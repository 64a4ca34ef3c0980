"""Port vs reference: the render-only fox snapshot loads bit-equal, and the
port's loader guards reject a mismatched network config or aabb_scale.

Also holds the fox fixtures the other test_torch_* files share: the same
field loaded by both packages, the JAX engine built as the reference
builds one without a dataset, and a JAX bake at small R."""

import functools
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
FOX = REPO / "data" / "fox_render.snap"
# the committed fox field: base.json with an 8-level x 4-feature, 2^19-row
# hash grid, aabb_scale 4 (3 occupancy cascades)
FOX_AABB_SCALE = 4.0


def fox_network_config(n_levels=8, n_features=4):
    from sienerf_tpu.utils.config import load_network_config

    cfg = load_network_config(REPO / "configs" / "nerf" / "base.json")
    cfg["encoding"] = dict(cfg["encoding"], n_levels=n_levels,
                           n_features_per_level=n_features, log2_hashmap_size=19)
    return cfg


@functools.lru_cache(maxsize=1)
def fox_jax():
    """(JAX engine, params, bitfield) for the fox snapshot."""
    from sienerf_tpu.engines.nerf import NerfEngine
    from sienerf_tpu.io.nerf_dataset import NerfDataset
    from sienerf_tpu.io.snapshot import load_render_snapshot
    from sienerf_tpu.utils.camera import look_at_matrix

    params, bitfield, _ = load_render_snapshot(FOX)
    c, r = 0.5, 0.5 + FOX_AABB_SCALE
    ds = NerfDataset(
        images=np.zeros((1, 8, 8, 4), np.float32),
        xforms=look_at_matrix([c, c, c - r], [c, c, c])[None].astype(np.float32),
        focal_lengths=np.full((1, 2), 8.0, np.float32),
        principal_points=np.full((1, 2), 0.5, np.float32),
        resolution=(8, 8), aabb_scale=FOX_AABB_SCALE)
    eng = NerfEngine.create(fox_network_config(), ds)
    return eng, params, bitfield


@functools.lru_cache(maxsize=4)
def fox_jax_bake(resolution):
    """The reference's bake_feature_grid at `resolution` (rows + scale).  The
    bitfield goes in as a jit argument: closed over, XLA constant-folds the
    bake's distance-field sidecar for minutes."""
    from sienerf_tpu.engines.nerf_baked import bake_feature_grid

    eng, params, bitfield = fox_jax()
    fn = jax.jit(lambda p, b: bake_feature_grid(eng, p, b, resolution,
                                                bricks=False)[0])
    grid = fn(params, bitfield)
    meta = {"resolution": resolution, "mode": "nearest",
            "n_cascades": int(bitfield.shape[0])}
    return {"rows": np.asarray(grid["rows"]), "scale": np.asarray(grid["scale"])}, meta


@functools.lru_cache(maxsize=4)
def fox_jax_baked_grid(resolution, mode="nearest", row_bits=16):
    """The reference's whole bake_feature_grid at `resolution` (rows,
    scale and every sidecar, bricks when nearest) as numpy, and its
    meta."""
    from sienerf_tpu.engines.nerf_baked import bake_feature_grid

    eng, params, bitfield = fox_jax()
    fn = jax.jit(lambda p, b: bake_feature_grid(eng, p, b, resolution, mode=mode,
                                                row_bits=row_bits)[0])
    grid = {k: np.asarray(v) for k, v in fn(params, bitfield).items()}
    return grid, {"resolution": resolution, "mode": mode,
                  "n_cascades": int(bitfield.shape[0])}


def fox_port_session_baked(resolution, mode="nearest", row_bits=16):
    """A copy of the port's fox Session holding the reference's bake
    (fox_jax_baked_grid, carried across by baked_grid_from_jax), so that
    both packages render from one bake; the shared session keeps none."""
    import copy

    from sienerf_torch.convert import baked_grid_from_jax

    grid, meta = fox_jax_baked_grid(resolution, mode, row_bits)
    s = copy.copy(fox_port_session())
    s._baked = (baked_grid_from_jax(grid, "cpu"), dict(meta))
    return s


@functools.lru_cache(maxsize=1)
def fox_port_session():
    """The port's Session on the CPU with the fox snapshot loaded."""
    from sienerf_torch.session import Session

    s = Session(device="cpu")
    s.load_snapshot(FOX)
    return s


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


def test_snapshot_arrays_bit_equal():
    from sienerf_tpu.io.snapshot import load_render_snapshot as jax_load
    from sienerf_torch.io.snapshot import load_render_snapshot

    jp, jbf, jmeta = jax_load(FOX)
    tp, tbf, tmeta = load_render_snapshot(
        FOX, network_config=fox_network_config(), aabb_scale=FOX_AABB_SCALE,
        device="cpu")
    assert set(tp) == set(jp)
    assert tmeta["grid_shape"] == jmeta["grid_shape"]
    assert tmeta["step"] == jmeta["step"]
    # the JAX loader packs the e4m3 bytes as f32 rows; the port keeps uint8
    jg = np.asarray(jp["grid_fp8"])
    assert tp["grid_fp8"].dtype == torch.uint8
    assert tp["grid_fp8"].shape == (8, 524288, 32)
    np.testing.assert_array_equal(tp["grid_fp8"].numpy().reshape(-1),
                                  np.ascontiguousarray(jg).view(np.uint8).reshape(-1))
    for k in ("grid_fp8_scale",):
        np.testing.assert_array_equal(tp[k].numpy(), np.asarray(jp[k]))
    for k in ("density_mlp", "rgb_mlp"):
        assert len(tp[k]) == len(jp[k])
        for a, b in zip(tp[k], jp[k]):
            assert a.dtype == torch.float32
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(tbf.numpy(), np.asarray(jbf))


@pytest.mark.parametrize("levels,features,aabb_scale", [
    (16, 2, FOX_AABB_SCALE),   # the repo default 16x2 grid: renders fog
    (8, 4, 2.0),               # 2 cascades, the bitfield has 3
    (8, 4, 8.0),               # 4 cascades
])
def test_snapshot_guards_raise(levels, features, aabb_scale):
    from sienerf_torch.io.snapshot import load_render_snapshot

    with pytest.raises(ValueError):
        load_render_snapshot(FOX, network_config=fox_network_config(levels, features),
                             aabb_scale=aabb_scale, device="cpu")


def test_session_builds_fox_engine():
    s = fox_port_session()
    eng = s.engine
    assert eng.net.grid.n_levels == 8 and eng.net.grid.n_features_per_level == 4
    np.testing.assert_array_equal(eng.aabb.min, np.full(3, -1.5, np.float32))
    assert s.state["occ"]["bitfield"].shape == (3, 128, 128, 128)
    jeng = fox_jax()[0]
    assert eng.net.grid.per_level_scale == jeng.net.grid.per_level_scale


def test_msgpack_decoder_matches_reference_decoder():
    from sienerf_tpu.io import msgpack_lite as ref
    from sienerf_torch.io import msgpack_lite

    obj = {"a": [1, -5, 300, -70000, 2 ** 40, -(2 ** 40), 1.5, None, True, False],
           "s" * 40: b"\x00\x01" * 300, "m": {"x": "y" * 300},
           "l": list(range(20))}
    raw = ref.pack(obj)
    assert msgpack_lite.unpack(raw) == ref.unpack(raw) == obj


def test_params_from_jax_equal_port_loader():
    from sienerf_tpu.io.snapshot import load_render_snapshot as jax_load
    from sienerf_torch.convert import params_from_jax
    from sienerf_torch.io.snapshot import load_render_snapshot

    jp, _, _ = jax_load(FOX)
    got = params_from_jax({k: (np.asarray(v) if not isinstance(v, list)
                               else [np.asarray(w) for w in v]) for k, v in jp.items()},
                          device="cpu")
    want, _, _ = load_render_snapshot(FOX, device="cpu")
    assert set(got) == set(want)
    for k in got:
        a, b = (got[k], want[k]) if isinstance(got[k], list) else ([got[k]], [want[k]])
        for x, y in zip(a, b):
            assert x.dtype == y.dtype and torch.equal(x, y), k
