"""Repairs of the port's earlier slices, each shown by a test:

1. `near_density_reg` and `near_reg_fraction` reach the engine: through
   Session.load_file and NerfEngine.create (the regulariser itself trains
   since, tests/test_torch_learners.py).
2. Session.render defaults to the live renderer, as the reference's does.
3. The trainer's sums run in a fixed order (ops/fixed_order.py): the hash
   grid's backward sorts every level's contributions by row and sums each
   row pairwise, the composite's prefix sum runs by blocks and its per-ray
   sums and the error map's splat are segment sums.  On the CPU: the
   backward equals the exact (float64) sum of the same bf16-rounded
   contributions within 1e-5 of the row's sum of magnitudes (f32 pairwise
   summation: log2(n) * 2^-24 * sum |c| is under 1e-5 for any row here),
   the segment sum and the prefix sum match float64 references, and both
   repeat bit for bit whatever the thread count.  On the card the same
   is checked by tests/test_torch_kernels.py::
   test_card_training_step_is_deterministic and chip_smoke.py's
   determinism check.
4. The composite's per-ray offset into its global prefix sum runs in
   float64 (the rest of the card-vs-CPU loss gap beyond bf16 flips; the
   flips themselves are shown value by value by chip_smoke.py).

And the envmap background, lifted in this slice: the live and the sweep
frame with a trained envmap in the params match the reference (the
live frame's agreement rule of tests/test_torch_live.py; the sweep frame
rtol 2e-2 / atol 5e-3 as tests/test_torch_frame.py holds it)."""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_dataset import _small_network, _write_scene
from test_torch_live import FOCAL, _cam, tiny

N = 4096


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


# --- 1. near-density regulariser --------------------------------------------


@pytest.mark.parametrize("kw", [dict(near_density_reg=0.1),
                                dict(near_density_reg=0.1, near_reg_fraction=0.5)])
def test_load_file_passes_the_near_density_options_on(tmp_path, kw):
    from sienerf_torch.session import Session

    scene = tmp_path / "scene"
    scene.mkdir()
    _write_scene(scene, np.random.default_rng(0))
    # the regulariser is ported since (tests/test_torch_learners.py): the
    # options reach the engine that trains with them
    s = Session(device="cpu").load_file(scene, network=_small_network(tmp_path),
                                        grid_size=16, **kw)
    assert s.engine.near_density_reg == kw["near_density_reg"]
    assert s.engine.near_reg_fraction == kw.get("near_reg_fraction", 0.25)


def test_create_keeps_the_near_reg_fraction():
    from test_torch_train import port_dataset, small_config

    from sienerf_torch.engines.nerf import NerfEngine
    from test_nerf_mode import make_dataset

    eng = NerfEngine.create(small_config(), port_dataset(make_dataset()), grid_size=16,
                            near_reg_fraction=0.4, device="cpu")
    assert eng.near_reg_fraction == 0.4 and eng.near_density_reg == 0.0


# --- 2. the live renderer is the default --------------------------------------


def test_render_defaults_to_the_live_frame():
    from test_torch_snapshot import fox_port_session

    s = fox_port_session()
    cam = _cam()
    default = s.render(16, 12, cam, (15.0, 15.0))
    live = s.render(16, 12, cam, (15.0, 15.0), renderer="live")
    assert torch.equal(default, live)
    assert s._baked is None  # the default bakes nothing


# --- 3. sums in a fixed order --------------------------------------------------


def _hash_inputs(seed=0, L=4, log2=10):
    from sienerf_torch.ops.hashgrid import HashGridConfig

    cfg = HashGridConfig(n_levels=L, n_features_per_level=2, log2_hashmap_size=log2,
                         base_resolution=4, per_level_scale=1.7)
    rng = np.random.default_rng(seed)
    table = torch.from_numpy(rng.uniform(-1, 1, (L, 1 << log2, 8, 2)).astype(np.float32))
    # clustered points: many samples share a row, as near a surface
    pos = np.concatenate([rng.random((N // 2, 3)),
                          0.5 + 0.01 * rng.standard_normal((N // 2, 3))]).clip(0, 1)
    g = torch.from_numpy(rng.standard_normal((N, L * 2)).astype(np.float32))
    return cfg, table, torch.from_numpy(pos.astype(np.float32)), g


def test_hash_backward_is_the_exact_sum_of_its_contributions():
    from sienerf_torch.ops.hashgrid import _geometry_cell, hashgrid_encode

    cfg, table, pos, g = _hash_inputs()
    t = table.clone().requires_grad_(True)
    (d,) = torch.autograd.grad(hashgrid_encode(cfg, t, pos), t, g)
    idx, w = _geometry_cell(cfg, pos)
    L, T = cfg.n_levels, cfg.table_size
    contrib = (w[..., None] * g.reshape(N, L, 1, 2)).reshape(N, L, 16)
    contrib = contrib.to(torch.bfloat16).double().numpy()
    exact = np.zeros((L, T, 16))
    mag = np.zeros((L, T, 16))
    for lv in range(L):
        np.add.at(exact[lv], idx[:, lv].numpy(), contrib[:, lv])
        np.add.at(mag[lv], idx[:, lv].numpy(), np.abs(contrib[:, lv]))
    got = d.reshape(L, T, 16).double().numpy()
    assert np.all(np.abs(got - exact) <= 1e-5 * mag + 1e-30)
    assert (mag > 0).sum() > 1000 and mag.max() > 10 * np.median(mag[mag > 0])


def test_hash_backward_repeats_bit_for_bit_across_thread_counts():
    from sienerf_torch.ops.hashgrid import hashgrid_encode

    cfg, table, pos, g = _hash_inputs(seed=1)
    outs = []
    for threads in (1, 2, 2):
        torch.set_num_threads(threads)
        t = table.clone().requires_grad_(True)
        outs.append(torch.autograd.grad(hashgrid_encode(cfg, t, pos), t, g)[0])
    assert all(torch.equal(outs[0], o) for o in outs[1:])


@pytest.mark.parametrize("n_seg,M", [(1, 1), (7, 1000), (300, 5000), (5000, 300)])
def test_segment_sum_sorted_matches_float64(n_seg, M):
    from sienerf_torch.ops.fixed_order import segment_sum_sorted

    rng = np.random.default_rng(M)
    seg = np.sort(rng.integers(0, n_seg, M))
    vals = rng.standard_normal((M, 3)).astype(np.float32)
    want = np.zeros((n_seg, 3))
    np.add.at(want, seg, vals.astype(np.float64))
    mag = np.zeros((n_seg, 3))
    np.add.at(mag, seg, np.abs(vals.astype(np.float64)))
    v = torch.from_numpy(vals).requires_grad_(True)
    got = segment_sum_sorted(v, torch.from_numpy(seg), n_seg)
    assert np.all(np.abs(got.detach().double().numpy() - want) <= 1e-6 * mag + 1e-30)
    # the backward is a gather
    (gv,) = torch.autograd.grad(got, v, torch.arange(n_seg * 3.0).reshape(n_seg, 3))
    np.testing.assert_array_equal(gv.numpy(), (np.arange(n_seg * 3.0).reshape(n_seg, 3))[seg])


@pytest.mark.parametrize("n", [1, 1000, 1024, 1025, 5000, 1 << 21])
def test_fixed_cumsum_matches_float64(n):
    from sienerf_torch.ops.fixed_order import fixed_cumsum

    x = np.random.default_rng(n).standard_normal(n)
    got = fixed_cumsum(torch.from_numpy(x)).numpy()
    want = np.cumsum(x)
    assert np.all(np.abs(got - want) <= 1e-12 * np.cumsum(np.abs(x)))
    xt = torch.from_numpy(x).requires_grad_(True)
    (g,) = torch.autograd.grad(fixed_cumsum(xt).sum(), xt)
    np.testing.assert_allclose(g.numpy(), np.arange(n, 0, -1), rtol=1e-12)


def test_composite_does_not_depend_on_the_rays_before_it():
    """4. The card's and the CPU's losses parted by more than their bf16
    flips: the composite's global prefix of log1p(-alpha) was rounded to
    f32 before each ray's start was subtracted, so a ray's transmittance
    carried an error of |prefix| * 2^-24 (3 % after 1,000 opaque rays), and
    a last-bit difference of one log1p on another device could flip that
    rounding.  Now the subtraction runs in float64: a ray composites alike
    alone and after a long opaque stream."""
    from sienerf_torch.ops.raymarch import composite_flat

    rng = np.random.default_rng(7)
    k = 16
    n_before = 1000
    dens = np.concatenate([np.full(n_before * k, 1e9), rng.uniform(0.5, 30.0, k)])
    rgb = rng.random((dens.size, 3))
    ts = np.tile(np.arange(k) * 0.01 + 0.1, n_before + 1)
    dts = np.full(dens.size, 0.01)
    ids = np.repeat(np.arange(n_before + 1), k)

    def run(sl, n):
        def f(a):
            return torch.from_numpy(np.ascontiguousarray(a[sl])).float()

        rid = torch.from_numpy(ids[sl] - ids[sl][0]).to(torch.int32)
        start = torch.arange(n, dtype=torch.int32) * k
        return composite_flat(f(rgb), f(dens), f(ts), f(dts), rid, start, n)

    alone = run(slice(n_before * k, None), 1)
    stream = run(slice(None), n_before + 1)
    for a, b in zip(alone, stream):
        np.testing.assert_allclose(b[-1].numpy(), a[-1].numpy(), rtol=1e-6, atol=1e-9)
    assert float(alone[1][0]) > 0.5  # the ray is seen


def test_splat_errors_sums_every_ray_of_a_texel():
    from sienerf_torch.ops.importance import init_error_map, splat_errors

    rng = np.random.default_rng(0)
    em = init_error_map(3, 4)
    img = torch.from_numpy(rng.integers(0, 3, 500))
    u = torch.from_numpy(rng.random(500).astype(np.float32))
    v = torch.from_numpy(rng.random(500).astype(np.float32))
    loss = torch.from_numpy(rng.random(500).astype(np.float32))
    got = splat_errors(em, img, u, v, loss)["error"].double().numpy()
    want = np.full((3, 4, 4), np.float32(0.9995) * 1.0, np.float64)
    ex = np.minimum((u.numpy() * 4).astype(int), 3)
    ey = np.minimum((v.numpy() * 4).astype(int), 3)
    np.add.at(want, (img.numpy(), ey, ex), loss.numpy().astype(np.float64))
    np.testing.assert_allclose(got, want, rtol=1e-6)


# --- the envmap background -----------------------------------------------------


@functools.lru_cache(maxsize=1)
def _envmap():
    rng = np.random.default_rng(4)
    env = rng.random((8, 16, 4)).astype(np.float32)
    env[..., 3] = rng.uniform(0.2, 0.9, (8, 16))
    return env


def test_live_frame_with_an_envmap_matches_reference():
    jeng, jp, teng, tp, bf = tiny()
    env = _envmap()
    jrgba, _ = jeng.render_frame(dict(jp, envmap=jnp.asarray(env)), jnp.asarray(bf), 24, 16,
                                 jnp.asarray(_cam()), FOCAL, background=(0.2, 0.3, 0.4))
    trgba, _ = teng.render_frame(dict(tp, envmap=torch.from_numpy(env)),
                                 torch.from_numpy(bf), 24, 16, _cam(), FOCAL,
                                 background=(0.2, 0.3, 0.4))
    err = np.abs(np.asarray(jrgba) - trgba.numpy())
    assert (err.max(axis=-1) <= 5e-3).mean() >= 0.99
    assert np.abs(np.asarray(jrgba)[..., 3] - 1).max() > 0.05  # the envmap shows


def test_sweep_frame_with_an_envmap_matches_reference():
    from sienerf_tpu.engines.nerf_sweep import render_frame_sweep as jsweep
    from sienerf_torch.convert import baked_grid_from_jax
    from sienerf_torch.engines.nerf_sweep import render_frame_sweep

    jeng, jp, teng, tp, bf = tiny()
    env = _envmap()
    grid, meta = jeng.bake_features(jp, {"bitfield": jnp.asarray(bf)}, resolution=16)
    kw = dict(width=24, height=16, background=(0.2, 0.3, 0.4))
    jr, _ = jsweep(jeng, dict(jp, envmap=jnp.asarray(env)), grid, meta, _cam(), FOCAL, **kw)
    tr, _ = render_frame_sweep(teng, dict(tp, envmap=torch.from_numpy(env)),
                               baked_grid_from_jax(jax.tree.map(np.asarray, grid), "cpu"),
                               dict(meta), _cam(), FOCAL, **kw)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=2e-2, atol=5e-3)


def test_geometry_scene_is_not_refused_any_more(tmp_path):
    from sienerf_torch.session import Session

    (tmp_path / "empty.geometry.json").write_text(json.dumps({"geometry": []}))
    s = Session(device="cpu").load_file(tmp_path / "empty.geometry.json")
    assert s.mode.value == "geometry" and s.engine.objects == []
