"""Per-image extra-dim conditioning, port vs reference (mirrors
tests/test_extra_dims.py): learnable latent codes and fixed light
directions in the trainer, nerf_apply with extra dims, and a conditioned
field (SH degree 2, 2 latent codes, the ball of tests/test_torch_live.py)
served through every renderer: a live frame with another view's row, the
sweep frame (the plain shade then the composite: K1 takes no extra dims)
and the baked gather frame, each from one R=16 bake in both packages.

Tolerances:
- the loader, the light-direction rows and the step's masks: equal.
- nerf_apply: rtol 2e-2 / atol 2e-3 (a bf16 rounding between MLP layers
  may fall the other way, tests/test_torch_live.py).
- frames: the live frame's rule (at least 99 % of pixels within rtol 2e-2
  / atol 5e-3); the sweep frame rtol 2e-2 / atol 5e-3 everywhere, as
  tests/test_torch_frame.py holds it."""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_extra_dims import N_VIEWS, make_dataset, tiny_config
from test_torch_live import _continuous_cell_grid

G = 32
W = H = 32
FOCAL = (36.0, 36.0)
FRAME_TOL = dict(rtol=2e-2, atol=5e-3)
MIN_AGREE = 0.99


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


def port_dataset(ds):
    from sienerf_torch.io.nerf_dataset import NerfDataset

    return NerfDataset(images=np.asarray(ds.images), xforms=np.asarray(ds.xforms),
                       focal_lengths=np.asarray(ds.focal_lengths),
                       principal_points=np.asarray(ds.principal_points),
                       resolution=ds.resolution, aabb_scale=ds.aabb_scale,
                       n_extra_learnable_dims=ds.n_extra_learnable_dims,
                       light_dirs=ds.light_dirs)


def _engines(ds):
    from sienerf_tpu.engines.nerf import NerfEngine as JaxEngine
    from sienerf_torch.engines.nerf import NerfEngine

    jeng = JaxEngine.create(tiny_config(), ds, train_batch_size=1 << 10, grid_size=G,
                            train_k=16)
    eng = NerfEngine.create(tiny_config(), port_dataset(ds), train_batch_size=1 << 10,
                            grid_size=G, train_k=16, device="cpu")
    for e in (jeng, eng):
        e.use_error_map = False
    return jeng, eng


def _one_step(eng, state):
    """A dense occupancy update and one training step of the port, from its
    own draws (the measured samples a ray set to 200: 64 rays of k 1024)."""
    gen = torch.Generator().manual_seed(1)
    state = eng.occupancy_update(state, eng.draw_occupancy(state, gen))
    eng._mean_samples = 200.0
    n_rays, k, iters = eng._phase_geometry()
    draws = eng.draw_step(gen, n_rays, 0)
    state, loss, _ = eng.train_step(state, draws, k, iters)
    assert np.isfinite(float(loss))
    return state


def _cam(eye=(1.3, 0.9, -0.4)):
    from sienerf_torch.utils.camera import look_at_matrix

    return look_at_matrix(list(eye), [0.5, 0.5, 0.5])


@functools.lru_cache(maxsize=1)
def scene():
    """(JAX engine, its params, port engine, port params, bitfield, the R=16
    bake as numpy, its meta): a seeded conditioned field, partly opaque
    inside a ball of occupied cells."""
    from sienerf_tpu.engines.nerf_baked import bake_feature_grid
    from sienerf_torch.convert import params_from_jax

    jeng, eng = _engines(make_dataset(n_extra=2))
    p = jax.tree.map(np.asarray, jeng.init(0)["params"])
    rng = np.random.default_rng(0)
    p["grid"] = _continuous_cell_grid(jeng.net.grid, rng)
    p["density_mlp"][-1] = p["density_mlp"][-1] * 12.0
    p["extra_dims"] = rng.uniform(-1.0, 1.0, (N_VIEWS, 2)).astype(np.float32) * 3.0
    ax = (np.arange(G) + 0.5) / G
    x, y, z = np.meshgrid(ax, ax, ax, indexing="ij")
    bitfield = ((x - 0.5) ** 2 + (y - 0.5) ** 2 + (z - 0.5) ** 2 < 0.3 ** 2)[None]
    jp = jax.tree.map(jnp.asarray, p)
    fn = jax.jit(lambda pp, b: bake_feature_grid(jeng, pp, b, 16)[0])
    grid = {k: np.asarray(v) for k, v in fn(jp, jnp.asarray(bitfield)).items()}
    meta = {"resolution": 16, "mode": "nearest", "n_cascades": 1}
    return jeng, jp, eng, params_from_jax(p, device="cpu"), bitfield, grid, meta


def _agree(got, want):
    err = np.abs(got - want)
    ok = (err <= FRAME_TOL["atol"] + FRAME_TOL["rtol"] * np.abs(want)).all(axis=-1)
    return ok.mean()


def test_nerf_apply_with_extra_matches():
    from sienerf_tpu.models.nerf_network import nerf_apply as jax_apply
    from sienerf_torch.models.nerf_network import nerf_apply

    jeng, jp, eng, tp, *_ = scene()
    assert eng.net.n_extra_dims == jeng.net.n_extra_dims == 2
    assert eng.net.rgb_mlp == type(eng.net.rgb_mlp)(**jeng.net.rgb_mlp.__dict__)
    rng = np.random.default_rng(1)
    pos = rng.uniform(0.2, 0.8, (512, 3)).astype(np.float32)
    dirw = rng.uniform(0.0, 1.0, (512, 3)).astype(np.float32)
    ex = rng.uniform(-1.0, 1.0, (512, 2)).astype(np.float32)
    for e in (ex, None):  # None: zeros
        want = jax_apply(jeng.net, jp, jnp.asarray(pos), jnp.asarray(dirw),
                         extra=None if e is None else jnp.asarray(e))
        got = nerf_apply(eng.net, tp, torch.from_numpy(pos), torch.from_numpy(dirw),
                         extra=None if e is None else torch.from_numpy(e))
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-2, atol=2e-3)


def test_latent_codes_created_and_trained():
    jeng, eng = _engines(make_dataset(n_extra=2))
    assert eng.net.n_extra_dims == 2 and eng.optimize_extra_dims == jeng.optimize_extra_dims
    state = eng.init(0)
    ex0 = state["params"]["extra_dims"].clone()
    assert ex0.shape == (N_VIEWS, 2) and float(ex0.abs().max()) <= 1.0
    assert not torch.allclose(ex0, torch.zeros_like(ex0))
    state = _one_step(eng, state)
    assert not torch.allclose(state["params"]["extra_dims"], ex0)  # learnable codes move


def test_light_dirs_fixed_conditioning():
    ld = np.tile(np.asarray([[0.0, 0.0, 1.0]], np.float32), (N_VIEWS, 1))
    jeng, eng = _engines(make_dataset(light_dirs=ld))
    assert eng.net.n_extra_dims == jeng.net.n_extra_dims == 3
    assert not eng.optimize_extra_dims and not jeng.optimize_extra_dims
    state = eng.init(0)
    ex0 = state["params"]["extra_dims"].clone()
    np.testing.assert_array_equal(ex0.numpy(), np.asarray(jeng.init(0)["params"]["extra_dims"]))
    state = _one_step(eng, state)
    assert torch.equal(state["params"]["extra_dims"], ex0)  # rate 0: the rows never move
    assert not torch.equal(state["params"]["rgb_mlp"][0], eng.init(0)["params"]["rgb_mlp"][0])


def test_loader_parses_driver_parameters(tmp_path):
    import cv2

    from sienerf_tpu.io.nerf_dataset import load_nerf_dataset as jax_load
    from sienerf_torch.io.nerf_dataset import load_nerf_dataset

    img = np.zeros((8, 8, 3), np.uint8)
    cv2.imwrite(str(tmp_path / "f0.png"), img)
    cv2.imwrite(str(tmp_path / "f1.png"), img)
    meta = {"camera_angle_x": 0.9, "n_extra_learnable_dims": 4,  # light dirs make it 0
            "frames": [{"file_path": "f0", "transform_matrix": np.eye(4).tolist(),
                        "driver_parameters": {"LightX": 1.0, "LightY": 0.0, "LightZ": 0.0}},
                       {"file_path": "f1", "transform_matrix": np.eye(4).tolist(),
                        "driver_parameters": {"LightX": 0.0, "LightY": 1.0, "LightZ": 0.0}}]}
    (tmp_path / "transforms.json").write_text(json.dumps(meta))
    got, want = load_nerf_dataset(tmp_path), jax_load(tmp_path)
    assert got.n_extra_learnable_dims == want.n_extra_learnable_dims == 0
    assert got.n_extra_dims == want.n_extra_dims == 3
    np.testing.assert_array_equal(got.light_dirs, want.light_dirs)


def test_live_frame_with_another_views_row_matches():
    jeng, jp, eng, tp, bitfield, _, _ = scene()
    row = 3
    want, _ = jeng.render_frame(jp, jnp.asarray(bitfield), W, H, _cam(), FOCAL,
                                extra_row=jp["extra_dims"][row])
    got, _ = eng.render_frame(tp, torch.from_numpy(bitfield), W, H, _cam(), FOCAL,
                              extra_row=tp["extra_dims"][row])
    assert _agree(got.numpy(), np.asarray(want)) >= MIN_AGREE
    # the default row is view 0's, and another row changes the colours
    v0, _ = eng.render_frame(tp, torch.from_numpy(bitfield), W, H, _cam(), FOCAL)
    assert float((v0 - got)[..., :3].abs().max()) > 1e-2
    assert float(got[..., 3].mean()) > 0.05


def test_sweep_frame_of_a_conditioned_field_matches():
    """The plain shade with view 0's row, then the composite (on the card:
    K2, and K1 never; tests/test_torch_kernels.py)."""
    from sienerf_torch.convert import baked_grid_from_jax
    from sienerf_torch.engines.nerf_sweep import _fused_prep_eligible, render_frame_sweep
    from sienerf_tpu.engines.nerf_sweep import render_frame_sweep as jax_frame

    jeng, jp, eng, tp, _, grid, meta = scene()
    tgrid = baked_grid_from_jax(grid, "cpu")
    assert not _fused_prep_eligible(eng, tgrid)
    want, _ = jax_frame(jeng, jp, {k: jnp.asarray(v) for k, v in grid.items()}, meta, _cam(),
                        FOCAL, width=W, height=H, impl="xla")
    got, _ = render_frame_sweep(eng, tp, tgrid, meta, _cam(), FOCAL, width=W, height=H)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FRAME_TOL)
    assert float(got[..., 3].mean()) > 0.05


def test_baked_frame_of_a_conditioned_field_matches():
    from sienerf_torch.convert import baked_grid_from_jax
    from sienerf_torch.engines.nerf_baked import render_frame_baked
    from sienerf_tpu.engines.nerf_baked import render_frame_baked as jax_frame

    jeng, jp, eng, tp, bitfield, grid, meta = scene()
    kw = dict(width=W, height=H, resolution=16, mode="nearest", n_cascades=1)
    want, _ = jax_frame(jeng, jp, jnp.asarray(bitfield), {k: jnp.asarray(v)
                                                          for k, v in grid.items()},
                        _cam(), FOCAL, **kw)
    tg = baked_grid_from_jax(grid, "cpu")
    got, _ = render_frame_baked(eng, tp, torch.from_numpy(bitfield), tg, _cam(), FOCAL, **kw)
    assert _agree(got.numpy(), np.asarray(want)) >= MIN_AGREE
    assert float(got[..., 3].mean()) > 0.05
    # another view's row: the frame of params whose view-0 row is that row
    other, _ = render_frame_baked(eng, tp, torch.from_numpy(bitfield), tg, _cam(), FOCAL,
                                  extra_row=tp["extra_dims"][3], **kw)
    swapped = dict(tp, extra_dims=tp["extra_dims"][[3, 1, 2, 0]])
    same, _ = render_frame_baked(eng, swapped, torch.from_numpy(bitfield), tg, _cam(), FOCAL,
                                 **kw)
    assert torch.equal(other, same) and not torch.equal(other, got)
