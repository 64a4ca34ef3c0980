"""The NeRF trainer's optional learners and loss terms (Slice C2b), port vs
reference, on the trained state of tests/test_torch_train.py (the ball
scene, 10 views at 48x48, 4 levels x 2 features, 2^12 rows) with every
learner injected at once: per-camera se(3) deltas, a log-scale focal,
per-image exposure, an 8x8 distortion map, 2 latent codes a view (the
colour MLP widened by their rows), an 8x16 trainable envmap, depth
supervision on analytic depth images, the near-density regulariser and
rolling shutter toward perturbed end cameras.  The learners' leaves are
drawn from numpy seeds; the draws of the step are the reference's own,
re-created from its keys (the motion-blur time too).

Also: the same step on the legacy two-phase path (its deep phase), the
phase switch and the adaptive ray count, the march's t chain under cone
stepping against the reference's autodiff of its march, the envmap's and
the distortion map's bilinear splats against a float64 index_add_ sum,
the learners' leaves and Adam moments through convert and a snapshot
round trip, an imported .ingp with latent codes, and Session.load_file's
learner flags.

Tolerances (those of tests/test_torch_train.py):
- loss rtol 1e-4; samples a ray equal; per-ray losses atol 1e-6 for all
  but 2 % of the rays (XLA's fused multiply-adds under jit);
- gradients: MLP matrices rtol 1e-2 / atol 1e-3 and 2 % of their largest
  entry, every other leaf (table, cam, focal, exposure, distortion, extra
  dims, envmap) within 2 % of its largest entry.  The step is the one
  tests/test_torch_train.py holds (its key folded with 1): the table's 2 %
  depends on the draws (XLA's fused multiply-adds and bf16 roundings that
  fall the other way move single samples), and on other draws the plain
  step's table reaches 2.2 %;
- the step's update: Adam's first step moves each entry by its leaf's rate
  against the sign of its gradient (1e-4 of the rate, and two f32 ulps of
  the entry), the sign the reference's in all but 2 % of each leaf's
  entries;
- the march's t chain: rtol 1e-5 / atol 1e-6 (a product of f32 factors);
- the splats: within 1e-5 of each texel's float64 sum of magnitudes."""

import functools
import inspect
import json
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_train as T
from test_nerf_mode import N_VIEWS, RES

E = 2  # latent codes a view
DIST_RES = 8
LEAVES = ("cam", "focal", "exposure", "distortion", "extra_dims", "envmap")


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


def _learners_on(eng, compact=True):
    eng.optimize_extrinsics = eng.optimize_focal = eng.optimize_exposure = True
    eng.optimize_distortion = True
    eng.distortion_resolution = DIST_RES
    eng.near_density_reg = 0.1
    eng.depth_supervision_lambda = 0.5
    eng.compact_training = compact


@functools.lru_cache(maxsize=2)
def injected(compact=True):
    """(JAX engine, JAX state, step key, port engine, port state, draws,
    (n_rays, k, iters)) with every learner on and its leaves injected."""
    import copy

    from sienerf_tpu.engines.nerf import NerfEngine as JaxEngine
    from sienerf_tpu.ops.optim import optim_init
    from sienerf_torch.convert import train_state_from_jax
    from sienerf_torch.engines.nerf import NerfEngine
    from sienerf_torch.io.nerf_dataset import NerfDataset

    jeng0, st0, key, _, _, ds = T.trained()
    ds = copy.deepcopy(ds)
    rng = np.random.default_rng(0)
    eyes = ds.xforms[:, :, 3]
    # depth: the camera's distance to the ball's surface
    ds.depths = np.broadcast_to((np.linalg.norm(eyes - 0.5, axis=1) - 0.18)[:, None, None],
                                (N_VIEWS, RES, RES)).astype(np.float32).copy()
    ds.rolling_shutter = np.asarray([0.1, 0.2, 0.3, 0.25], np.float32)
    ds.xforms_end = (ds.xforms + rng.normal(0, 0.01, ds.xforms.shape)).astype(np.float32)
    ds.envmap = rng.uniform(0, 1, (8, 16, 4)).astype(np.float32)
    ds.envmap[..., 3] = rng.uniform(0.3, 1.0, (8, 16))
    ds.n_extra_learnable_dims = E
    jeng = JaxEngine.create(T.small_config(), ds, train_batch_size=T.BATCH, grid_size=T.G,
                            train_k=T.TRAIN_K)
    pds = NerfDataset(images=ds.images, xforms=ds.xforms, focal_lengths=ds.focal_lengths,
                      principal_points=ds.principal_points, resolution=ds.resolution,
                      aabb_scale=ds.aabb_scale, depths=ds.depths,
                      rolling_shutter=ds.rolling_shutter, xforms_end=ds.xforms_end,
                      envmap=ds.envmap, n_extra_learnable_dims=E)
    eng = NerfEngine.create(T.small_config(), pds, train_batch_size=T.BATCH, grid_size=T.G,
                            train_k=T.TRAIN_K, device="cpu")
    for e in (jeng, eng):
        _learners_on(e, compact)
        e._mean_samples = jeng0._mean_samples
    p = dict(st0["params"])
    w0 = np.asarray(p["rgb_mlp"][0])  # rows of the codes between SH and geo
    p["rgb_mlp"] = [jnp.asarray(np.concatenate(
        [w0[:16], rng.normal(0, 0.3, (E, w0.shape[1])).astype(np.float32), w0[16:]]))] \
        + list(p["rgb_mlp"][1:])
    p["cam"] = jnp.asarray(rng.normal(0, 2e-3, (N_VIEWS, 6)).astype(np.float32))
    p["focal"] = jnp.asarray(rng.normal(0, 1e-2, 2).astype(np.float32))
    p["exposure"] = jnp.asarray(rng.normal(0, 0.1, (N_VIEWS, 1)).astype(np.float32))
    p["distortion"] = jnp.asarray(rng.normal(0, 2e-3, (DIST_RES, DIST_RES, 2)).astype(
        np.float32))
    p["extra_dims"] = jnp.asarray(rng.uniform(-1, 1, (N_VIEWS, E)).astype(np.float32))
    p["envmap"] = jnp.asarray(ds.envmap)
    st = dict(st0, params=p, opt=optim_init(p, jeng.opt))
    st.pop("emap")
    for e in (jeng, eng):
        e.use_error_map = False
    tst = train_state_from_jax(jax.tree.map(np.asarray, st), device="cpu")
    geometry = jeng._phase_geometry()
    assert geometry == eng._phase_geometry()
    key = jax.random.fold_in(key, 1)
    draws = T._jax_step_draws(key, geometry[0], N_VIEWS, False)
    draws["shutter"] = T._t(jax.random.uniform(jax.random.fold_in(key, 11), (geometry[0],)))
    return jeng, st, key, eng, tst, draws, geometry


@functools.lru_cache(maxsize=2)
def step_grads(compact=True):
    """The injected step's (JAX loss, aux, grads) and (port loss, grads, aux)."""
    jeng, st, key, eng, tst, draws, (n_rays, k, iters) = injected(compact)

    def loss_of(p):
        return jeng._loss_for_batch(p, st["occ"]["bitfield"], jeng.data, key, n_rays, None,
                                    st["step"], k, iters)

    (jl, jaux), jg = jax.jit(jax.value_and_grad(loss_of, has_aux=True))(st["params"])
    return (jl, jaux, jg), eng.loss_and_grads(tst, draws, k, iters)


@pytest.mark.parametrize("compact", [True, False], ids=["compact", "two_phase"])
def test_injected_step_loss_matches(compact):
    (jl, jaux, _), (loss, _, aux) = step_grads(compact)
    n_rays = injected(compact)[6][0]
    np.testing.assert_array_equal(aux[0].numpy(), np.asarray(jaux[0]))
    assert int(aux[0].sum()) > 4 * n_rays
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-4)
    d_ray = np.abs(aux[1].detach().numpy().astype(np.float64) - np.asarray(jaux[1]))
    assert (d_ray > 1e-6).sum() <= max(1, 0.02 * n_rays)
    # the depth and near-density terms are in the loss
    per_ray = aux[1].detach()
    assert float(loss) > float(per_ray.sum()) / max(1, int((per_ray != 0).sum()))


@pytest.mark.parametrize("compact", [True, False], ids=["compact", "two_phase"])
@pytest.mark.parametrize("leaf", ["density_mlp", "rgb_mlp", "grid", *LEAVES])
def test_injected_step_gradient_matches(leaf, compact):
    (_, _, jg), (_, tg, _) = step_grads(compact)
    want, got = jg[leaf], tg[leaf]
    pairs = zip(want, got) if isinstance(want, list) else [(want, got)]
    for i, (a, b) in enumerate(pairs):
        a, b = np.asarray(a), b.numpy()
        assert np.abs(a).max() > 0, f"{leaf}[{i}]: no gradient"
        assert np.abs(b - a).max() <= 0.02 * np.abs(a).max(), f"{leaf}[{i}]"
        if leaf.endswith("mlp"):
            np.testing.assert_allclose(b, a, **T.STEP_TOL, err_msg=f"{leaf}[{i}]")


def test_injected_train_step_masks_the_rates():
    """The step: cam, focal and exposure at extrinsics_lr_scale times the
    rate, the rest at the rate.  From fresh Adam moments the first step
    moves each entry by its rate against the sign of its gradient, which
    is the reference's sign."""
    _, _, _, eng, tst, draws, (n_rays, k, iters) = injected()
    got, loss, _ = eng.train_step(tst, draws, k, iters)
    (_, _, jg), (_, tg, _) = step_grads()
    lr = float(eng.opt.learning_rate)
    for leaf in LEAVES:
        rate = lr * (eng.extrinsics_lr_scale if leaf in ("cam", "focal", "exposure") else 1.0)
        move = got["params"][leaf].numpy() - tst["params"][leaf].numpy()
        g, jgl = tg[leaf].numpy(), np.asarray(jg[leaf])
        live = np.abs(g) > 1e-6 * np.abs(g).max()
        # the move as the f32 params hold it: within two ulps of the entry
        ulps = 2.0 * np.spacing(np.abs(tst["params"][leaf].numpy()))
        off = np.abs(move + rate * np.sign(g))
        assert (off <= 1e-4 * rate + ulps)[live].all(), leaf
        assert np.abs(move).max() <= rate * (1 + 1e-4), leaf
        assert (np.sign(g) == np.sign(jgl))[live].mean() >= 0.98, leaf


def test_two_phase_switch_and_adaptive_ray_count():
    """The deep phase's geometry, the switch to fast under 0.75 deep_k
    samples a ray, and the adaptive ray count's buckets, as the
    reference's."""
    from sienerf_tpu.engines.nerf import NerfEngine as JaxEngine
    from sienerf_torch.engines.nerf import NerfEngine

    ds = T.make_dataset()
    jeng = JaxEngine.create(T.small_config(), ds, train_batch_size=1 << 18)
    eng = NerfEngine.create(T.small_config(), T.port_dataset(ds), train_batch_size=1 << 18,
                            device="cpu")
    for e in (jeng, eng):
        e.compact_training, e.adapt_ray_count = False, True
    assert eng._phase_geometry() == jeng._phase_geometry() == (512, 512, 1280)
    for count in (500.0, 420.0, 300.0, 40.0, 9.0, 2000.0, 0.0, 64.0):
        k = eng._phase_geometry()[1]
        jeng._update_phase(count, k)
        eng._update_phase(count, k)
        assert getattr(eng, "_phase", "deep") == getattr(jeng, "_phase", "deep")
        assert getattr(eng, "_adaptive_n_rays", None) == getattr(jeng, "_adaptive_n_rays", None)
        assert eng._phase_geometry() == jeng._phase_geometry()
    assert eng._phase == "fast" and eng._adaptive_n_rays is not None


def test_march_t_chain_matches_the_reference_autodiff():
    """Under cone stepping a sample's t (and dt) grows with the ray's start;
    march_rays(t_grad=True) gives d ts / d t_start and d dts / d t_start,
    which the reference gets by differentiating its march loop."""
    from sienerf_tpu.ops.raymarch import MarchConfig as JMarch
    from sienerf_tpu.ops.raymarch import march_rays as jmarch
    from sienerf_torch.ops.raymarch import MarchConfig, march_rays

    rng = np.random.default_rng(6)
    n, K, iters, g = 128, 48, 160, 16
    cfg = dict(n_cascades=2, cone_angle=1.0 / 256.0, grid_size=g)
    bitfield = rng.random((2, g, g, g)) < 0.4
    origins = rng.uniform(-0.4, 1.4, (n, 3)).astype(np.float32)
    dirs = (0.5 - origins) + rng.normal(0, 0.2, (n, 3))
    dirs = (dirs / np.linalg.norm(dirs, axis=1, keepdims=True)).astype(np.float32)
    t0 = rng.uniform(0.05, 1.2, n).astype(np.float32)
    t1 = np.full(n, 4.0, np.float32)
    w1, w2 = rng.normal(size=(n, K)).astype(np.float32), rng.normal(size=(n, K)).astype(
        np.float32)

    def f(t):
        ts, dts, counts, _ = jmarch(JMarch(**cfg), jnp.asarray(bitfield), jnp.asarray(origins),
                                    jnp.asarray(dirs), t, jnp.asarray(t1), K, iters)
        return jnp.sum(ts * w1 + dts * w2), counts

    (_, jcounts), want = jax.jit(jax.value_and_grad(f, has_aux=True))(jnp.asarray(t0))
    ts, dts, counts, _, g_t, g_dt = march_rays(
        MarchConfig(**cfg), torch.from_numpy(bitfield), torch.from_numpy(origins),
        torch.from_numpy(dirs), torch.from_numpy(t0), torch.from_numpy(t1), K, iters,
        t_grad=True)
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jcounts))
    got = (g_t * torch.from_numpy(w1) + g_dt * torch.from_numpy(w2)).sum(dim=1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    assert float(g_t.max()) > 1.5 and float(g_dt.abs().max()) > 0  # the cone grew some t


def _splat_reference(n_rows, corners, weights, cot):
    """float64 index_add_ of weight * cotangent into each corner's row ->
    (sum, sum of magnitudes)."""
    c = torch.from_numpy(corners.reshape(-1))
    contrib = (torch.from_numpy(weights.reshape(-1, 1)).double()
               * torch.from_numpy(np.repeat(cot, corners.shape[1], axis=0)).double())
    out = torch.zeros((n_rows, cot.shape[1]), dtype=torch.float64).index_add_(0, c, contrib)
    mag = torch.zeros_like(out).index_add_(0, c, contrib.abs())
    return out.numpy(), mag.numpy()


@pytest.mark.parametrize("what", ["envmap", "distortion"])
def test_bilinear_splats_match_a_float64_index_add(what):
    from sienerf_torch.ops.envmap import dir_to_latlong_uv, read_envmap
    from sienerf_torch.ops.grids import bilinear_sample_2d

    rng = np.random.default_rng(7)
    n = 4096
    if what == "envmap":
        Hh, Ww, C = 8, 16, 4
        d = rng.normal(size=(n, 3)).astype(np.float32)
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        uv = dir_to_latlong_uv(torch.from_numpy(d)).numpy().astype(np.float64)
        fx, fy = uv[:, 1] * (Ww - 1), uv[:, 0] * (Hh - 1)
        x0, y0 = np.floor(fx).astype(np.int64), np.floor(fy).astype(np.int64)
        xs = [x0 % Ww, (x0 + 1) % Ww]
        ys = [np.clip(y0, 0, Hh - 1), np.clip(y0 + 1, 0, Hh - 1)]
    else:
        Hh, Ww, C = 32, 32, 2
        uv = rng.random((n, 2)).astype(np.float32)
        fx, fy = uv[:, 0].astype(np.float64) * Ww - 0.5, uv[:, 1].astype(np.float64) * Hh - 0.5
        x0, y0 = np.floor(fx).astype(np.int64), np.floor(fy).astype(np.int64)
        # clamped addressing: the second texel is the clamped first's next
        xc, yc = np.clip(x0, 0, Ww - 1), np.clip(y0, 0, Hh - 1)
        xs = [xc, np.clip(xc + 1, 0, Ww - 1)]
        ys = [yc, np.clip(yc + 1, 0, Hh - 1)]
    wx, wy = fx - x0, fy - y0
    corners = np.stack([ys[j] * Ww + xs[i] for j in (0, 1) for i in (0, 1)], axis=1)
    weights = np.stack([(wx if i else 1 - wx) * (wy if j else 1 - wy)
                        for j in (0, 1) for i in (0, 1)], axis=1)
    grid = torch.from_numpy(rng.random((Hh, Ww, C)).astype(np.float32)).requires_grad_(True)
    cot = rng.normal(size=(n, C)).astype(np.float32)
    out = read_envmap(grid, torch.from_numpy(d)) if what == "envmap" \
        else bilinear_sample_2d(grid, torch.from_numpy(uv))
    (g,) = torch.autograd.grad((out * torch.from_numpy(cot)).sum(), grid)
    want, mag = _splat_reference(Hh * Ww, corners, weights, cot)
    err = np.abs(g.numpy().reshape(Hh * Ww, C).astype(np.float64) - want)
    assert (err <= 1e-5 * mag + 1e-7).all(), float((err / (mag + 1e-30)).max())
    assert (np.abs(want) > 0).mean() > 0.9  # the rays cover the map


def test_learner_state_round_trips_through_convert_and_a_snapshot(tmp_path):
    from sienerf_torch.convert import train_state_to_jax
    from sienerf_torch.session import Session
    from sienerf_tpu.io.snapshot import load_snapshot as jax_load

    jeng, st, _, eng, tst, _, _ = injected()
    for leaf in LEAVES:
        np.testing.assert_array_equal(tst["params"][leaf].numpy(), np.asarray(st["params"][leaf]))
        back = train_state_to_jax(tst)
        for part in ("m", "v"):
            np.testing.assert_array_equal(back["opt"][part][leaf],
                                          np.asarray(st["opt"][part][leaf]))
    # a step moves the moments; the snapshot carries them both ways
    draws, (n_rays, k, iters) = injected()[5], injected()[6]
    stepped, _, _ = eng.train_step(tst, draws, k, iters)
    s = Session(device="cpu")
    s.engine, s.state, s.network_config = eng, stepped, T.small_config()
    path = tmp_path / "learners.snap"
    s.save_snapshot(path)
    r = Session(device="cpu")
    r.load_snapshot(path)
    for leaf in LEAVES:
        for a, b in ((r.state["params"][leaf], stepped["params"][leaf]),
                     (r.state["opt"]["m"][leaf], stepped["opt"]["m"][leaf]),
                     (r.state["opt"]["v"][leaf], stepped["opt"]["v"][leaf])):
            assert torch.equal(a, b), leaf
    re = r.engine
    assert re.optimize_extrinsics and re.optimize_focal and re.optimize_exposure
    assert re.optimize_distortion and re.distortion_resolution == DIST_RES
    assert re.train_envmap and re.net.n_extra_dims == E
    payload = jax_load(path)
    for leaf in LEAVES:
        np.testing.assert_array_equal(np.asarray(payload["state"]["params"][leaf]),
                                      stepped["params"][leaf].numpy())
    # the restored learner state renders
    rgba = r.render(16, 16)
    assert rgba.shape == (16, 16, 4) and bool(torch.isfinite(rgba).all())


def test_an_ingp_with_latent_codes_imports_and_renders(tmp_path):
    from sienerf_tpu.engines.nerf import NerfEngine as JaxEngine
    from sienerf_tpu.io import ingp as ji
    from sienerf_tpu.models.nerf_network import nerf_apply as jax_apply
    from sienerf_torch.engines.nerf import NerfEngine
    from sienerf_torch.models.nerf_network import nerf_apply

    jeng, st = injected()[:2]
    path = tmp_path / "codes.ingp"
    ji.export_ingp(path, T.small_config(), st["params"], jeng.net.grid, jeng.net.density_mlp,
                   jeng.net.rgb_mlp, density_grid=np.asarray(st["occ"]["density"]))
    doc = ji.load_ingp(path)
    doc["snapshot"]["nerf"]["dataset"] = {"n_extra_learnable_dims": E}
    ji.save_ingp(path, doc)
    jimp, _ = JaxEngine.from_ingp(path)
    eng, state = NerfEngine.from_ingp(path, device="cpu")
    assert eng.net.n_extra_dims == jimp.net.n_extra_dims == E
    rng = np.random.default_rng(8)
    pos, dirw = rng.random((256, 3)).astype(np.float32), rng.random((256, 3)).astype(np.float32)
    ex = rng.uniform(-1, 1, (256, E)).astype(np.float32)
    from sienerf_tpu.io.ingp import import_ingp

    jp = {k: ([jnp.asarray(w) for w in v] if isinstance(v, list) else jnp.asarray(v))
          for k, v in import_ingp(path)["params"].items()}
    want = jax_apply(jimp.net, jp, jnp.asarray(pos), jnp.asarray(dirw), extra=jnp.asarray(ex))
    got = nerf_apply(eng.net, state["params"], torch.from_numpy(pos), torch.from_numpy(dirw),
                     extra=torch.from_numpy(ex))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-2, atol=2e-3)
    rgba, _ = eng.render_frame(state["params"], state["occ"]["bitfield"], 16, 16,
                               jeng.xforms[0], (16.0, 16.0))
    assert bool(torch.isfinite(rgba).all()) and float(rgba[..., 3].mean()) > 0.01


def test_load_file_passes_the_learner_flags_on(tmp_path):
    from test_torch_dataset import _small_network, _write_scene

    from sienerf_torch.session import LEARNER_FLAGS, Session

    scene = tmp_path / "scene"
    scene.mkdir()
    _write_scene(scene, np.random.default_rng(0))
    flags = dict(optimize_extrinsics=True, optimize_focal=True, optimize_exposure=True,
                 optimize_distortion=True, train_envmap=True, depth_supervision_lambda=0.5,
                 compact_training=False, adapt_ray_count=True, extrinsics_lr_scale=1e-2)
    assert set(flags) == set(LEARNER_FLAGS)
    s = Session(device="cpu").load_file(scene, network=_small_network(tmp_path), grid_size=16,
                                        **flags)
    for k, v in flags.items():
        assert getattr(s.engine, k) == v, k
    assert {"cam", "focal", "exposure", "distortion", "envmap"} <= set(s.state["params"])
    assert s.state["params"]["envmap"].shape == (128, 256, 4)
    assert bool((s.state["params"]["envmap"][..., 3] == 1.0).all())
    assert s.engine.net.rgb_mlp.n_input_dims == 32  # no extra dims


def test_loader_reads_the_learners_fields_as_the_reference(tmp_path):
    """Rolling shutter, end cameras, light directions and the envmap (an
    EXR, linear) load as the reference loads them."""
    import cv2

    from sienerf_torch.io.exr import write_exr
    from sienerf_torch.io.nerf_dataset import load_nerf_dataset
    from sienerf_tpu.io.nerf_dataset import load_nerf_dataset as jax_load

    rng = np.random.default_rng(9)
    frames = []
    for i in range(3):
        cv2.imwrite(str(tmp_path / f"f{i}.png"), rng.integers(0, 256, (8, 12, 3), np.uint8))
        m = np.eye(4)
        m[:3, 3] = rng.normal(size=3)
        end = m.copy()
        end[:3, 3] += 0.01
        frames.append({"file_path": f"f{i}", "transform_matrix": m.tolist(),
                       "transform_matrix_end": end.tolist(),
                       "driver_parameters": {"LightX": float(i), "LightY": 1.0, "LightZ": 0.5}})
    write_exr(tmp_path / "env.exr", rng.random((4, 8, 3), np.float32))
    meta = {"camera_angle_x": 0.9, "rolling_shutter": [0.1, 0.2, 0.3, 0.4],
            "envmap": "env.exr", "frames": frames}
    (tmp_path / "transforms.json").write_text(json.dumps(meta))
    got, want = load_nerf_dataset(tmp_path), jax_load(tmp_path)
    for name in ("rolling_shutter", "xforms_end", "light_dirs", "envmap", "xforms"):
        np.testing.assert_array_equal(getattr(got, name), np.asarray(getattr(want, name)),
                                      err_msg=name)
    assert got.n_extra_dims == want.n_extra_dims == 3


# --- the table gradient on other draws --------------------------------------
#
# Where the training step's table gradient parts from the reference's on
# draws other than the one tests/test_torch_train.py and
# tests/test_torch_learners.py hold (the plain step of test_torch_train's
# trained state; the reference's draws re-created from its keys).
#
# On those draws the jitted reference's table gradient sits up to 24 % of
# its largest entry from the port's (key folded with 6), where the held
# draw gives 1 %.  On draws 3, 5 and 6 two roundings account for it,
# value by value:
#
# - XLA under jit contracts a sample's position o + t d into a fused
#   multiply-add, in the march (the occupancy probe that places the
#   samples) and in the loss (the position the hash grid encodes).  One ulp
#   there moves a sample across a cell of the finest level.  With the same
#   single rounding put into the port's CPU step, every ray's loss meets the
#   reference's within 1e-6 and the table gradient meets the reference's
#   within 0.2 % of its largest entry, once the reference accumulates the
#   table rows in f32 (its "nosort" mode, set on the module here; the JAX
#   package is not edited).
# - The reference's default hash backward accumulates each table row's
#   contributions in bf16 (a caveat in ROADMAP.md): against it the same
#   step sits within 1 %, as far as the reference's bf16 and f32 modes sit
#   from each other.
#
# On draws 3, 5 and 6 nothing is left for the port's arithmetic.  On the
# held draw (1) and on draw 7 one ray still differs (by 8.6e-6 and 1.8e-6)
# through another single rounding of the jitted reference, not located:
# fusing the start jitter t0 + dt u, the voxel skip t + n dt, the skip's
# tau + 1e-5 s or the hash encode's x s + 0.5 the same way changes nothing
# there.  Every other ray meets the reference within 1e-6; the table
# gradient sits 0.97 % (draw 1) and 0.52 % (draw 7) of its largest entry
# from the reference's f32 accumulation, against at most 0.1 % on draws 3,
# 5 and 6, and is held there to the learners' 2 % only: that gap is not
# explained yet (ROADMAP.md queue 3 item 3).

# draw -> the one ray that still differs (None: no ray)
TABLE_DRAWS = {3: None, 5: None, 6: None, 1: 20, 7: 50}
# with the fused positions: per-ray losses, the table against the
# reference's f32 and bf16 accumulation (relative to its largest entry)
RAY_ATOL, TABLE_F32, TABLE_BF16 = 1e-6, 2e-3, 1e-2
TABLE_LEFT = 2e-2  # the table on a draw with a ray left: the learners' tolerance


def _fma(src: str, plain: str, a: str, b: str, c: str) -> str:
    """`plain` (a + b * c) in `src` rounded once, as a fused multiply-add:
    the product of two f32 values is exact in float64."""
    assert plain in src, plain
    return src.replace(plain, f"({a}.double() + {b}.double()[:, None] * {c}.double()).float()")


@functools.lru_cache(maxsize=1)
def _fused_port():
    """The port's march and loss with the sample positions rounded once."""
    import sienerf_torch.engines.nerf as tn
    import sienerf_torch.ops.raymarch as tr

    march = textwrap.dedent(inspect.getsource(tr._march_rays_scalar))
    march = _fma(march, "origins + t[:, None] * dirs", "origins", "t", "dirs")
    loss = textwrap.dedent(inspect.getsource(tn.NerfEngine._loss_for_batch))
    loss = _fma(loss, "o_s + t_f[:, None] * d_s", "o_s", "t_f", "d_s")
    ns_march, ns_loss = dict(tr.__dict__), dict(tn.__dict__)
    exec(march, ns_march)
    exec(loss, ns_loss)
    return ns_march["_march_rays_scalar"], ns_loss["_loss_for_batch"]


@functools.lru_cache(maxsize=2)
def _reference_step(mode: str):
    """The jitted reference loss-and-gradient with its hash backward in
    `mode`, the step's key an argument (one compile for every draw)."""
    import sienerf_tpu.ops.hashgrid as jh

    jeng, st, _, _, _, _ = T.trained()
    n_rays, k, iters = jeng._phase_geometry()

    def loss_of(p, key):
        return jeng._loss_for_batch(p, st["occ"]["bitfield"], jeng.data, key, n_rays,
                                    st["emap"], st["step"], k, iters)

    step = jax.jit(jax.value_and_grad(loss_of, has_aux=True))
    prev, jh.HASH_BWD_MODE = jh.HASH_BWD_MODE, mode
    try:
        return step.lower(st["params"], jax.random.PRNGKey(0)).compile()  # traced in `mode`
    finally:
        jh.HASH_BWD_MODE = prev


def _share(a, b) -> float:
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.mark.parametrize("draw", list(TABLE_DRAWS))
def test_table_gradient_gap_is_the_references_fused_positions(draw, monkeypatch):
    import sienerf_torch.engines.nerf as tn
    import sienerf_torch.ops.raymarch as tr

    jeng, st, key, eng, tst, ds = T.trained()
    n_rays, k, iters = jeng._phase_geometry()
    kk = jax.random.fold_in(key, draw)
    draws = T._jax_step_draws(kk, n_rays, ds.n_images, False)
    want = {}
    for mode in ("bf16", "nosort"):
        (_, jaux), jg = _reference_step(mode)(st["params"], kk)
        want[mode] = np.asarray(jg["grid"])
    # the port as it is: the gap the learners' test cannot allow on every draw
    _, tg, _ = eng.loss_and_grads(tst, draws, k, iters)
    raw = _share(tg["grid"].numpy(), want["bf16"])
    # with the reference's single rounding of the sample positions
    march, loss_fn = _fused_port()
    monkeypatch.setattr(tr, "_march_rays_scalar", march)
    monkeypatch.setattr(tn.NerfEngine, "_loss_for_batch", loss_fn)
    loss, tg, aux = eng.loss_and_grads(tst, draws, k, iters)
    g = tg["grid"].numpy()
    np.testing.assert_array_equal(aux[0].numpy(), np.asarray(jaux[0]))  # samples a ray
    d_ray = np.abs(aux[1].detach().numpy().astype(np.float64) - np.asarray(jaux[1]))
    left = TABLE_DRAWS[draw]
    assert np.nonzero(d_ray > RAY_ATOL)[0].tolist() == ([] if left is None else [left]), draw
    f32, bf16 = _share(g, want["nosort"]), _share(g, want["bf16"])
    if left is not None:
        assert max(f32, bf16) <= TABLE_LEFT, (draw, raw, f32, bf16)
    else:
        assert f32 <= TABLE_F32, (draw, raw, f32)
        assert bf16 <= TABLE_BF16, (draw, raw, bf16)
        # the rest against the bf16 reference is its own bf16 accumulation
        assert bf16 <= 1.5 * _share(want["nosort"], want["bf16"]) + TABLE_F32
    for name in ("density_mlp", "rgb_mlp"):
        for a, b in zip(tg[name], _reference_step("nosort")(st["params"], kk)[1][name]):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), **T.STEP_TOL)
