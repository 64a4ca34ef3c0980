"""The NeRF trainer, port vs reference, on the synthetic ball scene of
tests/test_nerf_mode.py (10 views at 48x48) with a small network (4 levels
x 2 features, 2^12 rows, MLPs 16 wide, a 32^3 grid, 2^12-sample batches):
compact_samples, composite_flat, the occupancy update (dense and sparse),
mark_untrained_cells, the error map, one full training step from the
reference's own state and draws, a short training run of the port alone,
and each optional learner and dataset field of Slice C2b training a step
(tests/test_torch_learners.py holds them to the reference).

The reference state comes from two of its own bundles; the port takes it
through convert.train_state_from_jax and the reference's draws (ray
batch, jitter, background, occupancy cells and offsets), re-created from
its keys the way its functions draw them.

Tolerances:
- compact_samples, mark_untrained_cells, the error map's splat and its
  sampler: equal.
- composite_flat: rgb, opacity, T, depth and the gradients rtol 1e-5 /
  atol 1e-6 beyond the transmittance drift of the global cumsum.
  Exclusive transmittance is exp(c - c_first) of one cumsum c over all M
  samples; each side's cumsum lies within 2 ulps of |c| of the exact sum
  (XLA's sums f32 by a tree, the port's accumulates in float64), so
  the exponent moves by at most 4 * 2^-24 * max |c|, relative in T.  The
  stream has opaque rays, max |c| ~ 890: a drift of 2.1e-4.
- occupancy update: densities rtol 1e-5 / atol 1e-7 (the same f32
  operations), bitfield equal except cells within 1e-6 of the threshold,
  n_updates equal.  The threshold's mean: the port's within 1e-6 of the
  float64 mean of its densities, the reference's within its f32 summation
  bound, n * 2^-24 (n = 32^3 cells).
- one training step: loss rtol 1e-4, every gradient leaf as in
  tests/test_torch_hashgrad.py (MLP matrices rtol 1e-2 / atol 1e-3 and 2 %
  of their largest entry, the table 2 % of max |d|), the step equal.  The
  reference step runs under jit, as it trains, and XLA contracts the hash
  encode's pos * scale + 0.5 into a fused multiply-add, which can move a
  sample into the next cell: per-ray losses atol 1e-6 for all but at most
  2 % of the rays (one ray of 64 here), and the error map rtol 1e-6 /
  atol 1e-7 beyond the loss differences of the rays splatted into each
  texel.
- the port alone: over 4 bundles its bundle-mean loss falls at least 2x."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_nerf_mode import make_dataset, tiny_config

G = 32
BATCH = 1 << 12
TRAIN_K = 16
STEP_TOL = dict(rtol=1e-2, atol=1e-3)


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


def small_config():
    cfg = tiny_config()
    cfg["encoding"] = dict(cfg["encoding"], n_levels=4, log2_hashmap_size=12)
    cfg["network"] = dict(cfg["network"], n_neurons=16)
    cfg["rgb_network"] = dict(cfg["rgb_network"], n_neurons=16)
    return cfg


def port_dataset(ds):
    from sienerf_torch.io.nerf_dataset import NerfDataset

    return NerfDataset(images=np.asarray(ds.images), xforms=np.asarray(ds.xforms),
                       focal_lengths=np.asarray(ds.focal_lengths),
                       principal_points=np.asarray(ds.principal_points),
                       resolution=ds.resolution, aabb_scale=ds.aabb_scale)


@functools.lru_cache(maxsize=1)
def trained():
    """(JAX engine, JAX state after two bundles, its next key, port engine,
    the port's copy of that state, the dataset)."""
    from sienerf_tpu.engines.nerf import NerfEngine as JaxEngine
    from sienerf_torch.convert import train_state_from_jax
    from sienerf_torch.engines.nerf import NerfEngine

    ds = make_dataset()
    jeng = JaxEngine.create(small_config(), ds, train_batch_size=BATCH, grid_size=G,
                            train_k=TRAIN_K)
    st = jeng.init(0)
    key = jax.random.PRNGKey(0)
    for _ in range(2):
        key, sub = jax.random.split(key)
        st, _, _ = jeng.train_bundle(st, sub)
    eng = NerfEngine.create(small_config(), port_dataset(ds), train_batch_size=BATCH,
                            grid_size=G, train_k=TRAIN_K, device="cpu")
    eng._mean_samples = jeng._mean_samples
    tst = train_state_from_jax(jax.tree.map(np.asarray, st), device="cpu")
    return jeng, st, key, eng, tst, ds


def _t(a):
    return torch.from_numpy(np.array(a))


def test_engine_fields_and_state_carry_over():
    jeng, st, _, eng, tst, _ = trained()
    for name in ("train_n_rays", "train_k", "max_samples_per_ray",
                 "near_distance", "grid_interval", "dense_until", "dense_every_updates",
                 "min_transmittance", "use_error_map", "error_map_res", "error_map_warmup",
                 "loss_otype", "compact_training"):
        assert getattr(eng, name) == getattr(jeng, name), name
    assert eng.opt == type(eng.opt)(**jeng.opt.__dict__)
    assert eng._phase_geometry() == jeng._phase_geometry()
    np.testing.assert_array_equal(eng.visible_mask, np.asarray(jeng.visible_mask))
    assert tst["step"] == int(st["step"]) == 32
    assert tst["opt"]["step"] == 32 and tst["occ"]["n_updates"] == 2
    np.testing.assert_array_equal(tst["opt"]["ema"]["grid"].numpy(),
                                  np.asarray(st["opt"]["ema"]["grid"]))
    assert tst["emap"]["decay"] == float(np.float32(0.9995))


def test_phase_geometry_buckets_follow_the_reference():
    from sienerf_tpu.engines.nerf import NerfEngine as JaxEngine
    from sienerf_torch.engines.nerf import NerfEngine

    ds = make_dataset()
    jeng = JaxEngine.create(small_config(), ds, train_batch_size=1 << 18)
    eng = NerfEngine.create(small_config(), port_dataset(ds), train_batch_size=1 << 18,
                            device="cpu")
    assert eng._phase_geometry() == jeng._phase_geometry() == (256, 1024, 1664)
    for count in (700.0, 300.0, 90.0, 30.0, 6.0, 0.0, 120.0):
        jeng._update_phase(count, 0)
        eng._update_phase(count)
        assert eng._mean_samples == pytest.approx(jeng._mean_samples, rel=1e-12)
        assert eng._phase_geometry() == jeng._phase_geometry()


@pytest.mark.parametrize("M", [300, 4096])
def test_compact_samples_bit_equal(M):
    from sienerf_tpu.ops.raymarch import compact_samples as jcompact
    from sienerf_torch.ops.raymarch import compact_samples

    rng = np.random.default_rng(M)
    N, K = 64, 32
    ts = np.sort(rng.uniform(0, 2, (N, K)).astype(np.float32), axis=1)
    dts = rng.uniform(1e-3, 1e-2, (N, K)).astype(np.float32)
    counts = rng.integers(0, K + 1, N).astype(np.int32)
    want = jcompact(jnp.asarray(ts), jnp.asarray(dts), jnp.asarray(counts), M)
    got = compact_samples(_t(ts), _t(dts), _t(counts).long(), M)
    for name, a, b in zip(("t", "dt", "ray_id", "ray_start", "fits"), got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)
    assert got[2].dtype == torch.int32 and got[3].dtype == torch.int32
    if M == 300:  # some rays were dropped whole
        assert not bool(got[4].all())


def test_composite_flat_matches_within_the_cumsum_bound():
    from sienerf_tpu.ops.raymarch import compact_samples as jcompact
    from sienerf_tpu.ops.raymarch import composite_flat as jcomp
    from sienerf_torch.ops.raymarch import composite_flat

    rng = np.random.default_rng(3)
    N, K, M = 128, 48, 4096
    ts = np.sort(rng.uniform(0.1, 2.0, (N, K)).astype(np.float32), axis=1)
    dts = rng.uniform(1e-3, 2e-2, (N, K)).astype(np.float32)
    counts = rng.integers(0, K + 1, N).astype(np.int32)
    t, dt, rid, rstart, _ = [np.asarray(a) for a in jcompact(
        jnp.asarray(ts), jnp.asarray(dts), jnp.asarray(counts), M)]
    rgb = rng.uniform(0, 1, (M, 3)).astype(np.float32)
    dens = np.exp(rng.normal(1.5, 2.0, M)).astype(np.float32)
    wts = rng.normal(size=(4, N)).astype(np.float32)

    def jfn(c, d):
        outs = jcomp(c, d, jnp.asarray(t), jnp.asarray(dt), jnp.asarray(rid),
                     jnp.asarray(rstart), N)
        return sum(jnp.sum(o.reshape(N, -1).sum(-1) * w) for o, w in zip(outs, wts)), outs

    (_, want), (jg_rgb, jg_dens) = jax.value_and_grad(jfn, argnums=(0, 1), has_aux=True)(
        jnp.asarray(rgb), jnp.asarray(dens))
    c = _t(rgb).requires_grad_(True)
    d = _t(dens).requires_grad_(True)
    got = composite_flat(c, d, _t(t), _t(dt), _t(rid), _t(rstart), N)
    total = sum((o.reshape(N, -1).sum(-1) * _t(w)).sum() for o, w in zip(got, wts))
    g_rgb, g_dens = torch.autograd.grad(total, [c, d])
    alpha = np.where(rid < N, 1.0 - np.exp(-dens.astype(np.float64) * dt), 0.0)
    cmax = np.abs(np.cumsum(np.log1p(-np.minimum(alpha, 1 - 1e-7)))).max()
    assert cmax > 100.0  # opaque rays: the cumsum runs far from zero
    drift = 4 * 2.0 ** -24 * cmax  # relative drift of any transmittance
    for name, a, b in zip(("rgb", "opacity", "T", "depth"), got, want):
        b = np.asarray(b)
        np.testing.assert_allclose(a.detach().numpy(), b, rtol=1e-5 + drift, atol=1e-6,
                                   err_msg=name)
    for name, a, b in (("d rgb", g_rgb, jg_rgb), ("d density", g_dens, jg_dens)):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-5 + drift,
                                   atol=1e-6 + drift * np.abs(b).max(), err_msg=name)


def test_mark_untrained_cells_equal():
    from sienerf_tpu.ops.occupancy import OccupancyConfig as JOcc
    from sienerf_tpu.ops.occupancy import mark_untrained_cells as jmark
    from sienerf_torch.ops.occupancy import OccupancyConfig, mark_untrained_cells

    ds = make_dataset()
    res = np.asarray([ds.resolution] * ds.n_images, np.float32)
    xf = np.asarray(ds.xforms)[:3]  # three views see part of the grid
    want = np.asarray(jmark(JOcc(n_cascades=2, grid_size=G), xf, ds.focal_lengths, res))
    got = mark_untrained_cells(OccupancyConfig(n_cascades=2, grid_size=G), xf,
                               ds.focal_lengths, res)
    assert got.dtype == bool and 0.05 < got.mean() < 0.95
    np.testing.assert_array_equal(got, want)


def _jax_occupancy_draws(key, n_cascades, dense, n_samples):
    """The reference's draws inside update_density_grid, from its key."""
    n_cells = G ** 3
    if dense:
        keys = jax.random.split(key, n_cascades)
        return [{"cells": None, "u": _t(jax.random.uniform(keys[m], (n_cells, 3)))}
                for m in range(n_cascades)]
    keys = jax.random.split(key, 2 * n_cascades)
    return [{"cells": _t(jax.random.randint(keys[2 * m], (n_samples,), 0, n_cells)),
             "u": _t(jax.random.uniform(keys[2 * m + 1], (n_samples, 3)))}
            for m in range(n_cascades)]


@pytest.mark.parametrize("dense", [True, False])
def test_occupancy_update_from_the_reference_draws(dense):
    """The engines' updates from the trained state, the reference run op by
    op (under jit XLA may contract the hash encode's pos * scale + 0.5 into
    a fused multiply-add and move single samples into other cells)."""
    from sienerf_tpu.ops.occupancy import update_density_grid as jupdate

    jeng, st, key, eng, tst, _ = trained()
    key = jax.random.fold_in(key, 11)
    n = G ** 3 // 4  # a quarter of the cells a cascade, as at full size
    draws = _jax_occupancy_draws(key, jeng.occ.n_cascades, dense, n)
    with jax.disable_jit():
        want = jupdate(jeng.occ, st["occ"], jeng._density_fn(st["params"]), key,
                       jnp.asarray(jeng.aabb.min), jnp.asarray(jeng.aabb.diag),
                       jeng.data["visible_mask"], dense=dense, n_samples_per_cascade=n)
    got = eng.occupancy_update(tst, draws)["occ"]
    wd = np.asarray(want["density"])
    np.testing.assert_allclose(got["density"].numpy(), wd, rtol=1e-5, atol=1e-7)
    thresh = min(float(want["mean_density"]), 0.01)
    # the mean of cascade 0: the port's is the float64 mean of its f32
    # densities to 1e-6; the reference's eager f32 reduction carries up to
    # n * 2^-24 of summation error (2.7e-4 here)
    exact = np.maximum(got["density"][0].numpy(), 0.0).astype(np.float64).mean()
    np.testing.assert_allclose(float(got["mean_density"]), exact, rtol=1e-6)
    np.testing.assert_allclose(float(want["mean_density"]), exact, rtol=G ** 3 * 2.0 ** -24)
    near = np.abs(wd - thresh) <= 1e-6
    diff = got["bitfield"].numpy() != np.asarray(want["bitfield"])
    assert not (diff & ~near).any()
    assert 0.0 < np.asarray(want["bitfield"]).mean() < 1.0
    assert got["n_updates"] == int(want["n_updates"]) == 3
    assert (wd[~np.asarray(jeng.visible_mask)] == -1.0).all()


def test_error_map_splat_and_sampler_equal():
    from sienerf_tpu.ops import importance as jimp
    from sienerf_torch.ops import importance as timp

    rng = np.random.default_rng(5)
    n, n_img = 2048, 6
    emap = {"error": rng.uniform(0, 2, (n_img, 32, 32)).astype(np.float32)}
    emap["error"][2] = 0.0  # an image with no error yet
    img = rng.integers(0, n_img, n).astype(np.int32)
    u, v = rng.random(n).astype(np.float32), rng.random(n).astype(np.float32)
    losses = rng.exponential(0.05, n).astype(np.float32)
    jm = {"error": jnp.asarray(emap["error"]), "decay": jnp.float32(0.9995)}
    tm = {"error": _t(emap["error"]), "decay": 0.9995}
    want = jimp.splat_errors(jm, jnp.asarray(img), jnp.asarray(u), jnp.asarray(v),
                             jnp.asarray(losses))
    got = timp.splat_errors(tm, _t(img), _t(u), _t(v), _t(losses))
    np.testing.assert_array_equal(got["error"].numpy(), np.asarray(want["error"]))

    key = jax.random.PRNGKey(9)
    k1, k2, k3, k4 = jax.random.split(key, 4)
    draws = {"u_img": _t(jax.random.uniform(k1, (n,))),
             "u_row": _t(jax.random.uniform(k2, (n,))),
             "u_col": _t(jax.random.uniform(k3, (n,))),
             "jitter": _t(jax.random.uniform(k4, (n, 2)))}
    want = jimp.sample_error_map(want, key, n)
    got = timp.sample_error_map(got, draws)
    for name, a, b in zip(("img_idx", "u", "v"), got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)


def _jax_step_draws(key, n_rays, n_images, error_map):
    """The reference's draws of one step (_sample_training_rays and the
    jitter of _loss_for_batch), re-created from its key."""
    _, kpix, kbg = jax.random.split(key, 3)
    d = {"bg": _t(jax.random.uniform(kbg, (n_rays, 3))),
         "jitter": _t(jax.random.uniform(jax.random.fold_in(key, 7), (n_rays,)))}
    if error_map:
        k1, k2, k3, k4 = jax.random.split(kpix, 4)
        d["emap"] = {"u_img": _t(jax.random.uniform(k1, (n_rays,))),
                     "u_row": _t(jax.random.uniform(k2, (n_rays,))),
                     "u_col": _t(jax.random.uniform(k3, (n_rays,))),
                     "jitter": _t(jax.random.uniform(k4, (n_rays, 2)))}
    else:
        k1, k2 = jax.random.split(kpix)
        d["img_idx"] = _t(jax.random.randint(k1, (n_rays,), 0, n_images))
        d["uv"] = _t(jax.random.uniform(k2, (n_rays, 2)))
    return d


def _assert_grads_close(jg, tg):
    for name in ("density_mlp", "rgb_mlp"):
        for i, (a, b) in enumerate(zip(jg[name], tg[name])):
            a, b = np.asarray(a), b.numpy()
            np.testing.assert_allclose(b, a, **STEP_TOL, err_msg=f"{name}[{i}]")
            assert np.abs(b - a).max() <= 0.02 * np.abs(a).max(), f"{name}[{i}]"
    a, b = np.asarray(jg["grid"]), tg["grid"].numpy()
    assert np.abs(b - a).max() <= 0.02 * np.abs(a).max()


@pytest.mark.parametrize("error_map", [False, True])
def test_one_training_step_matches_the_reference(error_map):
    jeng, st, key, eng, tst, ds = trained()
    n_rays, k, iters = jeng._phase_geometry()
    key = jax.random.fold_in(key, 1 + error_map)
    if error_map:  # past the error map's warm-up
        st = dict(st, step=jnp.asarray(300, jnp.int32))
        tst = dict(tst, step=300)
    draws = _jax_step_draws(key, n_rays, ds.n_images, error_map)
    assert ("emap" in eng.draw_step(torch.Generator().manual_seed(0), n_rays,
                                    tst["step"])) == error_map

    def loss_of(p):
        return jeng._loss_for_batch(p, st["occ"]["bitfield"], jeng.data, key, n_rays,
                                    st["emap"], st["step"], k, iters)

    (jloss, jaux), jg = jax.jit(jax.value_and_grad(loss_of, has_aux=True))(st["params"])
    loss, tg, aux = eng.loss_and_grads(tst, draws, k, iters)
    np.testing.assert_array_equal(aux[0].numpy(), np.asarray(jaux[0]))  # samples a ray
    assert int(aux[0].sum()) > 4 * n_rays
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-4)
    _assert_grads_close(jg, tg)

    # per-ray losses: under jit, XLA contracts the hash encode's
    # pos * scale + 0.5 into a fused multiply-add, which can move a sample
    # into the next cell (run op by op, the reference gives every ray's
    # loss to 5e-8); at most 2 % of the rays may differ beyond 1e-6
    d_ray = np.abs(aux[1].detach().numpy().astype(np.float64) - np.asarray(jaux[1]))
    assert (d_ray > 1e-6).sum() <= max(1, 0.02 * n_rays)
    np.testing.assert_array_equal(aux[2][0].numpy(), np.asarray(jaux[2][0]))
    # pixel centres (px + 0.5) / w: XLA under jit multiplies by 1 / w
    for a, b in zip(aux[2][1:], jaux[2][1:]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2.0 ** -23)

    want, _, _ = jax.jit(lambda s: jeng._train_one_step(s, jeng.data, key, n_rays, None, k,
                                                        iters))(st)
    got, loss2, cnt = eng.train_step(tst, draws, k, iters)
    assert got["step"] == int(want["step"]) == tst["step"] + 1
    assert got["opt"]["step"] == int(want["opt"]["step"])
    # the error map: equal to rounding, but for the texels of those rays,
    # which differ by their rays' loss difference
    img, u, v = (x.numpy() for x in aux[2])
    eh = ew = eng.error_map_res
    flat = (img * eh + np.minimum((v * eh).astype(np.int64), eh - 1)) * ew \
        + np.minimum((u * ew).astype(np.int64), ew - 1)
    moved_by = np.zeros(got["emap"]["error"].numel())
    np.add.at(moved_by, flat, d_ray)
    want_e = np.asarray(want["emap"]["error"]).reshape(-1)
    err = np.abs(got["emap"]["error"].numpy().reshape(-1) - want_e)
    assert (err <= 1e-7 + 1e-6 * np.abs(want_e) + 1.01 * moved_by).all()
    assert float(loss2) == float(loss)
    assert float(cnt) == pytest.approx(float(aux[0].float().mean()))


def test_port_training_run_loss_falls():
    """Four bundles of the port alone, drawing from its own generator."""
    from sienerf_torch.engines.nerf import NerfEngine

    eng = NerfEngine.create(small_config(), port_dataset(make_dataset()),
                            train_batch_size=BATCH, grid_size=G, train_k=TRAIN_K,
                            device="cpu")
    state = eng.init(0)
    gen = torch.Generator().manual_seed(0)
    losses = []
    for _ in range(4):
        stats = {}
        state, loss, cnt = eng.train_bundle(state, gen, stats)
        losses.append(float(loss))
        assert np.isfinite(losses[-1]) and float(cnt) > 0
        assert stats["n_rays"] * stats["k"] >= BATCH
    assert losses[-1] <= 0.5 * losses[0], losses
    assert state["step"] == 64 and state["occ"]["n_updates"] == 4
    assert 0.0 < float(state["occ"]["bitfield"].float().mean()) < 0.5
    # the EMA shadow trails the raw params
    assert not torch.equal(state["opt"]["ema"]["grid"], state["params"]["grid"])
    # the eval protocol: live frames of the EMA params at training cameras
    mean, per_view = eng.eval_psnr(state, [0, 5])
    assert len(per_view) == 2 and mean == pytest.approx(np.mean(per_view))
    assert 12.0 < mean < 60.0


def test_cell_center_and_camera_conversions_match():
    from sienerf_tpu.io import nerf_dataset as jds
    from sienerf_tpu.ops.occupancy import cell_center as jcell_center
    from sienerf_torch.io import nerf_dataset as tds
    from sienerf_torch.ops.occupancy import cell_center

    rng = np.random.default_rng(8)
    idx = rng.integers(0, G, (100, 3)).astype(np.int32)
    mip = rng.integers(0, 3, 100).astype(np.int32)
    np.testing.assert_array_equal(
        cell_center(_t(idx), _t(mip), G).numpy(),
        np.asarray(jcell_center(jnp.asarray(idx), jnp.asarray(mip), G)))
    m = rng.normal(size=(4, 4)).astype(np.float32)
    p = rng.normal(size=(10, 3)).astype(np.float32)
    off = np.asarray([0.5, 0.4, 0.6], np.float32)
    for name, x in (("nerf_matrix_to_ngp", m), ("ngp_matrix_to_nerf", m[:3]),
                    ("nerf_position_to_ngp", p), ("ngp_position_to_nerf", p)):
        np.testing.assert_array_equal(getattr(tds, name)(x, 0.33, off),
                                      getattr(jds, name)(x, 0.33, off), err_msg=name)


@pytest.mark.parametrize("flag,value", [("optimize_extrinsics", True),
                                        ("optimize_focal", True),
                                        ("optimize_exposure", True),
                                        ("optimize_distortion", True),
                                        ("near_density_reg", 0.1),
                                        ("depth_supervision_lambda", 0.5),
                                        ("rolling_shutter", np.zeros(4, np.float32)),
                                        ("compact_training", False)])
def test_slice_c2_options_raise(flag, value):
    """Each learner and loss term of Slice C2b, once raising, trains a step
    from the trained state: its leaf is made and moves, the loss is
    finite."""
    import dataclasses

    eng = dataclasses.replace(trained()[3], **{flag: value})
    state = dict(trained()[4])
    fresh = eng.init(0)
    leaf = {"optimize_extrinsics": "cam", "optimize_focal": "focal",
            "optimize_exposure": "exposure", "optimize_distortion": "distortion"}.get(flag)
    if leaf:
        state["params"] = dict(state["params"], **{leaf: fresh["params"][leaf]})
        state["opt"] = {**state["opt"], **{k: dict(state["opt"][k], **{leaf: fresh["opt"][k][leaf]})
                                          for k in ("m", "v", "ema")}}
    n_rays, k, iters = eng._phase_geometry()
    draws = eng.draw_step(torch.Generator().manual_seed(0), n_rays, int(state["step"]))
    new, loss, cnt = eng.train_step(state, draws, k, iters)
    assert np.isfinite(float(loss)) and float(cnt) > 0
    if leaf:
        assert not torch.equal(new["params"][leaf], state["params"][leaf])


@pytest.mark.parametrize("field", ["light_dirs", "envmap", "xforms_end", "depths"])
def test_slice_c2_dataset_fields_raise(field):
    """Each dataset field of Slice C2b, once raising, reaches the engine:
    light directions widen the colour MLP by 3 fixed dims, an envmap
    turns on the trainable envmap, end cameras rolling shutter, depth
    images depth supervision's target."""
    import dataclasses

    from sienerf_torch.engines.nerf import NerfEngine

    ds = port_dataset(make_dataset())
    value = {"light_dirs": np.zeros((ds.n_images, 3), np.float32),
             "envmap": np.zeros((4, 8, 4), np.float32),
             "xforms_end": ds.xforms, "depths": ds.images[..., 0]}[field]
    eng = NerfEngine.create(small_config(), dataclasses.replace(ds, **{field: value}),
                            grid_size=G, device="cpu")
    params = eng.init(0)["params"]
    if field == "light_dirs":
        assert eng.net.n_extra_dims == 3 and not eng.optimize_extra_dims
        assert torch.equal(params["extra_dims"], torch.full((ds.n_images, 3), 0.5))
    elif field == "envmap":
        assert eng.train_envmap and params["envmap"].shape == (4, 8, 4)
    elif field == "xforms_end":
        assert eng.rolling_shutter is not None and "xforms_end" in eng.data
    else:
        assert torch.equal(eng.data["depths"], torch.from_numpy(ds.images[..., 0]))
