"""The multi-device paths, port vs reference, on the CPU.  The port's ranks
are spawned processes joined through gloo (parallel/mesh.py::run_ranks,
every spawn under a 60 s deadline, one torch thread a rank); the
reference's sharded functions run in the test process on make_ray_mesh(n)
of the 8 virtual CPU devices of tests/conftest.py, n the port's world size
(2 and 4).  One spawn a world size runs every sharded path of the port
(_port_body), one more the sharded bundles (_bundle_body); the tests read
their results.

The field is the small network of tests/test_torch_train.py trained six
bundles by the reference on the ball scene of tests/test_nerf_mode.py,
carried across by convert.py (params, training state, an R=32 bake).  The
rank bodies import no JAX (a spawned rank imports this module and checks):
the reference's work happens in the test process, and the ranks get numpy.

Tolerances:
- shard_range, gather, replicate: equal.
- Sharded live and baked frames (and multi-view): the same on every rank,
  and against the same function of the port on one device (render_rays or
  render_rays_baked over every ray in one batch) rgba atol 1e-4, depth atol
  1e-3, the reference's own bar for its sharded frames
  (tests/test_multichip.py).  Against the reference's sharded frames the
  live frame's rule (tests/test_torch_live.py, tests/test_torch_baked.py):
  at least 99 % of the pixels within rtol 2e-2 / atol 5e-3 and a PSNR
  above 40 dB (XLA may contract o + t*d into a fused multiply-add and move
  a sample across a voxel boundary).
- sweep_composite_sharded on the volume of tests/test_sweep.py's sharded
  test (K=2, R=16), against the reference's at min transmittance 0 and 0.3
  (each rank cuts at its own transmittance, as the reference's devices
  do), and against the port's one-device sweep at 0: rgb, opacity, T atol
  2e-5, depth atol 1e-4 (tests/test_sweep.py).
- prepare_rgba_volume_sharded: bit-equal to the one-device
  prepare_rgba_volume; the reference's within the shade tolerance rtol
  2e-2 / atol 2e-3 (tests/test_shade_pallas.py).
- render_frame_sweep_multichip: at min transmittance 0 rgba atol 1e-4 and
  depth atol 1e-3 from the port's one-device frame (tests/test_sweep.py);
  at 0 and at the default within rtol 2e-2 / atol 5e-3 of the reference's
  sharded frame (tests/test_torch_frame.py).
- The sharded training step: params, loss, mean samples a ray and the error
  map bit-equal on every rank to the port's one-process mean of the
  per-shard gradients (summed in rank order, as the ranks sum them).
  Against the reference's hand-averaged step of the same per-shard draws:
  loss, mean samples and error map rtol 2e-4 / atol 1e-6
  (tests/test_multichip.py); the mean gradients within the one-step gap of
  tests/test_torch_train.py; the params within rtol 2e-4 / atol 1e-6 on at
  least 98 % of each leaf and within a tenth of the learning rate
  everywhere (test_sharded_step_equals_the_mean says why).
- The sharded bundle: replicas bit-equal on every rank, two runs from one
  seed bit-equal."""

import functools
import sys
import time

import numpy as np
import pytest
import torch

from sienerf_torch.parallel.mesh import (
    all_gather,
    gather_rows,
    make_ray_mesh,
    ordered_mean,
    ordered_sum,
    replicate,
    run_ranks,
    shard_range,
)

WORLDS = (2, 4)
DEADLINE_S = 60.0
G = 32
BATCH = 1 << 12
TRAIN_K = 16
RES = 24          # frames RES x RES
TILE = 64         # rays a tile of the sharded frames
N_LOCAL = 256     # rays a rank of the sharded training step
K, R = 2, 16      # the sharded composite's volume
NEAR = 0.05
MIN_TS = (0.0, 0.3)
PREP_CAM = (1.7, 0.4, 0.3)
ONE_DEVICE = dict(atol=1e-4)
DEPTH_ONE_DEVICE = dict(atol=1e-3)
COMPOSITE_TOL = dict(atol=2e-5)
DEPTH_T_TOL = dict(atol=1e-4)
STEP_TOL = dict(rtol=2e-4, atol=1e-6)


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


# --- the ranks: no JAX here ------------------------------------------------------


def _engine(payload):
    from sienerf_torch.engines.nerf import NerfEngine
    from sienerf_torch.io.nerf_dataset import NerfDataset

    eng = NerfEngine.create(payload["config"], NerfDataset(**payload["dataset"]),
                            train_batch_size=BATCH, grid_size=G, train_k=TRAIN_K,
                            device="cpu")
    eng._mean_samples = payload["mean_samples"]
    return eng


def _cam(payload, v):
    ds = payload["dataset"]
    return ds["xforms"][v], tuple(float(f) * RES / ds["resolution"][0]
                                  for f in ds["focal_lengths"][v])


def _field(payload):
    from sienerf_torch.convert import baked_grid_from_jax, params_from_jax

    return (params_from_jax(payload["params"], "cpu"),
            torch.from_numpy(payload["bitfield"].copy()),
            baked_grid_from_jax(payload["grid"], "cpu"), payload["meta"])


def _oriented(v):
    from sienerf_torch.ops.sweep import orient_grid

    return orient_grid(torch.from_numpy(v["vol"]).to(torch.bfloat16), 0, False)


def _port_frames(mesh, payload, eng):
    """Every sharded frame (live, multi-view, baked, sweep), the sharded
    composite and shade, replicate and gather."""
    from sienerf_torch.engines.nerf_baked import render_frame_baked_multichip
    from sienerf_torch.engines.nerf_sweep import (
        prepare_rgba_volume_sharded,
        render_frame_sweep_multichip,
    )
    from sienerf_torch.ops.sweep_kernel import sweep_composite_sharded

    params, bf, grid, meta = _field(payload)
    cam, fl = _cam(payload, 1)
    out = {"frame": eng.render_frame_multichip(params, bf, RES, RES, cam, fl, mesh, tile=TILE)}
    cams = [_cam(payload, v) for v in (1, 2, 3)]
    out["views"] = eng.render_views_multichip(params, bf, RES, RES, [c for c, _ in cams],
                                              [f for _, f in cams], mesh, tile=TILE)
    out["baked"] = render_frame_baked_multichip(
        eng, params, bf, grid, cam, fl, mesh, width=RES, height=RES,
        resolution=meta["resolution"], mode=meta["mode"], n_cascades=meta["n_cascades"],
        tile=TILE, candidates=64, evals=16, min_transmittance=1e-4)
    out["sweep"] = {mt: render_frame_sweep_multichip(eng, params, grid, meta, cam, fl, mesh,
                                                     width=RES, height=RES,
                                                     min_transmittance=mt)
                    for mt in (0.0, None)}
    out["prep"] = prepare_rgba_volume_sharded(
        eng, params, grid["rows"], grid["scale"], torch.tensor(PREP_CAM),
        meta["resolution"], meta["n_cascades"], mesh)
    v = payload["volume"]
    out["composite"] = {
        mt: sweep_composite_sharded(mesh, _oriented(v), torch.from_numpy(v["o_c"]),
                                    torch.from_numpy(v["eb"]), torch.from_numpy(v["ec"]),
                                    NEAR, mt, resolution=R, n_cascades=K)
        for mt in MIN_TS}
    # replicate: rank r's tree holds r everywhere; rank 0's wins
    tree = {"a": torch.full((5,), float(mesh.rank)), "b": [torch.full((2, 3), mesh.rank)],
            "n": mesh.rank}
    out["replicated"] = replicate(tree, mesh)
    out["gathered"] = gather_rows(torch.arange(*shard_range(11, mesh.world, mesh.rank)), 11,
                                  mesh)
    return out


def _draws(d):
    return {k: (_draws(v) if isinstance(v, dict) else torch.from_numpy(v)) for k, v in d.items()}


def _port_step(mesh, payload, eng):
    """One sharded training step from the reference's per-shard draws, and
    on rank 0 the one-process mean of the per-shard gradients."""
    from sienerf_torch.convert import train_state_from_jax
    from sienerf_torch.models.nerf_network import nerf_l2_mask
    from sienerf_torch.ops.importance import splat_errors
    from sienerf_torch.ops.optim import optim_step, tree_leaves, tree_unflatten

    st = train_state_from_jax(payload["state"], "cpu")
    k, iters = payload["k"], payload["iters"]
    draws = [_draws(d) for d in payload["draws"]]
    new, loss, cnt = eng.train_step(st, draws[mesh.rank], k, iters, mesh=mesh)
    out = {"params": new["params"], "loss": loss, "cnt": cnt, "emap": new["emap"]["error"]}
    if mesh.rank == 0:
        per = [eng.loss_and_grads(st, d, k, iters) for d in draws]
        grads = [tree_leaves(g) for _, g, _ in per]
        mean = tree_unflatten(st["params"], [ordered_mean(list(g)) for g in zip(*grads)])
        params, _ = optim_step(eng.opt, st["opt"], st["params"], mean,
                               nerf_l2_mask(st["params"]), None)
        # each shard's splat alone (decay 0 adds it to zeros exactly), summed
        # in rank order, then the decayed map
        zero = {"error": torch.zeros_like(st["emap"]["error"]), "decay": 0.0}
        adds = [splat_errors(zero, *aux[2], aux[1].detach())["error"] for _, _, aux in per]
        err = st["emap"]["error"] * st["emap"]["decay"] + ordered_sum(adds)
        out["one_process"] = {
            "params": params, "loss": ordered_mean([lo for lo, _, _ in per]),
            "cnt": ordered_mean([aux[0].float().mean() for _, _, aux in per]),
            "emap": err, "grads": mean}
    return out


def _bundle_body(mesh, payload):
    """Two sharded bundles from one seed, twice."""
    from sienerf_torch.convert import train_state_from_jax

    _rank_setup()
    runs = []
    for _ in range(2):
        eng = _engine(payload)
        eng.grid_interval = 4  # steps a bundle: the test's time
        st = train_state_from_jax(payload["state"], "cpu")
        gen = torch.Generator().manual_seed(5)
        losses = []
        for _ in range(2):
            st, loss, _ = eng.train_bundle_multichip(st, gen, mesh)
            losses.append(float(loss))
        runs.append({"params": st["params"], "bitfield": st["occ"]["bitfield"],
                     "density": st["occ"]["density"], "emap": st["emap"]["error"],
                     "losses": np.asarray(losses), "step": st["step"],
                     "n_rays": eng._phase_geometry()[0]})
    return runs


def _rank_setup():
    torch.set_num_threads(1)
    assert "jax" not in sys.modules, "a rank imported JAX"


def _port_body(mesh, payload):
    _rank_setup()
    eng = _engine(payload)
    out = _port_frames(mesh, payload, eng)
    out["step"] = _port_step(mesh, payload, eng)
    return out


def _hang_body(mesh):
    if mesh.rank == 0:
        all_gather(torch.zeros(1), mesh)  # rank 1 never joins
    else:
        time.sleep(3 * DEADLINE_S)


def _raise_body(mesh):
    if mesh.rank == 1:
        raise ValueError("rank 1 fails")
    all_gather(torch.zeros(1), mesh)


def spawn(fn, world, *args, timeout_s=DEADLINE_S):
    return run_ranks(fn, world, "gloo", ["cpu"] * world, *args, timeout_s=timeout_s)


# --- the reference, in the test process ------------------------------------------


def volume():
    """tests/test_sweep.py::test_sweep_sharded_matches_single's inputs."""
    Rv = R + 1
    rng = np.random.default_rng(7)
    vol = np.zeros((K, Rv, Rv, Rv, 4), np.float32)
    sig = rng.uniform(0, 3.0, size=(K, Rv, Rv, Rv)) * (rng.uniform(size=(K, Rv, Rv, Rv)) < 0.2)
    vol[..., 3] = sig
    vol[..., :3] = sig[..., None] * rng.uniform(size=(K, Rv, Rv, Rv, 3))
    return dict(vol=vol, o_c=np.asarray([-1.3, 0.45, 0.5], np.float32),
                eb=np.linspace(-0.2, 0.25, 12).astype(np.float32),
                ec=np.linspace(-0.22, 0.2, 9).astype(np.float32))


@functools.lru_cache(maxsize=1)
def field():
    """(JAX engine, its state after six bundles, the ranks' payload)."""
    import jax

    from sienerf_tpu.engines.nerf import NerfEngine as JaxEngine
    from sienerf_tpu.engines.nerf_baked import bake_feature_grid
    from sienerf_tpu.ops.optim import inference_params
    from test_nerf_mode import make_dataset
    from test_torch_train import small_config

    ds = make_dataset()
    jeng = JaxEngine.create(small_config(), ds, train_batch_size=BATCH, grid_size=G,
                            train_k=TRAIN_K)
    st = jeng.init(0)
    key = jax.random.PRNGKey(0)
    for _ in range(6):  # the ball covers ~8 % of a frame (11 % of the images)
        key, sub = jax.random.split(key)
        st, _, _ = jeng.train_bundle(st, sub)
    params = inference_params(st["opt"], st["params"])
    # the bitfield a jit argument: closed over, XLA constant-folds the
    # bake's distance-field sidecar (tests/test_torch_snapshot.py)
    bake = jax.jit(lambda p, b: bake_feature_grid(jeng, p, b, 32, mode="nearest")[0])
    grid = bake(params, st["occ"]["bitfield"])
    payload = {
        "config": small_config(),
        "dataset": dict(images=np.asarray(ds.images), xforms=np.asarray(ds.xforms),
                        focal_lengths=np.asarray(ds.focal_lengths),
                        principal_points=np.asarray(ds.principal_points),
                        resolution=tuple(ds.resolution), aabb_scale=ds.aabb_scale),
        "mean_samples": jeng._mean_samples,
        "params": jax.tree.map(np.asarray, params),
        "bitfield": np.asarray(st["occ"]["bitfield"]),
        "grid": jax.tree.map(np.asarray, grid),
        "meta": {"resolution": 32, "mode": "nearest",
                 "n_cascades": int(st["occ"]["bitfield"].shape[0])},
        "state": jax.tree.map(np.asarray, st),
    }
    return jeng, st, payload


def _step_keys(world):
    """The reference's per-shard step keys: fold_in(step_key, i), as its
    sharded step folds them."""
    import jax

    return [jax.random.fold_in(jax.random.PRNGKey(7), i) for i in range(world)]


@functools.lru_cache(maxsize=4)
def port_run(world):
    """Every rank's results of _port_body."""
    from test_torch_train import _jax_step_draws

    jeng, _, payload = field()
    _, k, iters = jeng._phase_geometry()
    n_images = payload["dataset"]["images"].shape[0]
    draws = [{name: (v.numpy() if isinstance(v, torch.Tensor)
                     else {n2: w.numpy() for n2, w in v.items()})
              for name, v in _jax_step_draws(kk, N_LOCAL, n_images, False).items()}
             for kk in _step_keys(world)]
    return spawn(_port_body, world, dict(payload, k=k, iters=iters, draws=draws,
                                         volume=volume()))


@functools.lru_cache(maxsize=1)
def _jax_loss_grad():
    import jax

    jeng, st, _ = field()
    _, k, iters = jeng._phase_geometry()

    def loss_of(p, kk):
        return jeng._loss_for_batch(p, st["occ"]["bitfield"], jeng.data, kk, N_LOCAL,
                                    st["emap"], st["step"], k, iters)

    return jax.jit(jax.value_and_grad(loss_of, has_aux=True))


@functools.lru_cache(maxsize=4)
def jax_step(world):
    """The reference's hand-averaged step over `world` shards of N_LOCAL
    rays (tests/test_multichip.py::test_sharded_step_equals_mean_of_per_shard_grads)."""
    import jax
    import jax.numpy as jnp

    from sienerf_tpu.models.nerf_network import nerf_l2_mask as jmask
    from sienerf_tpu.ops.importance import splat_errors as jsplat
    from sienerf_tpu.ops.optim import optim_step as jstep

    jeng, st, _ = field()
    acc, losses, cnts, metas, per_rays = None, [], [], [], []
    for kk in _step_keys(world):
        (loss_i, (counts_i, per_ray_i, meta_i)), g_i = _jax_loss_grad()(st["params"], kk)
        losses.append(float(loss_i))
        cnts.append(float(jnp.mean(counts_i.astype(jnp.float32))))
        metas.append(meta_i)
        per_rays.append(per_ray_i)
        acc = g_i if acc is None else jax.tree.map(jnp.add, acc, g_i)
    grads = jax.tree.map(lambda x: x / world, acc)
    params, _ = jstep(jeng.opt, st["opt"], st["params"], grads, jmask(st["params"]), None)
    cat = lambda xs: jnp.concatenate([jnp.asarray(x) for x in xs])  # noqa: E731
    emap = jsplat(st["emap"], cat([m[0] for m in metas]), cat([m[1] for m in metas]),
                  cat([m[2] for m in metas]), cat(per_rays))
    return {"params": jax.tree.map(np.asarray, params), "loss": np.mean(losses),
            "cnt": np.mean(cnts), "emap": np.asarray(emap["error"]),
            "grads": jax.tree.map(np.asarray, grads)}


@functools.lru_cache(maxsize=4)
def jax_frames(world):
    import jax.numpy as jnp

    from sienerf_tpu.engines.nerf_baked import render_frame_baked_multichip
    from sienerf_tpu.engines.nerf_sweep import render_frame_sweep_multichip
    from sienerf_tpu.parallel.mesh import make_ray_mesh as jax_mesh

    jeng, _, payload = field()
    mesh = jax_mesh(world)
    params, bf, grid, meta = (payload["params"], payload["bitfield"], payload["grid"],
                              payload["meta"])
    cam, fl = _cam(payload, 1)
    out = {"frame": jeng.render_frame_multichip(params, bf, RES, RES, cam, fl, mesh, tile=TILE)}
    cams = [_cam(payload, v) for v in (1, 2, 3)]
    out["views"] = jeng.render_views_multichip(
        params, bf, RES, RES, jnp.asarray(np.stack([c for c, _ in cams])),
        jnp.asarray(np.asarray([f for _, f in cams], np.float32)), mesh, tile=TILE)
    out["baked"] = render_frame_baked_multichip(
        jeng, params, bf, grid, cam, fl, mesh, width=RES, height=RES,
        resolution=meta["resolution"], mode=meta["mode"], n_cascades=meta["n_cascades"],
        tile=TILE, candidates=64, evals=16, min_transmittance=1e-4)
    for mt in (0.0, None):
        out[("sweep", mt)] = render_frame_sweep_multichip(
            jeng, params, grid, meta, cam, fl, mesh, width=RES, height=RES,
            min_transmittance=mt)
    return {k: tuple(np.asarray(a) for a in v) for k, v in out.items()}


def hold_frame(got: np.ndarray, want: np.ndarray):
    """The live frame's rule (tests/test_torch_baked.py)."""
    from sienerf_torch.metrics import psnr

    assert got.shape == want.shape and np.isfinite(got).all()
    ok = np.abs(got - want) <= 5e-3 + 2e-2 * np.abs(want)
    assert ok.all(axis=-1).mean() >= 0.99
    assert psnr(got[..., :3], want[..., :3]) > 40.0


def _same_on_every_rank(outs, pick):
    for r, o in enumerate(outs[1:], 1):
        for a, b in zip(_leaves(pick(o)), _leaves(pick(outs[0]))):
            np.testing.assert_array_equal(a, b, err_msg=f"rank {r} vs rank 0")


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in tree for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [np.asarray(tree)]


def _one_device_rays(ray_fn):
    """A frame of view 1 through ray_fn over all its rays in one batch,
    filled as the sharded frames fill theirs."""
    from sienerf_torch.engines.nerf import NerfEngine
    from sienerf_torch.utils.camera import pixel_grid_uv, uv_to_ray

    payload = field()[2]
    eng = _engine(payload)
    cam, fl = _cam(payload, 1)
    o, d = uv_to_ray(pixel_grid_uv(RES, RES).reshape(-1, 2), (RES, RES), fl, cam,
                     lens=eng.lens)
    rgb, op, depth = ray_fn(eng, o, d)
    rgb = NerfEngine._background_fill(rgb, op, d, {}, (0.0, 0.0, 0.0))
    return (torch.cat([rgb, op[:, None]], -1).reshape(RES, RES, 4).numpy(),
            depth.reshape(RES, RES).numpy())


# --- tests ----------------------------------------------------------------------


@pytest.mark.parametrize("n,world", [(1, 1), (7, 2), (10, 4), (3, 4), (128, 3), (771, 4)])
def test_shard_range_covers_every_item_once(n, world):
    ranges = [shard_range(n, world, r) for r in range(world)]
    items = [i for lo, hi in ranges for i in range(lo, hi)]
    assert items == list(range(n))
    per = -(-n // world)  # the JAX package's padded share
    assert all(hi - lo <= per for lo, hi in ranges)
    assert ranges[0] == (0, min(per, n))


def test_make_ray_mesh_needs_a_process_group():
    with pytest.raises(RuntimeError, match="no process group"):
        make_ray_mesh(2, "cpu")


@pytest.mark.parametrize("case", ["hang", "raise"])
def test_run_ranks_fails_instead_of_hanging(case):
    t = time.monotonic()
    if case == "hang":
        with pytest.raises(TimeoutError, match="deadline"):
            spawn(_hang_body, 2, timeout_s=5.0)
    else:
        with pytest.raises(RuntimeError, match="rank 1 fails"):
            spawn(_raise_body, 2, timeout_s=30.0)
    assert time.monotonic() - t < 25.0


@pytest.mark.parametrize("world", WORLDS)
def test_replicate_and_gather(world):
    for r, out in enumerate(port_run(world)):
        np.testing.assert_array_equal(out["replicated"]["a"], np.zeros(5, np.float32))
        np.testing.assert_array_equal(out["replicated"]["b"][0], np.zeros((2, 3)))
        assert out["replicated"]["n"] == r  # not a tensor: left as it was
        np.testing.assert_array_equal(out["gathered"], np.arange(11))


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("what", ["frame", "baked"])
def test_sharded_frames_match(what, world):
    """The sharded live and baked frames: the same on every rank, the
    port's one-device function over all rays, and held to the reference's
    sharded frame."""
    from sienerf_torch.engines.nerf_baked import render_rays_baked

    outs = port_run(world)
    _same_on_every_rank(outs, lambda o: o[what])
    rgba, depth = outs[0][what]
    params, bf, grid, meta = _field(field()[2])
    if what == "frame":
        def ray_fn(eng, o, d):
            return eng.render_rays(eng._render_params(params), bf, o, d)
    else:
        def ray_fn(eng, o, d):
            return render_rays_baked(eng, params, grid, meta, bf, o, d, P=64, evals=16,
                                     min_transmittance=1e-4, init_advance_iters=32)
    one, one_depth = _one_device_rays(ray_fn)
    np.testing.assert_allclose(rgba, one, **ONE_DEVICE)
    np.testing.assert_allclose(depth, one_depth, **DEPTH_ONE_DEVICE)
    alpha = rgba[..., 3]
    assert alpha.max() > 0.15 and (alpha < 0.01).any()  # hits and misses
    hold_frame(rgba, jax_frames(world)[what][0])


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_views_match(world):
    """Three views in one sharded stream: view 0 is the port's sharded
    frame of its camera, and each is held to the reference's views."""
    outs = port_run(world)
    _same_on_every_rank(outs, lambda o: o["views"])
    rgba, depth = outs[0]["views"]
    assert rgba.shape == (3, RES, RES, 4) and depth.shape == (3, RES, RES)
    np.testing.assert_allclose(rgba[0], outs[0]["frame"][0], **ONE_DEVICE)
    want, _ = jax_frames(world)["views"]
    for v in range(3):
        hold_frame(rgba[v], want[v])


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("min_t", MIN_TS)
def test_sweep_composite_sharded_matches_reference(min_t, world):
    import jax
    import jax.numpy as jnp

    from sienerf_tpu.ops.sweep import orient_grid as jorient
    from sienerf_tpu.ops.sweep import sweep_composite_sharded as jsharded
    from sienerf_tpu.parallel.mesh import make_ray_mesh as jax_mesh

    outs = port_run(world)
    _same_on_every_rank(outs, lambda o: o["composite"][min_t])
    got = outs[0]["composite"][min_t]
    v = volume()
    mesh = jax_mesh(world)
    want = jax.jit(lambda og, sl, oc, b, c: jsharded(
        mesh, og, sl, oc, b, c, NEAR, min_t, resolution=R, n_cascades=K))(
        jorient(jnp.asarray(v["vol"], jnp.bfloat16), 0, False), jnp.ones((K, R + 1), bool),
        jnp.asarray(v["o_c"]), jnp.asarray(v["eb"]), jnp.asarray(v["ec"]))
    for name, a, b in zip(("rgb", "opacity", "T"), got[:3], want[:3]):
        np.testing.assert_allclose(a, np.asarray(b), **COMPOSITE_TOL, err_msg=name)
    np.testing.assert_allclose(got[3], np.asarray(want[3]), **DEPTH_T_TOL)
    if min_t > 0:  # each share cut at its own T: the fold goes below the cutoff
        assert (got[2] < min_t).any()


@pytest.mark.parametrize("world", WORLDS)
def test_sweep_composite_sharded_matches_one_device(world):
    from sienerf_torch.ops.sweep import sweep_composite

    got = port_run(world)[0]["composite"][0.0]
    v = volume()
    want = sweep_composite(_oriented(v), torch.from_numpy(v["o_c"]), torch.from_numpy(v["eb"]),
                           torch.from_numpy(v["ec"]), NEAR, 0.0, resolution=R, n_cascades=K)
    for name, a, b in zip(("rgb", "opacity", "T"), got[:3], want[:3]):
        np.testing.assert_allclose(a, b.numpy(), **COMPOSITE_TOL, err_msg=name)
    np.testing.assert_allclose(got[3], want[3].numpy(), **DEPTH_T_TOL)
    assert want[1].max() > 0.5  # the volume is not empty


@pytest.mark.parametrize("world", WORLDS)
def test_prepare_rgba_volume_sharded(world):
    from sienerf_tpu.engines.nerf_sweep import prepare_rgba_volume_sharded as jprep
    from sienerf_tpu.parallel.mesh import make_ray_mesh as jax_mesh
    from sienerf_torch.engines.nerf_sweep import prepare_rgba_volume

    outs = port_run(world)
    _same_on_every_rank(outs, lambda o: o["prep"])
    got = outs[0]["prep"]
    jeng, _, payload = field()
    params, _, grid, meta = _field(payload)
    one = prepare_rgba_volume(_engine(payload), params, grid["rows"], grid["scale"],
                              torch.tensor(PREP_CAM), meta["resolution"], meta["n_cascades"])
    np.testing.assert_array_equal(got, one.float().numpy())
    want = jprep(jeng, payload["params"], payload["grid"]["rows"], payload["grid"]["scale"],
                 np.asarray(PREP_CAM, np.float32), meta["resolution"], meta["n_cascades"],
                 jax_mesh(world))
    np.testing.assert_allclose(got, np.asarray(want, np.float32), rtol=2e-2, atol=2e-3)
    assert got[..., 3].max() > 1.0  # some vertices are dense


@pytest.mark.parametrize("world", WORLDS)
def test_render_frame_sweep_multichip(world):
    from sienerf_torch.engines.nerf_sweep import render_frame_sweep

    outs = port_run(world)
    _same_on_every_rank(outs, lambda o: o["sweep"])
    payload = field()[2]
    params, _, grid, meta = _field(payload)
    rgba, depth = outs[0]["sweep"][0.0]
    one, one_depth = render_frame_sweep(_engine(payload), params, grid, meta,
                                        *_cam(payload, 1), width=RES, height=RES,
                                        min_transmittance=0.0)
    np.testing.assert_allclose(rgba, one.numpy(), **ONE_DEVICE)
    np.testing.assert_allclose(depth, one_depth.numpy(), **DEPTH_ONE_DEVICE)
    alpha = rgba[..., 3]
    assert alpha.max() - alpha.min() > 0.3  # the ball against its surround
    for mt in (0.0, None):
        np.testing.assert_allclose(outs[0]["sweep"][mt][0], jax_frames(world)[("sweep", mt)][0],
                                   rtol=2e-2, atol=5e-3)


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_step_equals_the_mean(world):
    """One sharded step equals the mean of the per-shard gradients, the
    contract of the reference's data parallelism."""
    from test_torch_train import _assert_grads_close

    got = [o["step"] for o in port_run(world)]
    ref = got[0]["one_process"]
    for r, out in enumerate(got):  # every rank: the one-process mean, bit for bit
        for name in ("params", "loss", "cnt", "emap"):
            for a, b in zip(_leaves(out[name]), _leaves(ref[name])):
                np.testing.assert_array_equal(a, b, err_msg=f"rank {r} {name}")
    want = jax_step(world)
    np.testing.assert_allclose(float(ref["loss"]), want["loss"], **STEP_TOL)
    np.testing.assert_allclose(float(ref["cnt"]), want["cnt"], **STEP_TOL)
    np.testing.assert_allclose(ref["emap"], want["emap"], **STEP_TOL)
    # the mean gradients: within the port's one-step gap to the reference
    # (tests/test_torch_train.py: 2 % of a leaf's largest entry)
    _assert_grads_close(want["grads"], {
        k: (torch.from_numpy(v) if isinstance(v, np.ndarray)
            else [torch.from_numpy(w) for w in v]) for k, v in ref["grads"].items()})
    # the params: Adam divides each coordinate's gradient by its running
    # scale, so that gap moves a step by a share of the learning rate (up
    # to ~5 % of it on table texels few rays reach): rtol 2e-4 / atol 1e-6
    # on all but 2 % of each leaf, and a tenth of one step everywhere
    lr = field()[0].opt.learning_rate
    for a, b in zip(_leaves(ref["params"]), _leaves(want["params"])):
        close = np.abs(a - b) <= STEP_TOL["atol"] + STEP_TOL["rtol"] * np.abs(b)
        assert close.mean() >= 0.98, close.mean()
        np.testing.assert_allclose(a, b, rtol=0, atol=0.1 * lr)


def test_sharded_bundle_keeps_replicas_and_repeats():
    """Two 2-rank bundles from one seed: the state equal on both ranks, and
    the same bits when run again; the bundle trained."""
    payload = field()[2]
    outs = spawn(_bundle_body, 2, payload)
    state = payload["state"]
    for r, (a, b) in enumerate(outs):
        assert np.isfinite(a["losses"]).all() and a["step"] == state["step"] + 8
        for x, y, z in zip(_leaves(a), _leaves(b), _leaves(outs[0][0])):
            np.testing.assert_array_equal(x, y, err_msg=f"rank {r}: one seed, two runs")
            np.testing.assert_array_equal(x, z, err_msg=f"rank {r} vs rank 0")
    assert not np.array_equal(outs[0][0]["params"]["grid"], state["params"]["grid"])
