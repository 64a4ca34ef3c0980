"""SDF mode, port vs reference, on the sphere-and-box scene of
tests/test_torch_bvh_queries.py, scaled into the unit cube as a session
loads it, with a small network (8 levels, 2^14 rows) that the port fits
for 128 steps: the host batch sampler, one
training step on the reference's batch, the sphere tracer (on an analytic
distance and on the field), normals, frames in every mode (the field's and
the mesh's own), the IoU on the reference's jitter, the device
ground-truth path, and Session.load_file -> train -> render ->
calculate_iou on an OBJ written by the port.

Tolerances: the sampler exact (the same numpy draws and f32 operations);
the step's loss rtol 1e-4, its gradients as tests/test_torch_hashgrad.py
(MLP matrices rtol 1e-2 / atol 1e-3 and within 2 % of their largest
entry, the table within 2 % of max |d|).  Sphere tracing on an analytic
distance: hit masks exact, t rtol 1e-5.  On the field (a bf16 MLP, whose
roundings may flip): hit masks exact except rays within one
stop_threshold of the surface, counted and bounded (<= 1 %), t within
1e-3 where both hit except grazing rays (<= 1 %, counted); colours at the MLP bound (rtol 1e-2 / atol 1e-3) on
the pixels whose hit and shadow agree, which must be >= 97 %.  Frames of
the mesh itself (ground_truth): hits exact, colours rtol 1e-5 / atol
1e-5.  Normals: analytic rtol 1e-2 / atol 1e-3 (the gradient through a bf16
MLP), finite differences in f32 rtol 1e-3 / atol 1e-4.  IoU within 0.01
(a sign near zero may flip)."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sienerf_tpu.engines.sdf import SdfEngine as JSdf
from sienerf_tpu.models.single_network import apply_single_network as japply
from sienerf_tpu.ops.losses import get_loss as jloss
from sienerf_torch.engines.sdf import SdfEngine
from sienerf_torch.geom.mesh_io import normalize_to_unit_cube, save_obj
from sienerf_torch.ops.optim import tree_map
from sienerf_torch.utils.camera import look_at_matrix
from test_torch_bvh_queries import scene_triangles

MLP_TOL = dict(rtol=1e-2, atol=1e-3)
CAM = look_at_matrix([0.5, 0.7, -0.6], [0.5, 0.5, 0.5])


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


def small_config():
    return {
        "loss": {"otype": "MAPE"},
        "optimizer": {"otype": "Ema", "decay": 0.95, "nested": {
            "otype": "ExponentialDecay", "decay_start": 10000, "decay_interval": 5000,
            "decay_base": 0.33, "nested": {"otype": "Adam", "learning_rate": 1e-3, "beta1": 0.9,
                                           "beta2": 0.99, "epsilon": 1e-15, "l2_reg": 1e-6}}},
        "encoding": {"otype": "HashGrid", "n_levels": 8, "n_features_per_level": 2,
                     "log2_hashmap_size": 14, "base_resolution": 8, "per_level_scale": 1.5},
        "network": {"n_neurons": 32, "n_hidden_layers": 2},
    }


def unit_scene() -> np.ndarray:
    return normalize_to_unit_cube(scene_triangles(), scale_margin=0.9)


@pytest.fixture(scope="module")
def fitted():
    """The port's engine fitted for 8 bundles, and the reference's engine
    on the same triangles with the same params."""
    torch.set_num_threads(2)
    eng = SdfEngine.create(small_config(), unit_scene(), batch_size=1 << 11, device="cpu")
    state = eng.init(0)
    g = torch.Generator().manual_seed(0)
    losses = []
    for _ in range(8):
        state, loss = eng.train_bundle(state, g)
        losses.append(float(loss))
    jeng = JSdf.create(small_config(), unit_scene(), batch_size=1 << 11)
    jparams = jax.tree.map(lambda t: jnp.asarray(t.numpy()), state["params"])
    return eng, state, jeng, jparams, losses


def test_host_sampler_matches_the_reference(fitted):
    eng, _, jeng, _, _ = fitted
    np.testing.assert_array_equal(eng.bvh_host.triangles, jeng.bvh_host.triangles)
    a = eng.sample_batch_host(np.random.default_rng(4))
    b = jeng._sample_batch_host(np.random.default_rng(4))
    np.testing.assert_array_equal(a, b)
    assert a.shape == (1 << 11, 3) and a.min() >= 0 and a.max() <= 1


def test_one_training_step_on_the_reference_batch(fitted):
    eng, state, jeng, jparams, losses = fitted
    assert losses[-1] < losses[0]
    pos = jeng._sample_batch_host(np.random.default_rng(5))
    tgt = eng.ground_truth(torch.from_numpy(pos)).numpy()

    def loss_of(p):
        return jnp.mean(jloss("MAPE")(japply(jeng.net, p, jnp.asarray(pos))[:, 0],
                                      jnp.asarray(tgt)))

    jl, jg = jax.value_and_grad(loss_of)(jparams)
    tl, tg = eng.loss_and_grads(state["params"], torch.from_numpy(pos), torch.from_numpy(tgt))
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-4)
    for got, want in zip(tg["mlp"], jg["mlp"]):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, **MLP_TOL)
        assert np.abs(got.numpy() - want).max() <= 0.02 * np.abs(want).max()
    jd = np.asarray(jg["grid"])
    assert np.abs(tg["grid"].numpy() - jd).max() <= 0.02 * np.abs(jd).max()
    # the reference's own jitted bundle of one step on the same batch
    # the bundle donates its state: give it copies
    jstate = {"params": jax.tree.map(jnp.array, jparams),
              "opt": jax.tree.map(jnp.asarray, _np_opt(state))}
    _, jmean = jeng._train_bundle_host_jit(jstate, jnp.asarray(pos)[None],
                                           jnp.asarray(tgt)[None], None)
    st = {"params": tree_map(torch.clone, state["params"]),
          "opt": tree_map(lambda x: x.clone() if isinstance(x, torch.Tensor) else x,
                          state["opt"])}
    _, loss = eng.train_step(st, torch.from_numpy(pos), torch.from_numpy(tgt))
    np.testing.assert_allclose(float(loss), float(jmean), rtol=1e-4)


def _np_opt(state):
    opt = state["opt"]
    to_np = lambda t: t.numpy() if isinstance(t, torch.Tensor) else t  # noqa: E731
    out = {"m": tree_map(to_np, opt["m"]), "v": tree_map(to_np, opt["v"]),
           "step": np.int32(opt["step"])}
    if "ema" in opt:
        out["ema"] = tree_map(to_np, opt["ema"])
    return out


def _rays(eng, w=40, h=30):
    x = (torch.arange(w) + 0.5) / w
    y = (torch.arange(h) + 0.5) / h
    v, u = torch.meshgrid(y, x, indexing="ij")
    from sienerf_torch.utils.camera import uv_to_ray

    o, d = uv_to_ray(torch.stack([u.reshape(-1), v.reshape(-1)], -1), (w, h),
                     (w * 1.1, w * 1.1), CAM)
    d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    tmin, tmax = eng.aabb.ray_intersect(o, d)
    t0 = torch.clamp(tmin, min=0.0)
    return o, d, t0, torch.maximum(tmax, t0)


def test_sphere_trace_on_an_analytic_distance(fitted):
    eng, _, jeng, _, _ = fitted
    o, d, t0, t1 = _rays(eng)

    def sd(p, lib):
        q = p - 0.5
        return lib.sqrt(q[:, 0] * q[:, 0] + q[:, 1] * q[:, 1] + q[:, 2] * q[:, 2]) - 0.25

    jo, jd_, jt0, jt1 = (jnp.asarray(x.numpy()) for x in (o, d, t0, t1))
    for shadow in (False, True):
        want = jeng.sphere_trace(lambda p: sd(p, jnp), jo, jd_, jt0, jt1, track_shadow=shadow)
        got = eng.sphere_trace(lambda p: sd(p, torch), o, d, t0, t1, track_shadow=shadow)
        np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
        np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=1e-5)
        np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))
        np.testing.assert_allclose(got[4].numpy(), np.asarray(want[4]), rtol=1e-4, atol=1e-5)
    assert 0.1 < float(got[2].float().mean()) < 0.9


def test_sphere_trace_on_the_field(fitted):
    eng, state, jeng, jparams, _ = fitted
    from sienerf_tpu.models.single_network import pack_render_params as jpack

    o, d, t0, t1 = _rays(eng)
    jp = jpack(jeng.net, jparams)
    want = jeng.sphere_trace(jeng._sdf_fn(jp), *(jnp.asarray(x.numpy()) for x in (o, d, t0, t1)))
    got = eng.sphere_trace(eng.sdf_fn(state["params"]), o, d, t0, t1)
    jhit, hit = np.asarray(want[2]), got[2].numpy()
    assert 0.1 < hit.mean() < 0.9
    differ = jhit != hit
    # a ray whose hit differs passes within one stop_threshold of the
    # surface: its distance at the end of the reference's trace is small
    assert differ.sum() <= 0.01 * len(hit), int(differ.sum())
    both = jhit & hit
    # a ray that grazes the surface may converge elsewhere: counted
    far = np.abs(got[1].numpy()[both] - np.asarray(want[1])[both]) > 1e-3
    assert far.sum() <= 0.01 * both.sum(), int(far.sum())


def test_normals_match(fitted):
    eng, state, jeng, jparams, _ = fitted
    pos = np.random.default_rng(6).uniform(0.2, 0.8, (128, 3)).astype(np.float32)
    got = eng.normals(state["params"], torch.from_numpy(pos)).numpy()
    want = np.asarray(jeng._normals(jparams, jnp.asarray(pos)))
    np.testing.assert_allclose(got, want, **MLP_TOL)
    eng.normals_mode = jeng.normals_mode = "fd"
    try:
        got = eng.normals(state["params"], torch.from_numpy(pos)).numpy()
        want = np.asarray(jeng._normals(jparams, jnp.asarray(pos)))
    finally:
        eng.normals_mode = jeng.normals_mode = "analytic"
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("mode", ["shade", "normals", "ao", "positions", "depth"])
def test_frames_of_the_mesh_itself(fitted, mode):
    eng, state, jeng, jparams, _ = fitted
    jimg, jdepth = jeng.render_frame(jparams, None, 24, 16, CAM, ground_truth=True,
                                     render_mode=mode)
    img, depth = eng.render_frame(state["params"], 24, 16, CAM, ground_truth=True,
                                  render_mode=mode)
    np.testing.assert_array_equal(np.isfinite(depth.numpy()), np.isfinite(np.asarray(jdepth)))
    np.testing.assert_allclose(img.numpy(), np.asarray(jimg), rtol=1e-5, atol=1e-5)


def test_field_frames_match(fitted):
    eng, state, jeng, jparams, _ = fitted
    jimg, jdepth = jeng.render_frame(jparams, None, 40, 30, CAM)
    img, depth = eng.render_frame(state["params"], 40, 30, CAM, stats={})
    jhit, hit = np.isfinite(np.asarray(jdepth)), np.isfinite(depth.numpy())
    assert (jhit != hit).mean() <= 0.01
    close = np.isclose(img.numpy(), np.asarray(jimg), **MLP_TOL).all(axis=-1)
    assert close.mean() >= 0.97, close.mean()
    for mode in ("slice", "slice:0.8"):
        jimg, jdepth = jeng.render_frame(jparams, None, 24, 16, CAM, render_mode=mode)
        img, depth = eng.render_frame(state["params"], 24, 16, CAM, render_mode=mode)
        np.testing.assert_allclose(depth.numpy(), np.asarray(jdepth), rtol=1e-5)
        np.testing.assert_allclose(img.numpy(), np.asarray(jimg), **MLP_TOL)
    with pytest.raises(ValueError, match="render mode"):
        eng.render_frame(state["params"], 8, 8, CAM, render_mode="cost")


def test_iou_on_the_reference_jitter(fitted):
    eng, state, jeng, jparams, _ = fitted
    key = jax.random.PRNGKey(0)
    res, n_chunks = 16, 4
    draws = []
    for _ in range(n_chunks):
        key, sub = jax.random.split(key)
        draws.append(np.array(jax.random.uniform(sub, (res ** 3 // n_chunks, 3))))
    jstate = {"params": jparams, "opt": jax.tree.map(jnp.asarray, _np_opt(state))}
    want = jeng.calculate_iou(jstate, resolution=res, n_chunks=n_chunks)
    got = eng.calculate_iou(state, resolution=res, n_chunks=n_chunks,
                            draw=lambda ci, shape: torch.from_numpy(draws[ci]))
    assert abs(got - want) <= 0.01, (got, want)
    assert got > 0.5


def test_device_ground_truth_path(fitted):
    eng = fitted[0]
    pos = torch.from_numpy(np.random.default_rng(7).uniform(0, 1, (256, 3)).astype(np.float32))
    host = eng.ground_truth(pos)
    eng.host_gt = False
    try:
        dev = eng.ground_truth(pos)
        p, t = eng.draw_bundle(torch.Generator().manual_seed(1), n_steps=1)
    finally:
        eng.host_gt = True
    np.testing.assert_allclose(dev.numpy(), host.numpy(), rtol=1e-5, atol=1e-6)
    assert p.shape == (1, 1 << 11, 3) and t.shape == (1, 1 << 11)
    np.testing.assert_allclose(t[0].numpy(), eng.ground_truth(p[0]).numpy(), rtol=1e-5,
                               atol=1e-6)


def test_session_trains_a_mesh(tmp_path):
    from sienerf_torch.session import Session

    tri = scene_triangles()
    save_obj(tmp_path / "scene.obj", tri.reshape(-1, 3), np.arange(len(tri) * 3).reshape(-1, 3))
    (tmp_path / "net.json").write_text(json.dumps(small_config()))
    s = Session(device="cpu")
    s.load_file(tmp_path / "scene.obj", network=tmp_path / "net.json", batch_size=1 << 11)
    assert s.mode.value == "sdf" and len(s.engine.bvh_host.triangles) == len(tri)
    iou0 = s.calculate_iou(16, 4)
    s.train(64)
    assert s.training_step == 64 and len(s.loss_graph) == 4
    assert s.loss_graph[-1] < s.loss_graph[0]
    assert s.calculate_iou(16, 4) > iou0
    out = s.render(32, 24, CAM)
    assert out.shape == (24, 32, 4) and bool(torch.isfinite(out).all())
