"""The port's small modules against the JAX package's, from the same
seeded inputs: utils/log.py, utils/timers.py (Ema, PhaseTimers on a fake
clock), utils/dynamic_res.py (DynamicResController, Foveation),
utils/camera.py's field of view <-> focal length, utils/camera_path.py
(quaternions, slerp, CameraPath eval / orbit / JSON, render_video),
io/image_io.py::save_image (LDR) and scenes.py::resolve_scene.

Tolerances: text, factor sequences, resolutions and pixels equal; floats
of the camera math rtol 1e-6 / atol 1e-6 (numpy float64 on both sides)."""

import io
import json
import math
import types

import numpy as np
import pytest
import torch

from sienerf_tpu.utils import camera as jcam
from sienerf_tpu.utils import camera_path as jcp
from sienerf_tpu.utils import dynamic_res as jdr
from sienerf_tpu.utils import log as jlog
from sienerf_tpu.utils import timers as jtimers
from sienerf_torch.utils import camera as tcam
from sienerf_torch.utils import camera_path as tcp
from sienerf_torch.utils import dynamic_res as tdr
from sienerf_torch.utils import log as tlog
from sienerf_torch.utils import timers as ttimers

TOL = dict(rtol=1e-6, atol=1e-6)


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


def _clock(times):
    """A stand-in for a module's `time`: each call of time(), monotonic() or
    perf_counter() returns the next of `times`."""
    it = iter(times)
    nxt = lambda: next(it)  # noqa: E731
    return types.SimpleNamespace(time=nxt, monotonic=nxt, perf_counter=nxt)


def test_log_lines_are_the_reference_text(monkeypatch):
    outs = []
    for mod in (jlog, tlog):
        buf = io.StringIO()
        monkeypatch.setattr(mod, "_T0", 100.0)
        monkeypatch.setattr(mod, "time", _clock([101.5, 103.25, 250.0]))
        mod.set_stream(buf)
        mod.info("iteration=16 loss=0.5")
        mod.success("saved")
        mod.set_verbose(False)
        mod.info("hidden")
        mod.set_verbose(True)
        mod.set_stream(None)
        outs.append(buf.getvalue())
    assert outs[0] == outs[1] == ("[    1.50s] INFO    iteration=16 loss=0.5\n"
                                  "[    3.25s] SUCCESS saved\n")
    err = []
    for mod in (jlog, tlog):
        buf = io.StringIO()
        monkeypatch.setattr(mod, "time", _clock([107.0]))
        monkeypatch.setattr(mod.sys, "stderr", buf)
        mod.warning("careful")
        err.append(buf.getvalue())
    assert err[0] == err[1] == "[    7.00s] WARNING careful\n"


def test_ema_and_phase_timers(monkeypatch):
    rng = np.random.default_rng(0)
    samples = rng.uniform(1.0, 50.0, 40)
    nows = np.cumsum(rng.uniform(0.0, 0.7, 40))
    for hl in (0.0, 0.5, 2.0):
        a, b = jtimers.Ema(hl), ttimers.Ema(hl)
        got = [b.update(float(x), float(t)) for x, t in zip(samples, nows)]
        want = [a.update(float(x), float(t)) for x, t in zip(samples, nows)]
        assert got == want
    ticks = list(np.cumsum(rng.uniform(0.001, 0.2, 24)))
    summaries = []
    for mod in (jtimers, ttimers):
        monkeypatch.setattr(mod, "time", _clock(ticks))
        pt = mod.PhaseTimers(half_life_s=0.25)
        for i in range(6):
            with pt.phase("train" if i % 3 else "render"):
                pass
        summaries.append((pt.summary(), pt.ms("train"), pt.ms("render"),
                          math.isnan(pt.ms("none"))))
    assert summaries[0] == summaries[1] and summaries[0][3]


def test_dynamic_resolution_and_foveation():
    rng = np.random.default_rng(1)
    ms = rng.uniform(1.0, 200.0, 60)
    a, b = jdr.DynamicResController(target_ms=30.0), tdr.DynamicResController(target_ms=30.0)
    seq_j = [(a.update(float(m)), a.resolution(1280, 720)) for m in ms]
    seq_t = [(b.update(float(m)), b.resolution(1280, 720)) for m in ms]
    assert seq_t == seq_j and len({f for f, _ in seq_t}) > 5
    assert b.update(0.0) == a.update(0.0)
    t = np.linspace(0.0, 1.0, 257)
    for density, center in ((1.0, 0.5), (2.0, 0.5), (4.0, 0.5), (3.0, 0.3), (6.0, 0.8)):
        jf, tf = jdr.Foveation(density, center), tdr.Foveation(density, center)
        np.testing.assert_allclose(tf.unwarp(t), jf.unwarp(t), **TOL)
        np.testing.assert_allclose(tf.warp(t), jf.warp(t), **TOL)
        np.testing.assert_allclose(tf.warp(tf.unwarp(t)), t, rtol=0, atol=1e-6)


def test_fov_and_focal_length():
    for res, deg in ((1280, 50.0), (720, 90.0), (48, 12.5), (4096, 120.0)):
        f = tcam.fov_to_focal_length(res, deg)
        np.testing.assert_allclose(f, jcam.fov_to_focal_length(res, deg), **TOL)
        np.testing.assert_allclose(tcam.focal_length_to_fov(res, f),
                                   jcam.focal_length_to_fov(res, f), **TOL)
        np.testing.assert_allclose(tcam.focal_length_to_fov(res, f), deg, **TOL)


def _random_rotations(n, seed):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        q, r = np.linalg.qr(rng.normal(size=(3, 3)))
        q = q * np.sign(np.diag(r))[None]
        out.append(q if np.linalg.det(q) > 0 else -q)
    return out


def test_quaternions_and_slerp():
    rots = _random_rotations(12, 2)
    # the four branches of mat_to_quat: trace > 0 and each largest diagonal
    rots += [np.diag([1.0, -1.0, -1.0]), np.diag([-1.0, 1.0, -1.0]), np.diag([-1.0, -1.0, 1.0])]
    for m in rots:
        q = tcp.mat_to_quat(m)
        np.testing.assert_allclose(q, jcp.mat_to_quat(m), **TOL)
        np.testing.assert_allclose(tcp.quat_to_mat(q), jcp.quat_to_mat(q), **TOL)
        np.testing.assert_allclose(tcp.quat_to_mat(q), m, rtol=0, atol=1e-6)
    q0, q1 = tcp.mat_to_quat(rots[0]), tcp.mat_to_quat(rots[1])
    near = q0 + 1e-3 * tcp.mat_to_quat(rots[2])
    near /= np.linalg.norm(near)
    for a, b in ((q0, q1), (q0, -q1), (q0, near)):
        for t in (0.0, 0.1, 0.5, 0.93, 1.0):
            np.testing.assert_allclose(tcp.slerp(a, b, t), jcp.slerp(a, b, t), **TOL)


def _paths(loop, n=5, seed=3):
    rng = np.random.default_rng(seed)
    jpath, tpath = jcp.CameraPath(loop=loop), tcp.CameraPath(loop=loop)
    for i, m in enumerate(_random_rotations(n, seed)):
        xf = np.concatenate([m, rng.normal(size=(3, 1))], axis=1).astype(np.float32)
        jpath.add_keyframe(xf, fov=40.0 + 5 * i, aperture=0.01 * i)
        tpath.add_keyframe(xf, fov=40.0 + 5 * i, aperture=0.01 * i)
    return jpath, tpath


@pytest.mark.parametrize("loop", [False, True])
def test_camera_path_eval_orbit_and_json(loop, tmp_path):
    jpath, tpath = _paths(loop)
    for t in np.linspace(-0.1, 1.1, 23):
        a, b = jpath.eval(float(t)), tpath.eval(float(t))
        np.testing.assert_allclose(b.xform, a.xform, **TOL)
        np.testing.assert_allclose((b.fov, b.aperture), (a.fov, a.aperture), **TOL)
    tpath.save(tmp_path / "t.json")
    jpath.save(tmp_path / "j.json")
    assert json.loads((tmp_path / "t.json").read_text()) == \
        json.loads((tmp_path / "j.json").read_text())
    back, jback = tcp.CameraPath.load(tmp_path / "t.json"), jcp.CameraPath.load(tmp_path / "t.json")
    assert back.loop == loop and len(back.keyframes) == 5
    for k, jk, orig in zip(back.keyframes, jback.keyframes, tpath.keyframes):
        np.testing.assert_allclose(k.xform, jk.xform, **TOL)
        np.testing.assert_allclose(k.xform, orig.xform, rtol=0, atol=1e-6)
        assert (k.fov, k.aperture) == (jk.fov, jk.aperture)
    jo = jcp.CameraPath.orbit([0.5, 0.5, 0.5], 1.2, 0.35, n=6, fov=45.0)
    to = tcp.CameraPath.orbit([0.5, 0.5, 0.5], 1.2, 0.35, n=6, fov=45.0)
    assert to.loop and len(to.keyframes) == 6
    for t in np.linspace(0.0, 1.0, 13):
        np.testing.assert_allclose(to.eval(float(t)).xform, jo.eval(float(t)).xform, **TOL)


class _StubSession:
    """render() returns a frame that depends on the camera and the size."""

    def __init__(self, as_tensor):
        self.as_tensor, self.calls = as_tensor, []

    def render(self, width, height, camera_matrix=None, focal=None, **kw):
        self.calls.append((width, height, focal, kw))
        y, x = np.meshgrid(np.linspace(0, 1, height), np.linspace(0, 1, width), indexing="ij")
        c = float(np.asarray(camera_matrix)[0, 3])
        img = np.stack([x, y, np.full_like(x, 0.5 + 0.4 * np.sin(c)), np.ones_like(x)], -1)
        img = img.astype(np.float32)
        return torch.from_numpy(img) if self.as_tensor else img


def test_render_video_writes_an_mp4(tmp_path):
    cv2 = pytest.importorskip("cv2")
    path = tcp.CameraPath.orbit([0.5, 0.5, 0.5], 1.2, 0.35, n=4)
    got = []
    for as_tensor, mod in ((True, tcp), (False, jcp)):
        sess = _StubSession(as_tensor)
        out = tmp_path / f"{mod.__name__.split('.')[0]}.mp4"
        mod.render_video(sess, path, out, width=48, height=32, n_frames=5, fps=10, spp=2)
        assert [c[:2] for c in sess.calls] == [(48, 32)] * 5
        assert all(c[3] == {"spp": 2} for c in sess.calls)
        cap = cv2.VideoCapture(str(out))
        frames = []
        while True:
            ok, f = cap.read()
            if not ok:
                break
            frames.append(f)
        cap.release()
        assert len(frames) == 5 and frames[0].shape == (32, 48, 3)
        got.append((sess.calls, frames))
    assert [c[2] for c in got[0][0]] == [c[2] for c in got[1][0]]
    for a, b in zip(got[0][1], got[1][1]):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("channels,linear,ext", [
    (3, True, ".png"), (3, False, ".png"), (4, True, ".png"), (4, False, ".png"),
    (3, True, ".jpg"), (3, False, ".jpg")])  # JPEG has no alpha
def test_save_image_ldr_pixels(channels, linear, ext, tmp_path):
    cv2 = pytest.importorskip("cv2")
    from sienerf_torch.io.image_io import load_image, save_image
    from sienerf_tpu.io.image_io import save_image as jsave

    rng = np.random.default_rng(channels + 2 * linear)
    img = rng.uniform(-0.2, 1.2, (19, 23, channels)).astype(np.float32)
    img[0, :5, :3] = np.asarray([0.0, 0.0031308, 0.5, 1.0, 2.0], np.float32)[:, None]
    save_image(tmp_path / f"t{ext}", img, input_is_linear=linear)
    jsave(tmp_path / f"j{ext}", img, input_is_linear=linear)
    got = cv2.imread(str(tmp_path / f"t{ext}"), cv2.IMREAD_UNCHANGED)
    want = cv2.imread(str(tmp_path / f"j{ext}"), cv2.IMREAD_UNCHANGED)
    assert got.shape == (19, 23, channels) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    if ext == ".png":
        np.testing.assert_array_equal(load_image(tmp_path / f"t{ext}", as_float_linear=False),
                                      load_image(tmp_path / f"j{ext}", as_float_linear=False))


def test_resolve_scene(tmp_path):
    from sienerf_torch import scenes as tscenes
    from sienerf_tpu import scenes as jscenes

    a, b = tmp_path / "a", tmp_path / "b"
    (b / "data" / "nerf" / "fox").mkdir(parents=True)
    (a / "data" / "image").mkdir(parents=True)
    (a / "data" / "image" / "albert.exr").write_bytes(b"")
    (b / "data" / "image").mkdir(parents=True)
    (b / "data" / "image" / "albert.exr").write_bytes(b"")
    roots = (str(a), str(b))
    assert tscenes.ALL_SCENES == jscenes.ALL_SCENES
    for name in ("fox", "albert", str(tmp_path), "not_a_scene", "some/path.obj"):
        assert tscenes.resolve_scene(name, roots) == jscenes.resolve_scene(name, roots)
    assert tscenes.resolve_scene("albert", roots) == str(a / "data" / "image" / "albert.exr")
    for mod in (tscenes, jscenes):
        with pytest.raises(FileNotFoundError, match="lego"):
            mod.resolve_scene("lego", roots)
