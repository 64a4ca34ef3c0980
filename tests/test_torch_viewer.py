"""The viewer, port vs reference: FrameController's rungs, orbit_camera,
render_view on the committed fox field (plain live, foveated live and
foveated baked at <= 64x64, the baked views from one R=32 bake carried
across from the reference), orbit_benchmark's log on a fake clock, and
serve on 127.0.0.1 port 0 (the port only: the reference's serve blocks).

Tolerances: the live and baked frames' rule (tests/test_torch_live.py,
tests/test_torch_baked.py): at least 99 % of the pixels within rtol 2e-2 /
atol 5e-3 and a PSNR above 40 dB; cameras rtol 1e-6 / atol 1e-6; rungs,
resolutions and logs equal; the served PNG equal to render_view's frame
quantised the same way."""

import threading
import types
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from sienerf_torch import viewer as tview
from sienerf_tpu import viewer as jview
from test_torch_baked import hold_frame
from test_torch_snapshot import fox_jax, fox_jax_baked_grid, fox_port_session, \
    fox_port_session_baked

R = 32
CENTER = (0.5, 0.5, 0.5)


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


def test_frame_controller_rungs_and_orbit_camera():
    rng = np.random.default_rng(0)
    ms = rng.uniform(5.0, 400.0, 50)
    rungs = set()
    for target in (30.0, 100.0, 250.0):
        a, b = jview.FrameController(640, 360, target), tview.FrameController(640, 360, target)
        seq_j = [(a.update(float(m)), a.resolution()) for m in ms]
        seq_t = [(b.update(float(m)), b.resolution()) for m in ms]
        assert seq_t == seq_j
        rungs |= {r for r, _ in seq_t}
    assert rungs == {1.0, 0.5, 0.25, 0.125}
    for theta, phi, radius in ((0.0, 0.0, 2.2), (0.6, 0.3, 1.5), (4.0, -1.2, 3.0)):
        np.testing.assert_allclose(tview.orbit_camera(CENTER, radius, theta, phi),
                                   jview.orbit_camera(CENTER, radius, theta, phi),
                                   rtol=1e-6, atol=1e-6)


def _jax_session(baked=False):
    """The reference's Session holding the fox field (and the R=32 bake)."""
    from sienerf_tpu.common import TestbedMode
    from sienerf_tpu.session import Session

    eng, params, bitfield = fox_jax()
    s = Session()
    s.mode, s.engine = TestbedMode.NERF, eng
    s.state = {"opt": {}, "params": params, "occ": {"bitfield": bitfield}}
    s._baked = fox_jax_baked_grid(R) if baked else None
    return s


def _cam():
    return jview.orbit_camera(CENTER, 2.2, 0.6, 0.3)


@pytest.mark.parametrize("density,renderer", [(1.0, "live"), (4.0, "live"), (4.0, "baked")])
def test_render_view_matches(density, renderer):
    size = (32, 32) if density == 1.0 else (64, 48)
    baked = renderer == "baked"
    port = fox_port_session_baked(R) if baked else fox_port_session()
    kw = dict(focal=(60.0, 60.0), foveation_density=density)
    if baked:
        kw["renderer"] = "baked"
    got = tview.render_view(port, _cam(), *size, **kw)
    want = jview.render_view(_jax_session(baked), _cam(), *size, **dict(kw))
    assert isinstance(got, torch.Tensor) and got.shape == (size[1], size[0], 4)
    hold_frame(got.numpy(), np.asarray(want))
    assert float(got[..., 3].mean()) > 0.05


def test_foveated_view_refuses_the_sweep():
    with pytest.raises(ValueError, match="live or baked"):
        tview.render_view(fox_port_session(), _cam(), 64, 48, foveation_density=2.0,
                          focal=(60.0, 60.0), renderer="sweep")


class _StubSession:
    """engine.focals / resolution and a render() whose frame depends on its
    size and camera."""

    def __init__(self):
        self.engine = types.SimpleNamespace(focals=np.array([[40.0, 40.0]]), resolution=(64, 48))

    def render(self, width, height, camera, focal, **kw):
        y, x = np.meshgrid(np.linspace(0, 1, height), np.linspace(0, 1, width), indexing="ij")
        c = float(np.asarray(camera)[0, 3]) * focal[0] / 100.0
        img = np.stack([x, y, np.full_like(x, c % 1.0), np.ones_like(x)], -1).astype(np.float32)
        return img


def test_orbit_benchmark_log(monkeypatch, tmp_path):
    import cv2

    # frames of 400, 90, 700, ... ms on both packages' clocks
    durations = [0.4, 0.09, 0.7, 0.05, 0.3, 0.02, 0.25, 0.6, 0.01, 0.2]
    ticks = np.cumsum([x for d in durations for x in (1.0, d)]).tolist()
    logs = []
    for mod, d in ((jview, "j"), (tview, "t")):
        it = iter(ticks)
        monkeypatch.setattr(mod, "time", types.SimpleNamespace(time=lambda: next(it)))
        (tmp_path / d).mkdir()
        logs.append(mod.orbit_benchmark(_StubSession(), n_frames=10, width=128, height=96,
                                        target_ms=150.0, out_dir=str(tmp_path / d)))
    assert logs[0] == logs[1]
    assert len({(r["w"], r["h"]) for r in logs[1]}) > 2
    for i in range(10):
        got = cv2.imread(str(tmp_path / "t" / f"orbit_{i:03d}.png"), cv2.IMREAD_UNCHANGED)
        want = cv2.imread(str(tmp_path / "j" / f"orbit_{i:03d}.png"), cv2.IMREAD_UNCHANGED)
        np.testing.assert_array_equal(got, want)
        assert got.shape == (logs[1][i]["h"], logs[1][i]["w"], 3)


def test_serve_answers_the_page_and_frames(tmp_path):
    from sienerf_torch.io.png import read_png

    sess = fox_port_session()
    srv = tview.make_server(sess, "127.0.0.1", 0, width=32, height=32, target_ms=1e9)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    try:
        base = f"http://127.0.0.1:{srv.server_address[1]}"
        with urllib.request.urlopen(base + "/", timeout=60) as r:
            assert r.status == 200 and b"<canvas" in r.read()
        theta, phi, radius = 0.9, 0.2, 2.0
        with urllib.request.urlopen(f"{base}/frame?theta={theta}&phi={phi}&r={radius}",
                                    timeout=300) as r:
            assert r.headers["content-type"] == "image/png"
            assert r.headers["x-render-res"] == "32x32"
            assert float(r.headers["x-render-ms"]) >= 0
            (tmp_path / "f.png").write_bytes(r.read())
        with pytest.raises(urllib.error.HTTPError):
            urllib.request.urlopen(base + "/nothing", timeout=60)
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=60)
    got = read_png(tmp_path / "f.png")
    frame = tview.render_view(sess, tview.orbit_camera(CENTER, radius, theta, phi), 32, 32)
    want = (np.clip(frame[..., :3].numpy(), 0, 1) * 255).astype(np.uint8)
    assert got.shape == (32, 32, 3)
    np.testing.assert_array_equal(got, want)
    assert want.std() > 1.0
