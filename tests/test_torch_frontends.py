"""Front-ends of the port against the JAX package's: the viewer
(FrameController, orbit_camera, render_view plain and foveated, live and
baked, serve, orbit_benchmark), pyngp_compat's Testbed, and the CLI twin
`python -m sienerf_torch.run`.

Inputs: the committed fox snapshot (render_view, serve), and a tiny NeRF
scene written in code as PNG views with a transforms.json
(`png_nerf_scene`: tests/test_nerf_mode.py::make_dataset's 48x48 views of
an analytic ball, 8 bits), which both packages load.

Tolerances: the live frame's rule of tests/test_torch_live.py and
tests/test_torch_baked.py (at least 99 % of the pixels within rtol 2e-2 /
atol 5e-3, PSNR above 40 dB); camera matrices rtol 1e-6 / atol 1e-6;
FrameController rungs and resolutions equal; a served PNG equal to
render_view's frame quantised the same way."""

import functools
import json
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


@functools.lru_cache(maxsize=1)
def _views():
    from test_nerf_mode import make_dataset

    ds = make_dataset()
    return (np.clip(np.rint(ds.images * 255.0), 0, 255).astype(np.uint8),
            np.asarray(ds.xforms), float(ds.focal_lengths[0, 0]))


def png_nerf_scene(tmp: Path, n_test: int = 0) -> Path:
    """make_dataset's views written as 8-bit RGBA PNGs under tmp/scene with a
    transforms.json (NeRF-convention cameras, scale 0.33, offset 0.5), and
    with n_test > 0 a transforms_test.json of the first n_test views ->
    the scene directory."""
    from sienerf_torch.io.nerf_dataset import ngp_matrix_to_nerf
    from sienerf_torch.io.png import write_png

    q, xforms, fl = _views()
    root = tmp / "scene"
    root.mkdir(exist_ok=True)
    scale, offset = 0.33, np.full(3, 0.5, np.float32)
    frames = []
    for i in range(len(q)):
        write_png(root / f"v{i:02d}.png", q[i], level=1)
        m = np.eye(4, dtype=np.float32)
        m[:3] = ngp_matrix_to_nerf(xforms[i], scale, offset)
        frames.append({"file_path": f"v{i:02d}", "transform_matrix": m.tolist()})
    h, w = q.shape[1:3]
    meta = {"fl_x": fl, "fl_y": fl, "w": w, "h": h, "aabb_scale": 1, "scale": scale,
            "offset": offset.tolist()}
    (root / "transforms.json").write_text(json.dumps(dict(meta, frames=frames)))
    if n_test:
        (root / "transforms_test.json").write_text(json.dumps(dict(meta, frames=frames[:n_test])))
    return root


def _tiny_network(tmp: Path) -> Path:
    from test_nerf_mode import tiny_config

    cfg = tiny_config()
    cfg["encoding"] = dict(cfg["encoding"], n_levels=4, log2_hashmap_size=12)
    (tmp / "net.json").write_text(json.dumps(cfg))
    return tmp / "net.json"


def test_testbed_cameras_match_and_it_trains_and_screenshots(tmp_path):
    from sienerf_torch import pyngp_compat as tngp
    from sienerf_torch.io.png import read_png
    from sienerf_tpu import pyngp_compat as jngp

    root, net = png_nerf_scene(tmp_path), _tiny_network(tmp_path)
    kw = dict(network=str(net), train_batch_size=1 << 10, grid_size=16)
    jt = jngp.Testbed(jngp.TestbedMode.NERF)
    jt.load_training_data(str(root), **kw)
    tt = tngp.Testbed(tngp.TestbedMode.NERF, device="cpu")
    tt.load_training_data(str(root), **kw)
    assert tt.mode.value == jt.mode.value == "nerf"
    assert tt.n_params() == jt.n_params()
    assert tt.n_encoding_params() == jt.n_encoding_params()
    tol = dict(rtol=1e-6, atol=1e-6)
    for i in (0, 3, 9):
        np.testing.assert_allclose(tt.get_camera_extrinsics(i), jt.get_camera_extrinsics(i), **tol)
        np.testing.assert_allclose(tt.get_camera_extrinsics(i, False),
                                   jt.get_camera_extrinsics(i, False), **tol)
    m = np.asarray(jt.get_camera_extrinsics(4)).copy()
    m[:3, 3] += [0.1, -0.2, 0.05]
    jt.set_nerf_camera_matrix(m)
    tt.set_nerf_camera_matrix(m)
    np.testing.assert_allclose(tt.camera_matrix, jt.camera_matrix, **tol)
    assert tt.find_closest_training_view() == jt.find_closest_training_view() == 4
    jt.set_camera_extrinsics(2, m)
    tt.set_camera_extrinsics(2, m)
    np.testing.assert_allclose(tt.session.engine.xforms[2], np.asarray(jt.session.engine.xforms[2]),
                               **tol)
    np.testing.assert_allclose(tt.session.engine.data["xforms"][2].numpy(),
                               np.asarray(jt.session.engine.data["xforms"][2]), **tol)
    for step in (tt.next_training_view, tt.previous_training_view, tt.last_training_view,
                 tt.first_training_view):
        step()
    assert tt.last_training_view() == 9 and tt.next_training_view() == 0
    tt.session.engine.grid_interval = 4  # a short bundle on the CPU
    assert tt.frame() and tt.training_step == 4 and np.isfinite(tt.loss)
    tt.set_camera_to_training_view(1)
    img = tt.render(24, 24)
    assert isinstance(img, np.ndarray) and img.shape == (24, 24, 4) and np.isfinite(img).all()
    tt.screenshot(str(tmp_path / "shot.png"), 24, 24)
    np.testing.assert_array_equal(
        read_png(tmp_path / "shot.png"),
        (np.clip(img, 0, 1) * 255.0 + 0.5).astype(np.uint8))
    mesh = tt.compute_marching_cubes_mesh(16, thresh=1.0)
    assert set(mesh) >= {"V", "F"}
    tngp.free_temporary_memory()


def test_cli_flags_are_run_py_plus_device():
    import subprocess
    import sys

    sys.path.insert(0, str(REPO))
    import run as jrun

    from sienerf_torch import run as trun

    want = vars(jrun.parse_args(["--scene", "x"]))
    got = vars(trun.parse_args(["--scene", "x"]))
    assert got.pop("device") == "cuda"
    assert got == want
    out = subprocess.run([sys.executable, "-m", "sienerf_torch.run", "--help"], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0
    for flag in list(want) + ["device"]:
        assert f"--{flag}" in out.stdout


def test_cli_runs_end_to_end_on_the_cpu(tmp_path, monkeypatch, capsys):
    """Train, snapshot, eval on two test views, live and baked screenshots
    (the bake at R=24 instead of 256, for the CPU) and a 2-frame orbit
    video, through sienerf_torch.run.main."""
    import cv2

    from sienerf_torch import run as trun
    from sienerf_torch.io.png import read_png
    from sienerf_torch.session import Session

    root, net = png_nerf_scene(tmp_path, n_test=2), _tiny_network(tmp_path)
    bake = Session.bake
    monkeypatch.setattr(Session, "bake", lambda self, resolution=256, **kw: bake(self, 24, **kw))
    common = ["--scene", str(root), "--network", str(net), "--device", "cpu",
              "--batch_size", "1024", "--seed", "3"]
    assert trun.main(common + [
        "--n_steps", "16", "--save_snapshot", str(tmp_path / "s.msgpack"),
        "--test_transforms", str(root / "transforms_test.json"), "--eval_max_views", "2",
        "--eval_spp", "1", "--screenshot", str(tmp_path / "live.png"),
        "--screenshot_w", "32", "--screenshot_h", "24"]) == 0
    result = json.loads([l for l in capsys.readouterr().out.splitlines()
                         if l.startswith("{")][-1])
    assert result["n_views"] == 2 and np.isfinite(result["psnr_avg"])
    assert 0.0 < result["ssim_avg"] <= 1.0
    assert (tmp_path / "s.msgpack").stat().st_size > 0
    assert read_png(tmp_path / "live.png").shape == (24, 32, 4)
    assert trun.main(common + [
        "--n_steps", "0", "--load_snapshot", str(tmp_path / "s.msgpack"),
        "--renderer", "baked", "--screenshot", str(tmp_path / "baked.png"),
        "--screenshot_w", "32", "--screenshot_h", "24",
        "--video_camera_path", "orbit", "--video_output", str(tmp_path / "v.mp4"),
        "--video_fps", "2", "--video_n_seconds", "1", "--video_spp", "1",
        "--video_w", "32", "--video_h", "24"]) == 0
    baked = read_png(tmp_path / "baked.png")
    assert baked.shape == (24, 32, 4) and baked[..., :3].std() > 0
    cap = cv2.VideoCapture(str(tmp_path / "v.mp4"))
    n = 0
    while cap.read()[0]:
        n += 1
    cap.release()
    assert n == 2
