"""NeRF scenes on disk and the training Session, port vs reference: the
loader on a 3-view transforms.json written with OpenCV (per-frame and
global focal lengths, principal points, a dynamic mask, NSVF's white =
transparent), and a Session that trains that scene and then bakes and
renders from the optimizer's EMA shadow of the params.

Tolerances: the loader's arrays equal (the same numpy code on the same
bytes); the rest are checks of which params are read, not of values."""

import json

import cv2
import numpy as np
import pytest
import torch

W, H = 24, 16


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


def _write_scene(root, rng):
    """Three seeded RGBA views of a cube-centred scene and their cameras."""
    frames = []
    for i in range(3):
        img = rng.integers(0, 256, (H, W, 4), dtype=np.uint8)
        img[:2, :3, :3] = 255  # white pixels NSVF counts as transparent
        name = f"view_{i}"
        cv2.imwrite(str(root / f"{name}.png"), img)
        ang = 2 * np.pi * i / 3
        eye = [1.2 * np.cos(ang), 1.2 * np.sin(ang), 0.3 * i]
        fwd = -np.asarray(eye) / np.linalg.norm(eye)
        right = np.cross(fwd, [0.0, 0.0, 1.0])
        right /= np.linalg.norm(right)
        up = np.cross(right, fwd)
        m = np.eye(4)
        m[:3, 0], m[:3, 1], m[:3, 2], m[:3, 3] = right, up, -fwd, eye
        fr = {"file_path": name, "transform_matrix": m.tolist(), "sharpness": 10.0 + i}
        if i == 1:
            fr.update(fl_x=30.0, fl_y=28.0, cx=11.0, cy=9.0)
        frames.append(fr)
    mask = np.zeros((H, W), np.uint8)
    mask[5:9, 10:20] = 255
    cv2.imwrite(str(root / "dynamic_mask_view_2.png"), mask)
    meta = {"camera_angle_x": 0.9, "aabb_scale": 1, "scale": 0.4,
            "offset": [0.5, 0.45, 0.5], "white_transparent": True, "frames": frames}
    (root / "transforms.json").write_text(json.dumps(meta))
    return root


def test_load_nerf_dataset_equals_the_reference(tmp_path):
    from sienerf_tpu.io.nerf_dataset import load_nerf_dataset as jload
    from sienerf_torch.io.nerf_dataset import load_nerf_dataset

    root = _write_scene(tmp_path, np.random.default_rng(0))
    want, got = jload(root), load_nerf_dataset(root)
    for name in ("images", "xforms", "focal_lengths", "principal_points", "offset",
                 "sharpness", "rolling_shutter"):
        a, b = getattr(got, name), np.asarray(getattr(want, name))
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    for name in ("resolution", "aabb_scale", "scale", "is_hdr", "has_masks",
                 "n_extra_learnable_dims", "paths"):
        assert getattr(got, name) == getattr(want, name), name
    assert got.xforms_end is None and want.xforms_end is None
    assert got.lens.mode.value == want.lens.mode.value
    assert got.has_masks and (got.images[2, 5:9, 10:20, :3] == -1.0).all()
    assert (got.images[:, :2, :3, 3] == 0.0).all()  # white = transparent
    assert got.resolution == (W, H)


def test_loader_refuses_depth_images(tmp_path):
    """Ported since: depth images load in NGP units (the stored value times
    integer_depth_scale times the scene scale), 16-bit PNG equal to the
    reference's (which reads them with OpenCV), EXR through the port's
    codec; views without one read 0."""
    from sienerf_torch.io.exr import write_exr
    from sienerf_torch.io.nerf_dataset import load_nerf_dataset
    from sienerf_tpu.io.nerf_dataset import load_nerf_dataset as jload

    rng = np.random.default_rng(1)
    root = _write_scene(tmp_path, rng)
    meta = json.loads((root / "transforms.json").read_text())
    depth = rng.integers(0, 65536, (H, W), dtype=np.uint16)
    cv2.imwrite(str(root / "depth_0.png"), depth)
    meta["frames"][0]["depth_path"] = "depth_0.png"
    meta["integer_depth_scale"] = 1e-3
    (root / "transforms.json").write_text(json.dumps(meta))
    got, want = load_nerf_dataset(root), jload(root)
    assert got.depths.dtype == np.float32
    np.testing.assert_array_equal(got.depths, want.depths)
    np.testing.assert_allclose(got.depths[0], depth * np.float32(1e-3 * 0.4), rtol=1e-6)
    assert (got.depths[1:] == 0.0).all()
    exr = rng.random((H, W, 3), np.float32)
    write_exr(root / "depth_1.exr", exr, half=False)
    meta["frames"][1]["depth_path"] = "depth_1.exr"
    (root / "transforms.json").write_text(json.dumps(meta))
    got = load_nerf_dataset(root)
    np.testing.assert_allclose(got.depths[1], exr[..., 2] * np.float32(1e-3 * 0.4),
                               rtol=1e-6)  # OpenCV's first channel is blue


def test_load_image_matches_and_refuses_exr(tmp_path):
    from sienerf_tpu.io.image_io import load_image as jload
    from sienerf_torch.io.image_io import load_image

    img = np.random.default_rng(2).integers(0, 256, (5, 7, 3), dtype=np.uint8)
    cv2.imwrite(str(tmp_path / "a.png"), img)
    for linear in (False, True):
        np.testing.assert_array_equal(load_image(tmp_path / "a.png", linear),
                                      jload(tmp_path / "a.png", linear))
    # EXR now reads through the port's own codec (tests/test_torch_exr.py)
    from sienerf_tpu.io.exr import write_exr

    write_exr(tmp_path / "b.exr", np.random.default_rng(3).random((5, 7, 3), np.float32))
    np.testing.assert_array_equal(load_image(tmp_path / "b.exr"), jload(tmp_path / "b.exr"))


def _small_network(tmp_path):
    from test_torch_train import small_config

    path = tmp_path / "small.json"
    path.write_text(json.dumps(small_config()))
    return path


def test_trained_session_bakes_and_renders_from_the_ema_shadow(tmp_path, monkeypatch):
    from sienerf_torch.session import Session

    scene = tmp_path / "scene"
    scene.mkdir()
    _write_scene(scene, np.random.default_rng(3))
    sess = Session(seed=5, device="cpu")
    sess.load_file(scene, network=_small_network(tmp_path), grid_size=16,
                   train_batch_size=1 << 10, train_k=16)
    assert sess.engine.device.type == "cpu" and sess.state["step"] == 0
    loss = sess.train(16)
    assert np.isfinite(loss) and sess.training_step == 16 == sess.state["step"]
    ema = sess.state["opt"]["ema"]
    assert not torch.equal(ema["grid"], sess.state["params"]["grid"])
    assert sess.render_params() is ema

    seen = {}

    def capture(name, result):
        def fn(params, *a, **kw):
            seen[name] = params
            return result(params, *a, **kw)
        return fn

    eng = sess.engine
    monkeypatch.setattr(eng, "bake_features", capture("bake", eng.bake_features))
    monkeypatch.setattr(eng, "render_frame", capture("live", eng.render_frame))
    sess.bake(resolution=8)
    img = sess.render(12, 8, renderer="live")
    assert seen["bake"] is ema and seen["live"] is ema
    assert img.shape == (8, 12, 4) and bool(torch.isfinite(img).all())
    # a render-only state (no optimizer) renders its params
    sess.state = {"params": sess.state["params"], "occ": sess.state["occ"], "step": 16}
    assert sess.render_params() is sess.state["params"]
    with pytest.raises(RuntimeError, match="render-only"):
        sess.train(16)


def test_session_refuses_other_modes(tmp_path):
    from sienerf_torch.session import Session

    # SDF, image and volume scenes load since Slice F (tests/test_torch_
    # {sdf,image,volume}.py): a file their loaders cannot read raises there;
    # geometry scenes load (tests/test_torch_geometry.py)
    for scene, err in (("mesh.obj", "no triangles"), ("image.png", "failed to load"),
                       ("cloud.nvdb", "not a NanoVDB")):
        (tmp_path / scene).write_text("v 0 0 0\n")
        with pytest.raises((ValueError, IOError), match=err):
            Session(device="cpu").load_file(tmp_path / scene)
    (tmp_path / "scene.geometry.json").write_text("{}")
    assert Session(device="cpu").load_file(tmp_path / "scene.geometry.json").engine.objects == []
