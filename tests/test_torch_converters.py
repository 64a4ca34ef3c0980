"""The dataset converters, port vs reference, on captures built in code:
record3d (metadata with quaternion poses and a column-major K, plain and
rotated, subsampled), NSVF (pose/*.txt, intrinsics of 11, 16 and 9
values, bbox.txt, rgb/ PNGs of three splits, a pose-only tree, sharpness),
NeRFCapture frame records, COLMAP text models (cameras.txt of each camera
model, images.txt) through colmap_to_transforms and its command line, and
generate_dynamic_masks with a stub predictor.

Tolerances: the transforms dicts equal, floats within rtol 1e-6 / atol
1e-6 (the same numpy float64 arithmetic); the mask files' pixels equal."""

import json
import math

import numpy as np
import pytest
import torch

from sienerf_torch.io import colmap2nerf as tcol
from sienerf_torch.io import converters as tconv
from sienerf_tpu.io import colmap2nerf as jcol
from sienerf_tpu.io import converters as jconv


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


def assert_tree_close(got, want, path="$"):
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), path
        for k in want:
            assert_tree_close(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, (list, tuple)):
        assert isinstance(got, (list, tuple)) and len(got) == len(want), path
        for i, (a, b) in enumerate(zip(got, want)):
            assert_tree_close(a, b, f"{path}[{i}]")
    elif isinstance(want, (float, np.floating)) and not isinstance(want, bool):
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6, err_msg=path)
    else:
        assert type(got) is type(want) and got == want, path


def _poses_looking_at(rng, n, center, radius):
    out = []
    for i in range(n):
        a = 2 * math.pi * i / n
        eye = center + radius * np.array([math.cos(a), 0.3 * rng.normal(), math.sin(a)])
        fwd = (center - eye) / np.linalg.norm(center - eye)
        right = np.cross(fwd, [0.0, 1.0, 0.0])
        right /= np.linalg.norm(right)
        up = np.cross(right, fwd)
        m = np.eye(4)
        m[:3, :3] = np.stack([right, up, -fwd], axis=1)  # camera looks down -z
        m[:3, 3] = eye
        out.append(m)
    return out


@pytest.mark.parametrize("rotate,subsample", [(False, 1), (True, 2)])
def test_record3d(rotate, subsample, tmp_path):
    rng = np.random.default_rng(1)
    poses = []
    for m in _poses_looking_at(rng, 9, np.array([0.2, -0.1, 1.5]), 2.0):
        w = math.sqrt(max(1.0 + np.trace(m[:3, :3]), 1e-12)) / 2
        x = (m[2, 1] - m[1, 2]) / (4 * w)
        y = (m[0, 2] - m[2, 0]) / (4 * w)
        z = (m[1, 0] - m[0, 1]) / (4 * w)
        poses.append([x, y, z, w, *m[:3, 3]])
    K = np.array([[500.0, 0, 320.0], [0, 510.0, 240.0], [0, 0, 1]])
    meta = {"poses": poses, "K": K.T.reshape(-1).tolist(), "w": 640, "h": 480}
    (tmp_path / "metadata").write_text(json.dumps(meta))
    kw = dict(rotate=rotate, subsample=subsample, aabb_scale=8)
    want = jconv.record3d_to_transforms(tmp_path, **kw)
    got = tconv.record3d_to_transforms(tmp_path, **kw)
    assert_tree_close(got, want)
    assert len(got["frames"]) == len(range(0, 9, subsample))
    assert_tree_close(tconv.record3d_to_transforms(tmp_path / "metadata", **kw), want)


def _nsvf_tree(root, n_intr, with_images=True, with_bbox=True):
    from sienerf_torch.io.png import write_png

    rng = np.random.default_rng(n_intr)
    (root / "pose").mkdir(parents=True)
    if with_images:
        (root / "rgb").mkdir()
    names = [f"0_{i:03d}" for i in range(4)] + [f"1_{i:03d}" for i in range(2)]
    if n_intr != 9:
        names += [f"2_{i:03d}" for i in range(2)]
    for name, m in zip(names, _poses_looking_at(rng, len(names), np.zeros(3), 3.0)):
        (root / "pose" / f"{name}.txt").write_text(" ".join(f"{v:.9f}" for v in m.reshape(-1)))
        if with_images:
            img = rng.integers(0, 256, (20, 28, 4), dtype=np.uint8)
            write_png(root / "rgb" / f"{name}.png", img)
    intr = {11: [600.0, 14.0, 10.0] + [0.0] * 8,
            16: [600.0, 0, 14.0, 0, 0, 610.0, 10.0, 0, 0, 0, 1, 0, 0, 0, 0, 1],
            9: [600.0, 0, 14.0, 0, 610.0, 10.0, 0, 0, 1]}[n_intr]
    (root / "intrinsics.txt").write_text(" ".join(map(str, intr)))
    if with_bbox:
        (root / "bbox.txt").write_text("-1.0 -0.5 -2.0 1.5 0.5 1.0 0.01")


@pytest.mark.parametrize("n_intr,images,bbox", [(11, True, True), (16, True, False),
                                                (9, True, True), (16, False, True)])
def test_nsvf(n_intr, images, bbox, tmp_path):
    _nsvf_tree(tmp_path, n_intr, images, bbox)
    kw = dict(aabb_scale=2, white_transparent=True, compute_sharpness=images)
    want = jconv.nsvf_to_transforms(tmp_path, **kw)
    got = tconv.nsvf_to_transforms(tmp_path, **kw)
    assert_tree_close(got, want)
    assert set(got) == ({"train", "test"} if n_intr == 9 else {"train", "val", "test"})
    assert ("w" in got["train"]) == images


def test_nerfcapture():
    rng = np.random.default_rng(3)
    frames = []
    for i, m in enumerate(_poses_looking_at(rng, 5, np.zeros(3), 1.0)):
        fr = {"width": 192, "height": 256, "fl_x": 200.0 + i, "fl_y": 201.0, "cx": 96.0,
              "cy": 128.0, "transform_matrix": m}
        if i % 2:
            fr["depth_path"] = f"depth/{i}.png"
        if i != 3:
            fr["file_path"] = f"images/{i}.png"
        frames.append(fr)
    assert_tree_close(tconv.nerfcapture_to_transforms(frames, depth_scale=4.0),
                      jconv.nerfcapture_to_transforms(frames, depth_scale=4.0))
    for mod in (tconv, jconv):
        with pytest.raises(ValueError, match="no frames"):
            mod.nerfcapture_to_transforms([])


def test_dynamic_masks(tmp_path):
    import cv2

    from sienerf_torch.io.png import write_png

    imgs = np.random.default_rng(4).integers(0, 256, (3, 12, 16, 3), dtype=np.uint8)
    for d in ("t", "j"):
        (tmp_path / d).mkdir()
        for i in range(3):
            write_png(tmp_path / d / f"im{i}.png", imgs[i])
    calls = []

    def predictor(img):
        calls.append(img.shape)
        h, w = img.shape[:2]
        masks = np.zeros((3, h, w), bool)
        masks[0, :4] = True
        masks[1, :, :5] = True
        masks[2, 6:, 8:] = img[6:, 8:, 0] > 128
        return np.array(["person", "car", 7]), masks

    cats = ["person", "7"]
    assert tconv.generate_dynamic_masks(tmp_path / "t", cats, predictor) == 3
    assert jconv.generate_dynamic_masks(tmp_path / "j", cats, predictor) == 3
    assert calls == [(12, 16, 3)] * 6  # the masks are not read back as images
    for i in range(3):
        got = cv2.imread(str(tmp_path / "t" / f"dynamic_mask_im{i}.png"), cv2.IMREAD_UNCHANGED)
        want = cv2.imread(str(tmp_path / "j" / f"dynamic_mask_im{i}.png"), cv2.IMREAD_UNCHANGED)
        np.testing.assert_array_equal(got, want)
        assert got[:4].all() and got.shape == (12, 16, 4)
    with pytest.raises(RuntimeError, match="predictor"):
        tconv.generate_dynamic_masks(tmp_path / "t", cats)


_MODELS = {
    "SIMPLE_PINHOLE": [520.0, 320.0, 240.0],
    "PINHOLE": [520.0, 525.0, 320.0, 240.0],
    "SIMPLE_RADIAL": [520.0, 320.0, 240.0, 0.01],
    "RADIAL": [520.0, 320.0, 240.0, 0.01, -0.002],
    "OPENCV": [520.0, 525.0, 320.0, 240.0, 0.01, -0.002, 1e-4, -2e-4],
}


def _colmap_model(root, model, seed=5):
    rng = np.random.default_rng(seed)
    root.mkdir(parents=True)
    (root / "cameras.txt").write_text(
        "# Camera list\n" + f"1 {model} 640 480 " + " ".join(map(str, _MODELS[model])) + "\n")
    lines = ["# Image list", "#   IMAGE_ID, QW, QX, QY, QZ, TX, TY, TZ, CAMERA_ID, NAME"]
    for i, c2w in enumerate(_poses_looking_at(rng, 7, np.array([0.5, 1.0, -0.3]), 3.0)):
        c2w = c2w.copy()
        c2w[:3, 1:3] *= -1  # COLMAP's camera looks down +z with y down
        R = c2w[:3, :3].T
        t = -R @ c2w[:3, 3]
        w = math.sqrt(max(1.0 + np.trace(R), 1e-12)) / 2
        q = [w, (R[2, 1] - R[1, 2]) / (4 * w), (R[0, 2] - R[2, 0]) / (4 * w),
             (R[1, 0] - R[0, 1]) / (4 * w)]
        lines.append(f"{i + 1} " + " ".join(f"{v:.12f}" for v in (*q, *t)) + f" 1 img{i}.jpg")
        lines.append("100.0 200.0 -1 300.0 50.0 -1")  # the image's 2-D points
    (root / "images.txt").write_text("\n".join(lines) + "\n")


@pytest.mark.parametrize("model", list(_MODELS))
def test_colmap(model, tmp_path):
    _colmap_model(tmp_path / "sparse", model)
    for keep in (False, True):
        want = jcol.colmap_to_transforms(tmp_path / "sparse", "images", 4, keep)
        got = tcol.colmap_to_transforms(tmp_path / "sparse", "images", 4, keep)
        assert_tree_close(got, want)
        assert len(got["frames"]) == 7


def test_colmap_main_and_unsupported_model(tmp_path, capsys):
    _colmap_model(tmp_path / "sparse", "OPENCV")
    args = ["--colmap_text", str(tmp_path / "sparse"), "--aabb_scale", "2"]
    tcol.main(args + ["--out", str(tmp_path / "t.json")])
    jcol.main(args + ["--out", str(tmp_path / "j.json")])
    assert_tree_close(json.loads((tmp_path / "t.json").read_text()),
                      json.loads((tmp_path / "j.json").read_text()))
    out = capsys.readouterr().out.splitlines()
    assert out[0].endswith("with 7 frames") and out[1].endswith("with 7 frames")
    (tmp_path / "sparse" / "cameras.txt").write_text("1 FOV 640 480 1 2 3\n")
    for mod in (tcol, jcol):
        with pytest.raises(ValueError, match="FOV"):
            mod.colmap_to_transforms(tmp_path / "sparse")
