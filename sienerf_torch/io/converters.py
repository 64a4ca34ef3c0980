"""Dataset converters: record3d / NSVF / NeRFCapture -> transforms.json,
plus the dynamic-mask generator (port of the JAX package's
io/converters.py, numpy as there).

Behavioral spec: reference scripts/record3d2nerf.py (:1-176),
scripts/nsvf2nerf.py (:1-162), scripts/nerfcapture2nerf.py (:139-226 — the
dataset-capture manifest; the DDS live-streaming front half is hardware
specific), scripts/mask_images.py (:30-85).  Each parses a capture format's
poses/intrinsics and emits an NGP transforms.json (NeRF-convention
camera-to-world, intrinsics, aabb_scale).
"""

from __future__ import annotations

import json
import math
from pathlib import Path

import numpy as np

from sienerf_torch.io.image_io import load_image, save_image


def _quat_to_mat(q):
    x, y, z, w = q  # record3d stores xyzw
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ]
    )


def _axis_angle_mat4(axis, angle):
    axis = np.asarray(axis, np.float64)
    axis = axis / np.linalg.norm(axis)
    x, y, z = axis
    c, s = math.cos(angle), math.sin(angle)
    C = 1 - c
    m = np.eye(4)
    m[:3, :3] = [
        [c + x * x * C, x * y * C - z * s, x * z * C + y * s],
        [y * x * C + z * s, c + y * y * C, y * z * C - x * s],
        [z * x * C - y * s, z * y * C + x * s, c + z * z * C],
    ]
    return m


def find_center_of_attention(matrices) -> np.ndarray:
    """The point minimizing distance to all camera view axes
    (record3d2nerf.py:40-62 `find_transforms_center_and_scale`)."""
    rays_o = []
    rays_d = []
    for m in matrices:
        m = np.asarray(m, np.float64)
        rays_o.append(m[:3, 3:4])
        rays_d.append(m[:3, 2:3])
    rays_o = np.asarray(rays_o)
    rays_d = np.asarray(rays_d)
    A_i = np.eye(3) - rays_d * np.transpose(rays_d, [0, 2, 1])
    b_i = -A_i @ rays_o
    pt = np.squeeze(-np.linalg.inv((np.transpose(A_i, [0, 2, 1]) @ A_i).mean(0)) @ b_i.mean(0))
    return pt


def normalize_transforms(transforms: dict, translation, scale: float) -> dict:
    """Shift camera centers by -translation then scale (record3d2nerf.py:78-85)."""
    out = json.loads(json.dumps(transforms))
    for f in out["frames"]:
        m = np.asarray(f["transform_matrix"], np.float64)
        m[:3, 3] -= np.asarray(translation, np.float64)
        m[:3, 3] *= scale
        f["transform_matrix"] = m.tolist()
    return out


def record3d_to_transforms(
    scene: str | Path,
    rotate: bool = False,
    subsample: int = 1,
    aabb_scale: int = 16,
    images_rel: str = "rgbd",
) -> dict:
    """Convert a Record3D capture (metadata json with poses
    [qx,qy,qz,qw,tx,ty,tz] and a column-major K) to a normalized
    transforms.json (reference record3d2nerf.py:95-176).

    `scene` is the capture directory (containing `metadata`) or the metadata
    file itself.  Camera centers are shifted to the center of attention and
    scaled so the average camera distance is 4 ("nerf sized").
    """
    scene = Path(scene)
    meta_path = scene if scene.is_file() else (scene / "metadata")
    if not meta_path.exists() and (scene / "metadata.json").exists():
        meta_path = scene / "metadata.json"
    meta = json.loads(meta_path.read_text())
    poses = np.asarray(meta["poses"], np.float64)

    frames = []
    for idx in range(poses.shape[0]):
        pose = poses[idx]
        c2w = np.eye(4)
        c2w[:3, :3] = _quat_to_mat(pose[:4])
        c2w[:3, 3] = pose[4:7]
        if rotate:
            # rotate the camera 90deg about its -z, then swap world axes
            c2w = c2w @ _axis_angle_mat4([0, 0, -1], math.pi / 2)
            c2w = _axis_angle_mat4([1, 0, 0], math.pi / 2) @ c2w
        frames.append(
            {"file_path": f"./{images_rel}/{idx}.jpg", "transform_matrix": c2w.tolist()}
        )

    # record3d K is stored column-major (record3d2nerf.py:138)
    K = np.asarray(meta["K"], np.float64).reshape(3, 3).T
    if not rotate:
        h, w = meta["h"], meta["w"]
        fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    else:
        h, w = meta["w"], meta["h"]
        fx, fy, cx, cy = K[1, 1], K[0, 0], K[1, 2], h - K[0, 2]

    transforms = {
        "fl_x": float(fx),
        "fl_y": float(fy),
        "cx": float(cx),
        "cy": float(cy),
        "w": w,
        "h": h,
        "aabb_scale": aabb_scale,
        "scale": 1.0,
        "camera_angle_x": 2 * math.atan(w / (2 * fx)),
        "camera_angle_y": 2 * math.atan(h / (2 * fy)),
        "frames": frames[::subsample],
    }
    mats = [f["transform_matrix"] for f in transforms["frames"]]
    translation = find_center_of_attention(mats)
    centered = [np.asarray(m)[:3, 3] - translation for m in mats]
    avglen = float(np.mean([np.linalg.norm(t) for t in centered]))
    scale = 4.0 / avglen  # scale to "nerf sized" (record3d2nerf.py:74)
    return normalize_transforms(transforms, translation, scale)


def _laplacian_variance(gray: np.ndarray) -> float:
    """Sharpness metric (nsvf2nerf.py:30-37, cv2.Laplacian(...).var())."""
    k = np.array([[0, 1, 0], [1, -4, 1], [0, 1, 0]], np.float64)
    g = np.asarray(gray, np.float64)
    out = (
        k[0, 1] * np.roll(g, 1, 0)
        + k[2, 1] * np.roll(g, -1, 0)
        + k[1, 0] * np.roll(g, 1, 1)
        + k[1, 2] * np.roll(g, -1, 1)
        + k[1, 1] * g
    )
    return float(out[1:-1, 1:-1].var())


def nsvf_to_transforms(
    dataset_dir: str | Path,
    aabb_scale: int = 1,
    white_transparent: bool = False,
    black_transparent: bool = False,
    compute_sharpness: bool = False,
) -> dict[str, dict]:
    """Convert an NSVF-format dataset (pose/*.txt 4x4 c2w, intrinsics.txt,
    bbox.txt, rgb/<split>_*.png) to transforms jsons per split.

    Behavior matches reference nsvf2nerf.py:39-162: poses are translated by
    the bbox centroid and scaled by 0.5/max(radius); then the NeRF-convention
    swizzle flips camera y/z columns, swaps world y/z rows and flips world z.
    Splits: filename prefix 0_ -> train, 1_ -> val, 2_ -> test (val becomes
    test when no 2_ files exist).  Returns {"train": {...}, ...}.
    """
    root = Path(dataset_dir)
    els = tuple(map(float, (root / "intrinsics.txt").read_text().split()))
    if len(els) == 11:
        fl_x = fl_y = els[0]
        cx, cy = els[1], els[2]
    elif len(els) >= 16:
        fl_x, fl_y = els[0], els[5]
        cx, cy = els[2], els[6]
    elif len(els) == 9:  # plain 3x3 K (extension beyond nsvf2nerf.py:78-91)
        fl_x, fl_y = els[0], els[4]
        cx, cy = els[2], els[5]
    else:
        raise ValueError(f"don't understand intrinsics file ({len(els)} elements)")

    bbox_file = root / "bbox.txt"
    if bbox_file.exists():
        bb = [float(v) for v in bbox_file.read_text().split()[:6]]
        centroid = np.asarray(
            [(bb[0] + bb[3]) * 0.5, (bb[1] + bb[4]) * 0.5, (bb[2] + bb[5]) * 0.5]
        )
        radius = max((bb[3] - bb[0]) * 0.5, (bb[4] - bb[1]) * 0.5, (bb[5] - bb[2]) * 0.5)
        scale = 0.5 / radius
    else:
        centroid = np.zeros(3)
        scale = 1.0

    w = h = None
    rgb_dir = root / "rgb"
    split_files = {
        s: sorted(rgb_dir.glob(f"{i}_*")) if rgb_dir.exists() else []
        for i, s in enumerate(("train", "val", "test"))
    }
    if not any(split_files.values()):
        # pose-only tree: enumerate from pose/*.txt, point file_path at rgb/
        for i, s in enumerate(("train", "val", "test")):
            split_files[s] = [
                root / "rgb" / (p.stem + ".png")
                for p in sorted((root / "pose").glob(f"{i}_*.txt"))
            ]
    # reference: with no test split, val files serve as test (nsvf2nerf.py:110-114)
    if not split_files["test"]:
        split_files["test"] = split_files.pop("val")
        split_files["val"] = []

    out: dict[str, dict] = {}
    for split, files in split_files.items():
        if not files:
            continue
        frames = []
        for img_f in files:
            pose_f = root / "pose" / (img_f.stem + ".txt")
            if not pose_f.exists():
                continue
            m = np.asarray(
                [float(v) for v in pose_f.read_text().split()], np.float64
            ).reshape(4, 4)
            c2w = m.copy()
            c2w[0:3, 3] -= centroid
            c2w[0:3, 3] *= scale
            c2w[0:3, 2] *= -1  # flip the y and z axis (nsvf2nerf.py:146-149)
            c2w[0:3, 1] *= -1
            c2w = c2w[[0, 2, 1, 3], :]  # swap y and z
            c2w[2, :] *= -1  # flip whole world upside down
            frame = {
                "file_path": str(img_f.relative_to(root)),
                "transform_matrix": c2w.tolist(),
            }
            if w is None:
                try:  # a pose-only tree has no images: w and h stay unset
                    img = load_image(img_f, as_float_linear=False)
                    h, w = img.shape[:2]
                except (OSError, ImportError, ValueError):
                    pass
            if compute_sharpness:
                img = load_image(img_f, as_float_linear=False)
                frame["sharpness"] = _laplacian_variance(
                    255.0 * img[..., :3].mean(axis=-1)
                )
            frames.append(frame)
        t = {
            "fl_x": fl_x,
            "fl_y": fl_y,
            "cx": cx,
            "cy": cy,
            "k1": 0,
            "k2": 0,
            "p1": 0,
            "p2": 0,
            "scale": 1,
            "white_transparent": white_transparent,
            "black_transparent": black_transparent,
            "aabb_scale": int(aabb_scale),
            "frames": frames,
        }
        if w:
            t["w"], t["h"] = w, h
            t["camera_angle_x"] = math.atan(w / (fl_x * 2)) * 2
            t["camera_angle_y"] = math.atan(h / (fl_y * 2)) * 2
        out[split] = t
    return out


def nerfcapture_to_transforms(
    frames: list[dict], depth_scale: float = 10.0
) -> dict:
    """Build the NeRFCapture dataset manifest from captured frame records
    (reference nerfcapture2nerf.py:139-226 `dataset_capture_loop`).

    Each frame dict carries: width, height, fl_x, fl_y, cx, cy,
    transform_matrix ((4,4), row-major world-from-camera), file_path, and
    optionally depth_path.  Depth images are uint16 with
    `integer_depth_scale = depth_scale/65535` meters per unit.
    """
    if not frames:
        raise ValueError("no frames")
    f0 = frames[0]
    manifest = {
        "fl_x": float(f0["fl_x"]),
        "fl_y": float(f0["fl_y"]),
        "cx": float(f0["cx"]),
        "cy": float(f0["cy"]),
        "w": f0["width"],
        "h": f0["height"],
        "integer_depth_scale": float(depth_scale) / 65535.0,
        "frames": [],
    }
    for i, fr in enumerate(frames):
        entry = {
            "transform_matrix": np.asarray(fr["transform_matrix"], np.float64).tolist(),
            "file_path": fr.get("file_path", f"images/{i}"),
            "fl_x": float(fr["fl_x"]),
            "fl_y": float(fr["fl_y"]),
            "cx": float(fr["cx"]),
            "cy": float(fr["cy"]),
            "w": fr["width"],
            "h": fr["height"],
        }
        if fr.get("depth_path"):
            entry["depth_path"] = fr["depth_path"]
        manifest["frames"].append(entry)
    return manifest


def generate_dynamic_masks(
    image_dir: str | Path, mask_categories: list[str], predictor=None
) -> int:
    """Write `dynamic_mask_<basename>.png` files marking instances of the
    given categories (reference scripts/mask_images.py:30-85; the NeRF
    loader paints masked pixels and training skips them,
    nerf_loader.cu:596-612 / testbed_nerf.cu:776-780).

    `predictor(image_rgb_u8) -> (classes (M,), masks (M,H,W) bool)` supplies
    the segmentation model; the reference uses detectron2 Mask R-CNN, which
    is not bundled here — pass any instance-segmentation callable.
    """
    if predictor is None:
        raise RuntimeError(
            "generate_dynamic_masks needs a `predictor` callable "
            "(detectron2/torchvision are not bundled in this environment)"
        )
    cat_path = Path(__file__).with_name("category2id.json")
    category2id = json.loads(cat_path.read_text()) if cat_path.exists() else {}
    mask_ids = {category2id.get(c, c) for c in mask_categories}
    n = 0
    for img_path in sorted(Path(image_dir).iterdir()):
        if img_path.suffix.lower() not in (".jpg", ".jpeg", ".png", ".bmp", ".exr"):
            continue
        if img_path.name.startswith("dynamic_mask_"):
            continue
        img = load_image(img_path, as_float_linear=False)
        classes, masks = predictor((img[..., :3] * 255).astype(np.uint8))
        out_mask = np.zeros(img.shape[:2], bool)
        for cls, m in zip(classes, masks):
            if cls in mask_ids or str(cls) in mask_ids:
                out_mask |= np.asarray(m, bool)
        mask_rgba = np.repeat(out_mask[..., None].astype(np.float32), 4, axis=-1)
        save_image(
            img_path.parent / f"dynamic_mask_{img_path.stem}.png",
            mask_rgba,
            input_is_linear=False,
        )
        n += 1
    return n
