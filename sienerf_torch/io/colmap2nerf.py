"""COLMAP -> transforms.json converter (port of the JAX package's
io/colmap2nerf.py, numpy as there).

Behavioral spec: reference scripts/colmap2nerf.py (:1-465): parse a COLMAP
sparse model (cameras.txt / images.txt, text format), build NGP-style
transforms.json: per-frame camera-to-world matrices flipped into the NeRF
convention, shared intrinsics (fl/cx/cy/k1/k2/p1/p2), scene reorientation
(up vector -> +z), recentering so the cameras' closest-approach point is
the origin, and average-distance rescaling to 4/3 (= the reference's
`--scale` semantics with aabb filling).

The reference also shells out to the `colmap` binaries for SfM; that stage
is external here too (run COLMAP yourself; this converts its output).
"""

from __future__ import annotations

import json
import math
from pathlib import Path

import numpy as np


def _qvec2rotmat(q):
    w, x, y, z = q
    return np.array(
        [
            [1 - 2 * y * y - 2 * z * z, 2 * x * y - 2 * z * w, 2 * x * z + 2 * y * w],
            [2 * x * y + 2 * z * w, 1 - 2 * x * x - 2 * z * z, 2 * y * z - 2 * x * w],
            [2 * x * z - 2 * y * w, 2 * y * z + 2 * x * w, 1 - 2 * x * x - 2 * y * y],
        ]
    )


def parse_cameras_txt(path: Path) -> dict:
    out = {}
    for line in Path(path).read_text().splitlines():
        if line.startswith("#") or not line.strip():
            continue
        el = line.split()
        cam_id, model, w, h = int(el[0]), el[1], float(el[2]), float(el[3])
        p = list(map(float, el[4:]))
        cam = {"w": w, "h": h, "k1": 0.0, "k2": 0.0, "p1": 0.0, "p2": 0.0}
        if model == "SIMPLE_PINHOLE":
            cam.update(fl_x=p[0], fl_y=p[0], cx=p[1], cy=p[2])
        elif model == "PINHOLE":
            cam.update(fl_x=p[0], fl_y=p[1], cx=p[2], cy=p[3])
        elif model == "SIMPLE_RADIAL":
            cam.update(fl_x=p[0], fl_y=p[0], cx=p[1], cy=p[2], k1=p[3])
        elif model == "RADIAL":
            cam.update(fl_x=p[0], fl_y=p[0], cx=p[1], cy=p[2], k1=p[3], k2=p[4])
        elif model == "OPENCV":
            cam.update(fl_x=p[0], fl_y=p[1], cx=p[2], cy=p[3], k1=p[4], k2=p[5], p1=p[6], p2=p[7])
        else:
            raise ValueError(f"unsupported COLMAP camera model {model}")
        cam["camera_angle_x"] = 2 * math.atan(w / (2 * cam["fl_x"]))
        cam["camera_angle_y"] = 2 * math.atan(h / (2 * cam["fl_y"]))
        out[cam_id] = cam
    return out


def parse_images_txt(path: Path) -> list[dict]:
    frames = []
    lines = [l for l in Path(path).read_text().splitlines() if not l.startswith("#")]
    for i in range(0, len(lines) - 1, 2):
        el = lines[i].split()
        if len(el) < 10:
            continue
        q = np.array(list(map(float, el[1:5])))
        t = np.array(list(map(float, el[5:8])))
        cam_id = int(el[8])
        name = el[9]
        R = _qvec2rotmat(q)
        # COLMAP stores world-to-camera; invert to camera-to-world
        c2w = np.eye(4)
        c2w[:3, :3] = R.T
        c2w[:3, 3] = -R.T @ t
        # NeRF convention: flip y and z camera axes
        c2w[0:3, 1] *= -1
        c2w[0:3, 2] *= -1
        frames.append({"file_path": name, "transform_matrix": c2w, "camera_id": cam_id})
    return frames


def closest_point_2_lines(oa, da, ob, db):
    """Midpoint of the common perpendicular of two rays, plus a weight.

    Least-squares formulation: minimize |(oa + ta*da) - (ob + tb*db)|^2 over
    (ta, tb).  The normal equations give
        ta = (dot(t, da) - g * dot(t, db)) / (1 - g^2)
        tb = (g * dot(t, da) - dot(t, db)) / (1 - g^2)
    with t = ob - oa and g = dot(da, db); 1 - g^2 = sin^2(angle) doubles as
    the conditioning weight returned to the caller (near-parallel ray pairs
    contribute almost nothing to the scene-center estimate).  Camera rays
    point *at* the scene, so positive parameters (closest approach behind
    the cameras) are clamped to the origins — same convention as the
    reference helper (scripts/colmap2nerf.py closest_point_2_lines), which
    this replaces with an independent derivation.
    """
    da = da / np.linalg.norm(da)
    db = db / np.linalg.norm(db)
    g = float(np.dot(da, db))
    w = max(1.0 - g * g, 0.0)  # = |da x db|^2
    t = ob - oa
    inv = 1.0 / (w + 1e-10)
    ta = min((np.dot(t, da) - g * np.dot(t, db)) * inv, 0.0)
    tb = min((g * np.dot(t, da) - np.dot(t, db)) * inv, 0.0)
    return 0.5 * ((oa + ta * da) + (ob + tb * db)), w


def colmap_to_transforms(
    sparse_dir: str | Path,
    images_rel: str = "images",
    aabb_scale: int = 16,
    keep_colmap_coords: bool = False,
) -> dict:
    """Convert a COLMAP text model directory to a transforms.json dict."""
    sparse_dir = Path(sparse_dir)
    cams = parse_cameras_txt(sparse_dir / "cameras.txt")
    frames = parse_images_txt(sparse_dir / "images.txt")
    if not frames:
        raise ValueError("no images in COLMAP model")
    cam0 = cams[frames[0]["camera_id"]]

    if not keep_colmap_coords:
        up = np.zeros(3)
        for f in frames:
            up += -np.asarray(f["transform_matrix"])[0:3, 1]
        up = up / np.linalg.norm(up)
        # rotate up to +z, then swap to NGP's preferred axes (z-up -> y-up
        # happens later in the loader's cycling)
        c = np.cross(up, [0, 0, 1])
        s = np.linalg.norm(c)
        if s > 1e-6:
            k = c / s
            K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
            Rup = np.eye(3) + K * s + K @ K * (1 - float(np.dot(up, [0, 0, 1])))
        else:
            Rup = np.eye(3)
        R4 = np.eye(4)
        R4[:3, :3] = Rup
        for f in frames:
            f["transform_matrix"] = R4 @ f["transform_matrix"]

        # recenter at the cameras' mutual closest-approach point
        totw, totp = 0.0, np.zeros(3)
        for fa in frames:
            ma = np.asarray(fa["transform_matrix"])
            for fb in frames:
                mb = np.asarray(fb["transform_matrix"])
                p, w = closest_point_2_lines(ma[0:3, 3], ma[0:3, 2], mb[0:3, 3], mb[0:3, 2])
                if w > 0.00001:
                    totp += p * w
                    totw += w
        if totw > 0:
            totp /= totw
        avglen = 0.0
        for f in frames:
            f["transform_matrix"][0:3, 3] -= totp
            avglen += np.linalg.norm(f["transform_matrix"][0:3, 3])
        avglen /= len(frames)
        for f in frames:
            f["transform_matrix"][0:3, 3] *= 4.0 / avglen

    out = dict(cam0)
    out["aabb_scale"] = aabb_scale
    out["frames"] = [
        {
            "file_path": f"{images_rel}/{f['file_path']}",
            "transform_matrix": np.asarray(f["transform_matrix"]).tolist(),
        }
        for f in frames
    ]
    return out


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(description="COLMAP text model -> transforms.json")
    p.add_argument("--colmap_text", required=True, help="dir with cameras.txt/images.txt")
    p.add_argument("--images", default="images")
    p.add_argument("--aabb_scale", type=int, default=16)
    p.add_argument("--out", default="transforms.json")
    p.add_argument("--keep_colmap_coords", action="store_true")
    args = p.parse_args(argv)
    out = colmap_to_transforms(args.colmap_text, args.images, args.aabb_scale, args.keep_colmap_coords)
    Path(args.out).write_text(json.dumps(out, indent=2))
    print(f"wrote {args.out} with {len(out['frames'])} frames")


if __name__ == "__main__":
    main()
