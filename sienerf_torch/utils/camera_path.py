"""Camera paths: keyframes of camera orientation (a quaternion), position,
field of view and aperture; playback slerps orientations and runs a
Catmull-Rom spline through positions; paths save to and load from JSON;
render_video renders a path through a session into an mp4 (port of the
JAX package's utils/camera_path.py, in float64 numpy as there)."""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

from sienerf_torch.utils.camera import fov_to_focal_length, look_at_matrix


def mat_to_quat(m: np.ndarray) -> np.ndarray:
    """(3, 3) rotation -> quaternion (w, x, y, z)."""
    t = np.trace(m)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        return np.array([0.25 * s, (m[2, 1] - m[1, 2]) / s, (m[0, 2] - m[2, 0]) / s,
                         (m[1, 0] - m[0, 1]) / s])
    i = int(np.argmax(np.diag(m)))
    j, k = (i + 1) % 3, (i + 2) % 3
    s = np.sqrt(max(m[i, i] - m[j, j] - m[k, k] + 1.0, 1e-12)) * 2
    q = np.zeros(4)
    q[0] = (m[k, j] - m[j, k]) / s
    q[1 + i] = 0.25 * s
    q[1 + j] = (m[j, i] + m[i, j]) / s
    q[1 + k] = (m[k, i] + m[i, k]) / s
    return q


def quat_to_mat(q: np.ndarray) -> np.ndarray:
    """Quaternion (w, x, y, z), normalised here -> (3, 3) rotation."""
    w, x, y, z = q / np.linalg.norm(q)
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def slerp(q0, q1, t):
    """Spherical interpolation of unit quaternions along the shorter arc
    (linear, renormalised, where they are within 0.9995 of each other)."""
    d = float(np.dot(q0, q1))
    if d < 0:
        q1, d = -q1, -d
    if d > 0.9995:
        out = q0 + t * (q1 - q0)
        return out / np.linalg.norm(out)
    th = np.arccos(np.clip(d, -1, 1))
    return (np.sin((1 - t) * th) * q0 + np.sin(t * th) * q1) / np.sin(th)


@dataclass
class Keyframe:
    xform: np.ndarray  # (3, 4) NGP camera matrix
    fov: float = 50.0
    aperture: float = 0.0
    timestamp: float = 0.0

    def to_json(self) -> dict:
        q = mat_to_quat(self.xform[:3, :3])
        return {"R": list(map(float, q)), "T": list(map(float, self.xform[:3, 3])),
                "fov": self.fov, "aperture_size": self.aperture}

    @staticmethod
    def from_json(d: dict) -> "Keyframe":
        R = quat_to_mat(np.asarray(d["R"], np.float64))
        t = np.asarray(d["T"], np.float64)
        xf = np.concatenate([R, t[:, None]], axis=1).astype(np.float32)
        return Keyframe(xf, float(d.get("fov", 50.0)), float(d.get("aperture_size", 0.0)))


@dataclass
class CameraPath:
    keyframes: list = field(default_factory=list)
    loop: bool = False

    def add_keyframe(self, xform, fov: float = 50.0, aperture: float = 0.0):
        self.keyframes.append(Keyframe(np.asarray(xform, np.float32), fov, aperture))

    def eval(self, t: float) -> Keyframe:
        """The camera at t in [0, 1] over the whole path: orientations
        slerped, positions on a Catmull-Rom spline, fov and aperture
        linear between the segment's keyframes."""
        kf = self.keyframes
        n = len(kf)
        if n == 0:
            raise ValueError("empty camera path")
        if n == 1:
            return kf[0]
        seg_count = n if self.loop else n - 1
        s = np.clip(t, 0.0, 1.0) * seg_count
        i = min(int(s), seg_count - 1)
        u = s - i

        def P(j):
            return kf[j % n].xform[:3, 3] if self.loop else kf[np.clip(j, 0, n - 1)].xform[:3, 3]

        p0, p1, p2, p3 = P(i - 1), P(i), P(i + 1), P(i + 2)
        pos = 0.5 * ((2 * p1) + (-p0 + p2) * u + (2 * p0 - 5 * p1 + 4 * p2 - p3) * u * u
                     + (-p0 + 3 * p1 - 3 * p2 + p3) * u * u * u)
        q1 = mat_to_quat(kf[i % n].xform[:3, :3])
        q2 = mat_to_quat(kf[(i + 1) % n].xform[:3, :3])
        R = quat_to_mat(slerp(q1, q2, u))
        fov = (1 - u) * kf[i % n].fov + u * kf[(i + 1) % n].fov
        ap = (1 - u) * kf[i % n].aperture + u * kf[(i + 1) % n].aperture
        xf = np.concatenate([R, pos[:, None]], axis=1).astype(np.float32)
        return Keyframe(xf, float(fov), float(ap), t)

    def save(self, path: str | Path):
        Path(path).write_text(json.dumps(
            {"loop": self.loop, "path": [k.to_json() for k in self.keyframes]}, indent=1))

    @staticmethod
    def load(path: str | Path) -> "CameraPath":
        d = json.loads(Path(path).read_text())
        cp = CameraPath(loop=bool(d.get("loop", False)))
        cp.keyframes = [Keyframe.from_json(k) for k in d.get("path", [])]
        return cp

    @staticmethod
    def orbit(center, radius: float, height: float, n: int = 8,
              fov: float = 50.0) -> "CameraPath":
        """A looping path of n cameras on a circle around `center`, each
        looking at it."""
        cp = CameraPath(loop=True)
        c = np.asarray(center, np.float32)
        for i in range(n):
            a = 2 * np.pi * i / n
            eye = c + np.array([radius * np.cos(a), height, radius * np.sin(a)], np.float32)
            cp.add_keyframe(look_at_matrix(eye, c), fov=fov)
        return cp


def render_video(session, camera_path: CameraPath, out_path: str | Path, width: int = 640,
                 height: int = 360, n_frames: int = 60, fps: int = 30, **render_kw):
    """Render n_frames cameras evenly along `camera_path` through
    `session.render` (render_kw passed on) into an mp4 at `out_path`,
    written by OpenCV's VideoWriter (mp4v) as the JAX package writes it;
    raises where OpenCV is missing."""
    try:
        import cv2
    except ImportError as e:
        raise ImportError("render_video writes mp4 through OpenCV (the cv2 module), which "
                          "is not installed") from e

    writer = cv2.VideoWriter(str(out_path), cv2.VideoWriter_fourcc(*"mp4v"), fps,
                             (width, height))
    try:
        for i in range(n_frames):
            k = camera_path.eval(i / max(n_frames - 1, 1))
            fl = fov_to_focal_length(width, k.fov)
            rgba = session.render(width, height, camera_matrix=k.xform, focal=(fl, fl),
                                  **render_kw)
            if hasattr(rgba, "cpu"):  # the port's sessions render torch tensors
                rgba = rgba.cpu().numpy()
            frame = (np.clip(np.asarray(rgba[..., :3]), 0, 1) * 255).astype(np.uint8)
            writer.write(np.ascontiguousarray(frame[..., ::-1]))
    finally:
        writer.release()
    return out_path
