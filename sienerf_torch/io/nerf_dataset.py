"""NeRF datasets: transforms.json and its images (port of the JAX package's
io/nerf_dataset.py).

Conventions kept exactly:
- NGP world space: the scene is mapped near the unit cube by the dataset's
  `scale` (default NERF_SCALE = 0.33) and `offset` (default (0.5, 0.5, 0.5)).
- NeRF camera matrices become NGP ones by negating columns 1 and 2,
  scaling and offsetting the translation, and cycling the rows xyz <- yzx.
- Focal lengths come from fl_x / fl_y or camera_angle_x / y; the principal
  point from cx / cy.
- LDR images stay in sRGB (NeRF trains in sRGB); alpha is composited over
  the background in the loss, not here.  Pixels of a dynamic mask carry
  rgb -1 and alpha 0, and training skips them.

Images load through io/image_io.py: PNG through the port's own decoder
(io/png.py), EXR through the port's own codec (io/exr.py, linear, and the
dataset is then HDR), JPG through OpenCV, imported when such an image is
read.  Depth images (a frame's `depth_path`) are in NGP units: the stored
value times `integer_depth_scale` (default 1/65535) times the scene scale;
16-bit PNG and EXR read through the port's own readers, any other format
through OpenCV.
"""

from __future__ import annotations

import concurrent.futures as futures
import json
import math
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

from sienerf_torch.common import NERF_SCALE, LensMode
from sienerf_torch.utils.camera import Lens, look_at_matrix


def nerf_matrix_to_ngp(m: np.ndarray, scale: float, offset: np.ndarray) -> np.ndarray:
    """(3|4, 4) NeRF-convention camera-to-world -> NGP (3, 4)."""
    m = np.asarray(m, np.float32)[:3, :]
    out = m.copy()
    out[:, 1] *= -1.0
    out[:, 2] *= -1.0
    out[:, 3] = out[:, 3] * scale + offset
    return out[[1, 2, 0], :]


def ngp_matrix_to_nerf(m: np.ndarray, scale: float, offset: np.ndarray) -> np.ndarray:
    out = np.asarray(m, np.float32)[[2, 0, 1], :].copy()
    out[:, 1] *= -1.0
    out[:, 2] *= -1.0
    out[:, 3] = (out[:, 3] - offset) / scale
    return out


def nerf_position_to_ngp(p: np.ndarray, scale: float, offset: np.ndarray) -> np.ndarray:
    rv = np.asarray(p, np.float32) * scale + offset
    return rv[..., [1, 2, 0]]


def ngp_position_to_nerf(p: np.ndarray, scale: float, offset: np.ndarray) -> np.ndarray:
    return (np.asarray(p, np.float32)[..., [2, 0, 1]] - offset) / scale


@dataclass
class NerfDataset:
    """All images share one resolution (smaller ones are zero-padded)."""

    images: np.ndarray  # (N, H, W, 4) float32, sRGB (LDR)
    xforms: np.ndarray  # (N, 3, 4) NGP-convention camera-to-world
    focal_lengths: np.ndarray  # (N, 2)
    principal_points: np.ndarray  # (N, 2) in [0,1]
    resolution: tuple[int, int]  # (W, H)
    lens: Lens = field(default_factory=Lens)
    aabb_scale: float = 1.0
    scale: float = NERF_SCALE
    offset: np.ndarray = field(default_factory=lambda: np.full(3, 0.5, np.float32))
    is_hdr: bool = False
    depths: np.ndarray | None = None  # (N, H, W) depth in NGP units (0 = none)
    sharpness: np.ndarray | None = None
    n_extra_learnable_dims: int = 0
    paths: list = field(default_factory=list)
    # rolling shutter / motion blur: per-pixel time rs[0] + rs[1] u + rs[2] v
    # + rs[3] motionblur between xforms (start) and xforms_end
    rolling_shutter: np.ndarray = field(default_factory=lambda: np.zeros(4, np.float32))
    xforms_end: np.ndarray | None = None  # (N, 3, 4); None: static cameras
    has_masks: bool = False  # any dynamic-mask pixels (rgb -1)
    envmap: np.ndarray | None = None  # (He, We, 4) linear, the envmap's start
    light_dirs: np.ndarray | None = None  # (N, 3) fixed per-image light directions

    @property
    def n_images(self) -> int:
        return self.images.shape[0]

    @property
    def n_extra_dims(self) -> int:
        return (3 if self.light_dirs is not None else 0) + self.n_extra_learnable_dims

    @staticmethod
    def placeholder(aabb_scale: float) -> "NerfDataset":
        """A one-view 8x8 stand-in for rendering a snapshot without its
        dataset: the camera looks at the cube centre from outside the aabb
        (as NerfEngine.from_ingp builds one in the JAX package)."""
        c, r = 0.5, 0.5 + aabb_scale
        return NerfDataset(
            images=np.zeros((1, 8, 8, 4), np.float32),
            xforms=look_at_matrix([c, c, c - r], [c, c, c])[None].astype(np.float32),
            focal_lengths=np.full((1, 2), 8.0, np.float32),
            principal_points=np.full((1, 2), 0.5, np.float32),
            resolution=(8, 8),
            aabb_scale=aabb_scale,
        )


def _resolve_image_path(base: Path, file_path: str) -> Path | None:
    p = base / file_path
    if p.exists() and p.is_file():
        return p
    for ext in (".png", ".jpg", ".jpeg", ".exr"):
        q = base / (file_path + ext)
        if q.exists():
            return q
    return None


def _read_depth(path: Path) -> np.ndarray | None:
    """A depth image's first channel as OpenCV reads it (IMREAD_UNCHANGED,
    channels in BGR order): 8- or 16-bit PNG through io/png.py, EXR through
    io/exr.py, other formats through OpenCV."""
    suffix = path.suffix.lower()
    if suffix == ".png":
        from sienerf_torch.io.png import read_png

        d = read_png(path)
        if d.ndim == 3:
            d = d[..., 2] if d.shape[-1] >= 3 else d[..., 0]
        return d
    if suffix == ".exr":
        from sienerf_torch.io.exr import read_exr

        ch = read_exr(path)
        name = "B" if "B" in ch else sorted(ch)[0]
        return np.asarray(ch[name], np.float32)
    from sienerf_torch.io.image_io import _cv2

    cv2 = _cv2()
    d = cv2.imread(str(path), cv2.IMREAD_UNCHANGED)
    if d is not None and d.ndim == 3:
        d = d[..., 0]
    return d


def load_nerf_dataset(path: str | Path, split: str = "train", downscale: int = 1,
                      max_images: int | None = None) -> NerfDataset:
    """Load a directory holding transforms.json (or transforms_{split}.json,
    or several transforms*.json, merged), or one such file."""
    from sienerf_torch.io.image_io import load_image

    path = Path(path)
    if path.is_file():
        json_paths = [path]
        base = path.parent
    else:
        base = path
        candidates = [path / f"transforms_{split}.json", path / "transforms.json"]
        json_paths = [p for p in candidates if p.exists()][:1]
        if not json_paths:
            json_paths = sorted(path.glob("transforms*.json"))
        if not json_paths:
            raise FileNotFoundError(f"no transforms json under {path}")

    meta: dict = {}
    frames: list[dict] = []
    for jp in json_paths:
        j = json.loads(jp.read_text())
        frames.extend(j.get("frames", []))
        for k, v in j.items():
            if k != "frames":
                meta.setdefault(k, v)

    scale = float(meta.get("scale", NERF_SCALE))
    offset = np.asarray(meta.get("offset", [0.5, 0.5, 0.5]), np.float32)
    aabb_scale = float(meta.get("aabb_scale", 1))
    if max_images:
        frames = frames[:max_images]

    white_transparent = bool(meta.get("white_transparent", False))
    black_transparent = bool(meta.get("black_transparent", False))
    enable_depth = bool(meta.get("enable_depth_loading", True))
    integer_depth_scale = float(meta.get("integer_depth_scale", 1.0 / 65535.0))

    def load_one(fr):
        p = _resolve_image_path(base, fr["file_path"])
        if p is None:
            return None
        img = load_image(p, as_float_linear=False)  # LDR stays sRGB, EXR linear
        if downscale > 1:
            img = img[::downscale, ::downscale]
        # NSVF's white (or black) = transparent
        if white_transparent or black_transparent:
            rgb = img[..., :3]
            if white_transparent:
                img[..., 3] = np.where((rgb >= 254.5 / 255.0).all(-1), 0.0, img[..., 3])
            if black_transparent:
                img[..., 3] = np.where((rgb <= 0.5 / 255.0).all(-1), 0.0, img[..., 3])
        mask_p = p.parent / f"dynamic_mask_{p.stem}.png"
        if mask_p.exists():
            mask = load_image(mask_p, as_float_linear=False)[::downscale, ::downscale]
            masked = mask[..., 0] > 0.5
            img[..., :3] = np.where(masked[..., None], -1.0, img[..., :3])
            img[..., 3] = np.where(masked, 0.0, img[..., 3])
        depth = None
        if enable_depth and fr.get("depth_path") and (base / fr["depth_path"]).exists():
            d = _read_depth(base / fr["depth_path"])
            if d is not None:
                depth = d.astype(np.float32)[::downscale, ::downscale]
                depth *= integer_depth_scale * scale
        return p, img, depth

    with futures.ThreadPoolExecutor(max_workers=16) as ex:
        loaded = list(ex.map(load_one, frames))

    kept = [(fr, pl) for fr, pl in zip(frames, loaded) if pl is not None]
    if not kept:
        raise FileNotFoundError(f"no images found for {path}")
    frames = [fr for fr, _ in kept]
    paths = [pl[0] for _, pl in kept]
    imgs = [pl[1] for _, pl in kept]
    depth_imgs = [pl[2] for _, pl in kept]
    h = max(im.shape[0] for im in imgs)
    w = max(im.shape[1] for im in imgs)
    images = np.zeros((len(imgs), h, w, 4), np.float32)
    for i, im in enumerate(imgs):
        images[i, : im.shape[0], : im.shape[1]] = im
    depths = None
    if any(d is not None for d in depth_imgs):
        depths = np.zeros((len(imgs), h, w), np.float32)
        for i, d in enumerate(depth_imgs):
            if d is not None:
                depths[i, : d.shape[0], : d.shape[1]] = d
    has_masks = bool((images[..., :3] < 0).any())

    def focal_from(src, axis, res):
        fl_key = "fl_x" if axis == 0 else "fl_y"
        angle_key = "camera_angle_x" if axis == 0 else "camera_angle_y"
        if fl_key in src:
            return float(src[fl_key]) / downscale
        if angle_key in src:
            return 0.5 * res / math.tan(0.5 * float(src[angle_key]))
        return None

    n = len(frames)
    xforms = np.zeros((n, 3, 4), np.float32)
    xforms_end = np.zeros((n, 3, 4), np.float32)
    light_dirs = np.zeros((n, 3), np.float32)
    has_light_dirs = any_end = False
    fls = np.zeros((n, 2), np.float32)
    pps = np.zeros((n, 2), np.float32)
    sharp = np.zeros((n,), np.float32)
    for i, fr in enumerate(frames):
        src = {**meta, **fr}
        m_start = np.asarray(fr.get("transform_matrix_start", fr["transform_matrix"]),
                             np.float32)
        m_end = fr.get("transform_matrix_end")
        any_end = any_end or m_end is not None
        xforms[i] = nerf_matrix_to_ngp(m_start, scale, offset)
        xforms_end[i] = nerf_matrix_to_ngp(
            np.asarray(m_end, np.float32) if m_end is not None else m_start, scale, offset)
        if "driver_parameters" in fr:
            dp_ = fr["driver_parameters"]
            ld = np.asarray([float(dp_.get("LightX", 0.0)), float(dp_.get("LightY", 0.0)),
                             float(dp_.get("LightZ", 0.0))], np.float32)
            nrm = np.linalg.norm(ld)
            if nrm > 0:
                light_dirs[i] = (ld / nrm)[[1, 2, 0]]
                has_light_dirs = True
        fx = focal_from(src, 0, w)
        fy = focal_from(src, 1, h)
        if fx is None and fy is None:
            raise ValueError("dataset specifies no focal length / camera angle")
        fls[i] = (fx if fx is not None else fy, fy if fy is not None else fx)
        pps[i] = (float(src.get("cx", w * downscale / 2)) / downscale / w,
                  float(src.get("cy", h * downscale / 2)) / downscale / h)
        sharp[i] = float(fr.get("sharpness", 1.0))

    lens = Lens()
    if any(k in meta for k in ("k1", "k2", "p1", "p2")):
        params = tuple(float(meta.get(k, 0.0)) for k in ("k1", "k2", "p1", "p2"))
        mode = LensMode.OPENCV_FISHEYE if meta.get("is_fisheye", False) else LensMode.OPENCV
        lens = Lens(mode=mode, params=params)
    elif meta.get("camera_model") == "OPENCV_FISHEYE":
        params = tuple(float(meta.get(k, 0.0)) for k in ("k1", "k2", "k3", "k4"))
        lens = Lens(mode=LensMode.OPENCV_FISHEYE, params=params)

    rs = np.zeros(4, np.float32)
    if "rolling_shutter" in meta:
        v = list(map(float, meta["rolling_shutter"]))
        rs[: min(len(v), 4)] = v[:4]

    envmap = None
    if "envmap" in meta:
        ep = _resolve_image_path(base, str(meta["envmap"]))
        if ep is not None:
            # the envmap holds linear radiance
            envmap = np.asarray(load_image(ep, as_float_linear=True), np.float32)

    return NerfDataset(
        images=images,
        xforms=xforms,
        focal_lengths=fls,
        principal_points=pps,
        resolution=(w, h),
        lens=lens,
        aabb_scale=aabb_scale,
        scale=scale,
        offset=offset,
        is_hdr=paths[0].suffix.lower() == ".exr",
        depths=depths,
        sharpness=sharp,
        # light-dir datasets force the learnable count to 0
        n_extra_learnable_dims=0 if has_light_dirs
        else int(meta.get("n_extra_learnable_dims", 0)),
        paths=paths,
        rolling_shutter=rs,
        xforms_end=xforms_end if (any_end or rs.any()) else None,
        has_masks=has_masks,
        envmap=envmap,
        light_dirs=light_dirs if has_light_dirs else None,
    )
