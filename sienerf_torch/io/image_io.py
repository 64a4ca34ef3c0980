"""Image loading and saving (port of the JAX package's io/image_io.py).
EXR reads and writes through the port's own codec (io/exr.py), linear as
stored; PNG reads and writes through the port's own codec (io/png.py),
the pixels cv2.imread / cv2.imwrite give the JAX package; other LDR
formats (JPG) go through OpenCV, imported when such an image is read or
written: the package does not need it otherwise, so EXR and PNG work
wherever OpenCV is missing."""

from __future__ import annotations

from pathlib import Path

import numpy as np

from sienerf_torch.io.exr import load_exr_rgba, write_exr
from sienerf_torch.io.png import read_png, write_png


def _cv2():
    try:
        import cv2
    except ImportError as e:
        raise ImportError("reading or writing JPG and other non-PNG LDR images needs "
                          "OpenCV (the cv2 module), which is not installed") from e
    return cv2


def load_image(path: str | Path, as_float_linear: bool = True) -> np.ndarray:
    """Load an image as (H, W, 4) float32.  EXR: linear RGBA as stored
    (a missing alpha is 1).  LDR: bytes / 255 (or / 65535),
    converted sRGB -> linear when `as_float_linear` (alpha stays linear);
    a missing alpha channel is 1."""
    path = Path(path)
    if path.suffix.lower() == ".exr":
        return load_exr_rgba(path)
    if path.suffix.lower() == ".png":
        img = read_png(path)  # RGB order already
    else:
        cv2 = _cv2()
        img = cv2.imread(str(path), cv2.IMREAD_UNCHANGED)
        if img is None:
            raise IOError(f"failed to load image {path}")
        if img.ndim == 3 and img.shape[-1] >= 3:
            img = img.copy()
            img[..., :3] = img[..., 2::-1]  # BGR -> RGB
    if img.ndim == 2:
        img = img[..., None].repeat(3, axis=-1)
    img = img.astype(np.float32)
    if img.max() > 1.5:  # byte or uint16 input
        img = img / (255.0 if img.max() <= 255.0 else 65535.0)
    if img.shape[-1] == 3:
        img = np.concatenate([img, np.ones_like(img[..., :1])], axis=-1)
    if as_float_linear:
        rgb = img[..., :3]
        img[..., :3] = np.where(rgb <= 0.04045, rgb / 12.92, ((rgb + 0.055) / 1.055) ** 2.4)
    return img


def save_image(path: str | Path, img: np.ndarray, input_is_linear: bool = True) -> None:
    """Save a (H, W, 3|4) float image.  EXR: linear half floats as given.
    LDR: colour clipped to [0, 1], sRGB-encoded when `input_is_linear`,
    then bytes round(255 x); alpha (clipped, not encoded) the same way.
    PNG writes RGB or RGBA through io/png.py; other formats through
    OpenCV."""
    path = Path(path)
    img = np.asarray(img, np.float32)
    ext = path.suffix.lower()
    if ext == ".exr":
        write_exr(path, img)
        return
    rgb = np.clip(img[..., :3], 0.0, 1.0)
    if input_is_linear:
        rgb = np.where(rgb <= 0.0031308, 12.92 * rgb,
                       1.055 * np.power(np.maximum(rgb, 1e-8), 1 / 2.4) - 0.055)
    out = (np.clip(rgb, 0, 1) * 255.0 + 0.5).astype(np.uint8)
    if img.shape[-1] == 4:
        a = (np.clip(img[..., 3:4], 0, 1) * 255.0 + 0.5).astype(np.uint8)
        out = np.concatenate([out, a], axis=-1)
    if ext == ".png":
        write_png(path, out)
        return
    bgr = out[..., [2, 1, 0, 3]] if out.shape[-1] == 4 else out[..., ::-1]
    if not _cv2().imwrite(str(path), np.ascontiguousarray(bgr)):
        raise IOError(f"failed to write image {path}")
