"""Image loading and saving (port of the JAX package's io/image_io.py).
EXR reads and writes through the port's own codec (io/exr.py), linear as
stored; PNG reads through the port's own decoder (io/png.py), to the
values cv2.imread gives the JAX package; JPG loads through OpenCV, imported
when such an image is read: the package does not need it otherwise, so EXR
and PNG read wherever OpenCV is missing.
Saving LDR images is not ported yet (Slice G of ROADMAP.md)."""

from __future__ import annotations

from pathlib import Path

import numpy as np

from sienerf_torch.io.exr import load_exr_rgba, write_exr
from sienerf_torch.io.png import read_png


def _cv2():
    try:
        import cv2
    except ImportError as e:
        raise ImportError("loading JPG and other non-PNG LDR images needs OpenCV (the "
                          "cv2 module), which is not installed") from e
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


def save_image(path: str | Path, img: np.ndarray) -> None:
    """Save a (H, W, 3|4) float image as a linear half-float EXR."""
    path = Path(path)
    if path.suffix.lower() != ".exr":
        raise NotImplementedError(f"{path}: saving LDR images is not ported yet (Slice G "
                                  "of ROADMAP.md); save as .exr")
    write_exr(path, np.asarray(img, np.float32))
