"""Image loading, LDR part (port of the JAX package's io/image_io.py
load_image).  PNG and JPG load through OpenCV, imported when an image is
read: the package does not need it otherwise.  EXR (the JAX package's own
codec) is not ported yet."""

from __future__ import annotations

from pathlib import Path

import numpy as np


def _cv2():
    try:
        import cv2
    except ImportError as e:
        raise ImportError("loading PNG/JPG images needs OpenCV (the cv2 module), "
                          "which is not installed") from e
    return cv2


def load_image(path: str | Path, as_float_linear: bool = True) -> np.ndarray:
    """Load an LDR image as (H, W, 4) float32: bytes / 255 (or / 65535),
    converted sRGB -> linear when `as_float_linear` (alpha stays linear);
    a missing alpha channel is 1."""
    path = Path(path)
    if path.suffix.lower() == ".exr":
        raise NotImplementedError("EXR images are not ported yet (the EXR codec is "
                                  "Slice G of ROADMAP.md)")
    cv2 = _cv2()
    img = cv2.imread(str(path), cv2.IMREAD_UNCHANGED)
    if img is None:
        raise IOError(f"failed to load image {path}")
    if img.ndim == 2:
        img = img[..., None].repeat(3, axis=-1)
    if img.shape[-1] >= 3:
        img = img.copy()
        img[..., :3] = img[..., 2::-1]  # BGR -> RGB
    img = img.astype(np.float32)
    if img.max() > 1.5:  # byte or uint16 input
        img = img / (255.0 if img.max() <= 255.0 else 65535.0)
    if img.shape[-1] == 3:
        img = np.concatenate([img, np.ones_like(img[..., :1])], axis=-1)
    if as_float_linear:
        rgb = img[..., :3]
        img[..., :3] = np.where(rgb <= 0.04045, rgb / 12.92, ((rgb + 0.055) / 1.055) ** 2.4)
    return img
