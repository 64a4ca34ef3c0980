"""Per-element loss functions (port of the JAX package's ops/losses.py).

Selected by the `loss.otype` field of network configs (Huber for NeRF).
Each returns per-element losses; callers reduce.  Relative losses detach
their denominators, so the normaliser is a constant to the gradient.
"""

from __future__ import annotations

import torch


def l2(pred, target):
    d = pred - target
    return d * d


def l1(pred, target):
    return (pred - target).abs()


def huber(pred, target, delta: float = 0.1):
    """tcnn's Huber; NGP's NeRF uses delta 0.1 of the colour scale."""
    d = (pred - target).abs()
    quad = 0.5 * d * d / delta
    lin = d - 0.5 * delta
    return torch.where(d <= delta, quad, lin)


def relative_l2(pred, target, eps: float = 1e-2):
    d = pred - target
    denom = (pred * pred).detach() + eps
    return d * d / denom


def relative_l2_luminance(pred, target, eps: float = 1e-2):
    lum = 0.299 * pred[..., 0:1] + 0.587 * pred[..., 1:2] + 0.114 * pred[..., 2:3]
    denom = (lum * lum).detach() + eps
    d = pred - target
    return d * d / denom


def mape(pred, target, eps: float = 1e-2):
    return (pred - target).abs() / (target.abs().detach() + eps)


def smape(pred, target, eps: float = 1e-2):
    denom = (pred.abs() + target.abs()).detach() + eps
    return 2.0 * (pred - target).abs() / denom


def log_l1(pred, target):
    return torch.log(1.0 + (pred - target).abs())


_LOSSES = {
    "l2": l2,
    "l1": l1,
    "huber": huber,
    "relativel2": relative_l2,
    "relativel2luminance": relative_l2_luminance,
    "mape": mape,
    "smape": smape,
    "logl1": log_l1,
}


def get_loss(otype: str):
    fn = _LOSSES.get(otype.lower())
    if fn is None:
        raise ValueError(f"unknown loss otype {otype}")
    return fn
