"""Input encodings besides the hash grid (port of the JAX package's
ops/encodings.py): spherical harmonics (degree <= 4), frequency, one-blob,
triangle wave, identity, and the composite dispatch of tcnn configs.

tcnn's SH encoding takes directions warped into [0,1]^3, (d + 1) / 2; the
same convention is kept so both packages see the same inputs."""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import torch


def sh_encode(dirs_unit_cube: torch.Tensor, degree: int = 4) -> torch.Tensor:
    """(N, 3) directions in [0,1]^3 -> (N, degree^2) SH basis (tcnn's
    polynomial convention, the reference's operation order)."""
    if degree > 5:
        # the JAX package's sh_encode stops at degree 5 while its
        # encoding_output_dim reports degree^2 (ROADMAP.md, caveats)
        raise ValueError(f"SH degree {degree}: the reference basis stops at degree 5")
    d = dirs_unit_cube * 2.0 - 1.0
    x, y, z = d[..., 0], d[..., 1], d[..., 2]
    xy, xz, yz = x * y, x * z, y * z
    x2, y2, z2 = x * x, y * y, z * z
    out = [torch.full_like(x, 0.28209479177387814)]
    if degree >= 2:
        out += [-0.48860251190291987 * y, 0.48860251190291987 * z,
                -0.48860251190291987 * x]
    if degree >= 3:
        out += [
            1.0925484305920792 * xy,
            -1.0925484305920792 * yz,
            0.94617469575755997 * z2 - 0.31539156525251999,
            -1.0925484305920792 * xz,
            0.54627421529603959 * (x2 - y2),
        ]
    if degree >= 4:
        out += [
            0.59004358992664352 * y * (-3.0 * x2 + y2),
            2.8906114426405538 * xy * z,
            0.45704579946446572 * y * (1.0 - 5.0 * z2),
            0.3731763325901154 * z * (5.0 * z2 - 3.0),
            0.45704579946446572 * x * (1.0 - 5.0 * z2),
            1.4453057213202769 * z * (x2 - y2),
            0.59004358992664352 * x * (-x2 + 3.0 * y2),
        ]
    if degree >= 5:
        out += [
            2.5033429417967046 * xy * (x2 - y2),
            1.7701307697799304 * yz * (-3.0 * x2 + y2),
            0.94617469575756008 * xy * (7.0 * z2 - 1.0),
            0.66904654355728921 * yz * (3.0 - 7.0 * z2),
            -3.1735664074561294 * z2 + 3.7024941420321507 * z2 * z2 + 0.31735664074561293,
            0.66904654355728921 * xz * (3.0 - 7.0 * z2),
            0.47308734787878004 * (x2 - y2) * (7.0 * z2 - 1.0),
            1.7701307697799304 * xz * (-x2 + 3.0 * y2),
            0.62583573544917614 * (x2 * (x2 - 3.0 * y2) - y2 * (3.0 * x2 - y2)),
        ]
    return torch.stack(out, dim=-1)


def frequency_encode(x: torch.Tensor, n_frequencies: int) -> torch.Tensor:
    """NeRF-style sin/cos encoding: (N, D) -> (N, D * n_frequencies * 2),
    laid out per frequency as [sin of all dims, cos of all dims]."""
    feats = []
    for f in range(n_frequencies):
        arg = x * (math.pi * (2.0 ** f))
        feats.append(torch.sin(arg))
        feats.append(torch.cos(arg))
    return torch.cat(feats, dim=-1)


def oneblob_encode(x: torch.Tensor, n_bins: int) -> torch.Tensor:
    """One-blob encoding: a gaussian kernel splatted over n_bins per input
    dim on the torus [0,1).  (N, D) -> (N, D * n_bins)."""
    N, D = x.shape
    centers = (torch.arange(n_bins, dtype=torch.float32, device=x.device) + 0.5) / n_bins
    diff = x[..., None] - centers  # (N, D, B)
    diff = diff - torch.round(diff)
    sigma = 1.0 / n_bins
    val = torch.exp(-0.5 * (diff / sigma) ** 2) / (sigma * math.sqrt(2.0 * math.pi))
    return (val / n_bins).reshape(N, D * n_bins)


def trianglewave_encode(x: torch.Tensor, n_frequencies: int) -> torch.Tensor:
    feats = []
    for f in range(n_frequencies):
        arg = x * (2.0 ** f)
        feats.append(2.0 * torch.abs(arg - torch.floor(arg + 0.5)))
    return torch.cat(feats, dim=-1)


@dataclass(frozen=True)
class CompositeSpec:
    """One nested entry of a tcnn Composite encoding."""

    otype: str
    n_dims_to_encode: int | None = None
    params: dict = field(default_factory=dict)


def composite_encode(x: torch.Tensor, specs: list[CompositeSpec]) -> torch.Tensor:
    """Apply encodings to consecutive slices of the input dims; an entry
    without n_dims_to_encode takes the remaining dims (tcnn's rule)."""
    outs = []
    offset = 0
    total = x.shape[-1]
    for spec in specs:
        nd = spec.n_dims_to_encode
        if nd is None:
            nd = total - offset
        xi = x[..., offset:offset + nd]
        offset += nd
        ot = spec.otype.lower()
        if nd == 0:
            continue
        if ot == "sphericalharmonics":
            outs.append(sh_encode(xi, int(spec.params.get("degree", 4))))
        elif ot == "frequency":
            outs.append(frequency_encode(xi, int(spec.params.get("n_frequencies", 12))))
        elif ot == "oneblob":
            outs.append(oneblob_encode(xi, int(spec.params.get("n_bins", 16))))
        elif ot == "trianglewave":
            outs.append(trianglewave_encode(xi, int(spec.params.get("n_frequencies", 12))))
        elif ot == "identity":
            outs.append(xi)
        else:
            raise ValueError(f"unsupported composite encoding otype: {spec.otype}")
    return torch.cat(outs, dim=-1) if outs else x[..., :0]


def composite_specs_from_config(cfg: dict) -> list[CompositeSpec]:
    specs = []
    for entry in cfg.get("nested", []):
        e = dict(entry)
        otype = e.pop("otype")
        nd = e.pop("n_dims_to_encode", None)
        specs.append(CompositeSpec(otype=otype, n_dims_to_encode=nd, params=e))
    return specs


def encoding_output_dim(otype: str, n_dims: int, params: dict) -> int:
    ot = otype.lower()
    if ot == "sphericalharmonics":
        return int(params.get("degree", 4)) ** 2
    if ot == "frequency":
        return n_dims * int(params.get("n_frequencies", 12)) * 2
    if ot == "oneblob":
        return n_dims * int(params.get("n_bins", 16))
    if ot == "trianglewave":
        return n_dims * int(params.get("n_frequencies", 12))
    if ot == "identity":
        return n_dims
    raise ValueError(f"unknown encoding otype {otype}")
