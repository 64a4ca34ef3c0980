"""Disney-style BRDF shading with the fork's ambient (irradiance) term
(port of the JAX package's ops/brdf.py): the sun's colour scaled by the
shadow factor, sky ambient from the up-facing hemisphere, a checkerboard
floor, and the ambient term amb = ambient * mix(0.2, F_V, metallic) * base,
which the irradiance probes feed with light gathered from a NeRF.

Every function works on [..., 3] stacks of f32 tensors."""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from sienerf_torch.utils.device_inputs import constant


@dataclass(frozen=True)
class BRDFParams:
    """The reference's BRDF defaults."""

    metallic: float = 0.0
    subsurface: float = 0.0
    specular: float = 1.0
    roughness: float = 0.5
    sheen: float = 0.0
    clearcoat: float = 0.0
    clearcoat_gloss: float = 1.0
    basecolor: tuple = (0.8, 0.8, 0.8)
    ambientcolor: tuple = (0.0, 0.0, 0.0)


def _dot(a, b):
    return (a * b).sum(dim=-1)


def _schlick_fresnel(u):
    return torch.clamp(1.0 - u, 0.0, 1.0) ** 5


def _g1(ndoth, a: float):
    a2 = a * a
    if a >= 1.0:
        return torch.full_like(ndoth, 1.0 / math.pi)
    t = 1.0 + (a2 - 1.0) * ndoth * ndoth
    return (a2 - 1.0) / (math.pi * math.log(max(a2, 1e-8)) * t)


def _g2(ndoth, a):
    a2 = a * a
    t = 1.0 + (a2 - 1.0) * ndoth * ndoth
    return a2 / (math.pi * t * t)


def _smith_g_ggx(ndotv, alpha_g):
    a = alpha_g * alpha_g
    b = ndotv * ndotv
    return 1.0 / (ndotv + torch.sqrt(torch.clamp(a + b - a * b, min=0.0)))


def evaluate_shading(base_color, ambient_color, light_color, L, V, N, metallic=0.0,
                     subsurface=0.0, specular=1.0, roughness=0.5, specular_tint=0.0,
                     sheen=0.0, sheen_tint=0.0, clearcoat=0.0, clearcoat_gloss=1.0):
    """Shade [..., 3] stacks: base colour, ambient (irradiance) colour,
    light colour (sun x shadow), unit light, view (towards the camera) and
    normal directions -> [..., 3] radiance.  Back-facing or grazing
    (N.L < 0 or N.V < 0): the ambient term alone."""
    ndotl = _dot(N, L)
    ndotv = _dot(N, V)
    H = L + V
    H = H / torch.clamp(torch.sqrt(_dot(H, H))[..., None], min=1e-12)
    ndoth = _dot(N, H)
    ldoth = _dot(L, H)

    fl = _schlick_fresnel(ndotl)
    fv = _schlick_fresnel(ndotv)
    amb = ambient_color * (0.2 + metallic * (fv - 0.2))[..., None] * base_color

    lum_w = constant(np.asarray([0.3, 0.6, 0.1], np.float32), base_color.device).to(
        base_color.dtype)
    lum = (base_color * lum_w).sum(dim=-1, keepdim=True)
    ctint = base_color / (lum + 1e-5)
    one = torch.ones_like(base_color)
    cspec0 = (one + (ctint - one) * specular_tint) * (specular * 0.08)
    cspec0 = cspec0 + (base_color - cspec0) * metallic
    csheen = one + (ctint - one) * sheen_tint

    fd90 = 0.5 + 2.0 * ldoth * ldoth * roughness
    fd = (1.0 + (fd90 - 1.0) * fl) * (1.0 + (fd90 - 1.0) * fv)
    fss90 = ldoth * ldoth * roughness
    fss = (1.0 + (fss90 - 1.0) * fl) * (1.0 + (fss90 - 1.0) * fv)
    denom = torch.clamp(ndotl + ndotv, min=1e-6)
    ss = 1.25 * (fss * (1.0 / denom - 0.5) + 0.5)

    a = max(0.001, roughness * roughness)
    ds = _g2(ndoth, a)
    fh = _schlick_fresnel(ldoth)
    fs = cspec0 + (one - cspec0) * fh[..., None]
    nl = torch.clamp(ndotl, min=1e-6)
    nv = torch.clamp(ndotv, min=1e-6)
    gs = _smith_g_ggx(nl, a) * _smith_g_ggx(nv, a)
    fsheen = fh[..., None] * sheen * csheen

    dr = _g1(ndoth, 0.1 + (0.001 - 0.1) * clearcoat_gloss)
    fr = 0.04 + 0.96 * fh
    gr = _smith_g_ggx(nl, 0.25) * _smith_g_ggx(nv, 0.25)
    ccs = 0.25 * clearcoat * gr * fr * dr

    diffuse_mix = fd + (ss - fd) * subsurface
    brdf = (((1.0 / math.pi) * diffuse_mix[..., None] * base_color + fsheen) * (1.0 - metallic)
            + (gs * ds)[..., None] * fs + ccs[..., None])
    lit = brdf * light_color * torch.clamp(ndotl, min=0.0)[..., None] + amb
    backfacing = (ndotl < 0.0) | (ndotv < 0.0)
    return torch.where(backfacing[..., None], amb, lit)


SUN_COLOR = (255.0 / 255.0 * 4.0, 225.0 / 255.0 * 4.0, 195.0 / 255.0 * 4.0)
SKY_COLOR = (195.0 / 255.0 * 4.0, 215.0 / 255.0 * 4.0, 255.0 / 255.0 * 4.0)


def _color(c, like: torch.Tensor) -> torch.Tensor:
    return constant(np.asarray(c, np.float32), like.device)


def sky_ambient(normal: torch.Tensor, up_dir: torch.Tensor) -> torch.Tensor:
    """SKY_COLOR * (0.5 - N.up / 2)."""
    skyam = -(normal * up_dir).sum(dim=-1) * 0.5 + 0.5
    return _color(SKY_COLOR, normal) * skyam[..., None]


def checkerboard_floor_color(pos: torch.Tensor, aabb_min, aabb_diag_x: float) -> torch.Tensor:
    check_size = 8.0 / aabb_diag_x
    cx = torch.floor(check_size * (pos[..., 0] - float(aabb_min[0]))).to(torch.int32)
    cz = torch.floor(check_size * (pos[..., 2] - float(aabb_min[2]))).to(torch.int32)
    check = torch.where(((cx ^ cz) & 1) == 1, 0.8, 0.2)
    return torch.stack([check ** 3, check ** 2, check], dim=-1)


def soft_shadow_update(min_visibility, prev_distance, total_distance, distance,
                       k: float = 8.0):
    """The soft-shadow accumulator of a sphere-traced shadow ray ->
    (visibility, distance, total distance)."""
    y = distance * distance / (2.0 * torch.clamp(prev_distance, min=1e-20))
    d = torch.sqrt(torch.clamp(distance * distance - y * y, min=0.0))
    vis = k * d / torch.clamp(total_distance - y, min=1e-20)
    return torch.minimum(min_visibility, vis), distance, total_distance + distance
