"""The plain reference of the mesh shading: the Disney principled BRDF
(Burley 2012, as instant-ngp's `evaluate_shading` writes it) lit by the sun
through a shadow factor, plus the fork's ambient term, and the sun's and
sky's colours.  f32 throughout; it imports nothing of the program.

The ambient (irradiance) term is amb = E * (0.2 + metallic * (F_V - 0.2)) *
base, with E the irradiance the probe grid gives for the normal; a surface
that faces away from the sun or the camera gets the ambient term alone.
"""

from __future__ import annotations

import math

import torch

SUN = (4.0, 225.0 / 255.0 * 4.0, 195.0 / 255.0 * 4.0)  # the sun's colour, 4x (255, 225, 195)
# the BRDF's default parameters (the program's BRDFParams())
PARAMS = dict(metallic=0.0, subsurface=0.0, specular=1.0, roughness=0.5, sheen=0.0,
              clearcoat=0.0, clearcoat_gloss=1.0, specular_tint=0.0, sheen_tint=0.0)
BASE = (0.8, 0.8, 0.8)


def _dot(a, b):
    return (a * b).sum(-1)


def _schlick(x):
    return torch.clamp(1.0 - x, 0.0, 1.0) ** 5


def _gtr1(nh, a: float):
    if a >= 1.0:
        return torch.full_like(nh, 1.0 / math.pi)
    a2 = a * a
    return (a2 - 1.0) / (math.pi * math.log(max(a2, 1e-8)) * (1.0 + (a2 - 1.0) * nh * nh))


def _gtr2(nh, a: float):
    a2 = a * a
    k = 1.0 + (a2 - 1.0) * nh * nh
    return a2 / (math.pi * k * k)


def _smith_ggx(nv, a: float):
    a2, b = a * a, nv * nv
    return 1.0 / (nv + torch.sqrt(torch.clamp(a2 + b - a2 * b, min=0.0)))


def shade(base, ambient, light, L, V, N, metallic=0.0, subsurface=0.0, specular=1.0,
          roughness=0.5, sheen=0.0, clearcoat=0.0, clearcoat_gloss=1.0,
          specular_tint=0.0, sheen_tint=0.0):
    """(..., 3) base colour, irradiance, light (sun x shadow), unit light,
    view and normal directions -> (..., 3) radiance."""
    nl, nv = _dot(N, L), _dot(N, V)
    H = L + V
    H = H / torch.clamp(torch.sqrt(_dot(H, H))[..., None], min=1e-12)
    nh, lh = _dot(N, H), _dot(L, H)
    fl, fv = _schlick(nl), _schlick(nv)
    amb = ambient * (0.2 + metallic * (fv - 0.2))[..., None] * base

    lum = (base * torch.tensor([0.3, 0.6, 0.1], device=base.device)).sum(-1, keepdim=True)
    tint = base / (lum + 1e-5)
    one = torch.ones_like(base)
    spec0 = (one + (tint - one) * specular_tint) * (specular * 0.08)
    spec0 = spec0 + (base - spec0) * metallic
    sheen_c = one + (tint - one) * sheen_tint

    f90 = 0.5 + 2.0 * lh * lh * roughness
    diffuse = (1.0 + (f90 - 1.0) * fl) * (1.0 + (f90 - 1.0) * fv)
    ss90 = lh * lh * roughness
    fss = (1.0 + (ss90 - 1.0) * fl) * (1.0 + (ss90 - 1.0) * fv)
    ss = 1.25 * (fss * (1.0 / torch.clamp(nl + nv, min=1e-6) - 0.5) + 0.5)

    a = max(0.001, roughness * roughness)
    fh = _schlick(lh)
    spec_f = spec0 + (one - spec0) * fh[..., None]
    nl_c, nv_c = torch.clamp(nl, min=1e-6), torch.clamp(nv, min=1e-6)
    spec_g = _smith_ggx(nl_c, a) * _smith_ggx(nv_c, a)
    sheen_f = fh[..., None] * sheen * sheen_c
    coat = 0.25 * clearcoat * (_smith_ggx(nl_c, 0.25) * _smith_ggx(nv_c, 0.25)) \
        * (0.04 + 0.96 * fh) * _gtr1(nh, 0.1 + (0.001 - 0.1) * clearcoat_gloss)

    brdf = (((1.0 / math.pi) * (diffuse + (ss - diffuse) * subsurface)[..., None] * base
             + sheen_f) * (1.0 - metallic) + (spec_g * _gtr2(nh, a))[..., None] * spec_f
            + coat[..., None])
    lit = brdf * light * torch.clamp(nl, min=0.0)[..., None] + amb
    return torch.where(((nl < 0.0) | (nv < 0.0))[..., None], amb, lit)
