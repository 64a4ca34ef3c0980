"""Shear-warp slab-sweep primitives (port of the JAX package's ops/sweep.py).

For a pinhole at o, the ray through the intermediate pixel with gnomonic
coordinate e = d_{bc} / d_a crosses the plane x_a = x at
(u, v) = o_{bc} + (x - o_a) * e: a per-slab uniform scale of a fixed e-grid.
So every lattice plane of every cascade resamples onto one intermediate
image with a separable in-plane interpolation, the planes composite front
to back, and one projective warp maps the intermediate image to pixels.

`sweep_composite` here is the plain PyTorch version of the CUDA sweep
kernel (ops/sweep_kernel.py).  It repeats the reference's roundings: bf16
interpolation weights, f32 accumulation, a bf16 round of the row pass.

Coordinate canon: the sweep axis is axis 0 ascending with every ray's
d_a > 0 (a = argmax |forward|; a flip x -> 1-x keeps the cascade cubes,
centred at 0.5, in place).
"""

from __future__ import annotations

import numpy as np
import torch


def slab_schedule(n_cascades: int, resolution: int):
    """Static front-to-back slab schedule over all cascades -> numpy (S,)
    arrays: cascade, slab index j, world x, pitch, inner-mask flag.  A
    cascade-m slab with |x - 0.5| < side(m-1)/2 has its central vertex
    square owned by cascade m-1.  Sample planes are j = 0..R-1."""
    K, R = n_cascades, resolution
    casc, slab, xs, pitch, inner = [], [], [], [], []
    for m in range(K):
        side = 2.0 ** m
        lo = 0.5 - 0.5 * side
        p = side / R
        for j in range(R):
            x = lo + j * p
            casc.append(m)
            slab.append(j)
            xs.append(x)
            pitch.append(p)
            inner.append(m > 0 and abs(x - 0.5) < 2.0 ** (m - 2))
    order = np.argsort(np.asarray(xs), kind="stable")
    return (
        np.asarray(casc, np.int32)[order],
        np.asarray(slab, np.int32)[order],
        np.asarray(xs, np.float32)[order],
        np.asarray(pitch, np.float32)[order],
        np.asarray(inner, np.bool_)[order],
    )


def _clip_interval(a, b, lo, hi, jl, jh):
    """Intersect [jl, jh] with the j for which lo <= a + b*j <= hi, widened
    by one slab on either side -> (jl, jh, some); f64 tensors."""
    flat = b == 0
    safe = torch.where(flat, torch.ones_like(b), b)
    t1, t2 = (lo - a) / safe, (hi - a) / safe
    jl2 = torch.maximum(jl, torch.ceil(torch.minimum(t1, t2)) - 1.0)
    jh2 = torch.minimum(jh, torch.floor(torch.maximum(t1, t2)) + 1.0)
    jl = torch.where(flat, jl, jl2)
    jh = torch.where(flat, jh, jh2)
    some = torch.where(flat, (a >= lo) & (a <= hi), jl <= jh)
    return jl, jh, some


@torch.no_grad()
def slab_intervals(o_c, eb, ec, near, t_stop=None, phase=None, *,
                   resolution: int, n_cascades: int):
    """Per cascade and intermediate pixel, the interval [ja, jb) of slab
    indices outside which no sample can be live -> two (K, Hi, Wi) int32
    tensors (ja = R, jb = 0 where no slab can be).

    Within a cascade gu, gv and t_hat are affine in the slab index j, so
    the slabs with 0 <= gu, gv <= R and near <= t_hat <= t_stop form one
    interval.  It is computed in f64 with a margin that covers the f32
    evaluation error of the composite's own tests and widened by one slab,
    so it is a superset: the composite restricted to it equals the full
    loop bit for bit.  Plain version of the intervals of the CUDA sweep
    kernel (csrc/sweep.cu), which walks only these slabs."""
    R, K = resolution, n_cascades
    f64 = torch.float64
    eb, ec = eb.float(), ec.float()
    L = torch.sqrt(1.0 + eb[:, None] ** 2 + ec[None, :] ** 2).to(f64)
    o0, o1, o2 = (o_c.float()[i].to(f64) for i in range(3))
    es = (eb.to(f64)[:, None].expand_as(L), ec.to(f64)[None, :].expand_as(L))
    stop = torch.full_like(L, float("inf")) if t_stop is None else t_stop.float().to(f64)
    ph = 0.0 if phase is None else float(np.float32(phase))
    near = float(np.float32(near))
    eps = 32.0 / 16777216.0
    ja, jb = [], []
    for m in range(K):
        pitch = float(np.float32(2.0 ** m / R))
        side = pitch * R
        lo = 0.5 - 0.5 * side
        xs = lo + ph * pitch - o0  # x_rel at j = 0
        xmax = 2.0 * side + 1.0 + o0.abs()
        jl = torch.zeros_like(L)
        jh = torch.full_like(L, R - 1.0)
        some = torch.ones_like(L, dtype=torch.bool)
        for e, o in zip(es, (o1, o2)):
            d = eps * (o.abs() + abs(lo) + xmax * e.abs() + 1.0) / pitch
            jl, jh, ok = _clip_interval((o + xs * e - lo) / pitch, e, -d, R + d, jl, jh)
            some &= ok
        dt = eps * xmax * L
        jl, jh, ok = _clip_interval(xs * L, pitch * L, near - dt, stop + dt, jl, jh)
        some &= ok & (jl <= jh)
        ja.append(torch.where(some, jl, float(R)).to(torch.int32))
        jb.append(torch.where(some, jh + 1.0, 0.0).to(torch.int32))
    return torch.stack(ja), torch.stack(jb)


def orient_grid(grid5: torch.Tensor, axis: int, flip: bool) -> torch.Tensor:
    """(K, X, Y, Z, C) volume -> (K, S_a, C, S_b, S_c) slab-major view for
    the sweep along `axis`, ascending after an optional flip; b < c are the
    other two axes."""
    b, c = [ax for ax in (0, 1, 2) if ax != axis]
    g = grid5.permute(0, 1 + axis, 4, 1 + b, 1 + c)
    return g.flip(1) if flip else g


def canon_coords(vec3: torch.Tensor, axis: int, flip: bool, is_point: bool):
    """World vector/point -> canonical sweep coords (a, b, c).  Points flip
    about the cascade centre (x -> 1-x); directions negate."""
    b, c = [ax for ax in (0, 1, 2) if ax != axis]
    a = vec3[..., axis]
    if flip:
        a = (1.0 - a) if is_point else -a
    return torch.stack([a, vec3[..., b], vec3[..., c]], dim=-1)


def _interp_matrix(targets: torch.Tensor, n_src: int,
                   interp: str = "bilinear") -> torch.Tensor:
    """(M,) continuous source coordinates -> (M, n_src) f32 weights.  Rows
    whose coordinate lies outside [0, n_src-1] are zero.  'nearest' is
    one-hot, rounding half down: (d > -0.5) & (d <= 0.5)."""
    src = torch.arange(n_src, dtype=torch.float32, device=targets.device)
    d = targets[:, None] - src[None, :]
    if interp == "nearest":
        w = ((d > -0.5) & (d <= 0.5)).float()
    else:
        w = torch.clamp(1.0 - d.abs(), min=0.0)
    inb = (targets >= 0.0) & (targets <= n_src - 1)
    return torch.where(inb[:, None], w, 0.0)


def _composite_over(oriented, o_c, eb, ec, near, min_transmittance,
                    resolution: int, n_cascades: int, interp: str = "nearest",
                    t_stop=None, phase=None, stats: dict | None = None,
                    intervals=None, schedule=None, return_bw: bool = False):
    """Front-to-back composite of every slab of slab_schedule onto the
    intermediate image -> (rgb (Hi, Wi, 3), opacity, T, depth_t (Hi, Wi)),
    and the best weight (Hi, Wi) last with `return_bw`.  `schedule` =
    (s0, s1) composites only the schedule's entries [s0, s1), from T = 1
    (a rank's share of sweep_composite_sharded).

    With `phase` (spp jitter in [0, 1)) the sample plane moves to
    x + phase*pitch and its value blends planes j and j+1 in bf16.  With a
    `stats` dict, stats["samples"] counts the samples that need work (alive,
    inside the lattice, and in nearest mode not on a zeroed inner-square
    texel) and stats["texels"] the distinct (cascade, plane, u, v) texels
    those samples read, both as device tensors.  Slabs whose sigma is zero
    everywhere are counted as neither: no sample there needs work.  With
    `intervals` (slab_intervals' result) a sample outside its pixel's
    interval is dropped before any test, as the CUDA kernel drops it."""
    R = resolution
    Rv = R + 1
    dev = oriented.device
    Hi, Wi = eb.shape[0], ec.shape[0]
    L = torch.sqrt(1.0 + eb[:, None] ** 2 + ec[None, :] ** 2)
    ii = torch.arange(Rv, device=dev)
    band = (ii > R // 4) & (ii < 3 * R // 4)
    inner_sq = band[:, None] & band[None, :]
    ph = None
    if phase is not None:
        # f32 first, then bf16, as the reference rounds its f32 phase
        phase = torch.tensor(float(phase), dtype=torch.float32, device=dev)
        ph = phase.to(torch.bfloat16)
    # a slab whose sigma is zero everywhere adds nothing: skip it (one sync)
    live = (oriented[:, :, 3] > 0).flatten(2).any(dim=2)
    if ph is not None:
        live = live | torch.cat([live[:, 1:], live[:, -1:]], dim=1)
    live = live.cpu().numpy()

    C = torch.zeros((3, Hi, Wi), dtype=torch.float32, device=dev)
    T = torch.ones((Hi, Wi), dtype=torch.float32, device=dev)
    op = torch.zeros((Hi, Wi), dtype=torch.float32, device=dev)
    bw = torch.zeros((Hi, Wi), dtype=torch.float32, device=dev)
    bt = torch.zeros((Hi, Wi), dtype=torch.float32, device=dev)
    if stats is not None:
        # one flag per texel of each (cascade, plane), plus a last slot that
        # takes the writes of samples that read nothing
        touched = torch.zeros((n_cascades, Rv, Rv * Rv + 1), dtype=torch.uint8, device=dev)
    entries = list(zip(*slab_schedule(n_cascades, R)))
    if schedule is not None:
        entries = entries[schedule[0]:schedule[1]]
    for m, j, x, pitch, inner in entries:
        m, j = int(m), int(j)
        if not live[m, j]:
            continue
        x = torch.tensor(x, device=dev)
        pitch = torch.tensor(pitch, device=dev)
        slab = oriented[m, j]  # (4, Rv, Rv) bf16
        if ph is not None:
            slab2 = oriented[m, min(j + 1, Rv - 1)]
            slab = slab * (1 - ph) + slab2 * ph
            x = x + phase * pitch
        if inner:
            slab = torch.where(inner_sq[None], torch.zeros((), dtype=slab.dtype, device=dev), slab)
        x_rel = x - o_c[0]
        lo = 0.5 - 0.5 * pitch * R
        gu = (o_c[1] + x_rel * eb - lo) / pitch
        gv = (o_c[2] + x_rel * ec - lo) / pitch
        A = _interp_matrix(gu, Rv, interp).to(torch.bfloat16).float()
        B = _interp_matrix(gv, Rv, interp).to(torch.bfloat16).float()
        t1 = A @ slab.float().permute(1, 0, 2).reshape(Rv, 4 * Rv)
        t1 = t1.reshape(Hi, 4, Rv).to(torch.bfloat16).float()
        s = (t1.permute(1, 0, 2).reshape(4 * Hi, Rv) @ B.T).reshape(4, Hi, Wi)
        t_hat = x_rel * L
        dt = pitch * L

        sigma = torch.clamp(s[3], min=0.0)
        rgb = s[:3] / torch.clamp(sigma, min=1e-10)[None]
        alive = (T >= min_transmittance) & (t_hat >= near)
        if t_stop is not None:
            alive = alive & (t_hat <= t_stop)
        if intervals is not None:
            alive = alive & (intervals[0][m] <= j) & (j < intervals[1][m])
        if stats is not None:
            need = alive & ((gu >= 0) & (gu <= R))[:, None] & ((gv >= 0) & (gv <= R))[None, :]
            if interp == "nearest":
                corners = [(torch.ceil(gu - 0.5).long(), torch.ceil(gv - 0.5).long())]
            else:
                u0, v0 = torch.floor(gu).long(), torch.floor(gv).long()
                corners = [(u0 + du, v0 + dv) for du in (0, 1) for dv in (0, 1)]
            planes = (j, min(j + 1, R)) if ph is not None else (j,)
            for k, (u, v) in enumerate(corners):
                read = need & (u <= R)[:, None] & (v <= R)[None, :]
                u, v = u.clamp(0, R), v.clamp(0, R)
                if inner:
                    read = read & ~inner_sq[u][:, v]
                if k == 0 and interp == "nearest":
                    need = read
                flat = torch.where(read, u[:, None] * Rv + v[None, :], Rv * Rv)
                for plane in planes:
                    touched[m, plane, flat.flatten()] = 1
            stats["samples"] = stats.get("samples", 0) + need.sum()
        alpha = torch.where(alive, 1.0 - torch.exp(-sigma * dt), 0.0)
        w = T * alpha
        better = w > bw
        C = C + w[None] * rgb
        T = T * (1.0 - alpha)
        op = op + w
        bw = torch.where(better, w, bw)
        bt = torch.where(better, t_hat, bt)
    if stats is not None:
        stats["texels"] = stats.get("texels", 0) + touched[..., :-1].sum()
    out = (C.permute(1, 2, 0), op, T, bt)
    return out + (bw,) if return_bw else out


@torch.no_grad()
def sweep_composite(oriented, o_c, eb, ec, near, min_transmittance,
                    t_stop=None, phase=None, *, resolution: int,
                    n_cascades: int, interp: str = "nearest", stats: dict | None = None,
                    intervals=None, schedule=None, return_bw: bool = False):
    """Plain single-device sweep over an oriented (K, R+1, 4, R+1, R+1) bf16
    volume ([s*r, s*g, s*b, s]) -> (rgb (Hi, Wi, 3), opacity, T, depth_t),
    and the best weight with `return_bw`; `schedule` = (s0, s1) composites
    the schedule's entries [s0, s1) only, from T = 1."""
    return _composite_over(oriented, o_c, eb, ec, near, min_transmittance,
                           resolution, n_cascades, interp=interp,
                           t_stop=t_stop, phase=phase, stats=stats,
                           intervals=intervals, schedule=schedule, return_bw=return_bw)


def fold_partials(parts):
    """The partial composites of consecutive schedule ranges, each from
    T = 1, as (C, op, T, bw, bt) in schedule order -> one composite
    (C, op, T, bt), as the JAX package folds its devices' partials: each
    range is seen through the transmittance of the ranges before it
    (C += T C_i, op += T op_i, T *= T_i), and the depth is that of the best
    weight rescaled by the same transmittance.  The over operator is
    associative, so at min transmittance 0 the fold is the whole sweep up
    to float rounding; above 0 each range cuts at its own T."""
    C0, op0, T0, bw0, bt0 = parts[0]
    C = torch.zeros_like(C0)
    op = torch.zeros_like(op0)
    T = torch.ones_like(T0)
    bw = torch.zeros_like(bw0)
    bt = torch.zeros_like(bt0)
    for C_i, op_i, T_i, bw_i, bt_i in parts:
        cand = T * bw_i
        better = cand > bw
        bw = torch.where(better, cand, bw)
        bt = torch.where(better, bt_i, bt)
        C = C + T[..., None] * C_i
        op = op + T * op_i
        T = T * T_i
    return C, op, T, bt


def warp_to_pixels(maps: torch.Tensor, e_px: torch.Tensor,
                   eb0, deb, ec0, dec) -> torch.Tensor:
    """Final projective warp: bilinear sample of the intermediate maps
    (Hi, Wi, C) at each pixel's gnomonic coordinate (N, 2) -> (N, C)."""
    Hi, Wi, C = maps.shape
    fi = ((e_px[:, 0] - eb0) / deb).clamp(0.0, Hi - 1.0)
    fj = ((e_px[:, 1] - ec0) / dec).clamp(0.0, Wi - 1.0)
    i0 = torch.clamp(torch.floor(fi).to(torch.int64), max=Hi - 2)
    j0 = torch.clamp(torch.floor(fj).to(torch.int64), max=Wi - 2)
    wu = (fi - i0.float())[:, None]
    wv = (fj - j0.float())[:, None]
    flat = maps.reshape(Hi * Wi, C)
    base = i0 * Wi + j0
    r00 = flat[base]
    r01 = flat[base + 1]
    r10 = flat[base + Wi]
    r11 = flat[base + Wi + 1]
    return (r00 * (1 - wu) * (1 - wv) + r01 * (1 - wu) * wv
            + r10 * wu * (1 - wv) + r11 * wu * wv)
