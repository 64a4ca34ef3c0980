"""The plain reference of a slab-sweep (shear-warp) frame over a bake.

1. Shade: every lattice vertex decodes its int16 row, runs the colour MLP
   once with its own direction from the camera and stores the
   premultiplied (s*r, s*g, s*b, s) value in bf16.
2. Composite: the sweep axis is the dominant axis of the central view ray;
   every cascade slab, front to back, is resampled (nearest, bf16 weights)
   onto a gnomonic intermediate image and composited in f32, with the spp
   phase blending two planes in bf16.
3. Warp: one bilinear projective warp from the intermediate image to the
   pixels; black background.
4. The spp passes (low-discrepancy subpixel offsets, stratified slab
   phases) are averaged in float64.

The same semantics as the program's sweep renderer, written as plain
PyTorch; it imports nothing of the program.  `composite` can count the
samples that need work and the texels they read, which the K2 roofline
reads as its bound.
"""

from __future__ import annotations

import numpy as np
import torch

from perfbench.reference.field import density_act, mlp, rgb_act, sh4

E_MAX = 16.0
NEAR = 0.1              # the training near plane, which frames render from
MIN_TRANSMITTANCE = 0.01
PLANE_CHUNK = 16


def shade(rows, scale, cam_origin, rgb_w, resolution: int, n_cascades: int,
          precision: str = "bf16") -> torch.Tensor:
    """(K*(R+1)^3, 16) int16 rows -> (K, R+1, R+1, R+1, 4) bf16 volume."""
    R, K = resolution, n_cascades
    Rv = R + 1
    dev = rows.device
    planes = rows.reshape(K * Rv, Rv * Rv, rows.shape[-1])
    jj = (torch.arange(Rv * Rv, device=dev) // Rv).float()
    kk = (torch.arange(Rv * Rv, device=dev) % Rv).float()
    out = torch.empty((K * Rv, Rv * Rv, 4), dtype=torch.bfloat16, device=dev)
    for p0 in range(0, K * Rv, PLANE_CHUNK):
        n = min(PLANE_CHUNK, K * Rv - p0)
        r = planes[p0:p0 + n].reshape(n * Rv * Rv, -1)
        plane = torch.arange(p0, p0 + n, device=dev)
        casc = (plane // Rv).repeat_interleave(Rv * Rv)
        ip = (plane % Rv).repeat_interleave(Rv * Rv).float()
        side = torch.exp2(casc.float())
        lo = 0.5 - 0.5 * side
        pos = torch.stack([ip, jj.repeat(n), kk.repeat(n)], dim=-1) / R * side[:, None] \
            + lo[:, None]
        sent = r[:, 0] == -32768
        raw = r.float() * scale[casc]
        dens = torch.where(sent, 0.0, density_act(raw[:, 0]))
        d = pos - cam_origin
        d = d / torch.clamp(torch.sqrt((d * d).sum(-1, keepdim=True)), min=1e-6)
        rgb = rgb_act(mlp(rgb_w, torch.cat([sh4((d + 1.0) * 0.5), raw], dim=-1), precision))
        rgba = torch.cat([rgb * dens[:, None], dens[:, None]], dim=-1)
        out[p0:p0 + n] = rgba.to(torch.bfloat16).reshape(n, Rv * Rv, 4)
    return out.reshape(K, Rv, Rv, Rv, 4)


def slab_schedule(n_cascades: int, resolution: int):
    """Front-to-back (cascade, slab, world x, pitch, inner) over all cascades;
    an inner slab's central square belongs to the cascade below."""
    K, R = n_cascades, resolution
    ent = []
    for m in range(K):
        side = 2.0 ** m
        lo = 0.5 - 0.5 * side
        p = side / R
        for j in range(R):
            x = lo + j * p
            ent.append((m, j, np.float32(x), np.float32(p), m > 0 and abs(x - 0.5) < 2.0 ** (m - 2)))
    order = np.argsort(np.asarray([e[2] for e in ent], np.float32), kind="stable")
    return [ent[i] for i in order]


def _nearest(targets: torch.Tensor, n_src: int) -> torch.Tensor:
    src = torch.arange(n_src, dtype=torch.float32, device=targets.device)
    d = targets[:, None] - src[None, :]
    w = ((d > -0.5) & (d <= 0.5)).float()
    inb = (targets >= 0.0) & (targets <= n_src - 1)
    return torch.where(inb[:, None], w, 0.0)


def composite(oriented, o_c, eb, ec, phase, resolution: int, n_cascades: int,
              stats: dict | None = None):
    """oriented (K, R+1, 4, R+1, R+1) bf16 slab-major volume -> (rgb (Hi, Wi,
    3), opacity, T, depth).  With `stats`, "samples" counts the samples that
    need work and "texels" the distinct texels they read."""
    R = resolution
    Rv = R + 1
    dev = oriented.device
    Hi, Wi = eb.shape[0], ec.shape[0]
    L = torch.sqrt(1.0 + eb[:, None] ** 2 + ec[None, :] ** 2)
    ii = torch.arange(Rv, device=dev)
    band = (ii > R // 4) & (ii < 3 * R // 4)
    inner_sq = band[:, None] & band[None, :]
    phase_t = torch.tensor(float(phase), dtype=torch.float32, device=dev)
    ph = phase_t.to(torch.bfloat16)
    live = (oriented[:, :, 3] > 0).flatten(2).any(dim=2)
    live = (live | torch.cat([live[:, 1:], live[:, -1:]], dim=1)).cpu().numpy()
    C = torch.zeros((3, Hi, Wi), dtype=torch.float32, device=dev)
    T = torch.ones((Hi, Wi), dtype=torch.float32, device=dev)
    op = torch.zeros((Hi, Wi), dtype=torch.float32, device=dev)
    bw = torch.zeros((Hi, Wi), dtype=torch.float32, device=dev)
    bt = torch.zeros((Hi, Wi), dtype=torch.float32, device=dev)
    if stats is not None:
        touched = torch.zeros((n_cascades, Rv, Rv * Rv + 1), dtype=torch.uint8, device=dev)
        samples = torch.zeros((), dtype=torch.int64, device=dev)
    for m, j, x, pitch, inner in slab_schedule(n_cascades, R):
        if not live[m, j]:
            continue
        x = torch.tensor(x, device=dev)
        pitch = torch.tensor(pitch, device=dev)
        slab = oriented[m, j] * (1 - ph) + oriented[m, min(j + 1, Rv - 1)] * ph
        x = x + phase_t * pitch
        if inner:
            slab = torch.where(inner_sq[None], torch.zeros((), dtype=slab.dtype, device=dev),
                               slab)
        x_rel = x - o_c[0]
        lo = 0.5 - 0.5 * pitch * R
        gu = (o_c[1] + x_rel * eb - lo) / pitch
        gv = (o_c[2] + x_rel * ec - lo) / pitch
        A = _nearest(gu, Rv).to(torch.bfloat16).float()
        B = _nearest(gv, Rv).to(torch.bfloat16).float()
        t1 = A @ slab.float().permute(1, 0, 2).reshape(Rv, 4 * Rv)
        t1 = t1.reshape(Hi, 4, Rv).to(torch.bfloat16).float()
        s = (t1.permute(1, 0, 2).reshape(4 * Hi, Rv) @ B.T).reshape(4, Hi, Wi)
        t_hat = x_rel * L
        dt = pitch * L
        sigma = torch.clamp(s[3], min=0.0)
        rgb = s[:3] / torch.clamp(sigma, min=1e-10)[None]
        alive = (T >= MIN_TRANSMITTANCE) & (t_hat >= NEAR)
        if stats is not None:
            need = alive & ((gu >= 0) & (gu <= R))[:, None] & ((gv >= 0) & (gv <= R))[None, :]
            u, v = torch.ceil(gu - 0.5).long(), torch.ceil(gv - 0.5).long()
            need = need & (u <= R)[:, None] & (v <= R)[None, :]
            u, v = u.clamp(0, R), v.clamp(0, R)
            if inner:
                need = need & ~inner_sq[u][:, v]
            flat = torch.where(need, u[:, None] * Rv + v[None, :], Rv * Rv).flatten()
            touched[m, j, flat] = 1
            touched[m, min(j + 1, R), flat] = 1
            samples += need.sum()
        alpha = torch.where(alive, 1.0 - torch.exp(-sigma * dt), 0.0)
        w = T * alpha
        better = w > bw
        C = C + w[None] * rgb
        T = T * (1.0 - alpha)
        op = op + w
        bw = torch.where(better, w, bw)
        bt = torch.where(better, t_hat, bt)
    if stats is not None:
        stats["samples"] = stats.get("samples", 0) + int(samples)
        stats["texels"] = stats.get("texels", 0) + int(touched[..., :-1].sum())
    return C.permute(1, 2, 0), op, T, bt


def halton(index: int, base: int) -> np.float32:
    """Radical inverse of `index` in `base`, accumulated in f32 digit by
    digit."""
    n_digits = int(np.ceil(np.log(2 ** 31) / np.log(base)))
    result, f, i = np.float32(0.0), 1.0, int(index)
    for _ in range(n_digits):
        f = f / base
        result = np.float32(result + np.float32(f) * np.float32(i % base))
        i //= base
    return result


def pass_offset(i: int) -> tuple:
    """Pass i's subpixel offset in [0, 1)^2."""
    h = np.asarray([halton(i + 1, 2), halton(i + 1, 3)], np.float32) % np.float32(1.0)
    return float(h[0]), float(h[1])


def geometry(cam, focal, width: int, height: int, offset, device, margin: float = 1.15):
    """The frame's rays and its gnomonic intermediate grid."""
    cam = np.asarray(cam, np.float32)
    fl = np.asarray(focal, np.float32)
    d0 = cam[:3, :3] @ np.asarray([0.0, 0.0, 1.0], np.float32)
    axis = int(np.argmax(np.abs(d0)))
    flip = bool(d0[axis] < 0)
    hi = -(-int(margin * height) // 128) * 128
    wi = -(-int(margin * width) // 128) * 128
    n = width * height
    ids = torch.arange(n, device=device)
    px, py = (ids % width).float(), (ids // width).float()
    x = ((px + offset[0]) / width - 0.5) * float(width) / float(fl[0])
    y = ((py + offset[1]) / height - 0.5) * float(height) / float(fl[1])
    dc = torch.stack([x, y, torch.ones_like(x)], dim=-1)
    rot = torch.as_tensor(cam[:, :3], device=device)
    d = torch.stack([rot[r, 0] * dc[:, 0] + rot[r, 1] * dc[:, 1] + rot[r, 2] * dc[:, 2]
                     for r in range(3)], dim=-1)
    o = torch.as_tensor(cam[:, 3], device=device)
    d_n = d / torch.sqrt((d * d).sum(-1, keepdim=True))
    b, c = [a for a in (0, 1, 2) if a != axis]

    def canon(v, point):
        a = v[..., axis]
        if flip:
            a = (1.0 - a) if point else -a
        return torch.stack([a, v[..., b], v[..., c]], dim=-1)

    o_c, d_c = canon(o, True), canon(d_n, False)
    e_raw = d_c[:, 1:] / torch.clamp(d_c[:, 0:1], min=1e-3)
    good = (d_c[:, 0] > 1e-3) & (e_raw.abs() <= E_MAX).all(dim=-1)
    e_ok = torch.where(good[:, None], e_raw.clamp(-E_MAX, E_MAX), 0.0)
    elo = torch.where(good[:, None], e_ok, 1e9).amin(dim=0)
    ehi = torch.where(good[:, None], e_ok, -1e9).amax(dim=0)
    span = torch.clamp(ehi - elo, min=1e-3)
    deb, dec = span[0] / (hi - 2), span[1] / (wi - 2)
    eb = elo[0] + (torch.arange(hi, device=device, dtype=torch.float32) - 0.5) * deb
    ec = elo[1] + (torch.arange(wi, device=device, dtype=torch.float32) - 0.5) * dec
    return dict(axis=axis, flip=flip, o=o, o_c=o_c, e_px=e_raw.clamp(-E_MAX, E_MAX),
                good=good, eb=eb, ec=ec, deb=deb, dec=dec, b=b, c=c)


def orient(vol: torch.Tensor, g: dict) -> torch.Tensor:
    """(K, X, Y, Z, 4) -> (K, S_a, 4, S_b, S_c), ascending along the sweep."""
    o = vol.permute(0, 1 + g["axis"], 4, 1 + g["b"], 1 + g["c"])
    return o.flip(1) if g["flip"] else o


def warp(maps: torch.Tensor, g: dict) -> torch.Tensor:
    """Bilinear sample of the (Hi, Wi, C) maps at each pixel -> (N, C)."""
    Hi, Wi, C = maps.shape
    fi = ((g["e_px"][:, 0] - g["eb"][0]) / g["deb"]).clamp(0.0, Hi - 1.0)
    fj = ((g["e_px"][:, 1] - g["ec"][0]) / g["dec"]).clamp(0.0, Wi - 1.0)
    i0 = torch.clamp(torch.floor(fi).to(torch.int64), max=Hi - 2)
    j0 = torch.clamp(torch.floor(fj).to(torch.int64), max=Wi - 2)
    wu = (fi - i0.float())[:, None]
    wv = (fj - j0.float())[:, None]
    flat = maps.reshape(Hi * Wi, C)
    base = i0 * Wi + j0
    return (flat[base] * (1 - wu) * (1 - wv) + flat[base + 1] * (1 - wu) * wv
            + flat[base + Wi] * wu * (1 - wv) + flat[base + Wi + 1] * wu * wv)


def render(rows, scale, rgb_w, cam, focal, width: int, height: int, spp: int,
           resolution: int, n_cascades: int, precision: str = "bf16",
           stats: list | None = None) -> torch.Tensor:
    """One frame -> (H, W, 4) f32 rgba, the spp passes averaged in float64.
    With `stats` (a list), each pass's composite counts are appended."""
    dev = rows.device
    origin = torch.as_tensor(np.asarray(cam, np.float32)[:, 3], device=dev)
    vol = shade(rows, scale, origin, rgb_w, resolution, n_cascades, precision)
    acc = None
    for i in range(spp):
        g = geometry(cam, focal, width, height, pass_offset(i), dev)
        st = {} if stats is not None else None
        C, op, _, _ = composite(orient(vol, g), g["o_c"], g["eb"], g["ec"],
                                np.float32((i + 0.5) / spp), resolution, n_cascades, st)
        if stats is not None:
            stats.append(dict(st, axis=g["axis"]))
        out = warp(torch.cat([C, op[..., None]], dim=-1), g)
        good = g["good"]
        rgb = torch.where(good[:, None], out[:, :3], 0.0)
        a = torch.where(good, out[:, 3].clamp(0.0, 1.0), 0.0)
        rgba = torch.cat([rgb, a[:, None]], dim=-1).double()
        acc = rgba if acc is None else acc + rgba
    return (acc / spp).float().reshape(height, width, 4)
