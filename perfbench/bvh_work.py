"""K3's work on a hybrid frame, counted by the benchmark's own walk: the
box and triangle tests a stackless walk makes over the BVH the program
built, and the bytes no walk can avoid, for K3's roofline (k3_roofline).

The walk is the plain one (nodes in DFS order, skip links, leaves of up
to 4): a box test at every step, against the best t so far; at a leaf
whose box passes, a Moller-Trumbore test of each of its triangles; an
any-hit walk ends at its first hit.  It runs on every STRIDE-th ray of the
frame's three ray sets, as the program sends them, and the counts are
scaled by STRIDE:
- primary: every pixel's unit ray from the camera;
- shadow: from each hit of those rays, 1e-3 off the surface along its
  normal turned to the camera, towards the sun;
- depth-stop: from the camera along each direction of the sweep's
  intermediate image (its axis, flip and gnomonic grid as the program's
  frame reports them).

Operations a test, counted as a lower bound (adds, multiplies, divisions,
min and max; no comparisons, no loads, no address arithmetic):
- BOX_FLOPS = 23: the slab test's 6 subtractions and 6 multiplications by
  the inverse direction, 3 minima and 3 maxima per axis, 2 maxima and 2
  minima across the axes, and the clamp of the entry at 0;
- TRI_FLOPS = 46: two cross products (6 multiplications and 3
  subtractions each), three dot products and the determinant's (3
  multiplications and 2 additions each, 4 of them: 20), the reciprocal of
  the determinant, the 3 subtractions of o - a, the 3 multiplications by
  that reciprocal and u + v.
Compulsory bytes a launch: the rays read (12 bytes of direction, an
origin shared by every ray of the set read once; the shadow set's 1-byte
mask for every pixel and 24 bytes only for the walked rays), the results
written (closest hit: t, u, v and an 8-byte id; any hit: 1 byte), and the
BVH once (per node two 12-byte boxes and three 8-byte fields; per triangle
36 bytes).  Both parts are lower bounds of the work, so the bound is a
lower bound of K3's time and its share of the time cannot pass 100 %.
"""

from __future__ import annotations

import re

import torch

from perfbench.peaks import F32_FLOPS, HBM_BYTES_S

STRIDE = 64
BOX_FLOPS = 23
TRI_FLOPS = 46
_K3 = re.compile(r"\bbvh_walk_kernel\b")  # sienerf_torch/csrc/bvh.cu


def is_k3(name: str) -> bool:
    return bool(_K3.search(name))


@torch.no_grad()
def walk(bvh: dict, o: torch.Tensor, d: torch.Tensor, any_hit: bool = False):
    """Rays (N, 3) (o may be one row) -> (box tests, triangle tests, t (N,)
    inf on a miss, triangle id (N,) -1 on a miss)."""
    N, dev = d.shape[0], d.device
    o = o.expand(N, 3)
    inv = 1.0 / torch.where(d.abs() < 1e-12, torch.where(d < 0, -1e-12, 1e-12), d)
    node = torch.zeros((N,), dtype=torch.int64, device=dev)
    best = torch.full((N,), float("inf"), device=dev)
    best_id = torch.full((N,), -1, dtype=torch.int64, device=dev)
    n_box = n_tri = 0
    leaf = bvh["tri_count"].max().item()
    while True:
        act = torch.nonzero(node >= 0)[:, 0]
        if not act.numel():
            break
        ni = node[act]
        oa, da, ia = o[act], d[act], inv[act]
        t0 = (bvh["bbox_min"][ni] - oa) * ia
        t1 = (bvh["bbox_max"][ni] - oa) * ia
        tmin = torch.minimum(t0, t1).amax(-1)
        tmax = torch.maximum(t0, t1).amin(-1)
        box = (tmax >= torch.clamp(tmin, min=0.0)) & (tmin < best[act])
        cnt = bvh["tri_count"][ni]
        at_leaf = box & (cnt > 0)
        n_box += int(act.numel())
        n_tri += int(cnt[at_leaf].sum())
        found = torch.zeros_like(at_leaf)
        for j in range(leaf):
            test = at_leaf & (j < cnt)
            tid = torch.clamp(bvh["first_tri"][ni] + j, 0, bvh["tri_a"].shape[0] - 1)
            t = _moller_trumbore(oa, da, bvh["tri_a"][tid], bvh["tri_ab"][tid],
                                 bvh["tri_ac"][tid])
            better = test & (t < best[act])
            best[act] = torch.where(better, t, best[act])
            best_id[act] = torch.where(better, tid, best_id[act])
            found |= better
        nxt = torch.where(box & (cnt <= 0), ni + 1, bvh["skip"][ni])
        if any_hit:
            nxt = torch.where(found, -1, nxt)
        node[act] = nxt
    return n_box, n_tri, best, best_id


def _moller_trumbore(o, d, a, ab, ac, eps: float = 1e-9):
    p = torch.linalg.cross(d, ac)
    det = (ab * p).sum(-1)
    ok = det.abs() > eps
    inv = torch.where(ok, 1.0 / torch.where(ok, det, 1.0), 0.0)
    s = o - a
    u = (s * p).sum(-1) * inv
    q = torch.linalg.cross(s, ab)
    v = (d * q).sum(-1) * inv
    t = (ac * q).sum(-1) * inv
    hit = ok & (u >= 0) & (v >= 0) & (u + v <= 1) & (t > eps)
    return torch.where(hit, t, float("inf"))


@torch.no_grad()
def frame_work(geo, cam, focal, width: int, height: int, stride: int = STRIDE) -> dict:
    """The tests and compulsory bytes of K3's three launches in one hybrid
    frame of the engine `geo` -> {"box_tests", "tri_tests", "bytes",
    "rays"}, the tests scaled from every `stride`-th ray."""
    dev = geo.device
    bvh = geo.bvh_dev
    o, d = geo._frame_rays(width, height, cam, focal, dev)
    du = d / torch.sqrt((d * d).sum(-1, keepdim=True))
    n_pix = du.shape[0]
    box_p, tri_p, t, tid = walk(bvh, o[0], du[::stride])
    hit = tid >= 0
    n = geo.tri_normals[torch.clamp(tid, min=0)]
    n = n * torch.where((n * du[::stride]).sum(-1, keepdim=True) > 0, -1.0, 1.0)
    spos = (o[0] + torch.where(hit, t, 0.0)[:, None] * du[::stride] + n * 1e-3)[hit]
    sun = torch.tensor(geo.sun_dir, dtype=torch.float32, device=dev)
    sun = sun / torch.sqrt((sun * sun).sum())
    box_s, tri_s, _, _ = walk(bvh, spos, sun.expand(spos.shape), any_hit=True)
    st = {}
    geo.render_frame(width, height, cam, focal, renderer="sweep", stats=st)
    _, eb, ec, _, _ = st["intermediate"]
    axis, flip = st["axis"], st["flip"]
    hi, wi = eb.shape[0], ec.shape[0]
    b_ax, c_ax = [a for a in (0, 1, 2) if a != axis]
    dw = torch.zeros((hi * wi, 3), device=dev)
    dw[:, axis] = -1.0 if flip else 1.0
    dw[:, b_ax] = eb[:, None].expand(hi, wi).reshape(-1)
    dw[:, c_ax] = ec[None, :].expand(hi, wi).reshape(-1)
    dw = dw / torch.sqrt((dw * dw).sum(-1, keepdim=True))
    box_d, tri_d, _, _ = walk(bvh, o[0], dw[::stride])
    n_hits = int(hit.sum()) * stride
    closest_out = 4 + 8 + 4 + 4
    ray_bytes = (12 + n_pix * (12 + closest_out)          # primary
                 + 12 + n_pix * 2 + n_hits * 24            # shadow: mask, hit, walked rays
                 + 12 + hi * wi * (12 + closest_out))      # depth-stop
    m, n_tris = bvh["skip"].shape[0], bvh["tri_a"].shape[0]
    bvh_bytes = 3 * (m * (24 + 24) + n_tris * 36)
    return {"box_tests": stride * (box_p + box_s + box_d),
            "tri_tests": stride * (tri_p + tri_s + tri_d),
            "bytes": ray_bytes + bvh_bytes,
            "rays": {"primary": n_pix, "shadow_walked": n_hits, "depth": hi * wi}}


def bound_s(work: dict) -> float:
    """The larger of the operations at the F32 rate and the bytes at the
    HBM rate, seconds."""
    flops = work["box_tests"] * BOX_FLOPS + work["tri_tests"] * TRI_FLOPS
    return max(flops / F32_FLOPS, work["bytes"] / HBM_BYTES_S)
