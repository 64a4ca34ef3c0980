"""The plain reference of a scene's meshes: its own .obj reader, the scene
graph's placement, and closest hits by brute force.

- `read_obj`: "v" and "f" lines, polygons fanned into triangles, 1-based
  or negative indices -> (T, 3, 3) f32.
- `place`: the scene graph's rule: the mesh scaled isotropically so that
  its largest extent is 1, its box centre moved to 0.5, then scaled by
  the entry's "scale" about 0.5 and moved by its "center" (numpy f32, in
  that order).
- `Meshes.closest_hit`: every ray against every triangle of each block of
  triangles whose box the ray meets.  A mesh's triangles are sorted along
  a Morton curve of their centroids and cut into blocks of BLOCK; a ray
  is tested against a block only if it meets the block's box nearer than
  its best hit so far.  The test is Moller-Trumbore; the nearest hit wins.

Written from the scene format's documented semantics; it imports nothing
of the program.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

BLOCK = 256             # triangles a block
RAY_CHUNK = 1 << 15     # rays tested against one block at a time
EPS = 1e-9


def read_obj(path: str | Path) -> np.ndarray:
    verts, tris = [], []
    for line in Path(path).read_text().splitlines():
        parts = line.split()
        if not parts:
            continue
        if parts[0] == "v":
            verts.append([float(x) for x in parts[1:4]])
        elif parts[0] == "f":
            ids = []
            for tok in parts[1:]:
                i = int(tok.split("/")[0])
                ids.append(i - 1 if i > 0 else len(verts) + i)
            tris += [(ids[0], ids[k], ids[k + 1]) for k in range(1, len(ids) - 1)]
    return np.asarray(verts, np.float32)[np.asarray(tris, np.int64)]


def place(tri: np.ndarray, center, scale: float) -> np.ndarray:
    tri = np.asarray(tri, np.float32)
    flat = tri.reshape(-1, 3)
    lo, hi = flat.min(axis=0), flat.max(axis=0)
    size = float((hi - lo).max())
    unit = (tri - 0.5 * (lo + hi)) * (1.0 / (size if size > 0 else 1.0)) + 0.5
    return (unit - 0.5) * float(scale) + 0.5 + np.asarray(center, np.float32)


def _morton(c: np.ndarray) -> np.ndarray:
    """30-bit Morton codes of points in their own box."""
    lo, hi = c.min(axis=0), c.max(axis=0)
    q = ((c - lo) / np.maximum(hi - lo, 1e-12) * 1023).astype(np.int64)
    code = np.zeros(len(c), np.int64)
    for bit in range(10):
        for ax in range(3):
            code |= ((q[:, ax] >> bit) & 1) << (3 * bit + ax)
    return code


def _slab(o, inv, lo, hi):
    """Entry and exit t of rays o + t d (inv = 1 / d) against one box."""
    t0 = (lo - o) * inv
    t1 = (hi - o) * inv
    return torch.minimum(t0, t1).amax(dim=-1), torch.maximum(t0, t1).amin(dim=-1)


class Meshes:
    """The triangles of every mesh of a scene on `device`, in blocks."""

    def __init__(self, meshes: list, device, round_to=None):
        """meshes: [(T, 3, 3) f32 placed triangles]; `round_to`, a function
        of a tensor, rounds the vertices (the control's precision)."""
        self.meshes, tris = [], []
        base = 0
        for tri in meshes:
            order = np.argsort(_morton(tri.mean(axis=1)), kind="stable")
            t = torch.as_tensor(tri[order], device=device)
            if round_to is not None:
                t = round_to(t)
            blocks = []
            for s in range(0, len(t), BLOCK):
                b = t[s:s + BLOCK]
                blocks.append((base + s, b, b.reshape(-1, 3).amin(dim=0),
                               b.reshape(-1, 3).amax(dim=0)))
            flat = t.reshape(-1, 3)
            self.meshes.append((flat.amin(dim=0), flat.amax(dim=0), blocks))
            tris.append(t)
            base += len(t)
        self.all = torch.cat(tris)
        e1, e2 = self.all[:, 1] - self.all[:, 0], self.all[:, 2] - self.all[:, 0]
        n = torch.linalg.cross(e1, e2)
        self.normals = n / torch.clamp(torch.sqrt((n * n).sum(-1, keepdim=True)), min=1e-20)

    @torch.no_grad()
    def closest_hit(self, o: torch.Tensor, d: torch.Tensor):
        """Rays (N, 3) each (o may be one row) -> (t (N,), inf on a miss,
        triangle id (N,) into `all`, -1 on a miss)."""
        N, dev = d.shape[0], d.device
        o = o.expand(N, 3)
        inv = 1.0 / torch.where(d.abs() < 1e-12, torch.where(d < 0, -1e-12, 1e-12), d)
        best = torch.full((N,), float("inf"), device=dev)
        best_id = torch.full((N,), -1, dtype=torch.int64, device=dev)
        for lo, hi, blocks in self.meshes:
            tmin, tmax = _slab(o, inv, lo, hi)
            near = torch.nonzero((tmax >= torch.clamp(tmin, min=0.0)) & (tmin < best))[:, 0]
            if not near.numel():
                continue
            on, dn, invn = o[near], d[near], inv[near]
            for s0, tri, blo, bhi in blocks:
                tmin, tmax = _slab(on, invn, blo, bhi)
                cand = torch.nonzero((tmax >= torch.clamp(tmin, min=0.0))
                                     & (tmin < best[near]))[:, 0]
                for c in range(0, cand.shape[0], RAY_CHUNK):
                    sub = cand[c:c + RAY_CHUNK]
                    ids = near[sub]
                    t = _moller_trumbore(on[sub], dn[sub], tri)
                    tj, j = t.min(dim=1)
                    better = tj < best[ids]
                    best[ids] = torch.where(better, tj, best[ids])
                    best_id[ids] = torch.where(better, s0 + j, best_id[ids])
        return best, best_id


def _moller_trumbore(o, d, tri):
    """Rays (R, 3) against triangles (B, 3, 3) -> t (R, B), inf where the
    ray misses."""
    a, e1, e2 = tri[:, 0], tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0]
    p = torch.linalg.cross(d[:, None, :].expand(-1, tri.shape[0], 3), e2[None].expand(
        d.shape[0], -1, 3))
    det = (e1[None] * p).sum(-1)
    ok = det.abs() > EPS
    inv = torch.where(ok, 1.0 / torch.where(ok, det, 1.0), 0.0)
    s = o[:, None, :] - a[None]
    u = (s * p).sum(-1) * inv
    q = torch.linalg.cross(s, e1[None].expand_as(s))
    v = (d[:, None, :] * q).sum(-1) * inv
    t = (e2[None] * q).sum(-1) * inv
    hit = ok & (u >= 0) & (v >= 0) & (u + v <= 1) & (t > EPS)
    return torch.where(hit, t, float("inf"))
