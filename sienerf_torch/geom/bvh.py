"""Triangle BVH: host build and closest-hit traversal (port of the JAX
package's geom/bvh.py: the numpy builder, the stackless traversal and the
dense brute-force tier).

- Build (host, numpy or the native C++ builder): a binary BVH split at the
  centroid median of the largest extent, leaves of at most LEAF_SIZE
  triangles, flattened in DFS order with skip links, the triangles
  reordered so that each leaf's range is contiguous.
- `bvh_raytrace`: a stackless walk, one node pointer per ray.  At an
  interior node a ray whose box test passes steps to node+1 (the first
  child), otherwise to skip[node].  CUDA tensors go to K3
  (ops/bvh_kernel.py, csrc/bvh.cu), one thread a ray; other devices take
  `bvh_raytrace_plain`, the same walk as a host loop over the whole ray
  batch, as ops/raymarch.py::march_rays runs its march: every step is a
  handful of masked gathers and elementwise operations, and every
  `_CHECK_EVERY` steps the host asks whether any ray still walks and stops
  if none does.  Steps after the last ray finished change nothing, so the
  early exit is exact.  Every step moves a ray's pointer forward (node+1,
  or a skip link past the subtree), so each walk ends within the node
  count; the plain walks run until every ray is done and raise if a ray
  outlives that bound (a malformed layout).
- `brute_raytrace`: every ray against every triangle, for meshes of up to
  65,536 triangles.  With per-triangle plane constants the test is
  t = (k - n.o) / (n.d), u = (U.o + u_w) + t (U.d), v alike, so a tile of
  rays needs two (R, 3) @ (3, 3T) products (origins and directions) and
  elementwise work.  The products run in full f32 (TF32 off), as the
  reference's run at Precision.HIGHEST.

- The SDF mode's queries walk the same layout the same way:
  `bvh_any_hit` (shadow rays; the closest hit's id >= 0, K3's any-hit
  walk on CUDA),
  `bvh_count_hits` (every intersection along a ray: the parity of the
  watertight sign) and `bvh_closest_point` (the unsigned distance, a walk
  that enters a box only when it is nearer than the best triangle so far).
"""

from __future__ import annotations

import sys
import itertools
from contextlib import contextmanager
from dataclasses import dataclass

import numpy as np
import torch

LEAF_SIZE = 4
_CHECK_EVERY = 32  # traversal steps between the host's any-ray-active tests


@dataclass
class TriangleBVH:
    """Flattened BVH.  Node 0 is the root; nodes are in DFS order."""

    bbox_min: np.ndarray  # (M, 3) f32
    bbox_max: np.ndarray  # (M, 3) f32
    first_tri: np.ndarray  # (M,) i32: first triangle of a leaf, else -1
    tri_count: np.ndarray  # (M,) i32: > 0 for leaves
    skip: np.ndarray  # (M,) i32: the node after this subtree (-1 = done)
    triangles: np.ndarray  # (T, 3, 3) f32, reordered
    tri_index: np.ndarray  # (T,) i32: original triangle ids

    @property
    def n_nodes(self) -> int:
        return len(self.first_tri)

    def as_device_arrays(self, device=None) -> dict:
        def t(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(device)

        tri = self.triangles
        return {"bbox_min": t(self.bbox_min), "bbox_max": t(self.bbox_max),
                "first_tri": t(self.first_tri).to(torch.int64),
                "tri_count": t(self.tri_count).to(torch.int64),
                "skip": t(self.skip).to(torch.int64),
                "tri_a": t(tri[:, 0]), "tri_ab": t(tri[:, 1] - tri[:, 0]),
                "tri_ac": t(tri[:, 2] - tri[:, 0])}


def build_bvh(triangles: np.ndarray, leaf_size: int = LEAF_SIZE,
              builder: str = "native") -> TriangleBVH:
    """Build with the native C++ builder (the default; a failed build
    raises) or, with builder="numpy", the numpy one.  The two split at
    different centroids (box centre against vertex mean), so their trees
    differ; each traces the same hits."""
    tri = np.ascontiguousarray(triangles, np.float32)
    if builder == "native":
        from sienerf_torch.geom import bvh_native

        return TriangleBVH(*bvh_native.build(tri, leaf_size))
    if builder == "numpy":
        return _build_bvh_numpy(tri, leaf_size)
    raise ValueError(f"unknown BVH builder {builder!r}")


def _build_bvh_numpy(tri: np.ndarray, leaf_size: int) -> TriangleBVH:
    n = len(tri)
    centroids = tri.mean(axis=1)
    tmin_all = tri.min(axis=1)
    tmax_all = tri.max(axis=1)
    bbox_min, bbox_max, first_tri, tri_count, skip_size = [], [], [], [], []
    out_order: list[np.ndarray] = []

    def rec(ids: np.ndarray) -> int:
        """Build a subtree -> the number of nodes it made."""
        my_idx = len(bbox_min)
        lo = tmin_all[ids].min(axis=0)
        hi = tmax_all[ids].max(axis=0)
        bbox_min.append(lo)
        bbox_max.append(hi)
        if len(ids) <= leaf_size:
            first_tri.append(sum(len(o) for o in out_order))
            tri_count.append(len(ids))
            out_order.append(ids)
            skip_size.append(1)
            return 1
        axis = int(np.argmax(hi - lo))
        c = centroids[ids][:, axis]
        mid = len(ids) // 2
        part = np.argpartition(c, mid)
        first_tri.append(-1)
        tri_count.append(0)
        skip_size.append(0)  # patched below
        sz = 1 + rec(ids[part[:mid]]) + rec(ids[part[mid:]])
        skip_size[my_idx] = sz
        return sz

    old_limit = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old_limit, 10000 + 2 * n))
    try:
        rec(np.arange(n))
    finally:
        sys.setrecursionlimit(old_limit)
    m = len(bbox_min)
    skip = np.arange(m, dtype=np.int64) + np.asarray(skip_size, np.int64)
    skip = np.where(skip >= m, -1, skip).astype(np.int32)
    perm = np.concatenate(out_order) if out_order else np.zeros(0, np.int64)
    return TriangleBVH(
        bbox_min=np.asarray(bbox_min, np.float32), bbox_max=np.asarray(bbox_max, np.float32),
        first_tri=np.asarray(first_tri, np.int32), tri_count=np.asarray(tri_count, np.int32),
        skip=skip, triangles=tri[perm], tri_index=perm.astype(np.int32))


# --- traversal ---------------------------------------------------------------


def _ray_aabb(o, inv_d, lo, hi):
    t0 = (lo - o) * inv_d
    t1 = (hi - o) * inv_d
    return torch.minimum(t0, t1).amax(dim=-1), torch.maximum(t0, t1).amin(dim=-1)


def _moller_trumbore(o, d, a, ab, ac, eps: float = 1e-9):
    """Batched ray-triangle test.  o, d (..., 3); a, ab, ac (..., L, 3) ->
    (t, u, v, hit), each (..., L)."""
    dd = d[..., None, :].expand(ac.shape)
    pvec = torch.linalg.cross(dd, ac)
    det = (ab * pvec).sum(dim=-1)
    ok = det.abs() > eps
    inv_det = torch.where(ok, 1.0 / torch.where(ok, det, 1.0), 0.0)
    tvec = o[..., None, :] - a
    u = (tvec * pvec).sum(dim=-1) * inv_det
    qvec = torch.linalg.cross(tvec, ab)
    v = (dd * qvec).sum(dim=-1) * inv_det
    t = (ac * qvec).sum(dim=-1) * inv_det
    hit = ok & (u >= 0) & (v >= 0) & (u + v <= 1) & (t > eps)
    return t, u, v, hit


def _pick(x: torch.Tensor, j: torch.Tensor) -> torch.Tensor:
    return x.gather(1, j[:, None])[:, 0]


def _walk_steps(bvh: dict):
    """Steps 0, 1, 2, ... of a plain walk, ending with an error if a ray
    still walks after more steps than the BVH has nodes (each step moves
    a pointer forward, so a sound layout never gets there)."""
    n_nodes = bvh["skip"].shape[0]
    for step in itertools.count():
        if step > n_nodes + _CHECK_EVERY:
            raise RuntimeError(f"BVH walk: a ray still walks after {step} steps over "
                               f"{n_nodes} nodes; the skip links are malformed")
        yield step


def _inverse(dirs: torch.Tensor) -> torch.Tensor:
    eps = 1e-12
    tiny = torch.where(dirs < 0, -eps, eps)
    return 1.0 / torch.where(dirs.abs() < eps, tiny, dirs)


@torch.no_grad()
def bvh_raytrace(bvh: dict, origins: torch.Tensor, dirs: torch.Tensor, t_max=1e10,
                 leaf_size: int = LEAF_SIZE, mask: torch.Tensor | None = None):
    """Closest hit through the BVH's device arrays (as_device_arrays) ->
    (t (N,), tri_id (N,) int64, -1 on a miss, u (N,), v (N,)).  `mask`
    (N,) bool, where given, leaves the rays where it is False unwalked
    (misses).  K3 on CUDA tensors, the plain walk elsewhere."""
    if origins.device.type == "cuda":
        from sienerf_torch.ops.bvh_kernel import bvh_walk_kernel

        return bvh_walk_kernel(bvh, origins, dirs, t_max, mask=mask, leaf_size=leaf_size)
    return bvh_raytrace_plain(bvh, origins, dirs, t_max, leaf_size, mask)


@torch.no_grad()
def bvh_raytrace_plain(bvh: dict, origins: torch.Tensor, dirs: torch.Tensor, t_max=1e10,
                       leaf_size: int = LEAF_SIZE, mask: torch.Tensor | None = None):
    """bvh_raytrace's plain walk, on any device (K3's yardstick)."""
    N, dev = origins.shape[0], origins.device
    inv_d = _inverse(dirs)
    t_max = torch.as_tensor(t_max, dtype=torch.float32, device=dev).expand(N)
    n_tris = bvh["tri_a"].shape[0]
    offs = torch.arange(leaf_size, device=dev)
    node = torch.zeros((N,), dtype=torch.int64, device=dev)
    if mask is not None:
        node = torch.where(mask, node, -1)
    best_t = torch.minimum(torch.full((N,), float("inf"), device=dev), t_max)
    best_id = torch.full((N,), -1, dtype=torch.int64, device=dev)
    best_u = torch.zeros((N,), device=dev)
    best_v = torch.zeros((N,), device=dev)
    for step in _walk_steps(bvh):
        if step % _CHECK_EVERY == 0 and not bool((node >= 0).any()):
            break
        active = node >= 0
        ni = torch.clamp(node, min=0)
        tmin, tmax_box = _ray_aabb(origins, inv_d, bvh["bbox_min"][ni], bvh["bbox_max"][ni])
        box_hit = active & (tmax_box >= torch.clamp(tmin, min=0.0)) & (tmin < best_t)
        count = bvh["tri_count"][ni]
        is_leaf = count > 0
        tid = bvh["first_tri"][ni][:, None] + offs[None, :]  # (N, L)
        tid_valid = offs[None, :] < count[:, None]
        tid_c = torch.clamp(tid, 0, n_tris - 1)
        t, u, v, hit = _moller_trumbore(origins, dirs, bvh["tri_a"][tid_c],
                                        bvh["tri_ab"][tid_c], bvh["tri_ac"][tid_c])
        hit = (hit & tid_valid & (box_hit & is_leaf)[:, None]
               & (t < best_t[:, None]) & (t < t_max[:, None]))
        t_masked = torch.where(hit, t, float("inf"))
        j = torch.argmin(t_masked, dim=1)
        tj = _pick(t_masked, j)
        better = tj < best_t
        best_t = torch.where(better, tj, best_t)
        best_id = torch.where(better, _pick(tid_c, j), best_id)
        best_u = torch.where(better, _pick(u, j), best_u)
        best_v = torch.where(better, _pick(v, j), best_v)
        nxt = torch.where(box_hit & ~is_leaf, ni + 1, bvh["skip"][ni])
        node = torch.where(active, nxt, node)
    best_t = torch.where(best_id >= 0, best_t, float("inf"))
    return best_t, best_id, best_u, best_v


def bvh_any_hit(bvh: dict, origins: torch.Tensor, dirs: torch.Tensor, t_max=1e10,
                leaf_size: int = LEAF_SIZE, mask: torch.Tensor | None = None) -> torch.Tensor:
    """Occlusion: True where the ray hits any triangle within t_max (False
    where `mask` is False).  K3's any-hit walk on CUDA tensors, which ends
    a ray at its first hit; the plain closest hit elsewhere."""
    if origins.device.type == "cuda":
        from sienerf_torch.ops.bvh_kernel import bvh_walk_kernel

        return bvh_walk_kernel(bvh, origins, dirs, t_max, any_hit=True, mask=mask,
                               leaf_size=leaf_size)
    return bvh_raytrace_plain(bvh, origins, dirs, t_max, leaf_size, mask)[1] >= 0


def _leaf_triangles(bvh: dict, ni: torch.Tensor, offs: torch.Tensor):
    """The leaf slots of nodes ni -> (tid_c (N, L), tid_valid, count, a, ab, ac)."""
    count = bvh["tri_count"][ni]
    tid = bvh["first_tri"][ni][:, None] + offs[None, :]
    tid_valid = offs[None, :] < count[:, None]
    tid_c = torch.clamp(tid, 0, bvh["tri_a"].shape[0] - 1)
    return (tid_c, tid_valid, count, bvh["tri_a"][tid_c], bvh["tri_ab"][tid_c],
            bvh["tri_ac"][tid_c])


@torch.no_grad()
def bvh_count_hits(bvh: dict, origins: torch.Tensor, dirs: torch.Tensor,
                   leaf_size: int = LEAF_SIZE) -> torch.Tensor:
    """The number of triangles each ray crosses (N,) int64: every
    intersection along it, wherever it lies."""
    N, dev = origins.shape[0], origins.device
    inv_d = _inverse(dirs)
    offs = torch.arange(leaf_size, device=dev)
    node = torch.zeros((N,), dtype=torch.int64, device=dev)
    count = torch.zeros((N,), dtype=torch.int64, device=dev)
    for step in _walk_steps(bvh):
        if step % _CHECK_EVERY == 0 and not bool((node >= 0).any()):
            break
        active = node >= 0
        ni = torch.clamp(node, min=0)
        tmin, tmax_box = _ray_aabb(origins, inv_d, bvh["bbox_min"][ni], bvh["bbox_max"][ni])
        box_hit = active & (tmax_box >= torch.clamp(tmin, min=0.0))
        tid_c, tid_valid, cnt, a, ab, ac = _leaf_triangles(bvh, ni, offs)
        is_leaf = cnt > 0
        hit = _moller_trumbore(origins, dirs, a, ab, ac)[3]
        hit = hit & tid_valid & (box_hit & is_leaf)[:, None]
        count = count + hit.sum(dim=1)
        nxt = torch.where(box_hit & ~is_leaf, ni + 1, bvh["skip"][ni])
        node = torch.where(active, nxt, node)
    return count


def _closest_on_triangle(p, a, ab, ac):
    """The closest points of triangles (N, L, 3 each) to points p (N, 3)
    -> (N, L, 3): the Voronoi-region test of Ericson's Real-Time Collision
    Detection, in the reference's order of cases."""
    ap = p[:, None, :] - a
    d1 = (ab * ap).sum(dim=-1)
    d2 = (ac * ap).sum(dim=-1)
    bp = ap - ab
    d3 = (ab * bp).sum(dim=-1)
    d4 = (ac * bp).sum(dim=-1)
    cp = ap - ac
    d5 = (ab * cp).sum(dim=-1)
    d6 = (ac * cp).sum(dim=-1)
    va = d3 * d6 - d5 * d4
    vb = d5 * d2 - d1 * d6
    vc = d1 * d4 - d3 * d2

    def safe(x):
        return torch.where(x.abs() > 1e-20, x, 1.0)

    denom = va + vb + vc
    v = vb / safe(denom)
    w = vc / safe(denom)
    res = a + v[..., None] * ab + w[..., None] * ac
    t_ab = torch.clamp(d1 / safe(d1 - d3), 0.0, 1.0)
    t_ac = torch.clamp(d2 / safe(d2 - d6), 0.0, 1.0)
    t_bc = torch.clamp((d4 - d3) / safe((d4 - d3) + (d5 - d6)), 0.0, 1.0)
    res = torch.where(((vc <= 0) & (d1 >= 0) & (d3 <= 0))[..., None], a + t_ab[..., None] * ab, res)
    res = torch.where(((vb <= 0) & (d2 >= 0) & (d6 <= 0))[..., None], a + t_ac[..., None] * ac, res)
    res = torch.where(((va <= 0) & ((d4 - d3) >= 0) & ((d5 - d6) >= 0))[..., None],
                      a + ab + t_bc[..., None] * (ac - ab), res)
    res = torch.where(((d1 <= 0) & (d2 <= 0))[..., None], a, res)
    res = torch.where(((d3 >= 0) & (d4 <= d3))[..., None], a + ab, res)
    res = torch.where(((d6 >= 0) & (d5 <= d6))[..., None], a + ac, res)
    return res


@torch.no_grad()
def bvh_closest_point(bvh: dict, points: torch.Tensor, leaf_size: int = LEAF_SIZE):
    """The nearest triangle of each point -> (unsigned distance (N,),
    triangle id (N,) int64, closest point (N, 3)): a walk over the skip
    links that enters a box only when it is nearer than the best so far."""
    N, dev = points.shape[0], points.device
    offs = torch.arange(leaf_size, device=dev)
    node = torch.zeros((N,), dtype=torch.int64, device=dev)
    best_d2 = torch.full((N,), float("inf"), device=dev)
    best_id = torch.full((N,), -1, dtype=torch.int64, device=dev)
    best_p = torch.zeros((N, 3), device=dev)
    for step in _walk_steps(bvh):
        if step % _CHECK_EVERY == 0 and not bool((node >= 0).any()):
            break
        active = node >= 0
        ni = torch.clamp(node, min=0)
        lo, hi = bvh["bbox_min"][ni], bvh["bbox_max"][ni]
        dbox = torch.maximum(torch.clamp(lo - points, min=0.0), points - hi)
        enter = active & ((dbox * dbox).sum(dim=-1) < best_d2)
        tid_c, tid_valid, count, a, ab, ac = _leaf_triangles(bvh, ni, offs)
        is_leaf = count > 0
        cp = _closest_on_triangle(points, a, ab, ac)
        d2 = ((points[:, None, :] - cp) ** 2).sum(dim=-1)
        d2 = torch.where(tid_valid & (enter & is_leaf)[:, None], d2, float("inf"))
        j = torch.argmin(d2, dim=1)
        dj = _pick(d2, j)
        better = dj < best_d2
        best_d2 = torch.where(better, dj, best_d2)
        best_id = torch.where(better, _pick(tid_c, j), best_id)
        best_p = torch.where(better[:, None], cp[torch.arange(N, device=dev), j], best_p)
        nxt = torch.where(enter & ~is_leaf, ni + 1, bvh["skip"][ni])
        node = torch.where(active, nxt, node)
    return torch.sqrt(best_d2), best_id, best_p


# --- brute-force tier (small meshes) -------------------------------------------


def build_brute(triangles: np.ndarray, pad_to: int = 512, device=None) -> dict:
    """Per-triangle constants of brute_raytrace.  `triangles` (T, 3, 3)
    must be the BVH's reordered array, so that triangle ids index its
    normals alike.  Padding triangles have n = 0 and never hit."""
    tri = np.ascontiguousarray(triangles, np.float32)
    T = len(tri)
    Tp = max(pad_to, ((T + pad_to - 1) // pad_to) * pad_to)
    a = np.zeros((Tp, 3), np.float32)
    ab = np.zeros((Tp, 3), np.float32)
    ac = np.zeros((Tp, 3), np.float32)
    a[:T] = tri[:, 0]
    ab[:T] = tri[:, 1] - tri[:, 0]
    ac[:T] = tri[:, 2] - tri[:, 0]
    n = np.cross(ab, ac)  # unnormalised; n.n = det[ab, ac, n]
    nn = np.sum(n * n, axis=-1)
    safe = np.where(nn > 1e-30, nn, 1.0)[:, None]
    # p - a = u ab + v ac in the plane: u = (ac x n).(p - a) / n.n and
    # v = (n x ab).(p - a) / n.n; degenerate triangles keep n = 0
    n = np.where(nn[:, None] > 1e-30, n, 0.0)
    U = np.cross(ac, n) / safe
    V = np.cross(n, ab) / safe
    # one (R, 3) @ (3, 3Tp) product gives [n.x | U.x | V.x] for a batch x
    G = np.concatenate([n, U, V], axis=0).T

    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(device)

    return {"G": t(G), "k": t(np.sum(n * a, axis=-1)), "uw": t(-np.sum(U * a, axis=-1)),
            "vw": t(-np.sum(V * a, axis=-1)), "n_tris": T}


@contextmanager
def _full_f32_matmul():
    """f32 products in full f32 on the card (TF32 off) inside the block."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _brute_tile(bt: dict, o, d, t_max, eps: float = 1e-9):
    """One ray tile against every triangle -> (t, tid, u, v)."""
    Tp = bt["k"].shape[0]
    with _full_f32_matmul():
        Go = o @ bt["G"]  # (R, 3Tp)
        Gd = d @ bt["G"]
    no, uo, vo = Go[:, :Tp], Go[:, Tp:2 * Tp], Go[:, 2 * Tp:]
    nd, ud, vd = Gd[:, :Tp], Gd[:, Tp:2 * Tp], Gd[:, 2 * Tp:]
    live = nd.abs() > eps
    t = (bt["k"][None, :] - no) / torch.where(live, nd, 1.0)
    u = (uo + bt["uw"][None, :]) + t * ud
    v = (vo + bt["vw"][None, :]) + t * vd
    hit = live & (u >= 0) & (v >= 0) & (u + v <= 1.0) & (t > eps) & (t < t_max[:, None])
    t = torch.where(hit, t, float("inf"))
    j = torch.argmin(t, dim=1)
    tj = _pick(t, j)
    miss = ~torch.isfinite(tj)
    return (torch.where(miss, float("inf"), tj), torch.where(miss, -1, j),
            torch.where(miss, 0.0, _pick(u, j)), torch.where(miss, 0.0, _pick(v, j)))


@torch.no_grad()
def brute_raytrace(bt: dict, origins: torch.Tensor, dirs: torch.Tensor, t_max=1e10,
                   ray_tile: int = 8192):
    """Closest hit over all triangles, tile by tile of `ray_tile` rays;
    the drop-in for bvh_raytrace on small meshes -> (t, tri_id, u, v)."""
    N, dev = origins.shape[0], origins.device
    t_max = torch.as_tensor(t_max, dtype=torch.float32, device=dev).expand(N)
    outs = [_brute_tile(bt, origins[s:s + ray_tile], dirs[s:s + ray_tile],
                        t_max[s:s + ray_tile]) for s in range(0, N, ray_tile)]
    if not outs:
        z = torch.zeros((0,), device=dev)
        return z, z.to(torch.int64), z, z
    return tuple(torch.cat(parts) for parts in zip(*outs))
