"""Iso-surface meshes of a density or SDF field, and their refinement (port
of the JAX package's ops/meshing.py).

- `density_on_grid`: the field at the centres of an R^3 grid over the unit
  cube, evaluated on the device in chunks, returned to the host;
- `marching_cubes` (ops/marching_cubes.py, the default) or the dual
  `surface_nets` extract the mesh on the host in numpy;
- `mesh_1ring` and `optimise_mesh`: vertices moved toward the iso-surface
  by Adam on the device: the sign of (density - thresh) along the field's
  gradient (autograd), Laplacian smoothing toward the 1-ring centroid, and
  inflation along the vertex normal.  The 1-ring sums are sorted segment
  sums in a fixed order (ops/fixed_order.py).
"""

from __future__ import annotations

import numpy as np
import torch

from sienerf_torch.ops.fixed_order import segment_sum_sorted
from sienerf_torch.ops.marching_cubes import marching_cubes

_GRID_CHUNK = 1 << 20  # grid points a field evaluation
_VERT_CHUNK = 1 << 18  # vertices a colour or gradient evaluation


@torch.no_grad()
def density_on_grid(density_fn, resolution: int, device, chunk: int = _GRID_CHUNK) -> np.ndarray:
    """density_fn (unit-cube points (N, 3) -> (N,)) at the R^3 cell centres
    -> (R, R, R) float32 numpy in (z, y, x) order."""
    r = resolution
    n = r ** 3
    out = torch.empty(n, dtype=torch.float32, device=device)
    for s in range(0, n, chunk):
        i = torch.arange(s, min(s + chunk, n), device=device)
        pts = torch.stack([i % r, (i // r) % r, i // (r * r)], dim=-1).float()
        out[s:s + len(i)] = density_fn((pts + 0.5) / r)
    return out.reshape(r, r, r).cpu().numpy()


def surface_nets(grid: np.ndarray, iso: float, aabb_min, aabb_diag):
    """The dual extractor: one vertex per sign-changing cell at the mean of
    its edge crossings, two triangles across each sign-changing lattice
    edge.  grid (R, R, R) in (z, y, x) -> (vertices (V, 3) world f32,
    faces (F, 3) int32)."""
    g = np.asarray(grid, np.float32) - iso
    r = g.shape[0]
    inside = g < 0
    corner = np.zeros((r - 1, r - 1, r - 1), np.int32)
    for dz in (0, 1):
        for dy in (0, 1):
            for dx in (0, 1):
                corner += inside[dz:r - 1 + dz, dy:r - 1 + dy, dx:r - 1 + dx]
    active = (corner > 0) & (corner < 8)
    if not active.any():
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int32)
    cell_ids = np.full(active.shape, -1, np.int64)
    az, ay, ax = np.nonzero(active)
    cell_ids[az, ay, ax] = np.arange(len(az))

    verts = np.zeros((len(az), 3), np.float64)
    wsum = np.zeros(len(az), np.float64)
    corner_offs = [(dz, dy, dx) for dz in (0, 1) for dy in (0, 1) for dx in (0, 1)]
    edges = [(a, b) for i, a in enumerate(corner_offs) for b in corner_offs[i + 1:]
             if sum(abs(np.array(a) - np.array(b))) == 1]
    for a, b in edges:
        va = g[a[0] + az, a[1] + ay, a[2] + ax]
        vb = g[b[0] + az, b[1] + ay, b[2] + ax]
        cross = (va < 0) != (vb < 0)
        t = np.where(cross, va / np.where(np.abs(va - vb) > 1e-12, va - vb, 1.0), 0.0)
        pa = np.stack([ax + a[2], ay + a[1], az + a[0]], axis=-1).astype(np.float64)
        pb = np.stack([ax + b[2], ay + b[1], az + b[0]], axis=-1).astype(np.float64)
        verts += np.where(cross[:, None], pa + t[:, None] * (pb - pa), 0.0)
        wsum += cross
    verts /= np.maximum(wsum, 1)[:, None]

    faces = []
    axes = [  # (corner step along the edge, the 4 cells around it)
        ((0, 0, 1), [(0, 0, 0), (0, -1, 0), (-1, -1, 0), (-1, 0, 0)]),  # x
        ((0, 1, 0), [(0, 0, 0), (-1, 0, 0), (-1, 0, -1), (0, 0, -1)]),  # y
        ((1, 0, 0), [(0, 0, 0), (0, 0, -1), (0, -1, -1), (0, -1, 0)]),  # z
    ]
    for (ez, ey, ex), nbrs in axes:
        a0 = inside[0:r - ez, 0:r - ey, 0:r - ex]
        a1 = inside[ez:r, ey:r, ex:r]
        zz, yy, xx = np.nonzero(a0 != a1)
        keep = ((zz >= (1 if ez == 0 else 0)) & (zz < r - 1)
                & (yy >= (1 if ey == 0 else 0)) & (yy < r - 1)
                & (xx >= (1 if ex == 0 else 0)) & (xx < r - 1))
        zz, yy, xx = zz[keep], yy[keep], xx[keep]
        quad = []
        ok = np.ones(len(zz), bool)
        for dz, dy, dx in nbrs:
            cz, cy, cx = zz + dz, yy + dy, xx + dx
            good = ((cz >= 0) & (cy >= 0) & (cx >= 0) & (cz < r - 1) & (cy < r - 1)
                    & (cx < r - 1))
            ok &= good
            ids = np.full(len(zz), -1, np.int64)
            ids[good] = cell_ids[cz[good], cy[good], cx[good]]
            quad.append(ids)
        q = np.stack(quad, axis=-1)
        ok &= (q >= 0).all(axis=-1)
        q = q[ok]
        flip = a0[zz[ok], yy[ok], xx[ok]]  # orient by which side is inside
        q0, q1, q2, q3 = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
        faces.append(np.where(flip[:, None], np.stack([q0, q1, q2], -1),
                              np.stack([q0, q2, q1], -1)))
        faces.append(np.where(flip[:, None], np.stack([q0, q2, q3], -1),
                              np.stack([q0, q3, q2], -1)))
    faces = np.concatenate(faces).astype(np.int32) if faces else np.zeros((0, 3), np.int32)
    world = np.asarray(aabb_min) + (verts + 0.5) / r * np.asarray(aabb_diag)
    return world.astype(np.float32), faces


def extract_mesh(density_fn, resolution: int, aabb_min, aabb_diag, device, iso: float = 2.5,
                 color_fn=None, method: str = "mc"):
    """The field's iso-surface -> (vertices (V, 3) f32, faces (F, 3) int32,
    color_fn of the vertices (a device tensor of world points) as numpy, or
    None).  NeRF densities mesh at 2.5 (the reference's default), SDFs at
    0.  method "mc" is marching cubes, "surface_nets" the dual extractor."""
    grid = density_on_grid(density_fn, resolution, device)
    if method == "mc":
        verts, faces = marching_cubes(grid, iso, aabb_min, aabb_diag)
    elif method == "surface_nets":
        verts, faces = surface_nets(grid, iso, aabb_min, aabb_diag)
    else:
        raise ValueError(f"unknown meshing method {method!r}")
    colors = None
    if color_fn is not None and len(verts):
        with torch.no_grad():
            colors = np.concatenate([
                color_fn(torch.from_numpy(verts[s:s + _VERT_CHUNK]).to(device)).cpu().numpy()
                for s in range(0, len(verts), _VERT_CHUNK)])
    return verts, faces, colors


def mesh_1ring(verts: torch.Tensor, faces: torch.Tensor):
    """Each vertex's 1-ring centroid and area-weighted normal: a triangle
    adds its other two vertices (weight 2 in all) to each corner's centroid
    and its cross product to each corner's normal -> (centroid (V, 3),
    normal (V, 3), not normalised)."""
    V = verts.shape[0]
    faces = faces.to(torch.int64)
    ia, ib, ic = faces[:, 0], faces[:, 1], faces[:, 2]
    pa, pb, pc = verts[ia], verts[ib], verts[ic]
    fn = torch.linalg.cross(pb - pa, pc - pa)
    idx = torch.cat([ia, ib, ic])
    pos_acc = torch.cat([pb + pc, pa + pc, pb + pa])
    nrm_acc = torch.cat([fn, fn, fn])
    idx_s, order = torch.sort(idx, stable=True)
    pos = segment_sum_sorted(pos_acc[order], idx_s, V)
    nrm = segment_sum_sorted(nrm_acc[order], idx_s, V)
    w = segment_sum_sorted(torch.full(idx_s.shape, 2.0, device=verts.device), idx_s, V)
    w = torch.where(w <= 0.0, 1.0, w)
    return pos / w[:, None], nrm


def optimise_mesh(density_fn, verts, faces, aabb_min, aabb_diag, device, n_steps: int = 1,
                  thresh: float = 2.5, smooth_amount: float = 2048.0,
                  density_amount: float = 128.0, inflate_amount: float = 1.0,
                  learning_rate: float = 1e-4) -> np.ndarray:
    """Move the vertices toward the iso-surface `thresh` of density_fn
    (unit-cube points -> (N,)): per vertex the step direction is
    normalize(grad density) * sign(density - thresh) * density_amount +
    (v - 1-ring centroid) * smooth_amount - normalize(vertex normal) *
    inflate_amount, stepped by Adam (lr 1e-4, betas 0.9 / 0.99, eps 1e-8)
    n_steps times -> the world-space vertices (V, 3) numpy."""
    if len(verts) == 0:
        return np.asarray(verts, np.float32)
    v = torch.as_tensor(np.asarray(verts, np.float32), device=device)
    f = torch.as_tensor(np.asarray(faces), device=device).to(torch.int64)
    amin = torch.as_tensor(np.asarray(aabb_min, np.float32), device=device)
    adiag = torch.as_tensor(np.asarray(aabb_diag, np.float32), device=device)
    m = torch.zeros_like(v)
    mv = torch.zeros_like(v)

    def unit_norm(x):
        return x / torch.clamp(torch.linalg.norm(x, dim=-1, keepdim=True), min=1e-12)

    def density_and_grad(vc):
        with torch.enable_grad():
            vr = vc.detach().requires_grad_(True)
            dens = density_fn(torch.clamp((vr - amin) / adiag, 0.0, 1.0))
            return dens.detach(), torch.autograd.grad(dens.sum(), vr)[0]

    for t in range(1, n_steps + 1):
        parts = [density_and_grad(v[s:s + _VERT_CHUNK]) for s in range(0, len(v), _VERT_CHUNK)]
        dens, g_pos = (torch.cat(x) for x in zip(*parts))
        with torch.no_grad():
            centroid, normals = mesh_1ring(v, f)
            grad = (unit_norm(g_pos) * torch.sign(dens - thresh)[:, None] * density_amount
                    + (v - centroid) * smooth_amount - unit_norm(normals) * inflate_amount)
            m = 0.9 * m + 0.1 * grad
            mv = 0.99 * mv + 0.01 * grad * grad
            tt = np.float32(t)
            mh = m / float(np.float32(1.0) - np.float32(0.9) ** tt)
            vh = mv / float(np.float32(1.0) - np.float32(0.99) ** tt)
            v = v - learning_rate * mh / (torch.sqrt(vh) + 1e-8)
    return v.cpu().numpy()
