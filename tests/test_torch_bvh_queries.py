"""The SDF mode's BVH queries, port vs reference, on one BVH (a sphere of
320 triangles and a disjoint box, the reference's native build carried
across): any-hit, hit counts and the closest point.

Tolerances: hit flags and hit counts exact; closest triangle ids exact
except at ties (a point nearest to an edge or a vertex that triangles
share: then both ids are nearest, to 1e-6 in float64); distances rtol
1e-6 / atol 1e-7 (the same f32 operations; XLA may contract a multiply-add
of the closest-point test); closest points atol 1e-6 where the ids agree."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sienerf_tpu.geom import bvh as jbvh
from sienerf_torch.geom import bvh as tbvh
from sienerf_torch.geom.mesh_io import box_mesh, icosphere

DIST_TOL = dict(rtol=1e-6, atol=1e-7)


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


def scene_triangles() -> np.ndarray:
    """A sphere (320 triangles, radius 0.2) and a box beside it, both
    closed, in the unit cube."""
    sphere = icosphere(2, 0.2) + np.asarray([0.35, 0.5, 0.5], np.float32)
    box = box_mesh((0.62, 0.3, 0.35), (0.85, 0.7, 0.6))
    return np.concatenate([sphere, box]).astype(np.float32)


def bvh_pair():
    """The reference's BVH and the port's view of the same arrays."""
    jb = jbvh.build_bvh(scene_triangles())
    tb = tbvh.TriangleBVH(jb.bbox_min, jb.bbox_max, jb.first_tri, jb.tri_count, jb.skip,
                          jb.triangles, jb.tri_index)
    return jb.as_device_arrays(), tb.as_device_arrays("cpu"), tb


def query_points(n=2048, seed=0) -> np.ndarray:
    """Points anywhere in the cube, half of them near the surfaces."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(0.0, 1.0, (n, 3)).astype(np.float32)
    tri = scene_triangles()
    k = rng.integers(0, len(tri), n // 2)
    bc = rng.dirichlet([1, 1, 1], n // 2).astype(np.float32)
    near = (tri[k] * bc[:, :, None]).sum(axis=1) + rng.normal(0, 0.01, (n // 2, 3))
    pts[: n // 2] = near.astype(np.float32)
    return pts


def _rays(n=2048, seed=1):
    rng = np.random.default_rng(seed)
    o = query_points(n, seed)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d


def test_closest_point_matches():
    jd, td, _ = bvh_pair()
    pts = query_points()
    jdist, jid, jcp = jbvh.bvh_closest_point(jd, jnp.asarray(pts))
    dist, tid, cp = tbvh.bvh_closest_point(td, torch.from_numpy(pts))
    other = tid.numpy() != np.asarray(jid)
    assert other.mean() < 0.02
    if other.any():  # ties: both triangles are nearest
        p = torch.from_numpy(pts[other]).double()

        def d64(ids):
            ids = torch.as_tensor(np.asarray(ids, np.int64))[:, None]
            c = tbvh._closest_on_triangle(p, td["tri_a"][ids].double(),
                                          td["tri_ab"][ids].double(), td["tri_ac"][ids].double())
            return ((c[:, 0] - p) ** 2).sum(-1).sqrt().numpy()
        np.testing.assert_allclose(d64(tid.numpy()[other]), d64(np.asarray(jid)[other]),
                                   atol=1e-6)
    np.testing.assert_allclose(dist.numpy(), np.asarray(jdist), **DIST_TOL)
    np.testing.assert_allclose(cp.numpy()[~other], np.asarray(jcp)[~other], atol=1e-6)
    # against every triangle, brute force in float64
    tri = td["tri_a"].double()
    ab, ac = td["tri_ab"].double(), td["tri_ac"].double()
    p = torch.from_numpy(pts[:256]).double()
    best = torch.stack([tbvh._closest_on_triangle(p, tri[None].expand(256, -1, -1),
                                                  ab[None].expand(256, -1, -1),
                                                  ac[None].expand(256, -1, -1))])[0]
    brute = ((best - p[:, None]) ** 2).sum(-1).min(dim=1).values.sqrt()
    np.testing.assert_allclose(dist[:256].numpy(), brute.numpy(), rtol=1e-5, atol=1e-6)


def test_hit_counts_and_any_hit_match():
    jd, td, _ = bvh_pair()
    o, d = _rays()
    jc = jbvh.bvh_count_hits(jd, jnp.asarray(o), jnp.asarray(d))
    tc = tbvh.bvh_count_hits(td, torch.from_numpy(o), torch.from_numpy(d))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    assert 0 < (tc.numpy() % 2 == 1).mean() < 1  # some points inside, some outside
    for t_max in (1e10, 0.05):
        ja = jbvh.bvh_any_hit(jd, jnp.asarray(o), jnp.asarray(d), t_max=t_max)
        ta = tbvh.bvh_any_hit(td, torch.from_numpy(o), torch.from_numpy(d), t_max=t_max)
        np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
