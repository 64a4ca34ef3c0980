"""The plain BVH walks run until every ray is done: layouts deep enough that
a walk takes more steps than the 2,048 (closest hit) and 4,096 (crossings,
closest point) the walks once stopped at without a word.

- A stack of 12,000 parallel unit triangles along z, each crossed by a ray
  down the z axis: the closest hit, seen from above, has to visit nearly
  every node (its first leaves are the farthest), and the crossing count
  visits every node.
- The closest point to the centre of 20,000 small triangles tangent to the
  unit sphere: every box is nearer than the unit distance of the
  triangles, so the walk enters them all, and the one triangle at 0.9,
  towards (1, 1, 1), lies in the last leaves it reaches.
Each answer is known from the layout."""

from __future__ import annotations

import numpy as np
import torch

from sienerf_torch.geom.bvh import (
    build_bvh,
    bvh_any_hit,
    bvh_closest_point,
    bvh_count_hits,
    bvh_raytrace,
)

N_STACK = 12000


def _stack():
    z = np.linspace(0.0, 100.0, N_STACK, dtype=np.float32)
    tri = np.zeros((N_STACK, 3, 3), np.float32)
    tri[:, 0, :2] = (-1.0, -1.0)
    tri[:, 1, :2] = (2.0, -1.0)
    tri[:, 2, :2] = (-1.0, 2.0)
    tri[:, :, 2] = z[:, None]
    return tri


def _steps_needed(bvh) -> int:
    return bvh.n_nodes


def test_a_deep_walk_runs_to_the_end():
    torch.set_num_threads(2)
    bvh = build_bvh(_stack())
    assert _steps_needed(bvh) > 4096
    dev = bvh.as_device_arrays("cpu")
    o = torch.tensor([[0.1, 0.1, 150.0], [0.2, 0.1, -50.0]])
    d = torch.tensor([[0.0, 0.0, -1.0], [0.0, 0.0, 1.0]])
    t, tid, _, _ = bvh_raytrace(dev, o, d)
    np.testing.assert_allclose(t.numpy(), [50.0, 50.0], rtol=1e-6)
    z = bvh.triangles[tid.numpy(), 0, 2]
    np.testing.assert_allclose(z, [100.0, 0.0], atol=1e-4)
    assert bvh_count_hits(dev, o, d).tolist() == [N_STACK, N_STACK]
    assert bvh_any_hit(dev, o, d, t_max=49.0).tolist() == [False, False]
    assert bvh_any_hit(dev, o, d, mask=torch.tensor([False, True])).tolist() == [False, True]


def _tangent_triangles(n: int = 20000, near: float = 0.9, size: float = 0.01):
    rng = np.random.default_rng(0)
    d = rng.normal(size=(n, 3))
    d[0] = 1.0
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    a = np.cross(d, [0.0, 0.0, 1.0])
    a /= np.linalg.norm(a, axis=1, keepdims=True)
    b = np.cross(d, a)
    c = d * np.where(np.arange(n) == 0, near, 1.0)[:, None]
    return np.stack([c + size * a, c - 0.5 * size * a + 0.87 * size * b,
                     c - 0.5 * size * a - 0.87 * size * b], axis=1).astype(np.float32)


def test_a_deep_closest_point_walk_runs_to_the_end():
    torch.set_num_threads(2)
    bvh = build_bvh(_tangent_triangles())
    assert _steps_needed(bvh) > 4096
    dist, tid, _ = bvh_closest_point(bvh.as_device_arrays("cpu"), torch.zeros((1, 3)))
    np.testing.assert_allclose(dist.numpy(), [0.9], rtol=1e-6)
    assert int(bvh.tri_index[int(tid[0])]) == 0
