"""Render mode `normals`, port vs reference, on the seeded field of
tests/test_torch_live.py: a 32x32 live frame (the bf16 render table, whose
position gradient autograd takes through the interpolation weights) and a
ray batch (the f32 table, through the hash grid's backward).  The normal
is minus the density's position gradient, composited, normalised and
mapped to [0, 1] times opacity.

Tolerances: rtol 2e-2 / atol 5e-3 on the pixels and rays that agree, at
least 99 % of them, as the other live modes (tests/test_torch_live.py: a
pixel agrees when both packages took the same samples on its ray and
picked the same depth sample; under jit XLA may move single samples across
a voxel boundary)."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_live import FOCAL, _agree, _cam, _ray_batch, tiny

S = 32
NORMALS_TOL = dict(rtol=2e-2, atol=5e-3)


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


@functools.lru_cache(maxsize=4)
def _frame(mode):
    jeng, jp, teng, tp, bf = tiny()
    focal = tuple(f * S / 48 for f in FOCAL)
    want = jeng.render_frame(jp, jnp.asarray(bf), S, S, _cam(), focal, render_mode=mode)
    got = teng.render_frame(tp, torch.from_numpy(bf), S, S, _cam(), focal, render_mode=mode)
    return [g.numpy() for g in got], [np.asarray(w) for w in want]


def test_normals_frame_matches_the_reference():
    (rgba, depth), (want, want_depth) = _frame("normals")
    (cost, _), (want_cost, _) = _frame("cost")
    same = _agree(cost[..., 0], want_cost[..., 0], depth, want_depth)
    assert rgba.shape == (S, S, 4) and np.isfinite(rgba).all()
    hit = want[..., 3] > 0.5
    assert hit.mean() > 0.1
    # unit normals mapped to [0, 1], weighted by opacity
    assert (rgba[..., :3] >= -1e-6).all() and (rgba[..., :3] <= 1 + 1e-6).all()
    n = (rgba[hit][:, :3] / rgba[hit][:, 3:] - 0.5) * 2.0
    np.testing.assert_allclose(np.linalg.norm(n, axis=-1), 1.0, atol=2e-2)
    ok = np.isclose(rgba, want, **NORMALS_TOL).all(axis=-1)
    assert ok[same].mean() >= 0.99
    assert (ok | ~same).mean() >= 0.99


def test_normals_of_a_ray_batch_match_the_reference():
    jeng, jp, teng, tp, bf = tiny()
    o, d, _ = _ray_batch()
    want = [np.asarray(w) for w in jeng.render_rays(
        jp, jnp.asarray(bf), jnp.asarray(o), jnp.asarray(d), render_mode="normals")]
    got = [g.numpy() for g in teng.render_rays(
        tp, torch.from_numpy(bf), torch.from_numpy(o), torch.from_numpy(d),
        render_mode="normals")]
    cost = teng.render_rays(tp, torch.from_numpy(bf), torch.from_numpy(o),
                            torch.from_numpy(d), render_mode="cost")[0][:, 0].numpy()
    want_cost = np.asarray(jeng.render_rays(jp, jnp.asarray(bf), jnp.asarray(o),
                                            jnp.asarray(d), render_mode="cost")[0][:, 0])
    same = _agree(cost, want_cost, got[2], want[2])
    assert want[1].mean() > 0.1
    ok = np.isclose(got[0], want[0], **NORMALS_TOL).all(axis=-1)
    assert ok[same].mean() >= 0.99
