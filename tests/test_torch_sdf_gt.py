"""Ground-truth signed distance, port vs reference, on the sphere-and-box
scene of tests/test_torch_bvh_queries.py: the device walks of
geom/sdf_gt.py (unsigned distance, the watertight, raystab and path-escape
signs, the latter on the reference's own random draws) and the native
host query geom/bvh_native.py::sdf_query (the repo's csrc/sdf_query.cpp,
built by each package), and a failed native build raising.

Tolerances: distances rtol 1e-6 / atol 1e-7; signs exact.  The host query
against the device walk: the same distances to 1e-6 (C++ and torch f32)
and the same signs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sienerf_tpu.common import MeshSdfMode as JMode
from sienerf_tpu.geom import bvh_native as jnative
from sienerf_tpu.geom import sdf_gt as jgt
from sienerf_torch.common import MeshSdfMode
from sienerf_torch.geom import bvh_native as tnative
from sienerf_torch.geom import sdf_gt as tgt
from test_torch_bvh_queries import bvh_pair, query_points

DIST_TOL = dict(rtol=1e-6, atol=1e-7)


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


def test_unsigned_distance_and_signs_match():
    jd, td, _ = bvh_pair()
    pts = query_points(1024, 3)
    jp, tp = jnp.asarray(pts), torch.from_numpy(pts)
    np.testing.assert_allclose(tgt.unsigned_distance(td, tp)[0].numpy(),
                               np.asarray(jgt.unsigned_distance(jd, jp)[0]), **DIST_TOL)
    ws = tgt.sign_watertight(td, tp).numpy()
    np.testing.assert_array_equal(ws, np.asarray(jgt.sign_watertight(jd, jp)))
    assert 0.05 < (ws < 0).mean() < 0.95
    rs = tgt.sign_raystab(td, tp[:256], n_dirs=8).numpy()
    np.testing.assert_array_equal(rs, np.asarray(jgt.sign_raystab(jd, jp[:256], n_dirs=8)))
    # a closed mesh: the two signs agree away from the surface
    far = tgt.unsigned_distance(td, tp[:256])[0].numpy() > 1e-3
    np.testing.assert_array_equal(rs[far], ws[:256][far])


def _jax_path_draws(key, n_paths, n):
    """The reference's sign_pathescape uniforms, by (path, bounce)."""
    out = {}
    for p, k in enumerate(jax.random.split(key, n_paths)):
        k_dir, k_b = jax.random.split(k)
        out[(p, -1)] = np.array(jax.random.uniform(k_dir, (n, 2)))
        for j in range(4):
            out[(p, j)] = np.array(jax.random.uniform(jax.random.fold_in(k_b, j), (n, 2)))
    return out


def test_path_escape_sign_on_the_reference_draws():
    jd, td, _ = bvh_pair()
    pts = query_points(256, 4)
    key = jax.random.PRNGKey(3)
    want = np.asarray(jgt.sign_pathescape(jd, jnp.asarray(pts), key, n_paths=8))
    draws = _jax_path_draws(key, 8, len(pts))
    got = tgt.sign_pathescape(td, torch.from_numpy(pts), n_paths=8,
                              draw=lambda p, j, shape: torch.from_numpy(draws[(p, j)]))
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0.05 < (want < 0).mean() < 0.95
    pts = pts[:64]
    draws = _jax_path_draws(key, 32, len(pts))
    sd = tgt.signed_distance(td, torch.from_numpy(pts), MeshSdfMode.PATH_ESCAPE,
                             draw=lambda p, j, shape: torch.from_numpy(draws[(p, j)])).numpy()
    np.testing.assert_allclose(
        sd, np.asarray(jgt.signed_distance(jd, jnp.asarray(pts), JMode.PATH_ESCAPE, key)),
        **DIST_TOL)
    # drawn from a torch generator instead: a sign for every point
    s = tgt.sign_pathescape(td, torch.from_numpy(pts), torch.Generator().manual_seed(0),
                            n_paths=4)
    assert set(np.unique(s.numpy())) <= {-1.0, 1.0}


@pytest.mark.parametrize("mode", [0, 1])
def test_native_host_query_matches(mode):
    jd, td, tb = bvh_pair()
    pts = query_points(2048, 5 + mode)
    got = tnative.sdf_query(tb, pts, mode=mode, n_threads=2)
    np.testing.assert_array_equal(got, jnative.sdf_query(tb, pts, mode=mode, n_threads=2))
    dev_mode = MeshSdfMode.WATERTIGHT if mode == 0 else MeshSdfMode.RAYSTAB
    dev = tgt.signed_distance(td, torch.from_numpy(pts), dev_mode).numpy()
    np.testing.assert_allclose(np.abs(got), np.abs(dev), rtol=1e-5, atol=1e-6)
    far = np.abs(dev) > 1e-4
    np.testing.assert_array_equal(np.sign(got[far]), np.sign(dev[far]))


def test_failed_native_query_build_raises(tmp_path, monkeypatch):
    bad = tmp_path / "sdf_query.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(tnative, "_SDF_SRC", bad)
    monkeypatch.setattr(tnative, "_SDF_SO", tmp_path / "build" / "sdf_query.so")
    monkeypatch.setattr(tnative, "_sdf_lib", None)
    _, _, tb = bvh_pair()
    with pytest.raises(RuntimeError, match="g\\+\\+"):
        tnative.sdf_query(tb, query_points(8))
    monkeypatch.setattr(tnative, "_SDF_SRC", tmp_path / "missing.cpp")
    with pytest.raises(FileNotFoundError):
        tnative.sdf_query(tb, query_points(8))
