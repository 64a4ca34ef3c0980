"""The Takikawa (octree) encoding and its SDF path, port vs the JAX package,
on a sphere beside a box (tests/test_torch_sdf.py's scene) with octrees
of depth 7 (levels 4-6 encoded): the encoding (linear and smoothstep
interpolation, levels concatenated and summed) at rtol 1e-5 / atol 1e-6
(the same f32 operations), its feature and position gradients against
jax.grad at the same tolerance (the features' sums run in another
order), one SdfEngine step on a Takikawa network (loss rtol 1e-4 as
tests/test_torch_sdf.py, gradients as there), the network config rebuilt
from the depth the octree reached, and the raise when that depth does not
exceed starting_level."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sienerf_tpu.engines.sdf import SdfEngine as JSdf
from sienerf_tpu.geom import octree as jo
from sienerf_tpu.models.single_network import apply_single_network as japply
from sienerf_tpu.ops import takikawa as jt
from sienerf_tpu.ops.losses import get_loss as jloss
from sienerf_torch.engines import sdf as sdf_mod
from sienerf_torch.engines.sdf import SdfEngine
from sienerf_torch.geom import octree as to
from sienerf_torch.ops import takikawa as tt
from test_torch_sdf import MLP_TOL, small_config, unit_scene

DEPTH = 7
TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


def _tree():
    return to.build_triangle_octree(unit_scene(), DEPTH)


def _inputs(n=4096, seed=0):
    """Positions: half near the surface (found at every level), half
    uniform (some in no octree cell); features U(-1, 1); an upstream
    gradient."""
    tree = _tree()
    rng = np.random.default_rng(seed)
    cells = tree.level_cells(DEPTH - 1)
    near = (cells[rng.integers(0, len(cells), n // 2)] + rng.random((n // 2, 3))) / (1 << (DEPTH - 1))
    pos = np.concatenate([near, rng.random((n - n // 2, 3))]).astype(np.float32)
    feats = rng.uniform(-1.0, 1.0, (tree.n_vertices, 8)).astype(np.float32)
    return tree, pos, feats, rng


CASES = [("linear", False), ("smoothstep", False), ("linear", True), ("smoothstep", True)]


def _configs(interp, summed):
    kw = dict(depth=DEPTH, starting_level=4, sum_instead_of_concat=summed, interpolation=interp)
    return jt.TakikawaConfig(**kw), tt.TakikawaConfig(**kw)


@pytest.mark.parametrize("interp,summed", CASES)
def test_encoding_matches_the_reference(interp, summed):
    tree, pos, feats, _ = _inputs()
    jcfg, tcfg = _configs(interp, summed)
    want = np.asarray(jt.takikawa_encode(jcfg, jo.octree_device_tables(tree),
                                         jnp.asarray(feats), jnp.asarray(pos)))
    got = tt.takikawa_encode(tcfg, to.octree_device_tables(tree, "cpu"),
                             torch.from_numpy(feats), torch.from_numpy(pos))
    assert got.shape == want.shape == (len(pos), tcfg.n_output_dims)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert (got.numpy() == 0).all(axis=1).mean() < 0.5  # most points lie in a cell


@pytest.mark.parametrize("interp,summed", CASES)
def test_gradients_match_jax_grad(interp, summed):
    tree, pos, feats, rng = _inputs(seed=1)
    jcfg, tcfg = _configs(interp, summed)
    up = rng.normal(size=(len(pos), tcfg.n_output_dims)).astype(np.float32)
    jtab = jo.octree_device_tables(tree)

    def f(fe, p):
        return jnp.sum(jt.takikawa_encode(jcfg, jtab, fe, p) * up)

    jf, jp = jax.grad(f, argnums=(0, 1))(jnp.asarray(feats), jnp.asarray(pos))
    fe = torch.from_numpy(feats).requires_grad_(True)
    p = torch.from_numpy(pos).requires_grad_(True)
    out = tt.takikawa_encode(tcfg, to.octree_device_tables(tree, "cpu"), fe, p)
    (out * torch.from_numpy(up)).sum().backward()
    np.testing.assert_allclose(fe.grad.numpy(), np.asarray(jf), **TOL)
    np.testing.assert_allclose(p.grad.numpy(), np.asarray(jp), rtol=1e-5, atol=1e-4)
    assert float(p.grad.abs().max()) > 1.0 and float(fe.grad.abs().max()) > 0.1


def test_feature_gradient_is_one_sum_order():
    """Two backward passes on the same inputs give the same bits: each
    vertex sums its contributions in one fixed order."""
    tree, pos, feats, _ = _inputs(seed=2)
    _, tcfg = _configs("linear", False)
    tab = to.octree_device_tables(tree, "cpu")
    grads = []
    for _ in range(2):
        fe = torch.from_numpy(feats).requires_grad_(True)
        tt.takikawa_encode(tcfg, tab, fe, torch.from_numpy(pos)).pow(2).sum().backward()
        grads.append(fe.grad)
    assert torch.equal(grads[0], grads[1])


def _takikawa_config(n_levels=DEPTH):
    cfg = small_config()
    cfg["encoding"] = {"otype": "Takikawa", "n_levels": n_levels, "starting_level": 4,
                       "sum_instead_of_concat": False}
    return cfg


def test_one_sdf_step_matches_the_reference():
    eng = SdfEngine.create(_takikawa_config(), unit_scene(), batch_size=1 << 11, device="cpu")
    jeng = JSdf.create(_takikawa_config(), unit_scene(), batch_size=1 << 11)
    assert eng.net.takikawa == tt.TakikawaConfig(**vars(jeng.net.takikawa))
    assert eng.net.takikawa_n_vertices == jeng.net.takikawa_n_vertices
    assert eng.net.mlp.n_input_dims == jeng.net.mlp.n_input_dims == 24
    assert eng.octree_stats["depth"] == DEPTH
    for k, v in eng.tak_tables.items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(jeng.tak_tables[k]))
    state = eng.init(0)
    g = torch.Generator().manual_seed(0)
    for _ in range(2):
        state, _ = eng.train_bundle(state, g)
    params = state["params"]
    jparams = jax.tree.map(lambda t: jnp.asarray(t.numpy()), params)
    pos = jeng._sample_batch_host(np.random.default_rng(5))
    tgt = eng.ground_truth(torch.from_numpy(pos)).numpy()

    def loss_of(p):
        return jnp.mean(jloss("MAPE")(japply(jeng.net, p, jnp.asarray(pos), jeng.tak_tables)[:, 0],
                                      jnp.asarray(tgt)))

    jl, jg = jax.value_and_grad(loss_of)(jparams)
    tl, tg = eng.loss_and_grads(params, torch.from_numpy(pos), torch.from_numpy(tgt))
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-4)
    for got, want in zip(tg["mlp"], jg["mlp"]):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, **MLP_TOL)
        assert np.abs(got.numpy() - want).max() <= 0.02 * np.abs(want).max()
    jd = np.asarray(jg["takikawa"])
    assert np.abs(tg["takikawa"].numpy() - jd).max() <= 0.02 * np.abs(jd).max()
    assert sdf_mod.l2_mask(eng.net, params)["takikawa"] == 0.0


def test_the_config_follows_the_depth_the_octree_reached(monkeypatch):
    """A build that stops at depth 6 of the 8 asked for: the network is
    rebuilt for levels 4-5 (16 inputs), as the reference rebuilds it."""
    def shallow(build):
        return lambda tris, depth: build(tris, depth - 2)

    monkeypatch.setattr(sdf_mod, "build_triangle_octree", shallow(to.build_triangle_octree))
    monkeypatch.setattr(jo, "build_triangle_octree", shallow(jo.build_triangle_octree))
    eng = SdfEngine.create(_takikawa_config(8), unit_scene(), batch_size=1 << 10, device="cpu")
    jeng = JSdf.create(_takikawa_config(8), unit_scene(), batch_size=1 << 10)
    assert eng.net.takikawa.depth == jeng.net.takikawa.depth == 6
    assert eng.net.mlp.n_input_dims == jeng.net.mlp.n_input_dims == 16
    assert eng.net.takikawa_n_vertices == jeng.net.takikawa_n_vertices
    assert eng.init(0)["params"]["takikawa"].shape == (eng.net.takikawa_n_vertices, 8)


def test_an_octree_no_deeper_than_the_starting_level_raises():
    outside = unit_scene() + 2.0  # no child cell of the root touches it
    with pytest.raises(ValueError, match="starting_level"):
        SdfEngine.create(_takikawa_config(), outside, batch_size=1 << 10, device="cpu")
    with pytest.raises(ValueError, match="starting_level"):
        JSdf.create(_takikawa_config(), outside, batch_size=1 << 10)


def test_session_trains_and_renders_a_takikawa_sdf(tmp_path):
    import json

    from sienerf_torch.geom.mesh_io import save_obj
    from sienerf_torch.session import Session
    from sienerf_torch.utils.camera import look_at_matrix

    tri = unit_scene()
    save_obj(tmp_path / "m.obj", tri.reshape(-1, 3), np.arange(3 * len(tri)).reshape(-1, 3))
    (tmp_path / "tak.json").write_text(json.dumps(_takikawa_config()))
    s = Session(device="cpu").load_file(tmp_path / "m.obj", network=tmp_path / "tak.json",
                                        batch_size=1 << 11)
    iou0 = s.calculate_iou(32, 4)
    s.train(64)
    assert s.calculate_iou(32, 4) > iou0
    img = s.render(32, 24, look_at_matrix([1.3, 0.9, -0.5], [0.5] * 3))
    assert img.shape == (24, 32, 4) and bool(torch.isfinite(img).all())
    verts, faces = s.save_mesh(tmp_path / "m_out.obj", resolution=24)
    assert len(verts) > 0 and len(faces) > 0
