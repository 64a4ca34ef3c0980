"""The corner table layout's backward (tcnn's vertex table (L, T, F), the
layout of imported .ingp fields and of configs with `encoding.layout:
"corner"`), port vs reference, on seeded tables, points and output
gradients; then the corner layout through the NeRF network and the single
network of the image, SDF and volume modes; and hashgrid_stats (the Session's corner trainers and .ingp
training: tests/test_torch_corner_train.py).

Tolerances:
- d_table against jax.vjp of the reference's corner encode (an f32 sorted
  segment sum of the unrounded contributions w * g): rtol 1e-5 / atol
  1e-6 x max |d_table| (the same f32 terms, summed in another order).
- d_pos against the reference at tests/test_torch_hashgrad.py's rtol 1e-4
  / atol 1e-6, except where the L * 2^D terms of an entry cancel: there
  within the f32 summation bound of both sides, 2 * (terms) * 2^-24 *
  sum |term|.  Independent random vertex values cancel more often than
  the cell test's rows: at most 0.5 % of the entries may need that bound
  (0.09-0.25 % do here); and against finite differences in float64.
- Two backward calls: bit-equal (the fixed-order sum).
- Parameter gradients through nerf_apply and apply_single_network: as in
  tests/test_torch_hashgrad.py (MLP rtol 1e-2 / atol 1e-3 and 2 % of each
  leaf's largest entry; the table within 2 % of max |d|: its upstream
  gradient passes the bf16 MLP).
- hashgrid_stats: equal (the same numpy calls on the same values)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sienerf_tpu.ops import hashgrid as jhg
from sienerf_torch.ops import hashgrid as thg

N = 4096


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


def _configs(D=3, F=2, L=4, log2=12, base=8):
    kw = dict(n_dims=D, n_levels=L, n_features_per_level=F, log2_hashmap_size=log2,
              base_resolution=base, per_level_scale=2.0, layout="corner")
    return jhg.HashGridConfig(**kw), thg.HashGridConfig(**kw)


def _inputs(tcfg, seed=0, n=N):
    rng = np.random.default_rng(seed)
    table = rng.uniform(-1.0, 1.0, (tcfg.n_levels, tcfg.table_size,
                                    tcfg.n_features_per_level)).astype(np.float32)
    pos = rng.uniform(0.0, 1.0, (n, tcfg.n_dims)).astype(np.float32)
    g = rng.normal(size=(n, tcfg.n_output_dims)).astype(np.float32)
    return table, pos, g


def _port_grads(tcfg, table, pos, g, want_pos=True, flat=False):
    t = torch.from_numpy(table.reshape(table.shape[0], -1) if flat else table)
    t.requires_grad_(True)
    p = torch.from_numpy(pos).requires_grad_(want_pos)
    out = thg.hashgrid_encode(tcfg, t, p)
    grads = torch.autograd.grad(out, [t, p] if want_pos else [t], torch.from_numpy(g))
    return out.detach().numpy(), [x.numpy() for x in grads]


def _assert_d_pos_close(jcfg, table, pos, g, got, want):
    idx, w, per_dim, _, scales = (np.asarray(a) for a in jhg._geometry(jcfg, jnp.asarray(pos)))
    L, F, D = jcfg.n_levels, jcfg.n_features_per_level, jcfg.n_dims
    C, n = 1 << D, pos.shape[0]
    cf = table.reshape(L * jcfg.table_size, F)[idx].reshape(n, L, C, F)
    fdotg = np.abs((cf * g.reshape(n, L, 1, F)).sum(-1)).astype(np.float64)
    mag = np.stack([(fdotg * np.prod(np.delete(per_dim, d, axis=-1), axis=-1)
                     * scales[None, :, None]).sum(axis=(1, 2)) for d in range(D)], axis=-1)
    summation = 2 * (L * C + F) * 2.0 ** -24 * mag
    err = np.abs(got - want)
    plain = 1e-6 + 1e-4 * np.abs(want)
    assert (err <= np.maximum(plain, summation)).all()
    assert (err > plain).mean() <= 5e-3


# (D, F, L, log2 T, base resolution): 3-D with F = 2 and 2-D with F = 4,
# each with dense and hashed levels
CASES = [(3, 2, 4, 12, 8), (2, 4, 6, 10, 8)]


@pytest.mark.parametrize("D,F,L,log2,base", CASES)
def test_d_table_and_d_pos_match_the_reference(D, F, L, log2, base):
    jcfg, tcfg = _configs(D, F, L, log2, base)
    dense = [tcfg.level_is_dense(l) for l in range(L)]
    assert any(dense) and not all(dense)
    table, pos, g = _inputs(tcfg, seed=D * 10 + F)
    out, vjp = jax.vjp(lambda t, p: jhg.hashgrid_encode(jcfg, t, p),
                       jnp.asarray(table), jnp.asarray(pos))
    jd_table, jd_pos = (np.asarray(a) for a in vjp(jnp.asarray(g)))
    tout, (d_table, d_pos) = _port_grads(tcfg, table, pos, g)
    np.testing.assert_allclose(tout, np.asarray(out), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(d_table, jd_table, rtol=1e-5,
                               atol=1e-6 * np.abs(jd_table).max())
    _assert_d_pos_close(jcfg, table, pos, g, d_pos, jd_pos)
    # the 2-D flattening (L, T*F) takes the same gradient, in its shape
    _, (d_flat, _) = _port_grads(tcfg, table, pos, g, flat=True)
    assert d_flat.shape == (L, tcfg.table_size * F)
    np.testing.assert_array_equal(d_flat.reshape(d_table.shape), d_table)
    # the fixed order: a second call gives the same bits
    _, (d_table2, d_pos2) = _port_grads(tcfg, table, pos, g)
    np.testing.assert_array_equal(d_table2, d_table)
    np.testing.assert_array_equal(d_pos2, d_pos)


def test_d_table_is_not_rounded_to_bf16():
    """The corner backward sums the f32 contributions: a float64 numpy sum
    of the same terms sits within the f32 summation bound, far below a
    bf16 rounding of each term."""
    jcfg, tcfg = _configs(log2=10)
    table, pos, g = _inputs(tcfg, 7)
    _, (d_table,) = _port_grads(tcfg, table, pos, g, want_pos=False)
    idx, w, _, _, _ = (np.asarray(a) for a in jhg._geometry(jcfg, jnp.asarray(pos)))
    L, F, T = tcfg.n_levels, tcfg.n_features_per_level, tcfg.table_size
    c = (w.reshape(-1, 1).astype(np.float64)
         * np.repeat(g.reshape(N, L, 1, F), 8, axis=2).reshape(-1, F))
    ref, mag = np.zeros((L * T, F)), np.zeros((L * T, F))
    np.add.at(ref, idx, c)
    np.add.at(mag, idx, np.abs(c))
    err = np.abs(d_table.reshape(L * T, F) - ref)
    assert (err <= 1e-6 * mag + 1e-12).all()
    assert (d_table.reshape(L * T, F)[mag == 0] == 0).all()


def test_d_pos_finite_differences_float64():
    """gradcheck of d_pos in float64, at points more than 1e-3 of a cell
    from every cell face (the interpolation's derivative jumps there)."""
    _, tcfg = _configs(F=2, L=3, log2=10)
    table, pos, _ = _inputs(tcfg, 3)
    scales = np.asarray([tcfg.level_scale(l) for l in range(tcfg.n_levels)], np.float32)
    x = pos[:, None, :] * scales[None, :, None] + 0.5
    frac = x - np.floor(x)
    pos = pos[((frac > 1e-3) & (frac < 1 - 1e-3)).all(axis=(1, 2))][:24]
    assert len(pos) == 24
    t = torch.from_numpy(table).double()
    p = torch.from_numpy(pos).double().requires_grad_(True)
    assert torch.autograd.gradcheck(lambda q: thg.hashgrid_encode(tcfg, t, q), (p,),
                                    eps=1e-7, atol=1e-6, rtol=1e-5)


def test_no_d_pos_without_requires_grad_and_packed_tables_refuse():
    _, tcfg = _configs()
    table, pos, g = _inputs(tcfg, 5)
    t = torch.from_numpy(table).requires_grad_(True)
    p = torch.from_numpy(pos)
    thg.hashgrid_encode(tcfg, t, p).backward(torch.from_numpy(g))
    assert p.grad is None and t.grad is not None and t.grad.shape == t.shape
    # as the JAX package asserts: the packed render tables are cell-only
    for pack in (thg.pack_table_bf16, thg.pack_table_fp8):
        with pytest.raises(NotImplementedError, match="cell layout"):
            pack(tcfg, t.detach())


@pytest.mark.parametrize("layout", ["cell", "corner"])
def test_hashgrid_stats_match(layout):
    kw = dict(n_levels=4, n_features_per_level=2, log2_hashmap_size=10, base_resolution=4,
              layout=layout)
    jcfg, tcfg = jhg.HashGridConfig(**kw), thg.HashGridConfig(**kw)
    shape = (4, 1 << 10, 8, 2) if layout == "cell" else (4, 1 << 10, 2)
    table = np.random.default_rng(1).normal(size=shape).astype(np.float32)
    table[1, :100] = 0.0
    want = jhg.hashgrid_stats(jcfg, jnp.asarray(table), n_bins=16)
    assert thg.hashgrid_stats(tcfg, torch.from_numpy(table), n_bins=16) == want
    assert thg.hashgrid_stats(tcfg, table, n_bins=16) == want


def _tiny_net_config(layout="corner"):
    return {
        "encoding": {"otype": "HashGrid", "n_levels": 4, "n_features_per_level": 2,
                     "log2_hashmap_size": 12, "base_resolution": 8, "layout": layout},
        "network": {"n_neurons": 32, "n_hidden_layers": 1},
        "dir_encoding": {"otype": "Composite", "nested": [
            {"n_dims_to_encode": 3, "otype": "SphericalHarmonics", "degree": 4},
            {"otype": "Identity"}]},
        "rgb_network": {"n_neurons": 32, "n_hidden_layers": 2},
    }


def test_param_gradients_through_nerf_apply_match_jax_grad():
    from sienerf_tpu.models.nerf_network import NerfNetworkConfig as JNet
    from sienerf_tpu.models.nerf_network import init_nerf_network as jinit
    from sienerf_tpu.models.nerf_network import nerf_apply as japply
    from sienerf_torch.convert import params_from_jax
    from sienerf_torch.models.nerf_network import NerfNetworkConfig, nerf_apply
    from sienerf_torch.ops.optim import tree_map

    cfg = _tiny_net_config()
    jnet, tnet = JNet.from_network_config(cfg), NerfNetworkConfig.from_network_config(cfg)
    assert tnet.grid.layout == "corner"
    p = jax.tree.map(np.asarray, jinit(jax.random.PRNGKey(3), jnet))
    assert p["grid"].shape == (4, 1 << 12, 2)
    rng = np.random.default_rng(4)
    p["grid"] = rng.uniform(-0.5, 0.5, p["grid"].shape).astype(np.float32)
    pos = rng.uniform(0.0, 1.0, (N, 3)).astype(np.float32)
    d = rng.normal(size=(N, 3))
    dirw = ((d / np.linalg.norm(d, axis=1, keepdims=True) + 1.0) * 0.5).astype(np.float32)
    wr = rng.normal(size=(N, 3)).astype(np.float32)
    wd = rng.normal(size=(N,)).astype(np.float32)

    def jloss(params):
        rgb, dens = japply(jnet, params, jnp.asarray(pos), jnp.asarray(dirw))
        return jnp.sum(jax.nn.sigmoid(rgb) * wr) + jnp.sum(jnp.exp(dens) * wd)

    jg = jax.tree.map(np.asarray, jax.grad(jloss)(jax.tree.map(jnp.asarray, p)))
    tp = tree_map(lambda t: t.requires_grad_(True), params_from_jax(p, device="cpu"))
    rgb, dens = nerf_apply(tnet, tp, torch.from_numpy(pos), torch.from_numpy(dirw))
    loss = (torch.sigmoid(rgb) * torch.from_numpy(wr)).sum() \
        + (torch.exp(dens) * torch.from_numpy(wd)).sum()
    loss.backward()
    for name in ("density_mlp", "rgb_mlp"):
        for i, (a, b) in enumerate(zip(jg[name], tp[name])):
            b = b.grad.numpy()
            np.testing.assert_allclose(b, a, rtol=1e-2, atol=1e-3, err_msg=f"{name}[{i}]")
            assert np.abs(b - a).max() <= 0.02 * np.abs(a).max(), f"{name}[{i}]"
    a, b = jg["grid"], tp["grid"].grad.numpy()
    assert b.shape == a.shape
    assert np.abs(b - a).max() <= 0.02 * np.abs(a).max()


def test_single_network_gradients_match_jax_grad():
    """The image / SDF / volume network (models/single_network.py) on a
    2-D corner-layout grid: the parameter gradients of a loss through
    apply_single_network against jax.grad, from the image engine's flat
    (L, T*F) table carried across by convert.single_network_from_jax."""
    from sienerf_tpu.models import single_network as jsn
    from sienerf_torch import convert
    from sienerf_torch.models import single_network as tsn
    from sienerf_torch.ops.optim import tree_map

    cfg = {"encoding": {"otype": "HashGrid", "n_levels": 6, "n_features_per_level": 2,
                        "log2_hashmap_size": 12, "base_resolution": 8,
                        "per_level_scale": 1.6, "layout": "corner"},
           "network": {"n_neurons": 32, "n_hidden_layers": 2}}
    jcfg = jsn.SingleNetworkConfig.from_network_config(cfg, 2, 3)
    tcfg = tsn.SingleNetworkConfig.from_network_config(cfg, 2, 3)
    assert tcfg.grid.layout == "corner"
    jp = jsn.init_single_network(jax.random.PRNGKey(2), jcfg)
    rng = np.random.default_rng(2)
    grid = rng.uniform(-1.0, 1.0, np.asarray(jp["grid"]).shape).astype(np.float32)
    np_p = {"grid": grid.reshape(grid.shape[0], -1), "mlp": [np.asarray(w) for w in jp["mlp"]]}
    tp = tree_map(lambda t: t.requires_grad_(True),
                  convert.single_network_from_jax(np_p, tcfg.grid, "cpu"))
    assert tp["grid"].shape == (6, 1 << 12, 2)
    x = rng.uniform(0.0, 1.0, (N, 2)).astype(np.float32)
    wt = rng.normal(size=(N, 3)).astype(np.float32)

    def jloss(p):
        return jnp.sum(jsn.apply_single_network(jcfg, p, jnp.asarray(x)) * wt)

    jg = jax.grad(jloss)({k: (jnp.asarray(v) if k == "grid" else [jnp.asarray(w) for w in v])
                          for k, v in np_p.items()})
    (tsn.apply_single_network(tcfg, tp, torch.from_numpy(x)) * torch.from_numpy(wt)).sum() \
        .backward()
    for i, (a, b) in enumerate(zip(jg["mlp"], tp["mlp"])):
        a, b = np.asarray(a), b.grad.numpy()
        np.testing.assert_allclose(b, a, rtol=1e-2, atol=1e-3, err_msg=f"mlp[{i}]")
        assert np.abs(b - a).max() <= 0.02 * np.abs(a).max(), f"mlp[{i}]"
    a = np.asarray(jg["grid"]).reshape(tp["grid"].shape)
    assert np.abs(tp["grid"].grad.numpy() - a).max() <= 0.02 * np.abs(a).max()
