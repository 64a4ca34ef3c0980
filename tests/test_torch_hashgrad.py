"""The hash grid's backward and the network's gradients, port vs reference
(cell layout, 4 levels x 2 features, 2^12 rows; 4096 seeded points).

Tolerances:
- d_table against the reference's default mode ("bf16": contributions
  rounded to bf16, summed in bf16): within 2 % of max |d_table|, the
  reference's own bound for bf16 mode against its f32 backward
  (tests/test_hashgrid.py::test_bwd_bf16_mode_close).  The port sums the
  same bf16-rounded contributions in f32.
- d_table against a float64 numpy sum of the same bf16-rounded
  contributions: |d - ref| <= 1e-5 * sum |contribution| of that element
  (f32 summation of at most a few hundred terms).
- d_pos against the reference rtol 1e-4 / atol 1e-6, except where its
  L * 2^D terms cancel (at most 0.1 % of the entries): there within the
  f32 summation bound of both sides, 2 * (terms) * 2^-24 * sum |term|;
  and against finite differences in float64 (torch.autograd.gradcheck).
- Parameter gradients through nerf_apply against jax.grad: MLP matrices
  rtol 1e-2 / atol 1e-3 (a bf16 rounding between layers may flip with the
  f32 summation order, as in tests/test_torch_network.py), and each
  within 2 % of its largest entry; the table within 2 % of max |d|."""

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


def _configs(F=2, L=4, log2=12):
    kw = dict(n_levels=L, n_features_per_level=F, log2_hashmap_size=log2,
              base_resolution=8, per_level_scale=2.0)
    return jhg.HashGridConfig(**kw), thg.HashGridConfig(**kw)


def _inputs(jcfg, seed=0):
    rng = np.random.default_rng(seed)
    table = rng.uniform(-1.0, 1.0, (jcfg.n_levels, jcfg.table_size, 8,
                                    jcfg.n_features_per_level)).astype(np.float32)
    pos = rng.uniform(0.0, 1.0, (N, 3)).astype(np.float32)
    g = rng.normal(size=(N, jcfg.n_output_dims)).astype(np.float32)
    return table, pos, g


def _port_grads(tcfg, table, pos, g, want_pos=True):
    t = torch.from_numpy(table).requires_grad_(True)
    p = torch.from_numpy(pos).requires_grad_(want_pos)
    out = thg.hashgrid_encode(tcfg, t, p)
    grads = torch.autograd.grad(out, [t, p] if want_pos else [t], torch.from_numpy(g))
    return out.detach().numpy(), [x.numpy() for x in grads]


@pytest.mark.parametrize("F", [2, 4])
def test_d_table_and_d_pos_match_the_reference(F):
    jcfg, tcfg = _configs(F)
    table, pos, g = _inputs(jcfg, F)
    out, vjp = jax.vjp(lambda t, p: jhg.hashgrid_encode(jcfg, t, p),
                       jnp.asarray(table), jnp.asarray(pos))
    jd_table, jd_pos = vjp(jnp.asarray(g))
    tout, (d_table, d_pos) = _port_grads(tcfg, table, pos, g)
    np.testing.assert_allclose(tout, np.asarray(out), rtol=1e-5, atol=1e-6)
    jd_table = np.asarray(jd_table)
    assert np.abs(d_table - jd_table).max() <= 0.02 * np.abs(jd_table).max()
    _assert_d_pos_close(jcfg, table, pos, g, d_pos, np.asarray(jd_pos))


def _assert_d_pos_close(jcfg, table, pos, g, got, want):
    """d_pos within rtol 1e-4 / atol 1e-6, except entries where the L * 2^D
    terms of the sum cancel: there both sides carry an f32 summation error
    of up to (terms) * 2^-24 * sum |term| each, in their own order.  At
    most 0.1 % of the entries may need that bound."""
    idx, w, per_dim, offs, scales = (np.asarray(a) if not isinstance(a, np.ndarray) else a
                                     for a in jhg._geometry_cell(jcfg, jnp.asarray(pos)))
    L, F = jcfg.n_levels, jcfg.n_features_per_level
    cf = np.stack([table[l][idx[:, l]] for l in range(L)], axis=1)  # (N, L, C, F)
    fdotg = np.abs((cf * g.reshape(N, L, 1, F)).sum(-1)).astype(np.float64)
    mag = np.stack([(fdotg * np.prod(np.delete(per_dim, d, axis=-1), axis=-1)
                     * scales[None, :, None]).sum(axis=(1, 2)) for d in range(3)], axis=-1)
    summation = 2 * (L * 8 + F) * 2.0 ** -24 * mag
    err = np.abs(got - want)
    plain = 1e-6 + 1e-4 * np.abs(want)
    assert (err <= np.maximum(plain, summation)).all()
    assert (err > plain).mean() <= 1e-3


@pytest.mark.parametrize("F", [2, 4])
def test_d_table_is_the_f32_sum_of_bf16_contributions(F):
    """The same contributions the reference rounds (w * g to bf16),
    summed in float64 by numpy."""
    jcfg, tcfg = _configs(F)
    table, pos, g = _inputs(jcfg, 10 + F)
    _, (d_table,) = _port_grads(tcfg, table, pos, g, want_pos=False)
    idx, w, _, _, _ = jhg._geometry_cell(jcfg, jnp.asarray(pos))
    idx, w = np.asarray(idx), np.asarray(w)
    L, T, C = jcfg.n_levels, jcfg.table_size, 8
    gl = g.reshape(N, L, F)
    ref = np.zeros((L, T, C, F), np.float64)
    mag = np.zeros((L, T, C, F), np.float64)
    for l in range(L):
        c = (w[:, l, :, None] * gl[:, l, None, :]).astype(np.float32)
        c = np.asarray(jnp.asarray(c).astype(jnp.bfloat16).astype(jnp.float32), np.float64)
        np.add.at(ref[l], idx[:, l], c)
        np.add.at(mag[l], idx[:, l], np.abs(c))
    assert (np.abs(d_table - ref) <= 1e-5 * mag).all()
    assert (d_table[mag == 0] == 0).all()
    # the rounding is the reference's: the contributions are not f32 sums
    assert np.abs(d_table - ref).max() < np.abs(ref).max()


def test_d_pos_finite_differences_float64():
    """gradcheck of d_pos in float64 on the plain path, at points more
    than 1e-3 of a cell from every cell face (the cell table is not
    continuous across cells)."""
    jcfg, tcfg = _configs(F=2, L=3, log2=10)
    table, pos, _ = _inputs(jcfg, 3)
    scales = np.asarray([tcfg.level_scale(l) for l in range(tcfg.n_levels)], np.float32)
    x = pos[:, None, :] * scales[None, :, None] + 0.5
    frac = x - np.floor(x)
    pos = pos[((frac > 1e-3) & (frac < 1 - 1e-3)).all(axis=(1, 2))][:24]
    assert len(pos) == 24
    t = torch.from_numpy(table).double()
    p = torch.from_numpy(pos).double().requires_grad_(True)
    assert torch.autograd.gradcheck(lambda q: thg.hashgrid_encode(tcfg, t, q), (p,),
                                    eps=1e-7, atol=1e-6, rtol=1e-5)


def test_no_d_pos_without_requires_grad():
    _, tcfg = _configs()
    jcfg = _configs()[0]
    table, pos, g = _inputs(jcfg, 5)
    t = torch.from_numpy(table).requires_grad_(True)
    p = torch.from_numpy(pos)
    thg.hashgrid_encode(tcfg, t, p).backward(torch.from_numpy(g))
    assert p.grad is None and t.grad is not None


def _tiny_net_config():
    return {
        "encoding": {"otype": "HashGrid", "n_levels": 4, "n_features_per_level": 2,
                     "log2_hashmap_size": 12, "base_resolution": 8},
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
    p = jax.tree.map(np.asarray, jinit(jax.random.PRNGKey(3), jnet))
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
            # weight gradients are bf16 values, as in the reference
            assert torch.equal(tp[name][i].grad.bfloat16().float(), tp[name][i].grad)
    a, b = jg["grid"], tp["grid"].grad.numpy()
    assert np.abs(b - a).max() <= 0.02 * np.abs(a).max()
