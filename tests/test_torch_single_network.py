"""The single network (encoding -> MLP) of the image, SDF and volume modes,
port vs reference, on seeded tables, weights and points: 2-D and 3-D hash
grids (the image engine's flat table carried across by
convert.single_network_from_jax), the other encodings, the bf16 render
table, the l2 mask and the config parse.

Tolerances: features rtol 1e-5 / atol 1e-6 (the same f32 operations; only
the corner summation order may differ); MLP outputs rtol 1e-2 / atol 1e-3,
the bf16 compute bound of tests/test_torch_network.py; and where a bf16
layer input rounds the other way in the two packages (a value on a
rounding boundary, moved by the f32 summation order), the row is held
instead with the reference's roundings put into the port
(`assert_mlp_close`, ops/mlp.py::tap_roundings): rtol 1e-4 / atol 1e-5.
The f32 MLP (finite-difference normals) rtol 1e-5 / atol 1e-6."""

import dataclasses
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sienerf_tpu.models import single_network as jsn
from sienerf_tpu.ops import mlp as jmlp
from sienerf_torch import convert
from sienerf_torch.models import single_network as tsn
from sienerf_torch.ops.mlp import mlp_apply, tap_roundings

FEAT_TOL = dict(rtol=1e-5, atol=1e-6)
MLP_TOL = dict(rtol=1e-2, atol=1e-3)
FLIP_TOL = dict(rtol=1e-4, atol=1e-5)


def reference_roundings(cfg, params, feats: np.ndarray) -> list:
    """The reference MLP's bf16-rounded layer inputs, computed layer by
    layer as its mlp_apply does, as f32 tensors in tap_roundings order."""
    act = jmlp._activation_fn(cfg.activation)
    h = jnp.asarray(feats).astype(jnp.bfloat16)
    seen = [h]
    for i, w in enumerate(params):
        h = jnp.dot(h, jnp.asarray(w).astype(jnp.bfloat16), preferred_element_type=jnp.float32)
        if i < len(params) - 1:
            h = act(h).astype(jnp.bfloat16)
            seen.append(h)
    return [torch.from_numpy(np.array(x.astype(jnp.float32))) for x in seen]


def assert_mlp_close(cfg, tparams, jparams, feats: np.ndarray, want: np.ndarray,
                     jfeats: np.ndarray | None = None) -> int:
    """The port's MLP on `feats` against the reference's output `want`
    (from the reference's features `jfeats`, default `feats`): rows whose
    bf16 layer inputs round alike at the MLP bound, the others with the
    reference's roundings put into the port at FLIP_TOL -> the number of
    rows with a flip."""
    x = torch.from_numpy(np.array(feats, np.float32))
    with tap_roundings() as tap:
        got = mlp_apply(cfg, tparams, x).numpy()
    ref = reference_roundings(cfg, jparams, feats if jfeats is None else jfeats)
    flip = np.zeros(len(feats), bool)
    for a, b in zip(tap.seen[:len(ref)], ref):
        flip |= (a != b).any(dim=1).numpy()
    np.testing.assert_allclose(got[~flip], want[~flip], **MLP_TOL)
    if flip.any():
        with tap_roundings(replace=ref + [None]):
            got2 = mlp_apply(cfg, tparams, x).numpy()
        np.testing.assert_allclose(got2[flip], want[flip], **FLIP_TOL)
    return int(flip.sum())


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


def _cfg(otype="HashGrid", **enc):
    e = {"otype": otype, "n_levels": 6, "n_features_per_level": 2, "log2_hashmap_size": 12,
         "base_resolution": 8, "per_level_scale": 1.6, **enc}
    return {"encoding": e, "network": {"n_neurons": 32, "n_hidden_layers": 2}}


def _pair(cfg, d_in, d_out, seed=0, flat=False):
    """A seeded JAX network, its numpy params, and the port's copy."""
    jcfg = jsn.SingleNetworkConfig.from_network_config(cfg, d_in, d_out)
    tcfg = tsn.SingleNetworkConfig.from_network_config(cfg, d_in, d_out)
    jp = jsn.init_single_network(jax.random.PRNGKey(seed), jcfg)
    rng = np.random.default_rng(seed)
    np_p = {"mlp": [np.asarray(w) for w in jp["mlp"]]}
    if "grid" in jp:
        # table values of a trained field's size, not the init's 1e-4
        t = rng.uniform(-1.0, 1.0, jp["grid"].shape).astype(np.float32)
        np_p["grid"] = t.reshape(t.shape[0], -1) if flat else t
    tp = convert.single_network_from_jax(np_p, tcfg.grid, "cpu")
    return jcfg, tcfg, {k: (jnp.asarray(v) if k == "grid" else [jnp.asarray(w) for w in v])
                        for k, v in np_p.items()}, tp


@pytest.mark.parametrize("d_in,flat", [(2, True), (2, False), (3, False)])
def test_hash_grid_network_matches(d_in, flat):
    jcfg, tcfg, jp, tp = _pair(_cfg(), d_in, 4, seed=d_in, flat=flat)
    assert tp["grid"].shape == (6, 1 << 12, 1 << d_in, 2)
    x = np.random.default_rng(7).uniform(0, 1, (2048, d_in)).astype(np.float32)
    jf = np.asarray(jsn.encode_input(jcfg, jp, jnp.asarray(x)))
    tf = tsn.encode_input(tcfg, tp, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(tf, jf, **FEAT_TOL)
    jo = np.asarray(jsn.apply_single_network(jcfg, jp, jnp.asarray(x)))
    assert assert_mlp_close(tcfg.mlp, tp["mlp"], jp["mlp"], tf, jo, jf) < 0.01 * len(x)


def test_bf16_render_table_and_f32_mlp_match():
    from sienerf_tpu.ops.mlp import mlp_apply as jmlp
    from sienerf_torch.ops.mlp import mlp_apply as tmlp

    jcfg, tcfg, jp, tp = _pair(_cfg(), 3, 1, seed=3)
    x = np.random.default_rng(8).uniform(0, 1, (2048, 3)).astype(np.float32)
    jpk = jsn.pack_render_params(jcfg, jp)
    tpk = tsn.pack_render_params(tcfg, tp)
    assert "grid" not in tpk and tpk["grid_bf16"].dtype == torch.bfloat16
    np.testing.assert_allclose(tsn.encode_input(tcfg, tpk, torch.from_numpy(x)).numpy(),
                               np.asarray(jsn.encode_input(jcfg, jpk, jnp.asarray(x))),
                               **FEAT_TOL)
    feats = np.array(jsn.encode_input(jcfg, jp, jnp.asarray(x)))
    jo = np.asarray(jmlp(jcfg.mlp, jp["mlp"], jnp.asarray(feats), compute_dtype=jnp.float32))
    to = tmlp(tcfg.mlp, tp["mlp"], torch.from_numpy(feats), compute_dtype=torch.float32)
    np.testing.assert_allclose(to.numpy(), jo, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("enc", [
    {"otype": "Frequency", "n_frequencies": 6},
    {"otype": "OneBlob", "n_bins": 8},
    {"otype": "TriangleWave", "n_frequencies": 5},
    {"otype": "Identity"},
    {"otype": "Composite", "nested": [{"otype": "Frequency", "n_dims_to_encode": 2,
                                       "n_frequencies": 4}, {"otype": "OneBlob", "n_bins": 4}]},
])
def test_other_encodings_match(enc):
    cfg = {"encoding": enc, "network": {"n_neurons": 32, "n_hidden_layers": 1}}
    jcfg, tcfg, jp, tp = _pair(cfg, 3, 2, seed=4)
    assert tcfg.mlp.n_input_dims == jcfg.mlp.n_input_dims
    x = np.random.default_rng(9).uniform(0, 1, (1024, 3)).astype(np.float32)
    np.testing.assert_allclose(tsn.encode_input(tcfg, tp, torch.from_numpy(x)).numpy(),
                               np.asarray(jsn.encode_input(jcfg, jp, jnp.asarray(x))),
                               rtol=1e-5, atol=1e-5)
    jo = np.asarray(jsn.apply_single_network(jcfg, jp, jnp.asarray(x)))
    assert_mlp_close(tcfg.mlp, tp["mlp"], jp["mlp"],
                     tsn.encode_input(tcfg, tp, torch.from_numpy(x)).numpy(), jo,
                     np.asarray(jsn.encode_input(jcfg, jp, jnp.asarray(x))))


def test_init_l2_mask_and_takikawa():
    tcfg = tsn.SingleNetworkConfig.from_network_config(_cfg(), 2, 3)
    p = tsn.init_single_network(tcfg, torch.Generator().manual_seed(0))
    assert p["grid"].shape == (6, 1 << 12, 4, 2)
    assert float(p["grid"].abs().max()) <= 1e-4
    assert [tuple(w.shape) for w in p["mlp"]] == [(12, 32), (32, 32), (32, 3)]
    jcfg = jsn.SingleNetworkConfig.from_network_config(_cfg(), 2, 3)
    jmask = jsn.l2_mask(jcfg, jsn.init_single_network(jax.random.PRNGKey(0), jcfg))
    assert tsn.l2_mask(tcfg, p) == jmask
    # the Takikawa encoding: the config as the reference reads it (its final
    # depth and vertex count come from the SDF engine's octree), its init,
    # its l2 mask, and the tables it needs to encode
    enc = {"otype": "Takikawa", "n_levels": 7, "starting_level": 3}
    tk = tsn.SingleNetworkConfig.from_network_config({"encoding": enc}, 3, 1)
    jk = jsn.SingleNetworkConfig.from_network_config({"encoding": enc}, 3, 1)
    assert vars(tk.takikawa) == vars(jk.takikawa)
    assert tk.mlp.n_input_dims == jk.mlp.n_input_dims == 32
    tk = dataclasses.replace(tk, takikawa_n_vertices=50)
    pk = tsn.init_single_network(tk, torch.Generator().manual_seed(0))
    assert pk["takikawa"].shape == (50, 8) and float(pk["takikawa"].abs().max()) <= 1e-4
    jk = dataclasses.replace(jk, takikawa_n_vertices=50)
    assert tsn.l2_mask(tk, pk) == jsn.l2_mask(jk, jsn.init_single_network(
        jax.random.PRNGKey(0), jk))
    with pytest.raises(ValueError, match="tables"):
        tsn.encode_input(tk, pk, torch.zeros((4, 3)))
