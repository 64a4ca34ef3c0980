"""Port vs reference: an R=16 bake of the fox field.  Scales agree to f32
rounding of the max |feature|, sentinels are identical, and every row is
within 1 LSB of the int16 quantisation unless a rounding, shown here per
vertex, explains it:

- the reference's jitted bake contracts the lattice coordinate
  pos * scale + 0.5 of its hash encode into one fused multiply-add (XLA
  on the CPU), where the port, like the reference run op by op, rounds
  the product first.  At fine levels x is in the thousands, so one f32
  step of x moves the trilinear weights by ~1e-4.  Elsewhere the jitted
  encode differs by f32 steps, which can flip the bf16 rounding of an
  MLP input;
- a hidden activation of the density MLP rounds to a different bf16 in
  the two packages because their f32 sums run in different orders; the
  pre-activations then agree within the f32 summation error bound."""

import numpy as np
import pytest
import torch

from test_torch_snapshot import fox_jax, fox_jax_bake, fox_port_session

R = 16
Rv = R + 1
EPS = float(np.finfo(np.float32).eps)


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


def _bf16(x: np.ndarray) -> np.ndarray:
    return torch.tensor(x).to(torch.bfloat16).float().numpy()


def _bake_trace():
    """Per vertex of the R=16 bake, all cascades concatenated: the port's
    hash encode; the reference's encode run op by op and jitted, as its
    bake runs it; the reference's jitted lattice coordinates beside their
    op-by-op and fused-multiply-add values; the reference's jitted
    features and density-MLP hidden pre-activations."""
    import jax
    import jax.numpy as jnp

    from sienerf_tpu.models.nerf_network import _encode_pos as jax_encode
    from sienerf_tpu.ops.hashgrid import _static_level_data
    from sienerf_tpu.ops.mlp import mlp_apply as jax_mlp
    from sienerf_torch.engines.nerf_baked import _vertex_positions
    from sienerf_torch.models.nerf_network import _encode_pos
    from sienerf_torch.ops.baked import cascade_extent

    jeng, jp, _ = fox_jax()
    s = fox_port_session()
    eng, p = s.engine, s.state["params"]
    amin, adiag = torch.as_tensor(eng.aabb.min), torch.as_tensor(eng.aabb.diag)
    units = []
    for k in range(3):
        lo = 0.5 - 0.5 * cascade_extent(k)
        pos = _vertex_positions(torch.arange(Rv ** 3), R, lo, lo + cascade_extent(k))
        units.append(((pos - amin) / adiag).clamp(0.0, 1.0))
    unit = torch.cat(units)
    u = jnp.asarray(unit.numpy())
    level_scales = _static_level_data(jeng.net.grid)[0]
    un = unit.numpy()[:, None, :]
    enc_jit = jax.jit(lambda q, v: jax_encode(jeng.net, q, v))(jp, u)
    return dict(
        enc=_encode_pos(eng.net, p, unit).numpy(),
        enc_eager=np.asarray(jax_encode(jeng.net, jp, u)),
        enc_jit=np.asarray(enc_jit),
        feats_jit=np.asarray(jax.jit(lambda q, v: jax_mlp(
            jeng.net.density_mlp, q["density_mlp"], jax_encode(jeng.net, q, v)))(jp, u)),
        hidden_jit=np.asarray(jax.jit(lambda e, w: jnp.dot(
            e.astype(jnp.bfloat16), w.astype(jnp.bfloat16),
            preferred_element_type=jnp.float32))(enc_jit, jp["density_mlp"][0])),
        x_jit=np.asarray(jax.jit(lambda v: v[:, None, :] * level_scales[None, :, None] + 0.5)(u)),
        x_eager=un * level_scales[None, :, None] + np.float32(0.5),
        x_fma=(un.astype(np.float64) * level_scales[None, :, None] + 0.5).astype(np.float32),
    )


def test_bake_r16_matches_reference():
    import jax.numpy as jnp

    from sienerf_tpu.ops.baked import quantize_rows as jax_quantize
    from sienerf_torch.convert import baked_grid_from_jax
    from sienerf_torch.ops.mlp import mlp_apply

    jgrid, jmeta = fox_jax_bake(R)
    s = fox_port_session()
    grid, meta = s.engine.bake_features(s.state["params"], s.state["occ"], resolution=R)
    assert meta == jmeta
    ref = baked_grid_from_jax(jgrid, device="cpu")
    assert grid["rows"].dtype == torch.int16 and grid["rows"].shape == (3 * Rv ** 3, 16)
    np.testing.assert_allclose(grid["scale"].numpy(), ref["scale"].numpy(), rtol=1e-6, atol=0)
    rows, jrows = grid["rows"].numpy().astype(np.int32), ref["rows"].numpy().astype(np.int32)
    sent, jsent = rows[:, 0] == -32768, jrows[:, 0] == -32768
    np.testing.assert_array_equal(sent, jsent)
    assert 0 < sent.sum() < sent.size  # both culled and kept vertices

    tr = _bake_trace()
    scale = jgrid["scale"][np.repeat(np.arange(3), Rv ** 3)]

    def codes(feats):
        return np.clip(np.round(feats / scale), -32767, 32767)

    # the trace is the reference bake's own arithmetic: its jitted features
    # quantise to the reference's rows
    q = np.asarray(jax_quantize(jnp.asarray(tr["feats_jit"]), jnp.asarray(scale),
                                jnp.asarray(~jsent), 16)).view(np.int16).reshape(-1, 16)
    np.testing.assert_array_equal(q, jrows)

    # the density MLP alone, both packages on the reference's encode: codes
    # within 1 LSB except where a hidden activation rounds to another bf16,
    # and there the pre-activations agree within the f32 summation bound
    w0 = _bf16(s.state["params"]["density_mlp"][0].numpy())
    x = _bf16(tr["enc_jit"])
    hidden = x @ w0
    flip = _bf16(np.maximum(hidden, 0)) != _bf16(np.maximum(tr["hidden_jit"], 0))
    sum_bound = x.shape[1] * EPS * (np.abs(x) @ np.abs(w0))
    assert (np.abs(hidden - tr["hidden_jit"])[flip] <= sum_bound[flip]).all()
    feats = mlp_apply(s.engine.net.density_mlp, s.state["params"]["density_mlp"],
                      torch.tensor(tr["enc_jit"])).numpy()
    hidden_flip = flip.any(axis=1)
    assert np.abs(codes(feats) - codes(tr["feats_jit"])).max(axis=1)[~hidden_flip].max() <= 1

    # the encode: the port's is the reference's written arithmetic bit for
    # bit; the reference's jitted one takes the lattice coordinate as a
    # fused multiply-add, and elsewhere differs by f32 steps of the sum
    np.testing.assert_array_equal(tr["enc"], tr["enc_eager"])
    np.testing.assert_array_equal(tr["x_jit"], tr["x_fma"])
    x_moved = (tr["x_jit"] != tr["x_eager"]).reshape(len(rows), -1).any(axis=1)
    level_max = np.abs(tr["enc"]).reshape(len(rows), 8, 4).max(axis=(0, 2)).repeat(4)
    assert (np.abs(tr["enc_jit"] - tr["enc"])[~x_moved] <= 8 * EPS * level_max).all()
    input_flip = (_bf16(tr["enc"]) != x).any(axis=1)

    # the whole bake: every row that neither rounding explains is within 1 LSB
    diff = np.abs(rows - jrows).max(axis=1)
    explained = x_moved | input_flip | hidden_flip
    assert diff[~explained & ~sent].max() <= 1
    assert (diff <= 1).mean() >= 0.995


def test_scale_probe_ids_match_linspace():
    import jax.numpy as jnp

    from sienerf_torch.engines.nerf_baked import _scale_probe_ids

    for n in (17 ** 3, 33 ** 3, 257 ** 3):
        want = np.unique(np.asarray(jnp.linspace(0, n - 1, 1 << 18).astype(jnp.int32)))
        np.testing.assert_array_equal(_scale_probe_ids(n, 1 << 18), want)


def test_dilate_matches_reference():
    import jax.numpy as jnp

    from sienerf_tpu.engines.nerf_baked import _dilate3 as jax_dilate
    from sienerf_torch.engines.nerf_baked import _dilate3

    bf = np.random.default_rng(0).random((2, 16, 16, 16)) > 0.97
    np.testing.assert_array_equal(_dilate3(torch.from_numpy(bf)).numpy(),
                                  np.asarray(jax_dilate(jnp.asarray(bf))))
