"""K1 for every colour MLP of configs/nerf/: the port's plain shade against
the JAX package's XLA shade prep (`_shade_planes`) and its Pallas shade
kernel (interpret mode; with its halved density on the lattice faces
j = R and k = R, see the test) at R=8, at the reference's tolerance
rtol 2e-2 / atol 2e-3 (tests/test_shade_pallas.py); the kernel's weight packing for
each shape; the sweep frame's eligibility test against the JAX package's
on every repo config; and the route of a network the kernel does not take
(the plain shade, then K2) against the JAX package's XLA-prep frame.

The inputs come from a numpy seed: random int16 bake rows (30 % culled),
per-cascade scales and He-scaled weights of each config's shapes."""

import functools
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_nerf_mode import make_dataset, tiny_config

CONFIGS = sorted((Path(__file__).resolve().parent.parent / "configs" / "nerf").glob("*.json"))
R, K = 8, 2
CAM = np.asarray([0.1, 1.4, -0.6], np.float32)
TOL = dict(rtol=2e-2, atol=2e-3)


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


def _load(path):
    from sienerf_torch.utils.config import load_network_config

    return load_network_config(path)


def _rgb_shapes():
    """Each distinct colour-MLP weight-shape list of the repo's configs,
    with the first config that has it."""
    from sienerf_torch.models.nerf_network import NerfNetworkConfig
    from sienerf_torch.ops.mlp import mlp_layer_dims

    seen = {}
    for p in CONFIGS:
        net = NerfNetworkConfig.from_network_config(_load(p))
        seen.setdefault(tuple(mlp_layer_dims(net.rgb_mlp)), p.stem)
    return seen


SHAPES = _rgb_shapes()


def test_the_configs_hold_five_colour_mlps():
    assert sorted(SHAPES.values()) == ["base", "base_0layer", "base_1layer", "base_3layer",
                                       "big"]


def _inputs(shapes, seed):
    rng = np.random.default_rng(seed)
    Rv = R + 1
    rows = rng.integers(-32767, 32768, (K * Rv ** 3, 16)).astype(np.int16)
    rows[rng.random(K * Rv ** 3) < 0.3] = -32768
    scale = rng.uniform(2e-5, 2e-4, (K, 16)).astype(np.float32)
    ws = [rng.normal(0.0, 1.0 / np.sqrt(a), (a, b)).astype(np.float32) for a, b in shapes]
    return rows, scale, ws


@pytest.mark.parametrize("shapes", list(SHAPES), ids=list(SHAPES.values()))
def test_plain_shade_matches_the_pallas_kernel_and_the_xla_prep(shapes):
    from sienerf_tpu.engines.nerf_sweep import prepare_rgba_volume as jax_prep
    from sienerf_tpu.models.nerf_network import NerfNetworkConfig as JaxNet
    from sienerf_tpu.ops.shade_pallas import build_fieldmajor_planes, shade_volume_pallas
    from sienerf_tpu.utils.config import load_network_config as jload
    from sienerf_torch.common import NerfActivation
    from sienerf_torch.models.nerf_network import NerfNetworkConfig
    from sienerf_torch.ops.shade import _shade_general, shade_volume, shade_volume_plain

    path = next(p for p in CONFIGS if p.stem == SHAPES[shapes])
    rows, scale, ws = _inputs(shapes, seed=len(shapes) + shapes[0][1])
    Rv = R + 1
    rows32 = jnp.asarray(rows.view(np.int32))
    jws = tuple(jnp.asarray(w) for w in ws)
    want_k = shade_volume_pallas(
        build_fieldmajor_planes(rows32, R, K), jnp.asarray(scale), jnp.asarray(CAM), jws,
        resolution=R, n_cascades=K, block=384 * 384 // 2, density_act="exponential",
        rgb_act="logistic", interpret=True)
    want_k = np.asarray(want_k, np.float32)[:, :, :, :Rv, :Rv]
    jeng = types.SimpleNamespace(net=JaxNet.from_network_config(jload(path)))
    want_x = jax_prep(jeng, {"rgb_mlp": list(jws)}, rows32, jnp.asarray(scale),
                      jnp.asarray(CAM), R, K)
    want_x = np.asarray(want_x, np.float32).transpose(0, 1, 4, 2, 3)

    net = NerfNetworkConfig.from_network_config(_load(path))
    t = [torch.from_numpy(w) for w in ws]
    kw = dict(resolution=R, n_cascades=K, density_act=NerfActivation.EXPONENTIAL,
              rgb_act=NerfActivation.LOGISTIC)
    got = shade_volume_plain(torch.from_numpy(rows), torch.from_numpy(scale),
                             torch.from_numpy(CAM), t, rgb_mlp=net.rgb_mlp, **kw)
    assert got.shape == (K, Rv, 4, Rv, Rv) and got.stride(2) == 1
    np.testing.assert_allclose(got.float().numpy(), want_x, **TOL)
    # The Pallas kernel masks its 384-padded planes with clip(R + 0.5 - j)
    # and clip(R + 0.5 - k), which is 0.5, not 1, on the faces j = R and
    # k = R: it halves the density (and the premultiplied colour) there,
    # where its own spec, the XLA prep, does not.  The port follows the
    # XLA prep; against the Pallas kernel, the faces carry that factor.
    face = np.clip(R + 0.5 - np.arange(Rv), 0.0, 1.0)
    np.testing.assert_allclose(got.float().numpy() * face[:, None] * face[None, :], want_k,
                               **TOL)
    assert float(got[:, :, 3].float().max()) > 0.5  # not an empty volume
    # the wrapper on CPU tensors is the plain version, whatever the shape
    n0 = shade_volume.launches
    same = shade_volume(torch.from_numpy(rows), torch.from_numpy(scale),
                        torch.from_numpy(CAM), t, rgb_mlp=net.rgb_mlp, **kw)
    assert torch.equal(same, got) and shade_volume.launches == n0
    # so is the general path's entry, with the MLP taken from the weights
    gen = _shade_general(torch.from_numpy(rows), torch.from_numpy(scale),
                         torch.from_numpy(CAM), t, **kw)
    assert torch.equal(gen, got) and shade_volume.launches == n0


@pytest.mark.parametrize("shapes", list(SHAPES) + [((32, 40), (40, 40), (40, 3)),
                                                  ((32, 16), (16, 3))],
                         ids=list(SHAPES.values()) + ["w40", "w16"])
def test_packed_weights_unpack_for_every_shape(shapes):
    """Each layer's input is padded to the previous layer's padded output,
    a hidden width to a multiple of 16, the output layer to 8 columns,
    all with zeros (the JAX kernel's padding, shade_pallas.py:247-254)."""
    from sienerf_torch.ops.shade import pack_shade_weights, shade_mlp_layout, unpack_shade_weights

    _, _, ws = _inputs(shapes, seed=3)
    t = [torch.from_numpy(w) for w in ws]
    n_hidden, width = shade_mlp_layout(shapes)
    packed = pack_shade_weights(t)
    k_pads = [32] + [width] * n_hidden
    n_vals = sum(kp * width for kp in k_pads[:-1]) + k_pads[-1] * 8
    assert n_hidden == len(shapes) - 1 and width % 16 == 0 and packed.numel() == n_vals
    for w, u in zip(t, unpack_shade_weights(packed, shapes)):
        assert torch.equal(w.to(torch.bfloat16), u)
    nonzero = sum(int((w != 0).sum()) for w in t)
    assert int((packed != 0).sum()) == nonzero  # the padding is zero


def test_the_kernel_refuses_other_shapes():
    from sienerf_torch.ops.shade import shade_mlp_layout

    for bad in (((16, 64), (64, 3)), ((32, 64), (64, 4)), ((32, 64), (64, 32), (32, 3)),
                ((32, 64), (32, 3))):
        with pytest.raises(ValueError, match="colour MLP"):
            shade_mlp_layout(bad)


def _variants():
    """Every repo config, and configs the kernel does not take."""
    out = {p.stem: _load(p) for p in CONFIGS}
    base = _load(next(p for p in CONFIGS if p.stem == "base"))
    sh3 = dict(base, dir_encoding={"otype": "Composite", "nested": [
        {"n_dims_to_encode": 3, "otype": "SphericalHarmonics", "degree": 3},
        {"otype": "Identity"}]})
    out["sh3"] = sh3
    out["tanh"] = dict(base, rgb_network=dict(base["rgb_network"], activation="Tanh"))
    out["out_relu"] = dict(base, rgb_network=dict(base["rgb_network"], output_activation="ReLU"))
    return out


def test_eligibility_equals_the_reference_on_every_config():
    from sienerf_tpu.engines.nerf_sweep import _fused_prep_eligible as jax_eligible
    from sienerf_tpu.models.nerf_network import NerfNetworkConfig as JaxNet
    from sienerf_torch.engines.nerf_sweep import _fused_prep_eligible
    from sienerf_torch.models.nerf_network import NerfNetworkConfig

    jgrid = {"rows": jnp.zeros((4, 8), jnp.int32)}
    grid = {"rows": torch.zeros((4, 16), dtype=torch.int16)}
    got = {}
    for name, cfg in _variants().items():
        want = jax_eligible(types.SimpleNamespace(net=JaxNet.from_network_config(cfg)), jgrid)
        got[name] = _fused_prep_eligible(
            types.SimpleNamespace(net=NerfNetworkConfig.from_network_config(cfg)), grid)
        assert got[name] == want, name
    assert sum(got.values()) == len(CONFIGS)  # every repo config goes through K1
    assert not (got["sh3"] or got["tanh"] or got["out_relu"])


@functools.lru_cache(maxsize=1)
def _sh3_scene():
    """A JAX engine with an SH-degree-3 network (which K1 does not take),
    its seeded init and its R=16 bake, and the port's engine with the same
    params and bake."""
    from sienerf_tpu.engines.nerf import NerfEngine as JaxEngine
    from sienerf_tpu.engines.nerf_baked import bake_feature_grid
    from sienerf_torch.convert import baked_grid_from_jax, params_from_jax
    from sienerf_torch.engines.nerf import NerfEngine
    from test_torch_train import port_dataset

    cfg = tiny_config()
    cfg["dir_encoding"] = {"otype": "Composite", "nested": [
        {"n_dims_to_encode": 3, "otype": "SphericalHarmonics", "degree": 3},
        {"otype": "Identity"}]}
    ds = make_dataset()
    jeng = JaxEngine.create(cfg, ds, grid_size=32)
    st = jeng.init(0)
    bitfield = jnp.ones_like(st["occ"]["bitfield"])
    fn = jax.jit(lambda p, b: bake_feature_grid(jeng, p, b, 16, bricks=False)[0])
    jg = fn(st["params"], bitfield)
    jgrid = {"rows": np.asarray(jg["rows"]), "scale": np.asarray(jg["scale"])}
    meta = {"resolution": 16, "mode": "nearest", "n_cascades": int(bitfield.shape[0])}
    eng = NerfEngine.create(cfg, port_dataset(ds), grid_size=32, device="cpu")
    params = params_from_jax(jax.tree.map(np.asarray, st["params"]), device="cpu")
    return jeng, st["params"], jgrid, eng, params, baked_grid_from_jax(jgrid, "cpu"), meta


@pytest.mark.parametrize("eye", [(0.5, 0.5, -1.6), (2.1, 0.5, 0.6)])
def test_the_ineligible_route_gives_the_reference_frame(eye):
    from sienerf_tpu.engines.nerf_sweep import render_frame_sweep as jax_frame
    from sienerf_torch.engines.nerf_sweep import _fused_prep_eligible, render_frame_sweep
    from sienerf_torch.ops.shade import shade_volume
    from sienerf_torch.utils.camera import look_at_matrix

    jeng, jparams, jgrid, eng, params, grid, meta = _sh3_scene()
    assert not _fused_prep_eligible(eng, grid)
    cam = look_at_matrix(list(eye), [0.5, 0.5, 0.5])
    focal = (40.0, 40.0)
    want, wdepth = jax_frame(jeng, jparams, {k: jnp.asarray(v) for k, v in jgrid.items()}, meta,
                             cam, focal, width=48, height=40, impl="xla")
    n0 = shade_volume.launches
    got, depth = render_frame_sweep(eng, params, grid, meta, cam, focal, width=48, height=40)
    assert shade_volume.launches == n0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-2, atol=5e-3)
    assert float(got[..., 3].mean()) > 0.05
