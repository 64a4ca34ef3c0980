"""Image mode, port vs reference: the three coordinate samplers, one
training step on the reference's own coordinates, the full-frame render
and the MSE, the in-place optimizer, and Session.load_file -> train ->
render on an EXR written by the port.

Tolerances: samplers exact (the same f32 and uint32 operations); the
step's loss rtol 1e-4; its gradients as tests/test_torch_hashgrad.py
holds nerf_apply's: MLP matrices rtol 1e-2 / atol 1e-3 and each within 2 %
of its largest entry, the table within 2 % of max |d|; the render at the
MLP bound (rtol 1e-2 / atol 1e-3); the in-place optimizer bit-equal to the
functional one."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sienerf_tpu.engines.image import ImageEngine as JImage
from sienerf_tpu.models.single_network import apply_single_network as japply
from sienerf_tpu.ops.grids import bilinear_sample_2d as jbilinear
from sienerf_tpu.ops.losses import get_loss as jloss
from sienerf_torch import convert
from sienerf_torch.engines.image import ImageEngine
from sienerf_torch.ops import optim as toptim
from sienerf_torch.ops.mlp import mlp_apply
from test_torch_single_network import assert_mlp_close

MLP_TOL = dict(rtol=1e-2, atol=1e-3)


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


def small_config(base_resolution=4, per_level_scale=1.7):
    return {
        "loss": {"otype": "L2"},
        "optimizer": {"otype": "ExponentialDecay", "decay_start": 2000, "decay_interval": 1000,
                      "decay_base": 0.5,
                      "nested": {"otype": "Adam", "learning_rate": 1e-2, "beta1": 0.9,
                                 "beta2": 0.99, "epsilon": 1e-15, "l2_reg": 1e-6}},
        "encoding": {"otype": "HashGrid", "n_levels": 8, "n_features_per_level": 2,
                     "log2_hashmap_size": 14, "base_resolution": base_resolution,
                     "per_level_scale": per_level_scale},
        "network": {"otype": "FullyFusedMLP", "activation": "ReLU", "output_activation": "None",
                    "n_neurons": 32, "n_hidden_layers": 2},
    }


def make_target(n=48, c=3):
    y, x = np.meshgrid(np.linspace(0, 1, n), np.linspace(0, 1, n), indexing="ij")
    img = np.stack([0.5 + 0.5 * np.sin(6 * x) * np.cos(4 * y), x * y,
                    0.5 + 0.5 * np.cos(8 * (x - 0.5) * (y - 0.5)), np.ones_like(x)][:c], axis=-1)
    return img.astype(np.float32)


def _pair(batch=2048, seed=0, cfg=None):
    img = make_target()
    cfg = cfg or small_config()
    jeng = JImage.create(cfg, img, batch_size=batch)
    jparams, jopt = jeng.init(seed)
    teng = ImageEngine.create(cfg, img, batch_size=batch, device="cpu")
    # the reference's init with trained-size table values
    rng = np.random.default_rng(seed)
    grid = rng.uniform(-1, 1, np.asarray(jparams["grid"]).shape).astype(np.float32)
    np_p = {"grid": grid, "mlp": [np.asarray(w) for w in jparams["mlp"]]}
    jparams = {"grid": jnp.asarray(grid), "mlp": list(jparams["mlp"])}
    tparams = convert.single_network_from_jax(np_p, teng.net.grid, "cpu")
    return jeng, jparams, jopt, teng, tparams


@pytest.mark.parametrize("sampler", ["halton", "sobol"])
def test_low_discrepancy_samplers_match(sampler):
    jeng, _, _, teng, _ = _pair(batch=4096)
    jeng.sampler = teng.sampler = sampler
    for step in (0, 3):
        want = np.asarray(jeng._sample_coords(None, jnp.int32(step)))
        np.testing.assert_array_equal(teng.draw_coords(None, step).numpy(), want)


def test_texture_fetches_and_stratified_points():
    """nearest_sample_2d (the snap_to_pixel_centers targets) exact against
    the reference; stratified_2d puts sample i in cell (i % g, i // g % g)
    of a g x g grid, jittered inside it."""
    from sienerf_tpu.ops.grids import nearest_sample_2d as jnearest
    from sienerf_torch.ops.grids import nearest_sample_2d
    from sienerf_torch.ops.samplers import stratified_2d

    img = make_target(20, 4)
    uv = np.random.default_rng(3).uniform(-0.1, 1.1, (500, 2)).astype(np.float32)
    np.testing.assert_array_equal(
        nearest_sample_2d(torch.from_numpy(img), torch.from_numpy(uv)).numpy(),
        np.asarray(jnearest(jnp.asarray(img), jnp.asarray(uv))))
    _, _, _, teng, tparams = _pair()
    teng.snap_to_pixel_centers = True
    coords = torch.rand((256, 2), generator=torch.Generator().manual_seed(2))
    np.testing.assert_array_equal(teng.targets(coords).numpy(),
                                  np.asarray(jnearest(jnp.asarray(make_target()),
                                                      jnp.asarray(coords.numpy()))))
    pts = stratified_2d(100, torch.Generator().manual_seed(0)).numpy()
    i = np.arange(100)
    assert ((np.floor(pts * 10) == np.stack([i % 10, i // 10 % 10], -1)).all())


def test_one_training_step_on_the_reference_coordinates():
    # ~9 samples a coarsest cell, as in tests/test_torch_hashgrad.py: the
    # reference sums each cell's contributions in bf16, whose error grows
    # with their number (it passes 2 % of max |d| at 200 a cell)
    jeng, jparams, jopt, teng, tparams = _pair(cfg=small_config(16, 1.5))
    coords = jeng._sample_coords(jax.random.PRNGKey(5), 0)
    target = jbilinear(jeng.image, coords)

    def loss_of(p):
        return jnp.mean(jloss("L2")(japply(jeng.net, p, coords), target))

    jl, jg = jax.value_and_grad(loss_of)(jparams)
    tl, tg = teng.loss_and_grads(tparams, torch.from_numpy(np.array(coords)))
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-4)
    np.testing.assert_array_equal(teng.targets(torch.from_numpy(np.array(coords))).numpy(),
                                  np.asarray(target))
    for got, want in zip(tg["mlp"], jg["mlp"]):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, **MLP_TOL)
        assert np.abs(got.numpy() - want).max() <= 0.02 * np.abs(want).max()
    jd = np.asarray(jg["grid"]).reshape(tg["grid"].shape)
    assert np.abs(tg["grid"].numpy() - jd).max() <= 0.02 * np.abs(jd).max()


def test_in_place_optimizer_equals_the_functional_one(monkeypatch):
    monkeypatch.setattr(toptim, "_CHUNK", 1000)  # several chunks and a ragged last one
    _, _, _, teng, tparams = _pair()
    coords = torch.rand((2048, 2), generator=torch.Generator().manual_seed(1))
    spec = teng.opt
    state = toptim.optim_init(tparams, spec)
    p_ref, s_ref = tparams, state
    p_in = toptim.tree_map(torch.clone, tparams)
    s_in = toptim.tree_map(lambda x: x.clone() if isinstance(x, torch.Tensor) else x, state)
    for _ in range(3):
        _, g = teng.loss_and_grads(p_ref, coords)
        p_ref, s_ref = toptim.optim_step(spec, s_ref, p_ref, g, {"grid": 0.0, "mlp": [1.0] * 3})
        _, g = teng.loss_and_grads(p_in, coords)
        p_new, s_in = toptim.optim_step(spec, s_in, p_in, g, {"grid": 0.0, "mlp": [1.0] * 3},
                                        inplace=True)
        assert p_new["grid"] is p_in["grid"]
    for a, b in zip(toptim.tree_leaves([p_ref, s_ref["m"], s_ref["v"]]),
                    toptim.tree_leaves([p_in, s_in["m"], s_in["v"]])):
        assert torch.equal(a, b)


def test_render_and_mse_match():
    """The render is the network at pixel centres: the reference's network
    on the same centres (assert_mlp_close, op by op: its jitted render may
    contract a multiply-add of the hash encode) and its jitted render's
    MSE."""
    from sienerf_tpu.models.single_network import encode_input as jencode
    from sienerf_torch.models.single_network import encode_input

    jeng, jparams, jopt, teng, tparams = _pair()
    jopt2 = {**jopt, "m": jax.tree.map(jnp.zeros_like, jparams),
             "v": jax.tree.map(jnp.zeros_like, jparams)}
    topt = toptim.optim_init(tparams, teng.opt)
    got = teng.render(tparams, topt, 40, 24)
    assert got.shape == (24, 40, 3)
    x = (np.arange(40, dtype=np.float32) + 0.5) / 40
    y = (np.arange(24, dtype=np.float32) + 0.5) / 24
    u, v = np.meshgrid(x, y, indexing="xy")
    coords = np.stack([u.reshape(-1), v.reshape(-1)], axis=-1)
    feats = encode_input(teng.net, tparams, torch.from_numpy(coords)).numpy()
    jfeats = np.asarray(jencode(jeng.net, jparams, jnp.asarray(coords)))
    want = np.asarray(japply(jeng.net, jparams, jnp.asarray(coords)))
    np.testing.assert_allclose(feats, jfeats, rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(got.reshape(-1, 3).numpy(),
                                  mlp_apply(teng.net.mlp, tparams["mlp"],
                                            torch.from_numpy(feats)).numpy())
    assert_mlp_close(teng.net.mlp, tparams["mlp"], jparams["mlp"], feats, want, jfeats)
    np.testing.assert_allclose(teng.compute_mse(tparams, topt),
                               jeng.compute_mse(jparams, jopt2), rtol=1e-2)


def test_session_trains_an_exr_image(tmp_path):
    from sienerf_torch.io.exr import write_exr
    from sienerf_torch.session import Session

    write_exr(tmp_path / "target.exr", make_target(64, 4))
    (tmp_path / "net.json").write_text(json.dumps(small_config()))
    s = Session(device="cpu")
    s.load_file(tmp_path / "target.exr", network=tmp_path / "net.json", batch_size=2048)
    assert s.mode.value == "image" and s.engine.image.shape == (64, 64, 4)
    psnr0 = s.engine.psnr(s.state["params"], s.state["opt"])
    loss = s.train(150)
    assert np.isfinite(loss) and s.training_step == 150 * 16
    psnr1 = s.engine.psnr(s.state["params"], s.state["opt"])
    assert psnr1 > psnr0 + 8, (psnr0, psnr1)
    out = s.render(32, 32)
    assert out.shape == (32, 32, 4) and bool(torch.isfinite(out).all())
    with pytest.raises(ValueError, match="NeRF-only"):
        s.render(32, 32, renderer="sweep")
