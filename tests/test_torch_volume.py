"""Volume mode, port vs reference, on a synthetic shell (32^3) with a
small network (6 levels, 2^14 rows): the grid's targets, one training step
on the reference's positions, delta tracking on the reference's own
random draws (the grid's density and the network's), a frame, and
Session.load_file -> train -> render on an .nvdb written by the port.

Tolerances: targets rtol 1e-5 / atol 1e-6 (the same f32 operations; XLA
may contract a multiply-add); the step's loss rtol 1e-4, its gradients as
tests/test_torch_hashgrad.py (MLP matrices rtol 1e-2 / atol 1e-3 and
within 2 % of their largest entry, the table within 2 % of max |d|).
Delta tracking on the same draws: hit masks exact except rays whose
acceptance uniform lies within 1e-4 of sigma / majorant at a collision
(a rounding apart), counted and bounded (<= 0.5 %); the grid's colours
rtol 1e-5 / atol 1e-6, the network's at the MLP bound (rtol 1e-2 / atol
1e-3) where the hits agree."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sienerf_tpu.engines.volume import VolumeEngine as JVolume
from sienerf_tpu.io.nanovdb import synthetic_fog_volume as jsynth
from sienerf_torch.engines.volume import VolumeEngine
from sienerf_torch.io.nanovdb import synthetic_fog_volume, write_nanovdb
from sienerf_torch.utils.camera import look_at_matrix

MLP_TOL = dict(rtol=1e-2, atol=1e-3)
CAM = look_at_matrix([0.5, 0.5, -1.5], [0.5, 0.5, 0.5])


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


def small_config():
    return {
        "loss": {"otype": "L2"},
        "optimizer": {"otype": "Adam", "learning_rate": 1e-2, "epsilon": 1e-15},
        "encoding": {"otype": "HashGrid", "n_levels": 6, "n_features_per_level": 2,
                     "log2_hashmap_size": 14, "base_resolution": 8, "per_level_scale": 1.8},
        "network": {"n_neurons": 32, "n_hidden_layers": 2},
    }


@pytest.fixture(scope="module")
def fitted():
    """The port fitted for 4 bundles; the reference on the same volume and
    params."""
    torch.set_num_threads(2)
    vol = synthetic_fog_volume(32, "shell")
    eng = VolumeEngine.create(small_config(), vol, batch_size=4096, device="cpu")
    state = eng.init(0)
    g = torch.Generator().manual_seed(0)
    losses = []
    for _ in range(4):
        state, loss = eng.train_bundle(state, g)
        losses.append(float(loss))
    jeng = JVolume.create(small_config(), jsynth(32, "shell"), batch_size=4096)
    jparams = jax.tree.map(lambda t: jnp.asarray(t.numpy()), state["params"])
    return eng, state, jeng, jparams, losses


def test_targets_match(fitted):
    eng, _, jeng, _, _ = fitted
    assert eng.majorant == jeng.majorant
    pos = np.random.default_rng(1).uniform(0, 1, (2048, 3)).astype(np.float32)
    jp, tp = jnp.asarray(pos), torch.from_numpy(pos)
    np.testing.assert_allclose(eng.gt_sigma(tp).numpy(),
                               np.asarray(jeng._gt_sigma(jeng.gt_density, jp)), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(eng.gt_radiance(tp).numpy(),
                               np.asarray(jeng._gt_radiance(jeng.gt_density, jp, None)),
                               rtol=1e-5, atol=1e-6)


def test_one_training_step_on_the_reference_positions(fitted):
    from sienerf_tpu.models.single_network import apply_single_network as japply

    eng, state, jeng, jparams, losses = fitted
    assert losses[-1] < 0.5 * losses[0]
    pos = jax.random.uniform(jax.random.PRNGKey(2), (4096, 3))
    gt = jeng.gt_density
    sigma = jeng._gt_sigma(gt, pos)
    target = jnp.concatenate([jeng._gt_radiance(gt, pos, None), sigma[:, None]], axis=-1)

    def loss_of(p):
        out = japply(jeng.net, p, pos)
        pred = jnp.concatenate([jax.nn.sigmoid(out[:, :3]),
                                jnp.exp(jnp.clip(out[:, 3], -10, 10))[:, None]], axis=-1)
        w = jnp.concatenate([jnp.tile((sigma > 1e-3)[:, None], (1, 3)),
                             jnp.ones_like(sigma[:, None])], axis=-1)
        return jnp.mean((pred - target) ** 2 * w)

    jl, jg = jax.value_and_grad(loss_of)(jparams)
    tl, tg = eng.loss_and_grads(state["params"], torch.from_numpy(np.array(pos)))
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-4)
    for got, want in zip(tg["mlp"], jg["mlp"]):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, **MLP_TOL)
        assert np.abs(got.numpy() - want).max() <= 0.02 * np.abs(want).max()
    jd = np.asarray(jg["grid"])
    assert np.abs(tg["grid"].numpy() - jd).max() <= 0.02 * np.abs(jd).max()


class JaxDraws:
    """The reference's per-iteration uniforms of render_rays from `key`,
    made on demand in its split order."""

    def __init__(self, key):
        self.key, self.out = key, []

    def __call__(self, i, n):
        while len(self.out) <= i:
            self.key, k1 = jax.random.split(self.key)
            u = jax.random.uniform(k1, (n,), minval=1e-7)
            self.key, k2 = jax.random.split(self.key)
            self.out.append((torch.from_numpy(np.array(u)),
                             torch.from_numpy(np.array(jax.random.uniform(k2, (n,))))))
        return self.out[i]


def _rays(w=24, h=24, focal=30.0):
    from sienerf_torch.utils.camera import uv_to_ray

    x = (torch.arange(w) + 0.5) / w
    y = (torch.arange(h) + 0.5) / h
    v, u = torch.meshgrid(y, x, indexing="ij")
    return uv_to_ray(torch.stack([u.reshape(-1), v.reshape(-1)], -1), (w, h), (focal, focal),
                     CAM)


@pytest.mark.parametrize("use_gt", [True, False])
def test_delta_tracking_on_the_reference_draws(fitted, use_gt):
    eng, state, jeng, jparams, _ = fitted
    o, d = _rays()
    key = jax.random.PRNGKey(4)
    jrgb, jhit = jeng._render_rays_jit(jparams, jnp.asarray(o.numpy()),
                                       jnp.asarray(d.numpy()), key, use_gt, jeng.gt_density)
    rgb, hit = eng.render_rays(state["params"], o, d, use_gt=use_gt, draw=JaxDraws(key))
    jhit = np.asarray(jhit) > 0
    hit = hit.numpy() > 0
    assert 0.1 < hit.mean() < 0.9
    assert (hit != jhit).sum() <= 0.005 * len(hit), int((hit != jhit).sum())
    both = hit & jhit
    tol = dict(rtol=1e-5, atol=1e-6) if use_gt else MLP_TOL
    np.testing.assert_allclose(rgb.numpy()[both], np.asarray(jrgb)[both], **tol)


def test_frame_on_the_reference_draws(fitted):
    eng, state, jeng, jparams, _ = fitted
    key = jax.random.PRNGKey(0)
    want_rgb, want_a = jeng.render_frame(jparams, 16, 16, CAM, (20.0, 20.0), key=key,
                                         use_gt=True, spp=2)
    keys = []
    for _ in range(2):
        key, sub = jax.random.split(key)
        keys.append(JaxDraws(sub))
    rgb, a = eng.render_frame(state["params"], 16, 16, CAM, (20.0, 20.0), use_gt=True, spp=2,
                              draw=lambda s, i, n: keys[s](i, n), stats={})
    assert rgb.shape == (16, 16, 3) and a.shape == (16, 16)
    differ = np.abs(a.numpy() - want_a) > 1e-6
    assert differ.mean() <= 0.01
    np.testing.assert_allclose(rgb.numpy()[~differ], want_rgb[~differ], rtol=1e-5, atol=1e-5)


def test_session_trains_a_volume(tmp_path):
    from sienerf_torch.session import Session

    write_nanovdb(tmp_path / "shell.nvdb", synthetic_fog_volume(32, "shell").density)
    (tmp_path / "net.json").write_text(json.dumps(small_config()))
    s = Session(device="cpu")
    s.load_file(tmp_path / "shell.nvdb", network=tmp_path / "net.json", batch_size=4096)
    assert s.mode.value == "volume" and s.engine.gt_density.shape == (32, 32, 32, 1)
    s.train(96)
    assert s.training_step == 96 and s.loss_graph[-1] < 0.5 * s.loss_graph[0]
    out = s.render(32, 32, CAM, (40.0, 40.0), spp=2)
    assert out.shape == (32, 32, 4) and bool(torch.isfinite(out).all())
    gt = s.render(32, 32, CAM, (40.0, 40.0), spp=2, use_gt=True)
    # the shell covers the frame's centre, the corners see through
    assert float(gt[14:18, 14:18, 3].mean()) > 0.5 and float(gt[0, 0, 3]) < 0.2
    assert float(out[14:18, 14:18, 3].mean()) > 0.3 and float(out[0, 0, 3]) < 0.2
