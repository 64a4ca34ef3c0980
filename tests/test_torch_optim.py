"""The trainer's losses and optimizer, port vs reference: all eight losses
and their gradients, the optimizer spec parsed from configs/nerf/base.json,
the stepped learning-rate decay across its boundaries, and three
Ema(ExponentialDecay(Adam)) steps on identical gradients with the l2 mask.

Tolerances: losses and their gradients rtol 1e-6 (the same f32
operations; a division may round differently).  Learning-rate factors
rtol 1e-6 (f32 pow on the host against XLA's).  Optimizer steps rtol 1e-6
/ atol 1e-7 on params, m, v and the EMA shadow: the same operations in
the same order, but XLA may fuse a multiply and an add, and the bias
corrections' f32 pow runs in another library."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sienerf_tpu.ops import losses as jlosses
from sienerf_tpu.ops import optim as joptim
from sienerf_torch.ops import losses as tlosses
from sienerf_torch.ops import optim as toptim
from sienerf_torch.utils.config import default_configs_dir, load_network_config

LOSSES = ("l2", "l1", "huber", "relativel2", "relativel2luminance", "mape", "smape",
          "logl1")


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


@pytest.mark.parametrize("otype", LOSSES)
def test_loss_and_its_gradient_match(otype):
    rng = np.random.default_rng(LOSSES.index(otype))
    pred = rng.uniform(-0.3, 1.3, (512, 3)).astype(np.float32)
    target = rng.uniform(0.0, 1.0, (512, 3)).astype(np.float32)
    jfn, tfn = jlosses.get_loss(otype), tlosses.get_loss(otype)
    jval, jgrad = jax.value_and_grad(lambda p: jnp.sum(jfn(p, jnp.asarray(target))))(
        jnp.asarray(pred))
    p = torch.from_numpy(pred).requires_grad_(True)
    per = tfn(p, torch.from_numpy(target))
    np.testing.assert_allclose(per.detach().numpy(),
                               np.asarray(jfn(jnp.asarray(pred), jnp.asarray(target))),
                               rtol=1e-6)
    (g,) = torch.autograd.grad(per.sum(), p)
    np.testing.assert_allclose(g.numpy(), np.asarray(jgrad), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(float(per.detach().sum()), float(jval), rtol=1e-5)


def test_unknown_loss_raises():
    with pytest.raises(ValueError):
        tlosses.get_loss("hinge")


def _base_spec():
    cfg = load_network_config(default_configs_dir() / "nerf" / "base.json")
    return (toptim.OptimizerSpec.from_network_config(cfg["optimizer"]),
            joptim.OptimizerSpec.from_network_config(cfg["optimizer"]))


def test_spec_parse_of_the_nerf_config_matches():
    tspec, jspec = _base_spec()
    assert dataclasses.asdict(tspec) == dataclasses.asdict(jspec)
    assert tspec.ema_decay == 0.95 and tspec.decay_interval == 10000
    assert tspec.l2_reg == 1e-6 and tspec.epsilon == 1e-15


@pytest.mark.parametrize("step", [0, 1, 19999, 20000, 29999, 30000, 30001, 55555,
                                  2 ** 31 - 1])
def test_lr_factor_across_the_decay_boundaries(step):
    tspec, jspec = _base_spec()
    got = float(toptim.lr_factor(tspec, step))
    want = float(joptim.lr_factor(jspec, jnp.asarray(step, jnp.int32)))
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert got == pytest.approx(0.33 ** ((min(max(step, 20000), 2 ** 31 - 1) - 20000)
                                         // 10000), rel=1e-5)


def _params(rng):
    return {"grid": rng.uniform(-1e-2, 1e-2, (3, 64, 8, 2)).astype(np.float32),
            "density_mlp": [rng.uniform(-0.5, 0.5, (6, 16)).astype(np.float32),
                            rng.uniform(-0.5, 0.5, (16, 16)).astype(np.float32)],
            "rgb_mlp": [rng.uniform(-0.5, 0.5, (32, 16)).astype(np.float32),
                        rng.uniform(-0.5, 0.5, (16, 3)).astype(np.float32)]}


@pytest.mark.parametrize("decayed", [False, True])
def test_three_optim_steps_on_identical_gradients(decayed):
    """Adam with l2 on the MLP matrices only, bias correction, the EMA
    shadow; `decayed` starts past the decay boundary."""
    from sienerf_tpu.models.nerf_network import nerf_l2_mask as jmask
    from sienerf_torch.models.nerf_network import nerf_l2_mask as tmask

    tspec, jspec = _base_spec()
    rng = np.random.default_rng(7 + decayed)
    p0 = _params(rng)
    jp = jax.tree.map(jnp.asarray, p0)
    tp = toptim.tree_map(torch.from_numpy, p0)
    jst = joptim.optim_init(jp, jspec)
    tst = toptim.optim_init(tp, tspec)
    if decayed:
        jst["step"] = jnp.asarray(29998, jnp.int32)
        tst["step"] = 29998
    assert tmask(tp) == jmask(jp)
    for i in range(3):
        # gradients over decades, some exactly zero
        g = toptim.tree_map(
            lambda a: (rng.normal(size=a.shape) * 10.0 ** rng.integers(-6, 1, a.shape)
                       * (rng.random(a.shape) > 0.1)).astype(np.float32), p0)
        jp, jst = joptim.optim_step(jspec, jst, jp, jax.tree.map(jnp.asarray, g), jmask(jp))
        tp, tst = toptim.optim_step(tspec, tst, tp, toptim.tree_map(torch.from_numpy, g),
                                    tmask(tp))
        assert tst["step"] == int(jst["step"])
        for name, a, b in (("params", jp, tp), ("m", jst["m"], tst["m"]),
                           ("v", jst["v"], tst["v"]), ("ema", jst["ema"], tst["ema"])):
            # jax.tree.leaves takes dict keys in sorted order
            for x, y in zip(jax.tree.leaves(a), toptim.tree_leaves(dict(sorted(b.items())))):
                np.testing.assert_allclose(y.numpy(), np.asarray(x), rtol=1e-6, atol=1e-7,
                                           err_msg=f"step {i + 1} {name}")
    assert toptim.inference_params(tst, tp) is tst["ema"]
    assert toptim.inference_params({"m": {}}, tp) is tp


def test_tree_helpers_round_trip():
    tree = {"a": torch.zeros(2), "b": [torch.ones(1), torch.ones(3)]}
    leaves = toptim.tree_leaves(tree)
    assert [x.numel() for x in leaves] == [2, 1, 3]
    back = toptim.tree_unflatten(tree, [x + 1 for x in leaves])
    assert float(back["b"][1].sum()) == 6.0 and isinstance(back["b"], list)
