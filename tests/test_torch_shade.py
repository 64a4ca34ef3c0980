"""Port vs reference: K1's plain version on fox bakes.  Against the
reference's XLA shade prep (prepare_rgba_volume) at R=16, and against its
Pallas shade kernel in interpret mode at R=8, at the reference's own
tolerance rtol 2e-2 / atol 2e-3 (tests/test_shade_pallas.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_snapshot import fox_jax, fox_jax_bake, fox_port_session

CAM = np.asarray([0.1, 1.4, -0.6], np.float32)


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


def _f32(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def test_plain_shade_matches_xla_prep():
    from sienerf_tpu.engines.nerf_sweep import prepare_rgba_volume as jax_prep
    from sienerf_torch.convert import baked_grid_from_jax
    from sienerf_torch.engines.nerf_sweep import prepare_rgba_volume

    jeng, jparams, _ = fox_jax()
    jgrid, meta = fox_jax_bake(16)
    R, K = meta["resolution"], meta["n_cascades"]
    want = jax_prep(jeng, jparams, jnp.asarray(jgrid["rows"]), jnp.asarray(jgrid["scale"]),
                    jnp.asarray(CAM), R, K)
    s = fox_port_session()
    grid = baked_grid_from_jax(jgrid, device="cpu")
    got = prepare_rgba_volume(s.engine, s.state["params"], grid["rows"], grid["scale"],
                              torch.from_numpy(CAM), R, K)
    assert got.dtype == torch.bfloat16 and got.shape == (K, R + 1, R + 1, R + 1, 4)
    np.testing.assert_allclose(got.float().numpy(), _f32(want), rtol=2e-2, atol=2e-3)
    assert float(got[..., 3].float().max()) > 1.0  # dense fox, not an empty volume


def test_shade_wrapper_matches_pallas_interpret():
    from sienerf_tpu.ops.shade_pallas import build_fieldmajor_planes, shade_volume_pallas
    from sienerf_torch.convert import baked_grid_from_jax
    from sienerf_torch.ops.shade import shade_volume

    jeng, jparams, _ = fox_jax()
    jgrid, meta = fox_jax_bake(8)
    R, K = meta["resolution"], meta["n_cascades"]
    Rv = R + 1
    fm = build_fieldmajor_planes(jnp.asarray(jgrid["rows"]), R, K)
    want = shade_volume_pallas(
        fm, jnp.asarray(jgrid["scale"]), jnp.asarray(CAM), tuple(jparams["rgb_mlp"]),
        resolution=R, n_cascades=K, block=384 * 384 // 2,
        density_act=jeng.net.density_activation.name.lower(),
        rgb_act=jeng.net.rgb_activation.name.lower(), interpret=True)
    s = fox_port_session()
    grid = baked_grid_from_jax(jgrid, device="cpu")
    got = shade_volume(grid["rows"], grid["scale"], torch.from_numpy(CAM),
                       s.state["params"]["rgb_mlp"], resolution=R, n_cascades=K,
                       density_act=s.engine.net.density_activation,
                       rgb_act=s.engine.net.rgb_activation)
    # the port's volume is unpadded: (K, R+1, 4, R+1, R+1)
    assert got.shape == (K, Rv, 4, Rv, Rv)
    np.testing.assert_allclose(got.float().numpy(), _f32(want)[:, :, :, :Rv, :Rv],
                               rtol=2e-2, atol=2e-3)
    assert shade_volume.launches == 0  # CPU tensors never reach the kernel
