"""The MLP activations and the SH basis, port vs the JAX package:
every activation name the reference's MLP takes (ops/mlp.py), through
mlp_apply in f32 and bf16, at rtol 1e-6 / atol 1e-6 in f32 (the same
elementwise functions) and at the bf16 MLP bound rtol 1e-2 / atol 1e-3;
SH degrees 1-5 at rtol 1e-6 / atol 1e-6; degree 6 raises, as the
reference's basis stops at 5 while its encoding_output_dim reports 36."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sienerf_tpu.ops import encodings as jenc
from sienerf_tpu.ops import mlp as jmlp
from sienerf_torch.ops import encodings as tenc
from sienerf_torch.ops import mlp as tmlp

NAMES = ["ReLU", "None", "Sigmoid", "Logistic", "Tanh", "Exponential", "Squareplus",
         "Softplus", "LeakyReLU", "leaky_relu", "Sine"]


@pytest.mark.parametrize("name", NAMES)
def test_activation_matches_the_reference(name):
    x = np.linspace(-25.0, 25.0, 2001, dtype=np.float32)
    want = np.asarray(jmlp._activation_fn(name)(jnp.asarray(x)))
    got = tmlp._activation_fn(name)(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("name", ["Tanh", "Squareplus", "Softplus", "LeakyReLU", "Sine"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_mlp_with_the_activation_matches(name, dtype):
    rng = np.random.default_rng(len(name))
    cfg = dict(n_input_dims=12, n_output_dims=3, n_neurons=16, n_hidden_layers=2,
               activation=name, output_activation=name)
    ws = [rng.normal(0, 0.5, s).astype(np.float32) for s in ((12, 16), (16, 16), (16, 3))]
    x = rng.normal(size=(256, 12)).astype(np.float32)
    jd, td = (jnp.float32, torch.float32) if dtype == "f32" else (jnp.bfloat16, torch.bfloat16)
    want = np.asarray(jmlp.mlp_apply(jmlp.MLPConfig(**cfg), [jnp.asarray(w) for w in ws],
                                     jnp.asarray(x), compute_dtype=jd))
    got = tmlp.mlp_apply(tmlp.MLPConfig(**cfg), [torch.from_numpy(w) for w in ws],
                         torch.from_numpy(x), compute_dtype=td).numpy()
    tol = dict(rtol=1e-5, atol=1e-5) if dtype == "f32" else dict(rtol=1e-2, atol=1e-3)
    np.testing.assert_allclose(got, want, **tol)


def test_unknown_activation_raises():
    with pytest.raises(ValueError, match="unknown activation"):
        tmlp._activation_fn("gelu")


@pytest.mark.parametrize("degree", [1, 2, 3, 4, 5])
def test_sh_basis_matches_the_reference(degree):
    rng = np.random.default_rng(degree)
    d = rng.normal(size=(512, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    u = (d + 1.0) * 0.5
    want = np.asarray(jenc.sh_encode(jnp.asarray(u), degree))
    got = tenc.sh_encode(torch.from_numpy(u), degree).numpy()
    assert got.shape == want.shape == (512, degree ** 2)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_sh_degree_above_five_raises():
    assert jenc.sh_encode(jnp.zeros((2, 3)), 6).shape == (2, 25)  # the reference's caveat
    assert tenc.encoding_output_dim("SphericalHarmonics", 3, {"degree": 6}) == 36
    with pytest.raises(ValueError, match="degree 5"):
        tenc.sh_encode(torch.zeros((2, 3)), 6)
