"""Bias-free MLPs with the reference's precision (port of
the JAX package's ops/mlp.py).

The reference rounds each layer's inputs and weights to bf16 and
accumulates the products in f32 (`preferred_element_type=f32`), rounding
again to bf16 between layers.  Here that is `x.bfloat16().float() @
w.bfloat16().float()`: every product of two bf16 values is exact in f32, so
only the summation order can differ.  A bf16-output matmul would round the
sum, which the reference does not.

Autograd rounds the cotangents where JAX's transposes do: the backward of
`.float()` rounds the gradient of each bf16 layer input, and of each bf16
copy of a weight, to bf16 (JAX's transpose of `dot(..., preferred f32)`
returns the operand's dtype), and the backward of `.to(bfloat16)` widens
it to f32 again.  So weight gradients and the gradient reaching the
encoding are bf16 values, as in the reference.
"""

from __future__ import annotations

import math
from contextlib import contextmanager
from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class MLPConfig:
    n_input_dims: int
    n_output_dims: int
    n_neurons: int = 64
    n_hidden_layers: int = 2
    activation: str = "ReLU"
    output_activation: str = "None"

    @staticmethod
    def from_network_config(cfg: dict, n_input_dims: int,
                            n_output_dims: int) -> "MLPConfig":
        return MLPConfig(
            n_input_dims=n_input_dims,
            n_output_dims=n_output_dims,
            n_neurons=int(cfg.get("n_neurons", 64)),
            n_hidden_layers=int(cfg.get("n_hidden_layers", 2)),
            activation=cfg.get("activation", "ReLU"),
            output_activation=cfg.get("output_activation", "None"),
        )


def _activation_fn(name: str):
    name = name.lower()
    if name == "relu":
        return torch.relu
    if name == "none":
        return lambda x: x
    if name in ("sigmoid", "logistic"):
        return torch.sigmoid
    if name == "exponential":
        return torch.exp
    if name == "tanh":
        return torch.tanh
    if name == "squareplus":
        return lambda x: 0.5 * (x + torch.sqrt(x * x + 4.0))
    if name == "softplus":
        return lambda x: torch.logaddexp(x, torch.zeros_like(x))
    if name in ("leakyrelu", "leaky_relu"):
        return lambda x: torch.nn.functional.leaky_relu(x, 0.01)
    if name == "sine":
        return torch.sin
    raise ValueError(f"unknown activation {name}")


def mlp_layer_dims(config: MLPConfig) -> list[tuple[int, int]]:
    dims = []
    d_in = config.n_input_dims
    for _ in range(config.n_hidden_layers):
        dims.append((d_in, config.n_neurons))
        d_in = config.n_neurons
    dims.append((d_in, config.n_output_dims))
    return dims


def init_mlp_params(config: MLPConfig, generator: torch.Generator,
                    device=None) -> list[torch.Tensor]:
    """He-uniform f32 weights, (d_in, d_out) a layer, in [-sqrt(6/d_in),
    sqrt(6/d_in)]."""
    out = []
    for d_in, d_out in mlp_layer_dims(config):
        bound = math.sqrt(6.0 / d_in)
        out.append(torch.empty((d_in, d_out), dtype=torch.float32, device=device)
                   .uniform_(-bound, bound, generator=generator))
    return out


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


class _Tap:
    """mlp_apply's view of tap_roundings: lists that receive each layer's
    bf16-rounded input and the f32 output (`seen`, `kinds`: "rounded" or
    "output"), or an iterator of values to use in their place."""

    def __init__(self, replace):
        self.seen: list[torch.Tensor] = []
        self.kinds: list[str] = []
        self._replace = None if replace is None else iter(replace)

    def __call__(self, v: torch.Tensor, kind: str = "rounded") -> torch.Tensor:
        self.seen.append(v)
        self.kinds.append(kind)
        r = None if self._replace is None else next(self._replace, None)
        if r is None:
            return v
        # the given value, with v's gradient path
        return r.to(v.device) + (v - v.detach())


_tap: _Tap | None = None


@contextmanager
def tap_roundings(replace=None):
    """Within the block, mlp_apply hands the bf16-rounded input of every
    layer it computes, and its f32 output before the output activation (in
    call order), to the yielded tap's `seen` list; with `replace`, it uses
    those tensors' values instead of its own.  The tool that shows which
    values round the other way on two devices, and how far each moves a
    result.  A None in `replace`, or its end, keeps the value."""
    global _tap
    prev, _tap = _tap, _Tap(replace)
    try:
        yield _tap
    finally:
        _tap = prev


def _rounded(x: torch.Tensor) -> torch.Tensor:
    h = _bf16(x)
    return h if _tap is None else _tap(h)


def mlp_apply(config: MLPConfig, params: list[torch.Tensor],
              x: torch.Tensor, compute_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """x (N, n_input_dims) -> (N, n_output_dims) f32.  With compute_dtype
    float32 nothing is rounded to bf16 (the SDF engine's finite-difference
    normals)."""
    act = _activation_fn(config.activation)
    out_act = _activation_fn(config.output_activation)
    if compute_dtype == torch.float32:
        h = x.float()
        for i, w in enumerate(params):
            h = h @ w.float()
            if i < len(params) - 1:
                h = act(h)
        return out_act(h).float()
    h = _rounded(x)
    for i, w in enumerate(params):
        h = h @ _bf16(w)
        if i < len(params) - 1:
            h = _rounded(act(h))
    if _tap is not None:
        h = _tap(h, "output")
    return out_act(h).float()
