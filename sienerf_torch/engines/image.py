"""Image mode: a 2-D hash grid + MLP regressed onto an image (port of the
JAX package's engines/image.py).

A step draws a batch of coordinates in [0,1]^2 (random, Halton or Sobol),
fetches the bilinear (or nearest) texel as the target, and takes one L2
step.  The draw and the computation are separate (`draw_coords`,
`train_step(..., coords=...)`), so the tests hold one step to the
reference on the reference's own coordinates.  The table is the port's
(L, T, 4, F) cell table: the JAX engine's flat (L, T*C*F) boundary layout
is a TPU tiling workaround (convert.single_network_from_jax undoes it).

At the configuration's full width (configs/image/base.json: 16 levels x 2
features, 2^24 rows) the table is 8.6 GB in f32; with Adam's m and v and
the dense gradient the step holds four of it, so the optimizer updates in
place (ops/optim.py, `inplace`) and renders and evaluations run in chunks
of pixels."""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from sienerf_torch.models.single_network import (
    SingleNetworkConfig,
    apply_single_network,
    init_single_network,
    l2_mask,
)
from sienerf_torch.ops.grids import bilinear_sample_2d, nearest_sample_2d
from sienerf_torch.ops.losses import get_loss
from sienerf_torch.ops.optim import (
    OptimizerSpec,
    inference_params,
    optim_init,
    optim_step,
    tree_leaves,
    tree_map,
    tree_unflatten,
)
from sienerf_torch.ops.samplers import halton_2d, sobol_2d
from sienerf_torch.tracing import PhaseClock

# a training step's phases (train_step's stats)
IMAGE_PHASES = ("sample", "field", "optimizer")
_RENDER_CHUNK = 1 << 20  # pixels an inference pass


def _wrap_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 -> the int32 value the reference's wrapping arithmetic gives."""
    return ((x + (1 << 31)) % (1 << 32)) - (1 << 31)


@dataclass(eq=False)
class ImageEngine:
    net: SingleNetworkConfig
    opt: OptimizerSpec
    loss_otype: str
    image: torch.Tensor  # (H, W, C) f32 training texture on the engine's device
    batch_size: int = 1 << 18
    sampler: str = "random"  # random | halton | sobol
    snap_to_pixel_centers: bool = False
    device: torch.device = torch.device("cuda")

    @staticmethod
    def create(network_config: dict, image: np.ndarray, batch_size: int = 1 << 18,
               device: str | torch.device = "cuda") -> "ImageEngine":
        dev = torch.device(device)
        net = SingleNetworkConfig.from_network_config(network_config, n_input_dims=2,
                                                      n_output_dims=image.shape[-1])
        return ImageEngine(
            net=net, opt=OptimizerSpec.from_network_config(network_config.get("optimizer", {})),
            loss_otype=network_config.get("loss", {}).get("otype", "L2"),
            image=torch.as_tensor(np.asarray(image, np.float32), device=dev),
            batch_size=batch_size, device=dev)

    def init(self, seed: int = 1337):
        """Fresh params and optimizer state -> (params, opt_state)."""
        g = torch.Generator(device=self.device).manual_seed(seed)
        params = init_single_network(self.net, g, self.device)
        return params, optim_init(params, self.opt)

    def draw_coords(self, generator: torch.Generator, step: int) -> torch.Tensor:
        """The batch's coordinates (B, 2) in [0,1]^2 for optimizer step
        `step` (the Halton and Sobol samplers index by step * B + i)."""
        b = self.batch_size
        if self.sampler in ("halton", "sobol"):
            idx = _wrap_i32(int(step) * b + torch.arange(b, device=self.device))
            return halton_2d(idx) if self.sampler == "halton" else sobol_2d(idx)
        if self.sampler != "random":
            raise ValueError(f"unknown sampler {self.sampler!r}")
        return torch.rand((b, 2), generator=generator, device=self.device)

    def targets(self, coords: torch.Tensor) -> torch.Tensor:
        if self.snap_to_pixel_centers:
            return nearest_sample_2d(self.image, coords)
        return bilinear_sample_2d(self.image, coords)

    def loss_and_grads(self, params: dict, coords: torch.Tensor, clock=None):
        """The batch's mean loss and its gradient in every param leaf."""
        clock = clock or PhaseClock(None, self.device)
        target = self.targets(coords)
        clock.phase("sample")
        with torch.enable_grad():
            p_req = tree_map(lambda t: t.detach().requires_grad_(True), params)
            pred = apply_single_network(self.net, p_req, coords)
            loss = get_loss(self.loss_otype)(pred, target).mean()
            grads = torch.autograd.grad(loss, tree_leaves(p_req))
        clock.phase("field")
        return loss.detach(), tree_unflatten(params, list(grads))

    def train_step(self, params: dict, opt_state: dict, generator: torch.Generator | None = None,
                   coords: torch.Tensor | None = None, stats: dict | None = None):
        """One step on `coords`, or on a batch drawn from `generator` ->
        (params, opt_state, loss).  The params and the optimizer state are
        updated in place.  With stats["sync_phases"], stats["phase_s"]
        receives the seconds of sample / field / optimizer."""
        clock = PhaseClock(stats, self.device, IMAGE_PHASES)
        if coords is None:
            coords = self.draw_coords(generator, int(opt_state["step"]))
        loss, grads = self.loss_and_grads(params, coords, clock)
        params, opt_state = optim_step(self.opt, opt_state, params, grads,
                                       l2_mask(self.net, params), inplace=True)
        clock.phase("optimizer")
        return params, opt_state, loss

    @torch.no_grad()
    def render(self, params: dict, opt_state: dict, width: int, height: int) -> torch.Tensor:
        """Inference at pixel centres -> (H, W, C) f32, in chunks of pixels."""
        p = inference_params(opt_state, params)
        x = (torch.arange(width, dtype=torch.float32, device=self.device) + 0.5) / width
        y = (torch.arange(height, dtype=torch.float32, device=self.device) + 0.5) / height
        out = torch.empty((height * width, self.net.n_output_dims), device=self.device)
        for s in range(0, height * width, _RENDER_CHUNK):
            i = torch.arange(s, min(s + _RENDER_CHUNK, height * width), device=self.device)
            coords = torch.stack([x[i % width], y[i // width]], dim=-1)
            out[s:s + len(i)] = apply_single_network(self.net, p, coords)
        return out.reshape(height, width, -1)

    def compute_mse(self, params: dict, opt_state: dict, quantize_to_byte: bool = False) -> float:
        """Mean squared error of the render at the training resolution."""
        h, w, c = self.image.shape
        pred = self.render(params, opt_state, w, h)[..., :c]
        if quantize_to_byte:
            pred = torch.round(torch.clamp(pred, 0, 1) * 255.0) / 255.0
        return float(torch.mean((pred - self.image) ** 2))

    def psnr(self, params: dict, opt_state: dict) -> float:
        return -10.0 * math.log10(max(self.compute_mse(params, opt_state), 1e-12))
