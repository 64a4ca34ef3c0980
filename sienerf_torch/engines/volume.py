"""Volume mode: a neural fit of a density volume, rendered by delta
tracking (port of the JAX package's engines/volume.py).

Training: uniform positions in the unit cube; the targets are the grid's
trilinear density and a single-scatter radiance, albedo * (sun *
transmittance toward the sun + 0.2 sky), with the transmittance a 32-step
quadrature of the grid toward the sun.  The network's 4 outputs are
sigmoid rgb and exp density; L2, the radiance weighted where there is
medium.  A step's draw and its computation are separate (`draw_positions`,
`train_step(..., pos=...)`).

Frames: Woodcock (delta) tracking against the grid's majorant: each
iteration draws a free-flight distance and an acceptance uniform for every
ray (`draw(i, n)` -> two (n,) arrays, injectable: the tests feed the
reference's draws); an accepted collision shades by single scatter (the
grid's, use_gt) or the network's colour.  The reference's loop is a
`while_loop` up to max_march_steps; here it is a host loop over the rays
still alive, compacted every _MARCH_CHECK iterations (a ray's state changes
only while it is alive)."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from sienerf_torch.io.nanovdb import DenseVolume
from sienerf_torch.models.single_network import (
    SingleNetworkConfig,
    apply_single_network,
    init_single_network,
    l2_mask,
)
from sienerf_torch.ops.grids import trilinear_sample_3d
from sienerf_torch.ops.losses import get_loss
from sienerf_torch.ops.optim import (
    OptimizerSpec,
    optim_init,
    optim_step,
    tree_leaves,
    tree_map,
    tree_unflatten,
)
from sienerf_torch.tracing import PhaseClock
from sienerf_torch.utils.bbox import BoundingBox
from sienerf_torch.utils.camera import uv_to_ray

VOLUME_TRAIN_PHASES = ("sample", "ground_truth", "field", "optimizer")
VOLUME_FRAME_PHASES = ("setup", "march", "field", "shade")
_MARCH_CHECK = 16  # delta-tracking iterations between compactions of the live rays


@dataclass(eq=False)
class VolumeEngine:
    net: SingleNetworkConfig
    opt: OptimizerSpec
    loss_otype: str
    aabb: BoundingBox
    majorant: float
    gt_density: torch.Tensor  # (D, H, W, 1) on the engine's device
    device: torch.device
    albedo: float = 0.95
    sun_dir: tuple = (0.577, 0.577, 0.577)
    sky_color: tuple = (0.4, 0.55, 0.85)
    sun_color: tuple = (1.0, 0.95, 0.85)
    batch_size: int = 1 << 16
    max_march_steps: int = 512

    @staticmethod
    def create(network_config: dict, volume: DenseVolume, batch_size: int = 1 << 16,
               device: str | torch.device = "cuda") -> "VolumeEngine":
        dev = torch.device(device)
        net = SingleNetworkConfig.from_network_config(network_config, n_input_dims=3,
                                                      n_output_dims=4)
        return VolumeEngine(
            net=net, opt=OptimizerSpec.from_network_config(network_config.get("optimizer", {})),
            loss_otype=network_config.get("loss", {}).get("otype", "L2"),
            aabb=BoundingBox.unit(), majorant=max(volume.majorant, 1e-3),
            gt_density=torch.from_numpy(np.ascontiguousarray(volume.density[..., None],
                                                             np.float32)).to(dev),
            device=dev, batch_size=batch_size)

    def init(self, seed: int = 1337) -> dict:
        g = torch.Generator(device=self.device).manual_seed(seed)
        params = init_single_network(self.net, g, self.device)
        return {"params": params, "opt": optim_init(params, self.opt)}

    # --- ground truth -----------------------------------------------------------

    def gt_sigma(self, pos: torch.Tensor) -> torch.Tensor:
        return trilinear_sample_3d(self.gt_density, pos)[..., 0]

    def _sun(self) -> torch.Tensor:
        sun = torch.tensor(self.sun_dir, dtype=torch.float32, device=self.device)
        return sun / torch.linalg.norm(sun)

    def transmittance_to_light(self, pos: torch.Tensor, n_steps: int = 32) -> torch.Tensor:
        """exp(-optical depth) toward the sun: a fixed n_steps midpoint
        quadrature over one unit of distance, inside the box only."""
        ts = (torch.arange(n_steps, dtype=torch.float32, device=pos.device) + 0.5) / n_steps
        pts = pos[:, None, :] + ts[None, :, None] * (1.0 * self._sun())[None, None, :]
        sigma = self.gt_sigma(pts)
        inside = ((pts >= 0) & (pts <= 1)).all(dim=-1)
        tau = torch.where(inside, sigma, 0.0).sum(dim=1) * (1.0 / n_steps)
        return torch.exp(-tau)

    def gt_radiance(self, pos: torch.Tensor) -> torch.Tensor:
        """Single scatter: albedo * (sun * T_sun + 0.2 * sky)."""
        t_sun = self.transmittance_to_light(pos)
        sun_c = torch.tensor(self.sun_color, device=pos.device)
        sky_c = torch.tensor(self.sky_color, device=pos.device)
        return self.albedo * (t_sun[:, None] * sun_c + 0.2 * sky_c)

    # --- training -----------------------------------------------------------------

    def draw_positions(self, generator: torch.Generator) -> torch.Tensor:
        return torch.rand((self.batch_size, 3), generator=generator, device=self.device)

    def field(self, params: dict, pos: torch.Tensor):
        """-> (rgb (N, 3) sigmoid, sigma (N,) exp of the clamped output)."""
        out = apply_single_network(self.net, params, pos)
        return torch.sigmoid(out[:, :3]), torch.exp(torch.clamp(out[:, 3], -10, 10))

    def loss_and_grads(self, params: dict, pos: torch.Tensor, clock=None):
        clock = clock or PhaseClock(None, self.device)
        sigma = self.gt_sigma(pos)
        target = torch.cat([self.gt_radiance(pos), sigma[:, None]], dim=-1)
        w = torch.cat([(sigma > 1e-3)[:, None].expand(-1, 3).float(),
                       torch.ones_like(sigma[:, None])], dim=-1)
        clock.phase("ground_truth")
        with torch.enable_grad():
            p_req = tree_map(lambda t: t.detach().requires_grad_(True), params)
            rgb, sig = self.field(p_req, pos)
            pred = torch.cat([rgb, sig[:, None]], dim=-1)
            loss = (get_loss(self.loss_otype)(pred, target) * w).mean()
            grads = torch.autograd.grad(loss, tree_leaves(p_req))
        clock.phase("field")
        return loss.detach(), tree_unflatten(params, list(grads))

    def train_step(self, state: dict, pos: torch.Tensor, clock=None):
        """One step on positions pos (B, 3) -> (state, loss); the state is
        updated in place."""
        clock = clock or PhaseClock(None, self.device)
        loss, grads = self.loss_and_grads(state["params"], pos, clock)
        params, opt = optim_step(self.opt, state["opt"], state["params"], grads,
                                 l2_mask(self.net, state["params"]), inplace=True)
        clock.phase("optimizer")
        return {"params": params, "opt": opt}, loss

    def train_bundle(self, state: dict, generator: torch.Generator, n_steps: int = 16,
                     stats: dict | None = None):
        """n_steps steps -> (state, mean loss as a 0-d tensor).  With
        stats["sync_phases"], stats["phase_s"] receives the seconds of
        sample / ground_truth / field / optimizer."""
        clock = PhaseClock(stats, self.device, VOLUME_TRAIN_PHASES)
        losses = []
        for _ in range(n_steps):
            pos = self.draw_positions(generator)
            clock.phase("sample")
            state, loss = self.train_step(state, pos, clock)
            losses.append(loss)
        return state, torch.stack(losses).mean()

    # --- rendering ------------------------------------------------------------------

    @torch.no_grad()
    def render_rays(self, params: dict, origins: torch.Tensor, dirs: torch.Tensor,
                    generator: torch.Generator | None = None, use_gt: bool = False,
                    draw=None, clock=None):
        """Delta tracking -> (rgb (N, 3), hit (N,) f32).  Iteration i's
        uniforms are draw(i, N): (free-flight u in [1e-7, 1), acceptance u
        in [0, 1)), by default from `generator`; stats["march_iters"]
        counts the iterations."""
        clock = clock or PhaseClock(None, self.device)
        N, dev = origins.shape[0], origins.device
        if draw is None:
            def draw(_i, n):
                u = torch.rand((n,), generator=generator, device=dev)
                return 1e-7 + u * (1.0 - 1e-7), torch.rand((n,), generator=generator,
                                                            device=dev)
        d = dirs / torch.linalg.norm(dirs, dim=-1, keepdim=True)
        tmin, tmax = self.aabb.ray_intersect(origins, d)
        t = torch.clamp(tmin, min=0.0) + 1e-4
        alive = t < tmax
        inv_maj = 1.0 / self.majorant
        hit_pos = torch.zeros((N, 3), device=dev)
        hit = torch.zeros(N, dtype=torch.bool, device=dev)

        def sigma_at(pos):
            return self.gt_sigma(pos) if use_gt else self.field(params, pos)[1]

        i = 0
        while i < self.max_march_steps:
            idx = torch.nonzero(alive)[:, 0]
            if idx.numel() == 0:
                break
            o, dd, tm, tt = origins[idx], d[idx], tmax[idx], t[idx]
            a = torch.ones(idx.shape, dtype=torch.bool, device=dev)
            hp, hm = hit_pos[idx], hit[idx]
            for _ in range(min(_MARCH_CHECK, self.max_march_steps - i)):
                u_free, u_acc = draw(i, N)
                tt = tt - torch.log(u_free[idx]) * inv_maj
                pos = o + tt[:, None] * dd
                out = tt >= tm
                clock.phase("march")
                sigma = sigma_at(torch.clamp(pos, 0.0, 1.0))
                clock.phase("field")
                accept = u_acc[idx] < sigma * inv_maj
                newly = a & ~out & accept
                hp = torch.where(newly[:, None], pos, hp)
                hm = hm | newly
                a = a & ~out & ~accept
                i += 1
            t[idx], alive[idx], hit_pos[idx], hit[idx] = tt, a, hp, hm
        if clock.stats is not None:
            clock.stats["march_iters"] = clock.stats.get("march_iters", 0) + i
        if use_gt:
            t_sun = self.transmittance_to_light(hit_pos)
            rgb = self.albedo * (t_sun[:, None] * torch.tensor(self.sun_color, device=dev)
                                 + 0.2 * torch.tensor(self.sky_color, device=dev))
        else:
            rgb = self.field(params, hit_pos)[0]
        rgb = torch.where(hit[:, None], rgb, 0.0)
        clock.phase("shade")
        return rgb, hit.float()

    @torch.no_grad()
    def render_frame(self, params: dict, width: int, height: int, camera_matrix, focal,
                     generator: torch.Generator | None = None, use_gt: bool = False,
                     background=(1.0, 1.0, 1.0), spp: int = 4, draw=None,
                     stats: dict | None = None):
        """spp delta-tracked passes averaged -> (rgb over the background
        (H, W, 3), opacity (H, W)).  `draw(pass, i, n)` injects a pass's
        uniforms (render_rays); by default they come from `generator`, or
        from one seeded with 0.  With stats["sync_phases"], stats["phase_s"]
        receives the seconds of setup / march / field / shade."""
        clock = PhaseClock(stats, self.device, VOLUME_FRAME_PHASES)
        dev = self.device
        if generator is None and draw is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        x = (torch.arange(width, dtype=torch.float32, device=dev) + 0.5) / width
        y = (torch.arange(height, dtype=torch.float32, device=dev) + 0.5) / height
        v, u = torch.meshgrid(y, x, indexing="ij")
        uv = torch.stack([u.reshape(-1), v.reshape(-1)], dim=-1)
        o, d = uv_to_ray(uv, (width, height), focal, camera_matrix)
        clock.phase("setup")
        acc_rgb = acc_a = 0.0
        for s in range(spp):
            pass_draw = None if draw is None else (lambda i, n, s=s: draw(s, i, n))
            rgb, a = self.render_rays(params, o, d, generator, use_gt, pass_draw, clock)
            acc_rgb = acc_rgb + rgb
            acc_a = acc_a + a
        rgb, a = acc_rgb / spp, acc_a / spp
        out = rgb + (1.0 - a)[:, None] * torch.tensor(background, dtype=torch.float32,
                                                      device=dev)
        return out.reshape(height, width, 3), a.reshape(height, width)

