"""NeRF engine (port of the JAX package's engines/nerf.py::NerfEngine):
the trainer (train_bundle), the streaming ray-marched live renderer
(render_frame), fixed ray batches (render_rays), and the bake entry of the
sweep path (bake_features).

Training, compacted: a bundle is one occupancy update and then
`grid_interval` steps.  A step draws a ray batch (uniform, or from the
error map after its warm-up), marches every ray to completion through the
occupancy grid, packs the samples into one dense batch of
train_n_rays * train_k samples (rays that do not fit are dropped whole),
evaluates the field there, composites each ray over a random background,
and takes an Adam step on the Huber loss against the image.  The ray count
follows the measured samples a ray in power-of-four buckets.  The random
part of each step and of each occupancy update is drawn apart from its
computation (`draw_step`, `draw_occupancy`), from a torch.Generator, so
that a test can hand in the JAX package's draws.

The live renderer keeps a fixed buffer of `tile` ray slots.  Each round
marches `render_chunk` samples for every slot through the occupancy grid,
evaluates the field there, composites, writes finished rays to the frame
and refills their slots with the next pixels, so the slots stay full
however much ray lengths differ.  The JAX package runs the rounds in an
on-device while loop; here the loop is a Python `while` that asks the
device once per round whether any ray is alive, and every step inside is
plain PyTorch.

Not ported yet (Slice C2 of ROADMAP.md; each raises NotImplementedError):
the optional learners (extrinsics, focal, exposure, distortion map with
render mode `distortion`, extra-dim conditioning, trainable envmap), depth
supervision, rolling shutter, the near-density regulariser and the legacy
two-phase path (compact_training=False).  A trained envmap in the params
is read as the frame's background.  `bake_render_grid` bakes the fine
render grid that render_frame's `fine_bitfield` takes.
"""

from __future__ import annotations

import dataclasses
import math
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from sienerf_torch.common import NERF_RENDERING_NEAR_DISTANCE, LensMode
from sienerf_torch.io.nerf_dataset import NerfDataset
from sienerf_torch.models.nerf_network import (
    NerfNetworkConfig,
    apply_density_activation,
    apply_rgb_activation,
    density_raw,
    init_nerf_network,
    nerf_apply,
    nerf_l2_mask,
)
from sienerf_torch.ops.envmap import background_behind_envmap
from sienerf_torch.ops.hashgrid import pack_table_bf16, pack_table_fp8
from sienerf_torch.ops.importance import (
    draw_error_map_uniforms,
    init_error_map,
    sample_error_map,
    splat_errors,
)
from sienerf_torch.ops.losses import get_loss
from sienerf_torch.ops.occupancy import (
    OccupancyConfig,
    bake_fine_bitfield,
    density_to_bitfield,
    draw_density_update,
    init_occupancy_state,
    mark_untrained_cells,
    n_cascades_for_aabb_scale,
    occupied_bbox,
    pack_occupancy,
    ray_box_times,
    update_density_grid,
)
from sienerf_torch.ops.optim import (
    OptimizerSpec,
    inference_params,
    optim_init,
    optim_step,
    tree_leaves,
    tree_map,
    tree_unflatten,
)
from sienerf_torch.ops.raymarch import (
    MarchConfig,
    advance_to_occupied,
    calc_dt,
    compact_samples,
    composite_chunk,
    composite_flat,
    cone_angle_for_aabb,
    march_rays,
)
from sienerf_torch.utils.bbox import BoundingBox
from sienerf_torch.utils.camera import Lens, uv_to_ray

RENDER_MODES = ("shade", "cost", "positions", "depth", "ao", "encoding_vis", "normals")
_FRAME_PHASES = ("setup", "advance", "march", "eval", "composite", "flush")
# a training step's phases (train_bundle's stats)
TRAIN_PHASES = ("sample", "march", "field", "composite", "optimizer", "occupancy")


def _norm(x: torch.Tensor) -> torch.Tensor:
    return torch.sqrt((x * x).sum(dim=-1, keepdim=True))


class _PhaseClock:
    """Statistics for a caller's `stats` dict: with stats["sync_phases"]
    set, the seconds of each of `phases`, measured by synchronising the
    device after it (which slows the work, so a timed run leaves it
    unset); for a frame also the host's wait for the device's per-round
    answer."""

    def __init__(self, stats: dict | None, device: torch.device, phases=_FRAME_PHASES):
        self.stats = stats
        self.sync = bool(stats and stats.get("sync_phases")) and device.type == "cuda"
        if stats is not None and stats.get("sync_phases"):
            stats["phase_s"] = dict.fromkeys(phases, 0.0)
        self._t = time.perf_counter()

    def phase(self, name: str) -> None:
        if self.stats is None or "phase_s" not in self.stats:
            return
        if self.sync:
            torch.cuda.synchronize()
        now = time.perf_counter()
        self.stats["phase_s"][name] += now - self._t
        self._t = now

    def any_alive(self, alive: torch.Tensor) -> bool:
        t = time.perf_counter()
        out = bool(alive.any())
        if self.stats is not None:
            self.stats["host_wait_s"] += time.perf_counter() - t
            self._t = time.perf_counter()
        return out


@dataclass(eq=False)
class NerfEngine:
    net: NerfNetworkConfig
    aabb: BoundingBox
    march: MarchConfig = field(default_factory=MarchConfig)
    opt: OptimizerSpec = field(default_factory=OptimizerSpec)
    occ: OccupancyConfig = field(default_factory=OccupancyConfig)
    loss_otype: str = "Huber"
    # the training batch: train_n_rays * train_k samples (2^18 by default)
    train_n_rays: int = 4096
    # the training march budget, which bounds the render budget too: the
    # field is only trained to explain pixels within that march
    train_k: int = 64
    # compacted training: march every ray to completion (at most
    # max_samples_per_ray samples), pack the samples into one dense batch
    # and follow the measured samples a ray with the ray count; the legacy
    # two-phase path (False) is not ported yet
    compact_training: bool = True
    max_samples_per_ray: int = 1024
    # the training near plane: closer than this the field is untrained
    near_distance: float = 0.1
    grid_interval: int = 16  # steps a bundle: one occupancy update each
    dense_until: int = 256  # dense occupancy refresh before this step ...
    dense_every_updates: int = 16  # ... and every this many updates after
    min_transmittance: float = 1e-4
    # error-map importance sampling after a uniform warm-up
    use_error_map: bool = True
    error_map_res: int = 32
    error_map_warmup: int = 256
    # optional learners and loss terms (Slice C2 of ROADMAP.md): setting
    # one raises NotImplementedError when training starts
    optimize_extrinsics: bool = False
    optimize_focal: bool = False
    optimize_exposure: bool = False
    optimize_distortion: bool = False
    near_density_reg: float = 0.0
    near_reg_fraction: float = 0.25
    depth_supervision_lambda: float = 0.0
    train_envmap: bool = False
    rolling_shutter: np.ndarray | None = None
    optimize_extra_dims: bool = False
    render_chunk: int = 16  # samples per ray between field evaluations
    render_max_chunks: int = 96
    # packed hash table for the forward-only render path: "bf16", "fp8" or
    # "none" (render from the f32 table)
    render_table_pack: str = "bf16"
    # march iterations per round, as a multiple of render_chunk
    render_march_iters_mult: float = 3.0
    # interactive early-out of the composite (the eval protocol uses 1e-4)
    render_min_transmittance: float = 0.01
    # per-frame advance of every ray to its first occupied voxel; 0 disables
    init_advance_iters: int = 160
    # host copies of the dataset (create); the device copies live in .data
    images: np.ndarray | None = None
    xforms: np.ndarray | None = None
    focals: np.ndarray | None = None
    principal_points: np.ndarray | None = None
    resolution: tuple = (0, 0)
    lens: Lens = field(default_factory=Lens)
    visible_mask: np.ndarray | None = None
    data: dict | None = None
    device: torch.device = field(default_factory=lambda: torch.device("cuda"))

    @staticmethod
    def create(network_config: dict, dataset: NerfDataset, train_batch_size: int = 1 << 18,
               grid_size: int = 128, train_k: int = 64, near_density_reg: float = 0.0,
               near_reg_fraction: float = 0.25,
               device: str | torch.device = "cuda") -> "NerfEngine":
        """An engine for `dataset` on `device`: the network, optimizer and
        occupancy configs, the cells some camera sees, and the device
        copies of the images and cameras.  A dataset that needs an optional
        learner of Slice C2 (extra dims, light directions, an envmap,
        rolling shutter, depth), or a near-density regulariser, raises
        NotImplementedError."""
        c2 = "is not ported yet: Slice C2 of ROADMAP.md"
        if dataset.n_extra_dims:
            raise NotImplementedError(f"extra-dim conditioning (light dirs, latent codes) {c2}")
        if dataset.envmap is not None:
            raise NotImplementedError(f"the trainable envmap {c2}")
        if dataset.xforms_end is not None:
            raise NotImplementedError(f"rolling shutter and motion blur {c2}")
        if dataset.depths is not None:
            raise NotImplementedError(f"depth supervision {c2}")
        aabb_scale = dataset.aabb_scale
        net = NerfNetworkConfig.from_network_config(network_config, aabb_scale=aabb_scale,
                                                    hdr=dataset.is_hdr)
        n_casc = n_cascades_for_aabb_scale(aabb_scale)
        occ = OccupancyConfig(n_cascades=n_casc, grid_size=grid_size)
        march = MarchConfig(n_cascades=n_casc, cone_angle=cone_angle_for_aabb(aabb_scale),
                            grid_size=grid_size)
        dev = torch.device(device)
        eng = NerfEngine(
            net=net,
            aabb=BoundingBox.from_scale(aabb_scale),
            march=march,
            opt=OptimizerSpec.from_network_config(network_config.get("optimizer", {})),
            occ=occ,
            loss_otype=network_config.get("loss", {}).get("otype", "Huber"),
            train_n_rays=max(256, train_batch_size // train_k),
            train_k=train_k,
            images=np.asarray(dataset.images),
            xforms=np.asarray(dataset.xforms),
            focals=np.asarray(dataset.focal_lengths),
            principal_points=np.asarray(dataset.principal_points),
            resolution=dataset.resolution,
            lens=dataset.lens,
            near_density_reg=near_density_reg,
            near_reg_fraction=near_reg_fraction,
            device=dev,
        )
        eng._check_trainable()
        eng.visible_mask = mark_untrained_cells(
            occ, dataset.xforms, dataset.focal_lengths,
            np.asarray([dataset.resolution] * len(dataset.xforms), np.float32))

        def put(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

        eng.data = {"images": put(eng.images.astype(np.float32)),
                    "xforms": put(eng.xforms.astype(np.float32)),
                    "focals": put(eng.focals.astype(np.float32)),
                    "pp": put(eng.principal_points.astype(np.float32)),
                    "visible_mask": put(eng.visible_mask)}
        return eng

    @staticmethod
    def from_ingp(path, dataset: NerfDataset | None = None,
                  train_batch_size: int = 1 << 18,
                  device: str | torch.device = "cuda"):
        """An engine and state from a reference .ingp / .msgpack snapshot
        -> (engine, state).  The hash table keeps tcnn's corner layout; the
        occupancy grid, of the stored density grid's size, comes from that
        grid.  Without a dataset the engine renders from cameras the caller
        gives."""
        from sienerf_torch.io.ingp import import_ingp

        out = import_ingp(path)
        aabb_scale = out["meta"]["aabb_scale"]
        if dataset is None:
            dataset = dataclasses.replace(
                NerfDataset.placeholder(aabb_scale),
                n_extra_learnable_dims=int(out["meta"].get("n_extra_learnable_dims", 0)))
        grid_size = 128 if out["density_grid"] is None else int(out["density_grid"].shape[1])
        eng = NerfEngine.create(out["config"], dataset, train_batch_size=train_batch_size,
                                grid_size=grid_size, device=device)
        state = eng.init(0)
        dev = eng.device
        params = dict(state["params"])
        for k, v in out["params"].items():
            params[k] = ([torch.from_numpy(np.array(w)).to(dev) for w in v]
                         if isinstance(v, list) else torch.from_numpy(np.array(v)).to(dev))
        state["params"] = params
        state["opt"] = optim_init(params, eng.opt)
        if out["density_grid"] is not None:
            dens = torch.from_numpy(np.array(out["density_grid"], np.float32)).to(dev)
            n_casc = state["occ"]["density"].shape[0]
            if dens.shape[0] < n_casc:  # the snapshot stored fewer cascades
                pad = torch.zeros((n_casc - dens.shape[0],) + tuple(dens.shape[1:]),
                                  dtype=dens.dtype, device=dev)
                dens = torch.cat([dens, pad])
            dens, bitfield, mean = density_to_bitfield(dens[:n_casc])
            state["occ"] = {"density": dens, "bitfield": bitfield, "mean_density": mean,
                            "n_updates": 1}
        state["step"] = int(out["meta"]["training_step"])
        eng._phase = "fast"
        return eng, state

    def init(self, seed: int = 1337) -> dict:
        """A fresh training state: params, optimizer state, occupancy grid,
        step 0 and the error map, drawn from a generator seeded with
        `seed` on the engine's device."""
        gen = torch.Generator(device=self.device).manual_seed(seed)
        params = init_nerf_network(self.net, gen, self.device)
        state = {
            "params": params,
            "opt": optim_init(params, self.opt),
            "occ": init_occupancy_state(self.occ, self.device),
            "step": 0,
        }
        if self.use_error_map:
            state["emap"] = init_error_map(self.images.shape[0], self.error_map_res,
                                           self.device)
        return state

    # --- shared pieces ----------------------------------------------------

    def _aabb_times(self, origins, dirs, near: float):
        tmin, tmax = self.aabb.ray_intersect(origins, dirs)
        t0 = torch.clamp(tmin, min=near)
        return t0, torch.maximum(tmax, t0)

    def _render_near(self) -> float:
        return max(NERF_RENDERING_NEAR_DISTANCE, self.near_distance)

    def _eval_samples(self, params, origins, dirs, ts, dts, counts):
        """Evaluate the field at (N, K) marched samples -> activated rgb
        (N, K, 3), density (N, K), valid (N, K)."""
        N, K = ts.shape
        dev = ts.device
        valid = torch.arange(K, device=dev)[None, :] < counts[:, None]
        pos = origins[:, None, :] + ts[..., None] * dirs[:, None, :]
        unit = (pos - torch.as_tensor(self.aabb.min, device=dev)) \
            / torch.as_tensor(self.aabb.diag, device=dev)
        unit = unit.clamp(0.0, 1.0)
        dirw = (dirs / _norm(dirs) + 1.0) * 0.5
        dirw = dirw[:, None, :].expand(N, K, 3)
        rgb_raw, dens_raw = nerf_apply(self.net, params, unit.reshape(-1, 3),
                                       dirw.reshape(-1, 3))
        rgb = apply_rgb_activation(rgb_raw, self.net.rgb_activation).reshape(N, K, 3)
        dens = apply_density_activation(dens_raw, self.net.density_activation).reshape(N, K)
        return rgb, torch.where(valid, dens, 0.0), valid

    def _aabb_tensors(self):
        return (torch.as_tensor(self.aabb.min, device=self.device),
                torch.as_tensor(self.aabb.diag, device=self.device))

    # --- training ---------------------------------------------------------

    def _check_trainable(self) -> None:
        c2 = "is not ported yet: Slice C2 of ROADMAP.md"
        if not self.compact_training:
            raise NotImplementedError(f"the two-phase path (compact_training=False) {c2}")
        for on, what in ((self.optimize_extrinsics, "extrinsics optimisation"),
                         (self.optimize_focal, "focal optimisation"),
                         (self.optimize_exposure, "exposure optimisation"),
                         (self.optimize_distortion, "the trainable distortion map"),
                         (self.optimize_extra_dims, "extra-dim conditioning"),
                         (self.train_envmap, "the trainable envmap"),
                         (self.near_density_reg > 0.0, "the near-density regulariser"),
                         (self.depth_supervision_lambda > 0.0, "depth supervision"),
                         (self.rolling_shutter is not None, "rolling shutter")):
            if on:
                raise NotImplementedError(f"{what} {c2}")

    def draw_step(self, generator: torch.Generator, n_rays: int, step: int) -> dict:
        """The random part of one training step, on the engine's device:
        the rays' images and pixels (uniform "img_idx" and "uv" before the
        error map's warm-up ends, the sampler's uniforms "emap" after), the
        first-sample jitter and the random background."""
        dev = self.device
        d = {}
        if self.use_error_map and step >= self.error_map_warmup:
            d["emap"] = draw_error_map_uniforms(n_rays, generator, dev)
        else:
            d["img_idx"] = torch.randint(0, self.images.shape[0], (n_rays,),
                                         generator=generator, device=dev)
            d["uv"] = torch.rand((n_rays, 2), generator=generator, device=dev)
        d["jitter"] = torch.rand((n_rays,), generator=generator, device=dev)
        d["bg"] = torch.rand((n_rays, 3), generator=generator, device=dev)
        return d

    def _sample_training_rays(self, draws: dict, emap: dict | None):
        """draws -> (origins, dirs, target rgba, background, (img_idx, u, v)
        at the pixel centres).  Pinhole cameras."""
        w, h = self.resolution
        data = self.data
        if "emap" in draws:
            img_idx, u, v = sample_error_map(emap, draws["emap"])
        else:
            img_idx, u, v = draws["img_idx"], draws["uv"][:, 0], draws["uv"][:, 1]
        img_idx = img_idx.to(torch.int64)
        px = torch.clamp((u * w).to(torch.int64), max=w - 1)
        py = torch.clamp((v * h).to(torch.int64), max=h - 1)
        uv = torch.stack([(px.float() + 0.5) / w, (py.float() + 0.5) / h], dim=-1)
        origins, dirs = _batched_uv_to_ray(uv, (w, h), data["focals"][img_idx],
                                           data["pp"][img_idx], data["xforms"][img_idx],
                                           self.lens)
        target = data["images"].reshape(-1, 4)[(img_idx * h + py) * w + px]
        return origins, dirs, target, draws["bg"], (img_idx, uv[:, 0], uv[:, 1])

    def _loss_for_batch(self, params: dict, bitfield: torch.Tensor, draws: dict,
                        emap: dict | None, k: int, iters: int, clock: "_PhaseClock"):
        """The compacted training loss of one batch -> (loss, (counts,
        per-ray loss, (img_idx, u, v)))."""
        origins, dirs, target, bg, ray_meta = self._sample_training_rays(draws, emap)
        dirs_n = dirs / _norm(dirs)
        t0, t1 = self._aabb_times(origins, dirs_n, self.near_distance)
        # first-sample jitter: decorrelates the sample lattice across steps
        t0 = t0 + calc_dt(t0, self.march.cone_angle) * draws["jitter"]
        clock.phase("sample")
        ts, dts, counts, t_end = march_rays(self.march, bitfield, origins, dirs_n, t0, t1,
                                            k, iters)
        n = origins.shape[0]
        t_f, dt_f, ray_id, ray_start, fits = compact_samples(
            ts, dts, counts, self.train_n_rays * self.train_k)
        rid = torch.clamp(ray_id.to(torch.int64), max=n - 1)
        o_s, d_s = origins[rid], dirs_n[rid]
        pos = o_s + t_f[:, None] * d_s
        amin, adiag = self._aabb_tensors()
        unit = torch.clamp((pos - amin) / adiag, 0.0, 1.0)
        dirw = (d_s + 1.0) * 0.5
        clock.phase("march")
        rgb_raw, dens_raw = nerf_apply(self.net, params, unit, dirw)
        clock.phase("field")
        if clock.sync and rgb_raw.requires_grad:
            # the backward reaches the field's outputs when the composite's
            # and the loss's backward are done
            for t in (rgb_raw, dens_raw):
                t.register_hook(lambda g: clock.phase("composite"))
        rgb_s = apply_rgb_activation(rgb_raw, self.net.rgb_activation)
        dens_s = apply_density_activation(dens_raw, self.net.density_activation)
        rgb_sum, _, T_out, _ = composite_flat(rgb_s, dens_s, t_f, dt_f, ray_id, ray_start,
                                              n, self.min_transmittance)
        # a ray trains only when its march completed: it left the scene or
        # its transmittance fell below the threshold; a ray cut by the
        # sample cap or the iteration budget would train a fog billboard
        fits = fits & ((t_end >= t1) | (T_out < self.min_transmittance))
        pred = rgb_sum + T_out[:, None] * bg
        # the target composited over the same background
        gt = target[:, :3] * target[:, 3:4] + bg.detach() * (1.0 - target[:, 3:4])
        per_ray = get_loss(self.loss_otype)(pred, gt).mean(dim=-1)
        # masked pixels carry negative rgb and add nothing; the mean's
        # denominator counts the rays that train
        ray_ok = (target[:, 0] >= 0.0) & fits
        per_ray = torch.where(ray_ok, per_ray, 0.0)
        loss = per_ray.sum() / torch.clamp(ray_ok.float().sum(), min=1.0)
        return loss, (counts, per_ray, ray_meta)

    def loss_and_grads(self, state: dict, draws: dict, k: int, iters: int,
                       clock: "_PhaseClock | None" = None):
        """The loss of one batch and its gradient in every param leaf ->
        (loss, grads like params, (counts, per-ray loss, ray meta))."""
        clock = clock or _PhaseClock(None, self.device)
        with torch.enable_grad():
            p_req = tree_map(lambda t: t.detach().requires_grad_(True), state["params"])
            loss, aux = self._loss_for_batch(p_req, state["occ"]["bitfield"], draws,
                                             state.get("emap"), k, iters, clock)
            clock.phase("composite")
            grads = torch.autograd.grad(loss, tree_leaves(p_req))
        clock.phase("field")
        return loss.detach(), tree_unflatten(state["params"], list(grads)), aux

    def train_step(self, state: dict, draws: dict, k: int, iters: int,
                   clock: "_PhaseClock | None" = None):
        """One step from `draws` (draw_step) -> (new state, loss, mean
        samples a ray), the two numbers as 0-d tensors."""
        self._check_trainable()
        clock = clock or _PhaseClock(None, self.device)
        loss, grads, (counts, per_ray, ray_meta) = self.loss_and_grads(
            state, draws, k, iters, clock)
        params, opt = optim_step(self.opt, state["opt"], state["params"], grads,
                                 nerf_l2_mask(state["params"]))
        new_state = {**state, "params": params, "opt": opt, "step": int(state["step"]) + 1}
        if "emap" in state:
            img_idx, u, v = ray_meta
            new_state["emap"] = splat_errors(state["emap"], img_idx, u, v, per_ray.detach())
        clock.phase("optimizer")
        return new_state, loss, counts.float().mean()

    def _dense_update(self, state: dict) -> bool:
        return (int(state["step"]) < self.dense_until
                or int(state["occ"]["n_updates"]) % self.dense_every_updates == 0)

    def draw_occupancy(self, state: dict, generator: torch.Generator):
        """The random part of the occupancy update due at `state`: dense
        before step `dense_until` and every `dense_every_updates` updates,
        else G^3/4 random cells a cascade."""
        return draw_density_update(self.occ, self._dense_update(state), generator,
                                   self.device)

    def occupancy_update(self, state: dict, draws) -> dict:
        """Fold the density of the current (raw) params at the drawn cells
        into the occupancy grid."""
        params = state["params"]

        def density(unit):
            return apply_density_activation(density_raw(self.net, params, unit),
                                            self.net.density_activation)

        amin, adiag = self._aabb_tensors()
        occ = update_density_grid(self.occ, state["occ"], density, draws, amin, adiag,
                                  self.data["visible_mask"])
        return {**state, "occ": occ}

    def _phase_geometry(self):
        """(n_rays, k, march_iters) of the next bundle.  The first marches
        1024-sample rays; later ones set k from the measured samples a ray
        and the ray count so that the compacted samples fill the
        train_n_rays * train_k batch, both in power-of-four buckets (they
        define the batch, and in the reference each pair is a compile)."""
        M = self.train_n_rays * self.train_k
        mean = getattr(self, "_mean_samples", None)
        if not mean or mean <= 0:
            k = self.max_samples_per_ray
            n_rays = max(64, M // k)
        else:
            k = int(np.clip(4 ** int(np.ceil(np.log(max(2.0 * mean, 16.0)) / np.log(4))),
                            16, self.max_samples_per_ray))
            want = 1.15 * M / mean
            n_rays = 4 ** int(np.clip(np.round(np.log(max(want, 64.0)) / np.log(4)), 3, 8))
        return n_rays, k, int(k + k // 2 + 128)

    def _update_phase(self, mean_count: float) -> None:
        if mean_count > 0:
            prev = getattr(self, "_mean_samples", None)
            self._mean_samples = mean_count if not prev else 0.7 * prev + 0.3 * mean_count

    def train_bundle(self, state: dict, generator: torch.Generator,
                     stats: dict | None = None):
        """One occupancy update, then grid_interval steps -> (state, mean
        loss, mean samples a ray), the two numbers as 0-d tensors.

        `stats`, when given, receives the bundle's n_rays, k and march
        iterations, and with stats["sync_phases"] set the seconds of each
        training phase (TRAIN_PHASES), measured by synchronising the device
        after each (which slows the bundle)."""
        self._check_trainable()
        clock = _PhaseClock(stats, self.device, TRAIN_PHASES)
        n_rays, k, iters = self._phase_geometry()
        state = self.occupancy_update(state, self.draw_occupancy(state, generator))
        clock.phase("occupancy")
        losses, counts = [], []
        for _ in range(self.grid_interval):
            draws = self.draw_step(generator, n_rays, int(state["step"]))
            state, loss, cnt = self.train_step(state, draws, k, iters, clock)
            losses.append(loss)
            counts.append(cnt)
        loss, cnt = torch.stack(losses).mean(), torch.stack(counts).mean()
        self._update_phase(float(cnt))
        if stats is not None:
            stats.update(n_rays=n_rays, k=k, iters=iters)
        return state, loss, cnt

    def eval_psnr(self, state: dict, view_indices, background=(0.0, 0.0, 0.0),
                  downscale: int = 1):
        """PSNR of live frames of the EMA params at training cameras
        against their images composited over `background` (the eval
        protocol: min transmittance 1e-4) -> (mean, per view)."""
        params = inference_params(state["opt"], state["params"])
        w, h = self.resolution
        psnrs = []
        for vi in view_indices:
            rgba, _ = self.render_frame(
                params, state["occ"]["bitfield"], w // downscale, h // downscale,
                self.xforms[vi], tuple(np.asarray(self.focals[vi]) / downscale),
                screen_center=tuple(np.asarray(self.principal_points[vi])),
                min_transmittance=1e-4)
            gt = np.asarray(self.images[vi])[::downscale, ::downscale]
            bg = np.asarray(background, np.float32)
            gt_rgb = gt[..., :3] * gt[..., 3:4] + bg * (1.0 - gt[..., 3:4])
            mse = float(np.mean((rgba[..., :3].cpu().numpy() - gt_rgb) ** 2))
            psnrs.append(-10.0 * math.log10(max(mse, 1e-12)))
        return float(np.mean(psnrs)), psnrs

    # --- rendering --------------------------------------------------------

    def _mode_sample_colors(self, params, origins, dirs, ts, dts, counts, render_mode):
        """Per-sample colours of a render visualisation mode: positions,
        depth and ao replace the sample colour, glow adds an overlay."""
        rgb, dens, valid = self._eval_samples(params, origins, dirs, ts, dts, counts)
        mode = render_mode or "shade"
        if mode in ("shade", "cost"):
            return rgb, dens, valid
        pos = origins[:, None, :] + ts[..., None] * dirs[:, None, :]
        if mode.startswith("glow"):
            return self._glow_samples(mode, pos, origins, rgb, dens, dts, valid)
        if mode == "positions":
            rgb = (pos - 0.5) / 2.0 + 0.5
        elif mode == "depth":
            rgb = ts[..., None].expand(pos.shape)
        elif mode == "ao":
            alpha = 1.0 - torch.exp(-dens * dts)
            rgb = alpha[..., None].expand(pos.shape)
        elif mode == "normals":
            # the normal points where density falls: minus the density's
            # position gradient, through the hash grid's backward
            amin, adiag = self._aabb_tensors()
            N, K = ts.shape
            with torch.enable_grad():
                unit = ((pos.reshape(-1, 3) - amin) / adiag).clamp(0.0, 1.0)
                unit = unit.detach().requires_grad_(True)
                dens_u = apply_density_activation(density_raw(self.net, params, unit),
                                                  self.net.density_activation)
                (g,) = torch.autograd.grad(dens_u.sum(), unit)
            rgb = -g.reshape(N, K, 3)
        elif mode == "encoding_vis":
            # the network-domain position
            dev = pos.device
            rgb = ((pos - torch.as_tensor(self.aabb.min, device=dev))
                   / torch.as_tensor(self.aabb.diag, device=dev)).clamp(0.0, 1.0)
        else:
            raise ValueError(f"render mode {mode} not supported for NeRF")
        return rgb, dens, valid

    @staticmethod
    def _glow_samples(mode, pos, origins, rgb, dens, dts, valid):
        """Glow overlay: a height or radial band glow with cosine gridlines
        added to the sample colour.  Mode string
        "glow[:glow_mode[:y_cutoff]]"; glow_mode is a bitmask (1 green grid,
        2 cutline, 4 mask-to-alpha, 8 radial, 16 grid), default 1, y_cutoff
        default 0.  mask-to-alpha scales the sample's alpha by the band
        mask, folded into the density the compositor sees as
        sigma' = -log(1 - mask*alpha) / dt."""
        parts = mode.split(":")
        glow_mode = int(parts[1]) if len(parts) > 1 else 1
        y_cutoff = float(parts[2]) if len(parts) > 2 else 0.0
        green_grid, green_cutline = glow_mode & 1, glow_mode & 2
        mask_to_alpha, radial, grid_mode = glow_mode & 4, glow_mode & 8, glow_mode & 16

        if radial:
            dist = _norm(pos - origins[:, None, :])[..., 0]
            dist = torch.minimum(dist, (4.5 - pos[..., 1]) * 0.333)
        else:
            dist = pos[..., 1]
        if grid_mode:
            glow = 1.0 / torch.clamp(dist, min=1.0)
            mask = torch.ones_like(dist)
        else:
            y = (y_cutoff - dist) * 80.0
            in_band = y > 0.0
            mask = torch.where(in_band, torch.clamp(y, max=1.0), 0.0)
            glow = torch.zeros_like(dist)
            if green_cutline:
                glow = glow + torch.where(
                    in_band, torch.clamp(1.0 - torch.abs(1.0 - y), min=0.0) * 4.0, 0.0)
            y2 = torch.where(y > 1.0, 1.0 - (y - 1.0) * 0.05, y)
            if green_grid:
                glow = glow + torch.where(
                    in_band, torch.clamp(y2 / torch.clamp(dist, min=1.0), min=0.0), 0.0)
        # cosine gridlines at 4 octaves per axis
        line = torch.zeros_like(dist)
        for s in (2.0, 4.0, 8.0, 16.0):
            line = line + torch.clamp(
                torch.cos(pos * s * torch.pi * 16.0) - 0.975, min=0.0).sum(dim=-1)
        tint = torch.tensor([0.25, 1.0, 0.5], dtype=torch.float32, device=pos.device)
        if grid_mode:
            rgb = (glow * line * 15.0)[..., None] * tint
        else:
            g = torch.where(glow > 0.0, glow * glow * 0.25 + glow * line * 15.0, 0.0)
            rgb = rgb + g[..., None] * tint
        if mask_to_alpha:
            alpha = 1.0 - torch.exp(-dens * dts)
            scaled = (mask * alpha).clamp(0.0, 1.0 - 1e-7)
            dens = torch.where(dts > 0.0,
                               -torch.log1p(-scaled) / torch.clamp(dts, min=1e-12), dens)
        return rgb, dens, valid

    @staticmethod
    def _mode_epilogue(rgb: torch.Tensor, opacity: torch.Tensor, render_mode):
        """Per-mode frame epilogue: mode `normals` normalises the
        composited gradient and maps it to [0, 1], weighted by opacity."""
        if render_mode == "normals":
            n = rgb / torch.clamp(_norm(rgb), min=1e-9)
            return (0.5 * n + 0.5) * opacity[..., None]
        return rgb

    @staticmethod
    def _check_mode(render_mode) -> None:
        mode = render_mode or "shade"
        if mode == "distortion":
            raise NotImplementedError(
                "render mode 'distortion' (the trainable distortion map) is not ported "
                "yet: Slice C2 of ROADMAP.md")
        if mode not in RENDER_MODES and not mode.startswith("glow"):
            raise ValueError(f"render mode {mode} not supported for NeRF")

    def _march_iters(self) -> int:
        return max(int(self.render_chunk * self.render_march_iters_mult), self.render_chunk)

    def _render_budget(self) -> int:
        """Per-ray render sample budget = the training march budget: the
        full cap under compact training, train_k otherwise."""
        return self.max_samples_per_ray if self.compact_training else self.train_k

    def _min_t(self, min_transmittance) -> float:
        return float(self.render_min_transmittance if min_transmittance is None
                     else min_transmittance)

    @torch.no_grad()
    def render_rays(self, params, bitfield, origins, dirs, near=None, t_cap=None,
                    min_transmittance=None, fine_bitfield=None, render_mode=None):
        """Fixed-size ray batch -> (rgb (N, 3), opacity (N,), depth (N,)).

        Rounds of `render_chunk` samples between field evaluations, until
        every ray is dead.  `t_cap` (optional, per ray, in units of the
        unnormalised `dirs`) bounds the march, as a hybrid pass stops rays
        at mesh surfaces.  `min_transmittance` defaults to the interactive
        early-out (render_min_transmittance)."""
        self._check_mode(render_mode)
        if near is None:
            near = self._render_near()
        min_t = self._min_t(min_transmittance)
        dn = _norm(dirs)
        dirs_n = dirs / dn
        t0, t1 = self._aabb_times(origins, dirs_n, near)
        # clamp entry and exit to the tight box of the occupied cells
        blo, bhi = occupied_bbox(bitfield)
        btmin, btmax = ray_box_times(origins, dirs_n, blo, bhi)
        t0 = torch.maximum(t0, btmin)
        t1 = torch.maximum(torch.minimum(t1, btmax), t0)
        if t_cap is not None:
            t1 = torch.minimum(t1, t_cap * dn[:, 0])
        N, dev = origins.shape[0], origins.device
        budget = self._render_budget()
        words = pack_occupancy(bitfield)

        t = t0
        T = torch.ones((N,), dtype=torch.float32, device=dev)
        rgb_acc = torch.zeros((N, 3), dtype=torch.float32, device=dev)
        op_acc = torch.zeros((N,), dtype=torch.float32, device=dev)
        best_w = torch.zeros((N,), dtype=torch.float32, device=dev)
        best_t = torch.zeros((N,), dtype=torch.float32, device=dev)
        used = torch.zeros((N,), dtype=torch.int64, device=dev)
        for _ in range(self.render_max_chunks):
            active = (T >= min_t) & (t < t1) & (used < budget)
            if not bool(active.any()):
                break
            ts, dts, counts, t_end = march_rays(
                self.march, words, origins, dirs_n, t, t1, self.render_chunk,
                self._march_iters(), fine=fine_bitfield)
            counts = torch.where(active, counts, 0)
            rgb, dens, valid = self._mode_sample_colors(
                params, origins, dirs_n, ts, dts, counts, render_mode)
            rgb_sum, opacity, T_out, bw, bt = composite_chunk(
                rgb, dens, ts, dts, valid, T, min_t)
            better = bw > best_w
            t = torch.where(active, t_end, t)
            T = torch.where(active, T_out, T)
            rgb_acc = rgb_acc + torch.where(active[:, None], rgb_sum, 0.0)
            op_acc = op_acc + torch.where(active, opacity, 0.0)
            best_w = torch.where(better, bw, best_w)
            best_t = torch.where(better, bt, best_t)
            used = used + counts
        if render_mode == "cost":
            # samples-per-ray heatmap
            rgb_acc = (used.float() / 128.0)[:, None].expand(N, 3)
            op_acc = torch.ones_like(op_acc)
        rgb_acc = self._mode_epilogue(rgb_acc, op_acc, render_mode)
        # t is distance along the unit direction; depth is z-depth along the
        # camera axis, t / |dirs| for (x, y, 1) camera rays
        return rgb_acc, op_acc, best_t / dn[:, 0]

    @torch.no_grad()
    def render_frame(self, params, bitfield, width: int, height: int, camera_matrix,
                     focal_length, tile: int = 1 << 14, screen_center=(0.5, 0.5),
                     background=(0.0, 0.0, 0.0), min_transmittance=None,
                     fine_bitfield=None, pixel_offset=None, render_mode=None,
                     stats: dict | None = None):
        """Render a full frame with the streaming ray buffer -> rgba
        (H, W, 4) and depth (H, W) on the engine's params' device.

        `tile` is the number of ray slots; per-ray results do not depend on
        it.  `stats`, when given, receives the number of rounds, the
        samples the field evaluated, the seconds the host waited for the
        device's alive test, and (with stats["sync_phases"] set) the seconds
        of each phase."""
        self._check_mode(render_mode)
        dev = bitfield.device
        clock = _PhaseClock(stats, dev)
        if stats is not None:
            stats.update(rounds=0, host_wait_s=0.0)
        n = width * height
        A = min(tile, max(256, n))
        off = (0.5, 0.5) if pixel_offset is None else pixel_offset
        cam_spec = (width, height, focal_length, camera_matrix, screen_center, off)
        params = self._render_params(params)
        bounds = occupied_bbox(bitfield)
        # pack once; the per-round march probes the words (the fine grid's
        # with its grid size)
        words = pack_occupancy(bitfield)
        if fine_bitfield is not None:
            fine_bitfield = (pack_occupancy(fine_bitfield), int(fine_bitfield.shape[1]))

        # Build every pixel's ray once, advance each to its first occupied
        # voxel in one masked march over the whole frame, and keep them in
        # one table: a slot refill is then a row gather.
        ids_all = torch.arange(n, device=dev)
        o_a, d_a, dn_a, t0_a, t1_a = self._frame_make_rays(ids_all, n, cam_spec, bounds)
        clock.phase("setup")
        if self.init_advance_iters > 0:
            t0_a = advance_to_occupied(self.march, words, o_a, d_a, t0_a, t1_a,
                                       self.init_advance_iters)
        clock.phase("advance")
        rays_pre = self._frame_pack_rays(o_a, d_a, dn_a, t0_a, t1_a)

        ids0 = torch.arange(A, device=dev)
        o0, d0, dn0, t00, t10 = self._frame_take_rays(ids0, n, rays_pre)
        zero = torch.zeros((A,), dtype=torch.float32, device=dev)
        s = dict(
            ids=ids0, o=o0, d=d0, dnorm=dn0, t=t00, t1=t10,
            T=torch.ones((A,), dtype=torch.float32, device=dev),
            rgb=torch.zeros((A, 3), dtype=torch.float32, device=dev),
            op=zero, bw=zero, bt=zero,
            valid=ids0 < n,
            chunks=torch.zeros((A,), dtype=torch.int64, device=dev),
            used=torch.zeros((A,), dtype=torch.int64, device=dev),
            samples=torch.zeros((), dtype=torch.int64, device=dev),
            cursor=torch.full((), A, dtype=torch.int64, device=dev),
            minT=self._min_t(min_transmittance),
            # per-pixel output rows [r, g, b, opacity, depth]; row n takes
            # the writes of slots that have nothing to flush
            out=torch.zeros((n + 1, 5), dtype=torch.float32, device=dev),
        )
        clock.phase("setup")
        while clock.any_alive(self._frame_alive(s)):
            s = self._frame_round(s, params, words, n, rays_pre, fine_bitfield,
                                  render_mode, clock)
            if stats is not None:
                stats["rounds"] += 1
        if stats is not None:
            stats["samples"] = int(s["samples"])
        out = s["out"][:n]
        rgb = out[:, :3]
        opacity = out[:, 3]
        depth = out[:, 4]
        rgb = self._mode_epilogue(rgb, opacity, render_mode)
        if render_mode == "cost":
            opacity = torch.ones_like(opacity)
        bg = torch.as_tensor(np.asarray(background, np.float32), device=dev)
        if "envmap" in params:
            # the frame starts as the envmap's colour along each ray; the
            # background shows through the map's transparency
            bg = background_behind_envmap(params["envmap"], d_a, bg)
        rgb = rgb + (1.0 - opacity)[:, None] * bg
        rgba = torch.cat([rgb, opacity[:, None]], dim=-1)
        clock.phase("setup")
        return rgba.reshape(height, width, 4), depth.reshape(height, width)

    def _frame_make_rays(self, ids: torch.Tensor, n: int, cam_spec, bounds=None):
        """Pixel ids -> (origin, unit dir, |dir|, t0, t1) for a pinhole
        frame.  cam_spec = (width, height, focal, camera_matrix,
        screen_center, pixel_offset); `bounds` = (lo, hi) of the occupied
        cells clamps entry and exit."""
        width, height, focal_length, camera_matrix, screen_center, off = cam_spec
        ids_c = torch.clamp(ids, max=n - 1)
        px = (ids_c % width).float()
        py = (ids_c // width).float()
        off = np.asarray(off, np.float32)
        uv = torch.stack([(px + float(off[0])) / width,
                          (py + float(off[1])) / height], dim=-1)
        o, d = uv_to_ray(uv, (width, height), focal_length, camera_matrix,
                         screen_center, self.lens)
        dn = _norm(d)
        d_n = d / dn
        # render from the training near plane: closer than near_distance the
        # field got no gradient and reads as fog
        t0, t1 = self._aabb_times(o, d_n, self._render_near())
        if bounds is not None:
            btmin, btmax = ray_box_times(o, d_n, bounds[0], bounds[1])
            t0 = torch.maximum(t0, btmin)
            t1 = torch.maximum(torch.minimum(t1, btmax), t0)
        return o, d_n, dn[:, 0], t0, t1

    def _render_params(self, params: dict) -> dict:
        """Swap in a packed hash table for forward-only rendering."""
        if "grid_fp8" in params or "grid_bf16" in params:
            return params  # already packed (render-only snapshot)
        pack = self.render_table_pack
        if pack not in ("bf16", "fp8") or self.net.pos_otype != "grid" \
                or self.net.grid.layout != "cell":
            return params
        p = dict(params)
        if pack == "fp8":
            p["grid_fp8"], p["grid_fp8_scale"] = pack_table_fp8(self.net.grid, params["grid"])
        else:
            p["grid_bf16"] = pack_table_bf16(self.net.grid, params["grid"])
        del p["grid"]
        return p

    def bake_render_grid(self, params, occ_state, factor: int = 4) -> torch.Tensor:
        """The fine render grid (ops/occupancy.py::bake_fine_bitfield) of
        the current field at `factor` x the training grid, for
        render_frame's `fine_bitfield`: frames then skip the samples of
        near-zero density that the training grid cannot tell apart.
        -> (C, 128 f, 128 f, 128 f) bool on the engine's device."""
        def density(pos):
            return apply_density_activation(density_raw(self.net, params, pos),
                                            self.net.density_activation)

        return bake_fine_bitfield(density, occ_state["bitfield"],
                                  float(occ_state["mean_density"]), factor=factor)

    def bake_features(self, params: dict, occ_state: dict, resolution: int = 256,
                      mode: str = "nearest", row_bits: int = 16):
        """Bake the density branch into the render-side row table
        (engines/nerf_baked.py) -> (grid, meta)."""
        from sienerf_torch.engines.nerf_baked import bake_feature_grid

        return bake_feature_grid(self, params, occ_state["bitfield"], resolution,
                                 mode, row_bits=row_bits)

    def _frame_alive(self, s: dict) -> torch.Tensor:
        return (s["valid"] & (s["T"] >= s["minT"]) & (s["t"] < s["t1"])
                & (s["chunks"] < self.render_max_chunks)
                & (s["used"] < self._render_budget()))

    @staticmethod
    def _frame_pack_rays(o, d, dn, t0, t1) -> torch.Tensor:
        """Per-pixel ray data as one (n + 1, 9) f32 table [o, d, |d|, t0,
        t1], so that a slot refill is one row gather.  Row n is a harmless
        dead ray (unit dir, t0 == t1 == 0; a zero dir would give inf skips
        and NaN positions in masked slots)."""
        n = o.shape[0]
        packed = torch.zeros((n + 1, 9), dtype=torch.float32, device=o.device)
        packed[:n, 0:3] = o
        packed[:n, 3:6] = d
        packed[:n, 6] = dn
        packed[:n, 7] = t0
        packed[:n, 8] = t1
        packed[n, 5] = 1.0
        packed[n, 6] = 1.0
        return packed

    @staticmethod
    def _frame_take_rays(ids, n: int, rays_pre):
        """Gather the cached rays of pixel ids; ids past the frame take the
        dead ray in row n."""
        r = rays_pre.index_select(0, torch.clamp(ids, max=n))
        return r[:, 0:3], r[:, 3:6], r[:, 6], r[:, 7], r[:, 8]

    def _frame_round(self, s, params, words, n, rays_pre, fine_bitfield, render_mode,
                     clock: _PhaseClock):
        """One round of the streaming renderer: march a chunk, evaluate and
        composite it, flush finished rays to the frame, refill their
        slots."""
        ts, dts, counts, t_end = march_rays(
            self.march, words, s["o"], s["d"], s["t"], s["t1"], self.render_chunk,
            self._march_iters(), fine=fine_bitfield)
        clock.phase("march")
        rgb, dens, valid_s = self._mode_sample_colors(
            params, s["o"], s["d"], ts, dts, counts, render_mode)
        clock.phase("eval")
        rgb_sum, opacity, T_out, bw, bt = composite_chunk(
            rgb, dens, ts, dts, valid_s, s["T"], s["minT"])
        was_alive = self._frame_alive(s)
        counts = torch.where(was_alive, counts, 0)
        better = was_alive & (bw > s["bw"])
        s2 = dict(
            s,
            rgb=s["rgb"] + torch.where(was_alive[:, None], rgb_sum, 0.0),
            op=s["op"] + torch.where(was_alive, opacity, 0.0),
            bw=torch.where(better, bw, s["bw"]),
            bt=torch.where(better, bt, s["bt"]),
            t=torch.where(was_alive, t_end, s["t"]),
            T=torch.where(was_alive, T_out, s["T"]),
            chunks=s["chunks"] + was_alive.to(torch.int64),
            used=s["used"] + counts,
            samples=s["samples"] + counts.sum(),
        )
        clock.phase("composite")
        s2 = self._frame_flush_refill(s, s2, n, rays_pre, self._frame_alive, render_mode)
        clock.phase("flush")
        return s2

    def _frame_flush_refill(self, s, s2, n, rays_pre, alive_fn, render_mode=None):
        """Tail of a round, shared with the baked renderer
        (engines/nerf_baked.py): write the rays that `alive_fn` finds
        finished to the frame's output rows, then refill their slots from
        the pixel stream.  The output table is updated in place.  Ray ids
        are unique and every slot with nothing to flush writes row n, which
        is sliced off, so the scatter needs no ordering."""
        now_alive = alive_fn(s2)
        done = s["valid"] & ~now_alive
        tgt = torch.where(done, s["ids"], n)
        colour = s2["rgb"]
        if render_mode == "cost":
            colour = (s2["used"].float() / 128.0)[:, None].expand(-1, 3)
        payload = torch.cat(
            [colour, s2["op"][:, None], (s2["bt"] / s["dnorm"])[:, None]], dim=1)
        s2["out"] = s2["out"].index_copy_(0, tgt, payload)
        # refill dead slots from the pixel stream
        rank = torch.cumsum(done.to(torch.int64), dim=0)
        new_id = s["cursor"] + rank - 1
        take = done & (new_id < n)
        ids_n = torch.where(take, new_id, s["ids"])
        o_n, d_n, dn_n, t0_n, t1_n = self._frame_take_rays(ids_n, n, rays_pre)
        sel = take[:, None]
        s2.update(
            ids=ids_n,
            o=torch.where(sel, o_n, s["o"]),
            d=torch.where(sel, d_n, s["d"]),
            dnorm=torch.where(take, dn_n, s["dnorm"]),
            t=torch.where(take, t0_n, s2["t"]),
            t1=torch.where(take, t1_n, s2["t1"]),
            T=torch.where(take, 1.0, s2["T"]),
            rgb=torch.where(sel, 0.0, s2["rgb"]),
            op=torch.where(take, 0.0, s2["op"]),
            bw=torch.where(take, 0.0, s2["bw"]),
            bt=torch.where(take, 0.0, s2["bt"]),
            chunks=torch.where(take, 0, s2["chunks"]),
            used=torch.where(take, 0, s2["used"]),
            valid=now_alive | take,
            cursor=s["cursor"] + done.sum(),
        )
        return s2


def _batched_uv_to_ray(uv: torch.Tensor, resolution, focal: torch.Tensor,
                       principal: torch.Tensor, xform: torch.Tensor, lens: Lens):
    """Rays of pinhole cameras given per ray: uv (N, 2), focal (N, 2),
    principal point (N, 2), xform (N, 3, 4) -> (origins, dirs).  The
    rotation is applied as explicit f32 products and sums, never a matmul
    that could run in TF32 (the reference's einsum is Precision.HIGHEST)."""
    if lens.mode != LensMode.PERSPECTIVE:
        raise NotImplementedError(f"lens {lens.mode} is not ported yet")
    w, h = resolution
    x = (uv[:, 0] - principal[:, 0]) * w / focal[:, 0]
    y = (uv[:, 1] - principal[:, 1]) * h / focal[:, 1]
    rot = xform[:, :3, :3]
    dirs = rot[:, :, 0] * x[:, None] + rot[:, :, 1] * y[:, None] + rot[:, :, 2]
    return xform[:, :3, 3], dirs
