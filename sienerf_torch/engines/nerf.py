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

The optional learners train with the field: per-camera se(3) deltas
(`cam`), a log-scale focal (`focal`), per-image exposure (`exposure`), the
32x32 distortion map (`distortion`), per-image extra dims (`extra_dims`:
latent codes, or fixed light directions at rate 0) and the lat-long envmap
(`envmap`), at `extrinsics_lr_scale` times the rate for the first three;
the loss takes depth supervision and the near-density regulariser; rays
follow rolling shutter and every lens of utils/camera.py.  A camera
learner moves the samples, so its gradient reaches the field through the
sample positions (the hash grid's position gradient) and through the
march's t chain (ops/raymarch.py::march_rays' `t_grad`); without one the
positions take no gradient.  Every sum of the learners' gradients over
rays or samples runs in a fixed order (ops/fixed_order.py::take_rows).
The legacy two-phase path (compact_training=False: a deep full-ray phase,
then fixed-k marching with an optional adaptive ray count) trains too.
`bake_render_grid` bakes the fine render grid that render_frame's
`fine_bitfield` takes; render mode `distortion` shows the lens and the
distortion map as a colour wheel of each pixel's uv shift.

Several devices (parallel/mesh.py: one process a device): the
data-parallel bundle `train_bundle_multichip` (the state replicated, the
ray batch and the occupancy cells split over the ranks, gradients
averaged in rank order), and frames with their rays split over the ranks
(`render_frame_multichip`, `render_views_multichip`).
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field

import numpy as np
import torch

from sienerf_torch.common import NERF_RENDERING_NEAR_DISTANCE
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
from sienerf_torch.ops.fixed_order import take_rows
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
from sienerf_torch.ops.tonemap import flow_to_rgb
from sienerf_torch.parallel.mesh import (
    all_gather,
    all_max,
    all_mean,
    rank_generator,
    shard_range,
)
from sienerf_torch.tracing import PhaseClock
from sienerf_torch.utils.bbox import BoundingBox
from sienerf_torch.utils.camera import (
    Lens,
    camera_slerp,
    pixel_grid_uv,
    rotate,
    undistort,
    uv_to_ray,
)

RENDER_MODES = ("shade", "cost", "positions", "depth", "ao", "encoding_vis", "normals")
_FRAME_PHASES = ("setup", "advance", "march", "eval", "composite", "flush")
# a training step's phases (train_bundle's stats)
TRAIN_PHASES = ("sample", "march", "field", "composite", "optimizer", "occupancy")


def _norm(x: torch.Tensor) -> torch.Tensor:
    return torch.sqrt((x * x).sum(dim=-1, keepdim=True))


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
    train_march_iters: int = 192  # march iterations of the legacy fast phase
    # compacted training: march every ray to completion (at most
    # max_samples_per_ray samples), pack the samples into one dense batch
    # and follow the measured samples a ray with the ray count.  False: the
    # legacy two-phase path, a deep phase of deep_k-sample rays until the
    # mean samples a ray fall under phase_switch_count * deep_k, then
    # train_k samples a ray (adapt_ray_count: the ray count follows the
    # measured samples, in power-of-two buckets)
    compact_training: bool = True
    max_samples_per_ray: int = 1024
    deep_k: int = 512
    deep_march_iters: int = 1280
    phase_switch_count: float = 0.75
    adapt_ray_count: bool = False
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
    # the optional learners: per-camera se(3) deltas, a log-scale focal and
    # per-image exposure (at extrinsics_lr_scale times the rate), the
    # trainable distortion map
    optimize_extrinsics: bool = False
    extrinsics_lr_scale: float = 1e-3
    optimize_focal: bool = False
    optimize_exposure: bool = False
    optimize_distortion: bool = False
    distortion_resolution: int = 32
    # the near-density regulariser (compact training only): an L1 penalty
    # on the optical thickness in the first near_reg_fraction of each ray
    near_density_reg: float = 0.0
    near_reg_fraction: float = 0.25
    # depth supervision, when the dataset has depth images
    depth_supervision_lambda: float = 0.0
    # the trainable lat-long envmap behind the random background (on when
    # the dataset has one; else black and opaque at envmap_resolution)
    train_envmap: bool = False
    envmap_resolution: tuple = (128, 256)  # (H, W)
    envmap_init: np.ndarray | None = None  # (H, W, 4)
    # rolling shutter and motion blur: a pixel's camera is slerped between
    # xforms and xforms_end at rs[0] + rs[1] u + rs[2] v + rs[3] * random
    rolling_shutter: np.ndarray | None = None
    # per-image extra dims: fixed light directions (the first 3, rate 0)
    # and/or learnable latent codes
    light_dirs: np.ndarray | None = None  # (N, 3) unit, NGP axes
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
        copies of the images and cameras (and of the end cameras and depth
        images, where the dataset has them).  The dataset's extra dims
        (learnable codes, plus 3 with light directions) widen the colour
        MLP; only learnable codes train.  Its rolling shutter and envmap
        turn those on."""
        aabb_scale = dataset.aabb_scale
        light_dirs = dataset.light_dirs
        net = NerfNetworkConfig.from_network_config(network_config, aabb_scale=aabb_scale,
                                                    n_extra_dims=dataset.n_extra_dims,
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
            light_dirs=None if light_dirs is None else np.asarray(light_dirs, np.float32),
            optimize_extra_dims=dataset.n_extra_learnable_dims > 0,
            device=dev,
        )
        if dataset.xforms_end is not None:
            eng.rolling_shutter = np.asarray(dataset.rolling_shutter, np.float32)
        if dataset.envmap is not None:
            eng.train_envmap = True
            eng.envmap_init = np.asarray(dataset.envmap, np.float32)
            eng.envmap_resolution = tuple(dataset.envmap.shape[:2])
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
        if dataset.xforms_end is not None:
            eng.data["xforms_end"] = put(np.asarray(dataset.xforms_end, np.float32))
        if dataset.depths is not None:
            eng.data["depths"] = put(np.asarray(dataset.depths, np.float32))
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
        """A fresh training state: params (and the leaves of the learners
        that are on), optimizer state, occupancy grid, step 0 and the error
        map, drawn from a generator seeded with `seed` on the engine's
        device.  Camera, focal, exposure and distortion leaves start at 0;
        the extra dims U[-1, 1] (light directions (d + 1) / 2 in the first
        3); the envmap at the dataset's map, else black and opaque (alpha
        takes no gradient)."""
        gen = torch.Generator(device=self.device).manual_seed(seed)
        params = init_nerf_network(self.net, gen, self.device)
        dev, n_img = self.device, self.images.shape[0]

        def zeros(*shape):
            return torch.zeros(shape, dtype=torch.float32, device=dev)

        if self.optimize_extrinsics:
            params["cam"] = zeros(n_img, 6)  # (rotation, translation) se(3) deltas
        if self.optimize_focal:
            params["focal"] = zeros(2)  # log scale of (fx, fy)
        if self.optimize_exposure:
            params["exposure"] = zeros(n_img, 1)
        if self.optimize_distortion:
            r = self.distortion_resolution
            params["distortion"] = zeros(r, r, 2)
        if self.net.n_extra_dims:
            ex = torch.empty((n_img, self.net.n_extra_dims), dtype=torch.float32,
                             device=dev).uniform_(-1.0, 1.0, generator=gen)
            if self.light_dirs is not None:
                ex[:, :3] = torch.from_numpy((self.light_dirs + 1.0) * 0.5).to(dev)
            params["extra_dims"] = ex
        if self.train_envmap:
            if self.envmap_init is not None:
                params["envmap"] = torch.from_numpy(
                    np.ascontiguousarray(self.envmap_init, np.float32)).to(dev)
            else:
                # opaque: alpha does not train, and a transparent map would
                # let each step's random background through for good
                params["envmap"] = zeros(*tuple(self.envmap_resolution), 4)
                params["envmap"][..., 3] = 1.0
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

    def _render_extra(self, params):
        """The extra-dim row frames use by default: training view 0's."""
        if self.net.n_extra_dims and "extra_dims" in params:
            return params["extra_dims"][0]
        return None

    def _eval_samples(self, params, origins, dirs, ts, dts, counts, extra=None):
        """Evaluate the field at (N, K) marched samples -> activated rgb
        (N, K, 3), density (N, K), valid (N, K).  `extra`: the extra-dim
        conditioning, one (E,) row for every ray or (N, E) a ray; None
        takes the render default (_render_extra)."""
        N, K = ts.shape
        dev = ts.device
        valid = torch.arange(K, device=dev)[None, :] < counts[:, None]
        pos = origins[:, None, :] + ts[..., None] * dirs[:, None, :]
        unit = (pos - torch.as_tensor(self.aabb.min, device=dev)) \
            / torch.as_tensor(self.aabb.diag, device=dev)
        unit = unit.clamp(0.0, 1.0)
        dirw = (dirs / _norm(dirs) + 1.0) * 0.5
        dirw = dirw[:, None, :].expand(N, K, 3)
        ex = None
        if self.net.n_extra_dims:
            if extra is None:
                extra = self._render_extra(params)
            if extra is not None:
                E = self.net.n_extra_dims
                extra = torch.as_tensor(extra, dtype=torch.float32, device=dev)
                ex = extra.expand(N * K, E) if extra.dim() == 1 \
                    else extra[:, None, :].expand(N, K, E).reshape(-1, E)
        rgb_raw, dens_raw = nerf_apply(self.net, params, unit.reshape(-1, 3),
                                       dirw.reshape(-1, 3), extra=ex)
        rgb = apply_rgb_activation(rgb_raw, self.net.rgb_activation).reshape(N, K, 3)
        dens = apply_density_activation(dens_raw, self.net.density_activation).reshape(N, K)
        return rgb, torch.where(valid, dens, 0.0), valid

    def _aabb_tensors(self):
        return (torch.as_tensor(self.aabb.min, device=self.device),
                torch.as_tensor(self.aabb.diag, device=self.device))

    # --- training ---------------------------------------------------------

    def _shutter(self) -> bool:
        return self.rolling_shutter is not None and "xforms_end" in self.data

    def draw_step(self, generator: torch.Generator, n_rays: int, step: int) -> dict:
        """The random part of one training step, on the engine's device:
        the rays' images and pixels (uniform "img_idx" and "uv" before the
        error map's warm-up ends, the sampler's uniforms "emap" after), the
        first-sample jitter, the random background and, with rolling
        shutter, each ray's motion-blur time "shutter"."""
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
        if self._shutter():
            d["shutter"] = torch.rand((n_rays,), generator=generator, device=dev)
        return d

    def _sample_training_rays(self, draws: dict, emap: dict | None, cam: dict | None = None):
        """draws -> (origins, dirs, target rgba, background, (img_idx, u, v)
        at the pixel centres, target depth or None).  Rolling shutter
        slerps each ray's camera; `cam` holds the camera learners' leaves
        ("cam", "focal", "distortion") that move the rays."""
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
        xf = data["xforms"][img_idx]
        if self._shutter():
            # the pixel's shutter time, plus a random motion-blur time.  The
            # slerp runs in float64 and rounds once: in f32 its quaternions
            # lose up to ~1e-4 (a small component is the square root of a
            # cancellation), and the card's and the CPU's last bits of
            # arccos and sin would then move rays apart by ~1e-6, enough to
            # move samples across occupancy boundaries
            rs = [float(x) for x in self.rolling_shutter]
            pixel_t = rs[0] + rs[1] * uv[:, 0] + rs[2] * uv[:, 1] + rs[3] * draws["shutter"]
            xf = camera_slerp(xf.double(), data["xforms_end"][img_idx].double(),
                              pixel_t.double()).float()
        fl = data["focals"][img_idx]
        cam = cam or {}
        if "cam" in cam:
            xf = _apply_se3_delta(xf, take_rows(cam["cam"], img_idx))
        if "focal" in cam:
            # exp in float64, rounded once: the same scale on every device
            fl = fl * torch.exp(cam["focal"].double()).float()[None, :]
        origins, dirs = _batched_uv_to_ray(uv, (w, h), fl, data["pp"][img_idx], xf,
                                           self.lens, cam.get("distortion"))
        pix = (img_idx * h + py) * w + px
        target = data["images"].reshape(-1, 4)[pix]
        depth = data["depths"].reshape(-1)[pix] if "depths" in data else None
        return origins, dirs, target, draws["bg"], (img_idx, uv[:, 0], uv[:, 1]), depth

    def _loss_for_batch(self, params: dict, bitfield: torch.Tensor, draws: dict,
                        emap: dict | None, k: int, iters: int, clock: "PhaseClock"):
        """The training loss of one batch -> (loss, (counts, per-ray loss,
        (img_idx, u, v)))."""
        cam = {n: params[n] for n in ("cam", "focal", "distortion") if n in params}
        origins, dirs, target, bg, ray_meta, depth_target = self._sample_training_rays(
            draws, emap, cam)
        dirs_n = dirs / _norm(dirs)
        t0, t1 = self._aabb_times(origins, dirs_n, self.near_distance)
        # first-sample jitter: decorrelates the sample lattice across steps
        t0 = t0 + calc_dt(t0, self.march.cone_angle) * draws["jitter"]
        # a camera learner moves the samples: their positions take its
        # gradient, along the march's t chain too
        t_grad = bool(origins.requires_grad or dirs_n.requires_grad)
        clock.phase("sample")
        marched = march_rays(self.march, bitfield, origins.detach(), dirs_n.detach(),
                             t0.detach(), t1.detach(), k, iters, t_grad=t_grad)
        ts, dts, counts, t_end = marched[:4]
        n = origins.shape[0]
        img_idx = ray_meta[0]
        extra = params.get("extra_dims") if self.net.n_extra_dims else None
        if self.compact_training:
            M = self.train_n_rays * self.train_k
            t_f, dt_f, ray_id, ray_start, fits = compact_samples(ts, dts, counts, M)
            rid = torch.clamp(ray_id.to(torch.int64), max=n - 1)
            if t_grad:
                g_t, g_dt = compact_samples(marched[4], marched[5], counts, M)[:2]
                t0_s = take_rows(t0, rid)
                shift = t0_s - t0_s.detach()  # 0, with t0's gradient
                t_f, dt_f = t_f + g_t * shift, dt_f + g_dt * shift
                o_s, d_s = take_rows(origins, rid), take_rows(dirs_n, rid)
            else:
                o_s, d_s = origins[rid], dirs_n[rid]
            pos = o_s + t_f[:, None] * d_s
            amin, adiag = self._aabb_tensors()
            unit = torch.clamp((pos - amin) / adiag, 0.0, 1.0)
            dirw = (d_s + 1.0) * 0.5
            # each sample's extra dims are its image's row
            ex_s = None if extra is None else take_rows(extra, img_idx[rid])
            clock.phase("march")
            rgb_raw, dens_raw = nerf_apply(self.net, params, unit, dirw, extra=ex_s)
            clock.phase("field")
            if clock.sync and rgb_raw.requires_grad:
                # the backward reaches the field's outputs when the
                # composite's and the loss's backward are done
                for t in (rgb_raw, dens_raw):
                    t.register_hook(lambda g: clock.phase("composite"))
            rgb_s = apply_rgb_activation(rgb_raw, self.net.rgb_activation)
            dens_s = apply_density_activation(dens_raw, self.net.density_activation)
            rgb_sum, _, T_out, depth_pred = composite_flat(
                rgb_s, dens_s, t_f, dt_f, ray_id, ray_start, n, self.min_transmittance)
            # a ray trains only when its march completed: it left the scene
            # or its transmittance fell below the threshold; a ray cut by
            # the sample cap or the iteration budget would train a fog
            # billboard
            fits = fits & ((t_end >= t1) | (T_out < self.min_transmittance))
        else:
            if t_grad:
                shift = (t0 - t0.detach())[:, None]
                ts, dts = ts + marched[4] * shift, dts + marched[5] * shift
            ex_r = None if extra is None else take_rows(extra, img_idx)
            clock.phase("march")
            rgb, dens, valid = self._eval_samples(params, origins, dirs_n, ts, dts, counts,
                                                  extra=ex_r)
            clock.phase("field")
            rgb_sum, _, T_out, _, _ = composite_chunk(
                rgb, dens, ts, dts, valid, torch.ones_like(t0), self.min_transmittance)
            fits = torch.ones((n,), dtype=torch.bool, device=t0.device)
            alpha = 1.0 - torch.exp(-dens * dts)
            cum = torch.cumprod(1.0 - alpha, dim=1)
            T_excl = torch.cat([torch.ones_like(cum[:, :1]), cum[:, :-1]], dim=1)
            depth_pred = (alpha * T_excl * ts).sum(dim=1)
        if "envmap" in params:
            # the random background composited behind the envmap
            bg = background_behind_envmap(params["envmap"], dirs_n, bg)
        pred = rgb_sum + T_out[:, None] * bg
        if "exposure" in params:
            pred = pred * torch.exp(take_rows(params["exposure"], img_idx))
        # the target composited over the same background, which takes no
        # gradient on this side (the envmap's gradient is the prediction's)
        gt = target[:, :3] * target[:, 3:4] + bg.detach() * (1.0 - target[:, 3:4])
        per_ray = get_loss(self.loss_otype)(pred, gt).mean(dim=-1)
        # masked pixels carry negative rgb and add nothing; the mean's
        # denominator counts the rays that train
        ray_ok = (target[:, 0] >= 0.0) & fits
        per_ray = torch.where(ray_ok, per_ray, 0.0)
        denom = torch.clamp(ray_ok.float().sum(), min=1.0)
        loss = per_ray.sum() / denom
        if self.near_density_reg > 0.0 and self.compact_training:
            # optical thickness in the first near_reg_fraction of each ray
            near_cut = (t0 + self.near_reg_fraction * (t1 - t0)).detach()[rid]
            near = (t_f < near_cut) & (ray_id.to(torch.int64) < n)
            reg = torch.where(near, dens_s * dt_f, 0.0).sum() / denom
            loss = loss + self.near_density_reg * reg
        if depth_target is not None and self.depth_supervision_lambda > 0.0:
            # rays with a depth (> 0): the expected termination distance
            d_ok = ray_ok & (depth_target > 0.0)
            d_err = torch.where(d_ok, (depth_pred - depth_target).abs(), 0.0)
            loss = loss + self.depth_supervision_lambda * d_err.sum() / denom
        return loss, (counts, per_ray, ray_meta)

    def loss_and_grads(self, state: dict, draws: dict, k: int, iters: int,
                       clock: "PhaseClock | None" = None):
        """The loss of one batch and its gradient in every param leaf ->
        (loss, grads like params, (counts, per-ray loss, ray meta))."""
        clock = clock or PhaseClock(None, self.device)
        with torch.enable_grad():
            p_req = tree_map(lambda t: t.detach().requires_grad_(True), state["params"])
            loss, aux = self._loss_for_batch(p_req, state["occ"]["bitfield"], draws,
                                             state.get("emap"), k, iters, clock)
            clock.phase("composite")
            grads = torch.autograd.grad(loss, tree_leaves(p_req))
        clock.phase("field")
        return loss.detach(), tree_unflatten(state["params"], list(grads)), aux

    def train_step(self, state: dict, draws: dict, k: int, iters: int,
                   clock: "PhaseClock | None" = None, mesh=None):
        """One step from `draws` (draw_step) -> (new state, loss, mean
        samples a ray), the two numbers as 0-d tensors.  The camera, focal
        and exposure leaves step at extrinsics_lr_scale times the rate;
        extra dims that are not learnable (light directions) do not
        move.  With a mesh (parallel/mesh.py) the draws are this rank's
        share of the batch: the gradients of every leaf, the loss and the
        mean samples a ray are averaged over the ranks in rank order, so
        that every rank takes the same step, and the error map takes every
        rank's rays."""
        clock = clock or PhaseClock(None, self.device)
        loss, grads, (counts, per_ray, ray_meta) = self.loss_and_grads(
            state, draws, k, iters, clock)
        cnt = counts.float().mean()
        if mesh is not None:
            loss, grads, cnt = _rank_mean(loss, grads, cnt, mesh)
        p = state["params"]
        lr_mask = None
        freeze_extra = "extra_dims" in p and not self.optimize_extra_dims
        if self.optimize_extrinsics or self.optimize_focal or self.optimize_exposure \
                or freeze_extra:
            lr_mask = tree_map(lambda _: 1.0, p)
            for leaf in ("cam", "focal", "exposure"):
                if leaf in p:
                    lr_mask[leaf] = self.extrinsics_lr_scale
            if freeze_extra:
                lr_mask["extra_dims"] = 0.0
        params, opt = optim_step(self.opt, state["opt"], p, grads, nerf_l2_mask(p), lr_mask)
        new_state = {**state, "params": params, "opt": opt, "step": int(state["step"]) + 1}
        if "emap" in state:
            img_idx, u, v = ray_meta
            new_state["emap"] = splat_errors(state["emap"], img_idx, u, v, per_ray.detach(),
                                             mesh)
        clock.phase("optimizer")
        return new_state, loss, cnt

    def _dense_update(self, state: dict) -> bool:
        return (int(state["step"]) < self.dense_until
                or int(state["occ"]["n_updates"]) % self.dense_every_updates == 0)

    def draw_occupancy(self, state: dict, generator: torch.Generator):
        """The random part of the occupancy update due at `state`: dense
        before step `dense_until` and every `dense_every_updates` updates,
        else G^3/4 random cells a cascade."""
        return draw_density_update(self.occ, self._dense_update(state), generator,
                                   self.device)

    def occupancy_update(self, state: dict, draws, mesh=None) -> dict:
        """Fold the density of the current (raw) params at the drawn cells
        into the occupancy grid.  With a mesh every rank has drawn its own
        cells: the densities and the bitfields are reduced by their maximum
        over the ranks and the threshold's mean density by its mean, as the
        JAX package unions its devices' samples; the update count stays."""
        params = state["params"]

        def density(unit):
            return apply_density_activation(density_raw(self.net, params, unit),
                                            self.net.density_activation)

        amin, adiag = self._aabb_tensors()
        occ = update_density_grid(self.occ, state["occ"], density, draws, amin, adiag,
                                  self.data["visible_mask"])
        if mesh is not None:
            occ = dict(occ, density=all_max(occ["density"], mesh),
                       bitfield=all_max(occ["bitfield"], mesh),
                       mean_density=all_mean(occ["mean_density"], mesh))
        return {**state, "occ": occ}

    def _phase_geometry(self):
        """(n_rays, k, march_iters) of the next bundle.  Compacted: the
        first marches 1024-sample rays; later ones set k from the measured
        samples a ray and the ray count so that the compacted samples fill
        the train_n_rays * train_k batch, both in power-of-four buckets
        (they define the batch, and in the reference each pair is a
        compile).  Two-phase: deep_k-sample rays filling the batch in the
        deep phase, then train_k samples on train_n_rays rays (or the
        adaptive count)."""
        if not self.compact_training:
            if getattr(self, "_phase", "deep") == "deep":
                return (max(64, self.train_n_rays * self.train_k // self.deep_k),
                        self.deep_k, self.deep_march_iters)
            n_rays = getattr(self, "_adaptive_n_rays", None) or self.train_n_rays
            return n_rays, self.train_k, self.train_march_iters
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

    def _update_phase(self, mean_count: float, k: int = 0) -> None:
        """Fold a bundle's mean samples a ray (of k-sample rays) in:
        compacted, a running mean; two-phase, the switch from the deep
        phase once the mean falls under phase_switch_count * k, then (with
        adapt_ray_count) a ray count that fills the batch, in power-of-two
        buckets within [train_n_rays / 4, 16 train_n_rays]."""
        if self.compact_training:
            if mean_count > 0:
                prev = getattr(self, "_mean_samples", None)
                self._mean_samples = mean_count if not prev else 0.7 * prev + 0.3 * mean_count
            return
        if getattr(self, "_phase", "deep") == "deep" \
                and mean_count < self.phase_switch_count * k:
            self._phase = "fast"
        elif self.adapt_ray_count and mean_count > 0:
            want = self.train_n_rays * self.train_k / mean_count
            bucket = 1 << int(np.clip(np.round(np.log2(max(want, 256))), 8, 20))
            self._adaptive_n_rays = int(np.clip(bucket, self.train_n_rays // 4,
                                                self.train_n_rays * 16))

    def train_bundle(self, state: dict, generator: torch.Generator,
                     stats: dict | None = None):
        """One occupancy update, then grid_interval steps -> (state, mean
        loss, mean samples a ray), the two numbers as 0-d tensors.

        `stats`, when given, receives the bundle's n_rays, k and march
        iterations, and with stats["sync_phases"] set the seconds of each
        training phase (TRAIN_PHASES), measured by synchronising the device
        after each (which slows the bundle)."""
        n_rays, k, iters = self._phase_geometry()
        return self._bundle(state, generator, n_rays, k, iters, stats)

    def train_bundle_multichip(self, state: dict, generator: torch.Generator, mesh):
        """The data-parallel bundle over a mesh's ranks (parallel/mesh.py),
        the counterpart of the JAX package's shard_map bundle: every rank
        holds the same state, draws max(64, n_rays / world) rays a step from
        its own generator (parallel/mesh.py::rank_generator: the caller's
        generator, the same seeded one on every rank, folded with the rank)
        and its own occupancy cells; the occupancy grids are merged and the
        gradients averaged in rank order (train_step, occupancy_update), so
        the state stays the same on every rank.  -> (state, mean loss, mean
        samples a ray), averaged over the ranks; the next bundle's geometry
        follows the averaged count on every rank."""
        n_rays, k, iters = self._phase_geometry()
        return self._bundle(state, rank_generator(generator, mesh),
                            max(64, n_rays // mesh.world), k, iters, None, mesh)

    def _bundle(self, state, generator, n_rays, k, iters, stats, mesh=None):
        clock = PhaseClock(stats, self.device, TRAIN_PHASES)
        state = self.occupancy_update(state, self.draw_occupancy(state, generator), mesh)
        clock.phase("occupancy")
        losses, counts = [], []
        for _ in range(self.grid_interval):
            draws = self.draw_step(generator, n_rays, int(state["step"]))
            state, loss, cnt = self.train_step(state, draws, k, iters, clock, mesh)
            losses.append(loss)
            counts.append(cnt)
        loss, cnt = torch.stack(losses).mean(), torch.stack(counts).mean()
        self._update_phase(float(cnt), k)
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

    def _mode_sample_colors(self, params, origins, dirs, ts, dts, counts, render_mode,
                            extra=None):
        """Per-sample colours of a render visualisation mode: positions,
        depth and ao replace the sample colour, glow adds an overlay."""
        rgb, dens, valid = self._eval_samples(params, origins, dirs, ts, dts, counts,
                                              extra=extra)
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
        """Modes of marched frames ("distortion", a frame of its own, is
        render_frame's alone)."""
        mode = render_mode or "shade"
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
                    min_transmittance=None, fine_bitfield=None, render_mode=None,
                    extra_row=None):
        """Fixed-size ray batch -> (rgb (N, 3), opacity (N,), depth (N,)).

        Rounds of `render_chunk` samples between field evaluations, until
        every ray is dead.  `t_cap` (optional, per ray, in units of the
        unnormalised `dirs`) bounds the march, as a hybrid pass stops rays
        at mesh surfaces.  `min_transmittance` defaults to the interactive
        early-out (render_min_transmittance).  `extra_row` selects another
        view's extra dims (default view 0's)."""
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
                params, origins, dirs_n, ts, dts, counts, render_mode, extra=extra_row)
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
                     stats: dict | None = None, extra_row=None):
        """Render a full frame with the streaming ray buffer -> rgba
        (H, W, 4) and depth (H, W) on the engine's params' device.

        `tile` is the number of ray slots; per-ray results do not depend on
        it.  `stats`, when given, receives the number of rounds, the
        samples the field evaluated, the seconds the host waited for the
        device's alive test, and (with stats["sync_phases"] set) the seconds
        of each phase.  `extra_row` selects another view's extra dims
        (default view 0's).  Render mode "distortion" marches nothing: see
        _render_distortion_frame."""
        dev = bitfield.device
        if render_mode == "distortion":
            return self._render_distortion_frame(params, width, height, camera_matrix,
                                                 focal_length, screen_center, dev)
        self._check_mode(render_mode)
        clock = PhaseClock(stats, dev, _FRAME_PHASES)
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
                                  render_mode, clock, extra_row)
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

    def _render_distortion_frame(self, params, width: int, height: int, camera_matrix,
                                 focal_length, screen_center, dev):
        """Render mode "distortion": each pixel's uv shift (x64) by the lens
        undistortion and the trainable distortion map, its distorted ray's
        t = 1 point projected back through the pinhole model, as an HSV
        colour wheel -> (rgba (H, W, 4), depth (H, W) of ones)."""
        uv = pixel_grid_uv(width, height, dev).reshape(-1, 2)
        _, d = uv_to_ray(uv, (width, height), focal_length, camera_matrix, screen_center,
                         self.lens, distortion_grid=params.get("distortion"))
        cam = torch.as_tensor(np.asarray(camera_matrix, np.float32), device=dev)
        dc = rotate(cam[:3, :3].T, d)  # world -> camera frame, R^T d
        fl = np.asarray(focal_length, np.float32)
        sc = np.asarray(screen_center, np.float32)
        z = torch.where(dc[:, 2].abs() < 1e-9, 1e-9, dc[:, 2])
        uv2 = torch.stack([dc[:, 0] / z * float(fl[0]) / width + float(sc[0]),
                           dc[:, 1] / z * float(fl[1]) / height + float(sc[1])], dim=-1)
        rgb = flow_to_rgb((uv2 - uv) * 64.0)
        rgba = torch.cat([rgb, torch.ones_like(rgb[:, :1])], dim=-1)
        depth = torch.ones((width * height,), dtype=torch.float32, device=dev)
        return rgba.reshape(height, width, 4), depth.reshape(height, width)

    def _frame_make_rays(self, ids: torch.Tensor, n: int, cam_spec, bounds=None):
        """Pixel ids -> (origin, unit dir, |dir|, t0, t1) through the
        engine's lens.  cam_spec = (width, height, focal, camera_matrix,
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

    @staticmethod
    def _sharded_ray_fanout(mesh, tile: int, o: torch.Tensor, d: torch.Tensor, ray_fn):
        """The sharded paths' scaffold: the flat ray stream padded to a
        multiple of world * tile rays (origin 0, direction +z), each rank's
        contiguous share run through ray_fn(o_tile, d_tile) -> (rgb, opacity,
        depth) a tile at a time, and every share gathered in rank order ->
        flat (rgb, opacity, depth) of the input's length on every rank."""
        n = o.shape[0]
        chunk = mesh.world * tile
        pad = -(-n // chunk) * chunk - n
        o = torch.cat([o, o.new_zeros((pad, 3))])
        d = torch.cat([d, d.new_tensor([0.0, 0.0, 1.0]).expand(pad, 3)])
        lo, hi = shard_range(n + pad, mesh.world, mesh.rank)
        outs = []
        for t0 in range(lo, hi, tile):
            rgb, opacity, depth = ray_fn(o[t0:t0 + tile], d[t0:t0 + tile])
            outs.append(torch.cat([rgb, opacity[:, None], depth[:, None]], dim=-1))
        out = torch.cat(all_gather(torch.cat(outs), mesh))[:n]
        return out[:, :3], out[:, 3], out[:, 4]

    @staticmethod
    def _background_fill(rgb, opacity, dirs, params, background):
        """The unfilled transmittance over the trained envmap (read along
        `dirs`, the rays as the JAX package's sharded frames pass them:
        unnormalised) or the constant background."""
        bg = torch.as_tensor(np.asarray(background, np.float32), device=rgb.device)
        if "envmap" in params:
            bg = background_behind_envmap(params["envmap"], dirs, bg)
        return rgb + (1.0 - opacity)[:, None] * bg

    @torch.no_grad()
    def render_views_multichip(self, params, bitfield, width: int, height: int,
                               camera_matrices, focal_lengths, mesh, tile: int = 1 << 13,
                               background=(0.0, 0.0, 0.0), screen_center=(0.5, 0.5)):
        """V views in one sharded stream: every view's rays concatenated and
        split over the ranks, so the ranks stay balanced however the views
        differ in cost and V need not divide the world -> rgba (V, H, W, 4)
        and depth (V, H, W) on every rank.  params and bitfield are the
        same on every rank."""
        params = self._render_params(params)
        uv = pixel_grid_uv(width, height, bitfield.device).reshape(-1, 2)
        fls = np.asarray(focal_lengths, np.float32)
        rays = [uv_to_ray(uv, (width, height), tuple(fl), cam, screen_center, self.lens)
                for cam, fl in zip(np.asarray(camera_matrices, np.float32), fls)]
        o = torch.cat([r[0] for r in rays])
        d = torch.cat([r[1] for r in rays])
        rgb, opacity, depth = self._sharded_ray_fanout(
            mesh, tile, o, d, lambda oo, dd: self.render_rays(params, bitfield, oo, dd))
        rgb = self._background_fill(rgb, opacity, d, params, background)
        rgba = torch.cat([rgb, opacity[:, None]], dim=-1)
        V = len(rays)
        return rgba.reshape(V, height, width, 4), depth.reshape(V, height, width)

    @torch.no_grad()
    def render_frame_multichip(self, params, bitfield, width: int, height: int,
                               camera_matrix, focal_length, mesh, tile: int = 1 << 13,
                               background=(0.0, 0.0, 0.0), screen_center=(0.5, 0.5)):
        """A frame with its rays sharded over the mesh's ranks (render_rays
        over each rank's tiles; params and bitfield the same on every rank)
        -> rgba (H, W, 4) and depth (H, W) on every rank."""
        params = self._render_params(params)
        uv = pixel_grid_uv(width, height, bitfield.device).reshape(-1, 2)
        o, d = uv_to_ray(uv, (width, height), focal_length, camera_matrix, screen_center,
                         self.lens)
        rgb, opacity, depth = self._sharded_ray_fanout(
            mesh, tile, o, d, lambda oo, dd: self.render_rays(params, bitfield, oo, dd))
        rgb = self._background_fill(rgb, opacity, d, params, background)
        rgba = torch.cat([rgb, opacity[:, None]], dim=-1)
        return rgba.reshape(height, width, 4), depth.reshape(height, width)

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
                     clock: PhaseClock, extra_row=None):
        """One round of the streaming renderer: march a chunk, evaluate and
        composite it, flush finished rays to the frame, refill their
        slots."""
        ts, dts, counts, t_end = march_rays(
            self.march, words, s["o"], s["d"], s["t"], s["t1"], self.render_chunk,
            self._march_iters(), fine=fine_bitfield)
        clock.phase("march")
        rgb, dens, valid_s = self._mode_sample_colors(
            params, s["o"], s["d"], ts, dts, counts, render_mode, extra=extra_row)
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


def _rank_mean(loss: torch.Tensor, grads, cnt: torch.Tensor, mesh):
    """(loss, gradient tree, mean samples a ray) averaged over the mesh's
    ranks in rank order, in one collective of their concatenation."""
    leaves = tree_leaves(grads)
    flat = torch.cat([g.reshape(-1).float() for g in leaves]
                     + [loss.reshape(1).float(), cnt.reshape(1).float()])
    flat = all_mean(flat, mesh)
    out, at = [], 0
    for g in leaves:
        out.append(flat[at:at + g.numel()].reshape(g.shape).to(g.dtype))
        at += g.numel()
    return flat[at].to(loss.dtype), tree_unflatten(grads, out), flat[at + 1]


def _batched_uv_to_ray(uv: torch.Tensor, resolution, focal: torch.Tensor,
                       principal: torch.Tensor, xform: torch.Tensor, lens: Lens,
                       distortion_grid: torch.Tensor | None = None):
    """Rays of cameras given per ray: uv (N, 2), focal (N, 2), principal
    point (N, 2), xform (N, 3, 4) -> (origins, dirs), through the OpenCV
    and fisheye undistortion of `lens` (the training rays' lenses, as in
    the reference) and the distortion map's bilinear offset.  The rotation
    is applied as explicit f32 products and sums, never a matmul that could
    run in TF32 (the reference's einsum is Precision.HIGHEST)."""
    w, h = resolution
    x = (uv[:, 0] - principal[:, 0]) * w / focal[:, 0]
    y = (uv[:, 1] - principal[:, 1]) * h / focal[:, 1]
    x, y = undistort(lens, x, y)
    if distortion_grid is not None:
        from sienerf_torch.ops.grids import bilinear_sample_2d

        delta = bilinear_sample_2d(distortion_grid, uv)
        x = x + delta[:, 0]
        y = y + delta[:, 1]
    rot = xform[:, :3, :3]
    dirs = rot[:, :, 0] * x[:, None] + rot[:, :, 1] * y[:, None] + rot[:, :, 2]
    return xform[:, :3, 3], dirs


def _apply_se3_delta(xform: torch.Tensor, delta: torch.Tensor) -> torch.Tensor:
    """Small se(3) deltas (N, 6) = (w, v) applied to (N, 3, 4) cameras by
    the first-order exponential map: R' = (I + [w]x) R, t' = t + v, the
    product written as explicit f32 products and sums."""
    w, v = delta[:, :3], delta[:, 3:]
    zeros = torch.zeros_like(w[:, 0])
    skew = torch.stack([torch.stack([zeros, -w[:, 2], w[:, 1]], dim=-1),
                        torch.stack([w[:, 2], zeros, -w[:, 0]], dim=-1),
                        torch.stack([-w[:, 1], w[:, 0], zeros], dim=-1)], dim=1)
    R = xform[:, :3, :3]
    sR = skew[:, :, 0, None] * R[:, 0, None, :] + skew[:, :, 1, None] * R[:, 1, None, :] \
        + skew[:, :, 2, None] * R[:, 2, None, :]
    return torch.cat([R + sR, (xform[:, :3, 3] + v)[:, :, None]], dim=-1)
