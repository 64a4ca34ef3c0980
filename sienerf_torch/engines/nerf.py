"""NeRF engine, the render side (port of the render parts of the JAX
package's engines/nerf.py::NerfEngine): the streaming ray-marched live
renderer (render_frame), fixed ray batches (render_rays), and the bake entry
of the sweep path (bake_features).

The live renderer keeps a fixed buffer of `tile` ray slots.  Each round
marches `render_chunk` samples for every slot through the occupancy grid,
evaluates the field there, composites, writes finished rays to the frame
and refills their slots with the next pixels, so the slots stay full
however much ray lengths differ.  The JAX package runs the rounds in an
on-device while loop; here the loop is a Python `while` that asks the
device once per round whether any ray is alive, and every step inside is
plain PyTorch.

Not ported yet: render modes `normals` (needs the hash grid's position
gradient) and `distortion`, the envmap background, extra-dim conditioning,
the fine render grid's bake (`bake_render_grid`), and training.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch

from sienerf_torch.common import NERF_RENDERING_NEAR_DISTANCE
from sienerf_torch.io.nerf_dataset import NerfDataset
from sienerf_torch.models.nerf_network import (
    NerfNetworkConfig,
    apply_density_activation,
    apply_rgb_activation,
    nerf_apply,
)
from sienerf_torch.ops.hashgrid import pack_table_bf16, pack_table_fp8
from sienerf_torch.ops.occupancy import (
    n_cascades_for_aabb_scale,
    occupied_bbox,
    pack_occupancy,
    ray_box_times,
)
from sienerf_torch.ops.raymarch import (
    MarchConfig,
    advance_to_occupied,
    composite_chunk,
    cone_angle_for_aabb,
    march_rays,
)
from sienerf_torch.utils.bbox import BoundingBox
from sienerf_torch.utils.camera import Lens, uv_to_ray

RENDER_MODES = ("shade", "cost", "positions", "depth", "ao", "encoding_vis")
_FRAME_PHASES = ("setup", "advance", "march", "eval", "composite", "flush")


def _norm(x: torch.Tensor) -> torch.Tensor:
    return torch.sqrt((x * x).sum(dim=-1, keepdim=True))


class _PhaseClock:
    """Frame statistics for a caller's `stats` dict: rounds and the host's
    wait for the device's per-round answer always; with
    stats["sync_phases"] set, also the seconds of each phase, measured by
    synchronising the device after it (which slows the frame, so a timed
    frame leaves it unset)."""

    def __init__(self, stats: dict | None, device: torch.device):
        self.stats = stats
        self.sync = bool(stats and stats.get("sync_phases")) and device.type == "cuda"
        if stats is not None:
            stats.update(rounds=0, host_wait_s=0.0)
            if stats.get("sync_phases"):
                stats["phase_s"] = dict.fromkeys(_FRAME_PHASES, 0.0)
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
    # the training march budget, which bounds the render budget too: the
    # field is only trained to explain pixels within that march
    train_k: int = 64
    compact_training: bool = True
    max_samples_per_ray: int = 1024
    # the training near plane: closer than this the field is untrained
    near_distance: float = 0.1
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
    xforms: np.ndarray | None = None
    focals: np.ndarray | None = None
    principal_points: np.ndarray | None = None
    resolution: tuple = (0, 0)
    lens: Lens = field(default_factory=Lens)
    device: torch.device = field(default_factory=lambda: torch.device("cuda"))

    @staticmethod
    def create(network_config: dict, dataset: NerfDataset, grid_size: int = 128,
               train_k: int = 64, device: str | torch.device = "cuda") -> "NerfEngine":
        aabb_scale = dataset.aabb_scale
        net = NerfNetworkConfig.from_network_config(
            network_config, aabb_scale=aabb_scale,
            n_extra_dims=dataset.n_extra_learnable_dims, hdr=dataset.is_hdr)
        march = MarchConfig(n_cascades=n_cascades_for_aabb_scale(aabb_scale),
                            cone_angle=cone_angle_for_aabb(aabb_scale),
                            grid_size=grid_size)
        return NerfEngine(
            net=net,
            aabb=BoundingBox.from_scale(aabb_scale),
            march=march,
            train_k=train_k,
            xforms=np.asarray(dataset.xforms),
            focals=np.asarray(dataset.focal_lengths),
            principal_points=np.asarray(dataset.principal_points),
            resolution=dataset.resolution,
            lens=dataset.lens,
            device=torch.device(device),
        )

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
    def _check_mode(render_mode) -> None:
        mode = render_mode or "shade"
        if mode in ("normals", "distortion"):
            raise NotImplementedError(f"render mode {mode!r} is not ported yet")
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
        seconds the host waited for the device's alive test, and (with
        stats["sync_phases"] set) the seconds of each phase."""
        self._check_mode(render_mode)
        if "envmap" in params:
            raise NotImplementedError("envmap backgrounds are not ported yet")
        dev = bitfield.device
        clock = _PhaseClock(stats, dev)
        n = width * height
        A = min(tile, max(256, n))
        off = (0.5, 0.5) if pixel_offset is None else pixel_offset
        cam_spec = (width, height, focal_length, camera_matrix, screen_center, off)
        params = self._render_params(params)
        bounds = occupied_bbox(bitfield)
        # pack once; the per-round march probes the words
        words = pack_occupancy(bitfield)

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
        out = s["out"][:n]
        rgb = out[:, :3]
        opacity = out[:, 3]
        depth = out[:, 4]
        if render_mode == "cost":
            opacity = torch.ones_like(opacity)
        bg = torch.as_tensor(np.asarray(background, np.float32), device=dev)
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

    def bake_render_grid(self, params, occ_state, factor: int = 4):
        raise NotImplementedError("the fine render grid's bake is not ported yet")

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
        )
        clock.phase("composite")
        s2 = self._frame_flush_refill(s, s2, n, rays_pre, render_mode)
        clock.phase("flush")
        return s2

    def _frame_flush_refill(self, s, s2, n, rays_pre, render_mode=None):
        """Tail of a round: write finished rays to the frame's output rows,
        then refill their slots from the pixel stream.  The output table is
        updated in place.  Ray ids are unique and every slot with nothing
        to flush writes row n, which is sliced off, so the scatter needs no
        ordering."""
        now_alive = self._frame_alive(s2)
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
