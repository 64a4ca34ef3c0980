"""SDF mode: a neural signed-distance field fitted to a mesh, and its
sphere-traced frames (port of the JAX package's engines/sdf.py).

Training: each batch is the reference's 8-way split, 4/8 on the surface
(area-weighted triangles, uniform barycentrics), 3/8 on the surface plus
a normal offset (std 0.02) and 1/8 uniform in the unit cube; the targets
are the mesh's signed distances.  By default a bundle's batches are drawn
in numpy and their targets computed by the native host query
(geom/bvh_native.py::sdf_query, on the host's threads), then the steps run
on the device (MAPE, Ema(ExponentialDecay(Adam)), updated in place).
A Takikawa network's octree is built from the mesh in `create` (host numpy,
geom/octree.py) and its tables ride along every evaluation.  With
host_gt=False the batches are drawn on the device and the targets walk the
BVH there (geom/sdf_gt.py).  A failed native build or call raises.  A
bundle's draw and its steps are separate (`draw_bundle`, `train_step`), so
the tests hold the steps to the reference on the reference's batches.

Frames: `sphere_trace` steps every ray by the network's distance until it
converges (|d| < stop_threshold * max(t, 1)), leaves its interval or has
taken trace_steps steps.  The reference's loop is a `while_loop` over all
rays; here it is a host loop over the rays still alive, compacted every
_TRACE_CHECK steps (a ray's state changes only while it is alive, so the
result is the reference's).  The trace reads the bf16 render table;
normals are the gradient of the f32 field (autograd through the hash
grid's d_pos) or 6-tap central differences of an f32 MLP; shadows are a
second trace toward the sun with the soft-shadow estimate; then the BRDF
with sky ambient.  ground_truth=True traces the mesh itself (the BVH)."""

from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass

import numpy as np
import torch

from sienerf_torch.common import MeshSdfMode
from sienerf_torch.geom import bvh_native
from sienerf_torch.geom.bvh import TriangleBVH, build_bvh, bvh_raytrace
from sienerf_torch.geom.mesh_io import triangle_areas, triangle_normals
from sienerf_torch.geom.octree import build_triangle_octree, octree_device_tables
from sienerf_torch.geom.sdf_gt import signed_distance
from sienerf_torch.models.single_network import (
    SingleNetworkConfig,
    apply_single_network,
    encode_input,
    init_single_network,
    l2_mask,
    pack_render_params,
)
from sienerf_torch.ops.brdf import SUN_COLOR, BRDFParams, evaluate_shading, sky_ambient
from sienerf_torch.ops.losses import get_loss
from sienerf_torch.ops.mlp import mlp_apply
from sienerf_torch.ops.optim import (
    OptimizerSpec,
    inference_params,
    optim_init,
    optim_step,
    tree_leaves,
    tree_map,
    tree_unflatten,
)
from sienerf_torch.tracing import PhaseClock
from sienerf_torch.utils.bbox import BoundingBox
from sienerf_torch.utils.camera import uv_to_ray

SDF_TRAIN_PHASES = ("sample", "ground_truth", "field", "optimizer")
SDF_FRAME_PHASES = ("setup", "trace", "field", "normals", "shade")
RENDER_MODES = ("shade", "normals", "ao", "positions", "depth")
_TRACE_CHECK = 16  # sphere-trace steps between compactions of the live rays
_NORMAL_CHUNK = 1 << 18  # points a normals pass


@dataclass(eq=False)
class SdfEngine:
    net: SingleNetworkConfig
    opt: OptimizerSpec
    loss_otype: str
    aabb: BoundingBox
    bvh_host: TriangleBVH  # host arrays: the native query and the samplers
    bvh_dev: dict  # the same BVH on the device
    tri_normals: torch.Tensor  # (T, 3) of the BVH's reordered triangles
    tri_cdf: torch.Tensor  # (T,) area CDF on the device
    cdf_host: np.ndarray  # the same on the host
    device: torch.device
    sdf_mode: MeshSdfMode = MeshSdfMode.WATERTIGHT
    host_gt: bool = True
    batch_size: int = 1 << 16
    surface_offset_std: float = 0.02
    trace_steps: int = 128
    stop_threshold: float = 1e-4
    shadow_k: float = 8.0
    normals_mode: str = "analytic"  # "analytic" (autograd) | "fd" (6 taps)
    tak_tables: dict | None = None  # the Takikawa encoding's octree tables
    octree_stats: dict | None = None  # its build: seconds, depth, nodes, vertices

    @staticmethod
    def create(network_config: dict, triangles: np.ndarray, batch_size: int = 1 << 16,
               device: str | torch.device = "cuda", host_gt: bool = True) -> "SdfEngine":
        dev = torch.device(device)
        net = SingleNetworkConfig.from_network_config(network_config, n_input_dims=3,
                                                      n_output_dims=1)
        bvh = build_bvh(triangles)
        tak_tables = octree_stats = None
        if net.takikawa is not None:
            # the octree at the configured depth, then the network config
            # again from the depth it reached (the build stops early where
            # no child cell touches a triangle), as the reference re-reads
            # the depth after its build (testbed.cu:4148-4156)
            t0 = time.perf_counter()
            tree = build_triangle_octree(bvh.triangles, net.takikawa.depth)
            if tree.depth <= net.takikawa.starting_level:
                raise ValueError(f"octree depth {tree.depth} <= starting_level "
                                 f"{net.takikawa.starting_level}")
            cfg2 = dict(network_config)
            cfg2["encoding"] = {**cfg2.get("encoding", {}), "n_levels": tree.depth}
            net = dataclasses.replace(
                SingleNetworkConfig.from_network_config(cfg2, n_input_dims=3, n_output_dims=1),
                takikawa_n_vertices=tree.n_vertices)
            tak_tables = octree_device_tables(tree, dev)
            octree_stats = {"build_s": time.perf_counter() - t0, "depth": tree.depth,
                            "nodes": tree.n_nodes, "vertices": tree.n_vertices}
        cdf = np.cumsum(triangle_areas(bvh.triangles))
        cdf = (cdf / cdf[-1]).astype(np.float32)
        return SdfEngine(
            net=net, opt=OptimizerSpec.from_network_config(network_config.get("optimizer", {})),
            loss_otype=network_config.get("loss", {}).get("otype", "MAPE"),
            aabb=BoundingBox.unit(), bvh_host=bvh, bvh_dev=bvh.as_device_arrays(dev),
            tri_normals=torch.from_numpy(triangle_normals(bvh.triangles)).to(dev),
            tri_cdf=torch.from_numpy(cdf).to(dev), cdf_host=cdf, device=dev,
            host_gt=host_gt, batch_size=batch_size, tak_tables=tak_tables,
            octree_stats=octree_stats)

    def init(self, seed: int = 1337) -> dict:
        g = torch.Generator(device=self.device).manual_seed(seed)
        params = init_single_network(self.net, g, self.device)
        return {"params": params, "opt": optim_init(params, self.opt)}

    # --- batches ------------------------------------------------------------

    def _split(self):
        n = self.batch_size
        n_surf, n_pert = n // 2, (3 * n) // 8
        return n_surf, n_pert, n - n_surf - n_pert

    def sample_batch_host(self, rng: np.random.Generator) -> np.ndarray:
        """One batch (B, 3) drawn in numpy, the reference's host sampler
        draw for draw."""
        n_surf, n_pert, n_unif = self._split()
        tris = self.bvh_host.triangles
        u = rng.random(n_surf + n_pert).astype(np.float32)
        tri_idx = np.clip(np.searchsorted(self.cdf_host, u), 0, len(tris) - 1)
        bc = rng.random((n_surf + n_pert, 2)).astype(np.float32)
        r1 = np.sqrt(bc[:, 0:1])
        a = 1.0 - r1
        b = bc[:, 1:2] * r1
        t = tris[tri_idx]
        surf = t[:, 0] + a * (t[:, 1] - t[:, 0]) + b * (t[:, 2] - t[:, 0])
        pert = surf[n_surf:] + rng.normal(size=(n_pert, 3)).astype(np.float32) \
            * self.surface_offset_std
        unif = rng.random((n_unif, 3)).astype(np.float32)
        return np.clip(np.concatenate([surf[:n_surf], pert, unif], axis=0), 0.0, 1.0)

    def sample_batch(self, generator: torch.Generator) -> torch.Tensor:
        """One batch (B, 3) drawn on the device (the host_gt=False path)."""
        n_surf, n_pert, n_unif = self._split()
        dev, n_s = self.device, n_surf + n_pert
        tri = self.bvh_dev
        u = torch.rand((n_s,), generator=generator, device=dev)
        tri_idx = torch.clamp(torch.searchsorted(self.tri_cdf, u), 0, self.tri_cdf.shape[0] - 1)
        bc = torch.rand((n_s, 2), generator=generator, device=dev)
        r1 = torch.sqrt(bc[:, 0:1])
        surf = (tri["tri_a"][tri_idx] + (1.0 - r1) * tri["tri_ab"][tri_idx]
                + (bc[:, 1:2] * r1) * tri["tri_ac"][tri_idx])
        pert = surf[n_surf:] + torch.randn((n_pert, 3), generator=generator, device=dev) \
            * self.surface_offset_std
        unif = torch.rand((n_unif, 3), generator=generator, device=dev)
        return torch.clamp(torch.cat([surf[:n_surf], pert, unif]), 0.0, 1.0)

    def ground_truth(self, pos: torch.Tensor) -> torch.Tensor:
        """Signed distances of pos (N, 3): the native host query when
        host_gt, else the device walk."""
        if self.host_gt:
            mode = 1 if self.sdf_mode != MeshSdfMode.WATERTIGHT else 0
            return torch.from_numpy(bvh_native.sdf_query(
                self.bvh_host, pos.detach().cpu().numpy(), mode=mode)).to(pos.device)
        return signed_distance(self.bvh_dev, pos, self.sdf_mode)

    def draw_bundle(self, generator: torch.Generator, n_steps: int = 16, clock=None):
        """A bundle's batches and targets -> (pos (n, B, 3), target (n, B))
        on the device.  On the host path a numpy generator seeded from
        `generator` draws every batch first, then the native query gives
        their targets."""
        clock = clock or PhaseClock(None, self.device)
        if not self.host_gt:
            pos = torch.stack([self.sample_batch(generator) for _ in range(n_steps)])
            clock.phase("sample")
            tgt = torch.stack([self.ground_truth(p) for p in pos])
            clock.phase("ground_truth")
            return pos, tgt
        seed = int(torch.randint(0, 1 << 62, (1,), generator=generator,
                                 device=generator.device))
        rng = np.random.default_rng(seed)
        pos = np.stack([self.sample_batch_host(rng) for _ in range(n_steps)])
        clock.phase("sample")
        mode = 1 if self.sdf_mode != MeshSdfMode.WATERTIGHT else 0
        tgt = np.stack([bvh_native.sdf_query(self.bvh_host, p, mode=mode) for p in pos])
        clock.phase("ground_truth")
        return (torch.from_numpy(pos).to(self.device), torch.from_numpy(tgt).to(self.device))

    # --- training -----------------------------------------------------------

    def loss_and_grads(self, params: dict, pos: torch.Tensor, target: torch.Tensor):
        with torch.enable_grad():
            p_req = tree_map(lambda t: t.detach().requires_grad_(True), params)
            pred = apply_single_network(self.net, p_req, pos, tables=self.tak_tables)[:, 0]
            loss = get_loss(self.loss_otype)(pred, target).mean()
            grads = torch.autograd.grad(loss, tree_leaves(p_req))
        return loss.detach(), tree_unflatten(params, list(grads))

    def train_step(self, state: dict, pos: torch.Tensor, target: torch.Tensor, clock=None):
        """One step on a batch -> (state, loss); the state is updated in
        place."""
        clock = clock or PhaseClock(None, self.device)
        loss, grads = self.loss_and_grads(state["params"], pos, target)
        clock.phase("field")
        params, opt = optim_step(self.opt, state["opt"], state["params"], grads,
                                 l2_mask(self.net, state["params"]), inplace=True)
        clock.phase("optimizer")
        return {"params": params, "opt": opt}, loss

    def train_bundle(self, state: dict, generator: torch.Generator, n_steps: int = 16,
                     stats: dict | None = None):
        """Draw a bundle and take its n_steps steps -> (state, mean loss as
        a 0-d tensor).  With stats["sync_phases"], stats["phase_s"]
        receives the seconds of sample / ground_truth / field / optimizer."""
        clock = PhaseClock(stats, self.device, SDF_TRAIN_PHASES)
        pos, tgt = self.draw_bundle(generator, n_steps, clock)
        losses = []
        for i in range(n_steps):
            state, loss = self.train_step(state, pos[i], tgt[i], clock)
            losses.append(loss)
        return state, torch.stack(losses).mean()

    # --- sphere tracing -------------------------------------------------------

    def sdf_fn(self, params: dict):
        """The field's distance at points (N, 3) -> (N,), forward only, from
        the bf16 render table."""
        packed = pack_render_params(self.net, params)
        return lambda pos: apply_single_network(self.net, packed, pos,
                                                tables=self.tak_tables)[:, 0]

    @torch.no_grad()
    def sphere_trace(self, sdf_fn, origins, dirs, t_init, t_far, track_shadow: bool = False,
                     clock=None):
        """-> (pos (N, 3), t (N,), hit (N,), steps a ray (N,), soft-shadow
        visibility (N,) in [0, 1]).  clock.stats["trace_iters"] counts the
        loop's iterations."""
        clock = clock or PhaseClock(None, self.device)
        N, dev = origins.shape[0], origins.device
        t = t_init.float().clone()
        alive = torch.ones(N, dtype=torch.bool, device=dev)
        n_steps = torch.zeros(N, dtype=torch.int64, device=dev)
        prev_d = torch.full((N,), 1e20, device=dev)
        total_d = torch.zeros(N, device=dev)
        min_vis = torch.ones(N, device=dev)
        it = 0
        while it < self.trace_steps:
            idx = torch.nonzero(alive)[:, 0]
            if idx.numel() == 0:
                break
            o, dd, tf, tt = origins[idx], dirs[idx], t_far[idx], t[idx]
            a = torch.ones(idx.shape, dtype=torch.bool, device=dev)
            ns = torch.zeros(idx.shape, dtype=torch.int64, device=dev)
            pd, td, mv = prev_d[idx], total_d[idx], min_vis[idx]
            for _ in range(min(_TRACE_CHECK, self.trace_steps - it)):
                pos = o + tt[:, None] * dd
                clock.phase("trace")
                d = sdf_fn(pos)
                clock.phase("field")
                if track_shadow:
                    y = d * d / (2.0 * torch.clamp(pd, min=1e-20))
                    dist = torch.sqrt(torch.clamp(d * d - y * y, min=0.0))
                    vis = self.shadow_k * dist / torch.clamp(td - y, min=1e-20)
                    mv = torch.where(a & (td > 0), torch.minimum(mv, vis), mv)
                    pd = torch.where(a, d, pd)
                    td = torch.where(a, td + d, td)
                t_new = tt + d
                converged = d.abs() < self.stop_threshold * torch.clamp(tt, min=1.0)
                tt = torch.where(a, torch.minimum(t_new, tf), tt)
                ns = ns + a.to(torch.int64)
                a = a & ~converged & ~(t_new > tf)
                it += 1
            t[idx], alive[idx], n_steps[idx] = tt, a, n_steps[idx] + ns
            prev_d[idx], total_d[idx], min_vis[idx] = pd, td, mv
        if clock.stats is not None:
            clock.stats["trace_iters"] = clock.stats.get("trace_iters", 0) + it
        pos = origins + t[:, None] * dirs
        hit = t < t_far - 1e-6
        return pos, t, hit, n_steps, torch.clamp(min_vis, 0.0, 1.0)

    def normals(self, params: dict, pos: torch.Tensor) -> torch.Tensor:
        """Unit normals at pos (N, 3): the gradient of the f32 field
        (analytic), or 6-tap central differences ("fd")."""
        if self.normals_mode == "fd":
            return self._normals_fd(params, pos)
        out = []
        for s in range(0, pos.shape[0], _NORMAL_CHUNK):
            with torch.enable_grad():
                p = pos[s:s + _NORMAL_CHUNK].detach().requires_grad_(True)
                val = apply_single_network(self.net, params, p, tables=self.tak_tables)[:, 0]
                (g,) = torch.autograd.grad(val.sum(), p)
            out.append(g)
        g = torch.cat(out) if out else pos.new_zeros((0, 3))
        return g / torch.clamp(torch.linalg.norm(g, dim=-1, keepdim=True), min=1e-12)

    @torch.no_grad()
    def _normals_fd(self, params: dict, pos: torch.Tensor, eps: float = 1e-3) -> torch.Tensor:
        """Central differences of the field at +-eps along each axis, the
        MLP in f32: bf16 inputs would round positions to ~2e-3 and fold
        the taps into rounding noise."""
        eye = torch.eye(3, device=pos.device)
        offs = torch.cat([eye * eps, -eye * eps])
        out = []
        for s in range(0, pos.shape[0], _NORMAL_CHUNK):
            taps = (pos[s:s + _NORMAL_CHUNK, None, :] + offs[None]).reshape(-1, 3)
            feats = encode_input(self.net, params, taps, self.tak_tables)
            d = mlp_apply(self.net.mlp, params["mlp"], feats, compute_dtype=torch.float32)
            d = d[:, 0].reshape(-1, 6)
            out.append((d[:, :3] - d[:, 3:]) / (2.0 * eps))
        g = torch.cat(out) if out else pos.new_zeros((0, 3))
        return g / torch.clamp(torch.linalg.norm(g, dim=-1, keepdim=True), min=1e-12)

    @torch.no_grad()
    def render_frame(self, params: dict, width: int, height: int, camera_matrix,
                     ground_truth: bool = False, render_mode: str = "shade",
                     focal_scale: float = 1.1, sun_dir=(0.577, 0.577, 0.577),
                     brdf: BRDFParams = BRDFParams(), background=(1.0, 1.0, 1.0),
                     stats: dict | None = None):
        """Sphere-trace (or, ground_truth, ray-trace the mesh) a frame ->
        (colour (H, W, 3), depth (H, W), inf where nothing is hit).  Modes:
        shade, normals, ao, positions, depth, and slice[:z] (the field on
        the camera-facing plane at z-depth z: inside red, outside green).
        With stats["sync_phases"], stats["phase_s"] receives the seconds of
        setup / trace / field / normals / shade; stats["trace_iters"] counts
        the sphere tracer's iterations (primary and shadow)."""
        clock = PhaseClock(stats, self.device, SDF_FRAME_PHASES)
        dev = self.device
        fl = (width * focal_scale, width * focal_scale)
        x = (torch.arange(width, dtype=torch.float32, device=dev) + 0.5) / width
        y = (torch.arange(height, dtype=torch.float32, device=dev) + 0.5) / height
        v, u = torch.meshgrid(y, x, indexing="ij")
        uv = torch.stack([u.reshape(-1), v.reshape(-1)], dim=-1)
        o, d = uv_to_ray(uv, (width, height), fl, camera_matrix)
        d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
        tmin, tmax = self.aabb.ray_intersect(o, d)
        t0 = torch.clamp(tmin, min=0.0)
        t1 = torch.maximum(tmax, t0)
        bg = torch.tensor(background, dtype=torch.float32, device=dev)

        if render_mode.startswith("slice"):
            parts = render_mode.split(":")
            cam = torch.as_tensor(np.asarray(camera_matrix, np.float32), device=dev)
            fwd, cam_pos = cam[:, 2], cam[:, 3]
            if len(parts) > 1:
                zdepth = torch.tensor(float(parts[1]), device=dev)
            else:
                zdepth = (fwd * (torch.as_tensor(0.5 * (self.aabb.min + self.aabb.max),
                                                 device=dev) - cam_pos)).sum()
            tp = zdepth / torch.clamp((d * fwd).sum(dim=-1), min=1e-6)
            pos = o + tp[:, None] * d
            val = self.sdf_fn(params)(pos)
            color = torch.stack([torch.clamp(-val, min=0.0), torch.clamp(val, min=0.0),
                                 torch.zeros_like(val)], dim=-1)
            lo = torch.as_tensor(self.aabb.min, device=dev)
            hi = torch.as_tensor(self.aabb.max, device=dev)
            inb = ((pos >= lo) & (pos <= hi)).all(dim=-1)
            color = torch.where(inb[:, None], color, bg)
            depth = torch.where(inb, tp, float("inf"))
            return color.reshape(height, width, 3), depth.reshape(height, width)
        if render_mode not in RENDER_MODES:
            raise ValueError(f"unknown SDF render mode {render_mode!r}")

        sun = torch.tensor(sun_dir, dtype=torch.float32, device=dev)
        sun = sun / torch.linalg.norm(sun)
        clock.phase("setup")
        if ground_truth:
            t, tid, _, _ = bvh_raytrace(self.bvh_dev, o + t0[:, None] * d, d, t1 - t0)
            hit = tid >= 0
            t = torch.where(hit, t, t1 - t0) + t0
            pos = o + t[:, None] * d
            nrm = self.tri_normals[torch.clamp(tid, min=0)]
            nrm = nrm * torch.where((nrm * d).sum(dim=-1, keepdim=True) > 0, -1.0, 1.0)
            n_steps = torch.zeros_like(tid)
            spos = pos + nrm * 1e-3
            stid = bvh_raytrace(self.bvh_dev, spos, sun.expand(spos.shape))[1]
            shadow = torch.where(stid >= 0, 0.0, 1.0)
            clock.phase("trace")
        else:
            sdf = self.sdf_fn(params)
            pos, t, hit, n_steps, _ = self.sphere_trace(sdf, o, d, t0, t1, clock=clock)
            nrm = self.normals(params, pos)
            clock.phase("normals")
            spos = pos + nrm * 1e-3
            n = spos.shape[0]
            _, _, shadow_hit, _, min_vis = self.sphere_trace(
                sdf, spos, sun.expand(spos.shape), torch.full((n,), 1e-3, device=dev),
                torch.full((n,), 2.0, device=dev), track_shadow=True, clock=clock)
            shadow = torch.where(shadow_hit, 0.0, min_vis)

        view = -d
        up = torch.tensor([0.0, 1.0, 0.0], device=dev)
        base = torch.tensor(brdf.basecolor, dtype=torch.float32, device=dev) ** 2
        amb = torch.tensor(brdf.ambientcolor, dtype=torch.float32, device=dev) \
            * sky_ambient(nrm, up)
        suncol = torch.tensor(SUN_COLOR, device=dev) * shadow[:, None]
        if render_mode == "shade":
            color = evaluate_shading(
                base.expand(pos.shape), amb, suncol, sun.expand(pos.shape), view, nrm,
                metallic=brdf.metallic, subsurface=brdf.subsurface, specular=brdf.specular,
                roughness=brdf.roughness, sheen=brdf.sheen, clearcoat=brdf.clearcoat,
                clearcoat_gloss=brdf.clearcoat_gloss)
        elif render_mode == "normals":
            color = 0.5 * nrm + 0.5
        elif render_mode == "ao":
            color = (0.92 ** n_steps.float())[:, None].expand(pos.shape)
        elif render_mode == "positions":
            color = (pos - 0.5) / 2.0 + 0.5
        else:
            color = t[:, None].expand(pos.shape)
        color = torch.where(hit[:, None], color, bg)
        depth = torch.where(hit, t, float("inf"))
        clock.phase("shade")
        return color.reshape(height, width, 3), depth.reshape(height, width)

    # --- metrics --------------------------------------------------------------

    @torch.no_grad()
    def calculate_iou(self, state: dict, resolution: int = 64, n_chunks: int = 8,
                      seed: int = 0, draw=None) -> float:
        """Sign agreement of the field with the mesh on jittered grid
        points: |inside both| / |inside either|.  The jitter of chunk ci is
        draw(ci, (n, 3)), by default uniforms from a generator seeded with
        `seed`."""
        params = inference_params(state["opt"], state["params"])
        dev = self.device
        if draw is None:
            g = torch.Generator(device=dev).manual_seed(seed)

            def draw(_ci, shape):
                return torch.rand(shape, generator=g, device=dev)
        n = resolution ** 3
        idx = torch.arange(n, device=dev)
        cells = torch.stack([idx % resolution, (idx // resolution) % resolution,
                             idx // resolution ** 2], dim=-1).float()
        chunk = n // n_chunks
        inter = union = 0
        for ci in range(n_chunks):
            c = cells[ci * chunk:(ci + 1) * chunk]
            pos = (c + draw(ci, tuple(c.shape)).to(dev)) / resolution
            gt = self.ground_truth(pos) < 0
            pred = apply_single_network(self.net, params, pos, tables=self.tak_tables)[:, 0] < 0
            inter += int((gt & pred).sum())
            union += int((gt | pred).sum())
        return inter / max(union, 1)
