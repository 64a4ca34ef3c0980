"""Geometry mode: meshes inside a NeRF scene (port of the JAX package's
engines/geometry.py), the fork's own capability.

A scene is a JSON scene graph {"geometry": [{"type": "Mesh" | "Nerf",
"path", "center", "scale"}]}.  Meshes are normalised into the unit cube,
scaled and moved to their centre, and merged into one BVH whose
triangles keep their object id; NeRF objects load from native or .ingp
snapshots, or are attached in memory (attach_nerf): a NeRF entry without
a "path" is such a slot, for a render-only snapshot that
Session.load_snapshot loads.

Per frame:
- the mesh pass traces every pixel's closest hit (the dense brute-force
  tier up to BRUTE_MAX_TRIS triangles, the BVH above: K3 on CUDA,
  ops/bvh_kernel.py), traces a shadow ray from each hit towards the sun
  (every pixel sent with the hit mask, so nothing is compacted on the
  host), and shades the hit with the Disney BRDF;
  the ambient term is constant sky light, a baked irradiance envmap, or
  the irradiance probe grid gathered from the NeRF
  (engines/irradiance.py);
- renderer="live": each NeRF object is ray-marched with its far bound
  clamped to the mesh depth, and blended over the mesh where it lies in
  front;
- renderer="baked" (the interactive hybrid path): each NeRF object's bake
  is rendered by the baked gather renderer with the same far bound
  (engines/nerf_baked.py::render_rays_baked), and blended by the same
  rule;
- renderer="sweep" (exactly one NeRF object; with more it takes the baked
  path): the NeRF's baked lattice is shaded by K1 and composited by K2
  with a per-pixel stop t_stop, the euclidean distance to the mesh along
  each direction of the sweep's intermediate image, then blended over the
  mesh by the same rule.

The sweep frame makes no host synchronise: its sweep axis comes from the
camera on the host (nerf_sweep._pick_axis, the same central ray), its
constants from utils/device_inputs.py.  Under torch.profiler each BVH
call is a `bvh` device span of the recorder (tracing.py), inside the
frame's PhaseClock phases.

Depth units: the mesh pass returns z-depth t / |d| for camera rays whose
direction has z = 1 in the camera frame; K2's depth is euclidean and is
divided by |d| after the warp; t_stop is euclidean along the normalised
intermediate direction.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import torch

from sienerf_torch.common import NERF_RENDERING_NEAR_DISTANCE
from sienerf_torch.geom.bvh import (
    brute_raytrace,
    build_brute,
    build_bvh,
    bvh_any_hit,
    bvh_raytrace,
)
from sienerf_torch.geom.mesh_io import load_mesh, normalize_to_unit_cube, triangle_normals
from sienerf_torch.ops.brdf import (
    SUN_COLOR,
    BRDFParams,
    checkerboard_floor_color,
    evaluate_shading,
    sky_ambient,
)
from sienerf_torch.ops.optim import inference_params
from sienerf_torch.tracing import RECORDER
from sienerf_torch.utils.bbox import BoundingBox
from sienerf_torch.utils.camera import uv_to_ray
from sienerf_torch.utils.device_inputs import constant

# the dense tier traces faster than the BVH loop up to at least this size
BRUTE_MAX_TRIS = 65536
HYBRID_PHASES = ("mesh", "depth_trace", "shade", "sweep", "rest")


@dataclass
class GeometryObject:
    kind: str  # "mesh" | "nerf"
    center: np.ndarray
    path: str
    tri_range: tuple = (0, 0)  # the object's triangles in the merged BVH
    nerf: object = None  # NerfEngine of a NeRF object
    nerf_state: dict | None = None
    _bake: tuple | None = None  # (grid, meta) of the NeRF's bake, made once


def _norm(x: torch.Tensor) -> torch.Tensor:
    return torch.sqrt((x * x).sum(dim=-1, keepdim=True))


@dataclass(eq=False)
class GeometryEngine:
    objects: list
    bvh_dev: dict | None
    tri_normals: torch.Tensor | None
    tri_obj_id: torch.Tensor | None
    aabb: BoundingBox
    brute_dev: dict | None = None  # constants of the dense tier (small scenes)
    brdf: BRDFParams = field(default_factory=BRDFParams)
    sun_dir: tuple = (0.577, 0.577, 0.577)
    up_dir: tuple = (0.0, 1.0, 0.0)
    floor_y: float | None = None
    # the ambient term's source: "constant" | "envmap" | "grid"
    shade_mode: str = "constant"
    envmap: torch.Tensor | None = None  # (H, W, 3+) lat-long irradiance map
    probe_grid: dict | None = None  # from irradiance.bake_probe_grid
    device: torch.device = field(default_factory=lambda: torch.device("cuda"))

    # --- scene loading ----------------------------------------------------

    @staticmethod
    def load_scene(path: str | Path, data_root: str | Path | None = None,
                   device: str | torch.device = "cuda") -> "GeometryEngine":
        """Parse a scene-graph JSON.  Paths resolve against the JSON's
        directory and `data_root` (an absolute path that does not exist
        resolves by its file name)."""
        path = Path(path)
        dev = torch.device(device)
        spec = json.loads(path.read_text())
        roots = [path.parent] + ([Path(data_root)] if data_root else [])
        objects: list[GeometryObject] = []
        all_tris, all_obj_id = [], []
        n_tris = 0
        aabb = BoundingBox.unit()
        for entry in spec.get("geometry", []):
            center = np.asarray(entry.get("center", [0, 0, 0]), np.float32)
            kind = entry.get("type", "Mesh").lower()
            if kind == "nerf" and "path" not in entry:  # a slot for attach_nerf
                objects.append(GeometryObject("nerf", center, ""))
                aabb = aabb.enlarged(BoundingBox(center, center + 1.0))
                continue
            p = _resolve_path(entry["path"], roots)
            if kind == "mesh":
                tri = normalize_to_unit_cube(load_mesh(p))
                scale = float(entry.get("scale", 1.0))
                tri = (tri - 0.5) * scale + 0.5 + center
                obj = GeometryObject("mesh", center, str(p), (n_tris, n_tris + len(tri)))
                all_tris.append(tri)
                all_obj_id.append(np.full(len(tri), len(objects), np.int32))
                n_tris += len(tri)
                aabb = aabb.enlarged(BoundingBox(tri.reshape(-1, 3).min(axis=0),
                                                 tri.reshape(-1, 3).max(axis=0)))
            elif kind == "nerf":
                obj = GeometryObject("nerf", center, str(p))
                aabb = aabb.enlarged(BoundingBox(center, center + 1.0))
            else:
                raise ValueError(f"unknown geometry type {entry['type']}")
            objects.append(obj)

        bvh_dev = normals = obj_id = brute_dev = None
        if all_tris:
            tris = np.concatenate(all_tris).astype(np.float32)
            bvh = build_bvh(tris)
            bvh_dev = bvh.as_device_arrays(dev)
            normals = torch.from_numpy(triangle_normals(bvh.triangles)).to(dev)
            obj_id = torch.from_numpy(np.concatenate(all_obj_id)[bvh.tri_index]).to(dev)
            # built from the BVH's reordered triangles, so ids index the normals
            if len(tris) <= BRUTE_MAX_TRIS:
                brute_dev = build_brute(bvh.triangles, device=dev)
        return GeometryEngine(objects=objects, bvh_dev=bvh_dev, tri_normals=normals,
                              tri_obj_id=obj_id, brute_dev=brute_dev,
                              aabb=aabb.inflated(0.25), device=dev)

    def attach_nerf(self, index_or_path, nerf_engine, nerf_state) -> None:
        """Bind a NeRF engine and its state to a nerf scene object, given by
        index or path."""
        for i, o in enumerate(self.objects):
            if o.kind == "nerf" and index_or_path in (i, o.path):
                o.nerf, o.nerf_state, o._bake = nerf_engine, nerf_state, None
                return
        raise KeyError(index_or_path)

    def load_nerf_objects(self) -> int:
        """Load every nerf object whose path is a snapshot: a reference
        .ingp / .msgpack (NerfEngine.from_ingp) or a native training
        snapshot -> how many loaded.  A native snapshot needs its network
        config and an aabb_scale (meta["aabb_scale"], or a one-cascade
        occupancy grid, which means 1); a render-only snapshot has neither
        and raises: load it with Session.load_snapshot and attach_nerf."""
        from sienerf_torch.engines.nerf import NerfEngine
        from sienerf_torch.io.snapshot import load_snapshot
        from sienerf_torch.session import _is_reference_snapshot, engine_from_snapshot

        n = 0
        for o in self.objects:
            if o.kind != "nerf" or o.nerf is not None or not o.path:
                continue
            p = Path(o.path)
            if not p.exists() or p.suffix.lower() not in (".ingp", ".msgpack", ".snap"):
                continue
            if _is_reference_snapshot(p):
                eng, state = NerfEngine.from_ingp(p, device=self.device)
            else:
                payload = load_snapshot(p)
                meta = payload.get("meta", {})
                if str(meta.get("kind", "")).startswith("render_only"):
                    raise ValueError(
                        f"{p}: a render-only snapshot holds neither its network config nor "
                        "its aabb_scale, so it cannot be a scene object; load it with "
                        "Session.load_snapshot and bind it with GeometryEngine.attach_nerf")
                eng, state = engine_from_snapshot(payload, p, self.device)
            o.nerf, o.nerf_state, o._bake = eng, state, None
            n += 1
        return n

    # --- mesh pass --------------------------------------------------------

    def _ambient_for(self, geom: dict, pos, normals):
        """The ambient (irradiance) term: the probe grid, an irradiance
        envmap, or the constant ambient colour times sky light."""
        if "envmap" in geom:
            from sienerf_torch.engines.irradiance import sample_envmap_irradiance

            return sample_envmap_irradiance(geom["envmap"], normals)
        if "probe_grid" in geom:
            from sienerf_torch.engines.irradiance import sample_probe_grid

            return sample_probe_grid(geom["probe_grid"], pos, normals)
        up = constant(_f32(self.up_dir), pos.device)
        amb = constant(_f32(self.brdf.ambientcolor), pos.device)
        return amb * sky_ambient(normals, up)

    def _trace(self, geom: dict, o, d, t_max=1e10):
        """Closest hit: the dense tier for small scenes, the BVH otherwise."""
        if "brute" in geom:
            return brute_raytrace(geom["brute"], o, d, t_max)
        with RECORDER.span("bvh", device=True):
            return bvh_raytrace(geom["bvh"], o, d, t_max)

    def _occluded(self, geom: dict, o, d, mask):
        """Shadow rays: True where a triangle lies along the ray, for the
        rays where `mask` is True (False elsewhere)."""
        if "brute" in geom:  # the dense tier traces the masked rays alone
            out = torch.zeros_like(mask)
            ids = torch.nonzero(mask)[:, 0]
            if ids.numel():
                out[ids] = brute_raytrace(geom["brute"], o[ids], d[ids])[1] >= 0
            return out
        with RECORDER.span("bvh", device=True):
            return bvh_any_hit(geom["bvh"], o, d, mask=mask)

    def _geom_dict(self) -> dict:
        geom = {}
        if self.bvh_dev is not None:
            geom = {"bvh": self.bvh_dev, "tri_normals": self.tri_normals}
            if self.brute_dev is not None:
                geom["brute"] = self.brute_dev
        if self.shade_mode == "envmap" and self.envmap is not None:
            geom["envmap"] = self.envmap
        if self.shade_mode == "grid" and self.probe_grid is not None:
            geom["probe_grid"] = self.probe_grid
        return geom

    @torch.no_grad()
    def render_mesh_rays(self, origins, dirs):
        """Mesh pass on a ray batch -> (rgb, z-depth (inf on a miss), hit)."""
        return self._mesh_rays_body(self._geom_dict(), origins, dirs)

    def _mesh_rays_body(self, geom: dict, origins, dirs):
        dn = _norm(dirs)
        d = dirs / dn
        t, tid, _, _ = self._trace(geom, origins, d)
        hit = tid >= 0
        pos = origins + t[:, None] * d
        normal = geom["tri_normals"][torch.clamp(tid, min=0)]
        normal = normal * torch.where((normal * d).sum(dim=-1, keepdim=True) > 0, -1.0, 1.0)
        dev = origins.device
        sun = constant(_f32(self.sun_dir), dev)
        sun = sun / torch.sqrt((sun * sun).sum())
        # shadow rays from the hits towards the sun, every ray sent with the
        # hit mask; a miss keeps shadow 1
        spos = pos + normal * 1e-3
        shadow = torch.where(self._occluded(geom, spos, sun.expand(spos.shape), hit), 0.0, 1.0)
        base = (constant(_f32(self.brdf.basecolor), dev) ** 2).expand(pos.shape)
        if self.floor_y is not None:
            on_floor = (pos[..., 1] < self.floor_y + 1e-3) & (d[..., 1] < 0)
            floor_col = checkerboard_floor_color(pos, self.aabb.min, float(self.aabb.diag[0]))
            base = torch.where(on_floor[..., None], floor_col, base)
            up = constant(_f32((0.0, 1.0, 0.0)), dev)
            normal = torch.where(on_floor[..., None], up, normal)
        amb = self._ambient_for(geom, pos, normal)
        suncol = constant(_f32(SUN_COLOR), dev) * shadow[:, None]
        b = self.brdf
        color = evaluate_shading(base, amb, suncol, sun.expand(pos.shape), -d, normal,
                                 metallic=b.metallic, subsurface=b.subsurface,
                                 specular=b.specular, roughness=b.roughness, sheen=b.sheen,
                                 clearcoat=b.clearcoat, clearcoat_gloss=b.clearcoat_gloss)
        # z-depth along the view axis; t is euclidean along the unit d
        depth = torch.where(hit, t / dn[:, 0], float("inf"))
        return color, depth, hit

    def _mesh_or_empty(self, geom: dict, o, d):
        """Mesh pass (rgb zero off the mesh, depth, alpha) of a ray batch."""
        n = o.shape[0]
        if self.bvh_dev is None:
            return (torch.zeros((n, 3), device=o.device),
                    torch.full((n,), float("inf"), device=o.device),
                    torch.zeros((n,), device=o.device))
        rgb, depth, hit = self._mesh_rays_body(geom, o, d)
        return torch.where(hit[:, None], rgb, 0.0), depth, hit.float()

    # --- hybrid frame -----------------------------------------------------

    def _ensure_nerf_bakes(self, nerf_objs) -> list:
        """Each NeRF object's bake (R=256), made once and kept on the
        object -> [(grid, meta)]; a caller may set `_bake` itself."""
        out = []
        for o in nerf_objs:
            if o._bake is None:
                params = inference_params(o.nerf_state.get("opt") or {},
                                          o.nerf_state["params"])
                o._bake = o.nerf.bake_features(params, o.nerf_state["occ"])
            out.append(o._bake)
        return out

    @staticmethod
    def _frame_rays(width: int, height: int, camera_matrix, focal_length, device):
        """Every pixel's ray through its centre (no lens, centred principal
        point) -> (origins, dirs) (N, 3), dirs with z = 1 in the camera
        frame."""
        idx = torch.arange(width * height, device=device)
        px = (idx % width).float()
        py = (idx // width).float()
        uv = torch.stack([(px + 0.5) / width, (py + 0.5) / height], dim=-1)
        return uv_to_ray(uv, (width, height), focal_length, camera_matrix)

    @torch.no_grad()
    def render_frame(self, width: int, height: int, camera_matrix, focal_length,
                     background=(1.0, 1.0, 1.0), tile: int = 1 << 14,
                     renderer: str = "live", impl: str = "kernel",
                     stats: dict | None = None):
        """Hybrid frame -> (rgba (H, W, 4), z-depth (H, W)) on the engine's
        device.  The mesh pass writes colour and depth; each NeRF object is
        blended over it where it lies in front, its march stopped at the
        mesh: "live" marches the field; "baked" gathers each object's bake
        (render_rays_baked, the interactive hybrid path); "sweep" takes its
        baked lattice through K1 and K2 with the mesh's t_stop when there is
        exactly one NeRF object, and the baked path otherwise.  `tile` rays
        are rendered at a time; per-ray results do not depend on it.
        `impl` ("kernel" or "plain") chooses the hand-written kernels or
        their plain versions on the card (K1 and K2 of the sweep, G1 and G2
        of the baked path).  `stats` applies to the sweep: it receives the
        sweep axis and flip, the mesh's t_stop, the shaded volume, the
        intermediate grid (o_c, eb, ec, near, min transmittance) and the
        composite (C, opacity, T, depth), so that a caller can hold the
        kernels to their plain versions on this frame's inputs, and, with
        stats["sync_phases"] set, the seconds of HYBRID_PHASES; on the baked
        path it receives the seconds of "mesh" and "nerf"."""
        nerf_objs = [o for o in self.objects if o.kind == "nerf" and o.nerf is not None]
        if renderer == "sweep" and len(nerf_objs) == 1:
            return self._render_frame_hybrid_sweep(width, height, camera_matrix,
                                                   focal_length, background, nerf_objs[0],
                                                   impl, stats)
        if renderer == "sweep":
            renderer = "baked"  # the sweep takes exactly one NeRF object
        if renderer not in ("live", "baked"):
            raise ValueError(f"unknown renderer {renderer!r}")
        if impl not in ("kernel", "plain"):
            raise ValueError(f"unknown impl {impl!r}")
        from sienerf_torch.engines.nerf_baked import render_rays_baked
        from sienerf_torch.tracing import PhaseClock

        dev = self.device
        clock = PhaseClock(stats, dev, ("mesh", "nerf"))
        bakes = self._ensure_nerf_bakes(nerf_objs) if renderer == "baked" else \
            [None] * len(nerf_objs)
        o, d = self._frame_rays(width, height, camera_matrix, focal_length, dev)
        geom = self._geom_dict()
        rgb, depth, alpha = self._mesh_or_empty(geom, o, d)
        clock.phase("mesh")
        for obj, bake in zip(nerf_objs, bakes):
            params = inference_params(obj.nerf_state.get("opt") or {},
                                      obj.nerf_state["params"])
            bf = obj.nerf_state["occ"]["bitfield"]
            center = torch.as_tensor(np.asarray(obj.center, np.float32), device=dev)
            parts = []
            for s in range(0, o.shape[0], tile):
                oo, dd, cap = o[s:s + tile] - center, d[s:s + tile], depth[s:s + tile]
                if bake is None:
                    parts.append(obj.nerf.render_rays(params, bf, oo, dd, t_cap=cap))
                else:
                    parts.append(render_rays_baked(
                        obj.nerf, params, bake[0], bake[1], bf, oo, dd, P=64, evals=16,
                        step_scale=4.0, t_cap=cap, impl=impl))
            n_rgb, n_op, n_depth = (torch.cat(x) for x in zip(*parts))
            rgb, alpha, depth = _blend_over(rgb, alpha, depth, n_rgb, n_op, n_depth)
        clock.phase("nerf")
        bg = constant(_f32(background), dev)
        rgb = rgb + (1.0 - alpha)[:, None] * bg
        rgba = torch.cat([rgb, alpha[:, None]], dim=-1)
        return rgba.reshape(height, width, 4), depth.reshape(height, width)

    def _render_frame_hybrid_sweep(self, width, height, camera_matrix, focal_length,
                                   background, obj, impl: str = "kernel",
                                   stats: dict | None = None):
        from sienerf_torch.engines.nerf_sweep import (
            E_MAX,
            _align,
            _fused_prep_eligible,
            _pick_axis,
            axis_view,
            prepare_rgba_volume,
        )
        from sienerf_torch.ops.shade import shade_volume
        from sienerf_torch.ops.sweep import canon_coords, orient_grid, sweep_composite, warp_to_pixels
        from sienerf_torch.ops.sweep_kernel import sweep_composite_kernel
        from sienerf_torch.tracing import PhaseClock

        if impl not in ("kernel", "plain"):
            raise ValueError(f"unknown impl {impl!r}")
        grid, meta = self._ensure_nerf_bakes([obj])[0]
        if meta["mode"] != "nearest":
            raise ValueError("the sweep hybrid needs a mode='nearest' bake")
        eng = obj.nerf
        dev = grid["rows"].device
        clock = PhaseClock(stats, dev, HYBRID_PHASES)
        # the sweep axis from the centre pixel's ray, on the host: the
        # camera's third column, as uv_to_ray gives it at uv (0.5, 0.5)
        axis, flip = _pick_axis(camera_matrix, focal_length, width, height)
        hi, wi = _align(1.15 * height), _align(1.15 * width)
        R, K = meta["resolution"], meta["n_cascades"]
        params = inference_params(obj.nerf_state.get("opt") or {}, obj.nerf_state["params"])
        center = constant(_f32(obj.center), dev)
        o, d = self._frame_rays(width, height, camera_matrix, focal_length, dev)
        clock.phase("rest")

        # (a) the mesh pass on the pixels
        geom = self._geom_dict()
        mrgb, mdepth, malpha = self._mesh_or_empty(geom, o, d)
        clock.phase("mesh")

        # the sweep's geometry in the NeRF's own frame
        o0 = o[0] - center
        dnl = _norm(d)[:, 0]
        d_n = d / dnl[:, None]
        o_c = canon_coords(o0, axis, flip, True)
        d_c = canon_coords(d_n, axis, flip, False)
        e_raw = d_c[:, 1:] / torch.clamp(d_c[:, 0:1], min=1e-3)
        good = (d_c[:, 0] > 1e-3) & (e_raw.abs() <= E_MAX).all(dim=-1)
        e_px = e_raw.clamp(-E_MAX, E_MAX)
        e_ok = torch.where(good[:, None], e_px, 0.0)
        elo = torch.where(good[:, None], e_ok, 1e9).amin(dim=0)
        ehi = torch.where(good[:, None], e_ok, -1e9).amax(dim=0)
        span = torch.clamp(ehi - elo, min=1e-3)
        deb = span[0] / (hi - 2)
        dec = span[1] / (wi - 2)
        eb = elo[0] + (torch.arange(hi, device=dev, dtype=torch.float32) - 0.5) * deb
        ec = elo[1] + (torch.arange(wi, device=dev, dtype=torch.float32) - 0.5) * dec
        clock.phase("rest")

        # (b) the mesh's euclidean distance along each intermediate direction
        # (canonical (1, eb, ec) in world axes)
        if self.bvh_dev is not None:
            b_ax, c_ax = [ax for ax in (0, 1, 2) if ax != axis]
            dw = torch.zeros((hi * wi, 3), dtype=torch.float32, device=dev)
            dw[:, axis] = -1.0 if flip else 1.0
            dw[:, b_ax] = eb[:, None].expand(hi, wi).reshape(-1)
            dw[:, c_ax] = ec[None, :].expand(hi, wi).reshape(-1)
            dw = dw / _norm(dw)
            t, tid, _, _ = self._trace(geom, o[0].expand(dw.shape), dw)
            t_stop = torch.where(tid >= 0, t, float("inf")).reshape(hi, wi)
        else:
            t_stop = torch.full((hi, wi), float("inf"), device=dev)
        clock.phase("depth_trace")

        # (c) the sweep composite with the per-pixel stop
        near = max(NERF_RENDERING_NEAR_DISTANCE, eng.near_distance)
        min_t = eng.render_min_transmittance
        net = eng.net
        if impl == "kernel":
            if _fused_prep_eligible(eng, grid):
                vol = shade_volume(grid["rows"], grid["scale"], o0, params["rgb_mlp"],
                                   resolution=R, n_cascades=K, density_act=net.density_activation,
                                   rgb_act=net.rgb_activation, rgb_mlp=net.rgb_mlp)
            else:  # the JAX package's route: the plain shade, then K2
                vol = prepare_rgba_volume(eng, params, grid["rows"], grid["scale"], o0, R,
                                          K).permute(0, 1, 4, 2, 3)
            clock.phase("shade")
            C, op, T, bt = sweep_composite_kernel(
                axis_view(vol, axis), o_c, eb, ec, near, min_t, t_stop, resolution=R,
                n_cascades=K, data_flip=flip)
        else:
            vol = prepare_rgba_volume(eng, params, grid["rows"], grid["scale"], o0, R, K)
            clock.phase("shade")
            C, op, T, bt = sweep_composite(orient_grid(vol, axis, flip), o_c, eb, ec, near,
                                           min_t, t_stop, resolution=R, n_cascades=K)
        clock.phase("sweep")
        maps = torch.cat([C, op[..., None], bt[..., None]], dim=-1)
        outs = warp_to_pixels(maps, e_px, eb[0], deb, ec[0], dec)
        nrgb = torch.where(good[:, None], outs[:, :3], 0.0)
        nop = torch.where(good, outs[:, 3].clamp(0.0, 1.0), 0.0)
        # z-depth in the mesh pass's units
        ndep = torch.where(good, outs[:, 4], 0.0) / torch.clamp(dnl, min=1e-9)

        # (d) the depth-tested blend, as in the live hybrid
        rgb, alpha, depth = _blend_over(mrgb, malpha, mdepth, nrgb, nop, ndep)
        bg = constant(_f32(background), dev)
        rgb = rgb + (1.0 - alpha)[:, None] * bg
        rgba = torch.cat([rgb, alpha[:, None]], dim=-1)
        if stats is not None:
            stats.update(axis=axis, flip=flip, t_stop=t_stop, volume=vol, intermediate=(
                o_c, eb, ec, near, min_t), composite=(C, op, T, bt))
        clock.phase("rest")
        return rgba.reshape(height, width, 4), depth.reshape(height, width)


def _f32(values) -> np.ndarray:
    return np.asarray(values, np.float32)


def _blend_over(rgb, alpha, depth, n_rgb, n_op, n_depth):
    """A NeRF's fragment over the frame where it lies in front of what the
    frame holds: fb = nerf + fb * (1 - a); a solid fragment (a > 0.2) takes
    over the depth."""
    in_front = (n_op > 0.0) & (n_depth < depth)
    a = torch.where(in_front, n_op, 0.0)
    rgb = torch.where(in_front[:, None], n_rgb + rgb * (1.0 - a[:, None]), rgb)
    alpha = torch.where(in_front, a + alpha * (1.0 - a), alpha)
    depth = torch.where(in_front & (a > 0.2), n_depth, depth)
    return rgb, alpha, depth


def _resolve_path(p: str, roots) -> Path:
    cand = Path(p)
    if cand.exists():
        return cand
    for root in roots:
        for probe in (root / p, root / cand.name, root / "objs" / cand.name,
                      root / "geometry" / "objs" / cand.name):
            if probe.exists():
                return probe
    raise FileNotFoundError(f"cannot resolve scene asset {p}")
