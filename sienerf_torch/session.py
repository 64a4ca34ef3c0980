"""Session façade (port of the JAX package's session.py::Session): load a
NeRF scene and train it, save and load training snapshots, load a
render-only snapshot or a reference .ingp snapshot, or load a geometry
scene (meshes and NeRF objects); render live (the streaming ray-marched
renderer, the default), or bake and render slab-sweep frames or baked
gather frames.  Image (.exr), SDF (.obj / .stl) and volume (.nvdb) scenes
load, train and render through the same calls; NeRF and SDF fields export
meshes (save_mesh, optimise_mesh_step).  A trained session renders and
bakes from the optimizer's EMA shadow of the params."""

from __future__ import annotations

import dataclasses
import zlib
from pathlib import Path

import numpy as np
import torch

from sienerf_torch import metrics
from sienerf_torch.common import TestbedMode
from sienerf_torch.convert import train_state_from_jax, train_state_to_jax
from sienerf_torch.engines.image import ImageEngine
from sienerf_torch.engines.nerf import NerfEngine
from sienerf_torch.engines.sdf import SdfEngine
from sienerf_torch.engines.volume import VolumeEngine
from sienerf_torch.geom.mesh_io import load_mesh, normalize_to_unit_cube, save_obj, save_ply
from sienerf_torch.io import msgpack_lite
from sienerf_torch.io.image_io import load_image
from sienerf_torch.io.nanovdb import read_nanovdb
from sienerf_torch.io.nerf_dataset import NerfDataset, load_nerf_dataset
from sienerf_torch.io.snapshot import (
    grid_config_for_snapshot,
    load_snapshot,
    render_snapshot_from_payload,
    save_snapshot,
)
from sienerf_torch.models.nerf_network import (
    apply_density_activation,
    apply_rgb_activation,
    density_raw,
    nerf_apply,
)
from sienerf_torch.models.single_network import apply_single_network
from sienerf_torch.ops.meshing import extract_mesh, optimise_mesh
from sienerf_torch.ops.optim import inference_params
from sienerf_torch.ops.samplers import ld_pixel_offset
from sienerf_torch.ops.tonemap import error_overlay
from sienerf_torch.tracing import RECORDER
from sienerf_torch.utils import log
from sienerf_torch.utils.camera import camera_slerp
from sienerf_torch.utils.config import default_configs_dir, load_network_config
from sienerf_torch.utils.timers import PhaseTimers


# NerfEngine fields that load_file sets from its keyword arguments
LEARNER_FLAGS = ("optimize_extrinsics", "optimize_focal", "optimize_exposure",
                 "optimize_distortion", "train_envmap", "depth_supervision_lambda",
                 "compact_training", "adapt_ray_count", "extrinsics_lr_scale")


def mode_from_scene(path: str | Path) -> TestbedMode:
    """The mode a scene path implies: a directory holding transforms*.json
    or such a file is NeRF, a JSON with "geometry" in its name a geometry
    scene, an image file image mode, a mesh SDF mode, .nvdb volume mode;
    a snapshot (.ingp, .snap, .msgpack) is NONE (its content decides)."""
    p = Path(path)
    name = str(p).lower()
    if p.is_dir():
        if any(p.glob("transforms*.json")):
            return TestbedMode.NERF
        raise ValueError(f"scene directory {path} has no transforms*.json (NeRF scenes are "
                         "directories containing a transforms.json; other modes are files)")
    if name.endswith("transforms.json"):
        return TestbedMode.NERF
    if "geometry" in Path(name).name and name.endswith(".json"):
        return TestbedMode.GEOMETRY
    ext = p.suffix.lower()
    if ext in (".exr", ".png", ".jpg", ".jpeg", ".bin"):
        return TestbedMode.IMAGE
    if ext in (".obj", ".stl"):
        return TestbedMode.SDF
    if ext == ".nvdb":
        return TestbedMode.VOLUME
    if ext == ".json":
        return TestbedMode.NERF
    if ext in (".ingp", ".snap", ".msgpack"):
        return TestbedMode.NONE
    raise ValueError(f"cannot infer mode from scene {path}")


_PEEK_BYTES = 1 << 16


def _is_reference_snapshot(path: str | Path) -> bool:
    """A reference .ingp / msgpack snapshot (its state under "snapshot")
    rather than the native container (its state under "state").  The top
    map's keys are read from the file's first 64 KiB, decompressed as far
    as they go: the first of the two keys decides (each container has only
    its own), and only when neither shows there is the whole file
    decoded."""
    try:
        with open(path, "rb") as f:
            head = f.read(_PEEK_BYTES)
        if head[:1] == b"\x78":
            head = zlib.decompressobj().decompress(head)
        for key in msgpack_lite.top_keys(head):
            if key in ("snapshot", "state"):
                return key == "snapshot"
        raw = Path(path).read_bytes()
        if raw[:1] == b"\x78":
            raw = zlib.decompress(raw)
        top = msgpack_lite.unpack(raw)
        return isinstance(top, dict) and "snapshot" in top and "state" not in top
    except Exception:
        return False


class Session:
    """One engine, its state (training or render-only) and the cached bake,
    on `device`.  Training draws from a generator seeded with `seed`."""

    def __init__(self, configs_dir: str | Path | None = None, seed: int = 1337,
                 device: str | torch.device = "cuda"):
        self.configs_dir = Path(configs_dir) if configs_dir else default_configs_dir()
        self.device = torch.device(device)
        self.seed = seed
        self.mode = TestbedMode.NONE
        self.engine = None
        self.state: dict | None = None
        self.network_config: dict = {}
        self.training_step = 0
        self.loss = float("nan")
        self.loss_graph: list[float] = []
        self.timers = PhaseTimers()
        self._baked = None
        self._generator: torch.Generator | None = None
        # the training view whose extra dims frames render with (0: the
        # engine's default row)
        self.rendering_extra_dims_from_training_view = 0

    def load_file(self, scene: str | Path, network: str | Path | None = None,
                  **engine_kwargs):
        """Load a scene: a NeRF scene (a directory holding transforms.json,
        or the file) with the network config `network`
        (configs/nerf/base.json by default) and a fresh training state, or
        a geometry scene JSON, whose snapshot-backed NeRF objects load with
        it.  Dataset options: downscale, max_images, split; engine options:
        train_batch_size, grid_size, train_k, near_density_reg,
        near_reg_fraction (geometry: data_root), and the learners and loss
        terms, set on the engine before its state is made (LEARNER_FLAGS:
        optimize_extrinsics, optimize_focal, optimize_exposure,
        optimize_distortion, train_envmap, depth_supervision_lambda,
        compact_training, adapt_ray_count, extrinsics_lr_scale).  An image, a mesh or an
        .nvdb volume loads its mode's engine (configs/<mode>/base.json by
        default; option batch_size, and host_gt for SDF) with fresh
        params."""
        scene = Path(scene)
        mode = mode_from_scene(scene)
        if mode == TestbedMode.NONE:
            raise ValueError(f"{scene} is a snapshot: load it with load_snapshot")
        self._baked = None
        self._scene = scene
        self._engine_kwargs = dict(engine_kwargs)
        self.mode = mode
        self.training_step = 0
        self.loss = float("nan")
        self.loss_graph = []
        if mode == TestbedMode.GEOMETRY:
            from sienerf_torch.engines.geometry import GeometryEngine

            self.network_config = load_network_config(network) if network else {}
            self.engine = GeometryEngine.load_scene(scene, device=self.device, **engine_kwargs)
            self.engine.load_nerf_objects()
            self.state = {}
            self._generator = None
            return self
        cfg_path = Path(network) if network else self.configs_dir / mode.value / "base.json"
        self.network_config = load_network_config(cfg_path)
        self._generator = torch.Generator(device=self.device).manual_seed(self.seed)
        if mode in (TestbedMode.IMAGE, TestbedMode.SDF, TestbedMode.VOLUME):
            self.engine, self.state = _single_network_engine(
                mode, scene, self.network_config, self.device, self.seed, engine_kwargs)
            return self
        ds = load_nerf_dataset(scene, **{k: v for k, v in engine_kwargs.items()
                                         if k in ("downscale", "max_images", "split")})
        ekw = {k: v for k, v in engine_kwargs.items()
               if k in ("train_batch_size", "grid_size", "train_k", "near_density_reg",
                        "near_reg_fraction")}
        self.engine = NerfEngine.create(self.network_config, ds, device=self.device, **ekw)
        for k, v in engine_kwargs.items():
            if k in LEARNER_FLAGS:
                setattr(self.engine, k, v)
        self.state = self.engine.init(self.seed)
        self.dataset = ds
        return self

    def reload_network_from_file(self, network: str | Path | None = None):
        """Re-read the network config (`network`, or the mode's default) and
        start the loaded scene's engine and state afresh."""
        scene = getattr(self, "_scene", None)
        if scene is None:
            raise RuntimeError("load_file first")
        return self.load_file(scene, network=network, **getattr(self, "_engine_kwargs", {}))

    def train(self, n_steps: int, log_every: int = 256) -> float:
        """Train until at least n_steps have run -> the last loss: NeRF in
        bundles of engine.grid_interval steps, SDF and volume in bundles of
        16, image one step at a time (each counted as 16 training steps, as
        the reference's session counts them).  Each bundle is timed into
        timers["train"] (its loss read back inside the timed span); a line
        `iteration=... loss=...` is logged after each bundle that ends
        within a bundle's length (16 for image steps) past a multiple of
        `log_every` steps run in this call, as the reference logs."""
        if self.mode == TestbedMode.GEOMETRY:
            raise RuntimeError("geometry scenes train their NeRF objects separately")
        if self.engine is None:
            raise RuntimeError("load_file first")
        if not self.state.get("opt"):
            raise RuntimeError("cannot train from a render-only snapshot "
                               "(no optimizer state)")
        if self._generator is None:
            self._generator = torch.Generator(device=self.device).manual_seed(
                self.seed + self.training_step)
        done = 0
        while done < n_steps:
            with self.timers.phase("train"):
                if isinstance(self.engine, ImageEngine):
                    p, o, loss = self.engine.train_step(self.state["params"],
                                                        self.state["opt"], self._generator)
                    self.state = {"params": p, "opt": o}
                    step = 1
                elif isinstance(self.engine, NerfEngine):
                    self.state, loss, _ = self.engine.train_bundle(self.state,
                                                                   self._generator)
                    step = self.engine.grid_interval
                else:
                    self.state, loss = self.engine.train_bundle(self.state, self._generator)
                    step = 16
                self.loss = float(loss)  # reads the device: the span holds the bundle
            done += step
            self.training_step += 16 if isinstance(self.engine, ImageEngine) else step
            self.loss_graph.append(self.loss)
            self._baked = None  # a bake is of the params it was made from
            if done % log_every < getattr(self.engine, "grid_interval", 16):
                log.info(f"iteration={self.training_step} loss={self.loss:.6f} "
                         f"{self.timers.summary()}")
        return self.loss

    def render_params(self) -> dict:
        """The params bake() and render() read: the EMA shadow when the
        state has optimizer state, else (a render-only snapshot) its
        params."""
        opt = self.state.get("opt")
        return inference_params(opt, self.state["params"]) if opt else self.state["params"]

    # --- snapshots --------------------------------------------------------

    def save_snapshot(self, path: str | Path, level: int = 6) -> None:
        """Write the training state, the network config and meta (mode,
        training step, aabb_scale, the trainer's phase and measured samples
        a ray) as a native snapshot, which the JAX package's load_snapshot
        reads too.  `level` is the zlib level (0 stores: a fox-width state
        holds 2 GB of floats, which zlib compresses little and slowly)."""
        if not isinstance(self.engine, NerfEngine) or not self.state.get("opt"):
            raise RuntimeError("save_snapshot writes a NeRF training state")
        meta = {"mode": TestbedMode.NERF.value, "training_step": self.training_step,
                "aabb_scale": float(self.engine.aabb.diag[0])}
        phase = getattr(self.engine, "_phase", None)
        if phase is not None:
            meta["train_phase"] = phase
        mean = getattr(self.engine, "_mean_samples", None)
        if mean:
            meta["mean_samples"] = float(mean)
        save_snapshot(path, train_state_to_jax(self.state), self.network_config, meta,
                      level=level)

    def load_snapshot(self, path: str | Path):
        """Load a snapshot: a reference .ingp / .msgpack (an engine with the
        corner-layout table it holds, on the loaded scene's dataset and
        train_batch_size where a scene is loaded), a render-only snapshot (the fox
        field: aabb_scale 2^(cascades - 1), configs/nerf/base.json with its
        hash grid sized from the snapshot's grid_shape, both checked), or a
        native training snapshot with its optimizer state (onto the loaded
        scene's engine, or one built from the snapshot's config and
        aabb_scale)."""
        self._baked = None
        if _is_reference_snapshot(path):
            # on the loaded scene's dataset, at its train_batch_size
            bs = getattr(self, "_engine_kwargs", {}).get("train_batch_size", 1 << 18)
            self.engine, self.state = NerfEngine.from_ingp(
                path, dataset=getattr(self, "dataset", None), train_batch_size=bs,
                device=self.device)
            self.mode = TestbedMode.NERF
            self.training_step = int(self.state["step"])
            self._generator = None
            return {"state": self.state}
        payload = load_snapshot(path)
        meta = payload.get("meta", {})
        self.mode = TestbedMode.NERF
        if str(meta.get("kind", "")).startswith("render_only"):
            n_casc = int(np.asarray(payload["state"]["occ"]["bitfield"]).shape[0])
            aabb_scale = float(2 ** (n_casc - 1))
            cfg = grid_config_for_snapshot(
                load_network_config(self.configs_dir / "nerf" / "base.json"), meta)
            params, bitfield, smeta = render_snapshot_from_payload(
                payload, network_config=cfg, aabb_scale=aabb_scale, device=self.device)
            self.network_config = cfg
            self.engine = NerfEngine.create(cfg, NerfDataset.placeholder(aabb_scale),
                                            device=self.device)
            self._generator = None
            self.state = {"params": params, "occ": {"bitfield": bitfield},
                          "step": smeta["step"]}
            self.training_step = smeta["step"]
            return payload
        if isinstance(self.engine, NerfEngine):
            self.state = train_state_from_jax(payload["state"], self.device)
            _check_state_fits(self.engine, self.state, path)
            _restore_trainer_meta(self.engine, meta)
            _restore_learners(self.engine, self.state["params"])
        else:
            self.network_config = payload.get("config") or {}
            self.engine, self.state = engine_from_snapshot(payload, path, self.device)
        self.training_step = int(meta.get("training_step", 0))
        # a resumed run draws on from the restored step, not from the start
        self._generator = torch.Generator(device=self.device).manual_seed(
            self.seed + self.training_step)
        return payload

    # --- rendering --------------------------------------------------------

    def bake(self, resolution: int = 256, mode: str = "nearest", row_bits: int = 16):
        """Bake the loaded field into the render-side row table and its
        sidecars; cached until the next bake(), load or training bundle."""
        if not isinstance(self.engine, NerfEngine):
            raise RuntimeError("bake() is a NeRF-mode operation: load a NeRF scene or a "
                               "snapshot first")
        self._baked = self.engine.bake_features(
            self.render_params(), self.state["occ"], resolution=resolution,
            mode=mode, row_bits=row_bits)
        return self._baked

    @torch.no_grad()
    def render(self, width: int, height: int, camera_matrix=None, focal=None,
               spp: int = 1, renderer: str = "live", **kw) -> torch.Tensor:
        """Offscreen render -> (H, W, 4) f32 rgba tensor on the session's
        device.  renderer "live" (the default) ray-marches the field itself;
        "sweep" composites the baked lattice; "baked" gathers the bake's rows
        along candidate chains (engines/nerf_baked.py).  Both baked renderers
        bake once (bake_resolution, bake_mode) and keep the bake.  spp > 1
        averages passes in float64, each with a low-discrepancy subpixel
        offset; the sweep adds a stratified slab-phase jitter and the baked
        renderer a stratified chain-phase jitter.  `camera_matrix_end` blurs
        motion: pass i renders at the camera slerped (i + 0.5) / spp of the
        way from `camera_matrix` to it.  A field with extra dims renders
        with training view `rendering_extra_dims_from_training_view`'s row
        (an explicit `extra_row` wins).  A geometry scene renders
        its hybrid frame with `renderer` ("live", "baked" or "sweep"; one
        pass: GeometryEngine.render_frame, its options in kw); an image its
        network at pixel centres (alpha 1 for three channels); an SDF its
        sphere-traced frame (alpha 1; SdfEngine.render_frame's options in
        kw); a volume its delta-tracked frame of spp passes, alpha the
        opacity (VolumeEngine.render_frame's options in kw).  Under
        torch.profiler the call is a `render` span of the recorder
        (tracing.py), each spp pass a `pass` span."""
        with RECORDER.frame("render", self.device):
            return self._render(width, height, camera_matrix, focal, spp, renderer, **kw)

    def _render(self, width, height, camera_matrix, focal, spp, renderer, **kw):
        if self.engine is None:
            raise RuntimeError("load a scene or a snapshot first")
        if self.mode == TestbedMode.GEOMETRY:
            rgba, _ = self.engine.render_frame(width, height, camera_matrix,
                                               focal or (width, width), renderer=renderer, **kw)
            return rgba
        if not isinstance(self.engine, NerfEngine) and renderer != "live":
            raise ValueError(f"renderer={renderer!r} is NeRF-only (mode is {self.mode.value})")
        if isinstance(self.engine, ImageEngine):
            out = self.engine.render(self.state["params"], self.state["opt"], width, height)
            if out.shape[-1] == 3:
                out = torch.cat([out, torch.ones_like(out[..., :1])], dim=-1)
            return out
        if isinstance(self.engine, SdfEngine):
            img, _ = self.engine.render_frame(self.render_params(), width, height,
                                              camera_matrix, **kw)
            return torch.cat([img, torch.ones_like(img[..., :1])], dim=-1)
        if isinstance(self.engine, VolumeEngine):
            rgb, a = self.engine.render_frame(self.render_params(), width, height,
                                              camera_matrix, focal or (width, width),
                                              spp=spp, **kw)
            return torch.cat([rgb, a[..., None]], dim=-1)
        if renderer not in ("sweep", "live", "baked"):
            raise ValueError(f"unknown renderer {renderer!r}")
        eng = self.engine
        params = self.render_params()
        if camera_matrix is None:
            camera_matrix = eng.xforms[0]
            focal = tuple(np.asarray(eng.focals[0]) * width / eng.resolution[0])
            kw.setdefault("screen_center", tuple(np.asarray(eng.principal_points[0])))
        start = np.asarray(camera_matrix, np.float32)
        end = np.asarray(kw.pop("camera_matrix_end", start), np.float32)
        focal = tuple(np.asarray(focal, np.float32))
        ev = int(self.rendering_extra_dims_from_training_view)
        if ev > 0 and "extra_dims" in params and "extra_row" not in kw:
            kw["extra_row"] = params["extra_dims"][ev]
        bake_res = kw.pop("bake_resolution", 256)
        bake_mode = kw.pop("bake_mode", "nearest")
        if renderer != "live" and self._baked is None:
            self.bake(resolution=bake_res, mode=bake_mode)
        from sienerf_torch.engines.nerf_baked import render_frame_baked
        from sienerf_torch.engines.nerf_sweep import render_frame_sweep

        spp = max(int(spp), 1)
        acc = None
        for i in range(spp):
            with RECORDER.span("pass", device=True):
                cam = start
                if not np.allclose(start, end):
                    t = torch.tensor([(i + 0.5) / spp], dtype=torch.float32)
                    cam = camera_slerp(torch.from_numpy(start)[None],
                                       torch.from_numpy(end)[None], t)[0].numpy()
                off = ld_pixel_offset(i) if spp > 1 else None
                phase = np.float32((i + 0.5) / spp) if spp > 1 else None
                if renderer == "sweep":
                    grid, meta = self._baked
                    out5 = render_frame_sweep(
                        eng, params, grid, meta, cam, focal, width=width,
                        height=height, pixel_offset=off, axis_phase=phase, packed=True, **kw)
                    rgba = out5[:4].permute(1, 2, 0)
                elif renderer == "baked":
                    grid, meta = self._baked
                    rgba, _ = render_frame_baked(
                        eng, params, self.state["occ"]["bitfield"], grid, cam, focal,
                        width=width, height=height, resolution=meta["resolution"],
                        mode=meta["mode"], n_cascades=meta["n_cascades"], pixel_offset=off,
                        t_phase=phase, **kw)
                else:
                    rgba, _ = eng.render_frame(
                        params, self.state["occ"]["bitfield"], width, height,
                        cam, focal, pixel_offset=off, **kw)
                with RECORDER.span("accumulate", device=True):
                    a = rgba.double()
                    acc = a if acc is None else acc + a
        return (acc / spp).float()


    # --- evaluation overlays ------------------------------------------------

    def compare_view(self, view_index: int = 0, downscale: int = 1, **render_kw):
        """Render training view `view_index` with the live renderer ->
        (pred (H, W, 3), gt (H, W, 3), error overlay (H, W, 3), PSNR), the
        arrays in numpy: the reference's ground-truth overlay and false-colour
        error oracle (render_frame_epilogue, testbed.cu:4977-5087).
        `render_kw` goes to NerfEngine.render_frame (tile, stats)."""
        if self.mode != TestbedMode.NERF or not isinstance(self.engine, NerfEngine) \
                or getattr(self.engine, "images", None) is None:
            raise RuntimeError("compare_view needs a NeRF scene with training views")
        eng = self.engine
        w, h = eng.resolution[0] // downscale, eng.resolution[1] // downscale
        rgba, _ = eng.render_frame(
            self.render_params(), self.state["occ"]["bitfield"], w, h, eng.xforms[view_index],
            tuple(np.asarray(eng.focals[view_index]) / downscale),
            screen_center=tuple(np.asarray(eng.principal_points[view_index])), **render_kw)
        pred = rgba[..., :3]
        gt = torch.as_tensor(np.ascontiguousarray(
            eng.images[view_index][::downscale, ::downscale, :3]), device=pred.device)
        err = error_overlay(pred, gt)
        return (pred.cpu().numpy(), gt.cpu().numpy(), err.cpu().numpy(),
                metrics.psnr(pred, gt))

    # --- meshes -----------------------------------------------------------

    def _mesh_field(self, thresh: float = 2.5):
        """The field to mesh -> (density_fn of unit-cube points, iso level:
        `thresh` of a NeRF density, 0 of an SDF, aabb min, aabb diag)."""
        if not isinstance(self.engine, (NerfEngine, SdfEngine)):
            raise RuntimeError(f"mesh export is for NeRF and SDF fields (mode is "
                               f"{self.mode.value})")
        params = self.render_params()
        if isinstance(self.engine, NerfEngine):
            net = self.engine.net

            def dfn(unit):
                return apply_density_activation(density_raw(net, params, unit),
                                                net.density_activation)
            return dfn, thresh, self.engine.aabb.min, self.engine.aabb.diag
        net, tables = self.engine.net, self.engine.tak_tables
        return (lambda unit: apply_single_network(net, params, unit, tables=tables)[:, 0], 0.0,
                np.zeros(3, np.float32), np.ones(3, np.float32))

    def save_mesh(self, path: str | Path, resolution: int = 256, thresh: float = 2.5,
                  with_colors: bool = True):
        """Marching cubes of the field at resolution^3 over its box (NeRF:
        density at `thresh`; SDF: the zero level), saved as .obj or .ply ->
        (vertices, faces).  NeRF vertices carry colours (the colour branch
        looking along the inward normal, from 6-tap differences of the
        density) and outward normals.  The mesh stays in memory for
        optimise_mesh_step."""
        dfn, iso, amin, adiag = self._mesh_field(thresh)
        color_fn = None
        if with_colors and isinstance(self.engine, NerfEngine):
            color_fn = self._nerf_vertex_colors(dfn, amin, adiag, resolution)
        verts, faces, cn = extract_mesh(dfn, resolution, amin, adiag, self.device, iso=iso,
                                        color_fn=color_fn)
        colors = normals = None
        if cn is not None:
            colors, normals = cn[:, :3], cn[:, 3:]
        if str(path).endswith(".ply"):
            save_ply(path, verts, faces, colors, normals)
        else:
            save_obj(path, verts, faces, colors, normals)
        self.mesh = {"verts": verts, "faces": faces, "thresh": iso, "amin": amin,
                     "adiag": adiag}
        return verts, faces

    def _nerf_vertex_colors(self, dfn, amin, adiag, resolution: int):
        net, params = self.engine.net, self.render_params()

        def color_fn(world):
            amin_t = torch.as_tensor(np.asarray(amin, np.float32), device=world.device)
            adiag_t = torch.as_tensor(np.asarray(adiag, np.float32), device=world.device)
            unit = torch.clamp((world - amin_t) / adiag_t, 0.0, 1.0)
            eps = 1.0 / resolution
            eye = torch.eye(3, device=world.device)
            offs = torch.cat([eye * eps, -eye * eps])
            taps = torch.clamp(unit[:, None, :] + offs[None], 0.0, 1.0)
            d6 = dfn(taps.reshape(-1, 3)).reshape(-1, 6)
            g = d6[:, :3] - d6[:, 3:]
            nrm = g / torch.clamp(torch.linalg.norm(g, dim=-1, keepdim=True), min=1e-9)
            ex = self.engine._render_extra(params)
            if ex is not None:
                ex = ex.expand(unit.shape[0], ex.shape[0])
            rgb_raw, _ = nerf_apply(net, params, unit, (nrm + 1.0) * 0.5, extra=ex)
            rgb = apply_rgb_activation(rgb_raw, net.rgb_activation)
            return torch.cat([rgb, -nrm], dim=-1)  # colours, outward normals
        return color_fn

    def optimise_mesh_step(self, n_steps: int = 1, smooth_amount: float = 2048.0,
                           density_amount: float = 128.0, inflate_amount: float = 1.0):
        """Refine the in-memory mesh (from save_mesh) toward the field's
        iso-surface: n_steps Adam steps on its vertices
        (ops/meshing.py::optimise_mesh) -> the new vertices."""
        mesh = getattr(self, "mesh", None)
        if not mesh or not len(mesh.get("verts", ())):
            raise RuntimeError("no in-memory mesh: save_mesh first")
        dfn = self._mesh_field()[0]
        mesh["verts"] = optimise_mesh(
            dfn, mesh["verts"], mesh["faces"], mesh["amin"], mesh["adiag"], self.device,
            n_steps=n_steps, thresh=mesh.get("thresh", 2.5), smooth_amount=smooth_amount,
            density_amount=density_amount, inflate_amount=inflate_amount)
        return mesh["verts"]

    def calculate_iou(self, resolution: int = 64, n_chunks: int = 8, seed: int = 0) -> float:
        """SDF mode: the field's sign agreement with the mesh on jittered
        grid points (SdfEngine.calculate_iou)."""
        if not isinstance(self.engine, SdfEngine):
            raise RuntimeError("calculate_iou is an SDF-mode operation")
        return self.engine.calculate_iou(self.state, resolution, n_chunks, seed)


def _single_network_engine(mode: TestbedMode, scene: Path, cfg: dict, device, seed: int,
                           engine_kwargs: dict):
    """The image, SDF or volume engine of a scene file and its fresh state."""
    if mode == TestbedMode.IMAGE:
        img = load_image(scene, as_float_linear=scene.suffix.lower() == ".exr")
        eng = ImageEngine.create(cfg, img, device=device, **engine_kwargs)
        params, opt = eng.init(seed)
        return eng, {"params": params, "opt": opt}
    if mode == TestbedMode.SDF:
        tri = load_mesh(scene)
        if len(tri) == 0:
            raise ValueError(f"{scene}: the mesh has no triangles")
        tri = normalize_to_unit_cube(tri, scale_margin=0.9)
        eng = SdfEngine.create(cfg, tri, device=device, **engine_kwargs)
    else:
        eng = VolumeEngine.create(cfg, read_nanovdb(scene), device=device, **engine_kwargs)
    return eng, eng.init(seed)


def engine_from_snapshot(payload: dict, path, device):
    """The engine and state of a decoded native training snapshot ->
    (engine, state).  The engine is built from the snapshot's network config
    and meta["aabb_scale"] (a one-cascade occupancy grid means 1), with the
    extra dims and learners of the state's leaves; a table or occupancy
    grid that does not fit it raises."""
    meta = payload.get("meta", {})
    n_casc = int(np.asarray(payload["state"]["occ"]["bitfield"]).shape[0])
    if "aabb_scale" in meta:
        aabb_scale = float(meta["aabb_scale"])
    elif n_casc == 1:
        aabb_scale = 1.0
    else:
        raise ValueError(f"{path}: the snapshot's meta has no aabb_scale and its occupancy "
                         f"grid has {n_casc} cascades; the scale cannot be told")
    extra = payload["state"]["params"].get("extra_dims")
    ds = dataclasses.replace(NerfDataset.placeholder(aabb_scale), n_extra_learnable_dims=0
                             if extra is None else int(np.asarray(extra).shape[1]))
    eng = NerfEngine.create(payload.get("config") or {}, ds,
                            grid_size=int(np.asarray(payload["state"]["occ"]["bitfield"]).shape[1]),
                            device=device)
    state = train_state_from_jax(payload["state"], device)
    _check_state_fits(eng, state, path)
    _restore_trainer_meta(eng, meta)
    _restore_learners(eng, state["params"])
    return eng, state


def _restore_learners(eng: NerfEngine, params: dict) -> None:
    """Turn on the engine's learners whose leaves a restored state holds."""
    for leaf, flag in (("cam", "optimize_extrinsics"), ("focal", "optimize_focal"),
                       ("exposure", "optimize_exposure"), ("envmap", "train_envmap")):
        if leaf in params:
            setattr(eng, flag, True)
    if "distortion" in params:
        eng.optimize_distortion = True
        eng.distortion_resolution = int(params["distortion"].shape[0])
    if "envmap" in params:
        eng.envmap_resolution = tuple(int(x) for x in params["envmap"].shape[:2])


def _restore_trainer_meta(eng: NerfEngine, meta: dict) -> None:
    """The trainer's phase and measured samples a ray, as saved."""
    if "train_phase" in meta:
        eng._phase = meta["train_phase"]
    if meta.get("mean_samples"):
        eng._mean_samples = float(meta["mean_samples"])


def _check_state_fits(eng: NerfEngine, state: dict, path) -> None:
    """Raise when a snapshot's hash table or occupancy grid does not fit the
    engine (a mismatched table would render fog, not fail)."""
    grids, tables = eng.net.grid, state["params"].get("grid")
    if not isinstance(grids, tuple):  # one 3-D grid, or the triplane's three
        grids, tables = (grids,), (tables,)
    if len(grids) != len(tables):
        raise ValueError(f"{path}: {len(tables)} hash tables for {len(grids)} grids")
    for grid, table in zip(grids, tables):
        if grid is None or table is None:
            continue
        want = grid.n_levels * grid.table_size * grid.n_features_per_level \
            * ((1 << grid.n_dims) if grid.layout == "cell" else 1)
        if table.numel() != want or table.shape[0] != grid.n_levels:
            raise ValueError(
                f"{path}: the hash table {tuple(table.shape)} does not fit the network "
                f"config ({grid.n_levels} levels, 2^{grid.log2_hashmap_size} rows, "
                f"{grid.n_features_per_level} features)")
    n_casc, g = (int(x) for x in state["occ"]["bitfield"].shape[:2])
    if (n_casc, g) != (eng.occ.n_cascades, eng.occ.grid_size):
        raise ValueError(f"{path}: the occupancy grid has {n_casc} cascades of {g}^3 cells, "
                         f"the engine {eng.occ.n_cascades} of {eng.occ.grid_size}^3")
