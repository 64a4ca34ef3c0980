"""Session façade (port of the NeRF parts of the JAX package's
session.py::Session): load a NeRF scene and train it, or load a
render-only snapshot; render live (the streaming ray-marched renderer), or
bake and render slab-sweep frames.  A trained session renders and bakes
from the optimizer's EMA shadow of the params."""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from sienerf_torch.engines.nerf import NerfEngine
from sienerf_torch.io.nerf_dataset import NerfDataset, load_nerf_dataset
from sienerf_torch.io.snapshot import (
    grid_config_for_snapshot,
    load_snapshot,
    render_snapshot_from_payload,
)
from sienerf_torch.ops.optim import inference_params
from sienerf_torch.ops.samplers import ld_pixel_offset
from sienerf_torch.utils.config import default_configs_dir, load_network_config


def _is_nerf_scene(path: Path) -> bool:
    """A NeRF scene is a directory holding transforms*.json, or a .json
    file of one."""
    if path.is_dir():
        return any(path.glob("transforms*.json"))
    return path.suffix.lower() == ".json" and "geometry" not in path.name.lower()


class Session:
    """One engine, its state (training or render-only) and the cached bake,
    on `device`.  Training draws from a generator seeded with `seed`."""

    def __init__(self, configs_dir: str | Path | None = None, seed: int = 1337,
                 device: str | torch.device = "cuda"):
        self.configs_dir = Path(configs_dir) if configs_dir else default_configs_dir()
        self.device = torch.device(device)
        self.seed = seed
        self.engine: NerfEngine | None = None
        self.state: dict | None = None
        self.network_config: dict = {}
        self.training_step = 0
        self.loss = float("nan")
        self.loss_graph: list[float] = []
        self._baked = None
        self._generator: torch.Generator | None = None

    def load_file(self, scene: str | Path, network: str | Path | None = None,
                  **engine_kwargs):
        """Load a NeRF scene (a directory holding transforms.json, or the
        file) with the network config `network` (configs/nerf/base.json by
        default) and start a fresh training state.  Dataset options:
        downscale, max_images, split; engine options: train_batch_size,
        grid_size, train_k.  Other modes (image, SDF, volume, geometry) are
        not ported yet."""
        scene = Path(scene)
        if not _is_nerf_scene(scene):
            raise NotImplementedError(
                f"{scene}: only NeRF scenes (transforms.json) are ported yet; image, SDF, "
                "volume and geometry modes are Slice F of ROADMAP.md")
        self._baked = None
        self.training_step = 0
        self.loss = float("nan")
        self.loss_graph = []
        cfg_path = Path(network) if network else self.configs_dir / "nerf" / "base.json"
        self.network_config = load_network_config(cfg_path)
        ds = load_nerf_dataset(scene, **{k: v for k, v in engine_kwargs.items()
                                         if k in ("downscale", "max_images", "split")})
        ekw = {k: v for k, v in engine_kwargs.items()
               if k in ("train_batch_size", "grid_size", "train_k")}
        self.engine = NerfEngine.create(self.network_config, ds, device=self.device, **ekw)
        self.state = self.engine.init(self.seed)
        self.dataset = ds
        self._generator = torch.Generator(device=self.device).manual_seed(self.seed)
        return self

    def train(self, n_steps: int) -> float:
        """Train in bundles of engine.grid_interval steps until at least
        n_steps have run -> the last bundle's mean loss."""
        if self.engine is None:
            raise RuntimeError("load_file first")
        if not self.state.get("opt"):
            raise RuntimeError("cannot train from a render-only snapshot "
                               "(no optimizer state)")
        done = 0
        while done < n_steps:
            self.state, loss, _ = self.engine.train_bundle(self.state, self._generator)
            self.loss = float(loss)
            self.loss_graph.append(self.loss)
            done += self.engine.grid_interval
            self.training_step += self.engine.grid_interval
            self._baked = None  # a bake is of the params it was made from
        return self.loss

    def render_params(self) -> dict:
        """The params bake() and render() read: the EMA shadow when the
        state has optimizer state, else (a render-only snapshot) its
        params."""
        opt = self.state.get("opt")
        return inference_params(opt, self.state["params"]) if opt else self.state["params"]

    def load_snapshot(self, path: str | Path):
        """Load a render-only snapshot and build its engine.

        The aabb_scale is 2^(cascades - 1) of the snapshot's occupancy
        bitfield; the network config is configs/nerf/base.json with its hash
        grid sized from the snapshot's grid_shape, and the snapshot is
        checked against both."""
        self._baked = None
        payload = load_snapshot(path)
        meta = payload.get("meta", {})
        if not str(meta.get("kind", "")).startswith("render_only"):
            raise NotImplementedError("only render-only snapshots are ported yet")
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

    def bake(self, resolution: int = 256, mode: str = "nearest", row_bits: int = 16):
        """Bake the loaded field into the render-side row table; cached until
        the next bake() or load."""
        if self.engine is None:
            raise RuntimeError("load a scene or a snapshot first")
        self._baked = self.engine.bake_features(
            self.render_params(), self.state["occ"], resolution=resolution,
            mode=mode, row_bits=row_bits)
        return self._baked

    @torch.no_grad()
    def render(self, width: int, height: int, camera_matrix=None, focal=None,
               spp: int = 1, renderer: str = "sweep", **kw) -> torch.Tensor:
        """Offscreen render -> (H, W, 4) f32 rgba tensor on the session's
        device.  renderer "sweep" (the default here; the JAX package's
        default is "live") composites the baked lattice, "live" ray-marches
        the field itself.  spp > 1 averages passes in float64, each with a
        low-discrepancy subpixel offset; the sweep adds a stratified
        slab-phase jitter."""
        if renderer == "baked":
            raise NotImplementedError(
                'renderer "baked" (the baked gather renderer) is not ported yet; '
                "it comes with Slice E of ROADMAP.md, the rest of ops/baked.py")
        if renderer not in ("sweep", "live"):
            raise ValueError(f"unknown renderer {renderer!r}")
        if self.engine is None:
            raise RuntimeError("load a scene or a snapshot first")
        eng = self.engine
        params = self.render_params()
        if camera_matrix is None:
            camera_matrix = eng.xforms[0]
            focal = tuple(np.asarray(eng.focals[0]) * width / eng.resolution[0])
            kw.setdefault("screen_center", tuple(np.asarray(eng.principal_points[0])))
        cam = np.asarray(camera_matrix, np.float32)
        focal = tuple(np.asarray(focal, np.float32))
        bake_res = kw.pop("bake_resolution", 256)
        bake_mode = kw.pop("bake_mode", "nearest")
        if renderer == "sweep" and self._baked is None:
            self.bake(resolution=bake_res, mode=bake_mode)
        from sienerf_torch.engines.nerf_sweep import render_frame_sweep

        spp = max(int(spp), 1)
        acc = None
        for i in range(spp):
            off = ld_pixel_offset(i) if spp > 1 else None
            if renderer == "sweep":
                grid, meta = self._baked
                out5 = render_frame_sweep(
                    eng, params, grid, meta, cam, focal, width=width,
                    height=height, pixel_offset=off,
                    axis_phase=np.float32((i + 0.5) / spp) if spp > 1 else None,
                    packed=True, **kw)
                rgba = out5[:4].permute(1, 2, 0)
            else:
                rgba, _ = eng.render_frame(
                    params, self.state["occ"]["bitfield"], width, height,
                    cam, focal, pixel_offset=off, **kw)
            a = rgba.double()
            acc = a if acc is None else acc + a
        return (acc / spp).float()
