"""Session façade for the render paths (port of the render-only part of
the JAX package's session.py::Session): load a render-only snapshot, render
it live (the streaming ray-marched renderer), or bake it and render
slab-sweep frames."""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from sienerf_torch.engines.nerf import NerfEngine
from sienerf_torch.io.nerf_dataset import NerfDataset
from sienerf_torch.io.snapshot import (
    grid_config_for_snapshot,
    load_snapshot,
    render_snapshot_from_payload,
)
from sienerf_torch.ops.samplers import ld_pixel_offset
from sienerf_torch.utils.config import default_configs_dir, load_network_config


class Session:
    """One engine, its render-only state and the cached bake, on `device`."""

    def __init__(self, configs_dir: str | Path | None = None,
                 device: str | torch.device = "cuda"):
        self.configs_dir = Path(configs_dir) if configs_dir else default_configs_dir()
        self.device = torch.device(device)
        self.engine: NerfEngine | None = None
        self.state: dict | None = None
        self.network_config: dict = {}
        self.training_step = 0
        self._baked = None

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
        self.state = {"params": params, "occ": {"bitfield": bitfield},
                      "step": smeta["step"]}
        self.training_step = smeta["step"]
        return payload

    def bake(self, resolution: int = 256, mode: str = "nearest", row_bits: int = 16):
        """Bake the loaded field into the render-side row table; cached until
        the next bake() or load."""
        if self.engine is None:
            raise RuntimeError("load_snapshot first")
        self._baked = self.engine.bake_features(
            self.state["params"], self.state["occ"], resolution=resolution,
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
            raise RuntimeError("load_snapshot first")
        eng = self.engine
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
                    eng, self.state["params"], grid, meta, cam, focal, width=width,
                    height=height, pixel_offset=off,
                    axis_phase=np.float32((i + 0.5) / spp) if spp > 1 else None,
                    packed=True, **kw)
                rgba = out5[:4].permute(1, 2, 0)
            else:
                rgba, _ = eng.render_frame(
                    self.state["params"], self.state["occ"]["bitfield"], width, height,
                    cam, focal, pixel_offset=off, **kw)
            a = rgba.double()
            acc = a if acc is None else acc + a
        return (acc / spp).float()
