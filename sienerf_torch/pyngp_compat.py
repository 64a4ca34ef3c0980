"""A pyngp-shaped layer over Session (port of the JAX package's
pyngp_compat.py): scripts written against `import pyngp as ngp` switch
with `from sienerf_torch import pyngp_compat as ngp`.  Testbed runs on the
card unless it is built with device="cpu"."""

from __future__ import annotations

import json
import tempfile

import numpy as np
import torch

from sienerf_torch.common import (  # noqa: F401  (re-exported enums)
    NERF_SCALE,
    ColorSpace,
    LensMode,
    MeshSdfMode,
    NerfActivation,
    RenderMode,
    TestbedMode,
    TonemapCurve,
)
from sienerf_torch.io.image_io import save_image
from sienerf_torch.io.nerf_dataset import nerf_matrix_to_ngp, ngp_matrix_to_nerf
from sienerf_torch.ops.meshing import extract_mesh
from sienerf_torch.ops.optim import tree_leaves
from sienerf_torch.session import Session, mode_from_scene  # noqa: F401 (module parity)


def free_temporary_memory():
    """Release the caching allocator's unused blocks on the card (the
    reference frees its CUDA workspace arena here)."""
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


class Testbed:
    """ngp.Testbed(mode): load_training_data, frame, render, screenshot,
    the training-view camera bindings, snapshots, marching-cubes meshes and
    the mode metrics, over one Session on `device`."""

    def __init__(self, mode: TestbedMode | str = TestbedMode.NONE,
                 device: str | torch.device = "cuda"):
        self.session = Session(device=device)
        self.mode = TestbedMode(mode) if isinstance(mode, str) else mode
        self.shall_train = True
        self.batch_size = 1 << 18
        self.background_color = np.array([0.0, 0.0, 0.0, 1.0], np.float32)
        # the current camera (the reference's m_camera): render and
        # screenshot use it when no camera is passed
        self.camera_matrix = None
        self._view_idx = 0

    # -- data and network ---------------------------------------------------
    def load_training_data(self, path: str, **kw):
        self.session.load_file(path, **kw)
        self.mode = self.session.mode

    load_file = load_training_data

    def reload_network_from_file(self, path: str = ""):
        """Start the network and its training state afresh from a config
        file (or the mode's default), keeping the loaded scene."""
        self.session.reload_network_from_file(path or None)
        self.mode = self.session.mode

    def reload_network_from_json(self, config, config_base_path: str = ""):
        """The same from a config given as a dict or a JSON string."""
        cfg = json.loads(config) if isinstance(config, str) else config
        with tempfile.NamedTemporaryFile("w", suffix=".json", dir=config_base_path or None,
                                         delete=False) as fh:
            json.dump(cfg, fh)
            tmp = fh.name
        self.session.reload_network_from_file(tmp)
        self.mode = self.session.mode

    def n_params(self) -> int:
        return sum(int(x.numel()) for x in tree_leaves(self.session.state["params"]))

    def n_encoding_params(self) -> int:
        p = self.session.state["params"]
        enc = {k: v for k, v in p.items() if "grid" in k or "encoding" in k}
        return sum(int(x.numel()) for x in tree_leaves(enc))

    # -- the training loop ----------------------------------------------------
    def frame(self) -> bool:
        """One frame of the reference's loop: a training bundle when
        shall_train."""
        if self.shall_train and self.session.engine is not None:
            self.session.train(getattr(self.session.engine, "grid_interval", 16),
                               log_every=1 << 30)
        return True

    @property
    def loss(self) -> float:
        return self.session.loss

    @property
    def training_step(self) -> int:
        return self.session.training_step

    @property
    def rendering_extra_dims_from_training_view(self) -> int:
        """The training view whose extra dims (latent appearance) frames
        render with."""
        return int(self.session.rendering_extra_dims_from_training_view)

    @rendering_extra_dims_from_training_view.setter
    def rendering_extra_dims_from_training_view(self, i: int):
        self.session.rendering_extra_dims_from_training_view = int(i)

    # -- the camera -------------------------------------------------------------
    def _nerf_engine(self):
        eng = self.session.engine
        if eng is None or self.mode != TestbedMode.NERF:
            raise RuntimeError("NeRF-mode camera ops need a loaded NeRF scene")
        return eng

    def _scale_offset(self):
        ds = getattr(self.session, "dataset", None)
        return (getattr(ds, "scale", NERF_SCALE),
                getattr(ds, "offset", np.full(3, 0.5, np.float32)))

    def set_camera_to_training_view(self, i: int):
        eng = self._nerf_engine()
        i = int(i) % len(eng.xforms)
        self._view_idx = i
        self.camera_matrix = np.asarray(eng.xforms[i], np.float32)
        return i

    def first_training_view(self):
        return self.set_camera_to_training_view(0)

    def last_training_view(self):
        return self.set_camera_to_training_view(len(self._nerf_engine().xforms) - 1)

    def next_training_view(self):
        return self.set_camera_to_training_view(self._view_idx + 1)

    def previous_training_view(self):
        return self.set_camera_to_training_view(self._view_idx - 1)

    def find_closest_training_view(self) -> int:
        """The training view whose origin is nearest the current camera's."""
        eng = self._nerf_engine()
        if self.camera_matrix is None:
            return 0
        pos = np.asarray(self.camera_matrix, np.float32)[:, 3]
        d = np.linalg.norm(np.asarray(eng.xforms)[:, :, 3] - pos[None], axis=1)
        return int(np.argmin(d))

    def set_nerf_camera_matrix(self, m):
        """Set the current camera from a NeRF-convention (3|4, 4) matrix,
        through the dataset's scale and offset and the axis cycling."""
        ds = getattr(self.session, "dataset", None)
        scale, offset = getattr(ds, "scale", None), getattr(ds, "offset", None)
        if scale is None:
            scale, offset = NERF_SCALE, np.full(3, 0.5, np.float32)
        self.camera_matrix = nerf_matrix_to_ngp(np.asarray(m, np.float32), scale, offset)

    def get_camera_extrinsics(self, i: int, convert_to_nerf: bool = True):
        """Training view i's camera, in the NeRF convention by default."""
        m = np.asarray(self._nerf_engine().xforms[int(i)], np.float32)
        if not convert_to_nerf:
            return m
        return ngp_matrix_to_nerf(m, *self._scale_offset())

    def set_camera_extrinsics(self, i: int, m, convert_from_nerf: bool = True):
        """Overwrite training view i's camera, in the engine's host copy and
        in its device copy of the training cameras."""
        eng = self._nerf_engine()
        m = np.asarray(m, np.float32)
        if convert_from_nerf:
            m = nerf_matrix_to_ngp(m, *self._scale_offset())
        xf = np.array(eng.xforms)
        xf[int(i)] = m
        eng.xforms = xf
        eng.data["xforms"] = torch.from_numpy(xf.astype(np.float32)).to(eng.device)

    # -- rendering -----------------------------------------------------------------
    def render(self, width: int, height: int, spp: int = 1, linear: bool = True, **kw):
        """Session.render -> (H, W, 4) f32 numpy; a NeRF scene renders from
        the current camera when one is set and none is passed."""
        if self.camera_matrix is not None and "camera_matrix" not in kw \
                and self.mode == TestbedMode.NERF:
            eng = self.session.engine
            kw["camera_matrix"] = self.camera_matrix
            kw.setdefault("focal", tuple(np.asarray(eng.focals[self._view_idx]) * width
                                         / eng.resolution[0]))
        return self.session.render(width, height, spp=spp, **kw).cpu().numpy()

    def screenshot(self, path: str, width: int = 1920, height: int = 1080, **kw):
        save_image(path, self.render(width, height, **kw), input_is_linear=False)

    # -- snapshots ---------------------------------------------------------------------
    def save_snapshot(self, path: str, *_args):
        self.session.save_snapshot(path)

    def load_snapshot(self, path: str):
        self.session.load_snapshot(path)
        self.mode = self.session.mode

    # -- meshes ---------------------------------------------------------------------------
    def compute_and_save_marching_cubes_mesh(self, path: str, resolution=(256, 256, 256),
                                             thresh: float = 2.5, **kw):
        res = resolution[0] if hasattr(resolution, "__len__") else int(resolution)
        self.session.save_mesh(path, resolution=res, thresh=thresh)

    def compute_marching_cubes_mesh(self, resolution=(256, 256, 256), thresh: float = 2.5):
        """The field's marching-cubes mesh in memory -> {"V", "F"} (NeRF: its
        density at `thresh`; SDF: the zero level), kept for
        optimise_mesh_step."""
        res = resolution[0] if hasattr(resolution, "__len__") else int(resolution)
        sess = self.session
        dfn, iso, amin, adiag = sess._mesh_field(thresh)
        verts, faces, colors = extract_mesh(dfn, res, amin, adiag, sess.device, iso=iso)
        out = {"V": verts, "F": faces}
        if colors is not None:
            out["C"] = colors
        sess.mesh = {"verts": verts, "faces": faces, "thresh": iso, "amin": amin,
                     "adiag": adiag}
        return out

    def optimise_mesh_step(self, n_steps: int = 1):
        """Move the in-memory mesh toward the field's iso-surface
        (compute_marching_cubes_mesh first)."""
        return self.session.optimise_mesh_step(n_steps)

    # -- metrics -------------------------------------------------------------------------
    def compute_image_mse(self, quantize: bool = False) -> float:
        if self.mode != TestbedMode.IMAGE:
            raise RuntimeError("compute_image_mse is image-mode only")
        return self.session.engine.compute_mse(self.session.state["params"],
                                               self.session.state["opt"],
                                               quantize_to_byte=quantize)

    def calculate_iou(self, n_samples: int = 128 ** 3, scale_existing_results_factor: float = 0.0,
                      blocking: bool = True, force_use_octree: bool = True) -> float:
        """SDF mode: the IoU against the mesh at the grid resolution of
        about n_samples points."""
        if self.mode != TestbedMode.SDF:
            raise RuntimeError("calculate_iou is SDF-mode only")
        res = max(16, int(round(float(n_samples) ** (1.0 / 3.0))))
        return float(self.session.calculate_iou(resolution=res))
