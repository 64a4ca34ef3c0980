"""Shared enums and constants (port of the JAX package's common.py, the subset the
ported paths read).  Values are identical so snapshots and configs mean the
same thing in both packages."""

from __future__ import annotations

import enum
import math


class TestbedMode(enum.Enum):
    """Workload modes."""

    NONE = "none"
    NERF = "nerf"
    SDF = "sdf"
    IMAGE = "image"
    VOLUME = "volume"
    GEOMETRY = "geometry"


class RenderMode(enum.Enum):
    """Render visualisation modes (the pyngp surface re-exports them)."""

    AO = "ao"
    SHADE = "shade"
    NORMALS = "normals"
    POSITIONS = "positions"
    DEPTH = "depth"
    DISTANCE = "distance"
    STEPGRID = "stepgrid"
    DISTORTION = "distortion"
    COST = "cost"
    SLICE = "slice"
    SHADE_NERF = "shade_nerf"
    SHADE_ENVMAP = "shade_envmap"
    SHADE_GRID_ENVMAP = "shade_grid_envmap"


class NerfActivation(enum.Enum):
    """Output activations applied outside the network."""

    NONE = "none"
    RELU = "relu"
    LOGISTIC = "logistic"
    EXPONENTIAL = "exponential"


class LensMode(enum.Enum):
    """Camera lens models."""

    PERSPECTIVE = "perspective"
    OPENCV = "opencv"
    FTHETA = "ftheta"
    LATLONG = "latlong"
    OPENCV_FISHEYE = "opencv_fisheye"
    EQUIRECTANGULAR = "equirectangular"


class MeshSdfMode(enum.Enum):
    """Ground-truth signed-distance modes of SDF training."""

    WATERTIGHT = "watertight"
    RAYSTAB = "raystab"
    PATH_ESCAPE = "path_escape"


class TonemapCurve(enum.Enum):
    IDENTITY = "identity"
    ACES = "aces"
    HABLE = "hable"
    REINHARD = "reinhard"


class ColorSpace(enum.Enum):
    LINEAR = "linear"
    SRGB = "srgb"


NERF_GRIDSIZE = 128
NERF_CASCADES = 8
NERF_STEPS = 1024  # finest number of steps per unit length
SQRT3 = math.sqrt(3.0)
STEPSIZE = SQRT3 / NERF_STEPS
MIN_CONE_STEPSIZE = STEPSIZE
# the largest step is the width of the coarsest occupancy-grid cell
MAX_CONE_STEPSIZE = STEPSIZE * (1 << (NERF_CASCADES - 1)) * NERF_STEPS / NERF_GRIDSIZE
NERF_RENDERING_NEAR_DISTANCE = 0.05
# the NeRF datasets' default scale of world units onto the unit cube
NERF_SCALE = 0.33
NERF_MIN_OPTICAL_THICKNESS = 0.01
