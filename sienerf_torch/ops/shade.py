"""K1, the per-vertex shade of the baked lattice: CUDA kernel wrapper and its
plain PyTorch version.

Port of the JAX package's ops/shade_pallas.py (the Pallas kernel) and of
the JAX package's engines/nerf_sweep.py::_shade_planes (its reference, which is
the plain version here).  Every vertex of the K*(R+1)^3 bake is decoded,
its colour MLP is run once with the vertex's own direction from the camera
(exact for primary rays), and the premultiplied [s*r, s*g, s*b, s] bf16
value is stored channel-last: the storage is (K, R+1, R+1, R+1, 4), the four
channels of a vertex side by side, and callers see it as the permuted view
(K, R+1, 4, R+1, R+1).  The kernel is `csrc/shade.cu` (the MLP on the
tensor cores): a tuned path for the fox's 32-64-64-3 colour MLP (mma.sync,
weights in "fragment" order) and a general path for any other ReLU colour
MLP the JAX kernel takes, 0 or more hidden layers of one width: a
warp-specialised wgmma kernel up to width 256 (weights in "wgmma" order; a
net without hidden layers in fragment order), and for the nets it cannot
hold (wider, or weights that leave it no room) a wide kernel that runs the
layers through shared tiles (fragment order); the source notes give the
designs and the bounds.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from sienerf_torch.common import NerfActivation
from sienerf_torch.models.nerf_network import (
    apply_density_activation,
    apply_rgb_activation,
)
from sienerf_torch.ops import cuda_lib
from sienerf_torch.ops.baked import _decode_rows
from sienerf_torch.ops.encodings import sh_encode
from sienerf_torch.ops.mlp import MLPConfig, mlp_apply

_ACT_CODE = {NerfActivation.NONE: 0, NerfActivation.RELU: 1,
             NerfActivation.LOGISTIC: 2, NerfActivation.EXPONENTIAL: 3}
# the colour MLP of the tuned kernel (the fox's): [SH16; raw16] -> 64 -> 64
# -> 3, ReLU; every other ReLU colour MLP takes the kernel's general path
KERNEL_RGB_MLP = MLPConfig(n_input_dims=32, n_output_dims=3, n_neurons=64,
                           n_hidden_layers=2, activation="ReLU",
                           output_activation="None")
_TUNED_SHAPES = ((32, 64), (64, 64), (64, 3))
# planes per step of the plain shade (~1 M vertices at R=256)
_PLANE_CHUNK = 16
_MAX_CASCADES = 8  # the kernel keeps the (K, 16) scales in shared memory


def _pad16(n: int) -> int:
    return -(-n // 16) * 16


def shade_mlp_layout(shapes) -> tuple[int, int]:
    """(hidden layers, padded hidden width) of a colour MLP the kernel
    takes: a 32-wide input, any number of hidden layers of one width (each
    layer's input padded to the previous layer's padded output, as the JAX
    kernel pads its transposed weights), 3 outputs.  The width pads to a
    multiple of 16 (a pair of n8 tiles); with no hidden layer it is 32, the
    input's.  Raises for any other shape list."""
    shapes = tuple(tuple(int(d) for d in sh) for sh in shapes)
    ok = len(shapes) >= 1 and shapes[0][0] == 32 and shapes[-1][1] == 3 \
        and all(len(sh) == 2 for sh in shapes) \
        and all(a[1] == b[0] for a, b in zip(shapes, shapes[1:]))
    hidden = shapes[:-1]
    if ok and hidden:
        ok = all(sh[1] == hidden[0][1] for sh in hidden)
    if not ok:
        raise ValueError(f"shade kernel: the colour MLP must be 32 -> (W ->)* 3 with one "
                         f"hidden width W, got {list(shapes)}")
    return len(hidden), (_pad16(hidden[0][1]) if hidden else 32)


def mlp_for_weights(rgb_weights) -> MLPConfig:
    """The ReLU colour-MLP config of a weight list (what the kernel runs)."""
    n_hidden, _ = shade_mlp_layout([w.shape for w in rgb_weights])
    return MLPConfig(n_input_dims=32, n_output_dims=3,
                     n_neurons=int(rgb_weights[0].shape[1]) if n_hidden else 64,
                     n_hidden_layers=n_hidden, activation="ReLU", output_activation="None")


# the general kernel's weight descriptors (csrc/shade.cu GEN_LBO, GEN_SBO):
# a layer is k16 steps of 8-output groups of two 8 x 8 core matrices (the
# two halves of the step's 16 inputs, LBO bytes apart; successive groups SBO
# bytes apart), each core matrix 8 outputs x 8 inputs, inputs contiguous
WGMMA_LBO, WGMMA_SBO = 128, 256
LAYOUTS = ("fragment", "wgmma")


def _kernel_layout(n_hidden: int, path: str) -> str:
    """The weight layout a path reads: the general kernel's wgmma
    descriptors, or fragments for the tuned and wide kernels and for a net
    without hidden layers (the general kernel's producer warps run its one
    layer with mma.sync)."""
    return "wgmma" if path == "general" and n_hidden else "fragment"


def general_width(width: int) -> int:
    """The general kernel's padded hidden width for a padded width
    (shade_mlp_layout's): 64, 128 or 256, the widths it is built for (zero
    weights pad the rest, the same function).  Raises above 256, wgmma's
    widest product."""
    for w in (64, 128, 256):
        if width <= w:
            return w
    raise ValueError(f"shade kernel: hidden widths above 256 are not taken, got {width}")


def _layer_dims(shapes, layout: str):
    """(input rows, output columns) of each packed layer: the inputs padded
    to the previous layer's padded output (32 for the first), the hidden
    outputs to the layout's width, the output layer's to one n8 tile."""
    n_hidden, width = shade_mlp_layout(shapes)
    if layout == "wgmma" and n_hidden:
        width = general_width(width)
    ks = [32] + [width] * n_hidden
    return [(ks[i], width if i < n_hidden else 8) for i in range(n_hidden + 1)]


@functools.lru_cache(maxsize=32)
def _pack_index(shapes: tuple, device: torch.device, layout: str = "fragment") -> torch.Tensor:
    """For every bf16 value of the packed weights, its position in
    cat([W.flatten() for each layer] + [[0]]), as an index tensor on
    `device` (built once per shape list, device and layout): the last slot
    is the zero that pads each layer's input to the previous layer's padded
    output, a hidden width to the layout's and the output layer from 3 to 8
    outputs.

    "fragment" (the tuned kernel's) is the B-fragment order of
    mma.m16n8k16 (B is k x n, "col"): lane l = 4g + t of the (k16 tile kt,
    n8 tile nt) fragment holds B[16kt + 2t + {0, 1}, 8nt + g] and B[16kt +
    2t + 8 + {0, 1}, 8nt + g].  A hidden layer stores n8 tiles in pairs, so
    a lane's 8 values (16 bytes) feed two mma instructions; the output layer
    is k16 tiles of 32 lanes x 4.

    "wgmma" (the general kernel's) is K-major core matrices for wgmma's
    shared-memory descriptors: value (k, n) of a layer with N padded
    outputs sits at [k // 16][n // 8][(k % 16) // 8][n % 8][k % 8], so
    k16 step kt starts kt * (N / 8) * 256 bytes in, the two 8-input halves
    of a step lie WGMMA_LBO bytes apart and the 8-output groups WGMMA_SBO."""
    lane = torch.arange(32)
    g, t = lane // 4, lane % 4
    zero = sum(a * b for a, b in shapes)
    parts, base = [], 0
    for (k_pad, n_pad), (n_in, n_out) in zip(_layer_dims(shapes, layout), shapes):
        if layout == "wgmma":
            kt, ng, kh, nn, kk = torch.meshgrid(
                torch.arange(k_pad // 16), torch.arange(n_pad // 8), torch.arange(2),
                torch.arange(8), torch.arange(8), indexing="ij")
            k, n = 16 * kt + 8 * kh + kk, 8 * ng + nn
        elif n_pad == 8:  # the output layer: one n8 tile a k16 tile
            koff = torch.stack([2 * t, 2 * t + 1, 2 * t + 8, 2 * t + 9], dim=1)  # (32, 4)
            k = 16 * torch.arange(k_pad // 16)[:, None, None] + koff[None]
            n = g[None, :, None].expand(k.shape)
        else:
            koff = torch.stack([2 * t, 2 * t + 1, 2 * t + 8, 2 * t + 9], dim=1)
            kt = torch.arange(k_pad // 16)[:, None, None, None, None]
            npair = torch.arange(n_pad // 16)[None, :, None, None, None]
            half = torch.arange(2)[None, None, None, :, None]
            k = 16 * kt + koff[None, None, :, None, :]
            n = 16 * npair + 8 * half + g[None, None, :, None, None]
        idx = torch.where((k < n_in) & (n < n_out), base + k * n_out + n, zero)
        parts.append(idx.reshape(-1))
        base += n_in * n_out
    return torch.cat(parts).to(device)


def pack_shade_weights(rgb_weights, layout: str = "fragment") -> torch.Tensor:
    """Colour-MLP weights [(32, W), (W, W)..., (W, 3)] -> a kernel's bf16
    weight buffer in `layout` (see _pack_index): "fragment" for the tuned
    kernel ((6656,), 13,312 bytes, for the fox's 32-64-64-3), "wgmma" for
    the general kernel."""
    if layout not in LAYOUTS:
        raise ValueError(f"pack_shade_weights: layout must be one of {LAYOUTS}, got {layout!r}")
    dev = rgb_weights[0].device
    shapes = tuple(tuple(w.shape) for w in rgb_weights)
    flat = torch.cat([w.to(torch.bfloat16).reshape(-1) for w in rgb_weights]
                     + [torch.zeros(1, dtype=torch.bfloat16, device=dev)])
    return flat[_pack_index(shapes, dev, layout)].contiguous()


# the weights last packed for each layout and their versions: a frame loop
# shades with the same tensors every time
_packed: dict = {layout: {"weights": (), "versions": (), "buffer": None} for layout in LAYOUTS}


def _packed_for(rgb_weights, device: torch.device, layout: str = "fragment") -> torch.Tensor:
    """pack_shade_weights on `device` in `layout`, done again only when the
    weight tensors are other objects than last time, were written in place
    since, or were packed for another device."""
    cache = _packed[layout]
    versions = tuple(w._version for w in rgb_weights)
    same = (len(cache["weights"]) == len(rgb_weights)
            and all(a is b for a, b in zip(cache["weights"], rgb_weights))
            and cache["versions"] == versions
            and cache["buffer"].device == device)
    if not same:
        cache.update(weights=tuple(rgb_weights), versions=versions,
                     buffer=pack_shade_weights([w.to(device) for w in rgb_weights], layout))
    return cache["buffer"]


def unpack_shade_weights(packed: torch.Tensor, shapes=_TUNED_SHAPES,
                         layout: str = "fragment") -> list[torch.Tensor]:
    """The inverse of pack_shade_weights for weights of `shapes` -> bf16."""
    shapes = tuple(tuple(sh) for sh in shapes)
    idx = _pack_index(shapes, packed.device, layout)
    sizes = [a * b for a, b in shapes]
    flat = torch.zeros(sum(sizes) + 1, dtype=packed.dtype, device=packed.device)
    flat[idx] = packed
    return [w.reshape(sh) for w, sh in zip(flat[:-1].split(sizes), shapes)]


@torch.no_grad()
def shade_planes(planes: torch.Tensor, casc: torch.Tensor, iplane: torch.Tensor,
                 scale: torch.Tensor, cam_origin: torch.Tensor,
                 rgb_weights, rgb_mlp: MLPConfig, *, resolution: int,
                 density_act: NerfActivation, rgb_act: NerfActivation,
                 sh_degree: int = 4, extra: torch.Tensor | None = None) -> torch.Tensor:
    """Plain version: shade a stack of vertex planes, (P, (R+1)^2, F) int
    rows of cascade `casc` (P,) and lattice plane `iplane` (P,) ->
    (P, (R+1)^2, 4) bf16 premultiplied rgba, _PLANE_CHUNK planes at a time.
    `extra` (E,), one row of extra dims for every vertex, goes between the
    SH block and the features, as in the network (K1 takes none)."""
    R = resolution
    Rv = R + 1
    dev = planes.device
    jj = (torch.arange(Rv * Rv, device=dev) // Rv).float()
    kk = (torch.arange(Rv * Rv, device=dev) % Rv).float()
    out = torch.empty((planes.shape[0], Rv * Rv, 4), dtype=torch.bfloat16, device=dev)
    for p0 in range(0, planes.shape[0], _PLANE_CHUNK):
        pl = planes[p0:p0 + _PLANE_CHUNK]
        n = pl.shape[0]
        rows = pl.reshape(n * Rv * Rv, pl.shape[-1])
        m_r = casc[p0:p0 + n].repeat_interleave(Rv * Rv)
        i_r = iplane[p0:p0 + n].repeat_interleave(Rv * Rv).float()
        side = torch.exp2(m_r.float())
        lo = 0.5 - 0.5 * side
        ijk = torch.stack([i_r, jj.repeat(n), kk.repeat(n)], dim=-1)
        pos = ijk / R * side[:, None] + lo[:, None]
        raw, sent = _decode_rows(rows, scale[m_r])
        dens = torch.where(sent, 0.0, apply_density_activation(raw[:, 0], density_act))
        dvec = pos - cam_origin
        dvec = dvec / torch.clamp(torch.sqrt((dvec * dvec).sum(-1, keepdim=True)), min=1e-6)
        sh = sh_encode((dvec + 1.0) * 0.5, sh_degree)
        parts = [sh] if extra is None else [sh, extra.expand(sh.shape[0], extra.shape[0])]
        rgb = apply_rgb_activation(
            mlp_apply(rgb_mlp, rgb_weights, torch.cat(parts + [raw], dim=-1)), rgb_act)
        rgba = torch.cat([rgb * dens[:, None], dens[:, None]], dim=-1)
        out[p0:p0 + n] = rgba.to(torch.bfloat16).reshape(n, Rv * Rv, 4)
    return out


def _plane_range(planes, resolution: int, n_cascades: int) -> tuple[int, int]:
    """The vertex planes [p0, p1) a shade covers: all K*(R+1) by default."""
    n = n_cascades * (resolution + 1)
    p0, p1 = (0, n) if planes is None else (int(planes[0]), int(planes[1]))
    if not 0 <= p0 < p1 <= n:
        raise ValueError(f"shade_volume: planes must be a range in [0, {n}), got {planes}")
    return p0, p1


def _as_volume(out: torch.Tensor, planes, n_cascades: int) -> torch.Tensor:
    """Channel-last storage (P, R+1, R+1, 4) -> the view callers see: the
    axis-0 volume (K, R+1, 4, R+1, R+1), or (P, 4, R+1, R+1) for a plane
    range."""
    if planes is None:
        Rv = out.shape[1]
        return out.reshape(n_cascades, Rv, Rv, Rv, 4).permute(0, 1, 4, 2, 3)
    return out.permute(0, 3, 1, 2)


def shade_volume_plain(rows, scale, cam_origin, rgb_weights, *, resolution: int,
                       n_cascades: int, density_act: NerfActivation,
                       rgb_act: NerfActivation, rgb_mlp: MLPConfig | None = None,
                       planes=None) -> torch.Tensor:
    """The plain version in the kernel's output layout: (K*(R+1)^3, 16) int16
    rows -> axis-0 volume (K, R+1, 4, R+1, R+1) bf16, a view of channel-last
    storage (channel stride 1), or with `planes` = (p0, p1) vertex planes
    [p0, p1) of the K*(R+1) -> (p1 - p0, 4, R+1, R+1), a view of
    (p1 - p0, R+1, R+1, 4).  `rgb_mlp` is the network's colour-MLP config
    (by default the ReLU MLP of the weights' shapes)."""
    R, K = resolution, n_cascades
    Rv = R + 1
    dev = rows.device
    p0, p1 = _plane_range(planes, R, K)
    stack = rows.reshape(K * Rv, Rv * Rv, rows.shape[-1])[p0:p1]
    plane = torch.arange(p0, p1, device=dev)
    vol = shade_planes(stack, plane // Rv, plane % Rv, scale, cam_origin, rgb_weights,
                       rgb_mlp or mlp_for_weights(rgb_weights), resolution=R,
                       density_act=density_act, rgb_act=rgb_act)
    return _as_volume(vol.reshape(p1 - p0, Rv, Rv, 4), planes, K)


def shade_volume(rows, scale, cam_origin, rgb_weights, *, resolution: int,
                 n_cascades: int, density_act: NerfActivation,
                 rgb_act: NerfActivation, rgb_mlp: MLPConfig | None = None,
                 planes=None) -> torch.Tensor:
    """K1: (K*(R+1)^3, 16) int16 rows, (K, 16) f32 scale, (3,) f32 camera
    origin, colour-MLP weights [(32, W), (W, W)..., (W, 3)] ->
    (K, R+1, 4, R+1, R+1) bf16 axis-0 volume, a view of channel-last
    storage.  With `planes` = (p0, p1) it shades vertex planes [p0, p1) of
    the K*(R+1) planes of the bake (plane p is cascade p // (R+1), lattice
    plane p % (R+1)) -> (p1 - p0, 4, R+1, R+1), a view of channel-last
    (p1 - p0, R+1, R+1, 4): those planes of the whole volume.  Launches the
    CUDA kernel for CUDA tensors: the tuned path for the fox's 32-64-64-3,
    the general path for any other ReLU colour MLP (the general kernel, or
    the wide kernel for a net it cannot hold); tensors on the CPU take the
    plain version.  Raises for an MLP the kernel does not take."""
    return _shade_volume(rows, scale, cam_origin, rgb_weights, resolution=resolution,
                         n_cascades=n_cascades, density_act=density_act, rgb_act=rgb_act,
                         rgb_mlp=rgb_mlp, planes=planes)


def _shade_general(rows, scale, cam_origin, rgb_weights, **kw) -> torch.Tensor:
    """shade_volume through the general path whatever the MLP, the fox's
    32-64-64-3 included: the checks hold it to the tuned path's bits (the
    two paths' tensor-core instructions sum alike, see mma_probe).  A net
    the general kernel cannot hold takes the wide kernel, as in
    shade_volume."""
    return _shade_volume(rows, scale, cam_origin, rgb_weights, path="general", **kw)


def _shade_wide(rows, scale, cam_origin, rgb_weights, **kw) -> torch.Tensor:
    """shade_volume through the wide kernel whatever the MLP: the general
    path's first kernel, which the checks time beside the general kernel."""
    return _shade_volume(rows, scale, cam_origin, rgb_weights, path="wide", **kw)


def _launch_config(path: str, n_words: int, width: int,
                   n_hidden: int) -> tuple[int, int, int]:
    """(warps a block, blocks an SM, dynamic shared bytes a block) of a
    launch of the general or wide kernel; 0 warps if none fits."""
    lib = cuda_lib.load("shade")
    fn = lib.shade_wide_config if path == "wide" else lib.shade_general_config
    fn.restype = ctypes.c_int
    depth = () if path == "wide" else (n_hidden,)
    fn.argtypes = [ctypes.c_int] * (2 + len(depth)) + [ctypes.POINTER(ctypes.c_int)] * 2
    smem, blocks = ctypes.c_int(0), ctypes.c_int(0)
    warps = int(fn(n_words, width, *depth, ctypes.byref(smem), ctypes.byref(blocks)))
    return warps, blocks.value, smem.value


@functools.lru_cache(maxsize=64)
def _general_fits(shapes: tuple, device_index: int) -> bool:
    """Whether the general kernel holds this net on the card: a padded
    width of at most 256 and weights that leave room for its stage ring."""
    n_hidden, width = shade_mlp_layout(shapes)
    if n_hidden and width > 256:
        return False
    with torch.cuda.device(device_index):
        return _launch_config("general", *_words_and_width(shapes, "general"), n_hidden)[0] > 0


def _words_and_width(shapes: tuple, path: str) -> tuple[int, int]:
    """(32-bit words of packed weights, the width the launch is given) of a
    net on the general or wide path."""
    n_hidden, width = shade_mlp_layout(shapes)
    layout = _kernel_layout(n_hidden, path)
    if path == "general":
        width = general_width(width) if n_hidden else 32
    return sum(k * n for k, n in _layer_dims(shapes, layout)) // 2, width


def _route(shapes: tuple, path: str, device: torch.device) -> str:
    """The kernel a net takes: the tuned one for the fox's net (unless the
    general path is asked for), else the general kernel where it holds the
    net, else the wide kernel."""
    if path == "auto" and shapes == _TUNED_SHAPES:
        return "tuned"
    if path == "wide" or not _general_fits(shapes, device.index or 0):
        return "wide"
    return "general"


def _shade_volume(rows, scale, cam_origin, rgb_weights, *, resolution: int,
                  n_cascades: int, density_act: NerfActivation,
                  rgb_act: NerfActivation, rgb_mlp: MLPConfig | None = None,
                  path: str = "auto", stall_ns: int = 0, planes=None) -> torch.Tensor:
    """shade_volume on the kernel `path` asks for ("auto", "general" or
    "wide", see _route).  stall_ns > 0 has the general kernel's producer
    warp 0 write its rows late, so that its stages fill out of order (the
    checks' hook)."""
    kw = dict(resolution=resolution, n_cascades=n_cascades,
              density_act=density_act, rgb_act=rgb_act, planes=planes)
    if rows.device.type == "cpu":
        return shade_volume_plain(rows, scale, cam_origin, rgb_weights, rgb_mlp=rgb_mlp, **kw)
    if rows.device.type != "cuda":
        raise ValueError(f"shade_volume: unsupported device {rows.device}")
    R, K = resolution, n_cascades
    Rv = R + 1
    dev = rows.device
    p0, p1 = _plane_range(planes, R, K)
    if rows.dtype != torch.int16 or tuple(rows.shape) != (K * Rv ** 3, 16) \
            or not rows.is_contiguous():
        raise ValueError(f"shade_volume: rows must be contiguous int16 "
                         f"({K * Rv ** 3}, 16), got {rows.dtype} {tuple(rows.shape)}")
    shapes = tuple(tuple(w.shape) for w in rgb_weights)
    n_hidden, width = shade_mlp_layout(shapes)
    if rgb_mlp is not None and (rgb_mlp.activation.lower() != "relu"
                                or rgb_mlp.output_activation.lower() != "none"):
        raise ValueError(f"shade_volume: the kernel runs a ReLU MLP with no output "
                         f"activation, got {rgb_mlp.activation} / {rgb_mlp.output_activation}")
    if density_act not in _ACT_CODE or rgb_act not in _ACT_CODE:
        raise ValueError("shade_volume: unsupported activation")
    if K > _MAX_CASCADES:
        raise ValueError(f"shade_volume: at most {_MAX_CASCADES} cascades, got {K}")
    scale = scale.to(device=dev, dtype=torch.float32).contiguous()
    if tuple(scale.shape) != (K, 16):
        raise ValueError(f"shade_volume: scale must be ({K}, 16)")
    cam = cam_origin.to(device=dev, dtype=torch.float32).contiguous()
    route = _route(shapes, path, dev)
    if route == "general":
        if rows.data_ptr() % 16:
            raise ValueError("shade_volume: the general path reads rows 16-byte aligned")
        width = general_width(width) if n_hidden else 32
    packed = _packed_for(rgb_weights, dev, _kernel_layout(n_hidden, route))
    out = torch.empty((p1 - p0, Rv, Rv, 4), dtype=torch.bfloat16, device=dev)

    lib = cuda_lib.load("shade")
    n_sms = torch.cuda.get_device_properties(dev).multi_processor_count
    acts = (_ACT_CODE[density_act], _ACT_CODE[rgb_act])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if route == "tuned":
            fn = lib.shade_volume_launch
            fn.restype = ctypes.c_int
            fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
            code = fn(rows.data_ptr(), scale.data_ptr(), cam.data_ptr(),
                      packed.data_ptr(), out.data_ptr(), R, K, p0, p1 - p0, *acts, n_sms,
                      stream)
        else:
            general = route == "general"
            fn = lib.shade_general_launch if general else lib.shade_wide_launch
            fn.restype = ctypes.c_int
            fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
                           + [ctypes.c_int] * (8 if general else 7) + [ctypes.c_void_p])
            code = fn(rows.data_ptr(), scale.data_ptr(), cam.data_ptr(), packed.data_ptr(),
                      packed.numel() // 2, n_hidden, width, out.data_ptr(), R, K, p0,
                      p1 - p0, *acts, n_sms, *((stall_ns,) if general else ()), stream)
    cuda_lib.check(lib, "shade", code)
    shade_volume.launches += 1
    return _as_volume(out, planes, K)


shade_volume.launches = 0


def kernel_occupancy() -> tuple[int, int]:
    """(blocks of the tuned shade kernel that fit one SM, threads of a
    block), as the CUDA runtime reports them for the built library."""
    lib = cuda_lib.load("shade")
    out = []
    for fn in (lib.shade_blocks_per_sm, lib.shade_block_threads):
        fn.restype = ctypes.c_int
        fn.argtypes = []
        out.append(int(fn()))
    return out[0], out[1]


def general_occupancy(rgb_weights) -> tuple[int, int, int]:
    """(warps a block, blocks an SM, dynamic shared bytes a block) of the
    general path for these weights (the general kernel, or the wide one for
    a net it cannot hold), as its launch picks them."""
    shapes = tuple(tuple(int(d) for d in w.shape) for w in rgb_weights)
    route = _route(shapes, "general", torch.device("cuda", torch.cuda.current_device()))
    return _launch_config(route, *_words_and_width(shapes, route), shade_mlp_layout(shapes)[0])


def mma_probe(a: torch.Tensor, b: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """A @ B for (64, 64) bf16 CUDA tensors through the tuned kernel's
    mma.sync.m16n8k16 chain and through the general kernel's wgmma chain
    (csrc/shade.cu::shade_mma_probe_kernel) -> two (64, 64) f32 results, for
    the checks that compare the two instructions' sums."""
    if a.device.type != "cuda" or tuple(a.shape) != (64, 64) or tuple(b.shape) != (64, 64) \
            or a.dtype != torch.bfloat16 or b.dtype != torch.bfloat16:
        raise ValueError("mma_probe: two (64, 64) bf16 CUDA tensors")
    a, b = a.contiguous(), b.contiguous()
    d_sync = torch.empty((64, 64), dtype=torch.float32, device=a.device)
    d_wgmma = torch.empty_like(d_sync)
    lib = cuda_lib.load("shade")
    fn = lib.shade_mma_probe
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 5
    with torch.cuda.device(a.device):
        code = fn(a.data_ptr(), b.data_ptr(), d_sync.data_ptr(), d_wgmma.data_ptr(),
                  torch.cuda.current_stream(a.device).cuda_stream)
    cuda_lib.check(lib, "shade", code)
    return d_sync, d_wgmma
