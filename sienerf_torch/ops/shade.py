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
tensor cores): a tuned path for the fox's 32-64-64-3 colour MLP and a
general path for any other ReLU colour MLP the JAX kernel takes (0 or more
hidden layers of one width); its source note gives the design and the
bound.
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


@functools.lru_cache(maxsize=16)
def _pack_index(shapes: tuple, device: torch.device) -> torch.Tensor:
    """For every bf16 value of the packed weights, its position in
    cat([W.flatten() for each layer] + [[0]]), as an index tensor on
    `device` (built once per shape list and device): the last slot is the
    zero that pads each layer's input to the previous layer's padded output,
    a hidden width to a multiple of 16 and the output layer from 3 to 8
    outputs.  A hidden layer is stored in (k16, pair of n8) tiles of 32
    lanes x 8 values, the output layer in k16 tiles of 32 lanes x 4.

    The layout is the B-fragment order of mma.m16n8k16 (B is k x n,
    "col"): lane l = 4g + t of the (k16 tile kt, n8 tile nt) fragment holds
    B[16kt + 2t + {0, 1}, 8nt + g] and B[16kt + 2t + 8 + {0, 1}, 8nt + g].
    A hidden layer stores n8 tiles in pairs, so a lane's 8 values (16
    bytes) feed two mma instructions."""
    _, width = shade_mlp_layout(shapes)
    lane = torch.arange(32)
    g, t = lane // 4, lane % 4
    # k offsets of a lane's four values within a k16 tile
    koff = torch.stack([2 * t, 2 * t + 1, 2 * t + 8, 2 * t + 9], dim=1)  # (32, 4)
    zero = sum(a * b for a, b in shapes)
    parts, base, k_pad = [], 0, 32
    for n_in, n_out in shapes[:-1]:
        kt = torch.arange(k_pad // 16)[:, None, None, None, None]
        npair = torch.arange(width // 16)[None, :, None, None, None]
        half = torch.arange(2)[None, None, None, :, None]
        k = 16 * kt + koff[None, None, :, None, :]
        n = 16 * npair + 8 * half + g[None, None, :, None, None]
        idx = torch.where((k < n_in) & (n < n_out), base + k * n_out + n, zero)
        parts.append(idx.reshape(-1))
        base += n_in * n_out
        k_pad = width
    n_in = shapes[-1][0]
    kt = torch.arange(k_pad // 16)[:, None, None]
    k = 16 * kt + koff[None]                       # (KT, 32, 4)
    n = g[None, :, None].expand(k.shape)
    parts.append(torch.where((n < 3) & (k < n_in), base + k * 3 + n, zero).reshape(-1))
    return torch.cat(parts).to(device)


def pack_shade_weights(rgb_weights) -> torch.Tensor:
    """Colour-MLP weights [(32, W), (W, W)..., (W, 3)] -> the kernel's bf16
    fragment-order buffer ((6656,), 13,312 bytes, for the fox's
    32-64-64-3)."""
    dev = rgb_weights[0].device
    shapes = tuple(tuple(w.shape) for w in rgb_weights)
    flat = torch.cat([w.to(torch.bfloat16).reshape(-1) for w in rgb_weights]
                     + [torch.zeros(1, dtype=torch.bfloat16, device=dev)])
    return flat[_pack_index(shapes, dev)].contiguous()


# the weights last packed for the kernel and their versions: a frame loop
# shades with the same tensors every time
_packed: dict = {"weights": (), "versions": (), "buffer": None}


def _packed_for(rgb_weights, device: torch.device) -> torch.Tensor:
    """pack_shade_weights on `device`, done again only when the weight
    tensors are other objects than last time, were written in place since,
    or were packed for another device."""
    versions = tuple(w._version for w in rgb_weights)
    same = (len(_packed["weights"]) == len(rgb_weights)
            and all(a is b for a, b in zip(_packed["weights"], rgb_weights))
            and _packed["versions"] == versions
            and _packed["buffer"].device == device)
    if not same:
        _packed.update(weights=tuple(rgb_weights), versions=versions,
                       buffer=pack_shade_weights([w.to(device) for w in rgb_weights]))
    return _packed["buffer"]


def unpack_shade_weights(packed: torch.Tensor, shapes=_TUNED_SHAPES) -> list[torch.Tensor]:
    """The inverse of pack_shade_weights for weights of `shapes` -> bf16."""
    shapes = tuple(tuple(sh) for sh in shapes)
    idx = _pack_index(shapes, packed.device)
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


def shade_volume_plain(rows, scale, cam_origin, rgb_weights, *, resolution: int,
                       n_cascades: int, density_act: NerfActivation,
                       rgb_act: NerfActivation, rgb_mlp: MLPConfig | None = None) -> torch.Tensor:
    """The plain version in the kernel's output layout: (K*(R+1)^3, 16) int16
    rows -> axis-0 volume (K, R+1, 4, R+1, R+1) bf16, a view of channel-last
    storage (channel stride 1).  `rgb_mlp` is the network's colour-MLP
    config (by default the ReLU MLP of the weights' shapes)."""
    R, K = resolution, n_cascades
    Rv = R + 1
    dev = rows.device
    planes = rows.reshape(K * Rv, Rv * Rv, rows.shape[-1])
    casc = torch.arange(K, device=dev).repeat_interleave(Rv)
    iplane = torch.arange(Rv, device=dev).repeat(K)
    vol = shade_planes(planes, casc, iplane, scale, cam_origin, rgb_weights,
                       rgb_mlp or mlp_for_weights(rgb_weights), resolution=R,
                       density_act=density_act, rgb_act=rgb_act)
    return vol.reshape(K, Rv, Rv, Rv, 4).permute(0, 1, 4, 2, 3)


def shade_volume(rows, scale, cam_origin, rgb_weights, *, resolution: int,
                 n_cascades: int, density_act: NerfActivation,
                 rgb_act: NerfActivation, rgb_mlp: MLPConfig | None = None) -> torch.Tensor:
    """K1: (K*(R+1)^3, 16) int16 rows, (K, 16) f32 scale, (3,) f32 camera
    origin, colour-MLP weights [(32, W), (W, W)..., (W, 3)] ->
    (K, R+1, 4, R+1, R+1) bf16 axis-0 volume, a view of channel-last
    storage.  Launches the CUDA kernel for CUDA tensors: the tuned path for
    the fox's 32-64-64-3, the general path for any other ReLU colour MLP;
    tensors on the CPU take the plain version.  Raises for an MLP the
    kernel does not take."""
    return _shade_volume(rows, scale, cam_origin, rgb_weights, resolution=resolution,
                         n_cascades=n_cascades, density_act=density_act, rgb_act=rgb_act,
                         rgb_mlp=rgb_mlp, general=False)


def _shade_general(rows, scale, cam_origin, rgb_weights, **kw) -> torch.Tensor:
    """shade_volume through the general path whatever the MLP, the fox's
    32-64-64-3 included: the checks hold it to the tuned path's bits."""
    return _shade_volume(rows, scale, cam_origin, rgb_weights, general=True, **kw)


def _shade_volume(rows, scale, cam_origin, rgb_weights, *, resolution: int,
                  n_cascades: int, density_act: NerfActivation,
                  rgb_act: NerfActivation, rgb_mlp: MLPConfig | None = None,
                  general: bool) -> torch.Tensor:
    kw = dict(resolution=resolution, n_cascades=n_cascades,
              density_act=density_act, rgb_act=rgb_act)
    if rows.device.type == "cpu":
        return shade_volume_plain(rows, scale, cam_origin, rgb_weights, rgb_mlp=rgb_mlp, **kw)
    if rows.device.type != "cuda":
        raise ValueError(f"shade_volume: unsupported device {rows.device}")
    R, K = resolution, n_cascades
    Rv = R + 1
    dev = rows.device
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
    packed = _packed_for(rgb_weights, dev)
    out = torch.empty((K, Rv, Rv, Rv, 4), dtype=torch.bfloat16, device=dev)

    lib = cuda_lib.load("shade")
    n_sms = torch.cuda.get_device_properties(dev).multi_processor_count
    acts = (_ACT_CODE[density_act], _ACT_CODE[rgb_act])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if shapes == _TUNED_SHAPES and not general:
            fn = lib.shade_volume_launch
            fn.restype = ctypes.c_int
            fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
            code = fn(rows.data_ptr(), scale.data_ptr(), cam.data_ptr(),
                      packed.data_ptr(), out.data_ptr(), R, K, *acts, n_sms, stream)
        else:
            fn = lib.shade_general_launch
            fn.restype = ctypes.c_int
            fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
                           + [ctypes.c_int] * 5 + [ctypes.c_void_p])
            code = fn(rows.data_ptr(), scale.data_ptr(), cam.data_ptr(), packed.data_ptr(),
                      packed.numel() // 2, n_hidden, width, out.data_ptr(), R, K, *acts,
                      n_sms, stream)
    cuda_lib.check(lib, "shade", code)
    shade_volume.launches += 1
    return out.permute(0, 1, 4, 2, 3)


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
    general path for these weights, as its launch picks them."""
    lib = cuda_lib.load("shade")
    _, width = shade_mlp_layout([w.shape for w in rgb_weights])
    n_words = pack_shade_weights([w.cpu() for w in rgb_weights]).numel() // 2
    fn = lib.shade_general_config
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int, ctypes.c_int] + [ctypes.POINTER(ctypes.c_int)] * 2
    smem, blocks = ctypes.c_int(0), ctypes.c_int(0)
    warps = int(fn(n_words, width, ctypes.byref(smem), ctypes.byref(blocks)))
    return warps, blocks.value, smem.value
