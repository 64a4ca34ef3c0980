"""Slab-sweep (shear-warp) frame renderer over the baked lattice (port of
the JAX package's engines/nerf_sweep.py).

Per frame:
1. K1 shades every lattice vertex once for this camera (ops/shade.py) into
   a premultiplied (s*r, s*g, s*b, s) bf16 volume, stored channel-last
   (K, R+1, R+1, R+1, 4) and seen slab-major along world axis 0.
2. The sweep axis (the dominant axis of the central view ray, picked on
   the host) selects a permuted view of that one volume; K2
   (ops/sweep_kernel.py) composites every cascade slab front to back onto a
   gnomonic intermediate image, reading a texel's four channels as 8
   contiguous bytes and the flipped sweep as data plane R-j.
3. One projective warp maps the intermediate image onto the pixels, and
   the epilogue adds the background (behind a trained envmap, when the
   params carry one).

`render_frame_sweep_multichip` runs the same frame over the ranks of a
mesh (parallel/mesh.py): K1 shades each rank's share of the vertex planes
and the planes are gathered into the volume on every rank
(`prepare_rgba_volume_sharded`), K2 composites each rank's share of the
slab schedule and the partials are folded in schedule order
(ops/sweep_kernel.py::sweep_composite_sharded); the warp and the epilogue
run on every rank.

`impl="kernel"` (the default) runs K1 and K2; their wrappers launch the
CUDA kernels for CUDA tensors and take the plain versions only for
tensors on the CPU.  A network that K1 does not take (the JAX package's
eligibility test: SH degree other than 4, extra dims, a non-ReLU colour
MLP) is shaded by the plain shade and composited by K2, the JAX package's
route for such configs; a field with extra dims (latent codes, light
directions) goes this way, shaded with one row of them (training view 0's,
or the frame's `extra_row`).  `impl="plain"` runs the plain PyTorch
versions on any device, as the oracle the kernels are checked against.
"""

from __future__ import annotations

import numpy as np
import torch

from sienerf_torch.common import NERF_RENDERING_NEAR_DISTANCE, NerfActivation
from sienerf_torch.engines.nerf_baked import with_extra_row
from sienerf_torch.ops.baked import row_bits
from sienerf_torch.ops.envmap import background_behind_envmap
from sienerf_torch.ops.shade import shade_planes, shade_volume
from sienerf_torch.ops.sweep import canon_coords, orient_grid, sweep_composite, warp_to_pixels
from sienerf_torch.ops.sweep_kernel import sweep_composite_kernel, sweep_composite_sharded
from sienerf_torch.parallel.mesh import gather_rows, shard_range
from sienerf_torch.tracing import RECORDER
from sienerf_torch.utils.device_inputs import constant

E_MAX = 16.0  # gnomonic clamp: rays more than ~86 deg off-axis render as background


def _plain_planes(engine, params, rows, scale, cam_origin, resolution: int,
                  n_cascades: int, p0: int, p1: int) -> torch.Tensor:
    """The plain shade of vertex planes [p0, p1) of the K*(R+1) planes ->
    (p1 - p0, R+1, R+1, 4) bf16, with the params' render row of extra dims
    (zeros when they have none)."""
    R, K = resolution, n_cascades
    Rv = R + 1
    dev = rows.device
    extra = None
    if engine.net.n_extra_dims:
        extra = engine._render_extra(params)
        if extra is None:
            extra = torch.zeros((engine.net.n_extra_dims,), dtype=torch.float32, device=dev)
    plane = torch.arange(p0, p1, device=dev)
    vol = shade_planes(rows.reshape(K * Rv, Rv * Rv, rows.shape[-1])[p0:p1], plane // Rv,
                       plane % Rv, scale, cam_origin, params["rgb_mlp"], engine.net.rgb_mlp,
                       resolution=R, density_act=engine.net.density_activation,
                       rgb_act=engine.net.rgb_activation, sh_degree=engine.net.sh_degree,
                       extra=extra)
    return vol.reshape(p1 - p0, Rv, Rv, 4)


def prepare_rgba_volume(engine, params, rows, scale, cam_origin,
                        resolution: int, n_cascades: int) -> torch.Tensor:
    """Plain shade pass: (K*(R+1)^3, F) rows -> (K, R+1, R+1, R+1, 4) bf16
    premultiplied [s*r, s*g, s*b, s] volume for `cam_origin`, with the
    params' render row of extra dims (zeros when they have none)."""
    Rv = resolution + 1
    return _plain_planes(engine, params, rows, scale, cam_origin, resolution, n_cascades, 0,
                         n_cascades * Rv).reshape(n_cascades, Rv, Rv, Rv, 4)


def prepare_rgba_volume_sharded(engine, params, rows, scale, cam_origin,
                                resolution: int, n_cascades: int, mesh) -> torch.Tensor:
    """The shade pass split over a mesh's ranks: rank r shades its
    shard_range share of the K*(R+1) vertex planes (K1 on the card for a
    network it takes, else, as prepare_rgba_volume, the plain shade), and
    the planes are gathered in rank order -> the (K, R+1, R+1, R+1, 4) bf16
    channel-last volume on every rank.  rows, scale and params are the same
    on every rank."""
    R, K = resolution, n_cascades
    Rv = R + 1
    p0, p1 = shard_range(K * Rv, mesh.world, mesh.rank)
    if p1 == p0:  # a rank past the last plane
        local = torch.empty((0, Rv, Rv, 4), dtype=torch.bfloat16, device=rows.device)
    elif _fused_prep_eligible(engine, {"rows": rows}):
        local = shade_volume(rows, scale, cam_origin, params["rgb_mlp"], resolution=R,
                             n_cascades=K, density_act=engine.net.density_activation,
                             rgb_act=engine.net.rgb_activation, rgb_mlp=engine.net.rgb_mlp,
                             planes=(p0, p1)).permute(0, 2, 3, 1)
    else:
        local = _plain_planes(engine, params, rows, scale, cam_origin, R, K, p0, p1)
    return gather_rows(local, K * Rv, mesh).reshape(K, Rv, Rv, Rv, 4)


def axis_view(vol: torch.Tensor, axis: int) -> torch.Tensor:
    """The shade kernel's (K, i, 4, j, k) volume as the sweep-major view
    (K, S_a, 4, S_b, S_c) for the sweep along `axis`: strides only, no
    transposed copy."""
    return {0: vol, 1: vol.permute(0, 3, 2, 1, 4), 2: vol.permute(0, 4, 2, 1, 3)}[axis]


def _pick_axis(camera_matrix, focal_length, width, height, screen_center=(0.5, 0.5)):
    """Sweep axis and flip from the central view ray, on the host."""
    cam = np.asarray(camera_matrix, np.float32)
    sc = np.asarray(screen_center, np.float32)
    fl = np.asarray(focal_length, np.float32)
    x = (0.5 - sc[0]) * width / fl[0]
    y = (0.5 - sc[1]) * height / fl[1]
    d0 = cam[:3, :3] @ np.asarray([x, y, 1.0], np.float32)
    axis = int(np.argmax(np.abs(d0)))
    return axis, bool(d0[axis] < 0)


def _align(x, m: int = 128) -> int:
    return -(-int(x) // m) * m


_KERNEL_ACTS = (NerfActivation.EXPONENTIAL, NerfActivation.RELU, NerfActivation.LOGISTIC)


def _fused_prep_eligible(engine, grid) -> bool:
    """The JAX package's test for its fused shade kernel, and nothing more:
    16-field int16 rows, no extra dims, SH degree 4, a 32-wide ReLU colour
    MLP of any depth and width with no output activation, and kernel
    activations.  Where it fails, the frame takes the plain shade and then
    K2, as the JAX package takes its XLA prep and then its composite."""
    net = engine.net
    mlp = net.rgb_mlp
    return (
        row_bits(grid["rows"]) == 16
        and grid["rows"].shape[-1] == 16
        and net.n_extra_dims == 0
        and net.sh_degree == 4
        and mlp.n_input_dims == 32
        and mlp.activation.lower() == "relu"
        and mlp.output_activation.lower() == "none"
        and net.density_activation in _KERNEL_ACTS
        and net.rgb_activation in _KERNEL_ACTS
    )


@torch.no_grad()
def sweep_geometry(engine, camera_matrix, focal_length, *, width: int, height: int,
                   margin: float = 1.15, hi: int | None = None, wi: int | None = None,
                   screen_center=(0.5, 0.5), pixel_offset=None, device="cuda") -> dict:
    """The frame's rays and its gnomonic intermediate image: sweep axis and
    flip, rays (o, unit d, |d|), canonical camera origin o_c, per-pixel
    gnomonic coordinates e_px with their validity `good`, and the
    intermediate grid eb (hi,), ec (wi,) with its spacing deb, dec."""
    axis, flip = _pick_axis(camera_matrix, focal_length, width, height, screen_center)
    hi = hi or _align(margin * height)
    wi = wi or _align(margin * width)
    n = width * height
    off = (0.5, 0.5) if pixel_offset is None else pixel_offset
    cam_spec = (width, height, focal_length, camera_matrix, screen_center, off)
    o, d_n, dn, _, _ = engine._frame_make_rays(torch.arange(n, device=device), n, cam_spec)

    o_c = canon_coords(o[0], axis, flip, True)
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
    eb = elo[0] + (torch.arange(hi, device=device, dtype=torch.float32) - 0.5) * deb
    ec = elo[1] + (torch.arange(wi, device=device, dtype=torch.float32) - 0.5) * dec
    return dict(axis=axis, flip=flip, o=o, d=d_n, dn=dn, o_c=o_c, e_px=e_px, good=good,
                eb=eb, ec=ec, deb=deb, dec=dec)


@torch.no_grad()
def render_frame_sweep(engine, params, grid, meta, camera_matrix, focal_length, *,
                       width: int, height: int, margin: float = 1.15,
                       hi: int | None = None, wi: int | None = None,
                       impl: str = "kernel", packed: bool = False,
                       screen_center=(0.5, 0.5), background=(0.0, 0.0, 0.0),
                       min_transmittance=None, pixel_offset=None,
                       interp: str = "nearest", axis_phase=None, extra_row=None):
    """Full-frame slab-sweep render -> (rgba (H, W, 4), depth (H, W)), or one
    channel-major (5, H, W) array [r, g, b, a, depth] when `packed`.

    `grid`/`meta` come from bake_feature_grid (mode 'nearest').
    `axis_phase` in [0, 1) moves every sample plane by that fraction of its
    pitch (the spp jitter).  `extra_row` shades with another view's extra
    dims (default view 0's)."""
    params = with_extra_row(params, extra_row)
    if meta["mode"] != "nearest":
        raise ValueError("sweep renderer needs a mode='nearest' bake")
    if impl not in ("kernel", "plain"):
        raise ValueError(f"unknown impl {impl!r}")
    rows, scale = grid["rows"], grid["scale"]
    dev = rows.device
    R, K = meta["resolution"], meta["n_cascades"]
    with RECORDER.span("geometry", device=True):
        g = sweep_geometry(engine, camera_matrix, focal_length, width=width,
                           height=height, margin=margin, hi=hi, wi=wi,
                           screen_center=screen_center, pixel_offset=pixel_offset,
                           device=dev)
    axis, flip, o, o_c, eb, ec = g["axis"], g["flip"], g["o"], g["o_c"], g["eb"], g["ec"]
    min_t = engine.render_min_transmittance if min_transmittance is None \
        else min_transmittance
    near = max(NERF_RENDERING_NEAR_DISTANCE, engine.near_distance)

    if impl == "kernel":
        with RECORDER.span("shade", device=True):
            if _fused_prep_eligible(engine, grid):
                vol = shade_volume(rows, scale, o[0], params["rgb_mlp"], resolution=R,
                                   n_cascades=K, density_act=engine.net.density_activation,
                                   rgb_act=engine.net.rgb_activation,
                                   rgb_mlp=engine.net.rgb_mlp)
            else:  # the JAX package's route: the plain shade, then K2
                vol = prepare_rgba_volume(engine, params, rows, scale, o[0], R, K) \
                    .permute(0, 1, 4, 2, 3)
        with RECORDER.span("composite", device=True):
            C, op, T, bt = sweep_composite_kernel(
                axis_view(vol, axis), o_c, eb, ec, near, min_t, phase=axis_phase,
                resolution=R, n_cascades=K, interp=interp, data_flip=flip)
    else:
        with RECORDER.span("shade", device=True):
            vol = prepare_rgba_volume(engine, params, rows, scale, o[0], R, K)
        with RECORDER.span("composite", device=True):
            C, op, T, bt = sweep_composite(
                orient_grid(vol, axis, flip), o_c, eb, ec, near, min_t,
                phase=axis_phase, resolution=R, n_cascades=K, interp=interp)

    with RECORDER.span("warp", device=True):
        rgb, opacity, depth = _warp_epilogue(g, C, op, bt, params, background)
        if packed:
            out5 = torch.stack([rgb[:, 0], rgb[:, 1], rgb[:, 2], opacity, depth], dim=0)
            return out5.reshape(5, height, width)
        rgba = torch.cat([rgb, opacity[:, None]], dim=-1)
        return rgba.reshape(height, width, 4), depth.reshape(height, width)


def _warp_epilogue(g: dict, C, op, bt, params, background):
    """The intermediate maps warped to the pixels of sweep_geometry `g`,
    over the background (behind a trained envmap) -> flat rgb, opacity,
    z-depth."""
    maps = torch.cat([C, op[..., None], bt[..., None]], dim=-1)
    good = g["good"]
    outs = warp_to_pixels(maps, g["e_px"], g["eb"][0], g["deb"], g["ec"][0], g["dec"])
    rgb = torch.where(good[:, None], outs[:, :3], 0.0)
    opacity = torch.where(good, outs[:, 3].clamp(0.0, 1.0), 0.0)
    depth = torch.where(good, outs[:, 4], 0.0) / torch.clamp(g["dn"], min=1e-9)
    bg = constant(np.asarray(background, np.float32), C.device)
    if "envmap" in params:
        bg = background_behind_envmap(params["envmap"], g["d"], bg)
    return rgb + (1.0 - opacity)[:, None] * bg, opacity, depth


@torch.no_grad()
def render_frame_sweep_multichip(engine, params, grid, meta, camera_matrix, focal_length,
                                 mesh, *, width: int, height: int, margin: float = 1.15,
                                 hi: int | None = None, wi: int | None = None,
                                 screen_center=(0.5, 0.5), background=(0.0, 0.0, 0.0),
                                 min_transmittance=None, pixel_offset=None,
                                 interp: str = "nearest"):
    """render_frame_sweep over a mesh's ranks -> (rgba (H, W, 4), depth
    (H, W)) on every rank: the rays, axis and gnomonic grid of
    sweep_geometry, the plane-sharded shade (prepare_rgba_volume_sharded),
    the slab-sharded composite (sweep_composite_sharded, each rank's share
    cut at its own min transmittance: at 0 the frame is the one-device
    frame up to float rounding), then the warp and epilogue on every rank.
    params and the bake are the same on every rank."""
    if meta["mode"] != "nearest":
        raise ValueError("sweep renderer needs a mode='nearest' bake")
    rows, scale = grid["rows"], grid["scale"]
    R, K = meta["resolution"], meta["n_cascades"]
    g = sweep_geometry(engine, camera_matrix, focal_length, width=width, height=height,
                       margin=margin, hi=hi, wi=wi, screen_center=screen_center,
                       pixel_offset=pixel_offset, device=rows.device)
    min_t = engine.render_min_transmittance if min_transmittance is None \
        else min_transmittance
    near = max(NERF_RENDERING_NEAR_DISTANCE, engine.near_distance)
    vol = prepare_rgba_volume_sharded(engine, params, rows, scale, g["o"][0], R, K, mesh)
    C, op, T, bt = sweep_composite_sharded(
        mesh, axis_view(vol.permute(0, 1, 4, 2, 3), g["axis"]), g["o_c"], g["eb"], g["ec"],
        near, min_t, resolution=R, n_cascades=K, interp=interp, data_flip=g["flip"])
    rgb, opacity, depth = _warp_epilogue(g, C, op, bt, params, background)
    rgba = torch.cat([rgb, opacity[:, None]], dim=-1)
    return rgba.reshape(height, width, 4), depth.reshape(height, width)
