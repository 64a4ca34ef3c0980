"""The plain reference of the fork's hybrid frame: meshes inside a NeRF,
lit by the sun through shadow rays and by irradiance probes baked from the
NeRF, the NeRF's bake composited by a slab sweep that stops at the mesh,
and the two blended by depth.

Per frame (one pass, rays through the pixel centres):
1. The mesh pass: each pixel's closest hit among the scene's meshes
   (reference/mesh.py, brute force in blocks), its triangle's normal
   turned towards the camera, a shadow ray from 1e-3 off the surface along
   the normal towards the sun (any hit: shadow), and the Disney BRDF
   (reference/brdf.py) with the base colour's square, the sun's colour
   times the shadow factor, and the probe grid's irradiance as the
   ambient term (reference/probes.py).  Depth is z-depth: t / |d| for the
   pixel's camera ray d of z = 1.
2. The NeRF: the bake shaded from the camera and swept along the dominant
   axis of the central ray (reference/sweep.py's shade, orientation and
   warp), each intermediate pixel's composite stopped at t_stop, the
   distance to the mesh along its own direction (canonical (1, e_b, e_c)
   in world axes), which is traced like the pixels.  The composite is
   written here: reference/sweep.py's, with the stop.
3. The blend: the NeRF's fragment over the mesh where it is in front (its
   opacity > 0 and its depth, the best-weight t over |d|, nearer than the
   mesh's), fb = nerf + fb * (1 - a); then the white background under
   what is left: rgb + (1 - alpha) * 1.

The control's precision: the MLPs on e4m3 operands ("fp8"), and with
`mesh_precision="bf16"` the mesh pass's vertices, origins and directions
rounded to bf16.  It imports nothing of the program.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from perfbench.reference import brdf, probes
from perfbench.reference import field as ref_field
from perfbench.reference import sweep as ref_sweep
from perfbench.reference.fields import field_parts
from perfbench.reference.mesh import Meshes, place, read_obj
from perfbench.reference.sweep import MIN_TRANSMITTANCE, NEAR, slab_schedule

BACKGROUND = 1.0


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def composite_stop(oriented, o_c, eb, ec, t_stop, resolution: int, n_cascades: int):
    """The slab sweep of reference/sweep.py::composite without the spp
    phase, each intermediate pixel's samples cut at t_hat > t_stop (Hi,
    Wi) -> (rgb (Hi, Wi, 3), opacity, best-weight t)."""
    R = resolution
    Rv = R + 1
    dev = oriented.device
    Hi, Wi = eb.shape[0], ec.shape[0]
    L = torch.sqrt(1.0 + eb[:, None] ** 2 + ec[None, :] ** 2)
    ii = torch.arange(Rv, device=dev)
    band = (ii > R // 4) & (ii < 3 * R // 4)
    inner_sq = band[:, None] & band[None, :]
    live = (oriented[:, :, 3] > 0).flatten(2).any(dim=2).cpu().numpy()
    C = torch.zeros((3, Hi, Wi), device=dev)
    T = torch.ones((Hi, Wi), device=dev)
    op = torch.zeros((Hi, Wi), device=dev)
    bw = torch.zeros((Hi, Wi), device=dev)
    bt = torch.zeros((Hi, Wi), device=dev)
    for m, j, x, pitch, inner in slab_schedule(n_cascades, R):
        if not live[m, j]:
            continue
        slab = oriented[m, j]
        if inner:
            slab = torch.where(inner_sq[None], torch.zeros((), dtype=slab.dtype, device=dev),
                               slab)
        x_rel = torch.tensor(x, device=dev) - o_c[0]
        pitch = torch.tensor(pitch, device=dev)
        lo = 0.5 - 0.5 * pitch * R
        gu = (o_c[1] + x_rel * eb - lo) / pitch
        gv = (o_c[2] + x_rel * ec - lo) / pitch
        A = ref_sweep._nearest(gu, Rv).to(torch.bfloat16).float()
        B = ref_sweep._nearest(gv, Rv).to(torch.bfloat16).float()
        t1 = (A @ slab.float().permute(1, 0, 2).reshape(Rv, 4 * Rv)).reshape(Hi, 4, Rv)
        t1 = t1.to(torch.bfloat16).float()
        s = (t1.permute(1, 0, 2).reshape(4 * Hi, Rv) @ B.T).reshape(4, Hi, Wi)
        t_hat = x_rel * L
        sigma = torch.clamp(s[3], min=0.0)
        rgb = s[:3] / torch.clamp(sigma, min=1e-10)[None]
        alive = (T >= MIN_TRANSMITTANCE) & (t_hat >= NEAR) & (t_hat <= t_stop)
        alpha = torch.where(alive, 1.0 - torch.exp(-sigma * (pitch * L)), 0.0)
        w = T * alpha
        better = w > bw
        C = C + w[None] * rgb
        T = T * (1.0 - alpha)
        op = op + w
        bw = torch.where(better, w, bw)
        bt = torch.where(better, t_hat, bt)
    return C.permute(1, 2, 0), op, bt


def pixel_rays(cam, focal, width: int, height: int, device):
    """The camera origin (3,) and every pixel centre's ray (N, 3), z = 1
    in the camera frame, rotated row by row as sums of products."""
    cam = np.asarray(cam, np.float32)
    fl = np.asarray(focal, np.float32)
    ids = torch.arange(width * height, device=device)
    px, py = (ids % width).float(), (ids // width).float()
    x = ((px + 0.5) / width - 0.5) * float(width) / float(fl[0])
    y = ((py + 0.5) / height - 0.5) * float(height) / float(fl[1])
    rot = torch.as_tensor(cam[:, :3], device=device)
    d = torch.stack([rot[r, 0] * x + rot[r, 1] * y + rot[r, 2] * 1.0 for r in range(3)], dim=-1)
    return torch.as_tensor(cam[:, 3], device=device), d


class Scene:
    """What every frame of a run shares: the bake, the probe grid and the
    meshes, at a precision."""

    def __init__(self, config: dict, scene_dir: Path, field_parts: dict, resolution: int,
                 device, precision: str = "bf16", mesh_precision: str | None = None):
        sc = config["scene"]
        self.precision, self.resolution = precision, resolution
        self.rgb_w = field_parts["rgb_w"]
        bitfield = field_parts["bitfield"]
        self.n_cascades = bitfield.shape[0]
        aabb = float(config["aabb_scale"])
        encode = field_parts["encode"]
        self.rows, self.scale = ref_field.bake(encode, field_parts["density_w"], bitfield,
                                               resolution, aabb, precision)
        cone = 0.0 if aabb <= 1.0 else 1.0 / 256.0
        pg = sc["probe_grid"]
        self.probes = probes.bake(
            probes.nerf_field(encode, field_parts["density_w"], self.rgb_w, precision),
            bitfield, aabb, cone, sc["probe_box"], pg["grid_size"], pg["env_width"],
            pg["env_height"])
        tris = [place(read_obj(Path(scene_dir) / f"mesh{i}.obj"), m["center"], m["scale"])
                for i, m in enumerate(sc["meshes"])]
        self.round = _bf16 if mesh_precision == "bf16" else (lambda x: x)
        self.meshes = Meshes(tris, device, round_to=_bf16 if mesh_precision else None)
        sun = torch.tensor(sc["sun_dir"], dtype=torch.float32, device=device)
        self.sun = sun / torch.sqrt((sun * sun).sum())

    def _hits(self, o, d):
        return self.meshes.closest_hit(self.round(o), self.round(d))

    @torch.no_grad()
    def mesh_pass(self, o, d):
        """-> (rgb (N, 3), zero off the mesh, z-depth (N,), inf off it,
        alpha (N,))."""
        dn = torch.sqrt((d * d).sum(-1, keepdim=True))
        du = d / dn
        t, tid = self._hits(o, du)
        hit = tid >= 0
        pos = o + torch.where(hit, t, 0.0)[:, None] * du
        n = self.meshes.normals[torch.clamp(tid, min=0)]
        n = n * torch.where((n * du).sum(-1, keepdim=True) > 0, -1.0, 1.0)
        shadow = torch.ones_like(t)
        ids = torch.nonzero(hit)[:, 0]
        if ids.numel():
            spos = pos[ids] + n[ids] * 1e-3
            occluded = self._hits(spos, self.sun.expand(spos.shape))[1] >= 0
            shadow[ids] = torch.where(occluded, 0.0, 1.0)
        base = (torch.tensor(brdf.BASE, device=d.device) ** 2).expand(pos.shape)
        amb = probes.irradiance(self.probes, pos, n)
        light = torch.tensor(brdf.SUN, device=d.device) * shadow[:, None]
        rgb = brdf.shade(base, amb, light, self.sun.expand(pos.shape), -du, n, **brdf.PARAMS)
        depth = torch.where(hit, t / dn[:, 0], float("inf"))
        return torch.where(hit[:, None], rgb, 0.0), depth, hit.float()

    @torch.no_grad()
    def frame(self, cam, focal, width: int, height: int) -> torch.Tensor:
        """One hybrid frame -> (H, W, 4) f32 rgba."""
        dev = self.rows.device
        o, d = pixel_rays(cam, focal, width, height, dev)
        mrgb, mdepth, malpha = self.mesh_pass(o, d)
        g = ref_sweep.geometry(cam, focal, width, height, (0.5, 0.5), dev)
        hi, wi = g["eb"].shape[0], g["ec"].shape[0]
        dw = torch.zeros((hi * wi, 3), device=dev)
        dw[:, g["axis"]] = -1.0 if g["flip"] else 1.0
        dw[:, g["b"]] = g["eb"][:, None].expand(hi, wi).reshape(-1)
        dw[:, g["c"]] = g["ec"][None, :].expand(hi, wi).reshape(-1)
        dw = dw / torch.sqrt((dw * dw).sum(-1, keepdim=True))
        t_stop = self._hits(o, dw)[0].reshape(hi, wi)
        vol = ref_sweep.shade(self.rows, self.scale, o, self.rgb_w, self.resolution,
                              self.n_cascades, self.precision)
        C, op, bt = composite_stop(ref_sweep.orient(vol, g), g["o_c"], g["eb"], g["ec"],
                                   t_stop, self.resolution, self.n_cascades)
        out = ref_sweep.warp(torch.cat([C, op[..., None], bt[..., None]], dim=-1), g)
        good = g["good"]
        nrgb = torch.where(good[:, None], out[:, :3], 0.0)
        nop = torch.where(good, out[:, 3].clamp(0.0, 1.0), 0.0)
        dn = torch.sqrt((d * d).sum(-1))
        ndep = torch.where(good, out[:, 4], 0.0) / torch.clamp(dn, min=1e-9)
        front = (nop > 0.0) & (ndep < mdepth)
        a = torch.where(front, nop, 0.0)
        rgb = torch.where(front[:, None], nrgb + mrgb * (1.0 - a[:, None]), mrgb)
        alpha = torch.where(front, a + malpha * (1.0 - a), malpha)
        rgb = rgb + (1.0 - alpha)[:, None] * BACKGROUND
        return torch.cat([rgb, alpha[:, None]], dim=-1).reshape(height, width, 4)


def render(config: dict, seed: int, scene_dir: Path, cams: list, positions: list, fmt: dict,
           device, precision: str = "bf16", mesh_precision: str | None = None) -> dict:
    """The reference's frames at the given path positions -> {pos: uint8
    (H, W, 4)}, TF32 off."""
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        parts = field_parts(config, seed, device)
        scene = Scene(config, scene_dir, parts, fmt["bake_resolution"], device, precision,
                      mesh_precision)
        focal = (float(fmt["focal"]),) * 2
        out = {}
        for pos in positions:
            rgba = scene.frame(cams[pos], focal, fmt["width"], fmt["height"])
            out[pos] = (rgba.clamp(0.0, 1.0) * 255.0 + 0.5).to(torch.uint8).cpu().numpy()
        return out
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev

