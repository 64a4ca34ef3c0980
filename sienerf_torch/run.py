"""The command line of the port (the twin of the repo's run.py, with its
flags and defaults): train a scene, save and load snapshots, bake
irradiance probes, evaluate test views, take a screenshot, export a mesh
and render a camera-path video, on the card unless --device says
otherwise.

    python -m sienerf_torch.run --scene path/to/nerf_scene --n_steps 2000
    python -m sienerf_torch.run --scene image.exr --n_steps 1000 --screenshot out.png
    python -m sienerf_torch.run --scene bunny.obj --n_steps 500 --save_mesh out.ply
    python -m sienerf_torch.run --scene scene/transforms.json --device cpu --n_steps 64 \\
        --test_transforms scene/transforms.json --eval_max_views 2
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--scene", required=True,
                   help="scene: nerf dir/transforms.json, image, mesh, .nvdb, geometry json")
    p.add_argument("--network", default=None,
                   help="network config json (default: configs/<mode>/base.json)")
    p.add_argument("--n_steps", type=int, default=2000)
    p.add_argument("--batch_size", type=int, default=1 << 18)
    p.add_argument("--downscale", type=int, default=1, help="image downscale for NeRF datasets")
    p.add_argument("--seed", type=int, default=1337)
    p.add_argument("--load_snapshot", default=None)
    p.add_argument("--save_snapshot", default=None)
    p.add_argument("--screenshot", default=None, help="render a frame to this path after training")
    p.add_argument("--renderer", default="live", choices=["live", "baked"],
                   help="NeRF frame renderer: live march or baked feature grid")
    p.add_argument("--screenshot_w", type=int, default=800)
    p.add_argument("--screenshot_h", type=int, default=800)
    p.add_argument("--save_mesh", default=None)
    p.add_argument("--marching_cubes_res", type=int, default=256)
    p.add_argument("--test_transforms", default=None,
                   help="NeRF eval: transforms json with test views")
    # the eval protocol: every test view at full resolution, spp 8, a black
    # background, min transmittance 1e-4
    p.add_argument("--eval_downscale", type=int, default=1)
    p.add_argument("--eval_max_views", type=int, default=0, help="0 = all test views")
    p.add_argument("--eval_spp", type=int, default=8)
    p.add_argument("--optimize_extrinsics", action="store_true")
    p.add_argument("--bake_probes", type=int, default=0,
                   help="geometry mode: bake an NxNxN SH irradiance probe grid from the "
                   "scene's NeRF objects before rendering")
    p.add_argument("--video_camera_path", default=None,
                   help='camera path json (CameraPath.save format), or "orbit"')
    p.add_argument("--video_output", default="video.mp4")
    p.add_argument("--video_fps", type=int, default=30)
    p.add_argument("--video_n_seconds", type=float, default=2.0)
    p.add_argument("--video_spp", type=int, default=2)
    p.add_argument("--video_w", type=int, default=640)
    p.add_argument("--video_h", type=int, default=360)
    p.add_argument("--device", default="cuda",
                   help="torch device the session runs on (cpu for a machine without a card)")
    return p.parse_args(argv)


# rays a round of the eval frames' march: per-ray results do not depend on
# it, and a larger tile takes fewer rounds (the default, 2^14, several times
# as many on a 720p frame)
EVAL_TILE = 1 << 17


def evaluate(sess, test_transforms: str, downscale: int, max_views: int, spp: int) -> dict:
    """The eval protocol on a transforms json's views: spp passes a view at
    low-discrepancy subpixel offsets, min transmittance 1e-4, each against
    its image composited on black -> PSNR and SSIM figures."""
    from sienerf_torch import metrics
    from sienerf_torch.io.nerf_dataset import load_nerf_dataset
    from sienerf_torch.ops.samplers import ld_pixel_offset
    from sienerf_torch.utils import log

    test_ds = load_nerf_dataset(test_transforms, downscale=downscale)
    params = sess.render_params()
    bf = sess.state["occ"]["bitfield"]
    w, h = test_ds.resolution
    n_views = test_ds.n_images if max_views <= 0 else min(test_ds.n_images, max_views)
    spp = max(spp, 1)
    psnrs, ssims = [], []
    for vi in range(n_views):
        acc = None
        for si in range(spp):
            rgba, _ = sess.engine.render_frame(
                params, bf, w, h, test_ds.xforms[vi], tuple(test_ds.focal_lengths[vi]),
                screen_center=tuple(test_ds.principal_points[vi]), min_transmittance=1e-4,
                pixel_offset=ld_pixel_offset(si) if spp > 1 else None, tile=EVAL_TILE)
            a = rgba.double()
            acc = a if acc is None else acc + a
        pred = (acc / spp)[..., :3].float().cpu().numpy()
        gt = test_ds.images[vi]
        gt_rgb = gt[..., :3] * gt[..., 3:4]  # the protocol's black background
        psnrs.append(metrics.psnr(pred, gt_rgb))
        ssims.append(metrics.ssim(pred, gt_rgb))
        log.info(f"view {vi}: psnr={psnrs[-1]:.2f} ssim={ssims[-1]:.3f}")
    return {"psnr_avg": float(np.mean(psnrs)), "psnr_min": float(np.min(psnrs)),
            "psnr_max": float(np.max(psnrs)), "ssim_avg": float(np.mean(ssims)),
            "n_views": len(psnrs)}


def main(argv=None) -> int:
    from sienerf_torch.common import TestbedMode
    from sienerf_torch.io.image_io import save_image
    from sienerf_torch.scenes import resolve_scene
    from sienerf_torch.session import Session, mode_from_scene
    from sienerf_torch.utils import log
    from sienerf_torch.utils.camera import look_at_matrix

    args = parse_args(argv)
    args.scene = resolve_scene(args.scene)
    sess = Session(seed=args.seed, device=args.device)
    mode = mode_from_scene(args.scene)
    kwargs = {}
    if mode == TestbedMode.NERF:
        kwargs = {"train_batch_size": args.batch_size, "downscale": args.downscale}
    elif mode == TestbedMode.IMAGE:
        kwargs = {"batch_size": min(args.batch_size, 1 << 18)}
    elif mode in (TestbedMode.SDF, TestbedMode.VOLUME):
        kwargs = {"batch_size": min(args.batch_size, 1 << 16)}
    sess.load_file(args.scene, args.network, **kwargs)
    if args.optimize_extrinsics and mode == TestbedMode.NERF:
        sess.engine.optimize_extrinsics = True
        sess.state = sess.engine.init(args.seed)

    if args.load_snapshot:
        sess.load_snapshot(args.load_snapshot)

    if args.n_steps > 0 and mode != TestbedMode.GEOMETRY:
        t0 = time.time()
        sess.train(args.n_steps)
        log.success(f"trained {args.n_steps} steps in {time.time() - t0:.1f}s, "
                    f"final loss {sess.loss:.5f}")

    if args.save_snapshot:
        sess.save_snapshot(args.save_snapshot)

    if args.bake_probes > 0 and mode == TestbedMode.GEOMETRY:
        eng = sess.engine
        nerf_objs = [o for o in eng.objects if o.kind == "nerf" and o.nerf is not None]
        if not nerf_objs:
            log.warning("--bake_probes: scene has no NeRF objects to sample")
        else:
            from sienerf_torch.engines.irradiance import bake_probe_grid

            t0 = time.time()
            obj = nerf_objs[0]
            eng.probe_grid = bake_probe_grid(obj.nerf, obj.nerf_state, eng.aabb.min,
                                             eng.aabb.max, grid_size=args.bake_probes)
            eng.shade_mode = "grid"
            log.success(f"baked {args.bake_probes}^3 probe grid in {time.time() - t0:.1f}s")

    if args.test_transforms and mode == TestbedMode.NERF:
        with torch.no_grad():
            result = evaluate(sess, args.test_transforms, args.downscale * args.eval_downscale,
                              args.eval_max_views, args.eval_spp)
        print(json.dumps(result))

    if args.screenshot:
        cam = None
        if mode in (TestbedMode.SDF, TestbedMode.VOLUME, TestbedMode.GEOMETRY):
            cam = look_at_matrix([0.5, 0.6, -0.9], [0.5, 0.5, 0.5])
        kw = {"renderer": args.renderer} if args.renderer != "live" else {}
        rgba = sess.render(args.screenshot_w, args.screenshot_h, camera_matrix=cam, **kw)
        save_image(args.screenshot, rgba.cpu().numpy(), input_is_linear=False)
        log.success(f"screenshot saved to {args.screenshot}")

    if args.save_mesh:
        sess.save_mesh(args.save_mesh, resolution=args.marching_cubes_res)

    if args.video_camera_path:
        from sienerf_torch.utils.camera_path import CameraPath, render_video

        if args.video_camera_path == "orbit":
            cp = CameraPath.orbit([0.5, 0.5, 0.5], radius=1.2, height=0.35)
        else:
            cp = CameraPath.load(args.video_camera_path)
        n_frames = max(2, int(args.video_fps * args.video_n_seconds))
        kw = {"renderer": args.renderer} if args.renderer != "live" else {}
        t0 = time.time()
        render_video(sess, cp, args.video_output, width=args.video_w, height=args.video_h,
                     n_frames=n_frames, fps=args.video_fps, spp=args.video_spp, **kw)
        log.success(f"video: {n_frames} frames -> {args.video_output} "
                    f"({time.time() - t0:.1f}s)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
