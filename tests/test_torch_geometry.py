"""Geometry mode, port vs reference: a scene JSON with code-built meshes
(a box and an icosphere, written as OBJ files), the mesh pass with shadow
rays and BRDF shading under each ambient source (constant sky light, an
irradiance envmap, the probe grid, and the checkerboard floor), and the
hybrid frame with the tiny seeded NeRF of tests/test_torch_live.py behind
a box that hides part of it: the live hybrid and the sweep hybrid (K1 and
K2 with the mesh's t_stop; their plain versions here; the baked hybrid is
tests/test_torch_baked_hybrid.py), as
tests/test_geometry_mode.py::test_hybrid_sweep_renderer_depth_stop checks
the reference, with the live renderer in place of "baked" in (c).  Then
the Session in geometry mode, with a NeRF object loaded from a native
snapshot and one from an .ingp snapshot.

Tolerances: the scene's arrays are equal.  The mesh pass: hit masks agree
on at least 99.9 % of the pixels, and on the pixels both hit, rgba and
depth within rtol 1e-5 / atol 1e-6 (the same f32 formulas).  The live
hybrid: the live frame's rule of tests/test_torch_live.py (99 % of pixels
within atol 5e-3).  The sweep hybrid: the sweep composite's rtol 1e-4 /
atol 2e-4 (tests/test_sweep_pallas.py), on every pixel, the two packages
shading the same bake."""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_live import tiny

W = 48
FOCAL = (36.0, 36.0)
EYE = [0.5, 0.5, -1.6]
MESH_TOL = dict(rtol=1e-5, atol=1e-6)
SWEEP_TOL = dict(rtol=1e-4, atol=2e-4)


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


def _cam():
    from sienerf_torch.utils.camera import look_at_matrix

    return look_at_matrix(EYE, [0.5, 0.5, 0.5])


def _write_obj(path, tri):
    from sienerf_torch.geom.mesh_io import save_obj

    save_obj(path, tri.reshape(-1, 3), np.arange(tri.shape[0] * 3).reshape(-1, 3))


@functools.lru_cache(maxsize=1)
def scene_dir():
    """A box in front of the field (centre (0.6, 0.5, -0.4), side 0.4) and a
    small sphere beside it, as one scene JSON."""
    import tempfile
    from pathlib import Path

    from sienerf_torch.geom.mesh_io import box_mesh, icosphere

    d = Path(tempfile.mkdtemp())
    _write_obj(d / "box.obj", box_mesh())
    _write_obj(d / "ball.obj", icosphere(2))
    scene = {"geometry": [
        {"center": [0.1, 0.0, -0.9], "scale": 0.4, "path": "box.obj", "type": "Mesh"},
        {"center": [-0.25, -0.2, -0.6], "scale": 0.25, "path": str(d / "nowhere" / "ball.obj"),
         "type": "Mesh"}]}
    (d / "scene.geometry.json").write_text(json.dumps(scene))
    return d


def engines():
    from sienerf_tpu.engines.geometry import GeometryEngine as J
    from sienerf_torch.engines.geometry import GeometryEngine as T

    p = scene_dir() / "scene.geometry.json"
    return J.load_scene(p), T.load_scene(p, device="cpu")


def _field_objects():
    from sienerf_tpu.engines.geometry import GeometryObject as JO
    from sienerf_torch.engines.geometry import GeometryObject as TO

    jeng, jp, teng, tp, bf = tiny()
    jo = JO("nerf", np.zeros(3, np.float32), "inline", nerf=jeng,
            nerf_state={"params": jp, "opt": {}, "occ": {"bitfield": jnp.asarray(bf)}})
    to = TO("nerf", np.zeros(3, np.float32), "inline", nerf=teng,
            nerf_state={"params": tp, "opt": {}, "occ": {"bitfield": torch.from_numpy(bf)}})
    return jo, to


def test_scene_loads_like_the_reference():
    jg, tg = engines()
    assert [(o.kind, o.path, o.tri_range) for o in tg.objects] == \
        [(o.kind, o.path, o.tri_range) for o in jg.objects]
    np.testing.assert_array_equal(tg.aabb.min, jg.aabb.min)
    np.testing.assert_array_equal(tg.aabb.max, jg.aabb.max)
    for k, v in jg.bvh_dev.items():
        np.testing.assert_array_equal(tg.bvh_dev[k].numpy(), np.asarray(v), err_msg=k)
    np.testing.assert_array_equal(tg.tri_normals.numpy(), np.asarray(jg.tri_normals))
    np.testing.assert_array_equal(tg.tri_obj_id.numpy(), np.asarray(jg.tri_obj_id))
    for k in ("G", "k", "uw", "vw", "n_tris"):
        np.testing.assert_array_equal(np.asarray(tg.brute_dev[k]), np.asarray(jg.brute_dev[k]))


def _hold_mesh_frames(j, t):
    (jr, jd), (tr, td) = j, t
    jr, jd, tr, td = np.asarray(jr), np.asarray(jd), tr.numpy(), td.numpy()
    jh, th = np.isfinite(jd), np.isfinite(td)
    assert np.mean(jh == th) >= 0.999
    both = jh & th
    np.testing.assert_allclose(tr[both], jr[both], **MESH_TOL)
    np.testing.assert_allclose(td[both], jd[both], **MESH_TOL)
    return jh


@pytest.mark.parametrize("ambient", ["constant", "envmap", "grid", "floor"])
def test_mesh_pass_matches(ambient):
    import dataclasses

    jg, tg = engines()
    rng = np.random.default_rng(0)
    for g in (jg, tg):
        g.brdf = dataclasses.replace(g.brdf, ambientcolor=(0.3, 0.4, 0.5), metallic=0.2)
    if ambient == "envmap":
        env = rng.random((8, 16, 3)).astype(np.float32)
        jg.envmap, tg.envmap = jnp.asarray(env), torch.from_numpy(env)
    if ambient == "grid":
        grid = {"coeffs": rng.standard_normal((2, 2, 2, 9, 3)).astype(np.float32),
                "min": np.zeros(3, np.float32), "max": np.ones(3, np.float32)}
        jg.probe_grid = {k: jnp.asarray(v) for k, v in grid.items()}
        tg.probe_grid = {k: torch.from_numpy(v) for k, v in grid.items()}
    if ambient == "floor":
        jg.floor_y = tg.floor_y = 0.35
    else:
        jg.shade_mode = tg.shade_mode = ambient
    cam = _cam()
    hit = _hold_mesh_frames(jg.render_frame(W, W, cam, FOCAL, tile=W * W),
                            tg.render_frame(W, W, cam, FOCAL))
    assert 0.05 < hit.mean() < 0.6


@functools.lru_cache(maxsize=1)
def hybrid_frames():
    """(reference, port) frames of the box-in-front scene with the field:
    mesh only, live hybrid, sweep hybrid (an R=16 bake, the reference's
    carried across), and the port's live hybrid through the BVH tier."""
    jg, tg = engines()
    cam = _cam()
    out = {"mesh": (jg.render_frame(W, W, cam, FOCAL, tile=W * W),
                    tg.render_frame(W, W, cam, FOCAL))}
    jo, to = _field_objects()
    jg.objects.append(jo)
    tg.objects.append(to)
    out["live"] = (jg.render_frame(W, W, cam, FOCAL, tile=W * W),
                   tg.render_frame(W, W, cam, FOCAL, tile=1000))
    from sienerf_torch.convert import baked_grid_from_jax

    grid, meta = jo.nerf.bake_features(jo.nerf_state["params"], jo.nerf_state["occ"],
                                       resolution=16)
    jo._bake = (grid, meta)
    to._bake = (baked_grid_from_jax(jax.tree.map(np.asarray, grid), "cpu"), dict(meta))
    out["sweep"] = (jg.render_frame(W, W, cam, FOCAL, tile=W * W, renderer="sweep"),
                    tg.render_frame(W, W, cam, FOCAL, renderer="sweep"))
    tg.brute_dev = None
    out["live_bvh"] = tg.render_frame(W, W, cam, FOCAL)
    return out


def test_live_hybrid_matches():
    f = hybrid_frames()
    (jr, jd), (tr, td) = f["live"]
    err = np.abs(np.asarray(jr) - tr.numpy()).max(axis=-1)
    assert (err <= 5e-3).mean() >= 0.99
    mesh_hit = np.isfinite(np.asarray(f["mesh"][0][1]))
    assert mesh_hit.mean() > 0.03
    # the BVH tier renders the same frame
    torch.testing.assert_close(f["live_bvh"][0], tr, rtol=1e-5, atol=1e-5)


def test_sweep_hybrid_matches_and_stops_at_the_mesh():
    f = hybrid_frames()
    (jr, jd), (tr, td) = f["sweep"]
    jr, tr = np.asarray(jr), tr.numpy()
    np.testing.assert_allclose(tr, jr, **SWEEP_TOL)
    fin = np.isfinite(np.asarray(jd))
    np.testing.assert_array_equal(np.isfinite(td.numpy()), fin)
    np.testing.assert_allclose(td.numpy()[fin], np.asarray(jd)[fin], **SWEEP_TOL)
    # (a) where the mesh is in front, the mesh's colour (no NeRF sample
    # behind the surface survives the t_stop), bar in-front fog
    (mr, md), _ = f["mesh"]
    mesh_hit = np.isfinite(np.asarray(md))
    d = np.abs(tr[mesh_hit] - np.asarray(mr)[mesh_hit])
    assert d.max() < 0.05 and (d < 1e-3).mean() > 0.98
    # (b) the field renders off the mesh
    nerf_region = (tr[..., 3] > 0.5) & ~mesh_hit
    assert nerf_region.sum() > 10
    # (c) coverage agrees with the live hybrid
    live = f["live"][1][0].numpy()
    assert np.mean((tr[..., 3] > 0.5) == (live[..., 3] > 0.5)) > 0.85


def test_unported_renderers_raise():
    """renderer="baked", and "sweep" without a NeRF object (which takes the
    baked path), render the mesh alone now (Slice E), as the reference
    does, under the live frame's rule; an unknown renderer still raises."""
    jg, tg = engines()
    from test_torch_baked import hold_frame

    want, wd = jg.render_frame(16, 16, _cam(), FOCAL, renderer="baked")
    got, gd = tg.render_frame(16, 16, _cam(), FOCAL, renderer="baked")
    hold_frame(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(np.isfinite(gd.numpy()), np.isfinite(np.asarray(wd)))
    sweep, _ = tg.render_frame(16, 16, _cam(), FOCAL, renderer="sweep")  # no NeRF object
    assert torch.equal(sweep, got)
    assert 0.05 < float(got[..., 3].mean()) < 0.95
    with pytest.raises(ValueError):
        tg.render_frame(8, 8, _cam(), FOCAL, renderer="raster")


def _native_field_snapshot(path):
    """The tiny field as a native training snapshot (port writer)."""
    from sienerf_torch.ops.optim import optim_init
    from sienerf_torch.session import Session

    _, _, teng, tp, bf = tiny()
    s = Session(device="cpu")
    s.engine = teng
    g = bf.shape[1]
    s.state = {"params": tp, "opt": optim_init(tp, teng.opt),
               "occ": {"density": torch.rand((1, g, g, g)), "bitfield": torch.from_numpy(bf),
                       "mean_density": torch.tensor(0.01), "n_updates": 1}, "step": 3}
    s.network_config = json.loads(json.dumps(_tiny_config()))
    s.save_snapshot(path)


def _tiny_config():
    from test_nerf_mode import tiny_config

    return tiny_config()


def test_session_geometry_mode(tmp_path):
    from sienerf_torch.session import Session

    _native_field_snapshot(tmp_path / "field.snap")
    scene = json.loads((scene_dir() / "scene.geometry.json").read_text())
    scene["geometry"][0]["path"] = str(scene_dir() / "box.obj")
    scene["geometry"] = scene["geometry"][:1] + [
        {"type": "Nerf", "path": "field.snap", "center": [0.0, 0.0, 0.0]}]
    (tmp_path / "hybrid.geometry.json").write_text(json.dumps(scene))
    s = Session(device="cpu").load_file(tmp_path / "hybrid.geometry.json")
    assert s.mode.value == "geometry" and s.state == {}
    nerf = [o for o in s.engine.objects if o.kind == "nerf"][0]
    assert nerf.nerf is not None and nerf.nerf_state["step"] == 3
    img = s.render(24, 24, _cam(), (18.0, 18.0))
    want, _ = s.engine.render_frame(24, 24, _cam(), (18.0, 18.0))
    assert torch.equal(img, want)
    # the same frame as the field attached in memory
    _, to = _field_objects()
    mem = Session(device="cpu").load_file(tmp_path / "hybrid.geometry.json")
    mem.engine.attach_nerf(1, to.nerf, to.nerf_state)
    assert torch.equal(mem.render(24, 24, _cam(), (18.0, 18.0)), img)
    # every renderer reaches the geometry engine: the sweep hybrid (a small
    # bake set on the object, as a caller may) and an unknown name
    nerf._bake = nerf.nerf.bake_features(nerf.nerf_state["params"], nerf.nerf_state["occ"],
                                         resolution=16)
    sweep = s.render(24, 24, _cam(), (18.0, 18.0), renderer="sweep")
    want, _ = s.engine.render_frame(24, 24, _cam(), (18.0, 18.0), renderer="sweep")
    assert torch.equal(sweep, want) and not torch.equal(sweep, img)
    with pytest.raises(ValueError, match="unknown renderer"):
        s.render(24, 24, _cam(), (18.0, 18.0), renderer="march")
    with pytest.raises(RuntimeError, match="geometry"):
        s.train(16)
    with pytest.raises(RuntimeError, match="NeRF-mode"):
        s.bake()


def test_scene_object_from_an_ingp_snapshot(tmp_path):
    from test_torch_ingp import exported

    from sienerf_torch.session import Session

    path, _ = exported()
    scene = {"geometry": [{"type": "Nerf", "path": str(path), "center": [0.0, 0.0, 0.0]}]}
    (tmp_path / "i.geometry.json").write_text(json.dumps(scene))
    s = Session(device="cpu").load_file(tmp_path / "i.geometry.json")
    o = s.engine.objects[0]
    assert o.nerf.net.grid.layout == "corner" and o.nerf_state["step"] == 37
    img = s.render(12, 12, _cam(), (9.0, 9.0))
    assert bool(torch.isfinite(img).all())
