"""The corner table layout through the Session's trainers: the image, SDF
and volume trainers and the NeRF trainer with a config that sets
`encoding.layout: "corner"`, and a .ingp written by the port's export_ingp
loaded by Session.load_snapshot and trained on (its backward is held to
the reference in tests/test_torch_corner.py).  Scenes are built in code."""

import json

import numpy as np
import pytest
import torch

from test_torch_corner import _tiny_net_config


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


def _write_scene(mode, tmp_path):
    """A small scene of `mode` written in code and its corner-layout
    config -> (scene path, config path, load_file options)."""
    from sienerf_torch.io.exr import write_exr
    from sienerf_torch.io.nanovdb import synthetic_fog_volume, write_nanovdb

    if mode == "image":
        from test_torch_image import make_target, small_config

        write_exr(tmp_path / "t.exr", make_target(64, 4))
        scene, cfg, kw = tmp_path / "t.exr", small_config(), {"batch_size": 2048}
    elif mode == "sdf":
        from sienerf_torch.geom.mesh_io import save_obj
        from test_torch_bvh_queries import scene_triangles
        from test_torch_sdf import small_config

        tri = scene_triangles()
        save_obj(tmp_path / "m.obj", tri.reshape(-1, 3), np.arange(len(tri) * 3).reshape(-1, 3))
        scene, cfg, kw = tmp_path / "m.obj", small_config(), {"batch_size": 1 << 11}
    else:
        from test_torch_volume import small_config

        write_nanovdb(tmp_path / "v.nvdb", synthetic_fog_volume(32, "shell").density)
        scene, cfg, kw = tmp_path / "v.nvdb", small_config(), {"batch_size": 4096}
    cfg["encoding"]["layout"] = "corner"
    (tmp_path / "net.json").write_text(json.dumps(cfg))
    return scene, tmp_path / "net.json", kw


@pytest.mark.parametrize("mode", ["image", "sdf", "volume"])
def test_corner_configs_train_through_the_session(mode, tmp_path):
    """Each single-network trainer with a corner-layout config: the loss
    falls, the table (L, T, F) moves, and a frame renders."""
    from sienerf_torch.session import Session

    scene, net, kw = _write_scene(mode, tmp_path)
    s = Session(device="cpu")
    s.load_file(scene, network=net, **kw)
    grid = s.engine.net.grid
    assert grid.layout == "corner"
    table0 = s.state["params"]["grid"].clone()
    assert table0.shape == (grid.n_levels, grid.table_size, grid.n_features_per_level)
    s.train(32 if mode != "image" else 3)
    assert np.isfinite(s.loss) and s.loss_graph[-1] < s.loss_graph[0]
    assert not torch.equal(s.state["params"]["grid"], table0)
    out = s.render(24, 16, look_at_matrix_for(mode), (30.0, 30.0))
    assert out.shape == (16, 24, 4) and bool(torch.isfinite(out).all())


def look_at_matrix_for(mode):
    from sienerf_torch.utils.camera import look_at_matrix

    return look_at_matrix([0.5, 0.7, -0.6] if mode != "volume" else [0.5, 0.5, -1.5],
                          [0.5, 0.5, 0.5])


def test_corner_nerf_and_an_exported_ingp_train_through_the_session(tmp_path):
    """A corner-layout NeRF config trains through Session.train; the port's
    export_ingp of a cell-layout field loads through
    Session.load_snapshot (the corner table it holds, on the loaded
    scene's dataset) and trains on with a finite loss, twice to the same
    bits.  Bundles of 4 steps (grid_interval), to keep the CPU time low."""
    from sienerf_torch.io.ingp import export_ingp
    from sienerf_torch.session import Session
    from test_torch_frontends import png_nerf_scene

    root = png_nerf_scene(tmp_path)
    kw = dict(train_batch_size=1 << 10, grid_size=16)

    def session(layout):
        cfg = dict(_tiny_net_config(layout), **_optimizer_config())
        (tmp_path / f"{layout}.json").write_text(json.dumps(cfg))
        s = Session(device="cpu")
        s.load_file(root, network=tmp_path / f"{layout}.json", **kw)
        s.engine.grid_interval = 4
        return s, cfg

    s, _ = session("corner")
    assert s.engine.net.grid.layout == "corner"
    t0 = s.state["params"]["grid"].clone()
    s.train(4)
    assert np.isfinite(s.loss) and s.training_step == 4
    assert not torch.equal(s.state["params"]["grid"], t0)

    c, cell = session("cell")
    c.train(4)
    net = c.engine.net
    export_ingp(tmp_path / "f.ingp", cell, c.render_params(), net.grid, net.density_mlp,
                net.rgb_mlp, density_grid=c.state["occ"]["density"].numpy(),
                aabb_scale=float(c.engine.aabb.diag[0]), training_step=c.training_step,
                loss=c.loss)
    runs = []
    for _ in range(2):
        r, _ = session("cell")
        r.load_snapshot(tmp_path / "f.ingp")
        assert r.engine.net.grid.layout == "corner" and r.training_step == 4
        assert r.engine.images.shape[0] == c.engine.images.shape[0]
        r.engine.grid_interval = 4
        t0 = r.state["params"]["grid"].clone()
        r.train(4)
        assert np.isfinite(r.loss) and r.training_step == 8
        assert not torch.equal(r.state["params"]["grid"], t0)
        runs.append((r.loss, r.state["params"]["grid"]))
    assert runs[0][0] == runs[1][0] and torch.equal(runs[0][1], runs[1][1])


def _optimizer_config():
    from test_nerf_mode import tiny_config

    t = tiny_config()
    return {"loss": t["loss"], "optimizer": t["optimizer"]}
