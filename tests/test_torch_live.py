"""The live ray-marched renderer, port vs reference: the network forward
from f32, bf16 and fp8 hash tables, render_rays and a 48x32 render_frame of
a tiny engine (built as tests/test_nerf_mode.py builds its dataset and
config; seeded numpy params carried across by convert.params_from_jax), in
modes shade, depth and cost, and one 64x36 live frame of the committed fox
snapshot through both Sessions.

Tolerances: nerf_apply rtol 2e-2 / atol 2e-3 (a bf16 rounding between MLP
layers may flip with the f32 summation order).  Frames and ray batches:
rgba atol 5e-3 on the pixels that agree, and at least 99 % of the pixels
must agree.  A pixel agrees when both packages took the same number of
samples on its ray (read through render mode `cost`) and picked the same
depth sample (depth atol 1e-3).  The reference's loops are compiled, and
XLA on the CPU may contract `o + t*d` into a fused multiply-add, which can
move a single sample across a voxel boundary
(tests/test_torch_raymarch.py shows that gap per ray); depth is the t of
the largest weight, and between two near-equal weights a last-bit
difference picks the other sample, one step away.  Run op by op, the
reference gives the port's values to 1e-7 on such pixels.  The fox frame:
at least 99 % of the pixels within rtol 2e-2 / atol 5e-3 and a PSNR above
40 dB."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_nerf_mode import make_dataset, tiny_config
from test_torch_snapshot import fox_jax, fox_port_session

W, H = 48, 32
FOCAL = (50.0, 50.0)
EYE = (1.4, 0.8, -0.5)
G = 32
NET_TOL = dict(rtol=2e-2, atol=2e-3)


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


def _continuous_cell_grid(grid, rng):
    """A seeded cell table (L, T, C, F) that is continuous in space, as a
    trained one is.  The cell layout stores each cell's own copy of its
    corner vectors, so independent random rows would jump at every cell
    boundary, and a sample one ulp from a boundary (XLA contracts
    `o + t*d` under jit) would read another field.  Dense levels take their
    corners from one random vertex lattice; hashed levels, whose colliding
    cells cannot agree, get small values."""
    L, T, D, F = grid.n_levels, grid.table_size, grid.n_dims, grid.n_features_per_level
    table = rng.uniform(-0.02, 0.02, (L, T, 1 << D, F)).astype(np.float32)
    for l in range(L):
        if not grid.level_is_dense(l):
            continue
        r = grid.level_resolution(l)
        verts = rng.uniform(-1.0, 1.0, (r, r, r, F)).astype(np.float32)
        x, y, z = np.meshgrid(*[np.arange(r - 1)] * 3, indexing="ij")
        row = (x + y * (r - 1) + z * (r - 1) ** 2).reshape(-1)
        for c in range(1 << D):
            dx, dy, dz = c & 1, (c >> 1) & 1, (c >> 2) & 1
            table[l, row, c] = verts[x + dx, y + dy, z + dz].reshape(-1, F)
    return table


@functools.lru_cache(maxsize=1)
def tiny():
    """(JAX engine, JAX params, port engine, port params, bitfield): the
    same seeded field in both packages.  The occupancy is a ball with
    random blocks cut out; the grid (_continuous_cell_grid) and the density
    head are scaled so the field is partly opaque."""
    from sienerf_tpu.engines.nerf import NerfEngine as JaxEngine
    from sienerf_torch.convert import params_from_jax
    from sienerf_torch.engines.nerf import NerfEngine
    from sienerf_torch.io.nerf_dataset import NerfDataset

    ds = make_dataset()
    jeng = JaxEngine.create(tiny_config(), ds, train_batch_size=1 << 14, grid_size=G,
                            train_k=48)
    p = jax.tree.map(np.asarray, jeng.init(0)["params"])
    rng = np.random.default_rng(0)
    p["grid"] = _continuous_cell_grid(jeng.net.grid, rng)
    p["density_mlp"][-1] = p["density_mlp"][-1] * 12.0
    ax = (np.arange(G) + 0.5) / G
    x, y, z = np.meshgrid(ax, ax, ax, indexing="ij")
    ball = (x - 0.5) ** 2 + (y - 0.5) ** 2 + (z - 0.5) ** 2 < 0.3 ** 2
    blocks = rng.random((G // 4, G // 4, G // 4)) < 0.7
    bitfield = (ball & blocks.repeat(4, 0).repeat(4, 1).repeat(4, 2))[None]
    tds = NerfDataset(images=np.zeros((1, 8, 8, 4), np.float32),
                      xforms=np.asarray(ds.xforms),
                      focal_lengths=np.asarray(ds.focal_lengths),
                      principal_points=np.asarray(ds.principal_points),
                      resolution=ds.resolution, aabb_scale=ds.aabb_scale)
    teng = NerfEngine.create(tiny_config(), tds, grid_size=G, train_k=48, device="cpu")
    return (jeng, jax.tree.map(jnp.asarray, p), teng, params_from_jax(p, device="cpu"),
            bitfield)


def _cam():
    from sienerf_torch.utils.camera import look_at_matrix

    return look_at_matrix(list(EYE), [0.5, 0.5, 0.5])


def test_engine_fields_match():
    jeng, _, teng, _, _ = tiny()
    for name in ("render_chunk", "render_max_chunks", "render_march_iters_mult",
                 "render_min_transmittance", "init_advance_iters", "render_table_pack",
                 "max_samples_per_ray", "compact_training", "train_k", "near_distance"):
        assert getattr(teng, name) == getattr(jeng, name), name
    assert teng.march.n_cascades == jeng.march.n_cascades
    assert teng.march.cone_angle == jeng.march.cone_angle
    assert teng.march.grid_size == jeng.march.grid_size == G
    assert teng._march_iters() == jeng._march_iters() == 48
    assert teng._render_budget() == jeng._render_budget() == 1024


@pytest.mark.parametrize("table", ["f32", "bf16", "fp8", "flat"])
def test_nerf_apply_matches(table):
    from sienerf_tpu.models.nerf_network import density_raw as jax_density
    from sienerf_tpu.models.nerf_network import nerf_apply as jax_apply
    from sienerf_tpu.ops import hashgrid as jhg
    from sienerf_torch.convert import params_from_jax
    from sienerf_torch.models.nerf_network import density_raw, nerf_apply
    from sienerf_torch.ops import hashgrid as thg

    jeng, jp, teng, tp, _ = tiny()
    jp, tp = dict(jp), dict(tp)
    if table == "bf16":
        packed = jax.jit(lambda t: jhg.pack_table_bf16(jeng.net.grid, t))(jp.pop("grid"))
        jp["grid_bf16"] = packed
        mine = thg.pack_table_bf16(teng.net.grid, tp.pop("grid"))
        tp["grid_bf16"] = params_from_jax({"grid_bf16": np.asarray(packed)}, "cpu")["grid_bf16"]
        assert torch.equal(mine, tp["grid_bf16"])  # the port's packer gives the same bits
    elif table == "fp8":
        packed, scale = jax.jit(lambda t: jhg.pack_table_fp8(jeng.net.grid, t))(jp.pop("grid"))
        jp["grid_fp8"], jp["grid_fp8_scale"] = packed, scale
        mine, mine_scale = thg.pack_table_fp8(teng.net.grid, tp.pop("grid"))
        conv = params_from_jax({"grid_fp8": np.asarray(packed),
                                "grid_fp8_scale": np.asarray(scale)}, "cpu")
        tp.update(conv)
        np.testing.assert_allclose(mine_scale.numpy(), np.asarray(scale), rtol=1e-6)
        assert (mine != conv["grid_fp8"]).float().mean() < 1e-3  # ties in t / scale
    elif table == "flat":
        L = jeng.net.grid.n_levels
        jp["grid"] = jp["grid"].reshape(L, -1)
        tp["grid"] = tp["grid"].reshape(L, -1)
    rng = np.random.default_rng(1)
    pos = rng.uniform(0.0, 1.0, (2048, 3)).astype(np.float32)
    dirs = rng.normal(size=(2048, 3)).astype(np.float32)
    dirs = (dirs / np.linalg.norm(dirs, axis=1, keepdims=True) + 1.0) * 0.5
    want_rgb, want_d = jax_apply(jeng.net, jp, jnp.asarray(pos), jnp.asarray(dirs))
    rgb, dens = nerf_apply(teng.net, tp, torch.from_numpy(pos), torch.from_numpy(dirs))
    assert np.asarray(want_d).std() > 0.5  # a field with contrast
    np.testing.assert_allclose(rgb.numpy(), np.asarray(want_rgb), **NET_TOL)
    np.testing.assert_allclose(dens.numpy(), np.asarray(want_d), **NET_TOL)
    np.testing.assert_allclose(
        density_raw(teng.net, tp, torch.from_numpy(pos)).numpy(),
        np.asarray(jax_density(jeng.net, jp, jnp.asarray(pos))), **NET_TOL)


def test_pad_cell_table_matches():
    from sienerf_tpu.ops.hashgrid import _pad_cell_table as jax_pad
    from sienerf_torch.ops.hashgrid import _pad_cell_table

    jeng, jp, teng, tp, _ = tiny()
    want = np.asarray(jax_pad(jeng.net.grid, jp["grid"][:, :256]))
    got = _pad_cell_table(teng.net.grid, tp["grid"][:, :256])
    assert got.shape == (jeng.net.grid.n_levels, 256, 32)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("otype,opts", [("Frequency", {"n_frequencies": 6}),
                                        ("OneBlob", {"n_bins": 8}),
                                        ("TriangleWave", {"n_frequencies": 5}),
                                        ("Identity", {})])
def test_analytic_pos_encodings_match(otype, opts):
    """A NeRF network with an analytic position encoding: the encodings of
    ops/encodings.py through _encode_pos and the composite dispatch."""
    from sienerf_tpu.models.nerf_network import NerfNetworkConfig as JaxConfig
    from sienerf_tpu.models.nerf_network import _encode_pos as jax_encode
    from sienerf_tpu.ops import encodings as jenc
    from sienerf_torch.models.nerf_network import NerfNetworkConfig, _encode_pos
    from sienerf_torch.ops import encodings as tenc

    cfg = dict(tiny_config(), encoding=dict(otype=otype, **opts))
    jnet, tnet = JaxConfig.from_network_config(cfg), NerfNetworkConfig.from_network_config(cfg)
    assert tnet.density_mlp.n_input_dims == jnet.density_mlp.n_input_dims
    assert tnet.density_mlp.n_input_dims == tenc.encoding_output_dim(otype, 3, opts)
    pos = np.random.default_rng(2).uniform(0, 1, (512, 3)).astype(np.float32)
    want = np.asarray(jax_encode(jnet, {}, jnp.asarray(pos)))
    got = _encode_pos(tnet, {}, torch.from_numpy(pos))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    # the direction encoding's composite: SH on 3 dims, identity on the rest
    specs = tenc.composite_specs_from_config(cfg["dir_encoding"])
    jspecs = jenc.composite_specs_from_config(cfg["dir_encoding"])
    x = np.random.default_rng(3).uniform(0, 1, (64, 5)).astype(np.float32)
    np.testing.assert_allclose(
        tenc.composite_encode(torch.from_numpy(x), specs).numpy(),
        np.asarray(jenc.composite_encode(jnp.asarray(x), jspecs)), rtol=1e-5, atol=1e-6)


def _agree(got_cost, want_cost, got_depth, want_depth):
    same = (got_cost == want_cost) & (np.abs(got_depth - want_depth) <= 1e-3)
    assert same.mean() >= 0.99, f"only {same.mean():.4f} of the rays agree"
    return same


@functools.lru_cache(maxsize=1)
def _ray_batch():
    from sienerf_torch.utils.camera import uv_to_ray

    n = 1024
    rng = np.random.default_rng(4)
    uv = torch.from_numpy(rng.uniform(0, 1, (n, 2)).astype(np.float32))
    o, d = uv_to_ray(uv, (W, H), FOCAL, _cam())
    t_cap = rng.uniform(0.8, 2.5, n).astype(np.float32)
    return o.contiguous().numpy(), d.numpy(), t_cap


@functools.lru_cache(maxsize=8)
def _rays_both(mode, capped):
    jeng, jp, teng, tp, bf = tiny()
    o, d, t_cap = _ray_batch()
    jcap = jnp.asarray(t_cap) if capped else None
    tcap = torch.from_numpy(t_cap) if capped else None
    want = jeng.render_rays(jp, jnp.asarray(bf), jnp.asarray(o), jnp.asarray(d),
                            t_cap=jcap, render_mode=mode)
    got = teng.render_rays(tp, torch.from_numpy(bf), torch.from_numpy(o),
                           torch.from_numpy(d), t_cap=tcap, render_mode=mode)
    return [g.numpy() for g in got], [np.asarray(w) for w in want]


@pytest.mark.parametrize("capped", [False, True])
@pytest.mark.parametrize("mode", [None, "depth", "cost"])
def test_render_rays_matches(mode, capped):
    got, want = _rays_both(mode, capped)
    cost_got, cost_want = _rays_both("cost", capped)
    same = _agree(cost_got[0][:, 0], cost_want[0][:, 0], got[2], want[2])
    if mode != "cost":  # hits and misses
        assert want[1].mean() > 0.1 and (want[1] < 0.5).any()
    np.testing.assert_allclose(got[0][same], want[0][same], atol=5e-3)
    np.testing.assert_allclose(got[1][same], want[1][same], atol=5e-3)
    if capped:  # the cap shortens some rays
        free = _rays_both("cost", False)[0][0][:, 0]
        assert (cost_got[0][:, 0] < free).any()


@functools.lru_cache(maxsize=8)
def _frames_both(mode):
    jeng, jp, teng, tp, bf = tiny()
    want = jeng.render_frame(jp, jnp.asarray(bf), W, H, _cam(), FOCAL, render_mode=mode)
    stats = {}
    got = teng.render_frame(tp, torch.from_numpy(bf), W, H, _cam(), FOCAL,
                            render_mode=mode, stats=stats)
    return [g.numpy() for g in got], [np.asarray(w) for w in want], stats


@pytest.mark.parametrize("mode", [None, "depth", "cost"])
def test_render_frame_matches(mode):
    (rgba, depth), (want_rgba, want_depth), stats = _frames_both(mode)
    cost_got, cost_want, _ = _frames_both("cost")
    same = _agree(cost_got[0][..., 0], cost_want[0][..., 0], depth, want_depth)
    assert rgba.shape == (H, W, 4) and depth.shape == (H, W)
    assert np.isfinite(rgba).all() and stats["rounds"] >= 2
    if mode != "cost":
        assert 0.15 < want_rgba[..., 3].mean() < 0.95
    np.testing.assert_allclose(rgba[same], want_rgba[same], atol=5e-3)
    hit = _frames_both(None)[1][0][..., 3] > 0.5
    assert hit.any() and (depth[hit] > 0.5).all()  # the z-depth of what was hit


def test_render_frame_does_not_depend_on_tile():
    """Per-ray results are the same through a 256-slot buffer (many refills)
    and with a background colour and a subpixel offset."""
    jeng, jp, teng, tp, bf = tiny()
    kw = dict(background=(0.2, 0.5, 0.9), pixel_offset=np.asarray([0.25, 0.75], np.float32))
    want, _ = jeng.render_frame(jp, jnp.asarray(bf), W, H, _cam(), FOCAL, **kw)
    stats = {"sync_phases": True}
    small, d_small = teng.render_frame(tp, torch.from_numpy(bf), W, H, _cam(), FOCAL,
                                       tile=256, stats=stats, **kw)
    big, d_big = teng.render_frame(tp, torch.from_numpy(bf), W, H, _cam(), FOCAL, **kw)
    assert stats["rounds"] > (W * H) // 256  # every slot was refilled
    assert set(stats["phase_s"]) == {"setup", "advance", "march", "eval", "composite",
                                     "flush"}
    assert all(v > 0 for v in stats["phase_s"].values()) and stats["host_wait_s"] >= 0
    np.testing.assert_allclose(small.numpy(), big.numpy(), atol=1e-6)
    np.testing.assert_allclose(d_small.numpy(), d_big.numpy(), atol=1e-6)
    ok = np.abs(big.numpy() - np.asarray(want)).max(-1) <= 5e-3
    assert ok.mean() >= 0.99


@pytest.mark.parametrize("mode", ["positions", "ao", "encoding_vis", "glow", "glow:14:0.6",
                                  "glow:16"])
def test_visualisation_modes_match(mode):
    """The per-sample colours of the other modes, on one marched chunk."""
    jeng, jp, teng, tp, bf = tiny()
    o, d, _ = _ray_batch()
    d = d / np.linalg.norm(d, axis=-1, keepdims=True)
    from sienerf_torch.ops.raymarch import march_rays

    t0 = np.full(len(o), 0.3, np.float32)
    t1 = np.full(len(o), 2.5, np.float32)
    ts, dts, counts, _ = march_rays(teng.march, torch.from_numpy(bf), torch.from_numpy(o),
                                    torch.from_numpy(d), torch.from_numpy(t0),
                                    torch.from_numpy(t1), 16, 48)
    assert counts.sum() > 1000
    want = jeng._mode_sample_colors(jp, jnp.asarray(o), jnp.asarray(d),
                                    jnp.asarray(ts.numpy()), jnp.asarray(dts.numpy()),
                                    jnp.asarray(counts.numpy(), jnp.int32), mode)
    got = teng._mode_sample_colors(tp, torch.from_numpy(o), torch.from_numpy(d), ts, dts,
                                   counts, mode)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=2e-2, atol=5e-3)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=2e-2, atol=5e-3)


@pytest.mark.parametrize("what", ["normals", "distortion", "envmap", "extra_dims",
                                  "bake_render_grid", "unknown_mode", "unknown_renderer"])
def test_unported_parts_raise(what):
    _, _, teng, tp, bf = tiny()
    frame = functools.partial(teng.render_frame, tp, torch.from_numpy(bf), 8, 8, _cam(), FOCAL)
    if what == "distortion":
        # ported: a colour wheel of each pixel's uv shift, black for a
        # pinhole without a distortion map (tests/test_torch_lenses.py holds
        # it to the reference)
        rgba, depth = frame(render_mode=what)
        assert rgba.shape == (8, 8, 4) and float(rgba[..., :3].abs().max()) < 1e-4
        assert bool((depth == 1.0).all())
    elif what == "normals":
        # ported with the hash grid's position gradient; held to the
        # reference in tests/test_torch_normals.py
        rgba, _ = frame(render_mode=what)
        assert rgba.shape == (8, 8, 4) and bool(torch.isfinite(rgba).all())
    elif what == "envmap":
        # ported: the background behind a trained envmap, held to the
        # reference in tests/test_torch_repairs.py
        rgba, _ = teng.render_frame(dict(tp, envmap=torch.zeros((4, 8, 4))),
                                    torch.from_numpy(bf), 8, 8, _cam(), FOCAL)
        assert rgba.shape == (8, 8, 4) and bool(torch.isfinite(rgba).all())
    elif what == "extra_dims":
        import dataclasses

        from sienerf_torch.models.nerf_network import nerf_apply

        # ported: extra dims go between the SH block and the geo features;
        # with zero weights on their rows they change nothing
        # (tests/test_torch_extra_dims.py holds them to the reference)
        net = dataclasses.replace(
            teng.net, n_extra_dims=4,
            rgb_mlp=dataclasses.replace(teng.net.rgb_mlp,
                                        n_input_dims=teng.net.rgb_mlp.n_input_dims + 4))
        w0 = tp["rgb_mlp"][0]
        wide = dict(tp, rgb_mlp=[torch.cat([w0[:16], torch.zeros((4, w0.shape[1])), w0[16:]])]
                    + list(tp["rgb_mlp"][1:]))
        pos, dirw = torch.rand((64, 3)), torch.rand((64, 3))
        plain = nerf_apply(teng.net, tp, pos, dirw)
        for extra in (None, torch.rand((64, 4))):
            got = nerf_apply(net, wide, pos, dirw, extra=extra)
            assert all(torch.equal(a, b) for a, b in zip(got, plain))
    elif what == "bake_render_grid":
        # ported: held to the reference in tests/test_torch_fine_grid.py
        fine = teng.bake_render_grid(tp, {"bitfield": torch.from_numpy(bf),
                                          "mean_density": torch.tensor(0.01)}, factor=2)
        assert fine.shape == (1, 2 * G, 2 * G, 2 * G) and fine.dtype == torch.bool
        rgba, _ = frame(fine_bitfield=fine)
        assert rgba.shape == (8, 8, 4) and bool(torch.isfinite(rgba).all())
    elif what == "unknown_mode":
        with pytest.raises(ValueError):
            frame(render_mode="wireframe")
    else:
        with pytest.raises(ValueError):
            fox_port_session().render(8, 8, renderer="raster")


@pytest.mark.parametrize("spp", [1, 2])
def test_fox_live_frame_matches_reference(spp):
    """The slice as a whole: Session.render(renderer="live") of the fox
    snapshot in both packages."""
    from sienerf_tpu.common import TestbedMode
    from sienerf_tpu.session import Session as JaxSession
    from sienerf_torch.metrics import psnr

    eng, params, bitfield = fox_jax()
    js = JaxSession()
    js.mode = TestbedMode.NERF
    js.engine = eng
    js.state = {"opt": {}, "params": params, "occ": {"bitfield": bitfield}}
    from sienerf_torch.utils.camera import look_at_matrix

    cam = look_at_matrix([2.1, 0.5, 0.6], [0.5, 0.5, 0.5])
    focal = (55.0, 55.0)
    want = js.render(64, 36, cam, focal, spp=spp, renderer="live")
    got = fox_port_session().render(64, 36, cam, focal, spp=spp, renderer="live").numpy()
    assert got.shape == (36, 64, 4) and np.isfinite(got).all()
    assert got[..., 3].mean() > 0.5 and got[..., :3].std() > 1e-2
    ok = np.abs(got - want) <= 5e-3 + 2e-2 * np.abs(want)
    assert ok.all(axis=-1).mean() >= 0.99
    assert psnr(got[..., :3], want[..., :3]) > 40.0
