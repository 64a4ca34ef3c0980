"""The baked renderer's integer and lookup ops, port vs reference, on
seeded numpy inputs and on an R=16 bake of the committed fox field.

Bit-equal: the packed bit and byte tables and their lookups (the brick
probe with its head budget overflowing), the exact.py routes, the
live-bit sidecars and the distance fields, the run merge and both
compactions, every sidecar of the R=16 fox bake, and the brick and cell
rows packed from one vertex table.  The feature lookups (nearest,
trilinear, bricks) on one bake carried across by convert.baked_grid_from_jax:
rtol 1e-6 / atol 1e-6.  The candidate chain: ts to rtol 1e-6; the nearest
vertex of each candidate exactly, except where a candidate lies within 1e-5
of a Voronoi face of the lattice (XLA may contract `t0 + j*dmin` into a
fused multiply-add and move it by an ulp), which the test counts.  The
colour MLP on baked features: rtol 2e-2 / atol 2e-3 (tests/test_torch_live.py
NET_TOL)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_snapshot import fox_jax, fox_jax_baked_grid, fox_port_session

NET_TOL = dict(rtol=2e-2, atol=2e-3)
FEAT_TOL = dict(rtol=1e-6, atol=1e-6)


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


def _i32(a) -> np.ndarray:
    """uint32 words (the reference's) as int32 with the same bits."""
    return np.ascontiguousarray(np.asarray(a)).view(np.int32)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


# --- packed bits and bytes -----------------------------------------------------


@pytest.mark.parametrize("n", [1, 127, 128, 1000, 4099])
def test_pack_and_lookup_bits(n):
    from sienerf_torch.ops import bits as tb
    from sienerf_tpu.ops import bits as jb

    rng = np.random.default_rng(n)
    keep = rng.random(n) < 0.4
    words = tb.pack_bits(_t(keep))
    np.testing.assert_array_equal(words.numpy(), _i32(jb.pack_bits(jnp.asarray(keep))))
    flat = rng.integers(0, n, 3000)
    np.testing.assert_array_equal(tb.lookup_bits(words, _t(flat)).numpy(), keep[flat])
    np.testing.assert_array_equal(
        tb.lookup_bits(words, _t(flat)).numpy(),
        np.asarray(jb.lookup_bits(jb.pack_bits(jnp.asarray(keep)), jnp.asarray(flat))))


def test_occupancy_packs_with_the_same_bits():
    from sienerf_torch.ops.bits import pack_bits
    from sienerf_torch.ops.occupancy import pack_occupancy

    bf = torch.rand((2, 16, 16, 16), generator=torch.Generator().manual_seed(0)) < 0.3
    assert torch.equal(pack_occupancy(bf), pack_bits(bf.reshape(-1)))


@pytest.mark.parametrize("dims", [(2, 9, 9, 9), (1, 17, 5, 33), (3, 8, 8, 8)])
def test_pack_bits_brick_and_probe_ids(dims):
    from sienerf_torch.ops import bits as tb
    from sienerf_tpu.ops import bits as jb

    rng = np.random.default_rng(sum(dims))
    K, X, Y, Z = dims
    keep = rng.random(K * X * Y * Z) < 0.3
    words = tb.pack_bits_brick(_t(keep), dims)
    np.testing.assert_array_equal(words.numpy(),
                                  _i32(jb.pack_bits_brick(jnp.asarray(keep), dims)))
    n = 500
    k3 = np.stack([rng.integers(0, X, n), rng.integers(0, Y, n), rng.integers(0, Z, n)], -1)
    casc = rng.integers(0, K, n)
    row, off = tb.brick_probe_ids(_t(k3), _t(casc), dims)
    jrow, joff = jb.brick_probe_ids(jnp.asarray(k3, jnp.int32), jnp.asarray(casc, jnp.int32),
                                    dims)
    np.testing.assert_array_equal(row.numpy(), np.asarray(jrow))
    np.testing.assert_array_equal(off.numpy(), np.asarray(joff))
    got = tb.lookup_bits_brick(words, row[None], off[None], n_heads=n)
    flat = ((casc * X + k3[:, 0]) * Y + k3[:, 1]) * Z + k3[:, 2]
    np.testing.assert_array_equal(got[0].numpy(), keep[flat])


@pytest.mark.parametrize("n_heads", [1, 2, 4, 16])
def test_lookup_bits_brick_dedup_and_head_overflow(n_heads):
    """Chain-shaped probes: runs of one row, rows past the head budget kept."""
    from sienerf_torch.ops import bits as tb
    from sienerf_tpu.ops import bits as jb

    rng = np.random.default_rng(n_heads)
    words = rng.integers(0, 2 ** 32, (64, 4), dtype=np.uint64).astype(np.uint32)
    A, P = 40, 24
    steps = rng.random((A, P)) < 0.3  # a new row where a step lands
    row = np.cumsum(steps, axis=1) + rng.integers(0, 40, (A, 1))
    row = np.minimum(row, 63).astype(np.int32)
    off = rng.integers(0, 128, (A, P)).astype(np.int32)
    want = np.asarray(jb.lookup_bits_brick(jnp.asarray(words), jnp.asarray(row),
                                           jnp.asarray(off), n_heads))
    got = tb.lookup_bits_brick(_t(_i32(words)), _t(row), _t(off), n_heads)
    np.testing.assert_array_equal(got.numpy(), want)
    head, slot, ovf, ids = tb.run_slots(_t(row), n_heads)
    assert bool(ovf.any()) == (n_heads < int(slot.max()) + 1)


@pytest.mark.parametrize("n", [1, 16, 333, 4096])
def test_pack_and_lookup_bytes(n):
    from sienerf_torch.ops import bits as tb
    from sienerf_tpu.ops import bits as jb

    rng = np.random.default_rng(n)
    vals = rng.integers(0, 256, n)
    rows = tb.pack_bytes(_t(vals))
    jrows = jb.pack_bytes(jnp.asarray(vals, jnp.int32))
    np.testing.assert_array_equal(rows.numpy(), _i32(jrows))
    flat = rng.integers(0, n, 2000)
    got = tb.lookup_bytes(rows, _t(flat)).numpy()
    np.testing.assert_array_equal(got, vals[flat])
    np.testing.assert_array_equal(got, np.asarray(jb.lookup_bytes(jrows, jnp.asarray(flat))))


# --- exact.py -------------------------------------------------------------------


def _onehots(rng, A, P, S, empty=0.2):
    """(A, P, S) one-hot rows, some all zero, at most one p per (a, s)."""
    sel = np.zeros((A, P, S), bool)
    for a in range(A):
        ps = rng.permutation(P)[:S]
        for s, p in enumerate(ps):
            if rng.random() > empty:
                sel[a, p, s] = True
    return sel


def test_exact_routes_match_reference():
    from sienerf_torch.ops import exact as te
    from sienerf_tpu.ops import exact as je

    rng = np.random.default_rng(5)
    A, P, S, W = 6, 12, 7, 4
    words = rng.integers(0, 2 ** 32, (A, S, W), dtype=np.uint64).astype(np.uint32)
    sel = np.zeros((A, P, S), bool)
    pick = rng.integers(0, S, (A, P))
    sel[np.arange(A)[:, None], np.arange(P)[None], pick] = rng.random((A, P)) < 0.8
    got = te.onehot_select_u32(_t(sel), _t(_i32(words)))
    np.testing.assert_array_equal(got.numpy(),
                                  _i32(je.onehot_select_u32(jnp.asarray(sel), jnp.asarray(words))))
    csel = _onehots(rng, A, P, S)
    pwords = rng.integers(0, 2 ** 32, (A, P, W), dtype=np.uint64).astype(np.uint32)
    got = te.onehot_compact_u32(_t(csel), _t(_i32(pwords)))
    np.testing.assert_array_equal(
        got.numpy(), _i32(je.onehot_compact_u32(jnp.asarray(csel), jnp.asarray(pwords))))
    vals = rng.integers(0, 2 ** 31 - 1, (A, P)).astype(np.int32)
    got = te.onehot_compact_i32(_t(csel), _t(vals))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(je.onehot_compact_i32(jnp.asarray(csel), jnp.asarray(vals))))
    # exact_einsum routes f32 payloads (integers < 2^24, floats) exactly
    pay = np.concatenate([rng.integers(0, 2 ** 24, (A, P, 1)).astype(np.float32),
                          rng.normal(size=(A, P, 2)).astype(np.float32)], axis=-1)
    got = te.exact_einsum("aps,apv->asv", _t(csel.astype(np.float32)), _t(pay))
    want = je.exact_einsum("aps,apv->asv", jnp.asarray(csel, jnp.float32), jnp.asarray(pay))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# --- sidecars and the distance field ----------------------------------------


@pytest.mark.parametrize("R,K", [(16, 1), (16, 3), (24, 2)])
def test_live_bit_sidecars(R, K):
    from sienerf_torch.ops import baked as tk
    from sienerf_tpu.ops import baked as jk

    rng = np.random.default_rng(R + K)
    live = rng.random(K * (R + 1) ** 3) < 0.05
    for name in ("coarse_live_bits", "coarse_live_bits_brick", "trilinear_live_bits",
                 "scout_live_bits"):
        got = getattr(tk, name)(_t(live), R, K)
        want = getattr(jk, name)(jnp.asarray(live), R, K)
        np.testing.assert_array_equal(got.numpy(), _i32(want), err_msg=name)
    got = tk.dist_live_cells(_t(live), R, K)
    np.testing.assert_array_equal(got.numpy(), _i32(jk.dist_live_cells(jnp.asarray(live), R, K)))


@pytest.mark.parametrize("K,G,density", [(1, 16, 0.01), (3, 16, 0.002), (2, 32, 0.0005)])
def test_dist_occupancy_cells(K, G, density):
    from sienerf_torch.ops.baked import dist_occupancy_cells
    from sienerf_torch.ops.bits import lookup_bytes
    from sienerf_tpu.ops.baked import dist_occupancy_cells as jax_dist

    rng = np.random.default_rng(G + K)
    bf = rng.random((K, G, G, G)) < density
    got = dist_occupancy_cells(_t(bf))
    np.testing.assert_array_equal(got.numpy(), _i32(jax_dist(jnp.asarray(bf))))
    D = lookup_bytes(got, torch.arange(K * G ** 3)).numpy()
    assert D.min() == 0 and D.max() > 1


# --- run merge, compaction ------------------------------------------------------


@pytest.mark.parametrize("max_run", [2, 5, 12, 30])
def test_merge_same_vertex_runs(max_run):
    from sienerf_torch.ops.baked import merge_same_vertex_runs
    from sienerf_tpu.ops.baked import merge_same_vertex_runs as jax_merge

    rng = np.random.default_rng(max_run)
    A, P = 50, 32
    flat = np.cumsum(rng.random((A, P)) < 0.3, axis=1).astype(np.int32)
    keep = rng.random((A, P)) < 0.8
    dts = rng.uniform(1e-3, 1e-2, (A, P)).astype(np.float32)
    head, dt = merge_same_vertex_runs(_t(flat), _t(keep), _t(dts), max_run)
    jh, jd = jax_merge(jnp.asarray(flat), jnp.asarray(keep), jnp.asarray(dts), max_run)
    np.testing.assert_array_equal(head.numpy(), np.asarray(jh))
    np.testing.assert_array_equal(dt.numpy(), np.asarray(jd))


@pytest.mark.parametrize("n_keep", [1, 9, 33, 48])
def test_compactions(n_keep):
    from sienerf_torch.ops import baked as tk
    from sienerf_tpu.ops import baked as jk

    rng = np.random.default_rng(n_keep)
    A, P = 64, 40
    keep = rng.random((A, P)) < 0.35
    keep[0] = False
    keep[1] = True
    ts = np.cumsum(rng.random((A, P)), axis=1).astype(np.float32)
    dts = rng.random((A, P)).astype(np.float32)
    ids = rng.integers(0, 1 << 20, (A, P)).astype(np.int32)
    args = (_t(keep), n_keep, _t(ts), _t(dts), _t(ids))
    jargs = (jnp.asarray(keep), n_keep, jnp.asarray(ts), jnp.asarray(dts), jnp.asarray(ids))
    for got, want in zip(tk.compact_candidates(*args), jk.compact_candidates(*jargs)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for got, want in zip(tk.compact_candidates_onehot(*args),
                         jk.compact_candidates_onehot(*jargs)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# --- the fox bake: sidecars, packed rows, feature lookups -------------------


@pytest.mark.parametrize("mode", ["nearest", "trilinear"])
def test_fox_bake_sidecars_bit_equal(mode):
    """Every sidecar of an R=16 fox bake in both packages.  The rows
    themselves are held to 1 LSB in tests/test_torch_bake.py."""
    from sienerf_torch.convert import baked_grid_from_jax

    jgrid, _ = fox_jax_baked_grid(16, mode)
    s = fox_port_session()
    grid, meta = s.engine.bake_features(s.render_params(), s.state["occ"], resolution=16,
                                        mode=mode)
    ref = baked_grid_from_jax(jgrid, "cpu")
    sidecars = {"bits", "bits2", "bits2b", "bits3", "dist3d"} | (
        {"bits2t"} if mode == "trilinear" else {"brows"})
    assert set(grid) == set(ref) == sidecars | {"rows", "scale"}
    for k in sidecars - {"brows"}:
        assert torch.equal(grid[k], ref[k]), k
    assert grid["rows"].shape == ref["rows"].shape and grid["rows"].dtype == torch.int16
    if mode == "nearest":
        assert grid["brows"].shape == ref["brows"].shape


@pytest.mark.parametrize("row_bits", [8, 16])
def test_packed_bricks_and_cells_from_one_vertex_table(row_bits):
    from sienerf_torch.convert import baked_grid_from_jax
    from sienerf_torch.ops.baked import pack_bricks_from_vertices, pack_cells_from_vertices
    from sienerf_tpu.ops import baked as jk

    jgrid, meta = fox_jax_baked_grid(16, "nearest", row_bits)
    R, K = meta["resolution"], meta["n_cascades"]
    ref = baked_grid_from_jax(jgrid, "cpu")
    assert ref["rows"].dtype == (torch.int8 if row_bits == 8 else torch.int16)
    assert torch.equal(pack_bricks_from_vertices(ref["rows"], R, K, chunk=1000), ref["brows"])
    cells = baked_grid_from_jax({"rows": np.asarray(jk.pack_cells_from_vertices(
        jnp.asarray(jgrid["rows"]), R, K))}, "cpu")["rows"]
    assert torch.equal(pack_cells_from_vertices(ref["rows"], R, K, chunk=5000), cells)


def _positions(rng, n, spread=1.4):
    return (0.5 + rng.uniform(-spread, spread, (n, 3))).astype(np.float32)


@pytest.mark.parametrize("mode,row_bits", [("nearest", 16), ("nearest", 8), ("trilinear", 16)])
def test_baked_features_on_one_bake(mode, row_bits):
    from sienerf_torch.convert import baked_grid_from_jax
    from sienerf_torch.ops.baked import baked_features
    from sienerf_tpu.ops.baked import baked_features as jax_features

    jgrid, meta = fox_jax_baked_grid(16, mode, row_bits)
    grid = baked_grid_from_jax(jgrid, "cpu")
    rng = np.random.default_rng(row_bits)
    pos = np.concatenate([_positions(rng, 3000), _positions(rng, 3000, 0.3)])
    R, K = meta["resolution"], meta["n_cascades"]
    got = baked_features(grid["rows"], grid["scale"], R, K, mode, _t(pos)).numpy()
    want = np.asarray(jax_features(jnp.asarray(jgrid["rows"]), jnp.asarray(jgrid["scale"]),
                                   R, K, mode, jnp.asarray(pos)))
    np.testing.assert_allclose(got, want, **FEAT_TOL)
    live = got[:, 0] > -99.0
    assert 0.01 < live.mean() < 0.9


@pytest.mark.parametrize("n_heads", [2, 6, 24])
def test_baked_features_brick_on_one_bake(n_heads):
    """Chain-shaped survivors: the brick lookup with its head overflow, at
    8-bit rows (256-byte bricks, G2) and 16-bit rows (512-byte bricks,
    G1); and equal to the row lookup wherever no overflow."""
    from sienerf_torch.convert import baked_grid_from_jax
    from sienerf_torch.ops.baked import baked_features, baked_features_brick
    from sienerf_tpu.ops.baked import baked_features_brick as jax_brick

    rng = np.random.default_rng(n_heads)
    A, E = 64, 24
    o = rng.uniform(0.3, 0.7, (A, 1, 3))
    d = rng.normal(size=(A, 1, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    pos = (o + d * np.arange(E)[None, :, None] * 0.02).astype(np.float32)
    for row_bits in (8, 16):
        jgrid, meta = fox_jax_baked_grid(16, "nearest", row_bits)
        grid = baked_grid_from_jax(jgrid, "cpu")
        R, K = meta["resolution"], meta["n_cascades"]
        feats, ovf = baked_features_brick(grid["brows"], grid["scale"], R, K, _t(pos), n_heads)
        jf, jo = jax_brick(jnp.asarray(jgrid["brows"]), jnp.asarray(jgrid["scale"]), R, K,
                           jnp.asarray(pos), n_heads)
        np.testing.assert_array_equal(ovf.numpy(), np.asarray(jo))
        np.testing.assert_allclose(feats.numpy(), np.asarray(jf), **FEAT_TOL)
        rowf = baked_features(grid["rows"], grid["scale"], R, K, "nearest",
                              _t(pos.reshape(-1, 3))).reshape(A, E, -1)
        ok = ~ovf
        assert torch.equal(feats[ok], rowf[ok])
        assert bool(ovf.any()) == (n_heads < 24)


def test_baked_grid_from_jax_layouts():
    from sienerf_torch.convert import baked_grid_from_jax

    rng = np.random.default_rng(0)
    v16 = rng.integers(-32768, 32768, (5, 16)).astype(np.int16)
    v8 = rng.integers(-128, 128, (5, 16)).astype(np.int8)
    c16 = rng.integers(-32768, 32768, (5, 128)).astype(np.int16)
    b8 = rng.integers(-128, 128, (5, 256)).astype(np.int8)
    words = rng.integers(0, 2 ** 32, (7, 4), dtype=np.uint64).astype(np.uint32)
    for src in ({"rows": v16.view(np.int32), "brows": np.repeat(v16, 16, 1).view(np.int32)},
                {"rows": v8.view(np.int32), "brows": b8.view(np.int32)},
                {"rows": c16.view(np.int32)}):
        got = baked_grid_from_jax(dict(src, bits=words, scale=np.ones((3, 16))), "cpu")
        for k, v in src.items():
            assert got[k].numpy().tobytes() == v.tobytes()
            assert got[k].shape[1] in (16, 128, 256)
        assert got["bits"].dtype == torch.int32 and got["bits"].numpy().tobytes() == \
            words.tobytes()
        assert got["scale"].dtype == torch.float32


# --- the candidate chain and the colour MLP -----------------------------------


def _voronoi_margin(pos, R, K):
    """World distance of each position to the nearest face of its nearest-
    vertex cell (or its cascade's boundary)."""
    from sienerf_torch.ops.occupancy import mip_from_pos

    m = mip_from_pos(_t(pos), K).numpy()
    ext = 2.0 ** m
    u = (pos - 0.5) / ext[..., None] + 0.5
    x = u * R
    face = np.abs(x - np.floor(x) - 0.5).min(axis=-1) * ext / R
    casc = np.abs(np.abs(pos - 0.5).max(axis=-1) - 0.5 * ext)
    return np.minimum(face, casc)


@pytest.mark.parametrize("cone", [0.0, 1.0 / 256.0])
def test_candidate_chain(cone):
    from sienerf_torch.engines.nerf_baked import _candidate_chain
    from sienerf_torch.ops.baked import nearest_vertex_ids
    from sienerf_tpu.engines.nerf_baked import _candidate_chain as jax_chain

    rng = np.random.default_rng(7)
    N, P, R, K = 2000, 128, 32, 3
    t0 = rng.uniform(0.05, 4.0, N).astype(np.float32)
    o = rng.uniform(-1.0, 2.0, (N, 3)).astype(np.float32)
    d = rng.normal(size=(N, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    for step in (1.0, 4.0):
        ts, dts, t_end = _candidate_chain(_t(t0), cone, P, step)
        jts, jdts, jend = jax.jit(jax_chain, static_argnums=(1, 2, 3))(
            jnp.asarray(t0), cone, P, step)
        np.testing.assert_allclose(ts.numpy(), np.asarray(jts), rtol=1e-6)
        np.testing.assert_allclose(dts.numpy(), np.asarray(jdts), rtol=1e-6)
        np.testing.assert_allclose(t_end.numpy(), np.asarray(jend), rtol=1e-6)
        pos = o[:, None] + ts.numpy()[..., None] * d[:, None]
        jpos = o[:, None] + np.asarray(jts)[..., None] * d[:, None]
        a = nearest_vertex_ids(R, K, _t(pos))[0].numpy()
        b = nearest_vertex_ids(R, K, _t(jpos))[0].numpy()
        flips = a != b
        margin = _voronoi_margin(pos.reshape(-1, 3), R, K).reshape(N, P)
        assert (margin[flips] < 1e-5).all(), "a vertex flip away from a cell face"
        assert flips.sum() <= 1e-4 * flips.size, f"{int(flips.sum())} boundary flips"


def test_colors_from_raw():
    from sienerf_torch.engines.nerf_baked import _colors_from_raw
    from sienerf_tpu.engines.nerf_baked import _colors_from_raw as jax_colors

    jeng, jp, _ = fox_jax()
    s = fox_port_session()
    rng = np.random.default_rng(3)
    A, P = 64, 8
    raw = rng.normal(0, 2.0, (A * P, 16)).astype(np.float32)
    raw[::7, 0] = -100.0
    d = rng.normal(size=(A, 3)).astype(np.float32)
    valid = rng.random((A, P)) < 0.8
    rgb, dens = _colors_from_raw(s.engine, s.render_params(), _t(raw), _t(d), (A, P), _t(valid))
    jrgb, jdens = jax_colors(jeng, jp, jnp.asarray(raw), jnp.asarray(d), (A, P),
                             jnp.asarray(valid))
    np.testing.assert_allclose(rgb.numpy(), np.asarray(jrgb), **NET_TOL)
    np.testing.assert_allclose(dens.numpy(), np.asarray(jdens), **NET_TOL)
    assert (dens.numpy()[~valid] == 0).all()
