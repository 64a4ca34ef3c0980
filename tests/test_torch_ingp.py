"""Reference .ingp snapshots, port vs reference: the file codec, the Morton
order of the density grid, tcnn's parameter layout, the cell <-> corner
table conversions, import / export, the corner-layout hash-grid forward
(and its table gradient), and an engine built by NerfEngine.from_ingp.

Tolerances: the codec, the layouts and the conversions are exact (the same
numpy arithmetic); export writes the same bytes.  The corner-layout forward
and the imported engine's nerf_apply: rtol 1e-5 / atol 1e-6 (the same f32
operations; only the order of one sum of eight corner terms can differ).
The imported occupancy bitfield equals the reference's except cells whose
density lies between the two packages' means of cascade 0 (the
threshold): the reference's f32 mean of 16^3 values is a few 1e-4 off its
float64 value (the same bound tests/test_torch_train.py holds it to),
the port's is not."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_nerf_mode import make_dataset
from test_torch_snapshot_io import jax_state
from test_torch_train import small_config


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


@functools.lru_cache(maxsize=1)
def exported():
    """A JAX engine's seeded state exported as .ingp (cell table -> corner
    rows) -> (path, JAX engine)."""
    import tempfile
    from pathlib import Path

    from sienerf_tpu.engines.nerf import NerfEngine
    from sienerf_tpu.io.ingp import export_ingp

    eng = NerfEngine.create(small_config(), make_dataset(), grid_size=16)
    st = jax_state()
    path = Path(tempfile.mkdtemp()) / "a.ingp"
    export_ingp(path, small_config(), st["params"], eng.net.grid, eng.net.density_mlp,
                eng.net.rgb_mlp, density_grid=np.asarray(st["occ"]["density"]),
                aabb_scale=1.0, training_step=37, loss=0.25)
    return path, eng


def test_import_equals_the_reference():
    from sienerf_tpu.io import ingp as ji
    from sienerf_torch.io import ingp as ti

    path, _ = exported()
    a, b = ji.import_ingp(path), ti.import_ingp(path)
    assert a["config"] == b["config"] and a["meta"] == b["meta"]
    np.testing.assert_array_equal(a["density_grid"], b["density_grid"])
    for k in ("density_mlp", "rgb_mlp"):
        for x, y in zip(a["params"][k], b["params"][k]):
            np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(a["params"]["grid"], b["params"]["grid"])
    assert ti.load_ingp(path) == ji.load_ingp(path)


def test_export_writes_the_same_bytes(tmp_path):
    from sienerf_tpu.io import ingp as ji
    from sienerf_torch.io import ingp as ti

    path, eng = exported()
    st = jax_state()
    for compress in (True, False):
        out = tmp_path / f"b{int(compress)}.ingp"
        ti.export_ingp(out, small_config(), st["params"], eng.net.grid, eng.net.density_mlp,
                       eng.net.rgb_mlp, density_grid=np.asarray(st["occ"]["density"]),
                       aabb_scale=1.0, training_step=37, loss=0.25, compress=compress)
        ref = tmp_path / f"r{int(compress)}.ingp"
        ji.export_ingp(ref, small_config(), st["params"], eng.net.grid, eng.net.density_mlp,
                       eng.net.rgb_mlp, density_grid=np.asarray(st["occ"]["density"]),
                       aabb_scale=1.0, training_step=37, loss=0.25, compress=compress)
        assert out.read_bytes() == ref.read_bytes()


@pytest.mark.parametrize("g", [2, 8, 16])
def test_morton_order(g):
    from sienerf_tpu.io import ingp as ji
    from sienerf_torch.io import ingp as ti

    grid = np.random.default_rng(g).random((2, g, g, g)).astype(np.float32)
    m = ti.density_grid_to_morton(grid)
    np.testing.assert_array_equal(m, ji.density_grid_to_morton(grid))
    np.testing.assert_array_equal(ti.density_grid_from_morton(m, g), grid)


def _grid_cfgs():
    from sienerf_tpu.ops.hashgrid import HashGridConfig as J
    from sienerf_torch.ops.hashgrid import HashGridConfig as T

    kw = dict(n_levels=4, n_features_per_level=2, log2_hashmap_size=10, base_resolution=4,
              per_level_scale=2.0)
    return J(**kw), T(**kw)


def test_cell_corner_conversions_equal():
    from sienerf_tpu.io import ingp as ji
    from sienerf_torch.io import ingp as ti

    jc, tc = _grid_cfgs()
    rng = np.random.default_rng(0)
    cell = rng.standard_normal((4, 1 << 10, 8, 2)).astype(np.float32)
    corner = ti.cell_to_corner_table(tc, cell)
    np.testing.assert_array_equal(corner, ji.cell_to_corner_table(jc, cell))
    jcc, tcc = (dataclasses.replace(c, layout="corner") for c in (jc, tc))
    np.testing.assert_array_equal(ti.corner_to_cell_table(tcc, corner),
                                  ji.corner_to_cell_table(jcc, corner))
    with pytest.raises(ValueError, match="max_cells"):
        ti.corner_to_cell_table(tcc, corner, max_cells=8)


def test_tcnn_split_join_equal():
    from sienerf_tpu.io import ingp as ji
    from sienerf_torch.io import ingp as ti

    path, eng = exported()
    n = eng.net
    grid = dataclasses.replace(n.grid, layout="corner")
    flat = np.random.default_rng(1).standard_normal(200000).astype(np.float32)
    from sienerf_torch.ops.hashgrid import HashGridConfig
    from sienerf_torch.ops.mlp import MLPConfig

    tg = HashGridConfig(**dataclasses.asdict(grid))
    td, tr = (MLPConfig(**dataclasses.asdict(m)) for m in (n.density_mlp, n.rgb_mlp))
    a = ji.split_tcnn_params(flat, grid, n.density_mlp, n.rgb_mlp)
    b = ti.split_tcnn_params(flat, tg, td, tr)
    for k in ("density_mlp", "rgb_mlp"):
        for x, y in zip(a[k], b[k]):
            np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(a["grid"], b["grid"])
    np.testing.assert_array_equal(ti.join_tcnn_params(b, tg, td, tr),
                                  ji.join_tcnn_params(a, grid, n.density_mlp, n.rgb_mlp))
    assert ti.tcnn_grid_level_sizes(tg) == ji.tcnn_grid_level_sizes(grid)


@pytest.mark.parametrize("log2,levels", [(10, 6), (19, 4)])
def test_corner_layout_forward_matches(log2, levels):
    from sienerf_tpu.ops import hashgrid as jh
    from sienerf_torch.ops import hashgrid as th

    kw = dict(n_levels=levels, n_features_per_level=2, log2_hashmap_size=log2,
              base_resolution=4, per_level_scale=1.8, layout="corner")
    rng = np.random.default_rng(log2)
    table = rng.standard_normal((levels, 1 << log2, 2)).astype(np.float32)
    pos = rng.random((2000, 3)).astype(np.float32)
    pos[:10] = [0.0, 1.0, 0.5]  # the box's faces
    want = jh.hashgrid_encode(jh.HashGridConfig(**kw), jnp.asarray(table), jnp.asarray(pos))
    got = th.hashgrid_encode(th.HashGridConfig(**kw), torch.from_numpy(table),
                             torch.from_numpy(pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    # the corner layout trains: its table gradient is the reference's
    # (held in full in tests/test_torch_corner.py)
    g = rng.standard_normal((2000, 2 * levels)).astype(np.float32)
    _, vjp = jax.vjp(lambda t: jh.hashgrid_encode(jh.HashGridConfig(**kw), t, jnp.asarray(pos)),
                     jnp.asarray(table))
    jd = np.asarray(vjp(jnp.asarray(g))[0])
    t = torch.from_numpy(table).requires_grad_()
    th.hashgrid_encode(th.HashGridConfig(**kw), t, torch.from_numpy(pos)).backward(
        torch.from_numpy(g))
    np.testing.assert_allclose(t.grad.numpy(), jd, rtol=1e-5, atol=1e-6 * np.abs(jd).max())


def test_from_ingp_engine_matches_the_reference():
    from sienerf_tpu.engines.nerf import NerfEngine as JE
    from sienerf_tpu.models.nerf_network import nerf_apply as japply
    from sienerf_torch.engines.nerf import NerfEngine as TE
    from sienerf_tpu.ops.hashgrid import hashgrid_encode as jhash
    from sienerf_torch.models.nerf_network import nerf_apply
    from sienerf_torch.ops.hashgrid import hashgrid_encode as thash
    from sienerf_torch.ops.mlp import tap_roundings

    path, _ = exported()
    je, js = JE.from_ingp(path)
    te, ts = TE.from_ingp(path, device="cpu")
    assert te.net.grid.layout == "corner" and ts["step"] == int(js["step"]) == 37
    assert te.net.grid.level_is_dense(0) == je.net.grid.level_is_dense(0)
    rng = np.random.default_rng(2)
    x = rng.random((4096, 3)).astype(np.float32)
    d = rng.random((4096, 3)).astype(np.float32)
    jr, jd = japply(je.net, js["params"], jnp.asarray(x), jnp.asarray(d))
    # the encoding in f32; then the network from the reference's bf16
    # rounding of it: a feature one f32 ulp from a bf16 rounding boundary
    # can round the other way (1 of 4096 x 16 here) and move its sample's
    # output by ~1e-3, as tests/test_torch_network.py explains
    jenc = np.asarray(jhash(je.net.grid, js["params"]["grid"], jnp.asarray(x)))
    tenc = thash(te.net.grid, ts["params"]["grid"], torch.from_numpy(x))
    np.testing.assert_allclose(tenc.numpy(), jenc, rtol=1e-5, atol=1e-6)
    j16 = torch.from_numpy(jenc).to(torch.bfloat16).float()
    with tap_roundings(replace=[j16]):
        tr, td = nerf_apply(te.net, ts["params"], torch.from_numpy(x), torch.from_numpy(d))
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-5, atol=1e-6)
    # the occupancy: equal but for cells between the two packages' thresholds
    jb, tb = np.asarray(js["occ"]["bitfield"]), ts["occ"]["bitfield"].numpy()
    dens = ts["occ"]["density"].numpy()
    lo, hi = sorted((float(js["occ"]["mean_density"]), float(ts["occ"]["mean_density"])))
    assert abs(hi - lo) <= 1e-3 * hi
    between = (dens >= lo) & (dens <= hi)
    assert np.array_equal(jb[~between], tb[~between]) and jb.sum() > 100
    np.testing.assert_array_equal(ts["occ"]["density"].numpy(), np.asarray(js["occ"]["density"]))


def test_session_loads_an_ingp_snapshot():
    from sienerf_torch.session import Session

    path, _ = exported()
    s = Session(device="cpu")
    s.load_snapshot(path)
    assert s.engine.net.grid.layout == "corner" and s.training_step == 37
    img = s.render(12, 8, s.engine.xforms[0], (10.0, 10.0))
    assert img.shape == (8, 12, 4) and bool(torch.isfinite(img).all())
