"""The CUDA kernels K1 (shade), K2 (sweep composite), G1 and G2 (the row
gathers of the gather probe and of the baked renderer) against their plain
PyTorch versions, the baked frame through them against the plain frame,
and the rule that a kernel wrapper never falls back.

Tests marked `cuda` need an NVIDIA card and nvcc; they skip elsewhere.
This file imports no JAX, so on the card it runs without the repo's
conftest:  python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from sienerf_torch.common import NerfActivation
from sienerf_torch.ops import cuda_lib, gather, shade, sweep_kernel
from sienerf_torch.ops.gather import (
    gather_rows,
    gather_rows_plain,
    gather_small,
    gather_small_plain,
)
from sienerf_torch.ops.shade import _shade_general, shade_volume, shade_volume_plain
from sienerf_torch.ops.sweep_kernel import sweep_composite_kernel, sweep_composite_plain

FOX = Path(__file__).resolve().parent.parent / "data" / "fox_render.snap"
ACTS = dict(density_act=NerfActivation.EXPONENTIAL, rgb_act=NerfActivation.LOGISTIC)


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _shade_inputs(R=8, K=3, seed=0, device="cpu", culled=0.3):
    rng = np.random.default_rng(seed)
    Rv = R + 1
    rows = rng.integers(-32767, 32768, (K * Rv ** 3, 16)).astype(np.int16)
    rows[rng.random(K * Rv ** 3) < culled] = -32768  # culled vertices
    scale = rng.uniform(2e-5, 2e-4, (K, 16)).astype(np.float32)
    ws = [rng.normal(0, s, shp).astype(np.float32)
          for s, shp in ((0.3, (32, 64)), (0.2, (64, 64)), (0.2, (64, 3)))]
    cam = np.asarray([0.1, 1.4, -0.6], np.float32)
    t = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
    return t(rows), t(scale), t(cam), [t(w) for w in ws]


def _sweep_inputs(R=16, K=2, Hi=32, Wi=128, seed=0, device="cpu", channel_last=False):
    """A camera on -x and a volume: contiguous channel-planar
    (K, R+1, 4, R+1, R+1), or with channel_last the same values as
    channel-last storage (K, R+1, R+1, R+1, 4)."""
    rng = np.random.default_rng(seed)
    Rv = R + 1
    vol = rng.uniform(0, 1, (K, Rv, Rv, Rv, 4)).astype(np.float32)
    vol[..., 3] *= 4.0
    vol[:, : Rv // 4, :, :, 3] = 0.0
    if not channel_last:
        vol = np.ascontiguousarray(vol.transpose(0, 1, 4, 2, 3))
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(device)  # noqa: E731
    o_c = t([-0.7, 0.45, 0.55])
    eb = t(np.linspace(-0.4, 0.5, Hi))
    ec = t(np.linspace(-0.45, 0.4, Wi))
    stop = t(np.linspace(0.3, 1.6, Hi)[:, None] * np.ones((1, Wi)))
    return t(vol).to(torch.bfloat16), o_c, eb, ec, stop


# --- no fallback (runs everywhere) ------------------------------------------


def test_wrappers_reject_other_devices_without_falling_back(monkeypatch):
    def boom(*a, **k):
        raise AssertionError("plain version reached for a non-CPU tensor")

    monkeypatch.setattr(shade, "shade_volume_plain", boom)
    monkeypatch.setattr(sweep_kernel, "sweep_composite_plain", boom)
    n0 = (shade_volume.launches, sweep_composite_kernel.launches)
    rows, scale, cam, ws = _shade_inputs(R=4, K=1)
    with pytest.raises(ValueError):
        shade_volume(rows.to("meta"), scale, cam, ws, resolution=4, n_cascades=1, **ACTS)
    vol, o_c, eb, ec, _ = _sweep_inputs(R=4, K=1, Hi=8, Wi=8)
    with pytest.raises(ValueError):
        sweep_composite_kernel(vol.to("meta"), o_c, eb, ec, 0.05, 1e-4,
                               resolution=4, n_cascades=1)
    assert (shade_volume.launches, sweep_composite_kernel.launches) == n0


def test_build_raises_without_nvcc(monkeypatch):
    monkeypatch.setattr(cuda_lib.shutil, "which", lambda name: None)
    monkeypatch.setattr(cuda_lib.os.path, "exists", lambda p: False)
    with pytest.raises(RuntimeError, match="nvcc"):
        cuda_lib.build(force=True)


def test_cuda_session_raises_on_cpu_only_box():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    from sienerf_torch.session import Session

    with pytest.raises((RuntimeError, AssertionError)):
        Session().load_snapshot(FOX)  # the default device is the card


def test_plain_wrappers_on_cpu_agree_with_plain_versions():
    rows, scale, cam, ws = _shade_inputs(R=4, K=2)
    a = shade_volume(rows, scale, cam, ws, resolution=4, n_cascades=2, **ACTS)
    b = shade_volume_plain(rows, scale, cam, ws, resolution=4, n_cascades=2, **ACTS)
    assert torch.equal(a, b)
    sent = rows[:, 0] == -32768
    vol = a.permute(0, 1, 3, 4, 2).reshape(-1, 4)
    assert bool((vol[sent] == 0).all()) and bool((vol[~sent, 3] > 0).all())


# --- kernels on the card -----------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("act", [NerfActivation.LOGISTIC, NerfActivation.EXPONENTIAL])
def test_shade_kernel_matches_plain(cuda, act):
    rows, scale, cam, ws = _shade_inputs(R=16, K=3, device=cuda)
    kw = dict(resolution=16, n_cascades=3, density_act=NerfActivation.EXPONENTIAL,
              rgb_act=act)
    n0 = shade_volume.launches
    got = shade_volume(rows, scale, cam, ws, **kw)
    torch.cuda.synchronize()
    assert shade_volume.launches == n0 + 1
    want = shade_volume_plain(rows, scale, cam, ws, **kw)
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2, atol=2e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("act", [NerfActivation.LOGISTIC, NerfActivation.EXPONENTIAL])
@pytest.mark.parametrize("culled", [0.0, 0.3, 1.0])
@pytest.mark.parametrize("R,K", [(5, 1), (5, 3), (16, 1), (16, 3)])
def test_shade_kernel_ragged_sizes_and_culling(cuda, R, K, culled, act):
    """Vertex counts that are no multiple of the kernel's 32-vertex tile,
    tiles that straddle planes and cascades, and tiles whose rows are all,
    partly or never culled."""
    rows, scale, cam, ws = _shade_inputs(R=R, K=K, seed=R + K, device=cuda, culled=culled)
    kw = dict(resolution=R, n_cascades=K, density_act=NerfActivation.EXPONENTIAL,
              rgb_act=act)
    got = shade_volume(rows, scale, cam, ws, **kw)
    torch.cuda.synchronize()
    want = shade_volume_plain(rows, scale, cam, ws, **kw)
    assert got.shape == want.shape == (K, R + 1, 4, R + 1, R + 1)
    assert got.stride(2) == 1 and want.stride(2) == 1  # channel-last storage
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2, atol=2e-3)
    if culled == 1.0:
        assert not bool(got.float().any())


SWEEP_ROWS = [
    ("nearest", False, None, False), ("bilinear", False, None, False),
    ("nearest", True, None, False), ("nearest", False, 0.4375, False),
    ("bilinear", True, 0.25, True), ("nearest", False, None, True),
]


@pytest.mark.cuda
@pytest.mark.parametrize("interp,use_stop,phase,flip", SWEEP_ROWS)
@pytest.mark.parametrize("axis", [0, 1, 2])
@pytest.mark.parametrize("layout", ["channel_last", "channel_planar"])
def test_sweep_kernel_views_and_layouts(cuda, layout, axis, interp, use_stop, phase, flip):
    """The three sweep-axis views of one channel-last volume (8-byte texels)
    and their channel-planar copies (the generic path), at an image size
    that is no multiple of the kernel's pixel tile."""
    from sienerf_torch.ops.sweep import orient_grid

    R, K = 16, 2
    vol5, o_c, eb, ec, stop = _sweep_inputs(R, K, 37, 131, axis, cuda, channel_last=True)
    view = orient_grid(vol5, axis, False)
    assert view.stride(2) == 1
    if layout == "channel_planar":
        view = view.contiguous()
    args = (o_c, eb, ec, 0.05, 1e-4, stop if use_stop else None, phase)
    kw = dict(resolution=R, n_cascades=K, interp=interp, data_flip=flip)
    want = sweep_composite_plain(view, *args, **kw)
    got = sweep_composite_kernel(view, *args, **kw)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w.contiguous(), rtol=1e-4, atol=2e-4)
    assert float(got[1].max()) > 0.1


@pytest.mark.cuda
@pytest.mark.parametrize("interp,use_stop,phase,flip", SWEEP_ROWS)
def test_sweep_kernel_matches_plain(cuda, interp, use_stop, phase, flip):
    vol, o_c, eb, ec, stop = _sweep_inputs(device=cuda)
    args = (o_c, eb, ec, 0.05, 1e-4, stop if use_stop else None, phase)
    kw = dict(resolution=16, n_cascades=2, interp=interp, data_flip=flip)
    n0 = sweep_composite_kernel.launches
    got = sweep_composite_kernel(vol, *args, **kw)
    torch.cuda.synchronize()
    assert sweep_composite_kernel.launches == n0 + 1
    want = sweep_composite_plain(vol, *args, **kw)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w.contiguous(), rtol=1e-4, atol=2e-4)


@pytest.mark.cuda
def test_sweep_kernel_reads_strided_volume(cuda):
    vol, o_c, eb, ec, _ = _sweep_inputs(device=cuda)
    view = vol.permute(0, 3, 2, 1, 4)  # a transposed sweep, never copied
    got = sweep_composite_kernel(view, o_c, eb, ec, 0.05, 1e-4, resolution=16, n_cascades=2)
    want = sweep_composite_plain(view.contiguous(), o_c, eb, ec, 0.05, 1e-4,
                                 resolution=16, n_cascades=2)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w.contiguous(), rtol=1e-4, atol=2e-4)


@pytest.mark.cuda
def test_fox_frame_kernels_match_plain(cuda):
    from sienerf_torch.engines.nerf_sweep import render_frame_sweep
    from sienerf_torch.session import Session
    from sienerf_torch.utils.camera import look_at_matrix

    s = Session(device=cuda)
    s.load_snapshot(FOX)
    grid, meta = s.bake(resolution=32)
    for eye in ([0.5, 0.5, -1.6], [2.1, 0.5, 0.6], [0.4, -1.3, 0.5]):
        cam = look_at_matrix(eye, [0.5, 0.5, 0.5])
        a = render_frame_sweep(s.engine, s.state["params"], grid, meta, cam, (48.0, 48.0),
                               width=64, height=64, impl="kernel", packed=True)
        b = render_frame_sweep(s.engine, s.state["params"], grid, meta, cam, (48.0, 48.0),
                               width=64, height=64, impl="plain", packed=True)
        torch.testing.assert_close(a, b, rtol=2e-2, atol=5e-3)


def _g1_inputs(t32, n, g, seed=0):
    rng = np.random.default_rng(seed)
    table = rng.integers(-2 ** 31, 2 ** 31, (t32, 128), dtype=np.int64).astype(np.int32)
    idx = rng.integers(0, t32 // g, n).astype(np.int32)
    return table, idx


@pytest.mark.cuda
@pytest.mark.parametrize("g,n", [(1, 1 << 16), (4, 1000), (3, 12345)])
def test_g1_kernel_equals_plain(cuda, g, n):
    table, idx = _g1_inputs(50_000, n, g)
    table, idx = torch.from_numpy(table).to(cuda), torch.from_numpy(idx).to(cuda)
    before = gather_rows.launches
    got = gather_rows(table, idx, g)
    torch.cuda.synchronize()
    assert gather_rows.launches == before + 1
    assert torch.equal(got, gather_rows_plain(table, idx, g))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,c", [(torch.float32, 32), (torch.bfloat16, 32),
                                     (torch.float32, 4), (torch.uint8, 48)])
def test_g2_kernel_equals_plain(cuda, dtype, c):
    rng = np.random.default_rng(c)
    t, n = 1 << 13, 100_001
    table = torch.from_numpy(rng.integers(0, 200, (t, c)).astype(np.float32)).to(dtype).to(cuda)
    idx = torch.from_numpy(rng.integers(0, t, n).astype(np.int32)).to(cuda)
    before = gather_small.launches
    got = gather_small(table, idx)
    torch.cuda.synchronize()
    assert gather_small.launches == before + 1
    assert torch.equal(got, gather_small_plain(table, idx))


# G2 across every instantiation of gather.cu: 16-512-byte rows are the
# templated kernels (UNITS 1-32), 48 and 1024 bytes the generic one
G2_ROW_BYTES = (16, 32, 48, 64, 128, 256, 512, 1024)
G2_DTYPES = (torch.float32, torch.bfloat16, torch.float16, torch.uint8, torch.int32)
G2_NS = (0, 1, 31, 33, 1000, (1 << 20) + 7)


def _g2_table(t, row_bytes, dtype, device, seed=0):
    """(t, row_bytes / itemsize) of random bits: NaN patterns included, so
    results are compared as bytes."""
    gen = torch.Generator(device=device).manual_seed(seed)
    raw = torch.randint(0, 256, (t, row_bytes), generator=gen, dtype=torch.uint8, device=device)
    return raw.view(dtype)


def _g2_indices(kind, t, n, device, seed=0):
    gen = torch.Generator(device=device).manual_seed(seed)
    if kind == "equal":
        idx = torch.full((n,), t // 3, dtype=torch.int32, device=device)
    elif kind == "last":  # every other index and the final one on row t - 1
        idx = torch.randint(0, t, (n,), generator=gen, device=device, dtype=torch.int32)
        idx[1::2] = t - 1
        idx[-1:] = t - 1
    else:
        idx = torch.randint(0, t, (n,), generator=gen, device=device, dtype=torch.int32)
        if kind == "sorted":
            idx = idx.sort().values
    return idx


def _bytes_equal(a, b):
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(
        a.contiguous().view(torch.uint8), b.contiguous().view(torch.uint8))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", G2_DTYPES)
@pytest.mark.parametrize("row_bytes", G2_ROW_BYTES)
def test_g2_kernel_bit_equal_every_width_type_count_and_pattern(cuda, row_bytes, dtype):
    """Every N and index pattern at one row width and type, each launch
    counted once."""
    t = 3001  # not a power of two: the last row sits mid-sector
    table = _g2_table(t, row_bytes, dtype, cuda, seed=row_bytes)
    assert table.shape[1] * table.element_size() == row_bytes
    for n in G2_NS:
        for kind in ("equal", "sorted", "random", "last"):
            idx = _g2_indices(kind, t, n, cuda, seed=n)
            before = gather_small.launches
            got = gather_small(table, idx)
            torch.cuda.synchronize()
            assert gather_small.launches == before + 1
            assert _bytes_equal(got, gather_small_plain(table, idx)), (n, kind)


@pytest.mark.cuda
def test_g2_kernel_table_larger_than_l2(cuda):
    """2^22 rows of 64 bytes (268 MB, over five times the 50 MB L2)."""
    table = _g2_table(1 << 22, 64, torch.float32, cuda, seed=7)
    for kind in ("random", "sorted", "last"):
        idx = _g2_indices(kind, table.shape[0], 1 << 20, cuda, seed=3)
        got = gather_small(table, idx)
        torch.cuda.synchronize()
        assert _bytes_equal(got, gather_small_plain(table, idx)), kind


@pytest.mark.cuda
def test_gather_wrappers_cached_state_gives_the_same_result(cuda):
    """The bound ctypes functions and the SM count are kept after the first
    call; a second call, and a call after a synchronise, agree with it."""
    table = _g2_table(5000, 128, torch.bfloat16, cuda)
    idx = _g2_indices("random", 5000, 100_003, cuda)
    t32, i32 = (torch.from_numpy(a).to(cuda) for a in _g1_inputs(2000, 5000, 2))
    first = gather_small(table, idx), gather_rows(t32, i32, 2)
    assert set(gather._bound) >= {"gather_small_launch", "gather_rows512_launch"}
    assert gather._sms[torch.cuda.current_device()] == torch.cuda.get_device_properties(
        cuda).multi_processor_count
    second = gather_small(table, idx), gather_rows(t32, i32, 2)
    torch.cuda.synchronize()
    third = gather_small(table, idx), gather_rows(t32, i32, 2)
    torch.cuda.synchronize()
    for got in (first, second, third):
        assert _bytes_equal(got[0], gather_small_plain(table, idx))
        assert torch.equal(got[1], gather_rows_plain(t32, i32, 2))


@pytest.mark.cuda
def test_gather_wrappers_never_fall_back(cuda, monkeypatch):
    """With the build broken a CUDA call raises; it does not take the plain
    version."""
    def broken(name):
        raise RuntimeError("build failed")

    monkeypatch.setattr(gather.cuda_lib, "load", broken)
    table, idx = _g1_inputs(64, 16, 1)
    with pytest.raises(RuntimeError):
        gather_rows(torch.from_numpy(table).to(cuda), torch.from_numpy(idx).to(cuda))
    with pytest.raises(RuntimeError):
        gather_small(torch.zeros((64, 4), device=cuda), torch.from_numpy(idx).to(cuda))


def _train_engine(device):
    """A small port trainer (4 levels x 2 features, 2^12 rows, MLPs 16
    wide, a 32^3 grid) on four seeded 32x32 views of the unit cube."""
    from sienerf_torch.engines.nerf import NerfEngine
    from sienerf_torch.io.nerf_dataset import NerfDataset
    from sienerf_torch.utils.camera import look_at_matrix

    rng = np.random.default_rng(0)
    eyes = [[1.6, 0.5, 0.5], [0.5, 1.6, 0.4], [-0.6, 0.5, 0.6], [0.5, 0.4, -0.6]]
    ds = NerfDataset(images=rng.uniform(0, 1, (4, 32, 32, 4)).astype(np.float32),
                     xforms=np.stack([look_at_matrix(e, [0.5, 0.5, 0.5]) for e in eyes]),
                     focal_lengths=np.full((4, 2), 40.0, np.float32),
                     principal_points=np.full((4, 2), 0.5, np.float32),
                     resolution=(32, 32), aabb_scale=1.0)
    mlp = {"n_neurons": 16, "n_hidden_layers": 1}
    cfg = {"encoding": {"otype": "HashGrid", "n_levels": 4, "n_features_per_level": 2,
                        "log2_hashmap_size": 12, "base_resolution": 8},
           "network": mlp, "rgb_network": mlp,
           "optimizer": {"otype": "Ema", "decay": 0.95,
                         "nested": {"otype": "Adam", "learning_rate": 1e-2, "l2_reg": 1e-6}}}
    return NerfEngine.create(cfg, ds, train_batch_size=1 << 12, grid_size=32, train_k=16,
                             device=device)


@pytest.mark.cuda
def test_card_training_step_matches_the_cpu_step(cuda):
    """One training step on the card and on the CPU from the same state and
    draws: loss rtol 1e-3 (the card sums each MLP layer in another order, so
    a hidden value on a bf16 rounding boundary can round the other way, as
    in chip_smoke.py's card step), and rtol 1e-5 once the CPU step takes the
    card's bf16 roundings of every MLP input and its f32 MLP outputs
    (ops/mlp.py::tap_roundings): the flips account for the whole gap;
    MLP gradients rtol 1e-2 / atol 1e-3 and within 2 % of their largest
    entry, the hash table's within 2 % of max |d| (the tolerances of
    tests/test_torch_hashgrad.py)."""
    from sienerf_torch.ops.optim import tree_leaves, tree_map

    cpu, card = _train_engine("cpu"), _train_engine(cuda)
    gen = torch.Generator().manual_seed(1)
    state = cpu.init(0)
    state = cpu.occupancy_update(state, cpu.draw_occupancy(state, gen))
    assert 0.0 < float(state["occ"]["bitfield"].float().mean()) < 1.0
    n_rays, k, iters = cpu._phase_geometry()
    draws = cpu.draw_step(gen, n_rays, state["step"])

    def to_card(x):
        return x.to(cuda) if isinstance(x, torch.Tensor) else x

    from sienerf_torch.ops.mlp import tap_roundings

    loss, grads, aux = cpu.loss_and_grads(state, draws, k, iters)
    with tap_roundings() as tap:
        closs, cgrads, caux = card.loss_and_grads(tree_map(to_card, state),
                                                  tree_map(to_card, draws), k, iters)
    torch.cuda.synchronize()
    assert int(aux[0].sum()) > 4 * n_rays
    np.testing.assert_allclose(float(closs), float(loss), rtol=1e-3)
    with tap_roundings(replace=[v.detach().cpu() for v in tap.seen]):
        loss_inj = cpu.loss_and_grads(state, draws, k, iters)[0]
    np.testing.assert_allclose(float(closs), float(loss_inj), rtol=1e-5)
    for name in ("density_mlp", "rgb_mlp", "grid"):
        for a, b in zip(tree_leaves(cgrads[name]), tree_leaves(grads[name])):
            a = a.cpu()
            assert float((a - b).abs().max()) <= 0.02 * float(b.abs().max()), name
            if name != "grid":
                assert torch.allclose(a, b, rtol=1e-2, atol=1e-3), name
    # and a step: the card's state stays on the card
    new, loss2, cnt = card.train_step(tree_map(to_card, state), tree_map(to_card, draws),
                                      k, iters)
    assert new["params"]["grid"].device.type == "cuda" and new["step"] == 1
    assert new["emap"]["error"].device.type == "cuda" and float(cnt) > 0


@pytest.mark.cuda
def test_card_training_step_is_deterministic(cuda):
    """Two gradient evaluations of one batch, and two bundles from one state
    and one seed, on the card: bit-equal losses, gradients, params and
    occupancy (the sums of ops/fixed_order.py)."""
    from sienerf_torch.ops.optim import tree_leaves

    eng = _train_engine(cuda)
    state = eng.init(0)
    gen = torch.Generator(device=cuda).manual_seed(1)
    state, _, _ = eng.train_bundle(state, gen)
    n_rays, k, iters = eng._phase_geometry()
    draws = eng.draw_step(torch.Generator(device=cuda).manual_seed(2), n_rays, state["step"])
    a = eng.loss_and_grads(state, draws, k, iters)
    b = eng.loss_and_grads(state, draws, k, iters)
    assert torch.equal(a[0], b[0])
    assert all(torch.equal(x, y) for x, y in zip(tree_leaves(a[1]), tree_leaves(b[1])))
    mean = eng._mean_samples
    runs = []
    for _ in range(2):
        eng._mean_samples = mean
        st, loss, _ = eng.train_bundle(state, torch.Generator(device=cuda).manual_seed(3))
        runs.append((loss, tree_leaves(st["params"]) + tree_leaves(st["opt"]), st["occ"]))
    assert torch.equal(runs[0][0], runs[1][0])
    assert all(torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y
               for x, y in zip(runs[0][1], runs[1][1]))
    assert torch.equal(runs[0][2]["density"], runs[1][2]["density"])


@pytest.mark.cuda
def test_hybrid_frame_kernels_match_plain_with_a_mesh_t_stop(cuda, tmp_path):
    """The fox behind a code-built box: K2 with the box's per-pixel t_stop
    against the plain composite on the same inputs (rtol 1e-4 / atol 2e-4),
    and the kernel hybrid frame against the plain one (rtol 2e-2 / atol
    5e-3, K1's bf16 volume)."""
    import json

    from sienerf_torch.engines.geometry import GeometryObject
    from sienerf_torch.engines.nerf_sweep import axis_view
    from sienerf_torch.geom.mesh_io import box_mesh, save_obj
    from sienerf_torch.session import Session
    from sienerf_torch.utils.camera import look_at_matrix

    fox = Session(device=cuda)
    fox.load_snapshot(FOX)
    box = box_mesh()
    save_obj(tmp_path / "box.obj", box.reshape(-1, 3), np.arange(36).reshape(-1, 3))
    (tmp_path / "s.geometry.json").write_text(json.dumps({"geometry": [
        {"type": "Mesh", "path": "box.obj", "scale": 0.3, "center": [0.0, -0.1, -0.9]}]}))
    geo = Session(device=cuda).load_file(tmp_path / "s.geometry.json").engine
    R = 32
    obj = GeometryObject("nerf", np.zeros(3, np.float32), "fox", nerf=fox.engine,
                         nerf_state=fox.state)
    obj._bake = fox.bake(resolution=R)
    geo.objects.append(obj)
    cam = look_at_matrix([0.5, 0.5, -1.6], [0.5, 0.5, 0.5])
    stats = {}
    a, _ = geo.render_frame(96, 64, cam, (80.0, 80.0), renderer="sweep", stats=stats)
    b, _ = geo.render_frame(96, 64, cam, (80.0, 80.0), renderer="sweep", impl="plain")
    t_stop = stats["t_stop"]
    share = float(torch.isfinite(t_stop).float().mean())
    assert 0.02 < share < 0.9
    o_c, eb, ec, near, min_t = stats["intermediate"]
    want = sweep_composite_plain(axis_view(stats["volume"], stats["axis"]), o_c, eb, ec, near,
                                 min_t, t_stop, resolution=R, n_cascades=3,
                                 data_flip=stats["flip"])
    for g, w in zip(stats["composite"], want):
        torch.testing.assert_close(g, w.contiguous(), rtol=1e-4, atol=2e-4)
    torch.testing.assert_close(a, b, rtol=2e-2, atol=5e-3)


# --- the baked gather renderer (G2 and G1 on the frame's own rows) ---------


def _fox_baked_session(device, resolution=32, mode="nearest"):
    from sienerf_torch.session import Session

    s = Session(device=device)
    s.load_snapshot(FOX)
    s._baked = s.engine.bake_features(s.render_params(), s.state["occ"],
                                      resolution=resolution, mode=mode)
    return s


@pytest.mark.cuda
@pytest.mark.parametrize("mode,knobs", [("nearest", {}), ("nearest", {"fine": "brick"}),
                                        ("trilinear", {})])
def test_baked_frame_kernel_equals_plain(cuda, mode, knobs):
    """The baked frame through G2 (and G1 for bricks) equals the frame with
    the plain gathers bit for bit; the wrappers count their launches."""
    from sienerf_torch.utils.camera import look_at_matrix

    s = _fox_baked_session(cuda, mode=mode)
    cam = look_at_matrix([2.1, 0.5, 0.6], [0.5, 0.5, 0.5])
    n0 = (gather_small.launches, gather_rows.launches)
    a = s.render(96, 64, cam, (70.0, 70.0), renderer="baked", **knobs)
    n1 = (gather_small.launches, gather_rows.launches)
    b = s.render(96, 64, cam, (70.0, 70.0), renderer="baked", impl="plain", **knobs)
    assert (gather_small.launches, gather_rows.launches) == n1
    if knobs.get("fine") == "brick":
        assert n1[1] > n0[1] and n1[0] == n0[0]
    else:
        assert n1[0] > n0[0] and n1[1] == n0[1]
    assert torch.equal(a, b)
    assert float(a[..., 3].mean()) > 0.05


@pytest.mark.cuda
@pytest.mark.parametrize("fine", ["row", "brick"])
def test_gathers_on_the_frame_index_streams(cuda, monkeypatch, fine):
    """G2 on the vertex rows and G1 on the 512-byte bricks that a baked
    frame gathers, bit-equal to the plain versions, one launch a call."""
    from sienerf_torch.ops import baked as baked_ops
    from sienerf_torch.utils.camera import look_at_matrix

    s = _fox_baked_session(cuda)
    seen = []
    real = baked_ops.gather_table_rows

    def keep(table, ids, impl="kernel"):
        seen.append((table, baked_ops._row_ids(ids, table.shape[0]).clone()))
        return real(table, ids, impl)

    monkeypatch.setattr(baked_ops, "gather_table_rows", keep)
    s.render(64, 48, look_at_matrix([0.5, 0.5, -1.6], [0.5, 0.5, 0.5]), (48.0, 48.0),
             renderer="baked", fine=fine)
    assert seen
    for table, idx in seen:
        if table.shape[1] * table.element_size() == 512:
            t32 = table.view(torch.int32)
            n = gather_rows.launches
            assert torch.equal(gather_rows(t32, idx), gather_rows_plain(t32, idx))
            assert gather_rows.launches == n + 1
        else:
            n = gather_small.launches
            assert torch.equal(gather_small(table, idx), gather_small_plain(table, idx))
            assert gather_small.launches == n + 1
        assert int(idx.min()) >= 0 and int(idx.max()) < table.shape[0]


# --- the image, SDF and volume modes: plain PyTorch on the card ------------


def _mode_engines(mode, device):
    """A small engine of `mode` (8 levels, 2^14 rows) on `device`, on an
    input built in code."""
    import copy

    from sienerf_torch.engines.image import ImageEngine
    from sienerf_torch.engines.sdf import SdfEngine
    from sienerf_torch.engines.volume import VolumeEngine
    from sienerf_torch.geom.mesh_io import box_mesh, icosphere, normalize_to_unit_cube
    from sienerf_torch.io.nanovdb import synthetic_fog_volume
    from sienerf_torch.utils.config import default_configs_dir, load_network_config

    cfg = copy.deepcopy(load_network_config(default_configs_dir() / mode / "base.json"))
    cfg["encoding"].update(n_levels=8, log2_hashmap_size=14)
    if mode == "image":
        y, x = np.meshgrid(np.linspace(0, 1, 96), np.linspace(0, 1, 96), indexing="ij")
        img = np.stack([np.sin(30 * x * y), x, y, np.ones_like(x)], -1).astype(np.float32)
        return ImageEngine.create(cfg, img, batch_size=1 << 13, device=device)
    if mode == "sdf":
        tri = np.concatenate([icosphere(3, 0.3) + np.float32([0.35, 0.5, 0.5]),
                              box_mesh((0.7, 0.3, 0.3), (0.95, 0.7, 0.6))])
        return SdfEngine.create(cfg, normalize_to_unit_cube(tri, scale_margin=0.9),
                                batch_size=1 << 13, device=device)
    return VolumeEngine.create(cfg, synthetic_fog_volume(48, "shell"), batch_size=1 << 13,
                               device=device)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["image", "sdf", "volume"])
def test_card_mode_step_matches_the_cpu_step(cuda, mode):
    """One injected training step of each mode, card against CPU: the loss
    at rtol 1e-4, and at 1e-5 with the card's bf16 roundings put into the
    CPU step (ops/mlp.py::tap_roundings); gradients at the tolerances of
    tests/test_torch_hashgrad.py (MLP matrices rtol 1e-2 / atol 1e-3 and
    within 2 % of their largest entry, the table within 2 %)."""
    from sienerf_torch.ops.mlp import tap_roundings
    from sienerf_torch.ops.optim import tree_leaves, tree_map

    cpu, card = _mode_engines(mode, "cpu"), _mode_engines(mode, cuda)
    state = cpu.init(0)
    params = state[0] if mode == "image" else state["params"]
    gen = torch.Generator().manual_seed(1)
    if mode == "image":
        args = (torch.rand((1 << 13, 2), generator=gen),)
    elif mode == "sdf":
        pos = torch.from_numpy(cpu.sample_batch_host(np.random.default_rng(2)))
        args = (pos, cpu.ground_truth(pos))
    else:
        args = (torch.rand((1 << 13, 3), generator=gen),)
    loss, grads = cpu.loss_and_grads(params, *args)
    with tap_roundings() as tap:
        closs, cgrads = card.loss_and_grads(tree_map(lambda t: t.to(cuda), params),
                                            *(a.to(cuda) for a in args))
    torch.cuda.synchronize()
    with tap_roundings(replace=[v.detach().cpu() for v in tap.seen]):
        loss_inj = cpu.loss_and_grads(params, *args)[0]
    np.testing.assert_allclose(float(closs), float(loss), rtol=1e-4)
    np.testing.assert_allclose(float(closs), float(loss_inj), rtol=1e-5)
    for a, b in zip(tree_leaves(cgrads), tree_leaves(grads)):
        a = a.cpu()
        assert float((a - b).abs().max()) <= 0.02 * float(b.abs().max())
        if a.dim() == 2:
            assert torch.allclose(a, b, rtol=1e-2, atol=1e-3)


@pytest.mark.cuda
def test_card_sdf_and_volume_frames_match_the_cpu(cuda):
    """Small frames of a briefly fitted SDF and volume, card against CPU:
    the sphere tracer's hit masks within 1 % and the colours at the MLP
    bound on >= 97 % of pixels; delta tracking on the same draws, hits
    within 0.5 % and colours at the MLP bound on >= 99 % of the others."""
    import dataclasses

    from sienerf_torch.ops.optim import tree_map
    from sienerf_torch.utils.camera import look_at_matrix

    cam = look_at_matrix([1.3, 0.9, -0.5], [0.5, 0.5, 0.5])
    card = _mode_engines("sdf", cuda)
    state = card.init(0)
    gen = torch.Generator(device=cuda).manual_seed(0)
    for _ in range(4):
        state, _ = card.train_bundle(state, gen)
    cpu = _mode_engines("sdf", "cpu")
    p = tree_map(lambda t: t.cpu(), state["params"])
    a, ad = card.render_frame(state["params"], 48, 32, cam)
    b, bd = cpu.render_frame(p, 48, 32, cam)
    assert float((torch.isfinite(ad.cpu()) != torch.isfinite(bd)).float().mean()) <= 0.01
    assert float(torch.isclose(a.cpu(), b, rtol=1e-2, atol=1e-3).all(-1).float().mean()) >= 0.97
    card = _mode_engines("volume", cuda)
    state = card.init(0)
    for _ in range(2):
        state, _ = card.train_bundle(state, gen)
    cpu = dataclasses.replace(card, gt_density=card.gt_density.cpu(), device=torch.device("cpu"))
    g, cache = torch.Generator().manual_seed(3), []

    def draws_on(d):
        def draw(_pass, i, n):
            while len(cache) <= i:
                cache.append((1e-7 + torch.rand((n,), generator=g) * (1 - 1e-7),
                              torch.rand((n,), generator=g)))
            return tuple(x.to(d) for x in cache[i])
        return draw

    cam = look_at_matrix([0.5, 0.5, -1.5], [0.5, 0.5, 0.5])
    p = tree_map(lambda t: t.cpu(), state["params"])
    a, aa = card.render_frame(state["params"], 40, 24, cam, (50.0, 50.0), spp=1,
                              draw=draws_on(cuda))
    b, ba = cpu.render_frame(p, 40, 24, cam, (50.0, 50.0), spp=1, draw=draws_on("cpu"))
    differ = aa.cpu() != ba
    assert float(differ.float().mean()) <= 0.005
    close = torch.isclose(a.cpu(), b, rtol=1e-2, atol=1e-3).all(-1)[~differ]
    assert float(close.float().mean()) >= 0.99


# --- K1 for every colour MLP of configs/nerf/, the route K1 does not take,
# and the Takikawa backward --------------------------------------------------

RGB_SHAPES = {"base_0layer": ((32, 3),), "base_1layer": ((32, 64), (64, 3)),
              "base": ((32, 64), (64, 64), (64, 3)),
              "base_3layer": ((32, 64), (64, 64), (64, 64), (64, 3)),
              "big": ((32, 128), (128, 128), (128, 3))}


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(RGB_SHAPES))
@pytest.mark.parametrize("R,K", [(5, 1), (16, 3)])
def test_shade_kernel_takes_every_repo_colour_mlp(cuda, name, R, K):
    rng = np.random.default_rng(R + K)
    Rv = R + 1
    rows = rng.integers(-32767, 32768, (K * Rv ** 3, 16)).astype(np.int16)
    rows[rng.random(K * Rv ** 3) < 0.3] = -32768
    scale = rng.uniform(2e-5, 2e-4, (K, 16)).astype(np.float32)
    ws = [torch.from_numpy(rng.normal(0, 1 / np.sqrt(a), (a, b)).astype(np.float32)).to(cuda)
          for a, b in RGB_SHAPES[name]]
    args = (torch.from_numpy(rows).to(cuda), torch.from_numpy(scale).to(cuda),
            torch.tensor([0.1, 1.4, -0.6], device=cuda), ws)
    kw = dict(resolution=R, n_cascades=K, **ACTS)
    n0 = shade_volume.launches
    got = shade_volume(*args, **kw)
    torch.cuda.synchronize()
    assert shade_volume.launches == n0 + 1
    want = shade_volume_plain(*args, **kw)
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2, atol=2e-3)
    if name == "base":  # the general path on the tuned path's shapes: the same bits
        gen = _shade_general(*args, **kw)
        torch.cuda.synchronize()
        assert torch.equal(gen.contiguous().view(torch.int16), got.contiguous().view(torch.int16))


GENERAL_SHAPES = dict(
    RGB_SHAPES, w128x4=((32, 128), (128, 128), (128, 128), (128, 128), (128, 3)),
    w40=((32, 40), (40, 40), (40, 3)), w256=((32, 256), (256, 256), (256, 3)))


@pytest.mark.cuda
@pytest.mark.parametrize("name", [n for n in GENERAL_SHAPES if n != "base"])
@pytest.mark.parametrize("R,K,culled", [(1, 1, 0.0), (3, 2, 0.5), (4, 3, 0.9), (9, 3, 0.3)])
def test_general_path_ragged_stages(cuda, name, R, K, culled):
    """The general kernel's stream of 64-row stages at ragged sizes: 8
    vertices (one short stage), 128 vertices half kept (a cascade boundary
    inside a stage), 375 mostly culled, 3,000 (many stages, a short last
    one), each against the plain version, culled vertices zero."""
    rng = np.random.default_rng(7 * R + K)
    Rv = R + 1
    rows = rng.integers(-32767, 32768, (K * Rv ** 3, 16)).astype(np.int16)
    rows[rng.random(K * Rv ** 3) < culled] = -32768
    scale = rng.uniform(2e-5, 2e-4, (K, 16)).astype(np.float32)
    ws = [torch.from_numpy(rng.normal(0, 1 / np.sqrt(a), (a, b)).astype(np.float32)).to(cuda)
          for a, b in GENERAL_SHAPES[name]]
    args = (torch.from_numpy(rows).to(cuda), torch.from_numpy(scale).to(cuda),
            torch.tensor([0.1, 1.4, -0.6], device=cuda), ws)
    kw = dict(resolution=R, n_cascades=K, **ACTS)
    n0 = shade_volume.launches
    got = _shade_general(*args, **kw)
    torch.cuda.synchronize()
    assert shade_volume.launches == n0 + 1
    want = shade_volume_plain(*args, **kw)
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2, atol=2e-3)
    sent = torch.from_numpy(rows[:, 0] == -32768).to(cuda)
    flat = got.permute(0, 1, 3, 4, 2).reshape(-1, 4)
    assert not bool(flat[sent].any())


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["base_1layer", "base_3layer", "big", "w256"])
def test_general_path_stages_filled_out_of_order(cuda, name):
    """The general kernel with producer warp 0 of every block writing its
    claimed rows 20 us late: the other warps complete later stages first
    and the consumers run ahead of the stalled stage (three consumer
    warpgroups at width 64, so a slot's rounds would belong to different
    consumers with 8 slots), against the plain version."""
    rng = np.random.default_rng(11)
    R, K = 48, 2
    Rv = R + 1
    rows = rng.integers(-32767, 32768, (K * Rv ** 3, 16)).astype(np.int16)
    rows[rng.random(K * Rv ** 3) < 0.3] = -32768
    scale = rng.uniform(2e-5, 2e-4, (K, 16)).astype(np.float32)
    ws = [torch.from_numpy(rng.normal(0, 1 / np.sqrt(a), (a, b)).astype(np.float32)).to(cuda)
          for a, b in GENERAL_SHAPES[name]]
    args = (torch.from_numpy(rows).to(cuda), torch.from_numpy(scale).to(cuda),
            torch.tensor([0.1, 1.4, -0.6], device=cuda), ws)
    kw = dict(resolution=R, n_cascades=K, **ACTS)
    want = shade_volume_plain(*args, **kw)
    for stall_ns in (20000, 0):
        got = shade._shade_volume(*args, path="general", stall_ns=stall_ns, **kw)
        torch.cuda.synchronize()
        torch.testing.assert_close(got.float(), want.float(), rtol=2e-2, atol=2e-3)


# nets the general kernel cannot hold: wider than 256, or weights that leave
# no room for its stage ring
WIDE_SHAPES = {"w272": ((32, 272), (272, 3)), "w512": ((32, 512), (512, 3)),
               "w288x2": ((32, 288), (288, 288), (288, 3)),
               "w128x7": ((32, 128),) + ((128, 128),) * 6 + ((128, 3),)}


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(WIDE_SHAPES))
@pytest.mark.parametrize("R,K,culled", [(3, 2, 0.5), (16, 3, 0.3)])
def test_wide_path_takes_what_the_general_kernel_cannot_hold(cuda, name, R, K, culled):
    """shade_volume and the general path send these nets to the wide kernel
    (one launch each), against the plain version, culled vertices zero."""
    rng = np.random.default_rng(5 * R + K)
    Rv = R + 1
    rows = rng.integers(-32767, 32768, (K * Rv ** 3, 16)).astype(np.int16)
    rows[rng.random(K * Rv ** 3) < culled] = -32768
    scale = rng.uniform(2e-5, 2e-4, (K, 16)).astype(np.float32)
    ws = [torch.from_numpy(rng.normal(0, 1 / np.sqrt(a), (a, b)).astype(np.float32)).to(cuda)
          for a, b in WIDE_SHAPES[name]]
    shapes = tuple(tuple(w.shape) for w in ws)
    assert shade._route(shapes, "auto", cuda) == shade._route(shapes, "general", cuda) == "wide"
    args = (torch.from_numpy(rows).to(cuda), torch.from_numpy(scale).to(cuda),
            torch.tensor([0.1, 1.4, -0.6], device=cuda), ws)
    kw = dict(resolution=R, n_cascades=K, **ACTS)
    want = shade_volume_plain(*args, **kw)
    sent = torch.from_numpy(rows[:, 0] == -32768).to(cuda)
    for fn in (shade_volume, _shade_general):
        n0 = shade_volume.launches
        got = fn(*args, **kw)
        torch.cuda.synchronize()
        assert shade_volume.launches == n0 + 1
        torch.testing.assert_close(got.float(), want.float(), rtol=2e-2, atol=2e-3)
        assert not bool(got.permute(0, 1, 3, 4, 2).reshape(-1, 4)[sent].any())
    warps, blocks, smem = shade.general_occupancy(ws)
    assert warps >= 1 and blocks >= 1 and smem > 0


@pytest.mark.cuda
def test_wide_path_and_general_kernel_agree(cuda):
    """The wide kernel (the general path's first kernel) and the general
    kernel on the configs' general shapes: the same sums, the same bits."""
    rows, scale, cam, _ = _shade_inputs(R=16, K=3, seed=4, device=cuda)
    rng = np.random.default_rng(4)
    kw = dict(resolution=16, n_cascades=3, **ACTS)
    for name in ("base_0layer", "base_1layer", "base_3layer", "big"):
        ws = [torch.from_numpy(rng.normal(0, 1 / np.sqrt(a), (a, b)).astype(np.float32))
              .to(cuda) for a, b in RGB_SHAPES[name]]
        gen = _shade_general(rows, scale, cam, ws, **kw)
        wide = shade._shade_wide(rows, scale, cam, ws, **kw)
        torch.cuda.synchronize()
        assert torch.equal(gen.contiguous().view(torch.int16), wide.contiguous().view(torch.int16))


@pytest.mark.cuda
def test_wide_colour_mlp_sweep_frame_matches_plain(cuda):
    """A NeRF whose colour MLP is 512 wide: the sweep frame shades with K1
    (its wide kernel) once and composites with K2 once, against the plain
    frame."""
    from sienerf_torch.engines.nerf import NerfEngine
    from sienerf_torch.engines.nerf_sweep import _fused_prep_eligible, render_frame_sweep
    from sienerf_torch.io.nerf_dataset import NerfDataset
    from sienerf_torch.utils.camera import look_at_matrix
    from sienerf_torch.utils.config import load_network_config

    cfg = load_network_config(Path(__file__).resolve().parent.parent / "configs" / "nerf"
                              / "base.json")
    cfg["encoding"] = dict(cfg["encoding"], log2_hashmap_size=14)
    cfg["rgb_network"] = dict(cfg["rgb_network"], n_neurons=512, n_hidden_layers=1)
    eng = NerfEngine.create(cfg, NerfDataset.placeholder(1.0), grid_size=32, device=cuda)
    state = eng.init(0)
    assert [tuple(w.shape) for w in state["params"]["rgb_mlp"]] == [(32, 512), (512, 3)]
    occ = {"bitfield": torch.ones_like(state["occ"]["bitfield"])}
    grid, meta = eng.bake_features(state["params"], occ, resolution=32)
    assert _fused_prep_eligible(eng, grid)
    cam = look_at_matrix([0.5, 0.5, -1.6], [0.5, 0.5, 0.5])
    n0 = (shade_volume.launches, sweep_composite_kernel.launches)
    rgba, _ = render_frame_sweep(eng, state["params"], grid, meta, cam, (60.0, 60.0),
                                 width=64, height=48)
    torch.cuda.synchronize()
    assert (shade_volume.launches, sweep_composite_kernel.launches) == (n0[0] + 1, n0[1] + 1)
    want, _ = render_frame_sweep(eng, state["params"], grid, meta, cam, (60.0, 60.0),
                                 width=64, height=48, impl="plain")
    torch.testing.assert_close(rgba, want, rtol=2e-2, atol=5e-3)


@pytest.mark.cuda
def test_general_path_instructions_sum_alike(cuda):
    """One 64x64x64 bf16 product through the tuned kernel's mma.sync and
    the general kernel's wgmma: the same f32 bits (so the general path
    gives the tuned path's bits on the fox's 32-64-64-3)."""
    from sienerf_torch.ops.shade import mma_probe

    gen = torch.Generator(device=cuda).manual_seed(3)
    for scale in (1.0, 30.0):
        a = (torch.randn((64, 64), generator=gen, device=cuda) * scale).to(torch.bfloat16)
        b = torch.randn((64, 64), generator=gen, device=cuda).to(torch.bfloat16)
        d_sync, d_wgmma = mma_probe(a, b)
        torch.cuda.synchronize()
        assert torch.equal(d_sync.view(torch.int32), d_wgmma.view(torch.int32))
        torch.testing.assert_close(d_sync, (a.float() @ b.float()), rtol=1e-5, atol=1e-4)


@pytest.mark.cuda
def test_the_ineligible_route_launches_k2_not_k1(cuda):
    """A network K1 does not take (SH degree 3): the sweep frame shades
    with the plain shade and composites with K2, the JAX package's route."""
    from sienerf_torch.engines.nerf import NerfEngine
    from sienerf_torch.engines.nerf_sweep import _fused_prep_eligible, render_frame_sweep
    from sienerf_torch.io.nerf_dataset import NerfDataset
    from sienerf_torch.utils.camera import look_at_matrix
    from sienerf_torch.utils.config import load_network_config

    cfg = load_network_config(Path(__file__).resolve().parent.parent / "configs" / "nerf"
                              / "base.json")
    cfg["encoding"] = dict(cfg["encoding"], log2_hashmap_size=14)
    cfg["dir_encoding"] = {"otype": "Composite", "nested": [
        {"n_dims_to_encode": 3, "otype": "SphericalHarmonics", "degree": 3},
        {"otype": "Identity"}]}
    eng = NerfEngine.create(cfg, NerfDataset.placeholder(1.0), grid_size=32, device=cuda)
    state = eng.init(0)
    occ = {"bitfield": torch.ones_like(state["occ"]["bitfield"])}
    grid, meta = eng.bake_features(state["params"], occ, resolution=32)
    assert not _fused_prep_eligible(eng, grid)
    cam = look_at_matrix([0.5, 0.5, -1.6], [0.5, 0.5, 0.5])
    n0 = (shade_volume.launches, sweep_composite_kernel.launches)
    rgba, _ = render_frame_sweep(eng, state["params"], grid, meta, cam, (60.0, 60.0),
                                 width=64, height=48)
    torch.cuda.synchronize()
    assert (shade_volume.launches, sweep_composite_kernel.launches) == (n0[0], n0[1] + 1)
    want, _ = render_frame_sweep(eng, state["params"], grid, meta, cam, (60.0, 60.0),
                                 width=64, height=48, impl="plain")
    torch.testing.assert_close(rgba, want, rtol=2e-2, atol=5e-3)


@pytest.mark.cuda
def test_takikawa_backward_is_bit_equal_across_runs(cuda):
    from sienerf_torch.geom.mesh_io import box_mesh, icosphere
    from sienerf_torch.geom.octree import build_triangle_octree, octree_device_tables
    from sienerf_torch.ops.takikawa import TakikawaConfig, takikawa_encode

    tris = np.concatenate([icosphere(3, 0.3) + 0.5, box_mesh((0.7,) * 3, (0.9,) * 3)])
    tree = build_triangle_octree(tris.astype(np.float32), 8)
    tables = octree_device_tables(tree, cuda)
    cfg = TakikawaConfig(depth=8, starting_level=4)
    grads = []
    for _ in range(2):
        g = torch.Generator(device=cuda).manual_seed(0)
        feats = (torch.rand((tree.n_vertices, 8), generator=g, device=cuda) - 0.5) \
            .requires_grad_(True)
        pos = torch.rand((1 << 16, 3), generator=g, device=cuda).requires_grad_(True)
        out = takikawa_encode(cfg, tables, feats, pos)
        (out * out).sum().backward()
        grads.append((feats.grad, pos.grad))
    assert torch.equal(grads[0][0], grads[1][0]) and torch.equal(grads[0][1], grads[1][1])
    assert float(grads[0][0].abs().max()) > 0


def _learner_engine(device, n_extra=2):
    """_train_engine's scene with every learner on: cameras, focal,
    exposure, a 16x16 distortion map, latent codes, an 8x16 envmap, depth
    supervision, the near-density regulariser and rolling shutter."""
    import dataclasses

    from sienerf_torch.engines.nerf import NerfEngine
    from sienerf_torch.io.nerf_dataset import NerfDataset

    base = _train_engine("cpu")
    rng = np.random.default_rng(1)
    ds = NerfDataset(images=base.images, xforms=base.xforms, focal_lengths=base.focals,
                     principal_points=base.principal_points, resolution=base.resolution,
                     aabb_scale=1.0, depths=rng.uniform(0.5, 1.5, (4, 32, 32)).astype(
                         np.float32),
                     rolling_shutter=np.asarray([0.1, 0.2, 0.3, 0.25], np.float32),
                     xforms_end=(base.xforms + rng.normal(0, 0.01, base.xforms.shape)).astype(
                         np.float32),
                     envmap=rng.uniform(0, 1, (8, 16, 4)).astype(np.float32),
                     n_extra_learnable_dims=n_extra)
    cfg = {"encoding": {"otype": "HashGrid", "n_levels": 4, "n_features_per_level": 2,
                        "log2_hashmap_size": 12, "base_resolution": 8},
           "network": {"n_neurons": 16, "n_hidden_layers": 1},
           "rgb_network": {"n_neurons": 16, "n_hidden_layers": 1},
           "optimizer": {"otype": "Ema", "decay": 0.95,
                         "nested": {"otype": "Adam", "learning_rate": 1e-2, "l2_reg": 1e-6}}}
    eng = NerfEngine.create(cfg, ds, train_batch_size=1 << 12, grid_size=32, train_k=16,
                            near_density_reg=0.1, device=device)
    return dataclasses.replace(eng, optimize_extrinsics=True, optimize_focal=True,
                               optimize_exposure=True, optimize_distortion=True,
                               distortion_resolution=16, depth_supervision_lambda=0.5)


@pytest.mark.cuda
def test_learner_training_step_is_deterministic(cuda):
    """Every learner on: two gradient evaluations of one batch and two
    bundles from one state and seed are bit-equal (the learners' sums run
    through ops/fixed_order.py::take_rows)."""
    from sienerf_torch.ops.optim import tree_leaves

    eng = _learner_engine(cuda)
    state, _, _ = eng.train_bundle(eng.init(0), torch.Generator(device=cuda).manual_seed(1))
    n_rays, k, iters = eng._phase_geometry()
    draws = eng.draw_step(torch.Generator(device=cuda).manual_seed(2), n_rays, state["step"])
    assert "shutter" in draws
    a = eng.loss_and_grads(state, draws, k, iters)
    b = eng.loss_and_grads(state, draws, k, iters)
    assert torch.equal(a[0], b[0])
    assert all(torch.equal(x, y) for x, y in zip(tree_leaves(a[1]), tree_leaves(b[1])))
    for leaf in ("cam", "focal", "exposure", "distortion", "extra_dims", "envmap"):
        assert float(a[1][leaf].abs().max()) > 0, leaf
    mean = eng._mean_samples
    runs = []
    for _ in range(2):
        eng._mean_samples = mean
        st, loss, _ = eng.train_bundle(state, torch.Generator(device=cuda).manual_seed(3))
        runs.append((loss, tree_leaves(st["params"]) + tree_leaves(st["opt"]), st["occ"]))
    assert torch.equal(runs[0][0], runs[1][0])
    assert all(torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y
               for x, y in zip(runs[0][1], runs[1][1]))
    assert torch.equal(runs[0][2]["density"], runs[1][2]["density"])


def _conditioned_bake(cuda):
    """A seeded field with 16 latent codes a view (K1 does not take it) on
    a full occupancy grid, and its R=32 bake."""
    import dataclasses

    eng = _learner_engine(cuda, n_extra=16)
    eng = dataclasses.replace(eng, render_table_pack="none")
    state = eng.init(0)
    occ = {"bitfield": torch.ones_like(state["occ"]["bitfield"]),
           "mean_density": torch.tensor(0.01, device=cuda)}
    state["params"]["density_mlp"][-1] = state["params"]["density_mlp"][-1] * 40.0
    grid, meta = eng.bake_features(state["params"], occ, resolution=32)
    return eng, state, occ, grid, meta


@pytest.mark.cuda
def test_the_extra_dims_route_launches_k2_not_k1(cuda):
    """A conditioned field: the sweep frame shades with the plain shade
    (view 0's code) and composites with K2, the JAX package's route."""
    from sienerf_torch.engines.nerf_sweep import _fused_prep_eligible, render_frame_sweep
    from sienerf_torch.utils.camera import look_at_matrix

    eng, state, _, grid, meta = _conditioned_bake(cuda)
    assert eng.net.n_extra_dims == 16 and eng.net.rgb_mlp.n_input_dims == 48
    assert not _fused_prep_eligible(eng, grid)
    cam = look_at_matrix([0.5, 0.5, -1.6], [0.5, 0.5, 0.5])
    n0 = (shade_volume.launches, sweep_composite_kernel.launches)
    rgba, _ = render_frame_sweep(eng, state["params"], grid, meta, cam, (60.0, 60.0),
                                 width=64, height=48)
    torch.cuda.synchronize()
    assert (shade_volume.launches, sweep_composite_kernel.launches) == (n0[0], n0[1] + 1)
    want, _ = render_frame_sweep(eng, state["params"], grid, meta, cam, (60.0, 60.0),
                                 width=64, height=48, impl="plain")
    torch.testing.assert_close(rgba, want, rtol=2e-2, atol=5e-3)
    assert float(rgba[..., 3].mean()) > 0.05


@pytest.mark.cuda
def test_conditioned_baked_frame_through_g2_equals_plain(cuda):
    """A conditioned field's baked frame through G2 equals the frame with
    the plain gathers bit for bit, with view 0's code and with view 3's."""
    from sienerf_torch.engines.nerf_baked import render_frame_baked
    from sienerf_torch.utils.camera import look_at_matrix

    eng, state, occ, grid, meta = _conditioned_bake(cuda)
    cam = look_at_matrix([2.1, 0.5, 0.6], [0.5, 0.5, 0.5])
    kw = dict(width=96, height=64, resolution=32, mode="nearest",
              n_cascades=meta["n_cascades"])
    frames = []
    for row in (None, state["params"]["extra_dims"][3]):
        n0 = gather_small.launches
        a, _ = render_frame_baked(eng, state["params"], occ["bitfield"], grid, cam,
                                  (70.0, 70.0), extra_row=row, **kw)
        n1 = gather_small.launches
        b, _ = render_frame_baked(eng, state["params"], occ["bitfield"], grid, cam,
                                  (70.0, 70.0), extra_row=row, impl="plain", **kw)
        assert n1 > n0 and gather_small.launches == n1
        assert torch.equal(a, b) and float(a[..., 3].mean()) > 0.05
        frames.append(a)
    assert not torch.equal(frames[0], frames[1])


# --- K1 on plane ranges and K2 on schedule slices (the sharded paths) ----------

PLANE_ROUTES = {"tuned": ("base", "auto"), "general": ("big", "general"),
                "general_0layer": ("base_0layer", "general"), "wide": ("w272", "wide")}


@pytest.mark.cuda
@pytest.mark.parametrize("route", list(PLANE_ROUTES))
@pytest.mark.parametrize("R,K", [(9, 3), (16, 2)])
def test_shade_plane_ranges_equal_the_whole_bake(cuda, route, R, K):
    """K1 on vertex planes [p0, p1) of the bake, on every route, equals
    those planes of one whole-bake launch bit for bit: single planes, a
    range across a cascade boundary, the last planes, and each rank's
    share of 2 and 3 ranks.  A plane of R=9 is 100 rows, of R=16 289: no
    range but the whole is a multiple of the general kernel's 64-row
    stage."""
    from sienerf_torch.parallel.mesh import shard_range

    name, path = PLANE_ROUTES[route]
    shapes = dict(GENERAL_SHAPES, **WIDE_SHAPES)[name]
    rng = np.random.default_rng(R * K)
    Rv = R + 1
    rows = rng.integers(-32767, 32768, (K * Rv ** 3, 16)).astype(np.int16)
    rows[rng.random(K * Rv ** 3) < 0.3] = -32768
    scale = rng.uniform(2e-5, 2e-4, (K, 16)).astype(np.float32)
    ws = [torch.from_numpy(rng.normal(0, 1 / np.sqrt(a), (a, b)).astype(np.float32)).to(cuda)
          for a, b in shapes]
    args = (torch.from_numpy(rows).to(cuda), torch.from_numpy(scale).to(cuda),
            torch.tensor([0.1, 1.4, -0.6], device=cuda), ws)
    kw = dict(resolution=R, n_cascades=K, **ACTS)
    full = shade._shade_volume(*args, path=path, **kw)
    storage = full.permute(0, 1, 3, 4, 2).reshape(K * Rv, Rv, Rv, 4)
    n = K * Rv
    ranges = [(0, 1), (5, 6), (Rv - 2, Rv + 3), (n - 3, n), (0, n)]
    ranges += [shard_range(n, w, r) for w in (2, 3) for r in range(w)]
    for p0, p1 in ranges:
        n0 = shade_volume.launches
        part = shade._shade_volume(*args, path=path, planes=(p0, p1), **kw)
        torch.cuda.synchronize()
        assert shade_volume.launches == n0 + 1
        assert part.shape == (p1 - p0, 4, Rv, Rv) and part.stride(1) == 1
        got = part.permute(0, 2, 3, 1).contiguous().view(torch.int16)
        assert torch.equal(got, storage[p0:p1].contiguous().view(torch.int16)), (p0, p1)
    # and the plain version of a range that crosses a cascade boundary
    part = shade._shade_volume(*args, path=path, planes=(Rv - 2, Rv + 3), **kw)
    want = shade_volume_plain(*args, planes=(Rv - 2, Rv + 3), **kw)
    torch.testing.assert_close(part.float(), want.float(), rtol=2e-2, atol=2e-3)
    for bad in ((0, 0), (-1, 2), (n - 1, n + 1)):
        with pytest.raises(ValueError, match="planes"):
            shade_volume(*args, planes=bad, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("interp,use_stop,phase,flip", SWEEP_ROWS)
def test_sweep_schedule_slices_with_best_weight(cuda, interp, use_stop, phase, flip):
    """K2 on slices of the slab schedule (a slice that holds no cascade's
    slab 0 among them), returning the best weight, against the plain
    version; and two slices folded as the sharded sweep folds them against
    one whole launch at min transmittance 0."""
    from sienerf_torch.ops.sweep import fold_partials

    R, K = 16, 2
    vol, o_c, eb, ec, stop = _sweep_inputs(R, K, 37, 131, seed=3, device=cuda)
    S = R * K
    for min_t in (1e-4, 0.0):
        args = (vol, o_c, eb, ec, 0.05, min_t, stop if use_stop else None, phase)
        kw = dict(resolution=R, n_cascades=K, interp=interp, data_flip=flip, return_bw=True)
        for s0, s1 in ((0, S), (0, 13), (13, S), (5, 9), (S - 1, S)):
            n0 = sweep_composite_kernel.launches
            got = sweep_composite_kernel(*args, schedule=(s0, s1), **kw)
            torch.cuda.synchronize()
            assert sweep_composite_kernel.launches == n0 + 1 and len(got) == 5
            want = sweep_composite_plain(*args, schedule=(s0, s1), **kw)
            for g, w in zip(got, want):
                torch.testing.assert_close(g, w.contiguous(), rtol=1e-4, atol=2e-4)
    parts = []
    for s0, s1 in ((0, 13), (13, S)):
        C, op, T, bt, bw = sweep_composite_kernel(*args, schedule=(s0, s1), **kw)
        parts.append((C, op, T, bw, bt))
    folded = fold_partials(parts)
    whole = sweep_composite_kernel(*args, resolution=R, n_cascades=K, interp=interp,
                                   data_flip=flip)
    torch.cuda.synchronize()
    for name, a, b in zip(("C", "opacity", "T"), folded[:3], whole[:3]):
        torch.testing.assert_close(a, b, rtol=0, atol=2e-5, msg=name)
    torch.testing.assert_close(folded[3], whole[3], rtol=0, atol=1e-4)
    assert float(whole[1].max()) > 0.1


@pytest.mark.cuda
@pytest.mark.parametrize("t_grad,fine", [(False, False), (True, False), (False, True)])
def test_graphed_march_equals_the_eager_march(cuda, monkeypatch, t_grad, fine):
    """The one-candidate march replays its iterations as CUDA graphs on the
    card: bit-equal to the same march launched op by op, on a first call
    (capture), on a second call with other rays (replay of the kept graph),
    with an iteration count that is not a multiple of the graph's length,
    and when every ray finishes before the iteration budget."""
    from sienerf_torch.ops import raymarch as trm
    from sienerf_torch.ops.occupancy import pack_occupancy

    g, C, N, K = 32, 3, 777, 48
    cfg = trm.MarchConfig(n_cascades=C, cone_angle=1.0 / 256.0, grid_size=g)

    def scene(seed):
        rng = np.random.default_rng(seed)
        coarse = rng.random((C, g // 4, g // 4, g // 4)) < 0.3
        bf = np.repeat(np.repeat(np.repeat(coarse, 4, 1), 4, 2), 4, 3)
        o = rng.uniform(0.1, 0.9, (N, 3)).astype(np.float32)
        d = rng.normal(size=(N, 3))
        d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
        t0 = rng.uniform(0.0, 0.1, N).astype(np.float32)
        t1 = rng.uniform(1.0, 1.5 * 2 ** (C - 1), N).astype(np.float32)
        fine_bf = np.repeat(np.repeat(np.repeat(rng.random((C, g, g, g)) < 0.6, 2, 1), 2, 2),
                            2, 3)
        t = lambda a: torch.from_numpy(a).to(cuda)  # noqa: E731
        return (pack_occupancy(t(bf)), t(o), t(d), t(t0), t(t1),
                (pack_occupancy(t(fine_bf)), 2 * g) if fine else None)

    trm._GRAPHS.clear()
    for seed, iters in ((0, 200), (1, 200), (2, 64 * 40 + 17)):
        words, o, d, t0, t1, fine_words = scene(seed)
        args = (cfg, words, o, d, t0, t1, K, iters)
        monkeypatch.setattr(trm, "GRAPHED_MARCH", True)
        got = trm.march_rays(*args, fine=fine_words, t_grad=t_grad)
        monkeypatch.setattr(trm, "GRAPHED_MARCH", False)
        want = trm.march_rays(*args, fine=fine_words, t_grad=t_grad)
        torch.cuda.synchronize()
        assert len(got) == len(want) == (6 if t_grad else 4)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and torch.equal(a, b), seed
        assert int(got[2].sum()) > 0
    assert len(trm._GRAPHS) == 1  # one shape: captured once, replayed after
