"""The fork's hybrid scene on the port's main path, `Session.render(...,
renderer="sweep")` on a geometry scene, held to the benchmark's plain
reference (perfbench/reference/hybrid.py), and K3 (csrc/bvh.cu) held to
the plain BVH walk.

On the CPU a run of the `foxmesh3.hybrid1080` cell at a small size (seeded
NeRF weights over the fox's occupancy, 64x36 frames, an R=16 bake, 2^3
probes of 16x8 rays, three meshes of the configuration's shape at 528
triangles each, the BVH tier forced by BRUTE_MAX_TRIS = 0) goes through
the benchmark's own set-up, window and check.  Its frames must be the
reference's to one 8-bit level on every value (the two compute the same
f32 formulas, partly in other orders: a value moved by a few ulps can
round to the next level), and mean_abs within the cell's limit.  Planted
faults (shadow rays dropped, the probe ambient replaced by the constant
sky, the per-pixel stop ignored) and the control (the reference on e4m3
MLP operands and bf16 mesh rays) must fail that limit.  The `view` kind's
spp-1 frame is held to its one-pass reference the same way.

Tests marked `cuda` run on the card with the committed fox and the
benchmark's full-size scene (208,353 triangles): K3's closest and any hit
against the plain walk on one 1080p frame's primary, shadow and
depth-stop rays, its count of walked rays, and a 1080p hybrid frame under
torch.cuda.set_sync_debug_mode("error").  This file imports no JAX, so on
the card it runs without the repo's conftest:
    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_hybrid_cell.py
"""

from __future__ import annotations

import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch

from perfbench import generator, scene, spec
from perfbench.compare import judge, load_limits
from perfbench.run import run_cell

HYBRID = "foxmesh3.hybrid1080"
VIEW = "base84.view1080"
SEED = 2 ** 31 + 3
SMALL_NET = {"encoding": {"log2_hashmap_size": 12},
             "weights": {"kind": "seeded", "occupancy": "data/fox_render.snap"}}
SMALL = {"width": 64, "height": 36, "bake_resolution": 16, "path": {"n_cameras": 12, "stride": 5},
         "config": dict(SMALL_NET, scene={
             "shape": {"n_lon": 24, "n_lat": 12, "n_waves": 6, "bump": 0.25, "degenerate": 1},
             "probe_grid": {"grid_size": 2, "env_width": 16, "env_height": 8}})}
VIEW_SMALL = {"width": 64, "height": 36, "bake_resolution": 16,
              "path": {"n_cameras": 12, "stride": 5}, "config": SMALL_NET}
FULL = (1920, 1080, 1650.0)


@pytest.fixture(autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture
def bvh_tier(monkeypatch):
    from sienerf_torch.engines import geometry

    monkeypatch.setattr(geometry, "BRUTE_MAX_TRIS", 0)


def _hybrid_run():
    return run_cell(HYBRID, SEED, 1.0, False, "cpu", {"platform": "cpu"}, overrides=SMALL)


def test_the_hybrid_sweep_frame_is_the_references(bvh_tier):
    line, numbers = _hybrid_run()
    assert line["correct"], numbers
    assert numbers["max_abs"] <= 1.0, numbers
    assert line["attempted"] >= 1 and line["failed"] == 0
    assert set(line["metrics"]) == {"frame_ms", "frame_p95_ms", "setup_s"}


def _no_shadow(monkeypatch):
    from sienerf_torch.engines.geometry import GeometryEngine

    monkeypatch.setattr(GeometryEngine, "_occluded",
                        lambda self, geom, o, d, mask: torch.zeros_like(mask))


def _sky_ambient(monkeypatch):
    from sienerf_torch.engines.geometry import GeometryEngine

    ambient = GeometryEngine._ambient_for

    def sky(self, geom, pos, normals):
        return ambient(self, {k: v for k, v in geom.items() if k != "probe_grid"}, pos, normals)
    monkeypatch.setattr(GeometryEngine, "_ambient_for", sky)


def _no_stop(monkeypatch):
    from sienerf_torch.ops import sweep_kernel

    composite = sweep_kernel.sweep_composite_kernel

    def ignored(volume, o_c, eb, ec, near, min_t, t_stop=None, *a, **kw):
        return composite(volume, o_c, eb, ec, near, min_t, None, *a, **kw)
    ignored.launches = 0
    monkeypatch.setattr(sweep_kernel, "sweep_composite_kernel", ignored)


@pytest.mark.parametrize("fault", ["no_shadow", "sky_ambient", "no_stop"])
def test_a_planted_fault_is_not_correct(bvh_tier, fault, monkeypatch):
    {"no_shadow": _no_shadow, "sky_ambient": _sky_ambient, "no_stop": _no_stop}[fault](
        monkeypatch)
    line, numbers = _hybrid_run()
    assert not line["correct"], (fault, numbers)


def test_the_hybrid_control_is_not_correct():
    from perfbench.control_hybrid import control_numbers

    ok, checks = judge(control_numbers(HYBRID, SEED, "cpu", overrides=SMALL), load_limits(HYBRID))
    assert not ok, checks


def test_the_view_frame_is_its_one_pass_reference():
    line, numbers = run_cell(VIEW, SEED, 1.0, False, "cpu", {"platform": "cpu"},
                             overrides=VIEW_SMALL)
    assert line["correct"] and numbers["max_abs"] <= 1.0, numbers


def test_the_view_control_is_not_correct():
    from perfbench.control_hybrid import control_numbers

    ok, checks = judge(control_numbers(VIEW, SEED, "cpu", overrides=VIEW_SMALL),
                       load_limits(VIEW))
    assert not ok, checks


def test_the_scene_has_the_bunny_count_and_no_camera_inside_a_mesh():
    cfg = spec.load_config(spec.load_benchmark(), "foxmesh3")
    sc = cfg["scene"]
    assert scene.triangle_count(sc["shape"]) == sc["triangles_per_mesh"] == 69451
    cams = generator.fibonacci_cameras(120, 1.8)
    lo, hi = np.asarray(sc["probe_box"][0]), np.asarray(sc["probe_box"][1])
    for m in sc["meshes"]:
        c, r = np.asarray(m["center"]) + 0.5, m["scale"] / 2
        assert 0.12 <= r <= 0.25 and (c - r >= lo - 1e-9).all() and (c + r <= hi + 1e-9).all()
        assert min(np.linalg.norm(cam[:, 3] - c) for cam in cams) > 2 * r


# --- the new metrics' readers, on synthetic traces ------------------------------

MS = 1_000_000  # ns
K3 = "void (anonymous namespace)::bvh_walk_kernel<false, false>(Bvh, float const*)"
K3_EVENTS = [("elementwise", 0, 4 * MS), (K3, 4 * MS, 1 * MS), (K3, 5 * MS, 1 * MS),
             (K3, 6 * MS, 2 * MS), ("sweep_kernel<true>", 8 * MS, 3 * MS),
             (K3, 20 * MS, 2 * MS), (K3, 22 * MS, 1 * MS), (K3, 23 * MS, 1 * MS)]
WORK = {"box_tests": 10 ** 8, "tri_tests": 2 * 10 ** 7, "bytes": 3 * 10 ** 8,
        "rays": {"primary": 1, "shadow_walked": 1, "depth": 1}}


def _read(name, ctx):
    return spec.metric_reader(name)(ctx)


class _Filled:
    """A recorder whose recording was filled by hand."""

    def __init__(self, recording):
        self.recording = recording

    def read(self):
        return self.recording


def test_k3_readers_on_a_synthetic_trace(monkeypatch):
    from perfbench import bvh_work
    from sienerf_torch import tracing
    from sienerf_torch.tracing import Recording

    ctx = {"events": K3_EVENTS, "bvh_work": {5: WORK}, "frame_index": {5: 1},
           "counts": {"frames": 2, "k3_launches": 6}}
    bound = max((10 ** 8 * bvh_work.BOX_FLOPS + 2 * 10 ** 7 * bvh_work.TRI_FLOPS)
                / bvh_work.F32_FLOPS, 3 * 10 ** 8 / bvh_work.HBM_BYTES_S)
    assert _read("k3_roofline", ctx) == pytest.approx(100 * bound / 4e-3)
    for broken in ({"events": None}, {"bvh_work": None},
                   {"counts": {"frames": 3, "k3_launches": 6}},
                   {"events": [e for e in K3_EVENTS if e[0] != K3]}):
        assert _read("k3_roofline", dict(ctx, **broken)) is None
    monkeypatch.setattr(tracing, "RECORDER", _Filled(Recording([], {"k3.rays": 7 * 10 ** 6})))
    assert _read("k3_grays_s.hybrid", ctx) == pytest.approx(7e6 / 8e6)
    assert _read("k3_grays_s.hybrid", dict(ctx, events=None)) is None
    assert _read("k3_grays_s.hybrid", dict(ctx, events=K3_EVENTS[:1])) is None
    monkeypatch.setattr(tracing, "RECORDER", _Filled(Recording([])))
    assert _read("k3_grays_s.hybrid", ctx) is None  # a recording without K3


def test_the_benchmarks_walk_is_the_plain_walk():
    """bvh_work.walk, which counts K3's tests for its roofline, finds the
    plain walk's hits (closest and any) on a BVH several levels deep."""
    from perfbench import bvh_work
    from sienerf_torch.geom.bvh import build_bvh, bvh_raytrace_plain

    v, f = scene.star_mesh({"n_lon": 24, "n_lat": 12, "n_waves": 6, "bump": 0.25,
                            "degenerate": 1}, SEED, 0)
    bvh = build_bvh(v[f]).as_device_arrays("cpu")
    g = torch.Generator().manual_seed(5)
    o = torch.tensor([2.0, 0.3, 0.2])
    d = torch.nn.functional.normalize(-o + 0.4 * torch.randn((512, 3), generator=g), dim=-1)
    n_box, n_tri, t, tid = bvh_work.walk(bvh, o, d)
    pt, pid, _, _ = bvh_raytrace_plain(bvh, o.expand(d.shape), d)
    assert torch.equal(tid, pid) and torch.equal(t, pt) and 0 < int((tid >= 0).sum()) < 512
    assert n_box > 512 and 0 < n_tri <= 4 * n_box
    _, _, _, any_id = bvh_work.walk(bvh, o, d, any_hit=True)
    assert torch.equal(any_id >= 0, pid >= 0)


def test_mesh_ms_reads_the_mesh_and_depth_trace_phases(monkeypatch):
    from sienerf_torch import tracing
    from sienerf_torch.tracing import Recording, Span

    spans = []  # two frames: phases of 1, 6, 3, 2 and 2.5 device ms, a `bvh` span in `mesh`
    for f in range(2):
        spans.append(Span("render", -1, f, 100 * f * MS, (100 * f + 30) * MS, None))
        root, d = len(spans) - 1, 40.0 * f
        for name, ms in (("rest", 1.0), ("mesh", 6.0), ("depth_trace", 3.0), ("shade", 2.0),
                         ("sweep", 2.5)):
            spans.append(Span(name, root, f, 0, 1, (d, d + ms)))
            d += ms
        spans.append(Span("bvh", root, f, 0, 1, (40.0 * f + 2.0, 40.0 * f + 3.5)))

    class Filled:
        def read(self):
            return Recording(spans)
    monkeypatch.setattr(tracing, "RECORDER", Filled())
    assert _read("mesh_ms.hybrid", {"events": K3_EVENTS}) == pytest.approx(6.0 + 3.0)
    assert _read("mesh_ms.hybrid", {"events": None}) is None
    spans.clear()
    assert _read("mesh_ms.hybrid", {"events": K3_EVENTS}) is None


# --- on the card -------------------------------------------------------------


@pytest.fixture(scope="module")
def card_scene():
    """The benchmark's full-size scene on the card with the fox bound and
    baked, and the rays of one 1080p frame."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    from perfbench.kinds.hybrid import load_scene

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = spec.load_config(spec.load_benchmark(), "foxmesh3")
    d = Path(tempfile.mkdtemp())
    s, fox = load_scene(cfg, SEED, d, "cuda", {"bake_resolution": 256}, {})
    geo = s.engine
    W, H, F = FULL
    cam = generator.camera_path(spec.load_traffic("hybrid1080")["path"], SEED)[7]
    s.render(W, H, cam, focal=(F, F), renderer="sweep")  # warm-up
    o, d_ = geo._frame_rays(W, H, cam, (F, F), "cuda")
    du = d_ / torch.sqrt((d_ * d_).sum(-1, keepdim=True))
    st = {}
    geo.render_frame(W, H, cam, (F, F), renderer="sweep", stats=st)
    _, eb, ec, _, _ = st["intermediate"]
    hi, wi = eb.shape[0], ec.shape[0]
    b_ax, c_ax = [a for a in (0, 1, 2) if a != st["axis"]]
    dw = torch.zeros((hi * wi, 3), device="cuda")
    dw[:, st["axis"]] = -1.0 if st["flip"] else 1.0
    dw[:, b_ax] = eb[:, None].expand(hi, wi).reshape(-1)
    dw[:, c_ax] = ec[None, :].expand(hi, wi).reshape(-1)
    dw = dw / torch.sqrt((dw * dw).sum(-1, keepdim=True))
    return {"session": s, "fox": fox, "geo": geo, "cam": cam, "o": o, "du": du,
            "depth_o": o[0].expand(dw.shape), "dw": dw}


def _agree(k3, plain, name):
    """Closest hits of K3 and of the plain walk: ids equal except at ties
    (at most 1e-5 of the rays, each nearer than 1e-5 relative in t), t
    equal to the bit where the ids agree."""
    t1, i1, u1, v1 = k3
    t2, i2, u2, v2 = plain
    diff = i1 != i2
    n = i1.shape[0]
    assert int(diff.sum()) <= max(1, int(1e-5 * n)), (name, int(diff.sum()), n)
    if bool(diff.any()):
        both = (i1[diff] >= 0) & (i2[diff] >= 0)
        assert bool(both.all()), name
        rel = (t1[diff] - t2[diff]).abs() / t2[diff].abs()
        assert float(rel.max()) <= 1e-5, (name, float(rel.max()))
    same = ~diff
    bits = (t1[same].view(torch.int32) != t2[same].view(torch.int32)) \
        & ~(torch.isinf(t1[same]) & torch.isinf(t2[same]))
    assert int(bits.sum()) == 0, (name, "t differs in its bits on", int(bits.sum()), "rays")
    assert torch.equal(u1[same & (i1 >= 0)], u2[same & (i2 >= 0)])
    assert torch.equal(v1[same & (i1 >= 0)], v2[same & (i2 >= 0)])


@pytest.mark.cuda
def test_k3_closest_and_any_hit_are_the_plain_walks(card_scene):
    from sienerf_torch.geom.bvh import bvh_any_hit, bvh_raytrace, bvh_raytrace_plain
    from sienerf_torch.ops.bvh_kernel import bvh_walk_kernel

    c = card_scene
    bvh = c["geo"].bvh_dev
    n0 = bvh_walk_kernel.launches
    prim = bvh_raytrace(bvh, c["o"], c["du"])
    _agree(prim, bvh_raytrace_plain(bvh, c["o"], c["du"]), "primary")
    depth = bvh_raytrace(bvh, c["depth_o"], c["dw"])
    _agree(depth, bvh_raytrace_plain(bvh, c["depth_o"], c["dw"]), "depth-stop")
    t, tid = prim[0], prim[1]
    hit = tid >= 0
    assert 0.05 < float(hit.float().mean()) < 0.5
    n = c["geo"].tri_normals[torch.clamp(tid, min=0)]
    n = n * torch.where((n * c["du"]).sum(-1, keepdim=True) > 0, -1.0, 1.0)
    spos = c["o"] + torch.where(hit, t, 0.0)[:, None] * c["du"] + n * 1e-3
    sun = torch.tensor([0.577, 0.577, 0.577], device="cuda")
    sun = (sun / torch.sqrt((sun * sun).sum())).expand(spos.shape)
    k3 = bvh_any_hit(bvh, spos, sun, mask=hit)
    plain = bvh_raytrace_plain(bvh, spos, sun, mask=hit)[1] >= 0
    assert torch.equal(k3, plain) and not bool(k3[~hit].any()) and bool(k3.any())
    assert bvh_walk_kernel.launches - n0 == 3


@pytest.mark.cuda
def test_k3_counts_the_rays_it_walks_while_recording(card_scene, monkeypatch):
    from sienerf_torch import tracing
    from sienerf_torch.geom.bvh import bvh_any_hit, bvh_raytrace

    c = card_scene
    bvh = c["geo"].bvh_dev
    o, du = c["o"][::64], c["du"][::64].contiguous()
    mask = torch.arange(du.shape[0], device="cuda") % 3 == 0
    plain = (*bvh_raytrace(bvh, o, du), bvh_any_hit(bvh, o, du, mask=mask))
    monkeypatch.setattr(tracing, "profiling", lambda: True)
    with tracing.RECORDER.frame("render", "cuda"):
        counted = (*bvh_raytrace(bvh, o, du), bvh_any_hit(bvh, o, du, mask=mask))
    got = tracing.RECORDER.read().counters
    for a, b in zip(plain, counted):
        assert torch.equal(a, b)
    assert got["k3.rays"] == du.shape[0] + int(mask.sum())


@pytest.mark.cuda
def test_a_1080p_hybrid_frame_never_synchronises(card_scene):
    from sienerf_torch.ops.bvh_kernel import bvh_walk_kernel
    from sienerf_torch.ops.shade import shade_volume
    from sienerf_torch.ops.sweep_kernel import sweep_composite_kernel

    W, H, F = FULL
    s = card_scene["session"]
    n0 = (bvh_walk_kernel.launches, shade_volume.launches, sweep_composite_kernel.launches)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        rgba = s.render(W, H, card_scene["cam"], focal=(F, F), renderer="sweep")
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert rgba.shape == (H, W, 4) and bool(torch.isfinite(rgba).all())
    n1 = (bvh_walk_kernel.launches, shade_volume.launches, sweep_composite_kernel.launches)
    assert tuple(b - a for a, b in zip(n0, n1)) == (3, 1, 1)
