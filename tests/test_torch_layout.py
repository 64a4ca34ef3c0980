"""What the CUDA kernels K1 and K2 share with Python, checked on the CPU:
the channel-last volume both use, the plain version of K2's slab intervals
(a superset of every live sample; the composite over them equals the full
loop bit for bit), and K1's fragment-order weight packing.  Inputs come
from numpy seeds.  This file imports no JAX."""

import functools
from pathlib import Path

import numpy as np
import pytest
import torch

from sienerf_torch.common import NerfActivation
from sienerf_torch.ops.shade import (
    KERNEL_RGB_MLP,
    _packed_for,
    pack_shade_weights,
    shade_planes,
    shade_volume_plain,
    unpack_shade_weights,
)
from sienerf_torch.ops.sweep import (
    canon_coords,
    orient_grid,
    slab_intervals,
    slab_schedule,
    sweep_composite,
)
from sienerf_torch.ops.sweep_kernel import sweep_composite_plain
from test_torch_kernels import _shade_inputs, _sweep_inputs

FOX = Path(__file__).resolve().parent.parent / "data" / "fox_render.snap"
ACTS = dict(density_act=NerfActivation.EXPONENTIAL, rgb_act=NerfActivation.LOGISTIC)


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _camera(seed, axis, flip):
    """A random camera outside the unit cube looking along `axis` ->
    (o_c, eb, ec, t_stop) in canonical sweep coordinates."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(0.2, 0.8, 3).astype(np.float32)
    o[axis] = rng.uniform(1.3, 2.5) if flip else -rng.uniform(0.3, 1.5)
    o_c = canon_coords(torch.from_numpy(o), axis, flip, True)
    Hi, Wi = 24, 40
    c = rng.uniform(-0.15, 0.15, 2)
    eb = _t(np.linspace(c[0] - 0.5, c[0] + 0.55, Hi))
    ec = _t(np.linspace(c[1] - 0.6, c[1] + 0.5, Wi))
    eb[Hi // 2] = 0.0  # a ray parallel to a face
    stop = _t(rng.uniform(0.4, 3.0, (Hi, Wi)))
    return o_c, eb, ec, stop


# --- (a) the channel-last volume ---------------------------------------------


@pytest.mark.parametrize("R,K", [(4, 1), (5, 3), (8, 2)])
def test_plain_shade_is_channel_last_and_equals_planar(R, K):
    rows, scale, cam, ws = _shade_inputs(R, K)
    Rv = R + 1
    vol = shade_volume_plain(rows, scale, cam, ws, resolution=R, n_cascades=K, **ACTS)
    assert vol.shape == (K, Rv, 4, Rv, Rv) and vol.dtype == torch.bfloat16
    assert vol.stride(2) == 1 and vol.stride(4) == 4 and vol.stride(3) == 4 * Rv
    # the channel-planar volume, built from the per-plane shade directly
    planes = rows.reshape(K * Rv, Rv * Rv, 16)
    casc = torch.arange(K).repeat_interleave(Rv)
    iplane = torch.arange(Rv).repeat(K)
    flat = shade_planes(planes, casc, iplane, scale, cam, ws, KERNEL_RGB_MLP,
                        resolution=R, **ACTS)
    planar = torch.empty((K, Rv, 4, Rv, Rv), dtype=torch.bfloat16)
    for c in range(4):
        planar[:, :, c] = flat[..., c].reshape(K, Rv, Rv, Rv)
    assert planar.is_contiguous() and torch.equal(vol, planar)


@pytest.mark.parametrize("interp", ["nearest", "bilinear"])
@pytest.mark.parametrize("axis,flip", [(0, True), (1, False), (2, False), (2, True)])
def test_plain_composite_same_from_either_layout(axis, flip, interp):
    R, K = 8, 2
    vol5 = _sweep_inputs(R, K, 8, 8, channel_last=True)[0]
    o_c, eb, ec, _ = _camera(axis, axis, flip)
    view = orient_grid(vol5, axis, False)  # a strided view of channel-last storage
    assert view.stride(2) == 1 and not view.is_contiguous()
    kw = dict(resolution=R, n_cascades=K, interp=interp, data_flip=flip)
    a = sweep_composite_plain(view, o_c, eb, ec, 0.05, 1e-4, phase=0.25, **kw)
    b = sweep_composite_plain(view.contiguous(), o_c, eb, ec, 0.05, 1e-4, phase=0.25, **kw)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert float(a[1].max()) > 0.1


@functools.lru_cache(maxsize=1)
def _fox_cpu():
    from sienerf_torch.session import Session

    s = Session(device="cpu")
    s.load_snapshot(FOX)
    return s, s.bake(resolution=16)


@pytest.mark.parametrize("eye", [(0.5, 0.5, -1.6), (2.1, 0.5, 0.6), (0.4, -1.3, 0.5)])
def test_frame_same_through_wrappers_and_plain(eye):
    """The 64x64 fox frame through the kernel wrappers (on the CPU they hand
    the plain versions the channel-last views) against impl='plain', which
    composites a contiguous-free orient_grid view of the plain shade."""
    from sienerf_torch.engines.nerf_sweep import render_frame_sweep
    from sienerf_torch.utils.camera import look_at_matrix

    s, (grid, meta) = _fox_cpu()
    cam = look_at_matrix(list(eye), [0.5, 0.5, 0.5])
    kw = dict(width=64, height=64, packed=True, min_transmittance=1e-4)
    a = render_frame_sweep(s.engine, s.state["params"], grid, meta, cam, (48.0, 48.0),
                           impl="kernel", **kw)
    b = render_frame_sweep(s.engine, s.state["params"], grid, meta, cam, (48.0, 48.0),
                           impl="plain", **kw)
    assert torch.equal(a, b)
    assert float(a[3].mean()) > 0.3


# --- (b) K2's slab intervals ---------------------------------------------------


def _live(o_c, eb, ec, near, stop, phase, R, K):
    """Per schedule entry, the samples the composite's own f32 tests call
    live: (S, Hi, Wi) bool, with the entries' cascade and slab index."""
    f32 = np.float32
    o0, o1, o2 = (f32(v) for v in o_c.numpy())
    eb, ec = eb.numpy(), ec.numpy()
    L = np.sqrt(f32(1) + eb[:, None] ** 2 + ec[None, :] ** 2)
    casc, slab, xs, pitches, _ = slab_schedule(K, R)
    live = []
    for x, pitch in zip(xs, pitches):
        if phase is not None:
            x = x + f32(phase) * pitch
        x_rel = x - o0
        t_hat = x_rel * L
        lo = f32(0.5) - f32(0.5) * pitch * f32(R)
        gu = (o1 + x_rel * eb - lo) / pitch
        gv = (o2 + x_rel * ec - lo) / pitch
        ok = (t_hat >= f32(near)) & ((gu >= 0) & (gu <= R))[:, None] \
            & ((gv >= 0) & (gv <= R))[None, :]
        if stop is not None:
            ok &= t_hat <= stop.numpy()
        live.append(ok)
    return np.stack(live), casc, slab


@pytest.mark.parametrize("R,K", [(5, 3), (16, 2)])
@pytest.mark.parametrize("use_stop", [False, True])
@pytest.mark.parametrize("phase", [None, 0.4375])
@pytest.mark.parametrize("flip", [False, True])
def test_slab_intervals_hold_every_live_sample(R, K, use_stop, phase, flip):
    for seed in range(4):
        axis = seed % 3
        o_c, eb, ec, stop = _camera(10 * seed + R, axis, flip)
        stop = stop if use_stop else None
        ja, jb = slab_intervals(o_c, eb, ec, 0.05, stop, phase, resolution=R, n_cascades=K)
        assert ja.shape == jb.shape == (K, eb.shape[0], ec.shape[0])
        assert int(ja.min()) >= 0 and int(jb.max()) <= R
        live, casc, slab = _live(o_c, eb, ec, 0.05, stop, phase, R, K)
        assert live.any()
        j = slab[:, None, None]
        inside = (ja.numpy()[casc] <= j) & (j < jb.numpy()[casc])
        assert not (live & ~inside).any()  # never a miss
        # and not the trivial superset: the intervals drop most dead samples
        assert inside.sum() < 0.8 * live.size or live.mean() > 0.5


@pytest.mark.parametrize("R,K", [(5, 3), (16, 2)])
@pytest.mark.parametrize("interp,use_stop,phase,flip", [
    ("nearest", False, None, False), ("bilinear", False, None, True),
    ("nearest", True, 0.4375, False), ("bilinear", True, 0.4375, True),
    ("nearest", True, None, True),
])
def test_composite_over_intervals_equals_full_loop(R, K, interp, use_stop, phase, flip):
    vol5 = _sweep_inputs(R, K, 8, 8, seed=R, channel_last=True)[0]
    for axis in (0, 1, 2):
        o_c, eb, ec, stop = _camera(7 + axis, axis, flip)
        stop = stop if use_stop else None
        oriented = orient_grid(vol5, axis, flip)
        kw = dict(resolution=R, n_cascades=K, interp=interp)
        full = sweep_composite(oriented, o_c, eb, ec, 0.05, 1e-4, stop, phase, **kw)
        iv = slab_intervals(o_c, eb, ec, 0.05, stop, phase, resolution=R, n_cascades=K)
        cut = sweep_composite(oriented, o_c, eb, ec, 0.05, 1e-4, stop, phase,
                              intervals=iv, **kw)
        for a, b in zip(full, cut):
            assert torch.equal(a, b)
        assert float(full[1].max()) > 0.1


def test_slab_intervals_empty_for_a_pixel_that_misses():
    R, K = 16, 2
    o_c = _t([-0.5, 0.5, 0.5])
    eb, ec = _t([0.0, 15.0]), _t([0.0, -15.0])  # the second ray leaves at once
    ja, jb = slab_intervals(o_c, eb, ec, 0.05, resolution=R, n_cascades=K)
    assert int(jb[0, 0, 0]) - int(ja[0, 0, 0]) >= R - 1      # the axial ray sees all
    assert int(jb[0, 1, 1]) == 0 and int(ja[0, 1, 1]) == R   # cascade 0 never
    assert int(jb[1, 1, 1]) - int(ja[1, 1, 1]) <= 3


# --- (c) K1's packed weights ----------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1])
def test_packed_shade_weights_unpack_to_the_originals(seed):
    rng = np.random.default_rng(seed)
    ws = [_t(rng.normal(0, 0.3, shp)) for shp in ((32, 64), (64, 64), (64, 3))]
    packed = pack_shade_weights(ws)
    assert packed.dtype == torch.bfloat16 and packed.shape == (6656,)  # 13,312 bytes
    for w, u in zip(ws, unpack_shade_weights(packed)):
        assert torch.equal(w.to(torch.bfloat16), u)
    # W3's padding (outputs 3..7 of its one n8 tile) is zero: 5 of 8 values
    assert int((packed[-512:] == 0).sum()) >= 512 * 5 // 8


def test_packed_weights_are_kept_until_the_weights_change():
    rng = np.random.default_rng(3)
    ws = [_t(rng.normal(0, 0.3, shp)) for shp in ((32, 64), (64, 64), (64, 3))]
    cpu = torch.device("cpu")
    a = _packed_for(ws, cpu)
    assert _packed_for(ws, cpu) is a and torch.equal(a, pack_shade_weights(ws))
    ws[1].mul_(0.5)  # written in place: packed again
    b = _packed_for(ws, cpu)
    assert b is not a and torch.equal(b, pack_shade_weights(ws))
    other = [w.clone() for w in ws]  # equal values, other tensors: packed again
    assert _packed_for(other, cpu) is not b


def test_packed_weights_follow_the_mma_b_fragment():
    """Lane 4g+t of the (k16 tile kt, n8 tile nt) B fragment holds
    B[16kt + 2t + {0,1,8,9}, 8nt + g]."""
    ws = [torch.arange(n_in * n_out, dtype=torch.float32).reshape(n_in, n_out) % 251
          for n_in, n_out in ((32, 64), (64, 64), (64, 3))]
    packed = pack_shade_weights(ws).float()
    for layer, base, n_kt in ((0, 0, 2), (1, 2048, 4)):
        frag = packed[base:base + n_kt * 4 * 32 * 8].reshape(n_kt, 4, 32, 2, 4)
        for kt, npair, lane, half in ((0, 0, 0, 0), (1, 3, 13, 1), (n_kt - 1, 2, 31, 0)):
            g, t = lane // 4, lane % 4
            want = [ws[layer][16 * kt + 2 * t + d, 16 * npair + 8 * half + g]
                    for d in (0, 1, 8, 9)]
            assert frag[kt, npair, lane, half].tolist() == [float(x) for x in want]
    frag = packed[2048 + 4096:].reshape(4, 32, 4)
    for kt, lane in ((0, 0), (2, 9), (3, 11), (1, 30)):
        g, t = lane // 4, lane % 4
        want = [float(ws[2][16 * kt + 2 * t + d, g]) if g < 3 else 0.0 for d in (0, 1, 8, 9)]
        assert frag[kt, lane].tolist() == want
