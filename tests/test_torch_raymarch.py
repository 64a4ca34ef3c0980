"""Port vs reference: the occupancy probes, the ray march and the chunk
composite on random bitfields and rays (after tests/test_raymarch.py).

Tolerances: sample counts and probe results equal; ts and dts rtol 1e-6
(the same f32 operations in the same order); composite rtol 1e-5 /
atol 1e-6 (cumprod, prod and the sums run in another order).  The JAX
functions run eagerly, op by op, as the port does: under `jit` XLA on the
CPU may contract `o + t*d` into a fused multiply-add, which moves single
samples across voxel boundaries (test_jit_contraction_is_the_only_march_gap
shows that this is the only gap to the jitted march)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sienerf_tpu.ops import occupancy as jocc
from sienerf_tpu.ops import raymarch as jrm
from sienerf_torch.ops import occupancy as tocc
from sienerf_torch.ops import raymarch as trm


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _scene(seed, n_cascades, g, n, fill=0.35, cone=None):
    """Random blocky bitfield and rays that start inside the unit cube."""
    rng = np.random.default_rng(seed)
    coarse = rng.random((n_cascades, g // 4, g // 4, g // 4)) < fill
    bf = np.repeat(np.repeat(np.repeat(coarse, 4, 1), 4, 2), 4, 3)
    o = rng.uniform(0.1, 0.9, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3))
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    t0 = rng.uniform(0.0, 0.1, n).astype(np.float32)
    t1 = rng.uniform(1.0, 1.5 * 2 ** (n_cascades - 1), n).astype(np.float32)
    cone = (0.0 if n_cascades == 1 else 1.0 / 256.0) if cone is None else cone
    return bf, o, d, t0, t1, cone


def _configs(n_cascades, cone, g):
    return (jrm.MarchConfig(n_cascades=n_cascades, cone_angle=cone, grid_size=g),
            trm.MarchConfig(n_cascades=n_cascades, cone_angle=cone, grid_size=g))


def test_constants_match():
    from sienerf_tpu import common as jc
    from sienerf_torch import common as tc

    for name in ("MIN_CONE_STEPSIZE", "MAX_CONE_STEPSIZE", "NERF_GRIDSIZE",
                 "NERF_RENDERING_NEAR_DISTANCE"):
        assert getattr(jc, name) == getattr(tc, name)
    assert jrm.cone_angle_for_aabb(1.0) == trm.cone_angle_for_aabb(1.0) == 0.0
    assert jrm.cone_angle_for_aabb(4.0) == trm.cone_angle_for_aabb(4.0)


@pytest.mark.parametrize("n_cascades,g", [(1, 16), (3, 16), (2, 12)])
def test_pack_occupancy_words_bit_equal(n_cascades, g):
    rng = np.random.default_rng(5)
    bf = rng.random((n_cascades, g, g, g)) < 0.3
    want = np.asarray(jocc.pack_occupancy(jnp.asarray(bf)))  # uint32 rows
    got = tocc.pack_occupancy(_t(bf))
    assert got.dtype == torch.int32 and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)


def test_packed_lookup_matches_reference_and_scalar():
    rng = np.random.default_rng(7)
    g, C = 16, 3
    bf = rng.random((C, g, g, g)) < 0.3
    pos = rng.uniform(-1.5, 2.5, size=(4096, 3)).astype(np.float32)
    mip = rng.integers(0, C, size=(4096,))
    want = np.asarray(jocc.occupancy_lookup_packed(
        jocc.pack_occupancy(jnp.asarray(bf)), g, jnp.asarray(pos),
        jnp.asarray(mip, jnp.int32)))
    words = tocc.pack_occupancy(_t(bf))
    got = tocc.occupancy_lookup_packed(words, g, _t(pos), _t(mip))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        got.numpy(), tocc.occupancy_lookup(_t(bf), _t(pos), _t(mip)).numpy())
    # (rays, span) index shape, as the span march probes it
    got2 = tocc.occupancy_lookup_packed(words, g, _t(pos).reshape(64, 64, 3),
                                        _t(mip).reshape(64, 64))
    np.testing.assert_array_equal(got2.numpy().reshape(-1), want)


def test_mip_selection_matches():
    rng = np.random.default_rng(2)
    pos = rng.uniform(-3.0, 4.0, (2048, 3)).astype(np.float32)
    pos[:8] = [[0.5, 0.5, 0.5], [1.0, 0.5, 0.5], [1.5, 0.5, 0.5], [0.0, 0.5, 0.5],
               [2.5, 0.5, 0.5], [0.5, -0.5, 0.5], [0.5, 0.5, 1.0001], [0.9, 0.5, 0.5]]
    dt = np.exp(rng.uniform(np.log(1e-4), np.log(1.0), 2048)).astype(np.float32)
    for n in (1, 3, 8):
        np.testing.assert_array_equal(
            tocc.mip_from_pos(_t(pos), n).numpy(),
            np.asarray(jocc.mip_from_pos(jnp.asarray(pos), n)))
        np.testing.assert_array_equal(
            tocc.mip_from_dt(_t(dt), n, 128).numpy(),
            np.asarray(jocc.mip_from_dt(jnp.asarray(dt), n, 128)))


@pytest.mark.parametrize("fill", [0.0, 0.2, 1.0])
def test_occupied_bbox_and_ray_box_times(fill):
    rng = np.random.default_rng(11)
    bf = np.zeros((3, 16, 16, 16), bool)
    if fill:
        bf[0, 3:9, 5:7, 2:14] = rng.random((6, 2, 12)) < fill
        bf[1, 4:6, 4:12, 8:9] = fill == 1.0
    jlo, jhi = jocc.occupied_bbox(jnp.asarray(bf))
    lo, hi = tocc.occupied_bbox(_t(bf))
    np.testing.assert_array_equal(lo.numpy(), np.asarray(jlo))
    np.testing.assert_array_equal(hi.numpy(), np.asarray(jhi))
    _, o, d, _, _, _ = _scene(1, 1, 16, 256)
    d[:4, 0] = 0.0  # axis-parallel rays take the 1e-12 guard
    want = jocc.ray_box_times(jnp.asarray(o), jnp.asarray(d), jlo, jhi)
    got = tocc.ray_box_times(_t(o), _t(d), lo, hi)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)


def test_calc_dt_and_voxel_skip_match():
    bf, o, d, t0, t1, cone = _scene(3, 3, 16, 512)
    t = _t(t0) + 0.3
    np.testing.assert_array_equal(trm.calc_dt(t, cone).numpy(),
                                  np.asarray(jrm.calc_dt(jnp.asarray(t.numpy()), cone)))
    pos = o + t.numpy()[:, None] * d
    mip = np.random.default_rng(0).integers(0, 3, 512)
    dt = trm.calc_dt(t, cone)
    want = jrm._next_voxel_skip(jnp.asarray(t.numpy()), jnp.asarray(pos), jnp.asarray(d),
                                jnp.asarray(mip, jnp.int32), jnp.asarray(dt.numpy()), 16)
    got = trm._next_voxel_skip(t, _t(pos), _t(d), _t(mip), dt, 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


MARCH_CASES = {
    "scalar-1casc": dict(n_cascades=1, g=32, span=1),
    "scalar-3casc-cone": dict(n_cascades=3, g=32, span=1),
    "span4-1casc": dict(n_cascades=1, g=32, span=4),
    "span4-3casc-cone": dict(n_cascades=3, g=32, span=4),
}


@pytest.mark.parametrize("case", list(MARCH_CASES))
def test_march_rays_matches_reference(case):
    c = MARCH_CASES[case]
    bf, o, d, t0, t1, cone = _scene(0, c["n_cascades"], c["g"], 256)
    jcfg, tcfg = _configs(c["n_cascades"], cone, c["g"])
    K, iters = 24, 96 if c["span"] == 1 else 40
    with jax.disable_jit():
        want = jrm.march_rays(jcfg, jnp.asarray(bf), jnp.asarray(o), jnp.asarray(d),
                              jnp.asarray(t0), jnp.asarray(t1), K, iters, span=c["span"])
    got = trm.march_rays(tcfg, _t(bf), _t(o), _t(d), _t(t0), _t(t1), K, iters,
                         span=c["span"])
    ts, dts, counts, t_end = (np.asarray(x) for x in want)
    np.testing.assert_array_equal(got[2].numpy(), counts)
    assert 0 < counts.sum() and (counts < K).any() and (counts == K).any()
    np.testing.assert_allclose(got[0].numpy(), ts, rtol=1e-6)
    np.testing.assert_allclose(got[1].numpy(), dts, rtol=1e-6)
    np.testing.assert_allclose(got[3].numpy(), t_end, rtol=1e-6)


def test_span_march_equals_scalar_march():
    """The port's span-4 march places the scalar march's samples."""
    bf, o, d, t0, t1, cone = _scene(4, 1, 32, 128)
    _, tcfg = _configs(1, cone, 32)
    args = (tcfg, _t(bf), _t(o), _t(d), _t(t0), _t(t1), 24)
    ts_s, dts_s, k_s, te_s = trm.march_rays(*args, 1000)
    ts_v, dts_v, k_v, te_v = trm.march_rays(*args, 400, span=4)
    assert torch.equal(k_s, k_v)
    np.testing.assert_allclose(ts_s.numpy(), ts_v.numpy(), atol=1e-6)
    np.testing.assert_allclose(dts_s.numpy(), dts_v.numpy(), atol=1e-6)
    np.testing.assert_allclose(te_s.numpy(), te_v.numpy(), atol=1e-5)


@pytest.mark.parametrize("strict", [False, True])
def test_fine_grid_march_matches_reference(strict):
    """Two-level march: a fine grid equal to the upsampled coarse one, and a
    stricter one that culls samples."""
    G, f = 16, 2
    bf, o, d, t0, t1, cone = _scene(6, 1, G, 128, fill=0.4)
    up = np.repeat(np.repeat(np.repeat(bf, f, 1), f, 2), f, 3)
    fine = up & (np.random.default_rng(1).random(up.shape) < 0.5) if strict else up
    jcfg, tcfg = _configs(1, cone, G)
    with jax.disable_jit():
        want = jrm.march_rays(jcfg, jnp.asarray(bf), jnp.asarray(o), jnp.asarray(d),
                              jnp.asarray(t0), jnp.asarray(t1), 32, 120,
                              fine=jnp.asarray(fine))
    got = trm.march_rays(tcfg, _t(bf), _t(o), _t(d), _t(t0), _t(t1), 32, 120,
                         fine=_t(fine))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    assert np.asarray(want[2]).sum() > 0
    for a, b in zip((got[0], got[1], got[3]), (want[0], want[1], want[3])):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)
    with pytest.raises(ValueError):
        trm.march_rays(tcfg, _t(bf), _t(o), _t(d), _t(t0), _t(t1), 32, 8, span=4,
                       fine=_t(fine))


@pytest.mark.parametrize("n_cascades", [1, 3])
def test_advance_and_retreat_match_reference(n_cascades):
    bf, o, d, t0, t1, cone = _scene(8, n_cascades, 32, 512, fill=0.15)
    jcfg, tcfg = _configs(n_cascades, cone, 32)
    jargs = (jcfg, jnp.asarray(bf), jnp.asarray(o), jnp.asarray(d), jnp.asarray(t0),
             jnp.asarray(t1), 64)
    targs = (tcfg, _t(bf), _t(o), _t(d), _t(t0), _t(t1), 64)
    with jax.disable_jit():
        want_a = np.asarray(jrm.advance_to_occupied(*jargs))
        want_r = np.asarray(jrm.retreat_to_occupied(*jargs))
    got_a = trm.advance_to_occupied(*targs).numpy()
    got_r = trm.retreat_to_occupied(*targs).numpy()
    assert (want_a > t0).any() and (want_r < t1).any()
    np.testing.assert_allclose(got_a, want_a, rtol=1e-6)
    np.testing.assert_allclose(got_r, want_r, rtol=1e-6, atol=1e-6)


def test_jit_contraction_is_the_only_march_gap():
    """The jitted reference march (what the frame renderers run) may place a
    few rays' samples differently, because XLA contracts `o + t*d`.  Every
    ray whose counts agree has ts within rtol 1e-6; for every other ray the
    eager reference agrees with the port, so the gap is the compiler's."""
    bf, o, d, t0, t1, cone = _scene(0, 3, 32, 256)
    jcfg, tcfg = _configs(3, cone, 32)
    jargs = (jnp.asarray(bf), jnp.asarray(o), jnp.asarray(d), jnp.asarray(t0),
             jnp.asarray(t1))
    jitted = jax.jit(lambda *a: jrm.march_rays(jcfg, *a, 24, 96))(*jargs)
    with jax.disable_jit():
        eager = jrm.march_rays(jcfg, *jargs, 24, 96)
    got = trm.march_rays(tcfg, _t(bf), _t(o), _t(d), _t(t0), _t(t1), 24, 96)
    same = got[2].numpy() == np.asarray(jitted[2])
    assert same.mean() > 0.95
    np.testing.assert_allclose(got[0].numpy()[same], np.asarray(jitted[0])[same], rtol=1e-5)
    np.testing.assert_array_equal(got[2].numpy()[~same], np.asarray(eager[2])[~same])
    np.testing.assert_allclose(got[0].numpy()[~same], np.asarray(eager[0])[~same], rtol=1e-6)


@pytest.mark.parametrize("min_t", [1e-4, 0.01, 0.3])
def test_composite_chunk_matches_reference(min_t):
    rng = np.random.default_rng(3)
    N, K = 64, 16
    counts = rng.integers(0, K + 1, N)
    valid = np.arange(K)[None, :] < counts[:, None]
    ts = np.sort(rng.uniform(0.1, 2.0, (N, K)), axis=1).astype(np.float32)
    dts = rng.uniform(0.01, 0.1, (N, K)).astype(np.float32)
    rgb = rng.uniform(0, 1, (N, K, 3)).astype(np.float32)
    dens = np.where(valid, rng.uniform(0, 40.0, (N, K)), 0.0).astype(np.float32)
    dens[:4] = 1e5  # opaque at once: early-out and a depth tie on zero weights
    T_in = rng.uniform(0.0, 1.0, N).astype(np.float32)
    want = jrm.composite_chunk(jnp.asarray(rgb), jnp.asarray(dens), jnp.asarray(ts),
                               jnp.asarray(dts), jnp.asarray(valid), jnp.asarray(T_in),
                               min_t)
    got = trm.composite_chunk(_t(rgb), _t(dens), _t(ts), _t(dts), _t(valid), _t(T_in),
                              min_t)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-6)
    # the first maximum wins a tie, as in the reference
    w = torch.zeros((2, K))
    w[1, 3] = w[1, 9] = 0.5
    assert torch.argmax(w, dim=1).tolist() == [0, 3]
