"""The baked gather renderer, port vs reference, on the committed fox field
with one R=32 bake in both packages (the reference's, carried across by
convert.baked_grid_from_jax): 48x48 frames of render_frame_baked for every
gather-strategy knob (cull coarse / brick / fine, fine row / brick, adv dda
/ scout / dist), flush_every 2 and a trilinear bake; Session.render(
renderer="baked", spp=2); and render_rays_baked with a per-ray t_cap.

Tolerance, the live frame's rule (tests/test_torch_live.py): at least 99 %
of the pixels within rtol 2e-2 / atol 5e-3 and a PSNR above 40 dB, and the
frame's counts (rounds, ray-rounds, evals, overflows) equal.  The
reference's jitted frame may contract `t0 + j*dmin` or `o + t*d` into a
fused multiply-add, which moves a candidate by an ulp and can move it
across a vertex's cell; the counts show that no such move changed a ray's
course.

The reference's brick gather at 16-bit rows does not compile on the CPU
(XLA's verifier rejects its uint8 -> int16 bitcast), so fine=brick is held
to the reference's brick frame at 8-bit rows, and at 16-bit rows to the
reference's row frame, which it equals up to the rays that run over their
head budget (rolled back like an eval overflow)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_snapshot import (
    fox_jax,
    fox_jax_baked_grid,
    fox_port_session,
    fox_port_session_baked,
)

R = 32
W = H = 48
FOCAL = (40.0, 40.0)
EYE = [2.1, 0.5, 0.6]


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


def _cam():
    from sienerf_torch.utils.camera import look_at_matrix

    return look_at_matrix(EYE, [0.5, 0.5, 0.5])


def hold_frame(got: np.ndarray, want: np.ndarray):
    """The live frame's rule."""
    from sienerf_torch.metrics import psnr

    assert got.shape == want.shape and np.isfinite(got).all()
    ok = np.abs(got - want) <= 5e-3 + 2e-2 * np.abs(want)
    assert ok.all(axis=-1).mean() >= 0.99
    assert psnr(got[..., :3], want[..., :3]) > 40.0


def _frames(mode="nearest", row_bits=16, ref_knobs=None, **knobs):
    """(port rgba, port counts, reference rgba, reference counts)."""
    from sienerf_torch.engines.nerf_baked import render_frame_baked
    from sienerf_tpu.engines.nerf_baked import render_frame_baked as jax_frame

    jeng, jp, jbf = fox_jax()
    jgrid, meta = fox_jax_baked_grid(R, mode, row_bits)
    s = fox_port_session_baked(R, mode, row_bits)
    grid, _ = s._baked
    kw = dict(width=W, height=H, resolution=R, mode=mode, n_cascades=meta["n_cascades"],
              return_stats=True)
    rgba, _, counts = render_frame_baked(s.engine, s.render_params(),
                                         s.state["occ"]["bitfield"], grid, _cam(), FOCAL,
                                         **kw, **knobs)
    jrgba, _, jcounts = jax_frame(jeng, jp, jbf, jgrid, _cam(), FOCAL, **kw,
                                  **(knobs if ref_knobs is None else ref_knobs))
    return rgba.numpy(), counts.tolist(), np.asarray(jrgba), np.asarray(jcounts).tolist()


@pytest.mark.parametrize("knobs", [
    {}, {"cull": "brick"}, {"cull": "fine"}, {"adv": "scout"}, {"adv": "dist"},
    {"flush_every": 2}, {"cull": "brick", "cull_heads": 2}, {"advance_iters": 0},
], ids=lambda k: ",".join(f"{a}={b}" for a, b in k.items()) or "default")
def test_baked_frame_matches_reference(knobs):
    got, counts, want, jcounts = _frames(**knobs)
    hold_frame(got, want)
    assert counts == jcounts
    assert got[..., 3].mean() > 0.5 and got[..., :3].std() > 1e-2


@pytest.mark.parametrize("row_bits", [8, 16])
def test_baked_frame_brick_gather(row_bits):
    if row_bits == 8:
        got, counts, want, jcounts = _frames(row_bits=8, fine="brick")
        assert counts == jcounts
    else:
        got, counts, want, jcounts = _frames(fine="brick", ref_knobs={})
        assert counts[2] > 0.9 * jcounts[2]
    hold_frame(got, want)


def test_baked_frame_trilinear():
    got, counts, want, jcounts = _frames(mode="trilinear")
    hold_frame(got, want)
    assert counts == jcounts


def session_frames(width: int, height: int, spp: int = 1):
    """Session.render(renderer="baked") of the fox in both packages, each
    session holding the same R=32 bake -> (port rgba, reference rgba)."""
    from sienerf_tpu.common import TestbedMode
    from sienerf_tpu.session import Session as JaxSession

    eng, params, bitfield = fox_jax()
    js = JaxSession()
    js.mode = TestbedMode.NERF
    js.engine = eng
    js.state = {"opt": {}, "params": params, "occ": {"bitfield": bitfield}}
    jgrid, meta = fox_jax_baked_grid(R)
    js._baked = ({k: jnp.asarray(v) for k, v in jgrid.items()}, meta)
    focal = tuple(f * width / W for f in FOCAL)
    want = js.render(width, height, _cam(), focal, spp=spp, renderer="baked")
    got = fox_port_session_baked(R).render(width, height, _cam(), focal, spp=spp,
                                           renderer="baked").numpy()
    return got, want


@pytest.mark.parametrize("spp", [1, 2])
def test_session_render_baked(spp):
    """The slice as a whole: Session.render(renderer="baked") of the fox in
    both packages on one bake; spp 2 adds the chain-phase jitter."""
    got, want = session_frames(W, H, spp)
    hold_frame(got, want)
    assert fox_port_session()._baked is None  # the shared session kept no bake


def test_session_render_baked_small_frame():
    """The baked renderer is ported (Slice E): a 16x16 Session.render of the
    fox in both packages on one bake, at the live frame's rule, with
    coverage.  (Held in tests/test_torch_live.py's list of once-unported
    parts before; here it shares this file's bakes.)"""
    got, want = session_frames(16, 16)
    hold_frame(got, want)
    assert got[..., 3].mean() > 0.3


def test_render_rays_baked_with_t_cap():
    from sienerf_torch.engines.nerf_baked import render_rays_baked
    from sienerf_torch.utils.camera import uv_to_ray
    from sienerf_tpu.engines.nerf_baked import render_rays_baked as jax_rays

    jeng, jp, jbf = fox_jax()
    jgrid, meta = fox_jax_baked_grid(R)
    s = fox_port_session_baked(R)
    grid, _ = s._baked
    rng = np.random.default_rng(0)
    n = 1500
    uv = rng.uniform(0.05, 0.95, (n, 2)).astype(np.float32)
    o, d = uv_to_ray(torch.from_numpy(uv), (W, H), FOCAL, _cam())
    t_cap = rng.uniform(0.8, 3.0, n).astype(np.float32)
    t_cap[::5] = np.inf
    kw = dict(P=64, evals=16, step_scale=4.0)
    got = render_rays_baked(s.engine, s.render_params(), grid, meta,
                            s.state["occ"]["bitfield"], o, d, t_cap=torch.from_numpy(t_cap),
                            **kw)
    want = jax_rays(jeng, jp, jgrid, meta, jbf, jnp.asarray(o.numpy()),
                    jnp.asarray(d.numpy()), t_cap=jnp.asarray(t_cap), **kw)
    g = np.concatenate([got[0].numpy(), got[1].numpy()[:, None]], -1)[None]
    w = np.concatenate([np.asarray(want[0]), np.asarray(want[1])[:, None]], -1)[None]
    hold_frame(g, w)
    hit = np.asarray(want[1]) > 0.5
    np.testing.assert_allclose(got[2].numpy()[hit], np.asarray(want[2])[hit], rtol=2e-2,
                               atol=5e-3)
    # the cap cuts rays short: the capped half is more transparent
    assert g[0, t_cap < 1.0, 3].mean() < g[0, np.isinf(t_cap), 3].mean()


def test_extra_dims_raise_naming_their_slice():
    """Ported since: the colour MLP takes the params' render row of extra
    dims between the SH block and the features, the reference's concat
    (tests/test_torch_extra_dims.py holds conditioned frames to the
    reference); with zero weights on those rows the colours are the fox's."""
    import dataclasses

    from sienerf_torch.engines.nerf_baked import _colors_from_raw

    s = fox_port_session()
    net = s.engine.net
    eng = dataclasses.replace(s.engine, net=dataclasses.replace(
        net, n_extra_dims=2, rgb_mlp=dataclasses.replace(
            net.rgb_mlp, n_input_dims=net.rgb_mlp.n_input_dims + 2)))
    p = s.render_params()
    w0 = p["rgb_mlp"][0]
    wide = dict(p, extra_dims=torch.rand((3, 2)),
                rgb_mlp=[torch.cat([w0[:16], torch.zeros((2, w0.shape[1])), w0[16:]])]
                + list(p["rgb_mlp"][1:]))
    raw, d = torch.rand((4, 16)), torch.ones((2, 3))
    valid = torch.ones((2, 2), dtype=torch.bool)
    got = _colors_from_raw(eng, wide, raw, d, (2, 2), valid)
    want = _colors_from_raw(s.engine, p, raw, d, (2, 2), valid)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def _flush_before(self, s, s2, n, rays_pre, render_mode=None):
    """NerfEngine._frame_flush_refill as it was before the baked renderer
    shared it: the live alive predicate read inside."""
    now_alive = self._frame_alive(s2)
    done = s["valid"] & ~now_alive
    tgt = torch.where(done, s["ids"], n)
    colour = s2["rgb"]
    if render_mode == "cost":
        colour = (s2["used"].float() / 128.0)[:, None].expand(-1, 3)
    payload = torch.cat(
        [colour, s2["op"][:, None], (s2["bt"] / s["dnorm"])[:, None]], dim=1)
    s2["out"] = s2["out"].index_copy_(0, tgt, payload)
    rank = torch.cumsum(done.to(torch.int64), dim=0)
    new_id = s["cursor"] + rank - 1
    take = done & (new_id < n)
    ids_n = torch.where(take, new_id, s["ids"])
    o_n, d_n, dn_n, t0_n, t1_n = self._frame_take_rays(ids_n, n, rays_pre)
    sel = take[:, None]
    s2.update(
        ids=ids_n,
        o=torch.where(sel, o_n, s["o"]),
        d=torch.where(sel, d_n, s["d"]),
        dnorm=torch.where(take, dn_n, s["dnorm"]),
        t=torch.where(take, t0_n, s2["t"]),
        t1=torch.where(take, t1_n, s2["t1"]),
        T=torch.where(take, 1.0, s2["T"]),
        rgb=torch.where(sel, 0.0, s2["rgb"]),
        op=torch.where(take, 0.0, s2["op"]),
        bw=torch.where(take, 0.0, s2["bw"]),
        bt=torch.where(take, 0.0, s2["bt"]),
        chunks=torch.where(take, 0, s2["chunks"]),
        used=torch.where(take, 0, s2["used"]),
        valid=now_alive | take,
        cursor=s["cursor"] + done.sum(),
    )
    return s2


@pytest.mark.parametrize("render_mode", [None, "cost"])
def test_live_frame_unchanged_by_the_shared_flush(monkeypatch, render_mode):
    """The live frame through the shared flush (the alive predicate passed
    in) equals, bit for bit, the frame through the flush as it was."""
    from sienerf_torch.engines.nerf import NerfEngine

    s = fox_port_session()
    args = (s.render_params(), s.state["occ"]["bitfield"], 32, 24, _cam(), (28.0, 28.0))
    a, ad = s.engine.render_frame(*args, tile=256, render_mode=render_mode)
    monkeypatch.setattr(NerfEngine, "_frame_flush_refill",
                        lambda self, st, s2, n, rp, alive_fn, mode=None:
                        _flush_before(self, st, s2, n, rp, mode))
    b, bd = s.engine.render_frame(*args, tile=256, render_mode=render_mode)
    assert torch.equal(a, b) and torch.equal(ad, bd)
    assert float(a[..., 3].mean()) > 0.3
