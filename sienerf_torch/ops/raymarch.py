"""Ray marching through the occupancy grid and emission-absorption
compositing (port of the render side of the JAX package's ops/raymarch.py).

Rays are a fixed-shape batch with per-ray alive masks.  A march step tests
the ray's current position against the packed occupancy grid, emits the
sample into the ray's next free slot of an (N, K) slab when the voxel is
occupied, and otherwise hops past the empty voxel in whole cone steps, so
sample placement matches the reference's `advance_to_next_voxel`.  Every
function keeps the JAX package's f32 operation order: `t` advances by
`t + dt` or `t + skip`, and one differing ulp can move a sample across a
voxel boundary.

The loops are Python loops of plain PyTorch operations; on the card the
one-candidate march replays them as CUDA graphs (`_iterate`).  The trainer's
`compact_samples` and `composite_flat` pack the marched samples into one
dense ray-major stream and composite it segment by segment.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass

import torch

from sienerf_torch.common import MAX_CONE_STEPSIZE, MIN_CONE_STEPSIZE, NERF_GRIDSIZE
from sienerf_torch.ops.fixed_order import fixed_cumsum, segment_sum_sorted
from sienerf_torch.ops.occupancy import (
    mip_from_dt,
    mip_from_pos,
    occupancy_lookup_packed,
    pack_occupancy,
)


# iterations between a march's checks for rays still marching.  A check is
# a host sync on the card, where only the one-candidate march looks (every
# _DONE_CHECK iterations); on the CPU it costs next to nothing, every march
# looks every _DONE_CHECK_CPU, and each iteration saved is a full one
_DONE_CHECK, _DONE_CHECK_CPU = 64, 4


def _check_every(t: torch.Tensor, on_card: int) -> int:
    """Iterations between a march's checks: `on_card` (0: none) on the card."""
    return _DONE_CHECK_CPU if t.device.type == "cpu" else on_card


def _slot_iota(K: int, dev: torch.device):
    """arange(K)[None] for _writer on the card; None on the CPU."""
    return None if dev.type == "cpu" else torch.arange(K, device=dev)[None, :]


def _writer(iota_K, K: int, k: torch.Tensor, emit: torch.Tensor):
    """write(slab, value) -> slab with slab[r, k[r]] = value[r] where
    emit[r] (k[r] < K there), for (N, K) slabs.  On the card (iota_K from
    _slot_iota) one pass over the slab; on the CPU (iota_K None) in place,
    one element a ray, several times faster there."""
    if iota_K is not None:
        mask = (iota_K == k[:, None]) & emit[:, None]
        return lambda slab, value: torch.where(mask, value[:, None], slab)
    slot = torch.clamp(k, max=K - 1)[:, None]

    def write(slab, value):
        keep = slab.gather(1, slot)[:, 0]
        return slab.scatter_(1, slot, torch.where(emit, value, keep)[:, None])
    return write


def calc_dt(t: torch.Tensor, cone_angle: float) -> torch.Tensor:
    return torch.clamp(t * cone_angle, MIN_CONE_STEPSIZE, MAX_CONE_STEPSIZE)


def _as_packed(bitfield: torch.Tensor) -> torch.Tensor:
    """Accept a (C, G, G, G) bool bitfield or its pack_occupancy words
    (int32).  Frame renderers pack once and pass the words through."""
    if bitfield.dtype == torch.int32:
        return bitfield
    return pack_occupancy(bitfield)


def cone_angle_for_aabb(aabb_scale: float, cone_angle_constant: float = 1.0 / 256.0) -> float:
    """Uniform steps inside the unit cube, cone stepping for larger scenes."""
    return 0.0 if aabb_scale <= 1.0 else cone_angle_constant


def _next_voxel_skip(t, pos, d, mip, dt, grid_size: int = NERF_GRIDSIZE):
    """Distance to hop past the current (empty) voxel at cascade `mip`,
    rounded up to whole dt steps."""
    scale = torch.exp2(mip.float())
    p = ((pos - 0.5) / scale[..., None] + 0.5) * grid_size  # grid coords
    dg = d * (grid_size / scale[..., None])  # d(grid coords)/dt
    flat = dg.abs() < 1e-12
    safe = torch.where(flat, 1e-12, dg)
    nb = torch.floor(p) + (dg > 0).float()
    delta = (nb - p) / safe
    delta = torch.where(flat, float("inf"), delta)
    tau = delta.amin(dim=-1)  # world-t units to the nearest boundary
    tau = torch.clamp(tau, min=0.0) + 1e-5 * scale
    n_steps = torch.clamp(torch.ceil(tau / dt), 1.0, 1e6)
    return n_steps * dt


@dataclass(frozen=True)
class MarchConfig:
    n_cascades: int = 1
    cone_angle: float = 0.0
    grid_size: int = NERF_GRIDSIZE


def _probe_mip(config: MarchConfig, pos, dt):
    return torch.maximum(mip_from_pos(pos, config.n_cascades),
                         mip_from_dt(dt, config.n_cascades, config.grid_size))


@torch.no_grad()
def march_rays(config: MarchConfig, bitfield: torch.Tensor, origins: torch.Tensor,
               dirs: torch.Tensor, t_start: torch.Tensor, t_far: torch.Tensor,
               n_samples: int, n_iters: int, span: int = 1,
               fine: torch.Tensor | None = None, t_grad: bool = False):
    """Collect up to `n_samples` occupied-space samples per ray within a
    bounded march -> ts (N, K), dts (N, K), counts (N,), t_end (N,).

    bitfield: (C, G, G, G) bool or its packed words; origins, dirs (N, 3),
    dirs unit; t_start, t_far (N,).  `fine` is a render-baked bool grid at
    a multiple of G, or (its pack_occupancy words, its grid size) (two-level
    march, span 1 only).  span > 1 tests `span`
    consecutive cone-step candidates per iteration with one batched
    occupancy probe, emits the leading occupied run and then makes at most
    one voxel skip: the same samples as the one-candidate loop in `span`
    times fewer iterations (`n_iters` then counts those iterations).

    With `t_grad` (span 1 only) it also returns d ts / d t_start and
    d dts / d t_start (N, K): a sample's t is t_start plus the march's cone
    steps and voxel skips, each a whole number of steps calc_dt(t), so its
    derivative is the product of (1 + n * calc_dt'(t)) over the steps
    before it.  The JAX trainer differentiates its march loop; a trainer
    that learns the cameras puts this chain on t_start."""
    if span <= 1:
        return _march_rays_scalar(config, bitfield, origins, dirs, t_start, t_far,
                                  n_samples, n_iters, fine=fine, t_grad=t_grad)
    if t_grad:
        raise ValueError("the march's t gradient is of the one-candidate loop (span 1)")
    if fine is not None:
        raise ValueError("span marching does not support the fine render grid")
    N, K, S = origins.shape[0], n_samples, span
    dev = origins.device
    iota_K = _slot_iota(K, dev)
    iota_S1 = torch.arange(S + 1, device=dev)[None, :]
    words = _as_packed(bitfield)

    t = t_start
    k = torch.zeros((N,), dtype=torch.int64, device=dev)
    ts = torch.zeros((N, K), dtype=torch.float32, device=dev)
    dts = torch.zeros((N, K), dtype=torch.float32, device=dev)
    every = _check_every(t, 0)
    for it in range(n_iters):
        if every and it and it % every == 0 and not bool(((t < t_far) & (k < K)).any()):
            break  # every ray is done: the rest would change nothing
        # cone-step candidate chain t_0..t_{S-1} and its end point
        t_list, dt_list = [], []
        tj = t
        for _j in range(S):
            dtj = calc_dt(tj, config.cone_angle)
            t_list.append(tj)
            dt_list.append(dtj)
            tj = tj + dtj
        t_stack = torch.stack(t_list + [tj], dim=1)  # (N, S+1)
        dt_stack = torch.stack(dt_list, dim=1)  # (N, S)
        pos = origins[:, None, :] + t_stack[:, :S, None] * dirs[:, None, :]
        mip = _probe_mip(config, pos, dt_stack)
        occ = occupancy_lookup_packed(words, config.grid_size, pos, mip)
        in_range = t_stack[:, :S] < t_far[:, None]
        n_lead = torch.cumprod((occ & in_range).to(torch.int64), dim=1).sum(dim=1)
        ray_active = (t < t_far) & (k < K)
        m = torch.where(ray_active, torch.minimum(n_lead, K - k), 0)
        # emit candidates j < m into slots k..k+m-1
        for j in range(S):
            write = _writer(iota_K, K, k + j, ray_active & (j < m))
            ts = write(ts, t_stack[:, j])
            dts = write(dts, dt_stack[:, j])
        # next t: candidate m (the end point when the whole span emitted),
        # plus a voxel skip only when the run ended at an unoccupied
        # in-range candidate (not when K or t_far stopped it)
        t_next = torch.where(iota_S1 == m[:, None], t_stack, 0.0).sum(dim=1)
        pos_m = origins + t_next[:, None] * dirs
        dt_m = calc_dt(t_next, config.cone_angle)
        mip_m = _probe_mip(config, pos_m, dt_m)
        skip = _next_voxel_skip(t_next, pos_m, dirs, mip_m, dt_m, config.grid_size)
        do_skip = ray_active & (m == n_lead) & (n_lead < S) & (t_next < t_far)
        t = torch.where(ray_active, torch.where(do_skip, t_next + skip, t_next), t)
        k = k + m
    return ts, dts, k, t


def _march_rays_scalar(config: MarchConfig, bitfield, origins, dirs, t_start, t_far,
                       n_samples: int, n_iters: int, fine=None, t_grad: bool = False):
    """One candidate per iteration.  With `fine`, samples are emitted only
    where the fine grid is occupied, and empty space is skipped at the
    coarsest level that is empty: a whole coarse cell where the training
    grid is empty, one fine cell otherwise."""
    N, K = origins.shape[0], n_samples
    dev = origins.device
    if isinstance(fine, tuple):  # packed once by a frame: (words, grid size)
        words_fine, g_fine = fine
    else:
        g_fine = fine.shape[1] if fine is not None else config.grid_size
        words_fine = _as_packed(fine) if fine is not None else None
    words = _as_packed(bitfield)
    iota_K = _slot_iota(K, dev)
    with_fine = words_fine is not None
    lo, hi = MIN_CONE_STEPSIZE, MAX_CONE_STEPSIZE

    def body(consts, state):
        words, words_fine, iota_K, origins, dirs, t_far = consts
        t, k, ts, dts = state[:4]
        pos = origins + t[:, None] * dirs
        dt = calc_dt(t, config.cone_angle)
        mip = _probe_mip(config, pos, dt)
        occ = occupancy_lookup_packed(words, config.grid_size, pos, mip)
        occ_emit = occ
        if with_fine:
            occ_emit = occ & occupancy_lookup_packed(words_fine, g_fine, pos, mip)
        active = (t < t_far) & (k < K)
        emit = active & occ_emit
        write = _writer(iota_K, K, k, emit)
        ts = write(ts, t)
        dts = write(dts, dt)
        skip = _next_voxel_skip(t, pos, dirs, mip, dt, config.grid_size)
        if with_fine:
            skip = torch.where(occ, _next_voxel_skip(t, pos, dirs, mip, dt, g_fine), skip)
        out = ()
        if t_grad:
            g, gts, gdts = state[4:]
            tc = t * config.cone_angle
            ddt = torch.where((tc > lo) & (tc < hi), config.cone_angle, 0.0)
            gts = write(gts, g)
            gdts = write(gdts, ddt * g)
            n_steps = torch.round(skip / dt)
            g = torch.where(emit, g * (1.0 + ddt),
                            torch.where(active, g * (1.0 + n_steps * ddt), g))
            out = (g, gts, gdts)
        t = torch.where(emit, t + dt, torch.where(active, t + skip, t))
        k = k + emit.to(torch.int64)
        return (t, k, ts, dts) + out

    def alive(consts, state):
        return ((state[0] < consts[5]) & (state[1] < K)).any()

    t = t_start
    k = torch.zeros((N,), dtype=torch.int64, device=dev)
    ts = torch.zeros((N, K), dtype=torch.float32, device=dev)
    dts = torch.zeros((N, K), dtype=torch.float32, device=dev)
    state = (t, k, ts, dts)
    if t_grad:
        state += (torch.ones_like(t), torch.zeros_like(ts), torch.zeros_like(dts))
    consts = (words, words_fine, iota_K, origins, dirs, t_far)
    key = ("scalar", str(dev), config, N, K, t_grad, g_fine if with_fine else None,
           tuple(words.shape), None if words_fine is None else tuple(words_fine.shape))
    state = _iterate(key, body, alive, consts, state, n_iters, _check_every(t, _DONE_CHECK))
    t, k, ts, dts = state[:4]
    if t_grad:
        return ts, dts, k, t, state[5], state[6]
    return ts, dts, k, t


# On the card a march runs its iterations as CUDA graphs of _GRAPH_ITERS
# iterations: an iteration is ~40 small kernels, which the host launches
# several times slower than the card runs them.  A graph replays the same
# kernels on the same bits, so a march's results do not change.  One graph
# a march shape (rays, samples, grids); the few most recent are kept.
GRAPHED_MARCH = True
_GRAPH_ITERS = 16  # divides _DONE_CHECK
_GRAPHS: dict = {}
_GRAPHS_KEPT = 8
_GRAPH_LOCK = threading.Lock()


def _iterate(key, body, alive, consts, state, n_iters: int, every: int):
    """state = body(consts, state) n_iters times, looking every `every`
    iterations (0: never) whether alive(consts, state) and stopping once
    it is not -> the last state.  `consts` and `state` are tuples of
    tensors (a const may be None); body is free of host syncs."""
    if not (GRAPHED_MARCH and state[0].device.type == "cuda" and n_iters >= _GRAPH_ITERS
            and every % _GRAPH_ITERS == 0):
        return _loop(None, body, alive, consts, state, n_iters, every)
    with _GRAPH_LOCK:  # the graph's static tensors are shared
        entry = _GRAPHS.pop(key, None) or _capture(body, consts, state, _GRAPH_ITERS)
        _GRAPHS[key] = entry  # the most recent last
        while len(_GRAPHS) > _GRAPHS_KEPT:
            _GRAPHS.pop(next(iter(_GRAPHS)))
        graph, s_consts, s_state = entry
        for dst, src in zip(s_consts + s_state, consts + state):
            if dst is not None:
                dst.copy_(src)
        state = _loop(graph, body, alive, s_consts, s_state, n_iters, every)
        return tuple(s.clone() for s in state)


def _loop(graph, body, alive, consts, state, n_iters: int, every: int):
    """_iterate's loop: with a graph, whole graphs of _GRAPH_ITERS
    iterations that advance the static state in place, then single ones."""
    it = 0
    while it < n_iters:
        if every and it and it % every == 0 and not bool(alive(consts, state)):
            break  # every ray is done: the rest would change nothing
        if graph is not None and it + _GRAPH_ITERS <= n_iters:
            graph.replay()
            it += _GRAPH_ITERS
        else:
            state = body(consts, state)
            it += 1
    return state


def _capture(body, consts, state, n: int):
    """A CUDA graph of n iterations of body that reads its inputs from
    static copies of consts and state and writes its last state back into
    the state's copies -> (graph, static consts, static state)."""
    s_consts = tuple(None if c is None else c.clone() for c in consts)
    s_state = tuple(s.clone() for s in state)
    dev = s_state[0].device
    # one eager iteration on a side stream first (loads every kernel), as
    # torch.cuda.graphs asks
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        body(s_consts, s_state)
    torch.cuda.current_stream(dev).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        cur = s_state
        for _ in range(n):
            cur = body(s_consts, cur)
        for dst, src in zip(s_state, cur):
            dst.copy_(src)
    return graph, s_consts, s_state


@torch.no_grad()
def advance_to_occupied(config: MarchConfig, bitfield, origins, dirs, t_start, t_far,
                        n_iters: int) -> torch.Tensor:
    """Advance each ray's t through empty space to its first occupied voxel
    (or t_far) without emitting samples.  Run once per frame over all
    pixels, so that the streaming renderer's rounds start on content."""
    words = _as_packed(bitfield)
    t = t_start
    every = _check_every(t, 0)
    for it in range(n_iters):
        if every and it and it % every == 0 and not bool(active.any()):
            break  # no ray moved last time: the rest would change nothing
        pos = origins + t[:, None] * dirs
        dt = calc_dt(t, config.cone_angle)
        mip = _probe_mip(config, pos, dt)
        occ = occupancy_lookup_packed(words, config.grid_size, pos, mip)
        active = (t < t_far) & ~occ
        skip = _next_voxel_skip(t, pos, dirs, mip, dt, config.grid_size)
        t = torch.where(active, t + skip, t)
    return t


@torch.no_grad()
def retreat_to_occupied(config: MarchConfig, bitfield, origins, dirs, t_start, t_far,
                        n_iters: int) -> torch.Tensor:
    """advance_to_occupied from the far end: pull each ray's exit time back
    through trailing empty space to just past its last occupied voxel (or
    down to t_start).  Walks the reversed ray o' = o + t_far*d, d' = -d."""
    o_rev = origins + t_far[:, None] * dirs
    span = torch.clamp(t_far - t_start, min=0.0)
    s = advance_to_occupied(config, bitfield, o_rev, -dirs, torch.zeros_like(span),
                            span, n_iters)
    return t_far - torch.minimum(s, span)


def composite_chunk(rgb: torch.Tensor, density: torch.Tensor, ts: torch.Tensor,
                    dts: torch.Tensor, valid: torch.Tensor, T_in: torch.Tensor,
                    min_transmittance=1e-4):
    """Front-to-back emission-absorption over one chunk of samples.

    rgb (N, K, 3) and density (N, K) activated, ts, dts (N, K), valid
    (N, K) bool, T_in (N,) incoming transmittance; `min_transmittance` a
    float or a 0-d tensor.  weight = alpha * T; samples after T drops below
    min_transmittance add nothing; depth is the t of the largest weight
    (the first one on ties).  -> (rgb_sum (N, 3), opacity (N,), T_out (N,),
    best_w (N,), best_t (N,))."""
    alpha = torch.where(valid, 1.0 - torch.exp(-density * dts), 0.0)
    one_minus = 1.0 - alpha
    cum = torch.cumprod(one_minus, dim=1)
    T_excl = torch.cat([torch.ones_like(cum[:, :1]), cum[:, :-1]], dim=1) * T_in[:, None]
    live = T_excl >= min_transmittance
    w = torch.where(live, alpha * T_excl, 0.0)
    rgb_sum = (w[..., None] * rgb).sum(dim=1)
    opacity = w.sum(dim=1)
    T_out = T_in * torch.where(live, one_minus, 1.0).prod(dim=1)
    T_out = torch.where(T_out < min_transmittance, 0.0, T_out)
    best = torch.argmax(w, dim=1)
    onehot = torch.arange(w.shape[1], device=w.device)[None, :] == best[:, None]
    best_w = w.amax(dim=1)
    best_t = torch.where(onehot, ts, 0.0).sum(dim=1)
    return rgb_sum, opacity, T_out, best_w, best_t


def compact_samples(ts: torch.Tensor, dts: torch.Tensor, counts: torch.Tensor, M: int):
    """Compact an (N, K) marched-sample slab into a dense ray-major stream
    of M samples, the trainer's fixed batch.  Rays that would overflow M
    are dropped whole (no samples, no gradient): a ray cut mid-scene would
    train a fog "billboard" at its cut.  Each output slot finds its (ray,
    sample) by one searchsorted over the per-ray prefix sums.

    -> (t (M,), dt (M,), ray_id (M,) int32, == N on empty slots,
    ray_start (N,) int32, fits (N,) bool)."""
    N, K = ts.shape
    dev = ts.device
    counts = counts.to(torch.int64)
    fits = torch.cumsum(counts, dim=0) <= M
    counts2 = torch.where(fits, counts, 0)
    prefix2 = torch.cumsum(counts2, dim=0)
    ray_start = prefix2 - counts2
    m = torch.arange(M, dtype=torch.int64, device=dev)
    ray_id = torch.searchsorted(prefix2, m, right=True)
    rid_c = torch.clamp(ray_id, max=N - 1)
    j = m - ray_start[rid_c]
    flat = rid_c * K + torch.clamp(j, 0, K - 1)
    t = ts.reshape(-1)[flat]
    dt = dts.reshape(-1)[flat]
    ray_id = torch.where(m < prefix2[-1], ray_id, N)
    return t, dt, ray_id.to(torch.int32), ray_start.to(torch.int32), fits


def composite_flat(rgb: torch.Tensor, density: torch.Tensor, ts: torch.Tensor,
                   dts: torch.Tensor, ray_id: torch.Tensor, ray_start: torch.Tensor,
                   n_rays: int, min_transmittance: float = 1e-4):
    """Front-to-back emission-absorption over a compact_samples stream:
    rgb (M, 3) and density (M,) activated, ts, dts (M,), ray_id (M,)
    sorted (n_rays on empty slots), ray_start (n_rays,).

    Each sample's exclusive transmittance is exp of one global cumsum c of
    log1p(-alpha) over all M slots minus its value at the ray's first slot,
    as in the reference.  |c| grows with every opaque ray before a sample
    (each of the M terms is down to log(1e-7) = -16), so c rounded to f32
    would move T by about |c| * 2^-24 relative, and a last-bit difference
    of one log1p between two devices could flip that rounding.  The cumsum
    and the subtraction of the ray's start therefore run in float64 and
    round once, to the ray's own exponent: the card and the CPU then agree
    to the f32 ulps of their log1p and exp, and the reference (XLA sums f32
    by a tree and subtracts in f32) lies within a few ulps of |c|.  The
    prefix sums and the per-ray sums run in a fixed order
    (ops/fixed_order.py), so a run repeats bit for bit on the card.
    Differentiable in rgb and density.  -> (rgb_sum (n, 3), opacity (n,),
    T_out (n,), depth (n,), the weighted mean termination distance)."""
    M = ts.shape[0]
    ray_id = ray_id.to(torch.int64)
    valid = ray_id < n_rays
    rid = torch.clamp(ray_id, max=n_rays - 1)
    alpha = torch.where(valid, 1.0 - torch.exp(-density * dts), 0.0)
    lg = torch.log1p(-torch.clamp(alpha, max=1.0 - 1e-7))
    lg64 = lg.double()
    c_excl = fixed_cumsum(lg64) - lg64
    base = c_excl[torch.clamp(ray_start.to(torch.int64)[rid], 0, M - 1)]
    T_excl = torch.exp((c_excl - base).float())
    keep = valid & (T_excl >= min_transmittance)
    w = torch.where(keep, alpha * T_excl, 0.0)

    # the per-ray sums, column by column in one pass
    cols = torch.cat([w[:, None] * rgb, w[:, None], torch.where(keep, lg, 0.0)[:, None],
                      (w * ts)[:, None]], dim=1)
    sums = segment_sum_sorted(cols, ray_id, n_rays + 1)[:n_rays]
    rgb_sum, opacity, depth = sums[:, :3], sums[:, 3], sums[:, 5]
    T_out = torch.exp(sums[:, 4])
    T_out = torch.where(T_out < min_transmittance, 0.0, T_out)
    return rgb_sum, opacity, T_out, depth
