"""Sums in a fixed order, so that one seed gives one result on the card.

The card's `index_add_` adds with atomics and its 1-D `cumsum` scans with a
decoupled look-back; both add floats in an order that changes from run to
run, and a float sum depends on its order.  The functions here add in an
order fixed by the data alone, on every device:

- `segment_sum_sorted`: sums of the rows of each run of equal, sorted
  segment ids (a stable `torch.sort` puts contributions in that order), by
  a pairwise tree inside each run (stride 1, 2, 4, ...), written to the
  segment's output row by a copy, never an accumulation.
- `fixed_cumsum`: an inclusive prefix sum by blocks: a scan within each
  block of `_BLOCK` values (torch's per-row scan, which runs in a fixed
  order for a 2-D tensor), then the same function on the blocks' totals.
- `take_rows`: a row gather whose backward is a segment sum of the
  gradients in a stable sort of the indices (the per-image learners and
  the envmap's and distortion map's bilinear splats).

Each is differentiable where a caller needs it: the backward of a segment
sum is a gather, that of a prefix sum the reversed prefix sum of the
gradient.
"""

from __future__ import annotations

import torch

_BLOCK = 1024


def _scan_rows(x: torch.Tensor) -> torch.Tensor:
    """Inclusive cumsum of x (n,), n <= _BLOCK, through the 2-D per-row
    scan: a second row keeps torch off the 1-D device-wide scan."""
    n = x.shape[0]
    two = torch.zeros((2, _BLOCK), dtype=x.dtype, device=x.device)
    two[0, :n] = x
    return torch.cumsum(two, dim=1)[0, :n]


def _fixed_cumsum(x: torch.Tensor) -> torch.Tensor:
    n = x.shape[0]
    if n <= _BLOCK:
        return _scan_rows(x)
    m = -(-n // _BLOCK)
    pad = torch.zeros((m * _BLOCK - n,), dtype=x.dtype, device=x.device)
    blocks = torch.cat([x, pad]).reshape(m, _BLOCK)
    within = torch.cumsum(blocks, dim=1)
    carry = _fixed_cumsum(within[:, -1])  # inclusive prefix of the totals
    carry = torch.cat([carry.new_zeros(1), carry[:-1]])
    return (within + carry[:, None]).reshape(-1)[:n]


class _FixedCumsum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _fixed_cumsum(x)

    @staticmethod
    def backward(ctx, g):
        return _fixed_cumsum(g.flip(0)).flip(0)


def fixed_cumsum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sum of a 1-D tensor in an order fixed by its
    length.  Differentiable."""
    if x.dim() != 1:
        raise ValueError(f"fixed_cumsum takes a 1-D tensor, got {tuple(x.shape)}")
    return _FixedCumsum.apply(x)


def _tree_sum_sorted(vals: torch.Tensor, seg: torch.Tensor, n_segments: int) -> torch.Tensor:
    """Forward of segment_sum_sorted (no autograd)."""
    M = seg.shape[0]
    out = torch.zeros((n_segments,) + vals.shape[1:], dtype=vals.dtype, device=vals.device)
    if M == 0:
        return out
    start = torch.searchsorted(seg, seg, side="left")
    end = torch.searchsorted(seg, seg, side="right")
    pos = torch.arange(M, device=seg.device)
    rank = pos - start
    length = end - start
    acc = vals.clone()
    # the rows still to be added into: at stride s, those whose rank is a
    # multiple of s; each adds the row s after it when that row is in its
    # segment
    live = pos
    s = 1
    max_len = int(length.max())
    while s < max_len:
        r = rank[live]
        take = live[((r % (2 * s)) == 0) & (r + s < length[live])]
        acc[take] = acc[take] + acc[take + s]
        live = live[(r % (2 * s)) == 0]
        s *= 2
    heads = pos[rank == 0]
    out[seg[heads]] = acc[heads]
    return out


class _SegmentSumSorted(torch.autograd.Function):
    @staticmethod
    def forward(ctx, vals, seg, n_segments):
        ctx.save_for_backward(seg)
        ctx.n_segments = n_segments
        return _tree_sum_sorted(vals, seg, n_segments)

    @staticmethod
    def backward(ctx, g):
        (seg,) = ctx.saved_tensors
        return g[seg], None, None


def segment_sum_sorted(vals: torch.Tensor, seg: torch.Tensor, n_segments: int) -> torch.Tensor:
    """out[k] = the sum of vals[i] over the i with seg[i] == k.

    vals (M, ...) float; seg (M,) int64, ascending, each in
    [0, n_segments).  Each segment is summed pairwise in rank order
    ((v0 + v1) + (v2 + v3)) + ..., the same on every device and every
    run.  Differentiable in vals."""
    return _SegmentSumSorted.apply(vals, seg.to(torch.int64), n_segments)


class _TakeRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, idx):
        ctx.save_for_backward(idx)
        ctx.n_rows = table.shape[0]
        return table[idx]

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        flat = idx.reshape(-1)
        keys, order = torch.sort(flat, stable=True)
        rows = g.reshape((flat.shape[0],) + g.shape[idx.dim():])[order]
        return segment_sum_sorted(rows, keys, ctx.n_rows), None


def take_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table[idx] (rows of `table` at int indices of any shape),
    differentiable in `table`: the backward sums the gradients of each
    row's gathers by segment_sum_sorted, in the order of a stable sort of
    the indices, where autograd of indexing would add them with the card's
    unordered scatters.  Without a gradient to take it is plain
    indexing."""
    if not (torch.is_grad_enabled() and table.requires_grad):
        return table[idx]
    return _TakeRows.apply(table, idx.to(torch.int64))
