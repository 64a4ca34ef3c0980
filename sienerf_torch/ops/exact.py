"""Exact integer routing (port of the JAX package's ops/exact.py).

The JAX package routes integer payloads (row ids, packed bit words) through
one-hot contractions, which its matrix unit computes exactly only at full
precision or byte by byte.  Here each route is what it computes: a gather
(`route_select`) or a scatter (`route_compact`) of the payload itself, so no
rounding can reach it.  The one-hot functions keep the JAX package's
contracts, including what an empty slot holds (0); the renderer's brick
lookups call the index forms directly, which never build the one-hot.

32-bit words are held as int32 with the same bits (torch's uint32
arithmetic is incomplete), as ops/bits.py holds them.
"""

from __future__ import annotations

import torch


def exact_einsum(subscripts: str, *operands) -> torch.Tensor:
    """einsum whose f32 result is exact for one-hot contractions: the
    products and sums run in float64, where each output of a one-hot
    contraction is a single f32 payload times 1 plus zeros."""
    return torch.einsum(subscripts, *(o.double() for o in operands)).float()


def route_select(idx: torch.Tensor, has: torch.Tensor, words: torch.Tensor) -> torch.Tensor:
    """out[a, p] = words[a, idx[a, p]] where has[a, p], else 0: idx, has
    (A, P), words (A, S, W) -> (A, P, W).  idx may hold anything where has
    is False."""
    S = words.shape[1]
    i = torch.where(has, idx, 0).clamp(0, S - 1).to(torch.int64)
    out = torch.gather(words, 1, i[..., None].expand(-1, -1, words.shape[2]))
    return torch.where(has[..., None], out, torch.zeros((), dtype=words.dtype,
                                                        device=words.device))


def route_compact(slot: torch.Tensor, has: torch.Tensor, words: torch.Tensor,
                  n_slots: int) -> torch.Tensor:
    """out[a, slot[a, p]] = words[a, p] where has[a, p]; slots nobody
    writes hold 0: slot, has (A, P), words (A, P, W) -> (A, n_slots, W).
    At most one p may write each (a, s)."""
    A, P, W = words.shape
    s = torch.where(has, slot, n_slots).clamp(0, n_slots).to(torch.int64)
    out = torch.zeros((A, n_slots + 1, W), dtype=words.dtype, device=words.device)
    out.scatter_(1, s[..., None].expand(-1, -1, W), words)
    return out[:, :n_slots]


def onehot_select_u32(sel: torch.Tensor, words: torch.Tensor) -> torch.Tensor:
    """(A, P, S) one-hot x (A, S, W) words -> (A, P, W): each candidate's
    word row; a row of `sel` that is all zero gives 0."""
    sel = sel.bool()
    return route_select(sel.to(torch.uint8).argmax(dim=-1), sel.any(dim=-1), words)


def onehot_compact_u32(sel: torch.Tensor, words: torch.Tensor) -> torch.Tensor:
    """(A, P, S) one-hot x (A, P, W) words -> (A, S, W): route candidate-axis
    words into their slots; each (a, s) has at most one p with sel set, and
    a slot with none gives 0."""
    sel = sel.bool()
    return route_select(sel.to(torch.uint8).argmax(dim=1), sel.any(dim=1), words)


def onehot_compact_i32(sel: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """onehot_compact_u32 for (A, P) int32 payloads -> (A, S) int32."""
    return onehot_compact_u32(sel, vals.to(torch.int32)[..., None])[..., 0]
