"""The optimizer stack of the NeRF configs, Ema(ExponentialDecay(Adam))
(port of the JAX package's ops/optim.py).

Functional over a tree of tensors (a dict whose values are tensors or
lists of tensors): `optim_step` returns new params and a new state, and
the state is plain data, {"m", "v", "step", "ema"}.  The raw params train;
the EMA shadow is what inference reads (`inference_params`).  `step` is a
Python int: the learning rate and the bias corrections are f32 scalars
computed on the host, and every tensor operation keeps the reference's
order, so the same gradients give the same update to a few f32 ulps.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


def tree_map(fn, *trees):
    """Apply `fn` leaf by leaf over trees of one structure (dicts, lists,
    tuples; anything else is a leaf)."""
    t0 = trees[0]
    if isinstance(t0, dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in t0}
    if isinstance(t0, (list, tuple)):
        return [tree_map(fn, *xs) for xs in zip(*trees)]
    return fn(*trees)


def tree_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for k in tree for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_unflatten(tree, leaves: list):
    """`tree`'s structure with `leaves` in tree_leaves order."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


@dataclass(frozen=True)
class OptimizerSpec:
    learning_rate: float = 1e-2
    beta1: float = 0.9
    beta2: float = 0.99
    epsilon: float = 1e-15
    l2_reg: float = 1e-6
    # ExponentialDecay (a no-op when decay_interval <= 0)
    decay_start: int = 0
    decay_interval: int = 0
    decay_end: int = 2 ** 31 - 1
    decay_base: float = 1.0
    # Ema (a no-op when ema_decay <= 0)
    ema_decay: float = 0.0

    @staticmethod
    def from_network_config(cfg: dict) -> "OptimizerSpec":
        """Parse a (possibly nested) tcnn optimizer config."""
        ema_decay = 0.0
        decay = {}
        node = cfg
        while True:
            otype = node.get("otype", "Adam").lower()
            if otype == "ema":
                ema_decay = float(node.get("decay", 0.99))
                node = node["nested"]
            elif otype == "exponentialdecay":
                decay = dict(
                    decay_start=int(node.get("decay_start", 0)),
                    decay_interval=int(node.get("decay_interval", 0)),
                    decay_end=int(node.get("decay_end", 2 ** 31 - 1)),
                    decay_base=float(node.get("decay_base", 1.0)),
                )
                node = node["nested"]
            else:
                break
        return OptimizerSpec(
            learning_rate=float(node.get("learning_rate", 1e-2)),
            beta1=float(node.get("beta1", 0.9)),
            beta2=float(node.get("beta2", 0.99)),
            epsilon=float(node.get("epsilon", 1e-15)),
            l2_reg=float(node.get("l2_reg", 0.0)),
            ema_decay=ema_decay,
            **decay,
        )


def optim_init(params, spec: OptimizerSpec) -> dict:
    state = {
        "m": tree_map(torch.zeros_like, params),
        "v": tree_map(torch.zeros_like, params),
        "step": 0,
    }
    if spec.ema_decay > 0.0:
        state["ema"] = tree_map(torch.clone, params)
    return state


def lr_factor(spec: OptimizerSpec, step: int) -> np.float32:
    """Stepped exponential decay: times decay_base every decay_interval
    steps once past decay_start, frozen after decay_end."""
    if spec.decay_interval <= 0 or spec.decay_base == 1.0:
        return np.float32(1.0)
    eff = min(max(int(step), spec.decay_start), spec.decay_end) - spec.decay_start
    n = np.float32(eff // spec.decay_interval)
    return np.power(np.float32(spec.decay_base), n)


def optim_step(spec: OptimizerSpec, state: dict, params, grads, l2_mask=None,
               lr_mask=None, inplace: bool = False):
    """One Adam step with the learning-rate schedule, then the EMA shadow.

    `l2_mask` (a tree of 0/1 floats like params) picks the leaves that get
    l2_reg coupled into their gradient (the MLP matrices, not the hash
    table); None gives it to none.  `lr_mask` scales each leaf's rate.
    With `inplace` the params, m, v and the EMA shadow are updated in
    place, _CHUNK elements at a time, to the same values: the image mode's
    8.6 GB table leaves no room for the functional update's new copies.
    -> (new params, new state)."""
    step = int(state["step"]) + 1
    f32 = np.float32
    lr = f32(spec.learning_rate) * lr_factor(spec, step)
    b1, b2 = spec.beta1, spec.beta2
    bias1 = float(f32(1.0) - np.power(f32(b1), f32(step)))
    bias2 = float(f32(1.0) - np.power(f32(b2), f32(step)))
    if l2_mask is None:
        l2_mask = tree_map(lambda _: 0.0, params)
    if lr_mask is None:
        lr_mask = tree_map(lambda _: 1.0, params)

    def adam(p, g, m, v, mask, lscale):
        g = g.float()
        if mask:
            g = g + (spec.l2_reg * mask) * p.float()
        m = b1 * m + (1.0 - b1) * g
        v = b2 * v + (1.0 - b2) * g * g
        m_hat = m / bias1
        v_hat = v / bias2
        rate = float(lr * f32(lscale))
        new_p = p - rate * m_hat / (torch.sqrt(v_hat) + spec.epsilon)
        return new_p.to(p.dtype), m, v

    def upd(p, g, m, v, mask, lscale):
        if not inplace:
            return adam(p, g, m, v, mask, lscale)
        _in_chunks(lambda pc, mc, vc, gc: adam(pc, gc, mc, vc, mask, lscale), p, m, v, g,
                   n_out=3)
        return p, m, v

    out = tree_map(upd, params, grads, state["m"], state["v"], l2_mask, lr_mask)
    leaves = tree_leaves(out)  # (p, m, v) triples, flattened
    new_params = tree_unflatten(params, leaves[0::3])
    new_state = {"m": tree_unflatten(params, leaves[1::3]),
                 "v": tree_unflatten(params, leaves[2::3]), "step": step}
    if "ema" in state:
        d = spec.ema_decay

        def ema(e, p):
            if not inplace:
                return d * e + (1.0 - d) * p
            _in_chunks(lambda ec, pc: (d * ec + (1.0 - d) * pc,), e, p, n_out=1)
            return e

        new_state["ema"] = tree_map(ema, state["ema"], new_params)
    return new_params, new_state


_CHUNK = 1 << 26  # elements of one in-place pass (256 MB of f32)


@torch.no_grad()
def _in_chunks(fn, *tensors, n_out: int) -> None:
    """Apply `fn` to aligned flat chunks of `tensors` and write its n_out
    results into the chunks of the first n_out, in place."""
    flat = [t.reshape(-1) for t in tensors]
    for t, f in zip(tensors[:n_out], flat):
        if f.data_ptr() != t.data_ptr() or not t.is_contiguous():
            raise ValueError("an in-place optimizer leaf must be contiguous")
    for s in range(0, flat[0].numel(), _CHUNK):
        outs = fn(*(f[s:s + _CHUNK] for f in flat))
        for f, o in zip(flat[:n_out], outs):
            f[s:s + _CHUNK].copy_(o)


def inference_params(state: dict, params):
    """The params to render and evaluate with: the EMA shadow when there
    is one."""
    return state.get("ema", params)
