"""AdamW with global-norm clipping, cosine schedule, and policy-controlled
moment dtype — the port of ``repro.optim.adamw``.

Parameter trees are dicts of tensors with the reference's key names; a
tree's leaves are visited in sorted-key order, the order of
``jax.tree.leaves``, so sums over leaves add in the reference's order.
The step is an int32 scalar tensor, and every scalar of the update (the
learning rate, the clip scale, the bias corrections ``1 - b ** step``)
is an f32 tensor computed as JAX computes it, not a Python float64.
Plain torch: the reference has no kernel here either.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Iterator, NamedTuple

import torch


class TrainState(NamedTuple):
    params: Any
    m: Any
    v: Any
    step: torch.Tensor


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000


def tree_leaves(tree) -> Iterator[torch.Tensor]:
    """The leaves of a dict tree in sorted-key order (JAX's)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_leaves(tree[k])
    else:
        yield tree


def tree_unflatten(like, leaves):
    """A dict tree of ``like``'s structure with ``leaves`` (an iterable in
    sorted-key order) at its leaves."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        return next(it)
    return build(like)


def tree_map(fn, *trees):
    """``fn`` over the leaves of dict trees of one structure."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in first}
    return fn(*trees)


def init_state(params, moment_dtype=torch.float32) -> TrainState:
    """Zero moments in ``moment_dtype`` beside ``params``, step 0 (int32
    on the params' device)."""
    zeros = lambda p: torch.zeros(p.shape, dtype=moment_dtype,
                                  device=p.device)
    dev = next(tree_leaves(params)).device
    return TrainState(params=params, m=tree_map(zeros, params),
                      v=tree_map(zeros, params),
                      step=torch.zeros((), dtype=torch.int32, device=dev))


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup, then cosine decay to 0 at ``total_steps``; f32."""
    stepf = step.to(torch.float32)
    warm = torch.clamp(stepf / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((stepf - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    return cfg.lr * warm * 0.5 * (1.0 + torch.cos(math.pi * prog))


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over leaves (sorted-key order) of each leaf's sum
    of squares in f32."""
    total = None
    for x in tree_leaves(tree):
        s = torch.sum(torch.square(x.to(torch.float32)))
        total = s if total is None else total + s
    return torch.sqrt(total)


def _bias_correction(b: float, step: torch.Tensor) -> torch.Tensor:
    """``1 - b ** step`` in f32, as JAX takes a float scalar to an int32
    power.  The base stays a Python scalar: a tensor made from it on the
    card would be a host-to-device copy, which waits for the stream."""
    return 1 - torch.pow(b, step.to(torch.float32))


def apply_updates(cfg: AdamWConfig, state: TrainState, grads) -> TrainState:
    """One AdamW step: gradients clipped to ``clip_norm`` by their global
    norm, f32 moments, bias-corrected, decoupled weight decay on every
    leaf whose STACKED tensor has two or more dims (so the stacked
    ``[L, D]`` norm weights decay and ``ln_f`` and 1-D biases do not),
    each result cast back to its leaf's dtype.  Returns a new state; the
    old one is not written."""
    step = state.step + 1
    lr = schedule(cfg, step)
    gn = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / (gn + 1e-9), max=1.0)
    c1 = _bias_correction(cfg.b1, step)
    c2 = _bias_correction(cfg.b2, step)

    def upd(p, m, v, g):
        g = g.to(torch.float32) * scale
        m32 = m.to(torch.float32) * cfg.b1 + g * (1 - cfg.b1)
        v32 = v.to(torch.float32) * cfg.b2 + g * g * (1 - cfg.b2)
        mh = m32 / c1
        vh = v32 / c2
        p32 = p.to(torch.float32)
        p32 = p32 - lr * (mh / (torch.sqrt(vh) + cfg.eps)
                          + cfg.weight_decay * p32 * float(p.dim() > 1))
        return p32.to(p.dtype), m32.to(m.dtype), v32.to(v.dtype)

    out = tree_map(upd, state.params, state.m, state.v, grads)
    return TrainState(params=_pick(out, 0), m=_pick(out, 1),
                      v=_pick(out, 2), step=step)


def _pick(tree, i: int):
    if isinstance(tree, dict):
        return {k: _pick(v, i) for k, v in tree.items()}
    return tree[i]
