"""AdamW with global-norm clipping, cosine schedule, and policy-controlled
moment dtype — the port of ``repro.optim.adamw``.

Parameter trees are dicts of tensors with the reference's key names; a
tree's leaves are visited in sorted-key order, the order of
``jax.tree.leaves``, so sums over leaves add in the reference's order.
The step is an int32 scalar tensor, and every scalar of the update (the
learning rate, the clip scale, the bias corrections ``1 - b ** step``)
is an f32 tensor computed as JAX computes it, not a Python float64.
Plain torch: the reference has no kernel here either.

The update is in place, as a jit with donated arguments would run it:
each leaf's new weights and moments are written into the state's own
tensors, a chunk of the leaf at a time, so the f32 temporaries are a
chunk's.  deepseek-v2's 2-layer state under its bf16 policy is 42.9 GB
with the gradient; a new state beside it would add 32.2 GB, and
whole-leaf f32 temporaries 5 GB each on an expert stack.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Iterator, NamedTuple

import torch

from repro_torch.kernels import cost


# elements of a leaf updated at a time: the chunk's f32 temporaries (at
# most about ten, 256 MB each) against the host's launches, ~20 a chunk
# (at 2^24 deepseek-v2's update took 414 ms to enqueue and 455 ms on an
# H100: scripts/adamw_update_ab.py)
INPLACE_CHUNK = 1 << 26


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
    return _build(like, iter(leaves))


def _build(t, it):
    # a module-level function, not a closure over ``it``: a recursive
    # closure is a reference cycle, which kept each training step's
    # gradients alive until Python's cyclic collector ran (deepseek-v2's
    # step ran out of card memory on three steps' gradients)
    if isinstance(t, dict):
        return {k: _build(t[k], it) for k in sorted(t)}
    return next(it)


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


def global_norm(tree, specs=None, mesh=None) -> torch.Tensor:
    """sqrt of the sum over leaves (sorted-key order) of each leaf's sum
    of squares in f32.  On a ``mesh``, ``specs`` (a tree of spec tuples,
    ``models.model.param_placement``) says which leaves are shards: a
    shard's sum of squares is summed over the group of the axes it is
    split over, so every rank takes the norm of the whole tree, and the
    same one (a replicated leaf's gradient is equal on every rank)."""
    sq = [torch.sum(torch.square(x.to(torch.float32)))
          for x in tree_leaves(tree)]
    if mesh is not None:
        from repro_torch.models.comm import all_reduce_sum
        from repro_torch.sharding import split_axes
        by_axes: dict = {}
        for i, spec in enumerate(tree_leaves(specs)):
            axes = split_axes(spec)
            key = tuple(a for a in mesh.axis_names if a in axes)
            if key:
                by_axes.setdefault(key, []).append(i)
        for key, idx in by_axes.items():
            summed = all_reduce_sum(torch.stack([sq[i] for i in idx]),
                                    mesh.group(key))
            for j, i in enumerate(idx):
                sq[i] = summed[j]
    total = None
    for s in sq:
        total = s if total is None else total + s
    return torch.sqrt(total)


def _bias_correction(b: float, step: torch.Tensor) -> torch.Tensor:
    """``1 - b ** step`` in f32, as JAX takes a float scalar to an int32
    power.  The base stays a Python scalar: a tensor made from it on the
    card would be a host-to-device copy, which waits for the stream."""
    return 1 - torch.pow(b, step.to(torch.float32))


def _address(t: torch.Tensor) -> int:
    """Where ``t``'s data starts; a fake (the dry run's) has no data, so
    its storage stands for it."""
    return t.untyped_storage()._cdata if cost.is_fake(t) else t.data_ptr()


@torch.no_grad()
def apply_updates(cfg: AdamWConfig, state: TrainState, grads,
                  gnorm=None) -> TrainState:
    """One AdamW step: gradients clipped to ``clip_norm`` by their global
    norm, f32 moments, bias-corrected, decoupled weight decay on every
    leaf whose STACKED tensor has two or more dims (so the stacked
    ``[L, D]`` norm weights decay and ``ln_f`` and 1-D biases do not),
    each result cast back to its leaf's dtype.

    The state is consumed: each leaf's new params, m and v are written
    into its own tensors, ``INPLACE_CHUNK`` elements at a time, and the
    returned state holds those tensors with the new step; a caller that
    needs the old state clones it first.  An f32 leaf is updated by
    in-place ops on it, a leaf of another dtype through an f32 copy of the
    chunk that is cast back; either way each element's arithmetic and
    rounding are those of the whole-leaf update, the reference's.  params,
    m and v must be contiguous tensors that share no memory.  ``gnorm``
    is the gradients' global norm when the caller has taken it (on a
    mesh: ``global_norm(grads, specs, mesh)``, the whole tree's); None
    takes ``global_norm(grads)``.  On a mesh the moments are the params'
    shards, as the reference's ``state_shardings`` place them."""
    trees = (state.params, state.m, state.v)
    owned = [t for tree in trees for t in tree_leaves(tree) if t.numel()]
    if len({_address(t) for t in owned}) != len(owned) \
            or not all(t.is_contiguous() for t in owned):
        raise ValueError("apply_updates: params, m and v must be "
                         "contiguous tensors that share no memory")
    step = state.step + 1
    lr = schedule(cfg, step)
    gn = global_norm(grads) if gnorm is None else gnorm
    scale = torch.clamp(cfg.clip_norm / (gn + 1e-9), max=1.0)
    c1 = _bias_correction(cfg.b1, step)
    c2 = _bias_correction(cfg.b2, step)
    for p, m, v, g in zip(*(tree_leaves(t) for t in trees),
                          tree_leaves(grads)):
        decay = float(p.dim() > 1)
        flat = [t.view(-1) for t in (p, m, v)]
        gf = g.reshape(-1)
        for i in range(0, p.numel(), INPLACE_CHUNK):
            part = slice(i, i + INPLACE_CHUNK)
            p_, m_, v_ = (t[part] for t in flat)
            # an f32 chunk is the state's own (``to`` copies nothing)
            p32, m32, v32 = (t.to(torch.float32) for t in (p_, m_, v_))
            g32 = gf[part].to(torch.float32) * scale
            m32.mul_(cfg.b1).add_(g32 * (1 - cfg.b1))
            v32.mul_(cfg.b2).add_(g32 * g32 * (1 - cfg.b2))
            mh = m32 / c1
            vh = v32 / c2
            p32.sub_(lr * (mh / (torch.sqrt(vh) + cfg.eps)
                           + cfg.weight_decay * p32 * decay))
            for t, t32 in ((p_, p32), (m_, m32), (v_, v32)):
                if t.dtype != torch.float32:
                    t.copy_(t32)
    return state._replace(step=step)
