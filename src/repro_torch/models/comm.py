"""Collectives over a mesh's process groups, each with the backward that
makes a rank's gradient the right share of the mesh's.

The port's ranks hold explicit local tensors where the reference's
``shard_map`` holds per-device blocks.  The ranks of one line of the
"model" axis compute one data-parallel replica together: a value they
all hold is ONE value (replicated), and their gradients of it are equal.
The data-parallel ranks each compute the gradient of their own share of
the loss; a replicated weight's gradient is then averaged over them
(``models.training``).  So:

* ``scatter`` (this rank's block of a replicated value) has, as its
  backward, the all-gather of the blocks' gradients;
* ``gather(..., grad="slice")`` (blocks into a replicated value) takes
  this rank's block of the replicated gradient, and never sums it: every
  model rank holds the same gradient, and a sum would be M times it;
* ``gather(..., grad="sum")`` (the data ranks' blocks, each used by every
  data rank: FSDP weights, the tokens of a global dispatch) sums the
  gradients over the group and keeps this rank's block (a reduce-scatter);
* ``all_to_all`` is its own backward; ``sum_grad`` (a replicated weight
  used on this rank's block of tokens only) sums its gradient over the
  group; ``mean`` scales its gradient by a stated factor.

A group of one rank (or None) issues no collective.  Reductions run in
f32 and cast back.  gloo carries CUDA tensors for every collective used
here (``all_gather_into_tensor``, ``all_to_all_single``, ``all_reduce``);
a collective the group's backend refuses raises.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.sharding import spec_axes


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def _all_gather0(x, group):
    n = dist.get_world_size(group)
    x = x.contiguous()
    out = torch.empty((n * x.shape[0],) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    dist.all_gather_into_tensor(out, x, group=group)
    return out


def all_gather(x, dim: int, group):
    """The group's blocks of ``x`` concatenated along ``dim`` (no
    autograd)."""
    if group_size(group) == 1:
        return x
    out = _all_gather0(x.movedim(dim, 0), group)
    return out.movedim(0, dim)


def _block(x, dim: int, group):
    n, r = dist.get_world_size(group), dist.get_rank(group)
    step = x.shape[dim] // n
    return x.narrow(dim, r * step, step)


def all_reduce_sum(x, group):
    """The sum over the group in f32, in ``x``'s dtype (no autograd)."""
    if group_size(group) == 1:
        return x
    y = x.to(torch.float32).contiguous()
    if y.data_ptr() == x.data_ptr():
        y = y.clone()
    dist.all_reduce(y, group=group)
    return y.to(x.dtype)


class _Scatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _block(x, dim, group).contiguous()

    @staticmethod
    def backward(ctx, g):
        return all_gather(g, ctx.dim, ctx.group), None, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group, grad):
        ctx.dim, ctx.group, ctx.grad = dim, group, grad
        return all_gather(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        if ctx.grad == "sum":
            g = all_reduce_sum(g, ctx.group)
        return _block(g, ctx.dim, ctx.group).contiguous(), None, None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _a2a(x, group)

    @staticmethod
    def backward(ctx, g):
        return _a2a(g, ctx.group), None


def _a2a(x, group):
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    return out


class _SumGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_sum(g, ctx.group), None


class _Mean(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, grad_scale):
        ctx.grad_scale = grad_scale
        return all_reduce_sum(x, group) / group_size(group)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.grad_scale, None, None


class _Ratio(torch.autograd.Function):
    @staticmethod
    def forward(ctx, num, cnt, group):
        tot = all_reduce_sum(torch.stack([num, cnt]), group)
        den = torch.clamp(tot[1], min=1.0)
        ctx.save_for_backward(den)
        ctx.n = group_size(group)
        return tot[0] / den

    @staticmethod
    def backward(ctx, g):
        (den,) = ctx.saved_tensors
        return g * ctx.n / den, None, None


def scatter(x, dim: int, group):
    """This rank's block (of the group's equal blocks) of ``x`` along
    ``dim``, which every rank of the group holds whole."""
    if group_size(group) == 1:
        return x
    return _Scatter.apply(x, dim, group)


def gather(x, dim: int, group, grad: str = "slice"):
    """The group's blocks concatenated along ``dim``; ``grad`` "slice"
    (the result is one replicated value) or "sum" (each rank uses the
    whole result for work of its own)."""
    if group_size(group) == 1:
        return x
    return _Gather.apply(x, dim, group, grad)


def all_to_all(x, group):
    """Block ``j`` of ``x``'s dim 0 to group rank ``j``; block ``i`` of
    the result from group rank ``i`` (``jax.lax.all_to_all`` with
    ``split_axis = concat_axis = 0, tiled=True``)."""
    if group_size(group) == 1:
        return x
    return _AllToAll.apply(x, group)


def sum_grad(x, group):
    """``x`` itself, whose gradient is summed over the group."""
    if group_size(group) == 1:
        return x
    return _SumGrad.apply(x, group)


def mean(x, group, grad_scale: float = 1.0):
    """The mean of ``x`` over the group; the gradient of each rank's
    ``x`` is the result's times ``grad_scale``."""
    if group_size(group) == 1 and grad_scale == 1.0:
        return x
    return _Mean.apply(x, group, grad_scale)


def ratio(num, cnt, group: Optional[object]):
    """``sum(num) / max(sum(cnt), 1)`` over the group's ranks (f32
    scalars); the gradient of each rank's ``num`` is ``n / max(sum(cnt),
    1)`` times the result's, n the group's size, so the mean of the
    ranks' gradients is the gradient of the one global ratio."""
    if group_size(group) == 1:
        return num / torch.clamp(cnt, min=1.0)
    return _Ratio.apply(num, cnt, group)


def full_tree(tree, specs, mesh):
    """The global tensors of a tree of this rank's shards (``specs`` a
    tree of spec tuples over the same keys): each split dim all-gathered
    over the group of its axes (no autograd).  Every rank of the mesh
    must call it, in the same order."""
    if isinstance(tree, dict):
        return {k: full_tree(tree[k], specs[k], mesh) for k in sorted(tree)}
    x = tree
    for dim in range(len(specs)):
        axes = spec_axes(specs, dim)
        if axes:
            x = all_gather(x, dim, mesh.group(axes))
    return x
