"""What the synchronous train step (``launch.steps``) and the lease
window (``coherence.lease_sync``) share: a batch on the device, the loss
and its gradient, the mean of tensors over a ``torch.distributed``
group, and a mesh's gradient reduction (``reduce_mesh_grads``)."""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.coherence.fabric.backend import to_device
from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig
from repro_torch.optim import adamw
from repro_torch.sharding import NOSHARD, ShardCtx, split_axes


def device_batch(batch: dict, device) -> Dict[str, torch.Tensor]:
    """A batch of numpy arrays (or tensors) as tensors on ``device``
    (host arrays through pinned memory, without a wait)."""
    return {k: (v.to(device) if isinstance(v, torch.Tensor)
                else to_device(np.asarray(v), device))
            for k, v in batch.items()}


def loss_and_grads(cfg: ModelConfig, params: dict, batch: dict,
                   ctx: ShardCtx = NOSHARD):
    """(loss, metrics, grads): the loss of ``params`` on ``batch`` and its
    gradient as a tree of ``params``' structure (``M.loss_fn`` under
    ``ctx``: on a mesh or a data group, this rank's share, which
    ``reduce_mesh_grads`` or ``all_reduce_mean`` completes).  ``params``
    are not written; an unused leaf's gradient is zeros."""
    p = adamw.tree_map(lambda t: t.detach().requires_grad_(), params)
    leaves = list(adamw.tree_leaves(p))
    loss, metrics = M.loss_fn(cfg, p, batch, ctx)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(t) if g is None else g
             for t, g in zip(leaves, grads)]
    return loss.detach(), metrics, adamw.tree_unflatten(params, grads)


def all_reduce_mean(tensors, group) -> list:
    """The mean over ``group``'s ranks of each tensor, through ONE
    flattened f32 ``all_reduce``; each result in its tensor's dtype."""
    flat = torch.cat([t.reshape(-1).to(torch.float32) for t in tensors])
    dist.all_reduce(flat, group=group)
    flat /= dist.get_world_size(group)
    out, at = [], 0
    for t in tensors:
        out.append(flat[at:at + t.numel()].view(t.shape).to(t.dtype))
        at += t.numel()
    return out


def reduce_mesh_grads(grads, specs, ctx: ShardCtx):
    """A mesh rank's gradients (``loss_and_grads`` under ``ctx``) made the
    global loss's, leaf by leaf from its spec: a leaf split over the data
    axes was summed over them by its gather's backward, and is divided by
    their size; every other leaf is averaged over the data group (one
    flattened ``all_reduce``).  Nothing is reduced over "model": its
    ranks' gradients of a replicated leaf are equal already, and a
    model-split leaf's are its own."""
    dp = set(ctx.dp_axes)
    n_dp = ctx.mesh.axis_size(ctx.dp_axes)
    leaves = list(adamw.tree_leaves(grads))
    split = [any(a in dp for a in split_axes(spec))
             for spec in adamw.tree_leaves(specs)]
    out = [g / n_dp if s else g for g, s in zip(leaves, split)]
    if n_dp > 1:
        rest = [i for i, s in enumerate(split) if not s]
        for i, g in zip(rest, all_reduce_mean([leaves[i] for i in rest],
                                              ctx.data_group)):
            out[i] = g
    return adamw.tree_unflatten(grads, out)
