"""What the synchronous train step (``launch.steps``) and the lease
window (``coherence.lease_sync``) share: a batch on the device, the loss
and its gradient, and the mean of tensors over a ``torch.distributed``
group."""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.coherence.fabric.backend import to_device
from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig
from repro_torch.optim import adamw


def device_batch(batch: dict, device) -> Dict[str, torch.Tensor]:
    """A batch of numpy arrays (or tensors) as tensors on ``device``
    (host arrays through pinned memory, without a wait)."""
    return {k: (v.to(device) if isinstance(v, torch.Tensor)
                else to_device(np.asarray(v), device))
            for k, v in batch.items()}


def loss_and_grads(cfg: ModelConfig, params: dict, batch: dict):
    """(loss, metrics, grads): the loss of ``params`` on ``batch`` and its
    gradient as a tree of ``params``' structure.  ``params`` are not
    written; an unused leaf's gradient is zeros."""
    p = adamw.tree_map(lambda t: t.detach().requires_grad_(), params)
    leaves = list(adamw.tree_leaves(p))
    loss, metrics = M.loss_fn(cfg, p, batch)
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
