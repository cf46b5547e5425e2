"""The step functions — the port of ``repro.launch.steps``'s
``make_train_step``, ``make_prefill_step`` and ``make_decode_step``.

A step runs on a ``torch.distributed`` data-parallel ``group`` or on a
(data, model) ``mesh`` (``launch.mesh.make_model_mesh``), whose ranks
each hold their data rank's rows of the batch and their shards of the
parameters (``models.model.param_placement``): the MoE layers run
expert-parallel over the model axis.  The reference's XLA dry-run
helpers (``train_arguments``, ``serve_arguments``, ``build_cell``, ...)
abstract shapes and shardings for TPU meshes and are not ported (ROADMAP
Queue 1 item 13).
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig
from repro_torch.models.training import (all_reduce_mean, device_batch,
                                         loss_and_grads, reduce_mesh_grads)
from repro_torch.optim import adamw
from repro_torch.sharding import ShardCtx


def make_grad_step(cfg: ModelConfig, group=None, mesh=None) -> Callable:
    """``grad_step(params, batch) -> (loss, metrics, grads)``: the global
    batch's loss, its ``ce`` and ``aux``, and the gradient of the global
    loss as this rank holds it (``make_train_step``'s first half).

    With a ``torch.distributed`` ``group`` it is synchronous data
    parallelism: the CE's sum and count are summed over the group before
    the division, and each rank's gradients and its aux are averaged over
    the group by one flattened ``all_reduce``.  With a ``mesh`` the params
    are this rank's shards and the batch its data rank's rows; each
    gradient is reduced by its leaf's spec (``reduce_mesh_grads``).  A
    ``(n, 1)`` mesh computes what the ``group`` path computes."""
    if group is not None and mesh is not None:
        raise ValueError("a step takes a group or a mesh, not both")
    ctx = ShardCtx(mesh) if mesh is not None else ShardCtx(data_group=group)
    specs = None if mesh is None else M.param_placement(cfg, mesh)

    def grad_step(params, batch):
        dev = next(adamw.tree_leaves(params)).device
        loss, metrics, grads = loss_and_grads(cfg, params,
                                              device_batch(batch, dev), ctx)
        metrics = {k: v.detach() for k, v in metrics.items()}
        if group is not None:
            names = sorted(metrics)
            leaves = list(adamw.tree_leaves(grads))
            avg = all_reduce_mean(leaves + [loss]
                                  + [metrics[k] for k in names], group)
            grads = adamw.tree_unflatten(grads, avg[:len(leaves)])
            loss = avg[len(leaves)]
            metrics = dict(zip(names, avg[len(leaves) + 1:]))
        if mesh is not None:
            # loss, ce and aux are the global batch's on every rank
            grads = reduce_mesh_grads(grads, specs, ctx)
        return loss, metrics, grads

    return grad_step


def make_train_step(cfg: ModelConfig,
                    opt: adamw.AdamWConfig = adamw.AdamWConfig(),
                    group=None, mesh=None) -> Callable:
    """``train_step(state, batch) -> (new_state, metrics)``: loss,
    gradients (``make_grad_step`` over the ``group`` or the ``mesh``),
    ``apply_updates``, and the metrics ``ce``, ``aux``, ``loss`` and
    ``gnorm`` (f32 scalar tensors on the state's device), each the global
    batch's.  On a mesh the state holds this rank's shards and the clip
    takes the norm of the whole tree (``adamw.global_norm`` over the
    shards' holders).  The step owns the state it is given, as a jit with
    donated arguments would: ``apply_updates`` writes the new weights and
    moments into that state's tensors (new_state holds them), so a caller
    that needs the old state keeps a copy of it."""
    grad_step = make_grad_step(cfg, group, mesh)
    specs = None if mesh is None else M.param_placement(cfg, mesh)

    def train_step(state: adamw.TrainState, batch) -> Tuple[
            adamw.TrainState, Dict[str, torch.Tensor]]:
        loss, metrics, grads = grad_step(state.params, batch)
        gnorm = adamw.global_norm(grads, specs, mesh)
        new_state = adamw.apply_updates(opt, state, grads, gnorm=gnorm)
        return new_state, {**metrics, "loss": loss, "gnorm": gnorm}

    return train_step


def make_prefill_step(cfg: ModelConfig, mesh=None) -> Callable:
    """``prefill_step(params, cache, batch) -> (next_ids, cache)``:
    ``models.prefill`` of a batch (``tokens``, or ``frames``; ``patches``)
    on ``mesh``'s ranks (this rank's rows; None: one device)."""
    ctx = ShardCtx(mesh)

    def prefill_step(params, cache, batch):
        return M.prefill(cfg, params, batch.get("tokens"), cache,
                         patches=batch.get("patches"),
                         frames=batch.get("frames"), ctx=ctx)

    return prefill_step


def make_decode_step(cfg: ModelConfig, mesh=None) -> Callable:
    """``decode_step(params, cache, tokens, pos) -> (next_ids, cache)``
    on ``mesh``'s ranks (this rank's rows; None: one device)."""
    ctx = ShardCtx(mesh)

    def decode_step(params, cache, tokens, pos):
        return M.decode_step(cfg, params, cache, tokens, pos, ctx=ctx)

    return decode_step
