"""The step functions — the port of ``repro.launch.steps``: the
steps (``make_train_step``, ``make_prefill_step``,
``make_decode_step``) and the dry run's inputs (``batch_abstract``,
``train_arguments``, ``serve_arguments``, ``lease_arguments``,
``build_cell``).

A step runs on a ``torch.distributed`` data-parallel ``group`` or on a
(data, model) ``mesh`` (``launch.mesh.make_model_mesh``), whose ranks
each hold their data rank's rows of the batch and their shards of the
parameters by the reference's partition specs
(``models.model.param_placement``), each gathered where it is used; the
MoE layers run expert-parallel over the model axis.  The dry run's
inputs are this rank's, as meta tensors (``models.params.abstract``): its
rows of the batch over the data axes and its shard of every parameter
(and so of every gradient and AdamW moment), the reference's
per-device shards.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig, ShapeCell
from repro_torch.models.params import abstract, map_with_path
from repro_torch.models.training import (all_reduce_mean, device_batch,
                                         loss_and_grads, reduce_mesh_grads)
from repro_torch.optim import adamw
from repro_torch.sharding import ShardCtx, partition_spec, spec_axes


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


# ------------------------------------------------------------ dry run
def batch_rows(n: int, mesh=None) -> int:
    """This rank's rows of ``n``: the batch's spec over the data axes
    (``n`` when they do not divide it: every rank holds the rows)."""
    if mesh is None:
        return n
    axes = spec_axes(partition_spec(mesh, (n,), ("batch",)), 0)
    return n // mesh.axis_size(axes) if axes else n


def param_shapes(cfg: ModelConfig, mesh=None) -> Optional[dict]:
    """Every leaf's shape as this rank of ``mesh`` holds it (its shard
    under ``param_placement``); None on one device."""
    if mesh is None:
        return None
    place = M.param_placement(cfg, mesh)

    def walk(sp, pl):
        if isinstance(pl, dict):
            return {k: walk(sp[k], pl[k]) for k in sp}
        shape = list(sp.shape)
        for d in range(len(pl)):
            axes = spec_axes(pl, d)
            if axes:
                shape[d] //= mesh.axis_size(axes)
        return tuple(shape)

    return walk(M.model_spec(cfg), place)


def batch_abstract(cfg: ModelConfig, cell: ShapeCell, mesh=None,
                   lead: Tuple[int, ...] = ()):
    """This rank's batch as fakes (``lead`` dims in front: the lease
    window's W): ``tokens`` int32, or ``frames`` bf16 and ``labels`` for
    an audio frontend; ``patches`` bf16 for a vision one."""
    B, S = batch_rows(cell.global_batch, mesh), cell.seq_len
    empty = lambda *shape, dt=torch.int32: torch.empty(
        lead + shape, dtype=dt, device="meta")
    if cfg.frontend == "audio":
        return {"frames": empty(B, S, cfg.d_frontend, dt=torch.bfloat16),
                "labels": empty(B, S)}
    batch = {"tokens": empty(B, S)}
    if cfg.frontend == "vision":
        batch["patches"] = empty(B, cfg.n_patch_tokens, cfg.d_model,
                                 dt=torch.bfloat16)
    return batch


def train_arguments(cfg: ModelConfig, cell: ShapeCell, mesh=None):
    """(state, batch) of this rank as fakes: the params in the param
    dtype, zero moments in the moment dtype, the step."""
    params = abstract(M.model_spec(cfg), cfg.policy.param_dtype,
                      param_shapes(cfg, mesh))
    state = adamw.init_state(params, cfg.policy.moment_dtype)
    return state, batch_abstract(cfg, cell, mesh)


def serve_arguments(cfg: ModelConfig, cell: ShapeCell, mesh=None):
    """Prefill: (params, cache, batch); decode: (params, cache, tokens,
    pos) with ``pos = seq_len - 1``, the last slot, so every cache row is
    read.  The params as the server holds them (``cast_params``: weights
    of two or more dims in the compute dtype), the cache of ``seq_len``
    rows in the cache dtype, this rank's rows."""
    B, S = batch_rows(cell.global_batch, mesh), cell.seq_len
    params = abstract(M.model_spec(cfg), cfg.policy.param_dtype,
                      param_shapes(cfg, mesh))
    params = M.cast_params(cfg, params)
    cache = map_with_path(
        M.cache_spec(cfg, B, S), lambda _, p: torch.empty(
            p.shape, dtype=cfg.policy.cache_dtype, device="meta"))
    if cell.kind == "prefill":
        return params, cache, batch_abstract(cfg, cell, mesh)
    tokens = torch.empty((B, 1), dtype=torch.int32, device="meta")
    return params, cache, tokens, S - 1


def lease_arguments(cfg: ModelConfig, cell: ShapeCell, mesh, W: int):
    """(state, batches) for the lease window: the whole params (the
    window trains each replica alone) and W batches of this rank's
    rows."""
    params = abstract(M.model_spec(cfg), cfg.policy.param_dtype)
    state = adamw.init_state(params, cfg.policy.moment_dtype)
    return state, batch_abstract(cfg, cell, mesh, lead=(W,))


def build_cell(cfg: ModelConfig, cell: ShapeCell, mesh=None,
               variant: str = "base"):
    """(fn, args, parts) of one dry-run cell on this rank: the step, its
    fake inputs and the input trees that are params and optimizer state
    (``launch.opanalysis``'s ``parts``).  ``variant`` "leaseW" runs a
    train cell as the lease window of W local steps (default 4) over the
    "pod" axis (``coherence.lease_sync.make_lease_window_step``)."""
    if variant.startswith("lease") and cell.kind == "train":
        from repro_torch.coherence.lease_sync import (LeaseConfig,
                                                      make_lease_window_step)
        if mesh is None or "pod" not in mesh.axis_names:
            raise ValueError("the lease window needs the multi-pod mesh")
        W = int(variant[len("lease"):] or 4)
        fn = make_lease_window_step(cfg, adamw.AdamWConfig(),
                                    LeaseConfig(wr_lease=W),
                                    group=mesh.group(("pod",)))
        state, batches = lease_arguments(cfg, cell, mesh, W)
        return fn, (state, batches), {"params": state.params,
                                      "optimizer": (state.m, state.v,
                                                    state.step)}
    if cell.kind == "train":
        state, batch = train_arguments(cfg, cell, mesh)
        return (make_train_step(cfg, mesh=mesh), (state, batch),
                {"params": state.params,
                 "optimizer": (state.m, state.v, state.step)})
    args = serve_arguments(cfg, cell, mesh)
    fn = (make_prefill_step(cfg, mesh) if cell.kind == "prefill"
          else make_decode_step(cfg, mesh))
    return fn, args, {"params": args[0]}
