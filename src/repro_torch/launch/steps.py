"""The train step — the port of ``repro.launch.steps.make_train_step``.

The reference's XLA dry-run helpers (``train_arguments``,
``serve_arguments``, ``build_cell``, ...) abstract shapes and shardings
for TPU meshes and are not ported (ROADMAP Queue 1 item 13).
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.training import (all_reduce_mean, device_batch,
                                         loss_and_grads)
from repro_torch.optim import adamw


def make_train_step(cfg: ModelConfig,
                    opt: adamw.AdamWConfig = adamw.AdamWConfig(),
                    group=None) -> Callable:
    """``train_step(state, batch) -> (new_state, metrics)``: loss,
    gradients, ``apply_updates``, and the metrics ``ce``, ``aux``,
    ``loss`` and ``gnorm`` (f32 scalar tensors on the state's device).
    With a ``torch.distributed`` ``group`` it is synchronous data
    parallelism: each rank's gradients and metrics are averaged over the
    group by one flattened ``all_reduce`` before the update.  The step
    owns the state it is given, as a jit with donated arguments would:
    ``apply_updates`` writes the new weights and moments into that
    state's tensors (new_state holds them), so a caller that needs the
    old state keeps a copy of it."""

    def train_step(state: adamw.TrainState, batch) -> Tuple[
            adamw.TrainState, Dict[str, torch.Tensor]]:
        dev = state.step.device
        loss, metrics, grads = loss_and_grads(cfg, state.params,
                                              device_batch(batch, dev))
        metrics = {k: v.detach() for k, v in metrics.items()}
        if group is not None:
            names = sorted(metrics)
            leaves = list(adamw.tree_leaves(grads))
            avg = all_reduce_mean(leaves + [loss]
                                  + [metrics[k] for k in names], group)
            grads = adamw.tree_unflatten(grads, avg[:len(leaves)])
            loss = avg[len(leaves)]
            metrics = dict(zip(names, avg[len(leaves) + 1:]))
        new_state = adamw.apply_updates(opt, state, grads)
        return new_state, {**metrics, "loss": loss,
                           "gnorm": adamw.global_norm(grads)}

    return train_step

