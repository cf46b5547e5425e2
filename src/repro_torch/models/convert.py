"""Carry weights and caches across from the JAX package's trees.

The reference's parameter tree is nested dicts of arrays with stacked
``[L, ...]`` leaves under ``segments/seg<i>`` (and zamba2's shared block
under ``shared_attn``); its cache tree has the same shape, with KV leaves
(MLA: one ``ckv``) at attention positions and ``conv``/``state`` leaves
at SSM positions;
its ``TrainState`` holds a params tree, moments m and v of the same
shape and an int32 step.  The port keeps these layouts, so converting is a walk of the
port's spec that checks every leaf's path and shape and makes it a tensor
(``numpy`` arrays in, including the ``bfloat16`` arrays JAX hands out).
Tests use this so that both packages compute with the same numbers;
``params_shard_from_numpy`` gives a mesh rank its shards of such a tree.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.coherence.fabric.backend import resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import cache_spec, model_spec
from repro_torch.models.params import P


def _to_tensor(a) -> torch.Tensor:
    """A numpy array (f32, int, or the ``ml_dtypes`` bfloat16 JAX uses) as
    a CPU tensor of the same dtype, on a copy (JAX's arrays are
    read-only)."""
    a = np.array(a, order="C")
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _convert(spec, tree, dtype, device, path=""):
    if isinstance(spec, P):
        t = _to_tensor(tree)
        if tuple(t.shape) != tuple(spec.shape):
            raise ValueError(f"{path or '/'}: shape {tuple(t.shape)}, the "
                             f"port expects {spec.shape}")
        return t.to(device=device, dtype=dtype)
    if not isinstance(tree, dict) or set(tree) != set(spec):
        got = sorted(tree) if isinstance(tree, dict) else type(tree).__name__
        raise ValueError(f"{path or '/'}: keys {got}, the port expects "
                         f"{sorted(spec)}")
    return {k: _convert(spec[k], tree[k], dtype, device, f"{path}/{k}")
            for k in spec}


def params_from_numpy(cfg: ModelConfig, tree: dict, device=None) -> dict:
    """The reference's parameter tree (numpy leaves) as the port's, in the
    param dtype on ``device`` (None = the CUDA card)."""
    return _convert(model_spec(cfg), tree, cfg.policy.param_dtype,
                    resolve_device(device))


def params_shard_from_numpy(cfg: ModelConfig, tree: dict, mesh,
                            device=None) -> dict:
    """The reference's parameter tree (numpy leaves, global) as this
    rank's shards of the port's on ``mesh`` (``models.model.shard_model``:
    the MoE layers' router and expert stacks sliced by their specs, every
    other leaf whole), each leaf checked and converted on the host before
    it is sliced and moved to ``device`` (None = the CUDA card)."""
    from repro_torch.models.model import param_placement
    from repro_torch.models.params import shard_params
    host = _convert(model_spec(cfg), tree, cfg.policy.param_dtype, "cpu")
    dev = resolve_device(device)
    return _to(shard_params(host, param_placement(cfg, mesh), mesh), dev)


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device)


def _leaf_shapes(tree):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _leaf_shapes(tree[k])
        else:
            yield k, np.shape(tree[k])


def _cache_dims(tree) -> tuple:
    """(batch, max_len) of a cache tree: batch from its first leaf (an
    attention ``k``/``v``, an MLA ``ckv`` and an SSM ``conv`` are
    ``[..., B, rows, F]``, an SSM ``state`` ``[..., B, H, N, P]``),
    ``max_len`` from its first attention leaf, 0 when it has none (an SSM
    cache has no length)."""
    shapes = list(_leaf_shapes(tree))
    name, shape = shapes[0]
    batch = shape[-4] if name == "state" else shape[-3]
    max_len = next((s[-2] for n, s in shapes if n in ("k", "v", "ckv")), 0)
    return batch, max_len


def cache_from_numpy(cfg: ModelConfig, tree: dict, device=None) -> dict:
    """The reference's cache tree (numpy leaves; KV, SSM or both) as the
    port's, in the cache dtype on ``device`` (None = the CUDA card).
    Batch and length come from the tree's leaves (``_cache_dims``)."""
    batch, max_len = _cache_dims(tree)
    return _convert(cache_spec(cfg, batch, max_len), tree,
                    cfg.policy.cache_dtype, resolve_device(device))


def train_state_from_numpy(cfg: ModelConfig, params, m, v, step,
                           device=None):
    """The reference's ``TrainState`` (its params, m and v trees and its
    step, numpy leaves) as the port's ``optim.adamw.TrainState`` on
    ``device`` (None = the CUDA card): params in the param dtype, moments
    in the moment dtype, the step an int32 scalar."""
    from repro_torch.optim.adamw import TrainState
    dev = resolve_device(device)
    spec = model_spec(cfg)
    return TrainState(
        params=_convert(spec, params, cfg.policy.param_dtype, dev),
        m=_convert(spec, m, cfg.policy.moment_dtype, dev),
        v=_convert(spec, v, cfg.policy.moment_dtype, dev),
        step=torch.tensor(int(np.asarray(step)), dtype=torch.int32,
                          device=dev))
