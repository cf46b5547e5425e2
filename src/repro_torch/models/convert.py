"""Carry weights and caches across from the JAX package's trees.

The reference's parameter tree is nested dicts of arrays with stacked
``[L, ...]`` leaves under ``segments/seg0``; its cache tree has the same
shape.  The port keeps both layouts, so converting is a walk of the
port's spec that checks every leaf's path and shape and makes it a tensor
(``numpy`` arrays in, including the ``bfloat16`` arrays JAX hands out).
Tests use this so that both packages compute with the same numbers.
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


def cache_from_numpy(cfg: ModelConfig, tree: dict, device=None) -> dict:
    """The reference's KV-cache tree (numpy leaves) as the port's, in the
    cache dtype on ``device`` (None = the CUDA card).  Batch and length
    come from the tree's ``[..., B, max_len, Hkv*Dh]`` leaves."""
    first = tree["seg0"]["0"]["k"]
    batch, max_len = np.shape(first)[-3:-1]
    return _convert(cache_spec(cfg, batch, max_len), tree,
                    cfg.policy.cache_dtype, resolve_device(device))
