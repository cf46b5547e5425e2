"""Int8 gradient compression with error feedback — the port of
``repro.optim.compress``'s ``quantize``, ``dequantize`` and
``ef_compress``.

Gradients cross the wire as int8 (4x fewer bytes than f32); the
quantization error is fed back into the next step's gradient, so the
optimizer sees an unbiased long-run signal (the standard EF-SGD result).
The reference's ``compressed_psum`` and ``make_compressed_allreduce``
(an int8 reduce-scatter and all-gather inside ``shard_map``) are not
ported: no module of the reference calls them, and they cannot run
there, so nothing could hold a port to them.  ``compressed_psum`` hands
``jax.lax.all_to_all`` ``q[None]``, whose split axis has size 1 where
the mesh axis has n, so ``make_compressed_allreduce`` raises
``ValueError`` on every mesh (ROADMAP "Findings about the reference",
R2; Queue 1 item 12f's remainder).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def quantize(x, axis: Optional[int] = None) -> Tuple[torch.Tensor,
                                                     torch.Tensor]:
    """Symmetric int8: ``scale = max|x| / 127 + 1e-12`` over ``axis`` (all
    dims when None, kept as size-1 dims), ``q = clip(round(x / scale),
    -127, 127)`` rounded half to even.  Returns (q int8, scale f32)."""
    dims = tuple(range(x.dim())) if axis is None else axis
    scale = torch.amax(torch.abs(x), dim=dims, keepdim=True) / 127.0 + 1e-12
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize(q, scale):
    return q.to(torch.float32) * scale


def ef_compress(grad, error):
    """Error feedback: returns (decompressed_grad in grad's dtype,
    new_error f32)."""
    g = grad.to(torch.float32) + error
    q, s = quantize(g)
    deq = dequantize(q, s)
    return deq.to(grad.dtype), g - deq
