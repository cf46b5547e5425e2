"""Roofline terms for one rank of a step — the port of
``repro.launch.roofline``.

compute term    = sum over dtypes of FLOPs / that dtype's peak rate
memory term     = HBM bytes / HBM rate
collective term = wire bytes / NVLink rate (one direction of one GPU)

The counts come from ``launch.opanalysis`` (this rank's operators, its
kernels charged by their rules in ``kernels.cost``, its collectives with
the ring factors of ``_wire_bytes``), not from HLO text: the reference's
``parse_collectives`` has no counterpart.  The rates are the H100's, in
``kernels.cost``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

from repro_torch.kernels.cost import (HBM_BYTES_PER_S, NVLINK_BYTES_PER_S,
                                      compute_seconds)


def _wire_bytes(kind: str, result_bytes: int, n: int) -> float:
    """Per-device wire bytes under ring algorithms."""
    if n <= 1:
        return 0.0
    f = (n - 1) / n
    if kind == "all-gather":
        return result_bytes * f                  # result = gathered buffer
    if kind == "all-reduce":
        return 2.0 * result_bytes * f            # reduce-scatter + all-gather
    if kind == "reduce-scatter":
        return result_bytes * (n - 1)            # result = scattered shard
    if kind == "all-to-all":
        return result_bytes * f
    return float(result_bytes)                   # permute / broadcast


@dataclasses.dataclass
class Roofline:
    flops: float                  # per device, all dtypes
    hbm_bytes: float              # per device
    wire_bytes: float             # per device
    t_compute: float
    t_memory: float
    t_collective: float
    bottleneck: str
    model_flops: float = 0.0      # 6*N*D (or 6*N_active*D)
    useful_ratio: float = 0.0
    flops_by_dtype: Dict[str, float] = dataclasses.field(default_factory=dict)

    @property
    def bound(self) -> float:
        """The least time of the step's device work: max(compute, memory)."""
        return max(self.t_compute, self.t_memory)


def roofline_terms(flops_by_dtype: Dict[str, float], hbm_bytes: float,
                   wire_bytes: float, model_flops_global: float = 0.0,
                   n_devices: int = 1) -> Roofline:
    tc = compute_seconds(flops_by_dtype)
    tm = hbm_bytes / HBM_BYTES_PER_S
    tx = wire_bytes / NVLINK_BYTES_PER_S
    terms = {"compute": tc, "memory": tm, "collective": tx}
    bn = max(terms, key=terms.get)
    flops = float(sum(flops_by_dtype.values()))
    mf = model_flops_global / max(n_devices, 1)
    return Roofline(flops=flops, hbm_bytes=hbm_bytes, wire_bytes=wire_bytes,
                    t_compute=tc, t_memory=tm, t_collective=tx, bottleneck=bn,
                    model_flops=mf, useful_ratio=(mf / flops if flops else 0.0),
                    flops_by_dtype=dict(flops_by_dtype))


def model_flops_for(cfg, cell, n_params_total: int, n_params_active: int) -> float:
    """6*N*D for a train step (fwd+bwd), 2*N*D for inference, per the usual
    transformer accounting; D = tokens processed this step."""
    if cell.kind == "train":
        tokens = cell.global_batch * cell.seq_len
        return 6.0 * n_params_active * tokens
    if cell.kind == "prefill":
        tokens = cell.global_batch * cell.seq_len
        return 2.0 * n_params_active * tokens
    tokens = cell.global_batch                      # one token per sequence
    return 2.0 * n_params_active * tokens
