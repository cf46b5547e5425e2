"""The port's roofline (``repro_torch.launch.roofline``) and its dry-run
cells against the reference's, and the kernels' cost rules.

- ``_wire_bytes``, ``model_flops_for``, ``count_params``,
  ``active_params``, ``SHAPES`` and ``applicable_shapes``: pure
  functions of the configs, equal to the reference's exactly (the
  reference's ``active_params`` is computed here from its
  ``model_spec`` and ``tree_paths``: its ``launch/dryrun.py`` sets
  ``XLA_FLAGS`` when imported);
- each float kernel's cost rule reproduces the bound ``PERF.md`` §6
  gives at §6's shape, to its printed digits (0.05 MB and GFLOP; 0.006
  us: §6 rounds to 0.01 us a value ``chip_smoke.py`` printed to 0.001);
- ``roofline_terms`` takes FLOPs by dtype: its compute term is the sum
  of each dtype's FLOPs over that dtype's peak (exact, rtol 1e-12).
"""
import math

import pytest
import torch

from repro import configs as rcfgs
from repro.launch import roofline as rroof
from repro.models import model as rmodel
from repro.models.config import SHAPES as R_SHAPES
from repro.models.config import applicable_shapes as r_applicable
from repro.models.params import count_params as r_count_params
from repro.models.params import tree_paths as r_tree_paths
from repro_torch import configs as tcfgs
from repro_torch.kernels import cost as kcost
from repro_torch.launch import roofline as troof
from repro_torch.launch.dryrun import active_params
from repro_torch.models import model as tmodel
from repro_torch.models.config import SHAPES, applicable_shapes
from repro_torch.models.params import count_params

KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
         "collective-permute", "collective-broadcast")


def _r_active_params(cfg) -> int:
    """``repro.launch.dryrun.active_params``, written out."""
    total = routed = 0
    for path, p in r_tree_paths(rmodel.model_spec(cfg)):
        n = math.prod(p.shape)
        total += n
        if "/moe/w" in path:
            routed += n
    if cfg.n_experts:
        return int(total - routed + routed * (cfg.top_k / cfg.n_experts))
    return total


@pytest.mark.parametrize("n", [1, 2, 4, 16])
@pytest.mark.parametrize("kind", KINDS)
def test_wire_bytes_equal_reference(kind, n):
    for rb in (0, 1, 4096, 39_321_600):
        assert troof._wire_bytes(kind, rb, n) == rroof._wire_bytes(kind, rb,
                                                                    n)


def test_shapes_equal_reference():
    assert [tuple(vars(c).values()) for c in SHAPES] == \
        [tuple(vars(c).values()) for c in R_SHAPES]


@pytest.mark.parametrize("arch", list(tcfgs.ARCHS))
def test_params_and_model_flops_equal_reference(arch):
    """count_params, active_params, applicable_shapes and model_flops_for
    at full width and every applicable shape."""
    rc, tc = rcfgs.ARCHS[arch], tcfgs.ARCHS[arch]
    assert tc.sub_quadratic == rc.sub_quadratic
    n_total = count_params(tmodel.model_spec(tc))
    assert n_total == r_count_params(rmodel.model_spec(rc))
    n_active = active_params(tc)
    assert n_active == _r_active_params(rc)
    cells = applicable_shapes(tc)
    assert [c.name for c in cells] == [c.name for c in r_applicable(rc)]
    for c, r in zip(cells, r_applicable(rc)):
        assert troof.model_flops_for(tc, c, n_total, n_active) == \
            rroof.model_flops_for(rc, r, n_total, n_active)


def test_roofline_terms_sum_the_dtypes():
    fl = {"bf16": 3e12, "f32": 5e10}
    rl = troof.roofline_terms(fl, 2e9, 1e8, model_flops_global=4e12,
                              n_devices=2)
    want = 3e12 / kcost.BF16_FLOPS_PER_S + 5e10 / kcost.F32_FLOPS_PER_S
    assert rl.t_compute == pytest.approx(want, rel=1e-12)
    assert rl.t_memory == pytest.approx(2e9 / kcost.HBM_BYTES_PER_S,
                                        rel=1e-12)
    assert rl.t_collective == pytest.approx(
        1e8 / kcost.NVLINK_BYTES_PER_S, rel=1e-12)
    assert rl.flops == 3.05e12 and rl.bottleneck == "compute"
    assert rl.model_flops == 2e12
    assert rl.bound == max(rl.t_compute, rl.t_memory)


def _us(kc):
    s, by = kc.bound()
    return s * 1e6, by


@pytest.mark.parametrize("name,cost,want", [
    # smollm-360m's prefill: B=8, S=512, 15 over 5 heads of 64, causal
    ("flash_attention", lambda: kcost.flash_cost(
        8, 512, 512, 15, 5, 64, 64, torch.bfloat16, True), (6.26, "bytes")),
    # gemma3-4b: B=4, S=1536, 8 over 4 heads of 256, windowed and global
    ("flash_attention", lambda: kcost.flash_cost(
        4, 1536, 1536, 8, 4, 256, 256, torch.bfloat16, True, 1024),
     (34.76, "operations")),
    ("flash_attention", lambda: kcost.flash_cost(
        4, 1536, 1536, 8, 4, 256, 256, torch.bfloat16, True),
     (39.11, "operations")),
    # deepseek-v2's MLA prefill, (192, 128)
    ("flash_attention", lambda: kcost.flash_cost(
        2, 512, 512, 128, 128, 192, 128, torch.bfloat16, True),
     (50.08, "bytes")),
    # deepseek-v2's flash backward with the forward's statistics
    ("flash_attention_bwd", lambda: kcost.flash_bwd_cost(
        2, 512, 512, 128, 128, 192, 128, torch.bfloat16, True, stats=True),
     (100.48, "bytes")),
    ("flash_attention_bwd", lambda: kcost.flash_bwd_cost(
        8, 512, 512, 15, 5, 64, 64, torch.bfloat16, True, stats=True),
     (12.67, "bytes")),
    # mamba2-130m's prefill chunk, B/C a stride-0 broadcast, y in f32
    ("ssd_chunk", lambda: kcost.ssd_cost(
        8, 2, 256, 24, 64, 128, torch.bfloat16, True, torch.float32),
     (15.89, "bytes")),
    ("ssd_chunk_bwd", lambda: kcost.ssd_bwd_cost(
        8, 2, 256, 24, 64, 128, torch.bfloat16, True), (34.90, "bytes")),
    # smollm-360m's decode at kv_len 513 of a 584-row cache
    ("decode_attention", lambda: kcost.decode_cost(
        8, 15, 5, 64, 64, 513, torch.bfloat16), (1.58, "bytes")),
    ("rmsnorm", lambda: kcost.rmsnorm_cost(4096, 960, torch.bfloat16),
     (4.70, "bytes")),
    ("rmsnorm_bwd", lambda: kcost.rmsnorm_bwd_cost(4096, 960,
                                                   torch.bfloat16),
     (7.05, "bytes")),
])
def test_kernel_rules_give_perf_md_bounds(name, cost, want):
    us, by = _us(cost())
    assert by == want[1] and abs(us - want[0]) <= 0.006, (name, us)


def test_deepseek_flash_bwd_bytes_and_flops():
    """§6: 336.6 MB and 55.9 GFLOP (whose bf16 time is 56.6 us)."""
    kc = kcost.flash_bwd_cost(2, 512, 512, 128, 128, 192, 128,
                              torch.bfloat16, True, stats=True)
    assert abs(kc.nbytes / 1e6 - 336.6) <= 0.05
    assert abs(kc.flops["bf16"] / 1e9 - 55.9) <= 0.05
    us = kc.flops["bf16"] / kcost.BF16_FLOPS_PER_S * 1e6
    assert abs(us - 56.6) <= 0.05


@pytest.mark.parametrize("Sq,Sk,causal,window", [
    (512, 512, True, 0), (130, 50, True, 16), (100, 77, True, 16),
    (77, 77, False, 0), (1536, 1536, True, 1024), (5, 9, False, 3)])
def test_visible_pairs_count_the_mask(Sq, Sk, causal, window):
    want = sum(1 for i in range(Sq) for j in range(Sk)
               if (not causal or j <= i) and (not window or i - j < window))
    assert kcost.visible_pairs(Sq, Sk, causal, window) == want
