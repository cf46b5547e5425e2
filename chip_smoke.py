#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one
NVIDIA H100.

    python3 chip_smoke.py [--profile]

Phases (any failure raises and the script exits non-zero):

  1. card and build: the card's name and power limit, then the CUDA
     kernels built from ``src/repro_torch/kernels/csrc`` for ``sm_90a``;
  2. each kernel against its plain PyTorch version on the card, with
     CUDA-event timings and each kernel's bound.  The coherence kernels
     at the main path's shapes, on seeded inputs with duplicate tags,
     empty ways, full and partly-full TSU rows and clocks near ``TS_MAX``
     — exact equality on every output; each in the indexed form its
     caller uses, the tier tables read in place at each lane's row
     (``lease_probe`` on a replica's 1024 sets at N = 1, 64, 4096 lanes,
     and at the figure engine's shapes: W = 4 on an L1 of N x 64 sets and
     W = 16 on an L2 of 256 sets a bank, N = 1408 and 5632 lanes, a
     clock and a grant per lane;
     ``miss_round`` on the 8 TSU rows of 1024 ways with 32, 64 and 8192
     lanes, the counts phase 3 launches, and on rows of 20000 ways;
     ``write_grant`` on the 8 shard rows with 16 or 64 lanes), beside the
     call it replaced (the gathers plus the gathered launch, which must
     agree), and in the gathered form (``miss_round`` and ``write_grant``
     at 256 rows, ``write_grant`` at 16 rows of 20000 ways, walked in
     tiles).  The float kernels (rmsnorm at
     decode and prefill rows of every width the models normalise, flash
     attention, decode attention) at the LLM serving path's shapes
     (phase 9's among them: head dims 80, 128 with 7 query heads a kv
     head, and 256; hubert's D = 80 in bf16 also on the CUDA-core kernel,
     its route before the tensor-core one took that head dim) and at odd
     ones, in bf16 and in f32, within stated tolerances, with the time of
     one PyTorch library call of the same function beside them (timed
     only: the port never calls it).  ``ssd_chunk`` at the
     mamba2-130m and zamba2-1.2b prefill shapes (B and C a stride-0
     broadcast over the heads, as the model passes them, and copied per
     head) and at odd ones, bf16 (y asked in f32, as the model does) on
     the route ``route`` names and f32 on the CUDA-core kernels, with dt
     drawn so that cum falls to about -50 over a chunk of 256, cum equal
     to the plain version's and no NaN anywhere, each row beside the
     CUDA-core kernels' time at its shape; no PyTorch call computes it;
  3. the main path at the serving bench's geometry (8 TSU shards x 1024
     entries, 1024x8 replica sets, 2048x8 shared sets, 2 nodes x 2
     replicas) over 8192 keys, so the TSU table fills: warm the fabric
     (publish every key, fence, fill the reader tier), then replay a
     6000-request diurnal Zipf stream with a 16-key republish storm every
     256 served requests through ``BatchedKVLease`` and
     ``runtime.scheduler.replay`` — once on the card and once on the CPU
     with the same deterministic service model, which must agree on every
     served result, the grant log, all counters, every key's ``memts`` and
     the whole fabric state; the kernels' launch counts of the card run
     must all be > 0, ``write_grant``'s equal to the write and fence
     passes' rounds (one launch a round); ``lease_probe``'s launches by
     call site and ``miss_round``'s by lane count are logged; then a
     closed-loop and an
     open-loop replay on the card with the wall clock (requests/s,
     p50/p99);
  4. the LLM serving path at full width: ``runtime.server.Server`` with
     smollm-360m (32 layers, d_model 960, vocab 49152, seeded weights on
     the card), batch 8, 512-token prompts, 64 new tokens, four waves of
     8 requests whose group prompt repeats, so waves 2-4 are served from
     live leases; the float kernels' launch counts of this run must all
     be > 0, a prefix payload must be unchanged after decoding from it,
     ``serve_stream`` must equal sequential ``serve``, the card's lease
     and fabric counters and grant log must equal a CPU server's on the
     same stream (1 layer deep: the fabric sees only keys; it runs in a
     worker process beside the card's later checks), and at 4
     layers the card's final hidden state and first-token logits must
     equal the port on the CPU within a relative L2 of 2e-2; then
     prefill and decode times, generated tokens/s and host time per
     decode step;
  5. the SSM serving path at full width: ``Server`` with mamba2-130m (24
     layers, d_model 768, seeded weights on the card, bf16) on phase 4's
     stream (batch 8, 512-token prompts, 64 new tokens, four waves) with
     phase 4's checks (``ssd_chunk`` and ``rmsnorm`` launched, payload
     unchanged, ``serve_stream`` == ``serve``, counters and grant log ==
     a 1-layer CPU server, card == CPU model at 4 layers within a
     relative L2 of 2e-2) and timings; then zamba2-1.2b (38 layers,
     d_model 2048: five SSM layers and the shared attention block, six
     times, then two SSM layers) for two waves of 16 new tokens (miss,
     then hit), payload unchanged, card == CPU model at 6 layers (the
     first depth with a shared-attention layer), and its timings.  Both
     must run every ``ssd_chunk`` on the tensor-core route; both report
     its device time in a prefill and the card-vs-CPU relative L2 after
     each layer of the checked model, with the card's ``ssd_chunk`` on
     the tensor-core kernel (with cuBLAS's reduced-precision bf16
     reductions allowed, PyTorch's default, and refused), on the
     CUDA-core kernels, and on those with y rounded to bf16 before the
     inter-chunk part (the earlier arithmetic); then the second SSM
     block split into its steps, each step's card-vs-CPU error from the
     same input and chained from the same block input; and both bf16
     models, card and CPU, against the same model in f32 on the CPU,
     after each layer (F2);
  6. the figure engine (``core.engine``) at the figure drivers' settings:
     Fig. 7's 5 systems x 11 benchmarks at 4 GPUs x 32 CUs (``pcie_lat``
     1000, 1024 of the driver's 2048 rounds) in one ``sweep`` on the card,
     Fig. 8's 16-GPU point (11 x 512 lanes, 256 rounds) and Fig. 9's
     Xtreme suite (9 traces at half the driver's repetitions, HALCONE and
     SM-WT-NC, one ``sweep`` as ``fig9_xtreme.py`` runs it), each equal
     to the port on the CPU
     (counters equal, cycles within rtol 1e-6); ``simulate`` on the card
     of Xtreme 1 at 192 KB and Fig. 5's litmus traces, the whole state
     and the logs equal to the CPU's and the read logs
     ``tests/test_protocol_litmus.py`` asserts; ``lease_probe`` launched
     twice a round per static group (three times under HMG); each group's
     loop run under ``set_sync_debug_mode("error")``; the Fig. 7 cycles
     and geomean speedups over RDMA-WB-NC beside the paper's (simulated
     cycles of the modelled system), seconds, round steps and cell-rounds
     per second, and one group under ``torch.profiler``;
  7. the sharded fabric: phase 3's warm and trace through
     ``BatchedKVLease`` on ``ShardedArrayFabric`` over a fabric group,
     in a world of one over NCCL and a world of two ranks sharing the
     card over gloo with CUDA tensors, the two worlds at once
     (``--fabric-rank`` starts a rank), each rank equal to phase 3's CPU replay bit for bit (results, grant
     log, counters, replica counters, every key's ``memts``, the whole
     state) and to the port's ``HostFabric`` on the same trace; each
     rank's ``c10d`` collectives by pass (``obs.xprof``: 1 a TSU-touching
     pass, 0 an all-hit read batch), its TSU rows, the coherence kernels'
     launches, bytes gathered a wave, capacity, the host time of the
     exchange a pass, and under ``torch.profiler`` the idle share and the
     all-gather's host and device time;
  8. the training path at full width: ``runtime.trainer.Trainer`` with
     smollm-360m (seeded f32 master weights and moments, bf16 compute,
     remat) on the card, 8 steps of 8 x 512 tokens, a checkpoint every
     3 steps published on the fabric, a simulated failure at step 7 and
     a resume: the resumed steps equal the first run's losses bit for
     bit, the losses are finite and fall, ``rmsnorm``,
     ``flash_attention``, their backward kernels and ``lease_probe`` (the
     publish's op scan) launched, every flash backward on the
     tensor-core route from a forward's row statistics, and the events
     (but the wall-clock straggler events, each held to the watchdog's
     rule instead), fabric counters and grant log equal a 2-layer CPU
     trainer's (run in a worker process beside the card's); the
     card's loss and gradients at 2 layers equal the CPU's within a
     relative L2 of 2e-2; ``VmappedWorkers`` at
     4 layers (W = 1 equal workers, W = 4 at least 3x fewer collective
     bytes); a step's wall, host enqueue and device time, tokens/s, idle
     share, the backward kernels' share, the model-flops share and a
     checkpoint save's time.  Then mamba2-130m at full width (24 layers,
     d_model 768; 8 steps, a checkpoint every 3, a failure at 7) and
     zamba2-1.2b (19 of its 38 layers,
     d_model 2048) on a shorter one (6 steps, a checkpoint every 4, a
     failure at 5; its checkpoint is 6.1 GB), B = 8 x S = 512: the same
     checks with ``ssd_chunk``
     and ``ssd_chunk_bwd`` launched (zamba2: flash too), every
     ``ssd_chunk_bwd`` on the tensor-core route; the fabric
     against a CPU trainer of 2 layers at the smoke widths (zamba2: all 19
     layers, its looped tail has a fabric key a layer); card vs CPU
     gradients at 2 layers (zamba2: 6, the first depth with the shared
     attention block) under the f32 policy within 2e-2, and in bf16
     (mamba2 within 2e-2; each bf16 gradient's distance from the CPU's
     f32 one, the card's at most 1.25x the CPU's); a step's times,
     ``ssd_chunk_bwd``'s share of device time and peak memory.  Phase 2
     also holds the backward kernels against autograd of the plain
     versions (at the training shapes and odd ones, each flash row on its
     route, beside the library's backward and, at the bf16 training
     shape, the CUDA-core kernel of the first round; ``ssd_chunk_bwd`` at
     both SSM training shapes, B/C a stride-0 head or one per head, and
     odd ones, on every route that takes the shape, the routed kernel's
     time beside the CUDA-core kernel's and the plain backward's); phases
     4 and 5 assert that no prefill wrote the backward's row statistics
     and no backward kernel ran;
  9. windowed attention and the modality frontends at full width:
     ``Server`` with gemma3-4b (34 layers, d_model 2560, 8 over 4 heads
     of 256, vocab 262144, window 1024 on five layers of six; seeded
     weights on the card), batch 4, 1536-token prompts (past the window),
     16 new tokens, two waves (a miss, then a lease hit), with phase 4's
     checks (every flash on the tensor-core route at D = 256, decode at
     D = 256 one kernel a call, payload unchanged, ``serve_stream`` ==
     ``serve``, counters and grant log == a 1-layer CPU server) and the
     card == CPU at 6 layers (the first global layer) on one prompt,
     within a relative L2 of 2e-2 for the final hidden state, the
     first-token logits and 8 decode steps' hidden states; its times and
     flash's and decode's device time.  Then hubert-xlarge (48 layers, 16
     heads of 80, non-causal): ``prefill`` of 8 x 512 frames, every flash
     on the tensor-core route at D = 80, card == CPU at 4 layers (batch 2);
     and llava-next-34b at 4 of its 60 layers (34 B parameters do not
     fit one card), full width: ``prefill`` of 576 patch embeddings and
     64 tokens at batch 2 on the tensor-core route, 15 decode steps (7
     query heads a kv head), card == CPU at 2 layers (batch 1); each
     model's launch counts set to 0 just before its run and read just
     after;
 10. MoE and MLA at full width: ``Server`` with deepseek-v2-236b at 4 of
     its 60 layers (236 B parameters do not fit one card: the dense layer
     0, then 3 MoE layers of 160 routed experts, top-6, and 2 shared;
     MLA, whose prefill takes flash at q and k of 192 columns and v of
     128 on the tensor cores, and whose absorbed decode is einsums over
     the latent cache) and llama4-maverick-400b-a17b at 2 of 48 (one
     dense and one MoE layer of 128 experts, top-1, and 1 shared), each
     built on the card from seeded weights in its own bf16-param policy
     and freed before the next: batch 2, 512-token prompts, 32 (llama4:
     16) new tokens, two waves (a miss, then a lease hit), with phase
     4's checks (launch counts, every flash on the tensor-core route,
     the profiled deepseek prefill's flash the (192, 128) instantiation,
     payload unchanged); every MoE layer against its token-by-token
     evaluation in f32 on the card (``moe_by_token``: each kept choice
     through its expert times its gate, plus the shared experts; routed
     and dropped choices logged); card vs CPU at 2 layers (deepseek: the
     dense and the first MoE layer, one prompt and 4 decode steps) and 1
     (llama4's dense layer 0) within a relative L2 of 2e-2, tokens whose
     experts split at a near-tie left out; times and peak memory;
 11. training at the head dims 80 and 256 and at MLA's (192, 128):
     hubert-xlarge (24 of 48 layers, 16 heads of 80, non-causal) on 8 x 512
     frames with labels, gemma3-4b at 12 of 34 layers on B = 4 x S =
     1536, past its 1024-token window (f32 masters, bf16 compute), and
     deepseek-v2-236b at 2 of 60 layers (the dense layer and one MoE
     layer of 160 experts, 5.36 B parameters) on B = 2 x S = 512 in its
     own bf16-param, bf16-moment policy; full width and remat, each
     through its ``Trainer``'s step (which updates its state in place,
     the memory plan deepseek's state needs) for 6 steps on fresh
     batches: losses finite, below the untrained model's on their batch
     and falling (deepseek's, whose batches differ by more than a step
     moves it: the last below the first, and the fall against the
     untrained model larger in the last 3 steps than the first 3), the
     first 2 steps equal bit for bit to a run of them from the same
     state, a MoE model's aux > 0, every flash backward on the
     tensor-core route from a forward's row statistics (launch counts set
     to 0 just before the run and read just after; deepseek's at (192,
     128)); card vs CPU loss
     and gradients at 2, 6 and 2 layers (a CPU worker beside the card;
     deepseek's after the others', as it holds ~64 GB of the host's
     memory), bf16 and f32 policy (the f32 one on the CUDA-core route)
     within a relative L2 of 2e-2 (deepseek's experts whose routing split
     at a near-tie logged and left out of the per-leaf check); a step's
     wall, host and device ms, idle share, the backward kernels' share
     and peak memory.  Phase 2 holds the backward at the three training
     shapes on both routes against autograd of the plain version, beside
     SDPA's backward;
 12. expert parallelism (run inside phase 11, once its card work is done
     and while its last CPU check's worker, deepseek's, runs on): two
     ranks sharing the card over gloo with CUDA
     tensors (``--model-rank`` starts one) form a (1, 2) mesh
     (``launch.mesh.make_model_mesh``) and serve deepseek-v2-236b at
     full width and 2 of 60 layers (the dense layer 0 and one MoE layer
     of 160 experts, 80 a rank, MLA; each rank's shards built leaf by
     leaf from the seeded global weights): a prefill of 2 x 512 tokens
     through ``make_prefill_step`` (the expert-parallel route: two
     ``all_to_all`` and one all-gather along the sequence a MoE layer,
     no expert weight gathered) and 8 ``make_decode_step`` steps (the
     global route: one all-gather of the expert rows), every MoE call
     against ``moe_by_token`` in f32 (per-rank capacity for the prefill,
     global for the decode steps; every expert drawn whole from the
     seed), both ranks' ids equal, the kernels'
     launches (counts zeroed just before, read just after) and the
     collectives by kind; prefill and decode wall and device ms, the
     all-to-all's host and device ms, peak memory; at capacity factor 8
     the mesh prefill's final hidden state against rank 0's one-device
     prefill of the seeded global weights (relative L2 2e-2, ids equal
     outside near-ties).  Then the
     mesh train step at the deepseek-v2 (MLA's own head dims) and llama4
     smoke configs on (1, 2) and (2, 1) meshes, 3 steps on CUDA tensors
     and on CPU tensors in the same ranks: loss and gradients card vs CPU
     within 2e-2, replicated leaves equal bit for bit across the ranks,
     ``flash_attention_bwd`` and ``rmsnorm_bwd`` launched;
 13. the kernel summary line (with rows for the head dims phase 9 adds,
     the shapes phase 10 adds and phase 11's backward), then
     ``{"ok": true, "device": ...}`` last.  Each phase's start time is
     printed as ``[N s]``.

``--profile`` adds one closed-loop replay under ``torch.profiler`` after
phase 3: the device's busy and idle share of the wall clock, device time
by kernel and the host's top operators (in ``chip_smoke.json``).  Phase
4 always profiles two prefills and eight decode steps the same way; the
tables go to ``chip_smoke.json``; phase 5 does the same for mamba2.

It needs a CUDA card, and the repository's ``src/`` beside it.  Details go
to ``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import collections
import concurrent.futures
import contextlib
import functools
import gc
import json
import multiprocessing
import os
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12     # H100 SXM HBM3 (NVIDIA data sheet)
# compare/select ops are int32 and run outside the tensor cores; the table
# of peaks lists 67 TFLOP/s for float32 there, used as the (generous)
# operation rate, so the operation bound never overstates the least time
OPS_PER_S = 67e12
N_KEYS = 8192
N_REQUESTS = 6000
MAX_BATCH = 64
REPUBLISH_EVERY = 4 * MAX_BATCH
REPUBLISH_N = 16
WARM_CHUNK = MAX_BATCH
# phase 7: the sharded fabric, (backend, ranks) per world; the two ranks
# share the one card over gloo with CUDA tensors (NCCL refuses two ranks
# on one device)
FABRIC_WORLDS = (("nccl", 1), ("gloo", 2))
FABRIC_RANK_TIMEOUT_S = 300
# the profiled closed-loop replay of phase 7 takes the trace's first
# requests: the profiler's own cost grows with the events it records
# (64 since phase 11 joined the script; 128 since phase 10 did, 256 and
# 512 before)
FABRIC_PROFILE_REQUESTS = 64
# tensor-core peak in bf16 (data sheet, dense); f32 math runs on the
# CUDA cores at the 67 TFLOP/s above
BF16_FLOPS_PER_S = 989e12
KERNELS = (("lease_probe", "src/repro_torch/kernels/csrc/lease_probe.cu",
            "src/repro/kernels/lease_probe.py:81"),
           ("miss_round", "src/repro_torch/kernels/csrc/tier_pass.cu",
            "src/repro/kernels/tier_pass.py:204"),
           ("write_grant", "src/repro_torch/kernels/csrc/tier_pass.cu",
            "src/repro/kernels/tier_pass.py:241"),
           ("rmsnorm", "src/repro_torch/kernels/csrc/rmsnorm.cu",
            "src/repro/kernels/rmsnorm.py:31"),
           ("flash_attention",
            "src/repro_torch/kernels/csrc/flash_attention_wgmma.cu",
            "src/repro/kernels/flash_attention.py:79"),
           ("decode_attention",
            "src/repro_torch/kernels/csrc/decode_attention.cu",
            "src/repro/kernels/decode_attention.py:63"),
           ("ssd_chunk", "src/repro_torch/kernels/csrc/ssd_chunk_wgmma.cu",
            "src/repro/kernels/ssd_chunk.py:45"),
           # the backward kernels of the two float kernels training runs
           # (the reference differentiates jnp layers and has no backward
           # Pallas kernel; each row names the forward it differentiates)
           ("rmsnorm_bwd", "src/repro_torch/kernels/csrc/rmsnorm_bwd.cu",
            "src/repro/kernels/rmsnorm.py:31"),
           ("flash_attention_bwd",
            "src/repro_torch/kernels/csrc/flash_attention_bwd_wgmma.cu",
            "src/repro/kernels/flash_attention.py:79"),
           ("ssd_chunk_bwd",
            "src/repro_torch/kernels/csrc/ssd_chunk_bwd_wgmma.cu",
            "src/repro/kernels/ssd_chunk.py:45"))
# phase 4: the LLM serving path
ARCH = "smollm-360m"
SERVE_B, PROMPT_LEN, MAX_NEW = 8, 512, 64
MAX_LEN = PROMPT_LEN + MAX_NEW + 8
N_WAVES = 4
# depth (and batch) cut on the CPU side only, to keep the run short
CPU_FABRIC_LAYERS = 1        # the CPU server that checks the fabric
CPU_MODEL_LAYERS = 4         # card vs CPU model comparison, full width
SERVE_CPU_THREADS = 4        # that CPU server's threads, beside the card
CPU_MODEL_BATCH = 2
WEIGHT_SEED = 0
# kernel vs plain version: f32 is the same math summed in another order;
# bf16 rounds the f32 result once on both sides (2^-8 relative steps)
FLOAT_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
MODEL_REL_L2 = 2e-2          # card vs CPU model in bf16
# mamba2's gap is about half that (0.0100-0.0104 measured); held at 0.011
# so that a change which widens it shows
MODEL_REL_L2_BY_ARCH = {"mamba2-130m": 0.011}
# phase 5: the SSM serving path; zamba2 runs shorter traffic to hold the
# run's time, and its CPU model check needs 6 layers to reach the first
# shared-attention layer (index 5)
SSM_ARCH, HYBRID_ARCH = "mamba2-130m", "zamba2-1.2b"
HYBRID_WAVES, HYBRID_MAX_NEW, HYBRID_MODEL_LAYERS = 2, 16, 6
# the cache length zamba2's traffic needs: phase 2 times decode there
HYBRID_MAX_LEN = PROMPT_LEN + HYBRID_MAX_NEW + 8
# phase 8: training smollm-360m at full width on the card: batch, sequence,
# steps, checkpoint period and the step of the simulated failure (8 steps
# since the SSM models joined the phase, to hold the script's time); the CPU
# trainer that checks the fabric runs 2 layers on short rows at the smoke
# widths (the fabric sees only the parameter keys, the same at every depth
# and width), the
# card-vs-CPU gradient check 2 layers on one 512-token row, the lease
# workers 4 layers
TRAIN_B, TRAIN_S, TRAIN_STEPS, TRAIN_CKPT, TRAIN_FAIL = 8, 512, 8, 3, 7
TRAIN_CPU_LAYERS, TRAIN_CPU_B, TRAIN_CPU_S = 2, 2, 64
TRAIN_WORKER_LAYERS, TRAIN_WORKER_STEPS = 4, 8
TRAIN_LR, TRAIN_WARMUP = 1e-3, 2
# then the SSM models: (arch, steps, checkpoint period, failure step, layers
# of the card-vs-CPU gradient check); zamba2 on a shorter schedule (its
# checkpoint is 12.2 GB), checked at 6 layers, the first depth that
# reaches the shared attention block
SSM_TRAIN = (("mamba2-130m", 8, 3, 7, 2), ("zamba2-1.2b", 6, 4, 5, 6))
# phase 8's depth cuts, full width kept: zamba2 at 19 of its 38 layers
# (three shared-attention uses of six, a 6.1 GB checkpoint) since
# deepseek-v2 joined phase 11, to hold the script's time (38 layers: 115-130
# s of the phase, two 12.2 GB checkpoints and a restore)
PHASE8_LAYERS = {"zamba2-1.2b": 19}
# card vs CPU gradients: the loss, the whole gradient and each leaf of at
# least this many values within MODEL_REL_L2; the per-head vectors of the
# SSM blocks (A_log, D_skip, dt_bias) are sums of cancelling terms whose
# bf16 error is relative to the terms, so they are printed, and held by the
# whole gradient (as tests/test_torch_train.py holds them)
PER_LEAF_MIN = 64
# zamba2's bf16 gradient at 6 layers is 0.13 (relative L2) from its f32
# policy's in both packages (CPU, one 512-token row: the port 0.1297, the
# reference 0.1282), so two bf16 runs need not agree within MODEL_REL_L2
# there: its card-vs-CPU gradient check runs under the f32 policy, and the
# card's bf16 gradient may be no further from the CPU's f32 one than
# BF16_FROM_F32 times the CPU's bf16 gradient (both SSM models are held to
# these; smollm and mamba2 also to MODEL_REL_L2 in bf16)
BF16_GRAD_ARCHS = ("smollm-360m", "mamba2-130m")
BF16_FROM_F32 = 1.25
# backward kernel vs autograd of the plain version: f32 sums over up to
# 4096 rows (or every query of a key) in another order; bf16 rounds once
GRAD_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
# ssd_chunk_bwd's ddt and dA (f32 for both input dtypes): an element near
# zero is a difference of terms ~1000x larger (a reverse cumsum of
# cancelling terms), on which the f32 plain version itself is more than
# 1e-4 of 1 + |g| off an f64 gradient at mamba2's widths
# (tests/test_torch_ssd_bwd.py::test_f32_ddt_cancels_against_f64); each
# is held to rtol = 1e-4 and 1e-4 of its output's largest magnitude
SSD_BWD_SCALED = ("ddt", "dA")
SSD_BWD_SCALED_TOL = 1e-4
# phase 9: windowed attention and the modality frontends at full width.
# gemma3-4b (34 layers, all of them): batch 4, prompts of 1536 tokens,
# past the 1024-token window, so the local layers' prefill mask is live
# and decode's kv_len passes 1024; two waves (a miss, then a lease hit) of
# 16 new tokens (32 before deepseek-v2 joined phase 11: the 1-layer CPU
# server beside, at the 262144-wide vocabulary, took 56.6 s); card vs CPU
# at 6 layers (the first depth with a global layer, index 5) on one
# prompt, and 8 decode steps' hidden states
WINDOW_ARCH = "gemma3-4b"
WINDOW_B, WINDOW_PROMPT, WINDOW_NEW, WINDOW_WAVES = 4, 1536, 16, 2
WINDOW_MAX_LEN = WINDOW_PROMPT + WINDOW_NEW + 8
WINDOW_MODEL_LAYERS, WINDOW_DECODE_CHECK = 6, 8
# hubert-xlarge (48 layers, all of them): the encoder on 8 x 512 frames;
# card vs CPU at 4 layers, batch 2 (the CPU side cut)
AUDIO_ARCH = "hubert-xlarge"
AUDIO_B, AUDIO_FRAMES, AUDIO_MODEL_LAYERS, AUDIO_CPU_B = 8, 512, 4, 2
# llava-next-34b: 60 layers are 34 B parameters (137 GB in f32), past one
# card: depth cut to 4, full width; 576 patch embeddings + 64 text tokens
# at batch 2, then 16 decode steps; card vs CPU at 2 layers, batch 1
VISION_ARCH = "llava-next-34b"
VISION_LAYERS, VISION_B, VISION_TEXT, VISION_NEW = 4, 2, 64, 16
VISION_MODEL_LAYERS, VISION_CPU_B = 2, 1
# phase 2's rows at phase 9's shapes: (B, S, Hq, Hkv, D, causal, window)
# and (B, Sk, Hq, Hkv, D, kv_len)
PHASE9_FLASH = ((WINDOW_B, WINDOW_PROMPT, 8, 4, 256, True, 1024),
                (WINDOW_B, WINDOW_PROMPT, 8, 4, 256, True, 0),
                (AUDIO_B, AUDIO_FRAMES, 16, 16, 80, False, 0),
                (VISION_B, 576 + VISION_TEXT, 56, 8, 128, True, 0))
PHASE9_DECODE = ((WINDOW_B, WINDOW_MAX_LEN, 8, 4, 256,
                  WINDOW_PROMPT + WINDOW_NEW),
                 (VISION_B, 576 + VISION_TEXT + VISION_NEW + 8, 56, 8, 128,
                  576 + VISION_TEXT + 1))
# phase 10: MoE and MLA at full width, each model built on the card from
# seeded weights in its own policy (bf16 params) and freed before the next.
# deepseek-v2-236b: 60 layers are 236 B parameters, past one card: depth
# cut to 4 (the dense layer 0, then 3 MoE layers, a stacked segment; 13.3 B
# parameters, 26.6 GB); batch 2, 512-token prompts, 32 new tokens, two
# waves; card vs CPU at 2 layers (the dense layer and the first MoE layer)
# on one prompt plus 4 decode steps.  llama4-maverick-400b-a17b: depth cut
# to 2 of 48 (one dense and one MoE layer, the pattern's period; 18.6 B
# parameters, 37.1 GB: four layers would be 70.1 GB); 16 new tokens; card
# vs CPU at its dense layer 0.  (arch, layers, new tokens, CPU-check
# layers, decode steps checked)
MLA_ARCH, MOE_ARCH = "deepseek-v2-236b", "llama4-maverick-400b-a17b"
PHASE10 = ((MLA_ARCH, 4, 32, 2, 4), (MOE_ARCH, 2, 16, 1, 0))
PHASE10_B, PHASE10_PROMPT, PHASE10_WAVES = 2, 512, 2
# phase 2's rows at phase 10's shapes: flash (B, S, Hq, Hkv, D, Dv, causal)
# at deepseek's MLA prefill and llama4's, decode (B, Sk, Hq, Hkv, D,
# kv_len) at llama4's first and last step
PHASE10_FLASH = ((PHASE10_B, PHASE10_PROMPT, 128, 128, 192, 128, True),
                 (PHASE10_B, PHASE10_PROMPT, 40, 8, 128, 128, True))
PHASE10_DECODE = tuple((PHASE10_B, PHASE10_PROMPT + 16 + 8, 40, 8, 128,
                        kv_len) for kv_len in (PHASE10_PROMPT + 1,
                                               PHASE10_PROMPT + 16))
# a MoE routing split between the card and the CPU (their bf16 roundings
# upstream differ, by up to ~1% of the hidden state, so the router logits
# by a few bf16 steps) must sit at a near-tie of the CPU's gates: its k-th
# and (k+1)-th within this relative gap, four bf16 steps of a router logit
# at 2-4 (2^-6 each; deepseek's splits sat 0, 1 and 2 steps apart); such
# tokens are left out of the card-vs-CPU comparison, at most one in eight
NEAR_TIE = 2 ** -4
# phase 11: training at the head dims 80 and 256 and MLA's (192, 128) on
# the card, each model at full width in its own policy with remat, through
# Trainer.step_fn (the step Trainer.run takes; its checkpoint publish is
# phase 8's, and a gemma3 checkpoint would be 12 bytes a parameter on
# disk).  hubert-xlarge: 24 of 48 layers (all 48 before deepseek-v2
# joined; its host-bound step, 0.66-0.83 s, set the row's time), 8 x 512
# frames with labels.
# gemma3-4b: B = 4 x S = 1536, past the 1024-token window; depth cut to 12
# of 34 layers, whole local:global groups (cut when the update was out of
# place: 18 ran out of memory in AdamW's update, 71.86 GB allocated; the
# step now updates its state in place).  deepseek-v2-236b:
# bf16 params and moments, B = 2 x S = 512, 2 of 60 layers (the dense
# layer 0 and one MoE layer of 160 experts: 5.36 B parameters, 8 bytes a
# parameter with its gradient, 42.9 GB; 3 layers would be 9.33 B, 74.6
# GB before any activation or temporary).  Card vs CPU at 2 layers
# (hubert, a row of 512 frames; deepseek, all of its 2, a row of 128
# tokens) and 6 (gemma3, the first global layer; a row of 128 tokens: the
# worker took 36 s in bf16 at 256, where the 262144-wide tied embedding
# dominates), under the bf16 and the f32 policy; the CPU side runs in a
# worker process beside the card's.  The window's backward mask is held
# at the run's 1536 tokens by phase 2's row at gemma3's training shape.
# (arch, layers, B, S, CPU-check layers, CPU-check tokens)
WIDE_TRAIN = (("hubert-xlarge", 24, 8, 512, 2, 512),
              ("gemma3-4b", 12, 4, 1536, 6, 128),
              ("deepseek-v2-236b", 2, 2, 512, 2, 128))
# the CPU worker's threads, beside the card's host-bound steps (hubert's)
PHASE11_CPU_THREADS = 4
WIDE_TRAIN_STEPS = 6
# steps run twice from the same seeded state, to match bit for bit
REPEAT_STEPS = 2
# rows whose fall is read against the untrained model on the same batch:
# at deepseek-v2's B = 2 x S = 512 the untrained model's losses on six
# fresh batches spread 12.47-12.74, more than a step at WIDE_TRAIN_LR moves
# it (step 1's loss was above step 0's, on another batch), so its row
# needs, beside each loss below the untrained model's on its batch, the
# last loss below the first and the gap to the untrained model (the
# fall on each batch) larger over the last half of the steps than over
# the first half; the other rows fall at every step
WIDE_TRAIN_FALL_BY_GAP = ("deepseek-v2-236b",)
# phase 11's peak learning rate (warmup TRAIN_WARMUP): Adam's first steps
# move every weight by about the rate, and at full width phase 8's 1e-3
# overshoots (the loss rises above the untrained model's at some steps,
# as at 3e-4 and 1e-4; scripts/wide_train_lr_sweep.py); at 1e-5 both
# models' losses fall at every step
WIDE_TRAIN_LR = 1e-5
# phase 2's backward rows at phase 11's shapes (B, S, Hq, Hkv, D, Dv,
# causal, window): hubert-xlarge, gemma3-4b past its window, deepseek-v2's
# MLA pair
PHASE11_FLASH_BWD = ((8, 512, 16, 16, 80, 80, False, 0),
                     (4, 1536, 8, 4, 256, 256, True, 1024),
                     (2, 512, 128, 128, 192, 128, True, 0))
# phase 12: expert parallelism.  deepseek-v2-236b at full width, 2 of 60
# layers (the dense layer 0, then one MoE layer of 160 routed experts,
# top-6, 2 shared, MLA) in its bf16-param policy, on a (1, 2) mesh of two
# ranks sharing the card over gloo with CUDA tensors (NCCL refuses two
# ranks on one device): 80 experts a rank, each rank's shard built leaf by
# leaf from the seeded global weights (1.58 B replicated and 1.89 B
# expert-shard parameters, ~7 GB a rank).  A prefill of B = 2 x 512
# tokens (the expert-parallel route), then 8 decode steps (S = 1: the
# global route); at capacity factor 8 (nothing dropped) the mesh
# prefill's final hidden state against rank 0's one-device prefill.  Then
# the mesh train step at the deepseek-v2 (MLA's own head dims) and llama4
# smoke configs on (1, 2) and (2, 1) meshes, B = 4 x S = 64, 3 steps, on
# CUDA tensors and on CPU tensors in the same ranks, within 2e-2.  Full
# width training needs ~28 GB of params, moments and gradients a rank
# before activations: not two ranks on one card (ROADMAP item 25).
EP_ARCH = "deepseek-v2-236b"
EP_LAYERS = 2
EP_MESH = (1, 2)
EP_B, EP_PROMPT, EP_DECODE = 2, 512, 8
EP_TIMED = 3                 # timed prefills and decode steps a rank
EP_EQUAL_CF = 8.0
EP_SEED = 12
EP_TRAIN_ARCHS = ("deepseek-v2-236b", "llama4-maverick-400b-a17b")
EP_TRAIN_MESHES = ((1, 2), (2, 1))
EP_TRAIN_B, EP_TRAIN_S, EP_TRAIN_STEPS = 4, 64, 3
EP_TRAIN_TOL = 2e-2
EP_RANK_TIMEOUT_S = 400
# ssd_chunk vs its plain version: dt = 0.1 softplus(normal) and
# A = -exp(U(0, 1.5)), so cum falls to about -50 over a chunk of 256 on an
# average head (to -100 on the steepest)
SSD_DT_SCALE = 0.1


def log(*a) -> None:
    print(*a, flush=True)


# rmsnorm's rows: decode (R = 8) and prefill (R = 4096) at the widths
# the serving path normalises (smollm 960, mamba2 768 and its d_inner
# 1536, zamba2 2048 and its d_inner 4096; deepseek-v2's kv_ln 512, q_ln
# 1536 and its and llama4's d_model 5120), then an odd one
RMSNORM_SHAPES = tuple((R, D) for R in (SERVE_B, SERVE_B * PROMPT_LEN)
                       for D in (512, 768, 960, 1536, 2048, 4096, 5120)
                       ) + ((7, 80),)


# ------------------------------------------------------------------ timing
def device_ms(torch, fn, n=20, trials=5) -> float:
    """Median CUDA-event time of one call of ``fn``: a sleep kernel holds
    the stream while the host enqueues ``n`` calls, so the events time
    the calls back to back on the device, not the host's launch rate.
    The sleep lasts twice the host's measured time to enqueue ``n``
    calls, at least 10^7 cycles (a fixed 2 x 10^8 cycles held the card
    ~0.1 s a trial, whatever the call)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    enqueue_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    # cycles at 2 GHz, above the H100's boost clock, so at any clock the
    # sleep outlasts twice the enqueue
    cycles = int(max(1e7, 2 * enqueue_s * 2e9))
    out = []
    for _ in range(trials):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        s.record()
        for _ in range(n):
            fn()
        e.record()
        torch.cuda.synchronize()
        out.append(s.elapsed_time(e) / n)
    return statistics.median(out)


# ------------------------------------------------------- kernel inputs
def _first(tags, addr):
    """Per lane: index of the first matching way, or -1."""
    import numpy as np
    eq = tags == addr[:, None]
    return np.where(eq.any(1), eq.argmax(1), -1)


def probe_case(rng, K, N, W):
    """lease_probe at the fast read's shape: two replicas' ``[2, K, W+1]``
    tag and rts tables (every set WITH its trash way: the kernel reads
    replica 1's ``[:, :-1]`` view in place), duplicate tags, empty sets,
    each lane's set ``row`` (lanes share sets), hits on about half,
    clocks within a lease of ``TS_MAX``, one clock per replica."""
    import numpy as np
    tag = rng.integers(-1, 4 * W, (2, K, W + 1)).astype(np.int32)
    tag[:, ::3, 1 % W] = tag[:, ::3, 0]            # duplicate tags
    tag[:, 1::5] = -1                              # empty sets
    rts = rng.integers(65500, 65535, (2, K, W + 1)).astype(np.int32)
    row = rng.integers(0, K, N).astype(np.int32)
    addr = rng.integers(0, 4 * W, N).astype(np.int32)
    hit = rng.random(N) < 0.5
    addr[hit] = tag[1, row[hit], rng.integers(0, W, N)[hit]]
    addr[addr == -1] = 4 * W
    cts = rng.integers(65500, 65535, 2).astype(np.int32)
    return tag, rts, row, cts, addr


def _scanned(tags, addr):
    """Ways read up to each lane's first match (all of them on a miss) in
    ``[N, W]`` rows, and the number of lanes that match."""
    f = _first(tags, addr)
    return int((f + 1).sum() + (f < 0).sum() * tags.shape[1]), \
        int((f >= 0).sum())


def probe_bound(tags, addr, lane_words=0):
    """The indexed form: per lane its set's tags up to the first match,
    the rts of a hit, its address and row and the outputs (5 int32 + 2
    bool), and the one clock (``lane_words`` more int32 a lane where each
    lane has its own clock and grant); operations, the compares and 8 a
    lane."""
    N = len(addr)
    scanned, hits = _scanned(tags, addr)
    return (4 * scanned + 4 * hits + (30 + 4 * lane_words) * N + 4,
            scanned + 8 * N)


def engine_probe_case(rng, tier, N, W):
    """lease_probe as the figure engine's round calls it, N = E*NC lanes of
    E cells of 4 GPUs: ``tier`` "l1", each lane on its own CU's 64 sets of
    an ``[N*64, W+1]`` table; "l2", a GPU's CUs sharing their bank's 256
    sets of an ``[E*32*256, W+1]`` table (8 banks a GPU).  Every lane
    has its own clock and its TSU grant; hits on about half, clocks and
    grants near ``TS_MAX``.  Returns the tables, rows and the lanes'
    vectors."""
    import numpy as np
    if tier == "l1":
        K, row = N * 64, np.arange(N) * 64 + rng.integers(0, 64, N)
    else:
        cus = 32
        K = N // cus * 8 * 256
        bank = np.arange(N) // cus * 8 + rng.integers(0, 8, N)
        row = bank * 256 + rng.integers(0, 256, N)
    tag = rng.integers(-1, 1 << 20, (K, W + 1)).astype(np.int32)
    tag[rng.random(K) < 0.2] = -1                  # empty sets
    rts = rng.integers(65500, 65535, (K, W + 1)).astype(np.int32)
    addr = rng.integers(0, 1 << 20, N).astype(np.int32)
    hit = rng.random(N) < 0.5
    addr[hit] = tag[row[hit], rng.integers(0, W, N)[hit]]
    addr[addr == -1] = 1 << 20
    cts = rng.integers(65500, 65535, N).astype(np.int32)
    mwts = rng.integers(65500, 65535, N).astype(np.int32)
    mrts = (mwts + rng.integers(1, 9, N)).astype(np.int32)
    return tag, rts, row.astype(np.int32), cts, addr, mwts, mrts


def miss_case(rng, M, C, K1=1024, K2=2048, KT=8, W=8, match_at=None):
    """miss_round at the miss pass's shape: two replicas' ``[2, K1, W+1]``
    tag and rts sets, two nodes' ``[2, K2, W+1]`` tag, rts and wts sets,
    the TSU's ``[KT, 1, C+1]`` tag and memts (the kernel reads replica and
    node 1's ``[:, :-1]`` views and the TSU's ``[:, 0, :-1]`` in place),
    one clock per replica and node, and M lanes naming their rows: a
    quarter inactive on shard 0, as the pass pads; TSU row 1 empty, row 0
    with duplicate tags; hits on about half (at way ``match_at`` and
    nowhere else if given), some also in the replica or shared set; TSU
    clocks within rd = 8 of ``TS_MAX``."""
    import numpy as np
    r = lambda lo, hi, shp: rng.integers(lo, hi, shp).astype(np.int32)
    rp_tag, sh_tag = r(-1, 8 * C, (2, K1, W + 1)), r(-1, 8 * C, (2, K2, W + 1))
    ts_tag = r(0, 8 * C, (KT, 1, C + 1))
    ts_tag[:, 0, 3::7] = -1                        # partly full rows
    ts_tag[0, 0, 1:C:2] = ts_tag[0, 0, 0:C - 1:2]  # duplicate tags
    ts_tag[1] = -1                                 # an empty row
    s1, s2, shard = r(0, K1, M), r(0, K2, M), r(0, KT, M)
    act = rng.random(M) < 0.75
    shard[~act] = 0
    addr = r(0, 8 * C, M)
    hit = (rng.random(M) < 0.5) & (shard != 1)
    way = np.full(M, match_at) if match_at is not None else \
        rng.integers(0, C, M)
    if match_at is not None:        # no tag equals an address elsewhere
        ts_tag[ts_tag >= 0] += 8 * C
    ts_tag[shard[hit], 0, way[hit]] = addr[hit]
    for tag, s in ((rp_tag, s1), (sh_tag, s2)):
        put = rng.random(M) < 0.3
        tag[1, s[put], rng.integers(0, W, M)[put]] = addr[put]
    tables = [rp_tag, r(65515, 65535, (2, K1, W + 1)), sh_tag,
              r(65515, 65535, (2, K2, W + 1)), r(65505, 65515, (2, K2, W + 1)),
              ts_tag, r(65523, 65536, (KT, 1, C + 1))]
    return tables, [s1, s2, shard], [r(65515, 65535, 2), r(65515, 65535, 2),
                                     addr, act]


def miss_bound(tables, rows, addr, indexed):
    """Bytes: each distinct TSU row named once (its C tags), per lane its
    replica and shared set's tags up to the first match, the clocks of
    the matched ways, the memts of a TSU hit, its address, act and row
    indexes (indexed) or five int32 vectors (gathered), the two clocks
    once (indexed) and the 16 outputs (10 int32 + 6 bool).  Operations:
    a compare a way of each distinct row, the compares of the set scans
    and 30 a lane."""
    import numpy as np
    rp_tag, sh_tag, ts_tag = tables[0], tables[2], tables[5]
    s1, s2, shard = rows
    N, C = len(addr), ts_tag.shape[2] - 1
    distinct = len(np.unique(shard)) if indexed else N
    nbytes, ops = 4 * C * distinct, C * distinct + 30 * N
    for tags, s, vals in ((rp_tag[1, :, :-1], s1, 1),
                          (sh_tag[1, :, :-1], s2, 2)):
        scanned, hits = _scanned(tags[s], addr)
        nbytes += 4 * scanned + 4 * vals * hits
        ops += scanned
    nbytes += 4 * _scanned(ts_tag[shard, 0, :-1], addr)[1]
    nbytes += (17 * N + 8) if indexed else 20 * N
    return nbytes + 46 * N, ops


def grant_case(rng, K, C):
    """write_grant's TSU side: ``[K, 1, C+1]`` tag, memts and seq tables
    (set 0 with its trash way, as the fabric holds them)."""
    import numpy as np
    tag = rng.integers(0, 6000, (K, 1, C + 1)).astype(np.int32)  # full rows
    tag[1::4, :, 5::3] = -1                        # partly full rows
    tag[2::8] = -1                                 # empty rows
    mem = rng.integers(65528, 65535, (K, 1, C + 1)).astype(np.int32)  # ties
    seq = rng.integers(0, 64, (K, 1, C + 1)).astype(np.int32)
    return [tag, mem, seq]


def grant_lanes(rng, tables, N, row):
    """Lanes over the tables' rows ``row``: hits on a third, wl in 1..8."""
    import numpy as np
    addr = rng.integers(0, 6000, N).astype(np.int32)
    addr[::3] = tables[0][row[::3], 0, 11]
    addr[addr == -1] = 6000
    return [addr, rng.integers(1, 9, N).astype(np.int32)]


def grant_bound(tables, row, addr, indexed):
    """Bytes: each distinct row named once (its tags, the memts of its
    live ways and the seq of its ways tied at the minimum), then per lane
    addr, wl, the row index when ``indexed``, one memts on a hit and the
    outputs (4 int32 + 3 bool).  Operations: three per way of each
    distinct row, one compare per way a lane scans to its first match
    (all C on a miss) and ten per lane."""
    import numpy as np
    tag, mem, seq = (a[:, 0, :-1] for a in tables)
    C = tag.shape[1]
    nbytes, ops = 0, 0
    for r in np.unique(row):
        valid = tag[r] != -1
        p = np.where(valid, mem[r], -2 ** 30)
        nbytes += 4 * (C + int(valid.sum()) + int((p == p.min()).sum()))
        ops += 3 * C
    f = _first(tag[row], addr)
    N = len(row)
    nbytes += (12 if indexed else 8) * N + 4 * int((f >= 0).sum()) + 19 * N
    ops += int((f + 1).sum() + (f < 0).sum() * C) + 10 * N
    return nbytes, ops


# ------------------------------------------------------------- phase 2
def check_kernels(torch, np, dev, report):
    from repro_torch.kernels import ref
    from repro_torch.kernels.lease_probe import lease_probe
    from repro_torch.kernels.tier_pass import miss_round, write_grant

    rng = np.random.default_rng(2026)
    T = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def compare(name, kern, plain, args, bound, shape, gathered=None):
        """``gathered``, when given, is the call path the kernel's caller
        made before (the gathers plus the gathered launch): it must give
        the same outputs, and is timed beside."""
        got = kern(*args)
        want = plain(*args)
        torch.cuda.synchronize()
        err = 0
        for i, (g, w) in enumerate(zip(got, want)):
            if g.dtype != w.dtype or g.shape != w.shape or \
                    not torch.equal(g, w):
                raise AssertionError(f"{name}{shape}: output {i} differs "
                                     "from the plain version")
            err = max(err, int((g.long() - w.long()).abs().max()))
        if gathered is not None and not all(
                torch.equal(g, w) for g, w in zip(got, gathered())):
            raise AssertionError(f"{name}{shape}: the old call path "
                                 "differs")
        ms = device_ms(torch, lambda: kern(*args))
        plain_ms = device_ms(torch, lambda: plain(*args))
        nbytes, ops = bound
        bt, ot = nbytes / HBM_BYTES_PER_S * 1e3, ops / OPS_PER_S * 1e3
        row = {"shape": shape, "max_abs_err": err, "ms": ms,
               "plain_ms": plain_ms, "bound_ms": max(bt, ot),
               "bound_by": "bytes" if bt >= ot else "operations",
               "bytes": nbytes, "ops": ops}
        more = ""
        if gathered is not None:
            row["gathered_ms"] = device_ms(torch, gathered)
            more = (f", old call path (gathers + gathered launch) "
                    f"{row['gathered_ms'] * 1e3:.2f} us")
        report.setdefault(name, []).append(row)
        log(f"  {name}{shape}: exact; kernel {ms * 1e3:.2f} us, plain "
            f"{plain_ms * 1e3:.2f} us{more}, bound "
            f"{row['bound_ms'] * 1e3:.4f} us ({row['bound_by']})")

    # lease_probe as the fast read calls it: replica 1's 1024 sets read in
    # place at each lane's row, its one clock, no grant; beside it the
    # call it replaced (a fill of the replica index, a zero grant, the two
    # [N, W+1] set-row gathers and the clock gather, then the gathered
    # launch)
    for N in (1, 64, 4096):
        for W in (2, 8):
            tag, rts, row, cts, addr = probe_case(rng, 1024, N, W)
            tt, rt, ct, at, rowt = map(T, (tag, rts, cts, addr, row))

            def old(N=N, tt=tt, rt=rt, ct=ct, at=at, rowt=rowt):
                reps = torch.full((N,), 1, dtype=torch.int32, device=dev)
                z = torch.zeros((N,), dtype=torch.int32, device=dev)
                return lease_probe(tt[reps, rowt][..., :-1],
                                   rt[reps, rowt][..., :-1], ct[reps], at,
                                   z, z)
            compare("lease_probe", functools.partial(lease_probe, row=rowt),
                    functools.partial(ref.lease_probe_ref, row=rowt),
                    (tt[1][:, :-1], rt[1][:, :-1], ct[1:2], at),
                    probe_bound(tag[1, row, :-1], addr), [N, W], old)
    # lease_probe as the figure engine's round calls it: the L1 (W = 4)
    # and the L2 (W = 16) tables of Fig. 7's 11 cells of 4 x 32 CUs (1408
    # lanes) and of Fig. 8's 16-GPU point (5632 lanes), read in place at
    # each lane's row, a clock and a grant per lane
    for N in (1408, 5632):
        for tier, W in (("l1", 4), ("l2", 16)):
            tag, rts, row, cts, addr, mwts, mrts = engine_probe_case(
                rng, tier, N, W)
            tt, rt = T(tag)[:, :-1], T(rts)[:, :-1]
            rowt = T(row)
            compare("lease_probe", functools.partial(lease_probe, row=rowt),
                    functools.partial(ref.lease_probe_ref, row=rowt),
                    (tt, rt, *map(T, (cts, addr, mwts, mrts))),
                    probe_bound(tag[row, :-1], addr, lane_words=3),
                    [N, W, tier])
    # miss_round as the miss pass calls it: replica 1's and node 1's sets
    # and the 8 TSU rows read in place, M lanes naming them (the lane
    # counts phase 3's replay launches: 32 and 64 a round, 8192 in the
    # warm-up read), beside the round's old call (seven set-row gathers,
    # two clock gathers, act cast, rd filled, the gathered launch); the
    # gathered form at 256 lanes; TSU rows of 20000 ways, hits in the last
    # tile
    rd = 8
    for M, C, match_at in ((32, 1024, None), (64, 1024, None),
                           (8192, 1024, None), (64, 20000, 19997)):
        tables, rows, vecs = miss_case(rng, M, C, match_at=match_at)
        full = [T(a) for a in tables]
        rowt = tuple(map(T, rows))
        c1, c2, at, act = map(T, vecs)
        views = [t[1][:, :-1] for t in full[:5]] + \
            [t[:, 0, :-1] for t in full[5:]]
        reps = torch.full((M,), 1, dtype=torch.int32, device=dev)

        def old(M=M, full=full, rowt=rowt, c1=c1, c2=c2, at=at, act=act,
                reps=reps):
            s1, s2, sh = rowt
            return miss_round(
                *(t[reps, s1][:, :-1] for t in full[:2]),
                *(t[reps, s2][:, :-1] for t in full[2:5]),
                *(t[sh, 0][:, :-1] for t in full[5:]), c1[reps], c2[reps],
                at, act.to(torch.int32),
                torch.full((M,), rd, dtype=torch.int32, device=dev))
        compare("miss_round", functools.partial(miss_round, rows=rowt),
                functools.partial(ref.miss_round_ref, rows=rowt),
                views + [c1[1:2], c2[1:2], at, act, rd],
                miss_bound(tables, rows, vecs[2], True), [8, M, C], old)
    tables, rows, vecs = miss_case(rng, 256, 1024)
    g = [t[1, s, :-1] for t, s in zip(tables[:5], rows[:1] * 2 + rows[1:2] * 3)]
    g += [t[rows[2], 0, :-1] for t in tables[5:]]
    N = 256
    compare("miss_round", miss_round, ref.miss_round_ref,
            [T(a) for a in g] + [T(np.full(N, vecs[0][1], np.int32)),
                                 T(np.full(N, vecs[1][1], np.int32)),
                                 T(vecs[2]), T(vecs[3].astype(np.int32)),
                                 T(np.full(N, rd, np.int32))],
            miss_bound(tables, rows, vecs[2], False), [N, 8, 8, 1024])
    # gathered form: 256 lanes, each on its own row (lane i reads row i)
    tables = grant_case(rng, 256, 1024)
    lanes = np.arange(256, dtype=np.int32)
    vecs = grant_lanes(rng, tables, 256, lanes)
    compare("write_grant", write_grant, ref.write_grant_ref,
            [T(a)[:, 0, :-1] for a in tables] + [T(v) for v in vecs],
            grant_bound(tables, lanes, vecs[0], False), [256, 1024])
    # a TSU of more ways than the kernel holds in registers: walked in
    # tiles of 16384
    tables = grant_case(rng, 16, 20000)
    lanes = np.arange(16, dtype=np.int32)
    vecs = grant_lanes(rng, tables, 16, lanes)
    compare("write_grant", write_grant, ref.write_grant_ref,
            [T(a)[:, 0, :-1] for a in tables] + [T(v) for v in vecs],
            grant_bound(tables, lanes, vecs[0], False), [16, 20000])
    # the write pass's form: the 8 shard rows read in place, 16 (a storm)
    # or 64 (a warm-up chunk) lanes naming them, half at shard 0 as the
    # pass pads; beside it the three [N, C+1] gathers the pass made
    # before, plus the gathered-form launch
    tables = grant_case(rng, 8, 1024)
    full = [T(a) for a in tables]
    for N in (16, 64):
        row = rng.integers(0, 8, N).astype(np.int32)
        row[rng.random(N) < 0.5] = 0
        vecs = [T(v) for v in grant_lanes(rng, tables, N, row)]
        rowt = T(row)
        compare("write_grant", write_grant, ref.write_grant_ref,
                [t[:, 0, :-1] for t in full] + vecs + [rowt],
                grant_bound(tables, row, np.asarray(vecs[0].cpu()), True),
                [8, N, 1024],
                lambda: write_grant(*(t[rowt, 0][..., :-1] for t in full),
                                    *vecs))


# ------------------------------------------------ phase 2, float kernels
def _visible_pairs(Sq, Sk, causal, window=0):
    """(query, key) pairs the causal mask and the window leave visible."""
    def keys(i):
        hi = min(i + 1, Sk) if causal else Sk
        lo = max(0, i - window + 1) if window else 0
        return max(0, hi - lo)
    return sum(keys(i) for i in range(Sq))


def check_float_kernels(torch, np, dev, report):
    """rmsnorm, flash and decode attention against their plain versions on
    the card at the serving path's shapes and odd ones, bf16 and f32;
    each row with kernel, plain and library times and the bound."""
    import torch.nn.functional as F

    from repro_torch.kernels import ref
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_attention, route
    from repro_torch.kernels.rmsnorm import rmsnorm

    def randn(shape, dtype, seed):
        a = np.random.default_rng(seed).standard_normal(shape)
        return torch.from_numpy(a.astype(np.float32)).to(dev, dtype)

    def compare(name, kern, plain, library, nbytes, flops, dtype, shape,
                route="cuda", old=None):
        got = kern()
        want = plain()
        torch.cuda.synchronize()
        tol = FLOAT_TOL[str(dtype).split(".")[-1]]
        if got.dtype != want.dtype or got.shape != want.shape:
            raise AssertionError(f"{name}{shape}: dtype/shape differ")
        if not torch.isfinite(got).all():
            raise AssertionError(f"{name}{shape}: non-finite output")
        err = float((got.float() - want.float()).abs().max())
        if not torch.allclose(got.float(), want.float(), rtol=tol, atol=tol):
            raise AssertionError(f"{name}{shape} {dtype}: max |err| {err} "
                                 f"beyond rtol=atol={tol}")
        rate = BF16_FLOPS_PER_S if dtype == torch.bfloat16 else OPS_PER_S
        bt, ot = nbytes / HBM_BYTES_PER_S * 1e3, flops / rate * 1e3
        row = {"shape": shape, "dtype": str(dtype).split(".")[-1],
               "route": route, "max_abs_err": err, "tol": tol,
               "ms": device_ms(torch, kern),
               "plain_ms": device_ms(torch, plain, n=5, trials=3),
               "library_ms": device_ms(torch, library),
               "bound_ms": max(bt, ot),
               "bound_by": "bytes" if bt >= ot else "operations",
               "bytes": nbytes, "flops": flops}
        if old is not None:
            o = old()
            torch.cuda.synchronize()
            if not torch.allclose(o.float(), want.float(), rtol=tol,
                                  atol=tol):
                raise AssertionError(f"{name}{shape}: the CUDA-core kernel "
                                     "disagrees with the plain version")
            row["old_ms"] = device_ms(torch, old, n=5, trials=3)
        report.setdefault(name, []).append(row)
        log(f"  {name}{shape} {row['dtype']} ({route}): max |err| {err:.3g} "
            f"<= {tol}; "
            f"kernel {row['ms'] * 1e3:.2f} us, "
            + (f"the CUDA-core kernel {row['old_ms'] * 1e3:.2f} us, "
               if old else "") + "plain "
            f"{row['plain_ms'] * 1e3:.2f} us, library "
            f"{row['library_ms'] * 1e3:.2f} us, bound "
            f"{row['bound_ms'] * 1e3:.3f} us ({row['bound_by']})")

    log(f"  float tolerances (rtol = atol): {FLOAT_TOL}; f32 is the same "
        "math summed in another order, bf16 rounds the f32 result once")
    eps = 1e-6
    for dtype in (torch.bfloat16, torch.float32):
        el = torch.finfo(dtype).bits // 8
        for R, D in RMSNORM_SHAPES:
            x = randn((R, D), dtype, R + D)
            w = randn((D,), torch.float32, D) * 0.1
            w1 = (1.0 + w).to(dtype)
            compare("rmsnorm", lambda: rmsnorm(x, w, eps=eps),
                    lambda: ref.rmsnorm_ref(x, w, eps),
                    lambda: F.rms_norm(x, (D,), weight=w1, eps=eps),
                    2 * R * D * el + 4 * D, 4 * R * D, dtype, [R, D])
        # smollm-360m's prefill, a ragged tail, zamba2-1.2b's prefill
        for S, Hq, Hkv in ((PROMPT_LEN, 15, 5), (100, 15, 5),
                           (PROMPT_LEN, 32, 32)):
            B, D = SERVE_B, 64
            q = randn((B, S, Hq, D), dtype, 1)
            k = randn((B, S, Hkv, D), dtype, 2)
            v = randn((B, S, Hkv, D), dtype, 3)
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            compare("flash_attention",
                    lambda: flash_attention(q, k, v, causal=True),
                    lambda: ref.attention_ref(q, k, v, causal=True),
                    lambda: F.scaled_dot_product_attention(
                        qt, kt, vt, is_causal=True, enable_gqa=True),
                    (2 * B * S * Hq * D + 2 * B * S * Hkv * D) * el,
                    4 * D * B * Hq * _visible_pairs(S, S, True), dtype,
                    [B, S, Hq, Hkv, D], route(dtype, D))
        # phase 9's prefills: gemma3-4b (D = 256) local and global, hubert-
        # xlarge (D = 80, non-causal), llava-next-34b (D = 128, GQA 7)
        for B, S, Hq, Hkv, D, causal, window in PHASE9_FLASH:
            q = randn((B, S, Hq, D), dtype, 1)
            k = randn((B, S, Hkv, D), dtype, 2)
            v = randn((B, S, Hkv, D), dtype, 3)
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            i = torch.arange(S, device=dev)
            mask = (i[None, :] <= i[:, None]) & \
                (i[:, None] - i[None, :] < (window or S))
            # hubert's D = 80 in bf16 also on the CUDA-core kernel, its
            # route before the tensor-core kernel took that head dim
            old = (functools.partial(flash_attention, q, k, v, causal=causal,
                                     window=window, _route="simt")
                   if D == 80 and dtype == torch.bfloat16 else None)
            compare("flash_attention",
                    lambda: flash_attention(q, k, v, causal=causal,
                                            window=window),
                    lambda: ref.attention_ref(q, k, v, causal=causal,
                                              window=window),
                    lambda: F.scaled_dot_product_attention(
                        qt, kt, vt, attn_mask=mask, enable_gqa=True)
                    if window else F.scaled_dot_product_attention(
                        qt, kt, vt, is_causal=causal, enable_gqa=True),
                    (2 * B * S * Hq * D + 2 * B * S * Hkv * D) * el,
                    4 * D * B * Hq * _visible_pairs(S, S, causal, window),
                    dtype, [B, S, Hq, Hkv, D, int(causal), window],
                    route(dtype, D), old)
        # phase 10's prefills: deepseek-v2's MLA (q and k 192 wide with v
        # 128, k built as the model builds it: the rope columns broadcast
        # over the heads) and llama4-maverick's (5 query heads a kv head)
        for B, S, Hq, Hkv, D, Dv, causal in PHASE10_FLASH:
            q = randn((B, S, Hq, D), dtype, 1)
            k = randn((B, S, Hkv, D), dtype, 2)
            if Dv != D:
                kr = randn((B, S, D - Dv), dtype, 7)
                k = torch.cat([k[..., :Dv], kr[..., None, :].expand(
                    B, S, Hkv, D - Dv)], -1)
            v = randn((B, S, Hkv, Dv), dtype, 3)
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            sdpa = functools.partial(F.scaled_dot_product_attention, qt, kt,
                                     vt, is_causal=causal, enable_gqa=True)
            compare("flash_attention",
                    lambda: flash_attention(q, k, v, causal=causal),
                    lambda: ref.attention_ref(q, k, v, causal=causal), sdpa,
                    (B * S * Hq * (D + Dv) + B * S * Hkv * (D + Dv)) * el,
                    2 * (D + Dv) * B * Hq * _visible_pairs(S, S, causal),
                    dtype, [B, S, Hq, Hkv, D, Dv, int(causal)],
                    route(dtype, D, Dv))
            row = report["flash_attention"][-1]
            row["library_kernel"] = sdpa_backend(torch, sdpa)
            log(f"    SDPA ran {row['library_kernel'][:90]}")
        # smollm-360m's cache at three fill levels, zamba2-1.2b's at one
        for Sk, Hq, Hkv, kv_len in ((MAX_LEN, 15, 5, 1),
                                    (MAX_LEN, 15, 5, PROMPT_LEN + 1),
                                    (MAX_LEN, 15, 5, MAX_LEN),
                                    (HYBRID_MAX_LEN, 32, 32, PROMPT_LEN + 1)):
            B, D = SERVE_B, 64
            q = randn((B, 1, Hq, D), dtype, 4)
            k = randn((B, Sk, Hkv * D), dtype, 5).view(B, Sk, Hkv, D)
            v = randn((B, Sk, Hkv * D), dtype, 6).view(B, Sk, Hkv, D)
            k[:, kv_len:] = float("nan")       # never read: no NaN out
            v[:, kv_len:] = float("nan")
            qt = q.transpose(1, 2)
            kt, vt = (t[:, :kv_len].transpose(1, 2) for t in (k, v))
            kp, vp = (t.nan_to_num() for t in (k, v))
            compare("decode_attention",
                    lambda: decode_attention(q, k, v, kv_len),
                    lambda: ref.attention_ref(q, kp, vp, causal=False,
                                              kv_len=kv_len),
                    lambda: F.scaled_dot_product_attention(
                        qt, kt, vt, enable_gqa=True),
                    (2 * B * Hq * D + 2 * B * kv_len * Hkv * D) * el,
                    4 * D * B * Hq * kv_len, dtype,
                    [B, Sk, Hq, Hkv, D, kv_len])
        # phase 9's decode steps: gemma3-4b past its window (D = 256),
        # llava-next-34b (7 query heads a kv head); phase 10's:
        # llama4-maverick (5) at its first and last step
        for B, Sk, Hq, Hkv, D, kv_len in PHASE9_DECODE + PHASE10_DECODE:
            q = randn((B, 1, Hq, D), dtype, 4)
            k = randn((B, Sk, Hkv * D), dtype, 5).view(B, Sk, Hkv, D)
            v = randn((B, Sk, Hkv * D), dtype, 6).view(B, Sk, Hkv, D)
            k[:, kv_len:] = float("nan")
            v[:, kv_len:] = float("nan")
            qt = q.transpose(1, 2)
            kt, vt = (t[:, :kv_len].transpose(1, 2) for t in (k, v))
            kp, vp = (t.nan_to_num() for t in (k, v))
            compare("decode_attention",
                    lambda: decode_attention(q, k, v, kv_len),
                    lambda: ref.attention_ref(q, kp, vp, causal=False,
                                              kv_len=kv_len),
                    lambda: F.scaled_dot_product_attention(
                        qt, kt, vt, enable_gqa=True),
                    (2 * B * Hq * D + 2 * B * kv_len * Hkv * D) * el,
                    4 * D * B * Hq * kv_len, dtype,
                    [B, Sk, Hq, Hkv, D, kv_len])


def sdpa_backend(torch, fn, sdpa=None) -> str:
    """The device kernel that takes most of two calls of ``fn`` (a partial
    of SDPA, or a call of its backward) under ``torch.profiler``: which of
    its backends SDPA picked.  A window that records no device event
    (CUPTI missed the calls in two runs of this script, each time at a
    different shape) is profiled again, up to three windows; then the
    backend SDPA's dispatcher names for the same arguments
    (``torch._fused_sdp_choice`` on ``sdpa``, the forward's partial;
    default ``fn``) stands in, marked as such.  The name is reported, not
    checked; the library's time comes from CUDA events either way."""
    for _ in range(3):
        try:
            return profile_calls(torch, fn, 2)["device_by_name"][0]["name"]
        except AssertionError as e:
            log(f"    SDPA's profile: {e}; profiling again")
    from torch.nn.attention import SDPBackend
    sdpa = sdpa or fn
    choice = torch._fused_sdp_choice(*sdpa.args, **sdpa.keywords)
    names = {int(getattr(SDPBackend, n)): n for n in dir(SDPBackend)
             if n.isupper()}
    return f"{names.get(choice, choice)} (the dispatcher's choice)"


def log_rmsnorm_vs_library(report) -> None:
    """rmsnorm's time over ``F.rms_norm``'s at each bf16 shape."""
    rows = [r for r in report["rmsnorm"] if r["dtype"] == "bfloat16"]
    log("  rmsnorm / F.rms_norm, bf16: " + ", ".join(
        f"{tuple(r['shape'])} {r['ms'] / r['library_ms']:.2f}" for r in rows))


def ssd_bound(B, nc, Q, H, P, N, el, stride0, out_el, split):
    """Bytes (x in the storage type, y in its output type, B and C once
    per group when they are a stride-0 broadcast, dt, cum and the f32
    state) and flops over the visible causal pairs: 2N for the score and
    2P for y a pair, 2NP a row for the state; with ``split`` (the
    tensor-core route) y's and the state's products count twice, as the
    tensor cores do them on the hi and lo halves."""
    bc = B * nc * Q * N * (1 if stride0 else H)
    nbytes = B * nc * Q * H * P * (el + out_el) + 2 * bc * el \
        + 2 * 4 * B * nc * Q * H + 4 * B * nc * H * N * P + 4 * H
    k = 2 if split else 1
    flops = B * nc * H * (Q * (Q + 1) // 2 * (2 * N + k * 2 * P)
                          + k * 2 * Q * N * P)
    return nbytes, flops


def ssd_inputs(torch, np, dev, B, nc, Q, H, P, N, dtype, stride0, seed):
    """x, dt, A, B, C for ``ssd_chunk``: dt = SSD_DT_SCALE * softplus of a
    normal, A = -exp(U(0, 1.5)); B and C a group's [.., 1, N] broadcast to
    the heads, as a stride-0 view (``stride0``) or a copy per head."""
    rng = np.random.default_rng(seed)
    T = lambda a, dt=torch.float32: torch.from_numpy(
        a.astype(np.float32)).to(dev, dt)
    x = T(rng.standard_normal((B, nc, Q, H, P)), dtype)
    dt = T(np.log1p(np.exp(rng.standard_normal((B, nc, Q, H))))
           * SSD_DT_SCALE)
    A = T(-np.exp(rng.uniform(0.0, 1.5, H)))
    bc = []
    for _ in range(2):
        g = T(rng.standard_normal((B, nc, Q, 1, N)), dtype).expand(
            B, nc, Q, H, N)
        bc.append(g if stride0 else g.contiguous())
    return x, dt, A, bc[0], bc[1]


def check_ssd_kernel(torch, np, dev, report):
    """``ssd_chunk`` against its plain version on the card: y and state
    within FLOAT_TOL, cum equal to the plain version's bit for bit, no
    NaN.  bf16 rows ask y in f32, as the model does, and take the route
    ``route`` names; each row prints its route, the kernel's time, the
    CUDA-core kernels' time at the same shape (``path="simt"``: the
    earlier kernels at a tensor-core shape), the plain version's and the bound
    (no PyTorch call computes this function)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.ssd_chunk import route, ssd_chunk

    shapes = ((SERVE_B, 2, 256, 24, 64, 128, True),   # mamba2-130m prefill
              (SERVE_B, 2, 256, 24, 64, 128, False),  # B/C copied per head
              (SERVE_B, 2, 256, 64, 64, 64, True),    # zamba2-1.2b prefill
              (SERVE_B, 2, 256, 64, 64, 64, False),
              (SERVE_B, 2, 200, 24, 64, 128, True),   # a ragged chunk
              (SERVE_B, 1, 16, 24, 64, 128, False),   # one chunk of 16
              (2, 3, 64, 4, 32, 16, False))
    for dtype in (torch.bfloat16, torch.float32):
        tol = FLOAT_TOL[str(dtype).split(".")[-1]]
        el = torch.finfo(dtype).bits // 8
        for B, nc, Q, H, P, N, stride0 in shapes:
            shape = [B, nc, Q, H, P, N]
            path = route(dtype, P, N)
            args = ssd_inputs(torch, np, dev, B, nc, Q, H, P, N, dtype,
                              stride0, Q + H + N)
            before = ssd_chunk.route_launches[path]
            got = ssd_chunk(*args, out_dtype=torch.float32)
            want = ref.ssd_chunk_ref(*args, torch.float32)
            torch.cuda.synchronize()
            if ssd_chunk.route_launches[path] != before + 1:
                raise AssertionError(f"ssd_chunk{shape}: not on the "
                                     f"{path} route")
            err = 0.0
            for name, g, w, t in zip(("y", "state", "cum"), got, want,
                                     (tol, tol, 0.0)):
                if g.dtype != w.dtype or g.shape != w.shape:
                    raise AssertionError(f"ssd_chunk{shape}: {name} "
                                         "dtype/shape differ")
                if not torch.isfinite(g).all():
                    raise AssertionError(f"ssd_chunk{shape}: non-finite "
                                         f"{name}")
                e = float((g.float() - w.float()).abs().max())
                if not torch.allclose(g.float(), w.float(), rtol=t, atol=t):
                    raise AssertionError(f"ssd_chunk{shape} {dtype}: {name} "
                                         f"max |err| {e} beyond {t}")
                err = max(err, e)
            nbytes, flops = ssd_bound(B, nc, Q, H, P, N, el, stride0, 4,
                                      path == "wgmma")
            rate = BF16_FLOPS_PER_S if dtype == torch.bfloat16 else OPS_PER_S
            bt, ot = nbytes / HBM_BYTES_PER_S * 1e3, flops / rate * 1e3
            ms = device_ms(torch, lambda: ssd_chunk(
                *args, out_dtype=torch.float32))
            row = {"shape": shape, "dtype": str(dtype).split(".")[-1],
                   "stride0": stride0, "route": path, "max_abs_err": err,
                   "tol": tol, "ms": ms,
                   "simt_ms": ms if path == "simt" else device_ms(
                       torch, lambda: ssd_chunk(*args, out_dtype=torch.float32,
                                                path="simt")),
                   "plain_ms": device_ms(
                       torch, lambda: ref.ssd_chunk_ref(*args, torch.float32),
                       n=5, trials=3),
                   "library_ms": None, "bound_ms": max(bt, ot),
                   "bound_by": "bytes" if bt >= ot else "operations",
                   "bytes": nbytes, "flops": flops}
            report.setdefault("ssd_chunk", []).append(row)
            log(f"  ssd_chunk{shape} {row['dtype']}"
                f"{' stride-0 B/C' if stride0 else ''} ({path}, y in f32): "
                f"max |err| {err:.3g} <= {tol} (cum equal), cum down to "
                f"{float(got[2].min()):.1f}; kernel {row['ms'] * 1e3:.2f} "
                f"us, simt {row['simt_ms'] * 1e3:.2f} us, plain "
                f"{row['plain_ms'] * 1e3:.2f} us, bound "
                f"{row['bound_ms'] * 1e3:.3f} us ({row['bound_by']})")


# ------------------------------------------ phase 2, the backward kernels
def check_backward_kernels(torch, np, dev, report):
    """rmsnorm_bwd and flash_attention_bwd against autograd of their plain
    versions on the card, at the training shapes (rmsnorm: R = B S = 4096
    rows of 960; flash: B = 8, S = 512, 15 over 5 heads of 64, causal,
    and zamba2's shared block, 32 heads of 64)
    and odd ones (a few rows, odd widths, a window with rows that see no
    key, D = 128), bf16 and f32, each flash row on the route ``route``
    names (the tensor-core route with the forward's row statistics);
    each row with the kernel's time, the plain backward's and the
    library's (autograd of ``F.rms_norm`` and of SDPA, each on a graph
    built once; none where SDPA takes no such call), and the bound.  At
    the bf16 training shapes (smollm's, and phase 11's: hubert-xlarge's
    D = 80, gemma3-4b's 256 past its window, deepseek-v2's MLA pair (192,
    128)) flash also times the CUDA-core kernel (``_route="simt"``,
    smollm's the kernel of the first round) in the same run, checked
    against the plain version too; at deepseek's the SDPA backward's
    kernel is named."""
    import torch.nn.functional as F

    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_bwd,
                                                     route)
    from repro_torch.kernels.rmsnorm import rmsnorm_bwd

    def randn(shape, dtype, seed):
        a = np.random.default_rng(seed).standard_normal(shape)
        return torch.from_numpy(a.astype(np.float32)).to(dev, dtype)

    def backward_of(out, inputs, grad):
        """A timed call: the backward of a graph built once."""
        return lambda: torch.autograd.grad(out, inputs, grad,
                                           retain_graph=True)

    def compare(name, kern, plain, library, nbytes, flops, dtype, shape,
                path="cuda", old=None):
        got, want = kern(), plain()
        if old is not None:
            for g, w in zip(old(), want):
                if not torch.allclose(g.float(), w.float(), rtol=GRAD_TOL[
                        str(dtype).split(".")[-1]], atol=GRAD_TOL[
                        str(dtype).split(".")[-1]]):
                    raise AssertionError(f"{name}{shape}: the CUDA-core "
                                         "kernel disagrees with the plain "
                                         "version")
        torch.cuda.synchronize()
        tol = GRAD_TOL[str(dtype).split(".")[-1]]
        err = 0.0
        for g, w in zip(got, want):
            if g.dtype != w.dtype or g.shape != w.shape:
                raise AssertionError(f"{name}{shape}: dtype/shape differ")
            if not torch.isfinite(g).all():
                raise AssertionError(f"{name}{shape}: non-finite output")
            err = max(err, float((g.float() - w.float()).abs().max()))
            if not torch.allclose(g.float(), w.float(), rtol=tol, atol=tol):
                raise AssertionError(f"{name}{shape} {dtype}: max |err| "
                                     f"{err} beyond rtol=atol={tol}")
        again = kern()
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise AssertionError(f"{name}{shape}: differs from run to run")
        rate = BF16_FLOPS_PER_S if dtype == torch.bfloat16 else OPS_PER_S
        bt, ot = nbytes / HBM_BYTES_PER_S * 1e3, flops / rate * 1e3
        row = {"shape": shape, "dtype": str(dtype).split(".")[-1],
               "route": path, "max_abs_err": err, "tol": tol,
               "ms": device_ms(torch, kern),
               "plain_ms": device_ms(torch, plain, n=5, trials=3),
               "library_ms": None if library is None
               else device_ms(torch, library),
               "bound_ms": max(bt, ot),
               "bound_by": "bytes" if bt >= ot else "operations",
               "bytes": nbytes, "flops": flops}
        if old is not None:
            row["old_ms"] = device_ms(torch, old, n=5, trials=3)
        report.setdefault(name, []).append(row)
        log(f"  {name}{shape} {row['dtype']} ({path}): max |err| {err:.3g} "
            f"<= {tol}, same from run to run; kernel {row['ms'] * 1e3:.2f} "
            f"us, "
            + (f"CUDA-core kernel {row['old_ms'] * 1e3:.2f} us, " if old
               else "")
            + f"plain {row['plain_ms'] * 1e3:.2f} us, library "
            + ("none" if library is None
               else f"{row['library_ms'] * 1e3:.2f} us")
            + f", bound {row['bound_ms'] * 1e3:.3f} us ({row['bound_by']}, "
            f"{row['bound_ms'] / row['ms']:.3f} of it)")

    log(f"  backward tolerances (rtol = atol): {GRAD_TOL}")
    eps = 1e-6
    for dtype in (torch.bfloat16, torch.float32):
        el = torch.finfo(dtype).bits // 8
        for R, D in ((TRAIN_B * TRAIN_S, 960), (8, 960), (7, 80)):
            x = randn((R, D), dtype, R + D)
            dy = randn((R, D), dtype, R + D + 1)
            w = randn((D,), torch.float32, D) * 0.1
            xl = x.detach().requires_grad_()
            wl = (1.0 + w).to(dtype).requires_grad_()
            lib = F.rms_norm(xl, (D,), weight=wl, eps=eps)
            xp, wp = x.detach().requires_grad_(), w.detach().requires_grad_()
            plain_out = ref.rmsnorm_ref(xp, wp, eps)
            compare("rmsnorm_bwd", lambda: rmsnorm_bwd(x, w, dy, eps=eps),
                    backward_of(plain_out, (xp, wp), dy),
                    backward_of(lib, (xl, wl), dy),
                    3 * R * D * el + 8 * D, 12 * R * D, dtype, [R, D])
        if dtype == torch.bfloat16:
            log("  rmsnorm_bwd's first-round kernel (rewritten in place): "
                "21.41 us at [4096, 960] bf16, 26.44 us in f32, 9.64 us at "
                "[8, 960] bf16 (run AM, PERF.md)")
        wide = tuple((B, S, S, Hq, Hkv, D, Dv, causal, window)
                     for B, S, Hq, Hkv, D, Dv, causal, window
                     in PHASE11_FLASH_BWD)
        for B, Sq, Sk, Hq, Hkv, D, Dv, causal, window in tuple(
                (B, Sq, Sk, Hq, Hkv, D, D, causal, window)
                for B, Sq, Sk, Hq, Hkv, D, causal, window in (
                    (TRAIN_B, TRAIN_S, TRAIN_S, 15, 5, 64, True, 0),
                    (TRAIN_B, TRAIN_S, TRAIN_S, 32, 32, 64, True, 0),
                    (1, 130, 50, 4, 2, 64, True, 16),
                    (1, 130, 130, 4, 1, 128, True, 32),
                    (2, 77, 77, 4, 2, 16, False, 0),
                    (1, 100, 77, 4, 2, 80, True, 16),
                    (1, 333, 333, 4, 2, 256, False, 0))) + wide:
            q = randn((B, Sq, Hq, D), dtype, 1)
            k = randn((B, Sk, Hkv, D), dtype, 2)
            v = randn((B, Sk, Hkv, Dv), dtype, 3)
            do = randn((B, Sq, Hq, Dv), dtype, 4)
            path = route(dtype, D, Dv)
            stats = (torch.empty((2, B, Hq, Sq), dtype=torch.float32,
                                 device=dev) if path == "wgmma" else None)
            o = flash_attention(q, k, v, causal=causal, window=window,
                                stats=stats)
            qp, kp, vp = (t.detach().requires_grad_() for t in (q, k, v))
            plain_out = ref.attention_ref(qp, kp, vp, causal=causal,
                                          window=window)
            ql, kl, vl = (t.transpose(1, 2).detach().requires_grad_()
                          for t in (q, k, v))
            mask = None
            if window or Sq != Sk:
                qpos = torch.arange(Sq, device=dev)[:, None]
                kpos = torch.arange(Sk, device=dev)[None, :]
                mask = torch.zeros((Sq, Sk), device=dev, dtype=dtype)
                if causal:
                    mask = mask.masked_fill(kpos > qpos, -1e30)
                if window:
                    mask = mask.masked_fill(qpos - kpos >= window, -1e30)
            sdpa = functools.partial(
                F.scaled_dot_product_attention, ql, kl, vl, attn_mask=mask,
                is_causal=causal and mask is None, enable_gqa=True)
            try:
                library = backward_of(sdpa(), (ql, kl, vl),
                                      do.transpose(1, 2))
                library()
            except RuntimeError as e:        # no SDPA backend takes it
                log(f"    SDPA's backward at {D}/{Dv}: {str(e)[:120]}")
                library = None
            pairs = _visible_pairs(Sq, Sk, causal, window)
            old = None
            if path == "wgmma" and ((B == TRAIN_B and Hq == 15)
                                    or (B, Sq, Sk, Hq, Hkv, D, Dv, causal,
                                        window) in wide):
                def old():
                    return flash_attention_bwd(q, k, v, o, do, causal=causal,
                                               window=window, _route="simt")
            # the tensor-core route also reads the forward's m and 1 / l
            stat_bytes = 8 * B * Hq * Sq if path == "wgmma" else 0
            # q, k, o, dO, v read and dq, dk, dv written; S, dQ and dK
            # over D, dP and dV over Dv
            compare("flash_attention_bwd",
                    lambda: flash_attention_bwd(q, k, v, o, do,
                                                causal=causal, window=window,
                                                stats=stats),
                    backward_of(plain_out, (qp, kp, vp), do), library,
                    (2 * B * Sq * Hq * (D + Dv) + 2 * B * Sk * Hkv * (D + Dv))
                    * el + stat_bytes,
                    (6 * D + 4 * Dv) * B * Hq * pairs, dtype,
                    [B, Sq, Sk, Hq, Hkv, D, Dv, int(causal), window], path,
                    old)
            if Dv != D:
                row = report["flash_attention_bwd"][-1]
                row["library_kernel"] = "none" if library is None \
                    else sdpa_backend(torch, library, sdpa)
                log(f"    SDPA's backward ran {row['library_kernel'][:90]}")


def ssd_bwd_bound(B, nc, Q, H, P, N, el, stride0):
    """Bytes (x, B and C once per group when they are a stride-0
    broadcast, dt, cum, dy, dstate and dcum read; dx, the per-head dB and
    dC, ddt and dA written) and flops over the visible causal pairs (C.B
    and dy.x, 2N + 2P; dx, dB and dC, 2P + 4N) and 4NP a row for the
    state terms (B . dstate and dstate x)."""
    bc = B * nc * Q * N * (1 if stride0 else H)
    rows = B * nc * Q * H
    nbytes = (rows * P * el + 2 * bc * el + 3 * 4 * rows + 4 * rows * P
              + 4 * B * nc * H * N * P + 4 * H
              + rows * P * el + 2 * rows * N * el + 4 * rows + 4 * H)
    flops = B * nc * H * (Q * (Q + 1) // 2 * (6 * N + 4 * P)
                          + 4 * Q * N * P)
    return nbytes, flops


def check_ssd_bwd_kernel(torch, np, dev, report):
    """``ssd_chunk_bwd`` against ``ssd_chunk_bwd_ref`` (autograd of the
    plain version, y asked in f32 as the model asks it) on the card,
    within GRAD_TOL (ddt and dA: SSD_BWD_SCALED_TOL of their scale), at
    the mamba2-130m and zamba2-1.2b training shapes
    (B = 8, S = 512: nc = 2, Q = 256; B and C a stride-0 head), with B
    and C one per head, and at odd shapes; bf16 and f32; on every route
    that takes the shape (the route ``route`` names, and the CUDA-core
    kernel, ``path="simt"``), each from the cum of its own route's
    forward; nonzero cotangents on y, the state and cum; a rerun equal
    bit for bit.  Each row is the routed kernel's, with its time, the
    CUDA-core kernel's time at the same shape (the first round's kernel
    at a tensor-core shape), the plain backward's (autograd of the plain
    forward, on a graph built once) and the bound; no PyTorch call
    computes this function."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.ssd_chunk import route, ssd_chunk, ssd_chunk_bwd

    shapes = ((TRAIN_B, 2, 256, 24, 64, 128, True),   # mamba2-130m
              (TRAIN_B, 2, 256, 64, 64, 64, True),    # zamba2-1.2b
              (TRAIN_B, 2, 256, 24, 64, 128, False),  # B/C one per head
              (1, 2, 100, 3, 128, 48, True),          # ragged, odd N
              (2, 2, 200, 4, 128, 128, False),        # ragged, P = N = 128
              (2, 3, 64, 4, 32, 16, False))
    for dtype in (torch.bfloat16, torch.float32):
        tol = GRAD_TOL[str(dtype).split(".")[-1]]
        el = torch.finfo(dtype).bits // 8
        for B, nc, Q, H, P, N, stride0 in shapes:
            shape = [B, nc, Q, H, P, N]
            args = ssd_inputs(torch, np, dev, B, nc, Q, H, P, N, dtype,
                              stride0, Q + H + N + 1)
            rng = np.random.default_rng(Q + N)
            T = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(
                np.float32)).to(dev)
            dy, dstate, dcum = (T(B, nc, Q, H, P), T(B, nc, H, N, P),
                                T(B, nc, Q, H))
            path = route(dtype, P, N)
            want = ref.ssd_chunk_bwd_ref(*args, dy, dstate, dcum,
                                         torch.float32)
            errs, cums = {}, {}
            for p in sorted({path, "simt"}):
                cums[p] = cum = ssd_chunk(*args, out_dtype=torch.float32,
                                          path=p)[2]
                before = ssd_chunk_bwd.route_launches[p]
                got = ssd_chunk_bwd(*args, cum, dy, dstate, dcum, path=p)
                torch.cuda.synchronize()
                if ssd_chunk_bwd.route_launches[p] != before + 1:
                    raise AssertionError(f"ssd_chunk_bwd{shape}: not on "
                                         f"the {p} route")
                for name, g, w in zip(("dx", "ddt", "dA", "dB", "dC"), got,
                                      want):
                    if g.dtype != w.dtype or g.shape != w.shape:
                        raise AssertionError(f"ssd_chunk_bwd{shape}: {name} "
                                             "dtype/shape differ")
                    if not torch.isfinite(g).all():
                        raise AssertionError(f"ssd_chunk_bwd{shape} ({p}): "
                                             f"non-finite {name}")
                    e = float((g.float() - w.float()).abs().max())
                    rt = at = tol
                    if name in SSD_BWD_SCALED:
                        rt = SSD_BWD_SCALED_TOL
                        at = rt * max(1.0, float(w.abs().max()))
                    if not torch.allclose(g.float(), w.float(), rtol=rt,
                                          atol=at):
                        rel = float(((g.float() - w.float()).abs()
                                     / (1 + w.float().abs())).max())
                        raise AssertionError(
                            f"ssd_chunk_bwd{shape} {dtype} ({p}): {name} max "
                            f"|err| {e} ({rel:.3g} of 1 + |want|) beyond "
                            f"rtol={rt}, atol={at}")
                    if p == path:
                        errs[name] = e
                again = ssd_chunk_bwd(*args, cum, dy, dstate, dcum, path=p)
                if not all(torch.equal(a, b) for a, b in zip(got, again)):
                    raise AssertionError(f"ssd_chunk_bwd{shape} ({p}): "
                                         "differs from run to run")
            with torch.enable_grad():
                ins = [t.detach().requires_grad_() for t in args]
                outs = ref.ssd_chunk_ref(*ins, torch.float32)

            def plain():
                return torch.autograd.grad(outs, ins, (dy, dstate, dcum),
                                           retain_graph=True)

            def timed(p):
                return device_ms(torch, lambda: ssd_chunk_bwd(
                    *args, cums[p], dy, dstate, dcum, path=p))
            nbytes, flops = ssd_bwd_bound(B, nc, Q, H, P, N, el, stride0)
            rate = BF16_FLOPS_PER_S if dtype == torch.bfloat16 else OPS_PER_S
            bt, ot = nbytes / HBM_BYTES_PER_S * 1e3, flops / rate * 1e3
            row = {"shape": shape, "dtype": str(dtype).split(".")[-1],
                   "stride0": stride0, "route": path,
                   "max_abs_err": max(errs.values()), "errs": errs,
                   "tol": tol, "ms": timed(path),
                   "simt_ms": None if path == "simt" else timed("simt"),
                   "plain_ms": device_ms(torch, plain, n=3, trials=3),
                   "library_ms": None, "bound_ms": max(bt, ot),
                   "bound_by": "bytes" if bt >= ot else "operations",
                   "bytes": nbytes, "flops": flops}
            if row["simt_ms"] is None:
                row["simt_ms"] = row["ms"]
            del outs, ins
            report.setdefault("ssd_chunk_bwd", []).append(row)
            log(f"  ssd_chunk_bwd{shape} {row['dtype']}"
                f"{' stride-0 B/C' if stride0 else ''} ({path}"
                f"{' and simt' if path != 'simt' else ''}): max |err| "
                f"{', '.join(f'{k} {v:.3g}' for k, v in errs.items())}"
                f" (tol {tol}; ddt, dA {SSD_BWD_SCALED_TOL} of their "
                "scale), same from run to run; kernel "
                f"{row['ms'] * 1e3:.2f} us, simt {row['simt_ms'] * 1e3:.2f} "
                f"us, plain {row['plain_ms'] * 1e3:.2f} us, bound "
                f"{row['bound_ms'] * 1e3:.3f} us ({row['bound_by']}, "
                f"{row['bound_ms'] / row['ms']:.3f} of it); no library call")


# ------------------------------------------------------------- phase 3
class Serving:
    """``scheduler.replay``'s backend over two ``BatchedKVLease`` front
    ends (reader replica 1, writer replica 0); records every served read
    batch in resolve order."""

    def __init__(self, fab):
        from repro_torch.coherence.kv_lease import BatchedKVLease
        self.fab = fab
        self.reader = BatchedKVLease(fab, replica=1)
        self.writer = BatchedKVLease(fab, replica=0)
        self.served = []
        # {pass: [c10d collectives of each call]} while counted (phase 7)
        self.collectives = None

    def _call(self, kind, fn):
        """Run one fabric call; while counted, tally the ``c10d``
        collectives it issues (``obs.xprof``) under its pass: a read batch
        is "read, all hit" when the replica tier served it alone."""
        if self.collectives is None:
            return fn()
        from repro_torch.obs.xprof import collective_counts
        fast = self.fab.fast_read_batches
        out, c = collective_counts(fn)
        if kind == "read":
            kind = ("read, all hit" if self.fab.fast_read_batches > fast
                    else "read, misses")
        self.collectives[kind].append(c["total"])
        return out

    def read_batch_async(self, keys, replica):
        from repro_torch.coherence.fabric import ReadBatchHandle
        assert replica == self.reader.replica
        h = self._call("read", lambda: self.reader.get_batch_async(keys))
        return ReadBatchHandle(lambda: self._record(h.result()))

    def _record(self, out):
        self.served.append(out)
        return out

    def write_batch(self, items, replica):
        assert replica == self.writer.replica
        self._call("write", lambda: self.writer.put_batch(items))

    def fence(self):
        return self._call("fence", self.writer.fence)


def key_of(k: int) -> str:
    return f"prefix/{k}"


def fabric_config():
    """The serving bench's geometry: 8 TSU shards x 1024 entries."""
    from repro_torch.coherence.fabric import FabricConfig
    return FabricConfig(n_shards=8, rd_lease=8, wr_lease=4,
                        replica_sets=1024, replica_ways=8,
                        shared_sets=2048, shared_ways=8)


def build_fabric(device):
    from repro_torch.coherence.fabric import default_fabric
    return default_fabric(fabric_config(), n_nodes=2, replicas_per_node=2,
                          device=device)


def phase3_trace(loadgen):
    return loadgen.synthesize(N_REQUESTS, N_KEYS, a=1.2, process="diurnal",
                              rate=1.0, amplitude=0.9, cycles=3.0, seed=7)


def warm(serving) -> None:
    """Publish every key (write batches of one wave each), fence, and
    fill the reader's replica tier."""
    keys = [key_of(k) for k in range(N_KEYS)]
    for i in range(0, N_KEYS, WARM_CHUNK):
        serving.writer.put_batch([(k, f"{k}@0") for k in keys[i:i + WARM_CHUNK]])
    serving.writer.fence()
    serving.reader.get_batch(keys)


def service_model(n: int) -> float:
    """Deterministic service charge per fabric call (seconds): keeps the
    card and CPU replays' wave formation identical."""
    return 1e-3 + 2e-5 * n


def count_rounds(fab):
    """Wrap ``fab``'s write and fence passes to count the rounds each runs
    (the rows of its round matrix with a live lane): each round makes one
    TSU write grant.  Returns the running counts (none for the host-object
    fabric, which has no passes)."""
    import numpy as np
    n = collections.Counter()
    if not hasattr(fab, "_write_run"):
        return n

    def wrap(kind, run, masks_at):
        def counted(*args):
            n[kind] += int(np.asarray(args[masks_at]).any(axis=1).sum())
            return run(*args)
        return counted

    fab._write_run = wrap("write", fab._write_run, 3)
    fab._fence_run = wrap("fence", fab._fence_run, 2)
    return n


class CallSites:
    """Phase 3's kernel calls by call site, while it is entered: each
    ``lease_probe`` call on the card under the innermost of the fast read
    (``arrays._fast_read``), the op scan's read, write, publish and
    ``drain1`` (a posted write's drain, run by a write or a fence), and
    each ``miss_round`` call's lane count.  Counts only: nothing waits for
    the card."""

    SITES = (("fast read", None, "_fast_read"), ("read", "_OpScan", "read"),
             ("write", "_OpScan", "write"),
             ("publish", "_OpScan", "mm_write"),
             ("drain1", "_OpScan", "drain1"))

    def __init__(self):
        self.probe = collections.Counter()
        self.miss_lanes = collections.Counter()
        self._stack, self._undo = [], []

    def __enter__(self):
        from repro_torch.coherence.fabric import arrays
        from repro_torch.kernels import ops

        def patch(owner, attr, new):
            self._undo.append((owner, attr, getattr(owner, attr)))
            setattr(owner, attr, new)

        def enter(site, fn):
            def wrapped(*a, **kw):
                self._stack.append(site)
                try:
                    return fn(*a, **kw)
                finally:
                    self._stack.pop()
            return wrapped

        for site, cls, attr in self.SITES:
            owner = arrays if cls is None else getattr(arrays, cls)
            patch(owner, attr, enter(site, getattr(owner, attr)))
        probe, miss = ops._lease_probe, ops._miss_round

        def probe_at(*a, **kw):
            if a[3].shape[0]:                            # addr: [N]
                self.probe[self._stack[-1] if self._stack else "other"] += 1
            return probe(*a, **kw)

        def miss_at(*a, **kw):
            if a[9].shape[0]:                            # addr: [M]
                self.miss_lanes[a[9].shape[0]] += 1
            return miss(*a, **kw)

        patch(ops, "_lease_probe", probe_at)
        patch(ops, "_miss_round", miss_at)
        return self

    def __exit__(self, *exc):
        for owner, attr, old in reversed(self._undo):
            setattr(owner, attr, old)
        self._undo.clear()

    def report(self):
        return {"lease_probe_by_site": dict(self.probe),
                "miss_round_lanes": {str(k): v for k, v in
                                     sorted(self.miss_lanes.items())}}


def replay_modeled(device, trace, sites=None, fab=None, count=False):
    """Warm a fresh fabric (``fab``, else one built on ``device``) and
    replay ``trace`` with the deterministic service model; also returns
    the write and fence passes' round counts.  ``count``: tally the
    replay's ``c10d`` collectives by pass (``Serving.collectives``)."""
    from repro_torch.runtime import scheduler
    fab = build_fabric(device) if fab is None else fab
    rounds = count_rounds(fab)
    serving = Serving(fab)
    with sites or contextlib.nullcontext():
        t0 = time.perf_counter()
        warm(serving)
        if count:
            serving.collectives = collections.defaultdict(list)
        t1 = time.perf_counter()
        wave = service_model(MAX_BATCH)
        pol = scheduler.BatchPolicy(mode="continuous", max_batch=MAX_BATCH,
                                    min_bucket=8, max_wait_s=1.5 * wave)
        tr = trace.scaled(0.7 * (MAX_BATCH / wave) / trace.offered_rps)
        res = scheduler.replay(serving, tr, pol,
                               republish_every=REPUBLISH_EVERY,
                               republish_n=REPUBLISH_N,
                               service_model=service_model)
        t2 = time.perf_counter()
    return fab, serving, res, t1 - t0, t2 - t1, rounds


def compare_fabrics(np, a, b, sa, sb) -> None:
    if sa.served != sb.served:
        raise AssertionError("served results differ between card and CPU")
    if list(a.grant_log) != list(b.grant_log):
        raise AssertionError("grant logs differ between card and CPU")
    if a.stats() != b.stats():
        raise AssertionError("fabric counters differ between card and CPU")
    for r in range(a.n_replicas):
        if a.replica_stats(r) != b.replica_stats(r):
            raise AssertionError(f"replica {r} counters differ")
    ma = [a.memts(key_of(k)) for k in range(N_KEYS)]
    mb = [b.memts(key_of(k)) for k in range(N_KEYS)]
    if ma != mb:
        raise AssertionError("memts differs between card and CPU")
    xa, _ = a.export_state()
    xb, _ = b.export_state()
    bad = [k for k in xa if not np.array_equal(xa[k], xb[k])]
    if bad:
        raise AssertionError(f"fabric state differs: {bad}")


def check_outputs(res, fab, serving) -> None:
    """The repo's own invariants on the replayed stream."""
    st = fab.stats()
    if st["inval_msgs"] != 0 or st["bytes_l1_l2"] != 64 * st["l1_to_l2"] \
            or st["bytes_l2_mm"] != 64 * st["l2_to_mm"] \
            or st["bytes_inter_gpu"] != 64 * st["pcie_blocks"]:
        raise AssertionError(f"counter identities broke: {st}")
    if st["tsu_evictions"] == 0:
        raise AssertionError("the TSU never evicted: the table did not fill")
    # a key whose TSU entry was evicted (8192 keys hash unevenly over
    # 8 x 1024 entries) reads as absent; every other read is a published
    # value with a version >= 1
    served = [r for batch in serving.served for r in batch]
    if any(r is not None and (r[1] is None or r[1] < 1) for r in served):
        raise AssertionError("a served result carries no version")
    if sum(r is None for r in served) > len(served) // 4:
        raise AssertionError("most reads found no entry")
    if res.n_requests != N_REQUESTS:
        raise AssertionError("replay lost requests")


def check_no_sync(torch, np) -> None:
    """The miss path of ``read_batch_async`` enqueues its device work
    without waiting for the card: no host sync before ``.result()``."""
    fab = build_fabric(torch.device("cuda"))
    keys = [key_of(k) for k in range(MAX_BATCH)]
    fab.write_batch([(k, "x") for k in keys], replica=0)
    fab.fence()
    fab.read_batch(keys[:8], replica=1)         # warm pinned pool + caches
    torch.cuda.synchronize()
    kids = np.asarray([fab._keys[k] for k in keys], np.int32)
    torch.cuda.set_sync_debug_mode("error")
    try:
        decode = fab._read_misses_dispatch(keys, kids, np.arange(8, len(keys)),
                                           1)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    if decode is None or any(r is None for r in decode()):
        raise AssertionError("the miss pass did not serve the batch")


def capacity_replay(torch, np, fab, trace):
    """Closed-loop capacity on the wall clock: every request arrives at
    once, so the waves are the same on every rank of a fabric group."""
    from repro_torch.runtime import scheduler
    serving = Serving(fab)
    pol = scheduler.BatchPolicy(mode="continuous", max_batch=MAX_BATCH,
                                min_bucket=8)
    torch.cuda.synchronize()
    cap = scheduler.replay(serving, trace.scaled(1e9), pol,
                           republish_every=REPUBLISH_EVERY,
                           republish_n=REPUBLISH_N)
    torch.cuda.synchronize()
    cap_rps = cap.n_requests / max(cap.t_end, 1e-9)
    return cap, {"capacity_rps": cap_rps,
                 "capacity_p50_us": float(np.percentile(cap.latency_s * 1e6,
                                                        50)),
                 "capacity_p99_us": float(np.percentile(cap.latency_s * 1e6,
                                                        99)),
                 "capacity_waves": len(cap.batch_sizes)}


def wall_replays(torch, np, fab, trace):
    """Closed-loop capacity, then open-loop at 0.7x capacity, wall clock."""
    from repro_torch.runtime import scheduler
    cap, out = capacity_replay(torch, np, fab, trace)
    cap_rps = out["capacity_rps"]
    svc_wave = cap.t_end / max(len(cap.batch_sizes), 1)
    serving = Serving(fab)
    pol = scheduler.BatchPolicy(mode="continuous", max_batch=MAX_BATCH,
                                min_bucket=8,
                                max_wait_s=max(1.5 * svc_wave, 1e-3))
    tr = trace.scaled(0.7 * cap_rps / trace.offered_rps)
    res = scheduler.replay(serving, tr, pol, republish_every=REPUBLISH_EVERY,
                           republish_n=REPUBLISH_N)
    torch.cuda.synchronize()
    lat = res.latency_s * 1e6
    out.update({"offered_rps": 0.7 * cap_rps,
                "achieved_rps": res.n_requests / max(res.t_end, 1e-9),
                "p50_us": float(np.percentile(lat, 50)),
                "p99_us": float(np.percentile(lat, 99)),
                "waves": len(res.batch_sizes),
                "mean_batch": float(np.mean(res.batch_sizes)),
                "svc_wave_us": svc_wave * 1e6})
    return out


def profile_replay(torch, fab, trace):
    """``--profile``: one closed-loop replay under ``torch.profiler``.
    Returns the device's busy time (the union of its kernel and copy
    intervals) against the wall clock, device time by kernel name and the
    host's top operators by self time."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.runtime import scheduler
    serving = Serving(fab)
    pol = scheduler.BatchPolicy(mode="continuous", max_batch=MAX_BATCH,
                                min_bucket=8)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        res = scheduler.replay(serving, trace.scaled(1e9), pol,
                               republish_every=REPUBLISH_EVERY,
                               republish_n=REPUBLISH_N)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    out = device_breakdown(prof, wall_us)
    waves = len(res.batch_sizes)
    out.update({"requests": res.n_requests, "waves": waves,
                "device_events_per_wave": out["device_events"]
                / max(waves, 1)})
    return out


# device symbol of each kernel, as the profiler names it
KERNEL_SYMBOLS = {"lease_probe": ("lease_probe_kernel",),
                  "miss_round": ("miss_round_kernel",),
                  "write_grant": ("write_grant_kernel",),
                  "rmsnorm": ("rmsnorm_reg_kernel", "rmsnorm_elem_kernel"),
                  "flash_attention": ("flash_kernel", "flash_split_kernel",
                                      "flash_wgmma_kernel"),
                  "decode_attention": ("decode_cluster_kernel",),
                  "ssd_chunk": ("ssd_wgmma_kernel", "ssd_output_kernel",
                                "ssd_state_kernel"),
                  "rmsnorm_bwd": ("rmsnorm_bwd_reg", "rmsnorm_bwd_rows",
                                  "rmsnorm_bwd_dw"),
                  "flash_attention_bwd": ("flash_bwd_wgmma_dq",
                                          "flash_bwd_wgmma_dkdv",
                                          "flash_bwd_rows", "flash_bwd_dkdv",
                                          "flash_bwd_dq"),
                  "ssd_chunk_bwd": ("ssd_bwd_wgmma_query_kernel",
                                    "ssd_bwd_wgmma_key_kernel",
                                    "ssd_bwd_wgmma_chunk_kernel",
                                    "ssd_bwd_wgmma_da_kernel",
                                    "ssd_bwd_key_kernel",
                                    "ssd_bwd_query_kernel",
                                    "ssd_bwd_chunk_kernel",
                                    "ssd_bwd_da_kernel")}


def device_breakdown(prof, wall_us):
    """From a ``torch.profiler`` run over ``wall_us`` of wall clock: the
    device's busy time (the union of its kernel and copy intervals) and
    idle share, device time by kernel name, the ported kernels' share and
    the host's top operators by self time."""
    from torch.autograd import DeviceType
    # a scheduled profiler's step ranges ("ProfilerStep#N") are mirrored
    # on the device as annotations spanning the whole step: not work
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA
           and not e.name.startswith("ProfilerStep")]
    if not dev:
        raise AssertionError("the profiler recorded no device activity")
    spans = sorted((e.time_range.start, e.time_range.end) for e in dev)
    busy_us, (lo, hi) = 0.0, spans[0]
    for s, e in spans[1:]:
        if s > hi:
            busy_us += hi - lo
            lo, hi = s, e
        else:
            hi = max(hi, e)
    busy_us += hi - lo
    by_name = collections.defaultdict(lambda: [0, 0.0])
    for e in dev:
        by_name[e.name][0] += 1
        by_name[e.name][1] += e.time_range.elapsed_us()
    averages = prof.key_averages()
    top_dev = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:15]
    ported = {name: [n for n in by_name if any(sym in n for sym in syms)]
              for name, syms in KERNEL_SYMBOLS.items()}
    top_host = sorted(((a.key, a.count, a.self_cpu_time_total)
                       for a in averages if a.self_cpu_time_total > 0
                       and not a.key.startswith("ProfilerStep")),
                      key=lambda r: -r[2])[:15]
    # the all-gathers: c10d calls, their host time, NCCL's kernels (gloo's
    # copies are not told apart from the others)
    gathers = [a for a in averages if a.key == "c10d::allgather_"]
    calls = sum(a.count for a in gathers)
    coll = {"calls": calls,
            "host_us": sum(a.cpu_time_total for a in gathers),
            "device_us": sum(us for n, (_, us) in by_name.items()
                             if "nccl" in n.lower())}
    coll["host_us_per_call"] = coll["host_us"] / max(calls, 1)
    coll["device_us_per_call"] = coll["device_us"] / max(calls, 1)
    return {"wall_us": wall_us, "device_busy_us": busy_us,
            "device_idle_share": 1.0 - busy_us / wall_us,
            "device_events": len(dev),
            "device_by_name": [{"name": n[:120], "count": c, "us": us}
                               for n, (c, us) in top_dev],
            "ported_kernels": {
                k: {"count": sum(by_name[n][0] for n in names),
                    "us": sum(by_name[n][1] for n in names),
                    "symbols": [n[:120] for n in names]}
                for k, names in ported.items()},
            "host_by_op": [{"op": k[:120], "count": c, "self_us": us}
                           for k, c, us in top_host],
            "collective_us": coll}


def profile_calls(torch, fn, calls, counter=None):
    """``calls`` calls of ``fn`` under ``torch.profiler``, each followed
    by a device sync (the serving loop's steps end in one anyway): the
    device's busy time per call and ``device_breakdown``'s tables.  The
    sync keeps a call's kernels inside its step: a lone SDPA call, still
    running when the window closed, once left the trace with no device
    event.  One more call runs first, in the profiler's warm-up step
    (tracing prepared, nothing kept): started with no warm-up, the
    profiler missed the first device events of its window (a layer's
    first kernels; once one of 272 decode launches).
    ``counter``, a kernel wrapper: its launches during the recorded
    calls, as ``launches``."""
    from torch.profiler import ProfilerActivity, profile, schedule
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=calls,
                                   repeat=1)) as prof:
        fn()
        torch.cuda.synchronize()
        prof.step()
        n0 = counter.launches if counter is not None else 0
        t0 = time.perf_counter()
        for k in range(calls):
            fn()
            torch.cuda.synchronize()
            if k < calls - 1:
                prof.step()
        wall_us = (time.perf_counter() - t0) * 1e6
        prof.step()          # ends the window: the trace's processing
                             # stays out of the wall clock
    out = device_breakdown(prof, wall_us)
    out.update({"calls": calls,
                "device_ms_per_call": out["device_busy_us"] / calls / 1e3})
    if counter is not None:
        out["launches"] = counter.launches - n0
    return out


# ------------------------------------------------------------- phase 4
def serve_waves(np, vocab, n_waves, max_new, batch=SERVE_B,
                prompt_len=PROMPT_LEN):
    """``n_waves`` waves of ``batch`` requests; request i's prompt is
    drawn with seed i % batch (``launch/serve.py``'s rule), so every
    wave is one decode group with wave 1's group prompt."""
    from repro_torch.runtime.server import Request
    prompts = [np.random.default_rng(seed).integers(
        2, vocab, prompt_len).astype(np.int32) for seed in range(batch)]
    reqs = [Request(rid=i, prompt=prompts[i % batch], max_new=max_new)
            for i in range(n_waves * batch)]
    return [reqs[w * batch:(w + 1) * batch] for w in range(n_waves)]


def leaves(tree):
    """The tensors of a payload ``(cache tree, first ids)``, in order."""
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in leaves(tree[k])]
    if isinstance(tree, tuple):
        return [t for x in tree for t in leaves(x)]
    return [tree]


def named_leaves(tree, path=""):
    """(path, tensor) for each leaf of a dict tree, in sorted-key order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in named_leaves(tree[k], f"{path}/{k}")]
    return [(path, tree)]


def compare_grads(a, b, device="cpu") -> dict:
    """Two (loss, named gradient leaves) results, the leaves in the same
    order: the loss's relative error, the whole gradient's relative L2
    (from per-leaf sums), the worst leaf's of at least PER_LEAF_MIN
    values, each smaller leaf's, and every leaf's (relative L2, size)
    under "leaves".  A leaf zero on both sides (hubert's unused token
    embedding) is left out; one zero only in ``b`` raises.  The sums run
    on ``device`` (phase 11 passes the card, idle then: deepseek's 5.36 B
    values take minutes on the host)."""
    (la, ga), (lb, gb) = a, b
    num = den = 0.0
    per_leaf = {}
    for (path, x), (_, y) in zip(ga, gb):
        x, y = x.to(device).float(), y.to(device).float()
        d2, n2 = float((x - y).square().sum()), float(y.square().sum())
        num, den = num + d2, den + n2
        if n2 == 0.0:
            if d2:
                raise AssertionError(f"{path}: zero on one side only")
            continue
        per_leaf[path] = ((d2 / n2) ** 0.5, y.numel())
    return {"loss": abs(la - lb) / abs(lb), "gradient": (num / den) ** 0.5,
            "worst_leaf": max(e for e, n in per_leaf.values()
                              if n >= PER_LEAF_MIN),
            "small_leaves": {k: round(e, 5) for k, (e, n) in
                             per_leaf.items() if n < PER_LEAF_MIN},
            "leaves": per_leaf}


def held_by_f32(card, cpu, cpu32, keys, device="cpu"):
    """The rule for bf16 gradients that differ card vs CPU more than
    MODEL_REL_L2 (the two devices round to bf16 in different places, and
    sums of cancelling terms keep that rounding): for each key, "gradient"
    for the whole or a leaf's path, the card's and the CPU's bf16 distance
    from the CPU's f32 gradient ``cpu32``; the card's may be at most
    BF16_FROM_F32 x the CPU's.  Returns ({key: (card, cpu)}, the keys
    beyond it).  Without "gradient" only the named leaves are compared."""
    if "gradient" not in keys:
        card, cpu, cpu32 = ((loss, [(p, t) for p, t in named if p in keys])
                            for loss, named in (card, cpu, cpu32))
    c = compare_grads(card, cpu32, device)
    h = compare_grads(cpu, cpu32, device)

    def pick(e, k):
        return e["gradient"] if k == "gradient" else e["leaves"][k][0]
    held = {k: (pick(c, k), pick(h, k)) for k in keys}
    return held, [k for k, (x, y) in held.items() if x > BF16_FROM_F32 * y]


def compare_servers(a, b, what) -> None:
    """Lease-cache counters, fabric counters and grant log: exact."""
    if a.cache_stats != b.cache_stats:
        raise AssertionError(f"{what}: lease-cache counters differ: "
                             f"{a.cache_stats} vs {b.cache_stats}")
    if a.fabric_stats != b.fabric_stats:
        raise AssertionError(f"{what}: fabric counters differ")
    if list(a.fabric.grant_log) != list(b.fabric.grant_log):
        raise AssertionError(f"{what}: grant logs differ")


def rel_l2(a, b) -> float:
    a, b = a.float().cpu(), b.float().cpu()
    return float((a - b).norm() / b.norm())


def serve_timings(torch, np, cfg, srv, tokens, max_new):
    """Prefill and decode-step times at the serving shapes: wall clock
    with the server's per-step host sync and the host's enqueue time per
    step, then the device's busy time per prefill and per decode step
    from ``torch.profiler`` (the union of its kernel and copy
    intervals)."""
    from repro_torch.models import decode_step, init_cache, prefill
    S = tokens.shape[1]

    def run_prefill():
        return prefill(cfg, srv.params, tokens,
                       init_cache(cfg, srv.B, srv.max_len, tokens.device))

    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        nxt, cache = run_prefill()
        nxt.cpu()
        walls.append(time.perf_counter() - t0)
    host, steps = [], []
    ids0, cache0 = nxt, cache
    for t in range(max_new - 1):
        t0 = time.perf_counter()
        nxt, cache = decode_step(cfg, srv.params, cache, nxt[:, None],
                                 S + t)
        t1 = time.perf_counter()
        nxt.cpu()
        host.append(t1 - t0)
        steps.append(time.perf_counter() - t0)
    from repro_torch.kernels.decode_attention import decode_attention
    prof_prefill = profile_calls(torch, lambda: run_prefill()[0].cpu(), 2)
    prof_decode = profile_calls(
        torch, lambda: decode_step(cfg, srv.params, cache0, ids0[:, None],
                                   S)[0].cpu(), 8, counter=decode_attention)
    prof_decode["decode_attention_calls"] = prof_decode["launches"]
    return {"prefill_ms": statistics.median(walls) * 1e3,
            "prefill_device_ms": prof_prefill["device_ms_per_call"],
            "decode_step_ms": statistics.mean(steps) * 1e3,
            "decode_host_ms": statistics.mean(host) * 1e3,
            "decode_device_ms": prof_decode["device_ms_per_call"],
            "profile_prefill": prof_prefill, "profile_decode": prof_decode}


def kernel_wrappers():
    """Every kernel wrapper, each with its launch count."""
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_bwd)
    from repro_torch.kernels.lease_probe import lease_probe
    from repro_torch.kernels.rmsnorm import rmsnorm, rmsnorm_bwd
    from repro_torch.kernels.ssd_chunk import ssd_chunk, ssd_chunk_bwd
    from repro_torch.kernels.tier_pass import miss_round, write_grant
    return (rmsnorm, flash_attention, decode_attention, ssd_chunk,
            lease_probe, miss_round, write_grant, rmsnorm_bwd,
            flash_attention_bwd, ssd_chunk_bwd)


def forward_layers(torch, cfg, params, tokens, inputs=None):
    """``models.forward`` with the hidden state after every block
    recorded: (h_final, [h after block 0, 1, ...]).  ``inputs``, a list,
    also gets each block's (kind, params, input)."""
    from repro_torch.models import forward
    from repro_torch.models import model as model_mod
    hs, apply = [], model_mod._apply_block

    def record(cfg_, desc, bp, h, **kw):
        if inputs is not None:
            inputs.append((desc.kind, bp, h))
        h, nc, aux = apply(cfg_, desc, bp, h, **kw)
        hs.append(h)
        return h, nc, aux

    model_mod._apply_block = record
    try:
        with torch.no_grad():
            h, _ = forward(cfg, params, tokens)
    finally:
        model_mod._apply_block = apply
    return h, hs


def ssd_variants():
    """The card's arithmetic for ``layer_errors``, each a stand-in for
    ``kernels.ops._ssd_chunk`` and a setting of cuBLAS's bf16 products
    (``allow_bf16_reduced_precision_reduction``): the routed kernel with y
    in f32 (the model's call) with reduced-precision reductions allowed
    (PyTorch's default) and refused (the reference's XLA ``dot`` sums in
    f32 and rounds once), the CUDA-core kernels with y in f32, and the
    earlier arithmetic (the CUDA-core kernels, y rounded to x's dtype
    before the inter-chunk part is added)."""
    from repro_torch.kernels.ssd_chunk import ssd_chunk
    simt = lambda *a, **kw: ssd_chunk(*a, path="simt", **kw)
    return {"wgmma, y f32": (ssd_chunk, True),
            "wgmma, y f32, bf16 sums in f32": (ssd_chunk, False),
            "simt, y f32": (simt, True),
            "simt, y bf16": (lambda *a, **kw: ssd_chunk(*a, path="simt"),
                             True)}


def layer_errors(torch, cfg, params, tokens, h_host, hs_host):
    """F2: the card-vs-CPU relative L2 of the hidden state after each
    layer, for each of ``ssd_variants``' arithmetic on the card (the CPU
    side is the plain version, y in f32)."""
    from repro_torch.kernels import ops
    mm = torch.backends.cuda.matmul
    routed, flag = ops._ssd_chunk, mm.allow_bf16_reduced_precision_reduction
    out = {}
    try:
        for name, (fn, reduced) in ssd_variants().items():
            ops._ssd_chunk = fn
            mm.allow_bf16_reduced_precision_reduction = reduced
            h, hs = forward_layers(torch, cfg, params, tokens.to("cuda"))
            out[name] = [rel_l2(a, b) for a, b in zip(hs, hs_host)] \
                + [rel_l2(h, h_host)]
    finally:
        ops._ssd_chunk = routed
        mm.allow_bf16_reduced_precision_reduction = flag
    return out


def f32_reference(torch, cfg, params, params_host, tokens, hs_host):
    """F2: the bf16 model on the card and on the CPU (``hs_host``: the
    CPU's hidden state after each block, then after the final norm), each
    against the same model, its weights the bf16 ones upcast, computed in
    f32 on the CPU: relative L2 after each layer and the final norm.
    Which device is nearer the exact arithmetic."""
    import dataclasses

    from repro_torch.models.model import tree_map
    f32 = torch.float32
    cfg32 = dataclasses.replace(cfg, policy=dataclasses.replace(
        cfg.policy, compute_dtype=f32, cache_dtype=f32))
    p32 = tree_map(lambda t: t.to(f32) if t.is_floating_point() else t,
                   params_host)
    h32, hs32 = forward_layers(torch, cfg32, p32, tokens)
    h_c, hs_c = forward_layers(torch, cfg, params, tokens.to("cuda"))
    want = hs32 + [h32]
    return {"card bf16 vs CPU f32": [rel_l2(a, b) for a, b in
                                     zip(hs_c + [h_c], want)],
            "CPU bf16 vs CPU f32": [rel_l2(a, b) for a, b in
                                    zip(hs_host, want)]}


def ssm_step_errors(torch, cfg, bp, h, dev="cuda"):
    """F2: one SSM block (``bp``, the CPU's parameters; ``h``, its bf16
    input on the CPU) split into the steps of ``models.ssm.ssm_apply``'s
    prefill, each run on the CPU and on the card.  Three rows of the
    card's relative L2 against the CPU after each step: ``own``, each
    step from the SAME input (the CPU's output of the step before, copied
    to the card), the step's own difference; ``chained``, the card's
    steps fed their own outputs from the same block input, the
    difference as it builds up inside the block; ``chained, the CPU's
    dt`` the same with the card's dt replaced by the CPU's, which shows
    how much of it comes in through the decay exponent (cum = cumsum(dt
    A) over a chunk, about -50: a relative change of dt moves exp(cum)
    by about 50 times as much)."""
    import torch.nn.functional as F

    from repro_torch.models import ssm as S
    from repro_torch.models.layers import rmsnorm
    p, cd = bp["ssm"], h.dtype
    d_in, H, Pd, G, N = S.ssm_dims(cfg)
    B_, S_ = h.shape[:2]
    xw = d_in + 2 * G * N
    steps = (
        ("pre-norm", ("h", "ln"), lambda x, w: rmsnorm(x, w, cfg.rms_eps),
         "hn"),
        ("in_proj", ("hn", "in_proj"), lambda x, w: x @ w.to(cd), "zx"),
        ("conv", ("zx", "conv_w", "conv_b"), lambda zx, w, b:
         S._causal_conv(zx[..., d_in:d_in + xw], w.to(cd), b.to(cd)), "conv"),
        ("silu", ("conv",), lambda x: F.silu(x.float()).to(cd), "xc"),
        ("softplus", ("zx", "dt_bias"), lambda zx, b: F.softplus(
            zx[..., d_in + xw:].float() + b.float()), "dt"),
        ("ssd_chunked", ("xc", "dt", "A_log"), lambda xc, dt, a: S.ssd_chunked(
            xc[..., :d_in].reshape(B_, S_, H, Pd), dt, -torch.exp(a.float()),
            xc[..., d_in:d_in + G * N].reshape(B_, S_, G, N),
            xc[..., d_in + G * N:].reshape(B_, S_, G, N),
            min(cfg.ssd_chunk, S_))[0], "y4"),
        ("skip", ("y4", "xc", "D_skip"), lambda y4, xc, d: (
            y4.float() + d.float()[None, None, :, None]
            * xc[..., :d_in].reshape(B_, S_, H, Pd).float()
        ).reshape(B_, S_, d_in).to(cd), "y"),
        ("gate", ("y", "zx"), lambda y, zx: (
            y.float() * F.silu(zx[..., :d_in].float())).to(cd), "g"),
        ("gated norm", ("g", "norm_w"),
         lambda g, w: rmsnorm(g, w, cfg.rms_eps), "gn"),
        ("out_proj", ("gn", "out_proj"), lambda g, w: g @ w.to(cd), "o"),
        ("residual", ("h", "o"), lambda h, o: h + o, "out"))
    cpu = {"h": h, "ln": bp["ln"], **p}
    for _, ins, fn, name in steps:
        cpu[name] = fn(*(cpu[k] for k in ins))
    card = {k: v.to(dev) for k, v in cpu.items()}
    out = {"own": {}, "chained": {}, "chained, the CPU's dt": {}}
    for step, ins, fn, name in steps:
        out["own"][step] = rel_l2(fn(*(card[k] for k in ins)), cpu[name])
    for row, keep in (("chained", ()), ("chained, the CPU's dt", ("dt",))):
        env = {k: card[k] for k in ("h", "ln", *p)}
        for step, ins, fn, name in steps:
            env[name] = card[name] if name in keep else \
                fn(*(env[k] for k in ins))
            out[row][step] = rel_l2(env[name], cpu[name])
    return out


def check_serving(torch, np, dev, arch, *, need, n_waves=N_WAVES,
                  max_new=MAX_NEW, model_layers=CPU_MODEL_LAYERS,
                  full=True, batch=SERVE_B, prompt_len=PROMPT_LEN,
                  max_len=MAX_LEN, model_batch=CPU_MODEL_BATCH,
                  decode_check=0, layers=None):
    """A serving path at full width on the card (phases 4, 5, 9 and 10):
    every launch count set to 0 just before the waves and read just
    after; the kernels in ``need`` must have launched.  ``full`` adds the
    ``serve_stream`` and CPU-server comparisons; ``decode_check`` > 0
    also holds that many decode steps' hidden states, card vs CPU, in
    the model check (both sides decode the card's tokens); ``layers``
    cuts the served model's depth.  A MoE model's layers are each held to
    ``moe_by_token`` on the card, and its card-vs-CPU check leaves out
    the tokens whose experts split at a near-tie (``RouteLog``)."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ssd_chunk import ssd_chunk
    from repro_torch.models import cast_params, forward, init_cache, \
        init_model
    from repro_torch.models.model import tree_map, unembed_matrix
    from repro_torch.runtime.server import Server

    cfg = configs.get(arch)
    if layers:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    waves = serve_waves(np, cfg.vocab, n_waves, max_new, batch, prompt_len)
    t0 = time.perf_counter()
    params = init_model(cfg, torch.Generator(dev).manual_seed(WEIGHT_SEED))
    srv = Server(cfg, params, batch_size=batch, max_len=max_len,
                 device=dev)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in leaves(params))
    log(f"  {arch}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.n_heads}/{cfg.n_kv_heads} heads, vocab {cfg.vocab}, "
        f"{n_params / 1e9:.3f} B parameters; weights on the card in "
        f"{time.perf_counter() - t0:.1f} s")
    posted = []
    put = srv.kv.put_batch
    srv.kv.put_batch = lambda items: (posted.extend(items), put(items))

    counters = kernel_wrappers()
    for fn in counters:
        fn.launches = 0
    flash_routes = flash_attention.route_launches
    flash_routes.update(dict.fromkeys(flash_routes, 0))
    flash_attention.stats_writes = 0
    ssd_routes = ssd_chunk.route_launches
    ssd_routes.update(dict.fromkeys(ssd_routes, 0))
    out, walls, hits, snap = {}, [], [], None
    t_all = time.perf_counter()
    for w, wave in enumerate(waves):
        t0 = time.perf_counter()
        out.update(srv.serve(wave))
        walls.append(time.perf_counter() - t0)
        hits.append(srv.cache_stats["hits"])
        if w == 0:
            snap = [t.clone() for t in leaves(posted[0][1])]
    serve_s = time.perf_counter() - t_all
    torch.cuda.synchronize()
    launches = {fn.__name__: fn.launches for fn in counters}
    log(f"  card: {n_waves} waves x {batch} requests, prompts "
        f"{prompt_len}, {max_new} new tokens: "
        f"{', '.join(f'{x:.2f}' for x in walls)} s per wave; lease hits "
        f"after each wave {hits}; launches {launches}")
    if hits[1] < 1:
        raise AssertionError("wave 2 was not served from a lease")
    missing = [name for name in need if launches[name] < 1]
    if missing:
        raise AssertionError(f"{missing} not launched: {launches}")
    if launches["rmsnorm_bwd"] or launches["flash_attention_bwd"] or \
            launches["ssd_chunk_bwd"]:
        raise AssertionError(f"serving launched a backward kernel: "
                             f"{launches}")
    if "flash_attention" in need:
        # bf16 at D = 64 (256 for gemma3): every prefill on the
        # tensor-core kernel, none on the CUDA-core one
        log(f"  flash_attention routes: {flash_routes}; launches that "
            f"wrote row statistics: {flash_attention.stats_writes}")
        if flash_routes["wgmma"] < 1 or flash_routes["simt"]:
            raise AssertionError(f"flash routes {flash_routes}: the "
                                 "prefills did not all take the tensor-core "
                                 "kernel")
        if flash_attention.stats_writes:
            raise AssertionError("a prefill without grad wrote the "
                                 "backward's row statistics")
    if "ssd_chunk" in need:
        # bf16 at P = 64, N = 64 or 128: every SSM layer of the prefills on
        # the tensor-core kernel
        log(f"  ssd_chunk routes: {ssd_routes}")
        if ssd_routes["wgmma"] < 1 or ssd_routes["simt"]:
            raise AssertionError(f"ssd_chunk routes {ssd_routes}: the "
                                 "prefills did not all take the tensor-core "
                                 "kernel")
    if len(posted) != 1 or not all(
            torch.equal(a, b) for a, b in zip(snap, leaves(posted[0][1]))):
        raise AssertionError("the prefix payload changed while decoding "
                             "from it")
    want = {i: out[i % batch] for i in range(n_waves * batch)}
    for rid, toks in out.items():
        if toks.shape != (max_new,) or toks.dtype != np.int32 or \
                toks.min() < 0 or toks.max() >= cfg.vocab:
            raise AssertionError(f"request {rid}: bad tokens {toks}")
        if not np.array_equal(toks, want[rid]):
            raise AssertionError(f"request {rid}: a lease hit decoded "
                                 "other tokens than the prefill wave")
    log(f"  wave 2 served from a lease; the prefix payload is bit-identical "
        f"after decoding from it; waves 2-{n_waves} give wave 1's tokens")
    rep = {"launches": launches, "lease_hits": hits, "wave_s": walls,
           "serve_s": serve_s, "n_params": n_params,
           "tokens_per_s": n_waves * batch * max_new / serve_s,
           "hit_wave_tokens_per_s": batch * max_new
           / statistics.mean(walls[1:])}
    tok = torch.from_numpy(np.stack([r.prompt for r in waves[0]]))
    if cfg.n_experts:
        rep["moe_layers"] = check_moe_layers(torch, np, cfg, srv.params,
                                             tok.to(dev))

    if full:
        # the CPU server that checks the fabric runs in a worker process
        # while the card runs serve_stream, the model check and the timings
        pool = concurrent.futures.ProcessPoolExecutor(
            1, mp_context=multiprocessing.get_context("spawn"))
        cpu_future = pool.submit(
            cpu_server_side, dataclasses.replace(
                cfg, n_layers=CPU_FABRIC_LAYERS), waves, batch, max_len,
            SERVE_CPU_THREADS)
        srv_s = Server(cfg, params, batch_size=batch, max_len=max_len,
                       device=dev)
        t0 = time.perf_counter()
        out_s = srv_s.serve_stream(iter(waves))
        stream_s = time.perf_counter() - t0
        if out_s.keys() != out.keys() or any(
                not np.array_equal(out_s[r], out[r]) for r in out):
            raise AssertionError("serve_stream tokens differ from serve")
        compare_servers(srv_s, srv, "serve_stream vs serve")
        log(f"  serve_stream == sequential serve (tokens, counters, grant "
            f"log): {stream_s:.2f} s vs {serve_s:.2f} s")
        rep["stream_s"] = stream_s

    cfg4 = dataclasses.replace(cfg, n_layers=model_layers)
    p4 = cast_params(cfg4, init_model(
        cfg4, torch.Generator(dev).manual_seed(WEIGHT_SEED)))
    t0 = time.perf_counter()
    p4h = tree_map(lambda t: t.cpu(), p4)
    copy_s = time.perf_counter() - t0
    tok4 = tok[:model_batch]
    t0 = time.perf_counter()
    routes = RouteLog(torch, np, cfg4.top_k)
    with routes:
        if decode_check:
            # the prompt through a cache on both devices, then decode steps
            L = prompt_len + decode_check + 8
            with torch.no_grad():
                h_c, c_c = forward(cfg4, p4, tok4.to(dev), cache=init_cache(
                    cfg4, model_batch, L, dev))
                h_h, c_h = forward(cfg4, p4h, tok4, cache=init_cache(
                    cfg4, model_batch, L, "cpu"))
        else:
            with torch.no_grad():
                h_c, _ = forward(cfg4, p4, tok4.to(dev))
            blocks = []
            h_h, hs_h = forward_layers(torch, cfg4, p4h, tok4, blocks)
        keep = routes.agreed(h_c.shape[0] * h_c.shape[1])
        lg_c = h_c[:, -1] @ unembed_matrix(cfg4, p4)
        lg_h = h_h[:, -1] @ unembed_matrix(cfg4, p4h)
        last = keep.view(h_c.shape[:2])[:, -1]
        errs = {"hidden_rel_l2": rel_l2(
                    h_c.reshape(-1, h_c.shape[-1])[keep.to(dev)],
                    h_h.reshape(-1, h_h.shape[-1])[keep]),
                "logits_rel_l2": rel_l2(lg_c[last.to(dev)], lg_h[last])}
        if decode_check:
            dec, ids = [], torch.argmax(lg_c.float(), -1)
            with torch.no_grad():
                for t in range(decode_check):
                    x = ids[:, None].to(torch.int32)
                    hd_c, c_c = forward(cfg4, p4, x, cache=c_c,
                                        pos=prompt_len + t)
                    hd_h, c_h = forward(cfg4, p4h, x.cpu(), cache=c_h,
                                        pos=prompt_len + t)
                    k_t = routes.agreed(hd_c.shape[0])
                    if k_t.any():
                        dec.append(rel_l2(hd_c[k_t.to(dev)], hd_h[k_t]))
                    ids = torch.argmax((hd_c[:, -1] @ unembed_matrix(
                        cfg4, p4)).float(), -1)
            if not dec:
                raise AssertionError("every decode step's token split its "
                                     "MoE routing card vs CPU")
            errs["decode_hidden_rel_l2"] = max(dec)
        routes.check()
    limit = MODEL_REL_L2_BY_ARCH.get(arch, MODEL_REL_L2)
    if not all(torch.isfinite(t).all() for t in (h_c, lg_c)) or \
            max(errs.values()) > limit:
        raise AssertionError(f"card vs CPU model at {model_layers} "
                             f"layers: {errs} (limit {limit})")
    log(f"  card == CPU model at {model_layers} layers "
        f"({[cfg4.layer_kind(i) for i in range(model_layers)]}, windows "
        f"{[cfg4.attn_window(i) for i in range(model_layers)]}), full "
        f"width, batch {model_batch}, bf16"
        + (f", then {decode_check} decode steps (relative L2 each: "
           f"{', '.join(f'{e:.4f}' for e in dec)})" if decode_check else "")
        + f", {time.perf_counter() - t0:.1f} s (weights to the host "
        f"{copy_s:.1f} s): relative L2 {errs} <= {limit}"
        + (f"; MoE routing split at a near-tie on {routes.split} of "
           f"{routes.tokens} tokens, left out" if cfg4.n_experts else ""))
    rep.update({"model_errs": errs, "cache_stats": srv.cache_stats,
                "fabric_stats": srv.fabric_stats,
                "model_check_split_tokens": routes.split})
    if routes.split:
        # not held: the split tokens' hidden states follow other experts
        rep["hidden_rel_l2_all_tokens"] = rel_l2(h_c, h_h)
        log(f"  (relative L2 of the hidden states over every token, the "
            f"split ones too: {rep['hidden_rel_l2_all_tokens']:.4f})")
    if "ssd_chunk" in need:
        per = layer_errors(torch, cfg4, p4, tok4, h_h, hs_h)
        rep["layer_errs"] = per
        kinds = [cfg4.layer_kind(i) for i in range(model_layers)]
        log(f"  card vs CPU relative L2 after each layer {kinds} and after "
            "the final norm, by the card's ssd_chunk arithmetic:")
        for name, errs_l in per.items():
            log(f"    {name}: {', '.join(f'{e:.5f}' for e in errs_l)}")
        f32 = f32_reference(torch, cfg4, p4, p4h, tok4, hs_h + [h_h])
        rep["f32_layer_errs"] = f32
        log("  F2: relative L2 against the same model in f32 on the CPU "
            "after each layer and the final norm:")
        for name, errs_l in f32.items():
            log(f"    {name}: {', '.join(f'{e:.5f}' for e in errs_l)}")
        # the second SSM block, split into its steps, each from the CPU's
        # input to it
        _, bp, h_in = [b for b in blocks if b[0] == "ssm"][1]
        steps = ssm_step_errors(torch, cfg4, bp, h_in)
        rep["ssm_step_errs"] = steps
        log("  card vs CPU relative L2 after each step of SSM block 2 "
            "(own: from the same input; chained: from the same block "
            "input):")
        for row, errs_s in steps.items():
            log(f"    {row}: " + ", ".join(f"{k} {v:.5f}"
                                          for k, v in errs_s.items()))

    tm = serve_timings(torch, np, cfg, srv, tok.to(dev), max_new)
    tm["decode_device_idle_share"] = \
        1.0 - tm["decode_device_ms"] / tm["decode_step_ms"]
    rep.update(tm)
    if "decode_attention" in need:
        # one kernel per decode_attention call: a single device symbol,
        # launched as often as the wrapper counted
        dec = tm["profile_decode"]["ported_kernels"]["decode_attention"]
        calls = tm["profile_decode"]["decode_attention_calls"]
        if len(dec["symbols"]) != 1 or dec["count"] != calls or calls < 1:
            raise AssertionError(f"decode_attention: {calls} calls, device "
                                 f"kernels {dec}")
        log(f"  decode_attention is one kernel a call: {calls} calls, "
            f"{dec['count']} launches of {dec['symbols'][0][:60]}")
    log(f"  prefill (B={batch}, S={prompt_len}) {tm['prefill_ms']:.1f} ms "
        f"wall, {tm['prefill_device_ms']:.1f} ms device; decode step "
        f"{tm['decode_step_ms']:.2f} ms wall (host enqueue "
        f"{tm['decode_host_ms']:.2f} ms, device "
        f"{tm['decode_device_ms']:.2f} ms, idle share "
        f"{tm['decode_device_idle_share']:.2f}); {rep['tokens_per_s']:.0f} "
        f"generated tokens/s over the {n_waves} waves, "
        f"{rep['hit_wave_tokens_per_s']:.0f} in a lease-hit wave")
    for what in ("prefill", "decode"):
        prof = tm[f"profile_{what}"]
        top = ", ".join(f"{r['name'][:40]} {r['us'] / prof['calls']:.0f} us"
                        for r in prof["device_by_name"][:4])
        host = ", ".join(f"{r['op']} {r['self_us'] / prof['calls'] / 1e3:.2f}"
                         f" ms" for r in prof["host_by_op"][:4])
        ported = {k: f"{v['us'] / prof['calls']:.0f} us x {v['count'] // prof['calls']}"
                  for k, v in prof["ported_kernels"].items() if v["count"]}
        log(f"  a profiled {what}: {prof['device_events'] / prof['calls']:.0f}"
            f" device events; device by kernel: {top}; ported kernels per "
            f"call {ported}; host by op (self): {host}")
    if full:
        t0 = time.perf_counter()
        srv_h, cpu_s = cpu_future.result()
        pool.shutdown()
        compare_servers(srv, srv_h, "card vs CPU")
        log(f"  card == CPU ({CPU_FABRIC_LAYERS} layers, {cpu_s:.1f} s in a "
            f"worker process beside the card's checks and timings, "
            f"{time.perf_counter() - t0:.1f} s waited for): lease-cache "
            f"counters {srv.cache_stats}, fabric counters, grant log "
            f"({len(srv.fabric.grant_log)} grants)")
        rep["cpu_fabric_check_s"] = cpu_s
    return launches, rep


def cpu_server_side(cfg, waves, batch, max_len, threads):
    """The CPU server of ``check_serving``'s fabric check, run in a worker
    process: ``cfg``'s seeded weights on the CPU serving ``waves``; returns
    its counters and grant log (as ``compare_servers`` reads them) and
    seconds."""
    import types

    import torch

    from repro_torch.models import init_model
    from repro_torch.runtime.server import Server
    torch.set_num_threads(threads)
    srv = Server(cfg, init_model(cfg, torch.Generator().manual_seed(
        WEIGHT_SEED)), batch_size=batch, max_len=max_len, device="cpu")
    t0 = time.perf_counter()
    for wave in waves:
        srv.serve(wave)
    return types.SimpleNamespace(
        cache_stats=srv.cache_stats, fabric_stats=srv.fabric_stats,
        fabric=types.SimpleNamespace(grant_log=list(srv.fabric.grant_log))), \
        time.perf_counter() - t0


# ------------------------------------------------------------- phase 10
def route_split(np, g_c, g_h, k):
    """One MoE layer's gates [T, E] on the card (``g_c``) and the CPU
    (``g_h``): (the tokens whose top-k experts differ, the experts in
    those differences).  Each such token must sit at a near-tie of the
    CPU's gates (its k-th and (k+1)-th within NEAR_TIE), else raise."""
    top_c = np.sort(np.argsort(-g_c, -1, kind="stable")[:, :k], -1)
    top_h = np.sort(np.argsort(-g_h, -1, kind="stable")[:, :k], -1)
    differs = (top_c != top_h).any(-1)
    srt = -np.sort(-g_h, -1)
    gap = (srt[:, k - 1] - srt[:, k]) / srt[:, k - 1]
    if (gap[differs] > NEAR_TIE).any():
        raise AssertionError(f"MoE routing split card vs CPU away from a "
                             f"near-tie: gaps {gap[differs]}")
    experts = set()
    for a, b in zip(top_c[differs], top_h[differs]):
        experts |= set(a.tolist()) ^ set(b.tolist())
    return differs, experts


class RouteLog:
    """While active, every MoE layer's f32 gates ``[T, E]`` as
    ``models.moe.route`` computes them, in call order (a card forward, then
    the same forward on the CPU).  ``agreed`` pairs the card's calls with
    the CPU's since the last call and returns a ``[T]`` mask of the tokens
    whose top-k experts agree in every layer; a token whose experts split
    must sit at a near-tie of the CPU's gates (``NEAR_TIE``), a discrete
    choice the two devices' bf16 roundings upstream may flip; ``check``
    then holds the split tokens to at most one in eight of all compared.
    A model without MoE layers records nothing and keeps every token."""

    def __init__(self, torch, np, k):
        from repro_torch.models import moe
        self.torch, self.np, self.k, self.moe = torch, np, k, moe
        self.calls, self.split, self.tokens = [], 0, 0

    def __enter__(self):
        self.route = self.moe.route

        def rec(cfg, p, x):
            out = self.route(cfg, p, x)
            self.calls.append(out[0].detach().cpu().numpy())
            return out
        self.moe.route = rec
        return self

    def __exit__(self, *exc):
        self.moe.route = self.route

    def agreed(self, n_tokens):
        np, k = self.np, self.k
        calls, self.calls = self.calls, []
        half = len(calls) // 2
        keep = np.ones(n_tokens, bool)
        for g_c, g_h in zip(calls[:half], calls[half:]):
            differs, _ = route_split(np, g_c, g_h, k)
            keep &= ~differs
        self.split += int((~keep).sum())
        self.tokens += n_tokens
        return self.torch.from_numpy(keep)

    def check(self):
        if self.split * 8 > self.tokens:
            raise AssertionError(f"MoE routing split card vs CPU on "
                                 f"{self.split} of {self.tokens} tokens")


def moe_by_token(torch, np, cfg, p, h):
    """The MoE block's definition on the card in f32, token by token and
    with no dispatch buffer: each token's top-k experts by its gates
    (softmax of its router logits, taken in the compute dtype, as the
    block's; picked by repeated argmax, the lower index first on ties;
    renormalised over the k), its choices taken in token order, each
    kept while its expert has had fewer than C (the capacity: T k / E
    times the capacity factor, rounded up to a multiple of 8, at least 8);
    the output the sum of each kept choice's gate times its expert's
    SwiGLU of the token, plus the shared experts'.  Returns (out [T, D]
    f32, kept choices, dropped choices)."""
    import math

    import torch.nn.functional as F
    x = h.reshape(-1, h.shape[-1])
    T, E, k = x.shape[0], cfg.n_experts, cfg.top_k
    C = max(8, math.ceil(math.ceil(T * k / E * cfg.capacity_factor) / 8) * 8)
    g = torch.softmax((x @ p["router"].to(x.dtype)).float(), -1)
    topi, topv = [], []
    for _ in range(k):
        i = torch.argmax(g, -1)
        topi.append(i)
        topv.append(g.gather(1, i[:, None])[:, 0])
        g = g.scatter(1, i[:, None], -1.0)
    topi, topv = torch.stack(topi, 1), torch.stack(topv, 1)
    topv = topv / torch.clamp(topv.sum(-1, keepdim=True), min=1e-9)
    fe = topi.reshape(-1).cpu().numpy()
    seen = np.zeros(E, np.int64)
    kept = np.zeros(T * k, bool)
    for j, e in enumerate(fe):
        kept[j] = seen[e] < C
        seen[e] += 1
    xf = x.float()
    out = torch.zeros_like(xf)
    gate = topv.reshape(-1)
    for e in np.unique(fe[kept]):
        js = torch.from_numpy(np.nonzero(kept & (fe == e))[0]).to(x.device)
        tok = js // k
        xe = xf[tok]
        y = (F.silu(xe @ p["wg"][e].float()) * (xe @ p["wi"][e].float())) \
            @ p["wo"][e].float()
        out.index_add_(0, tok, y * gate[js][:, None])
    if cfg.n_shared_experts:
        sp = p["shared"]
        out += (F.silu(xf @ sp["wg"].float()) * (xf @ sp["wi"].float())) \
            @ sp["wo"].float()
    return out, int(kept.sum()), int((~kept).sum())


def check_moe_layers(torch, np, cfg, params, tokens):
    """Every MoE layer of a forward over ``tokens`` on the card: its block
    output against ``moe_by_token`` on the same input, within a relative
    L2 of ``MODEL_REL_L2`` (the block computes in bf16); a wrong slot,
    drop or gate cannot pass.  Logs each layer's routed and dropped
    choices."""
    from repro_torch.models import forward
    from repro_torch.models import moe
    seen, apply = [], moe.moe_apply

    def record(cfg_, p, h, **kw):
        out = apply(cfg_, p, h, **kw)
        seen.append((p, h, out[0]))
        return out

    moe.moe_apply = record
    try:
        with torch.no_grad():
            forward(cfg, params, tokens)
    finally:
        moe.moe_apply = apply
    rows = []
    for p, h, got in seen:
        want, routed, dropped = moe_by_token(torch, np, cfg, p, h)
        err = rel_l2(got.reshape(want.shape), want)
        rows.append({"routed": routed, "dropped": dropped, "rel_l2": err})
        if not err <= MODEL_REL_L2:
            raise AssertionError(f"MoE layer {len(rows)} vs its token-by-"
                                 f"token evaluation: relative L2 {err}")
    log(f"  MoE layers == their token-by-token evaluation in f32 "
        f"({tokens.shape[0]} x {tokens.shape[1]} tokens, top-{cfg.top_k} of "
        f"{cfg.n_experts}): " + "; ".join(
            f"layer {i + 1}: {r['routed']} routed, {r['dropped']} dropped, "
            f"relative L2 {r['rel_l2']:.4f}" for i, r in enumerate(rows)))
    return rows


def check_phase10(torch, np, dev):
    """deepseek-v2 (MLA and MoE) and llama4-maverick (MoE) served at full
    width and cut depth, each built on the card in its bf16-param policy
    and freed before the next: the serving checks, the MoE layers against
    their token-by-token evaluation, card vs CPU, peak memory; every
    deepseek prefill's flash on the tensor-core kernel at (192, 128)."""
    counts, reps = {}, {}
    for arch, layers, new, model_layers, decode_check in PHASE10:
        t0 = time.perf_counter()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        need = ("rmsnorm", "flash_attention") + (
            () if arch == MLA_ARCH else ("decode_attention",))
        counts[arch], rep = check_serving(
            torch, np, dev, arch, need=need, n_waves=PHASE10_WAVES,
            max_new=new, model_layers=model_layers, full=False,
            batch=PHASE10_B, prompt_len=PHASE10_PROMPT,
            max_len=PHASE10_PROMPT + new + 8, model_batch=1,
            decode_check=decode_check, layers=layers)
        rep["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
        for what in ("prefill", "decode"):
            prof = rep[f"profile_{what}"]
            for name in ("flash_attention", "decode_attention"):
                kern = prof["ported_kernels"][name]
                rep[f"{name}_{what}_device_ms"] = \
                    kern["us"] / prof["calls"] / 1e3
        if arch == MLA_ARCH:
            syms = rep["profile_prefill"]["ported_kernels"][
                "flash_attention"]["symbols"]
            if not syms or any("flash_wgmma_kernel<192, 128>" not in n
                               for n in syms):
                raise AssertionError(f"{arch}: a prefill's flash was not the "
                                     f"tensor-core kernel at (192, 128): "
                                     f"{syms}")
        log(f"  {arch}: peak memory {rep['peak_memory_gb']:.1f} GB; flash "
            f"{rep['flash_attention_prefill_device_ms']:.3f} ms of device "
            f"time a prefill; {time.perf_counter() - t0:.0f} s for {arch}")
        reps[arch] = rep
        torch.cuda.empty_cache()
    return counts, reps


# ------------------------------------------------------------- phase 9
def zero_counts():
    """Every launch count (and flash's per-route counts) set to 0."""
    from repro_torch.kernels.flash_attention import flash_attention
    for fn in kernel_wrappers():
        fn.launches = 0
    flash_attention.route_launches.update(
        dict.fromkeys(flash_attention.route_launches, 0))


def read_counts():
    from repro_torch.kernels.flash_attention import flash_attention
    return ({fn.__name__: fn.launches for fn in kernel_wrappers()},
            dict(flash_attention.route_launches))


def check_frontend(torch, np, dev, arch):
    """hubert-xlarge's encoder on frames (all 48 layers) or llava-next-34b
    at VISION_LAYERS on 576 patch embeddings and text tokens, then its
    decode steps, at full width on the card: counts set to 0 just before
    and read just after; the card against the CPU port at a cut depth and
    batch; wall and device times."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.models import (cast_params, decode_step, forward,
                                    init_cache, init_model, prefill)
    from repro_torch.models.model import tree_map, unembed_matrix

    audio = arch == AUDIO_ARCH
    cfg = configs.get(arch)
    if not audio:
        cfg = dataclasses.replace(cfg, n_layers=VISION_LAYERS)
    B = AUDIO_B if audio else VISION_B
    S = AUDIO_FRAMES if audio else cfg.n_patch_tokens + VISION_TEXT
    rng = np.random.default_rng(WEIGHT_SEED)
    t0 = time.perf_counter()
    params = cast_params(cfg, init_model(
        cfg, torch.Generator(dev).manual_seed(WEIGHT_SEED)))
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in leaves(params))
    log(f"  {arch}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.n_heads}/{cfg.n_kv_heads} heads of {cfg.d_head}, "
        f"{n_params / 1e9:.3f} B parameters in bf16 on the card "
        f"({time.perf_counter() - t0:.1f} s)")
    if audio:
        inputs = {"frames": rng.standard_normal(
            (B, S, cfg.d_frontend)).astype(np.float32)}
        tokens = None
    else:
        # patch embeddings at the scale of the token embeddings (0.02)
        inputs = {"patches": (0.02 * rng.standard_normal(
            (B, cfg.n_patch_tokens, cfg.d_model))).astype(np.float32)}
        tokens = torch.from_numpy(rng.integers(
            2, cfg.vocab, (B, S)).astype(np.int32))
    card = {k: torch.from_numpy(v).to(dev, torch.bfloat16)
            for k, v in inputs.items()}
    tok_c = None if tokens is None else tokens.to(dev)
    max_len = S + (0 if audio else VISION_NEW + 8)

    def run_prefill():
        return prefill(cfg, params, tok_c, init_cache(cfg, B, max_len, dev),
                       **card)

    zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    nxt, cache = run_prefill()
    ids = [nxt.cpu()]
    steps = []
    for t in range(0 if audio else VISION_NEW - 1):
        t1 = time.perf_counter()
        nxt, cache = decode_step(cfg, params, cache, nxt[:, None], S + t)
        ids.append(nxt.cpu())
        steps.append(time.perf_counter() - t1)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches, routes = read_counts()
    ids = torch.stack(ids, 1)
    log(f"  card: prefill of {B} x {S} "
        + ("frames" if audio else f"({cfg.n_patch_tokens} patches + "
           f"{VISION_TEXT} tokens), {VISION_NEW - 1} decode steps")
        + f" in {run_s:.2f} s; launches {launches}; flash routes {routes}")
    if launches["flash_attention"] < 1 or routes["wgmma"] < 1 or \
            routes["wgmma"] != launches["flash_attention"]:
        raise AssertionError(f"{arch}: flash_attention did not take the "
                             f"tensor-core route on every prefill: {routes}")
    need = ("rmsnorm",) if audio else ("rmsnorm", "decode_attention")
    if any(launches[n] < 1 for n in need):
        raise AssertionError(f"{arch}: {need} not all launched: {launches}")
    if ids.min() < 0 or ids.max() >= cfg.vocab:
        raise AssertionError(f"{arch}: bad ids {ids}")

    # card vs CPU at a cut depth and batch, the same weights
    layers_ = AUDIO_MODEL_LAYERS if audio else VISION_MODEL_LAYERS
    nb = AUDIO_CPU_B if audio else VISION_CPU_B
    cfg_m = dataclasses.replace(cfg, n_layers=layers_)
    p_m = cast_params(cfg_m, init_model(
        cfg_m, torch.Generator(dev).manual_seed(WEIGHT_SEED)))
    p_h = tree_map(lambda t: t.cpu(), p_m)
    t0 = time.perf_counter()
    with torch.no_grad():
        h_c, _ = forward(cfg_m, p_m, None if tok_c is None else tok_c[:nb],
                         **{k: v[:nb] for k, v in card.items()})
        h_h, _ = forward(cfg_m, p_h, None if tokens is None else tokens[:nb],
                         **{k: v[:nb].cpu() for k, v in card.items()})
    lg_c = h_c[:, -1] @ unembed_matrix(cfg_m, p_m)
    lg_h = h_h[:, -1] @ unembed_matrix(cfg_m, p_h)
    errs = {"hidden_rel_l2": rel_l2(h_c, h_h),
            "logits_rel_l2": rel_l2(lg_c, lg_h)}
    if not all(torch.isfinite(t).all() for t in (h_c, lg_c)) or \
            max(errs.values()) > MODEL_REL_L2:
        raise AssertionError(f"{arch}: card vs CPU at {layers_} layers: "
                             f"{errs} (limit {MODEL_REL_L2})")
    log(f"  card == CPU model at {layers_} layers, full width, batch {nb}, "
        f"bf16, {time.perf_counter() - t0:.1f} s: relative L2 {errs} <= "
        f"{MODEL_REL_L2}")
    del p_m, p_h

    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run_prefill()[0].cpu()
        walls.append(time.perf_counter() - t0)
    prof = profile_calls(torch, lambda: run_prefill()[0].cpu(), 2)
    rep = {"launches": launches, "flash_routes": routes,
           "n_params": n_params, "layers": cfg.n_layers, "batch": B,
           "seq": S, "model_errs": errs,
           "prefill_ms": statistics.median(walls) * 1e3,
           "prefill_device_ms": prof["device_ms_per_call"],
           "flash_prefill_device_ms":
           prof["ported_kernels"]["flash_attention"]["us"] / 2e3,
           "profile_prefill": prof}
    if steps:
        rep["decode_step_ms"] = statistics.mean(steps[1:]) * 1e3
    log(f"  prefill {rep['prefill_ms']:.1f} ms wall, "
        f"{rep['prefill_device_ms']:.2f} ms device (flash "
        f"{rep['flash_prefill_device_ms']:.3f} ms in "
        f"{prof['ported_kernels']['flash_attention']['count'] // 2} "
        "launches)"
        + (f"; decode step {rep['decode_step_ms']:.2f} ms wall"
           if steps else ""))
    return launches, rep


def check_phase9(torch, np, dev):
    """gemma3-4b served at full width and depth (phase 4's checks, 1536-
    token prompts past the window, the model check with decode steps),
    then hubert-xlarge and llava-next-34b through ``prefill``."""
    t0 = time.perf_counter()
    launches, gem = check_serving(
        torch, np, dev, WINDOW_ARCH,
        need=("rmsnorm", "flash_attention", "decode_attention"),
        n_waves=WINDOW_WAVES, max_new=WINDOW_NEW,
        model_layers=WINDOW_MODEL_LAYERS, batch=WINDOW_B,
        prompt_len=WINDOW_PROMPT, max_len=WINDOW_MAX_LEN, model_batch=1,
        decode_check=WINDOW_DECODE_CHECK)
    for what in ("prefill", "decode"):
        prof = gem[f"profile_{what}"]
        for name in ("flash_attention", "decode_attention"):
            k = prof["ported_kernels"][name]
            gem[f"{name}_{what}_device_ms"] = k["us"] / prof["calls"] / 1e3
    log(f"  {WINDOW_ARCH}: flash_attention "
        f"{gem['flash_attention_prefill_device_ms']:.3f} ms of device time a "
        f"prefill, decode_attention "
        f"{gem['decode_attention_decode_device_ms']:.3f} ms a step "
        f"({time.perf_counter() - t0:.0f} s for {WINDOW_ARCH})")
    counts = {WINDOW_ARCH: launches}
    reps = {WINDOW_ARCH: gem}
    for arch in (AUDIO_ARCH, VISION_ARCH):
        t0 = time.perf_counter()
        counts[arch], reps[arch] = check_frontend(torch, np, dev, arch)
        log(f"  ({time.perf_counter() - t0:.0f} s for {arch})")
    return counts, reps


# ------------------------------------------------------------- phase 6
# The figure engine at the figure drivers' settings, copied here (the
# script imports nothing of the JAX package): benchmarks/fig7_speedup.py's
# GEOM, fig8_scaling.py's 16-GPU point (32 CUs a GPU, max(128,
# BASE_ROUNDS * 4 // 16) rounds with BASE_ROUNDS = 1024) and
# fig9_xtreme.py's SIZES at 4 x 32 CUs.  Since phase 11 joined the
# script, to hold its time, Fig. 7's traces are cut from the driver's 2048
# rounds to 1024 (the CPU side of the 2048-round sweep alone took 105 s),
# and to 512 since deepseek-v2 joined phase 11 (1024 rounds: 57.7 s on
# the CPU side, 26.7 on the card), and the Xtreme traces repeat each pass
# a fifth, a quarter and half as often as fig9_xtreme.py's (reps 10, 4, 2
# there: 6146 rounds, 60-71 s a side; half of each, 4610 rounds and 42-43 s
# a side, before deepseek-v2 joined phase 11)
FIG7_ROUNDS = 512
FIG7_GEOM = dict(pcie_lat=1000.0)
# the CPU side's intra-op threads: the card side is one host thread, and
# with 4 of the 8 the CPU side set the phase's length (147 s against 125)
PHASE6_CPU_THREADS = 6
FIG8_GPUS, FIG8_ROUNDS = 16, max(128, 1024 * 4 // 16)
XTREME_SIZES = ((24, 2, "192KB"), (96, 1, "768KB"), (384, 1, "3MB"))
# the paper's simulated geomean speedups over RDMA-WB-NC (Fig. 7, 4 GPUs)
FIG7_PAPER = {"RDMA-WB-C-HMG": 1.5, "SM-WB-NC": 3.9, "SM-WT-NC": 4.6,
              "SM-WT-C-HALCONE": 4.6}
# rounds of the HALCONE group profiled: 128 since phase 10 joined the
# script (512 before), to hold its time; the profiler's processing of
# ~300 device events a round and their host operators grows with the
# window, and a round's count and idle share are steady well before 128
PROFILE_ROUNDS = 128


def h2d_setup_cycles(cfg, touched_blocks: int) -> float:
    """RDMA systems pay explicit host->device copies (the paper's first
    reason shared memory wins, §5.1), prorated to the simulated slice
    (copied from benchmarks/fig7_speedup.py)."""
    if cfg.topology != "rdma":
        return 0.0
    return touched_blocks * 64 / 32.0  # 32 B/cycle PCIe4


class GroupRuns:
    """While entered, each static group ``engine.sweep`` or ``simulate``
    runs: its config names, rounds, cells, ``lease_probe`` launches and the
    host's time to enqueue its loop (the loop does not wait for the
    card)."""

    def __init__(self):
        self.rows = []

    def __enter__(self):
        from repro_torch.core import engine
        from repro_torch.kernels.lease_probe import lease_probe
        self._run = run = engine._run

        def counted(cfg, C, ops_t, *a, **kw):
            before, t0 = lease_probe.launches, time.perf_counter()
            out = run(cfg, C, ops_t, *a, **kw)
            self.rows.append({
                "configs": cfg.name, "protocol": cfg.protocol,
                "rounds": ops_t.shape[0], "cells": C * ops_t.shape[1],
                "lease_probe": lease_probe.launches - before,
                "enqueue_s": time.perf_counter() - t0})
            return out

        engine._run = counted
        return self

    def __exit__(self, *exc):
        from repro_torch.core import engine
        engine._run = self._run

    def check(self):
        """``lease_probe`` twice a round per group (L2, L1), three times
        under HMG (the home probe)."""
        for r in self.rows:
            want = (3 if r["protocol"] == "hmg" else 2) * r["rounds"]
            if r["lease_probe"] != want:
                raise AssertionError(f"{r['configs']}: lease_probe launched "
                                     f"{r['lease_probe']} times over "
                                     f"{r['rounds']} rounds, not {want}")


def compare_sweeps(np, a, b, what) -> None:
    """Card against CPU: counters equal, cycles within rtol 1e-6 (a per-GPU
    mean summed in another order)."""
    for k in a["counters"]:
        if not np.array_equal(a["counters"][k], b["counters"][k]):
            raise AssertionError(f"{what}: counter {k} differs card vs CPU")
    for k in ("cycles", "makespan_max"):
        if not np.allclose(a[k], b[k], rtol=1e-6, atol=0) or \
                not np.isfinite(a[k]).all() or (a[k] <= 0).any():
            raise AssertionError(f"{what}: {k} differs card vs CPU")


def compare_runs(np, torch, a, b, what) -> None:
    """Two ``simulate`` results: read and result logs and every state leaf
    bit-equal, counters equal."""
    if not np.array_equal(a["read_log"], b["read_log"]) or any(
            not np.array_equal(a["res_log"][k], b["res_log"][k])
            for k in a["res_log"]):
        raise AssertionError(f"{what}: logs differ card vs CPU")
    sa, sb = a["state"], b["state"]
    leaves = [(n, getattr(sa, n), getattr(sb, n)) for n in
              ("l2_dirty", "mm_ver", "dir_sharers", "time")]
    leaves += [(f"{t}.{f}", x, y) for t in ("l1", "l2", "tsu")
               for f, x, y in zip(getattr(sa, t)._fields, getattr(sa, t),
                                  getattr(sb, t))]
    bad = [n for n, x, y in leaves if not torch.equal(x.cpu(), y.cpu())]
    if bad or a["counters"] != b["counters"]:
        raise AssertionError(f"{what}: state {bad} or counters differ")


def card_sweep(engine, cfgs, ops, addrs):
    """One ``sweep`` on the card (``device=None``), with its groups'
    ``lease_probe`` launches (checked) and times."""
    runs = GroupRuns()
    with runs:
        t0 = time.perf_counter()
        card = engine.sweep(cfgs, ops, addrs)
        card_s = time.perf_counter() - t0
    runs.check()
    steps = sum(r["rounds"] for r in runs.rows)
    cell_rounds = sum(r["rounds"] * r["cells"] for r in runs.rows)
    return card, {"card_s": card_s, "groups": runs.rows,
                  "round_steps_per_s": steps / card_s,
                  "cell_rounds_per_s": cell_rounds / card_s,
                  "lease_probe_launches": [r["lease_probe"]
                                           for r in runs.rows]}


def log_sweep(what, rep) -> None:
    steps = sum(r["rounds"] for r in rep["groups"])
    enq = ", ".join(f"{r['enqueue_s']:.1f}" for r in rep["groups"])
    log(f"  {what}: card {rep['card_s']:.1f} s ({len(rep['groups'])} "
        f"groups, {steps} round steps, {rep['round_steps_per_s']:.0f} "
        f"round steps/s, {rep['cell_rounds_per_s']:.0f} cell-rounds/s; "
        f"host enqueue {enq} s), cpu {rep['cpu_s']:.1f} s; card == cpu "
        "(counters equal, cycles rtol 1e-6); lease_probe "
        f"{rep['lease_probe_launches']} launches = 2 a round per group, 3 "
        "under HMG")


def cpu_engine_side(jobs, threads):
    """Phase 6's CPU side, run in a worker process beside the card runs:
    each job ``(kind, cfg or cfgs, ops, addrs)`` through ``sweep`` or
    ``simulate`` on the CPU with ``threads`` intra-op threads; returns
    ``{name: (result, seconds)}`` (a ``simulate`` state as CPU
    tensors)."""
    import torch

    from repro_torch.core import engine
    torch.set_num_threads(threads)
    out = {}
    for name, (kind, cfg, ops, addrs) in jobs.items():
        t0 = time.perf_counter()
        fn = engine.sweep if kind == "sweep" else engine.simulate
        out[name] = (fn(cfg, ops, addrs, device="cpu"),
                     time.perf_counter() - t0)
    return out


def geomeans(np, cycles, names):
    base = cycles[names.index("RDMA-WB-NC")]
    return {n: float(np.exp(np.mean(np.log(base / cycles[i]))))
            for i, n in enumerate(names) if n != "RDMA-WB-NC"}


def check_engine_no_sync(torch, engine, sc, ops, addrs) -> None:
    """The round loop enqueues its device work with no host sync: each
    Fig. 7 group's loop and a ``simulate`` loop (with its result log) run
    8 rounds under ``set_sync_debug_mode("error")``, their inputs on the
    card already."""
    from repro_torch.coherence.fabric.backend import to_device
    dev = torch.device("cuda")
    n_addr = engine._next_pow2(int(addrs.max()) + 2)
    ops_t = to_device(ops[:, :, :8].transpose(2, 0, 1), dev)
    addrs_t = to_device(addrs[:, :, :8].transpose(2, 0, 1), dev)
    groups = [sc.stack_configs([mk(**FIG7_GEOM)]) for mk in sc.ALL_CONFIGS]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for g in groups:
            engine._run(g, 1, ops_t, addrs_t, n_addr, False)
        engine._run(groups[-1], 1, ops_t[:, :1], addrs_t[:, :1], n_addr,
                    True)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()


def check_litmus(np, torch, engine, sc, traces) -> None:
    """Fig. 5's litmus traces with ``simulate`` on the card, at the litmus
    tests' 2 GPUs x 2 CUs and at 4 x 32: card == CPU, and the read logs
    and clocks ``tests/test_protocol_litmus.py`` asserts."""
    for kw in (dict(n_gpus=2, cus_per_gpu=2), {}):
        cfg = sc.sm_wt_halcone(**kw)
        a = engine.simulate(cfg, *traces.litmus_intra(cfg))
        compare_runs(np, torch, a, engine.simulate(
            cfg, *traces.litmus_intra(cfg), device="cpu"), "Fig. 5(a)")
        log0, log1 = a["read_log"][0], a["read_log"][1]
        cts = a["state"].l1_cts[:2].tolist()
        if (log0[0], log0[3], log1[1], log1[5]) != (0, 0, 0, 1) or \
                cts != [11, 11]:
            raise AssertionError(f"Fig. 5(a): read logs {log0} {log1}, "
                                 f"clocks {cts}")
        b = engine.simulate(cfg, *traces.litmus_inter(cfg))
        compare_runs(np, torch, b, engine.simulate(
            cfg, *traces.litmus_inter(cfg), device="cpu"), "Fig. 5(b)")
        g0, g1 = b["read_log"][0], b["read_log"][cfg.cus_per_gpu]
        if (g0[0], g1[1], g0[3], g1[5]) != (0, 0, 0, 1) or \
                float(b["counters"]["l2_to_mm"]) < 4:
            raise AssertionError(f"Fig. 5(b): read logs {g0} {g1}")
    log("  Fig. 5 litmus with simulate on the card at 2x2 and 4x32 CUs: "
        "card == CPU (whole state, logs); (a) reads X 0, 0 at CU0, Y 0 "
        "then 1 at CU1 (the coherency miss), both clocks 11; (b) GPU1 "
        "re-reads Y = 1 from MM")


def check_engine(torch, np):
    """Phase 6: the figure engine on the card against the port on the
    CPU (see the module docstring).  The CPU side runs in one worker
    process (PHASE6_CPU_THREADS threads) while the card runs; the profile
    comes after it has ended."""

    from repro_torch.core import engine, sysconfig as sc, traces
    out = {}
    benches = list(traces.STANDARD)
    cfgs = [mk(**FIG7_GEOM) for mk in sc.ALL_CONFIGS]
    names = [c.name for c in cfgs]
    t0 = time.perf_counter()
    named = [traces.standard_trace(cfgs[-1], traces.STANDARD[b],
                                   FIG7_ROUNDS) for b in benches]
    ops, addrs = traces.pack_batch(named)
    cfg16 = sc.sm_wt_halcone(n_gpus=FIG8_GPUS, cus_per_gpu=32)
    t16 = traces.pack_batch([traces.standard_trace(
        cfg16, traces.STANDARD[b], FIG8_ROUNDS) for b in benches])
    xcfgs = [sc.sm_wt_halcone(), sc.sm_wt_nc()]
    xnamed = {f"X{v}/{label}": traces.xtreme(
        xcfgs[0], traces.XtremeSpec(v, nb, reps))
        for v in (1, 2, 3) for nb, reps, label in XTREME_SIZES}
    xops, xaddrs = traces.pack_batch(list(xnamed.values()))
    x1 = f"X1/{XTREME_SIZES[0][2]}"
    log(f"  traces: Fig. 7 11 benchmarks x {cfgs[0].n_cus} CUs x "
        f"{FIG7_ROUNDS} rounds, Fig. 8 x {cfg16.n_cus} CUs x {FIG8_ROUNDS}, "
        f"9 Xtreme of {xops.shape[2]} rounds, in "
        f"{time.perf_counter() - t0:.1f} s")
    jobs = {"fig7": ("sweep", cfgs, ops, addrs),
            "fig8_16gpu": ("sweep", [cfg16], *t16),
            "fig9": ("sweep", xcfgs, xops, xaddrs),
            "x1": ("simulate", xcfgs[0], *xnamed[x1])}
    with concurrent.futures.ProcessPoolExecutor(
            1, mp_context=multiprocessing.get_context("spawn")) as pool:
        cpu_future = pool.submit(cpu_engine_side, jobs, PHASE6_CPU_THREADS)
        check_engine_no_sync(torch, engine, sc, ops, addrs)
        log("  the round loop enqueues with no host sync (sync debug mode, "
            "every Fig. 7 group and a simulate loop)")
        card = {k: card_sweep(engine, *job[1:]) for k, job in jobs.items()
                if job[0] == "sweep"}
        t0 = time.perf_counter()
        card_x1 = engine.simulate(xcfgs[0], *xnamed[x1])
        x1_s = time.perf_counter() - t0
        check_litmus(np, torch, engine, sc, traces)
        cpu = cpu_future.result()
    log("  (the card's times below were taken while the CPU side ran in a "
        "second process)")
    for k, (res, rep) in card.items():
        compare_sweeps(np, res, cpu[k][0], k)
        rep["cpu_s"] = cpu[k][1]
        out[k] = rep
    compare_runs(np, torch, card_x1, cpu["x1"][0], f"{x1} {xcfgs[0].name}")

    # ---- Fig. 7: 5 systems x 11 benchmarks, one sweep
    log_sweep(f"Fig. 7, 5 x 11 cells, {FIG7_ROUNDS} rounds", out["fig7"])
    cyc = card["fig7"][0]["cycles"].astype(np.float64)
    touched = [len(np.unique(a[(o == 1) | (o == 2)])) for o, a in named]
    cyc_h2d = cyc + np.array([[h2d_setup_cycles(c, t) for t in touched]
                              for c in cfgs])
    gm, gm_h2d = geomeans(np, cyc, names), geomeans(np, cyc_h2d, names)
    out["fig7"].update({
        "benchmarks": benches, "configs": names, "cycles": cyc.tolist(),
        "cycles_h2d": cyc_h2d.tolist(), "geomean": gm, "geomean_h2d": gm_h2d,
        "counters": {k: v.tolist() for k, v in
                     card["fig7"][0]["counters"].items()}})
    log("  Fig. 7 simulated cycles (the modelled 4-GPU system's, not a "
        f"speed of any chip), kcycles, benchmarks {benches}:")
    for n, row in zip(names, cyc):
        log(f"    {n:16s} " + " ".join(f"{x / 1e3:8.1f}" for x in row))
    log("  geomean speedup over RDMA-WB-NC: raw / with the h2d staging "
        "term / the paper's: " + "; ".join(
            f"{n} {gm[n]:.2f}x / {gm_h2d[n]:.2f}x / {FIG7_PAPER[n]}x"
            for n in gm))

    # ---- Fig. 8's 16-GPU point: 11 x 512 lanes
    log_sweep(f"Fig. 8 at {FIG8_GPUS} GPUs x 32 CUs, 11 x {cfg16.n_cus} "
              f"lanes, {FIG8_ROUNDS} rounds", out["fig8_16gpu"])
    cyc16 = card["fig8_16gpu"][0]["cycles"][0]
    out["fig8_16gpu"]["cycles"] = cyc16.tolist()
    log("  Fig. 8 16-GPU cycles, kcycles: " + " ".join(
        f"{b} {x / 1e3:.1f}" for b, x in zip(benches, cyc16)))

    # ---- Fig. 9's Xtreme suite as fig9_xtreme.py runs it: 9 traces in
    # one batch, HALCONE and SM-WT-NC
    log_sweep(f"Fig. 9, 2 x 9 Xtreme cells, {xops.shape[2]} rounds",
              out["fig9"])
    xc = card["fig9"][0]["cycles"]
    slow = (xc[0] / xc[1] - 1) * 100
    out["fig9"]["slowdown_pct"] = dict(zip(xnamed, slow.tolist()))
    log("  Fig. 9 HALCONE slowdown over SM-WT-NC, %: " + ", ".join(
        f"{k} {v:.1f}" for k, v in zip(xnamed, slow))
        + " (the paper's worst: 14.3 / 12.1 / 16.8 at 192KB)")
    out["simulate_x1"] = {"card_s": x1_s, "cpu_s": cpu["x1"][1]}
    log(f"  simulate {x1} on {xcfgs[0].name}, {xnamed[x1][0].shape[1]} "
        f"rounds: card {x1_s:.1f} s, cpu {cpu['x1'][1]:.1f} s, card == "
        "CPU (whole state, logs)")

    # ---- one group under the profiler: the device's share of the loop
    t0 = time.perf_counter()
    prof = profile_calls(torch, lambda: engine.sweep(
        [cfgs[-1]], ops[:, :, :PROFILE_ROUNDS],
        addrs[:, :, :PROFILE_ROUNDS]), 1)
    prof["profile_s"] = time.perf_counter() - t0
    out["profile_halcone"] = prof
    lp = prof["ported_kernels"]["lease_probe"]
    top = ", ".join(f"{r['name'][:40]} {r['us']:.0f} us x {r['count']}"
                    for r in prof["device_by_name"][:5])
    log(f"  profiled: the HALCONE group, 11 cells, {PROFILE_ROUNDS} rounds: "
        f"wall {prof['wall_us'] / 1e3:.1f} ms, device busy "
        f"{prof['device_busy_us'] / 1e3:.1f} ms, idle share "
        f"{prof['device_idle_share']:.3f}, "
        f"{prof['device_events'] / PROFILE_ROUNDS:.0f} device events a "
        f"round; lease_probe {lp['us'] / 1e3:.2f} ms in {lp['count']} "
        f"launches; device by kernel: {top} (profiled and processed in "
        f"{prof['profile_s']:.1f} s)")
    return out


# ------------------------------------------------------------- phase 7
def tsu_shapes(fab) -> dict:
    a = fab._af
    return {"tsu": tuple(a.tsu.tag.shape), "tsu_memts":
            tuple(a.tsu.memts.shape), "tsu_ver": tuple(a.tsu_ver.shape),
            "tsu_gseq": tuple(a.tsu_gseq.shape),
            "tsu_seq": tuple(a.tsu_seq.shape),
            "tsu_nseq": tuple(a.tsu_nseq.shape)}


def observables(fab, serving) -> dict:
    """What phase 7 holds against phase 3's CPU replay: served results,
    grant log, counters, replica counters, every key's ``memts``."""
    return {"served": list(serving.served), "grant_log": list(fab.grant_log),
            "stats": fab.stats(),
            "replica_stats": [fab.replica_stats(r)
                              for r in range(fab.n_replicas)],
            "memts": [fab.memts(key_of(k)) for k in range(N_KEYS)]}


class ExchangeClock:
    """Host seconds a sharded fabric spends entering and leaving its
    passes (``_xin``: wait for the gathered table; ``_xout``: keep the
    owned rows, issue the next gather), and the number of passes."""

    def __init__(self, fab):
        self.s, self.passes = 0.0, 0
        xin, xout = fab._xin, fab._xout

        def timed_in():
            t = time.perf_counter()
            out = xin()
            self.s += time.perf_counter() - t
            self.passes += 1
            return out

        def timed_out():
            t = time.perf_counter()
            xout()
            self.s += time.perf_counter() - t

        fab._xin, fab._xout = timed_in, timed_out


def fabric_rank(rank: int, world: int, backend: str, rdzv: str,
                out_path: str) -> None:
    """One rank of a phase-7 world (``chip_smoke.py --fabric-rank``): phase
    3's warm and modeled replay through ``BatchedKVLease`` on the sharded
    fabric over a fabric group on the card, the ``c10d`` collectives of
    each replay call by pass, the coherence kernels' launches on this
    rank; then the wall-clock replays and one closed-loop replay under
    ``torch.profiler`` over the trace's first ``FABRIC_PROFILE_REQUESTS``.
    Pickles what it saw to ``out_path``."""
    stage = {"begin": time.perf_counter()}
    import dataclasses
    import datetime
    import pickle

    import numpy as np
    import torch
    import torch.distributed as dist
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.coherence.fabric import (ShardedArrayFabric,
                                              default_fabric)
    from repro_torch.kernels.lease_probe import lease_probe
    from repro_torch.kernels.tier_pass import miss_round, write_grant
    from repro_torch.launch.mesh import make_fabric_group
    from repro_torch.runtime import loadgen

    if backend == "nccl":
        torch.cuda.set_device(rank)
    # ranks that share the host split its CPU threads
    torch.set_num_threads(max(1, len(os.sched_getaffinity(0)) // world))
    dist.init_process_group(
        backend, init_method=f"file://{rdzv}", rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=FABRIC_RANK_TIMEOUT_S))
    group = make_fabric_group(8, backend=backend)
    # a world of one is the degenerate layout (default_fabric picks the
    # single-device fabric there, as the reference does on one device)
    fab = (default_fabric(fabric_config(), 2, 2, group=group) if world > 1
           else ShardedArrayFabric(fabric_config(), 2, 2, group=group))
    kernels = (lease_probe, miss_round, write_grant)
    for fn in kernels:
        fn.launches = 0
    trace = phase3_trace(loadgen)
    stage["start"] = time.perf_counter()
    _, serving, res, warm_s, rep_s, rounds = replay_modeled(
        None, trace, fab=fab, count=True)
    torch.cuda.synchronize()
    stage["replay"] = time.perf_counter()
    arrays, host = fab.export_state()
    out = {"type": type(fab).__name__, "n_shard_devices": fab.n_shard_devices,
           "device": str(fab.device), "shapes": tsu_shapes(fab),
           "launches": {fn.__name__: fn.launches for fn in kernels},
           "rounds": dict(rounds), "warm_s": warm_s, "replay_s": rep_s,
           "waves": len(res.batch_sizes), "n_requests": res.n_requests,
           "collectives": dict(serving.collectives),
           "export": (arrays, host), **observables(fab, serving)}
    # then, outside phase 3's trace: the found keys of one wave read twice
    # by the reader; the second batch is served by the replica tier alone
    keys = [key_of(k) for k in range(MAX_BATCH)]
    found = [k for k, r in zip(keys, fab.read_batch(keys, replica=1))
             if r is not None]
    serving.read_batch_async(found, 1).result()
    out["collectives"] = dict(serving.collectives)
    stage["observe"] = time.perf_counter()
    # the open-loop replay forms its waves from each rank's own clock, so
    # ranks of a world of two would diverge: they replay closed-loop only,
    # and check that their waves agree
    clock = ExchangeClock(fab)
    if world == 1:
        out["wall"] = wall_replays(torch, np, fab, trace)
    else:
        cap, out["wall"] = capacity_replay(torch, np, fab, trace)
        waves = [None] * world
        dist.all_gather_object(waves, cap.batch_sizes, group=group)
        if any(w != waves[0] for w in waves):
            raise AssertionError("ranks formed different capacity waves")
    out["exchange_s"], out["exchange_passes"] = clock.s, clock.passes
    stage["wall"] = time.perf_counter()
    n = FABRIC_PROFILE_REQUESTS
    prof = profile_replay(torch, fab, dataclasses.replace(
        trace, t=trace.t[:n], kid=trace.kid[:n]))
    stage["profile"] = time.perf_counter()
    names = list(stage)
    out["stage_s"] = {b: stage[b] - stage[a] for a, b in zip(names, names[1:])}
    out["profile"] = {k: prof[k] for k in ("wall_us", "device_busy_us",
                                          "device_idle_share", "waves",
                                          "device_events_per_wave",
                                          "device_by_name", "host_by_op")}
    out["profile"]["collective_us"] = prof["collective_us"]
    dist.barrier()
    dist.destroy_process_group()
    with open(out_path, "wb") as f:
        pickle.dump(out, f)


def start_fabric_world(backend: str, world: int, tmp: pathlib.Path):
    """Start ``world`` ranks of ``fabric_rank``, rendezvous, results and
    each rank's output under ``tmp``; ``finish_fabric_world`` waits for
    them."""
    tmp.mkdir(parents=True, exist_ok=True)
    rdzv = tmp / "rdzv"
    rdzv.unlink(missing_ok=True)
    procs = []
    for r in range(world):
        with open(tmp / f"log{r}.txt", "w") as out:
            procs.append(subprocess.Popen(
                [sys.executable, str(ROOT / "chip_smoke.py"),
                 "--fabric-rank", str(r), str(world), backend, str(rdzv),
                 str(tmp / f"out{r}.pkl")],
                stdout=out, stderr=subprocess.STDOUT))
    return procs, tmp, time.monotonic() + 2 * FABRIC_RANK_TIMEOUT_S


def stop_ranks(procs) -> None:
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()


def finish_fabric_world(backend: str, world: int, started):
    """Every rank's results of a world ``start_fabric_world`` started.  A
    rank that fails or outlasts ``FABRIC_RANK_TIMEOUT_S`` plus the replay
    fails the phase, and every rank is stopped."""
    import pickle
    procs, tmp, deadline = started
    try:
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        raise AssertionError(f"phase 7: a {backend} rank of {world} did "
                             "not finish in time")
    finally:
        stop_ranks(procs)
    for r, p in enumerate(procs):
        if p.returncode != 0:
            text = (tmp / f"log{r}.txt").read_text()
            raise AssertionError(f"phase 7: {backend} rank {r} of {world} "
                                 f"exited {p.returncode}:\n{text[-4000:]}")
    return [pickle.loads((tmp / f"out{r}.pkl").read_bytes())
            for r in range(world)]


def compare_observables(got, want, what) -> None:
    for key in ("served", "grant_log", "stats", "replica_stats", "memts"):
        if got[key] != want[key]:
            raise AssertionError(f"{what}: {key} differs")


def check_sharded(torch, np, fab_h, serv_h, rounds_h):
    """Phase 7: the sharded fabric on the card in each of
    ``FABRIC_WORLDS``, each rank held bit for bit against phase 3's CPU
    replay (whole state included) and the port's ``HostFabric`` on the
    same trace; collectives by pass, bytes gathered, capacity, idle share
    and time in the exchange per pass."""
    from repro_torch.coherence.fabric import HostFabric
    from repro_torch.runtime import loadgen
    want = observables(fab_h, serv_h)
    xw, hw = fab_h.export_state()
    t0 = time.perf_counter()
    host = HostFabric(fabric_config(), n_nodes=2, replicas_per_node=2)
    _, serv_o, _, _, _, _ = replay_modeled(None, phase3_trace(loadgen),
                                           fab=host)
    oracle = observables(host, serv_o)
    host_s = time.perf_counter() - t0
    compare_observables(oracle, want, "HostFabric vs phase 3's CPU "
                        "replay")
    log(f"  HostFabric replays phase 3's trace in {host_s:.1f} s on the "
        "host: equal to phase 3's CPU replay")
    # one gather moves the packed owned rows of every rank: 6 planes of
    # [8, 1, 1025] int32 in all
    gathered_bytes = 6 * 8 * (1024 + 1) * 4
    report = {"host_fabric_s": host_s, "worlds": {}}
    tmp = ROOT / "build" / "phase7"
    # the worlds run at once (since phase 11 joined the script, to hold its
    # time), so their wall clocks share the host's CPUs
    t0 = time.perf_counter()
    started = {(b, w): start_fabric_world(b, w, tmp / f"{b}{w}")
               for b, w in FABRIC_WORLDS}
    done = {}
    try:
        for key in FABRIC_WORLDS:
            done[key] = (finish_fabric_world(*key, started.pop(key)),
                         time.perf_counter() - t0)
    finally:
        for procs, _, _ in started.values():
            stop_ranks(procs)
    for backend, world in FABRIC_WORLDS:
        ranks, wall_s = done[(backend, world)]
        rows = []
        for r, got in enumerate(ranks):
            what = f"{backend} world of {world}, rank {r}"
            if (got["type"], got["n_shard_devices"]) != (
                    "ShardedArrayFabric", world):
                raise AssertionError(f"{what}: {got['type']} over "
                                     f"{got['n_shard_devices']} ranks")
            compare_observables(got, want, what + " vs phase 3's CPU")
            compare_observables(got, oracle, what + " vs HostFabric")
            xg, hg = got["export"]
            bad = [k for k in xw if not np.array_equal(xg[k], xw[k])]
            if bad:
                raise AssertionError(f"{what}: fabric state differs: {bad}")
            # the write pass runs the same rounds; fences run the fence
            # pass here (phase 3's single-device fabric: the op scan)
            if got["rounds"].get("write") != rounds_h["write"]:
                raise AssertionError(f"{what}: rounds {got['rounds']}")
            want_shape = (8 // world, 1, 1025)
            if got["shapes"]["tsu"] != want_shape or \
                    got["shapes"]["tsu_nseq"] != (8 // world,):
                raise AssertionError(f"{what}: TSU rows {got['shapes']}")
            if min(got["launches"].values()) < 1:
                raise AssertionError(f"{what}: launches {got['launches']}")
            coll = got["collectives"]
            want_per = {"read, misses": 1, "read, all hit": 0, "write": 1,
                        "fence": 1}
            if len(coll.get("read, all hit", ())) != 1:
                raise AssertionError(f"{what}: the all-hit read batch was "
                                     f"not served by the replica tier")
            for kind, counts in coll.items():
                if set(counts) != {want_per[kind]}:
                    raise AssertionError(f"{what}: {kind} collectives per "
                                         f"call {sorted(set(counts))}")
            passes = sum(len(v) for k, v in coll.items()
                         if want_per[k] == 1)
            prof = got["profile"]
            row = {"rank": r, "device": got["device"],
                   "launches": got["launches"],
                   "collectives_per_call": {k: (len(v), sum(v))
                                            for k, v in coll.items()},
                   "passes_per_wave": passes / got["waves"],
                   "gathered_bytes_per_pass": gathered_bytes,
                   "gathered_bytes_per_wave": gathered_bytes * passes
                   / got["waves"],
                   "warm_s": got["warm_s"], "replay_s": got["replay_s"],
                   "wall": got["wall"],
                   "exchange_ms_per_pass": got["exchange_s"] * 1e3
                   / max(got["exchange_passes"], 1),
                   "device_idle_share": prof["device_idle_share"],
                   "collective_us": prof["collective_us"],
                   "profile": prof}
            rows.append(row)
            log(f"  {what} on {got['device']}: == phase 3's CPU replay and "
                "HostFabric (results, grant log, counters, replica "
                "counters, memts, whole state); TSU rows "
                f"{got['shapes']['tsu']}; launches {got['launches']}")
            log("    c10d collectives by pass (calls, collectives): "
                + ", ".join(f"{k} {n} / {c}" for k, (n, c) in
                            sorted(row["collectives_per_call"].items()))
                + f"; {row['passes_per_wave']:.2f} gathers a wave of "
                f"{gathered_bytes} B ({row['gathered_bytes_per_wave']:.0f}"
                " B a wave)")
            wall = got["wall"]
            open_loop = (f"; at 0.7x: p50 {wall['p50_us']:.0f} us, p99 "
                         f"{wall['p99_us']:.0f} us" if "p50_us" in wall
                         else "")
            log(f"    capacity {wall['capacity_rps']:.0f} req/s (closed "
                f"loop p50 {wall['capacity_p50_us']:.0f} us, p99 "
                f"{wall['capacity_p99_us']:.0f} us){open_loop}; exchange "
                f"{row['exchange_ms_per_pass']:.3f} ms of "
                "host a pass; profiled: idle share "
                f"{row['device_idle_share']:.3f}, collective "
                f"{prof['collective_us']['host_us_per_call']:.1f} us of host"
                f" and {prof['collective_us']['device_us_per_call']:.1f} us "
                "of device a call")
        report["worlds"][f"{backend}x{world}"] = {"wall_s": wall_s,
                                                 "ranks": rows}
        log(f"  {backend} world of {world}: {wall_s:.1f} s (rank 0: "
            + ", ".join(f"{k} {v:.1f} s" for k, v in
                        ranks[0]["stage_s"].items()) + ")")
    return report


# ------------------------------------------------------------------ main
# ------------------------------------------------------------- phase 8
def train_flops(cfg, params, B: int, S: int) -> float:
    """Model flops of one training step: 6 N a token for the weights
    (forward and backward, the tied unembedding included, a shared block
    once per use; the remat forward not counted), and 3x the forward's 4
    D flops a visible causal (query, key) pair per query head and
    attention layer; the SSD scan's own flops are not counted."""
    n_params = sum(t.numel() for t in leaves(params))
    uses = sum(1 for i in range(cfg.n_layers)
               if cfg.attn_every and (i + 1) % cfg.attn_every == 0)
    shared = sum(t.numel() for t in leaves(params.get("shared_attn", {})))
    if cfg.family == "hybrid":
        n_params += (uses - 1) * shared
    attn_layers = uses if cfg.family == "hybrid" else (
        0 if cfg.family == "ssm" else cfg.n_layers)
    attn = 12 * cfg.d_head * cfg.n_heads * B * _visible_pairs(S, S, True)
    return 6.0 * n_params * B * S + attn * attn_layers


def run_trainer(c, opt, tcfg, B, S, ckpt_dir, fail, device):
    """``c``'s ``Trainer`` on ``device`` with a failure at step ``fail``
    and a resume: (trainer, first run's losses by step, resumed losses by
    step, the resumed run's result)."""
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.runtime.trainer import Trainer, TrainerConfig
    tr = Trainer(c, opt, TrainerConfig(ckpt_dir=ckpt_dir, **tcfg),
                 data=SyntheticLM(c, DataConfig(global_batch=B, seq_len=S)),
                 device=device)
    try:
        tr.run(fail_at=fail)
    except RuntimeError as e:
        if "simulated node failure" not in str(e):
            raise
    else:
        raise AssertionError("the simulated failure did not happen")
    first = dict(tr.history)
    res = tr.resume()
    return tr, first, dict(tr.history[len(first):]), res


def cpu_trainer_side(c, opt, tcfg, ckpt_dir, fail, threads):
    """Phase 8's CPU trainer, run in a worker process beside the card's:
    (events, fabric counters, grant log, seconds)."""
    import torch
    torch.set_num_threads(threads)
    t0 = time.perf_counter()
    tr, _, _, res = run_trainer(c, opt, tcfg, TRAIN_CPU_B, TRAIN_CPU_S,
                                ckpt_dir, fail, torch.device("cpu"))
    return (tr.events, res["fabric_stats"], list(tr.fabric.grant_log),
            time.perf_counter() - t0)


def step_times(torch, step_fn, state, batch):
    """Three steps of ``step_fn`` on ``batch`` from ``state`` timed by the
    host clock (to the end of the enqueue, and to a sync after it), then
    two under ``torch.profiler``: (state, the median wall ms, the median
    host-enqueue ms, the profile).  Each step's state is the only
    reference to the one before, which it frees."""
    walls, hosts = [], []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, _ = step_fn(state, batch)
        hosts.append(time.perf_counter() - t0)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    box = [state]
    del state

    def one_step():
        box[0], m = step_fn(box[0], batch)
        float(m["loss"])
    prof = profile_calls(torch, one_step, 2)
    return (box[0], statistics.median(walls) * 1e3,
            statistics.median(hosts) * 1e3, prof)


def check_training(torch, np, dev, arch=ARCH, steps=TRAIN_STEPS,
                   ckpt=TRAIN_CKPT, fail=TRAIN_FAIL,
                   grad_layers=TRAIN_CPU_LAYERS, extras=True):
    """``arch`` trained at full width on the card through the port's
    ``Trainer``: ``steps`` steps of B = 8 rows of 512 tokens, a checkpoint
    every ``ckpt``, a simulated failure at step ``fail`` and a resume from
    the last checkpoint.  The resumed steps must repeat the first run's
    losses bit for bit, the losses must be finite and fall, every kernel
    of the path (the forward and backward float kernels the model runs,
    ``lease_probe`` under the checkpoint publish's op scan) must have
    launched, and the fabric's counters and grant log must equal a CPU
    trainer's on the same schedule (2 layers at full width; zamba2, whose
    looped tail has a fabric key a layer, all its layers at the smoke
    config's widths).  Then: the card's loss and gradients at
    ``grad_layers`` layers against the CPU's (relative L2 <= 2e-2 for the
    loss, the whole gradient and every leaf of at least PER_LEAF_MIN
    values, bf16; each per-head vector's error printed), a step's wall,
    host and device time under ``torch.profiler``, the backward kernels'
    share, peak memory, and with ``extras`` ``VmappedWorkers`` at 4
    layers with W = 1 and 4 and a checkpoint save."""
    import dataclasses
    import shutil

    from repro_torch import configs
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_bwd)
    from repro_torch.kernels.ssd_chunk import ssd_chunk_bwd
    from repro_torch.models import init_model
    from repro_torch.models.model import tree_map
    from repro_torch.models.training import loss_and_grads
    from repro_torch.optim import adamw
    from repro_torch.runtime.trainer import (TrainerConfig, param_keys,
                                            steady_events)

    cfg = configs.get(arch)
    if arch in PHASE8_LAYERS:
        cfg = dataclasses.replace(cfg, n_layers=PHASE8_LAYERS[arch])
    opt = adamw.AdamWConfig(lr=TRAIN_LR, warmup_steps=TRAIN_WARMUP,
                            total_steps=steps)
    tcfg = dict(total_steps=steps, ckpt_period=ckpt, keep=2)
    work = ROOT / "build" / "phase8"
    shutil.rmtree(work, ignore_errors=True)
    free = shutil.disk_usage(ROOT).free
    log(f"  {free / 1e9:.1f} GB free on the checkout's disk")
    rep = {"arch": arch, "steps": steps, "ckpt_period": ckpt,
           "fail_at": fail}

    # the fabric sees only the keys: a CPU trainer on short rows at the
    # smoke widths, 2 layers, or every layer where the keys depend on
    # depth (zamba2's looped tail); it runs in a worker process while the
    # card trains (at full width, 2 layers of smollm and mamba2 took 38.8
    # and 33.2 s there, longer than the card's run)
    small = dataclasses.replace(configs.SMOKE[arch],
                                n_layers=TRAIN_CPU_LAYERS)
    if param_keys(small) != param_keys(cfg):
        small = dataclasses.replace(configs.SMOKE[arch],
                                    n_layers=cfg.n_layers)
    if param_keys(small) != param_keys(cfg):
        raise AssertionError(f"the CPU trainer's fabric keys differ from "
                             f"{arch}'s")
    counters = kernel_wrappers()
    for fn in counters:
        fn.launches = 0
    bwd_routes = flash_attention_bwd.route_launches
    bwd_routes.update(dict.fromkeys(bwd_routes, 0))
    ssd_routes = ssd_chunk_bwd.route_launches
    ssd_routes.update(dict.fromkeys(ssd_routes, 0))
    flash_attention.stats_writes = 0
    with concurrent.futures.ProcessPoolExecutor(
            1, mp_context=multiprocessing.get_context("spawn")) as pool:
        cpu_future = pool.submit(cpu_trainer_side, small, opt, tcfg,
                                 str(work / "cpu"), fail, 4)
        t0 = time.perf_counter()
        tr, first, resumed, res = run_trainer(cfg, opt, tcfg, TRAIN_B,
                                              TRAIN_S, str(work / "card"),
                                              fail, dev)
        torch.cuda.synchronize()
        rep["run_s"] = time.perf_counter() - t0
        events, stats, grants, cpu_s = cpu_future.result()
    launches = {fn.__name__: fn.launches for fn in counters}
    losses = [first[s] for s in range(fail)] + [
        resumed[s] for s in range(fail, steps)]
    restored = next(e["step"] for e in tr.events if e["kind"] == "restore")
    log(f"  card: {steps} steps of {TRAIN_B} x {TRAIN_S} tokens, failure at "
        f"{fail}, resumed from the step-{restored} checkpoint: "
        f"{rep['run_s']:.1f} s; losses {[round(x, 4) for x in losses]}; "
        f"launches {launches}")
    again = {s: (first[s], resumed[s]) for s in range(restored, fail)}
    if any(a != b for a, b in again.values()):
        raise AssertionError(f"the resumed steps differ from the first "
                             f"run's: {again}")
    log(f"  resumed steps {sorted(again)} repeat the first run's losses "
        "bit for bit")
    if not np.all(np.isfinite(losses)) or not (
            np.mean(losses[-3:]) < np.mean(losses[:3])
            and losses[-1] < losses[0]):
        raise AssertionError(f"losses not finite or not falling: {losses}")
    # the publish is a write_batch of every parameter key on a one-shard
    # fabric: more rounds (a shard takes one write a round) than the write
    # pass's budget, so both packages serve it with the op scan, whose
    # probes run on lease_probe (write_grant never runs here)
    attends = cfg.family != "ssm"
    scans = cfg.family in ("ssm", "hybrid")
    need = ("rmsnorm", "rmsnorm_bwd", "lease_probe") + (
        ("flash_attention", "flash_attention_bwd") if attends else ()) + (
        ("ssd_chunk", "ssd_chunk_bwd") if scans else ())
    missing = [n for n in need if launches[n] < 1]
    if missing:
        raise AssertionError(f"{missing} not launched: {launches}")
    stray = [n for n in ("decode_attention", "flash_attention",
                         "flash_attention_bwd", "ssd_chunk",
                         "ssd_chunk_bwd") if n not in need and launches[n]]
    if stray:
        raise AssertionError(f"training {arch} launched {stray}: "
                             f"{launches}")
    if attends:
        # bf16 at D = 64: every backward on the tensor-core route, each
        # from the row statistics of a forward under grad
        log(f"  flash_attention_bwd routes {bwd_routes}; forwards that "
            f"wrote row statistics: {flash_attention.stats_writes}")
        if bwd_routes["wgmma"] != launches["flash_attention_bwd"] or \
                flash_attention.stats_writes < bwd_routes["wgmma"]:
            raise AssertionError(f"flash_attention_bwd routes {bwd_routes}, "
                                 f"{flash_attention.stats_writes} forwards "
                                 "with statistics")
    if scans:
        # bf16 at P = 64, N = 128 or 64: every backward on the tensor-core
        # route
        log(f"  ssd_chunk_bwd routes {ssd_routes}")
        if ssd_routes["wgmma"] != launches["ssd_chunk_bwd"]:
            raise AssertionError(f"ssd_chunk_bwd routes {ssd_routes} of "
                                 f"{launches['ssd_chunk_bwd']} launches")
        rep["ssd_chunk_bwd_routes"] = dict(ssd_routes)
    rep.update(losses=losses, launches=launches, events=tr.events,
               fabric_stats=res["fabric_stats"])

    # the watchdog's straggler events read each run's own wall clock, so
    # they are held to the watchdog's rule and every other event (leases,
    # the restore) must be equal
    factor = TrainerConfig().straggler_factor
    slow = {"card": [e for e in tr.events if e["kind"] == "straggler"],
            "cpu": [e for e in events if e["kind"] == "straggler"]}
    rep["stragglers"] = slow
    if slow["card"] or slow["cpu"]:
        log(f"  straggler events (wall clock, not compared): {slow}")
    card_events = steady_events(tr.events, factor)
    cpu_events = steady_events(events, factor)
    if cpu_events != card_events or stats != res["fabric_stats"] or \
            grants != list(tr.fabric.grant_log):
        raise AssertionError(
            f"card and CPU trainers' events, fabric counters or grant logs "
            f"differ: events {card_events} vs {cpu_events}; counters "
            f"{res['fabric_stats']} vs {stats}; grant logs of "
            f"{len(tr.fabric.grant_log)} and {len(grants)}")
    log(f"  card == cpu trainer ({small.n_layers} layers, d_model "
        f"{small.d_model}, {cpu_s:.1f} s in a worker process beside the "
        f"card's run): events, fabric counters "
        f"{ {k: v for k, v in res['fabric_stats'].items() if v} }, grant "
        f"log ({len(tr.fabric.grant_log)} grants)")
    shutil.rmtree(work / "cpu", ignore_errors=True)

    # card vs CPU loss and gradients at grad_layers layers, one 512-token row
    deep = dataclasses.replace(cfg, n_layers=grad_layers)
    params = init_model(deep, torch.Generator(dev).manual_seed(WEIGHT_SEED))
    host_params = tree_map(lambda t: t.cpu(), params)
    tok = SyntheticLM(cfg, DataConfig(global_batch=TRAIN_B,
                                      seq_len=TRAIN_S)).batch(0)["tokens"]
    row = torch.from_numpy(tok[:1])

    def grads(c, device):
        p = params if device == dev else host_params
        loss, _, g = loss_and_grads(c, p, {"tokens": row.to(device)})
        return float(loss), named_leaves(g)
    t0 = time.perf_counter()
    card, host = grads(deep, dev), grads(deep, torch.device("cpu"))
    errs = compare_grads(card, host)
    small_leaves = errs.pop("small_leaves")
    errs.pop("leaves")
    log(f"  card vs cpu at {grad_layers} layers ({time.perf_counter() - t0:.1f}"
        f" s): loss {errs['loss']:.2e}, gradient relative L2 "
        f"{errs['gradient']:.4f} (worst leaf of >= {PER_LEAF_MIN} values "
        f"{errs['worst_leaf']:.4f}; the smaller leaves, per-head vectors: "
        f"{small_leaves})")
    rep["card_vs_cpu"] = dict(errs, small_leaves=small_leaves,
                              layers=grad_layers)
    if scans:
        # the same under the f32 policy (every kernel of the path in its
        # f32 form), and each bf16 gradient's distance from the CPU's f32
        # one
        f32 = dataclasses.replace(deep, policy=dataclasses.replace(
            deep.policy, compute_dtype=torch.float32))
        card32, host32 = grads(f32, dev), grads(f32, torch.device("cpu"))
        errs32 = compare_grads(card32, host32)
        errs32.pop("small_leaves")
        errs32.pop("leaves")
        held, beyond = held_by_f32(card, host, host32, ["gradient"])
        from_f32 = dict(zip(("card", "cpu"), held["gradient"]))
        log(f"  f32 policy: card vs cpu loss {errs32['loss']:.2e}, gradient "
            f"{errs32['gradient']:.2e} (worst leaf {errs32['worst_leaf']:.2e})"
            f"; the bf16 gradient's relative L2 from the cpu's f32 one: card "
            f"{from_f32['card']:.4f}, cpu {from_f32['cpu']:.4f} "
            f"({from_f32['card'] / from_f32['cpu']:.3f}x)")
        rep["card_vs_cpu"].update(f32_policy=errs32, bf16_from_f32=from_f32)
        if max(errs32.values()) > MODEL_REL_L2 or beyond:
            raise AssertionError(f"f32 policy card vs cpu {errs32}; bf16 "
                                 f"from f32 {from_f32}")
    if arch in BF16_GRAD_ARCHS and max(errs.values()) > MODEL_REL_L2:
        raise AssertionError(f"card vs cpu beyond {MODEL_REL_L2}: {errs}")
    del params, host_params, card, host

    if extras:
        check_lease_workers(torch, np, dev, cfg, rep)

    # a step's times at full width, from the trained state
    batch = tr.data.batch(steps)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    state, wall_ms, host_ms, prof = step_times(torch, tr.step_fn,
                                               res["state"], batch)
    peak = torch.cuda.max_memory_allocated()
    # host syncs inside a step: each one stalls the enqueue until the card
    # catches up (the loss readback the trainer makes is outside step_fn)
    import warnings
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            state, _ = tr.step_fn(state, batch)
            torch.cuda.synchronize()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = [str(w.message).splitlines()[0][:160] for w in caught
             if "synchroniz" in str(w.message).lower()]
    tokens = TRAIN_B * TRAIN_S
    ported = prof["ported_kernels"]
    bwd_names = [n for n in ("rmsnorm_bwd", "flash_attention_bwd",
                             "ssd_chunk_bwd") if n in need]
    bwd = sum(ported[k]["us"] for k in bwd_names)
    flops = train_flops(cfg, state.params, TRAIN_B, TRAIN_S)
    n_params = sum(t.numel() for t in leaves(state.params))
    rep["step"] = {
        "wall_ms": wall_ms, "host_enqueue_ms": host_ms,
        "device_busy_ms": prof["device_ms_per_call"],
        "idle_share": prof["device_idle_share"],
        "tokens_per_s": tokens / (wall_ms / 1e3),
        "backward_kernels_share": bwd / prof["device_busy_us"],
        "ssd_chunk_bwd_share": (ported["ssd_chunk_bwd"]["us"]
                                / prof["device_busy_us"]),
        "peak_memory_gb": peak / 1e9,
        "ported_kernels": ported,
        "model_flops": flops, "n_params": n_params,
        "mfu": flops / (wall_ms / 1e3 * BF16_FLOPS_PER_S),
        "host_syncs": syncs, "device_events": prof["device_events"] / 2,
        "device_by_name": prof["device_by_name"],
        "host_by_op": prof["host_by_op"]}
    st = rep["step"]
    log(f"  a training step ({n_params / 1e6:.1f} M parameters, {tokens} "
        f"tokens): wall {st['wall_ms']:.1f} ms, host enqueue "
        f"{st['host_enqueue_ms']:.1f} ms, device busy "
        f"{st['device_busy_ms']:.1f} ms (idle share {st['idle_share']:.3f});"
        f" {st['tokens_per_s']:.0f} tokens/s; backward kernels "
        f"{st['backward_kernels_share']:.3f} of device time, ssd_chunk_bwd "
        f"{st['ssd_chunk_bwd_share']:.3f}; "
        + ", ".join(f"{k} {ported[k]['us'] / 2e3:.2f} ms "
                    f"({ported[k]['count'] // 2})"
                    for k in need if k in ported and ported[k]["count"])
        + f" a step; peak memory {st['peak_memory_gb']:.2f} GB; model "
        f"flops {flops / 1e12:.2f} T a step, {st['mfu']:.3f} of 989 TF/s; "
        f"{st['device_events']:.0f} device events a step; {len(syncs)} host "
        f"syncs in a step {syncs[:3]}")

    if extras:
        # checkpoint saves on a new manager: the first allocates its
        # pinned buffers, the second refills them; host time on the
        # training thread, then durable
        mgr = CheckpointManager(work / "save_probe", keep=1)
        rep["checkpoint"] = {}
        for i, name in enumerate(("first", "second")):
            t0 = time.perf_counter()
            mgr.save(steps + 99 + i, state)
            enq = time.perf_counter() - t0
            mgr.wait()
            rep["checkpoint"][name] = {
                "save_host_ms": enq * 1e3,
                "durable_ms": (time.perf_counter() - t0) * 1e3}
        log("  checkpoint save "
            f"({3 * n_params * 4 / 1e9:.2f} GB): "
            + "; ".join(f"{k} {v['save_host_ms']:.1f} ms on the training "
                        f"thread, durable after {v['durable_ms']:.0f} ms"
                        for k, v in rep["checkpoint"].items()))
    del tr, res, state
    shutil.rmtree(work, ignore_errors=True)
    return launches, rep


def check_lease_workers(torch, np, dev, cfg, rep):
    """``VmappedWorkers`` at 4 layers, two workers, one row each: W = 1
    keeps the workers' parameters equal after every step, W = 4 needs at
    least 3x fewer collective bytes."""
    import dataclasses

    from repro_torch.coherence.lease_sync import LeaseConfig, VmappedWorkers
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.optim import adamw

    four = dataclasses.replace(cfg, n_layers=TRAIN_WORKER_LAYERS)
    data = SyntheticLM(cfg, DataConfig(global_batch=2, seq_len=TRAIN_S))
    wopt = adamw.AdamWConfig(lr=TRAIN_LR, warmup_steps=1,
                             total_steps=TRAIN_WORKER_STEPS)
    workers = {W: VmappedWorkers(four, wopt, LeaseConfig(wr_lease=W), 2,
                                 device=dev) for W in (1, 4)}
    wl = {W: [] for W in workers}
    for s in range(TRAIN_WORKER_STEPS):
        b = data.batch(s)["tokens"]
        batches = {"tokens": np.stack([b[0:1], b[1:2]])}
        for W, w in workers.items():
            wl[W].append(w.step(batches))
        p = workers[1].state.params["embed"]
        if not torch.equal(p[0], p[1]):
            raise AssertionError("W = 1 workers hold different parameters")
    w1, w4 = workers[1], workers[4]
    if not (w4.collective_bytes * 3 < w1.collective_bytes
            and w4.clock.memts > 0 and np.all(np.isfinite(wl[1] + wl[4]))):
        raise AssertionError(f"lease workers: bytes {w1.collective_bytes} "
                             f"vs {w4.collective_bytes}, memts "
                             f"{w4.clock.memts}, losses {wl}")
    log(f"  VmappedWorkers ({TRAIN_WORKER_LAYERS} layers, 2 workers, "
        f"{TRAIN_WORKER_STEPS} steps): W=1 parameters equal after every "
        f"step, collective bytes W=1 {w1.collective_bytes} vs W=4 "
        f"{w4.collective_bytes} ({w1.collective_bytes / w4.collective_bytes:.1f}x), "
        f"memts {w4.clock.memts}; losses W=1 {[round(x, 3) for x in wl[1]]}")
    rep["workers"] = {"bytes": {1: w1.collective_bytes,
                                4: w4.collective_bytes},
                      "memts": w4.clock.memts, "losses": wl}


# ------------------------------------------------------------- phase 11
def _policies(torch, cfg):
    """The config under its own bf16 policy and under the f32 one."""
    import dataclasses
    return {"bf16": cfg, "f32": dataclasses.replace(
        cfg, policy=dataclasses.replace(cfg.policy,
                                        compute_dtype=torch.float32))}


def cpu_grads_side(cfg, weights, batch, threads):
    """Phase 11's CPU check, run in a worker process beside the card's
    run: loss and gradients of the weights saved at ``weights`` on
    ``batch`` under each policy, each gradient list saved beside the
    weights; returns {policy: (loss, path, seconds, the MoE layers' gates
    by call, ``RouteLog``'s)}."""
    import numpy as np
    import torch

    from repro_torch.models.training import loss_and_grads
    torch.set_num_threads(threads)
    params = torch.load(weights, mmap=True)
    out = {}
    for name, c in _policies(torch, cfg).items():
        t0 = time.perf_counter()
        with RouteLog(torch, np, c.top_k) as routes:
            loss, _, g = loss_and_grads(c, params, {
                k: torch.from_numpy(v) for k, v in batch.items()})
        path = pathlib.Path(weights).with_suffix(f".grads_{name}.pt")
        torch.save([t for _, t in named_leaves(g)], path)
        del g
        out[name] = (float(loss), str(path), time.perf_counter() - t0,
                     routes.calls)
    return out


def host_gb_available() -> float:
    """The host's available memory (``MemAvailable``), GB."""
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemAvailable:"):
                return int(line.split()[1]) * 1024 / 1e9
    raise RuntimeError("/proc/meminfo has no MemAvailable")


def expert_slices(named):
    """Named gradient leaves with each MoE expert stack (``moe/wg``,
    ``wi``, ``wo``: [..., E, rows, cols]) split into one entry an
    expert, ``path[e]``: the unit a routing split touches."""
    out = []
    for path, t in named:
        if path.rsplit("/", 2)[-2:-1] == ["moe"] and \
                path.endswith(("/wg", "/wi", "/wo")):
            dim = t.dim() - 3
            out += [(f"{path}[{e}]", t.select(dim, e))
                    for e in range(t.shape[dim])]
        else:
            out.append((path, t))
    return out


def start_cpu_check(torch, dev, pool, arch, cpu_layers, cpu_seq, work):
    """The first half of phase 11's card-vs-CPU check at ``cpu_layers``
    layers of ``arch`` at full width: the weights built on the card from
    WEIGHT_SEED and a host copy saved for the CPU worker in ``pool``,
    which starts on them at once.  The host's available memory is checked
    first: the worker's f32 policy holds f32 copies of the weights and
    their gradients (8 bytes a parameter; deepseek-v2's 43 GB).  Returns
    (the config, the token row, the worker's future)."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.models import init_model
    from repro_torch.models.model import tree_map

    deep = dataclasses.replace(configs.get(arch), n_layers=cpu_layers)
    params = init_model(deep, torch.Generator(dev).manual_seed(WEIGHT_SEED))
    n_params = sum(t.numel() for t in leaves(params))
    need, have = 8 * n_params / 1e9, host_gb_available()
    log(f"  {arch} at {cpu_layers} layers: {n_params / 1e9:.3f} B "
        f"parameters; the host has {have:.1f} GB available, the CPU side "
        f"needs ~{need:.1f} GB beside what is running")
    if have < need:
        raise AssertionError(f"{arch}: the card-vs-CPU check needs ~{need:.1f}"
                             f" GB of host memory, {have:.1f} available")
    t0 = time.perf_counter()
    path = work / f"{arch}_weights.pt"
    torch.save(tree_map(lambda t: t.cpu(), params), path)
    del params
    row = {k: v[:1] for k, v in SyntheticLM(deep, DataConfig(
        global_batch=1, seq_len=cpu_seq)).batch(0).items()}
    future = pool.submit(cpu_grads_side, deep, str(path), row,
                         PHASE11_CPU_THREADS)
    log(f"  {arch}: the weights to the CPU worker, one row of {cpu_seq} "
        f"tokens ({time.perf_counter() - t0:.1f} s)")
    return deep, row, future


def card_grads(torch, np, dev, arch, deep, row):
    """The card half of the check: the same weights built again on the
    card from WEIGHT_SEED, the card's loss and gradients on ``row`` under
    each policy, kept on the card, every attention layer's backward one
    ``flash_attention_bwd`` launch on the policy's route (bf16: the tensor
    cores; f32: the CUDA cores), and the MoE layers' gates by call.
    Returns {policy: (loss, named leaves), "routes": {policy: gates}}."""
    from repro_torch.kernels.flash_attention import flash_attention_bwd
    from repro_torch.models import init_model
    from repro_torch.models.training import loss_and_grads

    params = init_model(deep, torch.Generator(dev).manual_seed(WEIGHT_SEED))
    routes = flash_attention_bwd.route_launches
    card = {"routes": {}}
    for name, c in _policies(torch, deep).items():
        before = dict(routes)
        with RouteLog(torch, np, c.top_k) as gates:
            loss, _, g = loss_and_grads(c, params, {
                k: torch.from_numpy(v).to(dev) for k, v in row.items()})
        card["routes"][name] = gates.calls
        got = {k: routes[k] - before[k] for k in routes}
        want = "wgmma" if name == "bf16" else "simt"
        if got[want] != deep.n_layers or sum(got.values()) != deep.n_layers:
            raise AssertionError(f"{arch} {name}: flash backward routes "
                                 f"{got} at {deep.n_layers} layers")
        card[name] = (float(loss), named_leaves(g))
    return card


def finish_cpu_check(torch, np, dev, arch, deep, row, future):
    """The card's losses and gradients (``card_grads``, on the card, free
    of training by then) against the CPU worker's: under
    each policy the loss and the whole gradient within MODEL_REL_L2, and
    every leaf of at least PER_LEAF_MIN values; a bf16 leaf beyond it is
    held to ``held_by_f32``'s rule, as phase 8 holds zamba2's gradient.
    A MoE model's expert stacks are held one expert at a time
    (``expert_slices``); the experts of a token whose routing split card
    vs CPU at a near-tie (``route_split``, at most one token in eight)
    are logged and left out of the per-leaf check.  The sums run on the
    card ``dev``."""
    card = card_grads(torch, np, dev, arch, deep, row)
    t0 = time.perf_counter()
    paths = [p for p, _ in card["bf16"][1]]
    result = future.result()
    cpu = {n: ((loss, expert_slices(zip(paths, torch.load(
        path, mmap=True)))), secs)
        for n, (loss, path, secs, _) in result.items()}
    waited = time.perf_counter() - t0
    k = deep.top_k
    errs = {}
    for name, (host, secs) in cpu.items():
        left_out, split, tokens = set(), 0, 0
        for g_c, g_h in zip(card["routes"][name], result[name][3]):
            differs, experts = route_split(np, g_c, g_h, k)
            left_out |= experts
            split, tokens = split + int(differs.sum()), tokens + len(differs)
        if split * 8 > tokens:
            raise AssertionError(f"{arch} {name}: MoE routing split card vs "
                                 f"CPU on {split} of {tokens} tokens")
        card[name] = (card[name][0], expert_slices(card[name][1]))
        e = compare_grads(card[name], host, dev)
        skip = {p for p in e["leaves"]
                if p.endswith(tuple(f"[{x}]" for x in left_out))}
        errs[name] = {"loss": e["loss"], "gradient": e["gradient"],
                      "worst_leaf": max(
                          x for p, (x, n) in e["leaves"].items()
                          if n >= PER_LEAF_MIN and p not in skip),
                      "cpu_s": secs, "leaves_held_by_f32": {},
                      "routing_split": {"tokens": split, "of": tokens,
                                        "experts_left_out":
                                            sorted(left_out)}}
        if left_out:
            log(f"    {name} policy: {split} of {tokens} token routings "
                f"split card vs CPU at a near-tie; experts "
                f"{sorted(left_out)} left out of the per-leaf check ("
                + ", ".join(f"{p} {e['leaves'][p][0]:.4f}"
                            for p in sorted(skip)[:6]) + ")")
        beyond = [p for p, (x, n) in e["leaves"].items()
                  if n >= PER_LEAF_MIN and x > MODEL_REL_L2 and p not in skip]
        if name == "bf16" and beyond:
            held, beyond = held_by_f32(card["bf16"], host, cpu["f32"][0],
                                       beyond, dev)
            errs[name]["leaves_held_by_f32"] = held
        errs[name]["beyond"] = beyond
    log(f"  {arch}: card vs cpu at {deep.n_layers} layers ({waited:.1f} s "
        "waited for the worker): " + "; ".join(
            f"{n} policy loss {e['loss']:.2e}, gradient {e['gradient']:.2e}, "
            f"worst leaf {e['worst_leaf']:.2e} (cpu {e['cpu_s']:.1f} s)"
            for n, e in errs.items()) + f" <= {MODEL_REL_L2}")
    for p, (c, h) in errs["bf16"]["leaves_held_by_f32"].items():
        log(f"    bf16 leaf {p}: card vs cpu beyond {MODEL_REL_L2}; from the "
            f"CPU's f32 gradient the card's {c:.4f}, the CPU's {h:.4f} "
            f"({c / h:.3f}x, at most {BF16_FROM_F32}x)")
    bad = {n: e for n, e in errs.items()
           if max(e["loss"], e["gradient"]) > MODEL_REL_L2 or e["beyond"]}
    if bad:
        raise AssertionError(f"{arch}: card vs cpu beyond {MODEL_REL_L2}: "
                             f"{bad}")
    return dict(errs, layers=deep.n_layers,
                tokens=next(iter(row.values())).shape[1])


def check_wide_training(torch, np, dev, arch, layers, B, S, work):
    """``arch`` at full width and ``layers`` deep trained on the card for
    WIDE_TRAIN_STEPS steps of ``B`` x ``S`` through its ``Trainer``'s step:
    losses finite, each below the step's before (for the rows of
    WIDE_TRAIN_FALL_BY_GAP: the last below the first, and the fall
    against the untrained model larger in the last half of the steps than
    in the first) and below the untrained model's loss on the same batch, the first REPEAT_STEPS equal bit for
    bit to a run of those steps from the same seeded state before it (the
    step updates its state in place), a MoE model's aux > 0 at every
    step, every flash backward of the run on the tensor-core route from a
    forward's row statistics (launch counts set to 0 just before the run
    and read just after; at deepseek-v2's MLA pair the profiled step's
    flash kernels must be the (192, 128) ones); then a step's wall,
    host-enqueue and device ms, idle share, the backward kernels' share of
    device time and the run's peak memory."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_bwd)
    from repro_torch.models.model import loss_fn
    from repro_torch.optim import adamw
    from repro_torch.runtime.trainer import Trainer, TrainerConfig

    cfg = dataclasses.replace(configs.get(arch), n_layers=layers)
    rep = {"arch": arch, "layers": layers, "batch": B, "seq": S}
    routes = flash_attention_bwd.route_launches
    # the earlier phases' freed blocks go back to the card first: gemma3's
    # step needs large contiguous ones
    gc.collect()
    torch.cuda.empty_cache()
    log(f"  {arch}: {torch.cuda.memory_allocated() / 1e9:.2f} GB allocated "
        "on the card before its trainer")
    tr = Trainer(cfg, adamw.AdamWConfig(
        lr=WIDE_TRAIN_LR, warmup_steps=TRAIN_WARMUP,
        total_steps=WIDE_TRAIN_STEPS), TrainerConfig(
        total_steps=WIDE_TRAIN_STEPS, ckpt_dir=str(work / "ckpt")),
        data=SyntheticLM(cfg, DataConfig(global_batch=B, seq_len=S)),
        device=dev)
    # the first steps from the seeded state, to repeat: the step writes
    # the new state into the one it is given, so the run starts anew
    batch = tr.data.batch
    state = tr.init_state(WEIGHT_SEED)
    first = []
    for step in range(REPEAT_STEPS):
        state, m = tr.step_fn(state, batch(step))
        first.append(float(m["loss"]))
    del state, m
    gc.collect()
    torch.cuda.empty_cache()
    state = tr.init_state(WEIGHT_SEED)
    n_params = sum(t.numel() for t in leaves(state.params))
    # the untrained model's loss on each batch of the run: the yardstick
    # for each step's loss, and how far the batches differ by themselves
    with torch.no_grad():
        untrained = [float(loss_fn(cfg, state.params, {
            k: torch.from_numpy(v).to(dev)
            for k, v in batch(step).items()})[0])
            for step in range(WIDE_TRAIN_STEPS)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    routes.update(dict.fromkeys(routes, 0))
    flash_attention.stats_writes = 0
    t0 = time.perf_counter()
    losses, auxes = [], []
    for step in range(WIDE_TRAIN_STEPS):
        state, m = tr.step_fn(state, batch(step))
        losses.append(float(m["loss"]))
        auxes.append(float(m["aux"]))
    torch.cuda.synchronize()
    rep["run_s"] = time.perf_counter() - t0
    launches, fwd_routes = read_counts()
    bwd = dict(routes)
    writes = flash_attention.stats_writes
    rep["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    log(f"  card: {arch} at {layers} layers, {n_params / 1e9:.3f} B "
        f"parameters, {WIDE_TRAIN_STEPS} steps of {B} x {S}"
        f" in {rep['run_s']:.1f} s at lr {WIDE_TRAIN_LR}; losses "
        f"{[round(x, 4) for x in losses]} (the untrained model's on the "
        f"same batches {[round(x, 4) for x in untrained]}; the first "
        f"{REPEAT_STEPS} steps' run before: {first}); aux "
        f"{[round(x, 4) for x in auxes]}; "
        f"launches {launches}; flash routes {fwd_routes}, backward {bwd}, "
        f"forwards that wrote row statistics {writes}; peak memory "
        f"{rep['peak_memory_gb']:.2f} GB")
    half = WIDE_TRAIN_STEPS // 2
    gap = [u - t for t, u in zip(losses, untrained)]
    falls = (losses[-1] < losses[0]
             and sum(gap[-half:]) > sum(gap[:half])) \
        if arch in WIDE_TRAIN_FALL_BY_GAP \
        else all(b < a for a, b in zip(losses, losses[1:]))
    if not np.all(np.isfinite(losses)) or not falls or \
            any(t >= u for t, u in zip(losses[1:], untrained[1:])):
        raise AssertionError(f"{arch}: losses not finite, or not falling "
                             f"(at every step, or for {WIDE_TRAIN_FALL_BY_GAP}"
                             f" by the gap to the untrained model), or not "
                             f"below the untrained model's {untrained}: "
                             f"{losses}")
    if losses[:REPEAT_STEPS] != first:
        raise AssertionError(f"{arch}: the first {REPEAT_STEPS} steps from "
                             f"the same state gave {first}, then "
                             f"{losses[:REPEAT_STEPS]}")
    if cfg.n_experts and not all(a > 0 for a in auxes):
        raise AssertionError(f"{arch}: MoE aux loss {auxes}")
    need = ("rmsnorm", "rmsnorm_bwd", "flash_attention",
            "flash_attention_bwd")
    if any(launches[n] < 1 for n in need) or launches["decode_attention"]:
        raise AssertionError(f"{arch}: launches {launches}")
    # every backward on the tensor cores at this head dim, one a layer a
    # step, each from the row statistics of a forward under grad
    if bwd["wgmma"] != launches["flash_attention_bwd"] or bwd["simt"] \
            or launches["flash_attention_bwd"] != layers * WIDE_TRAIN_STEPS \
            or writes < bwd["wgmma"] or fwd_routes["simt"]:
        raise AssertionError(f"{arch}: flash backward routes {bwd}, forward "
                             f"routes {fwd_routes}, {writes} forwards with "
                             "statistics")
    rep.update(losses=losses, untrained_losses=untrained, lr=WIDE_TRAIN_LR,
               repeated_losses=first, aux=auxes,
               launches=launches, n_params=n_params,
               flash_routes=fwd_routes, flash_bwd_routes=bwd,
               stats_writes=writes)

    # a step's times at full width; the run's state goes in with no other
    # reference, so each step frees the one before (a second copy of the
    # weights and moments would not fit beside gemma3's step)
    held = [state]
    del state, m
    gc.collect()
    torch.cuda.empty_cache()
    state, wall_ms, host_ms, prof = step_times(
        torch, tr.step_fn, held.pop(), tr.data.batch(WIDE_TRAIN_STEPS))
    ported = prof["ported_kernels"]
    rep["step"] = {
        "wall_ms": wall_ms, "host_enqueue_ms": host_ms,
        "device_busy_ms": prof["device_ms_per_call"],
        "idle_share": prof["device_idle_share"],
        "tokens_per_s": B * S / (wall_ms / 1e3),
        "backward_kernels_share": sum(
            ported[k]["us"] for k in ("rmsnorm_bwd", "flash_attention_bwd"))
        / prof["device_busy_us"],
        "flash_attention_bwd_share": ported["flash_attention_bwd"]["us"]
        / prof["device_busy_us"],
        "ported_kernels": ported, "device_by_name": prof["device_by_name"]}
    st = rep["step"]
    log(f"  a training step ({B * S} tokens): wall {st['wall_ms']:.1f} ms, "
        f"host enqueue {st['host_enqueue_ms']:.1f} ms, device busy "
        f"{st['device_busy_ms']:.1f} ms (idle share {st['idle_share']:.3f});"
        f" {st['tokens_per_s']:.0f} tokens/s; backward kernels "
        f"{st['backward_kernels_share']:.3f} of device time, "
        f"flash_attention_bwd {st['flash_attention_bwd_share']:.3f}; "
        + ", ".join(f"{k} {ported[k]['us'] / 2e3:.2f} ms "
                    f"({ported[k]['count'] // 2})" for k in need)
        + " a step (a CPU worker of 4 threads beside); the device's top "
        "kernels a step: " + "; ".join(
            f"{d['name'][:60]} {d['us'] / 2e3:.2f} ms"
            for d in prof["device_by_name"][:4]))
    if cfg.is_mla:
        syms = ported["flash_attention"]["symbols"] \
            + ported["flash_attention_bwd"]["symbols"]
        if not ported["flash_attention_bwd"]["symbols"] or any(
                "<192, 128" not in n for n in syms):
            raise AssertionError(f"{arch}: a step's flash kernels were not "
                                 f"the tensor-core ones at (192, 128): "
                                 f"{syms}")
    del tr, state
    return launches, rep


def check_phase11(torch, np, dev, beside=None):
    """hubert-xlarge, gemma3-4b and deepseek-v2 trained at full width
    (gemma3 and deepseek at a cut depth), one after the other, each freed
    before the next.  The card-vs-CPU checks start first: each model's
    weights go to one CPU worker process, which runs while the card
    trains; each check ends, after all the training, with the card's
    gradients (``finish_cpu_check``).  ``beside()`` (phase 12), when
    given, runs on the card before the last check, while that check's
    CPU worker runs on (deepseek's, the longest)."""
    import shutil
    work = ROOT / "build" / "phase11"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    counts, reps, checks = {}, {}, {}
    with concurrent.futures.ProcessPoolExecutor(
            1, mp_context=multiprocessing.get_context("spawn")) as pool:
        for arch, _, _, _, cpu_layers, cpu_seq in WIDE_TRAIN:
            checks[arch] = start_cpu_check(torch, dev, pool, arch,
                                           cpu_layers, cpu_seq, work)
        gc.collect()
        torch.cuda.empty_cache()
        for arch, layers, B, S, *_ in WIDE_TRAIN:
            t0 = time.perf_counter()
            counts[arch], reps[arch] = check_wide_training(
                torch, np, dev, arch, layers, B, S, work)
            torch.cuda.empty_cache()
            log(f"  ({time.perf_counter() - t0:.0f} s for {arch})")
        for arch, *_ in WIDE_TRAIN:
            if beside is not None and arch == WIDE_TRAIN[-1][0]:
                beside()
                gc.collect()
                torch.cuda.empty_cache()
            t0 = time.perf_counter()
            reps[arch]["card_vs_cpu"] = finish_cpu_check(
                torch, np, dev, arch, *checks.pop(arch))
            for f in work.glob(f"{arch}_weights*"):
                f.unlink()
            gc.collect()
            torch.cuda.empty_cache()
            log(f"  ({time.perf_counter() - t0:.0f} s for {arch}'s check)")
    shutil.rmtree(work, ignore_errors=True)
    return counts, reps


# ------------------------------------------------------------- phase 12
def ep_train_cfg(arch):
    """A phase-12 training config: the smoke config in its own policy;
    deepseek-v2's with MLA's own head dims (q and k 128 + 64, v 128), the
    pair the flash kernels build, where the smoke config's (24, 16) is
    none of theirs."""
    import dataclasses

    from repro_torch import configs
    cfg = configs.SMOKE[arch]
    if cfg.is_mla:
        full = configs.ARCHS[arch]
        cfg = dataclasses.replace(cfg, nope_head_dim=full.nope_head_dim,
                                  rope_head_dim=full.rope_head_dim,
                                  v_head_dim=full.v_head_dim)
    return cfg


def near_tie_ids(torch, logits_a, logits_b):
    """Rows whose greedy ids differ between two ``[B, V]`` logit arrays,
    each of which must sit at a near-tie of ``logits_b`` (its top two
    within NEAR_TIE of the top's magnitude), else raise.  Returns the
    mask of rows kept (ids equal)."""
    a, b = logits_a.float(), logits_b.float()
    same = a.argmax(-1) == b.argmax(-1)
    top2 = torch.topk(b, 2, dim=-1).values
    gap = (top2[:, 0] - top2[:, 1]) / top2[:, 0].abs()
    if bool((gap[~same] > NEAR_TIE).any()):
        raise AssertionError(f"greedy ids differ away from a near-tie: "
                             f"gaps {gap[~same].tolist()}")
    return same


def ep_moe_checks(torch, np, cfg, p_full, calls, M):
    """Every recorded MoE call of the mesh's serving run against
    ``moe_by_token`` in f32 on the card: a prefill (split sequence) block
    by block at the per-rank capacity (each of the M sequence blocks of
    the rank's rows, as the expert-parallel path routes them), a decode
    step (S = 1) over its global batch at the global capacity.  Returns
    one row a call."""
    rows = []
    for kind, h, got in calls:
        if h.shape[1] % M == 0:
            parts, want = [], []
            w = h.shape[1] // M
            for m in range(M):
                blk = h[:, m * w:(m + 1) * w]
                out, routed, dropped = moe_by_token(torch, np, cfg, p_full,
                                                    blk)
                want.append(out.reshape(blk.shape))
                parts.append((routed, dropped))
            want = torch.cat(want, 1)
            routed, dropped = (sum(x) for x in zip(*parts))
        else:
            want, routed, dropped = moe_by_token(torch, np, cfg, p_full, h)
        err = rel_l2(got.reshape(want.shape), want)
        rows.append({"kind": kind, "tokens": int(h.shape[0] * h.shape[1]),
                     "routed": routed, "dropped": dropped, "rel_l2": err})
        if not err <= MODEL_REL_L2:
            raise AssertionError(f"phase 12: {kind} MoE layer vs its "
                                 f"token-by-token evaluation: relative L2 "
                                 f"{err}")
    return rows


def ep_serving(torch, np, mesh, rank):
    """deepseek-v2 at full width and EP_LAYERS layers on the (1, 2) mesh:
    the rank's shards built leaf by leaf from the seeded global weights;
    a counted prefill and EP_DECODE decode steps (every MoE call against
    ``moe_by_token``, the collectives of a prefill and of a decode step,
    the kernels' launches); timed prefills and decode steps with the
    all-to-all's host and device time; then at capacity factor
    EP_EQUAL_CF the mesh prefill's final hidden state against rank 0's
    one-device prefill of the same weights."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.models import comm, moe
    from repro_torch.models import model as M
    from repro_torch.obs.xprof import collective_counts
    from repro_torch.sharding import ShardCtx
    dev = torch.device("cuda")
    cfg = dataclasses.replace(configs.ARCHS[EP_ARCH], n_layers=EP_LAYERS)
    n_moe = sum(cfg.layer_kind(i) == "moe" for i in range(cfg.n_layers))
    Mm = mesh.axis_size(("model",))
    rep, stage = {}, {}
    t0 = time.perf_counter()
    params = M.init_model_shard(
        cfg, torch.Generator(dev).manual_seed(WEIGHT_SEED), mesh)
    torch.cuda.synchronize()
    rep["build_s"] = time.perf_counter() - t0
    specs = M.param_placement(cfg, mesh)
    n_all = sum(t.numel() for _, t in named_leaves(params))
    n_split = sum(t.numel() for (_, t), s in zip(named_leaves(params),
                                                  leaves_of(specs)) if s)
    rep["params_rank"] = {"replicated": n_all - n_split,
                          "expert_shard": n_split}
    params = M.cast_params(cfg, params)
    rng = np.random.default_rng(EP_SEED)
    tokens = torch.from_numpy(rng.integers(
        0, cfg.vocab, (EP_B, EP_PROMPT)).astype(np.int32)).to(dev)
    max_len = EP_PROMPT + EP_DECODE + 8
    prefill, decode = make_prefill_step(cfg, mesh), make_decode_step(cfg,
                                                                     mesh)

    def serve(counted=False):
        cache = M.init_cache(cfg, EP_B, max_len, device=dev)
        coll = {}
        if counted:
            (ids, cache), coll["prefill"] = collective_counts(
                prefill, params, cache, {"tokens": tokens})
        else:
            ids, cache = prefill(params, cache, {"tokens": tokens})
        seq = [ids]
        for t in range(EP_DECODE):
            if counted and t == 0:
                (ids, cache), coll["decode"] = collective_counts(
                    decode, params, cache, ids[:, None], EP_PROMPT + t)
            else:
                ids, cache = decode(params, cache, ids[:, None],
                                    EP_PROMPT + t)
            seq.append(ids)
        return torch.stack(seq, 1), coll

    # the counted run: launches, collectives, every MoE call's input
    calls, apply = [], moe.moe_apply

    def record(cfg_, p, h, **kw):
        out = apply(cfg_, p, h, **kw)
        calls.append(("prefill" if h.shape[1] > 1 else "decode", h, out[0]))
        return out

    stage["t"] = time.perf_counter()
    zero_counts()
    moe.moe_apply = record
    try:
        with torch.no_grad():
            ids, coll = serve(counted=True)
        torch.cuda.synchronize()
    finally:
        moe.moe_apply = apply
    rep["launches"], rep["routes"] = read_counts()
    rep["collectives"] = {k: v["by_op"] for k, v in coll.items()}
    rep["ids"] = ids.cpu().numpy()
    want = {"prefill": {"alltoall_base_": 2 * n_moe,
                        "_allgather_base_": n_moe},
            "decode": {"_allgather_base_": n_moe}}
    if rep["collectives"] != want:
        raise AssertionError(f"phase 12: collectives {rep['collectives']}, "
                             f"expected {want}")
    # the seeded global weights, every expert, drawn whole on this rank
    t0 = time.perf_counter()
    full = M.cast_params(cfg, M.init_model(
        cfg, torch.Generator(dev).manual_seed(WEIGHT_SEED)))
    stage["counted_run"] = t0 - stage.pop("t")
    with torch.no_grad():
        p_moe = full["segments"]["seg1"]["0"]["moe"]
        rep["moe_layers"] = ep_moe_checks(torch, np, cfg, p_moe, calls, Mm)
    del calls
    t1 = time.perf_counter()
    stage["moe_checks"] = t1 - t0

    # timings: whole prefills and decode steps, and each all-to-all
    a2a, orig = [], comm._a2a

    def timed_a2a(x, group):
        torch.cuda.synchronize()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        t = time.perf_counter()
        e0.record()
        y = orig(x, group)
        e1.record()
        torch.cuda.synchronize()
        a2a.append((time.perf_counter() - t, e0.elapsed_time(e1)))
        return y

    def wall_and_device(fn):
        torch.cuda.synchronize()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        t = time.perf_counter()
        e0.record()
        out = fn()
        e1.record()
        torch.cuda.synchronize()
        return (time.perf_counter() - t) * 1e3, e0.elapsed_time(e1), out

    with torch.no_grad():
        cache0 = M.init_cache(cfg, EP_B, max_len, device=dev)
        pre, dec = [], []
        for _ in range(EP_TIMED):
            wall, devms, (ids1, cache) = wall_and_device(
                lambda: prefill(params, cache0, {"tokens": tokens}))
            pre.append((wall, devms))
            wall, devms, _ = wall_and_device(
                lambda: decode(params, cache, ids1[:, None], EP_PROMPT))
            dec.append((wall, devms))
        comm._a2a = timed_a2a
        try:
            prefill(params, cache0, {"tokens": tokens})
        finally:
            comm._a2a = orig
    rep["prefill_ms"] = pre
    rep["decode_ms"] = dec
    rep["a2a_ms"] = [(h * 1e3, d) for h, d in a2a]
    t2 = time.perf_counter()
    stage["timings"] = t2 - t1
    # one exchange's buffer a rank: E x C rows of D bf16 values
    rep["a2a_bytes"] = cfg.n_experts * moe.capacity_for(
        cfg, EP_B * EP_PROMPT // Mm) * cfg.d_model * 2

    # nothing dropped: the mesh prefill against one device's
    cfg8 = dataclasses.replace(cfg, capacity_factor=EP_EQUAL_CF)
    with torch.no_grad():
        cache = M.init_cache(cfg, EP_B, max_len, device=dev)
        h_mesh, _ = M.forward(cfg8, params, tokens, cache=cache,
                              ctx=ShardCtx(mesh))
        W = M.unembed_matrix(cfg, params).to(h_mesh.dtype)
        rep["equal"] = None
        if rank == 0:
            h_one, _ = M.forward(cfg8, full, tokens, cache=cache)
            kept = near_tie_ids(torch, h_mesh[:, -1] @ W, h_one[:, -1] @ W)
            rep["equal"] = {"rel_l2": rel_l2(h_mesh, h_one),
                            "ids_kept": int(kept.sum()),
                            "rows": int(kept.numel())}
            del h_one
    del full, h_mesh
    stage["one_device"] = time.perf_counter() - t2
    rep["stage_s"] = stage
    rep["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    del params
    torch.cuda.empty_cache()
    return rep


def leaves_of(tree):
    """A spec tree's leaves (tuples) in sorted-key order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves_of(tree[k])]
    return [tree]


def ep_training(torch, np, meshes, rank):
    """The mesh train step at the deepseek-v2 and llama4 smoke configs
    (``ep_train_cfg``) on each mesh, on CUDA tensors (the kernels'
    launches counted) and then on CPU tensors in the same ranks: the first
    step's loss and gradients and EP_TRAIN_STEPS steps' losses, and a
    digest of every replicated leaf after the steps (the ranks compare
    theirs)."""
    import hashlib

    from repro_torch.launch.steps import make_grad_step, make_train_step
    from repro_torch.models import model as M
    from repro_torch.optim import adamw
    from repro_torch.sharding import shard_index
    out = {}
    for arch in EP_TRAIN_ARCHS:
        cfg = ep_train_cfg(arch)
        glob = M.init_model(cfg, torch.Generator().manual_seed(WEIGHT_SEED))
        rng = np.random.default_rng(EP_SEED + 1)
        batches = [{"tokens": rng.integers(0, cfg.vocab, (
            EP_TRAIN_B, EP_TRAIN_S)).astype(np.int32)}
            for _ in range(EP_TRAIN_STEPS)]
        opt = adamw.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=20)
        for shape, mesh in meshes.items():
            specs = M.param_placement(cfg, mesh)
            i, n = shard_index(mesh, ("data",))
            b = EP_TRAIN_B // n
            mine = [{k: v[i * b:(i + 1) * b] for k, v in bt.items()}
                    for bt in batches]
            res = {}
            for where in ("cuda", "cpu"):
                dev = torch.device(where)
                p = adamw.tree_map(lambda t: t.to(dev),
                                   M.shard_model(cfg, glob, mesh))
                if where == "cuda":
                    zero_counts()
                loss, _, grads = make_grad_step(cfg, mesh=mesh)(p, mine[0])
                step = make_train_step(cfg, opt, mesh=mesh)
                state = adamw.init_state(p, cfg.policy.moment_dtype)
                losses = []
                for bt in mine:
                    state, m = step(state, bt)
                    losses.append(float(m["loss"]))
                r = {"loss": float(loss), "losses": losses,
                     "grads": [(k, g.detach().cpu()) for k, g in
                               named_leaves(grads)]}
                if where == "cuda":
                    torch.cuda.synchronize()
                    r["launches"], r["routes"] = read_counts()
                r["digests"] = {
                    k: hashlib.sha256(t.detach().cpu().contiguous().view(
                        torch.uint8).numpy().tobytes()).hexdigest()
                    for (k, t), s in zip(named_leaves(state.params),
                                         leaves_of(specs)) if s == ()}
                res[where] = r
            cmp = compare_grads((res["cuda"]["loss"], res["cuda"]["grads"]),
                                (res["cpu"]["loss"], res["cpu"]["grads"]))
            steps_err = max(abs(a - b) / abs(b) for a, b in zip(
                res["cuda"]["losses"], res["cpu"]["losses"]))
            if not (cmp["loss"] <= EP_TRAIN_TOL
                    and cmp["gradient"] <= EP_TRAIN_TOL
                    and steps_err <= EP_TRAIN_TOL):
                raise AssertionError(
                    f"phase 12: {arch} on {shape}, card vs CPU: loss "
                    f"{cmp['loss']}, gradient {cmp['gradient']}, the "
                    f"steps' losses {steps_err}")
            out[(arch, shape)] = {
                "loss_err": cmp["loss"], "grad_rel_l2": cmp["gradient"],
                "worst_leaf": cmp["worst_leaf"], "steps_loss_err": steps_err,
                "losses": {w: res[w]["losses"] for w in res},
                "launches": res["cuda"]["launches"],
                "routes": res["cuda"]["routes"],
                "digests": {w: res[w]["digests"] for w in res}}
    return out


def model_rank(rank: int, world: int, rdzv: str, out_path: str) -> None:
    """One rank of phase 12 (``chip_smoke.py --model-rank``): a gloo world
    of ``world`` ranks sharing the card (NCCL refuses two ranks on one
    device), CUDA tensors through gloo; the (1, 2) mesh serves deepseek-v2
    at full width (``ep_serving``), then the (1, 2) and (2, 1) meshes
    train the smoke configs (``ep_training``).  Pickles what it saw."""
    import datetime
    import pickle

    import numpy as np
    import torch
    import torch.distributed as dist
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.launch.mesh import make_model_mesh

    stage = {"begin": time.perf_counter()}
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # the host's CPUs less those of phase 11's CPU worker, which runs on
    torch.set_num_threads(max(1, (len(os.sched_getaffinity(0))
                                  - PHASE11_CPU_THREADS) // world))
    dist.init_process_group(
        "gloo", init_method=f"file://{rdzv}", rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=EP_RANK_TIMEOUT_S))
    meshes = {shape: make_model_mesh(shape, backend="gloo")
              for shape in EP_TRAIN_MESHES}
    stage["start"] = time.perf_counter()
    out = {"serve": ep_serving(torch, np, meshes[EP_MESH], rank)}
    stage["serve"] = time.perf_counter()
    out["train"] = ep_training(torch, np, meshes, rank)
    stage["train"] = time.perf_counter()
    names = list(stage)
    out["stage_s"] = {b: stage[b] - stage[a] for a, b in zip(names, names[1:])}
    dist.barrier()
    dist.destroy_process_group()
    with open(out_path, "wb") as f:
        pickle.dump(out, f)


def check_phase12(torch, np):
    """Start the two ranks of phase 12 and check what they saw: equal ids
    on both, the collectives, the MoE layers, the mesh prefill against one
    device, the training checks, replicated leaves equal bit for bit
    across the ranks, and the kernels' launches."""
    import pickle
    import shutil
    tmp = ROOT / "build" / "phase12"
    shutil.rmtree(tmp, ignore_errors=True)
    tmp.mkdir(parents=True)
    world = EP_MESH[0] * EP_MESH[1]
    procs = []
    for r in range(world):
        with open(tmp / f"log{r}.txt", "w") as out:
            procs.append(subprocess.Popen(
                [sys.executable, str(ROOT / "chip_smoke.py"), "--model-rank",
                 str(r), str(world), str(tmp / "rdzv"),
                 str(tmp / f"out{r}.pkl")],
                stdout=out, stderr=subprocess.STDOUT))
    try:
        for p in procs:
            p.wait(timeout=EP_RANK_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        raise AssertionError("phase 12: a rank did not finish in time")
    finally:
        stop_ranks(procs)
    for r, p in enumerate(procs):
        if p.returncode != 0:
            raise AssertionError(f"phase 12: rank {r} exited {p.returncode}"
                                 f":\n{(tmp / f'log{r}.txt').read_text()[-4000:]}")
    res = [pickle.loads((tmp / f"out{r}.pkl").read_bytes())
           for r in range(world)]
    shutil.rmtree(tmp, ignore_errors=True)
    s = [x["serve"] for x in res]
    if any(not np.array_equal(x["ids"], s[0]["ids"]) for x in s):
        raise AssertionError("phase 12: the ranks' greedy ids differ")
    eq = s[0]["equal"]
    if not (eq["rel_l2"] <= MODEL_REL_L2 and eq["ids_kept"] >= 1):
        raise AssertionError(f"phase 12: mesh prefill vs one device {eq}")
    counts = {}
    for r, x in enumerate(s):
        need = ("rmsnorm", "flash_attention")   # MLA decodes by einsums
        if min(x["launches"][k] for k in need) < 1 \
                or x["routes"].get("simt", 0):
            raise AssertionError(f"phase 12: rank {r} serving launches "
                                 f"{x['launches']}, routes {x['routes']}")
        log(f"  rank {r}: {x['params_rank']['replicated'] / 1e9:.2f} B "
            f"replicated + {x['params_rank']['expert_shard'] / 1e9:.2f} B "
            f"expert-shard parameters built in {x['build_s']:.1f} s; "
            f"collectives {x['collectives']}; peak memory "
            f"{x['peak_memory_gb']:.2f} GB")
        log(f"  rank {r}: prefill {EP_B} x {EP_PROMPT} wall/device ms "
            f"{[(round(a, 3), round(b, 3)) for a, b in x['prefill_ms']]}; "
            f"decode step {[(round(a, 3), round(b, 3)) for a, b in x['decode_ms']]}"
            f"; all-to-all host/device ms "
            f"{[(round(a, 3), round(b, 3)) for a, b in x['a2a_ms']]} "
            f"({x['a2a_bytes'] / 1e6:.1f} MB a rank each way, through the "
            f"host: gloo, not NVLink)")
        log("  rank " + str(r) + ": MoE calls == token-by-token: " + "; ".join(
            f"{m['kind']} {m['tokens']} tokens: {m['routed']} routed, "
            f"{m['dropped']} dropped, relative L2 {m['rel_l2']:.4f}"
            for m in x["moe_layers"][:3]) + f" ... ({len(x['moe_layers'])} "
            "calls)")
        log(f"  rank {r}: serving stages (s) "
            f"{ {k: round(v, 2) for k, v in x['stage_s'].items()} }")
        counts[f"serve{r}"] = x["launches"]
    log(f"  mesh prefill at capacity factor {EP_EQUAL_CF} vs rank 0's one "
        f"device: final hidden state relative L2 {eq['rel_l2']:.5f}, ids "
        f"equal on {eq['ids_kept']} of {eq['rows']} rows (others near-ties)")
    t0, t1 = (x["train"] for x in res)
    for key, a in t0.items():
        b = t1[key]
        for where in ("cuda", "cpu"):
            if a["digests"][where] != b["digests"][where]:
                bad = [k for k in a["digests"][where]
                       if a["digests"][where][k] != b["digests"][where][k]]
                raise AssertionError(f"phase 12: {key} on {where}: "
                                     f"replicated leaves differ across the "
                                     f"ranks: {bad[:5]}")
        for x in (a, b):
            if x["launches"]["flash_attention_bwd"] < 1 \
                    or x["launches"]["rmsnorm_bwd"] < 1:
                raise AssertionError(f"phase 12: {key} training launches "
                                     f"{x['launches']}")
        counts[key] = a["launches"]
        log(f"  train {key[0]} on {key[1]}: card vs CPU loss "
            f"{a['loss_err']:.2e}, gradient relative L2 "
            f"{a['grad_rel_l2']:.4f} (worst leaf {a['worst_leaf']:.4f}), "
            f"{EP_TRAIN_STEPS} steps' losses {a['steps_loss_err']:.2e}; "
            f"card losses {a['losses']['cuda']}; replicated leaves equal "
            f"bit for bit on both ranks; flash_attention_bwd "
            f"{a['launches']['flash_attention_bwd']}, rmsnorm_bwd "
            f"{a['launches']['rmsnorm_bwd']} launches")
    rep = {"serve": [{k: v for k, v in x.items() if k != "ids"} for x in s],
           "train": {f"{k[0]} {k[1]}": {kk: vv for kk, vv in v.items()
                                        if kk != "digests"}
                     for k, v in t0.items()},
           "stage_s": [x["stage_s"] for x in res]}
    log(f"  rank stages (s): {[x['stage_s'] for x in res]}")
    return counts, rep


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is False; this "
                 "smoke test needs a CUDA card")
    if not (ROOT / "src" / "repro_torch").is_dir():
        sys.exit("chip_smoke: src/repro_torch not found beside the script")
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np

    from repro_torch.kernels import cuda
    from repro_torch.kernels.lease_probe import lease_probe
    from repro_torch.kernels.tier_pass import miss_round, write_grant
    from repro_torch.runtime import loadgen

    dev = torch.device("cuda")
    t_start = time.perf_counter()

    def elapsed() -> str:                 # the script's time so far
        return f"[{time.perf_counter() - t_start:.0f} s]"

    torch.backends.cuda.matmul.allow_tf32 = False   # f32 stays f32
    torch.backends.cudnn.allow_tf32 = False
    report = {}

    # ---- 1. card and build
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    log(smi)
    report["card"] = smi
    report["versions"] = {"python": sys.version.split()[0],
                          "torch": torch.__version__,
                          "cuda": torch.version.cuda}
    # the replay is host-bound, so its numbers depend on the host's CPUs
    # and on what else runs there
    report["host"] = {"cpus": os.cpu_count(),
                      "usable_cpus": len(os.sched_getaffinity(0)),
                      "loadavg_start": os.getloadavg()}
    log(f"host: {report['host']['usable_cpus']} of "
        f"{report['host']['cpus']} CPUs usable, load average "
        f"{report['host']['loadavg_start']}")
    t0 = time.perf_counter()
    built = cuda.build()
    report["build_s"] = time.perf_counter() - t0
    log(f"phase 1: built {sorted(built)} in {report['build_s']:.1f} s "
        f"(per source: {', '.join(f'{k} {v:.1f} s' for k, v in built.items())})")
    for name in cuda.SOURCES:
        regs = [ln.strip() for ln in cuda.library_path(name).with_suffix(
            ".log").read_text().splitlines() if "registers" in ln]
        log(f"  {name}.cu ptxas: {'; '.join(regs)}")

    # ---- 2. kernels against their plain versions
    log("phase 2: kernels vs plain versions on the card (coherence exact, "
        f"float within tolerance) {elapsed()}")
    kreport = {}
    check_kernels(torch, np, dev, kreport)
    check_float_kernels(torch, np, dev, kreport)
    log_rmsnorm_vs_library(kreport)
    check_ssd_kernel(torch, np, dev, kreport)
    check_backward_kernels(torch, np, dev, kreport)
    check_ssd_bwd_kernel(torch, np, dev, kreport)
    report["kernels"] = kreport
    check_no_sync(torch, np)
    log("  miss-path dispatch enqueues with no host sync (sync debug mode)")

    # ---- 3. the main path, card vs CPU
    log(f"phase 3: main path, {N_KEYS} keys, {N_REQUESTS} requests "
        f"{elapsed()}")
    trace = phase3_trace(loadgen)
    counters = (lease_probe, miss_round, write_grant)
    for fn in counters:
        fn.launches = 0
    sites = CallSites()
    fab_c, serv_c, res_c, warm_c, rep_c, rounds = replay_modeled(dev, trace,
                                                                 sites)
    torch.cuda.synchronize()
    launches = {fn.__name__: fn.launches for fn in counters}
    log(f"  card: warm {warm_c:.1f} s, replay {rep_c:.1f} s, "
        f"{len(res_c.batch_sizes)} waves; launches {launches}; write and "
        f"fence pass rounds {dict(rounds)}")
    calls = sites.report()
    log(f"  lease_probe launches by call site {calls['lease_probe_by_site']}"
        f"; miss_round launches by lane count {calls['miss_round_lanes']}")
    if sum(calls["lease_probe_by_site"].values()) != launches["lease_probe"] \
            or sum(calls["miss_round_lanes"].values()) != \
            launches["miss_round"]:
        raise AssertionError(f"call sites {calls} do not add up to the "
                             f"launches {launches}")
    if min(launches.values()) < 1:
        raise AssertionError(f"a kernel was not launched: {launches}")
    if launches["write_grant"] != sum(rounds.values()):
        raise AssertionError(f"write_grant launched {launches['write_grant']}"
                             f" times over {dict(rounds)} rounds: not one "
                             "launch a round")
    fab_h, serv_h, res_h, warm_h, rep_h, rounds_h = replay_modeled(
        torch.device("cpu"), trace)
    log(f"  cpu:  warm {warm_h:.1f} s, replay {rep_h:.1f} s")
    if rounds_h != rounds:
        raise AssertionError(f"rounds differ: card {dict(rounds)}, cpu "
                             f"{dict(rounds_h)}")
    compare_fabrics(np, fab_c, fab_h, serv_c, serv_h)
    check_outputs(res_c, fab_c, serv_c)
    log("  card == cpu: served results, grant log, counters, replica "
        "counters, memts of every key, whole fabric state")
    st = fab_c.stats()
    report["main_path"] = {"launches": launches, "rounds": dict(rounds),
                           "call_sites": calls,
                           "warm_s": warm_c,
                           "replay_s": rep_c,
                           "waves": len(res_c.batch_sizes),
                           "stats": st}
    wall = wall_replays(torch, np, fab_c, trace)
    report["wall"] = wall
    report["host"]["loadavg_after_replays"] = os.getloadavg()
    log(f"  wall clock on the card: capacity {wall['capacity_rps']:.0f} "
        f"req/s; at 0.7x: {wall['achieved_rps']:.0f} req/s, p50 "
        f"{wall['p50_us']:.0f} us, p99 {wall['p99_us']:.0f} us")
    if "--profile" in sys.argv[1:]:
        prof = profile_replay(torch, fab_c, trace)
        report["profile"] = prof
        log(f"  profiled closed-loop replay: {prof['waves']} waves in "
            f"{prof['wall_us'] / 1e3:.1f} ms, device busy "
            f"{prof['device_busy_us'] / 1e3:.1f} ms (idle share "
            f"{prof['device_idle_share']:.3f}), "
            f"{prof['device_events_per_wave']:.0f} device events per wave; "
            f"ported kernels {prof['ported_kernels']}")

    # ---- 4. the LLM serving path
    log(f"phase 4: LLM serving path, {ARCH} at full width {elapsed()}")
    served, report["serving"] = check_serving(
        torch, np, dev, ARCH,
        need=("rmsnorm", "flash_attention", "decode_attention"))
    launches.update({k: v for k, v in served.items() if k not in launches})

    # ---- 5. the SSM serving path
    log(f"phase 5: SSM serving path, {SSM_ARCH} then {HYBRID_ARCH} at full "
        f"width {elapsed()}")
    served, ssm = check_serving(torch, np, dev, SSM_ARCH,
                                need=("ssd_chunk", "rmsnorm"))
    launches["ssd_chunk"] = served["ssd_chunk"]
    _, hyb = check_serving(
        torch, np, dev, HYBRID_ARCH,
        need=("ssd_chunk", "rmsnorm", "flash_attention", "decode_attention"),
        n_waves=HYBRID_WAVES, max_new=HYBRID_MAX_NEW,
        model_layers=HYBRID_MODEL_LAYERS, full=False)
    for arch, rep in ((SSM_ARCH, ssm), (HYBRID_ARCH, hyb)):
        prof = rep["profile_prefill"]
        ported = prof["ported_kernels"]["ssd_chunk"]
        rep["ssd_chunk_prefill_device_ms"] = ported["us"] / prof["calls"] / 1e3
        log(f"  ssd_chunk in a {arch} prefill: "
            f"{rep['ssd_chunk_prefill_device_ms']:.2f} ms of device time in "
            f"{ported['count'] // prof['calls']} kernel launches "
            f"({', '.join(n[:40] for n in ported['symbols'])}), of "
            f"{rep['prefill_device_ms']:.2f} ms")
    report["ssm_serving"] = {SSM_ARCH: ssm, HYBRID_ARCH: hyb}

    # ---- 6. the figure engine, card vs CPU
    log("phase 6: the figure engine (Fig. 7 matrix, Fig. 8's 16-GPU point, "
        f"Fig. 9's Xtreme suite, Fig. 5's litmus), card vs CPU {elapsed()}")
    report["engine"] = check_engine(torch, np)

    # ---- 7. the sharded fabric on the card, card vs phase 3's CPU replay
    log("phase 7: the sharded fabric (phase 3's trace over a fabric group: "
        + ", ".join(f"{b} x {w}" for b, w in FABRIC_WORLDS) + f") "
        f"{elapsed()}")
    report["sharded"] = check_sharded(torch, np, fab_h, serv_h, rounds_h)

    # ---- 8. the training path at full width, card vs CPU
    log(f"phase 8: training {ARCH} at full width ({TRAIN_STEPS} steps, "
        f"checkpoint every {TRAIN_CKPT}, failure at {TRAIN_FAIL}, resume) "
        f"{elapsed()}")
    trained, report["training"] = check_training(torch, np, dev)
    for name in ("rmsnorm_bwd", "flash_attention_bwd"):
        launches[name] = trained[name]
    report["ssm_training"] = {}
    for arch, steps, ckpt, fail, layers in SSM_TRAIN:
        log(f"phase 8: training {arch} at full width "
            + (f"({PHASE8_LAYERS[arch]} layers) " if arch in PHASE8_LAYERS
               else "")
            + f"({steps} steps, checkpoint every {ckpt}, failure at {fail}, "
            f"resume) {elapsed()}")
        trained, report["ssm_training"][arch] = check_training(
            torch, np, dev, arch, steps, ckpt, fail, layers, extras=False)
        launches["ssd_chunk_bwd"] = launches.get("ssd_chunk_bwd", 0) \
            + trained["ssd_chunk_bwd"]

    # ---- 9. windowed attention and the modality frontends
    log(f"phase 9: {WINDOW_ARCH} served at full width, {AUDIO_ARCH} and "
        f"{VISION_ARCH} ({VISION_LAYERS} layers) through prefill "
        f"{elapsed()}")
    p9_counts, report["phase9"] = check_phase9(torch, np, dev)

    # ---- 10. MoE and MLA
    log(f"phase 10: {MLA_ARCH} and {MOE_ARCH} served at full width "
        f"({', '.join(f'{a}: {n} layers' for a, n, *_ in PHASE10)}) "
        f"{elapsed()}")
    p10_counts, report["phase10"] = check_phase10(torch, np, dev)

    # ---- 11. training at head dims 80 and 256 and MLA's (192, 128)
    log("phase 11: training " + ", ".join(
        f"{a} ({n} layers, {b} x {s})" for a, n, b, s, *_ in WIDE_TRAIN)
        + f" at full width, {WIDE_TRAIN_STEPS} steps {elapsed()}")
    # ---- 12. expert parallelism over a mesh of two ranks on the card,
    # run inside phase 11 while its last CPU check's worker runs on
    p12 = {}

    def phase12():
        log(f"phase 12: expert parallelism, {EP_ARCH} ({EP_LAYERS} layers) "
            f"served at full width on a {EP_MESH} mesh of gloo ranks sharing "
            f"the card, then the mesh train step at the smoke configs, "
            f"beside phase 11's last CPU check {elapsed()}")
        _, p12["report"] = check_phase12(torch, np)
        log(f"  (phase 12 ends, phase 11's last check follows) {elapsed()}")

    p11_counts, report["phase11"] = check_phase11(torch, np, dev,
                                                  beside=phase12)
    report["phase12"] = p12["report"]

    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    report["script_s"] = time.perf_counter() - t_start
    (out_dir / "chip_smoke.json").write_text(json.dumps(report, indent=1))
    log(f"phases 1-12 took {report['script_s']:.0f} s")

    # ---- 13. summary lines: each kernel's row at the main path's shapes
    main_shape = {"lease_probe": [64, 8], "miss_round": [8, 64, 1024],
                  "write_grant": [8, 64, 1024],
                  "rmsnorm": [SERVE_B * PROMPT_LEN, 960],
                  "flash_attention": [SERVE_B, PROMPT_LEN, 15, 5, 64],
                  "decode_attention": [SERVE_B, MAX_LEN, 15, 5, 64,
                                       PROMPT_LEN + 1],
                  "ssd_chunk": [SERVE_B, 2, 256, 24, 64, 128],
                  "rmsnorm_bwd": [TRAIN_B * TRAIN_S, 960],
                  "flash_attention_bwd": [TRAIN_B, TRAIN_S, TRAIN_S, 15, 5,
                                          64, 64, 1, 0],
                  "ssd_chunk_bwd": [TRAIN_B, 2, 256, 24, 64, 128]}
    line = []
    for name, source, replaces in KERNELS:
        row = max(kreport[name], key=lambda r: r["shape"][0])
        if name in main_shape:
            row = next(r for r in kreport[name]
                       if r["shape"] == main_shape[name]
                       and r.get("dtype", "bfloat16") == "bfloat16")
        line.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces, "launches": launches[name],
                     "max_abs_err": max(r["max_abs_err"]
                                        for r in kreport[name]),
                     "ms": row["ms"], "plain_ms": row["plain_ms"],
                     "bound_ms": row["bound_ms"],
                     "bound_by": row["bound_by"],
                     "library_ms": row.get("library_ms")})
    # the head dims phase 9 added, each at its model's prefill or decode
    # shape, its launches from phase 9's run of that model
    csrc = "src/repro_torch/kernels/csrc/"
    for name, kernel, source, arch, shape in (
            ("flash_attention_d256", "flash_attention",
             "flash_attention_wgmma.cu", WINDOW_ARCH, list(PHASE9_FLASH[0])),
            ("flash_attention_d80", "flash_attention",
             "flash_attention_wgmma.cu", AUDIO_ARCH, list(PHASE9_FLASH[2])),
            ("decode_attention_d256", "decode_attention",
             "decode_attention.cu", WINDOW_ARCH, list(PHASE9_DECODE[0]))):
        shape[5:6] = [int(shape[5])] if kernel == "flash_attention" \
            else shape[5:6]
        row = next(r for r in kreport[kernel] if r["shape"] == shape
                   and r["dtype"] == "bfloat16")
        replaces = next(r for n, _, r in KERNELS if n == kernel)
        line.append({"name": name, "route": "cuda", "source": csrc + source,
                     "replaces": replaces,
                     "launches": p9_counts[arch][kernel],
                     "max_abs_err": max(r["max_abs_err"]
                                        for r in kreport[kernel]
                                        if r["shape"][4] == shape[4]),
                     "ms": row["ms"], "plain_ms": row["plain_ms"],
                     "bound_ms": row["bound_ms"],
                     "bound_by": row["bound_by"],
                     "library_ms": row.get("library_ms")})
    # the shapes phase 10 added, each with its launches from phase 10's
    # run of that model
    for name, kernel, source, arch, shape in (
            ("flash_attention_d192_v128", "flash_attention",
             "flash_attention_wgmma.cu", MLA_ARCH, PHASE10_FLASH[0]),
            ("flash_attention_llama4", "flash_attention",
             "flash_attention_wgmma.cu", MOE_ARCH, PHASE10_FLASH[1]),
            ("decode_attention_llama4", "decode_attention",
             "decode_attention.cu", MOE_ARCH, PHASE10_DECODE[0])):
        shape = [int(x) for x in shape]
        rows = [r for r in kreport[kernel] if r["shape"] == shape]
        row = next(r for r in rows if r["dtype"] == "bfloat16")
        line.append({"name": name, "route": "cuda", "source": csrc + source,
                     "replaces": next(r for n, _, r in KERNELS
                                      if n == kernel),
                     "launches": p10_counts[arch][kernel],
                     "max_abs_err": max(r["max_abs_err"] for r in rows),
                     "ms": row["ms"], "plain_ms": row["plain_ms"],
                     "bound_ms": row["bound_ms"],
                     "bound_by": row["bound_by"],
                     "library_ms": row.get("library_ms")})
    # the backward at phase 11's head dims, each at its model's training
    # shape, its launches from phase 11's run of that model
    for (name, arch), (B, S, Hq, Hkv, D, Dv, causal, window) in zip(
            (("flash_attention_bwd_d80", AUDIO_ARCH),
             ("flash_attention_bwd_d256", WINDOW_ARCH),
             ("flash_attention_bwd_d192_v128", MLA_ARCH)), PHASE11_FLASH_BWD):
        shape = [B, S, S, Hq, Hkv, D, Dv, int(causal), window]
        rows = [r for r in kreport["flash_attention_bwd"]
                if r["shape"][5] == D]
        row = next(r for r in rows if r["shape"] == shape
                   and r["dtype"] == "bfloat16")
        line.append({"name": name, "route": "cuda",
                     "source": csrc + "flash_attention_bwd_wgmma.cu",
                     "replaces": next(r for n, _, r in KERNELS
                                      if n == "flash_attention_bwd"),
                     "launches": p11_counts[arch]["flash_attention_bwd"],
                     "max_abs_err": max(r["max_abs_err"] for r in rows),
                     "ms": row["ms"], "plain_ms": row["plain_ms"],
                     "bound_ms": row["bound_ms"],
                     "bound_by": row["bound_by"],
                     "library_ms": row.get("library_ms")})
    log(json.dumps({"kernels": line}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--fabric-rank"]:
        r, w, b, z, o = sys.argv[2:7]
        fabric_rank(int(r), int(w), b, z, o)
    elif sys.argv[1:2] == ["--model-rank"]:
        r, w, z, o = sys.argv[2:6]
        model_rank(int(r), int(w), z, o)
    else:
        main()
