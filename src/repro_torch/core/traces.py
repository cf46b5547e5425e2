"""Trace generators: the paper's Fig.5 litmus scenarios, the Xtreme synthetic
suite (§4.3.2, at block granularity), and generative models of the 11
standard benchmarks (Table 3).

The port's copy of ``repro.core.traces``: pure numpy, so every generator
gives arrays equal to the reference's for every config and seed.  The 11
standard benchmarks (STANDARD) map back to the paper's Table 3 suite by
footprint and memory-intensity class:

  =====  ==========================  =========  ========  ==================
  key    workload                    footprint  class     mix notes
  =====  ==========================  =========  ========  ==================
  aes    AES-256 encryption           71 MB     compute   table-lookup reuse
  atax   matrix-vector (A^T A x)      64 MB     memory    streaming, shared A
  bfs    breadth-first search        574 MB     memory    irregular, shared
                                                          frontier (70%)
  bicg   BiCGStab sub-kernels         64 MB     compute   two streamed MVs
  bs     black-scholes                67 MB     memory    50% writes, in-place
  fir    FIR filter                   67 MB     memory    sliding-window reuse
  fws    Floyd-Warshall               32 MB     memory    in-place shared
                                                          matrix (80% shared)
  mm     matrix multiply             192 MB     memory    tiled reuse (55%)
  mp     MaxPool                      64 MB     compute   dense conv-style
  rl     ReLU                         67 MB     memory    pure streaming
  conv   convolution                 145 MB     memory    stencil reuse (50%)
  =====  ==========================  =========  ========  ==================

Block granularity: one READ/WRITE per 64 B block touched; the 16 fp32 elements
a block holds are folded into a COMPUTE op (ALU + L1-hit cycles), which keeps
round counts tractable without changing miss behaviour.

For the figure engine a set of per-benchmark traces is padded to one dense
``[B, NC, R]`` tensor by ``pack_batch``: every trace is right-padded with
NOPs to the longest round count (NOP rounds advance no time and no
counters), and the batch axis becomes ``engine.sweep``'s benchmark axis.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np

from repro_torch.core.engine import COMPUTE, FENCE, NOP, READ, WRITE
from repro_torch.core.sysconfig import SystemConfig


def _pack(streams: List[List[Tuple[int, int]]]) -> Tuple[np.ndarray, np.ndarray]:
    """streams[cu] = [(op, addr), ...] -> padded [NC, T] arrays."""
    T = max(len(s) for s in streams)
    ops = np.zeros((len(streams), T), np.int32)
    addrs = np.zeros((len(streams), T), np.int32)
    for i, s in enumerate(streams):
        for t, (o, a) in enumerate(s):
            ops[i, t] = o
            addrs[i, t] = a
    return ops, addrs


def pack_batch(trace_list) -> Tuple[np.ndarray, np.ndarray]:
    """[(ops [NC, T_i], addrs [NC, T_i]), ...] -> ([B, NC, R], [B, NC, R]).

    Pads every trace with NOPs to the longest round count R so a benchmark
    batch is one dense tensor — the benchmark axis of
    ``engine.sweep``.  All traces must share NC (one CU grid per sweep)."""
    trace_list = list(trace_list)
    NC = trace_list[0][0].shape[0]
    R = max(o.shape[1] for o, _ in trace_list)
    B = len(trace_list)
    ops = np.zeros((B, NC, R), np.int32)
    addrs = np.zeros((B, NC, R), np.int32)
    for b, (o, a) in enumerate(trace_list):
        if o.shape[0] != NC:
            raise ValueError(f"trace {b} has NC={o.shape[0]}, expected {NC}")
        ops[b, :, :o.shape[1]] = o
        addrs[b, :, :a.shape[1]] = a
    return ops, addrs


# ------------------------------------------------------------------ litmus
def litmus_intra(cfg: SystemConfig):
    """Fig 5(a): CU0/CU1 of GPU0; X=5, Y=9 (distinct blocks, same GPU)."""
    X, Y = 5, 9
    s0 = [(READ, X), (WRITE, Y), (READ, X)]
    s1 = [(READ, Y), (WRITE, X), (READ, Y)]
    streams = [s0, s1] + [[] for _ in range(cfg.n_cus - 2)]
    # stagger exactly as the figure: I1-2 after I0-2, I1-3 after I0-3
    s0i = [s0[0], (NOP, 0), s0[1], s0[2], (NOP, 0), (NOP, 0)]
    s1i = [(NOP, 0), s1[0], (NOP, 0), (NOP, 0), s1[1], s1[2]]
    streams = [s0i, s1i] + [[(NOP, 0)] for _ in range(cfg.n_cus - 2)]
    return _pack(streams)


def litmus_inter(cfg: SystemConfig):
    """Fig 5(b): CU0 of GPU0 vs CU0 of GPU1 — same instructions.

    X and Y map to the SAME L2 bank (the paper's walkthrough treats the L2 as
    one logical cache with one cts; Table 2's per-bank clocks only see writes
    that route through the same bank — DESIGN.md §4 records this subtlety).
    """
    X, Y = 5, 5 + cfg.l2_banks
    s0 = [(READ, X), (NOP, 0), (WRITE, Y), (READ, X), (NOP, 0), (NOP, 0)]
    s1 = [(NOP, 0), (READ, Y), (NOP, 0), (NOP, 0), (WRITE, X), (READ, Y)]
    streams = [[(NOP, 0)] for _ in range(cfg.n_cus)]
    streams[0] = s0
    streams[cfg.cus_per_gpu] = s1            # CU0 of GPU1
    return _pack(streams)


# ------------------------------------------------------------------ Xtreme
@dataclasses.dataclass
class XtremeSpec:
    variant: int                  # 1 | 2 | 3
    blocks_per_slice: int         # slice size in 64B blocks (touched set)
    reps: int = 10
    compute_cycles: int = 160     # 16 elems x ~10 cycles FP+addressing each


def xtreme(cfg: SystemConfig, spec: XtremeSpec):
    """C = A + B with repeated writes (paper §4.3.2).

    Slices are assigned per-CU; variant 1 = private, 2 = intra-GPU sharing
    (CU_X0 writes CU_X1's slice), 3 = inter-GPU sharing (CU_X0 writes
    CU_Y1's slice).  FENCEs mark the kernel boundaries between steps.
    """
    NC = cfg.n_cus
    nb = spec.blocks_per_slice
    base_a, base_b, base_c = 0, NC * nb, 2 * NC * nb

    def slice_blocks(i):
        return np.arange(i * nb, (i + 1) * nb)

    def pass_over(i, dst_base, src1, src2, sl):
        out = []
        for b in sl:
            out += [(READ, src1 + b), (READ, src2 + b),
                    (COMPUTE, spec.compute_cycles), (WRITE, dst_base + b)]
        return out

    streams: List[List[Tuple[int, int]]] = [[] for _ in range(NC)]
    # step 1: every CU computes C_i = A_i + B_i on its own slice
    for i in range(NC):
        streams[i] += pass_over(i, base_c, base_a, base_b, slice_blocks(i))
    for i in range(NC):
        streams[i].append((FENCE, 0))

    if spec.variant == 1:
        # repeat step1 `reps` times, then A_i = C_i + B_i repeated
        for _ in range(spec.reps - 1):
            for i in range(NC):
                streams[i] += pass_over(i, base_c, base_a, base_b,
                                        slice_blocks(i))
        for i in range(NC):
            streams[i].append((FENCE, 0))
        for _ in range(spec.reps):
            for i in range(NC):
                streams[i] += pass_over(i, base_a, base_c, base_b,
                                        slice_blocks(i))
    else:
        victim = 1 if spec.variant == 2 else (cfg.cus_per_gpu + 1) % NC
        sl = slice_blocks(victim)
        for _ in range(spec.reps):
            streams[0] += pass_over(0, base_a, base_c, base_b, sl)
        for i in range(NC):
            streams[i].append((FENCE, 0))
        for i in range(NC):
            streams[i] += pass_over(i, base_c, base_a, base_b,
                                    slice_blocks(i))
    return _pack(streams)


# ------------------------------------------- standard benchmarks (Table 3)
@dataclasses.dataclass(frozen=True)
class BenchModel:
    name: str
    footprint_mb: float
    kind: str                 # "compute" | "memory"
    write_frac: float         # fraction of mem ops that write
    compute_per_mem: int      # COMPUTE cycles per memory op
    shared_frac: float        # accesses falling in the GPU-interleaved region
    reuse: float              # probability of re-touching a recent block
    rw_share: float = 0.05    # fraction of writes to read-write shared data
                              # (in-place algorithms: fws, bs ...)


# Type and footprints from Table 3; access-mix parameters follow each
# benchmark's published characterization (streaming reads, stencil reuse...).
# rw_share: the in-place algorithms (Floyd-Warshall's shared distance
# matrix, Black-Scholes' in-place price updates) write READ-WRITE SHARED
# data — the accesses that actually need coherence.  Calibrated against
# the paper's Fig 7 bars: large enough that the speedup sweeps exercise
# real write-sharing coherence misses (HMG pays invalidations, HALCONE
# self-invalidates — nonzero coh_miss counters), small enough that
# HALCONE stays within the paper's ~1%-overhead band of SM-WT-NC (our
# generative hot slice is far hotter than the paper's real traces, so a
# literal 80%-shared fws would overstate the coherence penalty ~10x).
# The streaming mixes stay at 0 (disjoint output slices, §5.1) and are
# bit-identical to the pre-hot-slice generator.
STANDARD: Dict[str, BenchModel] = {
    "aes":  BenchModel("aes", 71, "compute", 0.25, 220, 0.10, 0.30, 0.000),
    "atax": BenchModel("atax", 64, "memory", 0.10, 12, 0.50, 0.20, 0.000),
    "bfs":  BenchModel("bfs", 574, "memory", 0.15, 10, 0.70, 0.05, 0.000),
    "bicg": BenchModel("bicg", 64, "compute", 0.10, 150, 0.50, 0.20, 0.000),
    "bs":   BenchModel("bs", 67, "memory", 0.50, 14, 0.60, 0.10, 0.010),
    "fir":  BenchModel("fir", 67, "memory", 0.33, 16, 0.30, 0.40, 0.000),
    "fws":  BenchModel("fws", 32, "memory", 0.33, 12, 0.80, 0.15, 0.020),
    "mm":   BenchModel("mm", 192, "memory", 0.05, 40, 0.60, 0.55, 0.000),
    "mp":   BenchModel("mp", 64, "compute", 0.25, 160, 0.20, 0.25, 0.000),
    "rl":   BenchModel("rl", 67, "memory", 0.50, 10, 0.20, 0.10, 0.000),
    "conv": BenchModel("conv", 145, "memory", 0.12, 30, 0.50, 0.50, 0.000),
}


def standard_trace(cfg: SystemConfig, bench: BenchModel, rounds: int = 1536,
                   seed: int = 0):
    """Generative streaming trace with the benchmark's mix.

    Addresses: each GPU owns a private region sized by footprint share; a
    shared region (interleaved pages) receives `shared_frac` of accesses.
    Streaming = sequential block walk (stride 1) + `reuse` re-touches.

    ``rw_share`` benchmarks (in-place frontier/matrix updates) additionally
    target a small HOT slice at the base of the shared region with both a
    slice of their shared reads and their in-place writes — the accesses
    every GPU touches, i.e. the ones that actually exercise coherence
    (directory invalidations under HMG, self-invalidation under HALCONE;
    Fig 10).  With ``rw_share == 0`` — every STANDARD mix — the hot-slice
    paths are never taken and draw nothing from the rng, so those traces
    are bit-identical to the pre-hot-slice generator.
    """
    rng = np.random.default_rng(seed)
    NC, CU = cfg.n_cus, cfg.cus_per_gpu
    G, PB = cfg.n_gpus, cfg.page_blocks
    total_blocks = int(bench.footprint_mb * 1024 * 1024 / 64)
    # cap the address range so the sim's dense MM array stays small while
    # keeping cache-pressure >> capacity for big footprints
    total_blocks = min(total_blocks, 1 << 20)
    shared_blocks = max(1024, int(total_blocks * 0.5))
    priv_blocks = max(512, (total_blocks - shared_blocks) // cfg.n_gpus)
    priv_blocks = (priv_blocks + PB - 1) // PB * PB      # page aligned

    def priv_addr(g: int, b: int) -> int:
        # private data lives on pages OWNED by gpu g (home_gpu == g), the
        # placement a programmer uses under RDMA; SM interleaving unaffected
        page, off = divmod(b, PB)
        return (page * G + g) * PB + off

    ops = np.zeros((NC, rounds), np.int32)
    addrs = np.zeros((NC, rounds), np.int32)
    shared_base = priv_blocks * cfg.n_gpus
    gpu_start = rng.integers(0, shared_blocks, cfg.n_gpus)
    # interleave compute ops: 1 per `duty` rounds carries the compute budget
    duty = 4 if bench.kind == "compute" else 8
    half = priv_blocks // 2                      # inputs | outputs split
    for cu in range(NC):
        g = cu // CU
        pos = rng.integers(0, half)
        pos_w = rng.integers(0, half)
        # shared walks are gpu-clustered (neighbouring CUs stream the same
        # region) so temporal/spatial locality exists for caches to exploit
        pos_sh = (gpu_start[g] + (cu % CU) * 4) % shared_blocks
        recent = np.zeros(8, np.int64)
        for t in range(rounds):
            if t % 512 == 511:                 # kernel boundary (fence)
                ops[cu, t] = FENCE
                continue
            if t % duty == duty - 1:
                ops[cu, t] = COMPUTE
                addrs[cu, t] = bench.compute_per_mem * duty
                continue
            write = rng.random() < bench.write_frac
            r = rng.random()
            if write and rng.random() < bench.rw_share:
                # in-place update of shared read-write data (fws/bs-style):
                # the accesses that actually need coherence.  Targets the
                # hot slice every GPU reads (below), not this CU's private
                # walk position — otherwise no other GPU ever shares the
                # line and no protocol has anything to invalidate.
                a = shared_base + int(rng.integers(0, 2 * PB))
            elif write:
                # streaming kernels write each output once; output slices are
                # DISJOINT per CU (standard C=A+B partitioning — no write
                # sharing, which is what keeps coherency misses rare, §5.1)
                out_slice = max(16, half // CU)
                pos_w = (pos_w + 1) % out_slice
                a = priv_addr(g, half + ((cu % CU) * out_slice + pos_w)
                              % half)
            elif r < bench.reuse:
                a = recent[rng.integers(0, 8)]   # re-READ of an input
            elif r < bench.reuse + bench.shared_frac:
                # subdivide the already-drawn r: an rw_share-sized tail of
                # the shared reads hits the hot in-place slice (empty when
                # rw_share == 0 -> identical stream for streaming mixes)
                if r >= bench.reuse + bench.shared_frac * (1 - bench.rw_share):
                    a = shared_base + int(rng.integers(0, 2 * PB))
                else:
                    pos_sh = (pos_sh + 1) % shared_blocks
                    a = shared_base + pos_sh
                recent[t % 8] = a
            else:
                pos = (pos + 1) % half
                a = priv_addr(g, (pos + cu * 131) % half)
                recent[t % 8] = a
            ops[cu, t] = WRITE if write else READ
            addrs[cu, t] = a
    return ops, addrs
