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
     — exact equality on every output.  The float kernels (rmsnorm,
     flash attention, decode attention) at the LLM serving path's shapes
     and at odd ones, in bf16 and in f32, within stated tolerances, with
     the time of one PyTorch library call of the same function beside
     them (timed only: the port never calls it);
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
     must all be > 0; then a closed-loop and an open-loop replay on the
     card with the wall clock (requests/s, p50/p99);
  4. the LLM serving path at full width: ``runtime.server.Server`` with
     smollm-360m (32 layers, d_model 960, vocab 49152, seeded weights on
     the card), batch 8, 512-token prompts, 64 new tokens, four waves of
     8 requests whose group prompt repeats, so waves 2-4 are served from
     live leases; the float kernels' launch counts of this run must all
     be > 0, a prefix payload must be unchanged after decoding from it,
     ``serve_stream`` must equal sequential ``serve``, the card's lease
     and fabric counters and grant log must equal a CPU server's on the
     same stream (1 layer deep: the fabric sees only keys), and at 4
     layers the card's final hidden state and first-token logits must
     equal the port on the CPU within a relative L2 of 2e-2; then
     prefill and decode times, generated tokens/s and host time per
     decode step;
  5. the kernel summary line, then ``{"ok": true, "device": ...}`` last.

``--profile`` adds one closed-loop replay under ``torch.profiler`` after
phase 3: the device's busy and idle share of the wall clock, device time
by kernel and the host's top operators (in ``chip_smoke.json``).  Phase
4 always profiles two prefills and eight decode steps the same way; the
tables go to ``chip_smoke.json``.

It needs a CUDA card, and the repository's ``src/`` beside it.  Details go
to ``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import collections
import json
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
            "src/repro_torch/kernels/csrc/flash_attention.cu",
            "src/repro/kernels/flash_attention.py:79"),
           ("decode_attention",
            "src/repro_torch/kernels/csrc/decode_attention.cu",
            "src/repro/kernels/decode_attention.py:63"))
# phase 4: the LLM serving path
ARCH = "smollm-360m"
SERVE_B, PROMPT_LEN, MAX_NEW = 8, 512, 64
MAX_LEN = PROMPT_LEN + MAX_NEW + 8
N_WAVES = 4
# depth (and batch) cut on the CPU side only, to keep the run short
CPU_FABRIC_LAYERS = 1        # the CPU server that checks the fabric
CPU_MODEL_LAYERS = 4         # card vs CPU model comparison, full width
CPU_MODEL_BATCH = 2
WEIGHT_SEED = 0
# kernel vs plain version: f32 is the same math summed in another order;
# bf16 rounds the f32 result once on both sides (2^-8 relative steps)
FLOAT_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
MODEL_REL_L2 = 2e-2          # card vs CPU model in bf16


def log(*a) -> None:
    print(*a, flush=True)


# ------------------------------------------------------------------ timing
def device_ms(torch, fn, n=20, trials=5) -> float:
    """Median CUDA-event time of one call of ``fn``: a sleep kernel holds
    the stream while the host enqueues ``n`` calls, so the events time
    the calls back to back on the device, not the host's launch rate."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(trials):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(200_000_000)
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


def probe_case(rng, N, W):
    """lease_probe inputs: gathered set rows WITH the trash way (the
    kernel gets the strided [:, :-1] view, as the fabric passes it)."""
    import numpy as np
    tag = rng.integers(-1, 12, (N, W + 1)).astype(np.int32)
    tag[::3, 1 % W] = tag[::3, 0]                  # duplicate tags
    tag[1::5] = -1                                 # empty set rows
    rts = rng.integers(65500, 65535, (N, W + 1)).astype(np.int32)
    cts = rng.integers(65500, 65535, N).astype(np.int32)
    addr = rng.integers(0, 12, N).astype(np.int32)
    mwts = rng.integers(65520, 65535, N).astype(np.int32)
    mrts = (mwts + rng.integers(1, 9, N)).astype(np.int32)
    return tag, rts, cts, addr, mwts, mrts


def probe_bound(tag, addr):
    N, W1 = tag.shape
    W = W1 - 1
    f = _first(tag[:, :-1], addr)
    scanned = int((f + 1).sum() + (f < 0).sum() * W)
    nbytes = 4 * scanned + 4 * int((f >= 0).sum()) + 16 * N + 22 * N
    ops = scanned + 8 * N
    return nbytes, ops


def miss_case(rng, N, W1, W2, C):
    import numpy as np
    r = lambda lo, hi, shp: rng.integers(lo, hi, shp).astype(np.int32)
    rp_tag, sh_tag, ts_tag = r(-1, 40, (N, W1 + 1)), r(-1, 40, (N, W2 + 1)), \
        r(-1, 4000, (N, C + 1))
    rp_tag[::4, 1] = rp_tag[::4, 0]                # duplicate tags
    addr = r(0, 40, N)
    ts_tag[::2, 7] = addr[::2]                     # TSU hits on half the lanes
    ts_tag[1::6, :] = -1                           # empty TSU rows
    ts_mem = r(65520, 65535, (N, C + 1))           # clocks within rd of TS_MAX
    return ([rp_tag, r(0, 40, (N, W1 + 1)), sh_tag, r(0, 40, (N, W2 + 1)),
             r(0, 40, (N, W2 + 1)), ts_tag, ts_mem],
            [r(0, 40, N), r(0, 40, N), addr, r(0, 2, N),
             np.full(N, 8, np.int32)])


def miss_bound(rows, vecs):
    N = vecs[0].shape[0]
    addr = vecs[2]
    nbytes, ops = 20 * N + 46 * N, 30 * N
    for tags, vals in ((rows[0], (rows[1],)), (rows[2], rows[3:5]),
                       (rows[5], (rows[6],))):
        W = tags.shape[1] - 1
        f = _first(tags[:, :-1], addr)
        scanned = int((f + 1).sum() + (f < 0).sum() * W)
        nbytes += 4 * scanned + 4 * len(vals) * int((f >= 0).sum())
        ops += scanned
    return nbytes, ops


def grant_case(rng, N, C):
    import numpy as np
    tag = rng.integers(0, 6000, (N, C + 1)).astype(np.int32)   # full rows
    tag[1::4, 5::3] = -1                           # partly full rows
    tag[2::8, :] = -1                              # empty rows
    addr = rng.integers(0, 6000, N).astype(np.int32)
    tag[::3, 11] = addr[::3]                       # hits on a third
    mem = rng.integers(65528, 65535, (N, C + 1)).astype(np.int32)  # ties
    seq = rng.integers(0, 64, (N, C + 1)).astype(np.int32)
    wl = rng.integers(1, 9, N).astype(np.int32)
    return [tag, mem, seq], [addr, wl]


def grant_bound(rows, vecs):
    import numpy as np
    tag, mem, seq = (a[:, :-1] for a in rows)
    N, C = tag.shape
    valid = tag != -1
    p = np.where(valid, mem, -2 ** 30)
    tie = p == p.min(1, keepdims=True)
    nbytes = 4 * (tag.size + int(valid.sum()) + int(tie.sum())) + 8 * N \
        + 19 * N
    return nbytes, 3 * tag.size + 10 * N


# ------------------------------------------------------------- phase 2
def check_kernels(torch, np, dev, report):
    from repro_torch.kernels import ref
    from repro_torch.kernels.lease_probe import lease_probe
    from repro_torch.kernels.tier_pass import miss_round, write_grant

    rng = np.random.default_rng(2026)
    T = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def compare(name, kern, plain, args, bound, shape):
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
        ms = device_ms(torch, lambda: kern(*args))
        plain_ms = device_ms(torch, lambda: plain(*args))
        nbytes, ops = bound
        bt, ot = nbytes / HBM_BYTES_PER_S * 1e3, ops / OPS_PER_S * 1e3
        row = {"shape": shape, "max_abs_err": err, "ms": ms,
               "plain_ms": plain_ms, "bound_ms": max(bt, ot),
               "bound_by": "bytes" if bt >= ot else "operations",
               "bytes": nbytes, "ops": ops}
        report.setdefault(name, []).append(row)
        log(f"  {name}{shape}: exact; kernel {ms * 1e3:.2f} us, plain "
            f"{plain_ms * 1e3:.2f} us, bound {row['bound_ms'] * 1e3:.4f} us "
            f"({row['bound_by']})")

    for N in (1, 64, 4096):
        for W in (2, 8):
            tag, rts, *vecs = probe_case(rng, N, W)
            args = (T(tag)[:, :-1], T(rts)[:, :-1], *map(T, vecs))
            compare("lease_probe", lease_probe, ref.lease_probe_ref, args,
                    probe_bound(tag, vecs[1]), [N, W])
    rows, vecs = miss_case(rng, 256, 8, 8, 1024)
    compare("miss_round", miss_round, ref.miss_round_ref,
            [T(a)[:, :-1] for a in rows] + [T(v) for v in vecs],
            miss_bound(rows, vecs), [256, 8, 8, 1024])
    rows, vecs = grant_case(rng, 256, 1024)
    compare("write_grant", write_grant, ref.write_grant_ref,
            [T(a)[:, :-1] for a in rows] + [T(v) for v in vecs],
            grant_bound(rows, vecs), [256, 1024])


# ------------------------------------------------ phase 2, float kernels
def _visible_pairs(Sq, Sk, causal):
    """(query, key) pairs the causal mask leaves visible."""
    if not causal:
        return Sq * Sk
    return sum(min(i + 1, Sk) for i in range(Sq))


def check_float_kernels(torch, np, dev, report):
    """rmsnorm, flash and decode attention against their plain versions on
    the card at the serving path's shapes and odd ones, bf16 and f32;
    each row with kernel, plain and library times and the bound."""
    import torch.nn.functional as F

    from repro_torch.kernels import ref
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.rmsnorm import rmsnorm

    def randn(shape, dtype, seed):
        a = np.random.default_rng(seed).standard_normal(shape)
        return torch.from_numpy(a.astype(np.float32)).to(dev, dtype)

    def compare(name, kern, plain, library, nbytes, flops, dtype, shape):
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
               "max_abs_err": err, "tol": tol, "ms": device_ms(torch, kern),
               "plain_ms": device_ms(torch, plain),
               "library_ms": device_ms(torch, library),
               "bound_ms": max(bt, ot),
               "bound_by": "bytes" if bt >= ot else "operations",
               "bytes": nbytes, "flops": flops}
        report.setdefault(name, []).append(row)
        log(f"  {name}{shape} {row['dtype']}: max |err| {err:.3g} <= {tol}; "
            f"kernel {row['ms'] * 1e3:.2f} us, plain "
            f"{row['plain_ms'] * 1e3:.2f} us, library "
            f"{row['library_ms'] * 1e3:.2f} us, bound "
            f"{row['bound_ms'] * 1e3:.3f} us ({row['bound_by']})")

    log(f"  float tolerances (rtol = atol): {FLOAT_TOL}; f32 is the same "
        "math summed in another order, bf16 rounds the f32 result once")
    eps = 1e-6
    for dtype in (torch.bfloat16, torch.float32):
        el = torch.finfo(dtype).bits // 8
        for R, D in ((SERVE_B * PROMPT_LEN, 960), (7, 80)):
            x = randn((R, D), dtype, R + D)
            w = randn((D,), torch.float32, D) * 0.1
            w1 = (1.0 + w).to(dtype)
            compare("rmsnorm", lambda: rmsnorm(x, w, eps=eps),
                    lambda: ref.rmsnorm_ref(x, w, eps),
                    lambda: F.rms_norm(x, (D,), weight=w1, eps=eps),
                    2 * R * D * el + 4 * D, 4 * R * D, dtype, [R, D])
        for S in (PROMPT_LEN, 100):
            B, Hq, Hkv, D = SERVE_B, 15, 5, 64
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
                    [B, S, Hq, Hkv, D])
        B, Sk, Hq, Hkv, D = SERVE_B, MAX_LEN, 15, 5, 64
        q = randn((B, 1, Hq, D), dtype, 4)
        k = randn((B, Sk, Hkv * D), dtype, 5).view(B, Sk, Hkv, D)
        v = randn((B, Sk, Hkv * D), dtype, 6).view(B, Sk, Hkv, D)
        for kv_len in (1, PROMPT_LEN + 1, MAX_LEN):
            qt = q.transpose(1, 2)
            kt, vt = (t[:, :kv_len].transpose(1, 2) for t in (k, v))
            compare("decode_attention",
                    lambda: decode_attention(q, k, v, kv_len),
                    lambda: ref.attention_ref(q, k, v, causal=False,
                                              kv_len=kv_len),
                    lambda: F.scaled_dot_product_attention(
                        qt, kt, vt, enable_gqa=True),
                    (2 * B * Hq * D + 2 * B * kv_len * Hkv * D) * el,
                    4 * D * B * Hq * kv_len, dtype,
                    [B, Sk, Hq, Hkv, D, kv_len])


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

    def read_batch_async(self, keys, replica):
        from repro_torch.coherence.fabric import ReadBatchHandle
        assert replica == self.reader.replica
        h = self.reader.get_batch_async(keys)
        return ReadBatchHandle(lambda: self._record(h.result()))

    def _record(self, out):
        self.served.append(out)
        return out

    def write_batch(self, items, replica):
        assert replica == self.writer.replica
        self.writer.put_batch(items)

    def fence(self):
        return self.writer.fence()


def key_of(k: int) -> str:
    return f"prefix/{k}"


def build_fabric(device):
    from repro_torch.coherence.fabric import FabricConfig, default_fabric
    cfg = FabricConfig(n_shards=8, rd_lease=8, wr_lease=4,
                       replica_sets=1024, replica_ways=8,
                       shared_sets=2048, shared_ways=8)
    return default_fabric(cfg, n_nodes=2, replicas_per_node=2,
                          device=device)


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


def replay_modeled(device, trace):
    from repro_torch.runtime import scheduler
    fab = build_fabric(device)
    serving = Serving(fab)
    t0 = time.perf_counter()
    warm(serving)
    t1 = time.perf_counter()
    wave = service_model(MAX_BATCH)
    pol = scheduler.BatchPolicy(mode="continuous", max_batch=MAX_BATCH,
                                min_bucket=8, max_wait_s=1.5 * wave)
    tr = trace.scaled(0.7 * (MAX_BATCH / wave) / trace.offered_rps)
    res = scheduler.replay(serving, tr, pol, republish_every=REPUBLISH_EVERY,
                           republish_n=REPUBLISH_N,
                           service_model=service_model)
    t2 = time.perf_counter()
    return fab, serving, res, t1 - t0, t2 - t1


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


def wall_replays(torch, np, fab, trace):
    """Closed-loop capacity, then open-loop at 0.7x capacity, wall clock."""
    from repro_torch.runtime import scheduler
    serving = Serving(fab)
    pol = scheduler.BatchPolicy(mode="continuous", max_batch=MAX_BATCH,
                                min_bucket=8)
    torch.cuda.synchronize()
    cap = scheduler.replay(serving, trace.scaled(1e9), pol,
                           republish_every=REPUBLISH_EVERY,
                           republish_n=REPUBLISH_N)
    cap_rps = cap.n_requests / max(cap.t_end, 1e-9)
    svc_wave = cap.t_end / max(len(cap.batch_sizes), 1)
    pol = scheduler.BatchPolicy(mode="continuous", max_batch=MAX_BATCH,
                                min_bucket=8,
                                max_wait_s=max(1.5 * svc_wave, 1e-3))
    tr = trace.scaled(0.7 * cap_rps / trace.offered_rps)
    res = scheduler.replay(serving, tr, pol, republish_every=REPUBLISH_EVERY,
                           republish_n=REPUBLISH_N)
    torch.cuda.synchronize()
    lat = res.latency_s * 1e6
    out = {"capacity_rps": cap_rps,
           "capacity_p50_us": float(np.percentile(cap.latency_s * 1e6, 50)),
           "capacity_p99_us": float(np.percentile(cap.latency_s * 1e6, 99)),
           "offered_rps": 0.7 * cap_rps,
           "achieved_rps": res.n_requests / max(res.t_end, 1e-9),
           "p50_us": float(np.percentile(lat, 50)),
           "p99_us": float(np.percentile(lat, 99)),
           "waves": len(res.batch_sizes),
           "mean_batch": float(np.mean(res.batch_sizes)),
           "svc_wave_us": svc_wave * 1e6}
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
                  "rmsnorm": ("rmsnorm_kernel",),
                  "flash_attention": ("flash_kernel",),
                  "decode_attention": ("decode_split_kernel",
                                       "decode_combine_kernel")}


def device_breakdown(prof, wall_us):
    """From a ``torch.profiler`` run over ``wall_us`` of wall clock: the
    device's busy time (the union of its kernel and copy intervals) and
    idle share, device time by kernel name, the ported kernels' share and
    the host's top operators by self time."""
    from torch.autograd import DeviceType
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
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
    top_dev = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:15]
    ported = {name: [sum(v[i] for n, v in by_name.items()
                         if any(sym in n for sym in syms)) for i in (0, 1)]
              for name, syms in KERNEL_SYMBOLS.items()}
    top_host = sorted(((a.key, a.count, a.self_cpu_time_total)
                       for a in prof.key_averages()
                       if a.self_cpu_time_total > 0),
                      key=lambda r: -r[2])[:15]
    return {"wall_us": wall_us, "device_busy_us": busy_us,
            "device_idle_share": 1.0 - busy_us / wall_us,
            "device_events": len(dev),
            "device_by_name": [{"name": n[:120], "count": c, "us": us}
                               for n, (c, us) in top_dev],
            "ported_kernels": {n: {"count": c, "us": us}
                               for n, (c, us) in ported.items()},
            "host_by_op": [{"op": k[:120], "count": c, "self_us": us}
                           for k, c, us in top_host]}


def profile_calls(torch, fn, calls):
    """``calls`` calls of ``fn`` (each ending in a host sync, as the
    serving loop's steps do) under ``torch.profiler``: the device's busy
    time per call and ``device_breakdown``'s tables."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        wall_us = (time.perf_counter() - t0) * 1e6
    out = device_breakdown(prof, wall_us)
    out.update({"calls": calls,
                "device_ms_per_call": out["device_busy_us"] / calls / 1e3})
    return out


# ------------------------------------------------------------- phase 4
def serve_waves(np, vocab):
    """``N_WAVES`` waves of ``SERVE_B`` requests; request i's prompt is
    drawn with seed i % SERVE_B (``launch/serve.py``'s rule), so every
    wave is one decode group with wave 1's group prompt."""
    from repro_torch.runtime.server import Request
    prompts = [np.random.default_rng(seed).integers(
        2, vocab, PROMPT_LEN).astype(np.int32) for seed in range(SERVE_B)]
    reqs = [Request(rid=i, prompt=prompts[i % SERVE_B], max_new=MAX_NEW)
            for i in range(N_WAVES * SERVE_B)]
    return [reqs[w * SERVE_B:(w + 1) * SERVE_B] for w in range(N_WAVES)]


def leaves(tree):
    """The tensors of a payload ``(cache tree, first ids)``, in order."""
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in leaves(tree[k])]
    if isinstance(tree, tuple):
        return [t for x in tree for t in leaves(x)]
    return [tree]


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


def serve_timings(torch, np, cfg, srv, tokens):
    """Prefill and decode-step times at the serving shapes: wall clock
    with the server's per-step host sync and the host's enqueue time per
    step, then the device's busy time per prefill and per decode step
    from ``torch.profiler`` (the union of its kernel and copy
    intervals)."""
    from repro_torch.models import decode_step, init_cache, prefill

    def run_prefill():
        return prefill(cfg, srv.params, tokens,
                       init_cache(cfg, SERVE_B, MAX_LEN, tokens.device))

    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        nxt, cache = run_prefill()
        nxt.cpu()
        walls.append(time.perf_counter() - t0)
    host, steps = [], []
    ids0, cache0 = nxt, cache
    for t in range(MAX_NEW - 1):
        t0 = time.perf_counter()
        nxt, cache = decode_step(cfg, srv.params, cache, nxt[:, None],
                                 PROMPT_LEN + t)
        t1 = time.perf_counter()
        nxt.cpu()
        host.append(t1 - t0)
        steps.append(time.perf_counter() - t0)
    prof_prefill = profile_calls(torch, lambda: run_prefill()[0].cpu(), 2)
    prof_decode = profile_calls(
        torch, lambda: decode_step(cfg, srv.params, cache0, ids0[:, None],
                                   PROMPT_LEN)[0].cpu(), 8)
    return {"prefill_ms": statistics.median(walls) * 1e3,
            "prefill_device_ms": prof_prefill["device_ms_per_call"],
            "decode_step_ms": statistics.mean(steps) * 1e3,
            "decode_host_ms": statistics.mean(host) * 1e3,
            "decode_device_ms": prof_decode["device_ms_per_call"],
            "profile_prefill": prof_prefill, "profile_decode": prof_decode}


def check_serving(torch, np, dev, report):
    """The LLM serving path at full width on the card (phase 4)."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.lease_probe import lease_probe
    from repro_torch.kernels.rmsnorm import rmsnorm
    from repro_torch.kernels.tier_pass import miss_round, write_grant
    from repro_torch.models import cast_params, forward, init_model
    from repro_torch.models.model import tree_map, unembed_matrix
    from repro_torch.runtime.server import Server

    cfg = configs.get(ARCH)
    waves = serve_waves(np, cfg.vocab)
    t0 = time.perf_counter()
    params = init_model(cfg, torch.Generator(dev).manual_seed(WEIGHT_SEED))
    srv = Server(cfg, params, batch_size=SERVE_B, max_len=MAX_LEN,
                 device=dev)
    torch.cuda.synchronize()
    log(f"  {ARCH}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.n_heads}/{cfg.n_kv_heads} heads, vocab {cfg.vocab}; weights "
        f"on the card in {time.perf_counter() - t0:.1f} s")
    posted = []
    put = srv.kv.put_batch
    srv.kv.put_batch = lambda items: (posted.extend(items), put(items))

    counters = (rmsnorm, flash_attention, decode_attention, lease_probe,
                miss_round, write_grant)
    for fn in counters:
        fn.launches = 0
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
    log(f"  card: {N_WAVES} waves x {SERVE_B} requests, prompts "
        f"{PROMPT_LEN}, {MAX_NEW} new tokens: "
        f"{', '.join(f'{x:.2f}' for x in walls)} s per wave; lease hits "
        f"after each wave {hits}; launches {launches}")
    if hits[1] < 1:
        raise AssertionError("wave 2 was not served from a lease")
    if min(launches[fn.__name__] for fn in counters[:3]) < 1:
        raise AssertionError(f"a float kernel was not launched: {launches}")
    if len(posted) != 1 or not all(
            torch.equal(a, b) for a, b in zip(snap, leaves(posted[0][1]))):
        raise AssertionError("the prefix payload changed while decoding "
                             "from it")
    want = {i: out[i % SERVE_B] for i in range(N_WAVES * SERVE_B)}
    for rid, toks in out.items():
        if toks.shape != (MAX_NEW,) or toks.dtype != np.int32 or \
                toks.min() < 0 or toks.max() >= cfg.vocab:
            raise AssertionError(f"request {rid}: bad tokens {toks}")
        if not np.array_equal(toks, want[rid]):
            raise AssertionError(f"request {rid}: a lease hit decoded "
                                 "other tokens than the prefill wave")
    log("  wave 2 served from a lease; the prefix payload is bit-identical "
        "after decoding from it; waves 2-4 give wave 1's tokens")

    srv_s = Server(cfg, params, batch_size=SERVE_B, max_len=MAX_LEN,
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

    cfg2 = dataclasses.replace(cfg, n_layers=CPU_FABRIC_LAYERS)
    srv_h = Server(cfg2, init_model(cfg2, torch.Generator().manual_seed(
        WEIGHT_SEED)), batch_size=SERVE_B, max_len=MAX_LEN, device="cpu")
    t0 = time.perf_counter()
    for wave in waves:
        srv_h.serve(wave)
    cpu_s = time.perf_counter() - t0
    compare_servers(srv, srv_h, "card vs CPU")
    log(f"  card == CPU ({CPU_FABRIC_LAYERS} layers, {cpu_s:.1f} s): "
        f"lease-cache counters {srv.cache_stats}, fabric counters, grant "
        f"log ({len(srv.fabric.grant_log)} grants)")

    cfg4 = dataclasses.replace(cfg, n_layers=CPU_MODEL_LAYERS)
    p4 = cast_params(cfg4, init_model(
        cfg4, torch.Generator(dev).manual_seed(WEIGHT_SEED)))
    p4h = tree_map(lambda t: t.cpu(), p4)
    tok = torch.from_numpy(np.stack([r.prompt for r in waves[0]]))
    tok4 = tok[:CPU_MODEL_BATCH]
    h_c, _ = forward(cfg4, p4, tok4.to(dev))
    h_h, _ = forward(cfg4, p4h, tok4)
    lg_c = h_c[:, -1] @ unembed_matrix(cfg4, p4)
    lg_h = h_h[:, -1] @ unembed_matrix(cfg4, p4h)
    errs = {"hidden_rel_l2": rel_l2(h_c, h_h),
            "logits_rel_l2": rel_l2(lg_c, lg_h)}
    if not all(torch.isfinite(t).all() for t in (h_c, lg_c)) or \
            max(errs.values()) > MODEL_REL_L2:
        raise AssertionError(f"card vs CPU model at {CPU_MODEL_LAYERS} "
                             f"layers: {errs} (limit {MODEL_REL_L2})")
    log(f"  card == CPU model at {CPU_MODEL_LAYERS} layers, full width, "
        f"batch {CPU_MODEL_BATCH}, bf16: relative L2 {errs} <= "
        f"{MODEL_REL_L2}")

    tm = serve_timings(torch, np, cfg, srv, tok.to(dev))
    tokens_out = N_WAVES * SERVE_B * MAX_NEW
    tm.update({"serve_s": serve_s, "wave_s": walls,
               "tokens_per_s": tokens_out / serve_s,
               "hit_wave_tokens_per_s": SERVE_B * MAX_NEW
               / statistics.mean(walls[1:]),
               "decode_device_idle_share":
               1.0 - tm["decode_device_ms"] / tm["decode_step_ms"]})
    log(f"  prefill (B={SERVE_B}, S={PROMPT_LEN}) {tm['prefill_ms']:.1f} ms "
        f"wall, {tm['prefill_device_ms']:.1f} ms device; decode step "
        f"{tm['decode_step_ms']:.2f} ms wall (host enqueue "
        f"{tm['decode_host_ms']:.2f} ms, device "
        f"{tm['decode_device_ms']:.2f} ms, idle share "
        f"{tm['decode_device_idle_share']:.2f}); {tm['tokens_per_s']:.0f} "
        f"generated tokens/s over the 4 waves, "
        f"{tm['hit_wave_tokens_per_s']:.0f} in a lease-hit wave")
    report["serving"] = {"launches": launches, "lease_hits": hits,
                         "model_errs": errs, "stream_s": stream_s,
                         "cpu_fabric_check_s": cpu_s,
                         "cache_stats": srv.cache_stats,
                         "fabric_stats": srv.fabric_stats, **tm}
    prof = tm["profile_decode"]
    top = ", ".join(f"{r['name'][:40]} {r['us'] / prof['calls']:.0f} us"
                    for r in prof["device_by_name"][:4])
    host = ", ".join(f"{r['op']} {r['self_us'] / prof['calls'] / 1e3:.2f} ms"
                     for r in prof["host_by_op"][:4])
    log(f"  a profiled decode step: {prof['device_events'] / prof['calls']:.0f}"
        f" device events; device by kernel: {top}; host by op (self): "
        f"{host}")
    return launches


# ------------------------------------------------------------------ main
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
        "float within tolerance)")
    kreport = {}
    check_kernels(torch, np, dev, kreport)
    check_float_kernels(torch, np, dev, kreport)
    report["kernels"] = kreport
    check_no_sync(torch, np)
    log("  miss-path dispatch enqueues with no host sync (sync debug mode)")

    # ---- 3. the main path, card vs CPU
    log(f"phase 3: main path, {N_KEYS} keys, {N_REQUESTS} requests")
    trace = loadgen.synthesize(N_REQUESTS, N_KEYS, a=1.2, process="diurnal",
                               rate=1.0, amplitude=0.9, cycles=3.0, seed=7)
    counters = (lease_probe, miss_round, write_grant)
    for fn in counters:
        fn.launches = 0
    fab_c, serv_c, res_c, warm_c, rep_c = replay_modeled(dev, trace)
    torch.cuda.synchronize()
    launches = {fn.__name__: fn.launches for fn in counters}
    log(f"  card: warm {warm_c:.1f} s, replay {rep_c:.1f} s, "
        f"{len(res_c.batch_sizes)} waves; launches {launches}")
    if min(launches.values()) < 1:
        raise AssertionError(f"a kernel was not launched: {launches}")
    fab_h, serv_h, res_h, warm_h, rep_h = replay_modeled(
        torch.device("cpu"), trace)
    log(f"  cpu:  warm {warm_h:.1f} s, replay {rep_h:.1f} s")
    compare_fabrics(np, fab_c, fab_h, serv_c, serv_h)
    check_outputs(res_c, fab_c, serv_c)
    log("  card == cpu: served results, grant log, counters, replica "
        "counters, memts of every key, whole fabric state")
    st = fab_c.stats()
    report["main_path"] = {"launches": launches, "warm_s": warm_c,
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
    log(f"phase 4: LLM serving path, {ARCH} at full width")
    served = check_serving(torch, np, dev, report)
    launches.update({k: v for k, v in served.items() if k not in launches})

    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(report, indent=1))

    # ---- 5. summary lines: each kernel's row at the main path's shapes
    main_shape = {"lease_probe": [64, 8],
                  "rmsnorm": [SERVE_B * PROMPT_LEN, 960],
                  "flash_attention": [SERVE_B, PROMPT_LEN, 15, 5, 64],
                  "decode_attention": [SERVE_B, MAX_LEN, 15, 5, 64,
                                       PROMPT_LEN + 1]}
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
    log(json.dumps({"kernels": line}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
