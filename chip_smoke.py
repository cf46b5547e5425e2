#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one
NVIDIA H100.

    python3 chip_smoke.py [--profile]

Phases (any failure raises and the script exits non-zero):

  1. card and build: the card's name and power limit, then the three CUDA
     kernels built from ``src/repro_torch/kernels/csrc`` for ``sm_90a``;
  2. each kernel against its plain PyTorch version on the card, at the
     main path's shapes, on seeded inputs with duplicate tags, empty ways,
     full and partly-full TSU rows and clocks near ``TS_MAX`` — exact
     equality on every output — with CUDA-event timings and each
     kernel's bound;
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
  4. the kernel summary line, then ``{"ok": true, "device": ...}`` last.

``--profile`` adds one closed-loop replay under ``torch.profiler`` after
phase 3: the device's busy and idle share of the wall clock, device time
by kernel and the host's top operators (in ``chip_smoke.json``).

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
KERNELS = (("lease_probe", "src/repro_torch/kernels/csrc/lease_probe.cu",
            "src/repro/kernels/lease_probe.py:81"),
           ("miss_round", "src/repro_torch/kernels/csrc/tier_pass.cu",
            "src/repro/kernels/tier_pass.py:204"),
           ("write_grant", "src/repro_torch/kernels/csrc/tier_pass.cu",
            "src/repro/kernels/tier_pass.py:241"))


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
    from torch.autograd import DeviceType
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
                         if f"{name}_kernel" in n) for i in (0, 1)]
              for name, _, _ in KERNELS}
    top_host = sorted(((a.key, a.count, a.self_cpu_time_total)
                       for a in prof.key_averages()
                       if a.self_cpu_time_total > 0),
                      key=lambda r: -r[2])[:15]
    waves = len(res.batch_sizes)
    return {"requests": res.n_requests, "waves": waves, "wall_us": wall_us,
            "device_busy_us": busy_us,
            "device_idle_share": 1.0 - busy_us / wall_us,
            "device_events": len(dev),
            "device_events_per_wave": len(dev) / max(waves, 1),
            "device_by_name": [{"name": n[:120], "count": c, "us": us}
                               for n, (c, us) in top_dev],
            "ported_kernels": {n: {"count": c, "us": us}
                               for n, (c, us) in ported.items()},
            "host_by_op": [{"op": k[:120], "count": c, "self_us": us}
                           for k, c, us in top_host]}


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
    log("phase 2: kernels vs plain versions on the card (exact)")
    kreport = {}
    check_kernels(torch, np, dev, kreport)
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

    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(report, indent=1))

    # ---- 4. summary lines
    line = []
    for name, source, replaces in KERNELS:
        row = max(kreport[name], key=lambda r: r["shape"][0])
        if name == "lease_probe":
            row = next(r for r in kreport[name] if r["shape"] == [64, 8])
        line.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces, "launches": launches[name],
                     "max_abs_err": max(r["max_abs_err"]
                                        for r in kreport[name]),
                     "ms": row["ms"], "plain_ms": row["plain_ms"],
                     "bound_ms": row["bound_ms"],
                     "bound_by": row["bound_by"], "library_ms": None})
    log(json.dumps({"kernels": line}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
