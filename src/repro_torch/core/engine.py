"""Vectorised MGPU memory-hierarchy simulator on torch: the figure engine.

The port of ``repro.core.engine``.  The protocol advances in *rounds* (one
instruction per CU per round); every L1/L2/TSU probe, fill and timestamp
update is a dense tensor operation batched over every CU of every cell.
The hierarchy is held as ``core.state`` tiers, and every L1 and L2 probe
and its install math is the ``lease_probe`` kernel (``state.tier_probe``,
reading the tier tables in place); this file adds the timing (fixed
component latencies plus per-round queueing delays at L2 banks, HBM stacks
and PCIe links) and the per-config routing and gating policy.

Two drivers:

- ``simulate(cfg, ops, addrs)``: one (config, trace) cell, with the
  per-round result log and the final state.
- ``sweep(cfgs, ops, addrs)``: the figure engine.  ``ops``/``addrs`` are a
  padded ``[B, NC, R]`` batch (``traces.pack_batch``); configs are grouped
  by ``sysconfig.static_key`` and each group's C configs x B benchmarks
  run as ``E = C*B`` cells of one loop over rounds.

Where the reference ``lax.scan``s over rounds and ``vmap``s configs and
benchmarks, the port loops over rounds on the host and flattens the cells
into the leading dim of every tensor: lane ``e*NC + cu``, tier row
``e*N + i`` for a tier of N caches a cell, main memory ``e*n_addr + a``.
Every reduction that is global in one cell (queue counts, the fence's
clock maximum, HMG's invalidations, the counter sums, the per-GPU mean)
runs per cell.  The trace goes to the device once, and nothing in the loop
waits for the device.

Where the reference's ``.at[].set`` scatters repeat a target (CUs of one
GPU installing into one L2 set; lanes that install nothing all writing the
trash way), XLA keeps the highest lane's value: the port picks that lane
explicitly (``state.last_lane``) on both devices and writes every field of
an install from it.  ``simulate`` runs the reference's NOP rounds up to a
power of two, because lanes that install nothing still write the trash
ways of the state it returns; ``sweep`` returns no state and runs the real
rounds only (NOP rounds move no time and no counter).

Trace op encoding: 0=nop, 1=read, 2=write, 3=fence (kernel boundary -> cts
jumps to the cell's maximum), 4=compute (addr field = cycles).
"""
from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

from repro_torch.core import state as S
from repro_torch.core.state import INVALID, RES_FIELDS, TierState, TSUState
from repro_torch.core.sysconfig import (DATA_FIELDS, SystemConfig,
                                        stack_configs, static_key)
from repro_torch.obs import trace as obs

NOP, READ, WRITE, FENCE, COMPUTE = 0, 1, 2, 3, 4

COUNTERS = ("l1_to_l2", "l2_to_mm", "l1_hits", "l2_hits", "coh_miss_l1",
            "coh_miss_l2", "wb_evictions", "inval_msgs", "pcie_blocks",
            "reads", "writes",
            # Fig-10 per-link traffic (state.link_bytes): data blocks are
            # BLOCK_BYTES, invalidations CTRL_BYTES; HALCONE's inter-GPU
            # bytes carry no invalidation component by construction.
            "bytes_l1_l2", "bytes_l2_mm", "bytes_inter_gpu")

_i32, _f32 = torch.int32, torch.float32


class SimState(NamedTuple):
    """The hierarchy of E cells, each leaf flattened over cells (E = 1
    gives the reference's shapes); ``ctr`` is a dict of 0-d tensors in a
    returned state and an ``[E, len(COUNTERS)]`` f32 tensor in the loop."""

    l1: TierState          # per CU               [E*NC, S1, W1+1]
    l2: TierState          # per (gpu*banks)      [E*NL2, S2, W2+1]
    l2_dirty: torch.Tensor  # WB policy bit       [E*NL2, S2, W2+1]
    tsu: TSUState          # per HBM stack        [E*NH, ST, TW+1]
    mm_ver: torch.Tensor   # [E*A] authoritative data versions
    dir_sharers: torch.Tensor  # [E*A, G] bool (hmg only; [E, 1] otherwise)
    time: torch.Tensor     # [E*NC] f32
    ctr: object

    # -- flat-field views kept for litmus/demo inspection of results --
    l1_tag = property(lambda s: s.l1.tag)
    l1_rts = property(lambda s: s.l1.rts)
    l1_wts = property(lambda s: s.l1.wts)
    l1_ver = property(lambda s: s.l1.ver)
    l1_lru = property(lambda s: s.l1.lru)
    l1_cts = property(lambda s: s.l1.cts)
    l2_tag = property(lambda s: s.l2.tag)
    l2_rts = property(lambda s: s.l2.rts)
    l2_wts = property(lambda s: s.l2.wts)
    l2_ver = property(lambda s: s.l2.ver)
    l2_lru = property(lambda s: s.l2.lru)
    l2_cts = property(lambda s: s.l2.cts)
    tsu_tag = property(lambda s: s.tsu.tag)
    tsu_memts = property(lambda s: s.tsu.memts)


def _device(device) -> torch.device:
    # imported here: the fabric's stats module imports this one's COUNTERS
    from repro_torch.coherence.fabric.backend import resolve_device
    return resolve_device(device)


def _init(cfg: SystemConfig, E: int, n_addr: int, dev) -> SimState:
    NL2 = cfg.n_gpus * cfg.l2_banks
    hmg = cfg.protocol == "hmg"
    G = cfg.n_gpus if hmg else 1
    A = n_addr if hmg else 1
    return SimState(
        l1=S.init_tier(E * cfg.n_cus, cfg.l1_sets, cfg.l1_ways, dev),
        l2=S.init_tier(E * NL2, cfg.l2_sets, cfg.l2_ways, dev),
        l2_dirty=torch.zeros((E * NL2, cfg.l2_sets, cfg.l2_ways + 1),
                             dtype=torch.bool, device=dev),
        tsu=S.init_tsu(E * cfg.n_hbm, cfg.tsu_sets, cfg.tsu_ways, dev),
        mm_ver=torch.zeros((E * n_addr,), dtype=_i32, device=dev),
        dir_sharers=torch.zeros((E * A, G), dtype=torch.bool, device=dev),
        time=torch.zeros((E * cfg.n_cus,), dtype=_f32, device=dev),
        ctr=torch.zeros((E, len(COUNTERS)), dtype=_f32, device=dev))


def _counter_dict(ctr: torch.Tensor) -> dict:
    return {k: ctr[0, i] for i, k in enumerate(COUNTERS)}


def init_state(cfg: SystemConfig, n_addr: int, device=None) -> SimState:
    """One cell's empty hierarchy on ``device`` (None: the CUDA card)."""
    st = _init(cfg, 1, n_addr, _device(device))
    return st._replace(ctr=_counter_dict(st.ctr))


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p <<= 1
    return p


def _queue_delay(idx, active, n_queues, service):
    """Saturation queueing: a round's n requests to one port drain serially,
    so each waits ~(n-1)*service.  ``idx`` names each lane's queue among
    ``n_queues`` (a cell's queues are its own)."""
    counts = torch.zeros((n_queues,), dtype=_f32, device=idx.device)
    counts.index_add_(0, idx, active.to(_f32))
    return torch.where(active, torch.clamp_min(counts[idx] - 1.0, 0.0)
                       * service, 0.0)


def _to_device(a, dev) -> torch.Tensor:
    from repro_torch.coherence.fabric.backend import to_device
    return to_device(a, dev)


def _run(cfg: SystemConfig, C: int, ops_t, addrs_t, n_addr: int,
         with_log: bool):
    """Run one static group: ``cfg`` stacked over C configs (data fields
    ``[C]`` tensors), ``ops_t``/``addrs_t`` the ``[T, B, NC]`` trace on the
    device; the cells are (config, benchmark) pairs, config-major.
    Returns the final state and, ``with_log``, the ``[T, 7, E*NC]`` result
    log on the device."""
    T, B, NC = ops_t.shape
    dev = ops_t.device
    E = C * B
    d = {f: _to_device(getattr(cfg, f).repeat_interleave(B * NC).numpy(),
                       dev) for f in DATA_FIELDS}
    st = _init(cfg, E, n_addr, dev)
    step = _make_round(cfg, E, n_addr, d, dev, with_log)
    if C > 1:
        ops_t, addrs_t = ops_t.repeat(1, C, 1), addrs_t.repeat(1, C, 1)
    rounds = torch.arange(T, dtype=_i32, device=dev)
    log = torch.empty((T, len(RES_FIELDS), E * NC), dtype=_i32,
                      device=dev) if with_log else None
    for t in range(T):
        res = step(st, ops_t[t].view(-1), addrs_t[t].view(-1), rounds[t])
        if with_log:
            log[t] = res
    return st, log


def _time_summary(cfg: SystemConfig, E: int, time: torch.Tensor):
    """Per cell: (cycles, makespan_max).  CUs within a GPU hide each
    other's latency (warp interleaving) -> per-GPU throughput ~ mean CU
    time; GPUs don't share work -> max."""
    per_gpu = time.view(E, cfg.n_gpus, cfg.cus_per_gpu).mean(-1)
    return per_gpu.amax(-1), time.view(E, -1).amax(-1)


def simulate(cfg: SystemConfig, ops, addrs, device=None):
    """One (config, trace) cell on ``device`` (None: the CUDA card).
    ``ops``/``addrs``: ``[NC, T]``.  Returns the reference's keys: numpy
    ``cycles``, ``makespan_max``, ``per_cu_time`` ``[NC]``, ``counters``
    (a dict of scalars), ``read_log`` ``[NC, T]`` (-1 = no read) and
    ``res_log`` (``{RES_FIELDS: [NC, T]}``), and ``state`` on the
    device."""
    dev = _device(device)
    ops = np.asarray(ops, np.int32)
    addrs = np.asarray(addrs, np.int32)
    n_addr = _next_pow2(int(addrs.max()) + 2)
    T0 = ops.shape[1]
    T = _next_pow2(T0)
    if T != T0:                 # the reference's NOP rounds (trash ways)
        pad = ((0, 0), (0, T - T0))
        ops = np.pad(ops, pad)
        addrs = np.pad(addrs, pad)
    with obs.span("engine.simulate.scan", cat="engine", T=T):
        st, log = _run(stack_configs([cfg]), 1,
                       _to_device(ops.T[:, None, :], dev),
                       _to_device(addrs.T[:, None, :], dev), n_addr, True)
        cycles, makespan = _time_summary(cfg, 1, st.time)
        obs.fence(log, "engine.simulate.device")
    with obs.span("engine.simulate.decode", cat="engine"):
        # the packed per-round result block [T, 7, NC] (core.state.
        # RES_FIELDS) as per-field [NC, T0] views
        res_np = log.cpu().numpy().transpose(1, 2, 0)[:, :, :T0]
        fields = dict(zip(RES_FIELDS, res_np))
        read_log = np.where(ops[:, :T0] == READ, fields["version"], -1)
        ctr = st.ctr[0].cpu().numpy()
    return {
        "cycles": cycles[0].cpu().numpy(),
        "makespan_max": makespan[0].cpu().numpy(),
        "per_cu_time": st.time.cpu().numpy(),
        "counters": dict(zip(COUNTERS, ctr)),
        "read_log": read_log,
        "res_log": fields,
        "state": st._replace(ctr=_counter_dict(st.ctr)),
    }


def sweep(cfgs: Sequence[SystemConfig], ops, addrs, device=None):
    """Batched (config x benchmark) sweep on ``device`` (None: the CUDA
    card) — the figure engine.

    ops/addrs: ``[B, NC, R]`` (``traces.pack_batch``); every config must
    have ``n_cus == NC``.  Configs are grouped by structural signature
    (``sysconfig.static_key``, first-appearance order); each group runs
    as one loop over the R rounds with its configs x benchmarks as cells.
    Returns ``{"cycles": [C, B], "makespan_max": [C, B], "counters": {k:
    [C, B]}}`` as numpy, in the input config order: the math of per-cell
    ``simulate``, without the per-round result log."""
    dev = _device(device)
    cfgs = list(cfgs)
    ops = np.asarray(ops, np.int32)
    addrs = np.asarray(addrs, np.int32)
    if ops.ndim != 3:
        raise ValueError(f"expected [B, NC, R] batch, got {ops.shape}")
    B, NC, R = ops.shape
    for c in cfgs:
        if c.n_cus != NC:
            raise ValueError(f"config {c.name} has n_cus={c.n_cus}, "
                             f"traces have NC={NC}")
    n_addr = _next_pow2(int(addrs.max()) + 2)
    with obs.span("engine.sweep.pack", cat="engine", B=B, NC=NC):
        ops_t = _to_device(ops.transpose(2, 0, 1), dev)      # [R, B, NC]
        addrs_t = _to_device(addrs.transpose(2, 0, 1), dev)
        order: dict = {}
        for i, c in enumerate(cfgs):
            order.setdefault(static_key(c), []).append(i)
        groups = [(stack_configs([cfgs[i] for i in idx]), len(idx))
                  for idx in order.values()]
    with obs.span("engine.sweep.scan", cat="engine", n_groups=len(groups)):
        outs = []
        for g, C in groups:
            st, _ = _run(g, C, ops_t, addrs_t, n_addr, False)
            cycles, makespan = _time_summary(g, C * B, st.time)
            outs.append((cycles.view(C, B), makespan.view(C, B),
                         st.ctr.view(C, B, -1)))
            del st
        obs.fence(outs, "engine.sweep.device")
    with obs.span("engine.sweep.decode", cat="engine"):
        # group rows back to the input config order
        perm = np.argsort([i for idx in order.values() for i in idx])
        cycles, makespan, ctr = (torch.cat(xs).cpu().numpy()[perm]
                                 for xs in zip(*outs))
        return {"cycles": cycles, "makespan_max": makespan,
                "counters": {k: ctr[..., i] for i, k in enumerate(COUNTERS)}}


def _make_round(cfg: SystemConfig, E: int, n_addr: int, d: dict, dev,
                with_log: bool):
    """The round step of one static group of E cells, IN PLACE on the
    state: every old value a transition reads is read before its table is
    written.  ``d``: the data fields as per-lane ``[E*NC]`` tensors."""
    NC = cfg.n_cus
    G, NB, CU = cfg.n_gpus, cfg.l2_banks, cfg.cus_per_gpu
    NL2 = G * NB
    NH = cfg.n_hbm
    W1, W2 = cfg.l1_ways, cfg.l2_ways
    coherent = cfg.protocol == "halcone"
    hmg = cfg.protocol == "hmg"
    rdma = cfg.topology == "rdma"
    wb = cfg.l2_policy == "wb"
    N = E * NC
    lane = torch.arange(N, dtype=_i32, device=dev)   # also the L1 row
    cell = lane // NC
    gpu_of = lane % NC // CU
    l2_row0 = cell * NL2                             # the cell's first rows
    hbm_row0 = cell * NH
    mm0 = cell * n_addr
    no = torch.zeros((N,), dtype=torch.bool, device=dev)
    yes = torch.ones((), dtype=torch.bool, device=dev)
    zero_i = torch.zeros((N,), dtype=_i32, device=dev)
    inf_i = torch.full((N,), 2 ** 30, dtype=_i32, device=dev)
    minus1 = torch.full((N,), -1, dtype=_i32, device=dev)
    three = torch.full((N,), 3, dtype=_i32, device=dev)
    n2 = E * NL2 * cfg.l2_sets * (W2 + 1)
    scratch2 = torch.full((n2,), -1, dtype=_i32, device=dev)
    scratch_t = torch.full((E * NH * cfg.tsu_sets * (cfg.tsu_ways + 1),),
                           -1, dtype=_i32, device=dev) if coherent else None
    if hmg:
        written = torch.zeros((E * n_addr,), dtype=torch.bool, device=dev)
        own_keep = torch.zeros((n2,), dtype=torch.bool, device=dev)
        tag_base = (torch.arange(E * NL2, dtype=_i32, device=dev) // NL2
                    * n_addr).view(-1, 1, 1)
        g_ids = torch.arange(G, dtype=_i32, device=dev)
        dir_trash = mm0 + n_addr - 1
    # the counters as sums of per-cell lane counts: column k of `sums` is
    # COLS[k]; each counter adds two columns with weights (an absent
    # column reads the zero column)
    cols = ["reads", "writes", "l1_hit", "l2_hit", "need_l2", "need_mm"] \
        + ["dirty"] * wb + ["coh1", "coh2"] * coherent + ["pcie"] * rdma \
        + ["inval"] * hmg + ["zero"]
    at = lambda k: cols.index(k) if k in cols else cols.index("zero")
    terms = {"l1_to_l2": ("need_l2", 1, "zero", 0),
             "l2_to_mm": ("need_mm", 1, "dirty", 1),
             "l1_hits": ("l1_hit", 1, "zero", 0),
             "l2_hits": ("l2_hit", 1, "zero", 0),
             "coh_miss_l1": ("coh1", 1, "zero", 0),
             "coh_miss_l2": ("coh2", 1, "zero", 0),
             "wb_evictions": ("dirty", 1, "zero", 0),
             "inval_msgs": ("inval", 1, "zero", 0),
             "pcie_blocks": ("pcie", 1, "zero", 0),
             "reads": ("reads", 1, "zero", 0),
             "writes": ("writes", 1, "zero", 0),
             "bytes_l1_l2": ("need_l2", S.BLOCK_BYTES, "zero", 0),
             "bytes_l2_mm": ("need_mm", S.BLOCK_BYTES, "dirty",
                             S.BLOCK_BYTES),
             "bytes_inter_gpu": ("pcie", S.BLOCK_BYTES, "inval",
                                 S.CTRL_BYTES)}
    rows = [terms[k] for k in COUNTERS]
    ia, ib = (_to_device(np.array([at(r[j]) for r in rows]), dev)
              for j in (0, 2))
    wa, wgt_b = (_to_device(np.array([r[j] for r in rows], np.float32), dev)
                 for j in (1, 3))

    def round_step(st: SimState, op, addr, rnd):
        is_read = op == READ
        is_write = op == WRITE
        is_fence = op == FENCE
        is_comp = op == COMPUTE
        mem = is_read | is_write

        # ---------------- request routing (addr-only, no probes) ----------
        s1 = addr % cfg.l1_sets
        page = addr // cfg.page_blocks
        home = page % G
        remote = (home != gpu_of) if rdma else no
        # L2 instance: SM -> own GPU; RDMA-NC -> home GPU's L2;
        # HMG -> local first, then home.
        bank = addr % NB
        own_l2 = l2_row0 + gpu_of * NB + bank
        home_l2 = l2_row0 + home * NB + bank
        l2c = torch.where(remote, home_l2, own_l2) if rdma and not hmg \
            else own_l2
        s2 = addr // NB % cfg.l2_sets
        hb = hbm_row0 + page % NH

        # ---------------- TSU lease math (values; gating applied later) ---
        if coherent:
            ts_set = addr % cfg.tsu_sets
            hitT, wayT = S.probe(st.tsu.tag, hb, ts_set, addr)
            vT = S.victim(st.tsu.tag, st.tsu.memts, hb, ts_set)
            wayT = torch.where(hitT, wayT, vT)
            memts = torch.where(hitT, st.tsu.memts[hb, ts_set, wayT], 0)
            grant = S.tsu_lease(memts, is_write, d["rd_lease"],
                                d["wr_lease"])
            mwts, mrts = grant.wts, grant.rts
        else:
            # trivial grant [0, inf): the always-valid lease of
            # non-coherent blocks
            mwts, mrts = zero_i, inf_i

        # ---------------- L2 probe + install math (lease_probe) -----------
        # hit2u is UNGATED by need_l2 (not known yet); rows that do not
        # reach L2 discard everything derived from it
        (hit2_tag, hit2u, way2, rts2, l2_bwts, l2_brts, l2_ncts) = \
            S.tier_probe(st.l2, l2c, s2, addr, mwts, mrts)
        wts2 = st.l2.wts[l2c, s2, way2]
        if hmg:
            # second-level probe at the home node for local misses
            hitH_tag, _, wayH, *_ = S.tier_probe(st.l2, home_l2, s2, addr,
                                                 mwts, mrts)
            home_hit_u = hitH_tag & ~hit2u & remote
            below = hit2u | home_hit_u
            wts_from_l2 = torch.where(below, torch.where(
                hit2u, wts2, st.l2.wts[home_l2, s2, wayH]), mwts)
            rts_from_l2 = torch.where(below, torch.where(
                hit2u, rts2, st.l2.rts[home_l2, s2, wayH]), mrts)
        else:
            home_hit_u = no
            wts_from_l2 = torch.where(hit2u, wts2, mwts)
            rts_from_l2 = torch.where(hit2u, rts2, mrts)
        # who reaches MM (ungated): WB read and write misses; WT every
        # write and the read misses
        need_mm_u = ~hit2u & ~home_hit_u
        if not wb:
            need_mm_u = is_write | need_mm_u
        # lease hits keep their timestamps; misses and writes take the
        # fresh install (writes refresh the lease even on a hit)
        keep = hit2u & ~is_write
        l2_new_wts = torch.where(keep, wts2, l2_bwts)
        l2_new_rts = torch.where(keep, rts2, l2_brts)
        fresh = need_mm_u | is_write
        resp_wts = torch.where(fresh, l2_new_wts, wts_from_l2)
        resp_rts = torch.where(fresh, l2_new_rts, rts_from_l2)

        # ---------------- L1 probe + install math (lease_probe) -----------
        (hit1_tag, hit1u, way1, _, l1_new_wts, l1_new_rts, l1_ncts) = \
            S.tier_probe(st.l1, lane, s1, addr, resp_wts, resp_rts)
        l1_hit = hit1u & mem
        coh1 = hit1_tag & mem & ~l1_hit
        need_l2 = (is_read & ~l1_hit) | is_write        # WT L1, writes descend

        # ---------------- gate the L2/MM outcomes -------------------------
        l2_hit = hit2u & need_l2
        coh2 = hit2_tag & need_l2 & ~l2_hit
        home_hit = home_hit_u & need_l2
        need_mm = need_l2 & ~l2_hit & ~home_hit
        if not wb:
            need_mm = is_write | need_mm

        # ---------------- old values, before any table is written ---------
        l1_val = st.l1.ver[lane, s1, way1]
        l2_val = st.l2.ver[l2c, s2, way2]
        l2_install = need_l2 & (~l2_hit | is_write)
        w2i = torch.where(l2_hit, way2, S.victim(st.l2.tag, st.l2.lru, l2c,
                                                 s2))
        dirty_evict = (st.l2_dirty[l2c, s2, w2i]
                       & (st.l2.tag[l2c, s2, w2i] != INVALID) & ~l2_hit
                       & l2_install) if wb else no
        w1i = torch.where(hit1_tag, way1, S.victim(st.l1.tag, st.l1.lru,
                                                   lane, s1))
        if hmg:
            home_val = st.l2.ver[home_l2, s2, wayH]
            shr = st.dir_sharers[mm0 + addr]             # [N, G]

        # ---------------- TSU state updates -------------------------------
        if coherent:
            S.tsu_commit_scatter(st.tsu, hb, ts_set, wayT, addr,
                                 grant.new_memts, need_mm, hitT, scratch_t)

        # MM data versions: writes increment; then everyone who reads MM
        # sees the post-round version (same-tick semantics)
        st.mm_ver.index_add_(0, mm0 + torch.where(is_write, addr,
                                                  n_addr - 1),
                             is_write.to(_i32))
        mm_val = st.mm_ver[mm0 + addr]

        # ---------------- response values ----------------
        if hmg:
            mm_val_or_home = torch.where(home_hit, home_val, mm_val)
        else:
            mm_val_or_home = mm_val
        read_val = torch.where(l1_hit, l1_val,
                               torch.where(l2_hit, l2_val, mm_val_or_home))
        # value that lands in caches on a write: the post-write version
        fill_val = torch.where(is_write, mm_val, read_val)

        # ---------------- install into L2 (highest lane wins a slot) ------
        w2s = torch.where(l2_install, w2i, W2)              # trash slot
        lin2 = S.flat_index(st.l2.tag, l2c, s2, w2s)
        win = S.last_lane(lin2, n2, scratch2)
        S.set_last(st.l2.tag, lin2, torch.where(l2_install, addr, INVALID),
                   win)
        S.set_last(st.l2.ver, lin2, fill_val, win)
        S.set_last(st.l2.rts, lin2, l2_new_rts, win)
        S.set_last(st.l2.wts, lin2, l2_new_wts, win)
        st.l2.lru.index_put_((l2c, s2, torch.where(need_l2, w2i, W2)), rnd)
        if wb:
            S.set_last(st.l2_dirty, lin2, is_write & l2_install, win)
            st.l2_dirty.index_put_(
                (l2c, s2, torch.where(l2_hit & is_write, way2, W2)), yes)
        if coherent:
            # max with 0 is a no-op for non-writers; the kernel's new_cts
            # IS cts_after_write(l2_cts, l2_bwts) for the write's lease
            st.l2.cts.scatter_reduce_(0, l2c.long(),
                                      torch.where(is_write, l2_ncts, 0),
                                      "amax")

        # HMG: writer invalidates every sharer copy (VI), pays PCIe msgs
        if hmg:
            own = shr.gather(1, gpu_of[:, None].long())[:, 0]
            n_shr = (shr.sum(-1, dtype=_i32) - own.to(_i32)) \
                * is_write.to(_i32)
            # membership test instead of an all-pairs compare: mark the
            # cell's written addresses in a dense table, read it at every
            # live tag (the trash address n_addr-1 stays False)
            widx = (mm0 + torch.where(is_write, addr, n_addr - 1)).long()
            written.index_put_((widx,), is_write)
            tag = st.l2.tag
            kill = written[torch.where(tag >= 0, tag, n_addr - 1) + tag_base]
            # keep the writer's own copy
            S.set_last(own_keep, lin2, is_write, win)
            tag.masked_fill_(kill & ~own_keep.view(tag.shape), INVALID)
            own_keep.index_fill_(0, lin2, False)
            written.index_fill_(0, widx, False)
            # directory: a writer keeps only its own GPU's bit (the
            # reference's scatter-min of one-hot rows); the entries left
            # alone are written to the cell's trash row with its own value
            clear = is_write[:, None] & (g_ids != gpu_of[:, None])
            st.dir_sharers.index_put_(
                (torch.where(clear, (mm0 + addr)[:, None],
                             dir_trash[:, None]), g_ids.expand(N, G)),
                ~clear & st.dir_sharers[dir_trash])
            st.dir_sharers.index_put_(
                (torch.where(mem, mm0 + addr, dir_trash), gpu_of), yes)

        # ---------------- install into L1 (one row a lane) ----------------
        l1_install = mem & (~l1_hit | is_write)
        at1 = (lane, s1, torch.where(l1_install, w1i, W1))
        st.l1.tag.index_put_(at1, torch.where(l1_install, addr, INVALID))
        st.l1.ver.index_put_(at1, fill_val)
        st.l1.rts.index_put_(at1, l1_new_rts)
        st.l1.wts.index_put_(at1, l1_new_wts)
        st.l1.lru.index_put_((lane, s1, torch.where(mem, w1i, W1)), rnd)
        if coherent:
            # the kernel's new_cts IS cts_after_write(l1_cts, l1 wts)
            l1_cts = torch.where(is_write, l1_ncts, st.l1.cts).view(E, NC)
            # fences: kernel boundary -> the cell's clocks jump to its max
            l2_cts = st.l2.cts.view(E, NL2)
            gmax = torch.maximum(l1_cts.amax(1), l2_cts.amax(1))[:, None]
            fence = is_fence.view(E, NC)
            st.l1.cts.view(E, NC).copy_(torch.where(fence, gmax, l1_cts))
            l2_cts.copy_(torch.where(fence.any(1, keepdim=True),
                                     torch.maximum(l2_cts, gmax), l2_cts))

        # ---------------- timing ----------------
        q_l2 = _queue_delay(l2c, need_l2, E * NL2, d["l2_service"])
        mm_users = need_mm | dirty_evict if wb else need_mm
        q_mm = _queue_delay(hb, mm_users, E * NH, d["mm_service"])
        mm_t = need_mm * (d["mm_lat"] + q_mm)
        pcie_hop = no
        if rdma:
            pcie_hop = remote & ((need_mm | home_hit) if hmg else need_l2)
            q_pcie = _queue_delay(cell * G + gpu_of, pcie_hop, E * G,
                                  d["pcie_service"])
            pcie_t = pcie_hop * (d["pcie_lat"] + q_pcie)
        # Reads block the issuing warp for the hierarchy round trip; a CU's
        # other wavefronts overlap ~mlp outstanding misses.  (Without RDMA
        # the reference's PCIe term is a + 0.0, dropped here.)
        below_t = need_l2 * (d["l2_lat"] + q_l2) + mm_t
        if rdma:
            below_t = below_t + pcie_t
        read_lat = d["l1_lat"] + below_t / d["mlp"]
        # Writes are POSTED, except WB write-allocate fetches
        write_lat = d["l1_lat"] + q_l2
        if wb:
            write_lat = write_lat + ((mm_t + pcie_t) if rdma else mm_t) \
                / d["mlp"]
        lat = torch.where(is_read, read_lat,
                          torch.where(is_write, write_lat, 0.0))
        if wb:
            lat = lat + dirty_evict * (d["mm_lat"] + q_mm) / d["mlp"]
        lat = lat + is_comp * addr.to(_f32)
        if hmg:
            lat = lat + is_write * (shr.sum(-1) > 1) * d["pcie_lat"]
        st.time.add_(torch.where(mem | is_comp, lat, 0.0))

        # ---------------- counters (per cell) ----------------
        lanes_ = {"reads": is_read, "writes": is_write,
                  "l1_hit": l1_hit & is_read, "l2_hit": l2_hit & need_l2,
                  "need_l2": need_l2, "need_mm": need_mm,
                  "dirty": dirty_evict, "coh1": coh1 & is_read,
                  "coh2": coh2 & is_read, "pcie": pcie_hop}
        flags = torch.stack([lanes_[k] for k in cols if k in lanes_], 1)
        sums = [flags.view(E, NC, -1).sum(1, dtype=_f32)]
        if hmg:
            sums.append(n_shr.view(E, NC).sum(1, dtype=_f32)[:, None])
        sums.append(torch.zeros((E, 1), dtype=_f32, device=dev))
        sums = torch.cat(sums, 1)
        st.ctr.add_(sums[:, ia] * wa + sums[:, ib] * wgt_b)

        if not with_log:
            return None
        # the packed per-op result block (core.state.RES_FIELDS): where a
        # request was served (level), which lease it installed (wts/rts)
        # and whether it reached main memory (mm_used)
        lvl = torch.where(l1_hit, 0, torch.where(
            l2_hit, 1, torch.where(home_hit, 2, three)))
        return torch.stack([
            mem.to(_i32),                                      # found
            torch.where(is_read, read_val,                     # version
                        torch.where(is_write, mm_val, minus1)),
            minus1,                                            # gseq (n/a)
            torch.where(is_read, lvl, minus1),                 # level
            torch.where(mem, l1_new_wts, minus1),              # wts
            torch.where(mem, l1_new_rts, minus1),              # rts
            need_mm.to(_i32),                                  # mm_used
        ])

    return round_step
