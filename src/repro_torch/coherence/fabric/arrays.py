"""Array-native coherence fabric on torch: the whole TSU service as device
tensors.

The single-device counterpart of ``repro.coherence.fabric.arrays``.  All
coherence state lives in ``core.state`` tensors (``_AF``):

  * sharded TSU+MM   — a ``[n_shards, 1, capacity+1]`` table plus version /
    allocation-order / write-sequence side arrays,
  * replica tier     — ``TierState`` ``[n_replicas, sets, ways+1]``,
  * node-shared tier — ``TierState`` ``[n_nodes, sets, ways+1]``,
  * write queue      — a bounded ring per node,

and every transition updates those tensors IN PLACE.  Three engines drive
them, each the counterpart of a reference program:

  * the op scan (``_OpScan``, reference ``_build_run``): ops applied one
    at a time in op order.  The reference's ``lax.scan`` with its
    ``lax.cond`` gates and drain ``while_loop`` becomes a Python loop that
    branches on what the host already knows — each op's kind from the
    encoded batch and every queue's depth and entries from the host queue
    mirror — so no device value is read per op;
  * the fast read (``_fast_read``, reference ``_build_fast_read``): one
    vectorized ``state.tier_probe`` serves every replica-tier lease hit;
  * the batched passes (``pipeline.make_miss_pass`` /
    ``make_write_pass`` / ``make_fence_pass``).

Payloads stay on the host: every MM write is stamped with a globally
unique write sequence number (``gseq``), and the host maps ``gseq ->
value``.  The tensors decide everything (hits, grants, versions,
evictions); the host only moves payloads per the returned plan.
"""
from __future__ import annotations

import collections
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.coherence.fabric import pipeline as P_
from repro_torch.coherence.fabric.backend import (GRANT_LOG_LEN,
                                                  FabricBackend, Op,
                                                  ReadBatchHandle, _bounded,
                                                  resolve_device, to_device)
from repro_torch.coherence.fabric.stats import GI as _GI
from repro_torch.coherence.fabric.stats import G_KEYS as _G_KEYS
from repro_torch.coherence.fabric.stats import RI as _RI
from repro_torch.coherence.fabric.stats import R_KEYS as _R_KEYS
from repro_torch.coherence.fabric.tsu import FabricConfig, stable_hash
from repro_torch.core import protocol
from repro_torch.core import state as S
from repro_torch.core.state import TSUState, TierState, b2i
from repro_torch.kernels import ops as K
from repro_torch.launch.mesh import fabric_ranks, make_fabric_group
from repro_torch.obs import trace as obs

_NOP, _READ, _WRITE, _FENCE, _MM_WRITE, _PUBLISH, _MM_READ = range(7)
_PRUNE_EVERY = 4096          # payload-map GC cadence, in completed writes
_KIND = {"read": _READ, "write": _WRITE, "fence": _FENCE,
         "mm_write": _MM_WRITE, "publish": _PUBLISH, "mm_read": _MM_READ}

# pipelines: "batched" = the vectorized miss and write passes; "scan" =
# every batch through the op scan (the ordering reference)
PIPELINES = ("batched", "scan")
# read_batch falls back to the op scan when the miss subset needs more
# conflict-free rounds than max(_MIN_ROUND_BUDGET, m // 4)
_MIN_ROUND_BUDGET = 6

# the op scan's per-op result record
_REC_FIELDS = ("found", "version", "gseq", "level", "wts", "rts", "mm_used",
               "gmax")
_DLOG_FIELDS = ("dlog_ver", "dlog_wts", "dlog_rts", "dlog_gseq")
_i32 = torch.int32


class _AF(NamedTuple):
    """The device-resident fabric state."""

    rp: TierState            # replica tier [R, S1, W1+1]
    rp_gseq: torch.Tensor    # write-sequence id per line (payload handle)
    rp_tick: torch.Tensor    # [R] LRU tick
    sh: TierState            # shared tier [Nn, S2, W2+1]
    sh_gseq: torch.Tensor
    sh_tick: torch.Tensor    # [Nn]
    tsu: TSUState            # [Ks, 1, cap+1]
    tsu_ver: torch.Tensor    # per-entry version (resets on realloc)
    tsu_gseq: torch.Tensor
    tsu_seq: torch.Tensor    # allocation order (victim tie-break)
    tsu_nseq: torch.Tensor   # [Ks] next allocation seq
    gseq_next: torch.Tensor  # global write-sequence counter (0-d)
    wq: Dict[str, torch.Tensor]   # ring fields [Nn, Q]
    wq_head: torch.Tensor    # [Nn]
    wq_len: torch.Tensor     # [Nn]
    g: torch.Tensor          # global counters [len(G_KEYS)]
    r: torch.Tensor          # per-replica counters [R, len(R_KEYS)]


WQ_FIELDS = ("key", "rep", "wl", "shard", "set1", "set2")


def state_leaves(af, prefix: str = "") -> Dict[str, object]:
    """The leaves of a fabric state keyed by field path (``"rp.tag"``,
    ``"tsu.memts"``, ``"wq.key"``, ...).  Works on the port's ``_AF`` and
    on any NamedTuple/dict tree of arrays with the same layout."""
    out: Dict[str, object] = {}
    items = af.items() if isinstance(af, dict) else zip(af._fields, af)
    for name, v in items:
        path = prefix + name
        if isinstance(v, dict) or hasattr(v, "_fields"):
            out.update(state_leaves(v, path + "."))
        else:
            out[path] = v
    return out


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p <<= 1
    return p


class _Acc:
    """Counter increments of one op-scan run, applied to ``af.g``/``af.r``
    once at its end: host-known constants sum on the host, device values
    are concatenated into one ``index_add_``."""

    def __init__(self, n_replicas: int):
        self._host = {"g": np.zeros(len(_G_KEYS), np.int64),
                      "r": np.zeros(n_replicas * len(_R_KEYS), np.int64)}
        self._dev: Dict[str, list] = {"g": [], "r": []}

    def g(self, **kw) -> None:
        self._add("g", 0, _GI, kw)

    def r(self, rep: int, **kw) -> None:
        self._add("r", rep * len(_R_KEYS), _RI, kw)

    def _add(self, which, base, table, kw) -> None:
        """Each value: an int, a [1] device tensor, a (value, weight)
        pair, or a list of those."""
        for k, vals in kw.items():
            for v in (vals if isinstance(vals, list) else [vals]):
                v, w = v if isinstance(v, tuple) else (v, 1)
                if isinstance(v, torch.Tensor):
                    self._dev[which].append((base + table[k], v, w))
                elif v:
                    self._host[which][base + table[k]] += int(v) * w

    def flush(self, af: _AF) -> None:
        for which, vec in (("g", af.g), ("r", af.r.view(-1))):
            dev = self._dev[which]
            if dev:
                idx = to_device(np.asarray([i for i, _, _ in dev], np.int64),
                                vec.device)
                vals = torch.cat([v.reshape(-1) for _, v, _ in dev]).to(_i32)
                w = np.asarray([w for _, _, w in dev], np.int32)
                if (w != 1).any():
                    vals = vals * to_device(w, vec.device)
                vec.index_add_(0, idx, vals)
            h = self._host[which]
            if h.any():
                vec += to_device(h.astype(np.int32), vec.device)


class _OpScan:
    """The op scan for one geometry: ops applied one at a time, every
    lease decision served by ``core.state`` and the lease-probe kernel
    (one lane per probe).  ``run`` returns the per-op result arrays."""

    def __init__(self, W1, W2, KS, CAP, NN, NR, Q, MAXIF, device):
        self.W1, self.W2, self.KS, self.CAP = W1, W2, KS, CAP
        self.NN, self.NR, self.Q, self.MAXIF = NN, NR, Q, MAXIF
        self.dev = device
        self.ids = torch.arange(64, dtype=_i32, device=device)

    # ------------------------------------------------------- lane helpers
    def key1(self, kid: int) -> torch.Tensor:
        """Key id ``kid`` as a [1] device tensor: a view of ``ids``, the
        ids counted up once (no allocation and no fill per op), grown by
        doubling past the largest id asked for."""
        if kid >= self.ids.shape[0]:
            self.ids = torch.arange(max(kid + 1, 2 * self.ids.shape[0]),
                                    dtype=_i32, device=self.dev)
        return self.ids[kid:kid + 1]

    def probe1(self, tier, idx, st, key, mwts=None, mrts=None):
        """One-lane ``state.tier_probe``: the set row is a [1, W] view;
        ``mwts``/``mrts`` None read as 0."""
        return K.lease_probe(tier.tag[idx, st, :-1][None],
                             tier.rts[idx, st, :-1][None],
                             tier.cts[idx:idx + 1], key, mwts, mrts)

    def touch(self, tier, tick, idx, st, key, active):
        """Host probe semantics: on a tag match, bump the store tick and
        refresh the line's LRU (even if the lease is dead).  ``active`` is
        True or a [1] device mask."""
        th, hit, way, _, _, _, _ = self.probe1(tier, idx, st, key)
        if active is not True:
            th, hit = th & active, hit & active
        tick[idx:idx + 1] += b2i(th)
        w = torch.where(th, way, tier.n_ways)
        old = tier.lru[idx, st, w]
        tier.lru[idx, st, w] = torch.where(th, tick[idx:idx + 1], old)
        return th, hit, way

    @staticmethod
    def drop(tier, idx, st, way, cond):
        w = torch.where(cond, way, tier.n_ways)
        old = tier.tag[idx, st, w]
        tier.tag[idx, st, w] = torch.where(cond, S.INVALID, old)

    @staticmethod
    def install_at(tier, gseq_a, tick, idx, st, key, wts, rts, ver, gs,
                   th, way, active):
        """Host install semantics, IN PLACE: tick++, in place on
        ``(th, way)``, else the victim way (invalid first, then LRU);
        returns the displacement of a live different-key line.  ``th`` is
        False (a fill) or a [1] mask; ``active`` True or a [1] mask."""
        vic = S.victim(tier.tag, tier.lru, idx, st)
        w0 = vic.reshape(1) if th is False else torch.where(th, way, vic)
        evicted = tier.tag[idx, st, w0] != S.INVALID
        if th is not False:
            evicted = evicted & ~th
        if active is True:
            tick[idx:idx + 1] += 1
            w = w0
        else:
            evicted = evicted & active
            tick[idx:idx + 1] += b2i(active)
            w = torch.where(active, w0, tier.n_ways)
        for a, v in ((tier.tag, key), (tier.wts, wts), (tier.rts, rts),
                     (tier.ver, ver), (tier.lru, tick[idx:idx + 1]),
                     (gseq_a, gs)):
            if active is True:
                a[idx, st, w] = v
            else:
                old = a[idx, st, w]
                a[idx, st, w] = torch.where(active, v, old)
        return evicted

    # ---------------------------------------------------------- TSU side
    def mm_write1(self, af, acc, key, shard, wl, rd, wr):
        """TSUShard.mm_write: allocate (evicting the min-(memts,
        alloc-seq) entry when the shard is full), grant via Algorithm 3 +
        overflow reinit, bump the version."""
        gs = af.gseq_next.reshape(1).clone()
        wts, rts, ver, evict, ovf = self.tsu_write(af, key, shard, gs, wl,
                                                   rd, wr)
        af.gseq_next.add_(1)
        acc.g(tsu_evictions=evict, overflow_reinits=ovf)
        return wts, rts, ver, gs

    def tsu_write(self, af, key, shard: int, gs, wl, rd, wr):
        """The TSU row's half of ``mm_write1``, IN PLACE on ``af``'s TSU
        leaves at row ``shard``: stamps write sequence ``gs`` and returns
        ``(wts, rts, ver, evict, overflow)`` as [1] tensors."""
        th, way = S.probe(af.tsu.tag, shard, 0, key)
        vic = S.victim_lex(af.tsu.tag, af.tsu.memts, af.tsu_seq, shard, 0)
        full = (af.tsu.tag[shard, 0, :self.CAP] != S.INVALID).all()
        evict = ~th & full
        w0 = torch.where(th, way, vic)
        memts = torch.where(th, af.tsu.memts[shard, 0, w0], 0)
        gr = S.tsu_lease(memts, torch.ones((1,), dtype=torch.bool,
                                           device=self.dev),
                         rd, wl if wl >= 0 else wr)
        ver = torch.where(th, af.tsu_ver[shard, 0, w0] + 1, 1)
        seqv = torch.where(th, af.tsu_seq[shard, 0, w0],
                           af.tsu_nseq[shard:shard + 1])
        af.tsu.tag[shard, 0, w0] = key                # exact commit
        af.tsu.memts[shard, 0, w0] = gr.new_memts
        af.tsu_ver[shard, 0, w0] = ver
        af.tsu_gseq[shard, 0, w0] = gs
        af.tsu_seq[shard, 0, w0] = seqv
        af.tsu_nseq[shard:shard + 1] += b2i(~th)
        return gr.wts, gr.rts, ver, evict, gr.overflow

    def mm_read1(self, af, acc, key, shard, rd, wr, active):
        """TSUShard.mm_read: grant only if the entry exists (``active``:
        True or a [1] mask)."""
        found, wts, rts, ver, gs, ovf = self.tsu_read(af, key, shard, rd, wr,
                                                      active)
        acc.g(overflow_reinits=ovf)
        return found, wts, rts, ver, gs

    def tsu_read(self, af, key, shard: int, rd, wr, active):
        """The TSU row's half of ``mm_read1``, IN PLACE at row ``shard``:
        returns ``(found, wts, rts, ver, gs, overflow)`` as [1] tensors."""
        th, way = S.probe(af.tsu.tag, shard, 0, key)
        found = th if active is True else active & th
        memts = torch.where(th, af.tsu.memts[shard, 0, way], 0)
        gr = S.tsu_lease(memts, torch.zeros((1,), dtype=torch.bool,
                                            device=self.dev), rd, wr)
        tw = torch.where(found, way, self.CAP)
        old_tag = af.tsu.tag[shard, 0, tw]
        old_mem = af.tsu.memts[shard, 0, tw]
        af.tsu.tag[shard, 0, tw] = torch.where(found, key, old_tag)
        af.tsu.memts[shard, 0, tw] = torch.where(found, gr.new_memts, old_mem)
        ver = torch.where(found, af.tsu_ver[shard, 0, way], -1)
        gs = torch.where(found, af.tsu_gseq[shard, 0, way], -1)
        return found, gr.wts, gr.rts, ver, gs, found & gr.overflow

    def drain1(self, af, acc, node, rd, wr, queues):
        """WriteQueue._drain_one: pop the oldest posted write, write
        through to the TSU, adopt the grant into the node tier, then
        install the adopted lease into the submitting replica."""
        kid, s1, s2, shard, rep, wl = queues[node].popleft()
        key = self.key1(kid)
        cross = int(shard != node % self.KS)
        af.wq_head[node] = (af.wq_head[node] + 1) % self.Q
        af.wq_len[node] -= 1
        acc.g(l2_to_mm=1, write_throughs=1, pcie_blocks=cross,
              bytes_l2_mm=S.BLOCK_BYTES, bytes_inter_gpu=cross * S.BLOCK_BYTES)
        mwts, mrts, ver, gs = self.mm_write1(af, acc, key, shard, wl, rd, wr)
        # adopt into the node-shared tier (grant lease, node clock advance)
        thA, _, wayA, _, nwA, nrA, ncA = self.probe1(af.sh, node, s2, key,
                                                     mwts, mrts)
        af.sh.cts[node:node + 1] = ncA
        ev1 = self.install_at(af.sh, af.sh_gseq, af.sh_tick, node, s2, key,
                              nwA, nrA, ver, gs, thA, wayA, True)
        # install the adopted lease into the submitting replica
        thB, _, wayB, _, nwB, nrB, ncB = self.probe1(af.rp, rep, s1, key,
                                                     nwA, nrA)
        af.rp.cts[rep:rep + 1] = ncB
        ev2 = self.install_at(af.rp, af.rp_gseq, af.rp_tick, rep, s1, key,
                              nwB, nrB, ver, gs, thB, wayB, True)
        acc.g(capacity_evictions=[ev1, ev2])
        acc.r(rep, write_throughs=1, capacity_evictions=ev2)
        return kid, ver, mwts, mrts, gs

    # ---------------------------------------------------------- op kinds
    def read(self, af, acc, rep, node, kid, s1, s2, shard, rd, wr):
        key = self.key1(kid)
        # replica probe (ReplicaCache.get)
        th1, h1, way1 = self.touch(af.rp, af.rp_tick, rep, s1, key, True)
        hit_ver = af.rp.ver[rep, s1, way1]
        hit_gs = af.rp_gseq[rep, s1, way1]
        miss = ~h1
        coh = miss & th1
        comp = miss & ~th1
        self.drop(af.rp, rep, s1, way1, coh)
        # shared probe (SharedCache.get, only on a replica miss)
        th2, h2, way2 = self.touch(af.sh, af.sh_tick, node, s2, key, miss)
        sh_ver = af.sh.ver[node, s2, way2]
        sh_gs = af.sh_gseq[node, s2, way2]
        sh_wts = af.sh.wts[node, s2, way2]
        sh_rts = af.sh.rts[node, s2, way2]
        coh2 = miss & th2 & ~h2
        self.drop(af.sh, node, s2, way2, coh2)
        # MM/TSU access (fabric.read)
        need_mm = miss & ~h2
        fndR, mwts, mrts, mver, mgs = self.mm_read1(af, acc, key, shard, rd,
                                                    wr, need_mm)
        fndF = need_mm & fndR
        # shared-tier fill (always a victim way: an expired line was
        # dropped)
        thA, _, wayA, _, nwA, nrA, _ = self.probe1(af.sh, node, s2, key,
                                                   mwts, mrts)
        evF = self.install_at(af.sh, af.sh_gseq, af.sh_tick, node, s2, key,
                              nwA, nrA, mver, mgs, thA, wayA, fndF)
        # response travelling up to the replica
        resp_found = h2 | fndF
        resp_ver = torch.where(h2, sh_ver, mver)
        resp_gs = torch.where(h2, sh_gs, mgs)
        nw1, nr1, _ = S.install_lease(af.rp.cts[rep:rep + 1],
                                      torch.where(h2, sh_wts, nwA),
                                      torch.where(h2, sh_rts, nrA))
        ev1 = self.install_at(af.rp, af.rp_gseq, af.rp_tick, rep, s1, key,
                              nw1, nr1, resp_ver, resp_gs, False, None,
                              resp_found)
        home_miss = shard != node % self.KS
        B = S.BLOCK_BYTES
        common = dict(reads=1, l1_hits=h1, l2_hits=h2, l1_to_l2=miss,
                      coh_miss_l1=coh, coh_miss_l2=coh2,
                      self_invalidations=[coh, coh2], compulsory=comp,
                      refetches=resp_found, capacity_evictions=[evF, ev1])
        acc.g(l2_to_mm=need_mm, pcie_blocks=need_mm if home_miss else 0,
              bytes_l1_l2=(miss, B), bytes_l2_mm=(need_mm, B),
              bytes_inter_gpu=(need_mm, B) if home_miss else 0, **common)
        acc.r(rep, **common)
        return [h1 | resp_found,
                torch.where(h1, hit_ver, torch.where(resp_found, resp_ver,
                                                     -1)),
                torch.where(h1, hit_gs, torch.where(resp_found, resp_gs, -1)),
                torch.where(h1, 0, torch.where(h2, 1, torch.where(fndF, 2,
                                                                  3))),
                torch.where(fndF, mwts, 0), torch.where(fndF, mrts, 0),
                fndF, 0], []

    def write(self, af, acc, rep, node, kid, s1, s2, shard, wl, rd, wr,
              queues):
        key = self.key1(kid)
        # pending line (store-buffer forwarding): wts=rts=cts, ver=-1
        thP, _, wayP, _, _, _, _ = self.probe1(af.rp, rep, s1, key)
        cts = af.rp.cts[rep:rep + 1]
        evP = self.install_at(af.rp, af.rp_gseq, af.rp_tick, rep, s1, key,
                              cts, cts, -1, -1, thP, wayP, True)
        # posted write-through: ring push + bounded drain
        t = (af.wq_head[node] + af.wq_len[node]) % self.Q
        for f, v in zip(WQ_FIELDS, (kid, rep, wl, shard, s1, s2)):
            af.wq[f][node, t] = v
        af.wq_len[node] += 1
        queues[node].append((kid, s1, s2, shard, rep, wl))
        acc.g(writes=1, l1_to_l2=1, capacity_evictions=evP,
              bytes_l1_l2=S.BLOCK_BYTES)
        acc.r(rep, writes=1, l1_to_l2=1, capacity_evictions=evP)
        drains = []
        if len(queues[node]) > self.MAXIF:
            drains.append(self.drain1(af, acc, node, rd, wr, queues))
        return [0, -1, -1, -1, 0, 0, 0, 0], drains

    def fence(self, af, acc, rd, wr, queues):
        drains = []
        for nd in range(self.NN):
            while queues[nd]:
                drains.append(self.drain1(af, acc, nd, rd, wr, queues))
        gmax = torch.maximum(af.rp.cts.max(), af.sh.cts.max())
        af.rp.cts.copy_(gmax.expand_as(af.rp.cts))
        af.sh.cts.copy_(gmax.expand_as(af.sh.cts))
        acc.g(fences=1)
        return [0, -1, -1, -1, 0, 0, 0, gmax.reshape(1)], drains

    def mm_write(self, af, acc, node, kid, s2, shard, wl, publish, rd, wr):
        key = self.key1(kid)
        mwts, mrts, mver, mgs = self.mm_write1(af, acc, key, shard, wl, rd,
                                               wr)
        if publish:          # adopt into the node tier, node clock advance
            thA, _, wayA, _, nwA, nrA, ncA = self.probe1(af.sh, node, s2,
                                                         key, mwts, mrts)
            af.sh.cts[node:node + 1] = ncA
            evF = self.install_at(af.sh, af.sh_gseq, af.sh_tick, node, s2,
                                  key, nwA, nrA, mver, mgs, thA, wayA, True)
            acc.g(capacity_evictions=evF)
        acc.g(l2_to_mm=1, write_throughs=1, bytes_l2_mm=S.BLOCK_BYTES)
        return [1, mver, mgs, -1, mwts, mrts, 1, 0], []

    def mm_read(self, af, acc, kid, shard, rd, wr):
        key = self.key1(kid)
        fnd, mwts, mrts, mver, mgs = self.mm_read1(af, acc, key, shard, rd,
                                                   wr, True)
        acc.g(l2_to_mm=1, bytes_l2_mm=S.BLOCK_BYTES)
        return [fnd, mver, mgs, -1, torch.where(fnd, mwts, 0),
                torch.where(fnd, mrts, 0), fnd, 0], []

    # -------------------------------------------------------------- run
    def run(self, af: _AF, enc, rd: int, wr: int, queues) -> Dict:
        """Apply the encoded ops ``(kind, rep, node, kid, s1, s2, shard,
        wl)`` in order.  ``queues`` holds every node's pending posted
        writes ``(kid, s1, s2, shard, rep, wl)``, oldest first; pushes and
        drains update it as they update the device ring.  Returns the
        per-op result arrays (one device-to-host copy)."""
        acc = _Acc(self.NR)
        recs, dlogs = [], []
        for kind, rep, node, kid, s1, s2, shard, wl in enc:
            if kind == _READ:
                rec, dl = self.read(af, acc, rep, node, kid, s1, s2, shard,
                                    rd, wr)
            elif kind == _WRITE:
                rec, dl = self.write(af, acc, rep, node, kid, s1, s2, shard,
                                     wl, rd, wr, queues)
            elif kind == _FENCE:
                rec, dl = self.fence(af, acc, rd, wr, queues)
            elif kind in (_MM_WRITE, _PUBLISH):
                rec, dl = self.mm_write(af, acc, node, kid, s2, shard, wl,
                                        kind == _PUBLISH, rd, wr)
            elif kind == _MM_READ:
                rec, dl = self.mm_read(af, acc, kid, shard, rd, wr)
            else:
                raise ValueError(f"unknown op kind {kind}")
            recs.append(rec)
            dlogs.append(dl)
        acc.flush(af)
        return self._collect(recs, dlogs)

    @staticmethod
    def _collect(recs, dlogs) -> Dict:
        """Per-op records (ints or [1] device tensors) -> numpy arrays,
        with every device value fetched in ONE copy."""
        B = len(recs)
        LD = max([1] + [len(d) for d in dlogs])
        res = {f: np.zeros((B,), np.int64) for f in _REC_FIELDS}
        res["dcount"] = np.asarray([len(d) for d in dlogs], np.int64)
        res.update({f: np.full((B, LD), -1, np.int64)
                    for f in ("dlog_key",) + _DLOG_FIELDS})
        tens, where = [], []
        for i, (rec, dl) in enumerate(zip(recs, dlogs)):
            for f, v in zip(_REC_FIELDS, rec):
                if isinstance(v, torch.Tensor):
                    tens.append(v.reshape(-1))
                    where.append((res[f], (i,)))
                else:
                    res[f][i] = v
            for j, (kid, *vals) in enumerate(dl):
                res["dlog_key"][i, j] = kid
                for f, v in zip(_DLOG_FIELDS, vals):
                    tens.append(v.reshape(-1))
                    where.append((res[f], (i, j)))
        if tens:
            flat = torch.cat(tens).to(torch.int64).cpu().numpy()
            for (arr, ix), v in zip(where, flat):
                arr[ix] = v
        return res


def _fast_read(af: _AF, meta_s1, kids, rep: int):
    """Phase 1 of the two-phase batched read: ONE vectorized
    ``state.tier_probe`` over the batch serves every replica-tier lease
    hit, with sequential touch semantics (op i's LRU = tick + its rank
    among the batch's hits), IN PLACE.  Returns the packed [3, B]
    (hit, version, gseq) block."""
    s1s = meta_s1[kids]
    _, hit, way, _, _, _, _ = S.tier_probe(af.rp, rep, s1s, kids)
    hi = b2i(hit)
    rank = torch.cumsum(hi, 0).to(_i32)   # hit rank (one replica per call)
    w = torch.where(hit, way, af.rp.n_ways)
    # scatter-max == sequential set here: lru values are past ticks, and a
    # duplicate key's later touch carries the larger rank; misses land on
    # the trash way
    lru = af.rp.lru[rep]
    lru.view(-1).scatter_reduce_(0, s1s.long() * lru.shape[1] + w.long(),
                                 af.rp_tick[rep] + rank, "amax")
    ver = af.rp.ver[rep][s1s, way]
    gseq = af.rp_gseq[rep][s1s, way]
    nh = hi.sum(dtype=_i32)
    af.rp_tick[rep] += nh
    P_.counter_add(af.g, reads=nh, l1_hits=nh)
    P_.counter_add(af.r[rep], per_replica=True, reads=nh, l1_hits=nh)
    return torch.stack([hi, ver, gseq])


class ArrayFabric(FabricBackend):
    """The array-native fabric: ``FabricBackend`` over device tensors.

    ``apply(ops)`` encodes the batch (keys interned to dense ids; set
    indexes and shard routes precomputed with the same ``stable_hash``
    the host stores use), runs the op scan, then replays the returned
    plan on the host-side payload map.  ``device=None`` runs on the CUDA
    card (and raises without one); tests pass ``device="cpu"``.
    """

    def __init__(self, cfg: FabricConfig = FabricConfig(),
                 n_nodes: int = 1, replicas_per_node: int = 1,
                 pipeline: str = "batched", device=None):
        self.cfg = cfg = _bounded(cfg)
        if pipeline not in PIPELINES:
            raise ValueError(f"pipeline must be one of {PIPELINES}, "
                             f"got {pipeline!r}")
        self.device = resolve_device(device)
        self.pipeline = pipeline
        self.n_nodes = n_nodes
        self.n_replicas = n_nodes * replicas_per_node
        self._rpn = replicas_per_node
        self._S1 = max(1, cfg.replica_sets)
        self._W1 = max(1, cfg.replica_ways)
        self._S2 = max(1, cfg.shared_sets)
        self._W2 = max(1, cfg.shared_ways)
        self._KS = cfg.n_shards
        self._CAP = cfg.tsu_capacity
        self._Q = cfg.max_in_flight + 2
        self._scan = self._make_scan()
        self._miss_run = P_.make_miss_pass(self._W1, self._W2, self._KS)
        self._write_run = P_.make_write_pass(
            self._W1, self._W2, self._KS, n_nodes, self.n_replicas, self._Q,
            cfg.max_in_flight)
        self._fence_run = P_.make_fence_pass(
            self._W1, self._W2, self._KS, n_nodes, self.n_replicas, self._Q)
        self._af = self._init_af()
        # host-side payload plumbing (the tensors decide; this only ships)
        self._keys: Dict = {}
        self._key_list: List = []
        self._meta = np.zeros((64, 3), np.int32)    # kid -> set1, set2, shard
        self._vals: Dict[int, object] = {}          # gseq -> value
        self._pending: Dict[Tuple[int, int], object] = {}
        self._pending_n: Dict[Tuple[int, int], int] = {}   # in-flight count
        self._qmirror = [collections.deque() for _ in range(n_nodes)]
        self.grant_log = collections.deque(maxlen=GRANT_LOG_LEN)
        self._meta_dev = None           # device-side kid -> set1 table
        self._fast_read_batches = 0     # all-hit batches (FabricStats field)
        self._write_batches = 0         # non-empty write_batch calls
        self._writes_since_prune = 0

    def _make_scan(self) -> "_OpScan":
        return _OpScan(self._W1, self._W2, self._KS, self._CAP, self.n_nodes,
                       self.n_replicas, self._Q, self.cfg.max_in_flight,
                       self.device)

    # --------------------------------------------------- grant exchange
    def _xin(self) -> _AF:
        """Enter a device pass that touches the TSU: the state it runs on,
        the whole TSU table included.  Identity here; the sharded fabric
        assembles the table from every rank's rows."""
        return self._af

    def _xout(self) -> None:
        """Leave a device pass (after ``_xin``).  No-op here."""

    def _full_state(self) -> _AF:
        """The state with the whole TSU table, for views outside a pass
        (``memts``, ``prune_payloads``, ``export_state``)."""
        return self._af

    def _init_af(self) -> _AF:
        dev = self.device
        z = lambda *s: torch.zeros(s, dtype=_i32, device=dev)
        neg = lambda *s: torch.full(s, -1, dtype=_i32, device=dev)
        Nn, R, KS, CAP = self.n_nodes, self.n_replicas, self._KS, self._CAP
        return _AF(
            rp=S.init_tier(R, self._S1, self._W1, dev),
            rp_gseq=neg(R, self._S1, self._W1 + 1), rp_tick=z(R),
            sh=S.init_tier(Nn, self._S2, self._W2, dev),
            sh_gseq=neg(Nn, self._S2, self._W2 + 1), sh_tick=z(Nn),
            tsu=S.init_tsu(KS, 1, CAP, dev),
            tsu_ver=z(KS, 1, CAP + 1), tsu_gseq=neg(KS, 1, CAP + 1),
            tsu_seq=z(KS, 1, CAP + 1), tsu_nseq=z(KS),
            gseq_next=torch.zeros((), dtype=_i32, device=dev),
            wq={k: z(Nn, self._Q) for k in WQ_FIELDS},
            wq_head=z(Nn), wq_len=z(Nn),
            g=z(len(_G_KEYS)), r=z(R, len(_R_KEYS)))

    # ------------------------------------------------------ state transfer
    def export_state(self) -> Tuple[Dict[str, np.ndarray], Dict]:
        """The whole fabric as ``(arrays, host)``: ``arrays`` maps every
        state leaf's field path to an int32 numpy array; ``host`` holds
        the plain-Python tables.  ``load_state`` is the inverse."""
        arrays = {k: v.cpu().numpy().copy()   # never a view of live state
                  for k, v in state_leaves(self._full_state()).items()}
        host = {"key_list": list(self._key_list),
                "meta": self._meta.copy(),
                "vals": dict(self._vals),
                "pending": dict(self._pending),
                "pending_n": dict(self._pending_n),
                "qmirror": [list(q) for q in self._qmirror],
                "grant_log": list(self.grant_log),
                "fast_read_batches": self._fast_read_batches,
                "write_batches": self._write_batches,
                "writes_since_prune": self._writes_since_prune}
        return arrays, host

    def load_state(self, arrays: Dict[str, np.ndarray], host: Dict) -> None:
        """Adopt a state exported by ``export_state`` (or assembled from
        the reference fabric's leaves and host tables)."""
        leaves = state_leaves(self._af)
        if set(leaves) != set(arrays):
            raise ValueError("state layout mismatch: "
                             f"{sorted(set(leaves) ^ set(arrays))}")
        for k, t in leaves.items():
            a = np.array(arrays[k], np.int32)
            if a.shape != tuple(t.shape):
                raise ValueError(f"{k}: shape {a.shape}, fabric has "
                                 f"{tuple(t.shape)}")
            t.copy_(torch.from_numpy(a))
        self._key_list = list(host["key_list"])
        self._keys = {k: i for i, k in enumerate(self._key_list)}
        self._meta = np.array(host["meta"], np.int32)
        self._vals = dict(host["vals"])
        self._pending = dict(host["pending"])
        self._pending_n = dict(host["pending_n"])
        self._qmirror = [collections.deque(q) for q in host["qmirror"]]
        self.grant_log = collections.deque(host["grant_log"],
                                           maxlen=GRANT_LOG_LEN)
        self._fast_read_batches = int(host["fast_read_batches"])
        self._write_batches = int(host["write_batches"])
        self._writes_since_prune = int(host.get("writes_since_prune", 0))
        self._meta_dev = None

    # ------------------------------------------------------------- keys
    def _kid(self, key) -> int:
        kid = self._keys.get(key)
        if kid is None:
            kid = len(self._key_list)
            self._keys[key] = kid
            self._key_list.append(key)
            if kid >= self._meta.shape[0]:
                self._meta = np.concatenate(
                    [self._meta, np.zeros_like(self._meta)], axis=0)
            h = stable_hash(key)
            self._meta[kid] = (h % self._S1, h % self._S2, h % self._KS)
            self._meta_dev = None        # device copy is stale
        return kid

    def _queues(self):
        """Every node's pending posted writes as the op scan consumes
        them: ``(kid, s1, s2, shard, rep, wl)``, oldest first."""
        return [collections.deque((kid, *self._meta[kid].tolist(), rep, wl)
                                  for kid, _v, rep, wl in q)
                for q in self._qmirror]

    # ------------------------------------------------------------ apply
    def apply(self, ops: Sequence[Op]):
        if not ops:
            return []
        with obs.span("fabric.pack", n_ops=len(ops)):
            enc = []
            for op in ops:
                kind = _KIND.get(op.kind)
                if kind is None:
                    raise ValueError(f"unknown op kind {op.kind!r}")
                if kind == _FENCE:
                    enc.append((kind, 0, 0, 0, 0, 0, 0, -1))
                    continue
                kid = self._kid(op.key)
                s1, s2, shard = self._meta[kid].tolist()
                node = (op.node if op.kind == "publish"
                        else op.replica // self._rpn)
                enc.append((kind, op.replica, node, kid, s1, s2, shard,
                            -1 if op.wr_lease is None else op.wr_lease))
        with obs.span("fabric.exchange"):
            af = self._xin()
        with obs.span("fabric.scan", n_ops=len(ops)):
            res = self._scan.run(af, enc, self.cfg.rd_lease,
                                 self.cfg.wr_lease, self._queues())
            self._xout()
        with obs.span("fabric.decode", n_ops=len(ops)):
            out = [(op, self._decode(op, res, i))
                   for i, op in enumerate(ops)]
        if self._writes_since_prune >= _PRUNE_EVERY:
            self.prune_payloads()
        return out

    def prune_payloads(self) -> None:
        """Drop payload versions no longer referenced by any device-side
        line or TSU entry (payloads are named by gseq handles)."""
        af = self._full_state()
        live = set()
        for a in (af.rp_gseq, af.sh_gseq, af.tsu_gseq):
            live.update(torch.unique(a).cpu().tolist())
        self._vals = {g: v for g, v in self._vals.items() if g in live}
        self._writes_since_prune = 0

    def _drains(self, res, i, node: Optional[int] = None) -> None:
        """Replay the op's drain log on the payload map + grant log.  A
        write op drains its own node's queue; a fence drains every queue in
        node order (node=None -> pop the first non-empty mirror)."""
        for j in range(int(res["dcount"][i])):
            dk = int(res["dlog_key"][i][j])
            nd = (node if node is not None else
                  next(n for n in range(self.n_nodes) if self._qmirror[n]))
            mk, mval, mrep, _mwl = self._qmirror[nd].popleft()
            if mk != dk:
                raise RuntimeError("queue mirror diverged from the ring")
            self._vals[int(res["dlog_gseq"][i][j])] = mval
            self._writes_since_prune += 1
            # last in-flight write for (rep, key) drained: the replica line
            # now carries a real gseq, so the store-buffer copy can go
            n = self._pending_n.get((mrep, mk), 0) - 1
            if n <= 0:
                self._pending_n.pop((mrep, mk), None)
                self._pending.pop((mrep, mk), None)
            else:
                self._pending_n[(mrep, mk)] = n
            self.grant_log.append((self._key_list[dk],
                                   int(res["dlog_wts"][i][j]),
                                   int(res["dlog_rts"][i][j]),
                                   int(res["dlog_ver"][i][j])))

    def _read_result(self, kid: int, replica: int, found, version, gseq):
        """Decode one read op's outputs into the API result: None on a
        miss, store-buffer forwarding (version < 0) of a posted write,
        else payload + version."""
        if not found:
            return None
        ver = int(version)
        if ver < 0:
            return self._pending[(replica, kid)], None
        return self._vals[int(gseq)], ver

    def _decode(self, op: Op, res, i):
        kind = op.kind
        if kind == "read":
            if res["mm_used"][i]:
                self.grant_log.append((op.key, int(res["wts"][i]),
                                       int(res["rts"][i]),
                                       int(res["version"][i])))
            return self._read_result(self._keys[op.key], op.replica,
                                     res["found"][i], res["version"][i],
                                     res["gseq"][i])
        if kind == "write":
            kid = self._keys[op.key]
            self._pending[(op.replica, kid)] = op.value
            self._pending_n[(op.replica, kid)] = self._pending_n.get(
                (op.replica, kid), 0) + 1
            node = op.replica // self._rpn
            self._qmirror[node].append(
                (kid, op.value, op.replica,
                 -1 if op.wr_lease is None else op.wr_lease))
            self._drains(res, i, node=node)
            return None
        if kind == "fence":
            self._drains(res, i)
            return int(res["gmax"][i])
        if kind in ("mm_write", "publish"):
            gs = int(res["gseq"][i])
            self._vals[gs] = op.value
            self._writes_since_prune += 1
            g = (op.key, int(res["wts"][i]), int(res["rts"][i]),
                 int(res["version"][i]))
            self.grant_log.append(g)
            if kind == "mm_write":
                return g[1], g[2], g[3]
            return g[1], g[2]
        if kind == "mm_read":
            if not res["found"][i]:
                return None
            g = (op.key, int(res["wts"][i]), int(res["rts"][i]),
                 int(res["version"][i]))
            self.grant_log.append(g)
            return (self._vals[int(res["gseq"][i])], g[3], g[1], g[2])
        raise ValueError(f"unknown op kind {kind!r}")

    # ------------------------------------------------------------ batched
    def peek(self, key, replica: int = 0) -> bool:
        kid = self._keys.get(key)
        if kid is None:
            return False
        s1 = int(self._meta[kid][0])
        tags = self._af.rp.tag[replica, s1, :-1].cpu().numpy()
        w = np.nonzero(tags == kid)[0]
        if w.size == 0:
            return False
        rts = int(self._af.rp.rts[replica, s1, int(w[0])])
        return bool(protocol.valid(int(self._af.rp.cts[replica]), rts))

    def read_batch(self, keys: Sequence, replica: int = 0):
        """The two-phase batched read (backend contract), vectorized:
        phase 1 serves every replica-tier lease hit with ONE
        ``state.tier_probe``; phase 2 serves the miss subset with the
        vectorized miss pass over conflict-free rounds, falling back to
        the op scan under ``pipeline="scan"`` or when the subset needs
        more rounds than ``max(_MIN_ROUND_BUDGET, misses // 4)``."""
        return self.read_batch_async(keys, replica).result()

    def read_batch_async(self, keys: Sequence, replica: int = 0):
        """The overlapped batched read (backend contract): the phase-1
        probe runs and is decoded (one device-to-host copy), then the miss
        pass is ENQUEUED and only its decode waits in the handle — no
        device value is read before ``.result()`` on the miss path."""
        if not keys:
            return ReadBatchHandle(lambda: [])
        B = len(keys)
        with obs.span("fabric.pack", n_ops=B):
            keymap = self._keys
            try:
                kids = [keymap[k] for k in keys]  # hot path: interned keys
            except KeyError:
                kids = [self._kid(k) for k in keys]
            kids_np = np.asarray(kids, np.int32)
            if self._meta_dev is None:
                # whole table at its (power-of-two) capacity
                self._meta_dev = to_device(self._meta[:, 0], self.device)
        with obs.span("fabric.fast_probe", n_ops=B):
            packed = _fast_read(self._af, self._meta_dev,
                                to_device(kids_np, self.device), replica)
            obs.fence(packed, "fabric.fast_probe.device")
        with obs.span("fabric.decode", n_ops=B):
            packed = packed.cpu().numpy()
            hit = packed[0].astype(bool)
            ver, gseq = packed[1], packed[2]
            vals, pend = self._vals, self._pending
            if hit.all():
                self._fast_read_batches += 1
                ready = [(vals[g], v) if v >= 0
                         else (pend[(replica, k)], None)
                         for k, v, g in zip(kids, ver.tolist(),
                                            gseq.tolist())]
                return ReadBatchHandle(lambda: ready)
            out: List = [None] * B
            for i in np.nonzero(hit)[0]:
                v = int(ver[i])
                out[i] = ((pend[(replica, kids[i])], None) if v < 0
                          else (vals[int(gseq[i])], v))
            miss = np.nonzero(~hit)[0]
        with obs.span("fabric.miss_pass", misses=int(miss.size)):
            decode = (self._read_misses_dispatch(keys, kids_np, miss,
                                                 replica)
                      if self.pipeline == "batched" else None)
        if decode is None:          # scan pipeline / round-budget bail
            res = self.apply([Op("read", keys[i], replica=replica)
                              for i in miss])
            for j, i in enumerate(miss):
                out[i] = res[j][1]
            return ReadBatchHandle(lambda: out)

        def finish():
            served = decode()
            for j, i in enumerate(miss):
                out[i] = served[j]
            return out

        return ReadBatchHandle(finish)

    def _read_misses_dispatch(self, keys, kids_np, miss, replica):
        """Enqueue the miss subset through the vectorized miss pass
        (graph-colored conflict-free rounds over the padded subset).
        Returns a decode closure that resolves results — grant-log appends
        and payload lookups — in op order, or None to signal the op-scan
        fallback when the subset is too conflict-ridden to pay off."""
        m = miss.size
        with obs.span("fabric.pack", misses=int(m)):
            kids_m = kids_np[miss]
            meta = self._meta[kids_m]
            rounds = P_.conflict_rounds(kids_m, meta[:, 0], meta[:, 1])
            if len(rounds) > max(_MIN_ROUND_BUDGET, m // 4):
                return None
            # pow2 lane/round buckets, as the reference pads them
            M = max(32, _next_pow2(m))
            R = max(4, _next_pow2(len(rounds)))
            masks = P_.round_masks(rounds, R, M)
            ops = np.zeros((4, M), np.int32)
            ops[0, :m] = kids_m
            ops[1, :m] = meta[:, 0]
            ops[2, :m] = meta[:, 1]
            ops[3, :m] = meta[:, 2]
            node = replica // self._rpn
        with obs.span("fabric.exchange"):
            af = self._xin()
        with obs.span("fabric.scan", misses=int(m)):
            _, res = self._miss_run(af, ops, masks, replica, node,
                                    self.cfg.rd_lease, self.cfg.wr_lease)
            self._xout()
            obs.fence(res, "fabric.scan.device")

        def decode():
            with obs.span("fabric.decode", misses=int(m)):
                fields = dict(zip(S.RES_FIELDS, res.cpu().numpy()))
                out: List = []
                for j, i in enumerate(miss):
                    if fields["mm_used"][j]:
                        self.grant_log.append(
                            (keys[i], int(fields["wts"][j]),
                             int(fields["rts"][j]),
                             int(fields["version"][j])))
                    out.append(self._read_result(int(kids_m[j]), replica,
                                                 fields["found"][j],
                                                 fields["version"][j],
                                                 fields["gseq"][j]))
            return out

        return decode

    def _note_write_batch(self) -> None:
        self._write_batches += 1

    def write_batch(self, items, replica: int = 0, wr_lease=None) -> None:
        """Batched posted writes (backend contract), vectorized: the whole
        storm runs through the batched write pass — conflict-free rounds
        with the lane-static drain schedule (``pipeline.write_schedule``)
        and ONE batched TSU write-through grant per round — falling back
        to the op scan under ``pipeline="scan"`` or when the batch needs
        more rounds than ``max(_MIN_ROUND_BUDGET, writes // 2)``."""
        items = list(items)
        if not items:
            return
        self._note_write_batch()
        served = False
        if self.pipeline == "batched":
            with obs.span("fabric.write_pass", n_ops=len(items)):
                served = self._write_batch_batched(items, replica, wr_lease)
        if not served:
            self.apply([Op("write", k, v, replica=replica,
                           wr_lease=wr_lease) for k, v in items])

    def _write_batch_batched(self, items, replica, wr_lease) -> bool:
        """Serve a posted-write batch with the vectorized write pass, then
        replay the returned drain log in op order via ``_drains``.
        Returns False to signal the op-scan fallback."""
        B = len(items)
        node = replica // self._rpn
        with obs.span("fabric.pack", n_ops=B):
            kids = np.asarray([self._kid(k) for k, _ in items], np.int32)
            meta = self._meta[kids]
            wl = -1 if wr_lease is None else wr_lease
            pending = [(k, *self._meta[k].tolist(), r, w)
                       for k, _, r, w in self._qmirror[node]]
            rounds, sched = P_.write_schedule(
                kids, meta[:, 0], meta[:, 1], meta[:, 2], replica, wl,
                pending, self.cfg.max_in_flight)
            if len(rounds) > max(_MIN_ROUND_BUDGET, B // 2):
                return False
            M = max(32, _next_pow2(B))
            R = max(4, _next_pow2(len(rounds)))
            masks = P_.round_masks(rounds, R, M)
            ops = np.zeros((4, M), np.int32)
            ops[0, :B] = kids
            ops[1, :B] = meta[:, 0]
            ops[2, :B] = meta[:, 1]
            ops[3, :B] = meta[:, 2]
            sched = np.pad(sched, ((0, 0), (0, M - B)))
        with obs.span("fabric.exchange"):
            af = self._xin()
        with obs.span("fabric.scan", n_ops=B):
            _, res = self._write_run(af, ops, sched, masks, replica,
                                     node, wl, self.cfg.rd_lease,
                                     self.cfg.wr_lease)
            self._xout()
            obs.fence(res, "fabric.scan.device")
        with obs.span("fabric.decode", n_ops=B):
            f = dict(zip(P_.WRITE_RES_FIELDS, res.cpu().numpy()))
            # the drain decoder reads per-op drain-log ROWS; a write op
            # drains at most once, so each lane is a one-column row
            rd = {"dcount": f["dcount"]}
            rd.update({k: f[k][:, None] for k in P_.WRITE_RES_FIELDS[1:]})
            for i, (k, v) in enumerate(items):
                kid = int(kids[i])
                self._pending[(replica, kid)] = v
                self._pending_n[(replica, kid)] = self._pending_n.get(
                    (replica, kid), 0) + 1
                self._qmirror[node].append((kid, v, replica, wl))
                self._drains(rd, i, node=node)
        if self._writes_since_prune >= _PRUNE_EVERY:
            self.prune_payloads()
        return True

    # ------------------------------------------------------------ scalar
    def read(self, key, replica: int = 0):
        return self.apply([Op("read", key, replica=replica)])[0][1]

    def write(self, key, value, replica: int = 0, wr_lease=None) -> None:
        self.apply([Op("write", key, value, replica=replica,
                       wr_lease=wr_lease)])

    def fence(self) -> int:
        """Drain every node's posted-write queue, then jump all client
        clocks to the global max — through the op scan, as the reference's
        single-device fabric does (``_fence_batched`` is the vectorized
        fence pass, held equal to it by the tests)."""
        return self.apply([Op("fence")])[0][1]

    def _fence_batched(self) -> Optional[int]:
        """Serve a fence with the vectorized fence pass: every queued entry
        (all nodes, node-major FIFO) becomes one schedule lane; the drain
        log replays through ``_drains``.  Returns None to signal the
        op-scan fallback when the drain set is too conflict-ridden."""
        entries = []
        for nd in range(self.n_nodes):
            for kid, _v, rep, wl in self._qmirror[nd]:
                s1, s2, shard = self._meta[kid].tolist()
                entries.append((kid, s1, s2, shard, rep, wl, nd))
        D0 = len(entries)
        rounds, sched = P_.fence_schedule(entries)
        if len(rounds) > max(_MIN_ROUND_BUDGET, max(1, D0) // 2):
            return None
        D = max(8, _next_pow2(max(1, D0)))
        R = max(4, _next_pow2(len(rounds)))
        sched = np.pad(sched, ((0, 0), (0, D - D0)))
        masks = P_.round_masks(rounds, R, D)
        with obs.span("fabric.exchange"):
            af = self._xin()
        _, res, gmax = self._fence_run(af, sched, masks,
                                       self.cfg.rd_lease, self.cfg.wr_lease)
        self._xout()
        f = dict(zip(P_.WRITE_RES_FIELDS, res.cpu().numpy()))
        # ONE fence op draining D0 entries: the whole lane axis is row 0
        rd = {"dcount": np.asarray([D0], np.int32)}
        rd.update({k: f[k][None, :] for k in P_.WRITE_RES_FIELDS[1:]})
        self._drains(rd, 0)
        if self._writes_since_prune >= _PRUNE_EVERY:
            self.prune_payloads()
        return int(gmax)

    def mm_write(self, key, value, wr_lease=None):
        return self.apply([Op("mm_write", key, value,
                              wr_lease=wr_lease)])[0][1]

    def publish(self, key, value, node: int = 0, wr_lease=None):
        return self.apply([Op("publish", key, value, node=node,
                              wr_lease=wr_lease)])[0][1]

    def mm_read(self, key):
        return self.apply([Op("mm_read", key)])[0][1]

    # ------------------------------------------------------------ views
    def memts(self, key) -> int:
        kid = self._keys.get(key)
        if kid is None:
            return 0
        shard = int(self._meta[kid][2])
        tsu = self._full_state().tsu
        tags = tsu.tag[shard, 0].cpu().numpy()
        hit = np.nonzero(tags == kid)[0]
        if hit.size == 0:
            return 0
        return int(tsu.memts[shard, 0, int(hit[0])])

    @property
    def fast_read_batches(self) -> int:
        return self._fast_read_batches

    def stats(self) -> Dict[str, int]:
        g = self._af.g.cpu().numpy()
        out = {k: int(g[i]) for i, k in enumerate(_G_KEYS)}
        out["wb_evictions"] = 0
        out["inval_msgs"] = 0
        out["fast_read_batches"] = self._fast_read_batches
        out["write_batches"] = self._write_batches
        return out

    def replica_stats(self, replica: int = 0) -> Dict[str, int]:
        r = self._af.r[replica].cpu().numpy()
        out = {k: 0 for k in self.stats()}
        out.update({k: int(r[i]) for i, k in enumerate(_R_KEYS)})
        return out


class _ShardedOpScan(_OpScan):
    """The op scan under ``pipeline="scan"`` on a fabric group: the TSU
    leaves it is handed are this rank's owned rows, each op's TSU
    transition runs on its key's owning rank against them, and the grant
    hops back to the group in one broadcast — one collective per
    TSU-touching op, the ordering-sensitive debugging schedule."""

    def __init__(self, *args, group, rows: int, me: int, ranks):
        super().__init__(*args)
        self.group, self.rows, self.me, self.ranks = group, rows, me, ranks

    def _at_owner(self, shard: int, run, is_bool):
        """Run ``run(local_row)`` on the rank owning ``shard`` and
        broadcast its [1] outputs (bools as 0/1) to every rank."""
        owner, row = divmod(shard, self.rows)
        if owner == self.me:
            buf = torch.cat([v.reshape(1).to(_i32) for v in run(row)])
        else:
            buf = torch.empty((len(is_bool),), dtype=_i32, device=self.dev)
        dist.broadcast(buf, src=self.ranks[owner], group=self.group)
        return tuple(buf[i:i + 1] != 0 if b else buf[i:i + 1]
                     for i, b in enumerate(is_bool))

    def tsu_write(self, af, key, shard, gs, wl, rd, wr):
        local = super().tsu_write
        return self._at_owner(shard, lambda row: local(af, key, row, gs, wl,
                                                       rd, wr),
                              (False, False, False, True, True))

    def tsu_read(self, af, key, shard, rd, wr, active):
        local = super().tsu_read
        return self._at_owner(shard, lambda row: local(af, key, row, rd, wr,
                                                       active),
                              (True, False, False, False, False, True))


class ShardedArrayFabric(ArrayFabric):
    """The group-placed fabric: TSU shards on the ranks of a
    ``torch.distributed`` group.

    HALCONE's TSU is physically distributed — one timestamp storage unit
    per HBM stack, each coherence action executed beside the memory it
    guards.  Between batches each rank holds ONLY its owned rows of the
    ``[n_shards, 1, capacity+1]`` TSU table (``tsu``, ``tsu_ver``,
    ``tsu_gseq``, ``tsu_seq`` as ``[n_shards/D, 1, capacity+1]``,
    ``tsu_nseq`` as ``[n_shards/D]``); shard ``s`` lives on group rank
    ``s // (n_shards / D)``.  The client tiers and write-queue rings are
    replicated: the fabric is SPMD, every rank runs the same op stream
    through the same entry points and the same passes on identical
    tables.

    Under the default ``pipeline="batched"`` every device pass that
    touches the TSU (``apply``'s op scan, the miss, write and fence
    passes) starts with ONE ``state.owner_gather`` of the packed owned
    rows into a full-table buffer, runs on that buffer in place, and
    keeps its own rows with ``state.owner_take``; the next pass's gather
    is then issued asynchronously, to overlap the host's decode.  An
    all-hit read batch touches no TSU and issues no collective.  Under
    ``pipeline="scan"`` each op's TSU transition runs on its owning rank
    and the grant hops back in one broadcast.  ``bytes_inter_gpu`` counts
    home-shard misses (``node_id % n_shards``), not messages, so every
    counter is identical across group sizes and pipelines, and to the
    single-device ``ArrayFabric``.

    ``group`` defaults to ``launch.mesh.make_fabric_group(n_shards)``
    (NCCL on the card, gloo for ``device="cpu"``); ``n_shards`` must be
    divisible by its size.  ``device=None`` is the rank's card
    (``backend.resolve_device``).
    """

    def __init__(self, cfg: FabricConfig = FabricConfig(),
                 n_nodes: int = 1, replicas_per_node: int = 1, group=None,
                 pipeline: str = "batched", device=None):
        cfg = _bounded(cfg)
        if group is None:
            group = make_fabric_group(cfg.n_shards,
                                      backend=_backend_for(device))
        if group == dist.GroupMember.NON_GROUP_MEMBER:
            raise ValueError("this rank is not a member of the fabric group")
        D = dist.get_world_size(group)
        if cfg.n_shards % D:
            raise ValueError(
                f"n_shards={cfg.n_shards} must be divisible by the fabric "
                f"group's {D} ranks")
        self.group = group
        self._D = D
        self._me = dist.get_rank(group)
        self._rows = cfg.n_shards // D
        self._ranks = dist.get_process_group_ranks(group)
        self._prefetch = None       # the next pass's gather, in flight
        self._full = None           # the table a pass runs on
        super().__init__(cfg, n_nodes, replicas_per_node, pipeline=pipeline,
                         device=device)
        if pipeline == "batched":
            self._prefetch = self._gather(async_op=True)

    @property
    def n_shard_devices(self) -> int:
        return self._D

    def _make_scan(self) -> _OpScan:
        if self.pipeline != "scan":
            return super()._make_scan()
        return _ShardedOpScan(self._W1, self._W2, self._KS, self._CAP,
                              self.n_nodes, self.n_replicas, self._Q,
                              self.cfg.max_in_flight, self.device,
                              group=self.group, rows=self._rows, me=self._me,
                              ranks=self._ranks)

    @property
    def _owned(self) -> slice:
        """This rank's rows of the full table."""
        return slice(self._me * self._rows, (self._me + 1) * self._rows)

    def _init_af(self) -> _AF:
        af = super()._init_af()
        own = self._owned
        return af._replace(
            tsu=TSUState(tag=af.tsu.tag[own].clone(),
                         memts=af.tsu.memts[own].clone()),
            tsu_ver=af.tsu_ver[own].clone(), tsu_gseq=af.tsu_gseq[own].clone(),
            tsu_seq=af.tsu_seq[own].clone(), tsu_nseq=af.tsu_nseq[own].clone())

    # --------------------------------------------------- grant exchange
    def _gather(self, async_op: bool):
        """ONE all-gather of this rank's packed rows into the full table."""
        a = self._af
        return S.owner_gather(
            S.pack_tsu(a.tsu, a.tsu_ver, a.tsu_gseq, a.tsu_seq, a.tsu_nseq),
            self.group, async_op=async_op)

    def _with_table(self, full: torch.Tensor) -> _AF:
        tsu, ver, gseq, seq, nseq = S.unpack_tsu(full)
        return self._af._replace(tsu=tsu, tsu_ver=ver, tsu_gseq=gseq,
                                 tsu_seq=seq, tsu_nseq=nseq)

    def _xin(self) -> _AF:
        """The state a pass runs on: the replicated leaves as they are and
        the TSU leaves as views of the gathered full table, which the pass
        updates in place (never the owned rows by global index).  Under
        ``pipeline="scan"`` the owned rows themselves."""
        if self.pipeline != "batched":
            return self._af
        self._full = self._prefetch.wait()
        self._prefetch = None
        return self._with_table(self._full)

    def _xout(self) -> None:
        """Keep this rank's rows of the table the pass updated, then issue
        the next pass's gather asynchronously."""
        if self.pipeline != "batched":
            return
        with obs.span("fabric.exchange"):
            a = self._af
            mine = S.unpack_tsu(S.owner_take(self._full, self._me,
                                             self._rows))
            for dst, src in zip((a.tsu.tag, a.tsu.memts, a.tsu_ver,
                                 a.tsu_gseq, a.tsu_seq, a.tsu_nseq),
                                (mine[0].tag, mine[0].memts) + mine[1:]):
                dst.copy_(src)
            self._full = None
            self._prefetch = self._gather(async_op=True)

    def _full_state(self) -> _AF:
        """The state with the whole table, for views outside a pass.  Under
        the batched pipeline the gather in flight already holds it: it was
        issued right after the last pass kept its rows, and only a pass
        changes the TSU.  Under ``pipeline="scan"``, one gather."""
        if self.pipeline == "batched":
            return self._with_table(self._prefetch.wait())
        return self._with_table(self._gather(async_op=False))

    def fence(self) -> int:
        """The vectorized fence pass (one collective) under the batched
        pipeline, as the reference's sharded fabric runs it; the op scan
        otherwise, or when the drain set is too conflict-ridden."""
        if self.pipeline == "batched":
            out = self._fence_batched()
            if out is not None:
                return out
        return super().fence()


def _backend_for(device) -> Optional[str]:
    """The fabric group's backend for an entry point's ``device``: gloo
    for the CPU, else the default (NCCL where CUDA is available)."""
    return "gloo" if device is not None and \
        torch.device(device).type == "cpu" else None


def default_fabric(cfg: FabricConfig = FabricConfig(),
                   n_nodes: int = 1,
                   replicas_per_node: int = 1,
                   pipeline: str = "batched", device=None,
                   group=None) -> ArrayFabric:
    """The production entry point: the ``ShardedArrayFabric`` when a
    ``torch.distributed`` group is initialised and the shards can spread
    over more than one of its ranks (``group``, else the largest leading
    run of the world's ranks that divides ``n_shards``), the
    single-device ``ArrayFabric`` otherwise — also on a rank outside that
    run, which then holds the whole table itself and joins no collective.
    Both on the CUDA card unless ``device`` says otherwise.  Under a group
    every rank calls it."""
    cfg = _bounded(cfg)
    if group is None and dist.is_available() and dist.is_initialized() \
            and len(fabric_ranks(cfg.n_shards,
                                 range(dist.get_world_size()))) > 1:
        group = make_fabric_group(cfg.n_shards, backend=_backend_for(device))
    if group is not None and group != dist.GroupMember.NON_GROUP_MEMBER \
            and dist.get_world_size(group) > 1:
        return ShardedArrayFabric(cfg, n_nodes, replicas_per_node,
                                  group=group, pipeline=pipeline,
                                  device=device)
    return ArrayFabric(cfg, n_nodes, replicas_per_node, pipeline=pipeline,
                       device=device)
