"""The batched grant pipeline on torch: vectorized miss / write / fence
passes over conflict-free rounds.

The counterpart of ``repro.coherence.fabric.pipeline``.  The host-side
schedulers (``color_rounds``, ``conflict_rounds*``, ``round_masks``,
``write_schedule``, ``_write_colors_*``, ``write_rounds_greedy``,
``fence_schedule``) are numpy and copied verbatim, so both packages split
a batch into the same rounds.  The passes (``make_miss_pass``,
``make_write_pass``, ``make_fence_pass``) run each round's body as torch
ops on the fabric state:

  * the reference's ``lax.scan`` over the ``[R, M]`` round masks becomes
    a Python loop over the mask rows; a round with no active lane is an
    exact no-op there, so the loop skips it;
  * the state is updated IN PLACE (``index_put_``) — every old value a
    round needs is read before the scatter that overwrites it, the order
    the reference's functional ``.at[].set`` gives for free;
  * ``lax.cummax`` becomes ``torch.cummax(...).values`` and every
    ``cumsum``/``sum`` is cast back to int32.

Ops in one round touch disjoint cache state, so executing them together
equals executing them in op order; the per-store LRU ticks are written
provisionally in the rounds and remapped to exact op-order values after
them.  The per-lane round math goes
through ``kernels.ops.miss_round`` (read side) and, via
``core.state.tsu_commit_write_batch``, ``kernels.ops.write_grant`` (write
and fence sides).
"""
from __future__ import annotations

import collections
import functools
from typing import List, Sequence, Tuple

import numpy as np
import torch

from repro_torch.coherence.fabric.backend import to_device
from repro_torch.coherence.fabric.stats import GI, RI
from repro_torch.core import state as S
from repro_torch.core.state import RES_FIELDS, b2i
from repro_torch.kernels import ops as K

_i32 = torch.int32
_NEG = -2 ** 30


@functools.lru_cache(maxsize=None)
def _counter_index(names: Tuple[str, ...], per_replica: bool, device):
    table = RI if per_replica else GI
    return to_device(np.asarray([table[k] for k in names], np.int64), device)


def counter_add(vec, per_replica=False, **kw):
    """``vec[KEY] += value`` for every keyword, IN PLACE, as one
    ``index_add_`` (values are 0-d int32 tensors)."""
    idx = _counter_index(tuple(kw), per_replica, vec.device)
    vec.index_add_(0, idx, torch.stack([v.to(_i32) for v in kw.values()]))


def _n(b):
    return b.sum(dtype=_i32)


# ------------------------------------------------------------ round coloring
def color_rounds(footprints: Sequence[Sequence]) -> List[int]:
    """Order-preserving chain-depth graph coloring.

    ``footprints[j]`` is the set of resources op *j* touches; two ops
    conflict iff their footprints intersect.  The classic interval-free
    relaxation: op *j*'s color is one more than the largest color among
    the **last** prior user of each of its resources —

        color(j) = max(0, max_{res in fp(j)} last[res] + 1)

    which is valid because colors strictly increase along every resource
    chain (so the *last* user of a resource carries the maximum color of
    all its users, and no op in any round below the bound shares a
    resource with *j*), order-preserving within every conflict chain
    (conflicting ops get strictly increasing colors in op order), and
    never worse than the greedy contiguous splitter (by induction: every
    hard predecessor of *j* has a strictly smaller greedy round, so the
    bound never exceeds *j*'s greedy round).  O(n) over footprint sizes.
    """
    last: dict = {}
    colors: List[int] = []
    for fp in footprints:
        c = 0
        for res in fp:
            p = last.get(res)
            if p is not None and p + 1 > c:
                c = p + 1
        for res in fp:
            last[res] = c
        colors.append(c)
    return colors


def _colors_to_rounds(colors: Sequence[int]) -> List[np.ndarray]:
    n_rounds = (max(colors) + 1) if len(colors) else 1
    rounds: List[List[int]] = [[] for _ in range(n_rounds)]
    for j, c in enumerate(colors):
        rounds[c].append(j)
    return [np.asarray(r, np.int64) for r in rounds]


def conflict_rounds(kids, s1, s2) -> List[np.ndarray]:
    """Split a miss subset (op order) into conflict-free rounds by
    chain-depth graph coloring: within a round all keys, replica sets and
    shared sets are distinct, and any two ops that share one of those
    resources land in rounds ordered like the ops — so committing the
    rounds in order IS the sequential op order for every conflict chain.
    Returns index arrays into the subset (ascending within each round);
    concatenated they are a permutation of ``range(len(kids))``.  Never
    more rounds than ``conflict_rounds_greedy``."""
    fps = [((0, k), (1, a), (2, b))
           for k, a, b in zip(np.asarray(kids).tolist(),
                              np.asarray(s1).tolist(),
                              np.asarray(s2).tolist())]
    return _colors_to_rounds(color_rounds(fps))


def conflict_rounds_greedy(kids, s1, s2) -> List[np.ndarray]:
    """The greedy splitter (kept as the coloring property-test oracle):
    maximal contiguous conflict-free segments in op order."""
    rounds: List[np.ndarray] = []
    cur: List[int] = []
    seen_k, seen_1, seen_2 = set(), set(), set()
    for i, (k, a, b) in enumerate(zip(np.asarray(kids).tolist(),
                                      np.asarray(s1).tolist(),
                                      np.asarray(s2).tolist())):
        if k in seen_k or a in seen_1 or b in seen_2:
            rounds.append(np.asarray(cur, np.int64))
            cur = []
            seen_k, seen_1, seen_2 = set(), set(), set()
        cur.append(i)
        seen_k.add(k)
        seen_1.add(a)
        seen_2.add(b)
    rounds.append(np.asarray(cur, np.int64))
    return rounds


def round_masks(rounds: List[np.ndarray], n_rounds: int,
                width: int) -> np.ndarray:
    """Pack conflict rounds into a dense ``[n_rounds, width]`` bool mask
    matrix (rows beyond ``len(rounds)`` are empty — a fully masked pass is
    a no-op), the shape the one-jit round scan consumes."""
    masks = np.zeros((n_rounds, width), bool)
    for r, idxs in enumerate(rounds):
        masks[r, idxs] = True
    return masks

# ------------------------------------------------------ batched write pass
# The packed per-op result block of the write pass ([6, M] int32): each op
# is a posted write, so the only externally visible output is its drain —
# dcount (0/1) plus the drained grant's key/version/lease/gseq, exactly the
# op-scan's dlog_* record restricted to the one-drain-per-write case.
WRITE_RES_FIELDS = ("dcount", "dlog_key", "dlog_ver", "dlog_wts",
                    "dlog_rts", "dlog_gseq")

# the per-lane drain schedule block handed to the write pass ([7, M] int32)
WRITE_SCHED_FIELDS = ("drain", "dkey", "drep", "dwl", "dshard", "ds1",
                      "ds2")


def write_schedule(kids, s1, s2, shard, rep, wl, pending, maxif,
                   splitter: str = "colored"):
    """Resolve a write batch's drain schedule and split it into
    conflict-free rounds for the lane-static batched write pass.

    The bounded ring's drain schedule is **static in op index**: with L0
    pending entries at batch start, op j (0-based) drains the queue head
    iff ``L0 + j + 1 > maxif`` — so this host-side simulation resolves
    every drained entry exactly, independent of round assignment.

    ``pending`` is the node's queue at batch start, oldest first, as
    ``(kid, s1, s2, shard, rep, wl)`` tuples (``wl`` = the write-lease
    override recorded when the entry was posted, -1 for the default);
    ``rep``/``wl`` describe this batch's pushes.  Returns ``(rounds,
    sched)`` where ``sched`` is the ``[7, n]`` int32
    ``WRITE_SCHED_FIELDS`` block (zeros on non-drain lanes) and
    ``rounds`` are index arrays into the batch (a permutation of
    ``range(n)`` when concatenated; ascending within each round).

    Round constraints (op footprints): a push claims its key and its
    ``(rep, s1)`` replica set; a drain claims the drained entry's TSU
    shard and ``(node, s2)`` shared set always, plus its key and
    ``(drep, s1)`` replica set unless the entry was pushed in the very
    round the drain lands in (the pass applies every pending install
    before any drain install, so a same-round drain re-probes the
    pending line exactly as the sequential scan would).  The ``colored``
    splitter is chain-depth coloring (see ``color_rounds``) with three
    *order* side constraints that keep the pass's running-maximum clock
    chains and the TSU allocation sequencer exact:

      * a drain never lands in an earlier round than any prior drain
        (drains execute in op order globally — gseq ranks, the node
        clock chain and the per-replica clock chains then read in lane
        order = op order);
      * a push never lands in an earlier round than a prior drain whose
        entry belongs to the push's replica (the pending line's
        ``pend_cts`` must see that drain's replica-clock bump);
      * a drain of this replica's own entry never lands in an earlier
        round than any prior push (the prior pushes' ``pend_cts`` must
        NOT see this drain's bump; ties resolve in-round by exclusive
        prefix maxima).

    ``splitter="greedy"`` reproduces the greedy contiguous splitter (the
    property-test oracle; colored never uses more rounds)."""
    kids = np.asarray(kids).tolist()
    s1 = np.asarray(s1).tolist()
    s2 = np.asarray(s2).tolist()
    shard = np.asarray(shard).tolist()
    n = len(kids)
    wl = int(wl)

    # ---- static drain schedule: simulate the bounded ring on the host
    q = collections.deque((tuple(e), -1) for e in pending)
    drain = np.zeros((n,), np.int64)
    dent: List = [None] * n        # drained entry per op
    dpe: List = [None] * n         # in-batch push op of the drained entry
    for j in range(n):
        q.append(((kids[j], s1[j], s2[j], shard[j], rep, wl), j))
        if len(q) > maxif:
            e, pe = q.popleft()
            drain[j] = 1
            dent[j] = e
            dpe[j] = pe if pe >= 0 else None

    sched = np.zeros((len(WRITE_SCHED_FIELDS), n), np.int32)
    sched[0] = drain
    for j in range(n):
        if drain[j]:
            ek, e1, e2, esh, erep, ewl = dent[j]
            sched[1, j] = ek
            sched[2, j] = erep
            sched[3, j] = ewl
            sched[4, j] = esh
            sched[5, j] = e1
            sched[6, j] = e2

    if splitter == "greedy":
        colors = _write_colors_greedy(n, kids, s1, rep, drain, dent, dpe)
    else:
        colors = _write_colors_chain(n, kids, s1, rep, drain, dent, dpe)
    return _colors_to_rounds(colors) if n else [np.asarray([], np.int64)], \
        sched


def _write_colors_greedy(n, kids, s1, rep, drain, dent, dpe):
    """The greedy contiguous splitter, re-expressed over the static drain
    schedule: break before op j whenever its footprint intersects the
    open round's, with the same-round-push exemption re-evaluated after a
    break (the pushed entry may now sit in the previous round)."""
    colors: List[int] = []
    r = 0
    seen_k, seen_1, seen_2, seen_sh = set(), set(), set(), set()
    for j in range(n):
        def fp(r_):
            fk, f1, f2, fsh = {kids[j]}, {(rep, s1[j])}, set(), set()
            if drain[j]:
                ek, e1, e2, esh, erep, _ = dent[j]
                fsh.add(esh)
                f2.add(e2)
                pe = dpe[j]
                same_round = pe is not None and (pe == j or
                                                 colors[pe] == r_)
                if not same_round:
                    fk.add(ek)
                    f1.add((erep, e1))
            return fk, f1, f2, fsh

        fk, f1, f2, fsh = fp(r)
        if (fk & seen_k) or (f1 & seen_1) or (f2 & seen_2) \
                or (fsh & seen_sh):
            r += 1
            seen_k, seen_1, seen_2, seen_sh = set(), set(), set(), set()
            fk, f1, f2, fsh = fp(r)
        colors.append(r)
        seen_k |= fk
        seen_1 |= f1
        seen_2 |= f2
        seen_sh |= fsh
    return colors


def _write_colors_chain(n, kids, s1, rep, drain, dent, dpe):
    """Chain-depth coloring for the write storm (see ``write_schedule``
    docstring for the constraint system).  Hard resources take
    ``last[res] + 1``; the three order side constraints are soft (ties
    allowed).  A drain of an entry pushed in this batch at op ``pe`` is
    *exempt* from its key/replica-set resources only when it can land
    exactly in ``colors[pe]`` (the push's round, where the pass's
    pending-before-drain install order reproduces the sequential
    push-then-drain); otherwise the key conflict forces it at least one
    round later."""
    last: dict = {}
    colors: List[int] = []
    max_dc = -1                  # max color of any drain so far
    max_dc_rep: dict = {}        # ... of drains per drained-entry replica
    max_push = -1                # max color of any op (= push) so far
    for j in range(n):
        push_res = ((0, kids[j]), (1, rep, s1[j]))
        lb = max(0, max_dc_rep.get(rep, -1))
        for res in push_res:
            p = last.get(res)
            if p is not None and p + 1 > lb:
                lb = p + 1
        if not drain[j]:
            for res in push_res:
                last[res] = lb
            colors.append(lb)
            if lb > max_push:
                max_push = lb
            continue

        ek, e1, e2, esh, erep, _ = dent[j]
        d0_res = ((3, esh), (2, e2))
        dk_res = ((0, ek), (1, erep, e1))
        lb_ex = max(lb, max_dc)
        if erep == rep and max_push > lb_ex:
            lb_ex = max_push
        for res in d0_res:
            p = last.get(res)
            if p is not None and p + 1 > lb_ex:
                lb_ex = p + 1
        pe = dpe[j]
        if pe is not None and (pe == j or lb_ex <= colors[pe]):
            c = lb_ex if pe == j else colors[pe]
        else:
            c = lb_ex
            for res in dk_res:
                p = last.get(res)
                if p is not None and p + 1 > c:
                    c = p + 1
        for res in push_res + d0_res + dk_res:
            last[res] = c
        if c > max_dc:
            max_dc = c
        if c > max_dc_rep.get(erep, -1):
            max_dc_rep[erep] = c
        if c > max_push:
            max_push = c
        colors.append(c)
    return colors


def write_rounds_greedy(kids, s1, s2, shard, rep, wl, pending, maxif):
    """Greedy contiguous write rounds (the coloring property-test
    oracle) — ``write_schedule`` with ``splitter="greedy"``."""
    return write_schedule(kids, s1, s2, shard, rep, wl, pending, maxif,
                          splitter="greedy")

# ------------------------------------------------------------- fence pass
# the per-lane fence schedule block ([8, D] int32): one lane per queued
# posted write, in node order then FIFO order — the exact host drain order
FENCE_SCHED_FIELDS = ("ent", "dkey", "drep", "dwl", "dshard", "ds1",
                      "ds2", "dnode")


def fence_schedule(entries) -> Tuple[List[np.ndarray], np.ndarray]:
    """Build the fence drain schedule: ``entries`` is every node's queue
    concatenated in node order (each oldest-first), as
    ``(kid, s1, s2, shard, rep, wl, node)`` tuples.  Returns ``(rounds,
    sched)`` with ``sched`` the [8, n] ``FENCE_SCHED_FIELDS`` block.

    Rounds are greedy contiguous segments over the drain footprint (key,
    replica set, shared set, TSU shard): a fence drains in strict host
    order, and the drain-order side constraint (every drain >= all prior
    drains) collapses chain-depth coloring to exactly this contiguous
    segmentation — so the greedy split is the colored split here."""
    n = len(entries)
    sched = np.zeros((len(FENCE_SCHED_FIELDS), n), np.int32)
    rounds: List[np.ndarray] = []
    cur: List[int] = []
    seen: set = set()
    for j, (k, a, b, sh, rep, wl, node) in enumerate(entries):
        sched[:, j] = (1, k, rep, wl, sh, a, b, node)
        fp = {(0, k), (1, rep, a), (2, node, b), (3, sh)}
        if fp & seen:
            rounds.append(np.asarray(cur, np.int64))
            cur = []
            seen = set()
        cur.append(j)
        seen |= fp
    rounds.append(np.asarray(cur, np.int64))
    return rounds, sched



# ------------------------------------------------------------ torch passes
def _rounds(masks: np.ndarray) -> np.ndarray:
    """Rows of the host round matrix with at least one active lane."""
    return np.nonzero(np.asarray(masks).any(axis=1))[0]


def make_miss_pass(W1: int, W2: int, KS: int):
    """Build the vectorized miss pass for one tier geometry (W1/W2 = tier
    way counts, i.e. the trash-way indices; KS = TSU shard count).

    ``pass_(af, ops, masks, rep, node, rd, wr) -> (af, res)``: ``af`` is
    the fabric state (``arrays._AF``, updated IN PLACE and returned),
    ``ops`` the host ``[4, M]`` int32 op block (kid, replica set, shared
    set, TSU shard; padded lanes all-zero and masked out), ``masks`` the
    host ``[R, M]`` conflict-round matrix, rep/node python ints, and
    ``res`` the ``[7, M]`` int32 per-op result block (``RES_FIELDS``)."""

    def tier_fill(tier, gseq_a, idx, st, th, touch_lru, way, fill_c, key,
                  fill_lru, trash, fields):
        """Touch + victim + fill on one (already-dropped) tier, IN PLACE:
        the LRU touch refresh, then the install at the victim way."""
        wt = torch.where(th, way, trash)
        old = tier.lru[idx, st, wt]
        tier.lru.index_put_((idx, st, wt), torch.where(th, touch_lru, old))
        vic = S.victim(tier.tag, tier.lru, idx, st)
        evicted = fill_c & (tier.tag[idx, st, vic] != S.INVALID)
        wf = torch.where(fill_c, vic, trash)
        for a, v in [(tier.tag, key), (tier.lru, fill_lru)] + fields:
            old = a[idx, st, wf]
            a.index_put_((idx, st, wf), torch.where(fill_c, v, old))
        return evicted

    def round_body(af, out, act, kids, s1, s2, shard, rep, node, rd):
        # ---- fused per-lane round math (kernels.ops.miss_round): replica
        # probe, shared probe, Algorithm 3 TSU read grant and both install
        # levels over the tier tables in place, each lane's sets and shard
        # by index; the cross-lane state scatters stay here
        (th1, h1, way1, th2, h2, way2, fndF, tway, mwts, mrts, nmem, ovf,
         nwA, nrA, nw1, nr1) = K.miss_round(
            af.rp.tag[rep][:, :-1], af.rp.rts[rep][:, :-1],
            af.sh.tag[node][:, :-1], af.sh.rts[node][:, :-1],
            af.sh.wts[node][:, :-1],
            af.tsu.tag[:, 0, :-1], af.tsu.memts[:, 0, :-1],
            af.rp.cts[rep:rep + 1], af.sh.cts[node:node + 1], kids, act, rd,
            rows=(s1, s2, shard))
        M = kids.shape[0]
        dev = kids.device
        reps = torch.full((M,), rep, dtype=_i32, device=dev)
        nodes = torch.full((M,), node, dtype=_i32, device=dev)
        zt = torch.zeros_like(shard)

        # ---- replica classification + self-invalidate
        hit_ver = af.rp.ver[reps, s1, way1]
        hit_gs = af.rp_gseq[reps, s1, way1]
        miss = act & ~h1
        coh = miss & th1
        comp = miss & ~th1
        w1d = torch.where(coh, way1, W1)
        old = af.rp.tag[reps, s1, w1d]
        af.rp.tag.index_put_((reps, s1, w1d), torch.where(coh, S.INVALID, old))

        # ---- shared self-invalidate (on a replica miss)
        sh_ver = af.sh.ver[nodes, s2, way2]
        sh_gs = af.sh_gseq[nodes, s2, way2]
        coh2 = th2 & ~h2
        w2d = torch.where(coh2, way2, W2)
        old = af.sh.tag[nodes, s2, w2d]
        af.sh.tag.index_put_((nodes, s2, w2d),
                             torch.where(coh2, S.INVALID, old))

        # ---- commit the round's TSU grants + metadata
        need_mm = miss & ~h2
        S.tsu_commit_batch(af.tsu, shard, zt, tway, kids, nmem, fndF)
        mver = torch.where(fndF, af.tsu_ver[shard, zt, tway], -1)
        mgs = torch.where(fndF, af.tsu_gseq[shard, zt, tway], -1)
        home_miss = shard != node % KS

        # ---- response chain (what travels up to each tier)
        resp_found = h2 | fndF
        resp_ver = torch.where(h2, sh_ver, mver)
        resp_gs = torch.where(h2, sh_gs, mgs)

        # ---- provisional tick math (execution-order ranks)
        c1 = torch.cumsum(b2i(th1) + b2i(resp_found), 0).to(_i32)
        lru_t1 = af.rp_tick[rep] + c1 - b2i(resp_found)
        lru_f1 = af.rp_tick[rep] + c1
        c2 = torch.cumsum(b2i(th2) + b2i(fndF), 0).to(_i32)
        lru_t2 = af.sh_tick[node] + c2 - b2i(fndF)
        lru_f2 = af.sh_tick[node] + c2

        evF = tier_fill(af.sh, af.sh_gseq, nodes, s2, th2, lru_t2, way2,
                        fndF, kids, lru_f2, W2,
                        [(af.sh.wts, nwA), (af.sh.rts, nrA),
                         (af.sh.ver, mver), (af.sh_gseq, mgs)])
        ev1 = tier_fill(af.rp, af.rp_gseq, reps, s1, th1, lru_t1, way1,
                        resp_found, kids, lru_f1, W1,
                        [(af.rp.wts, nw1), (af.rp.rts, nr1),
                         (af.rp.ver, resp_ver), (af.rp_gseq, resp_gs)])

        # ---- counters: the op scan's per-read increments, summed
        b12, b2m, big = S.link_bytes(_n(miss), _n(need_mm),
                                     _n(need_mm & home_miss))
        counter_add(
            af.g, reads=_n(act), l1_hits=_n(h1), l2_hits=_n(h2),
            l1_to_l2=_n(miss), coh_miss_l1=_n(coh), coh_miss_l2=_n(coh2),
            self_invalidations=_n(coh) + _n(coh2), compulsory=_n(comp),
            l2_to_mm=_n(need_mm), pcie_blocks=_n(need_mm & home_miss),
            refetches=_n(resp_found), overflow_reinits=_n(ovf),
            capacity_evictions=_n(evF) + _n(ev1),
            bytes_l1_l2=b12, bytes_l2_mm=b2m, bytes_inter_gpu=big)
        counter_add(
            af.r[rep], per_replica=True, reads=_n(act), l1_hits=_n(h1),
            l2_hits=_n(h2), l1_to_l2=_n(miss), coh_miss_l1=_n(coh),
            coh_miss_l2=_n(coh2), self_invalidations=_n(coh) + _n(coh2),
            compulsory=_n(comp), refetches=_n(resp_found),
            capacity_evictions=_n(evF) + _n(ev1))
        af.rp_tick[rep] += _n(th1) + _n(resp_found)
        af.sh_tick[node] += _n(th2) + _n(fndF)

        vals = torch.stack([
            b2i(h1 | resp_found),
            torch.where(h1, hit_ver, torch.where(resp_found, resp_ver, -1)),
            torch.where(h1, hit_gs, torch.where(resp_found, resp_gs, -1)),
            torch.where(h1, 0, torch.where(h2, 1, torch.where(fndF, 2, 3))
                        ).to(_i32),
            torch.where(fndF, mwts, 0), torch.where(fndF, mrts, 0),
            b2i(fndF)])                               # RES_FIELDS order
        out = torch.where(act[None, :], vals, out)
        return out, th1, resp_found, th2, fndF

    def pass_(af, ops, masks, rep, node, rd, wr):
        dev = af.g.device
        ops_t = to_device(np.asarray(ops, np.int32), dev)
        masks_t = to_device(np.asarray(masks, bool), dev)
        kids, s1, s2, shard = ops_t[0], ops_t[1], ops_t[2], ops_t[3]
        M = kids.shape[0]
        out = torch.zeros((len(RES_FIELDS), M), dtype=_i32, device=dev)
        z = lambda: torch.zeros((M,), dtype=_i32, device=dev)
        fT1, fF1, fT2, fF2 = z(), z(), z(), z()
        t0_rp = af.rp_tick[rep].clone()
        t0_sh = af.sh_tick[node].clone()
        for r in _rounds(masks):
            out, th1, rf, th2, ff = round_body(af, out, masks_t[r], kids, s1,
                                               s2, shard, rep, node, rd)
            fT1 += b2i(th1)
            fF1 += b2i(rf)
            fT2 += b2i(th2)
            fF2 += b2i(ff)

        # ---- exact-LRU remap: every provisional tick is t0 + (execution
        # rank of its event); the LUT sends it to t0 + (op-order rank)
        mi = masks_t.to(_i32)
        rnd = torch.argmax(mi, 0)                # round of each lane
        lane2 = torch.repeat_interleave(rnd, 2)
        pos2 = torch.arange(2 * M, device=dev)

        def remap(row, f_touch, f_fill, t0):
            fl = torch.stack([f_touch, f_fill], 1).reshape(-1)       # [2M]
            exact = torch.cumsum(fl, 0).to(_i32)   # op-order rank (1-based)
            per_round = (mi * (f_touch + f_fill)[None, :]).sum(1, dtype=_i32)
            base = (torch.cumsum(per_round, 0) - per_round).to(_i32)
            inround = torch.cumsum(torch.repeat_interleave(mi, 2, 1)
                                   * fl[None, :], 1).to(_i32)
            prov = base[lane2] + inround[lane2, pos2]
            idx = torch.where(fl > 0, prov, 2 * M + 1)
            lut = torch.zeros((2 * M + 2,), dtype=_i32, device=dev)
            lut.index_put_((idx.long(),), torch.where(fl > 0, t0 + exact, 0))
            d = row - t0                          # >0 iff written this pass
            return torch.where(d > 0, lut[torch.clamp(d, 0, 2 * M + 1).long()],
                               row)

        af.rp.lru[rep] = remap(af.rp.lru[rep], fT1, fF1, t0_rp)
        af.sh.lru[node] = remap(af.sh.lru[node], fT2, fF2, t0_sh)
        return af, out

    return pass_


def _tier_install(tier, gseq_a, idx, st, key, wts, rts, ver, gs, lru_v,
                  th, way, active, trash):
    """Vectorized install, IN PLACE: at ``(th, way)``, else the victim way;
    LRU values are the caller's prefix-sum ranks.  All active
    ``(idx, st)`` sets of a round are distinct."""
    vic = S.victim(tier.tag, tier.lru, idx, st)
    w0 = torch.where(th, way, vic)
    evicted = active & ~th & (tier.tag[idx, st, w0] != S.INVALID)
    w = torch.where(active, w0, trash)
    for a, v in ((tier.tag, key), (tier.wts, wts), (tier.rts, rts),
                 (tier.ver, ver), (tier.lru, lru_v), (gseq_a, gs)):
        old = a[idx, st, w]
        a.index_put_((idx, st, w), torch.where(active, v, old))
    return evicted


def _write_commit(af, dshard, dkey, dwl, rd, wr, dr):
    """One batched TSU write-through for a round's drains, IN PLACE
    (``state.tsu_commit_write_batch``); returns (mwts, mrts, dver, gs,
    evict, ovf)."""
    dwl_eff = torch.where(dwl >= 0, dwl, wr)
    (mwts, mrts, dver, gs, evict, ovf, _, _, _, _, _,
     gnext) = S.tsu_commit_write_batch(
        af.tsu, af.tsu_ver, af.tsu_gseq, af.tsu_seq, af.tsu_nseq,
        af.gseq_next, dshard, dkey, dwl_eff, rd, dr)
    af.gseq_next.copy_(gnext)
    return mwts, mrts, dver, gs, evict, ovf


def _drain_vals(dr, dkey, dver, mwts, mrts, gs):
    return torch.stack([b2i(dr), torch.where(dr, dkey, -1),
                        torch.where(dr, dver, -1), torch.where(dr, mwts, -1),
                        torch.where(dr, mrts, -1), torch.where(dr, gs, -1)])


def make_write_pass(W1: int, W2: int, KS: int, NN: int, NR: int, Q: int,
                    MAXIF: int):
    """Build the lane-static vectorized write pass for one fabric geometry
    (W1/W2 = tier trash-way indices, KS = TSU shard count, NN/NR =
    node/replica counts, Q = ring capacity, MAXIF = max in-flight writes).

    ``pass_(af, ops, sched, masks, rep, node, wl, rd, wr) -> (af, res)``:
    ``ops`` the host [4, M] op block, ``sched`` the host [7, M]
    ``WRITE_SCHED_FIELDS`` drain schedule from ``write_schedule``,
    ``masks`` the host [R, M] round matrix, rep/node/wl python ints, and
    ``res`` the [6, M] ``WRITE_RES_FIELDS`` block.  The ring update and
    the LRU tick ranks are lane-static and happen once, outside the
    rounds; each round runs the state-dependent math: ONE batched TSU
    commit, the clock chains as running maxima, the pending installs and
    then the drain installs."""

    def round_body(af, out, act, kids, s1, drain_l, dkey, drep, dwl,
                   dshard, ds1, ds2, lru_pend, lru_drain, lru_sh, rep,
                   node, rd, wr):
        M = kids.shape[0]
        dev = kids.device
        iota = torch.arange(M, device=dev)
        reps = torch.full((M,), rep, dtype=_i32, device=dev)
        nodes = torch.full((M,), node, dtype=_i32, device=dev)
        dr = act & drain_l

        mwts, mrts, dver, gs, evict, ovf = _write_commit(
            af, dshard, dkey, dwl, rd, wr, dr)

        # ---- clock chains: running maxima of the sequential recurrences
        cts0n = af.sh.cts[node].clone()
        run_mw = torch.cummax(torch.where(dr, mwts, _NEG), 0).values
        nwA = torch.maximum(cts0n, run_mw)
        nrA = torch.maximum(nwA + 1, mrts)
        onehot_d = (torch.arange(NR, dtype=_i32, device=dev)[:, None]
                    == drep[None, :]) & dr[None, :]
        runsA = torch.cummax(torch.where(onehot_d, nwA[None, :], _NEG),
                             1).values
        cts0r = af.rp.cts.clone()
        nwB = torch.maximum(cts0r[drep], runsA[drep, iota])
        nrB = torch.maximum(nwB + 1, nrA)
        exclA = torch.cat([torch.full((NR, 1), _NEG, dtype=_i32, device=dev),
                           runsA[:, :-1]], 1)
        pend_cts = torch.maximum(cts0r[rep], exclA[rep])

        # ---- pending installs (store-buffer lines: wts=rts=cts, ver=-1)
        # against the pre-round replica state, then the drain installs —
        # whose probes run AFTER the pending scatters
        negs = torch.full((M,), -1, dtype=_i32, device=dev)
        thP, wayP = S.probe(af.rp.tag, reps, s1, kids)
        evP = _tier_install(af.rp, af.rp_gseq, reps, s1, kids, pend_cts,
                            pend_cts, negs, negs, lru_pend, thP & act, wayP,
                            act, W1)
        thA, wayA = S.probe(af.sh.tag, nodes, ds2, dkey)
        ev1 = _tier_install(af.sh, af.sh_gseq, nodes, ds2, dkey, nwA, nrA,
                            dver, gs, lru_sh, thA & dr, wayA, dr, W2)
        thB, wayB = S.probe(af.rp.tag, drep, ds1, dkey)
        ev2 = _tier_install(af.rp, af.rp_gseq, drep, ds1, dkey, nwB, nrB,
                            dver, gs, lru_drain, thB & dr, wayB, dr, W1)

        # ---- counters: the op scan's per-write increments, summed
        Pn = _n(act)
        D = _n(dr)
        cross = dr & (dshard != node % KS)
        b12, b2m, big = S.link_bytes(Pn, D, _n(cross))
        counter_add(
            af.g, writes=Pn, l1_to_l2=Pn, l2_to_mm=D, write_throughs=D,
            pcie_blocks=_n(cross), tsu_evictions=_n(evict),
            overflow_reinits=_n(ovf),
            capacity_evictions=_n(evP) + _n(ev1) + _n(ev2),
            bytes_l1_l2=b12, bytes_l2_mm=b2m, bytes_inter_gpu=big)
        counter_add(af.r[rep], per_replica=True, writes=Pn, l1_to_l2=Pn,
                    capacity_evictions=_n(evP))
        af.r.index_put_((drep, torch.full_like(drep, RI["write_throughs"])),
                        b2i(dr), accumulate=True)
        af.r.index_put_((drep, torch.full_like(drep,
                                               RI["capacity_evictions"])),
                        b2i(ev2), accumulate=True)
        af.rp.cts.copy_(torch.maximum(cts0r, runsA[:, -1]))
        af.sh.cts[node] = torch.maximum(cts0n, run_mw[-1])

        vals = _drain_vals(dr, dkey, dver, mwts, mrts, gs)
        return torch.where(act[None, :], vals, out)

    def pass_(af, ops, sched, masks, rep, node, wl, rd, wr):
        dev = af.g.device
        masks = np.asarray(masks, bool)
        sched = np.asarray(sched, np.int32)
        ops_t = to_device(np.asarray(ops, np.int32), dev)
        sched_t = to_device(sched, dev)
        masks_t = to_device(masks, dev)
        kids, s1, s2, shard = ops_t[0], ops_t[1], ops_t[2], ops_t[3]
        drain_l = sched_t[0] != 0
        dkey = sched_t[1]
        drep = torch.clamp(sched_t[2], 0, NR - 1)
        dwl, dshard, ds1, ds2 = sched_t[3], sched_t[4], sched_t[5], sched_t[6]
        M = kids.shape[0]
        iota = torch.arange(M, device=dev)

        # ---- real ring update (lane-static, host-known lanes): a
        # keep-last scatter at op-order slots, head/len advanced once
        act_np = masks.any(axis=0)
        prank_np = np.cumsum(act_np).astype(np.int32)
        Pt = int(prank_np[-1])
        Dt = int((act_np & (sched[0] != 0)).sum())
        keep = np.nonzero(act_np & (prank_np + Q > Pt))[0]
        if keep.size:
            lanes_t = to_device(keep.astype(np.int64), dev)
            prank_t = to_device(prank_np[keep], dev)
            slot = ((af.wq_head[node] + af.wq_len[node] + prank_t - 1) % Q
                    ).long()
            rows = torch.full_like(slot, node)
            push_v = {"key": kids, "shard": shard, "set1": s1, "set2": s2}
            for f, a in af.wq.items():
                v = (push_v[f][lanes_t] if f in push_v else torch.full(
                    (keep.size,), rep if f == "rep" else wl, dtype=_i32,
                    device=dev))
                a.index_put_((rows, slot), v)

        # ---- LRU tick ranks (lane-static): prefix sums over per-replica
        # increments from the batch-start ticks
        act_any = masks_t.any(0)
        dr_any = act_any & drain_l
        ar = torch.arange(NR, dtype=_i32, device=dev)[:, None]
        onehot_d = (ar == drep[None, :]) & dr_any[None, :]
        inc = b2i(act_any)[None, :] * b2i(ar == rep) + b2i(onehot_d)
        c = torch.cumsum(inc, 1).to(_i32)
        tick0 = af.rp_tick.clone()
        lru_pend = tick0[rep] + c[rep] - b2i(dr_any & (drep == rep))
        lru_drain = tick0[drep] + c[drep, iota]
        lru_sh = af.sh_tick[node] + torch.cumsum(b2i(dr_any), 0).to(_i32)

        af.rp_tick.copy_(tick0 + c[:, -1])
        af.sh_tick[node] += Dt
        af.wq_head[node] = (af.wq_head[node] + Dt) % Q
        af.wq_len[node] += Pt - Dt

        out = torch.zeros((len(WRITE_RES_FIELDS), M), dtype=_i32, device=dev)
        for r in _rounds(masks):
            out = round_body(af, out, masks_t[r], kids, s1, drain_l, dkey,
                             drep, dwl, dshard, ds1, ds2, lru_pend,
                             lru_drain, lru_sh, rep, node, rd, wr)
        return af, out

    return pass_


def make_fence_pass(W1: int, W2: int, KS: int, NN: int, NR: int, Q: int):
    """Build the vectorized fence pass: drain EVERY node's posted-write
    queue (node order, FIFO within a node) over conflict-free rounds, then
    jump every client clock to the global maximum.

    ``pass_(af, sched, masks, rd, wr) -> (af, res, gmax)``: ``sched`` the
    host [8, D] ``FENCE_SCHED_FIELDS`` block from ``fence_schedule``
    (padded lanes have ``ent == 0``), ``masks`` the host [R, D] round
    matrix, ``res`` the [6, D] ``WRITE_RES_FIELDS`` block and ``gmax`` a
    0-d tensor."""

    def round_body(af, out, act, ent_l, dkey, drep, dwl, dshard, ds1, ds2,
                   dnode, lru_rp, lru_sh, rd, wr):
        D = dkey.shape[0]
        dev = dkey.device
        iota = torch.arange(D, device=dev)
        dr = act & ent_l

        mwts, mrts, dver, gs, evict, ovf = _write_commit(
            af, dshard, dkey, dwl, rd, wr, dr)

        # ---- clock chains, per node and per replica (lane = drain order)
        onehot_n = (torch.arange(NN, dtype=_i32, device=dev)[:, None]
                    == dnode[None, :]) & dr[None, :]
        runsN = torch.cummax(torch.where(onehot_n, mwts[None, :], _NEG),
                             1).values
        sh_cts0 = af.sh.cts.clone()
        rp_cts0 = af.rp.cts.clone()
        nwA = torch.maximum(sh_cts0[dnode], runsN[dnode, iota])
        nrA = torch.maximum(nwA + 1, mrts)
        onehot_d = (torch.arange(NR, dtype=_i32, device=dev)[:, None]
                    == drep[None, :]) & dr[None, :]
        runsA = torch.cummax(torch.where(onehot_d, nwA[None, :], _NEG),
                             1).values
        nwB = torch.maximum(rp_cts0[drep], runsA[drep, iota])
        nrB = torch.maximum(nwB + 1, nrA)

        # ---- installs: shared tier at the drained node, then the drained
        # replica's tier
        thA, wayA = S.probe(af.sh.tag, dnode, ds2, dkey)
        ev1 = _tier_install(af.sh, af.sh_gseq, dnode, ds2, dkey, nwA, nrA,
                            dver, gs, lru_sh, thA & dr, wayA, dr, W2)
        thB, wayB = S.probe(af.rp.tag, drep, ds1, dkey)
        ev2 = _tier_install(af.rp, af.rp_gseq, drep, ds1, dkey, nwB, nrB,
                            dver, gs, lru_rp, thB & dr, wayB, dr, W1)

        # ---- counters: the op scan's per-drain increments, summed
        Dn = _n(dr)
        cross = dr & (dshard != dnode % KS)
        _, b2m, big = S.link_bytes(0, Dn, _n(cross))
        counter_add(
            af.g, l2_to_mm=Dn, write_throughs=Dn, pcie_blocks=_n(cross),
            tsu_evictions=_n(evict), overflow_reinits=_n(ovf),
            capacity_evictions=_n(ev1) + _n(ev2), bytes_l2_mm=b2m,
            bytes_inter_gpu=big)
        af.r.index_put_((drep, torch.full_like(drep, RI["write_throughs"])),
                        b2i(dr), accumulate=True)
        af.r.index_put_((drep, torch.full_like(drep,
                                               RI["capacity_evictions"])),
                        b2i(ev2), accumulate=True)
        af.rp.cts.copy_(torch.maximum(rp_cts0, runsA[:, -1]))
        af.sh.cts.copy_(torch.maximum(sh_cts0, runsN[:, -1]))

        vals = _drain_vals(dr, dkey, dver, mwts, mrts, gs)
        return torch.where(act[None, :], vals, out)

    def pass_(af, sched, masks, rd, wr):
        dev = af.g.device
        masks = np.asarray(masks, bool)
        sched_t = to_device(np.asarray(sched, np.int32), dev)
        masks_t = to_device(masks, dev)
        ent_l = sched_t[0] != 0
        dkey = sched_t[1]
        drep = torch.clamp(sched_t[2], 0, NR - 1)
        dwl, dshard, ds1, ds2 = sched_t[3], sched_t[4], sched_t[5], sched_t[6]
        dnode = torch.clamp(sched_t[7], 0, NN - 1)
        D = dkey.shape[0]
        iota = torch.arange(D, device=dev)

        # ---- lane-static bookkeeping: LRU ranks from the batch-start
        # ticks, tick/ring advances applied once
        onehot_d = (torch.arange(NR, dtype=_i32, device=dev)[:, None]
                    == drep[None, :]) & ent_l[None, :]
        onehot_n = (torch.arange(NN, dtype=_i32, device=dev)[:, None]
                    == dnode[None, :]) & ent_l[None, :]
        cr = torch.cumsum(b2i(onehot_d), 1).to(_i32)
        cn = torch.cumsum(b2i(onehot_n), 1).to(_i32)
        lru_rp = af.rp_tick[drep] + cr[drep, iota]
        lru_sh = af.sh_tick[dnode] + cn[dnode, iota]
        cnt_n = cn[:, -1]
        af.rp_tick.add_(cr[:, -1])
        af.sh_tick.add_(cnt_n)
        af.wq_head.copy_((af.wq_head + cnt_n) % Q)
        af.wq_len.sub_(cnt_n)
        af.g[GI["fences"]] += 1

        out = torch.zeros((len(WRITE_RES_FIELDS), D), dtype=_i32, device=dev)
        for r in _rounds(masks):
            out = round_body(af, out, masks_t[r], ent_l, dkey, drep, dwl,
                             dshard, ds1, ds2, dnode, lru_rp, lru_sh, rd, wr)

        # ---- barrier: every client clock jumps to the global max
        gmax = torch.maximum(af.rp.cts.max(), af.sh.cts.max())
        af.rp.cts.copy_(gmax.expand_as(af.rp.cts))
        af.sh.cts.copy_(gmax.expand_as(af.sh.cts))
        return af, out, gmax

    return pass_
