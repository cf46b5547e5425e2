"""Array-native coherence state layer on torch: the ONE implementation of
the hierarchy transition rules in the port.

The counterpart of ``repro.core.state``: the same ``TierState`` /
``TSUState`` layout (``[N, S, W+1]`` int32 arrays with a trailing trash
way as the target of masked scatters, ``INVALID = -1`` for an empty way),
the same probe / victim / TSU-grant / commit rules, and the same packed
result-record contract, so state dumps compare array for array.

One difference in idiom: the reference's ``.at[].set`` returns new arrays,
while the port updates the state tensors IN PLACE with ``index_put_``.
Functions that commit (``tsu_commit_*``, ``tsu_lease_batch``,
``tsu_commit_write_batch``) say so, read every old value they need before
their first write, and return the (same, mutated) tensors so call sites
read like the reference's.  Inactive lanes are routed to the trash way
and write back that slot's own value, so duplicate trash indices only
ever carry equal values.

All timestamp arithmetic is ``repro_torch.core.protocol``; the fused
probe+install and write-grant math goes through ``kernels.ops`` (the CUDA
kernels on the card, their plain versions on the CPU).
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from repro_torch.core import protocol
from repro_torch.kernels import ops as K

INVALID = -1
_i32 = torch.int32

# ------------------------------------------------------- link traffic (Fig 10)
BLOCK_BYTES = 64        # one cache block / KV line on any data link
CTRL_BYTES = 8          # one invalidation / control message (HMG only)


def link_bytes(l1_l2_msgs, l2_mm_msgs, inter_gpu_blocks, inval_msgs=0):
    """Per-link byte counters (L1<->L2, L2<->MM, inter-GPU); python ints or
    tensors alike."""
    return (l1_l2_msgs * BLOCK_BYTES,
            l2_mm_msgs * BLOCK_BYTES,
            inter_gpu_blocks * BLOCK_BYTES + inval_msgs * CTRL_BYTES)


# ------------------------------------------------------ per-op result block
RES_FIELDS = ("found", "version", "gseq", "level", "wts", "rts", "mm_used")


def b2i(b):
    return b.to(_i32)


def first_index(eq):
    """Index of the first True along the last dim (0 for an all-false row)
    — the reference's ``argmax`` convention, as int32."""
    return torch.argmax(eq.to(_i32), -1).to(_i32)


def lanes(x, like):
    """``x`` (python int or tensor) as a contiguous int32 vector shaped
    like ``like`` on its device."""
    if isinstance(x, torch.Tensor):
        return x.to(_i32).expand(like.shape).contiguous()
    return torch.full(like.shape, x, dtype=_i32, device=like.device)


# ----------------------------------------------------------------- states
class TierState(NamedTuple):
    """One set-associative lease tier: ``[N, S, W+1]`` arrays (N caches x S
    sets x W ways + 1 trash way); ``cts`` is the per-cache clock ``[N]``."""

    tag: torch.Tensor     # int32, INVALID = empty
    wts: torch.Tensor
    rts: torch.Tensor
    ver: torch.Tensor     # data version carried by the line
    lru: torch.Tensor     # victim score (higher = more recently used)
    cts: torch.Tensor     # [N] logical clocks

    @property
    def n_ways(self) -> int:
        return self.tag.shape[-1] - 1


class TSUState(NamedTuple):
    """Timestamp-storage-unit rows: ``[H, S, W+1]`` tag + memts."""

    tag: torch.Tensor
    memts: torch.Tensor

    @property
    def n_ways(self) -> int:
        return self.tag.shape[-1] - 1


def init_tier(n: int, sets: int, ways: int, device) -> TierState:
    shp = (n, sets, ways + 1)
    z = lambda: torch.zeros(shp, dtype=_i32, device=device)
    return TierState(tag=torch.full(shp, INVALID, dtype=_i32, device=device),
                     wts=z(), rts=z(), ver=z(), lru=z(),
                     cts=torch.zeros((n,), dtype=_i32, device=device))


def init_tsu(h: int, sets: int, ways: int, device) -> TSUState:
    shp = (h, sets, ways + 1)
    return TSUState(tag=torch.full(shp, INVALID, dtype=_i32, device=device),
                    memts=torch.zeros(shp, dtype=_i32, device=device))


# ----------------------------------------------------------------- probes
def probe(tag_arr, idx, set_idx, addr):
    """Tag-only probe over the live ways of each request's set.  Returns
    (tag_hit, way) — ``way`` is the FIRST matching way."""
    rows = tag_arr[idx, set_idx][..., :-1]
    eq = rows == addr[..., None]
    return eq.any(-1), first_index(eq)


def victim(tag_arr, score_arr, idx, set_idx):
    """Victim way: invalid ways first, else the minimum score; ties break to
    the FIRST such way."""
    rows_t = tag_arr[idx, set_idx][..., :-1]
    rows_s = score_arr[idx, set_idx][..., :-1]
    score = torch.where(rows_t == INVALID, -2 ** 30, rows_s)
    return torch.argmin(score, -1).to(_i32)


def victim_lex(tag_arr, primary, secondary, idx, set_idx):
    """Lexicographic victim: invalid first, else min primary, ties broken by
    min secondary (the fabric TSU's dict-order rule)."""
    rows_t = tag_arr[idx, set_idx][..., :-1]
    rows_p = primary[idx, set_idx][..., :-1]
    rows_s = secondary[idx, set_idx][..., :-1]
    p = torch.where(rows_t == INVALID, -2 ** 30, rows_p)
    pmin = torch.amin(p, -1, keepdim=True)
    s = torch.where(p == pmin, rows_s, 2 ** 30)
    return torch.argmin(s, -1).to(_i32)


# ------------------------------------------------------------- TSU grant
class TSUGrant(NamedTuple):
    wts: torch.Tensor        # the [wts, rts] lease the TSU grants
    rts: torch.Tensor
    new_memts: torch.Tensor  # the clock the entry holds afterwards
    overflow: torch.Tensor   # bool: the 16-bit reinit fired


def tsu_lease(memts, is_write, rd_lease, wr_lease) -> TSUGrant:
    """The TSU decision (Algorithm 3) for a batch of requests against their
    entries' current clocks, with the 16-bit overflow reinit: a grant that
    would push ``memts`` past ``TS_MAX`` restarts the entry at 0 and is
    re-served as a first read (wts=0, rts=lease, memts'=rts).

    memts: [n]; is_write: [n] bool; rd_lease/wr_lease: ints or [n]."""
    rd = lanes(rd_lease, memts)
    wr = lanes(wr_lease, memts)
    r_lease, r_memts = protocol.mm_read(memts, rd)
    w_lease, w_memts = protocol.mm_write(memts, wr)
    wts = torch.where(is_write, w_lease.wts, r_lease.wts)
    rts = torch.where(is_write, w_lease.rts, r_lease.rts)
    new_memts = torch.where(is_write, w_memts, r_memts)
    ovf = new_memts > protocol.TS_MAX
    wts = torch.where(ovf, 0, wts)
    rts = torch.where(ovf, torch.where(is_write, wr, rd), rts)
    new_memts = torch.where(ovf, rts, new_memts)
    return TSUGrant(wts, rts, new_memts, ovf)


def flat_index(a, idx, set_idx, way):
    """Linear offsets of ``a[idx, set_idx, way]`` in a contiguous [H, S, W]."""
    _, S, W = a.shape
    return ((idx.long() * S + set_idx.long()) * W + way.long())


def last_lane(lin, n: int, scratch=None):
    """For each lane, the highest lane with the same flat target ``lin``
    (int64, each in ``[0, n)``): the lane whose value the reference's
    ``.at[].set`` keeps where targets repeat (XLA applies duplicate
    updates in lane order).  ``index_put_`` leaves that winner undefined
    on CUDA, so the port picks it the same way on both devices and writes
    every target from its winner alone.  ``scratch``: an int32 ``[n]``
    buffer of -1s, left as it was found (None allocates one)."""
    lanes_ = torch.arange(lin.shape[0], dtype=_i32, device=lin.device)
    own = scratch is None
    if own:
        scratch = torch.full((n,), -1, dtype=_i32, device=lin.device)
    win = scratch.scatter_reduce_(0, lin, lanes_, "amax")[lin]
    if not own:
        scratch.index_fill_(0, lin, -1)
    return win


def set_last(a, lin, value, win):
    """``a.view(-1)[lin] = value`` with the highest lane winning each
    repeated target (``win`` from ``last_lane``), IN PLACE: every lane
    writes its target's winning value, so repeats carry equal values."""
    a.view(-1).index_put_((lin,), value[win])


def tsu_commit_scatter(tsu: TSUState, idx, set_idx, way, addr, new_memts,
                       active, tag_hit, scratch=None) -> TSUState:
    """The simulator's TSU update, IN PLACE: same-round requests to one
    slot resolve by scatter-max (the largest extension wins; on an
    eviction-install the largest tag keeps the slot); the clear before it
    is a set, where the highest lane wins as in the reference.  Inactive
    requests go to the trash way.  ``scratch``: ``last_lane``'s."""
    tw = torch.where(active, way, tsu.n_ways)
    lin = flat_index(tsu.tag, idx, set_idx, tw)
    old = tsu.memts.view(-1)[lin]
    tsu.tag.view(-1).scatter_reduce_(
        0, lin, torch.where(active, addr, INVALID), "amax")
    cleared = torch.where(active & ~tag_hit, 0, old)
    set_last(tsu.memts, lin, torch.where(active, torch.clamp_min(cleared, 0),
                                         cleared),
             last_lane(lin, tsu.memts.numel(), scratch))
    tsu.memts.view(-1).scatter_reduce_(
        0, lin, torch.where(active, new_memts, 0), "amax")
    return tsu


def tsu_commit_exact(tsu: TSUState, idx, set_idx, way, addr, new_memts,
                     active) -> TSUState:
    """The fabric's TSU update, IN PLACE: each active slot is written
    exactly (the host dict's replace); inactive ops go to the trash way."""
    tw = torch.where(active, way, tsu.n_ways)
    old_tag = tsu.tag[idx, set_idx, tw]
    old_mem = tsu.memts[idx, set_idx, tw]
    tsu.tag.index_put_((idx, set_idx, tw), torch.where(active, addr, old_tag))
    tsu.memts.index_put_((idx, set_idx, tw),
                         torch.where(active, new_memts, old_mem))
    return tsu


# -------------------------------------------------- tier probe + install
def install_lease(cts, wts_resp, rts_resp):
    """Install math alone (Algorithms 1/2 + writer clock): returns
    (new_wts, new_rts, new_cts)."""
    lease = protocol.install(cts, wts_resp, rts_resp)
    return lease.wts, lease.rts, protocol.cts_after_write(cts, lease.wts)


def tier_probe(tier: TierState, idx, set_idx, addr, mwts=None, mrts=None):
    """Fused probe + install math for one tier, served by the lease-probe
    kernel reading the tier's tables in place (trash way sliced off: a
    view whose row stride the kernel takes) at each request's set: with
    ``idx`` a host int, that cache's ``[S, W]`` sets at rows ``set_idx`` and
    its one clock; with an ``[N]`` ``idx``, every cache's sets as one
    ``[I*S, W]`` table at rows ``idx*S + set_idx``.  ``mwts``/``mrts``
    None read as 0.  Returns (tag_hit, hit, way, row_rts, new_wts,
    new_rts, new_cts)."""
    if not isinstance(idx, torch.Tensor):
        idx = int(idx)
        return K.lease_probe(tier.tag[idx][:, :-1], tier.rts[idx][:, :-1],
                             tier.cts[idx:idx + 1], addr, mwts, mrts,
                             row=set_idx)
    flat = lambda a: a.view(-1, a.shape[-1])[:, :-1]
    return K.lease_probe(flat(tier.tag), flat(tier.rts), tier.cts[idx], addr,
                         mwts, mrts,
                         row=(idx * tier.tag.shape[1] + set_idx).to(_i32))


# ------------------------------------------------- packed contiguous buffers
TIER_FIELDS = ("tag", "wts", "rts", "ver", "lru")
TSU_FIELDS = ("tag", "memts", "ver", "gseq", "seq", "nseq")


def pack_tier(tier: TierState) -> torch.Tensor:
    """Per-tier arrays as ONE contiguous ``[5, N, S, W+1]`` buffer."""
    return torch.stack([tier.tag, tier.wts, tier.rts, tier.ver, tier.lru])


def unpack_tier(buf: torch.Tensor, cts: torch.Tensor) -> TierState:
    return TierState(tag=buf[0], wts=buf[1], rts=buf[2], ver=buf[3],
                     lru=buf[4], cts=cts)


def pack_tsu(tsu: TSUState, ver, gseq, seq, nseq) -> torch.Tensor:
    """The TSU tier plus its per-shard sequencers as ONE ``[6, H, S, W+1]``
    buffer; ``nseq`` ([H]) rides in field 5 at ``[:, 0, 0]``."""
    f5 = torch.zeros_like(tsu.tag)
    f5[:, 0, 0] = nseq
    return torch.stack([tsu.tag, tsu.memts, ver, gseq, seq, f5])


def unpack_tsu(buf: torch.Tensor) -> Tuple:
    """Inverse of ``pack_tsu``: (TSUState, ver, gseq, seq, nseq)."""
    return (TSUState(tag=buf[0], memts=buf[1]), buf[2], buf[3], buf[4],
            buf[5][:, 0, 0])


def tsu_commit_batch(tsu: TSUState, idx, set_idx, way, addr, new_memts,
                     active) -> TSUState:
    """Batched exact TSU commit, IN PLACE: one scatter for a batch of
    grants; no two ACTIVE requests may target the same slot."""
    return tsu_commit_exact(tsu, idx, set_idx, way, addr, new_memts, active)


def tsu_commit_write_batch(tsu: TSUState, ver_arr, gseq_arr, seq_arr, nseq,
                           gseq0, shard, key, wr_eff, rd_lease, active):
    """The batched write-side TSU transition: ONE probe + allocation +
    grant + commit for a batch of write-throughs (distinct active keys, at
    most one active write per shard).  Commits IN PLACE into ``tsu``,
    ``ver_arr``, ``gseq_arr``, ``seq_arr`` and ``nseq``; ``gseq0`` (a 0-d
    tensor) is left alone and the advanced counter is returned.

    Returns ``(wts, rts, ver, gs, evict, overflow, tsu, ver_arr, gseq_arr,
    seq_arr, nseq, new_gseq_next)`` as the reference does."""
    cap = tsu.n_ways
    zset = torch.zeros_like(shard)
    # fused probe + lex victim + mm_write grant (kernels.ops.write_grant)
    # over the shards' set-0 rows in place, each lane reading row `shard`
    th, w0, full, g_wts, g_rts, g_memts, g_ovf = K.write_grant(
        tsu.tag[:, 0, :-1], tsu.memts[:, 0, :-1], seq_arr[:, 0, :-1], key,
        lanes(wr_eff, key), shard)
    ai = b2i(active)
    evict = active & ~th & full
    ver = torch.where(th, ver_arr[shard, zset, w0] + 1, 1)
    seqv = torch.where(th, seq_arr[shard, zset, w0], nseq[shard])
    rank = (torch.cumsum(ai, 0) - ai).to(_i32)       # exclusive gseq rank
    gs = torch.where(active, gseq0 + rank, -1)
    w = torch.where(active, w0, cap)                  # trash-way routing
    olds = [a[shard, zset, w] for a in (ver_arr, gseq_arr, seq_arr)]
    tsu_commit_batch(tsu, shard, zset, w0, key, g_memts, active)
    for a, v, old in zip((ver_arr, gseq_arr, seq_arr), (ver, gs, seqv), olds):
        a.index_put_((shard, zset, w), torch.where(active, v, old))
    nseq.index_put_((torch.where(active, shard, 0),), b2i(active & ~th),
                    accumulate=True)
    gnext = gseq0 + torch.sum(ai).to(_i32)
    return (g_wts, g_rts, ver, gs, evict, active & g_ovf, tsu, ver_arr,
            gseq_arr, seq_arr, nseq, gnext)


def tsu_lease_batch(tsu: TSUState, ver_arr, gseq_arr, shard, key,
                    rd_lease, wr_lease, active):
    """The batched read-side TSU transition: ONE probe + grant + commit
    (IN PLACE into ``tsu``) for a batch of distinct active keys.  Returns
    (found, wts, rts, ver, gseq, overflow, tsu)."""
    zset = torch.zeros_like(shard)
    th, way = probe(tsu.tag, shard, zset, key)
    found = active & th
    memts = torch.where(th, tsu.memts[shard, zset, way], 0)
    gr = tsu_lease(memts, torch.zeros(key.shape, dtype=torch.bool,
                                      device=key.device), rd_lease, wr_lease)
    tsu_commit_batch(tsu, shard, zset, way, key, gr.new_memts, found)
    ver = torch.where(found, ver_arr[shard, zset, way], -1)
    gs = torch.where(found, gseq_arr[shard, zset, way], -1)
    return found, gr.wts, gr.rts, ver, gs, found & gr.overflow, tsu
