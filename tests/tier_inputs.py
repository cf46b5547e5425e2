"""Seeded inputs for the indexed forms of ``lease_probe`` and
``miss_round``: a tier's tables as the fabric holds them (every set row
with its trailing trash way, the TSU as ``[KT, 1, C+1]``) and lanes that
name their rows by index.  numpy only, so both the CPU tests (against the
Pallas kernels) and the card tests (no jax) build the same cases.
"""
import numpy as np

from repro_torch.core.protocol import TS_MAX


def probe_tables(K, N, W, seed, one_clock=False):
    """A tier's ``[K, W+1]`` tag and rts tables and N lanes: every third
    row holds a duplicated tag, every fifth is empty, about half the
    lanes hit their row (lane 0 the duplicate), clocks within a lease of
    ``TS_MAX``.  Returns ``(tag, rts), row, cts, addr, mwts, mrts``; cts
    is one clock for every lane when ``one_clock``."""
    rng = np.random.default_rng(seed)
    tag = rng.integers(-1, 4 * W, (K, W + 1)).astype(np.int32)
    tag[::3, min(1, W - 1)] = tag[::3, 0]              # duplicate tags
    tag[1::5] = -1                                     # empty set rows
    rts = rng.integers(TS_MAX - 35, TS_MAX, (K, W + 1)).astype(np.int32)
    row = rng.integers(0, K, N).astype(np.int32)
    row[0] = 0
    addr = rng.integers(0, 4 * W, N).astype(np.int32)
    hit = rng.random(N) < 0.5
    way = rng.integers(0, W, N)
    addr[hit] = tag[row[hit], way[hit]]
    addr[0] = tag[0, 0]
    addr[addr == -1] = 4 * W                           # never an empty way
    cts = rng.integers(TS_MAX - 35, TS_MAX, 1 if one_clock else N
                       ).astype(np.int32)
    mwts = rng.integers(TS_MAX - 15, TS_MAX, N).astype(np.int32)
    mrts = (mwts + rng.integers(1, 9, N)).astype(np.int32)
    return (tag, rts), row, cts, addr, mwts, mrts


def miss_tables(K1, K2, KT, N, W1, W2, C, seed, match_at=None):
    """The miss pass's view of one round: a replica's ``[K1, W1+1]`` tag
    and rts sets, a node's ``[K2, W2+1]`` tag, rts and wts sets, the
    TSU's ``[KT, 1, C+1]`` tag and memts, and N lanes naming their rows
    ``(s1, s2, shard)``.  Lanes share TSU rows; a quarter are inactive and
    name shard 0, as the pass pads; TSU row 1 (when KT > 2) is empty, row
    0 holds duplicated tags; about half the lanes find their key in the
    TSU, at way ``match_at`` and nowhere else when given (else anywhere,
    lane 0 at row 0's first duplicate), some also in
    their replica or shared set; TSU clocks within ``rd`` of ``TS_MAX``.
    Returns ``tables, rows, (cts1, cts2, addr, act), rd`` with cts1 and
    cts2 one clock each and act bool."""
    rng = np.random.default_rng(seed)
    r = lambda lo, hi, shp: rng.integers(lo, hi, shp).astype(np.int32)
    rp_tag, sh_tag = r(-1, 8 * C, (K1, W1 + 1)), r(-1, 8 * C, (K2, W2 + 1))
    ts_tag = r(0, 8 * C, (KT, 1, C + 1))
    ts_tag[:, 0, 3::7] = -1                            # partly full rows
    ts_tag[0, 0, 1:C:2] = ts_tag[0, 0, 0:C - 1:2]      # duplicate tags
    if KT > 2:
        ts_tag[1] = -1                                 # an empty row
    ts_mem = r(TS_MAX - 12, TS_MAX + 1, (KT, 1, C + 1))
    s1, s2 = r(0, K1, N), r(0, K2, N)
    shard = r(0, KT, N)
    act = rng.random(N) < 0.75
    act[0] = True
    shard[~act] = 0
    shard[0] = 0
    addr = r(0, 8 * C, N)
    hit = (rng.random(N) < 0.5) & ((shard != 1) | (KT <= 2))
    way = (np.full(N, match_at) if match_at is not None
           else rng.integers(0, C, N))
    if match_at is not None:        # no tag equals an address elsewhere
        ts_tag[ts_tag >= 0] += 8 * C
    ts_tag[shard[hit], 0, way[hit]] = addr[hit]
    if match_at is None:
        addr[0] = ts_tag[0, 0, 0]                      # the duplicated tag
    for tag, s, W in ((rp_tag, s1, W1), (sh_tag, s2, W2)):
        put = rng.random(N) < 0.3
        tag[s[put], rng.integers(0, W, N)[put]] = addr[put]
    tables = [rp_tag, r(TS_MAX - 20, TS_MAX, (K1, W1 + 1)), sh_tag,
              r(TS_MAX - 20, TS_MAX, (K2, W2 + 1)),
              r(TS_MAX - 30, TS_MAX - 20, (K2, W2 + 1)), ts_tag, ts_mem]
    vecs = (r(TS_MAX - 20, TS_MAX, 1), r(TS_MAX - 20, TS_MAX, 1), addr, act)
    return tables, (s1, s2, shard), vecs, 8


def gathered(tables, rows, vecs, rd):
    """``miss_tables``' case in the reference's gathered form: each lane's
    rows copied out (trash way sliced off), cts broadcast, act int32, rd a
    vector — the arguments of the Pallas kernel and the gathered wrapper."""
    s1, s2, shard = rows
    cts1, cts2, addr, act = vecs
    N = len(addr)
    g = [t[s][:, :-1] for t, s in zip(tables[:5], (s1, s1, s2, s2, s2))]
    g += [t[shard, 0, :-1] for t in tables[5:]]
    return [np.ascontiguousarray(a) for a in g] + [
        np.full(N, cts1[0], np.int32), np.full(N, cts2[0], np.int32), addr,
        act.astype(np.int32), np.full(N, rd, np.int32)]
