"""The port's protocol rules and state layer against ``repro.core``.

``repro_torch.core.protocol`` and ``repro_torch.core.state`` are held to
``repro.core.protocol`` / ``repro.core.state`` on the same seeded inputs,
exactly (int32 lattice math).  The state layer commits in place where the
reference returns new arrays, so every commit is compared on the resulting
state.  The paper's Fig-5 walkthroughs (``tests/test_protocol_litmus.py``)
are checked at the protocol level and as fabric op traces against the
host-object oracle.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.coherence.fabric import FabricConfig as RConfig
from repro.coherence.fabric import HostFabric
from repro.core import protocol as RP
from repro.core import state as RS
from repro_torch.coherence.fabric import ArrayFabric, FabricConfig, Op
from repro_torch.core import protocol as TP
from repro_torch.core import state as TS


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _eq(got, want, msg=""):
    g = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_array_equal(g, np.asarray(want), err_msg=msg)


# --------------------------------------------------------------- protocol
_RULES = ["mm_read", "mm_write", "install", "cts_after_write", "valid",
          "overflow_reinit"]


@pytest.mark.parametrize("fn", _RULES)
def test_protocol_rule_matches_reference(fn):
    rng = np.random.default_rng(_RULES.index(fn))
    a, b, c = (rng.integers(0, TP.TS_MAX + 40, 256).astype(np.int32)
               for _ in range(3))
    nargs = {"mm_read": 2, "mm_write": 2, "install": 3,
             "cts_after_write": 2, "valid": 2, "overflow_reinit": 1}[fn]
    got = getattr(TP, fn)(*map(_t, (a, b, c)[:nargs]))
    want = getattr(RP, fn)(*map(jnp.asarray, (a, b, c)[:nargs]))
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for g, w in zip(got, want):
        g = g if isinstance(g, tuple) else (g,)
        w = w if isinstance(w, tuple) else (w,)
        for gg, ww in zip(g, w):
            _eq(gg, ww, fn)
    assert TP.TS_MAX == RP.TS_MAX == 65535


def test_fig5_walkthrough_leases():
    """The lease arithmetic of the paper's Fig. 5 (protocol docstring):
    first read [0, RdLease]; writes at memts 7 and 10 with WrLease 5 get
    [8, 12] and [11, 15]; an install never moves a lease backwards."""
    for P, A in ((TP, _t), (RP, jnp.asarray)):
        lease, memts = P.mm_read(A(np.array([0], np.int32)), 10)
        _eq(lease.wts, [0])
        _eq(lease.rts, [10])
        _eq(memts, [10])
        lease, memts = P.mm_write(A(np.array([7, 10], np.int32)), 5)
        _eq(lease.wts, [8, 11])
        _eq(lease.rts, [12, 15])
        inst = P.install(A(np.array([11, 3], np.int32)),
                         A(np.array([8, 8], np.int32)),
                         A(np.array([12, 12], np.int32)))
        _eq(inst.wts, [11, 8])
        _eq(inst.rts, [12, 12])
        _eq(P.valid(A(np.array([12, 13], np.int32)),
                    A(np.array([12, 12], np.int32))), [True, False])


# Fig-5 litmus orders as fabric op traces (max_in_flight=0: every write
# goes through at once, as the simulator's write-through does)
LITMUS = dict(n_shards=1, rd_lease=10, wr_lease=5, tsu_capacity=8,
              shared_sets=4, shared_ways=2, replica_sets=4, replica_ways=2,
              max_in_flight=0)


def _litmus_ops(case):
    X, Y = "X", "Y"
    pub = [Op("publish", X, "X0"), Op("publish", Y, "Y0")]
    if case == "fig5a_intra":       # CU0/CU1 of one GPU: replicas 0, 1
        body = [Op("read", X, replica=0), Op("read", Y, replica=1),
                Op("write", Y, "Y1", replica=0), Op("read", X, replica=0),
                Op("write", X, "X1", replica=1), Op("read", Y, replica=1)]
    elif case == "fig5b_inter":     # CU0 of GPU0 vs CU0 of GPU1
        body = [Op("read", X, replica=0), Op("read", Y, replica=2),
                Op("write", Y, "Y1", replica=0), Op("read", X, replica=0),
                Op("write", X, "X1", replica=2), Op("read", Y, replica=2)]
    else:                           # write -> fence -> read is coherent
        body = ([Op("read", X, replica=r) for r in range(4)]
                + [Op("write", X, "X1", replica=0), Op("fence")]
                + [Op("read", X, replica=r) for r in range(4)])
    return pub + body


@pytest.mark.parametrize("case", ["fig5a_intra", "fig5b_inter",
                                  "write_fence_read"])
def test_fig5_litmus_traces_match_host_oracle(case):
    host = HostFabric(RConfig(**LITMUS), n_nodes=2, replicas_per_node=2)
    port = ArrayFabric(FabricConfig(**LITMUS), n_nodes=2,
                       replicas_per_node=2, device="cpu")
    ops = _litmus_ops(case)
    hres = [r for _, r in host.apply(ops)]
    pres = [r for _, r in port.apply(ops)]
    assert pres == hres
    assert list(port.grant_log) == list(host.grant_log)
    assert port.stats() == host.stats()
    assert port.stats()["inval_msgs"] == 0
    if case == "write_fence_read":
        # the DRF guarantee: every post-fence read observes the write
        assert [r[0] for r in pres[-4:]] == ["X1"] * 4
    else:
        # read in the past: the reader's own replica still serves X0/Y0
        # under a live lease after the other replica's write
        assert pres[5] == ("X0", 1)


# ------------------------------------------------------------ state rules
def _tier_arrays(rng, n, sets, ways):
    tag = rng.integers(-1, 6, (n, sets, ways + 1)).astype(np.int32)
    score = rng.integers(0, 9, (n, sets, ways + 1)).astype(np.int32)
    sec = rng.integers(0, 9, (n, sets, ways + 1)).astype(np.int32)
    return tag, score, sec


@pytest.mark.parametrize("seed", [0, 1])
def test_probe_and_victims_match_reference(seed):
    rng = np.random.default_rng(seed)
    tag, score, sec = _tier_arrays(rng, 3, 5, 4)
    idx = rng.integers(0, 3, 40).astype(np.int32)
    st = rng.integers(0, 5, 40).astype(np.int32)
    addr = rng.integers(0, 6, 40).astype(np.int32)
    th, way = TS.probe(_t(tag), _t(idx), _t(st), _t(addr))
    rth, rway = RS.probe(jnp.asarray(tag), idx, st, jnp.asarray(addr))
    _eq(th, rth)
    _eq(way, rway)
    _eq(TS.victim(_t(tag), _t(score), _t(idx), _t(st)),
        RS.victim(jnp.asarray(tag), jnp.asarray(score), idx, st))
    _eq(TS.victim_lex(_t(tag), _t(score), _t(sec), _t(idx), _t(st)),
        RS.victim_lex(jnp.asarray(tag), jnp.asarray(score),
                      jnp.asarray(sec), idx, st))


@pytest.mark.parametrize("seed", [0, 1])
def test_tsu_lease_and_install_match_reference(seed):
    rng = np.random.default_rng(seed)
    memts = rng.integers(TP.TS_MAX - 30, TP.TS_MAX + 1, 64).astype(np.int32)
    memts[::3] = rng.integers(0, 100, len(memts[::3]))
    is_w = rng.random(64) < 0.5
    gr = TS.tsu_lease(_t(memts), _t(is_w), 8, 20)
    rgr = RS.tsu_lease(jnp.asarray(memts), jnp.asarray(is_w), 8, 20)
    for g, w in zip(gr, rgr):
        _eq(g, w)
    assert bool(gr.overflow.any()) and not bool(gr.overflow.all())
    cts, w, r = (rng.integers(0, 100, 64).astype(np.int32) for _ in range(3))
    for g, ww in zip(TS.install_lease(_t(cts), _t(w), _t(r)),
                     RS.install_lease(jnp.asarray(cts), jnp.asarray(w),
                                      jnp.asarray(r))):
        _eq(g, ww)


@pytest.mark.parametrize("fn", ["exact", "scatter"])
def test_tsu_commits_match_reference(fn):
    rng = np.random.default_rng(5)
    H, S_, W = 2, 3, 4
    tag = rng.integers(-1, 9, (H, S_, W + 1)).astype(np.int32)
    mem = rng.integers(0, 50, (H, S_, W + 1)).astype(np.int32)
    n = 6                               # distinct active slots
    idx = np.array([0, 0, 1, 1, 0, 1], np.int32)
    st = np.array([0, 1, 2, 0, 2, 1], np.int32)
    way = np.array([0, 1, 2, 3, 1, 0], np.int32)
    addr = rng.integers(0, 9, n).astype(np.int32)
    nm = rng.integers(0, 80, n).astype(np.int32)
    act = np.array([1, 0, 1, 1, 0, 1], bool)
    th = np.array([1, 1, 0, 1, 0, 0], bool)
    tsu = TS.TSUState(_t(tag.copy()), _t(mem.copy()))
    rtsu = RS.TSUState(jnp.asarray(tag), jnp.asarray(mem))
    if fn == "exact":
        out = TS.tsu_commit_exact(tsu, _t(idx), _t(st), _t(way), _t(addr),
                                  _t(nm), _t(act))
        rout = RS.tsu_commit_exact(rtsu, idx, st, way, jnp.asarray(addr),
                                   jnp.asarray(nm), jnp.asarray(act))
    else:
        out = TS.tsu_commit_scatter(tsu, _t(idx), _t(st), _t(way), _t(addr),
                                    _t(nm), _t(act), _t(th))
        rout = RS.tsu_commit_scatter(rtsu, idx, st, way, jnp.asarray(addr),
                                     jnp.asarray(nm), jnp.asarray(act),
                                     jnp.asarray(th))
    assert out.tag is tsu.tag                  # committed in place
    _eq(out.tag, rout.tag)
    _eq(out.memts, rout.memts)


def _tsu_side(rng, KS, CAP):
    tag = rng.integers(0, 40, (KS, 1, CAP + 1)).astype(np.int32)
    tag[0, 0, :CAP] = np.arange(CAP)           # shard 0 full, keys 0..CAP-1
    tag[1, 0, 2:] = -1                         # shard 1 partly full
    tag[2, 0, :] = -1                          # shard 2 empty
    mem = rng.integers(TP.TS_MAX - 8, TP.TS_MAX, (KS, 1, CAP + 1)).astype(
        np.int32)
    mem[0, 0, 3] = mem[0, 0, 5] = 1            # victim ties on memts
    ver = rng.integers(1, 5, (KS, 1, CAP + 1)).astype(np.int32)
    gseq = rng.integers(0, 99, (KS, 1, CAP + 1)).astype(np.int32)
    seq = rng.integers(0, 9, (KS, 1, CAP + 1)).astype(np.int32)
    nseq = rng.integers(9, 12, KS).astype(np.int32)
    return tag, mem, ver, gseq, seq, nseq


def test_tsu_commit_write_batch_matches_reference():
    """The batched write-side transition (write_grant + allocation +
    eviction + version/gseq/seq commit) equals the reference's, outputs
    and every committed array, including reinits near TS_MAX."""
    rng = np.random.default_rng(11)
    KS, CAP = 4, 8
    arrs = _tsu_side(rng, KS, CAP)
    shard = np.array([0, 1, 2, 3], np.int32)    # one write per shard
    key = np.array([100, 1, 50, 7], np.int32)
    wl = np.array([4, 9, 20000, -1], np.int32)
    wl_eff = np.where(wl >= 0, wl, 4).astype(np.int32)
    act = np.array([True, True, True, False])
    tarr = [_t(a.copy()) for a in arrs]
    got = TS.tsu_commit_write_batch(
        TS.TSUState(tarr[0], tarr[1]), tarr[2], tarr[3], tarr[4], tarr[5],
        torch.tensor(17, dtype=torch.int32), _t(shard), _t(key),
        _t(wl_eff), 8, _t(act))
    ra = [jnp.asarray(a) for a in arrs]
    want = RS.tsu_commit_write_batch(
        RS.TSUState(ra[0], ra[1]), ra[2], ra[3], ra[4], ra[5],
        jnp.int32(17), jnp.asarray(shard), jnp.asarray(key),
        jnp.asarray(wl_eff), 8, jnp.asarray(act))
    for i in (0, 1, 2, 3, 4, 5, 11):
        _eq(got[i], want[i], f"output {i}")
    _eq(got[6].tag, want[6].tag)
    _eq(got[6].memts, want[6].memts)
    for i in (7, 8, 9, 10):
        _eq(got[i], want[i], f"array {i}")
    assert bool(got[4][0])                      # full shard 0 evicted


def test_tsu_lease_batch_matches_reference():
    rng = np.random.default_rng(12)
    KS, CAP = 4, 8
    tag, mem, ver, gseq, _, _ = _tsu_side(rng, KS, CAP)
    shard = np.array([0, 0, 1, 2, 3], np.int32)
    key = np.array([3, 77, int(tag[1, 0, 0]), 5, int(tag[3, 0, 4])],
                   np.int32)
    act = np.array([True, True, True, True, False])
    tsu = TS.TSUState(_t(tag.copy()), _t(mem.copy()))
    got = TS.tsu_lease_batch(tsu, _t(ver), _t(gseq), _t(shard), _t(key), 8,
                             4, _t(act))
    want = RS.tsu_lease_batch(RS.TSUState(jnp.asarray(tag),
                                          jnp.asarray(mem)),
                              jnp.asarray(ver), jnp.asarray(gseq),
                              jnp.asarray(shard), jnp.asarray(key), 8, 4,
                              jnp.asarray(act))
    for i in range(6):
        _eq(got[i], want[i], f"output {i}")
    _eq(got[6].tag, want[6].tag)
    _eq(got[6].memts, want[6].memts)


@pytest.mark.parametrize("idx", [0, 1, np.int64(1)])
def test_tier_probe_of_one_cache_matches_reference(idx):
    """``tier_probe`` with a host cache index reads that cache's sets in
    place at ``set_idx`` with its one clock, and no grant reads as 0: the
    reference's probe of the same rows with an index vector and zero
    grants."""
    rng = np.random.default_rng(int(idx) + 3)
    n, sets, ways, N = 2, 8, 4, 24
    arrs = [rng.integers(-1, 8, (n, sets, ways + 1)).astype(np.int32)
            for _ in range(5)]
    cts = rng.integers(0, 8, n).astype(np.int32)
    tier = TS.TierState(*map(_t, arrs), _t(cts))
    rtier = RS.TierState(*map(jnp.asarray, arrs), jnp.asarray(cts))
    st = rng.integers(0, sets, N).astype(np.int32)
    addr = rng.integers(0, 8, N).astype(np.int32)
    got = TS.tier_probe(tier, idx, _t(st), _t(addr))
    z = jnp.zeros(N, jnp.int32)
    want = RS.tier_probe(rtier, np.full(N, int(idx), np.int32), st,
                         jnp.asarray(addr), z, z)
    for g, w in zip(got, want):
        _eq(g, w)


def test_tier_probe_pack_and_link_bytes_match_reference():
    rng = np.random.default_rng(13)
    n, sets, ways = 2, 4, 3
    arrs = [rng.integers(-1, 8, (n, sets, ways + 1)).astype(np.int32)
            for _ in range(5)]
    cts = rng.integers(0, 8, n).astype(np.int32)
    tier = TS.TierState(*map(_t, arrs), _t(cts))
    rtier = RS.TierState(*map(jnp.asarray, arrs), jnp.asarray(cts))
    idx = rng.integers(0, n, 16).astype(np.int32)
    st = rng.integers(0, sets, 16).astype(np.int32)
    addr, mw, mr = (rng.integers(0, 8, 16).astype(np.int32)
                    for _ in range(3))
    got = TS.tier_probe(tier, _t(idx), _t(st), _t(addr), _t(mw), _t(mr))
    want = RS.tier_probe(rtier, idx, st, jnp.asarray(addr), jnp.asarray(mw),
                         jnp.asarray(mr))
    for g, w in zip(got, want):
        _eq(g, w)
    _eq(TS.pack_tier(tier), RS.pack_tier(rtier))
    tsu = TS.TSUState(_t(arrs[0]), _t(arrs[1]))
    packed = TS.pack_tsu(tsu, _t(arrs[2]), _t(arrs[3]), _t(arrs[4]),
                         _t(cts))
    _eq(packed, RS.pack_tsu(RS.TSUState(jnp.asarray(arrs[0]),
                                        jnp.asarray(arrs[1])),
                            *map(jnp.asarray, arrs[2:]), jnp.asarray(cts)))
    un = TS.unpack_tsu(packed)
    _eq(un[4], cts)
    assert TS.link_bytes(3, 2, 1, 4) == RS.link_bytes(3, 2, 1, 4)
    assert TS.RES_FIELDS == RS.RES_FIELDS and TS.INVALID == int(RS.INVALID)
