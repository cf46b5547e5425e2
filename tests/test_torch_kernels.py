"""The port's coherence kernels against the reference's Pallas kernels.

The plain PyTorch versions (``repro_torch.kernels.ref``) must equal
``repro``'s Pallas kernels run in interpret mode, output for output and
bit for bit (int32 lattice math: no tolerance), on the reference suite's
own inputs (``tests/test_kernels.py``).  The CUDA kernels are held to the
plain versions on the card in ``tests/test_torch_cuda.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import protocol as rprotocol
from repro.core import state as RS
from repro.kernels.lease_probe import lease_probe as pallas_lease_probe
from repro.kernels.tier_pass import miss_round as pallas_miss_round
from repro.kernels.tier_pass import write_grant as pallas_write_grant
from repro_torch.core import protocol as tprotocol
from repro_torch.core import state as TS
from repro_torch.kernels import ops, ref
from repro_torch.kernels.lease_probe import lease_probe as cuda_lease_probe
from repro_torch.kernels.tier_pass import miss_round as cuda_miss_round
from repro_torch.kernels.tier_pass import write_grant as cuda_write_grant

from test_kernels import _lease_probe_inputs, _miss_round_inputs
from tier_inputs import gathered, miss_tables, probe_tables


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _assert_outs_equal(got, want, names):
    assert len(got) == len(want)
    for g, w, name in zip(got, want, names):
        g = g.cpu().numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        w = w.cpu().numpy() if isinstance(w, torch.Tensor) else np.asarray(w)
        assert g.dtype == w.dtype, (name, g.dtype, w.dtype)
        np.testing.assert_array_equal(g, w, err_msg=name)


_PROBE_OUTS = ["tag_hit", "hit", "way", "row_rts", "nwts", "nrts", "ncts"]
_MISS_OUTS = ["th1", "h1", "way1", "th2", "h2", "way2", "fnd", "tway",
              "mwts", "mrts", "nmem", "ovf", "nwa", "nra", "nw1", "nr1"]
_GRANT_OUTS = ["th", "way", "full", "wts", "rts", "nmem", "ovf"]


def _write_grant_inputs(N, C, seed):
    rng = np.random.default_rng(seed)
    ts_tag = rng.integers(-1, 20, (N, C)).astype(np.int32)
    ts_tag[::7] = -1                          # all-invalid TSU rows
    ts_mem = rng.integers(0, 70000, (N, C)).astype(np.int32)
    ts_mem[1::5] = rng.integers(65530, 65536, (len(ts_mem[1::5]), C))
    ts_seq = rng.integers(0, 50, (N, C)).astype(np.int32)
    addr = rng.integers(0, 20, N).astype(np.int32)
    wl = rng.integers(1, 10, N).astype(np.int32)
    return ts_tag, ts_mem, ts_seq, addr, wl


def _indexed_grant_inputs(K, N, C, seed):
    """A write round's ``[K, C]`` TSU tables (the shards' set-0 rows) and
    the ``[N]`` row vector naming each lane's shard.  Lanes share the K
    rows; a third of the lanes, the inactive ones, name row 0 as the write
    pass gives them.  Row 1 is all empty, row 2 holds duplicate tags, row
    3 is full with its minimum memts tied on a third of the ways whose seq
    is 2^30 and above, row 4 is full; memts near TS_MAX tie elsewhere.
    Lane 1 misses in row 3, lane 2 misses in row 1, lane 4 hits row 2's
    duplicated tag; half the other lanes hit their row."""
    rng = np.random.default_rng(seed)
    tag = rng.integers(0, 4 * C, (K, C)).astype(np.int32)
    tag[:, 1::5] = -1                           # partly full rows
    tag[1] = -1                                 # an all-empty row
    tag[2, 1::2] = tag[2, 0:C - 1:2]            # duplicate tags
    tag[3] = np.arange(C) + 8 * C               # full, distinct
    tag[4] = np.arange(C) + 16 * C              # full, distinct
    mem = rng.integers(tprotocol.TS_MAX - 7, tprotocol.TS_MAX + 1,
                       (K, C)).astype(np.int32)  # ties, reinits
    seq = rng.integers(0, 64, (K, C)).astype(np.int32)
    mem[3] = 100
    mem[3, 2::3] = 50                           # tied minimum
    seq[3, 2::3] = 2 ** 30 + rng.integers(0, 3, len(seq[3, 2::3]))
    row = rng.integers(0, K, N).astype(np.int32)
    row[::3] = 0                                # inactive lanes
    row[1:5] = [3, 1, 0, 2]
    addr = rng.integers(0, 4 * C, N).astype(np.int32)
    hit = rng.random(N) < 0.5
    way = rng.integers(0, C, N)
    addr[hit] = tag[row[hit], way[hit]]
    addr[addr == -1] = 4 * C                    # an address is never -1
    addr[1:3] = 32 * C                          # misses
    addr[4] = tag[2, 0]
    wl = rng.integers(1, 10, N).astype(np.int32)
    return (tag, mem, seq), row, addr, wl


# ------------------------------------------------------------ lease_probe
@pytest.mark.parametrize("N,W", [(64, 4), (256, 16), (100, 8), (1, 2)])
def test_lease_probe_ref_matches_pallas(N, W):
    ins = _lease_probe_inputs(N, W)
    got = ref.lease_probe_ref(*map(_t, ins))
    want = pallas_lease_probe(*map(jnp.asarray, ins), interpret=True)
    _assert_outs_equal(got, want, _PROBE_OUTS)


def test_lease_probe_duplicate_tags_use_first_way():
    tag_rows = np.array([[7, 7, -1, -1], [7, -1, 7, -1], [3, 7, 7, 7]],
                        np.int32)
    rts_rows = np.array([[5, 20, 0, 0], [20, 0, 5, 0], [9, 2, 30, 40]],
                        np.int32)
    ins = (tag_rows, rts_rows, np.array([10, 10, 10], np.int32),
           np.array([7, 7, 7], np.int32), np.zeros(3, np.int32),
           np.full(3, 12, np.int32))
    got = ref.lease_probe_ref(*map(_t, ins))
    want = pallas_lease_probe(*map(jnp.asarray, ins), interpret=True)
    _assert_outs_equal(got, want, _PROBE_OUTS)
    np.testing.assert_array_equal(got[1].numpy(), [False, True, False])
    np.testing.assert_array_equal(got[2].numpy(), [0, 0, 1])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_lease_probe_matches_protocol(seed):
    """The plain version's install math is the port's protocol, which is
    the reference's protocol."""
    tag_rows, rts_rows, cts, addr, mwts, mrts = _lease_probe_inputs(192, 8,
                                                                    seed)
    _, _, _, _, nwts, nrts, ncts = ref.lease_probe_ref(
        *map(_t, (tag_rows, rts_rows, cts, addr, mwts, mrts)))
    lease = tprotocol.install(_t(cts), _t(mwts), _t(mrts))
    rlease = rprotocol.install(jnp.asarray(cts), jnp.asarray(mwts),
                               jnp.asarray(mrts))
    for a, b, c in ((nwts, lease.wts, rlease.wts), (nrts, lease.rts,
                                                   rlease.rts)):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
        np.testing.assert_array_equal(a.numpy(), np.asarray(c))
    np.testing.assert_array_equal(
        ncts.numpy(), np.asarray(rprotocol.cts_after_write(
            jnp.asarray(cts), rlease.wts)))


@pytest.mark.parametrize("K,N,W,one_clock,grant", [
    (16, 64, 8, True, False), (5, 1, 2, True, True), (64, 100, 4, False, True),
    (3, 40, 8, False, False)])
def test_lease_probe_ref_indexed_matches_pallas(K, N, W, one_clock, grant):
    """The indexed plain version (a tier's [K, W] tables read at ``row``,
    cts one clock or per lane, no grant read as 0) equals the Pallas
    kernel on the rows it indexes: duplicate tags, empty rows, lanes
    sharing rows, clocks near TS_MAX."""
    (tag, rts), row, cts, addr, mwts, mrts = probe_tables(K, N, W, K + N,
                                                          one_clock)
    if not grant:
        mwts = mrts = np.zeros(N, np.int32)
    got = ref.lease_probe_ref(_t(tag)[:, :-1], _t(rts)[:, :-1], _t(cts),
                              _t(addr), *((_t(mwts), _t(mrts)) if grant
                                          else ()), row=_t(row))
    want = pallas_lease_probe(
        jnp.asarray(tag[row, :-1]), jnp.asarray(rts[row, :-1]),
        jnp.asarray(np.broadcast_to(cts, (N,))), jnp.asarray(addr),
        jnp.asarray(mwts), jnp.asarray(mrts), interpret=True)
    _assert_outs_equal(got, want, _PROBE_OUTS)
    assert got[0][0] and got[2][0] == 0         # lane 0: the first duplicate


# ------------------------------------------------------------- miss_round
@pytest.mark.parametrize("N,W1,W2,C,seed", [
    (64, 4, 8, 16, 0), (256, 2, 4, 64, 1), (96, 8, 2, 8, 2)])
def test_miss_round_ref_matches_pallas(N, W1, W2, C, seed):
    ins = _miss_round_inputs(N, W1, W2, C, seed)
    got = ref.miss_round_ref(*map(_t, ins))
    want = pallas_miss_round(*map(jnp.asarray, ins), interpret=True)
    _assert_outs_equal(got, want, _MISS_OUTS)


def test_miss_round_near_ts_max_grants():
    """Entry clocks within rd of TS_MAX: the strict ``>`` reinit fires
    exactly where the reference's does."""
    N, C = 64, 8
    ins = list(_miss_round_inputs(N, 2, 2, C, 3))
    rng = np.random.default_rng(3)
    ins[5][:, 0] = ins[9]                       # every lane finds its entry
    ins[6][:] = rng.integers(tprotocol.TS_MAX - 12, tprotocol.TS_MAX + 1,
                             (N, C))
    ins[10][:] = 1                              # all lanes active
    got = ref.miss_round_ref(*map(_t, ins))
    want = pallas_miss_round(*map(jnp.asarray, ins), interpret=True)
    _assert_outs_equal(got, want, _MISS_OUTS)
    assert got[11].any() and not got[11].all()  # some, not all, reinit


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_miss_round_matches_state_rules(seed):
    """The grant equals ``state.tsu_lease`` and the two install levels
    equal chained ``state.install_lease`` calls, in both packages."""
    ins = _miss_round_inputs(128, 4, 4, 32, seed)
    (th1, h1, way1, th2, h2, way2, fnd, tway, mwts, mrts, nmem, ovf, nwa,
     nra, nw1, nr1) = ref.miss_round_ref(*map(_t, ins))
    addr, rd = _t(ins[9]), _t(ins[11])
    eqt = _t(ins[5]) == addr[:, None]
    memts = torch.where(eqt.any(-1), ref._first_match_ref(eqt, _t(ins[6])), 0)
    gr = TS.tsu_lease(memts, torch.zeros(memts.shape, dtype=torch.bool), rd,
                      rd)
    rgr = RS.tsu_lease(jnp.asarray(memts.numpy()),
                       jnp.zeros(memts.shape, bool), jnp.asarray(ins[11]),
                       jnp.asarray(ins[11]))
    for a, b, c in ((mwts, gr.wts, rgr.wts), (mrts, gr.rts, rgr.rts),
                    (nmem, gr.new_memts, rgr.new_memts)):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
        np.testing.assert_array_equal(a.numpy(), np.asarray(c))
    wA, rA, _ = TS.install_lease(_t(ins[8]), mwts, mrts)
    np.testing.assert_array_equal(nwa.numpy(), wA.numpy())
    np.testing.assert_array_equal(nra.numpy(), rA.numpy())
    eq2 = _t(ins[2]) == addr[:, None]
    w1, r1, _ = TS.install_lease(
        _t(ins[7]), torch.where(h2, ref._first_match_ref(eq2, _t(ins[4])), nwa),
        torch.where(h2, ref._first_match_ref(eq2, _t(ins[3])), nra))
    np.testing.assert_array_equal(nw1.numpy(), w1.numpy())
    np.testing.assert_array_equal(nr1.numpy(), r1.numpy())
    act = ins[10].astype(bool)
    assert not (h1 & ~th1).any() and not (h2 & ~th2).any()
    assert not (th1.numpy() & ~act).any()
    assert not (th2 & h1).any() and not (fnd & h2).any()


@pytest.mark.parametrize("KT,N,C,W1,W2", [
    (8, 32, 64, 8, 8), (8, 64, 1024, 8, 8), (4, 17, 20, 2, 4),
    (2, 64, 128, 4, 2)])
def test_miss_round_ref_indexed_matches_pallas(KT, N, C, W1, W2):
    """The indexed plain version (the tiers' tables in place, each lane's
    rows by index, one clock a tier, act bool, rd an int) equals the
    Pallas kernel on the rows it indexes: lanes sharing TSU rows, padded
    lanes on shard 0, duplicate tags, an empty TSU row, clocks within rd
    of TS_MAX."""
    tables, rows, vecs, rd = miss_tables(64, 128, KT, N, W1, W2, C, KT + N)
    views = [_t(t)[:, :-1] for t in tables[:5]] + \
        [_t(t)[:, 0, :-1] for t in tables[5:]]
    got = ref.miss_round_ref(*views, *map(_t, vecs), rd,
                             rows=tuple(map(_t, rows)))
    want = pallas_miss_round(*map(jnp.asarray, gathered(tables, rows, vecs,
                                                         rd)),
                             interpret=True)
    _assert_outs_equal(got, want, _MISS_OUTS)
    assert got[6].any() and got[11].any()       # grants, and a reinit


# ------------------------------------------------------------ write_grant
@pytest.mark.parametrize("N,C,seed", [(64, 16, 0), (256, 64, 1), (40, 8, 2)])
def test_write_grant_ref_matches_pallas(N, C, seed):
    ins = _write_grant_inputs(N, C, seed)
    got = ref.write_grant_ref(*map(_t, ins))
    want = pallas_write_grant(*map(jnp.asarray, ins), interpret=True)
    _assert_outs_equal(got, want, _GRANT_OUTS)
    # the victim rule is state.victim_lex on the miss lanes, both packages
    th, way = got[0].numpy(), got[1].numpy()
    pad = lambda a: np.concatenate([a[:, None, :], np.zeros((N, 1, 1),
                                                            np.int32)], -1)
    vic = TS.victim_lex(*(_t(pad(a)) for a in ins[:3]),
                        torch.arange(N), torch.zeros(N, dtype=torch.long))
    rvic = RS.victim_lex(*(jnp.asarray(pad(a)) for a in ins[:3]),
                         jnp.arange(N), jnp.zeros(N, jnp.int32))
    np.testing.assert_array_equal(way[~th], vic.numpy()[~th])
    np.testing.assert_array_equal(vic.numpy(), np.asarray(rvic))
    assert got[2].numpy()[::7].sum() == 0       # empty rows are not full


def test_write_grant_ref_past_16384_ways_matches_pallas():
    """A TSU row of C = 20000 ways, past the 16384 the CUDA kernel holds
    in registers (it walks such rows in tiles): the plain version equals
    the Pallas kernel with the matching way and the victim in the last
    tile.  Lanes 0::4 hit a tag at ways C - 3 and C - 1 (the first
    wins); lanes 1::4 miss a full row whose least memts is at C - 2;
    lanes 2::4 miss a row whose one empty way is C - 5; lanes 3::4 miss a
    full row whose least memts ties on ways 7 and C - 4 (seq 9 and 3)."""
    N, C = 8, 20000
    rng = np.random.default_rng(20000)
    tag = np.stack([rng.permutation(4 * C)[:C] for _ in range(N)]).astype(
        np.int32)
    mem = rng.integers(65515, 65535, (N, C)).astype(np.int32)
    seq = rng.integers(0, 64, (N, C)).astype(np.int32)
    addr = np.full(N, 4 * C + 1, np.int32)
    tag[0::4, C - 1] = addr[0::4] = tag[0::4, C - 3]
    mem[1::4, C - 2] = 65435
    tag[2::4, C - 5] = -1
    mem[3::4, 7] = mem[3::4, C - 4] = 65435
    seq[3::4, 7], seq[3::4, C - 4] = 9, 3
    ins = (tag, mem, seq, addr, rng.integers(1, 9, N).astype(np.int32))
    got = ref.write_grant_ref(*map(_t, ins))
    want = pallas_write_grant(*map(jnp.asarray, ins), interpret=True)
    _assert_outs_equal(got, want, _GRANT_OUTS)
    th, way, full = (g.numpy() for g in got[:3])
    assert th[0::4].all() and not th[1::4].any()
    np.testing.assert_array_equal(way, [C - 3, C - 2, C - 5, C - 4] * 2)
    assert full[1::4].all() and not full[2::4].any()


@pytest.mark.parametrize("K,N,C,seed", [(8, 16, 16, 0), (8, 64, 64, 1),
                                         (8, 64, 1024, 2), (8, 16, 8, 3)])
def test_write_grant_ref_indexed_matches_pallas(K, N, C, seed):
    """The indexed form (``[K, C]`` tables + each lane's row) equals the
    Pallas kernel on the gathered rows, as the reference passes them, and
    the plain version's own gathered form."""
    tables, row, addr, wl = _indexed_grant_inputs(K, N, C, seed)
    got = ref.write_grant_ref(*map(_t, tables), _t(addr), _t(wl), _t(row))
    rows = [a[row] for a in tables]
    want = pallas_write_grant(*map(jnp.asarray, rows), jnp.asarray(addr),
                              jnp.asarray(wl), interpret=True)
    _assert_outs_equal(got, want, _GRANT_OUTS)
    _assert_outs_equal(got, ref.write_grant_ref(*map(_t, rows), _t(addr),
                                                _t(wl)), _GRANT_OUTS)
    th, way, full = (g.numpy() for g in got[:3])
    # tied minimum with seq >= 2^30: the cap at 2^30 on the untied ways
    # wins, so the victim is way 0 (a packed (p, seq, index) key would
    # pick way 2)
    assert not th[1] and way[1] == 0
    # all empty: every way ties at -2^30, so the least seq picks
    assert not th[2] and not full[2] and way[2] == np.argmin(tables[2][1])
    assert th[4] and way[4] == 0                         # first duplicate
    assert full[1] and full[row == 4].all()


# ------------------------------------------------------------ dispatcher
def test_dispatcher_sends_cpu_tensors_to_plain_versions():
    ins = tuple(map(_t, _lease_probe_inputs(16, 4)))
    _assert_outs_equal(ops.lease_probe(*ins), ref.lease_probe_ref(*ins),
                       _PROBE_OUTS)
    mins = tuple(map(_t, _miss_round_inputs(16, 2, 2, 8)))
    _assert_outs_equal(ops.miss_round(*mins), ref.miss_round_ref(*mins),
                       _MISS_OUTS)
    gins = tuple(map(_t, _write_grant_inputs(16, 8, 0)))
    _assert_outs_equal(ops.write_grant(*gins), ref.write_grant_ref(*gins),
                       _GRANT_OUTS)


def test_dispatcher_sends_indexed_write_grant_to_plain_version():
    tables, row, addr, wl = _indexed_grant_inputs(8, 64, 32, 4)
    args = (*map(_t, tables), _t(addr), _t(wl))
    before = cuda_write_grant.launches
    _assert_outs_equal(ops.write_grant(*args, _t(row)),
                       ref.write_grant_ref(*args, row=_t(row)), _GRANT_OUTS)
    assert cuda_write_grant.launches == before


def test_dispatcher_sends_indexed_probe_and_miss_round_to_plain_versions():
    (tag, rts), row, cts, addr, _, _ = probe_tables(8, 16, 4, 0, True)
    args = (_t(tag)[:, :-1], _t(rts)[:, :-1], _t(cts), _t(addr))
    before = cuda_lease_probe.launches
    _assert_outs_equal(ops.lease_probe(*args, row=_t(row)),
                       ref.lease_probe_ref(*args, row=_t(row)), _PROBE_OUTS)
    assert cuda_lease_probe.launches == before
    tables, rows, vecs, rd = miss_tables(8, 8, 4, 16, 2, 2, 8, 0)
    margs = [_t(t)[:, :-1] for t in tables[:5]] + \
        [_t(t)[:, 0, :-1] for t in tables[5:]] + [*map(_t, vecs), rd]
    rows = tuple(map(_t, rows))
    before = cuda_miss_round.launches
    _assert_outs_equal(ops.miss_round(*margs, rows=rows),
                       ref.miss_round_ref(*margs, rows=rows), _MISS_OUTS)
    assert cuda_miss_round.launches == before


def _shares_storage(view, table):
    return view.untyped_storage().data_ptr() == \
        table.untyped_storage().data_ptr()


def test_miss_pass_and_fast_read_read_the_tier_tables_in_place(monkeypatch):
    """The miss pass hands ``miss_round`` the tiers' tables as views of
    the fabric's storage (``[K, W]`` and ``[KT, C]``, never a gathered
    ``[M, ...]`` row block) with each lane's rows as ``rows``; the fast
    read hands ``lease_probe`` the replica tier's tables in place with
    ``row``."""
    from repro_torch.coherence.fabric import ArrayFabric, FabricConfig
    from repro_torch.coherence.fabric import pipeline as PL
    cfg = FabricConfig(n_shards=4, rd_lease=8, wr_lease=4, tsu_capacity=16,
                       shared_sets=8, shared_ways=2, replica_sets=4,
                       replica_ways=2)
    fab = ArrayFabric(cfg, n_nodes=2, replicas_per_node=2, device="cpu")
    af = fab._af
    misses, probes = [], []
    miss, probe = PL.K.miss_round, TS.K.lease_probe

    def spy_miss(*args, **kw):
        misses.append((args, kw))
        return miss(*args, **kw)

    def spy_probe(*args, **kw):
        probes.append((args, kw))
        return probe(*args, **kw)

    monkeypatch.setattr(PL.K, "miss_round", spy_miss)
    monkeypatch.setattr(TS.K, "lease_probe", spy_probe)
    keys = [f"k{i}" for i in range(12)]
    fab.write_batch([(k, "v") for k in keys], replica=0)
    fab.fence()
    assert fab.read_batch(keys, replica=1)           # misses: the miss pass
    fast = [(a, kw) for a, kw in probes if kw.get("row") is not None]
    assert misses and fast
    for args, kw in misses:
        M = args[9].shape[0]
        for t, table, W in zip(args[:7], (af.rp.tag, af.rp.rts, af.sh.tag,
                                          af.sh.rts, af.sh.wts, af.tsu.tag,
                                          af.tsu.memts),
                               (cfg.replica_ways,) * 2
                               + (cfg.shared_ways,) * 3
                               + (cfg.tsu_capacity,) * 2):
            assert _shares_storage(t, table) and t.shape[1] == W
        assert args[0].shape[0] == cfg.replica_sets
        assert args[5].shape[0] == cfg.n_shards
        assert _shares_storage(args[7], af.rp.cts) and args[7].shape == (1,)
        assert _shares_storage(args[8], af.sh.cts) and args[8].shape == (1,)
        assert args[10].dtype == torch.bool and isinstance(args[11], int)
        assert [r.shape for r in kw["rows"]] == [(M,)] * 3
    for args, kw in fast:
        assert _shares_storage(args[0], af.rp.tag)
        assert _shares_storage(args[1], af.rp.rts)
        assert args[0].shape == (cfg.replica_sets, cfg.replica_ways)
        assert args[2].shape == (1,) and args[4:] == (None, None)
        assert kw["row"].shape == args[3].shape


def test_write_batch_grants_from_the_tsu_tables_in_place(monkeypatch):
    """``tsu_commit_write_batch`` hands ``write_grant`` the shards' set-0
    tables as views (no [M, C] gather) and each lane's shard as its row."""
    rng = np.random.default_rng(5)
    KS, CAP, M = 4, 16, 8
    tag = rng.integers(-1, 40, (KS, 1, CAP + 1)).astype(np.int32)
    arrs = [_t(tag)] + [_t(rng.integers(0, 9, (KS, 1, CAP + 1)).astype(
        np.int32)) for _ in range(5)]
    tsu = TS.TSUState(arrs[0], arrs[1])
    shard = _t(np.array([0, 2, 1, 3, 0, 0, 0, 0], np.int32))
    seen = []
    old = TS.K.write_grant

    def spy(*args):
        seen.append(args)
        return old(*args)

    monkeypatch.setattr(TS.K, "write_grant", spy)
    TS.tsu_commit_write_batch(
        tsu, arrs[2], arrs[3], arrs[4], _t(np.full(KS, 3, np.int32)),
        torch.tensor(0, dtype=torch.int32), shard,
        _t(rng.integers(0, 40, M).astype(np.int32)), 4, 8,
        _t(np.arange(M) < 4))
    (args,) = seen
    for t, table in zip(args[:3], (tsu.tag, tsu.memts, arrs[4])):
        assert t.shape == (KS, CAP) and t.data_ptr() == table.data_ptr()
    assert args[5] is shard


def test_cuda_wrappers_refuse_cpu_tensors():
    """The kernel wrappers launch on CUDA tensors or raise — never a
    silent fallback."""
    with pytest.raises(ValueError, match="CUDA tensor"):
        cuda_lease_probe(*map(_t, _lease_probe_inputs(8, 2)))
    with pytest.raises(ValueError, match="CUDA tensor"):
        cuda_miss_round(*map(_t, _miss_round_inputs(8, 2, 2, 4)))
    with pytest.raises(ValueError, match="CUDA tensor"):
        cuda_write_grant(*map(_t, _write_grant_inputs(8, 4, 0)))
