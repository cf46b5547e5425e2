"""The port's figure engine against ``repro.core`` on the CPU.

``repro_torch.core.{sysconfig,traces,engine}`` are held to ``repro.core``
on the same inputs: every trace generator gives equal arrays; ``simulate``
gives a bit-equal final state (every int32 and bool leaf, trash ways
included), read log and result log, equal counters (f32 sums of integer
counts, exact) and cycles within rtol 1e-6 (a per-GPU mean summed in
another order); ``sweep`` equals the reference's ``sweep`` and the port's
own per-cell ``simulate``.  The reference's ``lease_probe`` runs in
interpret mode here, as its own tests run it; the port's runs its plain
version.  ``tests/test_sweep.py``, ``test_protocol_litmus.py`` and
``test_protocol_property.py`` are ported case for case, each also
compared with the reference's result.
"""
import dataclasses

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.core import engine as RE
from repro.core import sysconfig as RS
from repro.core import traces as RT
from repro_torch.coherence.fabric import stats as TStats
from repro_torch.core import engine as TE
from repro_torch.core import protocol as TP
from repro_torch.core import sysconfig as TS
from repro_torch.core import traces as TT
from repro_torch.core.engine import FENCE, NOP, READ, WRITE

KW = dict(n_gpus=2, cus_per_gpu=4)
ROUNDS = 96
BENCHES = ("aes", "mm")
SYSTEMS = ("rdma_wb_nc", "rdma_wb_hmg", "sm_wb_nc", "sm_wt_nc",
           "sm_wt_halcone")
CPU = dict(device="cpu")


def pair(name, **kw):
    """The same config in the reference and in the port."""
    return getattr(RS, name)(**kw), getattr(TS, name)(**kw)


def state_leaves(s):
    """Every array leaf of a SimState as numpy, by name."""
    out = {}
    for tier in ("l1", "l2", "tsu"):
        t = getattr(s, tier)
        for f in t._fields:
            out[f"{tier}.{f}"] = np.asarray(getattr(t, f))
    for f in ("l2_dirty", "mm_ver", "dir_sharers", "time"):
        out[f] = np.asarray(getattr(s, f))
    return out


def assert_same_run(r, p, what=""):
    """A port ``simulate`` result ``p`` against the reference's ``r``."""
    want, got = state_leaves(r["state"]), state_leaves(p["state"])
    assert want.keys() == got.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, f"{what}: {k} dtype"
        if k == "time":
            np.testing.assert_allclose(got[k], want[k], rtol=1e-6,
                                       err_msg=f"{what}: {k}")
        else:
            np.testing.assert_array_equal(got[k], want[k],
                                          err_msg=f"{what}: {k}")
    np.testing.assert_array_equal(p["read_log"], np.asarray(r["read_log"]),
                                  err_msg=what)
    assert tuple(p["res_log"]) == tuple(r["res_log"])
    for k in r["res_log"]:
        np.testing.assert_array_equal(p["res_log"][k],
                                      np.asarray(r["res_log"][k]),
                                      err_msg=f"{what}: res_log {k}")
    # (the reference's dict comes back with its keys sorted)
    assert tuple(p["counters"]) == RE.COUNTERS
    assert set(r["counters"]) == set(RE.COUNTERS)
    for k in RE.COUNTERS:
        assert float(p["counters"][k]) == float(r["counters"][k]), \
            f"{what}: counter {k}"
    np.testing.assert_allclose(p["per_cu_time"], np.asarray(r["per_cu_time"]),
                               rtol=1e-6, err_msg=what)
    for k in ("cycles", "makespan_max"):
        np.testing.assert_allclose(float(p[k]), float(r[k]), rtol=1e-6,
                                   err_msg=f"{what}: {k}")


def simulate_both(name, ops, addrs, **kw):
    rc, tc = pair(name, **kw)
    r = RE.simulate(rc, ops, addrs)
    p = TE.simulate(tc, ops, addrs, **CPU)
    assert_same_run(r, p, name)
    return r, p


# ------------------------------------------------------------------ traces
@pytest.mark.parametrize("gen", ["litmus_intra", "litmus_inter"])
def test_litmus_traces_equal_reference(gen):
    for kw in (KW, dict(n_gpus=2, cus_per_gpu=2)):
        rc, tc = pair("sm_wt_halcone", **kw)
        for a, b in zip(getattr(RT, gen)(rc), getattr(TT, gen)(tc)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("variant", [1, 2, 3])
def test_xtreme_traces_equal_reference(variant):
    rc, tc = pair("sm_wt_halcone", **KW)
    for nb, reps in ((3, 2), (5, 3)):
        want = RT.xtreme(rc, RT.XtremeSpec(variant, nb, reps))
        got = TT.xtreme(tc, TT.XtremeSpec(variant, nb, reps))
        for a, b in zip(want, got):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("bench", sorted(RT.STANDARD))
@pytest.mark.parametrize("seed", [0, 3])
def test_standard_traces_equal_reference(bench, seed):
    assert TT.STANDARD[bench] == TT.BenchModel(
        **dataclasses.asdict(RT.STANDARD[bench]))
    rc, tc = pair("sm_wt_halcone", **KW)
    want = RT.standard_trace(rc, RT.STANDARD[bench], ROUNDS, seed=seed)
    got = TT.standard_trace(tc, TT.STANDARD[bench], ROUNDS, seed=seed)
    for a, b in zip(want, got):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_pack_batch_equals_reference():
    rc, tc = pair("sm_wt_halcone", **KW)
    tl = [RT.standard_trace(rc, RT.STANDARD[b], r)
          for b, r in (("aes", 40), ("bs", 64), ("mm", 17))]
    for a, b in zip(RT.pack_batch(tl), TT.pack_batch(tl)):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError):
        TT.pack_batch([tl[0], (tl[1][0][:3], tl[1][1][:3])])


def test_copied_definitions_match_reference():
    """Op codes, counter names (one copy: the fabric's stats import the
    engine's), config fields and defaults, the factories."""
    assert (NOP, READ, WRITE, FENCE, TE.COMPUTE) == \
        (RE.NOP, RE.READ, RE.WRITE, RE.FENCE, RE.COMPUTE)
    assert TE.COUNTERS == RE.COUNTERS
    assert TStats.COUNTERS is TE.COUNTERS
    fields = lambda cls: [(f.name, f.default) for f in
                          dataclasses.fields(cls)]
    assert fields(TS.SystemConfig) == fields(RS.SystemConfig)
    assert (TS.META_FIELDS, TS.DATA_FIELDS) == \
        (RS.META_FIELDS, RS.DATA_FIELDS)
    for rf, tf in zip(RS.ALL_CONFIGS, TS.ALL_CONFIGS):
        assert dataclasses.asdict(rf(**KW)) == dataclasses.asdict(tf(**KW))
        assert TS.static_key(tf(**KW)) == RS.static_key(rf(**KW))


# ---------------------------------------------------------------- simulate
@pytest.mark.parametrize("bench", ["aes", "bs"])
@pytest.mark.parametrize("name", SYSTEMS)
def test_simulate_matches_reference(name, bench):
    rc = getattr(RS, name)(**KW)
    ops, addrs = RT.standard_trace(rc, RT.STANDARD[bench], ROUNDS)
    simulate_both(name, ops, addrs, **KW)


@pytest.mark.parametrize("name", SYSTEMS)
def test_shared_writes_match_reference(name):
    """Every CU reads and writes four shared blocks, with a fence midway:
    HMG's invalidations and directory, and HALCONE's coherence misses,
    which ``bs`` at 96 rounds on 8 CUs does not reach."""
    rng = np.random.default_rng(11)
    T = 40
    ops = rng.choice([READ, READ, WRITE, NOP], (8, T)).astype(np.int32)
    ops[:, T // 2] = FENCE
    addrs = rng.choice([5, 13, 64 + 5, 200], (8, T)).astype(np.int32)
    r, _ = simulate_both(name, ops, addrs, **KW)
    if name == "rdma_wb_hmg":
        assert float(r["counters"]["inval_msgs"]) > 0
    if name == "sm_wt_halcone":
        assert float(r["counters"]["coh_miss_l1"]) > 0


@pytest.mark.parametrize("name", SYSTEMS)
def test_collision_round_matches_reference(name):
    """All CUs of each GPU write distinct addresses of one L2 bank and set,
    more writers than ways, in one round, then read them back: the L2
    installs (and WB's dirty bits, HMG's kept copies) repeat a slot, and
    the highest lane must win it as in the reference."""
    kw = dict(n_gpus=2, cus_per_gpu=8, l2_ways=4, l1_sets=4, l2_sets=8,
              tsu_sets=16)
    rc = getattr(RS, name)(**kw)
    NC, CU = rc.n_cus, rc.cus_per_gpu
    stride = rc.l2_banks * rc.l2_sets       # same bank, same set
    cu = np.arange(NC)
    addr = 3 + stride * (cu % CU + 1 + (cu // CU) * 16)
    addrs = np.repeat(addr[:, None], 6, 1).astype(np.int32)
    ops = np.zeros_like(addrs)
    ops[:, 0] = READ
    ops[:, 1] = WRITE
    ops[:, 2] = READ
    ops[:CU, 3] = WRITE
    ops[:, 4] = FENCE
    ops[:, 5] = READ
    r, _ = simulate_both(name, ops, addrs, **kw)
    np.testing.assert_array_equal(np.asarray(r["read_log"])[:, 5],
                                  np.where(cu < CU, 2, 1))


def test_init_state_matches_reference():
    for name in SYSTEMS:
        rc, tc = pair(name, **KW)
        want = state_leaves(RE.init_state(rc, 64))
        got = state_leaves(TE.init_state(tc, 64, **CPU))
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_entry_points_default_to_cuda():
    """``device=None`` means the CUDA card; without one ``simulate``,
    ``sweep`` and ``init_state`` raise instead of running on the CPU."""
    cfg = TS.sm_wt_halcone(**KW)
    ops, addrs = TT.litmus_intra(cfg)
    for call in (lambda: TE.simulate(cfg, ops, addrs)["state"].l1.tag,
                 lambda: TE.init_state(cfg, 64).l1.tag,
                 lambda: TE.sweep([cfg], ops[None], addrs[None])):
        if torch.cuda.is_available():
            out = call()
            assert not isinstance(out, torch.Tensor) or \
                out.device.type == "cuda"
        else:
            with pytest.raises(RuntimeError, match="CUDA"):
                call()


# ------------------------------------------------------------------- sweep
LEASES = [(2, 10), (10, 2), (20, 5)]
ORDERED = [("sm_wt_halcone", dict(rd_lease=2)), ("sm_wt_nc", {}),
           ("sm_wt_halcone", dict(rd_lease=30))]
# every config the sweep tests run, in one reference sweep (one compile
# per static group)
UNION = [(n, {}) for n in SYSTEMS] \
    + [("sm_wt_halcone", dict(rd_lease=rd, wr_lease=wr)) for rd, wr in LEASES] \
    + ORDERED


@pytest.fixture(scope="module")
def batch():
    base = RS.sm_wt_halcone(**KW)
    tl = [RT.standard_trace(base, RT.STANDARD[b], ROUNDS) for b in BENCHES]
    # unequal lengths exercise pack_batch's NOP padding
    short = (tl[0][0][:, :ROUNDS - 17], tl[0][1][:, :ROUNDS - 17])
    tl = [short] + tl[1:]
    return tl, TT.pack_batch(tl)


@pytest.fixture(scope="module")
def ref_sweep(batch):
    """The reference's sweep of ``UNION``: row i is config ``UNION[i]``."""
    _, (ops_b, addrs_b) = batch
    return RE.sweep([getattr(RS, n)(**kw, **KW) for n, kw in UNION], ops_b,
                    addrs_b)


def _assert_cell_parity(cfg, trace, cycles, counters, bi):
    r = TE.simulate(cfg, *trace, **CPU)
    np.testing.assert_allclose(cycles[bi], float(r["cycles"]), rtol=1e-6,
                               err_msg=cfg.name)
    for k, v in r["counters"].items():
        assert counters[k][bi] == float(v), f"{cfg.name}/{k}"


def _assert_sweep_equals_reference(got, ref, rows):
    """``got``'s rows against the reference sweep's ``rows`` of UNION."""
    np.testing.assert_allclose(got["cycles"],
                               np.asarray(ref["cycles"])[rows], rtol=1e-6)
    np.testing.assert_allclose(got["makespan_max"],
                               np.asarray(ref["makespan_max"])[rows],
                               rtol=1e-6)
    assert tuple(got["counters"]) == RE.COUNTERS
    for k in RE.COUNTERS:
        np.testing.assert_array_equal(got["counters"][k],
                                      np.asarray(ref["counters"][k])[rows],
                                      err_msg=k)


def _sweep(named, ops_b, addrs_b):
    """The port's sweep of ``named`` configs, and their rows in UNION."""
    cfgs = [getattr(TS, n)(**kw, **KW) for n, kw in named]
    return cfgs, TE.sweep(cfgs, ops_b, addrs_b, **CPU), \
        [UNION.index(x) for x in named]


def test_sweep_matches_sequential_all_structures(batch, ref_sweep):
    """All five modeled systems (five static groups) in one call: equal to
    the reference's ``sweep`` and to the port's per-cell ``simulate``."""
    tl, (ops_b, addrs_b) = batch
    cfgs, res, rows = _sweep([(n, {}) for n in SYSTEMS], ops_b, addrs_b)
    assert res["cycles"].shape == (len(cfgs), len(tl))
    _assert_sweep_equals_reference(res, ref_sweep, rows)
    for ci, cfg in enumerate(cfgs):
        for bi, trace in enumerate(tl):
            _assert_cell_parity(cfg, trace, res["cycles"][ci],
                                {k: v[ci] for k, v in
                                 res["counters"].items()}, bi)


def test_sweep_config_vmap_group(batch, ref_sweep):
    """Lease variants share static structure -> one stacked group."""
    tl, (ops_b, addrs_b) = batch
    named = [("sm_wt_halcone", dict(rd_lease=rd, wr_lease=wr))
             for rd, wr in LEASES]
    cfgs, res, rows = _sweep(named, ops_b, addrs_b)
    assert len({TS.static_key(c) for c in cfgs}) == 1
    stacked = TS.stack_configs(cfgs)
    assert stacked.rd_lease.shape == (3,)
    assert stacked.rd_lease.dtype == torch.int32
    assert stacked.l2_lat.dtype == torch.float32
    _assert_sweep_equals_reference(res, ref_sweep, rows)
    for ci, cfg in enumerate(cfgs):
        for bi, trace in enumerate(tl):
            r = TE.simulate(cfg, *trace, **CPU)
            np.testing.assert_allclose(res["cycles"][ci, bi],
                                       float(r["cycles"]), rtol=1e-6)


def test_sweep_preserves_input_config_order(batch, ref_sweep):
    """Grouping by static structure must not permute the result rows."""
    tl, (ops_b, addrs_b) = batch
    cfgs, res, rows = _sweep(ORDERED, ops_b, addrs_b)
    _assert_sweep_equals_reference(res, ref_sweep, rows)
    for ci, cfg in enumerate(cfgs):
        r = TE.simulate(cfg, *tl[0], **CPU)
        np.testing.assert_allclose(res["cycles"][ci, 0], float(r["cycles"]),
                                   rtol=1e-6, err_msg=f"row {ci}")


def test_pack_batch_padding_is_exact():
    """NOP padding adds no cycles, no counters (so ``sweep`` may run the
    real rounds only)."""
    base = TS.sm_wt_halcone(**KW)
    ops, addrs = TT.standard_trace(base, TT.STANDARD["fir"], 48)
    padded_ops = np.pad(ops, ((0, 0), (0, 31)))
    padded_addrs = np.pad(addrs, ((0, 0), (0, 31)))
    a = TE.simulate(base, ops, addrs, **CPU)
    b = TE.simulate(base, padded_ops, padded_addrs, **CPU)
    np.testing.assert_allclose(float(a["cycles"]), float(b["cycles"]),
                               rtol=1e-7)
    for k in a["counters"]:
        assert float(a["counters"][k]) == float(b["counters"][k]), k
    s = TE.sweep([base], padded_ops[None], padded_addrs[None], **CPU)
    assert float(s["cycles"][0, 0]) == float(a["cycles"])


def test_fig10_byte_counters_decompose(batch):
    """The per-link byte counters are exactly state.link_bytes over the
    transaction counters, and HALCONE's inter-GPU bytes never contain an
    invalidation component (inval_msgs == 0, the Fig-10 claim)."""
    from repro_torch.core.state import BLOCK_BYTES, CTRL_BYTES

    tl, _ = batch
    for cfg in (TS.sm_wt_halcone(**KW), TS.rdma_wb_hmg(**KW)):
        c = {k: float(v) for k, v in
             TE.simulate(cfg, *tl[1], **CPU)["counters"].items()}
        assert c["bytes_l1_l2"] == c["l1_to_l2"] * BLOCK_BYTES
        assert c["bytes_l2_mm"] == c["l2_to_mm"] * BLOCK_BYTES
        assert c["bytes_inter_gpu"] == \
            c["pcie_blocks"] * BLOCK_BYTES + c["inval_msgs"] * CTRL_BYTES
        if cfg.protocol == "halcone":
            assert c["inval_msgs"] == 0.0


def test_stack_configs_rejects_mixed_structure():
    with pytest.raises(ValueError):
        TS.stack_configs([TS.sm_wt_halcone(**KW), TS.sm_wt_nc(**KW)])
    with pytest.raises(ValueError):
        TE.sweep([TS.sm_wt_halcone(n_gpus=4, cus_per_gpu=4)],
                 np.zeros((1, 8, 4), np.int32), np.zeros((1, 8, 4), np.int32),
                 **CPU)


def test_simulate_res_log_block(batch):
    """The packed per-op result block (core.state.RES_FIELDS): read_log is
    its version field masked to reads, found mirrors the memory ops, level
    only annotates reads, and mm_used reads were served at level 3."""
    from repro_torch.core.state import RES_FIELDS

    tl, _ = batch
    ops, addrs = tl[1]
    r = TE.simulate(TS.sm_wt_halcone(**KW), ops, addrs, **CPU)
    fields = r["res_log"]
    assert tuple(fields) == RES_FIELDS
    for name in RES_FIELDS:
        assert fields[name].shape == ops.shape, name
    np.testing.assert_array_equal(
        r["read_log"], np.where(ops == READ, fields["version"], -1))
    np.testing.assert_array_equal(
        fields["found"].astype(bool), (ops == READ) | (ops == WRITE))
    assert (fields["level"][ops != READ] == -1).all()
    read_levels = fields["level"][ops == READ]
    assert ((read_levels >= 0) & (read_levels <= 3)).all()
    mm_reads = (fields["mm_used"] == 1) & (ops == READ)
    assert (fields["level"][mm_reads] == 3).all()
    assert (fields["gseq"] == -1).all()
    assert (fields["rts"][(ops != READ) & (ops != WRITE)] == -1).all()


# ------------------------------------------------------------------ litmus
def small(**kw):
    return dict(n_gpus=2, cus_per_gpu=2, **kw)


def test_fig5a_intra_gpu():
    """CU0/CU1 of GPU0: order I0-1 -> I1-1 -> I0-2 -> I0-3 -> I1-2 -> I1-3."""
    ops, addrs = TT.litmus_intra(TS.sm_wt_halcone(**small()))
    _, r = simulate_both("sm_wt_halcone", ops, addrs, **small())
    log0, log1 = r["read_log"][0], r["read_log"][1]
    assert log0[0] == 0           # I0-1: first read of X
    assert log0[3] == 0           # I0-3: read in the past (L1 lease hit)
    assert log1[1] == 0           # I1-1: first read of Y
    assert log1[5] == 1           # I1-3: coherency miss sees CU0's write
    st_ = r["state"]
    assert int(st_.l1_cts[0]) == int(st_.l1_cts[1]) == 11


def test_fig5b_inter_gpu():
    """CU0 of GPU0 vs CU0 of GPU1: the final read of Y comes from MM and
    observes GPU0's write, with no invalidation traffic."""
    cfg = TS.sm_wt_halcone(**small())
    ops, addrs = TT.litmus_inter(cfg)
    _, r = simulate_both("sm_wt_halcone", ops, addrs, **small())
    gpu0, gpu1 = r["read_log"][0], r["read_log"][cfg.cus_per_gpu]
    assert gpu0[0] == 0 and gpu1[1] == 0
    assert gpu0[3] == 0
    assert gpu1[5] == 1
    assert float(r["counters"]["l2_to_mm"]) >= 4


def test_write_then_fence_then_read_is_coherent():
    """DRF: write (GPU0) -> fence -> read (GPU1) sees the write."""
    NC, X, T = 4, 5, 6
    ops = np.zeros((NC, T), np.int32)
    addrs = np.zeros((NC, T), np.int32)
    ops[:, 0] = READ
    addrs[:, 0] = X
    ops[0, 1] = WRITE
    addrs[0, 1] = X
    ops[:, 2] = FENCE
    ops[:, 3] = READ
    addrs[:, 3] = X
    _, r = simulate_both("sm_wt_halcone", ops, addrs, **small())
    assert (r["read_log"][:, 0] == 0).all()
    assert (r["read_log"][:, 3] == 1).all()


def test_unsynchronized_read_may_be_stale_but_never_future():
    ops = np.zeros((4, 4), np.int32)
    addrs = np.full((4, 4), 7, np.int32)
    ops[0, 0] = READ
    ops[2, 1] = WRITE
    ops[0, 2] = READ
    _, r = simulate_both("sm_wt_halcone", ops, addrs, **small())
    assert r["read_log"][0, 0] == 0
    assert r["read_log"][0, 2] in (0, 1)


def test_tsu_parallel_access_no_latency_overhead():
    """The TSU is off the critical path: HALCONE's read-miss latency equals
    the non-coherent system's on the same unshared trace."""
    rng = np.random.default_rng(0)
    T = 64
    ops = np.full((4, T), READ, np.int32)
    addrs = rng.integers(0, 4096, (4, T)).astype(np.int32)
    _, rc = simulate_both("sm_wt_halcone", ops, addrs, **small())
    _, rn = simulate_both("sm_wt_nc", ops, addrs, **small())
    assert float(rc["cycles"]) <= float(rn["cycles"]) * 1.02


# --------------------------------------------------------------- properties
PROP = dict(n_gpus=2, cus_per_gpu=2, l1_sets=4, l2_sets=8, tsu_sets=16)
op_strat = st.tuples(st.sampled_from([NOP, READ, WRITE]),
                     st.integers(min_value=0, max_value=31))


@settings(max_examples=25, deadline=None)
@given(st.lists(st.lists(op_strat, min_size=4, max_size=16),
                min_size=4, max_size=4),
       st.integers(0, 3))
def test_random_traces_swmr_and_monotone(traces_py, fence_round):
    """Arbitrary traces: every read returns a version that existed at read
    time, clocks stay non-negative, and the whole run equals the
    reference's."""
    T = max(len(s) for s in traces_py) + 1
    ops = np.zeros((4, T), np.int32)
    addrs = np.zeros((4, T), np.int32)
    for i, s in enumerate(traces_py):
        for t, (o, a) in enumerate(s):
            ops[i, t], addrs[i, t] = o, a
    ops[:, fence_round] = np.where(ops[:, fence_round] == NOP, FENCE,
                                   ops[:, fence_round])
    _, r = simulate_both("sm_wt_halcone", ops, addrs, **PROP)
    cum = np.zeros((T + 1, 64), np.int64)
    for t in range(T):
        cum[t + 1] = cum[t]
        for i in range(4):
            if ops[i, t] == WRITE:
                cum[t + 1, addrs[i, t]] += 1
    for i in range(4):
        for t in range(T):
            if ops[i, t] == READ:
                assert 0 <= r["read_log"][i, t] <= cum[t + 1, addrs[i, t]]
    assert (r["state"].l1_cts >= 0).all() and (r["state"].l2_cts >= 0).all()


@settings(max_examples=25, deadline=None)
@given(st.integers(1, 30), st.integers(0, 3), st.integers(0, 3))
def test_drf_visibility(n_pre_reads, writer, reader):
    """write -> fence -> read ALWAYS sees the write (any lease history)."""
    T = n_pre_reads + 3
    ops = np.zeros((4, T), np.int32)
    addrs = np.full((4, T), 3, np.int32)
    ops[reader, :n_pre_reads] = READ
    ops[writer, n_pre_reads] = WRITE
    ops[:, n_pre_reads + 1] = FENCE
    ops[reader, n_pre_reads + 2] = READ
    _, r = simulate_both("sm_wt_halcone", ops, addrs, **PROP)
    assert r["read_log"][reader, -1] == 1


def test_timestamp_overflow_reinit():
    """16-bit overflow re-initializes instead of flushing; data stays
    correct because of write-through."""
    ops = np.zeros((4, 10), np.int32)
    addrs = np.full((4, 10), 2, np.int32)
    ops[0, :6] = [WRITE, WRITE, WRITE, READ, WRITE, READ]
    _, r = simulate_both("sm_wt_halcone", ops, addrs, rd_lease=30000,
                         wr_lease=29000, **PROP)
    assert r["read_log"][0, 3] == 3
    assert r["read_log"][0, 5] == 4
    assert int(r["state"].tsu_memts.max()) <= TP.TS_MAX + 1


def test_tsu_eviction_lowest_memts():
    """When a TSU set fills, the entry with the lowest memts is evicted and
    the evicted block's next access is a compulsory MM miss."""
    kw = dict(n_gpus=2, cus_per_gpu=2, tsu_sets=1, tsu_ways=2, l1_sets=4,
              l2_sets=8)
    ops = np.zeros((4, 8), np.int32)
    addrs = np.zeros((4, 8), np.int32)
    for t, a in enumerate([1, 2, 3, 1]):
        ops[0, t] = READ
        addrs[0, t] = a
    _, r = simulate_both("sm_wt_halcone", ops, addrs, **kw)
    assert (r["read_log"][0, :4] == 0).all()
    tags = r["state"].tsu_tag[:, :, :2]
    assert int((tags >= 0).sum()) <= 2 * 8
