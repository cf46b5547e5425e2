"""The port's ``ArrayFabric`` against ``repro``'s ``ArrayFabric`` and
``HostFabric``, bit for bit.

The reference suites' own drivers and configurations
(``tests/test_fabric_parity.py``, ``tests/test_write_parity.py``,
``tests/test_overlap_stream.py``) drive the port on the CPU
(``device="cpu"``) next to the host-object oracle and the reference's
array fabric.  Every observable must match: per-op results, the ordered
grant log, the counter block, each replica's counters, every key's
``memts`` — and the whole state, array for array, against the reference's
``_AF`` (including the trash ways).  ``export_state``/``load_state``
carries a mid-run reference fabric into the port.  The guards at the end
pin the package boundary: no ``jax`` and no ``repro`` in ``repro_torch``,
and entry points that run on the card unless told otherwise.
"""
import ast
import os
import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import test_overlap_stream as overlap
from repro.coherence.fabric import ArrayFabric as RefArrayFabric
from repro.coherence.fabric import FabricConfig as RConfig
from repro.coherence.fabric import HostFabric
from repro_torch.coherence.fabric import (ArrayFabric, FabricConfig,
                                          ReadBatchHandle, default_fabric)
from repro_torch.coherence.fabric.arrays import state_leaves
from repro_torch.coherence.kv_lease import BatchedKVLease

from test_fabric_parity import (KEYS, MEDIUM, OVERFLOW, SMALL,
                                _drive_read_batches, random_trace)
from test_write_parity import WRITEHOT, _drive_write_storms

SRC = pathlib.Path(__file__).resolve().parent.parent / "src"


def port_fabric(cfg_kw, n_nodes=2, replicas_per_node=2, **kw):
    return ArrayFabric(FabricConfig(**cfg_kw), n_nodes=n_nodes,
                       replicas_per_node=replicas_per_node, device="cpu",
                       **kw)


def reference_state(fab):
    """A reference ``ArrayFabric`` as the ``(arrays, host)`` pair
    ``repro_torch``'s ``load_state`` takes."""
    arrays = {k: np.asarray(v, np.int32) for k, v in
              state_leaves(jax.device_get(fab._af)).items()}
    host = {"key_list": list(fab._key_list), "meta": np.array(fab._meta),
            "vals": dict(fab._vals), "pending": dict(fab._pending),
            "pending_n": dict(fab._pending_n),
            "qmirror": [list(q) for q in fab._qmirror],
            "grant_log": list(fab.grant_log),
            "fast_read_batches": fab._fast_read_batches,
            "write_batches": fab._write_batches,
            "writes_since_prune": fab._writes_since_prune}
    return arrays, host


def assert_same_state(ref_fab, port_fab):
    want, _ = reference_state(ref_fab)
    got, _ = port_fab.export_state()
    assert set(got) == set(want)
    assert all(v.dtype == np.int32 for v in got.values())
    bad = [k for k in want if not np.array_equal(got[k], want[k])]
    assert not bad, f"state leaves differ: {bad}"


def assert_same_export(a, b):
    """Two port fabrics hold the same arrays and host tables."""
    x, hx = a.export_state()
    y, hy = b.export_state()
    assert all(np.array_equal(x[k], y[k]) for k in x)
    assert np.array_equal(hx.pop("meta"), hy.pop("meta")) and hx == hy


def assert_same_observables(a, b, keys=KEYS):
    assert list(a.grant_log) == list(b.grant_log), "grant logs diverged"
    assert a.stats() == b.stats(), "FabricStats diverged"
    for r in range(a.n_replicas):
        assert a.replica_stats(r) == b.replica_stats(r), f"replica {r}"
    for k in keys:
        assert a.memts(k) == b.memts(k), f"memts({k!r})"


# ----------------------------------------------------- op scan (apply)
@pytest.mark.parametrize("cfg_kw,n_nodes,rpn,wr,seed", [
    (SMALL, 2, 2, (None,), 0), (SMALL, 2, 2, (None,), 1),
    (MEDIUM, 2, 2, (None,), 0), (OVERFLOW, 1, 2, (None, 1, 30000), 0),
    (OVERFLOW, 1, 2, (None, 1, 30000), 1)])
def test_random_trace_matches_host_oracle(cfg_kw, n_nodes, rpn, wr, seed):
    """The op scan: randomized reads/writes/fences/authority ops, with
    forced 16-bit reinits and TSU evictions on OVERFLOW."""
    host = HostFabric(RConfig(**cfg_kw), n_nodes=n_nodes,
                      replicas_per_node=rpn)
    port = port_fabric(cfg_kw, n_nodes, rpn)
    ops = random_trace(np.random.default_rng(seed), 300, n_nodes * rpn,
                       wr_choices=wr, n_nodes=n_nodes)
    for i, ((op, hr), (_, pr)) in enumerate(zip(host.apply(ops),
                                                port.apply(ops))):
        assert hr == pr, f"op {i} ({op.kind} {op.key!r}): {hr!r} != {pr!r}"
    assert_same_observables(host, port)
    if cfg_kw is OVERFLOW:
        assert host.stats()["overflow_reinits"] > 0
        assert host.stats()["tsu_evictions"] > 0


@pytest.mark.parametrize("cfg_kw,n_nodes,rpn,wr", [
    (SMALL, 2, 2, (None,)), (OVERFLOW, 1, 2, (None, 1, 30000))])
def test_op_scan_state_matches_reference_array_fabric(cfg_kw, n_nodes, rpn,
                                                      wr):
    ref = RefArrayFabric(RConfig(**cfg_kw), n_nodes=n_nodes,
                         replicas_per_node=rpn)
    port = port_fabric(cfg_kw, n_nodes, rpn)
    ops = random_trace(np.random.default_rng(4), 250, n_nodes * rpn,
                       wr_choices=wr, n_nodes=n_nodes)
    assert [r for _, r in ref.apply(ops)] == [r for _, r in port.apply(ops)]
    assert_same_observables(ref, port)
    assert_same_state(ref, port)


# ------------------------------------------------- batched read / write
@pytest.mark.parametrize("seed,cfg_kw", [(0, SMALL), (1, SMALL),
                                         (0, MEDIUM)])
def test_batched_reads_match_reference_and_host(seed, cfg_kw):
    """Mixed hit/miss/dup read batches through the fast read and the miss
    pass (SMALL mostly takes the op-scan fallback, MEDIUM real rounds)."""
    host = HostFabric(RConfig(**cfg_kw), n_nodes=2, replicas_per_node=2)
    port = port_fabric(cfg_kw)
    fabs = [host, port]
    with_ref = cfg_kw is SMALL and seed == 0
    if with_ref:
        fabs.append(RefArrayFabric(RConfig(**cfg_kw), n_nodes=2,
                                   replicas_per_node=2))
    warm = random_trace(np.random.default_rng(seed + 100), 150, 4)
    for b in fabs:
        b.apply(warm)
    outs = _drive_read_batches(fabs, seed)
    assert outs[1] == outs[0]
    assert_same_observables(host, port)
    if with_ref:
        assert outs[2] == outs[0]
        assert_same_state(fabs[2], port)
    scan = port_fabric(cfg_kw, pipeline="scan")
    scan.apply(warm)
    assert _drive_read_batches([scan], seed)[0] == outs[0]
    assert_same_export(scan, port)


@pytest.mark.parametrize("seed,cfg_kw", [(0, SMALL), (0, MEDIUM),
                                         (0, WRITEHOT), (1, WRITEHOT)])
def test_write_storms_match_reference_and_host(seed, cfg_kw):
    """Publish storms through the batched write pass: duplicate keys,
    queue fill -> drain inside a batch, 16-bit reinits (wr_lease 30000)
    and TSU evictions (WRITEHOT's 2-entry shards)."""
    host = HostFabric(RConfig(**cfg_kw), n_nodes=2, replicas_per_node=2)
    port = port_fabric(cfg_kw)
    fabs = [host, port]
    if cfg_kw is SMALL:
        fabs.append(RefArrayFabric(RConfig(**cfg_kw), n_nodes=2,
                                   replicas_per_node=2))
    warm = random_trace(np.random.default_rng(seed + 100), 120, 4)
    for b in fabs:
        b.apply(warm)
    outs = _drive_write_storms(fabs, seed)
    assert outs[1] == outs[0]
    assert_same_observables(host, port)
    assert host.stats()["write_throughs"] > 0
    if cfg_kw is WRITEHOT:
        assert host.stats()["tsu_evictions"] > 0
    if cfg_kw is SMALL:
        assert_same_state(fabs[2], port)


@pytest.mark.parametrize("seed", [0, 1])
def test_read_batch_async_matches_sync_and_host(seed, monkeypatch):
    """Overlapped reads (``read_batch_async``, resolved late) equal sync
    reads and the host oracle — the reference's overlap driver."""
    monkeypatch.setattr(overlap, "ReadBatchHandle", ReadBatchHandle)
    cfg_kw = overlap.SMALL
    a_async, a_sync = port_fabric(cfg_kw), port_fabric(cfg_kw)
    host = HostFabric(RConfig(**cfg_kw), n_nodes=2, replicas_per_node=2)
    out_async = overlap._drive(a_async, seed, async_reads=True)
    out_sync = overlap._drive(a_sync, seed, async_reads=False)
    monkeypatch.undo()
    out_host = overlap._drive(host, seed, async_reads=False)
    assert out_async == out_sync == out_host
    assert_same_observables(host, a_async, overlap.KEYS)
    assert_same_export(a_async, a_sync)


# ---------------------------------------------------- state transfer
def test_load_state_from_mid_run_reference_then_continue():
    """``load_state`` takes a reference fabric's state mid-run; both then
    see the same next ops and stay identical."""
    ref = RefArrayFabric(RConfig(**SMALL), n_nodes=2, replicas_per_node=2)
    ref.apply(random_trace(np.random.default_rng(21), 150, 4))
    ref.write_batch([(k, f"{k}@mid") for k in KEYS[:3]], replica=1)
    port = port_fabric(SMALL)
    port.load_state(*reference_state(ref))
    assert_same_state(ref, port)
    nxt = random_trace(np.random.default_rng(22), 120, 4)
    assert [r for _, r in ref.apply(nxt)] == [r for _, r in port.apply(nxt)]
    batch = [KEYS[i % len(KEYS)] for i in range(12)]
    assert ref.read_batch(batch, replica=2) == port.read_batch(batch,
                                                               replica=2)
    assert_same_observables(ref, port)
    assert_same_state(ref, port)
    # and the round trip through the port's own export is the identity
    again = port_fabric(SMALL)
    again.load_state(*port.export_state())
    assert_same_export(again, port)


def test_fence_pass_equals_op_scan_fence():
    """The vectorized fence pass (``_fence_batched``) and the op-scan
    fence drain the same queues into the same state."""
    a, b = port_fabric(MEDIUM), port_fabric(MEDIUM)
    for f in (a, b):
        f.apply(random_trace(np.random.default_rng(31), 120, 4))
        f.write_batch([(k, f"{k}@f") for k in KEYS], replica=3)
        f.write_batch([(k, f"{k}@g") for k in KEYS[:3]], replica=0)
    assert any(a._qmirror)
    assert a.fence() == b._fence_batched()
    assert_same_observables(a, b)
    assert_same_export(a, b)


def test_tracer_records_the_fabric_phases(tmp_path):
    """The port's copy of ``obs.trace``: a scoped tracer sees every phase
    of a write storm, a fence and a mixed read batch, and exports them as
    Chrome-trace JSON; the process tracer stays off."""
    import json

    from repro_torch.obs import trace as obs
    fab = port_fabric(MEDIUM)
    tr = obs.Tracer(enabled=True)
    old = obs.set_tracer(tr)
    try:
        fab.write_batch([(k, f"{k}@t") for k in KEYS[:4]], replica=0)
        fab.fence()
        fab.read_batch(KEYS, replica=1)
    finally:
        obs.set_tracer(old)
    totals = tr.phase_totals("fabric.")
    assert {"fabric.pack", "fabric.write_pass", "fabric.scan",
            "fabric.fast_probe", "fabric.miss_pass",
            "fabric.decode"} <= set(totals)
    assert all(r["count"] >= 1 and r["total_us"] >= 0
               for r in totals.values())
    doc = json.loads(tr.export(tmp_path / "trace.json").read_text())
    assert len(doc["traceEvents"]) == len(tr.events)
    assert not obs.get_tracer().enabled


def test_copied_definitions_match_reference():
    """The definitions the port copies instead of importing: counter
    names and layouts, config defaults, the key hash, the bounds, the
    result and schedule layouts."""
    import dataclasses

    from repro.coherence.fabric import backend as RB
    from repro.coherence.fabric import pipeline as RPipe
    from repro.coherence.fabric import stats as RSt
    from repro.coherence.fabric import tsu as RT
    from repro.core import engine as RE
    from repro.core import state as RS
    from repro_torch.coherence.fabric import backend as TB
    from repro_torch.coherence.fabric import pipeline as TPipe
    from repro_torch.coherence.fabric import stats as TSt
    from repro_torch.coherence.fabric import tsu as TT
    from repro_torch.core import state as TS

    fields = lambda cls: [(f.name, f.default) for f in
                          dataclasses.fields(cls)]
    assert TSt.COUNTERS == tuple(RE.COUNTERS)
    assert (TSt.G_KEYS, TSt.R_KEYS) == (RSt.G_KEYS, RSt.R_KEYS)
    assert fields(TSt.FabricStats) == fields(RSt.FabricStats)
    assert fields(TT.FabricConfig) == fields(RT.FabricConfig)
    assert TT.LeaseGrant._fields == RT.LeaseGrant._fields
    for key in ["prefix/0", "k7", 12345, b"raw", ("t", 1)]:
        assert TT.stable_hash(key) == RT.stable_hash(key)
    assert (TB.DEFAULT_TSU_CAPACITY, TB.GRANT_LOG_LEN) == \
        (RB.DEFAULT_TSU_CAPACITY, RB.GRANT_LOG_LEN)
    assert TB.Op._fields == RB.Op._fields
    assert (TS.INVALID, TS.BLOCK_BYTES, TS.CTRL_BYTES, TS.RES_FIELDS,
            TS.TIER_FIELDS, TS.TSU_FIELDS) == \
        (RS.INVALID, RS.BLOCK_BYTES, RS.CTRL_BYTES, RS.RES_FIELDS,
         RS.TIER_FIELDS, RS.TSU_FIELDS)
    assert (TPipe.WRITE_RES_FIELDS, TPipe.WRITE_SCHED_FIELDS,
            TPipe.FENCE_SCHED_FIELDS) == \
        (RPipe.WRITE_RES_FIELDS, RPipe.WRITE_SCHED_FIELDS,
         RPipe.FENCE_SCHED_FIELDS)


# ------------------------------------------------------------ guards
# the modules that carry the sharded fabric and its host oracle: each must
# be among those the guards scan
SHARDED_SLICE = ("coherence/fabric/tsu.py", "coherence/fabric/cache.py",
                 "coherence/fabric/writeq.py", "launch/mesh.py",
                 "obs/xprof.py")


def _modules():
    mods = sorted((SRC / "repro_torch").rglob("*.py"))
    for m in SHARDED_SLICE:
        assert SRC / "repro_torch" / m in mods, f"{m} is missing"
    return mods


def test_port_imports_neither_jax_nor_repro_ast():
    for path in _modules():
        tree = ast.parse(path.read_text(), str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
            else:
                continue
            for n in names:
                root = n.split(".")[0]
                assert root not in ("jax", "jaxlib", "repro"), \
                    f"{path.relative_to(SRC)} imports {n}"


def test_port_imports_neither_jax_nor_repro_at_runtime():
    mods = [".".join(p.relative_to(SRC).with_suffix("").parts)
            .removesuffix(".__init__") for p in _modules()]
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]\n"
            "assert not bad, bad\nprint('CLEAN', len(sys.modules))\n")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "CLEAN" in proc.stdout


def test_entry_points_default_to_cuda():
    """``device=None`` means the CUDA card; without one the entry points
    raise instead of running on the CPU quietly."""
    makers = (lambda: ArrayFabric(FabricConfig(**SMALL)),
              lambda: default_fabric(FabricConfig(**SMALL)),
              lambda: BatchedKVLease())
    for make in makers:
        if torch.cuda.is_available():
            fab = make()
            fab = getattr(fab, "backend", fab)
            assert fab.device.type == "cuda"
        else:
            with pytest.raises(RuntimeError, match="CUDA"):
                make()
    kv = BatchedKVLease(port_fabric(SMALL), replica=1)
    kv.put_batch([(k, f"{k}@kv") for k in KEYS[:4]])
    kv.fence()
    assert all(g is not None for g in kv.get_batch(KEYS[:4]))
    with pytest.raises(ValueError):
        BatchedKVLease(port_fabric(SMALL), device="cpu")
