"""The port's host-object oracle (``HostFabric``, ``TSUFabric``/``TSUShard``,
``SharedCache``/``ReplicaCache``, ``WriteQueue``, ``AuthoritativeStore``,
``LeaseKVCache``) against ``repro``'s, and against the port's
``ArrayFabric``.

The differential half drives the reference suites' traces and
configurations (``tests/test_fabric_parity.py``'s ``random_trace``,
``SMALL``, ``OVERFLOW``, ``MEDIUM``; ``tests/test_write_parity.py``'s write
storms) through both packages' ``HostFabric`` and the port's
``ArrayFabric`` on the CPU: per-op results, the grant log, ``stats()``,
every ``replica_stats`` and every key's ``memts`` must be equal.  The
unit half mirrors ``tests/test_writeq.py`` and the host-store cases of
``tests/test_fabric.py``: each scenario runs on the port's objects and on
the reference's, asserts the reference test's properties on both, and
their observations must be equal.
"""
import dataclasses
import gc
import types

import numpy as np
import pytest

import repro.coherence.fabric as RF
import repro.coherence.kv_lease as RK
import repro_torch.coherence.fabric as TF
import repro_torch.coherence.kv_lease as TK
from repro.core import engine as r_engine
from repro.core import protocol as r_protocol
from repro_torch.core import engine as t_engine
from repro_torch.core import protocol as t_protocol

from test_fabric_parity import (KEYS, MEDIUM, OVERFLOW, SMALL,
                                _drive_read_batches, random_trace)
from test_write_parity import WRITEHOT, _drive_write_storms


def _pkg(fab, kv, protocol, engine):
    return types.SimpleNamespace(
        FabricConfig=fab.FabricConfig, TSUFabric=fab.TSUFabric,
        SharedCache=fab.SharedCache, ReplicaCache=fab.ReplicaCache,
        WriteQueue=fab.WriteQueue, HostFabric=fab.HostFabric, Op=fab.Op,
        stable_hash=fab.stable_hash, FabricStats=fab.FabricStats,
        AuthoritativeStore=kv.AuthoritativeStore,
        LeaseKVCache=kv.LeaseKVCache, protocol=protocol, engine=engine)


PORT = _pkg(TF, TK, t_protocol, t_engine)
REF = _pkg(RF, RK, r_protocol, r_engine)


def _ops(pkg, ops):
    return [pkg.Op(o.kind, o.key, o.value, replica=o.replica, node=o.node,
                   wr_lease=o.wr_lease) for o in ops]


def _observe(fab, keys=KEYS):
    return {"grant_log": list(fab.grant_log), "stats": fab.stats(),
            "replica_stats": [fab.replica_stats(r)
                              for r in range(fab.n_replicas)],
            "memts": [fab.memts(k) for k in keys]}


def _three(cfg_kw, n_nodes=2, rpn=2):
    """The port's HostFabric, the reference's, the port's ArrayFabric."""
    return (PORT.HostFabric(PORT.FabricConfig(**cfg_kw), n_nodes, rpn),
            REF.HostFabric(REF.FabricConfig(**cfg_kw), n_nodes, rpn),
            TF.ArrayFabric(TF.FabricConfig(**cfg_kw), n_nodes, rpn,
                           device="cpu"))


def _assert_same(port, ref, arr, outs):
    assert outs[0] == outs[1], "port HostFabric != reference HostFabric"
    assert outs[0] == outs[2], "port HostFabric != port ArrayFabric"
    o = _observe(port)
    assert o == _observe(ref)
    assert o == _observe(arr)


# ------------------------------------------------------------ differential
@pytest.mark.parametrize("cfg_kw,n_nodes,rpn,wr,seed", [
    (SMALL, 2, 2, (None,), 0), (SMALL, 2, 2, (None,), 1),
    (SMALL, 2, 2, (None,), 2), (OVERFLOW, 1, 2, (None, 1, 30000), 0),
    (OVERFLOW, 1, 2, (None, 1, 30000), 1), (MEDIUM, 2, 2, (None, 2, 9), 3)])
def test_random_trace_matches_reference_host_and_array(cfg_kw, n_nodes, rpn,
                                                       wr, seed):
    ops = random_trace(np.random.default_rng(seed), 300, n_nodes * rpn,
                       wr_choices=wr, n_nodes=n_nodes)
    fabs = _three(cfg_kw, n_nodes, rpn)
    outs = [[r for _, r in f.apply(_ops(pkg, ops))]
            for f, pkg in zip(fabs, (PORT, REF, PORT))]
    _assert_same(*fabs, outs)
    if cfg_kw is OVERFLOW:
        st = fabs[0].stats()
        assert st["overflow_reinits"] > 0 and st["tsu_evictions"] > 0


@pytest.mark.parametrize("seed,cfg_kw", [(0, SMALL), (1, MEDIUM)])
def test_read_batches_match_reference_host_and_array(seed, cfg_kw):
    """The two-phase batched read (hits first, then misses in op order)
    after a warm trace, with writes and fences between batches."""
    fabs = _three(cfg_kw)
    warm = random_trace(np.random.default_rng(seed + 100), 150, 4)
    for f, pkg in zip(fabs, (PORT, REF, PORT)):
        f.apply(_ops(pkg, warm))
    outs = _drive_read_batches(fabs, seed)
    _assert_same(*fabs, outs)
    assert fabs[0].stats()["fast_read_batches"] == \
        fabs[1].stats()["fast_read_batches"]


@pytest.mark.parametrize("seed,cfg_kw", [(0, SMALL), (1, WRITEHOT)])
def test_write_storms_match_reference_host_and_array(seed, cfg_kw):
    fabs = _three(cfg_kw)
    outs = _drive_write_storms(fabs, seed)
    _assert_same(*fabs, outs)
    assert fabs[0].stats()["write_batches"] > 0


# ------------------------------------------------- unit scenarios, mirrored
def sc_submit_drains_fifo(m):
    """test_writeq: drains FIFO only past max_in_flight."""
    fab = m.TSUFabric(m.FabricConfig(n_shards=1, max_in_flight=2, wr_lease=4))
    q = m.WriteQueue(fab)
    drained = []
    for i in range(5):
        q.submit(f"k{i}", i, on_complete=lambda g, i=i: drained.append(i))
    assert drained == [0, 1, 2] and len(q) == 2
    q.flush()
    assert drained == [0, 1, 2, 3, 4] and len(q) == 0
    assert fab.stats.write_throughs == 5
    return drained, fab.stats.to_dict()


def sc_fence_nonempty_queue(m):
    """test_writeq: a fence over a non-empty queue drains, then jumps."""
    fab = m.TSUFabric(m.FabricConfig(n_shards=1, max_in_flight=4, wr_lease=4))
    q = m.WriteQueue(fab)
    ahead = m.SharedCache(fab, node_id=0)
    laggard = m.SharedCache(fab, node_id=0)
    grants = []
    for i in range(3):
        q.submit(f"k{i}", i, on_complete=grants.append)
    assert len(q) == 3 and not grants
    ahead.cts = 100
    cts = q.fence()
    assert len(q) == 0 and len(grants) == 3
    wtss = [g.wts for g in grants]
    assert wtss == sorted(wtss)
    assert cts == ahead.cts == laggard.cts == 100
    assert fab.stats.fences == 1 and fab.stats.write_throughs == 3
    assert fab.memts("k2") >= grants[-1].rts
    return [tuple(g) for g in grants], cts, fab.stats.to_dict()


def sc_max_in_flight_zero(m):
    fab = m.TSUFabric(m.FabricConfig(n_shards=1, max_in_flight=0))
    q = m.WriteQueue(fab)
    for i in range(4):
        q.submit(f"k{i}", i)
        assert len(q) == 0
    assert fab.stats.write_throughs == 4
    return fab.stats.to_dict()


def sc_fig5_plus_one(m):
    """test_fabric: a write from memts=m grants wts=m+1, rts=m+wr."""
    fabric = m.TSUFabric(m.FabricConfig(n_shards=1, wr_lease=5, rd_lease=10))
    g1, g2, g3 = fabric.write("x", "a"), fabric.write("x", "b"), \
        fabric.read("x")
    assert (g1.wts, g1.rts, g2.wts, g2.rts, g3.wts, g3.rts) == \
        (1, 5, 6, 10, 10, 20)
    assert fabric.memts("x") == 20
    return [tuple(g) for g in (g1, g2, g3)]


def sc_shard_routing(m):
    f1 = m.TSUFabric(m.FabricConfig(n_shards=8))
    keys = [f"key/{i}" for i in range(256)]
    routes = [f1.shard_of(k) for k in keys]
    assert routes == [m.stable_hash(k) % 8 for k in keys]
    assert len(set(routes)) == 8
    for k in keys:
        f1.write(k, k)
        assert k in f1.shards[f1.shard_of(k)].entries
    return routes


def sc_victim_eviction(m):
    fabric = m.TSUFabric(m.FabricConfig(n_shards=1, tsu_capacity=4,
                                        wr_lease=4))
    for i in range(8):
        fabric.write(f"k{i}", i)
    assert len(fabric.shards[0].entries) == 4
    assert fabric.stats.tsu_evictions == 4
    assert fabric.write("k0", "again").wts == 1
    return sorted(fabric.entries()), fabric.stats.to_dict()


def sc_overflow_reinit_host_stores(m):
    store = m.AuthoritativeStore(rd_lease=8, wr_lease=5000)
    for i in range(40):
        store.write("p", i)
    assert store.blocks["p"].memts <= m.protocol.TS_MAX
    assert store.fabric.stats.overflow_reinits >= 2
    big = m.TSUFabric(m.FabricConfig(n_shards=1, rd_lease=m.protocol.TS_MAX))
    big.write("x", 0)
    big.read("x")
    g = big.read("x")
    assert big.memts("x") <= m.protocol.TS_MAX and g.rts <= m.protocol.TS_MAX
    return store.blocks["p"].memts, tuple(g), store.fabric.stats.to_dict()


def _two_tier(m, rd=8, wr=4, **kw):
    fabric = m.TSUFabric(m.FabricConfig(
        n_shards=4, rd_lease=rd, wr_lease=wr,
        max_in_flight=kw.pop("max_in_flight", 0), **kw))
    node = m.SharedCache(fabric, node_id=0)
    return fabric, node, m.ReplicaCache(node)


def sc_lease_expiry_refetch(m):
    fabric, node, r = _two_tier(m)
    w = m.ReplicaCache(node)
    w.put("p", "v1")
    assert r.get("p")[0] == "v1"
    w.put("p", "v2")
    mm_before = fabric.stats.l2_to_mm
    assert r.get("p")[0] == "v1" and fabric.stats.l2_to_mm == mm_before
    r.cts = node.cts = fabric.memts("p") + 1
    assert r.get("p")[0] == "v2"
    assert r.stats.coh_miss_l1 >= 1 and fabric.stats.inval_msgs == 0
    return r.stats.to_dict(), fabric.stats.to_dict()


def sc_replica_miss_hits_node_tier(m):
    fabric, node, r1 = _two_tier(m)
    r2 = m.ReplicaCache(node)
    r1.put("p", "v1")
    mm_before = fabric.stats.l2_to_mm
    assert r2.get("p")[0] == "v1" and fabric.stats.l2_to_mm == mm_before
    assert r2.stats.l2_hits == 1 and r2.stats.compulsory == 1
    return r2.stats.to_dict()


def sc_capacity_eviction(m):
    fabric = m.TSUFabric(m.FabricConfig(n_shards=1, replica_sets=1,
                                        replica_ways=2, max_in_flight=0))
    r = m.ReplicaCache(m.SharedCache(fabric))
    for i in range(4):
        r.put(f"k{i}", i)
    assert r.stats.capacity_evictions >= 2
    assert r.get("k3")[0] == 3 and r.stats.l1_hits == 1
    return r.stats.to_dict()


def sc_write_queue_bounded_and_fence(m):
    fabric = m.TSUFabric(m.FabricConfig(n_shards=2, max_in_flight=4))
    node = m.SharedCache(fabric)
    r = m.ReplicaCache(node)
    for i in range(3):
        r.put(f"k{i}", i)
    assert len(node.queue) == 3 and fabric.memts("k0") == 0
    assert r.get("k0")[0] == 0                   # store-buffer forwarding
    for i in range(3, 8):
        r.put(f"k{i}", i)
    assert len(node.queue) == 4 and fabric.memts("k0") > 0
    fabric.barrier()
    assert len(node.queue) == 0 and fabric.stats.fences == 1
    return [fabric.memts(f"k{i}") for i in range(8)], fabric.stats.to_dict()


def sc_fence_jumps_clocks(m):
    fabric, node, r1 = _two_tier(m)
    r2 = m.ReplicaCache(node)
    r1.put("p", "v1")
    assert r1.cts > r2.cts
    fabric.barrier()
    assert r2.cts == r1.cts == node.cts
    assert r2.get("p")[0] == "v1"
    return r1.cts, r2.stats.to_dict()


def sc_stats_engine_view(m):
    names = {f.name for f in dataclasses.fields(m.FabricStats)}
    assert set(m.engine.COUNTERS) <= names
    fabric, node, r = _two_tier(m)
    r.put("a", 1)
    r.get("a")
    view = fabric.stats.engine_view()
    assert list(view) == list(m.engine.COUNTERS)
    assert view["writes"] == 1 and view["reads"] == 1
    assert view["wb_evictions"] == 0 and view["inval_msgs"] == 0
    return view


def sc_kv_lease_adapters(m):
    store = m.AuthoritativeStore(rd_lease=8, wr_lease=4)
    kv = m.LeaseKVCache(store, capacity=16)
    kv.put("p", "v1")
    assert store.fabric.stats.write_throughs == 1
    assert kv.get("p")[0] == "v1" and kv.stats["hits"] == 1
    assert store.blocks["p"].version == 1
    wts, rts = store.write("p", "v2")
    assert wts == store.blocks["p"].memts - 4 + 1
    kv.cts = store.blocks["p"].memts + 1      # reader fence
    assert kv.get("p")[0] == "v2"
    return (wts, rts), kv.stats, store.read("p"), kv.fabric_stats.to_dict()


def sc_store_lease_conflict(m):
    fabric = m.TSUFabric(m.FabricConfig(n_shards=1, rd_lease=8, wr_lease=4))
    with pytest.raises(ValueError, match="conflict"):
        m.AuthoritativeStore(rd_lease=100, fabric=fabric)
    return m.AuthoritativeStore(rd_lease=8, wr_lease=4,
                                fabric=fabric).rd_lease


def sc_registrations_weak(m):
    fabric = m.TSUFabric(m.FabricConfig(n_shards=1, max_in_flight=0))
    node = m.SharedCache(fabric)
    r = m.ReplicaCache(node)
    r.put("k", 1)
    del r, node
    gc.collect()
    assert fabric.barrier() == 0
    assert not fabric._caches and not fabric._queues
    return fabric.stats.to_dict()


def sc_pending_version_none(m):
    fabric = m.TSUFabric(m.FabricConfig(n_shards=1, max_in_flight=4))
    r = m.ReplicaCache(m.SharedCache(fabric))
    r.put("k", "v")
    assert r.get("k") == ("v", None)
    r.fence()
    assert r.get("k") == ("v", 1)
    return r.stats.to_dict()


SCENARIOS = [sc_submit_drains_fifo, sc_fence_nonempty_queue,
             sc_max_in_flight_zero, sc_fig5_plus_one, sc_shard_routing,
             sc_victim_eviction, sc_overflow_reinit_host_stores,
             sc_lease_expiry_refetch, sc_replica_miss_hits_node_tier,
             sc_capacity_eviction, sc_write_queue_bounded_and_fence,
             sc_fence_jumps_clocks, sc_stats_engine_view,
             sc_kv_lease_adapters, sc_store_lease_conflict,
             sc_registrations_weak, sc_pending_version_none]


@pytest.mark.parametrize("scenario", SCENARIOS,
                         ids=[s.__name__[3:] for s in SCENARIOS])
def test_host_objects_match_reference(scenario):
    assert scenario(PORT) == scenario(REF)


def test_drain_inside_scan_matches_port_host():
    """test_writeq: drains fired inside the array op scan (pushes past
    max_in_flight mid-trace) match the port's host queue exactly."""
    host = PORT.HostFabric(PORT.FabricConfig(**SMALL), 2, 2)
    arr = TF.ArrayFabric(TF.FabricConfig(**SMALL), 2, 2, device="cpu")
    ops = [TF.Op("write", KEYS[i % 4], f"v{i}", replica=i % 3)
           for i in range(12)]
    ops += [TF.Op("fence")] + [TF.Op("read", k, replica=1) for k in KEYS[:4]]
    assert host.apply(ops) == arr.apply(ops)
    assert _observe(host) == _observe(arr)
    assert host.stats()["write_throughs"] == 12


def test_ring_wraparound_matches_port_host():
    """test_writeq: the array ring (max_in_flight + 2 slots) wraps its head
    many times and stays equal to the port's host deque."""
    host = PORT.HostFabric(PORT.FabricConfig(**SMALL), 2, 2)
    arr = TF.ArrayFabric(TF.FabricConfig(**SMALL), 2, 2, device="cpu")
    rng = np.random.default_rng(23)
    pushes = 0
    for c in range(12):
        items = [(KEYS[int(rng.integers(len(KEYS)))], f"w{c}.{i}")
                 for i in range(int(rng.integers(1, 5)))]
        pushes += len(items)
        for b in (host, arr):
            b.write_batch(items, replica=int(c % 2))
        if c % 4 == 3:
            for b in (host, arr):
                b.fence()
    assert pushes > 4 * 4
    assert 0 <= int(arr._af.wq_head[0]) < 4
    assert 0 <= int(arr._af.wq_len[0]) <= 2
    assert _observe(host) == _observe(arr)
