"""The port's ``ShardedArrayFabric`` in gloo worlds on the CPU, bit for bit
against ``repro``'s ``HostFabric`` and the port's single-device
``ArrayFabric``.

Each world (1, 2, 4 and 8 ranks over 8 TSU shards; the world of two also
runs ``OVERFLOW`` on 2 shards) is spawned once: every rank runs
``tests/torch_sharded_worker.py``, which imports only ``torch`` and
``repro_torch``, drives the reference suites' scripts
(``tests/test_fabric_parity.py``'s traces, configurations and read-batch
helper) through the sharded fabric under both pipelines, and pickles per
call its results, its ``c10d`` collectives (``obs.xprof``) and its TSU
shapes.  This process runs ``HostFabric`` and ``ArrayFabric`` on the same
scripts and compares.  A world joins within ``WORLD_TIMEOUT_S``, its
ranks' collectives time out after ``torch_sharded_worker.TIMEOUT_S``;
either fails the test.  The ``c10d`` layer's counts: one collective per
TSU-touching pass under ``pipeline="batched"``, none for an all-hit read
batch, at least one per TSU-touching op under ``pipeline="scan"``.
"""
import os
import pathlib
import pickle
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from repro.coherence.fabric import FabricConfig as RConfig
from repro.coherence.fabric import HostFabric
from repro.coherence.fabric import Op as ROp
from repro_torch.coherence.fabric import ArrayFabric, FabricConfig, Op
from repro_torch.coherence.fabric import backend as TB
from repro_torch.coherence.kv_lease import BatchedKVLease

from test_fabric_parity import KEYS, MEDIUM, OVERFLOW, SMALL, random_trace
from torch_sharded_worker import run_script

ROOT = pathlib.Path(__file__).resolve().parent.parent
WORKER = ROOT / "tests" / "torch_sharded_worker.py"
WORLD_TIMEOUT_S = 300
WORLDS = (1, 2, 4, 8)
N_SHARDS = 8
N_NODES, RPN = 2, 2
# the TSU-touching op kinds: each issues at least one collective under
# pipeline="scan" (a read may reach the TSU; the scan cannot know first)
TSU_KINDS = ("read", "mm_write", "publish", "mm_read")


def _rows(ops):
    return [(o.kind, o.key, o.value, o.replica, o.node, o.wr_lease)
            for o in ops]


def _read_batches(seed, n_calls, batch=24, n_replicas=4):
    """``test_fabric_parity._drive_read_batches`` as script steps: mixed
    hit/miss/duplicate read batches with a fresh key each, a write
    between calls, a fence every second call."""
    rng = np.random.default_rng(seed)
    steps = []
    for c in range(n_calls):
        ks = [KEYS[int(rng.integers(len(KEYS)))] for _ in range(batch)]
        ks.append(f"fresh{c}")
        steps.append(("read_batch", ks, int(rng.integers(n_replicas))))
        steps.append(("write", KEYS[int(rng.integers(len(KEYS)))],
                      f"w{seed}.{c}", 0))
        if c % 2:
            steps.append(("fence",))
    return steps


def _all_hit_steps(rep=1):
    """``test_fast_read_batches_in_stats``: fill a replica, then read the
    same keys again — a batch every key of which is a lease hit."""
    return [("write_batch", [(k, f"{k}@hit") for k in KEYS[:4]], rep),
            ("fence",), ("read_batch", KEYS[:4], rep),
            ("read_batch", KEYS[:4], rep)]


def _scenarios(world):
    """The scripts of ``test_fabric_parity._sharded_multidevice_check`` and
    ``test_batched_pipeline_mixed_batch_parity`` at 8 shards, plus
    ``OVERFLOW`` on 2 shards in the world of two."""
    tail = [("memts", KEYS), ("stats",)]
    small = ([("apply", _rows(random_trace(np.random.default_rng(11), 220,
                                           4)))] + tail
             + [("read_batch", [KEYS[i % len(KEYS)] for i in range(24)]
                 + ["missing-key"], 1), ("stats",)]
             + _read_batches(21, 3) + _all_hit_steps() + tail)
    storms = [("write_batch", [(KEYS[(i * 3 + j) % len(KEYS)], f"s{j}.{i}")
                               for i in range(6)], j % 4) for j in range(4)]
    medium = ([("apply", _rows(random_trace(np.random.default_rng(100), 150,
                                            4)))]
              + _read_batches(0, 6) + storms + [("fence",)]
              + [("read_batch", KEYS + ["fresh-m"], 2)] + _all_hit_steps(3)
              + tail)
    out = [{"name": "small", "cfg": dict(SMALL, n_shards=N_SHARDS),
            "n_nodes": N_NODES, "rpn": RPN, "script": small},
           {"name": "medium", "cfg": dict(MEDIUM, n_shards=N_SHARDS),
            "n_nodes": N_NODES, "rpn": RPN, "script": medium}]
    if world == 2:
        ops = random_trace(np.random.default_rng(12), 150, 2,
                           wr_choices=(None, 1, 30000), n_nodes=1)
        out.append({"name": "overflow", "cfg": dict(OVERFLOW, n_shards=2),
                    "n_nodes": 1, "rpn": 2,
                    "script": [("apply", _rows(ops))] + tail
                    + [("read_batch", KEYS, 1), ("stats",)]})
    return out


_WORLDS = {}
_EXPECTED = {}


def _spawn(world, tmp):
    """Run ``world`` ranks of the worker; every rank's pickled results, or
    a failure with the ranks' stderr."""
    tmp.mkdir(parents=True, exist_ok=True)
    job = tmp / "job.pkl"
    job.write_bytes(pickle.dumps({"scenarios": _scenarios(world)}))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    procs, errs = [], []
    for r in range(world):
        errs.append(open(tmp / f"err{r}.txt", "w"))
        procs.append(subprocess.Popen(
            [sys.executable, str(WORKER), str(r), str(world),
             str(tmp / "rdzv"), str(job), str(tmp / f"out{r}.pkl")],
            env=env, cwd=str(ROOT), stdout=subprocess.DEVNULL,
            stderr=errs[-1]))
    deadline = time.monotonic() + WORLD_TIMEOUT_S
    try:
        while any(p.poll() is None for p in procs):
            if any(p.returncode not in (None, 0) for p in procs):
                break
            if time.monotonic() > deadline:
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for f in errs:
            f.close()
    bad = [(r, p.returncode) for r, p in enumerate(procs) if p.returncode]
    if bad:
        tails = "\n".join(f"--- rank {r} (rc {rc}) ---\n"
                          + (tmp / f"err{r}.txt").read_text()[-3000:]
                          for r, rc in bad)
        pytest.fail(f"world of {world}: ranks failed or timed out "
                    f"after {WORLD_TIMEOUT_S} s\n{tails}")
    return [pickle.loads((tmp / f"out{r}.pkl").read_bytes())
            for r in range(world)]


@pytest.fixture(scope="module")
def world_of(tmp_path_factory):
    def get(world):
        if world not in _WORLDS:
            _WORLDS[world] = _spawn(world,
                                    tmp_path_factory.mktemp(f"world{world}"))
        return _WORLDS[world]
    return get


def expected(sc):
    """``HostFabric`` (the oracle) and the port's single-device fabric on
    one scenario's script; ``all_hit[i]``: step ``i`` was a read batch the
    replica tier served alone (the oracle's ``fast_read_batches`` moved)."""
    key = (sc["name"], repr(sc["cfg"]))
    if key not in _EXPECTED:
        host = HostFabric(RConfig(**sc["cfg"]), n_nodes=sc["n_nodes"],
                          replicas_per_node=sc["rpn"])
        arr = ArrayFabric(FabricConfig(**sc["cfg"]), n_nodes=sc["n_nodes"],
                          replicas_per_node=sc["rpn"], device="cpu")
        all_hit = []

        def step(fn):
            before = host.stats()["fast_read_batches"]
            out = fn()
            all_hit.append(host.stats()["fast_read_batches"] > before)
            return out

        _EXPECTED[key] = {
            "host": run_script(host, sc["script"], ROp, step),
            "host_log": list(host.grant_log), "all_hit": all_hit,
            "array": run_script(arr, sc["script"], Op),
            "array_log": list(arr.grant_log),
            "array_export": arr.export_state()}
    return _EXPECTED[key]


def _same_export(a, b) -> bool:
    (x, hx), (y, hy) = a, b
    hx, hy = dict(hx), dict(hy)
    return (set(x) == set(y) and all(np.array_equal(x[k], y[k]) for k in x)
            and np.array_equal(hx.pop("meta"), hy.pop("meta")) and hx == hy)


# ------------------------------------------------------------------ parity
@pytest.mark.parametrize("world", WORLDS)
def test_sharded_matches_host_and_single_device(world, world_of):
    """Per-call results (read batches included), the grant log, ``stats()``
    and every ``replica_stats`` (the script's "stats" steps) and every
    key's ``memts``: the sharded fabric on every rank == ``HostFabric`` ==
    the port's ``ArrayFabric``."""
    ranks = world_of(world)
    for sc in _scenarios(world):
        if sc["name"] == "overflow":
            continue
        want = expected(sc)
        assert want["host"] == want["array"]
        assert want["host_log"] == want["array_log"]
        for r, res in enumerate(ranks):
            got = res["scenarios"][sc["name"]]["batched"]
            assert got["outs"] == want["host"], (sc["name"], r)
            assert got["grant_log"] == want["host_log"], (sc["name"], r)
            final_stats = got["outs"][-1][0]
            assert final_stats["bytes_inter_gpu"] > 0
            assert final_stats["write_batches"] > 0
            assert final_stats["fast_read_batches"] > 0


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_state_equals_single_device(world, world_of):
    """The whole state (``export_state``: every leaf of the full TSU table,
    tiers, rings, counters, and the host tables) equals the single-device
    fabric's after the same script, under both pipelines, on every
    rank."""
    for res in world_of(world):
        for sc in _scenarios(world):
            want = expected(sc)["array_export"]
            for pipe in ("batched", "scan"):
                got = res["scenarios"][sc["name"]][pipe]["export"]
                assert _same_export(got, want), (sc["name"], pipe)


@pytest.mark.parametrize("world", WORLDS)
def test_batched_pipeline_equals_scan(world, world_of):
    """``pipeline="batched"`` (one gather a pass) and ``pipeline="scan"``
    (one broadcast a TSU-touching op) give the same results, grant log
    and counters."""
    for res in world_of(world):
        for sc in _scenarios(world):
            b = res["scenarios"][sc["name"]]["batched"]
            s = res["scenarios"][sc["name"]]["scan"]
            assert b["outs"] == s["outs"], sc["name"]
            assert b["grant_log"] == s["grant_log"], sc["name"]


def test_sharded_overflow_two_ranks(world_of):
    """``OVERFLOW`` on 2 shards over 2 ranks: forced 16-bit reinits and
    victim evictions in a 2-entry TSU, equal to the oracle."""
    sc = next(s for s in _scenarios(2) if s["name"] == "overflow")
    want = expected(sc)
    assert want["host"] == want["array"]
    for res in world_of(2):
        for pipe in ("batched", "scan"):
            got = res["scenarios"]["overflow"][pipe]
            assert got["n_shard_devices"] == 2
            assert got["outs"] == want["host"], pipe
            assert got["grant_log"] == want["host_log"], pipe
    stats = want["host"][-1][0]
    assert stats["overflow_reinits"] > 0 and stats["tsu_evictions"] > 0


# ------------------------------------------------------------ placement
@pytest.mark.parametrize("world", WORLDS)
def test_owned_rows_between_batches(world, world_of):
    """After every call each rank holds only its ``n_shards/D`` rows of
    the TSU table."""
    for res in world_of(world):
        for sc in _scenarios(world):
            rows = sc["cfg"]["n_shards"] // world
            cap = sc["cfg"]["tsu_capacity"] + 1
            want = {k: (rows, 1, cap) for k in
                    ("tsu.tag", "tsu.memts", "tsu_ver", "tsu_gseq",
                     "tsu_seq")}
            want["tsu_nseq"] = (rows,)
            for pipe in ("batched", "scan"):
                got = res["scenarios"][sc["name"]][pipe]
                assert got["n_shard_devices"] == (
                    world if sc["name"] != "overflow" else 2)
                assert all(s == want for s in got["shapes"]), \
                    (sc["name"], pipe)


@pytest.mark.parametrize("world", WORLDS)
def test_collective_counts_at_the_c10d_layer(world, world_of):
    """Batched: exactly one ``allgather_`` per TSU-touching pass (the op
    scan of ``apply``/``write``, a read batch with misses, the write and
    fence passes), none for an all-hit read batch or a view (``memts``,
    ``stats``).  Scan: at least one collective per TSU-touching op."""
    one = {"total": 1, "by_op": {"allgather_": 1}}
    none = {"total": 0, "by_op": {}}
    for res in world_of(world):
        for sc in _scenarios(world):
            all_hit = expected(sc)["all_hit"]
            got = res["scenarios"][sc["name"]]
            # OVERFLOW's one-set replica tier never serves a whole batch
            assert any(all_hit) or sc["name"] == "overflow"
            for i, step in enumerate(sc["script"]):
                c = got["batched"]["counts"][i]
                if step[0] in ("memts", "stats") or all_hit[i]:
                    assert c == none, (sc["name"], i, step[0], c)
                else:
                    assert c == one, (sc["name"], i, step[0], c)
                if step[0] == "apply":
                    s = got["scan"]["counts"][i]
                    n = sum(r[0] in TSU_KINDS for r in step[1])
                    assert s["total"] >= n > 0, (sc["name"], i, s)
                    assert set(s["by_op"]) == {"broadcast_"}, s


@pytest.mark.parametrize("world", (2, 4, 8))
def test_indivisible_group_raises(world, world_of):
    """``n_shards`` not divisible by an explicit group's size raises."""
    for res in world_of(world):
        assert "divisible" in res["misc"]["indivisible"]


@pytest.mark.parametrize("world", WORLDS)
def test_fabric_group_takes_the_largest_dividing_rank_count(world,
                                                            world_of):
    """``make_fabric_group(n)``: the largest leading run of ranks whose
    count divides ``n``; ranks past it are outside the group."""
    for rank, res in enumerate(world_of(world)):
        for n, size in res["misc"]["group_sizes"].items():
            d = max(k for k in range(1, world + 1) if n % k == 0)
            assert size == (d if rank < d else None), (n, rank, size)


@pytest.mark.parametrize("world", WORLDS)
def test_default_fabric_and_kv_lease_under_a_group(world, world_of):
    """``default_fabric`` picks the sharded fabric when the shards spread
    over more than one rank; ``BatchedKVLease`` reaches it through its
    normal entry points with the single-device fabric's answers; ``None``
    as the device still needs CUDA under a group."""
    single = BatchedKVLease(ArrayFabric(FabricConfig(), device="cpu"))
    single.put_batch([(f"kv{i}", f"v{i}") for i in range(6)])
    single.fence()
    want = single.get_batch([f"kv{i}" for i in range(6)])
    d4 = max(k for k in range(1, world + 1) if 4 % k == 0)
    for rank, res in enumerate(world_of(world)):
        m = res["misc"]
        assert m["default"] == (("ShardedArrayFabric", world) if world > 1
                                else ("ArrayFabric", None))
        kind = ("ShardedArrayFabric" if d4 > 1 and rank < d4
                else "ArrayFabric")
        assert m["kv"] == (kind, want, single.fabric_stats)
        assert "CUDA" in m["resolve_none"] and m["resolve_cpu"] == "cpu"
        assert res["modules"] == [], "a rank imported jax or repro"


# ------------------------------------------------------------- devices
@pytest.mark.parametrize("local_rank,count,want", [
    (None, 1, "cuda:0"), ("1", 1, "cuda:0"), ("1", 2, "cuda:1"),
    ("0", 4, "cuda:0"), (None, 2, "cuda:1"), ("3", 2, None)])
def test_resolve_device_under_a_group(local_rank, count, want, monkeypatch):
    """Under an initialised group ``None`` is the rank's own card,
    ``cuda:LOCAL_RANK`` (the group rank without ``LOCAL_RANK``), and
    ``cuda:0`` for every rank of a one-card host; a rank past the cards
    raises.  Without a group it stays ``cuda``; without CUDA it raises and
    never falls back to the CPU."""
    monkeypatch.setattr(TB.torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(TB.torch.cuda, "device_count", lambda: count)
    assert TB.resolve_device(None) == torch.device("cuda")
    monkeypatch.setattr(TB.dist, "is_initialized", lambda: True)
    monkeypatch.setattr(TB.dist, "get_rank", lambda group=None: 1)
    if local_rank is None:
        monkeypatch.delenv("LOCAL_RANK", raising=False)
    else:
        monkeypatch.setenv("LOCAL_RANK", local_rank)
    if want is None:
        with pytest.raises(RuntimeError, match="no card"):
            TB.resolve_device(None)
    else:
        assert TB.resolve_device(None) == torch.device(want)
    assert TB.resolve_device("cpu") == torch.device("cpu")
    monkeypatch.setattr(TB.torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        TB.resolve_device(None)
