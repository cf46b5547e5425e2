"""One rank of a gloo world that drives the port's ``ShardedArrayFabric``.

    python tests/torch_sharded_worker.py RANK WORLD RDZV_FILE JOB OUT

``JOB`` is a pickle of ``{"scenarios": [...]}``; each scenario names a
fabric configuration and a script of fabric calls (plain tuples, see
``run_script``).  The rank runs every script through
``ShardedArrayFabric`` under both pipelines, counting the ``c10d``
collectives of each call with ``obs.xprof.collective_counts`` and the
shapes of its TSU leaves after it, runs the checks of the fabric group
and ``default_fabric`` in ``misc``, and pickles what it saw to ``OUT``.
The job's ``backend`` (default gloo) and ``device`` (default ``"cpu"``;
``None`` is the rank's card) say where the world runs; ``misc`` runs on
the CPU only.
It imports only ``torch`` and ``repro_torch``: the expected results come
from the parent test, which runs ``repro``'s ``HostFabric`` once.
"""
from __future__ import annotations

import datetime
import os
import pickle
import sys

TIMEOUT_S = 120          # a collective that waits longer fails the rank


def make_ops(op_cls, rows):
    """Script op tuples ``(kind, key, value, replica, node, wr_lease)`` as
    ``Op``s of either package."""
    return [op_cls(k, key, v, replica=r, node=n, wr_lease=wl)
            for k, key, v, r, n, wl in rows]


def run_script(fab, script, op_cls, step=None):
    """Drive ``fab`` through ``script`` and return each step's output:

      ("apply", rows)                  -> [result per op]
      ("read_batch", keys, replica)    -> read_batch's list
      ("write_batch", items, replica)  -> None
      ("write", key, value, replica)   -> None
      ("fence",)                       -> the jumped clock
      ("memts", keys)                  -> [memts per key]
      ("stats",)                       -> (stats, [replica_stats...])

    ``step(fn)`` runs each call (the worker counts collectives there)."""
    step = step or (lambda fn: fn())
    out = []
    for s in script:
        kind = s[0]
        if kind == "apply":
            ops = make_ops(op_cls, s[1])
            fn = lambda: [r for _, r in fab.apply(ops)]      # noqa: E731
        elif kind == "read_batch":
            fn = lambda s=s: fab.read_batch(s[1], replica=s[2])  # noqa: E731
        elif kind == "write_batch":
            fn = lambda s=s: fab.write_batch(s[1], replica=s[2])  # noqa: E731
        elif kind == "write":
            fn = lambda s=s: fab.write(s[1], s[2], replica=s[3])  # noqa: E731
        elif kind == "fence":
            fn = fab.fence
        elif kind == "memts":
            fn = lambda s=s: [fab.memts(k) for k in s[1]]  # noqa: E731
        elif kind == "stats":
            fn = lambda: (fab.stats(), [fab.replica_stats(r)  # noqa: E731
                                        for r in range(fab.n_replicas)])
        else:
            raise ValueError(f"unknown script step {kind!r}")
        out.append(step(fn))
    return out


def tsu_shapes(fab):
    a = fab._af
    return {"tsu.tag": tuple(a.tsu.tag.shape),
            "tsu.memts": tuple(a.tsu.memts.shape),
            "tsu_ver": tuple(a.tsu_ver.shape),
            "tsu_gseq": tuple(a.tsu_gseq.shape),
            "tsu_seq": tuple(a.tsu_seq.shape),
            "tsu_nseq": tuple(a.tsu_nseq.shape)}


def drive(fab, script, op_cls):
    """Run ``script`` counting each step's collectives; returns the
    outputs, the counts, the TSU shapes after each step and the final
    observables."""
    from repro_torch.obs.xprof import collective_counts
    counts, shapes = [], []

    def step(fn):
        out, c = collective_counts(fn)
        counts.append(c)
        shapes.append(tsu_shapes(fab))
        return out

    outs = run_script(fab, script, op_cls, step)
    arrays, host = fab.export_state()
    return {"outs": outs, "counts": counts, "shapes": shapes,
            "grant_log": list(fab.grant_log), "export": (arrays, host)}


def misc(world: int) -> dict:
    """The fabric group's divisor rule, the divisibility error,
    ``default_fabric``'s choice and the device rule under a group."""
    import torch.distributed as dist

    from repro_torch.coherence.fabric import (FabricConfig,
                                              ShardedArrayFabric,
                                              default_fabric)
    from repro_torch.coherence.fabric.backend import resolve_device
    from repro_torch.coherence.kv_lease import BatchedKVLease
    from repro_torch.launch.mesh import make_fabric_group

    out = {"group_sizes": {}}
    for n in (1, 2, 3, 5, 6, 8):
        g = make_fabric_group(n, backend="gloo")
        out["group_sizes"][n] = (dist.get_world_size(g)
                                 if g != dist.GroupMember.NON_GROUP_MEMBER
                                 else None)
    try:
        ShardedArrayFabric(FabricConfig(n_shards=world + 1, tsu_capacity=4),
                           group=dist.group.WORLD, device="cpu")
        out["indivisible"] = None
    except ValueError as e:
        out["indivisible"] = str(e)
    fab = default_fabric(FabricConfig(n_shards=8, tsu_capacity=4),
                         device="cpu")
    out["default"] = (type(fab).__name__,
                      getattr(fab, "n_shard_devices", None))
    kv = BatchedKVLease(device="cpu")         # 4 shards by default
    kv.put_batch([(f"kv{i}", f"v{i}") for i in range(6)])
    kv.fence()
    out["kv"] = (type(kv.backend).__name__, kv.get_batch(
        [f"kv{i}" for i in range(6)]), kv.fabric_stats)
    try:
        resolve_device(None)
        out["resolve_none"] = "no error"
    except RuntimeError as e:
        out["resolve_none"] = str(e)
    out["resolve_cpu"] = str(resolve_device("cpu"))
    return out


def main(argv) -> None:
    rank, world = int(argv[1]), int(argv[2])
    rdzv, job_path, out_path = argv[3], argv[4], argv[5]
    import torch
    import torch.distributed as dist

    from repro_torch.coherence.fabric import (FabricConfig, Op,
                                              ShardedArrayFabric)
    from repro_torch.launch.mesh import make_fabric_group
    with open(job_path, "rb") as f:
        job = pickle.load(f)
    backend, device = job.get("backend", "gloo"), job.get("device", "cpu")
    # ranks that share the host split its CPU threads
    torch.set_num_threads(max(1, len(os.sched_getaffinity(0)) // world))
    if backend == "nccl":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(
        backend, init_method=f"file://{rdzv}", rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=TIMEOUT_S))
    res = {"scenarios": {}}
    for sc in job["scenarios"]:
        group = make_fabric_group(sc["cfg"]["n_shards"], backend=backend)
        got = {}
        for pipe in ("batched", "scan"):
            fab = ShardedArrayFabric(FabricConfig(**sc["cfg"]),
                                     n_nodes=sc["n_nodes"],
                                     replicas_per_node=sc["rpn"],
                                     group=group, pipeline=pipe,
                                     device=device)
            got[pipe] = drive(fab, sc["script"], Op)
            got[pipe]["n_shard_devices"] = fab.n_shard_devices
            got[pipe]["device"] = str(fab.device)
        res["scenarios"][sc["name"]] = got
    if device == "cpu":
        res["misc"] = misc(world)
    res["modules"] = sorted(m for m in sys.modules
                            if m.split(".")[0] in ("jax", "jaxlib", "repro"))
    dist.barrier()
    dist.destroy_process_group()
    with open(out_path, "wb") as f:
        pickle.dump(res, f)


if __name__ == "__main__":
    main(sys.argv)
