"""One rank of a gloo world that trains the port's smoke model with the
lease window and with synchronous data parallelism.

    python tests/torch_lease_worker.py RANK WORLD RDZV_FILE JOB OUT

``JOB`` is a pickle of ``{"arch", "seed", "seq", "windows": {W: n},
"dp_steps", "ckpt_dir"}``.  The rank initialises the model from ``seed``
(the port's init is a pure function of the seed and the leaf's path, so
every rank starts from the same weights) under the f32 policy, takes its
rows of each global batch (``DataConfig(host_index=rank,
host_count=world)``), and for each ``W`` runs ``n`` windows of
``coherence.lease_sync.make_lease_window_step`` over the fabric group,
counting each window's ``c10d`` collectives (``obs.xprof``); then a
``Trainer`` over the group for ``dp_steps`` steps.  It pickles the
parameters after every window, the counts and the trainer's losses,
events and fabric counters to ``OUT``.  It imports only ``torch`` and
``repro_torch``.
"""
from __future__ import annotations

import datetime
import os
import pickle
import sys

TIMEOUT_S = 120          # a collective that waits longer fails the rank


def f32(cfg):
    import dataclasses

    import torch
    return dataclasses.replace(cfg, policy=dataclasses.replace(
        cfg.policy, compute_dtype=torch.float32, cache_dtype=torch.float32))


def main(argv) -> None:
    rank, world = int(argv[1]), int(argv[2])
    rdzv, job_path, out_path = argv[3], argv[4], argv[5]
    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch import configs
    from repro_torch.coherence.lease_sync import (LeaseConfig,
                                                  make_lease_window_step)
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.launch.mesh import make_fabric_group
    from repro_torch.models import init_model
    from repro_torch.obs.xprof import collective_counts
    from repro_torch.optim import adamw
    from repro_torch.runtime.trainer import Trainer, TrainerConfig

    with open(job_path, "rb") as f:
        job = pickle.load(f)
    torch.set_num_threads(max(1, len(os.sched_getaffinity(0)) // world))
    dist.init_process_group(
        "gloo", init_method=f"file://{rdzv}", rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=TIMEOUT_S))
    group = make_fabric_group(world, backend="gloo")
    cfg = f32(configs.SMOKE[job["arch"]])
    data = SyntheticLM(cfg, DataConfig(global_batch=world,
                                       seq_len=job["seq"], host_index=rank,
                                       host_count=world))
    opt = adamw.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=20)
    res = {"windows": {}}
    for W, n in job["windows"].items():
        step = make_lease_window_step(cfg, opt, LeaseConfig(wr_lease=W),
                                      group=group)
        state = adamw.init_state(init_model(
            cfg, torch.Generator().manual_seed(job["seed"])))
        params, counts, losses = [], [], []
        for i in range(n):
            batches = {"tokens": np.stack([data.batch(i * W + w)["tokens"]
                                           for w in range(W)])}
            (state, loss), c = collective_counts(step, state, batches)
            counts.append(c)
            losses.append(loss)
            # copies: the next window's steps update these tensors in place
            params.append({k: v.numpy().copy()
                           for k, v in _flat(state.params)})
        res["windows"][W] = {"params": params, "counts": counts,
                             "losses": losses, "step": int(state.step)}
    tr = Trainer(cfg, opt, TrainerConfig(total_steps=job["dp_steps"],
                                         ckpt_period=2,
                                         ckpt_dir=f"{job['ckpt_dir']}/{rank}"),
                 data=data, device="cpu", group=group)
    # the trainer's step updates the state it is given in place: the
    # collectives are counted on a state of their own
    _, c = collective_counts(tr.step_fn, tr.init_state(job["seed"]),
                             data.batch(0))
    out = tr.run(state=tr.init_state(job["seed"]))
    res["dp"] = {"counts": c, "losses": out["losses"], "events": tr.events,
                 "stats": out["fabric_stats"],
                 "params": {k: v.numpy() for k, v in
                            _flat(out["state"].params)}}
    res["modules"] = sorted(m for m in sys.modules
                            if m.split(".")[0] in ("jax", "jaxlib", "repro"))
    dist.barrier()
    dist.destroy_process_group()
    with open(out_path, "wb") as f:
        pickle.dump(res, f)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, tree.detach()


if __name__ == "__main__":
    main(sys.argv)
