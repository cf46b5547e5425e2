#!/usr/bin/env python3
"""AdamW's update timed inside full-width training steps on the card,
with this tree's ``optim/adamw.py`` and with other copies of that file.

    python3 scripts/adamw_update_ab.py [NAME=PATH ...] [--out PATH]

Each ``NAME=PATH`` names an ``adamw.py`` to load beside this tree's, for
example the parent commit's (``mkdir -p build/ab/parent && git show
HEAD~1:src/repro_torch/optim/adamw.py > build/ab/parent/adamw.py``).
Its ``apply_updates`` is called as its own tree's ``make_train_step``
called it: with ``inplace=True`` where it takes that flag.  For each
model of MODELS, built as ``chip_smoke.py``'s phases 8 and 11 build it
(full width, seed 0, ``SyntheticLM`` batches), the arms run in the order
A B .. this this .. B A, each STEPS steps of ``Trainer.step_fn`` after
one warm step: the median wall ms of a step (to a sync), its host-enqueue
ms, and the update's ms inside the step (CUDA events around the call: it
includes the host's launch gaps where the device waits for them).  Then
each arm's update alone, on the state and random gradients, under
``torch.profiler``: device busy ms, wall and host-enqueue ms.  The bound
of the update is the larger of its bytes (params, m, v and the gradient
read once, params, m and v written once) over 3.35 TB/s and its ~20 f32
flops an element over 67 TF/s.  deepseek-v2-236b (2 layers, its bf16
policy) runs this tree's update only: the state and a new one beside it
do not fit the card.  Prints a line an arm and model and writes them as
JSON to ``--out`` (default ``build/adamw_update_ab.json``).  Needs one
card and about 5 minutes with the kernels' build.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import importlib.util
import inspect
import json
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

# (arch, layers, batch, seq, every arm): phase 8's smollm, hubert at its
# full 48 layers, phase 11's gemma3, and deepseek-v2
MODELS = (("smollm-360m", 32, 8, 512, True),
          ("hubert-xlarge", 48, 8, 512, True),
          ("gemma3-4b", 12, 4, 1536, True),
          ("deepseek-v2-236b", 2, 2, 512, False))
STEPS = 3
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
FLOPS_PER_ELEMENT = 20


def load(name, path):
    spec = importlib.util.spec_from_file_location(f"adamw_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod       # its dataclasses look it up
    spec.loader.exec_module(mod)
    fn = mod.apply_updates
    if "inplace" in inspect.signature(fn).parameters:
        return lambda cfg, state, grads: fn(cfg, state, grads, inplace=True)
    return fn


def bound_ms(state) -> dict:
    from repro_torch.optim import adamw
    n, nbytes = 0, 0
    for p, m, v in zip(*(adamw.tree_leaves(t)
                         for t in (state.params, state.m, state.v))):
        n += p.numel()
        # the gradient has the param's dtype
        nbytes += p.numel() * (3 * p.element_size() + 2 * m.element_size()
                               + 2 * v.element_size())
    b = nbytes / HBM_BYTES_PER_S * 1e3
    o = n * FLOPS_PER_ELEMENT / F32_FLOPS_PER_S * 1e3
    return {"elements": n, "bytes": nbytes, "bytes_ms": b, "ops_ms": o,
            "bound_ms": max(b, o), "bound_by": "bytes" if b >= o
            else "operations"}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("arms", nargs="*", help="NAME=PATH of an adamw.py")
    ap.add_argument("--out", default=str(ROOT / "build" /
                                         "adamw_update_ab.json"))
    args = ap.parse_args()
    import torch

    import chip_smoke as cs
    from repro_torch import configs
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.optim import adamw
    from repro_torch.runtime.trainer import Trainer, TrainerConfig

    if not torch.cuda.is_available():
        sys.exit("adamw_update_ab: needs a CUDA card")
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print("card:", card, flush=True)
    this = adamw.apply_updates
    others = {}
    for a in args.arms:
        name, path = a.split("=", 1)
        others[name] = load(name, path)
    timed = {}
    out = {"card": card, "models": {}}

    def spy(cfg, state, grads):
        e0, e1 = torch.cuda.Event(True), torch.cuda.Event(True)
        e0.record()
        new = timed["fn"](cfg, state, grads)
        e1.record()
        timed["events"].append((e0, e1))
        return new
    adamw.apply_updates = spy
    try:
        for arch, layers, B, S, every in MODELS:
            gc.collect()
            torch.cuda.empty_cache()
            cfg = dataclasses.replace(configs.get(arch), n_layers=layers)
            tr = Trainer(cfg, adamw.AdamWConfig(
                lr=1e-5, warmup_steps=2, total_steps=100), TrainerConfig(
                total_steps=100, ckpt_dir=str(ROOT / "build" / "ab_ckpt")),
                data=SyntheticLM(cfg, DataConfig(global_batch=B, seq_len=S)),
                device=dev)
            state = tr.init_state(0)
            batch = tr.data.batch(0)
            bound = bound_ms(state)
            names = list(others) if every else []
            order = names + ["this", "this"] + names[::-1]
            fns = {"this": this, **others}
            rows = {n: {"wall_ms": [], "host_ms": [], "update_ms": []}
                    for n in ["this"] + names}
            torch.cuda.reset_peak_memory_stats()
            for arm in order:
                timed["fn"] = fns[arm]
                timed["events"] = []
                state, m = tr.step_fn(state, batch)        # warm
                float(m["loss"])
                timed["events"] = []
                for _ in range(STEPS):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    state, m = tr.step_fn(state, batch)
                    t1 = time.perf_counter()
                    torch.cuda.synchronize()
                    t2 = time.perf_counter()
                    rows[arm]["host_ms"].append((t1 - t0) * 1e3)
                    rows[arm]["wall_ms"].append((t2 - t0) * 1e3)
                rows[arm]["update_ms"] += [a.elapsed_time(b)
                                           for a, b in timed["events"]]
                del m
            peak = torch.cuda.max_memory_allocated() / 1e9
            # the update alone, on random gradients in the params' dtype
            grads = adamw.tree_map(lambda p: torch.randn_like(p) * 1e-3,
                                   state.params)
            for arm in ["this"] + names:
                fn = fns[arm]

                def call():
                    # an out-of-place update's result is dropped
                    fn(tr.opt, state, grads)
                walls, hosts = [], []
                for _ in range(3):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    call()
                    hosts.append((time.perf_counter() - t0) * 1e3)
                    torch.cuda.synchronize()
                    walls.append((time.perf_counter() - t0) * 1e3)
                prof = cs.profile_calls(torch, call, 2)
                r = rows[arm]
                r.update(
                    step_wall_ms=statistics.median(r["wall_ms"]),
                    step_host_ms=statistics.median(r["host_ms"]),
                    update_in_step_ms=statistics.median(r["update_ms"]),
                    alone_wall_ms=statistics.median(walls),
                    alone_host_ms=statistics.median(hosts),
                    alone_device_ms=prof["device_ms_per_call"],
                    alone_top_kernels=prof["device_by_name"][:6])
                print(f"{arch} ({layers} layers, {B} x {S}, "
                      f"{bound['elements'] / 1e9:.3f} B parameters) "
                      f"{arm}: step wall {r['step_wall_ms']:.2f} ms, host "
                      f"enqueue {r['step_host_ms']:.2f} ms, the update in "
                      f"the step {r['update_in_step_ms']:.2f} ms; the "
                      f"update alone: device busy "
                      f"{r['alone_device_ms']:.2f} ms, wall "
                      f"{r['alone_wall_ms']:.2f} ms, host enqueue "
                      f"{r['alone_host_ms']:.2f} ms; bound "
                      f"{bound['bound_ms']:.2f} ms by {bound['bound_by']} "
                      f"({bound['bytes'] / 1e9:.2f} GB); peak of the steps "
                      f"{peak:.2f} GB; steps {[round(x, 2) for x in r['wall_ms']]}",
                      flush=True)
            out["models"][arch] = {"layers": layers, "batch": B, "seq": S,
                                   "bound": bound, "peak_gb": peak,
                                   "arms": rows}
            del tr, state, grads
    finally:
        adamw.apply_updates = this
    pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    pathlib.Path(args.out).write_text(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
