#!/usr/bin/env python3
"""Loss traces of ``chip_smoke.py``'s phase-11 models under several
learning rates, to choose the rate that phase trains at.

    python3 scripts/wide_train_lr_sweep.py [--out PATH]

hubert-xlarge (48 layers, 8 x 512 frames) and gemma3-4b (12 of 34 layers,
4 x 1536 tokens) at full width on the CUDA card, built as phase 11 builds
them (seed 0, ``SyntheticLM`` batches, ``Trainer.step_fn``, warmup 2 and
cosine decay over 6 steps).  Prints the untrained model's loss on each
of the 6 batches, then for each (peak rate, data) pair the 6 steps'
losses, each run from the same initial state: the data is either a fresh
batch each step, as phase 11 trains, or batch 0 at every step.  ``--out``
(default ``build/wide_train_lr_sweep.json``) keeps the traces as JSON.
Needs one card and about 5 minutes with the kernels' build.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))

MODELS = (("hubert-xlarge", 48, 8, 512), ("gemma3-4b", 12, 4, 1536))
STEPS, WARMUP = 6, 2
# (peak learning rate, the same batch at every step)
RUNS = ((1e-3, False), (3e-4, False), (1e-4, False), (3e-5, False),
        (1e-4, True), (3e-5, True), (1e-5, False), (1e-5, True))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=str(ROOT / "build" /
                                         "wide_train_lr_sweep.json"))
    args = ap.parse_args()
    import torch

    from repro_torch import configs
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.models.model import loss_fn
    from repro_torch.optim import adamw
    from repro_torch.runtime.trainer import Trainer, TrainerConfig

    if not torch.cuda.is_available():
        sys.exit("wide_train_lr_sweep: needs a CUDA card")
    dev = torch.device("cuda")
    out = {}
    for arch, layers, B, S in MODELS:
        cfg = dataclasses.replace(configs.get(arch), n_layers=layers)
        data = SyntheticLM(cfg, DataConfig(global_batch=B, seq_len=S))
        rows = {}
        for lr, same in RUNS:
            gc.collect()
            torch.cuda.empty_cache()
            tr = Trainer(cfg, adamw.AdamWConfig(
                lr=lr, warmup_steps=WARMUP, total_steps=STEPS),
                TrainerConfig(total_steps=STEPS,
                              ckpt_dir=str(ROOT / "build" / "sweep_ckpt")),
                data=data, device=dev)
            state = tr.init_state(0)
            if "untrained" not in rows:
                with torch.no_grad():
                    rows["untrained"] = [float(loss_fn(cfg, state.params, {
                        k: torch.from_numpy(v).to(dev)
                        for k, v in data.batch(i).items()})[0])
                        for i in range(STEPS)]
                print(arch, "untrained losses per batch",
                      [round(x, 4) for x in rows["untrained"]], flush=True)
            losses = []
            t0 = time.perf_counter()
            for step in range(STEPS):
                state, m = tr.step_fn(state, data.batch(0 if same else step))
                losses.append(float(m["loss"]))
            key = (f"lr={lr} warmup={WARMUP} "
                   + ("batch 0 each step" if same else "fresh batches"))
            rows[key] = losses
            print(arch, key, [round(x, 4) for x in losses],
                  f"{time.perf_counter() - t0:.1f} s", flush=True)
            del tr, state, m
        out[arch] = rows
    pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    pathlib.Path(args.out).write_text(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
