#!/usr/bin/env python3
"""``rmsnorm_bwd``'s two launches and its block count, on one H100.

    python3 scripts/rmsnorm_bwd_blocks.py

At smollm-360m's training shape (R = 4096 rows of D = 960), bf16 and
f32: each launch's device time under ``torch.profiler`` (the row pass,
``rmsnorm_bwd_reg``, and dw's sum over the per-block partial rows,
``rmsnorm_bwd_dw``), then the whole call's CUDA-event time (as
``chip_smoke.py`` phase 2 times it) with the block count that
``rmsnorm_bwd_plan`` picks replaced by each of ``BLOCKS``; dx must not
change and dw must stay within 1e-4 of the planned call's.

Needs a CUDA card; prints the card's name and power limit first.
"""
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

BLOCKS = (66, 132, 264, 396, 512)


def main() -> None:
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    from repro_torch.kernels import rmsnorm as rm

    if not torch.cuda.is_available():
        sys.exit("rmsnorm_bwd_blocks: needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    dev = torch.device("cuda")
    planned = rm.rmsnorm_bwd_plan
    R, D = 4096, 960
    try:
        for dtype in (torch.bfloat16, torch.float32):
            rng = np.random.default_rng(0)
            x, dy = (torch.from_numpy(rng.standard_normal((R, D)).astype(
                np.float32)).to(dev, dtype) for _ in range(2))
            w = torch.from_numpy(rng.standard_normal(D).astype(
                np.float32)).to(dev) * 0.1
            want_dx, want_dw = rm.rmsnorm_bwd(x, w, dy)
            G = planned(R, D, 16 // x.element_size(),
                        rm._n_sms(dev.index))[3]
            for _ in range(3):
                rm.rmsnorm_bwd(x, w, dy)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(20):
                    rm.rmsnorm_bwd(x, w, dy)
                torch.cuda.synchronize()
            parts = {name: sum(a.device_time_total for a in
                               prof.key_averages() if name in a.key) / 20
                     for name in ("rmsnorm_bwd_reg", "rmsnorm_bwd_rows",
                                  "rmsnorm_bwd_dw")}
            print(f"{dtype} planned G={G}: " + ", ".join(
                f"{k} {us:.2f} us" for k, us in parts.items() if us),
                flush=True)
            for blocks in BLOCKS:
                def plan(*a, blocks=blocks):
                    return (*planned(*a)[:3], blocks)
                rm.rmsnorm_bwd_plan = plan
                dx, dw = rm.rmsnorm_bwd(x, w, dy)
                if not torch.equal(dx, want_dx) or not torch.allclose(
                        dw, want_dw, rtol=1e-4, atol=1e-4):
                    raise AssertionError(f"G={blocks}: dx or dw differs")
                ms = cs.device_ms(torch, lambda: rm.rmsnorm_bwd(x, w, dy))
                print(f"{dtype} G={blocks}: {ms * 1e3:.2f} us", flush=True)
            rm.rmsnorm_bwd_plan = planned
    finally:
        rm.rmsnorm_bwd_plan = planned


if __name__ == "__main__":
    main()
