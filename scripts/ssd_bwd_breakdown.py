#!/usr/bin/env python3
"""Where ``ssd_chunk_bwd``'s time goes, on one H100.

    python3 scripts/ssd_bwd_breakdown.py

At the mamba2-130m and zamba2-1.2b training shapes (B = 8, nc = 2, Q =
256, P = 64; H = 24, N = 128 and H = 64, N = 64; bf16, B and C a stride-0
broadcast over the heads, the cotangents in f32), the call's CUDA-event
time (as ``chip_smoke.py`` phase 2 times it), then ten calls under
``torch.profiler``: each of its four launches' device time (the key pass
``ssd_bwd_key_kernel``, the query pass ``ssd_bwd_query_kernel``, the chunk
pass ``ssd_bwd_chunk_kernel``, the dA pass ``ssd_bwd_da_kernel``) per
call, and the f32 flops each pair pass does (two 64 x 64 tiles of dots a
visible tile pair, then its outer products) over that time.

Needs a CUDA card; prints the card's name and power limit first.
"""
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

SHAPES = (("mamba2-130m", (8, 2, 256, 24, 64, 128)),
          ("zamba2-1.2b", (8, 2, 256, 64, 64, 64)))
CALLS = 10


def main() -> None:
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    from repro_torch.kernels.ssd_chunk import ssd_chunk, ssd_chunk_bwd

    if not torch.cuda.is_available():
        sys.exit("ssd_bwd_breakdown: needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    dev = torch.device("cuda")
    for arch, (B, nc, Q, H, P, N) in SHAPES:
        args = cs.ssd_inputs(torch, np, dev, B, nc, Q, H, P, N,
                             torch.bfloat16, True, 1)
        rng = np.random.default_rng(2)
        T = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(
            np.float32)).to(dev)
        cot = (T(B, nc, Q, H, P), T(B, nc, H, N, P), T(B, nc, Q, H))
        cum = ssd_chunk(*args, out_dtype=torch.float32)[2]

        def call():
            return ssd_chunk_bwd(*args, cum, *cot)
        ms = cs.device_ms(torch, call)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(CALLS):
                call()
            torch.cuda.synchronize()
        parts = {}
        for e in prof.events():
            if e.device_type == DeviceType.CUDA and "ssd_bwd" in e.name:
                name = e.name.split("ssd_bwd_")[1].split("_kernel")[0]
                parts[name] = parts.get(name, 0.0) + \
                    e.time_range.elapsed_us() / CALLS
        tiles = Q // 64
        pairs = B * nc * H * tiles * (tiles + 1) // 2 * 64 * 64
        flops = {"key": pairs * (2 * N + 2 * P + 2 * P + 2 * N),
                 "query": pairs * (2 * N + 2 * P + 2 * N)}
        print(f"{arch} [{B}, {nc}, {Q}, {H}, {P}, {N}] bf16: the call "
              f"{ms * 1e3:.2f} us; per launch " + ", ".join(
                  f"{k} {v:.2f} us" + (f" ({flops[k] / v / 1e6:.1f} TF/s)"
                                       if k in flops else "")
                  for k, v in sorted(parts.items(), key=lambda kv: -kv[1])),
              flush=True)


if __name__ == "__main__":
    main()
