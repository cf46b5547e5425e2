#!/usr/bin/env python3
"""Where the tensor-core flash backward's time goes, on one H100.

    python3 scripts/flash_bwd_breakdown.py

Builds ``src/repro_torch/kernels/csrc/flash_attention_bwd_wgmma.cu`` as it
is and in variants with one part cut out or changed (the results of a cut
variant are wrong; only its time is read), into
``build/flash_bwd_breakdown/``, and times each kernel of the pair (dQ,
dK/dV) under ``torch.profiler`` at smollm-360m's training shape (B = 8,
S = 512, Hq = 15, Hkv = 5, causal, bf16) at D = 64 and 128, in turns:
every variant, then every variant again in reverse order.  The
difference to ``base`` is what that part costs:

- ``stages3``: a ring of three stages instead of two;
- ``serial_waits``: dQ waits for every group of products as soon as it
  is committed (no overlap of its arithmetic with the tensor cores; its
  schedule at D = 128, and dK/dV's at both);
- ``overlap``: dQ's overlapped schedule at D = 128 too (D = 64's);
- ``no_stats_copy``: the dK/dV producer copies no row statistics;
- ``no_softmax``: P = S and dS = dP (no ex2, no statistics read);
- ``no_lo``: P and dS rounded to bf16 once (the lo products cut);
- ``no_rs``: no dV, dK or dQ product (and so no P, dS or split).

Needs a CUDA card and nvcc; prints the card's name and power limit first.
"""
import ctypes
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

LIB = "flash_attention_bwd_wgmma"


def variants(src: str) -> dict:
    def patch(s, a, b):
        if a not in s:
            raise SystemExit(f"flash_bwd_breakdown: the source changed; no "
                             f"{a!r}")
        return s.replace(a, b)

    out = {"base": src,
           "stages3": patch(src, "kStages = 2;", "kStages = 3;"),
           "serial_waits": patch(src, "kOverlapDq = D == 64;",
                                 "kOverlapDq = false;"),
           "overlap": patch(src, "kOverlapDq = D == 64;",
                            "kOverlapDq = true;"),
           "no_stats_copy": patch(src, "const bool ok = i < Sq;",
                                  "const bool ok = false;")}
    v = patch(src, "sacc[i] = ex2((sc - m[r]) * sl) * il[r];",
              "sacc[i] = sc;")
    v = patch(v, "split(sacc[i] * (pacc[i] - dd[r]), sacc[i + 1] * "
              "(pacc[i + 1] - dd[r]),", "split(pacc[i], pacc[i + 1],")
    v = patch(v, "sacc[i] = ex2((sc - sv[c]) * sl) * sv[kTile + c];",
              "sacc[i] = sc;")
    out["no_softmax"] = patch(
        v, "split(sacc[i] * (pacc[i] - sv[2 * kTile + c]),\n"
        "            sacc[i + 1] * (pacc[i + 1] - sv[2 * kTile + c + 1]),",
        "split(pacc[i], pacc[i + 1],")
    lo = """#pragma unroll
  for (int kt = 0; kt < kTile / 16; ++kt)
    wgmma_rs<D>(acc, lo[kt],"""
    out["no_lo"] = patch(src, lo, lo.replace("kt < kTile / 16", "kt < 0"))
    v = patch(src, "product_rs<D>(dqa, hi, lo, ks);", "")
    v = patch(v, "product_rs<D>(dva, phi, plo, dos);", "")
    out["no_rs"] = patch(v, "product_rs<D>(dka, dhi, dlo, qs);", "")
    return out


def main() -> None:
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import cuda
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_bwd)

    if not torch.cuda.is_available():
        sys.exit("flash_bwd_breakdown: needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    out_dir = ROOT / "build" / "flash_bwd_breakdown"
    out_dir.mkdir(parents=True, exist_ok=True)
    for h in cuda.CSRC.glob("*.cuh"):
        (out_dir / h.name).write_text(h.read_text())
    procs = {}
    for name, text in variants((cuda.CSRC / f"{LIB}.cu").read_text()).items():
        src = out_dir / f"{name}.cu"
        src.write_text(text)
        so = out_dir / f"lib{name}.so"
        procs[name] = (subprocess.Popen(
            [cuda._nvcc(), *cuda.NVCC_FLAGS, "-o", str(so), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so)
    libs = {}
    for name, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            sys.exit(f"flash_bwd_breakdown: {name} did not build:\n"
                     f"{log[-4000:]}")
        regs = [ln.replace("ptxas info    :", "").strip()
                for ln in log.splitlines()
                if "registers" in ln or "spill" in ln]
        print(f"{name}: {'; '.join(regs)}", flush=True)
        libs[name] = ctypes.CDLL(str(so))

    dev = torch.device("cuda")

    def randn(shape, seed):
        a = np.random.default_rng(seed).standard_normal(shape)
        return torch.from_numpy(a.astype(np.float32)).to(dev, torch.bfloat16)

    def kernel_us(fn, n=20):
        """Device us a call of each kernel ``fn`` launches, by name."""
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        return {("dq" if "_dq<" in a.key else "dkdv"): a.device_time_total / n
                for a in prof.key_averages() if "flash_bwd_wgmma" in a.key}

    routed = cuda._LIBS.get(LIB)
    try:
        for D in (64, 128):
            B, S, Hq, Hkv = 8, 512, 15, 5
            q, k, v, do = (randn(s, i) for i, s in enumerate(
                ((B, S, Hq, D), (B, S, Hkv, D), (B, S, Hkv, D),
                 (B, S, Hq, D))))
            stats = torch.empty((2, B, Hq, S), dtype=torch.float32,
                                device=dev)
            o = flash_attention(q, k, v, causal=True, stats=stats)
            times = {n: [] for n in libs}
            for order in (list(libs), list(libs)[::-1]):
                for name in order:
                    cuda._LIBS[LIB] = libs[name]
                    times[name].append(kernel_us(lambda: flash_attention_bwd(
                        q, k, v, o, do, causal=True, stats=stats)))
            base = {p: sum(t[p] for t in times["base"]) / 2
                    for p in ("dq", "dkdv")}
            for name, ts in times.items():
                print(f"D={D} {name}: " + "; ".join(
                    f"{p} {ts[0][p]:.2f}, {ts[1][p]:.2f} us (base - this: "
                    f"{base[p] - (ts[0][p] + ts[1][p]) / 2:+.2f})"
                    for p in ("dq", "dkdv")), flush=True)
    finally:
        if routed is None:
            cuda._LIBS.pop(LIB, None)
        else:
            cuda._LIBS[LIB] = routed


if __name__ == "__main__":
    main()
