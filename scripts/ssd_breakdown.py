#!/usr/bin/env python3
"""Where the tensor-core SSD kernel's time goes, on one H100.

    python3 scripts/ssd_breakdown.py

Builds ``src/repro_torch/kernels/csrc/ssd_chunk_wgmma.cu`` as it is and in
variants with one part cut out or swapped (the results of a cut variant
are wrong; only its time is read), into ``build/ssd_breakdown/``, and
times each with CUDA events at the mamba2-130m and zamba2-1.2b prefill
shapes (bf16, B and C a stride-0 broadcast, y in f32), in turns: every
variant, then every variant again in reverse order.  The difference to
``base`` is what that part costs:

- ``no_scan``: cum left at 0 (no serial cumsum);
- ``shuffle_scan``: the cumsum passed along warp 0's lanes by shuffles,
  one row a step (the kernel's first form of the scan);
- ``no_state``: no state pass;
- ``no_decay``: W = S (no exp, no dt);
- ``no_y_store``: y never stored;
- ``one_block_sm``: launch bounds for one block an SM (more registers).

Needs a CUDA card and nvcc; prints the card's name and power limit first.
"""
import ctypes
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

SCAN = """    for (int j0 = 0; j0 < scan_end; j0 += 16) {"""
SCAN_START = """  if (threadIdx.x == 0) {
    const float4* d4"""
SCAN_END = """  bar_sync(kConsumerBar, kConsumers);
  const long long chunk"""
SHUFFLE_SCAN = """  if (warp == 0) {
    float acc = 0.f;
#pragma unroll 1
    for (int j0 = 0; j0 < scan_end; j0 += 32) {
      const float p = __fmul_rn(dts[j0 + lane], a);
      float mine = 0.f;
#pragma unroll
      for (int l = 0; l < 32; ++l) {
        acc = __fadd_rn(acc, __shfl_sync(halcone::kAllLanes, p, l));
        mine = lane == l ? acc : mine;
      }
      if (j0 + lane < scan_end) cums[j0 + lane] = mine;
    }
  }
"""


def variants(src: str) -> dict:
    def patch(s, a, b):
        if a not in s:
            raise SystemExit(f"ssd_breakdown: the source changed; no {a!r}")
        return s.replace(a, b)

    scan0, scan1 = src.index(SCAN_START), src.index(SCAN_END)
    out = {"base": src,
           "no_scan": patch(src, SCAN, SCAN.replace("j0 < scan_end",
                                                    "j0 < 0")),
           "shuffle_scan": src[:scan0] + SHUFFLE_SCAN + src[scan1:],
           "no_state": patch(src, "const int n_state = qt == 0 ? "
                             "(Q + BK - 1) / BK : 0;",
                             "const int n_state = 0;"),
           "no_y_store": patch(src, "  if (r0 < Q) {\n    OT* yb",
                               "  if (r0 < 0) {\n    OT* yb"),
           "one_block_sm": patch(src, "__launch_bounds__(kThreads, "
                                 "Shape<N, P>::kBlocksPerSM)",
                                 "__launch_bounds__(kThreads, 1)")}
    v = patch(src, "float w0 = sacc[i] * ex2((ci[r] - cj.x) * kLog2e) * dj.x;",
              "float w0 = sacc[i];")
    out["no_decay"] = patch(v, "float w1 = sacc[i + 1] * ex2((ci[r] - cj.y) "
                            "* kLog2e) * dj.y;", "float w1 = sacc[i + 1];")
    return out


def main() -> None:
    import numpy as np
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import cuda
    from repro_torch.kernels.ssd_chunk import ssd_chunk

    if not torch.cuda.is_available():
        sys.exit("ssd_breakdown: needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    out_dir = ROOT / "build" / "ssd_breakdown"
    out_dir.mkdir(parents=True, exist_ok=True)
    for h in cuda.CSRC.glob("*.cuh"):
        (out_dir / h.name).write_text(h.read_text())
    procs = {}
    for name, text in variants(
            (cuda.CSRC / "ssd_chunk_wgmma.cu").read_text()).items():
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
            sys.exit(f"ssd_breakdown: {name} did not build:\n{log[-4000:]}")
        regs = [ln.replace("ptxas info    :", "").strip()
                for ln in log.splitlines()
                if "registers" in ln or "spill" in ln]
        print(f"{name}: {'; '.join(regs)}", flush=True)
        libs[name] = ctypes.CDLL(str(so))
    dev = torch.device("cuda")
    routed = cuda._LIBS.get("ssd_chunk_wgmma")
    try:
        for shape in ((8, 2, 256, 24, 64, 128), (8, 2, 256, 64, 64, 64)):
            args = cs.ssd_inputs(torch, np, dev, *shape, torch.bfloat16,
                                 True, 1)
            times = {n: [] for n in libs}
            for order in (list(libs), list(libs)[::-1]):
                for name in order:
                    cuda._LIBS["ssd_chunk_wgmma"] = libs[name]
                    times[name].append(cs.device_ms(torch, lambda: ssd_chunk(
                        *args, out_dtype=torch.float32)) * 1e3)
            base = sum(times["base"]) / 2
            for name, ts in times.items():
                mean = sum(ts) / 2
                print(f"{shape} {name}: {ts[0]:.2f}, {ts[1]:.2f} us "
                      f"(base - this: {base - mean:+.2f} us)", flush=True)
    finally:
        if routed is None:
            cuda._LIBS.pop("ssd_chunk_wgmma", None)
        else:
            cuda._LIBS["ssd_chunk_wgmma"] = routed


if __name__ == "__main__":
    main()
