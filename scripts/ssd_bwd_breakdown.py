#!/usr/bin/env python3
"""Where ``ssd_chunk_bwd``'s time goes, on one H100.

    python3 scripts/ssd_bwd_breakdown.py [--variants]

At the mamba2-130m and zamba2-1.2b training shapes (B = 8, nc = 2, Q =
256, P = 64; H = 24, N = 128 and H = 64, N = 64; bf16, B and C a stride-0
broadcast over the heads, the cotangents in f32), for each route (the
tensor-core kernel ``csrc/ssd_chunk_bwd_wgmma.cu``, then the CUDA-core
``csrc/ssd_chunk_bwd.cu``): the call's CUDA-event time (as
``chip_smoke.py`` phase 2 times it), then ten calls under
``torch.profiler``: each of its four launches' device time per call (the
query pass, the key pass, the chunk pass, the dA pass) and, for the two
pair passes, the rate of the products they issue over the visited 64 x 64
tile pairs: on the tensor-core route the bf16 wgmma flops with the splits
(query: C B^T, dy x^T twice, dC twice; key: B C^T, x dy^T twice, dx three
times, dB twice, the state terms four times a row), on the CUDA-core
route the f32 flops of its dots and outer products.

``--variants`` instead builds ``csrc/ssd_chunk_bwd_wgmma.cu`` as it is
and with one part cut out or changed at a time (the results of a cut
variant are wrong; only its time is read), into
``build/ssd_bwd_breakdown/``, and times its query and key passes under
``torch.profiler`` at both shapes, every variant and then every variant
again in reverse order; the difference to ``base`` is what the part
costs:

- ``no_pairs``: neither pass visits a tile pair (what is left is each
  block's set-up, loads of its resident tiles, the key pass's state
  terms and the epilogue);
- ``no_exp``: the pair loops take their exp (ex2) as 1;
- ``no_lo``: the lo products of the pair loops cut (dC += G_lo B, dx +=
  s_lo dy_hi + s_hi dy_lo, dB += G_lo C);
- ``no_state``: the key pass's state products cut.

Needs a CUDA card (and nvcc for ``--variants``); prints the card's name
and power limit first.
"""
import ctypes
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

SHAPES = (("mamba2-130m", (8, 2, 256, 24, 64, 128)),
          ("zamba2-1.2b", (8, 2, 256, 64, 64, 64)))
CALLS = 10
LIB = "ssd_chunk_bwd_wgmma"


def variants(src: str) -> dict:
    def patch(s, a, b):
        if a not in s:
            raise SystemExit(f"ssd_bwd_breakdown: the source changed; no "
                             f"{a!r}")
        return s.replace(a, b)

    out = {"base": src}
    v = patch(src, "const int ntiles = qt + 1;", "const int ntiles = 0;")
    out["no_pairs"] = patch(v, "const int ntiles = nq - jt;",
                            "const int ntiles = 0;")
    v = src
    for a in ("ex2((ci[r] - cj.x) * kLog2e)", "ex2((ci[r] - cj.y) * kLog2e)",
              "ex2((ci.x - cj[r]) * kLog2e)", "ex2((ci.y - cj[r]) * kLog2e)"):
        v = patch(v, a, "1.f")
    out["no_exp"] = v
    v = patch(src, "product_rs<N>(dca, glo, bs);", "")
    v = patch(v, "product_rs<P>(dxa, slo, yh);", "")
    v = patch(v, "product_rs<P>(dxa, shi, yl);", "")
    out["no_lo"] = patch(v, "product_rs<N>(dba, glo, cst);", "")
    v = patch(src, "pb < P / 64; ++pb)", "pb < 0; ++pb)")
    out["no_state"] = patch(v, "nb < N / 64; ++nb)", "nb < 0; ++nb)")
    return out


def build_variants(cuda) -> dict:
    """Each variant's library, built in parallel; prints its registers."""
    out_dir = ROOT / "build" / "ssd_bwd_breakdown"
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
            sys.exit(f"ssd_bwd_breakdown: {name} did not build:\n"
                     f"{log[-4000:]}")
        regs = [ln.replace("ptxas info    :", "").strip()
                for ln in log.splitlines() if "registers" in ln]
        print(f"{name}: {'; '.join(regs)}", flush=True)
        libs[name] = ctypes.CDLL(str(so))
    return libs


def main() -> None:
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    from repro_torch.kernels.ssd_chunk import ssd_chunk, ssd_chunk_bwd

    if not torch.cuda.is_available():
        sys.exit("ssd_bwd_breakdown: needs a CUDA card")

    def passes(call):
        """Device us a call of each of ``call``'s launches, by pass."""
        call()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(CALLS):
                call()
            torch.cuda.synchronize()
        parts = {}
        for e in prof.events():
            if e.device_type == DeviceType.CUDA and "ssd_bwd" in e.name:
                name = e.name.split("ssd_bwd_")[1].split("_kernel")[0]
                name = name.replace("wgmma_", "")
                parts[name] = parts.get(name, 0.0) + \
                    e.time_range.elapsed_us() / CALLS
        return parts
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    dev = torch.device("cuda")
    from repro_torch.kernels import cuda
    libs = build_variants(cuda) if "--variants" in sys.argv[1:] else None
    routed = cuda._LIBS.get(LIB)
    for arch, (B, nc, Q, H, P, N) in SHAPES:
        args = cs.ssd_inputs(torch, np, dev, B, nc, Q, H, P, N,
                             torch.bfloat16, True, 1)
        rng = np.random.default_rng(2)
        T = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(
            np.float32)).to(dev)
        cot = (T(B, nc, Q, H, P), T(B, nc, H, N, P), T(B, nc, Q, H))
        cum = ssd_chunk(*args, out_dtype=torch.float32)[2]
        tiles = Q // 64
        pairs = B * nc * H * tiles * (tiles + 1) // 2 * 64 * 64
        rows = B * nc * Q * H
        flops = {"wgmma": {"query": pairs * (2 * N + 4 * P + 4 * N),
                           "key": pairs * (2 * N + 4 * P + 6 * P + 4 * N)
                           + rows * 8 * N * P},
                 "simt": {"query": pairs * (2 * N + 2 * P + 2 * N),
                          "key": pairs * (2 * N + 2 * P + 2 * P + 2 * N)}}
        if libs:
            times = {n: [] for n in libs}
            try:
                for order in (list(libs), list(libs)[::-1]):
                    for name in order:
                        cuda._LIBS[LIB] = libs[name]
                        times[name].append(passes(lambda: ssd_chunk_bwd(
                            *args, cum, *cot, path="wgmma")))
            finally:
                if routed is None:
                    cuda._LIBS.pop(LIB, None)
                else:
                    cuda._LIBS[LIB] = routed
            base = {k: sum(t[k] for t in times["base"]) / 2
                    for k in ("query", "key")}
            for name, ts in times.items():
                print(f"{arch} {name}: " + "; ".join(
                    f"{k} {ts[0][k]:.2f}, {ts[1][k]:.2f} us (base - this: "
                    f"{base[k] - (ts[0][k] + ts[1][k]) / 2:+.2f})"
                    for k in ("query", "key")), flush=True)
            continue
        for path in ("wgmma", "simt"):
            def call():
                return ssd_chunk_bwd(*args, cum, *cot, path=path)
            ms = cs.device_ms(torch, call)
            parts = passes(call)
            rate = flops[path]
            print(f"{arch} [{B}, {nc}, {Q}, {H}, {P}, {N}] bf16, {path}: the "
                  f"call {ms * 1e3:.2f} us; per launch " + ", ".join(
                      f"{k} {v:.2f} us" + (f" ({rate[k] / v / 1e6:.1f} TF/s)"
                                           if k in rate else "")
                      for k, v in sorted(parts.items(),
                                         key=lambda kv: -kv[1])),
                  flush=True)


if __name__ == "__main__":
    main()
