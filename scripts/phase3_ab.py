#!/usr/bin/env python3
"""Phase 3's replay on two trees of this repository, in turns, on one H100.

    python3 scripts/phase3_ab.py OTHER_ROOT [--turns 2]

``OTHER_ROOT`` is another checkout of the repository (for example the
parent commit, unpacked with ``git archive`` into a git-ignored
directory).  Each run is a fresh process that imports that tree's
``chip_smoke.py`` and ``src/``: it builds the coherence kernels, warms a
fabric as phase 3 does (publish 8192 keys, fence, fill the reader tier),
then takes one closed-loop replay of phase 3's 6000-request trace under
``torch.profiler`` (device busy and idle share, device events a wave, the
coherence kernels' launches and device time) and the unprofiled
closed-loop capacity and 0.7x open-loop latency (``wall_replays``).  The
runs alternate other, this, this, other (``--turns`` pairs), so that a
drift of the host during the call falls on both trees.  Prints the
card's name and power limit, one line a run and the medians of each
tree; writes every number to ``chiprun_out/phase3_ab.json``.  Needs a
CUDA card.
"""
import json
import pathlib
import statistics
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]


def child(root: str) -> None:
    """One run on the tree at ``root``; prints its numbers as JSON."""
    root = pathlib.Path(root).resolve()
    sys.path[:0] = [str(root / "src"), str(root)]
    import numpy as np
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import cuda
    from repro_torch.runtime import loadgen
    if not torch.cuda.is_available():
        sys.exit("phase3_ab: needs a CUDA card")
    cuda.build(["lease_probe", "tier_pass"])
    dev = torch.device("cuda")
    trace = loadgen.synthesize(cs.N_REQUESTS, cs.N_KEYS, a=1.2,
                               process="diurnal", rate=1.0, amplitude=0.9,
                               cycles=3.0, seed=7)
    fab = cs.build_fabric(dev)
    cs.warm(cs.Serving(fab))
    torch.cuda.synchronize()
    prof = cs.profile_replay(torch, fab, trace)
    wall = cs.wall_replays(torch, np, fab, trace)
    ported = {k: v for k, v in prof["ported_kernels"].items()
              if k in ("lease_probe", "miss_round", "write_grant")}
    print(json.dumps({
        "root": str(root), "waves": prof["waves"],
        "device_events_per_wave": prof["device_events_per_wave"],
        "device_idle_share": prof["device_idle_share"],
        "device_busy_ms": prof["device_busy_us"] / 1e3,
        "wall_ms": prof["wall_us"] / 1e3,
        "kernels": {k: {"count": v["count"], "us": v["us"]}
                    for k, v in ported.items()},
        "capacity_rps": wall["capacity_rps"], "p50_us": wall["p50_us"],
        "p99_us": wall["p99_us"]}))


def main() -> None:
    args = sys.argv[1:]
    if args[:1] == ["--child"]:
        return child(args[1])
    if not args:
        sys.exit(__doc__)
    other = pathlib.Path(args[0]).resolve()
    turns = int(args[args.index("--turns") + 1]) if "--turns" in args else 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    order = [other, ROOT, ROOT, other] * (turns // 2) + \
        [other, ROOT] * (turns % 2)
    runs = []
    for root in order:
        out = subprocess.run([sys.executable, __file__, "--child", str(root)],
                             capture_output=True, text=True, timeout=600)
        if out.returncode != 0:
            sys.exit(f"phase3_ab: the run on {root} failed:\n"
                     f"{out.stdout[-3000:]}\n{out.stderr[-3000:]}")
        row = json.loads(out.stdout.strip().splitlines()[-1])
        row["tree"] = "this" if root == ROOT else "other"
        runs.append(row)
        print(f"{row['tree']:5s} events/wave {row['device_events_per_wave']:.1f}"
              f", idle share {row['device_idle_share']:.4f}, busy "
              f"{row['device_busy_ms']:.1f} ms of {row['wall_ms']:.1f} ms, "
              f"capacity {row['capacity_rps']:.0f} req/s, p50/p99 "
              f"{row['p50_us']:.0f}/{row['p99_us']:.0f} us, kernels "
              f"{row['kernels']}", flush=True)
    summary = {}
    for tree in ("other", "this"):
        rows = [r for r in runs if r["tree"] == tree]
        summary[tree] = {k: statistics.median(r[k] for r in rows) for k in (
            "device_events_per_wave", "device_idle_share", "device_busy_ms",
            "wall_ms", "capacity_rps", "p50_us", "p99_us")}
        print(f"median, {tree}: {summary[tree]}", flush=True)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "phase3_ab.json").write_text(json.dumps(
        {"card": smi, "runs": runs, "median": summary}, indent=1))


if __name__ == "__main__":
    main()
