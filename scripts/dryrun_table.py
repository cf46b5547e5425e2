"""PERF.md's dry-run table from the records of
``python -m repro_torch.launch.dryrun --arch all --shape all --mesh both``.

    PYTHONPATH=src python scripts/dryrun_table.py [--dir build/dryrun]
        [--old OLD_DIR]

One row a cell, each column "single pod ; multi-pod" (the (16, 16) and
(2, 16, 16) worlds): TFLOP bf16 / f32, GB moved, wire GB, the bound in
ms and its term (mem, com, col), the peak GB split into params + grads
+ optimizer + the rest, and whether it fits 80 GB.  ``--old``
names a second record directory (another tree's run) and lists the cells
whose ``fits`` differs between the two.
"""
import argparse
import json
import pathlib

ROOT = pathlib.Path(__file__).resolve().parents[1]
ARCHS = (("mamba2-130m", "mamba2"), ("smollm-360m", "smollm"),
         ("zamba2-1.2b", "zamba2"), ("hubert-xlarge", "hubert"),
         ("gemma3-4b", "gemma3"), ("qwen2.5-14b", "qwen2.5"),
         ("llava-next-34b", "llava"), ("qwen1.5-110b", "qwen1.5"),
         ("llama4-maverick-400b-a17b", "llama4"),
         ("deepseek-v2-236b", "deepseek"))
SHAPES = (("train_4k", "train"), ("prefill_32k", "prefill"),
          ("decode_32k", "decode"), ("long_500k", "long"))
MESHES = (("single", 1), ("multi", 2))
TERM = {"compute": "com", "memory": "mem", "collective": "col"}


def records(d: pathlib.Path):
    """{(cell, mesh number): record} of the cells that ran."""
    out = {}
    for arch, a in ARCHS:
        for shape, sh in SHAPES:
            for mesh, m in MESHES:
                p = d / mesh / f"{arch}__{shape}.json"
                if p.exists():
                    out[(f"{a} {sh}", m)] = json.loads(p.read_text())
    return out


def num(x: float) -> str:
    return f"{x:.0f}" if x >= 1000 else f"{x:.3g}"


def columns(rec) -> list:
    rl, mem = rec["roofline"], rec["memory"]
    fl = rl["flops_by_dtype"]
    parts = mem["parts"]
    peak = (f"{mem['peak_bytes'] / 1e9:.1f} = " + " + ".join(
        f"{parts[k] / 1e9:.1f}" for k in ("params", "grads", "optimizer",
                                          "other")))
    return [f"{num(fl.get('bf16', 0) / 1e12)} / "
            f"{num(fl.get('f32', 0) / 1e12)}",
            f"{rl['hbm_bytes_per_dev'] / 1e9:.0f}",
            num(rl["wire_bytes_per_dev"] / 1e9),
            f"{num(rl['bound_s'] * 1e3)} {TERM[rl['bottleneck']]}", peak,
            "yes" if mem["fits"] else "**no**"]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default=str(ROOT / "build" / "dryrun"))
    ap.add_argument("--old", default=None)
    args = ap.parse_args()
    new = records(pathlib.Path(args.dir))
    print("| cell | TFLOP | GB | wire GB | bound ms | peak GB | fits |")
    print("| --- | --- | --- | --- | --- | --- | --- |")
    for cell in dict.fromkeys(c for c, _ in new):
        cols = [columns(new[(cell, m)]) for _, m in MESHES
                if (cell, m) in new]
        print(f"| {cell} | " + " | ".join(
            " ; ".join(c[i] for c in cols) for i in range(6)) + " |")
    if args.old:
        old = records(pathlib.Path(args.old))
        changed = [f"{c}, {m}" for (c, m) in new if (c, m) in old and
                   new[(c, m)]["memory"]["fits"]
                   != old[(c, m)]["memory"]["fits"]]
        print(f"fits changed: {changed or 'none'}")
        print(f"fit: {sum(r['memory']['fits'] for r in new.values())} of "
              f"{len(new)} (before: "
              f"{sum(r['memory']['fits'] for r in old.values())})")


if __name__ == "__main__":
    main()
