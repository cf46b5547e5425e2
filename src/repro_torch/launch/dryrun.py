"""The dry run: one rank's share of every (architecture x input shape)
cell's step on the production mesh, counted without a card — the port of
``repro.launch.dryrun``.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch smollm-360m \\
        --shape train_4k --mesh single
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all \\
        --shape all --mesh both

Each cell builds this rank's inputs as meta tensors
(``launch.steps.build_cell``: its rows of the batch and its shard of
every parameter, gradient and moment under the reference's partition
specs), opens a fake world of 256
("single", a (16, 16) (data, model) mesh) or 512 ranks ("multi", (2,
16, 16) with "pod"; ``launch.mesh.fake_world``) and runs the step under
``launch.opanalysis``: FLOPs by dtype, HBM bytes, collective wire bytes
and peak live bytes by part, then the roofline terms on the H100
(``launch.roofline``).  The weights' all-gathers where they are used
count as wire bytes, and a gathered layer as a transient in the peak.
The ranks are symmetric, so the counts are rank 0's.

Records land in ``build/dryrun/<mesh>/<arch>__<shape>.json`` (git
ignores ``build/``); an existing record is kept unless ``--force``.
``--smoke`` runs the reduced configs, ``--mesh-shape D,M`` a (D, M)
(data, model) fake world in place of the production mesh.  A cell whose
peak does not fit the card's 80 GB is recorded with ``fits`` false; a
cell that raises fails, and the run exits 1.
"""
from __future__ import annotations

import argparse
import gc
import json
import math
import pathlib
import time
import traceback

import torch.distributed as dist

from repro_torch import configs as cfgs
from repro_torch.launch import opanalysis as OA
from repro_torch.launch import roofline as R
from repro_torch.launch import steps as S
from repro_torch.launch.mesh import (PRODUCTION, fake_world, make_model_mesh,
                                     make_production_mesh)
from repro_torch.models.config import SHAPES, applicable_shapes
from repro_torch.models.model import model_spec
from repro_torch.models.params import count_params, tree_paths

ART = pathlib.Path(__file__).resolve().parents[3] / "build" / "dryrun"
# the card's memory: NVIDIA H100 80GB HBM3
HBM_CAPACITY = 80 * 10 ** 9


def active_params(cfg) -> int:
    """Parameters touched per token: total minus the routed experts' share."""
    total = routed = 0
    for path, p in tree_paths(model_spec(cfg)):
        n = math.prod(p.shape)
        total += n
        if "/moe/w" in path:
            routed += n
    if cfg.n_experts:
        frac = cfg.top_k / cfg.n_experts
        return int(total - routed + routed * frac)
    return total


def run_cell(arch: str, shape_name: str, mesh_mode: str, mesh, force=False,
             variant: str = "base", smoke: bool = False, out_dir=ART):
    """One cell's record on ``mesh`` (this process's rank of an open fake
    world; None: one device), written under ``out_dir`` and returned;
    None when the shape does not apply to the arch."""
    sub = mesh_mode if variant == "base" else f"{mesh_mode}-{variant}"
    if smoke:
        sub += "-smoke"
    out_path = pathlib.Path(out_dir) / sub / f"{arch}__{shape_name}.json"
    if out_path.exists() and not force:
        print(f"[skip] {sub}/{arch}/{shape_name} (record exists)")
        return json.loads(out_path.read_text())
    cfg = cfgs.SMOKE[arch] if smoke else cfgs.get(arch)
    cell = {c.name: c for c in SHAPES}[shape_name]
    if cell not in applicable_shapes(cfg):
        print(f"[n/a ] {arch}/{shape_name} not applicable (DESIGN.md)")
        return None
    n_dev = 1 if mesh is None else math.prod(mesh.shape)
    t0 = time.time()
    fn, args, parts = S.build_cell(cfg, cell, mesh, variant)
    hc = OA.analyze(fn, *args, parts=parts,
                    host_reads=variant.startswith("lease"))
    t_trace = time.time() - t0
    del fn, args, parts
    hc.result = None
    n_total = count_params(model_spec(cfg))
    n_active = active_params(cfg)
    mf = R.model_flops_for(cfg, cell, n_total, n_active)
    rl = R.roofline_terms(hc.flops_by_dtype, hc.hbm_bytes, hc.wire_bytes,
                          mf, n_dev)
    rec = {
        "arch": arch, "shape": shape_name, "mesh": mesh_mode,
        "variant": variant, "smoke": smoke,
        "n_devices": n_dev, "rank": 0 if mesh is None else dist.get_rank(),
        "kind": cell.kind,
        "seq_len": cell.seq_len, "global_batch": cell.global_batch,
        "rows": S.batch_rows(cell.global_batch, mesh),
        "params_total": n_total, "params_active": n_active,
        "trace_s": round(t_trace, 2),
        "memory": {"peak_bytes": hc.peak_bytes, "parts": hc.peak_parts,
                   "part_peaks": hc.part_peaks,
                   "capacity_bytes": HBM_CAPACITY,
                   "fits": hc.peak_bytes <= HBM_CAPACITY},
        "collectives": {"per_kind": hc.coll_per_kind,
                        "per_group_size": {str(k): v for k, v
                                           in hc.coll_per_group.items()},
                        "total_wire_bytes": hc.wire_bytes,
                        "n_ops": hc.n_collectives,
                        "counts": hc.coll_counts},
        "kernels": hc.kernels,
        "n_ops": hc.n_ops,
        "roofline": {
            "flops_per_dev": rl.flops,
            "flops_by_dtype": rl.flops_by_dtype,
            "hbm_bytes_per_dev": rl.hbm_bytes,
            "wire_bytes_per_dev": rl.wire_bytes,
            "t_compute_s": rl.t_compute, "t_memory_s": rl.t_memory,
            "t_collective_s": rl.t_collective, "bottleneck": rl.bottleneck,
            "bound_s": rl.bound,
            "model_flops_per_dev": rl.model_flops,
            "useful_flop_ratio": rl.useful_ratio,
        },
    }
    out_path.parent.mkdir(parents=True, exist_ok=True)
    out_path.write_text(json.dumps(rec, indent=1))
    print(f"[ ok ] {sub}/{arch}/{shape_name}: trace {t_trace:.1f}s "
          f"flops/dev={rl.flops:.3e} hbm/dev={rl.hbm_bytes:.3e} "
          f"wire/dev={rl.wire_bytes:.3e} bottleneck={rl.bottleneck} "
          f"peak={hc.peak_bytes / 1e9:.2f}GB "
          f"fits={rec['memory']['fits']}")
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all", help="all, or names with commas")
    ap.add_argument("--shape", default="all",
                    help="all, or cell names with commas")
    ap.add_argument("--mesh", default="single", choices=["single", "multi",
                                                         "both"])
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--variant", default="base")
    ap.add_argument("--smoke", action="store_true",
                    help="the reduced configs")
    ap.add_argument("--mesh-shape", default=None,
                    help="D,M: a (data, model) fake world of D*M ranks in "
                         "place of the production mesh")
    ap.add_argument("--out", default=str(ART))
    args = ap.parse_args(argv)
    archs = list(cfgs.ARCHS) if args.arch == "all" else args.arch.split(",")
    shapes = ([c.name for c in SHAPES] if args.shape == "all"
              else args.shape.split(","))
    if args.mesh_shape:
        dims = tuple(int(d) for d in args.mesh_shape.split(","))
        meshes = [("x".join(map(str, dims)), dims, ("data", "model"))]
    else:
        meshes = [(m, *PRODUCTION[m == "multi"]) for m in
                  (["single", "multi"] if args.mesh == "both"
                   else [args.mesh])]
    failures = []
    for mode, dims, axes in meshes:
        with fake_world(math.prod(dims)):
            mesh = (make_model_mesh(dims, axes, backend="fake")
                    if args.mesh_shape else
                    make_production_mesh(multi_pod=(mode == "multi")))
            for arch in archs:
                for shape in shapes:
                    try:
                        run_cell(arch, shape, mode, mesh, force=args.force,
                                 variant=args.variant, smoke=args.smoke,
                                 out_dir=args.out)
                    except Exception:
                        failures.append((mode, arch, shape))
                        print(f"[FAIL] {mode}/{arch}/{shape}")
                        traceback.print_exc()
                    gc.collect()
    if failures:
        print("FAILURES:", failures)
        raise SystemExit(1)
    print("dry-run complete")


if __name__ == "__main__":
    main()
