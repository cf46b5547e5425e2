"""Training launcher.

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m --steps 20
    PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-130m --steps 20
    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m --smoke --steps 6 --device cpu
    PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \\
        --arch smollm-360m --smoke --steps 6 --mesh 2,2

The port of ``repro.launch.train``, with the same flags, plus
``--device`` (default: the CUDA card; ``cpu`` runs the plain PyTorch
versions of the kernels).  ``--mesh D,M`` trains on a (data, model) mesh
of the ``torchrun`` world (``launch.mesh.make_model_mesh``; the world
from the ``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR`` and ``MASTER_PORT``
that ``torchrun`` sets, NCCL with a card a rank, gloo with
``--device cpu``), where the reference's ``--mesh`` names a TPU mesh:
each rank holds its shards of the weights and its data rank's rows of
the batch, and writes its checkpoints under ``--ckpt-dir``/``rank<r>``.
Every ported model trains on the card: the dense decoders, mamba2 and
zamba2 (``ssd_chunk`` through its forward and backward kernels).
"""
import argparse
import os
import tempfile

import torch.distributed as dist

from repro_torch import configs as cfgs
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.launch.mesh import make_model_mesh
from repro_torch.runtime.trainer import Trainer, TrainerConfig
from repro_torch.sharding import shard_index


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m", choices=list(cfgs.ARCHS))
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "repro_torch_train"))
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--mesh", default=None,
                    help="D,M: a (data, model) mesh of the torchrun world")
    args = ap.parse_args(argv)

    cfg = cfgs.SMOKE[args.arch] if args.smoke else cfgs.get(args.arch)
    dcfg = DataConfig(global_batch=args.batch, seq_len=args.seq)
    mesh, ckpt_dir = None, args.ckpt_dir
    if args.mesh:
        cpu = args.device is not None and args.device.startswith("cpu")
        dist.init_process_group("gloo" if cpu else "nccl",
                                init_method="env://")
        mesh = make_model_mesh([int(d) for d in args.mesh.split(",")],
                               backend=dist.get_backend())
        i, n = shard_index(mesh, ("data",))
        dcfg = DataConfig(global_batch=args.batch, seq_len=args.seq,
                          host_index=i, host_count=n)
        ckpt_dir = os.path.join(ckpt_dir, f"rank{dist.get_rank()}")
    trainer = Trainer(cfg,
                      tcfg=TrainerConfig(total_steps=args.steps,
                                         ckpt_period=max(args.steps // 5, 1),
                                         ckpt_dir=ckpt_dir),
                      data=SyntheticLM(cfg, dcfg), device=args.device,
                      mesh=mesh)
    try:
        out = trainer.run()
    finally:
        if mesh is not None:
            dist.destroy_process_group()
    print(f"done: steps={out['final_step']} "
          f"loss {out['losses'][0]:.3f} -> {out['losses'][-1]:.3f} "
          f"events={out['events']}")
    return out


if __name__ == "__main__":
    main()
