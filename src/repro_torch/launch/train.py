"""Training launcher.

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m --steps 20
    PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-130m --steps 20
    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m --smoke --steps 6 --device cpu

The port of ``repro.launch.train``, with the same flags, plus
``--device`` (default: the CUDA card; ``cpu`` runs the plain PyTorch
versions of the kernels).  The reference's ``--mesh`` (TPU meshes) is
not ported.  Every ported model trains on the card: the dense decoders,
mamba2 and zamba2 (``ssd_chunk`` through its forward and backward
kernels).
"""
import argparse
import os
import tempfile

from repro_torch import configs as cfgs
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.runtime.trainer import Trainer, TrainerConfig


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
    args = ap.parse_args(argv)

    cfg = cfgs.SMOKE[args.arch] if args.smoke else cfgs.get(args.arch)
    data = SyntheticLM(cfg, DataConfig(global_batch=args.batch,
                                       seq_len=args.seq))
    trainer = Trainer(cfg,
                      tcfg=TrainerConfig(total_steps=args.steps,
                                         ckpt_period=max(args.steps // 5, 1),
                                         ckpt_dir=args.ckpt_dir),
                      data=data, device=args.device)
    out = trainer.run()
    print(f"done: steps={out['final_step']} "
          f"loss {out['losses'][0]:.3f} -> {out['losses'][-1]:.3f} "
          f"events={out['events']}")
    return out


if __name__ == "__main__":
    main()
