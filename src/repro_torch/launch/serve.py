"""Serving launcher: batched requests through the lease-coherent server.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-360m --requests 8
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu

The port of ``repro.launch.serve``, with the same flags and the same
default (the smoke config of the arch), plus ``--device``: the CUDA card
unless told otherwise.  Every prefix-KV lease comes from the port's
single-device ``ArrayFabric`` via ONE batched probe per serve call.
"""
import argparse
import json

import numpy as np
import torch

from repro_torch import configs as cfgs
from repro_torch.coherence.fabric import FabricConfig, default_fabric
from repro_torch.coherence.fabric.backend import resolve_device
from repro_torch.models import init_model
from repro_torch.runtime.server import Request, Server


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m", choices=list(cfgs.ARCHS))
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--tsu-shards", type=int, default=4)
    ap.add_argument("--rd-lease", type=int, default=8)
    ap.add_argument("--wr-lease", type=int, default=4)
    ap.add_argument("--device", default=None,
                    help="torch device for the model and the fabric "
                         "(default: the CUDA card; 'cpu' runs the plain "
                         "PyTorch versions of the kernels)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = cfgs.SMOKE[args.arch]            # serving demo runs the smoke cfg
    params = init_model(cfg, torch.Generator(dev).manual_seed(0))
    fabric = default_fabric(FabricConfig(n_shards=args.tsu_shards,
                                         rd_lease=args.rd_lease,
                                         wr_lease=args.wr_lease),
                            device=dev)
    srv = Server(cfg, params, batch_size=args.batch,
                 max_len=args.prompt_len + args.max_new + 8, fabric=fabric,
                 device=dev)
    reqs = []
    for i in range(args.requests):
        # half the requests share a prompt -> exercises the lease cache
        seed = i % max(args.requests // 2, 1)
        prompt = np.random.default_rng(seed).integers(
            2, cfg.vocab, args.prompt_len).astype(np.int32)
        reqs.append(Request(rid=i, prompt=prompt, max_new=args.max_new))
    # two waves: wave 1 prefills under one batched probe + one batched
    # write-through; wave 2's identical prefixes ride the live leases
    out = srv.serve(reqs[:len(reqs) // 2])
    out.update(srv.serve(reqs[len(reqs) // 2:]))
    for rid in sorted(out):
        print(f"req {rid}: {list(out[rid])}")
    print("lease-cache stats:", srv.cache_stats)
    print("fabric stats:", json.dumps(srv.fabric_stats))
    return srv, out


if __name__ == "__main__":
    main()
