"""One rank of a gloo world that runs the port's model on (data, model)
meshes: the expert-parallel MoE layer, the loss and its gradients, train
steps, the data-parallel step's CE, a mesh ``Trainer`` and serving.

    python tests/torch_mesh_worker.py RANK WORLD RDZV_FILE JOB OUT

``JOB`` is a pickle of ``{"tasks": [...]}``; every rank runs every task
in order.  A task names its mesh shape (``make_model_mesh``; rank r sits
at (r // M, r % M)), its config (a smoke config, the f32 or the config's
own policy, a capacity factor, MLA's full head dims), its device ("cpu"
by default; "cuda": the ranks share the card, CUDA tensors through
gloo) and its global inputs as numpy arrays; the rank takes its rows of
the batch and its shards of the weights
(``models.convert.params_shard_from_numpy``), runs the task and pickles
its local results to ``OUT``, with the modules it imported.  It imports
only ``torch``, ``numpy`` and ``repro_torch``.
"""
from __future__ import annotations

import dataclasses
import datetime
import pickle
import sys

TIMEOUT_S = 120          # a collective that waits longer fails the rank


def config(task):
    import torch

    from repro_torch import configs
    cfg = configs.SMOKE[task["arch"]]
    if task.get("policy", "f32") == "f32":
        cfg = dataclasses.replace(cfg, policy=dataclasses.replace(
            cfg.policy, compute_dtype=torch.float32,
            cache_dtype=torch.float32))
    if task.get("cf") is not None:
        cfg = dataclasses.replace(cfg, capacity_factor=task["cf"])
    if task.get("mla_heads"):       # the pair the flash kernels build
        full = configs.ARCHS[task["arch"]]
        cfg = dataclasses.replace(cfg, nope_head_dim=full.nope_head_dim,
                                  rope_head_dim=full.rope_head_dim,
                                  v_head_dim=full.v_head_dim)
    return cfg


def tensors(tree, dtype=None, device="cpu"):
    import torch
    if isinstance(tree, dict):
        return {k: tensors(v, dtype, device) for k, v in tree.items()}
    t = torch.from_numpy(tree.copy())
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


def arrays(tree):
    if isinstance(tree, dict):
        return {k: arrays(v) for k, v in tree.items()}
    t = tree.detach().cpu()
    return t.float().numpy().copy() if t.is_floating_point() \
        else t.numpy().copy()


def rows(x, mesh, ctx):
    """This rank's rows of a global batch array: its data rank's block."""
    from repro_torch.sharding import shard_index
    i, n = shard_index(mesh, ctx.dp_axes)
    b = x.shape[0] // n
    return x[i * b:(i + 1) * b]


def main(argv) -> None:
    rank, world = int(argv[1]), int(argv[2])
    rdzv, job_path, out_path = argv[3], argv[4], argv[5]
    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_model_mesh
    from repro_torch.launch.steps import (make_decode_step, make_grad_step,
                                          make_prefill_step, make_train_step)
    from repro_torch.models import init_cache, moe as moe_mod
    from repro_torch.models.convert import params_shard_from_numpy
    from repro_torch.models.model import (init_model_shard, param_placement,
                                          shard_model)
    from repro_torch.models.params import shard_params
    from repro_torch.obs.xprof import collective_counts
    from repro_torch.optim import adamw
    from repro_torch.runtime.trainer import Trainer, TrainerConfig
    from repro_torch.sharding import ShardCtx

    with open(job_path, "rb") as f:
        job = pickle.load(f)
    torch.set_num_threads(job.get("threads", 1))
    dist.init_process_group(
        "gloo", init_method=f"file://{rdzv}", rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=TIMEOUT_S))
    meshes = {}

    def mesh_of(shape):
        shape = tuple(shape)
        if shape not in meshes:
            meshes[shape] = make_model_mesh(shape, backend="gloo")
        return meshes[shape]

    res = {}
    for task in job["tasks"]:
        cfg = config(task)
        kind, name = task["kind"], task["name"]
        mesh = mesh_of(task["mesh"]) if "mesh" in task else None
        ctx = ShardCtx(mesh)
        cd = cfg.policy.compute_dtype
        dev = torch.device(task.get("device", "cpu"))
        if kind == "moe":
            p = shard_params(tensors(task["params"], device=dev),
                             moe_mod.placement(cfg, mesh), mesh)
            h = tensors(rows(task["h"], mesh, ctx), cd, dev)
            (out, aux), counts = collective_counts(
                moe_mod.moe_apply, cfg, p, h, want_aux=True, ctx=ctx)
            res[name] = {"out": arrays(out), "aux": float(aux),
                         "counts": counts}
        elif kind == "grads":
            p = params_shard_from_numpy(cfg, task["params"], mesh, dev)
            batch = {k: rows(v, mesh, ctx) for k, v in task["batch"].items()}
            loss, metrics, grads = make_grad_step(cfg, mesh=mesh)(p, batch)
            out = {"loss": float(loss), "ce": float(metrics["ce"]),
                   "aux": float(metrics["aux"]), "grads": arrays(grads)}
            if task.get("steps"):
                opt = adamw.AdamWConfig(**task["opt"])
                step = make_train_step(cfg, opt, mesh=mesh)
                state = adamw.init_state(p, cfg.policy.moment_dtype)
                losses = []
                for b in task["steps"]:
                    state, m = step(state, {k: rows(v, mesh, ctx)
                                            for k, v in b.items()})
                    losses.append(float(m["loss"]))
                out["losses"] = losses
                out["params"] = arrays(state.params)
                out["digests"] = digests(state.params,
                                         param_placement(cfg, mesh))
            res[name] = out
        elif kind == "step0":
            # the data-parallel step: rank r takes rows r of the batch
            group = dist.group.WORLD
            n = dist.get_world_size()
            b = task["batch"]["labels"].shape[0] // n
            batch = {k: v[rank * b:(rank + 1) * b]
                     for k, v in task["batch"].items()}
            p = tensors(task["params"])
            loss, metrics, grads = make_grad_step(cfg, group=group)(p, batch)
            opt = adamw.AdamWConfig(**task["opt"])
            state, m = make_train_step(cfg, opt, group=group)(
                adamw.init_state(tensors(task["params"]),
                                 cfg.policy.moment_dtype), batch)
            res[name] = {"loss": float(loss), "ce": float(metrics["ce"]),
                         "grads": arrays(grads), "gnorm": float(m["gnorm"]),
                         "params": arrays(state.params)}
        elif kind == "group_vs_mesh":
            # 3 steps on the data-parallel group and on an (n, 1) mesh
            opt = adamw.AdamWConfig(**task["opt"])
            out = {}
            for how in ("group", "mesh"):
                if how == "group":
                    step = make_train_step(cfg, opt, group=dist.group.WORLD)
                    p = tensors(task["params"])
                else:
                    step = make_train_step(cfg, opt, mesh=mesh)
                    p = shard_model(cfg, tensors(task["params"]), mesh)
                state = adamw.init_state(p, cfg.policy.moment_dtype)
                losses = []
                for bt in task["steps"]:
                    state, m = step(state, {k: rows(v, mesh, ctx)
                                            for k, v in bt.items()})
                    losses.append(float(m["loss"]))
                params = state.params
                if how == "mesh":
                    from repro_torch.models.comm import full_tree
                    params = full_tree(params, param_placement(cfg, mesh),
                                       mesh)
                out[how] = {"losses": losses, "params": arrays(params)}
            res[name] = out
        elif kind == "trainer":
            from repro_torch.data.pipeline import DataConfig, SyntheticLM
            from repro_torch.sharding import shard_index
            i, n = shard_index(mesh, ctx.dp_axes)
            data = SyntheticLM(cfg, DataConfig(
                global_batch=task["batch"], seq_len=task["seq"],
                host_index=i, host_count=n))
            opt = adamw.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=20)
            tcfg = TrainerConfig(total_steps=task["total"], ckpt_period=2,
                                 ckpt_dir=f"{task['ckpt_dir']}/{rank}")
            tr = Trainer(cfg, opt, tcfg, data=data, device=dev, mesh=mesh)
            full = tr.run(state=tr.init_state(task["seed"]))
            tr2 = Trainer(cfg, opt, dataclasses.replace(
                tcfg, ckpt_dir=f"{task['ckpt_dir']}/b{rank}"), data=data,
                device=dev, mesh=mesh)
            try:
                tr2.run(state=tr2.init_state(task["seed"]),
                        fail_at=task["fail"])
            except RuntimeError:
                pass
            resumed = tr2.resume()
            init = tr.init_state(task["seed"])
            res[name] = {"losses": full["losses"],
                         "resumed": resumed["losses"],
                         "params": arrays(full["state"].params),
                         "resumed_params": arrays(resumed["state"].params),
                         "init": arrays(init.params),
                         "events": [e for e in tr.events
                                    if e["kind"] != "straggler"]}
        elif kind == "collectives":
            res[name] = collectives(torch, mesh, dev)
        elif kind == "serve":
            p = init_model_shard(cfg, torch.Generator().manual_seed(
                task["seed"]), mesh)
            tokens = torch.from_numpy(rows(task["tokens"], mesh, ctx))
            B, S = tokens.shape
            cache = init_cache(cfg, B, S + task["decode"], device="cpu")
            prefill = make_prefill_step(cfg, mesh)
            decode = make_decode_step(cfg, mesh)
            (ids, cache), c_pre = collective_counts(prefill, p, cache,
                                                    {"tokens": tokens})
            seq, c_dec = [ids.numpy().copy()], None
            for t in range(task["decode"]):
                (ids, cache), c = collective_counts(
                    decode, p, cache, ids[:, None], S + t)
                c_dec = c_dec or c
                seq.append(ids.numpy().copy())
            res[name] = {"ids": seq, "prefill_counts": c_pre,
                         "decode_counts": c_dec}
        else:
            raise ValueError(kind)
    res["modules"] = sorted(m for m in sys.modules
                            if m.split(".")[0] in ("jax", "jaxlib", "repro"))
    dist.barrier()
    dist.destroy_process_group()
    with open(out_path, "wb") as f:
        pickle.dump(res, f)


def digests(params, specs):
    """sha256 of each replicated leaf's bytes, by path: the ranks of a
    mesh must hold them bit for bit alike."""
    import hashlib

    import torch

    def walk(t, s, path):
        if isinstance(t, dict):
            for k in sorted(t):
                yield from walk(t[k], s[k], f"{path}/{k}")
        elif s == ():
            b = t.detach().cpu().contiguous().view(torch.uint8)
            yield path, hashlib.sha256(b.numpy().tobytes()).hexdigest()
    return dict(walk(params, specs, ""))


def collectives(torch, mesh, dev):
    """Each collective ``models.comm`` issues, on ``dev``'s tensors along
    "model": the all-gather, the all-to-all, the f32 sum, and the
    backward of a scatter (an all-gather) and of a summed gather (a sum
    and a block), with bf16 among them."""
    from repro_torch.models import comm
    g = mesh.group(("model",))
    r = mesh.coords[mesh.axis_names.index("model")]
    x = (torch.arange(24, dtype=torch.float32, device=dev).reshape(4, 6)
         + 100 * r)
    out = {"all_gather": comm.all_gather(x, 1, g),
           "all_to_all": comm.all_to_all(x, g),
           "sum_bf16": comm.all_reduce_sum(x.to(torch.bfloat16), g)}
    y = x.clone().requires_grad_()
    (comm.scatter(y, 0, g) * (r + 1)).sum().backward()
    out["scatter_grad"] = y.grad
    z = x.clone().requires_grad_()
    (comm.gather(z, 0, g, grad="sum") * torch.arange(
        8, dtype=torch.float32, device=dev)[:, None]).sum().backward()
    out["gather_sum_grad"] = z.grad
    out["devices"] = sorted({str(t.device) for t in out.values()})
    return {k: v if k == "devices" else v.detach().float().cpu().numpy()
            for k, v in out.items()}


if __name__ == "__main__":
    main(sys.argv)
