#!/usr/bin/env python3
"""How far zamba2's bf16 gradient is from the f32 policy's, on the SSM
blocks' per-head vectors (ROADMAP Queue 3, F5).

    python3 scripts/f5_grad.py [--device cpu] [--out PATH]
    python3 scripts/f5_grad.py --device cpu --reference [--card PATH]
    python3 scripts/f5_grad.py --device cpu --split
    python3 scripts/f5_grad.py --device cpu --f32-heads
    python3 scripts/f5_grad.py [--device cpu] --full-width [--reference]
    python3 scripts/f5_grad.py --layers [--seed 6]

The smoke zamba2 (seven SSM layers and the shared attention block,
d_model 64, 8 heads of 16), weights from the port's init at seeds 1-6,
tokens from ``default_rng(seed + 10)``, 2 rows of 32: for ``A_log``,
``D_skip`` and ``dt_bias``, every SSM layer's leaf of a kind together, the
relative L2 between the gradient under the default bf16 policy and under
the f32 policy, on ``--device`` (default: the CUDA card, every
``ssd_chunk`` there through its forward and backward kernels; f32 matmuls
without TF32).  ``--out`` writes them as JSON.

``--reference`` and ``--split`` run on the CPU and import jax and the
reference package (``src/repro``), as the port's tests do; the port's
modules never do.  ``--reference`` prints the reference's own
bf16-vs-f32 error beside the port's and their ratio, and with ``--card``
the numbers of a card run (its ``--out``) beside those.  ``--split``
takes the first SSM block of seed 3 (its input the embedded tokens, a
seeded N(0, 1) bf16 cotangent on its output) and compares, in both
packages, the bf16 cotangent of every intermediate (the pre-norm, in_proj,
the conv and silu, softplus, ``ssd_chunked``, the skip, the gate, the
gated norm, out_proj) and each parameter's gradient with the port's f32
ones, chained from the output: where the port's error first outgrows the
reference's is the rounding point at fault.  ``--f32-heads`` repeats the
per-head measurement on the CPU with B and C broadcast to the heads in
f32 (their per-head gradients summed in f32 and rounded once, the
reference's rounding point) beside the port as it is.  ``--full-width``
measures the whole gradient instead, at zamba2-1.2b's full width and 6
layers on one 512-token row (``chip_smoke.py`` phase 8's check), with
``--reference`` the reference's beside it.  ``--layers`` splits one
seed's ``A_log`` error by SSM layer (ROADMAP Queue 3, F6): each layer's
bf16-vs-f32 relative L2 on ``--device`` (the card) and on the CPU port in
the same process, their ratio, and, walking the layers in the order the
backward reaches them (the last first), the first whose error on the
card is more than 1.25x the CPU's, and the routes ``ssd_chunk_bwd`` took
on the card (the smoke config's P = 16 takes the CUDA-core kernel).
"""
import argparse
import dataclasses
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

ARCH = "zamba2-1.2b"
SEEDS = range(1, 7)
KINDS = ("A_log", "D_skip", "dt_bias")
SPLIT_SEED = 3
TAPS = ("hn", "zxbcdt", "xBC_c", "dt", "y4", "y", "g", "gn", "out")


def named(tree, path=""):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in named(tree[k], f"{path}/{k}")]
    return [(path, tree)]


def rel(a, b) -> float:
    import numpy as np
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def kinds(tree) -> dict:
    """Each kind's leaves, every layer's, flattened together (f32 numpy)."""
    import numpy as np
    return {k: np.concatenate([np.asarray(v, np.float32).ravel()
                               for p, v in tree if p.endswith("/" + k)])
            for k in KINDS}


def port_cfgs():
    import torch

    from repro_torch import configs
    cfg = configs.SMOKE[ARCH]
    f32 = dataclasses.replace(cfg, policy=dataclasses.replace(
        cfg.policy, compute_dtype=torch.float32, cache_dtype=torch.float32))
    return cfg, f32


def tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def inputs(seed):
    """(the weights as a numpy tree, from the port's init; the tokens)."""
    import numpy as np
    import torch

    from repro_torch.models import init_model
    _, f32 = port_cfgs()
    params = tree_map(lambda t: t.numpy(), init_model(
        f32, torch.Generator().manual_seed(seed)))
    tok = np.random.default_rng(seed + 10).integers(
        2, f32.vocab, (2, 32)).astype(np.int32)
    return params, tok


def port_named(device, seed) -> dict:
    """{policy: [(path, gradient)]} of the port on ``device``."""
    import torch

    from repro_torch.models import convert
    from repro_torch.models.training import loss_and_grads
    params, tok = inputs(seed)
    out = {}
    for name, cfg in zip(("bf16", "f32"), port_cfgs()):
        p = convert.params_from_numpy(cfg, params, device=device)
        _, _, g = loss_and_grads(cfg, p, {"tokens": torch.from_numpy(tok).to(
            device)})
        out[name] = [(k, v.float().cpu().numpy()) for k, v in named(g)]
    return out


def port_grads(device, seed) -> dict:
    """{policy: {kind: gradient}} of the port on ``device``."""
    return {k: kinds(v) for k, v in port_named(device, seed).items()}


def per_layer(device, seed) -> dict:
    """Each SSM layer's ``A_log`` bf16-vs-f32 error on ``device`` and on
    the CPU port, in layer order, and the first layer (backward order)
    where ``device``'s is more than 1.25x the CPU's."""
    errs, whole = {}, {}
    for dev in (device, "cpu"):
        g = port_named(dev, seed)
        k = kinds(g["bf16"]), kinds(g["f32"])
        whole[str(dev)] = rel(k[0]["A_log"], k[1]["A_log"])
        g = {k: dict(v) for k, v in g.items()}
        errs[str(dev)] = {p: rel(g["bf16"][p], g["f32"][p])
                          for p in g["f32"] if p.endswith("/A_log")}
    card, cpu = errs[str(device)], errs["cpu"]
    rows = []
    for p in card:
        rows.append((p, card[p], cpu[p], card[p] / cpu[p]))
        print(f"  {p[:-len('/A_log')]}: {device} {card[p]:.4f}, cpu "
              f"{cpu[p]:.4f} ({card[p] / cpu[p]:.2f}x)", flush=True)
    first = next((r[0] for r in reversed(rows) if r[3] > 1.25), None)
    print(f"seed {seed}: every layer's A_log together: {device} "
          f"{whole[str(device)]:.4f}, cpu {whole['cpu']:.4f} "
          f"({whole[str(device)] / whole['cpu']:.2f}x); the first layer in "
          f"backward order whose {device} error is more than 1.25x the "
          f"CPU's: {first}", flush=True)
    return {"layers": rows, "whole": whole, "first_outgrown": first}


def reference_grads(seed) -> dict:
    import jax
    import jax.numpy as jnp

    from repro import configs as rcfgs
    from repro.models import model as rmodel
    params, tok = inputs(seed)
    rc = rcfgs.SMOKE[ARCH]
    out = {}
    for name, c in (("bf16", rc), ("f32", dataclasses.replace(
            rc, policy=dataclasses.replace(rc.policy, compute_dtype=jnp.float32,
                                           cache_dtype=jnp.float32)))):
        g = jax.grad(lambda p: rmodel.loss_fn(
            c, p, {"tokens": jnp.asarray(tok)})[0])(
            jax.tree.map(jnp.asarray, params))
        out[name] = kinds(named(jax.tree.map(lambda a: jax.device_get(a), g)))
    return out


def f32_heads(seed) -> dict:
    """The port's per-head errors on the CPU with B and C broadcast to the
    heads in f32: the plain version then sums their per-head gradients
    in f32 and rounds once."""
    from repro_torch.models import ssm
    heads = ssm._heads
    ssm._heads = lambda t, H: heads(t.float(), H)
    try:
        g = port_grads("cpu", seed)
    finally:
        ssm._heads = heads
    return {k: rel(g["bf16"][k], g["f32"][k]) for k in KINDS}


def full_width(device, reference) -> dict:
    """The whole gradient's bf16-vs-f32 relative L2 at zamba2-1.2b's full
    width, 6 layers, one 512-token row."""
    import numpy as np
    import torch

    from repro_torch import configs
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.models import init_model
    from repro_torch.models.training import loss_and_grads
    full = configs.get(ARCH)
    cfg = dataclasses.replace(full, n_layers=6)
    f32 = dataclasses.replace(cfg, policy=dataclasses.replace(
        cfg.policy, compute_dtype=torch.float32, cache_dtype=torch.float32))
    params = init_model(f32, torch.Generator().manual_seed(0))
    tok = SyntheticLM(full, DataConfig(global_batch=8, seq_len=512)).batch(
        0)["tokens"][:1]
    whole = lambda g: np.concatenate([np.asarray(v, np.float32).ravel()
                                      for _, v in g])
    grads = {}
    for name, c in (("bf16", cfg), ("f32", f32)):
        p = tree_map(lambda t: t.to(device), params)
        _, _, g = loss_and_grads(c, p, {"tokens": torch.from_numpy(tok).to(
            device)})
        grads[name] = whole([(k, v.float().cpu().numpy())
                             for k, v in named(g)])
    out = {"port": rel(grads["bf16"], grads["f32"])}
    print(f"{ARCH} at full width, 6 layers, one 512-token row ({device}): "
          f"the port's bf16 gradient {out['port']:.4f} from its f32 one",
          flush=True)
    if reference:
        import jax
        import jax.numpy as jnp

        from repro import configs as rcfgs
        from repro.models import model as rmodel
        rc = dataclasses.replace(rcfgs.ARCHS[ARCH], n_layers=6)
        jp = jax.tree.map(jnp.asarray, tree_map(lambda t: t.numpy(), params))
        rg = {}
        for name, c in (("bf16", rc), ("f32", dataclasses.replace(
                rc, policy=dataclasses.replace(
                    rc.policy, compute_dtype=jnp.float32,
                    cache_dtype=jnp.float32)))):
            g = jax.grad(lambda q: rmodel.loss_fn(
                c, q, {"tokens": jnp.asarray(tok)})[0])(jp)
            rg[name] = whole(named(jax.device_get(g)))
        out["reference"] = rel(rg["bf16"], rg["f32"])
        print(f"  the reference's {out['reference']:.4f}", flush=True)
    return out


def per_head(device) -> dict:
    res = {}
    for seed in SEEDS:
        g = port_grads(device, seed)
        res[seed] = {k: rel(g["bf16"][k], g["f32"][k]) for k in KINDS}
        print(f"seed {seed} ({device}): " + ", ".join(
            f"{k} {v:.4f}" for k, v in res[seed].items()), flush=True)
    return res


# ------------------------------------------------------- the block split
def torch_block(cfg, bp, h, t):
    """The port's SSM block (pre-norm, ``ssm_apply``'s prefill, residual),
    each intermediate passed through ``t(name, value)``."""
    import torch
    import torch.nn.functional as F

    from repro_torch.models import layers, ssm
    B, S, _ = h.shape
    d_in, H, Pd, G, N = ssm.ssm_dims(cfg)
    cd = h.dtype
    p = bp["ssm"]
    hn = t("hn", layers.rmsnorm(h, bp["ln"], cfg.rms_eps))
    zxbcdt = t("zxbcdt", hn @ p["in_proj"].to(cd))
    z = zxbcdt[..., :d_in]
    xBC = zxbcdt[..., d_in:2 * d_in + 2 * G * N]
    dt = t("dt", F.softplus(zxbcdt[..., 2 * d_in + 2 * G * N:].float()
                            + p["dt_bias"].float()))
    A = -torch.exp(p["A_log"].float())
    xBC_c = t("xBC_c", F.silu(ssm._causal_conv(
        xBC, p["conv_w"].to(cd), p["conv_b"].to(cd)).float()).to(cd))
    x = xBC_c[..., :d_in].reshape(B, S, H, Pd)
    Bc = xBC_c[..., d_in:d_in + G * N].reshape(B, S, G, N)
    Cc = xBC_c[..., d_in + G * N:].reshape(B, S, G, N)
    y4 = t("y4", ssm.ssd_chunked(x, dt, A, Bc, Cc, min(cfg.ssd_chunk, S))[0])
    y = t("y", (y4.float() + p["D_skip"].float()[None, None, :, None]
                * x.float()).reshape(B, S, d_in).to(cd))
    g = t("g", (y.float() * F.silu(z.float())).to(cd))
    gn = t("gn", layers.rmsnorm(g, p["norm_w"], cfg.rms_eps))
    return h + t("out", gn @ p["out_proj"].to(cd))


def jax_block(cfg, bp, h, t):
    """The reference's SSM block, the same taps."""
    import jax
    import jax.numpy as jnp

    from repro.models import layers, ssm
    B, S, _ = h.shape
    d_in, H, Pd, G, N = ssm.ssm_dims(cfg)
    cd = h.dtype
    p = bp["ssm"]
    hn = t("hn", layers.rmsnorm(h, bp["ln"], cfg.rms_eps))
    zxbcdt = t("zxbcdt", hn @ p["in_proj"].astype(cd))
    z = zxbcdt[..., :d_in]
    xBC = zxbcdt[..., d_in:2 * d_in + 2 * G * N]
    dt = t("dt", jax.nn.softplus(
        zxbcdt[..., 2 * d_in + 2 * G * N:].astype(jnp.float32)
        + p["dt_bias"].astype(jnp.float32)))
    A = -jnp.exp(p["A_log"].astype(jnp.float32))
    xBC_c = t("xBC_c", jax.nn.silu(ssm._causal_conv(
        xBC, p["conv_w"].astype(cd), p["conv_b"].astype(cd)).astype(
        jnp.float32)).astype(cd))
    x = xBC_c[..., :d_in].reshape(B, S, H, Pd)
    Bc = xBC_c[..., d_in:d_in + G * N].reshape(B, S, G, N)
    Cc = xBC_c[..., d_in + G * N:].reshape(B, S, G, N)
    y4 = t("y4", ssm.ssd_chunked(x, dt, A, Bc, Cc, min(cfg.ssd_chunk, S))[0])
    y = t("y", (y4 + p["D_skip"].astype(jnp.float32)[None, None, :, None]
                * x.astype(jnp.float32)).reshape(B, S, d_in).astype(cd))
    g = t("g", (y.astype(jnp.float32) * jax.nn.silu(
        z.astype(jnp.float32))).astype(cd))
    gn = t("gn", layers.rmsnorm(g, p["norm_w"], cfg.rms_eps))
    return h + t("out", gn @ p["out_proj"].astype(cd))


def split() -> dict:
    import jax
    import jax.numpy as jnp
    import numpy as np
    import torch

    from repro import configs as rcfgs
    params, tok = inputs(SPLIT_SEED)
    bp = params["segments"]["seg0"]["0"]
    block = dict(named(bp))
    embed = params["embed"]
    h16 = torch.from_numpy(embed).to(torch.bfloat16)[torch.from_numpy(tok)]
    dout = torch.from_numpy(np.random.default_rng(7).standard_normal(
        h16.shape).astype(np.float32)).to(torch.bfloat16)
    cfg16, cfg32 = port_cfgs()

    def chained(block_fn, bp_, h, dout_, zeros, grad):
        """The cotangent of every tapped intermediate and the parameters'
        gradients: one forward records the intermediates, then ``grad``
        differentiates the block with a zero added at each tap."""
        inter = {}

        def record(name, v):
            inter[name] = v
            return v
        block_fn(bp_, h, record)
        tp = {n: zeros(inter[n]) for n in TAPS}
        return grad(lambda p, t: block_fn(p, h, lambda n, v: v + t[n]),
                    bp_, tp, dout_)

    def port(cfg, dtype):
        ps = tree_map(lambda v: torch.from_numpy(v).requires_grad_(), bp)

        def grad(fn, p, tp, d):
            fn(p, tp).backward(d)
            out = {n: t.grad.float().numpy() for n, t in tp.items()}
            out.update({k.strip("/"): v.grad.float().numpy()
                        for k, v in named(p)})
            return out
        return chained(lambda p, h, t: torch_block(cfg, p, h, t), ps,
                       h16.to(dtype), dout.to(dtype),
                       lambda v: torch.zeros_like(v).requires_grad_(), grad)

    def reference():
        rc = rcfgs.SMOKE[ARCH]

        def grad(fn, p, tp, d):
            _, vjp = jax.vjp(fn, p, tp)
            gp, gt = vjp(d)
            out = {n: np.asarray(v, np.float32) for n, v in gt.items()}
            out.update({k.strip("/"): np.asarray(v, np.float32)
                        for k, v in named(jax.device_get(gp))})
            return out
        return chained(lambda p, h, t: jax_block(rc, p, h, t),
                       jax.tree.map(jnp.asarray, bp),
                       jnp.asarray(h16.float().numpy(), jnp.bfloat16),
                       jnp.asarray(dout.float().numpy(), jnp.bfloat16),
                       jnp.zeros_like, grad)

    exact = port(cfg32, torch.float32)
    got = {"port": port(cfg16, torch.bfloat16), "reference": reference()}
    rows = {}
    for n in TAPS[::-1] + tuple(k.strip("/") for k in sorted(block)):
        e = {k: rel(g[n], exact[n]) for k, g in got.items()}
        rows[n] = e
        ratio = (f"{e['port'] / e['reference']:.2f}x" if e["reference"]
                 else "-")
        print(f"  d{n:18s} port {e['port']:.5f}  reference "
              f"{e['reference']:.5f}  ({ratio})")
    return rows


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None)
    ap.add_argument("--reference", action="store_true")
    ap.add_argument("--card", default=None)
    ap.add_argument("--split", action="store_true")
    ap.add_argument("--f32-heads", action="store_true")
    ap.add_argument("--full-width", action="store_true")
    ap.add_argument("--layers", action="store_true")
    ap.add_argument("--seed", type=int, default=6)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    import torch
    dev = torch.device(args.device or "cuda")
    if dev.type == "cuda":
        import subprocess
        if not torch.cuda.is_available():
            sys.exit("f5_grad: no CUDA card (pass --device cpu)")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, check=True).stdout.strip())
    if args.split:
        print(f"the first SSM block of {ARCH}'s smoke config, seed "
              f"{SPLIT_SEED}: relative L2 of each bf16 cotangent and "
              "gradient from the port's f32 one, chained from the output")
        split()
        return
    if args.layers:
        from repro_torch.kernels.ssd_chunk import ssd_chunk_bwd
        print(f"{ARCH}'s smoke config, seed {args.seed}: each SSM layer's "
              "A_log, bf16 vs f32 policy, relative L2")
        res = per_layer(dev, args.seed)
        res["routes"] = dict(ssd_chunk_bwd.route_launches)
        print(f"  ssd_chunk_bwd routes on {dev}: {res['routes']}")
        if args.out:
            pathlib.Path(args.out).write_text(json.dumps(res, indent=1))
        return
    if args.full_width:
        res = full_width(dev, args.reference)
        if args.out:
            pathlib.Path(args.out).write_text(json.dumps(res, indent=1))
        return
    if args.f32_heads:
        for seed in SEEDS:
            base, var = port_grads("cpu", seed), f32_heads(seed)
            print(f"seed {seed}: " + "; ".join(
                f"{k} {rel(base['bf16'][k], base['f32'][k]):.4f}, with f32 "
                f"heads {var[k]:.4f}" for k in KINDS), flush=True)
        return
    res = {"port": per_head(dev)}
    if args.reference:
        card = json.loads(pathlib.Path(args.card).read_text())["port"] \
            if args.card else None
        for seed in SEEDS:
            r = reference_grads(seed)
            ref = {k: rel(r["bf16"][k], r["f32"][k]) for k in KINDS}
            cols = []
            for k in KINDS:
                p = res["port"][seed][k]
                c = f"{k}: reference {ref[k]:.4f}, port cpu {p:.4f} " \
                    f"({p / ref[k]:.2f}x)"
                if card:
                    q = card[str(seed)][k]
                    c += f", port card {q:.4f} ({q / ref[k]:.2f}x)"
                cols.append(c)
            print(f"seed {seed}: " + "; ".join(cols), flush=True)
    if args.out:
        pathlib.Path(args.out).write_text(json.dumps(res, indent=1))


if __name__ == "__main__":
    main()
