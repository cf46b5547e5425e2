"""Model assembly for all 10 architectures: the serving and training
paths of the dense decoders (gemma3's 5:1 local:global sliding window
among them), the MoE decoders (llama4-maverick's dense/MoE interleave,
deepseek-v2's dense first layer, MLA and MoE), mamba2, zamba2's hybrid
stack and the two modality-frontend stubs (hubert's audio frames, llava's
vision patches) — the port of ``repro.models.model``.

A config is compiled into the reference's *plan*: an optional prefix of
looped layers plus a run of stacked pattern-repeats (and a looped tail).
The parameter and cache trees keep the reference's names and layout
(stacked ``[L, ...]`` leaves under ``segments/seg<i>``, zamba2's shared
attention block at the top level under ``shared_attn``, an empty ``{}``
block at each of its positions, hubert's frame projection at the top
level under ``frontend``, an MLA cache's ``ckv`` leaf in place of ``k``
and ``v``), so the tests compare like with like; the reference's
``lax.scan`` over the stack becomes a Python loop over the layer index,
each stacked leaf unbound into its layers once (so autograd stacks the
layers' gradients in one step).  Every block kind of the reference is
ported: dense, MoE (``models/moe.py``: the one-device dispatch, and on a
mesh the expert-parallel one), SSM and shared attention, with GQA or MLA, global or windowed.  A windowed
layer's decode step attends to the whole filled cache, as the
reference's does (``layers.attention``; ROADMAP Queue 3 R1).

On a mesh (``ctx = sharding.ShardCtx(mesh)``, the reference's ``ctx``)
a rank holds its data rank's rows of the batch, replicated over its
model ranks, and the parameters as ``param_placement`` places them: the
MoE layers' router and expert stacks as their specs' shards, every other
leaf whole.  Attention, the norms and the dense FFN compute replicated
over the model ranks (tensor parallelism and FSDP of the dense weights
change the layout, not the values, and are not ported); the MoE layers
run expert-parallel (``moe.moe_apply``); ``loss_fn``'s CE is the ratio
of the data group's summed loss and count.

The MoE layers' load-balance losses are summed only for ``loss_fn``
(``ce + 0.01 * aux``, as the reference's); ``forward``, ``prefill`` and
``decode_step`` skip them.

Training (``loss_fn``): the f32 master weights go in as they are, and
every float weight of two or more dims is cast to the compute dtype where
it is used, as the reference's ``_constrain_params`` does; the cast is
differentiable, so the gradients land on the f32 leaves.  Under
``cfg.policy.remat`` each layer of a stacked segment runs under
``torch.utils.checkpoint`` (the reference's ``jax.checkpoint`` of the
scan body), so its activations are recomputed in the backward.  Serving
casts once instead (``cast_params``) and never checkpoints.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.coherence.fabric.backend import resolve_device
from repro_torch.models import attention as attn_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import chunked_xent, rmsnorm, swiglu
from repro_torch.models.params import (P, map_with_path, materialize,
                                       materialize_shard, pspecs,
                                       shard_params, stack_specs)
from repro_torch.sharding import NOSHARD, ShardCtx

@dataclasses.dataclass(frozen=True)
class LayerDesc:
    kind: str          # dense | moe | ssm | attn_shared
    window: int = 0


@dataclasses.dataclass(frozen=True)
class Segment:
    mode: str                      # "scan" | "loop"
    pattern: Tuple[LayerDesc, ...]
    repeats: int                   # scan: >=1; loop: always 1


def build_plan(cfg: ModelConfig) -> List[Segment]:
    descs = [LayerDesc(cfg.layer_kind(i), cfg.attn_window(i))
             for i in range(cfg.n_layers)]
    prefix = cfg.first_dense
    segs: List[Segment] = []
    if prefix:
        segs.append(Segment("loop", tuple(descs[:prefix]), 1))
    rest = descs[prefix:]
    n = len(rest)
    period = n
    for p in range(1, min(16, n) + 1):
        reps = n // p
        if reps >= 2 and all(rest[i] == rest[i % p] for i in range(p * reps)):
            period = p
            break
    reps = n // period
    if reps >= 2:
        segs.append(Segment("scan", tuple(rest[:period]), reps))
        rem = rest[period * reps:]
        if rem:
            segs.append(Segment("loop", tuple(rem), 1))
    elif n:
        segs.append(Segment("loop", tuple(rest), 1))
    return segs


# ------------------------------------------------------------------ specs
def attn_block_spec(cfg: ModelConfig) -> dict:
    """A dense attention block (GQA, or MLA under ``cfg.is_mla``);
    zamba2's one shared block has the same spec
    (``repro.models.model.shared_block_spec``)."""
    D = cfg.d_model
    ln = lambda: P((D,), (None,), "zeros")
    attn = attn_mod.mla_spec(cfg) if cfg.is_mla else attn_mod.gqa_spec(cfg)
    return {"ln1": ln(), "attn": attn, "ln2": ln(),
            "mlp": {"wg": P((D, cfg.d_ff), ("embed", "mlp")),
                    "wi": P((D, cfg.d_ff), ("embed", "mlp")),
                    "wo": P((cfg.d_ff, D), ("mlp", "embed"))}}


def block_spec(cfg: ModelConfig, desc: LayerDesc) -> dict:
    if desc.kind == "ssm":
        return {"ln": P((cfg.d_model,), (None,), "zeros"),
                "ssm": ssm_mod.ssm_spec(cfg)}
    if desc.kind == "attn_shared":
        return {}                      # the weights live at the top level
    s = attn_block_spec(cfg)
    if desc.kind == "moe":             # the experts in place of the MLP
        del s["mlp"]
        s["moe"] = moe_mod.moe_spec(cfg)
    return s


def model_spec(cfg: ModelConfig) -> dict:
    D, V = cfg.d_model, cfg.vocab
    spec: dict = {"embed": P((V, D), ("vocab", "embed"))}
    if cfg.frontend == "audio":
        spec["frontend"] = P((cfg.d_frontend, D), (None, "embed"))
    seg_specs = {}
    segs = build_plan(cfg)
    for si, seg in enumerate(segs):
        body = {str(j): block_spec(cfg, d) for j, d in enumerate(seg.pattern)}
        if seg.mode == "scan":
            body = stack_specs(body, seg.repeats)
        seg_specs[f"seg{si}"] = body
    spec["segments"] = seg_specs
    if any(d.kind == "attn_shared" for s in segs for d in s.pattern):
        spec["shared_attn"] = attn_block_spec(cfg)
    spec["ln_f"] = P((D,), (None,), "zeros")
    if not cfg.tie_embeddings:
        spec["unembed"] = P((D, V), ("embed", "vocab"))
    return spec


def block_cache_spec(cfg: ModelConfig, desc: LayerDesc, batch: int,
                     max_len: int, seq_axis: str) -> dict:
    """An SSM position holds its conv tail and state; every attention
    position, shared or not, holds a KV cache of its own (MLA: the
    compressed ``ckv``)."""
    if desc.kind == "ssm":
        return ssm_mod.ssm_cache_spec(cfg, batch)
    if cfg.is_mla:
        return attn_mod.mla_cache_spec(cfg, batch, max_len, seq_axis)
    return attn_mod.gqa_cache_spec(cfg, batch, max_len, seq_axis)


def cache_spec(cfg: ModelConfig, batch: int, max_len: int) -> dict:
    seq_axis = "kv_seq" if batch == 1 else "seq"
    out = {}
    for si, seg in enumerate(build_plan(cfg)):
        body = {str(j): block_cache_spec(cfg, d, batch, max_len, seq_axis)
                for j, d in enumerate(seg.pattern)}
        if seg.mode == "scan":
            body = stack_specs(body, seg.repeats)
        out[f"seg{si}"] = body
    return out


# ------------------------------------------------------------------ trees
def tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def layer_trees(tree, n: int) -> List:
    """The ``n`` per-layer trees of a stacked tree: every leaf unbound
    along its first dim once (views; under autograd one ``unbind`` node
    a leaf, whose backward stacks the layers' gradients)."""
    if isinstance(tree, dict):
        parts = {k: layer_trees(v, n) for k, v in tree.items()}
        return [{k: parts[k][r] for k in tree} for r in range(n)]
    return list(tree.unbind(0))


def _stack(trees: List[dict]) -> dict:
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in trees]) for k in first}
    return torch.stack(trees)


def cast_params(cfg: ModelConfig, params: dict) -> dict:
    """Float weights of two or more dims per layer in the compute dtype,
    once.  The reference casts them on every use, per layer slice
    (``model.py:158``, ``attention.py:39``); the values are identical, and
    the model's ``.to(compute_dtype)`` calls become no-ops.  Norm weights
    and biases (one dim per layer, two when stacked) stay in the param
    dtype."""
    cd = cfg.policy.compute_dtype

    def walk(spec, tree):
        if isinstance(spec, P):
            per_layer = len(spec.shape) - (spec.axes[:1] == ("stack",))
            cast = per_layer >= 2 and tree.is_floating_point()
            return tree.to(cd) if cast else tree
        return {k: walk(spec[k], tree[k]) for k in spec}

    return walk(model_spec(cfg), params)


# ------------------------------------------------------------------ forward
def _apply_block(cfg: ModelConfig, desc: LayerDesc, bp: dict, h, *,
                 positions, cache, pos, shared_attn, want_aux=False,
                 ctx: ShardCtx = NOSHARD):
    """One block: (h, new_cache, aux), aux the MoE layer's load-balance
    loss when ``want_aux``, else None."""
    if desc.kind == "ssm":
        y, nc = ssm_mod.ssm_apply(cfg, bp["ssm"],
                                  rmsnorm(h, bp["ln"], cfg.rms_eps),
                                  cache=cache)
        return h + y, nc, None
    p = shared_attn if desc.kind == "attn_shared" else bp
    apply_fn = attn_mod.mla_apply if cfg.is_mla else attn_mod.gqa_apply
    a, nc = apply_fn(cfg, p["attn"], rmsnorm(h, p["ln1"], cfg.rms_eps),
                     positions=positions, cache=cache, pos=pos,
                     window=desc.window)
    h = h + a
    hn = rmsnorm(h, p["ln2"], cfg.rms_eps)
    aux = None
    if desc.kind == "moe":
        m, aux = moe_mod.moe_apply(cfg, bp["moe"], hn, want_aux=want_aux,
                                   ctx=ctx)
    else:
        m = swiglu(hn, p["mlp"]["wg"], p["mlp"]["wi"], p["mlp"]["wo"],
                   h.dtype)
    return h + m, nc, aux


def _add(a, b):
    return b if a is None else a if b is None else a + b


def forward(cfg: ModelConfig, params: dict, tokens, *, patches=None,
            frames=None, cache=None, pos=None, ctx: ShardCtx = NOSHARD):
    """tokens: [B, S] int (None with ``frames``); ``frames`` [B, S,
    d_frontend]: audio frame embeddings, projected by ``frontend`` in
    place of the token embedding; ``patches`` [B, n, D]: vision patch
    embeddings that replace the first n positions' embeddings; ``pos``
    (host int) = cache fill level for a decode step.  Returns (h_final
    [B, S, D], new_cache); the given cache is never written.  With
    ``cfg.policy.remat``, no cache and grad mode on (training), each layer
    of a stacked segment is checkpointed.  On a mesh (``ctx``), the
    inputs and the result are this rank's rows."""
    h, new_cache, _ = _forward(cfg, params, tokens, patches=patches,
                               frames=frames, cache=cache, pos=pos, ctx=ctx)
    return h, new_cache


def _forward(cfg: ModelConfig, params: dict, tokens, *, patches=None,
             frames=None, cache=None, pos=None, want_aux=False,
             ctx: ShardCtx = NOSHARD):
    """``forward``, and the sum of the MoE layers' load-balance losses
    (an f32 scalar, 0 without MoE layers) when ``want_aux``, else None:
    (h_final, new_cache, aux)."""
    cd = cfg.policy.compute_dtype
    if frames is not None:
        h = frames.to(cd) @ params["frontend"].to(cd)
        S = frames.shape[1]
    else:
        S = tokens.shape[1]
        h = params["embed"].to(cd)[tokens]
    if patches is not None:
        h = torch.cat([patches.to(cd), h[:, patches.shape[1]:]], 1)
    shared_attn = params.get("shared_attn")
    positions = torch.arange(S, dtype=torch.int32, device=h.device)
    if pos is not None:
        positions = positions + pos
    new_cache: Dict[str, dict] = {}
    aux_total = None
    for si, seg in enumerate(build_plan(cfg)):
        sp = params["segments"][f"seg{si}"]
        sc = None if cache is None else cache[f"seg{si}"]
        if seg.mode == "loop":
            layers, views = [sp], [sc]
        else:
            layers = layer_trees(sp, seg.repeats)
            views = ([None] * seg.repeats if sc is None
                     else layer_trees(sc, seg.repeats))

        def run_layer(h, bp, bc, pattern=seg.pattern):
            ncs, aux = {}, None
            for j, desc in enumerate(pattern):
                h, nc, a = _apply_block(
                    cfg, desc, bp[str(j)], h, positions=positions,
                    cache=None if bc is None else bc[str(j)], pos=pos,
                    shared_attn=shared_attn, want_aux=want_aux, ctx=ctx)
                ncs[str(j)] = {} if nc is None else nc
                aux = _add(aux, a)
            return h, ncs, aux

        ckpt = (cfg.policy.remat and seg.mode == "scan" and cache is None
                and torch.is_grad_enabled())
        outs = []
        for bp, bc in zip(layers, views):
            if ckpt:
                # the segment's own run_layer, bound now: the backward's
                # recomputation runs after the loop has rebound the name to
                # a later segment's (zamba2's looped tail)
                h, a = checkpoint(
                    lambda hh, b, f=run_layer: f(hh, b, None)[::2], h, bp,
                    use_reentrant=False)
                aux_total = _add(aux_total, a)
                continue
            h, ncs, a = run_layer(h, bp, bc)
            aux_total = _add(aux_total, a)
            outs.append(ncs)
        if cache is not None:
            new_cache[f"seg{si}"] = outs[0] if seg.mode == "loop" \
                else _stack(outs)
    h = rmsnorm(h, params["ln_f"], cfg.rms_eps)
    if want_aux and aux_total is None:
        aux_total = torch.zeros((), dtype=torch.float32, device=h.device)
    return h, (new_cache if cache is not None else None), aux_total


def unembed_matrix(cfg: ModelConfig, params: dict):
    if cfg.tie_embeddings:
        return params["embed"].T
    return params["unembed"]


def loss_fn(cfg: ModelConfig, params: dict, batch: dict,
            ctx: ShardCtx = NOSHARD):
    """Training loss.  batch: ``tokens`` [B, S] (or ``labels`` and an
    optional ``mask``; an encoder always takes them), and ``patches`` or
    ``frames`` for a frontend, tensors on the params' device.  Next-token
    CE: labels are the tokens rolled by one, the last position masked; the
    loss is ``ce + 0.01 * aux``, aux the MoE layers' summed load-balance
    losses (0 without MoE layers).  Returns (loss, {"ce", "aux"}), f32
    scalars.  With ``ctx.data_group`` (a mesh's data axes, or a
    data-parallel group) the batch is this rank's rows and the CE that of
    the global batch: its masked sum and count summed over the group
    before the division, as the reference's one ratio over the whole
    batch; the ranks' mean gradient is the global loss's."""
    tokens = batch.get("tokens")
    h, _, aux = _forward(cfg, params, tokens, patches=batch.get("patches"),
                         frames=batch.get("frames"), want_aux=True, ctx=ctx)
    W = unembed_matrix(cfg, params)
    if cfg.causal and "labels" not in batch:
        ll = torch.roll(tokens, -1, dims=1)       # h[t] predicts tokens[t+1]
        mask = torch.ones(ll.shape, dtype=torch.float32, device=h.device)
        mask[:, -1] = 0.0
    else:
        ll = batch["labels"]
        mask = batch.get("mask")
    ce = chunked_xent(h, W, ll, mask, group=ctx.data_group)
    return ce + 0.01 * aux, {"ce": ce, "aux": aux}


def _next_ids(cfg: ModelConfig, params: dict, h):
    """Greedy ids from the last position: f32 argmax, first index on
    ties, int32 as the reference's."""
    logits = h[:, -1:] @ unembed_matrix(cfg, params).to(h.dtype)
    return torch.argmax(logits.float(), dim=-1)[:, 0].to(torch.int32)


# ------------------------------------------------------------------ serving
def prefill(cfg: ModelConfig, params: dict, tokens, cache, *, patches=None,
            frames=None, ctx: ShardCtx = NOSHARD):
    """Fill the cache from a prompt (tokens, or ``frames``; ``patches``
    over the first positions, as in ``forward``); returns
    (next_token_ids [B], cache), on a mesh this rank's rows."""
    h, new_cache = forward(cfg, params, tokens, patches=patches,
                           frames=frames, cache=cache, ctx=ctx)
    return _next_ids(cfg, params, h), new_cache


def decode_step(cfg: ModelConfig, params: dict, cache, tokens, pos: int,
                ctx: ShardCtx = NOSHARD):
    """One decode step.  tokens: [B, 1]; pos: host int (cache fill
    level).  Returns (next_token_ids [B], new_cache)."""
    h, new_cache = forward(cfg, params, tokens, cache=cache, pos=pos,
                           ctx=ctx)
    return _next_ids(cfg, params, h), new_cache


# ------------------------------------------------------------------ builders
def init_model(cfg: ModelConfig, gen: torch.Generator):
    """Seeded weights on ``gen``'s device, in the param dtype."""
    return materialize(model_spec(cfg), gen, cfg.policy.param_dtype)


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device=None):
    """A zero cache (KV, or SSM conv tail and state) on ``device`` (None =
    the CUDA card)."""
    dev = resolve_device(device)
    return map_with_path(cache_spec(cfg, batch, max_len),
                         lambda _, p: torch.zeros(p.shape, device=dev,
                                                  dtype=cfg.policy.cache_dtype))


# ------------------------------------------------------------------ meshes
def param_placement(cfg: ModelConfig, mesh) -> dict:
    """Every leaf's spec as a rank of ``mesh`` holds it: the MoE layers'
    router and expert stacks (``moe/router``, ``moe/wg``, ``moe/wi``,
    ``moe/wo``) under their ``pspecs``, every other leaf () (whole,
    replicated)."""
    spec = model_spec(cfg)
    full = pspecs(spec, mesh)

    def walk(sp, fs, path):
        if isinstance(sp, P):
            parts = path.split("/")
            held = len(parts) >= 2 and parts[-2] == "moe" \
                and parts[-1] in moe_mod.SHARDED
            return fs if held else ()
        return {k: walk(sp[k], fs[k], f"{path}/{k}") for k in sp}

    return walk(spec, full, "")


def init_model_shard(cfg: ModelConfig, gen: torch.Generator, mesh):
    """This rank's shards of ``init_model(cfg, gen)`` under
    ``param_placement``, drawn one leaf at a time (``materialize_shard``):
    every rank of the mesh draws the same global weights."""
    return materialize_shard(model_spec(cfg), param_placement(cfg, mesh),
                             gen, mesh, cfg.policy.param_dtype)


def shard_model(cfg: ModelConfig, params: dict, mesh) -> dict:
    """This rank's shards of a global parameter tree (or of a moments
    tree of the same structure)."""
    return shard_params(params, param_placement(cfg, mesh), mesh)
