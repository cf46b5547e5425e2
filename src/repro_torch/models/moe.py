"""Token-choice top-k MoE with capacity-based scatter dispatch — the port
of ``repro.models.moe`` (``moe_spec``, ``capacity_for``, ``moe_apply``
with its one-device path ``_moe_gspmd`` and its expert-parallel path
``_moe_shard_map``).

Dispatch avoids the ``[T, E, C]`` one-hot: each token choice's position
in its expert is a cumsum over a ``[T*k, E]`` int32 one-hot, and the
token embeddings are scattered into an ``[E*C + 1, D]`` buffer whose last
row takes the choices past an expert's capacity C (dropped).  The order
of the flattened ``[T*k]`` choices (token-major) decides who is dropped.
The router product, the expert products (``torch.bmm`` over all E
experts, as the reference's einsums) and the shared experts are plain
torch: the reference computes them outside any Pallas kernel.

On a mesh (``ctx.mesh``, a ``launch.mesh.Mesh``) ``moe_apply`` takes
the reference's rule (``repro/models/moe.py:59-63``): the expert-parallel
path when the mesh has a "model" axis, ``cfg.moe_shard_map`` is set and
the M model ranks divide the E experts.  A rank holds its data rank's
rows ``[B / n_dp, S, D]``, replicated over its model ranks, and the
block's leaves as their specs' shards (experts over "model", D over the
data axes where it divides; the shared experts' hidden dim over "model"
too, gathered whole where they are used, ``_shared``).  It takes
sequence block m of its rows (t_loc = T / (n_dp M) tokens, the
reference's device block),
gathers the weights' data shards, routes and dispatches into an
``[E * C, D]`` buffer at the per-rank capacity C, exchanges it with ONE
``all_to_all`` over the model group each way around the local experts'
products, combines, and all-gathers the blocks along the sequence over
the model group.  aux is the mean over all ranks of each rank's aux, as
the reference's ``pmean``.  When the shape does not split (``T % n_dev``,
``S % M`` or ``B % n_dp``: every decode step, S = 1), or the rule does
not hold, the reference runs ``_moe_gspmd`` over the GLOBAL batch with
the global capacity; the port gathers the data group's tokens, routes
them all in global order, computes only the local experts' rows of the
buffer, all-gathers those rows over the model group, and keeps its own
rows.  ``models.comm`` gives each collective its backward.
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.models import comm
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import swiglu
from repro_torch.models.params import P, pspecs
from repro_torch.sharding import NOSHARD, spec_axes


def moe_spec(cfg: ModelConfig) -> dict:
    D, E = cfg.d_model, cfg.n_experts
    Fe = cfg.d_ff_expert or cfg.d_ff
    s = {
        "router": P((D, E), ("embed", None)),
        "wg": P((E, D, Fe), ("experts", "embed", "expert_mlp")),
        "wi": P((E, D, Fe), ("experts", "embed", "expert_mlp")),
        "wo": P((E, Fe, D), ("experts", "expert_mlp", "embed")),
    }
    if cfg.n_shared_experts:
        Fs = Fe * cfg.n_shared_experts
        s["shared"] = {
            "wg": P((D, Fs), ("embed", "mlp")),
            "wi": P((D, Fs), ("embed", "mlp")),
            "wo": P((Fs, D), ("mlp", "embed")),
        }
    return s


# the router and the expert stacks: gathered over the data axes only
# (``_weights``), the expert dim staying split for the dispatch
SHARDED = ("router", "wg", "wi", "wo")


def placement(cfg: ModelConfig, mesh) -> dict:
    """One MoE block's leaves as a rank of ``mesh`` holds them: each
    under its partition spec, the shared experts' too."""
    return pspecs(moe_spec(cfg), mesh)


def capacity_for(cfg: ModelConfig, n_tokens: int) -> int:
    """Slots an expert: ``ceil(T k / E * capacity_factor)`` rounded up to
    a multiple of 8, at least 8 (so a decode step's T = B still has 8)."""
    c = math.ceil(n_tokens * cfg.top_k / cfg.n_experts * cfg.capacity_factor)
    return max(8, (c + 7) // 8 * 8)


def top_k(gates, k: int):
    """``jax.lax.top_k`` over the last dim: the k largest, descending, the
    lower index first among equal values.  ``torch.topk`` promises no
    order on ties, and bf16 router logits tie often (two of 160 experts),
    so this is a stable descending sort."""
    vals, idx = torch.sort(gates, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def route(cfg: ModelConfig, p: dict, x):
    """The router: x [T, D] in the compute dtype -> (gates [T, E] f32,
    topv [T, k] renormalised, topi [T, k]); the logits are taken in x's
    dtype and widened, as the reference's."""
    logits = (x @ p["router"].to(x.dtype)).float()
    gates = torch.softmax(logits, dim=-1)
    topv, topi = top_k(gates, cfg.top_k)
    topv = topv / torch.clamp(topv.sum(-1, keepdim=True), min=1e-9)
    return gates, topv, topi


def dispatch(cfg: ModelConfig, topi, C: int):
    """Each flattened choice's buffer row: (dest [T*k], keep [T*k]).  The
    choice j of expert e at position ``mypos`` (the count of earlier
    choices of e, token-major) goes to row ``e * C + mypos`` if
    ``mypos < C``, else to the discard row ``E * C``."""
    E = cfg.n_experts
    fe = topi.reshape(-1)
    onehot = (fe[:, None] == torch.arange(E, device=fe.device)[None, :]
              ).to(torch.int32)
    pos_all = torch.cumsum(onehot, dim=0) - 1                  # [T*k, E]
    mypos = torch.gather(pos_all, 1, fe[:, None])[:, 0]
    keep = mypos < C
    dest = torch.where(keep, fe * C + mypos, E * C)
    return dest, keep


def expert_parallel(cfg: ModelConfig, ctx=NOSHARD) -> bool:
    """The reference's rule for ``_moe_shard_map``: a mesh with a "model"
    axis, ``cfg.moe_shard_map``, and E divisible by the model ranks."""
    mesh = ctx.mesh
    return (mesh is not None and cfg.moe_shard_map
            and "model" in mesh.axis_names
            and cfg.n_experts % mesh.axis_size(("model",)) == 0)


def moe_apply(cfg: ModelConfig, p: dict, h, *, want_aux: bool = True,
              ctx=NOSHARD):
    """h: [B, S, D] -> (out [B, S, D], aux) with aux the Switch-style
    load-balance loss ``E * sum(f_e * mean(gates))`` (f32 scalar; f_e the
    share of the T*k choices that picked e), or None when not
    ``want_aux`` (serving skips it).  On a mesh, h is this rank's rows
    and ``p`` holds the rank's shards (module docstring)."""
    if ctx.mesh is None:
        return _moe_one_device(cfg, p, h, want_aux)
    if expert_parallel(cfg, ctx):
        # the reference's T % n_dev, S % M and B % n_dp: a rank holds
        # B / n_dp whole rows, so only S % M can fail
        if h.shape[1] % ctx.mesh.axis_size(("model",)) == 0:
            return _moe_expert_parallel(cfg, p, h, ctx, want_aux)
    return _moe_global(cfg, p, h, ctx, want_aux)


def _experts(xe, p: dict, cd):
    """The experts' SwiGLU on their buffer rows: xe [E', C', D] against
    stacks of E' experts -> [E', C', D]."""
    g = torch.bmm(xe, p["wg"].to(cd))
    u = torch.bmm(xe, p["wi"].to(cd))
    act = F.silu(g.float()).to(cd) * u
    return torch.bmm(act, p["wo"].to(cd))


def _aux(cfg: ModelConfig, gates, topi):
    E, k = cfg.n_experts, cfg.top_k
    T = gates.shape[0]
    f_e = torch.zeros(E, dtype=torch.float32, device=gates.device
                      ).index_add_(0, topi.reshape(-1),
                                   torch.ones(T * k, dtype=torch.float32,
                                              device=gates.device)) / (T * k)
    return E * torch.sum(f_e * gates.mean(0))


def _combine(ye_rows, dest, keep, topv, k: int):
    """Each token's output: the sum over its k choices of the expert row
    it was given (the discard row is zeros) times its gate."""
    D = ye_rows.shape[-1]
    y_pad = torch.cat([ye_rows, ye_rows.new_zeros((1, D))], 0)
    n = dest.shape[0]
    y_tok = y_pad[dest] * (keep[:, None] * topv.reshape(n)[:, None]
                           ).to(ye_rows.dtype)
    return y_tok.reshape(n // k, k, D).sum(dim=1)


def _shared(cfg: ModelConfig, p: dict, x, cd, ctx=NOSHARD):
    """The shared experts' SwiGLU on x [T, D]; on a mesh their weights
    cast to ``cd`` and gathered from this rank's shards where they are
    used, as every dense weight (``comm.whole``)."""
    sp = p["shared"]
    if ctx.mesh is not None:
        specs = placement(cfg, ctx.mesh)["shared"]
        sp = {k: comm.whole(sp[k].to(cd), specs[k], ctx.mesh) for k in sp}
    return swiglu(x, sp["wg"], sp["wi"], sp["wo"], cd)


def _moe_one_device(cfg: ModelConfig, p: dict, h, want_aux: bool):
    B, S, D = h.shape
    E, k = cfg.n_experts, cfg.top_k
    T = B * S
    C = capacity_for(cfg, T)
    cd = h.dtype
    x = h.reshape(T, D)
    gates, topv, topi = route(cfg, p, x)
    aux = _aux(cfg, gates, topi) if want_aux else None
    dest, keep = dispatch(cfg, topi, C)
    x_rep = x.repeat_interleave(k, dim=0)                      # [T*k, D]
    # repeated targets only on the discard row, which is sliced away
    buf = torch.zeros((E * C + 1, D), dtype=cd, device=h.device)
    buf = buf.index_copy(0, dest, x_rep)
    ye = _experts(buf[:E * C].reshape(E, C, D), p, cd)         # [E, C, D]
    out = _combine(ye.reshape(E * C, D), dest, keep, topv, k)
    if cfg.n_shared_experts:
        out = out + _shared(cfg, p, x, cd)
    return out.reshape(B, S, D), aux


def _weights(cfg: ModelConfig, p: dict, ctx) -> dict:
    """The router and expert stacks with their data-axis (FSDP) shards
    gathered: each dim split over data axes is all-gathered over their
    group, whose backward sums the gradient over it (a reduce-scatter).
    The expert dim stays split over "model"."""
    mesh, specs = ctx.mesh, placement(cfg, ctx.mesh)
    out = {}
    for name in SHARDED:
        w, ps = p[name], specs[name]
        for dim in range(len(ps)):
            axes = tuple(a for a in spec_axes(ps, dim) if a in ctx.dp_axes)
            if axes:
                w = comm.gather(w, dim, mesh.group(axes), grad="sum")
        out[name] = w
    return out


def _moe_expert_parallel(cfg: ModelConfig, p: dict, h, ctx, want_aux):
    """``_moe_shard_map``'s body on this rank (module docstring)."""
    mesh = ctx.mesh
    mg = mesh.group(("model",))
    M = mesh.axis_size(("model",))
    E, k, D = cfg.n_experts, cfg.top_k, h.shape[-1]
    E_loc = E // M
    cd = h.dtype
    xb = comm.scatter(h, 1, mg)                     # [B_loc, S / M, D]
    t_loc = xb.shape[0] * xb.shape[1]
    C = capacity_for(cfg, t_loc)                    # per-rank capacity
    xf = xb.reshape(t_loc, D)
    w = _weights(cfg, p, ctx)
    # the router is replicated over the model ranks, each routing its
    # own block of tokens: its gradient is their sum
    w["router"] = comm.sum_grad(w["router"], mg)
    gates, topv, topi = route(cfg, w, xf)
    aux = None
    if want_aux:
        # the mean over all ranks; a data rank's loss holds it whole, so
        # each rank's share of its gradient is 1 / M
        aux = comm.mean(_aux(cfg, gates, topi), mesh.group(mesh.axis_names),
                        1.0 / M)
    dest, keep = dispatch(cfg, topi, C)
    buf = torch.zeros((E * C + 1, D), dtype=cd, device=h.device)
    buf = buf.index_copy(0, dest, xf.repeat_interleave(k, dim=0))
    send = buf[:E * C].reshape(M, E_loc * C, D)
    recv = comm.all_to_all(send, mg)                # [M, E_loc * C, D]
    xe = recv.reshape(M, E_loc, C, D).transpose(0, 1).reshape(
        E_loc, M * C, D)
    ye = _experts(xe, w, cd)
    back = ye.reshape(E_loc, M, C, D).transpose(0, 1).reshape(
        M, E_loc * C, D)
    mine = comm.all_to_all(back, mg)
    out = _combine(mine.reshape(E * C, D), dest, keep, topv, k)
    out = comm.gather(out.reshape(xb.shape), 1, mg)  # [B_loc, S, D]
    if cfg.n_shared_experts:
        out = out + _shared(cfg, p, h.reshape(-1, D), cd,
                            ctx).reshape(h.shape)
    return out, aux


def _moe_global(cfg: ModelConfig, p: dict, h, ctx, want_aux):
    """``_moe_gspmd`` over the global batch, on this rank's rows (module
    docstring): no expert weight is gathered over the model axis."""
    mesh = ctx.mesh
    dg = ctx.data_group
    B_loc, S, D = h.shape
    E, k = cfg.n_experts, cfg.top_k
    cd = h.dtype
    x_loc = h.reshape(-1, D)
    x = comm.gather(x_loc, 0, dg, grad="sum")       # [T, D], global order
    T = x.shape[0]
    C = capacity_for(cfg, T)
    w = _weights(cfg, p, ctx)
    gates, topv, topi = route(cfg, w, x)
    aux = _aux(cfg, gates, topi) if want_aux else None
    dest, keep = dispatch(cfg, topi, C)
    buf = torch.zeros((E * C + 1, D), dtype=cd, device=h.device)
    buf = buf.index_copy(0, dest, x.repeat_interleave(k, dim=0))
    xe = buf[:E * C].reshape(E, C, D)
    e_axes = spec_axes(placement(cfg, mesh)["wg"], 0)
    eg = mesh.group(e_axes) if e_axes else None
    ye = comm.gather(_experts(comm.scatter(xe, 0, eg), w, cd), 0, eg)
    # this rank's rows: its data rank's block of the global tokens
    i = 0 if dg is None else dist.get_rank(dg)
    own = slice(i * x_loc.shape[0] * k, (i + 1) * x_loc.shape[0] * k)
    out = _combine(ye.reshape(E * C, D), dest[own], keep[own],
                   topv.reshape(-1)[own], k)
    if cfg.n_shared_experts:
        out = out + _shared(cfg, p, x_loc, cd, ctx)
    return out.reshape(B_loc, S, D), aux
