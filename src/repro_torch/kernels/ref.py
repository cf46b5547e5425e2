"""Plain PyTorch versions of the kernels: the ground truth the CUDA
kernels are held to, and what the dispatcher runs on CPU tensors.

Each function is the line-for-line counterpart of its namesake in
``repro/kernels/ref.py`` and runs on any device.  The float half
(``rmsnorm_ref``, ``attention_ref``, ``ssd_chunk_ref``) computes in f32 and casts the result
to the input's dtype, as the Pallas kernels do (their backward is
autograd of these: ``rmsnorm_bwd_ref``, ``attention_bwd_ref``,
``ssd_chunk_bwd_ref``); in particular the softmax
probabilities stay f32 for the PV product, where the reference's jnp
``layers.attention`` rounds them to v's dtype first.  Translation notes
for the coherence half:
``argmax``/``argmin`` pick the FIRST index on ties (an all-false row gives
0), bool masks are cast to int32 before ``argmax``, and every reduction
is cast back to int32 (torch's ``sum``/``cumsum``/``argmax`` return
int64).
"""
from __future__ import annotations

import torch

from repro_torch.core import protocol

_i32 = torch.int32
_NEG = -2 ** 30
NEG_INF = -1e30              # the attention kernels' additive mask value


def _first_index(eq):
    """Index of the first True per row (0 when the row has none)."""
    return torch.argmax(eq.to(_i32), -1).to(_i32)


def lease_probe_ref(tag_rows, rts_rows, cts, addr, mwts=None, mrts=None,
                    *, row=None):
    """HALCONE probe+install math over set rows.

    tag_rows/rts_rows: [N,W], or a tier's [K,W] tables with ``row`` ([N])
    naming each lane's set; cts: [N] or [1]; addr: [N]; mwts/mrts: [N] or
    None for 0.  Returns (tag_hit, hit, way, row_rts, new_wts, new_rts,
    new_cts)."""
    if row is not None:
        tag_rows, rts_rows = tag_rows[row], rts_rows[row]
    zero = torch.zeros_like(addr)
    mwts = zero if mwts is None else mwts
    mrts = zero if mrts is None else mrts
    eq = tag_rows == addr[:, None]
    tag_hit = eq.any(-1)
    way = _first_index(eq)
    rts = torch.gather(rts_rows, 1, way[:, None].long())[:, 0]
    row_rts = torch.where(tag_hit, rts, 0)
    hit = tag_hit & protocol.valid(cts, row_rts)
    lease = protocol.install(cts, mwts, mrts)
    new_cts = protocol.cts_after_write(cts, lease.wts)
    return tag_hit, hit, way, row_rts, lease.wts, lease.rts, new_cts


def _first_match_ref(eq, rows):
    first = eq & (torch.cumsum(eq.to(_i32), -1) == 1)
    return torch.sum(torch.where(first, rows, 0), -1).to(_i32)


def _tsu_grant_ref(memts, is_write, lease_v):
    """Algorithm 3 + the 16-bit overflow reinit (protocol.mm_*), one side
    at a time (``lease_v`` = rd or wr lease per lane)."""
    if is_write:
        lease, new_memts = protocol.mm_write(memts, lease_v)
    else:
        lease, new_memts = protocol.mm_read(memts, lease_v)
    ovf = new_memts > protocol.TS_MAX
    wts = torch.where(ovf, 0, lease.wts)
    rts = torch.where(ovf, lease_v, lease.rts)
    return wts, rts, torch.where(ovf, rts, new_memts), ovf


def miss_round_ref(rp_tag, rp_rts, sh_tag, sh_rts, sh_wts, ts_tag, ts_mem,
                   cts1, cts2, addr, act, rd, *, rows=None):
    """Read-side round math (``kernels.tier_pass.miss_round``): replica
    probe, shared probe, TSU read grant and both install levels — the 16
    per-lane intermediates of ``pipeline.make_miss_pass``'s round body.
    The rows are ``[N, W]`` (lane i on row i), or with ``rows = (s1, s2,
    shard)`` the tiers' ``[K, W]`` tables, each lane's row named by its
    entry; cts1/cts2 are [N] or [1], act int or bool, rd [N] or an int."""
    if rows is not None:
        s1, s2, shard = rows
        rp_tag, rp_rts = rp_tag[s1], rp_rts[s1]
        sh_tag, sh_rts, sh_wts = sh_tag[s2], sh_rts[s2], sh_wts[s2]
        ts_tag, ts_mem = ts_tag[shard], ts_mem[shard]
    act = act != 0
    eq1 = rp_tag == addr[:, None]
    th1 = eq1.any(-1)
    way1 = _first_index(eq1)
    h1 = th1 & protocol.valid(cts1, _first_match_ref(eq1, rp_rts))
    th1, h1 = th1 & act, h1 & act
    miss = act & ~h1

    eq2 = sh_tag == addr[:, None]
    th2 = eq2.any(-1)
    way2 = _first_index(eq2)
    rts2 = _first_match_ref(eq2, sh_rts)
    wts2 = _first_match_ref(eq2, sh_wts)
    h2 = th2 & protocol.valid(cts2, rts2)
    th2, h2 = th2 & miss, h2 & miss
    need = miss & ~h2

    eqt = ts_tag == addr[:, None]
    tht = eqt.any(-1)
    tway = _first_index(eqt)
    memts = torch.where(tht, _first_match_ref(eqt, ts_mem), 0)
    mwts, mrts, nmem, ovf = _tsu_grant_ref(memts, False, rd)
    fnd = need & tht

    leaseA = protocol.install(cts2, mwts, mrts)
    rwts = torch.where(h2, wts2, leaseA.wts)
    rrts = torch.where(h2, rts2, leaseA.rts)
    lease1 = protocol.install(cts1, rwts, rrts)
    return (th1, h1, way1, th2, h2, way2, fnd, tway, mwts, mrts, nmem,
            fnd & ovf, leaseA.wts, leaseA.rts, lease1.wts, lease1.rts)


def write_grant_ref(ts_tag, ts_mem, ts_seq, addr, wl, row=None,
                    invalid=-1):
    """Write-side TSU math (``kernels.tier_pass.write_grant``): probe,
    lexicographic victim (min-(memts, alloc_seq)) and the ``mm_write``
    grant + overflow reinit.  The tables are ``[K, C]`` and ``row`` names
    each lane's table row; None means lane i reads row i (K == N)."""
    if row is not None:
        ts_tag, ts_mem, ts_seq = ts_tag[row], ts_mem[row], ts_seq[row]
    eq = ts_tag == addr[:, None]
    th = eq.any(-1)
    way = _first_index(eq)
    inval = ts_tag == invalid
    p = torch.where(inval, _NEG, ts_mem)
    pmin = torch.amin(p, -1, keepdim=True)
    s = torch.where(p == pmin, ts_seq, 2 ** 30)
    vic = torch.argmin(s, -1).to(_i32)
    w0 = torch.where(th, way, vic)
    full = (~inval).all(-1)
    memts = torch.where(th, _first_match_ref(eq, ts_mem), 0)
    wts, rts, nmem, ovf = _tsu_grant_ref(memts, True, wl)
    return th, w0, full, wts, rts, nmem, ovf


# ------------------------------------------------------------ float kernels
def rmsnorm_ref(x, w, eps=1e-6):
    """x: [..., D]; w: [D].  ``x * rsqrt(mean(x^2) + eps) * (1 + w)`` in
    f32, cast to x's dtype."""
    xf = x.float()
    y = xf * torch.rsqrt(torch.mean(xf * xf, -1, keepdim=True) + eps)
    return (y * (1.0 + w.float())).to(x.dtype)


def attention_ref(q, k, v, *, causal=True, window=0, kv_len=None):
    """q: [B,Sq,Hq,D]; k: [B,Sk,Hkv,D]; v: [B,Sk,Hkv,Dv] — plain softmax
    attention in f32, scaled by q's ``D ** -0.5`` (MLA's v is narrower
    than q and k: Dv 128 against D 192).  Query head h reads kv head
    ``h // (Hq // Hkv)``; masked scores get ``NEG_INF`` added, as in the
    kernels.  Returns [B,Sq,Hq,Dv] in q's dtype."""
    B, Sq, Hq, D = q.shape
    Sk, Hkv, Dv = k.shape[1], k.shape[2], v.shape[-1]
    qpk = Hq // Hkv
    qr = q.reshape(B, Sq, Hkv, qpk, D).float()
    s = torch.einsum("bqhgd,bkhd->bhgqk", qr, k.float()) * D ** -0.5
    qpos = torch.arange(Sq, device=q.device)[:, None]
    kpos = torch.arange(Sk, device=q.device)[None, :]
    mask = torch.zeros((Sq, Sk), dtype=torch.float32, device=q.device)
    if causal:
        mask = torch.where(kpos > qpos, NEG_INF, mask)
    if window:
        mask = torch.where(qpos - kpos >= window, NEG_INF, mask)
    if kv_len is not None:
        mask = torch.where(kpos >= kv_len, NEG_INF, mask)
    p = torch.softmax(s + mask, dim=-1)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    return o.reshape(B, Sq, Hq, Dv).to(q.dtype)


def rmsnorm_bwd_ref(x, w, dy, eps=1e-6):
    """The plain backward of ``rmsnorm_ref``: autograd of the plain
    forward.  Returns (dx in x's dtype, dw in w's dtype)."""
    with torch.enable_grad():
        xg = x.detach().requires_grad_()
        wg = w.detach().requires_grad_()
        return torch.autograd.grad(rmsnorm_ref(xg, wg, eps), (xg, wg), dy)


def attention_bwd_ref(q, k, v, dout, *, causal=True, window=0):
    """The plain backward of ``attention_ref`` (train/prefill form):
    autograd of the plain forward.  Returns (dq, dk, dv) in the inputs'
    dtypes."""
    with torch.enable_grad():
        qkv = [t.detach().requires_grad_() for t in (q, k, v)]
        out = attention_ref(*qkv, causal=causal, window=window)
        return torch.autograd.grad(out, qkv, dout)


def ssd_chunk_ref(x, dt, A, Bc, Cc, out_dtype=None):
    """The SSD intra-chunk step for a batch of chunks — the batched form of
    the reference's one-chunk ``ssd_chunk_ref`` and the signature of its
    Pallas kernel.

    x: [B,nc,Q,H,P]; dt: [B,nc,Q,H]; A: [H]; Bc/Cc: [B,nc,Q,H,N] (any
    strides, a head stride of 0 included).  Per (b, chunk, h), in f32:
    ``cum = cumsum(dt*A)``, ``y_i = sum_{j<=i} (C_i.B_j) exp(cum_i -
    cum_j) dt_j x_j`` and ``state = sum_j (B_j dt_j exp(cum_last -
    cum_j))^T x_j``.  Pairs with j > i get ``exp(-inf) = 0``, as in the
    reference.  Returns (y [B,nc,Q,H,P] in ``out_dtype``, by default x's
    dtype, as the Pallas kernel; state [B,nc,H,N,P] f32; cum [B,nc,Q,H]
    f32)."""
    Q = x.shape[2]
    xf, dtf, Bf, Cf = x.float(), dt.float(), Bc.float(), Cc.float()
    cum = torch.cumsum(dtf * A.float(), dim=2)                 # [B,nc,Q,H]
    li = cum[:, :, :, None, :] - cum[:, :, None, :, :]         # [B,nc,Qi,Qj,H]
    tril = torch.ones((Q, Q), dtype=torch.bool, device=x.device).tril()
    L = torch.exp(torch.where(tril[None, None, :, :, None], li,
                              -torch.inf))
    cb = torch.einsum("bcihn,bcjhn->bcijh", Cf, Bf)
    scores = cb * L * dtf[:, :, None, :, :]
    y = torch.einsum("bcijh,bcjhp->bcihp", scores, xf)
    decay_out = torch.exp(cum[:, :, -1:, :] - cum)             # [B,nc,Q,H]
    state = torch.einsum("bcjhn,bcjhp->bchnp",
                         Bf * (dtf * decay_out)[..., None], xf)
    return y.to(x.dtype if out_dtype is None else out_dtype), state, cum


def ssd_chunk_bwd_ref(x, dt, A, Bc, Cc, dy, dstate, dcum, out_dtype=None):
    """The plain backward of ``ssd_chunk_ref``: autograd of the plain
    forward, with cotangents on all three outputs (dy in y's dtype or
    f32, dstate and dcum f32; the model's inter-chunk scan reads cum, so
    dcum is not zero there).  Returns (dx, ddt, dA, dBc, dCc) in the
    inputs' dtypes; a stride-0 head of Bc or Cc gets its per-head
    gradient, of the view's shape."""
    with torch.enable_grad():
        ins = [t.detach().requires_grad_() for t in (x, dt, A, Bc, Cc)]
        y, state, cum = ssd_chunk_ref(*ins, out_dtype)
        return torch.autograd.grad((y, state, cum), ins,
                                   (dy.to(y.dtype), dstate, dcum))
