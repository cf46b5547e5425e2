"""Plain PyTorch versions of the kernels: the ground truth the CUDA
kernels are held to, and what the dispatcher runs on CPU tensors.

Each function is the line-for-line counterpart of its namesake in
``repro/kernels/ref.py`` and runs on any device.  The float half
(``rmsnorm_ref``, ``attention_ref``) computes in f32 and casts the result
to the input's dtype, as the Pallas kernels do; in particular the softmax
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


def lease_probe_ref(tag_rows, rts_rows, cts, addr, mwts, mrts):
    """HALCONE probe+install math over gathered set rows.

    tag_rows/rts_rows: [N,W]; cts/addr/mwts/mrts: [N].
    Returns (tag_hit, hit, way, row_rts, new_wts, new_rts, new_cts)."""
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
                   cts1, cts2, addr, act, rd):
    """Read-side round math (``kernels.tier_pass.miss_round``): replica
    probe, shared probe, TSU read grant and both install levels — the 16
    per-lane intermediates of ``pipeline.make_miss_pass``'s round body."""
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


def write_grant_ref(ts_tag, ts_mem, ts_seq, addr, wl, invalid=-1):
    """Write-side TSU math (``kernels.tier_pass.write_grant``): probe,
    lexicographic victim (min-(memts, alloc_seq)) and the ``mm_write``
    grant + overflow reinit."""
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
    """q: [B,Sq,Hq,D]; k,v: [B,Sk,Hkv,D] — plain softmax attention in f32.
    Query head h reads kv head ``h // (Hq // Hkv)``; masked scores get
    ``NEG_INF`` added, as in the kernels."""
    B, Sq, Hq, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
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
    return o.reshape(B, Sq, Hq, D).to(q.dtype)
