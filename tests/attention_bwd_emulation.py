"""The arithmetic of the tensor-core flash backward, emulated on the CPU.

``src/repro_torch/kernels/csrc/flash_attention_bwd_wgmma.cu`` runs only on
the card; this module repeats its arithmetic in plain PyTorch so that tests
can hold it against the reference on the CPU
(``test_torch_attention_bwd_split.py``) and hold the kernel against it on
the card (``test_torch_cuda.py``): bf16 inputs, scores and dP exact in f32
(a bf16 x bf16 product is exact there), P = 2^((s - m) c) / l recomputed
from the forward's row statistics in base 2 (m, the max of the unscaled
masked products, and 1 / max(l, 1e-30); c = D^-0.5 log2(e)), Di = dO . O
from the forward's output, 64-row and 64-key tiles with the kernel's masks
and skips (dQ walks key tiles to the causal limit, dK/dV walks the group's
query heads and query tiles from the causal start), and P and dS split
into bf16 halves ``hi = bf16(x)`` and ``lo = bf16(x - hi)`` whose two
products add into one f32 accumulator.  dK and dQ are scaled by D^-0.5 in
the epilogue.  v, the output and dO may be narrower than q and k (MLA's
(D, Dv) = (192, 128)): dP and Di run over v's columns.  The kernel's
layout (``layout=True``): a head dim that is not a multiple of 64 (80)
loads as whole 64-column boxes, zero-filled past it, and at D = 256 two
blocks share each tile, each computing all of S and dP and its half of
the output columns.  Imports neither jax nor ``repro``.
"""
import torch

from attention_emulation import LOG2E, NEG_INF, zero_filled

TILE = 64                     # query rows and keys of every tile


def column_parts(D, Dv=None):
    """The blocks that share a tile at head dim D (v's Dv; None: the
    same), each with its part of the output columns: two past 128
    columns with v as wide (D = 256), else one (MLA's (192, 128) splits
    dK from dV instead, which changes no sum)."""
    return 2 if Dv in (None, D) and -(-D // 64) * 64 > 128 else 1


def _heads(t, qpk):
    """[B, S, H, D] -> [B, H * qpk, S, D] f32, kv head h repeated for its
    query heads."""
    return t.float().repeat_interleave(qpk, 2).transpose(1, 2)


def _masked(s, rows, cols, Sk, causal, window):
    """The kernel's masked scores: NEG_INF added for a causal or windowed
    pair, -inf for a key at or past Sk (TMA's zero-filled rows)."""
    add = torch.zeros(len(rows), len(cols))
    if causal:
        add = add + torch.where(cols[None] > rows[:, None], NEG_INF, 0.0)
    if window:
        add = add + torch.where(rows[:, None] - cols[None] >= window,
                                NEG_INF, 0.0)
    return torch.where(cols[None] >= Sk, -torch.inf, s + add)


def _scale(D):
    """(D^-0.5, D^-0.5 log2(e)) as the kernel forms them in f32."""
    scale = torch.tensor(D ** -0.5, dtype=torch.float32)
    return scale, scale * torch.tensor(LOG2E, dtype=torch.float32)


def row_stats(q, k, *, causal, window, D=None):
    """The forward kernel's row statistics for bf16 q [B, Sq, Hq, D] and
    k [B, Sk, Hkv, D]: m, the max of each row's unscaled masked f32
    products, and 1 / max(l, 1e-30) with l = sum 2^((s - m) c); each
    [B, Hq, Sq].  Tiles the forward skips hold only masked pairs of rows
    that see a key, so the max and the sum over all keys are the
    kernel's, up to the order of the sum.  ``D``: the head dim that
    scales the scores when q and k come zero-filled (default q's)."""
    B, Sq, Hq, _ = q.shape
    D = D or q.shape[3]
    Sk = k.shape[1]
    _, c = _scale(D)
    s = q.float().transpose(1, 2) @ _heads(k, Hq // k.shape[2]).transpose(
        -1, -2)
    s = _masked(s, torch.arange(Sq), torch.arange(Sk), Sk, causal, window)
    m = s.amax(-1)
    l = torch.exp2((s - m[..., None]) * c).sum(-1)
    return m, 1 / torch.clamp(l, min=1e-30)


def _split(x, split):
    hi = x.to(torch.bfloat16).float()
    return (hi, (x - hi).to(torch.bfloat16).float()) if split else (hi,)


def emulate_bwd(q, k, v, out, dout, stats=None, *, causal, window,
                split=True, layout=False):
    """The kernel's arithmetic in f32: q [B, Sq, Hq, D], k [B, Sk, Hkv,
    D], v [B, Sk, Hkv, Dv] and out, dout [B, Sq, Hq, Dv] bf16 -> (dq, dk,
    dv) f32, before the outputs' bf16 rounding.  ``stats``: (m, 1 / l),
    each [B, Hq, Sq], as the forward kernel wrote them; None computes
    them with ``row_stats``.
    ``split=False`` rounds P and dS to bf16 once instead; ``layout``
    takes the kernel's zero-filled boxes and column parts (Di = dO . O
    from the rows themselves, as the kernel reads them from memory)."""
    B, Sq, Hq, D = q.shape
    Sk, Hkv, Dv = k.shape[1], k.shape[2], v.shape[3]
    qpk = Hq // Hkv
    scale, c = _scale(D)
    di = (dout.float() * out.float()).sum(-1).transpose(1, 2)   # [B, Hq, Sq]
    parts = column_parts(D, Dv) if layout else 1
    if layout:
        q, k, v, dout = (zero_filled(t) for t in (q, k, v, dout))
    m, il = row_stats(q, k, causal=causal, window=window, D=D) \
        if stats is None else (t.float() for t in stats)
    qf, dof = q.float().transpose(1, 2), dout.float().transpose(1, 2)
    kf, vf = _heads(k, qpk), _heads(v, qpk)
    DT, DVT = q.shape[3], v.shape[3]

    def product(a, t):
        """a @ t, t's columns in the blocks' parts."""
        w = t.shape[-1] // parts
        return torch.cat([a @ t[..., i * w:(i + 1) * w]
                          for i in range(parts)], -1)

    def tile(rows, cols, h):
        """P and dS of a (query tile, key tile) pair, heads ``h``."""
        s = qf[:, h][..., rows, :] @ kf[:, h][..., cols, :].transpose(-1, -2)
        s = _masked(s, rows, cols, Sk, causal, window)
        p = torch.exp2((s - m[:, h][..., rows, None]) * c) \
            * il[:, h][..., rows, None]
        dp = dof[:, h][..., rows, :] @ vf[:, h][..., cols, :].transpose(
            -1, -2)
        return p, p * (dp - di[:, h][..., rows, None])

    nq, nk = -(-Sq // TILE), -(-Sk // TILE)
    dq = torch.zeros(B, Hq, Sq, DT)
    allh = torch.arange(Hq)
    for qt in range(nq):
        rows = torch.arange(qt * TILE, min(qt * TILE + TILE, Sq))
        kv_end = min(Sk, qt * TILE + TILE, Sq) if causal else Sk
        acc = torch.zeros(B, Hq, len(rows), DT)
        for t in range(-(-kv_end // TILE)):
            cols = torch.arange(t * TILE, min(t * TILE + TILE, Sk))
            _, ds = tile(rows, cols, allh)
            for part in _split(ds, split):
                acc = acc + product(part, kf[:, :, cols])
        dq[:, :, rows] = acc * scale
    dk = torch.zeros(B, Hkv, Sk, DT)
    dv = torch.zeros(B, Hkv, Sk, DVT)
    for kt in range(nk):
        cols = torch.arange(kt * TILE, min(kt * TILE + TILE, Sk))
        ak = torch.zeros(B, Hkv, len(cols), DT)
        av = torch.zeros(B, Hkv, len(cols), DVT)
        for g in range(qpk):                     # the group's query heads
            h = torch.arange(Hkv) * qpk + g
            for qt in range(kt if causal else 0, nq):
                rows = torch.arange(qt * TILE, min(qt * TILE + TILE, Sq))
                p, ds = tile(rows, cols, h)
                for part in _split(p, split):
                    av = av + product(part.transpose(-1, -2),
                                      dof[:, h][:, :, rows])
                for part in _split(ds, split):
                    ak = ak + product(part.transpose(-1, -2),
                                      qf[:, h][:, :, rows])
        dk[:, :, cols] = ak * scale
        dv[:, :, cols] = av
    return tuple(t.transpose(1, 2)[..., :w]
                 for t, w in ((dq, D), (dk, D), (dv, Dv)))


def exact_attention_bwd(q, k, v, dout, *, causal, window):
    """(dq, dk, dv) of softmax attention in f64 with the reference's
    masks, by autograd (v and dout may be narrower than q and k)."""
    B, Sq, Hq, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    qd, kd, vd = (t.double().requires_grad_() for t in (q, k, v))
    s = qd.transpose(1, 2) @ kd.repeat_interleave(Hq // Hkv, 2).permute(
        0, 2, 3, 1) * D ** -0.5
    i, j = torch.arange(Sq)[:, None], torch.arange(Sk)[None]
    if causal:
        s = s + torch.where(j > i, NEG_INF, 0.0)
    if window:
        s = s + torch.where(i - j >= window, NEG_INF, 0.0)
    o = torch.softmax(s, -1) @ vd.repeat_interleave(Hq // Hkv, 2).transpose(
        1, 2)
    return torch.autograd.grad(o.transpose(1, 2), (qd, kd, vd),
                               dout.double())
