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
the epilogue.  Imports neither jax nor ``repro``.
"""
import torch

from attention_emulation import LOG2E, NEG_INF

TILE = 64                     # query rows and keys of every tile


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


def row_stats(q, k, *, causal, window):
    """The forward kernel's row statistics for bf16 q [B, Sq, Hq, D] and
    k [B, Sk, Hkv, D]: m, the max of each row's unscaled masked f32
    products, and 1 / max(l, 1e-30) with l = sum 2^((s - m) c); each
    [B, Hq, Sq].  Tiles the forward skips hold only masked pairs of rows
    that see a key, so the max and the sum over all keys are the
    kernel's, up to the order of the sum."""
    B, Sq, Hq, D = q.shape
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
                split=True):
    """The kernel's arithmetic in f32: q, out, dout [B, Sq, Hq, D] and k, v
    [B, Sk, Hkv, D] bf16 -> (dq, dk, dv) f32, before the outputs' bf16
    rounding.  ``stats``: (m, 1 / l), each [B, Hq, Sq], as the forward
    kernel wrote them; None computes them with ``row_stats``.
    ``split=False`` rounds P and dS to bf16 once instead."""
    B, Sq, Hq, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    qpk = Hq // Hkv
    scale, c = _scale(D)
    m, il = row_stats(q, k, causal=causal, window=window) \
        if stats is None else (t.float() for t in stats)
    qf, dof = q.float().transpose(1, 2), dout.float().transpose(1, 2)
    kf, vf = _heads(k, qpk), _heads(v, qpk)
    di = (dout.float() * out.float()).sum(-1).transpose(1, 2)   # [B, Hq, Sq]

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
    dq = torch.zeros(B, Hq, Sq, D)
    allh = torch.arange(Hq)
    for qt in range(nq):
        rows = torch.arange(qt * TILE, min(qt * TILE + TILE, Sq))
        kv_end = min(Sk, qt * TILE + TILE, Sq) if causal else Sk
        acc = torch.zeros(B, Hq, len(rows), D)
        for t in range(-(-kv_end // TILE)):
            cols = torch.arange(t * TILE, min(t * TILE + TILE, Sk))
            _, ds = tile(rows, cols, allh)
            for part in _split(ds, split):
                acc = acc + part @ kf[:, :, cols]
        dq[:, :, rows] = acc * scale
    dk = torch.zeros(B, Hkv, Sk, D)
    dv = torch.zeros(B, Hkv, Sk, D)
    for kt in range(nk):
        cols = torch.arange(kt * TILE, min(kt * TILE + TILE, Sk))
        ak = torch.zeros(B, Hkv, len(cols), D)
        av = torch.zeros(B, Hkv, len(cols), D)
        for g in range(qpk):                     # the group's query heads
            h = torch.arange(Hkv) * qpk + g
            for qt in range(kt if causal else 0, nq):
                rows = torch.arange(qt * TILE, min(qt * TILE + TILE, Sq))
                p, ds = tile(rows, cols, h)
                for part in _split(p, split):
                    av = av + part.transpose(-1, -2) @ dof[:, h][:, :, rows]
                for part in _split(ds, split):
                    ak = ak + part.transpose(-1, -2) @ qf[:, h][:, :, rows]
        dk[:, :, cols] = ak * scale
        dv[:, :, cols] = av
    return dq.transpose(1, 2), dk.transpose(1, 2), dv.transpose(1, 2)


def exact_attention_bwd(q, k, v, dout, *, causal, window):
    """(dq, dk, dv) of softmax attention in f64 with the reference's
    masks, by autograd."""
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
