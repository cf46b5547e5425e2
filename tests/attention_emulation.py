"""The arithmetic of the tensor-core flash kernel, emulated on the CPU.

``src/repro_torch/kernels/csrc/flash_attention_wgmma.cu`` runs only on the
card; this module repeats its arithmetic in plain PyTorch so that tests can
hold it against the reference on the CPU (``test_torch_attention_split.py``)
and hold the kernel against it on the card (``test_torch_cuda.py``): bf16
inputs, scores exact in f32 (a bf16 x bf16 product is exact there), an
online softmax in base 2 (weights 2^((s - m) c), c = D^-0.5 log2(e)) over
64-row warpgroups and 64-key tiles with the kernel's masks and skips, and P
split into bf16 halves ``P_hi = bf16(P)`` and ``P_lo = bf16(P - P_hi)``
whose two products add into one f32 accumulator.  v may be narrower than
q and k (MLA's (192, 128)): the scores take q's D, the output v's Dv.  A
head dim that is not a multiple of 64 (hubert-xlarge's 80) loads as whole
64-column boxes whose columns past it TMA fills with zeros
(``zero_fill``).  Imports neither jax nor ``repro``.
"""
import torch

NEG_INF = -1e30
ROWS = 64                     # query rows per consumer warpgroup
BK = 64                       # keys per tile (csrc Shape<D>::BK)
BOX = 64                      # columns of a TMA box
LOG2E = 1.4426950408889634


def zero_filled(t):
    """``t`` [..., D] with zero columns up to whole 64-column boxes, as
    TMA loads it."""
    return torch.nn.functional.pad(t, (0, -t.shape[-1] % BOX))


def emulate_kernel(q, k, v, *, causal, window, split=True, zero_fill=False):
    """The kernel's arithmetic in f32: q [B, Sq, Hq, D], k [B, Sk, Hkv, D]
    and v [B, Sk, Hkv, Dv] bf16 -> [B, Sq, Hq, Dv] f32, before the
    output's bf16 rounding.  ``split=False`` rounds P to bf16 once
    instead; ``zero_fill`` computes over the zero-filled boxes and keeps
    the output's first Dv columns."""
    B, Sq, Hq, D = q.shape
    Sk, Hkv, Dv = k.shape[1], k.shape[2], v.shape[3]
    c = (torch.tensor(D ** -0.5, dtype=torch.float32)
         * torch.tensor(LOG2E, dtype=torch.float32))
    if zero_fill:
        q, k, v = (zero_filled(t) for t in (q, k, v))
    qpk = Hq // Hkv
    nt = -(-Sk // BK)
    # TMA zero-fills keys past Sk up to whole tiles
    pad = nt * BK - Sk
    kf = torch.nn.functional.pad(k.float(), (0, 0, 0, 0, 0, pad))
    vf = torch.nn.functional.pad(v.float(), (0, 0, 0, 0, 0, pad))
    kf = kf.repeat_interleave(qpk, 2).transpose(1, 2)   # [B, Hq, S, D]
    vf = vf.repeat_interleave(qpk, 2).transpose(1, 2)
    qf = q.float().transpose(1, 2)
    out = torch.zeros(B, Hq, Sq, v.shape[3])
    for r0 in range(0, Sq, ROWS):
        rows = torch.arange(r0, min(r0 + ROWS, Sq))
        last = int(rows[-1])
        o = torch.zeros(B, Hq, len(rows), v.shape[3])
        m = torch.full((B, Hq, len(rows)), NEG_INF)
        l = torch.zeros(B, Hq, len(rows))
        kv_end = min(Sk, (r0 // 128 + 1) * 128, Sq) if causal else Sk
        for t in range(-(-kv_end // BK)):
            k0 = t * BK
            if causal and k0 > last:                # wholly above the rows
                continue
            cols = torch.arange(k0, k0 + BK)
            s = qf[:, :, rows] @ kf[:, :, cols].transpose(-1, -2)
            add = torch.zeros(len(rows), BK)
            if causal:
                add = torch.where(cols[None] > rows[:, None], NEG_INF, add)
            if window:
                add = torch.where(rows[:, None] - cols[None] >= window,
                                  NEG_INF, add)
            s = torch.where(cols[None] >= Sk, -torch.inf, s + add)
            m_new = torch.maximum(m, s.amax(-1))
            alpha = torch.exp2((m - m_new) * c)
            # the difference first: a score equal to the max weighs 1
            p = torch.exp2((s - m_new[..., None]) * c)
            l = l * alpha + p.sum(-1)
            hi = p.to(torch.bfloat16).float()
            vt = vf[:, :, cols]
            pv = hi @ vt
            if split:
                pv = pv + (p - hi).to(torch.bfloat16).float() @ vt
            o = o * alpha[..., None] + pv
            m = m_new
        out[:, :, rows] = o * (1 / torch.clamp(l, min=1e-30))[..., None]
    return out.transpose(1, 2)[..., :Dv]


def exact_attention(q, k, v, *, causal, window):
    """Softmax attention in f64 with the reference's masks (v of any
    width, the scale q's D^-0.5)."""
    B, Sq, Hq, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    qd = q.double().transpose(1, 2)
    kd = k.double().repeat_interleave(Hq // Hkv, 2).transpose(1, 2)
    vd = v.double().repeat_interleave(Hq // Hkv, 2).transpose(1, 2)
    s = qd @ kd.transpose(-1, -2) * D ** -0.5
    i, j = torch.arange(Sq)[:, None], torch.arange(Sk)[None]
    if causal:
        s = s + torch.where(j > i, NEG_INF, 0.0)
    if window:
        s = s + torch.where(i - j >= window, NEG_INF, 0.0)
    return (torch.softmax(s, -1) @ vd).transpose(1, 2)
