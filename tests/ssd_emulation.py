"""The arithmetic of the tensor-core SSD kernel, emulated on the CPU.

``src/repro_torch/kernels/csrc/ssd_chunk_wgmma.cu`` runs only on the card;
this module repeats its arithmetic in plain PyTorch so that tests can hold
it against the reference on the CPU (``test_torch_ssd_split.py``) and hold
the kernel against it on the card (``test_torch_cuda.py``): bf16 inputs,
cum as torch's cumsum of dt * A, scores C B^T exact in f32 (a bf16 x bf16
product is exact there), 64-row warpgroups and 64-key tiles with the
kernel's skips and masks, weights W = S 2^((cum_i - cum_j) log2 e) dt_j
split into bf16 halves ``W_hi = bf16(W)`` and ``W_lo = bf16(W - W_hi)``
whose two products with x add into one f32 accumulator, and the state as
B^T (w x) with w x split the same way.  Imports neither jax nor ``repro``.
"""
import torch

ROWS = 64                     # query rows per consumer warpgroup
BK = 64                       # keys per tile (csrc BK)
LOG2E = 1.4426950408889634


def _split(t, split):
    """t as bf16 hi (+ lo) halves, summed back in f32 by the caller's
    products: [hi, lo] with ``split``, else [hi]."""
    hi = t.to(torch.bfloat16).float()
    return [hi, (t - hi).to(torch.bfloat16).float()] if split else [hi]


def emulate_kernel(x, dt, A, Bc, Cc, *, split=True):
    """The kernel's arithmetic in f32.  x: [B, nc, Q, H, P], Bc and Cc:
    [B, nc, Q, H, N] bf16; dt: [B, nc, Q, H] f32; A: [H] f32.  Returns
    (y [B, nc, Q, H, P] f32, before any rounding to an output type; state
    [B, nc, H, N, P] f32; cum [B, nc, Q, H] f32).  ``split=False`` rounds
    W and w x to bf16 once instead."""
    Bsz, nc, Q, H, P = x.shape
    nt = -(-Q // BK)
    pad = nt * BK - Q
    # [B, nc, H, Q, *], zero-filled past Q to whole tiles as TMA does
    tr = lambda t: torch.nn.functional.pad(
        t.float().permute(0, 1, 3, 2, 4), (0, 0, 0, pad))
    xf, bf, cf = tr(x), tr(Bc), tr(Cc)
    cum = torch.cumsum(dt * A, dim=2)
    cq = torch.nn.functional.pad(cum.permute(0, 1, 3, 2), (0, pad))
    dq = torch.nn.functional.pad(dt.permute(0, 1, 3, 2), (0, pad))
    y = torch.zeros(Bsz, nc, H, Q, P)
    for r0 in range(0, Q, ROWS):
        rows = torch.arange(r0, min(r0 + ROWS, Q))
        last = int(rows[-1])
        o = torch.zeros(Bsz, nc, H, len(rows), P)
        for t in range(nt):
            k0 = t * BK
            if k0 > last:                       # wholly above the rows
                continue
            cols = torch.arange(k0, k0 + BK)
            s = cf[:, :, :, rows] @ bf[:, :, :, cols].transpose(-1, -2)
            e = torch.exp2((cq[..., rows, None] - cq[..., None, cols])
                           * LOG2E)
            w = s * e * dq[..., None, cols]
            w = torch.where(cols[None] <= rows[:, None], w, 0.0)
            for half in _split(w, split):
                o = o + half @ xf[:, :, :, cols]
        y[:, :, :, rows] = o
    last = cq[..., Q - 1:Q]
    wq = torch.where(torch.arange(nt * BK) < Q,
                     dq * torch.exp(last - cq), 0.0)
    state = torch.zeros(Bsz, nc, H, Bc.shape[-1], P)
    for t in range(nt):
        cols = torch.arange(t * BK, (t + 1) * BK)
        wx = wq[..., cols, None] * xf[:, :, :, cols]
        for half in _split(wx, split):
            state = state + bf[:, :, :, cols].transpose(-1, -2) @ half
    return y.permute(0, 1, 3, 2, 4), state, cum


def exact_ssd(x, dt, A, Bc, Cc):
    """The function in f64 from the same inputs and the same f32 cum (the
    reference's): (y, state)."""
    xd, bd, cd = (t.double().permute(0, 1, 3, 2, 4) for t in (x, Bc, Cc))
    cum = torch.cumsum(dt * A, dim=2).double().permute(0, 1, 3, 2)
    d = dt.double().permute(0, 1, 3, 2)
    Q = x.shape[2]
    tril = torch.ones(Q, Q, dtype=torch.bool).tril()
    L = torch.exp(torch.where(tril, cum[..., :, None] - cum[..., None, :],
                              -torch.inf))
    y = ((cd @ bd.transpose(-1, -2)) * L * d[..., None, :]) @ xd
    w = d * torch.exp(cum[..., -1:] - cum)
    state = bd.transpose(-1, -2) @ (w[..., None] * xd)
    return y.permute(0, 1, 3, 2, 4), state
