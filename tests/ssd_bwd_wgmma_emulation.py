"""The arithmetic of the tensor-core SSD backward kernel, emulated on the
CPU.

``src/repro_torch/kernels/csrc/ssd_chunk_bwd_wgmma.cu`` runs only on the
card; this module repeats its arithmetic in plain PyTorch so that tests
can hold it against ``jax.vjp`` of the reference on the CPU
(``test_torch_ssd_bwd_split.py``) and hold the kernel against it on the
card (``test_torch_cuda.py``).  Per (b, chunk, head), with x, B and C
bf16 (exact as tensor-core operands), every product of two bf16 tiles
exact in its f32 accumulator, and the f32 operands never rounded once to
bf16 but split into bf16 pieces whose products add into one f32
accumulator:

- dy, dstate and the weights s = (C.B) L dt and G = (dy.x) L dt into two
  pieces, ``hi = bf16(t)`` and ``lo = bf16(t - hi)`` (``split2``), as the
  forward splits its weights: dy x^T and x dstate^T (which feed rowsum(S),
  colsum(T) and dw, and through them ddt and dA, reverse cumsums of terms
  that cancel ~1000x) are two products against the exact x, dC += G B and
  dB += G^T C two against the exact B or C, and dx += s^T dy, both
  operands split, three: hi.hi + lo.hi + hi.lo.

The passes, in the kernel's order:

- the query pass, one 64-row tile of queries i against the key tiles j
  <= i: C B^T and dy x^T, G, the row sums of ``S = G (C.B)``, ``dC +=
  G B``;
- the key pass, one 64-row tile of keys j: the state terms first (``dx =
  w (B dstate)``, ``dB = w (x dstate^T)``, ``dw = B . (x dstate^T)``),
  then against the query tiles i >= j, transposed (B C^T, x dy^T): the
  column sums of ``T = (dy.x)(C.B) L``, ``dx += s^T dy``, ``dB += G^T C``;
- the chunk and dA passes of ``ssd_bwd_emulation`` (the kernel keeps
  ``ssd_chunk_bwd.cu``'s).

L_ij = 2^((cum_i - cum_j) log2 e), as the kernel takes it on ex2, only
where j <= i, i < Q and j < Q: the other pairs are selected to exactly 0
before any exp could overflow.  With
``split=False`` each f32 operand is rounded to bf16 once instead (what
the split is measured against).  Imports neither jax nor ``repro``.
"""
import torch

from ssd_bwd_emulation import _fixed_order_sum

TILE = 64                     # query rows, key rows (csrc kTile)
LOG2E = 1.4426950408889634


def split2(t):
    """t as bf16 hi and lo pieces (in f32) whose sum is t to ~2^-17."""
    hi = t.to(torch.bfloat16).float()
    return [hi, (t - hi).to(torch.bfloat16).float()]


def _one(t):
    return [t.to(torch.bfloat16).float()]


def emulate_bwd(x, dt, A, Bc, Cc, cum, dy, dstate, dcum, *, split=True):
    """The kernel's gradient.  x: [B, nc, Q, H, P], Bc and Cc: [B, nc, Q,
    H, N] bf16 (any strides); dt, cum, dcum: [B, nc, Q, H] f32; A: [H]
    f32; dy: [B, nc, Q, H, P] (f32 or bf16); dstate: [B, nc, H, N, P] f32.
    Returns (dx, ddt, dA, dBc, dCc), all f32: dx, dBc and dCc before the
    kernel rounds them to bf16, dBc and dCc per head.  ``split=False``
    rounds dy, dstate, s and G to bf16 once instead."""
    s2 = split2 if split else _one
    Bsz, nc, Q, H, P = x.shape
    per = lambda t: t.float().permute(0, 1, 3, 2, 4)   # [B, nc, H, Q, *]
    xf, bf, cf = per(x), per(Bc), per(Cc)
    dyp = s2(per(dy))                                  # dy's pieces
    cq = cum.float().permute(0, 1, 3, 2)               # [B, nc, H, Q]
    dq = dt.float().permute(0, 1, 3, 2)
    last = cq[..., Q - 1:]

    def weights(i0, j0):
        """Rows i of the query tile, columns j of the key tile: which pairs
        are visible, L (0 elsewhere) and the tile's index slices."""
        is_ = slice(i0, min(i0 + TILE, Q))
        js = slice(j0, min(j0 + TILE, Q))
        vis = (torch.arange(j0, js.stop)[None, :]
               <= torch.arange(i0, is_.stop)[:, None])
        diff = torch.where(vis, cq[..., is_, None] - cq[..., None, js], 0.0)
        L = torch.where(vis, torch.exp2(diff * LOG2E), 0.0)
        return is_, js, vis, L

    # the query pass
    dC = torch.zeros_like(cf)
    rowS = torch.zeros_like(cq)
    for i0 in range(0, Q, TILE):
        for j0 in range(0, i0 + 1, TILE):
            is_, js, vis, L = weights(i0, j0)
            cb = cf[..., is_, :] @ bf[..., js, :].transpose(-1, -2)
            dd = sum(p[..., is_, :] @ xf[..., js, :].transpose(-1, -2)
                     for p in dyp)
            g = torch.where(vis, dd * (L * dq[..., None, js]), 0.0)
            rowS[..., is_] += (g * cb).sum(-1)
            for half in s2(g):
                dC[..., is_, :] += half @ bf[..., js, :]

    # the key pass
    ds = s2(dstate.float())
    raw = sum(xf @ p.transpose(-1, -2) for p in ds)    # x dstate^T: [Q, N]
    dx = sum(bf @ p for p in ds)                       # B dstate: [Q, P]
    dw = (bf * raw).sum(-1)
    decay = torch.exp(last - cq)
    w = dq * decay
    dx = dx * w[..., None]
    dB = raw * w[..., None]
    colT = torch.zeros_like(cq)
    for j0 in range(0, Q, TILE):
        for i0 in range(j0, Q, TILE):
            is_, js, vis, L = weights(i0, j0)
            vt, Lt = vis.transpose(-1, -2), L.transpose(-1, -2)
            cbt = bf[..., js, :] @ cf[..., is_, :].transpose(-1, -2)
            ddt_ = sum(xf[..., js, :] @ p[..., is_, :].transpose(-1, -2)
                       for p in dyp)
            e = Lt * dq[..., js, None]
            s = torch.where(vt, cbt * e, 0.0)
            g = torch.where(vt, ddt_ * e, 0.0)
            colT[..., js] += torch.where(vt, ddt_ * cbt * Lt, 0.0).sum(-1)
            sp = s2(s)
            if split:                  # hi.hi + lo.hi + hi.lo
                terms = [(sp[0], dyp[0]), (sp[1], dyp[0]), (sp[0], dyp[1])]
            else:
                terms = [(sp[0], dyp[0])]
            for a, b in terms:
                dx[..., js, :] += a @ b[..., is_, :]
            for half in s2(g):
                dB[..., js, :] += half @ cf[..., is_, :]

    # the chunk and dA passes (ssd_chunk_bwd.cu's)
    dct = dcum.float().permute(0, 1, 3, 2) + rowS - dq * colT - dw * w
    dct[..., Q - 1] += (dw * w).sum(-1)
    rev = torch.flip(torch.cumsum(torch.flip(dct, [-1]), -1), [-1])
    ddt = colT + dw * decay + A.float()[:, None] * rev
    dA = _fixed_order_sum((dq * rev).sum(-1).reshape(-1, H))
    back = lambda t: t.permute(0, 1, 3, 2, 4)
    return back(dx), ddt.permute(0, 1, 3, 2), dA, back(dB), back(dC)


def exact_bwd(x, dt, A, Bc, Cc, dy, dstate, dcum):
    """The gradient of ``ssd_chunk_ref``'s function in f64 from the same
    inputs (cum re-summed in f64): (dx, ddt, dA, dBc, dCc)."""
    ins = [t.double().requires_grad_() for t in (x, dt, A, Bc, Cc)]
    xd, dtd, Ad, bd, cd = ins
    Q = x.shape[2]
    cum = torch.cumsum(dtd * Ad, dim=2)
    li = cum[:, :, :, None, :] - cum[:, :, None, :, :]
    tril = torch.ones((Q, Q), dtype=torch.bool).tril()
    L = torch.exp(torch.where(tril[None, None, :, :, None], li, -torch.inf))
    s = torch.einsum("bcihn,bcjhn->bcijh", cd, bd) * L * dtd[:, :, None]
    y = torch.einsum("bcijh,bcjhp->bcihp", s, xd)
    wd = dtd * torch.exp(cum[:, :, -1:] - cum)
    state = torch.einsum("bcjhn,bcjhp->bchnp", bd * wd[..., None], xd)
    return torch.autograd.grad((y, state, cum), ins,
                               [t.double() for t in (dy, dstate, dcum)])
