"""The arithmetic of the SSD backward kernel, emulated on the CPU.

``src/repro_torch/kernels/csrc/ssd_chunk_bwd.cu`` runs only on the card;
this module repeats its closed-form gradient in plain PyTorch so that
``test_torch_ssd_bwd.py`` can hold it against ``jax.vjp`` of the
reference here.  Per (b, chunk, head), in f32, from the forward's saved
cum (never re-summed), with ``L_ij = exp(cum_i - cum_j)`` for j <= i,
``s_ij = (C_i . B_j) L_ij dt_j`` (the forward's scores), ``G_ij = (dy_i .
x_j) L_ij dt_j``, ``T_ij = (dy_i . x_j)(C_i . B_j) L_ij`` and ``w_j = dt_j
exp(cum_{Q-1} - cum_j)``:

- the key pass, one 64-row tile of keys j against the query tiles i >=
  j: the state terms first (``dx_j = w_j (B_j . dstate)``, ``dB_j = w_j
  (dstate x_j)``, ``dw_j = B_j . (dstate x_j)``), then ``dx_j += sum_i
  s_ij dy_i``, ``dB_j += sum_i G_ij C_i`` and the column sums of T;
- the query pass, one tile of queries i against the key tiles j <= i:
  ``dC_i = sum_j G_ij B_j`` and the row sums of ``S_ij = G_ij (C_i .
  B_j)``;
- the chunk pass: ``dcum_total = dcum + rowsum(S) - dt colsum(T) - dw
  w``, plus ``sum_j dw_j w_j`` at row Q - 1, its reverse cumsum r,
  ``ddt = colsum(T) + dw exp(cum_{Q-1} - cum) + A r`` and a partial
  ``sum_j dt_j r_j`` per (b, chunk, head);
- ``dA_h``: the partials summed over (b, chunk) in the kernel's fixed
  order (a stride of 256 rows per thread, then a halving tree).

A pair with j > i is never given its exponent: ``exp`` sees 0 there and
the pair is selected to 0, as the kernel skips it (``cum_i - cum_j`` can
reach +100 there, whose exp overflows).  Imports neither jax nor
``repro``.
"""
import torch

TILE = 64                     # rows of a key or query tile (csrc kTile)
REDUCE_THREADS = 256          # threads of the dA reduction (csrc kThreads)


def _fixed_order_sum(part):
    """part: [R, H] -> [H], summed as the reduction kernel sums: thread t
    adds rows t, t + 256, ... in order, then a halving tree over the
    threads."""
    R, H = part.shape
    red = torch.zeros(REDUCE_THREADS, H)
    for t in range(min(R, REDUCE_THREADS)):
        acc = torch.zeros(H)
        for r in range(t, R, REDUCE_THREADS):
            acc = acc + part[r]
        red[t] = acc
    stride = REDUCE_THREADS // 2
    while stride:
        red[:stride] = red[:stride] + red[stride:2 * stride]
        stride //= 2
    return red[0]


def emulate_bwd(x, dt, A, Bc, Cc, cum, dy, dstate, dcum):
    """The kernel's gradient.  x: [B, nc, Q, H, P]; dt, cum, dcum: [B, nc,
    Q, H] f32; A: [H] f32; Bc, Cc: [B, nc, Q, H, N] (any strides); dy:
    [B, nc, Q, H, P]; dstate: [B, nc, H, N, P] f32.  Returns (dx, ddt, dA,
    dBc, dCc) in the inputs' dtypes, dBc and dCc per head."""
    Bsz, nc, Q, H, P = x.shape
    per = lambda t: t.float().permute(0, 1, 3, 2, 4)   # [B, nc, H, Q, *]
    xf, bf, cf, yf = per(x), per(Bc), per(Cc), per(dy)
    cq = cum.float().permute(0, 1, 3, 2)               # [B, nc, H, Q]
    dq = dt.float().permute(0, 1, 3, 2)
    ds = dstate.float()
    decay = torch.exp(cq[..., Q - 1:] - cq)
    w = dq * decay

    # the key pass's state terms, then every visible tile pair, visited
    # once: the key pass reads it for dx, dB and colsum(T), the query pass
    # for dC and rowsum(S)
    raw = xf @ ds.transpose(-1, -2)                    # dstate x_j: [Q, N]
    dw = (bf * raw).sum(-1)
    dx = (bf @ ds) * w[..., None]
    dB = raw * w[..., None]
    dC = torch.zeros_like(cf)
    colT = torch.zeros_like(cq)
    rowS = torch.zeros_like(cq)
    for j0 in range(0, Q, TILE):
        js = slice(j0, min(j0 + TILE, Q))
        jj = torch.arange(j0, js.stop)[None, :]
        for i0 in range(j0, Q, TILE):
            is_ = slice(i0, min(i0 + TILE, Q))
            ii = torch.arange(i0, is_.stop)[:, None]
            vis = jj <= ii
            cb = cf[..., is_, :] @ bf[..., js, :].transpose(-1, -2)
            dd = yf[..., is_, :] @ xf[..., js, :].transpose(-1, -2)
            diff = cq[..., is_, None] - cq[..., None, js]
            L = torch.where(vis, torch.exp(torch.where(vis, diff, 0.0)), 0.0)
            e = L * dq[..., None, js]
            s, g = cb * e, dd * e
            dx[..., js, :] += s.transpose(-1, -2) @ yf[..., is_, :]
            dB[..., js, :] += g.transpose(-1, -2) @ cf[..., is_, :]
            colT[..., js] += (dd * cb * L).sum(-2)
            dC[..., is_, :] += g @ bf[..., js, :]
            rowS[..., is_] += (g * cb).sum(-1)

    # the chunk pass
    dct = dcum.float().permute(0, 1, 3, 2) + rowS - dq * colT - dw * w
    dct[..., Q - 1] += (dw * w).sum(-1)
    rev = torch.flip(torch.cumsum(torch.flip(dct, [-1]), -1), [-1])
    ddt = colT + dw * decay + A.float()[:, None] * rev
    dA = _fixed_order_sum((dq * rev).sum(-1).reshape(-1, H))
    back = lambda t, like: t.permute(0, 1, 3, 2, 4).to(like.dtype)
    return (back(dx, x), ddt.permute(0, 1, 3, 2), dA, back(dB, Bc),
            back(dC, Cc))
