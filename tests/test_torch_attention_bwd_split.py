"""The arithmetic of the tensor-core flash backward, emulated on the CPU.

``csrc/flash_attention_bwd_wgmma.cu`` runs only on the card, so
``attention_bwd_emulation.py`` repeats its arithmetic in plain PyTorch
(bf16 inputs, scores and dP exact in f32, P recomputed in base 2 from the
forward's m and 1 / l, Di = dO . O from the forward's bf16 output, 64-row
and 64-key tiles with the kernel's masks and skips, and P and dS split
into bf16 halves whose two products add into one f32 accumulator), and
this file holds it against the reference.  Inputs come from numpy with a
seed.  Tolerances, with their reasons:

- against ``jax.vjp`` of the reference's ``attention_ref``, rtol = atol =
  2e-2: both sides compute in f32 from the same bf16 inputs and round the
  result once (one bf16 step is 2^-8 relative);
- the split against one bf16 rounding of P and dS, both before the
  outputs' rounding and against an f64 gradient: the split keeps ~16 bits
  of each weight where one rounding keeps 8.  Measured on these cases,
  the mean error of dV (P alone) falls 650-710x; dQ and dK also carry Di
  from the forward's bf16 output, which no split removes, and fall
  2.0-7.1x.  With Di from an f32 output all three fall 650-710x.  So dV
  must beat one rounding by 100x and dQ, dK by 1.5x.

At D = 80 the kernel's tiles are whole 64-column boxes, zero-filled past
80, and at D = 256 two blocks share each tile, each with half of the
output columns (and all of S and dP); the emulation takes that layout
(``layout=True``) for those cases, and it must change no bit of the
outputs.

The kernel itself is held to this emulation on the card in
``tests/test_torch_cuda.py`` (``test_cuda_flash_bwd_wgmma_keeps_split``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from attention_bwd_emulation import (column_parts, emulate_bwd,
                                     exact_attention_bwd, row_stats)
from repro.kernels import ref as jref
from repro_torch.kernels import ref

CASES = [
    (1, 512, 512, 15, 5, 64, True, 0),        # smollm-360m's training step
    (1, 100, 100, 15, 5, 64, True, 0),        # ragged tail
    (1, 130, 130, 4, 1, 128, True, 32),       # MQA, windowed, D = 128
    (1, 50, 130, 4, 2, 64, False, 0),         # rectangular
    (1, 130, 50, 4, 2, 64, True, 0),          # more queries than keys
    (1, 130, 50, 4, 2, 64, True, 16),         # rows with no visible key
    (1, 200, 200, 4, 2, 64, False, 32),
    (1, 128, 128, 4, 4, 80, False, 0),        # hubert-xlarge: zero fill
    (1, 130, 130, 4, 2, 80, True, 32),
    (1, 160, 160, 4, 2, 256, True, 64),       # gemma3-4b: column halves
    (1, 100, 70, 2, 1, 256, False, 0),
]


def _inputs(B, Sq, Sk, Hq, Hkv, D):
    rng = np.random.default_rng(Sq + Sk + D)
    return [torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(
        torch.bfloat16) for s in ((B, Sq, Hq, D), (B, Sk, Hkv, D),
                                  (B, Sk, Hkv, D), (B, Sq, Hq, D))]


@pytest.mark.parametrize("B,Sq,Sk,Hq,Hkv,D,causal,window", CASES)
def test_bwd_split_emulation_matches_jax_and_beats_one_rounding(
        B, Sq, Sk, Hq, Hkv, D, causal, window):
    q, k, v, dout = _inputs(B, Sq, Sk, Hq, Hkv, D)
    out = ref.attention_ref(q, k, v, causal=causal, window=window)
    got = emulate_bwd(q, k, v, out, dout, causal=causal, window=window,
                      layout=D in (80, 256))
    jq, jk, jv, jdo = (jnp.asarray(t.float().numpy(), jnp.bfloat16)
                       for t in (q, k, v, dout))
    _, vjp = jax.vjp(lambda a, b, c: jref.attention_ref(
        a, b, c, causal=causal, window=window), jq, jk, jv)
    for g, w in zip(got, vjp(jdo)):
        assert torch.isfinite(g).all()
        np.testing.assert_allclose(
            g.to(torch.bfloat16).float().numpy(), np.asarray(w, np.float32),
            rtol=2e-2, atol=2e-2)

    exact = exact_attention_bwd(q, k, v, dout, causal=causal, window=window)
    one = emulate_bwd(q, k, v, out, dout, causal=causal, window=window,
                      split=False)
    for name, s, o, e, margin in zip("qkv", got, one, exact,
                                     (1.5, 1.5, 100.0)):
        err_split = float((s.double() - e).abs().mean())
        err_one = float((o.double() - e).abs().mean())
        assert err_split * margin < err_one, (name, err_split, err_one)


@pytest.mark.parametrize("B,Sq,Sk,Hq,Hkv,D,causal,window", [
    (1, 128, 128, 4, 4, 80, False, 0),
    (1, 130, 70, 4, 2, 80, True, 16),
    (1, 160, 160, 4, 2, 256, True, 64),
    (1, 100, 70, 2, 1, 256, False, 0),
])
def test_bwd_layout_changes_no_bit(B, Sq, Sk, Hq, Hkv, D, causal, window):
    """The kernel's layout at D = 80 (columns 80-127 of each tile zeros,
    so S and dP gain exact zero products and the outputs' extra columns
    are dropped) and at D = 256 (two column halves, each from the same S
    and dP): dq, dk and dv equal the plain tiling's bit for bit, split or
    rounded once."""
    assert column_parts(D) == (2 if D == 256 else 1)
    q, k, v, dout = _inputs(B, Sq, Sk, Hq, Hkv, D)
    out = ref.attention_ref(q, k, v, causal=causal, window=window)
    for split in (True, False):
        kw = dict(causal=causal, window=window, split=split)
        laid = emulate_bwd(q, k, v, out, dout, layout=True, **kw)
        for a, b in zip(laid, emulate_bwd(q, k, v, out, dout, **kw)):
            assert a.shape == b.shape and torch.equal(a, b)


def test_row_stats_weigh_a_fully_masked_row_evenly():
    """A row whose every key is masked has m = -1e30 (each masked product
    rounds to it) and l = its number of keys, as in the forward kernel;
    a row past the causal limit of no key, none."""
    q, k, _, _ = _inputs(1, 130, 50, 4, 2, 64)
    m, il = row_stats(q, k, causal=True, window=16)
    assert torch.all(m[..., 65:] == -1e30)
    torch.testing.assert_close(il[..., 65:], torch.full_like(il[..., 65:],
                                                             1 / 50))
    assert torch.all(m[..., :65] > -1e30)
