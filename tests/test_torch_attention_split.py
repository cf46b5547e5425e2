"""The arithmetic of the tensor-core flash kernel, emulated on the CPU.

``csrc/flash_attention_wgmma.cu`` runs only on the card, so
``attention_emulation.py`` repeats its arithmetic in plain PyTorch (bf16
inputs, scores exact in f32, an online softmax in base 2 with weights
2^((s - m) c), c = D^-0.5 log2(e), over 64-row warpgroups and 64-key tiles
with the kernel's masks and skips, and P split into bf16 halves
``P_hi = bf16(P)`` and ``P_lo = bf16(P - P_hi)`` whose two products add
into one f32 accumulator), and this file holds it against the reference.
Inputs come from numpy with a seed; the reference's Pallas kernel runs in
interpret mode.  Tolerances, with their reasons:

- against the Pallas kernel, rtol = atol = 2e-2: both sides compute in f32
  and round the result to bf16 once (one bf16 step is 2^-8 relative);
- the split against one bf16 rounding of P, both before the output's
  rounding and against an f64 softmax: the split keeps ~16 bits of each
  weight where one rounding keeps 8, so its error must be at least 16x
  smaller (about 2^8 expected).

At MLA's (D, Dv) = (192, 128) the Pallas kernel has no counterpart (its
BlockSpecs take one D), so the emulation is held there against the
reference's jnp ``layers.attention``, which takes a narrower v and rounds
P to bf16 before the PV product (2e-2 covers both roundings).

At D = 80 (hubert-xlarge) the kernel loads each 160-byte row as two
64-column boxes whose columns past 80 TMA fills with zeros; the emulation
computes over those boxes (``zero_fill``), which must change no bit of
its output.

The route function and the TMA stride rules of the wrapper are plain
Python and are checked here too; the kernels themselves are held to the
plain version on the card in ``tests/test_torch_cuda.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from attention_emulation import emulate_kernel, exact_attention, zero_filled
from repro.kernels.flash_attention import flash_attention as pallas_flash
from repro.models import layers as rlayers
from repro_torch.kernels.flash_attention import (HEAD_DIMS, PAIRS, route,
                                                 tma_strides)


def _block(n):
    """The Pallas kernel's tile along a sequence of n: it takes tiles that
    divide the sequence, 128 at most."""
    return max(b for b in range(1, min(n, 128) + 1) if n % b == 0)


@pytest.mark.parametrize("B,Sq,Sk,Hq,Hkv,D,causal,window", [
    (2, 256, 256, 4, 2, 64, True, 0),         # GQA, causal, two q blocks
    (1, 128, 128, 3, 1, 128, True, 32),       # MQA, windowed, D = 128
    (2, 128, 128, 2, 2, 64, False, 0),        # no mask
    (1, 100, 100, 4, 2, 64, True, 0),         # keys past Sk in the tile
    # windowed at D = 64: rows whose first key tile lies wholly outside
    # the window see a tile of equal masked scores
    (1, 200, 200, 4, 2, 64, True, 32),
    (1, 200, 200, 4, 2, 64, False, 32),
    (1, 50, 130, 4, 2, 64, False, 0),         # rectangular
    (1, 130, 50, 4, 2, 64, True, 0),          # more queries than keys
    # D = 256 (gemma3-4b; two blocks a row tile, each with half of O's
    # columns and all of S): windowed and global, GQA 2
    (1, 256, 256, 4, 2, 256, True, 64),
    (1, 200, 200, 4, 2, 256, True, 0),
    (1, 100, 150, 2, 1, 256, False, 0),
    # D = 80 (hubert-xlarge: non-causal, as many kv heads as query heads),
    # over the zero-filled boxes; then causal, windowed and ragged
    (2, 128, 128, 4, 4, 80, False, 0),
    (1, 130, 130, 4, 2, 80, True, 32),
    (1, 77, 100, 2, 1, 80, False, 0),
])
def test_split_emulation_matches_pallas_and_beats_one_rounding(
        B, Sq, Sk, Hq, Hkv, D, causal, window):
    rng = np.random.default_rng(Sq + Hq + D)
    arrs = [rng.standard_normal(shp).astype(np.float32)
            for shp in ((B, Sq, Hq, D), (B, Sk, Hkv, D), (B, Sk, Hkv, D))]
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16) for a in arrs)
    got = emulate_kernel(q, k, v, causal=causal, window=window,
                         zero_fill=D % 64 != 0)
    assert torch.isfinite(got).all()
    want = pallas_flash(*(jnp.asarray(t.float().numpy(), jnp.bfloat16)
                          for t in (q, k, v)),
                        causal=causal, window=window, bq=_block(Sq),
                        bk=_block(Sk), interpret=True)
    np.testing.assert_allclose(
        got.to(torch.bfloat16).float().numpy(),
        np.asarray(want, np.float32), rtol=2e-2, atol=2e-2)

    exact = exact_attention(q, k, v, causal=causal, window=window)
    one = emulate_kernel(q, k, v, causal=causal, window=window, split=False)
    err_split = float((got.double() - exact).abs().max())
    err_one = float((one.double() - exact).abs().max())
    assert err_split * 16 < err_one, (err_split, err_one)


@pytest.mark.parametrize("B,Sq,Sk,Hq,Hkv,causal,window", [
    (2, 128, 128, 4, 4, False, 0),            # hubert-xlarge's encoder
    (1, 130, 130, 4, 2, True, 32),
    (1, 77, 100, 2, 1, False, 16),
])
def test_zero_fill_changes_no_bit_at_d80(B, Sq, Sk, Hq, Hkv, causal, window):
    """D = 80 over two 64-column boxes, columns 80-127 zeros (TMA's fill
    past the tensor's inner size): the scores gain exact zero products
    and O's extra columns are dropped, so the output equals the
    unpadded arithmetic bit for bit, split or rounded once."""
    rng = np.random.default_rng(Sq + Sk + 80)
    q, k, v = (torch.from_numpy(rng.standard_normal(shp).astype(
        np.float32)).to(torch.bfloat16) for shp in (
        (B, Sq, Hq, 80), (B, Sk, Hkv, 80), (B, Sk, Hkv, 80)))
    assert zero_filled(q).shape[-1] == 128
    assert torch.equal(zero_filled(q)[..., 80:], torch.zeros(B, Sq, Hq, 48,
                                                             dtype=q.dtype))
    for split in (True, False):
        kw = dict(causal=causal, window=window, split=split)
        filled = emulate_kernel(q, k, v, zero_fill=True, **kw)
        assert filled.shape == (B, Sq, Hq, 80)
        assert torch.equal(filled, emulate_kernel(q, k, v, **kw))


@pytest.mark.parametrize("B,Sq,Sk,Hq,Hkv,causal,window", [
    (1, 256, 256, 4, 4, True, 0),             # deepseek-v2's prefill
    (2, 128, 128, 4, 2, False, 0),            # GQA, no mask
    (1, 200, 200, 2, 1, True, 64),            # windowed, a ragged tile
    (1, 100, 150, 2, 2, False, 0),            # rectangular
])
def test_split_emulation_with_narrow_v_matches_jnp_and_beats_one_rounding(
        B, Sq, Sk, Hq, Hkv, causal, window):
    """The tensor-core kernel's arithmetic at (D, Dv) = (192, 128): 12
    k-steps of S, O and P.V at Dv, against the reference's jnp attention,
    and the split P at least 16x closer to an f64 softmax than one bf16
    rounding."""
    D, Dv = 192, 128
    rng = np.random.default_rng(Sq + Hq + Dv)
    arrs = [rng.standard_normal(shp).astype(np.float32)
            for shp in ((B, Sq, Hq, D), (B, Sk, Hkv, D), (B, Sk, Hkv, Dv))]
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16) for a in arrs)
    got = emulate_kernel(q, k, v, causal=causal, window=window)
    assert got.shape == (B, Sq, Hq, Dv) and torch.isfinite(got).all()
    want = rlayers.attention(*(jnp.asarray(t.float().numpy(), jnp.bfloat16)
                               for t in (q, k, v)),
                             causal=causal, window=window, chunk=Sq)
    np.testing.assert_allclose(
        got.to(torch.bfloat16).float().numpy(),
        np.asarray(want, np.float32), rtol=2e-2, atol=2e-2)
    exact = exact_attention(q, k, v, causal=causal, window=window)
    one = emulate_kernel(q, k, v, causal=causal, window=window, split=False)
    err_split = float((got.double() - exact).abs().max())
    err_one = float((one.double() - exact).abs().max())
    assert err_split * 16 < err_one, (err_split, err_one)


@pytest.mark.parametrize("D,Dv,want", [
    (192, 128, "wgmma"), (128, 192, None), (192, 192, None),
    (64, 128, None), (128, 64, None)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_route_by_pair(D, Dv, want, dtype):
    """q/k and v widths: the pairs ``PAIRS`` lists are built, MLA's
    (192, 128) on the tensor cores in bf16 and the CUDA cores in f32;
    any other unequal pair raises."""
    if want is None:
        assert (D, Dv) not in PAIRS
        with pytest.raises(ValueError, match="no kernel"):
            route(dtype, D, Dv)
        return
    assert route(dtype, D, Dv) == (want if dtype == torch.bfloat16
                                   else "simt")
    assert route(dtype, 128) == route(dtype, 128, 128)


def test_mla_k_meets_the_tma_rules():
    """MLA's k as the model builds it (k_nope and the rope columns
    broadcast over the heads, concatenated): contiguous, a 384-byte head
    stride; v a 256-byte one."""
    B, T, H = 2, 8, 4
    k_nope = torch.zeros(B, T, H, 128, dtype=torch.bfloat16)
    kr = torch.zeros(B, T, 64, dtype=torch.bfloat16)
    k = torch.cat([k_nope, kr[..., None, :].expand(B, T, H, 64)], dim=-1)
    assert tma_strides("k", k) == [T * H * 192, H * 192, 192]
    v = torch.zeros(B, T * H * 128, dtype=torch.bfloat16).view(B, T, H, 128)
    assert tma_strides("v", v) == [T * H * 128, H * 128, 128]


@pytest.mark.parametrize("D", [8, 16, 32, 64, 80, 128, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_flash_route_by_dtype_and_head_dim(dtype, D):
    if dtype == torch.float16 or D not in HEAD_DIMS:
        with pytest.raises(ValueError, match="no kernel"):
            route(dtype, D)
        return
    want = "wgmma" if dtype == torch.bfloat16 and D in (64, 80, 128, 256) \
        else "simt"
    assert route(dtype, D) == want


def test_tma_strides_rules():
    """Strides of whole 16 bytes pass through; a dim of size 1 takes its
    contiguous stride; anything else raises."""
    kv = torch.zeros(2, 5, 2, 3, 64, dtype=torch.bfloat16)
    k = kv[:, :, 0]                            # a strided view
    assert tma_strides("k", k) == list(k.stride()[:3])
    one = torch.zeros(1, 7, 2, 64, dtype=torch.bfloat16)[:, :, :1]
    assert tma_strides("q", one) == [7 * 64, 2 * 64, 64]
    wide = torch.zeros(1, 4, 2, 68, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="16 bytes"):
        tma_strides("q", wide[..., :64])


def test_tma_strides_take_160_byte_rows():
    """hubert-xlarge's D = 80: a 160-byte head stride (a whole 16 bytes)
    passes, contiguous and as k, v views of one fused [B, S, 2, H, 80]
    projection; an 80-column view of wider rows whose stride is not a
    whole 16 bytes raises."""
    B, S, H = 2, 7, 16
    q = torch.zeros(B, S, H, 80, dtype=torch.bfloat16)
    assert tma_strides("q", q) == [S * H * 80, H * 80, 80]
    kv = torch.zeros(B, S, 2, H, 80, dtype=torch.bfloat16)
    assert tma_strides("k", kv[:, :, 0]) == [S * 2 * H * 80, 2 * H * 80, 80]
    assert tma_strides("v", kv[:, :, 1]) == [S * 2 * H * 80, 2 * H * 80, 80]
    odd = torch.zeros(B, S, H, 84, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="16 bytes"):
        tma_strides("q", odd[..., :80])
