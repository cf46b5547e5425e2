"""The arithmetic of the tensor-core SSD backward kernel against the JAX
reference on the CPU.

``csrc/ssd_chunk_bwd_wgmma.cu`` runs only on the card, so
``ssd_bwd_wgmma_emulation.emulate_bwd`` repeats its arithmetic in plain
torch (bf16 x, B and C exact as operands; dy, dstate and the weights s and
G split into bf16 hi and lo halves; 64-row query and key tiles with the
kernel's skips and selects; the query, key, chunk and dA passes in that
order), and this file holds it against the reference.  Tolerances, with
their reasons:

- against ``jax.vjp`` of the reference's ``ssd_chunk_ref`` on
  ``test_torch_backward``'s cases and at the models' widths, with
  full-f32 cotangents, the reference run in f32 on the bf16 inputs'
  values (it upcasts them itself; XLA's bf16 vjp on the CPU is up to 5%
  off the f64 gradient at dt scale 1.5, 1.25 against 1.1964, where the
  port's plain version and the emulation are within 0.1%): dx, dB and dC
  rounded to bf16 within 2e-2 (one bf16 rounding of the f32 result),
  ddt and dA (f32) within rtol 1e-4 and 1e-4 of their largest
  magnitude, as the card holds the kernel to the plain version
  (``chip_smoke.SSD_BWD_SCALED_TOL``): they are reverse cumsums of terms
  that cancel ~1000x (``test_torch_ssd_bwd.py::test_f32_ddt_cancels_against_f64``),
  and the halves carry ~2^-17 of each term (measured here: up to 1.5e-5
  of the scale, where the f32 plain version keeps within 1e-5);
- against the function's gradient in f64, with full-f32 cotangents: the
  split's error at least ``SPLIT_FACTOR`` times below that of one bf16
  rounding of the same f32 operands, for dx, dB and dC before their
  rounding to bf16 and for ddt and dA (measured on these cases: dx, dB
  and dC 324-753x, ddt 427-979x, dA 111-199x).

The backward's route and the wrapper's checks of its TMA operands are
plain Python and are checked here too; the kernel itself is held to this
emulation and to the plain version on the card in
``tests/test_torch_cuda.py``.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ref
from repro_torch.kernels.ssd_chunk import (HEAD_DIMS, dy_halves, pick, route,
                                           tma_view)
from ssd_bwd_wgmma_emulation import emulate_bwd, exact_bwd
from test_torch_backward import SSD_CASES, ssd_close, ssd_inputs, ssd_jax_vjp

SPLIT_FACTOR = 32
SCALED_TOL = 1e-4             # ddt and dA, at their output's scale
NAMES = ("dx", "ddt", "dA", "dBc", "dCc")
WGMMA_CASES = [   # B, nc, Q, H, P, N, stride-0 B/C, dt scale
    (1, 1, 256, 2, 64, 128, True, 0.1),     # mamba2's widths, 4 tiles
    (1, 2, 128, 2, 64, 64, True, 0.1),      # zamba2's widths
    (1, 1, 200, 2, 64, 64, False, 0.1),     # ragged last tiles
    (1, 1, 100, 1, 128, 128, True, 0.1),
    (1, 1, 64, 2, 64, 64, True, 1.5),       # cum to about -100
]


def _check(got, want):
    """The kernel's outputs (dx, dB and dC rounded to bf16) against the
    reference's gradient at the tolerances above."""
    for name, g, w in zip(NAMES, got, want):
        assert torch.isfinite(g).all(), name
        if name in ("ddt", "dA"):
            np.testing.assert_allclose(
                g.numpy(), w, rtol=SCALED_TOL,
                atol=SCALED_TOL * max(1.0, float(np.abs(w).max())),
                err_msg=name)
        else:
            ssd_close(g.to(torch.bfloat16), w, torch.bfloat16, name)


def _f32_cotangents(args, seed):
    """``args`` with dy replaced by full f32 values (the model's dy is the
    cotangent of y in f32), so that its split is exercised."""
    rng = np.random.default_rng(seed)
    dy = torch.from_numpy(rng.standard_normal(args[5].shape).astype(
        np.float32))
    return args[:5] + (dy,) + args[6:]


def _reference(args):
    """``jax.vjp`` of the reference in f32 on the bf16 inputs' values."""
    return ssd_jax_vjp(*(t.float() for t in args[:5]), *args[5:])


@pytest.mark.parametrize("case", SSD_CASES + WGMMA_CASES)
def test_split_emulation_matches_jax_vjp(case):
    seed = sum(case[:6]) + 2
    args = _f32_cotangents(ssd_inputs(*case, torch.bfloat16, seed=seed),
                           seed)
    cum = ref.ssd_chunk_ref(*args[:5])[2]
    _check(emulate_bwd(*args[:5], cum, *args[5:]), _reference(args))


@pytest.mark.parametrize("case", WGMMA_CASES[:3] + [
    (1, 2, 256, 24, 64, 128, True, 0.1)])  # mamba2's heads, one row
def test_split_beats_one_rounding(case):
    args = _f32_cotangents(ssd_inputs(*case, torch.bfloat16,
                                      seed=sum(case[:6])), sum(case[:6]))
    cum = ref.ssd_chunk_ref(*args[:5])[2]
    split = emulate_bwd(*args[:5], cum, *args[5:])
    one = emulate_bwd(*args[:5], cum, *args[5:], split=False)
    exact = exact_bwd(*args)
    for name, s, o, e in zip(NAMES, split, one, exact):
        err = lambda t: float((t.double() - e).abs().max())
        assert err(s) * SPLIT_FACTOR < err(o), (name, err(s), err(o))


def test_split_emulation_never_exponentiates_a_masked_pair():
    """At dt scale 1.5 cum falls by ~100 over 64 rows: exp(cum_i - cum_j)
    for j > i overflows to inf, and so does exp(0 - cum_j) for a padded
    row past Q; both are selected to 0 before use, so every gradient is
    finite, and the emulation is the reference's."""
    args = _f32_cotangents(ssd_inputs(1, 1, 100, 2, 64, 64, True, 1.5,
                                      torch.bfloat16, seed=4), 4)
    cum = ref.ssd_chunk_ref(*args[:5])[2]
    assert float(cum[..., 63, :].min()) < -88.0     # exp(88.7) is f32's max
    _check(emulate_bwd(*args[:5], cum, *args[5:]), _reference(args))


@pytest.mark.parametrize("N", [1, 16, 48, 64, 128, 256])
@pytest.mark.parametrize("P", [16, 32, 64, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_bwd_route_by_dtype_and_dims(dtype, P, N):
    """The backward takes the forward's route: the tensor-core kernel for
    bf16 at P and N in (64, 128), the CUDA-core kernel otherwise; the
    CUDA-core kernel takes every shape on request, the tensor-core kernel
    only its own."""
    want = "wgmma" if dtype == torch.bfloat16 and P in (64, 128) \
        and N in (64, 128) else "simt"
    assert P in HEAD_DIMS and route(dtype, P, N) == want
    assert pick("ssd_chunk_bwd", dtype, P, N) == want
    assert pick("ssd_chunk_bwd", dtype, P, N, "simt") == "simt"
    if want == "simt":
        with pytest.raises(ValueError, match="does not take"):
            pick("ssd_chunk_bwd", dtype, P, N, "wgmma")


@pytest.mark.parametrize("arch,H,N", [("mamba2-130m", 24, 128),
                                      ("zamba2-1.2b", 64, 64)])
def test_bwd_tma_views_of_dy_and_dstate(arch, H, N):
    """The key pass reads dy's bf16 halves through TMA maps over a
    contiguous [B, nc, Q, H, P] tensor (H heads, strides of whole 16
    bytes, both halves on 16 bytes); dy and dstate are read 16 bytes a
    row in f32, so a contiguous view that starts off 16 bytes is refused,
    as is a stride TMA cannot take."""
    import repro_torch.kernels.cuda as cuda
    Bsz, nc, Q, P = 8, 2, 256, 64
    dy = torch.zeros(Bsz, nc, Q, H, P)
    halves = dy_halves(dy)
    assert halves.shape == (2, Bsz, nc, Q, H, P)
    assert halves.dtype == torch.bfloat16 and halves.is_contiguous()
    for half in halves:
        assert tma_view("dy", half, False) == (
            [nc * Q * H * P, Q * H * P, H * P, P], H)
    dstate = torch.zeros(Bsz, nc, H, N, P)
    for t in (dy, dstate):
        cuda.check_rows_16b("t", t)
        flat = torch.zeros(t.numel() + 1)
        with pytest.raises(ValueError, match="16 bytes"):
            cuda.check_rows_16b("t", flat[1:].view(t.shape))
    odd = torch.zeros(Bsz, nc, Q, H, P + 4, dtype=torch.bfloat16)[..., :P]
    with pytest.raises(ValueError, match="16 bytes"):
        tma_view("dy", odd, False)
