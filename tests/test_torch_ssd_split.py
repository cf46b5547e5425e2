"""The arithmetic of the tensor-core SSD kernel, emulated on the CPU.

``csrc/ssd_chunk_wgmma.cu`` runs only on the card, so ``ssd_emulation.py``
repeats its arithmetic in plain PyTorch (bf16 inputs, scores exact in f32,
64-row warpgroups and 64-key tiles with the kernel's skips and masks, the
weights W and the state's w x split into bf16 halves ``hi = bf16(t)`` and
``lo = bf16(t - hi)`` whose two products add into one f32 accumulator),
and this file holds it against the reference.  Inputs come from numpy with
a seed; the reference's Pallas kernel runs in interpret mode.  Tolerances,
with their reasons:

- against the Pallas kernel on the bf16 inputs, y rounded to bf16 on both
  sides, rtol = atol = 2e-2: both compute in f32 and round once (one bf16
  step is 2^-8 relative);
- against the Pallas kernel on the same values in f32 (y, state in f32),
  rtol = atol = ``SPLIT_TOL`` (5e-4): the split keeps ~16 bits of each
  weight (2^-17 relative), and the two sum over up to 256 keys in
  another order; the largest error measured over the five split cases
  is 8e-5 absolute, at |y| up to 21;
- the split against one bf16 rounding of W (and of w x), both against the
  function in f64: the split's error must be at least 16x smaller (about
  2^8 expected);
- cum within 1e-5: one f32 cumsum on both sides.

The route function, the TMA view rules of the wrapper and the model's
views are plain Python and are checked here too; the kernel itself is held
to this emulation and to the plain version on the card in
``tests/test_torch_cuda.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd_chunk import ssd_chunk as pallas_ssd_chunk
from repro_torch import configs as tcfgs
from repro_torch.kernels import ops
from repro_torch.kernels.ssd_chunk import HEAD_DIMS, route, tma_view
from repro_torch.models import ssm as tssm
from ssd_emulation import emulate_kernel, exact_ssd

BF16 = dict(rtol=2e-2, atol=2e-2)
SPLIT_TOL = dict(rtol=5e-4, atol=5e-4)
CUM = dict(rtol=1e-5, atol=1e-5)


def _inputs(B, nc, Q, H, P, N, seed):
    """bf16 x, B, C (one group, broadcast to the heads as the model does),
    f32 dt = 0.1 softplus(normal) and A = -exp(U(0, 1.5)): cum falls to
    about -50 over a chunk of 256."""
    rng = np.random.default_rng(seed)
    bf = lambda shp: torch.from_numpy(
        rng.standard_normal(shp).astype(np.float32)).to(torch.bfloat16)
    x = bf((B, nc, Q, H, P))
    dt = torch.from_numpy((np.log1p(np.exp(rng.standard_normal(
        (B, nc, Q, H)))) * 0.1).astype(np.float32))
    A = torch.from_numpy((-np.exp(rng.uniform(0.0, 1.5, H))).astype(
        np.float32))
    Bc, Cc = (bf((B, nc, Q, 1, N)).expand(B, nc, Q, H, N) for _ in range(2))
    return x, dt, A, Bc, Cc


def _pallas(x, dt, A, Bc, Cc, dtype):
    j = lambda t: jnp.asarray(t.float().contiguous().numpy(), dtype)
    return [np.asarray(r, np.float32) for r in pallas_ssd_chunk(
        j(x), jnp.asarray(dt.numpy()), jnp.asarray(A.numpy()), j(Bc), j(Cc),
        interpret=True)]


@pytest.mark.parametrize("B,nc,Q,H,P,N", [
    (1, 2, 128, 2, 64, 64),        # zamba2's widths, one query block
    (1, 1, 256, 2, 64, 128),       # mamba2's widths, two query blocks
    (2, 1, 200, 2, 64, 64),        # ragged last query and key tiles
    (1, 1, 16, 2, 128, 128),       # one short chunk, P = N = 128
    (1, 1, 100, 1, 128, 64),
])
def test_split_emulation_matches_pallas_and_beats_one_rounding(B, nc, Q, H,
                                                               P, N):
    args = _inputs(B, nc, Q, H, P, N, seed=Q + P + N)
    y, st, cum = emulate_kernel(*args)
    assert all(torch.isfinite(t).all() for t in (y, st, cum))
    yb, sb, cb = _pallas(*args, jnp.bfloat16)
    np.testing.assert_allclose(y.to(torch.bfloat16).float().numpy(), yb,
                               **BF16)
    np.testing.assert_allclose(st.numpy(), sb, **BF16)
    np.testing.assert_allclose(cum.numpy(), cb, **CUM)
    yf, sf, _ = _pallas(*args, jnp.float32)
    np.testing.assert_allclose(y.numpy(), yf, **SPLIT_TOL)
    np.testing.assert_allclose(st.numpy(), sf, **SPLIT_TOL)

    y_ex, st_ex = exact_ssd(*args)
    y1, st1, _ = emulate_kernel(*args, split=False)
    err = lambda a, b: float((a.double() - b).abs().max())
    assert err(y, y_ex) * 16 < err(y1, y_ex), (err(y, y_ex), err(y1, y_ex))
    assert err(st, st_ex) * 16 < err(st1, st_ex), (err(st, st_ex),
                                                   err(st1, st_ex))


def test_emulation_never_weighs_masked_pairs():
    """dt wide enough that cum spans hundreds: exp(cum_i - cum_j) is inf
    for j > i; those pairs are selected to 0, so no NaN reaches y."""
    x, dt, A, Bc, Cc = _inputs(1, 1, 128, 2, 64, 64, seed=5)
    dt = dt * 200
    y, st, cum = emulate_kernel(x, dt, A, Bc, Cc)
    assert float(cum.min()) < -100
    assert all(torch.isfinite(t).all() for t in (y, st))
    yf, sf, _ = _pallas(x, dt, A, Bc, Cc, jnp.float32)
    np.testing.assert_allclose(y.numpy(), yf, **SPLIT_TOL)
    np.testing.assert_allclose(st.numpy(), sf, **SPLIT_TOL)


@pytest.mark.parametrize("N", [1, 16, 48, 64, 128, 256, 257])
@pytest.mark.parametrize("P", [8, 16, 32, 64, 128, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_ssd_route_by_dtype_and_dims(dtype, P, N):
    if dtype == torch.float16 or P not in HEAD_DIMS or not 1 <= N <= 256:
        with pytest.raises(ValueError, match="no kernel"):
            route(dtype, P, N)
        return
    want = "wgmma" if dtype == torch.bfloat16 and P in (64, 128) \
        and N in (64, 128) else "simt"
    assert route(dtype, P, N) == want


def test_tma_view_rules():
    """Strides of whole 16 bytes pass through; a broadcast head (stride 0)
    reads through a head dim of size 1; a dim of size 1 takes its
    contiguous stride; a misaligned stride or base, or a stride of 0 that
    is not a broadcast head, raises."""
    xbc = torch.zeros(2, 3, 32, 1792, dtype=torch.bfloat16)
    x = xbc[..., :1536].reshape(2, 3, 32, 24, 64)
    assert tma_view("x", x, False) == ([3 * 32 * 1792, 32 * 1792, 1792, 64],
                                       24)
    b = xbc[..., 1536:1664].reshape(2, 3, 32, 1, 128).expand(2, 3, 32, 24,
                                                             128)
    assert tma_view("Bc", b) == ([3 * 32 * 1792, 32 * 1792, 1792, 128], 1)
    one = torch.zeros(1, 1, 16, 2, 64, dtype=torch.bfloat16)
    assert tma_view("x", one, False)[0] == [16 * 2 * 64, 16 * 2 * 64,
                                            2 * 64, 64]
    with pytest.raises(ValueError, match="stride of 0"):
        tma_view("x", b, False)
    odd = torch.zeros(1, 1, 4, 2, 68, dtype=torch.bfloat16)[..., :64]
    with pytest.raises(ValueError, match="16 bytes"):
        tma_view("x", odd, False)
    flat = torch.zeros(1 + 2 * 4 * 2 * 64, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="16 bytes"):
        tma_view("x", flat[1:].view(1, 2, 4, 2, 64), False)


@pytest.mark.parametrize("arch", ["mamba2-130m", "zamba2-1.2b"])
def test_model_views_take_the_tensor_core_route(arch, monkeypatch):
    """At full width the model hands ``ssd_chunk`` bf16 views that the
    tensor-core route takes as they are: x a strided view of the conv
    output (row stride d_inner + 2GN), B and C its group's columns
    broadcast to the heads with stride 0, read through a size-1 head."""
    cfg = tcfgs.get(arch)
    d_in, H, Pd, G, N = tssm.ssm_dims(cfg)
    gen = torch.Generator().manual_seed(0)
    p = {k: (torch.randn(s.shape, generator=gen) * 0.02).to(
        torch.bfloat16 if len(s.shape) == 2 else torch.float32)
        for k, s in tssm.ssm_spec(cfg).items()}
    seen = []
    real = ops.ssd_chunk

    def spy(*args, **kw):
        seen.append(args)
        return real(*args, **kw)

    monkeypatch.setattr(ops, "ssd_chunk", spy)
    h = torch.randn(1, 16, cfg.d_model, generator=gen).to(torch.bfloat16)
    out, _ = tssm.ssm_apply(cfg, p, h)
    assert torch.isfinite(out.float()).all() and len(seen) == 1
    x, dt, A, Bc, Cc, out_dtype = seen[0]
    assert out_dtype == torch.float32
    assert route(x.dtype, Pd, N) == "wgmma"
    row = d_in + 2 * G * N
    assert x.stride(2) == row            # one prompt: b, c take any stride
    assert tma_view("x", x, False) == ([16 * H * Pd] * 2 + [row, Pd], H)
    for t in (Bc, Cc):
        assert t.stride(3) == 0 and t.stride(2) == row
        assert tma_view("Bc", t) == ([16 * H * N] * 2 + [row, N], 1)
