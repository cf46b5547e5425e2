"""The plain backward versions of the float kernels against the JAX
reference, on the CPU.

``ref.rmsnorm_bwd_ref`` and ``ref.attention_bwd_ref`` are what the
backward kernels (``csrc/rmsnorm_bwd.cu``, ``csrc/flash_attention_bwd*.cu``)
are held to on the card; here they are held to ``jax.vjp`` of the
reference's ``repro.kernels.ref.rmsnorm_ref`` and ``attention_ref`` on the
same inputs (seeded numpy arrays) and cotangents.  Tolerances, rtol =
atol: 1e-5 in f32 (the same f32 math, summed in another order), 2e-2 in
bf16 (both sides compute in f32 from the same bf16 inputs and round the
result once; one bf16 step is 2^-8 relative).  rmsnorm's f32 dw, a sum
over the rows, is held to 1e-5 of the sum of its terms' magnitudes.
The attention cases are those of
``test_cuda_flash_attention_bwd_equals_plain``, the training shape at
one row of the batch; the rmsnorm cases those of
``test_cuda_rmsnorm_bwd_equals_plain``.  At MLA's (D, Dv) = (192, 128)
(deepseek-v2) the reference's ``attention_ref`` shapes its output with
q's width, so the plain backward is held to ``jax.vjp`` of the
reference's MLA attention, ``repro.models.layers.attention``, run in f32
(on the bf16 values for the bf16 cases, whose result is rounded once).

``ref.ssd_chunk_bwd_ref`` (what ``csrc/ssd_chunk_bwd.cu`` is held to) is
held to ``jax.vjp`` of the reference's one-chunk ``ssd_chunk_ref``,
vmapped over (batch, chunk, head), with nonzero cotangents on y, the
state and cum.  dt = 0.1 softplus(normal) and A = -exp(U(0, 1.5)), as
``chip_smoke.py`` draws them, and one case whose cum falls to about -100
over 64 rows, so that a masked pair's exp(cum_i - cum_j) would
overflow; B and C one group broadcast to the heads as a stride-0 view
(as the model passes them) or one array per head.  In f32 each output is
held to 1e-5 of its largest magnitude: ddt and dA add a reverse cumsum
of cancelling terms (their sums up to ~1000x smaller than their terms),
where f32 sums in another order differ by more than 1e-5 of the element
(``test_torch_ssd_bwd.py::test_f32_ddt_cancels_against_f64``: more than
1e-4 against f64); ddt and dA are f32 for both dtypes and held so.

The wrappers' host-side choices (the backward's route and
``rmsnorm_bwd_plan``) are plain Python and are checked here too.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.models import layers as rlayers
from repro_torch.kernels import ref
from repro_torch.kernels.flash_attention import (BWD_HEAD_DIMS, check_stats,
                                                 route)
from repro_torch.kernels.rmsnorm import (BWD_BLOCK_ROWS, ELEMENT_PATH,
                                         plan, rmsnorm_bwd_plan)

TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _arrays(seed, shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _close(got, want, dtype):
    """``got`` (torch) against ``want`` (jax) at the tolerance of a call
    in ``dtype``; both of one dtype."""
    assert str(got.dtype).split(".")[-1] == str(want.dtype)
    tol = TOL[dtype]
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("R,D", [(4096, 960), (8, 960), (7, 80), (5, 100),
                                 (3, 8), (33, 4096), (1, 7)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_bwd_ref_matches_jax_vjp(R, D, dtype):
    xa, dya, wa = _arrays(R + D, ((R, D), (R, D), (D,)))
    wa *= 0.1
    x, dy = (torch.from_numpy(a).to(dtype) for a in (xa, dya))
    w = torch.from_numpy(wa)
    dx, dw = ref.rmsnorm_bwd_ref(x, w, dy)
    jx, jdy = (jnp.asarray(t.float().numpy(), JDT[dtype]) for t in (x, dy))
    _, vjp = jax.vjp(lambda a, b: jref.rmsnorm_ref(a, b), jx,
                     jnp.asarray(wa))
    want_dx, want_dw = vjp(jdy)
    assert dw.dtype == torch.float32
    _close(dx, want_dx, dtype)
    if dtype == torch.bfloat16:
        _close(dw, want_dw, dtype)
        return
    # dw sums R terms dy * xh, in another order than XLA's: in f32 each
    # column is held to 1e-5 of the sum of its terms' magnitudes (at R =
    # 4096 the columns' terms cancel to sums 64x smaller than that)
    xf = x.double()
    xh = xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + 1e-6)
    mag = (dy.double() * xh).abs().sum(0)
    err = (dw.double() - torch.from_numpy(np.array(want_dw))).abs()
    assert str(want_dw.dtype) == "float32"
    assert bool((err <= TOL[dtype] * (1 + mag)).all()), float(
        (err / (1 + mag)).max())


ATTENTION_CASES = [
    (1, 512, 512, 15, 5, 64, True, 0),        # smollm-360m's training step
    (1, 100, 100, 15, 5, 64, True, 0),        # ragged tail
    (2, 77, 77, 4, 2, 16, False, 0),
    (1, 130, 130, 4, 1, 128, True, 32),       # MQA, windowed
    (1, 50, 130, 4, 2, 32, False, 0),         # rectangular
    (1, 130, 50, 4, 2, 64, True, 0),          # more queries than keys
    # rows 65.. have no visible key (past Sk and the window): both weigh
    # their keys evenly
    (1, 130, 50, 4, 2, 64, True, 16),
    (1, 200, 200, 4, 2, 64, False, 32),
    (1, 77, 77, 4, 4, 80, False, 0),          # hubert-xlarge's head dim
    (1, 100, 100, 4, 2, 256, True, 32),       # gemma3-4b's, windowed
]


@pytest.mark.parametrize("B,Sq,Sk,Hq,Hkv,D,causal,window", ATTENTION_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_bwd_ref_matches_jax_vjp(B, Sq, Sk, Hq, Hkv, D, causal,
                                           window, dtype):
    arrs = _arrays(Sq + Sk + D, ((B, Sq, Hq, D), (B, Sk, Hkv, D),
                                 (B, Sk, Hkv, D), (B, Sq, Hq, D)))
    q, k, v, dout = (torch.from_numpy(a).to(dtype) for a in arrs)
    got = ref.attention_bwd_ref(q, k, v, dout, causal=causal, window=window)
    jq, jk, jv, jdo = (jnp.asarray(t.float().numpy(), JDT[dtype])
                       for t in (q, k, v, dout))
    _, vjp = jax.vjp(lambda a, b, c: jref.attention_ref(
        a, b, c, causal=causal, window=window), jq, jk, jv)
    for g, w in zip(got, vjp(jdo)):
        assert torch.isfinite(g.float()).all()
        _close(g, w, dtype)


@pytest.mark.parametrize("B,Sq,Sk,Hq,Hkv,causal,window", [
    (1, 512, 512, 4, 4, True, 0),             # deepseek-v2's training rows
    (1, 130, 130, 4, 2, True, 32),            # GQA, windowed, ragged
    (1, 77, 130, 4, 1, False, 0),             # rectangular
    (1, 130, 50, 4, 2, True, 16),             # rows with no visible key
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_bwd_ref_at_the_mla_pair_matches_jax_vjp(
        B, Sq, Sk, Hq, Hkv, causal, window, dtype):
    """The plain backward at (D, Dv) = (192, 128): dq and dk 192 wide, dv
    128, against ``jax.vjp`` of the reference's MLA attention."""
    D, Dv = 192, 128
    arrs = _arrays(Sq + Sk + D, ((B, Sq, Hq, D), (B, Sk, Hkv, D),
                                 (B, Sk, Hkv, Dv), (B, Sq, Hq, Dv)))
    q, k, v, dout = (torch.from_numpy(a).to(dtype) for a in arrs)
    got = ref.attention_bwd_ref(q, k, v, dout, causal=causal, window=window)
    assert [g.shape for g in got] == [q.shape, k.shape, v.shape]
    jq, jk, jv, jdo = (jnp.asarray(t.float().numpy()) for t in (q, k, v,
                                                               dout))
    _, vjp = jax.vjp(lambda a, b, c: rlayers.attention(
        a, b, c, causal=causal, window=window, chunk=Sq), jq, jk, jv)
    for g, w in zip(got, vjp(jdo)):
        assert torch.isfinite(g.float()).all()
        _close(g, w.astype(JDT[dtype]), dtype)


@pytest.mark.parametrize("D", BWD_HEAD_DIMS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_bwd_takes_the_forward_route(dtype, D):
    """The backward takes the forward's ``route``: the tensor-core
    kernel for bf16 at D = 64, 80, 128 and 256, the CUDA-core kernel
    otherwise;
    the row statistics it needs on the tensor-core route are
    ``[2, B, Hq, Sq]`` f32, contiguous, on q's device."""
    want = "wgmma" if dtype == torch.bfloat16 and D in (64, 80, 128, 256) \
        else "simt"
    assert route(dtype, D) == want
    q = torch.zeros(2, 5, 3, D, dtype=dtype)
    check_stats("t", torch.zeros(2, 2, 3, 5), q)
    for bad in (torch.zeros(2, 2, 5, 3), torch.zeros(2, 2, 3, 5,
                                                      dtype=torch.float64),
                torch.zeros(2, 2, 3, 10)[..., ::2], None):
        with pytest.raises(ValueError, match="stats"):
            check_stats("t", bad, q)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_bwd_takes_the_forward_route_at_the_mla_pair(dtype):
    """At (192, 128) the backward's route is the forward's: bf16 on the
    tensor cores (which needs the forward's row statistics, one row per
    query as at every pair), f32 on the CUDA cores."""
    want = "wgmma" if dtype == torch.bfloat16 else "simt"
    assert route(dtype, 192, 128) == want
    check_stats("t", torch.zeros(2, 2, 3, 5),
                torch.zeros(2, 5, 3, 192, dtype=dtype))


@pytest.mark.parametrize("R,D,vec_len", [
    (4096, 960, 8), (4096, 960, 4), (8, 960, 8), (33, 4096, 8),
    (33, 4096, 4), (7, 80, 8), (5, 100, 8), (1, 7, 4), (4096, 6400, 4),
    (1 << 20, 960, 8)])
def test_rmsnorm_bwd_plan(R, D, vec_len):
    """The backward holds rows in the forward's layout: ``plan``'s
    (vpt, tpr, slots); the element path (8 rows a block) where the
    forward takes it or a pointer is off 16 bytes.  The thread's vectors
    cover the row.  Blocks: one a row group up to one an SM, at most
    four an SM, and no block walks more than four groups below that."""
    n_sms = 132
    vpt, tpr, slots, G = rmsnorm_bwd_plan(R, D, vec_len, n_sms)
    if plan(R, D, vec_len, n_sms) == ELEMENT_PATH:
        assert (vpt, slots) == (0, BWD_BLOCK_ROWS)
    else:
        assert (vpt, tpr, slots) == plan(R, D, vec_len, n_sms)
        assert vpt * tpr * vec_len >= D and slots * tpr <= 256
    groups = -(-R // slots)
    assert min(groups, n_sms) <= G <= min(groups, 4 * n_sms)
    assert -(-groups // G) <= 4 or G == 4 * n_sms
    element = rmsnorm_bwd_plan(R, D, vec_len, n_sms, aligned=False)
    assert element[:3] == (0, ELEMENT_PATH[1], BWD_BLOCK_ROWS)
    assert element[3] == rmsnorm_bwd_plan(R, D, D + 1, n_sms)[3]


# ------------------------------------------------------------- ssd_chunk
SSD_CASES = [   # B, nc, Q, H, P, N, stride-0 B/C, dt scale
    (1, 2, 16, 2, 16, 8, True, 0.1),
    (2, 1, 64, 3, 16, 16, False, 0.1),
    (1, 1, 64, 2, 16, 16, True, 1.5),     # cum to about -100
    (1, 2, 40, 2, 16, 8, False, 0.1),     # a ragged tile
    (1, 1, 130, 2, 16, 16, True, 0.1),    # three key tiles, one ragged
]


def ssd_inputs(B, nc, Q, H, P, N, stride0, scale, dtype, seed):
    """(x, dt, A, Bc, Cc, dy, dstate, dcum) as torch tensors; dy holds
    bf16 values, so that a bf16 cotangent carries it exactly."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    T = lambda a, dt=torch.float32: torch.from_numpy(a).to(dt)
    x = T(f(B, nc, Q, H, P), dtype)
    dt = T((np.log1p(np.exp(f(B, nc, Q, H))) * scale).astype(np.float32))
    A = T((-np.exp(rng.uniform(0.0, 1.5, H))).astype(np.float32))
    bc = []
    for _ in range(2):
        g = T(f(B, nc, Q, 1 if stride0 else H, N), dtype)
        bc.append(g.expand(B, nc, Q, H, N))
    dy = T(f(B, nc, Q, H, P)).to(torch.bfloat16).float()
    dstate = T(f(B, nc, H, N, P))
    dcum = T(f(B, nc, Q, H))
    return x, dt, A, bc[0], bc[1], dy, dstate, dcum


def ssd_jax_vjp(x, dt, A, Bc, Cc, dy, dstate, dcum):
    """jax.vjp of the reference's one-chunk ``ssd_chunk_ref`` vmapped over
    (b, chunk, head), every input per head; y in x's dtype as the
    reference returns it.  Returns (dx, ddt, dA, dBc, dCc) as numpy in
    the port's layout."""
    dtype = JDT[x.dtype]
    per = lambda t, d: jnp.asarray(np.moveaxis(
        t.float().contiguous().numpy(), 3, 2), d)     # [B, nc, H, Q, *]
    hq = lambda t: jnp.asarray(np.moveaxis(t.numpy(), 3, 2))
    one = jax.vmap(jref.ssd_chunk_ref, in_axes=(0, 0, 0, 0, 0))
    f = jax.vmap(jax.vmap(one, in_axes=(0, 0, None, 0, 0)),
                 in_axes=(0, 0, None, 0, 0))
    _, vjp = jax.vjp(f, per(x, dtype), hq(dt), jnp.asarray(A.numpy()),
                     per(Bc, dtype), per(Cc, dtype))
    grads = vjp((per(dy, dtype), jnp.asarray(dstate.numpy()), hq(dcum)))
    dx, ddt, dA, dB, dC = (np.asarray(g, np.float32) for g in grads)
    back = lambda a: np.moveaxis(a, 2, 3)
    return back(dx), back(ddt), dA, back(dB), back(dC)


def ssd_close(got, want, dtype, name):
    """``TOL``; in f32 at the scale of the output's largest magnitude."""
    got = got.float().numpy()
    if got.dtype != want.dtype or got.shape != want.shape:
        raise AssertionError(f"{name}: {got.shape} vs {want.shape}")
    tol = TOL[dtype]
    scale = 1.0 if dtype == torch.bfloat16 else max(1.0, np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale,
                               err_msg=name)


def ssd_check(got, want, dtype):
    names = ("dx", "ddt", "dA", "dBc", "dCc")
    for name, g, w in zip(names, got, want):
        assert torch.isfinite(g.float()).all(), name
        # ddt and dA are f32 on both sides: held as in f32
        ssd_close(g, w, torch.float32 if name in ("ddt", "dA") else dtype,
                  name)


@pytest.mark.parametrize("case", SSD_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_chunk_bwd_ref_matches_jax_vjp(case, dtype):
    args = ssd_inputs(*case, dtype, seed=sum(case[:6]))
    got = ref.ssd_chunk_bwd_ref(*args)
    assert [t.dtype for t in got] == [dtype, torch.float32, torch.float32,
                                      dtype, dtype]
    assert got[3].shape == args[3].shape            # per head, the view's
    ssd_check(got, ssd_jax_vjp(*args), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_chunk_bwd_ref_takes_y_in_f32(dtype):
    """With y asked in f32 (as the model asks it) dy is an f32 cotangent;
    holding bf16 values, it gives the bf16-y gradient."""
    args = ssd_inputs(1, 2, 64, 2, 16, 16, True, 0.1, dtype, seed=7)
    got = ref.ssd_chunk_bwd_ref(*args, out_dtype=torch.float32)
    ssd_check(got, ssd_jax_vjp(*args), dtype)
