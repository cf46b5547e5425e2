"""The port's SSM serving path (``ssd_chunk``, ``models/ssm.py``, mamba2
and zamba2's hybrid stack, the server over both) against the reference.

Inputs and weights come from numpy with a seed and are handed to both
packages; weights and caches cross over through
``repro_torch.models.convert``.  The reference's Pallas ``ssd_chunk``
runs in interpret mode.  Tolerances, with their reasons:

- ``F32`` (rtol = atol = 1e-4): the same f32 arithmetic summed in another
  order (einsum vs matmul, cumsum, ``exp`` from two libraries);
- ``CUM`` (rtol = atol = 1e-5): ``cum`` is one f32 cumsum on both sides;
- ``BF16`` (rtol = atol = 2e-2): bf16 keeps 8 significant bits, and a
  value may round differently on the two sides.  In the model the port
  keeps the intra-chunk output in f32, as the reference's jnp
  ``ssd_chunked`` does, and rounds once after adding the inter-chunk
  part; ``BF16_MODEL_REL_L2`` pins the bf16 models' relative L2 at what
  that gives, with a margin of about 10%: mamba2 0.01155 / 0.01575 (forward /
  after three decode steps), zamba2 0.00741 / 0.00804, where rounding
  the intra-chunk part to bf16 first gave 0.01175 / 0.01607 and
  0.01278 / 0.01128.

The CUDA kernel is held to the plain version on the card in
``tests/test_torch_cuda.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as rcfgs
from repro.kernels import ref as rref
from repro.kernels.ssd_chunk import ssd_chunk as pallas_ssd_chunk
from repro.models import init_model as r_init_model
from repro.models import model as rmodel
from repro.models import ssm as rssm
from repro.models.config import Policy as RPolicy
from repro.models.params import P as RP
from repro.runtime.server import Request as RRequest
from repro.runtime.server import Server as RServer
from repro_torch import configs as tcfgs
from repro_torch.kernels import ops, ref
from repro_torch.kernels.ssd_chunk import ssd_chunk as cuda_ssd_chunk
from repro_torch.launch import serve as tserve
from repro_torch.models import convert
from repro_torch.models import model as tmodel
from repro_torch.models import ssm as tssm
from repro_torch.models.config import Policy as TPolicy
from repro_torch.runtime.server import Request, Server

F32 = dict(rtol=1e-4, atol=1e-4)
CUM = dict(rtol=1e-5, atol=1e-5)
BF16 = dict(rtol=2e-2, atol=2e-2)
DTYPES = {"f32": (jnp.float32, torch.float32, F32),
          "bf16": (jnp.bfloat16, torch.bfloat16, BF16)}
ARCHS = ["mamba2-130m", "zamba2-1.2b"]
# bf16 port vs reference, relative L2 of the forward's and of the last
# decode step's hidden states (measured values + 10%; see the docstring)
BF16_MODEL_REL_L2 = {"mamba2-130m": (0.0127, 0.0173),
                     "zamba2-1.2b": (0.0082, 0.0089)}


def _np(t):
    """A port tensor or reference array as f32 numpy."""
    if isinstance(t, torch.Tensor):
        return t.detach().float().cpu().numpy()
    return np.asarray(t, np.float32)


def _pair(a, dt):
    """One numpy f32 array as a reference array and a port tensor of the
    same dtype (both round f32 -> bf16 to nearest even)."""
    jd, td, _ = DTYPES[dt]
    return jnp.asarray(a, jd), torch.from_numpy(np.ascontiguousarray(a)).to(td)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += _leaves(tree[k], f"{prefix}/{k}")
        return out
    return [(prefix, tree)]


def _rel_l2(a, b):
    a, b = _np(a), _np(b)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _f32(cfg):
    """The config under the f32 policy (compute and cache in f32)."""
    pol = dict(compute_dtype=jnp.float32, cache_dtype=jnp.float32) \
        if isinstance(cfg.policy, RPolicy) else \
        dict(compute_dtype=torch.float32, cache_dtype=torch.float32)
    return dataclasses.replace(cfg, policy=type(cfg.policy)(**pol))


# ------------------------------------------------------------- ssd_chunk
def _ssd_inputs(B, nc, Q, H, P, N, seed, dt_scale=1.0):
    """x, dt (softplus of a normal, times ``dt_scale``), A (-exp of
    U(0, 1.5), as the reference's kernel test draws it), B and C."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, nc, Q, H, P)).astype(np.float32)
    dt = (np.log1p(np.exp(rng.standard_normal((B, nc, Q, H))))
          * dt_scale).astype(np.float32)
    A = (-np.exp(rng.uniform(0.0, 1.5, H))).astype(np.float32)
    Bc = rng.standard_normal((B, nc, Q, 1, N)).astype(np.float32)
    Cc = rng.standard_normal((B, nc, Q, 1, N)).astype(np.float32)
    return x, dt, A, Bc, Cc


def _broadcast_pair(a, H, dt, stride0):
    """``[..., 1, N]`` -> ``[..., H, N]``: a materialised reference array,
    and a port tensor that is a stride-0 view (``stride0``) or a copy."""
    full = np.broadcast_to(a, a.shape[:3] + (H, a.shape[-1]))
    j, t = _pair(np.ascontiguousarray(full), dt)
    if stride0:
        t = _pair(a, dt)[1].expand(*full.shape)
        assert t.stride(3) == 0
    return j, t


@pytest.mark.parametrize("B,nc,Q,H,P,N", [(1, 2, 32, 2, 16, 16),
                                          (2, 4, 64, 4, 32, 32)])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("stride0", [False, True])
def test_ssd_chunk_ref_matches_pallas_and_reference(B, nc, Q, H, P, N, dt,
                                                    stride0):
    """The batched plain version against the Pallas kernel (interpret
    mode) and against the reference's one-chunk oracle, per (b, c, h)."""
    x, dtv, A, Bc, Cc = _ssd_inputs(B, nc, Q, H, P, N, seed=Q + H)
    xj, xt = _pair(x, dt)
    Bj, Bt = _broadcast_pair(Bc, H, dt, stride0)
    Cj, Ct = _broadcast_pair(Cc, H, dt, stride0)
    tol = DTYPES[dt][2]
    y, st, cum = ref.ssd_chunk_ref(xt, torch.from_numpy(dtv),
                                   torch.from_numpy(A), Bt, Ct)
    assert y.dtype == xt.dtype and st.dtype == cum.dtype == torch.float32
    assert y.shape == (B, nc, Q, H, P) and st.shape == (B, nc, H, N, P) \
        and cum.shape == (B, nc, Q, H)
    yp, sp, cp = pallas_ssd_chunk(xj, jnp.asarray(dtv), jnp.asarray(A), Bj,
                                  Cj, interpret=True)
    np.testing.assert_allclose(_np(y), _np(yp), **tol)
    np.testing.assert_allclose(_np(st), _np(sp), **tol)
    np.testing.assert_allclose(_np(cum), _np(cp), **CUM)
    for b in range(B):
        for c in range(nc):
            for h in range(H):
                yr, sr, cr = rref.ssd_chunk_ref(
                    xj[b, c, :, h], jnp.asarray(dtv[b, c, :, h]), A[h],
                    Bj[b, c, :, h], Cj[b, c, :, h])
                np.testing.assert_allclose(_np(y[b, c, :, h]), _np(yr),
                                           **tol)
                np.testing.assert_allclose(_np(st[b, c, h]), _np(sr), **tol)
                np.testing.assert_allclose(_np(cum[b, c, :, h]), _np(cr),
                                           **CUM)


@pytest.mark.parametrize("stride0", [False, True])
def test_ssd_chunk_ref_out_dtype_f32(stride0):
    """``out_dtype=torch.float32`` returns the intra-chunk output before
    its rounding: the Pallas kernel's on the same values in f32, and the
    default bf16 output once rounded."""
    x, dtv, A, Bc, Cc = _ssd_inputs(2, 2, 64, 4, 32, 32, seed=3)
    xj, xt = _pair(x, "bf16")
    Bj, Bt = _broadcast_pair(Bc, 4, "bf16", stride0)
    Cj, Ct = _broadcast_pair(Cc, 4, "bf16", stride0)
    args = (xt, torch.from_numpy(dtv), torch.from_numpy(A), Bt, Ct)
    y32, st, _ = ops.ssd_chunk(*args, torch.float32)
    y, st16, _ = ref.ssd_chunk_ref(*args)
    assert y32.dtype == torch.float32 and y.dtype == torch.bfloat16
    assert torch.equal(y32.to(torch.bfloat16), y) and torch.equal(st, st16)
    f = lambda a: jnp.asarray(np.asarray(a, np.float32))
    yp, sp, _ = pallas_ssd_chunk(f(xj), jnp.asarray(dtv), jnp.asarray(A),
                                 f(Bj), f(Cj), interpret=True)
    np.testing.assert_allclose(_np(y32), _np(yp), **F32)
    np.testing.assert_allclose(_np(st), _np(sp), **F32)


def test_ssd_chunk_ref_wide_dt_stays_finite():
    """dt drawn so that cum spans hundreds: exp(cum_i - cum_j) would be
    inf for j > i, and a 0 mask times inf is NaN; those pairs must weigh
    exactly 0 (the reference's exp(-inf)), as in the Pallas kernel."""
    x, dtv, A, Bc, Cc = _ssd_inputs(1, 1, 64, 2, 16, 16, seed=5,
                                    dt_scale=20.0)
    xj, xt = _pair(x, "f32")
    Bh = np.ascontiguousarray(np.broadcast_to(Bc, (1, 1, 64, 2, 16)))
    Ch = np.ascontiguousarray(np.broadcast_to(Cc, (1, 1, 64, 2, 16)))
    y, st, cum = ref.ssd_chunk_ref(xt, torch.from_numpy(dtv),
                                   torch.from_numpy(A), torch.from_numpy(Bh),
                                   torch.from_numpy(Ch))
    assert float(cum.min()) < -100
    assert all(torch.isfinite(t).all() for t in (y, st, cum))
    yp, sp, _ = pallas_ssd_chunk(xj, jnp.asarray(dtv), jnp.asarray(A),
                                 jnp.asarray(Bh), jnp.asarray(Ch),
                                 interpret=True)
    np.testing.assert_allclose(_np(y), _np(yp), **F32)
    np.testing.assert_allclose(_np(st), _np(sp), **F32)


def test_ssd_chunk_dispatch_and_wrapper_refuses_cpu():
    """CPU tensors go to the plain version; the CUDA wrapper raises on
    them instead of falling back."""
    x, dtv, A, Bc, Cc = _ssd_inputs(1, 1, 16, 2, 16, 16, seed=1)
    args = (torch.from_numpy(x), torch.from_numpy(dtv), torch.from_numpy(A),
            torch.from_numpy(Bc).expand(1, 1, 16, 2, 16),
            torch.from_numpy(Cc).expand(1, 1, 16, 2, 16))
    for a, b in zip(ops.ssd_chunk(*args), ref.ssd_chunk_ref(*args)):
        assert torch.equal(a, b)
    before = cuda_ssd_chunk.launches
    with pytest.raises(ValueError, match="CUDA tensor"):
        cuda_ssd_chunk(*args)
    assert cuda_ssd_chunk.launches == before


def test_einsum_dtype_pins():
    """jnp promotes a bf16 x f32 einsum to f32 (``ssm.py:140-141``); torch
    refuses mixed dtypes, so the port casts the compute-dtype operand to
    f32 first and gets the reference's f32 result."""
    rng = np.random.default_rng(0)
    c = rng.standard_normal((2, 3, 4)).astype(np.float32)
    s = rng.standard_normal((2, 3, 4, 5)).astype(np.float32)
    cj, ct = _pair(c, "bf16")
    want = jnp.einsum("bhn,bhnp->bhp", cj, jnp.asarray(s))
    assert want.dtype == jnp.float32
    with pytest.raises(RuntimeError):
        torch.einsum("bhn,bhnp->bhp", ct, torch.from_numpy(s))
    got = torch.einsum("bhn,bhnp->bhp", ct.float(), torch.from_numpy(s))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(_np(got), _np(want), **F32)
    # elementwise products promote on both sides (``ssm.py:138``)
    assert (ct * torch.from_numpy(s[..., 0])).dtype == torch.float32


# ----------------------------------------------------------- ssd_chunked
@pytest.mark.parametrize("G", [1, 2])
@pytest.mark.parametrize("with_state0", [False, True])
def test_ssd_chunked_matches_reference(G, with_state0):
    """Kernel (plain version) intra-chunk + the loop over chunks against
    the reference's jnp ``ssd_chunked``: four chunks, a carried-in state,
    one and two groups (f32)."""
    B, S, H, P, N, chunk = 2, 128, 4, 16, 16, 32
    rng = np.random.default_rng(G + 2 * with_state0)
    x = rng.standard_normal((B, S, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, H)))).astype(np.float32)
    A = (-np.exp(rng.uniform(0.0, 1.5, H))).astype(np.float32)
    Bc = rng.standard_normal((B, S, G, N)).astype(np.float32)
    Cc = rng.standard_normal((B, S, G, N)).astype(np.float32)
    s0 = rng.standard_normal((B, H, N, P)).astype(np.float32) \
        if with_state0 else None
    yr, fr = rssm.ssd_chunked(*map(jnp.asarray, (x, dt, A, Bc, Cc)), chunk,
                              None if s0 is None else jnp.asarray(s0))
    yt, ft = tssm.ssd_chunked(*map(torch.from_numpy, (x, dt, A, Bc, Cc)),
                              chunk,
                              None if s0 is None else torch.from_numpy(s0))
    assert yt.dtype == torch.float32 and ft.shape == (B, H, N, P)
    np.testing.assert_allclose(_np(yt), _np(yr), **F32)
    np.testing.assert_allclose(_np(ft), _np(fr), **F32)


def test_ragged_prompt_length_raises():
    """A chunk that does not divide the sequence raises (the reference
    asserts); nothing is padded silently."""
    x = torch.zeros(1, 40, 2, 16)
    with pytest.raises(ValueError, match="does not divide"):
        tssm.ssd_chunked(x, torch.ones(1, 40, 2), -torch.ones(2),
                         torch.zeros(1, 40, 1, 16), torch.zeros(1, 40, 1, 16),
                         16)
    cfg = tcfgs.SMOKE["mamba2-130m"]                # ssd_chunk = 16
    params = tmodel.init_model(cfg, torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="does not divide"):
        tmodel.prefill(cfg, params, torch.ones(2, 20, dtype=torch.int32),
                       tmodel.init_cache(cfg, 2, 32, "cpu"))


# -------------------------------------------------------------- ssm_apply
def _np_tree(spec, rng, scale=0.1):
    """Numpy weights for a reference spec tree, drawn leaf by leaf in
    path order; empty blocks (zamba2's shared positions) stay ``{}``."""
    if isinstance(spec, RP):
        return (rng.standard_normal(spec.shape) * scale).astype(np.float32)
    return {k: _np_tree(spec[k], rng, scale) for k in sorted(spec)}


def _models(arch, dt, seed=0):
    """The reference and port configs and one set of weights in both."""
    rc, tc = rcfgs.SMOKE[arch], tcfgs.SMOKE[arch]
    if dt == "f32":
        rc, tc = _f32(rc), _f32(tc)
    rp = _np_tree(rmodel.model_spec(rc), np.random.default_rng(seed))
    return rc, tc, jax.tree.map(jnp.asarray, rp), \
        convert.params_from_numpy(tc, rp, device="cpu")


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_ssm_apply_prefill_then_decode_matches_reference(dt):
    """One SSM block: a prefill over two chunks that snapshots the state
    and the pre-conv tail, then two decode steps from the port's cache;
    the given caches are never written."""
    rc, tc, rp, tp = _models("mamba2-130m", dt)
    cdj, cdt, tol = DTYPES[dt]
    p_r = jax.tree.map(lambda a: a[1], rp["segments"]["seg0"]["0"]["ssm"])
    p_t = {k: v[1] for k, v in tp["segments"]["seg0"]["0"]["ssm"].items()}
    rng = np.random.default_rng(1)
    B, S = 2, 32
    hj, ht = _pair(rng.standard_normal((B, S, rc.d_model)).astype(
        np.float32), dt)
    zero = jax.tree.map(np.asarray, rmodel.init_cache(rc, B, S))
    cache_np = zero["seg0"]["0"]
    cj = jax.tree.map(lambda a: jnp.asarray(a[0]), cache_np)
    ct = {k: torch.from_numpy(np.array(v[0], np.float32)).to(cdt)
          for k, v in cache_np.items()}
    out_r, nc_r = rssm.ssm_apply(rc, p_r, hj, cache=cj)
    out_t, nc_t = tssm.ssm_apply(tc, p_t, ht, cache=ct)
    assert out_t.dtype == cdt and nc_t["state"].dtype == cdt
    np.testing.assert_allclose(_np(out_t), _np(out_r), **tol)
    for k in ("conv", "state"):
        np.testing.assert_allclose(_np(nc_t[k]), _np(nc_r[k]), **tol)
        assert not ct[k].any()                    # the given cache unwritten
    # the tail is the PRE-conv input of the last K-1 positions
    d_in, _, _, G, N = tssm.ssm_dims(tc)
    pre = (ht @ p_t["in_proj"].to(cdt))[..., d_in:2 * d_in + 2 * G * N]
    assert torch.equal(nc_t["conv"], pre[:, -(tc.d_conv - 1):].to(cdt))
    cj = {k: jnp.asarray(_np(v), cdj) for k, v in nc_t.items()}
    for step in range(2):
        hj1, ht1 = _pair(rng.standard_normal((B, 1, rc.d_model)).astype(
            np.float32), dt)
        snap = {k: v.clone() for k, v in nc_t.items()}
        out_r, nc_r = rssm.ssm_apply(rc, p_r, hj1, cache=cj)
        out_t, nc_t2 = tssm.ssm_apply(tc, p_t, ht1, cache=nc_t)
        np.testing.assert_allclose(_np(out_t), _np(out_r), **tol)
        for k in ("conv", "state"):
            np.testing.assert_allclose(_np(nc_t2[k]), _np(nc_r[k]), **tol)
            assert torch.equal(nc_t[k], snap[k])  # decoding wrote nothing
        cj = {k: jnp.asarray(_np(v), cdj) for k, v in nc_t2.items()}
        nc_t = nc_t2


# ------------------------------------------------------------------ model
def _tokens(rng, cfg, B, S):
    t = rng.integers(2, cfg.vocab, (B, S)).astype(np.int32)
    return jnp.asarray(t), torch.from_numpy(t)


def test_zamba2_plan_scans_shared_blocks_and_loops_the_tail():
    """zamba2-1.2b's 38 layers: (ssm x5, attn_shared) x 6 stacked, then a
    looped tail of 2 SSM layers; the shared block's positions are empty
    ``{}`` trees and each holds a KV cache of its own."""
    cfg = tcfgs.get("zamba2-1.2b")
    plan = tmodel.build_plan(cfg)
    assert [(s.mode, [d.kind for d in s.pattern], s.repeats)
            for s in plan] == [("scan", ["ssm"] * 5 + ["attn_shared"], 6),
                               ("loop", ["ssm", "ssm"], 1)]
    spec = tmodel.model_spec(cfg)
    assert spec["segments"]["seg0"]["5"] == {} and "shared_attn" in spec
    cache = tmodel.cache_spec(cfg, 2, 40)
    assert cache["seg0"]["5"]["k"].shape == (6, 2, 40, 32 * 64)
    assert cache["seg1"]["1"]["state"].shape == (2, 64, 64, 64)


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_from_numpy_carries_ssm_and_hybrid_caches(arch):
    """The reference's SSM-only (mamba2) and hybrid (zamba2: KV at the
    shared positions, conv/state elsewhere, stacked and looped) caches
    convert, batch and length read from the leaves."""
    rc, tc = rcfgs.SMOKE[arch], tcfgs.SMOKE[arch]
    rng = np.random.default_rng(0)
    cache = jax.tree.map(
        lambda x: jnp.asarray(rng.standard_normal(x.shape), jnp.bfloat16),
        rmodel.init_cache(rc, 3, 24))
    got = convert.cache_from_numpy(tc, jax.tree.map(np.asarray, cache),
                                   device="cpu")
    assert len(_leaves(got)) == len(_leaves(cache))
    for (pa, a), (pb, b) in zip(_leaves(cache), _leaves(got)):
        assert pa == pb and b.dtype == torch.bfloat16
        np.testing.assert_array_equal(np.asarray(a, np.float32),
                                      b.float().numpy())


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_forward_prefill_decode_match_reference(arch, dt):
    """forward, prefill (two chunks) and three decode steps on carried-over
    weights.  Under the f32 policy hidden states and caches agree within
    ``F32`` and every greedy token is equal; in bf16 the hidden states
    agree within a relative L2 of 2e-2, and within ``BF16_MODEL_REL_L2``,
    which the intra-chunk part kept in f32 gives."""
    rc, tc, rp, tp = _models(arch, dt)
    rng = np.random.default_rng(2)
    B, S, T = 2, 32, 40
    tj, tt = _tokens(rng, rc, B, S)
    hr, _, _ = rmodel.forward(rc, rp, tj)
    ht, none = tmodel.forward(tc, tp, tt)
    assert none is None and ht.dtype == tc.policy.compute_dtype
    if dt == "f32":
        np.testing.assert_allclose(_np(ht), _np(hr), **F32)
    else:
        assert _rel_l2(ht, hr) <= 2e-2
        assert _rel_l2(ht, hr) <= BF16_MODEL_REL_L2[arch][0]
    nr, cr = rmodel.prefill(rc, rp, tj, rmodel.init_cache(rc, B, T))
    nt, ct = tmodel.prefill(tc, tp, tt, tmodel.init_cache(tc, B, T, "cpu"))
    assert nt.dtype == torch.int32 and nt.shape == (B,)
    assert [p for p, _ in _leaves(ct)] == [p for p, _ in _leaves(cr)]
    for step in range(3):
        if dt == "f32":
            np.testing.assert_array_equal(nt.numpy(), np.asarray(nr))
            for (_, a), (_, b) in zip(_leaves(cr), _leaves(ct)):
                np.testing.assert_allclose(_np(b), _np(a), **F32)
        nr, cr = rmodel.decode_step(rc, rp, cr,
                                    jnp.asarray(nt.numpy())[:, None],
                                    S + step)
        nt, ct = tmodel.decode_step(tc, tp, ct, nt[:, None], S + step)
    if dt == "f32":
        np.testing.assert_array_equal(nt.numpy(), np.asarray(nr))
    h_r, _, _ = rmodel.forward(rc, rp, jnp.asarray(nt.numpy())[:, None],
                               cache=cr, pos=S + 3)
    h_t, _ = tmodel.forward(tc, tp, nt[:, None], cache=ct, pos=S + 3)
    if dt == "f32":
        np.testing.assert_allclose(_np(h_t), _np(h_r), **F32)
    else:
        assert _rel_l2(h_t, h_r) <= 2e-2
        assert _rel_l2(h_t, h_r) <= BF16_MODEL_REL_L2[arch][1]


def test_cast_params_keeps_ssm_vectors_in_f32():
    """in_proj, conv_w, out_proj and the shared block's matrices go to the
    compute dtype; A_log, D_skip, dt_bias, conv_b and the norm weights
    (``norm_w`` feeds the rmsnorm kernel) stay f32, stacked or not."""
    cfg = tcfgs.SMOKE["zamba2-1.2b"]
    cast = tmodel.cast_params(cfg, tmodel.init_model(
        cfg, torch.Generator().manual_seed(0)))
    for path, t in _leaves(cast):
        name = path.rsplit("/", 1)[-1]
        matrix = name in ("in_proj", "conv_w", "out_proj", "wq", "wk", "wv",
                          "wo", "wg", "wi", "embed", "unembed")
        assert t.dtype == (torch.bfloat16 if matrix else torch.float32), path


# ----------------------------------------------------------------- server
def _cfgs(arch, f32: bool):
    rc, tc = rcfgs.SMOKE[arch], tcfgs.SMOKE[arch]
    return (_f32(rc), _f32(tc)) if f32 else (rc, tc)


@pytest.fixture(scope="module", params=ARCHS)
def served(request):
    """One arch and one set of reference weights, as jax and numpy."""
    rp = r_init_model(rcfgs.SMOKE[request.param], jax.random.PRNGKey(1))
    return request.param, rp, jax.tree.map(np.asarray, rp)


def _waves(seed, n_prompts, schedule, max_new=3, cls=Request):
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(2, 256, 32).astype(np.int32)
               for _ in range(n_prompts)]
    return [[cls(rid=i, prompt=prompts[i % n_prompts], max_new=max_new)
             for i in wave] for wave in schedule]


def _serve_all(srv, waves):
    out = {}
    for wave in waves:
        out.update(srv.serve(wave))
    return out


@pytest.mark.parametrize("f32", [True, False])
def test_serve_matches_reference_server(served, f32):
    """Two groups a wave, 32-token prompts over two chunks, two waves:
    wave 2 rides wave 1's leases.  Under the f32 policy the greedy tokens
    equal the reference's; the lease-cache and fabric counters are equal
    under any policy (the fabric sees only keys)."""
    arch, rp, npp = served
    rc, tc = _cfgs(arch, f32)
    sched = [[0, 1, 2, 3], [4, 5, 6, 7]]
    srv_r = RServer(rc, rp, batch_size=2, max_len=48)
    srv_t = Server(tc, convert.params_from_numpy(tc, npp, "cpu"),
                   batch_size=2, max_len=48, device="cpu")
    out_r = _serve_all(srv_r, _waves(3, 4, sched, cls=RRequest))
    out_t = _serve_all(srv_t, _waves(3, 4, sched))
    assert set(out_t) == set(out_r) == set(range(8))
    if f32:
        for rid in out_r:
            np.testing.assert_array_equal(out_t[rid], out_r[rid])
    assert srv_t.cache_stats == srv_r.cache_stats
    assert srv_t.fabric_stats == srv_r.fabric_stats
    assert srv_t.cache_stats["hits"] >= 1


def test_serve_stream_matches_sequential_serve(served):
    arch, _, npp = served
    _, tc = _cfgs(arch, False)
    make = lambda: Server(tc, convert.params_from_numpy(tc, npp, "cpu"),
                          batch_size=2, max_len=48, device="cpu")
    sched = [[0, 1], [2, 3, 4], [5]]
    out_seq = _serve_all(srv_seq := make(), _waves(4, 2, sched))
    out_str = (srv_str := make()).serve_stream(iter(_waves(4, 2, sched)))
    assert set(out_str) == set(out_seq)
    for rid in out_seq:
        np.testing.assert_array_equal(out_str[rid], out_seq[rid])
    assert srv_str.cache_stats == srv_seq.cache_stats
    assert srv_str.fabric_stats == srv_seq.fabric_stats


def test_prefix_payload_unchanged_by_decoding_from_it(served):
    """A lease hit decodes from the cached ``(cache, first)`` payload —
    the final SSM state, the conv tail and (zamba2) the shared block's KV;
    decoding must leave every tensor of it bit-identical."""
    arch, _, npp = served
    _, tc = _cfgs(arch, False)
    srv = Server(tc, convert.params_from_numpy(tc, npp, "cpu"),
                 batch_size=2, max_len=48, device="cpu")
    posted = []
    put = srv.kv.put_batch
    srv.kv.put_batch = lambda items: (posted.extend(items), put(items))
    waves = _waves(5, 2, [[0, 1], [2, 3], [4, 5]], max_new=5)
    out = srv.serve(waves[0])
    assert len(posted) == 1
    _, (cache, first) = posted[0]
    tensors = [t for _, t in _leaves(cache)] + [first]
    snap = [t.clone() for t in tensors]
    out2 = srv.serve(waves[1])
    out3 = srv.serve(waves[2])
    assert len(posted) == 1 and srv.cache_stats["hits"] == 2
    for before, now in zip(snap, tensors):
        assert torch.equal(before, now)
    assert any(t.any() for p, t in _leaves(cache) if p.endswith("state"))
    for j in (0, 1):
        np.testing.assert_array_equal(out[j], out2[2 + j])
        np.testing.assert_array_equal(out[j], out3[4 + j])


def test_serve_launcher_mamba2_on_cpu(capsys):
    srv, out = tserve.main(["--arch", "mamba2-130m", "--device", "cpu",
                            "--requests", "8", "--batch", "4",
                            "--max-new", "4"])
    assert set(out) == set(range(8))
    assert srv.cache_stats["hits"] >= 1
    assert "lease-cache stats" in capsys.readouterr().out
