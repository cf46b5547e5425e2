"""The port's float kernels and dense model against the reference.

Inputs and weights come from numpy with a seed and are handed to both
packages; weights cross over through ``repro_torch.models.convert``.  The
reference's Pallas kernels run in interpret mode.  Tolerances, with their
reasons:

- ``F32`` (rtol = atol = 1e-4): the same f32 arithmetic, summed in another
  order (einsum vs online softmax, XLA vs torch matmuls, ``pow``/``exp``
  from two libraries) over at most a few layers;
- ``BF16`` (rtol = atol = 2e-2): bf16 keeps 8 significant bits (relative
  rounding 2^-9), and a value may round differently on the two sides; in
  the model the reference's jnp attention also rounds the softmax
  probabilities to bf16 before the PV product, which the kernels (Pallas
  and the port alike) do not.

The CUDA kernels are held to the plain versions on the card in
``tests/test_torch_cuda.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as rcfgs
from repro.kernels.decode_attention import decode_attention as pallas_decode
from repro.kernels.flash_attention import flash_attention as pallas_flash
from repro.kernels.rmsnorm import rmsnorm as pallas_rmsnorm
from repro.models import attention as rattn
from repro.models import layers as rlayers
from repro.models import model as rmodel
from repro.models.config import Policy as RPolicy
from repro.models.params import tree_paths as r_tree_paths
from repro_torch import configs as tcfgs
from repro_torch.kernels import ops, ref
from repro_torch.kernels.decode_attention import \
    decode_attention as cuda_decode
from repro_torch.kernels.flash_attention import flash_attention as cuda_flash
from repro_torch.kernels.rmsnorm import rmsnorm as cuda_rmsnorm
from repro_torch.models import attention as tattn
from repro_torch.models import convert, layers
from repro_torch.models import model as tmodel
from repro_torch.models.params import (P, leaf_seed, materialize,
                                       tree_paths)

F32 = dict(rtol=1e-4, atol=1e-4)
BF16 = dict(rtol=2e-2, atol=2e-2)
DTYPES = {"f32": (jnp.float32, torch.float32, F32),
          "bf16": (jnp.bfloat16, torch.bfloat16, BF16)}


def _np(t):
    """A port tensor or reference array as f32 numpy."""
    if isinstance(t, torch.Tensor):
        return t.detach().float().cpu().numpy()
    return np.asarray(t, np.float32)


def _pair(a, dt):
    """One numpy f32 array as a reference array and a port tensor of the
    same dtype (both round f32 -> bf16 to nearest even)."""
    jd, td, _ = DTYPES[dt]
    return jnp.asarray(a, jd), torch.from_numpy(a).to(td)


def _normal(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


# ----------------------------------------------------------------- kernels
@pytest.mark.parametrize("R,D", [(64, 256), (128, 960), (32, 80), (7, 80)])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_rmsnorm_plain_matches_pallas_and_jnp(R, D, dt):
    rng = np.random.default_rng(R + D)
    xj, xt = _pair(_normal(rng, (R, D)), dt)
    w = _normal(rng, (D,)) * 0.1
    got = ref.rmsnorm_ref(xt, torch.from_numpy(w))
    assert got.dtype == xt.dtype and got.shape == xt.shape
    tol = DTYPES[dt][2]
    for want in (pallas_rmsnorm(xj, jnp.asarray(w), interpret=True),
                 rlayers.rmsnorm(xj, jnp.asarray(w))):
        np.testing.assert_allclose(_np(got), _np(want), **tol)


_FLASH = [(1, 128, 4, 4, 64), (2, 64, 6, 2, 16), (1, 128, 4, 2, 80)]


@pytest.mark.parametrize("B,S,Hq,Hkv,D", _FLASH)
@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("causal,window", [(True, 0), (False, 0), (True, 32)])
def test_flash_plain_matches_pallas_and_jnp(B, S, Hq, Hkv, D, dt, causal,
                                            window):
    rng = np.random.default_rng(S + Hq + D)
    (qj, qt), (kj, kt), (vj, vt) = (
        _pair(_normal(rng, shp), dt)
        for shp in ((B, S, Hq, D), (B, S, Hkv, D), (B, S, Hkv, D)))
    got = ref.attention_ref(qt, kt, vt, causal=causal, window=window)
    assert got.dtype == qt.dtype and got.shape == qt.shape
    tol = DTYPES[dt][2]
    np.testing.assert_allclose(
        _np(got), _np(pallas_flash(qj, kj, vj, causal=causal, window=window,
                                   interpret=True)), **tol)
    np.testing.assert_allclose(
        _np(got), _np(rlayers.attention(qj, kj, vj, causal=causal,
                                        window=window)), **tol)
    np.testing.assert_array_equal(
        _np(ops.flash_attention(qt, kt, vt, causal=causal, window=window)),
        _np(got))


@pytest.mark.parametrize("B,Sk,Hq,Hkv,D,kv_len", [
    (2, 256, 6, 2, 16, 1), (2, 256, 6, 2, 16, 100), (1, 512, 4, 1, 64, 512),
    (1, 128, 4, 2, 80, 77)])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_decode_plain_matches_pallas_and_jnp(B, Sk, Hq, Hkv, D, kv_len, dt):
    rng = np.random.default_rng(Sk + kv_len + D)
    (qj, qt), (kj, kt), (vj, vt) = (
        _pair(_normal(rng, shp), dt)
        for shp in ((B, 1, Hq, D), (B, Sk, Hkv, D), (B, Sk, Hkv, D)))
    got = ref.attention_ref(qt, kt, vt, causal=False, kv_len=kv_len)
    tol = DTYPES[dt][2]
    np.testing.assert_allclose(
        _np(got), _np(pallas_decode(qj, kj, vj, kv_len, interpret=True)),
        **tol)
    np.testing.assert_allclose(
        _np(got), _np(rlayers.attention(qj, kj, vj, causal=False,
                                        kv_len=kv_len)), **tol)
    # the masked tail weighs exactly nothing: garbage there changes nothing
    kt2, vt2 = kt.clone(), vt.clone()
    kt2[:, kv_len:] = 1e4
    vt2[:, kv_len:] = -1e4
    np.testing.assert_array_equal(
        _np(ops.decode_attention(qt, kt2, vt2, kv_len)), _np(got))


def test_attention_dispatch_rules():
    q = torch.zeros(1, 2, 4, 16)
    k = torch.zeros(1, 8, 2, 16)
    with pytest.raises(ValueError, match="one query token"):
        layers.attention(q, k, k, causal=False, kv_len=4)
    with pytest.raises(ValueError, match="causal"):
        layers.attention(q[:, :1], k, k, causal=True, kv_len=4)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        layers.attention(q[:, :1], k, k, causal=False, window=4, kv_len=4)


def test_float_wrappers_refuse_cpu_tensors():
    """The kernel wrappers launch on CUDA tensors or raise — never a
    silent fallback; the dispatcher sends CPU tensors to the plain
    versions."""
    x = torch.ones(4, 16)
    q, k = torch.ones(1, 4, 2, 16), torch.ones(1, 4, 1, 16)
    with pytest.raises(ValueError, match="CUDA tensor"):
        cuda_rmsnorm(x, torch.zeros(16))
    with pytest.raises(ValueError, match="CUDA tensor"):
        cuda_flash(q, k, k)
    with pytest.raises(ValueError, match="CUDA tensor"):
        cuda_decode(q[:, :1], k, k, 3)
    np.testing.assert_array_equal(_np(ops.rmsnorm(x, torch.zeros(16))),
                                  _np(ref.rmsnorm_ref(x, torch.zeros(16))))


# ----------------------------------------------------------------- configs
def _policy_names(p):
    """A policy's fields with dtypes as names (torch and jnp alike)."""
    def name(x):
        if isinstance(x, torch.dtype):
            return str(x).split(".")[-1]
        return np.dtype(x).name if not isinstance(x, bool) else x
    return {f.name: name(getattr(p, f.name)) for f in dataclasses.fields(p)}


@pytest.mark.parametrize("table", ["ARCHS", "SMOKE"])
def test_configs_match_reference(table):
    rt, tt = getattr(rcfgs, table), getattr(tcfgs, table)
    assert list(rt) == list(tt)
    for name in rt:
        a, b = dataclasses.asdict(rt[name]), dataclasses.asdict(tt[name])
        pa, pb = a.pop("policy"), b.pop("policy")
        assert a == b, name
        assert _policy_names(rt[name].policy) == \
            _policy_names(tt[name].policy), name


# ------------------------------------------------------------------ params
def _f32(cfg):
    """The config under the f32 policy (compute and cache in f32)."""
    pol = dict(compute_dtype=jnp.float32, cache_dtype=jnp.float32) \
        if isinstance(cfg.policy, RPolicy) else \
        dict(compute_dtype=torch.float32, cache_dtype=torch.float32)
    return dataclasses.replace(cfg, policy=type(cfg.policy)(**pol))


@pytest.mark.parametrize("arch", ["smollm-360m", "qwen2.5-14b"])
@pytest.mark.parametrize("table", ["ARCHS", "SMOKE"])
def test_specs_match_reference(arch, table):
    rc, tc = getattr(rcfgs, table)[arch], getattr(tcfgs, table)[arch]
    shapes = lambda paths: [(p, s.shape, s.axes, s.init)
                            for p, s in paths]
    assert shapes(tree_paths(tmodel.model_spec(tc))) == \
        shapes(r_tree_paths(rmodel.model_spec(rc)))
    assert shapes(tree_paths(tmodel.cache_spec(tc, 2, 40))) == \
        shapes(r_tree_paths(rmodel.cache_spec(rc, 2, 40)))
    assert tmodel.build_plan(tc) == [
        tmodel.Segment(s.mode, tuple(tmodel.LayerDesc(d.kind, d.window)
                                     for d in s.pattern), s.repeats)
        for s in rmodel.build_plan(rc)]


def test_materialize_is_seeded_per_leaf():
    cfg = tcfgs.SMOKE["smollm-360m"]
    a = tmodel.init_model(cfg, torch.Generator().manual_seed(3))
    b = tmodel.init_model(cfg, torch.Generator().manual_seed(3))
    c = tmodel.init_model(cfg, torch.Generator().manual_seed(4))
    for (pa, ta), (_, tb), (_, tc) in zip(_leaves(a), _leaves(b),
                                          _leaves(c)):
        assert torch.equal(ta, tb), pa
        if pa.endswith(("ln1", "ln2", "ln_f")):
            assert not ta.any(), pa                   # zeros init
        else:
            assert not torch.equal(ta, tc), pa
            assert abs(float(ta.std()) - 0.02) < 0.005, pa
    # a leaf depends on its path and the seed only: a one-leaf spec at the
    # same path draws the same values
    one = materialize({"embed": P((256, 64), ("vocab", "embed"))},
                      torch.Generator().manual_seed(3))
    assert torch.equal(one["embed"], a["embed"])
    assert leaf_seed(3, "/embed") == leaf_seed(3, "/embed") != \
        leaf_seed(4, "/embed")


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += _leaves(tree[k], f"{prefix}/{k}")
        return out
    return [(prefix, tree)]


@pytest.mark.parametrize("arch", ["mamba2-130m", "zamba2-1.2b",
                                  "llama4-maverick-400b-a17b",
                                  "deepseek-v2-236b", "gemma3-4b",
                                  "llava-next-34b", "hubert-xlarge"])
def test_unported_blocks_raise(arch):
    cfg = tcfgs.SMOKE[arch]
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item 12"):
        tmodel.model_spec(cfg)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tmodel.forward(cfg, {}, torch.zeros(1, 4, dtype=torch.int32))


def test_convert_checks_and_carries_bf16_exactly():
    rc, tc = rcfgs.SMOKE["smollm-360m"], tcfgs.SMOKE["smollm-360m"]
    params = jax.tree.map(np.asarray, rmodel.init_model(rc,
                                                        jax.random.PRNGKey(0)))
    got = convert.params_from_numpy(tc, params, device="cpu")
    for (pa, a), (pb, b) in zip(_leaves(params), _leaves(got)):
        assert pa == pb and b.dtype == torch.float32
        np.testing.assert_array_equal(a, b.numpy())
    bad = dict(params, ln_f=np.zeros(3, np.float32))
    with pytest.raises(ValueError, match="/ln_f"):
        convert.params_from_numpy(tc, bad, device="cpu")
    with pytest.raises(ValueError, match="keys"):
        convert.params_from_numpy(tc, {"embed": params["embed"]},
                                  device="cpu")
    rng = np.random.default_rng(0)
    cache = jax.tree.map(
        lambda x: jnp.asarray(rng.standard_normal(x.shape), jnp.bfloat16),
        rmodel.init_cache(rc, 2, 24))
    tcache = convert.cache_from_numpy(tc, jax.tree.map(np.asarray, cache),
                                      device="cpu")
    for (pa, a), (pb, b) in zip(_leaves(cache), _leaves(tcache)):
        assert pa == pb and b.dtype == torch.bfloat16
        np.testing.assert_array_equal(np.asarray(a, np.float32),
                                      b.float().numpy())


# ------------------------------------------------------------------- model
def _models(arch, dt, seed=0):
    """The reference and port configs and one set of weights in both."""
    rc, tc = rcfgs.SMOKE[arch], tcfgs.SMOKE[arch]
    if dt == "f32":
        rc, tc = _f32(rc), _f32(tc)
    rng = np.random.default_rng(seed)
    rp = {}
    for path, spec in r_tree_paths(rmodel.model_spec(rc)):
        a = (rng.standard_normal(spec.shape) * 0.1).astype(np.float32)
        node = rp
        *head, last = path.strip("/").split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = a
    return rc, tc, jax.tree.map(jnp.asarray, rp), \
        convert.params_from_numpy(tc, rp, device="cpu")


def _tokens(rng, cfg, B, S):
    t = rng.integers(2, cfg.vocab, (B, S)).astype(np.int32)
    return jnp.asarray(t), torch.from_numpy(t)


@pytest.mark.parametrize("arch", ["smollm-360m", "qwen2.5-14b"])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_gqa_apply_matches_reference(arch, dt):
    rc, tc, rp, tp = _models(arch, dt)
    cdj, cdt, tol = DTYPES[dt]
    p_r = rp["segments"]["seg0"]["0"]["attn"]
    p_t = tp["segments"]["seg0"]["0"]["attn"]
    p_r = jax.tree.map(lambda x: x[1], p_r)
    p_t = {k: v[1] for k, v in p_t.items()}
    rng = np.random.default_rng(1)
    B, S, T = 2, 12, 20
    hj, ht = _pair(_normal(rng, (B, S, rc.d_model)), dt)
    cache_np = {k: np.zeros((B, T, rc.n_kv_heads * rc.d_head), np.float32)
                for k in ("k", "v")}
    cj = {k: jnp.asarray(v, cdj) for k, v in cache_np.items()}
    ct = {k: torch.from_numpy(v).to(cdt) for k, v in cache_np.items()}
    out_r, nc_r = rattn.gqa_apply(rc, p_r, hj, positions=jnp.arange(S),
                                  cache=cj)
    out_t, nc_t = tattn.gqa_apply(tc, p_t, ht,
                                  positions=torch.arange(S), cache=ct)
    np.testing.assert_allclose(_np(out_t), _np(out_r), **tol)
    for k in ("k", "v"):
        np.testing.assert_allclose(_np(nc_t[k]), _np(nc_r[k]), **tol)
        assert not ct[k].any()                   # the input cache unwritten
    # one decode step over the filled cache
    hj1, ht1 = _pair(_normal(rng, (B, 1, rc.d_model)), dt)
    cj = {k: jnp.asarray(_np(v), cdj) for k, v in nc_t.items()}
    out_r, nc_r = rattn.gqa_apply(rc, p_r, hj1, positions=S + jnp.arange(1),
                                  cache=cj, pos=S)
    out_t, nc_t2 = tattn.gqa_apply(tc, p_t, ht1,
                                   positions=S + torch.arange(1),
                                   cache=nc_t, pos=S)
    np.testing.assert_allclose(_np(out_t), _np(out_r), **tol)
    for k in ("k", "v"):
        np.testing.assert_allclose(_np(nc_t2[k]), _np(nc_r[k]), **tol)
        assert not nc_t[k][:, S].any()           # the given cache unwritten


def _rel_l2(a, b):
    a, b = _np(a), _np(b)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("arch", ["smollm-360m", "qwen2.5-14b"])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_forward_prefill_decode_match_reference(arch, dt):
    """forward, prefill and three decode steps on carried-over weights.
    Under the f32 policy hidden states agree within ``F32`` and every
    greedy token is equal; in bf16 the hidden states agree within a
    relative L2 of 2e-2 (greedy ids may split on near-ties there)."""
    rc, tc, rp, tp = _models(arch, dt)
    rng = np.random.default_rng(2)
    B, S, T = 2, 16, 24
    tj, tt = _tokens(rng, rc, B, S)
    hr, _, _ = rmodel.forward(rc, rp, tj)
    ht, none = tmodel.forward(tc, tp, tt)
    assert none is None and ht.dtype == tc.policy.compute_dtype
    if dt == "f32":
        np.testing.assert_allclose(_np(ht), _np(hr), **F32)
    else:
        assert _rel_l2(ht, hr) <= 2e-2
    nr, cr = rmodel.prefill(rc, rp, tj, rmodel.init_cache(rc, B, T))
    nt, ct = tmodel.prefill(tc, tp, tt, tmodel.init_cache(tc, B, T, "cpu"))
    assert nt.dtype == torch.int32 and nt.shape == (B,)
    for step in range(3):
        if dt == "f32":
            np.testing.assert_array_equal(nt.numpy(), np.asarray(nr))
            for (_, a), (_, b) in zip(_leaves(cr), _leaves(ct)):
                np.testing.assert_allclose(_np(b), _np(a), **F32)
        # both sides decode the port's token so a bf16 near-tie cannot
        # make the streams diverge
        nr, cr = rmodel.decode_step(rc, rp, cr, jnp.asarray(nt.numpy())[:, None],
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


def test_cast_params_casts_matrices_and_keeps_norms():
    """Weights of two or more dims per layer go to the compute dtype once;
    norm weights stay f32 (the rmsnorm kernel takes an f32 weight), also
    when they are stacked ``[L, D]``."""
    cfg = tcfgs.SMOKE["smollm-360m"]
    params = tmodel.init_model(cfg, torch.Generator().manual_seed(0))
    cast = tmodel.cast_params(cfg, params)
    for (path, a), (_, b) in zip(_leaves(params), _leaves(cast)):
        norm = path.rsplit("/", 1)[-1] in ("ln1", "ln2", "ln_f")
        assert b.dtype == (torch.float32 if norm else torch.bfloat16), path
        assert torch.equal(b, a.to(b.dtype)), path
    assert cast["segments"]["seg0"]["0"]["ln1"].shape == (cfg.n_layers,
                                                          cfg.d_model)
