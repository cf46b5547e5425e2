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
import contextlib
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
from repro_torch.kernels.rmsnorm import ELEMENT_PATH
from repro_torch.kernels.rmsnorm import plan as rmsnorm_plan
from repro_torch.kernels.rmsnorm import rmsnorm as cuda_rmsnorm
from repro_torch.models import attention as tattn
from repro_torch.models import convert, layers, training
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


@pytest.mark.parametrize("D", [768, 960, 1536, 2048, 4096])
@pytest.mark.parametrize("R", [8, 4096])
@pytest.mark.parametrize("vec", [4, 8])
def test_rmsnorm_plan_holds_each_row_in_registers(R, D, vec):
    """The rmsnorm kernel's shape at the serving path's rows (on an H100's
    132 SMs): the least vectors a thread that hold the row; prefill packs
    256 / tpr rows a block with the least tpr that needs at most four
    vectors a thread; decode spreads one row over 128-256 threads with
    one or two vectors each (four only for a row of 1024 f32 vectors)."""
    nvec = D // vec
    vpt, tpr, rows = rmsnorm_plan(R, D, vec, 132)
    assert vpt in (1, 2, 4) and tpr in (32, 128, 256)
    assert vpt * tpr >= nvec and (vpt == 1 or (vpt // 2) * tpr < nvec)
    if R == 8:
        assert rows == 1 and tpr in (128, 256)
        assert vpt <= 2 or nvec > 512
    else:
        assert rows * tpr == 256
        assert 4 * tpr >= nvec > 4 * {32: 0, 128: 32, 256: 128}[tpr]


@pytest.mark.parametrize("R,D,vec,want", [
    (5, 100, 8, ELEMENT_PATH), (5, 100, 4, (1, 32, 1)), (7, 80, 8, (1, 32, 1)),
    (3, 8, 8, (1, 32, 1)), (2, 8200 * 8, 8, ELEMENT_PATH),
    (1024, 960, 8, (1, 128, 1))])
def test_rmsnorm_plan_odd_rows(R, D, vec, want):
    """A D that does not fill whole vectors, or a row over 1024 vectors,
    takes the element path; a row of at most 32 vectors one warp; rows
    that would fill fewer blocks than SMs one row a block."""
    assert rmsnorm_plan(R, D, vec, 132) == want


_FLASH = [(1, 128, 4, 4, 64), (2, 64, 6, 2, 16), (1, 128, 4, 2, 80),
          (1, 128, 4, 2, 256)]


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
    (1, 128, 4, 2, 80, 77),
    # D = 256 (gemma3-4b decodes with 2 query heads a kv head; 1 and 7
    # as the CUDA kernel's other head groups)
    (1, 128, 8, 4, 256, 77), (1, 96, 2, 2, 256, 77), (1, 96, 14, 2, 256, 77)])
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
    """A decode takes one query token and no causal mask; a window there
    masks nothing, as in the reference (ROADMAP Queue 3 R1)."""
    q = torch.zeros(1, 2, 4, 16)
    k = torch.zeros(1, 8, 2, 16)
    with pytest.raises(ValueError, match="one query token"):
        layers.attention(q, k, k, causal=False, kv_len=4)
    with pytest.raises(ValueError, match="causal"):
        layers.attention(q[:, :1], k, k, causal=True, kv_len=4)
    rng = np.random.default_rng(0)
    q1, kk, vv = (torch.from_numpy(_normal(rng, s)) for s in
                  ((1, 1, 4, 16), (1, 8, 2, 16), (1, 8, 2, 16)))
    np.testing.assert_array_equal(
        _np(layers.attention(q1, kk, vv, causal=False, window=4, kv_len=7)),
        _np(layers.attention(q1, kk, vv, causal=False, kv_len=7)))


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


@pytest.mark.parametrize("arch", ["smollm-360m", "qwen2.5-14b",
                                  "mamba2-130m", "zamba2-1.2b", "gemma3-4b",
                                  "hubert-xlarge", "llava-next-34b",
                                  "llama4-maverick-400b-a17b",
                                  "deepseek-v2-236b"])
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
    """The reference and port configs and one set of weights in both.
    ``dt`` "f32": the f32 policy; "bf16": the smoke configs' (f32 params,
    bf16 compute); "bf16-params": the full config's policy (deepseek-v2
    and llama4-maverick keep their params in bf16, and both packages get
    the bf16-rounded weights)."""
    rc, tc = rcfgs.SMOKE[arch], tcfgs.SMOKE[arch]
    if dt == "f32":
        rc, tc = _f32(rc), _f32(tc)
    if dt == "bf16-params":
        rc = dataclasses.replace(rc, policy=rcfgs.ARCHS[arch].policy)
        tc = dataclasses.replace(tc, policy=tcfgs.ARCHS[arch].policy)
    rng = np.random.default_rng(seed)
    rp = {}
    for path, spec in r_tree_paths(rmodel.model_spec(rc)):
        a = (rng.standard_normal(spec.shape) * 0.1).astype(np.float32)
        node = rp
        *head, last = path.strip("/").split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = a
    jd = jnp.bfloat16 if dt == "bf16-params" else jnp.float32
    return rc, tc, jax.tree.map(lambda a: jnp.asarray(a, jd), rp), \
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


@pytest.mark.parametrize("arch", ["smollm-360m", "qwen2.5-14b",
                                  "llama4-maverick-400b-a17b",
                                  "deepseek-v2-236b"])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_forward_prefill_decode_match_reference(arch, dt):
    """forward, prefill and three decode steps on carried-over weights.
    Under the f32 policy hidden states agree within ``F32`` and every
    greedy token is equal; in bf16 the hidden states agree within a
    relative L2 of 2e-2 (greedy ids may split on near-ties there)."""
    _forward_prefill_decode(arch, dt)


_MOE = ["llama4-maverick-400b-a17b", "deepseek-v2-236b"]


@pytest.mark.parametrize("arch", _MOE)
def test_moe_models_under_bf16_params_match_reference(arch):
    """The smoke deepseek-v2 and llama4-maverick under their configs' own
    policy, bf16 params (their 1-D norm weights too, which the port
    widens to f32 before the rmsnorm kernel): forward, prefill and decode
    steps within a relative L2 of 2e-2 of the reference's."""
    _, tc, _, tp = _models(arch, "bf16-params")
    assert tp["ln_f"].dtype == tmodel.cast_params(tc, tp)["ln_f"].dtype \
        == torch.bfloat16
    _forward_prefill_decode(arch, "bf16-params")


@pytest.mark.parametrize("arch", _MOE)
@pytest.mark.parametrize("dt", ["f32", "bf16", "bf16-params"])
def test_moe_loss_fn_matches_reference_with_aux(arch, dt):
    """``loss_fn`` is ``ce + 0.01 * aux`` with aux the MoE layers' summed
    load-balance losses (not 0): loss, ce and aux against the
    reference's, within rtol 1e-4 under the f32 policy and a relative
    2e-2 in bf16; under the f32 policy the gradient of every leaf too
    (the stacked MoE layers checkpointed, their aux returned through the
    checkpoint), within 1e-4 of its largest magnitude."""
    rc, tc, rp, tp = _models(arch, dt, seed=4)
    tj, tt = _tokens(np.random.default_rng(5), rc, 2, 32)
    (loss_r, met_r), grads_r = jax.value_and_grad(
        lambda p: rmodel.loss_fn(rc, p, {"tokens": tj}), has_aux=True)(rp)
    loss_t, met_t, grads_t = training.loss_and_grads(tc, tp,
                                                     {"tokens": tt})
    met_t = {k: v.detach() for k, v in met_t.items()}
    assert float(met_t["aux"]) > 0.5
    np.testing.assert_allclose(
        float(loss_t), float(met_t["ce"]) + 0.01 * float(met_t["aux"]),
        rtol=1e-6)
    for a, b in ((loss_t, loss_r), (met_t["ce"], met_r["ce"]),
                 (met_t["aux"], met_r["aux"])):
        if dt == "f32":
            np.testing.assert_allclose(float(a), float(b), rtol=1e-4)
        else:
            assert abs(float(a) - float(b)) <= 2e-2 * abs(float(b)), (a, b)
    if dt == "f32":
        ra = _leaves(jax.tree.map(np.asarray, grads_r))
        ta = _leaves(grads_t)
        assert [p for p, _ in ra] == [p for p, _ in ta]
        for (pa, g_r), (_, g_t) in zip(ra, ta):
            scale = float(np.abs(g_r).max()) if g_r.size else 0.0
            np.testing.assert_allclose(_np(g_t), g_r, rtol=1e-4,
                                       atol=1e-4 * max(scale, 1e-30),
                                       err_msg=pa)


# a bf16 routing split: the reference's gates at the boundary of its top k
# (its k-th and (k+1)-th) within this relative gap, about one bf16 step
# of a router logit (2^-6 at logits of 2-4)
NEAR_TIE = 2e-2


@contextlib.contextmanager
def _routes():
    """Record each MoE layer's f32 gates [T, E] in both packages, in call
    order (the reference's through ``jax.debug.callback``, which its scan
    and jit keep), beside their own MoE blocks."""
    rec = {"ref": [], "port": []}
    r_apply, t_apply = rmodel.moe_mod.moe_apply, tmodel.moe_mod.moe_apply

    def r_hook(cfg, p, h, *args):
        x = h.reshape(-1, h.shape[-1])
        gates = jax.nn.softmax((x @ p["router"].astype(h.dtype)).astype(
            jnp.float32), axis=-1)
        jax.debug.callback(lambda g: rec["ref"].append(np.asarray(g)), gates)
        return r_apply(cfg, p, h, *args)

    def t_hook(cfg, p, h, **kw):
        gates, _, _ = tmodel.moe_mod.route(cfg, p, h.reshape(-1, h.shape[-1]))
        rec["port"].append(gates.numpy())
        return t_apply(cfg, p, h, **kw)

    rmodel.moe_mod.moe_apply, tmodel.moe_mod.moe_apply = r_hook, t_hook
    try:
        yield rec
    finally:
        rmodel.moe_mod.moe_apply, tmodel.moe_mod.moe_apply = r_apply, t_apply


def _split_tokens(rec, k, n_tokens):
    """The tokens (flat [B*S] indices) whose top-k experts differ between
    the packages in any MoE layer recorded since the last call (the
    records are consumed, after ``jax.effects_barrier`` lets the
    reference's callbacks land); each split must sit at a near-tie of the
    reference's gates (``NEAR_TIE``): a discrete choice that the two
    sides' bf16 roundings upstream (the reference's jnp attention rounds
    P to bf16, the port's does not) may flip."""
    jax.effects_barrier()
    split = np.zeros(n_tokens, bool)
    for g_r, g_t in zip(rec["ref"], rec["port"]):
        order_r = np.argsort(-g_r, axis=-1, kind="stable")
        order_t = np.argsort(-g_t, axis=-1, kind="stable")
        differs = (np.sort(order_r[:, :k], -1)
                   != np.sort(order_t[:, :k], -1)).any(-1)
        srt = -np.sort(-g_r, axis=-1)
        gap = (srt[:, k - 1] - srt[:, k]) / srt[:, k - 1]
        assert (gap[differs] <= NEAR_TIE).all(), gap[differs]
        split |= differs
    assert len(rec["ref"]) == len(rec["port"])
    rec["ref"].clear()
    rec["port"].clear()
    return split


def _forward_prefill_decode(arch, dt):
    """In bf16 a MoE model's tokens may route differently on the two sides
    at a near-tie (``_split_tokens``): such tokens (at most one in eight)
    are left out of the hidden-state comparison, the rest held to the
    relative L2 of 2e-2; under the f32 policy every token is held."""
    rc, tc, rp, tp = _models(arch, dt)
    rng = np.random.default_rng(2)
    B, S, T = 2, 16, 24
    tj, tt = _tokens(rng, rc, B, S)
    moe = bool(rc.n_experts) and dt != "f32"
    with _routes() if moe else contextlib.nullcontext() as rec:

        def close(h_t, h_r):
            if dt == "f32":
                np.testing.assert_allclose(_np(h_t), _np(h_r), **F32)
                return
            a, b = _np(h_t), _np(h_r)
            if moe:
                keep = ~_split_tokens(rec, rc.top_k, a.shape[0] * a.shape[1])
                assert keep.mean() >= 7 / 8, keep
                a, b = (x.reshape(-1, x.shape[-1])[keep] for x in (a, b))
            assert _rel_l2(a, b) <= 2e-2

        hr, _, _ = rmodel.forward(rc, rp, tj)
        ht, none = tmodel.forward(tc, tp, tt)
        assert none is None and ht.dtype == tc.policy.compute_dtype
        close(ht, hr)
        nr, cr = rmodel.prefill(rc, rp, tj, rmodel.init_cache(rc, B, T))
        nt, ct = tmodel.prefill(tc, tp, tt, tmodel.init_cache(tc, B, T,
                                                              "cpu"))
        if moe:
            _split_tokens(rec, rc.top_k, B * S)
        assert nt.dtype == torch.int32 and nt.shape == (B,)
        for step in range(3):
            if dt == "f32":
                np.testing.assert_array_equal(nt.numpy(), np.asarray(nr))
                for (_, a), (_, b) in zip(_leaves(cr), _leaves(ct)):
                    np.testing.assert_allclose(_np(b), _np(a), **F32)
            # both sides decode the port's token so a bf16 near-tie cannot
            # make the streams diverge
            nr, cr = rmodel.decode_step(rc, rp, cr,
                                        jnp.asarray(nt.numpy())[:, None],
                                        S + step)
            nt, ct = tmodel.decode_step(tc, tp, ct, nt[:, None], S + step)
            if moe:
                _split_tokens(rec, rc.top_k, B)
        if dt == "f32":
            np.testing.assert_array_equal(nt.numpy(), np.asarray(nr))
        h_r, _, _ = rmodel.forward(rc, rp, jnp.asarray(nt.numpy())[:, None],
                                   cache=cr, pos=S + 3)
        h_t, _ = tmodel.forward(tc, tp, nt[:, None], cache=ct, pos=S + 3)
        close(h_t, h_r)


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
