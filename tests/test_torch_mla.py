"""The port's MLA block (``repro_torch.models.attention.mla_apply``) and
the plain attention with a v narrower than q and k, against
``repro.models.attention`` and ``repro.models.layers.attention`` on the
CPU.

Inputs and weights come from numpy with a seed and are handed to both
packages.  The config is the smoke deepseek-v2 (q_lora 48, kv_lora 32,
nope 16, rope 8, v 16), also without ``q_lora`` and without weight
absorption.  Tolerances, with their reasons:

- f32 (rtol = atol = 1e-5): the same f32 arithmetic in another summation
  order, one block deep;
- bf16 (rtol = atol = 2e-2): bf16 keeps 8 significant bits; the
  reference's jnp attention also rounds the softmax weights to bf16
  before the PV product, which the port's plain version does not.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as rcfgs
from repro.models import attention as rattn
from repro.models import layers as rlayers
from repro.models import model as rmodel
from repro.models.params import tree_paths as r_tree_paths
from repro_torch import configs as tcfgs
from repro_torch.kernels import ref
from repro_torch.models import attention as tattn
from repro_torch.models import convert
from repro_torch.models import model as tmodel

TOL = {"f32": dict(rtol=1e-5, atol=1e-5), "bf16": dict(rtol=2e-2, atol=2e-2)}
DT = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16,
                                                    torch.bfloat16)}
ARCH = "deepseek-v2-236b"


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(t, np.float32)


def _pair(a, dt):
    jd, td = DT[dt]
    return jnp.asarray(a, jd), torch.from_numpy(a).to(td)


# ------------------------------------------------- attention, Dv < D
@pytest.mark.parametrize("B,S,Hq,Hkv,D,Dv", [
    (2, 40, 4, 4, 24, 16),            # the smoke MLA's widths
    (1, 64, 6, 2, 24, 16),            # GQA
    (1, 32, 2, 2, 192, 128),          # deepseek-v2's widths
])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_attention_plain_with_narrow_v_matches_jnp(B, S, Hq, Hkv, D, Dv,
                                                   causal, dt):
    """``attention_ref`` with v narrower than q and k: [B, S, Hq, Dv],
    the scores scaled by q's D^-0.5, as ``layers.attention``."""
    rng = np.random.default_rng(S + D + Dv)
    (qj, qt), (kj, kt), (vj, vt) = (
        _pair(rng.standard_normal(s).astype(np.float32), dt)
        for s in ((B, S, Hq, D), (B, S, Hkv, D), (B, S, Hkv, Dv)))
    got = ref.attention_ref(qt, kt, vt, causal=causal)
    assert got.shape == (B, S, Hq, Dv) and got.dtype == qt.dtype
    want = rlayers.attention(qj, kj, vj, causal=causal, chunk=S)
    np.testing.assert_allclose(_np(got), _np(want), **TOL[dt])
    # a decode: one query over the first kv_len keys
    got = ref.attention_ref(qt[:, :1], kt, vt, causal=False, kv_len=S - 3)
    want = rlayers.attention(qj[:, :1], kj, vj, causal=False, kv_len=S - 3)
    np.testing.assert_allclose(_np(got), _np(want), **TOL[dt])


# ------------------------------------------------------------ MLA block
def _cfgs(dt, **kw):
    rc, tc = rcfgs.SMOKE[ARCH], tcfgs.SMOKE[ARCH]
    if dt == "f32":
        rc = dataclasses.replace(rc, policy=dataclasses.replace(
            rc.policy, compute_dtype=jnp.float32, cache_dtype=jnp.float32))
        tc = dataclasses.replace(tc, policy=dataclasses.replace(
            tc.policy, compute_dtype=torch.float32,
            cache_dtype=torch.float32))
    return dataclasses.replace(rc, **kw), dataclasses.replace(tc, **kw)


def _weights(rc, seed):
    rng = np.random.default_rng(seed)
    tree = {path.strip("/"): (rng.standard_normal(spec.shape) * 0.2
                              ).astype(np.float32)
            for path, spec in r_tree_paths(rattn.mla_spec(rc))}
    return ({k: jnp.asarray(v) for k, v in tree.items()},
            {k: torch.from_numpy(v) for k, v in tree.items()})


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("absorb", [True, False])
@pytest.mark.parametrize("q_lora", [48, 0])
def test_mla_apply_prefill_and_decode_match_reference(dt, absorb, q_lora):
    """A 12-token prefill into a 20-row ``ckv`` cache, then two decode
    steps over it (weight absorption, deepseek's setting, or the cache
    up-projected to per-head k and v): outputs and caches; the given
    cache is never written."""
    rc, tc = _cfgs(dt, mla_absorb=absorb, q_lora=q_lora)
    jd, td = DT[dt]
    rp, tp = _weights(rc, 1)
    rng = np.random.default_rng(2)
    B, S, T = 2, 12, 20
    hj, ht = _pair(rng.standard_normal((B, S, rc.d_model)).astype(
        np.float32), dt)
    width = rc.kv_lora + rc.rope_head_dim
    cj = {"ckv": jnp.zeros((B, T, width), jd)}
    ct = {"ckv": torch.zeros((B, T, width), dtype=td)}
    out_r, nc_r = rattn.mla_apply(rc, rp, hj, positions=jnp.arange(S),
                                  cache=cj)
    out_t, nc_t = tattn.mla_apply(tc, tp, ht, positions=torch.arange(S),
                                  cache=ct)
    np.testing.assert_allclose(_np(out_t), _np(out_r), **TOL[dt])
    np.testing.assert_allclose(_np(nc_t["ckv"]), _np(nc_r["ckv"]),
                               **TOL[dt])
    assert not ct["ckv"].any()
    cj = {"ckv": jnp.asarray(_np(nc_t["ckv"]), jd)}
    for step in range(2):
        x = rng.standard_normal((B, 1, rc.d_model)).astype(np.float32)
        xj, xt = _pair(x, dt)
        pos = S + step
        out_r, nc_r = rattn.mla_apply(rc, rp, xj,
                                      positions=pos + jnp.arange(1),
                                      cache=cj, pos=pos)
        out_t, nc2 = tattn.mla_apply(tc, tp, xt,
                                     positions=pos + torch.arange(1),
                                     cache=nc_t, pos=pos)
        np.testing.assert_allclose(_np(out_t), _np(out_r), **TOL[dt])
        np.testing.assert_allclose(_np(nc2["ckv"]), _np(nc_r["ckv"]),
                                   **TOL[dt])
        assert not nc_t["ckv"][:, pos].any()        # the given cache
        cj = {"ckv": jnp.asarray(_np(nc2["ckv"]), jd)}
        nc_t = nc2


def test_mla_cache_spec_and_convert():
    """The MLA cache is one ``ckv`` ``[B, max_len, kv_lora + rope]`` a
    layer, stacked like the reference's; ``cache_from_numpy`` reads its
    length from ``ckv`` (not only from ``k``/``v``) and carries the bf16
    values exactly."""
    rc, tc = rcfgs.SMOKE[ARCH], tcfgs.SMOKE[ARCH]
    rng = np.random.default_rng(3)
    cache = jax.tree.map(
        lambda x: jnp.asarray(rng.standard_normal(x.shape), jnp.bfloat16),
        rmodel.init_cache(rc, 2, 24))
    npc = jax.tree.map(np.asarray, cache)
    assert convert._cache_dims(npc) == (2, 24)
    got = convert.cache_from_numpy(tc, npc, device="cpu")
    flat = lambda t, p="": [x for k in sorted(t) for x in (
        flat(t[k], f"{p}/{k}") if isinstance(t[k], dict) else
        [(f"{p}/{k}", t[k])])]
    ra, ta = flat(npc), flat(got)
    assert [p for p, _ in ra] == [p for p, _ in ta]
    assert all(p.endswith("/ckv") for p, _ in ta)
    for (_, a), (_, b) in zip(ra, ta):
        assert b.dtype == torch.bfloat16 and b.shape[-2:] == (
            24, tc.kv_lora + tc.rope_head_dim)
        np.testing.assert_array_equal(np.asarray(a, np.float32),
                                      b.float().numpy())
    zeros = tmodel.init_cache(tc, 2, 24, "cpu")
    assert [(p, tuple(t.shape)) for p, t in flat(zeros)] == \
        [(p, tuple(t.shape)) for p, t in ta]
