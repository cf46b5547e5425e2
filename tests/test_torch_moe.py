"""The port's MoE block (``repro_torch.models.moe``) against the one-device
dispatch of ``repro.models.moe`` on the CPU.

Inputs and weights come from numpy with a seed and are handed to both
packages.  The configs are the smoke deepseek-v2 (top-2 of 8 experts, one
shared expert) and llama4-maverick (top-1, one shared expert), each also
without its shared expert.  Tolerances, with their reasons:

- f32 (rtol = atol = 1e-5): the same f32 arithmetic in another summation
  order, one block deep;
- bf16 (rtol = atol = 2e-2): bf16 keeps 8 significant bits, and a value
  may round differently on the two sides;
- aux (rtol 1e-6): an f32 mean and sum of the same gates.

Routing is held exactly: the forced-drop and forced-tie cases assert the
dropped choices and the experts picked, not only the output.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as rcfgs
from repro.models import moe as rmoe
from repro.models.params import tree_paths as r_tree_paths
from repro_torch import configs as tcfgs
from repro_torch.models import moe as tmoe

TOL = {"f32": dict(rtol=1e-5, atol=1e-5), "bf16": dict(rtol=2e-2, atol=2e-2)}
DT = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16,
                                                    torch.bfloat16)}
ARCHS = ("deepseek-v2-236b", "llama4-maverick-400b-a17b")


def _cfgs(arch, shared=True):
    rc, tc = rcfgs.SMOKE[arch], tcfgs.SMOKE[arch]
    if not shared:
        rc = dataclasses.replace(rc, n_shared_experts=0)
        tc = dataclasses.replace(tc, n_shared_experts=0)
    return rc, tc


def _weights(rc, seed, scale=0.1):
    """The block's weights as numpy f32, nested by the spec's paths."""
    rng = np.random.default_rng(seed)
    tree = {}
    for path, spec in r_tree_paths(rmoe.moe_spec(rc)):
        node = tree
        *head, last = path.strip("/").split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = (rng.standard_normal(spec.shape) * scale).astype(
            np.float32)
    return tree


def _both(tree):
    return (jax.tree.map(jnp.asarray, tree),
            jax.tree.map(torch.from_numpy, tree))


def _run(rc, tc, tree, h, dt):
    jd, td = DT[dt]
    rp, tp = _both(tree)
    out_r, aux_r = rmoe.moe_apply(rc, rp, jnp.asarray(h, jd))
    out_t, aux_t = tmoe.moe_apply(tc, tp, torch.from_numpy(h).to(td))
    assert out_t.dtype == td and out_t.shape == h.shape
    return out_t, aux_t, out_r, aux_r


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(t, np.float32)


def _check(out_t, aux_t, out_r, aux_r, dt):
    np.testing.assert_allclose(_np(out_t), _np(out_r), **TOL[dt])
    np.testing.assert_allclose(float(aux_t), float(aux_r), rtol=1e-6)


def _routing(tc, tp, h):
    """The port's (topi, keep) for h (f32)."""
    x = torch.from_numpy(h).reshape(-1, h.shape[-1])
    _, _, topi = tmoe.route(tc, tp, x)
    _, keep = tmoe.dispatch(tc, topi, tmoe.capacity_for(tc, x.shape[0]))
    return topi, keep


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("shared", [True, False])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_moe_apply_matches_reference(arch, shared, dt):
    """top-k (deepseek's smoke top-2) and top-1 (llama4), with and
    without the shared expert, at a prefill shape: output and aux."""
    rc, tc = _cfgs(arch, shared)
    tree = _weights(rc, 1)
    h = np.random.default_rng(2).standard_normal(
        (2, 24, rc.d_model)).astype(np.float32)
    _check(*_run(rc, tc, tree, h, dt), dt)
    assert tmoe.capacity_for(tc, 48) == rmoe.capacity_for(rc, 48)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_moe_forced_drops_match_reference(arch, dt):
    """A router biased towards expert 3 for every token: the expert takes
    its first C choices in token order and the rest go to the discard
    row, on both sides."""
    rc, tc = _cfgs(arch)
    tree = _weights(rc, 3)
    h = np.abs(np.random.default_rng(4).standard_normal(
        (2, 16, rc.d_model))).astype(np.float32)
    tree["router"][:, 3] += 1.0            # every token's top choice
    _check(*_run(rc, tc, tree, h, dt), dt)
    topi, keep = _routing(tc, _both(tree)[1], h)
    C = tmoe.capacity_for(tc, 32)
    first = topi[:, 0]
    assert bool((first == 3).all())
    # choices are flattened token-major: token t's first choice is entry
    # t * k, so expert 3 keeps tokens 0..C-1 and drops the rest
    k = tc.top_k
    assert keep.reshape(-1, k)[:, 0].tolist() == [t < C for t in range(32)]
    assert int((~keep).sum()) >= 32 - C


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_moe_forced_ties_pick_the_lower_index(arch, dt):
    """Router columns 2, 5 and 6 equal and dominant: every gate ties
    across them, and the lower indices win, as ``jax.lax.top_k`` orders
    them."""
    rc, tc = _cfgs(arch)
    tree = _weights(rc, 5)
    h = np.abs(np.random.default_rng(6).standard_normal(
        (1, 8, rc.d_model))).astype(np.float32)
    col = np.abs(np.random.default_rng(7).standard_normal(rc.d_model))
    for e in (6, 2, 5):
        tree["router"][:, e] = col + 0.5
    _check(*_run(rc, tc, tree, h, dt), dt)
    topi, _ = _routing(tc, _both(tree)[1], h)
    assert topi.tolist() == [[2, 5][:tc.top_k]] * 8


def test_top_k_orders_ties_as_jax():
    rng = np.random.default_rng(8)
    g = rng.integers(0, 4, (64, 160)).astype(np.float32) / 4
    want_v, want_i = jax.lax.top_k(jnp.asarray(g), 6)
    got_v, got_i = tmoe.top_k(torch.from_numpy(g), 6)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_moe_decode_sized_batch_matches_reference(arch, dt):
    """A decode step's T = B tokens: capacity 8, output and aux equal."""
    rc, tc = _cfgs(arch)
    tree = _weights(rc, 9)
    h = np.random.default_rng(10).standard_normal(
        (3, 1, rc.d_model)).astype(np.float32)
    assert tmoe.capacity_for(tc, 3) == 8
    _check(*_run(rc, tc, tree, h, dt), dt)


def test_moe_aux_only_when_asked():
    rc, tc = _cfgs(ARCHS[0])
    _, tp = _both(_weights(rc, 11))
    h = torch.from_numpy(np.random.default_rng(12).standard_normal(
        (2, 4, rc.d_model)).astype(np.float32))
    out, aux = tmoe.moe_apply(tc, tp, h)
    out2, none = tmoe.moe_apply(tc, tp, h, want_aux=False)
    assert none is None and aux.dtype == torch.float32 and aux.dim() == 0
    assert torch.equal(out, out2)
