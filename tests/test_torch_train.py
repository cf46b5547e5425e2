"""The port's training path against the reference on the CPU.

Inputs, data and weights come from numpy with a seed and are handed to
both packages (weights cross over through ``repro_torch.models.convert``).
Tolerances, with their reasons:

- the data pipeline, the checkpoint format, the fabric keys, counters and
  grant log: equal, bit for bit;
- ``F32`` (rtol 1e-4, atol 1e-4 of the leaf's largest magnitude): loss and
  gradients under the f32 policy are the same f32 arithmetic summed in
  another order (XLA vs torch matmuls and reductions, an online vs a full
  softmax); a gradient element near zero is held at the leaf's scale;
- ``BF16_REL_L2`` (2e-2): under the default bf16 policy a value may round
  differently on the two sides, and the reference's jnp attention rounds
  the softmax probabilities to bf16 before the PV product
  (``repro/models/layers.py:73``), which the port's kernels do not;
- ``OPT`` (rtol 1e-6, atol 1e-6 of the leaf's largest magnitude): AdamW
  is the same elementwise f32 math; the global norm sums in another order
  and ``pow``/``cos`` come from two libraries, which moves a result by an
  f32 rounding or two — of its operands, so a parameter that the update
  brings near zero is held at the leaf's scale;
- under a bf16-param, bf16-moment policy the same f32 rounding or two
  can move a result across a bf16 rounding boundary: within one bf16
  step of the reference's, element by element, the step taken at the
  larger of the two results and the element's old value (a moment that
  cancels to near zero is held at its operands' scale, as ``OPT`` is);
- AdamW's in-place update (the Trainer's memory plan) against its
  out-of-place one: equal bit for bit (the same arithmetic per element).

The reference ``Trainer`` runs on a mesh whose axes are ``Auto``: jax
0.9's ``make_mesh`` defaults to ``Explicit`` axes, under which the
reference's embedding gather raises a ``ShardingTypeError``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AxisType

from repro import configs as rcfgs
from repro.checkpoint.manager import CheckpointManager as RCkpt
from repro.coherence.fabric import FabricConfig as RFabricConfig
from repro.coherence.fabric import TSUFabric as RTSUFabric
from repro.coherence.lease_sync import LeaseClock as RLeaseClock
from repro.coherence.lease_sync import LeaseConfig as RLeaseConfig
from repro.coherence.lease_sync import VmappedWorkers as RWorkers
from repro.core import protocol as rprotocol
from repro.data.pipeline import DataConfig as RDataConfig
from repro.data.pipeline import SyntheticLM as RSyntheticLM
from repro.models import layers as rlayers
from repro.models import model as rmodel
from repro.models.config import Policy as RPolicy
from repro.optim import adamw as radamw
from repro.optim import compress as rcompress
from repro.runtime.trainer import Trainer as RTrainer
from repro.runtime.trainer import TrainerConfig as RTrainerConfig
from repro_torch import configs as tcfgs
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.coherence.fabric import FabricConfig, TSUFabric
from repro_torch.coherence.lease_sync import (LeaseClock, LeaseConfig,
                                              VmappedWorkers)
from repro_torch.core import protocol
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.launch import train as train_launcher
from repro_torch.models import convert, layers, training
from repro_torch.models import model as tmodel
from repro_torch.optim import adamw, compress
from repro_torch.runtime.trainer import (Trainer, TrainerConfig, param_keys,
                                        steady_events)

OPT_RTOL = 1e-6
BF16_REL_L2 = 2e-2
PER_LEAF_MIN = 64            # a bf16 gradient leaf held on its own


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().float().cpu().numpy()
    return np.asarray(t, np.float32)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += _leaves(tree[k], f"{prefix}/{k}")
        return out
    return [(prefix, tree)]


def _f32_close(got, want, what=""):
    want = np.asarray(want, np.float32)
    scale = float(np.abs(want).max()) if want.size else 0.0
    np.testing.assert_allclose(_np(got), want, rtol=1e-4,
                               atol=1e-4 * max(scale, 1e-30), err_msg=what)


def _opt_close(got, want, what=""):
    want = np.asarray(want, np.float32)
    scale = float(np.abs(want).max()) if want.size else 0.0
    np.testing.assert_allclose(_np(got), want, rtol=OPT_RTOL,
                               atol=OPT_RTOL * scale, err_msg=what)


def _rel_l2(got, want) -> float:
    got, want = _np(got).astype(np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                  1e-30))


def _f32(cfg):
    """The config under the f32 policy (compute and cache in f32)."""
    pol = dict(compute_dtype=jnp.float32, cache_dtype=jnp.float32) \
        if isinstance(cfg.policy, RPolicy) else \
        dict(compute_dtype=torch.float32, cache_dtype=torch.float32)
    return dataclasses.replace(cfg, policy=dataclasses.replace(cfg.policy,
                                                               **pol))


def _ref_params(rc, seed=0):
    """Seeded weights for config ``rc`` as a numpy tree, the same in every
    process: the port's init (a leaf's values depend on the seed and its
    path) in the reference's layout.  The reference's own init folds
    Python's per-process ``hash`` of the path into its keys."""
    tc = (tcfgs.SMOKE if rc.name.endswith("-smoke") else tcfgs.ARCHS)[
        rc.name.removesuffix("-smoke")]
    tc = dataclasses.replace(tc, policy=dataclasses.replace(
        tc.policy, compute_dtype=torch.float32))
    return jax.tree.map(lambda t: t.numpy(), tmodel.init_model(
        tc, torch.Generator().manual_seed(seed)))


def _auto_mesh():
    return jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)


# -------------------------------------------------------------------- data
@pytest.mark.parametrize("arch,B,S,hosts", [
    ("smollm-360m", 2, 32, 1), ("smollm-360m", 4, 64, 2),
    ("mamba2-130m", 3, 48, 1)])
@pytest.mark.parametrize("table", ["SMOKE", "ARCHS"])
def test_synthetic_batches_bit_equal_reference(arch, B, S, hosts, table):
    """Every host's batch at several steps, at the smoke vocab and the
    full one (smollm's 49152), equals the reference's bit for bit."""
    rc, tc = getattr(rcfgs, table)[arch], getattr(tcfgs, table)[arch]
    for host in range(hosts):
        ref = RSyntheticLM(rc, RDataConfig(global_batch=B, seq_len=S,
                                           host_index=host,
                                           host_count=hosts))
        got = SyntheticLM(tc, DataConfig(global_batch=B, seq_len=S,
                                         host_index=host, host_count=hosts))
        for step in (0, 1, 7, 123):
            a, b = ref.batch(step), got.batch(step)
            assert a.keys() == b.keys()
            assert b["tokens"].dtype == np.int32
            np.testing.assert_array_equal(a["tokens"], b["tokens"])


# -------------------------------------------------------------------- loss
@pytest.mark.parametrize("S,chunk", [(64, 16), (48, 512), (32, 32)])
def test_chunked_xent_matches_reference(S, chunk):
    """Value and gradients (h and the unembed) under f32, with a mask that
    zeroes some positions; the loss chunk by chunk equals the reference's
    scan; a chunk that does not divide S raises."""
    rng = np.random.default_rng(S + chunk)
    B, D, V = 2, 16, 40
    h = rng.standard_normal((B, S, D)).astype(np.float32)
    w = rng.standard_normal((D, V)).astype(np.float32) * 0.3
    lab = rng.integers(0, V, (B, S)).astype(np.int32)
    mask = (rng.random((B, S)) > 0.2).astype(np.float32)
    rv, (rgh, rgw) = jax.value_and_grad(
        lambda a, b: rlayers.chunked_xent(a, b, jnp.asarray(lab),
                                          jnp.asarray(mask), chunk),
        argnums=(0, 1))(jnp.asarray(h), jnp.asarray(w))
    th, tw = (torch.from_numpy(a).requires_grad_() for a in (h, w))
    tv = layers.chunked_xent(th, tw, torch.from_numpy(lab),
                             torch.from_numpy(mask), chunk)
    tv.backward()
    assert tv.dtype == torch.float32 and tv.shape == ()
    _f32_close(tv, rv)
    _f32_close(th.grad, rgh)
    _f32_close(tw.grad, rgw)
    # no mask: every position counts
    tv0 = layers.chunked_xent(th.detach(), tw.detach(),
                              torch.from_numpy(lab), None, chunk)
    _f32_close(tv0, rlayers.chunked_xent(jnp.asarray(h), jnp.asarray(w),
                                         jnp.asarray(lab), None, chunk))
    with pytest.raises(ValueError, match="multiple"):
        layers.chunked_xent(th, tw, torch.from_numpy(lab), None, S - 1
                            if S > 33 else 5)


@pytest.mark.parametrize("arch", ["smollm-360m", "mamba2-130m",
                                  "zamba2-1.2b", "gemma3-4b"])
@pytest.mark.parametrize("policy", ["f32", "bf16"])
def test_loss_fn_value_and_grads_match_reference(arch, policy):
    """``loss_fn`` and its gradient on every parameter against
    ``jax.value_and_grad(repro.models.model.loss_fn)`` on the same weights
    and tokens (f32 master weights cast on use, gradients back on the f32
    leaves; gemma3's smoke window of 16 is live on 32 tokens); the
    metrics are ce and aux = 0.  Under the f32 policy every
    leaf within ``F32``.  Under bf16 the loss and the whole gradient
    within a relative L2 of 2e-2, and so every leaf of at least
    ``PER_LEAF_MIN`` values (worst 0.0156 over seeds 1-3, zamba2's
    conv_b).  The per-head vectors of the SSM blocks (``A_log``,
    ``D_skip``, ``dt_bias``: 8 values in the smoke config) are sums of a
    few cancelling terms whose bf16 error is relative to the terms, not
    to the small sum: between the two bf16 runs they differ by up to
    0.17 (zamba2, seed 3) while the whole gradient stays within 0.0114,
    so they are held by the whole-gradient check."""
    rc, tc = rcfgs.SMOKE[arch], tcfgs.SMOKE[arch]
    if policy == "f32":
        rc, tc = _f32(rc), _f32(tc)
    params = _ref_params(rc, 1)
    tok = np.random.default_rng(2).integers(2, rc.vocab, (2, 32)).astype(
        np.int32)

    def ref_grads(cfg):
        return jax.value_and_grad(
            lambda p: rmodel.loss_fn(cfg, p, {"tokens": jnp.asarray(tok)}),
            has_aux=True)(jax.tree.map(jnp.asarray, params))
    (rloss, rmet), rgrads = ref_grads(rc)
    tp = convert.params_from_numpy(tc, params, device="cpu")
    loss, met, grads = training.loss_and_grads(
        tc, tp, {"tokens": torch.from_numpy(tok)})
    assert float(met["aux"]) == 0.0 and float(rmet["aux"]) == 0.0
    pairs = [(pa, a, b) for (pa, a), (pb, b) in
             zip(_leaves(jax.tree.map(np.asarray, rgrads)), _leaves(grads))
             if pa == pb]
    assert len(pairs) == len(_leaves(grads))
    for pa, a, b in pairs:
        assert b.dtype == torch.float32, pa
    if policy == "f32":
        _f32_close(loss, rloss)
        _f32_close(met["ce"], rmet["ce"])
        for pa, a, b in pairs:
            _f32_close(b, a, pa)
    else:
        assert _rel_l2(loss, rloss) <= BF16_REL_L2
        whole = lambda xs: np.concatenate([_np(x).ravel() for x in xs])
        assert _rel_l2(whole(b for _, _, b in pairs),
                       whole(a for _, a, _ in pairs)) <= BF16_REL_L2
        for pa, a, b in pairs:
            if a.size >= PER_LEAF_MIN:
                assert _rel_l2(b, a) <= BF16_REL_L2, (pa, _rel_l2(b, a))


def test_remat_changes_no_gradient():
    """Checkpointing each layer recomputes the same arithmetic: loss and
    gradients with and without remat are equal bit for bit."""
    tc = tcfgs.SMOKE["smollm-360m"]
    params = convert.params_from_numpy(tc, _ref_params(rcfgs.SMOKE[
        "smollm-360m"], 3), device="cpu")
    tok = {"tokens": torch.from_numpy(np.random.default_rng(4).integers(
        2, tc.vocab, (2, 32)).astype(np.int32))}
    outs = []
    for remat in (True, False):
        cfg = dataclasses.replace(tc, policy=dataclasses.replace(
            tc.policy, remat=remat))
        loss, _, grads = training.loss_and_grads(cfg, params, tok)
        outs.append((loss, [g for _, g in _leaves(grads)]))
    assert torch.equal(outs[0][0], outs[1][0])
    assert all(torch.equal(a, b) for a, b in zip(outs[0][1], outs[1][1]))


def test_remat_with_a_looped_tail_changes_no_gradient():
    """zamba2 at 14 layers is a stacked segment (two repeats of five SSM
    layers and the shared attention block) and a looped tail of two SSM
    layers: each stacked layer's recomputation in the backward runs its
    own segment's layers, not the tail's, so the gradients with and
    without remat are equal bit for bit (at zamba2-1.2b's 38 layers the
    recomputation once ran the tail's two layers and raised)."""
    tc = dataclasses.replace(tcfgs.SMOKE["zamba2-1.2b"], n_layers=14)
    plan = tmodel.build_plan(tc)
    assert [(s.mode, len(s.pattern), s.repeats) for s in plan] == [
        ("scan", 6, 2), ("loop", 2, 1)]
    params = tmodel.init_model(tc, torch.Generator().manual_seed(5))
    tok = {"tokens": torch.from_numpy(np.random.default_rng(6).integers(
        2, tc.vocab, (2, 32)).astype(np.int32))}
    outs = []
    for remat in (True, False):
        cfg = dataclasses.replace(tc, policy=dataclasses.replace(
            tc.policy, remat=remat))
        loss, _, grads = training.loss_and_grads(cfg, params, tok)
        outs.append((loss, [g for _, g in _leaves(grads)]))
    assert torch.equal(outs[0][0], outs[1][0])
    assert all(torch.equal(a, b) for a, b in zip(outs[0][1], outs[1][1]))


# ------------------------------------------------------------------- AdamW
def _ref_state(rc, seed):
    params = _ref_params(rc, seed)
    rng = np.random.default_rng(seed)
    rnd = lambda scale: jax.tree.map(
        lambda x: (rng.standard_normal(x.shape) * scale).astype(np.float32),
        params)
    # nonzero norm weights, so weight decay shows on them
    params = jax.tree.map(lambda x: x + rng.standard_normal(x.shape).astype(
        np.float32) * 0.05, params)
    m = rnd(1e-3)
    v = jax.tree.map(np.abs, rnd(1e-6))
    return params, m, v


@pytest.mark.parametrize("step,gscale", [(0, 1e-3), (4, 10.0), (60, 1e-2)])
def test_apply_updates_matches_reference(step, gscale):
    """One AdamW step on the smoke smollm's tree from the same params,
    moments, step and gradients: params, m, v within ``OPT``, the step
    equal, in warmup (0), clipped (large gradients, 4) and in the cosine
    decay (60)."""
    rc, tc = rcfgs.SMOKE["smollm-360m"], tcfgs.SMOKE["smollm-360m"]
    params, m, v = _ref_state(rc, 5)
    rng = np.random.default_rng(6)
    g = jax.tree.map(lambda x: (rng.standard_normal(x.shape) * gscale)
                     .astype(np.float32), params)
    ocfg = dict(lr=1e-3, warmup_steps=10, total_steps=100)
    rstate = radamw.TrainState(*(jax.tree.map(jnp.asarray, t)
                                 for t in (params, m, v)),
                               jnp.asarray(step, jnp.int32))
    rnew = jax.jit(lambda s, gg: radamw.apply_updates(
        radamw.AdamWConfig(**ocfg), s, gg))(rstate,
                                            jax.tree.map(jnp.asarray, g))
    tstate = convert.train_state_from_numpy(tc, params, m, v, step,
                                            device="cpu")
    tg = convert.params_from_numpy(tc, g, device="cpu")
    tnew = adamw.apply_updates(adamw.AdamWConfig(**ocfg), tstate, tg)
    assert tnew.step.dtype == torch.int32 and int(tnew.step) == step + 1
    for name in ("params", "m", "v"):
        ra = _leaves(jax.tree.map(np.asarray, getattr(rnew, name)))
        ta = _leaves(getattr(tnew, name))
        for (pa, a), (pb, b) in zip(ra, ta):
            assert pa == pb
            _opt_close(b, a, f"{name}{pa}")
    np.testing.assert_allclose(
        float(adamw.global_norm(tg)),
        float(radamw.global_norm(jax.tree.map(jnp.asarray, g))), rtol=1e-6)
    np.testing.assert_allclose(
        float(adamw.schedule(adamw.AdamWConfig(**ocfg), tnew.step)),
        float(radamw.schedule(radamw.AdamWConfig(**ocfg), rnew.step)),
        rtol=1e-6)


def _own_policy(arch):
    """The smoke config under its full config's own policy (the smoke
    configs keep only the moment dtype; deepseek-v2's and llama4's params
    are bf16 too)."""
    return dataclasses.replace(tcfgs.SMOKE[arch],
                               policy=tcfgs.ARCHS[arch].policy)


def _bf16_steps_apart(got, want, old) -> float:
    """The largest distance between two bf16-valued arrays in bf16 steps:
    the spacing of bf16 values (2^(e - 7) for a value in [2^e, 2^(e + 1)))
    at the largest magnitude of the two and the element's ``old``
    value."""
    got, want = _np(got).astype(np.float64), np.asarray(want, np.float64)
    mag = np.maximum(np.maximum(np.abs(got), np.abs(want)),
                     np.abs(_np(old)))
    step = np.exp2(np.floor(np.log2(np.where(mag > 0, mag, 1.0))) - 7)
    return float((np.abs(got - want) / step).max()) if got.size else 0.0


@pytest.mark.parametrize("step,gscale", [(0, 1e-3), (4, 10.0)])
def test_apply_updates_under_bf16_moments_matches_reference(step, gscale):
    """One AdamW step on the smoke deepseek-v2's tree under the full
    config's policy (bf16 params, bf16 moments, bf16 gradients) from the
    same state and gradients: every element of params, m and v within one
    bf16 step of the reference's, the step equal; in warmup and clipped."""
    rc, tc = rcfgs.SMOKE["deepseek-v2-236b"], _own_policy("deepseek-v2-236b")
    assert tc.policy.param_dtype == tc.policy.moment_dtype == torch.bfloat16
    params, m, v = _ref_state(rc, 8)
    rng = np.random.default_rng(9)
    g = jax.tree.map(lambda x: (rng.standard_normal(x.shape) * gscale)
                     .astype(np.float32), params)
    ocfg = dict(lr=1e-3, warmup_steps=10, total_steps=100)
    tstate = convert.train_state_from_numpy(tc, params, m, v, step,
                                            device="cpu")
    tg = convert.params_from_numpy(tc, g, device="cpu")
    # the reference gets the same bf16 values
    bf = lambda tree: jax.tree.map(
        lambda t: jnp.asarray(t.float().numpy(), jnp.bfloat16), tree)
    rstate = radamw.TrainState(bf(tstate.params), bf(tstate.m),
                               bf(tstate.v), jnp.asarray(step, jnp.int32))
    rnew = jax.jit(lambda s, gg: radamw.apply_updates(
        radamw.AdamWConfig(**ocfg), s, gg))(rstate, bf(tg))
    # the update writes the state it is given
    olds = {name: [(pa, t.clone()) for pa, t in _leaves(getattr(tstate,
                                                                 name))]
            for name in ("params", "m", "v")}
    tnew = adamw.apply_updates(adamw.AdamWConfig(**ocfg), tstate, tg)
    assert int(tnew.step) == int(rnew.step) == step + 1
    for name in ("params", "m", "v"):
        ra = _leaves(jax.tree.map(np.asarray, getattr(rnew, name)))
        ta = _leaves(getattr(tnew, name))
        old = olds[name]
        assert [pa for pa, _ in ra] == [pb for pb, _ in ta]
        for (pa, a), (_, b), (_, o) in zip(ra, ta, old):
            assert b.dtype == torch.bfloat16 and str(a.dtype) == "bfloat16"
            assert _bf16_steps_apart(b, a.astype(np.float32), o) <= 1.0, \
                f"{name}{pa}"


def _whole_leaf_update(cfg, state, grads):
    """AdamW as one out-of-place expression a leaf, each result cast back
    to its leaf's dtype: the arithmetic ``adamw.apply_updates`` must
    repeat element for element."""
    step = state.step + 1
    lr = adamw.schedule(cfg, step)
    scale = torch.clamp(cfg.clip_norm / (adamw.global_norm(grads) + 1e-9),
                        max=1.0)
    c1 = 1 - torch.pow(cfg.b1, step.to(torch.float32))
    c2 = 1 - torch.pow(cfg.b2, step.to(torch.float32))

    def upd(p, m, v, g):
        g = g.to(torch.float32) * scale
        m32 = m.to(torch.float32) * cfg.b1 + g * (1 - cfg.b1)
        v32 = v.to(torch.float32) * cfg.b2 + g * g * (1 - cfg.b2)
        p32 = p.to(torch.float32)
        p32 = p32 - lr * (m32 / c1 / (torch.sqrt(v32 / c2) + cfg.eps)
                          + cfg.weight_decay * p32 * float(p.dim() > 1))
        return p32.to(p.dtype), m32.to(m.dtype), v32.to(v.dtype)

    out = [upd(*x) for x in zip(*(adamw.tree_leaves(t) for t in (
        state.params, state.m, state.v, grads)))]
    return [x for leaf in out for x in leaf], step


def _pmv(state):
    """Each leaf's params, m and v, leaf after leaf."""
    return [x for leaf in zip(*(adamw.tree_leaves(t) for t in (
        state.params, state.m, state.v))) for x in leaf]


@pytest.mark.parametrize("arch,chunk", [
    ("smollm-360m", 37),                   # f32 params and moments
    ("deepseek-v2-236b", 37),              # bf16 params and moments
    ("deepseek-v2-236b", adamw.INPLACE_CHUNK),
])
def test_in_place_update_equals_the_whole_leaf_update(arch, chunk,
                                                     monkeypatch):
    """The memory plan: ``apply_updates`` writes each leaf's new params,
    m and v into the state's own tensors ``INPLACE_CHUNK`` (here
    ``chunk``) elements at a time, an f32 leaf by in-place ops; three
    steps of it (warmup, clipped, cosine) equal the whole-leaf
    out-of-place update bit for bit.  smollm under its f32 policy,
    deepseek-v2 under its own bf16 one."""
    monkeypatch.setattr(adamw, "INPLACE_CHUNK", chunk)
    rc, tc = rcfgs.SMOKE[arch], _own_policy(arch)
    params, m, v = _ref_state(rc, 10)
    ocfg = adamw.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=20)
    mine = convert.train_state_from_numpy(tc, params, m, v, 1, device="cpu")
    rng = np.random.default_rng(11)
    for gscale in (1e-3, 10.0, 1e-2):
        g = convert.params_from_numpy(tc, jax.tree.map(
            lambda x: (rng.standard_normal(x.shape) * gscale).astype(
                np.float32), params), device="cpu")
        want, step = _whole_leaf_update(ocfg, mine, g)
        owned = _pmv(mine)
        mine = adamw.apply_updates(ocfg, mine, g)
        got = _pmv(mine)
        assert all(a is b for a, b in zip(owned, got))
        assert len(got) == len(want) == len(owned)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and torch.equal(a, b)
        assert torch.equal(mine.step, step)


def test_a_train_step_frees_its_gradients_without_the_cyclic_gc(
        monkeypatch):
    """Each step's gradients are freed when the step returns, by their
    reference counts: a reference cycle around them (the recursive
    closure ``tree_unflatten`` had) kept them until Python's cyclic
    collector ran, three steps of deepseek-v2's 10.7 GB on the card."""
    import gc
    import weakref
    tc = tcfgs.SMOKE["smollm-360m"]
    tr = Trainer(tc, tcfg=TrainerConfig(total_steps=3),
                 data=SyntheticLM(tc, DataConfig(global_batch=2, seq_len=16)),
                 device="cpu")
    refs = []
    update = adamw.apply_updates

    def spy(cfg, state, grads, **kw):
        refs.append([weakref.ref(t) for t in adamw.tree_leaves(grads)])
        return update(cfg, state, grads, **kw)
    monkeypatch.setattr(adamw, "apply_updates", spy)
    state = tr.init_state(0)
    state, _ = tr.step_fn(state, tr.data.batch(0))   # lazy imports first
    gc.collect()
    gc.disable()
    try:
        for step in range(1, 3):
            state, _ = tr.step_fn(state, tr.data.batch(step))
        alive = [sum(r() is not None for r in rs) for rs in refs[1:]]
    finally:
        gc.enable()
    assert alive == [0, 0], alive


def test_in_place_update_refuses_shared_memory():
    """In place, two leaves on one storage would be updated twice: the
    update raises before it writes anything."""
    w = torch.ones(4, 3)
    st = adamw.init_state({"a": w, "b": w[:2]})
    g = {"a": torch.ones(4, 3), "b": torch.ones(2, 3)}
    with pytest.raises(ValueError, match="share no memory"):
        adamw.apply_updates(adamw.AdamWConfig(), st, g)
    assert torch.equal(w, torch.ones(4, 3))


def test_weight_decay_follows_the_stacked_leaf_rank():
    """With zero gradients and moments the update is -lr wd p exactly
    where the STACKED leaf has two or more dims: the stacked ``[L, D]``
    norm weights ``ln1``/``ln2`` decay, ``ln_f`` does not — as the
    reference."""
    rc, tc = rcfgs.SMOKE["smollm-360m"], tcfgs.SMOKE["smollm-360m"]
    params, _, _ = _ref_state(rc, 7)
    zeros = jax.tree.map(np.zeros_like, params)
    ocfg = adamw.AdamWConfig(lr=1e-2, warmup_steps=1, total_steps=10)
    st = convert.train_state_from_numpy(tc, params, zeros, zeros, 0,
                                        device="cpu")
    old = {k: t.clone() for k, t in st.params["segments"]["seg0"]["0"].items()
           if isinstance(t, torch.Tensor)}
    ln_f = st.params["ln_f"].clone()
    new = adamw.apply_updates(ocfg, st, convert.params_from_numpy(
        tc, zeros, device="cpu"))
    rnew = radamw.apply_updates(
        radamw.AdamWConfig(lr=1e-2, warmup_steps=1, total_steps=10),
        radamw.TrainState(*(jax.tree.map(jnp.asarray, t)
                            for t in (params, zeros, zeros)),
                          jnp.asarray(0, jnp.int32)),
        jax.tree.map(jnp.asarray, zeros))
    seg = new.params["segments"]["seg0"]["0"]
    assert old["ln1"].shape == (tc.n_layers, tc.d_model)
    lr = float(adamw.schedule(ocfg, new.step))
    for name in ("ln1", "ln2"):
        assert not torch.equal(seg[name], old[name])
        np.testing.assert_allclose(seg[name].numpy(),
                                   (old[name] * (1 - lr * 0.1)).numpy(),
                                   rtol=1e-6)
        _opt_close(seg[name],
                   np.asarray(rnew.params["segments"]["seg0"]["0"][name]))
    assert torch.equal(new.params["ln_f"], ln_f)
    np.testing.assert_array_equal(np.asarray(rnew.params["ln_f"]),
                                  ln_f.numpy())


# ------------------------------------------------------------- compression
@pytest.mark.parametrize("axis", [None, 1])
def test_quantize_matches_reference(axis):
    rng = np.random.default_rng(8)
    x = rng.standard_normal((128, 64)).astype(np.float32)
    x[3, 5] = 0.5 * (x.max() / 127)                   # a half-way value
    rq, rs = rcompress.quantize(jnp.asarray(x), axis=axis)
    q, s = compress.quantize(torch.from_numpy(x), axis=axis)
    assert q.dtype == torch.int8 and tuple(q.shape) == x.shape
    assert tuple(s.shape) == tuple(rs.shape)
    np.testing.assert_allclose(s.numpy(), np.asarray(rs), rtol=1e-7)
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    err = np.abs(compress.dequantize(q, s).numpy() - x)
    assert err.max() <= float(np.abs(x).max()) / 127.0 + 1e-6


def test_ef_compress_matches_reference_and_is_unbiased():
    rng = np.random.default_rng(9)
    g = rng.standard_normal(1024).astype(np.float32) * 1e-3
    rerr, terr = jnp.zeros(1024), torch.zeros(1024)
    rtot, ttot = jnp.zeros(1024), torch.zeros(1024)
    for _ in range(50):
        rs, rerr = rcompress.ef_compress(jnp.asarray(g), rerr)
        ts, terr = compress.ef_compress(torch.from_numpy(g), terr)
        np.testing.assert_allclose(ts.numpy(), np.asarray(rs), rtol=1e-6,
                                   atol=1e-12)
        rtot, ttot = rtot + rs, ttot + ts
    np.testing.assert_allclose(ttot.numpy() / 50, g, rtol=0, atol=2e-5)


# -------------------------------------------------------------- checkpoint
def test_checkpoints_cross_between_packages(tmp_path):
    """A checkpoint the reference writes restores in the port, and one the
    port writes restores in the reference, every leaf equal; the port's
    keeps ``keep`` newest and names the latest."""
    rc, tc = rcfgs.SMOKE["smollm-360m"], tcfgs.SMOKE["smollm-360m"]
    params, m, v = _ref_state(rc, 10)
    rstate = radamw.TrainState(*(jax.tree.map(jnp.asarray, t)
                                 for t in (params, m, v)),
                               jnp.asarray(7, jnp.int32))
    rmgr = RCkpt(tmp_path / "ref", keep=2)
    rmgr.save(7, rstate)
    rmgr.wait()
    tmpl = adamw.init_state(tmodel.init_model(
        tc, torch.Generator().manual_seed(0)))
    mgr = CheckpointManager(tmp_path / "ref", keep=2)
    assert mgr.latest_step() == 7
    got = mgr.restore(None, tmpl, device="cpu")
    assert isinstance(got, adamw.TrainState)
    assert got.step.dtype == torch.int32 and int(got.step) == 7
    for name in ("params", "m", "v"):
        for (pa, a), (pb, b) in zip(_leaves(jax.tree.map(
                np.asarray, getattr(rstate, name))), _leaves(getattr(got,
                                                                   name))):
            assert pa == pb
            np.testing.assert_array_equal(b.numpy(), a)

    # the port writes, the reference reads
    mine = CheckpointManager(tmp_path / "port", keep=2)
    for s in (3, 6, 9):
        mine.save(s, got._replace(step=torch.tensor(s, dtype=torch.int32)))
    mine.wait()
    assert mine.latest_step() == 9
    assert sorted(p.name for p in (tmp_path / "port").iterdir()) == [
        "step_00000006", "step_00000009"]
    back = RCkpt(tmp_path / "port").restore(9, rstate)
    assert int(back.step) == 9
    for name in ("params", "m", "v"):
        for (pa, a), (pb, b) in zip(_leaves(getattr(back, name)),
                                    _leaves(getattr(got, name))):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())


# -------------------------------------------------------------- lease sync
@pytest.mark.parametrize("fabric", ["array", "tsu"])
def test_lease_clock_matches_reference_cases(fabric):
    """``test_fabric.py``'s two cases: the first sync grants (1, 4) with
    memts 4 and the second wts 5 (Fig. 5's +1 order); forty syncs at a
    lease of 5000 keep memts <= TS_MAX (the 16-bit reinit) — on the
    array fabric and on the host ``TSUFabric``, equal to the reference."""
    def make(pkg):
        if fabric == "array":
            return RLeaseClock() if pkg == "ref" else LeaseClock(device="cpu")
        return (RLeaseClock(RTSUFabric(RFabricConfig(n_shards=1)))
                if pkg == "ref" else
                LeaseClock(TSUFabric(FabricConfig(n_shards=1))))
    clocks = {pkg: make(pkg) for pkg in ("ref", "port")}
    seen = {}
    for pkg, clock in clocks.items():
        a = clock.on_sync(4)
        b = clock.on_sync(4)
        seen[pkg] = [(int(a.wts), int(a.rts)), int(b.wts), clock.memts]
    assert seen["port"] == seen["ref"]
    assert seen["port"][0] == (1, 4) and seen["port"][1] == 5
    memts = {}
    for pkg in ("ref", "port"):
        clock = make(pkg)
        for _ in range(40):
            clock.on_sync(5000)
        memts[pkg] = clock.memts
    assert memts["port"] == memts["ref"] <= protocol.TS_MAX
    assert protocol.TS_MAX == rprotocol.TS_MAX


def _worker_batches(data, s):
    b = data.batch(s)["tokens"]
    return {"tokens": np.stack([b[0:1], b[1:2]])}


def test_vmapped_workers_w1_is_sync_dp_and_w4_cuts_bytes():
    """Two workers on different rows: at W = 1 they hold equal parameters
    after every step (sync DP); at W = 4 the collective bytes are at least
    3x fewer than at W = 1 and the workers agree after the final sync; the
    clock's memts advanced.  Both equal the reference's workers started
    from the same weights (f32 policy: losses within ``F32``)."""
    rc, tc = _f32(rcfgs.SMOKE["smollm-360m"]), _f32(tcfgs.SMOKE[
        "smollm-360m"])
    data = SyntheticLM(tc, DataConfig(global_batch=2, seq_len=32))
    params = _ref_params(rc, 11)
    rparams = jax.tree.map(jnp.asarray, params)
    ocfg = dict(lr=1e-3, warmup_steps=1, total_steps=20)
    tw = {W: VmappedWorkers(tc, adamw.AdamWConfig(**ocfg),
                            LeaseConfig(wr_lease=W), 2, device="cpu",
                            params=convert.params_from_numpy(tc, params,
                                                             device="cpu"))
          for W in (1, 4)}
    rw = {}
    for W in (1, 4):
        rw[W] = RWorkers(rc, radamw.AdamWConfig(**ocfg),
                         RLeaseConfig(wr_lease=W), 2, jax.random.PRNGKey(0))
        rw[W].state = rw[W].state._replace(params=jax.tree.map(
            lambda x: jnp.broadcast_to(x[None], (2,) + x.shape), rparams))
    for s in range(8):
        batches = _worker_batches(data, s)
        for W in (1, 4):
            _f32_close(tw[W].step(batches), rw[W].step(batches), f"W={W}")
        for _, p in _leaves(tw[1].state.params):
            assert torch.equal(p[0], p[1])
    assert tw[4].collective_bytes * 3 < tw[1].collective_bytes
    assert tw[4].collective_bytes == rw[4].collective_bytes
    assert tw[1].collective_bytes == rw[1].collective_bytes
    for _, p in _leaves(tw[4].state.params):
        assert torch.equal(p[0], p[1])
    assert tw[4].clock.memts > 0
    assert tw[4].clock.memts == rw[4].clock.memts


# ----------------------------------------------------------------- trainer
@pytest.mark.parametrize("arch", ["smollm-360m", "mamba2-130m",
                                  "zamba2-1.2b", "gemma3-4b"])
def test_param_keys_are_the_reference_trainers(arch):
    """The checkpoint publish's fabric keys: ``"ckpt" + keystr(path)`` in
    the reference's order, at the full and the smoke config; a stacked
    segment's layers share a key, so a dense or SSM model has the same
    keys at every depth (smollm: 11)."""
    def ref_keys(rc):
        return ["ckpt" + jax.tree_util.keystr(kp) for kp, _ in
                jax.tree_util.tree_flatten_with_path(
                    rmodel.abstract_model(rc))[0]]
    want = ref_keys(rcfgs.ARCHS[arch])
    assert param_keys(tcfgs.ARCHS[arch]) == want
    assert param_keys(tcfgs.SMOKE[arch]) == ref_keys(rcfgs.SMOKE[arch])
    # zamba2's looped tail has keys a layer; the smoke gemma3 is one
    # looped segment of 7 layers, the full one a stacked 6 x 5 and a tail
    if arch not in ("zamba2-1.2b", "gemma3-4b"):
        assert param_keys(tcfgs.SMOKE[arch]) == want
    if arch == "smollm-360m":
        assert len(want) == 11 and want[0] == "ckpt['embed']" \
            and want[1] == "ckpt['ln_f']" \
            and want[-1] == "ckpt['segments']['seg0']['0']['mlp']['wo']"


@pytest.mark.parametrize("step,dt,ok", [(5, 3.5, True), (4, 3.1, True),
                                         (3, 9.0, False), (6, 2.9, False)])
def test_steady_events_hold_stragglers_to_the_watchdog(step, dt, ok):
    """A straggler event (ema 1.0, factor 3) is left out when it keeps the
    watchdog's rule and raises when it breaks it; every other event stays,
    in order."""
    events = [{"kind": "param_lease", "step": 2},
              {"kind": "straggler", "step": step, "dt": dt, "ema": 1.0},
              {"kind": "restore", "step": 4}]
    if ok:
        assert steady_events(events, 3.0) == [events[0], events[2]]
    else:
        with pytest.raises(ValueError, match="watchdog's rule"):
            steady_events(events, 3.0)


@pytest.mark.parametrize("arch", ["smollm-360m", "mamba2-130m"])
def test_trainer_fail_and_resume_match_reference(arch, tmp_path):
    """The smoke config's ``Trainer`` with a failure at step 6 and a
    resume from the step-4 checkpoint, beside the reference ``Trainer`` on
    the same config, data and initial state: the same events (the
    restore at 4, the publishes' leases; each wall-clock straggler event
    held to the watchdog's rule instead), fabric counters and grant log
    equal, finite losses within 2e-2 of the reference's (bf16 policy),
    and the resumed steps 4 and 5 repeat the first run's losses bit for
    bit."""
    rc, tc = rcfgs.SMOKE[arch], tcfgs.SMOKE[arch]
    params = _ref_params(rc, 12)
    rtr = RTrainer(rc, _auto_mesh(), tcfg=RTrainerConfig(
        total_steps=8, ckpt_period=4, ckpt_dir=str(tmp_path / "ref")),
        data=RSyntheticLM(rc, RDataConfig(global_batch=2, seq_len=32)))
    with pytest.raises(RuntimeError, match="simulated node failure"):
        rtr.run(state=radamw.init_state(jax.tree.map(jnp.asarray, params)),
                fail_at=6)
    rres = rtr.resume()

    tr = Trainer(tc, tcfg=TrainerConfig(
        total_steps=8, ckpt_period=4, ckpt_dir=str(tmp_path / "port")),
        data=SyntheticLM(tc, DataConfig(global_batch=2, seq_len=32)),
        device="cpu")
    with pytest.raises(RuntimeError, match="simulated node failure"):
        tr.run(state=adamw.init_state(convert.params_from_numpy(
            tc, params, device="cpu")), fail_at=6)
    first = [loss for _, loss in tr.history]
    res = tr.resume()
    assert res["final_step"] == rres["final_step"] == 8
    factor = tr.tcfg.straggler_factor
    assert steady_events(tr.events, factor) == steady_events(rtr.events,
                                                             factor)
    assert {"kind": "restore", "step": 4} in tr.events
    assert res["fabric_stats"] == rres["fabric_stats"]
    assert list(tr.fabric.grant_log) == list(rtr.fabric.grant_log)
    assert len(first) == 6 and res["losses"][:2] == first[4:6]
    assert all(np.isfinite(res["losses"]))
    np.testing.assert_allclose(res["losses"], rres["losses"], rtol=2e-2)


@pytest.mark.parametrize("arch", ["deepseek-v2-236b",
                                  "llama4-maverick-400b-a17b"])
def test_moe_trainer_fail_and_resume_repeats_its_losses(arch, tmp_path):
    """The smoke MoE configs under their full configs' bf16-param,
    bf16-moment policy: the port's ``Trainer`` with a failure at step 6
    and a resume from the step-4 checkpoint repeats the first run's
    losses at steps 4 and 5 bit for bit (the checkpoint carries the bf16
    leaves as their bits), every loss finite, the restore logged.
    Port-only: the reference ``Trainer`` cannot resume these configs on
    jax 0.9 (its checkpoint writes a bf16 leaf as raw 2-byte records,
    which ``jax.device_put`` refuses on restore)."""
    tc = _own_policy(arch)
    assert tc.policy.param_dtype == tc.policy.moment_dtype == torch.bfloat16
    tr = Trainer(tc, tcfg=TrainerConfig(
        total_steps=8, ckpt_period=4, ckpt_dir=str(tmp_path)),
        data=SyntheticLM(tc, DataConfig(global_batch=2, seq_len=32)),
        device="cpu")
    with pytest.raises(RuntimeError, match="simulated node failure"):
        tr.run(fail_at=6)
    first = [loss for _, loss in tr.history]
    res = tr.resume()
    assert res["final_step"] == 8 and len(first) == 6
    assert {"kind": "restore", "step": 4} in tr.events
    assert res["losses"][:2] == first[4:6]
    assert all(np.isfinite(first + res["losses"]))
    assert all(t.dtype == torch.bfloat16 for t in adamw.tree_leaves(
        {"params": res["state"].params, "m": res["state"].m}))


def test_bf16_leaves_round_trip_through_a_checkpoint(tmp_path):
    """A bfloat16 leaf is written as its bits and restored bit for bit
    into a bfloat16 template; f32 leaves are unchanged."""
    rng = np.random.default_rng(3)
    state = {"w": torch.from_numpy(rng.standard_normal((5, 7)).astype(
        np.float32)).to(torch.bfloat16), "b": torch.arange(3.0)}
    mgr = CheckpointManager(tmp_path / "ck")
    mgr.save(2, state)
    back = mgr.restore(2, {"w": torch.zeros(5, 7, dtype=torch.bfloat16),
                           "b": torch.zeros(3)}, device="cpu")
    assert back["w"].dtype == torch.bfloat16
    assert torch.equal(back["w"], state["w"])
    assert torch.equal(back["b"], state["b"])


@pytest.mark.parametrize("w_dtype,b_dtype", [
    (torch.float32, torch.float32),        # the bf16 leaf into f32
    (torch.bfloat16, torch.bfloat16),      # the f32 leaf into bf16
])
def test_bf16_checkpoint_leaves_keep_their_dtype(tmp_path, w_dtype, b_dtype):
    """``meta.json`` records a bfloat16 leaf as bfloat16, not as the int16
    of its bits, and a restore into a template whose dtype disagrees on
    bfloat16 raises rather than return the bits as integers."""
    import json
    state = {"w": torch.ones(5, 7, dtype=torch.bfloat16),
             "b": torch.arange(3.0)}
    mgr = CheckpointManager(tmp_path / "ck")
    mgr.save(2, state)
    mgr.wait()
    meta = json.loads((tmp_path / "ck" / "step_00000002" / "meta.json")
                      .read_text())
    assert meta["leaves"]["/w"] == [[5, 7], "bfloat16"]
    assert meta["leaves"]["/b"] == [[3], "float32"]
    with pytest.raises(TypeError, match="checkpoint's leaf is"):
        mgr.restore(2, {"w": torch.zeros(5, 7, dtype=w_dtype),
                        "b": torch.zeros(3, dtype=b_dtype)}, device="cpu")


def test_trainer_resume_on_a_new_device_logs_the_remesh(tmp_path):
    tc = tcfgs.SMOKE["smollm-360m"]
    tr = Trainer(tc, tcfg=TrainerConfig(total_steps=4, ckpt_period=2,
                                        ckpt_dir=str(tmp_path)),
                 data=SyntheticLM(tc, DataConfig(global_batch=2,
                                                 seq_len=16)),
                 device="cpu")
    with pytest.raises(RuntimeError):
        tr.run(fail_at=3)
    res = tr.resume(device="cpu")
    assert res["final_step"] == 4
    assert {"kind": "elastic_remesh", "devices": 1} in tr.events
    assert res["state"].step.device.type == "cpu"


def test_train_launcher_runs_on_the_cpu(tmp_path, capsys):
    out = train_launcher.main(["--arch", "smollm-360m", "--smoke",
                               "--steps", "3", "--batch", "2", "--seq", "16",
                               "--ckpt-dir", str(tmp_path), "--device",
                               "cpu"])
    assert out["final_step"] == 3 and len(out["losses"]) == 3
    assert "done: steps=3" in capsys.readouterr().out
    assert (tmp_path / "step_00000003").is_dir()


def test_trainer_defaults_to_the_card():
    tc = tcfgs.SMOKE["smollm-360m"]
    if torch.cuda.is_available():
        assert Trainer(tc).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            Trainer(tc)


def test_a_failed_background_write_raises_in_wait(tmp_path):
    """The writer thread's error is not lost: ``wait`` raises it (here the
    checkpoint directory became a file)."""
    mgr = CheckpointManager(tmp_path / "ck")
    (tmp_path / "ck").rmdir()
    (tmp_path / "ck").write_text("not a directory")
    mgr.save(1, {"w": torch.zeros(3)})
    with pytest.raises(OSError):
        mgr.wait()
    mgr.wait()                                   # raised once
