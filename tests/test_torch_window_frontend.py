"""Windowed attention (gemma3-4b) and the modality frontends (hubert-xlarge's
audio frames, llava-next-34b's vision patches) in the port against the
reference, on the CPU.

Inputs and weights come from numpy with a seed and are handed to both
packages; weights cross over through ``repro_torch.models.convert``.  The
smoke configs: gemma3 7 layers (five local with window 16, one global,
one local), hubert 3 non-causal layers fed frames of 32, llava 3 layers
with 8 patch embeddings in front of the tokens.  Tolerances, with their
reasons:

- ``F32`` (rtol = atol = 1e-5), the f32 policy: the same f32 arithmetic,
  summed in another order (einsum vs the plain version's softmax, XLA vs
  torch matmuls) over at most 7 layers of width 64;
- bf16, a relative L2 of 2e-2 on hidden states: bf16 keeps 8 significant
  bits, a value may round differently on the two sides, and the
  reference's jnp attention rounds the softmax probabilities to bf16
  before the PV product, which the port's kernels do not;
- gradients as ``tests/test_torch_train.py`` holds them: under the f32
  policy each leaf within rtol 1e-4 and 1e-4 of its largest magnitude
  (a backward sums over every position in another order); in bf16 the
  loss, the whole gradient and every leaf of at least 64 values within a
  relative L2 of 2e-2.

R1 (ROADMAP Queue 3): the reference's windowed decode masks nothing (its
query sits at position 0), so the port's attends to every filled cache
row too, and equals its own unwindowed decode bit for bit.
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
from repro.models.config import Policy as RPolicy
from repro.runtime.server import Request as RRequest
from repro.runtime.server import Server as RServer
from repro_torch import configs as tcfgs
from repro_torch.kernels import ref
from repro_torch.models import attention as tattn
from repro_torch.models import convert, layers, training
from repro_torch.models import model as tmodel
from repro_torch.runtime.server import Request, Server

F32 = dict(rtol=1e-5, atol=1e-5)
BF16_REL_L2 = 2e-2
PER_LEAF_MIN = 64
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().float().cpu().numpy()
    return np.asarray(t, np.float32)


def _rel_l2(got, want) -> float:
    got, want = _np(got).astype(np.float64), _np(want).astype(np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                  1e-30))


def _close(got, want, dt):
    if dt == "f32":
        np.testing.assert_allclose(_np(got), _np(want), **F32)
    else:
        assert _rel_l2(got, want) <= BF16_REL_L2


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += _leaves(tree[k], f"{prefix}/{k}")
        return out
    return [(prefix, tree)]


def _f32(cfg):
    pol = dict(compute_dtype=jnp.float32, cache_dtype=jnp.float32) \
        if isinstance(cfg.policy, RPolicy) else \
        dict(compute_dtype=torch.float32, cache_dtype=torch.float32)
    return dataclasses.replace(cfg, policy=dataclasses.replace(cfg.policy,
                                                               **pol))


def _models(arch, dt, seed=0):
    """Reference and port configs (f32 policy for ``dt == "f32"``) and one
    set of numpy weights in both packages."""
    rc, tc = rcfgs.SMOKE[arch], tcfgs.SMOKE[arch]
    if dt == "f32":
        rc, tc = _f32(rc), _f32(tc)
    rng = np.random.default_rng(seed)
    npp = jax.tree.map(
        lambda x: (rng.standard_normal(x.shape) * 0.1).astype(np.float32),
        rmodel.abstract_model(rc))
    return rc, tc, jax.tree.map(jnp.asarray, npp), \
        convert.params_from_numpy(tc, npp, device="cpu")


def _pair(a, dt):
    jd, td = DTYPES[dt]
    return jnp.asarray(a, jd), torch.from_numpy(a).to(td)


def _normal(rng, shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


# ----------------------------------------------------------- R1: decode
@pytest.mark.parametrize("D", [16, 256])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_windowed_decode_masks_nothing_as_the_reference(D, dt):
    """R1: a windowed decode step past the window (kv_len 33, window 16)
    equals the reference's ``layers.attention`` (its query at position 0,
    so ``q_pos - k_pos >= window`` never holds), equals the port's own
    unwindowed decode bit for bit, and differs from attention over only
    the last 16 rows: the window is not applied, in both packages."""
    rng = np.random.default_rng(D)
    window, kv_len = 16, 33
    (qj, qt), (kj, kt), (vj, vt) = (
        _pair(_normal(rng, shp), dt)
        for shp in ((2, 1, 4, D), (2, 40, 2, D), (2, 40, 2, D)))
    got = layers.attention(qt, kt, vt, causal=False, window=window,
                           kv_len=kv_len)
    want = rlayers.attention(qj, kj, vj, causal=False, window=window,
                             q_offset=0, kv_len=kv_len)
    tol = 1e-5 if dt == "f32" else 2e-2
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)
    np.testing.assert_array_equal(
        _np(got), _np(layers.attention(qt, kt, vt, causal=False,
                                       kv_len=kv_len)))
    last = ref.attention_ref(qt, kt[:, kv_len - window:kv_len],
                             vt[:, kv_len - window:kv_len], causal=False)
    assert float(np.abs(_np(got) - _np(last)).max()) > 0.1


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_gqa_apply_windowed_prefill_and_decode_match_reference(dt):
    """gemma3's local attention block: a prefill of 24 tokens past the
    window of 16 (the mask live) and a decode step at pos 24 (pos + 1 >
    window), against ``repro.models.attention.gqa_apply``."""
    rc, tc, rp, tp = _models("gemma3-4b", dt)
    # the smoke stack has no repeating period: one looped segment
    assert tc.attn_window(0) == 16 and tmodel.build_plan(tc)[0].mode == "loop"
    p_r = rp["segments"]["seg0"]["0"]["attn"]
    p_t = tp["segments"]["seg0"]["0"]["attn"]
    rng = np.random.default_rng(1)
    B, S, T = 2, 24, 32
    hj, ht = _pair(_normal(rng, (B, S, rc.d_model)), dt)
    cj = {k: jnp.zeros((B, T, rc.n_kv_heads * rc.d_head), DTYPES[dt][0])
          for k in ("k", "v")}
    ct = {k: torch.zeros((B, T, tc.n_kv_heads * tc.d_head),
                         dtype=DTYPES[dt][1]) for k in ("k", "v")}
    out_r, nc_r = rattn.gqa_apply(rc, p_r, hj, positions=jnp.arange(S),
                                  cache=cj, window=16)
    out_t, nc_t = tattn.gqa_apply(tc, p_t, ht, positions=torch.arange(S),
                                  cache=ct, window=16)
    _close(out_t, out_r, dt)
    hj1, ht1 = _pair(_normal(rng, (B, 1, rc.d_model)), dt)
    cj = {k: jnp.asarray(_np(v), DTYPES[dt][0]) for k, v in nc_t.items()}
    out_r, _ = rattn.gqa_apply(rc, p_r, hj1, positions=S + jnp.arange(1),
                               cache=cj, pos=S, window=16)
    out_t, _ = tattn.gqa_apply(tc, p_t, ht1, positions=S + torch.arange(1),
                               cache=nc_t, pos=S, window=16)
    _close(out_t, out_r, dt)


# ------------------------------------------------------------- gemma3
@pytest.mark.parametrize("table,want", [
    # 34 layers: five local and a global one, stacked five times, then a
    # looped tail of four local layers
    ("ARCHS", [("scan", [1024] * 5 + [0], 5), ("loop", [1024] * 4, 1)]),
    # 7 layers have no repeating period: one looped segment
    ("SMOKE", [("loop", [16] * 5 + [0, 16], 1)])])
def test_gemma3_plan_is_the_references(table, want):
    """gemma3's windows by layer in the port's plan and the reference's."""
    summary = lambda plan: [(s.mode, [d.window for d in s.pattern],
                             s.repeats) for s in plan]
    assert summary(tmodel.build_plan(getattr(tcfgs, table)["gemma3-4b"])) \
        == want
    assert summary(rmodel.build_plan(getattr(rcfgs, table)["gemma3-4b"])) \
        == want


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_gemma3_forward_prefill_decode_match_reference(dt):
    """The smoke gemma3 (7 layers, window 16): ``forward``, a prefill of
    64-token prompts (the reference's attention takes them in q chunks
    of 32) and 12 decode steps past the window.  Under the f32 policy the
    hidden states and caches within ``F32`` and every greedy token equal;
    in bf16 the hidden states within a relative L2 of 2e-2 (both sides
    decode the port's tokens, so a near-tie cannot split the streams)."""
    rc, tc, rp, tp = _models("gemma3-4b", dt)
    rng = np.random.default_rng(2)
    B, S, T, steps = 2, 64, 80, 12
    tok = rng.integers(2, rc.vocab, (B, S)).astype(np.int32)
    hr, _, _ = rmodel.forward(rc, rp, jnp.asarray(tok))
    ht, _ = tmodel.forward(tc, tp, torch.from_numpy(tok))
    _close(ht, hr, dt)
    nr, cr = rmodel.prefill(rc, rp, jnp.asarray(tok),
                            rmodel.init_cache(rc, B, T))
    nt, ct = tmodel.prefill(tc, tp, torch.from_numpy(tok),
                            tmodel.init_cache(tc, B, T, "cpu"))
    for step in range(steps):
        if dt == "f32":
            np.testing.assert_array_equal(nt.numpy(), np.asarray(nr))
        ids = nt.numpy()[:, None]
        h_r, cr, _ = rmodel.forward(rc, rp, jnp.asarray(ids), cache=cr,
                                    pos=S + step)
        h_t, ct = tmodel.forward(tc, tp, torch.from_numpy(ids), cache=ct,
                                 pos=S + step)
        _close(h_t, h_r, dt)
        W = tmodel.unembed_matrix(tc, tp).to(h_t.dtype)
        nt = torch.argmax((h_t[:, -1:] @ W).float(), -1)[:, 0].to(
            torch.int32)
        nr = jnp.argmax((h_r[:, -1:] @ rmodel.unembed_matrix(rc, rp).astype(
            h_r.dtype)).astype(jnp.float32), -1)[:, 0]
    # the reference's cache carried across (keys and shapes checked)
    for (pa, a), (pb, b) in zip(_leaves(convert.cache_from_numpy(
            tc, jax.tree.map(np.asarray, cr), device="cpu")), _leaves(ct)):
        assert pa == pb
        _close(b, a, dt)


def test_gemma3_server_matches_reference_f32():
    """``Server`` on the smoke gemma3 under the f32 policy in both
    packages: 24-token prompts (past the window), 12 new tokens, three
    waves whose groups repeat: equal tokens, lease-cache and fabric
    counters, and the later waves served from leases."""
    rc, tc, rp, tp = _models("gemma3-4b", "f32", seed=3)
    rng = np.random.default_rng(4)
    prompts = [rng.integers(2, 256, 24).astype(np.int32) for _ in range(3)]
    sched = [[0, 1, 2], [3, 4, 5], [6, 7, 8]]
    waves = lambda cls: [[cls(rid=i, prompt=prompts[i % 3], max_new=12)
                          for i in w] for w in sched]
    srv_r = RServer(rc, rp, batch_size=2, max_len=48)
    srv_t = Server(tc, tp, batch_size=2, max_len=48, device="cpu")
    out_r, out_t = {}, {}
    for wr, wt in zip(waves(RRequest), waves(Request)):
        out_r.update(srv_r.serve(wr))
        out_t.update(srv_t.serve(wt))
    assert set(out_t) == set(out_r) == set(range(9))
    for rid in out_r:
        np.testing.assert_array_equal(out_t[rid], np.asarray(out_r[rid]))
    assert srv_t.cache_stats == srv_r.cache_stats
    assert srv_t.fabric_stats == srv_r.fabric_stats
    assert srv_t.cache_stats["hits"] >= 1


# ----------------------------------------------------------- frontends
def _frames(rng, cfg, B, S):
    return _normal(rng, (B, S, cfg.d_frontend))


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_hubert_forward_and_prefill_match_reference(dt):
    """The smoke hubert (3 non-causal layers): ``forward`` and ``prefill``
    on frames projected by ``frontend`` (no token embedding), hidden
    state, first ids (f32) and the filled cache."""
    rc, tc, rp, tp = _models("hubert-xlarge", dt)
    assert not tc.causal and "frontend" in tp
    fr = _frames(np.random.default_rng(5), rc, 2, 32)
    hr, _, _ = rmodel.forward(rc, rp, None, frames=jnp.asarray(fr))
    ht, _ = tmodel.forward(tc, tp, None, frames=torch.from_numpy(fr))
    assert ht.shape == (2, 32, tc.d_model)
    _close(ht, hr, dt)
    nr, cr = rmodel.prefill(rc, rp, None, rmodel.init_cache(rc, 2, 40),
                            frames=jnp.asarray(fr))
    nt, ct = tmodel.prefill(tc, tp, None, tmodel.init_cache(tc, 2, 40, "cpu"),
                            frames=torch.from_numpy(fr))
    if dt == "f32":
        np.testing.assert_array_equal(nt.numpy(), np.asarray(nr))
    # the reference's cache carried across (keys and shapes checked)
    for (pa, a), (pb, b) in zip(_leaves(convert.cache_from_numpy(
            tc, jax.tree.map(np.asarray, cr), device="cpu")), _leaves(ct)):
        assert pa == pb
        _close(b, a, dt)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_llava_prefill_and_decode_match_reference(dt):
    """The smoke llava (3 layers): ``prefill`` with 8 patch embeddings in
    place of the first 8 token embeddings, then 3 decode steps on
    tokens: ids (f32), caches and the last hidden state."""
    rc, tc, rp, tp = _models("llava-next-34b", dt)
    rng = np.random.default_rng(6)
    B, S, T = 2, 32, 40
    tok = rng.integers(2, rc.vocab, (B, S)).astype(np.int32)
    pt = _normal(rng, (B, rc.n_patch_tokens, rc.d_model))
    hr, _, _ = rmodel.forward(rc, rp, jnp.asarray(tok),
                              patches=jnp.asarray(pt))
    ht, _ = tmodel.forward(tc, tp, torch.from_numpy(tok),
                           patches=torch.from_numpy(pt))
    _close(ht, hr, dt)
    nr, cr = rmodel.prefill(rc, rp, jnp.asarray(tok),
                            rmodel.init_cache(rc, B, T),
                            patches=jnp.asarray(pt))
    nt, ct = tmodel.prefill(tc, tp, torch.from_numpy(tok),
                            tmodel.init_cache(tc, B, T, "cpu"),
                            patches=torch.from_numpy(pt))
    for step in range(3):
        if dt == "f32":
            np.testing.assert_array_equal(nt.numpy(), np.asarray(nr))
        nr, cr = rmodel.decode_step(rc, rp, cr,
                                    jnp.asarray(nt.numpy())[:, None],
                                    S + step)
        nt, ct = tmodel.decode_step(tc, tp, ct, nt[:, None], S + step)
    # the reference's cache carried across (keys and shapes checked)
    for (pa, a), (pb, b) in zip(_leaves(convert.cache_from_numpy(
            tc, jax.tree.map(np.asarray, cr), device="cpu")), _leaves(ct)):
        assert pa == pb
        _close(b, a, dt)


def _frontend_batch(arch, rc, rng, B=2, S=32):
    """Numpy batches: hubert's frames with labels and a mask (the
    encoder's loss), llava's tokens with patches (next-token loss)."""
    if arch == "hubert-xlarge":
        mask = (rng.random((B, S)) < 0.7).astype(np.float32)
        return {"frames": _frames(rng, rc, B, S),
                "labels": rng.integers(0, rc.vocab, (B, S)).astype(np.int32),
                "mask": mask}
    return {"tokens": rng.integers(2, rc.vocab, (B, S)).astype(np.int32),
            "patches": _normal(rng, (B, rc.n_patch_tokens, rc.d_model))}


@pytest.mark.parametrize("arch", ["hubert-xlarge", "llava-next-34b"])
@pytest.mark.parametrize("policy", ["f32", "bf16"])
def test_frontend_loss_fn_value_and_grads_match_reference(arch, policy):
    """``loss_fn`` on a frontend batch and its gradient on every leaf
    (hubert's unused token embedding gets zeros in both) against
    ``jax.value_and_grad(repro.models.model.loss_fn)``."""
    rc, tc, rp, tp = _models(arch, policy, seed=7)
    batch = _frontend_batch(arch, rc, np.random.default_rng(8))
    (rloss, _), rgrads = jax.value_and_grad(
        lambda p: rmodel.loss_fn(rc, p, {k: jnp.asarray(v)
                                         for k, v in batch.items()}),
        has_aux=True)(rp)
    loss, met, grads = training.loss_and_grads(
        tc, tp, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert float(met["aux"]) == 0.0
    ra, ta = _leaves(jax.tree.map(np.asarray, rgrads)), _leaves(grads)
    assert [p for p, _ in ra] == [p for p, _ in ta]
    if policy == "f32":
        np.testing.assert_allclose(float(loss), float(rloss), rtol=1e-5)
        for (pa, a), (_, b) in zip(ra, ta):
            scale = float(np.abs(a).max()) if a.size else 0.0
            np.testing.assert_allclose(_np(b), a, rtol=1e-4,
                                       atol=1e-4 * max(scale, 1e-30),
                                       err_msg=pa)
    else:
        assert _rel_l2(loss, rloss) <= BF16_REL_L2
        whole = lambda xs: np.concatenate([_np(x).ravel() for x in xs])
        assert _rel_l2(whole(b for _, b in ta), whole(a for _, a in ra)) \
            <= BF16_REL_L2
        for (pa, a), (_, b) in zip(ra, ta):
            if a.size >= PER_LEAF_MIN and np.abs(a).max() > 0:
                assert _rel_l2(b, a) <= BF16_REL_L2, (pa, _rel_l2(b, a))
    if arch == "hubert-xlarge":
        assert not grads["embed"].any()


def test_encoder_serves_no_decode_step():
    """hubert is encoder-only: the serving launcher refuses it with a
    ValueError before building anything."""
    from repro_torch.launch import serve
    with pytest.raises(ValueError, match="encoder-only"):
        serve.main(["--arch", "hubert-xlarge", "--device", "cpu"])


def test_serve_launcher_runs_gemma3_on_the_cpu(capsys):
    """``launch.serve --arch gemma3-4b --device cpu``: the smoke gemma3
    behind the lease fabric, two waves, the second from leases."""
    from repro_torch.launch import serve
    srv, out = serve.main(["--arch", "gemma3-4b", "--device", "cpu",
                           "--prompt-len", "24", "--max-new", "4"])
    assert len(out) == 8 and all(v.shape == (4,) for v in out.values())
    assert srv.cache_stats["hits"] >= 1
    assert "lease-cache stats" in capsys.readouterr().out
