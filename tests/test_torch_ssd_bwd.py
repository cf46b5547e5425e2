"""The SSD backward kernel's arithmetic and its ``autograd.Function``,
against the JAX reference on the CPU.

``csrc/ssd_chunk_bwd.cu`` runs only on the card.  Here
``ssd_bwd_emulation.emulate_bwd`` repeats its closed-form tiled
arithmetic in torch and is held to ``jax.vjp`` of the reference's
``ssd_chunk_ref`` on the cases and at the tolerances of
``test_torch_backward.py`` (which holds the plain version,
``ref.ssd_chunk_bwd_ref``, the same way).  ``SSDChunkFn``, the
``autograd.Function`` the dispatcher takes on the card, runs here with its
two kernels replaced by the plain forward and the emulated backward:
against autograd of the plain version (rtol = atol 1e-4 in f32, the same
math in another order; 2e-2 in bf16, one rounding of each side), and
inside the mamba2 and zamba2 smoke models' ``loss_fn`` against
``jax.value_and_grad`` of the reference's (``test_torch_train.py``'s f32
rule: rtol 1e-4 and 1e-4 of each leaf's largest magnitude).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as rcfgs
from repro.models import model as rmodel
from repro_torch import configs as tcfgs
from repro_torch.kernels import ops, ref
from repro_torch.kernels import ssd_chunk as ssd_mod
from repro_torch.models import convert, training
from ssd_bwd_emulation import emulate_bwd
from test_torch_backward import SSD_CASES, ssd_check, ssd_inputs, ssd_jax_vjp
from test_torch_train import _f32, _f32_close, _leaves, _ref_params
@pytest.mark.parametrize("case", SSD_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bwd_emulation_matches_jax_vjp(case, dtype):
    args = ssd_inputs(*case, dtype, seed=sum(case[:6]) + 1)
    cum = ref.ssd_chunk_ref(*args[:5])[2]
    got = emulate_bwd(*args[:5], cum, *args[5:])
    ssd_check(got, ssd_jax_vjp(*args), dtype)


def test_bwd_emulation_never_exponentiates_a_masked_pair():
    """At dt scale 1.5 cum falls by ~100 over 64 rows: exp(cum_i - cum_j)
    for j > i overflows to inf, and a pair masked after the exp gives NaN
    in every gradient it touches; the emulation (as the kernel) selects
    the pair to 0 before its exp, and gives finite gradients."""
    args = ssd_inputs(1, 1, 64, 2, 16, 16, True, 1.5, torch.float32, seed=3)
    cum = ref.ssd_chunk_ref(*args[:5])[2]
    assert float(cum[..., -1, :].min()) < -88.0     # exp(88.7) is f32's max
    got = emulate_bwd(*args[:5], cum, *args[5:])
    assert all(torch.isfinite(g).all() for g in got)
    q = cum[0, 0, :, 0]
    assert not torch.isfinite(torch.exp(q[None, :] - q[:, None])).all()


def _ssd_f64(x, dt, A, Bc, Cc):
    """``ref.ssd_chunk_ref``'s function in f64 (y, state, cum)."""
    Q = x.shape[2]
    cum = torch.cumsum(dt * A, dim=2)
    li = cum[:, :, :, None, :] - cum[:, :, None, :, :]
    tril = torch.ones((Q, Q), dtype=torch.bool).tril()
    L = torch.exp(torch.where(tril[None, None, :, :, None], li, -torch.inf))
    s = torch.einsum("bcihn,bcjhn->bcijh", Cc, Bc) * L * dt[:, :, None]
    y = torch.einsum("bcijh,bcjhp->bcihp", s, x)
    w = dt * torch.exp(cum[:, :, -1:] - cum)
    state = torch.einsum("bcjhn,bcjhp->bchnp", Bc * w[..., None], x)
    return y, state, cum


def test_f32_ddt_cancels_against_f64():
    """Why ddt and dA are held at their output's scale: at mamba2's widths
    (Q = 256, H = 24, P = 64, N = 128, one batch row) the f32 plain
    version's ddt is more than 1e-4 of 1 + |g| off the f64 gradient on
    some element (a reverse cumsum of terms ~1000x larger than their
    sum), while every element is within 1e-5 of the output's largest
    magnitude; the emulated kernel likewise."""
    args = ssd_inputs(1, 2, 256, 24, 64, 128, True, 0.1, torch.float32,
                      seed=409)
    ins = [t.double().requires_grad_() for t in args[:5]]
    exact = torch.autograd.grad(_ssd_f64(*ins), ins,
                                [t.double() for t in args[5:]])
    cum = ref.ssd_chunk_ref(*args[:5])[2]
    for got in (ref.ssd_chunk_bwd_ref(*args),
                emulate_bwd(*args[:5], cum, *args[5:])):
        g, e = got[1].double(), exact[1]
        err = (g - e).abs()
        assert float((err / (1 + e.abs())).max()) > 1e-4
        assert float(err.max()) < 1e-5 * float(e.abs().max())


# ---------------------------------------------- SSDChunkFn on the CPU
def _cpu_kernels(monkeypatch, launches):
    """``SSDChunkFn`` with its kernels replaced by the plain forward and
    the emulated backward (the kernels take CUDA tensors only); counts
    the backward's calls."""
    def fwd(x, dt, A, Bc, Cc, *, out_dtype=None):
        return ref.ssd_chunk_ref(x, dt, A, Bc, Cc, out_dtype)

    def bwd(x, dt, A, Bc, Cc, cum, dy, dstate, dcum):
        launches.append(Bc.stride())
        return emulate_bwd(x, dt, A, Bc, Cc, cum, dy, dstate, dcum)
    monkeypatch.setattr(ssd_mod, "ssd_chunk", fwd)
    monkeypatch.setattr(ssd_mod, "ssd_chunk_bwd", bwd)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_chunk_fn_equals_autograd_of_the_plain_version(monkeypatch,
                                                           dtype):
    """Under grad, ``SSDChunkFn`` (forward, saved cum, backward) gives
    autograd of the plain version's gradients (as ``test_torch_backward``
    holds them to the reference); a group's B and C broadcast to the heads
    by ``expand`` get the per-head gradient, summed over the heads by
    expand's backward; an input that needs no gradient gets None."""
    launches = []
    _cpu_kernels(monkeypatch, launches)
    x, dt, A, Bc, Cc, dy, dstate, dcum = ssd_inputs(
        2, 2, 64, 3, 16, 16, True, 0.1, dtype, seed=11)
    grads = []
    for fn in (ssd_mod.SSDChunkFn.apply, ref.ssd_chunk_ref):
        ins = [t.detach().requires_grad_() for t in (x, dt, A)] + [
            t[:, :, :, :1].detach().requires_grad_() for t in (Bc, Cc)]
        bc = [t.expand(-1, -1, -1, x.shape[3], -1) for t in ins[3:]]
        for t in bc:
            t.retain_grad()
        y, state, cum = fn(*ins[:3], *bc, torch.float32)
        torch.autograd.backward((y, state, cum), (dy, dstate, dcum))
        for view, group in zip(bc, ins[3:]):
            assert torch.equal(group.grad, view.grad.sum(3, keepdim=True))
        grads.append([t.grad for t in ins[:3] + bc])
    assert len(launches) == 1 and launches[0][3] == 0   # a stride-0 head
    # per head, as the kernel returns them (each side rounds each head's
    # gradient once in bf16; their sums over heads may differ by those
    # roundings where the heads cancel)
    ssd_check(grads[0], [g.float().numpy() for g in grads[1]], dtype)
    # only x needs a gradient: the others get None
    ins = [t.detach() for t in (x, dt, A, Bc, Cc)]
    ins[0].requires_grad_()
    y, _, _ = ssd_mod.SSDChunkFn.apply(*ins, None)
    y.float().sum().backward()
    assert ins[0].grad.shape == x.shape
    assert all(t.grad is None for t in ins[1:])


@pytest.mark.parametrize("arch", ["mamba2-130m", "zamba2-1.2b"])
def test_loss_fn_through_ssd_chunk_fn_matches_reference(monkeypatch, arch):
    """The smoke model's loss and gradient under the f32 policy, with
    every ``ssd_chunk`` taking ``SSDChunkFn`` (the dispatcher's card path)
    on the kernels' CPU stand-ins, against
    ``jax.value_and_grad(repro.models.model.loss_fn)``: every leaf within
    rtol 1e-4 and 1e-4 of its largest magnitude, as
    ``test_torch_train.py`` holds the plain path."""
    launches = []
    _cpu_kernels(monkeypatch, launches)
    monkeypatch.setattr(ops, "ssd_chunk",
                        lambda x, dt, A, Bc, Cc, out_dtype=None:
                        ssd_mod.SSDChunkFn.apply(x, dt, A, Bc, Cc,
                                                 out_dtype))
    rc, tc = _f32(rcfgs.SMOKE[arch]), _f32(tcfgs.SMOKE[arch])
    params = _ref_params(rc, 1)
    tok = np.random.default_rng(2).integers(2, rc.vocab, (2, 32)).astype(
        np.int32)
    (rloss, _), rgrads = jax.value_and_grad(
        lambda p: rmodel.loss_fn(rc, p, {"tokens": jnp.asarray(tok)}),
        has_aux=True)(jax.tree.map(jnp.asarray, params))
    tp = convert.params_from_numpy(tc, params, device="cpu")
    loss, _, grads = training.loss_and_grads(
        tc, tp, {"tokens": torch.from_numpy(tok)})
    # one backward a layer that runs the SSM block, each on a stride-0
    # B/C head (one group)
    assert launches and all(st[3] == 0 for st in launches)
    _f32_close(loss, rloss)
    pairs = list(zip(_leaves(jax.tree.map(np.asarray, rgrads)),
                     _leaves(grads)))
    assert pairs and all(pa == pb for (pa, _), (pb, _) in pairs)
    for (pa, a), (_, b) in pairs:
        _f32_close(b, a, pa)
