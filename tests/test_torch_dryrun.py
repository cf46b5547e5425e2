"""The port's operator analyser (``repro_torch.launch.opanalysis``) and
dry-run cells (``launch.steps.build_cell``) against the reference's HLO
analyser, and its own accounting.

- FLOPs against ``repro.launch.hloanalysis`` on full-width smollm-360m
  at B = 2, S = 256, the reference compiled on a one-device mesh with
  ``Auto`` axes (jax 0.9's ``make_mesh`` defaults to ``Explicit``, under
  which the reference's ``with_sharding_constraint`` raises).  Decode:
  equal.  Prefill and train: the reference's jnp attention computes
  every (query, key) pair, the kernels only the causal ones, so the
  masked pairs' FLOPs are taken from the reference (4 D a pair a head in
  the forward; in training the forward, its remat and the 8 D of the
  backward's four products); and the port runs two products the
  reference does not: the flash backward recomputes S = Q K^T (2 D a
  visible pair), and ``chunked_xent`` checkpoints each chunk, so its
  unembedding runs again in the backward (2 B S D V).  With those terms
  the counts agree to 1e-9 (the acceptance bound is 1%).  The rmsnorm
  kernels' elementwise FLOPs (their rules') are left out, as the
  reference counts none.
- Each float kernel is opaque: on fakes an entry point counts exactly
  its rule's FLOPs and bytes and no operator of its plain version, under
  grad its forward's and its backward's rule once each.
- Collectives: deepseek-v2's smoke MoE on fake (1, 2) and (2, 2) worlds
  counts one ``all_to_all_single`` each way a MoE layer in prefill, with
  ``_wire_bytes``' ring bytes; the train step adds the remat forward's
  and the backward's.  Rank 3 of (2, 2) counts what rank 0 counts.
- HBM bytes, pinned exactly to hand counts: views, in-place operators,
  copies and fills, a stride-0 operand, gathers, a product and one small
  step.  An analysis active on one thread is not charged a kernel
  entered on another.
- Memory: the params, grads and optimizer-state parts of smollm-smoke's
  train step at its peak are its tree's bytes under its policy dtypes,
  exactly.
"""
import threading

import jax
import pytest
import torch
from jax.sharding import AxisType

from repro import configs as rcfgs
from repro.launch import hloanalysis as rhlo
from repro.launch import steps as rsteps
from repro.models.config import ShapeCell as RShapeCell
from repro_torch import configs as tcfgs
from repro_torch.kernels import cost as kcost
from repro_torch.kernels import ops
from repro_torch.launch import opanalysis as OA
from repro_torch.launch import roofline as R
from repro_torch.launch import steps as S
from repro_torch.launch.mesh import fake_world, make_model_mesh
from repro_torch.models.config import ShapeCell
from repro_torch.models.moe import capacity_for
from repro_torch.models.params import count_params
from repro_torch.models.model import model_spec

B, SEQ = 2, 256


def _ref_flops(kind: str) -> float:
    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    fn, args, insh, outsh, donate = rsteps.build_cell(
        rcfgs.get("smollm-360m"), RShapeCell("x", kind, SEQ, B), mesh)
    compiled = jax.jit(fn, in_shardings=insh, out_shardings=outsh,
                       donate_argnums=donate).lower(*args).compile()
    return rhlo.analyze(compiled.as_text(), 1).flops


@pytest.mark.parametrize("kind", ["decode", "prefill", "train"])
def test_flops_agree_with_reference_hlo_analyser(kind):
    cfg = tcfgs.get("smollm-360m")
    fn, args, parts = S.build_cell(cfg, ShapeCell("x", kind, SEQ, B))
    cost = OA.analyze(fn, *args, parts=parts)
    products = cost.flops - sum(cost.kernels[k]["flops"] for k in
                                ("rmsnorm", "rmsnorm_bwd")
                                if k in cost.kernels)
    D, H, L = cfg.d_head, cfg.n_heads, cfg.n_layers
    visible = kcost.visible_pairs(SEQ, SEQ, True)
    masked = SEQ * SEQ - visible
    want = _ref_flops(kind)
    if kind == "prefill":
        want -= 4 * D * masked * B * H * L
    elif kind == "train":
        want -= (4 * D + 4 * D + 8 * D) * masked * B * H * L
        want += 2 * D * visible * B * H * L                 # bwd's S
        want += 2 * B * SEQ * cfg.d_model * cfg.vocab       # xent's remat
    assert products == pytest.approx(want, rel=1e-9)
    assert abs(products - want) <= 0.01 * want


def _meta(*shape, dtype=torch.bfloat16, grad=False):
    return torch.empty(shape, dtype=dtype, device="meta",
                       requires_grad=grad)


def _cases(grad):
    """(entry, args, kwargs, forward rule, backward rule or None)."""
    bf, f32 = torch.bfloat16, torch.float32
    q, k, v = (_meta(2, 64, 4, 64, grad=grad), _meta(2, 64, 2, 64, grad=grad),
               _meta(2, 64, 2, 64, grad=grad))
    x, w = _meta(3, 70, 96, grad=grad), _meta(96, dtype=f32, grad=grad)
    sx = _meta(2, 2, 32, 4, 64, grad=grad)
    sdt = _meta(2, 2, 32, 4, dtype=f32, grad=grad)
    sA = _meta(4, dtype=f32, grad=grad)
    sB = _meta(2, 2, 32, 1, 64, grad=grad).expand(2, 2, 32, 4, 64)
    sC = _meta(2, 2, 32, 4, 64, grad=grad)
    out = [("rmsnorm", ops.rmsnorm, (x, w), {},
            kcost.rmsnorm_cost(210, 96, bf), kcost.rmsnorm_bwd_cost(210, 96, bf)),
           ("flash_attention", ops.flash_attention, (q, k, v),
            {"causal": True, "window": 16},
            kcost.flash_cost(2, 64, 64, 4, 2, 64, 64, bf, True, 16,
                         stats=grad),
            kcost.flash_bwd_cost(2, 64, 64, 4, 2, 64, 64, bf, True, 16,
                             stats=True)),
           ("ssd_chunk", ops.ssd_chunk, (sx, sdt, sA, sB, sC, f32), {},
            kcost.ssd_cost(2, 2, 32, 4, 64, 64, bf, True, f32),
            kcost.ssd_bwd_cost(2, 2, 32, 4, 64, 64, bf, True))]
    if not grad:
        kq, kk = _meta(2, 1, 4, 64), _meta(2, 100, 2, 64)
        out.append(("decode_attention", ops.decode_attention,
                    (kq, kk, kk, 77), {},
                    kcost.decode_cost(2, 4, 2, 64, 64, 77, bf), None))
    return out


@pytest.mark.parametrize("i", range(4))
def test_kernels_are_opaque_on_fakes(i):
    name, entry, args, kw, rule, _ = _cases(False)[i]
    cost = OA.analyze(entry, *args, **kw)
    assert cost.n_ops == 0, name                 # no operator of the plain
    assert cost.flops_by_dtype == rule.flops
    assert cost.hbm_bytes == rule.nbytes
    assert cost.kernels == {name: {"calls": 1, "flops": sum(
        rule.flops.values()), "bytes": rule.nbytes}}
    out = cost.result
    assert all(kcost.is_fake(t) for t in (out if isinstance(out, tuple)
                                       else (out,)))


@pytest.mark.parametrize("i", range(3))
def test_kernels_under_grad_charge_forward_and_backward(i):
    name, entry, args, kw, fwd, bwd = _cases(True)[i]
    leaves = [t for t in args if isinstance(t, torch.Tensor)
              and t.requires_grad]

    def step():
        out = entry(*args, **kw)
        out = out[0] if isinstance(out, tuple) else out
        return torch.autograd.grad(out, leaves, torch.ones_like(out),
                                   allow_unused=True)

    cost = OA.analyze(step)
    assert cost.kernels[name]["calls"] == 1
    assert cost.kernels[name + "_bwd"]["calls"] == 1
    want = {dt: fwd.flops.get(dt, 0) + bwd.flops.get(dt, 0)
            for dt in set(fwd.flops) | set(bwd.flops)}
    # no matrix product of a plain version is counted
    assert cost.flops_by_dtype == want


F32 = dict(dtype=torch.float32)


# (operator, its inputs' shapes, HBM bytes by hand, in f32 unless named)
BYTE_CASES = [
    # views and metadata move nothing
    ("views", lambda x: x.view(8, 4).t()[1:3], [(4, 8)], 0),
    ("empty_like", torch.empty_like, [(4, 8)], 0),
    # a and b read, the result written: 3 x 128
    ("add", torch.add, [(4, 8), (4, 8)], 384),
    # in place: x and y read, x written
    ("add_", lambda x, y: x.add_(y), [(4, 8), (4, 8)], 384),
    ("add_ on a view", lambda x, y: x[0].add_(y[0]), [(4, 8), (4, 8)], 96),
    # the write and the source, the destination not read
    ("copy_", lambda d, s: d.copy_(s), [(4, 8), (4, 8)], 256),
    ("zero_", lambda x: x.zero_(), [(4, 8)], 128),
    ("clone", torch.clone, [(4, 8)], 256),
    # the stride-0 operand once: 32 + 128 read, 128 written
    ("expand", lambda a, b: a.expand(4, 8) + b, [(1, 8), (4, 8)], 288),
    # a gather: 5 int64 indices, 5 rows of 16 read and written
    ("index_select", lambda t, i: t.index_select(0, i),
     [(100, 16), ((5,), torch.int64)], 40 + 2 * 5 * 16 * 4),
    ("embedding", lambda t, i: torch.nn.functional.embedding(i, t),
     [(100, 16), ((5,), torch.int64)], 40 + 2 * 5 * 16 * 4),
    ("index", lambda t, i: t[i], [(100, 16), ((5,), torch.int64)],
     40 + 2 * 5 * 16 * 4),
    # x, w^T (a view) and the product
    ("mm", torch.mm, [(4, 8), (8, 16)], 128 + 512 + 256),
    ("sum", torch.sum, [(4, 8)], 128 + 4),
]


def _inputs(shapes):
    out = []
    for sh in shapes:
        shape, dt = sh if isinstance(sh[0], tuple) else (sh, torch.float32)
        out.append(_meta(*shape, dtype=dt))
    return out


@pytest.mark.parametrize("name,fn,shapes,want",
                         BYTE_CASES, ids=[c[0] for c in BYTE_CASES])
def test_bytes_of_known_operators(name, fn, shapes, want):
    cost = OA.analyze(fn, *_inputs(shapes))
    assert cost.hbm_bytes == want, name          # exact


def test_bytes_and_flops_of_a_small_step():
    """x [4, 8] @ w [16, 8]^T, relu, sum, all f32: the product reads x
    (128 B) and w through its transposed view (512 B) and writes h
    (256 B); relu reads and writes h (512 B); the sum reads h and writes
    one float (260 B): 1668 B.  FLOPs: 2 x 4 x 8 x 16 in f32."""
    def step(x, w):
        return (x @ w.t()).relu().sum()

    cost = OA.analyze(step, _meta(4, 8, **F32), _meta(16, 8, **F32))
    assert cost.hbm_bytes == 1668
    assert cost.flops_by_dtype == {"f32": 1024}


def test_an_analysis_sees_only_its_own_thread():
    """A kernel entered on another thread while an analysis is active
    here is not charged to it."""
    x, w = _meta(4, 96), _meta(96, **F32)

    def step():
        t = threading.Thread(target=ops.rmsnorm, args=(x, w))
        t.start()
        t.join()
        return ops.rmsnorm(x, w)

    cost = OA.analyze(step)
    assert cost.kernels["rmsnorm"]["calls"] == 1
    assert kcost.current() is None


def test_host_reads_raise_unless_allowed():
    x = _meta(4, dtype=torch.float32)
    with pytest.raises(RuntimeError, match="host read"):
        OA.analyze(lambda t: float(t.sum()), x)
    assert OA.analyze(lambda t: float(t.sum()), x,
                      host_reads=True).host_reads == 1


def test_memory_parts_are_the_trees():
    cfg = tcfgs.SMOKE["smollm-360m"]
    fn, args, parts = S.build_cell(cfg, ShapeCell("x", "train", 64, 2))
    cost = OA.analyze(fn, *args, parts=parts)
    n = count_params(model_spec(cfg))
    p_el = cfg.policy.param_dtype.itemsize
    m_el = cfg.policy.moment_dtype.itemsize
    assert cost.peak_parts["params"] == n * p_el
    assert cost.peak_parts["grads"] == n * p_el
    assert cost.peak_parts["optimizer"] == 2 * n * m_el + 4   # m, v, step
    assert cost.peak_bytes == sum(cost.peak_parts.values())
    assert cost.peak_parts["other"] > 0


def _moe_counts(dims, kind, rank=0):
    cfg = tcfgs.SMOKE["deepseek-v2-236b"]
    cell = ShapeCell("x", kind, 64, 8)
    with fake_world(dims[0] * dims[1], rank):
        mesh = make_model_mesh(dims, ("data", "model"), backend="fake")
        fn, args, parts = S.build_cell(cfg, cell, mesh)
        cost = OA.analyze(fn, *args, parts=parts)
    n_dp, M = dims
    t_loc = cell.global_batch // n_dp * cell.seq_len // M
    rows = cfg.n_experts * capacity_for(cfg, t_loc)
    a2a = R._wire_bytes("all-to-all", rows * cfg.d_model * 2, M)
    n_moe = sum(cfg.layer_kind(i) == "moe" for i in range(cfg.n_layers))
    return cost, a2a, n_moe


@pytest.mark.parametrize("dims", [(1, 2), (2, 2)])
def test_moe_all_to_alls_on_fake_worlds(dims):
    cost, a2a, n_moe = _moe_counts(dims, "prefill")
    assert cost.coll_counts["all-to-all"] == 2 * n_moe
    assert cost.coll_per_kind["all-to-all"] == pytest.approx(
        2 * n_moe * a2a, rel=1e-12)
    train, a2a_t, _ = _moe_counts(dims, "train")
    # the forward, its remat and the backward: each way, a MoE layer
    assert train.coll_counts["all-to-all"] == 6 * n_moe
    assert train.coll_per_kind["all-to-all"] == pytest.approx(
        6 * n_moe * a2a_t, rel=1e-12)
    assert train.coll_counts["all-reduce"] >= 1        # gradients, CE
    assert train.wire_bytes > train.coll_per_kind["all-to-all"]


def test_ranks_are_symmetric():
    a, _, _ = _moe_counts((2, 2), "train", rank=0)
    b, _, _ = _moe_counts((2, 2), "train", rank=3)
    keep = ("flops_by_dtype", "hbm_bytes", "wire_bytes", "coll_counts",
            "coll_per_group", "peak_bytes", "peak_parts", "kernels")
    assert {k: getattr(a, k) for k in keep} == \
        {k: getattr(b, k) for k in keep}
