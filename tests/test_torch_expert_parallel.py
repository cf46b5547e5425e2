"""The port's expert parallelism (``repro_torch.models.moe`` on a mesh,
``launch.steps`` on a mesh, ``Trainer(mesh=)``) against the reference's
``_moe_shard_map``, ``loss_fn`` and train step on Auto-axes meshes.

The reference runs in subprocesses with 8 forced host devices, one a
mesh shape, on meshes ``(1, 2)``, ``(2, 1)``, ``(2, 2)`` and ``(1, 4)`` of
("data", "model"); the port runs in gloo worlds of 2 and 4 ranks
(``tests/torch_mesh_worker.py``; rank r at (r // M, r % M), the device
order of ``jax.make_mesh``), all started at once.  Weights come from the
port's seeded init (``_ref_params``; the reference's own init folds
Python's per-process ``hash``), the MoE blocks' from numpy, so both
packages compute with the same numbers; a rank's results are held
against its block of the reference's global ones.  Tolerances, with
their reasons:

- f32 (1e-4, relative to each array's largest magnitude): the same f32
  arithmetic summed in another order (XLA against torch, the
  collectives' sums);
- bf16 (2e-2): bf16 keeps 8 significant bits;
- aux (rtol 1e-5): the mean over all ranks of f32 means;
- params after AdamW steps (rtol 1e-4, atol ``ADAM_ATOL`` = 1% of the
  learning rate a step): Adam moves a weight by up to the learning rate
  whatever its gradient's size, so where a gradient is near zero a
  difference of 1e-7 in it (the norm's summation order, the collectives')
  moves the weight by a visible share of a step; the losses and the
  gradients themselves are held at 1e-5 and 1e-4.

A MoE layer's output covers its routing: a choice routed or dropped
differently would move it by a whole expert row.  The smoke configs'
random weights leave no near-tie at these shapes under f32.
"""
import dataclasses
import os
import pickle
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import configs as tcfgs
from repro_torch.models import model as tmodel
from repro_torch.models import moe as tmoe
from repro_torch.sharding import local_shard

ROOT = Path(__file__).resolve().parents[1]
WORKER = ROOT / "tests" / "torch_mesh_worker.py"
ARCHS = ("deepseek-v2-236b", "llama4-maverick-400b-a17b")
MESHES = {2: [(1, 2), (2, 1)], 4: [(2, 2), (1, 4)]}
TIMEOUT_S = 400
B, S = 4, 16                     # a step's global batch
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=20)
F32_TOL = 1e-4
BF16_TOL = 2e-2
ADAM_ATOL = 1e-2 * OPT["lr"]     # a step's share of the weights' change


# ------------------------------------------------------------------ inputs
def _np_tree(tree):
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    return tree.detach().float().numpy()


def _f32cfg(arch, cf=None):
    cfg = tcfgs.SMOKE[arch]
    cfg = dataclasses.replace(cfg, policy=dataclasses.replace(
        cfg.policy, compute_dtype=torch.float32, cache_dtype=torch.float32))
    return cfg if cf is None else dataclasses.replace(cfg,
                                                      capacity_factor=cf)


def _moe_weights(cfg, seed, scale=0.1):
    """One MoE block's weights as numpy f32, nested by the spec's keys."""
    rng = np.random.default_rng(seed)

    def walk(sp):
        if isinstance(sp, dict):
            return {k: walk(sp[k]) for k in sorted(sp)}
        return (rng.standard_normal(sp.shape) * scale).astype(np.float32)
    return walk(tmoe.moe_spec(cfg))


def _moe_cases(arch):
    """(name, weights, h, policy) of one config's MoE layer cases."""
    cfg = _f32cfg(arch)
    D = cfg.d_model
    rng = np.random.default_rng(10)
    base = _moe_weights(cfg, 1)
    h = rng.standard_normal((4, 8, D)).astype(np.float32)
    drop = _moe_weights(cfg, 3)
    drop["router"][:, 3] += 1.0              # every token's top choice
    h_pos = np.abs(rng.standard_normal((4, 8, D))).astype(np.float32)
    tie = _moe_weights(cfg, 5)
    col = np.abs(rng.standard_normal(D)).astype(np.float32)
    for e in (2, 5, 6):
        tie["router"][:, e] = col            # equal, dominant columns
    return [("base", base, h, "f32"), ("drops", drop, h_pos, "f32"),
            ("ties", tie, h_pos, "f32"),
            ("decode", base, h[:, :1], "f32"),         # S = 1: fallback
            ("odd", base, h[:, :3], "f32"),            # S = 3
            ("bf16", base, h, "bf16")]


def _params(arch, seed=0):
    return _np_tree(tmodel.init_model(_f32cfg(arch),
                                      torch.Generator().manual_seed(seed)))


def _batches(cfg, seed):
    """Three global batches; the first with labels and a mask whose count
    differs between the two halves of the batch (the data ranks)."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(3):
        tok = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
        b = {"tokens": tok}
        if i == 0:
            mask = np.ones((B, S), np.float32)
            mask[:B // 2, S // 4:] = 0.0         # rows of data rank 0
            mask[B // 2:, -1] = 0.0
            b = {"tokens": tok, "labels": np.roll(tok, -1, 1), "mask": mask}
        out.append(b)
    return out


def _step0_inputs():
    """A dense smoke model (smollm) and a global batch of labels and a
    mask whose count differs between the two ranks' rows."""
    cfg = _f32cfg("smollm-360m")
    rng = np.random.default_rng(20)
    tok = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    mask = np.ones((B, S), np.float32)
    mask[:B // 2, 3:] = 0.0
    return {"params": _params("smollm-360m", 7),
            "batch": {"tokens": tok, "labels": np.roll(tok, -1, 1),
                      "mask": mask}}


def _inputs():
    inp = {"moe": {a: _moe_cases(a) for a in ARCHS},
           "params": {a: _params(a, 2) for a in ARCHS},
           "batches": {a: _batches(_f32cfg(a), 11) for a in ARCHS},
           "step0": _step0_inputs()}
    return inp


# ------------------------------------------------------- the reference
REF = r'''
import os, sys, pickle
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
sys.path.insert(0, "src")
import dataclasses
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import AxisType
from repro import configs as cfgs
from repro.models import moe as rmoe, model as rmodel
from repro.optim import adamw
from repro.sharding import ShardCtx, NOSHARD

inp = pickle.load(open(sys.argv[1], "rb"))
shape = (None if sys.argv[2] == "none"
         else tuple(int(x) for x in sys.argv[2].split("x")))
out = {}
f32 = lambda t: jax.tree.map(lambda a: np.asarray(a, np.float32), t)


def cfg_of(arch, policy="f32"):
    c = cfgs.SMOKE[arch]
    if policy == "f32":
        c = dataclasses.replace(c, policy=dataclasses.replace(
            c.policy, compute_dtype=jnp.float32, cache_dtype=jnp.float32))
    return c


def tree(x, dt=None):
    return jax.tree.map(lambda a: jnp.asarray(a) if dt is None
                        or a.dtype.kind != "f" else jnp.asarray(a, dt), x)


def step_fn(rc, ctx):
    opt = adamw.AdamWConfig(**inp["opt"])

    def step(state, batch):
        (loss, met), grads = jax.value_and_grad(
            lambda p: rmodel.loss_fn(rc, p, batch, ctx),
            has_aux=True)(state.params)
        return adamw.apply_updates(opt, state, grads), loss, met, grads
    return jax.jit(step)


if shape is None:
    rc = cfg_of("smollm-360m")
    s0 = inp["step0"]
    params = tree(s0["params"], rc.policy.param_dtype)
    state = adamw.init_state(params, rc.policy.moment_dtype)
    new, loss, met, grads = step_fn(rc, NOSHARD)(state, tree(s0["batch"]))
    out["step0"] = {"loss": float(loss), "ce": float(met["ce"]),
                    "grads": f32(grads), "params": f32(new.params)}
else:
    n = shape[0] * shape[1]
    mesh = jax.make_mesh(shape, ("data", "model"), devices=jax.devices()[:n],
                         axis_types=(AxisType.Auto,) * 2)
    ctx = ShardCtx(mesh)
    for arch in inp["archs"]:
        for name, w, h, policy in inp["moe"][arch]:
            rc = cfg_of(arch, policy)
            cd = rc.policy.compute_dtype
            o, a = jax.jit(lambda p, x: rmoe.moe_apply(rc, p, x, ctx))(
                tree(w), jnp.asarray(h, cd))
            out[(arch, "moe", name)] = {"out": f32(o), "aux": float(a)}
        rc = cfg_of(arch)
        params = tree(inp["params"][arch], rc.policy.param_dtype)
        state = adamw.init_state(params, rc.policy.moment_dtype)
        fn = step_fn(rc, ctx)
        losses = []
        for i, b in enumerate(inp["batches"][arch]):
            state, loss, met, grads = fn(state, tree(b))
            losses.append(float(loss))
            if i == 0:
                out[(arch, "grads")] = {
                    "loss": float(loss), "ce": float(met["ce"]),
                    "aux": float(met["aux"]), "grads": f32(grads)}
        out[(arch, "steps")] = {"losses": losses,
                                "params": f32(state.params)}
pickle.dump(out, open(sys.argv[3], "wb"))
print("REF_OK")
'''


# ------------------------------------------------------- the port's worlds
def _tasks(world, inp, ckpt_dir=""):
    tasks = []
    for shape in MESHES[world]:
        for arch in ARCHS:
            for name, w, h, policy in inp["moe"][arch]:
                tasks.append({"kind": "moe", "name": (shape, arch, name),
                              "mesh": shape, "arch": arch, "policy": policy,
                              "params": w, "h": h})
            tasks.append({"kind": "grads", "name": (shape, arch, "grads"),
                          "mesh": shape, "arch": arch,
                          "params": inp["params"][arch],
                          "batch": inp["batches"][arch][0],
                          "steps": inp["batches"][arch], "opt": OPT})
    if world == 2:
        tasks.append({"kind": "step0", "name": "step0",
                      "arch": "smollm-360m", "opt": OPT,
                      **inp["step0"]})
        for arch in ARCHS:
            tasks.append({"kind": "group_vs_mesh", "mesh": (2, 1),
                          "name": (arch, "group_vs_mesh"), "arch": arch,
                          "params": inp["params"][arch],
                          "steps": inp["batches"][arch], "opt": OPT})
        tasks.append({"kind": "serve", "name": "serve", "mesh": (1, 2),
                      "arch": ARCHS[0], "cf": 8.0, "seed": 4, "decode": 3,
                      "tokens": np.random.default_rng(30).integers(
                          0, 256, (2, 16)).astype(np.int32)})
        tasks.append({"kind": "trainer", "name": "trainer", "mesh": (1, 2),
                      "arch": ARCHS[0], "seed": 3, "batch": 2, "seq": 16,
                      "total": 5, "fail": 3, "ckpt_dir": ckpt_dir})
    return tasks


def _start(cmds, tmp):
    procs = []
    for i, (cmd, env) in enumerate(cmds):
        err = open(tmp / f"err{i}.txt", "w")
        procs.append((subprocess.Popen(cmd, env=env, cwd=str(ROOT),
                                       stdout=subprocess.DEVNULL,
                                       stderr=err), err, cmd))
    return procs


def _wait(procs, tmp):
    deadline = time.monotonic() + TIMEOUT_S
    try:
        while any(p.poll() is None for p, _, _ in procs):
            if any(p.returncode not in (None, 0) for p, _, _ in procs):
                break
            if time.monotonic() > deadline:
                break
            time.sleep(0.1)
    finally:
        for p, err, _ in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
            err.close()
    bad = [(i, p.returncode) for i, (p, _, _) in enumerate(procs)
           if p.returncode]
    if bad:
        tails = "\n".join(f"--- {' '.join(procs[i][2][1:3])} (rc {rc}) ---\n"
                          + (tmp / f"err{i}.txt").read_text()[-3000:]
                          for i, rc in bad)
        pytest.fail(f"processes failed or timed out after {TIMEOUT_S} s\n"
                    f"{tails}")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's results by mesh and the port's ranks' by world,
    from one launch of every process at once."""
    tmp = tmp_path_factory.mktemp("ep")
    inp = _inputs()
    (tmp / "ref_in.pkl").write_bytes(pickle.dumps(
        {**inp, "archs": ARCHS, "opt": OPT}))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               JAX_PLATFORMS="cpu")
    cmds = []
    refs = ["none"] + [f"{d}x{m}" for w in MESHES for d, m in MESHES[w]]
    for r in refs:
        cmds.append(([sys.executable, "-c", REF, str(tmp / "ref_in.pkl"), r,
                      str(tmp / f"ref_{r}.pkl")], env))
    for world in MESHES:
        wdir = tmp / f"world{world}"
        wdir.mkdir()
        (wdir / "job.pkl").write_bytes(pickle.dumps(
            {"tasks": _tasks(world, inp, str(wdir / "ckpt")),
             "threads": 1}))
        for r in range(world):
            cmds.append(([sys.executable, str(WORKER), str(r), str(world),
                          str(wdir / "rdzv"), str(wdir / "job.pkl"),
                          str(wdir / f"out{r}.pkl")], env))
    _wait(_start(cmds, tmp), tmp)
    ref = {}
    for r in refs:
        ref[r] = pickle.loads((tmp / f"ref_{r}.pkl").read_bytes())
    port = {w: [pickle.loads((tmp / f"world{w}" / f"out{r}.pkl")
                             .read_bytes()) for r in range(w)]
            for w in MESHES}
    return {"ref": ref, "port": port, "inp": inp}


# ------------------------------------------------------------------ helpers
class _Coords:
    """A rank's place on a mesh, for ``local_shard``."""

    def __init__(self, shape, rank):
        self.axis_names = ("data", "model")
        self.shape = shape
        self.coords = (rank // shape[1], rank % shape[1])


def _close(got, want, tol, what):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    scale = float(np.abs(want).max()) if want.size else 0.0
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * max(scale, 1e-30), err_msg=what)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += _leaves(tree[k], f"{prefix}/{k}")
        return out
    return [(prefix, tree)]


def _rank_rows(x, shape, rank):
    n_dp = shape[0]
    b = x.shape[0] // n_dp
    d = rank // shape[1]
    return x[d * b:(d + 1) * b]


def _adam_close(got, want, steps, what):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=F32_TOL,
                               atol=ADAM_ATOL * steps, err_msg=what)


def _held(arch, shape, rank, tree_ref, tree_port, tol, what, close=None):
    """Every leaf of a rank's tree against its shard of the reference's
    global tree (``close(got, want, what)``, default ``_close`` at
    ``tol``)."""
    cfg = _f32cfg(arch)
    mesh = _Coords(shape, rank)
    specs = dict(_leaves(tmodel.param_placement(cfg, mesh)))
    got = dict(_leaves(tree_port))
    for path, want in _leaves(tree_ref):
        want = local_shard(torch.from_numpy(np.asarray(want, np.float32)),
                           specs[path], mesh).numpy()
        if close is None:
            _close(got[path], want, tol, f"{what} {path}")
        else:
            close(got[path], want, f"{what} {path}")


def _world(shape):
    return shape[0] * shape[1]


CASES = [(shape, arch) for w in MESHES for shape in MESHES[w]
         for arch in ARCHS]


# ------------------------------------------------------------------ tests
@pytest.mark.parametrize("shape,arch", CASES)
@pytest.mark.parametrize("case", ["base", "drops", "ties", "decode", "odd",
                                  "bf16"])
def test_moe_layer_equals_shard_map(runs, shape, arch, case):
    """The MoE layer on every rank: its block of ``_moe_shard_map``'s
    output (``_moe_gspmd`` over the global batch for the decode step and
    the odd sequence, whose shapes do not split) and the aux."""
    want = runs["ref"][f"{shape[0]}x{shape[1]}"][(arch, "moe", case)]
    tol = BF16_TOL if case == "bf16" else F32_TOL
    for rank, res in enumerate(runs["port"][_world(shape)]):
        got = res[(shape, arch, case)]
        _close(got["out"], _rank_rows(want["out"], shape, rank), tol,
               f"{shape} {arch} {case} rank {rank}")
        np.testing.assert_allclose(got["aux"], want["aux"],
                                   rtol=tol if case == "bf16" else 1e-5)


@pytest.mark.parametrize("shape,arch", CASES)
def test_moe_layer_collectives(runs, shape, arch):
    """The expert-parallel path's collectives: two ``all_to_all`` over
    the model group, one all-gather along the sequence, the aux's
    ``all_reduce``, and the weights' data shards gathered (four leaves)
    only where the data axis has more than one rank; the decode step's
    global dispatch exchanges no ``all_to_all``."""
    n_dp, M = shape
    for res in runs["port"][_world(shape)]:
        base = res[(shape, arch, "base")]["counts"]["by_op"]
        assert base.get("alltoall_base_", 0) == (2 if M > 1 else 0)
        gathers = (1 if M > 1 else 0) + (4 if n_dp > 1 else 0)
        assert base.get("_allgather_base_", 0) == gathers, base
        dec = res[(shape, arch, "decode")]["counts"]["by_op"]
        assert dec.get("alltoall_base_", 0) == 0, dec


@pytest.mark.parametrize("shape,arch", CASES)
def test_loss_and_gradients_equal_reference(runs, shape, arch):
    """``loss_fn`` and every gradient (this rank's shard of the global
    gradient) on a batch of labels and a mask whose count differs across
    the data ranks, against ``jax.value_and_grad`` of the reference's
    ``loss_fn`` under the mesh."""
    want = runs["ref"][f"{shape[0]}x{shape[1]}"][(arch, "grads")]
    for rank, res in enumerate(runs["port"][_world(shape)]):
        got = res[(shape, arch, "grads")]
        for k in ("loss", "ce", "aux"):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5,
                                       err_msg=k)
        _held(arch, shape, rank, want["grads"], got["grads"], F32_TOL,
              f"{shape} rank {rank} grad")


@pytest.mark.parametrize("shape,arch", CASES)
def test_three_train_steps_equal_reference(runs, shape, arch):
    """Three mesh train steps: the losses and the params after them, and
    every replicated leaf equal bit for bit on all ranks."""
    want = runs["ref"][f"{shape[0]}x{shape[1]}"][(arch, "steps")]
    ranks = runs["port"][_world(shape)]
    for rank, res in enumerate(ranks):
        got = res[(shape, arch, "grads")]
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5)
        _held(arch, shape, rank, want["params"], got["params"], F32_TOL,
              f"{shape} rank {rank} params",
              close=lambda g, w, what: _adam_close(g, w, 3, what))
    specs = dict(_leaves(tmodel.param_placement(_f32cfg(arch),
                                                _Coords(shape, 0))))
    first = dict(_leaves(ranks[0][(shape, arch, "grads")]["params"]))
    for res in ranks[1:]:
        for path, leaf in _leaves(res[(shape, arch, "grads")]["params"]):
            if specs[path] == ():
                assert np.array_equal(leaf, first[path]), path


def test_step0_data_parallel_ce_is_the_global_ratio(runs):
    """The data-parallel step (``group=``) with labels and a mask whose
    count differs on the two ranks: the CE, every gradient and the params
    after one step equal the reference's over the global batch — the
    ratio of summed losses and summed counts, not a mean of the ranks'
    means."""
    want = runs["ref"]["none"]["step0"]
    for res in runs["port"][2]:
        got = res["step0"]
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
        np.testing.assert_allclose(got["ce"], want["ce"], rtol=1e-5)
        gl = dict(_leaves(got["grads"]))
        for path, g in _leaves(want["grads"]):
            _close(gl[path], g, F32_TOL, f"grad {path}")
        pl = dict(_leaves(got["params"]))
        for path, p in _leaves(want["params"]):
            _adam_close(pl[path], p, 1, f"params {path}")


@pytest.mark.parametrize("arch", ARCHS)
def test_group_path_equals_a_data_mesh(runs, arch):
    """A ``(2, 1)`` mesh (the MoE weights held as data shards, the
    layer's path ``_moe_shard_map``'s at M = 1) computes what the
    ``group=`` path computes: three steps' losses and params."""
    for res in runs["port"][2]:
        got = res[(arch, "group_vs_mesh")]
        np.testing.assert_allclose(got["mesh"]["losses"],
                                   got["group"]["losses"], rtol=1e-6)
        pm = dict(_leaves(got["mesh"]["params"]))
        for path, p in _leaves(got["group"]["params"]):
            _adam_close(pm[path], p, 3, path)


def test_mesh_serving_equals_one_device(runs):
    """``make_prefill_step`` and three ``make_decode_step`` steps on a
    (1, 2) mesh (capacity factor 8, nothing dropped) give the port's
    one-device ids; the prefill exchanges two ``all_to_all`` a MoE layer
    and gathers no expert weight, the decode steps none."""
    cfg = _f32cfg(ARCHS[0], cf=8.0)
    task = next(t for t in _tasks(2, runs["inp"]) if t["kind"] == "serve")
    params = tmodel.init_model(cfg, torch.Generator().manual_seed(
        task["seed"]))
    tokens = torch.from_numpy(task["tokens"])
    cache = tmodel.init_cache(cfg, 2, 16 + task["decode"], device="cpu")
    ids, cache = tmodel.prefill(cfg, params, tokens, cache)
    want = [ids.numpy()]
    for t in range(task["decode"]):
        ids, cache = tmodel.decode_step(cfg, params, cache, ids[:, None],
                                        16 + t)
        want.append(ids.numpy())
    n_moe = sum(cfg.layer_kind(i) == "moe" for i in range(cfg.n_layers))
    for res in runs["port"][2]:
        got = res["serve"]
        for a, b in zip(got["ids"], want):
            assert np.array_equal(a, b)
        pre = got["prefill_counts"]["by_op"]
        assert pre.get("alltoall_base_", 0) == 2 * n_moe
        assert pre.get("_allgather_base_", 0) == n_moe    # sequence blocks
        dec = got["decode_counts"]["by_op"]
        assert dec.get("alltoall_base_", 0) == 0
        assert dec.get("_allgather_base_", 0) == n_moe    # expert rows


def test_mesh_trainer_resume_repeats_losses(runs):
    """``Trainer(mesh=)`` on (1, 2): its state is the rank's shards of the
    seeded global init; a failure at step 3 and a resume from the step-2
    checkpoint (global tensors) repeat the losses and params bit for
    bit."""
    cfg = tcfgs.SMOKE[ARCHS[0]]
    glob = tmodel.init_model(cfg, torch.Generator().manual_seed(3))
    for rank, res in enumerate(runs["port"][2]):
        got = res["trainer"]
        assert got["resumed"] == got["losses"][2:]
        rp = dict(_leaves(got["resumed_params"]))
        for path, p in _leaves(got["params"]):
            assert np.array_equal(rp[path], p), path
        mesh = _Coords((1, 2), rank)
        init = dict(_leaves(got["init"]))
        specs = dict(_leaves(tmodel.param_placement(cfg, mesh)))
        for path, g in _leaves(glob):
            want = local_shard(g, specs[path], mesh).float().numpy()
            assert np.array_equal(init[path], want), path
        assert [e["kind"] for e in got["events"]].count("param_lease") == 3


def test_workers_import_neither_jax_nor_repro(runs):
    for w in MESHES:
        for res in runs["port"][w]:
            assert res["modules"] == []
