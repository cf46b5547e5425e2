"""The dense mesh path under the reference's placement: every weight a
rank's shard by its partition spec, gathered where it is used, and the
residual carry split over the sequence between blocks
(``models.model``), held three ways on gloo worlds of the CPU.

- Against the reference: the smollm-360m and zamba2-1.2b smoke configs
  (f32 policy) on (1, 2), (2, 1) and (2, 2) ("data", "model") meshes:
  ``loss_fn`` and every gradient's shard against ``jax.value_and_grad``
  of the reference's ``loss_fn`` on an Auto-axes mesh with the params
  placed by the reference's shardings, then three train steps.  The
  reference runs in subprocesses with 8 forced host devices, one a mesh.
- Against one device: every dense, SSM, frontend and hybrid smoke config
  on (2, 2): the loss, every gradient's shard and a served prompt's ids
  (a prefill, two decode steps) against the port's own one-device
  results, and the replicated leaves equal on all ranks after a step.
- The split carry on (1, 2): each checkpointed layer keeps its input as
  [B, S / 2, D], and the loss and gradients equal those with the carry
  whole; ``Trainer.resume(mesh=)`` onto a (1, 2) and a (2, 1) mesh of a
  four-rank world's first two ranks repeats a straight run's losses;
  ``launch.train --mesh 1,2`` trains two steps on a two-rank world.

Tolerances, as ``tests/test_torch_expert_parallel.py`` sets them: f32
1e-4 of each array's largest magnitude (the same arithmetic summed in
another order, XLA against torch, and the collectives' sums); losses
rtol 1e-5; params after AdamW steps rtol 1e-4 with atol 1% of a step's
learning rate, except at elements whose gradient is within the gradient
check's tolerance of zero (``_adam_close``).  The split carry against
the whole one: 1e-6 (the same operators on the same values; only the
all-gathers differ).
"""
import dataclasses
import os
import pickle
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import configs as tcfgs
from repro_torch.launch.steps import make_grad_step
from repro_torch.models import model as tmodel
from repro_torch.sharding import local_shard

from placement_counts import Coords, spec_leaves

ROOT = Path(__file__).resolve().parents[1]
WORKER = ROOT / "tests" / "torch_mesh_worker.py"
REF_ARCHS = ("smollm-360m", "zamba2-1.2b")
REF_MESHES = {2: [(1, 2), (2, 1)], 4: [(2, 2)]}
ONE_ARCHS = ("smollm-360m", "mamba2-130m", "zamba2-1.2b", "gemma3-4b",
             "hubert-xlarge", "llava-next-34b", "qwen2.5-14b",
             "qwen1.5-110b")
TIMEOUT_S = 400
B, S = 4, 16                     # a step's global batch
DECODE = 2
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=20)
F32_TOL = 1e-4
ADAM_ATOL = 1e-2 * OPT["lr"]


def _f32cfg(arch):
    cfg = tcfgs.SMOKE[arch]
    return dataclasses.replace(cfg, policy=dataclasses.replace(
        cfg.policy, compute_dtype=torch.float32, cache_dtype=torch.float32))


def _np_tree(tree):
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    return tree.detach().float().numpy()


def _params(arch, seed):
    return _np_tree(tmodel.init_model(_f32cfg(arch),
                                      torch.Generator().manual_seed(seed)))


def _batch(cfg, rng, labels=False):
    """A global batch: tokens, or frames and labels (an audio frontend),
    with patches (a vision one); with ``labels``, a mask whose count
    differs between the two halves (the data ranks)."""
    tok = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    if cfg.frontend == "audio":
        return {"frames": rng.standard_normal(
            (B, S, cfg.d_frontend)).astype(np.float32), "labels": tok}
    b = {"tokens": tok}
    if cfg.frontend == "vision":
        b["patches"] = rng.standard_normal(
            (B, cfg.n_patch_tokens, cfg.d_model)).astype(np.float32)
    if labels:
        mask = np.ones((B, S), np.float32)
        mask[:B // 2, S // 4:] = 0.0
        mask[B // 2:, -1] = 0.0
        b.update(labels=np.roll(tok, -1, 1), mask=mask)
    return b


def _inputs():
    rng = np.random.default_rng(40)
    ref = {a: {"params": _params(a, 2),
               "batches": [_batch(_f32cfg(a), rng, labels=i == 0)
                           for i in range(3)]} for a in REF_ARCHS}
    one = {}
    for a in ONE_ARCHS:
        cfg = _f32cfg(a)
        prompt = _batch(cfg, rng)
        prompt.pop("labels", None)
        one[a] = {"params": _params(a, 5), "batch": _batch(cfg, rng),
                  "prompt": prompt,
                  "decode": DECODE if cfg.causal else 0}
    carry = {"params": _params("smollm-360m", 6),
             "batch": _batch(_f32cfg("smollm-360m"), rng, labels=True)}
    return {"ref": ref, "one": one, "carry": carry}


# ------------------------------------------------------- the reference
REF = r'''
import os, sys, pickle
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
sys.path.insert(0, "src")
import dataclasses
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import AxisType
from repro import configs as cfgs
from repro.models import model as rmodel
from repro.models.params import shardings
from repro.optim import adamw
from repro.sharding import ShardCtx

inp = pickle.load(open(sys.argv[1], "rb"))
shape = tuple(int(x) for x in sys.argv[2].split("x"))
f32 = lambda t: jax.tree.map(lambda a: np.asarray(a, np.float32), t)
mesh = jax.make_mesh(shape, ("data", "model"),
                     devices=jax.devices()[:shape[0] * shape[1]],
                     axis_types=(AxisType.Auto,) * 2)
ctx = ShardCtx(mesh)
opt = adamw.AdamWConfig(**inp["opt"])
out = {}
for arch in inp["archs"]:
    rc = cfgs.SMOKE[arch]
    rc = dataclasses.replace(rc, policy=dataclasses.replace(
        rc.policy, compute_dtype=jnp.float32, cache_dtype=jnp.float32))
    psh = shardings(rmodel.model_spec(rc), mesh, rc.policy.param_dtype)
    params = jax.tree.map(lambda a, s: jax.device_put(
        jnp.asarray(a, rc.policy.param_dtype), s),
        inp["ref"][arch]["params"], psh)
    state = adamw.init_state(params, rc.policy.moment_dtype)

    @jax.jit
    def step(state, batch):
        (loss, met), grads = jax.value_and_grad(
            lambda p: rmodel.loss_fn(rc, p, batch, ctx),
            has_aux=True)(state.params)
        return adamw.apply_updates(opt, state, grads), loss, met, grads

    losses = []
    for i, b in enumerate(inp["ref"][arch]["batches"]):
        state, loss, met, grads = step(state, jax.tree.map(jnp.asarray, b))
        losses.append(float(loss))
        if i == 0:
            out[(arch, "grads")] = {"loss": float(loss),
                                    "ce": float(met["ce"]),
                                    "grads": f32(grads)}
    out[(arch, "steps")] = {"losses": losses, "params": f32(state.params)}
pickle.dump(out, open(sys.argv[3], "wb"))
print("REF_OK")
'''


# ------------------------------------------------------- the port's worlds
def _tasks(world, inp, ckpt_dir):
    tasks = []
    for shape in REF_MESHES[world]:
        for arch in REF_ARCHS:
            r = inp["ref"][arch]
            tasks.append({"kind": "grads", "name": (shape, arch),
                          "mesh": shape, "arch": arch,
                          "params": r["params"], "batch": r["batches"][0],
                          "steps": r["batches"], "opt": OPT})
    if world == 2:
        tasks.append({"kind": "carry", "name": "carry", "mesh": (1, 2),
                      "arch": "smollm-360m", **inp["carry"]})
    else:
        for arch in ONE_ARCHS:
            tasks.append({"kind": "vs_one", "name": ("one", arch),
                          "mesh": (2, 2), "arch": arch, "opt": OPT,
                          **inp["one"][arch]})
        tasks.append({"kind": "remesh", "name": "remesh", "mesh": (2, 2),
                      "arch": "smollm-360m", "seed": 3, "batch": 4,
                      "seq": 16, "total": 7, "fail": 4,
                      "onto": [(1, 2), (2, 1)], "ckpt_dir": ckpt_dir})
    return tasks


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _wait(procs, tmp):
    deadline = time.monotonic() + TIMEOUT_S
    try:
        while any(p.poll() is None for p, _ in procs):
            if any(p.returncode not in (None, 0) for p, _ in procs) \
                    or time.monotonic() > deadline:
                break
            time.sleep(0.1)
    finally:
        for p, err in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
            err.close()
    bad = [(i, p.returncode) for i, (p, _) in enumerate(procs)
           if p.returncode]
    if bad:
        pytest.fail(f"processes failed or timed out after {TIMEOUT_S} s\n"
                    + "\n".join(f"--- process {i} (rc {rc}) ---\n"
                                + (tmp / f"err{i}.txt").read_text()[-3000:]
                                for i, rc in bad))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's results by mesh, the port's ranks' by world, and
    the training launcher's two ranks, from one launch of every process
    at once."""
    tmp = tmp_path_factory.mktemp("placement")
    inp = _inputs()
    (tmp / "ref_in.pkl").write_bytes(pickle.dumps(
        {**inp, "archs": REF_ARCHS, "opt": OPT}))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")
    cmds = []
    refs = [f"{d}x{m}" for w in REF_MESHES for d, m in REF_MESHES[w]]
    for r in refs:
        cmds.append(([sys.executable, "-c", REF, str(tmp / "ref_in.pkl"), r,
                      str(tmp / f"ref_{r}.pkl")], env))
    for world in REF_MESHES:
        wdir = tmp / f"world{world}"
        wdir.mkdir()
        (wdir / "job.pkl").write_bytes(pickle.dumps(
            {"tasks": _tasks(world, inp, str(wdir / "ckpt")), "threads": 1}))
        for r in range(world):
            cmds.append(([sys.executable, str(WORKER), str(r), str(world),
                          str(wdir / "rdzv"), str(wdir / "job.pkl"),
                          str(wdir / f"out{r}.pkl")], env))
    port = _free_port()
    for r in range(2):
        cmds.append(([sys.executable, "-m", "repro_torch.launch.train",
                      "--arch", "smollm-360m", "--smoke", "--steps", "2",
                      "--batch", "4", "--seq", "16", "--device", "cpu",
                      "--mesh", "1,2", "--ckpt-dir", str(tmp / "launch")],
                     dict(env, RANK=str(r), WORLD_SIZE="2",
                          MASTER_ADDR="localhost", MASTER_PORT=str(port))))
    procs = []
    for i, (cmd, e) in enumerate(cmds):
        err = open(tmp / f"err{i}.txt", "w")
        out = err if "repro_torch.launch.train" in cmd else \
            subprocess.DEVNULL
        procs.append((subprocess.Popen(cmd, env=e, cwd=str(ROOT),
                                       stdout=out, stderr=err), err))
    _wait(procs, tmp)
    launch = [(tmp / f"err{i}.txt").read_text()
              for i in range(len(cmds) - 2, len(cmds))]
    return {"ref": {r: pickle.loads((tmp / f"ref_{r}.pkl").read_bytes())
                    for r in refs},
            "port": {w: [pickle.loads((tmp / f"world{w}" / f"out{r}.pkl")
                                      .read_bytes()) for r in range(w)]
                     for w in REF_MESHES},
            "launch": launch, "inp": inp}


# ------------------------------------------------------------------ helpers
def _close(got, want, tol, what):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    scale = float(np.abs(want).max()) if want.size else 0.0
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * max(scale, 1e-30), err_msg=what)


def _adam_close(got, want, grad, steps, what):
    """Params after AdamW steps: rtol 1e-4, atol ``ADAM_ATOL`` a step;
    an element whose first gradient lies within the gradient check's
    tolerance of zero (``F32_TOL`` of the leaf's largest) is held to
    Adam's own bound instead, 2 lr a step: Adam moves a weight by up to
    lr whatever the gradient's size, so there the direction is the sign
    of summation noise (the reference's own one-device and (1, 2) runs
    of zamba2 differ by 5.4e-5 at such an element of ``in_proj``, whose
    gradient is 4e-7 of the leaf's largest)."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    grad = np.abs(np.asarray(grad, np.float32))
    tiny = grad <= F32_TOL * grad.max()
    atol = np.where(tiny, 2 * OPT["lr"] * steps, ADAM_ATOL * steps)
    bad = np.abs(got - want) > atol + F32_TOL * np.abs(want)
    assert not bad.any(), (what, int(bad.sum()), got[bad][:5], want[bad][:5])


def _shards(arch, shape, rank, tree):
    """A rank's shard of each leaf of a global tree, by path."""
    mesh = Coords(shape, rank)
    specs = dict(spec_leaves(tmodel.param_placement(_f32cfg(arch), mesh)))
    return {path: local_shard(torch.from_numpy(np.asarray(x, np.float32)),
                              specs[path], mesh).numpy()
            for path, x in spec_leaves(tree)}


def _held(arch, shape, rank, tree_want, tree_got, close):
    """Every leaf of a rank's tree against its shard of the global
    tree."""
    got = dict(spec_leaves(tree_got))
    for path, want in _shards(arch, shape, rank, tree_want).items():
        close(got[path], want, path)


def _rows(x, shape, rank):
    b = x.shape[0] // shape[0]
    d = rank // shape[1]
    return x[d * b:(d + 1) * b]


REF_CASES = [(shape, arch) for w in REF_MESHES for shape in REF_MESHES[w]
             for arch in REF_ARCHS]


# ------------------------------------------------------------------ tests
@pytest.mark.parametrize("shape,arch", REF_CASES)
def test_loss_and_gradient_shards_equal_reference(runs, shape, arch):
    """``loss_fn`` and this rank's shard of every gradient (most of them
    split now) against the reference's mesh ``value_and_grad``."""
    want = runs["ref"][f"{shape[0]}x{shape[1]}"][(arch, "grads")]
    for rank, res in enumerate(runs["port"][shape[0] * shape[1]]):
        got = res[(shape, arch)]
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
        np.testing.assert_allclose(got["ce"], want["ce"], rtol=1e-5)
        _held(arch, shape, rank, want["grads"], got["grads"],
              lambda g, w, p: _close(g, w, F32_TOL,
                                     f"{shape} rank {rank} grad {p}"))


@pytest.mark.parametrize("shape,arch", REF_CASES)
def test_three_train_steps_equal_reference(runs, shape, arch):
    """Three mesh train steps: the losses and each rank's shard of the
    params after them against the reference's; every replicated leaf
    equal bit for bit on all ranks."""
    ref = runs["ref"][f"{shape[0]}x{shape[1]}"]
    want = ref[(arch, "steps")]
    ranks = runs["port"][shape[0] * shape[1]]
    for rank, res in enumerate(ranks):
        got = res[(shape, arch)]
        grads = _shards(arch, shape, rank, ref[(arch, "grads")]["grads"])
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5)
        _held(arch, shape, rank, want["params"], got["params"],
              lambda g, w, p: _adam_close(
                  g, w, grads[p], 3, f"{shape} params {p}"))
    for res in ranks[1:]:
        assert res[(shape, arch)]["digests"] == \
            ranks[0][(shape, arch)]["digests"]


@pytest.fixture(scope="module")
def one_device(runs):
    """The port's one-device loss, gradients and served ids of every
    ``ONE_ARCHS`` config on the same inputs."""
    out = {}
    for arch in ONE_ARCHS:
        cfg, inp = _f32cfg(arch), runs["inp"]["one"][arch]
        params = _tensors(inp["params"])
        loss, _, grads = make_grad_step(cfg)(params, inp["batch"])
        prompt = {k: torch.from_numpy(v) for k, v in inp["prompt"].items()}
        Bp, Sp = next(iter(prompt.values())).shape[:2]
        cache = tmodel.init_cache(cfg, Bp, Sp + inp["decode"], device="cpu")
        with torch.no_grad():
            ids, cache = tmodel.prefill(cfg, params, prompt.get("tokens"),
                                        cache, patches=prompt.get("patches"),
                                        frames=prompt.get("frames"))
            seq = [ids.numpy()]
            for t in range(inp["decode"]):
                ids, cache = tmodel.decode_step(cfg, params, cache,
                                                ids[:, None], Sp + t)
                seq.append(ids.numpy())
        out[arch] = {"loss": float(loss), "grads": _np_tree(grads),
                     "ids": seq}
    return out


def _tensors(tree):
    if isinstance(tree, dict):
        return {k: _tensors(v) for k, v in tree.items()}
    return torch.from_numpy(tree.copy())


@pytest.mark.parametrize("arch", ONE_ARCHS)
def test_mesh_equals_one_device(runs, one_device, arch):
    """On (2, 2): the loss, every gradient's shard and the served ids of
    each rank's rows equal the port's one-device results; the replicated
    leaves are equal on all ranks after a step."""
    want = one_device[arch]
    ranks = runs["port"][4]
    for rank, res in enumerate(ranks):
        got = res[("one", arch)]
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=F32_TOL)
        _held(arch, (2, 2), rank, want["grads"], got["grads"],
              lambda g, w, p: _close(g, w, F32_TOL, f"rank {rank} {p}"))
        for a, b in zip(got["ids"], want["ids"]):
            assert np.array_equal(a, _rows(b, (2, 2), rank)), arch
        assert got["digests"] == ranks[0][("one", arch)]["digests"]
    # most leaves are split on (2, 2); only the norms and the SSM
    # per-head vectors stay whole
    specs = [s for _, s in spec_leaves(tmodel.param_placement(
        _f32cfg(arch), Coords((2, 2))))]
    assert sum(bool(s) for s in specs) > len(specs) // 2


def test_split_carry_saves_half_the_sequence(runs):
    """Under remat on (1, 2) each checkpointed layer keeps its input as
    [B, S / 2, D] (the tensors autograd saves at a checkpoint's entry),
    where the whole carry keeps [B, S, D]; the loss and gradients equal
    the whole carry's to 1e-6."""
    cfg = _f32cfg("smollm-360m")
    layers = cfg.n_layers                   # one stacked segment
    D = cfg.d_model
    for res in runs["port"][2]:
        got = res["carry"]
        split = [s for s in got["split"]["saved"] if len(s) == 3
                 and s[-1] == D]
        whole = [s for s in got["whole"]["saved"] if len(s) == 3
                 and s[-1] == D]
        assert got["gathered_contiguous"]
        assert split == [(B, S // 2, D)] * layers, got["split"]["saved"]
        assert whole == [(B, S, D)] * layers, got["whole"]["saved"]
        np.testing.assert_allclose(got["split"]["loss"],
                                   got["whole"]["loss"], rtol=1e-6)
        gw = dict(spec_leaves(got["whole"]["grads"]))
        for path, g in spec_leaves(got["split"]["grads"]):
            _close(g, gw[path], 1e-6, path)


def test_resume_onto_another_mesh_repeats_losses(runs):
    """A (2, 2) run that fails at step 4, resumed from its step-4
    checkpoint on a (1, 2) and on a (2, 1) mesh of the first two ranks:
    the losses after the resume equal the straight (2, 2) run's, and the
    resume logs the new mesh's size."""
    for rank, res in enumerate(runs["port"][4]):
        got = res["remesh"]
        straight = got["straight"]
        assert len(straight) == 7
        for shape in ((1, 2), (2, 1)):
            if rank >= 2:
                assert shape not in got
                continue
            r = got[shape]
            np.testing.assert_allclose(r["losses"], straight[4:], rtol=1e-5)
            kinds = [e["kind"] for e in r["events"]]
            assert {"kind": "elastic_remesh", "devices": 2} in r["events"]
            assert kinds.index("elastic_remesh") < kinds.index("restore")


def test_train_launcher_on_a_mesh(runs):
    """``python -m repro_torch.launch.train --mesh 1,2`` on a two-rank
    gloo world (the world from ``torchrun``'s environment variables)
    trains two steps on both ranks, with equal losses."""
    finals = []
    for log in runs["launch"]:
        line = [x for x in log.splitlines() if x.startswith("done:")]
        assert line and "steps=2" in line[0], log[-2000:]
        finals.append(line[0].split("events")[0])
    assert finals[0] == finals[1]


def test_workers_import_neither_jax_nor_repro(runs):
    for w in REF_MESHES:
        for res in runs["port"][w]:
            assert res["modules"] == []
