"""The lease window and synchronous data parallelism over a gloo world of
two ranks (``tests/torch_lease_worker.py``), against the one-process
``VmappedWorkers`` and ``Trainer`` on the same weights and rows.

Both sides run the smoke smollm under the f32 policy.  Tolerance: rtol
1e-5, atol 1e-5 of the leaf's largest magnitude — the same f32 arithmetic,
but the ranks split the host's threads, so a product may block its sums
differently; the mean of two values is exact either way.  The world
joins within ``WORLD_TIMEOUT_S`` and each collective within the
worker's ``TIMEOUT_S``; either timeout fails the test.
"""
import os
import pathlib
import pickle
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.coherence.lease_sync import LeaseConfig, VmappedWorkers
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.models import init_model
from repro_torch.optim import adamw
from repro_torch.runtime.trainer import Trainer, TrainerConfig
from torch_lease_worker import _flat, f32

ROOT = pathlib.Path(__file__).resolve().parent.parent
WORKER = pathlib.Path(__file__).resolve().parent / "torch_lease_worker.py"
WORLD_TIMEOUT_S = 300
WORLD, SEED, SEQ = 2, 5, 32
WINDOWS = {1: 4, 4: 2}           # W -> windows: 4 and 8 local steps
DP_STEPS = 3


def _close(got, want, what=""):
    scale = float(np.abs(want).max()) if want.size else 0.0
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * scale,
                               err_msg=what)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("lease_world")
    job = tmp / "job.pkl"
    job.write_bytes(pickle.dumps({
        "arch": "smollm-360m", "seed": SEED, "seq": SEQ, "windows": WINDOWS,
        "dp_steps": DP_STEPS, "ckpt_dir": str(tmp / "ckpt")}))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    procs, errs = [], []
    for r in range(WORLD):
        errs.append(open(tmp / f"err{r}.txt", "w"))
        procs.append(subprocess.Popen(
            [sys.executable, str(WORKER), str(r), str(WORLD),
             str(tmp / "rdzv"), str(job), str(tmp / f"out{r}.pkl")],
            env=env, cwd=str(ROOT), stdout=subprocess.DEVNULL,
            stderr=errs[-1]))
    deadline = time.monotonic() + WORLD_TIMEOUT_S
    try:
        while any(p.poll() is None for p in procs):
            if any(p.returncode not in (None, 0) for p in procs) \
                    or time.monotonic() > deadline:
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for f in errs:
            f.close()
    bad = [(r, p.returncode) for r, p in enumerate(procs) if p.returncode]
    if bad:
        pytest.fail("ranks failed or timed out:\n" + "\n".join(
            f"--- rank {r} (rc {rc}) ---\n"
            + (tmp / f"err{r}.txt").read_text()[-3000:] for r, rc in bad))
    return [pickle.loads((tmp / f"out{r}.pkl").read_bytes())
            for r in range(WORLD)]


def _cfg():
    return f32(configs.SMOKE["smollm-360m"])


def _opt():
    return adamw.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=20)


@pytest.mark.parametrize("W", sorted(WINDOWS))
def test_lease_window_equals_vmapped_workers(ranks, W):
    """After every window both ranks hold the parameters
    ``VmappedWorkers`` (one worker a rank's row) holds after the same
    local steps and sync; the step counter advanced W a window."""
    cfg = _cfg()
    data = SyntheticLM(cfg, DataConfig(global_batch=WORLD, seq_len=SEQ))
    vw = VmappedWorkers(cfg, _opt(), LeaseConfig(wr_lease=W), WORLD,
                        device="cpu", params=init_model(
                            cfg, torch.Generator().manual_seed(SEED)))
    for i in range(WINDOWS[W]):
        for w in range(W):
            b = data.batch(i * W + w)["tokens"]
            vw.step({"tokens": np.stack([b[r:r + 1] for r in range(WORLD)])})
        want = dict((k, v[0].numpy()) for k, v in _flat(vw.state.params))
        for r, res in enumerate(ranks):
            got = res["windows"][W]["params"][i]
            assert got.keys() == want.keys()
            for k in want:
                _close(got[k], want[k], f"rank {r} window {i} {k}")
    for res in ranks:
        assert res["windows"][W]["step"] == W * WINDOWS[W]
        assert all(np.isfinite(res["windows"][W]["losses"]))


@pytest.mark.parametrize("W", sorted(WINDOWS))
def test_one_all_reduce_per_window(ranks, W):
    """Each window issues exactly one ``c10d`` collective, an
    ``allreduce_`` (the flattened params, m and v), and none inside."""
    for res in ranks:
        for c in res["windows"][W]["counts"]:
            assert c == {"total": 1, "by_op": {"allreduce_": 1}}
        assert res["modules"] == []


def test_data_parallel_trainer_equals_mean_of_row_gradients(ranks,
                                                           tmp_path):
    """A ``Trainer`` over the group (each rank its row; two ``allreduce_``
    a step: the CE's summed loss and count, whose ratio is the global
    batch's CE, then the gradients and metrics averaged) equals, step by
    step,
    ``apply_updates`` with the mean of the rows' gradients computed in one
    process (the same arithmetic: Adam normalises each gradient element,
    so a run on the whole batch, summed in another order, would move
    elements whose gradient is rounding noise by up to lr).  Its losses
    equal a one-process ``Trainer``'s on the whole batch within the
    tolerance, and so do its events and fabric counters exactly."""
    from repro_torch.models.training import loss_and_grads
    cfg, opt = _cfg(), _opt()
    data = SyntheticLM(cfg, DataConfig(global_batch=WORLD, seq_len=SEQ))
    tr = Trainer(cfg, opt, TrainerConfig(total_steps=DP_STEPS, ckpt_period=2,
                                         ckpt_dir=str(tmp_path)),
                 data=data, device="cpu")
    out = tr.run(state=tr.init_state(SEED))
    state = tr.init_state(SEED)
    for s in range(DP_STEPS):
        b = data.batch(s)["tokens"]
        rows = [loss_and_grads(cfg, state.params,
                               {"tokens": torch.from_numpy(b[r:r + 1])})[2]
                for r in range(WORLD)]
        mean = adamw.tree_map(lambda *g: torch.stack(g).mean(0), *rows)
        state = adamw.apply_updates(opt, state, mean)
    want = dict((k, v.numpy()) for k, v in _flat(state.params))
    for res in ranks:
        dp = res["dp"]
        assert dp["counts"] == {"total": 2, "by_op": {"allreduce_": 2}}
        _close(np.array(dp["losses"]), np.array(out["losses"]), "losses")
        for k in want:
            _close(dp["params"][k], want[k], k)
        assert dp["events"] == tr.events
        assert dp["stats"] == out["fabric_stats"]
