"""``python -m repro_torch.launch.dryrun`` in subprocesses: every
(arch, applicable shape) of the smoke configs on a fake (2, 2) world,
and smollm-360m's cells at full width on the single-pod (16, 16) mesh.

The runs start together (module fixture) and the tests read their
records.  A record must hold what the dry run promises: this rank's
FLOPs by dtype, HBM bytes, the collectives, the peak by part with
``fits`` against 80 GB, and the roofline terms; the counts are
computed, not compared, here (``test_torch_dryrun.py`` holds them to the
reference).
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from repro_torch import configs as tcfgs
from repro_torch.models.config import SHAPES, applicable_shapes

SRC = Path(__file__).resolve().parents[1] / "src"
# the smoke runs split so that none takes much longer than another (the
# SSM configs' 16-row chunks make their long cells the slowest)
SMOKE_RUNS = (("zamba2-1.2b", "prefill_32k"),
              ("zamba2-1.2b", "train_4k,decode_32k,long_500k"),
              ("mamba2-130m", "all"),
              (",".join(a for a in tcfgs.ARCHS
                        if a not in ("zamba2-1.2b", "mamba2-130m")), "all"))
TIMEOUT_S = 600


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun")
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1")
    base = [sys.executable, "-m", "repro_torch.launch.dryrun", "--out",
            str(out)]
    cmds = [base + ["--smoke", "--mesh-shape", "2,2", "--arch", a,
                    "--shape", s] for a, s in SMOKE_RUNS]
    cmds.append(base + ["--arch", "smollm-360m", "--shape", "all",
                        "--mesh", "single"])
    procs = [subprocess.Popen(c, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return out, [p.returncode for p in procs], logs


def _check(rec, n_dev):
    assert rec["n_devices"] == n_dev and rec["rank"] == 0
    rl = rec["roofline"]
    assert rl["flops_per_dev"] == pytest.approx(
        sum(rl["flops_by_dtype"].values()))
    assert rl["flops_by_dtype"].get("bf16", 0) > 0
    assert rl["hbm_bytes_per_dev"] > 0 and rl["bound_s"] > 0
    assert rl["bottleneck"] in ("compute", "memory", "collective")
    mem = rec["memory"]
    assert mem["peak_bytes"] == sum(mem["parts"].values()) > 0
    assert mem["parts"]["params"] > 0
    assert mem["fits"] == (mem["peak_bytes"] <= 80 * 10 ** 9)
    if rec["kind"] == "train":
        # the step's peak may come before the gradients exist
        assert mem["part_peaks"]["grads"] > 0
        assert mem["parts"]["optimizer"] > 0
    assert rec["collectives"]["total_wire_bytes"] == pytest.approx(
        sum(rec["collectives"]["per_kind"].values()))


def test_smoke_cells_on_a_fake_2x2_world(runs):
    out, rcs, logs = runs
    for rc, log in zip(rcs[:-1], logs[:-1]):
        assert rc == 0, log[-3000:]
        assert "dry-run complete" in log
    for arch, cfg in tcfgs.SMOKE.items():
        for cell in SHAPES:
            path = out / "2x2-smoke" / f"{arch}__{cell.name}.json"
            assert path.exists() == (cell in applicable_shapes(cfg)), path
            if path.exists():
                rec = json.loads(path.read_text())
                assert (rec["arch"], rec["shape"], rec["smoke"]) == \
                    (arch, cell.name, True)
                _check(rec, 4)


def test_smoke_moe_cells_count_all_to_alls(runs):
    out = runs[0]
    for arch in ("deepseek-v2-236b", "llama4-maverick-400b-a17b"):
        for shape in ("train_4k", "prefill_32k"):
            rec = json.loads((out / "2x2-smoke" / f"{arch}__{shape}.json")
                             .read_text())
            assert rec["collectives"]["counts"]["all-to-all"] > 0
            assert rec["collectives"]["per_group_size"]["2"] > 0


def test_smollm_full_width_on_the_single_pod_mesh(runs):
    out, rcs, logs = runs
    assert rcs[-1] == 0, logs[-1][-3000:]
    cfg = tcfgs.get("smollm-360m")
    for cell in applicable_shapes(cfg):
        rec = json.loads((out / "single" / f"smollm-360m__{cell.name}.json")
                         .read_text())
        _check(rec, 256)
        assert rec["rows"] == cell.global_batch // 16
        assert rec["params_total"] == 361_821_120
        assert rec["memory"]["fits"]
    assert not (out / "single" / "smollm-360m__long_500k.json").exists()
