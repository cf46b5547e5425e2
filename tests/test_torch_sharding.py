"""The port's sharding rules (``repro_torch.sharding``), parameter specs
and mesh (``launch.mesh.make_model_mesh``) against the reference's.

``partition_spec`` must give the reference's spec for every leaf of
every config's ``model_spec`` (and cache spec) under meshes (1, 1),
(2, 2), (2, 4), (16, 16) and (2, 16, 16).  The reference reads only a
mesh's ``axis_names`` and ``devices.shape`` (``repro/sharding.py``), so
a stand-in object serves for the 256- and 512-device meshes.  Exact:
the rules are integer arithmetic.
"""
import itertools
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro import configs as rcfgs
from repro import sharding as rsharding
from repro.models import model as rmodel
from repro.models.params import tree_paths as r_tree_paths
from repro_torch import configs as tcfgs
from repro_torch import sharding as tsharding
from repro_torch.launch.mesh import axis_subsets, _lines
from repro_torch.models import model as tmodel
from repro_torch.models.params import pspecs

ROOT = Path(__file__).resolve().parents[1]
SHAPES = [((1, 1), ("data", "model")), ((2, 2), ("data", "model")),
          ((2, 4), ("data", "model")), ((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model"))]


class StandIn:
    """What the reference's rules read of a mesh, and the port's."""

    def __init__(self, shape, names, coords=None):
        self.axis_names = names
        self.devices = np.empty(shape, dtype=object)
        self.shape = shape
        self.coords = coords


def _ref_spec(ps):
    return tuple(ps)


@pytest.mark.parametrize("shape,names", SHAPES)
@pytest.mark.parametrize("arch", sorted(tcfgs.ARCHS))
def test_partition_spec_equals_reference(arch, shape, names):
    mesh = StandIn(shape, names)
    for smoke in (False, True):
        rc = (rcfgs.SMOKE if smoke else rcfgs.ARCHS)[arch]
        tc = (tcfgs.SMOKE if smoke else tcfgs.ARCHS)[arch]
        want = {p: _ref_spec(rsharding.partition_spec(mesh, s.shape, s.axes))
                for p, s in r_tree_paths(rmodel.model_spec(rc))}
        got = {p: s for p, s in _spec_leaves(pspecs(tmodel.model_spec(tc),
                                                     mesh))}
        assert got == want
        for batch, max_len in ((4, 64), (1, 64)):
            want = {p: _ref_spec(rsharding.partition_spec(mesh, s.shape,
                                                          s.axes))
                    for p, s in r_tree_paths(rmodel.cache_spec(rc, batch,
                                                               max_len))}
            got = {p: s for p, s in _spec_leaves(pspecs(
                tmodel.cache_spec(tc, batch, max_len), mesh))}
            assert got == want


def _spec_leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _spec_leaves(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, tree


@pytest.mark.parametrize("rules_off", [(), ("model",), ("pod", "data")])
def test_rules_and_mesh_axes_equal_reference(rules_off):
    rules = tsharding.rules_without(*rules_off)
    assert rules == {k: tuple(v) for k, v in
                     rsharding.rules_without(*rules_off).items()}
    for (shape, names), logical, dim in itertools.product(
            SHAPES, sorted(k for k in rules if k), (1, 2, 6, 15, 32, 504)):
        mesh = StandIn(shape, names)
        assert tsharding.mesh_axes_for(mesh, dim, logical, rules) == \
            rsharding.mesh_axes_for(mesh, dim, logical, rules)


def test_shard_ctx_constrain_is_the_identity():
    x = torch.arange(6.0).reshape(2, 3)
    ctx = tsharding.ShardCtx(StandIn((2, 2), ("data", "model")))
    assert ctx.constrain(x, "batch", None) is x
    assert ctx.spec((4, 8), ("batch", "mlp")) == ("data", "model")
    assert tsharding.NOSHARD.spec((4, 8), ("batch", "mlp")) is None
    assert tsharding.NOSHARD.data_group is None


@pytest.mark.parametrize("shape,names", SHAPES[:3] + [SHAPES[4]])
def test_local_shards_tile_the_global_tensor(shape, names):
    """Every rank's ``local_shard`` put back at its place rebuilds the
    global tensor, for specs over one axis, two axes of one dim and two
    dims."""
    g = torch.arange(32 * 64 * 4, dtype=torch.float32).reshape(32, 64, 4)
    n = int(np.prod(shape))
    specs = [("model",), (None, "data"), ("data", "model"),
             ((names[0], names[1]),), (None, tuple(names[:2]), None)]
    for spec in specs:
        back = torch.full_like(g, -1.0)
        seen = torch.zeros_like(g)
        for r in range(n):
            coords = tuple(int(c) for c in np.unravel_index(r, shape))
            mesh = StandIn(shape, names, coords)
            part = tsharding.local_shard(g, spec, mesh)
            idx = []
            for dim in range(3):
                axes = tsharding.spec_axes(spec, dim)
                i, k = tsharding.shard_index(mesh, axes) if axes else (0, 1)
                step = g.shape[dim] // k
                idx.append(slice(i * step, (i + 1) * step))
            back[tuple(idx)] = part
            seen[tuple(idx)] += 1
        assert torch.equal(back, g)
        # a shard is held by the ranks that differ only on other axes
        used = {a for e in spec if e is not None
                for a in (e if isinstance(e, tuple) else (e,))}
        rep = int(np.prod([s for s, a in zip(shape, names)
                           if a not in used]))
        assert bool((seen == rep).all())


def test_mesh_lines_and_group_order():
    """``make_model_mesh``'s groups: rank r = d * M + m at (d, m); a
    line along "model" is the ranks of one data row, along "data" one
    model column, in ascending order, the subsets made in a fixed
    order."""
    assert axis_subsets(("data", "model")) == [("data",), ("model",),
                                               ("data", "model")]
    assert _lines((2, 4), [1]) == [[0, 1, 2, 3], [4, 5, 6, 7]]
    assert _lines((2, 4), [0]) == [[0, 4], [1, 5], [2, 6], [3, 7]]
    assert _lines((2, 2, 2), [0, 1]) == [[0, 2, 4, 6], [1, 3, 5, 7]]


WORKER = r'''
import datetime, pickle, sys
import torch.distributed as dist
sys.path.insert(0, "src")
from repro_torch.launch.mesh import make_model_mesh
from repro_torch.models.comm import all_gather
import torch
r, w, f, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
dist.init_process_group("gloo", init_method=f"file://{f}", rank=r,
                        world_size=w, timeout=datetime.timedelta(seconds=60))
res = {}
for shape in ((2, 2), (1, 4), (4, 1)):
    mesh = make_model_mesh(shape, backend="gloo")
    got = {}
    for axes in (("data",), ("model",), ("data", "model")):
        g = mesh.group(axes)
        got[axes] = all_gather(torch.tensor([r]), 0, g).tolist() \
            if mesh.axis_size(axes) > 1 else [r]
    res[shape] = {"coords": mesh.coords, "groups": got}
dist.destroy_process_group()
pickle.dump(res, open(out, "wb"))
'''


def test_make_model_mesh_coordinates_and_groups(tmp_path):
    """A gloo world of 4: each rank's coordinates and the ranks of its
    groups along "data", "model" and both."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    procs = [subprocess.Popen(
        [sys.executable, "-c", WORKER, str(r), "4", str(tmp_path / "rdzv"),
         str(tmp_path / f"out{r}.pkl")], cwd=str(ROOT), env=env,
        stderr=subprocess.PIPE) for r in range(4)]
    for p in procs:
        _, err = p.communicate(timeout=120)
        assert p.returncode == 0, err.decode()[-2000:]
    for r in range(4):
        res = pickle.loads((tmp_path / f"out{r}.pkl").read_bytes())
        for shape, got in res.items():
            D, M = shape
            d, m = r // M, r % M
            assert got["coords"] == (d, m)
            assert got["groups"][("model",)] == [d * M + j for j in range(M)]
            assert got["groups"][("data",)] == [j * M + m for j in range(D)]
            assert got["groups"][("data", "model")] == list(range(4))
