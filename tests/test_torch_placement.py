"""The port's parameter placement (``models.model.param_placement``)
against the reference's, and the dry run's inputs under it, without
weights.

For every config of ``configs.ARCHS`` on the production meshes, (16, 16)
("data", "model") and (2, 16, 16) ("pod", "data", "model"), as stand-ins
(the rules read only a mesh's axis names and shape):

- every leaf's spec equals ``repro.models.params.pspecs`` of the
  reference's ``model_spec`` — d_model over the data axes (FSDP), heads,
  mlp, vocab and experts over "model", each where it divides;
- ``launch.steps.param_shapes`` gives each leaf the reference's
  per-device shard shape, so the dry run's params, gradients and AdamW
  moments are a rank's shards: their bytes equal the sum over leaves of
  the reference's shard bytes in the param and moment dtypes.

Exact: integer arithmetic.
"""
import math

import numpy as np
import pytest

from repro import configs as rcfgs
from repro.models import model as rmodel
from repro.models.params import pspecs as r_pspecs
from repro.models.params import tree_paths as r_tree_paths
from repro_torch import configs as tcfgs
from repro_torch.launch import steps as S
from repro_torch.models import model as tmodel
from repro_torch.models.config import SHAPES, applicable_shapes

from placement_counts import spec_leaves

MESHES = [((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model"))]


class StandIn:
    """What the placement rules read of a mesh, in both packages."""

    def __init__(self, shape, names):
        self.axis_names = names
        self.shape = shape
        self.devices = np.empty(shape, dtype=object)

    def axis_size(self, axes):
        sizes = dict(zip(self.axis_names, self.shape))
        return math.prod(sizes[a] for a in axes)


def _ref_leaves(tree, prefix=""):
    """The reference's spec tree's leaves (``PartitionSpec``) by path, as
    tuples."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += _ref_leaves(tree[k], f"{prefix}/{k}")
        return out
    return [(prefix, tuple(tree))]


def _shard_shape(shape, spec, mesh):
    sizes = dict(zip(mesh.axis_names, mesh.shape))
    out = list(shape)
    for d, e in enumerate(spec):
        if e is not None:
            out[d] //= math.prod(sizes[a] for a in
                                 (e if isinstance(e, tuple) else (e,)))
    return tuple(out)


CASES = [(arch, shape, names) for arch in sorted(tcfgs.ARCHS)
         for shape, names in MESHES]


@pytest.mark.parametrize("arch,shape,names", CASES)
def test_param_placement_is_the_reference_partition_spec(arch, shape, names):
    mesh = StandIn(shape, names)
    want = dict(_ref_leaves(r_pspecs(rmodel.model_spec(rcfgs.ARCHS[arch]),
                                     mesh)))
    got = dict(spec_leaves(tmodel.param_placement(tcfgs.ARCHS[arch], mesh)))
    assert got == want
    # and the placement splits something wherever the reference does
    assert any(s for s in got.values())


@pytest.mark.parametrize("arch,shape,names", CASES)
def test_dry_run_state_is_the_reference_shard_bytes(arch, shape, names):
    """A rank's parameters, and the train cell's moments, are the
    reference's per-device shards of every leaf."""
    mesh = StandIn(shape, names)
    rc, tc = rcfgs.ARCHS[arch], tcfgs.ARCHS[arch]
    specs = dict(_ref_leaves(r_pspecs(rmodel.model_spec(rc), mesh)))
    want_el = 0
    for path, p in r_tree_paths(rmodel.model_spec(rc)):
        want_el += math.prod(_shard_shape(p.shape, specs[path], mesh))
    got = dict(spec_leaves(S.param_shapes(tc, mesh)))
    assert sum(math.prod(s) for s in got.values()) == want_el
    for path, p in r_tree_paths(rmodel.model_spec(rc)):
        assert got[path] == _shard_shape(p.shape, specs[path], mesh), path
    cell = next(c for c in SHAPES if c.kind == "train")
    if cell in applicable_shapes(tc):
        state, _ = S.train_arguments(tc, cell, mesh)
        nbytes = lambda tree: sum(t.numel() * t.element_size()
                                  for _, t in spec_leaves(tree))
        p_el = tc.policy.param_dtype.itemsize
        m_el = tc.policy.moment_dtype.itemsize
        assert nbytes(state.params) == want_el * p_el
        assert nbytes(state.m) == nbytes(state.v) == want_el * m_el
