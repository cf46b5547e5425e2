"""The all-gathers a forward on a (data, model) mesh issues, derived from
the parameter placement (``models.model.param_placement``) and the
residual carry's rule, not read from a run: the tests that pin a mesh
step's collectives hold the run to these.

- A weight is gathered where it is used: one all-gather for each of its
  dims split over more than one rank, in every use — a stacked leaf in
  each of its layers, the tied embedding twice (the embedding and the
  unembedding), zamba2's shared block at each of its positions.
- A MoE block's router and expert stacks gather only their data-axis
  dims (``moe._weights``); the expert dim stays split.
- The residual carry (S divisible by the "model" ranks, M > 1): one
  all-gather at each block's start and one before ``ln_f``.
"""
import math

from repro_torch.models import model as tmodel
from repro_torch.models import moe as tmoe
from repro_torch.models.params import tree_paths
from repro_torch.sharding import DP_AXES, spec_axes


class Coords:
    """A rank's place on a (data, model) mesh, for the placement rules and
    ``local_shard``."""

    def __init__(self, shape, rank=0):
        self.axis_names = ("data", "model")
        self.shape = tuple(shape)
        self.coords = (rank // shape[1], rank % shape[1])


def spec_leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += spec_leaves(tree[k], f"{prefix}/{k}")
        return out
    return [(prefix, tree)]


def split_dims(spec, shape, data_only=False) -> int:
    """The dims of ``spec`` split over more than one rank of a mesh of
    ``shape`` (only those over data axes when ``data_only``)."""
    sizes = dict(zip(("data", "model"), shape))
    n = 0
    for d in range(len(spec)):
        axes = spec_axes(spec, d)
        if data_only and not all(a in DP_AXES for a in axes):
            continue
        n += math.prod(sizes[a] for a in axes) > 1
    return n


def shared_gathers(cfg, shape) -> int:
    """One MoE call's gathers of its shared experts."""
    place = tmoe.placement(cfg, Coords(shape))
    return sum(split_dims(s, shape) for _, s in
               spec_leaves(place.get("shared", {})))


def weight_gathers(cfg, shape) -> int:
    """One forward's all-gathers of weights (module docstring)."""
    place = dict(spec_leaves(tmodel.param_placement(cfg, Coords(shape))))
    n_shared = sum(cfg.layer_kind(i) == "attn_shared"
                   for i in range(cfg.n_layers))
    total = 0
    for path, p in tree_paths(tmodel.model_spec(cfg)):
        parts = path.split("/")
        uses = p.shape[0] if p.axes[:1] == ("stack",) else 1
        if path == "/embed" and cfg.tie_embeddings:
            uses = 2
        if parts[1] == "shared_attn":
            uses = n_shared
        moe_stack = parts[-2] == "moe" and parts[-1] in tmoe.SHARDED
        total += uses * split_dims(place[path], shape, data_only=moe_stack)
    return total


def carry_gathers(cfg, shape, S) -> int:
    """One forward's all-gathers of the residual carry at sequence S."""
    M = shape[1]
    return cfg.n_layers + 1 if M > 1 and S % M == 0 else 0
