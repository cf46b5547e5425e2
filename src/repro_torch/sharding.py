"""Logical-axis sharding rules with divisibility fallback — the port of
``repro.sharding`` (``DEFAULT_RULES``, ``mesh_axes_for``,
``partition_spec``, ``rules_without``, ``ShardCtx`` and ``NOSHARD``).

Params and activations are annotated with *logical* axis names; these
rules map them onto a mesh's axes.  A mesh axis is dropped for a tensor
dim whose size it does not divide (smollm's 15 heads on a 16-way "model"
axis, hubert's vocab of 504), so every spec is valid for every
architecture.  A mesh here is anything with ``axis_names`` and a
``shape`` tuple (``launch.mesh.Mesh``), or the reference's
``devices.shape``.

A partition spec is a tuple with one entry a dim: None (whole), an axis
name, or a tuple of axis names (the dim split over their product,
row-major in that order), trailing Nones trimmed, as the reference's
``PartitionSpec``.  The reference places arrays with ``NamedSharding``;
the port's ranks hold explicit local tensors, and ``local_shard`` is
this rank's slice of a global tensor under a spec.  ``shard_map`` is
jax's API and has no counterpart: the code that runs under it in the
reference (the expert-parallel MoE) calls ``torch.distributed`` itself.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

# logical axis -> preferred mesh axes (tried in order, greedily combined)
DEFAULT_RULES: dict = {
    "batch": ("pod", "data"),
    "tokens": ("pod", "data"),     # flattened B*S (MoE dispatch)
    "embed": ("pod", "data"),      # ZeRO-3 / FSDP for parameter d_model dims
    "heads": ("model",),
    "kv_heads": ("model",),
    "mlp": ("model",),
    "vocab": ("model",),
    "experts": ("model",),
    "expert_mlp": ("model",),
    "capacity": ("data",),
    "seq": (),                     # unsharded by default
    "seq_shard": ("model",),       # sequence parallelism for residual carries
    "kv_seq": ("data",),           # long-context decode: shard KV length
    "dstate": (),
    "stack": (),                   # scanned layer dim — never sharded
    "fabric_shard": ("fabric",),   # TSU shard-major dims of the coherence
                                   # fabric
    None: (),
}

DP_AXES = ("pod", "data")          # the data-parallel axes, outer first


def axis_sizes(mesh) -> dict:
    """``{axis name: size}`` of a mesh (``shape`` a tuple, or the
    reference's ``devices.shape``)."""
    shape = mesh.devices.shape if hasattr(mesh, "devices") else mesh.shape
    return dict(zip(mesh.axis_names, tuple(shape)))


def _axis_size(mesh, name: str) -> int:
    return axis_sizes(mesh).get(name, 1)


def mesh_axes_for(mesh, dim_size: int, logical: Optional[str],
                  rules: Optional[dict] = None,
                  taken: Optional[set] = None) -> Tuple[str, ...]:
    """Greedy: keep the prefix of the preferred mesh axes while
    divisibility holds (an axis absent from the mesh or already taken is
    skipped)."""
    rules = rules or DEFAULT_RULES
    prefs = rules.get(logical, ())
    out = []
    size = 1
    for ax in prefs:
        if ax not in mesh.axis_names:
            continue
        if taken is not None and ax in taken:
            continue
        nxt = size * _axis_size(mesh, ax)
        if nxt == 0 or dim_size % nxt != 0:
            break
        out.append(ax)
        size = nxt
    return tuple(out)


def partition_spec(mesh, shape: Sequence[int],
                   logical_axes: Sequence[Optional[str]],
                   rules: Optional[dict] = None) -> tuple:
    """The spec tuple; each mesh axis used at most once per tensor."""
    assert len(shape) == len(logical_axes), (shape, logical_axes)
    taken: set = set()
    spec = []
    for dim, logical in zip(shape, logical_axes):
        axes = mesh_axes_for(mesh, dim, logical, rules, taken)
        taken.update(axes)
        if not axes:
            spec.append(None)
        elif len(axes) == 1:
            spec.append(axes[0])
        else:
            spec.append(tuple(axes))
    while spec and spec[-1] is None:
        spec.pop()
    return tuple(spec)


def spec_axes(spec: tuple, dim: int) -> Tuple[str, ...]:
    """The mesh axes dim ``dim`` of ``spec`` is split over (outer
    first), () when it is whole."""
    if dim >= len(spec) or spec[dim] is None:
        return ()
    e = spec[dim]
    return e if isinstance(e, tuple) else (e,)


def split_axes(spec: tuple) -> Tuple[str, ...]:
    """Every mesh axis some dim of ``spec`` is split over."""
    return tuple(a for dim in range(len(spec)) for a in spec_axes(spec, dim))


def shard_index(mesh, axes: Sequence[str]) -> Tuple[int, int]:
    """(this rank's index, the count) of the shards over ``axes``:
    row-major over the axes in the given order, as ``all_gather`` over
    them tiles."""
    sizes = axis_sizes(mesh)
    coord = dict(zip(mesh.axis_names, mesh.coords))
    idx, n = 0, 1
    for ax in axes:
        idx = idx * sizes[ax] + coord[ax]
        n *= sizes[ax]
    return idx, n


def local_shard(x, spec: tuple, mesh):
    """This rank's slice of the global tensor ``x`` under ``spec`` (a
    view; the counterpart of placing ``x`` with a ``NamedSharding``)."""
    for dim in range(len(spec)):
        axes = spec_axes(spec, dim)
        if not axes:
            continue
        i, n = shard_index(mesh, axes)
        if x.shape[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split "
                             f"over {axes} ({n})")
        step = x.shape[dim] // n
        x = x.narrow(dim, i * step, step)
    return x


class ShardCtx:
    """Threaded through the model code.  ``mesh`` None: one device (or a
    data-parallel rank: ``data_group`` is then the group the loss's
    token count is summed over).  ``constrain`` is the identity: the
    reference pins GSPMD's layout of a global array with it, while the
    port's ranks compute on explicit local tensors whose layout the code
    that makes them decides."""

    def __init__(self, mesh=None, rules: Optional[dict] = None,
                 data_group=None):
        self.mesh = mesh
        self.rules = rules or DEFAULT_RULES
        self._data_group = data_group

    def constrain(self, x, *logical_axes):
        return x

    def spec(self, shape, logical_axes) -> Optional[tuple]:
        if self.mesh is None:
            return None
        return partition_spec(self.mesh, shape, logical_axes, self.rules)

    @property
    def dp_axes(self) -> Tuple[str, ...]:
        if self.mesh is None:
            return ()
        return tuple(a for a in DP_AXES if a in self.mesh.axis_names)

    @property
    def data_group(self):
        """The group over the data-parallel axes through this rank (None:
        one rank)."""
        if self.mesh is not None:
            return self.mesh.group(self.dp_axes)
        return self._data_group


NOSHARD = ShardCtx(None)


def rules_without(*axes) -> dict:
    """Rules with the given mesh axes removed."""
    return {k: tuple(a for a in v if a not in axes)
            for k, v in DEFAULT_RULES.items()}
