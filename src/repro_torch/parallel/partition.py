"""Logical-axis partitioning: the MaxText-style rule table (counterpart of
``repro/parallel/partition.py``).

Every parameter and cache entry carries a tuple of *logical* axis names
("embed", "mlp", "heads", ...). A rule table maps each logical axis to an
ordered list of candidate mesh axes; resolution picks the first candidate
whose axes exist on the mesh, are not taken by an earlier dim and (strict
resolution: parameters and caches) divide the dimension.

The reference hands the resolved specs to XLA, which inserts the
collectives. This port is explicit (Megatron-style): ``make_sharding``
names, for a rank, the slice of each dim it holds; ``models/model.py``
cuts each rank's shards by those slices; and the blocks call a collective
(``parallel/tp.py``) exactly where a sharded dim is contracted. So
``logical_constraint`` places nothing: an activation is whatever the
shards it was computed from make it.

A mesh is anything with named axes: a ``torch.distributed`` DeviceMesh
(``launch/mesh.py::make_host_mesh``), or an object whose ``.shape`` maps
axis names to sizes (as a JAX mesh's does), which is all resolution
reads.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
from typing import Any, NamedTuple

from repro_torch.optim.adamw import tree_map


class Boxed(NamedTuple):
    """A parameter value bundled with its logical axis names."""
    value: Any
    axes: tuple


def box(axes: tuple, value):
    ndim = value.dim() if hasattr(value, "dim") else getattr(
        value, "ndim", len(axes))
    assert len(axes) == ndim, (axes, tuple(value.shape))
    return Boxed(value, axes)


def is_boxed(x) -> bool:
    return isinstance(x, Boxed)


def unbox_tree(tree):
    """Split a tree of Boxed leaves into (values_tree, axes_tree)."""
    values = tree_map(lambda b: b.value, tree)
    axes = tree_map(lambda b: b.axes, tree)
    return values, axes


# Default rule table: TP over "model", FSDP over "data", DP batch over
# ("pod", "data"). Order within a candidate list = priority. The same
# table as the reference's.
DEFAULT_RULES: dict[str, tuple] = {
    # weight dims
    "embed":    ("data",),            # FSDP: gathered at use
    "mlp":      ("model",),           # TP column/row
    "heads":    ("model",),
    "kv":       ("model",),
    "head_dim": (),
    "vocab":    ("model",),
    "expert":   ("data", "model"),    # EP: expert dim over whichever divides
    "dinner":   ("model",),           # mamba inner dim
    "state":    (),
    "conv":     (),
    "dt":       (),
    "codebook": (),
    "layer":    (),                   # stacked layer axis: never sharded
    # activation dims
    "batch":    (("pod", "data"), "data"),  # tuple candidate = used together
    "pages":    (),                   # paged-KV pool: host-addressed pages
    "seq":      (),
    "cache_seq": ("model",),
    "act_heads": ("model",),
    "act_kv":   ("model",),
    "act_mlp":  ("model",),
    "act_dinner": ("model",),
    "act_embed": (),
    "act_vocab": ("model",),
    "act_expert": (),
}


def serve_rules(rules: dict[str, tuple] | None = None) -> dict[str, tuple]:
    """Rule table for the slot-batched serve engine: the given (or
    default) table with the batch axis replicated. Decode slots and pool
    pages are host-addressed rows, so the engine is tensor-parallel only;
    scale-out over ``data`` is a replica's business, not a slot's."""
    merged = dict(DEFAULT_RULES if rules is None else rules)
    merged["batch"] = ()
    return merged


@dataclasses.dataclass
class MeshContext:
    mesh: Any
    rules: dict[str, tuple]


_ctx = threading.local()


def _get_ctx() -> MeshContext:
    return getattr(_ctx, "value", MeshContext(None, DEFAULT_RULES))


def current_mesh():
    """The mesh of the active ``axis_rules`` context (None without one)."""
    return _get_ctx().mesh


@contextlib.contextmanager
def axis_rules(mesh, rules: dict[str, tuple] | None = None,
               overrides: dict[str, tuple] | None = None):
    """Install the (mesh, rules) context that ``resolve_spec``,
    ``make_sharding`` and the blocks' collectives (``parallel/tp.py``)
    read. ``overrides`` patches individual logical axes."""
    merged = dict(DEFAULT_RULES if rules is None else rules)
    if overrides:
        merged.update(overrides)
    old = getattr(_ctx, "value", None)
    _ctx.value = MeshContext(mesh, merged)
    try:
        yield _ctx.value
    finally:
        if old is None:
            del _ctx.value
        else:
            _ctx.value = old


def mesh_shape(mesh) -> dict[str, int]:
    """Axis name -> size: a DeviceMesh's named dims, else ``mesh.shape``
    taken as a mapping."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, tuple(mesh.mesh.shape)))
    return dict(mesh.shape)


def _flat(cand) -> tuple:
    return cand if isinstance(cand, tuple) else (cand,)


def _mesh_axis_size(sizes: dict, axis) -> int:
    return math.prod(sizes[a] for a in _flat(axis))


def resolve_spec(axes: tuple, shape: tuple | None = None, *,
                 strict: bool = True, mesh=None,
                 rules: dict | None = None) -> tuple:
    """Logical axes tuple -> spec under the active rule table: a tuple
    with one entry per dim up to the last sharded one, each a mesh axis,
    a tuple of mesh axes, or None (the entries of the reference's
    PartitionSpec).

    strict=True (parameters, caches): a candidate is used only if it
    divides the dim evenly; otherwise try the next, else replicate.
    strict=False: the first candidate whose axes exist and are free."""
    ctx = _get_ctx()
    mesh = mesh or ctx.mesh
    rules = rules or ctx.rules
    if mesh is None:
        return ()
    sizes = mesh_shape(mesh)
    used: set = set()
    parts = []
    for i, name in enumerate(axes):
        cands = rules.get(name, ()) if name is not None else ()
        chosen = None
        for cand in cands:
            flat = _flat(cand)
            if any(a not in sizes for a in flat):
                continue
            if any(a in used for a in flat):
                continue
            if strict and shape is not None:
                if shape[i] % _mesh_axis_size(sizes, cand) != 0:
                    continue
            chosen = cand
            break
        if chosen is not None:
            used.update(_flat(chosen))
        parts.append(chosen)
    while parts and parts[-1] is None:
        parts.pop()
    return tuple(parts)


@dataclasses.dataclass(frozen=True)
class Sharding:
    """A resolved placement on ``mesh``: ``spec`` (``resolve_spec``'s
    tuple) names, per dim, the mesh axis or axes it is split over. A dim
    split over axes (a, b) is cut into size(a) * size(b) equal blocks,
    and the rank at coordinates (i, j) holds block i * size(b) + j."""
    mesh: Any
    spec: tuple

    def coords(self) -> dict[str, int]:
        """This process's index on each mesh axis (a DeviceMesh's)."""
        names = self.mesh.mesh_dim_names
        return {n: self.mesh.get_local_rank(n) for n in names}

    def dim_slices(self, shape, coords: dict | None = None) -> tuple:
        """One slice per dim of ``shape``: the part the rank at
        ``coords`` (default: this process) holds."""
        sizes = mesh_shape(self.mesh)
        out = []
        for i, n in enumerate(shape):
            part = self.spec[i] if i < len(self.spec) else None
            if part is None:
                out.append(slice(0, n))
                continue
            coords = self.coords() if coords is None else coords
            block, count = 0, 1
            for a in _flat(part):
                block = block * sizes[a] + coords[a]
                count *= sizes[a]
            if n % count:
                raise ValueError(f"dim {i} of {tuple(shape)} does not split "
                                 f"into {count} equal parts ({part})")
            w = n // count
            out.append(slice(block * w, (block + 1) * w))
        return tuple(out)

    def local_shape(self, shape) -> tuple:
        """The shape of every rank's block (the same on each)."""
        first = {a: 0 for a in mesh_shape(self.mesh)}
        return tuple(s.stop - s.start
                     for s in self.dim_slices(tuple(shape), first))

    def shard(self, value, coords: dict | None = None):
        """The rank's block of the full ``value``."""
        return value[self.dim_slices(tuple(value.shape), coords)]


def make_sharding(axes: tuple, shape: tuple | None = None, *, strict=True,
                  mesh=None, rules: dict | None = None):
    """The ``Sharding`` of a value with these logical axes (None without
    a mesh)."""
    ctx = _get_ctx()
    mesh = mesh or ctx.mesh
    if mesh is None:
        return None
    return Sharding(mesh, resolve_spec(axes, shape, strict=strict,
                                       mesh=mesh, rules=rules))


def logical_constraint(x, *axes):
    """Returns ``x`` as it is. In the reference this pins an activation's
    layout for XLA; here the blocks compute on local shards and call
    their collectives explicitly, so there is nothing to pin."""
    return x


def tree_shardings(axes_tree, shapes_tree, *, mesh=None, rules=None):
    """Shardings for a whole tree (strict): ``axes_tree``'s tuples beside
    ``shapes_tree``'s leaves (anything with ``.shape``)."""
    return tree_map(
        lambda axes, shp: make_sharding(axes, tuple(shp.shape), strict=True,
                                        mesh=mesh, rules=rules),
        axes_tree, shapes_tree)
