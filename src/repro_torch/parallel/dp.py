"""The data axes of sharded training: FSDP of the leaves that resolve to
``data``, the data mean of the gradients and the sums a sharded step
needs over every mesh axis (port-only: the reference leaves all of it to
XLA).

The batch is split over every batch axis of the mesh
(``launch/mesh.py::dp_axes``: ``pod``, then ``data``, the rule table's
("pod", "data") candidate), so the data mean, the gradients' sum, the
norm and the int8 scale span them all. FSDP shards over ``data`` alone:
a leaf is replicated over ``pod``, whose replicas' gradients are summed
like any replicated leaf's.

A train state on a (data, model) mesh is cut by ``launch/steps.py::
train_shardings`` (``DEFAULT_RULES``): a leaf dim that resolves to
``data`` ("embed", and "expert" where ``data`` divides it) is FSDP. The
rank stores its block of the master param and of AdamW's ``m`` and
``v``; the step gathers the leaf over ``data`` where a layer uses it
(``FSDP.gather_layer``, inside the layer's remat region, so ``remat=
"block"`` gathers it again in the backward), into the layout the
tensor-parallel blocks read, and the gather's backward reduce-scatters
the gradient back. Leaves replicated over ``data`` have their gradients
summed by one ``all_reduce`` of a flat buffer over each batch axis
(``FSDP.reduce_grads``; the FSDP blocks over ``pod``); then every
gradient is scaled by 1 / (the batch ranks): the data mean.

Every rank computes the global loss (``mean``: an ``all_reduce`` mean
whose backward is the identity, so rank i differentiates only its own
rows' term and the data mean of the gradients is the global gradient).
The MoE aux loss is no mean of per-row terms: ``models/layers.py::
_route`` takes the data mean of its per-expert statistics before their
product, so every rank holds the global aux.

Collectives are the ``torch.distributed`` ones the group's backend
takes (gloo and nccl take ``all_gather_into_tensor`` and
``reduce_scatter_tensor``); every rank issues the same ones in the same
order, since gloo pairs them by order.
"""
from __future__ import annotations

import functools
import math

import torch
import torch.distributed as dist

from repro_torch.launch.mesh import dp_axes
from repro_torch.optim.adamw import tree_leaves, tree_map

from . import partition as part
from . import tp


def _bytes(x) -> int:
    return x.numel() * x.element_size()


def all_gather(x, dim: int, group, size: int):
    """Each rank's block of dim ``dim`` -> the whole dim, blocks in the
    group's rank order. Returns (whole, bytes received)."""
    out = x.new_empty(size * x.numel())        # flat: every backend's form
    dist.all_gather_into_tensor(out, x.contiguous().view(-1), group=group)
    out = out.view((size,) + tuple(x.shape))
    return out.movedim(0, dim).flatten(dim, dim + 1), _bytes(out)


class DPGroup(tp.Collectives):
    """One rank's data-parallel groups. The batch is split over the mesh's
    batch axes (``dp_axes``, pod-major): ``size`` ranks, of which this
    rank is ``rank``; ``all_reduce`` spans them (``data``, then ``pod``).
    FSDP gathers and scatters over ``data`` alone: ``group`` is its
    process group, ``data_size`` its size. The collectives it ran are
    counted by axis and kind (``tp.Collectives``)."""

    def __init__(self, mesh):
        super().__init__()
        sizes = part.mesh_shape(mesh)
        axes = dp_axes(mesh)
        self.size, self.rank = 1, 0
        for a in axes:
            self.size *= sizes[a]
            self.rank = self.rank * sizes[a] + mesh.get_local_rank(a)
        # the axes a sum spans, the fast one first
        self.axes = tuple(a for a in reversed(axes) if sizes[a] > 1)
        self.groups = {a: mesh.get_group(a) for a in self.axes}
        self.group = mesh.get_group("data")
        self.data_size = sizes["data"]

    def all_reduce(self, x, op=dist.ReduceOp.SUM, axes=None):
        """Reduce ``x`` over the batch axes (or those of ``axes`` the sum
        spans), one axis after the other, in place; returns it."""
        for a in self.axes:
            if axes is None or a in axes:
                dist.all_reduce(x, op=op, group=self.groups[a])
                self.count(a, "all-reduce", _bytes(x))
        return x

    def all_gather(self, x, dim: int):
        out, n = all_gather(x, dim, self.group, self.data_size)
        self.count("data", "all-gather", n)
        return out

    def reduce_scatter(self, x, dim: int):
        """The ``data`` group's sum of ``x``, of which this rank keeps its
        block of dim ``dim``."""
        n = x.shape[dim] // self.data_size
        parts = x.unflatten(dim, (self.data_size, n)).movedim(dim, 0) \
            .contiguous()
        out = x.new_empty(parts[0].numel())
        dist.reduce_scatter_tensor(out, parts.view(-1), group=self.group)
        self.count("data", "reduce-scatter", _bytes(out))
        return out.view(parts.shape[1:])


def batch_ranks(mesh) -> int:
    """How many ranks the batch is split over."""
    sizes = part.mesh_shape(mesh)
    return math.prod(sizes[a] for a in dp_axes(mesh))


@functools.lru_cache(maxsize=None)
def group_of(mesh) -> DPGroup:
    return DPGroup(mesh)


def current() -> DPGroup | None:
    """The active mesh's data groups; None without a mesh or where the
    batch is not split (nothing to reduce)."""
    mesh = part.current_mesh()
    if mesh is None or batch_ranks(mesh) == 1:
        return None
    return group_of(mesh)


class _Gather(torch.autograd.Function):
    """Forward: the whole leaf from the ranks' blocks of dim ``dim``.
    Backward: the gradient's sum over the group, the rank's block kept."""

    @staticmethod
    def forward(ctx, x, dim, g):
        ctx.dim, ctx.g = dim, g
        return g.all_gather(x, dim)

    @staticmethod
    def backward(ctx, gy):
        return ctx.g.reduce_scatter(gy, ctx.dim), None, None


class _Mean(torch.autograd.Function):
    """Forward: the group's mean. Backward: the identity (every rank
    computes the same loss from it; the gradients' data mean follows)."""

    @staticmethod
    def forward(ctx, x, g):
        return g.all_reduce(x.clone()) / g.size

    @staticmethod
    def backward(ctx, gy):
        return gy, None


def mean(x):
    """The data mean of ``x`` (each rank's value of its own rows) over
    every batch axis, the identity where the batch is not split."""
    g = current()
    return x if g is None else _Mean.apply(x, g)


def local_rows(batch: dict, rank: int, size: int, microbatches: int = 1):
    """Rank ``rank``'s rows of a global batch (leading dim B): of each of
    the ``microbatches`` consecutive row blocks, the rank's share, so the
    rank's microbatch m holds its rows of the global microbatch m (the
    reference's split, MoE aux and gshard groups included)."""
    out = {}
    for k, v in batch.items():
        B = v.shape[0]
        if B % (size * microbatches):
            raise ValueError(f"batch of {B} rows does not split into "
                             f"{size} data ranks x {microbatches} "
                             "microbatches")
        blocks = v.unflatten(0, (microbatches, size, B // (size
                                                           * microbatches)))
        out[k] = blocks[:, rank].flatten(0, 1)
    return out


def _dim_of(spec: tuple, axis: str) -> int | None:
    """The dim that ``spec`` splits over ``axis`` alone (None if none)."""
    for i, p in enumerate(spec):
        if p == axis:
            return i
        if isinstance(p, tuple) and axis in p:
            raise NotImplementedError(
                f"dim {i} split over {p}: a train leaf shards over one "
                "mesh axis a dim")
    return None


class FSDP:
    """A train state's layout on a ([pod,] data, model) mesh and the
    step's work on it: ``shardings`` is the params' tree of
    ``partition.Sharding`` (``launch/steps.py::train_shardings``); ``m``,
    ``v`` and the error buffers share it. ``dp`` is the FSDP degree (the
    ``data`` axis), ``group`` the data groups (None where the batch is not
    split)."""

    def __init__(self, mesh, shardings):
        self.mesh = mesh
        sizes = part.mesh_shape(mesh)
        self.dp, self.tp = sizes.get("data", 1), sizes.get("model", 1)
        self.shardings = shardings
        self.group = group_of(mesh) if batch_ranks(mesh) > 1 else None
        self.tp_group = tp.group_of(mesh) if self.tp > 1 else None
        self.dims = tree_map(
            lambda sh: _dim_of(sh.spec, "data") if self.dp > 1 else None,
            shardings)
        coords = {a: mesh.get_local_rank(a) for a in sizes}

        def owner(sh):
            # the rank that counts a leaf's block: index 0 on every axis
            # the leaf is replicated over
            held = {a for p in sh.spec if p is not None
                    for a in part._flat(p)}
            return all(coords[a] == 0 for a in sizes if a not in held)

        self.owner = tree_map(owner, shardings)

    # -- forward ----------------------------------------------------------
    def _gather(self, tree, dims, shift: int = 0):
        def one(t, d):
            return t if d is None else _Gather.apply(t, d - shift,
                                                     self.group)
        return tree_map(one, tree, dims)

    def gather_top(self, params):
        """``params`` with every leaf outside ``blocks`` whole over
        ``data`` (the layer stack is gathered a layer at a time)."""
        return {k: v if k == "blocks" else self._gather(v, self.dims[k])
                for k, v in params.items()}

    def gather_layer(self, layer):
        """One layer's parameters (``model._layers``' views: the stacked
        leaves without their layer dim) whole over ``data``."""
        return self._gather(layer, self.dims["blocks"], shift=1)

    def gather_params(self, params):
        """The whole tree over ``data`` (every layer at once)."""
        return self._gather(params, self.dims)

    # -- after the backward ------------------------------------------------
    def reduce_grads(self, grads):
        """The data mean of the gradients: the leaves replicated over
        ``data`` summed over every batch axis by one ``all_reduce`` of a
        flat f32 buffer an axis, the FSDP leaves (reduce-scattered over
        ``data`` by the gather's backward) over ``pod`` likewise, then
        every leaf times 1 / (the batch ranks)."""
        if self.group is None:
            return grads
        pairs = list(zip(tree_leaves(grads), tree_leaves(self.dims)))
        rep = [g for g, d in pairs if d is None]
        blocks = [g for g, d in pairs if d is not None]
        for leaves, axes in ((rep, None), (blocks, ("pod",))):
            if not leaves or not any(axes is None or a in axes
                                     for a in self.group.axes):
                continue
            flat = self.group.all_reduce(torch.cat(
                [g.reshape(-1).to(torch.float32) for g in leaves]), axes=axes)
            for g, s in zip(leaves, flat.split([g.numel() for g in leaves])):
                g.copy_(s.view_as(g))
        inv = 1.0 / self.group.size
        return tree_map(lambda g: g * inv, grads)

    def sum_all(self, x, op=dist.ReduceOp.SUM):
        """``x`` reduced over the whole mesh (model, then the batch axes),
        in place: the same bits on every rank."""
        if self.tp_group is not None:
            self.tp_group.all_reduce(x, op=op)
        if self.group is not None:
            self.group.all_reduce(x, op=op)
        return x

    def global_norm(self, grads):
        """The global norm of sharded gradients: every element counted
        once (a block held by several ranks only by its owner), summed
        over the mesh."""
        sq = [torch.sum(torch.square(g.to(torch.float32))) * float(own)
              for g, own in zip(tree_leaves(grads), tree_leaves(self.owner))]
        return torch.sqrt(self.sum_all(torch.stack(sq).sum()))

    def reduce_max(self, x):
        """``x`` (per-leaf maxima of the rank's blocks) -> the maxima over
        each whole leaf."""
        return self.sum_all(x, op=dist.ReduceOp.MAX)

    # -- checkpoints ------------------------------------------------------
    def whole(self, tree, keep: bool = True):
        """A tree laid out like the params (params, ``m``, ``v``, error
        buffers) -> every leaf whole on the host (gathered over both
        axes a leaf at a time); None leaves where not ``keep`` (every rank
        joins the gathers, one keeps the result)."""
        def one(t, sh, key):
            for axis, g, n in (("model", self.tp_group, self.tp),
                               ("data", self.group, self.dp)):
                d = _dim_of(sh.spec, axis)
                if d is None or n == 1:
                    continue
                if key == "in_proj" and axis == "model":
                    # the x | z halves are cut apart (model.shard_params)
                    t = torch.cat([all_gather(h, d, g.group, n)[0]
                                   for h in t.chunk(2, dim=-1)], dim=-1)
                else:
                    t = all_gather(t, d, g.group, n)[0]
            return t.cpu() if keep else None

        def walk(t, sh, key=None):
            if isinstance(t, dict):
                return {k: walk(v, sh[k], k) for k, v in t.items()}
            return one(t, sh, key)

        return walk(tree, self.shardings)
