"""The collectives of tensor-parallel serving, called by the blocks on
local shards (Megatron-style; the reference leaves them to XLA).

Each rank holds its shards of the weights (``models/model.py::
shard_params``). A block calls into here only where a sharded dim is
contracted or must be whole again:

  * a row-parallel product (``wo`` over sharded heads, ``w_down`` over a
    sharded ``mlp``, Mamba's ``x_proj`` and ``out_proj`` over a sharded
    ``dinner``): each rank's partial product in f32, summed over the
    group in f32, then cast to the compute dtype. TP=1 rounds the whole
    product to the compute dtype once; so does this, after summing f32
    partials, so the two differ only by the order of f32 additions.
  * a vocab-parallel embedding lookup: ids outside the rank's rows look
    up zeros, and the sum over the group (f32) is exact;
  * a dim that must be whole (vocab-sharded logits, the router's
    expert-sharded logits): each rank writes its block into zeros and the
    group sums them, exactly, so every rank holds the same bits.

Every collective is one ``all_reduce`` (sum) over the mesh's ``model``
axis: gloo takes it on CPU and CUDA tensors alike, and no other
collective is needed. The group is read from the active
``partition.axis_rules`` context; without a mesh there a sharded weight
raises rather than compute a partial answer.

Training differentiates through them as Megatron's pair does. Every rank
computes the same loss, so a sum over the group (``_Exit``: the
row-parallel sum, the vocab-parallel lookup, ``gather_last``) is the
identity backward, not another sum, which would scale the gradient by
the group's size. Where a replicated value enters a column-parallel
product, or any computation on the rank's own shards (``enter``:
identity forward), each rank's gradient of it is a partial one, and the
backward sums them over the group. A leaf held whole but read only by
the rank's shards (qwen3's ``q_norm``; kv heads whole while heads shard)
enters the same way, so its gradient is the whole sum on every rank.
"""
from __future__ import annotations

import functools

import torch
import torch.distributed as dist

from . import partition as part


class Collectives:
    """The collectives a rank's group ran, counted by (mesh axis, kind):
    ``by_kind[(axis, kind)] = [calls, bytes]``, the bytes of each
    collective's result on this rank (what a step costs;
    ``analysis/hlo_cost.py`` reads them). ``calls`` / ``bytes`` are the
    totals; ``reset()`` zeroes them."""

    def __init__(self):
        self.by_kind: dict[tuple, list] = {}

    def reset(self) -> None:
        self.by_kind = {}

    def count(self, axis: str, kind: str, nbytes: int) -> None:
        c = self.by_kind.setdefault((axis, kind), [0, 0])
        c[0] += 1
        c[1] += nbytes

    @property
    def calls(self) -> int:
        return sum(c[0] for c in self.by_kind.values())

    @property
    def bytes(self) -> int:
        return sum(c[1] for c in self.by_kind.values())


class TPGroup(Collectives):
    """One rank's tensor-parallel group: the process group over the
    mesh's ``model`` axis, this rank's index on it and the group's size,
    with the counts of the collectives it ran (``Collectives``)."""

    def __init__(self, mesh):
        super().__init__()
        self.group = mesh.get_group("model")
        self.rank = mesh.get_local_rank("model")
        self.size = part.mesh_shape(mesh)["model"]

    def all_reduce(self, x, op=dist.ReduceOp.SUM):
        """Reduce ``x`` over the group (a sum unless ``op``), in place;
        returns it."""
        dist.all_reduce(x, op=op, group=self.group)
        self.count("model", "all-reduce", x.numel() * x.element_size())
        return x

    def sum_f32(self, x):
        """The group's sum of ``x`` taken in f32 (a new tensor), cast back
        to ``x``'s dtype."""
        return self.all_reduce(x.to(torch.float32, copy=True)).to(x.dtype)


@functools.lru_cache(maxsize=None)
def group_of(mesh) -> TPGroup:
    return TPGroup(mesh)


def current() -> TPGroup:
    """The active mesh's TP group; raises without one (a sharded weight
    outside the mesh context would give a partial answer)."""
    mesh = part.current_mesh()
    if mesh is None:
        raise RuntimeError("sharded weights need their mesh: run under "
                           "partition.axis_rules(mesh, rules)")
    return group_of(mesh)


class _Exit(torch.autograd.Function):
    """Forward: the group's sum (in ``x``'s dtype), in place on ``x`` (a
    temporary of the caller's). Backward: the identity (every rank holds
    the loss's whole gradient of the sum)."""

    @staticmethod
    def forward(ctx, x, g):
        ctx.mark_dirty(x)
        return g.all_reduce(x)

    @staticmethod
    def backward(ctx, gy):
        return gy, None


class _Enter(torch.autograd.Function):
    """Forward: the identity. Backward: the group's f32 sum of the ranks'
    partial gradients."""

    @staticmethod
    def forward(ctx, x, g):
        ctx.g = g
        return x.view_as(x)

    @staticmethod
    def backward(ctx, gy):
        return ctx.g.sum_f32(gy), None


def enter(x):
    """``x`` (replicated on every rank) where it enters computation on the
    rank's shards: the identity, whose gradient is summed over the
    group."""
    return _Enter.apply(x, current())


def row_parallel(x, w, matmul=torch.matmul):
    """``matmul(x, w)`` over a contracted dim that each rank holds a
    block of: the f32 partial products summed over the group, cast to
    ``x``'s dtype."""
    out = matmul(x.to(torch.float32), w.to(torch.float32))
    return _Exit.apply(out, current()).to(x.dtype)


def gather_last(local, full: int):
    """Each rank's block of the last dim -> the whole dim (``full``), the
    same bits on every rank; the gradient is the rank's own block of the
    whole one."""
    g = current()
    n = local.shape[-1]
    out = local.new_zeros(tuple(local.shape[:-1]) + (full,))
    out[..., g.rank * n:(g.rank + 1) * n] = local
    return _Exit.apply(out, g)


def vocab_rows(lookup, table, ids):
    """``lookup(table, ids)`` on a vocab-sharded ``table`` [V / n, ...]:
    this rank's rows of its id range, zeros elsewhere, in f32 (the sum
    over the group, ``vocab_sum``, is exact)."""
    g = current()
    v0 = g.rank * table.shape[0]
    local = ids - v0
    own = (local >= 0) & (local < table.shape[0])
    rows = lookup(table, torch.where(own, local, 0)).to(torch.float32)
    return rows * own[..., None]


def vocab_sum(rows):
    """The group's sum of ``vocab_rows``' blocks: every row whole."""
    return _Exit.apply(rows, current())
