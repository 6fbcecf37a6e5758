"""Meshes over ``torch.distributed`` process groups (counterpart of
``repro/launch/mesh.py``).

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` with named dims
(``("data", "model")``, or ``("pod", "data", "model")``) over ranks of an
initialised process group. ``make_production_mesh`` gives the reference's
production layouts (16 x 16 and 2 x 16 x 16); only the dry run uses them,
over a fake process group of that many ranks (``launch/dryrun.py``).

The backend is the caller's choice, never switched behind its back:
``default_backend`` gives ``nccl`` on CUDA and ``gloo`` on the CPU; ranks
that share one card must ask for ``gloo`` by name (NCCL refuses two ranks
on one device), and ``check_backend`` raises on ``nccl`` there.
``spawn_ranks`` starts a group of rank processes on one host.
"""
from __future__ import annotations

import datetime
import math
import os
import pickle
import tempfile
import traceback
from pathlib import Path

import torch
import torch.distributed as dist

MESH_AXES = ("data", "model")
POD_MESH_AXES = ("pod", "data", "model")


def make_mesh_auto(shape: tuple, axes: tuple, *, device="cuda",
                   ranks=None):
    """A DeviceMesh of ``shape`` named ``axes`` over ``ranks`` (default the
    first prod(shape) ranks of the world), row-major. Every rank of the
    world must make the same call (its groups are created collectively);
    a rank outside ``ranks`` gets a mesh it is not on."""
    from torch.distributed.device_mesh import DeviceMesh
    if not dist.is_initialized():
        raise RuntimeError("make_mesh_auto needs an initialised process "
                           "group (launch/mesh.py::init_distributed)")
    n = 1
    for s in shape:
        n *= s
    ranks = list(range(n)) if ranks is None else list(ranks)
    if len(ranks) != n:
        raise ValueError(f"{len(ranks)} ranks for a {shape} mesh")
    if max(ranks) >= dist.get_world_size():
        raise ValueError(f"ranks {ranks} exceed the world of "
                         f"{dist.get_world_size()}")
    return DeviceMesh(torch.device(device).type,
                      torch.tensor(ranks).reshape(shape),
                      mesh_dim_names=tuple(axes))


def make_host_mesh(data: int = 1, model: int = 1, *, device="cuda",
                   backend: str | None = None, ranks=None):
    """A (data, model) mesh over ranks of the initialised process group
    (the reference's tests / examples mesh). ``backend``, when given,
    must be the group's: a mesh never switches backend."""
    if backend is not None and dist.is_initialized() \
            and dist.get_backend() != backend:
        raise ValueError(f"the process group runs {dist.get_backend()!r}, "
                         f"not {backend!r}")
    return make_mesh_auto((data, model), MESH_AXES, device=device,
                          ranks=ranks)


def make_production_mesh(*, multi_pod: bool = False, device="cuda"):
    """The production mesh: (16, 16) over ("data", "model"), or with
    ``multi_pod`` (2, 16, 16) over ("pod", "data", "model"), whose ``pod``
    axis carries only data-parallel traffic. A DeviceMesh over the first
    256 / 512 ranks of the initialised process group, which must have at
    least that many (the dry run starts a fake one); raises otherwise."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    n = math.prod(shape)
    if not dist.is_initialized() or dist.get_world_size() < n:
        have = dist.get_world_size() if dist.is_initialized() else 0
        raise RuntimeError(f"the production mesh {shape} needs a process "
                           f"group of at least {n} ranks (got {have})")
    return make_mesh_auto(shape, POD_MESH_AXES if multi_pod else MESH_AXES,
                          device=device)


def dp_axes(mesh) -> tuple:
    names = mesh.mesh_dim_names
    return tuple(a for a in ("pod", "data") if a in names)


def default_backend(device) -> str:
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def check_backend(backend: str, device, world: int) -> None:
    """Raise where ``backend`` cannot serve ``world`` ranks on ``device``:
    NCCL needs a CUDA device of its own for every rank."""
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"unknown backend {backend!r} (nccl | gloo)")
    if backend != "nccl":
        return
    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError(f"the nccl backend needs CUDA devices; device="
                         f"{dev.type!r} takes --dist-backend gloo")
    cards = torch.cuda.device_count()
    if world > cards:
        raise ValueError(
            f"the nccl backend needs a card per rank: {world} ranks on "
            f"{cards} card(s) share a device, which NCCL refuses; ask for "
            "--dist-backend gloo")


def init_distributed(rank: int, world: int, *, backend: str, device,
                     init_method: str, timeout_s: float = 600.0):
    """Join the process group as ``rank`` of ``world`` over
    ``init_method`` (``file://...`` or ``tcp://localhost:PORT``) with
    ``backend`` (checked by ``check_backend``). Returns this rank's
    device: ``device`` as named, or for a bare "cuda" the rank's own card
    where there is one for every rank, else card 0, which the ranks
    then share."""
    check_backend(backend, device, world)
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        own = world <= torch.cuda.device_count()
        dev = torch.device("cuda", rank if own else 0)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=timeout_s))
    return dev


def _rank_entry(rank, fn, world, backend, device, init_method, out_dir,
                args, threads):
    if threads:
        torch.set_num_threads(threads)
    try:
        dev = init_distributed(rank, world, backend=backend, device=device,
                               init_method=init_method)
        result = fn(rank, world, dev, *args)
        dist.barrier()
        dist.destroy_process_group()
    except BaseException:
        (Path(out_dir) / f"rank{rank}.err").write_text(
            traceback.format_exc())
        raise
    with open(Path(out_dir) / f"rank{rank}.pkl", "wb") as f:
        pickle.dump(result, f)


def spawn_ranks(fn, world: int, *, backend: str, device, args=(),
                threads: int | None = None) -> list:
    """Run ``fn(rank, world, device, *args)`` in ``world`` spawned rank
    processes that have joined one process group (``backend``, a file
    store under the temporary directory); returns their results in rank
    order. ``fn`` must be importable by name (a module-level function).
    If a rank fails, the others are stopped and every failed rank's
    traceback is raised here. ``threads`` pins each rank's torch threads."""
    import torch.multiprocessing as tmp
    from torch.multiprocessing.spawn import ProcessException
    check_backend(backend, device, world)
    if str(device).startswith("cuda"):
        from repro_torch.kernels import _build
        _build.build()            # ranks load this build, none compiles
    with tempfile.TemporaryDirectory() as out_dir:
        init_method = "file://" + os.path.join(out_dir, "store")
        try:
            tmp.start_processes(
                _rank_entry, nprocs=world, start_method="spawn", args=(
                    fn, world, backend, str(device), init_method, out_dir,
                    tuple(args), threads))
        except ProcessException as e:     # a rank raised or was killed
            errs = sorted(Path(out_dir).glob("rank*.err"))
            detail = "\n".join(f"{p.stem}: {p.read_text()}" for p in errs)
            raise RuntimeError(f"a rank failed:\n{detail or e}") from None
        results = []
        for r in range(world):
            with open(Path(out_dir) / f"rank{r}.pkl", "rb") as f:
                results.append(pickle.load(f))
    return results
