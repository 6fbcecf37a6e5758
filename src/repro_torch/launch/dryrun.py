"""Dry run: every (arch x shape x mesh) cell's per-rank cost, memory and
H100 roofline, from the port's own step on meta tensors (the counterpart
of ``repro/launch/dryrun.py``, which lowers and compiles each cell with
XLA against placeholder TPU devices).

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun              # all cells
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-34b \\
        --shape train_4k --mesh single                           # one cell
    PYTHONPATH=src python -m repro_torch.launch.dryrun --list

The process joins torch's fake process group (``fake``: every collective
returns at once, nothing is sent) as rank 0 of FAKE_WORLD ranks, and lays
the production meshes over it (``launch/mesh.py::make_production_mesh``:
(16, 16) "single", (2, 16, 16) "multi", on the meta device). Each cell's
step (``launch/steps.py::build_cell``) runs on one rank's inputs as meta
tensors, so nothing is allocated or computed and the card is never
touched, wherever the process runs. ``analysis/hlo_cost.py::count_cell``
counts it (a layer per block kind and a Mamba time step, multiplied by
their counts) and ``analysis/roofline.py`` turns the counts into H100
time terms. Results are cached incrementally in
experiments/dryrun_torch/*.json; pass --force to recompute.
"""
from __future__ import annotations

import argparse
import json
import time
import traceback
from pathlib import Path

from repro_torch.analysis import hlo_cost
from repro_torch.analysis import roofline as rl
from repro_torch.configs import registry
from repro_torch.launch import shapes as shp
from repro_torch.launch import steps as steps_mod
from repro_torch.launch.mesh import make_production_mesh

RESULTS_DIR = Path(__file__).resolve().parents[3] / "experiments" / \
    "dryrun_torch"

MESHES = {"single": False, "multi": True}
FAKE_WORLD = 512                # ranks of the fake group: both meshes fit


def start_fake_group(world: int = FAKE_WORLD) -> None:
    """Join a fake process group of ``world`` ranks as rank 0 (the
    process's default group; ``torch.distributed.destroy_process_group``
    leaves it)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


def stop_fake_group() -> None:
    """Leave the fake group, and forget the collective groups made on its
    meshes (``parallel/tp.py``, ``dp.py`` keep one a mesh)."""
    import torch.distributed as dist

    from repro_torch.parallel import dp, tp
    dist.destroy_process_group()
    tp.group_of.cache_clear()
    dp.group_of.cache_clear()


def run_cell(arch: str, shape_name: str, mesh_name: str, *,
             rules: dict | None = None, hyper=None, tag: str = "",
             smoke: bool = False, shape=None, mesh=None) -> dict:
    """One cell's record. ``smoke`` takes the arch's smoke config,
    ``shape`` a ``shapes.ShapeCell`` in place of ``SHAPES[shape_name]``,
    ``mesh`` a DeviceMesh in place of the production one (both for
    tests). Needs an initialised process group of the mesh's size
    (``start_fake_group``)."""
    cfg = registry.get(arch, smoke=smoke)
    shape = shape or shp.SHAPES[shape_name]
    if not shp.applicable(cfg, shape):
        return {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                "status": "skipped",
                "reason": "full-attention arch: 512k dense KV cache is the "
                          "quadratic regime long_500k excludes (DESIGN.md §5)"}
    if mesh is None:
        mesh = make_production_mesh(multi_pod=MESHES[mesh_name],
                                    device="meta")
    n_dev = mesh.size()
    hyper = hyper or steps_mod.TrainHyper()
    t0 = time.time()
    totals = hlo_cost.count_cell(cfg, shape, mesh, rules=rules, hyper=hyper)
    t_count = time.time() - t0
    mem = totals.memory
    roof = rl.analyze(totals, n_devices=n_dev,
                      model_flops=rl.model_flops_for(cfg, shape), mesh=mesh)
    return {
        "arch": arch, "shape": shape_name, "mesh": mesh_name, "tag": tag,
        "status": "ok",
        "n_devices": n_dev,
        "count_s": round(t_count, 2),
        "memory": {
            "argument_bytes": mem["argument_bytes"],
            "output_bytes": mem["output_bytes"],
            "temp_bytes": mem["temp_bytes"],
            "alias_bytes": mem["alias_bytes"],
            "peak_estimate_bytes": mem["argument_bytes"]
                + mem["output_bytes"] + mem["temp_bytes"]
                - mem["alias_bytes"],
        },
        "roofline": {
            "flops_per_device": roof.flops,
            "hbm_bytes_per_device": roof.hbm_bytes,
            "collective_bytes_per_device": roof.collective_bytes,
            "compute_s": roof.compute_s,
            "memory_s": roof.memory_s,
            "collective_s": roof.collective_s,
            "bottleneck": roof.bottleneck,
            "model_flops": roof.model_flops,
            "useful_ratio": roof.useful_ratio,
            "mfu_bound": roof.mfu_bound,
            "collective_bytes_by_kind": roof.collectives.bytes_by_kind,
            "collective_count_by_kind": roof.collectives.count_by_kind,
            "flops_by_dtype": roof.flops_by_dtype,
            "collectives_by_axis": {
                a: {k: {"calls": c, "bytes": b} for k, (c, b) in kinds.items()}
                for a, kinds in totals.collectives_by_axis.items()},
            "collective_s_by_axis": roof.collective_s_by_axis,
            "link_bw_by_axis": roof.link_bw_by_axis,
            "kernels": dict(totals.kernels),
            "transcendentals": totals.transcendentals,
        },
    }


def cell_path(arch, shape, mesh, tag="") -> Path:
    suffix = f"__{tag}" if tag else ""
    return RESULTS_DIR / f"{arch}__{shape}__{mesh}{suffix}.json"


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--arch", default=None)
    p.add_argument("--shape", default=None, choices=list(shp.SHAPES) + [None])
    p.add_argument("--mesh", default=None, choices=["single", "multi", None])
    p.add_argument("--force", action="store_true")
    p.add_argument("--list", action="store_true")
    p.add_argument("--tag", default="")
    args = p.parse_args(argv)

    archs = [args.arch] if args.arch else registry.assigned_archs()
    shapes = [args.shape] if args.shape else list(shp.SHAPES)
    meshes = [args.mesh] if args.mesh else ["single", "multi"]

    if args.list:
        for a in archs:
            for s in shapes:
                for m in meshes:
                    print(f"{a} x {s} x {m}")
        return

    start_fake_group()
    RESULTS_DIR.mkdir(parents=True, exist_ok=True)
    failures = []
    for a in archs:
        for s in shapes:
            for m in meshes:
                path = cell_path(a, s, m, args.tag)
                if path.exists() and not args.force:
                    cached = json.loads(path.read_text())
                    print(f"[cached] {a} x {s} x {m}: {cached['status']}")
                    continue
                print(f"[run]    {a} x {s} x {m} ...", flush=True)
                try:
                    res = run_cell(a, s, m, tag=args.tag)
                except Exception as e:  # noqa: BLE001 — record and continue
                    res = {"arch": a, "shape": s, "mesh": m, "tag": args.tag,
                           "status": "error", "error": str(e)[:2000],
                           "traceback": traceback.format_exc()[-4000:]}
                    failures.append((a, s, m, str(e)[:200]))
                path.write_text(json.dumps(res, indent=1))
                st = res["status"]
                if st == "ok":
                    r = res["roofline"]
                    print(f"         ok: count {res['count_s']}s "
                          f"| bottleneck {r['bottleneck']} "
                          f"| mfu_bound {r['mfu_bound']:.3f} "
                          f"| peak/dev {res['memory']['peak_estimate_bytes']/2**30:.2f} GiB",
                          flush=True)
                else:
                    print(f"         {st}: {res.get('reason', res.get('error', ''))[:200]}",
                          flush=True)
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for f in failures:
            print("  ", *f)
        raise SystemExit(1)
    print("\nall requested cells done")


if __name__ == "__main__":
    main()
