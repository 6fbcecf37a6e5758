"""The port's dry run (``repro_torch/launch/dryrun.py``) and production
meshes (``launch/mesh.py::make_production_mesh``) against the reference's.

  * ``make_production_mesh`` raises without a process group of 256 / 512
    ranks, and over one (a fake group) is the reference's (16, 16)
    ("data", "model") or (2, 16, 16) ("pod", "data", "model") layout.
  * ``run_cell`` reports ``ok``, or ``skipped`` with the reference's
    reason exactly where the reference skips, for every assigned arch and
    shape cell at smoke size (the smoke configs; the cells' kinds at 16
    tokens x 8 rows) on (data, model) = (2, 2) and on (pod, data, model) =
    (2, 2, 2), the MoE archs on meta tensors included. Its
    ``argument_bytes`` is the sum of the local shapes the reference's
    ``resolve_spec`` gives each of the cell's inputs (params, optimizer
    state, batch, step; the serve dtype's params and the cache), also for
    the full configs on the production meshes.
  * ``--list`` prints the reference's cells (the reference's in a
    subprocess: its module sets XLA_FLAGS when it is imported).

The fake group (torch's ``fake`` backend, 512 ranks) is started by a
module fixture, which destroys it.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.analysis import hlo_cost as H  # noqa: E402
from repro_torch.configs import registry as TR  # noqa: E402
from repro_torch.launch import dryrun as D  # noqa: E402
from repro_torch.launch import mesh as LM  # noqa: E402
from repro_torch.launch import shapes as TSH  # noqa: E402
from repro_torch.launch import steps as TS  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
ARCHS = sorted(TR.assigned_archs())
SMOKE = {name: TSH.ShapeCell(name, 16, 8, cell.kind)
         for name, cell in TSH.SHAPES.items()}
MESHES = {"single": ((2, 2), ("data", "model")),
          "multi": ((2, 2, 2), ("pod", "data", "model"))}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op torch thread for this module's small models: the suite
    runs several workers on the host's cores, and a torch pool of one
    thread a core in each slows small-model tests many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_production_mesh_needs_a_process_group():
    """(First in the module: no group is up yet.)"""
    with pytest.raises(RuntimeError, match="at least 256 ranks"):
        LM.make_production_mesh(device="meta")


@pytest.fixture(scope="module")
def meshes():
    D.start_fake_group(D.FAKE_WORLD)
    try:
        yield {name: LM.make_mesh_auto(shape, axes, device="meta")
               for name, (shape, axes) in MESHES.items()}
    finally:
        D.stop_fake_group()


@pytest.fixture(scope="module")
def cells(meshes):
    return {(a, s, m): D.run_cell(a, s, m, smoke=True, shape=SMOKE[s],
                                  mesh=meshes[m])
            for a in ARCHS for s in SMOKE for m in MESHES}


def test_production_meshes(meshes):
    single = LM.make_production_mesh(device="meta")
    multi = LM.make_production_mesh(multi_pod=True, device="meta")
    assert tuple(single.mesh.shape) == (16, 16)
    assert single.mesh_dim_names == ("data", "model")
    assert tuple(multi.mesh.shape) == (2, 16, 16)
    assert multi.mesh_dim_names == ("pod", "data", "model")
    assert LM.dp_axes(multi) == ("pod", "data")
    assert single.mesh.flatten().tolist() == list(range(256))


@pytest.mark.parametrize("arch", ARCHS)
def test_every_cell_is_ok_or_the_references_skip(cells, arch):
    from repro.configs import registry as JR
    from repro.launch import shapes as JSH
    jc = JR.get(arch, smoke=True)
    for s in SMOKE:
        for m in MESHES:
            res = cells[(arch, s, m)]
            if not JSH.applicable(jc, JSH.SHAPES[s]):
                assert res["status"] == "skipped", (arch, s, m)
                assert res["reason"].startswith("full-attention arch: 512k")
                continue
            assert res["status"] == "ok", (arch, s, m, res)
            assert res["n_devices"] == int(np.prod(MESHES[m][0]))
            r, mem = res["roofline"], res["memory"]
            assert r["flops_per_device"] > 0 and r["hbm_bytes_per_device"] > 0
            assert r["bottleneck"] in ("compute", "memory", "collective")
            assert 0 < r["mfu_bound"] < 1
            assert r["collective_count_by_kind"]["all-reduce"] > 0
            if m == "multi" and SMOKE[s].kind == "train":
                # the data mean spans the pod axis
                assert r["collectives_by_axis"]["pod"]["all-reduce"][
                    "calls"] > 0
            assert mem["peak_estimate_bytes"] == mem["argument_bytes"] + \
                mem["output_bytes"] + mem["temp_bytes"] - mem["alias_bytes"]
            assert mem["peak_estimate_bytes"] >= mem["argument_bytes"] > 0
            assert res["count_s"] >= 0


def _ref_local_bytes(jc, jshape, mesh_sizes, serve_dtype="bfloat16"):
    """The bytes of a cell's inputs on one rank: every leaf's local shape
    under the reference's resolve_spec (DEFAULT_RULES, strict)."""
    import jax.numpy as jnp

    from repro.launch import shapes as JSH
    from repro.launch import steps as JS
    from repro.models import model as JM
    from repro.parallel import partition as JP

    class Mesh:
        shape = dict(mesh_sizes)

    def leaves(axes, specs, dtype=None):
        total = 0
        if isinstance(specs, dict):
            return sum(leaves(axes[k], specs[k], dtype) for k in specs)
        shape = tuple(specs.shape)
        spec = tuple(JP.resolve_spec(tuple(axes), shape, strict=True,
                                     mesh=Mesh, rules=JP.DEFAULT_RULES))
        spec += (None,) * (len(shape) - len(spec))
        n = 1
        for size, p in zip(shape, spec):
            names = () if p is None else ((p,) if isinstance(p, str) else p)
            n *= size // int(np.prod([mesh_sizes[a] for a in names]))
        dt = jnp.dtype(specs.dtype)
        if dtype and jnp.issubdtype(dt, jnp.floating):
            dt = jnp.dtype(dtype)
        total += n * dt.itemsize
        return total

    pshapes, paxes = JM.abstract_params(jc)
    specs = JSH.input_specs(jc, jshape)
    total = leaves(JSH.batch_axes(jc, jshape), specs["batch"])
    if jshape.kind == "train":
        opt = {"m": pshapes, "v": pshapes,
               "count": np.zeros((), np.int32)}
        return total + leaves(paxes, pshapes) + leaves(
            JS.opt_state_axes(paxes), opt) + 4
    total += leaves(paxes, pshapes, serve_dtype)
    if jshape.kind == "decode":
        total += leaves(JM.cache_axes(jc), specs["cache"])
    return total


@pytest.mark.parametrize("arch", ARCHS)
def test_argument_bytes_are_the_references_local_shapes(cells, meshes, arch):
    from repro.configs import registry as JR
    from repro.launch import shapes as JSH
    for m, (shape, axes) in MESHES.items():
        sizes = dict(zip(axes, shape))
        for s in SMOKE:
            res = cells[(arch, s, m)]
            if res["status"] != "ok":
                continue
            jshape = JSH.ShapeCell(s, 16, 8, SMOKE[s].kind)
            want = _ref_local_bytes(JR.get(arch, smoke=True), jshape, sizes)
            assert res["memory"]["argument_bytes"] == want, (arch, s, m)


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "mixtral-8x22b"])
def test_full_config_argument_bytes_on_the_production_meshes(meshes, arch):
    """The full config's inputs on the production meshes (build_cell's
    meta args; tests/test_torch_shapes.py holds every arch's local
    shapes at (16, 16))."""
    from repro.configs import registry as JR
    from repro.launch import shapes as JSH
    full, jfull = TR.get(arch), JR.get(arch)
    for multi in (False, True):
        mesh = LM.make_production_mesh(multi_pod=multi, device="meta")
        sizes = dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))
        for s, cell in TSH.SHAPES.items():
            if not TSH.applicable(full, cell):
                continue
            got = H._argument_bytes(TS.build_cell(full, cell, mesh)[1])
            assert got == _ref_local_bytes(jfull, JSH.SHAPES[s], sizes), \
                (arch, s, multi)


def test_list_prints_the_references_cells(capsys):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    ref = subprocess.run([sys.executable, "-m", "repro.launch.dryrun",
                          "--list"], capture_output=True, text=True,
                         env=env, cwd=ROOT, timeout=300)
    assert ref.returncode == 0, ref.stderr
    D.main(["--list"])
    got = capsys.readouterr().out
    assert got == ref.stdout
    assert len(got.splitlines()) == len(ARCHS) * len(TSH.SHAPES) * 2
