"""The port's dry-run cells against the reference's
(``repro_torch/launch/shapes.py`` and ``steps.build_cell`` vs
``repro/launch/shapes.py`` and ``repro/launch/steps.py::build_cell``).

``SHAPES``, ``is_subquadratic`` and ``applicable`` equal the reference's.
For every assigned arch (full config), every applicable shape and meshes
{data, model} = (1, 1), (1, 2), (2, 2) and (16, 16), each of
``build_cell``'s args (meta tensors: one rank's params, optimizer state,
batch and cache) has the local shape and dtype the reference's
``input_specs`` / ``batch_axes`` / ``opt_state_axes`` /
``abstract_params`` / ``cache_spec`` resolve to under its
``resolve_spec`` (``DEFAULT_RULES``, strict), on a stand-in mesh whose
``.shape`` maps axis names to sizes.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import registry as JR  # noqa: E402
from repro.launch import shapes as JSH  # noqa: E402
from repro.launch import steps as JS  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.parallel import partition as JP  # noqa: E402
from repro_torch.configs import registry as TR  # noqa: E402
from repro_torch.launch import shapes as TSH  # noqa: E402
from repro_torch.launch import steps as TS  # noqa: E402

ARCHS = sorted(JR.assigned_archs())
MESHES = ((1, 1), (1, 2), (2, 2), (16, 16))


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op torch thread for this module's small models: the suite
    runs several workers on the host's cores, and a torch pool of one
    thread a core in each slows small-model tests many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class Mesh:
    def __init__(self, data, model):
        self.shape = {"data": data, "model": model}


def _is_axes(t) -> bool:
    return isinstance(t, tuple) and all(isinstance(e, (str, type(None)))
                                        for e in t)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def _local(axes, sds, mesh):
    """(local shape, dtype name) of a reference leaf under its resolved
    spec."""
    shape = tuple(sds.shape)
    spec = tuple(JP.resolve_spec(tuple(axes), shape, strict=True, mesh=mesh,
                                 rules=JP.DEFAULT_RULES))
    spec += (None,) * (len(shape) - len(spec))
    out = []
    for n, p in zip(shape, spec):
        names = () if p is None else ((p,) if isinstance(p, str) else p)
        out.append(n // int(np.prod([mesh.shape[a] for a in names])))
    return tuple(out), str(sds.dtype)


def _want(axes_tree, specs_tree, mesh, dtype=None):
    axes, specs = _flat(axes_tree), _flat(specs_tree)
    assert set(axes) == set(specs), set(axes) ^ set(specs)
    out = {}
    for k in specs:
        shape, dt = _local(axes[k], specs[k], mesh)
        if dtype and "float" in dt:
            dt = dtype
        out[k] = (shape, dt)
    return out


def _got(tree):
    return {k: (tuple(t.shape), str(t.dtype).replace("torch.", ""))
            for k, t in _flat(tree).items()}


@functools.lru_cache(maxsize=None)
def _reference(arch):
    jc = JR.get(arch)
    shapes, axes = JM.abstract_params(jc)
    return jc, shapes, axes


def test_shapes_and_applicability_equal_the_reference():
    assert list(TSH.SHAPES) == list(JSH.SHAPES)
    for name, cell in JSH.SHAPES.items():
        got = TSH.SHAPES[name]
        assert (got.name, got.seq_len, got.global_batch, got.kind) == \
            (cell.name, cell.seq_len, cell.global_batch, cell.kind)
    for arch in ARCHS:
        jc, tc = JR.get(arch), TR.get(arch)
        assert TSH.is_subquadratic(tc) == JSH.is_subquadratic(jc)
        for name in JSH.SHAPES:
            assert TSH.applicable(tc, TSH.SHAPES[name]) == \
                JSH.applicable(jc, JSH.SHAPES[name]), (arch, name)
    # and the specs of one cell, unsharded: the reference's global shapes
    tc, jc = TR.get("qwen2-vl-2b"), JR.get("qwen2-vl-2b")
    for name in JSH.SHAPES:
        want = JSH.input_specs(jc, JSH.SHAPES[name])
        got = TSH.input_specs(tc, TSH.SHAPES[name])
        assert {k: (tuple(v.shape), str(v.dtype)) for k, v in
                _flat(want).items()} == _got(got), name


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
@pytest.mark.parametrize("arch", ARCHS)
def test_build_cell_args_are_the_reference_resolution(arch, mesh):
    jc, pshapes, paxes = _reference(arch)
    tc = TR.get(arch)
    stand_in = Mesh(*mesh)
    cells = [n for n, c in JSH.SHAPES.items() if JSH.applicable(jc, c)]
    assert cells == [n for n, c in TSH.SHAPES.items()
                     if TSH.applicable(tc, c)]
    for name in cells:
        jshape, tshape = JSH.SHAPES[name], TSH.SHAPES[name]
        fn, args = TS.build_cell(tc, tshape, stand_in)
        assert callable(fn)
        specs = JSH.input_specs(jc, jshape)
        batch = _want(JSH.batch_axes(jc, jshape), specs["batch"], stand_in)
        if tshape.kind == "train":
            params, opt, tbatch, step = args
            ostate = {"m": pshapes, "v": pshapes,
                      "count": np.zeros((), np.int32)}
            assert _got(params) == _want(paxes, pshapes, stand_in), name
            axes = JS.opt_state_axes(paxes)
            assert _got(opt) == _want(axes, ostate, stand_in), name
            assert (tuple(step.shape), step.dtype) == ((), torch.int32)
        else:
            params, tbatch = args[:2]
            assert _got(params) == _want(paxes, pshapes, stand_in,
                                         dtype="bfloat16"), name
        assert _got(tbatch) == batch, name
        if tshape.kind == "decode":
            cache = _want(JM.cache_axes(jc), specs["cache"], stand_in)
            assert _got(args[2]) == cache, name
        for arg in args:
            for t in _flat(arg).values():
                assert t.device.type == "meta"
