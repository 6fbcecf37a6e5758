"""The port's partition rules against the reference's
(``repro_torch/parallel/partition.py`` vs ``repro/parallel/partition.py``).

Resolution is pure logic: for every assigned arch and ``paper_tanh``, full
and smoke, the port's ``abstract_params`` shapes and axes, the four cache
spec / axes functions and the resolved spec of every leaf equal the
reference's, at meshes {data, model} = (1, 1), (1, 2), (1, 4), (2, 2) and
(16, 16), under ``DEFAULT_RULES`` and ``serve_rules()``, strict and not.
Both resolve on a stand-in mesh object whose ``.shape`` maps axis names to
sizes, which is all either reads.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import registry as JR  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.parallel import partition as JP  # noqa: E402
from repro_torch.configs import registry as TR  # noqa: E402
from repro_torch.launch import steps as TS  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.parallel import partition as TP  # noqa: E402

ARCHS = sorted(JR.assigned_archs()) + ["paper_tanh"]
MESHES = ((1, 1), (1, 2), (1, 4), (2, 2), (16, 16))
RULES = {"default": (JP.DEFAULT_RULES, TP.DEFAULT_RULES),
         "serve": (JP.serve_rules(), TP.serve_rules())}


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


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


def _dtype(d) -> str:
    return str(d).replace("torch.", "")


@functools.lru_cache(maxsize=None)
def _abstract(arch, smoke):
    jc, tc = JR.get(arch, smoke=smoke), TR.get(arch, smoke=smoke)
    js, ja = JM.abstract_params(jc)
    ts, ta = TM.abstract_params(tc)
    return jc, tc, js, ja, ts, ta


def _specs_equal(axes_flat, shapes_flat):
    """Every leaf's resolved spec, port == reference, at every mesh, rule
    table and strictness."""
    for data, model in MESHES:
        mesh = Mesh(data, model)
        for jr, tr in RULES.values():
            for strict in (True, False):
                for key, axes in axes_flat.items():
                    shape = tuple(shapes_flat[key].shape)
                    want = JP.resolve_spec(tuple(axes), shape, strict=strict,
                                           mesh=mesh, rules=jr)
                    got = TP.resolve_spec(tuple(axes), shape, strict=strict,
                                          mesh=mesh, rules=tr)
                    assert got == tuple(want), (key, data, model, strict)


@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
@pytest.mark.parametrize("arch", ARCHS)
def test_abstract_params_and_specs_match_reference(arch, smoke):
    jc, tc, js, ja, ts, ta = _abstract(arch, smoke)
    jsf, tsf = _flat(js), _flat(ts)
    assert set(jsf) == set(tsf)
    for key in jsf:
        assert tuple(tsf[key].shape) == tuple(jsf[key].shape), key
        assert _dtype(tsf[key].dtype) == str(jsf[key].dtype), key
        assert tsf[key].device.type == "meta"
    jaf, taf = _flat(ja), _flat(ta)
    assert {k: tuple(v) for k, v in jaf.items()} == taf
    _specs_equal(taf, tsf)
    for data, model in MESHES:
        for _, tr in RULES.values():
            got = _flat(TP.tree_shardings(ta, ts, mesh=Mesh(data, model),
                                          rules=tr))
            for key, sh in got.items():
                assert sh.spec == TP.resolve_spec(
                    taf[key], tuple(tsf[key].shape), mesh=Mesh(data, model),
                    rules=tr)


@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_specs_and_axes_match_reference(arch, smoke):
    jc, tc = JR.get(arch, smoke=smoke), TR.get(arch, smoke=smoke)
    pairs = [(JM.cache_spec(jc, 3, 40), TM.cache_spec(tc, 3, 40),
              JM.cache_axes(jc), TM.cache_axes(tc)),
             (JM.cache_spec(jc, 3, 40, per_slot=True),
              TM.cache_spec(tc, 3, 40, per_slot=True),
              JM.cache_axes(jc, per_slot=True),
              TM.cache_axes(tc, per_slot=True))]
    if jc.has_attention or jc.parallel_mamba:
        pairs.append((JM.paged_cache_spec(jc, 3, 9, 16, 40),
                      TM.paged_cache_spec(tc, 3, 9, 16, 40),
                      JM.paged_cache_axes(jc), TM.paged_cache_axes(tc)))
    else:
        for fn in (JM.paged_cache_spec, TM.paged_cache_spec):
            with pytest.raises(ValueError, match="nothing to page"):
                fn(jc if fn is JM.paged_cache_spec else tc, 3, 9, 16, 40)
    for js, ts, ja, ta in pairs:
        jsf, tsf = _flat(js), _flat(ts)
        assert set(jsf) == set(tsf)
        for key in jsf:
            assert tuple(tsf[key].shape) == tuple(jsf[key].shape), key
            assert _dtype(tsf[key].dtype) == str(jsf[key].dtype), key
        jaf, taf = _flat(ja), _flat(ta)
        assert {k: tuple(v) for k, v in jaf.items()} == taf
        _specs_equal(taf, tsf)


def test_serve_shardings_match_reference_specs():
    """steps.serve_shardings: the parameter and paged-cache specs are the
    reference's strict resolution under serve_rules; the rest replicated."""
    cfg, jc = TR.get("hymba-1.5b"), JR.get("hymba-1.5b")
    mesh = Mesh(1, 4)
    psh, csh, rep = TS.serve_shardings(cfg, 2, 160, mesh, page_size=16,
                                       n_pages=21)
    assert rep.spec == ()
    js, ja = JM.abstract_params(jc)
    rules = JP.serve_rules()
    jsf, jaf = _flat(js), _flat(ja)
    for key, sh in _flat(psh).items():
        assert sh.spec == tuple(JP.resolve_spec(
            tuple(jaf[key]), tuple(jsf[key].shape), mesh=mesh, rules=rules))
    spec = JM.paged_cache_spec(jc, 2, 21, 16, 160)
    cax = _flat(JM.paged_cache_axes(jc))
    for key, sh in _flat(csh).items():
        assert sh.spec == tuple(JP.resolve_spec(
            tuple(cax[key]), tuple(_flat(spec)[key].shape), mesh=mesh,
            rules=rules))
    # hymba at TP=4: 25 heads stay whole, d_inner 3200 splits
    assert _flat(psh)["blocks/attn/wq"].spec == (None, "data")
    assert _flat(psh)["blocks/mamba/out_proj"].spec == (None, "model", "data")


def test_rules_context_and_helpers():
    assert TP.serve_rules()["batch"] == () and TP.serve_rules(
        {"mlp": ()})["mlp"] == ()
    assert TP.serve_rules() == {k: tuple(v) if isinstance(v, tuple) else v
                                for k, v in JP.serve_rules().items()}
    assert TP.resolve_spec(("mlp",), (8,)) == ()          # no mesh: whole
    with TP.axis_rules(Mesh(1, 2), overrides={"mlp": ()}) as ctx:
        assert TP.current_mesh() is ctx.mesh
        assert TP.resolve_spec(("embed", "mlp"), (8, 8)) == ("data",)
        assert TP.resolve_spec(("heads",), (4,)) == ("model",)
        with TP.axis_rules(None):
            assert TP.make_sharding(("heads",), (4,)) is None
        assert TP.current_mesh() is ctx.mesh
    assert TP.current_mesh() is None
    x = torch.ones(2, 3)
    assert TP.logical_constraint(x, "batch", "act_embed") is x
    b = TP.box(("embed", "mlp"), torch.zeros(2, 3))
    assert TP.is_boxed(b) and not TP.is_boxed(b.value)
    vals, axes = TP.unbox_tree({"a": b, "n": {"s": TP.box((), torch.ones(()))}})
    assert axes == {"a": ("embed", "mlp"), "n": {"s": ()}}
    assert vals["a"] is b.value
    with pytest.raises(AssertionError):
        TP.box(("embed",), torch.zeros(2, 3))


@pytest.mark.parametrize("spec,mesh", [
    (("model",), (1, 4)), ((None, ("data", "model")), (2, 2)),
    (("data", "model"), (2, 2)), ((), (2, 2))])
def test_sharding_blocks_tile_the_whole(spec, mesh):
    """Each rank's block (``Sharding.shard``) at every coordinate: blocks
    of the right local shape that together hold every element once."""
    data, model = mesh
    full = torch.arange(8 * 12).reshape(8, 12)
    sh = TP.Sharding(Mesh(data, model), spec)
    seen = torch.zeros_like(full)
    for d in range(data):
        for m in range(model):
            blk = sh.shard(full, {"data": d, "model": m})
            assert tuple(blk.shape) == sh.local_shape(full.shape)
            seen[sh.dim_slices(full.shape, {"data": d, "model": m})] += 1
    sizes = {"data": data, "model": model}
    blocks = int(np.prod([sizes[a] for part in spec if part is not None
                          for a in (part if isinstance(part, tuple)
                                    else (part,))]))
    assert torch.all(seen == data * model // blocks)
