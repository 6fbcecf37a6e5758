"""The gatecount-driven autotuner of the port (``repro_torch.core.autotune``)
against the reference's (``repro.core.autotune``).

- The grid: every candidate's tag, NAND2 gates and fixed-datapath max
  error equal the reference's exactly (the datapaths are bitwise).
- The search: both ``greedy_assign``s, driven by one scripted eval (a
  table of losses by tag tuple: accepts, a tie at the budget, a sweep
  that accepts nothing, a slack that runs two rounds), make the same
  decisions, history, evals and log lines.
- The oracle: ``eval_fn_of`` on the reference's olmo-1b smoke params and
  held-out batches, at f32, within ``EVAL_REL_TOL`` of the reference's
  ``make_eval_fn`` loss under three assignments, whose reference losses
  lie further apart than twice that limit: a port that ignored the
  assignment, or gave a layer another layer's unit, would fail (the mix
  with its layers swapped reads 5.5e-5 above the mix).
- ``train_smoke`` trains on the CPU and returns finite params.
"""
import ast
import dataclasses
import pathlib

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import registry as JR  # noqa: E402
from repro.core import autotune as JA  # noqa: E402
from repro.data import DataConfig as JDataConfig  # noqa: E402
from repro.data import SyntheticPipeline as JPipeline  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch.configs import registry as TR  # noqa: E402
from repro_torch.core import autotune as TA  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
N_GRID = len(JA.FULL_GRID) + 1          # the grid and the baseline


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread for these small models: the suite runs several
    workers on the host's cores, and a torch pool of one thread a core in
    each slows small-model tests up to ~70x (tests/test_torch_examples.py;
    six concurrent runs of this file take ~31 s each with one thread)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def grids():
    ref = JA.candidate_grid(JA.FULL_GRID) + [JA.candidate_of(JA.BASELINE_ACT)]
    port = TA.candidate_grid(TA.FULL_GRID, device="cpu") \
        + [TA.candidate_of(TA.BASELINE_ACT, device="cpu")]
    return ref, port


def _public(path):
    tree = ast.parse(path.read_text())
    names = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            names.update(t.id for t in node.targets
                         if isinstance(t, ast.Name))
    return {n for n in names if not n.startswith("_")}


def test_every_public_name_of_the_reference():
    ref = _public(ROOT / "src" / "repro" / "core" / "autotune.py")
    assert ref and ref <= set(dir(TA)), sorted(ref - set(dir(TA)))


@pytest.mark.parametrize("i", range(N_GRID))
def test_candidate_matches_reference(grids, i):
    ref, port = grids
    a, b = ref[i], port[i]
    assert b.tag == a.tag
    assert b.gates == a.gates and b.max_err == a.max_err
    assert b.row() == a.row()


def test_grids_and_baseline_constants(grids):
    assert TA.FULL_GRID == JA.FULL_GRID
    assert TA.REDUCED_GRID == JA.REDUCED_GRID
    assert TA.BASELINE_ACT.tag() == JA.BASELINE_ACT.tag() == "cr_fixed-d64"
    red_j = JA.candidate_grid(JA.REDUCED_GRID)
    red_t = TA.candidate_grid(TA.REDUCED_GRID, device="cpu")
    assert [c.row() for c in red_t] == [c.row() for c in red_j]


def test_candidate_of_rejects_a_float_datapath():
    with pytest.raises(ValueError, match="_fixed"):
        TA.candidate_of(dataclasses.replace(TA.BASELINE_ACT, impl="cr"),
                        device="cpu")


# scripted evals: loss = 1 + the sum of each layer's penalty by tag, with
# some whole assignments overridden by table entries
SCENARIOS = {
    # pwl_fixed-d32 hurts, the Q2.10 PWL is free (a tie at the budget),
    # poly_fixed-d8 helps
    "accept_and_tie": dict(pen={"pwl_fixed-d32": 0.01,
                                "pwl_fixed-d64-q2.10": 0.0,
                                "poly_fixed-d8": -0.002},
                           default=0.003, slack=0.0, table={}),
    # every cheaper unit hurts: nothing is accepted
    "no_candidate": dict(pen={}, default=0.004, slack=0.0, table={}),
    # a slack: a later layer's cheaper unit lowers the loss, and the
    # table makes layer 0's first rejected swap fit in the second round
    "slack_rounds": dict(pen={"poly_fixed-d16": -0.006,
                              "pwl_fixed-d32": 0.015},
                         default=0.05, slack=0.011,
                         table={("pwl_fixed-d32", "pwl_fixed-d32",
                                 "poly_fixed-d16"): 1.0}),
}


def _scripted(sc):
    def eval_fn(layer_cfgs):
        key = tuple(c.tag() for c in layer_cfgs)
        if key in sc["table"]:
            return sc["table"][key]
        return 1.0 + sum(sc["pen"].get(t, sc["default"]) if t != "cr_fixed-d64"
                         else 0.0 for t in key)
    return eval_fn


def _search(pkg, cands, sc):
    lines = []
    res = pkg.greedy_assign(_scripted(sc), 3, cands[:-1], cands[-1],
                            budget_slack=sc["slack"], log=lines.append)
    return res, lines


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_greedy_assign_makes_the_reference_decisions(grids, name):
    sc = SCENARIOS[name]
    (rj, lj), (rt, lt) = (_search(JA, grids[0], sc),
                          _search(TA, grids[1], sc))
    assert [c.tag for c in rt.assignment] == [c.tag for c in rj.assignment]
    assert rt.history == rj.history
    assert (rt.base_loss, rt.loss, rt.evals) == (rj.base_loss, rj.loss,
                                                 rj.evals)
    assert (rt.gates, rt.base_gates) == (rj.gates, rj.base_gates)
    assert lt == lj
    if name == "no_candidate":
        assert rt.history == [] and rt.loss == rt.base_loss
        # one sweep: every cheaper candidate of every layer, once
        cheaper = sum(c.gates < rt.baseline.gates for c in grids[1][:-1])
        assert rt.evals == 1 + 3 * cheaper
    elif name == "accept_and_tie":
        assert any(h["loss"] == rt.base_loss for h in rt.history)
    else:
        assert {h["round"] for h in rt.history} == {0, 1}


# ---------------------------------------------------------------------------
# the model in the loop: olmo-1b smoke at f32, the reference's params and
# batches
# ---------------------------------------------------------------------------

EVAL_BATCH, EVAL_SEQ = 2, 16
ASSIGNMENTS = {
    "uniform_cr_fixed_d64": ("cr_fixed-d64", "cr_fixed-d64"),
    "uniform_pwl_fixed_d32": ("pwl_fixed-d32", "pwl_fixed-d32"),
    "mix_q2_10": ("cr_fixed-d64", "pwl_fixed-d64-q2.10"),
}
# The untrained smoke model's loss sits near ln(V), and a unit moves it by
# 7e-6 to 6e-5 absolute (~1e-6 to 8e-6 relative). Port against reference
# read 0 to 1.42e-7 relative (at most 2 float32 ulps of a loss of ~6.72)
# on these assignments, so the limit is ~2x that: wide enough for one
# Q2.13 LSB flipped under another GEMM order, and narrow enough that a
# wrong unit on one layer shows.
EVAL_REL_TOL = 3e-7


def _olmo(reg):
    base = reg.get("olmo-1b", smoke=True)
    return dataclasses.replace(base, activation=JA.BASELINE_ACT
                               if reg is JR else TA.BASELINE_ACT,
                               compute_dtype="float32")


@pytest.fixture(scope="module")
def olmo():
    jcfg, tcfg = _olmo(JR), _olmo(TR)
    jparams, _ = JM.materialize_params(jcfg, seed=0)
    pipe = JPipeline(jcfg, JDataConfig(seed=1234, vocab_size=jcfg.vocab_size),
                     EVAL_BATCH, EVAL_SEQ)
    jbatches = [pipe(i) for i in range(2)]
    tparams = TM.params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg,
                                   device="cpu")
    tbatches = [{k: torch.from_numpy(np.array(v)) for k, v in b.items()}
                for b in jbatches]
    ref_eval = JA.make_eval_fn(jcfg, jparams, batch=EVAL_BATCH, seq=EVAL_SEQ)
    return dict(tcfg=tcfg, jcfg=jcfg, ref_eval=ref_eval,
                eval_fn=TA.eval_fn_of(tcfg, tparams, tbatches))


def _tags(act_cls, name):
    return tuple(act_cls.from_tag(t) for t in ASSIGNMENTS[name])


@pytest.fixture(scope="module")
def ref_losses(olmo):
    from repro.core.activations import ActivationConfig as JAct
    return {n: olmo["ref_eval"](_tags(JAct, n)) for n in ASSIGNMENTS}


@pytest.mark.parametrize("name", sorted(ASSIGNMENTS))
def test_eval_fn_matches_reference(olmo, ref_losses, name):
    from repro_torch.core.activations import ActivationConfig as TAct
    ref = ref_losses[name]
    got = olmo["eval_fn"](_tags(TAct, name))
    assert np.isfinite(got)
    assert abs(got - ref) <= EVAL_REL_TOL * abs(ref), (got, ref)
    # the limit can tell this assignment from every other one: a port
    # within it of this loss is further than it from any other's
    for other, loss in ref_losses.items():
        if other != name:
            assert abs(loss - ref) > 2 * EVAL_REL_TOL * abs(ref), (other,
                                                                   loss, ref)


def test_eval_fn_keeps_no_graph_and_is_deterministic(olmo):
    from repro_torch.core.activations import ActivationConfig as TAct
    tags = tuple(TAct.from_tag(t) for t in ASSIGNMENTS["mix_q2_10"])
    assert olmo["eval_fn"](tags) == olmo["eval_fn"](tags)


def test_train_smoke_returns_finite_params():
    cfg = dataclasses.replace(TR.get("olmo-1b", smoke=True),
                              activation=TA.BASELINE_ACT)
    params = TA.train_smoke(cfg, steps=2, batch=2, seq=16, device="cpu")
    init = TM.materialize_params(cfg, seed=0, device="cpu")
    leaves = [(k, v) for k, v in params["blocks"]["ffn"].items()]
    assert leaves
    for k, v in leaves:
        assert torch.isfinite(v).all(), k
    # the warmup lr is 0 at step 0 and positive at step 1: the weights moved
    assert not torch.equal(params["blocks"]["ffn"][leaves[0][0]],
                           init["blocks"]["ffn"][leaves[0][0]])
    eval_fn = TA.make_eval_fn(cfg, params, batch=2, seq=16, eval_batches=1,
                              device="cpu")
    assert np.isfinite(eval_fn((TA.BASELINE_ACT,) * cfg.n_layers))


def test_default_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TA.candidate_of(TA.BASELINE_ACT)
