"""The port's spans (``repro_torch.spans``): with no profiler recording a
span is one shared no-op that records nothing; under a CPU
``torch.profiler`` run the serve engine (one-shot and token-budget
schedules), the train step and the attention branch open their spans
with the right parents, and serve the same tokens and make the same
params as without a profiler."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch import spans  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.serve import EngineConfig, ServeEngine  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op torch thread for this module's small models: the suite
    runs several workers on the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _fresh():
    spans.reset()
    yield
    spans.reset()


@pytest.fixture(scope="module")
def dense():
    cfg = registry.get("qwen3-0.6b", smoke=True, compute_dtype="float32")
    return cfg, M.materialize_params(cfg, seed=0, device="cpu")


def profiled(fn):
    """(fn()'s result, the names of the profiler's events) of one CPU
    profiler run around ``fn``."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, {e.name for e in prof.events()}


def test_span_is_the_shared_noop_without_a_profiler():
    assert not torch.autograd._profiler_enabled()
    a, b = spans.span("serve.step"), spans.span("train.step")
    assert a is spans.OFF and b is spans.OFF
    with a, b:
        pass
    assert spans.device_ms() == {}


def test_spans_nest_and_reset():
    def run():
        with spans.span("outer"):
            with spans.span("inner"):
                pass
            with spans.span("inner"):
                pass

    _, names = profiled(run)
    assert {"repro.outer", "repro.inner"} <= names
    d = spans.device_ms()
    assert set(d) == {"outer", "inner", "outer/inner"}
    assert d["outer"][0] == 1 and d["inner"][0] == d["outer/inner"][0] == 2
    assert d["outer"][1] >= d["inner"][1] >= 0.0
    assert spans.device_ms() == d            # resolved once, kept
    spans.reset()
    assert spans.device_ms() == {}


def serve(cfg, params, **kw):
    rng = np.random.RandomState(3)
    eng = ServeEngine(cfg, params, EngineConfig(
        slots=2, chunk=4, page_size=5, max_prompt_len=32, max_len=48, **kw),
        device="cpu")
    for n in (7, 19, 12):
        eng.submit(rng.randint(0, 512, (n,)), max_new=6)
    return [c.tokens for c in eng.run()], eng


def test_serve_spans_one_shot(dense):
    cfg, params = dense
    want, _ = serve(cfg, params)
    assert spans.device_ms() == {}
    (got, eng), names = profiled(lambda: serve(cfg, params))
    assert got == want
    assert {"repro.serve." + n for n in ("step", "admit", "prefill", "insert",
                                         "pages", "decode", "harvest")} <= names
    d = spans.device_ms()
    for key in ("serve.step/serve.admit", "serve.admit/serve.prefill",
                "serve.admit/serve.insert", "serve.step/serve.pages",
                "serve.step/serve.decode", "serve.step/serve.harvest",
                "serve.prefill/model.attention",
                "serve.decode/model.attention"):
        assert key in d, (key, sorted(d))
    parents = {k.rsplit("/", 1)[0] for k in d if k.endswith("/serve.prefill")}
    assert parents == {"serve.admit"}
    st = eng.stats
    assert d["serve.decode"][0] == st.decode_chunks
    assert d["serve.prefill"][0] == st.prefill_batches
    assert d["serve.decode/model.attention"][0] == \
        st.decode_steps * cfg.n_layers
    # each span brackets what its EngineStats field times
    assert d["serve.prefill"][1] >= 1e3 * st.prefill_s
    assert d["serve.insert"][1] >= 1e3 * st.insert_s
    assert d["serve.decode"][1] >= 1e3 * st.decode_s
    assert "serve.prefill_chunk" not in d


def test_serve_spans_chunked(dense):
    cfg, params = dense
    kw = dict(chunk_prefill=4, token_budget=8)
    want, _ = serve(cfg, params, **kw)
    (got, eng), names = profiled(lambda: serve(cfg, params, **kw))
    assert got == want
    assert "repro.serve.prefill_chunk" in names
    d = spans.device_ms()
    assert d["serve.prefill_chunk"][0] == eng.stats.prefill_chunks
    assert "serve.decode/serve.prefill_chunk" in d
    assert "serve.prefill" not in d and "serve.insert" not in d
    assert d["serve.decode"][0] == eng.stats.decode_chunks


@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_spans(dense, microbatches):
    cfg, params = dense
    step = steps.make_train_step(
        cfg, steps.TrainHyper(microbatches=microbatches))
    g = torch.Generator().manual_seed(5)
    batch = {k: torch.randint(0, cfg.vocab_size, (2, 16), generator=g)
             for k in ("tokens", "labels")}
    want, _, _ = step(params, adamw.init_state(params), batch, 1)
    assert spans.device_ms() == {}
    (got, _, _), names = profiled(
        lambda: step(params, adamw.init_state(params), batch, 1))
    assert {"repro.train." + n for n in ("step", "forward", "backward",
                                         "optimizer")} <= names
    for a, b in zip(adamw.tree_leaves(want), adamw.tree_leaves(got)):
        assert torch.equal(a, b)
    d = spans.device_ms()
    assert d["train.step"][0] == 1
    for name in ("forward", "backward"):
        assert d[f"train.step/train.{name}"][0] == microbatches
    assert d["train.step/train.optimizer"][0] == 1
    assert "train.reduce" not in d
    assert d["train.forward/model.attention"][0] == \
        microbatches * cfg.n_layers
    # remat "block": the backward runs each block's forward again
    assert d["train.backward/model.attention"][0] == \
        microbatches * cfg.n_layers
