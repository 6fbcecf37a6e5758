"""The port's synthetic pipeline: the invariants of ``tests/test_data.py``
(determinism, shifted labels, host slicing, modality entries, vocab
range, learnable structure), and its Markov transition rule held against
rows the reference's ``_markov_rows`` made. The values differ from the
reference's by construction (torch's generator, not ``jax.random``)."""
import dataclasses

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.data import DataConfig as JDataConfig  # noqa: E402
from repro.data import pipeline as JPL  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.data import DataConfig, SyntheticPipeline, eval_batches  # noqa: E402
from repro_torch.data import pipeline as TPL  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op torch thread for this module's small models: the suite
    runs several workers on the host's cores, and a torch pool of one
    thread a core in each slows small-model tests many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(**over):
    cfg = registry.get("qwen3-0.6b", smoke=True)
    return dataclasses.replace(cfg, **over) if over else cfg


def _pipe(gb=8, seq=32, seed=0, cfg=None, **kw):
    return SyntheticPipeline(cfg or _cfg(),
                             DataConfig(seed=seed, vocab_size=512), gb, seq,
                             device="cpu", **kw)


def test_deterministic_across_instances():
    a, b = _pipe(seed=3), _pipe(seed=3)
    for step in (0, 7, 1000):
        ba, bb = a(step), b(step)
        assert set(ba) == {"tokens", "labels"}
        for k in ba:
            assert torch.equal(ba[k], bb[k])


def test_different_steps_and_seeds_differ():
    p = _pipe()
    assert not torch.equal(p(0)["tokens"], p(1)["tokens"])
    assert not torch.equal(p(0)["tokens"], _pipe(seed=1)(0)["tokens"])


def test_labels_are_shifted_tokens_int32_on_device():
    b = _pipe()(5)
    assert torch.equal(b["tokens"][:, 1:], b["labels"][:, :-1])
    for v in b.values():
        assert v.dtype == torch.int32 and v.device.type == "cpu"
        assert tuple(v.shape) == (8, 32)


def test_host_sharding_partitions_global_batch():
    h0 = _pipe(gb=8, host_id=0, host_count=2)(11)["tokens"]
    h1 = _pipe(gb=8, host_id=1, host_count=2)(11)["tokens"]
    assert h0.shape[0] == h1.shape[0] == 4
    # hosts never generate identical rows (independent generators)
    assert not torch.equal(h0, h1)


def test_vlm_batch_has_mrope_and_patches():
    cfg = _cfg(rope_kind="mrope", patch_embed_input=True)
    b = _pipe(gb=4, seq=16, cfg=cfg)(0)
    assert tuple(b["mrope_positions"].shape) == (4, 16, 3)
    assert torch.equal(b["mrope_positions"][1, :, 2],
                       torch.arange(16, dtype=torch.int32))
    assert tuple(b["patch_embeds"].shape) == (4, 16, cfg.d_model)
    assert b["patch_embeds"].dtype == torch.bfloat16


def test_audio_batch_multi_codebook():
    cfg = _cfg(n_codebooks=4)
    p = SyntheticPipeline(cfg, DataConfig(vocab_size=256), 4, 16,
                          device="cpu")
    b = p(0)
    assert tuple(b["tokens"].shape) == (4, 16, 4)
    assert torch.equal(b["tokens"][:, 1:], b["labels"][:, :-1])
    assert not torch.equal(b["tokens"][..., 0], b["tokens"][..., 1])


def test_indivisible_host_count_rejected():
    with pytest.raises(ValueError):
        _pipe(gb=8, host_count=3)


@pytest.mark.parametrize("seed,step", [(0, 0), (1, 17), (2 ** 20, 3),
                                       (12345, 2 ** 20)])
def test_tokens_in_vocab_range(seed, step):
    t = _pipe(seed=seed, gb=2, seq=16)(step)["tokens"]
    assert int(t.min()) >= 0 and int(t.max()) < 512


def test_vocab_capped_by_model():
    p = SyntheticPipeline(_cfg(), DataConfig(vocab_size=10 ** 6), 2, 8,
                          device="cpu")
    assert p.cfg.vocab_size == _cfg().vocab_size


def test_data_is_learnable_structure():
    """Markov/copy/progression rows are predictable: rows repeat
    themselves at some lag far above iid-uniform chance."""
    b = _pipe(gb=64, seq=64)(0)["tokens"].numpy()
    hit = 0
    for row in b:
        for lag in range(1, 33):
            if (row[lag:] == row[:-lag]).mean() > 0.5:
                hit += 1
                break
    assert hit >= 0.05 * len(b), hit


def _explained(rows, vocab, branching):
    """Fraction of transitions a -> b in ``rows`` that the port's rule
    gives for some choice j < branching."""
    a = torch.as_tensor(rows[:, :-1], dtype=torch.int32)[..., None]
    b = torch.as_tensor(rows[:, 1:], dtype=torch.int32)[..., None]
    j = torch.arange(branching, dtype=torch.int32)
    return float((TPL._markov_next(a, j, vocab) == b).any(-1).float().mean())


def test_markov_rule_explains_reference_rows():
    cfg = JDataConfig(vocab_size=512, branching=8)
    rows = np.array(JPL._markov_rows(jax.random.key(3), 16, 64, cfg))
    assert _explained(rows, 512, 8) == 1.0
    # and not by accident: a smaller branching misses transitions
    assert _explained(rows, 512, 2) < 0.5


def test_port_markov_rows_follow_the_rule():
    cfg = DataConfig(vocab_size=512)
    rows = TPL._markov_rows(torch.Generator().manual_seed(0), 16, 64, cfg)
    assert _explained(rows.numpy(), 512, 8) == 1.0


def test_eval_batches_disjoint_from_training_steps():
    p = _pipe(gb=2, seq=8)
    ev = eval_batches(p, 2)
    assert torch.equal(ev[0]["tokens"], p(10 ** 6)["tokens"])
    assert not torch.equal(ev[0]["tokens"], ev[1]["tokens"])
    assert p.state(4) == {"seed": 0, "step": 4, "global_batch": 2,
                          "seq_len": 8}
