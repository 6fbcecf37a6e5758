"""Deterministic synthetic token pipeline — shard-aware and resumable
(counterpart of ``repro/data/pipeline.py``).

  * **Step-indexed determinism**: batch(step) is a pure function of
    (seed, step, host, shape). Restarting from a checkpoint at step k
    replays exactly the batches an uninterrupted run would have seen — the
    checkpoint only has to store (seed, step), never a cursor or buffer.
  * **Shard-aware**: each host makes only its slice of the global batch,
    from a generator of its own.
  * **Structured, learnable data**: sequences come from a mixture of
    deterministic grammars (Markov chains with a per-seed transition
    structure, copy runs, arithmetic progressions), mixed by the
    reference's weights, so a model trained on them shows a falling loss.

The randomness is a ``torch.Generator`` seeded by
``np.random.SeedSequence([seed, step, host_id])``: the same rules as the
reference, other values (its PRNG is ``jax.random``). Batches are made on
the CPU and moved to the pipeline's device. The modality entries are
made as in the reference: ``mrope_positions``, ``patch_embeds`` and
[b, s, K] codebook planes.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import dtype_of


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seed: int = 0
    vocab_size: int = 1024          # sampling range (<= model vocab)
    # mixture weights over generators (renormalized)
    w_markov: float = 0.5
    w_copy: float = 0.3
    w_progression: float = 0.2
    markov_order: int = 1
    branching: int = 8              # successors per state in the chain
    copy_period_max: int = 64


def _batch_generator(seed: int, step: int, host_id: int = 0):
    """The generator of one host's batch at one step: a pure function of
    (seed, step, host_id)."""
    state = np.random.SeedSequence([seed, step, host_id]).generate_state(
        1, np.uint64)[0]
    return torch.Generator().manual_seed(int(state))


# ---------------------------------------------------------------------------
# generators
# ---------------------------------------------------------------------------

def _markov_next(v, j, vocab: int):
    """The chain's transition: state v (int32) with choice j < branching
    goes to |v * 1103515245 + j * 40503 + 1| mod vocab, the int32 products
    wrapping as the reference's do (and ``%`` taking the divisor's sign)."""
    h = v * 1103515245 + j * 40503 + 1
    return torch.abs(h) % vocab


def _markov_rows(gen, b, s, cfg: DataConfig):
    """Per-seed sparse Markov chain: each state has ``branching``
    successors. Next-token entropy is log(branching) << log(vocab)."""
    V, Br = cfg.vocab_size, cfg.branching
    v = torch.randint(0, V, (b,), generator=gen, dtype=torch.int32)
    choices = torch.randint(0, Br, (b, s), generator=gen, dtype=torch.int32)
    toks = []
    for t in range(s):
        v = _markov_next(v, choices[:, t], V)
        toks.append(v)
    return torch.stack(toks, dim=1)


def _copy_rows(gen, b, s, cfg: DataConfig):
    """Periodic copy task: a random prefix of length p repeats."""
    V = cfg.vocab_size
    p = torch.randint(4, cfg.copy_period_max, (b, 1), generator=gen)
    base = torch.randint(0, V, (b, s), generator=gen, dtype=torch.int32)
    src = torch.arange(s)[None, :] % p
    return torch.gather(base, 1, src)


def _progression_rows(gen, b, s, cfg: DataConfig):
    """Arithmetic progressions mod vocab: token_t = a + t*d (mod V)."""
    V = cfg.vocab_size
    a = torch.randint(0, V, (b, 1), generator=gen, dtype=torch.int32)
    d = torch.randint(1, 17, (b, 1), generator=gen, dtype=torch.int32)
    t = torch.arange(s, dtype=torch.int32)[None, :]
    return (a + t * d) % V


def _mix_rows(gen, b, s, cfg: DataConfig):
    ws = torch.tensor([cfg.w_markov, cfg.w_copy, cfg.w_progression],
                      dtype=torch.float64)
    gen_id = torch.multinomial(ws / ws.sum(), b, replacement=True,
                               generator=gen)
    rows = torch.stack([_markov_rows(gen, b, s, cfg),
                        _copy_rows(gen, b, s, cfg),
                        _progression_rows(gen, b, s, cfg)])    # [3, b, s]
    return rows[gen_id, torch.arange(b)]                       # [b, s]


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------

class SyntheticPipeline:
    """batch = pipeline(step). State is *implicit* — resuming = calling
    with a later step. ``host_id``/``host_count`` slice the global batch
    for multi-host runs (each host makes its ``global_batch // host_count``
    rows from its own generator). Batches land on ``device``."""

    def __init__(self, model_cfg: ModelConfig, data_cfg: DataConfig,
                 global_batch: int, seq_len: int, *, host_id: int = 0,
                 host_count: int = 1, device="cuda"):
        if global_batch % host_count:
            raise ValueError(
                f"global_batch {global_batch} not divisible by "
                f"host_count {host_count}")
        self.model_cfg = model_cfg
        self.cfg = dataclasses.replace(
            data_cfg, vocab_size=min(data_cfg.vocab_size, model_cfg.vocab_size))
        self.global_batch = global_batch
        self.seq_len = seq_len
        self.host_id = host_id
        self.host_count = host_count
        self.local_batch = global_batch // host_count
        self.device = torch.device(device)

    def _generate(self, step: int) -> dict:
        # one extra token so labels are a clean shift
        cfg, mc = self.cfg, self.model_cfg
        b, s = self.local_batch, self.seq_len + 1
        gen = _batch_generator(cfg.seed, step, self.host_id)
        K = mc.n_codebooks
        if K > 1:
            toks = torch.stack([_mix_rows(gen, b, s, cfg) for _ in range(K)],
                               dim=-1)                         # [b, s, K]
        else:
            toks = _mix_rows(gen, b, s, cfg)                   # [b, s]
        batch = {"tokens": toks[:, :-1].to(torch.int32),
                 "labels": toks[:, 1:].to(torch.int32)}
        if mc.rope_kind == "mrope":
            pos = torch.arange(self.seq_len, dtype=torch.int32)
            batch["mrope_positions"] = pos[None, :, None].expand(
                b, self.seq_len, 3)
        if mc.patch_embed_input:
            batch["patch_embeds"] = (0.02 * torch.randn(
                (b, self.seq_len, mc.d_model), generator=gen)).to(
                dtype_of(mc))
        return batch

    def __call__(self, step: int) -> dict:
        return {k: v.contiguous().to(self.device)
                for k, v in self._generate(int(step)).items()}

    def state(self, step: int) -> dict:
        """What a checkpoint needs to resume this pipeline exactly."""
        return {"seed": self.cfg.seed, "step": int(step),
                "global_batch": self.global_batch, "seq_len": self.seq_len}


def eval_batches(pipeline: SyntheticPipeline, n: int, start_step: int = 10**6):
    """Deterministic held-out batches (disjoint step range from training)."""
    return [pipeline(start_step + i) for i in range(n)]
