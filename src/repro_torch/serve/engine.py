"""Continuous-batching serve engine (counterpart of
``repro/serve/engine.py``).

The engine owns the device KV cache (cache contracts: models/model.py)
and runs decode as a loop of ``chunk`` steps with embedding, stack,
sampling and per-slot EOS/budget masking all on the device: the host
enqueues the whole chunk and syncs once, on the chunk's tokens. Between
chunks the host harvests finished slots and admits queued requests into
the freed rows.

Cache contracts. By default (``EngineConfig(cache="paged")``) the KV
ring lives in one page pool [L, n_pages, page_size, KV, hd] shared by
all slots, with per-slot page tables mapping logical ring pages to pool
pages. Admission is bounded by *free pages*, not free slots: prompt
pages are allocated at admission (plus a worst-case reservation, so
lazy growth during decode can never deadlock), grown chunk by chunk as
generation advances, and released at completion. Page-aligned common
prompt prefixes are shared through a refcounted host-side registry
(paging.py): a hit admits those tokens without prefilling them, the
suffix queries attending over the cached pages. The host keeps the page
table and uploads it once before a decode chunk when it changed.
``cache="slot"`` keeps one full ring per slot, the reference's A/B
baseline.

Admission is batched by key: the scheduler pops up to
``len(free_slots)`` queued requests that share a power-of-two prefill
bucket (and, paged, the same matched prefix chain) and the engine
prefills them in ONE ragged batch, samples every admitted row's first
token on the device, and syncs only the [N] token vector. The admitted
rows are then scattered into the big cache; a slot write replaces the
entire row (all W positions, or the row's pages), so no state of the
previous occupant leaks into the new request's attention.

Token-budget schedule (``EngineConfig(chunk_prefill=N)``, paged archs
without SSM state; the others keep one-shot admission):
each ``step()`` packs a token budget with one decode chunk over the
decode-phase slots and one prefill chunk of at most N prompt tokens per
mid-prompt slot (scheduler.py::plan_step). Admission binds a slot and
reserves pages without running any prompt tokens; the chunks resume the
prompt from the slot's pages, and the final chunk samples the first
token and arms the slot's decode state on the device. The decode chunk
is enqueued first and the chunks after it; a decode step's write mask
keeps mid-prefill slots' pages and positions untouched.

Stateful archs (Mamba: falcon-mamba, hymba) prefill at exact prompt
lengths, since pad tokens would run through the SSM state; a pure-SSM
stack has no KV ring to page and serves on the slot contract whatever
``cache`` asks, and prefix sharing and chunked prefill are off for them
(their state depends on every earlier token), as in the reference.

Multi-codebook archs (musicgen: ``cfg.n_codebooks = K > 1``) run through
the same engine and schedules: a token is a [K] plane vector ([S, K]
prompts, [B, K] decode state, K-tuple host records), the embeddings sum
the K planes and the K heads give [B, K, V] logits; the cache is
post-embedding, so page tables, prefix chains and write masks are
unchanged. EOS is tested on codebook 0; token stats count plane tokens
(K per position).

Sampling is schedule-invariant: greedy rows take the argmax (first index
on ties); a row with temperature > 0 draws with a ``torch.Generator``
seeded from (engine seed, uid, token index), a pure function of the
request and the token position. The host derives the index without a
sync: a slot's k-th chunk step draws token ``len(run.tokens) + k``. So
one-shot, chunked and drain-trimmed schedules draw the same tokens at
any temperature. The draws cannot match the reference's ``jax.random``
streams.

Tensor parallelism (``ServeEngine(..., mesh=)``, a (1, N) mesh from
``launch/mesh.py::make_host_mesh``): every rank of the mesh builds the
same engine and takes the same calls in the same order. Each rank holds
its shards of the weights and of the cache (``launch/steps.py::
serve_shardings`` under ``partition.serve_rules``: kv heads over
``model`` where KV divides, else whole; Mamba state over ``model``),
and every step runs under the mesh's ``axis_rules`` context, where the
blocks call their collectives. Logits are whole and bit-identical on
every rank, so sampling, the scheduler, the page table and the slots
(host state) stay the same on every rank without any exchange.

Timing is honest on the card: every span in ``EngineStats`` ends at a
host sync on the work it times (the token pull, or an explicit
``torch.cuda.synchronize`` after the insert), never at enqueue — except
chunked prefill, whose chunks are not synced (their time lands in the
next decode sync), as in the reference. Under any ``torch.profiler`` run
each ``step()`` also opens the spans of ``repro_torch.spans``:
``serve.step`` around the iteration; inside it ``serve.admit`` (the
admission loop, with ``serve.prefill`` from the prefill call through the
first-token pull and ``serve.insert`` through its sync), ``serve.pages``
(page growth and the table upload), ``serve.decode`` (the decode chunk
through its token pull; under the token-budget schedule with the
``serve.prefill_chunk`` spans enqueued behind it) and ``serve.harvest``.
Each range of the trace is named ``repro.<span>``, and
``repro_torch.spans.device_ms()`` gives each span's device time in stream
order. ``prefill_s``, ``insert_s`` and ``decode_s`` time exactly what
``serve.prefill``, ``serve.insert`` and ``serve.decode`` bracket.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from repro_torch import spans
from repro_torch.launch import steps as steps_mod
from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig
from repro_torch.parallel import partition as part

from .paging import PagePool, SlotPages
from .scheduler import (Completion, Request, SlotRun, TokenBudgetScheduler,
                        bucket_len)

_MASK64 = (1 << 64) - 1


def _mix64(z: int) -> int:
    """splitmix64 finalizer."""
    z = (z + 0x9E3779B97F4A7C15) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return z ^ (z >> 31)


def token_seed(seed: int, uid: int, index: int) -> int:
    """Generator seed of request ``uid``'s token ``index`` under engine
    ``seed`` (63 bits, a pure function of the three)."""
    return _mix64(_mix64(_mix64(seed & _MASK64) ^ (uid & _MASK64))
                  ^ (index & _MASK64)) >> 1


def _draw(logits_row, temperature: float, gen: torch.Generator):
    """One row's draw: logits [..., V] -> int32 [...] (a multi-codebook
    row's planes drawn in order from the one generator)."""
    probs = torch.softmax(logits_row.to(torch.float32)
                          / max(temperature, 1e-6), dim=-1)
    got = torch.multinomial(probs.reshape(-1, probs.shape[-1]), 1,
                            generator=gen)
    return got.reshape(probs.shape[:-1]).to(torch.int32)


def sample_tokens(gen: torch.Generator, logits, temperature):
    """Per-row sampling: temperature <= 0 -> greedy (argmax, first index
    on ties). logits [B, V] (or [B, K, V]); ``temperature`` a host
    sequence of B floats; rows with temperature > 0 draw from ``gen`` in
    row order. Returns int32 [B] (or [B, K]) on logits' device."""
    out = torch.argmax(logits, dim=-1).to(torch.int32)
    for i, t in enumerate(temperature):
        if t > 0.0:
            out[i] = _draw(logits[i], float(t), gen)
    return out


def sample_tokens_indexed(seed: int, uids, indices, logits, temperature):
    """Schedule-invariant per-row sampling: row i with temperature > 0
    draws with a generator seeded by ``token_seed(seed, uids[i],
    indices[i])``; temperature <= 0 is greedy. ``uids`` / ``indices`` /
    ``temperature`` are host sequences of length B (no device sync).
    logits [B, V] (or [B, K, V]: the K planes draw in order under the
    row's one generator). Returns int32 [B] (or [B, K])."""
    out = torch.argmax(logits, dim=-1).to(torch.int32)
    for i, t in enumerate(temperature):
        if t > 0.0:
            gen = torch.Generator(device=logits.device)
            gen.manual_seed(token_seed(seed, int(uids[i]), int(indices[i])))
            out[i] = _draw(logits[i], float(t), gen)
    return out


def make_prefill_sample(cfg: ModelConfig, capacity: int):
    """Admission step: ragged prefill + on-device first-token sampling.
    (params, batch{tokens [N,S], lengths [N]}, uids, seed, temperature)
    -> (tok0 [N], per-slot cache). The first token is token index 0 of
    its request. Full-vocab logits never leave the device."""
    prefill = steps_mod.make_prefill_step(cfg, capacity=capacity)

    def prefill_sample(params, batch, uids, seed, temperature):
        logits, cache = prefill(params, batch)
        return sample_tokens_indexed(seed, uids, [0] * len(uids), logits,
                                     temperature), cache

    return prefill_sample


def make_slot_insert(cfg: ModelConfig):
    """Batched slot admission: scatter N prefilled requests (an N-row
    per-slot cache) into rows ``slots`` [N] of the big cache and the
    slot-state tensors, in place."""

    def insert(cache, state, slots, small_cache, slot_vals):
        for name, big in cache["layers"].items():
            big[:, slots] = small_cache["layers"][name].to(big.dtype)
        cache["cur"][slots] = small_cache["cur"].to(cache["cur"].dtype)
        if "k_pos" in cache:                     # pure-SSM stacks have none
            cache["k_pos"][slots] = small_cache["k_pos"].to(
                cache["k_pos"].dtype)
        for name, val in slot_vals.items():
            state[name][slots] = val.to(state[name].dtype)
        return cache, state

    return insert


def make_paged_insert(cfg: ModelConfig, page_size: int):
    """Batched admission for the paged cache contract, in place: reshape
    each admitted row's k/v into pages and scatter them into the shared
    pool at ``write_rows`` [N, n_w] (physical page ids; trash-padded rows
    write harmlessly into page 0), install the rows' page tables
    ``tbl_rows`` [N, pages_per_slot] and per-slot vectors at ``slots``
    [N]. On a prefix hit ``write_rows`` covers only the suffix pages, so
    shared prefix pages are never rewritten. A hybrid stack's conv / ssm
    state is per slot: it goes to rows ``slots``."""

    def insert(cache, state, slots, small_cache, slot_vals, tbl_rows,
               write_rows):
        for name, big in cache["layers"].items():
            sm = small_cache["layers"][name]
            if name not in ("k", "v"):            # conv / ssm stay per slot
                big[:, slots] = sm.to(big.dtype)
                continue
            L, N, Wx = sm.shape[:3]               # [L, N, n_w*ps, KV, hd]
            big[:, write_rows] = sm.to(big.dtype).reshape(
                (L, N, Wx // page_size, page_size) + tuple(sm.shape[3:]))
        cache["cur"][slots] = small_cache["cur"].to(cache["cur"].dtype)
        cache["k_pos"][slots] = small_cache["k_pos"].to(cache["k_pos"].dtype)
        cache["page_tbl"][slots] = tbl_rows.to(cache["page_tbl"].dtype)
        for name, val in slot_vals.items():
            state[name][slots] = val.to(state[name].dtype)
        return cache, state

    return insert


def make_prefix_prefill_sample(cfg: ModelConfig, page_size: int,
                               capacity: int):
    """Prefix-hit admission step: gather the shared prefix pages out of
    the pool, ragged-prefill only the suffixes against them, and sample
    first tokens on the device — the contract of make_prefill_sample,
    but the batch carries *suffix* tokens/lengths. (params, pool_kv,
    pages [n_pre], batch, uids, seed, temperature) -> (tok0 [N], small
    cache): its k_pos width is ``capacity`` (the padded ring) and its
    k/v are the suffix pages only."""
    engine = steps_mod.make_engine(cfg)

    def prefill_sample(params, pool_kv, pages, batch, uids, seed,
                       temperature):
        prefix_len = pages.shape[0] * page_size
        prefix = {}
        for name in ("k", "v"):
            sel = pool_kv[name][:, pages]             # [L, n_pre, ps, KV, hd]
            prefix[name] = sel.reshape((sel.shape[0], prefix_len)
                                       + tuple(sel.shape[3:]))
        logits, cache = M.prefill_prefix_fn(params, batch, cfg, engine,
                                            prefix, prefix_len, capacity,
                                            page_size)
        return sample_tokens_indexed(seed, uids, [0] * len(uids), logits,
                                     temperature), cache

    return prefill_sample


def make_decode_chunk(cfg: ModelConfig, n_steps: int, paged: bool = False):
    """(params, cache, state, seed, uids, emitted0, temps) ->
    (cache, state, toks [T, B] or [T, B, K]): ``n_steps`` decode steps
    enqueued on the device with no host sync inside. Rows record their
    sampled token while active and 0 afterwards; ``emitted`` / ``active``
    advance so the host can replay termination exactly (EOS, on codebook
    0 for K > 1 planes, or budget). ``uids`` /
    ``emitted0`` / ``temps`` are the host's per-slot request ids, tokens
    drawn so far and temperatures (sampling keys only).

    With ``paged``, ``active`` is also each step's write mask: inactive
    rows leave their cache bit for bit as it was (writes land on the
    trash page, k_pos and cur stay; models/model.py). For plain
    continuous batching that is hygiene, but the chunked schedule
    decodes while some slots are mid-prefill, and those slots' pages
    must not be scribbled by the shared decode chunk."""
    engine = steps_mod.make_engine(cfg)
    multi = cfg.n_codebooks > 1

    def chunk(params, cache, state, seed, uids, emitted0, temps):
        tok, emitted, active = state["tok"], state["emitted"], state["active"]
        budget, eos = state["budget"], state["eos"]
        toks = []
        for t in range(n_steps):
            batch = {"tokens": tok[:, None]}          # [B, 1] or [B, 1, K]
            if paged:
                batch["write_mask"] = active
            logits, cache = M.decode_fn(params, batch, cache, cfg, engine)
            # an active row's token index is emitted0 + t: the same key
            # no matter how steps are cut into chunks
            nxt = sample_tokens_indexed(seed, uids,
                                        [e + t for e in emitted0],
                                        logits, temps)
            nxt = torch.where(active[:, None] if multi else active, nxt,
                              torch.zeros_like(nxt))
            emitted = emitted + active.to(torch.int32)
            head = nxt[:, 0] if multi else nxt
            active = active & (head != eos) & (emitted < budget)
            tok = nxt
            toks.append(nxt)
        new_state = dict(state, tok=tok, emitted=emitted, active=active)
        return cache, new_state, torch.stack(toks)

    return chunk


def make_chunk_prefill(cfg: ModelConfig, page_size: int):
    """Chunked-admission step: advance ONE slot's prefill by ``clen``
    prompt tokens (models/model.py::run_stack_prefill_chunk, in place)
    and, on the final chunk, arm the slot's decode state on the device.

    (params, cache, state, batch{tokens [1, S]}, slot, pos, clen, first,
    final, uid, seed, temp, budget, eos) -> (cache, state, tok0), every
    argument after ``batch`` a host value. Every chunk samples tok0 from
    the logits at its last real token; a non-final chunk's tok0 is a
    throwaway the host never reads. The slot's ``active`` stays False
    until the final chunk, so interleaved decode chunks leave its pages
    untouched (write mask). The final chunk's first token samples with
    the (uid, 0) key — what one-shot admission would have drawn. K > 1
    planes feed chunk tokens [1, S, K] and arm a [K] first token, EOS
    tested on codebook 0."""
    step = steps_mod.make_prefill_chunk_step(cfg, page_size)
    multi = cfg.n_codebooks > 1

    def chunk(params, cache, state, batch, slot, pos, clen, first, final,
              uid, seed, temp, budget, eos):
        if first:
            # forget the slot's previous occupant. A prefix hit starts at
            # pos = prefix_len with the shared pages' positions valid
            # (ring order is sequence order: prefix caching excludes
            # sliding windows); a cold start (pos = 0) resets to -1
            k_pos = cache["k_pos"]
            j = torch.arange(k_pos.shape[1], dtype=k_pos.dtype,
                             device=k_pos.device)
            row = torch.where(j < pos, j, -1)
        else:
            row = cache["k_pos"][slot]
        pool_kv = {"k": cache["layers"]["k"], "v": cache["layers"]["v"]}
        logits, new_row = step(params, batch, pool_kv,
                               cache["page_tbl"][slot], row, pos, clen)
        tok0 = sample_tokens_indexed(seed, [uid], [0], logits, [temp])[0]
        cache["cur"][slot] = pos + clen
        cache["k_pos"][slot] = new_row
        if final:
            state["tok"][slot] = tok0
            state["emitted"][slot] = 1
            head = tok0[0] if multi else tok0
            state["active"][slot] = (head != eos) if budget > 1 else False
            state["budget"][slot] = budget
            state["eos"][slot] = eos
        return cache, state, tok0

    return chunk


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    slots: int = 4              # decode batch width (fixed)
    max_prompt_len: int = 256
    max_len: int = 512          # prompt + generation bound per request
    chunk: int = 8              # decode steps per host sync
    min_bucket: int = 16        # smallest prefill bucket
    admission: str = "batched"  # "batched": up to len(free_slots) same-
                                # bucket requests per prefill; "serial":
                                # one request per prefill
    trim_drain: bool = True     # cap the final decode chunks at the
                                # largest remaining per-slot budget
    cache: str = "paged"        # "paged": shared page pool + per-slot
                                # page tables, admission by free pages
                                # (grown lazily, freed at completion);
                                # "slot": one full ring per slot, the
                                # reference's A/B baseline
    page_size: int = 16         # tokens per page (paged only)
    n_pages: int | None = None  # physical pool size incl. the trash
                                # page; None = slots * pages_per_slot
                                # + 1, the slot contract's memory
    prefix_cache: bool = True   # share page-aligned common prompt
                                # prefixes across requests (paged, no
                                # sliding window, no SSM state)
    chunk_prefill: int = 0      # > 0: admission streams each prompt in
                                # chunks of at most this many tokens,
                                # interleaved with decode under the
                                # token budget (paged, no SSM; clamped to
                                # the padded ring). 0 = one-shot
    token_budget: int | None = None  # per-iteration token cap of the
                                # chunked schedule: decode steps x
                                # decode slots + prefill chunk tokens.
                                # None = slots * chunk + chunk_prefill
    seed: int = 0

    def __post_init__(self):
        if self.max_prompt_len >= self.max_len:
            raise ValueError("max_prompt_len must leave room to generate "
                             f"({self.max_prompt_len} >= {self.max_len})")
        if self.slots < 1 or self.chunk < 1:
            raise ValueError(f"slots ({self.slots}) and chunk "
                             f"({self.chunk}) must be >= 1")
        if self.admission not in ("batched", "serial"):
            raise ValueError(f"admission must be 'batched' or 'serial', "
                             f"got {self.admission!r}")
        if self.cache not in ("paged", "slot"):
            raise ValueError(f"cache must be 'paged' or 'slot', "
                             f"got {self.cache!r}")
        if self.page_size < 1:
            raise ValueError(f"page_size ({self.page_size}) must be >= 1")
        if self.n_pages is not None and self.n_pages < 2:
            raise ValueError(f"n_pages ({self.n_pages}) must be >= 2 "
                             "(one trash page + one usable page)")
        if self.chunk_prefill < 0:
            raise ValueError(f"chunk_prefill ({self.chunk_prefill}) "
                             "must be >= 0 (0 = one-shot admission)")
        if self.token_budget is not None:
            if self.chunk_prefill == 0:
                raise ValueError("token_budget only shapes the chunked "
                                 "schedule; set chunk_prefill > 0")
            if self.token_budget < 1:
                raise ValueError(f"token_budget ({self.token_budget}) "
                                 "must be >= 1")


@dataclasses.dataclass
class EngineStats:
    """Cumulative engine counters (seconds end at a device sync). Token
    counters count plane tokens: K per position for K codebooks, so K = 1
    and K > 1 rates compare."""
    prefill_s: float = 0.0
    prefill_tokens: int = 0        # real prompt tokens prefilled
    prefill_padded_tokens: int = 0  # incl. bucket padding
    prefill_batches: int = 0       # admission prefills (one forward each)
    prefill_requests: int = 0      # requests admitted across prefills
    insert_s: float = 0.0          # slot-insert time (the other half of
                                   # admission)
    prefill_chunks: int = 0        # chunked admission: prefill chunks
                                   # (never synced, so chunked prefill_s
                                   # counts enqueue time only; their
                                   # compute lands in decode_s)
    decode_s: float = 0.0
    decode_chunks: int = 0
    decode_steps: int = 0          # sum of per-chunk decode steps (one
                                   # forward each)
    decode_tokens: int = 0         # real tokens emitted during decode
    pages_in_use: int = 0          # paged only: live (ref > 0) pool pages
    pages_peak: int = 0            # paged only: high-water mark of the above
    prefix_hit_tokens: int = 0     # prompt tokens admitted straight from
                                   # cached prefix pages (never prefilled)
    # live-occupancy gauges, filled by ServeEngine.snapshot()
    slots_in_use: int = 0
    queue_depth: int = 0
    pages_free: int = 0            # PagePool.available() (0 = slot cache)

    def delta(self, prev: "EngineStats") -> "EngineStats":
        """Interval view: counters become (self - prev), gauges keep
        self's value."""
        out = EngineStats()
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if f.name not in _STAT_GAUGES:
                v = v - getattr(prev, f.name)
            setattr(out, f.name, v)
        return out

    def decode_utilization(self, slots: int, planes: int = 1) -> float:
        """Fraction of decode step-slots that emitted a real token."""
        denom = self.decode_steps * slots * planes
        return self.decode_tokens / denom if denom else 0.0

    @property
    def prefill_tokens_per_s(self):
        return self.prefill_tokens / self.prefill_s if self.prefill_s else 0.0

    @property
    def admission_tokens_per_s(self):
        """Prompt tokens over the whole admission path (prefill + insert)."""
        denom = self.prefill_s + self.insert_s
        return self.prefill_tokens / denom if denom else 0.0

    @property
    def admitted_tokens_per_s(self):
        """All admitted prompt tokens (computed + prefix hits) over the
        admission path: exceeds admission_tokens_per_s by the hit tokens'
        worth of skipped prefill."""
        denom = self.prefill_s + self.insert_s
        return ((self.prefill_tokens + self.prefix_hit_tokens) / denom
                if denom else 0.0)

    @property
    def prefix_hit_rate(self):
        """Fraction of admitted prompt tokens served from cached pages."""
        total = self.prefill_tokens + self.prefix_hit_tokens
        return self.prefix_hit_tokens / total if total else 0.0

    @property
    def decode_tokens_per_s(self):
        return self.decode_tokens / self.decode_s if self.decode_s else 0.0


# gauges describe "now" and are copied (not differenced) by delta()
_STAT_GAUGES = frozenset({
    "slots_in_use", "queue_depth", "pages_free",
    "pages_in_use", "pages_peak",
})


class StatsWindow:
    """Rolling interval reader over EngineStats snapshots: each tick()
    returns the delta since the previous tick (first tick: since boot)."""

    def __init__(self):
        self._prev = EngineStats()

    def tick(self, snap: EngineStats) -> EngineStats:
        delta = snap.delta(self._prev)
        self._prev = snap
        return delta


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    return torch.as_tensor(tree).to(device)


class ServeEngine:
    """Continuous-batching server over one model + parameter set.

    >>> eng = ServeEngine(cfg, params, EngineConfig(slots=4))
    >>> eng.submit([1, 2, 3], max_new=16)
    >>> done = eng.run()          # list[Completion], uid order

    ``device`` defaults to "cuda" and raises when no GPU is present; it
    never falls back to the CPU. Parameters are moved there and the
    compute-dtype leaves cast once (``model.compute_params``).

    With ``mesh`` (a (1, N) DeviceMesh this rank is on) and optionally
    ``rules`` (``serve_rules(rules)`` is used) the engine is this rank's
    part of a tensor-parallel group: ``params`` is the full tree, of
    which it keeps its shards. Every rank must make the same calls."""

    def __init__(self, cfg: ModelConfig, params, ecfg: EngineConfig = None,
                 *, mesh=None, rules: dict | None = None, device="cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("ServeEngine(device='cuda'): no CUDA device "
                               "is available; pass device='cpu' to serve "
                               "on the CPU")
        self.mesh = mesh
        self.rules = part.serve_rules(rules) if mesh is not None else None
        if mesh is not None and part.mesh_shape(mesh).get("data", 1) != 1:
            raise ValueError(
                f"ServeEngine(mesh=) is tensor-parallel only: mesh "
                f"{part.mesh_shape(mesh)} has data > 1 (scale out over "
                "data with replicas)")
        self.cfg = cfg
        self.ecfg = ecfg or EngineConfig()
        # K > 1 codebooks: every token is a [K] plane vector
        self.K = cfg.n_codebooks
        self.capacity = M.cache_capacity(cfg, self.ecfg.max_len)
        stateful = cfg.use_mamba or cfg.parallel_mamba
        # pad tokens would run through the SSM / conv state, so stateful
        # archs prefill at exact prompt lengths (scheduler.py)
        self._exact_buckets = stateful
        # the paged contract needs a KV ring; pure-SSM stacks fall back to
        # the slot contract (their whole state is O(1) per row anyway)
        self.paged = (self.ecfg.cache == "paged"
                      and (cfg.has_attention or cfg.parallel_mamba))
        # prefix pages replay cached k/v verbatim: SSM state depends on
        # the whole history and sliding-window rings are not in sequence
        # order, so both opt out
        self.prefix_enabled = (self.paged and self.ecfg.prefix_cache
                               and cfg.sliding_window is None
                               and not stateful)
        # chunked prefill resumes a prompt from its pages mid-stream,
        # which no SSM / conv state can do
        self.chunked = (self.ecfg.chunk_prefill > 0 and self.paged
                        and not stateful)
        B = self.ecfg.slots
        dev = self.device
        ps = self.ecfg.page_size
        if self.paged:
            self._n_per_slot = M.pages_per_slot(cfg, self.ecfg.max_len, ps)
            self._w_pad = self._n_per_slot * ps       # padded ring width
            n_pages = self.ecfg.n_pages
            if n_pages is None:
                n_pages = B * self._n_per_slot + 1    # slot-contract memory
            if n_pages - 1 < self._n_per_slot:
                raise ValueError(
                    f"n_pages={n_pages} cannot hold one worst-case request "
                    f"({self._n_per_slot} pages + the trash page): the "
                    "queue head could never be admitted")
            self._n_pages = n_pages
            self._pool = PagePool(n_pages, ps)
        psh = csh = None
        if mesh is not None:
            psh, csh, _ = steps_mod.serve_shardings(
                cfg, B, self.ecfg.max_len, mesh, self.rules,
                **(dict(page_size=ps, n_pages=self._n_pages) if self.paged
                   else {}))
            params = M.shard_params(params, cfg, psh)
        self.params = M.compute_params(_to_device(params, dev), cfg)
        if self.paged:
            # host copy of the device page table, authoritative; rows
            # start at trash. Uploaded once before a chunk when changed
            self._tbl = np.zeros((B, self._n_per_slot), np.int32)
            self._tbl_dirty = False
            self._slot_pages: dict[int, SlotPages] = {}
            self.cache = M.init_paged_cache(cfg, B, self._n_pages, ps,
                                            self.ecfg.max_len, device=dev,
                                            shardings=csh)
            prefill_capacity = self._w_pad
            self._insert = make_paged_insert(cfg, ps)
        else:
            self.cache = M.init_cache(cfg, B, self.ecfg.max_len,
                                      per_slot=True, device=dev,
                                      shardings=csh)
            prefill_capacity = self.capacity
            self._insert = make_slot_insert(cfg)
        self.state = {
            "tok": torch.zeros((B, self.K) if self.K > 1 else (B,),
                               dtype=torch.int32, device=dev),
            "emitted": torch.zeros((B,), dtype=torch.int32, device=dev),
            "active": torch.zeros((B,), dtype=torch.bool, device=dev),
            "budget": torch.zeros((B,), dtype=torch.int32, device=dev),
            "eos": torch.full((B,), -1, dtype=torch.int32, device=dev),
        }
        self._prefill = self._under_rules(
            make_prefill_sample(cfg, prefill_capacity))
        if self.prefix_enabled:
            self._prefix_prefill = self._under_rules(
                make_prefix_prefill_sample(cfg, ps, self._w_pad))
        if self.chunked:
            # a chunk wider than the padded ring would collide with its
            # own scatter (two chunk tokens sharing a ring slot)
            self._chunk_tokens = min(self.ecfg.chunk_prefill, self._w_pad)
            self._token_budget = (self.ecfg.token_budget
                                  or B * self.ecfg.chunk + self._chunk_tokens)
            self._chunk_prefill = self._under_rules(
                make_chunk_prefill(cfg, ps))
        self._decode_fns: dict = {}    # decode steps -> chunk function
        self._decode_at(self.ecfg.chunk)
        self.sched = TokenBudgetScheduler(B)
        self.stats = EngineStats()
        self.completions: list[Completion] = []
        self._uid = 0

    def _decode_at(self, n_steps: int):
        """The decode chunk running ``n_steps`` steps, built on demand."""
        fn = self._decode_fns.get(n_steps)
        if fn is None:
            fn = self._decode_fns[n_steps] = self._under_rules(
                make_decode_chunk(self.cfg, n_steps, paged=self.paged))
        return fn

    def _under_rules(self, fn):
        """``fn`` run under this engine's (mesh, rules) context, where the
        blocks find their TP group; ``fn`` itself without a mesh."""
        if self.mesh is None:
            return fn
        mesh, rules = self.mesh, self.rules

        def wrapped(*args, **kwargs):
            with part.axis_rules(mesh, rules):
                return fn(*args, **kwargs)

        return wrapped

    # -- request intake ----------------------------------------------------

    def submit(self, prompt_tokens, max_new: int, *, temperature: float = 0.0,
               eos_id: Optional[int] = None, uid: Optional[int] = None,
               arrival_s: Optional[float] = None) -> int:
        """Queue one request; returns its uid (sampling keys fold it in,
        so a caller-chosen uid keeps its stream wherever it is placed).
        Multi-codebook engines (K > 1) take prompts [S, K] and record
        every token as a K-tuple; lengths, buckets and page costs stay
        positional."""
        arr = np.asarray(prompt_tokens)
        if self.K > 1:
            if arr.ndim != 2 or arr.shape[-1] != self.K:
                raise ValueError(
                    f"multi-codebook prompts must be [S, {self.K}], got "
                    f"shape {arr.shape}")
            toks = [tuple(int(x) for x in row) for row in arr]
        else:
            toks = [int(t) for t in arr.reshape(-1)]
        if not toks:
            raise ValueError("empty prompt")
        if len(toks) > self.ecfg.max_prompt_len:
            raise ValueError(f"prompt length {len(toks)} > max_prompt_len "
                             f"{self.ecfg.max_prompt_len}")
        if max_new < 1:
            raise ValueError("max_new must be >= 1")
        if uid is None:
            uid = self._uid
            self._uid += 1
        else:
            uid = int(uid)
            self._uid = max(self._uid, uid + 1)
        now = time.perf_counter()
        self.sched.submit(Request(
            uid=uid, tokens=toks, max_new=max_new, temperature=temperature,
            eos_id=-1 if eos_id is None else int(eos_id),
            submitted_at=now,
            arrival_s=now if arrival_s is None else float(arrival_s)))
        return uid

    def snapshot(self) -> EngineStats:
        """Point-in-time copy of the stats with the occupancy gauges."""
        s = dataclasses.replace(self.stats)
        s.slots_in_use = len(self.sched.active_slots())
        s.queue_depth = len(self.sched.queue)
        s.pages_free = self._pool.available() if self.paged else 0
        return s

    # -- admission ---------------------------------------------------------

    def _bucket_of(self, length: int) -> int:
        return bucket_len(length, min_bucket=self.ecfg.min_bucket,
                          max_len=self.ecfg.max_prompt_len,
                          exact=self._exact_buckets)

    def _chunk_bucket(self, length: int) -> int:
        """Padded chunk length: the reference's chunk buckets, so both
        packages run the same shapes."""
        return bucket_len(
            length, min_bucket=min(self.ecfg.min_bucket, self._chunk_tokens),
            max_len=self._chunk_tokens)

    def _head(self, tok) -> int:
        """Codebook-0 id of one sampled token (a scalar, or a [K] plane
        row): the plane the EOS contract tests."""
        return int(tok[0]) if self.K > 1 else int(tok)

    def _as_token(self, tok):
        """One sampled token as its host record: an int, or a K-tuple of
        plane ids (hashable, so prefix chains key on it)."""
        return tuple(int(x) for x in tok) if self.K > 1 else int(tok)

    def _match_of(self, req: Request) -> list:
        """Cached prefix page chain for a request (possibly empty),
        capped so the suffix is never empty — admission needs at least
        one real token to read first-token logits from."""
        if not self.prefix_enabled:
            return []
        limit = (len(req.tokens) - 1) // self.ecfg.page_size
        return self._pool.match(req.tokens, limit=limit)

    def _admit_key(self, req: Request):
        """Requests admitted in one ragged prefill must agree on both the
        (suffix) prefill bucket and the matched prefix chain."""
        match = self._match_of(req)
        sbucket = self._bucket_of(
            len(req.tokens) - len(match) * self.ecfg.page_size)
        return (sbucket, tuple(match))

    def _page_cost(self, req: Request) -> int:
        """Worst-case NEW pages this request could ever need (prompt plus
        full generation budget, minus its cached prefix). Admitting by
        this bound lets growth draw on reservations instead of failing
        mid-decode."""
        ps = self.ecfg.page_size
        L = len(req.tokens)
        gen = min(req.max_new, self.ecfg.max_len - L)
        worst = min(-(-(L + gen) // ps), self._n_per_slot)
        return max(worst - len(self._match_of(req)), 0)

    def _reserve_pages(self, reqs: list):
        """Pin each request's matched prefix, allocate its prompt pages
        and reserve its worst-case growth, in queue order. A request
        that no longer fits (the evictable pool shrank since the batch
        was sized) rolls back and returns to the queue front along with
        everything behind it. Returns (admitted requests, their plans)."""
        ps = self.ecfg.page_size
        taken, plans = [], []
        for i, req in enumerate(reqs):
            match = self._match_of(req)
            if match:
                # pin before any alloc below could evict the chain
                self._pool.share(match)
            L = len(req.tokens)
            gen = min(req.max_new, self.ecfg.max_len - L)
            n_now = min(-(-L // ps), self._n_per_slot)   # prompt pages
            worst = min(-(-(L + gen) // ps), self._n_per_slot)
            new = self._pool.alloc(n_now - len(match))
            ok = new is not None and self._pool.reserve(worst - n_now)
            if not ok:
                if new is not None:
                    self._pool.release(new)
                if match:
                    self._pool.release(match)
                self.sched.queue.extendleft(reversed(reqs[i:]))
                break
            taken.append(req)
            plans.append(SlotPages(pages=match + new,
                                   n_shared=len(match), worst=worst))
        return taken, plans

    def _release_plan(self, sp: SlotPages) -> None:
        self._pool.release(sp.pages)
        self._pool.unreserve(sp.worst - len(sp.pages))

    def _admit_chunked(self, slots: list, reqs: list) -> bool:
        """Chunked admission: reserve pages and bind the slot, but run
        ZERO prompt tokens — the prefill cursor starts past any prefix
        hit and ``_step_chunked`` advances it one budgeted chunk per
        iteration. Nothing runs on the device here, so requests of one
        round need not share an admission key."""
        reqs, plans = self._reserve_pages(reqs)
        if not reqs:
            return False
        self.stats.pages_in_use = self._pool.in_use
        self.stats.pages_peak = self._pool.pages_peak
        ps = self.ecfg.page_size
        now = time.perf_counter()
        for b, req, sp in zip(slots, reqs, plans):
            sp.prefill_pos = sp.n_shared * ps
            sp.prefill_done = False
            sp.first_chunk = True
            self._tbl[b, :len(sp.pages)] = sp.pages
            self._tbl[b, len(sp.pages):] = 0
            self._tbl_dirty = True
            self.stats.prefix_hit_tokens += sp.n_shared * ps * self.K
            self.stats.prefill_requests += 1
            self.sched.bind(b, SlotRun(request=req, tokens=[],
                                       admitted_at=now))
            self._slot_pages[b] = sp
        return True

    def _admit(self, slots: list, reqs: list) -> bool:
        """Admit ``reqs`` (same admission key) into free rows
        ``slots[:N]``: one ragged prefill with on-device first-token
        sampling (a prefix hit prefills only the suffix against the
        cached pages), one multi-row insert. Only the [N] tok0 vector is
        synced. Returns False when nothing could be admitted (page
        exhaustion: admission waits until decode frees pages)."""
        plans = None
        if self.paged:
            reqs, plans = self._reserve_pages(reqs)
            if not reqs:
                return False
            self.stats.pages_in_use = self._pool.in_use
            self.stats.pages_peak = self._pool.pages_peak
        N = len(reqs)
        ps = self.ecfg.page_size
        n_pre = plans[0].n_shared if plans else 0
        pre_len = n_pre * ps
        lens = [len(r.tokens) - pre_len for r in reqs]     # suffix lengths
        bucket = self._bucket_of(lens[0])
        K = self.K
        padded = np.zeros((N, bucket, K) if K > 1 else (N, bucket), np.int32)
        for i, r in enumerate(reqs):
            padded[i, :lens[i]] = np.asarray(r.tokens[pre_len:], np.int32)
        dev = self.device
        batch = {"tokens": torch.as_tensor(padded, device=dev),
                 "lengths": torch.as_tensor(lens, dtype=torch.int32,
                                            device=dev)}
        uids = [r.uid for r in reqs]
        temps = [float(r.temperature) for r in reqs]

        with spans.span("serve.prefill"):
            t0 = time.perf_counter()
            if n_pre:
                pool_kv = {"k": self.cache["layers"]["k"],
                           "v": self.cache["layers"]["v"]}
                pages = torch.as_tensor(plans[0].pages[:n_pre],
                                        dtype=torch.int64, device=dev)
                tok0, small_cache = self._prefix_prefill(
                    self.params, pool_kv, pages, batch, uids, self.ecfg.seed,
                    temps)
            else:
                tok0, small_cache = self._prefill(self.params, batch, uids,
                                                  self.ecfg.seed, temps)
            tok0 = tok0.cpu().numpy()             # [N] or [N, K] ints; syncs
            now = time.perf_counter()
        self.stats.prefill_s += now - t0
        self.stats.prefill_tokens += sum(lens) * K
        self.stats.prefix_hit_tokens += N * pre_len * K
        self.stats.prefill_padded_tokens += N * bucket * K
        self.stats.prefill_batches += 1
        self.stats.prefill_requests += N

        budgets = [min(r.max_new, self.ecfg.max_len - len(r.tokens))
                   for r in reqs]
        # single-token requests finish at admission; their dead rows ride
        # the batched insert (active=False, page-table row all trash) and
        # are fully overwritten by the slot's next occupant
        live = np.ones(N, bool)
        for i, (req, t, budget) in enumerate(zip(reqs, tok0, budgets)):
            if self._head(t) == req.eos_id or budget <= 1:
                reason = "eos" if self._head(t) == req.eos_id else "length"
                self._complete(req, [self._as_token(t)], reason,
                               admitted_at=now, token_times=[now])
                live[i] = False
                if plans:
                    self._release_plan(plans[i])
        if not live.any():
            if self.paged:
                self.stats.pages_in_use = self._pool.in_use
            return True                 # requests completed: progress
        slot_vals = {
            "tok": torch.as_tensor(tok0.astype(np.int32), device=dev),
            "emitted": torch.ones((N,), dtype=torch.int32, device=dev),
            "active": torch.as_tensor(live, device=dev),
            "budget": torch.as_tensor(budgets, dtype=torch.int32, device=dev),
            "eos": torch.as_tensor([r.eos_id for r in reqs],
                                   dtype=torch.int32, device=dev),
        }
        rows = torch.as_tensor(slots[:N], dtype=torch.int64, device=dev)
        insert_args = [self.cache, self.state, rows, small_cache, slot_vals]
        if self.paged:
            # logical -> physical rows for the insert: the full table per
            # row (unallocated tail maps to trash) plus the pages the
            # small cache writes — the whole padded ring when cold, only
            # the suffix pages on a prefix hit (shared prefix pages are
            # never rewritten)
            tbl_rows = np.zeros((N, self._n_per_slot), np.int32)
            n_w = self._n_per_slot if n_pre == 0 else -(-bucket // ps)
            write_rows = np.zeros((N, n_w), np.int64)
            for i, sp in enumerate(plans):
                if not live[i]:
                    continue
                tbl_rows[i, :len(sp.pages)] = sp.pages
                own = sp.pages[n_pre:]
                write_rows[i, :min(len(own), n_w)] = own[:n_w]
            insert_args += [torch.as_tensor(tbl_rows, device=dev),
                            torch.as_tensor(write_rows, device=dev)]
        with spans.span("serve.insert"):
            t0 = time.perf_counter()
            self.cache, self.state = self._insert(*insert_args)
            _sync(dev)    # the insert's cost lands in insert_s, not decode
            self.stats.insert_s += time.perf_counter() - t0
        if self.paged:
            self._tbl[slots[:N]] = tbl_rows    # host copy == device now
            if self.prefix_enabled:
                # every fully written prompt page becomes (or extends) a
                # registered chain; duplicate keys keep the first page
                for i, (req, sp) in enumerate(zip(reqs, plans)):
                    if live[i]:
                        n_full = len(req.tokens) // ps
                        self._pool.register(req.tokens[:n_full * ps],
                                            sp.pages[:n_full])
        for i in np.nonzero(live)[0]:
            self.sched.bind(slots[i], SlotRun(
                request=reqs[i], tokens=[self._as_token(tok0[i])],
                admitted_at=now, token_times=[now]))
            if self.paged:
                self._slot_pages[slots[i]] = plans[i]
        return True

    def _admit_ready(self) -> None:
        while True:
            free = self.sched.free_slots()
            if not free or not self.sched.queue:
                return
            # early-completed requests leave their slots free, so the loop
            # re-checks free slots and the new queue head's key each round
            width = 1 if self.ecfg.admission == "serial" else len(free)
            if self.chunked:
                # nothing runs at admission -> no admission-key
                # constraint; the page budget still gates the batch
                reqs = self.sched.next_batch(
                    width, lambda r: 0, cost_of=self._page_cost,
                    budget=self._pool.available())
                if not reqs or not self._admit_chunked(free, reqs):
                    return
                continue
            if self.paged:
                reqs = self.sched.next_batch(
                    width, self._admit_key, cost_of=self._page_cost,
                    budget=self._pool.available())
            else:
                reqs = self.sched.next_batch(width, self._admit_key)
            if not reqs or not self._admit(free, reqs):
                return

    def _complete(self, req: Request, tokens, reason: str, *,
                  admitted_at: float, token_times=None) -> None:
        tt = list(token_times or ())
        ttft = (tt[0] - (req.arrival_s or req.submitted_at)) if tt else 0.0
        self.completions.append(Completion(
            uid=req.uid, prompt_len=len(req.tokens), tokens=list(tokens),
            finish_reason=reason, submitted_at=req.submitted_at,
            admitted_at=admitted_at, finished_at=time.perf_counter(),
            arrival_s=req.arrival_s or req.submitted_at,
            ttft_s=ttft))

    # -- page lifecycle (paged contract only) ------------------------------

    def _grow_pages(self, active: list, n_steps: int) -> None:
        """Allocate the pages the coming chunk will write into, drawn
        from each slot's admission-time reservation (cannot fail). A row
        that exhausts its budget mid-chunk keeps writing — past its last
        allocated page those writes land on the trash page."""
        ps = self.ecfg.page_size
        for b in active:
            run = self.sched.slots[b]
            sp = self._slot_pages[b]
            L = len(run.request.tokens)
            g = len(run.tokens)                  # generated so far (tok0..)
            # chunk inputs sit at positions L+g-1 .. L+g-2+n_steps
            need = min(-(-(L + g - 1 + n_steps) // ps),
                       self._n_per_slot, sp.worst)
            delta = need - len(sp.pages)
            if delta > 0:
                new = self._pool.alloc_reserved(delta)
                self._tbl[b, len(sp.pages):need] = new
                sp.pages.extend(new)
                self._tbl_dirty = True
        self.stats.pages_in_use = self._pool.in_use
        self.stats.pages_peak = self._pool.pages_peak

    def _free_slot(self, b: int) -> None:
        """Return an evicted slot's pages — decref shared prefix pages,
        park registered ref-0 pages as evictable cache, free the rest —
        and point its table row back at trash."""
        self._release_plan(self._slot_pages.pop(b))
        self._tbl[b] = 0
        self._tbl_dirty = True
        self.stats.pages_in_use = self._pool.in_use

    def _push_tbl(self) -> None:
        """Upload the host page table if it changed (page growth or slot
        free): one host-to-device copy between chunks, never inside one."""
        if not self._tbl_dirty:
            return
        self.cache["page_tbl"].copy_(torch.from_numpy(self._tbl))
        self._tbl_dirty = False

    # -- decode loop -------------------------------------------------------

    def _decode_keys(self, rows):
        """Sampling keys of a decode chunk: per-slot uid, tokens drawn so
        far and temperature of ``rows`` (other slots: greedy dummies)."""
        runs = self.sched.slots
        B = len(runs)
        uids, emitted0, temps = [0] * B, [0] * B, [0.0] * B
        for b in rows:
            run = runs[b]
            uids[b] = run.request.uid
            emitted0[b] = len(run.tokens)
            temps[b] = float(run.request.temperature)
        return uids, emitted0, temps

    def _drain_cap(self, rows) -> int:
        """Decode steps for the coming chunk: ``chunk``, or with
        trim_drain, capped at the largest remaining budget of ``rows``
        (EOS can only end a row earlier; keys derive from (uid, token
        index), so trimming is token-identical at any temperature)."""
        n_steps = self.ecfg.chunk
        if self.ecfg.trim_drain:
            need = max(
                min(run.request.max_new,
                    self.ecfg.max_len - len(run.request.tokens))
                - len(run.tokens)
                for run in (self.sched.slots[b] for b in rows))
            n_steps = max(1, min(n_steps, need))
        return n_steps

    def step(self) -> bool:
        """One engine iteration. Chunked engines pack a token budget
        (decode chunk + one prefill chunk per mid-prompt slot); the others
        admit, then run one decode chunk. Returns False when idle."""
        with spans.span("serve.step"):
            if self.chunked:
                return self._step_chunked()
            return self._step_one_shot()

    def _step_one_shot(self) -> bool:
        with spans.span("serve.admit"):
            self._admit_ready()
        active = self.sched.active_slots()
        if not active:
            return False
        n_steps = self._drain_cap(active)
        decode = self._decode_at(n_steps)
        if self.paged:
            with spans.span("serve.pages"):
                self._grow_pages(active, n_steps)
                self._push_tbl()
        uids, emitted0, temps = self._decode_keys(active)
        with spans.span("serve.decode"):
            t0 = time.perf_counter()
            self.cache, self.state, toks = decode(
                self.params, self.cache, self.state, self.ecfg.seed, uids,
                emitted0, temps)
            toks = toks.cpu().numpy()                      # [T, B]; syncs
            now = time.perf_counter()
        self.stats.decode_s += now - t0
        self.stats.decode_chunks += 1
        self.stats.decode_steps += toks.shape[0]
        with spans.span("serve.harvest"):
            self._harvest(active, toks, now)
        return True

    def _harvest(self, active: list, toks, now: float) -> None:
        """Fold one synced chunk's tokens [T, B(, K)] into the bound runs;
        evict and complete rows that hit EOS or their budget."""
        for b in active:
            run = self.sched.slots[b]
            req = run.request
            budget = min(req.max_new, self.ecfg.max_len - len(req.tokens))
            for t in range(toks.shape[0]):
                tok = self._head(toks[t, b])
                run.tokens.append(self._as_token(toks[t, b]))
                run.token_times.append(now)
                self.stats.decode_tokens += self.K
                if tok == req.eos_id or len(run.tokens) >= budget:
                    self.sched.evict(b)
                    if self.paged:
                        self._free_slot(b)
                    self._complete(
                        req, run.tokens,
                        "eos" if tok == req.eos_id else "length",
                        admitted_at=run.admitted_at,
                        token_times=run.token_times)
                    break

    def _step_chunked(self) -> bool:
        """One token-budget iteration: plan decode steps + prefill
        chunks, enqueue the decode chunk FIRST, then one prefill chunk
        per mid-prompt slot, sync the decode tokens, harvest. Final-chunk
        slots sample their first token on the device inside the chunk and
        flip active there, so they join the NEXT iteration's decode
        chunk."""
        with spans.span("serve.admit"):
            self._admit_ready()
        active = self.sched.active_slots()
        if not active:
            return False
        pf = [b for b in active if not self._slot_pages[b].prefill_done]
        pf.sort(key=lambda b: self.sched.slots[b].request.uid)
        dec = [b for b in active if self._slot_pages[b].prefill_done]
        n_steps = self._drain_cap(dec) if dec else self.ecfg.chunk
        plan = self.sched.plan_step(
            budget=self._token_budget, chunk_tokens=self._chunk_tokens,
            decode_steps=n_steps if dec else 0, n_decode=len(dec),
            prefill_left=[
                (b, len(self.sched.slots[b].request.tokens)
                 - self._slot_pages[b].prefill_pos) for b in pf])

        with spans.span("serve.pages"):
            if dec:
                self._grow_pages(dec, plan.decode_steps)
            self._push_tbl()    # one upload covers decode AND chunks
        # the chunks' tokens go to the device before the decode chunk is
        # enqueued: a copy from host memory waits for the stream
        chunk_tokens = []
        for b, c in plan.chunks:
            req = self.sched.slots[b].request
            pos = self._slot_pages[b].prefill_pos
            sbucket = self._chunk_bucket(c)
            padded = np.zeros((1, sbucket, self.K) if self.K > 1
                              else (1, sbucket), np.int32)
            padded[0, :c] = np.asarray(req.tokens[pos:pos + c], np.int32)
            chunk_tokens.append(torch.as_tensor(padded, device=self.device))
        if not dec:
            finals = self._prefill_chunks(plan.chunks, chunk_tokens)
            with spans.span("serve.harvest"):
                self._arm_finals(finals)
            return True
        decode = self._decode_at(plan.decode_steps)
        uids, emitted0, temps = self._decode_keys(dec)
        with spans.span("serve.decode"):
            t0 = time.perf_counter()
            self.cache, self.state, toks = decode(
                self.params, self.cache, self.state, self.ecfg.seed, uids,
                emitted0, temps)
            finals = self._prefill_chunks(plan.chunks, chunk_tokens)
            toks = toks.cpu().numpy()                      # [T, B]; syncs
            now = time.perf_counter()
        self.stats.decode_s += now - t0
        self.stats.decode_chunks += 1
        self.stats.decode_steps += toks.shape[0]
        with spans.span("serve.harvest"):
            self._harvest(dec, toks, now)
            self._arm_finals(finals)
        return True

    def _prefill_chunks(self, chunks, chunk_tokens) -> list:
        """Enqueue one prefill chunk per (slot, tokens) of ``chunks``;
        returns the (slot, first token) of each prompt a chunk finished."""
        finals = []
        for (b, c), tokens in zip(chunks, chunk_tokens):
            req = self.sched.slots[b].request
            sp = self._slot_pages[b]
            pos = sp.prefill_pos
            final = pos + c == len(req.tokens)
            gen = min(req.max_new, self.ecfg.max_len - len(req.tokens))
            with spans.span("serve.prefill_chunk"):
                tc = time.perf_counter()
                self.cache, self.state, tok0 = self._chunk_prefill(
                    self.params, self.cache, self.state, {"tokens": tokens},
                    b, pos, c, sp.first_chunk, final, req.uid,
                    self.ecfg.seed, float(req.temperature), gen, req.eos_id)
                # enqueue time only: chunks are never synced here, their
                # compute lands in the next decode sync (decode_s)
                self.stats.prefill_s += time.perf_counter() - tc
            self.stats.prefill_chunks += 1
            self.stats.prefill_tokens += c * self.K
            self.stats.prefill_padded_tokens += tokens.shape[1] * self.K
            sp.prefill_pos = pos + c
            sp.first_chunk = False
            if final:
                sp.prefill_done = True
                finals.append((b, tok0))
        return finals

    def _arm_finals(self, finals) -> None:
        """Pull each finished prompt's first token (a sync each), register
        its full prompt pages, and complete a request that ends there."""
        ps = self.ecfg.page_size
        for b, tok0 in finals:
            raw = tok0.cpu().numpy()                       # syncs
            t = self._head(raw)
            now = time.perf_counter()
            run = self.sched.slots[b]
            req = run.request
            sp = self._slot_pages[b]
            if self.prefix_enabled:
                n_full = len(req.tokens) // ps
                self._pool.register(req.tokens[:n_full * ps],
                                    sp.pages[:n_full])
            run.tokens.append(self._as_token(raw))
            run.token_times.append(now)
            gen = min(req.max_new, self.ecfg.max_len - len(req.tokens))
            if t == req.eos_id or gen <= 1:
                self.sched.evict(b)
                self._free_slot(b)
                self._complete(req, run.tokens,
                               "eos" if t == req.eos_id else "length",
                               admitted_at=run.admitted_at,
                               token_times=run.token_times)

    def run(self) -> list[Completion]:
        """Serve until queue and slots drain. Completions in uid order."""
        while self.sched.pending:
            if not self.step() and not self.sched.queue:
                break
        return sorted(self.completions, key=lambda c: c.uid)
