"""Continuous-batching serve engine, slot contract (counterpart of
``repro/serve/engine.py``).

The engine owns one per-slot KV cache [L, B=slots, W, KV, hd] (cache
contract: models/model.py — ``cur`` [B], ``k_pos`` [B, W]) and runs decode
as a loop of ``chunk`` steps with embedding, stack, sampling and per-slot
EOS/budget masking all on the device: the host enqueues the whole chunk
and syncs once, on the chunk's tokens. Between chunks the host harvests
finished slots and admits queued requests into the freed rows.

Admission is batched by bucket: the scheduler pops up to
``len(free_slots)`` queued requests that share a power-of-two prefill
bucket and the engine prefills them in ONE ragged batch, samples every
admitted row's first token on the device, and syncs only the [N] token
vector. The admitted rows are then scattered into the big cache; a slot
write replaces the entire row (all W positions), so no state of the
previous occupant leaks into the new request's attention.

Sampling is schedule-invariant: greedy rows take the argmax (first index
on ties); a row with temperature > 0 draws with a ``torch.Generator``
seeded from (engine seed, uid, token index), a pure function of the
request and the token position. The host derives the index without a
sync: a slot's k-th chunk step draws token ``len(run.tokens) + k``. The
draws cannot match the reference's ``jax.random`` streams.

Timing is honest on the card: every span in ``EngineStats`` ends at a
host sync on the work it times (the token pull, or an explicit
``torch.cuda.synchronize`` after the insert), never at enqueue.

Not ported yet (ROADMAP.md, Queue A item 8): the paged cache, prefix
reuse and chunked prefill. ``EngineConfig(cache="paged")`` raises; under
``cache="slot"`` the reference itself ignores ``prefix_cache`` and
``chunk_prefill``, and so does the port.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.launch import steps as steps_mod
from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig

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
    probs = torch.softmax(logits_row.to(torch.float32)
                          / max(temperature, 1e-6), dim=-1)
    return torch.multinomial(probs, 1, generator=gen)[0].to(torch.int32)


def sample_tokens(gen: torch.Generator, logits, temperature):
    """Per-row sampling: temperature <= 0 -> greedy (argmax, first index
    on ties). logits [B, V]; ``temperature`` a host sequence of B floats;
    rows with temperature > 0 draw from ``gen`` in row order. Returns
    int32 [B] on logits' device."""
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
    Returns int32 [B]."""
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
        cache["k_pos"][slots] = small_cache["k_pos"].to(cache["k_pos"].dtype)
        for name, val in slot_vals.items():
            state[name][slots] = val.to(state[name].dtype)
        return cache, state

    return insert


def make_decode_chunk(cfg: ModelConfig, n_steps: int):
    """(params, cache, state, seed, uids, emitted0, temps) ->
    (cache, state, toks [T, B]): ``n_steps`` decode steps enqueued on the
    device with no host sync inside. Rows record their sampled token while
    active and 0 afterwards; ``emitted`` / ``active`` advance so the host
    can replay termination exactly (EOS or budget). ``uids`` /
    ``emitted0`` / ``temps`` are the host's per-slot request ids, tokens
    drawn so far and temperatures (sampling keys only)."""
    engine = steps_mod.make_engine(cfg)

    def chunk(params, cache, state, seed, uids, emitted0, temps):
        tok, emitted, active = state["tok"], state["emitted"], state["active"]
        budget, eos = state["budget"], state["eos"]
        toks = []
        for t in range(n_steps):
            logits, cache = M.decode_fn(params, {"tokens": tok[:, None]},
                                        cache, cfg, engine)
            # an active row's token index is emitted0 + t: the same key
            # no matter how steps are cut into chunks
            nxt = sample_tokens_indexed(seed, uids,
                                        [e + t for e in emitted0],
                                        logits, temps)
            nxt = torch.where(active, nxt, torch.zeros_like(nxt))
            emitted = emitted + active.to(torch.int32)
            active = active & (nxt != eos) & (emitted < budget)
            tok = nxt
            toks.append(nxt)
        new_state = dict(state, tok=tok, emitted=emitted, active=active)
        return cache, new_state, torch.stack(toks)

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
    cache: str = "slot"         # "slot": one full ring per slot. "paged"
                                # (the reference's default) is not
                                # ported yet and raises
    page_size: int = 16         # paged only
    n_pages: int | None = None  # paged only
    prefix_cache: bool = True   # paged only (ignored under "slot")
    chunk_prefill: int = 0      # paged only (ignored under "slot")
    token_budget: int | None = None  # chunked schedule only
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
        if self.cache == "paged":
            raise NotImplementedError(
                "the paged cache is not ported yet (ROADMAP.md, Queue A "
                "item 8); use cache='slot'")
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
    """Cumulative engine counters (seconds end at a device sync)."""
    prefill_s: float = 0.0
    prefill_tokens: int = 0        # real prompt tokens prefilled
    prefill_padded_tokens: int = 0  # incl. bucket padding
    prefill_batches: int = 0       # admission prefills (one forward each)
    prefill_requests: int = 0      # requests admitted across prefills
    insert_s: float = 0.0          # slot-insert time (the other half of
                                   # admission)
    prefill_chunks: int = 0        # chunked admission (not ported): 0
    decode_s: float = 0.0
    decode_chunks: int = 0
    decode_steps: int = 0          # sum of per-chunk decode steps (one
                                   # forward each)
    decode_tokens: int = 0         # real tokens emitted during decode
    pages_in_use: int = 0          # paged only (not ported): 0
    pages_peak: int = 0
    prefix_hit_tokens: int = 0
    # live-occupancy gauges, filled by ServeEngine.snapshot()
    slots_in_use: int = 0
    queue_depth: int = 0
    pages_free: int = 0

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
    def decode_tokens_per_s(self):
        return self.decode_tokens / self.decode_s if self.decode_s else 0.0


_STAT_GAUGES = frozenset({
    "slots_in_use", "queue_depth", "pages_free",
    "pages_in_use", "pages_peak",
})


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
    compute-dtype leaves cast once (``model.compute_params``)."""

    def __init__(self, cfg: ModelConfig, params, ecfg: EngineConfig = None,
                 *, device="cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("ServeEngine(device='cuda'): no CUDA device "
                               "is available; pass device='cpu' to serve "
                               "on the CPU")
        self.cfg = cfg
        self.ecfg = ecfg or EngineConfig()
        self.capacity = M.cache_capacity(cfg, self.ecfg.max_len)
        B = self.ecfg.slots
        self.params = M.compute_params(_to_device(params, self.device), cfg)
        self.cache = M.init_cache(cfg, B, self.ecfg.max_len, per_slot=True,
                                  device=self.device)
        dev = self.device
        self.state = {
            "tok": torch.zeros((B,), dtype=torch.int32, device=dev),
            "emitted": torch.zeros((B,), dtype=torch.int32, device=dev),
            "active": torch.zeros((B,), dtype=torch.bool, device=dev),
            "budget": torch.zeros((B,), dtype=torch.int32, device=dev),
            "eos": torch.full((B,), -1, dtype=torch.int32, device=dev),
        }
        self._prefill = make_prefill_sample(cfg, self.capacity)
        self._insert = make_slot_insert(cfg)
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
            fn = self._decode_fns[n_steps] = make_decode_chunk(self.cfg,
                                                               n_steps)
        return fn

    # -- request intake ----------------------------------------------------

    def submit(self, prompt_tokens, max_new: int, *, temperature: float = 0.0,
               eos_id: Optional[int] = None, uid: Optional[int] = None,
               arrival_s: Optional[float] = None) -> int:
        """Queue one request; returns its uid (sampling keys fold it in,
        so a caller-chosen uid keeps its stream wherever it is placed)."""
        toks = [int(t) for t in np.asarray(prompt_tokens).reshape(-1)]
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
        s.pages_free = 0
        return s

    # -- admission ---------------------------------------------------------

    def _bucket_of(self, length: int) -> int:
        return bucket_len(length, min_bucket=self.ecfg.min_bucket,
                          max_len=self.ecfg.max_prompt_len)

    def _admit_key(self, req: Request):
        return self._bucket_of(len(req.tokens))

    def _admit(self, slots: list, reqs: list) -> bool:
        """Admit ``reqs`` (same bucket) into free rows ``slots[:N]``: one
        ragged prefill with on-device first-token sampling, one multi-row
        insert. Only the [N] tok0 vector is synced."""
        N = len(reqs)
        lens = [len(r.tokens) for r in reqs]
        bucket = self._bucket_of(lens[0])
        padded = np.zeros((N, bucket), np.int32)
        for i, r in enumerate(reqs):
            padded[i, :lens[i]] = np.asarray(r.tokens, np.int32)
        batch = {"tokens": torch.as_tensor(padded, device=self.device),
                 "lengths": torch.as_tensor(lens, dtype=torch.int32,
                                            device=self.device)}
        uids = [r.uid for r in reqs]
        temps = [float(r.temperature) for r in reqs]

        t0 = time.perf_counter()
        tok0, small_cache = self._prefill(self.params, batch, uids,
                                          self.ecfg.seed, temps)
        tok0 = tok0.cpu().numpy()                      # [N] ints; syncs
        now = time.perf_counter()
        self.stats.prefill_s += now - t0
        self.stats.prefill_tokens += sum(lens)
        self.stats.prefill_padded_tokens += N * bucket
        self.stats.prefill_batches += 1
        self.stats.prefill_requests += N

        budgets = [min(r.max_new, self.ecfg.max_len - len(r.tokens))
                   for r in reqs]
        # single-token requests finish at admission; their dead rows ride
        # the batched insert (active=False) and are fully overwritten by
        # the slot's next occupant
        live = np.ones(N, bool)
        for i, (req, t, budget) in enumerate(zip(reqs, tok0, budgets)):
            if int(t) == req.eos_id or budget <= 1:
                reason = "eos" if int(t) == req.eos_id else "length"
                self._complete(req, [int(t)], reason, admitted_at=now,
                               token_times=[now])
                live[i] = False
        if not live.any():
            return True                 # requests completed: progress
        dev = self.device
        slot_vals = {
            "tok": torch.as_tensor(tok0.astype(np.int32), device=dev),
            "emitted": torch.ones((N,), dtype=torch.int32, device=dev),
            "active": torch.as_tensor(live, device=dev),
            "budget": torch.as_tensor(budgets, dtype=torch.int32, device=dev),
            "eos": torch.as_tensor([r.eos_id for r in reqs],
                                   dtype=torch.int32, device=dev),
        }
        rows = torch.as_tensor(slots[:N], dtype=torch.int64, device=dev)
        t0 = time.perf_counter()
        self.cache, self.state = self._insert(self.cache, self.state, rows,
                                              small_cache, slot_vals)
        _sync(dev)        # the insert's cost lands in insert_s, not decode
        self.stats.insert_s += time.perf_counter() - t0
        for i in np.nonzero(live)[0]:
            self.sched.bind(slots[i], SlotRun(
                request=reqs[i], tokens=[int(tok0[i])],
                admitted_at=now, token_times=[now]))
        return True

    def _admit_ready(self) -> None:
        while True:
            free = self.sched.free_slots()
            if not free or not self.sched.queue:
                return
            # early-completed requests leave their slots free, so the loop
            # re-checks free slots and the new queue head's bucket
            width = 1 if self.ecfg.admission == "serial" else len(free)
            reqs = self.sched.next_batch(width, self._admit_key)
            if not reqs or not self._admit(free, reqs):
                return

    def _complete(self, req: Request, tokens, reason: str, *,
                  admitted_at: float, token_times=None) -> None:
        tt = list(token_times or ())
        ttft = (tt[0] - (req.arrival_s or req.submitted_at)) if tt else 0.0
        itl = float(np.percentile(np.diff(tt), 99.0)) if len(tt) >= 2 else 0.0
        self.completions.append(Completion(
            uid=req.uid, prompt_len=len(req.tokens), tokens=list(tokens),
            finish_reason=reason, submitted_at=req.submitted_at,
            admitted_at=admitted_at, finished_at=time.perf_counter(),
            arrival_s=req.arrival_s or req.submitted_at,
            ttft_s=ttft, itl_p99_s=itl))

    # -- decode loop -------------------------------------------------------

    def step(self) -> bool:
        """One engine iteration: admit, then one decode chunk. Returns
        False when idle."""
        self._admit_ready()
        active = self.sched.active_slots()
        if not active:
            return False
        n_steps = self.ecfg.chunk
        if self.ecfg.trim_drain:
            # drain cap: when every surviving slot's remaining budget is
            # below the chunk size, run a shorter final chunk (EOS can only
            # end a row earlier; keys derive from (uid, token index), so
            # trimming is token-identical at any temperature)
            need = max(
                min(run.request.max_new,
                    self.ecfg.max_len - len(run.request.tokens))
                - len(run.tokens)
                for run in (self.sched.slots[b] for b in active))
            n_steps = max(1, min(n_steps, need))
        runs = self.sched.slots
        uids = [r.request.uid if r else 0 for r in runs]
        emitted0 = [len(r.tokens) if r else 0 for r in runs]
        temps = [float(r.request.temperature) if r else 0.0 for r in runs]
        decode = self._decode_at(n_steps)
        t0 = time.perf_counter()
        self.cache, self.state, toks = decode(
            self.params, self.cache, self.state, self.ecfg.seed, uids,
            emitted0, temps)
        toks = toks.cpu().numpy()                          # [T, B]; syncs
        now = time.perf_counter()
        self.stats.decode_s += now - t0
        self.stats.decode_chunks += 1
        self.stats.decode_steps += toks.shape[0]
        self._harvest(active, toks, now)
        return True

    def _harvest(self, active: list, toks, now: float) -> None:
        """Fold one synced chunk's tokens [T, B] into the bound runs;
        evict and complete rows that hit EOS or their budget."""
        for b in active:
            run = self.sched.slots[b]
            req = run.request
            budget = min(req.max_new, self.ecfg.max_len - len(req.tokens))
            for t in range(toks.shape[0]):
                tok = int(toks[t, b])
                run.tokens.append(tok)
                run.token_times.append(now)
                self.stats.decode_tokens += 1
                if tok == req.eos_id or len(run.tokens) >= budget:
                    self.sched.evict(b)
                    self._complete(
                        req, run.tokens,
                        "eos" if tok == req.eos_id else "length",
                        admitted_at=run.admitted_at,
                        token_times=run.token_times)
                    break

    def run(self) -> list[Completion]:
        """Serve until queue and slots drain. Completions in uid order."""
        while self.sched.pending:
            if not self.step() and not self.sched.queue:
                break
        return sorted(self.completions, key=lambda c: c.uid)
