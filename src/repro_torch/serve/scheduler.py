"""Host-side scheduling for the continuous-batching serve engine
(counterpart of ``repro/serve/scheduler.py``, ported whole).

Pure-Python bookkeeping, free of any array library: requests, completions,
the FIFO admission queue, the prompt-length bucketing policy, and the
token-budget step planner that interleaves chunked prefill with decode.
The device-side counterpart (cache slots, on-device decode) lives in
engine.py.

Bucketing: prompts are right-padded to power-of-two buckets (floored at
`min_bucket`), so requests of nearby lengths share one ragged prefill
batch and the number of distinct prefill shapes is log2(max_prompt_len)
(the reference compiles one trace per shape) — pad tokens are causally downstream of
every real token and are excluded from the KV cache by the ragged
prefill (models/model.py), so bucketing is semantics-free for attention
caches. SSM/conv states *are* contaminated by trailing pads, so stateful
archs (mamba / hybrid) use exact-length buckets instead.

Token-budget planning (`plan_step`): instead of the phase-separated
admit-then-decode loop (one whole-prompt prefill dispatch stalls every
in-flight request), each engine iteration packs a fixed token budget
with (a) on-device decode steps for every decode-phase slot and (b) one
chunk of at most `chunk_tokens` prompt tokens from each prefill-phase
slot. Decode is never skipped (tail latency is the point), but when
prefills are in flight the planner reserves their chunk allowance
*before* sizing the decode chunk, so a generous budget cannot be eaten
entirely by decode and starve admission-in-progress — and symmetrically
a tiny budget still decodes at least one step.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Optional


def next_pow2(n: int) -> int:
    return 1 if n <= 1 else 1 << (n - 1).bit_length()


def bucket_len(length: int, *, min_bucket: int = 16, max_len: int,
               exact: bool = False) -> int:
    """Padded prompt length for a real prompt of `length` tokens.

    Validation is shared by both bucketing policies: the exact-length
    (SSM) path rejects over-long prompts exactly like the pow2 path."""
    if length > max_len:
        raise ValueError(f"prompt length {length} exceeds max_len {max_len}")
    if exact:
        return length
    # top bucket is clamped to max_len itself (not its pow2 ceiling):
    # nothing requires it to be a power of two, and padding past
    # max_len would only waste prefill compute
    return min(max(next_pow2(length), min_bucket), max_len)


@dataclasses.dataclass
class Request:
    uid: int
    tokens: list            # prompt token ids; multi-codebook (K > 1)
                            # prompts hold one K-tuple per position —
                            # len() / slicing / bucket keys and page
                            # costs all stay positional, and tuples
                            # keep prefix-chain keys hashable
    max_new: int
    temperature: float = 0.0
    eos_id: int = -1        # -1: never stops on a token
    submitted_at: float = 0.0
    arrival_s: float = 0.0  # when the request entered the SYSTEM — the
                            # router's front door when routed, else the
                            # engine submit time (engine.submit defaults
                            # it). submitted_at - arrival_s is the time
                            # spent queued ABOVE this engine.


@dataclasses.dataclass
class Completion:
    uid: int
    prompt_len: int
    tokens: list            # generated ids (includes the eos if hit);
                            # K-tuples per position when K > 1
    finish_reason: str      # "eos" | "length" | "shed" (router dropped
                            # it under backpressure; tokens is empty)
    submitted_at: float = 0.0
    admitted_at: float = 0.0
    finished_at: float = 0.0
    arrival_s: float = 0.0  # system entry (Request.arrival_s)
    ttft_s: float = 0.0     # submit -> first token visible on host

    @property
    def _arrival(self) -> float:
        # completions minted before arrival_s existed (or built by hand
        # in tests) leave it 0.0: fall back to the engine submit time
        return self.arrival_s or self.submitted_at

    @property
    def latency_s(self) -> float:
        return self.finished_at - self._arrival

    @property
    def queue_s(self) -> float:
        """Total wait before compute: arrival -> engine admission.
        Splits exactly into router_queue_s + engine_queue_s, fixing the
        blind spot where router wait was only measurable by the
        caller's own bookkeeping."""
        return self.admitted_at - self._arrival

    @property
    def router_queue_s(self) -> float:
        """Wait above the engine (router queue); 0 when not routed."""
        return self.submitted_at - self._arrival

    @property
    def engine_queue_s(self) -> float:
        """Wait inside the engine (submit -> slot admission)."""
        return self.admitted_at - self.submitted_at


@dataclasses.dataclass
class SlotRun:
    """One in-flight request bound to a decode-batch slot."""
    request: Request
    tokens: list            # generated so far (host copy)
    admitted_at: float
    # host-visible timestamp per harvested token (one per chunk sync for
    # every token the chunk emitted) — the raw series behind ttft/ITL
    token_times: list = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class StepPlan:
    """One engine iteration's worth of work under the token budget."""
    decode_steps: int       # decode steps for the shared decode chunk
    chunks: list            # [(slot, n_tokens)] prefill chunks, FIFO order
    spare: int              # budget left unpacked (informational)


class TokenBudgetScheduler:
    """FIFO admission over a fixed set of decode slots, plus the
    token-budget packing policy for chunked-prefill engines. Also
    exported as ``FifoScheduler``, as in the reference."""

    def __init__(self, n_slots: int):
        self.queue: collections.deque[Request] = collections.deque()
        self.slots: list[Optional[SlotRun]] = [None] * n_slots

    def submit(self, req: Request) -> None:
        self.queue.append(req)

    def free_slots(self) -> list[int]:
        return [i for i, s in enumerate(self.slots) if s is None]

    def active_slots(self) -> list[int]:
        return [i for i, s in enumerate(self.slots) if s is not None]

    def next_request(self) -> Optional[Request]:
        return self.queue.popleft() if self.queue else None

    def next_batch(self, n: int, key_of, *, cost_of=None,
                   budget: int | None = None) -> list:
        """Pop up to `n` requests that share the head request's admission
        key (``key_of``: Request -> hashable; for the engine this is the
        prefill bucket plus, under prefix caching, the matched page
        chain — requests in one batch prefill in ONE ragged dispatch, so
        they must agree on both).

        The queue head always leads — its key defines the batch, so a
        request can never be starved by later arrivals — and requests
        left behind keep their relative order.

        With ``cost_of``/``budget`` (paged admission: worst-case new
        pages vs pages available) the batch additionally stays within
        budget. A head that doesn't fit by itself blocks the whole
        queue — admitting cheaper later requests over its head would
        starve large prompts under sustained load — so the engine sees
        [] and waits for decode to free pages (backpressure, no OOM).

        Scanning stops as soon as the batch is full: the untouched tail
        is never popped/re-appended (an earlier version rotated the
        whole queue through popleft/append on every admission round —
        O(queue) churn per batch under load for no benefit)."""
        if n < 1 or not self.queue:
            return []
        remaining = budget
        if cost_of is not None and remaining is not None \
                and cost_of(self.queue[0]) > remaining:
            return []                   # head-of-line backpressure
        head_key = key_of(self.queue[0])
        taken, skipped = [], []
        while self.queue and len(taken) < n:
            req = self.queue.popleft()
            cost = cost_of(req) if cost_of is not None else 0
            if key_of(req) == head_key and \
                    (remaining is None or cost <= remaining):
                taken.append(req)
                if remaining is not None:
                    remaining -= cost
            else:
                skipped.append(req)
        # skipped requests return to the FRONT (before the untouched
        # tail), preserving the original relative order
        self.queue.extendleft(reversed(skipped))
        return taken

    def plan_step(self, *, budget: int, chunk_tokens: int,
                  decode_steps: int, n_decode: int,
                  prefill_left: list) -> StepPlan:
        """Pack one engine iteration: `n_decode` decode-phase slots (one
        token per slot per decode step, up to `decode_steps` steps) and
        `prefill_left` = [(slot, remaining_prompt_tokens)] in admission
        order, each taking a chunk of at most `chunk_tokens`.

        Decode comes first in the schedule — a decoding slot is never
        skipped for a new prefill chunk — but in-flight prefills get
        their chunk allowance *reserved* before the decode chunk is
        sized, so decode cannot absorb the entire budget and stall
        admission (which would just recreate, over more steps, the
        phase-separated behavior this planner replaces). Both sides are
        floored at one unit of progress per iteration, so no slot ever
        starves regardless of how tight the budget is."""
        if chunk_tokens < 1:
            raise ValueError(f"chunk_tokens ({chunk_tokens}) must be >= 1")
        want = [(slot, min(chunk_tokens, max(left, 0)))
                for slot, left in prefill_left if left > 0]
        steps = 0
        if n_decode > 0 and decode_steps > 0:
            for_decode = budget - sum(n for _, n in want)
            steps = max(1, min(decode_steps, for_decode // n_decode))
            budget -= n_decode * steps
        chunks = []
        for slot, n in want:
            n = min(n, max(budget, 0))
            if n < 1:
                # liveness floor: an in-flight prefill always advances
                # at least one token per iteration, even when decode
                # (at its own floor) already overflowed the budget
                n = 1 if not chunks else 0
            if n:
                chunks.append((slot, n))
                budget -= n
        return StepPlan(decode_steps=steps, chunks=chunks,
                        spare=max(budget, 0))

    def bind(self, slot: int, run: SlotRun) -> None:
        assert self.slots[slot] is None, f"slot {slot} busy"
        self.slots[slot] = run

    def evict(self, slot: int) -> SlotRun:
        run = self.slots[slot]
        assert run is not None, f"slot {slot} already free"
        self.slots[slot] = None
        return run

    @property
    def pending(self) -> bool:
        return bool(self.queue) or any(s is not None for s in self.slots)


# the reference package's other public name for the same class
FifoScheduler = TokenBudgetScheduler
