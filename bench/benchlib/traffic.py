"""The one general traffic generator: it reads a mix's parameters (a
``traffic/<name>.json`` file) and the cell's settings, and makes the
inputs of a run from its seed.

Every seed gets the same set of sizes and gaps in another order: a
length or a gap is a fixed quantile of its distribution, (i + 0.5) / n
for i < n, and the seed permutes them. So runs with different seeds do
the same work, and only the token ids and the order differ.

Distributions (``{"dist": ...}``): ``uniform`` over [min, max];
``lognormal`` with ``median`` and ``sigma``, clipped to [min, max];
``exponential`` with ``mean`` (arrival gaps).
"""
from __future__ import annotations

import math
from statistics import NormalDist

import numpy as np


def rng(seed: int, stream: str) -> np.random.Generator:
    """A generator for one named stream of a run's seed (any size of
    seed: numpy's SeedSequence takes arbitrary integers)."""
    return np.random.default_rng([seed & ((1 << 128) - 1),
                                  *map(ord, stream)])


def quantiles(dist: dict, n: int) -> np.ndarray:
    """The n stratified quantiles of ``dist`` (float, unpermuted)."""
    u = (np.arange(n) + 0.5) / n
    kind = dist["dist"]
    if kind == "uniform":
        lo, hi = dist["min"], dist["max"]
        return lo + u * (hi - lo)
    if kind == "lognormal":
        z = np.array([NormalDist().inv_cdf(p) for p in u])
        x = dist["median"] * np.exp(dist["sigma"] * z)
        return np.clip(x, dist["min"], dist["max"])
    if kind == "exponential":
        return -dist["mean"] * np.log1p(-u)
    raise ValueError(f"unknown distribution {kind!r}")


def lengths(dist: dict, n: int, gen: np.random.Generator) -> np.ndarray:
    """n integer sizes: the quantiles rounded, in the seed's order."""
    q = np.rint(quantiles(dist, n)).astype(np.int64)
    if "min" in dist:
        q = np.clip(q, dist["min"], dist["max"])
    return gen.permutation(q)


# ---------------------------------------------------------------------------
# training: packed documents
# ---------------------------------------------------------------------------

def train_ring(traffic: dict, batch: int, seq: int, ring: int, vocab: int,
               eos_id: int, seed: int):
    """``ring`` batches of ``batch`` rows of ``seq`` tokens and their
    labels (int32 numpy [ring, batch, seq] each): documents of the mix's
    lengths, token ids uniform over the vocabulary, each ended by
    ``eos_id``, packed end to end; a row is the next ``seq + 1`` tokens of
    the stream, cut into inputs and next-token labels. Every row differs."""
    if not 0 <= eos_id < vocab:
        raise ValueError(f"eos id {eos_id} outside the vocabulary of {vocab}")
    need = ring * batch * (seq + 1)
    dist = traffic["doc_len"]
    n_docs = max(16, int(math.ceil(2 * need / np.mean(quantiles(dist, 4096)))))
    gen = rng(seed, "train")
    lens = lengths(dist, n_docs, gen)
    stream = gen.integers(0, vocab, size=int(lens.sum()), dtype=np.int64)
    stream[np.cumsum(lens) - 1] = eos_id
    if stream.size < need:
        raise ValueError("documents too short for the ring")
    rows = stream[:need].reshape(ring, batch, seq + 1).astype(np.int32)
    return rows[..., :-1], rows[..., 1:]


# ---------------------------------------------------------------------------
# serving: requests and their arrivals
# ---------------------------------------------------------------------------

def requests(traffic: dict, n: int, vocab: int, seed: int):
    """n requests: (prompt token ids int32, output tokens), the prompt
    lengths and output lengths drawn from the mix in the seed's order."""
    gen = rng(seed, "requests")
    p_len = lengths(traffic["prompt_len"], n, gen)
    o_len = lengths(traffic["output_len"], n, gen)
    return [(gen.integers(0, vocab, size=int(p), dtype=np.int64)
             .astype(np.int32), int(o)) for p, o in zip(p_len, o_len)]


def arrivals(rate_per_s: float, n: int, seed: int) -> np.ndarray:
    """Open-loop due times (seconds from the schedule's start) of n
    Poisson arrivals at ``rate_per_s``: the exponential gaps' quantiles
    in the seed's order, summed."""
    gaps = quantiles({"dist": "exponential", "mean": 1.0 / rate_per_s}, n)
    return np.cumsum(rng(seed, "arrivals").permutation(gaps))
