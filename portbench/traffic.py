"""The one generator every traffic mix goes through.

A mix is a JSON file under `portbench/traffic/`; this module reads its
parameters and draws the inputs from the run's seed. The seed changes the
order of the work, not its amount: a mix of N requests takes the same N
quantiles of each distribution (prompt and answer lengths, the gaps
between arrivals) on every seed, and the seed permutes them and draws the
token ids. Two runs of one seed get the same inputs.

Kinds:
- "train": batches {'tokens': (B, S + 1) int32} of uniform token ids,
  every row different.
- "serve", "loop": "open": N = ceil(rate * seconds) requests with Poisson
  gaps (exponential quantiles / rate), each due at its arrival time; the
  lengths and gaps in a stratified order (`stratified`), so every part of
  the window offers the same mix.
- "serve", "loop": "closed": `clients` streams of requests; client c
  sends its next request when its last is answered. A client's first
  request takes a share (c + 0.5) / clients of its drawn answer, so the
  clients start spread over their answers as in a steady state.

Open-loop scheduling adapted from `tools/serve_bench.py`'s `_measure_window`
(which drives another package), with seeded Poisson gaps in place of its
fixed interval.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from statistics import NormalDist

import numpy as np

SEED_MODULUS = 2 ** 63


def rng_for(seed: int, stream: int) -> np.random.Generator:
    """An independent numpy stream per purpose, any whole-number seed."""
    return np.random.default_rng([int(seed) % SEED_MODULUS, stream])


def quantiles(dist: dict, n: int) -> np.ndarray:
    """The n mid-quantiles (i + 0.5) / n of a length distribution, as ints
    clipped to [min, max]: "lognormal" (median, sigma) or "uniform"."""
    u = (np.arange(n) + 0.5) / n
    kind = dist["dist"]
    if kind == "lognormal":
        z = np.array([NormalDist().inv_cdf(x) for x in u])
        vals = np.exp(math.log(dist["median"]) + dist["sigma"] * z)
        vals = np.rint(vals)
    elif kind == "uniform":
        span = dist["max"] - dist["min"] + 1
        vals = dist["min"] + np.floor(u * span)
    else:
        raise ValueError(f"unknown length distribution {kind!r}")
    return np.clip(vals, dist["min"], dist["max"]).astype(np.int64)


@dataclass
class Request:
    index: int
    prompt: list
    max_new: int
    due_s: float = 0.0      # open loop: offset from the window's start
    client: int = -1        # closed loop: the client that sends it


def stratified(values: np.ndarray, rng: np.random.Generator,
               block: int = 8) -> np.ndarray:
    """`values` in a seeded order in which every run of `block`
    consecutive places holds one value of each of `block` strata (by
    rank): any stretch of the schedule carries the same mix of sizes, so
    the seed changes the order of the work and not the work a window cuts
    off."""
    ranked = np.sort(values)
    strata = np.array_split(ranked, block)
    strata = [rng.permutation(s) for s in strata]
    out = []
    for i in range(max(len(s) for s in strata)):
        row = [s[i] for s in strata if i < len(s)]
        out.extend(rng.permutation(row))
    return np.array(out)


def open_loop(traffic: dict, seed: int, seconds: float, vocab: int
              ) -> list[Request]:
    """The window's requests in due order; lengths and gaps stratified."""
    rate = float(traffic["rate_per_s"])
    n = max(1, math.ceil(rate * seconds))
    rng = rng_for(seed, 1)
    p_len = stratified(quantiles(traffic["prompt"], n), rng)
    a_len = stratified(quantiles(traffic["answer"], n), rng)
    u = (np.arange(n) + 0.5) / n
    gaps = stratified(-np.log1p(-u) / rate, rng)
    due = np.cumsum(gaps) - gaps[0]
    ids = rng.integers(0, vocab, int(p_len.sum()))
    prompts = np.split(ids, np.cumsum(p_len)[:-1])
    return [Request(i, prompts[i].tolist(), int(a_len[i]), float(due[i]))
            for i in range(n)]


def closed_loop(traffic: dict, seed: int, vocab: int) -> list[list[Request]]:
    """Each client's requests in sending order (`per_client` of them)."""
    clients, per = int(traffic["clients"]), int(traffic["per_client"])
    n = clients * per
    rng = rng_for(seed, 3)
    p_len = rng.permutation(quantiles(traffic["prompt"], n))
    a_len = rng.permutation(quantiles(traffic["answer"], n))
    ids = rng.integers(0, vocab, int(p_len.sum()))
    prompts = [c.tolist() for c in np.split(ids, np.cumsum(p_len)[:-1])]
    out = []
    for c in range(clients):
        reqs = []
        for j in range(per):
            i = c * per + j
            max_new = int(a_len[i])
            if j == 0:
                max_new = max(1, math.ceil(max_new * (c + 0.5) / clients))
            reqs.append(Request(i, prompts[i], max_new, client=c))
        out.append(reqs)
    return out


def longest_request(traffic: dict) -> int:
    """prompt + answer of the longest request the mix can send."""
    return int(traffic["prompt"]["max"] + traffic["answer"]["max"])


def train_batches(traffic: dict, seed: int, vocab: int):
    """{'tokens': (B, S + 1) int32} batches of uniform token ids."""
    rng = rng_for(seed, 4)
    b, s = int(traffic["batch"]), int(traffic["seq"])
    while True:
        yield {"tokens": rng.integers(0, vocab, (b, s + 1), dtype=np.int32)}


def first_batches(traffic: dict, seed: int, vocab: int, n: int) -> list:
    it = train_batches(traffic, seed, vocab)
    return [next(it) for _ in range(n)]
