"""The one generator of every traffic mix, driven by the mix's data file
(``traffic/<name>.json``).

Lengths follow ``serving/sim/workload.py``'s lognormal (``median`` the
log-space location, ``sigma`` its spread, rounded, then clipped to
``[lo, hi]``) and arrivals its Poisson process (exponential gaps at
``rate_rps``), copied here as arithmetic, not imported.  Every seed sends the
same sizes in another order: n requests take the distributions' quantiles at
(i + 1/2) / n, and the seed deals gaps, prompt lengths and answer lengths
each in an order of its own, drawn uniformly.  So the arrivals come in the
bursts that independent users make (runs of short gaps fall where the seed
puts them), while every seed carries the same work.  Token ids are uniform
over the vocabulary, from the seed.

Kinds:
  * ``train``: token batches, a frozen copy of ``training/data.py``'s
    arithmetic: step ``s`` of seed ``seed`` draws (batch, seq + 1) ids from
    ``default_rng((seed, 0, s))``; tokens are the first seq, labels the
    last.
  * ``open``: an open loop, round(rate x seconds) requests due within the
    window, the gaps scaled to a mean of exactly 1 / rate.
"""
from __future__ import annotations

import math
import random
from dataclasses import dataclass
from statistics import NormalDist

import numpy as np


def _seed(seed: int) -> int:
    return int(seed) % (1 << 64)


def train_batch(seed: int, step: int, batch: int, seq: int, vocab: int) -> dict:
    rng = np.random.default_rng((_seed(seed), 0, step))
    toks = rng.integers(0, vocab, (batch, seq + 1), dtype=np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:].copy()}


def lognormal_lengths(spec: dict, n: int) -> list[int]:
    """n stratified draws of the lognormal ``spec`` (median, sigma, lo, hi),
    in increasing order."""
    nd = NormalDist()
    out = []
    for i in range(n):
        z = nd.inv_cdf((i + 0.5) / n)
        length = int(round(spec["median"] * math.exp(spec["sigma"] * z)))
        out.append(max(spec["lo"], min(length, spec["hi"])))
    return out


def exponential_gaps(rate: float, n: int) -> list[float]:
    """n stratified exponential gaps whose mean is exactly 1 / rate, in
    increasing order."""
    gaps = [-math.log(1.0 - (i + 0.5) / n) for i in range(n)]
    scale = n / (rate * sum(gaps))
    return [g * scale for g in gaps]


@dataclass
class RequestSpec:
    rid: int
    due_s: float          # seconds after the window opens
    prompt: list[int]
    max_new_tokens: int


def _prompt(seed: int, rid: int, length: int, vocab: int) -> list[int]:
    rng = np.random.default_rng((_seed(seed), 1, rid))
    return rng.integers(0, vocab, length).tolist()


def dealt(values: list, seed: int, stream: int) -> list:
    """``values`` in the order that ``seed`` deals them (uniform over every
    order; ``stream`` keeps the orders of one seed's quantities apart)."""
    out = list(values)
    random.Random(_seed(seed) * 4 + stream).shuffle(out)
    return out


def open_requests(traffic: dict, seed: int, seconds: float, vocab: int) -> list[RequestSpec]:
    n = max(1, int(round(traffic["rate_rps"] * seconds)))
    gaps = dealt(exponential_gaps(traffic["rate_rps"], n), seed, 0)
    prompts = dealt(lognormal_lengths(traffic["prompt"], n), seed, 1)
    outputs = dealt(lognormal_lengths(traffic["output"], n), seed, 2)
    out, t = [], 0.0
    for i in range(n):
        t += gaps[i]
        out.append(RequestSpec(i, t, _prompt(seed, i, prompts[i], vocab), outputs[i]))
    return out


def warmup_lengths(spec: dict, step: int) -> list[int]:
    """Prompt lengths that warm up the shapes a mix uses: every ``step``
    tokens across ``[lo, hi]``, both ends included."""
    lo, hi = spec["lo"], spec["hi"]
    return sorted(set(list(range(lo, hi, step)) + [hi]))
