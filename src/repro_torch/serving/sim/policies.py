"""Pluggable batching policies for the serving event loop.

A policy turns pool state into the next engine iteration (a
:class:`StepPlan`); the event loop prices the plan through the step oracle
and applies its effects at completion time.  Policies see a ``pool`` duck
(see :class:`~repro_torch.serving.sim.sim.Pool`) with:

* ``queue``            — waiting requests (FIFO ``deque``)
* ``running``          — decode-phase requests (hold a KV slot)
* ``prefilling``       — admitted requests whose prompt is (partially)
                         unprocessed
* ``pending_arrivals`` — arrivals not yet delivered, so static batching can
                         distinguish "wait for a full batch" from "drain the
                         tail of the trace"

``plan`` may mutate the pool's queues (admission) but never timestamps —
those belong to the event loop.  Returning ``None`` means "idle until the
next event".
"""
from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class StepPlan:
    """One engine iteration: prompt chunks to prefill + sequences to decode."""
    kind: str                                      # prefill | decode | mixed
    prefill: list = field(default_factory=list)    # (SimRequest, chunk_tokens)
    decode: list = field(default_factory=list)     # SimRequests, 1 token each


class StaticBatching:
    """Gang scheduling: admit a batch, prefill it, decode until every member
    finishes, then admit the next batch.  A partial batch is admitted only
    when no further arrivals can top it up (end-of-trace drain)."""

    name = "static"

    def __init__(self, batch_size: int = 8):
        self.batch_size = batch_size

    def plan(self, pool, now: float) -> StepPlan | None:
        if pool.running:
            return StepPlan("decode", decode=list(pool.running))
        if pool.prefilling:                 # cohort prefill already planned
            return None
        if len(pool.queue) < self.batch_size and pool.pending_arrivals > 0:
            return None                     # wait for a full gang
        if not pool.queue:
            return None
        n = min(self.batch_size, len(pool.queue))
        admit = [pool.queue.popleft() for _ in range(n)]
        pool.prefilling.extend(admit)
        return StepPlan("prefill", prefill=[(r, r.prompt_len) for r in admit])


class ContinuousBatching:
    """vLLM-v0-style continuous batching: free KV slots are refilled from the
    queue every iteration; newly admitted requests run one batched full
    prefill step (decode pauses for it), then join the decode batch.
    ``admit_cap`` bounds admissions per step, limiting prefill stalls."""

    name = "continuous"

    def __init__(self, max_batch: int = 16, admit_cap: int | None = None):
        self.max_batch = max_batch
        self.admit_cap = admit_cap

    def plan(self, pool, now: float) -> StepPlan | None:
        free = self.max_batch - len(pool.running) - len(pool.prefilling)
        n = min(free, len(pool.queue), self.admit_cap or free)
        if n > 0:
            admit = [pool.queue.popleft() for _ in range(n)]
            pool.prefilling.extend(admit)
            return StepPlan("prefill",
                            prefill=[(r, r.prompt_len) for r in admit])
        if pool.running:
            return StepPlan("decode", decode=list(pool.running))
        return None


class ChunkedPrefill:
    """Sarathi-style chunked prefill: every iteration carries a token budget;
    each decode sequence costs one token and the remainder goes to the
    head-of-line prompt, so long prompts never stall decode for a whole
    prefill.  One prompt chunks at a time (FCFS)."""

    name = "chunked"

    def __init__(self, max_batch: int = 16, token_budget: int = 256):
        self.max_batch = max_batch
        self.token_budget = token_budget

    def plan(self, pool, now: float) -> StepPlan | None:
        decode = list(pool.running)
        if (not pool.prefilling and pool.queue
                and len(pool.running) + 1 <= self.max_batch):
            pool.prefilling.append(pool.queue.popleft())
        prefill = []
        budget = self.token_budget - len(decode)
        if pool.prefilling and budget > 0:
            head = pool.prefilling[0]
            chunk = min(budget, head.prompt_len - head.prefilled)
            if chunk > 0:
                prefill.append((head, chunk))
        if not decode and not prefill:
            return None
        kind = ("mixed" if decode and prefill
                else "prefill" if prefill else "decode")
        return StepPlan(kind, prefill=prefill, decode=decode)


class PrefillOnly:
    """FCFS batched full prefill — the prefill side of disaggregation."""

    name = "prefill_only"

    def __init__(self, batch_size: int = 1):
        self.batch_size = batch_size

    def plan(self, pool, now: float) -> StepPlan | None:
        if not pool.queue:
            return None
        n = min(self.batch_size, len(pool.queue))
        admit = [pool.queue.popleft() for _ in range(n)]
        pool.prefilling.extend(admit)
        return StepPlan("prefill", prefill=[(r, r.prompt_len) for r in admit])


class DecodeOnly:
    """Pure continuous decode — the decode side of disaggregation.  Arriving
    requests are already prefilled, so admission is free: the queue drains
    straight into the running batch whenever slots are open."""

    name = "decode_only"

    def __init__(self, max_batch: int = 16):
        self.max_batch = max_batch

    def plan(self, pool, now: float) -> StepPlan | None:
        while pool.queue and len(pool.running) < self.max_batch:
            pool.running.append(pool.queue.popleft())
        if pool.running:
            return StepPlan("decode", decode=list(pool.running))
        return None


@dataclass
class DisaggregatedPD:
    """Prefill/decode disaggregation: arrivals prefill on a dedicated pool,
    then migrate (paying a KV-transfer latency) to a decode pool running
    pure continuous decode.  Removes prefill/decode interference at the
    price of the transfer and a second set of chips; the event loop expands
    this descriptor into two pools."""

    prefill_batch: int = 1
    decode_batch: int = 16
    transfer_s: float = 0.002

    name = "disaggregated"


def make_policy(name: str, max_batch: int, *, token_budget: int = 256):
    """Name -> policy instance: the one registry shared by
    :class:`~repro_torch.api.spec.ServingWorkload` and
    :class:`~repro_torch.serving.sim.sim.ServingScenario` (policies that need
    richer construction, e.g. :class:`DisaggregatedPD`, are passed as
    objects instead of names)."""
    if name == "continuous":
        return ContinuousBatching(max_batch)
    if name == "chunked":
        return ChunkedPrefill(max_batch, token_budget=token_budget)
    if name == "static":
        return StaticBatching(max_batch)
    raise ValueError(f"unknown serving policy {name!r}")
