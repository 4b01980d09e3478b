"""Serving engine: continuous batching over slot-based KV caches
(counterpart of ``repro/serving/engine.py``).

``ServingEngine`` keeps B cache slots; requests are admitted into free slots
(prefill populates the slot via the model's prefill path at batch=1, then the
KV rows are copied into the slot), and every engine step decodes one token
for all slots.  Per-slot positions make mixed-depth batches exact.

All timestamps flow through one injected ``clock`` (default: wall clock).
Trace replay passes a :class:`VirtualClock` driven in simulated seconds, so
caller-supplied ``arrival_s`` values — including ``0.0`` — are honored
exactly.

Where the reference rebuilds the cache arrays on every admission and step,
this engine owns its cache tensors and updates them in place.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import Model, zero_cache
from repro_torch.serving.sim.workload import VirtualClock  # noqa: F401  (re-exported)


@dataclass
class Request:
    rid: int
    prompt: list[int]
    max_new_tokens: int = 16
    arrival_s: float | None = None   # None: stamped by the engine's clock
    # outputs
    tokens: list[int] = field(default_factory=list)
    ttft_s: float | None = None
    finished_s: float | None = None
    slot: int | None = None


class ServingEngine:
    """``device=None`` is the card (raises where there is none); ``params``
    must lie on the engine's device.  ``plain_kernels`` as in :class:`Model`.
    An encoder-decoder config (Whisper) raises, as the reference's engine
    cannot serve one either."""

    def __init__(self, cfg: ModelConfig, params, *, slots: int = 4,
                 cache_len: int = 512, greedy: bool = True,
                 clock: Callable[[], float] = time.perf_counter,
                 device=None, plain_kernels: bool = False):
        if cfg.encoder_layers > 0:
            # the reference's engine prefills {"tokens": prompt} alone, and its
            # encoder then fails on the missing frame embeddings
            raise ValueError(f"ServingEngine: {cfg.name} is an encoder-decoder; the reference's "
                             "engine takes no frame embeddings, so neither does this one "
                             "(drive Model.prefill and decode_step with frame_embeds)")
        self.cfg = cfg
        self.clock = clock
        self.model = Model(cfg, device, plain_kernels=plain_kernels)
        self.device = self.model.device
        self.params = params
        self.slots = slots
        self.cache_len = cache_len
        self.cache = zero_cache(cfg, slots, cache_len, self.device)
        self.cache["pos"] = torch.zeros((slots,), dtype=torch.int32, device=self.device)
        self.active: dict[int, Request] = {}     # slot -> request
        self.queue: list[Request] = []
        self.greedy = greedy
        self._last_tok = torch.zeros((slots, 1), dtype=torch.long, device=self.device)
        self.finished: list[Request] = []

    # ------------------------------------------------------------------
    def submit(self, req: Request):
        if req.arrival_s is None:    # explicit 0.0 (trace replay) is kept
            req.arrival_s = self.clock()
        self.queue.append(req)

    def _free_slots(self) -> list[int]:
        return [s for s in range(self.slots) if s not in self.active]

    def _admit(self):
        for slot in self._free_slots():
            if not self.queue:
                break
            req = self.queue.pop(0)
            req.slot = slot
            prompt = torch.tensor([req.prompt], dtype=torch.long, device=self.device)
            logits, pc = self.model.prefill(self.params, {"tokens": prompt},
                                            cache_len=self.cache_len)
            tok = int(torch.argmax(logits[0, -1]))     # waits for the device
            req.tokens.append(tok)
            req.ttft_s = self.clock() - req.arrival_s
            # copy the single-request (batch=1) cache into this slot, in place,
            # every leaf of the layer's cache ({k, v}, MLA's {ckv, kr}, the
            # RG-LRU's state {h, conv}, the mLSTM's {conv, C, n, m} or the
            # sLSTM's {c, n, h, m})
            for mine, new in zip(self.cache["blocks"], pc["blocks"]):
                for name, t in mine.items():
                    t[slot].copy_(new[name][0])
            self.cache["pos"][slot] = len(req.prompt)
            self._last_tok[slot, 0] = tok
            self.active[slot] = req

    # ------------------------------------------------------------------
    def step(self) -> int:
        """Admit + one decode step for all slots.  Returns #active."""
        self._admit()
        if not self.active:
            return 0
        logits, self.cache = self.model.decode_step(self.params, self.cache,
                                                    {"tokens": self._last_tok})
        next_tok = torch.argmax(logits[:, 0], dim=-1)
        self._last_tok = next_tok[:, None]
        toks = next_tok.tolist()                       # one transfer a step
        done = []
        for slot, req in self.active.items():
            req.tokens.append(toks[slot])
            if len(req.tokens) >= req.max_new_tokens:
                req.finished_s = self.clock()
                done.append(slot)
        for slot in done:
            self.finished.append(self.active.pop(slot))
        return len(self.active) + len(done)

    def run_until_drained(self, max_steps: int = 10_000) -> list[Request]:
        steps = 0
        while (self.queue or self.active) and steps < max_steps:
            self.step()
            steps += 1
        return self.finished
