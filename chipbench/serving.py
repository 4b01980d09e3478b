"""What the serving modes share: the port's ``ServingEngine`` over the
benchmark's weights, its warm-up, the times of every output token, the
traced run's spans, and the check of served tokens against the reference.

Token times: a request's first token is stamped by the engine (its
``ttft_s`` from ``arrival_s``, which the open loop sets to the time the
request was due); every later token at the end of the engine step that
produced it, when the step has read its tokens back.
"""
from __future__ import annotations

import gc
import random
import time

from chipbench import judge, weights
from chipbench import traffic as tr
from chipbench.harness import port_config, reference
from chipbench.trace import DeviceSlice, Spans, Traced


class TokenTimes:
    """Each request's token times, read after every engine step."""

    def __init__(self, engine):
        self.engine = engine
        self.times: dict[int, list[float]] = {}
        self._finished = 0

    def record(self) -> None:
        now = time.perf_counter()
        eng = self.engine
        reqs = list(eng.active.values()) + eng.finished[self._finished:]
        self._finished = len(eng.finished)
        for r in reqs:
            ts = self.times.setdefault(r.rid, [])
            new = len(r.tokens) - len(ts)
            if new > 0 and not ts:
                ts.append(r.arrival_s + r.ttft_s)
                new -= 1
            ts.extend([now] * new)

    def clear(self) -> None:
        self.times.clear()
        self._finished = len(self.engine.finished)

    def gaps_until(self, t: float) -> list[float]:
        return [b - a for ts in self.times.values() for a, b in zip(ts, ts[1:]) if b <= t]


class Served:
    """The engine of one serving cell, and its traced run's instruments."""

    def __init__(self, ctx):
        from repro_torch.serving import ServingEngine
        torch = self.torch = ctx.torch
        self.ctx = ctx
        eng_cfg = ctx.cell["engine"]
        self.params = weights.make_params(ctx.cfgj, ctx.seed, ctx.device)
        ctx.mark("weights")
        self.engine = ServingEngine(port_config(ctx.cfgj), self.params, slots=eng_cfg["slots"],
                                    cache_len=eng_cfg["cache_len"], device=ctx.device)
        cuda = ctx.device.type == "cuda"
        self.sync = (lambda: torch.cuda.synchronize(ctx.device)) if cuda else None
        self.spans = Spans(ctx.trace, sync=self.sync)
        self.slice = DeviceSlice(torch, ctx.device) if ctx.trace else None
        eng = self.engine

        def decode_info(params, cache, batch):
            rows = sum(len(r.prompt) + len(r.tokens) for r in eng.active.values())
            return {"live": len(eng.active), "rows": rows}

        def prefill_info(params, batch, cache_len):
            return {"S": int(batch["tokens"].shape[1])}

        self.spans.wrap(eng.model, "prefill", "prefill", sync=True, info=prefill_info)
        self.spans.wrap(eng.model, "decode_step", "decode", sync=True, info=decode_info)
        self.times = TokenTimes(eng)

    def submit(self, spec: tr.RequestSpec, arrival_s: float | None) -> None:
        from repro_torch.serving import Request
        self.engine.submit(Request(rid=spec.rid, prompt=spec.prompt,
                                   max_new_tokens=spec.max_new_tokens, arrival_s=arrival_s))

    def warm_up(self) -> None:
        """A prefill at every ``warmup_step`` prompt tokens across the mix's
        range and two decode steps each, then the engine emptied."""
        from repro_torch.serving import Request
        eng, V = self.engine, self.ctx.cfgj["vocab_size"]
        step = self.ctx.cell["engine"]["warmup_step"]
        for i, n in enumerate(tr.warmup_lengths(self.ctx.traffic["prompt"], step)):
            eng.submit(Request(rid=-1 - i, prompt=[(7 * i + j) % V for j in range(n)],
                               max_new_tokens=3))
        eng.run_until_drained()
        eng.finished.clear()
        if self.sync is not None:
            self.sync()
        self.ctx.mark("warm_up")

    def step(self) -> None:
        with self.spans.span("engine.step", sync=True):
            self.engine.step()
        self.times.record()

    def slice_control(self, t: float, t0: float) -> None:
        """Start or stop the traced slice by the window's clock."""
        if self.slice is None:
            return
        sl = self.ctx.cell["trace_slice"]
        if self.slice.t_start is None and t - t0 >= sl["start_s"]:
            self.slice.start()
        elif self.slice.t_stop is None and self.slice.t_start is not None \
                and t - self.slice.t_start >= sl["seconds"]:
            self.slice.stop()

    def close_slice(self) -> None:
        if self.slice is not None and self.slice.t_start is not None \
                and self.slice.t_stop is None:
            self.slice.stop()

    def traced(self, t0: float, t1: float):
        if self.slice is None or self.slice.t_start is None:
            return None
        return Traced(self.ctx.cfgj, self.ctx.traffic, self.ctx.cell, self.spans,
                      self.slice.kernels(), self.slice.t_start, self.slice.t_stop, t0, t1)

    def free_program(self) -> None:
        """Drop the engine (its cache and state); the weights, which are the
        benchmark's, stay for the reference."""
        self.engine.cache = None
        self.engine = self.times.engine = None
        gc.collect()
        if self.sync is not None:
            self.torch.cuda.empty_cache()

    def check(self, finished: list) -> dict:
        """The served-token check over a sample of ``finished`` drawn from
        the seed, the longest request in it.  ``sample`` is what a control
        reads again: each request's sequence, positions and served tokens."""
        ctx = self.ctx
        k = ctx.cell["check"]["requests"]
        if not finished:
            raise RuntimeError("no request finished: nothing served can be checked")
        longest = max(finished, key=lambda r: (len(r.prompt) + len(r.tokens), r.rid))
        rest = sorted((r for r in finished if r is not longest), key=lambda r: r.rid)
        picked = [longest] + random.Random(int(ctx.seed)).sample(rest, min(k - 1, len(rest)))
        sample = {"seqs": [r.prompt + r.tokens[:-1] for r in picked],
                  "pos": [list(range(len(r.prompt) - 1, len(r.prompt) - 1 + len(r.tokens)))
                          for r in picked],
                  "tokens": [list(r.tokens) for r in picked]}
        ref = reference(ctx.cfgj).logits_at(self.params, sample["seqs"], sample["pos"])
        gap = max(judge.served_gap(lg, toks) for lg, toks in zip(ref, sample["tokens"]))
        numbers = {"logit_gap": gap, "served_tokens": sum(map(len, sample["tokens"])),
                   "requests_checked": len(picked)}
        return {"numbers": numbers, "checks": judge.checks(numbers, ctx.cell["limits"]),
                "sample": sample}


def controls(ctx, sample: dict) -> dict:
    """The control of a served check: the reference in float8 in the
    program's place, its first token at each position of the same sequences
    judged as a served token would be."""
    params = weights.make_params(ctx.cfgj, ctx.seed, ctx.device)
    ref = reference(ctx.cfgj).logits_at(params, sample["seqs"], sample["pos"])
    low = reference(ctx.cfgj, "fp8").logits_at(params, sample["seqs"], sample["pos"])
    return {"fp8": {"logit_gap": max(judge.served_gap(lg, lo.argmax(dim=1).tolist())
                                     for lg, lo in zip(ref, low))}}
