"""Fault tolerance & straggler mitigation for long-running training.

* ``StepMonitor`` — per-step wall-time statistics with z-score straggler
  detection (on multi-host fleets each host reports; here single-host).
* ``run_with_restarts`` — supervision loop: on failure, restore the latest
  checkpoint (optionally onto a smaller/larger mesh = elastic rescale via
  CheckpointManager's resharding restore) and continue.
* ``ElasticPlan`` — recompute (dp, batch) after losing nodes while keeping
  tp/pp intact; the dry-run proves target meshes compile ahead of time.
"""
from __future__ import annotations

import math
import time
from dataclasses import dataclass, field
from typing import Callable

from repro_torch.training.checkpoint import CheckpointManager


@dataclass
class StepMonitor:
    window: int = 50
    z_threshold: float = 3.0
    times: list[float] = field(default_factory=list)
    stragglers: list[tuple[int, float]] = field(default_factory=list)
    _t0: float | None = None
    step: int = 0

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self) -> float:
        if self._t0 is None:
            raise RuntimeError("StepMonitor.stop() before start(): call "
                               "start() at the top of each step")
        dt = time.perf_counter() - self._t0
        self._t0 = None
        self.times.append(dt)
        self.times = self.times[-self.window:]
        self.step += 1
        if len(self.times) >= 10:
            mean = sum(self.times) / len(self.times)
            var = sum((t - mean) ** 2 for t in self.times) / len(self.times)
            std = math.sqrt(var)
            if std > 0 and (dt - mean) / std > self.z_threshold:
                self.stragglers.append((self.step, dt))
        return dt

    @property
    def mean_step_s(self) -> float:
        return sum(self.times) / max(len(self.times), 1)


@dataclass
class ElasticPlan:
    """Rescale DP after node loss, preserving tp/pp shards."""
    tp: int
    pp: int
    dp: int
    global_batch: int

    def rescale(self, surviving_chips: int) -> "ElasticPlan":
        shard = self.tp * self.pp
        new_dp = max(surviving_chips // shard, 1)
        # keep per-replica batch constant; shrink global batch accordingly
        per_dp = self.global_batch // self.dp
        return ElasticPlan(self.tp, self.pp, new_dp, per_dp * new_dp)


def run_with_restarts(train_loop: Callable[[int], int], ckpt: CheckpointManager,
                      *, max_restarts: int = 3,
                      on_restart: Callable[[int, Exception], None] | None = None) -> int:
    """``train_loop(start_step) -> final_step``; restarts from the latest
    checkpoint on failure.

    ``max_restarts`` bounds *consecutive* unproductive restarts: whenever a
    failed attempt checkpointed past the previous high-water step, the
    budget resets — a long run peppered with transient faults keeps going,
    while a crash loop that never advances still raises after
    ``max_restarts`` tries.
    """
    restarts = 0

    def latest() -> int:
        step = ckpt.latest_step()
        return -1 if step is None else step

    best = latest()
    while True:
        start = latest() + 1
        try:
            return train_loop(start)
        except Exception as e:  # noqa: BLE001 — supervision boundary
            now = latest()
            if now > best:      # durable progress since the last failure
                best = now
                restarts = 0
            restarts += 1
            if on_restart:
                on_restart(restarts, e)
            if restarts > max_restarts:
                raise
