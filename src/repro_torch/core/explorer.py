"""Design-space exploration primitives and results (paper §3.5, §5.2).

The enumeration itself lives in :mod:`repro_torch.api.sweep`: a declarative
:class:`~repro_torch.api.sweep.SweepSpace` over :class:`~repro_torch.api.spec.SimSpec`
fields replaces the old hardcoded (tp, pp, batch, micro) grid, with
:func:`explore` kept as a deprecation shim for external callers.  This
module keeps the pieces both surfaces share: pruning rules
(user-extensible), :class:`Candidate`/:class:`EvalResult`, and
:class:`ExplorationResult` — the Pareto frontier over (system throughput
TPS/chip vs user-facing TPS/user), best-under-SLO queries and
step-time/goodput rankings of the paper's Fig. 13 workflow.

Throughput is first-class: candidates are grouped by the sub-results they
share (same tp/ep and per-shard batch ⇒ same traced, transformed and priced
block graphs), so a sweep pays the expensive stages once per group and the
simulator's :class:`~repro_torch.core.simcache.SimCache` serves the rest.
``ExplorationResult`` carries configs/sec and per-layer cache hit rates so
benchmarks can track the sweep-throughput trajectory.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Callable, Iterable

from repro_torch.configs.base import ModelConfig
from repro_torch.core.memory import COLLECTIVE_BUFFER_BYTES
from repro_torch.core.passes.base import ParallelConfig
from repro_torch.core.simulator import Report, Simulator, shard_memory_floor


@dataclass
class Candidate:
    par: ParallelConfig
    global_batch: int
    extra: dict = field(default_factory=dict)

    def key(self) -> tuple:
        p = self.par
        return (p.tp, p.pp, p.dp, p.pods, p.microbatches, self.global_batch)

    def B_local(self) -> int:
        return max(self.global_batch // max(self.par.dp * self.par.pods, 1), 1)

    def reuse_key(self) -> tuple:
        """Candidates with equal reuse keys share priced block graphs (the
        simulator's block-stage cache key, minus the sweep-constant parts)."""
        return (self.par.shard_key(), self.B_local())


@dataclass(frozen=True)
class FailedCandidate:
    """A quarantined candidate: it exhausted its execution contract
    (``max_retries`` worker deaths/timeouts, or raised inside evaluation)
    and was recorded instead of aborting the sweep.  A third outcome
    category next to evaluated/pruned — downstream tooling must never
    silently drop candidates (manifest rows carry ``status: failed``)."""
    cand: Candidate
    spec: object                 # the full SimSpec (json_hash for manifests)
    attempts: int
    reason: str
    traceback: str = ""          # compact summary, last frames only


@dataclass
class EvalResult:
    cand: Candidate
    report: Report
    pruned: bool = False
    reason: str = ""
    # request-level result when the sweep ran a serving scenario for this
    # candidate (per-replica workload share; see
    # repro_torch.serving.sim.ServingScenario)
    serving: object | None = None
    # resilience result when the sweep priced the candidate under failures
    # (repro_torch.resilience.ResilienceReport; objective="goodput_under_failures")
    resilience: object | None = None
    # the full SimSpec this candidate evaluated (set by repro_torch.api.sweep)
    spec: object | None = None

    @property
    def tps_per_chip(self) -> float:
        return self.report.tps_per_chip

    @property
    def tps_per_user(self) -> float:
        # decode: tokens per second seen by one request
        return 1e6 / self.report.step_time_us if self.report.mode == "decode" else 0.0

    @property
    def goodput_rps(self) -> float:
        """System-level SLO-attainment goodput.  A per-replica serving
        result is scaled by the candidate's replica count; a fleet result
        (``system_level`` reports, e.g. ``FleetReport``) already aggregates
        over its replicas and is passed through unscaled."""
        if self.serving is None:
            return 0.0
        if getattr(type(self.serving), "system_level", False):
            return self.serving.goodput_rps
        replicas = max(self.cand.par.dp * self.cand.par.pods, 1)
        return self.serving.goodput_rps * replicas

    @property
    def slo_attainment(self) -> float:
        return self.serving.slo_attainment if self.serving is not None else 0.0


# -------------------------- pruning rules ---------------------------------

def rule_divisibility(cfg: ModelConfig, c: Candidate) -> str | None:
    p = c.par
    if c.global_batch % (p.dp * p.pods) and c.global_batch >= p.dp * p.pods:
        return "batch not divisible by dp"
    if p.microbatches > max(c.global_batch // (p.dp * p.pods), 1):
        return "microbatches exceed local batch"
    return None


def rule_tp_too_wide(cfg: ModelConfig, c: Candidate) -> str | None:
    if c.par.tp > cfg.d_model // 64:
        return "tp wider than head granularity"
    return None


def rule_pp_layers(cfg: ModelConfig, c: Candidate) -> str | None:
    if c.par.pp > cfg.num_layers:
        return "more stages than layers"
    return None


def rule_memory_fit(hw_bytes: float, *, mode: str = "decode",
                    seq_len: int = 4096, cache_len: int = 0):
    """Closed-form memory-infeasibility pruning (pre-simulation).

    Estimates the per-device floor: sharded parameters + KV cache (decode)
    + collective staging buffers.  Every term is a component the full memory
    simulation also counts (before its >=1 fragmentation factor), so the
    estimate is a lower bound — a candidate pruned here could never have
    passed the post-simulation ``memory_limit`` filter, while feasible
    candidates are never pruned early.  The post-filter remains as the
    fallback for the activation/optimizer terms this estimate omits.
    """
    def rule(cfg: ModelConfig, c: Candidate, report: Report | None = None) -> str | None:
        param_dev, kv = shard_memory_floor(cfg, c.par, c.B_local(), mode,
                                           cache_len or seq_len)
        est = param_dev + kv + COLLECTIVE_BUFFER_BYTES
        if est > hw_bytes:
            return (f"memory-fit: params+KV >= {est / 1e9:.1f}GB "
                    f"> limit {hw_bytes / 1e9:.1f}GB")
        return None
    return rule


DEFAULT_RULES: list[Callable] = [rule_divisibility, rule_tp_too_wide, rule_pp_layers]


# -------------------------- exploration -----------------------------------

@dataclass
class ExplorationResult:
    # tuples: sweep results are shared (manifest writers, notebooks, the
    # legacy explore() shim) — immutability keeps them consistent
    evaluated: tuple
    pruned: tuple
    wall_time_s: float
    n_groups: int = 0                               # distinct reuse groups
    configs_per_sec: float = 0.0
    cache_stats: dict = field(default_factory=dict)  # per-layer hits/misses
    objective: str = "step_time"
    workers: int = 1                                # sweep evaluation processes
    # MetricsRegistry snapshot of the sweep (counters/histograms); filled by
    # sweep(), empty for the legacy explore() path
    metrics: dict = field(default_factory=dict)
    # quarantined candidates (FailedCandidate): exhausted retries or raised
    # during evaluation under sweep(strict=False) — a category distinct from
    # pruned (pruning is a *verdict*, failure is an execution outcome)
    failed: tuple = ()

    def pareto(self, x=lambda r: r.tps_per_user, y=lambda r: r.tps_per_chip
               ) -> list[EvalResult]:
        """Upper-right Pareto frontier (maximize both)."""
        pts = sorted(self.evaluated, key=lambda r: (-x(r), -y(r)))
        front, best_y = [], -math.inf
        for r in pts:
            if y(r) > best_y:
                front.append(r)
                best_y = y(r)
        return front

    def best_under_slo(self, *, tpot_ms: float | None = None,
                       min_tps_user: float | None = None) -> EvalResult | None:
        ok = self.evaluated
        if tpot_ms is not None:
            ok = [r for r in ok if r.report.step_time_us / 1e3 <= tpot_ms]
        if min_tps_user is not None:
            ok = [r for r in ok if r.tps_per_user >= min_tps_user]
        if not ok:
            return None
        return max(ok, key=lambda r: r.tps_per_chip)

    def ranked(self, objective: str | None = None) -> list[EvalResult]:
        """Candidates best-first under an objective.

        ``step_time`` ranks by steady-state per-step latency (the default);
        ``goodput`` ranks by system-level SLO-attainment
        throughput from the request-level serving simulation and requires
        ``sweep(..., objective="goodput")``.  The two orders genuinely
        differ under load: small batches win on step time while starving
        admission capacity — see docs/serving.md for a documented scenario.
        ``goodput_under_failures`` ranks by useful tokens per wall second
        from the resilience replay (then goodput fraction) and requires
        ``sweep(..., objective="goodput_under_failures")`` — fast-but-
        fragile configurations genuinely reorder under failures; see
        docs/resilience.md.
        """
        objective = objective or self.objective
        if objective == "goodput":
            if any(r.serving is None for r in self.evaluated):
                raise ValueError(
                    "goodput ranking needs sweep(objective='goodput')")
            return sorted(self.evaluated,
                          key=lambda r: (-r.goodput_rps,
                                         r.report.step_time_us
                                         if r.report else 0.0))
        if objective == "goodput_under_failures":
            if any(r.resilience is None for r in self.evaluated):
                raise ValueError(
                    "goodput_under_failures ranking needs "
                    "sweep(objective='goodput_under_failures')")
            # useful tokens per wall second is the deployment-facing number;
            # goodput fraction breaks ties between equal-throughput meshes
            return sorted(self.evaluated,
                          key=lambda r: (-r.resilience.tokens_per_s,
                                         -r.resilience.goodput,
                                         r.report.step_time_us
                                         if r.report else 0.0))
        if objective == "step_time":
            return sorted(self.evaluated,
                          key=lambda r: (r.report.step_time_us,
                                         -r.tps_per_chip))
        raise ValueError(f"unknown objective {objective!r}")


def _stats_delta(after: dict, before: dict) -> dict:
    return {layer: {k: after[layer][k] - before.get(layer, {}).get(k, 0)
                    for k in ("hits", "misses")}
            for layer in after}


def explore(sim: Simulator, cfg: ModelConfig, *, mode: str = "decode",
            seq_len: int = 4096, chips: int = 256,
            tp_choices: Iterable[int] = (1, 2, 4, 8, 16),
            pp_choices: Iterable[int] = (1, 2, 4),
            batch_choices: Iterable[int] = (8, 16, 32, 64, 128, 256),
            micro_choices: Iterable[int] = (1,),
            rules: list[Callable] | None = None,
            memory_limit: float | None = None,
            max_evals: int = 10_000, objective: str = "step_time",
            scenario=None) -> ExplorationResult:
    """Deprecated kwargs shim for external callers: the hardcoded
    (tp, pp, batch, micro) grid expressed as a declarative
    :class:`~repro_torch.api.sweep.SweepSpace` over :class:`~repro_torch.api.spec.SimSpec`
    fields — bit-identical candidates, pruning, grouping and rankings by
    construction.  Intra-repo code calls :func:`repro_torch.api.sweep.sweep`.
    """
    import warnings

    from repro_torch.api.spec import (
        Cluster, CharonDeprecationWarning, STEP_WORKLOADS, SimSpec,
    )
    from repro_torch.api.sweep import SweepSpace, sweep
    warnings.warn(
        "explore(sim, cfg, tp_choices=...) is deprecated; build a "
        "SweepSpace over SimSpec fields and call repro_torch.api.sweep (see "
        "docs/api.md)", CharonDeprecationWarning, stacklevel=2)
    if memory_limit is not None and memory_limit <= 0:
        # legacy 0.0 degenerately pruned everything; the spec surface uses
        # 0 for "unlimited", so refuse the ambiguous value outright
        raise ValueError("memory_limit must be positive; pass None (or "
                         "omit) for no limit")
    base = SimSpec(
        model=cfg,
        cluster=Cluster(sim.hw, chips=chips,
                        memory_limit=memory_limit or 0.0),
        workload=STEP_WORKLOADS[mode](seq_len=seq_len))
    space = SweepSpace(base, {
        "parallel.tp": tuple(tp_choices), "parallel.pp": tuple(pp_choices),
        "workload.global_batch": tuple(batch_choices),
        "parallel.microbatches": tuple(micro_choices)})
    return sweep(space, sim=sim, rules=rules, max_evals=max_evals,
                 objective=objective, scenario=scenario)
