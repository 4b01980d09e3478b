"""Serving metrics: percentile summaries, SLO goodput, utilization.

``ServingReport`` is the request-level analogue of the core simulator's
``Report``: instead of one steady-state step time it carries the TTFT/TPOT/
end-to-end *distributions* a deployment decision actually hinges on, plus
SLO-attainment goodput — the objective the explorer can rank parallelism
configs by (``sweep(..., objective="goodput")``).  ``FleetReport`` is the
same thing one level up: per-replica ``ServingReport``s plus fleet-wide
distributions, replica utilization and the autoscaler trace.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import ClassVar


@dataclass(frozen=True)
class SLO:
    """Per-request latency targets; a request "meets SLO" when both hold."""
    ttft_s: float = 2.0
    tpot_ms: float = 100.0

    def met(self, r) -> bool:
        return r.ttft_s <= self.ttft_s and r.tpot_ms <= self.tpot_ms


@dataclass(frozen=True)
class Percentiles:
    p50: float
    p90: float
    p99: float
    mean: float
    max: float

    @staticmethod
    def of(values) -> "Percentiles":
        s = sorted(values)
        if not s:
            return Percentiles(0.0, 0.0, 0.0, 0.0, 0.0)

        def q(p: float) -> float:
            i = (len(s) - 1) * p
            lo, hi = math.floor(i), math.ceil(i)
            return s[lo] + (s[hi] - s[lo]) * (i - lo)

        return Percentiles(q(0.50), q(0.90), q(0.99), sum(s) / len(s), s[-1])

    def as_dict(self, scale: float = 1.0, nd: int = 4) -> dict:
        return {k: round(getattr(self, k) * scale, nd)
                for k in ("p50", "p90", "p99", "mean", "max")}


@dataclass
class ServingReport:
    """Aggregate result of one workload replay through one policy."""
    n_requests: int
    makespan_s: float                   # first arrival -> last completion
    ttft_s: Percentiles                 # time to first token
    tpot_ms: Percentiles                # per-output-token latency after first
    e2e_s: Percentiles                  # arrival -> completion
    queue_delay_s: Percentiles          # arrival -> first scheduled
    prompt_tokens: int
    output_tokens: int
    tokens_per_s: float                 # (prompt + output) / makespan
    output_tokens_per_s: float
    requests_per_s: float
    slo: SLO | None
    slo_attainment: float               # fraction of requests meeting SLO
    goodput_rps: float                  # attainment * requests_per_s
    n_steps: int
    steps_by_kind: dict                 # step kind -> count
    utilization: dict                   # pool -> {busy_frac, <kind>_frac, steps}
    oracle_stats: dict = field(default_factory=dict)  # serving-bucket delta
    # finished SimRequests; a tuple because report objects are cache-shared
    # (charon-lint R1: cached values must be immutable or copied)
    requests: tuple = field(default_factory=tuple)

    @staticmethod
    def build(reqs, pools, slo: SLO | None,
              oracle_stats: dict) -> "ServingReport":
        t0 = min((r.arrival_s for r in reqs), default=0.0)
        t1 = max((r.finished_s for r in reqs), default=0.0)
        makespan = max(t1 - t0, 1e-12)
        prompt_toks = sum(r.prompt_len for r in reqs)
        out_toks = sum(r.output_len for r in reqs)
        attain = (sum(1 for r in reqs if slo.met(r)) / len(reqs)
                  if slo and reqs else 1.0)
        rps = len(reqs) / makespan
        steps_by_kind: dict[str, int] = {}
        util: dict[str, dict] = {}
        for p in pools:
            for k, n in p.steps_by_kind.items():
                steps_by_kind[k] = steps_by_kind.get(k, 0) + n
            u = {"busy_frac": round(p.busy_s / makespan, 4),
                 "steps": p.n_steps}
            for k, s in p.phase_s.items():
                u[f"{k}_frac"] = round(s / makespan, 4)
            util[p.name] = u
        return ServingReport(
            n_requests=len(reqs), makespan_s=makespan,
            ttft_s=Percentiles.of([r.ttft_s for r in reqs]),
            tpot_ms=Percentiles.of([r.tpot_ms for r in reqs]),
            e2e_s=Percentiles.of([r.e2e_s for r in reqs]),
            queue_delay_s=Percentiles.of([r.queue_delay_s for r in reqs]),
            prompt_tokens=prompt_toks, output_tokens=out_toks,
            tokens_per_s=(prompt_toks + out_toks) / makespan,
            output_tokens_per_s=out_toks / makespan,
            requests_per_s=rps, slo=slo, slo_attainment=attain,
            goodput_rps=attain * rps,
            n_steps=sum(p.n_steps for p in pools),
            steps_by_kind=steps_by_kind, utilization=util,
            oracle_stats=oracle_stats, requests=tuple(reqs))

    # per-replica serving results are replica-level; FleetReport overrides
    system_level: ClassVar[bool] = False

    # ---- attribution (repro_torch.obs.explain) ----
    def explain(self, top_k: int = 8) -> str:
        """Plain-text attribution: dominant SLO-violation cause (queueing vs
        prefill vs decode), queue-delay share of TTFT, step mix, busiest
        lanes."""
        from repro_torch.obs.explain import render_serving
        return render_serving(self, top_k=top_k)

    def explain_dict(self, top_k: int = 8) -> dict:
        """Structured form of :meth:`explain` (what sweep manifests embed)."""
        from repro_torch.obs.explain import explain_serving
        return explain_serving(self, top_k=top_k)

    def summary(self) -> dict:
        """Flat dict for benchmarks / examples."""
        return {
            "n_requests": self.n_requests,
            "makespan_s": round(self.makespan_s, 3),
            "ttft_p50_s": round(self.ttft_s.p50, 4),
            "ttft_p99_s": round(self.ttft_s.p99, 4),
            "tpot_p50_ms": round(self.tpot_ms.p50, 3),
            "tpot_p99_ms": round(self.tpot_ms.p99, 3),
            "queue_delay_p50_s": round(self.queue_delay_s.p50, 4),
            "tokens_per_s": round(self.tokens_per_s, 1),
            "output_tokens_per_s": round(self.output_tokens_per_s, 1),
            "requests_per_s": round(self.requests_per_s, 3),
            "slo_attainment": round(self.slo_attainment, 4),
            "goodput_rps": round(self.goodput_rps, 3),
            "n_steps": self.n_steps,
            "steps_by_kind": dict(self.steps_by_kind),
            "utilization": self.utilization,
            "oracle_stats": self.oracle_stats,
        }


# ----------------------------------------------------------------------
@dataclass
class FleetReport:
    """Aggregate result of one workload replay through a replica fleet.

    Fleet-wide percentiles/goodput are computed over the union of every
    replica's finished requests against the fleet makespan, so they equal a
    hand-merge of the per-replica :class:`ServingReport`s (asserted in
    tests/test_fleet_sim.py).  ``goodput_rps`` is therefore *system-level*
    already — the explorer must not multiply it by a replica count the way
    it scales per-replica serving results (``system_level`` flags that).
    """
    n_requests: int
    makespan_s: float
    ttft_s: Percentiles
    tpot_ms: Percentiles
    e2e_s: Percentiles
    queue_delay_s: Percentiles
    prompt_tokens: int
    output_tokens: int
    tokens_per_s: float
    output_tokens_per_s: float
    requests_per_s: float
    slo: SLO | None
    slo_attainment: float
    goodput_rps: float
    n_steps: int
    steps_by_kind: dict
    router: str
    n_replicas: int                      # replicas constructed (incl. standby)
    replicas: tuple = field(default_factory=tuple)  # per-replica ServingReports
    replica_requests: dict = field(default_factory=dict)  # r<idx> -> n finished
    replica_utilization: dict = field(default_factory=dict)  # r<idx>/<pool>
    autoscaler_trace: tuple = field(default_factory=tuple)
    oracle_stats: dict = field(default_factory=dict)
    requests: tuple = field(default_factory=tuple)
    # replica fault injection (FleetSpec.faults): the seeded failure trace,
    # and how many queued/in-flight requests were displaced and rerouted
    failure_trace: tuple = field(default_factory=tuple)  # {t, replica} rows
    n_rerouted: int = 0

    system_level: ClassVar[bool] = True

    @property
    def n_replica_failures(self) -> int:
        return len(self.failure_trace)

    @property
    def utilization(self) -> dict:
        """Alias so fleet and single-replica reports expose the same lane
        map to :func:`repro_torch.obs.explain.explain_serving`."""
        return self.replica_utilization

    def explain(self, top_k: int = 8) -> str:
        """Plain-text attribution — see :meth:`ServingReport.explain`."""
        from repro_torch.obs.explain import render_serving
        return render_serving(self, top_k=top_k)

    def explain_dict(self, top_k: int = 8) -> dict:
        from repro_torch.obs.explain import explain_serving
        return explain_serving(self, top_k=top_k)

    @staticmethod
    def build(finished_by: list, replicas: list, slo: SLO | None, router: str,
              autoscaler_trace: list, oracle_stats: dict, *,
              failure_trace: list | None = None,
              n_rerouted: int = 0) -> "FleetReport":
        """Merge per-replica finished-request lists into the fleet view.

        ``finished_by[i]`` holds the requests that *finished* on
        ``replicas[i]`` (disaggregated fleets attribute a request to its
        decode replica).  The per-replica :class:`ServingReport`s are built
        exactly as a standalone single-replica run would build them — same
        pool names, own makespan — which is what makes the round-robin
        fleet bit-identical to per-shard single runs.
        """
        per = tuple(ServingReport.build(reqs, rep.pools, slo, {})
                    for rep, reqs in zip(replicas, finished_by))
        reqs = [r for chunk in finished_by for r in chunk]
        t0 = min((r.arrival_s for r in reqs), default=0.0)
        t1 = max((r.finished_s for r in reqs), default=0.0)
        makespan = max(t1 - t0, 1e-12)
        prompt_toks = sum(r.prompt_len for r in reqs)
        out_toks = sum(r.output_len for r in reqs)
        attain = (sum(1 for r in reqs if slo.met(r)) / len(reqs)
                  if slo and reqs else 1.0)
        rps = len(reqs) / makespan
        steps_by_kind: dict[str, int] = {}
        util: dict[str, dict] = {}
        for rep in replicas:
            for p in rep.pools:
                for k, n in p.steps_by_kind.items():
                    steps_by_kind[k] = steps_by_kind.get(k, 0) + n
                u = {"busy_frac": round(p.busy_s / makespan, 4),
                     "steps": p.n_steps}
                for k, s in p.phase_s.items():
                    u[f"{k}_frac"] = round(s / makespan, 4)
                util[f"r{rep.index}/{p.name}"] = u
        return FleetReport(
            n_requests=len(reqs), makespan_s=makespan,
            ttft_s=Percentiles.of([r.ttft_s for r in reqs]),
            tpot_ms=Percentiles.of([r.tpot_ms for r in reqs]),
            e2e_s=Percentiles.of([r.e2e_s for r in reqs]),
            queue_delay_s=Percentiles.of([r.queue_delay_s for r in reqs]),
            prompt_tokens=prompt_toks, output_tokens=out_toks,
            tokens_per_s=(prompt_toks + out_toks) / makespan,
            output_tokens_per_s=out_toks / makespan,
            requests_per_s=rps, slo=slo, slo_attainment=attain,
            goodput_rps=attain * rps,
            n_steps=sum(p.n_steps for rep in replicas for p in rep.pools),
            steps_by_kind=steps_by_kind, router=router,
            n_replicas=len(replicas), replicas=per,
            replica_requests={f"r{rep.index}": len(chunk)
                              for rep, chunk in zip(replicas, finished_by)},
            replica_utilization=util,
            autoscaler_trace=tuple(autoscaler_trace),
            oracle_stats=oracle_stats, requests=tuple(reqs),
            failure_trace=tuple(failure_trace or ()), n_rerouted=n_rerouted)

    def summary(self) -> dict:
        """Flat dict for benchmarks / examples."""
        return {
            "n_requests": self.n_requests,
            "n_replicas": self.n_replicas,
            "router": self.router,
            "makespan_s": round(self.makespan_s, 3),
            "ttft_p50_s": round(self.ttft_s.p50, 4),
            "ttft_p99_s": round(self.ttft_s.p99, 4),
            "tpot_p50_ms": round(self.tpot_ms.p50, 3),
            "tpot_p99_ms": round(self.tpot_ms.p99, 3),
            "queue_delay_p50_s": round(self.queue_delay_s.p50, 4),
            "tokens_per_s": round(self.tokens_per_s, 1),
            "output_tokens_per_s": round(self.output_tokens_per_s, 1),
            "requests_per_s": round(self.requests_per_s, 3),
            "slo_attainment": round(self.slo_attainment, 4),
            "goodput_rps": round(self.goodput_rps, 3),
            "n_steps": self.n_steps,
            "steps_by_kind": dict(self.steps_by_kind),
            "replica_requests": dict(self.replica_requests),
            "autoscaler_actions": len(self.autoscaler_trace),
            "n_replica_failures": self.n_replica_failures,
            "n_rerouted": self.n_rerouted,
            "oracle_stats": self.oracle_stats,
        }
