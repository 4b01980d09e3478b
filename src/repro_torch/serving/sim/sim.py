"""Discrete-event serving simulator: continuous batching over predicted steps.

This is the request-level layer the paper's deployment case study needs:
instead of executing a model, every engine iteration is *priced* by the core
:class:`~repro_torch.core.simulator.Simulator` (through the memoized
:class:`~repro_torch.serving.sim.oracle.StepOracle`) and a discrete-event loop
advances simulated time, so a 500-request trace replays in seconds of wall
time while producing the TTFT/TPOT/goodput distributions a real deployment
would measure.

Event loop invariants:

* A pool (one engine instance) runs at most one iteration at a time; when a
  ``STEP_DONE`` fires, token accounting happens first, then every idle pool
  gets a chance to plan its next step.
* Requests finish exactly once: the first token is emitted by the step that
  completes the prompt (prefill counts the first output token, the standard
  TTFT convention), the remaining ``output_len - 1`` tokens by decode steps.
* Disaggregated prefill/decode expands into two pools; completing a prefill
  on a ``role="prefill"`` pool schedules a delayed ``ARRIVAL`` (KV transfer)
  at the decode pool.
* All times come from the seeded workload and the deterministic oracle, and
  event ties break on insertion order — identical runs are bit-identical.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field

from repro_torch.configs.base import ModelConfig
from repro_torch.core.passes.base import ParallelConfig
from repro_torch.core.simulator import Simulator
from repro_torch.obs.recorder import CNAMES, NULL_RECORDER
from repro_torch.serving.sim.events import (
    ARRIVAL, AUTOSCALE, FAILURE, RECOVER, STEP_DONE, EventQueue,
)
from repro_torch.serving.sim.oracle import StepOracle
from repro_torch.serving.sim.policies import (
    ContinuousBatching, DecodeOnly, DisaggregatedPD, PrefillOnly, StepPlan,
    make_policy,
)
from repro_torch.serving.sim.report import SLO, FleetReport, ServingReport
from repro_torch.serving.sim.router import Autoscaler, LeastLoadedRouter, make_router
from repro_torch.serving.sim.workload import SimRequest, Workload, synthesize


@dataclass
class Pool:
    """One engine instance: a queue, a running batch, busy-time accounting."""
    name: str
    policy: object
    role: str = "both"                  # both | prefill | decode
    queue: deque = field(default_factory=deque)
    running: list = field(default_factory=list)
    prefilling: list = field(default_factory=list)
    pending_arrivals: int = 0
    busy: bool = False
    busy_s: float = 0.0
    phase_s: dict = field(default_factory=dict)       # step kind -> seconds
    steps_by_kind: dict = field(default_factory=dict)  # step kind -> count
    n_steps: int = 0


def make_pools(policy) -> tuple[list[Pool], float]:
    """Policy -> the pool(s) one engine replica runs: a DisaggregatedPD
    descriptor expands into a prefill/decode pair (plus its KV-transfer
    latency), anything else is a single ``engine`` pool.  Shared by the
    single-replica and fleet simulators so per-replica pool names — and
    therefore utilization keys — match between the two."""
    if isinstance(policy, DisaggregatedPD):
        return [Pool("prefill", PrefillOnly(policy.prefill_batch),
                     role="prefill"),
                Pool("decode", DecodeOnly(policy.decode_batch),
                     role="decode")], policy.transfer_s
    return [Pool("engine", policy)], 0.0


def record_request_lanes(rec, reqs, *, pid: str = "requests",
                         metrics=None) -> None:
    """Emit per-request trace lanes: queued → prefill → decode spans, one
    ``tid`` per request.  Lanes beyond ``rec.max_request_lanes`` (a 100k
    request trace would mean 100k Perfetto tracks) are dropped *loudly*: a
    metadata instant carries the dropped count and a
    ``trace.dropped_request_lanes`` counter is bumped when ``metrics`` is
    given."""
    if not rec.enabled:
        return
    cap = rec.max_request_lanes
    shown = sorted(reqs, key=lambda r: r.rid)
    dropped = max(len(shown) - cap, 0)
    for r in shown[:cap]:
        tid = f"req{r.rid}"
        q0 = r.enqueue_s if r.enqueue_s is not None else r.arrival_s
        if r.start_s is not None:
            if r.start_s > q0:
                rec.span(pid, tid, "queued", q0, r.start_s - q0,
                         cat="request", cname="grey")
            if r.first_token_s is not None:
                rec.span(pid, tid, "prefill", r.start_s,
                         r.first_token_s - r.start_s, cat="request",
                         args={"prompt_len": r.prompt_len})
                if r.finished_s is not None and r.output_len > 1:
                    rec.span(pid, tid, "decode", r.first_token_s,
                             r.finished_s - r.first_token_s, cat="request",
                             args={"output_len": r.output_len})
    if dropped > 0:
        last = max((r.finished_s or r.arrival_s for r in shown),
                   default=0.0)
        rec.instant(pid, "meta", "charon:request_lanes_truncated", last,
                    args={"dropped_requests": dropped,
                          "max_request_lanes": cap,
                          "total_requests": len(shown)})
        if metrics is not None:
            metrics.inc("trace.dropped_request_lanes", dropped)


def price_step_s(oracle: StepOracle, plan: StepPlan) -> float:
    """Price one planned engine iteration through the shared step oracle —
    the single pricing convention both simulators use."""
    if plan.kind == "decode":
        ctx = max(r.prompt_len + r.decoded for r in plan.decode)
        return oracle.decode_step_s(len(plan.decode), ctx)
    if plan.kind == "prefill":
        seq = max(chunk for _, chunk in plan.prefill)
        return oracle.prefill_s(len(plan.prefill), seq)
    ctx = max((r.prompt_len + r.decoded for r in plan.decode), default=0)
    chunk = sum(c for _, c in plan.prefill)
    return oracle.mixed_step_s(len(plan.decode), ctx, chunk)


class ServingSimulator:
    """Replay a :class:`Workload` through a batching policy, pricing every
    engine iteration with the step oracle."""

    def __init__(self, sim: Simulator, cfg: ModelConfig | None = None, *,
                 par: ParallelConfig | None = None, policy=None,
                 oracle: StepOracle | None = None, ctx_floor: int = 256):
        self.sim = sim
        self.cfg = cfg
        self.par = par or ParallelConfig()
        self.policy = policy or ContinuousBatching()
        # spec-driven use (``ServingSimulator(sim).run(spec)``) defers the
        # oracle until the spec supplies model/parallelism
        self.oracle = oracle if cfg is None else (
            oracle or StepOracle(sim, cfg, self.par, ctx_floor=ctx_floor))

    # ------------------------------------------------------------------
    def _pools(self) -> tuple[list[Pool], float]:
        return make_pools(self.policy)

    def _price_s(self, plan: StepPlan) -> float:
        return price_step_s(self.oracle, plan)

    def _finish_step(self, pool: Pool, plan: StepPlan, now: float,
                     evq: EventQueue, pools: list[Pool], transfer_s: float,
                     finished: list[SimRequest]) -> None:
        pool.busy = False
        for r, chunk in plan.prefill:
            r.prefilled += chunk
            if r.prefilled >= r.prompt_len:
                pool.prefilling.remove(r)
                r.first_token_s = now       # prefill emits the first token
                r.decoded = 1
                if r.decoded >= r.output_len:
                    r.finished_s = now
                    finished.append(r)
                elif pool.role == "prefill":
                    evq.push(now + transfer_s, ARRIVAL, (pools[1], r))
                else:
                    pool.running.append(r)
        for r in plan.decode:
            r.decoded += 1
            if r.decoded >= r.output_len:
                r.finished_s = now
                pool.running.remove(r)
                finished.append(r)

    # ------------------------------------------------------------------
    def run(self, workload, *, slo: SLO | None = None,
            max_steps: int = 2_000_000, recorder=None,
            metrics=None) -> ServingReport:
        """Replay a request trace and aggregate a :class:`ServingReport`.

        Accepts either a legacy :class:`Workload` (with the policy/model
        fixed at construction) or a :class:`~repro_torch.api.spec.SimSpec` whose
        workload is a :class:`~repro_torch.api.spec.ServingWorkload` — the spec
        then supplies the model, parallelism, policy, trace and SLO.  A
        spec whose workload carries a non-trivial
        :class:`~repro_torch.api.spec.FleetSpec` is delegated to
        :class:`FleetSimulator` and returns a :class:`FleetReport`.

        ``recorder`` (a :class:`~repro_torch.obs.TraceRecorder`) collects engine
        step spans and per-request lanes; ``metrics`` (a
        :class:`~repro_torch.obs.MetricsRegistry`) accumulates step/request
        counters and the oracle hit/miss delta.  Both default to off and
        cost nothing when off — the report is bit-identical either way.
        """
        from repro_torch.api.spec import SimSpec
        if isinstance(workload, SimSpec):
            spec = workload
            w = spec.workload
            if getattr(w, "mode", None) != "serving":
                raise TypeError(
                    "ServingSimulator.run(spec) needs a ServingWorkload; "
                    f"got {type(w).__name__} (use Simulator.run for "
                    "steady-state workloads)")
            if spec.cluster.hardware != self.sim.hw.name:
                raise ValueError(
                    f"simulator built for {self.sim.hw.name!r} cannot run a "
                    f"spec for cluster hardware {spec.cluster.hardware!r}")
            if not w.fleet.trivial:
                return FleetSimulator(self.sim).run(spec, slo=slo,
                                                    max_steps=max_steps,
                                                    recorder=recorder,
                                                    metrics=metrics)
            inner = ServingSimulator(self.sim, spec.model, par=spec.parallel,
                                     policy=w.make_policy(),
                                     ctx_floor=w.ctx_floor)
            return inner.run(w.build(), slo=slo if slo is not None else w.slo,
                             max_steps=max_steps, recorder=recorder,
                             metrics=metrics)
        if self.oracle is None:
            raise TypeError("ServingSimulator was built without a model "
                            "config; pass a SimSpec to run()")
        rec = recorder if recorder is not None else NULL_RECORDER
        reqs = sorted((r.reset_copy() for r in workload.requests),
                      key=lambda r: r.arrival_s)
        pools, transfer_s = self._pools()
        evq = EventQueue()
        for r in reqs:
            evq.push(r.arrival_s, ARRIVAL, (pools[0], r))
        # only the entry pool knows its arrival count up front; downstream
        # pools (disaggregated decode) receive an unknowable subset via
        # migration, so a wait-for-arrivals policy must not wait on them
        pools[0].pending_arrivals = len(reqs)
        finished: list[SimRequest] = []
        stats0 = self.oracle.stats()
        steps = 0
        while evq:
            ev = evq.pop()
            now = ev.time
            if ev.kind == ARRIVAL:
                pool, r = ev.payload
                pool.queue.append(r)
                pool.pending_arrivals = max(pool.pending_arrivals - 1, 0)
                if r.enqueue_s is None:
                    r.enqueue_s = now
            else:                                   # STEP_DONE
                pool, plan = ev.payload
                self._finish_step(pool, plan, now, evq, pools, transfer_s,
                                  finished)
            for pool in pools:
                if pool.busy:
                    continue
                plan = pool.policy.plan(pool, now)
                if plan is None:
                    continue
                steps += 1
                if steps > max_steps:
                    raise RuntimeError(
                        f"serving sim exceeded {max_steps} steps "
                        f"({len(finished)}/{len(reqs)} finished)")
                dt = self._price_s(plan)
                for r, _ in plan.prefill:
                    if r.start_s is None:
                        r.start_s = now
                for r in plan.decode:
                    if r.start_s is None:
                        r.start_s = now
                pool.busy = True
                pool.n_steps += 1
                pool.busy_s += dt
                pool.phase_s[plan.kind] = pool.phase_s.get(plan.kind, 0.0) + dt
                pool.steps_by_kind[plan.kind] = \
                    pool.steps_by_kind.get(plan.kind, 0) + 1
                if rec.enabled:
                    rec.span("serving", pool.name, plan.kind, now, dt,
                             cat="step",
                             args={"n_prefill": len(plan.prefill),
                                   "n_decode": len(plan.decode)})
                evq.push(now + dt, STEP_DONE, (pool, plan))
        if len(finished) != len(reqs):
            raise RuntimeError(
                f"serving sim deadlocked: {len(reqs) - len(finished)} of "
                f"{len(reqs)} requests unfinished under {self.policy.name}")
        stats1 = self.oracle.stats()
        delta = {k: stats1.get(k, 0) - stats0.get(k, 0)
                 for k in ("hits", "misses")}
        delta["hit_rate"] = round(
            delta["hits"] / max(delta["hits"] + delta["misses"], 1), 4)
        record_request_lanes(rec, finished, pid="serving/requests",
                             metrics=metrics)
        rep = ServingReport.build(finished, pools, slo, delta)
        if metrics is not None:
            metrics.inc("serving.requests", len(finished))
            metrics.inc("serving.steps", steps)
            for k, n in rep.steps_by_kind.items():
                metrics.inc(f"serving.steps.{k}", n)
            metrics.update_nested(delta, prefix="serving.oracle")
        return rep


# ----------------------------------------------------------------------
@dataclass
class ReplicaPool:
    """One replica of a fleet: an engine instance (a single pool, or a
    prefill/decode pool pair when the per-replica policy is
    :class:`DisaggregatedPD`), plus routability state.

    ``active`` gates routing only — a scaled-down replica keeps draining
    the requests it already holds, so request conservation never depends on
    autoscaler behaviour.  ``ready_at`` models provisioning: a freshly
    scaled-up replica takes traffic once the clock passes it.

    ``failed_until`` is the fault-injection analogue: a failed replica is
    unroutable (and never plans steps) until the clock passes it.  Each
    failure bumps ``epoch`` so the in-flight step's ``STEP_DONE`` — priced
    before the failure — is recognized as stale and dropped.
    """
    index: int
    pools: list
    transfer_s: float = 0.0
    role: str = "serve"                  # serve | prefill (fleet-level disagg)
    active: bool = True
    ready_at: float = 0.0
    failed_until: float = 0.0
    epoch: int = 0

    def up(self, now: float) -> bool:
        return now >= self.failed_until

    @property
    def entry(self) -> Pool:
        return self.pools[0]

    def load(self) -> int:
        """In-flight requests: queued + prefilling + decoding — the routing
        and autoscaling depth metric."""
        return sum(len(p.queue) + len(p.prefilling) + len(p.running)
                   for p in self.pools)


class FleetSimulator:
    """Fleet-scale serving: N replica engines behind a router, sharing one
    :class:`StepOracle`, on one deterministic event heap.

    Each replica is an independent :class:`ReplicaPool` (identical model /
    parallelism / policy — the fleet is homogeneous), so pricing goes
    through a single oracle and the marginal cost of a replica is queue
    bookkeeping, not ingest traces.  The router spreads fresh arrivals over
    routable replicas; with ``FleetSpec.prefill_replicas > 0`` the fleet is
    disaggregated — arrivals prefill on dedicated :class:`PrefillOnly`
    replicas, then migrate (paying ``transfer_s``) to the least-loaded
    decode replica.  An optional :class:`~repro_torch.api.spec.AutoscalerSpec`
    grows/shrinks the serving set on ``AUTOSCALE`` ticks.  An optional
    :class:`~repro_torch.api.spec.ReplicaFaultSpec` (``FleetSpec.faults``)
    injects seeded replica failures: the failed replica's in-flight step is
    killed (epoch guard), its requests reroute through the router and
    restart from scratch, the autoscaler skips down replicas, and the
    report carries the failure trace — SLO goodput under failures.

    Determinism matches the single-replica loop: seeded workloads, a
    deterministic oracle, heap ties broken by insertion order, and routers/
    autoscaler that are pure functions of fleet state.  Only the pools of
    the replica an event touches are replanned — except on the final fresh
    arrival, which replans every entry replica (the fleet-wide drain signal
    it flips can unblock gang-scheduling pools idling on a partial batch) —
    so fleet event-loop cost stays O(events), not O(events × replicas).
    """

    def __init__(self, sim: Simulator, cfg: ModelConfig | None = None, *,
                 par: ParallelConfig | None = None, policy=None, fleet=None,
                 oracle: StepOracle | None = None, ctx_floor: int = 256):
        from repro_torch.api.spec import FleetSpec
        self.sim = sim
        self.cfg = cfg
        self.par = par or ParallelConfig()
        self.policy = policy or ContinuousBatching()
        self.fleet = fleet or FleetSpec()
        self.oracle = oracle if cfg is None else (
            oracle or StepOracle(sim, cfg, self.par, ctx_floor=ctx_floor))

    # ------------------------------------------------------------------
    def _replicas(self) -> tuple[list[ReplicaPool], list[ReplicaPool],
                                 list[ReplicaPool]]:
        """Build the fleet: (all, serve group, entry group).

        With an autoscaler, ``max_replicas`` serve replicas exist up front
        (construction is cheap — they share the oracle) and only the
        initial count is active; scale-ups activate standbys in index
        order, so replica identity is stable across the run.
        """
        import copy

        f = self.fleet
        scaler = f.autoscaler
        n_active = f.replicas
        n_total = f.replicas
        if scaler is not None:
            n_active = min(max(f.replicas, scaler.min_replicas),
                           scaler.max_replicas)
            n_total = max(n_total, scaler.max_replicas)
        reps: list[ReplicaPool] = []
        for i in range(n_total):
            pools, transfer = make_pools(copy.deepcopy(self.policy))
            reps.append(ReplicaPool(index=i, pools=pools, transfer_s=transfer,
                                    active=i < n_active))
        serve = list(reps)
        if f.prefill_replicas > 0:
            for _ in range(f.prefill_replicas):
                pool = Pool("prefill", PrefillOnly(f.prefill_batch),
                            role="prefill")
                reps.append(ReplicaPool(index=len(reps), pools=[pool],
                                        transfer_s=f.transfer_s,
                                        role="prefill"))
            # decode side of a disaggregated fleet: pure continuous decode,
            # capped by the per-replica policy's admission limit (a
            # DisaggregatedPD policy names its decode cap explicitly)
            if isinstance(self.policy, DisaggregatedPD):
                cap = self.policy.decode_batch
            else:
                cap = getattr(self.policy, "max_batch",
                              getattr(self.policy, "batch_size", 16))
            for rep in serve:
                rep.pools[:] = [Pool("decode", DecodeOnly(cap), role="decode")]
        entry = [rep for rep in reps if rep.role == "prefill"] or serve
        return reps, serve, entry

    def _routable(self, group: list[ReplicaPool],
                  now: float) -> list[ReplicaPool]:
        up = [rep for rep in group
              if rep.active and now >= rep.ready_at and rep.up(now)]
        # provisioning gap, a fleet-wide outage, or everything scaled down:
        # fall back rather than drop arrivals (a request queued on a down
        # replica is drained — or re-displaced — when it recovers)
        return (up
                or [rep for rep in group if rep.active and rep.up(now)]
                or [rep for rep in group if rep.active] or group)

    def _finish(self, rep: ReplicaPool, pool: Pool, plan: StepPlan,
                now: float, evq: EventQueue, serve: list[ReplicaPool],
                decode_router, finished_by: list[list],
                rec=NULL_RECORDER) -> None:
        pool.busy = False
        for r, chunk in plan.prefill:
            r.prefilled += chunk
            if r.prefilled >= r.prompt_len:
                pool.prefilling.remove(r)
                if r.first_token_s is None:
                    r.first_token_s = now   # prefill emits the first token
                    # (a request re-prefilling after a replica failure keeps
                    # its original TTFT — that token was already delivered)
                r.decoded = 1
                if r.decoded >= r.output_len:
                    r.finished_s = now
                    finished_by[rep.index].append(r)
                elif rep.role == "prefill":
                    # fleet-level disaggregation: migrate to a decode replica
                    target = decode_router.route(
                        r, self._routable(serve, now), now)
                    if rec.enabled:
                        rec.instant(f"replica{rep.index}", "kv_transfer",
                                    "kv_transfer", now, cat="migration",
                                    args={"rid": r.rid, "to": target.index,
                                          "transfer_s": rep.transfer_s})
                    evq.push(now + rep.transfer_s, ARRIVAL,
                             (target, target.entry, r))
                elif pool.role == "prefill":
                    # per-replica DisaggregatedPD: decode pool is a sibling
                    if rec.enabled:
                        rec.instant(f"replica{rep.index}", "kv_transfer",
                                    "kv_transfer", now, cat="migration",
                                    args={"rid": r.rid, "to": rep.index,
                                          "transfer_s": rep.transfer_s})
                    evq.push(now + rep.transfer_s, ARRIVAL,
                             (rep, rep.pools[1], r))
                else:
                    pool.running.append(r)
        for r in plan.decode:
            r.decoded += 1
            if r.decoded >= r.output_len:
                r.finished_s = now
                pool.running.remove(r)
                finished_by[rep.index].append(r)

    # ------------------------------------------------------------------
    def run(self, workload, *, slo: SLO | None = None,
            max_steps: int = 50_000_000, recorder=None,
            metrics=None) -> FleetReport:
        """Replay a trace through the fleet and aggregate a
        :class:`FleetReport`.

        Accepts a :class:`Workload` (fleet/policy fixed at construction) or
        a :class:`~repro_torch.api.spec.SimSpec` whose
        :class:`~repro_torch.api.spec.ServingWorkload` supplies model,
        parallelism, policy, trace, SLO and :class:`FleetSpec` — the spec
        form of "sweep disaggregation ratios × replica counts".

        ``recorder`` collects per-replica step-span lanes, per-request
        lanes, KV-transfer migration instants, autoscaler actions and
        FAILURE/RECOVER/reroute instants; ``metrics`` accumulates fleet
        counters.  Both default to off and cost nothing when off.
        """
        from repro_torch.api.spec import SimSpec
        if isinstance(workload, SimSpec):
            spec = workload
            w = spec.workload
            if getattr(w, "mode", None) != "serving":
                raise TypeError(
                    "FleetSimulator.run(spec) needs a ServingWorkload; "
                    f"got {type(w).__name__}")
            if spec.cluster.hardware != self.sim.hw.name:
                raise ValueError(
                    f"simulator built for {self.sim.hw.name!r} cannot run a "
                    f"spec for cluster hardware {spec.cluster.hardware!r}")
            inner = FleetSimulator(self.sim, spec.model, par=spec.parallel,
                                   policy=w.make_policy(), fleet=w.fleet,
                                   ctx_floor=w.ctx_floor)
            return inner.run(w.build(), slo=slo if slo is not None else w.slo,
                             max_steps=max_steps, recorder=recorder,
                             metrics=metrics)
        if self.oracle is None:
            raise TypeError("FleetSimulator was built without a model "
                            "config; pass a SimSpec to run()")
        rec = recorder if recorder is not None else NULL_RECORDER
        f = self.fleet
        reqs = sorted((r.reset_copy() for r in workload.requests),
                      key=lambda r: r.arrival_s)
        replicas, serve, entry = self._replicas()
        router = make_router(f.router)
        decode_router = LeastLoadedRouter()
        scaler = Autoscaler(f.autoscaler) if f.autoscaler is not None else None
        evq = EventQueue()
        for r in reqs:
            evq.push(r.arrival_s, ARRIVAL, (None, None, r))
        if scaler is not None and reqs:
            evq.push(reqs[0].arrival_s + f.autoscaler.interval_s,
                     AUTOSCALE, ())
        # seeded replica fault injection: every replica (standbys included —
        # machines fail whether or not they take traffic) owns a lazy
        # renewal stream; the next failure is always one event ahead
        faults = f.faults if (f.faults is not None and f.faults.active) \
            else None
        fault_gap: dict[int, object] = {}
        if faults is not None and reqs:
            from repro_torch.resilience.faults import replica_fault_stream
            for rep in replicas:
                fault_gap[rep.index] = replica_fault_stream(faults, rep.index)
                evq.push(reqs[0].arrival_s + fault_gap[rep.index](),
                         FAILURE, (rep,))
        failure_trace: list[dict] = []
        n_rerouted = 0
        remaining = len(reqs)
        finished_by: list[list[SimRequest]] = [[] for _ in replicas]
        n_finished = 0
        stats0 = self.oracle.stats()
        steps = 0
        while evq:
            ev = evq.pop()
            now = ev.time
            rep = None
            replan: list[ReplicaPool] = []
            if ev.kind == ARRIVAL:
                rep, pool, r = ev.payload
                if rep is None:             # fresh arrival: route it now
                    remaining -= 1
                    rep = router.route(r, self._routable(entry, now), now)
                    pool = rep.entry
                    # fleet-wide drain signal for wait-for-gang policies:
                    # per-replica arrival counts are unknowable under
                    # load-dependent routing, so every entry pool sees the
                    # fleet-wide undelivered count (conservative: a gang
                    # waits a little longer, never deadlocks)
                    for x in entry:
                        x.entry.pending_arrivals = remaining
                    if remaining == 0:
                        # the drain signal just flipped fleet-wide: an entry
                        # replica idling on a partial gang (static batching
                        # planned None while arrivals were pending) gets no
                        # further events, so the final arrival must replan
                        # every entry replica, not just the routed one
                        replan = [x for x in entry if x is not rep]
                pool.queue.append(r)
                if r.enqueue_s is None:
                    r.enqueue_s = now
            elif ev.kind == STEP_DONE:
                rep, pool, plan, epoch = ev.payload
                if epoch != rep.epoch:
                    continue                 # step killed by a failure
                before = len(finished_by[rep.index])
                self._finish(rep, pool, plan, now, evq, serve, decode_router,
                             finished_by, rec)
                n_finished += len(finished_by[rep.index]) - before
            elif ev.kind == FAILURE:
                (frep,) = ev.payload
                if n_finished >= len(reqs):
                    continue                 # trace done: stop the process
                failure_trace.append({"t": round(now, 4),
                                      "replica": frep.index})
                frep.failed_until = now + faults.restart_s
                frep.epoch += 1              # kills the in-flight STEP_DONE
                displaced: list[SimRequest] = []
                for pool in frep.pools:
                    pool.busy = False
                    displaced.extend(pool.queue)
                    pool.queue.clear()
                    displaced.extend(pool.prefilling)
                    pool.prefilling.clear()
                    displaced.extend(pool.running)
                    pool.running.clear()
                evq.push(frep.failed_until, RECOVER, (frep,))
                evq.push(frep.failed_until + fault_gap[frep.index](),
                         FAILURE, (frep,))
                # reroute what the replica held: KV state died with it, so
                # requests restart from scratch (keeping their original
                # enqueue/start/first-token stamps — latency is end-to-end)
                for r in displaced:
                    r.prefilled = 0
                    r.decoded = 0
                    n_rerouted += 1
                    target = router.route(r, self._routable(entry, now), now)
                    target.entry.queue.append(r)
                    if rec.enabled:
                        rec.instant("fleet", "faults", "reroute", now,
                                    cat="fault",
                                    args={"rid": r.rid, "from": frep.index,
                                          "to": target.index})
                    if target not in replan:
                        replan.append(target)
                if rec.enabled:
                    rec.instant("fleet", "faults", f"FAILURE r{frep.index}",
                                now, cat="fault",
                                args={"replica": frep.index,
                                      "displaced": len(displaced),
                                      "restart_s": faults.restart_s})
                    rec.span(f"replica{frep.index}", "downtime", "down", now,
                             faults.restart_s, cat="fault",
                             cname=CNAMES["downtime"])
            elif ev.kind == RECOVER:
                (rep,) = ev.payload          # replan it (gated if re-failed)
                if rec.enabled:
                    rec.instant("fleet", "faults", f"RECOVER r{rep.index}",
                                now, cat="fault", args={"replica": rep.index})
            else:                            # AUTOSCALE
                n_actions0 = len(scaler.trace)
                scaler.tick(now, serve)
                if rec.enabled:
                    for entry_row in scaler.trace[n_actions0:]:
                        rec.instant("fleet", "autoscaler",
                                    entry_row["action"], now, cat="autoscale",
                                    args=dict(entry_row))
                if remaining > 0 or n_finished < len(reqs):
                    evq.push(now + f.autoscaler.interval_s, AUTOSCALE, ())
            if rep is not None:
                replan.insert(0, rep)        # touched replica replans first
            for prep in replan:
                if not prep.up(now):
                    continue                 # down: drains at its RECOVER
                for pool in prep.pools:
                    if pool.busy:
                        continue
                    plan = pool.policy.plan(pool, now)
                    if plan is None:
                        continue
                    steps += 1
                    if steps > max_steps:
                        raise RuntimeError(
                            f"fleet sim exceeded {max_steps} steps "
                            f"({n_finished}/{len(reqs)} finished)")
                    dt = price_step_s(self.oracle, plan)
                    for r, _ in plan.prefill:
                        if r.start_s is None:
                            r.start_s = now
                    for r in plan.decode:
                        if r.start_s is None:
                            r.start_s = now
                    pool.busy = True
                    pool.n_steps += 1
                    pool.busy_s += dt
                    pool.phase_s[plan.kind] = \
                        pool.phase_s.get(plan.kind, 0.0) + dt
                    pool.steps_by_kind[plan.kind] = \
                        pool.steps_by_kind.get(plan.kind, 0) + 1
                    if rec.enabled:
                        rec.span(f"replica{prep.index}", pool.name,
                                 plan.kind, now, dt, cat="step",
                                 args={"n_prefill": len(plan.prefill),
                                       "n_decode": len(plan.decode)})
                    evq.push(now + dt, STEP_DONE, (prep, pool, plan,
                                                   prep.epoch))
        if n_finished != len(reqs):
            raise RuntimeError(
                f"fleet sim deadlocked: {len(reqs) - n_finished} of "
                f"{len(reqs)} requests unfinished across "
                f"{len(replicas)} replicas")
        stats1 = self.oracle.stats()
        delta = {k: stats1.get(k, 0) - stats0.get(k, 0)
                 for k in ("hits", "misses")}
        delta["hit_rate"] = round(
            delta["hits"] / max(delta["hits"] + delta["misses"], 1), 4)
        delta["distinct_steps"] = self.oracle.n_distinct_steps
        record_request_lanes(
            rec, [r for chunk in finished_by for r in chunk],
            pid="fleet/requests", metrics=metrics)
        frep = FleetReport.build(
            finished_by, replicas, slo, router.name,
            scaler.trace if scaler is not None else [], delta,
            failure_trace=failure_trace, n_rerouted=n_rerouted)
        if metrics is not None:
            metrics.inc("fleet.requests", n_finished)
            metrics.inc("fleet.steps", steps)
            for k, n in frep.steps_by_kind.items():
                metrics.inc(f"fleet.steps.{k}", n)
            metrics.inc("fleet.failures", len(failure_trace))
            metrics.inc("fleet.rerouted", n_rerouted)
            metrics.inc("fleet.autoscale_actions",
                        len(frep.autoscaler_trace))
            metrics.update_nested(delta, prefix="fleet.oracle")
        return frep


# ----------------------------------------------------------------------
@dataclass
class ServingScenario:
    """A request-level what-if the explorer can rank candidates by.

    ``evaluate`` turns an explorer candidate into a per-replica serving run:
    the workload is round-robin split over the candidate's ``dp * pods``
    replicas, the candidate's per-replica batch (``B_local``) becomes the
    policy's admission cap, and the reported goodput is scaled back to the
    system level — so a config with more replicas competes on aggregate
    SLO-attainment throughput, not per-step latency.
    """
    workload: Workload
    slo: SLO = field(default_factory=SLO)
    policy: str = "continuous"          # continuous | chunked | static
    token_budget: int = 256             # chunked-prefill budget
    ctx_floor: int = 256
    fleet: object | None = None         # FleetSpec -> fleet-level evaluation

    @staticmethod
    def default(seed: int = 0) -> "ServingScenario":
        """A small mixed workload: enough load that admission capacity (not
        per-step latency) decides SLO attainment — see docs/serving.md."""
        return ServingScenario(synthesize(
            200, arrival="poisson", rate_rps=16.0, seed=seed))

    def make_policy(self, max_batch: int):
        return make_policy(self.policy, max_batch,
                           token_budget=self.token_budget)

    def evaluate(self, sim: Simulator, cfg: ModelConfig, cand):
        if self.fleet is not None and not self.fleet.trivial:
            # fleet evaluation: the full workload hits the routed fleet, the
            # candidate's per-replica batch caps each engine, and the
            # resulting goodput is system-level already (no dp*pods scaling)
            fsim = FleetSimulator(sim, cfg, par=cand.par,
                                  policy=self.make_policy(cand.B_local()),
                                  fleet=self.fleet, ctx_floor=self.ctx_floor)
            return fsim.run(self.workload, slo=self.slo)
        replicas = max(cand.par.dp * cand.par.pods, 1)
        wl = self.workload.shard(replicas)
        ssim = ServingSimulator(sim, cfg, par=cand.par,
                                policy=self.make_policy(cand.B_local()),
                                ctx_floor=self.ctx_floor)
        rep = ssim.run(wl, slo=self.slo)
        return rep
