"""Declarative design-space sweeps over :class:`~repro_torch.api.spec.SimSpec`.

The legacy ``explore()`` hardcoded its grid to (tp, pp, batch, micro).  A
:class:`SweepSpace` instead names *any* spec field as an axis — parallelism
degrees, batch, sequence length, quantization, remat policy, even the
hardware target — and :func:`sweep` enumerates the cross product, applies
the same pruning rules, groups candidates by
:meth:`~repro_torch.api.spec.SimSpec.reuse_key` so the simulator's cache layers
stay warm within a group, and ranks the survivors under the step-time or
request-level goodput objective.  The result is the same
:class:`~repro_torch.core.explorer.ExplorationResult` the old surface returned,
so Pareto/SLO/ranking queries are unchanged.

Axis names are resolved against the spec components: use a dotted path
(``"parallel.tp"``, ``"workload.seq_len"``, ``"cluster.hardware"``) or a
bare field name, which is looked up in parallel -> workload -> cluster ->
model order.  ``"batch"`` and ``"micro"`` alias ``workload.global_batch``
and ``parallel.microbatches``.

When ``cluster.chips`` is set and ``dp`` is not itself an axis, data
parallelism is derived per candidate as ``chips // (tp*pp*pods*cp)`` and
non-divisible combinations are skipped — the legacy enumeration rule.  For
MoE models expert parallelism follows tp unless ``ep`` is an explicit axis.
"""
from __future__ import annotations

import dataclasses
import itertools
import math
import os
import traceback
from dataclasses import dataclass
from typing import Callable, Iterable

from repro_torch.analysis.chaos import FaultPlan
from repro_torch.api.pool import (
    RetryPolicy, SweepJournal, _compact_tb, get_pool,
)
from repro_torch.api.spec import ServingWorkload, SimSpec
from repro_torch.core.backend.collectives import collective_memo_stats
from repro_torch.obs.clock import wall_s
from repro_torch.core.explorer import (
    Candidate, DEFAULT_RULES, EvalResult, ExplorationResult,
    FailedCandidate, _stats_delta, rule_memory_fit,
)
from repro_torch.core.simulator import Simulator, merge_cache_shards
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.recorder import NULL_RECORDER

_ALIASES = {"batch": "workload.global_batch", "micro": "parallel.microbatches",
            "hardware": "cluster.hardware", "hw": "cluster.hardware"}
_COMPONENTS = ("parallel", "workload", "cluster", "model")


def _resolve_axis(spec: SimSpec, name: str) -> tuple[str, ...]:
    """Axis name -> (component, field, ...) path.  Dotted paths are explicit
    and may reach into nested spec objects (``workload.fleet.replicas``);
    bare names search parallel -> workload -> cluster -> model."""
    name = _ALIASES.get(name, name)
    if "." in name:
        comp, rest = name.split(".", 1)
        if comp not in _COMPONENTS:
            raise KeyError(f"unknown spec component {comp!r} in axis {name!r}")
        obj = getattr(spec, comp)
        parts = rest.split(".")
        for i, f in enumerate(parts):
            if not dataclasses.is_dataclass(obj) or f not in {
                    x.name for x in dataclasses.fields(obj)}:
                raise KeyError(f"{type(obj).__name__} has no field {f!r} "
                               f"(axis {name!r})")
            if i < len(parts) - 1:
                obj = getattr(obj, f)
                if obj is None:
                    raise KeyError(
                        f"axis {name!r} descends through a None field — set "
                        f"a non-None default on the base spec (or sweep "
                        f"{'.'.join([comp] + parts[:i + 1])!r} as whole "
                        "objects)")
        return (comp, *parts)
    for comp in _COMPONENTS:
        obj = getattr(spec, comp)
        if name in {x.name for x in dataclasses.fields(obj)}:
            return (comp, name)
    raise KeyError(f"axis {name!r} matches no field of any spec component")


def _nested_replace(obj, path: tuple, value):
    """``dataclasses.replace`` along a field path, rebuilding each frozen
    level from the inside out."""
    if len(path) == 1:
        return dataclasses.replace(obj, **{path[0]: value})
    inner = _nested_replace(getattr(obj, path[0]), path[1:], value)
    return dataclasses.replace(obj, **{path[0]: inner})


def spec_replace(spec: SimSpec, changes: dict) -> SimSpec:
    """Rebuild a spec with dotted-path (or bare-name) field changes."""
    parts: dict[str, object] = {}
    for name, value in changes.items():
        comp, *path = _resolve_axis(spec, name)
        parts[comp] = _nested_replace(parts.get(comp, getattr(spec, comp)),
                                      tuple(path), value)
    return dataclasses.replace(spec, **parts)


@dataclass(frozen=True)
class SweepSpace:
    """A base spec plus named axes; hashable like every other spec object.

    ``axes`` accepts a mapping ``{axis_name: values}`` (normalized to a
    tuple of ``(name, tuple(values))`` pairs, preserving insertion order —
    the cross product enumerates the last axis fastest).
    """
    base: SimSpec
    axes: tuple = ()

    def __post_init__(self):
        ax = self.axes
        pairs = ax.items() if isinstance(ax, dict) else ax
        norm = []
        for k, v in pairs:
            if isinstance(v, (str, bytes)):
                raise TypeError(
                    f"axis {k!r}: values must be a sequence, got the bare "
                    f"string {v!r} — wrap it in a tuple")
            norm.append((str(k), tuple(v)))
        norm = tuple(norm)
        for k, _ in norm:
            _resolve_axis(self.base, k)          # fail fast on bad names
        object.__setattr__(self, "axes", norm)

    @property
    def axis_names(self) -> tuple[str, ...]:
        return tuple(k for k, _ in self.axes)

    def size(self) -> int:
        n = 1
        for _, vals in self.axes:
            n *= len(vals)
        return n

    def points(self) -> Iterable[SimSpec]:
        """Enumerate candidate specs: cross product of the axes, then the
        chip-budget dp derivation (and MoE ep) unless explicitly swept."""
        names = self.axis_names
        resolved = {n: _resolve_axis(self.base, n) for n in names}
        derive_dp = ("parallel", "dp") not in resolved.values()
        derive_ep = ("parallel", "ep") not in resolved.values()
        for combo in itertools.product(*(v for _, v in self.axes)):
            spec = spec_replace(self.base, dict(zip(names, combo)))
            par, chips = spec.parallel, spec.cluster.chips
            if chips:
                denom = par.tp * par.pp * par.pods * par.cp
                if derive_dp:
                    if chips % denom:
                        continue                  # budget not divisible
                    par = dataclasses.replace(par, dp=chips // denom)
                elif par.chips != chips:
                    continue                      # explicit dp over budget
            if derive_ep and spec.model.num_experts:
                par = dataclasses.replace(par, ep=par.tp)
            if par is not spec.parallel:
                spec = dataclasses.replace(spec, parallel=par)
            yield spec


def _sim_for(cluster, sims: dict, engine: str,
             persist: str | None = None) -> Simulator:
    key = cluster.hardware
    if key not in sims:
        sims[key] = Simulator(cluster.resolve(), engine=engine,
                              persist=persist)
    return sims[key]


def _merge_stats(deltas: list[dict]) -> dict:
    """Sum per-simulator cache-stat deltas layer-wise.  The ``collectives``
    layer is excluded here — its counters are process-global, so every
    simulator reports the same window and summing would multi-count; the
    caller patches in one global delta instead."""
    out: dict[str, dict] = {}
    for d in deltas:
        for layer, st in d.items():
            if layer == "collectives":
                continue
            acc = out.setdefault(layer, {"hits": 0, "misses": 0})
            acc["hits"] += st.get("hits", 0)
            acc["misses"] += st.get("misses", 0)
    return out


def _serving_probe(spec: SimSpec) -> SimSpec:
    """The steady-state spec a serving candidate is step-probed with: one
    replica's decode iteration at the policy's admission cap and the
    oracle's context floor, bucketed exactly like the oracle buckets it —
    so the probe's priced report is the first entry of the serving run's
    own step table (shared through the SimCache), and it carries the memory
    footprint the post-simulation ``memory_limit`` filter needs."""
    from repro_torch.api.spec import Cluster, DecodeWorkload
    from repro_torch.serving.sim.oracle import pow2_bucket
    w = spec.workload
    ctx = pow2_bucket(w.ctx_floor)
    return SimSpec(
        model=spec.model,
        cluster=Cluster(spec.cluster.resolve(),
                        memory_limit=spec.cluster.memory_limit),
        parallel=dataclasses.replace(spec.parallel, dp=1, pods=1,
                                     microbatches=1),
        workload=DecodeWorkload(global_batch=pow2_bucket(w.max_batch),
                                seq_len=ctx, cache_len=ctx))


def _resolve_scenario(objective: str, scenario):
    """Normalize the user-facing ``scenario=`` argument once per process
    (idempotent: an already-resolved scenario passes through).  Deferred
    import: repro_torch.serving pulls the real-model serving stack, which the
    step-time-only path never needs."""
    if objective != "goodput":
        return scenario
    from repro_torch.serving.sim import ServingScenario
    if scenario is None:
        return ServingScenario.default()
    if isinstance(scenario, ServingWorkload):
        return scenario.scenario()
    return scenario


def _evaluate_one(idx: int, spec: SimSpec, cand: Candidate, sims: dict,
                  stats0: dict, engine: str, objective: str, scenario,
                  persist: str | None = None, timings: list | None = None,
                  faults=None, attempt: int = 1) -> EvalResult:
    """Evaluate one candidate end to end: step/probe pricing, the
    post-simulation memory filter, then the objective's serving/resilience
    replay.  THE single evaluation code path — the serial loop and every
    pool worker run exactly this function, which is why parallel sweeps
    (under any fault schedule) are bit-identical to serial ones.

    ``timings`` (a list, when given) collects ``(idx, phase, t0, t1)``
    wall-clock rows per evaluation stage — raw material for the sweep's
    per-worker trace lanes.  ``faults`` is the chaos hook
    (:class:`~repro_torch.analysis.chaos.FaultPlan`): only ``candidate_error``
    fires here, *before* any pricing, so an injected failure can never
    change a simulated number."""
    t0 = wall_s()
    s = _sim_for(spec.cluster, sims, engine, persist)
    # snapshot a lazily-created simulator's counters before its first
    # run: the collectives memo is process-global, not zero at birth
    if spec.cluster.hardware not in stats0:
        stats0[spec.cluster.hardware] = s.cache_stats()
    if faults is not None:
        faults.maybe_raise(spec.json_hash(), attempt)
    serving_mode = spec.workload.mode == "serving"
    rep = s.run(_serving_probe(spec) if serving_mode else spec)
    res = EvalResult(cand, rep, spec=spec)
    limit = spec.cluster.memory_limit
    if limit and rep.memory and rep.memory.total > limit:
        res.pruned = True
        res.reason = f"memory {rep.memory.total/1e9:.1f}GB > limit"
    if timings is not None:
        timings.append((idx, "probe" if serving_mode else "step",
                        t0, wall_s()))
    if res.pruned:
        return res
    if objective == "goodput":
        from repro_torch.serving.sim import ServingSimulator
        t0 = wall_s()
        if serving_mode:
            # the spec IS the scenario: trace, SLO, policy and fleet all
            # come from the ServingWorkload (FleetReports are system-
            # level — EvalResult.goodput_rps passes them through)
            res.serving = ServingSimulator(s).run(spec)
        else:
            res.serving = scenario.evaluate(s, spec.model, cand)
        if timings is not None:
            timings.append((idx, "serving", t0, wall_s()))
    elif objective == "goodput_under_failures":
        from repro_torch.resilience import ResilienceSimulator
        t0 = wall_s()
        res.resilience = ResilienceSimulator(s).run(spec)
        if timings is not None:
            timings.append((idx, "resilience", t0, wall_s()))
    return res


def _evaluate(items: list, sims: dict, stats0: dict, engine: str,
              objective: str, scenario, persist: str | None = None,
              timings: list | None = None,
              progress: Callable | None = None) -> list:
    """Evaluate ``(idx, spec, cand)`` triples in order via
    :func:`_evaluate_one`; returns ``(idx, EvalResult)`` pairs."""
    scenario = _resolve_scenario(objective, scenario)
    results: list[tuple[int, EvalResult]] = []
    for idx, spec, cand in items:
        res = _evaluate_one(idx, spec, cand, sims, stats0, engine,
                            objective, scenario, persist, timings)
        results.append((idx, res))
        if progress is not None:
            progress(res)
    return results


def _shard_items(items: list, workers: int) -> list[list]:
    """Deterministically shard ``(idx, spec, cand)`` triples over workers.

    Whole trace-affinity clusters — contiguous runs of reuse groups that
    share a traced-graph (``ingest``) key — are kept together, so each
    worker's per-process ingest cache traces any given shape exactly once
    and no two workers duplicate a trace.  Clusters go to the currently
    lightest shard (greedy balance; ties break on shard index), which is a
    pure function of the candidate list, so the shard layout — and thus
    every worker-local cache interaction — is reproducible."""
    def trace_key(spec: SimSpec) -> tuple:
        # serving candidates sharing a bucket family would all land on one
        # worker (their trace shapes are identical by design), yet their
        # cost is the Python event loop, not graph traces — spread them by
        # full workload identity instead
        extra = (spec.workload,) if spec.workload.mode == "serving" else ()
        return (spec.cluster.hardware, spec.model,
                spec.workload.mode) + spec.trace_shapes() + extra

    clusters: dict[tuple, list] = {}
    for item in items:
        clusters.setdefault(trace_key(item[1]), []).append(item)
    shards: list[list] = [[] for _ in range(workers)]
    for cluster in clusters.values():
        target = min(range(workers), key=lambda i: (len(shards[i]), i))
        shards[target].extend(cluster)
    return [s for s in shards if s]


def _write_manifest(path: str, space: SweepSpace,
                    result: ExplorationResult) -> None:
    """Sweep provenance: the space, every candidate's full spec JSON (keyed
    by :meth:`~repro_torch.api.spec.SimSpec.json_hash`), its outcome, and the
    final ranking — enough to re-run or audit any row without the process
    that produced it."""
    import json

    from repro_torch.obs.explain import (
        compact_report, compact_resilience, compact_serving,
    )

    def row(res: EvalResult, rank: dict) -> dict:
        h = res.spec.json_hash()
        # compact attribution: every surviving candidate carries its "why"
        # (dominant phase / SLO-violation cause / loss bucket) so ranking
        # flips are explainable straight from the manifest
        explain = None
        if not res.pruned:
            explain = {}
            if res.report is not None:
                explain["step"] = compact_report(res.report)
            if res.serving is not None:
                explain["serving"] = compact_serving(res.serving)
            if res.resilience is not None:
                explain["resilience"] = compact_resilience(res.resilience)
        return {
            "json_hash": h,
            "spec": json.loads(res.spec.to_json()),
            "status": "pruned" if res.pruned else "completed",
            "pruned": res.pruned,
            "reason": res.reason or None,
            "step_time_us": (round(res.report.step_time_us, 3)
                             if res.report is not None else None),
            "goodput_rps": (round(res.goodput_rps, 4)
                            if res.serving is not None else None),
            "goodput_under_failures": (
                round(res.resilience.goodput, 6)
                if res.resilience is not None else None),
            "explain": explain,
            "rank": rank.get(h),
        }

    def failed_row(rec) -> dict:
        # quarantined candidates stay visible: downstream tooling must be
        # able to see *every* enumerated candidate's outcome
        return {
            "json_hash": rec.spec.json_hash(),
            "spec": json.loads(rec.spec.to_json()),
            "status": "failed",
            "pruned": False,
            "reason": rec.reason,
            "attempts": rec.attempts,
            "traceback": rec.traceback or None,
            "rank": None,
        }

    try:
        ranking = [r.spec.json_hash() for r in result.ranked()]
    except ValueError:        # mixed objectives: manifest still records rows
        ranking = []
    rank = {h: i for i, h in enumerate(ranking)}
    doc = {
        "kind": "charon-sweep-manifest",
        "version": 1,
        "base_hash": space.base.json_hash(),
        "base": json.loads(space.base.to_json()),
        "axes": {name: list(vals) for name, vals in space.axes},
        "objective": result.objective,
        "workers": result.workers,
        "wall_time_s": round(result.wall_time_s, 3),
        "n_evaluated": len(result.evaluated),
        "n_pruned": len(result.pruned),
        "n_failed": len(result.failed),
        "metrics": result.metrics or None,
        "ranking": ranking,
        "candidates": [row(r, rank)
                       for r in result.evaluated + result.pruned]
                      + [failed_row(rec) for rec in result.failed],
    }
    with open(path, "w") as f:
        # default=str absorbs non-JSON axis values (HardwareSpec and
        # friends) the same way the spec's own serializer names them
        json.dump(doc, f, indent=1, sort_keys=True, default=str)
        f.write("\n")


def _progress_line(reg: MetricsRegistry, n_total: int, t0: float, *,
                   final: bool = False) -> None:
    """One stderr progress line, driven entirely by the sweep's metrics
    registry (configs done, rate, ETA, prune count)."""
    import sys
    done = int(reg.counters.get("sweep.configs_done", 0))
    npruned = int(reg.counters.get("sweep.pruned", 0))
    el = wall_s() - t0
    rate = done / el if el > 0 else 0.0
    eta = (n_total - done) / rate if rate > 0 else float("inf")
    eta_s = f"{eta:.0f}s" if math.isfinite(eta) else "?"
    print(f"\rsweep {done}/{n_total} configs · {rate:.1f} cfg/s · "
          f"eta {eta_s} · pruned {npruned}",
          file=sys.stderr, end="\n" if final else "", flush=True)


def _record_sweep_lanes(rec, sweep_t0: float, lane: str, timings: list,
                        by_idx: dict) -> None:
    """Per-candidate evaluation spans on one worker's trace lane (timings
    are epoch seconds from :func:`_evaluate`; normalized to sweep-relative
    time here), with prune instants carrying their reasons."""
    if not rec.enabled:
        return
    for idx, phase, a, b in timings:
        res = by_idx.get(idx)
        args: dict = {"idx": idx}
        if res is not None:
            args["json_hash"] = res.spec.json_hash()[:12]
        rec.span("sweep", lane, f"cand{idx}:{phase}", a - sweep_t0, b - a,
                 cat="sweep", args=args)
        if res is not None and res.pruned and phase in ("step", "probe"):
            rec.instant("sweep", lane, f"prune:cand{idx}", b - sweep_t0,
                        cat="prune", args={"idx": idx, "reason": res.reason})


def _journal_header(space: SweepSpace, objective: str, engine: str) -> dict:
    """The identity a journal is keyed by: resuming against a journal whose
    base spec, axes, objective or engine differ must fail loudly rather
    than silently mix results from two different sweeps."""
    return {"base_hash": space.base.json_hash(),
            "axes": {name: list(vals) for name, vals in space.axes},
            "objective": objective, "engine": engine}


def sweep(space: SweepSpace, *, sim: Simulator | None = None,
          engine: str = "analytical", rules: list[Callable] | None = None,
          max_evals: int = 10_000, objective: str = "step_time",
          scenario=None, workers: int = 1, persist: str | None = None,
          mp_context: str | None = None, manifest: str | None = None,
          journal: str | None = None, resume: str | None = None,
          strict: bool = False, faults: FaultPlan | None = None,
          retry: RetryPolicy | None = None,
          recorder=None, metrics: MetricsRegistry | None = None,
          progress: bool = False) -> ExplorationResult:
    """Enumerate, prune, simulate and rank every spec in ``space``.

    ``sim`` seeds the per-hardware simulator registry (its caches stay warm
    across sweeps); hardware axes beyond it get fresh ``engine`` simulators.
    Pruning uses the classic rules plus, when ``cluster.memory_limit`` is
    set, the closed-form memory-fit lower bound before simulation and the
    full memory report after.  ``objective="goodput"`` replays a
    request-level scenario per candidate — pass a
    :class:`~repro_torch.serving.sim.ServingScenario`, a
    :class:`~repro_torch.api.spec.ServingWorkload`, or None for the default.
    ``objective="goodput_under_failures"`` replays each candidate's seeded
    failure trace through :class:`~repro_torch.resilience.ResilienceSimulator`
    (the base must be a ``TrainWorkload`` with ``resilience=`` set, whose
    nested fields — checkpoint interval, MTBFs, spares — are then ordinary
    dotted axes); results carry ``EvalResult.resilience``.

    A :class:`~repro_torch.api.spec.ServingWorkload` *base* (goodput objective
    only) sweeps the request-level simulator itself: each candidate replays
    the spec's own trace/SLO/policy — including its
    :class:`~repro_torch.api.spec.FleetSpec`, so ``workload.fleet.replicas`` or
    ``workload.fleet.prefill_replicas`` are axes like any other — and is
    step-probed once (one bucketed decode iteration) for the memory filter
    and ranking tie-breaks.

    ``workers > 1`` shards candidate groups by reuse/trace key over a
    long-lived :class:`~repro_torch.api.pool.WorkerPool` (a process-wide
    singleton: the second sweep reuses warm workers, skipping the spawn +
    torch-import cost and keeping worker-local simulator caches hot).
    ``mp_context=None`` picks ``fork`` where the platform offers it and the
    process has not initialised CUDA, else ``spawn``.  Results, rankings
    and pruned reasons are bit-identical to the serial sweep, with the
    merged ``cache_stats`` summing the
    per-worker deltas.  ``sim=`` is not used for evaluation in that case
    (worker processes own their simulators); pass ``persist=`` (a
    directory) to warm-start every worker from the on-disk cache tier —
    workers write their new entries back as atomic per-worker shards,
    merged (and corruption-quarantined) into the main cache file when the
    sweep completes.

    Execution contract (``retry=``, a :class:`~repro_torch.api.pool.RetryPolicy`):
    each candidate gets a wall-clock timeout and heartbeat-based liveness
    checks; a worker crash/hang/timeout retries the candidate with
    exponential backoff on a respawned worker up to ``max_retries`` times,
    after which the candidate is *quarantined* — recorded on
    ``ExplorationResult.failed`` (and as ``status: failed`` in the
    manifest) instead of aborting the sweep.  ``strict=True`` opts back
    into fail-fast: the serial path re-raises the underlying exception, the
    pool raises :class:`~repro_torch.api.pool.CandidateFailedError`.  ``faults=``
    (a :class:`~repro_torch.analysis.chaos.FaultPlan`; default: parsed from the
    ``CHARON_FAULTS`` env var) deterministically injects worker crashes,
    hangs, poison candidates and cache-shard corruption to exercise exactly
    those recovery paths — see docs/robustness.md.

    ``journal=`` (a file path) appends one fsync'd JSONL row per finished
    candidate as the sweep runs; after a crash or kill, re-running with the
    same ``journal=`` (or pointing ``resume=`` at the file) validates the
    sweep identity, injects the recorded results and evaluates only the
    remainder — merged rankings are bit-identical to an uninterrupted run.

    ``manifest=`` (a file path) writes a JSON provenance record after the
    sweep: the space, every candidate's full spec (keyed by its
    ``json_hash``), per-row ``status`` (completed/pruned/failed), pruned
    reasons, objective values, a compact ``explain`` attribution per
    surviving row, the metrics snapshot and the final ranking.

    Observability (all off by default, zero cost when off): ``recorder`` (a
    :class:`~repro_torch.obs.TraceRecorder`) captures per-worker lanes of
    per-candidate evaluation spans plus prune instants; ``metrics`` (a
    :class:`~repro_torch.obs.MetricsRegistry`) accumulates sweep counters — a
    snapshot always lands in ``ExplorationResult.metrics`` and the
    manifest; ``progress=True`` prints a stderr progress line (configs
    done, rate, ETA, prune counts) as candidates complete.  None of the
    three changes results or rankings.
    """
    if objective not in ("step_time", "goodput", "goodput_under_failures"):
        raise ValueError(f"unknown objective {objective!r}")
    if objective == "goodput_under_failures":
        w = space.base.workload
        if getattr(w, "mode", None) != "train" or w.resilience is None:
            raise TypeError(
                "goodput_under_failures sweeps price TrainWorkload specs "
                "with a non-None resilience= — set workload.resilience on "
                "the base spec (its fields are then sweep axes, e.g. "
                "'workload.resilience.ckpt.interval_steps')")
    serving_base = isinstance(space.base.workload, ServingWorkload)
    if serving_base and objective != "goodput":
        raise TypeError(
            "a ServingWorkload base sweeps the request-level simulator — "
            "pass objective='goodput' (step_time needs a steady-state "
            "Train/Prefill/Decode workload)")
    if serving_base and scenario is not None:
        raise TypeError(
            "a ServingWorkload base carries its own trace/SLO/policy; "
            "scenario= would be ignored — drop one of the two")
    rules = list(DEFAULT_RULES if rules is None else rules)
    reg = metrics if metrics is not None else MetricsRegistry()
    rec = recorder if recorder is not None else NULL_RECORDER
    policy = retry if retry is not None else RetryPolicy()
    if faults is None:
        faults = FaultPlan.from_env()
    if faults is not None and not faults.enabled:
        faults = None
    t0 = wall_s()
    coll0 = collective_memo_stats().as_dict()
    pruned: list[EvalResult] = []
    cands: list[tuple[SimSpec, Candidate]] = []
    for spec in space.points():
        w = spec.workload
        cand = Candidate(spec.parallel, getattr(w, "global_batch", None)
                         or w.max_batch)
        reason = next((r for rule in rules
                       if (r := rule(spec.model, cand))), None)
        if reason is None and spec.cluster.memory_limit \
                and w.mode != "serving":
            # serving specs have no single step shape for the closed-form
            # bound; the probe's full memory report post-filters them
            fit = rule_memory_fit(spec.cluster.memory_limit, mode=w.mode,
                                  seq_len=w.seq_len, cache_len=w.cache_len)
            reason = fit(spec.model, cand)
        if reason:
            pruned.append(EvalResult(cand, None, pruned=True, reason=reason,
                                     spec=spec))
            reg.inc("sweep.pruned")
            reg.inc("sweep.pruned_rules")
            if rec.enabled:
                rec.instant("sweep", "prune", "prune:rule", 0.0, cat="prune",
                            args={"json_hash": spec.json_hash()[:12],
                                  "reason": reason})
            continue
        cands.append((spec, cand))

    # evaluate group-by-group so every candidate after the first in a group
    # hits the simulator's block-stage cache while it is warm
    cands.sort(key=lambda sc: (sc[0].reuse_key(), sc[1].key()))
    n_groups = len({s.reuse_key() for s, _ in cands})
    items = [(i, spec, cand)
             for i, (spec, cand) in enumerate(cands[:max_evals])]

    # ---- journal / resume: skip candidates with recorded outcomes --------
    header = _journal_header(space, objective, engine)
    expect = {"kind": SweepJournal.KIND, "version": SweepJournal.VERSION,
              **header}
    prior_rows: dict[str, dict] = {}
    if resume and not (journal and os.path.abspath(str(resume))
                       == os.path.abspath(str(journal))):
        prior_rows.update(SweepJournal.load(str(resume), expect=expect))
    jr = SweepJournal(str(journal), header) if journal else None
    if jr is not None:
        prior_rows.update(jr.rows)

    injected: list[tuple[int, EvalResult]] = []
    todo: list = []
    for idx, spec, cand in items:
        row = prior_rows.get(spec.json_hash()) if prior_rows else None
        # failed rows are re-attempted: a resume is an explicit second
        # chance for transient (crash/timeout) failures
        if row is not None and row["status"] in ("completed", "pruned"):
            injected.append((idx, SweepJournal.result_from(row)))
            reg.inc("sweep.resumed")
        else:
            todo.append((idx, spec, cand))

    def count_result(res: EvalResult) -> None:
        reg.inc("sweep.configs_done")
        if res.pruned:
            reg.inc("sweep.pruned")
            reg.inc("sweep.pruned_memory")
        else:
            reg.inc("sweep.evaluated")

    for _, res in injected:
        count_result(res)

    failed: list[FailedCandidate] = []

    def on_result(res: EvalResult, attempt: int = 1) -> None:
        count_result(res)
        if jr is not None:
            jr.append_result(res)
        if progress:
            _progress_line(reg, len(items), t0)

    def on_failed(recf: FailedCandidate) -> None:
        reg.inc("sweep.configs_done")
        reg.inc("sweep.failed")
        if jr is not None:
            jr.append_failed(recf)
        if rec.enabled:
            rec.instant("sweep", "quarantine", "quarantine",
                        wall_s() - t0, cat="fault",
                        args={"json_hash": recf.spec.json_hash()[:12],
                              "reason": recf.reason,
                              "attempts": recf.attempts})
        if progress:
            _progress_line(reg, len(items), t0)

    workers = max(int(workers), 1)
    pooled = workers > 1 and len(todo) > 1
    try:
        if pooled:
            shards = _shard_items(todo, workers)
            pool = get_pool(workers, mp_context)
            eval_results, pool_failed, merged, coll, lanes, shard_files = \
                pool.run(shards, engine=engine, objective=objective,
                         scenario=scenario, persist=persist, faults=faults,
                         policy=policy, strict=strict,
                         shard_tag=space.base.json_hash()[:8],
                         metrics=reg, recorder=rec, sweep_t0=t0,
                         on_result=on_result, on_failed=on_failed)
            failed.extend(pool_failed)
            by_idx = dict(eval_results)
            for wid in sorted(lanes):
                for _, phase, a, b in lanes[wid]:
                    reg.observe(f"sweep.eval_s.{phase}", b - a)
                _record_sweep_lanes(rec, t0, f"worker{wid}", lanes[wid],
                                    by_idx)
            # workers wrote their persistent-cache entries as atomic
            # shards; union them back into the main file(s) now
            for main, shard_list in sorted(shard_files.items()):
                merge_cache_shards(main, shard_list, metrics=reg)
            merged["collectives"] = coll
        else:
            sims: dict[str, Simulator] = {}
            if sim is not None:
                sims[sim.hw.name] = sim
            stats0 = {k: s.cache_stats() for k, s in sims.items()}
            timings: list = []
            scenario_r = _resolve_scenario(objective, scenario)
            eval_results = []
            for idx, spec, cand in todo:
                attempt = 1
                while True:
                    try:
                        res = _evaluate_one(
                            idx, spec, cand, sims, stats0, engine,
                            objective, scenario_r, persist, timings,
                            faults=faults, attempt=attempt)
                    except Exception as e:
                        if strict:
                            raise
                        reg.inc("pool.candidate_errors")
                        if attempt <= policy.max_retries:
                            attempt += 1
                            reg.inc("pool.retries")
                            continue
                        recf = FailedCandidate(
                            cand, spec, attempt,
                            f"{type(e).__name__}: {e}",
                            _compact_tb(traceback.format_exc()))
                        reg.inc("pool.quarantined")
                        failed.append(recf)
                        on_failed(recf)
                        break
                    eval_results.append((idx, res))
                    on_result(res, attempt)
                    break
            for _, phase, a, b in timings:
                reg.observe(f"sweep.eval_s.{phase}", b - a)
            _record_sweep_lanes(rec, t0, "worker0", timings,
                                dict(eval_results))
            if persist:
                for s in sims.values():
                    s.save_cache()
            deltas = [_stats_delta(s.cache_stats(), stats0.get(k, {}))
                      for k, s in sims.items()]
            merged = _merge_stats(deltas)
            coll1 = collective_memo_stats().as_dict()
            merged["collectives"] = {k: coll1[k] - coll0[k]
                                     for k in ("hits", "misses")}
    finally:
        if jr is not None:
            jr.close()

    wall = wall_s() - t0
    evaluated = []
    for _, res in sorted(eval_results + injected, key=lambda r: r[0]):
        (pruned if res.pruned else evaluated).append(res)
    # deterministic quarantine order regardless of which worker/attempt
    # recorded the failure
    failed.sort(key=lambda f: f.spec.json_hash())
    if progress:
        _progress_line(reg, len(items), t0, final=True)
    reg.set("sweep.n_groups", n_groups)
    reg.set("sweep.wall_s", round(wall, 6))
    reg.set("sweep.configs_per_sec",
            round(len(items) / wall, 4) if wall > 0 else 0.0)
    reg.update_nested(merged, prefix="sweep.cache")
    result = ExplorationResult(
        tuple(evaluated), tuple(pruned), wall, n_groups=n_groups,
        configs_per_sec=(len(items) / wall) if wall > 0 else 0.0,
        cache_stats=merged, objective=objective,
        workers=workers if pooled else 1,
        metrics=reg.snapshot(), failed=tuple(failed))
    if manifest:
        _write_manifest(manifest, space, result)
    return result
