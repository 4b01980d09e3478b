"""ResilienceSimulator: price a training run under injected failures.

Wraps a :class:`~repro_torch.core.simulator.Simulator` the same way the serving
simulator does: the step oracle prices steps (full mesh and every elastic
degraded mesh, memoized), the resilience timeline replays them against the
spec's seeded failure trace, and the result is a
:class:`~repro_torch.resilience.report.ResilienceReport`.

    sim = Simulator("h100_sxm", engine="analytical")
    spec = SimSpec(cfg, cluster=Cluster("h100_sxm", pods=1),
                   parallel=ParallelConfig(tp=4, dp=8),
                   workload=TrainWorkload(
                       global_batch=256, resilience=ResilienceSpec(
                           total_steps=2000,
                           faults=FaultModel(host_mtbf_s=4 * 3600, seed=7),
                           ckpt=CheckpointSpec(interval_steps=100))))
    rep = ResilienceSimulator(sim).run(spec)
    rep.goodput, rep.young_daly_interval_steps, rep.summary()

Determinism contract: the failure trace, the straggler table and therefore
the whole report are pure functions of the spec — same spec, same report,
across runs and across ``sweep(workers=N)``.  An inactive fault model with
checkpointing off reproduces the failure-free report exactly
(``rep.step_report`` is bit-identical to ``Simulator.run`` on the same
spec without ``resilience``, and ``goodput == 1.0``).
"""
from __future__ import annotations

import dataclasses
import math

from repro_torch.api.spec import ResilienceSpec, SimSpec
from repro_torch.resilience.faults import FailureGen, _mix
from repro_torch.resilience.report import ResilienceReport
from repro_torch.resilience.timeline import ReplayStats, replay
from repro_torch.training.fault_tolerance import ElasticPlan

# replayed candidate multipliers around the Young/Daly interval when
# optimize_interval is set — a geometric grid is enough to bracket the
# optimum, and every candidate replays the *same* failure trace
_INTERVAL_GRID = (0.25, 0.5, 1.0, 2.0, 4.0)
# straggler table size guard: (total_steps x n_hosts) doubles, three arrays
_MAX_STRAGGLER_CELLS = 200_000_000


class ResilienceSimulator:
    """Discrete-event resilience pricing over a core step simulator."""

    def __init__(self, sim):
        self.sim = sim

    # ------------------------------------------------------------------
    def run(self, spec: SimSpec, *, recorder=None,
            metrics=None) -> ResilienceReport:
        """Price ``spec`` under its failure model.

        ``recorder`` captures the bucket partition of the *configured*
        interval's replay as colored trace spans (interval-grid candidates
        replayed for ``optimize_interval`` are not recorded — one timeline
        per run); ``metrics`` accumulates failure/restart/checkpoint
        counters.  Reports are bit-identical with either on or off.
        """
        w = spec.workload
        if getattr(w, "mode", None) != "train":
            raise TypeError(
                "ResilienceSimulator prices TrainWorkload specs; got mode="
                f"{getattr(w, 'mode', None)!r}")
        rspec = w.resilience or ResilienceSpec()

        # failure-free baseline: the stripped spec is the plain training
        # spec, so this report is bit-identical to Simulator.run without
        # resilience (and shares its cache entry)
        base_spec = dataclasses.replace(
            spec, workload=dataclasses.replace(w, resilience=None))
        base = self.sim.run(base_spec)
        base_step_s = base.step_time_us / 1e6
        ideal_s = rspec.total_steps * base_step_s

        par = spec.parallel
        chips = par.chips
        cph = rspec.chips_per_host
        n_hosts = max(1, -(-chips // cph))              # ceil
        shard_chips = par.tp * par.pp * par.cp
        min_hosts = max(1, -(-shard_chips // cph))

        # checkpoint pricing: per-device training state over the write path
        mem = base.memory
        state_bytes = float(mem.weights + mem.opt_state) if mem else 0.0
        write_gbps = rspec.ckpt.write_gbps or (
            self.sim.hw.inter.bandwidth / 1e9)
        save_s = state_bytes / (write_gbps * 1e9) if write_gbps > 0 else 0.0
        restore_s = rspec.ckpt.restore_factor * save_s

        price = self._make_pricer(spec, rspec, base, n_hosts)
        stragglers = _straggler_table(rspec, n_hosts)

        def one(interval: int, rec=None) -> ReplayStats:
            # a fresh generator per replay: every interval candidate sees
            # the identical seeded trace
            from repro_torch.obs.recorder import NULL_RECORDER
            gen = FailureGen(rspec.faults, n_chips=chips, n_hosts=n_hosts,
                             n_links=n_hosts)
            return replay(
                total_steps=rspec.total_steps, interval=interval,
                price=price, failgen=gen, straggler_mult=stragglers,
                n_hosts=n_hosts, min_hosts=min_hosts, spares=rspec.spares,
                elastic=rspec.elastic, save_s=save_s, restore_s=restore_s,
                sync=rspec.ckpt.mode == "sync",
                async_overhead=rspec.ckpt.async_overhead,
                restart_delay_s=rspec.restart_delay_s,
                repair_s=rspec.repair_s,
                max_wall_s=rspec.max_wall_factor * max(ideal_s, 1e-9),
                rec=rec if rec is not None else NULL_RECORDER)

        interval = rspec.ckpt.interval_steps
        st = one(interval, rec=recorder)

        # system MTBF and the Young/Daly closed form, in steps
        rate = 0.0
        for mtbf, count in ((rspec.faults.chip_mtbf_s, chips),
                            (rspec.faults.host_mtbf_s, n_hosts),
                            (rspec.faults.link_mtbf_s, n_hosts)):
            if 0 < mtbf < math.inf:
                rate += count / mtbf
        mtbf_system = 1.0 / rate if rate > 0 else math.inf
        yd_steps = None
        if rate > 0 and save_s > 0 and base_step_s > 0:
            yd_steps = max(1, round(
                math.sqrt(2.0 * save_s * mtbf_system) / base_step_s))

        # simulated optimum: replay the same trace over a grid around
        # Young/Daly (plus the configured interval) and keep the argmax
        sim_opt = None
        by_interval: dict[int, float] = {}
        if rspec.optimize_interval and rate > 0 and yd_steps is not None:
            cands = {max(1, round(yd_steps * f)) for f in _INTERVAL_GRID}
            if interval > 0:
                cands.add(interval)
            for c in sorted(cands):
                stc = st if c == interval else one(c)
                by_interval[c] = _goodput(stc)
            sim_opt = max(sorted(by_interval),
                          key=lambda c: (by_interval[c], -c))

        if metrics is not None:
            metrics.inc("resilience.failures", sum(st.n_failures.values()))
            for kind, n in st.n_failures.items():
                metrics.inc(f"resilience.failures.{kind}", n)
            metrics.inc("resilience.restarts", st.n_restarts)
            metrics.inc("resilience.checkpoints", st.n_checkpoints)
            metrics.inc("resilience.reshards", st.n_reshards)
            metrics.inc("resilience.degraded_steps", st.degraded_steps)
            metrics.observe("resilience.goodput", _goodput(st))
        return ResilienceReport(
            goodput=_goodput(st), wall_s=st.wall_s, ideal_s=ideal_s,
            completed=st.completed, steps_done=st.steps_done,
            total_steps=rspec.total_steps,
            useful_tokens=st.useful_tokens,
            tokens_per_s=st.useful_tokens / max(st.wall_s, 1e-9),
            useful_s=st.useful_s, rework_s=st.rework_s,
            straggler_s=st.straggler_s, checkpoint_s=st.checkpoint_s,
            downtime_s=st.downtime_s, n_failures=st.n_failures,
            n_restarts=st.n_restarts, n_checkpoints=st.n_checkpoints,
            n_spare_swaps=st.n_spare_swaps, n_reshards=st.n_reshards,
            degraded_steps=st.degraded_steps,
            state_bytes_per_device=state_bytes, write_gbps=write_gbps,
            save_s=save_s, restore_s=restore_s, interval_steps=interval,
            mtbf_system_s=mtbf_system,
            young_daly_interval_steps=yd_steps,
            simulated_optimal_interval_steps=sim_opt,
            goodput_by_interval=by_interval,
            step_report=base, failure_trace=tuple(st.events))

    # ------------------------------------------------------------------
    def _make_pricer(self, spec: SimSpec, rspec: ResilienceSpec, base,
                     n_hosts: int):
        """``price(hosts) -> (step_s, tokens_per_step)``, memoized.

        The full mesh uses the baseline report verbatim; degraded meshes
        shrink dp via :meth:`ElasticPlan.rescale` (tp/pp/cp shards intact,
        per-replica batch preserved) and re-price through the step oracle.
        Degraded specs flatten pods: after losing arbitrary hosts the
        original pod structure no longer holds, so the shrunk mesh is
        priced as a single pod — a modeling choice, documented in
        docs/resilience.md.
        """
        w = spec.workload
        par = spec.parallel
        cph = rspec.chips_per_host
        full = (base.step_time_us / 1e6, float(base.tokens_per_step))
        memo: dict[int, tuple[float, float]] = {}

        def price(hosts: int) -> tuple[float, float]:
            if hosts >= n_hosts:
                return full
            got = memo.get(hosts)
            if got is not None:
                return got
            plan = ElasticPlan(tp=par.tp * par.cp, pp=par.pp,
                               dp=par.dp * par.pods,
                               global_batch=w.global_batch)
            new = plan.rescale(min(hosts * cph, par.chips))
            gb = new.global_batch or new.dp   # floor: one sample per replica
            degraded = SimSpec(
                model=spec.model,
                cluster=dataclasses.replace(spec.cluster, pods=1, chips=0),
                parallel=dataclasses.replace(par, dp=new.dp, pods=1),
                workload=dataclasses.replace(w, global_batch=gb,
                                             resilience=None))
            rep = self.sim.run(degraded)
            got = (rep.step_time_us / 1e6, float(rep.tokens_per_step))
            memo[hosts] = got
            return got

        return price


def _goodput(st: ReplayStats) -> float:
    return st.useful_s / st.wall_s if st.wall_s > 0 else 1.0


def _straggler_table(rspec: ResilienceSpec, n_hosts: int):
    """Per-(step, host) slowdown table, sampled once per spec.

    Returns ``mult(step, hosts) -> float`` — the max multiplier over the
    first ``hosts`` hosts at that step (prefix-max precomputed), so a
    shrunk mesh deterministically sees a subset of the full mesh's
    stragglers and a reworked step replays its original slowdown.
    """
    if rspec.straggler_prob <= 0 or rspec.straggler_mult <= 1:
        return None
    cells = rspec.total_steps * n_hosts
    if cells > _MAX_STRAGGLER_CELLS:
        raise ValueError(
            f"straggler table of {cells} cells (total_steps={rspec.total_steps}"
            f" x hosts={n_hosts}) exceeds {_MAX_STRAGGLER_CELLS}; lower "
            "total_steps or disable stragglers")
    import numpy as np
    rng = np.random.default_rng(_mix(rspec.faults.seed, 777, n_hosts))
    shape = (rspec.total_steps, n_hosts)
    slow = rng.random(shape) < rspec.straggler_prob
    draws = 1.0 + rng.random(shape) * (rspec.straggler_mult - 1.0)
    table = np.maximum.accumulate(np.where(slow, draws, 1.0), axis=1)

    def mult(step: int, hosts: int) -> float:
        return float(table[step, min(hosts, n_hosts) - 1])

    return mult
