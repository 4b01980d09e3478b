"""Discrete-event resilience timeline: priced steps vs. a failure trace.

``replay`` walks a training run step by step against a lazy failure trace
(:class:`~repro_torch.resilience.faults.FailureGen`), charging every second of
simulated wall time to exactly one bucket::

    wall_s == useful_s + rework_s + straggler_s + checkpoint_s + downtime_s

Steps are priced through a caller-supplied ``price(hosts)`` callback (the
step oracle underneath), so elastic resharding re-prices degraded meshes
for free; stragglers are a per-(step, host) multiplier table sampled once
and replayed identically on rework — a gang-synchronized step costs the
max over its hosts.

The loop is sequential (one job, one mesh), but failures are *exogenous*:
component clocks tick in wall time whether the job computes, checkpoints,
or sits in a restart, which is what makes a checkpoint-interval sweep
against a fixed seeded trace meaningful.
"""
from __future__ import annotations

import heapq
import math
from dataclasses import dataclass, field
from typing import Callable

from repro_torch.obs.recorder import CNAMES, NULL_RECORDER
from repro_torch.resilience.faults import FailureEvent, FailureGen

# steps are counted as "completed steps so far", so checkpoint boundaries
# land after step % interval == 0 and restore rolls back to that count


@dataclass
class ReplayStats:
    """Raw tallies out of one :func:`replay` pass."""
    wall_s: float = 0.0
    useful_s: float = 0.0
    rework_s: float = 0.0
    straggler_s: float = 0.0
    checkpoint_s: float = 0.0
    downtime_s: float = 0.0
    steps_done: int = 0
    useful_tokens: float = 0.0
    n_failures: dict[str, int] = field(default_factory=dict)
    n_restarts: int = 0
    n_checkpoints: int = 0
    n_spare_swaps: int = 0
    n_reshards: int = 0
    degraded_steps: int = 0
    completed: bool = True
    events: list[FailureEvent] = field(default_factory=list)


def replay(*, total_steps: int, interval: int,
           price: Callable[[int], tuple[float, float]],
           failgen: FailureGen,
           straggler_mult: Callable[[int, int], float] | None,
           n_hosts: int, min_hosts: int, spares: int, elastic: bool,
           save_s: float, restore_s: float, sync: bool,
           async_overhead: float, restart_delay_s: float, repair_s: float,
           max_wall_s: float, rec=NULL_RECORDER) -> ReplayStats:
    """Replay ``total_steps`` priced steps against the failure trace.

    ``price(hosts) -> (base_step_s, tokens_per_step)`` for a mesh of
    ``hosts`` hosts (memoized by the caller).  ``straggler_mult(step,
    hosts)`` is the gang-max slowdown of that step index on that mesh
    (``None`` = no stragglers).  ``interval == 0`` means never checkpoint:
    any failure rolls back to step 0.

    ``rec`` (a :class:`~repro_torch.obs.TraceRecorder`) captures the bucket
    partition as colored trace spans — useful/rework step windows (known
    only retroactively, at commit vs. wipe), straggler tails, checkpoint
    stalls, downtime windows, failure instants.  The stats are identical
    with recording on or off.
    """
    st = ReplayStats()
    wall = 0.0
    step = 0                 # completed steps
    last_ckpt = 0            # last durable checkpoint (in completed steps)
    hosts = n_hosts          # hosts currently in the mesh
    spares_free = spares
    repairs: list[float] = []       # repair-completion times (min-heap)
    pending: tuple[float, int] | None = None   # async (durable_at, step)
    # steps since the last durable checkpoint: (step_count, base_s, tokens)
    uncommitted: list[tuple[int, float, float]] = []
    # trace-only mirror of ``uncommitted``: (step_count, start_s, base_dur)
    # — useful vs. rework is decided retroactively, so open step windows
    # stay here until a commit (useful span) or a failure wipe (rework span)
    windows: list[tuple[int, float, float]] = []
    prev_price_hosts: int | None = None
    _PID = "resilience"

    def flush_windows(upto: int, cname_key: str):
        keep = []
        for (i, s0, d) in windows:
            if i <= upto:
                rec.span(_PID, "steps", f"step{i}", s0, d, cat="bucket",
                         cname=CNAMES[cname_key])
            else:
                keep.append((i, s0, d))
        windows[:] = keep

    def commit(upto: int):
        nonlocal last_ckpt
        keep = []
        for (i, b, tok) in uncommitted:
            if i <= upto:
                st.useful_s += b
                st.useful_tokens += tok
            else:
                keep.append((i, b, tok))
        uncommitted[:] = keep
        last_ckpt = upto
        st.n_checkpoints += 1
        if rec.enabled:
            flush_windows(upto, "useful")

    def check_async(now: float):
        nonlocal pending
        if pending is not None and pending[0] <= now:
            commit(pending[1])
            pending = None

    def process_repairs(now: float):
        nonlocal spares_free
        while repairs and repairs[0] <= now:
            heapq.heappop(repairs)
            spares_free += 1

    def capacity(ev: FailureEvent):
        # link failures are transient (restart, reroute around) — no host
        # leaves; a chip failure drains its whole host, like a host failure
        nonlocal hosts, spares_free
        if ev.kind == "link":
            return
        if spares_free > 0:
            spares_free -= 1
            st.n_spare_swaps += 1          # hot swap: mesh size kept
        else:
            hosts -= 1
        heapq.heappush(repairs, ev.t_s + repair_s)

    def record(ev: FailureEvent):
        st.events.append(ev)
        st.n_failures[ev.kind] = st.n_failures.get(ev.kind, 0) + 1
        if rec.enabled:
            rec.instant(_PID, "faults", f"FAILURE:{ev.kind}", ev.t_s,
                        cat="fault", args={"kind": ev.kind})

    def handle_failure(ev: FailureEvent):
        nonlocal wall, step, pending, hosts, spares_free
        # an in-flight async save that became durable before the failure
        # still counts; anything later is lost with the job state
        check_async(ev.t_s)
        pending = None
        process_repairs(ev.t_s)
        record(ev)
        st.n_restarts += 1
        for (_, b, _tok) in uncommitted:   # wiped: replayed from last_ckpt
            st.rework_s += b
        uncommitted.clear()
        if rec.enabled:
            flush_windows(total_steps + 1, "rework")  # wipe: all are rework

        def restart_end(t: float) -> float:
            return t + restart_delay_s + (restore_s if last_ckpt > 0 else 0.0)

        capacity(ev)
        end = restart_end(ev.t_s)
        # absorb failures that land inside the restart window — each one
        # restarts the restart
        while failgen.peek() <= end:
            ev2 = failgen.pop()
            record(ev2)
            capacity(ev2)
            end = max(end, restart_end(ev2.t_s))
            if end > max_wall_s:
                break
        # a mesh below the feasibility floor (or any degradation, when not
        # elastic) stalls until repairs bring hosts back
        required = min_hosts if elastic else n_hosts
        while hosts < required and repairs:
            t = heapq.heappop(repairs)
            end = max(end, restart_end(t))
            hosts += 1
        if hosts < required:
            st.completed = False
            end = max(end, max_wall_s) + 1.0   # trip the divergence guard
        # restarting anyway: refill the mesh from free spares
        while hosts < n_hosts and spares_free > 0:
            hosts += 1
            spares_free -= 1
            st.n_spare_swaps += 1
        st.downtime_s += end - ev.t_s
        if rec.enabled:
            rec.span(_PID, "downtime", f"restart:{ev.kind}", ev.t_s,
                     end - ev.t_s, cat="bucket", cname=CNAMES["downtime"],
                     args={"rollback_to_step": last_ckpt, "hosts": hosts})
        wall = end
        step = last_ckpt

    while step < total_steps:
        check_async(wall)
        process_repairs(wall)
        if wall > max_wall_s:
            st.completed = False
            break
        base_s, tokens = price(hosts)
        if prev_price_hosts is not None and hosts != prev_price_hosts:
            st.n_reshards += 1
        prev_price_hosts = hosts
        mult = straggler_mult(step, hosts) if straggler_mult else 1.0
        dt = base_s * mult
        if failgen.peek() <= wall + dt:
            ev = failgen.pop()
            st.rework_s += ev.t_s - wall   # the partial step is wiped too
            if rec.enabled and ev.t_s > wall:
                rec.span(_PID, "steps", f"step{step + 1}:partial", wall,
                         ev.t_s - wall, cat="bucket", cname=CNAMES["rework"])
            wall = ev.t_s
            handle_failure(ev)
            continue
        if rec.enabled:
            windows.append((step + 1, wall, base_s))
            if dt > base_s:
                rec.span(_PID, "straggler", f"step{step + 1}:straggle",
                         wall + base_s, dt - base_s, cat="bucket",
                         cname=CNAMES["straggler"],
                         args={"mult": round(mult, 4)})
        wall += dt
        step += 1
        uncommitted.append((step, base_s, tokens))
        st.straggler_s += dt - base_s
        if hosts < n_hosts:
            st.degraded_steps += 1
        if interval and step % interval == 0 and step < total_steps:
            # the boundary stall: full save when sync, snapshot when async
            stall = save_s if sync else async_overhead * save_s
            if failgen.peek() <= wall + stall:
                ev = failgen.pop()
                st.checkpoint_s += ev.t_s - wall
                if rec.enabled and ev.t_s > wall:
                    rec.span(_PID, "checkpoint", f"save@{step}:partial",
                             wall, ev.t_s - wall, cat="bucket",
                             cname=CNAMES["checkpoint"])
                wall = ev.t_s
                handle_failure(ev)
                continue
            if rec.enabled and stall > 0:
                rec.span(_PID, "checkpoint", f"save@{step}", wall, stall,
                         cat="bucket", cname=CNAMES["checkpoint"],
                         args={"mode": "sync" if sync else "async"})
            wall += stall
            st.checkpoint_s += stall
            if sync:
                commit(step)
            else:
                # durable once the background write lands; a failure before
                # then falls back to the previous durable checkpoint
                pending = (wall + save_s, step)

    # final completion (or the divergence guard) covers whatever survived
    for (_, b, tok) in uncommitted:
        st.useful_s += b
        st.useful_tokens += tok
    uncommitted.clear()
    if rec.enabled:
        flush_windows(total_steps + 1, "useful")
    st.wall_s = wall
    st.steps_done = step
    if not math.isfinite(wall):
        st.completed = False
    return st
