"""Crash-safe, long-lived worker pool for design-space sweeps.

A fresh ``ProcessPoolExecutor`` per ``sweep(workers=N)`` call would make
every worker pay the spawn + torch import before pricing its first
candidate, and a single worker crash, hang or poison candidate would take
the whole sweep down with no partial results.  This pool is built for
sweep-scale robustness instead:

* **long-lived** — :func:`get_pool` returns a process-wide singleton keyed
  by (workers, context); worker processes survive across ``sweep()`` calls,
  so the torch import is paid once and worker-local simulator caches stay
  warm between sweeps (the steady-state throughput win);
* **fork where safe** — the default context is ``fork`` when the platform
  offers it and this process has not initialised CUDA (workers inherit the
  parent's already-imported torch at zero cost), else ``spawn``: a forked
  child of a process that has initialised CUDA cannot use the card.  Pass
  ``mp_context=`` to override;
* **per-candidate execution contracts** — each candidate is dispatched as
  its own task with a wall-clock timeout; workers send ``started`` markers,
  results, and daemon-thread heartbeats, so the parent can tell a slow
  candidate from a dead or wedged worker;
* **bounded retry + quarantine** — a candidate whose worker died, timed
  out, or raised is retried with exponential backoff up to
  ``RetryPolicy.max_retries`` times on a respawned worker; a candidate
  that exhausts its attempts is *quarantined* — recorded as a
  :class:`~repro_torch.core.explorer.FailedCandidate` (``status: failed`` in
  manifests) instead of aborting the sweep;
* **journaled results** — :class:`SweepJournal` appends one fsync'd JSONL
  row per finished candidate, so ``sweep(..., resume=journal)`` skips
  completed work after a process kill;
* **cache write-back** — on completion each worker writes its persistent
  cache tier as an atomic per-worker shard, merged (and corruption-
  quarantined) by :func:`repro_torch.core.simulator.merge_cache_shards`;
* **per-incarnation channels** — each spawn gets a fresh task queue and a
  private result pipe.  A shared ``mp.Queue`` is *not* crash-safe: its
  writes happen on a feeder thread under a cross-process semaphore, and a
  worker SIGKILLed (or ``os._exit``-ing) mid-write leaves that semaphore
  acquired forever, silently wedging every other worker and every respawn
  sharing the channel — observed as cascading timeouts and spurious
  quarantines under chaos testing.  Private pipes make sends synchronous
  in the calling thread, scope any poisoned state to the incarnation that
  dies with it, and give the parent EOF as a prompt death signal.

The headline contract (tests/test_pool_robustness.py): results, rankings
and pruned reasons are **bit-identical to the serial sweep** — under any
injected :class:`~repro_torch.analysis.chaos.FaultPlan` schedule that doesn't
exhaust a candidate's retries.  The pool owns *execution* only; every
simulated number comes from the same ``_evaluate_one`` code path serial
sweeps run.

Not in charon-lint's R2 determinism scope: liveness math (timeouts,
heartbeat staleness, backoff deadlines) is wall-clock by nature — it uses
the sanctioned :func:`repro_torch.obs.clock.wall_s` epoch clock throughout so
worker-side timestamps remain comparable with the parent's.
"""
from __future__ import annotations

import atexit
import io
import os
import pickle
import queue as queue_mod
import signal
import threading
import time
import traceback
from collections import deque
from dataclasses import dataclass
from multiprocessing.connection import wait as _conn_wait

from repro_torch.core.explorer import FailedCandidate
from repro_torch.obs.clock import wall_s


@dataclass(frozen=True)
class RetryPolicy:
    """The per-candidate execution contract.

    ``max_retries`` is the number of *re*-attempts after the first try; a
    candidate is quarantined after ``max_retries + 1`` failed attempts.
    Backoff before attempt ``n`` is ``min(backoff_s * 2**(n-2),
    backoff_max_s)`` seconds.  ``timeout_s`` bounds one attempt's wall
    clock (measured from dispatch, so a worker stuck importing or hung
    mid-candidate both trip it).  A worker whose heartbeat goes silent for
    ``miss_heartbeats * heartbeat_s`` while a task is in flight is treated
    as dead even if the OS still reports the process alive."""
    max_retries: int = 2
    timeout_s: float = 120.0
    backoff_s: float = 0.05
    backoff_max_s: float = 2.0
    heartbeat_s: float = 0.25
    miss_heartbeats: int = 120

    def __post_init__(self):
        if self.max_retries < 0:
            raise ValueError("max_retries must be >= 0")
        if self.timeout_s <= 0 or self.heartbeat_s <= 0:
            raise ValueError("timeout_s and heartbeat_s must be positive")

    def backoff_for(self, attempt: int) -> float:
        """Seconds to wait before dispatching attempt ``attempt`` (>= 2)."""
        return min(self.backoff_s * 2.0 ** max(attempt - 2, 0),
                   self.backoff_max_s)


class CandidateFailedError(RuntimeError):
    """Raised by ``sweep(..., strict=True)`` when a candidate exhausts its
    execution contract: carries the :class:`FailedCandidate` record."""

    def __init__(self, failed: FailedCandidate):
        self.failed = failed
        super().__init__(
            f"candidate {getattr(failed.spec, 'json_hash', lambda: '?')()[:12]}"
            f" failed after {failed.attempts} attempt(s): {failed.reason}")


# --------------------------------------------------------------------------
# worker process
# --------------------------------------------------------------------------

def _worker_main(wid: int, seq: int, task_q, wconn, parent_pid: int,
                 heartbeat_s: float) -> None:
    """Worker loop: apply ``begin`` sweep configs, evaluate ``task``s with
    process-local simulators (kept warm across sweeps — the pool's point),
    answer ``flush`` with cache-stat deltas + persistent-cache shards.

    Robustness details: SIGINT is ignored (the parent owns Ctrl-C and
    shuts the pool down); a daemon heartbeat thread beats even while the
    main thread evaluates; the task-get timeout doubles as an orphan check
    (``getppid`` changes when the parent is SIGKILLed — exit instead of
    lingering).  Results go over ``wconn``, this incarnation's private
    pipe: ``Connection.send`` writes the whole frame synchronously in the
    calling thread (no feeder thread), so dying right after a send can
    never strand a half-written message, and dying mid-send poisons only
    a pipe that is discarded with this incarnation."""
    signal.signal(signal.SIGINT, signal.SIG_IGN)

    stop = threading.Event()
    send_lock = threading.Lock()            # beat + main thread share wconn

    def _send(msg) -> bool:
        try:
            with send_lock:
                wconn.send(msg)
            return True
        except (OSError, ValueError):
            return False                    # parent gone (or seat retired)

    def _beat() -> None:
        while not stop.is_set():
            if not _send(("hb", wid, seq, wall_s())):
                return                      # parent gone: let the loop exit
            stop.wait(heartbeat_s)

    threading.Thread(target=_beat, daemon=True).start()

    # the one-time heavy import (torch via the simulator stack); under
    # fork this is inherited from the parent and effectively free
    from repro_torch.core.backend.collectives import collective_memo_stats
    from repro_torch.api.sweep import (
        _evaluate_one, _merge_stats, _resolve_scenario,
    )
    from repro_torch.core.explorer import _stats_delta

    # simulators stay warm across sweeps, but only for the same (engine,
    # persist) configuration — a sweep pricing with a different engine or
    # cache dir must never reuse a simulator built for another
    sims_by_cfg: dict = {}
    sims: dict = {}
    stats0: dict = {}
    coll0: dict = {}
    cfg: dict = {}

    while True:
        if os.getppid() != parent_pid:
            os._exit(0)                     # orphaned by a killed parent
        try:
            msg = task_q.get(timeout=0.5)
        except queue_mod.Empty:
            continue
        kind = msg[0]
        if kind == "stop":
            stop.set()
            os._exit(0)
        if kind == "begin":
            _, engine, objective, scenario, persist, faults, shard_tag = msg
            cfg = {"engine": engine, "objective": objective,
                   "scenario": _resolve_scenario(objective, scenario),
                   "persist": persist, "faults": faults,
                   "shard_tag": shard_tag}
            sims = sims_by_cfg.setdefault((engine, persist), {})
            # warm sims carry counters from previous sweeps: re-baseline
            stats0 = {k: s.cache_stats() for k, s in sims.items()}
            coll0 = collective_memo_stats().as_dict()
            continue
        if kind == "task":
            _, task_id, idx, spec, cand, attempt = msg
            faults = cfg.get("faults")
            h = spec.json_hash()
            # injected crash: after "started" so the parent attributes the
            # death to this candidate exactly like a real mid-eval segfault
            if not _send(("started", wid, seq, task_id, wall_s())):
                os._exit(0)
            if faults is not None and faults.should(
                    "worker_crash", (h,), attempt):
                os._exit(137)
            if faults is not None and faults.should(
                    "worker_hang", (h,), attempt):
                time.sleep(faults.hang_s)   # parent's timeout kills us
            timings: list = []
            try:
                res = _evaluate_one(
                    idx, spec, cand, sims, stats0, cfg["engine"],
                    cfg["objective"], cfg["scenario"], cfg["persist"],
                    timings, faults=faults, attempt=attempt)
                if not _send(("done", wid, seq, task_id, idx, res,
                              timings)):
                    os._exit(0)
            except Exception as e:
                tb = traceback.format_exc(limit=8)
                if not _send(("failed", wid, seq, task_id, idx,
                              f"{type(e).__name__}: {e}", tb)):
                    os._exit(0)
            continue
        if kind == "flush":
            deltas = [_stats_delta(s.cache_stats(), stats0.get(k, {}))
                      for k, s in sims.items()]
            coll1 = collective_memo_stats().as_dict()
            coll = {k: coll1[k] - coll0.get(k, 0)
                    for k in ("hits", "misses")}
            shards: list = []
            faults = cfg.get("faults")
            if cfg.get("persist"):
                for s in sims.values():
                    p = s.save_cache_shard(cfg.get("shard_tag") or "sweep")
                    if p is None:
                        continue
                    if faults is not None and faults.should(
                            "cache_corrupt", (s.cache.persist_path.name,
                                              wid)):
                        from repro_torch.analysis.chaos import corrupt_shard
                        corrupt_shard(str(p))
                    shards.append((str(s.cache.persist_path), str(p)))
            if not _send(("flushed", wid, seq, _merge_stats(deltas), coll,
                          shards)):
                os._exit(0)


# --------------------------------------------------------------------------
# parent-side pool
# --------------------------------------------------------------------------

class _Task:
    __slots__ = ("task_id", "idx", "spec", "cand", "attempt", "dispatched",
                 "started")

    def __init__(self, task_id, idx, spec, cand):
        self.task_id = task_id
        self.idx = idx
        self.spec = spec
        self.cand = cand
        self.attempt = 1
        self.dispatched = 0.0
        self.started = 0.0


class _Slot:
    """One worker seat: a process (respawned in place on death), its task
    queue and result pipe, a monotonically increasing spawn ``seq``
    (stale-message guard), its parent-side pending work and in-flight
    task."""
    __slots__ = ("wid", "proc", "task_q", "rconn", "seq", "last_hb",
                 "inflight", "pending", "retry_at", "flushed")

    def __init__(self, wid: int):
        self.wid = wid
        self.proc = None
        self.task_q = None
        self.rconn = None                    # parent end of the result pipe
        self.seq = 0
        self.last_hb = 0.0
        self.inflight: _Task | None = None
        self.pending: deque = deque()
        self.retry_at = 0.0                  # backoff deadline for pending[0]
        self.flushed = None


class WorkerPool:
    """A crash-tolerant pool of long-lived sweep evaluation processes.

    Use :func:`get_pool` rather than constructing directly — reuse across
    ``sweep()`` calls is where the spawn/import amortization comes from.
    """

    def __init__(self, workers: int, mp_context: str | None = None,
                 heartbeat_s: float = 0.25):
        import multiprocessing as mp
        if workers < 1:
            raise ValueError("workers must be >= 1")
        self.workers = int(workers)
        self.context_name = mp_context or default_context()
        self.heartbeat_s = heartbeat_s
        self._ctx = mp.get_context(self.context_name)
        self._slots = [_Slot(i) for i in range(self.workers)]
        self._next_task_id = 0
        self._closed = False
        # re-sent to seats respawned mid-sweep; run() refreshes it
        self._begin_msg: tuple = ("begin", "analytical", "step_time", None,
                                  None, None, "sweep")
        for s in self._slots:
            self._spawn(s)

    # -------------------------------------------------- lifecycle
    @property
    def alive(self) -> bool:
        return not self._closed and any(
            s.proc is not None and s.proc.is_alive() for s in self._slots)

    def _spawn(self, slot: _Slot) -> None:
        """(Re)start a worker seat with fresh channels and a new seq.

        Both the task queue and the result pipe are **per-incarnation**: a
        worker killed mid-message (injected crash, timeout SIGKILL) can
        leave a shared multiprocessing channel's write/read semaphore
        permanently acquired — the holder's death never releases a POSIX
        semaphore — which would wedge every worker and every later
        incarnation on the same channel.  Rebuilding the channels at spawn
        means a poisoned lock dies with the incarnation that poisoned it.
        Any message still in flight from the previous incarnation is
        dropped by the seq guard (and can't even arrive once the old pipe
        is closed)."""
        slot.seq += 1
        slot.task_q = self._ctx.Queue()
        if slot.rconn is not None:
            try:
                slot.rconn.close()
            except OSError:
                pass
        rconn, wconn = self._ctx.Pipe(duplex=False)
        slot.rconn = rconn
        slot.last_hb = wall_s()
        slot.proc = self._ctx.Process(
            target=_worker_main,
            args=(slot.wid, slot.seq, slot.task_q, wconn,
                  os.getpid(), self.heartbeat_s),
            daemon=True, name=f"charon-sweep-w{slot.wid}")
        slot.proc.start()
        # drop the parent's copy of the write end: the child then holds the
        # only one, so its death (however abrupt) delivers EOF on rconn
        wconn.close()

    def _revive(self, slot: _Slot) -> None:
        """Respawn a dead seat mid-sweep: the fresh incarnation missed the
        sweep's ``begin``, so re-send it before any task."""
        if slot.proc is not None and slot.proc.is_alive():
            return
        self._spawn(slot)
        slot.task_q.put(self._begin_msg)

    def _kill(self, slot: _Slot) -> None:
        if slot.proc is not None and slot.proc.is_alive():
            slot.proc.kill()
            slot.proc.join(timeout=5.0)

    def shutdown(self) -> None:
        if self._closed:
            return
        self._closed = True
        for s in self._slots:
            try:
                s.task_q.put(("stop",))
            except Exception:
                pass
        deadline = wall_s() + 2.0
        for s in self._slots:
            if s.proc is not None:
                s.proc.join(timeout=max(deadline - wall_s(), 0.1))
                if s.proc.is_alive():
                    s.proc.kill()
            if s.rconn is not None:
                try:
                    s.rconn.close()
                except OSError:
                    pass
                s.rconn = None

    def _reset_all(self) -> None:
        """Abort path (strict failure): kill every worker and respawn fresh
        seats so queued/in-flight state can't leak into the next sweep."""
        for s in self._slots:
            self._kill(s)
            s.inflight = None
            s.pending.clear()
            self._spawn(s)
        self._drain(0.0)

    # -------------------------------------------------- run a sweep
    def run(self, shards: list, *, engine: str, objective: str, scenario,
            persist: str | None, faults=None, policy: RetryPolicy | None = None,
            strict: bool = False, shard_tag: str = "sweep",
            metrics=None, recorder=None, sweep_t0: float = 0.0,
            on_result=None, on_failed=None):
        """Evaluate pre-sharded ``(idx, spec, cand)`` triples.

        ``shards[k]`` seeds seat ``k``'s pending queue (trace-affinity
        layout from ``_shard_items`` — retries stay on the same seat, so a
        respawned worker rebuilds the same cache neighborhood).  Returns
        ``(results, failed, stats, coll, lanes, shard_files)`` where
        ``results`` is ``[(idx, EvalResult)]``, ``failed`` is
        ``[FailedCandidate]``, ``stats``/``coll`` are the merged cache-stat
        deltas, ``lanes`` maps seat -> timing rows and ``shard_files`` maps
        main cache path -> list of written shard paths."""
        if self._closed:
            raise RuntimeError("pool is shut down")
        policy = policy or RetryPolicy()
        self._begin_msg = ("begin", engine, objective, scenario, persist,
                           faults, shard_tag)
        for s in self._slots:
            s.inflight = None
            s.pending.clear()
            s.retry_at = 0.0
            s.flushed = None
            s.last_hb = wall_s()
            self._ensure_alive(s)
            s.task_q.put(self._begin_msg)
        for k, shard in enumerate(shards):
            seat = self._slots[k % self.workers]
            for idx, spec, cand in shard:
                self._next_task_id += 1
                seat.pending.append(_Task(self._next_task_id, idx, spec,
                                          cand))

        results: list = []
        failed: list = []
        lanes: dict[int, list] = {s.wid: [] for s in self._slots}

        def outstanding() -> bool:
            return any(s.pending or s.inflight for s in self._slots)

        try:
            while outstanding():
                self._dispatch_ready()
                self._drain(timeout=0.05, results=results, failed=failed,
                            lanes=lanes, policy=policy, strict=strict,
                            metrics=metrics, recorder=recorder,
                            sweep_t0=sweep_t0, on_result=on_result,
                            on_failed=on_failed)
                self._liveness_scan(policy, failed, strict, metrics,
                                    recorder, sweep_t0, on_failed)
        except BaseException:
            # strict failure or Ctrl-C mid-sweep: never leave tasks queued
            # on live workers — the next sweep would receive their results
            self._reset_all()
            raise

        stats, coll, shard_files = self._flush(policy, metrics)
        results.sort(key=lambda r: r[0])
        return results, failed, stats, coll, lanes, shard_files

    # -------------------------------------------------- internals
    def _ensure_alive(self, slot: _Slot) -> None:
        if slot.proc is None or not slot.proc.is_alive():
            self._spawn(slot)

    def _dispatch_ready(self) -> None:
        now = wall_s()
        for s in self._slots:
            if s.inflight is not None or not s.pending:
                continue
            if now < s.retry_at:
                continue                     # backoff window still open
            self._revive(s)                  # idle seat may have died
            task = s.pending.popleft()
            task.dispatched = wall_s()
            task.started = 0.0
            s.inflight = task
            s.task_q.put(("task", task.task_id, task.idx, task.spec,
                          task.cand, task.attempt))

    def _drain(self, timeout: float, results=None, failed=None, lanes=None,
               policy=None, strict=False, metrics=None, recorder=None,
               sweep_t0=0.0, on_result=None, on_failed=None) -> None:
        deadline = wall_s() + timeout
        while True:
            conns = {s.rconn: s for s in self._slots
                     if s.rconn is not None}
            if not conns:
                return                       # every seat dead: liveness
            budget = deadline - wall_s()     # scan will respawn them
            ready = _conn_wait(list(conns), timeout=max(budget, 0.0))
            if not ready:
                return
            for c in ready:
                slot = conns[c]
                try:
                    msg = c.recv()
                except (EOFError, OSError):
                    # the incarnation died (EOF on its private pipe); the
                    # liveness scan attributes the death and respawns
                    try:
                        c.close()
                    except OSError:
                        pass
                    if slot.rconn is c:
                        slot.rconn = None
                    continue
                kind, wid, seq = msg[0], msg[1], msg[2]
                if seq != slot.seq:
                    continue                 # stale incarnation: drop
                if kind == "hb":
                    slot.last_hb = msg[3]
                elif kind == "started":
                    if slot.inflight is not None and \
                            slot.inflight.task_id == msg[3]:
                        slot.inflight.started = wall_s()
                elif kind == "done":
                    _, _, _, task_id, idx, res, timings = msg
                    if slot.inflight is None or \
                            slot.inflight.task_id != task_id:
                        continue             # superseded attempt: drop
                    task = slot.inflight
                    slot.inflight = None
                    if results is not None:
                        results.append((idx, res))
                    if lanes is not None:
                        lanes[wid].extend(timings)
                    if on_result is not None:
                        on_result(res, task.attempt)
                    return  # a seat opened: dispatch before draining more
                elif kind == "failed":
                    _, _, _, task_id, idx, reason, tb = msg
                    if slot.inflight is None or \
                            slot.inflight.task_id != task_id:
                        continue
                    task = slot.inflight
                    slot.inflight = None
                    if metrics is not None:
                        metrics.inc("pool.candidate_errors")
                    self._retry_or_quarantine(
                        slot, task, reason, tb, policy, failed, strict,
                        metrics, recorder, sweep_t0, on_failed, kill=False)
                    return  # seat freed (retry queued or quarantined)
                elif kind == "flushed":
                    slot.flushed = msg[3:]
            if wall_s() >= deadline:
                return

    def _liveness_scan(self, policy: RetryPolicy, failed, strict,
                       metrics, recorder, sweep_t0, on_failed) -> None:
        now = wall_s()
        for s in self._slots:
            task = s.inflight
            if task is None:
                # an idle seat that died (e.g. injected crash raced the
                # result) just gets respawned lazily at next dispatch
                continue
            dead = s.proc is None or not s.proc.is_alive()
            t_ref = task.started or task.dispatched
            timed_out = now - t_ref > policy.timeout_s
            wedged = (not dead and
                      now - s.last_hb >
                      policy.miss_heartbeats * self.heartbeat_s)
            if not (dead or timed_out or wedged):
                continue
            reason = ("worker died" if dead else
                      f"timeout after {policy.timeout_s:.1f}s" if timed_out
                      else "heartbeat lost")
            if metrics is not None:
                metrics.inc("pool.worker_deaths" if dead
                            else "pool.timeouts")
            s.inflight = None
            self._retry_or_quarantine(
                s, task, reason, "", policy, failed, strict, metrics,
                recorder, sweep_t0, on_failed, kill=True)

    def _retry_or_quarantine(self, slot: _Slot, task: _Task, reason: str,
                             tb: str, policy: RetryPolicy, failed, strict,
                             metrics, recorder, sweep_t0, on_failed,
                             kill: bool) -> None:
        """One attempt failed: respawn the seat if needed, then either
        requeue the candidate (front of the same seat, after backoff) or
        quarantine it."""
        if kill:
            self._kill(slot)
            self._spawn(slot)
            if metrics is not None:
                metrics.inc("pool.respawns")
            # the fresh incarnation missed this sweep's begin
            slot.task_q.put(self._begin_msg)
        if recorder is not None and recorder.enabled:
            recorder.instant(
                "sweep", f"worker{slot.wid}",
                f"fault:cand{task.idx}", wall_s() - sweep_t0, cat="fault",
                args={"idx": task.idx, "attempt": task.attempt,
                      "reason": reason})
        if task.attempt <= policy.max_retries:
            task.attempt += 1
            slot.retry_at = wall_s() + policy.backoff_for(task.attempt)
            slot.pending.appendleft(task)
            if metrics is not None:
                metrics.inc("pool.retries")
            return
        rec = FailedCandidate(task.cand, task.spec, task.attempt, reason,
                              _compact_tb(tb))
        if metrics is not None:
            metrics.inc("pool.quarantined")
        if strict:
            raise CandidateFailedError(rec)
        if failed is not None:
            failed.append(rec)
        if on_failed is not None:
            on_failed(rec)

    def _flush(self, policy: RetryPolicy, metrics):
        """Collect per-worker cache-stat deltas and persistent-cache shard
        paths.  A worker that dies during flush forfeits its stats/shards
        (results are already safe in the parent) — never fatal."""
        for s in self._slots:
            if s.proc is not None and s.proc.is_alive():
                s.task_q.put(("flush",))
        deadline = wall_s() + policy.timeout_s
        while (any(s.flushed is None and s.proc is not None
                   and s.proc.is_alive() for s in self._slots)
               and wall_s() < deadline):
            self._drain(timeout=0.05)
        stats: dict = {}
        coll = {"hits": 0, "misses": 0}
        shard_files: dict[str, list] = {}
        for s in self._slots:
            if s.flushed is None:
                if metrics is not None:
                    metrics.inc("pool.flush_lost")
                continue
            wstats, wcoll, shards = s.flushed
            for layer, st in wstats.items():
                acc = stats.setdefault(layer, {"hits": 0, "misses": 0})
                acc["hits"] += st["hits"]
                acc["misses"] += st["misses"]
            for k in coll:
                coll[k] += wcoll.get(k, 0)
            for main, shard in shards:
                shard_files.setdefault(main, []).append(shard)
        return stats, coll, shard_files


def _compact_tb(tb: str, max_lines: int = 12) -> str:
    """Last frames only: enough to identify a poison candidate's failure
    site without shipping a whole traceback into manifests."""
    lines = tb.strip().splitlines()
    return "\n".join(lines[-max_lines:])


def default_context() -> str:
    """``fork`` where the platform offers it (workers inherit the parent's
    imported torch — near-zero startup), else ``spawn``.  A process that
    has initialised CUDA gets ``spawn`` too: CUDA state does not survive a
    fork, so a forked worker could never touch the card (the profiling
    engine measures there)."""
    import multiprocessing as mp

    import torch
    if torch.cuda.is_initialized():
        return "spawn"
    return "fork" if "fork" in mp.get_all_start_methods() else "spawn"


# --------------------------------------------------------------------------
# pool registry (the long-lived part)
# --------------------------------------------------------------------------

_POOLS: dict[tuple, WorkerPool] = {}


def get_pool(workers: int, mp_context: str | None = None) -> WorkerPool:
    """Process-wide singleton pool per (workers, context): the second
    ``sweep(workers=N)`` in a process reuses warm workers — no respawn, no
    re-import, warm per-worker simulator caches."""
    key = (int(workers), mp_context or default_context())
    pool = _POOLS.get(key)
    if pool is None or pool._closed:
        pool = WorkerPool(workers, mp_context=key[1])
        _POOLS[key] = pool
    return pool


def shutdown_pools() -> None:
    """Stop every registered pool (atexit hook; also useful in tests)."""
    for pool in _POOLS.values():
        pool.shutdown()
    _POOLS.clear()


atexit.register(shutdown_pools)


# --------------------------------------------------------------------------
# sweep journal: resumable execution
# --------------------------------------------------------------------------

class _JournalUnpickler(pickle.Unpickler):
    """Maps the JAX package's module paths onto this package's."""

    def find_class(self, module, name):
        if module == "repro" or module.startswith("repro."):
            module = "repro_torch" + module[len("repro"):]
        return super().find_class(module, name)


class SweepJournal:
    """Append-only JSONL record of per-candidate sweep outcomes.

    Line 1 is a header identifying the sweep (base spec hash, axes,
    objective, engine); every following line is one finished candidate:
    ``{"h": json_hash, "status": completed|pruned|failed, ...}`` with the
    full :class:`EvalResult` hex-pickled for completed/pruned rows.  Rows
    are flushed *and fsync'd* per append, so a SIGKILL loses at most the
    in-flight candidate; a torn final line (killed mid-write) is tolerated
    on load.  ``sweep(..., resume=path)`` injects the recorded results and
    skips their candidates; ``failed`` rows are re-attempted on resume (a
    resume is an explicit second chance for transient failures)."""

    KIND = "charon-sweep-journal"
    VERSION = 1

    def __init__(self, path: str, header: dict):
        import json
        self.path = str(path)
        self.rows: dict[str, dict] = {}
        full = {"kind": self.KIND, "version": self.VERSION, **header}
        if os.path.exists(self.path) and os.path.getsize(self.path):
            existing = self.load(self.path, expect=full)
            self.rows = existing
            self._f = open(self.path, "a")
        else:
            self._f = open(self.path, "w")
            self._write_line(json.dumps(full, sort_keys=True, default=str))

    @classmethod
    def load(cls, path: str, expect: dict | None = None) -> dict[str, dict]:
        """Read a journal into ``{json_hash: row}``.  Raises ``ValueError``
        when the header disagrees with ``expect`` (resuming a *different*
        sweep would silently mix results); tolerates one torn final line."""
        import json
        rows: dict[str, dict] = {}
        with open(path) as f:
            lines = f.read().splitlines()
        if not lines:
            raise ValueError(f"journal {path} is empty")
        header = json.loads(lines[0])
        if header.get("kind") != cls.KIND:
            raise ValueError(f"{path} is not a {cls.KIND} file")
        if expect is not None:
            mismatched = [k for k, v in expect.items()
                          if json.loads(json.dumps(header.get(k),
                                                   default=str))
                          != json.loads(json.dumps(v, default=str))]
            if mismatched:
                raise ValueError(
                    f"journal {path} belongs to a different sweep "
                    f"(mismatched: {', '.join(sorted(mismatched))}) — "
                    "remove it or pass a fresh journal path")
        for i, line in enumerate(lines[1:], start=2):
            if not line.strip():
                continue
            try:
                row = json.loads(line)
            except ValueError:
                if i == len(lines):
                    break                    # torn final line: SIGKILL race
                raise
            rows[row["h"]] = row
        return rows

    def _write_line(self, line: str) -> None:
        self._f.write(line + "\n")
        self._f.flush()
        os.fsync(self._f.fileno())

    def append_result(self, res) -> None:
        import json
        row = {"h": res.spec.json_hash(),
               "status": "pruned" if res.pruned else "completed",
               "res": pickle.dumps(res, protocol=pickle.HIGHEST_PROTOCOL
                                   ).hex()}
        self.rows[row["h"]] = row
        self._write_line(json.dumps(row))

    def append_failed(self, rec: FailedCandidate) -> None:
        import json
        row = {"h": rec.spec.json_hash(), "status": "failed",
               "attempts": rec.attempts, "reason": rec.reason,
               "tb": rec.traceback}
        self.rows[row["h"]] = row
        self._write_line(json.dumps(row))

    @staticmethod
    def result_from(row: dict):
        """Rehydrate a completed/pruned row's :class:`EvalResult`.  A row the
        JAX package wrote names its classes ``repro.…``; they load as this
        package's classes of the same path, so resuming such a journal never
        imports the other package."""
        return _JournalUnpickler(io.BytesIO(bytes.fromhex(row["res"]))).load()

    def close(self) -> None:
        self._f.close()
