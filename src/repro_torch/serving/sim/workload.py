"""Request workloads for the serving simulator (synthetic + trace replay).

Every stochastic choice flows through a single ``random.Random(seed)``
instance, so a (spec, seed) pair always synthesizes the same trace — the
property the conservation/memoization tests and A/B policy comparisons rely
on.  The module also provides the clocks shared with ``serving.engine``:
the real :class:`~repro_torch.serving.engine.ServingEngine` timestamps requests
through an injected clock, and trace replay passes a :class:`VirtualClock`
driven in simulated seconds so a caller-supplied ``arrival_s`` of ``0.0``
is preserved exactly instead of being silently replaced by wall-clock time.
"""
from __future__ import annotations

import math
import random
import time
from dataclasses import dataclass, replace


class VirtualClock:
    """Monotone simulated-seconds clock, callable like ``time.perf_counter``."""

    def __init__(self, start: float = 0.0):
        self._now = float(start)

    def __call__(self) -> float:
        return self._now

    def advance_to(self, t: float) -> None:
        if t < self._now:
            raise ValueError(f"clock moving backwards: {t} < {self._now}")
        self._now = float(t)


def wall_clock() -> float:
    """Default real-time clock (so callers never reach for ``time`` directly)."""
    return time.perf_counter()


@dataclass
class SimRequest:
    """One request flowing through the discrete-event simulator.

    Progress fields are mutated by the event loop; ``ServingSimulator.run``
    operates on reset copies so a :class:`Workload` can be replayed through
    any number of policies/candidates.  ``session`` (-1 = sessionless)
    groups requests that share a conversation prefix — the fleet router's
    session-affinity policy keeps a session on one replica so its prefix
    stays in that replica's cache.
    """
    rid: int
    arrival_s: float
    prompt_len: int
    output_len: int
    session: int = -1
    # progress (mutated by the event loop)
    prefilled: int = 0
    decoded: int = 0
    # timestamps (simulated seconds)
    enqueue_s: float | None = None      # entered the current pool's queue
    start_s: float | None = None        # first scheduled into an engine step
    first_token_s: float | None = None
    finished_s: float | None = None

    @property
    def done(self) -> bool:
        return self.finished_s is not None

    @property
    def ttft_s(self) -> float:
        return self.first_token_s - self.arrival_s

    @property
    def tpot_ms(self) -> float:
        if self.output_len <= 1:
            return 0.0
        return (self.finished_s - self.first_token_s) / (self.output_len - 1) * 1e3

    @property
    def e2e_s(self) -> float:
        return self.finished_s - self.arrival_s

    @property
    def queue_delay_s(self) -> float:
        return self.start_s - self.arrival_s

    def reset_copy(self) -> "SimRequest":
        return replace(self, prefilled=0, decoded=0, enqueue_s=None,
                       start_s=None, first_token_s=None, finished_s=None)


@dataclass(frozen=True)
class LengthDist:
    """Token-length distribution: ``fixed`` | ``uniform`` | ``lognormal``.

    ``lognormal`` is the production shape (heavy right tail of long prompts);
    ``median`` is the log-space location and ``sigma`` the log-space spread.
    Samples are clamped to ``[1, cap]``.
    """
    kind: str = "fixed"
    value: int = 512                # fixed
    lo: int = 1                     # uniform
    hi: int = 1024
    median: float = 512.0           # lognormal
    sigma: float = 0.6
    cap: int = 8192

    def sample(self, rng: random.Random) -> int:
        if self.kind == "fixed":
            n = self.value
        elif self.kind == "uniform":
            n = rng.randint(self.lo, self.hi)
        elif self.kind == "lognormal":
            n = int(round(self.median * math.exp(rng.gauss(0.0, self.sigma))))
        else:
            raise ValueError(f"unknown length distribution {self.kind!r}")
        return max(1, min(n, self.cap))


@dataclass
class Workload:
    """An arrival-ordered request trace (immutable by convention: the
    simulator runs on reset copies, never on these instances)."""
    requests: list[SimRequest]

    @property
    def n_requests(self) -> int:
        return len(self.requests)

    @property
    def prompt_tokens(self) -> int:
        return sum(r.prompt_len for r in self.requests)

    @property
    def output_tokens(self) -> int:
        return sum(r.output_len for r in self.requests)

    @property
    def duration_s(self) -> float:
        if not self.requests:
            return 0.0
        return self.requests[-1].arrival_s - self.requests[0].arrival_s

    @staticmethod
    def from_trace(rows) -> "Workload":
        """Trace replay: ``rows`` is an iterable of
        ``(arrival_s, prompt_len, output_len)`` (any order; re-sorted)."""
        rows = sorted(rows, key=lambda r: float(r[0]))
        return Workload([
            SimRequest(rid=i, arrival_s=float(a), prompt_len=max(int(p), 1),
                       output_len=max(int(o), 1))
            for i, (a, p, o) in enumerate(rows)])

    def shard(self, k: int, offset: int = 0) -> "Workload":
        """Every ``k``-th request (deterministic round-robin split) — one
        replica's share of a round-robin split over ``k`` identical
        replicas.  This is exactly what a round-robin fleet router delivers
        to replica ``offset``, which is how the explorer's goodput objective
        turns a system-level workload into a per-replica one (and what the
        shim↔spec bit-identity tests assert)."""
        if k <= 1:
            return Workload([r.reset_copy() for r in self.requests])
        return Workload([r.reset_copy()
                         for r in self.requests[offset % k::k]])

    def thin(self, k: int, offset: int = 0) -> "Workload":
        """Deprecated replica-thinning knob: describe the replica split with
        :class:`~repro_torch.api.spec.FleetSpec` (``ServingWorkload(fleet=
        FleetSpec(replicas=k))``) and let the fleet simulator route the
        stream, or call :meth:`shard` for the raw per-replica share."""
        import warnings

        from repro_torch.api.spec import CharonDeprecationWarning
        warnings.warn(
            "Workload.thin(k) is deprecated; use FleetSpec(replicas=k) on a "
            "ServingWorkload (see docs/serving.md) or Workload.shard(k) for "
            "the raw round-robin share", CharonDeprecationWarning,
            stacklevel=2)
        return self.shard(k, offset)


def synthesize(n: int, *, arrival: str = "poisson", rate_rps: float = 8.0,
               burst_factor: float = 4.0, switch_prob: float = 0.1,
               period_s: float = 600.0, diurnal_amp: float = 0.8,
               flash_start_s: float = 60.0, flash_dur_s: float = 30.0,
               flash_mult: float = 8.0, sessions: int = 0,
               prompt: LengthDist = LengthDist("lognormal", median=512.0,
                                               sigma=0.7, cap=4096),
               output: LengthDist = LengthDist("lognormal", median=128.0,
                                               sigma=0.7, cap=1024),
               seed: int = 0, start_s: float = 0.0) -> Workload:
    """Synthesize a deterministic ``n``-request workload.

    ``arrival``:
      * ``poisson``      — exponential interarrivals at ``rate_rps``.
      * ``uniform``      — evenly spaced at ``1/rate_rps``.
      * ``bursty``       — two-regime modulated Poisson: the rate alternates
        between ``rate_rps * burst_factor`` (burst) and
        ``rate_rps / burst_factor`` (lull); the regime flips with
        probability ``switch_prob`` per arrival (sticky bursts).  The mean
        rate is of order ``rate_rps`` but not exactly it — this is a shape
        knob, not a calibrated trace.
      * ``diurnal``      — non-homogeneous Poisson with a sinusoidal rate
        ``rate_rps * (1 + diurnal_amp * sin(2πt / period_s))`` (Lewis-
        Shedler thinning against the peak rate): the traffic shape an
        autoscaler earns its keep on.
      * ``flash_crowd``  — base Poisson at ``rate_rps`` with a
        ``flash_mult``× spike during ``[flash_start_s, flash_start_s +
        flash_dur_s)`` (thinning again) — the scale-up stress case.

    ``sessions > 0`` tags every request with a session id drawn uniformly
    from ``range(sessions)`` (multi-turn users); ``sessions = 0`` leaves
    requests sessionless and the rng stream identical to earlier versions.
    """
    rng = random.Random(seed)
    t = float(start_s)
    in_burst = False

    if arrival == "diurnal":
        amp = min(max(float(diurnal_amp), 0.0), 1.0)
        peak = rate_rps * (1.0 + amp)
        two_pi = 2.0 * math.pi

        def rate_at(ts: float) -> float:
            return rate_rps * (1.0 + amp * math.sin(two_pi * ts / period_s))
    elif arrival == "flash_crowd":
        peak = rate_rps * max(float(flash_mult), 1.0)
        flash_end = flash_start_s + flash_dur_s

        def rate_at(ts: float) -> float:
            return peak if flash_start_s <= ts < flash_end else rate_rps
    else:
        peak = rate_at = None

    reqs = []
    for i in range(n):
        if arrival == "poisson":
            t += rng.expovariate(rate_rps)
        elif arrival == "uniform":
            t += 1.0 / rate_rps
        elif arrival == "bursty":
            if rng.random() < switch_prob:
                in_burst = not in_burst
            r = rate_rps * (burst_factor if in_burst else 1.0 / burst_factor)
            t += rng.expovariate(r)
        elif rate_at is not None:
            # thinning: candidate points at the peak rate, accepted with
            # probability rate(t)/peak — exact for any bounded rate function
            while True:
                t += rng.expovariate(peak)
                if rng.random() * peak <= rate_at(t):
                    break
        else:
            raise ValueError(f"unknown arrival process {arrival!r}")
        req = SimRequest(rid=i, arrival_s=t, prompt_len=prompt.sample(rng),
                         output_len=output.sample(rng))
        if sessions > 0:
            req.session = rng.randrange(sessions)
        reqs.append(req)
    return Workload(reqs)
