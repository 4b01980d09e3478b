"""Declarative simulation specs — the single typed entry surface.

Charon's headline claim is a *unified* simulator; this module is the unified
*API*: one frozen, hashable :class:`SimSpec` describes any simulation —
training, prefill, decode, or request-level serving — as

    SimSpec(model, cluster, parallel, workload)

* :class:`Cluster` — where it runs (hardware spec or registry name, chip
  budget, pods, per-device memory limit),
* :class:`ParallelConfig` (re-used from ``core.passes.base``) — how the model
  is sharded,
* a workload variant — what one step (or one request trace) looks like:
  :class:`TrainWorkload` / :class:`PrefillWorkload` / :class:`DecodeWorkload`
  for steady-state step simulation, :class:`ServingWorkload` for the
  discrete-event request-level simulator.

Every spec component is frozen and hashable, so a ``SimSpec`` *is* a cache
key (the simulator's serving bucket and the sweep reuse-grouping key both use
it directly) and any field can be a sweep axis (see ``repro_torch.api.sweep``).

Entry points: ``Simulator.run(spec) -> Report`` and
``ServingSimulator.run(spec) -> ServingReport``.  The legacy kwargs surfaces
(``Simulator.simulate(...)``) survives as a thin shim that constructs a spec
and emits :class:`CharonDeprecationWarning`.

Specs hash as the reference's do: equal specs give the same ``json_hash`` in
both packages, so manifests and cache keys stay interchangeable.  One
default differs: ``Cluster.hardware`` is ``"h100_sxm"`` here.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import math
from dataclasses import dataclass, field
from typing import ClassVar

from repro_torch.configs.base import ModelConfig
from repro_torch.core.backend.hardware import HARDWARE, HardwareSpec, LinkDomain
from repro_torch.core.passes.base import ParallelConfig


class CharonDeprecationWarning(DeprecationWarning):
    """Emitted by the legacy kwargs shims.  Intra-repo code must use the
    spec API; tests and benchmarks escalate this warning to an error."""


# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class Cluster:
    """Where a simulation runs.

    ``hardware`` accepts a registry name (``"h100_sxm"``) or a
    :class:`HardwareSpec` instance; instances are normalized to their name
    for hashing/equality and kept for :meth:`resolve` (custom specs compare
    by name).  ``chips`` is the total chip budget a sweep distributes over
    data parallelism (0 = derived from the parallel config).  ``pods``
    defaults the parallel config's pod count when that is left at 1.
    ``memory_limit`` (bytes per device, 0 = unlimited) drives both the
    closed-form memory-fit pre-pruning and the post-simulation filter in
    sweeps.
    """
    hardware: str | HardwareSpec = "h100_sxm"
    chips: int = 0
    pods: int = 1
    memory_limit: float = 0.0
    # derived: a custom HardwareSpec handed in via ``hardware``.  Kept as an
    # init field so dataclasses.replace carries it through non-hardware
    # changes (chips/pods/memory_limit on a custom cluster), but dropped the
    # moment a replace renames ``hardware`` — a stale spec never survives.
    _custom: HardwareSpec | None = field(default=None, repr=False,
                                         compare=False)

    def __post_init__(self):
        if isinstance(self.hardware, HardwareSpec):
            object.__setattr__(self, "_custom", self.hardware)
            object.__setattr__(self, "hardware", self.hardware.name)
        elif self._custom is not None and self._custom.name != self.hardware:
            object.__setattr__(self, "_custom", None)
        if self._custom is None and self.hardware not in HARDWARE:
            raise KeyError(
                f"unknown hardware {self.hardware!r}; registry has "
                f"{sorted(HARDWARE)} (or pass a HardwareSpec instance)")

    def resolve(self) -> HardwareSpec:
        return self._custom or HARDWARE[self.hardware]


# ---------------------------------------------------------------------------
# Resilience spec types: fault processes, checkpoint pricing, and the
# resilience scenario itself.  Frozen and hashable like every other spec
# component, so ``workload.resilience.ckpt.interval_steps`` is a sweep axis
# and a seeded fault model participates in cache keys / manifests for free.

@dataclass(frozen=True)
class FaultModel:
    """Seeded MTBF fault process per component class.

    Each ``*_mtbf_s`` is the mean time between failures of *one* component
    of that class, in seconds of simulated wall time; ``0`` (or ``inf``)
    disables the class entirely.  Component failures are independent renewal
    processes — exponential inter-arrivals by default, or Weibull with shape
    ``weibull_shape`` (``k < 1`` front-loads infant mortality) scaled so the
    mean stays at the configured MTBF.  The whole failure trace is a pure
    function of ``seed`` + component counts: it is sampled in wall-clock
    time, independent of the checkpoint schedule, so interval sweeps replay
    the *same* failures.
    """
    chip_mtbf_s: float = 0.0
    host_mtbf_s: float = 0.0
    link_mtbf_s: float = 0.0
    dist: str = "exponential"       # exponential | weibull
    weibull_shape: float = 0.7
    seed: int = 0

    def __post_init__(self):
        if self.dist not in ("exponential", "weibull"):
            raise ValueError(
                f"fault dist {self.dist!r} not in ('exponential', 'weibull')")
        if self.dist == "weibull" and self.weibull_shape <= 0:
            raise ValueError("weibull_shape must be positive")
        for name in ("chip_mtbf_s", "host_mtbf_s", "link_mtbf_s"):
            if getattr(self, name) < 0:
                raise ValueError(f"{name} must be >= 0 (0 disables)")

    @property
    def active(self) -> bool:
        """True when any component class can actually fail."""
        return any(0 < m < math.inf for m in
                   (self.chip_mtbf_s, self.host_mtbf_s, self.link_mtbf_s))


@dataclass(frozen=True)
class CheckpointSpec:
    """How (and how often) training state is checkpointed.

    Save cost is priced from the memory report's per-device state bytes
    (weights + optimizer state) over ``write_gbps``; ``write_gbps = 0``
    derives the per-device write bandwidth from the cluster's inter-host
    link (``hw.inter.bandwidth``).  ``mode="sync"`` stalls the full save on
    the step boundary; ``mode="async"`` stalls only
    ``async_overhead x save_s`` (the device-to-host snapshot) and the
    checkpoint becomes *durable* ``save_s`` later — a failure while the
    write is in flight falls back to the previous durable checkpoint.
    ``restore_s = restore_factor x save_s``.
    """
    interval_steps: int = 0         # checkpoint every N steps; 0 = never
    mode: str = "sync"              # sync | async
    write_gbps: float = 0.0         # GB/s per device; 0 = derive from hw
    restore_factor: float = 1.0
    async_overhead: float = 0.05

    def __post_init__(self):
        if self.interval_steps < 0:
            raise ValueError("interval_steps must be >= 0 (0 = never)")
        if self.mode not in ("sync", "async"):
            raise ValueError(f"ckpt mode {self.mode!r} not in "
                             "('sync', 'async')")
        if self.write_gbps < 0 or self.restore_factor < 0:
            raise ValueError("write_gbps / restore_factor must be >= 0")
        if not 0 <= self.async_overhead <= 1:
            raise ValueError("async_overhead must be in [0, 1]")


@dataclass(frozen=True)
class ResilienceSpec:
    """A resilience scenario: run ``total_steps`` training steps against a
    seeded fault process, pricing checkpoints, restarts, elastic resharding
    and stragglers.  Attach to ``TrainWorkload.resilience`` and run through
    ``repro_torch.resilience.ResilienceSimulator`` — the plain step simulation is
    untouched (``resilience`` never reaches ``sim_kwargs``), so an inactive
    fault model reproduces the failure-free report bit-for-bit.

    ``chips_per_host`` maps the parallel config's chip count onto failure
    domains (a host failure takes all its chips).  ``spares`` are warm
    standby hosts consumed before the mesh degrades; with ``elastic`` the
    mesh then shrinks dp via ``ElasticPlan.rescale`` (re-priced through the
    step oracle), otherwise the run stalls until a repair completes
    (``repair_s`` per host).  Stragglers: each host each step is slowed by
    ``U(1, straggler_mult)`` with probability ``straggler_prob``; a
    gang-synchronized step costs the max over hosts.
    """
    total_steps: int = 1000
    faults: FaultModel = FaultModel()
    ckpt: CheckpointSpec = CheckpointSpec()
    chips_per_host: int = 8
    spares: int = 0
    elastic: bool = True
    restart_delay_s: float = 60.0   # detection + reschedule + re-init
    repair_s: float = 1800.0        # failed host returns as a spare after
    straggler_prob: float = 0.0     # per host, per step
    straggler_mult: float = 1.0     # max slowdown multiplier
    optimize_interval: bool = True  # also replay a grid around Young/Daly
    max_wall_factor: float = 1000.0  # divergence guard (x ideal wall time)

    def __post_init__(self):
        if self.total_steps < 1:
            raise ValueError("total_steps must be >= 1")
        if self.chips_per_host < 1:
            raise ValueError("chips_per_host must be >= 1")
        if self.spares < 0:
            raise ValueError("spares must be >= 0")
        if not 0 <= self.straggler_prob <= 1:
            raise ValueError("straggler_prob must be in [0, 1]")
        if self.straggler_mult < 1:
            raise ValueError("straggler_mult must be >= 1")
        if self.restart_delay_s < 0 or self.repair_s < 0:
            raise ValueError("restart_delay_s / repair_s must be >= 0")


# ---------------------------------------------------------------------------
# Workload variants.  ``mode`` is a real (init=False) field so it survives
# ``dataclasses.asdict`` round-trips and discriminates reconstruction.

@dataclass(frozen=True)
class _StepWorkload:
    """Shared shape of one steady-state simulated step."""
    global_batch: int = 8
    seq_len: int = 2048
    cache_len: int = 0              # 0 -> seq_len where a KV cache exists
    fusion: bool = False
    quantize: str | None = None     # None | "int8" | "f8" (QuantizePass)

    def sim_kwargs(self) -> dict:
        """The exact legacy ``Simulator.simulate`` kwargs this spec means —
        the one translation point between the spec and kwargs surfaces."""
        return dict(mode=self.mode, global_batch=self.global_batch,
                    seq_len=self.seq_len, cache_len=self.cache_len,
                    fusion=self.fusion, quantize=self.quantize,
                    remat=getattr(self, "remat", "none"),
                    optimizer=getattr(self, "optimizer", "adamw"))


@dataclass(frozen=True)
class TrainWorkload(_StepWorkload):
    mode: str = field(default="train", init=False)
    remat: str = "block"            # none | block | dots
    optimizer: str = "adamw"        # adamw | adafactor
    # resilience scenario (None = plain failure-free step simulation).
    # Deliberately excluded from sim_kwargs(): step pricing is identical
    # with or without it, only ResilienceSimulator consumes it.
    resilience: ResilienceSpec | None = None


@dataclass(frozen=True)
class PrefillWorkload(_StepWorkload):
    mode: str = field(default="prefill", init=False)


@dataclass(frozen=True)
class DecodeWorkload(_StepWorkload):
    """One decode iteration: ``global_batch`` sequences at context
    ``seq_len`` (``cache_len`` overrides the KV-cache depth)."""
    mode: str = field(default="decode", init=False)


# ---------------------------------------------------------------------------
# Fleet spec types: replica pools, routing, autoscaling — frozen and hashable
# like every other spec component, so ``workload.fleet.replicas`` is a sweep
# axis and a fleet spec participates in cache keys / manifests for free.

@dataclass(frozen=True)
class RouterSpec:
    """Which replica an arriving request lands on.

    ``kind``: ``round_robin`` (arrival order — with a fixed fleet this is
    exactly ``Workload.shard``), ``least_loaded`` (fewest in-flight
    requests), or ``session_affinity`` (rendezvous-hash requests of one
    session onto one replica, keeping its prompt prefix warm in that
    replica's cache; sessionless requests use ``fallback``).
    """
    kind: str = "round_robin"
    fallback: str = "least_loaded"  # session_affinity's sessionless policy

    def __post_init__(self):
        kinds = ("round_robin", "least_loaded", "session_affinity")
        if self.kind not in kinds:
            raise ValueError(f"router kind {self.kind!r} not in {kinds}")
        if self.fallback not in kinds or self.fallback == "session_affinity":
            raise ValueError(
                f"router fallback {self.fallback!r} must be one of "
                "('round_robin', 'least_loaded')")


@dataclass(frozen=True)
class AutoscalerSpec:
    """Queue-depth autoscaling with hysteresis.

    Every ``interval_s`` of simulated time the mean in-flight depth over
    active replicas is sampled; above ``scale_up_queue`` a standby replica
    activates (taking traffic ``provision_s`` later), below
    ``scale_down_queue`` the least-loaded active replica deactivates (it
    drains what it holds, so no request is ever dropped).  The up/down gap
    plus ``cooldown_s`` between actions is the hysteresis.
    """
    min_replicas: int = 1
    max_replicas: int = 8
    scale_up_queue: float = 8.0
    scale_down_queue: float = 1.0
    interval_s: float = 2.0
    cooldown_s: float = 4.0
    provision_s: float = 5.0

    def __post_init__(self):
        if not 1 <= self.min_replicas <= self.max_replicas:
            raise ValueError(
                f"need 1 <= min_replicas={self.min_replicas} <= "
                f"max_replicas={self.max_replicas}")
        if self.scale_down_queue >= self.scale_up_queue:
            raise ValueError(
                f"scale_down_queue={self.scale_down_queue} must be below "
                f"scale_up_queue={self.scale_up_queue} (the hysteresis gap)")
        if self.interval_s <= 0:
            raise ValueError("interval_s must be positive")


@dataclass(frozen=True)
class ReplicaFaultSpec:
    """Seeded whole-replica failure injection for the fleet simulator.

    Each replica fails as an independent renewal process with mean
    ``mtbf_s`` (``0``/``inf`` disables) and recovers ``restart_s`` later.
    On failure the replica's in-flight and queued requests are rerouted
    through the fleet router (progress on the failed replica is lost — the
    requests re-prefill elsewhere); the autoscaler never activates a
    replica that is currently down.  The trace is a pure function of
    ``seed`` + replica index, so reports are bit-deterministic.
    """
    mtbf_s: float = 0.0
    restart_s: float = 30.0
    dist: str = "exponential"       # exponential | weibull
    weibull_shape: float = 0.7
    seed: int = 0

    def __post_init__(self):
        if self.mtbf_s < 0:
            raise ValueError("mtbf_s must be >= 0 (0 disables)")
        if self.restart_s < 0:
            raise ValueError("restart_s must be >= 0")
        if self.dist not in ("exponential", "weibull"):
            raise ValueError(
                f"fault dist {self.dist!r} not in ('exponential', 'weibull')")
        if self.dist == "weibull" and self.weibull_shape <= 0:
            raise ValueError("weibull_shape must be positive")

    @property
    def active(self) -> bool:
        return 0 < self.mtbf_s < math.inf


@dataclass(frozen=True)
class FleetSpec:
    """A replica fleet: how many engine instances, routed and scaled how.

    ``replicas`` engine instances run the workload's policy behind
    ``router``; a non-None ``autoscaler`` turns ``replicas`` into the
    *initial* active count (clamped to its [min, max]) with standbys up to
    ``max_replicas``.  ``prefill_replicas > 0`` disaggregates at the fleet
    level: arrivals prefill on that many dedicated prefill replicas
    (admission ``prefill_batch``), then migrate — paying ``transfer_s`` of
    KV-transfer latency — to the least-loaded decode replica.

    The default is :meth:`trivial`: exactly the single-replica simulator,
    so every existing serving spec is already a fleet spec.
    """
    replicas: int = 1
    router: RouterSpec = RouterSpec()
    autoscaler: AutoscalerSpec | None = None
    prefill_replicas: int = 0
    prefill_batch: int = 4
    transfer_s: float = 0.002
    faults: ReplicaFaultSpec | None = None

    def __post_init__(self):
        if self.replicas < 1:
            raise ValueError(f"replicas must be >= 1, got {self.replicas}")
        if self.prefill_replicas < 0:
            raise ValueError("prefill_replicas must be >= 0")
        if self.prefill_replicas > 0 and self.prefill_batch < 1:
            raise ValueError("prefill_batch must be >= 1")

    @property
    def trivial(self) -> bool:
        """True when this fleet is exactly one plain replica — the single-
        replica event loop handles it without the fleet layer."""
        return (self.replicas == 1 and self.prefill_replicas == 0
                and self.autoscaler is None and self.faults is None)


def _default_prompt():
    from repro_torch.serving.sim.workload import LengthDist
    return LengthDist("lognormal", median=512.0, sigma=0.7, cap=4096)


def _default_output():
    from repro_torch.serving.sim.workload import LengthDist
    return LengthDist("lognormal", median=128.0, sigma=0.7, cap=1024)


def _default_slo():
    from repro_torch.serving.sim.report import SLO
    return SLO()


@dataclass(frozen=True)
class ServingWorkload:
    """A request-level trace spec for the discrete-event serving simulator.

    Carries the arrival process, length distributions, SLO and batching
    policy in frozen hashable form — the trace itself is synthesized
    deterministically from ``seed`` by :meth:`build` (or replayed from
    ``trace`` rows when given).  ``max_batch`` is the policy's admission
    cap; in goodput sweeps the candidate's per-replica batch overrides it.
    """
    mode: str = field(default="serving", init=False)
    n_requests: int = 200
    arrival: str = "poisson"        # poisson | uniform | bursty
                                    # | diurnal | flash_crowd
    rate_rps: float = 8.0
    burst_factor: float = 4.0
    switch_prob: float = 0.1
    period_s: float = 600.0         # diurnal: one day, compressed
    diurnal_amp: float = 0.8        # diurnal: rate swings rate*(1 +/- amp)
    flash_start_s: float = 60.0     # flash_crowd: spike onset
    flash_dur_s: float = 30.0       # flash_crowd: spike duration
    flash_mult: float = 8.0         # flash_crowd: rate multiplier in spike
    sessions: int = 0               # >0: tag requests with session ids
    prompt: object = field(default_factory=_default_prompt)    # LengthDist
    output: object = field(default_factory=_default_output)    # LengthDist
    seed: int = 0
    trace: tuple = ()               # ((arrival_s, prompt, output), ...) rows
    slo: object = field(default_factory=_default_slo)          # SLO
    policy: str = "continuous"      # continuous | chunked | static
    max_batch: int = 32
    token_budget: int = 256         # chunked-prefill budget
    ctx_floor: int = 256            # oracle context-bucket floor
    fleet: FleetSpec = FleetSpec()  # replica pool / router / autoscaler

    def build(self):
        """Materialize the deterministic request trace (a ``Workload``)."""
        from repro_torch.serving.sim.workload import Workload, synthesize
        if self.trace:
            return Workload.from_trace(self.trace)
        return synthesize(self.n_requests, arrival=self.arrival,
                          rate_rps=self.rate_rps,
                          burst_factor=self.burst_factor,
                          switch_prob=self.switch_prob,
                          period_s=self.period_s,
                          diurnal_amp=self.diurnal_amp,
                          flash_start_s=self.flash_start_s,
                          flash_dur_s=self.flash_dur_s,
                          flash_mult=self.flash_mult,
                          sessions=self.sessions, prompt=self.prompt,
                          output=self.output, seed=self.seed)

    def make_policy(self, max_batch: int | None = None):
        from repro_torch.serving.sim.policies import make_policy
        return make_policy(self.policy, max_batch or self.max_batch,
                           token_budget=self.token_budget)

    def scenario(self):
        """The explorer-facing view: a :class:`ServingScenario` whose
        per-candidate admission cap is the candidate's replica batch."""
        from repro_torch.serving.sim.sim import ServingScenario
        return ServingScenario(self.build(), slo=self.slo, policy=self.policy,
                               token_budget=self.token_budget,
                               ctx_floor=self.ctx_floor,
                               fleet=None if self.fleet.trivial
                               else self.fleet)


STEP_WORKLOADS = {"train": TrainWorkload, "prefill": PrefillWorkload,
                  "decode": DecodeWorkload}


# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class SimSpec:
    """One fully-specified simulation.  Frozen and hashable: equal specs
    mean bit-identical simulations, so a spec can serve as a cache key."""
    model: ModelConfig
    cluster: Cluster = Cluster()
    parallel: ParallelConfig = field(default_factory=ParallelConfig)
    workload: object = field(default_factory=TrainWorkload)

    def __post_init__(self):
        # a pods-bearing cluster defaults the parallel config's pod count
        if self.cluster.pods > 1 and self.parallel.pods == 1:
            object.__setattr__(self, "parallel", dataclasses.replace(
                self.parallel, pods=self.cluster.pods))
        elif self.cluster.pods > 1 and self.parallel.pods != self.cluster.pods:
            raise ValueError(
                f"cluster.pods={self.cluster.pods} conflicts with "
                f"parallel.pods={self.parallel.pods}")

    def __hash__(self):
        # memoized: specs are cache keys on hot paths (the serving oracle
        # probes the SimCache once per engine step) and every component is
        # immutable by contract, so the nested hash is computed once
        h = getattr(self, "_hash", None)
        if h is None:
            h = hash((self.model, self.cluster, self.parallel, self.workload))
            object.__setattr__(self, "_hash", h)
        return h

    def __getstate__(self):
        # string hashes are salted per process: a pickled memo would poison
        # dict lookups in the loading process (persistent SimCache tier)
        d = dict(self.__dict__)
        d.pop("_hash", None)
        return d

    # ------------------------------------------------------------------
    @property
    def mode(self) -> str:
        return self.workload.mode

    def B_local(self) -> int:
        """Per-replica batch after the data-parallel split.  Serving specs
        have no global batch; the policy's admission cap plays that role."""
        if self.mode == "serving":
            return self.workload.max_batch
        dp = max(self.parallel.dp * self.parallel.pods, 1)
        return max(self.workload.global_batch // dp, 1)

    def trace_shapes(self) -> tuple:
        """``(B_local, seq, cache)`` as the simulator's ingest stage sees
        them — the shape part of the traced-graph identity.  Single source
        of truth for :meth:`reuse_key` and the sweep's worker sharding
        (``api/sweep.py``'s ``_shard_items`` in the reference): the two must agree or workers
        duplicate ingest traces.  A serving spec prices many bucketed shapes
        through its oracle; the admission cap and context floor bound that
        bucket family, so they stand in as its shape identity."""
        w = self.workload
        if w.mode == "serving":
            return (w.max_batch, w.ctx_floor, -1)
        seq = w.seq_len if w.mode != "decode" else 1
        cache = w.cache_len or (w.seq_len if w.mode == "decode" else 0)
        return (self.B_local(), seq, cache)

    def reuse_key(self) -> tuple:
        """Specs with equal reuse keys share traced/transformed/priced block
        graphs inside one simulator — the sweep sorts candidates by this key
        so each group pays the expensive stages once (``shard_key`` leads so
        legacy tp/pp/batch sweeps keep their historical evaluation order)."""
        w = self.workload
        remat = getattr(w, "remat", "none") if w.mode == "train" else "none"
        return (self.cluster.hardware, self.model.name, w.mode,
                self.parallel.shard_key()) + self.trace_shapes() + (
                getattr(w, "fusion", False), getattr(w, "quantize", None)
                or "", remat)

    # ------------------------------------------------------------------
    def asdict(self) -> dict:
        """Nested plain-dict form (tuples preserved); inverse of
        :meth:`from_dict`."""
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "SimSpec":
        cl = dict(d["cluster"])
        custom = cl.pop("_custom", None)
        if custom is not None:          # non-registry hardware: rebuild it
            custom = dict(custom)
            custom["intra"] = LinkDomain(**custom["intra"])
            custom["inter"] = LinkDomain(**custom["inter"])
            cl["hardware"] = HardwareSpec(**custom)
        w = dict(d["workload"])
        mode = w.pop("mode")
        if mode == "serving":
            from repro_torch.serving.sim.report import SLO
            from repro_torch.serving.sim.workload import LengthDist
            w["prompt"] = LengthDist(**w["prompt"])
            w["output"] = LengthDist(**w["output"])
            w["slo"] = SLO(**w["slo"])
            fl = dict(w.get("fleet") or {})
            if fl:
                fl["router"] = RouterSpec(**fl.get("router", {}))
                scaler = fl.get("autoscaler")
                fl["autoscaler"] = (AutoscalerSpec(**scaler)
                                    if scaler is not None else None)
                faults = fl.get("faults")
                fl["faults"] = (ReplicaFaultSpec(**faults)
                                if faults is not None else None)
                w["fleet"] = FleetSpec(**fl)
            workload = ServingWorkload(**w)
        else:
            res = w.get("resilience")
            if res is not None:
                res = dict(res)
                res["faults"] = FaultModel(**res["faults"])
                res["ckpt"] = CheckpointSpec(**res["ckpt"])
                w["resilience"] = ResilienceSpec(**res)
            workload = STEP_WORKLOADS[mode](**w)
        return cls(model=ModelConfig(**d["model"]), cluster=Cluster(**cl),
                   parallel=ParallelConfig(**d["parallel"]),
                   workload=workload)

    # ------------------------------------------------------------------
    def to_json(self) -> str:
        """Stable JSON form: sorted keys, compact separators, tuples as
        arrays.  ``from_json(to_json())`` rebuilds an equal spec with an
        equal hash, so the string (and :meth:`json_hash`) can serve as a
        cross-process cache key, a sweep-manifest row, or a result
        provenance record."""
        return json.dumps(self.asdict(), sort_keys=True,
                          separators=(",", ":"))

    def json_hash(self) -> str:
        """sha256 hex digest of :meth:`to_json` — the persistent SimCache's
        report key (stable across processes, unlike ``hash()``)."""
        return hashlib.sha256(self.to_json().encode()).hexdigest()

    @classmethod
    def from_json(cls, s: str) -> "SimSpec":
        """Inverse of :meth:`to_json` (hash-preserving round trip)."""
        d = json.loads(s)
        # JSON has no tuples: restore the fields whose types (and therefore
        # the spec's hash) depend on them
        m = d.get("model", {})
        if "block_pattern" in m:
            m["block_pattern"] = tuple(m["block_pattern"])
        w = d.get("workload", {})
        if "trace" in w:
            w["trace"] = tuple(tuple(row) for row in w["trace"])
        return cls.from_dict(d)

    @staticmethod
    def from_legacy(cfg: ModelConfig, hw, *, mode: str = "train",
                    global_batch: int = 8, seq_len: int = 2048,
                    par: ParallelConfig | None = None, remat: str = "block",
                    optimizer: str = "adamw", fusion: bool = False,
                    quantize: str | None = None,
                    cache_len: int = 0) -> "SimSpec":
        """Translate the legacy ``simulate()`` kwargs surface into a spec.

        ``remat``/``optimizer`` only shape train workloads — for prefill and
        decode the legacy simulator never consumed them (no RecomputePass,
        no optimizer step), so dropping them preserves bit-identity.
        """
        kw = dict(global_batch=global_batch, seq_len=seq_len,
                  cache_len=cache_len, fusion=fusion, quantize=quantize)
        if mode == "train":
            kw.update(remat=remat, optimizer=optimizer)
        return SimSpec(model=cfg, cluster=Cluster(hw),
                       parallel=par or ParallelConfig(),
                       workload=STEP_WORKLOADS[mode](**kw))
