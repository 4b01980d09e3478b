"""Resilience report: goodput, lost-work breakdown, optimal intervals."""
from __future__ import annotations

from dataclasses import dataclass, field

from repro_torch.core.simulator import Report
from repro_torch.resilience.faults import FailureEvent


@dataclass
class ResilienceReport:
    """What a training run costs under failures.

    Wall-time accounting identity (asserted in tests)::

        wall_s == useful_s + rework_s + straggler_s
                  + checkpoint_s + downtime_s

    * ``useful_s`` — base step time of steps that survived to the end
      (covered by a durable checkpoint or by final completion).
    * ``rework_s`` — step time wiped by a failure and replayed (includes
      the partial step cut short by the failure itself).
    * ``straggler_s`` — slowdown excess of completed steps over their base
      cost (kept *and* later-reworked steps both count here).
    * ``checkpoint_s`` — save stalls (full save when sync; the snapshot
      fraction when async).
    * ``downtime_s`` — restart delay + checkpoint restore + any wait for
      repairs when the mesh cannot run.

    ``goodput`` is ``useful_s / wall_s`` — the fraction of wall-clock the
    cluster spent on steps that counted.  ``step_report`` is the
    failure-free :class:`~repro_torch.core.simulator.Report` for the full mesh —
    bit-identical to ``Simulator.run`` on the same spec without
    ``resilience``.
    """
    # headline
    goodput: float
    wall_s: float
    ideal_s: float                  # total_steps x failure-free step time
    completed: bool                 # False if the divergence guard tripped
    steps_done: int
    total_steps: int
    useful_tokens: float
    tokens_per_s: float             # useful tokens over wall time
    # breakdown (sums to wall_s)
    useful_s: float
    rework_s: float
    straggler_s: float
    checkpoint_s: float
    downtime_s: float
    # failure / recovery counters
    n_failures: dict[str, int]
    n_restarts: int
    n_checkpoints: int
    n_spare_swaps: int
    n_reshards: int
    degraded_steps: int
    # checkpoint pricing inputs
    state_bytes_per_device: float
    write_gbps: float
    save_s: float
    restore_s: float
    interval_steps: int
    # optimal-interval analysis
    mtbf_system_s: float            # 1 / sum of component failure rates
    young_daly_interval_steps: int | None
    simulated_optimal_interval_steps: int | None
    goodput_by_interval: dict[int, float] = field(default_factory=dict)
    # provenance
    step_report: Report | None = None
    failure_trace: tuple[FailureEvent, ...] = ()

    def explain_dict(self) -> dict:
        """Compact attribution (what sweep manifests embed): goodput,
        per-bucket wall-clock fractions, the dominant loss bucket."""
        from repro_torch.obs.explain import compact_resilience
        return compact_resilience(self)

    def summary(self) -> dict:
        """Flat dict for benchmarks and manifests."""
        return {
            "goodput": round(self.goodput, 6),
            "completed": self.completed,
            "wall_s": round(self.wall_s, 3),
            "ideal_s": round(self.ideal_s, 3),
            "steps_done": self.steps_done,
            "total_steps": self.total_steps,
            "tokens_per_s": round(self.tokens_per_s, 1),
            "useful_s": round(self.useful_s, 3),
            "rework_s": round(self.rework_s, 3),
            "straggler_s": round(self.straggler_s, 3),
            "checkpoint_s": round(self.checkpoint_s, 3),
            "downtime_s": round(self.downtime_s, 3),
            "n_failures": dict(self.n_failures),
            "n_restarts": self.n_restarts,
            "n_checkpoints": self.n_checkpoints,
            "n_spare_swaps": self.n_spare_swaps,
            "n_reshards": self.n_reshards,
            "degraded_steps": self.degraded_steps,
            "save_s": round(self.save_s, 3),
            "restore_s": round(self.restore_s, 3),
            "interval_steps": self.interval_steps,
            "mtbf_system_s": round(self.mtbf_system_s, 1),
            "young_daly_interval_steps": self.young_daly_interval_steps,
            "simulated_optimal_interval_steps":
                self.simulated_optimal_interval_steps,
        }
