"""``repro_torch.resilience`` against the reference's, on the CPU: the twin of
``tests/test_resilience.py`` and of
``tests/test_obs.py::test_resilience_bit_identical_and_span_partition``.

Determinism contracts asserted here, as the reference asserts them:

* the failure trace is a pure function of (FaultModel, component counts) —
  independent of the checkpoint schedule, so interval sweeps replay the
  *same* trace;
* a full ResilienceReport is bit-identical across runs and across
  ``sweep(workers=N)``;
* an inactive fault model with checkpointing off reproduces the
  failure-free report exactly (goodput == 1.0).

And across packages: with one price table (``StubSim`` of
``tests/test_torch_sweep.py``) a ``ResilienceReport`` — failure trace, every
bucket, the Young/Daly and simulated optimal intervals, the embedded step
report — equals the reference's field for field, seed for seed, as do its
trace events and metrics and a ``goodput_under_failures`` sweep.

The reference's twins price xlstm-125m; the cases that price for real run
the port's analytical engine on phi4-mini-3.8b at full width, on the
reference's cluster (``tpu_v5e``, 32 chips over 4 hosts) and with its fault
model (they came before the port had xLSTM).  phi4-mini's step there is
~7.3 s against xlstm's ~1.9 s, so the 400 steps see more failures; every
assertion is the reference's.  The ``test_xlstm_*`` cases run the reference's
own config there.
"""
import dataclasses
import math

import pytest

import repro.api as RA
import repro.obs as RO
import repro.resilience as RR
import repro_torch.api as TA
import repro_torch.obs as TO
import repro_torch.resilience as TR
from repro_torch.api import (
    AutoscalerSpec, CheckpointSpec, Cluster, DecodeWorkload, FaultModel, FleetSpec,
    ReplicaFaultSpec, ResilienceSpec, RouterSpec, ServingWorkload, SimSpec, SweepSpace,
    TrainWorkload, sweep,
)
from repro_torch.configs import get_config
from repro_torch.core import ParallelConfig, Simulator
from repro_torch.obs import CNAMES, MetricsRegistry, TraceRecorder
from repro_torch.resilience import FailureGen, ResilienceSimulator
from repro_torch.serving.sim import SLO, LengthDist, ServingSimulator
from test_torch_obs import _assert_perfetto_valid
from test_torch_sweep import PKGS, StubSim, counters_less_wall, manifest_less_wall, pkg_spec, plain

CFG = get_config("phi4-mini-3.8b")
HW = "tpu_v5e"

# 32 chips over 4 hosts; host MTBF 1200s -> system MTBF 300s
FAULTS = FaultModel(host_mtbf_s=1200.0, seed=11)
RES = ResilienceSpec(total_steps=400, faults=FAULTS,
                     ckpt=CheckpointSpec(interval_steps=10),
                     chips_per_host=8, restart_delay_s=30.0, repair_s=600.0,
                     optimize_interval=False)
RES_PKG = {"ref": RR, "port": TR}


@pytest.fixture(scope="module")
def sim():
    return Simulator(HW, engine="analytical")


def _sim():
    return Simulator(HW, engine="analytical")


def _spec(res):
    return SimSpec(CFG, cluster=Cluster(HW), parallel=ParallelConfig(tp=4, dp=8),
                   workload=TrainWorkload(global_batch=256, seq_len=2048, resilience=res))


# ---------------- failure traces ----------------

def test_failure_trace_deterministic_and_seed_sensitive():
    def first(n, seed):
        gen = FailureGen(FaultModel(host_mtbf_s=3600.0, chip_mtbf_s=1e6, seed=seed),
                         n_chips=16, n_hosts=4, n_links=4)
        return [gen.pop() for _ in range(n)]

    a, b = first(50, seed=3), first(50, seed=3)
    assert a == b
    assert [e.t_s for e in a] == sorted(e.t_s for e in a)
    assert first(50, seed=4) != a


def test_weibull_gaps_keep_configured_mean():
    gen = FailureGen(FaultModel(host_mtbf_s=100.0, dist="weibull", weibull_shape=0.7, seed=1),
                     n_chips=0, n_hosts=1, n_links=0)
    ts = [gen.pop().t_s for _ in range(4000)]
    gaps = [b - a for a, b in zip([0.0] + ts, ts)]
    assert sum(gaps) / len(gaps) == pytest.approx(100.0, rel=0.1)


def test_inactive_fault_model_yields_no_failures():
    gen = FailureGen(FaultModel(), n_chips=8, n_hosts=1, n_links=1)
    assert gen.peek() == math.inf
    assert not FaultModel().active
    assert FAULTS.active


# ---------------- resilience simulation (the port's own engine) ----------------

def test_goodput_under_failures_and_accounting_identity(sim):
    rep = ResilienceSimulator(sim).run(_spec(RES))
    assert rep.completed and rep.steps_done == 400
    assert 0.0 < rep.goodput < 1.0
    assert rep.n_restarts > 0 and rep.failure_trace
    assert rep.n_failures.get("host", 0) > 0
    parts = (rep.useful_s + rep.rework_s + rep.straggler_s + rep.checkpoint_s
             + rep.downtime_s)
    assert rep.wall_s == pytest.approx(parts, rel=1e-9)
    assert rep.wall_s > rep.ideal_s
    assert rep.n_checkpoints > 0 and rep.checkpoint_s > 0


def test_report_bit_deterministic_across_simulators():
    r1 = ResilienceSimulator(_sim()).run(_spec(RES))
    r2 = ResilienceSimulator(_sim()).run(_spec(RES))
    assert r1.summary() == r2.summary()
    assert r1.failure_trace == r2.failure_trace
    assert r1.goodput == r2.goodput and r1.wall_s == r2.wall_s


def test_trace_independent_of_checkpoint_schedule(sim):
    dense = ResilienceSimulator(sim).run(
        _spec(dataclasses.replace(RES, ckpt=CheckpointSpec(interval_steps=5))))
    sparse = ResilienceSimulator(sim).run(
        _spec(dataclasses.replace(RES, ckpt=CheckpointSpec(interval_steps=100))))
    n = min(len(dense.failure_trace), len(sparse.failure_trace))
    assert n > 0
    assert dense.failure_trace[:n] == sparse.failure_trace[:n]


def test_mtbf_infinity_reproduces_failure_free_report(sim):
    res = ResilienceSpec(total_steps=400, faults=FaultModel(),
                         ckpt=CheckpointSpec(interval_steps=0), optimize_interval=False)
    rep = ResilienceSimulator(sim).run(_spec(res))
    plain_rep = sim.run(_spec(None))
    assert rep.goodput == 1.0
    assert rep.wall_s == pytest.approx(rep.ideal_s, rel=1e-12)
    assert rep.failure_trace == () and rep.n_restarts == 0
    assert rep.downtime_s == 0 and rep.rework_s == 0 and rep.checkpoint_s == 0
    assert rep.step_report.step_time_us == plain_rep.step_time_us
    assert rep.step_report.kind_us == plain_rep.kind_us
    assert rep.tokens_per_s == pytest.approx(
        plain_rep.tokens_per_step / (plain_rep.step_time_us / 1e6), rel=1e-9)


def test_checkpoint_pricing_from_memory_report(sim):
    rep = ResilienceSimulator(sim).run(_spec(RES))
    mem = rep.step_report.memory
    assert rep.state_bytes_per_device == mem.weights + mem.opt_state
    assert rep.write_gbps == pytest.approx(sim.hw.inter.bandwidth / 1e9)
    assert rep.save_s == pytest.approx(rep.state_bytes_per_device / (rep.write_gbps * 1e9))
    slow = dataclasses.replace(
        RES, ckpt=CheckpointSpec(interval_steps=10, write_gbps=rep.write_gbps / 2))
    rep2 = ResilienceSimulator(sim).run(_spec(slow))
    assert rep2.save_s == pytest.approx(2 * rep.save_s)
    assert rep2.restore_s == pytest.approx(slow.ckpt.restore_factor * rep2.save_s)


def test_async_checkpoint_stalls_less_than_sync(sim):
    sync = ResilienceSimulator(sim).run(_spec(RES))
    async_rep = ResilienceSimulator(sim).run(_spec(dataclasses.replace(
        RES, ckpt=CheckpointSpec(interval_steps=10, mode="async"))))
    assert async_rep.checkpoint_s < sync.checkpoint_s
    parts = (async_rep.useful_s + async_rep.rework_s + async_rep.straggler_s
             + async_rep.checkpoint_s + async_rep.downtime_s)
    assert async_rep.wall_s == pytest.approx(parts, rel=1e-9)


def test_elastic_resharding_and_spares(sim):
    elastic = ResilienceSimulator(sim).run(_spec(RES))
    assert elastic.n_reshards > 0 and elastic.degraded_steps > 0
    rigid = ResilienceSimulator(sim).run(_spec(dataclasses.replace(RES, elastic=False)))
    assert rigid.degraded_steps == 0
    assert rigid.downtime_s > elastic.downtime_s
    spared = ResilienceSimulator(sim).run(_spec(dataclasses.replace(RES, spares=4)))
    assert spared.n_spare_swaps > 0
    assert spared.degraded_steps == 0
    assert spared.goodput > elastic.goodput


def test_straggler_slowdown_deterministic(sim):
    res = dataclasses.replace(RES, straggler_prob=0.05, straggler_mult=2.0)
    a = ResilienceSimulator(sim).run(_spec(res))
    b = ResilienceSimulator(sim).run(_spec(res))
    assert a.straggler_s > 0
    assert a.summary() == b.summary()
    clean = ResilienceSimulator(sim).run(_spec(RES))
    assert clean.straggler_s == 0
    assert a.goodput < clean.goodput


def test_young_daly_and_simulated_optimum_reported(sim):
    rep = ResilienceSimulator(sim).run(_spec(dataclasses.replace(RES, optimize_interval=True)))
    yd = rep.young_daly_interval_steps
    assert yd is not None and yd >= 1
    base_step_s = rep.step_report.step_time_us / 1e6
    assert yd == max(1, round(math.sqrt(2.0 * rep.save_s * rep.mtbf_system_s) / base_step_s))
    assert rep.mtbf_system_s == pytest.approx(1200.0 / 4)
    opt = rep.simulated_optimal_interval_steps
    assert opt in rep.goodput_by_interval
    assert rep.goodput_by_interval[opt] == max(rep.goodput_by_interval.values())
    assert rep.interval_steps in rep.goodput_by_interval


def test_resilience_requires_train_mode(sim):
    spec = SimSpec(CFG, cluster=Cluster(HW), parallel=ParallelConfig(tp=4),
                   workload=DecodeWorkload(global_batch=8, seq_len=512))
    with pytest.raises(TypeError, match="TrainWorkload"):
        ResilienceSimulator(sim).run(spec)


def test_resilience_bit_identical_and_span_partition(sim):
    res = dataclasses.replace(RES, straggler_prob=0.05, straggler_mult=1.5)
    spec = _spec(res)
    rep_off = ResilienceSimulator(sim).run(spec)
    rec, reg = TraceRecorder(), MetricsRegistry()
    rep_on = ResilienceSimulator(sim).run(spec, recorder=rec, metrics=reg)
    assert rep_on.summary() == rep_off.summary()
    events = rec.events()
    _assert_perfetto_valid(events)
    useful_us = sum(ev["dur"] for ev in events if ev.get("cname") == CNAMES["useful"])
    assert useful_us / 1e6 == pytest.approx(rep_on.useful_s, rel=1e-9)
    assert rep_on.n_failures and reg.snapshot()["counters"]["resilience.failures"] == \
        sum(rep_on.n_failures.values())
    assert any(ev["name"].startswith("FAILURE:") for ev in events)
    d = rep_on.explain_dict()
    assert d["dominant_loss"] in ("rework", "checkpoint", "downtime", "straggler", None)
    assert sum(d["bucket_fracs"].values()) == pytest.approx(1.0, abs=2e-3)


# ---------------- across packages: one price table ----------------

VARIANTS = {
    "sync": {},
    "async": {"ckpt": CheckpointSpec(interval_steps=10, mode="async")},
    "rigid": {"elastic": False},
    "spares": {"spares": 4},
    "stragglers": {"straggler_prob": 0.05, "straggler_mult": 2.0},
    "optimize": {"optimize_interval": True},
    "weibull_chips": {"faults": FaultModel(host_mtbf_s=3600.0, chip_mtbf_s=2e4,
                                           link_mtbf_s=5e4, dist="weibull",
                                           weibull_shape=0.8, seed=9)},
    "no_ckpt": {"ckpt": CheckpointSpec(interval_steps=0)},
}


def res_pair(variant: str) -> dict:
    """The reference's RES with one variant, built in each package (the
    nested specs are carried field for field)."""
    out = {}
    for name, (A, *_rest) in PKGS.items():
        kw = {k: getattr(A, type(v).__name__)(**dataclasses.asdict(v))
              if dataclasses.is_dataclass(v) else v
              for k, v in VARIANTS[variant].items()}
        base = A.ResilienceSpec(total_steps=400,
                                faults=A.FaultModel(host_mtbf_s=1200.0, seed=11),
                                ckpt=A.CheckpointSpec(interval_steps=10), chips_per_host=8,
                                restart_delay_s=30.0, repair_s=600.0, optimize_interval=False)
        out[name] = dataclasses.replace(base, **kw)
    return out


def train_pair(res: dict) -> dict:
    return {name: pkg_spec(name, hw=HW, chips=0, parallel=lambda P: P(tp=4, dp=8),
                           workload=lambda A, n=name: A.TrainWorkload(
                               global_batch=256, seq_len=2048, resilience=res[n]))
            for name in PKGS}


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_resilience_report_equals_the_reference_with_one_price_table(variant):
    specs = train_pair(res_pair(variant))
    assert specs["port"].json_hash() == specs["ref"].json_hash()
    reps = {}
    for name, spec in specs.items():
        rec = (RO if name == "ref" else TO).TraceRecorder()
        reg = (RO if name == "ref" else TO).MetricsRegistry()
        reps[name] = (RES_PKG[name].ResilienceSimulator(StubSim(name, HW))
                      .run(spec, recorder=rec, metrics=reg), rec.events(), reg.snapshot())
    (port, p_ev, p_m), (ref, r_ev, r_m) = reps["port"], reps["ref"]
    assert plain(port) == plain(ref)
    assert [e.asdict() for e in port.failure_trace] == [e.asdict() for e in ref.failure_trace]
    assert port.summary() == ref.summary()
    assert port.explain_dict() == ref.explain_dict()
    assert p_ev == r_ev and p_m == r_m
    if variant not in ("no_ckpt",):
        assert ref.n_restarts > 0           # the table's steps see failures


def _res_space(A, name):
    res = res_pair("sync")[name]
    base = pkg_spec(name, hw=HW, chips=0, parallel=lambda P: P(tp=4, dp=8),
                    workload=lambda A_: A_.TrainWorkload(
                        global_batch=256, seq_len=2048,
                        resilience=dataclasses.replace(
                            res, total_steps=200,
                            ckpt=A.CheckpointSpec(interval_steps=50))))
    return A.SweepSpace(base, {"workload.resilience.ckpt.interval_steps": (10, 50, 200),
                               "workload.resilience.spares": (0, 1)})


def test_goodput_under_failures_sweep_equals_the_reference(tmp_path):
    out = {}
    for name, (A, *_rest) in PKGS.items():
        out[name] = A.sweep(_res_space(A, name), sim=StubSim(name, HW),
                            objective="goodput_under_failures",
                            manifest=str(tmp_path / f"{name}.json"))
    port, ref = out["port"], out["ref"]
    assert len(ref.ranked()) == 6
    assert plain(port.evaluated) == plain(ref.evaluated)
    assert [r.spec.json_hash() for r in port.ranked()] == \
        [r.spec.json_hash() for r in ref.ranked()]
    assert counters_less_wall(port.metrics) == counters_less_wall(ref.metrics)
    assert manifest_less_wall(tmp_path / "port.json") == manifest_less_wall(tmp_path / "ref.json")


# ---------------- spec surface ----------------

def test_resilience_spec_json_roundtrip_preserves_hash():
    spec = _spec(dataclasses.replace(
        RES, faults=FaultModel(host_mtbf_s=3600.0, chip_mtbf_s=1e7, dist="weibull",
                               weibull_shape=0.8, seed=9),
        spares=2, straggler_prob=0.01, straggler_mult=3.0))
    back = SimSpec.from_json(spec.to_json())
    assert back == spec and back.json_hash() == spec.json_hash()
    assert back.workload.resilience.faults.dist == "weibull"
    ref = RA.SimSpec.from_json(spec.to_json())
    assert ref.json_hash() == spec.json_hash()


def test_fleet_faults_json_roundtrip_and_trivial():
    fleet = FleetSpec(replicas=2, router=RouterSpec("round_robin"),
                      faults=ReplicaFaultSpec(mtbf_s=120.0, restart_s=15.0, seed=3))
    spec = SimSpec(CFG, parallel=ParallelConfig(tp=4),
                   workload=ServingWorkload(n_requests=4, fleet=fleet))
    back = SimSpec.from_json(spec.to_json())
    assert back == spec and back.json_hash() == spec.json_hash()
    assert back.workload.fleet.faults.mtbf_s == 120.0
    assert not FleetSpec(replicas=1, faults=ReplicaFaultSpec(mtbf_s=1.0)).trivial
    assert FleetSpec(replicas=1).trivial


def test_fault_model_validation():
    with pytest.raises(ValueError):
        FaultModel(host_mtbf_s=-1.0)
    with pytest.raises(ValueError):
        FaultModel(dist="lognormal")
    with pytest.raises(ValueError):
        CheckpointSpec(mode="mirrored")
    with pytest.raises(ValueError):
        ResilienceSpec(total_steps=0)
    with pytest.raises(ValueError):
        ReplicaFaultSpec(mtbf_s=-2.0)


# ---------------- sweep objective (the port's own engine) ----------------

def _port_res_space():
    return _res_space(TA, "port")


def test_sweep_goodput_under_failures_ranks_by_useful_tokens():
    res = sweep(_port_res_space(), objective="goodput_under_failures")
    ranked = res.ranked()
    assert len(ranked) == 6
    assert all(r.resilience is not None for r in ranked)
    rates = [r.resilience.tokens_per_s for r in ranked]
    assert rates == sorted(rates, reverse=True)
    n = min(len(r.resilience.failure_trace) for r in ranked)
    assert n > 0
    first = ranked[0].resilience.failure_trace[:n]
    assert all(r.resilience.failure_trace[:n] == first for r in ranked)


def test_sweep_goodput_under_failures_workers_bit_identical(tmp_path):
    import json

    def key(res):
        return [(r.spec.json_hash(), r.resilience.goodput, r.resilience.wall_s,
                 r.resilience.failure_trace) for r in res.ranked()]

    man = tmp_path / "manifest.json"
    serial = sweep(_port_res_space(), objective="goodput_under_failures", manifest=str(man))
    parallel = sweep(_port_res_space(), objective="goodput_under_failures", workers=2)
    assert key(serial) == key(parallel)
    doc = json.loads(man.read_text())
    assert doc["objective"] == "goodput_under_failures"
    rows = doc["candidates"]
    assert rows and all(row["goodput_under_failures"] is not None
                        for row in rows if not row["pruned"])


def test_sweep_goodput_under_failures_requires_resilience():
    with pytest.raises(TypeError, match="resilience"):
        sweep(SweepSpace(_spec(None), {"tp": (2, 4)}), objective="goodput_under_failures")


# ---------------- fleet replica faults (the port's own engine) ----------------

def _fleet_spec(faults, *, replicas=3, autoscaler=None, n=300):
    return SimSpec(CFG, cluster=Cluster(HW), parallel=ParallelConfig(tp=4),
                   workload=ServingWorkload(
                       n_requests=n, arrival="poisson", rate_rps=150.0,
                       prompt=LengthDist("lognormal", median=128.0, sigma=0.5, cap=512),
                       output=LengthDist("lognormal", median=48.0, sigma=0.5, cap=192),
                       seed=5, slo=SLO(ttft_s=0.25, tpot_ms=80.0), max_batch=16,
                       fleet=FleetSpec(replicas=replicas, router=RouterSpec("least_loaded"),
                                       autoscaler=autoscaler, faults=faults)))


def test_fleet_faults_conserve_requests_and_degrade_goodput(sim):
    clean = ServingSimulator(sim).run(_fleet_spec(None))
    assert clean.n_replica_failures == 0 and clean.n_rerouted == 0
    faulty = ServingSimulator(sim).run(_fleet_spec(
        ReplicaFaultSpec(mtbf_s=1.0, restart_s=0.5, seed=5)))
    assert faulty.n_requests == 300
    assert faulty.n_replica_failures > 0 and faulty.n_rerouted > 0
    assert faulty.slo_attainment < clean.slo_attainment
    assert faulty.summary()["n_replica_failures"] == faulty.n_replica_failures


def test_fleet_fault_trace_bit_deterministic():
    spec = _fleet_spec(ReplicaFaultSpec(mtbf_s=1.0, restart_s=0.5, seed=5))
    a = ServingSimulator(_sim()).run(spec)
    b = ServingSimulator(_sim()).run(spec)
    assert a.failure_trace == b.failure_trace
    assert a.goodput_rps == b.goodput_rps
    assert a.ttft_s == b.ttft_s and a.n_rerouted == b.n_rerouted


def test_fleet_faults_with_autoscaler_conserve_requests(sim):
    asc = AutoscalerSpec(min_replicas=1, max_replicas=4, scale_up_queue=6.0,
                         scale_down_queue=1.0, interval_s=2.0, cooldown_s=4.0, provision_s=5.0)
    rep = ServingSimulator(sim).run(_fleet_spec(
        ReplicaFaultSpec(mtbf_s=1.5, restart_s=0.5, seed=2), replicas=2, autoscaler=asc))
    assert rep.n_requests == 300
    assert rep.n_replica_failures > 0
    for row in rep.failure_trace:
        assert set(row) == {"t", "replica"}


def test_single_replica_with_faults_uses_fleet_path(sim):
    rep = ServingSimulator(sim).run(_fleet_spec(
        ReplicaFaultSpec(mtbf_s=0.8, restart_s=0.3, seed=1), replicas=1, n=200))
    assert rep.n_requests == 200
    assert rep.n_replica_failures > 0


# ---------------- the reference's own config: xlstm-125m ----------------

XLSTM = get_config("xlstm-125m")


def _xspec(res, A=TA):
    if A is TA:
        cfg, par = XLSTM, ParallelConfig(tp=4, dp=8)
    else:
        from repro.configs import get_config as r_config
        from repro.core import ParallelConfig as RPar
        cfg, par = r_config("xlstm-125m"), RPar(tp=4, dp=8)
    return A.SimSpec(cfg, cluster=A.Cluster(HW), parallel=par,
                     workload=A.TrainWorkload(global_batch=256, seq_len=2048, resilience=res))


def test_xlstm_goodput_under_failures_and_accounting_identity(sim):
    """The reference's case on its own config: 400 steps of xlstm-125m (a
    step of about 1.9 s) on 32 chips with its fault model."""
    rep = ResilienceSimulator(sim).run(_xspec(RES))
    assert rep.completed and rep.steps_done == 400
    assert 0.0 < rep.goodput < 1.0
    assert rep.n_restarts > 0 and rep.failure_trace
    assert rep.n_failures.get("host", 0) > 0
    parts = rep.useful_s + rep.rework_s + rep.straggler_s + rep.checkpoint_s + rep.downtime_s
    assert rep.wall_s == pytest.approx(parts, rel=1e-9)
    assert rep.wall_s > rep.ideal_s
    assert rep.n_checkpoints > 0 and rep.checkpoint_s > 0


def test_xlstm_mtbf_infinity_reproduces_failure_free_report(sim):
    res = ResilienceSpec(total_steps=400, faults=FaultModel(),
                         ckpt=CheckpointSpec(interval_steps=0), optimize_interval=False)
    rep = ResilienceSimulator(sim).run(_xspec(res))
    plain = sim.run(_xspec(None))
    assert rep.goodput == 1.0
    assert rep.wall_s == pytest.approx(rep.ideal_s, rel=1e-12)
    assert rep.failure_trace == () and rep.n_restarts == 0
    assert rep.step_report.step_time_us == plain.step_time_us
    assert rep.step_report.kind_us == plain.kind_us


def test_xlstm_step_within_the_step_gap_of_the_reference(sim):
    """The failure-free step that the resilience simulation prices, each
    package's own analytical engine: within ``STEP_TOL`` = 15 % of
    ``tests/test_torch_simulator.py`` (measured +11.7 %) and its memory
    within that file's 8 % for xlstm's train memory (measured -5.4 %: the
    reference's joint graph keeps ``jax.nn.silu``'s residuals)."""
    from repro.core import Simulator as RSim
    r = RSim(HW, engine="analytical").run(_xspec(None, RA))
    t = sim.run(_xspec(None))
    assert t.step_time_us == pytest.approx(r.step_time_us, rel=0.15)
    assert t.memory.total == pytest.approx(r.memory.total, rel=0.08)
