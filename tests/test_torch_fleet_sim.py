"""``repro_torch``'s fleet simulator against the reference's, on the CPU: the
twin of ``tests/test_fleet_sim.py``, less its sweep cases
(``test_fleet_sweep_*``, ``test_fleet_fields_are_sweep_axes``,
``test_serving_base_requires_goodput``), which wait for the port of
``api/sweep.py``.

With one price table in both packages (``table_oracle`` of
``tests/test_torch_serving_sim.py``) every router, the autoscaler on a flash
crowd, fleet-level disaggregation and seeded replica faults give a
``FleetReport`` equal to the reference's field for field.  The cases that
need a real oracle run the port's analytical engine on phi4-mini-3.8b at
full width (the reference's twins use xlstm-125m, which the port lacks)."""
import dataclasses
import math
import warnings

import pytest

import repro.api as RA
import repro.serving.sim as RS
import repro_torch.api as TA
import repro_torch.serving.sim as TS
from repro.configs import get_config as r_config
from repro.core import ParallelConfig as RPar
from repro_torch.api import (
    AutoscalerSpec, Cluster, FleetSpec, ReplicaFaultSpec, RouterSpec, ServingWorkload,
    SimSpec,
)
from repro_torch.core import ParallelConfig, Simulator
from repro_torch.serving.sim import (
    FleetReport, FleetSimulator, LengthDist, ServingReport, ServingSimulator, make_router,
    synthesize,
)
from test_torch_serving_sim import ARCH, CFG, oracle_for, pkg_cfg, pkg_sim, short

PAR = ParallelConfig()
SHORT = short(TS)
PKGS = {"ref": (RA, RS), "port": (TA, TS)}


@pytest.fixture(scope="module")
def sim():
    # module-scoped: the shared oracle's cold misses dominate; every test
    # after the first runs warm
    return Simulator("h100_sxm", engine="analytical")


def _spec(n=200, rate=48.0, seed=3, arrival="poisson", fleet=None, A=TA, S=TS, **kw):
    cfg = CFG if A is TA else r_config(ARCH)
    par = ParallelConfig() if A is TA else RPar()
    return A.SimSpec(cfg, cluster=A.Cluster("h100_sxm"), parallel=par,
                     workload=A.ServingWorkload(
                         n_requests=n, arrival=arrival, rate_rps=rate, seed=seed,
                         fleet=fleet or A.FleetSpec(), **short(S), **kw))


def fleet_pair(fleet, **kw):
    """The same fleet spec through both packages' fleet event loops over the
    table oracle (what ``ServingSimulator(sim).run(spec)`` does, with the
    oracle swapped); returns {"ref": report, "port": report}."""
    out = {}
    for name, (A, S) in PKGS.items():
        spec = _spec(fleet=fleet(A), A=A, S=S, **kw)
        w = spec.workload
        fsim = S.FleetSimulator(pkg_sim(name), pkg_cfg(name), par=spec.parallel,
                                policy=w.make_policy(), fleet=w.fleet,
                                oracle=oracle_for(name, w.ctx_floor))
        out[name] = fsim.run(w.build(), slo=w.slo)
    return out


def _assert_equal(reps):
    ref, port = reps["ref"], reps["port"]
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert port.summary() == ref.summary()
    return port


# ---------------- spec types ----------------

def test_fleet_spec_roundtrip_and_hash():
    fleets = {name: A.FleetSpec(replicas=4, router=A.RouterSpec("session_affinity"),
                                autoscaler=A.AutoscalerSpec(max_replicas=6),
                                prefill_replicas=2, prefill_batch=8,
                                faults=A.ReplicaFaultSpec(mtbf_s=50.0, dist="weibull", seed=4))
              for name, (A, _) in PKGS.items()}
    specs = {name: _spec(fleet=fleets[name], A=A, S=S, sessions=16)
             for name, (A, S) in PKGS.items()}
    spec = specs["port"]
    again = SimSpec.from_json(spec.to_json())
    assert again == spec and hash(again) == hash(spec)
    assert again.json_hash() == spec.json_hash() == specs["ref"].json_hash()
    assert spec.to_json() == specs["ref"].to_json()
    assert again.workload.fleet.autoscaler == fleets["port"].autoscaler
    assert SimSpec.from_json(specs["ref"].to_json()) == spec
    assert RA.SimSpec.from_json(spec.to_json()) == specs["ref"]
    # no-autoscaler fleets round-trip the None
    spec2 = _spec(fleet=FleetSpec(replicas=2))
    assert SimSpec.from_json(spec2.to_json()) == spec2
    assert spec2.json_hash() == _spec(fleet=RA.FleetSpec(replicas=2), A=RA, S=RS).json_hash()


def test_fleet_spec_validation():
    with pytest.raises(ValueError):
        FleetSpec(replicas=0)
    with pytest.raises(ValueError):
        RouterSpec("best_effort")
    with pytest.raises(ValueError):
        RouterSpec("session_affinity", fallback="session_affinity")
    with pytest.raises(ValueError):
        AutoscalerSpec(scale_up_queue=2.0, scale_down_queue=4.0)
    with pytest.raises(ValueError):
        AutoscalerSpec(min_replicas=5, max_replicas=2)
    with pytest.raises(ValueError):
        ReplicaFaultSpec(mtbf_s=-1.0)
    with pytest.raises(ValueError):
        ReplicaFaultSpec(dist="gamma")
    assert FleetSpec().trivial
    assert not FleetSpec(replicas=2).trivial
    assert not FleetSpec(autoscaler=AutoscalerSpec()).trivial
    assert ReplicaFaultSpec(mtbf_s=10.0).active and not ReplicaFaultSpec().active
    assert not ReplicaFaultSpec(mtbf_s=math.inf).active


# ---------------- one price table: equal to the reference ----------------

@pytest.mark.parametrize("router", ["round_robin", "least_loaded", "session_affinity"])
def test_fleet_reports_equal_the_reference_for_every_router(router):
    port = _assert_equal(fleet_pair(lambda A: A.FleetSpec(replicas=3, router=A.RouterSpec(router)),
                                    n=200, arrival="bursty", seed=11, sessions=12))
    assert port.n_requests == 200 and port.router == router


@pytest.mark.parametrize("policy", ["continuous", "chunked", "static"])
def test_fleet_reports_equal_the_reference_for_every_policy(policy):
    port = _assert_equal(fleet_pair(lambda A: A.FleetSpec(replicas=2), n=120, policy=policy,
                                    max_batch=8))
    assert port.n_requests == 120


def test_disaggregated_fleet_equals_the_reference():
    port = _assert_equal(fleet_pair(
        lambda A: A.FleetSpec(replicas=2, prefill_replicas=1, prefill_batch=4), n=150))
    assert port.replica_utilization["r2/prefill"]["steps"] > 0


def test_autoscaled_flash_crowd_equals_the_reference():
    port = _assert_equal(fleet_pair(
        lambda A: A.FleetSpec(replicas=1, router=A.RouterSpec("least_loaded"),
                              autoscaler=A.AutoscalerSpec(
                                  min_replicas=1, max_replicas=4, scale_up_queue=6.0,
                                  scale_down_queue=0.5, interval_s=1.0, cooldown_s=3.0,
                                  provision_s=0.5)),
        n=500, arrival="flash_crowd", rate=10.0, seed=2, flash_start_s=5.0,
        flash_dur_s=25.0, flash_mult=12.0))
    actions = {e["action"].split(":")[0] for e in port.autoscaler_trace}
    assert actions == {"scale_up", "scale_down"}


@pytest.mark.parametrize("dist", ["exponential", "weibull"])
def test_replica_faults_equal_the_reference(dist):
    port = _assert_equal(fleet_pair(
        lambda A: A.FleetSpec(replicas=3, router=A.RouterSpec("least_loaded"),
                              faults=A.ReplicaFaultSpec(mtbf_s=1.5, restart_s=0.4, dist=dist,
                                                        seed=7)),
        n=200, rate=60.0))
    assert port.n_requests == 200
    assert port.failure_trace and port.n_rerouted > 0
    assert port.n_replica_failures == len(port.failure_trace)


def test_replica_fault_stream_equals_the_reference():
    from repro.resilience.faults import replica_fault_stream as r_stream
    from repro_torch.resilience.faults import replica_fault_stream as t_stream
    for spec, rspec in ((ReplicaFaultSpec(mtbf_s=30.0, seed=3),
                         RA.ReplicaFaultSpec(mtbf_s=30.0, seed=3)),
                        (ReplicaFaultSpec(mtbf_s=30.0, dist="weibull", seed=9),
                         RA.ReplicaFaultSpec(mtbf_s=30.0, dist="weibull", seed=9))):
        for index in (0, 5):
            t, r = t_stream(spec, index), r_stream(rspec, index)
            assert [t() for _ in range(20)] == [r() for _ in range(20)]


def test_failure_gen_equals_the_reference():
    from repro.resilience.faults import FailureGen as RGen
    from repro_torch.resilience import FailureGen
    fm = TA.FaultModel(chip_mtbf_s=500.0, host_mtbf_s=900.0, link_mtbf_s=2000.0, seed=5)
    rfm = RA.FaultModel(chip_mtbf_s=500.0, host_mtbf_s=900.0, link_mtbf_s=2000.0, seed=5)
    counts = dict(n_chips=16, n_hosts=2, n_links=4)
    t, r = FailureGen(fm, **counts), RGen(rfm, **counts)
    assert [t.pop().asdict() for _ in range(50)] == [r.pop().asdict() for _ in range(50)]
    assert FailureGen(TA.FaultModel(), **counts).peek() == math.inf


# ---------------- shim <-> spec identity (the port's own oracle) ----------------

def test_round_robin_fleet_matches_sharded_single_runs(sim):
    """Replica i of a round-robin fleet sees exactly ``shard(k, i)``; its
    per-replica report must be bit-identical to a standalone run of that
    shard."""
    spec = _spec(n=150, fleet=FleetSpec(replicas=3))
    w = spec.workload
    frep = ServingSimulator(sim).run(spec)
    assert isinstance(frep, FleetReport) and frep.n_replicas == 3
    for i in range(3):
        solo = ServingSimulator(sim, CFG, par=PAR, policy=w.make_policy(),
                                ctx_floor=w.ctx_floor).run(w.build().shard(3, i), slo=w.slo)
        per = frep.replicas[i]
        assert per.n_requests == solo.n_requests
        assert per.ttft_s == solo.ttft_s
        assert per.tpot_ms == solo.tpot_ms
        assert per.n_steps == solo.n_steps
        assert per.utilization == solo.utilization


def test_thin_shim_equals_router_delivery():
    wl = synthesize(60, rate_rps=20.0, seed=7, **SHORT)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        thinned = wl.thin(4, offset=2)
    key = lambda w: [(r.rid, r.arrival_s, r.prompt_len, r.output_len) for r in w.requests]
    assert key(thinned) == key(wl.shard(4, offset=2))

    class Rep:
        def __init__(self, index):
            self.index = index
    reps = [Rep(i) for i in range(4)]
    router = make_router(RouterSpec())
    routed = [[] for _ in reps]
    for r in wl.requests:
        routed[router.route(r, reps, r.arrival_s).index].append(r)
    assert [r.rid for r in routed[2]] == [r.rid for r in thinned.requests]
    with pytest.raises(ValueError):
        make_router("nonsense")
    assert make_router("session_affinity").fallback.name == "least_loaded"


# ---------------- determinism + conservation (the port's own oracle) ----------------

@pytest.mark.parametrize("router", ["round_robin", "least_loaded", "session_affinity"])
def test_fleet_conservation_and_determinism(sim, router):
    fleet = FleetSpec(replicas=3, router=RouterSpec(router))
    spec = _spec(n=200, arrival="bursty", seed=11, sessions=12, fleet=fleet)
    a = ServingSimulator(sim).run(spec)
    b = ServingSimulator(sim).run(spec)
    assert a.n_requests == 200                  # conservation (else the
    assert sum(a.replica_requests.values()) == 200   # loop raised)
    assert a.ttft_s == b.ttft_s and a.tpot_ms == b.tpot_ms
    assert a.replica_requests == b.replica_requests
    sa, sb = a.summary(), b.summary()
    sa.pop("oracle_stats"), sb.pop("oracle_stats")
    assert sa == sb


@pytest.mark.parametrize("n", [30, 45, 200])
def test_static_gang_fleet_drains(sim, n):
    """A gang-scheduling replica idling on a partial batch is unblocked by the
    fleet-wide last arrival, so a static-policy fleet drains."""
    fleet = FleetSpec(replicas=2)
    spec = _spec(n=n, seed=3, policy="static", max_batch=8, fleet=fleet)
    a = ServingSimulator(sim).run(spec)
    assert a.n_requests == n
    assert sum(a.replica_requests.values()) == n
    b = ServingSimulator(sim).run(spec)
    assert a.ttft_s == b.ttft_s and a.tpot_ms == b.tpot_ms


def test_disaggregated_fleet_uses_policy_decode_batch(sim):
    from repro_torch.serving.sim.policies import DisaggregatedPD

    fsim = FleetSimulator(sim, CFG, par=PAR, policy=DisaggregatedPD(decode_batch=7),
                          fleet=FleetSpec(replicas=2, prefill_replicas=1))
    _, serve, _ = fsim._replicas()
    assert {p.policy.max_batch for rep in serve for p in rep.pools} == {7}


def test_disaggregated_fleet_conserves(sim):
    spec = _spec(n=150, fleet=FleetSpec(replicas=2, prefill_replicas=1, prefill_batch=4))
    rep = ServingSimulator(sim).run(spec)
    assert rep.n_requests == 150
    assert set(rep.replica_utilization) >= {"r0/decode", "r1/decode", "r2/prefill"}
    assert rep.replica_utilization["r2/prefill"]["steps"] > 0


def test_least_loaded_beats_round_robin_on_bursty(sim):
    reps = {}
    for kind in ("round_robin", "least_loaded"):
        spec = _spec(n=250, arrival="bursty", rate=64.0, seed=5,
                     fleet=FleetSpec(replicas=3, router=RouterSpec(kind)))
        reps[kind] = ServingSimulator(sim).run(spec)
    rr, ll = reps["round_robin"], reps["least_loaded"]
    assert rr.replica_requests != ll.replica_requests
    assert ll.queue_delay_s.p99 <= rr.queue_delay_s.p99


def test_session_affinity_is_sticky(sim):
    spec = _spec(n=200, sessions=8,
                 fleet=FleetSpec(replicas=4, router=RouterSpec("session_affinity")))
    rep = ServingSimulator(sim).run(spec)
    by_session = {}
    for i, per in enumerate(rep.replicas):
        for r in per.requests:
            by_session.setdefault(r.session, set()).add(i)
    assert by_session and all(len(v) == 1 for v in by_session.values())
    assert len({next(iter(v)) for v in by_session.values()}) > 1


# ---------------- autoscaler (the port's own oracle) ----------------

def test_autoscaler_no_thrash_on_flat_trace(sim):
    fleet = FleetSpec(replicas=2, autoscaler=AutoscalerSpec(
        min_replicas=2, max_replicas=4, scale_up_queue=12.0,
        scale_down_queue=0.0 + 1e-9, interval_s=1.0))
    spec = _spec(n=150, arrival="uniform", rate=8.0, fleet=fleet)
    rep = ServingSimulator(sim).run(spec)
    assert rep.n_requests == 150
    assert rep.autoscaler_trace == ()


def test_autoscaler_scales_up_on_flash_crowd(sim):
    fleet = FleetSpec(replicas=1, router=RouterSpec("least_loaded"),
                      autoscaler=AutoscalerSpec(
                          min_replicas=1, max_replicas=4, scale_up_queue=6.0,
                          scale_down_queue=0.5, interval_s=1.0, cooldown_s=3.0,
                          provision_s=0.5))
    spec = _spec(n=500, arrival="flash_crowd", rate=10.0, seed=2, flash_start_s=5.0,
                 flash_dur_s=25.0, flash_mult=12.0, fleet=fleet)
    rep = ServingSimulator(sim).run(spec)
    ups = [e for e in rep.autoscaler_trace if e["action"].startswith("scale_up")]
    downs = [e for e in rep.autoscaler_trace if e["action"].startswith("scale_down")]
    assert ups, "flash crowd must trigger scale-up"
    assert downs, "post-flash lull must scale back down"
    assert rep.n_requests == 500
    assert sum(1 for v in rep.replica_requests.values() if v > 0) > 1


def test_replica_faults_reroute_and_conserve(sim):
    fleet = FleetSpec(replicas=3, faults=ReplicaFaultSpec(mtbf_s=2.0, restart_s=0.5, seed=1))
    spec = _spec(n=200, rate=60.0, fleet=fleet)
    a = ServingSimulator(sim).run(spec)
    b = ServingSimulator(sim).run(spec)
    assert a.n_requests == 200 and a.failure_trace and a.n_rerouted > 0
    assert a.failure_trace == b.failure_trace and a.ttft_s == b.ttft_s
    for r in a.requests:
        assert r.decoded == r.output_len and r.arrival_s <= r.first_token_s <= r.finished_s


# ---------------- report aggregation ----------------

def test_fleet_report_equals_hand_merge(sim):
    spec = _spec(n=120, fleet=FleetSpec(replicas=3))
    rep = ServingSimulator(sim).run(spec)
    merged = [r for per in rep.replicas for r in per.requests]
    hand = ServingReport.build(merged, [], rep.slo, {})
    assert rep.n_requests == hand.n_requests == 120
    assert rep.ttft_s == hand.ttft_s
    assert rep.tpot_ms == hand.tpot_ms
    assert rep.e2e_s == hand.e2e_s
    assert rep.makespan_s == hand.makespan_s
    assert rep.slo_attainment == hand.slo_attainment
    assert abs(rep.goodput_rps - hand.goodput_rps) < 1e-12
    assert rep.n_steps == sum(per.n_steps for per in rep.replicas)


def test_fleet_report_is_system_level():
    assert FleetReport.system_level and not ServingReport.system_level


# ---------------- arrival generators ----------------

def test_diurnal_and_flash_generators():
    di = synthesize(800, arrival="diurnal", rate_rps=20.0, period_s=40.0, diurnal_amp=0.9,
                    seed=4, **SHORT)
    arr = [r.arrival_s for r in di.requests]
    assert arr == sorted(arr)
    r_di = RS.synthesize(800, arrival="diurnal", rate_rps=20.0, period_s=40.0,
                         diurnal_amp=0.9, seed=4, **short(RS))
    assert arr == [r.arrival_s for r in r_di.requests]
    phase = [math.sin(2 * math.pi * t / 40.0) for t in arr]
    assert sum(1 for p in phase if p > 0.5) > 2 * sum(1 for p in phase if p < -0.5)

    fl = synthesize(600, arrival="flash_crowd", rate_rps=10.0, flash_start_s=10.0,
                    flash_dur_s=10.0, flash_mult=8.0, seed=4, **SHORT)
    t = [r.arrival_s for r in fl.requests]
    r_fl = RS.synthesize(600, arrival="flash_crowd", rate_rps=10.0, flash_start_s=10.0,
                         flash_dur_s=10.0, flash_mult=8.0, seed=4, **short(RS))
    assert t == [r.arrival_s for r in r_fl.requests]
    in_flash = sum(1 for x in t if 10.0 <= x < 20.0)
    before = sum(1 for x in t if 0.0 <= x < 10.0)
    assert in_flash > 3 * max(before, 1)


def test_fleet_spec_run_needs_a_serving_workload(sim):
    from repro_torch.api import DecodeWorkload
    with pytest.raises(TypeError, match="ServingWorkload"):
        FleetSimulator(sim).run(SimSpec(CFG, workload=DecodeWorkload()))
    with pytest.raises(TypeError, match="SimSpec"):
        FleetSimulator(sim).run(synthesize(3))
    spec = SimSpec(CFG, cluster=Cluster("h100_sxm"),
                   workload=ServingWorkload(n_requests=3, fleet=FleetSpec(replicas=2)))
    with pytest.raises(ValueError, match="cluster hardware"):
        FleetSimulator(Simulator("a100_80g")).run(spec)
