"""``repro_torch.obs`` (recorder, metrics, explain) and ``core/timeline.py``
against the reference's, on the CPU: the twin of ``tests/test_obs.py`` (its
resilience case is twinned in ``test_torch_resilience.py``).

Contracts asserted here, as the reference asserts them:

* every exported trace is Perfetto-loadable: required keys on every event,
  microsecond timestamps sorted non-decreasing, non-negative durations,
  JSON round-trip;
* ``recorder=None`` and an attached ``MetricsRegistry`` change no report
  field — observability is a pure tap on the core step, serving and fleet
  simulators;
* truncation is loud.

And across packages: with one price table (``table_oracle`` of
``tests/test_torch_serving_sim.py``) the serving and fleet runs give the
reference's chrome-trace JSON, ``MetricsRegistry`` snapshot and
``explain_dict()``; for one core report, both packages' ``explain_report``,
``render_report``, ``to_chrome_trace`` and ``record_report`` agree.  The
cases that price for real use phi4-mini-3.8b on ``h100_sxm``; the
``test_xlstm_*`` cases run the reference's own xlstm-125m specs on
``tpu_v5e``.
"""
import dataclasses
import json

import pytest

import repro.api as RA
import repro.obs as RO
import repro.serving.sim as RS
import repro_torch.api as TA
import repro_torch.obs as TO
import repro_torch.serving.sim as TS
from repro.core import timeline as r_timeline
from repro_torch.api import (
    Cluster, FleetSpec, RouterSpec, ServingWorkload, SimSpec, SweepSpace, TrainWorkload, sweep,
)
from repro_torch.core import ParallelConfig, Simulator
from repro_torch.core import timeline as t_timeline
from repro_torch.obs import (
    CNAMES, NULL_RECORDER, HistStat, MetricsRegistry, TraceRecorder, compact_report,
    compact_serving, critical_path, explain_report,
)
from repro_torch.obs import clock
from repro_torch.serving.sim import SLO, ServingSimulator
from test_torch_fleet_sim import _spec as fleet_spec
from test_torch_serving_sim import (
    CFG, POLICIES, oracle_for, pkg_cfg, pkg_sim, serve_pair, short,
)

PKGS = {"ref": (RA, RS, RO), "port": (TA, TS, TO)}


@pytest.fixture(scope="module")
def sim():
    return Simulator("h100_sxm", engine="analytical")


def _step_spec():
    return SimSpec(CFG, cluster=Cluster("h100_sxm", chips=2), parallel=ParallelConfig(tp=2),
                   workload=TrainWorkload(global_batch=8, seq_len=512))


def _serving_spec(n=120, fleet=None, **kw):
    if fleet is not None:
        kw["fleet"] = fleet
    kw.setdefault("rate_rps", 48.0)
    return SimSpec(CFG, cluster=Cluster("h100_sxm"),
                   workload=ServingWorkload(n_requests=n, seed=3, max_batch=8,
                                            slo=SLO(ttft_s=1.0, tpot_ms=50.0),
                                            **short(TS), **kw))


def _assert_perfetto_valid(events):
    assert events, "trace is empty"
    last_ts = -1.0
    for ev in events:
        for key in ("name", "ph", "ts", "pid", "tid"):
            assert key in ev, f"event missing {key}: {ev}"
        assert ev["ph"] in ("X", "i", "C", "M")
        assert ev["ts"] >= last_ts, "timestamps must be non-decreasing"
        last_ts = ev["ts"]
        if ev["ph"] == "X":
            assert ev["dur"] >= 0.0


# ---------------- recorder primitives ----------------

def test_recorder_schema_and_roundtrip(tmp_path):
    recs = {}
    for name, (_, _, O) in PKGS.items():
        rec = O.TraceRecorder()
        rec.span("p", "t", "a", 1.0, 0.5, cat="step", args={"k": 1})
        rec.span("p", "t", "b", 0.5, 0.25, cname=O.CNAMES["useful"])
        rec.instant("p", "t2", "evt", 0.75, cat="fault", args={"r": 2})
        rec.counter("p", "q", 2.0, {"depth": 3})
        rec.counter("p", "n", 2.5, 4)
        rec.extend([{"name": "x", "ph": "i", "s": "t", "ts": 3.0e6, "pid": "p", "tid": "t"}])
        recs[name] = rec
    rec = recs["port"]
    events = rec.events()
    _assert_perfetto_valid(events)
    assert events[0]["ts"] == pytest.approx(0.5e6)      # seconds in, microseconds out
    doc = rec.to_json()
    assert doc == recs["ref"].to_json()
    assert set(doc) >= {"traceEvents", "displayTimeUnit"}
    assert json.loads(json.dumps(doc)) == doc
    path = tmp_path / "sub" / "trace.json"
    rec.write(path)
    assert json.loads(path.read_text())["traceEvents"] == events
    assert CNAMES == RO.CNAMES


def test_recorder_clamps_negative_durations():
    rec = TraceRecorder()
    rec.span("p", "t", "x", 1.0, -0.5)
    assert rec.events()[0]["dur"] == 0.0


def test_null_recorder_is_disabled_and_inert():
    assert NULL_RECORDER.enabled is False
    NULL_RECORDER.span("p", "t", "x", 0.0, 1.0)
    NULL_RECORDER.instant("p", "t", "x", 0.0)
    NULL_RECORDER.counter("p", "x", 0.0, 1.0)
    NULL_RECORDER.extend([{"ts": 0.0}])
    assert NULL_RECORDER.events() == []
    # an empty *enabled* recorder is falsy (len 0) but must still record:
    # code paths guard on `is not None` / `.enabled`, never truthiness
    rec = TraceRecorder()
    assert len(rec) == 0 and rec.enabled


def test_wall_clock_is_epoch_seconds():
    t0 = clock.wall_s()
    assert t0 > 1.6e9 and clock.wall_span_s(t0) >= 0.0


# ---------------- metrics registry ----------------

def test_metrics_registry_counters_histograms_diff():
    snaps = {}
    for name, (_, _, O) in PKGS.items():
        reg = O.MetricsRegistry()
        reg.inc("a.b")
        reg.inc("a.b", 2)
        reg.set("gauge", 7.5)
        reg.observe("lat", 1.0)
        reg.observe("lat", 3.0)
        before = reg.snapshot()
        reg.inc("a.b", 5)
        reg.observe("lat", 0.5)
        reg.inc("new")
        snaps[name] = (before, reg.snapshot(), O.MetricsRegistry.diff(reg.snapshot(), before))
    assert snaps["port"] == snaps["ref"]
    before, _, d = snaps["port"]
    assert before["counters"]["a.b"] == 3.0 and before["counters"]["gauge"] == 7.5
    lat = before["histograms"]["lat"]
    assert lat["count"] == 2 and lat["total"] == 4.0
    assert lat["min"] == 1.0 and lat["max"] == 3.0
    assert d["counters"]["a.b"] == 5.0 and d["counters"]["new"] == 1.0
    assert d["histograms"]["lat"]["count"] == 1
    h = HistStat()
    assert h.as_dict()["count"] == 0
    h.observe(2.0)
    assert h.as_dict()["count"] == 1


def test_metrics_update_nested_flattens():
    reg = MetricsRegistry()
    reg.update_nested({"pricing": {"hits": 4, "misses": 1, "ok": True, "name": "x"}},
                      prefix="cache")
    snap = reg.snapshot()["counters"]
    assert snap == {"cache.pricing.hits": 4.0, "cache.pricing.misses": 1.0}


def test_simulator_metrics_registry(sim):
    before = sim.metrics_registry().snapshot()
    sim.run(_step_spec())
    reg = sim.metrics_registry()
    after = reg.snapshot()
    assert any(k.startswith("cache.") for k in after["counters"])
    assert any(k.startswith("ingest_extrap.") for k in after["counters"])
    assert sim.metrics_registry(reg) is reg
    d = MetricsRegistry.diff(after, before)
    assert d["counters"]["cache.block_times.hits"] + \
        d["counters"]["cache.block_times.misses"] > 0
    run_reg = MetricsRegistry()
    sim.run(_step_spec(), metrics=run_reg)
    assert run_reg.snapshot()["counters"]["sim.runs"] == 1.0


# ---------------- core step simulator ----------------

def test_core_run_bit_identical_and_traced(sim):
    spec = _step_spec()
    rep_off = Simulator("h100_sxm").run(spec)
    rec = TraceRecorder()
    rep_on = Simulator("h100_sxm").run(spec, recorder=rec)
    # recording forces keep_timelines, so compare the priced fields
    for f in ("step_time_us", "tokens_per_s", "tps_per_chip", "mfu", "breakdown_us",
              "kind_us"):
        assert getattr(rep_on, f) == getattr(rep_off, f), f
    events = rec.events()
    _assert_perfetto_valid(events)
    cats = {ev.get("cat") for ev in events if ev["ph"] == "X"}
    assert cats & {"compute", "comm"}
    # the same report through the reference's record_report gives the same trace
    ref_rec = RO.TraceRecorder()
    r_timeline.record_report(ref_rec, rep_on)
    assert ref_rec.to_json() == rec.to_json()
    # a disabled recorder takes the fast path
    assert sim.run(spec, recorder=NULL_RECORDER).block_timelines == {}


def test_report_explain_and_compact(sim):
    rep = sim.run(_step_spec())
    text = rep.explain()
    assert "top op" in text.lower() and "keep_timelines=True" in text
    d = rep.explain_dict()
    assert d["top_ops_by_time_us"] and d == RO.explain_report(rep)
    assert text == RO.render_report(rep)
    c = compact_report(rep)
    assert c == RO.compact_report(rep)
    assert set(c) >= {"dominant_phase", "compute_frac", "comm_frac"}
    assert 0.0 <= c["compute_frac"] <= 1.0


def test_critical_path_covers_timeline(sim):
    rep = sim.run(_step_spec(), keep_timelines=True)
    d = explain_report(rep)
    assert d["top_ops_by_time_us"][0][1] > 0.0
    tl = max(rep.block_timelines.values(), key=lambda t: t.total_time)
    cp = d["critical_path"]
    assert cp["n_ops"] == len(critical_path(tl))
    assert cp["total_us"] > 0.0
    assert "block_exposed_comm_us" in d and d["top_ops_by_comm_bytes"]
    # the same timeline-backed report explains alike in both packages
    assert d == RO.explain_report(rep)
    assert rep.explain() == RO.render_report(rep)
    assert [iv.name for iv in critical_path(tl)] == [iv.name for iv in RO.critical_path(tl)]


# ---------------- serving + fleet: one price table, both packages ----------------

@pytest.mark.parametrize("policy", ["continuous", "chunked", "disaggregated"])
def test_serving_trace_and_metrics_equal_the_reference(policy):
    recs = {name: O.TraceRecorder() for name, (_, _, O) in PKGS.items()}
    regs = {name: O.MetricsRegistry() for name, (_, _, O) in PKGS.items()}
    reps = serve_pair(POLICIES[policy], recorders=recs, metrics=regs)
    assert dataclasses.asdict(reps["port"]) == dataclasses.asdict(reps["ref"])
    assert recs["port"].to_json() == recs["ref"].to_json()
    assert regs["port"].snapshot() == regs["ref"].snapshot()
    assert reps["port"].explain_dict() == reps["ref"].explain_dict()
    assert reps["port"].explain() == reps["ref"].explain()
    assert TO.compact_serving(reps["port"]) == RO.compact_serving(reps["ref"])
    _assert_perfetto_valid(recs["port"].events())
    off = serve_pair(POLICIES[policy])["port"]
    assert dataclasses.asdict(off) == dataclasses.asdict(reps["port"])


def test_fleet_trace_and_metrics_equal_the_reference():
    out = {}
    for name, (A, S, O) in PKGS.items():
        spec = fleet_spec(n=150, rate=60.0, A=A, S=S, fleet=A.FleetSpec(
            replicas=3, router=A.RouterSpec("least_loaded"),
            faults=A.ReplicaFaultSpec(mtbf_s=1.5, restart_s=0.4, seed=7)))
        w = spec.workload
        rec, reg = O.TraceRecorder(max_request_lanes=32), O.MetricsRegistry()
        rep = S.FleetSimulator(pkg_sim(name), pkg_cfg(name), par=spec.parallel,
                               policy=S.DisaggregatedPD(prefill_batch=2, decode_batch=8),
                               fleet=w.fleet, oracle=oracle_for(name)).run(
            w.build(), slo=w.slo, recorder=rec, metrics=reg)
        out[name] = (rep, rec, reg)
    (rep, rec, reg), (r_rep, r_rec, r_reg) = out["port"], out["ref"]
    assert dataclasses.asdict(rep) == dataclasses.asdict(r_rep)
    assert rec.to_json() == r_rec.to_json()
    assert reg.snapshot() == r_reg.snapshot()
    assert rep.explain_dict() == r_rep.explain_dict()
    names = {ev["name"] for ev in rec.events()}
    assert {"kv_transfer", "charon:request_lanes_truncated"} <= names
    assert any(n.startswith("FAILURE r") for n in names) and "reroute" in names
    assert reg.snapshot()["counters"]["fleet.failures"] == len(rep.failure_trace)


def test_autoscaled_fleet_trace_equals_the_reference():
    recs = {}
    for name, (A, S, O) in PKGS.items():
        spec = fleet_spec(n=300, arrival="flash_crowd", rate=10.0, seed=2, flash_start_s=5.0,
                       flash_dur_s=15.0, flash_mult=12.0, A=A, S=S,
                       fleet=A.FleetSpec(replicas=1, autoscaler=A.AutoscalerSpec(
                           max_replicas=3, scale_up_queue=6.0, scale_down_queue=0.5,
                           interval_s=1.0, cooldown_s=3.0, provision_s=0.5)))
        w = spec.workload
        recs[name] = O.TraceRecorder()
        S.FleetSimulator(pkg_sim(name), pkg_cfg(name), par=spec.parallel,
                         policy=w.make_policy(), fleet=w.fleet,
                         oracle=oracle_for(name)).run(w.build(), slo=w.slo, recorder=recs[name])
    assert recs["port"].to_json() == recs["ref"].to_json()
    assert any(ev["tid"] == "autoscaler" for ev in recs["port"].events())


# ---------------- serving + fleet: the port's own oracle ----------------

def test_serving_bit_identical_with_recorder_and_metrics(sim):
    spec = _serving_spec()
    rep_off = ServingSimulator(sim).run(spec)
    rec, reg = TraceRecorder(), MetricsRegistry()
    rep_on = ServingSimulator(sim).run(spec, recorder=rec, metrics=reg)
    a, b = rep_on.summary(), rep_off.summary()
    a.pop("oracle_stats"), b.pop("oracle_stats")       # warm second run
    assert a == b and rep_on.requests == rep_off.requests
    _assert_perfetto_valid(rec.events())
    snap = reg.snapshot()["counters"]
    assert snap["serving.requests"] == spec.workload.n_requests
    assert snap["serving.steps"] > 0
    req_tids = {ev["tid"] for ev in rec.events() if ev["pid"].endswith("requests")}
    assert any(t.startswith("req") for t in req_tids)


def test_request_lane_truncation_is_loud(sim):
    spec = _serving_spec(n=40)
    rec, reg = TraceRecorder(max_request_lanes=4), MetricsRegistry()
    ServingSimulator(sim).run(spec, recorder=rec, metrics=reg)
    names = {ev["name"] for ev in rec.events()}
    assert "charon:request_lanes_truncated" in names
    assert reg.snapshot()["counters"]["trace.dropped_request_lanes"] == 40 - 4
    lanes = {ev["tid"] for ev in rec.events()
             if ev["pid"].endswith("requests") and ev["ph"] == "X"}
    assert len(lanes) == 4


def test_fleet_bit_identical_and_lanes(sim):
    fleet = FleetSpec(replicas=3, router=RouterSpec("least_loaded"))
    spec = _serving_spec(n=150, fleet=fleet)
    rep_off = ServingSimulator(sim).run(spec)
    rec, reg = TraceRecorder(), MetricsRegistry()
    rep_on = ServingSimulator(sim).run(spec, recorder=rec, metrics=reg)
    a, b = rep_on.summary(), rep_off.summary()
    a.pop("oracle_stats"), b.pop("oracle_stats")
    assert a == b
    events = rec.events()
    _assert_perfetto_valid(events)
    assert {"replica0", "replica1", "replica2"} <= {ev["pid"] for ev in events}
    assert reg.snapshot()["counters"]["fleet.requests"] == 150
    d = rep_on.explain_dict()
    assert "dominant_violation_cause" in d and json.loads(json.dumps(d)) == d


def test_serving_explain_names_dominant_cause(sim):
    rep = ServingSimulator(sim).run(_serving_spec(n=150, rate_rps=400.0))
    text = rep.explain()
    assert isinstance(text, str) and "dominant cause" in text
    d = rep.explain_dict()
    assert json.loads(json.dumps(d)) == d    # manifest-embeddable
    assert d["n_violating"] > 0 and d["dominant_violation_cause"] in d["slo_violation_cause"]
    assert compact_serving(rep)["slo_attainment"] == d["slo_attainment"]


# ---------------- chrome-trace exporter ----------------

def test_chrome_trace_truncation_is_loud(sim):
    rep = sim.run(_step_spec(), keep_timelines=True)
    tl = next(iter(rep.block_timelines.values()))
    reg = MetricsRegistry()
    events = t_timeline.to_chrome_trace(tl, expand_limit=2, metrics=reg)
    names = {ev["name"] for ev in events}
    assert "charon:trace_truncated" in names
    assert reg.snapshot()["counters"]["trace.dropped_intervals"] > 0
    full = t_timeline.to_chrome_trace(tl)
    assert len(full) > len(events)
    assert full == r_timeline.to_chrome_trace(tl)
    assert events == r_timeline.to_chrome_trace(tl, expand_limit=2)


def test_pp_trace_and_write_equal_the_reference(tmp_path):
    spec = SimSpec(CFG, cluster=Cluster("h100_sxm", chips=2),
                   parallel=ParallelConfig(pp=2, microbatches=4),
                   workload=TrainWorkload(global_batch=8, seq_len=256))
    rep = Simulator("h100_sxm").run(spec, keep_timelines=True)
    assert rep.pp is not None
    events = t_timeline.pp_trace(rep.pp)
    assert events and events == r_timeline.pp_trace(rep.pp)
    path = t_timeline.write_trace(events, tmp_path / "pp.json")
    assert json.loads(path.read_text())["traceEvents"] == events


def test_merge_traces_sorts():
    a = [{"name": "x", "ph": "i", "ts": 5.0, "pid": "p", "tid": "t", "s": "t"}]
    b = [{"name": "y", "ph": "i", "ts": 1.0, "pid": "p", "tid": "t", "s": "t"}]
    merged = t_timeline.merge_traces(a, b)
    assert [ev["ts"] for ev in merged] == [1.0, 5.0]
    assert merged == r_timeline.merge_traces(a, b)


# ---------------- memory report aliasing (regression) ----------------

def test_memory_timeline_is_immutable_tuple(sim):
    rep = sim.run(_step_spec())
    assert isinstance(rep.memory.timeline, tuple)
    for entry in rep.memory.timeline:
        assert isinstance(entry, tuple)


# ---------------- sweep ----------------

def test_sweep_metrics_trace_and_progress(sim, capsys):
    space = SweepSpace(_step_spec(), {"parallel.tp": (2,), "workload.global_batch": (16, 32, 64)})
    rec, reg = TraceRecorder(), MetricsRegistry()
    res = sweep(space, sim=sim, recorder=rec, metrics=reg, progress=True)
    err = capsys.readouterr().err
    assert "sweep 3/3" in err and "cfg/s" in err
    assert res.metrics["counters"]["sweep.configs_done"] == 3.0
    assert res.metrics["counters"]["sweep.evaluated"] == len(res.evaluated)
    events = rec.events()
    _assert_perfetto_valid(events)
    assert any(ev["tid"].startswith("worker") for ev in events)
    res_off = sweep(space, sim=sim)
    key = lambda r: r.cand.key()
    assert [key(r) for r in res.ranked()] == [key(r) for r in res_off.ranked()]
    assert res_off.metrics["counters"]["sweep.configs_done"] == 3.0


def test_sweep_manifest_rows_carry_explain(sim, tmp_path):
    space = SweepSpace(_step_spec(), {"workload.global_batch": (16, 32)})
    manifest = tmp_path / "m.json"
    res = sweep(space, sim=sim, manifest=str(manifest))
    doc = json.loads(manifest.read_text())
    assert doc["metrics"]["counters"]["sweep.configs_done"] == 2.0
    rows = [r for r in doc["candidates"] if not r["pruned"]]
    assert rows and all(r["explain"]["step"]["dominant_phase"] for r in rows)
    assert res.evaluated


def test_sweep_trace_lanes_equal_the_reference_with_one_price_table():
    """The sweep's trace (less its wall-clock spans) and counters through both
    packages over ``StubSim``: the same prune instants, lanes and names."""
    from test_torch_sweep import StubSim, counters_less_wall, space_pair
    out = {}
    for name, (A, _, O) in PKGS.items():
        rec, reg = O.TraceRecorder(), O.MetricsRegistry()
        res = A.sweep(space_pair("decode_h100")[name], sim=StubSim(name), recorder=rec,
                      metrics=reg)
        out[name] = ([(ev["name"], ev["ph"], ev["tid"], ev.get("args"))
                      for ev in rec.events() if ev["ph"] != "X"],
                     sorted((ev["name"], ev["tid"]) for ev in rec.events() if ev["ph"] == "X"),
                     counters_less_wall(res.metrics))
    assert out["port"] == out["ref"]
    assert out["port"][0] and out["port"][1]


# ---------------- the reference's own config: xlstm-125m, tp 2, tpu_v5e ----------------

def _xlstm_step_spec():
    from repro_torch.configs import get_config
    return SimSpec(get_config("xlstm-125m"), cluster=Cluster("tpu_v5e"),
                   parallel=ParallelConfig(tp=2),
                   workload=TrainWorkload(global_batch=32, seq_len=512))


def _xlstm_serving_spec(n=120):
    from repro_torch.configs import get_config
    return SimSpec(get_config("xlstm-125m"), cluster=Cluster("tpu_v5e"),
                   parallel=ParallelConfig(tp=2),
                   workload=ServingWorkload(n_requests=n, seed=3, rate_rps=48.0,
                                            slo=SLO(ttft_s=1.0, tpot_ms=50.0), **short(TS)))


def test_xlstm_core_run_bit_identical_traced_and_explained_as_the_reference():
    """The reference's step spec (xlstm-125m train B32 S512, tp 2, on
    ``tpu_v5e``): recording changes no priced field, the trace is
    Perfetto-valid and the reference's ``record_report`` and
    ``explain_report`` give the same of this report."""
    sim = Simulator("tpu_v5e", engine="analytical")
    spec = _xlstm_step_spec()
    rep_off = sim.run(spec)
    rec = TraceRecorder()
    rep_on = sim.run(spec, recorder=rec)
    for f in ("step_time_us", "tokens_per_s", "tps_per_chip", "mfu", "breakdown_us",
              "kind_us"):
        assert getattr(rep_on, f) == getattr(rep_off, f), f
    _assert_perfetto_valid(rec.events())
    ref_rec = RO.TraceRecorder()
    r_timeline.record_report(ref_rec, rep_on)
    assert ref_rec.to_json() == rec.to_json()
    assert rep_on.explain_dict() == RO.explain_report(rep_on)


def test_xlstm_serving_bit_identical_with_recorder_and_metrics():
    sim = Simulator("tpu_v5e", engine="analytical")
    spec = _xlstm_serving_spec()
    rep_off = ServingSimulator(sim).run(spec)
    rec, reg = TraceRecorder(), MetricsRegistry()
    rep_on = ServingSimulator(sim).run(spec, recorder=rec, metrics=reg)
    a, b = rep_on.summary(), rep_off.summary()
    a.pop("oracle_stats"), b.pop("oracle_stats")
    assert a == b and rep_on.requests == rep_off.requests
    _assert_perfetto_valid(rec.events())
    snap = reg.snapshot()["counters"]
    assert snap["serving.requests"] == spec.workload.n_requests
    assert snap["serving.steps"] > 0
