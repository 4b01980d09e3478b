"""``repro_torch.serving.sim`` against the reference's serving simulator, on
the CPU: the twin of ``tests/test_serving_sim.py``, its explorer goodput
objective included.

Parity is held in two layers:

* **The event loop, bit for bit.**  ``table_oracle`` subclasses each
  package's ``StepOracle`` and prices every bucketed step from one formula
  (``table_price``), so both packages see identical step prices; for the same
  workload, policy and SLO their ``ServingReport``s are then equal field for
  field (``dataclasses.asdict``), request timestamps included.
* **End to end, within ``STEP_TOL``.**  Each package's own analytical engine
  prices phi4-mini-3.8b at full width; their step times differ by up to
  -11 % (decode) and -5 % (prefill), which ``tests/test_torch_simulator.py``
  holds to ``STEP_TOL`` = 15 %, so makespan and TTFT percentiles of a trace
  whose requests all arrive at once (sums of step prices, no queueing
  feedback) are held to the same 15 %.

The reference's own twins use ``xlstm-125m`` on ``tpu_v5e``.  The cases that
need a real oracle use the dense phi4-mini-3.8b on ``h100_sxm`` (they came
before the port had xLSTM); the ``test_xlstm_*`` cases run the reference's own
config, ``CFG = get_config("xlstm-125m")`` with ``tp=2`` on ``tpu_v5e``, with
the reference's assertions, and hold the trace's makespan and TTFT to the
reference's within ``STEP_TOL``.
"""
import dataclasses
import functools
import warnings

import numpy as np
import pytest

import repro.serving.sim as RS
import repro_torch.serving.sim as TS
from repro.api import (
    Cluster as RCluster, ServingWorkload as RServing, SimSpec as RSpec,
)
from repro.configs import get_config as r_config
from repro.core import ParallelConfig as RPar, Simulator as RSim
from repro.serving import sp_planner as r_sp
from repro_torch.api import (
    CharonDeprecationWarning, Cluster, DecodeWorkload, ServingWorkload, SimSpec, SweepSpace,
    sweep,
)
from repro_torch.configs import get_config
from repro_torch.core import ParallelConfig, Simulator
from repro_torch.core.backend.hardware import H100_SXM, TPU_V5E
from repro_torch.serving import sp_planner as t_sp
from repro_torch.serving.sim import (
    SLO, ChunkedPrefill, ContinuousBatching, DisaggregatedPD, LengthDist, Pool,
    ServingSimulator, StaticBatching, Workload, pow2_bucket, synthesize,
)
from repro_torch.serving.sim.workload import SimRequest

ARCH = "phi4-mini-3.8b"
CFG = get_config(ARCH)
PAR = ParallelConfig()
STEP_TOL = 0.15      # tests/test_torch_simulator.py's step-time gap, phi4-mini prefill/decode
PKGS = {"ref": RS, "port": TS}


@pytest.fixture(scope="module")
def sim():
    # module-scoped: the serving oracle's misses (cold simulate calls) are
    # the slow part; every test after the first runs warm
    return Simulator("h100_sxm", engine="analytical")


# ---------------- the shared price table ----------------

def table_price(mode: str, B: int, S: int, cache_len: int) -> float:
    """Seconds for one bucketed step: a deterministic stand-in for the
    simulator, the same in both packages."""
    if mode == "decode":
        return (3.0 + 0.25 * B + cache_len / 512) * 1e-3
    return (1.5 + B * S / 128) * 1e-3


@functools.cache
def table_oracle(S):
    """``S.StepOracle`` subclass pricing bucketed steps from ``table_price``;
    its ``stats()`` count table hits and misses as the sim cache would."""
    class TableOracle(S.StepOracle):
        def __post_init__(self):
            super().__post_init__()
            self.table, self.hits, self.misses = {}, 0, 0

        def _priced_s(self, mode, B, S_, cache_len):
            self.lookups += 1
            key = (mode, B, S_, cache_len)
            if key in self.table:
                self.hits += 1
            else:
                self.misses += 1
                self.table[key] = table_price(*key)
            return self.table[key]

        @property
        def n_distinct_steps(self) -> int:
            return len(self.table)

        def stats(self) -> dict:
            return {"hits": self.hits, "misses": self.misses}

    return TableOracle


@functools.cache
def pkg_sim(name):
    """A plain Simulator of each package: the table oracle only reads its
    hardware and cache switch."""
    return RSim("h100_sxm") if name == "ref" else Simulator("h100_sxm")


def pkg_cfg(name):
    return r_config(ARCH) if name == "ref" else CFG


def oracle_for(name, ctx_floor=256):
    S, par = PKGS[name], (RPar() if name == "ref" else ParallelConfig())
    return table_oracle(S)(pkg_sim(name), pkg_cfg(name), par, ctx_floor=ctx_floor)


def short(S):
    return dict(prompt=S.LengthDist("lognormal", median=64.0, sigma=0.6, cap=256),
                output=S.LengthDist("lognormal", median=12.0, sigma=0.5, cap=48))


def _wl(S=TS, n=80, seed=3, rate=40.0):
    return S.synthesize(n, rate_rps=rate, seed=seed, **short(S))


def serve_pair(policy, *, wl=None, slo=(1.0, 50.0), ctx_floor=256, recorders=None,
               metrics=None):
    """The same workload, policy and SLO through both packages' event loops
    over the table oracle; returns {"ref": report, "port": report}."""
    out = {}
    for name, S in PKGS.items():
        w = wl(S) if wl is not None else _wl(S)
        ssim = S.ServingSimulator(pkg_sim(name), pkg_cfg(name), policy=policy(S),
                                  oracle=oracle_for(name, ctx_floor))
        out[name] = ssim.run(w, slo=S.SLO(*slo) if slo else None,
                             recorder=recorders[name] if recorders else None,
                             metrics=metrics[name] if metrics else None)
    return out


def _reqs(wl):
    return [(r.rid, r.arrival_s, r.prompt_len, r.output_len, r.session) for r in wl.requests]


# ---------------- workload generation ----------------

ARRIVALS = {
    "poisson": dict(rate_rps=40.0),
    "uniform": dict(rate_rps=20.0),
    "bursty": dict(rate_rps=25.0, burst_factor=3.0, switch_prob=0.2),
    "diurnal": dict(rate_rps=20.0, period_s=40.0, diurnal_amp=0.9),
    "flash_crowd": dict(rate_rps=10.0, flash_start_s=2.0, flash_dur_s=3.0, flash_mult=8.0),
}


@pytest.mark.parametrize("arrival", list(ARRIVALS))
def test_synthesize_equals_the_reference_request_for_request(arrival):
    for seed, sessions in ((0, 0), (7, 5)):
        got = {name: S.synthesize(120, arrival=arrival, seed=seed, sessions=sessions,
                                  start_s=0.5, **ARRIVALS[arrival], **short(S))
               for name, S in PKGS.items()}
        assert _reqs(got["port"]) == _reqs(got["ref"])
    lengths = [LengthDist("fixed", value=33), LengthDist("uniform", lo=3, hi=900)]
    r_lengths = [RS.LengthDist("fixed", value=33), RS.LengthDist("uniform", lo=3, hi=900)]
    t = synthesize(50, arrival=arrival, prompt=lengths[0], output=lengths[1], seed=2,
                   **ARRIVALS[arrival])
    r = RS.synthesize(50, arrival=arrival, prompt=r_lengths[0], output=r_lengths[1], seed=2,
                      **ARRIVALS[arrival])
    assert _reqs(t) == _reqs(r)


def test_workload_determinism():
    key = lambda wl: [(r.arrival_s, r.prompt_len, r.output_len) for r in wl.requests]
    assert key(_wl(seed=5)) == key(_wl(seed=5))
    assert key(_wl(seed=5)) != key(_wl(seed=6))
    wl = _wl(seed=5)
    arrivals = [r.arrival_s for r in wl.requests]
    assert arrivals == sorted(arrivals)
    assert all(r.prompt_len >= 1 and r.output_len >= 1 for r in wl.requests)
    with pytest.raises(ValueError):
        synthesize(3, arrival="nonsense")
    with pytest.raises(ValueError):
        synthesize(3, prompt=LengthDist("nonsense"))


def test_bursty_and_uniform_arrivals():
    for arrival in ("bursty", "uniform"):
        wl = synthesize(50, arrival=arrival, rate_rps=20.0, seed=1)
        arrivals = [r.arrival_s for r in wl.requests]
        assert arrivals == sorted(arrivals) and len(set(arrivals)) > 1


def test_trace_replay_and_shard():
    rows = [(2.0, 5, 3), (0.5, 7, 1), (1.0, 2, 2), (1.0, 0, 9)]
    wl = Workload.from_trace(rows)
    assert [r.arrival_s for r in wl.requests] == [0.5, 1.0, 1.0, 2.0]
    assert [r.prompt_len for r in wl.requests] == [7, 2, 1, 5]
    half = wl.shard(2)
    assert [r.rid for r in half.requests] == [0, 2]
    assert [r.rid for r in wl.shard(2, offset=1).requests] == [1, 3]
    # sharded copies are reset clones, not aliases
    half.requests[0].decoded = 99
    assert wl.requests[0].decoded == 0
    # and all of it equals the reference, request for request
    ref = RS.Workload.from_trace(rows)
    assert _reqs(wl) == _reqs(ref)
    for k, off in ((1, 0), (2, 1), (3, 2)):
        assert _reqs(wl.shard(k, off)) == _reqs(ref.shard(k, off))
    assert (wl.n_requests, wl.prompt_tokens, wl.output_tokens, wl.duration_s) == \
        (ref.n_requests, ref.prompt_tokens, ref.output_tokens, ref.duration_s)


def test_thin_is_deprecated_shard():
    wl = Workload.from_trace([(0.5, 7, 1), (1.0, 2, 2), (2.0, 5, 3)])
    with pytest.warns(CharonDeprecationWarning):
        thinned = wl.thin(2)
    assert ([(r.rid, r.arrival_s, r.prompt_len) for r in thinned.requests]
            == [(r.rid, r.arrival_s, r.prompt_len) for r in wl.shard(2).requests])


def test_thin_external_call_warns_and_matches_shard():
    """thin() under default filters: exactly one warning, results equal to
    shard() and to the reference's thin()."""
    wl = synthesize(40, arrival="bursty", rate_rps=25.0, seed=7)
    ref = RS.synthesize(40, arrival="bursty", rate_rps=25.0, seed=7)
    for offset in (0, 1):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("default")   # external-style filters
            thinned = wl.thin(3, offset)
            r_thinned = ref.thin(3, offset)
        ours = [w for w in caught if issubclass(w.category, CharonDeprecationWarning)]
        assert len(ours) == 1
        assert "FleetSpec(replicas=k)" in str(ours[0].message)
        assert _reqs(thinned) == _reqs(wl.shard(3, offset)) == _reqs(r_thinned)
        assert all(r.decoded == 0 for r in thinned.requests)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        t = wl.thin(2)
    t.requests[0].decoded = 123
    assert wl.requests[0].decoded == 0
    with warnings.catch_warnings():
        warnings.simplefilter("error", CharonDeprecationWarning)
        with pytest.raises(CharonDeprecationWarning):
            wl.thin(2)


def test_pow2_bucket():
    assert [pow2_bucket(n) for n in (1, 2, 3, 5, 8, 9)] == [1, 2, 4, 8, 8, 16]
    assert pow2_bucket(3, floor=64) == 64
    assert pow2_bucket(100, floor=64) == 128
    for floor in (1, 16, 256, 2048):
        for n in (-3, 0, 1, 2, 3, 15, 16, 17, 255, 256, 257, 1023, 1024, 1025, 4097):
            assert pow2_bucket(n, floor) == RS.pow2_bucket(n, floor)


def test_virtual_clock_is_the_one_the_engine_shares():
    from repro_torch import serving
    from repro_torch.serving import engine
    assert serving.VirtualClock is engine.VirtualClock is TS.VirtualClock
    clk = TS.VirtualClock(1.0)
    clk.advance_to(2.5)
    assert clk() == 2.5
    with pytest.raises(ValueError):
        clk.advance_to(2.0)
    assert TS.wall_clock() > 0


# ---------------- event-loop parity with one price table ----------------

POLICIES = {
    "continuous": lambda S: S.ContinuousBatching(8),
    "continuous_cap2": lambda S: S.ContinuousBatching(8, admit_cap=2),
    "continuous_cap1": lambda S: S.ContinuousBatching(8, admit_cap=1),
    "chunked": lambda S: S.ChunkedPrefill(8, token_budget=128),
    "static": lambda S: S.StaticBatching(8),
    "disaggregated": lambda S: S.DisaggregatedPD(prefill_batch=2, decode_batch=8,
                                                 transfer_s=0.002),
}


@pytest.mark.parametrize("policy", list(POLICIES))
def test_reports_equal_the_reference_with_one_price_table(policy):
    reps = serve_pair(POLICIES[policy])
    ref, port = reps["ref"], reps["port"]
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    stamps = lambda rep: [(r.rid, r.enqueue_s, r.start_s, r.first_token_s, r.finished_s)
                          for r in rep.requests]
    assert stamps(port) == stamps(ref)
    assert port.summary() == ref.summary()
    assert port.n_requests == 80 and port.oracle_stats["misses"] > 0


def test_reports_equal_the_reference_on_a_trace_and_without_slo():
    rows = [(0.0, 874, 32), (0.0, 305, 32), (0.0, 951, 32), (0.1, 163, 5), (0.3, 40, 1)]
    for slo in (None, (0.05, 4.0)):
        reps = serve_pair(POLICIES["continuous_cap1"], slo=slo, ctx_floor=1024,
                          wl=lambda S: S.Workload.from_trace(rows))
        assert dataclasses.asdict(reps["port"]) == dataclasses.asdict(reps["ref"])
        assert reps["port"].slo_attainment == (1.0 if slo is None else reps["ref"].slo_attainment)


# ---------------- event-loop conservation (the port's own oracle) ----------------

CONSERVATION = [
    ContinuousBatching(8),
    ContinuousBatching(8, admit_cap=2),
    ChunkedPrefill(8, token_budget=128),
    StaticBatching(8),
    DisaggregatedPD(prefill_batch=2, decode_batch=8, transfer_s=0.002),
]


@pytest.mark.parametrize("policy", CONSERVATION, ids=lambda p: p.name)
def test_conservation_invariants(sim, policy):
    wl = _wl()
    rep = ServingSimulator(sim, CFG, par=PAR, policy=policy).run(
        wl, slo=SLO(ttft_s=1.0, tpot_ms=50.0))
    # every submitted request finishes exactly once
    assert rep.n_requests == wl.n_requests
    assert sorted(r.rid for r in rep.requests) == sorted(r.rid for r in wl.requests)
    for r in rep.requests:
        assert r.prefilled == r.prompt_len
        assert r.decoded == r.output_len
        assert r.arrival_s <= r.start_s <= r.first_token_s <= r.finished_s
    # token conservation
    assert rep.prompt_tokens == wl.prompt_tokens
    assert rep.output_tokens == wl.output_tokens
    # the workload itself is never mutated (runs operate on reset copies)
    assert all(r.decoded == 0 and r.finished_s is None for r in wl.requests)


def test_run_is_deterministic(sim):
    wl = _wl(seed=9)
    ssim = ServingSimulator(sim, CFG, par=PAR, policy=ContinuousBatching(8))
    a, b = ssim.run(wl).summary(), ssim.run(wl).summary()
    a.pop("oracle_stats"), b.pop("oracle_stats")  # hit/miss split differs
    assert a == b


def test_disaggregated_pool_roles(sim):
    rep = ServingSimulator(
        sim, CFG, par=PAR,
        policy=DisaggregatedPD(prefill_batch=2, decode_batch=8)).run(_wl())
    assert set(rep.utilization) == {"prefill", "decode"}
    assert "decode_frac" not in rep.utilization["prefill"]
    assert "prefill_frac" not in rep.utilization["decode"]


def test_run_needs_a_model_or_a_spec(sim):
    with pytest.raises(TypeError, match="SimSpec"):
        ServingSimulator(sim).run(_wl(n=3))
    spec = SimSpec(CFG, cluster=Cluster("h100_sxm"), workload=ServingWorkload(n_requests=3))
    with pytest.raises(ValueError, match="cluster hardware"):
        ServingSimulator(Simulator("a100_80g")).run(spec)
    with pytest.raises(TypeError, match="needs a ServingWorkload"):
        from repro_torch.api import DecodeWorkload
        ServingSimulator(sim).run(SimSpec(CFG, workload=DecodeWorkload()))


# ---------------- policy unit behaviour (no oracle) ----------------

def _fake_reqs(n, prompt_len=100):
    return [SimRequest(rid=i, arrival_s=0.0, prompt_len=prompt_len, output_len=4)
            for i in range(n)]


def test_static_waits_for_full_gang():
    pool = Pool("p", None)
    pool.queue.extend(_fake_reqs(2))
    pool.pending_arrivals = 5
    pol = StaticBatching(4)
    assert pol.plan(pool, 0.0) is None          # more arrivals may top it up
    pool.pending_arrivals = 0
    plan = pol.plan(pool, 0.0)                  # drain: partial gang admitted
    assert plan.kind == "prefill" and len(plan.prefill) == 2
    assert pol.plan(pool, 0.0) is None          # cohort in flight: no re-admit


def test_chunked_prefill_respects_token_budget():
    pool = Pool("p", None)
    pool.running.extend(_fake_reqs(3))
    pool.queue.extend(_fake_reqs(1, prompt_len=500))
    pol = ChunkedPrefill(max_batch=8, token_budget=16)
    plan = pol.plan(pool, 0.0)
    assert plan.kind == "mixed"
    assert len(plan.decode) == 3
    [(head, chunk)] = plan.prefill
    assert chunk == 16 - 3                      # decode tokens eat the budget
    head.prefilled += chunk
    plan2 = pol.plan(pool, 0.0)                 # same head keeps chunking
    assert plan2.prefill[0][0] is head


def test_continuous_admission_cap():
    pool = Pool("p", None)
    pool.queue.extend(_fake_reqs(6))
    plan = ContinuousBatching(8, admit_cap=2).plan(pool, 0.0)
    assert plan.kind == "prefill" and len(plan.prefill) == 2
    # admit_cap=1 is the port's engine schedule: one batch-1 prefill a step
    pool1 = Pool("p", None)
    pool1.queue.extend(_fake_reqs(3))
    pol = ContinuousBatching(8, admit_cap=1)
    kinds = []
    for _ in range(3):
        plan = pol.plan(pool1, 0.0)
        kinds.append((plan.kind, len(plan.prefill)))
        pool1.running.extend(pool1.prefilling)
        pool1.prefilling.clear()
    assert kinds == [("prefill", 1)] * 3
    assert pol.plan(pool1, 0.0).kind == "decode"


def test_make_policy_names():
    from repro_torch.serving.sim.policies import make_policy
    assert isinstance(make_policy("continuous", 4), ContinuousBatching)
    assert make_policy("chunked", 4, token_budget=64).token_budget == 64
    assert make_policy("static", 4).batch_size == 4
    with pytest.raises(ValueError):
        make_policy("nonsense", 4)


# ---------------- oracle memoization (the port's own oracle) ----------------

def test_oracle_memoization_across_sweep():
    s = Simulator("h100_sxm", engine="analytical")
    ssim = ServingSimulator(s, CFG, par=PAR, policy=ContinuousBatching(8))
    wl = _wl(n=60)
    first = ssim.run(wl)
    # bucketing keeps distinct step keys tiny vs thousands of lookups
    assert first.oracle_stats["hits"] > 20 * first.oracle_stats["misses"]
    second = ssim.run(wl)
    assert second.oracle_stats["misses"] == 0   # fully served from SimCache
    assert second.oracle_stats["hit_rate"] == 1.0
    assert s.cache_stats()["serving"]["hits"] > 0


def test_oracle_invalidated_on_engine_state_mutation():
    # profile-then-resimulate must never serve stale priced steps from the
    # serving bucket
    from repro_torch.core.backend.profiling import ProfileDB

    db = ProfileDB(path="/nonexistent/empty.json")
    s = Simulator("h100_sxm", engine="profiling", db=db)
    ssim = ServingSimulator(s, CFG, par=PAR, policy=ContinuousBatching(8))
    wl = _wl(n=20)
    ssim.run(wl)
    misses0 = s.cache_stats()["serving"]["misses"]
    db.put("h100_sxm|matmul|1,1,1|bf16", 1.0, {})   # any external put
    second = ssim.run(wl)
    # the version bump keys every step lookup afresh (no stale hits)
    assert second.oracle_stats["misses"] > 0
    assert s.cache_stats()["serving"]["misses"] > misses0


def test_oracle_front_memos_evict_and_respect_cache_toggle(sim):
    from repro_torch.serving.sim.oracle import StepOracle

    oracle = StepOracle(sim, CFG, PAR)
    oracle.decode_step_s(4, 300)
    oracle.prefill_s(2, 128)
    assert len(oracle._raw) == 2 and len(oracle._price) == 2
    assert oracle.n_distinct_steps == 2
    # a state-version change evicts stale front-memo entries wholesale
    orig = sim.engine._state_version
    sim.engine._state_version = lambda: ("bumped",)
    try:
        oracle.decode_step_s(4, 300)
        assert len(oracle._raw) == 1 and len(oracle._price) == 1
    finally:
        sim.engine._state_version = orig
    # with the sim cache disabled the memos are never populated
    s2 = Simulator("h100_sxm", engine="analytical")
    s2.cache.enabled = False
    o2 = StepOracle(s2, CFG, PAR)
    o2.decode_step_s(4, 300)
    o2.prefill_s(2, 128)
    assert not o2._raw and not o2._price


def test_oracle_prices_are_the_simulators_bucketed_steps(sim):
    from repro_torch.api import DecodeWorkload, PrefillWorkload
    from repro_torch.serving.sim.oracle import StepOracle

    oracle = StepOracle(sim, CFG, PAR, ctx_floor=1024)
    d = sim.run(SimSpec(CFG, cluster=Cluster("h100_sxm"),
                        workload=DecodeWorkload(global_batch=8, seq_len=1024, cache_len=1024)))
    p = sim.run(SimSpec(CFG, cluster=Cluster("h100_sxm"),
                        workload=PrefillWorkload(global_batch=1, seq_len=512)))
    assert oracle.decode_step_s(5, 700) == d.step_time_us / 1e6
    assert oracle.prefill_s(1, 300) == p.step_time_us / 1e6
    assert oracle.mixed_step_s(5, 700, 300) == oracle.prefill_s(1, 300) + oracle.decode_step_s(5, 700)
    assert oracle.mixed_step_s(0, 0, 300) == oracle.prefill_s(1, 300)


# ---------------- specs ----------------

def _serving_spec_pairs():
    out = []
    for kw in (dict(), dict(n_requests=12, arrival="bursty", rate_rps=3.0, policy="chunked",
                            max_batch=8, token_budget=64, ctx_floor=1024, seed=5),
               dict(trace=((0.0, 874, 32), (0.0, 305, 32)), policy="continuous", max_batch=8)):
        r = RSpec(r_config(ARCH), cluster=RCluster("h100_sxm"), workload=RServing(**kw))
        t = SimSpec(CFG, cluster=Cluster("h100_sxm"), workload=ServingWorkload(**kw))
        out.append((r, t))
    r = RSpec(r_config(ARCH), cluster=RCluster("h100_sxm"),
              workload=RServing(prompt=RS.LengthDist("uniform", lo=16, hi=1024),
                                output=RS.LengthDist("fixed", value=32),
                                slo=RS.SLO(ttft_s=0.5, tpot_ms=40.0)))
    t = SimSpec(CFG, cluster=Cluster("h100_sxm"),
                workload=ServingWorkload(prompt=LengthDist("uniform", lo=16, hi=1024),
                                         output=LengthDist("fixed", value=32),
                                         slo=SLO(ttft_s=0.5, tpot_ms=40.0)))
    out.append((r, t))
    return out


def test_serving_specs_hash_and_round_trip_as_the_reference():
    pairs = _serving_spec_pairs()
    for rs, ts in pairs:
        assert ts.to_json() == rs.to_json()
        assert ts.json_hash() == rs.json_hash()
        back = SimSpec.from_json(rs.to_json())
        assert back == ts and back.json_hash() == rs.json_hash() and hash(back) == hash(ts)
        assert SimSpec.from_dict(dataclasses.asdict(ts)) == ts
        assert RSpec.from_json(ts.to_json()) == rs
        assert ts.B_local() == rs.B_local() and ts.trace_shapes() == rs.trace_shapes()
        assert _reqs(ts.workload.build()) == _reqs(rs.workload.build())
    assert len({ts.json_hash() for _, ts in pairs}) == len(pairs)


def test_spec_run_equals_the_inner_simulator(sim):
    spec = SimSpec(CFG, cluster=Cluster("h100_sxm"),
                   workload=ServingWorkload(n_requests=40, rate_rps=30.0, seed=4, max_batch=8,
                                            ctx_floor=512, **short(TS)))
    w = spec.workload
    via_spec = ServingSimulator(sim).run(spec)
    direct = ServingSimulator(sim, CFG, policy=w.make_policy(), ctx_floor=w.ctx_floor).run(
        w.build(), slo=w.slo)
    a, b = via_spec.summary(), direct.summary()
    a.pop("oracle_stats"), b.pop("oracle_stats")
    assert a == b and via_spec.requests == direct.requests
    scen = w.scenario()
    assert isinstance(scen, TS.ServingScenario) and scen.fleet is None
    assert scen.ctx_floor == 512 and scen.make_policy(4).max_batch == 4


# ---------------- end to end: each package's own simulator ----------------

def test_phi4_mini_trace_within_the_step_gap_of_the_reference(sim):
    """The 12-request trace that chip_smoke.py serves on the card (numpy seed
    0, prompts 16-1024, 32 new tokens, all arriving at once), with the
    engine's schedule (8 slots, one batch-1 prefill a step), priced by each
    package's analytical engine on h100_sxm: makespan and TTFT percentiles
    within STEP_TOL of the reference's."""
    rng = np.random.default_rng(0)
    rows = []
    for _ in range(12):
        plen = int(rng.integers(16, 1025))
        rng.integers(0, CFG.vocab_size, plen)
        rows.append((0.0, plen, 32))
    reps = {}
    for name, S in PKGS.items():
        s = sim if name == "port" else RSim("h100_sxm", engine="analytical")
        reps[name] = S.ServingSimulator(s, pkg_cfg(name),
                                        policy=S.ContinuousBatching(8, admit_cap=1)).run(
            S.Workload.from_trace(rows))
    ref, port = reps["ref"], reps["port"]
    assert port.steps_by_kind == ref.steps_by_kind == {"prefill": 12, "decode": 62}
    assert port.makespan_s == pytest.approx(ref.makespan_s, rel=STEP_TOL)
    for p in ("p50", "p90", "p99", "mean", "max"):
        assert getattr(port.ttft_s, p) == pytest.approx(getattr(ref.ttft_s, p), rel=STEP_TOL)
        assert getattr(port.tpot_ms, p) == pytest.approx(getattr(ref.tpot_ms, p), rel=STEP_TOL)
    assert port.output_tokens_per_s == pytest.approx(ref.output_tokens_per_s, rel=STEP_TOL)


# ---------------- sequence-parallel planner ----------------

def test_sp_planner_equals_the_reference_and_defaults_to_h100():
    from repro.core.backend.hardware import HARDWARE as R_HW
    for hw, r_hw in ((TPU_V5E, R_HW["tpu_v5e"]), (H100_SXM, R_HW["h100_sxm"])):
        for S in (256, 4096, 32768):
            for sp, zz in ((1, False), (4, True), (8, False)):
                assert t_sp.attention_latency_us(S, sp, zigzag=zz, d_head=128, n_heads=24,
                                                 hw=hw) == \
                    r_sp.attention_latency_us(S, sp, zigzag=zz, d_head=128, n_heads=24,
                                              hw=r_hw)
            assert dataclasses.asdict(t_sp.plan_request(S, d_head=128, n_heads=24, hw=hw)) == \
                dataclasses.asdict(r_sp.plan_request(S, d_head=128, n_heads=24, hw=r_hw))
        lens = [128, 512, 2048, 8192, 300, 40000]
        for dynamic in (True, False):
            assert dataclasses.asdict(t_sp.plan_batch(lens, d_head=128, n_heads=24, hw=hw,
                                                      dynamic=dynamic)) == \
                dataclasses.asdict(r_sp.plan_batch(lens, d_head=128, n_heads=24, hw=r_hw,
                                                   dynamic=dynamic))
    assert t_sp.plan_request(4096, d_head=128, n_heads=24) == \
        t_sp.plan_request(4096, d_head=128, n_heads=24, hw=H100_SXM)
    dyn = t_sp.plan_batch([256] * 6 + [32768], d_head=128, n_heads=24)
    static = t_sp.plan_batch([256] * 6 + [32768], d_head=128, n_heads=24, dynamic=False)
    assert dyn.makespan_us < static.makespan_us


# ---------------- explorer goodput objective ----------------

def test_goodput_ranking_diverges_from_step_time(sim):
    """Under heavy load small batches win on step time but starve admission.
    phi4-mini's decode step on ``h100_sxm`` is ~3-4 ms against xlstm-125m's
    sub-millisecond one on ``tpu_v5e``, so the reference's SLO (50 ms TTFT,
    2 ms TPOT) is scaled by ten; the load is the reference's."""
    scen = ServingWorkload(
        n_requests=160, rate_rps=2000.0,
        prompt=LengthDist("lognormal", median=64.0, sigma=0.5, cap=256),
        output=LengthDist("fixed", value=24), seed=11, slo=SLO(ttft_s=0.5, tpot_ms=20.0))
    base = SimSpec(CFG, cluster=Cluster("h100_sxm", chips=8),
                   workload=DecodeWorkload(seq_len=512))
    res = sweep(SweepSpace(base, {"tp": (1, 2), "pp": (1,), "batch": (8, 32)}),
                sim=sim, objective="goodput", scenario=scen)
    assert res.evaluated and all(r.serving is not None for r in res.evaluated)
    by_step = res.ranked("step_time")
    by_goodput = res.ranked("goodput")
    assert [r.cand.key() for r in by_step] != [r.cand.key() for r in by_goodput]
    assert by_goodput[0].goodput_rps > by_step[0].goodput_rps
    assert by_goodput[0].cand.global_batch > by_step[0].cand.global_batch


def test_step_time_objective_requires_no_serving(sim):
    base = SimSpec(CFG, cluster=Cluster("h100_sxm", chips=4),
                   workload=DecodeWorkload(seq_len=512))
    space = SweepSpace(base, {"tp": (1, 2), "pp": (1,), "batch": (8,)})
    res = sweep(space, sim=sim)
    assert res.ranked("step_time")
    with pytest.raises(ValueError):
        res.ranked("goodput")
    with pytest.raises(ValueError):
        sweep(space, sim=sim, objective="nonsense")


# ---------------- the reference's own config: xlstm-125m, tp 2, tpu_v5e ----------------

XLSTM = get_config("xlstm-125m")
XPAR = ParallelConfig(tp=2)


@pytest.fixture(scope="module")
def tpu_sim():
    return Simulator("tpu_v5e", engine="analytical")


@pytest.mark.parametrize("policy", CONSERVATION, ids=lambda p: p.name)
def test_xlstm_conservation_invariants(tpu_sim, policy):
    wl = _wl()
    rep = ServingSimulator(tpu_sim, XLSTM, par=XPAR, policy=policy).run(
        wl, slo=SLO(ttft_s=1.0, tpot_ms=50.0))
    assert rep.n_requests == wl.n_requests
    assert sorted(r.rid for r in rep.requests) == sorted(r.rid for r in wl.requests)
    for r in rep.requests:
        assert r.prefilled == r.prompt_len
        assert r.decoded == r.output_len
        assert r.arrival_s <= r.start_s <= r.first_token_s <= r.finished_s
    assert rep.prompt_tokens == wl.prompt_tokens
    assert rep.output_tokens == wl.output_tokens
    assert all(r.decoded == 0 and r.finished_s is None for r in wl.requests)


def test_xlstm_run_is_deterministic(tpu_sim):
    wl = _wl(seed=9)
    ssim = ServingSimulator(tpu_sim, XLSTM, par=XPAR, policy=ContinuousBatching(8))
    a, b = ssim.run(wl).summary(), ssim.run(wl).summary()
    a.pop("oracle_stats"), b.pop("oracle_stats")
    assert a == b


def test_xlstm_disaggregated_pool_roles(tpu_sim):
    rep = ServingSimulator(
        tpu_sim, XLSTM, par=XPAR,
        policy=DisaggregatedPD(prefill_batch=2, decode_batch=8)).run(_wl())
    assert set(rep.utilization) == {"prefill", "decode"}
    assert "decode_frac" not in rep.utilization["prefill"]
    assert "prefill_frac" not in rep.utilization["decode"]


def test_xlstm_trace_within_the_step_gap_of_the_reference(tpu_sim):
    """Each package's own analytical engine on the reference's config and
    workload: the same requests and tokens, makespan and TTFT p50 within
    ``STEP_TOL`` (measured -0.2 % and 0 %)."""
    ref = RS.ServingSimulator(RSim("tpu_v5e", engine="analytical"), r_config("xlstm-125m"),
                              par=RPar(tp=2), policy=RS.ContinuousBatching(8)).run(
        _wl(RS), slo=RS.SLO(ttft_s=1.0, tpot_ms=50.0))
    rep = ServingSimulator(tpu_sim, XLSTM, par=XPAR, policy=ContinuousBatching(8)).run(
        _wl(), slo=SLO(ttft_s=1.0, tpot_ms=50.0))
    assert (rep.n_requests, rep.prompt_tokens, rep.output_tokens) == \
        (ref.n_requests, ref.prompt_tokens, ref.output_tokens)
    r, t = ref.summary(), rep.summary()
    for key in ("makespan_s", "ttft_p50_s"):
        assert t[key] == pytest.approx(r[key], rel=STEP_TOL), key


def test_xlstm_goodput_ranking_diverges_from_step_time(tpu_sim):
    """The reference's scenario and SLO (50 ms TTFT, 2 ms TPOT) on its
    config and cluster."""
    scen = ServingWorkload(
        n_requests=160, rate_rps=2000.0,
        prompt=LengthDist("lognormal", median=64.0, sigma=0.5, cap=256),
        output=LengthDist("fixed", value=24), seed=11, slo=SLO(ttft_s=0.05, tpot_ms=2.0))
    base = SimSpec(XLSTM, cluster=Cluster("tpu_v5e", chips=8),
                   workload=DecodeWorkload(seq_len=512))
    res = sweep(SweepSpace(base, {"tp": (1, 2), "pp": (1,), "batch": (8, 32)}),
                sim=tpu_sim, objective="goodput", scenario=scen)
    assert res.evaluated and all(r.serving is not None for r in res.evaluated)
    by_step = res.ranked("step_time")
    by_goodput = res.ranked("goodput")
    assert [r.cand.key() for r in by_step] != [r.cand.key() for r in by_goodput]
    assert by_goodput[0].goodput_rps > by_step[0].goodput_rps
    assert by_goodput[0].cand.global_batch > by_step[0].cand.global_batch


def test_xlstm_step_time_objective_requires_no_serving(tpu_sim):
    base = SimSpec(XLSTM, cluster=Cluster("tpu_v5e", chips=4),
                   workload=DecodeWorkload(seq_len=512))
    space = SweepSpace(base, {"tp": (1, 2), "pp": (1,), "batch": (8,)})
    res = sweep(space, sim=tpu_sim)
    assert res.ranked("step_time")
    with pytest.raises(ValueError):
        res.ranked("goodput")
    with pytest.raises(ValueError):
        sweep(space, sim=tpu_sim, objective="nonsense")
