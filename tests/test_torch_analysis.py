"""Twins of ``tests/test_analysis.py`` for the port's correctness tooling
(``repro_torch.analysis``, carried from ``repro.analysis``).

Layer 1: charon-lint rule fixtures — for every rule a snippet it MUST flag
(true positive) and a clean equivalent it must NOT flag (false-positive
guard), plus disable-comment accounting, scope normalization and the CLI.

Layer 2: sanitizer — the cache-poisoning detector must raise on a
deliberately mutated cached value (and stay silent otherwise), the oracle
memo cross-check must catch an injected stale price, and check_determinism
must pass on a healthy spec.

Day-one fixes: regression tests pinning the frozen (tuple) report fields
and the determinism of the refactored overlap fluid model.
"""
from __future__ import annotations

import dataclasses
import subprocess
import sys
from pathlib import Path

import pytest

from repro_torch.analysis.lint import run_lint
from repro_torch.analysis.lint.engine import parse_disables
from repro_torch.analysis.sanitize import (
    CacheSanitizerError, SanitizingSimCache, check_determinism, diff_values,
    structural_fingerprint,
)
from repro_torch.api.spec import Cluster, ServingWorkload, SimSpec, TrainWorkload
from repro_torch.configs import get_config
from repro_torch.core.passes.base import ParallelConfig
from repro_torch.core.simulator import Simulator

import repro.serving.sim as RS
import repro_torch.serving.sim as TS
from repro.api.spec import (
    Cluster as RCluster, ServingWorkload as RServing, SimSpec as RSpec, TrainWorkload as RTrain,
)
from repro.configs import get_config as r_config
from repro.core.passes.base import ParallelConfig as RPar
from repro.core.simulator import Simulator as RSim

TINY = dict(name="lint-tiny", num_layers=2, d_model=128, num_heads=2, num_kv_heads=2,
            d_ff=256, vocab_size=512)
CFG = dataclasses.replace(get_config("gemma-7b"), **TINY)
R_CFG = dataclasses.replace(r_config("gemma-7b"), **TINY)


def lint_snippet(tmp_path: Path, rel: str, code: str, rules=None):
    """Write *code* at *rel* under a fixture tree and lint it."""
    path = tmp_path / rel
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(code)
    return run_lint([tmp_path], rules=rules)


def active_rules(report):
    return sorted({f.rule for f in report.active})


# ======================================================================
# R1: cache aliasing
# ======================================================================

def test_r1_flags_returned_mutable_cache_value(tmp_path):
    rep = lint_snippet(tmp_path, "core/bad.py", """
def timeline(self, key):
    return self.cache.get("memory", key, lambda: [1, 2, 3])
""")
    assert active_rules(rep) == ["R1"]


def test_r1_flags_named_then_returned_mutable_build(tmp_path):
    rep = lint_snippet(tmp_path, "core/bad.py", """
def stage(self, key):
    def build():
        return {"t": 1.0}
    out = self.cache.get("block_times", key, build)
    return out
""")
    assert active_rules(rep) == ["R1"]


def test_r1_flags_mutation_of_cache_fetched_value(tmp_path):
    rep = lint_snippet(tmp_path, "core/bad.py", """
def poke(self, key, build):
    rep = self.cache.get("reports", key, build)
    rep.kind_us["matmul"] = 0.0
    rep.breakdown.update({"fwd": 1})
    return rep.step_time_us
""")
    assert active_rules(rep) == ["R1"] and len(rep.active) == 2


def test_r1_passes_dataclass_build_and_copied_return(tmp_path):
    rep = lint_snippet(tmp_path, "core/good.py", """
def stage(self, key):
    def build():
        return Stage(t_fwd=1.0)
    return self.cache.get("block_times", key, build)

def copied(self, key):
    out = self.cache.get("memory", key, lambda: compute(key))
    return out

def plain_dict_get(d, key):
    # 2-arg dict.get is not a cache bucket get
    return d.get(key, [])
""")
    assert rep.active == ()


# ======================================================================
# R2: nondeterminism sources
# ======================================================================

def test_r2_flags_wall_clock_and_global_random(tmp_path):
    rep = lint_snippet(tmp_path, "serving/sim/bad.py", """
import os
import random
import time


def jitter():
    t = time.time()
    r = random.random()
    u = os.urandom(4)
    g = random.Random()
    return t, r, u, g
""")
    assert active_rules(rep) == ["R2"] and len(rep.active) == 4


def test_r2_flags_id_keys_and_set_iteration(tmp_path):
    rep = lint_snippet(tmp_path, "core/bad.py", """
def order(flows, table):
    extra = {}
    for f in flows:
        extra[id(f)] = 1.0
        table.get(id(f))
    kinds = {f.kind for f in flows}
    return [k for k in kinds]
""")
    assert active_rules(rep) == ["R2"] and len(rep.active) == 3


def test_r2_passes_seeded_rng_sorted_sets_and_out_of_scope(tmp_path):
    rep = lint_snippet(tmp_path, "resilience/good.py", """
import random


def trace(seed, flows):
    rng = random.Random(seed)
    kinds = {f.kind for f in flows}
    ordered = sorted(kinds)
    if "x" in kinds:            # membership is order-free: fine
        ordered.append("x")
    return rng.random(), ordered
""")
    assert rep.active == ()
    # time.time is fine OUTSIDE the deterministic scopes (obs/, benchmarks)
    rep = lint_snippet(tmp_path, "obs/clock2.py", """
import time


def wall():
    return time.time()
""")
    assert rep.active == ()


def test_r2_perf_counter_exempt_only_in_measurement_engines(tmp_path):
    code = """
import time


def measure():
    return time.perf_counter()
"""
    assert active_rules(lint_snippet(
        tmp_path, "core/backend/profiling.py", code)) == []
    assert active_rules(lint_snippet(
        tmp_path, "core/backend/other.py", code)) == ["R2"]


# ======================================================================
# R3: spec-surface drift
# ======================================================================

_R3_HEADER = """
from dataclasses import dataclass, field
"""


def test_r3_flags_compare_false_and_unwired_nested_spec(tmp_path):
    rep = lint_snippet(tmp_path, "api/spec.py", _R3_HEADER + """
@dataclass(frozen=True)
class Inner:
    x: int = 0


@dataclass(frozen=True)
class Outer:
    tag: str = field(default="", compare=False)
    inner: Inner = field(default_factory=Inner)
""")
    # tag: compare=False; inner: no "inner" string literal -> not in from_dict
    assert active_rules(rep) == ["R3"] and len(rep.active) == 2


def test_r3_flags_manual_hash_missing_field(tmp_path):
    rep = lint_snippet(tmp_path, "api/spec.py", _R3_HEADER + """
@dataclass(frozen=True)
class Spec:
    a: int = 0
    b: int = 0

    def __hash__(self):
        return hash(self.a)
""")
    assert active_rules(rep) == ["R3"]
    assert "b" in rep.active[0].message


def test_r3_passes_wired_spec(tmp_path):
    rep = lint_snippet(tmp_path, "api/spec.py", _R3_HEADER + """
@dataclass(frozen=True)
class Inner:
    x: int = 0


@dataclass(frozen=True)
class Outer:
    inner: Inner = field(default_factory=Inner)
    _memo: int = field(default=0, compare=False)   # private: allowed

    @classmethod
    def from_dict(cls, d):
        return cls(inner=Inner(**d["inner"]))

    def __hash__(self):
        return hash((self.inner,))
""")
    assert rep.active == ()


def test_r3_real_spec_module_is_clean():
    root = Path(__file__).resolve().parent.parent
    rep = run_lint([root / "src" / "repro_torch" / "api" / "spec.py"])
    assert [f for f in rep.active if f.rule == "R3"] == []


# ======================================================================
# R4: memo dicts vs the state-version guard
# ======================================================================

def test_r4_flags_unguarded_pricing_memo(tmp_path):
    rep = lint_snippet(tmp_path, "serving/sim/bad.py", """
class LeakyOracle:
    def __init__(self, sim):
        self.sim = sim
        self._price = {}

    def price(self, key):
        ver = self.sim.engine._state_version()
        if key not in self._price:
            self._price[key] = self.sim.run(key)
        return self._price[key]
""")
    assert active_rules(rep) == ["R4"]
    assert "_price" in rep.active[0].message


def test_r4_passes_guarded_memo_and_pure_spec_table(tmp_path):
    rep = lint_snippet(tmp_path, "serving/sim/good.py", """
class Oracle:
    def __init__(self, sim):
        self.sim = sim
        self._price = {}
        self._specs = {}
        self._ver = None

    def _live(self):
        ver = self.sim.engine._state_version()
        if ver != self._ver:
            self._price.clear()
            self._ver = ver

    def price(self, key):
        self._live()
        if key not in self._price:
            self._price[key] = self.sim.run(key)
        return self._price[key]

    def spec_for(self, key):
        # pure key->spec table: no pricing call in this method, exempt
        if key not in self._specs:
            self._specs[key] = ("spec", key)
        return self._specs[key]
""")
    assert rep.active == ()


# ======================================================================
# R5: recorder/metrics threading
# ======================================================================

def test_r5_flags_run_without_observability_params(tmp_path):
    rep = lint_snippet(tmp_path, "serving/sim/bad.py", """
class BlindSimulator:
    def run(self, spec):
        return price(spec)
""")
    assert active_rules(rep) == ["R5"] and len(rep.active) == 2


def test_r5_flags_unforwarded_delegation(tmp_path):
    rep = lint_snippet(tmp_path, "serving/sim/bad.py", """
class OuterSimulator:
    def run(self, spec, *, recorder=None, metrics=None):
        inner = InnerSimulator(self.sim)
        return inner.run(spec.build())
""")
    assert active_rules(rep) == ["R5"]
    assert "recorder" in rep.active[0].message


def test_r5_passes_forwarded_and_pricing_calls(tmp_path):
    rep = lint_snippet(tmp_path, "serving/sim/good.py", """
class OuterSimulator:
    def run(self, spec, *, recorder=None, metrics=None):
        base = self.sim.run(spec.base())     # pricing call: exempt
        inner = InnerSimulator(self.sim)
        return inner.run(spec.build(), recorder=recorder, metrics=metrics)


class Helper:
    def run(self, x):
        # not a *Simulator class: no observability contract
        return x
""")
    assert rep.active == ()


# ======================================================================
# R6: exception hygiene in crash-recovery scopes
# ======================================================================

def test_r6_flags_bare_except(tmp_path):
    rep = lint_snippet(tmp_path, "api/pool.py", """
def retry(task):
    try:
        return task()
    except:
        return None
""")
    assert active_rules(rep) == ["R6"]
    assert "bare" in rep.active[0].message


def test_r6_flags_swallowed_control_exceptions(tmp_path):
    rep = lint_snippet(tmp_path, "api/sweep.py", """
def drain(q):
    try:
        return q.get()
    except (KeyboardInterrupt, SystemExit):
        return None


def run(pool):
    try:
        pool.step()
    except BaseException as e:
        log(e)
""")
    assert active_rules(rep) == ["R6"] and len(rep.active) == 2
    assert "KeyboardInterrupt" in rep.active[0].message


def test_r6_passes_cleanup_then_reraise_and_narrow_handlers(tmp_path):
    rep = lint_snippet(tmp_path, "core/simcache.py", """
def atomic_write(path, blob):
    try:
        dump(path, blob)
    except BaseException:
        cleanup(path)
        raise


def evaluate(task):
    try:
        return task()
    except Exception as e:       # retryable: narrow catch is the contract
        return failed(e)
""")
    assert rep.active == ()


def test_r6_scoped_to_recovery_files(tmp_path):
    # the same swallow outside pool/sweep/chaos/simcache is not R6's beat
    code = """
def f(x):
    try:
        return x()
    except BaseException:
        return None
"""
    assert active_rules(lint_snippet(tmp_path, "core/engine2.py", code)) == []
    assert active_rules(
        lint_snippet(tmp_path, "analysis/chaos.py", code)) == ["R6"]


# ======================================================================
# engine mechanics: disable comments, scoping, CLI
# ======================================================================

def test_disable_comment_suppresses_but_counts(tmp_path):
    rep = lint_snippet(tmp_path, "core/bad.py", """
import time


def wall():
    return time.time()  # charon-lint: disable=R2
""")
    assert rep.active == () and len(rep.disabled) == 1
    assert rep.ok
    assert "1 disabled suppression(s)" in rep.render()
    assert "suppressed:" in rep.render()


def test_disable_comment_is_rule_specific(tmp_path):
    rep = lint_snippet(tmp_path, "core/bad.py", """
import time


def wall():
    return time.time()  # charon-lint: disable=R1
""")
    assert active_rules(rep) == ["R2"]   # wrong rule id: not suppressed


def test_parse_disables_multi_rule():
    d = parse_disables(["x = 1  # charon-lint: disable=R1,R2", "y = 2"])
    assert d == {1: {"R1", "R2"}}


def test_scope_normalization_matches_real_tree_and_fixtures(tmp_path):
    # the same snippet must be flagged whether it lives in a fixture tree
    # (core/x.py) or the real one (src/repro_torch/core/x.py)
    code = "import time\nT = time.time()\n"
    assert active_rules(lint_snippet(tmp_path, "core/x.py", code)) == ["R2"]
    assert active_rules(lint_snippet(
        tmp_path, "src/repro_torch/core/y.py", code)) == ["R2"]


def test_syntax_errors_are_reported_not_fatal(tmp_path):
    rep = lint_snippet(tmp_path, "core/broken.py", "def broken(:\n")
    assert not rep.ok and rep.errors and rep.active == ()


def test_cli_exit_codes(tmp_path):
    bad = tmp_path / "core"
    bad.mkdir()
    (bad / "bad.py").write_text("import time\nT = time.time()\n")
    root = Path(__file__).resolve().parent.parent
    env_path = str(root / "src")
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis.lint", str(tmp_path)],
        capture_output=True, text=True, env={"PYTHONPATH": env_path,
                                             "PATH": "/usr/bin:/bin"})
    assert r.returncode == 1 and "R2" in r.stdout
    (bad / "bad.py").write_text("X = 1\n")
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis.lint", str(tmp_path)],
        capture_output=True, text=True, env={"PYTHONPATH": env_path,
                                             "PATH": "/usr/bin:/bin"})
    assert r.returncode == 0 and "0 finding(s)" in r.stdout


def test_repo_tree_is_lint_clean_with_zero_suppressions():
    """The acceptance bar: the shipped tree has no findings and no disable
    comments (real violations get fixed, not suppressed)."""
    root = Path(__file__).resolve().parent.parent
    rep = run_lint([root / "src" / "repro_torch"])
    assert rep.active == (), "\n" + rep.render()
    assert rep.disabled == (), "disable comments crept into src/repro_torch/"


# ======================================================================
# sanitizer: fingerprints, poisoning detection, determinism harness
# ======================================================================

def test_structural_fingerprint_properties():
    a = {"x": [1, 2.5, (3, "s")], "y": {"n": None}, "z": {7, 8}}
    b = {"z": {8, 7}, "y": {"n": None}, "x": [1, 2.5, (3, "s")]}
    assert structural_fingerprint(a) == structural_fingerprint(b)
    b["x"].append(4)
    assert structural_fingerprint(a) != structural_fingerprint(b)
    # floats by bit pattern, nan stable; int/float/bool distinguished
    assert structural_fingerprint(float("nan")) \
        == structural_fingerprint(float("nan"))
    assert structural_fingerprint(1) != structural_fingerprint(1.0)
    assert structural_fingerprint(True) != structural_fingerprint(1)
    # cycles terminate
    cyc = []
    cyc.append(cyc)
    assert structural_fingerprint(cyc)


def test_sanitizing_cache_detects_injected_mutation():
    c = SanitizingSimCache()
    v = c.get("reports", "k", lambda: {"t": [1.0, 2.0]})
    assert c.get("reports", "k", lambda: None) is v     # clean hit
    v["t"].append(3.0)                                  # poison it
    with pytest.raises(CacheSanitizerError) as ei:
        c.get("reports", "k", lambda: None)
    assert ei.value.bucket == "reports" and ei.value.key == "k"


def test_sanitizing_cache_off_paths_match_simcache():
    c = SanitizingSimCache(enabled=False)
    assert c.get("reports", "k", lambda: [1]) == [1]    # pass-through
    c2 = SanitizingSimCache()
    unhashable = ["list-key"]
    assert c2.get("reports", unhashable, lambda: 7) == 7


def test_simulator_sanitize_flag_and_env(monkeypatch):
    from repro_torch.core.simcache import SimCache
    sim = Simulator("h100_sxm", engine="analytical")
    assert type(sim.cache) is SimCache           # default: plain cache
    sim = Simulator("h100_sxm", engine="analytical", sanitize=True)
    assert isinstance(sim.cache, SanitizingSimCache)
    monkeypatch.setenv("CHARON_SANITIZE", "1")
    sim = Simulator("h100_sxm", engine="analytical")
    assert isinstance(sim.cache, SanitizingSimCache)
    monkeypatch.setenv("CHARON_SANITIZE", "0")
    sim = Simulator("h100_sxm", engine="analytical")
    assert type(sim.cache) is SimCache


def test_sanitizer_catches_poisoned_block_stage_end_to_end():
    spec = SimSpec(CFG, cluster=Cluster("h100_sxm"),
                   parallel=ParallelConfig(),
                   workload=TrainWorkload(global_batch=8, seq_len=128))
    sim = Simulator("h100_sxm", engine="analytical", sanitize=True)
    r1 = sim.run(spec)
    # mutate a cached block stage behind the cache's back
    key = next(iter(sim.cache._data["block_times"]))
    sim.cache._data["block_times"][key].kind_us["matmul"] = 1e9
    with pytest.raises(CacheSanitizerError) as ei:
        sim.run(spec)
    assert ei.value.bucket == "block_times"
    assert r1.step_time_us > 0


def test_sanitized_serving_run_matches_default_run():
    sw = ServingWorkload(n_requests=30, rate_rps=30.0, seed=3, max_batch=8)
    spec = SimSpec(CFG, workload=sw)
    from repro_torch.serving.sim import ServingSimulator
    plain = ServingSimulator(Simulator("h100_sxm")).run(spec)
    sane = ServingSimulator(Simulator("h100_sxm", sanitize=True)).run(spec)
    a, b = plain.summary(), sane.summary()
    a.pop("oracle_stats"), b.pop("oracle_stats")  # verify recounts hits
    assert a == b


def _table_oracle(S):
    """A ``StepOracle`` of package ``S`` that prices a bucketed step from one
    formula, so that both packages' event loops see the same prices."""
    class TableOracle(S.StepOracle):
        def _priced_s(self, mode, B, S_, cache_len):
            self.lookups += 1
            key = (mode, B, S_, cache_len)
            if key not in self._price:
                base = 2e-3 if mode == "prefill" else 1e-3
                self._price[key] = base + 1e-6 * B * S_ + 1e-8 * B * cache_len
            return self._price[key]
    return TableOracle


def test_sanitized_serving_run_equals_the_reference():
    """Both packages sanitized (``CacheSanitizerError`` armed on every memo
    hit), the same workload over one price table: equal reports."""
    reps = {}
    for name, S, sim, cfg, par in (("ref", RS, RSim("h100_sxm", sanitize=True), R_CFG, RPar()),
                                   ("port", TS, Simulator("h100_sxm", sanitize=True), CFG,
                                    ParallelConfig())):
        wl = S.synthesize(40, rate_rps=30.0, seed=3)
        oracle = _table_oracle(S)(sim, cfg, par, ctx_floor=256)
        reps[name] = S.ServingSimulator(sim, cfg, policy=S.ContinuousBatching(8),
                                        oracle=oracle).run(wl)
    assert dataclasses.asdict(reps["port"]) == dataclasses.asdict(reps["ref"])
    assert reps["port"].n_requests == 40


def test_oracle_memo_cross_check_catches_stale_price():
    from repro_torch.serving.sim.oracle import StepOracle
    sim = Simulator("h100_sxm", sanitize=True)
    oracle = StepOracle(sim, CFG)
    good = oracle.decode_step_s(4, 300)
    assert oracle.decode_step_s(4, 300) == good         # clean memo hit
    oracle._raw[("decode", 4, 300)] = good * 2          # inject staleness
    with pytest.raises(CacheSanitizerError) as ei:
        oracle.decode_step_s(4, 300)
    assert ei.value.bucket == "oracle._raw"
    # _price memo staleness is caught by the same cross-check
    fast = next(iter(oracle._price))
    oracle._price[fast] = oracle._price[fast] * 2
    with pytest.raises(CacheSanitizerError) as ei:
        oracle._priced_s(*fast)
    assert ei.value.bucket == "oracle._price"


def test_check_determinism_passes_on_healthy_specs():
    step = SimSpec(CFG, workload=TrainWorkload(global_batch=8, seq_len=128))
    rep = check_determinism(step)
    assert rep.ok, rep.render()
    assert set(rep.variants) == {"warm", "uncached", "pickled"}
    serving = SimSpec(CFG, workload=ServingWorkload(
        n_requests=20, rate_rps=20.0, seed=1, max_batch=8))
    rep = check_determinism(serving)
    assert rep.ok, rep.render()


def test_diff_values_reports_field_paths():
    @dataclasses.dataclass
    class D:
        x: float
        items: tuple

    a = D(1.0, (1, 2))
    assert diff_values(a, D(1.0, (1, 2))) == []
    diffs = diff_values(a, D(2.0, (1, 3)), path="r")
    assert {d[0] for d in diffs} == {"r.x", "r.items[1]"}
    assert diff_values([1], [1, 2]) == [("report", "len=1", "len=2")]
    # nan == nan under the exact-float rule
    assert diff_values(float("nan"), float("nan")) == []


# ======================================================================
# day-one fixes: frozen report fields stay frozen (regression per fix)
# ======================================================================

def test_serving_and_fleet_report_fields_are_tuples():
    from repro_torch.api.spec import FleetSpec
    from repro_torch.serving.sim import ServingSimulator
    sim = Simulator("h100_sxm")
    spec = SimSpec(CFG, workload=ServingWorkload(
        n_requests=20, rate_rps=20.0, seed=1, max_batch=8))
    rep = ServingSimulator(sim).run(spec)
    assert isinstance(rep.requests, tuple)
    fleet_spec = SimSpec(CFG, workload=ServingWorkload(
        n_requests=20, rate_rps=20.0, seed=1, max_batch=8,
        fleet=FleetSpec(replicas=2)))
    frep = ServingSimulator(sim).run(fleet_spec)
    assert isinstance(frep.requests, tuple)
    assert isinstance(frep.replicas, tuple)
    assert isinstance(frep.autoscaler_trace, tuple)
    assert isinstance(frep.failure_trace, tuple)
    for per in frep.replicas:
        assert isinstance(per.requests, tuple)


def test_sanitized_step_run_equals_the_plain_run_and_the_reference():
    """A sanitized step report is bit-identical to the plain one, under the
    flag and under ``CHARON_SANITIZE=1``, and within the step (15 %) and
    memory (3 %) tolerances that ``test_torch_simulator.py`` holds the port's
    plain reports to against the reference's sanitized one."""
    import os
    spec = SimSpec(CFG, workload=TrainWorkload(global_batch=8, seq_len=128))
    plain = Simulator("h100_sxm").run(spec)
    sane = Simulator("h100_sxm", sanitize=True).run(spec)
    assert dataclasses.asdict(sane) == dataclasses.asdict(plain)
    os.environ["CHARON_SANITIZE"] = "1"
    try:
        env = Simulator("h100_sxm")
        assert isinstance(env.cache, SanitizingSimCache)
        assert dataclasses.asdict(env.run(spec)) == dataclasses.asdict(plain)
    finally:
        del os.environ["CHARON_SANITIZE"]
    ref = RSim("h100_sxm", sanitize=True).run(
        RSpec(R_CFG, cluster=RCluster("h100_sxm"), workload=RTrain(global_batch=8, seq_len=128)))
    assert sane.step_time_us == pytest.approx(ref.step_time_us, rel=0.15)
    assert sane.memory.total == pytest.approx(ref.memory.total, rel=0.03)


def test_exploration_result_fields_are_tuples():
    from repro_torch.api import DecodeWorkload, SweepSpace, sweep
    base = SimSpec(CFG, cluster=Cluster("h100_sxm", chips=4),
                   workload=DecodeWorkload(seq_len=128))
    res = sweep(SweepSpace(base, {"tp": (1, 2), "batch": (8,)}),
                sim=Simulator("h100_sxm", sanitize=True))
    assert isinstance(res.evaluated, tuple)
    assert isinstance(res.pruned, tuple)
    assert isinstance(res.failed, tuple)
    assert res.evaluated


def test_memory_report_timeline_stays_tuple():
    spec = SimSpec(CFG, workload=TrainWorkload(global_batch=8, seq_len=128))
    rep = Simulator("h100_sxm").run(spec)
    assert rep.memory is not None
    assert isinstance(rep.memory.timeline, tuple)


def test_overlap_fluid_model_is_replayable():
    """The id()->index refactor keeps the fluid model a pure function of
    its input: two structurally equal interval lists produce identical
    adjusted end times (object identity no longer leaks into keys)."""
    from repro_torch.core.overlap import bandwidth_aware_comm
    from repro_torch.core.scheduler import Interval

    def mk():
        return [Interval(f"f{i}", "comm", "ici", 0.1 * (i % 3), 1.0 + i,
                         "fwd", "g", 1e6 * (1 + i), 1, "analytical")
                for i in range(6)]

    ends1 = [iv.end for iv in bandwidth_aware_comm(mk())]
    ends2 = [iv.end for iv in bandwidth_aware_comm(mk())]
    assert ends1 == ends2
