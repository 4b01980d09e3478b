"""Crash-safe sweep execution in ``repro_torch``: the twin of
``tests/test_pool_robustness.py``, the worker pool's recovery contracts.

The headline invariant, exercised under every injected fault kind: a sweep
under any deterministic :class:`~repro_torch.analysis.chaos.FaultPlan`
schedule that does not exhaust a candidate's retries produces rankings,
reports and pruned reasons **bit-identical** to the fault-free serial sweep.

The port prices with its own analytical engine (forked workers trace the
torch block with ``make_fx`` over FakeTensors).  Its space is the
reference's with phi4-mini-3.8b on ``h100_sxm`` in place of xlstm-125m on
``tpu_v5e`` (chosen before the port had xLSTM); the ``test_xlstm_*`` cases
run the reference's own space, xlstm-125m on ``tpu_v5e``, through the crash,
error and quarantine recoveries.  The fault plans keep the
reference's seeds and ``RetryPolicy`` timeouts.  A plan decides on
``spec.json_hash()``, which is equal in both packages, so the plans fire on
the same candidates in both: on the reference's own 18 candidates (4 poisoned,
as the reference verified) and on this space, where every plan fires too
(``test_fault_plans_fire_on_the_same_candidates_in_both_packages``).
"""
import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import pytest

import repro.api as RA
from repro.analysis.chaos import FaultPlan as RFaultPlan
from repro.configs import get_config as r_config
from repro_torch.analysis.chaos import ChaosError, FaultPlan, corrupt_shard
from repro_torch.api import Cluster, DecodeWorkload, SimSpec, SweepSpace, sweep
from repro_torch.api.pool import (
    CandidateFailedError, RetryPolicy, SweepJournal, get_pool, shutdown_pools,
)
from repro_torch.configs import get_config
from repro_torch.core.simulator import Simulator, merge_cache_shards
from repro_torch.obs.metrics import MetricsRegistry

ARCH = "phi4-mini-3.8b"
CFG = get_config(ARCH)

# the reference's policies: a short per-candidate timeout keeps the hang test
# fast; a warm candidate here takes well under a second
FAST = RetryPolicy(timeout_s=5.0, backoff_s=0.01, backoff_max_s=0.1)


@pytest.fixture(scope="module", autouse=True)
def _pool_teardown():
    yield
    shutdown_pools()


AXES = {"tp": (1, 2, 4), "pp": (1, 2), "batch": (8, 16, 32)}


def _space(memory_limit=16e9):
    base = SimSpec(CFG, cluster=Cluster("h100_sxm", chips=16, memory_limit=memory_limit),
                   workload=DecodeWorkload(global_batch=8, seq_len=1024))
    return SweepSpace(base, AXES)


def _result_key(res):
    return (
        [(r.cand.key(), r.report.step_time_us, r.report.mfu,
          sorted(r.report.kind_us.items()), r.report.memory.total)
         for r in res.evaluated],
        [(r.cand.key(), r.reason) for r in res.pruned],
        [(r.cand.key(), r.report.step_time_us) for r in res.ranked()],
    )


def _counters(res):
    return res.metrics.get("counters", {})


# ======================================================================
# the reference's seeds fire on the same candidates in both packages
# ======================================================================

PLANS = {
    "worker_crash": dict(seed=3, worker_crash=0.3),
    "worker_hang": dict(seed=0, worker_hang=0.15, hang_s=60.0),
    "candidate_error": dict(seed=1, candidate_error=0.2),
    "poison": dict(seed=1, candidate_error=0.2, repeat=True),
    "cache_corrupt": dict(cache_corrupt=1.0),
}


def _ref_space(arch, hw):
    base = RA.SimSpec(r_config(arch), cluster=RA.Cluster(hw, chips=16, memory_limit=16e9),
                      workload=RA.DecodeWorkload(global_batch=8, seq_len=1024))
    return RA.SweepSpace(base, AXES)


@pytest.mark.parametrize("arch,hw", [("xlstm-125m", "tpu_v5e"), (ARCH, "h100_sxm")])
def test_fault_plans_fire_on_the_same_candidates_in_both_packages(arch, hw):
    """On the reference's space (rebuilt in the port from its spec JSON) and
    on this file's: equal hashes, and every plan decides alike on every
    candidate and attempt."""
    ref = _ref_space(arch, hw)
    port = SweepSpace(SimSpec.from_json(ref.base.to_json()), AXES)
    hashes = [s.json_hash() for s in port.points()]
    assert hashes == [s.json_hash() for s in ref.points()] and len(hashes) == 18
    if arch == ARCH:
        assert hashes == [s.json_hash() for s in _space().points()]
    for name, kw in PLANS.items():
        kind = name if name in ("worker_crash", "worker_hang", "cache_corrupt") \
            else "candidate_error"
        p, r = FaultPlan(**kw), RFaultPlan(**kw)
        for attempt in (1, 2):
            fired = [p.should(kind, (h,), attempt) for h in hashes]
            assert fired == [r.should(kind, (h,), attempt) for h in hashes]
            if attempt == 1:
                assert any(fired), name          # the schedule fires on this space
    poisoned = sum(FaultPlan(**PLANS["poison"]).should("candidate_error", (h,), 2)
                   for h in hashes)
    assert poisoned == 4


# ======================================================================
# recoverable faults: bit-identity under crash / hang / poison candidate
# ======================================================================

def test_worker_crash_recovery_bit_identical():
    serial = sweep(_space())
    chaotic = sweep(_space(), workers=2, retry=FAST,
                    faults=FaultPlan(**PLANS["worker_crash"]))
    assert _result_key(serial) == _result_key(chaotic)
    assert chaotic.failed == ()
    c = _counters(chaotic)
    assert c.get("pool.worker_deaths", 0) >= 1
    assert c.get("pool.retries", 0) >= 1
    assert c.get("pool.respawns", 0) >= 1
    assert c.get("pool.quarantined", 0) == 0


def test_worker_hang_timeout_recovery_bit_identical():
    serial = sweep(_space())
    chaotic = sweep(
        _space(), workers=2,
        retry=RetryPolicy(timeout_s=2.0, backoff_s=0.01, backoff_max_s=0.1),
        faults=FaultPlan(**PLANS["worker_hang"]))
    assert _result_key(serial) == _result_key(chaotic)
    assert chaotic.failed == ()
    c = _counters(chaotic)
    assert c.get("pool.timeouts", 0) >= 1
    assert c.get("pool.retries", 0) >= 1


def test_candidate_error_recovery_bit_identical_serial_and_pool():
    plan = FaultPlan(**PLANS["candidate_error"])   # first attempt only
    clean = sweep(_space())
    ser = sweep(_space(), faults=plan)
    par = sweep(_space(), workers=2, retry=FAST, faults=plan)
    assert _result_key(clean) == _result_key(ser) == _result_key(par)
    assert ser.failed == () and par.failed == ()
    for res in (ser, par):
        c = _counters(res)
        assert c.get("pool.candidate_errors", 0) >= 1
        assert c.get("pool.retries", 0) >= 1


# ======================================================================
# quarantine: retries exhausted -> FailedCandidate, never an abort
# ======================================================================

# fires on every attempt for 4 of the 18 candidates
POISON = FaultPlan(**PLANS["poison"])
ONE_RETRY = RetryPolicy(max_retries=1, timeout_s=5.0, backoff_s=0.01, backoff_max_s=0.1)


def test_quarantine_is_symmetric_between_serial_and_pool():
    ser = sweep(_space(), faults=POISON, retry=ONE_RETRY)
    par = sweep(_space(), workers=2, faults=POISON, retry=ONE_RETRY)
    assert len(ser.failed) == len(par.failed) == 4
    assert [f.spec.json_hash() for f in ser.failed] == [f.spec.json_hash() for f in par.failed]
    for f in ser.failed + par.failed:
        assert f.attempts == 2
        assert "ChaosError" in f.reason
    assert len(ser.evaluated) + len(ser.pruned) == 18 - 4
    assert _result_key(ser) == _result_key(par)
    assert _counters(par).get("pool.quarantined", 0) == 4
    assert _counters(par).get("sweep.failed", 0) == 4


def test_strict_mode_fails_fast():
    with pytest.raises(ChaosError):
        sweep(_space(), faults=POISON, retry=ONE_RETRY, strict=True)
    with pytest.raises(CandidateFailedError) as ei:
        sweep(_space(), workers=2, faults=POISON, retry=ONE_RETRY, strict=True)
    assert ei.value.failed.attempts == 2
    clean = sweep(_space(), workers=2, retry=FAST)
    assert _result_key(clean) == _result_key(sweep(_space()))


def test_manifest_records_failed_rows(tmp_path):
    man = tmp_path / "manifest.json"
    res = sweep(_space(), faults=POISON, retry=ONE_RETRY, manifest=str(man))
    doc = json.loads(man.read_text())
    statuses = {}
    for row in doc["candidates"]:
        statuses[row["status"]] = statuses.get(row["status"], 0) + 1
    assert statuses["failed"] == doc["n_failed"] == len(res.failed) == 4
    assert statuses["completed"] == len(res.evaluated)
    frow = next(r for r in doc["candidates"] if r["status"] == "failed")
    assert frow["attempts"] == 2 and "ChaosError" in frow["reason"]
    assert frow["rank"] is None and frow["traceback"]


# ======================================================================
# journal / resume
# ======================================================================

def test_journal_full_resume_skips_all_work(tmp_path):
    jr = tmp_path / "sweep.jsonl"
    first = sweep(_space(), journal=str(jr))
    second = sweep(_space(), journal=str(jr))
    assert _result_key(first) == _result_key(second)
    assert _counters(second).get("sweep.resumed", 0) == 18
    assert _counters(second).get("sweep.evaluated", 0) \
        + _counters(second).get("sweep.pruned", 0) == 18


def test_journal_tolerates_torn_final_line(tmp_path):
    jr = tmp_path / "sweep.jsonl"
    sweep(_space(), journal=str(jr))
    lines = jr.read_text().splitlines()
    jr.write_text("\n".join(lines[:8]) + "\n" + lines[8][: len(lines[8]) // 2])
    resumed = sweep(_space(), workers=2, retry=FAST, journal=str(jr))
    assert _result_key(resumed) == _result_key(sweep(_space()))
    assert _counters(resumed).get("sweep.resumed", 0) == 7


def test_journal_header_mismatch_is_rejected(tmp_path):
    jr = tmp_path / "sweep.jsonl"
    sweep(_space(), journal=str(jr))
    other = SweepSpace(_space().base, {"tp": (1, 2), "batch": (8, 16)})
    with pytest.raises(ValueError, match="different sweep"):
        sweep(other, journal=str(jr))
    with pytest.raises(ValueError, match="different sweep"):
        sweep(_space(), resume=str(jr), objective="goodput")


def test_journal_failed_rows_are_reattempted_on_resume(tmp_path):
    jr = tmp_path / "sweep.jsonl"
    broken = sweep(_space(), faults=POISON, retry=ONE_RETRY, journal=str(jr))
    assert len(broken.failed) == 4
    healed = sweep(_space(), journal=str(jr))
    assert healed.failed == ()
    assert _result_key(healed) == _result_key(sweep(_space()))
    assert _counters(healed).get("sweep.resumed", 0) == 14


_KILL_HARNESS = """
import sys
from repro_torch.api import Cluster, DecodeWorkload, SimSpec, SweepSpace, sweep
from repro_torch.configs import get_config

base = SimSpec(get_config("phi4-mini-3.8b"),
               cluster=Cluster("h100_sxm", chips=16, memory_limit=16e9),
               workload=DecodeWorkload(global_batch=8, seq_len=1024))
space = SweepSpace(base, {"tp": (1, 2, 4), "pp": (1, 2), "batch": (8, 16, 32)})
print("READY", flush=True)
sweep(space, workers=2, journal=sys.argv[1])
print("DONE", flush=True)
"""


def test_sigkill_mid_sweep_then_resume_bit_identical(tmp_path):
    """SIGKILL a pooled sweep process mid-run (its workers become orphans
    and must exit on their own), then resume from the journal: the merged
    result is bit-identical to an uninterrupted serial sweep."""
    jr = tmp_path / "sweep.jsonl"
    script = tmp_path / "harness.py"
    script.write_text(_KILL_HARNESS)
    root = Path(__file__).resolve().parent.parent
    proc = subprocess.Popen([sys.executable, str(script), str(jr)],
                            env={**os.environ, "PYTHONPATH": str(root / "src")},
                            stdout=subprocess.PIPE, text=True)
    try:
        deadline = time.monotonic() + 120.0
        while time.monotonic() < deadline:
            if proc.poll() is not None:
                pytest.fail("harness finished before it could be killed: "
                            f"{proc.stdout.read()}")
            if jr.exists() and len(jr.read_text().splitlines()) >= 4:
                break
            time.sleep(0.02)
        else:
            pytest.fail("journal never accumulated rows")
        os.kill(proc.pid, signal.SIGKILL)
        proc.wait(timeout=30.0)
    finally:
        if proc.poll() is None:
            proc.kill()
        proc.stdout.close()
    rows = jr.read_text().splitlines()
    assert 4 <= len(rows) < 19
    resumed = sweep(_space(), journal=str(jr))
    assert _result_key(resumed) == _result_key(sweep(_space()))
    assert _counters(resumed).get("sweep.resumed", 0) >= 3


# ======================================================================
# persistent-cache write-back through shards
# ======================================================================

def test_pooled_sweep_writes_back_merged_cache(tmp_path):
    res = sweep(_space(), workers=2, retry=FAST, persist=str(tmp_path))
    assert res.failed == ()
    assert list(tmp_path.glob("*.pkl")), "pooled sweep left no merged cache file"
    assert not list(tmp_path.glob("*.shard"))
    assert _counters(res).get("pool.cache_shards_merged", 0) >= 1
    warm = sweep(_space(), persist=str(tmp_path))
    assert _result_key(res) == _result_key(warm)
    assert warm.cache_stats["reports"]["hits"] >= 1


def test_corrupt_shard_is_quarantined_not_fatal(tmp_path):
    res = sweep(_space(), workers=2, retry=FAST, persist=str(tmp_path),
                faults=FaultPlan(**PLANS["cache_corrupt"]))
    assert _result_key(res) == _result_key(sweep(_space()))
    assert _counters(res).get("pool.cache_shards_quarantined", 0) >= 1
    assert list(tmp_path.glob("*.corrupt"))
    assert not list(tmp_path.glob("*.shard"))


def test_merge_cache_shards_truncated_file_direct(tmp_path):
    from repro_torch.core import ParallelConfig
    spec = SimSpec(CFG, parallel=ParallelConfig(tp=2, dp=4),
                   workload=DecodeWorkload(global_batch=8, seq_len=512))
    s1 = Simulator("h100_sxm", persist=str(tmp_path))
    s1.run(spec)
    good = s1.save_cache_shard("t1")
    bad = s1.save_cache_shard("t2")
    corrupt_shard(str(bad))
    reg = MetricsRegistry()
    out = merge_cache_shards(str(s1.cache.persist_path), [str(good), str(bad)], metrics=reg)
    assert out["merged"] == 1 and out["quarantined"] == 1
    assert reg.counters.get("pool.cache_shards_quarantined") == 1
    assert bad.with_name(bad.name + ".corrupt").exists()
    assert not good.exists()
    s2 = Simulator("h100_sxm", persist=str(tmp_path))
    assert s2.cache.loaded_sizes.get("reports", 0) >= 1
    assert s2.run(spec).step_time_us == s1.run(spec).step_time_us


# ======================================================================
# chaos plan mechanics + pool plumbing
# ======================================================================

def test_fault_plan_is_deterministic_and_attempt_aware():
    plan = FaultPlan(seed=5, worker_crash=0.5)
    rolls = [plan.roll("worker_crash", f"h{i}") for i in range(64)]
    assert rolls == [FaultPlan(seed=5, worker_crash=0.5).roll("worker_crash", f"h{i}")
                     for i in range(64)]
    assert rolls == [RFaultPlan(seed=5, worker_crash=0.5).roll("worker_crash", f"h{i}")
                     for i in range(64)]
    assert any(rolls) and not all(rolls)
    fired = next(f"h{i}" for i in range(64) if plan.roll("worker_crash", f"h{i}"))
    assert plan.should("worker_crash", (fired,), attempt=1)
    assert not plan.should("worker_crash", (fired,), attempt=2)
    assert FaultPlan(seed=5, worker_crash=0.5, repeat=True).should(
        "worker_crash", (fired,), attempt=2)
    assert rolls != [FaultPlan(seed=6, worker_crash=0.5).roll("worker_crash", f"h{i}")
                     for i in range(64)]


def test_charon_faults_env_grammar():
    plan = FaultPlan.from_env({"CHARON_FAULTS": "worker_crash:0.05, worker_hang:0.01,"
                               "cache_corrupt:0.02,seed:7,repeat:1,hang_s:12.5"})
    assert plan == FaultPlan(worker_crash=0.05, worker_hang=0.01, cache_corrupt=0.02,
                             seed=7, repeat=True, hang_s=12.5)
    assert FaultPlan.from_env({}) is None
    assert FaultPlan.from_env({"CHARON_FAULTS": "  "}) is None
    with pytest.raises(ValueError, match="unknown CHARON_FAULTS kind"):
        FaultPlan.from_env({"CHARON_FAULTS": "meteor_strike:1.0"})
    with pytest.raises(ValueError, match="not 'kind:value'"):
        FaultPlan.from_env({"CHARON_FAULTS": "worker_crash"})
    with pytest.raises(ValueError, match="rate must be in"):
        FaultPlan(worker_crash=1.5)


def test_sweep_reads_charon_faults_env(monkeypatch):
    monkeypatch.setenv("CHARON_FAULTS", "candidate_error:0.2,seed:1")
    res = sweep(_space())
    monkeypatch.delenv("CHARON_FAULTS")
    assert _result_key(res) == _result_key(sweep(_space()))
    assert _counters(res).get("pool.candidate_errors", 0) >= 1


def test_retry_policy_contract():
    p = RetryPolicy(backoff_s=0.1, backoff_max_s=0.5)
    assert p.backoff_for(2) == pytest.approx(0.1)
    assert p.backoff_for(3) == pytest.approx(0.2)
    assert p.backoff_for(10) == pytest.approx(0.5)
    with pytest.raises(ValueError):
        RetryPolicy(max_retries=-1)
    with pytest.raises(ValueError):
        RetryPolicy(timeout_s=0.0)


def test_pool_is_long_lived_across_sweeps():
    p1 = get_pool(2)
    sweep(_space(), workers=2, retry=FAST)
    p2 = get_pool(2)
    assert p2 is p1 and p1.alive
    pids = sorted(s.proc.pid for s in p1._slots)
    sweep(_space(), workers=2, retry=FAST)
    assert sorted(s.proc.pid for s in p1._slots) == pids


def test_journal_roundtrips_results(tmp_path):
    jr_path = tmp_path / "j.jsonl"
    res = sweep(_space(), journal=str(jr_path))
    rows = SweepJournal.load(str(jr_path))
    assert len(rows) == 18
    some = next(iter(rows.values()))
    rehydrated = SweepJournal.result_from(some)
    assert rehydrated.spec.json_hash() == some["h"]
    orig = next(r for r in res.evaluated + res.pruned if r.spec.json_hash() == some["h"])
    assert rehydrated.pruned == orig.pruned
    assert rehydrated.reason == orig.reason
    if orig.report is not None:
        assert rehydrated.report.step_time_us == orig.report.step_time_us
        assert rehydrated.report.kind_us == orig.report.kind_us


# ======================================================================
# the reference's own space: xlstm-125m on tpu_v5e
# ======================================================================

XLSTM = get_config("xlstm-125m")


def _xspace(memory_limit=16e9):
    base = SimSpec(XLSTM, cluster=Cluster("tpu_v5e", chips=16, memory_limit=memory_limit),
                   workload=DecodeWorkload(global_batch=8, seq_len=1024))
    return SweepSpace(base, AXES)


def test_xlstm_worker_crash_recovery_bit_identical():
    serial = sweep(_xspace())
    chaotic = sweep(_xspace(), workers=2, retry=FAST, faults=FaultPlan(**PLANS["worker_crash"]))
    assert _result_key(serial) == _result_key(chaotic)
    assert chaotic.failed == ()
    c = _counters(chaotic)
    assert c.get("pool.worker_deaths", 0) >= 1
    assert c.get("pool.retries", 0) >= 1
    assert c.get("pool.respawns", 0) >= 1
    assert c.get("pool.quarantined", 0) == 0


def test_xlstm_candidate_error_recovery_bit_identical_serial_and_pool():
    plan = FaultPlan(**PLANS["candidate_error"])
    clean = sweep(_xspace())
    ser = sweep(_xspace(), faults=plan)
    par = sweep(_xspace(), workers=2, retry=FAST, faults=plan)
    assert _result_key(clean) == _result_key(ser) == _result_key(par)
    assert ser.failed == () and par.failed == ()
    for res in (ser, par):
        c = _counters(res)
        assert c.get("pool.candidate_errors", 0) >= 1
        assert c.get("pool.retries", 0) >= 1


def test_xlstm_quarantine_is_symmetric_between_serial_and_pool():
    """4 of the reference's 18 candidates poisoned, as it verified."""
    ser = sweep(_xspace(), faults=POISON, retry=ONE_RETRY)
    par = sweep(_xspace(), workers=2, faults=POISON, retry=ONE_RETRY)
    assert len(ser.failed) == len(par.failed) == 4
    assert [f.spec.json_hash() for f in ser.failed] == [f.spec.json_hash() for f in par.failed]
    for f in ser.failed + par.failed:
        assert f.attempts == 2
        assert "ChaosError" in f.reason
    assert len(ser.evaluated) + len(ser.pruned) == 18 - 4
    assert _result_key(ser) == _result_key(par)
    assert _counters(par).get("pool.quarantined", 0) == 4
