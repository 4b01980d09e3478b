"""``repro_torch.api.sweep`` and ``repro_torch.core.explorer`` against the
reference's, on the CPU: the twin of the sweep and explorer cases of
``tests/test_api_spec.py``, ``tests/test_perf_cache.py`` and
``tests/test_sim_core.py``, and of ``tests/test_sweep_parallel.py``'s
multiprocess sweeps (its pricing, overlap, cache and ingest cases are twinned
in ``test_torch_sim_core.py``, ``test_torch_simulator.py`` and
``test_torch_ingest.py``).

Parity is held in two layers:

* **The machinery, bit for bit.**  ``StubSim`` prices every spec from one
  table keyed on ``spec.json_hash()`` (``stub_numbers``) and returns each
  package's own ``Report``; equal specs hash equal in both packages, so both
  see the same prices.  Enumeration hashes, rule- and memory-pruned reasons,
  ``ranked()``, ``pareto()``, ``best_under_slo()``, every ``EvalResult``
  (``dataclasses.asdict``), the manifest rows (less wall times) and the
  journal rows are then ``==`` to the reference's, and a journal written by
  either package resumes in the other.
* **The numbers, within stated tolerances.**  With each package's own
  analytical simulator on the ``bench_explore`` space (qwen2.5-32b decode on
  ``tpu_v5e``, tp x pp x batch): the same candidates are evaluated and
  rule-pruned; memory agrees within ``MEM_TOL`` = 3 %; step times within
  ``STEP_TOL`` = 15 % once the reference's whole-table embedding read is
  priced into the port's step (``table_read_us``; ROADMAP queue C: the
  reference's tracer prices the head's lookup as a read of the whole table,
  the port's as a read of the rows it gathers, 15.3 % of the step at tp 16,
  one sequence a replica); and every pair of candidates more than
  ``ORDER_GAP`` = 30 % apart in the reference is ordered the same way.

The reference's own twins use ``xlstm-125m``.  The cases that price for real
use the dense phi4-mini-3.8b or qwen2.5-32b (they came before the port had
xLSTM); the ``test_xlstm_*`` cases run the reference's own xlstm-125m space on
``tpu_v5e`` (serial against pooled, memory pruning, batch extrapolation) with
its assertions, and hold each candidate to the reference's within ``STEP_TOL``
and ``MEM_TOL``.
"""
import dataclasses
import functools
import json
import math
import warnings

import pytest

import repro.api as RA
import repro.api.pool as RP
import repro.core.explorer as RE
import repro.core.memory as RMem
import repro.core.simulator as RSimMod
import repro_torch.api as TA
import repro_torch.api.pool as TP
import repro_torch.core.memory as TMem
import repro_torch.core.simulator as TSimMod
from repro.configs import get_config as r_config
from repro.core import ParallelConfig as RPar, Simulator as RSim
from repro_torch.api import (
    CharonDeprecationWarning, Cluster, DecodeWorkload, ServingWorkload, SimSpec,
    SweepSpace, spec_replace, sweep,
)
from repro_torch.configs import get_config
from repro_torch.core import ParallelConfig, Simulator
from repro_torch.core.backend.analytical import AnalyticalEngine
from repro_torch.core.backend.hardware import HARDWARE
from repro_torch.core.explorer import Candidate, explore, rule_memory_fit
from repro_torch.core.ir import OpNode

STEP_TOL = 0.15      # step time against the reference, the reference's table read priced in
MEM_TOL = 0.03       # memory total against the reference
ORDER_GAP = 0.30     # reference pairs this far apart must keep their order
ARCH = "phi4-mini-3.8b"
CFG = get_config(ARCH)
# each package's api, simulator and memory modules and its ParallelConfig
PKGS = {"ref": (RA, RSimMod, RMem, RPar), "port": (TA, TSimMod, TMem, ParallelConfig)}


# ---------------- the shared price table ----------------

@functools.cache
def stub_numbers(h: str, mode: str, tp: int, pp: int, dp: int, pods: int,
                 micro: int, B: int, S: int) -> dict:
    """Step time, memory and token counts of one spec, keyed on its
    ``json_hash`` ``h``: a deterministic stand-in for the simulator, the
    same in both packages (the hash's digits add a small spread so no two
    candidates tie)."""
    jitter = int(h[:8], 16) / 16 ** 8
    B_local = max(B // max(dp * pods, 1), 1)
    per_token = S if mode != "decode" else 1
    compute = 40.0 * B_local * per_token / 1024 / tp
    comm = 120.0 * math.log2(tp) + 300.0 * (pp - 1) / micro
    step = 1e3 * (1.0 + compute / 1e3) + comm + 50.0 * jitter
    if mode == "train":
        step *= 1e3          # seconds a step, as failures over hours need
    weights = 8e9 / (tp * pp)
    opt = 2 * weights if mode == "train" else 0.0
    kv = 2.5e5 * B_local * S / tp if mode == "decode" else 0.0
    act = 1e5 * B_local * per_token / tp if mode != "decode" else 0.0
    tokens = float(B * per_token)
    return {"step": step, "weights": weights, "opt": opt, "kv": kv, "act": act,
            "total": weights + opt + kv + act, "tokens": tokens,
            "compute": 1e3 + compute, "comm": comm}


class StubSim:
    """A ``Simulator`` stand-in pricing from ``stub_numbers``; ``run(spec)``
    returns the package's own ``Report``.  ``runs`` counts the specs it
    priced, so a resumed sweep can be held to the remainder."""

    def __init__(self, pkg: str, hw: str = "h100_sxm"):
        self.pkg = pkg
        self.hw = HARDWARE[hw] if pkg == "port" else RSimMod.HARDWARE[hw]
        self.runs = 0

    def run(self, spec, **_):
        if spec.cluster.hardware != self.hw.name:
            raise ValueError(f"stub built for {self.hw.name!r}")
        _, sim_mod, mem_mod, _ = PKGS[self.pkg]
        p, w = spec.parallel, spec.workload
        n = stub_numbers(spec.json_hash(), w.mode, p.tp, p.pp, p.dp, p.pods,
                         p.microbatches, w.global_batch, w.seq_len)
        self.runs += 1
        chips = p.chips
        tps = n["tokens"] / (n["step"] / 1e6)
        mem = mem_mod.MemoryReport(
            weights=n["weights"], opt_state=n["opt"], kv_cache=n["kv"],
            activations_peak=n["act"], total=n["total"])
        return sim_mod.Report(
            mode=w.mode, step_time_us=n["step"], chips=chips,
            tokens_per_step=n["tokens"], tokens_per_s=tps, tps_per_chip=tps / chips,
            mfu=0.5 * n["compute"] / n["step"], model_flops=1e12 * n["tokens"],
            breakdown_us={"fwd": n["compute"], "pp_latency": n["comm"]},
            kind_us={"matmul": n["compute"], "all_reduce": n["comm"]}, memory=mem)

    def cache_stats(self) -> dict:
        return {}

    def save_cache(self):
        return None


def pkg_spec(name, model=ARCH, hw="h100_sxm", chips=16, memory_limit=0.0,
             workload=None, parallel=None):
    A, _, _, Par = PKGS[name]
    cfg = r_config(model) if name == "ref" else get_config(model)
    w = workload(A) if workload is not None else A.DecodeWorkload(seq_len=1024)
    return A.SimSpec(cfg, cluster=A.Cluster(hw, chips=chips, memory_limit=memory_limit),
                     parallel=parallel(Par) if parallel else Par(), workload=w)


def plain(x):
    """Cross-package form of a result: dataclasses as dicts (class names
    differ between the packages, fields must not)."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return dataclasses.asdict(x)
    if isinstance(x, (list, tuple)):
        return [plain(v) for v in x]
    return x


WALL_COUNTERS = ("sweep.wall_s", "sweep.configs_per_sec")


def counters_less_wall(metrics: dict) -> dict:
    """A sweep's counters without its wall-clock gauges (the histograms are
    all wall times of evaluation stages)."""
    return {k: v for k, v in metrics["counters"].items() if k not in WALL_COUNTERS}


def manifest_less_wall(path) -> dict:
    doc = json.loads(open(path).read())
    doc.pop("wall_time_s")
    doc["metrics"] = counters_less_wall(doc["metrics"])
    return doc


SPACES = {
    # bench_explore's space: rule- and memory-fit-pruned candidates
    "bench_explore": dict(model="qwen2.5-32b", hw="tpu_v5e", chips=256,
                          memory_limit=16e9,
                          workload=lambda A: A.DecodeWorkload(seq_len=8192),
                          axes={"tp": (4, 8, 16, 32), "pp": (1, 2, 4),
                                "batch": (16, 32, 64, 128, 256, 512)}),
    # memory pruned after pricing (the stub's memory > 12 GB)
    "decode_h100": dict(model=ARCH, hw="h100_sxm", chips=16, memory_limit=12e9,
                        workload=lambda A: A.DecodeWorkload(seq_len=2048),
                        axes={"tp": (1, 2, 3, 4), "pp": (1, 2),
                              "batch": (8, 16, 100)}),
    "train_micro": dict(model=ARCH, hw="h100_sxm", chips=8, memory_limit=0.0,
                        workload=lambda A: A.TrainWorkload(global_batch=32, seq_len=512),
                        axes={"tp": (1, 2), "pp": (1, 2), "micro": (1, 2, 4),
                              "workload.remat": ("block", "none")}),
}


def space_pair(key):
    d = dict(SPACES[key])
    axes = d.pop("axes")
    return {name: PKGS[name][0].SweepSpace(pkg_spec(name, **d), axes) for name in PKGS}


def sweep_pair(key, tmp_path=None, **kw):
    out = {}
    for name, space in space_pair(key).items():
        A = PKGS[name][0]
        extra = {}
        if tmp_path is not None:
            extra = {"manifest": str(tmp_path / f"{name}.json"),
                     "journal": str(tmp_path / f"{name}.jsonl")}
        out[name] = A.sweep(space, sim=StubSim(name, space.base.cluster.hardware),
                            **extra, **kw)
    return out


@pytest.mark.parametrize("key", sorted(SPACES))
def test_enumeration_hashes_equal_the_reference(key):
    sp = space_pair(key)
    assert sp["port"].size() == sp["ref"].size()
    assert [s.json_hash() for s in sp["port"].points()] == \
        [s.json_hash() for s in sp["ref"].points()]


@pytest.mark.parametrize("key", sorted(SPACES))
def test_stub_priced_sweep_equals_the_reference(key, tmp_path):
    res = sweep_pair(key, tmp_path)
    port, ref = res["port"], res["ref"]
    assert ref.pruned or key == "train_micro"
    assert plain(port.evaluated) == plain(ref.evaluated)
    assert plain(port.pruned) == plain(ref.pruned)
    assert [(r.spec.json_hash(), r.reason) for r in port.pruned] == \
        [(r.spec.json_hash(), r.reason) for r in ref.pruned]
    hashes = lambda rs: [r.spec.json_hash() for r in rs]
    assert hashes(port.ranked()) == hashes(ref.ranked())
    assert hashes(port.pareto()) == hashes(ref.pareto())
    for slo in ({"tpot_ms": 1.5}, {"min_tps_user": 700.0}, {}):
        a, b = port.best_under_slo(**slo), ref.best_under_slo(**slo)
        assert (a is None) == (b is None)
        if a is not None:
            assert a.spec.json_hash() == b.spec.json_hash()
    assert port.n_groups == ref.n_groups
    assert counters_less_wall(port.metrics) == counters_less_wall(ref.metrics)
    assert manifest_less_wall(tmp_path / "port.json") == \
        manifest_less_wall(tmp_path / "ref.json")
    # journal rows: the same header and rows; each row's pickled result
    # loads in its own package to the same fields
    jp = (tmp_path / "port.jsonl").read_text().splitlines()
    jr = (tmp_path / "ref.jsonl").read_text().splitlines()
    assert json.loads(jp[0]) == json.loads(jr[0])
    rows_p, rows_r = TP.SweepJournal.load(str(tmp_path / "port.jsonl")), \
        RP.SweepJournal.load(str(tmp_path / "ref.jsonl"))
    assert list(rows_p) == list(rows_r)
    for h in rows_p:
        assert rows_p[h]["status"] == rows_r[h]["status"]
        assert plain(TP.SweepJournal.result_from(rows_p[h])) == \
            plain(RP.SweepJournal.result_from(rows_r[h]))


@pytest.mark.parametrize("writer,reader", [("ref", "port"), ("port", "ref")])
def test_journal_written_by_one_package_resumes_in_the_other(writer, reader, tmp_path):
    """A journal cut after 10 rows resumes in the other package: its header
    validates there, the 10 recorded candidates are injected, only the rest
    are priced, and the merged result equals the reader's uninterrupted
    sweep.  The port reads the reference's rows as its own classes."""
    sp = space_pair("decode_h100")
    jr = tmp_path / "j.jsonl"
    PKGS[writer][0].sweep(sp[writer], sim=StubSim(writer), journal=str(jr))
    lines = jr.read_text().splitlines()
    jr.write_text("\n".join(lines[:11]) + "\n")
    A = PKGS[reader][0]
    stub = StubSim(reader)
    resumed = A.sweep(sp[reader], sim=stub, journal=str(jr))
    whole_stub = StubSim(reader)
    whole = A.sweep(sp[reader], sim=whole_stub)
    assert resumed.metrics["counters"]["sweep.resumed"] == 10
    assert stub.runs == whole_stub.runs - 10
    assert plain(resumed.evaluated) == plain(whole.evaluated)
    assert plain(resumed.pruned) == plain(whole.pruned)
    assert [r.spec.json_hash() for r in resumed.ranked()] == \
        [r.spec.json_hash() for r in whole.ranked()]
    if reader == "port":
        assert all(type(r).__module__ == "repro_torch.core.explorer"
                   for r in resumed.evaluated + resumed.pruned)


def test_port_journal_rows_load_without_the_reference_package(tmp_path):
    """The port's ``SweepJournal.result_from`` maps the reference's class
    paths onto the port's: a subprocess that imports only the port resumes a
    journal the reference wrote, and ``repro`` never enters ``sys.modules``."""
    import subprocess
    import sys
    from pathlib import Path
    sp = space_pair("decode_h100")
    jr = tmp_path / "j.jsonl"
    RA.sweep(sp["ref"], sim=StubSim("ref"), journal=str(jr))
    script = tmp_path / "load.py"
    script.write_text(
        "import sys\n"
        "from repro_torch.api.pool import SweepJournal\n"
        f"rows = SweepJournal.load({str(jr)!r})\n"
        "res = [SweepJournal.result_from(r) for r in rows.values()]\n"
        "assert all(type(r).__module__ == 'repro_torch.core.explorer' for r in res)\n"
        "bad = [m for m in sys.modules if m == 'repro' or m.startswith(('repro.', 'jax'))]\n"
        "assert not bad, bad\n"
        "print(len(res))\n")
    root = Path(__file__).resolve().parent.parent
    out = subprocess.run([sys.executable, str(script)], capture_output=True, text=True,
                         env={"PYTHONPATH": str(root / "src"), "PATH": "/usr/bin:/bin"},
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) == len(RP.SweepJournal.load(str(jr)))


def test_serial_and_pooled_sweeps_are_bit_identical():
    """The port's own analytical engine, serial against ``workers=2``
    (forked workers trace with ``make_fx`` over FakeTensors)."""
    base = SimSpec(CFG, cluster=Cluster("h100_sxm", chips=8, memory_limit=80e9),
                   workload=DecodeWorkload(seq_len=1024))
    space = SweepSpace(base, {"tp": (1, 2, 4), "pp": (1, 2), "batch": (8, 16)})
    serial = sweep(space)
    parallel = sweep(space, workers=2)
    key = lambda res: ([plain(r.report) for r in res.evaluated],
                       [(r.cand.key(), r.reason) for r in res.pruned],
                       [r.cand.key() for r in res.ranked()],
                       [r.cand.key() for r in res.pareto()])
    assert key(serial) == key(parallel)
    assert parallel.workers == 2 and serial.workers == 1
    for layer in ("ingest", "block_times", "pricing", "collectives"):
        assert layer in parallel.cache_stats


def test_shard_items_keeps_trace_families_together():
    from repro_torch.api.sweep import _shard_items
    space = SweepSpace(SimSpec(CFG, cluster=Cluster("h100_sxm", chips=16),
                               workload=DecodeWorkload(seq_len=1024)),
                       {"tp": (1, 2, 4), "pp": (1, 2), "batch": (8, 16, 32)})
    items = [(i, s, Candidate(s.parallel, s.workload.global_batch))
             for i, s in enumerate(space.points())]
    shards = _shard_items(items, 2)
    assert sum(len(s) for s in shards) == len(items)
    fams = lambda shard: {(s.B_local(), s.workload.seq_len, s.workload.cache_len)
                          for _, s, _ in shard}
    assert len(shards) == 2 and not fams(shards[0]) & fams(shards[1])
    # the same layout as the reference's, candidate for candidate
    from repro.api.sweep import _shard_items as r_shard
    r_space = space_pair("decode_h100")["ref"]
    t_space = space_pair("decode_h100")["port"]
    mk = lambda sp, C: [(i, s, C(s.parallel, s.workload.global_batch))
                        for i, s in enumerate(sp.points())]
    layout = lambda shards: [[(i, s.json_hash()) for i, s, _ in sh] for sh in shards]
    assert layout(_shard_items(mk(t_space, Candidate), 3)) == \
        layout(r_shard(mk(r_space, RE.Candidate), 3))


# ---------------- each package's own analytical simulator ----------------

def table_read_us(hw: str, cfg, B_local: int) -> float:
    """The port's analytical price of the reference's head lookup: one
    elementwise read of the whole embedding table (ROADMAP queue C)."""
    node = OpNode("embed_table_read", "elementwise", dtype="bf16",
                  bytes_in=cfg.vocab_size * cfg.d_model * 2 + 4 * B_local,
                  bytes_out=4 * B_local * cfg.d_model)
    return AnalyticalEngine(HARDWARE[hw]).latency_us(node)


def test_bench_explore_space_within_tolerances_of_the_reference():
    d = dict(SPACES["bench_explore"])
    axes = d.pop("axes")
    ref = RA.sweep(RA.SweepSpace(pkg_spec("ref", **d), axes), sim=RSim("tpu_v5e"))
    port = sweep(SweepSpace(pkg_spec("port", **d), axes), sim=Simulator("tpu_v5e"))
    by = lambda res: {r.spec.json_hash(): r for r in res.evaluated}
    rr, pp = by(ref), by(port)
    assert set(pp) == set(rr) and len(rr) == 61
    assert [(r.spec.json_hash(), r.reason) for r in port.pruned] == \
        [(r.spec.json_hash(), r.reason) for r in ref.pruned]
    cfg = get_config("qwen2.5-32b")
    for h, r in rr.items():
        a, b = r.report, pp[h].report
        assert b.memory.total == pytest.approx(a.memory.total, rel=MEM_TOL)
        priced = b.step_time_us + table_read_us("tpu_v5e", cfg, r.cand.B_local())
        assert priced == pytest.approx(a.step_time_us, rel=STEP_TOL), r.cand.key()
    hs = sorted(rr)
    pairs = 0
    for i, x in enumerate(hs):
        for y in hs[i + 1:]:
            a1, a2 = rr[x].report.step_time_us, rr[y].report.step_time_us
            if max(a1, a2) / min(a1, a2) > 1 + ORDER_GAP:
                pairs += 1
                b1, b2 = pp[x].report.step_time_us, pp[y].report.step_time_us
                assert (a1 < a2) == (b1 < b2), (rr[x].cand.key(), rr[y].cand.key())
    assert pairs > 100


# ---------------- the explorer's surface (test_api_spec / test_perf_cache / test_sim_core) ----

GRID = dict(tp_choices=(1, 2, 4), pp_choices=(1, 2), batch_choices=(8, 16, 100))


def _space(memory_limit=0.0):
    base = SimSpec(CFG, cluster=Cluster("h100_sxm", chips=16, memory_limit=memory_limit),
                   workload=DecodeWorkload(seq_len=1024))
    return SweepSpace(base, {"tp": GRID["tp_choices"], "pp": GRID["pp_choices"],
                             "batch": GRID["batch_choices"]})


def test_sweep_rejects_serving_workload_base():
    base = SimSpec(CFG, cluster=Cluster("h100_sxm", chips=4),
                   workload=ServingWorkload(n_requests=5))
    with pytest.raises(TypeError):
        sweep(SweepSpace(base, {"tp": (1, 2)}))


def test_sweep_axis_typos_fail_fast():
    base = SimSpec(CFG, workload=DecodeWorkload())
    with pytest.raises(KeyError):
        SweepSpace(base, {"workload.seq_length": (512,)})
    with pytest.raises(KeyError):
        SweepSpace(base, {"seq_length": (512,)})
    with pytest.raises(KeyError):
        SweepSpace(base, {"engine.tp": (1,)})
    with pytest.raises(TypeError):
        SweepSpace(base, {"hardware": "h100_sxm"})
    with pytest.raises(ValueError):
        with pytest.warns(CharonDeprecationWarning):
            explore(Simulator("h100_sxm"), CFG, chips=4, memory_limit=0.0)


def test_legacy_explore_shim_warns_and_is_bit_identical():
    with pytest.warns(CharonDeprecationWarning):
        legacy = explore(Simulator("h100_sxm"), CFG, mode="decode", seq_len=1024,
                         chips=16, memory_limit=16e9, **GRID)
    new = sweep(_space(memory_limit=16e9), sim=Simulator("h100_sxm"))
    key = lambda res: [(r.cand.key(), r.report.step_time_us, r.tps_per_chip)
                       for r in res.ranked()]
    assert key(legacy) == key(new)
    assert [(p.cand.key(), p.reason) for p in legacy.pruned] == \
        [(p.cand.key(), p.reason) for p in new.pruned]
    assert legacy.n_groups == new.n_groups
    assert [r.cand.key() for r in legacy.pareto()] == [r.cand.key() for r in new.pareto()]
    for layer in ("block_times", "pricing", "ingest"):
        assert legacy.cache_stats[layer] == new.cache_stats[layer]
    assert all(r.spec is not None for r in new.evaluated)


def test_plain_sweep_raises_no_deprecation_warning():
    """``pytest.ini`` escalates only the reference's warning class; the
    port's is escalated here around a plain ``sweep()``."""
    space = SweepSpace(SimSpec(CFG, cluster=Cluster("h100_sxm", chips=2),
                               workload=DecodeWorkload(seq_len=512)),
                       {"tp": (1, 2), "batch": (8,)})
    with warnings.catch_warnings():
        warnings.simplefilter("error", CharonDeprecationWarning)
        res = sweep(space)
    assert len(res.evaluated) == 2


def test_sweep_axes_beyond_the_legacy_grid():
    base = SimSpec(CFG, cluster=Cluster("h100_sxm", chips=8), parallel=ParallelConfig(),
                   workload=DecodeWorkload(global_batch=16))
    space = SweepSpace(base, {"tp": (1, 2), "seq_len": (512, 2048),
                              "quantize": (None, "int8"),
                              "hardware": ("tpu_v5e", "h100_sxm")})
    assert space.size() == 16
    res = sweep(space)
    assert len(res.evaluated) == 16
    assert {r.spec.cluster.hardware for r in res.evaluated} == {"tpu_v5e", "h100_sxm"}
    by = {(r.spec.cluster.hardware, r.spec.parallel.tp, r.spec.workload.seq_len,
           r.spec.workload.quantize): r.report.step_time_us for r in res.evaluated}
    for h in ("tpu_v5e", "h100_sxm"):
        assert by[(h, 2, 2048, "int8")] < by[(h, 2, 2048, None)]
    assert res.n_groups == 16
    assert res.cache_stats["pricing"]["hits"] > 0


def test_sweep_derives_dp_and_skips_nondivisible():
    base = SimSpec(CFG, cluster=Cluster("h100_sxm", chips=8),
                   workload=DecodeWorkload(global_batch=8, seq_len=512))
    res = sweep(SweepSpace(base, {"tp": (1, 2, 3)}))
    assert sorted(r.spec.parallel.tp for r in res.evaluated) == [1, 2]
    assert all(r.spec.parallel.chips == 8 for r in res.evaluated)


def test_memory_liveness_memoized_across_candidates():
    sim = Simulator("h100_sxm")
    spec = SimSpec(CFG, parallel=ParallelConfig(tp=2, dp=4),
                   workload=DecodeWorkload(global_batch=8, seq_len=512))
    r1 = sim.run(spec)
    assert sim.cache_stats()["memory"] == {"hits": 0, "misses": 1, "hit_rate": 0.0}
    r2 = sim.run(spec_replace(spec, {"parallel.dp": 8, "workload.global_batch": 16}))
    st = sim.cache_stats()["memory"]
    assert st["hits"] == 1 and st["misses"] == 1
    assert r1.memory.activations_peak == r2.memory.activations_peak


def _grid(tp=(1, 2, 4), pp=(1, 2), batch=(8, 16, 32), memory_limit=0.0):
    base = SimSpec(CFG, cluster=Cluster("h100_sxm", chips=16, memory_limit=memory_limit),
                   workload=DecodeWorkload(seq_len=1024))
    return SweepSpace(base, {"tp": tp, "pp": pp, "batch": batch})


def test_explore_pricing_cache_hit_rate_and_stats():
    res = sweep(_grid(), sim=Simulator("h100_sxm"))
    assert res.evaluated and res.configs_per_sec > 0 and res.n_groups > 0
    pr = res.cache_stats["pricing"]
    assert pr["hits"] / (pr["hits"] + pr["misses"]) > 0.3
    assert res.cache_stats["block_times"]["hits"] > 0
    assert res.cache_stats["ingest"]["misses"] < len(res.evaluated)


def test_explore_deterministic_pareto():
    def frontier():
        res = sweep(_grid(), sim=Simulator("h100_sxm"))
        return [(r.cand.key(), r.report.step_time_us, r.tps_per_chip) for r in res.pareto()]
    assert frontier() == frontier()
    sim = Simulator("h100_sxm")
    key = lambda res: [(r.cand.key(), r.report.step_time_us) for r in res.pareto()]
    assert key(sweep(_grid(), sim=sim)) == key(sweep(_grid(), sim=sim))


def test_rule_memory_fit_prunes_before_simulation():
    rule = rule_memory_fit(1e6, mode="decode", seq_len=4096)
    c = Candidate(ParallelConfig(tp=2, dp=8), 32)
    assert "memory-fit" in rule(CFG, c)
    assert rule_memory_fit(1e15, mode="decode", seq_len=4096)(CFG, c) is None
    res = sweep(_grid(tp=(1, 2), pp=(1,), batch=(8, 16), memory_limit=1e6),
                sim=Simulator("h100_sxm"))
    assert not res.evaluated
    assert all(p.report is None and "memory-fit" in p.reason for p in res.pruned)


def test_memory_fit_estimate_is_lower_bound():
    sim = Simulator("h100_sxm")
    for tp, gb in [(1, 8), (2, 16), (4, 32)]:
        par = ParallelConfig(tp=tp, dp=16 // tp)
        rep = sim.run(SimSpec(CFG, parallel=par,
                              workload=DecodeWorkload(global_batch=gb, seq_len=1024)))
        rule = rule_memory_fit(rep.memory.total, mode="decode", seq_len=1024)
        assert rule(CFG, Candidate(par, gb)) is None


def test_explorer_pruning_and_pareto():
    base = SimSpec(CFG, cluster=Cluster("h100_sxm", chips=16),
                   workload=DecodeWorkload(seq_len=2048))
    res = sweep(SweepSpace(base, {"tp": (1, 2, 4), "pp": (1,), "batch": (8, 16, 100)}),
                sim=Simulator("h100_sxm"))
    assert res.pruned, "divisibility rule should prune batch=100 w/ dp"
    front = res.pareto()
    xs = [1e6 / r.report.step_time_us for r in front]
    assert xs == sorted(xs, reverse=True) or len(front) == 1
    best = res.best_under_slo(tpot_ms=1e9)
    assert best.tps_per_chip == max(r.tps_per_chip for r in res.evaluated)


def test_ranked_objectives_need_their_sweeps():
    res = sweep(_grid(tp=(1, 2), pp=(1,), batch=(8,)), sim=StubSim("port"))
    assert res.ranked("step_time")
    for objective in ("goodput", "goodput_under_failures"):
        with pytest.raises(ValueError):
            res.ranked(objective)
    with pytest.raises(ValueError):
        sweep(_grid(), sim=StubSim("port"), objective="nonsense")


# ---------------- the pool's start method ----------------

@pytest.mark.parametrize("cuda_up,want", [(True, "spawn"), (False, "fork")])
def test_default_context_spawns_once_cuda_is_initialised(monkeypatch, cuda_up, want):
    import multiprocessing as mp

    import torch
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: cuda_up)
    if want == "fork" and "fork" not in mp.get_all_start_methods():
        want = "spawn"
    assert TP.default_context() == want
    # the reference's rule, which knows nothing of CUDA
    assert RP.default_context() == ("fork" if "fork" in mp.get_all_start_methods() else "spawn")


def test_moe_sweep_derives_ep_as_the_reference():
    """An MoE model's expert parallelism follows tp unless ep is an axis: the
    derived specs, and each package's own analytical reports of them (the
    expert-parallel pass, its all_to_all pair), equal the reference's."""
    kw = dict(model="olmoe-1b-7b", chips=8, workload=lambda A: A.DecodeWorkload(
        global_batch=8, seq_len=2048))
    sp = {name: PKGS[name][0].SweepSpace(pkg_spec(name, **kw), {"tp": (1, 2, 4, 8)})
          for name in PKGS}
    pts = {name: list(s.points()) for name, s in sp.items()}
    assert [p.parallel.ep for p in pts["port"]] == [p.parallel.ep for p in pts["ref"]] == \
        [1, 2, 4, 8]
    assert [p.json_hash() for p in pts["port"]] == [p.json_hash() for p in pts["ref"]]
    res = {"ref": RA.sweep(sp["ref"], sim=RSim("h100_sxm")),
           "port": sweep(sp["port"], sim=Simulator("h100_sxm"))}
    by = {name: {r.spec.parallel.tp: r.report for r in res[name].evaluated} for name in res}
    assert sorted(by["port"]) == sorted(by["ref"]) == [1, 2, 4, 8]
    for tp, t in by["port"].items():
        r = by["ref"][tp]
        assert t.kind_us.get("all_to_all", 0.0) == pytest.approx(
            r.kind_us.get("all_to_all", 0.0), rel=1e-12)
        assert t.kind_us["matmul"] == pytest.approx(r.kind_us["matmul"], rel=1e-12)
        assert t.step_time_us == pytest.approx(r.step_time_us, rel=STEP_TOL)
    assert "all_to_all" not in by["port"][1].kind_us and by["port"][8].kind_us["all_to_all"] > 0
    explicit = SweepSpace(pkg_spec("port", **kw), {"tp": (2,), "ep": (1,)})
    assert [p.parallel.ep for p in explicit.points()] == [1]


# ---------------- the reference's own config: xlstm-125m on tpu_v5e ----------------

XLSTM = get_config("xlstm-125m")


def _xspace(A=TA, memory_limit=16e9):
    """The reference's ``_space`` (tests/test_sweep_parallel.py): xlstm-125m
    decode on 16 chips of ``tpu_v5e``, tp x pp x batch."""
    cfg = XLSTM if A is TA else r_config("xlstm-125m")
    base = A.SimSpec(cfg, cluster=A.Cluster("tpu_v5e", chips=16, memory_limit=memory_limit),
                     workload=A.DecodeWorkload(seq_len=1024))
    return A.SweepSpace(base, {"tp": (1, 2, 4), "pp": (1, 2), "batch": (8, 16, 32)})


def test_xlstm_serial_and_pooled_sweeps_are_bit_identical():
    serial = sweep(_xspace())
    parallel = sweep(_xspace(), workers=2)
    key = lambda res: ([plain(r.report) for r in res.evaluated],
                       [(r.cand.key(), r.reason) for r in res.pruned],
                       [r.cand.key() for r in res.ranked()],
                       [r.cand.key() for r in res.pareto()])
    assert key(serial) == key(parallel)
    assert parallel.workers == 2 and serial.workers == 1
    for layer in ("ingest", "block_times", "pricing", "collectives"):
        assert layer in parallel.cache_stats
    assert len(parallel.evaluated) + len(parallel.pruned) == \
        len(serial.evaluated) + len(serial.pruned)


def test_xlstm_parallel_sweep_memory_pruning_matches():
    serial = sweep(_xspace(memory_limit=2e9))
    parallel = sweep(_xspace(memory_limit=2e9), workers=2)
    assert [(p.cand.key(), p.reason) for p in serial.pruned] == \
        [(p.cand.key(), p.reason) for p in parallel.pruned]


def test_xlstm_sweep_within_tolerances_of_the_reference():
    """Each package's own analytical engine on the reference's space: the
    same candidates evaluated and pruned (18, none pruned), memory within
    ``MEM_TOL`` and step time within ``STEP_TOL`` (measured memory +0.00 to
    +0.03 %, step -8.8 to -13.3 %: the port's decode block is below the
    reference's, ``tests/test_torch_simulator.py`` has its parts)."""
    ref = RA.sweep(_xspace(RA), sim=RSim("tpu_v5e"))
    port = sweep(_xspace(), sim=Simulator("tpu_v5e"))
    by = lambda res: {r.spec.json_hash(): r for r in res.evaluated}
    rr, pp = by(ref), by(port)
    assert set(pp) == set(rr) and rr
    assert [(r.spec.json_hash(), r.reason) for r in port.pruned] == \
        [(r.spec.json_hash(), r.reason) for r in ref.pruned]
    for h, r in rr.items():
        a, b = r.report, pp[h].report
        assert b.memory.total == pytest.approx(a.memory.total, rel=MEM_TOL), r.cand.key()
        assert b.step_time_us == pytest.approx(a.step_time_us, rel=STEP_TOL), r.cand.key()


def test_xlstm_ingest_extrapolation_bit_exact_and_self_verifying():
    from repro.core import model_ingest as r_ingest
    from repro_torch.core import model_ingest as t_ingest

    def sig(mg):
        return [(bg.kind, bg.repeat,
                 [(n.name, n.kind, n.dtype, n.flops, n.bytes_in, n.bytes_out,
                   tuple(n.out_shape), tuple(sorted(n.attrs.items())), tuple(n.deps), n.repeat)
                  for g in (bg.fwd, bg.joint) if g is not None for n in g.toposort()])
                for bg in mg.all_blocks()]

    stats = {}
    for name, mod, cfg in (("ref", r_ingest, r_config("xlstm-125m")), ("port", t_ingest, XLSTM)):
        mod.ingest_extrapolation_clear()
        try:
            for B in (1, 2, 4, 8, 16, 32, 64):
                a = mod.ingest_graphs(cfg, B, 1, "decode", cache_len=512)
                if name == "port":
                    assert sig(a) == sig(mod.block_graphs(cfg, B, 1, "decode", cache_len=512)), B
            stats[name] = mod.ingest_extrapolation_stats()
        finally:
            mod.ingest_extrapolation_clear()
    assert stats["port"] == stats["ref"]
    assert stats["port"]["extrapolated"] >= 2 and stats["port"]["traced"] <= 5


def test_xlstm_explorer_pruning_and_pareto():
    """``tests/test_sim_core.py``'s case on its own config: xlstm-125m decode
    on 16 chips of ``tpu_v5e``."""
    base = SimSpec(XLSTM, cluster=Cluster("tpu_v5e", chips=16),
                   workload=DecodeWorkload(seq_len=2048))
    res = sweep(SweepSpace(base, {"tp": (1, 2, 4), "pp": (1,), "batch": (8, 16, 100)}),
                sim=Simulator("tpu_v5e", engine="analytical"))
    assert res.pruned, "divisibility rule should prune batch=100 w/ dp"
    front = res.pareto()
    xs = [1e6 / r.report.step_time_us for r in front]
    assert xs == sorted(xs, reverse=True) or len(front) == 1
    best = res.best_under_slo(tpot_ms=1e9)
    assert best is not None
    assert best.tps_per_chip == max(r.tps_per_chip for r in res.evaluated)
