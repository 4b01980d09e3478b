"""The jax-free simulator core carried into ``repro_torch.core``, held against
``repro.core`` bit for bit: the same hand-built ``Graph`` goes through both
packages' engines, collectives, scheduler, overlap models, liveness, memory
model, random forest and passes, and every result is compared with ``==``.
Twins of ``tests/test_sim_core.py`` and of the pass half of
``tests/test_tracer_passes.py``."""
import dataclasses
import math

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

import repro.core.backend.analytical as r_analytical
import repro.core.backend.collectives as r_coll
import repro.core.backend.hardware as r_hw
import repro.core.backend.prediction as r_pred
import repro.core.ir as r_ir
import repro.core.memory as r_mem
import repro.core.overlap as r_overlap
import repro.core.passes.analysis as r_analysis
import repro.core.passes.base as r_base
import repro.core.passes.data_parallel as r_dp
import repro.core.passes.fusion as r_fusion
import repro.core.passes.parallelism as r_par
import repro.core.passes.pipeline as r_pipe
import repro.core.passes.quantize as r_quant
import repro.core.passes.recompute as r_remat
import repro.core.scheduler as r_sched
import repro_torch.core.backend.analytical as t_analytical
import repro_torch.core.backend.collectives as t_coll
import repro_torch.core.backend.hardware as t_hw
import repro_torch.core.backend.prediction as t_pred
import repro_torch.core.ir as t_ir
import repro_torch.core.memory as t_mem
import repro_torch.core.overlap as t_overlap
import repro_torch.core.passes.analysis as t_analysis
import repro_torch.core.passes.base as t_base
import repro_torch.core.passes.data_parallel as t_dp
import repro_torch.core.passes.fusion as t_fusion
import repro_torch.core.passes.parallelism as t_par
import repro_torch.core.passes.pipeline as t_pipe
import repro_torch.core.passes.quantize as t_quant
import repro_torch.core.passes.recompute as t_remat
import repro_torch.core.scheduler as t_sched

REF = dict(ir=r_ir, hw=r_hw, an=r_analytical, coll=r_coll, pred=r_pred, mem=r_mem,
           ov=r_overlap, analysis=r_analysis, base=r_base, dp=r_dp, fusion=r_fusion,
           par=r_par, pipe=r_pipe, quant=r_quant, remat=r_remat, sched=r_sched)
PORT = dict(ir=t_ir, hw=t_hw, an=t_analytical, coll=t_coll, pred=t_pred, mem=t_mem,
            ov=t_overlap, analysis=t_analysis, base=t_base, dp=t_dp, fusion=t_fusion,
            par=t_par, pipe=t_pipe, quant=t_quant, remat=t_remat, sched=t_sched)
HW_NAMES = ("tpu_v5e", "tpu_v5p", "a100_80g", "h100_sxm", "xla_cpu")


def both(fn):
    """fn(package) for the reference and the port."""
    return fn(REF), fn(PORT)


def node_tuple(n):
    return (n.name, n.kind, tuple(n.deps), tuple(n.out_shape), n.dtype, n.flops, n.bytes_in,
            n.bytes_out, n.comm_bytes, n.comm_group, n.comm_size, n.overlappable, n.stream,
            n.repeat, n.phase, tuple(sorted(n.attrs.items())))


def graph_tuple(g):
    return [node_tuple(n) for n in g.nodes.values()]


def block_graph(m, *, feat=3072, ff=8192, rows=512, comm=True):
    """A transformer-block-shaped graph: norm chain, column/row matmul
    pairs, attention, an FFN, a DP all-reduce on its own stream."""
    g = m["ir"].Graph("block")
    x = g.op("elementwise", out_shape=(rows, feat), dtype="f32", flops=rows * feat,
             bytes_in=2 * rows * feat, bytes_out=4 * rows * feat)
    r = g.op("reduce", deps=[x.name], out_shape=(rows,), dtype="f32", flops=rows * feat,
             bytes_in=4 * rows * feat, bytes_out=4 * rows)
    n = g.op("elementwise", deps=[x.name, r.name], out_shape=(rows, feat), flops=3 * rows * feat,
             bytes_in=4 * rows * feat, bytes_out=2 * rows * feat)
    q = g.op("matmul", deps=[n.name], out_shape=(rows, feat), flops=2.0 * rows * feat * feat,
             bytes_in=2.0 * (rows * feat + feat * feat), bytes_out=2.0 * rows * feat,
             attrs={"mm_dims": (rows, feat, feat),
                    "mm_bytes": (2.0 * rows * feat, 2.0 * feat * feat)})
    a = g.op("attention", deps=[q.name], out_shape=(1, rows, 8, 3, 128), flops=1.6e9,
             bytes_in=5.2e6, bytes_out=3.1e6,
             attrs={"attn_dims": (1, 24, rows, rows, 128), "causal": True, "window": 0})
    c = g.op("copy", deps=[a.name], out_shape=(rows, feat), bytes_in=3.1e6, bytes_out=3.1e6)
    o = g.op("matmul", deps=[c.name], out_shape=(rows, feat), flops=2.0 * rows * feat * feat,
             bytes_in=2.0 * (rows * feat + feat * feat), bytes_out=2.0 * rows * feat,
             attrs={"mm_dims": (rows, feat, feat),
                    "mm_bytes": (2.0 * rows * feat, 2.0 * feat * feat)})
    up = g.op("matmul", deps=[o.name], out_shape=(rows, ff), flops=2.0 * rows * ff * feat,
              bytes_in=2.0 * (rows * feat + feat * ff), bytes_out=2.0 * rows * ff,
              attrs={"mm_dims": (rows, ff, feat), "mm_bytes": (2.0 * rows * feat, 2.0 * feat * ff)})
    s = g.op("elementwise", deps=[up.name], out_shape=(rows, ff), flops=4.0 * rows * ff,
             bytes_in=2.0 * rows * ff, bytes_out=2.0 * rows * ff)
    dn = g.op("matmul", deps=[s.name], out_shape=(rows, feat), flops=2.0 * rows * ff * feat,
              bytes_in=2.0 * (rows * ff + feat * ff), bytes_out=2.0 * rows * feat,
              attrs={"mm_dims": (rows, feat, ff), "mm_bytes": (2.0 * rows * ff, 2.0 * feat * ff)})
    g.op("scatter", deps=[dn.name], out_shape=(8, 2048, 8, 128), bytes_in=16448.0,
         bytes_out=16448.0, attrs={"operand_bytes": 33554432.0})
    if comm:
        g.op("all_reduce", deps=[dn.name], comm_bytes=6.3e6, comm_group="dp", comm_size=8,
             overlappable=True, stream="dp_comm", bytes_in=6.3e6, bytes_out=6.3e6)
    return g


# ---------------- collectives ----------------

def test_collective_byte_formulas_match():
    for kind in ("all_reduce", "all_gather", "reduce_scatter", "all_to_all", "send"):
        for n in (1, 2, 8, 64):
            r, t = both(lambda m: m["coll"].link_traffic_bytes(kind, 1024.0, n))
            assert r == t


@settings(max_examples=25, deadline=None)
@given(payload=st.floats(1e3, 1e9), n=st.integers(2, 64))
def test_collective_time_matches(payload, n):
    for hw in HW_NAMES:
        r, t = both(lambda m: m["coll"].collective_time_us(
            "all_reduce", payload, n, m["hw"].HARDWARE[hw].intra))
        assert r == t


@pytest.mark.parametrize("hw", HW_NAMES)
def test_hierarchical_collectives_match(hw):
    for kind in ("all_reduce", "all_gather", "reduce_scatter", "all_to_all", "send"):
        for intra, inter in ((1, 1), (16, 1), (16, 2), (4, 8)):
            r, t = both(lambda m: m["coll"].hierarchical_collective_time_us(
                kind, 64e6, m["coll"].GroupSpec(intra, inter), m["hw"].HARDWARE[hw]))
            assert r == t


def test_hardware_registry_is_carried_field_for_field():
    assert set(r_hw.HARDWARE) == set(t_hw.HARDWARE) == set(HW_NAMES)
    for name in HW_NAMES:
        r, t = r_hw.HARDWARE[name], t_hw.HARDWARE[name]
        assert dataclasses.asdict(r) == dataclasses.asdict(t)
    assert t_hw.HARDWARE["h100_sxm"].peak_flops["bf16"] == 989e12
    assert t_hw.HARDWARE["h100_sxm"].hbm_bw == 3350e9


# ---------------- analytical engine ----------------

@pytest.mark.parametrize("hw", HW_NAMES)
def test_analytical_latency_and_price_batch_match(hw):
    r_eng = r_analytical.AnalyticalEngine(r_hw.HARDWARE[hw])
    t_eng = t_analytical.AnalyticalEngine(t_hw.HARDWARE[hw])
    rg, tg = both(block_graph)
    r_lat = [r_eng.latency_us(n) for n in rg]
    t_lat = [t_eng.latency_us(n) for n in tg]
    assert r_lat == t_lat
    assert r_eng.price_batch(list(rg)) == t_eng.price_batch(list(tg)) == t_lat


def test_roofline_and_misalignment_match():
    for m_, n_, k_ in ((1024, 1024, 1024), (1024, 5, 1024), (8, 3072, 3072), (3, 200064, 3072)):
        r, t = both(lambda m: m["an"].AnalyticalEngine(m["hw"].TPU_V5E).latency_us(
            m["ir"].OpNode("a", "matmul", flops=2.0 * m_ * n_ * k_, bytes_in=1e6, bytes_out=1e6,
                           attrs={"mm_dims": (m_, n_, k_)})))
        assert r == t
    eng = t_analytical.AnalyticalEngine(t_hw.TPU_V5E)
    aligned = eng.latency_us(t_ir.OpNode("a", "matmul", flops=1e12, attrs={"mm_dims": (1024, 1024, 1024)}))
    skinny = eng.latency_us(t_ir.OpNode("b", "matmul", flops=1e12, attrs={"mm_dims": (1024, 5, 1024)}))
    assert skinny > aligned


# ---------------- scheduler + overlap ----------------

def _intervals(tl):
    return [(i.name, i.kind, i.stream, i.start, i.end, i.comm_bytes) for i in tl.intervals]


@pytest.mark.parametrize("overlap", ["ratio", "bandwidth"])
@pytest.mark.parametrize("hw", ["tpu_v5e", "h100_sxm"])
def test_schedule_overlap_and_schedule_times_match(hw, overlap):
    def run(m):
        g = block_graph(m)
        h = m["hw"].HARDWARE[hw]
        eng = m["an"].AnalyticalEngine(h)
        tl = m["sched"].schedule(g, eng)
        tl = (m["ov"].apply_ratio_overlap if overlap == "ratio"
              else m["ov"].apply_bandwidth_aware)(tl, h)
        fast = m["sched"].schedule_times(g, eng, h, overlap=overlap)
        return _intervals(tl), tl.total_time, tl.by_kind(), fast
    r, t = both(run)
    assert r == t


def test_bandwidth_aware_comm_matches():
    def run(m):
        iv = m["sched"].Interval
        tl = [iv(f"f{i}", "all_gather", f"s{i}", s, s + d, comm_bytes=d * 1e5)
              for i, (s, d) in enumerate([(0, 10), (3, 40), (5, 7), (20, 30), (21, 1)])]
        return [(i.name, i.start, i.end) for i in m["ov"].bandwidth_aware_comm(tl)]
    r, t = both(run)
    assert r == t


def test_scheduler_respects_deps_in_the_port():
    g = t_ir.Graph("g")
    a = g.op("matmul", flops=1e9)
    b = g.op("matmul", deps=[a.name], flops=1e9)
    tl = t_sched.schedule(g, t_analytical.AnalyticalEngine(t_hw.H100_SXM))
    iv = {i.name: i for i in tl.intervals}
    assert iv[b.name].start >= iv[a.name].end


# ---------------- memory ----------------

@settings(max_examples=20, deadline=None)
@given(sizes=st.lists(st.floats(1, 1e6), min_size=1, max_size=20))
def test_liveness_peak_matches(sizes):
    def run(m):
        g = m["ir"].Graph("g")
        prev = None
        for s in sizes:
            prev = g.op("elementwise", deps=[prev.name] if prev else [], bytes_out=s)
        return m["mem"].graph_liveness_peak(g, record_timeline=True)
    r, t = both(run)
    assert r == t


@pytest.mark.parametrize("mode", ["train", "prefill", "decode"])
def test_simulate_memory_matches(mode):
    def run(m):
        fwd = block_graph(m, comm=False)
        joint = m["remat"].RecomputePass("block").apply(fwd.clone()) if mode == "train" else None
        rep = m["mem"].simulate_memory(fwd, n_layers=32, param_bytes=7.6e9, boundary_bytes=3.1e6,
                                       mode=mode, zero_stage=1, dp=4, tp=2,
                                       kv_cache_bytes=1e9 if mode == "decode" else 0.0,
                                       block_joint=joint)
        return dataclasses.asdict(rep)
    r, t = both(run)
    assert r == t


# ---------------- random forest / prediction ----------------

def test_random_forest_matches():
    rng = np.random.default_rng(0)
    X = rng.uniform(0, 10, (400, 3))
    y = X[:, 0] * 2 + np.sin(X[:, 1]) + 0.1 * X[:, 2]
    r, t = both(lambda m: m["pred"].RandomForest(n_trees=12, max_depth=8)
                .fit(X[:300], y[:300]).predict(X[300:]))
    assert np.array_equal(r, t)
    assert np.mean(np.abs(t - y[300:])) < 0.8


# ---------------- passes ----------------

@pytest.mark.parametrize("tp,sp", [(2, 1), (4, 1), (4, 4), (3, 1)])
def test_tensor_and_sequence_parallel_match(tp, sp):
    def run(m):
        ctx = m["base"].PassContext(parallel=m["base"].ParallelConfig(tp=tp, sp=sp))
        g = m["par"].TensorParallelPass().apply(block_graph(m), ctx)
        return graph_tuple(m["par"].SequenceParallelPass().apply(g, ctx))
    r, t = both(run)
    assert r == t


def test_tp_divides_and_inserts_collectives_in_the_port():
    g = block_graph(PORT)
    ctx = t_base.PassContext(parallel=t_base.ParallelConfig(tp=4))
    g2 = t_par.TensorParallelPass().apply(g, ctx)
    mm = lambda gg: gg.total("flops", pred=lambda n: n.kind == "matmul")  # noqa: E731
    assert mm(g2) == mm(g) / 4
    assert "all_reduce" in {n.kind for n in g2 if n.comm_group == "tp"}


@pytest.mark.parametrize("cp", [2, 4])
@pytest.mark.parametrize("decode", [False, True])
def test_context_parallel_matches(cp, decode):
    def run(m):
        g = m["ir"].Graph("cp")
        sq = 1 if decode else 512
        g.op("attention", out_shape=(8, sq, 8, 3, 128), flops=2e8, bytes_in=6.7e7, bytes_out=4.9e4,
             attrs={"attn_dims": (8, 24, sq, 2048, 128), "causal": not decode, "window": 0})
        ctx = m["base"].PassContext(parallel=m["base"].ParallelConfig())
        return graph_tuple(m["par"].ContextParallelPass(cp=cp).apply(g, ctx))
    r, t = both(run)
    assert r == t


def test_expert_parallel_matches():
    def run(m):
        g = m["ir"].Graph("moe")
        a = g.op("matmul", out_shape=(8, 64, 128), flops=1e9, bytes_in=1e6, bytes_out=1e6)
        b = g.op("matmul", deps=[a.name], out_shape=(8, 64, 128), flops=1e9,
                 bytes_in=1e6, bytes_out=1e6)
        g.op("elementwise", deps=[b.name], out_shape=(64, 128), flops=1e3,
             bytes_in=1e6, bytes_out=1e6)
        ctx = m["base"].PassContext(parallel=m["base"].ParallelConfig(tp=1, ep=4))
        return graph_tuple(m["par"].ExpertParallelPass(num_experts=8).apply(g, ctx))
    r, t = both(run)
    assert r == t
    assert sum(1 for n in t if n[1] == "all_to_all") == 2


def test_fusion_quantize_recompute_match():
    def run(m):
        g = m["ir"].Graph("f")
        a = g.op("norm", out_shape=(64, 256), flops=1e5, bytes_in=1e5, bytes_out=1e5)
        g.op("matmul", deps=[a.name], out_shape=(64, 512), flops=1e7,
             bytes_in=2e5, bytes_out=1e5, attrs={"mm_dims": (64, 512, 256)})
        fused = m["fusion"].FusionPass().apply(g.clone())
        blk = block_graph(m, comm=False)
        return (graph_tuple(fused),
                graph_tuple(m["quant"].QuantizePass("int8").apply(blk.clone())),
                graph_tuple(m["quant"].QuantizePass("f8", matmul_only=False).apply(blk.clone())),
                graph_tuple(m["remat"].RecomputePass("block").apply(blk.clone())),
                graph_tuple(m["remat"].RecomputePass("dots").apply(blk.clone())))
    r, t = both(run)
    assert r == t
    fused = t[0]
    assert len(fused) == 1 and fused[0][1] == "fused" and fused[0][5] == 1e5 + 1e7


def test_data_parallel_pass_and_optimizer_cost_match():
    def run(m):
        ctx = m["base"].PassContext(parallel=m["base"].ParallelConfig(dp=8, zero_stage=1))
        g = m["dp"].DataParallelPass(compression="int8").apply(block_graph(m, comm=False), ctx)
        costs = [m["dp"].optimizer_step_cost(3.8e9, optimizer=o, zero_stage=z, dp=8)
                 for o in ("adamw", "adafactor") for z in (0, 1, 3)]
        return graph_tuple(g), costs
    r, t = both(run)
    assert r == t


@pytest.mark.parametrize("name", ["none", "gpipe", "1f1b", "dualpipe", "interleaved"])
def test_pipeline_schedules_match(name):
    def run(m):
        out = []
        for p, mb in ((1, 1), (4, 16), (8, 3), (8, 32)):
            if name == "none" and p > 1:
                continue
            s = m["pipe"].make_schedule(name, p, mb, 1.0, 2.0, 0.05)
            out.append((s.total_time, s.bubble_fraction,
                        [(e.rank, e.microbatch, e.kind, e.start, e.end) for e in s.events]))
        return out
    r, t = both(run)
    assert r == t


def test_1f1b_bubble_formula_in_the_port():
    p, m, tf, tb = 4, 16, 1.0, 2.0
    s = t_pipe.schedule_1f1b(p, m, tf, tb, 0.0)
    assert s.total_time == pytest.approx(m * (tf + tb) + (p - 1) * (tf + tb), rel=1e-6)
    assert t_pipe.make_schedule("dualpipe", 8, 16, 1.0, 2.0, 0.05).total_time \
        < t_pipe.make_schedule("1f1b", 8, 16, 1.0, 2.0, 0.05).total_time


def test_analysis_pipeline_matches():
    def run(m):
        g = m["ir"].Graph("g")
        a = g.op("matmul", flops=1e9, bytes_in=1e6, bytes_out=1e6, phase="fwd")
        g.op("matmul", deps=[a.name], flops=1e9, bytes_in=1e6, bytes_out=1e6, phase="bwd")
        pipe = m["analysis"].AnalysisPipeline(post_passes=[m["remat"].RecomputePass("block")])
        res = pipe.run(g, m["base"].PassContext(parallel=m["base"].ParallelConfig()))
        res = dict(res, pre=dataclasses.asdict(res["pre"]), post=dataclasses.asdict(res["post"]),
                   graph=graph_tuple(res["graph"]))
        return res, m["analysis"].mfu(1e12, 1e6, 1, 197e12)
    r, t = both(run)
    assert r == t
    assert t[0]["recompute_overhead"] == pytest.approx(0.5)


def test_parallel_config_hashes_and_keys_match():
    for kw in ({}, {"tp": 4, "dp": 8, "sp": 4}, {"pp": 4, "microbatches": 8, "zero_stage": 3}):
        r, t = both(lambda m: m["base"].ParallelConfig(**kw))
        assert dataclasses.asdict(r) == dataclasses.asdict(t)
        assert r.key() == t.key() and r.shard_key() == t.shard_key() and r.chips == t.chips
        assert math.isfinite(t.chips)
