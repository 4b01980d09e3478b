"""``repro_torch``'s Simulator, spec API and profiling engine against the
reference's, on the CPU.

With the analytical engine on ``h100_sxm``, the four dense decoders in three
modes give the reference's report where the graphs agree (products,
attention, the transpose of the head: ``kind_us`` equal up to the order of
summation; the optimizer step: equal) and the step time within ``STEP_TOL`` elsewhere, measured on these
specs and explained in ``PERF.md`` (largest: gemma-7b prefill -12.3 %, its
GeGLU and the head's embedding lookup; phi4-mini-3.8b decode -11.0 %, the
lookup).  The memory total within ``MEMORY_TOL`` (measured at most 2.3 %)."""
import dataclasses
import json
import math
import warnings

import jax
import pytest
import torch

from repro.api import (
    Cluster as RCluster, DecodeWorkload as RDecode, PrefillWorkload as RPrefill,
    ServingWorkload as RServing, SimSpec as RSpec, TrainWorkload as RTrain,
)
from repro.api.spec import CheckpointSpec as RCkpt, FaultModel as RFault, ResilienceSpec as RRes
from repro.configs import get_config as r_config
from repro.core import ParallelConfig as RPar, Simulator as RSim
from repro.core.backend import profiling as r_prof
from repro.core.backend.hardware import HARDWARE as R_HW
from repro.core import model_ingest as r_ingest
from repro.core.ir import OpNode as ROp
from repro.models.params import param_logical_axes
from repro_torch.api import (
    CharonDeprecationWarning, Cluster, DecodeWorkload, PrefillWorkload, SimSpec, TrainWorkload,
)
from repro_torch.api.spec import CheckpointSpec, FaultModel, ResilienceSpec
from repro_torch.configs import ARCH_IDS, get_config as t_config
from repro_torch.core import ParallelConfig, Report, Simulator
from repro_torch.core import simulator as t_simulator
from repro_torch.core import model_ingest as t_ingest
from repro_torch.core.backend import profiling as t_prof
from repro_torch.core.backend.hardware import HARDWARE as T_HW
from repro_torch.core.ir import OpNode

STEP_TOL = 0.15
MEMORY_TOL = 0.03
# olmoe's train step (MoE block, joint graph): JAX transposes the dispatch's
# and the combine's ``.at[].set`` scatters by scattering and gathering an id
# array of the operand's shape to find each element's winning write, so the
# reference's joint graph prices (E, cap, D) and (T*K, D) id buffers that
# torch's index_put/index_add backward (one gather) never writes
# (tests/test_torch_ingest.py, ``REST_BYTES["moe_joint"]``).  The port's
# backward, step and memory are then below the reference's, never above:
# measured bwd -36.8 / -48.5 %, step -22.4 / -32.9 %, memory -8.2 / -8.0 % at
# ep 1 / ep 8.  The forward stays within ``STEP_TOL``.
MOE_TRAIN_TOL = {"bwd": 0.55, "step": 0.35, "memory": 0.10}
# xlstm-125m's mLSTM chunk leads with B*H in the port (one batch dim for
# every product) where the reference keeps (B, chunk, H): the reference
# transposes two of the chunk body's outputs back to its layout and its
# float32 inputs, the port one product's output and its bf16 inputs inside
# their cast (tests/test_torch_ingest.py).  Its transpose time is then below
# the reference's, never above: measured -22.8 % in prefill and -37.8 % in
# train, equal in decode (the sLSTM's transposes and the head's are the
# reference's).
LAYOUT_TRANSPOSE_TOL = {"xlstm-125m": 0.45}
# xlstm-125m's train memory: ``jax.nn.silu`` is a ``jit`` call, which the
# reference's tracer keeps as one node, and in the joint graph that node
# returns silu's residuals beside its output (151 MB for the mLSTM's conv
# branch and 75 MB for its z gate, live at the block's peak), which the
# port's ``silu`` does not save.  The port's activation peak is then below
# the reference's, never above: measured total -5.5 %.
SILU_TRAIN_MEMORY_TOL = {"xlstm-125m": 0.08}
# xlstm-125m's mLSTM chunk body: the products JAX emits for elementwise work,
# all-batch (N, 1, 1), are multiplies in the port (tests/test_torch_ingest.py,
# ``ALL_BATCH``), so its matmul time is the reference's less theirs.
ALL_BATCH_ARCHS = ("xlstm-125m",)
# whisper-large-v3's FFN is a plain GELU (its xattn and enc blocks): the
# reference prices lax's four elementwise passes over (B, S, d_ff) beside the
# up projection's bias add, where the port prices ATen's one gelu, the kernel
# it runs (tests/test_torch_ingest.py, ``PLAIN_GELU``).  With the encoder's 32
# blocks at 1500 frames in train and prefill, that is the gap (the port's
# elementwise time is about half the reference's there).  Its forward,
# backward and step are then below
# the reference's, never above: measured step -21.3 % in train and -23.0 % in
# prefill.  Decode (no encoder) is within ``STEP_TOL`` (-9.0 %).
PLAIN_GELU_TOL = {"whisper-large-v3": 0.30}


def _matmul_share_without_all_batch(arch, mode) -> float:
    """The reference's matmul time over its forward graphs at this mode's
    shape, without its all-batch products, over all of it."""
    from repro.core.backend.analytical import AnalyticalEngine as RAnalytical
    B, S = WORKLOADS[mode][2]["global_batch"], WORKLOADS[mode][2]["seq_len"]
    mg = r_ingest.block_graphs(r_config(arch), B, 1 if mode == "decode" else S, mode,
                               cache_len=S if mode == "decode" else 0)
    eng = RAnalytical(R_HW["h100_sxm"])
    us = [(eng.latency_us(n) * n.repeat * b.repeat, tuple(n.attrs["mm_dims"][1:]) == (1, 1))
          for b in mg.all_blocks() for n in b.fwd if n.kind == "matmul"]
    return sum(u for u, ab in us if not ab) / sum(u for u, _ in us)
WORKLOADS = {"train": (RTrain, TrainWorkload, dict(global_batch=8, seq_len=2048)),
             "prefill": (RPrefill, PrefillWorkload, dict(global_batch=1, seq_len=512)),
             "decode": (RDecode, DecodeWorkload, dict(global_batch=8, seq_len=2048))}

_SIMS = {}


def sims():
    if not _SIMS:
        _SIMS.update(ref=RSim("h100_sxm"), port=Simulator("h100_sxm"))
    return _SIMS["ref"], _SIMS["port"]


def spec_pair(arch, mode, *, chips=1, par=None, **kw):
    rw, tw, base = WORKLOADS[mode]
    base = dict(base, **kw)
    par = par or {}
    return (RSpec(r_config(arch), cluster=RCluster("h100_sxm", chips=chips),
                  parallel=RPar(**par), workload=rw(**base)),
            SimSpec(t_config(arch), cluster=Cluster("h100_sxm", chips=chips),
                    parallel=ParallelConfig(**par), workload=tw(**base)))


def _below_by_at_most(got, want, tol):
    assert want * (1 - tol) <= got <= want * (1 + 1e-12), (got, want)


def check_report(arch, mode, r, t):
    assert isinstance(t, Report) and t.mode == mode
    assert (t.chips, t.tokens_per_step, t.model_flops) == (r.chips, r.tokens_per_step,
                                                           r.model_flops)
    moe_train = t_config(arch).is_moe and mode == "train"
    gelu = PLAIN_GELU_TOL.get(arch) if mode in ("train", "prefill") else None
    if moe_train:
        _below_by_at_most(t.step_time_us, r.step_time_us, MOE_TRAIN_TOL["step"])
    elif gelu is not None:
        _below_by_at_most(t.step_time_us, r.step_time_us, gelu)
    else:
        assert t.step_time_us == pytest.approx(r.step_time_us, rel=STEP_TOL)
    assert t.mfu * t.step_time_us == pytest.approx(r.mfu * r.step_time_us, rel=1e-12)
    assert set(t.breakdown_us) == set(r.breakdown_us)
    for k, v in r.breakdown_us.items():
        if moe_train and k == "bwd":
            _below_by_at_most(t.breakdown_us[k], v, MOE_TRAIN_TOL["bwd"])
        elif gelu is not None and k in ("fwd", "bwd"):
            _below_by_at_most(t.breakdown_us[k], v, gelu)
        else:
            # a zero entry (pp_bubble at pp 1) is a difference of sums of the
            # step's size: rounding leaves up to an ulp of it either way
            tol0 = max(1e-9, 2 * math.ulp(r.step_time_us))
            assert t.breakdown_us[k] == pytest.approx(v, rel=STEP_TOL, abs=tol0), k
    if mode == "train":
        assert t.breakdown_us["optimizer"] == r.breakdown_us["optimizer"]
    for kind in ("matmul", "attention", "transpose", "all_to_all"):
        if kind == "transpose" and arch in LAYOUT_TRANSPOSE_TOL:
            _below_by_at_most(t.kind_us[kind], r.kind_us[kind], LAYOUT_TRANSPOSE_TOL[arch])
            continue
        if kind == "matmul" and arch in ALL_BATCH_ARCHS:
            assert t.kind_us[kind] == pytest.approx(
                r.kind_us[kind] * _matmul_share_without_all_batch(arch, mode), rel=1e-12)
            continue
        # the same prices summed in another node order
        assert t.kind_us.get(kind, 0.0) == pytest.approx(r.kind_us.get(kind, 0.0),
                                                         rel=1e-12), kind
    if moe_train:
        _below_by_at_most(t.memory.total, r.memory.total, MOE_TRAIN_TOL["memory"])
    elif mode == "train" and arch in SILU_TRAIN_MEMORY_TOL:
        _below_by_at_most(t.memory.total, r.memory.total, SILU_TRAIN_MEMORY_TOL[arch])
    else:
        assert t.memory.total == pytest.approx(r.memory.total, rel=MEMORY_TOL)
    for k in ("weights", "grads", "opt_state", "kv_cache"):
        assert getattr(t.memory, k) == getattr(r.memory, k), k


@pytest.mark.parametrize("mode", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_report_matches_the_reference(arch, mode):
    rs, ts = spec_pair(arch, mode)
    assert rs.json_hash() == ts.json_hash()
    r_sim, t_sim = sims()
    check_report(arch, mode, r_sim.run(rs), t_sim.run(ts))


@pytest.mark.parametrize("mode", ["train", "prefill", "decode"])
def test_moe_report_at_ep_8_matches_the_reference(mode):
    """olmoe on 8 chips at ep 8: the expert-parallel pass shards the expert
    products and inserts its all_to_all pair in both packages alike."""
    rs, ts = spec_pair("olmoe-1b-7b", mode, chips=8, par={"ep": 8})
    assert rs.json_hash() == ts.json_hash()
    r_sim, t_sim = sims()
    r, t = r_sim.run(rs), t_sim.run(ts)
    check_report("olmoe-1b-7b", mode, r, t)
    assert t.kind_us["all_to_all"] > 0
    one = t_sim.run(spec_pair("olmoe-1b-7b", mode, chips=8)[1])
    assert "all_to_all" not in one.kind_us
    assert t.kind_us["matmul"] < one.kind_us["matmul"]


def test_optimizer_leaves_are_counted_as_the_reference_stacks_them():
    for arch in ARCH_IDS:
        want = len(jax.tree.leaves(param_logical_axes(r_config(arch)),
                                   is_leaf=lambda x: isinstance(x, tuple)))
        assert t_simulator._param_leaves(t_config(arch)) == want


def test_simulator_sane_mfu_and_scaling():
    sim = Simulator("h100_sxm", engine="analytical")
    cfg = t_config("gemma-7b")
    par = ParallelConfig(tp=16, dp=16, sp=16, zero_stage=1)
    spec = SimSpec(cfg, parallel=par, workload=TrainWorkload(global_batch=256, seq_len=4096))
    r = sim.run(spec)
    assert 0.02 < r.mfu < 1.0
    assert r.memory.total > 0
    r2 = sim.run(dataclasses.replace(spec, workload=TrainWorkload(global_batch=512, seq_len=4096)))
    assert r2.tokens_per_s >= r.tokens_per_s * 0.95
    ref = RSim("h100_sxm").run(RSpec(r_config("gemma-7b"), cluster=RCluster("h100_sxm"),
                                     parallel=RPar(tp=16, dp=16, sp=16, zero_stage=1),
                                     workload=RTrain(global_batch=256, seq_len=4096)))
    assert r.step_time_us == pytest.approx(ref.step_time_us, rel=STEP_TOL)


def test_simulator_decode_batch_throughput_monotone():
    sim = Simulator("h100_sxm", engine="analytical")
    cfg = t_config("gemma-7b")
    par = ParallelConfig(tp=16, dp=16)
    spec = SimSpec(cfg, parallel=par, workload=DecodeWorkload(global_batch=16, seq_len=8192))
    t8 = sim.run(spec)
    t64 = sim.run(dataclasses.replace(spec, workload=DecodeWorkload(global_batch=64,
                                                                    seq_len=8192)))
    assert t64.tps_per_chip > t8.tps_per_chip  # weights amortise over batch


def _report_tuple(rep):
    return (rep.step_time_us, rep.mfu, rep.breakdown_us, rep.kind_us,
            dataclasses.asdict(rep.memory), rep.tokens_per_s)


@pytest.mark.parametrize("mode", ["train", "decode"])
def test_cache_on_and_off_give_identical_reports(mode):
    _, spec = spec_pair("phi4-mini-3.8b", mode, par={"tp": 2, "dp": 2}, chips=4)
    a = Simulator("h100_sxm", cache=True)
    b = Simulator("h100_sxm", cache=False)
    first = _report_tuple(a.run(spec))
    assert _report_tuple(a.run(spec)) == first           # warm cache
    assert _report_tuple(b.run(spec)) == first
    assert _report_tuple(a.run(spec, keep_timelines=True)) == first


def test_simulate_shim_warns_and_matches_run():
    cfg = t_config("phi4-mini-3.8b")
    sim = Simulator()
    assert sim.hw.name == "h100_sxm"
    with pytest.warns(CharonDeprecationWarning):
        old = sim.simulate(cfg, mode="prefill", global_batch=1, seq_len=256)
    new = sim.run(SimSpec(cfg, workload=PrefillWorkload(global_batch=1, seq_len=256)))
    assert _report_tuple(old) == _report_tuple(new)


def test_persistent_tier_stamps_torch_and_reloads(tmp_path):
    _, spec = spec_pair("phi4-mini-3.8b", "decode")
    a = Simulator("h100_sxm", persist=str(tmp_path))
    rep = a.run(spec)
    path = a.save_cache()
    assert path is not None
    meta = a._persist_meta()
    assert meta["torch"] == torch.__version__ and "repro_torch" in meta and "jax" not in meta
    b = Simulator("h100_sxm", persist=str(tmp_path))
    assert _report_tuple(b.run(spec)) == _report_tuple(rep)


def test_surfaces_of_later_slices_raise():
    """Observability and the sanitizing cache are ported: explain, the
    metrics registry and the recorder work, and a sanitized run equals the
    plain one; a spec for other hardware than the simulator's still raises."""
    sim = Simulator("h100_sxm")
    _, spec = spec_pair("phi4-mini-3.8b", "prefill", seq_len=64)
    rep = sim.run(spec)
    assert "step report" in rep.explain() and rep.explain_dict()["mode"] == "prefill"
    assert sim.metrics_registry().snapshot()["counters"]
    from repro_torch.obs import TraceRecorder
    rec = TraceRecorder()
    assert sim.run(spec, recorder=rec).step_time_us == rep.step_time_us and len(rec) > 0
    assert _report_tuple(Simulator("h100_sxm", sanitize=True).run(spec)) == _report_tuple(rep)
    with pytest.raises(ValueError):
        Simulator("tpu_v5e").run(spec)


# ---------------- spec ----------------

def _spec_pairs():
    res = dict(total_steps=50, faults=dict(chip_mtbf_s=3600.0, seed=3),
               ckpt=dict(interval_steps=10, mode="async"))
    out = []
    for arch in ("phi4-mini-3.8b", "yi-34b"):
        for mode in ("train", "prefill", "decode"):
            out.append(spec_pair(arch, mode))
        out.append(spec_pair(arch, "train", chips=64,
                             par=dict(tp=4, pp=2, dp=8, microbatches=4, zero_stage=3),
                             fusion=True, quantize="int8", remat="dots", optimizer="adafactor"))
        out.append(spec_pair(arch, "decode", cache_len=4096))
    rt = RSpec(r_config("gemma-7b"), cluster=RCluster("a100_80g", chips=8, pods=2),
               workload=RTrain(resilience=RRes(
                   total_steps=50, faults=RFault(**res["faults"]), ckpt=RCkpt(**res["ckpt"]))))
    tt = SimSpec(t_config("gemma-7b"), cluster=Cluster("a100_80g", chips=8, pods=2),
                 workload=TrainWorkload(resilience=ResilienceSpec(
                     total_steps=50, faults=FaultModel(**res["faults"]),
                     ckpt=CheckpointSpec(**res["ckpt"]))))
    out.append((rt, tt))
    return out


def test_equal_specs_hash_equal_in_both_packages():
    pairs = _spec_pairs()
    for rs, ts in pairs:
        assert ts.to_json() == rs.to_json()
        assert ts.json_hash() == rs.json_hash()
    assert len({ts.json_hash() for _, ts in pairs}) == len(pairs)


def test_from_json_round_trips_across_packages():
    for rs, ts in _spec_pairs():
        back = SimSpec.from_json(rs.to_json())
        assert back == ts and back.json_hash() == rs.json_hash() and hash(back) == hash(ts)
        there = RSpec.from_json(ts.to_json())
        assert there == rs and there.json_hash() == ts.json_hash()


def test_serving_spec_raises_naming_its_item():
    """A serving spec now loads (queue A item 7 is ported); ``Simulator.run``
    refuses it with the reference's TypeError, which names the simulator
    that runs it."""
    rs = RSpec(r_config("phi4-mini-3.8b"), cluster=RCluster("h100_sxm"),
               workload=RServing(n_requests=4))
    ts = SimSpec.from_json(rs.to_json())
    assert ts.json_hash() == rs.json_hash()
    with pytest.raises(TypeError, match=r"ServingSimulator\(sim\)\.run\(spec\)"):
        Simulator("h100_sxm").run(ts)
    with pytest.raises(TypeError, match=r"ServingSimulator\(sim\)\.run\(spec\)"):
        RSim("h100_sxm").run(rs)


def test_cluster_defaults_to_h100():
    assert Cluster().hardware == "h100_sxm"
    assert SimSpec(t_config("gemma-7b")).cluster.resolve().name == "h100_sxm"
    with pytest.raises(KeyError):
        Cluster("no_such_chip")


# ---------------- profiling ----------------

def _nodes(op):
    return [op("m", "matmul", dtype="bf16", flops=2.0 * 8 * 3072 * 3072,
               attrs={"mm_dims": (8, 3072, 3072)}),
            op("e", "elementwise", dtype="f32", out_shape=(8, 1, 3072), flops=24576.0),
            op("c", "copy", dtype="bf16", out_shape=(8, 3072)),
            op("a", "attention", dtype="bf16", flops=2e8,
               attrs={"attn_dims": (8, 24, 1, 2048, 128), "causal": False, "window": 0})]


def test_profile_db_gives_the_same_latencies_through_both_engines(tmp_path):
    r_db, t_db = r_prof.ProfileDB(tmp_path / "r.json"), t_prof.ProfileDB(tmp_path / "t.json")
    r_nodes, t_nodes = _nodes(ROp), _nodes(OpNode)
    t_nodes[3].attrs["G"] = 3
    for i, (rn, tn) in enumerate(zip(r_nodes, t_nodes)):
        rk, tk = r_prof.node_key(rn, "h100_sxm"), t_prof.node_key(tn, "h100_sxm")
        assert tk == (rk + "|G3" if rn.kind == "attention" else rk)
        r_db.put(rk, 10.0 + i, {"kind": rn.kind})
        t_db.put(tk, 10.0 + i, {"kind": tn.kind})
    r_eng = r_prof.ProfilingEngine(R_HW["h100_sxm"], r_db)
    t_eng = t_prof.ProfilingEngine(T_HW["h100_sxm"], t_db)
    assert [r_eng.latency_us(n) for n in r_nodes] == [t_eng.latency_us(n) for n in t_nodes] \
        == [10.0, 11.0, 12.0, 13.0]
    t_db.save()
    assert json.loads((tmp_path / "t.json").read_text()) == t_db.data
    other_g = OpNode("a", "attention", dtype="bf16",
                     attrs={"attn_dims": (8, 24, 1, 2048, 128), "G": 1})
    assert t_eng.latency_us(other_g) is None        # another group: another key


def test_profiling_simulator_prices_from_the_db_and_falls_back(tmp_path):
    _, spec = spec_pair("phi4-mini-3.8b", "decode")
    db = t_prof.ProfileDB(tmp_path / "db.json")
    ana = Simulator("h100_sxm").run(spec)
    empty = Simulator("h100_sxm", engine="profiling", db=db).run(spec)
    assert _report_tuple(empty) == _report_tuple(ana)    # every miss falls back
    mg = t_ingest.ingest_graphs(t_config("phi4-mini-3.8b"), 8, 1, "decode", cache_len=2048)
    for n in mg.blocks[0].fwd:
        if n.kind == "attention":
            db.put(t_prof.node_key(n, "h100_sxm"), 1000.0, {})
    full = Simulator("h100_sxm", engine="profiling", db=db).run(spec)
    assert full.kind_us["attention"] == pytest.approx(1000.0 * 32)


def test_measure_on_miss_is_for_the_card_it_measures_on():
    """Another target's engine reads its DB only, as the reference's engine
    measures only for ``xla_cpu``; without CUDA ``h100_sxm`` raises
    (``test_torch_imports.py``)."""
    assert t_prof.MEASURE_HW == "h100_sxm"
    assert not t_prof.ProfilingEngine(T_HW["tpu_v5e"], measure_on_miss=True).measure_on_miss


SYNTH = [
    OpNode("m", "matmul", dtype="bf16", attrs={"mm_dims": (16, 32, 64)}),
    OpNode("m", "matmul", dtype="f32", attrs={"mm_dims": (8, 16, 32)}),
    OpNode("a", "attention", dtype="bf16",
           attrs={"attn_dims": (1, 6, 16, 16, 64), "G": 3, "causal": True, "window": 0}),
    OpNode("a", "attention", dtype="bf16",
           attrs={"attn_dims": (2, 6, 1, 32, 64), "G": 3, "causal": False, "window": 0}),
    OpNode("n", "norm", dtype="bf16", out_shape=(4, 64)),
    OpNode("e", "elementwise", dtype="f32", out_shape=(4, 64)),
    OpNode("r", "reduce", dtype="f32", out_shape=(4,)),
    OpNode("c", "copy", dtype="bf16", out_shape=(4, 8, 2)),
    OpNode("t", "transpose", dtype="bf16", out_shape=(16, 8)),
    OpNode("s", "softmax", dtype="f32", out_shape=(4, 8)),
    OpNode("g", "gather", dtype="bf16", out_shape=(1, 4, 8)),
]


@pytest.mark.parametrize("node", SYNTH, ids=lambda n: f"{n.kind}-{n.dtype}")
def test_synthesize_and_measure_runs_each_kind_on_the_cpu(node):
    from repro_torch import kernels as K
    K.reset_launch_counts()
    us = t_prof.synthesize_and_measure(node, device="cpu")
    assert us is not None and us > 0
    assert K.launch_counts() == {"rmsnorm": 0, "flash_attention": 0, "decode_attention": 0,
                                "rmsnorm_bwd": 0, "flash_attention_bwd": 0, "adamw": 0,
                                "adafactor": 0}


def test_synthesize_gives_none_only_for_what_it_cannot_build():
    cannot = [OpNode("x", "scatter", out_shape=(4, 8)),
              OpNode("m", "matmul", dtype="int8", attrs={"mm_dims": (8, 8, 8)}),
              OpNode("m", "matmul", dtype="bf16"),
              OpNode("a", "attention", dtype="bf16",
                     attrs={"attn_dims": (1, 6, 16, 16, 96), "G": 3}),      # no kernel at D=96
              OpNode("a", "attention", dtype="bf16",
                     attrs={"attn_dims": (1, 6, 1, 16, 64), "G": 4})]       # K2 has no G=4
    for n in cannot:
        assert t_prof.synthesize_and_measure(n, device="cpu") is None
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert t_prof.dispatch_overhead_us("cpu") > 0


if __name__ == "__main__":
    # The gaps PERF.md records: PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_simulator.py
    r_sim, t_sim = sims()
    for arch in ARCH_IDS:
        for mode in WORKLOADS:
            rs, ts = spec_pair(arch, mode)
            r, t = r_sim.run(rs), t_sim.run(ts)
            blocks = {k: f"{v:.2f}/{t.detail['t_fwd'][k]:.2f}" for k, v in r.detail["t_fwd"].items()}
            print(f"{arch:15s} {mode:7s} step {r.step_time_us:.1f} -> {t.step_time_us:.1f} us "
                  f"({t.step_time_us / r.step_time_us - 1:+.2%}), memory "
                  f"{t.memory.total / r.memory.total - 1:+.2%}, t_fwd ref/port {blocks}")
