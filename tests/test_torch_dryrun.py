"""The port's dry run (``launch/dryrun.py``), its graph analysis
(``launch/hlo_analysis.py``), roofline (``launch/roofline.py``) and
perf-iteration runner (``launch/perf_iter.py``) against the reference's.

Tiny cells are traced over DTensors on a fake world of 4 ranks at a (2, 2)
mesh over ``(data, model)``; the reference lowers the same cells on 4 host
devices in a subprocess (its ``lower_cell`` takes the production meshes
only, so the subprocess uses its own pieces: ``ShardingEnv``, the spec
trees, ``to_named``, ``jax.jit(...).lower(...).compile()`` and
``analyze_module``).  Measured gap on those cells: none, the per-device dot
FLOPs are equal (prefill and decode, and train with and without remat),
so the tolerance is a relative 1e-9.  They were equal only once the port
gave the residual stream's sums their placements before each norm
(DTensor otherwise keeps a row-parallel product's partial sums unreduced
and gathers the next weight) and rotated q and k each on its own under
DTensor (a concatenation along the sharded heads gathers them).
"""
from __future__ import annotations

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch
import torch.distributed as dist

from repro_torch.configs import get_tiny_config
from repro_torch.configs.base import SHAPES, RunConfig, ShapeConfig
from repro_torch.core.backend.hardware import HARDWARE
from repro_torch.launch import dryrun, perf_iter, roofline
from repro_torch.launch.hlo_analysis import analyze_module
from repro_torch.launch.mesh import fake_world, make_mesh
from repro_torch.models import layers as L

REPO = Path(__file__).resolve().parents[1]


def _trace(fn, *args):
    from torch.fx.experimental.proxy_tensor import make_fx
    with dryrun._traced_loops():
        return make_fx(fn, tracing_mode="fake")(*args)


def test_analysis_trip_counts():
    """Twin of the reference's ``test_hlo_analysis_trip_counts``: a
    ``layers.scan`` of 7 steps of ``tanh(c @ w)`` is one loop of trip count
    7, its product counted 7 times."""
    def f(x, w):
        def body(c, _):
            return torch.tanh(c @ w), None
        return L.scan(body, x, None, length=7)[0]

    gm = _trace(f, torch.zeros(64, 64), torch.zeros(64, 64))
    st = analyze_module(gm)
    assert st["flops"] == 7 * 2 * 64 ** 3
    assert [w["trip_count"] for w in st["while_loops"]] == [7]


def test_nested_loops_multiply():
    def f(x, w):
        def inner(c, _):
            return c @ w, None

        def outer(c, _):
            return L.scan(inner, c, None, length=3)[0], None
        return L.scan(outer, x, None, length=5)[0]

    st = analyze_module(_trace(f, torch.zeros(8, 8), torch.zeros(8, 8)))
    assert st["flops"] == 15 * 2 * 8 ** 3
    assert sorted(w["trip_count"] for w in st["while_loops"]) == [3, 5]


def test_traced_loops_are_scoped():
    """Outside ``_traced_loops`` (and in another thread inside it) a
    ``layers.scan`` traces as its loop, 7 products and no marks; inside,
    one product between the marks.  Nothing of torch or of ``layers`` is
    left swapped after it."""
    import threading
    from torch.distributed.tensor import placement_types
    from torch.fx.experimental.proxy_tensor import make_fx

    def f(x, w):
        return L.scan(lambda c, _: (c @ w, None), x, None, length=7)[0]

    def mms(gm):
        return sum(1 for n in gm.graph.nodes if n.op == "call_function"
                   and getattr(n.target, "__name__", "").startswith("mm"))

    args = (torch.zeros(8, 8), torch.zeros(8, 8))
    scan, a2a = L.scan, placement_types.shard_dim_alltoall
    assert mms(make_fx(f, tracing_mode="fake")(*args)) == 7
    assert mms(_trace(f, *args)) == 1
    other = []
    with dryrun._traced_loops():
        th = threading.Thread(target=lambda: other.append(make_fx(f, tracing_mode="fake")(*args)))
        th.start()
        th.join()
    assert mms(other[0]) == 7
    assert L.scan is scan and placement_types.shard_dim_alltoall is a2a
    assert mms(make_fx(f, tracing_mode="fake")(*args)) == 7


def test_hbm_bytes_count_casts_and_skip_views():
    """A materialising node reads its operands and writes its output once;
    views cost nothing; a cast (``_to_copy``) is counted."""
    def f(x):
        v = x.view(32, 8).t()             # views
        y = x.t().reshape(-1)             # a copy: the transposed view flattened
        return (x * 2.0).to(torch.bfloat16), v, y
    gm = _trace(f, torch.zeros(8, 32))
    st = analyze_module(gm)
    n = 8 * 32
    # mul: 4n read + 4n written; cast: 4n read + 2n written; the flattened
    # transpose: a clone (4n + 4n)
    assert st["hbm_bytes"] == 8 * n + 6 * n + 8 * n


def test_row_write_prices_the_rows():
    """An in-place row write prices the rows and their indices, not the
    buffer (the reference's dynamic-update-slice)."""
    def f(buf, rows, idx):
        buf[idx] = rows
        return buf
    gm = _trace(f, torch.zeros(1000, 16), torch.zeros(4, 16), torch.zeros(4, dtype=torch.long))
    st = analyze_module(gm)
    assert st["hbm_bytes"] == 4 * 8 + 3 * 4 * 16 * 4


def _graph(kind: str, n: int, shape=(1024,)):
    """A hand-built graph of one collective over a group named ``g``."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    g = torch.fx.Graph()
    with FakeTensorMode():
        x = torch.empty(shape)
        out = {"all_gather_into_tensor": torch.empty((shape[0] * n,)),
               "reduce_scatter_tensor": torch.empty((shape[0] // n,))}.get(kind, torch.empty(shape))
    p = g.placeholder("x")
    p.meta["val"] = x
    op = getattr(torch.ops._c10d_functional, kind).default
    args = {"all_gather_into_tensor": (p, n, "g"), "reduce_scatter_tensor": (p, "sum", n, "g"),
            "all_reduce": (p, "sum", "g"), "all_to_all_single": (p, None, None, "g")}[kind]
    c = g.call_function(op, args)
    c.meta["val"] = out
    g.output(c)
    return torch.fx.GraphModule(torch.nn.Module(), g)


@pytest.mark.parametrize("n", [2, 4, 16])
@pytest.mark.parametrize("kind,traffic", [
    ("all_gather_into_tensor", lambda n, b: (n - 1) * b),
    ("reduce_scatter_tensor", lambda n, b: (n - 1) / n * b),
    ("all_reduce", lambda n, b: 2 * (n - 1) / n * b),
    ("all_to_all_single", lambda n, b: (n - 1) / n * b),
])
def test_collective_traffic_follows_the_ring_formulas(kind, traffic, n):
    b = 1024 * 4
    st = analyze_module(_graph(kind, n), group_sizes={"g": n})
    coll = st["collectives"]
    assert coll["count"] == 1
    assert coll["traffic_bytes"] == traffic(n, b)
    (k, d), = coll["by_kind"].items()
    assert k == {"all_gather_into_tensor": "all-gather", "reduce_scatter_tensor": "reduce-scatter",
                 "all_reduce": "all-reduce", "all_to_all_single": "all-to-all"}[kind]
    assert d["operand_bytes"] == b


TINY = {"dense": "phi4-mini-3.8b", "moe": "olmoe-1b-7b"}
SHAPE = ShapeConfig("tiny_train", 64, 8, "train")

REF_LOWER = r"""
import os, sys, json
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, jax.numpy as jnp
from repro.configs import get_tiny_config
from repro.configs.base import ShapeConfig, RunConfig
from repro.distributed.sharding import ShardingEnv, activate
from repro.launch.hlo_analysis import analyze_module
from repro.launch.specs import input_specs
from repro.models import abstract_params
from repro.training.optimizer import make_optimizer
from repro.training.train_step import batch_pspecs, make_train_step, state_pspecs, to_named
out = {}
for arch in sys.argv[1:]:
    cfg = get_tiny_config(arch)
    shape = ShapeConfig("tiny_train", 64, 8, "train")
    run = RunConfig(model=cfg, shape=shape, pod=1, data=2, model_axis=2, optimizer="adamw",
                    zero_stage=1, remat_policy="block")
    mesh = jax.make_mesh((2, 2), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    env = ShardingEnv(mesh)
    with activate(env), mesh:
        params_abs = abstract_params(cfg)
        b_ns = to_named(env, batch_pspecs(cfg, env, 8, kind="train"))
        opt = make_optimizer("adamw")
        step = make_train_step(cfg, run, opt)
        state_abs = {"params": params_abs, "opt": jax.eval_shape(opt.init, params_abs),
                     "step": jax.ShapeDtypeStruct((), jnp.int32)}
        s_ns = to_named(env, state_pspecs(cfg, env, run))
        low = jax.jit(step, in_shardings=(s_ns, b_ns), out_shardings=(s_ns, None)).lower(
            state_abs, input_specs(cfg, shape))
        st = analyze_module(low.compile().as_text())
    out[arch] = {"flops": st["flops"], "by_kind": st["collectives"]["by_kind"]}
print("RECORDS", json.dumps(out))
"""


def _reference_records():
    r = subprocess.run([sys.executable, "-c", REF_LOWER, *TINY.values()], capture_output=True,
                       text=True, cwd=str(REPO), timeout=600,
                       env={"PYTHONPATH": str(REPO / "src"), "JAX_PLATFORMS": "cpu",
                            "PATH": os.environ.get("PATH", "/usr/bin:/bin")})
    line = next((ln for ln in r.stdout.splitlines() if ln.startswith("RECORDS ")), None)
    assert line, r.stdout[-2000:] + r.stderr[-4000:]
    return json.loads(line[8:])


@pytest.fixture(scope="module")
def reference_records():
    return _reference_records()


def _tiny_records():
    out = {}
    with fake_world(4):
        mesh = make_mesh((2, 2), ("data", "model"))
        for name, arch in TINY.items():
            cfg = get_tiny_config(arch)
            run = RunConfig(model=cfg, shape=SHAPE, pod=1, data=2, model_axis=2,
                            optimizer="adamw", zero_stage=1, remat_policy="block")
            out[name], _ = dryrun.cell_record(cfg, arch, SHAPE, mesh, run=run)
    assert not dist.is_initialized()
    return out


@pytest.fixture(scope="module")
def tiny_records():
    return _tiny_records()


REFERENCE_KEYS = {"arch", "shape", "mesh", "status", "n_devices", "kind", "params",
                  "active_params", "xla_flops", "xla_bytes_accessed", "flops_per_device",
                  "hbm_bytes_per_device", "while_loops", "memory_analysis", "collectives",
                  "zero_stage", "optimizer", "remat", "lower_s", "compile_s", "hlo_bytes"}


@pytest.mark.parametrize("name", list(TINY))
def test_tiny_cell_record_has_the_references_keys(tiny_records, name):
    rec = tiny_records[name]
    assert REFERENCE_KEYS <= set(rec)
    assert rec["status"] == "ok" and rec["n_devices"] == 4 and rec["mesh"] == "2x2"
    assert rec["flops_per_device"] > 0 and rec["hbm_bytes_per_device"] > 0
    assert rec["collectives"]["traffic_bytes"] > 0
    assert rec["memory_analysis"]["temp_bytes"] > 0
    assert rec["memory_analysis"]["argument_bytes"] > 0
    assert set(rec["collectives"]) >= {"count", "by_kind", "traffic_bytes"}
    assert rec["xla_flops"] is None and rec["compile_s"] is None
    json.dumps(rec)


@pytest.mark.parametrize("name", list(TINY))
def test_tiny_cell_flops_equal_the_references(tiny_records, reference_records, name):
    got = tiny_records[name]["flops_per_device"]
    want = reference_records[TINY[name]]["flops"]
    assert got == pytest.approx(want, rel=1e-9)


def test_moe_cell_has_the_expert_all_to_alls(tiny_records):
    """The MoE cell's train step moves its capacity rows: two all-to-alls a
    layer forward, two in the recomputed forward, two backward."""
    cfg = get_tiny_config(TINY["moe"])
    assert tiny_records["moe"]["collectives"]["by_kind"]["all-to-all"]["count"] >= \
        6 * cfg.num_layers


def test_cell_terms_by_hand():
    h = HARDWARE["h100_sxm"]
    assert (roofline.PEAK_FLOPS, roofline.HBM_BW, roofline.LINK_BW) == \
        (h.peak_flops["bf16"], h.hbm_bw, h.intra.bandwidth) == (989e12, 3.35e12, 450e9)
    rec = {"status": "ok", "arch": "gemma-7b", "shape": "train_4k", "n_devices": 256,
           "active_params": 8_000_000_000, "flops_per_device": 5e14,
           "hbm_bytes_per_device": 2e12, "collectives": {"traffic_bytes": 1e11},
           "memory_analysis": {"argument_bytes": 3e9, "temp_bytes": 4e9}}
    t = roofline.cell_terms(rec)
    tokens = 256 * 4096
    model_flops = 6 * 8e9 * tokens
    assert t["compute_s"] == pytest.approx(5e14 / 989e12)
    assert t["memory_s"] == pytest.approx(2e12 / 3.35e12)
    assert t["collective_s"] == pytest.approx(1e11 / 450e9)
    assert t["dominant"] == "memory"
    assert t["model_flops"] == model_flops
    assert t["hlo_to_model_flops"] == pytest.approx(5e14 * 256 / model_flops)
    assert t["roofline_fraction"] == pytest.approx(model_flops / 256 / 989e12 / (2e12 / 3.35e12))
    assert (t["mem_args_gb"], t["mem_temp_gb"]) == (3.0, 4.0)
    dec = dict(rec, shape="decode_32k")
    assert roofline.cell_terms(dec)["model_flops"] == 2 * 8e9 * SHAPES["decode_32k"].global_batch
    assert roofline.cell_terms({"status": "skipped"}) is None
    assert "| gemma-7b | train_4k |" in roofline.to_markdown([t])


def test_experiments_are_the_references():
    src = (REPO / "src" / "repro" / "launch" / "perf_iter.py").read_text()
    node = next(n for n in ast.parse(src).body if isinstance(n, ast.Assign)
                and any(getattr(t, "id", None) == "EXPERIMENTS" for t in n.targets))
    assert perf_iter.EXPERIMENTS == ast.literal_eval(node.value)


def _prefill_record(cfg, S=2048, B=2):
    shape = ShapeConfig("tiny_prefill", S, B, "prefill")
    with fake_world(4):
        rec, gm = dryrun.cell_record(cfg, cfg.name, shape, make_mesh((2, 2), ("data", "model")))
    return rec, gm


def _dots(gm):
    from repro_torch.launch.hlo_analysis import _val, op_name
    return [(op_name(n), _val(n.args[0]).dtype, tuple(_val(n.args[1]).shape))
            for n in gm.graph.nodes if op_name(n) in ("mm", "bmm")]


def test_overrides_change_the_trace():
    """``perf_iter``'s model overrides are read: ``attn_kv_block`` sets the
    kv loop's length, ``attn_score_dtype`` the PV product's operand type,
    ``lru_gate_blocks`` the RG-LRU's gate shapes."""
    base = get_tiny_config("phi4-mini-3.8b")
    rec, gm = _prefill_record(base)
    # T 2048 > 1024: blockwise; one q block (heads divide the model axis), causal
    assert [w["trip_count"] for w in rec["while_loops"]] == [2048 // 512] * base.num_layers
    rec2, _ = _prefill_record(base.replace(attn_kv_block=1024))
    assert [w["trip_count"] for w in rec2["while_loops"]] == [2] * base.num_layers
    # the PV product: (.., t, d) with t the kv block
    pv = (512, base.head_dim)
    assert {d for op, d, s in _dots(gm) if op == "bmm" and s[-2:] == pv} == {torch.float32}
    _, gm3 = _prefill_record(base.replace(attn_score_dtype="bfloat16"))
    assert {d for op, d, s in _dots(gm3) if op == "bmm" and s[-2:] == pv} == {torch.bfloat16}
    rg = get_tiny_config("recurrentgemma-9b")
    W = rg.lru_width or rg.d_model
    _, g1 = _prefill_record(rg, S=32)
    _, g4 = _prefill_record(rg.replace(lru_gate_blocks=4), S=32)
    assert not any(s[-2:] == (W // 8, W // 4) for _, _, s in _dots(g1))
    assert any(op == "bmm" and s[-1] == W // 4 for op, _, s in _dots(g4))


def test_fake_world_leaves_no_process_group():
    with fake_world(8):
        assert dist.get_world_size() == 8
        with pytest.raises(RuntimeError):
            with fake_world(4):
                pass
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError):
        make_mesh((2, 2), ("data", "model"))


if __name__ == "__main__":
    # the tiny cells' collectives beside the reference's (ROADMAP queue C):
    # PYTHONPATH=src python tests/test_torch_dryrun.py
    ref, port = _reference_records(), _tiny_records()
    for name, arch in TINY.items():
        print(f"{arch} train B8 S64, (2, 2) mesh: flops/device port "
              f"{port[name]['flops_per_device']:.0f}, reference {ref[arch]['flops']:.0f}")
        kinds = sorted(set(ref[arch]["by_kind"]) | set(port[name]["collectives"]["by_kind"]))
        for k in kinds:
            p = port[name]["collectives"]["by_kind"].get(k, {"count": 0, "traffic_bytes": 0})
            r = ref[arch]["by_kind"].get(k, {"count": 0, "traffic_bytes": 0})
            print(f"  {k:18s} port {p['count']:4d} x {p['traffic_bytes']:12.0f} B   "
                  f"reference {r['count']:4d} x {r['traffic_bytes']:12.0f} B")


def test_full_size_decode_cell_on_the_multi_pod_mesh():
    """gemma-7b decode_32k traced at full size on the 2x16x16 production mesh
    (a fake world of 512 ranks; about 10 s here), held as the card's smoke
    run held its record: status ok, a non-empty record, and its roofline row.
    Its per-device operations are the weights' products (2 a parameter a
    token) and the attention over the 32k cache (4 B H T D a layer), split
    over the 512 devices."""
    from repro_torch.configs import get_config
    rec, gm, _ = dryrun.lower_cell("gemma-7b", "decode_32k", True)
    assert gm is not None
    assert (rec["status"], rec["mesh"], rec["n_devices"], rec["kind"]) == \
        ("ok", "2x16x16", 512, "decode")
    cfg, shape = get_config("gemma-7b"), SHAPES["decode_32k"]
    B, T = shape.global_batch, shape.seq_len
    want = (2 * rec["active_params"] * B
            + 4 * B * cfg.num_heads * T * cfg.head_dim * cfg.num_layers) / 512
    assert rec["flops_per_device"] == pytest.approx(want, rel=1e-2)
    assert rec["hbm_bytes_per_device"] > 0 and rec["memory_analysis"]["temp_bytes"] > 0
    coll = rec["collectives"]
    assert coll["traffic_bytes"] > 0 and coll["count"] > 0
    assert {"all-gather", "reduce-scatter", "all-reduce"} <= set(coll["by_kind"])
    terms = roofline.cell_terms(rec)
    assert max(terms["compute_s"], terms["memory_s"], terms["collective_s"]) > 0
    assert terms["dominant"] == "memory"          # a decode step reads more than it computes
