"""Multi-pod dry run (counterpart of ``repro/launch/dryrun.py``).

The reference fakes 512 host devices, lowers each (arch x shape x mesh)
cell's jitted step with ``in_shardings`` and lets XLA's SPMD partitioner
place the collectives.  Here a fake process group of 256 or 512 ranks
(``launch.mesh.fake_world``) stands for the devices: the state, batch and
cache are built as DTensors over the production mesh, each over a
FakeTensor local shard (no memory), with the placements the sharding rules
give them (``training.train_step``'s spec trees), and the step is traced by
``make_fx`` on the CPU device, where every kernel wrapper takes its plain
version.  DTensor places the collectives; the traced graph is rank 0's
program, every shape per device, and ``launch/hlo_analysis.py`` reads the
roofline inputs from it.  The three steps are the reference's: the train
step (``value_and_grad``, the optimizer, remat), ``prefill(cache_len=S)``
and ``decode_step``.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma-7b --shape train_4k

Records go to ``results/torch/dryrun/``.  Plain tensors that the step makes
(positions, masks, constants) are taken as replicated on every rank
(``implicit_replication``), as GSPMD takes constants.  ``layers.scan`` is
traced once between the loop marks of ``core/stubs.py`` (over the local
shards of DTensor operands), as the reference's ``lax.scan`` is one while
loop.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import time
import traceback
from pathlib import Path

import torch

from repro_torch.configs import (
    ARCH_IDS, SHAPES, ModelConfig, RunConfig, ShapeConfig, get_config, get_shape, supports_shape,
)
from repro_torch.distributed.sharding import ShardingEnv, activate, contiguous_stride, resolve_spec
from repro_torch.launch.hlo_analysis import analyze_module, memory_analysis
from repro_torch.launch.mesh import fake_world, make_mesh, production_shape
from repro_torch.launch.specs import input_specs
from repro_torch.models import Model, abstract_cache, cache_logical_axes, count_params
from repro_torch.models import layers as L
from repro_torch.models.params import abstract_params
from repro_torch.training.optimizer import make_optimizer
from repro_torch.training.train_step import (
    batch_pspecs, make_train_step, param_pspecs, state_pspecs, to_named,
)

RESULTS_DIR = Path(__file__).resolve().parents[3] / "results" / "torch" / "dryrun"


# ---------------------------------------------------------------------------
# Run-config defaults per cell
# ---------------------------------------------------------------------------

def default_run(cfg: ModelConfig, shape: ShapeConfig, multi_pod: bool,
                overrides: dict | None = None) -> RunConfig:
    n = count_params(cfg)
    kw = dict(
        pod=2 if multi_pod else 1,
        data=16, model_axis=16,
        optimizer="adafactor" if n > 100e9 else "adamw",
        zero_stage=3 if n > 5e9 else 1,
        remat_policy="block" if shape.kind == "train" else "none",
        microbatches=1,
    )
    if overrides:
        kw.update(overrides)
    return RunConfig(model=cfg, shape=shape, **kw)


# ---------------------------------------------------------------------------
# Cell tracing
# ---------------------------------------------------------------------------

def _cache_pspecs(cfg: ModelConfig, env: ShardingEnv, B: int, S: int):
    """Resolve decode-cache logical axes against the active mesh."""
    return _zip_leaves(abstract_cache(cfg, B, S), cache_logical_axes(cfg, B, S),
                       lambda t, logical: resolve_spec(env, logical, tuple(t.shape)))


class Leaf:
    """One input of a traced step: global shape, dtype and placements (and
    whether it is a parameter that takes a gradient)."""
    __slots__ = ("shape", "dtype", "placements", "grad")

    def __init__(self, shape, dtype, pl, grad=False):
        self.shape, self.dtype, self.placements, self.grad = tuple(shape), dtype, tuple(pl), grad

    def local_shape(self, mesh) -> tuple:
        shape = list(self.shape)
        for i, p in enumerate(self.placements):
            if p.is_shard():
                if shape[p.dim] % mesh.size(i):
                    raise ValueError(f"dim {p.dim} of {self.shape} does not divide mesh dim {i}")
                shape[p.dim] //= mesh.size(i)
        return tuple(shape)


def _zip_leaves(values, pls, make):
    """``make(value_leaf, placements)`` over a value tree and the tree of its
    placements (tuples of placements are leaves)."""
    if isinstance(values, dict):
        return {k: _zip_leaves(values[k], pls[k], make) for k in values}
    if isinstance(values, (list, tuple)):
        return [_zip_leaves(v, p, make) for v, p in zip(values, pls)]
    return make(values, pls)


def _flatten(tree) -> list:
    if isinstance(tree, dict):
        return [x for k in tree for x in _flatten(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _flatten(v)]
    return [tree]


def _unflatten(tree, it):
    if isinstance(tree, dict):
        return {k: _unflatten(tree[k], it) for k in tree}
    if isinstance(tree, (list, tuple)):
        return [_unflatten(v, it) for v in tree]
    return next(it)


def _shard_dim_alltoall(input, gather_dim, shard_dim, mesh, mesh_dim):
    """DTensor's Shard(i) -> Shard(j) as the all-to-all it is on the card
    (on a CPU mesh DTensor makes it an all-gather and a chunk, since Gloo
    has no all-to-all; the fake world's mesh is a CPU mesh)."""
    return torch.ops._dtensor.shard_dim_alltoall(input, gather_dim, shard_dim,
                                                 mesh.get_group(mesh_dim).group_name)


@contextlib.contextmanager
def _alltoall_as_on_card():
    """While open, DTensor's Shard(i) -> Shard(j) traces as
    :func:`_shard_dim_alltoall`.  This swaps a private function of torch's
    ``placement_types`` (there from torch 2.4 on; read on 2.11 and 2.13): a
    release without it raises here, naming its version, rather than tracing
    the CPU mesh's all-gather."""
    from torch.distributed.tensor import placement_types
    if not (hasattr(placement_types, "shard_dim_alltoall")
            and hasattr(torch.ops._dtensor, "shard_dim_alltoall")):
        raise RuntimeError(f"torch {torch.__version__} has no DTensor shard_dim_alltoall: "
                           "the dry run cannot trace a re-sharding as an all-to-all")
    orig = placement_types.shard_dim_alltoall
    placement_types.shard_dim_alltoall = _shard_dim_alltoall
    try:
        yield
    finally:
        placement_types.shard_dim_alltoall = orig


@contextlib.contextmanager
def _traced_loops():
    """While tracing: each ``layers.scan`` traced once between the loop
    marks, and DTensor's re-sharding as the all-to-all the card runs."""
    with L.marked_loops(), _alltoall_as_on_card():
        yield


def _dtensor(local, leaf: Leaf, mesh):
    """One input of the step as a DTensor over its local shard."""
    from torch.distributed.tensor import DTensor
    shape = torch.Size(leaf.shape)
    t = DTensor.from_local(local, mesh, leaf.placements, run_check=False, shape=shape,
                           stride=contiguous_stride(shape))
    return t.requires_grad_(True) if leaf.grad else t


def _local(tree):
    from torch.distributed.tensor import DTensor
    return [t.to_local() if isinstance(t, DTensor) else t
            for t in _flatten(tree) if isinstance(t, torch.Tensor)]


def trace_step(cfg: ModelConfig, shape: ShapeConfig, run: RunConfig, mesh):
    """``(gm, seconds)``: the cell's step traced over DTensors on ``mesh``
    under a sharding env of the default rules (an open process group of
    ``mesh``'s size is needed: ``fake_world``)."""
    env = ShardingEnv(mesh)
    B, S = shape.global_batch, shape.seq_len
    t0 = time.time()
    with activate(env):
        params_abs = abstract_params(cfg)
        zs = run.zero_stage if shape.kind == "train" else 0
        batch_abs = input_specs(cfg, shape)
        b_pl = to_named(env, batch_pspecs(cfg, env, B, kind=shape.kind))
        leaves = {"batch": _zip_leaves(batch_abs, b_pl,
                                       lambda t, pl: Leaf(t.shape, t.dtype, pl))}
        if shape.kind == "train":
            s_pl = to_named(env, state_pspecs(cfg, env, run))
            kw = {"plain_kernels": True} if run.optimizer == "adamw" else {}
            optimizer = make_optimizer(run.optimizer, cfg=cfg, **kw)
            with torch.device("meta"):
                opt_abs = optimizer.init(params_abs)
            leaves["state"] = {
                "params": _zip_leaves(params_abs, s_pl["params"],
                                      lambda t, pl: Leaf(t.shape, t.dtype, pl, grad=True)),
                "opt": _zip_leaves(opt_abs, s_pl["opt"],
                                   lambda t, pl: Leaf(t.shape, t.dtype, pl)),
                "step": Leaf((), torch.int32, s_pl["step"]),
            }
            step = make_train_step(cfg, run, optimizer, device="cpu", plain_kernels=True)

            def fn(state, batch):
                return list(step(state, batch))
        else:
            p_pl = to_named(env, param_pspecs(cfg, env, zs))
            leaves["params"] = _zip_leaves(params_abs, p_pl,
                                           lambda t, pl: Leaf(t.shape, t.dtype, pl))
            model = Model(cfg, "cpu", plain_kernels=True)
            if shape.kind == "prefill":
                def fn(params, batch):
                    return list(model.prefill(params, batch, cache_len=S))
            else:
                cache_abs = abstract_cache(cfg, B, S)
                c_pl = to_named(env, _cache_pspecs(cfg, env, B, S))
                leaves["cache"] = _zip_leaves(cache_abs, c_pl,
                                              lambda t, pl: Leaf(t.shape, t.dtype, pl))

                def fn(params, cache, batch):
                    return list(model.decode_step(params, cache, batch))

        order = [k for k in ("state", "params", "cache", "batch") if k in leaves]
        gm = trace_fn(fn, [leaves[k] for k in order], mesh)
    return gm, time.time() - t0


def trace_fn(fn, trees: list, mesh):
    """``make_fx`` graph of ``fn(*trees)`` over DTensors on ``mesh``: each
    tree's leaves are :class:`Leaf`s, made DTensors over FakeTensor local
    shards; ``fn`` returns a list of DTensors or tensors, whose local shards
    are the graph's outputs."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor.experimental import implicit_replication
    from torch.fx.experimental.proxy_tensor import make_fx

    flat = _flatten(trees)
    with FakeTensorMode():
        locals_ = [torch.empty(leaf.local_shape(mesh), dtype=leaf.dtype) for leaf in flat]

    def traced(*xs):
        it = iter([_dtensor(x, leaf, mesh) for x, leaf in zip(xs, flat)])
        args = [_unflatten(t, it) for t in trees]
        with implicit_replication():
            return _local(fn(*args))

    with _traced_loops():
        gm = make_fx(traced, tracing_mode="fake")(*locals_)
    # nodes whose values nothing reads (DTensor of some torch releases traces
    # its own shape inference at full size into the graph) run nowhere, as
    # XLA's dead-code pass drops them from the reference's module; the graph
    # is read, never run, so its code is not regenerated
    gm.graph.eliminate_dead_code()
    return gm


def _mesh_name(shape: tuple) -> str:
    return "x".join(map(str, shape))


def cell_record(cfg: ModelConfig, arch: str, shape: ShapeConfig, mesh, *,
                run: RunConfig | None = None, multi_pod: bool = False):
    """``(record, gm)`` of ``cfg`` at ``shape`` traced on ``mesh`` (an open
    world of its size is needed; ``lower_cell`` opens the production one)."""
    run = run or default_run(cfg, shape, multi_pod)
    gm, t_lower = trace_step(cfg, shape, run, mesh)
    stats = analyze_module(gm)
    mem = memory_analysis(gm)
    record = {
        "arch": arch, "shape": shape.name,
        "mesh": _mesh_name(tuple(mesh.shape)),
        "status": "ok",
        "n_devices": int(mesh.size()),
        "kind": shape.kind,
        "params": count_params(cfg),
        "active_params": count_params(cfg, active_only=True),
        # XLA's own cost analysis has no counterpart here
        "xla_flops": None,
        "xla_bytes_accessed": None,
        # trip-count-aware per-device numbers (launch/hlo_analysis.py)
        "flops_per_device": stats["flops"],
        "hbm_bytes_per_device": stats["hbm_bytes"],
        "while_loops": stats["while_loops"],
        "memory_analysis": {**mem, "generated_code_bytes": None},
        "collectives": stats["collectives"],
        "zero_stage": run.zero_stage,
        "optimizer": run.optimizer,
        "remat": run.remat_policy,
        "lower_s": round(t_lower, 2),
        "compile_s": None,
        "hlo_bytes": None,
        "graph_nodes": stats["n_computations"],
    }
    return record, gm


def lower_cell(arch: str, shape_name: str, multi_pod: bool,
               run_overrides: dict | None = None,
               model_overrides: dict | None = None):
    """Trace one (arch x shape x mesh) cell on the production mesh in a fake
    world of its size.  Returns ``(record, gm, None)``: the record carries
    cost/memory/collective numbers, ``gm`` is the traced graph (the
    reference returns its lowered and compiled steps)."""
    cfg = get_config(arch)
    if model_overrides:
        cfg = cfg.replace(**model_overrides)
    shape = get_shape(shape_name)
    mesh_tag = "2x16x16" if multi_pod else "16x16"
    if not supports_shape(cfg, shape):
        return ({"arch": arch, "shape": shape_name, "mesh": "multi" if multi_pod else "single",
                 "status": "skipped", "reason": "sub-quadratic-only shape on full-attention arch"},
                None, None)
    mesh_shape, axes = production_shape(multi_pod)
    run = default_run(cfg, shape, multi_pod, run_overrides)
    with fake_world(math.prod(mesh_shape)):
        mesh = make_mesh(mesh_shape, axes)
        record, gm = cell_record(cfg, arch, shape, mesh, run=run, multi_pod=multi_pod)
    record["mesh"] = mesh_tag
    return record, gm, None


# ---------------------------------------------------------------------------
# Command line
# ---------------------------------------------------------------------------

def run_cell_to_file(arch: str, shape_name: str, multi_pod: bool) -> dict:
    RESULTS_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{arch}__{shape_name}__{'multi' if multi_pod else 'single'}"
    out = RESULTS_DIR / f"{tag}.json"
    try:
        record, _, _ = lower_cell(arch, shape_name, multi_pod)
    except Exception as e:
        record = {"arch": arch, "shape": shape_name,
                  "mesh": "2x16x16" if multi_pod else "16x16",
                  "status": "error", "error": f"{type(e).__name__}: {e}",
                  "traceback": traceback.format_exc()[-4000:]}
    out.write_text(json.dumps(record, indent=1))
    return record


def main():
    ap = argparse.ArgumentParser(description="multi-pod dry-run")
    ap.add_argument("--arch", default=None, choices=list(ARCH_IDS))
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--mesh", default="single", choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true", help="run every remaining cell")
    ap.add_argument("--force", action="store_true", help="recompute cached cells")
    args = ap.parse_args()

    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]
    cells = []
    for arch in ([args.arch] if args.arch else ARCH_IDS):
        for shape_name in ([args.shape] if args.shape else SHAPES):
            for mp in meshes:
                cells.append((arch, shape_name, mp))
    if not args.all and not (args.arch and args.shape):
        ap.error("give --arch and --shape, or --all")

    for arch, shape_name, mp in cells:
        tag = f"{arch}__{shape_name}__{'multi' if mp else 'single'}"
        out = RESULTS_DIR / f"{tag}.json"
        if out.exists() and not args.force:
            rec = json.loads(out.read_text())
            print(f"[cached] {tag}: {rec.get('status')}", flush=True)
            continue
        t0 = time.time()
        rec = run_cell_to_file(arch, shape_name, mp)
        status = rec.get("status")
        extra = "" if status != "error" else " :: " + rec.get("error", "")[:160]
        print(f"[{time.time()-t0:7.1f}s] {tag}: {status}{extra}", flush=True)
        if status == "ok":
            ma = rec.get("memory_analysis", {})
            print(f"    flops/dev={rec.get('flops_per_device'):.3e} "
                  f"hbm/dev={rec.get('hbm_bytes_per_device'):.3e} "
                  f"coll_traffic/dev={rec['collectives']['traffic_bytes']:.3e} "
                  f"(n={rec['collectives']['count']}) mem={ma}", flush=True)


if __name__ == "__main__":
    main()
