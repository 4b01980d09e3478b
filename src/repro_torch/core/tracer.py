"""Graph tracer: torch model ingestion (paper §3.2a).

Charon ingests PyTorch models via torch.fx; ``trace(fn, *args)`` turns any
callable that ``make_fx`` can trace (the port's model zoo, user code) into an
operator-level :class:`~repro_torch.core.ir.Graph`.  The trace runs over
FakeTensors, so a full-width layer costs no memory.  Backward graphs come from
``torch.autograd.grad`` traced inside the same ``make_fx`` call (the
aot_autograd joint graph).  Torch has no ``lax.scan``: a Python loop is
unrolled into one node per iteration, and the model ingest sets a block's
``repeat`` from the layer count instead (``core/model_ingest.py``).

The ATen-op tables below mirror the reference's lax-primitive tables, so
that each op lands in the same node kind with the same flop and byte rules.
Collectives and convolutions have no table yet: the port's models have none,
and the parallelism passes insert the collectives a sharding implies.
"""
from __future__ import annotations

import math
import operator
from functools import partial
from typing import Any, Callable

import torch
from torch.fx.experimental.proxy_tensor import make_fx
from torch.utils._pytree import tree_flatten, tree_leaves, tree_map

from repro_torch.core.ir import Graph
from repro_torch.core.stubs import attention_flops

_DTYPE_BYTES = {"float32": 4, "bfloat16": 2, "float16": 2, "int32": 4,
                "uint32": 4, "int8": 1, "uint8": 1, "bool": 1, "float64": 8,
                "int64": 8, "uint64": 8, "float8_e4m3fn": 1, "float8_e5m2": 1}
_DTYPE_SHORT = {"float32": "f32", "bfloat16": "bf16", "float16": "f16",
                "int8": "int8", "float8_e4m3fn": "f8", "float8_e5m2": "f8"}

# Any op with a tensor output that no table names (add, mul, where, the
# dtype cast ``_to_copy``, ...) is elementwise, one flop an element, as the
# reference prices its ELEMENTWISE primitives and every unknown one.
MATMUL = {"mm", "bmm", "addmm", "baddbmm"}
TRANSCENDENTAL = {"exp", "log", "tanh", "sigmoid", "rsqrt", "sqrt", "pow", "sin",
                  "cos", "erf", "erfinv", "log1p", "expm1", "exp2", "atan2", "silu",
                  "gelu", "softplus", "_softmax", "_log_softmax",
                  "_softmax_backward_data", "_log_softmax_backward_data",
                  "silu_backward", "gelu_backward", "sigmoid_backward",
                  "tanh_backward"}
MOVEMENT = {"view": "copy", "_unsafe_view": "copy", "reshape": "copy",
            "_reshape_alias": "copy", "expand": "copy", "unsqueeze": "copy",
            "squeeze": "copy", "clone": "copy", "contiguous": "copy",
            "slice": "copy", "select": "copy", "narrow": "copy", "split": "copy",
            "split_with_sizes": "copy", "unbind": "copy", "cat": "copy",
            "stack": "copy", "flip": "copy", "roll": "copy", "repeat": "copy",
            "constant_pad_nd": "copy", "as_strided": "copy",
            "arange": "copy", "ones": "copy", "zeros": "copy", "full": "copy",
            "ones_like": "copy", "zeros_like": "copy", "full_like": "copy",
            "scalar_tensor": "copy", "new_ones": "copy", "new_zeros": "copy",
            "new_full": "copy",
            "permute": "transpose", "t": "transpose", "transpose": "transpose",
            "index": "gather", "index_select": "gather", "gather": "gather",
            "embedding": "gather",
            "index_put": "scatter", "scatter": "scatter", "scatter_add": "scatter",
            "index_add": "scatter", "slice_scatter": "scatter",
            "select_scatter": "scatter", "copy_": "scatter",
            "sort": "sort", "argsort": "sort", "topk": "sort"}
# ops that extract part of an operand: they read what they extract
EXTRACT = {"slice", "select", "narrow", "split", "split_with_sizes", "unbind",
           "index", "index_select", "gather", "embedding"}
REDUCTION = {"sum", "mean", "amax", "amin", "max", "min", "prod", "argmax",
             "argmin", "cumsum", "cumprod", "var", "std", "logsumexp", "any",
             "all", "norm", "linalg_vector_norm"}
# no work and no node: aliases pass their producer on; allocations start none
ALIAS = {"detach", "alias", "lift_fresh", "lift_fresh_copy"}
NO_OP = {"empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided"}
# reshapes that ``torch.matmul`` (and a weight's 2-D view) put around ``mm``:
# the reference's ``dot_general`` takes and gives those shapes itself, so they
# belong to the product and make no node
MATMUL_RESHAPE = {"view", "_unsafe_view", "reshape", "_reshape_alias"}
TRANSPOSE = {"t", "permute", "transpose"}


def _dtype_name(dtype) -> str:
    return str(dtype).replace("torch.", "")


def _val_bytes(t) -> float:
    return float(math.prod(t.shape)) * _DTYPE_BYTES.get(_dtype_name(t.dtype), 4)


def _val_elems(t) -> float:
    return float(math.prod(t.shape))


def _short_dtype(t) -> str:
    return _DTYPE_SHORT.get(_dtype_name(getattr(t, "dtype", "bfloat16")), "f32")


def _tensor_vals(obj) -> list:
    return [v for v in tree_leaves(obj) if isinstance(v, torch.Tensor)]


def _op_name(target) -> str:
    """``aten.mm.default`` -> ``mm``; ``aten.index_put_.default`` -> ``index_put_``."""
    return target._schema.name.split("::")[-1]


class _TraceCtx:
    def __init__(self, graph: Graph):
        self.graph = graph
        self.producer: dict[Any, str] = {}

    def dep_of(self, fx_node) -> str | None:
        return self.producer.get(fx_node)


def _fx_inputs(fx_node) -> list:
    """The fx nodes a node reads, lists (``cat``, ``index_put``) flattened."""
    return [a for a in tree_leaves((fx_node.args, fx_node.kwargs))
            if isinstance(a, torch.fx.Node)]


def _mm_node(ctx: _TraceCtx, ins: list, out, common: dict):
    # operand pair: (lhs, rhs) of mm/bmm, (mat1, mat2) after addmm's bias
    lhs, rhs = (ins[-2], ins[-1])
    contract = lhs.shape[-1]
    out_elems = _val_elems(out)
    flops = 2.0 * out_elems * contract
    # (M, N, K) for the alignment model, as the reference derives them
    n = rhs.shape[-1]
    m = out_elems / max(n, 1)
    node = ctx.graph.op("matmul", flops=flops, **common)
    node.attrs["mm_dims"] = (int(m), int(n), int(contract))
    node.attrs["mm_bytes"] = (_val_bytes(lhs), _val_bytes(rhs))
    return node


def _is_op(fx_node, names) -> bool:
    return (fx_node.op == "call_function" and isinstance(fx_node.target, torch._ops.OpOverload)
            and _op_name(fx_node.target) in names)


def _feeds_matmul(fx_node) -> bool:
    """Every use of ``fx_node`` is a matmul operand, directly or through
    reshapes and transposes."""
    return bool(fx_node.users) and all(
        _is_op(u, MATMUL) or (_is_op(u, MATMUL_RESHAPE | TRANSPOSE) and _feeds_matmul(u))
        for u in fx_node.users)


def _matmul_reshapes(gm: torch.fx.GraphModule) -> set:
    """Reshapes on a matmul operand's way in, or of a matmul's output."""
    return {n for n in gm.graph.nodes if _is_op(n, MATMUL_RESHAPE)
            and (_feeds_matmul(n) or _is_op(n.args[0], MATMUL))}


def _trace_fx(ctx: _TraceCtx, gm: torch.fx.GraphModule, phase: str):
    g = ctx.graph
    folded = _matmul_reshapes(gm)
    for fx_node in gm.graph.nodes:
        if fx_node.op != "call_function":
            continue
        target = fx_node.target
        if target is operator.getitem:
            src = fx_node.args[0]
            if ctx.dep_of(src):
                ctx.producer[fx_node] = ctx.dep_of(src)
            continue
        if not isinstance(target, torch._ops.OpOverload):
            continue
        op = _op_name(target)
        # an in-place op is priced as its functional form (``copy_`` is a scatter)
        base = op if op in MOVEMENT else op.rstrip("_")
        fx_ins = _fx_inputs(fx_node)
        if base in ALIAS or fx_node in folded:
            if fx_ins and ctx.dep_of(fx_ins[0]):
                ctx.producer[fx_node] = ctx.dep_of(fx_ins[0])
            continue
        if base in NO_OP:
            continue
        outs = _tensor_vals(fx_node.meta.get("val"))
        if not outs:
            continue
        ins = [v for a in fx_ins for v in _tensor_vals(a.meta.get("val"))]
        deps = [d for a in fx_ins if (d := ctx.dep_of(a))]
        out = outs[0]
        common = dict(deps=deps,
                      out_shape=tuple(int(s) for s in out.shape),
                      dtype=_short_dtype(out),
                      bytes_in=sum(_val_bytes(v) for v in ins),
                      bytes_out=sum(_val_bytes(v) for v in outs),
                      repeat=1, phase=phase)
        if base in ("charon_attention", "charon_attention_bwd"):
            q, k, v = ins[:3]
            causal, window = fx_node.args[-2], fx_node.args[-1]
            fl = attention_flops(q.shape, v.shape, causal=causal, window=window)
            if base.endswith("bwd"):
                fl *= 2.5  # dq/dk/dv + score recompute
            b, sq, hkv, g_, dq = q.shape
            node = g.op("attention", flops=fl, **common)
            node.attrs["attn_dims"] = (int(b), int(hkv * g_), int(sq),
                                       int(v.shape[1]), int(dq))
            node.attrs["causal"], node.attrs["window"] = causal, window
            # GQA group: the profiling engine synthesises grouped attention
            node.attrs["G"] = int(g_)
        elif base in MATMUL:
            node = _mm_node(ctx, ins, out, common)
        elif base in REDUCTION:
            node = g.op("reduce", flops=sum(_val_elems(v) for v in ins), **common)
        elif base in MOVEMENT:
            kind = MOVEMENT[base]
            if base in EXTRACT:
                # slices/gathers read the extracted elements, not the operand
                # (embedding lookups must not be priced as full-table reads)
                common = dict(common, bytes_in=common["bytes_out"])
            if kind == "scatter" and len(ins) >= 2:
                # in-place update semantics: traffic = read+write of the
                # UPDATE slice + indices, not the full buffer; the operand's
                # size is kept for engines on non-aliasing backends
                operand_bytes = _val_bytes(ins[0])
                upd_bytes = sum(_val_bytes(v) for v in ins[1:])
                common = dict(common, bytes_in=upd_bytes, bytes_out=upd_bytes)
                node = g.op(kind, **common)
                node.attrs["operand_bytes"] = operand_bytes
                ctx.producer[fx_node] = node.name
                continue
            node = g.op(kind, **common)
        elif base in TRANSCENDENTAL:
            node = g.op("elementwise", flops=4.0 * _val_elems(out), **common)
        else:
            node = g.op("elementwise", flops=_val_elems(out), **common)
        ctx.producer[fx_node] = node.name
    return ctx


def trace(fn: Callable, *args, name: str = "traced", phase: str = "fwd",
          coalesce: bool = True, **kwargs) -> Graph:
    """Native ingestion: any torch callable + example args (real or fake
    tensors, in pytrees) -> Graph; the trace runs over FakeTensors."""
    gm = make_fx(partial(fn, **kwargs) if kwargs else fn, tracing_mode="fake")(*args)
    g = Graph(name)
    _trace_fx(_TraceCtx(g), gm, phase)
    if coalesce:
        g = coalesce_elementwise(g)
    return g


def _with_grad(t):
    if isinstance(t, torch.Tensor) and t.is_floating_point():
        return t.detach().requires_grad_()
    return t


def trace_grad(fn: Callable, *args, name: str = "joint", **kwargs) -> Graph:
    """Joint forward+backward graph via torch.autograd.grad (aot_autograd's
    joint graph).  Every floating-point input is differentiated; the
    cotangents are ones.  Backward-only cost = joint - forward."""
    f = partial(fn, **kwargs) if kwargs else fn

    def joint(*a):
        wrt = [t for t in tree_flatten(a)[0]
               if isinstance(t, torch.Tensor) and t.requires_grad]
        outs = [t for t in _tensor_vals(f(*a)) if t.requires_grad]
        return torch.autograd.grad(outs, wrt, [torch.ones_like(o) for o in outs],
                                   allow_unused=True)

    return trace(joint, *tree_map(_with_grad, args), name=name, phase="bwd")


# --------------------------------------------------------------------------
# PyTorch-profiler granularity: coalesce adjacent elementwise chains
# --------------------------------------------------------------------------

def coalesce_elementwise(g: Graph) -> Graph:
    """Fuse elementwise/copy chains into single nodes (matching what XLA's
    fuser — and the paper's operator granularity — would show)."""
    FUSABLE = {"elementwise", "copy"}
    succ_n = {k: len(v) for k, v in g.successors().items()}
    out = Graph(g.name)
    alias: dict[str, str] = {}
    orig_of: dict[str, str] = {}  # output-graph name -> last original fused in
    for node in g.toposort():
        deps = [alias.get(d, d) for d in node.deps]
        if node.kind in FUSABLE and deps:
            cand = deps[0]
            if (cand in out.nodes and out.nodes[cand].kind in FUSABLE
                    and out.nodes[cand].repeat == node.repeat
                    and succ_n.get(orig_of.get(cand, cand), 2) == 1):
                p = out.nodes[cand]
                p.flops += node.flops
                p.bytes_out = node.bytes_out        # chain output replaces
                p.out_shape = node.out_shape or p.out_shape
                for d in deps[1:]:
                    if d != p.name and d not in p.deps:
                        p.deps.append(d)
                alias[node.name] = p.name
                orig_of[p.name] = node.name
                continue
        nn = node.clone()
        nn.deps = [d for d in dict.fromkeys(deps) if d != nn.name]
        out.nodes[nn.name] = nn
        orig_of[nn.name] = node.name
    return out
