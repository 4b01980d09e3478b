"""Graph analysis: trip-count-aware FLOPs / HBM bytes / collectives
(counterpart of ``repro/launch/hlo_analysis.py``).

The reference parses the per-device optimized HLO text of a step that XLA's
SPMD partitioner has sharded.  The port's dry run (``launch/dryrun.py``)
traces the step over DTensors with ``make_fx``; the graph it gets holds each
rank's local operations and the functional collectives DTensor placed
(``_c10d_functional.*``), so every shape in it is per-device, and so is every
number reported here.  The same roles and formulas:

  * execution counts: the nodes between a ``charon::scan_enter`` mark and its
    ``scan_exit`` (``core/stubs.py``; ``layers.scan`` traced once, as a
    ``lax.scan`` is a while loop with a known trip count) count the loop's
    length times; nested loops multiply,
  * dot FLOPs: ``2 * prod(out dims) * prod(contracting dims)`` for ``mm``,
    ``bmm``, ``addmm``, ``baddbmm`` and ``convolution``,
  * HBM traffic: every materialising node reads its operands and writes its
    output once.  View-like nodes cost nothing.  A gather reads only what it
    gathers (twice its output, as the reference prices a slice), and an
    in-place row write (``index_put_``) prices the rows, not the buffer (the
    reference's dynamic-update-slice).  Unlike the reference, casts
    (``_to_copy``) are counted: an eager program materialises each one,
  * collective inventory with ring-algorithm per-device link traffic:
      all-gather          (n-1) * operand      (operand = local shard)
      reduce-scatter      (n-1)/n * operand    (operand = full local buffer)
      all-reduce          2 (n-1)/n * operand
      all-to-all          (n-1)/n * operand
    with ``n`` the group's size (the node's group-size argument, else the
    size of the process group it names).
"""
from __future__ import annotations

import math
import operator
from dataclasses import dataclass

import torch

# nodes that move no bytes: views, aliases, the collectives' waits, the loop marks
_VIEW_OPS = {
    "view", "_unsafe_view", "expand", "permute", "t", "transpose", "slice", "select",
    "split", "split_with_sizes", "unbind", "unsqueeze", "squeeze", "alias", "detach",
    "as_strided", "narrow", "view_as", "_reshape_alias", "lift_fresh", "wait_tensor",
    "scan_enter", "scan_exit", "empty", "empty_strided", "new_empty", "_local_scalar_dense",
}
_GATHER_OPS = {"index_select", "index", "gather", "embedding"}
_ROW_WRITES = {"index_put_", "index_put"}
_DOT_OPS = {"mm", "bmm", "addmm", "baddbmm", "convolution"}
_COLL_KINDS = {
    "all_gather_into_tensor": "all-gather", "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter", "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
    "all_to_all_single": "all-to-all",
    "shard_dim_alltoall": "all-to-all",      # DTensor's Shard(i) -> Shard(j)
}
_COLL_NAMESPACES = ("_c10d_functional", "_c10d_functional_autograd", "_dtensor")


def op_name(node) -> str:
    """The ATen op's name without its namespace and overload (``mm``,
    ``index_put_``), ``getitem`` for a tuple's item, or '' for a non-call."""
    if node.op != "call_function":
        return ""
    t = node.target
    if t is operator.getitem:
        return "getitem"
    if isinstance(t, torch._ops.OpOverload):
        return t._schema.name.split("::")[-1]
    return getattr(t, "__name__", str(t))


def _namespace(node) -> str:
    t = node.target
    return t.namespace if isinstance(t, torch._ops.OpOverload) else ""


def _tensors(val) -> list:
    if isinstance(val, torch.Tensor):
        return [val]
    if isinstance(val, (list, tuple)):
        return [t for v in val for t in _tensors(v)]
    return []


def tensor_bytes(val) -> float:
    return float(sum(t.numel() * t.element_size() for t in _tensors(val)))


def _val(x):
    return x.meta.get("val") if isinstance(x, torch.fx.Node) else None


def _arg_nodes(node) -> list:
    out = []

    def walk(a):
        if isinstance(a, torch.fx.Node):
            out.append(a)
        elif isinstance(a, (list, tuple)):
            for b in a:
                walk(b)
    for a in node.args:
        walk(a)
    for a in node.kwargs.values():
        walk(a)
    return out


def _operand_bytes(node) -> float:
    return sum(tensor_bytes(_val(a)) for a in _arg_nodes(node))


def dot_flops(node) -> float:
    """``2 * prod(out) * prod(contracting)`` of a product node."""
    name = op_name(node)
    out = _val(node)
    if name in ("addmm", "baddbmm"):
        a = _val(node.args[1])
    elif name == "convolution":
        w = _val(node.args[1])                  # (Cout, Cin / groups, *kernel)
        return 2.0 * out.numel() * (w.shape[1] * math.prod(w.shape[2:]))
    else:
        a = _val(node.args[0])
    return 2.0 * out.numel() * a.shape[-1]


def group_size(node, group_sizes: dict | None = None) -> int:
    """The collective's group size: its ``group_size`` argument where it has
    one, else the size of the process group its ``group_name`` names."""
    names = [a.name for a in node.target._schema.arguments]
    args = dict(zip(names, node.args)) | dict(node.kwargs)
    if "group_size" in args:
        return int(args["group_size"])
    name = args["group_name"]
    if group_sizes and name in group_sizes:
        return group_sizes[name]
    from torch.distributed.distributed_c10d import _resolve_process_group
    return _resolve_process_group(name).size()


@dataclass
class Collective:
    kind: str
    name: str
    operand_bytes: float
    output_bytes: float
    group_size: int
    mult: float = 1.0

    @property
    def traffic_bytes(self) -> float:
        n = max(self.group_size, 1)
        b = self.operand_bytes
        if self.kind == "all-gather":
            t = (n - 1) * b
        elif self.kind == "all-reduce":
            t = 2.0 * (n - 1) / n * b
        elif self.kind in ("reduce-scatter", "all-to-all"):
            t = (n - 1) / n * b
        else:
            t = b
        return t * self.mult


def collective_kind(node) -> str | None:
    if _namespace(node) not in _COLL_NAMESPACES:
        return None
    return _COLL_KINDS.get(op_name(node))


def _node_hbm_bytes(node, name: str) -> float:
    if name in _VIEW_OPS or name == "getitem":
        return 0.0
    if name in _GATHER_OPS:
        return 2.0 * tensor_bytes(_val(node))
    if name in _ROW_WRITES:
        # the buffer is written where it lies: price the rows (the reference's
        # dynamic-update-slice); the other operands (indices, rows) are read
        upd = tensor_bytes(_val(node.args[2]))
        rest = sum(tensor_bytes(_val(a)) for a in _arg_nodes(node)[1:])
        return rest + 2.0 * upd
    if name == "copy_":
        return 2.0 * tensor_bytes(_val(node.args[1]))
    return tensor_bytes(_val(node)) + _operand_bytes(node)


def execution_counts(gm) -> dict:
    """{node: how many times it runs}: the product of the lengths of the
    loops (scan marks) around it."""
    counts, stack = {}, []
    for node in gm.graph.nodes:
        name = op_name(node)
        if name == "scan_exit":
            stack.pop()
        counts[node] = math.prod(stack)
        if name == "scan_enter":
            stack.append(int(node.args[1]))
    if stack:
        raise ValueError("a scan_enter mark has no scan_exit")
    return counts


def analyze_module(gm, *, group_sizes: dict | None = None) -> dict:
    """The reference's record of one per-device graph: ``flops``,
    ``hbm_bytes``, ``collectives`` (``by_kind``, ``count``,
    ``operand_bytes``, ``traffic_bytes``), ``while_loops`` (one entry a loop
    with its ``trip_count``) and ``n_computations`` (the graph's nodes)."""
    counts = execution_counts(gm)
    flops = 0.0
    hbm_bytes = 0.0
    colls: list[Collective] = []
    while_info: list[dict] = []
    for node in gm.graph.nodes:
        if node.op != "call_function":
            continue
        name, mult = op_name(node), counts[node]
        if name == "scan_enter":
            while_info.append({"name": node.name, "trip_count": int(node.args[1])})
        if name in _DOT_OPS:
            flops += dot_flops(node) * mult
        kind = collective_kind(node)
        if kind:
            colls.append(Collective(kind, node.name, _operand_bytes(node),
                                    tensor_bytes(_val(node)), group_size(node, group_sizes),
                                    mult))
        hbm_bytes += _node_hbm_bytes(node, name) * mult

    by_kind: dict[str, dict] = {}
    for cl in colls:
        d = by_kind.setdefault(cl.kind, {"count": 0, "operand_bytes": 0.0,
                                         "traffic_bytes": 0.0})
        d["count"] += int(cl.mult) if cl.mult >= 1 else 1
        d["operand_bytes"] += cl.operand_bytes * cl.mult
        d["traffic_bytes"] += cl.traffic_bytes

    return {
        "flops": flops,
        "hbm_bytes": hbm_bytes,
        "collectives": {
            "by_kind": by_kind,
            "count": sum(d["count"] for d in by_kind.values()),
            "operand_bytes": sum(d["operand_bytes"] for d in by_kind.values()),
            "traffic_bytes": sum(d["traffic_bytes"] for d in by_kind.values()),
        },
        "while_loops": while_info,
        "n_computations": len(gm.graph.nodes),
    }


def memory_analysis(gm) -> dict:
    """``argument_bytes`` (the graph's inputs), ``output_bytes`` (its
    outputs) and ``temp_bytes``: the peak of the bytes held by the
    intermediates that are live at once, in a walk over the graph in order.
    A view or an in-place op keeps its base alive; an intermediate lives from
    the node that makes it to the last use of it or of a view of it (a loop's
    body counted once).  XLA's buffer assignment, which the reference reads,
    also reuses and aliases buffers; this walk does not."""
    nodes = list(gm.graph.nodes)
    pos = {n: i for i, n in enumerate(nodes)}
    root, size = {}, {}
    for n in nodes:
        name = op_name(n)
        args = _arg_nodes(n)
        if n.op == "call_function" and args and (
                name in _VIEW_OPS or name == "getitem" or name.endswith("_")) \
                and name not in ("empty", "empty_strided", "new_empty", "scan_enter",
                                 "scan_exit"):
            root[n] = root.get(args[0], args[0])
        else:
            root[n] = n
            size[n] = tensor_bytes(_val(n)) if n.op == "call_function" else 0.0
    last = {r: pos[r] for r in size}
    end = len(nodes)
    for n in nodes:
        for a in _arg_nodes(n):
            r = root[a]
            if r in last:
                last[r] = max(last[r], end if n.op == "output" else pos[n])
    delta = [0.0] * (end + 2)
    for r, b in size.items():
        if b:
            delta[pos[r]] += b
            delta[last[r] + 1] -= b
    live = peak = 0.0
    for d in delta:
        live += d
        peak = max(peak, live)
    out_node = next(n for n in reversed(nodes) if n.op == "output")
    return {
        "argument_bytes": sum(tensor_bytes(_val(n)) for n in nodes if n.op == "placeholder"),
        "output_bytes": sum(tensor_bytes(_val(a)) for a in _arg_nodes(out_node)),
        "temp_bytes": peak,
    }


def collective_summary(gm) -> dict:
    return analyze_module(gm)["collectives"]
