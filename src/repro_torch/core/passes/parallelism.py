"""Shard-based parallelism passes: TP / SP / EP / CP (paper §3.2b-i).

The passes adjust sharded operator shapes/costs and insert the collective
operators the parallelism implies (Megatron column->row TP with all-reduce,
SP's reduce-scatter + all-gather split, EP's all-to-all pair, CP's KV
all-gather).  They operate on any traced graph using shape heuristics plus
optional attribute tags set by the model-ingest layer.
"""
from __future__ import annotations

from repro_torch.core.ir import Graph, OpNode


def _scale(node: OpNode, f: float, *, bytes_in=True, bytes_out=True, flops=True):
    if flops:
        node.flops /= f
    if bytes_in:
        node.bytes_in /= f
    if bytes_out:
        node.bytes_out /= f
    if node.attrs.get("mm_dims"):
        m, n, k = node.attrs["mm_dims"]
        node.attrs["mm_dims"] = (m, n, k)  # refined below by caller when known


class TensorParallelPass:
    """Megatron TP: column-parallel then row-parallel matmul pairs; the row
    output needs an all-reduce (or reduce-scatter + all-gather under SP).

    Column/row classification: a matmul whose input is feature-sharded
    (produced by a column-parallel ancestor through elementwise ops) is
    row-parallel; otherwise, if its N dim divides tp it starts a
    column-parallel region.
    """

    name = "tp"

    def apply(self, g: Graph, ctx) -> Graph:
        tp = ctx.parallel.tp
        if tp <= 1:
            return g
        sp = ctx.parallel.sp > 1
        out = Graph(g.name)
        sharded_feat: set[str] = set()   # nodes whose output is feature-sharded
        rename: dict[str, str] = {}
        for node in g.toposort():
            n = node.clone()
            n.deps = [rename.get(d, d) for d in n.deps]
            if n.kind == "matmul":
                m, nn, kk = n.attrs.get("mm_dims", (0, 0, 0))
                lhs_b, rhs_b = n.attrs.get("mm_bytes", (n.bytes_in / 2, n.bytes_in / 2))
                dep_sharded = any(d in sharded_feat for d in node.deps)
                if dep_sharded and kk % tp == 0:
                    # row-parallel: K sharded on both operands -> all-reduce
                    n.flops /= tp
                    n.bytes_in = (lhs_b + rhs_b) / tp
                    n.attrs["mm_bytes"] = (lhs_b / tp, rhs_b / tp)
                    n.attrs["mm_dims"] = (m, nn, kk // tp)
                    out.add(n)
                    cname = "reduce_scatter" if sp else "all_reduce"
                    c = out.op(cname, deps=[n.name],
                               comm_bytes=n.bytes_out / (tp if sp else 1),
                               comm_group="tp", comm_size=tp,
                               bytes_in=n.bytes_out, bytes_out=n.bytes_out,
                               repeat=n.repeat, phase=n.phase, dtype=n.dtype,
                               out_shape=n.out_shape)
                    rename[node.name] = c.name
                    continue
                if nn % tp == 0 and nn >= tp:
                    # column-parallel: N sharded -> weights (rhs) shard by tp
                    if sp:
                        ag = out.op("all_gather", deps=list(n.deps),
                                    comm_bytes=lhs_b / tp,
                                    comm_group="tp", comm_size=tp,
                                    bytes_in=lhs_b, bytes_out=lhs_b,
                                    repeat=n.repeat, phase=n.phase, dtype=n.dtype)
                        n.deps = [ag.name]
                    n.flops /= tp
                    n.bytes_out /= tp
                    n.bytes_in = lhs_b + rhs_b / tp
                    n.attrs["mm_bytes"] = (lhs_b, rhs_b / tp)
                    n.attrs["mm_dims"] = (m, nn // tp, kk)
                    out.add(n)
                    sharded_feat.add(n.name)
                    continue
                out.add(n)
                continue
            if n.kind == "attention" and n.attrs.get("attn_dims"):
                b, h, sq, skv, d = n.attrs["attn_dims"]
                if h % tp == 0:
                    n.flops /= tp
                    n.bytes_in /= tp
                    n.bytes_out /= tp
                    n.attrs["attn_dims"] = (b, h // tp, sq, skv, d)
                    sharded_feat.add(n.name)
                out.add(n)
                continue
            # elementwise/movement: propagate feature sharding + shrink if fed
            # only by sharded producers
            if node.deps and all(d in sharded_feat for d in node.deps):
                n.flops /= tp
                n.bytes_in /= tp
                n.bytes_out /= tp
                sharded_feat.add(n.name)
            out.add(n)
        return out


class SequenceParallelPass:
    """Megatron-SP: ops outside the TP regions (norms, residual elementwise)
    run on a sequence shard.  Applied after TP: unsharded compute nodes
    shrink by sp."""

    name = "sp"

    def apply(self, g: Graph, ctx) -> Graph:
        sp = ctx.parallel.sp
        if sp <= 1:
            return g
        for n in g:
            if n.kind in ("norm", "elementwise", "reduce", "copy", "softmax") \
                    and not n.attrs.get("tp_sharded"):
                n.flops /= sp
                n.bytes_in /= sp
                n.bytes_out /= sp
        return g


class ExpertParallelPass:
    """EP: expert GEMMs shard over ep; an all-to-all pair moves capacity rows
    to expert owners and back (Megatron/DeepSpeed-MoE dataflow)."""

    name = "ep"

    def __init__(self, num_experts: int):
        self.num_experts = num_experts

    def cache_key(self) -> tuple:
        return (self.name, self.num_experts)

    def apply(self, g: Graph, ctx) -> Graph:
        ep = ctx.parallel.ep
        if ep <= 1 or self.num_experts % ep != 0:
            return g
        out = Graph(g.name)
        rename: dict[str, str] = {}
        expert_nodes = []
        for node in g.toposort():
            n = node.clone()
            n.deps = [rename.get(d, d) for d in n.deps]
            is_expert = n.attrs.get("moe_expert") or (
                n.kind == "matmul" and n.out_shape
                and n.out_shape[0] == self.num_experts)
            if is_expert:
                if not expert_nodes:  # first expert GEMM: dispatch all-to-all
                    a2a = out.op("all_to_all", deps=list(n.deps),
                                 comm_bytes=n.bytes_in, comm_group="ep",
                                 comm_size=ep, bytes_in=n.bytes_in,
                                 bytes_out=n.bytes_in, repeat=n.repeat,
                                 phase=n.phase, dtype=n.dtype)
                    n.deps = [a2a.name]
                n.flops /= ep
                n.bytes_in /= ep
                n.bytes_out /= ep
                expert_nodes.append(n.name)
                out.add(n)
                last_expert = n
                continue
            if expert_nodes and any(d in expert_nodes for d in n.deps):
                # leaving the expert region: combine all-to-all
                a2a = out.op("all_to_all", deps=[expert_nodes[-1]],
                             comm_bytes=last_expert.bytes_out,
                             comm_group="ep", comm_size=ep,
                             bytes_in=last_expert.bytes_out,
                             bytes_out=last_expert.bytes_out,
                             repeat=n.repeat, phase=n.phase, dtype=n.dtype)
                n.deps = [a2a.name if d in expert_nodes else d for d in n.deps]
                expert_nodes = []
            out.add(n)
        return out


class ContextParallelPass:
    """CP (Ulysses/ring style): attention q-sequence shards over cp; KV is
    all-gathered per layer."""

    name = "cp"

    def __init__(self, cp: int | None = None):
        self.cp = cp   # explicit size (e.g. reuse of the tp axis); else ctx.cp

    def cache_key(self) -> tuple:
        return (self.name, self.cp)

    def apply(self, g: Graph, ctx) -> Graph:
        cp = self.cp or ctx.parallel.cp
        if cp <= 1:
            return g
        out = Graph(g.name)
        rename: dict[str, str] = {}
        for node in g.toposort():
            n = node.clone()
            n.deps = [rename.get(d, d) for d in n.deps]
            if n.kind == "attention" and n.attrs.get("attn_dims"):
                b, h, sq, skv, d = n.attrs["attn_dims"]
                if sq == 1:
                    # decode: flash-decode style KV-sequence sharding — each
                    # shard scans its KV slice; combine partial softmax with a
                    # small all-reduce of (m, l, o)
                    n.flops /= cp
                    n.bytes_in /= cp
                    n.attrs["attn_dims"] = (b, h, sq, skv // cp, d)
                    out.add(n)
                    ar = out.op("all_reduce", deps=[n.name],
                                comm_bytes=b * h * (d + 2) * 4,
                                comm_group="cp", comm_size=cp,
                                repeat=n.repeat, phase=n.phase, dtype="f32",
                                out_shape=n.out_shape)
                    rename[node.name] = ar.name
                    continue
                # prefill/train: q-sequence sharding, KV all-gathered
                ag = out.op("all_gather", deps=list(n.deps),
                            comm_bytes=2 * b * skv * d * h * 2 / cp,
                            comm_group="cp", comm_size=cp,
                            repeat=n.repeat, phase=n.phase, dtype=n.dtype)
                n.deps = [ag.name]
                n.flops /= cp
                n.bytes_out /= cp
                n.attrs["attn_dims"] = (b, h, sq // cp, skv, d)
            out.add(n)
        return out
