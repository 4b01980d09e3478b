"""DP / ZeRO / FSDP passes (paper §3.2b-iii).

DDP: gradient all-reduce over the dp group, tagged overlappable (bucketed
sync overlaps the backward pass).  ZeRO-1/2: reduce-scatter gradients +
all-gather updated params.  ZeRO-3/FSDP: additionally all-gather parameters
in forward and backward (prefetch-overlappable).  Cross-pod DP pays the
hierarchical (ICI+DCN) price via intra/inter sizes on the node attrs.
"""
from __future__ import annotations

from repro_torch.core.ir import Graph


class DataParallelPass:
    name = "dp"

    def __init__(self, *, grad_dtype_bytes: int = 2, compression: str = "none"):
        self.grad_bytes_per_param = {"none": grad_dtype_bytes, "int8": 1}.get(
            compression, grad_dtype_bytes)
        self.compression = compression

    def apply(self, g: Graph, ctx) -> Graph:
        p = ctx.parallel
        dp_total = p.dp * p.pods
        if dp_total <= 1 or ctx.param_bytes <= 0:
            return g
        n_params = ctx.param_bytes / 2  # params assumed bf16
        grad_bytes = n_params * self.grad_bytes_per_param / (p.tp * max(p.ep, 1) // max(p.ep, 1))
        grad_bytes = n_params * self.grad_bytes_per_param / p.tp
        zs = p.zero_stage
        hier = {"intra_size": p.dp, "inter_size": p.pods}

        last = None
        for node in g:
            last = node.name
        if zs >= 1:
            g.op("reduce_scatter", name="dp_grad_reduce_scatter",
                 deps=[last] if last else [],
                 comm_bytes=grad_bytes, comm_group="dp", comm_size=dp_total,
                 overlappable=True, stream="dp_comm", phase="opt",
                 attrs=dict(hier))
            g.op("all_gather", name="dp_param_all_gather",
                 deps=["dp_grad_reduce_scatter"],
                 comm_bytes=n_params * 2 / p.tp, comm_group="dp",
                 comm_size=dp_total, overlappable=True, stream="dp_comm",
                 phase="opt", attrs=dict(hier))
        else:
            g.op("all_reduce", name="dp_grad_all_reduce",
                 deps=[last] if last else [],
                 comm_bytes=grad_bytes, comm_group="dp", comm_size=dp_total,
                 overlappable=True, stream="dp_comm", phase="opt",
                 attrs=dict(hier))
        if zs >= 3:
            # FSDP parameter all-gathers in fwd and bwd (prefetchable)
            for phase in ("fwd", "bwd"):
                g.op("all_gather", name=f"fsdp_param_ag_{phase}",
                     comm_bytes=n_params * 2 / p.tp, comm_group="dp",
                     comm_size=dp_total, overlappable=True, stream="dp_comm",
                     phase=phase, attrs=dict(hier))
        return g


def optimizer_step_cost(n_params: float, *, optimizer: str = "adamw",
                        zero_stage: int = 0, dp: int = 1) -> tuple[float, float]:
    """(flops, bytes) of the optimizer update, post ZeRO sharding."""
    shard = dp if zero_stage >= 1 else 1
    n = n_params / shard
    if optimizer == "adamw":
        flops = 12 * n
        byts = n * (2 + 2 + 4 + 4) + n * (4 + 4)   # p, g, m, v read + m,v write
    else:  # adafactor
        flops = 14 * n
        byts = n * (2 + 2) + 4 * (n ** 0.5) * 4
    return flops, byts
