"""Precision pass (paper §3.2b quantization).

Rewrites node dtypes; bytes scale by the dtype-width ratio and compute time
scales through the hardware's precision-specific peak (the analytical engine
reads node.dtype).  Matmul-only quantization (weight-only W8A16-style) is the
default; full activation quantization is opt-in."""
from __future__ import annotations

from repro_torch.core.ir import Graph

_BYTES = {"f32": 4, "bf16": 2, "f16": 2, "int8": 1, "f8": 1}


class QuantizePass:
    name = "quantize"

    def __init__(self, dtype: str = "int8", *, matmul_only: bool = True):
        self.dtype = dtype
        self.matmul_only = matmul_only

    def cache_key(self) -> tuple:
        return (self.name, self.dtype, self.matmul_only)

    def apply(self, g: Graph, ctx=None) -> Graph:
        new_b = _BYTES[self.dtype]
        for n in g:
            if self.matmul_only and n.kind not in ("matmul", "fused", "attention", "conv"):
                continue
            old_b = _BYTES.get(n.dtype, 2)
            scale = new_b / old_b
            n.bytes_in *= scale
            n.bytes_out *= scale
            if n.is_comm:
                n.comm_bytes *= scale
            n.dtype = self.dtype
        return g
