"""Analytical engine: roofline for compute, link-centric model for comm.

Compute ops (paper §3.3c): t = max(flops / (peak * eff), bytes / (bw * eff)).
TPU adaptation: MXU efficiency degrades when matmul dims misalign with the
128x128 systolic tile / 8-row subtile, and when the working set exceeds VMEM
(double-buffering stalls).  This replaces CUDA occupancy heuristics — the
paper's analytical engine is hardware-agnostic by design.
"""
from __future__ import annotations

import math

import numpy as np

from repro_torch.core.backend.collectives import GroupSpec, hierarchical_collective_time_us
from repro_torch.core.backend.hardware import HardwareSpec
from repro_torch.core.ir import OpNode

_DTYPE_KEY = {"bf16": "bf16", "f16": "bf16", "f32": "f32", "fp32": "f32",
              "int8": "int8", "f8": "f8", "fp8": "f8"}


def mxu_efficiency(node: OpNode, hw: HardwareSpec) -> float:
    """Alignment-based MXU utilisation for matmul-class ops."""
    eff = hw.matmul_eff
    dims = node.attrs.get("mm_dims")  # (M, N, K) when the tracer knows them
    if not dims:
        return eff
    m, n, k = dims
    for d in (n, k):
        if d % hw.mxu_dim != 0:
            eff *= max(0.35, (d % hw.mxu_dim) / hw.mxu_dim if d < hw.mxu_dim
                       else 1.0 - 0.5 * (hw.mxu_dim - d % hw.mxu_dim) / hw.mxu_dim)
    if m % hw.sub_dim != 0 and m < hw.sub_dim:
        eff *= max(0.2, m / hw.sub_dim)
    # skinny matmuls can't fill the systolic pipeline
    if min(m, n, k) < hw.mxu_dim // 4:
        eff *= 0.7
    return max(eff, 0.05)


_MXU_KINDS = ("matmul", "attention", "conv", "fused")


class AnalyticalEngine:
    name = "analytical"
    priority = 10

    def __init__(self, hw: HardwareSpec, *, algorithm: str = "ring"):
        self.hw = hw
        self.algorithm = algorithm
        # eff is a pure function of (mm_dims, hw); sweeps re-derive it for
        # the same few dozen dim tuples thousands of times
        self._effs: dict = {}

    def supports(self, node: OpNode) -> bool:
        return True  # the universal fallback

    def _mxu_eff(self, node: OpNode) -> float:
        dims = node.attrs.get("mm_dims")
        key = tuple(dims) if dims else None
        e = self._effs.get(key)
        if e is None:
            e = self._effs[key] = mxu_efficiency(node, self.hw)
        return e

    def _comm_us(self, node: OpNode) -> float:
        group = GroupSpec(
            intra_size=node.comm_size if node.comm_group != "pod" else 1,
            inter_size=node.comm_size if node.comm_group == "pod" else 1,
        )
        return hierarchical_collective_time_us(
            node.kind, node.comm_bytes, group, self.hw, algorithm=self.algorithm)

    def _roofline_inputs(self, node: OpNode) -> tuple[float, float, float]:
        """(flops, total_bytes, peak*eff) — the roofline columns for one
        compute node, shared verbatim by the scalar and batch paths."""
        hw = self.hw
        peak = hw.flops_for(_DTYPE_KEY.get(node.dtype, "bf16"))
        eff = self._mxu_eff(node) if node.kind in _MXU_KINDS else 1.0
        total_bytes = node.total_bytes
        if node.kind == "scatter" and not hw.scatter_inplace:
            # non-aliasing backend copies the whole buffer on functional update
            total_bytes += 2.0 * node.attrs.get("operand_bytes", 0.0)
        return node.flops, total_bytes, peak * eff

    def latency_us(self, node: OpNode) -> float | None:
        if node.is_comm:
            return self._comm_us(node)
        flops, total_bytes, denom = self._roofline_inputs(node)
        t_compute = flops / denom if flops else 0.0
        t_memory = total_bytes / (self.hw.hbm_bw * self.hw.mem_eff) \
            if total_bytes else 0.0
        t = max(t_compute, t_memory)
        # fixed per-op dispatch overhead (XLA fusion boundary cost)
        return t * 1e6 + 0.3

    def price_batch(self, nodes) -> list:
        """Vectorized roofline over a node batch: the FLOPs/bytes/peak*eff
        columns go through numpy float64 element-wise ops — the same IEEE
        operations in the same per-element order as :meth:`latency_us`, so
        results are bit-identical to the scalar path (asserted in
        tests/test_sweep_parallel.py).  Comm nodes keep the per-node
        hierarchical-collective model (already memoized)."""
        out: list = [0.0] * len(nodes)
        idx: list[int] = []
        flops: list[float] = []
        bts: list[float] = []
        denom: list[float] = []
        for i, node in enumerate(nodes):
            if node.is_comm:
                out[i] = self._comm_us(node)
                continue
            f, tb, d = self._roofline_inputs(node)
            idx.append(i)
            flops.append(f)
            bts.append(tb)
            denom.append(d)
        if idx:
            f = np.asarray(flops, dtype=np.float64)
            t_c = f / np.asarray(denom, dtype=np.float64)   # 0/x == 0.0 exactly
            t_m = np.asarray(bts, dtype=np.float64) / (self.hw.hbm_bw * self.hw.mem_eff)
            t = np.maximum(t_c, t_m) * 1e6 + 0.3
            for j, i in enumerate(idx):
                out[i] = float(t[j])
        return out
