"""Charon simulator core — the paper's primary contribution.

Compiler-style simulation pipeline: torch model ingestion (tracer/stubs/
model_ingest, ``make_fx`` over FakeTensors) -> parallelism & optimization
passes -> multi-engine backend (profiling on the card / prediction /
analytical, fused fallback) -> scheduler + overlap models -> analyses (time,
MFU, memory).
"""
from repro_torch.core.ir import Graph, OpNode
from repro_torch.core.passes.base import ParallelConfig
from repro_torch.core.simulator import Report, Simulator

__all__ = ["Graph", "OpNode", "Report", "Simulator", "ParallelConfig"]
