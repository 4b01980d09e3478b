"""Hardware specifications and interconnect topologies.

Constants follow public spec sheets; the assignment's TPU v5e numbers
(197 TFLOP/s bf16, 819 GB/s HBM, ~50 GB/s/link ICI) are the default target.
The simulator treats the fleet as hierarchical link domains: ICI torus links
inside a pod, DCN between pods — the paper's "hierarchical link-centric"
communication model with calibrated per-hop latency + effective bandwidth.
"""
from __future__ import annotations

from dataclasses import dataclass, field


@dataclass(frozen=True)
class LinkDomain:
    name: str                 # 'ici' | 'dcn' | 'nvlink' | 'ib' | 'host'
    bandwidth: float          # effective GB-per-second per direction per link
    latency_us: float         # per-hop handshake latency
    links_per_chip: int = 1
    topology: str = "ring"    # ring | switch | mesh2d


@dataclass(frozen=True)
class HardwareSpec:
    name: str
    peak_flops: dict[str, float]       # dtype -> FLOP/s
    hbm_bw: float                      # bytes/s
    hbm_bytes: float
    vmem_bytes: float                  # on-chip (VMEM / SMEM+L2)
    intra: LinkDomain                  # intra-pod / intra-node fabric
    inter: LinkDomain                  # cross-pod / cross-node fabric
    mxu_dim: int = 128                 # systolic array tile (alignment grain)
    sub_dim: int = 8
    # calibrated effective-utilization knobs (paper: "calibrated ... from profiling")
    matmul_eff: float = 0.85           # large aligned matmul efficiency
    mem_eff: float = 0.80              # HBM streaming efficiency
    dispatch_us: float = 0.3           # per-dispatch overhead (opt leaves etc.)
    scatter_inplace: bool = True       # XLA aliases in-place updates through
                                       # loop carries (TPU/GPU yes; CPU no)
    overlap_slowdown_compute: float = 1.12   # ratio-based overlap model defaults
    overlap_slowdown_comm: float = 1.25
    overlap_slowdown_comm_comm: float = 1.9

    def flops_for(self, dtype: str) -> float:
        return self.peak_flops.get(dtype, self.peak_flops.get("bf16", 1e12))


TPU_V5E = HardwareSpec(
    name="tpu_v5e",
    peak_flops={"bf16": 197e12, "f32": 98.5e12, "int8": 394e12, "f8": 394e12},
    hbm_bw=819e9,
    hbm_bytes=16e9,
    vmem_bytes=128e6,
    intra=LinkDomain("ici", 50e9, 1.0, links_per_chip=4, topology="mesh2d"),
    inter=LinkDomain("dcn", 25e9, 10.0, links_per_chip=1, topology="switch"),
)

TPU_V5P = HardwareSpec(
    name="tpu_v5p",
    peak_flops={"bf16": 459e12, "f32": 229e12, "int8": 918e12, "f8": 918e12},
    hbm_bw=2765e9,
    hbm_bytes=95e9,
    vmem_bytes=128e6,
    intra=LinkDomain("ici", 100e9, 1.0, links_per_chip=6, topology="mesh2d"),
    inter=LinkDomain("dcn", 25e9, 10.0, links_per_chip=1, topology="switch"),
)

A100_80G = HardwareSpec(
    name="a100_80g",
    peak_flops={"bf16": 312e12, "f32": 19.5e12, "int8": 624e12, "f8": 312e12},
    hbm_bw=2039e9,
    hbm_bytes=80e9,
    vmem_bytes=40e6 + 20e6,
    intra=LinkDomain("nvlink", 300e9, 0.7, links_per_chip=12, topology="switch"),
    inter=LinkDomain("ib", 25e9, 5.0, links_per_chip=1, topology="switch"),
    mxu_dim=16, sub_dim=8,
)

H100_SXM = HardwareSpec(
    name="h100_sxm",
    peak_flops={"bf16": 989e12, "f32": 67e12, "int8": 1979e12, "f8": 1979e12},
    hbm_bw=3350e9,
    hbm_bytes=80e9,
    vmem_bytes=50e6 + 25e6,
    intra=LinkDomain("nvlink", 450e9, 0.7, links_per_chip=18, topology="switch"),
    inter=LinkDomain("ib", 50e9, 5.0, links_per_chip=1, topology="switch"),
    mxu_dim=16, sub_dim=8,
)

XLA_CPU = HardwareSpec(
    # measured on this container (single-core XLA CPU): 107/135 GFLOP/s
    # bf16/f32 matmul, ~3.3-4.3 GB/s effective stream bandwidth.  Used as the
    # accuracy ground-truth target in benchmarks (the paper validates on real
    # GPUs; we validate on the hardware we actually have).
    name="xla_cpu",
    peak_flops={"bf16": 1.07e11, "f32": 1.35e11},
    hbm_bw=3.6e9,
    hbm_bytes=32e9,
    vmem_bytes=32e6,
    intra=LinkDomain("host", 1e10, 1.0),
    inter=LinkDomain("host", 1e10, 1.0),
    mxu_dim=16, sub_dim=4,
    matmul_eff=0.8, mem_eff=1.0,
    dispatch_us=25.0,
    scatter_inplace=False,
)

HARDWARE = {h.name: h for h in (TPU_V5E, TPU_V5P, A100_80G, H100_SXM, XLA_CPU)}


def get_hardware(name: str) -> HardwareSpec:
    return HARDWARE[name]
