"""Profiling engine + profiling database (paper §3.3a).

Operators are synthesised from their IR description, run on the card, and
the measured latency is cached in a JSON database keyed by (hardware, kind,
dims, dtype).  The same database is the training set for the prediction
engine.

Which code runs an operator follows the port's own path: ``attention``
with ``sq > 1`` is the flash-attention kernel (K1), with ``sq == 1`` the
split-KV decode kernel (K2, every cache row valid), ``norm`` the rmsnorm
kernel (K3), ``matmul`` cuBLAS through ``torch.matmul``, and an elementwise,
reduce, copy or transpose node one PyTorch launch.  Attention is synthesised
grouped: the tracer records the group size ``G`` on the node, and
:func:`node_key` appends it to an attention key.

Timing on the card (:func:`_time_fn`): one CUDA graph holds launches of
the operator on several copies of its inputs in turn, so that they exceed
the L2 cache and every launch reads them from device memory (in a model step
each layer's weights arrive cold), and enough launches that the graph's own
replay cost is spread thin; CUDA events around replays of that graph give
the time a launch.  Unlike the reference's host-clock times, these are not
reduced by :func:`dispatch_overhead_us`: a replayed graph holds no host
dispatch, and the launch floor it does hold is paid by every kernel of a
real step.  A measurement that cannot run raises: only a kind or dims that
cannot be synthesised give None (and the analytical engine).
"""
from __future__ import annotations

import json
import math
import time
from pathlib import Path

import torch

from repro_torch.core.backend.hardware import HardwareSpec
from repro_torch.core.ir import OpNode
from repro_torch.kernels import ops
from repro_torch.kernels.decode_attention import SUPPORTED_D as K2_D, SUPPORTED_G
from repro_torch.kernels.flash_attention import SUPPORTED_D as K1_D
from repro_torch.kernels.rmsnorm import MAX_D

DB_PATH = Path(__file__).resolve().parents[4] / "results" / "profile_db_torch.json"

_DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32, "f16": torch.float16,
           "int8": torch.int8, "f8": torch.bfloat16}
_KERNEL_DTYPES = (torch.bfloat16, torch.float32)   # what K1-K3 are built for

MEASURE_HW = "h100_sxm"      # the hardware measure-on-miss runs on
_COLD_BYTES = 128 << 20      # input copies a graph rotates through (L2: 50 MB)
_MAX_COPIES = 64
_GRAPH_BYTES = 1 << 30       # inputs a graph's launches read, at most 256 launches
_MIN_LAUNCHES, _MAX_LAUNCHES = 8, 256
_REPLAYS = 5


def node_key(node: OpNode, hw_name: str) -> str:
    dims = node.attrs.get("mm_dims") or node.attrs.get("attn_dims") or node.out_shape
    key = f"{hw_name}|{node.kind}|{','.join(map(str, dims))}|{node.dtype}"
    if node.kind == "attention":
        # grouped-query attention: the same dims at another group size are
        # another kernel launch (the reference synthesises multi-head only)
        key += f"|G{int(node.attrs.get('G', 1))}"
    return key


class ProfileDB:
    def __init__(self, path: Path | str = DB_PATH):
        self.path = Path(path)
        self.data: dict[str, dict] = {}
        self.version = 0     # bumped on every put; price caches key on it
        if self.path.exists():
            try:
                self.data = json.loads(self.path.read_text())
            except Exception:
                self.data = {}

    def get(self, key: str):
        e = self.data.get(key)
        return e["us"] if e else None

    def put(self, key: str, us: float, meta: dict):
        self.version += 1
        self.data[key] = {"us": us, **meta}

    def save(self):
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self.path.write_text(json.dumps(self.data, indent=0))

    def entries(self):
        return self.data.items()


def _device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("profiling on a CUDA device was asked for and none is available")
    if dev.type not in ("cuda", "cpu"):
        raise RuntimeError(f"no profiling on device {dev}")
    return dev


def _time_cuda(fn, arg_sets: list) -> float:
    """µs a launch: CUDA events around replays of one CUDA graph holding
    launches of ``fn`` on the input sets in turn (8 to 256 launches, up to
    ``_GRAPH_BYTES`` of inputs); the least of ``_REPLAYS`` replays."""
    for a in arg_sets:                  # builds the kernel, allocates scratch
        fn(*a)
    torch.cuda.synchronize()
    per_launch = _nbytes(*(t for t in arg_sets[0] if isinstance(t, torch.Tensor)))
    launches = min(_MAX_LAUNCHES, max(_MIN_LAUNCHES, math.ceil(_GRAPH_BYTES / max(per_launch, 1.0))))
    rounds = math.ceil(launches / len(arg_sets))
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(rounds):
            for a in arg_sets:
                fn(*a)
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(_REPLAYS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) * 1e3 / (rounds * len(arg_sets)))
    del graph
    return float(min(times))


def _time_cpu(fn, arg_sets: list, min_time_s: float = 0.02, max_iters: int = 50) -> float:
    """µs a call on the host: the least over calls (wall clock)."""
    for a in arg_sets:
        fn(*a)
    times, total = [], 0.0
    while total < min_time_s and len(times) < max_iters:
        a = arg_sets[len(times) % len(arg_sets)]
        t0 = time.perf_counter()
        fn(*a)
        dt = time.perf_counter() - t0
        times.append(dt)
        total += dt
    return float(min(times) * 1e6)


_DISPATCH_US: dict[str, float] = {}


def dispatch_overhead_us(device="cuda") -> float:
    """Launch floor on ``device``: a one-element fill timed as every operator
    is (what a kernel that does nothing costs)."""
    dev = _device(device)
    if dev.type not in _DISPATCH_US:
        x = torch.zeros((1,), dtype=torch.float32, device=dev)
        run = _time_cuda if dev.type == "cuda" else _time_cpu
        _DISPATCH_US[dev.type] = run(lambda t: t.fill_(1.0), [(x,)])
    return _DISPATCH_US[dev.type]


def _time_fn(fn, arg_sets: list, device: torch.device) -> float:
    """Time a launch (µs): the device's time on the card, the host's on the
    CPU (where only the shapes handed to each kernel are being checked)."""
    return (_time_cuda if device.type == "cuda" else _time_cpu)(fn, arg_sets)


def _copies(nbytes: float, device: torch.device) -> int:
    if device.type != "cuda":
        return 1
    return int(min(_MAX_COPIES, max(1, math.ceil(_COLD_BYTES / max(nbytes, 1.0)))))


def _nbytes(*tensors) -> float:
    return float(sum(t.numel() * t.element_size() for t in tensors))


def synthesize_and_measure(node: OpNode, device="cuda") -> float | None:
    """Build the operator from its IR description and time it on ``device``
    (the card unless the caller asks for the CPU, where the kernel wrappers
    take their plain versions).  None only for a kind or dims that cannot be
    synthesised; a failing build, launch or measurement raises."""
    dev = _device(device)
    dt = _DTYPES.get(node.dtype, torch.bfloat16)
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(shape, dtype=dt):
        return torch.randn(shape, generator=gen, dtype=torch.float32, device=dev).to(dtype)

    def sets(make):
        """Copies of the inputs made by ``make`` (enough to exceed L2)."""
        first = make()
        n = _copies(_nbytes(*first), dev)
        return [first] + [make() for _ in range(n - 1)]

    k = node.kind
    if k == "matmul":
        dims = node.attrs.get("mm_dims")
        if not dims or not dt.is_floating_point:
            return None
        m, n, kk = (int(x) for x in dims)
        out = torch.empty((m, n), dtype=dt, device=dev)
        args = sets(lambda: (randn((m, kk)), randn((kk, n))))
        return _time_fn(lambda a, b: torch.matmul(a, b, out=out), args, dev)
    if k == "attention":
        dims = node.attrs.get("attn_dims")
        if not dims or dt not in _KERNEL_DTYPES:
            return None
        bsz, h, sq, skv, d = (int(x) for x in dims)
        g = int(node.attrs.get("G", 1))
        if h % g:
            return None
        hkv = h // g
        if sq > 1:
            if d not in K1_D:
                return None
            causal = bool(node.attrs.get("causal", True))
            window = int(node.attrs.get("window", 0))
            args = sets(lambda: (randn((bsz, sq, hkv, g, d)), randn((bsz, skv, hkv, d)),
                                 randn((bsz, skv, hkv, d))))
            return _time_fn(lambda q, kk_, v: ops.flash_attention_bshd(
                q, kk_, v, causal=causal, window=window), args, dev)
        if d not in K2_D or g not in SUPPORTED_G:
            return None
        valid = torch.full((bsz,), skv, dtype=torch.int32, device=dev)
        args = sets(lambda: (randn((bsz, 1, hkv, g, d)), randn((bsz, skv, hkv, d)),
                             randn((bsz, skv, hkv, d))))
        return _time_fn(lambda q, kk_, v: ops.decode_attention_bthd(q, kk_, v, valid),
                        args, dev)
    if k in ("norm", "softmax", "elementwise", "reduce", "copy", "transpose"):
        shape = tuple(int(x) for x in node.out_shape) or (1024,)
        if k == "norm":
            if dt not in _KERNEL_DTYPES or shape[-1] > MAX_D:
                return None
            w = torch.ones(shape[-1:], dtype=dt, device=dev)
            return _time_fn(lambda x: ops.rmsnorm(x, w), sets(lambda: (randn(shape),)), dev)
        if not dt.is_floating_point:
            return None
        args = sets(lambda: (randn(shape),))
        if k == "softmax":
            return _time_fn(lambda x: torch.softmax(x, dim=-1), args, dev)
        if k == "reduce":
            return _time_fn(lambda x: torch.sum(x, dtype=torch.float32), args, dev)
        if k == "transpose" and len(shape) >= 2:
            out = torch.empty((*shape[:-2], shape[-1], shape[-2]), dtype=dt, device=dev)
            return _time_fn(lambda x: out.copy_(x.transpose(-1, -2)), args, dev)
        out = torch.empty(shape, dtype=dt, device=dev)
        if k == "copy":
            return _time_fn(lambda x: out.copy_(x), args, dev)
        return _time_fn(lambda x: torch.mul(x, 1.5, out=out), args, dev)
    if k in ("embed", "gather"):
        v = int(node.attrs.get("vocab", 32768))
        d = int(node.out_shape[-1]) if node.out_shape else 512
        t = int(math.prod(node.out_shape[:-1])) if len(node.out_shape) > 1 else 1024
        if not dt.is_floating_point:
            return None
        out = torch.empty((t, d), dtype=dt, device=dev)
        idx = torch.randint(0, v, (t,), generator=gen, device=dev)
        args = sets(lambda: (randn((v, d)),))
        return _time_fn(lambda tbl: torch.index_select(tbl, 0, idx, out=out), args, dev)
    return None


class ProfilingEngine:
    """Highest-priority engine: exact measured latencies from the DB, with
    optional on-demand measurement on the card (``h100_sxm`` only)."""

    name = "profiling"
    priority = 30

    SUPPORTED = {"matmul", "attention", "norm", "softmax", "elementwise",
                 "reduce", "embed", "gather", "copy", "transpose"}

    def __init__(self, hw: HardwareSpec, db: ProfileDB | None = None,
                 *, measure_on_miss: bool = False):
        self.hw = hw
        self.db = db or ProfileDB()
        self.measure_on_miss = measure_on_miss and hw.name == MEASURE_HW
        if self.measure_on_miss and not torch.cuda.is_available():
            raise RuntimeError(
                f"measure_on_miss for {hw.name!r} measures on the card, and CUDA is "
                "not available here")
        self._self_puts = 0

    @property
    def state_version(self) -> int:
        """Changes when *external* DB mutation could alter an already-given
        answer (fused-engine price caches invalidate on it).  Own
        measure-on-miss puts are excluded: the value cached for that
        signature IS the measurement, so nothing previously answered
        changes."""
        return self.db.version - self._self_puts

    def supports(self, node: OpNode) -> bool:
        return node.kind in self.SUPPORTED

    def latency_us(self, node: OpNode) -> float | None:
        key = node_key(node, self.hw.name)
        us = self.db.get(key)
        if us is not None:
            return us
        if not self.measure_on_miss:
            return None
        us = synthesize_and_measure(node)
        if us is not None:
            self._self_puts += 1
            self.db.put(key, us, {"kind": node.kind,
                                  "dims": list(node.attrs.get("mm_dims")
                                               or node.attrs.get("attn_dims")
                                               or node.out_shape),
                                  "dtype": node.dtype,
                                  "flops": node.flops,
                                  "bytes": node.total_bytes})
        return us
