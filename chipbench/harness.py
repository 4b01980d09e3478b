"""What every run of the benchmark shares: where the checkout and its caches
are, the manifest and the files it names, a configuration's family and
reference, the process's start, the look for JAX, and the result
line.

Everything a cell needs is found by name: ``BENCHMARK.json`` names the
configuration (``configs/<name>.json``) and the traffic
(``traffic/<name>.json``) of each cell, the cell's own file
(``workloads/<cell>.json``) names its mode (``modes/<mode>.py``), a
configuration names its family (``families/<family>.py``) and its reference
(``configs/<reference>.py``), and each per-layer metric is read by
``metrics/<metric>.py``.
"""
from __future__ import annotations

import importlib.util
import json
import os
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
MANIFEST = ROOT / "BENCHMARK.json"

# Fixed cache directories inside the checkout: only the first run of a cell
# in a checkout builds, every later one loads.
CACHE = ROOT / "build" / "chipbench"
CACHE_ENV = {
    "REPRO_TORCH_BUILD_DIR": CACHE / "repro_torch_kernels",
    "TORCH_EXTENSIONS_DIR": CACHE / "torch_extensions",
    "TRITON_CACHE_DIR": CACHE / "triton",
    "CUDA_CACHE_PATH": CACHE / "cuda_cache",
}

# Top-level module names that no run may have loaded: the JAX package of this
# repository (``repro``) and JAX itself.  Compared whole: ``repro_torch`` is
# the port, not ``repro``.
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "repro")


def set_cache_env() -> None:
    """Point every build and kernel cache at its fixed directory in the
    checkout; called before the port or torch is imported."""
    for key, path in CACHE_ENV.items():
        os.environ[key] = str(path)
    os.environ["USE_FLAX"] = "0"
    # one process with few threads: the host's side of the run does not
    # compete with itself for the cores it shares
    for key in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[key] = "1"


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def manifest() -> dict:
    return load_json(MANIFEST)


def cell_entry(man: dict, name: str) -> dict:
    for w in man["workloads"]:
        if w["name"] == name:
            return w
    raise SystemExit(f"chipbench: no workload named {name!r} in BENCHMARK.json")


def config_file(name: str) -> dict:
    return load_json(HERE / "configs" / f"{name}.json")


def traffic_file(name: str) -> dict:
    return load_json(HERE / "traffic" / f"{name}.json")


def cell_file(name: str) -> dict:
    return load_json(HERE / "workloads" / f"{name}.json")


def load_module(path: Path, name: str):
    """A module of the benchmark by its file (metric files have dots in their
    names, so they are loaded by path)."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def mode_module(mode: str):
    return load_module(HERE / "modes" / f"{mode}.py", f"chipbench_mode_{mode}")


def metric_module(name: str):
    return load_module(HERE / "metrics" / f"{name}.py", "chipbench_metric_" + name.replace(".", "_"))


def end_to_end_for(man: dict, cell: str) -> list[dict]:
    """The end-to-end metrics this cell reports: those that list it, and those
    that list no cells (reported everywhere)."""
    return [m for m in man["end_to_end"] if "workloads" not in m or cell in m["workloads"]]


def per_layer_for(man: dict, cell: str) -> list[dict]:
    """The per-layer metrics read in this cell's traced run: those that list
    it, and those without a list whose end-to-end metric the cell reports."""
    e2e = {m["name"] for m in end_to_end_for(man, cell)}
    return [m for m in man["per_layer"]
            if (cell in m["workloads"] if "workloads" in m else m["moves"] in e2e)]


# --------------------------------------------------------------------------
# A configuration's family and its reference, by name
# --------------------------------------------------------------------------

_FAMILIES: dict = {}


def family(cfgj: dict):
    """The module of the configuration's family (``families/<family>.py``):
    its weights' layout, the port's config, a step's work."""
    name = cfgj["family"]
    if name not in _FAMILIES:
        _FAMILIES[name] = load_module(HERE / "families" / f"{name}.py", f"chipbench_family_{name}")
    return _FAMILIES[name]


def port_config(cfgj: dict):
    """The port's ``ModelConfig`` for a configuration file."""
    return family(cfgj).port_config(cfgj)


def reference(cfgj: dict, precision: str = "fp32"):
    """The plain reference of the configuration (``configs/<reference>.py``'s
    ``Reference``), float32 products in float32."""
    mod = load_module(HERE / "configs" / f"{cfgj['reference']}.py",
                      f"chipbench_reference_{cfgj['reference']}")
    mod.precise()
    return mod.Reference(cfgj, precision)


# --------------------------------------------------------------------------
# Time, statistics
# --------------------------------------------------------------------------

def process_age_s() -> float:
    """Seconds since this process started (Linux's /proc), so that set-up
    counts the interpreter's start too; 0 where that cannot be read."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = float(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(0.0, uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


class Clock:
    """The process's set-up clock: ``setup_s()`` is the time from the
    process's start to now."""

    def __init__(self):
        self.t0 = time.perf_counter() - process_age_s()

    def since_start(self) -> float:
        return time.perf_counter() - self.t0


def percentile(values: list[float], q: float) -> float:
    """The q-th percentile (0 < q < 100) by linear interpolation between
    order statistics (numpy's default), over every value given."""
    xs = sorted(values)
    if not xs:
        raise ValueError("percentile of no values")
    pos = (len(xs) - 1) * q / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


# --------------------------------------------------------------------------
# The look for JAX, the device, the result line
# --------------------------------------------------------------------------

def forbidden_loaded(names=None) -> list[str]:
    """The forbidden top-level names among ``names`` (default: the modules
    this process has loaded)."""
    tops = {name.split(".", 1)[0] for name in (list(sys.modules) if names is None else names)}
    return sorted(tops.intersection(FORBIDDEN_MODULES))


def device_info(torch, device, chips: int) -> dict:
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": chips,
            "memory_peak_bytes": int(max(torch.cuda.max_memory_allocated(i)
                                         for i in range(chips)))}


def card_power() -> str:
    """The card's name and power limit, as nvidia-smi reads them ("" where it
    cannot be run)."""
    import subprocess
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20)
        return out.stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return ""


def result_line(*, correct: bool, attempted: int, failed: int, metrics: dict, device: dict,
                checks: dict, breakdown: dict | None = None, setup: dict | None = None) -> str:
    """The result's one JSON line; ``checks`` (each number compared, beside
    its limit) is its last key."""
    out = {"correct": bool(correct), "attempted": int(attempted), "failed": int(failed),
           "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    if setup is not None:
        out["setup"] = setup
    out["checks"] = checks
    return json.dumps(out)


def checks_lines(checks: dict) -> list[str]:
    return [f"check {name}: {c['value']!r} limit {c['limit']!r} "
            f"{'ok' if c['value'] <= c['limit'] else 'FAILED'}" for name, c in checks.items()]


class Ctx:
    """One run of one cell: its files, its arguments, the device, and where
    the mode reports the device's reading (``read_device``, called by the
    mode once the window has closed and before the reference runs)."""

    def __init__(self, *, name: str, man: dict, seed: int, seconds: float, trace: bool,
                 torch, device, clock: Clock, config: dict | None = None,
                 traffic: dict | None = None, cell: dict | None = None):
        """``config``, ``traffic``, ``cell``: the files' contents in place
        of those the manifest names (the CPU tests' small sizes)."""
        self.name = name
        self.entry = cell_entry(man, name)
        self.cell = cell if cell is not None else cell_file(name)
        self.cfgj = config if config is not None else config_file(self.entry["config"])
        self.traffic = traffic if traffic is not None else traffic_file(self.entry["traffic"])
        self.seed, self.seconds, self.trace = int(seed), float(seconds), bool(trace)
        self.torch, self.device, self.clock = torch, device, clock
        self.scratch = CACHE / "scratch"
        self.device_record: dict | None = None
        self.marks: dict[str, float] = {}

    def mark(self, name: str) -> None:
        """Seconds from the process's start to the end of a part of set-up."""
        self.marks[name] = self.clock.since_start()

    def read_device(self) -> None:
        if self.device.type == "cuda":
            self.device_record = device_info(self.torch, self.device, self.entry["chips"])
        else:
            self.device_record = {"platform": "cpu", "kind": "cpu", "count": 1,
                                  "memory_peak_bytes": 0}
