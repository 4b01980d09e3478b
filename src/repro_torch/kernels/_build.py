"""Builds and loads the CUDA kernels of ``csrc/``.

Each ``csrc/<name>.cu`` is compiled at first use by ``nvcc`` for ``sm_90a``
into its own shared library with a plain C interface and loaded with
``ctypes``; the sources include no PyTorch header, so a build takes seconds.
Libraries go to ``build/repro_torch_kernels/`` at the repository root (or to
``$REPRO_TORCH_BUILD_DIR``), named by a hash of the source, of every header
and source under ``csrc/`` and of the flags, so an edit anywhere there
rebuilds and an unchanged tree is reused.

Nothing here catches a failure and carries on: a missing compiler, a compile
error or a missing symbol raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("rmsnorm", "flash_attention", "flash_attention_bwd", "decode_attention", "adamw",
           "adafactor")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_libs: dict[str, ctypes.CDLL] = {}
build_seconds = 0.0   # wall time spent in nvcc by this process


def build_dir() -> Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    # <root>/src/repro_torch/kernels/_build.py -> <root>/build/repro_torch_kernels
    return Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"


def find_nvcc() -> str:
    for cand in (os.environ.get("NVCC"),
                 shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (looked at $NVCC, PATH and $CUDA_HOME/bin): "
                       "the CUDA kernels of repro_torch cannot be built")


def source_hash(name: str) -> str:
    """Hash of ``csrc/<name>.cu``, of every ``*.cuh`` and ``*.cu`` under
    ``csrc/`` (whatever a source may include) and of the flags."""
    h = hashlib.sha256()
    h.update(name.encode())
    for f in sorted([*CSRC.rglob("*.cuh"), *CSRC.rglob("*.cu")]):
        h.update(f.relative_to(CSRC).as_posix().encode())
        h.update(f.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _target(name: str) -> tuple[Path, Path]:
    src = CSRC / f"{name}.cu"
    return src, build_dir() / f"lib{name}_{source_hash(name)}.so"


def _start(name: str, extra_flags: tuple[str, ...] = ()):
    """Start nvcc for one source unless its library exists; returns
    (process or None, temporary path, final path)."""
    src, out = _target(name)
    if out.exists():
        return None, None, out
    nvcc = find_nvcc()
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp.so")
    cmd = [nvcc, *NVCC_FLAGS, *extra_flags, "-o", str(tmp), str(src)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, proc, tmp: Path, out: Path) -> str:
    if proc is None:
        return ""
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {name}.cu (exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)   # atomic: a concurrent build sees a whole file or none
    return log


def build_all(verbose: bool = False) -> dict[str, str]:
    """Compile every source, one nvcc each, all started together.  Returns the
    compiler's output per source (register and shared-memory use with
    ``verbose``)."""
    global build_seconds
    t0 = time.perf_counter()
    extra = ("-Xptxas", "-v") if verbose else ()
    started = [(n, *_start(n, extra)) for n in SOURCES]
    logs = {n: _finish(n, p, tmp, out) for n, p, tmp, out in started}
    build_seconds += time.perf_counter() - t0
    return logs


def load(name: str) -> ctypes.CDLL:
    """The shared library of ``csrc/<name>.cu``, built if need be."""
    global build_seconds
    lib = _libs.get(name)
    if lib is None:
        t0 = time.perf_counter()
        proc, tmp, out = _start(name)
        _finish(name, proc, tmp, out)
        build_seconds += time.perf_counter() - t0
        lib = _libs[name] = ctypes.CDLL(str(out))
    return lib


def check(err: int, what: str) -> None:
    """Raise if a launch function returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error code {err} "
                           "(cudaGetLastError)")


def launch(fn, device: torch.device, what: str, *args) -> None:
    """Call the C launch function ``fn(*args, stream)`` on PyTorch's current
    stream of ``device`` and raise if it reports an error.  Nothing
    synchronises.  The stream is read as a raw handle (what
    ``torch.cuda.current_stream(device).cuda_stream`` gives, without
    building a ``Stream`` object each call)."""
    index = device.index
    if index == torch.cuda.current_device():
        err = fn(*args, torch._C._cuda_getCurrentRawStream(index))
    else:
        with torch.cuda.device(device):
            err = fn(*args, torch._C._cuda_getCurrentRawStream(index))
    check(err, what)


DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def dtype_code(t, what: str) -> int:
    code = DTYPE_CODES.get(t.dtype)
    if code is None:
        raise TypeError(f"{what}: dtype {t.dtype} is not supported by the kernel "
                        "(float32 and bfloat16 are)")
    return code
