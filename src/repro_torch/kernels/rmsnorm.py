"""RMSNorm (+ residual add inside the kernel): wrapper, plain version, launch count.

Counterpart of ``repro/kernels/rmsnorm.py``.  The kernel is CUDA C++
(``csrc/rmsnorm.cu``), one block a row.  For a CUDA tensor the wrapper
launches it or raises; only a tensor on the CPU takes the plain version.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

MAX_D = 12288   # the fp32 row must fit 48 KB of shared memory


def rmsnorm_plain(x: torch.Tensor, w: torch.Tensor, *, eps: float = 1e-6,
                  offset: bool = False, residual: torch.Tensor | None = None) -> torch.Tensor:
    """The kernel's arithmetic in plain torch: fp32 statistics, output in
    ``x.dtype``; with ``residual`` the sum is rounded to ``x.dtype`` first, as
    an array add rounds it, and only the norm of the sum is returned."""
    if residual is not None:
        x = x + residual
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    y = xf * (1.0 / torch.sqrt(var + eps))
    scale = (1.0 + w.float()) if offset else w.float()
    return (y * scale).to(x.dtype)


def _lib():
    lib = _build.load("rmsnorm")
    fn = lib.rmsnorm_launch
    if fn.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp, vp, vp, vp, ci, ci, ctypes.c_float, ci, ci, ci, vp]
        fn.restype = ci
    return fn


def rmsnorm(x: torch.Tensor, w: torch.Tensor, *, eps: float = 1e-6, offset: bool = False,
            residual: torch.Tensor | None = None) -> torch.Tensor:
    """x: (..., D); w: (D,).  With ``residual`` normalises ``x + residual``."""
    x_code = _build.dtype_code(x, "rmsnorm x")
    w_code = _build.dtype_code(w, "rmsnorm w")
    if x.device.type == "cpu":
        return rmsnorm_plain(x, w, eps=eps, offset=offset, residual=residual)
    if x.device.type != "cuda":
        raise RuntimeError(f"rmsnorm: no kernel for device {x.device}")
    D = x.shape[-1]
    if w.shape != (D,) or w.device != x.device:
        raise ValueError(f"rmsnorm: w must be ({D},) on {x.device}, got {tuple(w.shape)} on {w.device}")
    if D > MAX_D:
        raise ValueError(f"rmsnorm: D={D} exceeds the kernel's limit of {MAX_D}")
    if not x.is_contiguous() or not w.is_contiguous():
        raise ValueError("rmsnorm: x and w must be contiguous")
    res_ptr = None
    if residual is not None:
        if (residual.shape != x.shape or residual.dtype != x.dtype
                or residual.device != x.device or not residual.is_contiguous()):
            raise ValueError("rmsnorm: residual must match x in shape, dtype, device "
                             "and be contiguous")
        res_ptr = residual.data_ptr()
    out = torch.empty_like(x)
    rows = x.numel() // D if D else 0
    if rows == 0:
        return out
    _build.launch(_lib(), x.device, "rmsnorm", x.data_ptr(), res_ptr, w.data_ptr(),
                  out.data_ptr(), rows, D, float(eps), int(bool(offset)), x_code, w_code)
    rmsnorm.launches += 1
    return out


rmsnorm.launches = 0   # kernel launches made by this wrapper
