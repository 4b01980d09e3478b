"""RMSNorm, optionally of ``x + residual`` with the sum returned too, and its
backward: wrappers, plain versions, launch plan and launch counts.

Counterpart of ``repro/kernels/rmsnorm.py``.  The kernels are CUDA C++
(``csrc/rmsnorm.cu``): one block a row, the row held in registers as 16-byte
vectors, sized by :func:`launch_plan`; the backward (:func:`bwd_launch_plan`:
smaller blocks, four an SM, where a row fits them) walks the rows with one
barrier a row and sums the blocks' fp32 partial ``dw`` rows in a second
kernel spread over the card.  For a CUDA tensor each wrapper launches its kernel
or raises; only a tensor on the CPU takes the plain version.  The autograd
glue that pairs forward and backward is ``ops.rmsnorm`` / ``ops.add_rmsnorm``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

MAX_D = 16384          # every dtype and variant holds a row this long in registers
BWD_THREADS, BWD_CHUNKS = 128, 3   # the backward's small blocks (kBwdThreads, kBwdChunks)
BWD_PARTS_SMALL = 528  # most blocks of the backward in small blocks (four an SM of an H100)
BWD_PARTS = 256        # most blocks of the backward in the forward's plan (two an SM)
DW_COLS = 16           # columns of dw a block of the backward's sum (DW_COLS in the source)
MAX_THREADS = 512      # RMS_MAX_THREADS in the source
VECTOR_CHUNKS = (1, 2, 3, 4, 6, 8)        # chunks a thread the source is built for (kVecChunks)
SCALAR_CHUNKS = (1, 2, 4, 8, 16, 32)      # and for its scalar variant (kScalarChunks)


def launch_plan(D: int, dtype: torch.dtype, *, aligned: bool = True) -> tuple[int, int, int]:
    """(threads a block, chunks a thread, elements a load) of the kernel for
    rows of ``D`` elements of ``dtype``, as ``rms_plan`` in the source computes
    it.  A load is one 16-byte vector (8 bf16, 4 fp32) where D is a multiple
    of it and every base is 16-byte ``aligned``, else one element.  The plan
    takes the fewest chunks whose block, in whole warps, stays within
    ``MAX_THREADS``."""
    key = (D, dtype, aligned)
    plan = _plans.get(key)
    if plan is None:
        vec = 16 // dtype.itemsize
        if not aligned or D % vec:
            vec = 1
        n = D // vec
        for c in VECTOR_CHUNKS if vec > 1 else SCALAR_CHUNKS:
            warps = -(-(-(-n // c)) // 32)        # ceil(ceil(n / c) / 32)
            if warps * 32 <= MAX_THREADS:
                plan = _plans[key] = (warps * 32, c, vec)
                break
        else:
            raise ValueError(f"rmsnorm: D={D} is past what the kernel holds in registers")
    return plan


_plans: dict[tuple, tuple[int, int, int]] = {}   # (D, dtype, aligned) -> launch_plan


def bwd_launch_plan(D: int, dtype: torch.dtype, rows: int, *,
                    aligned: bool = True) -> tuple[int, int, int, int, int]:
    """(threads, chunks, vector, parts, dw blocks) of the backward for
    ``rows`` rows of ``D`` (``rmsnorm_bwd_plan`` in the source): blocks of at
    most :data:`BWD_THREADS` threads with the fewest chunks up to
    :data:`BWD_CHUNKS` where the row fits them, at most
    :data:`BWD_PARTS_SMALL` of them, else the forward's plan and at most
    :data:`BWD_PARTS` blocks; ``parts`` blocks walk the rows (each writes one
    fp32 row of partial dw; at least 1), and the blocks of the dw sum, one a
    strip of :data:`DW_COLS` columns."""
    vec = 16 // dtype.itemsize
    if not aligned or D % vec:
        vec = 1
    n = D // vec
    for c in (c for c in (VECTOR_CHUNKS if vec > 1 else SCALAR_CHUNKS) if c <= BWD_CHUNKS):
        threads = -(-(-(-n // c)) // 32) * 32           # ceil(n / c) in whole warps
        if threads <= BWD_THREADS:
            return threads, c, vec, max(1, min(rows, BWD_PARTS_SMALL)), -(-D // DW_COLS)
    return (*launch_plan(D, dtype, aligned=aligned), max(1, min(rows, BWD_PARTS)),
            -(-D // DW_COLS))


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


def add_rmsnorm_plain(x: torch.Tensor, residual: torch.Tensor, w: torch.Tensor, *,
                      eps: float = 1e-6, offset: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """``(s, norm(s))`` with ``s = x + residual`` rounded to ``x.dtype``."""
    s = x + residual
    return s, rmsnorm_plain(s, w, eps=eps, offset=offset)


def rmsnorm_bwd_plain(x: torch.Tensor, w: torch.Tensor, dy: torch.Tensor, *,
                      eps: float = 1e-6, offset: bool = False,
                      ds: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """The backward kernel's arithmetic in plain torch, step by step: ``(dx,
    dw)`` for ``y = rmsnorm(x, w)`` and the gradient ``dy`` of y.  ``x`` is
    what was normalised (the rounded sum where there was a residual); ``ds``,
    the gradient of add_rmsnorm's written sum, is added to ``dx``.  fp32
    throughout; dx in ``x.dtype``, dw in ``w.dtype``."""
    xf, g = x.float(), dy.float()
    rs = 1.0 / torch.sqrt(xf.square().mean(dim=-1, keepdim=True) + eps)   # rstd
    xh = xf * rs                                                          # x^
    scale = (1.0 + w.float()) if offset else w.float()                    # w'
    gw = g * scale
    dx = rs * (gw - xh * (gw * xh).mean(dim=-1, keepdim=True))
    if ds is not None:
        dx = dx + ds.float()
    dw = (g * xh).reshape(-1, x.shape[-1]).sum(dim=0)
    return dx.to(x.dtype), dw.to(w.dtype)


_fns: dict[str, object] = {}   # the library's C functions, argtypes set


def _fn(name: str):
    fn = _fns.get(name)
    if fn is None:
        lib = _build.load("rmsnorm")
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.rmsnorm_launch.argtypes = [vp] * 5 + [ci, ci, ctypes.c_float] + [ci] * 6 + [vp]
        lib.rmsnorm_launch.restype = ci
        lib.rmsnorm_plan.argtypes = [ci, ci, ci, ctypes.POINTER(ci)]
        lib.rmsnorm_plan.restype = ci
        lib.rmsnorm_bwd_launch.argtypes = [vp] * 7 + [ci, ci, ctypes.c_float] + [ci] * 7 + [vp]
        lib.rmsnorm_bwd_launch.restype = ci
        lib.rmsnorm_bwd_plan.argtypes = [ci, ci, ci, ci, ctypes.POINTER(ci)]
        lib.rmsnorm_bwd_plan.restype = ci
        _fns.update(rmsnorm_launch=lib.rmsnorm_launch, rmsnorm_plan=lib.rmsnorm_plan,
                    rmsnorm_bwd_launch=lib.rmsnorm_bwd_launch,
                    rmsnorm_bwd_plan=lib.rmsnorm_bwd_plan)
        fn = _fns[name]
    return fn


def kernel_plan(D: int, dtype: torch.dtype, *, aligned: bool = True) -> tuple[int, int, int]:
    """:func:`launch_plan` as the compiled kernel reports it (needs the library)."""
    out = (ctypes.c_int * 3)()
    _build.check(_fn("rmsnorm_plan")(D, _build.DTYPE_CODES[dtype], int(aligned), out),
                 "rmsnorm_plan")
    return out[0], out[1], out[2]


def kernel_bwd_plan(D: int, dtype: torch.dtype, rows: int, *,
                    aligned: bool = True) -> tuple[int, int, int, int, int]:
    """:func:`bwd_launch_plan` as the compiled kernel reports it (needs the library)."""
    out = (ctypes.c_int * 5)()
    _build.check(_fn("rmsnorm_bwd_plan")(D, _build.DTYPE_CODES[dtype], int(aligned), rows, out),
                 "rmsnorm_bwd_plan")
    return tuple(out)


def _launch(x, w, residual, *, eps, offset, with_sum, plan=None):
    """Checks the CUDA operands and launches the kernel once; returns
    ``(sum or None, norm)``.  ``plan`` other than :func:`launch_plan`'s is for
    timing alternatives on the card."""
    D = x.shape[-1]
    if w.shape != (D,) or w.device != x.device:
        raise ValueError(f"rmsnorm: w must be ({D},) on {x.device}, got {tuple(w.shape)} on {w.device}")
    if D > MAX_D:
        raise ValueError(f"rmsnorm: D={D} exceeds the kernel's limit of {MAX_D}")
    if not x.is_contiguous() or not w.is_contiguous():
        raise ValueError("rmsnorm: x and w must be contiguous")
    aligned = x.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0
    res_ptr = None
    if residual is not None:
        if (residual.shape != x.shape or residual.dtype != x.dtype
                or residual.device != x.device or not residual.is_contiguous()):
            raise ValueError("rmsnorm: residual must match x in shape, dtype, device "
                             "and be contiguous")
        res_ptr = residual.data_ptr()
        aligned = aligned and res_ptr % 16 == 0
    x_code = _build.DTYPE_CODES[x.dtype]
    w_code = _build.dtype_code(w, "rmsnorm w")
    out = torch.empty_like(x)
    s = torch.empty_like(x) if with_sum else None
    rows = x.numel() // D if D else 0
    if rows == 0:
        return s, out
    threads, chunks, vector = plan or launch_plan(D, x.dtype, aligned=aligned)
    _build.launch(_fn("rmsnorm_launch"), x.device, "rmsnorm", x.data_ptr(), res_ptr,
                  w.data_ptr(), out.data_ptr(), None if s is None else s.data_ptr(), rows, D,
                  eps, offset, x_code, w_code, threads, chunks, vector)
    rmsnorm.launches += 1
    return s, out


def _device(x: torch.Tensor, what: str) -> str:
    _build.dtype_code(x, f"{what} x")
    if x.device.type not in ("cpu", "cuda"):
        raise RuntimeError(f"{what}: no kernel for device {x.device}")
    return x.device.type


def rmsnorm(x: torch.Tensor, w: torch.Tensor, *, eps: float = 1e-6, offset: bool = False,
            residual: torch.Tensor | None = None) -> torch.Tensor:
    """x: (..., D); w: (D,).  With ``residual`` normalises ``x + residual``."""
    if _device(x, "rmsnorm") == "cpu":
        _build.dtype_code(w, "rmsnorm w")
        return rmsnorm_plain(x, w, eps=eps, offset=offset, residual=residual)
    return _launch(x, w, residual, eps=float(eps), offset=int(bool(offset)), with_sum=False)[1]


def add_rmsnorm(x: torch.Tensor, residual: torch.Tensor, w: torch.Tensor, *,
                eps: float = 1e-6, offset: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """``(s, norm(s))`` with ``s = x + residual`` rounded to ``x.dtype``: the
    block's residual add and the next norm in one launch.  x, residual:
    (..., D); w: (D,)."""
    if _device(x, "add_rmsnorm") == "cpu":
        _build.dtype_code(w, "add_rmsnorm w")
        return add_rmsnorm_plain(x, residual, w, eps=eps, offset=offset)
    return _launch(x, w, residual, eps=float(eps), offset=int(bool(offset)), with_sum=True)


rmsnorm.launches = 0   # kernel launches made by this module's wrappers


def rmsnorm_bwd(x: torch.Tensor, w: torch.Tensor, dy: torch.Tensor, *, eps: float = 1e-6,
                offset: bool = False, ds: torch.Tensor | None = None,
                parts: int | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """``(dx, dw)`` of the norm (see :func:`rmsnorm_bwd_plain`).  x, dy, ds:
    (..., D) contiguous of one dtype; w: (D,).  ``parts`` other than
    :func:`bwd_launch_plan`'s is for timing alternatives on the card."""
    if _device(x, "rmsnorm_bwd") == "cpu":
        _build.dtype_code(w, "rmsnorm_bwd w")
        return rmsnorm_bwd_plain(x, w, dy, eps=eps, offset=offset, ds=ds)
    D = x.shape[-1]
    if w.shape != (D,) or w.device != x.device:
        raise ValueError(f"rmsnorm_bwd: w must be ({D},) on {x.device}, got {tuple(w.shape)}")
    if D > MAX_D:
        raise ValueError(f"rmsnorm_bwd: D={D} exceeds the kernel's limit of {MAX_D}")
    for name, t in (("dy", dy), ("ds", ds)):
        if t is not None and (t.shape != x.shape or t.dtype != x.dtype or t.device != x.device):
            raise ValueError(f"rmsnorm_bwd: {name} must match x in shape, dtype and device")
    tensors = [t for t in (x, w, dy, ds) if t is not None]
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("rmsnorm_bwd: x, w, dy and ds must be contiguous")
    aligned = all(t.data_ptr() % 16 == 0 for t in tensors)
    x_code = _build.DTYPE_CODES[x.dtype]
    w_code = _build.dtype_code(w, "rmsnorm_bwd w")
    dx, dw = torch.empty_like(x), torch.empty_like(w)
    rows = x.numel() // D if D else 0
    if rows == 0:
        return dx, dw.zero_()
    threads, chunks, vector, planned, _ = bwd_launch_plan(D, x.dtype, rows, aligned=aligned)
    parts = planned if parts is None else parts
    part = torch.empty((parts, D), dtype=torch.float32, device=x.device)
    _build.launch(_fn("rmsnorm_bwd_launch"), x.device, "rmsnorm_bwd", x.data_ptr(), w.data_ptr(),
                  dy.data_ptr(), None if ds is None else ds.data_ptr(), dx.data_ptr(),
                  dw.data_ptr(), part.data_ptr(), rows, D, float(eps), int(bool(offset)), x_code,
                  w_code, threads, chunks, vector, parts)
    rmsnorm_bwd.launches += 1
    return dx, dw


rmsnorm_bwd.launches = 0   # backward launches (a row kernel and its dw sum each)
