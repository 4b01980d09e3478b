"""Flash-attention forward: wrapper, plain version, launch count.

Counterpart of ``repro/kernels/flash_attention.py``.  The kernels are CUDA
C++ (``csrc/flash_attention.cu``): one block for each (batch, q head, q tile)
with the KV loop inside; for bf16 a warp-specialised block of TMA loads and
``wgmma`` products (:func:`tile_plan`), for float32 fp32 FMAs.  They take
strides, so the model's ``(B,S,H,D)`` tensors are passed as permuted views
and never copied.  For a CUDA tensor the wrapper launches a kernel or raises;
only a tensor on the CPU takes the plain version.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build

NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)
SUPPORTED_D = (64, 128, 256)
SMEM_LIMIT = 232_448     # shared memory one block may use on sm_90 (227 KB)
SM_SMEM = 233_472        # shared memory of an sm_90 SM (228 KB), 1 KB of it reserved a block


def tile_plan(D: int) -> dict[str, int]:
    """The bf16 kernel's tiles for head dim ``D`` (``TcPlan`` in the source):
    q rows a block (one consumer warpgroup), kv rows a tile, stages of the
    K/V ring, threads (a producer warpgroup beside the consumer), blocks an
    SM it is built for, and shared-memory bytes (Q, the K and V ring, 256 of
    barriers)."""
    if D not in SUPPORTED_D:
        raise ValueError(f"flash_attention: no bf16 plan for D={D}")
    bq = bk = 64
    stages = 3
    return {"q_rows": bq, "kv_rows": bk, "stages": stages, "threads": 256,
            "blocks_per_sm": 2 if D < 256 else 1,
            "smem_bytes": bq * D * 2 + 2 * stages * bk * D * 2 + 256}


def flash_attention_plain(q, k, v, *, causal: bool = True, window: int = 0,
                          scale: float | None = None) -> torch.Tensor:
    """The kernel's function in plain torch.  q: (B,H,Sq,D); k/v:
    (B,Hkv,Sk,D) -> (B,H,Sq,D).  Follows the kernel, not ``ref.py``: the
    running maximum is floored at -1e30, so a fully masked row gives 0."""
    B, H, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    G = H // Hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    qg = q.float().reshape(B, Hkv, G, Sq, D)
    s = torch.einsum("bkgsd,bktd->bkgst", qg, k.float()) * scale
    qp = torch.arange(Sq, device=q.device)[:, None]
    tp = torch.arange(Sk, device=q.device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= tp <= qp
    if window > 0:
        mask &= tp > qp - window
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True).clamp_min(-1e30)
    p = torch.exp(s - m)                       # a masked score gives exactly 0
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bkgst,bktd->bkgsd", p, v.float()) / l.clamp_min(1e-30)
    return o.reshape(B, H, Sq, D).to(q.dtype)


def _lib():
    lib = _build.load("flash_attention")
    if lib.flash_attention_launch.argtypes is None:
        vp, ci, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.flash_attention_launch.argtypes = (
            [vp, vp, vp, vp] + [ci] * 6 + [ll] * 12 + [ci, ci, ctypes.c_float, ci, vp])
        lib.flash_attention_launch.restype = ci
        lib.flash_attention_plan.argtypes = [ci, ctypes.POINTER(ctypes.c_int)]
        lib.flash_attention_plan.restype = ci
    return lib


def kernel_plan(D: int) -> dict[str, int]:
    """:func:`tile_plan` as the compiled kernel reports it (needs the library)."""
    out = (ctypes.c_int * 6)()
    if _lib().flash_attention_plan(D, out) != 0:
        raise ValueError(f"flash_attention: no bf16 plan for D={D}")
    return dict(zip(("q_rows", "kv_rows", "stages", "threads", "blocks_per_sm", "smem_bytes"),
                    out))


def check_operand(name: str, t: torch.Tensor) -> None:
    """TMA's rule: a 16-byte aligned base, stride 1 over D and every other
    stride a multiple of 16 bytes.  Raises rather than copies."""
    if t.stride(-1) != 1:
        raise ValueError(f"flash_attention: {name} must have stride 1 over D, got {t.stride()}")
    item = t.element_size()
    if any(s * item % 16 for s in t.stride()[:3]) or t.data_ptr() % 16:
        raise ValueError(f"flash_attention: {name} must be 16-byte aligned with strides that "
                         f"are multiples of 16 bytes, got strides {t.stride()} of "
                         f"{item}-byte elements")


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    scale: float | None = None, out: torch.Tensor | None = None) -> torch.Tensor:
    """q: (B,H,Sq,D); k/v: (B,Hkv,Sk,D) with H % Hkv == 0 -> (B,H,Sq,D).
    Any strides over the first three dims that are multiples of 16 bytes.
    ``out``, if given, is a ``(B,H,Sq,D)`` tensor (view) of ``q.dtype`` that
    receives the result."""
    B, H, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    if H % Hkv or k.shape != (B, Hkv, Sk, D) or v.shape != k.shape:
        raise ValueError(f"flash_attention: bad shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)}")
    code = _build.dtype_code(q, "flash_attention q")
    if q.device.type == "cpu":
        o = flash_attention_plain(q, k, v, causal=causal, window=window, scale=scale)
        if out is None:
            return o
        out.copy_(o)
        return out
    if q.device.type != "cuda":
        raise RuntimeError(f"flash_attention: no kernel for device {q.device}")
    if k.dtype != q.dtype or v.dtype != q.dtype or k.device != q.device or v.device != q.device:
        raise ValueError("flash_attention: q, k and v must share dtype and device")
    if D not in SUPPORTED_D:
        raise ValueError(f"flash_attention: head dim {D} not supported by the kernel "
                         f"(supported: {SUPPORTED_D})")
    if out is None:
        out = torch.empty((B, H, Sq, D), dtype=q.dtype, device=q.device)
    elif out.shape != q.shape or out.dtype != q.dtype or out.device != q.device:
        raise ValueError("flash_attention: out must match q in shape, dtype and device")
    for name, t in (("q", q), ("k", k), ("v", v), ("out", out)):
        check_operand(name, t)
    if B == 0 or Sq == 0:
        return out
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    _build.launch(_lib().flash_attention_launch, q.device, "flash_attention",
                  q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                  B, H, Hkv, Sq, Sk, D,
                  *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
                  int(bool(causal)), int(window), float(scale), code)
    flash_attention.launches += 1
    return out


flash_attention.launches = 0   # kernel launches made by this wrapper
