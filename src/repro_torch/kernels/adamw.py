"""AdamW update of one parameter tensor: wrapper, plain version, launch count.

Not the port of a TPU kernel: the reference's AdamW is array code that XLA
fuses into one pass over a leaf, and eager PyTorch would run it as some
twenty elementwise launches.  The kernel (``csrc/adamw.cu``) is that one
pass, with the reference's arithmetic in its order, so it equals
:func:`adamw_update_plain` bit for bit.  For a CUDA tensor the wrapper
launches it or raises; only a tensor on the CPU takes the plain version.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

BLOCKS_PER_SM = 8      # blocks of 256 threads the grid-stride loop is given, a SM
_SMS: dict[int, int] = {}


@torch.no_grad()
def adamw_update_plain(p, g, m, v, *, lr, c1, c2, b1: float, b2: float, eps: float,
                       weight_decay: float) -> None:
    """The update in plain torch, in place:
    ``m = b1 m + (1 - b1) g``, ``v = b2 v + (1 - b2) g^2``,
    ``u = (m / c1) / (sqrt(v / c2) + eps) + wd p``, ``p = p - lr u``, in
    fp32 with g and p widened and p rounded back to its dtype.  ``lr``,
    ``c1``, ``c2``: 0-d fp32 tensors."""
    g = g.to(torch.float32)
    m.mul_(b1).add_(g * (1 - b1))
    v.mul_(b2).add_(g.square().mul_(1 - b2))
    u = (m / c1).div_(torch.sqrt(v / c2).add_(eps))
    pf = p.to(torch.float32)
    u.add_(weight_decay * pf)
    p.copy_(pf - u.mul_(lr))


def _lib():
    lib = _build.load("adamw")
    if lib.adamw_launch.argtypes is None:
        vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.adamw_launch.argtypes = [vp] * 4 + [ctypes.c_longlong] + [vp] * 3 + [cf] * 6 \
            + [ci] * 4 + [vp]
        lib.adamw_launch.restype = ci
    return lib


def _blocks(device: torch.device, n: int) -> int:
    sms = _SMS.get(device.index)
    if sms is None:
        sms = _SMS[device.index] = torch.cuda.get_device_properties(device).multi_processor_count
    return max(1, min(sms * BLOCKS_PER_SM, -(-n // (256 * 4))))


@torch.no_grad()
def adamw_update(p, g, m, v, *, lr, c1, c2, b1: float, b2: float, eps: float,
                 weight_decay: float) -> None:
    """:func:`adamw_update_plain` in one launch for CUDA tensors.  p: fp32 or
    bf16; g: fp32 or bf16 of p's shape; m, v: fp32 of p's shape; all
    contiguous on one device; lr, c1, c2: 0-d fp32 tensors there."""
    if p.device.type == "cpu":
        return adamw_update_plain(p, g, m, v, lr=lr, c1=c1, c2=c2, b1=b1, b2=b2, eps=eps,
                                  weight_decay=weight_decay)
    if p.device.type != "cuda":
        raise RuntimeError(f"adamw_update: no kernel for device {p.device}")
    p_code = _build.dtype_code(p, "adamw_update p")
    g_code = _build.dtype_code(g, "adamw_update g")
    for name, t in (("g", g), ("m", m), ("v", v), ("lr", lr), ("c1", c1), ("c2", c2)):
        if t.device != p.device:
            raise ValueError(f"adamw_update: {name} is on {t.device}, p on {p.device}")
    if g.shape != p.shape or m.shape != p.shape or v.shape != p.shape:
        raise ValueError("adamw_update: g, m and v must have p's shape")
    if m.dtype != torch.float32 or v.dtype != torch.float32:
        raise ValueError("adamw_update: m and v must be float32")
    if any(t.dtype != torch.float32 or t.numel() != 1 for t in (lr, c1, c2)):
        raise ValueError("adamw_update: lr, c1 and c2 must be one float32 each")
    if not all(t.is_contiguous() for t in (p, g, m, v)):
        raise ValueError("adamw_update: p, g, m and v must be contiguous")
    n = p.numel()
    if n == 0:
        return
    vec = 4 if all(t.data_ptr() % (4 * t.element_size()) == 0 for t in (p, g, m, v)) else 1
    _build.launch(_lib().adamw_launch, p.device, "adamw", p.data_ptr(), g.data_ptr(),
                  m.data_ptr(), v.data_ptr(), n, lr.data_ptr(), c1.data_ptr(), c2.data_ptr(),
                  b1, 1 - b1, b2, 1 - b2, eps, weight_decay, p_code, g_code, vec,
                  _blocks(p.device, n))
    adamw_update.launches += 1


adamw_update.launches = 0   # kernel launches made by this wrapper
