"""Split-KV single-token attention: wrappers, plain versions, launch counts.

Counterpart of ``repro/kernels/decode_attention.py``.  Two CUDA C++ kernels
(``csrc/decode_attention.cu``): one writes a partial ``(o, m, l)`` for each
(batch, kv head, split), one combines the splits.  K and V are read through
strides, so the model's ``(B,T,Hkv,D)`` cache is passed as a permuted view
and never copied.  For a CUDA tensor the wrappers launch the kernels or
raise; only a tensor on the CPU takes the plain versions.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build

NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)
SUPPORTED_D = (64, 128, 256)
MAX_GROUP = 8
MIN_SPLIT_ROWS = 64       # a split shorter than this is not worth a block
DEFAULT_SM_COUNT = 132    # used where no CUDA device is asked (plain version on the CPU)


def split_plan(B: int, Hkv: int, T: int, *, sm_count: int = DEFAULT_SM_COUNT,
               n_splits: int | None = None) -> tuple[int, int]:
    """(number of splits, rows a split) for a (B, Hkv, T, D) cache: enough
    splits that B*Hkv*ns blocks give every SM two, none shorter than
    ``MIN_SPLIT_ROWS`` rows."""
    if n_splits is None:
        n_splits = -(-2 * sm_count // max(B * Hkv, 1))
        n_splits = min(n_splits, max(T // MIN_SPLIT_ROWS, 1))
    n_splits = max(1, min(n_splits, max(T, 1)))
    chunk = -(-max(T, 1) // n_splits)
    return -(-max(T, 1) // chunk), chunk


def combine_splits_plain(o_part, m_part, l_part, dtype) -> torch.Tensor:
    """o (B,Hkv,ns,G,D), m/l (B,Hkv,ns,G), fp32 -> (B, Hkv*G, D) in ``dtype``:
    ``w = l exp(m - max m)``, ``out = sum o w / max(sum w, 1e-30)``."""
    B, Hkv, ns, G, D = o_part.shape
    m_max = m_part.amax(dim=2, keepdim=True)
    w = l_part * torch.exp(m_part - m_max)
    denom = w.sum(dim=2).clamp_min(1e-30)
    o = (o_part * w[..., None]).sum(dim=2) / denom[..., None]
    return o.reshape(B, Hkv * G, D).to(dtype)


def decode_partials_plain(q, k, v, kv_valid_len, scale, ns: int, chunk: int):
    """The partial kernel's arithmetic in plain torch; returns (o, m, l)."""
    B, H, D = q.shape
    Hkv, T = k.shape[1], k.shape[2]
    G = H // Hkv
    Tp = ns * chunk
    kf = torch.nn.functional.pad(k.float(), (0, 0, 0, Tp - T)).reshape(B, Hkv, ns, chunk, D)
    vf = torch.nn.functional.pad(v.float(), (0, 0, 0, Tp - T)).reshape(B, Hkv, ns, chunk, D)
    qg = q.float().reshape(B, Hkv, G, D)
    s = torch.einsum("bkgd,bkscd->bksgc", qg, kf) * scale
    t_pos = torch.arange(Tp, device=q.device).reshape(1, 1, ns, 1, chunk)
    mask = (t_pos < T) & (t_pos < kv_valid_len.reshape(B, 1, 1, 1, 1))
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1).clamp_min(-1e30)
    p = torch.exp(s - m[..., None])            # a masked score gives exactly 0
    l = p.sum(dim=-1)
    o = torch.einsum("bksgc,bkscd->bksgd", p, vf) / l.clamp_min(1e-30)[..., None]
    return o, m, l


def decode_attention_plain(q, k, v, *, kv_valid_len=None, scale: float | None = None,
                           n_splits: int | None = None) -> torch.Tensor:
    """The two kernels' function in plain torch, split and combine included.
    q: (B,H,D); k/v: (B,Hkv,T,D) -> (B,H,D).  A row with ``kv_valid_len == 0``
    gives 0 (the kernels' behaviour; ``ref.py`` gives the mean of V)."""
    B, H, D = q.shape
    Hkv, T = k.shape[1], k.shape[2]
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    if kv_valid_len is None:
        kv_valid_len = torch.full((B,), T, dtype=torch.int32, device=q.device)
    ns, chunk = split_plan(B, Hkv, T, n_splits=n_splits)
    o, m, l = decode_partials_plain(q, k, v, kv_valid_len, scale, ns, chunk)
    return combine_splits_plain(o, m, l, q.dtype)


def _lib():
    lib = _build.load("decode_attention")
    vp, ci, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    if lib.decode_attention_launch.argtypes is None:
        lib.decode_attention_launch.argtypes = (
            [vp] * 7 + [ci] * 7 + [ll] * 6 + [ctypes.c_float, ci, vp])
        lib.decode_attention_launch.restype = ci
        lib.decode_combine_launch.argtypes = [vp] * 4 + [ci] * 6 + [vp]
        lib.decode_combine_launch.restype = ci
    return lib


def combine_splits(o_part, m_part, l_part, dtype) -> torch.Tensor:
    """Combine kernel: partials as in :func:`combine_splits_plain` -> (B,H,D)."""
    if o_part.device.type == "cpu":
        return combine_splits_plain(o_part, m_part, l_part, dtype)
    if o_part.device.type != "cuda":
        raise RuntimeError(f"combine_splits: no kernel for device {o_part.device}")
    B, Hkv, ns, G, D = o_part.shape
    for name, t, shape in (("o_part", o_part, (B, Hkv, ns, G, D)),
                           ("m_part", m_part, (B, Hkv, ns, G)),
                           ("l_part", l_part, (B, Hkv, ns, G))):
        if (t.shape != shape or t.dtype != torch.float32 or not t.is_contiguous()
                or t.device != o_part.device):
            raise ValueError(f"combine_splits: {name} must be contiguous float32 {shape} "
                             f"on {o_part.device}")
    out = torch.empty((B, Hkv * G, D), dtype=dtype, device=o_part.device)
    code = _build.dtype_code(out, "combine_splits out")
    if out.numel() == 0:
        return out
    _build.launch(_lib().decode_combine_launch, o_part.device, "combine_splits",
                  o_part.data_ptr(), m_part.data_ptr(), l_part.data_ptr(), out.data_ptr(),
                  B, Hkv, G, ns, D, code)
    combine_splits.launches += 1
    return out


def decode_attention(q, k, v, *, kv_valid_len=None, scale: float | None = None) -> torch.Tensor:
    """q: (B,H,D) one token a sequence; k/v: (B,Hkv,T,D), any strides over the
    first three dims; ``kv_valid_len``: (B,) int32, rows at or past it are
    dead.  Returns (B,H,D)."""
    B, H, D = q.shape
    Hkv, T = k.shape[1], k.shape[2]
    if H % Hkv or k.shape != (B, Hkv, T, D) or v.shape != k.shape:
        raise ValueError(f"decode_attention: bad shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)}")
    code = _build.dtype_code(q, "decode_attention q")
    if q.device.type == "cpu":
        return decode_attention_plain(q, k, v, kv_valid_len=kv_valid_len, scale=scale)
    if q.device.type != "cuda":
        raise RuntimeError(f"decode_attention: no kernel for device {q.device}")
    if k.dtype != q.dtype or v.dtype != q.dtype or k.device != q.device or v.device != q.device:
        raise ValueError("decode_attention: q, k and v must share dtype and device")
    if D not in SUPPORTED_D:
        raise ValueError(f"decode_attention: head dim {D} not supported by the kernel "
                         f"(supported: {SUPPORTED_D})")
    G = H // Hkv
    if G > MAX_GROUP:
        raise ValueError(f"decode_attention: {G} q heads a kv head exceed the kernel's "
                         f"limit of {MAX_GROUP}")
    if not q.is_contiguous():
        raise ValueError("decode_attention: q must be contiguous")
    if k.stride(-1) != 1 or v.stride(-1) != 1:
        raise ValueError("decode_attention: k and v must have stride 1 over D")
    if kv_valid_len is None:
        kv_valid_len = torch.full((B,), T, dtype=torch.int32, device=q.device)
    elif (kv_valid_len.shape != (B,) or kv_valid_len.dtype != torch.int32
          or kv_valid_len.device != q.device or not kv_valid_len.is_contiguous()):
        raise ValueError(f"decode_attention: kv_valid_len must be contiguous int32 ({B},) "
                         f"on {q.device}")
    if B == 0 or T == 0:
        return torch.zeros((B, H, D), dtype=q.dtype, device=q.device)
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    sm_count = torch.cuda.get_device_properties(q.device).multi_processor_count
    ns, chunk = split_plan(B, Hkv, T, sm_count=sm_count)
    o_part = torch.empty((B, Hkv, ns, G, D), dtype=torch.float32, device=q.device)
    m_part = torch.empty((B, Hkv, ns, G), dtype=torch.float32, device=q.device)
    l_part = torch.empty((B, Hkv, ns, G), dtype=torch.float32, device=q.device)
    _build.launch(_lib().decode_attention_launch, q.device, "decode_attention",
                  q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_valid_len.data_ptr(),
                  o_part.data_ptr(), m_part.data_ptr(), l_part.data_ptr(),
                  B, H, Hkv, T, D, ns, chunk, *k.stride()[:3], *v.stride()[:3],
                  float(scale), code)
    decode_attention.launches += 1
    return combine_splits(o_part, m_part, l_part, q.dtype)


decode_attention.launches = 0   # launches of the partial kernel by this wrapper
combine_splits.launches = 0     # launches of the combine kernel by this wrapper
