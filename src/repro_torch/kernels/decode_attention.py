"""Split-KV single-token attention: wrapper, plain versions, launch count.

Counterpart of ``repro/kernels/decode_attention.py``.  One CUDA C++ launch
(``csrc/decode_attention.cu``) computes a partial ``(acc, m, l)`` for each
(batch, head block, split) and, in the last block of a (batch, head block)
to finish, combines the splits.  Two kernels take the calls
(:func:`kernel_path`): bf16 at a group of 5, 7, 8 or 16 runs the group on
the tensor cores (``mma.sync``) with K and V staged through a ring of
asynchronous copies; fp32, and bf16 at a group of 1-3, run on the CUDA
cores.  A head block is a kv head's group of q heads, or half of an fp32
group of 16 (:func:`heads_a_block`).  K and V are read through strides, so
the model's ``(B,T,Hkv,D)`` cache is passed as a permuted view and never
copied.  For a CUDA tensor the wrapper launches the kernel or raises; only
a tensor on the CPU takes the plain versions.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build

NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)
SUPPORTED_D = (64, 128, 256)
SUPPORTED_G = (1, 2, 3, 5, 7, 8, 16)   # group sizes the kernels take
TC_G = (5, 7, 8, 16)               # bf16 groups on the tensor-core kernel
WARPS = 4                          # warps a block (DEC_WARPS in the source)
STAGE_ROWS = 32                    # rows a ring stage of the tensor-core kernel (TcPlan::ROWS)
SPLIT_FLOOR = 128                  # least rows a split (SPLIT_FLOOR in the source)
MAX_SPLITS = 256                   # most splits a (batch, head block) (MAX_SPLITS)
DEFAULT_SM_COUNT = 132             # used where no CUDA device is asked (plain version on the CPU)
DEFAULT_BLOCKS_PER_SM = 4          # likewise; on the card the kernel's measured occupancy


def kernel_path(G: int, dtype: torch.dtype) -> str:
    """Which kernel a group of G in ``dtype`` takes (``tc_path`` in the
    source): ``"tensor_cores"`` for bf16 at a group of 5, 7, 8 or 16, else
    ``"cuda_cores"``."""
    return "tensor_cores" if dtype == torch.bfloat16 and G in TC_G else "cuda_cores"


def rows_per_iter(D: int, itemsize: int) -> int:
    """Rows a block of the CUDA-core kernel reads an iteration
    (``DecPlan::ROWS_ITER`` in the source): a row is read in 16-byte loads
    by ``min(32, D*itemsize/16)`` lanes, and each lane keeps 4 loads of K
    (and 4 of V) in flight."""
    vec = 16 // itemsize
    lanes_a_row = min(32, D // vec)
    loads_a_row = D // (vec * lanes_a_row)
    return (4 // loads_a_row) * (32 // lanes_a_row) * WARPS


def plan_rows(G: int, D: int, dtype: torch.dtype) -> int:
    """Rows a split is a whole number of: a ring stage of the tensor-core
    kernel (32 at every head dim: 16 KB of K and 16 KB of V at D 256), an
    iteration of the CUDA-core one."""
    if kernel_path(G, dtype) == "tensor_cores":
        return STAGE_ROWS
    return rows_per_iter(D, torch.tensor([], dtype=dtype).element_size())


def heads_a_block(G: int, dtype: torch.dtype) -> int:
    """Q heads a block for a group of G in ``dtype`` (``heads_a_block`` in
    the source): the whole group, but an fp32 group of 16 is split over two
    blocks of 8, whose registers and shared memory the 8-head CUDA-core
    kernel fits."""
    return 8 if G == 16 and kernel_path(G, dtype) == "cuda_cores" else G


def head_blocks(Hkv: int, G: int, dtype: torch.dtype) -> int:
    """Blocks over the heads of one sequence: one a kv head, two where an
    fp32 group of 16 is split."""
    return Hkv * (G // heads_a_block(G, dtype))


def split_plan(B: int, Hkv: int, T: int, *, sm_count: int = DEFAULT_SM_COUNT,
               blocks_per_sm: int = DEFAULT_BLOCKS_PER_SM, rows_per_iter: int = 32,
               n_splits: int | None = None) -> tuple[int, int]:
    """(number of splits, rows a split) for a (B, T, D) cache read by
    ``Hkv`` head blocks a sequence (:func:`head_blocks`).  The splits are as
    many as let B*Hkv*ns blocks fill the card once (``sm_count *
    blocks_per_sm`` resident blocks), but no split is under ``SPLIT_FLOOR``
    = 128 rows, there are at most ``MAX_SPLITS`` = 256 and at least one,
    and each split is a whole number of the kernel's ``rows_per_iter`` rows
    (an iteration, or a ring stage).  ``split_plan`` in the source is the
    same rule.  The floor was chosen on an H100 80GB HBM3 by
    ``chip_smoke.py``'s ``k2_parts``, which times 16 to 2048 rows a split:
    128 rows was the fastest for both kernels at a single sequence
    (recurrentgemma's G 16 at D 256, qwen2-vl's G 7 and phi4-mini's G 3 at
    D 128) and at recurrentgemma's B8 mix, and within 3 % of the fastest
    (256) at qwen2-vl's B8 mix.  Filling the card alone had given a single
    sequence 128 splits of 16 rows, whose fp32 partials were as many bytes
    as the cache.  ``n_splits`` forces a count (still at most
    ``MAX_SPLITS`` and one a ``rows_per_iter``)."""
    T = max(T, 1)
    if n_splits is None:
        n_splits = min((sm_count * blocks_per_sm) // max(B * Hkv, 1), T // SPLIT_FLOOR)
    n_splits = max(1, min(n_splits, MAX_SPLITS, -(-T // rows_per_iter)))
    chunk = -(-T // n_splits)
    chunk = -(-chunk // rows_per_iter) * rows_per_iter
    return -(-T // chunk), chunk


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
    """The kernel's function in plain torch, split and combine included.
    q: (B,H,D); k/v: (B,Hkv,T,D) -> (B,H,D).  A row with ``kv_valid_len == 0``
    gives 0 (the kernel's behaviour; ``ref.py`` gives the mean of V)."""
    B, H, D = q.shape
    Hkv, T = k.shape[1], k.shape[2]
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    if kv_valid_len is None:
        kv_valid_len = torch.full((B,), T, dtype=torch.int32, device=q.device)
    G = H // Hkv
    ns, chunk = split_plan(B, head_blocks(Hkv, G, q.dtype), T,
                           rows_per_iter=plan_rows(G, D, q.dtype), n_splits=n_splits)
    o, m, l = decode_partials_plain(q, k, v, kv_valid_len, scale, ns, chunk)
    return combine_splits_plain(o, m, l, q.dtype)


def _lib():
    lib = _build.load("decode_attention")
    vp, ci, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    if lib.decode_attention_launch.argtypes is None:
        lib.decode_attention_launch.argtypes = (
            [vp] * 9 + [ci] * 7 + [ll] * 6 + [ctypes.c_float, ci, vp])
        lib.decode_attention_launch.restype = ci
        lib.decode_attention_plan.argtypes = [ci, ci, ci, ctypes.POINTER(ctypes.c_int)]
        lib.decode_attention_plan.restype = ci
        lib.decode_attention_heads_a_block.argtypes = [ci, ci]
        lib.decode_attention_heads_a_block.restype = ci
        lib.decode_attention_split_plan.argtypes = [ci] * 6 + [ctypes.POINTER(ctypes.c_int)]
        lib.decode_attention_split_plan.restype = None
    return lib


_plans: dict[tuple, tuple] = {}                   # (device, G, D, dtype) -> plan
_scratch: dict[tuple, torch.Tensor] = {}          # (device, B, head blocks, ns, G, D) -> buffer


def kernel_heads_a_block(G: int, dtype: torch.dtype) -> int:
    """Q heads a block for a group of G in ``dtype``, as the compiled
    library has it (0 where it takes no such group)."""
    return _lib().decode_attention_heads_a_block(G, _build.DTYPE_CODES[dtype])


def kernel_split_plan(B: int, HB: int, T: int, sm_count: int, blocks_per_sm: int,
                      rows: int) -> tuple[int, int]:
    """(splits, rows a split) as the compiled library's ``split_plan``
    has them."""
    out = (ctypes.c_int * 2)()
    _lib().decode_attention_split_plan(B, HB, T, sm_count, blocks_per_sm, rows, out)
    return out[0], out[1]


def kernel_plan(device: torch.device, G: int, D: int, dtype: torch.dtype) -> tuple:
    """(SM count, resident blocks an SM, rows a split is a whole number of,
    path) of the kernel for (G, D, dtype) on ``device``, asked of the card
    once and kept; the path is :func:`kernel_path`'s word for the kernel
    the library chose."""
    key = (device.index, G, D, dtype)
    plan = _plans.get(key)
    if plan is None:
        out = (ctypes.c_int * 6)()
        with torch.cuda.device(device):
            _build.check(_lib().decode_attention_plan(G, D, _build.DTYPE_CODES[dtype], out),
                         "decode_attention_plan")
        sm_count = torch.cuda.get_device_properties(device).multi_processor_count
        plan = _plans[key] = (sm_count, out[0], out[1],
                              "tensor_cores" if out[3] else "cuda_cores")
    return plan


def _scratch_for(device: torch.device, B: int, HB: int, ns: int, G: int, D: int):
    """Pointers to the fp32 partials (acc, m, l) of ``HB`` head blocks of
    ``G`` heads and the B*HB counters, in one int32 buffer kept a (device,
    shape).  The counters start at 0 and the kernel leaves them at 0.  Calls
    that share a shape share the buffer, so they must run on one stream."""
    n = B * HB * ns * G
    key = (device.index, B, HB, ns, G, D)
    buf = _scratch.get(key)
    if buf is None:
        buf = _scratch[key] = torch.zeros(n * (D + 2) + B * HB, dtype=torch.int32, device=device)
    base = buf.data_ptr()
    return base, base + 4 * n * D, base + 4 * n * (D + 1), base + 4 * n * (D + 2)


def decode_attention(q, k, v, *, kv_valid_len=None, scale: float | None = None) -> torch.Tensor:
    """q: (B,H,D) one token a sequence; k/v: (B,Hkv,T,D), any strides over the
    first three dims that are multiples of 16 bytes; ``kv_valid_len``: (B,)
    int32, rows at or past it are dead.  Returns (B,H,D)."""
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
    if G not in SUPPORTED_G:
        raise ValueError(f"decode_attention: {G} q heads a kv head; the kernel is built for "
                         f"{SUPPORTED_G}")
    if not q.is_contiguous() or q.data_ptr() % 16:
        raise ValueError("decode_attention: q must be contiguous and 16-byte aligned")
    item = q.element_size()
    for name, t in (("k", k), ("v", v)):
        if (t.stride(-1) != 1 or t.data_ptr() % 16
                or any(s * item % 16 for s in t.stride()[:3])):
            raise ValueError(f"decode_attention: {name} must have stride 1 over D, a 16-byte "
                             f"aligned base and strides of whole 16 bytes, got {t.stride()}")
    if kv_valid_len is None:
        kv_valid_len = torch.full((B,), T, dtype=torch.int32, device=q.device)
    elif (kv_valid_len.shape != (B,) or kv_valid_len.dtype != torch.int32
          or kv_valid_len.device != q.device or not kv_valid_len.is_contiguous()):
        raise ValueError(f"decode_attention: kv_valid_len must be contiguous int32 ({B},) "
                         f"on {q.device}")
    if B == 0 or T == 0:
        return torch.zeros((B, H, D), dtype=q.dtype, device=q.device)
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    sm_count, blocks_per_sm, rows, _ = kernel_plan(q.device, G, D, q.dtype)
    HB = head_blocks(Hkv, G, q.dtype)
    ns, chunk = split_plan(B, HB, T, sm_count=sm_count, blocks_per_sm=blocks_per_sm,
                           rows_per_iter=rows)
    acc, m, l, counter = _scratch_for(q.device, B, HB, ns, H // HB, D)
    out = torch.empty((B, H, D), dtype=q.dtype, device=q.device)
    _build.launch(_lib().decode_attention_launch, q.device, "decode_attention",
                  q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_valid_len.data_ptr(),
                  out.data_ptr(), acc, m, l, counter,
                  B, H, Hkv, T, D, ns, chunk, *k.stride()[:3], *v.stride()[:3],
                  float(scale), code)
    decode_attention.launches += 1
    return out


decode_attention.launches = 0   # kernel launches made by this wrapper
