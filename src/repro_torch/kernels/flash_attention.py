"""Flash attention, forward and backward: wrappers, plain versions, launch
counts.

Counterpart of ``repro/kernels/flash_attention.py``.  The kernels are CUDA
C++.  The forward (``csrc/flash_attention.cu``): one block for each (batch,
q head, q tile) with the KV loop inside; for bf16 a warp-specialised block of
TMA loads and ``wgmma`` products (:func:`tile_plan`, its walk
:func:`fwd_kv_tiles`), for float32 fp32 FMAs;
given ``lse`` it launches the variant that also writes the row log-sum-exp.
The backward (``csrc/flash_attention_bwd.cu``, which the reference does not
have): a delta kernel, a dK/dV kernel of one block a (batch, q head, kv
tile) that walks the q tiles seeing it, the group's dK/dV summed in head
order (at D 128 by the blocks themselves, in turns, else by a sum kernel
over each head's partial), and a dQ kernel that walks the kv tiles; for bf16 with aligned
views TMA loads and ``wgmma`` products (:func:`bwd_tile_plan`, the walks
:func:`bwd_q_tiles` / :func:`bwd_kv_tiles`), otherwise fp32 FMAs
(:func:`bwd_fma_plan`).  They take
strides, so the model's ``(B,S,H,D)`` tensors are passed as permuted views
and never copied.  For a CUDA tensor a wrapper launches its kernels or
raises; only a tensor on the CPU takes the plain version.  The autograd glue
is ``ops.flash_attention_bshd``.

Both take one head dim for q, k and v (``SUPPORTED_D``), or MLA's dims
(``MLA_D``): q and k at 192, v at 128, the output and its gradient at v's.
Any other pair raises.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build

NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)
SUPPORTED_D = (64, 128, 256)   # one head dim for q, k and v
MLA_D = (192, 128)             # MLA's prefill: (q/k head dim, v head dim)
SMEM_LIMIT = 232_448     # shared memory one block may use on sm_90 (227 KB)
PAIR_MIN_KEYS = 1536     # D 128: the two-consumer plan where q and k both hold this many rows
SM_SMEM = 233_472        # shared memory of an sm_90 SM (228 KB), 1 KB of it reserved a block


def supported(Dqk: int, Dv: int) -> bool:
    """Whether the forward kernels take q/k head dim ``Dqk`` and v head dim ``Dv``."""
    return (Dqk == Dv and Dqk in SUPPORTED_D) or (Dqk, Dv) == MLA_D


def tile_plan(D: int, Dv: int | None = None, S: int | None = None) -> dict[str, int]:
    """The bf16 kernel's tiles for q/k head dim ``D`` and v head dim ``Dv``
    (default ``D``) where the shorter of q and k holds ``S`` rows (None: as
    many as a long sequence's), ``TcPlan`` in the source: q rows a block (one
    consumer warpgroup of 64; at D 128 with ``S`` at least ``PAIR_MIN_KEYS``
    two, ``PAIR``), kv rows a tile, stages of the
    K/V ring, threads (a producer warpgroup beside the consumers; at D 64 a
    producer warp), blocks an SM it is
    built for (three at D 64, else two where two fit an SM's shared memory),
    shared-memory bytes (Q, the K and V ring, 256 of barriers), and whether
    the grid is one-dimensional, every head's heaviest q tile first
    (``flat_grid``, ``FLAT``: at D 128 and D 256), rather than (q tile,
    head, batch) with each head's heaviest first.  The ring is three stages
    of 64 kv rows deep at D 256 and at D 128 below ``PAIR_MIN_KEYS``, two
    stages of 64 at ``MLA_D`` (where two blocks then share an SM), two of 128
    at D 64 and three of 128 for the two consumers at D 128."""
    Dv = D if Dv is None else Dv
    if not supported(D, Dv):
        raise ValueError(f"flash_attention: no bf16 plan for D={D}, Dv={Dv}")
    lean = (D, Dv) == (64, 64)
    pair = (D, Dv) == (128, 128) and (S is None or S >= PAIR_MIN_KEYS)
    bq, bk = 128 if pair else 64, 128 if lean or pair else 64
    stages = 3 if pair else 2 if D != Dv or lean else 3
    smem = bq * D * 2 + stages * bk * (D + Dv) * 2 + 256
    return {"q_rows": bq, "kv_rows": bk, "stages": stages,
            "threads": 160 if lean else 384 if pair else 256,
            "blocks_per_sm": 3 if lean else 2 if 2 * (smem + 1024) <= SM_SMEM else 1,
            "smem_bytes": smem, "flat_grid": int(D == Dv and D in (128, 256))}


def fwd_kv_tiles(qt: int, Sq: int, Sk: int, causal: bool, window: int, D: int,
                 Dv: int | None = None) -> range:
    """The kv tiles (of :func:`tile_plan`'s ``kv_rows``) that the bf16
    kernel's block of q tile ``qt`` (of ``q_rows``) walks, in order: from the
    tile holding the first key some row of it sees under the window to the
    last key any row sees under the causal mask or the end of K (the block's
    ``kv_lo`` and ``kv_hi`` in the source).  Where a block holds two
    consumer warpgroups (D 128, long sequences) both walk all of it."""
    plan = tile_plan(D, Dv, min(Sq, Sk))
    bq, bk = plan["q_rows"], plan["kv_rows"]
    q0 = qt * bq
    hi = min(Sk, min(q0 + bq, Sq)) if causal else Sk
    lo = max(0, q0 - window + 1) // bk if window > 0 else 0
    n = -(-(hi - lo * bk) // bk) if hi > lo * bk else 0
    return range(lo, lo + n)


# (q/k, v) head dims of the backward's tensor-core path (bf16, aligned views)
BWD_TC_DIMS = ((64, 64), (128, 128), (256, 256), MLA_D)
# ... whose dK/dV blocks of a group add into one running sum a kv head, in head order
# (``BwdPlan::CHAIN``), rather than writing each q head's partial for a sum kernel
BWD_CHAIN_DIMS = ((128, 128),)
BWD_TILE = 64            # q rows and kv rows of the tensor-core backward's tiles


def bwd_tile_plan(D: int, Dv: int | None = None) -> dict[str, int]:
    """The tensor-core backward's plan for q/k head dim ``D`` and v head dim
    ``Dv`` (default ``D``; ``BwdPlan`` in the source): q rows and kv rows a
    tile; the dK/dV kernel's ring stages, threads and blocks an SM (one
    warpgroup, three an SM at D 64, whose P^T waits in shared memory while
    dP^T is formed, and two at 128; above it two warpgroups, one owning dV
    and P^T, the other dK and dS^T, one block an SM); the dQ
    kernel's (one warpgroup; two stages and two blocks an SM up to 128, one
    block at D 256, one stage and two blocks at ``MLA_D``); and the two
    kernels' shared-memory bytes (K and V, a ring of Q, dO and their 64 rows
    of lse and delta, at D 64 and above 128 a 64 x 64 fp32 P^T, 64 of
    barriers; Q and dO, a ring of K and V, 64 of barriers)."""
    Dv = D if Dv is None else Dv
    if (D, Dv) not in BWD_TC_DIMS:
        raise ValueError(f"flash_attention_bwd: no tensor-core plan for D={D}, Dv={Dv}")
    split, stages, lean = D > 128, 2, (D, Dv) == (64, 64)
    dq_stages = stages if D == Dv else 1
    tile = BWD_TILE * (D + Dv) * 2          # a 64-row tile of Q and of dO (or of K and V)
    return {"q_rows": BWD_TILE, "kv_rows": BWD_TILE, "stages": stages,
            "dkdv_threads": 256 if split else 128,
            "dkdv_blocks_per_sm": 1 if split else 3 if lean else 2,
            "dq_stages": dq_stages, "dq_threads": 128,
            "dq_blocks_per_sm": 1 if D == Dv and D > 128 else 2,
            "smem_dkdv": (1 + stages) * tile + (BWD_TILE * BWD_TILE * 4 if split or lean else 0)
                         + 2 * stages * BWD_TILE * 4 + 64,
            "smem_dq": (1 + dq_stages) * tile + 64}


def bwd_fma_plan(D: int, Dv: int | None = None) -> dict[str, int]:
    """The FMA backward's plan for q/k head dim ``D`` and v head dim ``Dv``
    (``FmaPlan`` in the source): kv rows a dK/dV block (64 up to D 128, else
    32) and the dK/dV and dQ kernels' shared-memory bytes (fp32 tiles of K,
    V, Q and dO with rows padded by 4, P^T and dS^T of 32 q columns and 32
    rows of lse and delta; Q and dO of 64 rows, K and V of 32, dS)."""
    Dv = D if Dv is None else Dv
    if not supported(D, Dv):
        raise ValueError(f"flash_attention_bwd: no kernel for D={D}, Dv={Dv}")
    rows, width = (64 if D <= 128 else 32), D + Dv + 8
    return {"kv_rows": rows,
            "smem_dkdv": 4 * (rows * width + 32 * width + 2 * rows * 36 + 64),
            "smem_dq": 4 * (64 * width + 32 * width + 64 * 36)}


def bwd_q_tiles(kt: int, Sq: int, Sk: int, causal: bool, window: int) -> range:
    """The q tiles whose rows can see some row of kv tile ``kt``: what the
    tensor-core dK/dV block of that tile walks (``dkdv_q_tiles`` in the
    source)."""
    k_last = min(kt * BWD_TILE + BWD_TILE, Sk) - 1
    lo = kt if causal else 0
    hi = min(Sq, k_last + window) if window > 0 else Sq
    n = -(-(hi - lo * BWD_TILE) // BWD_TILE) if hi > lo * BWD_TILE else 0
    return range(lo, lo + n)


def bwd_kv_tiles(qt: int, Sq: int, Sk: int, causal: bool, window: int) -> range:
    """The kv tiles that some row of q tile ``qt`` can see: what the
    tensor-core dQ block of that tile walks (``dq_kv_tiles`` in the
    source)."""
    q0 = qt * BWD_TILE
    q_last = min(q0 + BWD_TILE, Sq) - 1
    lo = max(0, q0 - window + 1) // BWD_TILE if window > 0 else 0
    hi = min(Sk, q_last + 1) if causal else Sk
    n = -(-(hi - lo * BWD_TILE) // BWD_TILE) if hi > lo * BWD_TILE else 0
    return range(lo, lo + n)


CHAIN_SLAB = 64    # blocks of a head's slab at least in a chained dK/dV grid (the source's)


def bwd_block_order(kind: str, B: int, H: int, S: int,
                    chain_g: int = 0) -> list[tuple[int, int, int]]:
    """(tile, q head, batch) of each block of the tensor-core ``"dkdv"`` or
    ``"dq"`` kernel in the order of its one-dimensional grid: every head's
    heaviest tile under a causal mask first (kv tile 0; the last q tile).
    ``S`` is Sk for dK/dV, Sq for dQ.  ``chain_g``: the group G of a dK/dV
    grid whose blocks chain the group's sum (D 128 at G > 1; ``dkdv_block``
    in the source): there the kv tiles go in chunks of ``CH`` (enough that a
    chunk holds ``CHAIN_SLAB`` blocks of one head of each group), a chunk's
    blocks head by head of the group, so that the block of head g of a kv
    tile starts a slab after head g - 1's, which it waits on."""
    n = -(-S // BWD_TILE)
    if kind == "dkdv" and chain_g > 1:
        hkv = H // chain_g
        hb = hkv * B
        ch = min(n, -(-CHAIN_SLAB // hb))
        order = []
        for k0 in range(0, n, ch):
            for g in range(chain_g):
                for t in range(k0, min(n, k0 + ch)):
                    for r in range(hb):
                        b, hk = divmod(r, hkv)
                        order.append((t, hk * chain_g + g, b))
        return order
    order = []
    for i in range(n * H * B):
        t, hb = divmod(i, H * B)
        b, h = divmod(hb, H)
        order.append((t if kind == "dkdv" else n - 1 - t, h, b))
    return order


def bwd_workspace_bytes(B: int, H: int, Hkv: int, Sq: int, Sk: int, D: int,
                        dtype: torch.dtype, aligned: bool, Dv: int | None = None) -> int:
    """Bytes of scratch the backward needs (``bwd_workspace`` in the
    source): the FMA path's delta, (B,H,Sq) fp32; the tensor-core path's
    delta and log2-unit lse over q rows padded to whole tiles, and for G > 1
    at D 128 (``BWD_CHAIN_DIMS``) each kv head's running sums of dK
    (B,Hkv,Sk,D) and dV (B,Hkv,Sk,Dv) in fp32 and an int32 turn a (batch, kv
    head, kv tile), padded to 256 bytes, which the group's blocks pass on in
    head order; at the other dims each q head's partial dK (B,H,Sk,D) and dV
    (B,H,Sk,Dv) in fp32.  The tensor-core path takes bf16 at the dims of
    ``BWD_TC_DIMS`` (``Dv`` None for one head dim) with every operand's base
    on 16 bytes and its strides multiples of 8 elements (``aligned``;
    ``takes_wg`` in the source)."""
    Dv = D if Dv is None else Dv
    if not (dtype == torch.bfloat16 and (D, Dv) in BWD_TC_DIMS and aligned):
        return B * H * Sq * 4
    rows = B * H * -(-Sq // BWD_TILE) * BWD_TILE * 4
    if H == Hkv:
        return 2 * rows
    if (D, Dv) in BWD_CHAIN_DIMS:
        turns = B * Hkv * -(-Sk // BWD_TILE) * 4
        return 2 * rows + B * Hkv * Sk * (D + Dv) * 4 + -(-turns // 256) * 256
    return 2 * rows + B * H * Sk * (D + Dv) * 4


def _mask(Sq: int, Sk: int, causal: bool, window: int, device) -> torch.Tensor:
    """(Sq, Sk) bool: which key each query sees, by absolute position."""
    qp = torch.arange(Sq, device=device)[:, None]
    tp = torch.arange(Sk, device=device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=device)
    if causal:
        mask &= tp <= qp
    if window > 0:
        mask &= tp > qp - window
    return mask


def flash_attention_lse_plain(q, k, v, *, causal: bool = True, window: int = 0,
                              scale: float | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """The forward kernel's function in plain torch, with the row log-sum-exp
    of the scaled scores that its LSE variant writes.  q: (B,H,Sq,D); k:
    (B,Hkv,Sk,D); v: (B,Hkv,Sk,Dv) -> ((B,H,Sq,Dv) in q's dtype, (B,H,Sq)
    fp32); the scale defaults to 1/sqrt(D).  Follows the kernel, not
    ``ref.py``: the running maximum is floored at -1e30, so a fully masked
    row gives 0 (and a log-sum-exp near -1e30)."""
    B, H, Sq, D = q.shape
    Hkv, Sk, Dv = k.shape[1], k.shape[2], v.shape[-1]
    G = H // Hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    qg = q.float().reshape(B, Hkv, G, Sq, D)
    s = torch.einsum("bkgsd,bktd->bkgst", qg, k.float()) * scale
    s = torch.where(_mask(Sq, Sk, causal, window, q.device), s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True).clamp_min(-1e30)
    p = torch.exp(s - m)                       # a masked score gives exactly 0
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bkgst,bktd->bkgsd", p, v.float()) / l.clamp_min(1e-30)
    lse = (m + torch.log(l.clamp_min(1e-30))).reshape(B, H, Sq)
    return o.reshape(B, H, Sq, Dv).to(q.dtype), lse


def flash_attention_plain(q, k, v, *, causal: bool = True, window: int = 0,
                          scale: float | None = None) -> torch.Tensor:
    """The kernel's function in plain torch.  q: (B,H,Sq,D); k: (B,Hkv,Sk,D);
    v: (B,Hkv,Sk,Dv) -> (B,H,Sq,Dv).  Follows the kernel, not ``ref.py``: the
    running maximum is floored at -1e30, so a fully masked row gives 0."""
    return flash_attention_lse_plain(q, k, v, causal=causal, window=window, scale=scale)[0]


def flash_attention_bwd_plain(q, k, v, o, lse, do, *, causal: bool = True, window: int = 0,
                              scale: float | None = None):
    """The backward kernels' arithmetic in plain torch, step by step: ``(dq,
    dk, dv)`` of the forward given its output ``o``, its log-sum-exp ``lse``
    (B,H,Sq) and the gradient ``do`` of ``o``.  Shapes as the forward's (v,
    o and do at v's head dim); fp32 throughout, each gradient in its input's
    dtype.  A masked score has P = 0, so a fully masked row sends no
    gradient."""
    B, H, Sq, D = q.shape
    Hkv, Sk, Dv = k.shape[1], k.shape[2], v.shape[-1]
    G = H // Hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    qg = q.float().reshape(B, Hkv, G, Sq, D)
    og = o.float().reshape(B, Hkv, G, Sq, Dv)
    dog = do.float().reshape(B, Hkv, G, Sq, Dv)
    kf, vf = k.float(), v.float()
    s = torch.einsum("bkgsd,bktd->bkgst", qg, kf) * scale
    p = torch.exp(s - lse.float().reshape(B, Hkv, G, Sq, 1))
    p = torch.where(_mask(Sq, Sk, causal, window, q.device), p, torch.zeros_like(p))
    delta = (dog * og).sum(dim=-1, keepdim=True)                 # rowsum(dO * O)
    dv = torch.einsum("bkgst,bkgsd->bktd", p, dog)               # sum_g P^T dO
    dp = torch.einsum("bkgsd,bktd->bkgst", dog, vf)              # dO V^T
    ds = p * (dp - delta)
    dk = torch.einsum("bkgst,bkgsd->bktd", ds, qg) * scale       # sum_g dS^T Q
    dq = torch.einsum("bkgst,bktd->bkgsd", ds, kf) * scale       # dS K
    return dq.reshape(B, H, Sq, D).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _lib():
    lib = _build.load("flash_attention")
    if lib.flash_attention_launch.argtypes is None:
        vp, ci, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.flash_attention_launch.argtypes = (
            [vp, vp, vp, vp, vp] + [ci] * 7 + [ll] * 12 + [ci, ci, ctypes.c_float, ci, vp])
        lib.flash_attention_launch.restype = ci
        lib.flash_attention_plan.argtypes = [ci, ci, ci, ci, ctypes.POINTER(ctypes.c_int)]
        lib.flash_attention_plan.restype = ci
    return lib


def kernel_plan(D: int, Dv: int | None = None, S: int | None = None) -> dict[str, int]:
    """:func:`tile_plan` as the compiled kernel reports it (needs the library)."""
    Dv = D if Dv is None else Dv
    S = PAIR_MIN_KEYS if S is None else S
    out = (ctypes.c_int * 7)()
    if _lib().flash_attention_plan(D, Dv, S, S, out) != 0:
        raise ValueError(f"flash_attention: no bf16 plan for D={D}, Dv={Dv}")
    return dict(zip(("q_rows", "kv_rows", "stages", "threads", "blocks_per_sm", "smem_bytes",
                     "flat_grid"), out))


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
                    scale: float | None = None, out: torch.Tensor | None = None,
                    lse: torch.Tensor | None = None) -> torch.Tensor:
    """q: (B,H,Sq,D); k: (B,Hkv,Sk,D); v: (B,Hkv,Sk,Dv) with H % Hkv == 0 ->
    (B,H,Sq,Dv); the scale defaults to 1/sqrt(D).  Any strides over the
    first three dims that are multiples of 16 bytes.  ``out``, if given, is
    a ``(B,H,Sq,Dv)`` tensor (view) of ``q.dtype`` that receives the result.
    ``lse``, if given, is a contiguous ``(B,H,Sq)`` fp32 tensor that
    receives the row log-sum-exp (the kernel's LSE variant, for the
    backward)."""
    B, H, Sq, D = q.shape
    Hkv, Sk, Dv = k.shape[1], k.shape[2], v.shape[-1]
    if H % Hkv or k.shape != (B, Hkv, Sk, D) or v.shape != (B, Hkv, Sk, Dv):
        raise ValueError(f"flash_attention: bad shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)}")
    code = _build.dtype_code(q, "flash_attention q")
    if lse is not None and (lse.shape != (B, H, Sq) or lse.dtype != torch.float32
                            or lse.device != q.device or not lse.is_contiguous()):
        raise ValueError(f"flash_attention: lse must be a contiguous ({B}, {H}, {Sq}) float32 "
                         f"tensor on {q.device}")
    if q.device.type == "cpu":
        o, row_lse = flash_attention_lse_plain(q, k, v, causal=causal, window=window, scale=scale)
        if lse is not None:
            lse.copy_(row_lse)
        if out is None:
            return o
        out.copy_(o)
        return out
    if q.device.type != "cuda":
        raise RuntimeError(f"flash_attention: no kernel for device {q.device}")
    if k.dtype != q.dtype or v.dtype != q.dtype or k.device != q.device or v.device != q.device:
        raise ValueError("flash_attention: q, k and v must share dtype and device")
    if not supported(D, Dv):
        raise ValueError(f"flash_attention: head dims {D} (q, k) and {Dv} (v) not supported by "
                         f"the kernel (supported: one of {SUPPORTED_D}, or {MLA_D})")
    if out is None:
        out = torch.empty((B, H, Sq, Dv), dtype=q.dtype, device=q.device)
    elif out.shape != (B, H, Sq, Dv) or out.dtype != q.dtype or out.device != q.device:
        raise ValueError("flash_attention: out must be (B,H,Sq,Dv) of q's dtype and device")
    for name, t in (("q", q), ("k", k), ("v", v), ("out", out)):
        check_operand(name, t)
    if B == 0 or Sq == 0:
        return out
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    _build.launch(_lib().flash_attention_launch, q.device, "flash_attention",
                  q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                  None if lse is None else lse.data_ptr(), B, H, Hkv, Sq, Sk, D, Dv,
                  *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
                  int(bool(causal)), int(window), float(scale), code)
    flash_attention.launches += 1
    return out


flash_attention.launches = 0   # kernel launches made by this wrapper


def _bwd_lib():
    lib = _build.load("flash_attention_bwd")
    if lib.flash_attention_bwd_launch.argtypes is None:
        vp, ci, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.flash_attention_bwd_launch.argtypes = (
            [vp, vp, vp, vp, ll] + [ci] * 9 + [ctypes.c_float, ci, vp])
        lib.flash_attention_bwd_launch.restype = ci
        lib.flash_attention_bwd_plan.argtypes = [ci, ci, ctypes.POINTER(ci)]
        lib.flash_attention_bwd_plan.restype = ci
        lib.flash_attention_bwd_fma_plan.argtypes = [ci, ci, ctypes.POINTER(ci)]
        lib.flash_attention_bwd_fma_plan.restype = ci
        lib.flash_attention_bwd_workspace.argtypes = [ci] * 9
        lib.flash_attention_bwd_workspace.restype = ll
    return lib


def kernel_bwd_plan(D: int, Dv: int | None = None) -> dict[str, int]:
    """:func:`bwd_tile_plan` as the compiled kernels report it (needs the library)."""
    Dv = D if Dv is None else Dv
    out = (ctypes.c_int * 10)()
    if _bwd_lib().flash_attention_bwd_plan(D, Dv, out) != 0:
        raise ValueError(f"flash_attention_bwd: no tensor-core plan for D={D}, Dv={Dv}")
    return dict(zip(("q_rows", "kv_rows", "stages", "dkdv_threads", "dkdv_blocks_per_sm",
                     "dq_stages", "dq_threads", "dq_blocks_per_sm", "smem_dkdv", "smem_dq"),
                    out))


def kernel_bwd_fma_plan(D: int, Dv: int | None = None) -> dict[str, int]:
    """:func:`bwd_fma_plan` as the compiled kernels report it (needs the library)."""
    Dv = D if Dv is None else Dv
    out = (ctypes.c_int * 3)()
    if _bwd_lib().flash_attention_bwd_fma_plan(D, Dv, out) != 0:
        raise ValueError(f"flash_attention_bwd: no kernel for D={D}, Dv={Dv}")
    return dict(zip(("kv_rows", "smem_dkdv", "smem_dq"), out))


def kernel_bwd_workspace_bytes(B: int, H: int, Hkv: int, Sq: int, Sk: int, D: int,
                               dtype: torch.dtype, aligned: bool, Dv: int | None = None) -> int:
    """:func:`bwd_workspace_bytes` as the compiled library computes it."""
    Dv = D if Dv is None else Dv
    return int(_bwd_lib().flash_attention_bwd_workspace(B, H, Hkv, Sq, Sk, D, Dv,
                                                        _build.DTYPE_CODES[dtype], int(aligned)))


def _check_bwd_operand(name: str, t: torch.Tensor) -> None:
    """The backward kernels read and write four elements at a time: stride 1
    over D, every other stride and the base a multiple of four elements."""
    if t.stride(-1) != 1 or any(s % 4 for s in t.stride()[:3]) or t.data_ptr() % (4 * t.element_size()):
        raise ValueError(f"flash_attention_bwd: {name} needs stride 1 over D and strides and a "
                         f"base that are multiples of 4 elements, got strides {t.stride()}")


def flash_attention_bwd(q, k, v, o, lse, do, *, causal: bool = True, window: int = 0,
                        scale: float | None = None, dq=None, dk=None, dv=None):
    """``(dq, dk, dv)`` of :func:`flash_attention` (see
    :func:`flash_attention_bwd_plain`).  q, dq: (B,H,Sq,D); o, do:
    (B,H,Sq,Dv); k, dk: (B,Hkv,Sk,D); v, dv: (B,Hkv,Sk,Dv), all of one dtype,
    with strides as the forward's; lse: the forward's contiguous (B,H,Sq) fp32
    log-sum-exp.  ``dq``/``dk``/``dv``, if given, are tensors (views) that
    receive the gradients.  The kernels take the forward's dims
    (:func:`supported`): one head dim, or MLA's (192, 128)."""
    B, H, Sq, D = q.shape
    Hkv, Sk, Dv = k.shape[1], k.shape[2], v.shape[-1]
    if (H % Hkv or k.shape != (B, Hkv, Sk, D) or v.shape != (B, Hkv, Sk, Dv)
            or o.shape != (B, H, Sq, Dv) or do.shape != o.shape or lse.shape != (B, H, Sq)):
        raise ValueError(f"flash_attention_bwd: bad shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)} o {tuple(o.shape)} do {tuple(do.shape)} "
                         f"lse {tuple(lse.shape)}")
    code = _build.dtype_code(q, "flash_attention_bwd q")
    outs = {"dq": (dq, q), "dk": (dk, k), "dv": (dv, v)}
    for name, (t, like) in outs.items():
        if t is not None and (t.shape != like.shape or t.dtype != like.dtype
                              or t.device != like.device):
            raise ValueError(f"flash_attention_bwd: {name} must match its input in shape, "
                             "dtype and device")
    if q.device.type == "cpu":
        grads = flash_attention_bwd_plain(q, k, v, o, lse, do, causal=causal, window=window,
                                          scale=scale)
        return tuple(g if t is None else t.copy_(g)
                     for g, (t, _) in zip(grads, outs.values()))
    if q.device.type != "cuda":
        raise RuntimeError(f"flash_attention_bwd: no kernel for device {q.device}")
    ins = (q, k, v, o, do)
    if any(t.dtype != q.dtype or t.device != q.device for t in ins):
        raise ValueError("flash_attention_bwd: q, k, v, o and do must share dtype and device")
    if lse.dtype != torch.float32 or lse.device != q.device or not lse.is_contiguous():
        raise ValueError("flash_attention_bwd: lse must be contiguous float32 on q's device")
    if not supported(D, Dv):
        raise ValueError(f"flash_attention_bwd: head dims {D} (q, k) and {Dv} (v) not supported "
                         f"by the kernels (supported: one of {SUPPORTED_D}, or {MLA_D})")
    dq = torch.empty_like(q, memory_format=torch.contiguous_format) if dq is None else dq
    dk = torch.empty_like(k, memory_format=torch.contiguous_format) if dk is None else dk
    dv = torch.empty_like(v, memory_format=torch.contiguous_format) if dv is None else dv
    tensors = (*ins, dq, dk, dv)
    for name, t in zip(("q", "k", "v", "o", "do", "dq", "dk", "dv"), tensors):
        _check_bwd_operand(name, t)
    if B == 0 or Sq == 0 or Sk == 0:
        dk.zero_()
        dv.zero_()
        return dq.zero_(), dk, dv
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    aligned = all(t.data_ptr() % 16 == 0 and all(s % 8 == 0 for s in t.stride()[:3])
                  for t in tensors)
    nbytes = bwd_workspace_bytes(B, H, Hkv, Sq, Sk, D, q.dtype, aligned, Dv)
    ws = torch.empty(nbytes, dtype=torch.uint8, device=q.device)
    ptrs = (ctypes.c_void_p * 8)(*(t.data_ptr() for t in tensors))
    strides = (ctypes.c_longlong * 24)(*(s for t in tensors for s in t.stride()[:3]))
    _build.launch(_bwd_lib().flash_attention_bwd_launch, q.device, "flash_attention_bwd",
                  ptrs, strides, lse.data_ptr(), ws.data_ptr(), nbytes, B, H, Hkv, Sq, Sk, D,
                  Dv, int(bool(causal)), int(window), float(scale), code)
    flash_attention_bwd.launches += 1
    return dq, dk, dv


flash_attention_bwd.launches = 0   # backward launches (delta, dK/dV, [sum,] dQ kernels each)
