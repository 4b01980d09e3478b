"""The yardstick's arithmetic: the card's published peaks, the least time a
piece of work needs, and the operations and bytes of each kernel and step,
counted from the traffic's shapes (never from what the program launches).

``bound``, ``flash_work``, ``flash_bwd_work`` and ``decode_work`` are frozen
copies of the functions of the same names in the
repository's ``chip_smoke.py`` (as they stood when this benchmark was written), taking
shapes instead of tensors, so that a later change to the program or to that
script cannot move the yardstick.
"""
from __future__ import annotations

# One NVIDIA H100 SXM, NVIDIA's data sheet, dense rates, at the full 700 W.
PEAK_FLOPS_BF16 = 989e12
PEAK_BYTES_S = 3.35e12
MEMORY_BYTES = 80e9


def bound_s(nbytes: float, flops: float) -> float:
    """The least time the work needs: the larger of its bytes at the memory
    rate and its operations at the bf16 peak."""
    return max(nbytes / PEAK_BYTES_S, flops / PEAK_FLOPS_BF16)


def causal_pairs(S: int) -> int:
    """The (q, k) positions a causal mask over S rows leaves."""
    return S * (S + 1) // 2


def flash_work(B: int, H: int, Hkv: int, Sq: int, Sk: int, D: int, pairs: int,
               elt: int = 2, Dv: int | None = None) -> tuple[float, float]:
    """(bytes, operations) of K1's forward: q, k, v read once, o written
    once; 2 (D + Dv) operations a visible pair and q head."""
    Dv = D if Dv is None else Dv
    q, k = B * H * Sq * D, B * Hkv * Sk * D
    nbytes = (q + k + (k + q) * Dv // D) * elt
    return float(nbytes), 2.0 * B * H * (D + Dv) * pairs


def flash_bwd_work(B: int, H: int, Hkv: int, Sq: int, Sk: int, D: int, pairs: int,
                   elt: int = 2, Dv: int | None = None) -> tuple[float, float]:
    """(bytes, operations) of K1's backward: q, k, v, o, dO and the lse read
    once, dq, dk, dv written once; 2.5 times the forward's operations."""
    Dv = D if Dv is None else Dv
    q, k = B * H * Sq * D, B * Hkv * Sk * D
    nbytes = 2 * (q + k) * (D + Dv) // D * elt + 4 * B * H * Sq
    return float(nbytes), 2.5 * 2.0 * B * H * (D + Dv) * pairs


def decode_work(B: int, H: int, Hkv: int, D: int, rows: int, elt: int = 2) -> tuple[float, float]:
    """(bytes, operations) of K2 over ``rows`` valid cache rows in all: the
    K and V rows read once, q read and o written once; 4 D operations a q
    head and row."""
    nbytes = (2 * rows * Hkv * D + 2 * B * H * D) * elt + 4 * B
    return float(nbytes), 4.0 * H * D * rows


def adamw_bytes(n_params: int, p_elt: int = 2, g_elt: int = 2) -> float:
    """AdamW's update: p, m and v read and written once (m, v float32), g
    read once."""
    return float(n_params * (2 * p_elt + 16 + g_elt))
