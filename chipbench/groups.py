"""Who wrote a device kernel, by its name: a frozen copy of
``chip_smoke.py::kernel_group`` (as it stood when this benchmark was written), so
that renaming a kernel in the program shows as a metric that goes silent and
not as a yardstick that moves."""
from __future__ import annotations

import re

AF_KERNELS = re.compile(r"\baf_(rows|wide|usq|apply|v|vapply)_kernel\b")

GROUPS = ("K1", "K1_bwd", "K2", "K3", "K3_bwd", "adamw", "adafactor", "cublas", "other")


def kernel_group(name: str) -> str:
    """K1 (forward or backward), K2, K3 (forward or backward), the
    optimizers' kernels (AdamW's, Adafactor's), cuBLAS, other."""
    if AF_KERNELS.search(name):
        return "adafactor"
    name = name.lower()
    if "adamw_kernel" in name:
        return "adamw"
    if "flash_fwd" in name:
        return "K1"
    if "flash_bwd" in name:
        return "K1_bwd"
    if "decode_kernel" in name or "decode_tc_kernel" in name:
        return "K2"
    if "rmsnorm_kernel" in name:
        return "K3"
    if "rmsnorm_bwd" in name or "rmsnorm_dw" in name:
        return "K3_bwd"
    if any(t in name for t in ("nvjet", "gemm", "cublas", "cutlass", "xmma")):
        return "cublas"
    return "other"
