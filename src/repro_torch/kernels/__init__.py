"""Hopper kernels of the port, their wrappers and plain versions.

``launch_counts`` / ``reset_launch_counts`` read and zero the integer each
wrapper adds one to where it launches its kernel (and nowhere else), so a run
can show that its path went through the kernels.  ``add_rmsnorm`` launches
the rmsnorm kernel and counts on ``rmsnorm``; a backward wrapper counts one a
call (its kernels: K3's row kernel and dw sum, K1's delta, dK/dV and dQ).
``adamw_update`` (one launch a parameter tensor) is the training step's
fused optimizer update, a kernel of the port that replaces no TPU kernel;
``adafactor_update`` (one call a layer group) is Adafactor's, and counts the
kernels it launches (2 or 3 a group: ``adafactor.launch_plan``).
"""
from repro_torch.kernels import ops, ref
from repro_torch.kernels.adafactor import adafactor_update, adafactor_update_plain
from repro_torch.kernels.adamw import adamw_update, adamw_update_plain
from repro_torch.kernels.decode_attention import (
    combine_splits_plain, decode_attention, decode_attention_plain,
)
from repro_torch.kernels.flash_attention import (
    flash_attention, flash_attention_bwd, flash_attention_bwd_plain, flash_attention_lse_plain,
    flash_attention_plain,
)
from repro_torch.kernels.rmsnorm import (
    add_rmsnorm, add_rmsnorm_plain, rmsnorm, rmsnorm_bwd, rmsnorm_bwd_plain, rmsnorm_plain,
)

_COUNTED = {
    "rmsnorm": rmsnorm,
    "flash_attention": flash_attention,
    "decode_attention": decode_attention,
    "rmsnorm_bwd": rmsnorm_bwd,
    "flash_attention_bwd": flash_attention_bwd,
    "adamw": adamw_update,
    "adafactor": adafactor_update,
}


def launch_counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in _COUNTED.items()}


def reset_launch_counts() -> None:
    for fn in _COUNTED.values():
        fn.launches = 0


__all__ = ["ops", "ref", "decode_attention", "flash_attention", "rmsnorm",
           "add_rmsnorm", "decode_attention_plain", "flash_attention_plain", "rmsnorm_plain",
           "add_rmsnorm_plain", "flash_attention_bwd", "flash_attention_bwd_plain",
           "flash_attention_lse_plain", "rmsnorm_bwd", "rmsnorm_bwd_plain", "adamw_update",
           "adamw_update_plain", "adafactor_update", "adafactor_update_plain",
           "combine_splits_plain", "launch_counts", "reset_launch_counts"]
