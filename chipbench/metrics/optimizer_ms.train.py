"""optimizer_ms.train: device ms a step in AdamW's kernels (``adamw_kernel``
by name, ``groups.kernel_group``), over the steps of the profiled slice."""


def read(tr):
    steps = len(tr.in_slice("step"))
    busy = tr.group_s("adamw")
    if not steps or busy <= 0:
        return None
    return busy / steps * 1e3
