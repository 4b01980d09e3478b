"""adamw_roofline.train: AdamW's kernel (``adamw_kernel`` by name) against
its roofline over the steps of the profiled slice, in %: every parameter's
p, m and v read and written once and g read once (``work.adamw_bytes``, bf16
p and g, fp32 m and v) at 3.35 TB/s."""
from chipbench import weights, work


def read(tr):
    steps = len(tr.in_slice("step"))
    busy = tr.group_s("adamw")
    if not steps or busy <= 0:
        return None
    least = work.adamw_bytes(weights.count(tr.cfg)) / work.PEAK_BYTES_S
    return least * steps / busy * 100.0
