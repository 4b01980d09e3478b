"""idle_share.train: Share of the profiled slice in which no device activity (kernel, copy
or fill) ran, in %."""
from chipbench.trace import busy_s


def read(tr):
    span = tr.slice_t1 - tr.slice_t0
    if span <= 0:
        return None
    return (1.0 - busy_s(tr.kernels, tr.slice_t0, tr.slice_t1) / span) * 100.0
