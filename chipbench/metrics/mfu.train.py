"""mfu.train: model operations of the train steps over 989 TFLOP/s times
their wall time (the traced window's step spans, each ending in a sync), in
%.  Operations: the configuration's family counts them (``train_flops``:
for a dense decoder 6 N a token over the matrix products, N counting the
head and not the embedding table, and 3 x 4 H Dh a visible causal pair a
layer, no recompute counted)."""
from chipbench import work
from chipbench.harness import family


def read(tr):
    spans = tr.spans.named("step")
    if not spans:
        return None
    flops = family(tr.cfg).train_flops(tr.cfg, tr.traffic["batch"], tr.traffic["seq"])
    return flops * len(spans) / (work.PEAK_FLOPS_BF16 * sum(s.t1 - s.t0 for s in spans)) * 100.0
