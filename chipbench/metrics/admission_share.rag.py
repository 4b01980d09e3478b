"""admission_share.rag: share of the traced window spent inside prefill
spans (the engine admits a request by a B1 prefill between decode steps,
and every live request waits for it), in %."""


def read(tr):
    spans = [s for s in tr.spans.named("prefill") if tr.window_t0 <= s.t0 <= tr.window_t1]
    if not spans:
        return None
    return sum(s.t1 - s.t0 for s in spans) / (tr.window_t1 - tr.window_t0) * 100.0
