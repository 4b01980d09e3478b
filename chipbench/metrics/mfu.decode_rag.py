"""mfu.decode_rag: the decode steps' share of the card's roofline over their
spans' time (each span ends in a sync), in %: for each step, the least time
its work needs (the family's ``decode_step_work``; for a dense decoder the
weights once and the live requests' K/V rows once at 3.35 TB/s, which bound
it, or the operations of the live rows at 989 TFLOP/s), summed, over the
summed span time."""
from chipbench import work
from chipbench.harness import family


def read(tr):
    spans = [s for s in tr.spans.named("decode") if s.info["live"] > 0]
    if not spans:
        return None
    step_work = family(tr.cfg).decode_step_work
    least = sum(work.bound_s(*step_work(tr.cfg, s.info["live"], s.info["rows"])) for s in spans)
    return least / sum(s.t1 - s.t0 for s in spans) * 100.0
