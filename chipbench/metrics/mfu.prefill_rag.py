"""mfu.prefill_rag: the prefills' share of the card's roofline over their
spans' time (each span ends in a sync), in %: for each B1 prefill of S
tokens, the least time its work needs (the family's ``prefill_work``; for a
dense decoder operations at 989 TFLOP/s, which bound it from a few hundred
tokens up, or bytes at 3.35 TB/s), summed, over the summed span time."""
from chipbench import work
from chipbench.harness import family


def read(tr):
    spans = tr.spans.named("prefill")
    if not spans:
        return None
    prefill_work = family(tr.cfg).prefill_work
    least = sum(work.bound_s(*prefill_work(tr.cfg, s.info["S"])) for s in spans)
    return least / sum(s.t1 - s.t0 for s in spans) * 100.0
