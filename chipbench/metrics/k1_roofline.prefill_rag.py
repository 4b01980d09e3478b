"""k1_roofline.prefill_rag: K1's forward (``flash_fwd`` kernels by name)
against its roofline over the prefills of the profiled slice, in %: each
B1 prefill of S tokens runs K1 once a layer over S causal rows
(``work.flash_work``), whose least times, summed, are set over K1's device
time in the slice."""
from chipbench import work


def read(tr):
    spans = tr.in_slice("prefill")
    busy = tr.group_s("K1")
    if not spans or busy <= 0:
        return None
    cfg = tr.cfg
    H, Hkv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    Dh = cfg.get("head_dim", cfg["hidden_size"] // H)
    least = sum(work.bound_s(*work.flash_work(1, H, Hkv, s.info["S"], s.info["S"], Dh,
                                              work.causal_pairs(s.info["S"])))
                for s in spans) * cfg["num_hidden_layers"]
    return least / busy * 100.0
