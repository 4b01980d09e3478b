"""k1_bwd_roofline.train: K1's backward (``flash_bwd`` kernels by name:
delta, dK/dV, dQ) against its roofline over the steps of the profiled
slice, in %: one backward a layer a step over the batch's causal rows
(``work.flash_bwd_work``), whatever the remat policy recomputes."""
from chipbench import work


def read(tr):
    steps = len(tr.in_slice("step"))
    busy = tr.group_s("K1_bwd")
    if not steps or busy <= 0:
        return None
    cfg, T = tr.cfg, tr.traffic
    H, Hkv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    Dh = cfg.get("head_dim", cfg["hidden_size"] // H)
    B, S = T["batch"], T["seq"]
    least = work.bound_s(*work.flash_bwd_work(B, H, Hkv, S, S, Dh, work.causal_pairs(S)))
    return least * cfg["num_hidden_layers"] * steps / busy * 100.0
