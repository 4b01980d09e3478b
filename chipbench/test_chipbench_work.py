"""The yardstick's arithmetic against hand counts at small shapes, and the
metric readers on a made-up trace."""
from __future__ import annotations

import pytest

from chipbench import harness, weights, work
from chipbench.groups import kernel_group
from chipbench.trace import Kernel, Span, Spans, Traced, busy_s, idle_gaps, open_span


def test_pairs():
    assert work.causal_pairs(4) == 1 + 2 + 3 + 4


def test_flash_work_by_hand():
    # B1, 2 q heads on 1 kv head, S 4, D 8, causal: q 64, k 32, v 32, o 64 elements
    nbytes, flops = work.flash_work(1, 2, 1, 4, 4, 8, 10)
    assert nbytes == (64 + 32 + 32 + 64) * 2
    assert flops == 2 * 2 * (8 + 8) * 10
    nbytes, flops = work.flash_bwd_work(1, 2, 1, 4, 4, 8, 10)
    assert nbytes == 2 * (64 + 32) * 2 * 2 + 4 * 2 * 4     # q, k, v, o, dO, lse in; dq, dk, dv out
    assert flops == 2.5 * 2 * 2 * 16 * 10


def test_decode_work_by_hand():
    # 2 live rows, 4 q heads on 2 kv heads, D 8, 10 cache rows in all
    nbytes, flops = work.decode_work(2, 4, 2, 8, 10)
    assert nbytes == (2 * 10 * 2 * 8 + 2 * 2 * 4 * 8) * 2 + 4 * 2
    assert flops == 4 * 4 * 8 * 10


def test_bound_takes_the_slower_side():
    assert work.bound_s(3.35e12, 1.0) == pytest.approx(1.0)
    assert work.bound_s(1.0, 989e12) == pytest.approx(1.0)


def test_step_arithmetic_of_qwen_at_ten_layers():
    cfg = harness.config_file("qwen2.5-32b.l10")
    fam = harness.family(cfg)
    per_layer = 5120 * 5120 * 2 + 5120 * 1024 * 2 + 3 * 5120 * 27648
    assert fam.body_matmul_params(cfg) == 10 * per_layer
    n_mm = 10 * per_layer + 5120 * 152064
    flops = fam.train_flops(cfg, 1, 2048)
    assert flops == 6 * n_mm * 2048 + 3 * 4 * 40 * 128 * work.causal_pairs(2048) * 10
    assert flops == pytest.approx(7.08e13, rel=2e-3)
    assert weights.count(cfg) == n_mm + 5120 * 152064 + 21 * 5120 + 10 * (5120 + 2048)
    assert work.adamw_bytes(10) == 10 * (2 + 2 + 16 + 2)


def test_prefill_and_decode_step_work():
    cfg = dict(harness.config_file("yi-34b"), hidden_size=8, vocab_size=10, num_hidden_layers=2,
               num_attention_heads=2, num_key_value_heads=1, head_dim=4, intermediate_size=6)
    fam = harness.family(cfg)
    body = 2 * (8 * 2 * 4 + 2 * 8 * 1 * 4 + 2 * 4 * 8 + 3 * 8 * 6)     # q, k and v, o, the MLP
    assert fam.body_matmul_params(cfg) == body == 672
    nbytes, flops = fam.prefill_work(cfg, 3)
    assert flops == 2 * body * 3 + 4 * 2 * 4 * 6 * 2 + 2 * 8 * 10
    assert nbytes == (body + 80 + 3 * 8 + 2 * 3 * 2 * 1 * 4) * 2
    nbytes, flops = fam.decode_step_work(cfg, 2, 7)
    assert flops == 2 * (body + 80) * 2 + 4 * 2 * 4 * 7 * 2
    assert nbytes == (body + 80 + 2 * 8 + 2 * (7 + 2) * 2 * 4) * 2


def test_kernel_groups():
    assert kernel_group("void flash_fwd_tc2_kernel<128, 128, true>") == "K1"
    assert kernel_group("flash_bwd_dkdv_wg_kernel") == "K1_bwd"
    assert kernel_group("decode_tc_kernel<5, 128>") == "K2"
    assert kernel_group("adamw_kernel") == "adamw"
    assert kernel_group("nvjet_tst_128x256") == "cublas"
    assert kernel_group("void at::native::elementwise_kernel") == "other"


def made_up(cell: str, spans: list[Span], kernels: list[Kernel]) -> Traced:
    man = harness.manifest()
    w = harness.cell_entry(man, cell)
    sp = Spans(True)
    sp.items = spans
    return Traced(harness.config_file(w["config"]), harness.traffic_file(w["traffic"]),
                  harness.cell_file(cell), sp, kernels, 0.0, 1.0, 0.0, 2.0)


def test_busy_and_gaps_merge_overlaps_and_clip():
    ks = [Kernel("a", -0.1, 0.2), Kernel("b", 0.1, 0.3), Kernel("c", 0.5, 0.6), Kernel("d", 0.9, 1.5)]
    assert busy_s(ks, 0.0, 1.0) == pytest.approx(0.3 + 0.1 + 0.1)
    assert idle_gaps(ks, 0.0, 1.0) == [(0.3, 0.5), (0.6, 0.9)]
    spans = [Span("engine.step", 0.0, 1.0, 1), Span("prefill", 0.25, 0.55, 2)]
    assert open_span(spans, 0.4) == "prefill" and open_span(spans, 0.7) == "engine.step"
    assert open_span(spans, 1.5) == "none"


def test_train_readers_on_a_made_up_slice():
    cfg = harness.config_file("yi-34b.l10")
    steps = [Span("step", 0.0, 0.4, 1), Span("step", 0.5, 0.9, 1)]
    adamw_s = 2 * work.adamw_bytes(weights.count(cfg)) / work.PEAK_BYTES_S / 0.8
    kernels = [Kernel("adamw_kernel", 0.1, 0.1 + adamw_s), Kernel("x", 0.5, 0.6)]
    tr = made_up("yi-34b.train.s2048", steps, kernels)
    read = lambda name: harness.metric_module(name).read(tr)  # noqa: E731
    assert read("adamw_roofline.train") == pytest.approx(80.0)
    assert read("optimizer_ms.train") == pytest.approx(adamw_s / 2 * 1e3)
    assert read("k1_bwd_roofline.train") is None           # no K1 backward kernel in the slice
    flops = harness.family(cfg).train_flops(cfg, 1, 2048)
    assert read("mfu.train") == pytest.approx(flops / (989e12 * 0.4) * 100)
    assert read("idle_share.train") == pytest.approx(100 * (1 - adamw_s - 0.1))


def test_serving_readers_on_a_made_up_slice():
    cfg = harness.config_file("yi-34b")
    spans = [Span("engine.step", 0.0, 0.5, 1), Span("prefill", 0.0, 0.2, 2, {"S": 1000}),
             Span("decode", 0.3, 0.5, 2, {"live": 4, "rows": 4000}),
             Span("engine.step", 0.5, 0.7, 1), Span("decode", 0.5, 0.7, 2, {"live": 0, "rows": 0})]
    tr = made_up("yi-34b.serve.rag", spans, [Kernel("flash_fwd_kernel", 0.0, 0.01)])
    read = lambda name: harness.metric_module(name).read(tr)  # noqa: E731
    assert read("admission_share.rag") == pytest.approx(0.2 / 2.0 * 100)
    k1 = work.bound_s(*work.flash_work(1, 56, 8, 1000, 1000, 128, work.causal_pairs(1000)))
    assert read("k1_roofline.prefill_rag") == pytest.approx(60 * k1 / 0.01 * 100)
    fam = harness.family(cfg)
    dec = work.bound_s(*fam.decode_step_work(cfg, 4, 4000))
    assert read("mfu.decode_rag") == pytest.approx(dec / 0.2 * 100)
    assert read("mfu.prefill_rag") == pytest.approx(
        work.bound_s(*fam.prefill_work(cfg, 1000)) / 0.2 * 100)
