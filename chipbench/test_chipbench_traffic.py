"""The traffic generator: the same seed gives the same inputs, another seed
another order of the same sizes, and seeds past 32 bits work."""
from __future__ import annotations

import bisect

import numpy as np
import pytest

from chipbench import harness
from chipbench import traffic as tr

BIG = 2**31 + 987_654


def test_train_batches_repeat_for_a_seed_and_differ_across_seeds_and_steps():
    a = tr.train_batch(BIG, 3, 1, 2048, 152064)
    assert a["tokens"].shape == (1, 2048) and a["labels"].shape == (1, 2048)
    np.testing.assert_array_equal(a["tokens"], tr.train_batch(BIG, 3, 1, 2048, 152064)["tokens"])
    np.testing.assert_array_equal(a["tokens"][0, 1:], a["labels"][0, :-1])
    assert not np.array_equal(a["tokens"], tr.train_batch(BIG + 1, 3, 1, 2048, 152064)["tokens"])
    assert not np.array_equal(a["tokens"], tr.train_batch(BIG, 4, 1, 2048, 152064)["tokens"])


def test_train_batches_are_the_pipelines_arithmetic():
    """The frozen copy draws what ``training/data.py`` draws."""
    from repro_torch.configs import get_tiny_config
    from repro_torch.training.data import SyntheticTokenPipeline
    cfg = get_tiny_config("yi-34b")
    pipe = SyntheticTokenPipeline(cfg, global_batch=2, seq_len=16, seed=11)
    try:
        for step in range(2):
            want = next(pipe)
            got = tr.train_batch(11, step, 2, 16, cfg.vocab_size)
            np.testing.assert_array_equal(got["tokens"], want["tokens"])
            np.testing.assert_array_equal(got["labels"], want["labels"])
    finally:
        pipe.close()


def test_open_loop_same_seed_same_requests_other_seed_same_sizes_in_another_order():
    t = harness.traffic_file("rag")
    a = tr.open_requests(t, BIG, 40, 64000)
    assert len(a) == round(t["rate_rps"] * 40)
    assert a == tr.open_requests(t, BIG, 40, 64000)
    b = tr.open_requests(t, BIG + 1, 40, 64000)
    assert [r.max_new_tokens for r in a] != [r.max_new_tokens for r in b]
    assert [len(r.prompt) for r in a] != [len(r.prompt) for r in b]
    assert sorted(len(r.prompt) for r in a) == sorted(len(r.prompt) for r in b)
    assert sorted(r.max_new_tokens for r in a) == sorted(r.max_new_tokens for r in b)
    gaps = lambda rs: [y.due_s - x.due_s for x, y in zip(rs, rs[1:])]  # noqa: E731
    assert gaps(a) != gaps(b)
    assert sorted(gaps(a) + [a[0].due_s]) == pytest.approx(sorted(gaps(b) + [b[0].due_s]))
    assert a[-1].due_s == pytest.approx(b[-1].due_s) == pytest.approx(len(a) / t["rate_rps"])
    assert all(t["prompt"]["lo"] <= len(r.prompt) <= t["prompt"]["hi"] for r in a)
    assert all(0 <= x < 64000 for r in a for x in r.prompt)


def busiest(due: list[float], width: float) -> int:
    """The most arrivals in any stretch of ``width`` seconds."""
    return max(bisect.bisect_right(due, t + width) - i for i, t in enumerate(due))


def test_open_loop_arrivals_bunch_as_poisson_arrivals_do():
    """The busiest 2 s of a window hold as many arrivals as a Poisson
    process's do (given the count, its arrival times are sorted uniform
    draws; an evened-out schedule's busiest stretch holds fewer), and a
    seed's lengths fall independently of its gaps."""
    t = harness.traffic_file("rag")
    n = round(t["rate_rps"] * 50)
    rng = np.random.default_rng(5)
    poisson = np.mean([busiest(sorted(rng.uniform(0, 50, n)), 2.0) for _ in range(400)])
    ours, corr = [], []
    for seed in range(BIG, BIG + 100):
        reqs = tr.open_requests(t, seed, 50, 64000)
        ours.append(busiest([r.due_s for r in reqs], 2.0))
        g = np.diff([0.0] + [r.due_s for r in reqs])
        corr.append(np.corrcoef(g, [len(r.prompt) for r in reqs])[0, 1])
    assert abs(np.mean(ours) - poisson) < 0.5 and np.std(ours) > 0.5
    assert abs(np.mean(corr)) < 0.05


def test_lognormal_quantiles_follow_the_median():
    spec = {"median": 768, "sigma": 0.6, "lo": 128, "hi": 1920}
    xs = tr.lognormal_lengths(spec, 101)
    assert xs == sorted(xs) and xs[50] == 768 and xs[0] >= 128 and xs[-1] <= 1920
    gaps = tr.exponential_gaps(3.0, 120)
    assert sum(gaps) == pytest.approx(40.0)


def test_warmup_lengths_cover_the_range():
    assert tr.warmup_lengths({"lo": 32, "hi": 512}, 32)[::15] == [32, 512]
