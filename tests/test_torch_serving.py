"""The port's serving engine: twins of the reference's engine tests, and the
port's engine against the reference's engine with weights carried across
(greedy tokens must be equal, also across a wrap of the ring cache)."""
import jax
import numpy as np
import pytest
import torch

from repro.configs import get_tiny_config as j_tiny
from repro.models import Model as JModel
from repro.serving import Request as JRequest, ServingEngine as JEngine
from repro_torch.configs import get_tiny_config as t_tiny
from repro_torch.convert import from_reference_params
from repro_torch.launch import serve
from repro_torch.models import Model
from repro_torch.serving import Request, ServingEngine, VirtualClock

PROMPTS = [[1, 2, 3, 4], [9, 8, 7], [5, 5, 5, 5, 5]]  # 3 requests, 2 slots


def _tiny_engine(**kw):
    cfg = t_tiny("gemma-7b")
    model = Model(cfg, "cpu")
    params = model.init(torch.Generator().manual_seed(0))
    return cfg, model, params, ServingEngine(cfg, params, slots=2, cache_len=64, device="cpu", **kw)


def test_serving_engine_continuous_batching_matches_sequential():
    cfg, model, params, eng = _tiny_engine()
    for i, p in enumerate(PROMPTS):
        eng.submit(Request(rid=i, prompt=p, max_new_tokens=5))
    finished = eng.run_until_drained(max_steps=200)
    assert len(finished) == 3
    # sequential reference for request 0
    req = finished[[r.rid for r in finished].index(0)]
    out = []
    logits, cache = model.prefill(params, {"tokens": [PROMPTS[0]]}, cache_len=64)
    tok = int(torch.argmax(logits[0, -1]))
    out.append(tok)
    for _ in range(4):
        logits, cache = model.decode_step(params, cache, {"tokens": [[tok]]})
        tok = int(torch.argmax(logits[0, 0]))
        out.append(tok)
    assert req.tokens == out


def test_serving_engine_virtual_clock_trace_replay():
    """Caller-supplied arrival_s (including 0.0) is honored and TTFT is
    computed on the injected clock's timebase, not wall-clock."""
    clk = VirtualClock()
    *_, eng = _tiny_engine(clock=clk)
    traced = Request(rid=0, prompt=[1, 2, 3], max_new_tokens=2, arrival_s=0.0)
    eng.submit(traced)
    assert traced.arrival_s == 0.0
    stamped = Request(rid=1, prompt=[4, 5], max_new_tokens=2)
    clk.advance_to(0.125)
    eng.submit(stamped)
    assert stamped.arrival_s == 0.125       # engine stamps via the clock
    clk.advance_to(0.25)
    finished = eng.run_until_drained(max_steps=50)
    assert len(finished) == 2
    by_rid = {r.rid: r for r in finished}
    assert by_rid[0].ttft_s == pytest.approx(0.25)   # prefill at t=0.25
    assert by_rid[1].ttft_s == pytest.approx(0.125)
    with pytest.raises(ValueError):
        clk.advance_to(0.1)


@pytest.mark.parametrize("arch", ["phi4-mini-3.8b", "gemma-7b"])
@pytest.mark.parametrize("cache_len", [64, 8])      # 8: positions reach 9, so pos % T wraps
def test_engine_tokens_equal_the_reference_engine(arch, cache_len):
    cj = j_tiny(arch).replace(dtype="float32", param_dtype="float32")
    ct = t_tiny(arch).replace(dtype="float32", param_dtype="float32")
    pj = JModel(cj).init(jax.random.PRNGKey(0))
    pt = from_reference_params(jax.tree.map(np.asarray, pj), ct, "cpu")
    je = JEngine(cj, pj, slots=2, cache_len=cache_len)
    te = ServingEngine(ct, pt, slots=2, cache_len=cache_len, device="cpu")
    for i, p in enumerate(PROMPTS):
        je.submit(JRequest(rid=i, prompt=p, max_new_tokens=5))
        te.submit(Request(rid=i, prompt=p, max_new_tokens=5))
    want = {r.rid: r.tokens for r in je.run_until_drained(max_steps=200)}
    got = {r.rid: r.tokens for r in te.run_until_drained(max_steps=200)}
    assert len(got) == 3 and all(len(t) == 5 for t in got.values())
    assert got == want
    assert [r.slot for r in sorted(te.finished, key=lambda r: r.rid)] == \
           [r.slot for r in sorted(je.finished, key=lambda r: r.rid)]


def test_engine_rejects_a_prompt_longer_than_the_cache():
    *_, eng = _tiny_engine()
    eng.cache_len = 4
    eng.submit(Request(rid=0, prompt=[1, 2, 3, 4, 5], max_new_tokens=2))
    with pytest.raises(ValueError):
        eng.step()


def test_launch_serve_runs_on_the_cpu_when_asked(capsys):
    finished = serve.main(["--device", "cpu", "--requests", "3", "--slots", "2",
                           "--max-new", "4", "--arch", "phi4-mini-3.8b"])
    assert len(finished) == 3 and all(len(r.tokens) == 4 for r in finished)
    out = capsys.readouterr().out
    assert "phi4-mini-tiny on cpu" in out and "served 3/3" in out


@pytest.mark.parametrize("flags,tiny", [([], True), (["--tiny"], True), (["--full"], False),
                                        (["--no-tiny"], False)])
def test_launch_serve_tiny_is_a_real_switch(flags, tiny, monkeypatch):
    """In the reference --tiny can never be turned off; here --full / --no-tiny
    ask for the published config (seen through which config getter runs)."""
    asked = []
    monkeypatch.setattr(serve, "get_config", lambda a: asked.append("full") or t_tiny(a))
    monkeypatch.setattr(serve, "get_tiny_config", lambda a: asked.append("tiny") or t_tiny(a))
    serve.main(["--device", "cpu", "--requests", "1", "--max-new", "2", *flags])
    assert asked == ["tiny" if tiny else "full"]
