"""A run of each mode on the CPU at a small size, without the look for a
card, with the timed path broken underneath: ``correct`` has to come out
false, once for each fault the cell can have (a step that returns its state
unchanged; half of the batch left out, the mean taken over the rest; a
token altered where it is produced; one chip, so no exchange to leave out).
And the control, the reference in float8 in the program's place, has to
fail the cell's limits too.  The limits are the cells' own."""
from __future__ import annotations

import copy
import time

import pytest
import torch

from chipbench import harness, judge, weights

SMALL = dict(hidden_size=128, intermediate_size=256, num_attention_heads=4, num_key_value_heads=2,
             head_dim=32, num_hidden_layers=2, vocab_size=2048)
SEED = 2**31 + 4242


class StepClock:
    """A clock that moves 10 ms at every reading: a serving window is then a
    fixed number of engine steps, whatever the speed of the machine."""

    def __init__(self):
        self.t = 1000.0

    def __call__(self) -> float:
        self.t += 0.01
        return self.t


def small_run(cell: str, monkeypatch):
    monkeypatch.setattr(weights, "CHUNK", 1 << 14)
    man = harness.manifest()
    entry = harness.cell_entry(man, cell)
    T = copy.deepcopy(harness.traffic_file(entry["traffic"]))
    C = copy.deepcopy(harness.cell_file(cell))
    if T["kind"] == "train":
        T["seq"] = 64
    else:
        monkeypatch.setattr(time, "perf_counter", StepClock())
        T["prompt"].update(lo=8, hi=48, median=20)
        T["output"].update(lo=16, hi=48, median=24)
        T["rate_rps"] = 20.0
        C["engine"].update(slots=4, cache_len=96, warmup_step=16)
        C["drain_s"] = 30
        C["check"]["requests"] = 16
    cfg = dict(harness.config_file(entry["config"]), **SMALL)
    ctx = harness.Ctx(name=cell, man=man, seed=SEED, seconds=1.0, trace=False, torch=torch,
                      device=torch.device("cpu"), clock=harness.Clock(), config=cfg, traffic=T,
                      cell=C)
    ctx.scratch = harness.CACHE / "test_scratch"
    mode = harness.mode_module(C["mode"])
    return ctx, mode, mode.run(ctx)


def break_trainer(monkeypatch, fault) -> None:
    """The port's Trainer, its step broken by ``fault`` (the step keeps its
    model, which the mode's spans wrap)."""
    import repro_torch.launch.train as launch

    class Broken(launch.Trainer):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            broken = fault(self.step_fn)
            broken.model = self.step_fn.model
            self.step_fn = broken
    monkeypatch.setattr(launch, "Trainer", Broken)


def break_engine(monkeypatch, fault) -> None:
    """The port's ServingEngine, broken by ``fault`` once it is built."""
    import repro_torch.serving as serving

    class Broken(serving.ServingEngine):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            fault(self)
    monkeypatch.setattr(serving, "ServingEngine", Broken)


TRAIN = [w["name"] for w in harness.manifest()["workloads"]
         if harness.cell_file(w["name"])["mode"] == "train"]
SERVE = [w["name"] for w in harness.manifest()["workloads"]
         if harness.cell_file(w["name"])["mode"] != "train"]


def unchanged_state(step):
    from repro_torch.training.train_step import make_loss_fn
    loss_fn = make_loss_fn(step.model)

    def broken(state, batch):
        with torch.no_grad():
            loss, metrics = loss_fn(state["params"], batch)
        return state, {"loss": loss.detach(), "grad_norm": loss.detach()}
    return broken


def half_batch(step):
    def broken(state, batch):
        labels = batch["labels"].copy()
        labels[:, labels.shape[1] // 2:] = -1
        return step(state, dict(batch, labels=labels))
    return broken


def altered_token(engine):
    model, calls = engine.model, [0]
    decode = model.decode_step

    def broken(params, cache, batch):
        logits, cache = decode(params, cache, batch)
        calls[0] += 1
        if calls[0] == 5:
            logits = logits.roll(1, dims=-1)
        return logits, cache
    model.decode_step = broken


@pytest.mark.parametrize("fault", [unchanged_state, half_batch], ids=lambda f: f.__name__)
@pytest.mark.parametrize("cell", TRAIN)
def test_a_broken_train_step_is_not_correct(cell, fault, monkeypatch):
    break_trainer(monkeypatch, fault)
    _, _, out = small_run(cell, monkeypatch)
    assert not judge.all_within(out["checks"]), out["numbers"]


@pytest.mark.parametrize("cell", SERVE)
def test_an_altered_token_is_not_correct(cell, monkeypatch):
    break_engine(monkeypatch, altered_token)
    _, _, out = small_run(cell, monkeypatch)
    assert not judge.all_within(out["checks"]), out["numbers"]


@pytest.mark.parametrize("cell", TRAIN + SERVE)
def test_the_float8_control_is_not_correct(cell, monkeypatch):
    ctx, mode, out = small_run(cell, monkeypatch)
    assert judge.all_within(out["checks"]), out["numbers"]
    control = mode.controls(ctx, out["sample"])["fp8"]
    limits = harness.cell_file(cell)["limits"]
    assert not judge.all_within(judge.checks(control, limits)), control
