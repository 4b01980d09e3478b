"""Mode ``train``: the port's training step as its launcher builds it
(``repro_torch.launch.train.Trainer``: ``make_train_step``, AdamW, the
traffic's remat policy, no checkpoints), fed token batches that the benchmark
draws from the seed.

Set-up builds the Trainer, hands it the benchmark's weights, and drives the
same step object through the checked steps on the window's own feed; it
keeps each step's loss, each leaf's first gradient (from AdamW's first
moment after one step, m = (1 - b1) g) and each leaf's change over the
checked steps (against the first weights, made again from the seed).  The
window then runs the same object on until ``--seconds`` have passed, each
step ending in a sync (the loss read back).  After the window the program's
state is freed and the reference trains the same batches from the same
weights.
"""
from __future__ import annotations

import gc
import time

from chipbench import judge, weights
from chipbench import traffic as tr
from chipbench.harness import port_config, reference
from chipbench.trace import DeviceSlice, Spans, Traced

NORM_CHUNK = 1 << 26


def diff_norm(torch, a, b) -> float:
    """Norm of a - b in float32, a slice at a time."""
    fa, fb = a.detach().reshape(-1), b.detach().reshape(-1)
    total = torch.zeros((), dtype=torch.float64, device=fa.device)
    for i in range(0, fa.numel(), NORM_CHUNK):
        d = fa[i:i + NORM_CHUNK].float() - fb[i:i + NORM_CHUNK].float()
        total += torch.linalg.vector_norm(d).double() ** 2
    return float(total.sqrt())


def change_norms(torch, cfgj: dict, seed: int, device, tree: dict) -> dict:
    return {weights.path_name(path): diff_norm(torch, weights.get_leaf(tree, path), p0)
            for path, p0 in weights.initial_leaves(cfgj, seed, device)}


def reference_readings(ctx, batches: list, *, precision: str = "fp32",
                       half_batch: bool = False) -> dict:
    """The reference's losses, first gradients and changes over ``batches``
    from the benchmark's first weights."""
    torch = ctx.torch
    params = weights.make_params(ctx.cfgj, ctx.seed, ctx.device)
    out = reference(ctx.cfgj, precision).train_steps(
        params, batches, ctx.traffic["adamw"], half_batch=half_batch)
    out["change_norms"] = change_norms(torch, ctx.cfgj, ctx.seed, ctx.device, params)
    del params
    gc.collect()
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    return out


def run(ctx) -> dict:
    torch = ctx.torch
    from repro_torch.launch.train import Trainer, parse_args
    from repro_torch.training.train_step import init_state

    T, cfgj = ctx.traffic, ctx.cfgj
    B, S, V = T["batch"], T["seq"], cfgj["vocab_size"]
    b1 = T["adamw"]["b1"]
    cuda = ctx.device.type == "cuda"
    args = parse_args(["--arch", cfgj["port_arch"], "--batch", str(B), "--seq", str(S),
                       "--optimizer", T["optimizer"], "--remat", T["remat"],
                       "--ckpt-every", "0", "--ckpt-dir", str(ctx.scratch / "train_ckpt"),
                       "--seed", str(ctx.seed), "--device", str(ctx.device)])
    trainer = Trainer(args, cfg=port_config(cfgj))
    step_fn = trainer.step_fn
    spans = Spans(ctx.trace, sync=(lambda: torch.cuda.synchronize(ctx.device)) if cuda else None)
    spans.wrap(trainer.step_fn.model, "forward", "forward")

    def batch_at(i: int) -> dict:
        return tr.train_batch(ctx.seed, i, B, S, V)

    state = init_state(weights.make_params(cfgj, ctx.seed, ctx.device), trainer.optimizer)
    ctx.mark("weights")
    checked = T["checked_steps"]
    prog = {"losses": [], "grad_norms": {}}
    for i in range(checked):
        state, m = step_fn(state, batch_at(i))
        prog["losses"].append(float(m["loss"]))
        if i == 0:
            prog["grad_norms"] = {
                weights.path_name(path): float(torch.linalg.vector_norm(
                    weights.get_leaf(state["opt"]["m"], path))) / (1.0 - b1)
                for path, *_ in weights.leaf_specs(cfgj)}
    ctx.mark("checked_steps")
    prog["change_norms"] = change_norms(torch, cfgj, ctx.seed, ctx.device, state["params"])
    ctx.mark("change_norms")
    setup_s = ctx.clock.since_start()

    # ---- the window ----
    sl = ctx.cell["trace_slice"]
    dslice = DeviceSlice(torch, ctx.device) if ctx.trace else None
    n, step = 0, checked
    t0 = time.perf_counter()
    while True:
        if dslice is not None and n == sl["start_step"]:
            dslice.start()
        with spans.span("data"):
            batch = batch_at(step)
        with spans.span("step", sync=True):
            state, m = step_fn(state, batch)
            float(m["loss"])
        n += 1
        step += 1
        if dslice is not None and n == sl["start_step"] + sl["steps"]:
            dslice.stop()
        if time.perf_counter() - t0 >= ctx.seconds:
            break
    t1 = time.perf_counter()
    if dslice is not None and dslice.t_start is not None and dslice.t_stop is None:
        dslice.stop()
    ctx.read_device()

    traced = None
    if dslice is not None and dslice.t_start is not None:
        traced = Traced(cfgj, T, ctx.cell, spans, dslice.kernels(), dslice.t_start,
                        dslice.t_stop, t0, t1)
    del state, m, trainer, step_fn, batch
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    batches = [batch_at(i) for i in range(checked)]
    ref = reference_readings(ctx, batches)
    numbers = judge.train_numbers(prog, ref)
    return {"metrics": {"train_tokens_per_s": n * B * S / (t1 - t0), "setup_s": setup_s},
            "attempted": n, "failed": 0, "numbers": numbers,
            "checks": judge.checks(numbers, ctx.cell["limits"]), "traced": traced,
            "sample": {"batches": batches, "reference": ref}}


def controls(ctx, sample: dict) -> dict:
    """The numbers compared, with the reference in the program's place over
    the run's checked batches: in float8 (the control) and with half of
    the batch left out (a fault)."""
    return {label: judge.train_numbers(reference_readings(ctx, sample["batches"], **kw),
                                       sample["reference"])
            for label, kw in (("fp8", {"precision": "fp8"}), ("half_batch", {"half_batch": True}))}
