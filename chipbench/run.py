"""The port's benchmark: one run of one cell.

    python3 chipbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Runs from the root of a checkout on a machine with an NVIDIA card (the
cell's ``chips`` of them), and drives the PyTorch and CUDA port
(``src/repro_torch``) only.  The cell's mode (``modes/<mode>.py``) sets up,
measures for ``--seconds``, and checks what the window produced against the
plain reference.  The last line of standard output is one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's end-to-end
metrics with ``--trace 0``, its per-layer metrics with ``--trace 1``),
``device``, traced ``breakdown``, and ``setup``: the seconds from the
process's start at which each part of set-up ended, and the kernels' build
(``kernels_build_s``, 0 where the checkout had them).  ``setup_s`` counts
the build, as it counts all set-up: only a checkout's first run builds.
``checks``, the numbers compared beside their limits, comes last, and the
same numbers end standard error.

Exits with another code than 0 and prints no result where there is no card
(or fewer than the cell asks for), or where the JAX package or JAX has been
loaded into the process.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from chipbench import harness, judge  # noqa: E402


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def per_layer(man: dict, cell: str, traced) -> dict:
    out = {}
    for m in harness.per_layer_for(man, cell):
        value = harness.metric_module(m["name"]).read(traced) if traced is not None else None
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def main(argv=None) -> int:
    clock = harness.Clock()
    args = parse(argv)
    man = harness.manifest()
    entry = harness.cell_entry(man, args.workload)
    harness.set_cache_env()
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < entry["chips"]:
        print(f"chipbench: {args.workload} needs {entry['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    from repro_torch.kernels import _build
    _build.build_all()
    print(f"chipbench: kernels built in {_build.build_seconds:.3f} s "
          f"(0 where the checkout had them)", file=sys.stderr)
    ctx = harness.Ctx(name=args.workload, man=man, seed=args.seed, seconds=args.seconds,
                      trace=bool(args.trace), torch=torch, device=device, clock=clock)
    ctx.mark("kernels")
    out = harness.mode_module(ctx.cell["mode"]).run(ctx)

    if args.trace:
        metrics = per_layer(man, args.workload, out["traced"])
    else:
        metrics = {m["name"]: {"value": out["metrics"][m["name"]], "unit": m["unit"]}
                   for m in harness.end_to_end_for(man, args.workload)}
    dev = dict(ctx.device_record)
    breakdown = None
    if args.trace:
        tr = out["traced"]
        from chipbench.trace import busy_s
        dev["busy_s"] = busy_s(tr.kernels, tr.slice_t0, tr.slice_t1)
        dev["window_s"] = tr.slice_t1 - tr.slice_t0
        breakdown = tr.breakdown()
    bad = harness.forbidden_loaded()
    if bad:
        print(f"chipbench: the run loaded {', '.join(bad)}; no result", file=sys.stderr)
        return 3
    print(f"chipbench: {harness.card_power()}; set-up marks {ctx.marks}; "
          f"numbers {out['numbers']}", file=sys.stderr)
    setup = dict(ctx.marks, kernels_build_s=_build.build_seconds)
    print(harness.result_line(correct=judge.all_within(out["checks"]),
                              attempted=out["attempted"], failed=out["failed"], metrics=metrics,
                              device=dev, checks=out["checks"], breakdown=breakdown,
                              setup=setup), flush=True)
    for line in harness.checks_lines(out["checks"]):
        print(line, file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
