"""The control and the planted faults of a cell, on the card at the cell's
own size: the readings that its limits are set from.

    python3 chipbench/control.py --workload <cell> --seeds 11,12,13 --seconds 20

For each seed, one run of the cell's mode (a short window at the cell's own
load), then its mode's ``controls`` over what that run checked: the
reference in float8 in the program's place (the control) and, for a train
cell, the reference with half of the batch left out.  One JSON line a seed:
the program's numbers and each of theirs.  The benchmark's own runs never
run this.
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from chipbench import harness  # noqa: E402


def main(argv=None) -> int:
    clock = harness.Clock()
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    harness.set_cache_env()
    import torch
    if not torch.cuda.is_available():
        print("chipbench control: no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    man = harness.manifest()
    for seed in (int(s) for s in args.seeds.split(",")):
        ctx = harness.Ctx(name=args.workload, man=man, seed=seed, seconds=args.seconds,
                          trace=False, torch=torch, device=device, clock=clock)
        mode = harness.mode_module(ctx.cell["mode"])
        out = mode.run(ctx)
        rec = {"workload": args.workload, "seed": seed, "program": out["numbers"],
               "metrics": out["metrics"], "peak": ctx.device_record["memory_peak_bytes"]}
        rec.update({f"control_{k}": v for k, v in mode.controls(ctx, out["sample"]).items()})
        print(json.dumps(rec), flush=True)
        del out, ctx
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
