"""The knee of an open-loop serving cell: its window at each of several
rates, one after the other on one engine, in one process.

    python3 chipbench/knee.py --workload yi-34b.serve.rag --seed 7 --seconds 40 \\
        --rates 2.5,3,3.5,4,4.5

One JSON line a rate: requests due, the queue when the window closed, the
drain's seconds, TTFT p90 and ITL p95.  The knee is the highest rate at which
the queue does not grow through the window; the cell's traffic file holds
its rate as a number, found once by this sweep.  The benchmark's own runs
never run this.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from chipbench import harness  # noqa: E402
from chipbench import traffic as tr  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--rates", required=True, help="comma-separated requests a second")
    args = ap.parse_args(argv)
    harness.set_cache_env()
    import torch
    if not torch.cuda.is_available():
        print("chipbench knee: no CUDA device", file=sys.stderr)
        return 2
    from chipbench.serving import Served
    window = harness.mode_module("serve_open").window
    ctx = harness.Ctx(name=args.workload, man=harness.manifest(), seed=args.seed,
                      seconds=args.seconds, trace=False, torch=torch,
                      device=torch.device("cuda", 0), clock=harness.Clock())
    sv = Served(ctx)
    sv.warm_up()
    for rate in (float(r) for r in args.rates.split(",")):
        reqs = tr.open_requests(dict(ctx.traffic, rate_rps=rate), args.seed, args.seconds,
                                ctx.cfgj["vocab_size"])
        sv.engine.finished.clear()
        sv.times.clear()
        w = window(sv, reqs, args.seconds)
        print(json.dumps({"rate_rps": rate, "ttft_p90_ms": w["ttft_p90_ms"],
                          "itl_p95_ms": w["itl_p95_ms"], "failed": w["failed"], **w["numbers"]}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
