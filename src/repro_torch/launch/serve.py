"""Serving launcher: continuous batching over a request stream with SLO
accounting (counterpart of ``repro/launch/serve.py``).

Runs on the CUDA device unless ``--device cpu`` is given, and raises where
there is no card.  ``--tiny`` (the default) serves the reduced config;
``--full`` (or ``--no-tiny``) serves the published one.  In the reference
``--tiny`` is ``store_true`` with ``default=True`` and so can never be turned
off; here it is a real switch.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch phi4-mini-3.8b --full \
        --requests 12 --slots 8 --cache-len 2048 --max-new 32 --prompt-len 1024
    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma-7b --device cpu
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import ARCH_IDS, get_config, get_tiny_config
from repro_torch.models import Model
from repro_torch.serving import Request, ServingEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma-7b", choices=list(ARCH_IDS))
    ap.add_argument("--tiny", action=argparse.BooleanOptionalAction, default=True,
                    help="serve the reduced config (default); --no-tiny serves the full one")
    ap.add_argument("--full", dest="tiny", action="store_false",
                    help="serve the full published config (same as --no-tiny)")
    ap.add_argument("--device", default=None,
                    help="torch device; default: the CUDA device (an error if there is none)")
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--cache-len", type=int, default=256)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--prompt-len", type=int, default=24)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ttft-slo-ms", type=float, default=None)
    args = ap.parse_args(argv)

    cfg = get_tiny_config(args.arch) if args.tiny else get_config(args.arch)
    model = Model(cfg, args.device)
    params = model.init(torch.Generator(device=model.device).manual_seed(args.seed))
    engine = ServingEngine(cfg, params, slots=args.slots, cache_len=args.cache_len,
                           device=model.device)

    rng = np.random.default_rng(args.seed)
    t0 = time.perf_counter()
    for rid in range(args.requests):
        plen = int(rng.integers(4, args.prompt_len))
        prompt = rng.integers(0, cfg.vocab_size, plen).tolist()
        engine.submit(Request(rid=rid, prompt=prompt, max_new_tokens=args.max_new))
    finished = engine.run_until_drained()
    if model.device.type == "cuda":
        torch.cuda.synchronize(model.device)
    wall = time.perf_counter() - t0

    toks = sum(len(r.tokens) for r in finished)
    ttfts = [r.ttft_s * 1e3 for r in finished if r.ttft_s is not None]
    print(f"[{cfg.name} on {model.device}] served {len(finished)}/{args.requests} requests, "
          f"{toks} tokens, {wall*1e3:.0f} ms wall ({toks/wall:.1f} tok/s)")
    print(f"TTFT ms: p50={np.percentile(ttfts, 50):.1f} "
          f"p95={np.percentile(ttfts, 95):.1f} max={max(ttfts):.1f}")
    if args.ttft_slo_ms is not None:
        ok = sum(t <= args.ttft_slo_ms for t in ttfts)
        print(f"TTFT SLO {args.ttft_slo_ms} ms: {ok}/{len(ttfts)} met")
    return finished


if __name__ == "__main__":
    main()
