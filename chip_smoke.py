#!/usr/bin/env python3
"""Drives the PyTorch/CUDA port's serving path on one NVIDIA GPU.

    python3 chip_smoke.py                 # every phase; what a check of the port runs
    python3 chip_smoke.py --phases env,build,kernels --ptxas   # a new kernel's first run

Phases, each printing one JSON object on a line of its own:

  env      versions, compiler, GPU name and power limit; exits non-zero if
           there is no CUDA device (there is no CPU carry-on)
  build    compiles src/repro_torch/kernels/csrc/*.cu with nvcc (one process
           a source, started together); seconds taken
  kernels  every kernel against its plain PyTorch version on the card, at the
           shapes the serving path gives it and at edge shapes, in float32
           (tolerance 2e-5: another order of summation) and bfloat16 (2e-2),
           with times from CUDA events
  serve    phi4-mini-3.8b at full width and depth, random weights from a
           seed, ServingEngine(slots=8, cache_len=2048), 12 requests of 16 to
           1024 prompt tokens and 32 new tokens each; checks the tokens, the
           logits and that the launch counts are exactly what the path implies
  parity   the same model cut to 4 layers, the same requests, once through
           the kernels and once through their plain versions

Then one line {"kernels": [...]} with, for each kernel of the serving path,
its launches in the serve phase, error, time, plain version's time, bound and
the time of the one PyTorch call that computes the same function; then the
GPU's name and power limit as nvidia-smi prints them; then, last,
{"ok": true, "device": {...}}.  Any failing phase ends the run with a
non-zero exit code and no last line.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))

import numpy as np
import torch
import torch.nn.functional as F

# Published peaks of one H100 SXM (dense): device memory rate, bf16 tensor
# cores, fp32 outside the tensor cores.
PEAK_BYTES_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}

TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
ARCH = "phi4-mini-3.8b"
SEED = 0


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def gpu_name_and_power() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# --------------------------------------------------------------------------
# timing and bounds
# --------------------------------------------------------------------------

_flush_buf = None


def time_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Median time of one call in ms, from CUDA events, with the L2 cache
    overwritten before every call (the serving path walks 32 layers of weights
    and caches between two calls of the same kernel, so it finds L2 cold)."""
    global _flush_buf
    if _flush_buf is None:
        _flush_buf = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        _flush_buf.zero_()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def bound(nbytes: float, flops: float, dtype) -> tuple[float, str]:
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def randn(rng, shape, dtype):
    return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).cuda().to(dtype)


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def dt_name(dtype) -> str:
    return str(dtype).replace("torch.", "")


# --------------------------------------------------------------------------
# kernel checks
# --------------------------------------------------------------------------

def visible_pairs(Sq, Sk, causal, window) -> int:
    """Number of (q, k) positions the masks leave, which is what the work of
    this call is proportional to."""
    q = np.arange(Sq)[:, None]
    k = np.arange(Sk)[None, :]
    m = np.ones((Sq, Sk), bool)
    if causal:
        m &= k <= q
    if window > 0:
        m &= k > q - window
    return int(m.sum())


def check_flash(rng, *, B, H, Hkv, Sq, Sk, D, causal, window, dtype, timed, bshd=False):
    from repro_torch.kernels import flash_attention, flash_attention_plain
    if bshd:   # the model's layout: strided views, as the serving path passes them
        q = randn(rng, (B, Sq, H, D), dtype).permute(0, 2, 1, 3)
        k = randn(rng, (B, Sk, Hkv, D), dtype).permute(0, 2, 1, 3)
        v = randn(rng, (B, Sk, Hkv, D), dtype).permute(0, 2, 1, 3)
    else:
        q, k, v = (randn(rng, (B, H, Sq, D), dtype), randn(rng, (B, Hkv, Sk, D), dtype),
                   randn(rng, (B, Hkv, Sk, D), dtype))
    got = flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    want = flash_attention_plain(q, k, v, causal=causal, window=window)
    rec = {"kernel": "flash_attention", "dtype": dt_name(dtype),
           "case": f"B{B} H{H} Hkv{Hkv} Sq{Sq} Sk{Sk} D{D} causal{int(causal)} window{window}"
                   + (" bshd" if bshd else ""),
           "max_abs_err": max_err(got, want), "tol": TOL[dtype]}
    if timed:
        item = q.element_size()
        nbytes = (2 * q.numel() + 2 * k.numel()) * item
        flops = 4.0 * B * H * D * visible_pairs(Sq, Sk, causal, window)
        rec["bound_ms"], rec["bound_by"] = bound(nbytes, flops, dtype)
        rec["ms"] = time_ms(lambda: flash_attention(q, k, v, causal=causal, window=window))
        rec["plain_ms"] = time_ms(
            lambda: flash_attention_plain(q, k, v, causal=causal, window=window), iters=5)
        if window == 0 and (causal is False or Sq == Sk):
            rec["library_ms"] = time_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=causal, enable_gqa=True))
        else:
            rec["library_ms"] = None
    return rec


def check_decode(rng, *, B, H, Hkv, T, D, valid, dtype, timed, bthd=False):
    from repro_torch.kernels import decode_attention, decode_attention_plain
    q = randn(rng, (B, H, D), dtype)
    if bthd:   # the model's cache layout, read through strides
        k = randn(rng, (B, T, Hkv, D), dtype).permute(0, 2, 1, 3)
        v = randn(rng, (B, T, Hkv, D), dtype).permute(0, 2, 1, 3)
    else:
        k, v = randn(rng, (B, Hkv, T, D), dtype), randn(rng, (B, Hkv, T, D), dtype)
    vl = None if valid is None else torch.tensor(valid, dtype=torch.int32, device="cuda")
    got = decode_attention(q, k, v, kv_valid_len=vl)
    torch.cuda.synchronize()
    want = decode_attention_plain(q, k, v, kv_valid_len=vl)
    rec = {"kernel": "decode_attention", "dtype": dt_name(dtype),
           "case": f"B{B} H{H} Hkv{Hkv} T{T} D{D} valid{valid}" + (" bthd" if bthd else ""),
           "max_abs_err": max_err(got, want), "tol": TOL[dtype]}
    if valid is not None and 0 in valid:   # the pinned semantics: a dead row gives 0
        rec["zero_rows_max_abs"] = float(got[[i for i, n in enumerate(valid) if n == 0]]
                                         .float().abs().max())
        if rec["zero_rows_max_abs"] != 0.0:
            fail(f"decode_attention: kv_valid_len=0 must give 0, got {rec}")
    if timed:
        item = q.element_size()
        rows = sum(valid) if valid is not None else B * T     # cache rows this run reads
        nbytes = (2 * rows * Hkv * D + 2 * q.numel()) * item + 4 * B
        flops = 4.0 * H * D * rows
        rec["bound_ms"], rec["bound_by"] = bound(nbytes, flops, dtype)
        rec["ms"] = time_ms(lambda: decode_attention(q, k, v, kv_valid_len=vl))
        rec["plain_ms"] = time_ms(lambda: decode_attention_plain(q, k, v, kv_valid_len=vl), iters=5)
        valid_t = vl if vl is not None else torch.full((B,), T, device="cuda")
        mask = (torch.arange(T, device="cuda")[None, :] < valid_t[:, None])[:, None, None, :]
        rec["library_ms"] = time_ms(lambda: F.scaled_dot_product_attention(
            q[:, :, None, :], k, v, attn_mask=mask, enable_gqa=True))
    return rec


def check_combine(rng, *, B, Hkv, ns, G, D, dtype, timed):
    from repro_torch.kernels import combine_splits, combine_splits_plain
    o = randn(rng, (B, Hkv, ns, G, D), torch.float32)
    m = randn(rng, (B, Hkv, ns, G), torch.float32) * 3.0
    l = randn(rng, (B, Hkv, ns, G), torch.float32).abs() + 0.1
    got = combine_splits(o, m, l, dtype)
    torch.cuda.synchronize()
    want = combine_splits_plain(o, m, l, dtype)
    rec = {"kernel": "decode_combine", "dtype": dt_name(dtype),
           "case": f"B{B} Hkv{Hkv} ns{ns} G{G} D{D}",
           "max_abs_err": max_err(got, want), "tol": TOL[dtype]}
    if timed:
        nbytes = 4 * (o.numel() + m.numel() + l.numel()) + got.numel() * got.element_size()
        flops = 2.0 * o.numel() + 4.0 * m.numel()
        rec["bound_ms"], rec["bound_by"] = bound(nbytes, flops, torch.float32)
        rec["ms"] = time_ms(lambda: combine_splits(o, m, l, dtype))
        rec["plain_ms"] = time_ms(lambda: combine_splits_plain(o, m, l, dtype))
        rec["library_ms"] = None     # no single PyTorch call computes it
    return rec


def check_rmsnorm(rng, *, R, D, dtype, w_dtype, offset, residual, timed):
    from repro_torch.kernels import rmsnorm, rmsnorm_plain
    x = randn(rng, (R, D), dtype)
    w = (randn(rng, (D,), torch.float32) * 0.1 + (0.0 if offset else 1.0)).to(w_dtype)
    r = randn(rng, (R, D), dtype) if residual else None
    got = rmsnorm(x, w, eps=1e-6, offset=offset, residual=r)
    torch.cuda.synchronize()
    want = rmsnorm_plain(x, w, eps=1e-6, offset=offset, residual=r)
    rec = {"kernel": "rmsnorm", "dtype": dt_name(dtype),
           "case": f"R{R} D{D} w:{dt_name(w_dtype)} offset{int(offset)} residual{int(residual)}",
           "max_abs_err": max_err(got, want), "tol": TOL[dtype]}
    if timed:
        nbytes = (2 + int(residual)) * x.numel() * x.element_size() + w.numel() * w.element_size()
        flops = (4.0 + int(residual)) * x.numel()
        rec["bound_ms"], rec["bound_by"] = bound(nbytes, flops, torch.float32)
        rec["ms"] = time_ms(lambda: rmsnorm(x, w, eps=1e-6, offset=offset, residual=r))
        rec["plain_ms"] = time_ms(lambda: rmsnorm_plain(x, w, eps=1e-6, offset=offset, residual=r))
        if not offset and not residual:
            rec["library_ms"] = time_ms(lambda: F.rms_norm(x, (D,), w.to(dtype), 1e-6))
        else:
            rec["library_ms"] = None
    return rec


def phase_kernels():
    """Returns (all records, {kernel name: record at the serving path's shape})."""
    from repro_torch import kernels as K
    from repro_torch.kernels.decode_attention import split_plan
    rng = np.random.default_rng(SEED)
    bf16, f32 = torch.bfloat16, torch.float32
    recs, main = [], {}

    # --- K1 at the serving path's shapes (prefill: B=1, the model's layout) ...
    for S in (64, 1000, 2048):
        for dtype in (bf16, f32):
            recs.append(check_flash(rng, B=1, H=24, Hkv=8, Sq=S, Sk=S, D=128, causal=True,
                                    window=0, dtype=dtype, timed=dtype is bf16, bshd=True))
            if S == 1000 and dtype is bf16:
                main["flash_attention"] = recs[-1]
    # ... and at edge shapes
    for dtype in (bf16, f32):
        edge = [dict(B=2, H=16, Hkv=16, Sq=200, Sk=200, D=256, causal=True, window=0),   # gemma: D=256, G=1
                dict(B=2, H=8, Hkv=1, Sq=192, Sk=192, D=64, causal=True, window=0),      # MQA, G=8, ragged
                dict(B=2, H=4, Hkv=2, Sq=160, Sk=160, D=64, causal=True, window=64),     # sliding window
                dict(B=1, H=4, Hkv=2, Sq=300, Sk=300, D=128, causal=False, window=64),   # window alone
                dict(B=1, H=4, Hkv=1, Sq=128, Sk=256, D=64, causal=False, window=0),     # Sq != Sk
                dict(B=1, H=6, Hkv=2, Sq=70, Sk=33, D=128, causal=True, window=0)]       # rows with no key in range
        for e in edge:
            recs.append(check_flash(rng, **e, dtype=dtype, timed=False))

    # --- K2 at the serving path's shape (8 slots, ring cache of 2048, the model's layout) ...
    mixed = [1, 2048, 17, 1024, 300, 2047, 64, 1500]
    for dtype in (bf16, f32):
        recs.append(check_decode(rng, B=8, H=24, Hkv=8, T=2048, D=128, valid=mixed, dtype=dtype,
                                 timed=dtype is bf16, bthd=True))
        if dtype is bf16:
            main["decode_attention"] = recs[-1]
    recs.append(check_decode(rng, B=8, H=24, Hkv=8, T=2048, D=128, valid=[2048] * 8, dtype=bf16,
                             timed=True, bthd=True))
    # ... and at edge shapes
    for dtype in (bf16, f32):
        recs.append(check_decode(rng, B=2, H=16, Hkv=16, T=300, D=256, valid=[300, 7], dtype=dtype,
                                 timed=False))                                   # D=256, G=1, ragged T
        recs.append(check_decode(rng, B=1, H=8, Hkv=1, T=300, D=64, valid=None, dtype=dtype,
                                 timed=False))                                   # MQA, G=8
        recs.append(check_decode(rng, B=3, H=14, Hkv=2, T=512, D=128, valid=[0, 512, 100],
                                 dtype=dtype, timed=False, bthd=True))           # G=7, a dead row
    ns, _ = split_plan(8, 8, 2048,
                       sm_count=torch.cuda.get_device_properties(0).multi_processor_count)
    for dtype in (bf16, f32):
        recs.append(check_combine(rng, B=8, Hkv=8, ns=ns, G=3, D=128, dtype=dtype,
                                  timed=dtype is bf16))
        if dtype is bf16:
            main["decode_combine"] = recs[-1]
    recs.append(check_combine(rng, B=2, Hkv=3, ns=1, G=8, D=64, dtype=f32, timed=False))

    # --- K3 at the serving path's shapes (R = slots or prompt length, D = 3072) ...
    for R in (8, 1000):
        for dtype, w_dtype in ((bf16, bf16), (f32, f32)):
            recs.append(check_rmsnorm(rng, R=R, D=3072, dtype=dtype, w_dtype=w_dtype, offset=False,
                                      residual=False, timed=dtype is bf16))
            if R == 1000 and dtype is bf16:
                main["rmsnorm"] = recs[-1]
    # ... with the residual inside the kernel, the 1 + w form, fp32 w beside bf16 x, odd rows
    for dtype in (bf16, f32):
        recs.append(check_rmsnorm(rng, R=1000, D=3072, dtype=dtype, w_dtype=dtype, offset=False,
                                  residual=True, timed=dtype is bf16))
        recs.append(check_rmsnorm(rng, R=300, D=3072, dtype=dtype, w_dtype=f32, offset=True,
                                  residual=False, timed=False))
        recs.append(check_rmsnorm(rng, R=1, D=256, dtype=dtype, w_dtype=f32, offset=True,
                                  residual=True, timed=False))
        recs.append(check_rmsnorm(rng, R=300, D=7168, dtype=dtype, w_dtype=dtype, offset=False,
                                  residual=False, timed=False))

    K.reset_launch_counts()
    bad = [r for r in recs if not (r["max_abs_err"] <= r["tol"])]   # a NaN is bad too
    emit({"phase": "kernels", "checks": recs, "failed": len(bad)})
    if bad:
        fail(f"{len(bad)} kernel check(s) over tolerance: {bad}")
    return recs, main


# --------------------------------------------------------------------------
# serving
# --------------------------------------------------------------------------

def make_requests(vocab: int):
    from repro_torch.serving import Request
    rng = np.random.default_rng(SEED)
    reqs = []
    for rid in range(12):
        plen = int(rng.integers(16, 1025))
        reqs.append(Request(rid=rid, prompt=rng.integers(0, vocab, plen).tolist(),
                            max_new_tokens=32))
    return reqs


def run_engine(cfg, params, *, plain: bool):
    """Serve the 12 requests; returns (requests, engine steps, seconds,
    whether every logit was finite)."""
    from repro_torch.serving import ServingEngine
    engine = ServingEngine(cfg, params, slots=8, cache_len=2048, plain_kernels=plain)
    finite = []
    prefill, decode = engine.model.prefill, engine.model.decode_step

    def watched_prefill(p, batch, cache_len):
        logits, cache = prefill(p, batch, cache_len=cache_len)
        finite.append(torch.isfinite(logits).all())
        return logits, cache

    def watched_decode(p, cache, batch):
        logits, cache = decode(p, cache, batch)
        finite.append(torch.isfinite(logits).all())
        return logits, cache

    engine.model.prefill, engine.model.decode_step = watched_prefill, watched_decode
    reqs = make_requests(cfg.vocab_size)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for r in reqs:
        engine.submit(r)
    steps = 0
    while engine.queue or engine.active:
        engine.step()
        steps += 1
        if steps > 10_000:
            fail("the engine did not drain")
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    return reqs, steps, seconds, bool(torch.stack(finite).all())


def phase_serve():
    from repro_torch import kernels as K
    from repro_torch.configs import get_config
    from repro_torch.models import Model, count_params
    cfg = get_config(ARCH)
    model = Model(cfg)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=model.device).manual_seed(SEED))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()

    K.reset_launch_counts()
    reqs, steps, seconds, finite = run_engine(cfg, params, plain=False)
    counts = K.launch_counts()

    L = cfg.num_layers
    norms = 2 * L + 1
    want = {"flash_attention": L * len(reqs), "decode_attention": L * steps,
            "decode_combine": L * steps, "rmsnorm": norms * (len(reqs) + steps)}
    toks = sum(len(r.tokens) for r in reqs)
    ttft = [r.ttft_s * 1e3 for r in reqs]
    rec = {"phase": "serve", "arch": cfg.name, "layers": L, "d_model": cfg.d_model,
           "vocab": cfg.vocab_size, "dtype": cfg.dtype, "params": count_params(cfg),
           "slots": 8, "cache_len": 2048, "requests": len(reqs),
           "prompt_tokens": sum(len(r.prompt) for r in reqs), "new_tokens": toks,
           "engine_steps": steps, "seconds": seconds, "tokens_per_s": toks / seconds,
           "ttft_ms_p50": float(np.percentile(ttft, 50)), "ttft_ms_p95": float(np.percentile(ttft, 95)),
           "init_seconds": init_s, "logits_finite": finite,
           "launches": counts, "launches_expected": want,
           "max_memory_allocated_bytes": torch.cuda.max_memory_allocated()}
    emit(rec)
    if any(len(r.tokens) != 32 or r.finished_s is None for r in reqs):
        fail("a request did not finish with 32 tokens")
    if any(not (0 <= t < cfg.vocab_size) for r in reqs for t in r.tokens):
        fail("a token outside the vocabulary")
    if not finite:
        fail("non-finite logits on the serving path")
    if counts != want:
        fail(f"launch counts {counts} differ from what the path implies {want}")
    del params
    torch.cuda.empty_cache()
    return counts


def phase_profile(out_dir: str):
    """Where a decode step and a prefill spend their time: torch.profiler over
    10 steady decode steps at 8 full slots and over one 512-token prefill.
    Writes the tables by kernel to ``out_dir`` and prints the summary."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    from repro_torch.serving import Request, ServingEngine
    cfg = get_config(ARCH)
    model = Model(cfg)
    params = model.init(torch.Generator(device=model.device).manual_seed(SEED))
    engine = ServingEngine(cfg, params, slots=8, cache_len=2048)
    rng = np.random.default_rng(SEED)
    for rid in range(8):
        engine.submit(Request(rid=rid, prompt=rng.integers(0, cfg.vocab_size, 512).tolist(),
                              max_new_tokens=64))
    for _ in range(5):
        engine.step()
    prompt = {"tokens": [rng.integers(0, cfg.vocab_size, 512).tolist()]}
    model.prefill(params, prompt, cache_len=2048)
    torch.cuda.synchronize()
    os.makedirs(out_dir, exist_ok=True)
    rec = {"phase": "profile"}
    for name, n, fn in (("decode_step", 10, engine.step),
                        ("prefill_512", 3, lambda: model.prefill(params, prompt, cache_len=2048))):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) / n * 1e3
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        avgs = prof.key_averages()
        # kernels and device copies only: a CPU operator's entry repeats its kernels' time
        on_device = [e for e in avgs if e.device_type == torch.autograd.DeviceType.CUDA]
        device_ms = sum(e.self_device_time_total for e in on_device) / n / 1e3
        top = sorted(on_device, key=lambda e: -e.self_device_time_total)[:8]
        rec[name] = {"wall_ms": wall_ms, "device_busy_ms": device_ms,
                     "device_idle_share": max(0.0, 1.0 - device_ms / wall_ms),
                     "device_launches": sum(e.count for e in on_device) // n,
                     "top_device": [[e.key[:60], e.self_device_time_total / n / 1e3, e.count // n]
                                    for e in top]}
        with open(os.path.join(out_dir, f"profile_{name}.txt"), "w") as f:
            f.write(avgs.table(sort_by="self_cuda_time_total", row_limit=40, max_name_column_width=80))
            f.write("\n\n")
            f.write(avgs.table(sort_by="self_cpu_time_total", row_limit=40, max_name_column_width=80))
    emit(rec)
    del params
    torch.cuda.empty_cache()


def phase_parity():
    """4 layers of the same model: kernels against their plain versions."""
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    cfg = get_config(ARCH).replace(num_layers=4)
    model = Model(cfg)
    params = model.init(torch.Generator(device=model.device).manual_seed(SEED))
    first = {}
    runs = {}
    for plain in (False, True):
        m = Model(cfg, plain_kernels=plain)
        logits = []
        for r in make_requests(cfg.vocab_size):
            lg, _ = m.prefill(params, {"tokens": [r.prompt]}, cache_len=2048)
            logits.append(lg[0, -1])
        first[plain] = torch.stack(logits)
        runs[plain] = run_engine(cfg, params, plain=plain)[0]
    diff = (first[False] - first[True]).abs().amax(dim=-1)              # per request
    top2 = first[True].topk(2, dim=-1).values
    margin = top2[:, 0] - top2[:, 1]
    tol = 1e-1   # bf16 activations through 4 layers: one rounding step differs here and there
    same_first, near_tie, equal, total = 0, 0, 0, 0
    for i, (a, b) in enumerate(zip(runs[False], runs[True])):
        same_first += a.tokens[0] == b.tokens[0]
        near_tie += (a.tokens[0] != b.tokens[0]) and float(margin[i]) <= 2 * float(diff[i])
        equal += sum(x == y for x, y in zip(a.tokens, b.tokens))
        total += len(a.tokens)
    rec = {"phase": "parity", "layers": cfg.num_layers, "requests": len(runs[False]),
           "first_logits_max_abs_diff": float(diff.max()), "tol": tol,
           "first_token_equal": same_first, "first_token_near_tie": near_tie,
           "tokens_equal_share": equal / total}
    emit(rec)
    if not float(diff.max()) <= tol:
        fail(f"first-token logits differ by {float(diff.max())} > {tol}")
    if same_first + near_tie != len(runs[False]):
        fail("a first token differs between kernels and plain versions beyond a near-tie "
             "of the two best logits")


# --------------------------------------------------------------------------

KERNEL_INFO = {
    "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:104"),
    "decode_attention": ("src/repro_torch/kernels/csrc/decode_attention.cu",
                         "src/repro/kernels/decode_attention.py:67"),
    "decode_combine": ("src/repro_torch/kernels/csrc/decode_attention.cu",
                       "src/repro/kernels/decode_attention.py:89"),
    "rmsnorm": ("src/repro_torch/kernels/csrc/rmsnorm.cu",
                "src/repro/kernels/rmsnorm.py:45"),
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases", default="env,build,kernels,serve,parity",
                    help="comma-separated subset of env,build,kernels,serve,parity; the "
                         "closing lines are printed only when all five ran")
    ap.add_argument("--profile", metavar="DIR", default=None,
                    help="also profile 10 decode steps and a prefill of the full model with "
                         "torch.profiler; the tables by kernel are written to DIR")
    ap.add_argument("--ptxas", action="store_true",
                    help="print the compiler's register and shared-memory report to stderr")
    args = ap.parse_args(argv)
    phases = args.phases.split(",")

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script measures on a CUDA device only")
    if not os.path.isdir(os.path.join(HERE, "src", "repro_torch")):
        fail("src/repro_torch is missing beside chip_smoke.py")
    from repro_torch.kernels import _build

    smi = gpu_name_and_power()
    try:
        import triton  # noqa: F401
        has_triton = True
    except ImportError:
        has_triton = False
    nvcc = subprocess.run([_build.find_nvcc(), "--version"], capture_output=True, text=True,
                          timeout=60, check=True).stdout.strip().splitlines()[-2:]
    emit({"phase": "env", "python": sys.version.split()[0], "torch": torch.__version__,
          "cuda": torch.version.cuda, "nvcc": " | ".join(nvcc), "triton": has_triton,
          "gpu": smi, "device_name": torch.cuda.get_device_name(0),
          "device_count": torch.cuda.device_count(),
          "sm_count": torch.cuda.get_device_properties(0).multi_processor_count})

    torch.backends.cuda.matmul.allow_tf32 = False   # float32 products stay float32

    if "build" in phases:
        logs = _build.build_all(verbose=args.ptxas)
        if args.ptxas:
            for name, log in logs.items():
                print(f"--- nvcc {name}.cu ---\n{log}", file=sys.stderr)
        emit({"phase": "build", "seconds": _build.build_seconds, "sources": list(_build.SOURCES),
              "build_dir": os.path.relpath(_build.build_dir(), HERE)})
    main_recs = counts = None
    if "kernels" in phases:
        _, main_recs = phase_kernels()
    if "serve" in phases:
        counts = phase_serve()
    if args.profile:
        phase_profile(args.profile)
    if "parity" in phases:
        phase_parity()
    if main_recs is None or counts is None or "parity" not in phases:
        print("chip_smoke: partial run, no closing lines", file=sys.stderr)
        return 0

    kernels = []
    for name, (source, replaces) in KERNEL_INFO.items():
        r = main_recs[name]
        if counts[name] <= 0:
            fail(f"kernel {name} was not launched on the serving path")
        kernels.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                        "launches": counts[name], "max_abs_err": r["max_abs_err"],
                        "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"], "library_ms": r["library_ms"],
                        "shape": r["case"], "dtype": r["dtype"]})
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
