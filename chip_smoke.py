#!/usr/bin/env python3
"""Drives the PyTorch/CUDA port's serving path on one NVIDIA GPU.

    python3 chip_smoke.py                 # every phase; what a check of the port runs
    python3 chip_smoke.py --phases env,build,kernels --ptxas   # a new kernel's first run
    python3 chip_smoke.py --phases env,build,kernels --baseline-src OTHER   # + OTHER's kernels

Phases, each printing one JSON object on a line of its own:

  env      versions, compiler, GPU name and power limit; exits non-zero if
           there is no CUDA device (there is no CPU carry-on)
  build    compiles src/repro_torch/kernels/csrc/*.cu with nvcc (one process
           a source, started together); seconds taken; then a SASS check:
           cuobjdump must find HGMMA (wgmma) and UTMALDG (TMA loads) in the
           flash-attention library, 16-byte loads and stores in the rmsnorm one
  kernels  every kernel against its plain PyTorch version on the card, at the
           shapes the serving path gives it and at edge shapes, in float32
           (tolerance 2e-5: another order of summation) and bfloat16 (2e-2),
           with times: `ms` from CUDA events around a wrapper call (host work
           included), `device_ms` the call's own device time from the
           profiler, and the same two for the library call; for K3 also
           the launch floor (the device time of a one-element fill), the
           device time with its inputs left in L2, and the device time of
           other launch plans; the kernels' host-side plans against what
           the compiled kernels report
  serve    phi4-mini-3.8b at full width and depth, random weights from a
           seed, ServingEngine(slots=8, cache_len=2048), 12 requests of 16 to
           1024 prompt tokens and 32 new tokens each; checks the tokens, the
           logits and that the launch counts are exactly what the path implies
  parity   the same model cut to 4 layers, the same requests, once through
           the kernels and once through their plain versions

`--baseline-src DIR` times the serving-shape kernels (K1, K2, K3) of the
tree at DIR (e.g. the parent commit, unpacked) beside this tree's, in turns
(DIR, here, here, DIR), each in a process of its own, through the wrappers'
common signatures (the `times` phase; for K3 also `host_us`, the host time
of a wrapper call, taken before the process profiles anything).

Then one line {"kernels": [...]} with, for each kernel of the serving path,
its launches in the serve phase, error, time, device time, plain version's
time, bound and the time and device time of the one PyTorch call that
computes the same function; then the
GPU's name and power limit as nvidia-smi prints them; then, last,
{"ok": true, "device": {...}}.  Any failing phase ends the run with a
non-zero exit code and no last line.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
# The package under test; another tree's for the --baseline-src processes.
SRC = os.environ.get("CHIP_SMOKE_SRC", os.path.join(HERE, "src"))
sys.path.insert(0, SRC)

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


_flush_names = None
_flush_i64 = None


def device_ms(fn, iters: int = 10, cold: bool = True) -> float:
    """The call's own device time in ms: the profiler's self device time of
    every kernel (and device copy) that ``fn`` launches, per call, over
    ``iters`` calls with the L2 cache overwritten before each call (unless
    not ``cold``: then the inputs stay in L2 from the call before).  The
    overwrite reads 256 MB (an int64 sum, whose kernels are left out by
    name), so L2 holds clean lines: a fill would leave up to 50 MB of dirty
    lines that the measured call would pay to write back."""
    global _flush_names, _flush_i64
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    if _flush_i64 is None:
        _flush_i64 = torch.ones(256 << 17, dtype=torch.int64, device="cuda")   # 256 MB
    flush = _flush_i64
    on_dev = torch.autograd.DeviceType.CUDA
    if _flush_names is None:
        with profile(activities=acts) as prof:
            flush.sum()
            torch.cuda.synchronize()
        _flush_names = {e.key for e in prof.key_averages() if e.device_type == on_dev}
    fn()
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        for _ in range(iters):
            if cold:
                flush.sum()
            fn()
        torch.cuda.synchronize()
    # A kernel's mean time times its launches a call: the count is rounded, so
    # an event the tracer drops now and then does not pull the sum down.
    total = sum(e.self_device_time_total / e.count * max(1, round(e.count / iters))
                for e in prof.key_averages()
                if e.device_type == on_dev and e.key not in _flush_names and e.count)
    return total / 1e3


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


def flash_inputs(rng, *, B, H, Hkv, Sq, Sk, D, dtype, bshd):
    if bshd:   # the model's layout: strided views, as the serving path passes them
        return (randn(rng, (B, Sq, H, D), dtype).permute(0, 2, 1, 3),
                randn(rng, (B, Sk, Hkv, D), dtype).permute(0, 2, 1, 3),
                randn(rng, (B, Sk, Hkv, D), dtype).permute(0, 2, 1, 3))
    return (randn(rng, (B, H, Sq, D), dtype), randn(rng, (B, Hkv, Sk, D), dtype),
            randn(rng, (B, Hkv, Sk, D), dtype))


def flash_work(q, k, causal, window) -> tuple[float, float]:
    """(bytes, operations) the function needs: q, k, v read once, o written
    once; 4 D operations a visible (q, k) pair."""
    B, H, Sq, D = q.shape
    nbytes = (2 * q.numel() + 2 * k.numel()) * q.element_size()
    return nbytes, 4.0 * B * H * D * visible_pairs(Sq, k.shape[2], causal, window)


def sdpa_flash(q, k, v, causal):
    return lambda: F.scaled_dot_product_attention(q, k, v, is_causal=causal, enable_gqa=True)


def check_flash(rng, *, B, H, Hkv, Sq, Sk, D, causal, window, dtype, timed, bshd=False):
    from repro_torch.kernels import flash_attention, flash_attention_plain
    q, k, v = flash_inputs(rng, B=B, H=H, Hkv=Hkv, Sq=Sq, Sk=Sk, D=D, dtype=dtype, bshd=bshd)
    got = flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    want = flash_attention_plain(q, k, v, causal=causal, window=window)
    rec = {"kernel": "flash_attention", "dtype": dt_name(dtype),
           "case": f"B{B} H{H} Hkv{Hkv} Sq{Sq} Sk{Sk} D{D} causal{int(causal)} window{window}"
                   + (" bshd" if bshd else ""),
           "max_abs_err": max_err(got, want), "tol": TOL[dtype]}
    if timed:
        nbytes, flops = flash_work(q, k, causal, window)
        rec["bound_ms"], rec["bound_by"] = bound(nbytes, flops, dtype)
        call = lambda: flash_attention(q, k, v, causal=causal, window=window)  # noqa: E731
        rec["ms"] = time_ms(call)
        rec["device_ms"] = device_ms(call)
        rec["plain_ms"] = time_ms(
            lambda: flash_attention_plain(q, k, v, causal=causal, window=window), iters=5)
        if window == 0 and (causal is False or Sq == Sk):
            rec["library_ms"] = time_ms(sdpa_flash(q, k, v, causal))
            rec["library_device_ms"] = device_ms(sdpa_flash(q, k, v, causal))
        else:
            rec["library_ms"] = rec["library_device_ms"] = None
    return rec


def decode_inputs(rng, *, B, H, Hkv, T, D, valid, dtype, bthd):
    q = randn(rng, (B, H, D), dtype)
    if bthd:   # the model's cache layout, read through strides
        k = randn(rng, (B, T, Hkv, D), dtype).permute(0, 2, 1, 3)
        v = randn(rng, (B, T, Hkv, D), dtype).permute(0, 2, 1, 3)
    else:
        k, v = randn(rng, (B, Hkv, T, D), dtype), randn(rng, (B, Hkv, T, D), dtype)
    vl = None if valid is None else torch.tensor(valid, dtype=torch.int32, device="cuda")
    return q, k, v, vl


def decode_work(q, k, valid) -> tuple[float, float]:
    """(bytes, operations) the function needs: the valid K and V rows read
    once, q read and o written once; 4 D operations a q head and row."""
    B, H, D = q.shape
    Hkv, T = k.shape[1], k.shape[2]
    rows = sum(valid) if valid is not None else B * T     # cache rows this run reads
    nbytes = (2 * rows * Hkv * D + 2 * q.numel()) * q.element_size() + 4 * B
    return nbytes, 4.0 * H * D * rows


def sdpa_decode(q, k, v, vl):
    B, T = q.shape[0], k.shape[2]
    valid_t = vl if vl is not None else torch.full((B,), T, device="cuda")
    mask = (torch.arange(T, device="cuda")[None, :] < valid_t[:, None])[:, None, None, :]
    return lambda: F.scaled_dot_product_attention(q[:, :, None, :], k, v, attn_mask=mask,
                                                  enable_gqa=True)


def check_decode(rng, *, B, H, Hkv, T, D, valid, dtype, timed, bthd=False):
    import importlib
    from repro_torch.kernels import decode_attention, decode_attention_plain
    dec = importlib.import_module("repro_torch.kernels.decode_attention")
    q, k, v, vl = decode_inputs(rng, B=B, H=H, Hkv=Hkv, T=T, D=D, valid=valid, dtype=dtype,
                                bthd=bthd)
    got = decode_attention(q, k, v, kv_valid_len=vl)
    torch.cuda.synchronize()
    want = decode_attention_plain(q, k, v, kv_valid_len=vl)
    sm_count, per_sm, rows = dec.kernel_plan(q.device, H // Hkv, D, dtype)
    ns, chunk = dec.split_plan(B, Hkv, T, sm_count=sm_count, blocks_per_sm=per_sm,
                               rows_per_iter=rows)
    rec = {"kernel": "decode_attention", "dtype": dt_name(dtype),
           "case": f"B{B} H{H} Hkv{Hkv} T{T} D{D} valid{valid}" + (" bthd" if bthd else ""),
           "splits": ns, "chunk": chunk, "blocks_per_sm": per_sm,
           "max_abs_err": max_err(got, want), "tol": TOL[dtype]}
    if valid is not None and 0 in valid:   # the pinned semantics: a dead row gives 0
        rec["zero_rows_max_abs"] = float(got[[i for i, n in enumerate(valid) if n == 0]]
                                         .float().abs().max())
        if rec["zero_rows_max_abs"] != 0.0:
            fail(f"decode_attention: kv_valid_len=0 must give 0, got {rec}")
    if timed:
        nbytes, flops = decode_work(q, k, valid)
        rec["bound_ms"], rec["bound_by"] = bound(nbytes, flops, dtype)
        call = lambda: decode_attention(q, k, v, kv_valid_len=vl)  # noqa: E731
        rec["ms"] = time_ms(call)
        rec["device_ms"] = device_ms(call)
        rec["plain_ms"] = time_ms(lambda: decode_attention_plain(q, k, v, kv_valid_len=vl), iters=5)
        rec["library_ms"] = time_ms(sdpa_decode(q, k, v, vl))
        rec["library_device_ms"] = device_ms(sdpa_decode(q, k, v, vl))
    return rec


_floor_ms = None


def launch_floor_ms() -> float:
    """The card's launch floor: the profiler's device time of a one-element
    ``torch.zeros(1, device="cuda")`` fill, the least a kernel launch shows."""
    global _floor_ms
    if _floor_ms is None:
        _floor_ms = device_ms(lambda: torch.zeros(1, device="cuda"))
    return _floor_ms


def host_us(fn, n: int = 1000, rounds: int = 5) -> float:
    """Host time of one call in µs: ``perf_counter`` over ``n`` calls with
    no synchronise inside (what the enqueue costs the serving loop), the
    median of ``rounds``.  A process that has run the profiler pays more
    for every operator afterwards, so this is taken before any profiling."""
    times = []
    for _ in range(rounds):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        times.append((time.perf_counter() - t0) / n * 1e6)
        torch.cuda.synchronize()
    return float(np.median(times))


def rms_inputs(rng, R, D, dtype, w_dtype, offset, residual, misaligned=False):
    """x, w, residual (or None).  ``misaligned``: x is a contiguous view whose
    base lies one element past a 16-byte boundary."""
    x = randn(rng, (R, D), dtype)
    if misaligned:
        buf = torch.empty(R * D + 1, dtype=dtype, device="cuda")
        buf[1:].copy_(x.reshape(-1))
        x = buf[1:1 + R * D].view(R, D)
    w = (randn(rng, (D,), torch.float32) * 0.1 + (0.0 if offset else 1.0)).to(w_dtype)
    r = randn(rng, (R, D), dtype) if residual else None
    return x, w, r


def check_rmsnorm(rng, *, R, D, dtype, w_dtype, offset, residual, timed, fused=False,
                  misaligned=False):
    """K3 against its plain version: ``rmsnorm`` (norm of x, or of x +
    residual), or with ``fused`` ``add_rmsnorm`` (the sum, which must equal
    torch's add bit for bit, and its norm)."""
    import importlib
    from repro_torch.kernels import add_rmsnorm, add_rmsnorm_plain, rmsnorm, rmsnorm_plain
    rms = importlib.import_module("repro_torch.kernels.rmsnorm")
    residual = residual or fused
    x, w, r = rms_inputs(rng, R, D, dtype, w_dtype, offset, residual, misaligned)
    if fused:
        call = lambda: add_rmsnorm(x, r, w, eps=1e-6, offset=offset)  # noqa: E731
        plain = lambda: add_rmsnorm_plain(x, r, w, eps=1e-6, offset=offset)  # noqa: E731
    else:
        call = lambda: rmsnorm(x, w, eps=1e-6, offset=offset, residual=r)  # noqa: E731
        plain = lambda: rmsnorm_plain(x, w, eps=1e-6, offset=offset, residual=r)  # noqa: E731
    got = call()
    torch.cuda.synchronize()
    want = plain()
    rec = {"kernel": "add_rmsnorm" if fused else "rmsnorm", "dtype": dt_name(dtype),
           "case": f"R{R} D{D} w:{dt_name(w_dtype)} offset{int(offset)} residual{int(residual)}"
                   + (" misaligned" if misaligned else ""),
           "plan": rms.launch_plan(D, dtype, aligned=x.data_ptr() % 16 == 0)}
    if fused:
        (got_s, got), (want_s, want) = got, want
        rec["sum_equal"] = bool(torch.equal(got_s, want_s))
        if not rec["sum_equal"]:
            fail(f"add_rmsnorm {rec['case']}: the sum differs from torch's add "
                 f"(max {max_err(got_s, want_s)})")
    rec.update(max_abs_err=max_err(got, want), tol=TOL[dtype])
    if timed:
        nbytes = ((2 + int(residual) + int(fused)) * x.numel() * x.element_size()
                  + w.numel() * w.element_size())
        flops = (4.0 + int(residual)) * x.numel()
        rec["bound_ms"], rec["bound_by"] = bound(nbytes, flops, torch.float32)
        rec["floor_device_ms"] = launch_floor_ms()
        rec["ms"] = time_ms(call)
        rec["device_ms"] = device_ms(call)
        rec["device_ms_warm_l2"] = device_ms(call, cold=False)
        rec["plain_ms"] = time_ms(plain)
        if not offset and not residual:
            wd = w.to(dtype)
            lib = lambda: F.rms_norm(x, (D,), wd, 1e-6)  # noqa: E731
            rec["library_ms"] = time_ms(lib)
            rec["library_device_ms"] = device_ms(lib)
        else:
            rec["library_ms"] = rec["library_device_ms"] = None
    return rec


# K3 plans timed beside the one launch_plan picks, at the serving shapes
RMS_PLANS = [(384, 1, 8), (192, 2, 8), (128, 3, 8), (96, 4, 8)]


def rms_plan_times(rng) -> list:
    """Device time of each plan of ``RMS_PLANS`` for rows of 3072 bf16, at
    the decode (8) and prefill (1000) row counts, norm alone and with the sum,
    each checked against the plain version."""
    import importlib
    from repro_torch.kernels import add_rmsnorm_plain
    rms = importlib.import_module("repro_torch.kernels.rmsnorm")
    bf16 = torch.bfloat16
    chosen = rms.launch_plan(3072, bf16)
    out = []
    for R, with_sum in ((8, False), (1000, False), (8, True), (1000, True)):
        x, w, r = rms_inputs(rng, R, 3072, bf16, bf16, False, with_sum)
        want = add_rmsnorm_plain(x, r, w)[1] if with_sum else rms.rmsnorm_plain(x, w)
        for plan in RMS_PLANS:
            call = lambda: rms._launch(x, w, r, eps=1e-6, offset=0, with_sum=with_sum,  # noqa: E731
                                       plan=plan)[1]
            err = max_err(call(), want)
            out.append({"case": f"R{R} D3072 bf16" + (" with sum" if with_sum else ""),
                        "plan": list(plan), "chosen": plan == chosen, "max_abs_err": err,
                        "device_ms": device_ms(call)})
            if not err <= TOL[bf16]:
                fail(f"rmsnorm plan {plan} at R{R}: error {err}")
    return out


def check_plans(recs_plans: dict) -> None:
    """The wrappers' host-side plans against what the compiled kernels
    report: K1's tiles and shared memory, K2's rows an iteration, K3's
    threads, chunks and vector."""
    import importlib
    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    dec = importlib.import_module("repro_torch.kernels.decode_attention")
    rms = importlib.import_module("repro_torch.kernels.rmsnorm")
    for dtype in (torch.bfloat16, torch.float32):
        for D in (64, 100, 256, 3072, 5120, 7168, 12288, 12290, rms.MAX_D):
            for aligned in (True, False):
                mine = rms.launch_plan(D, dtype, aligned=aligned)
                theirs = rms.kernel_plan(D, dtype, aligned=aligned)
                recs_plans[f"rmsnorm {dt_name(dtype)} D{D} aligned{int(aligned)}"] = list(theirs)
                if mine != theirs:
                    fail(f"rmsnorm plan {dt_name(dtype)} D={D} aligned={aligned}: "
                         f"wrapper {mine}, kernel {theirs}")
    for D in fa.SUPPORTED_D:
        mine, theirs = fa.tile_plan(D), fa.kernel_plan(D)
        recs_plans[f"flash D{D}"] = theirs
        if mine != theirs:
            fail(f"flash_attention plan D={D}: wrapper {mine}, kernel {theirs}")
    dev = torch.device("cuda", torch.cuda.current_device())
    for dtype in (torch.bfloat16, torch.float32):
        for D in dec.SUPPORTED_D:
            for G in dec.SUPPORTED_G:
                sm_count, per_sm, rows = dec.kernel_plan(dev, G, D, dtype)
                recs_plans[f"decode {dt_name(dtype)} D{D} G{G}"] = {
                    "sm_count": sm_count, "blocks_per_sm": per_sm, "rows_per_iter": rows}
                want = dec.rows_per_iter(D, torch.tensor([], dtype=dtype).element_size())
                if rows != want or per_sm < 1:
                    fail(f"decode_attention plan {dt_name(dtype)} D={D} G={G}: kernel "
                         f"{(per_sm, rows)}, wrapper rows {want}")


def phase_kernels():
    """Returns (all records, {kernel name: record at the serving path's shape})."""
    from repro_torch import kernels as K
    rng = np.random.default_rng(SEED)
    bf16, f32 = torch.bfloat16, torch.float32
    recs, main, plans = [], {}, {}
    check_plans(plans)

    # --- K1 at the serving path's shapes (prefill: B=1, the model's layout) ...
    for S in (64, 512, 1000, 2048):
        for dtype in (bf16, f32):
            recs.append(check_flash(rng, B=1, H=24, Hkv=8, Sq=S, Sk=S, D=128, causal=True,
                                    window=0, dtype=dtype, timed=dtype is bf16, bshd=True))
            if S == 1000 and dtype is bf16:
                main["flash_attention"] = recs[-1]
    # ... and at edge shapes
    for dtype in (bf16, f32):
        edge = [dict(B=2, H=24, Hkv=8, Sq=777, Sk=777, D=128, causal=True, window=0, bshd=True),  # batch, ragged
                dict(B=1, H=16, Hkv=16, Sq=512, Sk=512, D=256, causal=True, window=0),   # gemma: D=256, G=1
                dict(B=2, H=16, Hkv=16, Sq=200, Sk=200, D=256, causal=True, window=0),
                dict(B=2, H=8, Hkv=1, Sq=192, Sk=192, D=64, causal=True, window=0),      # MQA, G=8, ragged
                dict(B=2, H=4, Hkv=2, Sq=160, Sk=160, D=64, causal=True, window=64),     # sliding window
                dict(B=1, H=4, Hkv=2, Sq=300, Sk=300, D=128, causal=False, window=64),   # window alone
                dict(B=1, H=4, Hkv=1, Sq=128, Sk=256, D=64, causal=False, window=0),     # Sq != Sk
                dict(B=1, H=6, Hkv=2, Sq=70, Sk=33, D=128, causal=True, window=0)]       # rows with no key in range
        for i, e in enumerate(edge):
            recs.append(check_flash(rng, **e, dtype=dtype, timed=dtype is bf16 and i < 2))

    # --- K2 at the serving path's shape (8 slots, ring cache of 2048, the model's layout) ...
    mixed = [1, 2048, 17, 1024, 300, 2047, 64, 1500]
    for dtype in (bf16, f32):
        recs.append(check_decode(rng, B=8, H=24, Hkv=8, T=2048, D=128, valid=mixed, dtype=dtype,
                                 timed=dtype is bf16, bthd=True))
        if dtype is bf16:
            main["decode_attention"] = recs[-1]
    recs.append(check_decode(rng, B=8, H=24, Hkv=8, T=2048, D=128, valid=[2048] * 8, dtype=bf16,
                             timed=True, bthd=True))
    # ... at qwen2.5-32b's group (G=5) and with a long cache (many splits) ...
    for dtype in (bf16, f32):
        recs.append(check_decode(rng, B=4, H=40, Hkv=8, T=1500, D=128, valid=None, dtype=dtype,
                                 timed=dtype is bf16, bthd=True))
        recs.append(check_decode(rng, B=2, H=24, Hkv=8, T=16384, D=128, valid=[16384, 9000],
                                 dtype=dtype, timed=dtype is bf16, bthd=True))
    # ... and at edge shapes
    for dtype in (bf16, f32):
        recs.append(check_decode(rng, B=2, H=16, Hkv=16, T=300, D=256, valid=[300, 7], dtype=dtype,
                                 timed=False))                                   # D=256, G=1, ragged T
        recs.append(check_decode(rng, B=1, H=8, Hkv=1, T=300, D=64, valid=None, dtype=dtype,
                                 timed=False))                                   # MQA, G=8
        recs.append(check_decode(rng, B=3, H=14, Hkv=2, T=512, D=128, valid=[0, 512, 100],
                                 dtype=dtype, timed=False, bthd=True))           # G=7, a dead row
        recs.append(check_decode(rng, B=2, H=4, Hkv=2, T=256, D=64, valid=[256, 255],
                                 dtype=dtype, timed=False))                      # G=2
        recs.append(check_decode(rng, B=128, H=24, Hkv=8, T=256, D=128, valid=None, dtype=dtype,
                                 timed=False, bthd=True))                        # one split
    if not any(r["splits"] == 1 for r in recs if r["kernel"] == "decode_attention"):
        fail("no decode case ran with a single split")

    # --- K3 at the serving path's shapes (R = slots or prompt length, D = 3072) ...
    for R in (8, 1000):
        for dtype, w_dtype in ((bf16, bf16), (f32, f32)):
            recs.append(check_rmsnorm(rng, R=R, D=3072, dtype=dtype, w_dtype=w_dtype, offset=False,
                                      residual=False, timed=dtype is bf16))
            if R == 1000 and dtype is bf16:
                main["rmsnorm"] = recs[-1]
    # ... the residual added and its sum written (the block's add and the next norm) ...
    for R in (8, 512, 1000):
        for dtype in (bf16, f32):
            recs.append(check_rmsnorm(rng, R=R, D=3072, dtype=dtype, w_dtype=dtype, offset=False,
                                      residual=True, fused=True, timed=dtype is bf16))
    # ... with the residual inside the kernel, the 1 + w form, fp32 w beside bf16 x, odd rows,
    # D not a multiple of the 16-byte vector, a base off 16 bytes, and D above the 12288 that a
    # shared-memory row allowed
    for dtype in (bf16, f32):
        recs.append(check_rmsnorm(rng, R=1000, D=3072, dtype=dtype, w_dtype=dtype, offset=False,
                                  residual=True, timed=dtype is bf16))
        recs.append(check_rmsnorm(rng, R=300, D=3072, dtype=dtype, w_dtype=f32, offset=True,
                                  residual=False, timed=False))
        recs.append(check_rmsnorm(rng, R=1, D=256, dtype=dtype, w_dtype=f32, offset=True,
                                  residual=True, timed=False))
        recs.append(check_rmsnorm(rng, R=300, D=7168, dtype=dtype, w_dtype=dtype, offset=False,
                                  residual=False, timed=False))
        for fused in (False, True):
            recs.append(check_rmsnorm(rng, R=37, D=100, dtype=dtype, w_dtype=f32, offset=True,
                                      residual=fused, fused=fused, timed=False))
            recs.append(check_rmsnorm(rng, R=8, D=3072, dtype=dtype, w_dtype=dtype, offset=False,
                                      residual=fused, fused=fused, timed=False, misaligned=True))
        recs.append(check_rmsnorm(rng, R=64, D=16384, dtype=dtype, w_dtype=dtype, offset=False,
                                  residual=True, fused=True, timed=False))
        recs.append(check_rmsnorm(rng, R=16, D=12290, dtype=dtype, w_dtype=f32, offset=False,
                                  residual=False, timed=False))
    if not any(r["plan"][2] == 1 for r in recs if "plan" in r):
        fail("no rmsnorm case ran the scalar variant")
    rms_plans = rms_plan_times(rng)

    K.reset_launch_counts()
    bad = [r for r in recs if not (r["max_abs_err"] <= r["tol"])]   # a NaN is bad too
    emit({"phase": "kernels", "plans": plans, "floor_device_ms": launch_floor_ms(),
          "rmsnorm_plans": rms_plans, "checks": recs, "failed": len(bad)})
    if bad:
        fail(f"{len(bad)} kernel check(s) over tolerance: {bad}")
    return recs, main


# instructions each library must hold: K1's wgmma (HGMMA) and TMA loads
# (UTMALDG), K3's 16-byte loads and stores
SASS_WANTED = {"flash_attention": (r"HGMMA", r"UTMALDG"),
               "rmsnorm": (r"LDG\.E\.128", r"STG\.E\.128")}


def sass_check() -> dict:
    """Counts of the ``SASS_WANTED`` instructions in each library; fails if
    one is missing, so a K1 that quietly stopped using the tensor cores or
    TMA, or a K3 that stopped moving 16 bytes a load, does not pass."""
    from repro_torch.kernels import _build
    cuobjdump = os.path.join(os.path.dirname(_build.find_nvcc()), "cuobjdump")
    counts = {}
    for name, ops in SASS_WANTED.items():
        _build.load(name)                               # built if need be
        lib = _build._target(name)[1]
        sass = subprocess.run([cuobjdump, "-sass", str(lib)], capture_output=True, text=True,
                              timeout=300, check=True).stdout
        counts[name] = {op: len(re.findall(rf"\b{op}\b", sass)) for op in ops}
    emit({"phase": "sass", "counts": counts})
    missing = [(name, op) for name, c in counts.items() for op, n in c.items() if n == 0]
    if missing:
        fail(f"instructions missing from the kernel libraries: {missing}")
    return counts


def phase_times():
    """The serving shapes of K1, K2 and K3 in bf16 through the wrappers' plain
    signatures, which every tree of the port has (K3's
    ``rmsnorm(x, w, eps=, offset=, residual=)``): ms and device_ms, and for
    K3 the host time of a call."""
    from repro_torch.kernels import decode_attention, flash_attention, rmsnorm
    rng = np.random.default_rng(SEED)
    bf16 = torch.bfloat16
    out = []
    # K3's host time first, before this process runs the profiler
    k3 = []
    for R, residual in ((8, False), (1000, False), (1000, True)):
        x, w, r = rms_inputs(rng, R, 3072, bf16, bf16, False, residual)
        call = lambda x=x, w=w, r=r: rmsnorm(x, w, eps=1e-6, offset=False, residual=r)  # noqa: E731
        k3.append(({"kernel": "rmsnorm", "case": f"R{R} D3072 residual{int(residual)}",
                    "host_us": host_us(call)}, call))
    # what the trimmed pieces of the wrapper cost alone (the same in every tree)
    x = rms_inputs(rng, 8, 3072, bf16, bf16, False, False)[0]
    dev = x.device.index
    pieces = {"current_stream().cuda_stream": lambda: torch.cuda.current_stream().cuda_stream,
              "_cuda_getCurrentRawStream": lambda: torch._C._cuda_getCurrentRawStream(dev),
              "dict[str(dtype)]": lambda: {"torch.bfloat16": 1}.get(str(x.dtype)),
              "dict[dtype]": lambda: {torch.bfloat16: 1}.get(x.dtype),
              "current_device()": torch.cuda.current_device,
              "empty_like(R8)": lambda: torch.empty_like(x)}
    host_pieces_us = {name: host_us(fn, n=10000, rounds=3) for name, fn in pieces.items()}
    for S in (512, 1000, 2048):
        q, k, v = flash_inputs(rng, B=1, H=24, Hkv=8, Sq=S, Sk=S, D=128, dtype=bf16, bshd=True)
        call = lambda: flash_attention(q, k, v, causal=True)  # noqa: E731
        out.append({"kernel": "flash_attention", "case": f"B1 H24 Hkv8 S{S} D128 causal bshd",
                    "ms": time_ms(call), "device_ms": device_ms(call)})
    for valid in ([2048] * 8, [1, 2048, 17, 1024, 300, 2047, 64, 1500]):
        q, k, v, vl = decode_inputs(rng, B=8, H=24, Hkv=8, T=2048, D=128, valid=valid,
                                    dtype=bf16, bthd=True)
        call = lambda: decode_attention(q, k, v, kv_valid_len=vl)  # noqa: E731
        out.append({"kernel": "decode_attention", "case": f"B8 H24 Hkv8 T2048 D128 valid{valid}",
                    "ms": time_ms(call), "device_ms": device_ms(call)})
    for rec, call in k3:
        out.append({**rec, "ms": time_ms(call), "device_ms": device_ms(call)})
    emit({"phase": "times", "src": SRC, "records": out, "host_pieces_us": host_pieces_us})


def phase_baseline(other: str) -> None:
    """phase_times for the tree at ``other`` and for this one, in turns
    (other, this, this, other), each in a process of its own."""
    other_src = os.path.join(os.path.abspath(other), "src")
    if not os.path.isdir(os.path.join(other_src, "repro_torch")):
        fail(f"--baseline-src: no src/repro_torch under {other}")
    runs = []
    for label, src in (("baseline", other_src), ("this", SRC), ("this", SRC),
                       ("baseline", other_src)):
        env = dict(os.environ, CHIP_SMOKE_SRC=src)
        env.pop("REPRO_TORCH_BUILD_DIR", None)     # each tree builds into its own build/
        res = subprocess.run([sys.executable, os.path.abspath(__file__), "--phases", "times"],
                             capture_output=True, text=True, timeout=900, env=env)
        lines = [ln for ln in res.stdout.splitlines() if ln.startswith('{"phase": "times"')]
        if res.returncode != 0 or not lines:
            fail(f"baseline run of {src} failed (exit {res.returncode}):\n{res.stderr[-4000:]}")
        runs.append({"tree": label, **json.loads(lines[0])})
    emit({"phase": "baseline", "runs": runs})


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
            "rmsnorm": norms * (len(reqs) + steps)}
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
    "rmsnorm": ("src/repro_torch/kernels/csrc/rmsnorm.cu",
                "src/repro/kernels/rmsnorm.py:45"),
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases", default="env,build,kernels,serve,parity",
                    help="comma-separated subset of env,build,kernels,serve,parity (and times, "
                         "the serving-shape timings alone); the closing lines are printed only "
                         "when the five of the default ran")
    ap.add_argument("--baseline-src", metavar="DIR", default=None,
                    help="also time the serving-shape kernels of the tree at DIR beside this "
                         "tree's, in turns, on this card")
    ap.add_argument("--profile", metavar="DIR", default=None,
                    help="also profile 10 decode steps and a prefill of the full model with "
                         "torch.profiler; the tables by kernel are written to DIR")
    ap.add_argument("--ptxas", action="store_true",
                    help="print the compiler's register and shared-memory report to stderr")
    args = ap.parse_args(argv)
    phases = args.phases.split(",")

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script measures on a CUDA device only")
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        fail(f"src/repro_torch is missing ({SRC})")
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
        sass_check()
    if "times" in phases:
        phase_times()
    if args.baseline_src:
        phase_baseline(args.baseline_src)
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
                        "ms": r["ms"], "device_ms": r["device_ms"], "plain_ms": r["plain_ms"],
                        "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                        "library_ms": r["library_ms"],
                        "library_device_ms": r["library_device_ms"],
                        "shape": r["case"], "dtype": r["dtype"]})
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
