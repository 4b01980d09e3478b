#!/usr/bin/env python3
"""Drives the PyTorch/CUDA port's serving and training paths and its simulator on one NVIDIA GPU.

    python3 chip_smoke.py                 # every phase; what a check of the port runs
    python3 chip_smoke.py --phases env,build,kernels --ptxas   # a new kernel's first run
    python3 chip_smoke.py --phases env,build,kernels --baseline-src OTHER   # + OTHER's kernels

Phases, each printing one JSON object on a line of its own:

  env      versions, compiler, GPU name and power limit; exits non-zero if
           there is no CUDA device (there is no CPU carry-on)
  build    compiles src/repro_torch/kernels/csrc/*.cu with nvcc (one process
           a source, started together); seconds taken; then a SASS check:
           cuobjdump must find HGMMA (wgmma) and UTMALDG (TMA loads) in the
           flash-attention libraries, forward and backward, 16-byte loads and
           stores in the rmsnorm one
  kernels  every kernel against its plain PyTorch version on the card, at the
           shapes the serving path gives it (K1 also at MLA's (192, 128),
           at recurrentgemma's 16 q heads on one kv head, D 256, with a
           window, and at D 64 at whisper's B1 prefill and B8 train shapes;
           K2 at its group of 16, on the tensor cores in bf16, and at
           one sequence of G 16, 7 and 3; K1, K2, K3 and the backward kernels
           at qwen2-vl's G 7 and D 3584) and at edge shapes, in float32
           (tolerance 2e-5: another order of summation) and bfloat16 (2e-2);
           the backward kernels of K1 and K3 at the train path's shapes (K1's
           also at deepseek's B1 H128 S2048 with q/k 192 and v 128, at
           recurrentgemma's 16 q heads on one kv head at D 256 and at
           gemma-7b's 16 heads of 256, each on the tensor cores in bf16 and
           on the FMA kernels in fp32 or off 16 bytes; K3's at D 4096 in the
           1 + w form with the sum) and at edge shapes, on the same tolerances, against autograd in
           float32 of the plain forwards (each gradient's largest error over
           the larger of 1 and its largest magnitude) and against the plain
           backward in float32 from the same inputs, bfloat16 ones too (the
           largest error of a gradient row in L2 over that row's norm; 2e-2
           bf16, 1e-4 fp32, whose rows that cancel read up to 3.1e-5), and
           at the train shape what the row measure reads for gradients that
           left out one 64 x 64 tile (it must exceed that limit),
           with times: `ms` from CUDA events around a wrapper call (host work
           included), `device_ms` the call's own device time from the
           profiler, and the same two for the library call; for K3 also
           the launch floor (the device time of a one-element fill), the
           device time with its inputs left in L2, and the device time of
           other launch plans (for its backward, of other numbers of
           blocks); each backward run twice from the same inputs at its
           train shape must give the same bits; the kernels' host-side
           plans (K1 backward's tiles and workspace too) against what the
           compiled kernels report; a DTensor prefill and decode through
           layers.attention on a one-rank NCCL (1, 1) mesh, through K1 and
           K2 under local_map, the plain-tensor call's bits; K2's partial
           pass and merge timed apart over 16-2048 rows a split (k2_parts,
           also a phase of its own), and K2 twice from the same inputs at a
           single sequence of G 16 and at G 7 (the same bits); K1's backward
           at D 64 at whisper's three train shapes timed by kernel (delta,
           dK/dV, dQ), its forward at D 256 at recurrentgemma's S1000 and
           S2048 and gemma-7b's S2048 and at D 64 at whisper's five shapes
           (the encoder at B1 and B8, the cross attention at B1 Sq224 and B8
           Sq448, the decoder's causal self attention at B8 S448; grid blocks
           and waves too), and at D 128, causal, its forward at yi-34b's,
           qwen2.5-32b's and phi4-mini's S2048 and S1000 and olmoe's and
           qwen2-vl's S1000 and its backward by kernel at yi-34b's (G 7),
           qwen2.5-32b's (G 5), phi4-mini's (G 3) and qwen2-vl's (G 7) S2048,
           each beside SDPA (these checks alone are the
           k1_parts phase, which CHIP_SMOKE_SRC points at another tree), each
           twice for the same bits (the backward at the encoder's shape and
           yi-34b's, the forward at S1000, gemma-7b's, whisper's B8 encoder
           and yi-34b's S2048); the backward's workspace at D 128 and G > 1
           (each kv head's running sums, no q head's partials); Adafactor's
           kernels against the plain update at recurrentgemma-9b's groups
           (the tied embedding, each pass of it timed, and the largest
           12-layer groups timed beside their one-read, five-pass and
           six-pass bytes bounds and torch.optim.Adafactor), at edge shapes,
           at a row too wide for the statistics' stages, and where the
           factorised sum of u^2 must give way to the u^2 pass (its guard
           fails) or stands after rows of zeros (which path ran is
           reported for each case), at an lr
           that moves p by many ulps (vr, vc and v within 1e-5 relative; a
           parameter's change within 1e-5 (fp32) or AF_BF16_UPDATE_TOL
           (bf16) relative L2 of the plain version's, controls above that;
           a bf16 parameter within one ulp at its operands' magnitude; the
           same bits twice; these checks alone are the adafactor phase)
  serve    phi4-mini-3.8b at full width and depth, random weights from a
           seed, ServingEngine(slots=8, cache_len=2048), 12 requests of 16 to
           1024 prompt tokens and 32 new tokens each; checks the tokens, the
           logits and that the launch counts are exactly what the path implies
  parity   the same model cut to 4 layers, the same requests, once through
           the kernels and once through their plain versions
  train    phi4-mini-3.8b at full width and depth through the training
           launcher's pieces (repro_torch.launch.train.Trainer): AdamW, remat
           "block", B1 S2048 (cut only if the port's simulator says the step
           does not fit the card), a warm-up step, 3 steps timed with CUDA
           events, one under the profiler (device-busy time by kernel group:
           K1, K1_bwd, K2, K3, K3_bwd, adamw, adafactor, cublas, other),
           peak memory, launches of K1 and K3 forward and backward; loss and
           grad norm finite at every step, the step counter advancing
  train_parity the train step cut to 4 layers, kernels against plain versions
           (the model's and AdamW's): loss, every gradient leaf, and each
           parameter's change in one AdamW step at lr 1e-3; then the update
           of that tree timed three ways (the AdamW kernel a leaf, the plain
           version a leaf, the plain version in multi-tensor ops)
  simulate the simulator's path: repro_torch's Simulator.run for phi4-mini-3.8b
           at full width and depth on h100_sxm, prefill (B1 S512) and decode
           (B8, cache 2048), with the analytical engine and with the
           profiling engine measuring every operator on the card into a fresh
           profile DB (K1 for the prefill's attention, K2 for the decode's,
           counted), K3 and cuBLAS timed on hand-built norm and matmul nodes
           (the tracer emits no norm node);
           then the port's own Model.prefill / decode_step at those shapes
           (wall time from CUDA events, device-busy time by kernel group from
           the profiler) and the signed error of each prediction; and the
           train cell: Simulator.run for train at the train phase's shape
           (K1 forward and backward counted) against the train phase's step
           and its peak memory
  serve_sim the serving simulator predicting serve's own trace: the 12
           requests as a trace, ContinuousBatching(max_batch=8, admit_cap=1)
           for the engine's schedule, priced by the analytical engine and by
           the profiling engine timing every bucketed step's operators on the
           card (a fresh profile DB; K1 and K2 counted); measured: a fresh
           drained engine run of the trace in a process of its own (host clock,
           then a profiled run for device-busy time); predicted against
           measured makespan, TTFT p50/p95, output tokens/s, steps, also with
           the reference head's transpose of the embedding taken out
  sweep    the simulator's design-space search priced on the card, a line a
           part: (1) phi4-mini-3.8b decode (cache 2048) on 8 chips of
           h100_sxm, 80 GB a chip, over tp (1,2,4,8) x pp (1,2,4) x batch
           (8..256), a serial sweep whose profiling engine measures every
           operator into a fresh DB (K2 counted): counts, pruned reasons,
           operators measured, the top 3 by tokens/s per chip, the Pareto
           front and the best candidate's gain over bench_explore's
           engineering baseline (tp 8, batch 64); (2) the same sweep on a new
           simulator over the saved DB, which must measure nothing and rank
           alike; (3) the analytical sweep with workers=2, whose pool must
           start under spawn (CUDA is initialised) and equal the serial sweep;
           (4) goodput under failures over five checkpoint intervals for the
           train phase's step on 64 chips (K1 forward and backward counted),
           with the Young/Daly interval; (5) the two best tp=1, pp=1
           candidates' per-replica decode step run by the port's own model,
           tokens/s per chip predicted against measured
  moe      the MoE family (olmoe-1b-7b: 64 experts, top 8, GQA with G=1), a
           line a part: (1) serve at full width and depth (random bf16
           weights from a seed, ServingEngine(slots=8, cache_len=2048), serve's
           12 requests): tokens/s, TTFT, engine steps, peak memory, launches
           against the path's formula, one profiled decode step at 8 live
           slots by kernel group and by the MoE's operators (the experts'
           batched products, the router's choice and sort, the gathers and
           scatters), and no host sync in a decode step; (2) parity: 4
           layers, kernels against plain versions, the share of (token, k)
           expert choices alike layer by layer, each request with a flipped
           route reported with the layer and the router margin there, and
           the first-token logits held to 1e-1 (and the first token equal or
           a near-tie) with the plain run on the kernel run's routes; (3)
           simulate: Simulator.run prefill B1 S512 and decode B8 x 2048,
           analytical and profiling (fresh DB, K1 and K2 counted), against
           the port's own step, by op kind with the experts' products apart;
           (4) train_parity: the train step cut to 4 layers as train_parity
           does, the plain run on the kernel run's routes
  griffin  the RG-LRU family (recurrentgemma-9b at full width and depth: 38
           layers, 26 recurrent and 12 local-attention ones with 16 q heads
           on one kv head at D 256, window 2048), random bf16 weights from
           the seed, a line a part: (1) serve as moe's (launches: K1 an
           attention layer a prefill, K2 one a decode step, K3 2L+1 a call;
           the recurrence's and the conv's kernels apart in the profiled
           step); (2) parity: the first 6 layers, kernels against plain
           versions as the parity phase holds them; (3) simulate as moe's,
           K1 and K2 (G = 16) counted
  xlstm    the xLSTM family (xlstm-125m at full width: 4 heads of 192, chunk
           256; its 12 layers, m, m, m, s three times, cut to one such cycle
           of 4 for the run's time since the dense phase), random bf16
           weights from the seed, the mLSTM's conv filter and bias and gate
           bias drawn too (the reference's init leaves them 0, which makes
           every mLSTM block add 0), a line a part: (1) serve as moe's
           (launches: no K1 or K2, K3 2L+1 a call; the mLSTM's, the sLSTM's
           and the conv's kernels apart in the profiled step; the prompts
           the padded-chunk fault touches counted); (2) parity at that
           depth: in float32 within the 0.1 limit (and the engines'
           tokens), in bf16 within twice what a float64 rounding of the
           plain norms moves the plain run by; (3) simulate as moe's, no
           attention; (4) the chunk body's all-batch (2097152, 1, 1) and
           outer (8192, 1, 192) products as bmm beside a multiply; (5) one
           timed AdamW step of the launcher (B1 S512, remat "block": K3 and
           its backward at D 768, the AdamW kernel) against the simulator's
           train prediction and its memory
  whisper  the Whisper family (whisper-large-v3 at full width and depth: 32
           encoder and 32 decoder layers, d_model 1280, 20 heads of 64, vocab
           51,866), random bf16 weights from the seed, frame embeddings drawn
           from the seed times 0.1, a line a part: (1) transcribe: the
           reference's engine takes no frame embeddings, so Model.prefill and
           decode_step are driven as a transcription, B8 requests, a 4-token
           prompt, a ring of 448, 124 greedy new tokens, then one B1 prefill
           of a 224-token prompt (tokens/s, time to the first token, peak
           memory, launches: K1 2L + Le a prefill, K2 2L a decode step, no K3;
           one profiled decode step, no host sync in it; the encoder alone);
           (2) cross_decode: B8 H20 Sq1 Sk1500 D64 through K2 with every row
           valid (the path's route), K1 with one query row and SDPA; (3)
           parity at full depth, kernels against plain versions, the
           first-token logits within 0.1 and the first tokens equal or
           near-tied (in float32, and bf16 against a float64 rounding of the
           plain attention, where bf16 alone moves them more); (4) simulate as
           moe's at prefill B1 S224 and decode B8 at cache 448, the encoder's
           price apart against Model.encode; (5) one timed AdamW step of the
           launcher at B8 S448 with the 1500-frame encoder, remat "block" (K1
           forward and backward at the encoder's, the decoder's and the cross
           attention's shapes) against the simulator's train prediction
  vlm      the VLM family (qwen2-vl-7b at full width and depth: 28 layers,
           d_model 3584, 28 q heads on 4 kv heads (G 7) of 128, M-RoPE over
           (t, h, w) positions, vocab 152,064 untied), random bf16 weights from
           the seed, a line a part: (1) serve as moe's, text only (the
           reference's engine takes no image); (2) multimodal: Model driven
           with a B2 prefill of S512, 256 patch embeddings (normal from the
           seed times 0.02) over rows 0-255 at (0, i // 16, i % 16), text after
           them at t = h = w from 16, then 32 greedy decode steps at (B, 1, 3)
           positions that continue the text's: TTFT, tokens/s, the prefill and
           a decode step measured, launches (K1 28 a prefill, K2 28 a step, K3
           57 a call), no host sync in a decode step, and the first-token
           logits moved by dropping the positions or the patches; (3) parity
           at full depth: the first-token logits of serve's 12 prompts and of
           the multimodal prefill within 0.1, first tokens equal or near-tied,
           both engines' tokens; (4) simulate as moe's at prefill B1 S512 with
           the image's positions and patches and decode B8 at 2048; (5) one
           timed AdamW step of the launcher at B1 S2048 with the pipeline's
           positions and patches, remat "block", depth cut 28 -> 12 layers
           (AdamW's 12 bytes a parameter: 91.4 GB whole), against the
           simulator's train prediction and its memory
  mla      the MLA family (deepseek-v3-671b at full width: 128 heads, q/k
           head dim 192 and v head dim 128 in the prefill's K1, 256 experts,
           top 8, one shared expert), depth cut to 2 layers (what one card
           holds), random bf16 weights from the seed, a line a part: (0)
           layout: the absorbed decode's five batched products profiled at
           full width, none of which may copy an operand, and the
           transposes the tracer prices for that block; (1)
           serve as moe's (launches: K1 a layer a prefill, no K2, K3 4L+1 a
           call; the expert products apart from the absorbed attention's in
           the profiled step); (2) parity as moe's on these 2 layers; (3)
           simulate as moe's, K1 at (192, 128) counted in the prefill; (4)
           train: depth cut to 1 layer (13.36e9 parameters, 26.7 GB, and as
           much of gradients), the trainer's loss and gradients at B1 S2048,
           remat "block", no optimizer update: K1's backward at (192, 128)
           launched once and that call held against its plain version on its
           own inputs, the loss against the plain versions' forward on the
           same routes, and the profiling engine timing the traced backward
           attention node through K1's backward
  dryrun   sharding and the dry-run launcher (run right after griffin, whose
           model it reuses), a line a part: (1) cell_trace: recurrentgemma-9b
           long_500k (decode, B1, S 524,288) traced over DTensors on a (1, 1)
           mesh of a fake world of 1 (repro_torch.launch.dryrun.cell_record),
           its per-device FLOPs, HBM bytes and roofline row with the H100's
           constants (launch/roofline.py); the full-size cells of the
           launcher's production meshes are host work, run by `python -m
           repro_torch.launch.dryrun --arch A --shape S` (gemma-7b
           decode_32k on 2x16x16 in tests/test_torch_dryrun.py); (2) cell:
           then its decode step run on the card at full
           width and depth (the ring of 2048 rows all valid, pos 524,287):
           wall and device-busy time, launches of K2 and K3 in one step (12
           and 77), host syncs, and the roofline bound over busy time; the
           same step once more under a sharding env over a (1, 1) mesh of a
           real world of one rank (NCCL): logits bit-equal, launches equal;
           each of the step's 12 K2 calls against the plain version on its
           own inputs (2e-2, and under a quarter of what 16 rows left out
           move the plain version by), and the logits
           against the same step through the plain versions: in bfloat16
           the first token equal or a near-tie; in float32 (the weights
           widened) within 1e-3, which a K2 16 rows short must exceed; the
           kernels phase checks K2 at this cell's B1 shape (16 splits of 128
           rows) in both types
  griffin_train recurrentgemma-9b trained at full width and depth (after
           dryrun frees the griffin weights), a line a part: (1) the launcher's
           Trainer with --optimizer adafactor (AdamW's 12 bytes a parameter
           would be 113 GB), B1 S2048, remat "block", conv filters drawn: a
           warm-up step, 3 timed, one profiled (busy by kernel group), peak
           memory, launches a step (K1 24, its backward 12, K3 153 and its
           backward 77, Adafactor's kernels 198 over its 71 layer groups),
           then one step with int8 gradient compression
           through make_train_step; (2) the analytical and profiling engines'
           train step (a fresh DB; K1 and its backward at G 16, D 256
           counted) against the measured busy, wall and peak; (3) the train
           step on 6 layers, kernels against plain versions as train_parity
           holds phi4-mini (Adafactor's kernels against its plain update),
           under Adafactor and under Adafactor with int8
  dense    the main path's dense GQA decoders that no other phase runs, gemma-7b
           (28 layers, 16 heads of 256, G 1, GeGLU, tied vocab 256,000, 1 + w
           norms), qwen2.5-32b (64 layers, d_model 5120, 40 heads on 8 (G 5),
           QKV bias) and yi-34b (60 layers, d_model 7168, 56 heads on 8 (G 7)),
           in turn, random bf16 weights from the seed, a line a part: (1)
           serve as moe's at full width and depth; (2) parity at full depth as
           vlm's (the first-token logits of serve's 12 prompts within 0.1,
           first tokens equal or near-tied, a float64 rounding of the plain
           run beside, both engines' tokens); (3) simulate as moe's at prefill
           B1 S512 and decode B8 at 2048; gemma-7b's part then runs the serve
           launcher as a user does at its default arch (python -m
           repro_torch.launch.serve --full with the README's flags: what it
           printed, its launches against the formula); (4) one timed AdamW
           step of the train launcher's Trainer (qwen2.5-32b's built at that
           launcher's default arch, without --arch) at B1 S2048, remat
           "block", width never cut, depth cut to DENSE_TRAIN_LAYERS (20, 10
           and 10 layers), against the analytical and profiling engines'
           train step and the peak; (5) the train step's parity on 2 layers
           (loss, every gradient leaf, AdamW's change); a closing line a model
           (parameters, depths served and trained, seconds a part, peak
           memory at init, serve and train); the kernels phase holds K1, its
           backward, K2, K3, its backward and AdamW at these models' shapes

Before the closing lines, one line {"phase": "seconds", ...}: the seconds of
each phase that ran (also in a partial run).

`--baseline-src DIR` times the serving-shape kernels (K1, K2, K3) and the
train-shape backward of K1 and K3 of the tree at DIR (e.g. the parent
commit, unpacked) beside this tree's, in turns (DIR, here, here, DIR), each
in a process of its own, through the wrappers' common signatures (the
`times` phase; for K3 also `host_us`, the host time of a wrapper call, taken
before the process profiles anything).  Every output must be the other
tree's bits, but K2's and those that come from K1's bf16 forward at D 64 or
at D 128 over 1536 rows or more (its cases, and its backward's at whisper's
three train shapes, which start from that forward's output and log-sum-exp;
`new_k1_bits`): a plan's kv tiles set
those bits, so each tree's are held to their plain versions at the kernel
tolerance, and the cases so held are named in the line.  K1's backward at D
128 starts from the plain forward's output and log-sum-exp, the same in
every tree, and is held bit for bit.  `--variant PATCH`
(repeatable, with `--baseline-src`) adds the tree at DIR with the unified
diff PATCH applied (a copy under build/variants/) to those turns (DIR, each
variant, here, here, each variant in reverse, DIR): the kernel designs that
were tried and not shipped, kept as patches against the tree they were
written for under src/repro_torch/kernels/variants/, so that they can be
timed again beside it.

Then one line {"kernels": [...]} with, for each kernel of the serving path
and the backward kernels and optimizers of the train path, its launches in
the serve phase (the train phase for a backward kernel and AdamW,
griffin_train's for Adafactor), in the train phase, by the
profiling engine in the simulate, serve_sim and sweep phases and in the moe,
griffin, griffin_train, xlstm, whisper, vlm, mla and dense phases' parts and
the dryrun phase's decode step, its timings at olmoe's,
recurrentgemma's, xlstm's, whisper's, qwen2-vl's and deepseek's shapes where it has them
and at gemma-7b's, qwen2.5-32b's and yi-34b's (``dense_shapes``),
error, time,
device time, plain version's
time, bound and the time and device time of the one PyTorch call that
computes the same function; then the
GPU's name and power limit as nvidia-smi prints them; then, last,
{"ok": true, "device": {...}}.  Any failing phase ends the run with a
non-zero exit code and no last line.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
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
FLOOR = 0.1     # row_err: a row is measured against at least this share of the RMS row norm
# row_err's limits: bf16 as TOL; fp32 above TOL because a row whose softmax is nearly one-hot
# cancels (dQ = P (dP - delta) K), and there another order of summation reads up to 3.1e-5 (fp32
# FMA kernel against the plain backward, S2048); one skipped 64 x 64 tile reads 0.4 and more
ROW_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
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
    return sum(device_ms_by_kernel(fn, iters, cold).values())


def device_ms_by_kernel(fn, iters: int = 10, cold: bool = True, tries: int = 3) -> dict:
    """:func:`device_ms` split by kernel name: {name: ms a call}.  A profile
    that holds no kernel of the call (the tracer now and then delivers none)
    is taken again, up to ``tries`` times; after that the call's time from
    CUDA events stands under the name :data:`EVENTS_KEY`, so no call reads
    0 ms."""
    global _flush_names, _flush_i64
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    if _flush_i64 is None:
        _flush_i64 = torch.ones(256 << 17, dtype=torch.int64, device="cuda")   # 256 MB
    flush = _flush_i64
    on_dev = torch.autograd.DeviceType.CUDA
    if _flush_names is None:
        # the flush's kernels are those of two sessions that ran it alone: a
        # record of earlier work that the tracer delivers late lands in one
        # session at most, and would otherwise leave its kernel out of every
        # later sum
        names = []
        for _ in range(2):
            torch.cuda.synchronize()
            with profile(activities=acts) as prof:
                flush.sum()
                torch.cuda.synchronize()
            names.append({e.key for e in prof.key_averages() if e.device_type == on_dev})
        _flush_names = names[0] & names[1]
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=acts) as prof:
            for _ in range(iters):
                if cold:
                    flush.sum()
                fn()
            torch.cuda.synchronize()
        # A kernel's mean time times its launches a call: the count is rounded,
        # so an event the tracer drops now and then does not pull the sum down.
        out = {e.key: e.self_device_time_total / e.count * max(1, round(e.count / iters)) / 1e3
               for e in prof.key_averages()
               if e.device_type == on_dev and e.key not in _flush_names and e.count}
        if sum(out.values()) > 0:
            return out
    return {EVENTS_KEY: events_ms(fn, iters, cold)}


EVENTS_KEY = "(cuda events: the profiler delivered no kernel of the call)"


def events_ms(fn, iters: int, cold: bool) -> float:
    """Median ms of one call from CUDA events, after the same int64 read as
    :func:`device_ms_by_kernel` when ``cold``."""
    times = []
    for _ in range(iters):
        if cold:
            _flush_i64.sum()
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
    return float((a.detach().float() - b.detach().float()).abs().max())


def dt_name(dtype) -> str:
    return str(dtype).replace("torch.", "")


# --------------------------------------------------------------------------
# kernel checks
# --------------------------------------------------------------------------

def visible_per_row(Sq, Sk, causal, window) -> np.ndarray:
    """Number of keys each query row sees under the masks."""
    q = np.arange(Sq)[:, None]
    k = np.arange(Sk)[None, :]
    m = np.ones((Sq, Sk), bool)
    if causal:
        m &= k <= q
    if window > 0:
        m &= k > q - window
    return m.sum(axis=1)


def visible_pairs(Sq, Sk, causal, window) -> int:
    """Number of (q, k) positions the masks leave, which is what the work of
    this call is proportional to."""
    return int(visible_per_row(Sq, Sk, causal, window).sum())


def flash_inputs(rng, *, B, H, Hkv, Sq, Sk, D, dtype, bshd, Dv=None):
    """q, k (head dim D) and v (head dim Dv, default D)."""
    Dv = D if Dv is None else Dv
    if bshd:   # the model's layout: strided views, as the serving path passes them
        return (randn(rng, (B, Sq, H, D), dtype).permute(0, 2, 1, 3),
                randn(rng, (B, Sk, Hkv, D), dtype).permute(0, 2, 1, 3),
                randn(rng, (B, Sk, Hkv, Dv), dtype).permute(0, 2, 1, 3))
    return (randn(rng, (B, H, Sq, D), dtype), randn(rng, (B, Hkv, Sk, D), dtype),
            randn(rng, (B, Hkv, Sk, Dv), dtype))


def flash_work(q, k, causal, window, v=None) -> tuple[float, float]:
    """(bytes, operations) the function needs: q, k, v read once, o written
    once; 2 (D + Dv) operations a visible (q, k) pair (v: a head dim of its
    own, as MLA's; default k's)."""
    B, H, Sq, D = q.shape
    Dv = D if v is None else v.shape[-1]
    nbytes = (q.numel() + k.numel() + (k.numel() + B * H * Sq * D) * Dv // D) * q.element_size()
    return nbytes, 2.0 * B * H * (D + Dv) * visible_pairs(Sq, k.shape[2], causal, window)


def sdpa_flash(q, k, v, causal):
    return lambda: F.scaled_dot_product_attention(q, k, v, is_causal=causal, enable_gqa=True)


def check_flash(rng, *, B, H, Hkv, Sq, Sk, D, causal, window, dtype, timed, bshd=False,
                Dv=None, lse=False):
    """K1 against its plain version; ``Dv``: v's head dim apart from q's and
    k's (MLA's (192, 128)); ``lse``: the LSE variant, its row log-sum-exp
    held too (its error over max(1, |lse|))."""
    from repro_torch.kernels import flash_attention, flash_attention_lse_plain
    q, k, v = flash_inputs(rng, B=B, H=H, Hkv=Hkv, Sq=Sq, Sk=Sk, D=D, dtype=dtype, bshd=bshd,
                           Dv=Dv)
    row_lse = torch.empty((B, H, Sq), dtype=torch.float32, device="cuda") if lse else None
    got = flash_attention(q, k, v, causal=causal, window=window, lse=row_lse)
    torch.cuda.synchronize()
    want, want_lse = flash_attention_lse_plain(q, k, v, causal=causal, window=window)
    rec = {"kernel": "flash_attention", "dtype": dt_name(dtype),
           "case": f"B{B} H{H} Hkv{Hkv} Sq{Sq} Sk{Sk} D{D}"
                   + ("" if Dv is None else f" Dv{Dv}")
                   + f" causal{int(causal)} window{window}"
                   + (" bshd" if bshd else "") + (" lse" if lse else ""),
           "max_abs_err": max_err(got, want), "tol": TOL[dtype]}
    if lse:
        rec["lse_err"] = float(((row_lse - want_lse).abs() / want_lse.abs().clamp_min(1)).max())
        rec["max_abs_err"] = max(rec["max_abs_err"], rec["lse_err"])
    if dtype is torch.bfloat16:
        # the tensor-core kernel's grid, one block a (q tile, head, batch), in waves
        # of the blocks the card holds at once
        from repro_torch.kernels.flash_attention import tile_plan
        plan = tile_plan(D, Dv, min(Sq, Sk))
        rec["grid_blocks"] = B * H * -(-Sq // plan["q_rows"])
        rec["waves"] = rec["grid_blocks"] / (
            torch.cuda.get_device_properties(0).multi_processor_count * plan["blocks_per_sm"])
    del want, want_lse
    if timed:
        nbytes, flops = flash_work(q, k, causal, window, v)
        rec["bound_ms"], rec["bound_by"] = bound(nbytes, flops, dtype)
        call = lambda: flash_attention(q, k, v, causal=causal, window=window)  # noqa: E731
        rec["ms"] = time_ms(call)
        rec["device_ms"] = device_ms(call)
        rec["plain_ms"] = time_ms(
            lambda: flash_attention_lse_plain(q, k, v, causal=causal, window=window)[0], iters=5)
        # a window of at least Sk hides no key: SDPA computes the same function
        if (window == 0 or window >= Sk) and (causal is False or Sq == Sk):
            rec["library_ms"] = time_ms(sdpa_flash(q, k, v, causal))
            by_kernel = device_ms_by_kernel(sdpa_flash(q, k, v, causal))
            rec["library_device_ms"] = sum(by_kernel.values())
            if Dv is not None:
                # which of SDPA's backends ran: its flash backend takes one head dim
                rec["library_kernels"] = [name[:100] for name in by_kernel]
        else:
            rec["library_ms"] = rec["library_device_ms"] = None
    return rec


MLA_K1 = dict(B=1, H=128, Hkv=128, D=192, Dv=128, causal=True, window=0, bshd=True)


def row_err(got, want, zero_rows=()) -> float:
    """The largest error of a gradient row (its last dimension), in L2, over
    that row's reference norm, over the gradients given.  Row by row, so a row
    of small gradients (a late query's dQ, a late key's dK) is held to the
    same relative limit as the early rows' large ones.  A row that is zero by
    the arithmetic (``zero_rows``: for each gradient a bool per row, or None;
    dQ of a query that sees one key, whose softmax has no derivative) holds
    only rounding noise, and is measured against the gradient's RMS row norm;
    any row against at least 1 % of it.  NaN if any value is."""
    worst = []
    for i, (g, w) in enumerate(zip(got, want)):
        w = w.float().reshape(-1, w.shape[-1])
        rn = torch.linalg.vector_norm(w, dim=-1)
        rms = max(float(rn.square().mean().sqrt()), 1e-30)
        den = rn.clamp_min(FLOOR * rms)
        if i < len(zero_rows) and zero_rows[i] is not None:
            den = torch.where(zero_rows[i].to(den.device), torch.full_like(den, rms), den)
        d = torch.linalg.vector_norm(g.float().reshape(w.shape) - w, dim=-1)
        worst.append((d / den).max())
    return float(torch.stack(worst).max())


def scaled_err(got, want) -> float:
    """The largest error over the gradients, each relative to the larger of 1
    and its reference's largest magnitude (NaN if any value is)."""
    return float(torch.stack([(g.float() - w.float()).abs().max()
                              / max(1.0, float(w.float().abs().max()))
                              for g, w in zip(got, want)]).max())


def bwd_errs_ok(r) -> bool:
    """A backward record's two errors within their limits (a NaN is not), and
    what one skipped tile reads above the row limit."""
    return (r["scaled_err"] <= r["tol"] and r["row_err"] <= r["row_tol"]
            and all(e > r["row_tol"] for e in r.get("dropped_tile_row_err", {}).values()))


def grads_f32(fn, inputs, grad_out):
    """Autograd of ``fn`` in float32 on float32 copies of ``inputs`` (what a
    bfloat16 kernel is held to: its inputs' values, none of its roundings)."""
    leaves = [t.detach().float().requires_grad_() for t in inputs]
    outs = fn(*leaves)
    if isinstance(outs, torch.Tensor):
        outs, grad_out = (outs,), (grad_out,)
    return outs, torch.autograd.grad(outs, leaves, [g.float() for g in grad_out])


def attention_dropping_tile(q, k, v, *, causal, q0, k0, tile=64):
    """Attention in float32 as ``flash_attention_plain`` computes it, but with
    the query rows q0..q0+tile not seeing the keys k0..k0+tile: what a
    backward kernel that skipped one tile of one of its loops would compute
    the gradients of.  No window, no fully masked row."""
    B, H, Sq, D = q.shape
    G = H // k.shape[1]
    s = q @ k.repeat_interleave(G, 1).transpose(-1, -2) / math.sqrt(D)
    qp = torch.arange(Sq, device=q.device)[:, None]
    kp = torch.arange(k.shape[2], device=q.device)[None, :]
    seen = (kp <= qp) if causal else torch.ones_like(s[0, 0], dtype=torch.bool)
    seen = seen & ~((qp >= q0) & (qp < q0 + tile) & (kp >= k0) & (kp < k0 + tile))
    return torch.softmax(s.masked_fill(~seen, float("-inf")), -1) @ v.repeat_interleave(G, 1)


def flash_bwd_work(q, k, causal, window, v=None) -> tuple[float, float]:
    """(bytes, operations) of the backward: q, k, v, o, dO and lse read once,
    dq, dk, dv written once; 2.5 times the forward's operations (the
    tracer's factor for a backward attention node).  ``v``: a head dim of
    its own (MLA's), which o, dO and dv share; default k's."""
    B, H, Sq, D = q.shape
    Dv = D if v is None else v.shape[-1]
    nbytes = 2 * (q.numel() + k.numel()) * (D + Dv) // D * q.element_size() + 4 * B * H * Sq
    return nbytes, 2.5 * 2.0 * B * H * (D + Dv) * visible_pairs(Sq, k.shape[2], causal, window)


def off_by_4(t):
    """A copy of ``t`` whose base lies 4 elements past a 16-byte boundary (8
    bytes for bf16): the tensor-core backward needs 16, so this takes the
    FMA kernels."""
    buf = torch.empty(t.numel() + 4, dtype=t.dtype, device=t.device)
    out = buf[4:].view(t.shape)
    out.copy_(t)
    return out


def check_flash_bwd(rng, *, B, H, Hkv, Sq, Sk, D, causal, window, dtype, timed, bshd=False,
                    misaligned=False, Dv=None):
    """K1's backward (after its LSE forward) against autograd of the plain
    forward on the same inputs and dO; ``Dv``: v's head dim apart from q's
    and k's (MLA's 128 beside 192), which o and dO share."""
    from repro_torch.kernels import (flash_attention, flash_attention_bwd,
                                     flash_attention_bwd_plain, flash_attention_plain)
    Dv = D if Dv is None else Dv
    q, k, v = flash_inputs(rng, B=B, H=H, Hkv=Hkv, Sq=Sq, Sk=Sk, D=D, dtype=dtype, bshd=bshd,
                           Dv=Dv)
    do = flash_inputs(rng, B=B, H=H, Hkv=Hkv, Sq=Sq, Sk=Sk, D=Dv, dtype=dtype, bshd=bshd)[0]
    o = torch.empty_like(do)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device="cuda")
    flash_attention(q, k, v, causal=causal, window=window, out=o, lse=lse)
    if misaligned:
        q, k, v, o, do = (off_by_4(t) for t in (q, k, v, o, do))
    got = flash_attention_bwd(q, k, v, o, lse, do, causal=causal, window=window)
    torch.cuda.synchronize()
    plain = lambda *t: flash_attention_plain(*t, causal=causal, window=window)  # noqa: E731
    (want_o,), want = grads_f32(plain, (q, k, v), do)
    # the backward's own arithmetic in fp32 from the same inputs (bf16 ones
    # too: the forward's rounded o enters delta there as in the kernel)
    exact = flash_attention_bwd_plain(*(t.float() for t in (q, k, v, o)), lse, do.float(),
                                      causal=causal, window=window)
    one_key = torch.from_numpy(visible_per_row(Sq, Sk, causal, window) <= 1)
    zero = [one_key.expand(B, H, Sq).reshape(-1), None, None]
    rec = {"kernel": "flash_attention_bwd", "dtype": dt_name(dtype),
           "case": f"B{B} H{H} Hkv{Hkv} Sq{Sq} Sk{Sk} D{D}" + (f" Dv{Dv}" if Dv != D else "")
                   + f" causal{int(causal)} window{window}"
                   + (" bshd" if bshd else "") + (" misaligned" if misaligned else ""),
           "max_abs_err": max(max_err(a, b) for a, b in zip(got, want)),
           "scaled_err": scaled_err(got, want), "row_err": row_err(got, exact, zero),
           "err_of": "max_abs_err, scaled_err: dq, dk, dv against autograd of the plain forward "
                     "in fp32, scaled_err over max(1, max |autograd|); row_err: against "
                     "flash_attention_bwd_plain in fp32, the largest row error over its row's "
                     "norm; tol holds scaled_err, row_tol row_err",
           "tol": TOL[dtype], "row_tol": ROW_TOL[dtype], "o_err": max_err(o, want_o)}
    del exact
    if timed:
        # one 64 x 64 tile left out where the gradients are smallest (the last
        # q rows, the middle keys): row_err must read it above row_tol
        drop = lambda *t: attention_dropping_tile(*t, causal=causal, q0=Sq - 64,  # noqa: E731
                                                  k0=Sk // 2)
        _, dropped = grads_f32(drop, (q, k, v), do)
        rec["dropped_tile_row_err"] = {n: row_err([a], [b], [z])
                                       for n, a, b, z in zip(("dq", "dk", "dv"), dropped, want,
                                                             zero)}
        del dropped
    del want_o, want
    if timed:
        nbytes, flops = flash_bwd_work(q, k, causal, window, v)
        rec["bound_ms"], rec["bound_by"] = bound(nbytes, flops, dtype)
        call = lambda: flash_attention_bwd(q, k, v, o, lse, do, causal=causal,  # noqa: E731
                                           window=window)
        rec["ms"] = time_ms(call)
        rec["device_ms_by_kernel"] = device_ms_by_kernel(call)
        rec["device_ms"] = sum(rec["device_ms_by_kernel"].values())

        def plain():
            leaves = [t.detach().requires_grad_() for t in (q, k, v)]
            return torch.autograd.grad(flash_attention_plain(*leaves, causal=causal,
                                                             window=window), leaves, do)
        rec["plain_ms"] = time_ms(plain, iters=3)   # the plain forward and autograd's backward
        # a window of at least Sk hides no key: SDPA computes the same function
        if (window == 0 or window >= Sk) and (causal is False or Sq == Sk):
            leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
            lo = F.scaled_dot_product_attention(*leaves, is_causal=causal, enable_gqa=True)
            lib = lambda: torch.autograd.grad(lo, leaves, do, retain_graph=True)  # noqa: E731
            rec["library_ms"] = time_ms(lib)
            rec["library_device_ms"] = device_ms(lib)
            del lo, leaves
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
    sm_count, per_sm, rows, path = dec.kernel_plan(q.device, H // Hkv, D, dtype)
    head_blocks = dec.head_blocks(Hkv, H // Hkv, dtype)
    ns, chunk = dec.split_plan(B, head_blocks, T, sm_count=sm_count, blocks_per_sm=per_sm,
                               rows_per_iter=rows)
    rec = {"kernel": "decode_attention", "dtype": dt_name(dtype),
           "case": f"B{B} H{H} Hkv{Hkv} T{T} D{D} valid{valid}" + (" bthd" if bthd else ""),
           "path": path, "splits": ns, "chunk": chunk, "blocks_per_sm": per_sm,
           "head_blocks": head_blocks, "max_abs_err": max_err(got, want), "tol": TOL[dtype]}
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


def k2_forced_call(q, k, v, vl, ns: int, chunk: int, merge: bool):
    """A call of K2's library with a forced split plan (``ns`` splits of
    ``chunk`` rows), on scratch of its own.  ``merge`` False starts the
    splits' counters far below 0, so no block finds itself the last one and
    the call is the partial pass alone (the C entry keeps its arguments
    across trees of the port, so another tree's K2 runs here too)."""
    import importlib
    from repro_torch.kernels import _build
    dec = importlib.import_module("repro_torch.kernels.decode_attention")
    B, H, D = q.shape
    Hkv, T = k.shape[1], k.shape[2]
    acc = torch.empty(B * H * ns * D, dtype=torch.float32, device="cuda")
    ml = torch.empty(2 * B * H * ns, dtype=torch.float32, device="cuda")
    counter = torch.full((B * H,), 0 if merge else -(1 << 30), dtype=torch.int32, device="cuda")
    if vl is None:
        vl = torch.full((B,), T, dtype=torch.int32, device="cuda")
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), vl.data_ptr(), torch.empty_like(q).data_ptr(),
            acc.data_ptr(), ml.data_ptr(), ml.data_ptr() + 4 * B * H * ns, counter.data_ptr(),
            B, H, Hkv, T, D, ns, chunk, *k.stride()[:3], *v.stride()[:3], 1.0 / math.sqrt(D),
            _build.DTYPE_CODES[q.dtype])
    keep = (acc, ml, counter, vl)
    return lambda: (_build.launch(dec._lib().decode_attention_launch, q.device, "k2", *args), keep)


K2_PARTS_SHAPES = (
    # (name, B, H, Hkv, T, D, valid): the long_500k cell's decode, recurrentgemma's and
    # qwen2-vl's serving decode, and phi4-mini's G 3 at B1 (the FMA path in every tree)
    ("long_500k B1 G16 D256", 1, 16, 1, 2048, 256, [2048]),
    ("griffin B8 G16 D256 mixed", 8, 16, 1, 2048, 256, [1, 2048, 17, 1024, 300, 2047, 64, 1500]),
    ("vlm B8 G7 D128 mixed", 8, 28, 4, 2048, 128, [1, 2048, 17, 1024, 300, 2047, 64, 1500]),
    ("vlm B1 G7 D128", 1, 28, 4, 2048, 128, [2048]),
    ("phi4 B1 G3 D128", 1, 24, 8, 2048, 128, [2048]),
)


def k2_parts(rng) -> list:
    """K2's partial pass and its merge measured apart, in bf16 at the shapes
    of ``K2_PARTS_SHAPES``: for each number of rows a split from 16 to 2048
    that the kernel's rows an iteration (or a ring stage) divide, the call's
    device time with the merge and without it (:func:`k2_forced_call`), the
    difference being the merge's; and the plan's own choice beside SDPA +
    mask.  Another tree's K2 is measured by running this with
    ``CHIP_SMOKE_SRC``."""
    import importlib
    from repro_torch.kernels import decode_attention
    dec = importlib.import_module("repro_torch.kernels.decode_attention")
    out = []
    for name, B, H, Hkv, T, D, valid in K2_PARTS_SHAPES:
        q, k, v, vl = decode_inputs(rng, B=B, H=H, Hkv=Hkv, T=T, D=D, valid=valid,
                                    dtype=torch.bfloat16, bthd=True)
        rows = dec.kernel_plan(q.device, H // Hkv, D, q.dtype)[2]
        rec = {"shape": name, "case": f"B{B} H{H} Hkv{Hkv} T{T} D{D} valid{valid}",
               "rows_per_iter": rows, "sweep": []}
        for chunk in (16, 32, 64, 128, 256, 512, 1024, 2048):
            if chunk % rows:
                continue
            ns = -(-T // chunk)
            full = device_ms(k2_forced_call(q, k, v, vl, ns, chunk, merge=True))
            part = device_ms(k2_forced_call(q, k, v, vl, ns, chunk, merge=False)) \
                if ns > 1 else full
            rec["sweep"].append({"chunk": chunk, "splits": ns, "device_ms": full,
                                 "partial_ms": part, "merge_ms": full - part})
        rec["plan_device_ms"] = device_ms(lambda: decode_attention(q, k, v, kv_valid_len=vl))
        rec["sdpa_device_ms"] = device_ms(sdpa_decode(q, k, v, vl))
        out.append(rec)
    return out


# K1's backward at D 64 at whisper-large-v3's three train shapes (B8, 20 heads, G 1), and
# its forward at D 256 at recurrentgemma-9b's serving and train shapes (16 q heads on one kv
# head, its window of 2048 covering S) and gemma-7b's (16 heads of 256, G 1), each causal
K1_PARTS_BWD = (("whisper_enc", 8, 20, 20, 1500, 1500, False),
                ("whisper_cross", 8, 20, 20, 448, 1500, False),
                ("whisper_self", 8, 20, 20, 448, 448, True))
K1_PARTS_FWD = (("griffin_s1000", 1, 16, 1, 1000, 2048),
                ("griffin_s2048", 1, 16, 1, 2048, 2048),
                ("gemma_s2048", 1, 16, 16, 2048, 0))
# K1's forward at D 64 at whisper-large-v3's five shapes (20 heads, G 1): the encoder's self
# attention at the B1 prefill and the B8 train step, the cross attention of the B1 context
# prefill (224 rows) and of the train step (448), and the decoder's causal self attention
K1_PARTS_FWD64 = (("whisper_enc_b1", 1, 1500, 1500, False),
                  ("whisper_enc_b8", 8, 1500, 1500, False),
                  ("whisper_cross_b1", 1, 224, 1500, False),
                  ("whisper_cross_b8", 8, 448, 1500, False),
                  ("whisper_self_b8", 8, 448, 448, True))
# K1 at D 128, the main path's head dim, causal: its forward at the train shapes (S2048) of
# yi-34b (56 q heads on 8), qwen2.5-32b (40 on 8) and phi4-mini (24 on 8) and at the serving
# prefills (S1000) of those and of olmoe-1b-7b (16 on 16) and qwen2-vl-7b (28 on 4); its
# backward at the train shapes of yi-34b (G 7), qwen2.5-32b (G 5), phi4-mini (G 3) and
# qwen2-vl-7b (G 7)
K1_PARTS_FWD128 = (("yi_s2048", 1, 56, 8, 2048), ("qwen_s2048", 1, 40, 8, 2048),
                   ("phi4_s2048", 1, 24, 8, 2048), ("yi_s1000", 1, 56, 8, 1000),
                   ("qwen_s1000", 1, 40, 8, 1000), ("phi4_s1000", 1, 24, 8, 1000),
                   ("olmoe_s1000", 1, 16, 16, 1000), ("qwen2vl_s1000", 1, 28, 4, 1000))
K1_PARTS_BWD128 = (("yi_s2048", 1, 56, 8, 2048), ("qwen_s2048", 1, 40, 8, 2048),
                   ("phi4_s2048", 1, 24, 8, 2048), ("qwen2vl_s2048", 1, 28, 4, 2048))


def k1_parts(rng) -> list:
    """The kernels phase's checks at the part shapes, alone: K1's backward at
    D 64 at ``K1_PARTS_BWD``'s shapes and at D 128 at ``K1_PARTS_BWD128``'s
    (:func:`check_flash_bwd`, its device time by kernel: delta, dK/dV, [sum,]
    dQ), its forward at D 256 at ``K1_PARTS_FWD``'s, at D 64 at
    ``K1_PARTS_FWD64``'s and at D 128 at ``K1_PARTS_FWD128``'s
    (:func:`check_flash`: grid and waves too), in bf16 on the model's layout,
    each timed beside SDPA.  CHIP_SMOKE_SRC points it at another tree."""
    bf16 = torch.bfloat16
    out = []
    for name, B, H, Hkv, Sq, Sk, causal in K1_PARTS_BWD:
        out.append({"shape": name, **check_flash_bwd(rng, B=B, H=H, Hkv=Hkv, Sq=Sq, Sk=Sk, D=64,
                                                     causal=causal, window=0, dtype=bf16,
                                                     timed=True, bshd=True)})
    for name, B, H, Hkv, S, window in K1_PARTS_FWD:
        out.append({"shape": name, **check_flash(rng, B=B, H=H, Hkv=Hkv, Sq=S, Sk=S, D=256,
                                                 causal=True, window=window, dtype=bf16,
                                                 timed=True, bshd=True)})
    for name, B, Sq, Sk, causal in K1_PARTS_FWD64:
        out.append({"shape": name, **check_flash(rng, B=B, H=20, Hkv=20, Sq=Sq, Sk=Sk, D=64,
                                                 causal=causal, window=0, dtype=bf16,
                                                 timed=True, bshd=True)})
    for name, B, H, Hkv, S in K1_PARTS_FWD128:
        out.append({"shape": name, **check_flash(rng, B=B, H=H, Hkv=Hkv, Sq=S, Sk=S, D=128,
                                                 causal=True, window=0, dtype=bf16,
                                                 timed=True, bshd=True)})
    for name, B, H, Hkv, S in K1_PARTS_BWD128:
        out.append({"shape": name, **check_flash_bwd(rng, B=B, H=H, Hkv=Hkv, Sq=S, Sk=S, D=128,
                                                     causal=True, window=0, dtype=bf16,
                                                     timed=True, bshd=True)})
    return out


def check_ok(r) -> bool:
    """A kernel check's record within its limits (a NaN is not)."""
    if "ok" in r:       # a check that holds several measures (Adafactor's)
        return bool(r["ok"])
    return bwd_errs_ok(r) if "row_err" in r else r["max_abs_err"] <= r["tol"]


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


def check_rmsnorm_bwd(rng, *, R, D, dtype, w_dtype, offset, residual, timed, fused=False):
    """K3's backward against autograd of the plain forward: ``rmsnorm`` of x,
    or of x + residual, or with ``fused`` ``add_rmsnorm`` (whose sum has a
    gradient of its own, which joins dx).  x and the residual get the same
    gradient, so dx stands for both."""
    from repro_torch.kernels import (add_rmsnorm_plain, rmsnorm_bwd, rmsnorm_bwd_plain,
                                     rmsnorm_plain)
    residual = residual or fused
    x, w, r = rms_inputs(rng, R, D, dtype, w_dtype, offset, residual)
    dy = randn(rng, (R, D), dtype)
    ds = randn(rng, (R, D), dtype) if fused else None
    s = x + r if residual else x                     # what the forward normalised
    got = rmsnorm_bwd(s, w, dy, eps=1e-6, offset=offset, ds=ds)
    torch.cuda.synchronize()
    if fused:
        _, want = grads_f32(lambda x, r, w: add_rmsnorm_plain(x, r, w, eps=1e-6, offset=offset),
                            (x, r, w), (ds, dy))
    else:
        _, want = grads_f32(lambda x, w, *r: rmsnorm_plain(x, w, eps=1e-6, offset=offset,
                                                          residual=r[0] if r else None),
                            (x, w, r) if residual else (x, w), dy)
    want = (want[0], want[-1]) if fused else want[:2]     # dx (= d residual), dw
    exact = rmsnorm_bwd_plain(s.float(), w.float(), dy.float(), eps=1e-6, offset=offset,
                              ds=None if ds is None else ds.float())
    rec = {"kernel": "rmsnorm_bwd", "dtype": dt_name(dtype),
           "case": f"R{R} D{D} w:{dt_name(w_dtype)} offset{int(offset)} residual{int(residual)}"
                   + (" with sum" if fused else ""),
           "max_abs_err": max(max_err(a, b) for a, b in zip(got, want)),
           "scaled_err": scaled_err(got, want), "row_err": row_err(got, exact),
           "err_of": "max_abs_err, scaled_err: dx, dw against autograd of the plain forward in "
                     "fp32, scaled_err over max(1, max |autograd|); row_err: against "
                     "rmsnorm_bwd_plain in fp32, the largest error of a row of dx, and of dw, "
                     "over its norm; tol holds scaled_err, row_tol row_err",
           "tol": TOL[dtype], "row_tol": ROW_TOL[dtype]}
    if timed:
        nbytes = ((3 + int(fused)) * x.numel() * x.element_size()
                  + 2 * w.numel() * w.element_size())
        rec["bound_ms"], rec["bound_by"] = bound(nbytes, 10.0 * x.numel(), torch.float32)
        call = lambda: rmsnorm_bwd(s, w, dy, eps=1e-6, offset=offset, ds=ds)  # noqa: E731
        rec["ms"] = time_ms(call)
        rec["device_ms_by_kernel"] = device_ms_by_kernel(call)
        rec["device_ms"] = sum(rec["device_ms_by_kernel"].values())

        def plain():
            xl, wl = x.detach().requires_grad_(), w.detach().requires_grad_()
            rl = r.detach().requires_grad_() if residual else None
            if fused:
                return torch.autograd.grad(add_rmsnorm_plain(xl, rl, wl, offset=offset),
                                           (xl, wl), (ds, dy))
            return torch.autograd.grad(rmsnorm_plain(xl, wl, offset=offset, residual=rl),
                                       (xl, wl), dy)
        rec["plain_ms"] = time_ms(plain)
        if not offset and not residual:
            xl = x.detach().clone().requires_grad_()
            wl = w.detach().to(dtype).requires_grad_()
            ly = F.rms_norm(xl, (D,), wl, 1e-6)
            lib = lambda: torch.autograd.grad(ly, (xl, wl), dy, retain_graph=True)  # noqa: E731
            rec["library_ms"] = time_ms(lib)
            rec["library_device_ms"] = device_ms(lib)
        else:
            rec["library_ms"] = rec["library_device_ms"] = None
    return rec


def check_adamw(rng, *, n, p_dtype, g_dtype, timed, misaligned=False):
    """The fused AdamW update against its plain (unfused) version on copies
    of the same p, g, m, v at step 3 of the launcher's schedule: p, m and v
    after one update (bit-equal expected: the same roundings in the same
    order)."""
    from repro_torch.kernels import adamw_update, adamw_update_plain
    from repro_torch.training.optimizer import cosine_schedule
    off = 1 if misaligned else 0
    p = randn(rng, (n + off,), torch.float32).mul_(0.02).to(p_dtype)[off:]
    g = randn(rng, (n + off,), torch.float32).mul_(0.01).to(g_dtype)[off:]
    m = randn(rng, (n + off,), torch.float32).mul_(0.01)[off:]
    v = randn(rng, (n + off,), torch.float32).square_().mul_(1e-4)[off:]
    step = torch.tensor(3, dtype=torch.int32, device="cuda")
    hp = dict(lr=cosine_schedule(3e-4)(step), b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1)
    hp["c1"] = 1.0 - torch.pow(torch.tensor(0.9, device="cuda"), step.float())
    hp["c2"] = 1.0 - torch.pow(torch.tensor(0.95, device="cuda"), step.float())
    mine = [t.clone() for t in (p, m, v)]
    plain = [t.clone() for t in (p, m, v)]
    adamw_update(mine[0], g, mine[1], mine[2], **hp)
    torch.cuda.synchronize()
    adamw_update_plain(plain[0], g, plain[1], plain[2], **hp)
    rec = {"kernel": "adamw", "dtype": dt_name(p_dtype),
           "case": f"n{n} p:{dt_name(p_dtype)} g:{dt_name(g_dtype)}"
                   + (" misaligned" if misaligned else ""),
           "max_abs_err": max(max_err(a, b) for a, b in zip(mine, plain)), "tol": TOL[p_dtype],
           "bit_equal": all(torch.equal(a, b) for a, b in zip(mine, plain))}
    if timed:
        pe, ge = p.element_size(), g.element_size()
        rec["bound_ms"], rec["bound_by"] = bound(n * (2 * pe + ge + 16), 15.0 * n, torch.float32)
        call = lambda: adamw_update(mine[0], g, mine[1], mine[2], **hp)  # noqa: E731
        rec["ms"] = time_ms(call)
        rec["device_ms"] = device_ms(call)
        rec["plain_ms"] = time_ms(lambda: adamw_update_plain(plain[0], g, plain[1], plain[2], **hp))
        if p_dtype == g_dtype == torch.float32:
            # PyTorch's fused AdamW: the same update (weight decay as p (1 - lr wd)), fp32
            # moments for fp32 parameters; for bf16 parameters it keeps bf16 moments, which
            # is another function
            w = mine[0].clone().requires_grad_()
            w.grad = g.clone()
            opt = torch.optim.AdamW([w], lr=float(hp["lr"]), betas=(0.9, 0.95), eps=1e-8,
                                    weight_decay=0.1, fused=True)
            rec["library_ms"] = time_ms(opt.step)
            rec["library_device_ms"] = device_ms(opt.step)
            del opt, w
        else:
            rec["library_ms"] = rec["library_device_ms"] = None
    del mine, plain, p, g, m, v
    torch.cuda.empty_cache()
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


# blocks of K3's backward timed beside the plan's, at the train path's rows
RMS_BWD_PARTS = (132, 264, 396, 528, 660)


def rms_bwd_parts_times(rng) -> list:
    """Device time of K3's backward at R2048 D3072 bf16, norm only and with
    the sum's gradient, for each number of blocks of ``RMS_BWD_PARTS``, each
    checked against the plain backward."""
    import importlib
    rms = importlib.import_module("repro_torch.kernels.rmsnorm")
    bf16 = torch.bfloat16
    chosen = rms.bwd_launch_plan(3072, bf16, 2048)[3]
    out = []
    for with_sum in (False, True):
        x, w, _ = rms_inputs(rng, 2048, 3072, bf16, bf16, False, False)
        dy = randn(rng, (2048, 3072), bf16)
        ds = randn(rng, (2048, 3072), bf16) if with_sum else None
        want = rms.rmsnorm_bwd_plain(x.float(), w.float(), dy.float(),
                                     ds=None if ds is None else ds.float())
        for parts in RMS_BWD_PARTS:
            call = lambda: rms.rmsnorm_bwd(x, w, dy, ds=ds, parts=parts)  # noqa: E731
            err = row_err(call(), want)
            out.append({"case": "R2048 D3072 bf16" + (" with sum" if with_sum else ""),
                        "parts": parts, "chosen": parts == chosen, "row_err": err,
                        "device_ms": device_ms(call)})
            if not err <= ROW_TOL[bf16]:
                fail(f"rmsnorm_bwd with {parts} blocks: row error {err}")
    return out


def determinism_checks(rng) -> list:
    """Each backward twice from the same inputs at its train shape (K1 also
    at a group of 5 and of 1, whose partial sums differ, at yi-34b's group of
    7, whose blocks add their dK and dV in turns, at MLA's (192, 128), at a
    group of 16 at D 256 and at whisper's encoder at D 64), K1's forward
    twice at D 256 (recurrentgemma's and gemma-7b's shapes), at D 64
    (whisper's encoder at B8) and at D 128 (yi-34b's train shape), and K2
    twice at a single sequence of a group of 16 and at a batch of a group of
    7: every output must be the same bits."""
    from repro_torch.kernels import (decode_attention, flash_attention, flash_attention_bwd,
                                     rmsnorm_bwd)
    bf16 = torch.bfloat16
    out = []
    for B, H, Hkv, S in ((1, 24, 8, 2048), (2, 40, 8, 333), (1, 8, 8, 200), (1, 56, 8, 2048)):
        q, k, v = flash_inputs(rng, B=B, H=H, Hkv=Hkv, Sq=S, Sk=S, D=128, dtype=bf16, bshd=True)
        do = flash_inputs(rng, B=B, H=H, Hkv=Hkv, Sq=S, Sk=S, D=128, dtype=bf16, bshd=True)[0]
        o = torch.empty_like(do)
        lse = torch.empty((B, H, S), dtype=torch.float32, device="cuda")
        flash_attention(q, k, v, causal=True, out=o, lse=lse)
        runs = [flash_attention_bwd(q, k, v, o, lse, do, causal=True) for _ in range(2)]
        out.append({"kernel": "flash_attention_bwd", "case": f"B{B} H{H} Hkv{Hkv} S{S} D128 "
                    "causal bshd", "bit_equal": all(torch.equal(a, b) for a, b in zip(*runs))})
    # deepseek-v3-671b's train shape at MLA's (192, 128)
    q, k, v = flash_inputs(rng, B=1, H=128, Hkv=128, Sq=2048, Sk=2048, D=192, Dv=128, dtype=bf16,
                           bshd=True)
    do = flash_inputs(rng, B=1, H=128, Hkv=128, Sq=2048, Sk=2048, D=128, dtype=bf16,
                      bshd=True)[0]
    o = torch.empty_like(do)
    lse = torch.empty((1, 128, 2048), dtype=torch.float32, device="cuda")
    flash_attention(q, k, v, causal=True, out=o, lse=lse)
    runs = [flash_attention_bwd(q, k, v, o, lse, do, causal=True) for _ in range(2)]
    out.append({"kernel": "flash_attention_bwd", "case": "B1 H128 Hkv128 S2048 D192 Dv128 "
                "causal bshd", "bit_equal": all(torch.equal(a, b) for a, b in zip(*runs))})
    # recurrentgemma-9b's: 16 q heads on one kv head at D 256, the partials of 16 summed
    q, k, v = flash_inputs(rng, B=1, H=16, Hkv=1, Sq=2048, Sk=2048, D=256, dtype=bf16, bshd=True)
    do = flash_inputs(rng, B=1, H=16, Hkv=1, Sq=2048, Sk=2048, D=256, dtype=bf16, bshd=True)[0]
    o = torch.empty_like(do)
    lse = torch.empty((1, 16, 2048), dtype=torch.float32, device="cuda")
    flash_attention(q, k, v, causal=True, window=2048, out=o, lse=lse)
    runs = [flash_attention_bwd(q, k, v, o, lse, do, causal=True, window=2048) for _ in range(2)]
    out.append({"kernel": "flash_attention_bwd", "case": "B1 H16 Hkv1 S2048 D256 causal "
                "window2048 bshd", "bit_equal": all(torch.equal(a, b) for a, b in zip(*runs))})
    # whisper-large-v3's encoder at D 64 (B8 H20 S1500, not causal): three dK/dV blocks an SM
    q, k, v = flash_inputs(rng, B=8, H=20, Hkv=20, Sq=1500, Sk=1500, D=64, dtype=bf16, bshd=True)
    do = flash_inputs(rng, B=8, H=20, Hkv=20, Sq=1500, Sk=1500, D=64, dtype=bf16, bshd=True)[0]
    o = torch.empty_like(do)
    lse = torch.empty((8, 20, 1500), dtype=torch.float32, device="cuda")
    flash_attention(q, k, v, causal=False, out=o, lse=lse)
    runs = [flash_attention_bwd(q, k, v, o, lse, do, causal=False) for _ in range(2)]
    out.append({"kernel": "flash_attention_bwd", "case": "B8 H20 Hkv20 S1500 D64 bshd",
                "bit_equal": all(torch.equal(a, b) for a, b in zip(*runs))})
    # K1's forward at D 256 (its flat grid): recurrentgemma's S1000 with its window,
    # gemma-7b's S2048
    for H, Hkv, S, window in ((16, 1, 1000, 2048), (16, 16, 2048, 0)):
        q, k, v = flash_inputs(rng, B=1, H=H, Hkv=Hkv, Sq=S, Sk=S, D=256, dtype=bf16, bshd=True)
        runs = [flash_attention(q, k, v, causal=True, window=window) for _ in range(2)]
        out.append({"kernel": "flash_attention", "case": f"B1 H{H} Hkv{Hkv} S{S} D256 causal "
                    f"window{window} bshd", "bit_equal": torch.equal(*runs)})
    # ... and at D 64 (kv tiles of 128 rows, three blocks an SM): whisper's encoder at B8
    q, k, v = flash_inputs(rng, B=8, H=20, Hkv=20, Sq=1500, Sk=1500, D=64, dtype=bf16, bshd=True)
    runs = [flash_attention(q, k, v, causal=False) for _ in range(2)]
    out.append({"kernel": "flash_attention", "case": "B8 H20 Hkv20 S1500 D64 bshd",
                "bit_equal": torch.equal(*runs)})
    # ... and at D 128 (two consumer warpgroups in turns): yi-34b's train shape
    q, k, v = flash_inputs(rng, B=1, H=56, Hkv=8, Sq=2048, Sk=2048, D=128, dtype=bf16, bshd=True)
    runs = [flash_attention(q, k, v, causal=True) for _ in range(2)]
    out.append({"kernel": "flash_attention", "case": "B1 H56 Hkv8 S2048 D128 causal bshd",
                "bit_equal": torch.equal(*runs)})
    del q, k, v, o, do, lse, runs
    x, w, r = rms_inputs(rng, 2048, 3072, bf16, bf16, False, True)
    dy, ds = randn(rng, (2048, 3072), bf16), randn(rng, (2048, 3072), bf16)
    runs = [rmsnorm_bwd(x + r, w, dy, ds=ds) for _ in range(2)]
    out.append({"kernel": "rmsnorm_bwd", "case": "R2048 D3072 with sum",
                "bit_equal": all(torch.equal(a, b) for a, b in zip(*runs))})
    # K2's merge sums the splits in split order: the long_500k cell's B1 G 16 at D 256
    # (32 splits) and qwen2-vl's B8 G 7 serving mix, each on the tensor-core kernel
    for B, H, Hkv, D, valid in ((1, 16, 1, 256, [2048]),
                                (8, 28, 4, 128, [1, 2048, 17, 1024, 300, 2047, 64, 1500])):
        q, k, v, vl = decode_inputs(rng, B=B, H=H, Hkv=Hkv, T=2048, D=D, valid=valid,
                                    dtype=bf16, bthd=True)
        runs = [decode_attention(q, k, v, kv_valid_len=vl) for _ in range(2)]
        out.append({"kernel": "decode_attention", "case": f"B{B} H{H} Hkv{Hkv} T2048 D{D} "
                    f"valid{valid} bthd", "bit_equal": torch.equal(*runs)})
    return out


def sharded_attention_check(rng) -> dict:
    """A DTensor prefill (K1) and decode with ragged valid lengths (K2) in
    bf16 through ``layers.attention(strategy="kernel")`` on a (1, 1) mesh of a
    real NCCL world of one rank, sharded over batch and kv heads: the local
    case, which runs the kernels on each rank's shards under ``local_map``.
    Each result must be the plain-tensor call's bits, and its kernel's launch
    count must move (no plain stand-in)."""
    import tempfile

    import torch.distributed as dist
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch import kernels as K
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import layers as L
    bf16 = torch.bfloat16
    B, S, T, Hkv, G, D = 2, 512, 2048, 8, 3, 128          # phi4-mini's heads
    q, k, v = (randn(rng, (B, S, Hkv, G, D), bf16), randn(rng, (B, S, Hkv, D), bf16),
               randn(rng, (B, S, Hkv, D), bf16))
    qd, kc, vc = (randn(rng, (B, 1, Hkv, G, D), bf16), randn(rng, (B, T, Hkv, D), bf16),
                  randn(rng, (B, T, Hkv, D), bf16))
    valid = torch.tensor([T, 700], dtype=torch.int32, device="cuda")
    calls = {"prefill": ((q, k, v), dict(causal=True), "flash_attention"),
             "decode": ((qd, kc, vc), dict(causal=False, kv_valid_len=valid), "decode_attention")}
    out = {}
    with tempfile.TemporaryDirectory(dir=HERE) as tmp:
        store = dist.FileStore(os.path.join(tmp, "store"), 1)
        dist.init_process_group("nccl", store=store, rank=0, world_size=1)
        try:
            mesh = make_mesh((1, 1), ("data", "model"))
            for kind, (args, kw, kernel) in calls.items():
                dts = [distribute_tensor(a, mesh, [Shard(0), Shard(2)]) for a in args]
                kw_d = dict(kw)
                if "kv_valid_len" in kw:
                    kw_d["kv_valid_len"] = distribute_tensor(valid, mesh, [Shard(0), Replicate()])
                with torch.no_grad():
                    want = L.attention(*args, strategy="kernel", **kw)
                    K.reset_launch_counts()
                    got = L.attention(*dts, strategy="kernel", **kw_d)
                    torch.cuda.synchronize()
                    launches = K.launch_counts()
                out[kind] = {"kernel": kernel, "launches": launches[kernel],
                             "other_launches": sum(launches.values()) - launches[kernel],
                             "placements": [str(p) for p in got.placements],
                             "bit_equal": torch.equal(got.full_tensor(), want)}
        finally:
            dist.destroy_process_group()
    bad = {kind: r for kind, r in out.items()
           if not r["bit_equal"] or r["launches"] != 1 or r["other_launches"] != 0}
    if bad:
        fail(f"sharded attention on the card: {bad}")
    return out


def check_plans(recs_plans: dict) -> None:
    """The wrappers' host-side plans against what the compiled kernels
    report: K1's tiles and shared memory, its backward's tiles, shared memory
    and workspace bytes, K2's rows an iteration, K3's threads, chunks and
    vector, and its backward's blocks."""
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
        for S in (333, 1000, fa.PAIR_MIN_KEYS - 1, fa.PAIR_MIN_KEYS, 2048):
            mine, theirs = fa.tile_plan(D, None, S), fa.kernel_plan(D, None, S)
            recs_plans[f"flash D{D} S{S}"] = theirs
            if mine != theirs:
                fail(f"flash_attention plan D={D} S={S}: wrapper {mine}, kernel {theirs}")
    mine, theirs = fa.tile_plan(*fa.MLA_D), fa.kernel_plan(*fa.MLA_D)
    recs_plans[f"flash D{fa.MLA_D[0]} Dv{fa.MLA_D[1]}"] = theirs
    if mine != theirs:
        fail(f"flash_attention plan {fa.MLA_D}: wrapper {mine}, kernel {theirs}")
    for dims in fa.BWD_TC_DIMS:
        mine, theirs = fa.bwd_tile_plan(*dims), fa.kernel_bwd_plan(*dims)
        recs_plans[f"flash_bwd D{dims[0]} Dv{dims[1]}"] = theirs
        if mine != theirs:
            fail(f"flash_attention_bwd plan {dims}: wrapper {mine}, kernel {theirs}")
    for dims in [(D, D) for D in fa.SUPPORTED_D] + [fa.MLA_D]:
        mine, theirs = fa.bwd_fma_plan(*dims), fa.kernel_bwd_fma_plan(*dims)
        recs_plans[f"flash_bwd fma D{dims[0]} Dv{dims[1]}"] = theirs
        if mine != theirs:
            fail(f"flash_attention_bwd FMA plan {dims}: wrapper {mine}, kernel {theirs}")
    for shape in ((1, 24, 8, 2048, 2048, 128), (2, 40, 8, 333, 333, 128), (1, 8, 8, 200, 200, 128),
                  (1, 16, 16, 300, 300, 256), (2, 8, 1, 192, 192, 64), (1, 4, 2, 300, 100, 64),
                  (8, 20, 20, 448, 1500, 64), (8, 20, 20, 1500, 1500, 64),      # whisper
                  (1, 128, 128, 2048, 2048, 192, 128), (2, 16, 4, 333, 333, 192, 128),  # MLA
                  (1, 16, 1, 2048, 2048, 256), (1, 16, 16, 2048, 2048, 256),  # D 256, G 16 / 1
                  (1, 40, 8, 2048, 2048, 128), (1, 56, 8, 2048, 2048, 128)):  # qwen2.5, yi
        for dtype in (torch.bfloat16, torch.float32):
            for aligned in (True, False):
                mine = fa.bwd_workspace_bytes(*shape[:6], dtype, aligned, *shape[6:])
                theirs = fa.kernel_bwd_workspace_bytes(*shape[:6], dtype, aligned, *shape[6:])
                if mine != theirs:
                    fail(f"flash_attention_bwd workspace {shape} {dt_name(dtype)} aligned={aligned}: "
                         f"wrapper {mine}, kernel {theirs}")
        recs_plans[f"flash_bwd workspace B{shape[0]} H{shape[1]} Hkv{shape[2]} S{shape[3]} "
                   f"D{shape[5]} bf16"] = fa.kernel_bwd_workspace_bytes(
                       *shape[:6], torch.bfloat16, True, *shape[6:])
        # at D 128 a group's blocks add into one fp32 sum a kv head: no q head's partials
        B, H, Hkv, _, Sk, D = shape[:6]
        partials = B * H * Sk * 2 * D * 4
        if (D, *shape[6:]) == (128,) and H > Hkv and \
                fa.kernel_bwd_workspace_bytes(*shape[:6], torch.bfloat16, True) >= partials:
            fail(f"flash_attention_bwd workspace {shape}: the (B, H, Sk, D) partials are back")
    for dtype in (torch.bfloat16, torch.float32):
        for D in (64, 100, 256, 3072, 5120, 16384):
            for aligned in (True, False):
                for rows in (1, 8, 255, 256, 528, 2048):
                    mine = rms.bwd_launch_plan(D, dtype, rows, aligned=aligned)
                    theirs = rms.kernel_bwd_plan(D, dtype, rows, aligned=aligned)
                    if mine != theirs:
                        fail(f"rmsnorm_bwd plan {dt_name(dtype)} D={D} rows={rows} aligned={aligned}:"
                             f" wrapper {mine}, kernel {theirs}")
    recs_plans["rmsnorm_bwd bf16 D3072 R2048"] = list(rms.kernel_bwd_plan(3072, torch.bfloat16, 2048))
    dev = torch.device("cuda", torch.cuda.current_device())
    for dtype in (torch.bfloat16, torch.float32):
        for D in dec.SUPPORTED_D:
            for G in dec.SUPPORTED_G:
                sm_count, per_sm, rows, path = dec.kernel_plan(dev, G, D, dtype)
                recs_plans[f"decode {dt_name(dtype)} D{D} G{G}"] = {
                    "sm_count": sm_count, "blocks_per_sm": per_sm, "rows": rows, "path": path}
                want = (dec.plan_rows(G, D, dtype), dec.kernel_path(G, dtype))
                if (rows, path) != want or per_sm < 1:
                    fail(f"decode_attention plan {dt_name(dtype)} D={D} G={G}: kernel "
                         f"{(per_sm, rows, path)}, wrapper {want}")
                if path == "tensor_cores" and D <= 128 and per_sm < 2:
                    fail(f"decode_attention: the tensor-core kernel at D {D} G {G} holds "
                         f"{per_sm} block an SM (2 wanted)")
        for G in dec.SUPPORTED_G:
            mine, theirs = dec.heads_a_block(G, dtype), dec.kernel_heads_a_block(G, dtype)
            recs_plans[f"decode heads_a_block {dt_name(dtype)} G{G}"] = theirs
            if mine != theirs:
                fail(f"decode_attention heads a block for {dt_name(dtype)} G={G}: wrapper "
                     f"{mine}, kernel {theirs}")
    for B in (1, 2, 3, 8, 32, 128):
        for HB in (1, 2, 4, 8, 16, 20):
            for T in (1, 63, 64, 300, 448, 1500, 2048, 16384, 524288):
                for per_sm in (1, 2, 4, 5):
                    for rows in (8, 16, 32, 64):
                        mine = dec.split_plan(B, HB, T, sm_count=132, blocks_per_sm=per_sm,
                                              rows_per_iter=rows)
                        theirs = dec.kernel_split_plan(B, HB, T, 132, per_sm, rows)
                        if mine != theirs:
                            fail(f"decode_attention split plan B{B} HB{HB} T{T} per_sm{per_sm}"
                                 f" rows{rows}: wrapper {mine}, kernel {theirs}")
    recs_plans["decode split_plan B1 HB1 T2048 2/SM rows32"] = dec.kernel_split_plan(
        1, 1, 2048, 132, 2, 32)


# --------------------------------------------------------------------------
# Adafactor's update of a layer group (csrc/adafactor.cu)
# --------------------------------------------------------------------------

AF_STATE_TOL = 1e-5     # vr, vc, v: largest elementwise relative error against the plain version
AF_UPDATE_TOL = 1e-5    # an fp32 parameter's change: relative L2 against the plain version's
# A bf16 parameter's change: relative L2 against the plain version's.  On an
# H100 80GB HBM3 at 700 W the sound kernels read 0 to 5.5e-5 over these cases
# (elements whose fp32 result lies within 1e-7 of a bf16 rounding tie come
# out one ulp apart), and the controls below 1.1e-2 (the step 1 % off) to 1.0.
AF_BF16_UPDATE_TOL = 2e-4
AF_HP = dict(eps1=1e-30, eps2=1e-3, clip_threshold=1.0, weight_decay=0.0)
# Each case runs at an lr that moves a parameter by many of its last places,
# so that the change, and not only its rounding, is held to the plain
# version's.  At the launcher's step-3 lr (9e-6) a step moves a parameter of
# 0.02 by about 1e-7: a hundred fp32 ulps, but 1/700 of a bf16 ulp, where a
# bf16 parameter would come out equal to its input whatever the update.  So
# the fp32 cases run at PARITY_LR (1e-3: about 1e4 fp32 ulps) and the bf16
# ones at AF_BF16_LR (a step of lr x RMS(p) x u, about 1e-2, some 80 bf16
# ulps); beta2 keeps the step's value.
AF_BF16_LR = 0.5
# Controls: the same relative L2 of the plain version's change against the
# plain version under an error the kernels could make, which must exceed the
# case's limit: the step's size 1 % off (lr x 1.01), the clip forced to 1
# (where the case makes the clip bite), the apply left out (p unchanged).
AF_CONTROL_LR = 1.01


def af_chunks(*lists, n=1 << 25):
    """Aligned flat chunks of n elements of the layers of each list (so a
    full-size group's float64 temporaries stay at a few hundred MB)."""
    for ts in zip(*lists):
        flat = [t.reshape(-1) for t in ts]
        for i in range(0, flat[0].numel(), n):
            yield [f[i:i + n].double() for f in flat]


def af_sq_dist(xs, ys) -> float:
    return sum(float((x - y).square().sum()) for x, y in af_chunks(xs, ys))


def af_operand_ulps(mine, plain, before) -> float:
    """The largest |mine - plain| of a bf16 parameter in bf16 ulps at the
    larger magnitude of the parameter before and after the plain update.
    Where the step cancels the parameter (p - lr x scale x u near 0) the
    result's own last place is far finer than the rounding of the fp32
    operands, and a 1e-7 relative difference in u shows there as many of
    its ulps; at the operands' magnitude it is at most one."""
    worst = 0.0
    for a, b, p0 in af_chunks(mine, plain, before):
        mag = torch.maximum(p0.abs(), b.abs())
        ulp = torch.ldexp(torch.ones_like(mag), torch.frexp(mag).exponent - 8)
        ulp = ulp.clamp_min(2.0 ** -133)      # bf16's smallest subnormal
        worst = max(worst, float(((a - b).abs() / ulp).max()))
    return worst


def af_scalars(step: int) -> dict:
    """lr and beta2 of the launcher's schedule at ``step``, as the optimizer
    computes them (0-d fp32 tensors on the card)."""
    from repro_torch.training.optimizer import cosine_schedule
    s = torch.tensor(step, dtype=torch.int32, device="cuda")
    return {"lr": cosine_schedule(3e-4)(s), "beta2": 1.0 - s.to(torch.float32) ** -0.8}


def af_group(gen, layers, shape, p_dtype, g_dtype, *, g_scale=1.0, misaligned=False,
             g_rows=None):
    """(g layers, p layers, state) on the card from ``gen``: p ~ 0.02 N(0, 1)
    as a trained weight, g ~ 1e-3 g_scale N(0, 1), the state a positive
    second moment of gradients of 1e-3 (step 3's, or zeros for step 1's use
    as the step sets beta2 = 0).  ``layers`` None: one unstacked tensor.
    ``misaligned``: every layer's base one element off its allocation.
    ``g_rows(g)``: rewrites a layer's g (fp32, its last two dims rows and
    columns) before it takes its dtype."""
    from repro_torch.kernels import adafactor as AF
    off = 1 if misaligned else 0

    def one(dtype, scale, rows=None):
        n = math.prod(shape)
        t = torch.randn(n + off, generator=gen, device="cuda", dtype=torch.float32)
        t.mul_(scale)
        if rows is not None:
            rows(t[off:].view(shape))
        return t.to(dtype)[off:].view(shape)
    n_layers = 1 if layers is None else layers
    gs = [one(g_dtype, 1e-3 * g_scale, g_rows) for _ in range(n_layers)]
    ps = [one(p_dtype, 0.02) for _ in range(n_layers)]
    full = tuple(shape) if layers is None else (layers, *shape)

    def moment(sh):
        return torch.rand(sh, generator=gen, device="cuda").add_(0.5).mul_(1e-6)
    if AF.factored(full):
        state = {"vr": moment(full[:-1]), "vc": moment((*full[:-2], full[-1]))}
    else:
        state = {"v": moment(full)}
    return gs, ps, state


def af_copy(ps, state):
    return [t.clone() for t in ps], {k: v.clone() for k, v in state.items()}


def af_rows_zero_and_1e2(g):
    """A fresh state's case whose guard holds: rows of g exactly 0 beside rows
    of exactly 1e2 (a zero row's vr is eps1-small, but no nonzero g meets it)."""
    g.copy_(torch.where(torch.arange(g.shape[-2], device=g.device)[:, None] % 2 == 0, 0.0, 1e2)
            .expand_as(g))


def af_rows_guard_fails(g):
    """A case whose guard fails: a quarter of the rows 0, a quarter tiny
    (1e-18: their vr stays near eps1), the odd columns scaled by 0.1, so a
    tiny row's denominator in such a column falls under eps1 and a clamp
    bites on a nonzero g."""
    R = g.shape[-2]
    i = torch.arange(R, device=g.device)
    g.mul_(torch.where(i < R // 4, 0.0, torch.where(i < R // 2, 1e-15, 1.0))[:, None])
    g[..., 1::2].mul_(0.1)


# af_rows_kernel's other tile plans timed beside the shipped one: (rows a tile, stages)
AF_TILE_VARIANTS = ((1, 3), (2, 2), (2, 3), (4, 2), (8, 2), (16, 4), (32, 4))


def af_tile_plans(gs, ps, state, plan, hp) -> dict:
    """The update of one group on the shipped plan and on AF_TILE_VARIANTS
    (those that fit one block's shared memory and no larger than a slab
    needs), CUDA events in turns, the shipped plan first: {"trT_stS": [ms, ms]}.
    Another tile changes the order of some sums, so their bits may differ."""
    from repro_torch.kernels import adafactor as AF
    sg, sp = gs[0].element_size(), ps[0].element_size()
    plans = {f"tr{plan['tile_rows']}_st{plan['stages']}": plan}
    for tr, st in AF_TILE_VARIANTS:
        smem = AF.rows_smem(tr, st, plan["C"], sg, sp, plan["lanes"], plan["vec"])
        if smem <= AF.ROWS_SMEM and tr <= max(4, plan["slab_rows"]):
            plans.setdefault(f"tr{tr}_st{st}", plan | {"tile_rows": tr, "stages": st})
    turns = {k: [] for k in plans}
    for _ in range(2):
        for k, pl in plans.items():
            turns[k].append(time_ms(lambda pl=pl: AF.launch_group(gs, ps, state, pl, **hp),
                                    iters=3, warmup=1))
    return turns


def check_adafactor(gen, name, layers, shape, *, p_dtype, g_dtype, step=3, g_scale=1.0,
                    misaligned=False, timed=False, g_rows=None, fresh=False, guard=None):
    """Adafactor's update of one group by the kernels against its plain
    version on copies of the same g, p and state: vr, vc or v within
    AF_STATE_TOL (elementwise relative); the parameter's change within
    AF_UPDATE_TOL (fp32) or AF_BF16_UPDATE_TOL (bf16) relative L2 of the
    plain version's, with the controls above it; a bf16 parameter within one
    bf16 ulp at its operands' magnitude (its last-place distance and the
    share that differs reported); the kernels twice from the same inputs
    give the same bits; which path gave the update's sum of u^2 (the
    statistics pass where its guard held, else the u^2 pass), which must be
    ``guard`` where that is given.  ``g_rows``: rewrites g (af_group);
    ``fresh``: the state zeroed (as step 1 leaves it before the step).
    ``timed``: the kernels' time (CUDA events and device time, also by
    kernel) beside their bytes bounds: one read of g and p and one write of
    p (the state read and written once), five passes (g read twice, p twice,
    p written once) and six (g three times, as a pass of its own for u^2
    reads it); the plain version's
    time and ``torch.optim.Adafactor(foreach=True)`` on the same leaves."""
    from repro_torch.kernels import adafactor as AF
    from repro_torch.kernels import adafactor_update, adafactor_update_plain
    gs, ps, state = af_group(gen, layers, shape, p_dtype, g_dtype, g_scale=g_scale,
                             misaligned=misaligned, g_rows=g_rows)
    if step == 1 or fresh:
        for t in state.values():
            t.zero_()
    hp = {**af_scalars(step), **AF_HP}
    hp["lr"] = torch.tensor(PARITY_LR if p_dtype == torch.float32 else AF_BF16_LR,
                            dtype=torch.float32, device="cuda")
    tol = AF_UPDATE_TOL if p_dtype == torch.float32 else AF_BF16_UPDATE_TOL
    plan = AF.group_plan(gs, ps, state, AF.sms_of(ps[0].device))
    mine, mine_s = af_copy(ps, state)
    again, again_s = af_copy(ps, state)
    plain, plain_s = af_copy(ps, state)
    before = [t.clone() for t in ps]
    work = adafactor_update(gs, mine, mine_s, **hp)
    adafactor_update(gs, again, again_s, **hp)
    torch.cuda.synchronize()
    u2_from = ("statistics" if float(work[AF.GUARD]) == 1.0 else "u2_pass") \
        if plan["factored"] else "v_kernel"
    del work
    adafactor_update_plain(gs, plain, plain_s, **hp)
    state_err = max(float(((mine_s[k].double() - plain_s[k].double()).abs()
                           / plain_s[k].double().abs()).max()) for k in state)

    def change_rel_l2(got) -> float:
        """||got - plain|| / ||plain - before||, over the group (the
        absolute norm where the plain version changes nothing)."""
        num, den = math.sqrt(af_sq_dist(got, plain)), math.sqrt(af_sq_dist(plain, before))
        return num / den if den else num

    def plain_control(**over) -> float:
        ctl, ctl_s = af_copy(ps, state)
        adafactor_update_plain(gs, ctl, ctl_s, **{**hp, **over})
        err = change_rel_l2(ctl)
        del ctl, ctl_s
        return err

    rec = {"kernel": "adafactor", "case": name, "dtype": dt_name(p_dtype),
           "layers": layers, "shape": list(shape), "p": dt_name(p_dtype), "g": dt_name(g_dtype),
           "step": step, "lr": float(hp["lr"]), "misaligned": misaligned,
           "plan": {k: plan[k] for k in (
               "path", "vec", "grid", "kernels", "slab_rows", "slabs_a_matrix", "tile_rows",
               "stages", "lanes", "kc", "blocks_a_sm", "smem", "slab_rows2",
               "slabs_a_matrix2", "grid2") if k in plan},
           "u2_from": u2_from,
           "state_rel_err": state_err, "state_tol": AF_STATE_TOL,
           "max_abs_err": max(max_err(a, b) for a, b in zip(mine, plain)),
           "update_rel_l2": change_rel_l2(mine), "update_tol": tol,
           "bit_equal_twice": all(torch.equal(a, b) for a, b in zip(mine, again))
           and all(torch.equal(mine_s[k], again_s[k]) for k in state),
           "bit_equal_plain": all(torch.equal(a, b) for a, b in zip(mine, plain))}
    moved = any(not torch.equal(b, p0) for b, p0 in zip(plain, before))
    if moved:
        rec["control_lr_x1.01"] = plain_control(lr=hp["lr"] * AF_CONTROL_LR)
        rec["control_no_apply"] = change_rel_l2(before)
        controls = [rec["control_lr_x1.01"], rec["control_no_apply"]]
        if g_scale > 1.0:
            rec["control_clip_1"] = plain_control(clip_threshold=math.inf)
            if step > 1:    # at step 1 (beta2 0) u is g over its own RMS: no clip bites
                controls.append(rec["control_clip_1"])
        rec["controls_exceed_tol"] = all(c > tol for c in controls)
    else:   # zero gradients and no decay: nothing moves, and nothing may
        rec["controls_exceed_tol"] = True
    ok = rec["update_rel_l2"] <= tol and rec["controls_exceed_tol"]
    if p_dtype == torch.bfloat16:
        ulps = max(int((a.view(torch.int16).int() - b.view(torch.int16).int()).abs().max())
                   for a, b in zip(mine, plain))
        differ = sum(int((a != b).sum()) for a, b in zip(mine, plain))
        rec.update(max_ulp=ulps, share_differing=differ / sum(t.numel() for t in mine),
                   max_operand_ulp=af_operand_ulps(mine, plain, before))
        ok = ok and rec["max_operand_ulp"] <= 1.0
    rec["ok"] = bool(ok and state_err <= AF_STATE_TOL and rec["bit_equal_twice"]
                     and (guard is None or u2_from == ("statistics" if guard else "u2_pass")))
    del before
    if timed:
        N = sum(t.numel() for t in ps)
        pe, ge = ps[0].element_size(), gs[0].element_size()
        st_bytes = 8 * sum(t.numel() for t in state.values())
        rec["bound_ms"], rec["bound_by"] = bound(N * (ge + 2 * pe) + st_bytes, 20.0 * N,
                                                 torch.float32)
        rec["five_pass_bound_ms"] = (N * (2 * ge + 3 * pe) + st_bytes) / PEAK_BYTES_S * 1e3
        rec["six_pass_bound_ms"] = (N * (3 * ge + 3 * pe) + st_bytes) / PEAK_BYTES_S * 1e3
        call = lambda: adafactor_update(gs, mine, mine_s, **hp)  # noqa: E731
        rec["ms"] = time_ms(call, iters=5, warmup=1)
        rec["device_ms"] = device_ms(call, iters=3, cold=False)
        rec["device_ms_by_kernel"] = device_ms_by_kernel(call, iters=3, cold=False)
        if plan["path"] == "rows":
            rec["tile_plans_ms"] = af_tile_plans(gs, mine, mine_s, plan, hp)
        del again, again_s
        torch.cuda.empty_cache()
        rec["plain_ms"] = time_ms(lambda: adafactor_update_plain(gs, plain, plain_s, **hp),
                                  iters=3, warmup=1)
        del plain, plain_s
        torch.cuda.empty_cache()
        # the nearest PyTorch call: torch.optim.Adafactor over the same leaves,
        # a leaf at a time (no stacking: its factors and clip are per layer),
        # its own eps (eps1 None: the dtype's smallest), lr 3e-4, no relative step
        ws = [t.clone().requires_grad_() for t in ps]
        for w, g in zip(ws, gs):
            w.grad = g
        opt = torch.optim.Adafactor(ws, lr=3e-4, foreach=True)
        rec["library_ms"] = time_ms(opt.step, iters=3, warmup=1)
        rec["library_device_ms"] = device_ms(opt.step, iters=3, cold=False)
        del opt, ws
    else:
        rec["ms"] = rec["device_ms"] = rec["plain_ms"] = rec["bound_ms"] = None
        rec["library_ms"] = rec["library_device_ms"] = None
    del gs, ps, state, mine, mine_s
    torch.cuda.empty_cache()
    return rec


def adafactor_checks() -> tuple[list, dict]:
    """The kernels against the plain version at recurrentgemma-9b's shapes
    and at edge shapes; returns (records, the main records by name)."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    bf16, f32 = torch.bfloat16, torch.float32
    recs, main = [], {}
    # the tied embedding (256000 x 4096, unstacked: 132 slabs of 1944 rows) and
    # the largest 12-layer group (12 x 12288 x 4096), timed; their guards hold
    recs.append(check_adafactor(gen, "embedding", None, (256000, 4096), p_dtype=bf16,
                                g_dtype=bf16, timed=True, guard=True))
    main["adafactor"] = recs[-1]
    recs.append(check_adafactor(gen, "stacked_mlp", 12, (12288, 4096), p_dtype=bf16,
                                g_dtype=bf16, timed=True, guard=True))
    main["adafactor_group"] = recs[-1]
    # its transpose, 12 x 4096 x 12288 (six such groups: 39 % of the tree's
    # elements), rows of 48 KB: tiles of one row, three column vectors a thread
    recs.append(check_adafactor(gen, "stacked_mlp_wide", 12, (4096, 12288), p_dtype=bf16,
                                g_dtype=bf16, timed=True, guard=True))
    # the tree's other forms: 12 x (4096, 16, 256) (49,152 matrices of 16 x
    # 256: tiles of 16 KB, the wide walk), 12 x (4096,) (a 12 x 4096 matrix),
    # 12 x (4096, 1, 256) (not factored), step 1 and 3, the clip active and
    # not, zero gradients
    for step in (1, 3):
        for g_scale, label in ((1.0, ""), (100.0, " clip"), (0.0, " zero")):
            recs.append(check_adafactor(gen, f"heads{label}", 12, (4096, 16, 256), p_dtype=bf16,
                                        g_dtype=bf16, step=step, g_scale=g_scale,
                                        timed=step == 3 and not label))
            recs.append(check_adafactor(gen, f"norms{label}", 12, (4096,), p_dtype=bf16,
                                        g_dtype=bf16, step=step, g_scale=g_scale))
            recs.append(check_adafactor(gen, f"conv{label}", 12, (4096, 1, 256), p_dtype=bf16,
                                        g_dtype=bf16, step=step, g_scale=g_scale))
    # a 1-D leaf (bf16 and fp32), a last dim of 1, a 0-d leaf; odd and
    # unaligned; fp32 and mixed (fp32 g, bf16 p: gradient accumulation's)
    recs.append(check_adafactor(gen, "vector", None, (4096,), p_dtype=bf16, g_dtype=bf16))
    recs.append(check_adafactor(gen, "last_dim_1", None, (4096, 1), p_dtype=bf16, g_dtype=bf16))
    recs.append(check_adafactor(gen, "scalar", None, (), p_dtype=f32, g_dtype=f32))
    recs.append(check_adafactor(gen, "vector", None, (4096,), p_dtype=f32, g_dtype=f32))
    recs.append(check_adafactor(gen, "odd", None, (1001, 333), p_dtype=bf16, g_dtype=bf16,
                                misaligned=True))
    recs.append(check_adafactor(gen, "odd_stacked", 3, (1001, 333), p_dtype=f32, g_dtype=f32,
                                misaligned=True))
    recs.append(check_adafactor(gen, "odd_vector", 3, (1001,), p_dtype=bf16, g_dtype=bf16,
                                misaligned=True))
    recs.append(check_adafactor(gen, "square", None, (4096, 4096), p_dtype=f32, g_dtype=f32,
                                step=1))
    recs.append(check_adafactor(gen, "square", None, (4096, 4096), p_dtype=f32, g_dtype=f32,
                                g_scale=100.0))
    recs.append(check_adafactor(gen, "square_mixed", None, (4096, 4096), p_dtype=bf16,
                                g_dtype=f32))
    recs.append(check_adafactor(gen, "skinny", None, (100000, 8), p_dtype=f32, g_dtype=f32,
                                step=1))
    # where the update's sum of u^2 comes from, from a fresh state: rows of g
    # exactly 0 beside rows of 1e2 (the guard holds: no nonzero g meets a
    # zero row's small vr), and tiny rows in scaled columns (a clamp bites on
    # a nonzero g: the u^2 pass runs), over several slabs of one matrix and
    # over many matrices of one slab each
    recs.append(check_adafactor(gen, "guard_zero_rows", None, (2048, 1024), p_dtype=bf16,
                                g_dtype=bf16, fresh=True, g_rows=af_rows_zero_and_1e2,
                                guard=True))
    recs.append(check_adafactor(gen, "guard_fails", None, (2048, 1024), p_dtype=bf16,
                                g_dtype=bf16, fresh=True, g_rows=af_rows_guard_fails,
                                guard=False))
    recs.append(check_adafactor(gen, "guard_fails_heads", 12, (64, 16, 1024), p_dtype=bf16,
                                g_dtype=bf16, fresh=True, g_rows=af_rows_guard_fails,
                                guard=False))
    # a row wider than the statistics' stages (an lm head's 32768 columns):
    # the wide walk, its u^2 pass always
    recs.append(check_adafactor(gen, "wide_rows", None, (512, 32768), p_dtype=bf16,
                                g_dtype=bf16, guard=False))
    return recs, main


# the serving mix of valid lengths of K2's mixed cases: 7,001 rows over 8 slots
MIXED_VALID = [1, 2048, 17, 1024, 300, 2047, 64, 1500]


def dense_kernel_cases() -> list:
    """The kernels at the shapes of the dense phase's three decoders, each
    record under ``"arch"``: K2 at B8 T2048 with the serving mix of valid
    lengths (gemma-7b's G 1 at D 256 on the CUDA cores, qwen2.5-32b's G 5,
    yi-34b's G 7); K1 causal at gemma-7b's serving prefill (S1000, 16 heads of
    256) and at qwen2.5-32b's and yi-34b's 40 and 56 heads on 8 at S1000 and
    S2048; K1's backward at those two at S2048; K3 with the sum at qwen2.5-32b's
    D 5120 and gemma-7b's D 3072 in the 1 + w form, and its backward with the
    sum at R2048 D5120; AdamW on qwen2.5-32b's up projection, 5120 x 27648.  bf16
    timed; fp32 beside it where the case is cheap."""
    rng = np.random.default_rng(SEED + 7)
    bf16, f32 = torch.bfloat16, torch.float32
    out = []

    def add(arch, rec):
        out.append({"arch": arch, **rec})

    for arch, H, Hkv, D in (("gemma-7b", 16, 16, 256), ("qwen2.5-32b", 40, 8, 128),
                            ("yi-34b", 56, 8, 128)):
        for dtype in (bf16, f32):
            add(arch, check_decode(rng, B=8, H=H, Hkv=Hkv, T=2048, D=D, valid=MIXED_VALID,
                                   dtype=dtype, timed=dtype is bf16, bthd=True))
    for dtype in (bf16, f32):
        add("gemma-7b", check_flash(rng, B=1, H=16, Hkv=16, Sq=1000, Sk=1000, D=256, causal=True,
                                    window=0, dtype=dtype, timed=dtype is bf16, bshd=True))
    for arch, H in (("qwen2.5-32b", 40), ("yi-34b", 56)):
        for S in (1000, 2048):
            for dtype in (bf16, f32) if S == 1000 else (bf16,):
                add(arch, check_flash(rng, B=1, H=H, Hkv=8, Sq=S, Sk=S, D=128, causal=True,
                                      window=0, dtype=dtype, timed=dtype is bf16, bshd=True))
        add(arch, check_flash_bwd(rng, B=1, H=H, Hkv=8, Sq=2048, Sk=2048, D=128, causal=True,
                                  window=0, dtype=bf16, timed=True, bshd=True))
    for arch, D, offset in (("qwen2.5-32b", 5120, False), ("gemma-7b", 3072, True)):
        for dtype in (bf16, f32):
            add(arch, check_rmsnorm(rng, R=1000, D=D, dtype=dtype, w_dtype=dtype, offset=offset,
                                    residual=True, fused=True, timed=dtype is bf16))
    for dtype in (bf16, f32):
        add("qwen2.5-32b", check_rmsnorm_bwd(rng, R=2048, D=5120, dtype=dtype, w_dtype=dtype,
                                             offset=False, residual=True, fused=True,
                                             timed=dtype is bf16))
    # the path's bf16 leaf; fp32 beside PyTorch's fused AdamW, which has no bf16 form
    # with fp32 moments
    add("qwen2.5-32b", check_adamw(rng, n=5120 * 27648, p_dtype=bf16, g_dtype=bf16, timed=True))
    add("qwen2.5-32b", check_adamw(rng, n=5120 * 27648, p_dtype=f32, g_dtype=f32, timed=True))
    return out


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
    # ... at olmoe-1b-7b's (16 q and 16 kv heads, G=1) ...
    for dtype in (bf16, f32):
        recs.append(check_flash(rng, B=1, H=16, Hkv=16, Sq=1000, Sk=1000, D=128, causal=True,
                                window=0, dtype=dtype, timed=dtype is bf16, bshd=True))
        if dtype is bf16:
            main["moe_flash_attention"] = recs[-1]
    # ... at deepseek-v3-671b's MLA prefill (q/k head dim 192, v 128, 128 heads, G=1):
    # the serving shape, S 1 / 63 / 65 / 1024, Sq != Sk unmasked, G > 1, and the LSE variant
    for dtype in (bf16, f32):
        recs.append(check_flash(rng, **MLA_K1, Sq=1000, Sk=1000, dtype=dtype, timed=dtype is bf16))
        if dtype is bf16:
            main["mla_flash_attention"] = recs[-1]
        for S in (1, 63, 65, 1024):
            recs.append(check_flash(rng, **MLA_K1, Sq=S, Sk=S, dtype=dtype,
                                    timed=dtype is bf16 and S == 1024))
        mla_edge = [dict(B=1, H=8, Hkv=8, Sq=100, Sk=300, causal=False, window=0, bshd=False),
                    dict(B=2, H=16, Hkv=4, Sq=333, Sk=333, causal=True, window=0, bshd=True),   # G=4
                    dict(B=1, H=8, Hkv=2, Sq=200, Sk=200, causal=True, window=64, bshd=False)]
        for e in mla_edge:
            recs.append(check_flash(rng, **e, D=192, Dv=128, dtype=dtype, timed=False))
        recs.append(check_flash(rng, **MLA_K1, Sq=1000, Sk=1000, dtype=dtype, timed=False,
                                lse=True))
        recs.append(check_flash(rng, B=2, H=16, Hkv=4, Sq=129, Sk=129, D=192, Dv=128, causal=True,
                                window=0, dtype=dtype, timed=False, lse=True))
    # ... at recurrentgemma-9b's local attention (16 q heads on one kv head, D 256, window
    # 2048): the serving shape, where the window does not bite, and a window that does
    for dtype in (bf16, f32):
        recs.append(check_flash(rng, B=1, H=16, Hkv=1, Sq=1000, Sk=1000, D=256, causal=True,
                                window=2048, dtype=dtype, timed=dtype is bf16, bshd=True))
        if dtype is bf16:
            main["griffin_flash_attention"] = recs[-1]
        recs.append(check_flash(rng, B=2, H=16, Hkv=1, Sq=300, Sk=300, D=256, causal=True,
                                window=64, dtype=dtype, timed=False, bshd=True))
    # ... and at its train length S2048
    recs.append(check_flash(rng, B=1, H=16, Hkv=1, Sq=2048, Sk=2048, D=256, causal=True,
                            window=2048, dtype=bf16, timed=True, bshd=True))
    # ... at gemma-7b's (16 heads of 256, G 1, causal) at its train length S2048
    for dtype in (bf16, f32):
        recs.append(check_flash(rng, B=1, H=16, Hkv=16, Sq=2048, Sk=2048, D=256, causal=True,
                                window=0, dtype=dtype, timed=dtype is bf16, bshd=True))
        if dtype is bf16:
            main["gemma_flash_attention"] = recs[-1]
    # ... at whisper-large-v3's (20 heads, G = 1, D 64, not causal): the encoder's self
    # attention over its 1500 frames, and the cross attention of the B1 context prefill
    # (Sq 224 against the 1500 encoder rows)
    for dtype in (bf16, f32):
        for name, Sq in (("whisper_enc_flash_attention", 1500),
                         ("whisper_cross_flash_attention", 224)):
            recs.append(check_flash(rng, B=1, H=20, Hkv=20, Sq=Sq, Sk=1500, D=64, causal=False,
                                    window=0, dtype=dtype, timed=dtype is bf16, bshd=True))
            if dtype is bf16:
                main[name] = recs[-1]
    # ... and at its B8 train step's three: the encoder, the cross attention (Sq 448) and
    # the decoder's causal self attention (448 x 448)
    for dtype in (bf16, f32):
        for name, Sq, Sk, causal in (("whisper_enc_b8_flash_attention", 1500, 1500, False),
                                     ("whisper_cross_b8_flash_attention", 448, 1500, False),
                                     ("whisper_self_flash_attention", 448, 448, True)):
            recs.append(check_flash(rng, B=8, H=20, Hkv=20, Sq=Sq, Sk=Sk, D=64, causal=causal,
                                    window=0, dtype=dtype, timed=dtype is bf16, bshd=True))
            if dtype is bf16:
                main[name] = recs[-1]
    # ... at qwen2-vl-7b's (28 q heads on 4 kv heads, G 7, D 128): the serving shape, and
    # the multimodal prefill's B2 S512
    for dtype in (bf16, f32):
        recs.append(check_flash(rng, B=1, H=28, Hkv=4, Sq=1000, Sk=1000, D=128, causal=True,
                                window=0, dtype=dtype, timed=dtype is bf16, bshd=True))
        if dtype is bf16:
            main["vlm_flash_attention"] = recs[-1]
        recs.append(check_flash(rng, B=2, H=28, Hkv=4, Sq=512, Sk=512, D=128, causal=True,
                                window=0, dtype=dtype, timed=False, bshd=True))
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
    mixed = MIXED_VALID
    for dtype in (bf16, f32):
        recs.append(check_decode(rng, B=8, H=24, Hkv=8, T=2048, D=128, valid=mixed, dtype=dtype,
                                 timed=dtype is bf16, bthd=True))
        if dtype is bf16:
            main["decode_attention"] = recs[-1]
    recs.append(check_decode(rng, B=8, H=24, Hkv=8, T=2048, D=128, valid=[2048] * 8, dtype=bf16,
                             timed=True, bthd=True))
    # ... at olmoe-1b-7b's (G=1) ...
    for dtype in (bf16, f32):
        recs.append(check_decode(rng, B=8, H=16, Hkv=16, T=2048, D=128, valid=mixed, dtype=dtype,
                                 timed=dtype is bf16, bthd=True))
        if dtype is bf16:
            main["moe_decode_attention"] = recs[-1]
    # ... at recurrentgemma-9b's (G=16 at D 256: in bf16 the group in one block on the
    # tensor cores, in fp32 two blocks of 8 heads a kv head), the serving shape and a
    # ragged ring ...
    for dtype in (bf16, f32):
        recs.append(check_decode(rng, B=8, H=16, Hkv=1, T=2048, D=256, valid=mixed, dtype=dtype,
                                 timed=dtype is bf16, bthd=True))
        if dtype is bf16:
            main["griffin_decode_attention"] = recs[-1]
        recs.append(check_decode(rng, B=3, H=16, Hkv=1, T=333, D=256, valid=[333, 7, 0],
                                 dtype=dtype, timed=False, bthd=True))
    recs.append(check_decode(rng, B=8, H=16, Hkv=1, T=2048, D=256, valid=[2048] * 8, dtype=bf16,
                             timed=True, bthd=True))
    # ... at the dryrun phase's recurrentgemma-9b long_500k decode (B1, the
    # full ring valid: the split floor's 16 splits of 128 rows) ...
    for dtype in (bf16, f32):
        recs.append(check_decode(rng, B=1, H=16, Hkv=1, T=2048, D=256, valid=[2048],
                                 dtype=dtype, timed=dtype is bf16, bthd=True))
        if dtype is bf16:
            main["dryrun_decode_attention"] = recs[-1]
    # ... at whisper-large-v3's (G = 1 at D 64): the self attention's ring of 448 with
    # mixed valid lengths, and the cross attention over the encoder's 1500 rows, every
    # row valid (the kernel's wrapper holds that valid length) ...
    for dtype in (bf16, f32):
        recs.append(check_decode(rng, B=8, H=20, Hkv=20, T=448, D=64,
                                 valid=[1, 448, 17, 200, 127, 447, 64, 300], dtype=dtype,
                                 timed=dtype is bf16, bthd=True))
        if dtype is bf16:
            main["whisper_self_decode_attention"] = recs[-1]
        recs.append(check_decode(rng, B=8, H=20, Hkv=20, T=1500, D=64, valid=None, dtype=dtype,
                                 timed=dtype is bf16, bthd=True))
        if dtype is bf16:
            main["whisper_cross_decode_attention"] = recs[-1]
    # ... at qwen2-vl-7b's (G 7 at D 128: 28 heads on 4), the serving mix of valid lengths ...
    for dtype in (bf16, f32):
        recs.append(check_decode(rng, B=8, H=28, Hkv=4, T=2048, D=128, valid=mixed, dtype=dtype,
                                 timed=dtype is bf16, bthd=True))
        if dtype is bf16:
            main["vlm_decode_attention"] = recs[-1]
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
    # ... at a single sequence with the small groups, which the split floor must cost
    # nothing: phi4-mini's G 3 (the CUDA-core kernel) and qwen2-vl's G 7 at B1 over the ring
    for name, H, Hkv in (("b1_g3", 24, 8), ("b1_g7", 28, 4)):
        for dtype in (bf16, f32):
            recs.append(check_decode(rng, B=1, H=H, Hkv=Hkv, T=2048, D=128, valid=[2048],
                                     dtype=dtype, timed=dtype is bf16, bthd=True))
            if dtype is bf16:
                main[f"{name}_decode_attention"] = recs[-1]
    if not any(r["splits"] == 1 for r in recs if r["kernel"] == "decode_attention"):
        fail("no decode case ran with a single split")
    if not {r["path"] for r in recs if r["kernel"] == "decode_attention"} >= {"tensor_cores",
                                                                               "cuda_cores"}:
        fail("the decode cases did not run both kernels")

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
    # ... at olmoe-1b-7b's width (D = 2048), its decode and prefill rows ...
    for R in (8, 1000):
        for dtype in (bf16, f32):
            recs.append(check_rmsnorm(rng, R=R, D=2048, dtype=dtype, w_dtype=dtype, offset=False,
                                      residual=True, fused=True, timed=dtype is bf16 and R == 1000))
            if R == 1000 and dtype is bf16:
                main["moe_rmsnorm"] = recs[-1]
    # ... at deepseek-v3-671b's: ln1/ln2 at D 7168 (the sum written), MLA's q_norm at
    # D 1536 and kv_norm at D 512 (no residual), its decode and prefill rows ...
    for R in (8, 1000):
        for dtype in (bf16, f32):
            recs.append(check_rmsnorm(rng, R=R, D=7168, dtype=dtype, w_dtype=dtype, offset=False,
                                      residual=True, fused=True, timed=dtype is bf16 and R == 1000))
            if R == 1000 and dtype is bf16:
                main["mla_rmsnorm"] = recs[-1]
            for D in (1536, 512):
                recs.append(check_rmsnorm(rng, R=R, D=D, dtype=dtype, w_dtype=dtype,
                                          offset=False, residual=False, timed=False))
    # ... at recurrentgemma-9b's (D 4096, the 1 + w form, the sum written) ...
    for R in (8, 1000):
        for dtype in (bf16, f32):
            recs.append(check_rmsnorm(rng, R=R, D=4096, dtype=dtype, w_dtype=dtype, offset=True,
                                      residual=True, fused=True, timed=dtype is bf16 and R == 1000))
            if R == 1000 and dtype is bf16:
                main["griffin_rmsnorm"] = recs[-1]
    # ... at xlstm-125m's (D 768: ln with the sum written, and out_norm, no residual,
    # over the mLSTM's 4 x 192 heads and the sLSTM's width) ...
    for R in (8, 1000):
        for dtype in (bf16, f32):
            for fused in (False, True):
                recs.append(check_rmsnorm(rng, R=R, D=768, dtype=dtype, w_dtype=dtype,
                                          offset=False, residual=fused, fused=fused,
                                          timed=dtype is bf16 and R == 1000))
                if R == 1000 and dtype is bf16:
                    main["xlstm_add_rmsnorm" if fused else "xlstm_rmsnorm"] = recs[-1]
    # ... at qwen2-vl-7b's (D 3584, the sum written), its decode and prefill rows ...
    for R in (8, 1000):
        for dtype in (bf16, f32):
            recs.append(check_rmsnorm(rng, R=R, D=3584, dtype=dtype, w_dtype=dtype, offset=False,
                                      residual=True, fused=True, timed=dtype is bf16 and R == 1000))
            if R == 1000 and dtype is bf16:
                main["vlm_rmsnorm"] = recs[-1]
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

    # --- K1 backward at the train path's shape (phi4-mini: B1 S2048, G=3, the model's
    # layout) and the serving path's prefill, then at edge shapes: D 64/256, G 1/2/5/7/8,
    # windows, ragged lengths, rows that see no key at all
    for S in (1000, 2048):
        for dtype in (bf16, f32):
            recs.append(check_flash_bwd(rng, B=1, H=24, Hkv=8, Sq=S, Sk=S, D=128, causal=True,
                                        window=0, dtype=dtype, timed=dtype is bf16, bshd=True))
            if S == 2048 and dtype is bf16:
                main["flash_attention_bwd"] = recs[-1]
    for dtype in (bf16, f32):
        edge = [dict(B=2, H=40, Hkv=8, Sq=333, Sk=333, D=128, causal=True, window=0, bshd=True),  # G=5
                dict(B=1, H=16, Hkv=16, Sq=300, Sk=300, D=256, causal=True, window=0),   # D=256, G=1
                dict(B=2, H=8, Hkv=1, Sq=192, Sk=192, D=64, causal=True, window=0),      # G=8
                dict(B=1, H=14, Hkv=2, Sq=130, Sk=130, D=128, causal=True, window=0),    # G=7
                dict(B=2, H=4, Hkv=2, Sq=160, Sk=160, D=64, causal=True, window=64),     # window
                dict(B=1, H=4, Hkv=2, Sq=300, Sk=300, D=128, causal=False, window=64),   # window alone
                dict(B=1, H=4, Hkv=1, Sq=128, Sk=256, D=64, causal=False, window=0),     # Sq != Sk
                dict(B=1, H=4, Hkv=2, Sq=300, Sk=100, D=64, causal=False, window=64),    # masked rows
                dict(B=1, H=8, Hkv=8, Sq=200, Sk=200, D=128, causal=True, window=0,
                     bshd=True),                                                  # G=1, ragged
                dict(B=1, H=6, Hkv=2, Sq=70, Sk=33, D=128, causal=True, window=0),       # Sq != Sk
                dict(B=1, H=6, Hkv=2, Sq=100, Sk=100, D=128, causal=True, window=0,
                     misaligned=True)]                                            # FMA kernels
        for e in edge:
            recs.append(check_flash_bwd(rng, **e, dtype=dtype, timed=False))
        # olmoe-1b-7b's train_parity shape (B2 S512, G=1)
        recs.append(check_flash_bwd(rng, B=2, H=16, Hkv=16, Sq=512, Sk=512, D=128, causal=True,
                                    window=0, dtype=dtype, timed=False, bshd=True))
        # whisper-large-v3's train shapes (B8, 20 heads, D 64, not causal): the decoder's
        # cross attention (Sq 448 against the encoder's 1500 rows) and the encoder's self
        # attention (1500 x 1500)
        for name, Sq in (("whisper_cross_flash_attention_bwd", 448),
                         ("whisper_enc_flash_attention_bwd", 1500)):
            recs.append(check_flash_bwd(rng, B=8, H=20, Hkv=20, Sq=Sq, Sk=1500, D=64,
                                        causal=False, window=0, dtype=dtype,
                                        timed=dtype is bf16, bshd=True))
            if dtype is bf16:
                main[name] = recs[-1]
        # ... and the decoder's self attention (448 x 448, causal)
        recs.append(check_flash_bwd(rng, B=8, H=20, Hkv=20, Sq=448, Sk=448, D=64, causal=True,
                                    window=0, dtype=dtype, timed=dtype is bf16, bshd=True))
        if dtype is bf16:
            main["whisper_self_flash_attention_bwd"] = recs[-1]
        # qwen2-vl-7b's train shape (B1 S2048, G 7: the group sum over 7 heads)
        recs.append(check_flash_bwd(rng, B=1, H=28, Hkv=4, Sq=2048, Sk=2048, D=128, causal=True,
                                    window=0, dtype=dtype, timed=dtype is bf16, bshd=True))
        if dtype is bf16:
            main["vlm_flash_attention_bwd"] = recs[-1]
    # ... at deepseek-v3-671b's train shape (MLA: q/k head dim 192, v 128, 128 heads, G 1,
    # B1 S2048; bf16 on the tensor-core kernels of two dK/dV warpgroups, fp32 and a view
    # off 16 bytes on the FMA ones), timed beside SDPA's backward, then a group of 4 with
    # ragged rows, Sq != Sk unmasked, and a window ...
    for dtype in (bf16, f32):
        recs.append(check_flash_bwd(rng, **MLA_K1, Sq=2048, Sk=2048, dtype=dtype,
                                    timed=dtype is bf16))
        if dtype is bf16:
            main["mla_flash_attention_bwd"] = recs[-1]
        for e in (dict(B=2, H=16, Hkv=4, Sq=333, Sk=333, causal=True, window=0, bshd=True),
                  dict(B=1, H=8, Hkv=8, Sq=100, Sk=300, causal=False, window=0, bshd=False),
                  dict(B=1, H=8, Hkv=2, Sq=200, Sk=200, causal=True, window=64, bshd=False),
                  dict(B=1, H=4, Hkv=2, Sq=130, Sk=130, causal=True, window=0, bshd=False,
                       misaligned=True)):                                 # FMA kernels
            recs.append(check_flash_bwd(rng, **e, D=192, Dv=128, dtype=dtype, timed=False))
    # ... at recurrentgemma-9b's train shape (16 q heads on one kv head, D 256, its
    # window of 2048 covering S: the group's 16 partials summed) and gemma-7b's (16 heads
    # of 256, G 1), timed beside SDPA's backward, then at D 256 a group of 8 on strided
    # views, Sq != Sk, a window cutting tiles at a group of 8 and rows that see no key,
    # and a view off 16 bytes (the FMA kernels) ...
    for dtype in (bf16, f32):
        recs.append(check_flash_bwd(rng, B=1, H=16, Hkv=1, Sq=2048, Sk=2048, D=256, causal=True,
                                    window=2048, dtype=dtype, timed=dtype is bf16, bshd=True))
        if dtype is bf16:
            main["griffin_flash_attention_bwd"] = recs[-1]
        recs.append(check_flash_bwd(rng, B=1, H=16, Hkv=16, Sq=2048, Sk=2048, D=256, causal=True,
                                    window=0, dtype=dtype, timed=dtype is bf16, bshd=True))
        if dtype is bf16:
            main["gemma_flash_attention_bwd"] = recs[-1]
        for e in (dict(B=2, H=16, Hkv=2, Sq=300, Sk=300, causal=True, window=0, bshd=True),
                  dict(B=1, H=4, Hkv=1, Sq=128, Sk=320, causal=False, window=0),
                  dict(B=1, H=8, Hkv=1, Sq=333, Sk=333, causal=True, window=100, bshd=True),
                  dict(B=1, H=4, Hkv=2, Sq=300, Sk=100, causal=False, window=64),
                  dict(B=1, H=4, Hkv=2, Sq=130, Sk=130, causal=True, window=0,
                       misaligned=True)):                                 # FMA kernels
            recs.append(check_flash_bwd(rng, **e, D=256, dtype=dtype, timed=False))

    # --- K3 backward at the train path's rows (B1 S2048, D 3072: add_rmsnorm in 63 of a
    # step's 65 norms) and the serving path's, with and without the residual, the sum's
    # gradient and the 1 + w form
    for R in (8, 1000, 2048):
        for dtype in (bf16, f32):
            for fused in (False, True):
                recs.append(check_rmsnorm_bwd(rng, R=R, D=3072, dtype=dtype, w_dtype=dtype,
                                              offset=False, residual=fused, fused=fused,
                                              timed=dtype is bf16))
                if R == 2048 and dtype is bf16 and fused:
                    main["rmsnorm_bwd"] = recs[-1]
            recs.append(check_rmsnorm_bwd(rng, R=R, D=3072, dtype=dtype, w_dtype=f32, offset=True,
                                          residual=True, timed=False))
    for dtype in (bf16, f32):      # olmoe-1b-7b's train_parity rows (B2 S512, D 2048)
        recs.append(check_rmsnorm_bwd(rng, R=1024, D=2048, dtype=dtype, w_dtype=dtype,
                                      offset=False, residual=True, fused=True, timed=False))
    for dtype in (bf16, f32):      # xlstm-125m's rows at B1 S2048, D 768
        for fused in (False, True):
            recs.append(check_rmsnorm_bwd(rng, R=2048, D=768, dtype=dtype, w_dtype=dtype,
                                          offset=False, residual=fused, fused=fused,
                                          timed=dtype is bf16))
            if dtype is bf16 and fused:
                main["xlstm_rmsnorm_bwd"] = recs[-1]
    for dtype in (bf16, f32):      # qwen2-vl-7b's rows at B1 S2048, D 3584, the sum's gradient
        recs.append(check_rmsnorm_bwd(rng, R=2048, D=3584, dtype=dtype, w_dtype=dtype,
                                      offset=False, residual=True, fused=True,
                                      timed=dtype is bf16))
        if dtype is bf16:
            main["vlm_rmsnorm_bwd"] = recs[-1]
    for dtype in (bf16, f32):      # recurrentgemma-9b's rows at B1 S2048, D 4096, 1 + w, the sum
        recs.append(check_rmsnorm_bwd(rng, R=2048, D=4096, dtype=dtype, w_dtype=dtype,
                                      offset=True, residual=True, fused=True,
                                      timed=dtype is bf16))
        if dtype is bf16:
            main["griffin_rmsnorm_bwd"] = recs[-1]
    # --- the fused AdamW update: phi4-mini's leaves (a layer's up projection, the
    # embedding), bf16 parameters and gradients, fp32 moments; fp32 beside PyTorch's
    # fused AdamW; a length that is no multiple of 4 and a base off 16 bytes
    recs.append(check_adamw(rng, n=3072 * 8192, p_dtype=bf16, g_dtype=bf16, timed=True))
    main["adamw"] = recs[-1]
    recs.append(check_adamw(rng, n=200064 * 3072, p_dtype=bf16, g_dtype=bf16, timed=True))
    recs.append(check_adamw(rng, n=3072 * 8192, p_dtype=f32, g_dtype=f32, timed=True))
    recs.append(check_adamw(rng, n=3072 * 8192, p_dtype=bf16, g_dtype=f32, timed=False))
    recs.append(check_adamw(rng, n=12345, p_dtype=bf16, g_dtype=bf16, timed=False))
    recs.append(check_adamw(rng, n=3073, p_dtype=f32, g_dtype=f32, timed=False, misaligned=True))
    # --- Adafactor's update of a layer group: recurrentgemma-9b's groups and edge shapes
    af_recs, af_main = adafactor_checks()
    recs.extend(af_recs)
    main.update(af_main)
    # --- every kernel at the dense phase's three decoders' shapes
    dense = dense_kernel_cases()
    recs.extend(dense)
    main["dense"] = [r for r in dense if "bound_ms" in r]

    for dtype in (bf16, f32):
        recs.append(check_rmsnorm_bwd(rng, R=37, D=100, dtype=dtype, w_dtype=f32, offset=True,
                                      residual=False, timed=False))              # scalar variant
        recs.append(check_rmsnorm_bwd(rng, R=600, D=256, dtype=dtype, w_dtype=dtype,
                                      offset=False, residual=True, fused=True, timed=False))
        recs.append(check_rmsnorm_bwd(rng, R=64, D=16384, dtype=dtype, w_dtype=dtype,
                                      offset=False, residual=False, timed=False))
    rms_bwd_parts = rms_bwd_parts_times(rng)
    k2 = k2_parts(np.random.default_rng(SEED + 2))
    determinism = determinism_checks(rng)
    sharded = sharded_attention_check(rng)

    K.reset_launch_counts()
    bad = [r for r in recs if not check_ok(r)]
    emit({"phase": "kernels", "plans": plans, "floor_device_ms": launch_floor_ms(),
          "rmsnorm_plans": rms_plans, "rmsnorm_bwd_parts": rms_bwd_parts, "k2_parts": k2,
          "determinism": determinism, "sharded_attention": sharded,
          "checks": recs, "failed": len(bad)})
    if bad:
        fail(f"{len(bad)} kernel check(s) over tolerance: {bad}")
    if not all(d["bit_equal"] for d in determinism):
        fail(f"a kernel gave other bits on a second run: {determinism}")
    return recs, main


# instructions each library must hold: K1's and its backward's wgmma (HGMMA)
# and TMA loads (UTMALDG), K3's 16-byte loads and stores, K2's mma.sync (HMMA)
# and cp.async (LDGSTS), Adafactor's 16-byte loads and stores and its rsqrtf
SASS_WANTED = {"flash_attention": (r"HGMMA", r"UTMALDG"),
               "flash_attention_bwd": (r"HGMMA", r"UTMALDG"),
               "rmsnorm": (r"LDG\.E\.128", r"STG\.E\.128"),
               "decode_attention": (r"HMMA", r"LDGSTS"),
               "adafactor": (r"LDG\.E\.128", r"STG\.E\.128", r"MUFU\.RSQ", r"UBLKCP")}


# the bf16 forward's instantiations at MLA's dims, at D 256 and (two consumer warpgroups)
# at D 128 (mangled: flash_fwd_tc_kernel<192, 128, lse>, flash_fwd_tc2_kernel<128, 128,
# lse>), each of which must hold the flash library's wanted instructions too
FWD_TC_FUNCTION = re.compile(r"flash_fwd_(tc2?)_kernelILi(128|192|256)ELi(128|256)ELb(\d)E")
# the bf16 backward's dK/dV and dQ instantiations at (256, 256), (192, 128) and (64, 64)
# (mangled: flash_bwd_dkdv_wg_kernel<256, 256>), which must each hold them
BWD_TC_FUNCTION = re.compile(r"flash_bwd_(dkdv|dq)_wg_kernelILi(256|192|64)ELi(256|128|64)EE")
# K2's tensor-core instantiations (decode_tc_kernel<G, D>), each of which must hold them
DEC_TC_FUNCTION = re.compile(r"decode_tc_kernelILi(\d+)ELi(\d+)EE")
# every instantiation of K1's bf16 forward and of its backward's dK/dV and dQ kernels, for
# the --ptxas report (registers and spills of each)
FWD_TC_ANY = re.compile(r"flash_fwd_(tc2?)_kernelILi(\d+)ELi(\d+)ELb(\d)E")
BWD_WG_ANY = re.compile(r"flash_bwd_(dkdv|dq)_wg_kernelILi(\d+)ELi(\d+)EE")
# K2's CUDA-core instantiations (decode_kernel<T, G, D>: fp32, and bf16 at G 1-3), for the
# --ptxas report
DEC_FMA_ANY = re.compile(r"decode_kernelI(f|13__nv_bfloat16)Li(\d+)ELi(\d+)EE")
# Adafactor's kernels by name and template arguments (mangled)
AF_ANY = re.compile(r"\d+(af_[a-z]+_kernel)I(.+?)Ev")


def sass_check() -> dict:
    """Counts of the ``SASS_WANTED`` instructions in each library, in each of
    K1's instantiations at MLA's dims and at D 256 on its own, and in each of
    its backward's dK/dV and dQ instantiations at (256, 256), (192, 128) and
    (64, 64); fails
    if one is missing, so a K1 (or its backward at those widths) that quietly
    stopped using the tensor cores or TMA, or a K3 that stopped moving 16
    bytes a load, does not pass; likewise each of K2's twelve tensor-core
    instantiations (groups 5, 7, 8, 16 at D 64, 128, 256) on its own."""
    from repro_torch.kernels import _build
    cuobjdump = os.path.join(os.path.dirname(_build.find_nvcc()), "cuobjdump")
    counts = {}
    for name, ops in SASS_WANTED.items():
        _build.load(name)                               # built if need be
        lib = _build._target(name)[1]
        sass = subprocess.run([cuobjdump, "-sass", str(lib)], capture_output=True, text=True,
                              timeout=300, check=True).stdout
        counts[name] = {op: len(re.findall(rf"\b{op}\b", sass)) for op in ops}
        if name == "flash_attention":
            for part in sass.split("Function : ")[1:]:
                m = FWD_TC_FUNCTION.search(part.split("\n", 1)[0])
                if m:
                    counts[f"flash_fwd_{m[1]}_kernel<{m[2]}, {m[3]}, lse {m[4]}>"] = {
                        op: len(re.findall(rf"\b{op}\b", part)) for op in ops}
            for kernel in ("tc_kernel<192", "tc_kernel<256", "tc2_kernel<128"):
                if sum(k.startswith(f"flash_fwd_{kernel}") for k in counts) != 2:
                    fail(f"the flash library lacks K1's two instantiations flash_fwd_{kernel}: "
                         f"{sorted(counts)}")
        if name == "flash_attention_bwd":
            for part in sass.split("Function : ")[1:]:
                m = BWD_TC_FUNCTION.search(part.split("\n", 1)[0])
                if m:
                    counts[f"flash_bwd_{m[1]}_wg_kernel<{m[2]}, {m[3]}>"] = {
                        op: len(re.findall(rf"\b{op}\b", part)) for op in ops}
            if sum(k.startswith("flash_bwd_") for k in counts) != 6:
                fail(f"the flash backward library lacks its dK/dV and dQ instantiations at "
                     f"(256, 256), (192, 128) and (64, 64): {sorted(counts)}")
        if name == "decode_attention":
            for part in sass.split("Function : ")[1:]:
                m = DEC_TC_FUNCTION.search(part.split("\n", 1)[0])
                if m:
                    counts[f"decode_tc_kernel<{m[1]}, {m[2]}>"] = {
                        op: len(re.findall(rf"\b{op}\b", part)) for op in ops}
            if sum(k.startswith("decode_tc_kernel") for k in counts) != 12:
                fail(f"the decode library lacks its twelve tensor-core instantiations: "
                     f"{sorted(counts)}")
    emit({"phase": "sass", "counts": counts})
    missing = [(name, op) for name, c in counts.items() for op, n in c.items() if n == 0]
    if missing:
        fail(f"instructions missing from the kernel libraries: {missing}")
    return counts


def ptxas_report(log: str, function: re.Pattern, label: str) -> dict:
    """Registers and spill bytes of each instantiation whose mangled name
    ``function`` matches, from ptxas's ``-v`` report in ``log``:
    {"label<args>": {"registers", "spill_stores", "spill_loads"}}."""
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            f = function.search(m[1])
            name = f"{label}<{', '.join(f.groups())}>" if f else None
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            out.setdefault(name, {})["spill_stores"] = int(m[1])
            out[name]["spill_loads"] = int(m[2])
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out.setdefault(name, {})["registers"] = int(m[1])
            name = None
    return out


def digest(out) -> str:
    """A short hash of a kernel's output bits (a tuple's in order; bf16 widened
    to fp32, which is exact)."""
    import hashlib
    h = hashlib.sha256()
    for t in (out if isinstance(out, (tuple, list)) else (out,)):
        h.update(t.detach().float().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


# this tree's D 128 forward takes its two-consumer plan (kv tiles of 128 rows) where q and
# k both hold this many rows (kernels/flash_attention.py PAIR_MIN_KEYS); the script times
# other trees too, whose packages may not say so
PAIR_MIN_KEYS = 1536


def new_k1_bits(D: int, S: int) -> bool:
    """Whether K1's bf16 forward at head dim ``D`` over ``S`` rows walks kv
    tiles of 128 rows in this tree (D 64; D 128 from ``PAIR_MIN_KEYS``), so
    that its bits are not a 64-row plan's."""
    return D == 64 or (D == 128 and S >= PAIR_MIN_KEYS)


def held_to_plain(q, k, v, causal, *, o=None, lse=None, do=None, grads=None) -> dict:
    """A ``times`` record's error against the plain versions, for a case whose
    outputs come from K1's bf16 forward where it walks kv tiles of 128 rows
    (:func:`new_k1_bits`), so that its bits are not those of a tree with
    64-row tiles: the
    forward's output against ``flash_attention_plain`` (largest absolute
    error); given the backward's ``o``, ``lse``, ``do`` and ``grads``, also
    the log-sum-exp against the plain one (over max(1, |lse|)) and the
    gradients against ``flash_attention_bwd_plain`` in fp32 from that ``o``
    and ``lse`` (``row_err``).  ``phase_baseline`` holds such a case in each
    tree to the kernel tolerance instead of to the other tree's bits."""
    from repro_torch.kernels import (flash_attention, flash_attention_bwd_plain,
                                     flash_attention_lse_plain)
    want_o, want_lse = flash_attention_lse_plain(q, k, v, causal=causal)
    got_o = flash_attention(q, k, v, causal=causal) if o is None else o
    err = max_err(got_o, want_o)
    if grads is not None:
        B, H, Sq, _ = q.shape
        one_key = torch.from_numpy(visible_per_row(Sq, k.shape[2], causal, 0) <= 1)
        want = flash_attention_bwd_plain(*(t.float() for t in (q, k, v, o)), lse, do.float(),
                                         causal=causal)
        err = max(err, float(((lse - want_lse).abs() / want_lse.abs().clamp_min(1)).max()),
                  row_err(grads, want, [one_key.expand(B, H, Sq).reshape(-1), None, None]))
    return {"held_to_plain": True, "plain_err": err, "tol": TOL[q.dtype]}


def phase_times():
    """The serving shapes of K1, K2 and K3 in bf16 and the train path's
    shapes of their backward (K1's also at D 256, G 16 and at MLA's (192,
    128), which need a tree with the MLA backward), through the wrappers'
    plain signatures, which every tree of the port since its training slice
    has (K3's
    ``rmsnorm(x, w, eps=, offset=, residual=)``, K1's ``flash_attention(...,
    lse=)`` then ``flash_attention_bwd(q, k, v, o, lse, do, causal=,
    window=)``, K3's ``rmsnorm_bwd(x, w, dy, eps=, offset=, ds=)``): ms and
    device_ms, for K3 the host time of a call, and a digest of every output
    (K1 in fp32 too), so that two trees' kernels are held bit for bit; K2's
    records also carry their error against the plain version, which holds
    two trees whose K2 splits or sums otherwise.  K1's backward at D 64 at
    whisper's three train shapes (by kernel), its forward at D 256 at
    ``K1_PARTS_FWD``'s shapes, at MLA's (192, 128) and at D 64 at
    ``K1_PARTS_FWD64``'s, and at D 128 at ``K1_PARTS_FWD128``'s and its
    backward at ``K1_PARTS_BWD128``'s (from the plain forward's o and
    log-sum-exp, by kernel) come from a stream of their own, as do K2 at a
    single sequence and at qwen2-vl's group of 7, last.  The records whose
    outputs come from K1's bf16 forward on kv tiles of 128 rows
    (:func:`new_k1_bits`) also carry their error against the plain versions
    (:func:`held_to_plain`)."""
    from repro_torch.kernels import (decode_attention, decode_attention_plain, flash_attention,
                                     flash_attention_bwd, flash_attention_lse_plain, rmsnorm,
                                     rmsnorm_bwd)
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
                    "ms": time_ms(call), "device_ms": device_ms(call), "out_sha": digest(call()),
                    **(held_to_plain(q, k, v, True) if new_k1_bits(128, S) else {})})
    for D in (64, 128, 256):       # the fp32 FMA kernel and the other head dims' instantiations
        for dtype in (bf16, torch.float32):
            q, k, v = flash_inputs(rng, B=1, H=8, Hkv=2, Sq=333, Sk=333, D=D, dtype=dtype,
                                   bshd=False)
            call = lambda: flash_attention(q, k, v, causal=True)  # noqa: E731
            out.append({"kernel": "flash_attention", "case": f"B1 H8 Hkv2 S333 D{D} causal "
                                                             f"{dt_name(dtype)}",
                        "ms": time_ms(call), "device_ms": device_ms(call),
                        "out_sha": digest(call())})
            if dtype is bf16 and new_k1_bits(D, 333):
                out[-1].update(held_to_plain(q, k, v, True))
    def k2(case, q, k, v, vl, timed=True):
        # K2's output bits, and its error against the plain version, which holds
        # two trees whose K2 sums in another order
        got = decode_attention(q, k, v, kv_valid_len=vl)
        rec = {"kernel": "decode_attention", "case": case, "out_sha": digest(got),
               "max_abs_err": max_err(got, decode_attention_plain(q, k, v, kv_valid_len=vl)),
               "tol": TOL[q.dtype]}
        if timed:
            call = lambda: decode_attention(q, k, v, kv_valid_len=vl)  # noqa: E731
            rec["ms"], rec["device_ms"] = time_ms(call), device_ms(call)
        return rec

    mixed = MIXED_VALID
    for valid in ([2048] * 8, mixed):
        q, k, v, vl = decode_inputs(rng, B=8, H=24, Hkv=8, T=2048, D=128, valid=valid,
                                    dtype=bf16, bthd=True)
        out.append(k2(f"B8 H24 Hkv8 T2048 D128 valid{valid}", q, k, v, vl))
    # every group a kernel takes, each head dim, both dtypes, split: the output bits alone
    # (inputs from streams of their own, so that a tree that takes more groups draws the
    # cases after these as every other tree does)
    import importlib
    dec = importlib.import_module("repro_torch.kernels.decode_attention")
    sweep_rng = np.random.default_rng(SEED + 1)
    for G in dec.SUPPORTED_G:
        for D in (64, 128, 256):
            for dtype in (bf16, torch.float32):
                q, k, v, vl = decode_inputs(sweep_rng, B=2, H=2 * G, Hkv=2, T=700, D=D,
                                            valid=[700, 333], dtype=dtype, bthd=True)
                out.append(k2(f"B2 H{2 * G} Hkv2 T700 D{D} {dt_name(dtype)}", q, k, v, vl,
                              timed=False))
    if 16 in dec.SUPPORTED_G:      # recurrentgemma's decode, where the tree takes it
        for valid in ([2048] * 8, mixed):
            q, k, v, vl = decode_inputs(sweep_rng, B=8, H=16, Hkv=1, T=2048, D=256,
                                        valid=valid, dtype=bf16, bthd=True)
            out.append(k2(f"B8 H16 Hkv1 T2048 D256 valid{valid}", q, k, v, vl))
    for rec, call in k3:
        out.append({**rec, "ms": time_ms(call), "device_ms": device_ms(call),
                    "out_sha": digest(call())})
    # K1's backward at D 128 from the plain forward's o and log-sum-exp (the same inputs in
    # every tree, whatever its forward's kv tiles), so that its own bits are held
    for S in (1000, 2048):
        q, k, v = flash_inputs(rng, B=1, H=24, Hkv=8, Sq=S, Sk=S, D=128, dtype=bf16, bshd=True)
        do = flash_inputs(rng, B=1, H=24, Hkv=8, Sq=S, Sk=S, D=128, dtype=bf16, bshd=True)[0]
        o, lse = flash_attention_lse_plain(q, k, v, causal=True)
        call = lambda: flash_attention_bwd(q, k, v, o, lse, do, causal=True, window=0)  # noqa: E731
        out.append({"kernel": "flash_attention_bwd", "case": f"B1 H24 Hkv8 S{S} D128 causal bshd",
                    "ms": time_ms(call), "device_ms": device_ms(call),
                    "out_sha": digest((o, lse, *call()))})
    # ... at recurrentgemma-9b's and deepseek-v3-671b's train shapes (D 256 at G 16 with its
    # window; MLA's (192, 128), which trees before the MLA backward's do not take)
    for B, H, Hkv, D, Dv, window in ((1, 16, 1, 256, 256, 2048), (1, 128, 128, 192, 128, 0)):
        q, k, v = flash_inputs(rng, B=B, H=H, Hkv=Hkv, Sq=2048, Sk=2048, D=D, dtype=bf16,
                               bshd=True, Dv=Dv)
        do = flash_inputs(rng, B=B, H=H, Hkv=Hkv, Sq=2048, Sk=2048, D=Dv, dtype=bf16,
                          bshd=True)[0]
        o = torch.empty_like(do)
        lse = torch.empty((B, H, 2048), dtype=torch.float32, device="cuda")
        flash_attention(q, k, v, causal=True, window=window, out=o, lse=lse)
        call = lambda: flash_attention_bwd(q, k, v, o, lse, do, causal=True,  # noqa: E731
                                           window=window)
        out.append({"kernel": "flash_attention_bwd",
                    "case": f"B{B} H{H} Hkv{Hkv} S2048 D{D} Dv{Dv} causal window{window} bshd",
                    "ms": time_ms(call), "device_ms_by_kernel": device_ms_by_kernel(call),
                    "out_sha": digest((o, lse, *call()))})
        out[-1]["device_ms"] = sum(out[-1]["device_ms_by_kernel"].values())
    # K1's backward at D 64 at whisper-large-v3's three train shapes and its forward at D 256
    # at recurrentgemma-9b's and gemma-7b's, from a stream of their own
    k1_rng = np.random.default_rng(SEED + 5)
    for name, B, H, Hkv, Sq, Sk, causal in K1_PARTS_BWD:
        q, k, v = flash_inputs(k1_rng, B=B, H=H, Hkv=Hkv, Sq=Sq, Sk=Sk, D=64, dtype=bf16,
                               bshd=True)
        do = flash_inputs(k1_rng, B=B, H=H, Hkv=Hkv, Sq=Sq, Sk=Sk, D=64, dtype=bf16,
                          bshd=True)[0]
        o = torch.empty_like(do)
        lse = torch.empty((B, H, Sq), dtype=torch.float32, device="cuda")
        flash_attention(q, k, v, causal=causal, out=o, lse=lse)
        call = lambda: flash_attention_bwd(q, k, v, o, lse, do, causal=causal,  # noqa: E731
                                           window=0)
        out.append({"kernel": "flash_attention_bwd",
                    "case": f"B{B} H{H} Hkv{Hkv} Sq{Sq} Sk{Sk} D64 causal{int(causal)} bshd",
                    "ms": time_ms(call), "device_ms_by_kernel": device_ms_by_kernel(call),
                    "out_sha": digest((o, lse, *call())),
                    **held_to_plain(q, k, v, causal, o=o, lse=lse, do=do, grads=call())})
        out[-1]["device_ms"] = sum(out[-1]["device_ms_by_kernel"].values())
    for name, B, H, Hkv, S, window in K1_PARTS_FWD:
        q, k, v = flash_inputs(k1_rng, B=B, H=H, Hkv=Hkv, Sq=S, Sk=S, D=256, dtype=bf16,
                               bshd=True)
        call = lambda: flash_attention(q, k, v, causal=True, window=window)  # noqa: E731
        out.append({"kernel": "flash_attention",
                    "case": f"B{B} H{H} Hkv{Hkv} S{S} D256 causal window{window} bshd",
                    "ms": time_ms(call), "device_ms": device_ms(call), "out_sha": digest(call())})
    # ... and K1 at deepseek-v3-671b's prefill, MLA's (192, 128)
    q, k, v = flash_inputs(k1_rng, B=1, H=128, Hkv=128, Sq=1000, Sk=1000, D=192, Dv=128,
                           dtype=bf16, bshd=True)
    call = lambda: flash_attention(q, k, v, causal=True)  # noqa: E731
    out.append({"kernel": "flash_attention", "case": "B1 H128 Hkv128 S1000 D192 Dv128 causal bshd",
                "ms": time_ms(call), "device_ms": device_ms(call), "out_sha": digest(call())})
    # ... and K1 at D 64 at whisper-large-v3's five shapes
    for name, B, Sq, Sk, causal in K1_PARTS_FWD64:
        q, k, v = flash_inputs(k1_rng, B=B, H=20, Hkv=20, Sq=Sq, Sk=Sk, D=64, dtype=bf16,
                               bshd=True)
        call = lambda: flash_attention(q, k, v, causal=causal)  # noqa: E731
        out.append({"kernel": "flash_attention",
                    "case": f"B{B} H20 Hkv20 Sq{Sq} Sk{Sk} D64 causal{int(causal)} bshd",
                    "ms": time_ms(call), "device_ms": device_ms(call), "out_sha": digest(call()),
                    **held_to_plain(q, k, v, causal)})
    # ... and K1 at D 128 at K1_PARTS_FWD128's shapes, its backward at K1_PARTS_BWD128's
    # from the plain forward's o and log-sum-exp, by kernel
    for name, B, H, Hkv, S in K1_PARTS_FWD128:
        q, k, v = flash_inputs(k1_rng, B=B, H=H, Hkv=Hkv, Sq=S, Sk=S, D=128, dtype=bf16,
                               bshd=True)
        call = lambda: flash_attention(q, k, v, causal=True)  # noqa: E731
        out.append({"kernel": "flash_attention",
                    "case": f"B{B} H{H} Hkv{Hkv} S{S} D128 causal bshd ({name})",
                    "ms": time_ms(call), "device_ms": device_ms(call), "out_sha": digest(call()),
                    **(held_to_plain(q, k, v, True) if new_k1_bits(128, S) else {})})
    for name, B, H, Hkv, S in K1_PARTS_BWD128:
        q, k, v = flash_inputs(k1_rng, B=B, H=H, Hkv=Hkv, Sq=S, Sk=S, D=128, dtype=bf16,
                               bshd=True)
        do = flash_inputs(k1_rng, B=B, H=H, Hkv=Hkv, Sq=S, Sk=S, D=128, dtype=bf16,
                          bshd=True)[0]
        o, lse = flash_attention_lse_plain(q, k, v, causal=True)
        call = lambda: flash_attention_bwd(q, k, v, o, lse, do, causal=True,  # noqa: E731
                                           window=0)
        out.append({"kernel": "flash_attention_bwd",
                    "case": f"B{B} H{H} Hkv{Hkv} S{S} D128 causal bshd ({name})",
                    "ms": time_ms(call), "device_ms_by_kernel": device_ms_by_kernel(call),
                    "out_sha": digest((o, lse, *call()))})
        out[-1]["device_ms"] = sum(out[-1]["device_ms_by_kernel"].values())
    for with_sum in (False, True):
        x, w, _ = rms_inputs(rng, 2048, 3072, bf16, bf16, False, False)
        dy = randn(rng, (2048, 3072), bf16)
        ds = randn(rng, (2048, 3072), bf16) if with_sum else None
        call = lambda: rmsnorm_bwd(x, w, dy, eps=1e-6, offset=False, ds=ds)  # noqa: E731
        out.append({"kernel": "rmsnorm_bwd", "case": "R2048 D3072" + (" with sum" if with_sum else ""),
                    "ms": time_ms(call), "device_ms": device_ms(call), "out_sha": digest(call())})
    # K2 at a single sequence (the long_500k cell's G 16 at D 256, qwen2-vl's G 7 and
    # phi4-mini's G 3 at D 128), at qwen2-vl's B8 serving mix, and at the serving shapes of
    # the groups of 1 (olmoe's; whisper's self and cross attention), on a stream of their own
    k2_rng = np.random.default_rng(SEED + 3)
    for B, H, Hkv, T, D, valid in ((1, 16, 1, 2048, 256, [2048]), (1, 28, 4, 2048, 128, [2048]),
                                   (1, 24, 8, 2048, 128, [2048]), (8, 28, 4, 2048, 128, mixed),
                                   (8, 16, 16, 2048, 128, mixed),
                                   (8, 20, 20, 448, 64, [1, 448, 17, 200, 127, 447, 64, 300]),
                                   (8, 20, 20, 1500, 64, None)):
        q, k, v, vl = decode_inputs(k2_rng, B=B, H=H, Hkv=Hkv, T=T, D=D, valid=valid,
                                    dtype=bf16, bthd=True)
        out.append(k2(f"B{B} H{H} Hkv{Hkv} T{T} D{D} valid{valid}", q, k, v, vl))
    emit({"phase": "times", "src": SRC, "records": out, "host_pieces_us": host_pieces_us})


def apply_patch(root: str, patch: str) -> None:
    """Apply the unified diff ``patch`` to the files under ``root`` (paths
    after ``+++ b/``).  Every hunk must match its file exactly where its
    header says; otherwise fail."""
    lines = open(patch).read().split("\n")
    hunks, i = {}, 0
    while i < len(lines):
        if lines[i].startswith("+++ "):
            path = lines[i][4:].split("\t")[0].removeprefix("b/")
            hunks[path] = []
        m = re.match(r"@@ -(\d+)(?:,(\d+))? \+\d+(?:,(\d+))? @@", lines[i])
        if m:
            n_old, n_new = int(m[2] or 1), int(m[3] or 1)
            old, new = [], []
            while len(old) < n_old or len(new) < n_new:
                i += 1
                tag, text = lines[i][:1], lines[i][1:]
                if tag in (" ", "-"):
                    old.append(text)
                if tag in (" ", "+"):
                    new.append(text)
            start = int(m[1]) - (1 if n_old else 0)
            hunks[path].append((start, old, new))
        i += 1
    for path, edits in hunks.items():
        fp = os.path.join(root, path)
        text = open(fp).read().split("\n")
        for start, old, new in reversed(edits):
            if text[start:start + len(old)] != old:
                fail(f"{patch}: a hunk at {path}:{start + 1} does not match")
            text[start:start + len(old)] = new
        with open(fp, "w") as f:
            f.write("\n".join(text))


def variant_src(base_src: str, patch: str) -> str:
    """A copy of ``base_src``/repro_torch under build/variants/<patch's
    name>/src with ``patch`` applied; returns that src."""
    import shutil
    name = os.path.splitext(os.path.basename(patch))[0]
    root = os.path.join(HERE, "build", "variants", name)
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(os.path.join(base_src, "repro_torch"),
                    os.path.join(root, "src", "repro_torch"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    apply_patch(root, patch)
    return os.path.join(root, "src")


def phase_baseline(other: str, variants: list[str] = ()) -> None:
    """phase_times for the tree at ``other``, for that tree with each patch of
    ``variants`` applied, and for this one, in turns (other, each variant,
    this, this, each variant in reverse, other), each in a process of its
    own.  This tree must give the other's bits; a variant's other bits, or a
    variant that fails to build or run, is reported, not fatal."""
    other_src = os.path.join(os.path.abspath(other), "src")
    if not os.path.isdir(os.path.join(other_src, "repro_torch")):
        fail(f"--baseline-src: no src/repro_torch under {other}")
    trees = [("baseline", other_src)]
    trees += [(os.path.splitext(os.path.basename(p))[0], variant_src(other_src, p))
              for p in variants]
    runs, broken = [], {}
    for label, src in [*trees, ("this", SRC), ("this", SRC), *reversed(trees)]:
        if label in broken:
            continue
        env = dict(os.environ, CHIP_SMOKE_SRC=src)
        env.pop("REPRO_TORCH_BUILD_DIR", None)     # each tree builds into its own build/
        res = subprocess.run([sys.executable, os.path.abspath(__file__), "--phases", "times"],
                             capture_output=True, text=True, timeout=900, env=env)
        lines = [ln for ln in res.stdout.splitlines() if ln.startswith('{"phase": "times"')]
        if res.returncode != 0 or not lines:
            if label in ("baseline", "this"):
                fail(f"baseline run of {src} failed (exit {res.returncode}):\n"
                     f"{res.stderr[-4000:]}")
            broken[label] = f"exit {res.returncode}: {res.stderr[-2000:]}"
            continue
        runs.append({"tree": label, **json.loads(lines[0])})
    # every kernel's output bits but K2's and K1's bf16 forward's at D 64 and D 128 (and its
    # backward's from those outputs at D 64), this tree's against the other's, case by case (the
    # cases both trees run: a shape the other tree's kernels do not take is this one's
    # alone); K2, whose splits and sums may differ between trees, and those K1 cases, whose
    # kv tiles may, are held in each run to their plain versions at the kernel tolerance
    def sha_map(run):
        return {(r["kernel"], r["case"]): r.get("out_sha") for r in run["records"]
                if r["kernel"] != "decode_attention" and not r.get("held_to_plain")}

    def differing(rs):
        shas = [sha_map(run) for run in rs]
        common = set.intersection(*(set(s_) for s_ in shas))
        return common, [f"{k} {c}" for (k, c) in sorted(common)
                        if len({s_[(k, c)] for s_ in shas}) != 1]

    main_runs = [run for run in runs if run["tree"] in ("baseline", "this")]
    common, differ = differing(main_runs)
    variant_differ = {label: differing([r for r in runs if r["tree"] in ("baseline", label)])[1]
                      for label, _ in trees[1:] if label not in broken}
    k2_over = [f"{run['tree']} {r['case']}: {r['max_abs_err']}" for run in runs
               for r in run["records"]
               if r["kernel"] == "decode_attention" and not r["max_abs_err"] <= r["tol"]]
    held = sorted({f"{r['kernel']} {r['case']}" for run in runs for r in run["records"]
                   if r.get("held_to_plain")})
    held_over = [f"{run['tree']} {r['kernel']} {r['case']}: {r['plain_err']}" for run in runs
                 for r in run["records"]
                 if r.get("held_to_plain") and not r["plain_err"] <= r["tol"]]
    # K1's and its backward's device ms by tree, one entry a run, in the order run
    k1_ms = {}
    for run in runs:
        for r in run["records"]:
            if r["kernel"].startswith("flash_attention"):
                k1_ms.setdefault(f"{r['kernel']} {r['case']}", {}).setdefault(
                    run["tree"], []).append(r["device_ms"])
    emit({"phase": "baseline", "runs": runs, "outputs_bit_equal": not differ, "differ": differ,
          "cases_compared": len(common), "k2_over_tolerance": k2_over,
          "this_tree_only": sorted(f"{k} {c}" for (k, c) in
                                   set(sha_map(main_runs[1])) - common),
          "variant_differ": variant_differ, "variant_broken": broken, "k1_device_ms": k1_ms,
          "held_to_plain": held, "held_over_tolerance": held_over})
    if differ:
        fail(f"--baseline-src: outputs differ from the other tree's: {differ}")
    if k2_over:
        fail(f"--baseline-src: K2 over its tolerance against the plain version: {k2_over}")
    main_over = [h for h in held_over if h.split(" ", 1)[0] in ("baseline", "this")]
    if main_over:
        fail(f"--baseline-src: K1 at D 64 or 128 over its tolerance against the plain version: "
             f"{main_over}")


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
            "rmsnorm": norms * (len(reqs) + steps), "flash_attention_bwd": 0, "rmsnorm_bwd": 0,
            "adamw": 0, "adafactor": 0}
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


def phase_parity(cfg=None, params=None, phase: str = "parity") -> dict:
    """4 layers of the serve model (or ``params`` of ``cfg``, made by the
    caller): kernels against their plain versions, the first-token logits
    of serve's 12 prompts, then both engines' tokens."""
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    if cfg is None:
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
    tol = 1e-1   # bf16 activations through the layers: one rounding step differs here and there
    same_first, near_tie, equal, total = 0, 0, 0, 0
    for i, (a, b) in enumerate(zip(runs[False], runs[True])):
        same_first += a.tokens[0] == b.tokens[0]
        near_tie += (a.tokens[0] != b.tokens[0]) and float(margin[i]) <= 2 * float(diff[i])
        equal += sum(x == y for x, y in zip(a.tokens, b.tokens))
        total += len(a.tokens)
    rec = {"phase": phase, **({"part": "parity", "arch": cfg.name} if phase != "parity" else {}),
           "layers": cfg.num_layers, "requests": len(runs[False]),
           "first_logits_max_abs_diff": float(diff.max()), "tol": tol,
           "first_token_equal": same_first, "first_token_near_tie": near_tie,
           "tokens_equal_share": equal / total}
    emit(rec)
    if not float(diff.max()) <= tol:
        fail(f"{phase}: first-token logits differ by {float(diff.max())} > {tol}")
    if same_first + near_tie != len(runs[False]):
        fail(f"{phase}: a first token differs between kernels and plain versions beyond a "
             "near-tie of the two best logits")
    return rec


# --------------------------------------------------------------------------
# training: the launcher's step at full size, and kernels against plain
# --------------------------------------------------------------------------

TRAIN_BATCH, TRAIN_SEQ = 1, 2048
TRAIN_STEPS = 3          # timed steps, after one warm-up step and before one profiled step


@contextlib.contextmanager
def k1_calls_by_shape():
    """While open, K1's forward and backward calls through the autograd glue
    (``kernels/ops.py``) are counted by ``"fwd|bwd Sq<q> Sk<k> causal<c>"``
    (into the dict it yields); the calls themselves are unchanged."""
    from repro_torch.kernels import ops
    counts: dict = {}
    saved = ops._flash_attention, ops._flash_attention_bwd

    def counted(way, fn):
        def call(q, k, *a, causal=True, **kw):
            key = f"{way} Sq{q.shape[2]} Sk{k.shape[2]} causal{int(causal)}"
            counts[key] = counts.get(key, 0) + 1
            return fn(q, k, *a, causal=causal, **kw)
        return call

    ops._flash_attention = counted("fwd", saved[0])
    ops._flash_attention_bwd = counted("bwd", saved[1])
    try:
        yield counts
    finally:
        ops._flash_attention, ops._flash_attention_bwd = saved


def train_spec(cfg, *, seq: int = TRAIN_SEQ, batch: int = TRAIN_BATCH, optimizer: str = "adamw"):
    from repro_torch.api import Cluster, SimSpec, TrainWorkload
    return SimSpec(cfg, cluster=Cluster("h100_sxm", chips=1),
                   workload=TrainWorkload(global_batch=batch, seq_len=seq, remat="block",
                                          optimizer=optimizer))


def train_shape(cfg, seq: int = TRAIN_SEQ, batch: int = TRAIN_BATCH,
                cut: str = "seq", optimizer: str = "adamw") -> tuple[int, int, float]:
    """(batch, sequence, predicted bytes): B``batch`` S``seq`` if the port's
    simulator says its step under ``optimizer`` fits the card's memory, else
    the sequence (or, ``cut="batch"``, the batch) halved until it does (depth
    and width are never cut)."""
    from repro_torch.core import Simulator
    total = torch.cuda.get_device_properties(0).total_memory
    while True:
        need = Simulator("h100_sxm").run(train_spec(cfg, seq=seq, batch=batch,
                                                    optimizer=optimizer)).memory.total
        if need <= total or (seq <= 128 if cut == "seq" else batch <= 1):
            return batch, seq, need
        if cut == "seq":
            seq //= 2
        else:
            batch //= 2


def adafactor_launches_a_step(cfg, params) -> int:
    """The kernels one Adafactor update of ``params`` launches: its layer
    groups' (``adafactor.launch_plan``: 2 a group that is not factored, 3 a
    factored one: the statistics, the u^2 pass, which returns at once where
    the statistics' guard held, and the apply)."""
    from repro_torch.kernels import adafactor as AF
    from repro_torch.training.optimizer import _groups, _stack_shape
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return sum(AF.launch_plan(_stack_shape(g), len(g), g[0].dtype, g[0].dtype, 8, sms)["kernels"]
               for g in _groups(params, cfg))


def phase_train(arch: str = ARCH, phase: str = "train", timed_steps: int = TRAIN_STEPS,
                perturb=None, seq: int = TRAIN_SEQ, batch: int = TRAIN_BATCH, cut: str = "seq",
                layers: int | None = None, optimizer: str = "adamw", then=None):
    """phi4-mini-3.8b (or ``arch``) at full width and depth through
    repro_torch.launch.train's pieces (its Trainer: config, synthetic data,
    ``optimizer`` (``--optimizer``), remat "block", the train step): one
    warm-up step, ``timed_steps`` steps timed with CUDA events and counted by
    the kernel wrappers, one step under the profiler; loss and grad norm
    finite at every step, the step counter advancing by one.
    ``perturb(params)``: changes the initial parameters in place (leaves the
    reference's init leaves at 0); ``seq`` and ``batch``: the shape to start
    from, ``cut`` what ``train_shape`` halves if it does not fit; ``layers``:
    the depth, cut from the config's (width never cut); ``then(trainer,
    state, batch)``: run on the state after the profiled step, before it is
    freed, its result under the record's ``"then"``."""
    from repro_torch import kernels as K
    from repro_torch.configs import get_config
    from repro_torch.launch import train as T
    cfg = get_config(arch)
    if layers is not None:
        cfg = cfg.replace(num_layers=layers)
    B, S, predicted_bytes = train_shape(cfg, seq, batch, cut, optimizer)
    argv = ["--batch", str(B), "--seq", str(S), "--remat", "block", "--optimizer", optimizer,
            "--steps", str(timed_steps + 2), "--ckpt-every", "0", "--seed", str(SEED)]
    # the launcher's own default arch is taken as a user who names none gets it
    launcher_default = T.parse_args(argv).arch == arch
    if not launcher_default:
        argv = ["--arch", arch, *argv]
    trainer = T.Trainer(T.parse_args(argv), cfg=cfg)
    torch.cuda.reset_peak_memory_stats()
    state = trainer.init_state()
    if perturb is not None:
        with torch.no_grad():
            perturb(state["params"])
    from repro_torch.training.optimizer import tree_leaves
    n_leaves = len(tree_leaves(state["params"]))
    af_launches = adafactor_launches_a_step(cfg, state["params"])
    pipe = trainer.pipeline(0)
    steps = []

    def one(state):
        before = int(state["step"])
        state, metrics = trainer.step_fn(state, next(pipe))
        loss, gn = float(metrics["loss"]), float(metrics["grad_norm"])
        steps.append({"step": before, "loss": loss, "grad_norm": gn})
        if not (math.isfinite(loss) and math.isfinite(gn)):
            fail(f"train step {before}: loss {loss}, grad_norm {gn}")
        if int(state["step"]) != before + 1:
            fail(f"train step {before}: the step counter went to {int(state['step'])}")
        return state

    try:
        t0 = time.perf_counter()
        state = one(state)                                   # warm-up
        warm_s = time.perf_counter() - t0
        K.reset_launch_counts()
        wall_ms = []
        with k1_calls_by_shape() as k1_shapes:
            for _ in range(timed_steps):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                state = one(state)
                end.record()
                end.synchronize()
                wall_ms.append(start.elapsed_time(end))
        counts = K.launch_counts()
        parts = {"warmup_s": warm_s, "timed_s": time.perf_counter() - t0 - warm_s}
        from torch.profiler import ProfilerActivity, profile
        t1 = time.perf_counter()
        # the device's activity alone: the record reads kernels only, and the
        # host's operator events of an eager step (the sLSTM's loop makes
        # about 190,000 launches a step) took minutes to read back
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            state = one(state)
            torch.cuda.synchronize()
        parts["profiled_step_s"] = time.perf_counter() - t1
        avgs = prof.key_averages()
        t2 = time.perf_counter()
        parts["profile_read_s"] = t2 - t1 - parts["profiled_step_s"]
        groups = device_groups(avgs)
        launches = sum(e.count for e in avgs if e.device_type == torch.autograd.DeviceType.CUDA)
        top_other = top_kernels(avgs, "other")
        k1_bwd = top_kernels(avgs, "K1_bwd")
        peak = torch.cuda.max_memory_allocated()
        # the optimizer's share of the step: one more update, alone, on
        # gradients of the parameters' shapes (its arithmetic does not depend
        # on their values); after the peak is read
        from repro_torch.training.optimizer import tree_map
        grads = tree_map(lambda p: torch.zeros_like(p, requires_grad=False), state["params"])
        update = lambda: trainer.optimizer.update(grads, state["opt"], state["params"])  # noqa: E731
        optimizer_ms = time_ms(update, iters=2, warmup=1)
        optimizer_device_ms = device_ms(update, iters=2, cold=False)
        del grads, update
        parts["optimizer_s"] = time.perf_counter() - t2
        after = then(trainer, state, next(pipe)) if then is not None else None
    finally:
        pipe.close()
    per_step = {k: v / timed_steps for k, v in counts.items()}
    L = cfg.num_layers
    La = attention_calls(cfg)           # K1 calls of a forward
    # what one step of the path launches: K1 forward twice an attention call
    # (the forward and its recomputation under remat "block"), its backward
    # once; K3 forward 2L + 1 (two norms a block, the final norm outside the
    # checkpoints) plus 2L recomputed, its backward 2L + 1 (none where the
    # norm is LayerNorm, plain torch); the AdamW update once a parameter
    # tensor, Adafactor's kernels (2 or 3) once a layer group
    rms = cfg.norm != "layernorm"
    want = {"flash_attention": 2 * La, "flash_attention_bwd": La,
            "rmsnorm": (4 * L + 1) * rms, "rmsnorm_bwd": (2 * L + 1) * rms,
            "decode_attention": 0, "adamw": n_leaves if optimizer == "adamw" else 0,
            "adafactor": af_launches if optimizer == "adafactor" else 0}
    rec = {"phase": phase, "arch": cfg.name, "layers": L, "d_model": cfg.d_model,
           "params": cfg.param_count(), "batch": B, "seq": S, "remat": "block",
           "optimizer": optimizer, "predicted_bytes": predicted_bytes,
           "steps": steps, "warmup_s": warm_s, "wall_ms": wall_ms,
           "wall_ms_median": float(np.median(wall_ms)),
           "device_busy_ms": sum(groups.values()) / 1e3,
           "device_ms_by_group": {k: v / 1e3 for k, v in groups.items()},
           "device_launches": launches, "peak_bytes": peak, "top_other_ms": top_other,
           "k1_bwd_kernels_ms": k1_bwd,
           "optimizer_ms": optimizer_ms, "optimizer_device_ms": optimizer_device_ms,
           "launches": counts, "launches_per_step": per_step, "launches_per_step_want": want,
           "k1_launches_by_shape": {k: v / timed_steps for k, v in sorted(k1_shapes.items())},
           "parts_s": parts, "launcher_argv": argv, "launcher_default_arch": launcher_default,
           "gpu": gpu_name_and_power()}
    if after is not None:
        rec["then"] = after
    emit(rec)
    if any(per_step[k] != v for k, v in want.items()):
        fail(f"{phase}: kernel launches a step {per_step}, the path implies {want}")
    del state, trainer
    torch.cuda.empty_cache()
    return rec


def leaf_paths(tree, keys: str = "") -> list:
    """The dotted path of each leaf of ``tree`` in ``tree_leaves`` order
    (dict keys sorted, lists in order, a list index as a key)."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in leaf_paths(tree[k], f"{keys}.{k}")]
    if isinstance(tree, (list, tuple)):
        return [p for i, v in enumerate(tree) for p in leaf_paths(v, f"{keys}.{i}")]
    return [keys[1:]]


def rel_l2(got, want) -> float:
    """||got - want|| / ||want|| in fp32 (0 where both are 0)."""
    d = float(torch.linalg.vector_norm((got.float() - want.float()).reshape(-1)))
    n = float(torch.linalg.vector_norm(want.float().reshape(-1)))
    return d / n if n else d


PARITY_LR = 1e-3    # the peak lr of the reference's training tests, reached at step 1
UPDATE_TOL = 0.5    # relative L2 of a parameter's change in one step, kernels against plain
# Leaves whose change is held to the lr bound (each element within lr and one bf16 rounding)
# in place of UPDATE_TOL, beside the gradient limit that every leaf keeps, by arch and the
# end of their path.  qwen2.5-32b's key biases (zero at init): RoPE with theta 1e6 turns about
# a third of a key's components by under 0.1 rad over 512 positions, and the softmax ignores
# a score shift common to every key, so the gradient of those components is near 0, about
# the size of the rounding; AdamW's first step, lr sign(g), then moves 13-14 % of the
# elements the other way on the other side (their gradients within 0.018 relative L2 of
# each other, their changes 0.72 apart, on an H100 at 2 layers).
SIGN_BOUND_LEAVES = {"qwen2.5-32b": ".attn.k.b"}


def adamw_foreach(ps, gs, ms, vs, *, lr, c1, c2, b1, b2, eps, weight_decay) -> None:
    """``adamw_update_plain`` over lists of leaves in PyTorch's multi-tensor
    (``_foreach``) ops, op for op, in place: the way to update a whole tree in
    a few launches without a kernel of one's own.  Each op makes a whole-tree
    temporary, and gradients and parameters are widened leaf by leaf (there is
    no multi-tensor cast).  Timed beside the kernel; used nowhere in the port."""
    g = [t.to(torch.float32) for t in gs]
    torch._foreach_mul_(ms, b1)
    torch._foreach_add_(ms, torch._foreach_mul(g, 1 - b1))
    torch._foreach_mul_(vs, b2)
    sq = torch._foreach_mul(g, g)
    del g
    torch._foreach_mul_(sq, 1 - b2)
    torch._foreach_add_(vs, sq)
    del sq
    u = torch._foreach_div(ms, c1)
    d = torch._foreach_div(vs, c2)
    torch._foreach_sqrt_(d)
    torch._foreach_add_(d, eps)
    torch._foreach_div_(u, d)
    del d
    pf = [p.to(torch.float32) for p in ps]
    torch._foreach_add_(u, torch._foreach_mul(pf, weight_decay))
    torch._foreach_mul_(u, lr)
    torch._foreach_copy_(ps, torch._foreach_sub(pf, u))


def adamw_tree_times(params, grads, opt_state) -> dict:
    """One AdamW update of a whole parameter tree, three ways, at step 1 of
    the parity run's schedule: the kernel a leaf (what the port runs), the
    plain version a leaf, and ``adamw_foreach``; each from the same p, g, m, v
    (the last two checked bit-equal to the first), then each timed (CUDA
    events and profiler device time; the tree is updated in place again and
    again, which does not change the arithmetic) with the device memory it
    takes beyond its inputs."""
    from repro_torch.kernels import adamw_update, adamw_update_plain
    from repro_torch.training.optimizer import cosine_schedule, tree_leaves
    step = torch.ones((), dtype=torch.int32, device="cuda")
    hp = dict(lr=cosine_schedule(PARITY_LR, warmup=1)(step), b1=0.9, b2=0.95, eps=1e-8,
              weight_decay=0.1)
    hp["c1"] = 1.0 - torch.pow(torch.tensor(0.9, device="cuda"), step.float())
    hp["c2"] = 1.0 - torch.pow(torch.tensor(0.95, device="cuda"), step.float())
    base = [tree_leaves(params), list(grads), tree_leaves(opt_state["m"]),
            tree_leaves(opt_state["v"])]

    def per_leaf(fn):
        return lambda ps, gs, ms, vs: [fn(*a, **hp) for a in zip(ps, gs, ms, vs)]
    ways = {"kernel_per_leaf": per_leaf(adamw_update),
            "plain_per_leaf": per_leaf(adamw_update_plain),
            "plain_foreach": lambda ps, gs, ms, vs: adamw_foreach(ps, gs, ms, vs, **hp)}
    out = {"leaves": len(base[0]), "params": sum(p.numel() for p in base[0])}
    first = None
    for name, fn in ways.items():       # the kernel first: the others are held to it
        ps, ms, vs = ([t.detach().clone() for t in ts] for ts in (base[0], base[2], base[3]))
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        fn(ps, base[1], ms, vs)
        torch.cuda.synchronize()
        out[name] = {"extra_bytes": torch.cuda.max_memory_allocated() - before}
        if first is None:
            first = (ps, ms, vs)
            continue
        out[name]["bit_equal"] = all(torch.equal(a, b) for x, y in zip(first, (ps, ms, vs))
                                     for a, b in zip(x, y))
        time_way(out[name], fn, ps, base[1], ms, vs)
        del ps, ms, vs
        torch.cuda.empty_cache()
    time_way(out["kernel_per_leaf"], ways["kernel_per_leaf"], first[0], base[1], *first[1:])
    del first
    torch.cuda.empty_cache()
    return out


def time_way(rec, fn, *args) -> None:
    """``ms`` and ``device_ms`` of ``fn(*args)``, into ``rec``."""
    call = lambda: fn(*args)  # noqa: E731
    rec["ms"] = time_ms(call, iters=3, warmup=1)
    rec["device_ms"] = device_ms(call, iters=2, cold=False)


class RoutePin:
    """Records the experts each MoE dispatch chooses (``torch.topk`` as
    ``repro_torch.models.layers`` calls it) and replays them, in call order,
    in another run, so that two runs are held against each other on the same
    routes: routing is discontinuous, and where the kernels and their plain
    versions round differently a near-tied choice flips now and then.  While
    active it stands in for ``torch`` in that module; every other name is
    torch's own."""

    def __init__(self):
        self.calls, self.margins, self.mode, self.next = [], [], None, 0

    def __getattr__(self, name):
        return getattr(torch, name)

    def topk(self, probs, k, dim=-1, **kw):
        if self.mode == "replay":
            ids = self.calls[self.next]
            self.next += 1
            if ids.shape != (*probs.shape[:-1], k):
                fail(f"route replay: dispatch {self.next} has {tuple(probs.shape)}, "
                     f"the recorded routes {tuple(ids.shape)}")
            return probs.gather(dim, ids), ids
        vals, ids = torch.topk(probs, k, dim=dim, **kw)
        if self.mode == "record":
            # the router margin: the k-th choice's probability over the next one's
            top = torch.topk(probs, k + 1, dim=dim).values
            self.calls.append(ids)
            self.margins.append(top[..., k - 1] - top[..., k])
        return vals, ids

    def run(self, mode: str, fn, *args):
        from repro_torch.models import layers as L
        if mode == "record":
            self.calls, self.margins = [], []
        self.mode, self.next = mode, 0
        L.torch = self
        try:
            return fn(*args)
        finally:
            L.torch, self.mode = torch, None


def route_agreement(a: list, b: list) -> list:
    """Per dispatch (a layer's call), the share of (token, k) choices of run
    ``a`` that run ``b`` also made for that token."""
    out = []
    for x, y in zip(a, b):
        same = (x[..., :, None] == y[..., None, :]).any(-1)
        out.append(float(same.float().mean()))
    return out


def phase_train_parity(arch: str = ARCH, phase: str = "train_parity", tree_times: bool = True,
                       layers: int = 4, optimizer: str = "adamw", compression: str = "none",
                       perturb=None):
    """The train step of ``arch`` cut to ``layers`` layers, once through the
    kernels (the model's and AdamW's) and once through their plain versions,
    from the same parameters and batch, at lr PARITY_LR from the first step
    (warm-up 1), so that the step moves bf16 parameters by several of their
    last places: loss (and its cross-entropy and router parts), every
    gradient leaf, and each parameter leaf's change under ``optimizer``
    (``"adamw"`` or ``"adafactor"``, over the config's block cycle) with
    ``compression`` (``"none"`` or ``"int8"``).  ``perturb(params, gen)``
    changes the initial parameters in place.  A MoE model's plain run takes
    the kernel run's routes (``RoutePin``); the share of choices an unpinned
    plain forward makes alike is reported beside.  Then, with
    ``tree_times`` (AdamW), ``adamw_tree_times`` on that tree."""
    from repro_torch.configs import RunConfig, ShapeConfig, get_config
    from repro_torch.models import Model
    from repro_torch.training import SyntheticTokenPipeline, init_state, make_loss_fn
    from repro_torch.training import make_train_step
    from repro_torch.training.optimizer import (adafactor, adamw, cosine_schedule, tree_leaves,
                                                tree_map)
    cfg = get_config(arch).replace(num_layers=layers)
    run = RunConfig(model=cfg, shape=ShapeConfig("parity", 512, 2, "train"), remat_policy="block",
                    optimizer=optimizer, grad_compression=compression)
    pipe = SyntheticTokenPipeline(cfg, global_batch=2, seq_len=512, seed=SEED)
    batch = next(pipe)
    pipe.close()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    base = Model(cfg).init(gen)
    if perturb is not None:
        with torch.no_grad():
            perturb(base, gen)
    pin = RoutePin() if cfg.is_moe else None
    out, parts = {}, {}

    def step(plain):
        tree = tree_map(lambda t: t.detach().clone().requires_grad_(), base)
        model = Model(cfg, remat_policy="block", plain_kernels=plain)
        loss, m = make_loss_fn(model)(tree, batch)
        grads = [g.detach() for g in torch.autograd.grad(loss, tree_leaves(tree))]
        lr = cosine_schedule(PARITY_LR, warmup=1)
        opt = adamw(lr, plain_kernels=plain) if optimizer == "adamw" \
            else adafactor(lr, cfg=cfg, plain_kernels=plain)
        state = init_state(tree, opt)
        state, metrics = make_train_step(cfg, run, opt, plain_kernels=plain)(state, batch)
        delta = [p.detach().float() - b.float()
                 for p, b in zip(tree_leaves(state["params"]), tree_leaves(base))]
        parts[plain] = {"ce": float(m["ce"].detach()), "aux_loss": float(m["aux_loss"].detach())}
        # the state is kept only for the tree's update times: a run holds its parameters
        # and AdamW's moments (10 bytes a parameter) while the other run takes its own
        return (float(loss.detach()), float(metrics["loss"]), grads, delta,
                state if tree_times else None)

    for plain in (False, True):
        if pin is None:
            out[plain] = step(plain)
        else:
            out[plain] = pin.run("replay" if plain else "record", step, plain)
    rec_routes = {}
    if pin is not None:
        if pin.next != len(pin.calls):
            fail(f"{phase}: the plain run made {pin.next} dispatches, the kernels' "
                 f"{len(pin.calls)}")
        # the forward's routes, kernels (recorded above) against an unpinned plain forward
        kernel_calls = pin.calls
        with torch.no_grad():
            pin.run("record", Model(cfg, plain_kernels=True).forward, base, batch)
        rec_routes = {"routes_pinned": True, "dispatches_replayed": len(kernel_calls),
                      "unpinned_route_agreement_by_layer":
                          route_agreement(kernel_calls[:cfg.num_layers], pin.calls)}
    (lk, mk, gk, dk, state), (lp, mp, gp, dp, _) = out.pop(False), out.pop(True)
    by_leaf = [{"leaf": name, "shape": list(a.shape), "grad_rel_l2": rel_l2(a, b),
                "update_rel_l2": rel_l2(c, d),
                # elements whose gradient takes the other sign on the other side
                "grad_sign_differs_share": float(((a > 0) != (b > 0)).float().mean())}
               for name, a, b, c, d in zip(leaf_paths(base), gk, gp, dk, dp)]
    grad_err = max(r["grad_rel_l2"] for r in by_leaf)
    tail = SIGN_BOUND_LEAVES.get(arch)
    bounded = [i for i, r in enumerate(by_leaf) if tail and r["leaf"].endswith(tail)]
    update_err = max(r["update_rel_l2"] for i, r in enumerate(by_leaf) if i not in bounded)
    bounded_change = max((float(d.abs().max()) for i in bounded for d in (dk[i], dp[i])),
                         default=None)
    moved = sum(int((d != 0).sum()) for d in dk) / sum(d.numel() for d in dk)
    del gp, dp
    # bf16 activations through 4 layers forward and back: the kernels and the
    # plain versions round at other places (P before P V, the sums of squares),
    # as parity's logits do; AdamW's first step is lr (sign(g) + wd p), so an
    # element whose gradient is near 0 may take the other sign on the other
    # side; no update at all reads 1, an update of unrelated gradients about 1.4
    tol = {"loss": 1e-2, "grad_rel_l2": 5e-2, "update_rel_l2": UPDATE_TOL,
           "lr_bound": PARITY_LR * (1 + 2 ** -7)}
    rec = {"phase": phase, "arch": cfg.name, "layers": cfg.num_layers, "batch": 2, "seq": 512,
           "optimizer": optimizer, "grad_compression": compression,
           "lr": PARITY_LR, "loss_kernels": lk, "loss_plain": lp, "loss_abs_diff": abs(lk - lp),
           "step_loss_abs_diff": abs(mk - mp), "loss_parts_kernels": parts[False],
           "loss_parts_plain": parts[True], "grad_leaves": len(gk),
           "grad_rel_l2_max": grad_err, "update_rel_l2_max": update_err,
           "share_of_elements_moved": moved, "tol": tol,
           "lr_bound_leaves": [by_leaf[i]["leaf"] for i in bounded],
           "lr_bound_leaves_max_abs_change": bounded_change,
           "worst_update_leaves": sorted(by_leaf, key=lambda r: -r["update_rel_l2"])[:4],
           **rec_routes}
    del dk
    if tree_times:
        rec["adamw_tree"] = adamw_tree_times(state["params"], gk, state["opt"])
    emit(rec)
    if not (abs(lk - lp) <= tol["loss"] and abs(mk - mp) <= tol["loss"]):
        fail(f"{phase}: loss {lk} (kernels) against {lp} (plain)")
    for k in ("ce", "aux_loss"):
        if not abs(parts[False][k] - parts[True][k]) <= tol["loss"]:
            fail(f"{phase}: {k} {parts[False][k]} (kernels) against {parts[True][k]} (plain)")
    if not grad_err <= tol["grad_rel_l2"]:
        fail(f"{phase}: a gradient differs by {grad_err} (relative L2)")
    if not update_err <= tol["update_rel_l2"]:
        fail(f"{phase}: a parameter's change differs by {update_err} (relative L2)")
    if bounded and not bounded_change <= tol["lr_bound"]:
        fail(f"{phase}: a leaf of {tail} changed by {bounded_change}, over the lr bound")
    if tree_times and not all(rec["adamw_tree"][w]["bit_equal"]
                              for w in ("plain_per_leaf", "plain_foreach")):
        fail(f"{phase}: the AdamW updates of the tree differ: {rec['adamw_tree']}")
    del base, state, gk
    torch.cuda.empty_cache()
    return rec


# --------------------------------------------------------------------------
# the simulator against the port's own step
# --------------------------------------------------------------------------

AF_KERNELS = re.compile(r"\baf_(rows|wide|usq|apply|v|vapply)_kernel\b")


def kernel_group(name: str) -> str:
    """Who wrote a kernel, by its name: K1 (forward or backward), K2, K3
    (forward or backward), the optimizers' kernels (AdamW's, Adafactor's),
    cuBLAS, other."""
    if AF_KERNELS.search(name):
        return "adafactor"
    name = name.lower()
    if "adamw_kernel" in name:
        return "adamw"
    if "flash_fwd" in name:
        return "K1"
    if "flash_bwd" in name:
        return "K1_bwd"
    if "decode_kernel" in name or "decode_tc_kernel" in name:
        return "K2"
    if "rmsnorm_kernel" in name:
        return "K3"
    if "rmsnorm_bwd" in name or "rmsnorm_dw" in name:
        return "K3_bwd"
    if any(t in name for t in ("nvjet", "gemm", "cublas", "cutlass", "xmma")):
        return "cublas"
    return "other"


def is_kernel(e) -> bool:
    """A device kernel of the profiler's averages (a range opened with
    ``record_function`` also shows on the device's timeline, spanning its
    kernels and the gaps between them: it is no kernel)."""
    return e.device_type == torch.autograd.DeviceType.CUDA and not any(
        e.key.startswith(f"{label}::") for label, _ in FAMILY_OPS.values())


def device_groups(avgs) -> dict:
    """Self device time (µs, whole window) of the profiler's kernels by who
    wrote them (``kernel_group``)."""
    out = {"K1": 0.0, "K1_bwd": 0.0, "K2": 0.0, "K3": 0.0, "K3_bwd": 0.0, "adamw": 0.0,
           "adafactor": 0.0, "cublas": 0.0, "other": 0.0}
    for e in avgs:
        if is_kernel(e):
            out[kernel_group(e.key)] += e.self_device_time_total
    return out


def top_kernels(avgs, group: str, n: int = 10) -> list:
    """The ``n`` kernels of ``group`` (``device_groups``' names) with the most
    device time in the window: [name, ms, launches]."""
    rows = [(e.key, e.self_device_time_total / 1e3, e.count) for e in avgs
            if is_kernel(e) and kernel_group(e.key) == group]
    return [list(r) for r in sorted(rows, key=lambda r: -r[1])[:n]]


# The MoE block's own work, by the aten operator that launched it (its
# kernels' device time, children included; no name here runs inside another):
# the experts' batched products, the router's choice and the dispatch's sort,
# and the gathers and scatters of dispatch and combine (which hold the cache
# rows' writes and the embedding lookup too).
MOE_OPS = {"expert_bmm": ("aten::bmm",),
           "route_sort": ("aten::topk", "aten::sort", "aten::searchsorted", "aten::softmax"),
           "scatter_gather": ("aten::index_add", "aten::index", "aten::index_put_")}


def moe_op_us(avgs, experts: int | None = None) -> dict:
    """Device µs (whole window) of the ``MOE_OPS`` groups.  ``experts`` (a
    model's expert count, 0 for one without): the profiler grouped by input
    shape, and only a ``bmm`` whose batch is the experts is an expert
    product; the others (MLA's absorbed attention, any batched product of a
    model without experts) go to ``other_bmm``."""
    out = {g: 0.0 for g in MOE_OPS}
    if experts is not None:
        out["other_bmm"] = 0.0
    for e in avgs:
        if e.device_type != torch.autograd.DeviceType.CPU:
            continue
        for g, names in MOE_OPS.items():
            if e.key in names:
                if (g == "expert_bmm" and experts is not None
                        and not (experts and e.input_shapes and e.input_shapes[0]
                                 and e.input_shapes[0][0] == experts)):
                    g = "other_bmm"
                    out.setdefault("other_bmm_shapes", []).append(
                        [e.input_shapes[:2], e.count, e.device_time_total])
                out[g] += e.device_time_total
    return out


# The RG-LRU block's own work, by the layer function that launched it: the
# recurrence (the log-depth scan in a prefill, one step in a decode, with
# their float32 gate products) and the causal conv.
GRIFFIN_OPS = {"rglru": ("rglru_scan", "rglru_step"), "conv": ("causal_conv1d",)}
XLSTM_OPS = {"mlstm": ("mlstm_chunkwise", "mlstm_step"), "slstm": ("slstm_scan",),
             "conv": ("causal_conv1d",)}
# a family's recurrent operators, put apart in a profiled step: (label, groups)
FAMILY_OPS = {"hybrid": ("griffin", GRIFFIN_OPS), "ssm": ("xlstm", XLSTM_OPS)}


@contextlib.contextmanager
def op_annotations(label: str, ops: dict):
    """While open, each ``ops`` function of ``models.layers`` runs inside a
    profiler range ``<label>::<group>``, whose device time holds its
    kernels'."""
    from repro_torch.models import layers as L
    saved = {}
    for group, names in ops.items():
        for name in names:
            saved[name] = fn = getattr(L, name)

            def wrapped(*a, _fn=fn, _label=f"{label}::{group}", **kw):
                with torch.profiler.record_function(_label):
                    return _fn(*a, **kw)
            setattr(L, name, wrapped)
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(L, name, fn)


# The most calls ``measure_step`` profiles: the calls repeat the same kernels, and reading back
# the profiler's host events of ten decode steps of a 64-layer model took seconds a phase.
PROFILED_CALLS = 3


def measure_step(fn, n: int, experts: int | None = None, annotate=None) -> dict:
    """The port's step: wall µs a call from CUDA events around ``n`` calls,
    then device-busy µs a call and its groups from the profiler over
    ``min(n, PROFILED_CALLS)`` more (and the ``MOE_OPS`` groups' share of it;
    ``experts``: the expert products told apart from the other batched
    products by their batch;
    ``annotate``: a ``FAMILY_OPS`` entry, whose groups' device µs are given
    too, ranges opened in the profiled calls only)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    wall_us = start.elapsed_time(end) * 1e3 / n
    n = min(n, PROFILED_CALLS)
    for _ in range(3):      # a profile that the tracer delivered no kernel of is taken again
        with (op_annotations(*annotate) if annotate else contextlib.nullcontext()), \
                profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                        record_shapes=experts is not None) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        avgs = prof.key_averages(group_by_input_shape=experts is not None)
        groups = {k: v / n for k, v in device_groups(avgs).items()}
        if sum(groups.values()) > 0:
            break
    else:
        raise RuntimeError("the profiler delivered no kernel of the step in three sessions")
    launches = sum(e.count for e in avgs if is_kernel(e))
    rec = {"wall_us": wall_us, "device_busy_us": sum(groups.values()), "device_us": groups,
           "device_launches": launches // n,
           "moe_op_us": {k: (v / n if isinstance(v, float) else v)
                         for k, v in moe_op_us(avgs, experts).items()},
           "top_other_kernels": [[name[:80], ms / n, count // n]
                                 for name, ms, count in top_kernels(avgs, "other", 6)]}
    if annotate:
        label, ops = annotate
        rec[f"{label}_op_us"] = {g: sum(e.device_time_total for e in avgs
                                        if e.key == f"{label}::{g}"
                                        and e.device_type == torch.autograd.DeviceType.CPU) / n
                                 for g in ops}
    return rec


def phase_simulate(train=None):
    """Simulator.run for phi4-mini-3.8b at full width and depth on h100_sxm,
    prefill (B1 S512) and decode (B8, cache 2048), and, given the train
    phase's record, train at its shape: the analytical engine, then the
    profiling engine measuring every operator on this card (a fresh profile
    DB; a backward attention node through K1's backward), then the port's own
    Model.prefill / decode_step at the same shapes (train: the train phase's
    step); prints a line for each mode (predicted against measured, by op kind
    too; train also its memory against the measured peak) and one for the
    phase."""
    from repro_torch import kernels as K
    from repro_torch.api import Cluster, DecodeWorkload, PrefillWorkload, SimSpec
    from repro_torch.configs import get_config
    from repro_torch.core import Simulator
    from repro_torch.core.backend import profiling as P
    from repro_torch.core.model_ingest import ingest_graphs
    from repro_torch.core.ir import OpNode
    from repro_torch.models import Model, zero_cache
    cfg = get_config(ARCH)
    db_path = os.path.join(HERE, "build", "simulate", "profile_db_torch.json")
    if os.path.exists(db_path):
        os.remove(db_path)
    db = P.ProfileDB(db_path)
    cluster = Cluster("h100_sxm", chips=1)
    specs = {"prefill": SimSpec(cfg, cluster=cluster,
                                workload=PrefillWorkload(global_batch=1, seq_len=512)),
             "decode": SimSpec(cfg, cluster=cluster,
                               workload=DecodeWorkload(global_batch=8, seq_len=2048))}
    if train is not None:
        specs["train"] = train_spec(cfg, seq=train["seq"], batch=train["batch"])
    analytical = Simulator("h100_sxm")
    profiling = Simulator("h100_sxm", engine="profiling", db=db, measure_on_miss=True)
    rec = {"phase": "simulate", "arch": cfg.name, "layers": cfg.num_layers,
           "launch_floor_us": P.dispatch_overhead_us()}
    reports = {}
    for mode, spec in specs.items():
        t0 = time.perf_counter()
        ana = analytical.run(spec)
        t1 = time.perf_counter()
        K.reset_launch_counts()
        prof = profiling.run(spec)
        counts = K.launch_counts()
        t2 = time.perf_counter()
        reports[mode] = (ana, prof)
        w = spec.workload
        mg = ingest_graphs(cfg, w.global_batch, 1 if mode == "decode" else w.seq_len, mode,
                           cache_len=w.cache_len or w.seq_len)
        priced = sum(n.repeat * b.repeat for b in mg.all_blocks()
                     for n in (b.joint if mode == "train" and b.joint is not None else b.fwd))
        rec[mode] = {"phase": "simulate", "mode": mode, "priced_ops": priced,
                     "analytical_us": ana.step_time_us, "profiling_us": prof.step_time_us,
                     "analytical_kind_us": ana.kind_us, "profiling_kind_us": prof.kind_us,
                     "analytical_t_fwd_us": ana.detail["t_fwd"],
                     "profiling_t_fwd_us": prof.detail["t_fwd"],
                     "analytical_s": t1 - t0, "profiling_s": t2 - t1,
                     "profiling_launches": counts}
    rec["profile_db_entries"] = len(db.data)
    if rec["prefill"]["profiling_launches"]["flash_attention"] <= 0:
        fail("the profiling engine did not launch K1 for the prefill's attention")
    if rec["decode"]["profiling_launches"]["decode_attention"] <= 0:
        fail("the profiling engine did not launch K2 for the decode's attention")
    if train is not None and min(rec["train"]["profiling_launches"]["flash_attention"],
                                 rec["train"]["profiling_launches"]["flash_attention_bwd"]) <= 0:
        fail("the profiling engine did not launch K1 forward and backward for train attention")
    # the tracer emits no norm node (as the reference's does not): K3 and
    # cuBLAS are timed on hand-built nodes at the model's shapes
    nodes = {"norm_prefill": OpNode("n", "norm", out_shape=(512, cfg.d_model), dtype="bf16"),
             "norm_decode": OpNode("n", "norm", out_shape=(8, cfg.d_model), dtype="bf16"),
             "matmul_prefill_up": OpNode("m", "matmul", dtype="bf16",
                                         attrs={"mm_dims": (512, cfg.d_ff, cfg.d_model)}),
             "matmul_decode_up": OpNode("m", "matmul", dtype="bf16",
                                        attrs={"mm_dims": (8, cfg.d_ff, cfg.d_model)})}
    K.reset_launch_counts()
    rec["synthesized_us"] = {k: P.synthesize_and_measure(n) for k, n in nodes.items()}
    rec["synthesized_launches"] = K.launch_counts()
    if rec["synthesized_launches"]["rmsnorm"] <= 0:
        fail("synthesize_and_measure did not launch K3 for norm nodes")
    # what the DB now holds must give the same reports without measuring
    replay = Simulator("h100_sxm", engine="profiling", db=db)
    for mode, spec in specs.items():
        if replay.run(spec).step_time_us != reports[mode][1].step_time_us:
            fail(f"{mode}: the filled profile DB does not reproduce the profiling report")
    db.save()
    rec["attention_entries_us"] = {k: v["us"] for k, v in db.data.items() if "|attention|" in k}

    model = Model(cfg)
    params = model.init(torch.Generator(device=model.device).manual_seed(SEED))
    rng = np.random.default_rng(SEED)
    prompt = {"tokens": rng.integers(0, cfg.vocab_size, (1, 512)).tolist()}
    cache = zero_cache(cfg, 8, 2048, model.device)
    cache["pos"].fill_(2047)            # every slot holds 2048 valid rows
    step = {"tokens": rng.integers(0, cfg.vocab_size, (8, 1)).tolist()}
    runs = {"prefill": (lambda: model.prefill(params, prompt, cache_len=512), 5),
            "decode": (lambda: model.decode_step(params, cache, step), 10)}
    for mode, (fn, n) in runs.items():
        meas = measure_step(fn, n)
        ana, prof = reports[mode]
        err = {f"{p}_vs_{m}": pred / meas[key] - 1.0
               for p, pred in (("analytical", ana.step_time_us), ("profiling", prof.step_time_us))
               for m, key in (("wall", "wall_us"), ("device_busy", "device_busy_us"))}
        # the profiling prediction by op kind beside what ran: the port's step
        # performs no transpose (cuBLAS reads the embedding transposed) and
        # prices its norms as K3 where the graph has elementwise/reduce chains
        kinds, dev = prof.kind_us, meas["device_us"]
        rest = sum(v for k, v in kinds.items() if k not in ("matmul", "attention", "transpose"))
        by_kind = {"matmul/cublas": [kinds.get("matmul", 0.0), dev["cublas"]],
                   "attention/K1+K2": [kinds.get("attention", 0.0), dev["K1"] + dev["K2"]],
                   "transpose/none": [kinds.get("transpose", 0.0), 0.0],
                   "rest/K3+other": [rest, dev["K3"] + dev["other"]]}
        rec[mode].update(measured=meas, signed_error=err, kind_vs_measured_us=by_kind)
        for v in (ana.step_time_us, prof.step_time_us, meas["wall_us"], meas["device_busy_us"]):
            if not (math.isfinite(v) and v > 0):
                fail(f"{mode}: a non-positive or non-finite step time in {rec[mode]}")
        emit(rec[mode])
    del params, cache
    torch.cuda.empty_cache()
    if train is not None:
        ana, prof = reports["train"]
        meas = {"wall_us": train["wall_ms_median"] * 1e3,
                "device_busy_us": train["device_busy_ms"] * 1e3,
                "device_us": {k: v * 1e3 for k, v in train["device_ms_by_group"].items()},
                "peak_bytes": train["peak_bytes"]}
        err = {f"{p}_vs_{m}": pred / meas[key] - 1.0
               for p, pred in (("analytical", ana.step_time_us), ("profiling", prof.step_time_us))
               for m, key in (("wall", "wall_us"), ("device_busy", "device_busy_us"))}
        kinds, dev = prof.kind_us, meas["device_us"]
        rest = sum(v for k, v in kinds.items() if k not in ("matmul", "attention", "transpose"))
        # kind_us covers the forward graphs only; the backward attention
        # node's price is its `|bwd` profile entry, one a layer
        bwd_entries = [v for k, v in rec["attention_entries_us"].items() if k.endswith("|bwd")]
        if len(bwd_entries) != 1:
            fail(f"train: expected one backward attention entry, got {rec['attention_entries_us']}")
        rec["train"]["bwd_attention_us_a_layer"] = bwd_entries[0]
        rec["train"].update(
            measured=meas, signed_error=err,
            # the step's parts as each engine priced them, beside the measured
            # optimizer update (kind_us below covers the forward graphs only)
            analytical_breakdown_us=ana.breakdown_us, profiling_breakdown_us=prof.breakdown_us,
            measured_optimizer_device_us=train["optimizer_device_ms"] * 1e3,
            kind_vs_measured_us={
                "matmul/cublas": [kinds.get("matmul", 0.0), dev["cublas"]],
                "attention/K1": [kinds.get("attention", 0.0), dev["K1"]],
                "attention_bwd/K1_bwd": [bwd_entries[0] * cfg.num_layers, dev["K1_bwd"]],
                "transpose/none": [kinds.get("transpose", 0.0), 0.0],
                "rest/K3+K3_bwd+other": [rest, dev["K3"] + dev["K3_bwd"] + dev["other"]],
                "optimizer/adamw+adafactor": [prof.breakdown_us.get("optimizer", 0.0),
                                              dev["adamw"] + dev["adafactor"]]},
            memory={"analytical_bytes": ana.memory.total, "profiling_bytes": prof.memory.total,
                    "measured_peak_bytes": train["peak_bytes"],
                    "signed_error": ana.memory.total / train["peak_bytes"] - 1.0,
                    "predicted_by_part": {k: v for k, v in dataclasses.asdict(ana.memory).items()
                                          if isinstance(v, (int, float))}})
        for v in (ana.step_time_us, prof.step_time_us):
            if not (math.isfinite(v) and v > 0):
                fail(f"train: a non-positive or non-finite predicted step time in {rec['train']}")
        emit(rec["train"])
    emit({k: v for k, v in rec.items() if k not in specs})
    return rec


# --------------------------------------------------------------------------
# the serving simulator against the port's own serve run
# --------------------------------------------------------------------------

# The serve trace's deepest context is 874-983 tokens while the first eight
# requests decode and 518-642 while the last four do, so the default floor of
# 256 prices every decode step at the 1024 bucket: K2 reads each row up to its
# valid length, not the ring cache's 2048 rows, so a floor of 2048 would price
# twice the attention bytes the card reads.
SERVE_SIM_CTX_FLOOR = 256


def phase_serve_measure():
    """The measured side of ``serve_sim``, in a process that has not profiled
    anything: a warm-up, one drained engine run of the serve trace on the host
    clock (as ``serve`` times it), then another run under the profiler for the
    device-busy time.  Prints one JSON line."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch import kernels as K
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    from repro_torch.serving import Request, ServingEngine
    t_start = time.perf_counter()
    cfg = get_config(ARCH)
    model = Model(cfg)
    params = model.init(torch.Generator(device=model.device).manual_seed(SEED))
    warm = ServingEngine(cfg, params, slots=8, cache_len=2048)
    for rid, plen in enumerate((1000, 200)):       # cuBLAS handles, kernel modules, allocator
        warm.submit(Request(rid=rid, prompt=list(range(plen)), max_new_tokens=3))
    warm.run_until_drained()
    del warm
    K.reset_launch_counts()
    reqs, steps, seconds, finite = run_engine(cfg, params, plain=False)
    counts = K.launch_counts()
    t_prof = time.perf_counter()
    # the device's activity alone: the line reads kernels only, and the host's operator
    # events of a drained run took over a minute to read back
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        p_reqs, p_steps, p_seconds, p_finite = run_engine(cfg, params, plain=False)
    avgs = prof.key_averages()
    t_prof = time.perf_counter() - t_prof
    groups = device_groups(avgs)
    busy_s = sum(groups.values()) / 1e6
    ttft = [r.ttft_s * 1e3 for r in reqs]
    toks = sum(len(r.tokens) for r in reqs)
    makespan = max(r.finished_s for r in reqs) - min(r.arrival_s for r in reqs)
    emit({"phase": "serve_measure", "requests": len(reqs), "engine_steps": steps,
          "new_tokens": toks, "seconds": seconds, "makespan_s": makespan,
          "tokens_per_s": toks / seconds, "ttft_ms_p50": float(np.percentile(ttft, 50)),
          "ttft_ms_p95": float(np.percentile(ttft, 95)), "launches": counts,
          "logits_finite": finite and p_finite,
          "tokens_32": all(len(r.tokens) == 32 for r in reqs + p_reqs),
          "process_seconds": time.perf_counter() - t_start, "profile_seconds": t_prof,
          "profiled": {"engine_steps": p_steps, "seconds": p_seconds,
                       "device_busy_s": busy_s,
                       "device_idle_share": max(0.0, 1.0 - busy_s / p_seconds),
                       "device_ms": {k: v / 1e3 for k, v in groups.items()},
                       "device_launches": sum(e.count for e in avgs
                                              if e.device_type == torch.autograd.DeviceType.CUDA)}})


def logged_oracle(sim, cfg, ctx_floor, *, transpose_free: bool = False):
    """A StepOracle that counts the steps each bucketed spec prices, so the
    trace's predicted time can be split by op kind.  With ``transpose_free``
    every step costs its price less the time its graph spends in
    ``transpose`` nodes: the one there is the reference head's ``emb_w.T``,
    which the port's own step never runs (cuBLAS reads the embedding
    transposed)."""
    from repro_torch.serving.sim import StepOracle, pow2_bucket

    class Logged(StepOracle):
        def __post_init__(self):
            super().__post_init__()
            self.used = {}

        def _report(self, mode, B, S, cache_len):
            spec = self._spec_for(mode, B, S, cache_len)
            return self.sim.cache.get("serving", (spec, self.sim.engine._state_version()),
                                      lambda: self.sim.run(spec))

        def _priced_s(self, mode, B, S, cache_len):
            price = super()._priced_s(mode, B, S, cache_len)
            if transpose_free:
                price -= self._report(mode, B, S, cache_len).kind_us.get("transpose", 0.0) / 1e6
            return price

        def _log(self, key):
            self.used[key] = self.used.get(key, 0) + 1

        def decode_step_s(self, batch, ctx):
            C = pow2_bucket(ctx, self.ctx_floor)
            self._log(("decode", pow2_bucket(batch), C, C))
            return super().decode_step_s(batch, ctx)

        def prefill_s(self, batch, seq):
            self._log(("prefill", pow2_bucket(batch), pow2_bucket(seq, self.seq_floor), 0))
            return super().prefill_s(batch, seq)

        def kind_ms(self) -> dict:
            out = {}
            for key, n in self.used.items():
                for k, v in self._report(*key).kind_us.items():
                    out[k] = out.get(k, 0.0) + n * v / 1e3
            return out

    return Logged(sim, cfg, ctx_floor=ctx_floor)


def serving_prediction(rep) -> dict:
    ttft = [r.ttft_s * 1e3 for r in rep.requests]
    return {"makespan_s": rep.makespan_s, "ttft_ms_p50": float(np.percentile(ttft, 50)),
            "ttft_ms_p95": float(np.percentile(ttft, 95)),
            "output_tokens_per_s": rep.output_tokens_per_s, "steps_by_kind": rep.steps_by_kind}


def phase_serve_sim():
    """The serving simulator predicting the serve phase's own trace: the 12
    requests of ``make_requests`` (all arriving at 0) as a trace workload,
    the engine's schedule as ``ContinuousBatching(max_batch=8, admit_cap=1)``
    (one batch-1 prefill a step into free slots, then a decode of the active
    slots), priced by the analytical engine and by the profiling engine
    measuring every bucketed step's operators on this card (a fresh profile
    DB; K1 for prefill attention, K2 for decode attention, cuBLAS for the
    products).  Measured: a fresh drained engine run of the same trace, in a
    process of its own (``serve_measure``).  Prints the measured line, a line
    of predictions and one of predicted against measured."""
    from repro_torch import kernels as K
    from repro_torch.configs import get_config
    from repro_torch.core import Simulator
    from repro_torch.core.backend import profiling as P
    from repro_torch.serving.sim import ContinuousBatching, ServingSimulator, Workload
    t_phase = time.perf_counter()
    cfg = get_config(ARCH)
    L = cfg.num_layers

    res = subprocess.run([sys.executable, os.path.abspath(__file__), "--phases", "serve_measure"],
                         capture_output=True, text=True, timeout=900)
    lines = [ln for ln in res.stdout.splitlines() if ln.startswith('{"phase": "serve_measure"')]
    if res.returncode != 0 or not lines:
        fail(f"serve_measure failed (exit {res.returncode}):\n{res.stderr[-4000:]}")
    meas = json.loads(lines[0])
    emit(meas)
    n_req, steps = meas["requests"], meas["engine_steps"]
    want = {"flash_attention": L * n_req, "decode_attention": L * steps,
            "rmsnorm": (2 * L + 1) * (n_req + steps), "flash_attention_bwd": 0, "rmsnorm_bwd": 0,
            "adamw": 0, "adafactor": 0}
    if not (meas["logits_finite"] and meas["tokens_32"]):
        fail("serve_measure: non-finite logits or a request without 32 tokens")
    if meas["launches"] != want:
        fail(f"serve_measure: launch counts {meas['launches']} differ from {want}")

    rows = [(0.0, len(r.prompt), r.max_new_tokens) for r in make_requests(cfg.vocab_size)]
    wl = Workload.from_trace(rows)
    db_path = os.path.join(HERE, "build", "serve_sim", "profile_db_torch.json")
    if os.path.exists(db_path):
        os.remove(db_path)
    db = P.ProfileDB(db_path)
    sims = {"analytical": Simulator("h100_sxm"),
            "profiling": Simulator("h100_sxm", engine="profiling", db=db, measure_on_miss=True)}
    pred = {"phase": "serve_sim", "arch": cfg.name, "layers": L, "requests": len(rows),
            "policy": "continuous(max_batch=8, admit_cap=1)", "ctx_floor": SERVE_SIM_CTX_FLOOR}
    for name, sim in sims.items():
        K.reset_launch_counts()
        t0 = time.perf_counter()
        oracle = logged_oracle(sim, cfg, SERVE_SIM_CTX_FLOOR)
        rep = ServingSimulator(sim, cfg, policy=ContinuousBatching(8, admit_cap=1),
                               oracle=oracle).run(wl)
        seconds = time.perf_counter() - t0
        launches = K.launch_counts()
        free = ServingSimulator(sim, cfg, policy=ContinuousBatching(8, admit_cap=1),
                                oracle=logged_oracle(sim, cfg, SERVE_SIM_CTX_FLOOR,
                                                     transpose_free=True)).run(wl)
        if K.launch_counts() != launches:
            fail(f"{name}: the transpose-free replay measured again")
        pred[name] = {**serving_prediction(rep), "without_transpose": serving_prediction(free),
                      "kind_ms": oracle.kind_ms(), "steps_by_bucket": {
                          "|".join(map(str, k)): n for k, n in oracle.used.items()},
                      "n_distinct_steps": oracle.n_distinct_steps,
                      "oracle_stats": rep.oracle_stats, "seconds": seconds, "launches": launches}
        if rep.n_requests != len(rows) or rep.steps_by_kind != {"prefill": n_req,
                                                                "decode": steps}:
            fail(f"{name}: predicted {rep.steps_by_kind} for {rep.n_requests} requests, "
                 f"the engine made {n_req} prefills and {steps} decode steps")
        for v in (rep.makespan_s, free.makespan_s, rep.ttft_s.p50):
            if not (math.isfinite(v) and v > 0):
                fail(f"{name}: a non-positive or non-finite prediction in {pred[name]}")
    pred["profile_db_entries"] = len(db.data)
    db.save()
    prof_launches = pred["profiling"]["launches"]
    if prof_launches["flash_attention"] <= 0:
        fail("serve_sim: the profiling engine did not launch K1 for prefill attention")
    if prof_launches["decode_attention"] <= 0:
        fail("serve_sim: the profiling engine did not launch K2 for decode attention")
    emit(pred)

    busy = meas["profiled"]["device_busy_s"]
    measured = {"makespan_s": meas["makespan_s"], "device_busy_s": busy,
                "ttft_ms_p50": meas["ttft_ms_p50"], "ttft_ms_p95": meas["ttft_ms_p95"],
                "output_tokens_per_s": meas["new_tokens"] / meas["makespan_s"],
                "tokens_per_s_as_serve": meas["tokens_per_s"], "engine_steps": steps,
                "prefills": n_req, "device_idle_share": meas["profiled"]["device_idle_share"]}
    cmp = {"phase": "serve_sim", "gpu": gpu_name_and_power(), "measured": measured}
    for name in sims:
        for label, p in ((name, pred[name]), (f"{name}_without_transpose",
                                               pred[name]["without_transpose"])):
            cmp[label] = {"makespan_s": p["makespan_s"],
                          "vs_wall": p["makespan_s"] / measured["makespan_s"] - 1.0,
                          "vs_device_busy": p["makespan_s"] / busy - 1.0,
                          "ttft_ms_p50": p["ttft_ms_p50"], "ttft_ms_p95": p["ttft_ms_p95"],
                          "output_tokens_per_s": p["output_tokens_per_s"]}
    # the profiling prediction by op kind beside the drained run's kernel groups
    kinds, dev = pred["profiling"]["kind_ms"], meas["profiled"]["device_ms"]
    rest = sum(v for k, v in kinds.items() if k not in ("matmul", "attention", "transpose"))
    cmp["profiling_kind_vs_measured_ms"] = {
        "matmul/cublas": [kinds.get("matmul", 0.0), dev["cublas"]],
        "attention/K1+K2": [kinds.get("attention", 0.0), dev["K1"] + dev["K2"]],
        "transpose/none": [kinds.get("transpose", 0.0), 0.0],
        "rest/K3+other": [rest, dev["K3"] + dev["other"]]}
    cmp["n_distinct_steps"] = pred["profiling"]["n_distinct_steps"]
    cmp["seconds"] = time.perf_counter() - t_phase
    emit(cmp)
    return pred


# --------------------------------------------------------------------------
# design-space and resilience sweeps priced on the card
# --------------------------------------------------------------------------

SWEEP_AXES = {"tp": (1, 2, 4, 8), "pp": (1, 2, 4), "batch": (8, 16, 32, 64, 128, 256)}
SWEEP_CACHE = 2048
SWEEP_INTERVALS = (10, 25, 50, 100, 200)    # checkpoint intervals of the resilience sweep
# tests/test_resilience.py's run is 400 steps of ~1.9 s; this step is ~0.2 s,
# so 4000 steps keep the run about as long against the same fault model
SWEEP_TRAIN_STEPS = 4000
BASELINE = {"tp": 8, "pp": 1, "batch": 64}   # bench_explore's engineering baseline


def fresh_db(name: str):
    from repro_torch.core.backend import profiling as P
    path = os.path.join(HERE, "build", "sweep", name)
    if os.path.exists(path):
        os.remove(path)
    return P.ProfileDB(path)


def cand_row(r) -> dict:
    p = r.cand.par
    return {"tp": p.tp, "pp": p.pp, "dp": p.dp, "batch": r.cand.global_batch,
            "batch_a_replica": r.cand.B_local(), "step_us": r.report.step_time_us,
            "tokens_s_chip": r.tps_per_chip, "tokens_s_user": r.tps_per_user,
            "memory_gb": r.report.memory.total / 1e9}


def ranking_key(res) -> list:
    return [(r.spec.json_hash(), r.report.step_time_us, r.tps_per_chip) for r in res.ranked()]


def phase_sweep():
    """The simulator's design-space search on this card (``SWEEP_AXES`` over
    phi4-mini-3.8b decode on 8 chips of ``h100_sxm``), one JSON line a part:
    (1) the serial sweep priced by the profiling engine measuring every
    operator on the card into a fresh DB (K2 for decode attention, counted),
    ranked by tokens/s per chip against bench_explore's engineering baseline;
    (2) the same sweep on a new simulator over the saved DB, which must
    measure nothing and rank alike; (3) the analytical sweep with
    ``workers=2``, whose pool must start its workers with ``spawn`` (CUDA is
    initialised here) and equal the serial one; (4) a
    ``goodput_under_failures`` sweep of the checkpoint interval for the train
    phase's shape on 64 chips, priced by the profiling engine (K1 forward and
    backward counted); (5) the port's own decode step at the per-replica
    batch of the two best tp=1, pp=1 candidates of (1), tokens/s per chip
    predicted against measured."""
    from repro_torch import kernels as K
    from repro_torch.api import (
        CheckpointSpec, Cluster, DecodeWorkload, FaultModel, ResilienceSpec, SimSpec,
        SweepSpace, sweep,
    )
    from repro_torch.api.pool import get_pool, shutdown_pools
    from repro_torch.configs import get_config
    from repro_torch.core import Simulator
    from repro_torch.models import Model, zero_cache
    t_phase = time.perf_counter()
    cfg = get_config(ARCH)
    base = SimSpec(cfg, cluster=Cluster("h100_sxm", chips=8, memory_limit=80e9),
                   workload=DecodeWorkload(seq_len=SWEEP_CACHE))
    space = SweepSpace(base, SWEEP_AXES)
    launches = {}

    # (1) the serving design space, priced on the card
    db = fresh_db("profile_db_serving.json")
    sim = Simulator("h100_sxm", engine="profiling", measure_on_miss=True, db=db)
    K.reset_launch_counts()
    t0 = time.perf_counter()
    res = sweep(space, sim=sim)
    seconds = time.perf_counter() - t0
    counts = K.launch_counts()
    measured = db.version
    db.save()
    if counts["decode_attention"] <= 0:
        fail("sweep: the profiling engine did not launch K2 for decode attention")
    if not res.evaluated:
        fail("sweep: no candidate was evaluated")
    for r in res.evaluated:
        if not (math.isfinite(r.report.step_time_us) and r.report.step_time_us > 0):
            fail(f"sweep: a non-positive or non-finite step time for {r.cand.key()}")
    by_tps = sorted(res.evaluated, key=lambda r: -r.tps_per_chip)
    baseline = next((r for r in res.evaluated
                     if (r.cand.par.tp, r.cand.par.pp, r.cand.global_batch)
                     == (BASELINE["tp"], BASELINE["pp"], BASELINE["batch"])), None)
    if baseline is None:
        fail("sweep: the engineering baseline was not evaluated")
    reasons = {}
    for r in res.pruned:
        reasons[r.reason] = reasons.get(r.reason, 0) + 1
    emit({"phase": "sweep", "part": "serving_space", "arch": cfg.name, "layers": cfg.num_layers,
          "cluster": "h100_sxm x 8, 80 GB a chip", "cache_len": SWEEP_CACHE, "axes": SWEEP_AXES,
          "points": space.size(), "enumerated": len(res.evaluated) + len(res.pruned),
          "evaluated": len(res.evaluated), "pruned": len(res.pruned), "pruned_reasons": reasons,
          "n_groups": res.n_groups, "operators_measured": measured, "seconds": seconds,
          "launches": counts, "top3_by_tokens_s_chip": [cand_row(r) for r in by_tps[:3]],
          "pareto": [cand_row(r) for r in res.pareto()],
          "baseline": cand_row(baseline), "best": cand_row(by_tps[0]),
          "predicted_gain_over_baseline": by_tps[0].tps_per_chip / baseline.tps_per_chip})
    launches["serving_space"] = counts

    # (2) the same sweep from the warm DB: nothing measured, the same ranking
    warm_db = type(db)(db.path)
    warm = Simulator("h100_sxm", engine="profiling", measure_on_miss=True, db=warm_db)
    K.reset_launch_counts()
    t0 = time.perf_counter()
    res2 = sweep(space, sim=warm)
    seconds2 = time.perf_counter() - t0
    counts2 = K.launch_counts()
    same = ranking_key(res2) == ranking_key(res) and \
        [(r.cand.key(), r.reason) for r in res2.pruned] == [(r.cand.key(), r.reason)
                                                            for r in res.pruned]
    emit({"phase": "sweep", "part": "warm_db", "db_entries": len(warm_db.data),
          "operators_measured": warm_db.version, "launches": counts2, "seconds": seconds2,
          "rankings_equal": same})
    if warm_db.version != 0 or any(counts2.values()):
        fail(f"sweep: the warm DB measured {warm_db.version} operators ({counts2})")
    if not same:
        fail("sweep: the warm DB's ranking differs from the measuring sweep's")

    # (3) the analytical sweep in a spawned pool against the serial one
    if not torch.cuda.is_initialized():
        fail("sweep: CUDA is not initialised before the pooled sweep")
    t0 = time.perf_counter()
    serial = sweep(space, engine="analytical")
    t1 = time.perf_counter()
    pooled = sweep(space, engine="analytical", workers=2)
    t2 = time.perf_counter()
    context = get_pool(2).context_name
    fields = lambda rs: [dataclasses.asdict(r) for r in rs]
    equal = {"rankings": ranking_key(serial) == ranking_key(pooled),
             "pruned": [(r.cand.key(), r.reason) for r in serial.pruned]
             == [(r.cand.key(), r.reason) for r in pooled.pruned],
             "eval_results": fields(serial.evaluated) == fields(pooled.evaluated)}
    emit({"phase": "sweep", "part": "spawned_pool", "context": context,
          "workers": pooled.workers, "serial_seconds": t1 - t0, "pooled_seconds": t2 - t1,
          "evaluated": len(pooled.evaluated), "failed": len(pooled.failed), "equal": equal,
          "best_analytical": cand_row(max(serial.evaluated, key=lambda r: r.tps_per_chip))})
    shutdown_pools()
    if context != "spawn" or pooled.workers != 2:
        fail(f"sweep: the pool ran {pooled.workers} workers under {context!r}, not 2 under spawn")
    if not all(equal.values()) or pooled.failed:
        fail(f"sweep: the pooled sweep differs from the serial one ({equal})")

    # (4) goodput under failures: the checkpoint interval of the train shape on 64 chips
    res_spec = ResilienceSpec(total_steps=SWEEP_TRAIN_STEPS,
                              faults=FaultModel(host_mtbf_s=1200.0, seed=11),
                              ckpt=CheckpointSpec(interval_steps=10), chips_per_host=8,
                              restart_delay_s=30.0, repair_s=600.0, optimize_interval=False)
    train = train_spec(cfg, seq=TRAIN_SEQ, batch=64 * TRAIN_BATCH)
    train = dataclasses.replace(
        train, cluster=Cluster("h100_sxm", chips=64),
        workload=dataclasses.replace(train.workload, resilience=res_spec))
    rspace = SweepSpace(train, {"workload.resilience.ckpt.interval_steps": SWEEP_INTERVALS})
    tdb = fresh_db("profile_db_train.json")
    tsim = Simulator("h100_sxm", engine="profiling", measure_on_miss=True, db=tdb)
    K.reset_launch_counts()
    t0 = time.perf_counter()
    rres = sweep(rspace, sim=tsim, objective="goodput_under_failures")
    seconds4 = time.perf_counter() - t0
    counts4 = K.launch_counts()
    tdb.save()
    if min(counts4["flash_attention"], counts4["flash_attention_bwd"]) <= 0:
        fail(f"sweep: the train pricing launched K1 forward and backward {counts4}")
    rows = []
    for r in sorted(rres.evaluated, key=lambda r: r.spec.workload.resilience.ckpt.interval_steps):
        rep = r.resilience
        parts = rep.useful_s + rep.rework_s + rep.straggler_s + rep.checkpoint_s + rep.downtime_s
        if not (rep.completed and 0 < rep.goodput <= 1 and abs(parts / rep.wall_s - 1) < 1e-9):
            fail(f"sweep: a resilience report that does not add up: {rep.summary()}")
        rows.append({"interval_steps": rep.interval_steps, "goodput": rep.goodput,
                     "tokens_per_s": rep.tokens_per_s, "wall_s": rep.wall_s,
                     "failures": rep.n_failures, "restarts": rep.n_restarts,
                     "checkpoints": rep.n_checkpoints, "checkpoint_s": rep.checkpoint_s,
                     "rework_s": rep.rework_s, "downtime_s": rep.downtime_s})
    first = rres.evaluated[0].resilience
    emit({"phase": "sweep", "part": "resilience", "cluster": "h100_sxm x 64 (dp 64), 8 a host",
          "step": "B1 S2048 a replica, AdamW, remat block",
          "step_us": first.step_report.step_time_us, "save_s": first.save_s,
          "restore_s": first.restore_s, "mtbf_system_s": first.mtbf_system_s,
          "young_daly_interval_steps": first.young_daly_interval_steps,
          "best_interval_steps": rres.ranked()[0].resilience.interval_steps,
          "operators_measured": tdb.version, "launches": counts4, "seconds": seconds4,
          "intervals": rows})
    launches["resilience"] = counts4

    # (5) the two best tp=1, pp=1 candidates against the port's own decode step
    ones = sorted((r for r in res.evaluated if r.cand.par.tp == 1 and r.cand.par.pp == 1),
                  key=lambda r: -r.tps_per_chip)[:2]
    if len(ones) < 2:
        fail("sweep: fewer than two tp=1, pp=1 candidates fit")
    model = Model(cfg)
    params = model.init(torch.Generator(device=model.device).manual_seed(SEED))
    rng = np.random.default_rng(SEED)
    out = []
    for r in ones:
        B = r.cand.B_local()
        cache = zero_cache(cfg, B, SWEEP_CACHE, model.device)
        cache["pos"].fill_(SWEEP_CACHE - 1)
        step = {"tokens": rng.integers(0, cfg.vocab_size, (B, 1)).tolist()}
        meas = measure_step(lambda: model.decode_step(params, cache, step), 10)
        busy_tps, wall_tps = B / (meas["device_busy_us"] / 1e6), B / (meas["wall_us"] / 1e6)
        # the port's step runs no transpose (cuBLAS reads the embedding
        # transposed); the reference head's transpose, priced in, taken out
        free_us = r.report.step_time_us - r.report.kind_us.get("transpose", 0.0)
        free_tps = B / (free_us / 1e6)
        out.append({**cand_row(r), "step_us_without_transpose": free_us,
                    "tokens_s_chip_without_transpose": free_tps,
                    "signed_error_without_transpose_vs_busy": free_tps / busy_tps - 1.0,
                    "measured_busy_us": meas["device_busy_us"],
                    "measured_wall_us": meas["wall_us"], "measured_tokens_s_chip_busy": busy_tps,
                    "measured_tokens_s_chip_wall": wall_tps,
                    "signed_error_vs_busy": r.tps_per_chip / busy_tps - 1.0,
                    "signed_error_vs_wall": r.tps_per_chip / wall_tps - 1.0,
                    "device_us": meas["device_us"]})
        del cache
    del params
    torch.cuda.empty_cache()
    emit({"phase": "sweep", "part": "predicted_vs_measured", "gpu": gpu_name_and_power(),
          "candidates": out,
          "same_order_busy": out[0]["measured_tokens_s_chip_busy"]
          >= out[1]["measured_tokens_s_chip_busy"],
          "same_order_wall": out[0]["measured_tokens_s_chip_wall"]
          >= out[1]["measured_tokens_s_chip_wall"],
          "phase_seconds": time.perf_counter() - t_phase})
    return {"launches": {name: sum(c.get(name, 0) for c in launches.values())
                         for name in KERNEL_INFO}}


# --------------------------------------------------------------------------
# the MoE family: olmoe-1b-7b served, held against the plain versions,
# simulated and trained in parity on the card
# --------------------------------------------------------------------------

MOE_ARCH = "olmoe-1b-7b"
ATTENTION_KINDS = ("attn_ffn", "moe_attn_ffn", "mla_moe", "griffin_attn")


def attention_calls(cfg) -> int:
    """K1 calls of one full-sequence forward: one an attention layer, two a
    Whisper decoder layer (self and cross attention), one an encoder layer."""
    from repro_torch.models.params import layer_kinds
    kinds = layer_kinds(cfg)
    return (sum(kind in ATTENTION_KINDS for kind in kinds) + 2 * kinds.count("xattn")
            + cfg.encoder_layers)


def moe_serve(cfg, params=None, phase: str = "moe") -> dict:
    """A model of a family with its own phase (olmoe at full width and depth,
    or ``params`` of ``cfg`` made by the caller): ServingEngine(slots=8,
    cache_len=2048) on serve's 12 requests, launches against the path's
    formula, then one decode step at 8 live slots under the profiler and the
    host syncs of one ``decode_step`` (``torch.cuda.set_sync_debug_mode``).
    The formula: K1 an attention layer a prefill; K2 an attention layer a
    decode step (none for MLA, whose absorbed decode is plain products); K3
    2L+1 a call (4L+1 for MLA: its q_norm and kv_norm too).  An RG-LRU
    layer (``griffin_rec``) has no attention and its two norms; so has an
    xLSTM layer (``mlstm``: ``ln`` and ``out_norm``; ``slstm``: the same)."""
    import warnings
    from repro_torch import kernels as K
    from repro_torch.models import Model, count_params
    from repro_torch.models.params import layer_kinds
    from repro_torch.serving import Request, ServingEngine
    init_s = None
    if params is None:
        model = Model(cfg)
        t0 = time.perf_counter()
        params = model.init(torch.Generator(device=model.device).manual_seed(SEED))
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
    allocated = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    reqs, steps, seconds, finite = run_engine(cfg, params, plain=False)
    counts = K.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    L = cfg.num_layers
    La = sum(kind in ATTENTION_KINDS for kind in layer_kinds(cfg))   # attention layers
    mla = cfg.attention == "mla"
    want = {"flash_attention": La * len(reqs), "decode_attention": 0 if mla else La * steps,
            "rmsnorm": ((4 if mla else 2) * L + 1) * (len(reqs) + steps),
            "flash_attention_bwd": 0, "rmsnorm_bwd": 0, "adamw": 0, "adafactor": 0}
    toks = sum(len(r.tokens) for r in reqs)
    ttft = [r.ttft_s * 1e3 for r in reqs]
    # a steady decode step: 8 live slots of 512-token prompts
    engine = ServingEngine(cfg, params, slots=8, cache_len=2048)
    rng = np.random.default_rng(SEED)
    for rid in range(8):
        engine.submit(Request(rid=rid, prompt=rng.integers(0, cfg.vocab_size, 512).tolist(),
                              max_new_tokens=64))
    for _ in range(3):
        engine.step()
    step = measure_step(engine.step, 3, experts=cfg.num_experts,
                        annotate=FAMILY_OPS.get(cfg.family))
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            engine.model.decode_step(params, engine.cache, {"tokens": engine._last_tok})
        finally:
            torch.cuda.set_sync_debug_mode("default")
    # the mode's own notice ("a prototype feature ...") is not a sync
    syncs = [str(w.message)[:160] for w in caught
             if "called a synchronizing" in str(w.message)]
    rec = {"part": "serve", "arch": cfg.name, "layers": L, "attention_layers": La,
           "d_model": cfg.d_model,
           "experts": cfg.num_experts, "top_k": cfg.top_k, "params": count_params(cfg),
           "active_params": count_params(cfg, active_only=True), "slots": 8, "cache_len": 2048,
           "requests": len(reqs), "prompt_tokens": sum(len(r.prompt) for r in reqs),
           "new_tokens": toks, "engine_steps": steps, "seconds": seconds,
           "tokens_per_s": toks / seconds, "ttft_ms_p50": float(np.percentile(ttft, 50)),
           "ttft_ms_p95": float(np.percentile(ttft, 95)), "init_seconds": init_s,
           "logits_finite": finite, "launches": counts, "launches_expected": want,
           "allocated_after_init_bytes": allocated, "peak_bytes": peak, "decode_step": step,
           "decode_step_host_syncs": syncs}
    if cfg.family == "ssm":
        # prompts the reference's padded-chunk fault touches (ROADMAP queue C):
        # longer than a chunk and no multiple of it, their prefill hands the
        # decode a wiped mLSTM state, in both packages
        rec["padded_chunk_prompts"] = sum(len(r.prompt) > cfg.chunk_size
                                          and len(r.prompt) % cfg.chunk_size != 0 for r in reqs)
    emit({"phase": phase, **rec})
    if any(len(r.tokens) != 32 or r.finished_s is None for r in reqs):
        fail(f"{phase} serve: a request did not finish with 32 tokens: {rec}")
    if any(not (0 <= t < cfg.vocab_size) for r in reqs for t in r.tokens):
        fail(f"{phase} serve: a token outside the vocabulary")
    if not finite:
        fail(f"{phase} serve: non-finite logits on the serving path")
    if counts != want:
        fail(f"{phase} serve: launch counts {counts} differ from what the path implies {want}")
    if syncs:
        fail(f"{phase} serve: a decode step synchronised with the host: {syncs}")
    del params, engine
    torch.cuda.empty_cache()
    return rec


def moe_parity(cfg, params=None) -> dict:
    """olmoe cut to 4 layers (or ``params`` of ``cfg`` made by the caller,
    already cut), serve's requests prefilled through the kernels
    and through their plain versions, the experts each dispatch chose
    recorded (``RoutePin``).  Unpinned, the plain run routes on its own: the
    share of (token, k) choices alike layer by layer, and for each request
    the first-token logit difference, the layer of its first flip and the
    plain run's router margins there (the gap between the k-th and the next
    expert's probability) of the tokens that flipped.  A flipped route
    is a real difference in the answer, so the bound is not held there: the
    plain run is made again on the kernel run's routes, and the 1e-1 bound
    and the first-token rule (equal, or a near-tie of the two best logits)
    hold on those, for every request."""
    from repro_torch.models import Model
    if params is None:
        cfg = cfg.replace(num_layers=4)
        params = Model(cfg).init(torch.Generator(device="cuda").manual_seed(SEED))
    L = cfg.num_layers
    reqs = make_requests(cfg.vocab_size)
    pin = RoutePin()
    first, routes, margins = {}, {}, []
    for way, plain, mode in (("kernels", False, "record"), ("plain", True, "record"),
                             ("plain_pinned", True, "replay")):
        m = Model(cfg, plain_kernels=plain)
        logits, calls = [], []
        for i, r in enumerate(reqs):
            if mode == "replay":
                pin.calls = routes["kernels"][i]
            lg, _ = pin.run(mode, m.prefill, params, {"tokens": [r.prompt]}, 2048)
            if mode == "replay" and pin.next != len(pin.calls):
                fail(f"{cfg.name} parity: request {r.rid} replayed {pin.next} of "
                     f"{len(pin.calls)} routes")
            if way == "plain":
                margins.append(pin.margins)
            logits.append(lg[0, -1])
            calls.append(pin.calls)
        first[way], routes[way] = torch.stack(logits), calls
    diff = {w: (first["kernels"] - first[w]).abs().amax(dim=-1) for w in ("plain", "plain_pinned")}
    top2 = first["plain_pinned"].topk(2, dim=-1).values
    margin = top2[:, 0] - top2[:, 1]
    tol = 1e-1
    by_layer = [[0.0, 0] for _ in range(L)]
    per_req, flips, same_first, near_tie = [], 0, 0, 0
    for i, r in enumerate(reqs):
        shares = route_agreement(routes["kernels"][i], routes["plain"][i])
        for j, sh in enumerate(shares):
            n = routes["kernels"][i][j].numel()
            by_layer[j][0] += sh * n
            by_layer[j][1] += n
        flipped = [j for j, sh in enumerate(shares) if sh < 1.0]
        entry = {"rid": r.rid, "prompt": len(r.prompt),
                 "first_logits_max_abs_diff_unpinned": float(diff["plain"][i]),
                 "first_logits_max_abs_diff_pinned": float(diff["plain_pinned"][i]),
                 "routes_agree": not flipped}
        if flipped:
            flips += 1
            j = flipped[0]
            a, b = routes["kernels"][i][j], routes["plain"][i][j]
            tok = (~(a.sort(-1).values == b.sort(-1).values).all(-1)).nonzero()[:, 0]
            at_flip = margins[i][j][tok]
            entry.update(first_flip_layer=j, tokens_flipped_there=int(tok.numel()),
                         choices=int(a.numel()),
                         router_margin_at_flip_min=float(at_flip.min()),
                         router_margin_at_flip_max=float(at_flip.max()),
                         router_margin_median_at_that_layer=float(margins[i][j].median()))
        per_req.append(entry)
        a, b = int(first["kernels"][i].argmax()), int(first["plain_pinned"][i].argmax())
        same_first += a == b
        near_tie += a != b and float(margin[i]) <= 2 * float(diff["plain_pinned"][i])
    rec = {"part": "parity", "arch": cfg.name, "layers": L, "requests": len(reqs),
           "route_agreement_by_layer": [s_ / max(n, 1) for s_, n in by_layer],
           "requests_with_a_flipped_route": flips, "tol": tol,
           "first_logits_max_abs_diff_pinned": float(diff["plain_pinned"].max()),
           "first_logits_max_abs_diff_unpinned": float(diff["plain"].max()),
           "first_logits_max_abs_diff_unpinned_routes_agree":
               max((e["first_logits_max_abs_diff_unpinned"] for e in per_req
                    if e["routes_agree"]), default=None),
           "first_token_equal_pinned": same_first, "first_token_near_tie_pinned": near_tie,
           "first_token_equal_unpinned": int((first["kernels"].argmax(-1)
                                              == first["plain"].argmax(-1)).sum()),
           "per_request": per_req}
    del params
    torch.cuda.empty_cache()
    return rec, same_first + near_tie


def moe_simulate(cfg, params=None, name: str = "moe",
                 attention_kernels=(("prefill", "flash_attention"), ("decode", "decode_attention")),
                 prefill_calls: int = 5, prefill_seq: int = 512, decode_cache: int = 2048,
                 extra=None) -> dict:
    """Simulator.run for olmoe (or ``cfg``, whose ``params`` the caller made)
    on h100_sxm, prefill B1 S``prefill_seq`` and decode B8 at cache
    ``decode_cache``, analytical and profiling (a fresh DB under
    ``build/<name>``; each mode's attention kernel of ``attention_kernels``
    counted), then the port's own Model.prefill / decode_step at those shapes
    (``extra``: more of the prefill's one request, an encoder-decoder's frame
    embeddings or a VLM's (t, h, w) positions and patch embeddings); the
    signed errors, also by op kind: the
    experts' products (the matmul nodes tagged ``moe_expert``) against the
    device time of the ``aten::bmm`` calls over the experts, the other
    products against the rest of cuBLAS, attention against K1 + K2, and the
    rest."""
    from repro_torch import kernels as K
    from repro_torch.api import Cluster, DecodeWorkload, PrefillWorkload, SimSpec
    from repro_torch.core import Simulator
    from repro_torch.core.backend import profiling as P
    from repro_torch.core.model_ingest import ingest_graphs
    from repro_torch.models import Model, zero_cache
    db_path = os.path.join(HERE, "build", name, "profile_db_torch.json")
    if os.path.exists(db_path):
        os.remove(db_path)
    db = P.ProfileDB(db_path)
    cluster = Cluster("h100_sxm", chips=1)
    specs = {"prefill": SimSpec(cfg, cluster=cluster,
                                workload=PrefillWorkload(global_batch=1, seq_len=prefill_seq)),
             "decode": SimSpec(cfg, cluster=cluster,
                               workload=DecodeWorkload(global_batch=8, seq_len=decode_cache))}
    sims = {"analytical": Simulator("h100_sxm"),
            "profiling": Simulator("h100_sxm", engine="profiling", db=db, measure_on_miss=True)}
    out = {}
    for mode, spec in specs.items():
        r = {"part": "simulate", "mode": mode}
        reports = {}
        for eng, sim in sims.items():
            K.reset_launch_counts()
            t0 = time.perf_counter()
            reports[eng] = sim.run(spec)
            r[f"{eng}_s"] = time.perf_counter() - t0
            r[f"{eng}_launches"] = K.launch_counts()
        w = spec.workload
        mg = ingest_graphs(cfg, w.global_batch, 1 if mode == "decode" else w.seq_len, mode,
                           cache_len=w.cache_len or w.seq_len)
        # each engine's price of the experts' products and of the other products
        # (one layer's graph times its repeat), and who priced each operator
        priced, by_engine = {}, {}
        for eng, sim in sims.items():
            expert = other = 0.0
            for b in mg.all_blocks():
                for n in b.fwd:
                    us = sim.engine.latency_us(n)
                    if us is None or not math.isfinite(us):
                        fail(f"{cfg.name} simulate {mode}: {eng} left {n.kind} {n.out_shape} "
                             "unpriced")
                    if eng == "profiling":
                        e = sim.engine.engine_for(n)
                        by_engine[e] = by_engine.get(e, 0) + 1
                    if n.kind == "matmul":
                        if n.attrs.get("moe_expert"):
                            expert += us * n.repeat * b.repeat
                        else:
                            other += us * n.repeat * b.repeat
            priced[eng] = {"expert_matmul_us": expert, "other_matmul_us": other}
        r.update({f"{eng}_us": rep.step_time_us for eng, rep in reports.items()})
        r.update({f"{eng}_kind_us": rep.kind_us for eng, rep in reports.items()})
        r["priced_matmul_us"] = priced
        r["operators_by_engine"] = by_engine
        out[mode] = (r, reports, priced)
    for mode, kernel in attention_kernels:
        if out[mode][0]["profiling_launches"][kernel] <= 0:
            fail(f"{cfg.name} simulate: the profiling engine did not launch {kernel} for the "
                 f"{mode}'s attention")
    db.save()

    model = Model(cfg)
    if params is None:
        params = model.init(torch.Generator(device=model.device).manual_seed(SEED))
    rng = np.random.default_rng(SEED)
    prompt = {"tokens": rng.integers(0, cfg.vocab_size, (1, prefill_seq)).tolist(),
              **(extra or {})}
    cache = zero_cache(cfg, 8, decode_cache, model.device)
    cache["pos"].fill_(decode_cache - 1)      # every slot holds a full ring of valid rows
    step = {"tokens": rng.integers(0, cfg.vocab_size, (8, 1)).tolist()}
    runs = {"prefill": (lambda: model.prefill(params, prompt, cache_len=prefill_seq),
                        prefill_calls),
            "decode": (lambda: model.decode_step(params, cache, step), 10)}
    recs = []
    for mode, (fn, n) in runs.items():
        r, reports, priced = out[mode]
        meas = measure_step(fn, n, experts=cfg.num_experts, annotate=FAMILY_OPS.get(cfg.family))
        err = {f"{p}_vs_{m}": rep.step_time_us / meas[key] - 1.0
               for p, rep in reports.items()
               for m, key in (("wall", "wall_us"), ("device_busy", "device_busy_us"))}
        dev, ops = meas["device_us"], meas["moe_op_us"]
        by_kind = {}
        for p, rep in reports.items():
            kinds = rep.kind_us
            rest = sum(v for k, v in kinds.items() if k not in ("matmul", "attention"))
            by_kind[p] = {
                "matmul_moe_expert/aten_bmm": [priced[p]["expert_matmul_us"], ops["expert_bmm"]],
                "matmul_other/cublas_rest": [priced[p]["other_matmul_us"],
                                             dev["cublas"] - ops["expert_bmm"]],
                "attention/K1+K2": [kinds.get("attention", 0.0), dev["K1"] + dev["K2"]],
                "rest/K3+other": [rest, dev["K3"] + dev["other"]]}
            for k, (pred, got) in by_kind[p].items():
                by_kind[p][k].append(pred / got - 1.0 if got > 0 else None)
        r.update(measured=meas, signed_error=err, kind_vs_measured_us=by_kind,
                 device_idle_share=max(0.0, 1.0 - meas["device_busy_us"] / meas["wall_us"]))
        for v in [rep.step_time_us for rep in reports.values()] + [meas["wall_us"],
                                                                    meas["device_busy_us"]]:
            if not (math.isfinite(v) and v > 0):
                fail(f"{cfg.name} simulate {mode}: a non-positive or non-finite step time in {r}")
        if not all(math.isfinite(x) for x in err.values()):
            fail(f"{cfg.name} simulate {mode}: a non-finite error {err}")
        recs.append(r)
    del params, cache
    torch.cuda.empty_cache()
    return {"prefill": recs[0], "decode": recs[1], "profile_db_entries": len(db.data)}


def phase_moe() -> dict:
    """The MoE family on the card, a line a part: serve, parity, simulate,
    train_parity (see ``moe_serve``, ``moe_parity``, ``moe_simulate`` and
    ``phase_train_parity``); returns the launches of each part."""
    from repro_torch import kernels as K
    from repro_torch.configs import get_config
    cfg = get_config(MOE_ARCH)
    t0 = time.perf_counter()
    serve = moe_serve(cfg)
    parity, ok_first = moe_parity(cfg)
    emit({"phase": "moe", **parity})
    sim = moe_simulate(cfg)
    for mode in ("prefill", "decode"):
        emit({"phase": "moe", **sim[mode]})
    K.reset_launch_counts()
    tp = phase_train_parity(MOE_ARCH, phase="moe_train_parity", tree_times=False)
    tp_launches = K.launch_counts()
    emit({"phase": "moe", "part": "done", "seconds": time.perf_counter() - t0,
          "profile_db_entries": sim["profile_db_entries"],
          "train_parity_launches": tp_launches, "gpu": gpu_name_and_power()})
    # the parity part's checks, after every part has printed its line
    if not parity["first_logits_max_abs_diff_pinned"] <= parity["tol"]:
        fail(f"moe parity: first-token logits differ by "
             f"{parity['first_logits_max_abs_diff_pinned']} > {parity['tol']} on the same routes")
    if ok_first != parity["requests"]:
        fail("moe parity: a first token differs between kernels and plain versions beyond a "
             "near-tie, on the same routes")
    if min(tp_launches["flash_attention_bwd"], tp_launches["rmsnorm_bwd"]) <= 0:
        fail(f"moe train_parity: K1's or K3's backward was not launched: {tp_launches}")
    return {"serve": serve["launches"],
            "simulate": {k: sim["prefill"]["profiling_launches"][k]
                         + sim["decode"]["profiling_launches"][k] for k in tp_launches},
            "train_parity": tp_launches, "serve_rec": serve, "train_parity_rec": tp}


GRIFFIN_ARCH = "recurrentgemma-9b"
GRIFFIN_PARITY_LAYERS = 6       # two whole (rec, rec, attn) cycles


def griffin_draw(params, gen) -> None:
    """The RG-LRU blocks' conv filters, which the reference's init leaves 0
    (the recurrence would then carry nothing), drawn in place from ``gen``:
    normal, std 1/sqrt(conv_width)."""
    with torch.no_grad():
        for p in params["blocks"]:
            if "conv" in p:
                w = p["conv"]["w"]
                w.copy_(torch.randn(w.shape, generator=gen, device=w.device)
                        / math.sqrt(w.shape[0]))


def phase_griffin(keep: bool = False) -> dict:
    """The RG-LRU family on the card (recurrentgemma-9b at full width and
    depth: 38 layers, 26 ``griffin_rec`` and 12 ``griffin_attn`` with MQA
    over 16 heads at D 256 and a window of 2048), random bf16 weights from
    the seed, made once and shared by the parts, a line a part: serve
    (``moe_serve``: K1 a local-attention layer a prefill, K2 one a decode
    step, K3 2L+1 a call; the profiled step with the recurrence's and the
    conv's kernels apart), parity (``phase_parity`` on the first
    ``GRIFFIN_PARITY_LAYERS`` layers) and simulate (``moe_simulate``: K1 and
    K2 counted in the profiling engine's prefill and decode).  The
    reference's init leaves the conv filters 0, so the recurrence would
    carry nothing; here they are drawn from the seed too (normal, std
    1/sqrt(conv_width)).  Returns the launches of each part (and, with
    ``keep``, the parameters under ``params``, for the dryrun phase)."""
    import gc
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    gc.collect()
    torch.cuda.empty_cache()
    cfg = get_config(GRIFFIN_ARCH)
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    model = Model(cfg)
    gen = torch.Generator(device=model.device).manual_seed(SEED)
    params = model.init(gen)
    griffin_draw(params, gen)
    torch.cuda.synchronize()
    init = {"seconds": time.perf_counter() - t0, "allocated_bytes": torch.cuda.memory_allocated(),
            "peak_bytes": torch.cuda.max_memory_allocated()}
    serve = moe_serve(cfg, params, phase="griffin")
    cut = cfg.replace(num_layers=GRIFFIN_PARITY_LAYERS)
    parity = phase_parity(cut, {**params, "blocks": params["blocks"][:GRIFFIN_PARITY_LAYERS]},
                          phase="griffin")
    sim = moe_simulate(cfg, params, name="griffin")
    for mode in ("prefill", "decode"):
        emit({"phase": "griffin", **sim[mode]})
    emit({"phase": "griffin", "part": "done", "arch": cfg.name,
          "seconds": time.perf_counter() - t0, "init": init, "parity_layers": parity["layers"],
          "profile_db_entries": sim["profile_db_entries"], "gpu": gpu_name_and_power()})
    out = {"serve": serve["launches"],
           "simulate": {k: sim["prefill"]["profiling_launches"][k]
                        + sim["decode"]["profiling_launches"][k] for k in serve["launches"]},
           "serve_rec": serve}
    if keep:
        out["params"] = params
    del params, model
    gc.collect()
    torch.cuda.empty_cache()
    return out


# the dryrun phase's cell on one card (the full-size traces of the launcher's
# meshes are host work: `python -m repro_torch.launch.dryrun --arch A --shape S`)
DRYRUN_CELL = ("recurrentgemma-9b", "long_500k")
DRYRUN_STEPS = 20


def dryrun_row(rec: dict) -> dict:
    """What a trace line prints of a dry-run record, with its roofline row."""
    from repro_torch.launch.roofline import cell_terms
    if rec.get("status") != "ok":
        fail(f"dryrun: {rec.get('arch')} {rec.get('shape')}: {rec.get('status')} "
             f"{rec.get('error', '')}")
    terms = cell_terms(rec)
    coll = rec["collectives"]
    row = {"arch": rec["arch"], "shape": rec["shape"], "mesh": rec["mesh"],
           "n_devices": rec["n_devices"], "flops_per_device": rec["flops_per_device"],
           "hbm_bytes_per_device": rec["hbm_bytes_per_device"],
           "collective_traffic_bytes": coll["traffic_bytes"],
           "collectives_by_kind": {k: {"count": v["count"], "traffic_bytes": v["traffic_bytes"]}
                                   for k, v in coll["by_kind"].items()},
           "while_loops": len(rec["while_loops"]),
           "memory_analysis": rec["memory_analysis"], "trace_s": rec["lower_s"],
           "graph_nodes": rec["graph_nodes"], "roofline": terms,
           "bound_s": max(terms["compute_s"], terms["memory_s"], terms["collective_s"])}
    if not (rec["flops_per_device"] > 0 and rec["hbm_bytes_per_device"] > 0
            and rec["memory_analysis"]["temp_bytes"] > 0):
        fail(f"dryrun: an empty record {row}")
    return row


def dryrun_cache(cfg, gen):
    """recurrentgemma-9b's long_500k cache on the card: B1, every local
    attention ring's 2048 rows filled (normal, bf16) and valid, the RG-LRU
    states and conv inputs drawn, ``pos`` 524,287 (the reference's cell: a
    ring of min(S, window) rows)."""
    from repro_torch.models.kvcache import zero_cache
    S = 524_288
    cache = zero_cache(cfg, 1, S, "cuda")
    for layer in cache["blocks"]:
        for t in layer.values():
            t.copy_(torch.randn(t.shape, generator=gen, device="cuda").to(t.dtype))
    cache["pos"].fill_(S - 1)
    return cache


@contextlib.contextmanager
def k2_plain_one_split_short():
    """While open, the plain version of K2 that the model calls leaves out
    the last 16 valid rows of each sequence: what a K2 whose combine lost
    one split of 16 rows computes (the dryrun cell's plan now has 16 splits
    of 128 rows, so losing a whole one moves the output further)."""
    from repro_torch.models import layers as L
    orig = L.decode_attention_plain

    def short(q, k, v, *, kv_valid_len=None, scale=None):
        if kv_valid_len is None:
            kv_valid_len = torch.full((q.shape[0],), k.shape[2], dtype=torch.int32,
                                      device=q.device)
        return orig(q, k, v, kv_valid_len=(kv_valid_len - 16).clamp_min(0), scale=scale)

    L.decode_attention_plain = short
    try:
        yield
    finally:
        L.decode_attention_plain = orig


DRYRUN_F32_LOGITS_TOL = 1e-3


def dryrun_float32_logits(cfg, params, snapshot, pos, batch) -> dict:
    """The dryrun cell's step in float32 (the bf16 weights and the cache's
    snapshot widened; K2's and K3's float32 builds): its logits through the
    kernels against the plain versions' (``DRYRUN_F32_LOGITS_TOL``), and
    what a K2 one split short moves the plain versions' by, which must lie
    above that tolerance.  In bfloat16 the logits (about 12 here, an ulp
    of 0.0625) round the two apart as far as that K2 moves them."""
    import gc
    from repro_torch.models import Model
    from repro_torch.models.kvcache import zero_cache
    from repro_torch.training.optimizer import tree_map
    c32 = cfg.replace(dtype="float32", param_dtype="float32")
    p32 = tree_map(lambda t: t.float(), params)
    cache = zero_cache(c32, 1, 524_288, "cuda")
    cache["pos"].copy_(pos)

    def run(plain: bool):
        for layer, saved in zip(cache["blocks"], snapshot):
            for t, s_ in zip(layer.values(), saved):
                t.copy_(s_)
        return Model(c32, plain_kernels=plain).decode_step(p32, cache, batch)[0]
    kern, plain = run(False), run(True)
    with k2_plain_one_split_short():
        short = run(True)
    out = {"logits_max_abs_diff_plain": max_err(kern, plain),
           "logits_max_abs_diff_one_split_short": max_err(short, plain),
           "tol": DRYRUN_F32_LOGITS_TOL, "first_token_equal": bool(
               torch.equal(kern.reshape(-1, kern.shape[-1]).argmax(-1),
                           plain.reshape(-1, plain.shape[-1]).argmax(-1)))}
    del p32, cache
    gc.collect()
    torch.cuda.empty_cache()
    return out


def dryrun_k2_calls(step, restore) -> dict:
    """K2 held against its plain version at the dryrun cell's own inputs:
    one step from the snapshot with each K2 call's inputs and output kept,
    then the plain version on each.  Beside it, what a K2 that dropped 16
    rows (an eighth of one of the plan's 16 splits of 128) would be off by:
    the plain version told 16 valid rows fewer.  The kernel's error must lie
    under the kernel tolerance and under a quarter of the least of those."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.decode_attention import decode_attention_plain
    calls = []
    orig = ops.decode_attention_bthd

    def keep(q, k, v, kv_valid_len=None, *, scale=None):
        o = orig(q, k, v, kv_valid_len, scale=scale)
        vl = kv_valid_len if kv_valid_len is not None else \
            torch.full((q.shape[0],), k.shape[1], dtype=torch.int32, device=q.device)
        calls.append((q.clone(), k.clone(), v.clone(), vl.clone(), scale, o.clone()))
        return o

    restore()
    ops.decode_attention_bthd = keep
    try:
        step()
    finally:
        ops.decode_attention_bthd = orig
    errs, short = [], []
    for q, k, v, vl, scale, o in calls:
        B, _, Hkv, G, D = q.shape

        def plain(valid):
            return decode_attention_plain(q.reshape(B, Hkv * G, D), k.permute(0, 2, 1, 3),
                                          v.permute(0, 2, 1, 3), kv_valid_len=valid,
                                          scale=scale).reshape(o.shape)
        want = plain(vl)
        errs.append(max_err(o, want))
        short.append(max_err(plain(vl - 16), want))
    return {"calls": len(calls), "valid": [int(c[3][0]) for c in calls][:1],
            "max_abs_err": max(errs), "one_split_short_min_err": min(short),
            "tol": TOL[torch.bfloat16]}


def dryrun_step_syncs(step) -> list:
    import warnings
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            step()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return [str(w.message)[:160] for w in caught if "called a synchronizing" in str(w.message)]


def phase_dryrun(params=None) -> dict:
    """Sharding and the dry-run launcher on the card (see the module's
    docstring), a line a part: cell_trace (recurrentgemma-9b long_500k
    traced on a (1, 1) mesh), then cell (its decode step run here, with
    ``params``: the griffin phase's weights, else random ones from the
    seed).  Returns the step's launches."""
    import gc
    import tempfile
    import torch.distributed as dist
    from repro_torch import kernels as K
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.distributed.sharding import ShardingEnv, activate
    from repro_torch.launch.dryrun import cell_record
    from repro_torch.launch.mesh import fake_world, make_mesh
    from repro_torch.models import Model
    t0 = time.perf_counter()
    gpu = gpu_name_and_power()
    arch, shape_name = DRYRUN_CELL
    cfg = get_config(arch)
    with fake_world(1):
        rec, gm = cell_record(cfg, arch, SHAPES[shape_name], make_mesh((1, 1), ("data", "model")))
        del gm
    row = dryrun_row(rec)
    emit({"phase": "dryrun", "part": "cell_trace", **row, "gpu": gpu})

    model = Model(cfg)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    if params is None:
        params = model.init(gen)
        griffin_draw(params, gen)
    # the cache and the token from a generator of their own: the same cell
    # whether the weights are the griffin phase's or made here
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    cache = dryrun_cache(cfg, gen)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (1, 1), generator=gen, device="cuda")}
    snapshot = [[t.clone() for t in layer.values()] for layer in cache["blocks"]]

    def restore():
        for layer, saved in zip(cache["blocks"], snapshot):
            for t, s in zip(layer.values(), saved):
                t.copy_(s)

    def step():
        return model.decode_step(params, cache, batch)[0]

    # the step's launches (the ring's write is idempotent, the recurrent
    # states move on: each measured run starts from the snapshot)
    restore()
    K.reset_launch_counts()
    logits = step()
    torch.cuda.synchronize()
    launches = K.launch_counts()
    from repro_torch.models.params import layer_kinds
    want = {"flash_attention": 0,
            "decode_attention": sum(k == "griffin_attn" for k in layer_kinds(cfg)),
            "rmsnorm": 2 * cfg.num_layers + 1,
            "flash_attention_bwd": 0, "rmsnorm_bwd": 0, "adamw": 0, "adafactor": 0}
    measured = measure_step(step, DRYRUN_STEPS, annotate=FAMILY_OPS.get(cfg.family))
    syncs = dryrun_step_syncs(step)

    # the same step under a sharding env over a (1, 1) mesh of a real world
    # of one rank: plain tensors, so every hook is the identity
    with tempfile.TemporaryDirectory(dir=HERE) as tmp:
        store = dist.FileStore(os.path.join(tmp, "store"), 1)
        dist.init_process_group("nccl", store=store, rank=0, world_size=1)
        try:
            restore()
            K.reset_launch_counts()
            with activate(ShardingEnv(make_mesh((1, 1), ("data", "model")))):
                logits_env = step()
            torch.cuda.synchronize()
            launches_env = K.launch_counts()
        finally:
            dist.destroy_process_group()
    restore()
    again = step()
    k2 = dryrun_k2_calls(step, restore)
    # the same step through the kernels' plain versions, from the snapshot
    restore()
    logits_plain = Model(cfg, plain_kernels=True).decode_step(params, cache, batch)[0]
    plain_diff = max_err(logits, logits_plain)
    f32 = dryrun_float32_logits(cfg, params, snapshot, cache["pos"], batch)
    rows_k, rows_p = (t.float().reshape(-1, t.shape[-1]) for t in (logits, logits_plain))
    same_first, near_tie = first_token_rule(rows_k, rows_p, (rows_k - rows_p).abs().amax(dim=-1))
    busy_s = measured["device_busy_us"] * 1e-6
    out = {"phase": "dryrun", "part": "cell", "arch": arch, "shape": shape_name,
           "batch": 1, "seq": SHAPES[shape_name].seq_len, "ring_rows": cfg.window,
           "layers": cfg.num_layers, "launches": launches, "launches_expected": want,
           "launches_under_env": launches_env,
           "logits_bit_equal_under_env": bool(torch.equal(logits, logits_env)),
           "logits_bit_equal_rerun": bool(torch.equal(logits, again)),
           "logits_finite": bool(torch.isfinite(logits).all()),
           "logits_max_abs": float(logits_plain.float().abs().max()),
           "logits_max_abs_diff_plain": plain_diff,
           "first_token_equal_plain": same_first, "first_token_near_tie_plain": near_tie,
           "k2_calls": k2, "float32": f32,
           "wall_us": measured["wall_us"], "device_busy_us": measured["device_busy_us"],
           "device_idle_share": max(0.0, 1.0 - measured["device_busy_us"] / measured["wall_us"]),
           "device_us": measured["device_us"], "device_launches": measured["device_launches"],
           "host_syncs": syncs,
           "roofline_bound_s": row["bound_s"], "roofline_terms": row["roofline"],
           "measured_roofline_fraction": row["bound_s"] / busy_s,
           "seconds": time.perf_counter() - t0, "gpu": gpu}
    emit(out)
    if launches != want:
        fail(f"dryrun cell: launches {launches} differ from what the path implies {want}")
    if launches_env != launches or not out["logits_bit_equal_under_env"]:
        fail(f"dryrun cell: the sharding env changed the step: {out}")
    if not out["logits_finite"]:
        fail(f"dryrun cell: non-finite logits: {out}")
    if same_first + near_tie != rows_k.shape[0]:
        fail("dryrun cell: the first token differs from the plain versions' step beyond a "
             "near-tie of the two best logits")
    if not f32["logits_max_abs_diff_plain"] <= f32["tol"] < f32["logits_max_abs_diff_one_split_short"]:
        fail(f"dryrun cell: float32 logits against the plain versions' step: {f32}")
    if not (k2["max_abs_err"] <= TOL[torch.bfloat16]
            and 4 * k2["max_abs_err"] < k2["one_split_short_min_err"]):
        fail(f"dryrun cell: K2 against its plain version at the cell's inputs: {k2}")
    if syncs:
        fail(f"dryrun cell: the decode step synchronised with the host: {syncs}")
    del params, cache, snapshot, model
    gc.collect()
    torch.cuda.empty_cache()
    return {"cell": launches}


def int8_step(trainer, state, batch) -> dict:
    """One more step of ``trainer``'s state through ``make_train_step`` with
    ``RunConfig.grad_compression="int8"`` (the reference's CLI has no flag
    for it): loss and grad norm finite, the step counter advancing, its wall
    time, peak memory and launches."""
    from repro_torch import kernels as K
    from repro_torch.training import make_train_step
    step = make_train_step(trainer.cfg, dataclasses.replace(trainer.run, grad_compression="int8"),
                           trainer.optimizer)
    before = int(state["step"])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    state, metrics = step(state, batch)
    loss, gn = float(metrics["loss"]), float(metrics["grad_norm"])
    torch.cuda.synchronize()
    out = {"grad_compression": "int8", "step": before, "loss": loss, "grad_norm": gn,
           "wall_ms": (time.perf_counter() - t0) * 1e3,
           "peak_bytes": torch.cuda.max_memory_allocated(), "launches": K.launch_counts(),
           "step_counter_after": int(state["step"])}
    if not (math.isfinite(loss) and math.isfinite(gn)) or out["step_counter_after"] != before + 1:
        fail(f"int8 train step: {out}")
    return out


def phase_griffin_train() -> dict:
    """recurrentgemma-9b trained on the card at full width and depth (after
    the dryrun phase has freed the griffin phase's weights), a line a part:
    train (``phase_train``: the launcher's Trainer with ``--optimizer
    adafactor``, which factors its second moments, at B1 S2048, remat
    "block"; AdamW's 12 bytes a parameter would be 113 GB; the conv filters
    drawn; then one step with int8 gradient compression through
    ``make_train_step``), train_vs_simulate (the analytical and profiling
    engines' train step against the measured one and the peak), and the
    train step on the first ``GRIFFIN_PARITY_LAYERS`` layers, kernels
    against plain versions, under Adafactor and under Adafactor with int8.
    Returns the launches a step of each part."""
    import gc
    from repro_torch.configs import get_config
    gc.collect()
    torch.cuda.empty_cache()
    cfg = get_config(GRIFFIN_ARCH)
    t0 = time.perf_counter()
    tgen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    train = phase_train(GRIFFIN_ARCH, phase="griffin_train", perturb=lambda p: griffin_draw(p, tgen),
                        optimizer="adafactor", then=int8_step)
    parts = {"train_s": time.perf_counter() - t0}
    gc.collect()
    torch.cuda.empty_cache()
    versus = train_versus(cfg, train, "griffin_train", profiling=True)
    parts["simulate_s"] = time.perf_counter() - t0 - sum(parts.values())
    parity = {}
    for compression in ("none", "int8"):
        parity[compression] = phase_train_parity(
            GRIFFIN_ARCH, phase="griffin_train_parity", tree_times=False,
            layers=GRIFFIN_PARITY_LAYERS, optimizer="adafactor", compression=compression,
            perturb=griffin_draw)
    parts["parity_s"] = time.perf_counter() - t0 - sum(parts.values())
    emit({"phase": "griffin_train", "part": "done", "arch": cfg.name,
          "seconds": time.perf_counter() - t0, "parts_s": parts,
          "launches_per_step": train["launches_per_step"],
          "int8_step_launches": train["then"]["launches"],
          "profiling_launches": versus["profiling_launches"],
          "parity_layers": GRIFFIN_PARITY_LAYERS, "gpu": gpu_name_and_power()})
    return {"train": train["launches_per_step"], "train_int8": train["then"]["launches"],
            "simulate": versus["profiling_launches"], "train_rec": train}


XLSTM_ARCH = "xlstm-125m"
# The train part's sequence: at S2048 the sLSTM's eager loop makes a step of
# 764,208 launches (17.1 s wall, 1.43 s busy on an H100 at 700 W), and the
# profiled step took about 360 s of the profiler's processing; at 512 a step
# makes about a quarter of them (two chunks of the mLSTM, 512 sLSTM steps).
XLSTM_TRAIN_SEQ = 512
# The phase's depth: one whole (m, m, m, s) cycle of the 12 layers, so that the run keeps
# its time limit beside the dense phase.  Every part is bound by the host (the sLSTM's eager
# loop, a launch a token and layer): at all 12 layers on an H100 the phase took 222 s, its
# parity 88 s, its simulate 76 s, its serve 27 s and its train step at 4 layers 31 s.
XLSTM_LAYERS = 4


def xlstm_draw(params, gen) -> None:
    """The mLSTM blocks' conv filter and bias and gate bias drawn from
    ``gen`` in place (normal; std 1/sqrt(conv_width), 0.1 and 1).  The
    reference's init leaves them 0, and then every mLSTM block adds exactly
    0 (q = k = 0)."""
    for p in params["blocks"]:
        if "gates" in p:
            for t, std in ((p["conv"]["w"], 1.0 / math.sqrt(p["conv"]["w"].shape[0])),
                           (p["conv"]["b"], 0.1), (p["gates"]["b"], 1.0)):
                t.copy_(torch.randn(t.shape, generator=gen, device=t.device) * std)


def xlstm_degenerate_products() -> dict:
    """The mLSTM chunk body's products that JAX emits as ``dot_general`` of
    elementwise work, at the train shape (B8, chunk 256, 4 heads of 192), as
    the port runs them (``torch.bmm`` over N matrices) beside the elementwise
    multiply that gives the same numbers: the all-batch (2097152, 1, 1) of
    the intra-chunk weights and the outer (8192, 1, 192) of the state's
    weights; time, device time, and whether the two agree bit for bit."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    out = {}
    for name, (a_shape, b_shape) in {"all_batch_2097152x1x1": ((2097152, 1, 1), (2097152, 1, 1)),
                                     "outer_8192x1x192": ((8192, 1, 1), (8192, 1, 192))}.items():
        a = torch.randn(a_shape, generator=gen, device="cuda")
        b = torch.randn(b_shape, generator=gen, device="cuda")
        bmm = lambda: torch.bmm(a, b)  # noqa: E731
        mul = lambda: a * b  # noqa: E731
        out[name] = {"bmm_ms": time_ms(bmm), "bmm_device_ms": device_ms(bmm),
                     "mul_ms": time_ms(mul), "mul_device_ms": device_ms(mul),
                     "bit_equal": bool(torch.equal(bmm(), mul())),
                     "bytes_bound_ms": bound(4.0 * (a.numel() + 2 * b.numel()), 0.0,
                                             torch.float32)[0]}
    return out


def first_token_logits(cfg, params, *, plain: bool) -> torch.Tensor:
    """(12, V) float32: the last position's logits of serve's 12 prompts,
    each prefilled alone, through the kernels or their plain versions."""
    from repro_torch.models import Model
    m = Model(cfg, plain_kernels=plain)
    return torch.stack([m.prefill(params, {"tokens": [r.prompt]}, cache_len=2048)[0][0, -1]
                        for r in make_requests(cfg.vocab_size)])


@contextlib.contextmanager
def float64_norms():
    """While open, the plain versions of K3 that the model calls compute in
    float64 and round once to the activation type: a third rounding of the
    same function, beside the kernel's and the plain version's (float32)."""
    from repro_torch.models import layers as L

    def norm(x, w, *, eps=1e-6, offset=False, residual=None):
        xs = (x if residual is None else x + residual).double()
        y = xs * torch.rsqrt(xs.square().mean(-1, keepdim=True) + eps)
        return (y * (w.double() + (1.0 if offset else 0.0))).to(x.dtype)

    def add_norm(x, residual, w, *, eps=1e-6, offset=False):
        s_ = x + residual
        return s_, norm(s_, w, eps=eps, offset=offset)

    saved = L.rmsnorm_plain, L.add_rmsnorm_plain
    L.rmsnorm_plain, L.add_rmsnorm_plain = norm, add_norm
    try:
        yield
    finally:
        L.rmsnorm_plain, L.add_rmsnorm_plain = saved


def first_token_rule(a, b, diff) -> tuple[int, int]:
    """(first tokens equal, first tokens differing on a near-tie of b's two
    best logits, within twice the logits' difference)."""
    top2 = b.topk(2, dim=-1).values
    margin = top2[:, 0] - top2[:, 1]
    same = a.argmax(-1) == b.argmax(-1)
    return int(same.sum()), int((~same & (margin <= 2 * diff)).sum())


def xlstm_parity(cfg, params) -> dict:
    """xlstm-125m at ``cfg``'s depth, kernels against their plain versions, two
    ways.  (1) In float32 (the bf16 weights widened; K3's float32 build):
    first-token logits of serve's 12 prompts within the 0.1 limit the other
    families are held to, every first token equal or a near-tie, then both
    engines' served tokens.  (2) In bfloat16, as served: the mLSTM block
    amplifies a rounding step of its input about twentyfold (its normaliser
    divides by q.n, which random weights leave near 0 for some tokens: one
    1-ulp change of every norm moves the logits of a 256-wide, 12-layer stack
    by up to 0.13 on the CPU), so the kernels' difference from the plain
    versions is held to twice what a third rounding of the same norms
    (``float64_norms``) moves the plain run by, and the first tokens to
    equal or near-tied."""
    tol = 1e-1
    from repro_torch.training.optimizer import tree_map
    c32 = cfg.replace(dtype="float32", param_dtype="float32")
    p32 = tree_map(lambda t: t.float(), params)
    k32, q32 = (first_token_logits(c32, p32, plain=plain) for plain in (False, True))
    d32 = (k32 - q32).abs().amax(dim=-1)
    eq32, tie32 = first_token_rule(k32, q32, d32)
    runs = {plain: run_engine(c32, p32, plain=plain)[0] for plain in (False, True)}
    equal = sum(x == y for a, b in zip(runs[False], runs[True]) for x, y in zip(a.tokens, b.tokens))
    total = sum(len(a.tokens) for a in runs[False])
    del p32
    kb, qb = (first_token_logits(cfg, params, plain=plain) for plain in (False, True))
    with float64_norms():
        q64 = first_token_logits(cfg, params, plain=True)
    db, floor = (kb - qb).abs().amax(dim=-1), (q64 - qb).abs().amax(dim=-1)
    eqb, tieb = first_token_rule(kb, qb, db)
    rec = {"phase": "xlstm", "part": "parity", "arch": cfg.name, "layers": cfg.num_layers,
           "requests": len(runs[False]),
           "float32": {"first_logits_max_abs_diff": float(d32.max()), "tol": tol,
                       "first_token_equal": eq32, "first_token_near_tie": tie32,
                       "tokens_equal_share": equal / total},
           "bfloat16": {"first_logits_max_abs_diff": float(db.max()),
                        "first_logits_max_abs_diff_float64_norms": float(floor.max()),
                        "tol": 2 * float(floor.max()),
                        "per_request": [[float(a), float(b)] for a, b in zip(db, floor)],
                        "first_token_equal": eqb, "first_token_near_tie": tieb},
           "gpu": gpu_name_and_power()}
    emit(rec)
    if not float(d32.max()) <= tol:
        fail(f"xlstm parity: float32 first-token logits differ by {float(d32.max())} > {tol}")
    if eq32 + tie32 != len(runs[False]) or eqb + tieb != len(runs[False]):
        fail("xlstm parity: a first token differs between kernels and plain versions beyond a "
             "near-tie of the two best logits")
    if not float(db.max()) <= 2 * float(floor.max()):
        fail(f"xlstm parity: bf16 first-token logits differ by {float(db.max())}, over twice "
             f"the float64-norm rounding's {float(floor.max())}")
    torch.cuda.empty_cache()
    return rec


def train_versus(cfg, train: dict, phase: str, profiling: bool = False) -> dict:
    """The analytical simulator's train step at the train part's shape (B, S,
    remat "block", its optimizer) against its measured step (wall and device
    busy) and its peak memory: one JSON line, returned.  With ``profiling``
    the profiling engine's too, measuring every operator on this card into a
    fresh profile DB (K1's forward and backward counted)."""
    from repro_torch import kernels as K
    from repro_torch.core import Simulator
    from repro_torch.core.backend import profiling as P
    spec = train_spec(cfg, seq=train["seq"], batch=train["batch"], optimizer=train["optimizer"])
    pred = Simulator("h100_sxm").run(spec)
    wall_us, busy_us = train["wall_ms_median"] * 1e3, train["device_busy_ms"] * 1e3
    versus = {"part": "train_vs_simulate", "arch": cfg.name, "batch": train["batch"],
              "seq": train["seq"], "optimizer": train["optimizer"],
              "analytical_us": pred.step_time_us,
              "analytical_breakdown_us": pred.breakdown_us,
              "analytical_t_fwd_us": pred.detail["t_fwd"],
              "measured_wall_us": wall_us, "measured_device_busy_us": busy_us,
              "signed_error": {"analytical_vs_wall": pred.step_time_us / wall_us - 1.0,
                               "analytical_vs_device_busy": pred.step_time_us / busy_us - 1.0},
              "device_idle_share": max(0.0, 1.0 - busy_us / wall_us),
              "memory": {"analytical_bytes": pred.memory.total,
                         "measured_peak_bytes": train["peak_bytes"],
                         "signed_error": pred.memory.total / train["peak_bytes"] - 1.0}}
    preds = [pred]
    if profiling:
        db_path = os.path.join(HERE, "build", phase, "profile_db_torch.json")
        if os.path.exists(db_path):
            os.remove(db_path)
        db = P.ProfileDB(db_path)
        t0 = time.perf_counter()
        K.reset_launch_counts()
        prof = Simulator("h100_sxm", engine="profiling", db=db, measure_on_miss=True).run(spec)
        launches = K.launch_counts()
        preds.append(prof)
        versus.update(
            profiling_us=prof.step_time_us, profiling_breakdown_us=prof.breakdown_us,
            profiling_s=time.perf_counter() - t0, profiling_launches=launches,
            profile_db_entries=len(db.data),
            profiling_attention_entries_us={k: v["us"] for k, v in db.data.items()
                                            if "|attention|" in k})
        versus["signed_error"].update(
            profiling_vs_wall=prof.step_time_us / wall_us - 1.0,
            profiling_vs_device_busy=prof.step_time_us / busy_us - 1.0)
        versus["memory"]["profiling_bytes"] = prof.memory.total
        if min(launches["flash_attention"], launches["flash_attention_bwd"]) <= 0:
            fail(f"{phase} train: the profiling engine did not launch K1 forward and backward: "
                 f"{launches}")
    emit({"phase": phase, **versus})
    if not all(math.isfinite(p.step_time_us) and p.step_time_us > 0 for p in preds):
        fail(f"{phase} train: a non-positive or non-finite predicted step time {versus}")
    return versus


def phase_xlstm() -> dict:
    """The xLSTM family on the card (xlstm-125m at full width: 4 heads of
    192, chunk 256; its 12 layers, m, m, m, s three times, cut to
    ``XLSTM_LAYERS``, one such cycle), random bf16 weights from the seed (the
    mLSTM's conv filter and bias and gate bias drawn too, ``xlstm_draw``), a
    line a part: serve (``moe_serve``: no K1 or K2, K3 2L+1 a call, the
    mLSTM's, sLSTM's and conv's kernels apart in the profiled step, the
    prompts the padded-chunk fault touches counted), parity
    (``xlstm_parity``), simulate (``moe_simulate``, no attention), the chunk
    body's degenerate products timed as bmm and as a multiply, then train
    (``phase_train``: one timed AdamW step of the launcher, B1
    S``XLSTM_TRAIN_SEQ``) against the simulator's train prediction and its
    memory.  Returns the launches of each part."""
    import gc
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    gc.collect()
    torch.cuda.empty_cache()
    cfg = get_config(XLSTM_ARCH).replace(num_layers=XLSTM_LAYERS)
    t0 = time.perf_counter()
    model = Model(cfg)
    gen = torch.Generator(device=model.device).manual_seed(SEED)
    params = model.init(gen)
    xlstm_draw(params, gen)
    torch.cuda.synchronize()
    serve = moe_serve(cfg, params, phase="xlstm")
    parts = {"serve_s": time.perf_counter() - t0}
    parity = xlstm_parity(cfg, params)
    parts["parity_s"] = time.perf_counter() - t0 - sum(parts.values())
    # two prefills timed and two profiled: each launches about 46,000 kernels
    sim = moe_simulate(cfg, params, name="xlstm", attention_kernels=(), prefill_calls=2)
    for mode in ("prefill", "decode"):
        emit({"phase": "xlstm", **sim[mode]})
    parts["simulate_s"] = time.perf_counter() - t0 - sum(parts.values())
    degenerate = xlstm_degenerate_products()
    emit({"phase": "xlstm", "part": "degenerate_products", **degenerate,
          "gpu": gpu_name_and_power()})
    del params, model
    gc.collect()
    torch.cuda.empty_cache()
    tgen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    train = phase_train(XLSTM_ARCH, phase="xlstm_train", timed_steps=1,
                        perturb=lambda p: xlstm_draw(p, tgen), seq=XLSTM_TRAIN_SEQ,
                        layers=XLSTM_LAYERS)
    parts["train_s"] = time.perf_counter() - t0 - sum(parts.values())
    train_versus(cfg, train, "xlstm")
    emit({"phase": "xlstm", "part": "done", "arch": cfg.name,
          "seconds": time.perf_counter() - t0, "parts_s": parts,
          "parity_layers": parity["layers"], "profile_db_entries": sim["profile_db_entries"],
          "gpu": gpu_name_and_power()})
    return {"serve": serve["launches"],
            "simulate": {k: sim["prefill"]["profiling_launches"][k]
                         + sim["decode"]["profiling_launches"][k] for k in serve["launches"]},
            "train": train["launches_per_step"], "serve_rec": serve}


WHISPER_ARCH = "whisper-large-v3"
WHISPER_B = 8            # requests, each with its own 30-second segment of frames
WHISPER_PROMPT = 4       # the start-of-transcript prompt
WHISPER_CACHE = 448      # the decoder's context
WHISPER_NEW = 124        # greedy new tokens: 128 positions, about one segment's text
WHISPER_CONTEXT = 224    # the previous segment's text, which Whisper conditions on (B1)
WHISPER_TRAIN = (8, 448)  # (batch, sequence) of the train part; the encoder's 1500 frames


def whisper_frames(cfg, B: int, seed: int) -> torch.Tensor:
    """(B, 1500, d_model) float32 frame embeddings on the card: normal from
    ``seed``, times 0.1, as ``tests/test_archs.py`` draws them."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randn((B, cfg.encoder_seq, cfg.d_model), generator=gen, device="cuda") * 0.1


def whisper_expected(cfg, decode_steps: int, prefills: int = 1) -> dict:
    """The transcription's launches: K1 at every attention of a prefill (the
    encoder's self attention, the decoder's self and cross attention: 2L +
    Le), K2 at both of a decode step's (self against the ring, cross
    against the encoder's rows: 2L), no K3 (LayerNorm is plain torch)."""
    L, Le = cfg.num_layers, cfg.encoder_layers
    return {"flash_attention": (2 * L + Le) * prefills, "decode_attention": 2 * L * decode_steps,
            "rmsnorm": 0, "flash_attention_bwd": 0, "rmsnorm_bwd": 0, "adamw": 0, "adafactor": 0}


def whisper_transcribe(cfg, model, params) -> dict:
    """Model.prefill and decode_step driven as a transcription (the
    reference's engine takes no frame embeddings, so neither does the
    port's): B8 requests, each with its own frames, a 4-token prompt, a ring
    of 448, 124 greedy new tokens; then one B1 prefill of a 224-token
    prompt.  Tokens/s, time to the first token, peak memory, launches against
    ``whisper_expected``, one profiled decode step at 8 rows by kernel
    group, no host sync in a decode step, and the encoder alone timed."""
    import warnings
    from repro_torch import kernels as K
    rng = np.random.default_rng(SEED)
    B, V = WHISPER_B, cfg.vocab_size
    prompt = torch.tensor(rng.integers(0, V, (B, WHISPER_PROMPT)), device="cuda")
    fe = whisper_frames(cfg, B, SEED + 2)

    def prefill():
        return model.prefill(params, {"tokens": prompt, "frame_embeds": fe},
                             cache_len=WHISPER_CACHE)

    logits, cache = prefill()                # warm-up: the libraries and handles load
    model.decode_step(params, cache, {"tokens": logits[:, -1].argmax(-1, keepdim=True)})
    del cache
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    logits, cache = prefill()
    tok = logits[:, -1].argmax(-1, keepdim=True)
    torch.cuda.synchronize()
    ttft_s = time.perf_counter() - t0
    prefill_counts = K.launch_counts()
    out, finite = [tok], [torch.isfinite(logits).all()]
    for _ in range(WHISPER_NEW - 1):
        logits, cache = model.decode_step(params, cache, {"tokens": tok})
        tok = logits[:, -1].argmax(-1, keepdim=True)
        out.append(tok)
        finite.append(torch.isfinite(logits).all())
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = K.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    tokens = torch.cat(out, dim=1).cpu()
    finite = bool(torch.stack(finite).all())
    want = whisper_expected(cfg, WHISPER_NEW - 1)
    # one decode step at the 8 rows under the profiler, and its host syncs
    step = measure_step(lambda: model.decode_step(params, cache, {"tokens": tok}), 3)
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            model.decode_step(params, cache, {"tokens": tok})
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = [str(w.message)[:160] for w in caught if "called a synchronizing" in str(w.message)]
    pos_after = int(cache["pos"][0])
    del cache
    # the previous segment's text, B1, and the encoder of one segment alone
    ctx = {"tokens": torch.tensor(rng.integers(0, V, (1, WHISPER_CONTEXT)), device="cuda"),
           "frame_embeds": fe[:1]}
    K.reset_launch_counts()
    model.prefill(params, ctx, cache_len=WHISPER_CACHE)
    torch.cuda.synchronize()
    ctx_counts = K.launch_counts()
    ctx_step = measure_step(lambda: model.prefill(params, ctx, cache_len=WHISPER_CACHE), 2)
    enc_step = measure_step(lambda: model.encode(params, fe[:1]), 2)
    rec = {"part": "transcribe", "arch": cfg.name, "layers": cfg.num_layers,
           "encoder_layers": cfg.encoder_layers, "d_model": cfg.d_model, "vocab": V,
           "batch": B, "prompt_tokens": WHISPER_PROMPT, "cache_len": WHISPER_CACHE,
           "new_tokens": WHISPER_NEW, "decode_steps": WHISPER_NEW - 1, "seconds": seconds,
           "tokens_per_s": B * WHISPER_NEW / seconds, "ttft_ms": ttft_s * 1e3,
           "decode_ms_per_step": (seconds - ttft_s) * 1e3 / (WHISPER_NEW - 1),
           "peak_bytes": peak, "logits_finite": finite, "first_tokens": tokens[:, 0].tolist(),
           "launches": counts, "launches_expected": want, "prefill_launches": prefill_counts,
           "decode_step": step, "decode_step_host_syncs": syncs, "pos_after": pos_after,
           "context_prefill": {"batch": 1, "prompt_tokens": WHISPER_CONTEXT,
                               "launches": ctx_counts, **ctx_step},
           "encoder_b1": enc_step, "gpu": gpu_name_and_power()}
    emit({"phase": "whisper", **rec})
    if tokens.shape != (B, WHISPER_NEW) or not ((tokens >= 0) & (tokens < V)).all():
        fail(f"whisper transcribe: tokens of shape {tuple(tokens.shape)} or outside the vocabulary")
    if not finite:
        fail("whisper transcribe: non-finite logits")
    if counts != want or prefill_counts != whisper_expected(cfg, 0) \
            or ctx_counts != whisper_expected(cfg, 0):
        fail(f"whisper transcribe: launch counts {counts} (prefill {prefill_counts}, context "
             f"{ctx_counts}) differ from what the path implies {want}")
    if syncs:
        fail(f"whisper transcribe: a decode step synchronised with the host: {syncs}")
    return rec


def whisper_cross_decode() -> dict:
    """The cross attention of one decode step at its real shape (B8 H20 Sq1,
    the encoder's 1500 rows, D64, bf16, the cache's (B, T, H, D) layout) three
    ways: K2 with every row valid (the path's route), K1 with one query row
    (the route before), and SDPA; each held against the plain version, with
    its time, device time and the bytes bound."""
    from repro_torch.kernels import decode_attention, decode_attention_plain, flash_attention
    rng = np.random.default_rng(SEED + 5)
    B, H, T, D, dt = WHISPER_B, 20, 1500, 64, torch.bfloat16
    q, k, v, _ = decode_inputs(rng, B=B, H=H, Hkv=H, T=T, D=D, valid=None, dtype=dt, bthd=True)
    want = decode_attention_plain(q, k, v)
    nbytes, flops = decode_work(q, k, None)
    bound_ms, bound_by = bound(nbytes, flops, dt)
    ways = {"K2_full_valid": lambda: decode_attention(q, k, v),
            "K1_one_query_row": lambda: flash_attention(q[:, :, None, :], k, v, causal=False),
            "sdpa": sdpa_decode(q, k, v, None)}
    rec = {"part": "cross_decode", "case": f"B{B} H{H} Sq1 Sk{T} D{D} bf16 bthd",
           "bound_ms": bound_ms, "bound_by": bound_by, "ways": {}}
    for name, fn in ways.items():
        got = fn().reshape(want.shape)
        rec["ways"][name] = {"max_abs_err": max_err(got, want), "ms": time_ms(fn),
                             "device_ms": device_ms(fn)}
    rec["k1_over_k2_device"] = (rec["ways"]["K1_one_query_row"]["device_ms"]
                                / rec["ways"]["K2_full_valid"]["device_ms"])
    rec["gpu"] = gpu_name_and_power()
    emit({"phase": "whisper", **rec})
    bad = {n: w for n, w in rec["ways"].items() if not w["max_abs_err"] <= TOL[dt]}
    if bad:
        fail(f"whisper cross_decode: over tolerance {TOL[dt]}: {bad}")
    return rec


def attention_f64(q, k, v, *, causal=True, window=0, scale=None):
    """``flash_attention_plain``'s function computed in float64 and rounded
    once to q's type: a third rounding of the same attention."""
    B, H, Sq, D = q.shape
    G = H // k.shape[1]
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    kf, vf = (t.double().repeat_interleave(G, 1) for t in (k, v))
    s = (q.double() @ kf.transpose(-1, -2)) * scale
    qp = torch.arange(Sq, device=q.device)[:, None]
    kp = torch.arange(k.shape[2], device=q.device)[None, :]
    seen = torch.ones_like(s[0, 0], dtype=torch.bool)
    if causal:
        seen &= kp <= qp
    if window > 0:
        seen &= kp > qp - window
    return (torch.softmax(s.masked_fill(~seen, float("-inf")), -1) @ vf).to(q.dtype)


def whisper_parity(cfg, params) -> dict:
    """The transcription's 8 requests (its frames and prompts) prefilled at
    full depth through the kernels and through their plain versions: the
    first-token logits within 0.1 and the first tokens equal or a near-tie of
    the plain run's two best logits (with its margin).  Where bf16 rounding
    alone moves them by more, as the xlstm phase holds it: in float32 within
    0.1, and in bf16 within twice what a float64 rounding of the plain
    attention moves the plain run by (LayerNorm is plain torch in both runs;
    attention is what differs)."""
    from repro_torch.models import Model
    from repro_torch.models import layers as L
    from repro_torch.training.optimizer import tree_map
    rng = np.random.default_rng(SEED)
    prompt = torch.tensor(rng.integers(0, cfg.vocab_size, (WHISPER_B, WHISPER_PROMPT)),
                          device="cuda")
    fe = whisper_frames(cfg, WHISPER_B, SEED + 2)
    tol = 1e-1

    def first(c, p, plain):
        m = Model(c, plain_kernels=plain)
        return m.prefill(p, {"tokens": prompt, "frame_embeds": fe},
                         cache_len=WHISPER_CACHE)[0][:, -1].float()

    kb, qb = first(cfg, params, False), first(cfg, params, True)
    db = (kb - qb).abs().amax(dim=-1)
    eqb, tieb = first_token_rule(kb, qb, db)
    top2 = qb.topk(2, dim=-1).values
    rec = {"part": "parity", "arch": cfg.name, "layers": cfg.num_layers,
           "encoder_layers": cfg.encoder_layers, "requests": WHISPER_B, "tol": tol,
           "bfloat16": {"first_logits_max_abs_diff": float(db.max()),
                        "per_request": [float(x) for x in db],
                        "plain_top2_margin": [float(x) for x in top2[:, 0] - top2[:, 1]],
                        "first_token_equal": eqb, "first_token_near_tie": tieb}}
    held = "bfloat16 within tol"
    if not float(db.max()) <= tol:
        c32 = cfg.replace(dtype="float32", param_dtype="float32")
        p32 = tree_map(lambda t: t.float(), params)
        k32, q32 = first(c32, p32, False), first(c32, p32, True)
        del p32
        d32 = (k32 - q32).abs().amax(dim=-1)
        eq32, tie32 = first_token_rule(k32, q32, d32)
        saved = L.flash_attention_plain
        L.flash_attention_plain = attention_f64
        try:
            q64 = first(cfg, params, True)
        finally:
            L.flash_attention_plain = saved
        floor = (q64 - qb).abs().amax(dim=-1)
        rec["float32"] = {"first_logits_max_abs_diff": float(d32.max()), "tol": tol,
                          "first_token_equal": eq32, "first_token_near_tie": tie32}
        rec["bfloat16"].update(first_logits_max_abs_diff_float64_attention=float(floor.max()),
                               tol=2 * float(floor.max()))
        held = "float32 within tol, bfloat16 within twice the float64-attention rounding"
        if not (float(d32.max()) <= tol and float(db.max()) <= 2 * float(floor.max())
                and eq32 + tie32 == WHISPER_B):
            rec["held"] = "no"
            emit({"phase": "whisper", **rec})
            fail(f"whisper parity: first-token logits differ beyond both rules: {rec}")
    rec["held"] = held
    rec["gpu"] = gpu_name_and_power()
    emit({"phase": "whisper", **rec})
    if eqb + tieb != WHISPER_B:
        fail("whisper parity: a first token differs between kernels and plain versions beyond a "
             "near-tie of the two best logits")
    torch.cuda.empty_cache()
    return rec


def phase_whisper() -> dict:
    """The Whisper family on the card (whisper-large-v3 at full width and
    depth: 32 encoder and 32 decoder layers, d_model 1280, 20 heads of 64,
    vocab 51,866; random bf16 weights from the seed), a line a part:
    transcribe (``whisper_transcribe``), the cross decode's three routes
    (``whisper_cross_decode``), parity (``whisper_parity``), simulate
    (``moe_simulate`` at prefill B1 S224 and decode B8 at cache 448, then
    the encoder's predicted time against the measured ``Model.encode``), and
    train (``phase_train``: one timed AdamW step of the launcher, B8 S448,
    remat "block", the batch cut only if the simulator says the step does
    not fit) against the simulator's train prediction.  Returns the launches
    of each part."""
    import gc
    from repro_torch.configs import get_config
    from repro_torch.core import Simulator
    from repro_torch.api import Cluster, PrefillWorkload, SimSpec
    from repro_torch.models import Model, count_params
    gc.collect()
    torch.cuda.empty_cache()
    cfg = get_config(WHISPER_ARCH)
    t0 = time.perf_counter()
    model = Model(cfg)
    params = model.init(torch.Generator(device=model.device).manual_seed(SEED))
    torch.cuda.synchronize()
    parts = {"init_s": time.perf_counter() - t0}
    transcribe = whisper_transcribe(cfg, model, params)
    parts["transcribe_s"] = time.perf_counter() - t0 - sum(parts.values())
    whisper_cross_decode()
    parts["cross_decode_s"] = time.perf_counter() - t0 - sum(parts.values())
    whisper_parity(cfg, params)
    parts["parity_s"] = time.perf_counter() - t0 - sum(parts.values())
    sim = moe_simulate(cfg, params, name="whisper", prefill_seq=WHISPER_CONTEXT,
                       decode_cache=WHISPER_CACHE,
                       extra={"frame_embeds": whisper_frames(cfg, 1, SEED + 3)},
                       prefill_calls=3)
    for mode in ("prefill", "decode"):
        emit({"phase": "whisper", **sim[mode]})
    # the encoder apart: its block's price times its 32 layers, each engine, against
    # Model.encode of one segment measured alone
    spec = SimSpec(cfg, cluster=Cluster("h100_sxm", chips=1),
                   workload=PrefillWorkload(global_batch=1, seq_len=WHISPER_CONTEXT))
    from repro_torch.core.backend import profiling as P
    db = P.ProfileDB(os.path.join(HERE, "build", "whisper", "profile_db_torch.json"))
    enc_pred = {eng: sim_.run(spec).detail["t_fwd"]["enc"] * cfg.encoder_layers
                for eng, sim_ in (("analytical", Simulator("h100_sxm")),
                                  ("profiling", Simulator("h100_sxm", engine="profiling", db=db)))}
    enc = transcribe["encoder_b1"]
    encoder = {"part": "simulate_encoder", "layers": cfg.encoder_layers,
               "frames": cfg.encoder_seq, "predicted_us": enc_pred,
               "measured_wall_us": enc["wall_us"], "measured_device_busy_us": enc["device_busy_us"],
               "signed_error": {f"{p}_vs_{m}": v / enc[k] - 1.0 for p, v in enc_pred.items()
                                for m, k in (("wall", "wall_us"),
                                             ("device_busy", "device_busy_us"))}}
    emit({"phase": "whisper", **encoder})
    parts["simulate_s"] = time.perf_counter() - t0 - sum(parts.values())
    del params, model
    gc.collect()
    torch.cuda.empty_cache()
    B, S = WHISPER_TRAIN
    train = phase_train(WHISPER_ARCH, phase="whisper_train", timed_steps=1, seq=S, batch=B,
                        cut="batch")
    train_versus(cfg, train, "whisper")
    parts["train_s"] = time.perf_counter() - t0 - sum(parts.values())
    emit({"phase": "whisper", "part": "done", "arch": cfg.name, "params": count_params(cfg),
          "seconds": time.perf_counter() - t0, "parts_s": parts,
          "profile_db_entries": sim["profile_db_entries"], "gpu": gpu_name_and_power()})
    return {"transcribe": transcribe["launches"],
            "simulate": {k: sim["prefill"]["profiling_launches"][k]
                         + sim["decode"]["profiling_launches"][k] for k in transcribe["launches"]},
            "train": train["launches_per_step"]}




VLM_ARCH = "qwen2-vl-7b"
VLM_GRID = 16            # one image of 16 x 16 merged patches: launch.specs.N_PATCH_STUB rows
VLM_B, VLM_S = 2, 512    # the multimodal prefill: the image's 256 rows, then 256 text tokens
VLM_NEW = 32             # greedy decode steps after it
VLM_CACHE = 2048         # the serving ring
# The train part's depth: AdamW at 12 bytes a parameter is 91.4 GB at the full 28
# layers against the card's 80 GB; 12 layers are 3,886,691,840 parameters, 46.6 GB.
VLM_TRAIN_LAYERS = 12


def vlm_positions(B: int, S: int, grid: int = VLM_GRID) -> torch.Tensor:
    """(B, S, 3) int64 on the card, Qwen2-VL's layout (arXiv:2409.12191) built as
    input data: an image of ``grid`` x ``grid`` merged patches on rows 0..grid^2-1
    at (t, h, w) = (0, i // grid, i % grid), then text at t = h = w from ``grid``
    (one past the image's largest position) on."""
    n = grid * grid
    i = torch.arange(S, device="cuda")
    image = torch.stack([torch.zeros_like(i), i // grid, i % grid], dim=-1)
    text = (grid + i - n)[:, None].expand(S, 3)
    return torch.where((i < n)[:, None], image, text).expand(B, S, 3).contiguous()


def vlm_inputs(cfg, B: int = VLM_B) -> dict:
    """The multimodal prefill's batch: B x VLM_S tokens from the seed, 256 patch
    embeddings a row (normal from the seed times 0.02, as training/data.py draws
    them; float32, the model casts them) over rows 0-255, ``vlm_positions``."""
    from repro_torch.launch.specs import N_PATCH_STUB
    if VLM_GRID ** 2 != N_PATCH_STUB:
        fail(f"the image grid {VLM_GRID}^2 is not the {N_PATCH_STUB} patches of the stub")
    rng = np.random.default_rng(SEED + 6)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 6)
    pe = torch.randn((VLM_B, N_PATCH_STUB, cfg.d_model), generator=gen, device="cuda") * 0.02
    toks = torch.tensor(rng.integers(0, cfg.vocab_size, (VLM_B, VLM_S)), device="cuda")
    return {"tokens": toks[:B], "positions": vlm_positions(B, VLM_S), "patch_embeds": pe[:B]}


def vlm_expected(cfg, prefills: int, decode_steps: int) -> dict:
    """K1 an attention layer a prefill, K2 one a decode step, K3 2L + 1 a call."""
    L = cfg.num_layers
    return {"flash_attention": L * prefills, "decode_attention": L * decode_steps,
            "rmsnorm": (2 * L + 1) * (prefills + decode_steps), "flash_attention_bwd": 0,
            "rmsnorm_bwd": 0, "adamw": 0, "adafactor": 0}


def vlm_multimodal(cfg, model, params) -> dict:
    """``Model`` driven with an image (the engine takes none, as the reference's):
    a B2 prefill of S512, 256 patch embeddings over rows 0-255 at distinct (t, h, w)
    positions and 256 text tokens after them, then ``VLM_NEW`` greedy decode steps at
    explicit (B, 1, 3) positions that continue the text's.  Time to the first
    token, tokens/s, peak memory, launches against ``vlm_expected``, the prefill
    and one decode step measured (busy, wall, launches), no host sync in a
    decode step; and what the first-token logits move by when the positions are
    the default equal sections, or the patches are left out (both must move
    them: the path read its 3-D positions and its patches)."""
    import warnings
    from repro_torch import kernels as K
    batch = vlm_inputs(cfg)
    first_text = VLM_GRID + VLM_S - VLM_GRID ** 2
    dec_pos = (first_text + torch.arange(VLM_NEW + 16, device="cuda"))[None, :, None] \
        .expand(VLM_B, VLM_NEW + 16, 3)

    def prefill(b=batch):
        return model.prefill(params, b, cache_len=VLM_CACHE)

    logits, cache = prefill()                # warm-up
    model.decode_step(params, cache, {"tokens": logits[:, -1].argmax(-1, keepdim=True),
                                      "positions": dec_pos[:, :1]})
    del cache
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    logits, cache = prefill()
    tok = logits[:, -1].argmax(-1, keepdim=True)
    torch.cuda.synchronize()
    ttft_s = time.perf_counter() - t0
    prefill_counts = K.launch_counts()
    first = logits[:, -1].float()
    out, finite = [tok], [torch.isfinite(logits).all()]
    for j in range(VLM_NEW):
        logits, cache = model.decode_step(params, cache, {"tokens": tok,
                                                          "positions": dec_pos[:, j:j + 1]})
        tok = logits[:, -1].argmax(-1, keepdim=True)
        out.append(tok)
        finite.append(torch.isfinite(logits).all())
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = K.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    tokens = torch.cat(out, dim=1).cpu()
    finite = bool(torch.stack(finite).all())
    want = vlm_expected(cfg, 1, VLM_NEW)
    step_batch = {"tokens": tok, "positions": dec_pos[:, VLM_NEW:VLM_NEW + 1]}
    step = measure_step(lambda: model.decode_step(params, cache, step_batch), 3)
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            model.decode_step(params, cache, step_batch)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = [str(w.message)[:160] for w in caught if "called a synchronizing" in str(w.message)]
    pos_after = int(cache["pos"][0])
    del cache
    pre = measure_step(prefill, 2)
    moved = {}
    for name, b in (("equal_sections", {k: v for k, v in batch.items() if k != "positions"}),
                    ("no_patches", {k: v for k, v in batch.items() if k != "patch_embeds"})):
        moved[name] = float((prefill(b)[0][:, -1].float() - first).abs().max())
    rec = {"part": "multimodal", "arch": cfg.name, "layers": cfg.num_layers, "batch": VLM_B,
           "seq": VLM_S, "patches": VLM_GRID ** 2, "image_grid": [VLM_GRID, VLM_GRID],
           "first_text_position": first_text, "cache_len": VLM_CACHE, "new_tokens": VLM_NEW,
           "seconds": seconds, "ttft_ms": ttft_s * 1e3,
           "tokens_per_s": VLM_B * (VLM_NEW + 1) / seconds,
           "decode_ms_per_step": (seconds - ttft_s) * 1e3 / VLM_NEW, "peak_bytes": peak,
           "logits_finite": finite, "first_tokens": tokens[:, 0].tolist(),
           "launches": counts, "launches_expected": want, "prefill_launches": prefill_counts,
           "prefill": pre, "decode_step": step, "decode_step_host_syncs": syncs,
           "pos_after": pos_after, "first_logits_moved_by": moved, "gpu": gpu_name_and_power()}
    emit({"phase": "vlm", **rec})
    if tokens.shape != (VLM_B, VLM_NEW + 1) or not ((tokens >= 0)
                                                    & (tokens < cfg.vocab_size)).all():
        fail(f"vlm multimodal: tokens of shape {tuple(tokens.shape)} or outside the vocabulary")
    if not finite:
        fail("vlm multimodal: non-finite logits")
    if counts != want or prefill_counts != vlm_expected(cfg, 1, 0):
        fail(f"vlm multimodal: launch counts {counts} (prefill {prefill_counts}) differ from "
             f"what the path implies {want}")
    if syncs:
        fail(f"vlm multimodal: a decode step synchronised with the host: {syncs}")
    if not min(moved.values()) > 0.0:
        fail(f"vlm multimodal: the first-token logits did not move without the 3-D positions "
             f"or the patches: {moved}")
    return rec


def full_depth_parity(cfg, params, batch=None, float32: bool = False) -> tuple[dict, list]:
    """A model at full depth, kernels against their plain versions: the
    first-token logits of serve's 12 prompts (and, with ``batch``, of that
    prefill: qwen2-vl's multimodal one, B2 with patches and 3-D positions)
    within 0.1, every first token equal or a near-tie of the plain run's two
    best logits; beside them, what a float64 rounding of the plain norms and
    attention moves the plain run by, and the logits' largest magnitude (the
    head rounds them to bf16); then both engines' tokens on serve's requests.
    With ``float32``, as ``xlstm_parity`` holds a model whose bf16 rounding
    alone moves its logits by about the limit: the 0.1 limit is held on the
    same prompts with float32 activations (the weights stay bf16 and each
    product widens its own; the kernels' float32 builds), and the bf16 run
    to twice what the float64 rounding moves the plain run by.  Returns (the
    record, the checks that failed), so that the phase's later parts still
    run and print."""
    from repro_torch.models import Model
    from repro_torch.models import layers as L
    tol = 1e-1

    def first(plain):
        out = {"text": first_token_logits(cfg, params, plain=plain)}
        if batch is not None:
            out["multimodal"] = Model(cfg, plain_kernels=plain).prefill(
                params, batch, cache_len=2048)[0][:, -1].float()
        return out

    got = {plain: first(plain) for plain in (False, True)}
    # what a third rounding of the same functions moves the plain run by (K3's norms
    # and K1's attention in float64, rounded once): information beside the limit,
    # which stays 0.1
    saved = L.flash_attention_plain
    L.flash_attention_plain = attention_f64
    try:
        with float64_norms():
            third = first(True)
    finally:
        L.flash_attention_plain = saved
    runs = {plain: run_engine(cfg, params, plain=plain)[0] for plain in (False, True)}
    equal = sum(x == y for a, b in zip(runs[False], runs[True]) for x, y in zip(a.tokens, b.tokens))
    total = sum(len(a.tokens) for a in runs[False])
    rec = {"part": "parity", "arch": cfg.name, "layers": cfg.num_layers, "tol": tol,
           "tokens_equal_share": equal / total, "gpu": gpu_name_and_power()}
    if float32:
        c32 = cfg.replace(dtype="float32")
        f32 = {plain: first_token_logits(c32, params, plain=plain) for plain in (False, True)}
    problems = []
    for name in got[True]:
        mine, plain = got[False][name], got[True][name]
        diff = (mine - plain).abs().amax(dim=-1)
        eq, tie = first_token_rule(mine, plain, diff)
        top2 = plain.topk(2, dim=-1).values
        rec[name] = {"requests": len(diff), "first_logits_max_abs_diff": float(diff.max()),
                     "per_request": [float(x) for x in diff],
                     "first_logits_max_abs_diff_float64_plain":
                         float((third[name] - plain).abs().max()),
                     "first_logits_abs_max": float(plain.abs().max()),
                     "plain_top2_margin_min": float((top2[:, 0] - top2[:, 1]).min()),
                     "first_token_equal": eq, "first_token_near_tie": tie, "tol": tol}
        if float32:
            rec[name]["tol"] = 2 * rec[name]["first_logits_max_abs_diff_float64_plain"]
        if not float(diff.max()) <= rec[name]["tol"]:
            problems.append(f"{cfg.name} {name} first-token logits differ by "
                            f"{float(diff.max())} > {rec[name]['tol']}")
        if eq + tie != len(diff):
            problems.append(f"{cfg.name} {name}: a first token differs beyond a near-tie")
    if float32:
        mine, plain = f32[False], f32[True]
        diff = (mine - plain).abs().amax(dim=-1)
        eq, tie = first_token_rule(mine, plain, diff)
        rec["float32"] = {"requests": len(diff), "first_logits_max_abs_diff": float(diff.max()),
                          "per_request": [float(x) for x in diff], "tol": tol,
                          "first_token_equal": eq, "first_token_near_tie": tie}
        if not float(diff.max()) <= tol:
            problems.append(f"{cfg.name} float32 first-token logits differ by "
                            f"{float(diff.max())} > {tol}")
        if eq + tie != len(diff):
            problems.append(f"{cfg.name} float32: a first token differs beyond a near-tie")
    torch.cuda.empty_cache()
    return rec, problems


def phase_vlm() -> dict:
    """The VLM family on the card (qwen2-vl-7b at full width and depth: 28
    layers, d_model 3584, 28 heads on 4 kv heads (G 7) of 128, M-RoPE, vocab
    152,064 untied; random bf16 weights from the seed, made once and shared by
    the parts), a line a part: serve (``moe_serve``, text only, as the
    reference's engine serves it: K1 a layer a prefill, K2 a layer a decode
    step, K3 2L+1 a call, no host sync in a decode step), multimodal
    (``vlm_multimodal``), parity (``full_depth_parity``), simulate (``moe_simulate``
    at prefill B1 S512 with the image's (t, h, w) positions and patches, and
    decode B8 at 2048), and train (``phase_train``: one timed AdamW step of the
    launcher at B1 S2048 with the pipeline's positions and patches, remat
    "block", depth cut to ``VLM_TRAIN_LAYERS``) against the simulator's train
    prediction.  Returns the launches of each part."""
    import gc
    from repro_torch.configs import get_config
    from repro_torch.models import Model, count_params
    gc.collect()
    torch.cuda.empty_cache()
    cfg = get_config(VLM_ARCH)
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    model = Model(cfg)
    params = model.init(torch.Generator(device=model.device).manual_seed(SEED))
    torch.cuda.synchronize()
    init = {"allocated_bytes": torch.cuda.memory_allocated(),
            "peak_bytes": torch.cuda.max_memory_allocated()}
    parts = {"init_s": time.perf_counter() - t0}
    serve = moe_serve(cfg, params, phase="vlm")
    parts["serve_s"] = time.perf_counter() - t0 - sum(parts.values())
    multimodal = vlm_multimodal(cfg, model, params)
    parts["multimodal_s"] = time.perf_counter() - t0 - sum(parts.values())
    parity, problems = full_depth_parity(cfg, params, vlm_inputs(cfg))
    emit({"phase": "vlm", **parity})
    parts["parity_s"] = time.perf_counter() - t0 - sum(parts.values())
    one = vlm_inputs(cfg, B=1)
    sim = moe_simulate(cfg, params, name="vlm", prefill_seq=VLM_S, prefill_calls=3,
                       extra={"positions": one["positions"], "patch_embeds": one["patch_embeds"]})
    for mode in ("prefill", "decode"):
        emit({"phase": "vlm", **sim[mode]})
    parts["simulate_s"] = time.perf_counter() - t0 - sum(parts.values())
    del params, model, one
    gc.collect()
    torch.cuda.empty_cache()
    train = phase_train(VLM_ARCH, phase="vlm_train", timed_steps=1, layers=VLM_TRAIN_LAYERS)
    train_versus(cfg.replace(num_layers=VLM_TRAIN_LAYERS), train, "vlm")
    parts["train_s"] = time.perf_counter() - t0 - sum(parts.values())
    emit({"phase": "vlm", "part": "done", "arch": cfg.name, "params": count_params(cfg),
          "train_layers": VLM_TRAIN_LAYERS, "seconds": time.perf_counter() - t0,
          "parts_s": parts, "init": init, "profile_db_entries": sim["profile_db_entries"],
          "gpu": gpu_name_and_power()})
    if problems:
        fail(f"vlm parity: {problems}")
    return {"serve": serve["launches"], "multimodal": multimodal["launches"],
            "simulate": {k: sim["prefill"]["profiling_launches"][k]
                         + sim["decode"]["profiling_launches"][k] for k in serve["launches"]},
            "train": train["launches_per_step"]}


MLA_ARCH = "deepseek-v3-671b"
# Depth cut to what one card holds: 2 layers are 24,867,937,280 parameters
# (49.7 GB of bf16), and init makes each leaf in fp32 first (an expert leaf,
# 256 x 7168 x 2048, is 15.0 GB beside its 7.5 GB result), so it peaks near
# 65 GB; 3 layers are 72.75 GB of weights.
MLA_LAYERS = 2


def _subtree_kernels(ev) -> list:
    """The device kernels a profiled CPU operator launched, its children's
    included."""
    out = [k.name for k in getattr(ev, "kernels", [])]
    for child in ev.cpu_children:
        out += _subtree_kernels(child)
    return out


def mla_layout() -> dict:
    """deepseek-v3-671b's absorbed decode (``mla_decode``, one layer's
    attention weights at full width, B8 at a ring of 2048, plain norms) once
    under the profiler: the device kernels each of its five ``aten::bmm``
    launched.  A product that cannot read an operand where it lies copies it
    first, a copy kernel beside its GEMM.  Also the transposes the port's
    tracer prices for that block, against the reference's 40.4 MB."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import get_config
    from repro_torch.core.model_ingest import block_graphs
    from repro_torch.models import model as M
    from repro_torch.models.params import _mla_attn
    cfg = get_config(MLA_ARCH)
    bf16 = torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(SEED)

    def c(path, shape, logical, fan_in):
        w = torch.randn(shape, generator=gen, device="cuda")
        return (w if fan_in <= 0 else w / math.sqrt(fan_in)).to(bf16)

    p = _mla_attn(cfg, c, ("attn",))
    B, T = 8, 2048
    rng = np.random.default_rng(SEED)
    x = randn(rng, (B, 1, cfg.d_model), bf16)
    cache = {"ckv": randn(rng, (B, T, cfg.kv_lora_rank), bf16),
             "kr": randn(rng, (B, T, cfg.qk_rope_head_dim), bf16)}
    pos = torch.full((B,), T - 1, dtype=torch.int32, device="cuda")
    M.mla_decode(cfg, p, x, pos, cache, plain=True)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        M.mla_decode(cfg, p, x, pos, cache, plain=True)
        torch.cuda.synchronize()
    products = []
    for ev in prof.events():
        if ev.name == "aten::bmm" and ev.device_type == torch.autograd.DeviceType.CPU:
            names = _subtree_kernels(ev)
            products.append({"shapes": ev.input_shapes[:2], "kernels": [n[:90] for n in names],
                             "copies": sum(kernel_group(n) != "cublas" for n in names)})
    mg = block_graphs(cfg.replace(num_layers=1), B, 1, "decode", cache_len=T)
    priced = [n for n in mg.blocks[0].fwd if n.kind == "transpose"]
    rec = {"part": "layout", "products": products,
           "bmm_with_a_copy": sum(pr["copies"] > 0 for pr in products),
           "priced_transposes": [[list(n.out_shape), n.dtype, n.bytes_out] for n in priced],
           "priced_transpose_bytes": sum(n.total_bytes for n in priced)}
    emit({"phase": "mla", **rec})
    if len(products) != 5:
        fail(f"mla layout: {len(products)} batched products profiled, 5 expected: {products}")
    return rec


def phase_mla() -> dict:
    """The MLA family on the card (deepseek-v3-671b at full width, depth cut
    to ``MLA_LAYERS``, random bf16 weights from the seed, made once and
    shared by the parts), a line a part: serve (``moe_serve``), parity
    (``moe_parity``, the plain run on the kernel run's routes), simulate
    (``moe_simulate``: K1 at (192, 128) counted in the profiling engine's
    prefill; the absorbed decode has no attention node), then, those
    weights freed, train (``mla_train`` at ``MLA_TRAIN_LAYERS``).  Returns
    the launches of each part."""
    import gc
    from repro_torch import kernels as K
    from repro_torch.configs import get_config
    from repro_torch.models import Model, count_params
    layout = mla_layout()
    if layout["bmm_with_a_copy"]:
        fail(f"mla layout: a batched product of the absorbed decode copied an operand: "
             f"{layout['products']}")
    gc.collect()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated()
    full = get_config(MLA_ARCH)
    cfg = full.replace(num_layers=MLA_LAYERS)
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    model = Model(cfg)
    params = model.init(torch.Generator(device=model.device).manual_seed(SEED))
    torch.cuda.synchronize()
    init = {"seconds": time.perf_counter() - t0, "allocated_before_bytes": before,
            "allocated_bytes": torch.cuda.memory_allocated(),
            "peak_bytes": torch.cuda.max_memory_allocated()}
    reduced = {"num_layers": [full.num_layers, MLA_LAYERS],
               "params": [count_params(full), count_params(cfg)],
               "why": "2 layers of bf16 weights (49.7 GB) and their fp32 init fit the card's "
                      "80 GB; 3 layers (72.75 GB) do not"}
    serve = moe_serve(cfg, params, phase="mla")
    parity, ok_first = moe_parity(cfg, params)
    emit({"phase": "mla", **parity})
    sim = moe_simulate(cfg, params, name="mla", attention_kernels=(("prefill", "flash_attention"),))
    for mode in ("prefill", "decode"):
        emit({"phase": "mla", **sim[mode]})
    if not parity["first_logits_max_abs_diff_pinned"] <= parity["tol"]:
        fail(f"mla parity: first-token logits differ by "
             f"{parity['first_logits_max_abs_diff_pinned']} > {parity['tol']} on the same routes")
    if ok_first != parity["requests"]:
        fail("mla parity: a first token differs between kernels and plain versions beyond a "
             "near-tie, on the same routes")
    del params, model
    gc.collect()
    torch.cuda.empty_cache()
    train = mla_train(full)
    reduced["train_layers"] = [full.num_layers, MLA_TRAIN_LAYERS]
    emit({"phase": "mla", "part": "done", "arch": cfg.name, "seconds": time.perf_counter() - t0,
          "init": init, "reduced": reduced, "profile_db_entries": sim["profile_db_entries"],
          "gpu": gpu_name_and_power()})
    return {"serve": serve["launches"],
            "simulate": {k: sim["prefill"]["profiling_launches"][k]
                         + sim["decode"]["profiling_launches"][k] for k in serve["launches"]},
            "train": train["launches"], "serve_rec": serve}


def loss_and_grads(loss_fn, params, batch):
    """``(loss, gradients of every parameter leaf)``."""
    from repro_torch.training.optimizer import tree_leaves
    loss, _ = loss_fn(params, batch)
    return loss, torch.autograd.grad(loss, tree_leaves(params))


MLA_TRAIN_LAYERS = 1     # 13.36e9 parameters: 26.7 GB of bf16 weights and as much of gradients
MLA_TRAIN_SEQ = 2048


def mla_train(full) -> dict:
    """deepseek-v3-671b at full width and ``MLA_TRAIN_LAYERS`` layer through
    the trainer's loss and gradients (``make_loss_fn``, remat "block", B1
    S``MLA_TRAIN_SEQ``, no optimizer update: two layers would be 99 GB with
    their gradients): the forward's K1 and its backward at (192, 128), the
    backward's one call held against ``flash_attention_bwd_plain`` on its own
    inputs (fp32), the loss against a forward through the plain versions on
    the same routes (``RoutePin``), every gradient finite; then the profiling
    engine times the traced backward attention node through K1's backward.
    One JSON line, returned."""
    import gc
    from repro_torch import kernels as K
    from repro_torch.core.backend import profiling as P
    from repro_torch.core.model_ingest import ingest_graphs
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import flash_attention_bwd_plain
    from repro_torch.models import Model, count_params
    from repro_torch.training import SyntheticTokenPipeline, make_loss_fn
    from repro_torch.training.optimizer import tree_leaves
    gc.collect()
    torch.cuda.empty_cache()
    cfg = full.replace(num_layers=MLA_TRAIN_LAYERS)
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    model = Model(cfg, remat_policy="block")
    params = model.init(torch.Generator(device="cuda").manual_seed(SEED))
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    pipe = SyntheticTokenPipeline(cfg, global_batch=1, seq_len=MLA_TRAIN_SEQ, seed=SEED)
    batch = next(pipe)
    pipe.close()
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    calls = []
    orig = ops._flash_attention_bwd

    def keep(q, k, v, o, lse, do, *, causal, window, scale, **out):
        got = orig(q, k, v, o, lse, do, causal=causal, window=window, scale=scale, **out)
        calls.append(([t.detach().clone() for t in (q, k, v, o, lse, do)],
                      dict(causal=causal, window=window, scale=scale), [g.clone() for g in got]))
        return got

    pin = RoutePin()
    K.reset_launch_counts()
    ops._flash_attention_bwd = keep
    try:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        # the routes recorded through the backward too: remat "block" routes each
        # layer again as it recomputes it, and must save what the forward saved
        loss, grads = pin.run("record", loss_and_grads, make_loss_fn(model), params, batch)
        end.record()
        end.synchronize()
    finally:
        ops._flash_attention_bwd = orig
    launches = K.launch_counts()
    step_ms = start.elapsed_time(end)
    peak = torch.cuda.max_memory_allocated()
    loss_k = float(loss.detach())
    finite = all(bool(torch.isfinite(g).all()) for g in grads)
    grad_norm = float(torch.linalg.vector_norm(torch.stack(
        [torch.linalg.vector_norm(g, dtype=torch.float32) for g in grads])))
    del grads, loss
    gc.collect()
    torch.cuda.empty_cache()
    with torch.no_grad():
        loss_p = float(pin.run("replay", make_loss_fn(Model(cfg, plain_kernels=True)), params,
                               batch)[0])
    if 2 * pin.next != len(pin.calls):
        fail(f"mla train: the plain forward made {pin.next} dispatches, the kernels' forward "
             f"and recomputation {len(pin.calls)}")
    bwd = []
    for ins, kw, got in calls:
        want = flash_attention_bwd_plain(*(t.float() for t in ins[:4]), ins[4], ins[5].float(),
                                         **kw)
        B, H, Sq, _ = ins[0].shape
        # dQ of a query that sees one key is 0 by the arithmetic (as check_flash_bwd holds it)
        one_key = torch.from_numpy(visible_per_row(Sq, ins[1].shape[2], kw["causal"],
                                                   kw["window"]) <= 1)
        bwd.append({"shapes": [list(t.shape) for t in ins[:3]],
                    "max_abs_err": max(max_err(a, b) for a, b in zip(got, want)),
                    "scaled_err": scaled_err(got, want),
                    "row_err": row_err(got, want, [one_key.expand(B, H, Sq).reshape(-1)])})
        del want
    del calls
    # the profiling engine: the traced backward attention node at these dims
    node = next(n for b in ingest_graphs(cfg, 1, MLA_TRAIN_SEQ, "train").all_blocks()
                for n in (b.joint if b.joint is not None else b.fwd)
                if n.kind == "attention" and n.attrs.get("backward"))
    K.reset_launch_counts()
    price_us = P.synthesize_and_measure(node)
    price_launches = K.launch_counts()["flash_attention_bwd"]
    rec = {"phase": "mla", "part": "train", "arch": cfg.name, "layers": MLA_TRAIN_LAYERS,
           "params": count_params(cfg), "batch": 1, "seq": MLA_TRAIN_SEQ, "remat": "block",
           "optimizer": None, "init_s": init_s, "loss_and_grad_ms": step_ms, "peak_bytes": peak,
           "loss_kernels": loss_k, "loss_plain_same_routes": loss_p,
           "loss_abs_diff": abs(loss_k - loss_p), "loss_tol": 1e-2, "grads_finite": finite,
           "grad_norm": grad_norm, "launches": launches, "k1_bwd_calls": bwd,
           "k1_bwd_tol": {"scaled_err": TOL[torch.bfloat16], "row_err": ROW_TOL[torch.bfloat16]},
           "profiling_bwd_node": {"key": P.node_key(node, "h100_sxm"), "us": price_us,
                                  "flash_attention_bwd_launches": price_launches},
           "seconds": time.perf_counter() - t0, "gpu": gpu_name_and_power()}
    emit(rec)
    if launches["flash_attention_bwd"] != MLA_TRAIN_LAYERS or len(bwd) != MLA_TRAIN_LAYERS:
        fail(f"mla train: K1's backward launched {launches['flash_attention_bwd']} times, "
             f"{MLA_TRAIN_LAYERS} expected")
    if not all(b["scaled_err"] <= TOL[torch.bfloat16] and b["row_err"] <= ROW_TOL[torch.bfloat16]
               for b in bwd):
        fail(f"mla train: K1's backward against its plain version: {bwd}")
    if not (finite and math.isfinite(loss_k) and abs(loss_k - loss_p) <= 1e-2):
        fail(f"mla train: loss {loss_k} (kernels) against {loss_p} (plain), grads finite {finite}")
    if not (price_us is not None and price_us > 0 and price_launches > 0):
        fail(f"mla train: the profiling engine did not time the backward node: {price_us}")
    del params, leaves, model
    gc.collect()
    torch.cuda.empty_cache()
    return rec


# The dense GQA decoders of the paper's main path that the other phases do not run, each
# served at full width and depth and trained at full width.
DENSE_ARCHS = ("gemma-7b", "qwen2.5-32b", "yi-34b")
# The train part's depth, the most layers the card holds: AdamW holds 12 bytes a parameter
# (bf16 p and g, fp32 m and v), and the card 85.0e9 bytes.  At B1 S2048, remat "block", the
# step's peak on an H100 was 72.5e9 bytes at 18 layers of gemma-7b and 72.0e9 at 9 of
# qwen2.5-32b and of yi-34b, beside the port's simulator's 72.5e9, 74.9e9 and 74.9e9:
#   gemma-7b: 3.32 GB a layer, 9.4 GB the tied embedding; all 28 layers 102 GB; 20 layers
#     are 6,323,039,232 parameters, 79.4 GB (21 would be 82.8)
#   qwen2.5-32b: 5.85 GB a layer, 18.7 GB the embedding and head; all 64 layers 393 GB; 10
#     layers are 6,433,192,960 parameters, 78.0 GB (11 would be 83.9)
#   yi-34b: 6.69 GB a layer, 11.0 GB the embedding and head; all 60 layers 413 GB; 10 layers
#     are 6,496,078,848 parameters, 78.7 GB (11 would be 85.5)
DENSE_TRAIN_LAYERS = {"gemma-7b": 20, "qwen2.5-32b": 10, "yi-34b": 10}
# the train step's parity, kernels against plain versions: two runs of the step side by
# side hold two trees of gradients and of fp32 changes (6 bytes a parameter each) beside the
# parameters; at 2 layers qwen2.5-32b is 2,532,384,768 parameters, its embedding and head
# 1,557,135,360 of them
DENSE_PARITY_LAYERS = 2
# the serve launcher at its own default --arch, with the flags the README gives it on the card
SERVE_LAUNCHER_ARGV = ("--full", "--requests", "12", "--slots", "8", "--cache-len", "2048",
                       "--max-new", "32", "--prompt-len", "1024")


def dense_launcher_serve(cfg) -> dict:
    """``repro_torch.launch.serve.main`` run as a user runs it, at its default
    ``--arch`` with ``SERVE_LAUNCHER_ARGV`` (its own weights from its seed, its
    own requests): what it printed, which must name ``cfg``'s arch (the
    launcher's default), every request finished with its 32 tokens, the
    launches against the path's formula (K1 L a prefill, K2 L a decode step,
    K3 2L + 1 a call; the engine's steps read from K2's count), seconds with
    the init, peak memory."""
    import io
    from repro_torch import kernels as K
    from repro_torch.launch import serve as launcher
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    printed = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(printed):
        finished = launcher.main(list(SERVE_LAUNCHER_ARGV))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = K.launch_counts()
    L = cfg.num_layers
    steps = counts["decode_attention"] // L
    want = {"flash_attention": L * len(finished), "decode_attention": L * steps,
            "rmsnorm": (2 * L + 1) * (len(finished) + steps), "flash_attention_bwd": 0,
            "rmsnorm_bwd": 0, "adamw": 0, "adafactor": 0}
    lines = printed.getvalue().splitlines()
    rec = {"part": "launcher_serve", "argv": list(SERVE_LAUNCHER_ARGV), "printed": lines,
           "requests": len(finished), "new_tokens": sum(len(r.tokens) for r in finished),
           "engine_steps": steps, "seconds_with_init": seconds,
           "peak_bytes": torch.cuda.max_memory_allocated(), "launches": counts,
           "launches_expected": want, "gpu": gpu_name_and_power()}
    emit({"phase": "dense", **rec})
    if not (lines and lines[0].startswith(f"[{cfg.name} on cuda")):
        fail(f"dense launcher_serve: the launcher's default arch is not {cfg.name}: {lines}")
    if len(finished) != 12 or any(len(r.tokens) != 32 or not all(0 <= t < cfg.vocab_size
                                                                 for t in r.tokens)
                                  for r in finished):
        fail(f"dense launcher_serve: not 12 requests of 32 tokens in the vocabulary: {rec}")
    if counts != want:
        fail(f"dense launcher_serve: launch counts {counts} differ from what the path implies "
             f"{want}")
    torch.cuda.empty_cache()
    return rec


def dense_model(arch: str, problems: list) -> dict:
    """One dense decoder on the card, random bf16 weights from the seed made
    once and shared by the first three parts, a line a part: serve
    (``moe_serve`` at full width and depth: K1 L a prefill, K2 L a decode
    step, K3 2L + 1 a call, no host sync in a decode step), parity
    (``full_depth_parity``: its failed checks go to ``problems``), simulate
    (``moe_simulate``: prefill B1 S512 and decode B8 at 2048, analytical and
    profiling, against the port's own steps); then, with those weights freed,
    the serve launcher where ``arch`` is its default (``dense_launcher_serve``),
    train (``phase_train``: one timed AdamW step of the train launcher's
    Trainer at B1 S2048, remat "block", width never cut, depth cut to
    ``DENSE_TRAIN_LAYERS``) against both engines (``train_versus``), and the
    train step's parity on ``DENSE_PARITY_LAYERS`` layers
    (``phase_train_parity``: loss, every gradient leaf, AdamW's change); then
    a closing line.  Returns the launches of each part."""
    import gc
    from repro_torch import kernels as K
    from repro_torch.configs import get_config
    from repro_torch.models import Model, count_params
    gc.collect()
    torch.cuda.empty_cache()
    cfg = get_config(arch)
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    model = Model(cfg)
    params = model.init(torch.Generator(device=model.device).manual_seed(SEED))
    torch.cuda.synchronize()
    init = {"allocated_bytes": torch.cuda.memory_allocated(),
            "peak_bytes": torch.cuda.max_memory_allocated()}
    parts = {"init_s": time.perf_counter() - t0}

    def part(name):
        parts[name] = time.perf_counter() - t0 - sum(parts.values())

    serve = moe_serve(cfg, params, phase="dense")
    part("serve_s")
    parity, failed = full_depth_parity(cfg, params, float32=True)
    problems.extend(failed)
    emit({"phase": "dense", **parity})
    part("parity_s")
    sim = moe_simulate(cfg, params, name="dense")
    for mode in ("prefill", "decode"):
        emit({"phase": "dense", "arch": cfg.name, **sim[mode]})
    part("simulate_s")
    del params, model
    gc.collect()
    torch.cuda.empty_cache()
    out = {}
    if arch == DENSE_ARCHS[0]:      # the serve launcher's default (which it checks)
        out["launcher_serve"] = dense_launcher_serve(cfg)["launches"]
        part("launcher_serve_s")
    layers = DENSE_TRAIN_LAYERS[arch]
    train = phase_train(arch, phase="dense_train", timed_steps=1, layers=layers)
    versus = train_versus(cfg.replace(num_layers=layers), train, "dense", profiling=True)
    part("train_s")
    K.reset_launch_counts()
    tp = phase_train_parity(arch, phase="dense_train_parity", tree_times=False,
                            layers=DENSE_PARITY_LAYERS)
    tp_launches = K.launch_counts()
    part("train_parity_s")
    if min(tp_launches["flash_attention_bwd"], tp_launches["rmsnorm_bwd"],
           tp_launches["adamw"]) <= 0:
        fail(f"dense train_parity {arch}: a backward kernel or AdamW was not launched: "
             f"{tp_launches}")
    emit({"phase": "dense", "part": "done", "arch": cfg.name, "params": count_params(cfg),
          "layers_served": cfg.num_layers, "layers_trained": layers,
          "train_params": train["params"], "train_launcher_argv": train["launcher_argv"],
          "train_launcher_default_arch": train["launcher_default_arch"],
          "parity_layers": DENSE_PARITY_LAYERS, "seconds": time.perf_counter() - t0,
          "parts_s": parts, "init": init, "serve_peak_bytes": serve["peak_bytes"],
          "train_peak_bytes": train["peak_bytes"],
          "signed_error_vs_device_busy": {
              "prefill": sim["prefill"]["signed_error"], "decode": sim["decode"]["signed_error"],
              "train": versus["signed_error"]},
          "profile_db_entries": sim["profile_db_entries"], "gpu": gpu_name_and_power()})
    out.update(serve=serve["launches"],
               simulate={k: sim["prefill"]["profiling_launches"][k]
                         + sim["decode"]["profiling_launches"][k] for k in serve["launches"]},
               train=train["launches_per_step"], simulate_train=versus["profiling_launches"],
               train_parity=tp_launches)
    return out


def phase_dense() -> dict:
    """gemma-7b, qwen2.5-32b and yi-34b in turn (``dense_model``); the parity
    checks that failed fail the phase after every model has printed.  The
    serve launcher's default is gemma-7b and the train launcher's qwen2.5-32b
    (``phase_train`` builds that Trainer without ``--arch``)."""
    from repro_torch.launch import train as T
    if T.parse_args([]).arch not in DENSE_ARCHS:
        fail(f"dense: the train launcher's default {T.parse_args([]).arch} is not one of "
             f"{DENSE_ARCHS}")
    problems: list = []
    out = {arch: dense_model(arch, problems) for arch in DENSE_ARCHS}
    if problems:
        fail(f"dense parity: {problems}")
    if "launcher_serve" not in out[DENSE_ARCHS[0]]:
        fail("dense: the serve launcher did not run")
    return out


KERNEL_INFO = {
    "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:104"),
    "decode_attention": ("src/repro_torch/kernels/csrc/decode_attention.cu",
                         "src/repro/kernels/decode_attention.py:67"),
    "rmsnorm": ("src/repro_torch/kernels/csrc/rmsnorm.cu",
                "src/repro/kernels/rmsnorm.py:45"),
    # the backward of K1 and K3: the TPU kernels are forward only, and the
    # reference differentiates its plain attention and norm instead
    "flash_attention_bwd": ("src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
                            "src/repro/kernels/flash_attention.py:104"),
    "rmsnorm_bwd": ("src/repro_torch/kernels/csrc/rmsnorm.cu",
                    "src/repro/kernels/rmsnorm.py:45"),
    # no TPU kernel: the reference's AdamW update is array code XLA fuses
    "adamw": ("src/repro_torch/kernels/csrc/adamw.cu", "src/repro/training/optimizer.py:79"),
    # no TPU kernel: the reference's Adafactor update is array code XLA fuses
    "adafactor": ("src/repro_torch/kernels/csrc/adafactor.cu",
                  "src/repro/training/optimizer.py:104"),
}
# kernels whose main path is training, with what they stand for
TRAIN_ONLY = {
    "flash_attention_bwd": "backward of K1; the TPU kernel has none (the reference trains "
                           "through src/repro/models/layers.py:241-250)",
    "rmsnorm_bwd": "backward of K3; the TPU kernel has none (the reference trains through "
                   "src/repro/models/layers.py:31)",
    "adamw": "the training step's fused AdamW update; it replaces no TPU kernel (the "
             "reference's update is array code at the line named, which XLA fuses)",
    "adafactor": "Adafactor's update of a layer group in 2 or 3 launches (g read twice where the "
                 "statistics' guard holds); it replaces no TPU kernel "
                 "(the reference's update is array code at the line named, which XLA fuses); "
                 "its main path is recurrentgemma-9b's train step (griffin_train)",
}


# seconds each phase of this run took, by name (``clocked``)
PHASE_SECONDS: dict = {}


def clocked(name: str, fn):
    """``fn``, which when called adds its seconds to ``PHASE_SECONDS[name]``."""
    def call(*args, **kw):
        t0 = time.perf_counter()
        try:
            return fn(*args, **kw)
        finally:
            PHASE_SECONDS[name] = PHASE_SECONDS.get(name, 0.0) + time.perf_counter() - t0
    return call


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases",
                    default="env,build,kernels,serve,parity,train,train_parity,simulate,"
                            "serve_sim,sweep,moe,griffin,dryrun,griffin_train,xlstm,whisper,"
                            "vlm,mla,dense",
                    help="comma-separated subset of env,build,kernels,serve,parity,train,"
                         "train_parity,simulate,serve_sim,sweep,moe,griffin,dryrun,"
                         "griffin_train,xlstm,whisper,vlm,mla,dense (and times, the serving-shape "
                         "timings alone; k2_parts and k1_parts, the kernels phase's part "
                         "times alone; adafactor, its Adafactor checks alone; serve_measure, "
                         "the measured side of serve_sim alone; "
                         "mla_layout, the mla phase's first part alone); the closing lines are "
                         "printed only when the nineteen of the default ran")
    ap.add_argument("--baseline-src", metavar="DIR", default=None,
                    help="also time the serving-shape kernels of the tree at DIR beside this "
                         "tree's, in turns, on this card")
    ap.add_argument("--variant", metavar="PATCH", action="append", default=[],
                    help="with --baseline-src: also time the tree at DIR with this unified "
                         "diff applied, in the same turns (repeatable; e.g. a patch under "
                         "src/repro_torch/kernels/variants/)")
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
        rec = {}
        if args.ptxas:
            for name, log in logs.items():
                print(f"--- nvcc {name}.cu ---\n{log}", file=sys.stderr)
            rec["decode_tc_ptxas"] = ptxas_report(logs.get("decode_attention", ""),
                                                  DEC_TC_FUNCTION, "decode_tc_kernel")
            rec["decode_fma_ptxas"] = ptxas_report(logs.get("decode_attention", ""),
                                                   DEC_FMA_ANY, "decode_kernel")
            rec["flash_tc_ptxas"] = ptxas_report(logs.get("flash_attention", ""), FWD_TC_ANY,
                                                 "flash_fwd_kernel")
            rec["flash_bwd_wg_ptxas"] = ptxas_report(logs.get("flash_attention_bwd", ""),
                                                     BWD_WG_ANY, "flash_bwd_wg_kernel")
            rec["adafactor_ptxas"] = ptxas_report(logs.get("adafactor", ""), AF_ANY,
                                                  "adafactor")
            # ptxas's notes that it issues a kernel's wgmma groups one after another
            # (C75xx "Potential Performance Loss"), by mangled name: no spill, but on record
            rec["wgmma_serialized"] = {
                m[2]: m[1] for log in logs.values()
                for m in re.finditer(r"\((C75\d\d)\) Potential Performance Loss.*?function '(\S+)'",
                                     log)}
        emit({"phase": "build", "seconds": _build.build_seconds, "sources": list(_build.SOURCES),
              "build_dir": os.path.relpath(_build.build_dir(), HERE), **rec})
        spilled = {k: r for key in ("decode_tc_ptxas", "decode_fma_ptxas", "flash_tc_ptxas",
                                    "flash_bwd_wg_ptxas")
                   for k, r in rec.get(key, {}).items()
                   if r.get("spill_stores") or r.get("spill_loads")}
        if spilled:
            fail(f"kernels spill: {spilled}")
        sass_check()
    if "times" in phases:
        clocked("times", phase_times)()
    if "k2_parts" in phases:
        emit({"phase": "k2_parts", "src": SRC,
              "k2_parts": clocked("k2_parts", k2_parts)(np.random.default_rng(SEED + 2))})
    if "k1_parts" in phases:
        parts = clocked("k1_parts", k1_parts)(np.random.default_rng(SEED + 4))
        emit({"phase": "k1_parts", "src": SRC, "gpu": smi, "k1_parts": parts})
        if not all(check_ok(r) for r in parts):
            fail(f"K1 at the part shapes: off its plain version: {parts}")
    if "adafactor" in phases:
        af_recs, _ = clocked("adafactor_checks", adafactor_checks)()
        emit({"phase": "adafactor", "gpu": smi, "checks": af_recs})
        if not all(check_ok(r) for r in af_recs):
            fail(f"Adafactor's kernels off their plain version: {af_recs}")
    if "serve_measure" in phases:
        clocked("serve_measure", phase_serve_measure)()
    if args.variant and not args.baseline_src:
        fail("--variant needs --baseline-src: a patch applies to the tree there")
    if args.baseline_src:
        clocked("baseline", phase_baseline)(args.baseline_src, args.variant)
    main_recs = counts = None
    if "kernels" in phases:
        _, main_recs = clocked("kernels", phase_kernels)()
    if "serve" in phases:
        counts = clocked("serve", phase_serve)()
    if args.profile:
        clocked("profile", phase_profile)(args.profile)
    if "parity" in phases:
        clocked("parity", phase_parity)()
    train = clocked("train", phase_train)() if "train" in phases else None
    train_parity = clocked("train_parity", phase_train_parity)() \
        if "train_parity" in phases else None
    sim = clocked("simulate", phase_simulate)(train) if "simulate" in phases else None
    serve_sim = clocked("serve_sim", phase_serve_sim)() if "serve_sim" in phases else None
    swept = clocked("sweep", phase_sweep)() if "sweep" in phases else None
    moe = clocked("moe", phase_moe)() if "moe" in phases else None
    griffin = clocked("griffin", phase_griffin)(keep="dryrun" in phases) \
        if "griffin" in phases else None
    dryrun = clocked("dryrun", phase_dryrun)(griffin.pop("params", None) if griffin else None) \
        if "dryrun" in phases else None
    griffin_train = clocked("griffin_train", phase_griffin_train)() \
        if "griffin_train" in phases else None
    xlstm = clocked("xlstm", phase_xlstm)() if "xlstm" in phases else None
    whisper = clocked("whisper", phase_whisper)() if "whisper" in phases else None
    vlm = clocked("vlm", phase_vlm)() if "vlm" in phases else None
    if "mla_layout" in phases:
        clocked("mla_layout", mla_layout)()
    mla = clocked("mla", phase_mla)() if "mla" in phases else None
    dense = clocked("dense", phase_dense)() if "dense" in phases else None
    if (main_recs is None or counts is None or "parity" not in phases or train is None
            or train_parity is None or sim is None or serve_sim is None or swept is None
            or moe is None or griffin is None or dryrun is None or griffin_train is None
            or xlstm is None
            or whisper is None or vlm is None or mla is None or dense is None):
        emit({"phase": "seconds", **PHASE_SECONDS})
        print("chip_smoke: partial run, no closing lines", file=sys.stderr)
        return 0

    # launches by the simulator's profiling engine: K1 in the prefill's run,
    # K2 in the decode's, K1's backward in the train's, K3 on the hand-built
    # norm nodes; K3's backward none (the tracer emits no norm node, as the
    # reference's does not)
    sim_launches = {"flash_attention": sim["prefill"]["profiling_launches"]["flash_attention"],
                    "decode_attention": sim["decode"]["profiling_launches"]["decode_attention"],
                    "rmsnorm": sim["synthesized_launches"]["rmsnorm"],
                    "flash_attention_bwd":
                        sim["train"]["profiling_launches"]["flash_attention_bwd"],
                    "rmsnorm_bwd": sim["train"]["profiling_launches"]["rmsnorm_bwd"],
                    # the simulator prices the optimizer from its bytes; it times no update
                    "adamw": sim["train"]["profiling_launches"]["adamw"],
                    "adafactor": sim["train"]["profiling_launches"]["adafactor"]}
    kernels = []
    for name, (source, replaces) in KERNEL_INFO.items():
        r = main_recs[name]
        # a forward kernel's main path is serving; a backward kernel's, and the
        # optimizer's, training
        launches = train["launches"][name] if name in TRAIN_ONLY else counts[name]
        if name == "adafactor":     # recurrentgemma-9b's train step, three steps
            launches = griffin_train["train_rec"]["launches"][name]
        if launches <= 0:
            fail(f"kernel {name} was not launched on its main path")
        rec = {"name": name, "route": "cuda", "source": source, "replaces": replaces,
               "launches": launches, "train_launches": train["launches"][name],
               "simulate_launches": sim_launches[name],
               "serve_sim_launches": serve_sim["profiling"]["launches"].get(name, 0),
               "sweep_launches": swept["launches"][name],
               # olmoe-1b-7b: serving (forward kernels), the profiling engine's
               # measurements, and the 4-layer train step through the kernels
               "moe_launches": {part: moe[part][name]
                                for part in ("serve", "simulate", "train_parity")},
               # deepseek-v3-671b cut to 2 layers: serving, and the profiling
               # engine's measurements (K1 at (192, 128) in its prefill); cut to 1
               # layer: the loss and gradients (K1's backward at (192, 128))
               "mla_launches": {part: mla[part][name]
                                for part in ("serve", "simulate", "train")},
               # recurrentgemma-9b at full width and depth: serving, and the profiling
               # engine's measurements (K1 in its prefill, K2 at G = 16 in its decode);
               # the Adafactor train step (a step), the int8 step, and the profiling
               # engine's train measurements (K1 and its backward at G 16, D 256)
               "griffin_launches": {
                   **{part: griffin[part][name] for part in ("serve", "simulate")},
                   "train": griffin_train["train"][name],
                   "train_int8": griffin_train["train_int8"][name],
                   "simulate_train": griffin_train["simulate"][name]},
               # recurrentgemma-9b long_500k: the dryrun phase's decode step at full
               # width and depth (K2 and K3), the cell its roofline bounds
               "dryrun_launches": {"cell": dryrun["cell"][name]},
               # xlstm-125m at full width and depth: serving (K3 only), the profiling
               # engine's measurements, and the launcher's train step (a step)
               "xlstm_launches": {part: xlstm[part][name]
                                  for part in ("serve", "simulate", "train")},
               # whisper-large-v3 at full width and depth: the transcription (one B8
               # prefill and 123 decode steps), the profiling engine's measurements, and
               # the launcher's train step (a step)
               "whisper_launches": {part: whisper[part][name]
                                    for part in ("transcribe", "simulate", "train")},
               # qwen2-vl-7b at full width and depth: serving (text only), the multimodal
               # prefill and its 32 decode steps, the profiling engine's measurements,
               # and the launcher's train step at 12 layers (a step)
               "vlm_launches": {part: vlm[part][name]
                                for part in ("serve", "multimodal", "simulate", "train")},
               "max_abs_err": r["max_abs_err"],
               "ms": r["ms"], "device_ms": r["device_ms"], "plain_ms": r["plain_ms"],
               "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
               "library_ms": r["library_ms"],
               "library_device_ms": r["library_device_ms"],
               "shape": r["case"], "dtype": r["dtype"]}
        for key in ("scaled_err", "row_err", "row_tol", "dropped_tile_row_err"):
            if key in r:
                rec[key] = r[key]
        if name == "flash_attention_bwd":
            # the profiling engine's price of a backward attention node (one
            # layer at the train shape, timed in a CUDA graph) beside this
            # kernel's device time at that shape
            price = sim["train"]["bwd_attention_us_a_layer"]
            rec["simulate_price_us_a_layer"] = price
            rec["simulate_price_vs_device_ms"] = price / 1e3 / r["device_ms"] - 1.0
        moe_rec = main_recs.get(f"moe_{name}")
        if moe_rec is not None:
            # the same kernel at olmoe-1b-7b's serving shape
            rec["moe_shape"] = {k: moe_rec[k] for k in (
                "case", "max_abs_err", "ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms", "library_device_ms")}
        mla_rec = main_recs.get(f"mla_{name}")
        if mla_rec is not None:
            # the same kernel at deepseek-v3-671b's prefill shape (K1 at (192, 128),
            # K3 at D 7168 with the sum)
            rec["mla_shape"] = {k: mla_rec.get(k) for k in (
                "case", "max_abs_err", "ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms", "library_device_ms", "library_kernels")}
        dryrun_rec = main_recs.get(f"dryrun_{name}")
        if dryrun_rec is not None:
            # the same kernel at the dryrun cell's decode (K2 at B1, G 16, the
            # full ring of 2048 rows)
            rec["dryrun_shape"] = {k: dryrun_rec.get(k) for k in (
                "case", "splits", "chunk", "max_abs_err", "ms", "device_ms", "plain_ms",
                "bound_ms", "bound_by", "library_ms", "library_device_ms")}
        griffin_rec = main_recs.get(f"griffin_{name}")
        if griffin_rec is not None:
            # the same kernel at recurrentgemma-9b's serving shapes (K1 at H16 Hkv1 D256
            # with its window, K2 at G = 16, K3 at D 4096 in the 1 + w form)
            rec["griffin_shape"] = {k: griffin_rec.get(k) for k in (
                "case", "max_abs_err", "ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms", "library_device_ms")}
        gemma_rec = main_recs.get(f"gemma_{name}")
        if gemma_rec is not None:
            # K1's backward at gemma-7b's train shape (16 heads of 256, G 1, B1 S2048)
            rec["gemma_shape"] = {k: gemma_rec.get(k) for k in (
                "case", "max_abs_err", "ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms", "library_device_ms")}
        for key, label in ((f"xlstm_{name}", "xlstm_shape"),
                           (f"xlstm_add_{name}", "xlstm_shape_add")):
            xlstm_rec = main_recs.get(key)
            if xlstm_rec is not None:
                # the same kernel at xlstm-125m's width (D 768): out_norm (no
                # residual), ln with the sum written, the backward at the train rows
                rec[label] = {
                    k: xlstm_rec.get(k) for k in (
                        "case", "max_abs_err", "ms", "device_ms", "plain_ms", "bound_ms",
                        "bound_by", "library_ms", "library_device_ms")}
        for part in ("enc", "cross", "self", "enc_b8", "cross_b8"):
            whisper_rec = main_recs.get(f"whisper_{part}_{name}")
            if whisper_rec is not None:
                # the same kernel at whisper-large-v3's shapes (D 64, G 1): K1 at the
                # encoder's 1500 x 1500 and the cross attention's 224 x 1500 at B1, and
                # at the B8 train step's three (the decoder's self attention 448 x 448),
                # K2 at the self ring of 448 and the encoder's 1500 rows, K1's backward
                # at B8
                rec[f"whisper_shape_{part}"] = {k: whisper_rec.get(k) for k in (
                    "case", "max_abs_err", "ms", "device_ms", "plain_ms", "bound_ms",
                    "bound_by", "library_ms", "library_device_ms")}
        vlm_rec = main_recs.get(f"vlm_{name}")
        if vlm_rec is not None:
            # the same kernel at qwen2-vl-7b's shapes (G 7 at D 128, K3 at D 3584 with
            # the sum): K1 at the serving prefill, K2 at the serving ring, the
            # backward kernels at the train shape B1 S2048
            rec["vlm_shape"] = {k: vlm_rec.get(k) for k in (
                "case", "max_abs_err", "ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms", "library_device_ms")}
        # gemma-7b, qwen2.5-32b and yi-34b (the dense phase): serving at full width and
        # depth, the profiling engine's prefill and decode, the serve launcher at its default
        # (gemma-7b), the train step at the cut depth (a step), the profiling engine's train
        # step, and the 2-layer train parity
        rec["dense_launches"] = {arch: {part: n[name] for part, n in parts.items()}
                                 for arch, parts in dense.items()}
        rec["dense_shapes"] = [{k: c.get(k) for k in (
            "arch", "case", "dtype", "path", "splits", "max_abs_err", "ms", "device_ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms", "library_device_ms")}
            for c in main_recs["dense"] if c["kernel"].replace("add_", "") == name]
        if name == "adafactor":
            # the largest 12-layer group, the bounds of five and six passes (g read
            # twice or three times, p twice), and the update over recurrentgemma-9b's
            # whole tree
            group = main_recs["adafactor_group"]
            rec["five_pass_bound_ms"] = r["five_pass_bound_ms"]
            rec["six_pass_bound_ms"] = r["six_pass_bound_ms"]
            rec["update_rel_l2"] = r["update_rel_l2"]
            rec["group_shape"] = {k: group.get(k) for k in (
                "case", "max_abs_err", "ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
                "five_pass_bound_ms", "six_pass_bound_ms", "library_ms", "library_device_ms")}
            rec["tree_update_device_ms"] = griffin_train["train_rec"]["optimizer_device_ms"]
        if name in TRAIN_ONLY:
            rec["note"] = TRAIN_ONLY[name]
        kernels.append(rec)
    emit({"phase": "seconds", **PHASE_SECONDS})
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
