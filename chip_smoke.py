#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``paddle_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing JSON lines:
  1. device  — the card's name and count; nvidia-smi's name and power limit
               follow on a line of their own.
  2. build   — builds every CUDA kernel of the port with nvcc, one process
               per source, all started together; build seconds, ptxas'
               register/spill report and, from cuobjdump -sass, each
               kernel's count of wgmma (HGMMA) and TMA load (UTMALDG)
               instructions. Fails if a bf16 instantiation of flash_fwd,
               flash_bwd_dkv or flash_bwd_dq spills, or if any of them has no
               HGMMA or no UTMALDG: the proof that they are the wgmma + TMA
               designs.
  3. kernel  — each kernel against its plain PyTorch version on the card, on
               the cases listed in CASES (forward; the backward pair on the
               same cases plus BWD_BLOCK_CASE, through
               flash_attention_bwd_block at global offsets), with the
               tolerances stated there; at the serving slice's shape and at
               the NMT Transformer's two (nmt_enc: non-causal with ragged
               kv_len, nmt_dec: causal; 32 x 8 x 256 x 64) also each
               kernel's time, the plain version's, one PyTorch library
               call's (F.scaled_dot_product_attention, forward or backward,
               with a key mask for kv_len: a yardstick the port never
               calls), the bound (the least time the card could take) and
               the host time of one wrapper call (TMA descriptors and
               launch included).
  4. slice   — the serving slice at the LM's published width (BASE_CFG:
               d_model 512, 8 heads, 6 layers, vocab 32000, random weights
               from a seed): get_model -> Model.init on CUDA -> generate() of
               8 prompts x 1024 tokens, 32 new tokens, greedy, flash +
               bf16 on. Every kernel's launch count is set to 0 just before
               generate() and read just after.
  5. train   — the training slice at BASE_CFG: Model.init -> the spec's
               optimizer (Adam) -> minimize -> one step on 8 x 1024 tokens,
               flash + bf16 + check_nan_inf on, with every launch count set
               to 0 just before the step and read just after; then 8 steps
               on the fixed batch (the loss must fall), the step time,
               tokens/s and peak memory (check_nan_inf off, as bench.py
               steps), and the loss and gradients of one
               step against composed attention and against the recomputed
               (unfused) flash backward.
  6. trainer — the trainer slice through Trainer(...).train(), flash + bf16
               + check_nan_inf on. The LM at BASE_CFG: a reader of 4 batches
               of 8 x 1024 tokens, 2 epochs, CheckpointConfig(step_interval=4,
               max_num_checkpoints=2) in a temporary directory; launch counts
               set to 0 just before train() and read around every step (6 of
               each kernel per step); the first step's loss against a direct
               minimize step on the same weights and batch; a fresh Trainer
               that auto-resumes from a copy of the directory taken at the
               epoch boundary ends epoch 1 with the uninterrupted run's
               parameters and Adam slots; the Trainer's step ms against the
               direct step's; checkpoint save and load seconds and bytes;
               peak memory. Then the MNIST conv net (get_model("mnist"),
               f32) through the Trainer, batch 64, 8 steps on one batch: the
               loss falls.
  7. conv    — the conv zoo, with PyTorch's TF32 switches at their defaults
               (the port's f32 products run in full f32 regardless):
               (a) ResNet-50 at bench.py's cell (224x224x3 NHWC, 1000
               classes, bf16 compute, Momentum, synthetic flowers-shaped
               batches): one minimize step whose BN moving statistics all
               change and stay finite, 8 steps on one batch (the loss
               falls), the step time (best of 3 after warm steps, host clock
               + sync), images/s, MFU against the bf16 dense peak (FLOPs per
               image counted from the conv and fc shapes, 3x the forward)
               and peak memory at batch 64 and 128; (b) f32 parity: one
               ResNet-50 step at 64x64, batch 4, on the card against the same
               step on the CPU (loss, gradients, new BN state; see
               CONV_PARITY_*); (c) ResNet-50 through Trainer.train, batch 64,
               2 epochs x 2 batches, a checkpoint every 2 steps, and a
               resumed Trainer held to the spread of two uninterrupted runs
               (cuDNN's deterministic algorithms on for this part only);
               (d) SE-ResNeXt-50 and VGG-16 at 224x224, 102 classes, batch
               32, 4 minimize steps each with dropout drawing from a seeded
               CUDA generator: the losses are finite and a later one is
               below the first (see ZOO_STEPS); (e) one bf16
               amp_minimize step of ResNet-50 against the bf16 minimize
               step on the same batch and weights (those after (a)'s 8
               steps).
  8. nmt     — the NMT Transformer at bench.py's cell: get_model("transformer",
               seq_len=256, scan_layers=True), BASE_CFG at full depth and
               width, batch 32, bf16 compute and flash on, Adam + Noam.
               (a) the published dropouts (0.1) through minimize's step with
               a CUDA generator: 0 flash launches (attention composes), the
               loss falls over 8 steps, step ms (best of 3 after a warm
               step), tokens/s, MFU against the bf16 dense peak (FLOPs
               counted from the shapes), peak memory, and no f32 GEMM
               kernel among the step's products (torch.profiler); (b) every
               dropout at 0: 18 launches of each kernel per step, and the
               loss and gradients of flash (structural masks) against
               composed attention (additive masks); (c) eval at the
               published config: 18 forward launches, and the loss and the
               non-pad logits flash against composed; (d) attention dropout:
               the keep rate of one call's mask and the expectation over
               mask draws, each within 4 sigma.
  9. rnn     — stacked_dynamic_lstm and machine_translation at their
               get_model defaults, batch 32, f32: the loss falls over 8
               Adam steps, step ms (best of 3), words/s, kernel launches per
               step, peak memory; then machine_translation's beam-search
               model (beam 4, 32 steps) on the trained weights, on the card
               and on the CPU in lockstep: the tokens are equal, or where a
               row first differs the two candidates' scores are within
               BEAM_TIE_TOL (a near tie); the entry point's result equals
               the card's lockstep result.
 10. serve   — decode serving at BASE_CFG (f32 weights and pages, greedy)
               through DecodeEngine(max_slots=16, page_size=16,
               max_context=1024, prefill_chunk=256): (a) 48 requests
               submitted together (prompt lengths uniform in [16, 768],
               max_new_tokens in [8, 128], numpy seed 0): generated tokens/s,
               TTFT and per-token latency p50/p99 from the waterfall, the
               decode step's ms at full occupancy and its launches, the idle
               share (the same burst again under torch.profiler),
               preemptions, peak memory, one step shape, 0 flash launches
               (the engine composes attention), and 12 requests against
               generate() with flash off; (b) the burst on a starved pool
               (3 slots' pages + scratch): preemptions > 0; (c) 16 requests
               sharing a 512-token prefix, with the prefix cache (hits >= 15
               x 512 tokens) and without; (d) 8 requests with spec_tokens 4,
               the target as its own draft: acceptance rate; (e)
               generate_beam (batch 4, prompts of 257, beam 4, 32 tokens):
               6 flash-forward launches, flash against composed in lockstep.
               Tokens of two runs are equal, or first differ at a near tie
               (SERVE_TIE_TOL); no page leaks after any run.
 11. dp      — data parallelism (paddle_tpu_torch.parallel): (a) the LM at
               BASE_CFG (8 x 1024, flash + bf16, Adam) on one rank of a real
               NCCL process group (a FileStore in a temporary directory):
               DataParallel's step against minimize's on the same weights
               and batch, bit for bit (loss, every parameter, both Adam
               slots), with and without ZeRO-1, 6 launches of each kernel;
               step ms (best of 3, in turns with the direct step), the NCCL
               kernels' device ms (torch.profiler), the gathered logits'
               bytes, peak memory; (b) two ranks spawned on the one card
               over gloo (each cuda:0, 4 x 1024 rows), 3 steps plain and
               with ZeRO-1, against the one-rank run on the same 8 x 1024
               batch: losses within TRAIN_LOSS_TOL; per parameter, Adam's
               first moment (a running mean of the reduced gradients)
               within TRAIN_GRAD_TOL and the update (the distance from the
               one-rank run's parameters over how far that run moved them)
               within DP_MOVEMENT_TOL (see dp_agreement), limits that a
               control, rank 0's rows alone with no reduction, must
               exceed; the replicas bit-equal, ZeRO-1 bit-equal to plain
               with half the slot bytes; the ZeRO-1 run saves a sharded
               checkpoint, sync and async, timed (with several ranks an
               async save blocks the step for the whole save); (c)
               ResNet-50 at 64 x 64, batch 8, f32, one step on two gloo
               ranks (BN statistics over both) against one rank: the loss
               (CONV_PARITY_LOSS), the new BN statistics and the
               parameters' movement within CONV_PARITY_* of the card's own
               spread under a 1e-7 input perturbation; (d) with two or more
               cards, (b) over NCCL with one rank per card (up to 4) and
               the all-reduce's device ms, else a line saying it did not
               run; (e) the LM through Trainer(parallel=True) with
               CheckpointConfig(sharded=True, async_save=True), 4 batches x
               2 epochs at one rank: launches, a resumed Trainer bit-equal
               to the uninterrupted one, sync save seconds and bytes, the
               seconds an async save blocks the step and its writer's,
               load seconds, and (b)'s two-rank checkpoint loaded at one
               rank equal leaf for leaf.
 12. telemetry — the LM at BASE_CFG through Trainer.train at bench.py's
               LM cell (8 x 1024 tokens, bf16, flash, Adam) with the
               telemetry on (an exporter on an ephemeral port, a run log,
               tracing, a watch rule on trainer.step_seconds, the roofline
               ledger) and off, in turns from the same weights and batches
               (TELEMETRY_*): the losses bit-equal, 6 launches of each
               kernel every step and the same device activity count under
               torch.profiler both ways; the trainer.mfu gauge equal to the
               counted FLOPs over the step's seconds times the card's peak;
               the counted FLOPs within 1% of the analytic count and equal
               to the CPU path's count of the same step (FakeTensorMode);
               step ms on and off. The exporter, scraped while it trains:
               /metrics parses and holds trainer_mfu, trainer_goodput_frac,
               trainer_step_seconds and device_hbm_*{device="cuda:0"}, the
               peak gauge equal to torch.cuda.max_memory_allocated; /trace
               validates with every step's trainer.step_compute span and a
               memory counter track; core.profiler.profiler(log_dir) over
               two steps writes a torch.profiler trace holding the three
               kernels. Faults: a NaN step under skip_step (nan_skip badput,
               goodput below 1) and a slow step body (one straggler flag,
               the watch alert; the trainer.step fault point sits before
               the timed step, as in the JAX package). A DecodeEngine burst
               of 16 of phase serve (a)'s requests with tracing and the
               ledger on, against both off: tokens equal or a near tie,
               every request's span tree complete, no step fault, ledger
               rows for the step and the prefill with their verdicts.
 13. infer   — the inference-deployment slice (INFER_*): (a) the LM at
               BASE_CFG (bf16 + flash, random weights from seed 0) served
               through ServingEngine (one replica, a ragged token FeedSpec,
               length buckets 128/256/512, max batch 8): 32 requests with
               prompts of 64-512 tokens submitted at once, the served
               program returning logits; requests/s, p50/p99 latency, mean
               occupancy, aot_cache_sizes() before and after, flash
               launches per batch (6), peak memory; each request's logits
               against an unbatched Inferencer.infer of its prompt, the
               cache sizes steady, no error, nothing pending after close();
               (b) ResNet-50 at bench.py's cell in eval, f32: the BN-folded
               forward (inference_optimize) against the unfolded one at
               batch 8 within the card's own spread, images/s at batch 32
               each way, and the folded model served through ServingEngine
               (batch buckets 1-32); (c) the LM exported with
               io.save_inference_model (4 x 512) and loaded: logits bit-equal
               to the eager forward, 6 launches of the hand-written forward
               inside the loaded program (the operator
               paddle_tpu_torch::flash_fwd) and no library attention under
               torch.profiler; (d) the fluid_benchmark CLI in process
               (run_benchmark(parse_args(...))): resnet, transformer,
               transformer_lm, mnist, resnet --infer_only and a profiled
               transformer_lm pass: the JAX record's keys, finite losses,
               examples/s, 6 launches of each kernel per LM step, the
               profile's trace holding the three kernels.
 14. kernels — one line: each kernel with its launches on every path
               (phases 4-6, 8 and 10-13), its error and times at the
               slice shape and at the NMT cases from phase 3; before it, a
               line with the kernels' earlier times, copied from PERF.md
               (not measured).
The last line is {"ok": true, "device": {...}}. It is printed only when every
phase passed; the exit code is 0 only then. Without CUDA the script exits 1
and prints no result.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# peak rates of an H100 SXM (NVIDIA data sheet, dense, at the 700 W limit)
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12

# (name, B, H, H_kv, T, d, dtype, causal, window, ragged kv_len): ragged is
# False (no kv_len), True (kv_len drawn in [1, T]) or (lo, hi) (drawn in
# [lo, hi]). nmt_enc and nmt_dec are the NMT Transformer's attention at
# bench.py's cell (batch 32, seq 256, 8 heads of 64): its encoder
# self-attention and cross-attention (non-causal, per-row kv_len of the
# synthetic batch's lengths in [T/2, T]) and its decoder self-attention.
CASES = [
    ("slice", 8, 8, 8, 1024, 64, "bfloat16", True, None, False),
    ("gqa", 8, 8, 2, 1024, 64, "bfloat16", True, None, False),
    ("window", 8, 8, 8, 1024, 64, "bfloat16", True, 256, False),
    ("kv_len", 8, 8, 8, 1024, 64, "bfloat16", True, None, True),
    ("t192_f32", 2, 8, 8, 192, 64, "float32", True, None, False),
    # generate_beam's f32 prefill in phase serve (batch 4, 256 tokens)
    ("beam_prefill", 4, 8, 8, 256, 64, "float32", True, None, False),
    ("d128", 4, 8, 8, 1024, 128, "bfloat16", True, None, False),
    # T not a multiple of the 128-row/128-key tiles (TMA zero fill), and d=32
    # (64-byte swizzle)
    ("t1000_bf16", 4, 8, 8, 1000, 64, "bfloat16", True, None, False),
    ("d32_bf16", 4, 8, 8, 1024, 32, "bfloat16", True, None, False),
    ("nmt_enc", 32, 8, 8, 256, 64, "bfloat16", False, None, (128, 256)),
    ("nmt_dec", 32, 8, 8, 256, 64, "bfloat16", True, None, False),
]
# the cases timed (kernel, plain version and library) besides checked
TIMED_CASES = ("slice", "nmt_enc", "nmt_dec")
# max |kernel - plain| allowed. bf16: both versions read the same bf16 inputs
# and accumulate in f32, but round P to bf16 at different points and write a
# bf16 output (2^-8 relative ~ 4e-3 at |out| ~ 1): 2e-2 on out; lse is f32
# from f32 scores and differs only by summation order and exp2 vs exp: 1e-3.
# f32: FMA in another order than the plain version's einsum (TF32 off): 1e-4.
TOL = {"bfloat16": (2e-2, 1e-3), "float32": (1e-4, 1e-4)}
# The backward pair on the same cases, plus one block backward at global
# offsets (q rows at positions 256..511 against keys 0..511, window 200:
# every row keeps a live key): (name, B, H, H_kv, T, T_kv, d, dtype, causal,
# window, q_off, k_off).
BWD_BLOCK_CASE = ("bwd_block_offsets", 2, 8, 2, 256, 512, 64, "bfloat16", True, 200, 256, 0)
# max |kernel - plain| / max |plain| allowed on each of dq, dk, dv. bf16: the
# plain version keeps P and dS in f32 (as the TPU kernels do); the kernels
# round P and dS to bf16 (2^-9 relative) as tensor-core operands and store
# bf16 gradients (another 2^-9), and sum up to 1024 such terms in f32: 2e-2.
# f32: FMA in another order than the plain version's einsums (TF32 off): 1e-4.
BWD_TOL = {"bfloat16": 2e-2, "float32": 1e-4}
# Each kernel's design, and its time at the slice shape before this design,
# copied from PERF.md section 6 (the chip runs of the earlier mma.sync
# bodies). Printed on a line of their own, never as this run's.
DESIGNS = {"flash_fwd": "wgmma+tma", "flash_bwd_dkv": "wgmma+tma", "flash_bwd_dq": "wgmma+tma"}
EARLIER_MS = {"flash_fwd": 0.0968, "flash_bwd_dkv": 0.1760, "flash_bwd_dq": 0.1188}
# kernels that must hold wgmma and TMA instructions in their SASS
HOPPER_KERNELS = ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq")
# first-token logits of the slice, flash on vs off: both round q/k/v to bf16
# and accumulate in f32; they differ by where P is rounded: 2e-2 absolute
LOGITS_TOL = 2e-2
NEW_TOKENS = 32
PROMPTS, PROMPT_LEN = 8, 1024
# the training slice: bench.py's LM cell (8 sequences x 1024 tokens)
TRAIN_BATCH, TRAIN_STEPS = 8, 8
# the trainer slice: a reader of 4 such batches, 2 epochs, a checkpoint
# every 4 steps (one per epoch), 2 kept; the MNIST net: batch 64, 8 steps
TRAINER_BATCHES, TRAINER_EPOCHS, TRAINER_CKPT_STEPS = 4, 2, 4
MNIST_BATCH, MNIST_STEPS = 64, 8
# A resumed run against the uninterrupted one: the same weights, Adam state
# and batches through the same kernels, none of which sums with atomics, so
# the two must agree bit for bit (max |difference| = 0 over every
# parameter and Adam slot).
RESUME_TOL = 0.0
# One step's loss, flash attention vs composed attention (and vs the
# recomputed flash backward): both round q/k/v and P to bf16 and accumulate
# in f32; the kernel sums in another order and stores `out` in bf16, which
# the next projection rounds to bf16 anyway: 5e-3 absolute on a loss of ~10.
TRAIN_LOSS_TOL = 5e-3
# Gradients, per parameter: |g_flash - g_composed|_2 / max(|g_composed|_2,
# 1e-2 * the largest parameter's |g_composed|_2), at most 5e-2. The composed
# path's autograd rounds dP to bf16 at the P cast before the softmax backward
# subtracts Delta (a cancellation); the kernels keep dP and Delta in f32 and
# round P and dS to bf16, so in bf16 the two differ by a few 1e-2 relative
# even where both are right. The floor: the k projections' biases have zero gradient in exact
# arithmetic (a constant added to all of a row's scores cancels in the
# softmax), so theirs is rounding noise in both paths (~1e-5 of the largest).
TRAIN_GRAD_TOL, TRAIN_GRAD_FLOOR = 5e-2, 1e-2
# The conv zoo: ResNet-50 at bench.py's cell and the second entry of its
# batch sweep; SE-ResNeXt-50 and VGG-16 at their published widths.
CONV_BATCHES, CONV_STEPS = (64, 128), 8
ZOO_BATCH, ZOO_STEPS = 32, 4
# "the loss falls" for these two: a later loss below the first. Not the last
# one: SE-ResNeXt's published Momentum (lr 0.1, momentum 0.9) overshoots on
# one repeated batch after its second step, in the JAX package as in the
# port (the same 4 steps on the CPU, dropout off, agree to 4%).
TRAINER_CONV_BATCH = 64
# f32 parity of one ResNet-50 step (64x64, batch 4), card against CPU, with
# the TF32 switches at PyTorch's defaults. TF32 keeps ~3 decimal digits, so
# a TF32 convolution would show as ~1e-3 in the loss and the BN statistics.
# The loss: 1e-5 relative. The new BN statistics and the gradients (rel L2
# over all of them): at most CONV_PARITY_MIN, or CONV_PARITY_SPREAD times
# the CPU's own spread, measured in the same run, when the input moves by
# 1e-7 relative. At random init ResNet-50's gradients are ill-conditioned:
# pre-ReLU values within rounding of 0 flip, and train-mode BN spreads each
# flip over its channel, so f32 rounding alone moves them by ~1e-2
# (tools/torch_conv_zoo_probe.py), and no fixed 1e-4 can hold.
CONV_PARITY_LOSS, CONV_PARITY_MIN, CONV_PARITY_SPREAD = 1e-5, 1e-4, 4.0
# one bf16 amp_minimize step against the bf16 minimize step on the same
# weights and batch: the loss, absolute (BN's scale and bias and the fc
# bias are rounded to bf16 too)
AMP_LOSS_TOL = 2e-2
# The NMT Transformer at bench.py's cell (bench.py:484-496): batch 32 of 256
# tokens, BASE_CFG at full depth and width, bf16 compute and flash on;
# 8 steps for "the loss falls"
NMT_BATCH, NMT_SEQ, NMT_STEPS = 32, 256, 8
# eval, flash against composed attention: the loss and the logits at
# non-pad positions, absolute. Both round q/k/v and P to bf16 and
# accumulate in f32, at other points (the kernel stores its output in
# bf16); through 12 layers of post-LN that moves logits of ~unit scale by
# a few 1e-3
NMT_EVAL_TOL = 2e-2
# attention dropout's expectation: mask draws averaged
NMT_DROP_DRAWS = 64
# stacked_dynamic_lstm and machine_translation at their get_model defaults,
# f32; the beam-search model at beam 4, 32 steps. Where the card's beam and
# the CPU's first differ, the two candidates' scores must be a near tie:
# f32 products summed in another order move a log-prob by ~1e-6
RNN_BATCH, RNN_STEPS = 32, 8
BEAM, BEAM_LEN, BEAM_TIE_TOL = 4, 32, 1e-4
# Decode serving: DecodeEngine over the LM at BASE_CFG, f32 weights and
# pages, greedy. (a) a burst of 48 requests submitted together, prompt
# lengths uniform in [16, 768] and max_new_tokens in [8, 128] (numpy seed 0);
# 12 of them held against generate() with flash off; (b) the same burst on a
# starved pool of 3 slots' pages + scratch; (c) 16 requests sharing a
# 512-token prefix, tails of 16-64 tokens, 32 new tokens each; (d) 8 of the
# requests with spec_tokens 4 and the target as its own draft; (e)
# generate_beam, batch 4, beam 4, 32 new tokens, prompts of 257 tokens (a
# 256-position prefill, which the flash tiling divides: one forward launch a
# layer). Tokens that differ between two runs must differ first at a near
# tie: the two candidates within SERVE_TIE_TOL in the reference's logits
# (f32 sums in another order move a logit by ~1e-6).
SERVE_CONFIG = dict(max_slots=16, page_size=16, max_context=1024, prefill_chunk=256)
SERVE_REQUESTS, SERVE_CHECKED = 48, 12
SERVE_PROMPT_LEN, SERVE_NEW_TOKENS = (16, 768), (8, 128)
SERVE_PREFIX, SERVE_PREFIX_TAIL, SERVE_PREFIX_REQUESTS, SERVE_PREFIX_NEW = 512, (16, 64), 16, 32
SERVE_SPEC_REQUESTS, SERVE_SPEC_TOKENS = 8, 4
SERVE_BEAM_BATCH, SERVE_BEAM_PROMPT = 4, 257
SERVE_TIE_TOL = 1e-4
SERVE_WAIT_S = 600
# DecodeEngine counters that must stay 0 on a clean run: the recovery ladder
# re-prefills a slot whose step raised and still returns the right tokens, so
# only these show that a step failed on the card
SERVE_FAULT_COUNTERS = ("step_faults_total", "errors_total", "retries_exhausted_total")
# Data parallelism (phase dp): DataParallel steps of the LM at BASE_CFG;
# ResNet-50 at 64 x 64, batch 8, f32 for BN across ranks. At one rank the
# DP step runs minimize's very operations, so it must equal that step bit
# for bit (loss, every parameter, both Adam slots), with and without ZeRO-1.
DP_STEPS = 3
DP_RESNET_SIZE, DP_RESNET_BATCH = 64, 8
DP_ONE_RANK_TOL = 0.0
# Phase dp (b)/(d), per parameter: |p - p_ref|_2 / |p_ref - p_init|_2, the
# distance of a data-parallel run's parameters from the one-rank run's
# after DP_STEPS Adam steps, over how far the one-rank run moved them. Adam's
# first steps move each entry by ~lr x the sign of its gradient, so a
# near-zero gradient entry whose sign bf16 rounding at another GEMM tiling
# flips moves 2 lr the other way: sound runs read up to 7.95e-2 (2 ranks)
# and 0.13 (4 cards) at their worst parameter; the control (rank 0's rows
# alone, as if the all-reduce did nothing) 0.85 at its median one (PERF.md
# section 6, PR 9), and it must read above the limit in every run.
DP_MOVEMENT_TOL = 0.25
# Telemetry (phase telemetry): bench.py's LM cell through the Trainer (8 x
# 1024 tokens, bf16, flash, Adam) with the telemetry on — an exporter on an
# ephemeral port (scraped while it trains), a run log, tracing, a watch on
# the step time, the roofline ledger — and off, in turns from the same
# weights and batches: TELEMETRY_STEPS steps a run, TELEMETRY_TURNS runs
# each way, then one profiled run each way; step ms from the third step on
# (the first is counted, the second still warms up). The step's counted
# FLOPs within
# TELEMETRY_FLOPS_TOL (relative) of the analytic count, and equal to the CPU
# path's count of the same step (traced under FakeTensorMode: shapes only).
TELEMETRY_STEPS, TELEMETRY_TURNS, TELEMETRY_FLOPS_TOL = 8, 2, 0.01
# (c) one run of TELEMETRY_FAULT_STEPS steps with a NaN injected at step
# TELEMETRY_NAN_STEP (nan_policy "skip_step") and the body of step
# TELEMETRY_STALL_STEP slowed by TELEMETRY_STALL_S (the Trainer's timed
# step, where the JAX package's Trainer would time it too; the trainer.step
# fault point sits before it in both): ~10x the step, past the straggler
# watch's 2.5x and the watch rule's 4x of the running median
TELEMETRY_FAULT_STEPS, TELEMETRY_NAN_STEP = 8, 2
TELEMETRY_STALL_STEP, TELEMETRY_STALL_S = 6, 0.5
# (d) the first TELEMETRY_SERVE_REQUESTS requests of phase serve (a)'s burst
TELEMETRY_SERVE_REQUESTS = 16


# Phase infer. (a) the LM at BASE_CFG served through ServingEngine (one
# replica, length buckets, max batch 8): INFER_REQUESTS ragged prompts with
# lengths uniform in INFER_PROMPT_LENS (numpy seed 0), each request's logits
# within INFER_LOGITS_TOL (abs) of an unbatched Inferencer.infer of the same
# prompt: pad keys lie beyond every real query under the causal mask, so
# the difference is bf16 GEMM rounding at other batch sizes (phase slice's
# LOGITS_TOL).
INFER_LENGTH_BUCKETS, INFER_MAX_BATCH = (128, 256, 512), 8
INFER_REQUESTS, INFER_PROMPT_LENS, INFER_LOGITS_TOL = 32, (64, 512), 2e-2
INFER_WAIT_S = 300
# (b) ResNet-50 at bench.py's cell in eval, f32: folded against unfolded at
# batch INFER_RESNET_BATCH (CONV_PARITY_MIN, or CONV_PARITY_SPREAD times the
# card's own spread under a 1e-7 relative input change), after
# INFER_BN_WARM_BATCHES train-mode forwards move the moving statistics off
# their init (so the fold is not near the identity); images/s at batch 32;
# INFER_RESNET_REQUESTS single-image requests served (batch buckets 1-32).
INFER_RESNET_BATCH, INFER_BN_WARM_BATCHES, INFER_RESNET_SERVE_MAX = 8, 4, 32
INFER_RESNET_REQUESTS, INFER_RESNET_BN_PAIRS, INFER_IMAGE_SIZE = 64, 53, 224
# (c) the exported LM program's input
INFER_EXPORT_SHAPE = (4, 512)
# (d) the CLI's runs, in process (--json --no_random added): bench.py's
# ResNet-50 batch, the NMT Transformer at its get_model config (the CLI has
# no sequence-length flag: seq 64) and batch 32, the LM cell, MNIST, the
# ResNet forward alone and a profiled LM pass.
INFER_CLI_RUNS = (
    ("resnet", ["--model", "resnet", "--batch_size", "64", "--iterations", "4",
                "--skip_batch_num", "2"]),
    ("transformer", ["--model", "transformer", "--batch_size", "32", "--iterations", "4",
                     "--skip_batch_num", "2"]),
    ("transformer_lm", ["--model", "transformer_lm", "--batch_size", "8", "--iterations", "4",
                        "--skip_batch_num", "2"]),
    ("mnist", ["--model", "mnist", "--batch_size", "64", "--iterations", "8",
               "--skip_batch_num", "2"]),
    ("resnet_infer_only", ["--model", "resnet", "--batch_size", "64", "--iterations", "4",
                           "--skip_batch_num", "2", "--infer_only"]),
    ("transformer_lm_profile", ["--model", "transformer_lm", "--batch_size", "8",
                                "--iterations", "2", "--skip_batch_num", "1", "--profile"]),
)
INFER_RECORD_KEYS = {"pass", "model", "batch_size", "chips", "examples_per_sec", "unit",
                     "last_loss", "elapsed_sec"}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def time_ms(fn, iters: int = 20) -> float:
    """Device time of one call of ``fn``: CUDA events around ``iters`` calls
    enqueued behind a sleep kernel, so the host's enqueue time is hidden."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(100_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def host_us(fn, iters: int = 50) -> float:
    """Host time of one call of ``fn`` in microseconds: the wrapper's checks,
    its allocations, the TMA descriptors where the kernel has them, and the
    launch, with the card held busy by a sleep kernel so no call waits on it."""
    import torch

    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(100_000_000)
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return 1e6 * t / iters


def cuobjdump_path(nvcc: str):
    """cuobjdump beside nvcc, else the copy in Triton's package; None if
    neither exists."""
    found = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    if os.path.exists(found):
        return found
    try:
        import triton
    except ImportError:
        return None
    found = os.path.join(os.path.dirname(triton.__file__), "backends", "nvidia", "bin", "cuobjdump")
    return found if os.path.exists(found) else None


def sass_counts(cuobjdump: str, lib: str) -> dict:
    """HGMMA and UTMALDG instructions in a library's SASS, per kernel
    function (by its demangled-enough name: the text after the last
    'flash_')."""
    sass = subprocess.run([cuobjdump, "-sass", lib], capture_output=True, text=True,
                          timeout=300, check=True).stdout
    counts, fn = {}, None
    for ln in sass.splitlines():
        m = re.search(r"Function : (\S+)", ln)
        if m:
            fn = m.group(1)
            fn = fn[fn.rfind("flash_"):]
            counts[fn] = {"HGMMA": 0, "UTMALDG": 0}
        elif fn is not None:
            counts[fn]["HGMMA"] += "HGMMA" in ln
            counts[fn]["UTMALDG"] += "UTMALDG" in ln
    return counts


def ptxas_spills(nvcc_output: str) -> dict:
    """Spill stores + loads (bytes) per kernel function, from -Xptxas -v."""
    spills, fn = {}, None
    for ln in nvcc_output.splitlines():
        m = re.search(r"Function properties for (\S+)", ln)
        if m:
            fn = m.group(1)
            fn = fn[fn.rfind("flash_"):]
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m and fn is not None:
            spills[fn] = int(m.group(1)) + int(m.group(2))
            fn = None
    return spills


def draw_kv_len(ragged, B, T, gen):
    """A case's kv_len: None, or [B] int32 on the card drawn from ``gen`` in
    [1, T] (ragged True: every row keeps key 0 live, so every row is
    compared) or in [lo, hi] (ragged a pair)."""
    import torch

    if not ragged:
        return None
    lo, hi = (1, T) if ragged is True else ragged
    return torch.randint(lo, hi + 1, (B,), generator=gen, device="cuda").to(torch.int32)


def sdpa_mask(kv_len, T_kv):
    """F.scaled_dot_product_attention's boolean mask for kv_len (True =
    attend), [B, 1, 1, T_kv]; None without kv_len."""
    import torch

    if kv_len is None:
        return None
    return (torch.arange(T_kv, device="cuda")[None, :] < kv_len[:, None])[:, None, None, :]


def live_pairs(T, T_kv, causal, window, kv_len, B, H, q_off=0, k_off=0):
    """Live (q, k) pairs of the call, as the masks define them."""
    import torch

    q = q_off + torch.arange(T, device="cuda")[:, None]
    k = k_off + torch.arange(T_kv, device="cuda")[None, :]
    live = torch.ones(T, T_kv, dtype=torch.bool, device="cuda")
    if causal:
        live &= q >= k
        if window is not None:
            live &= q - k < window
    if kv_len is None:
        return int(live.sum()) * B * H
    per_b = torch.stack([(live & (k < int(n))).sum() for n in kv_len])
    return int(per_b.sum()) * H


def kv_rows(B, T_kv, kv_len):
    """Key rows the call needs per kv head: B * T_kv, or sum(kv_len) when
    keys past a row's kv_len are dead."""
    return B * T_kv if kv_len is None else int(kv_len.clamp(max=T_kv).sum())


def bound_ms(B, H, H_kv, T, d, dtype, causal, window, kv_len):
    """The larger of: the operations (4*d flops per live pair: Q K^T and
    P V) over the dtype's peak, and the bytes (q, live k and v rows read
    once, out and lse written once) over the memory rate."""
    esize = 2 if dtype == "bfloat16" else 4
    flops = 4 * d * live_pairs(T, T, causal, window, kv_len, B, H)
    nbytes = esize * d * (2 * B * H * T + 2 * H_kv * kv_rows(B, T, kv_len)) + 4 * B * H * T
    peak = PEAK_BF16_FLOPS if dtype == "bfloat16" else PEAK_F32_FLOPS
    t_ops, t_bytes = flops / peak, nbytes / PEAK_HBM_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def bwd_bound_ms(kernel, B, H, H_kv, T, T_kv, d, dtype, causal, window, kv_len, q_off=0, k_off=0):
    """The bound of one backward kernel: operations per live pair (dK/dV:
    S, dP, dV, dK = 8*d; dQ: S, dP, dQ = 6*d) over the dtype's peak, against
    bytes (q, live k and v rows, dO read once, lse and Delta in f32, then
    dk and dv, or dq, written once) over the memory rate."""
    esize = 2 if dtype == "bfloat16" else 4
    pairs = live_pairs(T, T_kv, causal, window, kv_len, B, H, q_off, k_off)
    q_like, kv_like = esize * B * H * T * d, esize * H_kv * kv_rows(B, T_kv, kv_len) * d
    nbytes = 2 * q_like + 2 * kv_like + 2 * 4 * B * H * T
    if kernel == "flash_bwd_dkv":
        flops, nbytes = 8 * d * pairs, nbytes + 2 * esize * B * H_kv * T_kv * d
    else:
        flops, nbytes = 6 * d * pairs, nbytes + q_like
    peak = PEAK_BF16_FLOPS if dtype == "bfloat16" else PEAK_F32_FLOPS
    t_ops, t_bytes = flops / peak, nbytes / PEAK_HBM_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def state_max_abs_diff(a, b) -> float:
    """Largest |difference| over every parameter and optimizer slot of two
    (Variables, OptState) training states on the card (inf if they differ
    in structure or step)."""
    import torch

    from paddle_tpu_torch.core import tree

    la, lb = tree.leaves(a), tree.leaves(b)
    if len(la) != len(lb):
        return float("inf")
    worst = 0.0
    for x, y in zip(la, lb):
        if isinstance(x, torch.Tensor):
            worst = max(worst, float((x.float() - y.float()).abs().max()))
        elif x != y:
            return float("inf")
    return worst


def trainer_phase(smi: str):
    """Phase 6: the LM at BASE_CFG and the MNIST net through the Trainer.
    Returns the LM run's kernel launches and the phase's checks."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from paddle_tpu_torch.checkpoint import latest_checkpoint
    from paddle_tpu_torch.core import profiler as prof
    from paddle_tpu_torch.core.config import set_flags
    from paddle_tpu_torch.models import get_model
    from paddle_tpu_torch.ops.cuda import build as kbuild
    from paddle_tpu_torch.trainer import (BeginEpochEvent, BeginStepEvent, CheckpointConfig,
                                          EndStepEvent, Trainer)

    set_flags(use_flash_attention=True, use_bf16_compute=True, check_nan_inf=True)
    spec = get_model("transformer_lm")  # BASE_CFG, seq_len 1024, on CUDA
    rng = np.random.RandomState(0)
    batches = [spec.synth_batch(TRAIN_BATCH, rng) for _ in range(TRAINER_BATCHES)]
    init_vars = spec.model.init(0, *batches[0])
    init_state = spec.optimizer().create_state(init_vars.params)
    step = spec.optimizer().minimize(spec.model)

    def direct_epoch():
        """minimize's step over the batches from the initial state, each step
        read as the Trainer reads it (loss and finite flag): the losses and
        the ms of steps 2..4 (the host clock between step ends)."""
        losses, t = [], [time.perf_counter()]
        v, st = init_vars, init_state
        for b in batches:
            out = step(v, st, *b)
            losses.append(float(out.loss))
            bool(out.finite)
            t.append(time.perf_counter())
            v, st = out.variables, out.opt_state
        return losses, [1e3 * (b - a) for a, b in zip(t[1:-1], t[2:])]

    def trainer_epoch():
        """The same epoch through a Trainer with no checkpoint: the ms
        between its EndStepEvents (steps 2..4)."""
        t = Trainer(lambda: spec.model, spec.optimizer)
        t.variables, t.opt_state = init_vars, init_state
        ends = []
        t.train(num_epochs=1, reader=lambda: iter(batches),
                event_handler=lambda ev: ends.append(time.perf_counter())
                if isinstance(ev, EndStepEvent) else None)
        return [1e3 * (b - a) for a, b in zip(ends[:-1], ends[1:])]

    direct_losses, _ = direct_epoch()

    def kernel_counts():
        return {n: k.launches for n, k in kbuild.KERNELS.items()}

    def make_trainer(root):
        return Trainer(lambda: spec.model, spec.optimizer, checkpoint_config=CheckpointConfig(
            root, step_interval=TRAINER_CKPT_STEPS, max_num_checkpoints=2))

    work = tempfile.mkdtemp(prefix="chip_smoke_trainer_")
    try:
        root, copy = os.path.join(work, "ckpt"), os.path.join(work, "resume")
        trainer = make_trainer(root)
        trainer.variables, trainer.opt_state = init_vars, init_state
        losses, per_step, marks = [], [], {}

        def handler(ev):
            if isinstance(ev, BeginStepEvent):
                marks["counts"] = kernel_counts()
            elif isinstance(ev, EndStepEvent):
                losses.append(ev.metrics)
                now = kernel_counts()
                per_step.append({n: now[n] - marks["counts"][n] for n in now})
            elif isinstance(ev, BeginEpochEvent) and ev.epoch == 1:
                # the epoch boundary's state: checkpoint_0 with next_epoch 1
                shutil.copytree(root, copy)

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        prof.reset_metrics()
        for kern in kbuild.KERNELS.values():
            kern.launches = 0
        trainer.train(num_epochs=TRAINER_EPOCHS, event_handler=handler, reader=lambda: iter(batches))
        torch.cuda.synchronize()
        trainer_launches = kernel_counts()
        peak_bytes = torch.cuda.max_memory_allocated()
        saves = prof.histograms().get("checkpoint.save_seconds", {})
        shard = os.path.join(latest_checkpoint(root), "shard_0.npz")
        ckpt_bytes = os.path.getsize(shard)

        resumed = make_trainer(copy)
        resumed_losses = []
        resumed.train(num_epochs=TRAINER_EPOCHS, reader=lambda: iter(batches),
                      event_handler=lambda ev: resumed_losses.append(ev.metrics)
                      if isinstance(ev, EndStepEvent) else None)
        loads = prof.histograms().get("checkpoint.load_seconds", {})
        resume_diff = state_max_abs_diff((trainer.variables, trainer.opt_state),
                                         (resumed.variables, resumed.opt_state))
        resumed_step = resumed.global_step
        del resumed
    finally:
        shutil.rmtree(work, ignore_errors=True)

    # the Trainer's host cost: its step ms against the direct step's, in
    # turns (direct, trainer, direct, trainer), steps 2..4 of each epoch
    direct_ms, trainer_ms = [], []
    for _ in range(2):
        direct_ms += direct_epoch()[1]
        trainer_ms += trainer_epoch()
    n_layers = spec.extra["cfg"]["n_layers"]
    lm_checks = {
        "six_launches_of_each_kernel_every_step": all(
            c[k] == n_layers for c in per_step for k in ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq")),
        "steps": trainer.global_step == TRAINER_BATCHES * TRAINER_EPOCHS == len(per_step),
        "first_loss_equals_direct_step": losses[0] == direct_losses[0],
        "epoch0_losses_equal_direct_steps": losses[:TRAINER_BATCHES] == direct_losses,
        "losses_finite": bool(np.isfinite(losses).all()),
        "resumed_at_epoch_boundary": len(resumed_losses) == TRAINER_BATCHES
        and resumed_step == trainer.global_step,
        "resumed_losses_equal": resumed_losses == losses[TRAINER_BATCHES:],
        "resumed_state_within_tol": resume_diff <= RESUME_TOL,
        "checkpoints_saved": saves.get("count", 0) == 2,
    }
    emit({"phase": "trainer", "model": "transformer_lm", "params": sum(
              p.numel() for p in init_vars.params.values()),
          "batch": TRAIN_BATCH, "seq_len": spec.extra["seq_len"], "batches": TRAINER_BATCHES,
          "epochs": TRAINER_EPOCHS, "launches": trainer_launches, "launches_per_step": per_step,
          "losses": losses, "direct_losses": direct_losses,
          "first_loss_minus_direct": losses[0] - direct_losses[0],
          "resumed_losses": resumed_losses, "resume_max_abs_diff": resume_diff,
          "resume_tol": RESUME_TOL,
          "trainer_step_ms": trainer_ms, "direct_step_ms": direct_ms,
          "trainer_step_ms_median": float(np.median(trainer_ms)),
          "direct_step_ms_median": float(np.median(direct_ms)),
          "trainer_over_direct_ms": float(np.median(trainer_ms) - np.median(direct_ms)),
          "checkpoint_bytes": ckpt_bytes, "checkpoint_save_s": saves,
          "checkpoint_load_s": loads, "peak_memory_bytes": peak_bytes, "card": smi,
          "checks": lm_checks})
    del trainer, init_vars, init_state, batches

    # the MNIST conv net, f32
    set_flags(use_bf16_compute=False)
    mspec = get_model("mnist")
    mbatch = mspec.synth_batch(MNIST_BATCH, np.random.RandomState(0))
    mnist = Trainer(lambda: mspec.model, mspec.optimizer)
    mlosses, mt = [], []

    def mhandler(ev):
        if isinstance(ev, EndStepEvent):
            mt.append(time.perf_counter())
            mlosses.append(ev.metrics)

    mnist.train(num_epochs=1, reader=lambda: iter([mbatch] * MNIST_STEPS), event_handler=mhandler)
    mnist_ms = [1e3 * (b - a) for a, b in zip(mt[:-1], mt[1:])]
    mnist_checks = {"mnist_loss_falls": mlosses[-1] < mlosses[0],
                    "mnist_losses_finite": bool(np.isfinite(mlosses).all()),
                    "mnist_steps": len(mlosses) == MNIST_STEPS}
    emit({"phase": "trainer", "model": "mnist", "batch": MNIST_BATCH, "losses": mlosses,
          "step_ms": mnist_ms, "step_ms_median": float(np.median(mnist_ms)),
          "params": sum(p.numel() for p in mnist.variables.params.values()), "card": smi,
          "checks": mnist_checks})
    set_flags(use_bf16_compute=True)
    return trainer_launches, {**lm_checks, **mnist_checks}


def conv_flops_per_image(spec):
    """Multiply-adds x 2 of one image's forward, counted from the shapes of
    every convolution and dense product one forward runs (3x this for a
    training step): the conv and fc entry points are wrapped for one
    batch-1 eval forward on the card. Also returns how many of the
    convolutions' NHWC results came back contiguous, i.e. how many of
    cuDNN's NCHW outputs were channels-last (no relayout copy), and the
    number of convolutions."""
    import torch

    from paddle_tpu_torch import layers
    from paddle_tpu_torch.ops import nn as onn

    count, convs, nhwc = [0], [0], [0]
    conv, mm = onn.conv2d, layers.f32_matmul

    def counted_conv(x, w, *a, groups=1, **k):
        out = conv(x, w, *a, groups=groups, **k)
        count[0] += 2 * out.numel() * w.shape[0] * w.shape[1] * w.shape[2]
        convs[0] += 1
        nhwc[0] += out.is_contiguous()
        return out

    def counted_mm(a, b):
        count[0] += 2 * a.shape[0] * a.shape[1] * b.shape[1]
        return mm(a, b)

    import numpy as np

    x, y = spec.synth_batch(1, np.random.RandomState(0))
    onn.conv2d, layers.f32_matmul = counted_conv, counted_mm
    try:
        with torch.no_grad():
            v = spec.model.init(0, x, y)
            count[0] = convs[0] = nhwc[0] = 0
            spec.model.apply(v, x, y, is_train=False)
    finally:
        onn.conv2d, layers.f32_matmul = conv, mm
    return count[0], nhwc[0], convs[0]


def conv_phase(smi: str):
    """Phase 7: the conv zoo. Returns the phase's checks."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from paddle_tpu_torch import convert
    from paddle_tpu_torch.backward import append_backward
    from paddle_tpu_torch.checkpoint import latest_checkpoint
    from paddle_tpu_torch.core import profiler as prof
    from paddle_tpu_torch.core.config import set_flags
    from paddle_tpu_torch.core.enforce import EnforceError
    from paddle_tpu_torch.models import get_model
    from paddle_tpu_torch.trainer import BeginEpochEvent, CheckpointConfig, EndStepEvent, Trainer
    from paddle_tpu_torch.transpiler import amp_minimize

    defaults = {"matmul.allow_tf32": torch.backends.cuda.matmul.allow_tf32,
                "cudnn.allow_tf32": torch.backends.cudnn.allow_tf32}
    checks = {"tf32_switches_at_pytorch_defaults": defaults == {"matmul.allow_tf32": False,
                                                                "cudnn.allow_tf32": True}}

    # (a) ResNet-50 at bench.py's cell
    set_flags(use_bf16_compute=True, check_nan_inf=False)
    spec = get_model("resnet", dataset="flowers", depth=50, class_dim=1000)
    flops, nhwc_results, n_convs = conv_flops_per_image(spec)
    checks["conv_results_channels_last"] = nhwc_results == n_convs
    rng = np.random.RandomState(0)
    x, y = spec.synth_batch(CONV_BATCHES[0], rng)
    v0 = spec.model.init(0, x, y)
    opt = spec.optimizer()
    st0 = opt.create_state(v0.params)
    step = opt.minimize(spec.model)
    first = step(v0, st0, x, y)
    new_state = first.variables.state
    checks["bn_state_every_leaf_changes"] = bool(v0.state) and all(
        not torch.equal(new_state[k], v0.state[k]) for k in v0.state)
    checks["bn_state_finite"] = all(bool(torch.isfinite(t).all()) for t in new_state.values())
    checks["bn_state_no_graph"] = all(t.grad_fn is None for t in new_state.values())
    # the weights stay HWIO-contiguous through the update (no layout drift)
    checks["conv_weights_contiguous_after_step"] = all(
        t.is_contiguous() for t in first.variables.params.values())
    losses, v, st = [float(first.loss)], first.variables, first.opt_state
    for _ in range(CONV_STEPS - 1):
        o = step(v, st, x, y)
        v, st = o.variables, o.opt_state
        losses.append(float(o.loss))
    checks["resnet50_loss_falls"] = losses[-1] < losses[0]
    checks["resnet50_losses_finite"] = bool(np.isfinite(losses).all())

    # (e) amp_minimize against the bf16 minimize step, on the weights after
    # those 8 steps (at init BN's scale 1 and bias 0 and the fc bias 0 are
    # exact in bf16, so the two would agree to the bit)
    ref_loss = float(step(v, st, x, y).loss)
    amp = amp_minimize(opt, spec.model, compute_dtype="bfloat16")(v, st, None, x, y)
    amp_loss = float(amp.loss)
    amp_err = abs(amp_loss - ref_loss)
    checks["amp_loss_within_tol"] = amp_err <= AMP_LOSS_TOL
    checks["amp_master_weights_f32"] = all(
        t.dtype == torch.float32 for t in amp.variables.params.values())
    del amp, first, new_state, v, st, o

    timing = {}
    for bs in CONV_BATCHES:
        if bs != CONV_BATCHES[0]:
            x, y = spec.synth_batch(bs, rng)
        for _ in range(2):
            step(v0, st0, x, y)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        runs = []
        for _ in range(3):
            t0 = time.perf_counter()
            step(v0, st0, x, y)
            torch.cuda.synchronize()
            runs.append(time.perf_counter() - t0)
        best = min(runs)
        timing[bs] = {"step_ms": 1e3 * best, "step_ms_runs": [1e3 * r for r in runs],
                      "images_per_s": bs / best,
                      "mfu_bf16": 3 * flops * bs / best / PEAK_BF16_FLOPS,
                      "peak_memory_bytes": torch.cuda.max_memory_allocated()}
    emit({"phase": "conv", "part": "a_resnet50", "model": "resnet50", "image_size": 224,
          "class_dim": 1000, "params": sum(p.numel() for p in v0.params.values()),
          "state_leaves": len(v0.state), "forward_flops_per_image": flops,
          "convolutions": n_convs, "conv_results_channels_last": nhwc_results,
          "train_flops_per_image": 3 * flops, "losses": losses, "by_batch": timing,
          "amp_loss": amp_loss, "minimize_loss_same_weights": ref_loss, "amp_loss_abs_err": amp_err, "amp_loss_tol": AMP_LOSS_TOL, "card": smi})
    del v0, st0, x, y

    # (b) f32 parity, card against CPU, TF32 switches untouched
    set_flags(use_bf16_compute=False)
    pspec = get_model("resnet", dataset="flowers", depth=50, class_dim=1000, image_size=64)
    px, py = pspec.synth_batch(4, np.random.RandomState(1))
    pv = pspec.model.init(0, px, py)

    def one_step(variables, xs, ys):
        loss, (g, new, _) = append_backward(pspec.model, xs, ys, state=variables.state)(
            variables.params)
        return float(loss), g, new

    def rel_all(a, b):
        num = sum(float((a[k].double().cpu() - b[k].double().cpu()).norm()) ** 2 for k in b)
        den = sum(float(b[k].double().cpu().norm()) ** 2 for k in b)
        return (num / den) ** 0.5

    l_cuda, g_cuda, s_cuda = one_step(pv, px, py)
    cpu_v = convert.variables_from_jax(
        (convert.params_to_numpy(pv.params), convert.params_to_numpy(pv.state)), "cpu")
    l_cpu, g_cpu, s_cpu = one_step(cpu_v, px.cpu(), py.cpu())
    noise = torch.from_numpy(np.random.RandomState(2).randn(*px.shape).astype(np.float32))
    l_cpu2, g_cpu2, s_cpu2 = one_step(cpu_v, px.cpu() * (1 + 1e-7 * noise), py.cpu())
    parity = {"loss_rel_err": abs(l_cuda - l_cpu) / abs(l_cpu),
              "grad_rel_l2": rel_all(g_cuda, g_cpu), "state_rel_l2": rel_all(s_cuda, s_cpu),
              "cpu_spread_grad_rel_l2": rel_all(g_cpu2, g_cpu),
              "cpu_spread_state_rel_l2": rel_all(s_cpu2, s_cpu),
              "cpu_spread_loss_rel": abs(l_cpu2 - l_cpu) / abs(l_cpu)}
    grad_tol = max(CONV_PARITY_MIN, CONV_PARITY_SPREAD * parity["cpu_spread_grad_rel_l2"])
    state_tol = max(CONV_PARITY_MIN, CONV_PARITY_SPREAD * parity["cpu_spread_state_rel_l2"])
    checks["f32_parity_loss"] = parity["loss_rel_err"] <= CONV_PARITY_LOSS
    checks["f32_parity_grads"] = parity["grad_rel_l2"] <= grad_tol
    checks["f32_parity_bn_state"] = parity["state_rel_l2"] <= state_tol
    checks["tf32_switches_untouched"] = defaults == {
        "matmul.allow_tf32": torch.backends.cuda.matmul.allow_tf32,
        "cudnn.allow_tf32": torch.backends.cudnn.allow_tf32}
    emit({"phase": "conv", "part": "b_f32_parity", "model": "resnet50", "image_size": 64,
          "batch": 4, "tf32_switches": defaults, **parity, "loss_tol": CONV_PARITY_LOSS,
          "grad_tol": grad_tol, "state_tol": state_tol, "losses": [l_cuda, l_cpu]})
    del pv, cpu_v, g_cuda, g_cpu, g_cpu2

    # (c) ResNet-50 through the Trainer, with a resumed run
    set_flags(use_bf16_compute=True, check_nan_inf=True)
    rng = np.random.RandomState(3)
    batches = [spec.synth_batch(TRAINER_CONV_BATCH, rng) for _ in range(2)]
    saved_det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    work = tempfile.mkdtemp(prefix="chip_smoke_conv_")
    try:
        root, copy = os.path.join(work, "ckpt"), os.path.join(work, "resume")

        def run(trainer, on_begin_epoch1=None):
            losses = []

            def handler(ev):
                if isinstance(ev, EndStepEvent):
                    losses.append(ev.metrics)
                elif isinstance(ev, BeginEpochEvent) and ev.epoch == 1 and on_begin_epoch1:
                    on_begin_epoch1()

            trainer.train(num_epochs=2, reader=lambda: iter(batches), event_handler=handler)
            return losses

        def make(r):
            return Trainer(lambda: spec.model, spec.optimizer,
                           checkpoint_config=CheckpointConfig(r, step_interval=2, max_num_checkpoints=2))

        prof.reset_metrics()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        a = make(root)
        a_losses = run(a, lambda: shutil.copytree(root, copy))
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        saves = prof.histograms().get("checkpoint.save_seconds", {})
        ckpt_bytes = os.path.getsize(os.path.join(latest_checkpoint(root), "shard_0.npz"))
        b = Trainer(lambda: spec.model, spec.optimizer)
        b_losses = run(b)
        spread = state_max_abs_diff((a.variables, a.opt_state), (b.variables, b.opt_state))
        del b
        r = make(copy)
        r_losses = run(r)
        loads = prof.histograms().get("checkpoint.load_seconds", {})
        resume_diff = state_max_abs_diff((a.variables, a.opt_state), (r.variables, r.opt_state))
        resumed_step, a_step = r.global_step, a.global_step
        del a, r
    finally:
        torch.backends.cudnn.deterministic = saved_det
        shutil.rmtree(work, ignore_errors=True)
    checks["trainer_resnet50_steps"] = a_step == 4 and len(a_losses) == 4
    checks["trainer_resnet50_losses_finite"] = bool(np.isfinite(a_losses).all())
    checks["trainer_resumed_at_epoch_boundary"] = resumed_step == 4 and len(r_losses) == 2
    checks["trainer_resumed_within_run_to_run_spread"] = resume_diff <= spread
    checks["trainer_checkpoints_saved"] = saves.get("count", 0) == 2
    emit({"phase": "conv", "part": "c_trainer", "model": "resnet50", "batch": TRAINER_CONV_BATCH,
          "epochs": 2, "batches": 2, "cudnn_deterministic": True, "losses": a_losses,
          "uninterrupted_again_losses": b_losses, "resumed_losses": r_losses,
          "run_to_run_max_abs_diff": spread, "resume_max_abs_diff": resume_diff,
          "checkpoint_bytes": ckpt_bytes, "checkpoint_save_s": saves, "checkpoint_load_s": loads,
          "peak_memory_bytes": peak, "card": smi})
    del batches
    set_flags(check_nan_inf=False)

    # (d) SE-ResNeXt-50 and VGG-16 at their published widths, dropout on
    for name, kw in (("se_resnext", dict(class_dim=102)),
                     ("vgg", dict(dataset="flowers", class_dim=102))):
        zspec = get_model(name, **kw)
        zx, zy = zspec.synth_batch(ZOO_BATCH, np.random.RandomState(4))
        zv = zspec.model.init(0, zx, zy)
        zopt = zspec.optimizer()
        zst = zopt.create_state(zv.params)
        zstep = zopt.minimize(zspec.model)
        try:
            zstep(zv, zst, zx, zy)
            needs_rng = False
        except EnforceError:
            needs_rng = True
        gen = torch.Generator(device="cuda").manual_seed(0)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zlosses, zms = [], []
        for _ in range(ZOO_STEPS):
            t0 = time.perf_counter()
            o = zstep(zv, zst, zx, zy, rng=gen)
            zlosses.append(float(o.loss))
            zms.append(1e3 * (time.perf_counter() - t0))
            zv, zst = o.variables, o.opt_state
        checks[f"{name}_needs_rng_for_dropout"] = needs_rng
        checks[f"{name}_losses_finite"] = bool(np.isfinite(zlosses).all())
        checks[f"{name}_loss_falls"] = min(zlosses[1:]) < zlosses[0]
        emit({"phase": "conv", "part": f"d_{name}", "image_size": zspec.extra["image_size"],
              "class_dim": 102, "batch": ZOO_BATCH,
              "params": sum(p.numel() for p in zv.params.values()), "losses": zlosses,
              "step_ms_with_loss_read": zms, "peak_memory_bytes": torch.cuda.max_memory_allocated(),
              "card": smi})
        del zv, zst, o
    set_flags(use_bf16_compute=True)
    emit({"phase": "conv", "checks": checks})
    return checks


def nmt_train_flops(cfg, batch, seq_len):
    """FLOPs of one NMT training step, counted from the model's shapes:
    2 per multiply-add, 3x the forward (forward + two backward products).
    Projections per token: the encoder layer's q/k/v/out (4 d^2) and FFN
    (2 d d_inner), the decoder layer's self and cross q/k/v/out (8 d^2) and
    FFN, and the vocabulary projection (d V); attention per layer and call:
    Q K^T and P V over every (query, key) pair, B T^2 d each, for the
    3 calls a layer pair makes. Padding is counted as the dense shapes
    compute it."""
    d, di, n = cfg["d_model"], cfg["d_inner"], cfg["n_layers"]
    tokens = batch * seq_len
    proj_macs = tokens * (n * (4 * d * d + 2 * d * di + 8 * d * d + 2 * d * di) + d * cfg["trg_vocab"])
    attn_macs = 3 * n * 2 * batch * seq_len * seq_len * d
    return 6 * proj_macs, 6 * attn_macs


def kernel_launch_counts():
    from paddle_tpu_torch.ops.cuda import build as kbuild

    return {n: k.launches for n, k in kbuild.KERNELS.items()}


def zero_kernel_counts():
    from paddle_tpu_torch.ops.cuda import build as kbuild

    for kern in kbuild.KERNELS.values():
        kern.launches = 0


def profiled_gemms(fn):
    """Run ``fn`` once under torch.profiler: ``(kernel launches, {GEMM kernel
    name: count})``, a GEMM being a kernel whose name says gemm/gemv,
    cutlass, xmma, nvjet or cublas."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    launches, gemms = 0, {}
    for evt in prof.key_averages():
        if "CUDA" not in str(getattr(evt, "device_type", "")) or getattr(evt, "is_user_annotation", False):
            continue
        launches += evt.count
        low = evt.key.lower()
        if any(t in low for t in ("gemm", "gemv", "cutlass", "xmma", "nvjet", "cublas")):
            gemms[evt.key[:120]] = gemms.get(evt.key[:120], 0) + evt.count
    return launches, gemms


def is_f32_gemm(name: str) -> bool:
    """A GEMM kernel on f32 operands: cuBLAS's SIMT sgemm, an xmma f32f32
    GEMM, or an nvjet kernel whose operand type letter is s (f32)."""
    low = name.lower()
    return "sgemm" in low or "f32f32" in low or low.startswith("nvjet_s")


def best_step_ms(fn, runs: int = 3) -> list:
    """Host-clock ms of ``runs`` calls of ``fn``, each ending in a sync."""
    import torch

    out = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append(1e3 * (time.perf_counter() - t0))
    return out


def grads_agreement(g, g_ref, floor_frac):
    """Per-parameter |g - g_ref|_2 / max(|g_ref|_2, floor_frac * the
    largest |g_ref|_2): the worst, its parameter and the median."""
    import numpy as np

    norms = {n: float(x.float().norm()) for n, x in g_ref.items()}
    floor = floor_frac * max(norms.values())
    rel = {n: float((g[n].float() - x.float()).norm()) / max(norms[n], floor)
           for n, x in g_ref.items()}
    worst = max(rel, key=rel.get)
    return {"grad_rel_l2_max": rel[worst], "grad_rel_l2_worst_param": worst,
            "grad_rel_l2_median": float(np.median(list(rel.values())))}


def nmt_phase(smi: str):
    """Phase 8: the NMT Transformer at bench.py's cell. Returns its kernel
    launches by path and its checks."""
    import numpy as np
    import torch

    from paddle_tpu_torch.backward import append_backward
    from paddle_tpu_torch.core.config import set_flags
    from paddle_tpu_torch.models import get_model
    from paddle_tpu_torch.ops.attention import scaled_dot_product_attention

    set_flags(use_flash_attention=True, use_bf16_compute=True, check_nan_inf=False)
    spec = get_model("transformer", seq_len=NMT_SEQ, scan_layers=True)
    cfg = spec.extra["cfg"]
    batch = spec.synth_batch(NMT_BATCH, np.random.RandomState(0))
    variables = spec.model.init(0, *batch)
    n_attn = 3 * cfg["n_layers"]
    checks, paths = {}, {}

    # (a) the published dropouts (0.1), Adam with Noam through minimize's
    # step with a CUDA generator; one seed per step, so every step draws
    # the same masks and the loss moves only with the parameters
    opt = spec.optimizer()
    opt_state = opt.create_state(variables.params)
    step = opt.minimize(spec.model)

    def run(v, st):
        return step(v, st, *batch, rng=torch.Generator(device="cuda").manual_seed(0))

    zero_kernel_counts()
    out = run(variables, opt_state)
    torch.cuda.synchronize()
    paths["nmt_train_published"] = kernel_launch_counts()
    losses = [float(out.loss)]
    v, st = out.variables, out.opt_state
    for _ in range(NMT_STEPS - 1):
        out = run(v, st)
        v, st = out.variables, out.opt_state
        losses.append(float(out.loss))
    del out, v, st
    torch.cuda.reset_peak_memory_stats()
    run(variables, opt_state)  # warm
    step_ms = best_step_ms(lambda: run(variables, opt_state))
    peak = torch.cuda.max_memory_allocated()
    launches, gemms = profiled_gemms(lambda: run(variables, opt_state))
    proj_flops, attn_flops = nmt_train_flops(cfg, NMT_BATCH, NMT_SEQ)
    best = min(step_ms)
    checks["a_no_flash_launch_with_attention_dropout"] = all(
        n == 0 for n in paths["nmt_train_published"].values())
    checks["a_loss_falls"] = losses[-1] < losses[0]
    checks["a_losses_finite"] = bool(np.isfinite(losses).all())
    checks["a_no_f32_gemm"] = bool(gemms) and not any(is_f32_gemm(k) for k in gemms)
    emit({"phase": "nmt", "part": "a_published_dropout", "model": "transformer",
          "cfg": {k: cfg[k] for k in ("d_model", "d_inner", "num_heads", "n_layers", "src_vocab",
                                      "trg_vocab", "attn_dropout", "relu_dropout",
                                      "residual_dropout", "scan_layers")},
          "params": sum(p.numel() for p in variables.params.values()), "batch": NMT_BATCH,
          "seq_len": NMT_SEQ, "optimizer": "Adam+NoamDecay", "losses": losses,
          "launches": paths["nmt_train_published"], "step_ms": best, "step_ms_runs": step_ms,
          "tokens_per_s": NMT_BATCH * NMT_SEQ / (best / 1e3),
          "flops_per_step": proj_flops + attn_flops, "projection_flops": proj_flops,
          "attention_flops": attn_flops,
          "mfu": (proj_flops + attn_flops) / (best / 1e3) / PEAK_BF16_FLOPS,
          "peak_memory_bytes": peak, "kernel_launches_per_step": launches, "gemm_kernels": gemms,
          "card": smi})
    del opt_state

    # (b) every dropout at 0: flash (structural masks) against composed
    # attention (additive masks), the loss and every gradient of one step
    spec0 = get_model("transformer", seq_len=NMT_SEQ, scan_layers=True, attn_dropout=0.0,
                      relu_dropout=0.0, residual_dropout=0.0)

    def loss_and_grads(flash):
        set_flags(use_flash_attention=flash)
        loss, (grads, _, _) = append_backward(spec0.model, *batch)(variables.params)
        return float(loss), grads

    zero_kernel_counts()
    loss_flash, g_flash = loss_and_grads(True)
    torch.cuda.synchronize()
    paths["nmt_train_dropout0"] = kernel_launch_counts()
    loss_comp, g_comp = loss_and_grads(False)
    agree = grads_agreement(g_flash, g_comp, TRAIN_GRAD_FLOOR)
    del g_flash, g_comp
    checks["b_launches_18_18_18"] = all(
        paths["nmt_train_dropout0"][k] == n_attn for k in ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq"))
    checks["b_loss_flash_vs_composed_within_tol"] = abs(loss_flash - loss_comp) <= TRAIN_LOSS_TOL
    checks["b_grads_flash_vs_composed_within_tol"] = agree["grad_rel_l2_max"] <= TRAIN_GRAD_TOL
    emit({"phase": "nmt", "part": "b_dropout0_flash_vs_composed",
          "launches": paths["nmt_train_dropout0"], "loss_flash": loss_flash,
          "loss_composed": loss_comp, "loss_abs_err": abs(loss_flash - loss_comp),
          "loss_tol": TRAIN_LOSS_TOL, "grad_tol": TRAIN_GRAD_TOL, "grad_floor": TRAIN_GRAD_FLOOR,
          **agree, "card": smi})

    # (c) eval at the published config: flash against composed, the loss and
    # the logits at non-pad positions (pad queries differ on purpose)
    with torch.no_grad():
        set_flags(use_flash_attention=True)
        zero_kernel_counts()
        (l_flash, _, lg_flash), _ = spec.model.apply(variables, *batch)
        torch.cuda.synchronize()
        paths["nmt_eval"] = kernel_launch_counts()
        set_flags(use_flash_attention=False)
        (l_comp, _, lg_comp), _ = spec.model.apply(variables, *batch)
        set_flags(use_flash_attention=True)
        valid = ~batch[3]
        logits_err = float((lg_flash[valid] - lg_comp[valid]).abs().max())
        del lg_flash, lg_comp
    checks["c_eval_forward_launches_18"] = paths["nmt_eval"]["flash_fwd"] == n_attn and (
        paths["nmt_eval"]["flash_bwd_dkv"] == paths["nmt_eval"]["flash_bwd_dq"] == 0)
    checks["c_eval_loss_within_tol"] = abs(float(l_flash) - float(l_comp)) <= NMT_EVAL_TOL
    checks["c_eval_logits_within_tol"] = logits_err <= NMT_EVAL_TOL
    emit({"phase": "nmt", "part": "c_eval_flash_vs_composed", "launches": paths["nmt_eval"],
          "loss_flash": float(l_flash), "loss_composed": float(l_comp),
          "loss_abs_err": abs(float(l_flash) - float(l_comp)),
          "logits_max_abs_err_non_pad": logits_err, "tol": NMT_EVAL_TOL, "card": smi})

    # (d) attention dropout on the card. Keep rate: q = k = 0 gives uniform
    # weights 1/T, and v = I (T x T) makes each output row the dropped
    # weight row, so out * T * keep rounds to the keep mask. Expectation:
    # over NMT_DROP_DRAWS masks the mean output minus the undropped one, its
    # total and a random-sign projection, each within 4 sigma of 0 (sigma
    # from the draws' spread).
    B, H, T, dh = NMT_BATCH, cfg["num_heads"], NMT_SEQ, cfg["d_model"] // cfg["num_heads"]
    rate = cfg["attn_dropout"]
    set_flags(use_flash_attention=False)  # the undropped reference composes too
    keep = 1.0 - rate
    gen = torch.Generator(device="cuda").manual_seed(1)
    with torch.no_grad():
        zeros = torch.zeros(B, H, T, dh, device="cuda")
        eye = torch.eye(T, device="cuda").expand(B, H, T, T).contiguous()
        out = scaled_dot_product_attention(zeros, zeros, eye, dropout_rate=rate, is_test=False,
                                           dropout_generator=gen)
        mask = out.float() * T * keep
        mask_err = float((mask - mask.round()).abs().max())
        kept = float(mask.round().sum())
        n = mask.numel()
        keep_rate = kept / n
        keep_sigma = (keep * rate / n) ** 0.5
        del zeros, eye, out, mask
        g2 = torch.Generator(device="cuda").manual_seed(2)
        q, k, v = (torch.randn(B, H, T, dh, generator=g2, device="cuda") for _ in range(3))
        ref = scaled_dot_product_attention(q, k, v).float()
        signs = torch.randint(0, 2, ref.shape, generator=g2, device="cuda").float() * 2 - 1
        stats = []
        for _ in range(NMT_DROP_DRAWS):
            diff = scaled_dot_product_attention(q, k, v, dropout_rate=rate, is_test=False,
                                                dropout_generator=gen).float() - ref
            stats.append([float(diff.sum()), float((diff * signs).sum())])
        del q, k, v, ref, signs, diff
    stats = np.asarray(stats)
    z = stats.mean(0) / (stats.std(0, ddof=1) / np.sqrt(len(stats)))
    checks["d_mask_recovered"] = mask_err < 0.05
    checks["d_keep_rate_within_4_sigma"] = abs(keep_rate - keep) <= 4 * keep_sigma
    checks["d_expectation_within_4_sigma"] = bool(np.all(np.abs(z) <= 4))
    emit({"phase": "nmt", "part": "d_attention_dropout", "shape": [B, H, T, dh], "rate": rate,
          "keep_rate": keep_rate, "keep_expected": keep, "keep_sigma": keep_sigma,
          "mask_round_err": mask_err, "draws": NMT_DROP_DRAWS,
          "expectation_z": z.tolist(), "card": smi})
    set_flags(use_flash_attention=True)
    emit({"phase": "nmt", "checks": checks})
    return paths, checks


def beam_lockstep(mt, cf, dims, params_gpu, src, lens, beam, max_len, bos, eos):
    """The machine_translation beam search on the card and on the CPU in
    lockstep, from the same weights: per step, each row's chosen candidates
    (source beam * V + token, best first). At the first step where a row's
    choice differs, the gap on the CPU's scores between the two candidates
    at the first differing rank is kept and the row is no longer compared.
    Returns (card result, CPU result, {row: (step, gap)})."""
    import functools

    import torch

    from paddle_tpu_torch import framework

    dec = framework.build(functools.partial(mt.infer_decoder, **dims, beam_size=beam))
    params_cpu = {n: p.cpu() for n, p in params_gpu.items()}
    B, V = src.shape[0], dims["vocab_size"]
    kw = dict(batch_size=B, beam_size=beam)
    sides = {}
    with torch.no_grad():
        for name, params, dev in (("gpu", params_gpu, "cuda"), ("cpu", params_cpu, "cpu")):
            (step_fn, carry), _ = dec.apply(params, src.to(dev), lens.to(dev))
            sides[name] = [step_fn, cf.beam_init(carry, **kw, bos_id=bos), [], []]
        diverged = {}
        for s in range(max_len):
            chosen = {}
            for name, side in sides.items():
                step_fn, state, toks, ptrs = side
                state, tok, src_beam, total = cf.beam_step(step_fn, state, **kw, vocab_size=V,
                                                           eos_id=eos)
                side[1] = state
                toks.append(tok)
                ptrs.append(src_beam)
                chosen[name] = ((src_beam.long() * V + tok.long()).cpu(), total.cpu())
            (idx_g, _), (idx_c, tot_c) = chosen["gpu"], chosen["cpu"]
            for b in range(B):
                if b in diverged or torch.equal(idx_g[b], idx_c[b]):
                    continue
                r = int((idx_g[b] != idx_c[b]).nonzero()[0])
                a, c = int(idx_c[b, r]), int(idx_g[b, r])
                diverged[b] = (s, abs(float(tot_c[b, a]) - float(tot_c[b, c])))
        results = {name: cf.beam_finish(side[1], side[2], side[3], eos)
                   for name, side in sides.items()}
    return results["gpu"], results["cpu"], diverged


def rnn_phase(smi: str):
    """Phase 9: stacked_dynamic_lstm and machine_translation at their
    get_model defaults, f32, and the beam search on the card against the
    CPU. Returns the phase's checks."""
    import numpy as np
    import torch

    from paddle_tpu_torch.core.config import set_flags
    from paddle_tpu_torch.models import get_model, machine_translation
    from paddle_tpu_torch.ops import control_flow as cf

    set_flags(use_bf16_compute=False, use_flash_attention=True, check_nan_inf=False)
    checks = {}
    trained = {}
    for name in ("stacked_dynamic_lstm", "machine_translation"):
        spec = get_model(name)
        batch = spec.synth_batch(RNN_BATCH, np.random.RandomState(0))
        variables = spec.model.init(0, *batch)
        opt = spec.optimizer()
        opt_state = opt.create_state(variables.params)
        step = opt.minimize(spec.model)
        losses, v, st = [], variables, opt_state
        for _ in range(RNN_STEPS):
            out = step(v, st, *batch)
            v, st = out.variables, out.opt_state
            losses.append(float(out.loss))
        trained[name] = (spec, v, batch)
        del out, st
        torch.cuda.reset_peak_memory_stats()
        step_ms = best_step_ms(lambda: step(variables, opt_state, *batch))
        peak = torch.cuda.max_memory_allocated()
        launches, _ = profiled_gemms(lambda: step(variables, opt_state, *batch))
        best = min(step_ms)
        words = RNN_BATCH * spec.examples_per_row
        checks[f"{name}_loss_falls"] = losses[-1] < losses[0]
        checks[f"{name}_losses_finite"] = bool(np.isfinite(losses).all())
        emit({"phase": "rnn", "model": name, "batch": RNN_BATCH, "seq_len": spec.examples_per_row,
              "params": sum(p.numel() for p in variables.params.values()), "dtype": "float32",
              "losses": losses, "step_ms": best, "step_ms_runs": step_ms,
              "words_per_s": words / (best / 1e3), "kernel_launches_per_step": launches,
              "peak_memory_bytes": peak, "card": smi})
        del variables, opt_state

    # the beam-search inference model, card against CPU, on the trained
    # machine_translation weights
    spec, v, batch = trained["machine_translation"]
    dims = {k: spec.extra[k] for k in ("vocab_size", "emb_dim", "hidden_dim")}
    src, lens = batch[0], batch[1]
    infer = spec.extra["make_infer_model"](beam_size=BEAM, max_len=BEAM_LEN)
    t0 = time.perf_counter()
    (seqs, scores), _ = infer.apply(v.params, src, lens)
    torch.cuda.synchronize()
    infer_s = time.perf_counter() - t0
    (g_seqs, g_scores), (c_seqs, c_scores), diverged = beam_lockstep(
        machine_translation, cf, dims, v.params, src, lens, BEAM, BEAM_LEN, 0, 1)
    same_rows = [b for b in range(src.shape[0]) if b not in diverged]
    checks["beam_entry_point_equals_lockstep"] = torch.equal(seqs, g_seqs)
    checks["beam_tokens_equal_or_near_tie"] = (
        torch.equal(g_seqs[same_rows].cpu(), c_seqs[same_rows])
        and all(gap < BEAM_TIE_TOL for _, gap in diverged.values()))
    checks["beam_shape"] = tuple(seqs.shape) == (RNN_BATCH, BEAM, BEAM_LEN)
    emit({"phase": "rnn", "part": "beam_search", "beam": BEAM, "max_len": BEAM_LEN,
          "batch": RNN_BATCH, "infer_s": infer_s,
          "rows_equal": len(same_rows), "diverged": {str(b): {"step": s, "gap": g}
                                                     for b, (s, g) in diverged.items()},
          "tie_tol": BEAM_TIE_TOL,
          "scores_max_abs_diff_equal_rows": float((g_scores[same_rows].cpu()
                                                   - c_scores[same_rows]).abs().max()),
          "card": smi})
    set_flags(use_bf16_compute=True)
    emit({"phase": "rnn", "checks": checks})
    return checks


def greedy_gap(params, cfg, prompt, ref, got):
    """Where two greedy continuations of ``prompt`` first differ: (index,
    the reference's logit of its own token minus its logit of the other's)
    along the reference's path (CachedDecoder, composed f32); None if equal
    over their common length."""
    import numpy as np
    import torch

    from paddle_tpu_torch.models import transformer_lm as tlm

    from paddle_tpu_torch.core.config import set_flags

    n = min(len(ref), len(got))
    diff = np.nonzero(np.asarray(ref[:n]) != np.asarray(got[:n]))[0]
    if not len(diff):
        return None
    j = int(diff[0])
    set_flags(use_flash_attention=False)
    with torch.no_grad():
        dec = tlm.CachedDecoder(params, cfg, 1, len(prompt) + j + 1)
        logits = dec.prefill(torch.as_tensor(prompt[None], device="cuda"))
        for s in range(j):
            logits = dec.step(torch.tensor([int(ref[s])], dtype=torch.int32, device="cuda"),
                              len(prompt) + s)
    set_flags(use_flash_attention=True)
    return j, float(logits[0, int(ref[j])] - logits[0, int(got[j])])


def serve_burst(params, cfg, reqs, decode_kw, profile=False, **engine_kw):
    """One DecodeEngine run: ``reqs`` [(prompt, max_new_tokens)] submitted
    together, launch counts set to 0 just before and read just after.
    Returns (outputs, stats); the engine is closed and its pages checked for
    leaks. With ``profile`` the burst runs under torch.profiler (CUDA
    kernels), for the busy time and the idle share."""
    import torch
    from torch.profiler import ProfilerActivity, profile as tprofile

    from paddle_tpu_torch.observability import metrics as obs_metrics
    from paddle_tpu_torch.serving import DecodeConfig, DecodeEngine
    from paddle_tpu_torch.tracing import waterfall

    engine = DecodeEngine(params, cfg, decode=DecodeConfig(**decode_kw), **engine_kw)
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()  # the weights, the pages, earlier phases' leftovers
        zero_kernel_counts()
        prof = tprofile(activities=[ProfilerActivity.CUDA]) if profile else None
        if prof is not None:
            prof.__enter__()
        t0 = time.perf_counter()
        handles = [engine.submit(p, n) for p, n in reqs]
        outs = [h.result(timeout=SERVE_WAIT_S) for h in handles]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        t_post = time.perf_counter()
        if prof is not None:
            prof.__exit__(None, None, None)
        launches = kernel_launch_counts()
        peak = torch.cuda.max_memory_allocated()
        docs = [waterfall.doc(h._req.rid) for h in handles]
        snap = engine.metrics.snapshot()
        step_p50 = obs_metrics.default_registry().quantile(
            "serving.decode.step_seconds", 0.5, {"engine": engine.metrics.engine_label})
        sizes = (engine.decode_step_cache_size(), engine.prefill_cache_size(),
                 engine.verify_step_cache_size())
        accept = engine.metrics.spec_accept_rate()
    finally:
        unjoined = engine.close(timeout=SERVE_WAIT_S)
    engine.kv.assert_no_leaks()
    stats = {"faults": {k: snap[k] for k in SERVE_FAULT_COUNTERS}, "wall_s": wall, "launches": launches, "peak_memory_bytes": peak,
             "traces": [h.trace for h in handles],
             "burst_memory_bytes": peak - before, "docs": docs,
             "metrics": snap, "step_p50_s_histogram": step_p50, "step_sizes": sizes,
             "spec_accept_rate": accept, "unjoined": unjoined, "no_leaks": True}
    if prof is not None:
        try:  # the raw device events: building the profiler's event tree
            # for the burst's ~10^5 kernels would take ~20 s of host time
            busy_us = 1e-3 * sum(e.duration_ns() for e in prof.profiler.kineto_results.events()
                                 if "CUDA" in str(e.device_type()) and not e.is_user_annotation())
        except AttributeError:
            busy_us = sum(evt.self_device_time_total for evt in prof.key_averages()
                          if "CUDA" in str(getattr(evt, "device_type", ""))
                          and not getattr(evt, "is_user_annotation", False))
        stats["busy_ms"] = busy_us / 1e3
        stats["idle_share"] = 1.0 - busy_us / 1e6 / wall if busy_us else None
        stats["profiler_post_s"] = time.perf_counter() - t_post
    return outs, stats


def held_against(params, cfg, prompts, refs, outs):
    """(all equal or near ties, {request: (index, gap)} where they differ)."""
    gaps = {}
    for i, (prompt, ref, out) in enumerate(zip(prompts, refs, outs)):
        g = greedy_gap(params, cfg, prompt, ref, out)
        if g is not None or len(ref) != len(out):
            gaps[i] = g if g is not None else (min(len(ref), len(out)), float("inf"))
    return all(abs(g) <= SERVE_TIE_TOL for _, g in gaps.values()), gaps


def beam_flash_lockstep(params, cfg, prompt, beam, max_len):
    """generate_beam's search with the prefill flash-routed and composed, in
    lockstep (the decode steps are the same math either way): per step,
    each row's chosen candidates. At the first step where a row's choice
    differs, the gap on the composed side's scores between the two
    candidates at the first differing rank is kept and the row is no longer
    compared. Returns (flash result, composed result, {row: (step, gap)})."""
    import torch

    from paddle_tpu_torch.core.config import set_flags
    from paddle_tpu_torch.models import transformer_lm as tlm
    from paddle_tpu_torch.ops import control_flow as cf

    B, tp = prompt.shape
    V = cfg["vocab"]
    kw = dict(batch_size=B, beam_size=beam)
    sides = {}
    with torch.no_grad():
        for name, flash in (("flash", True), ("composed", False)):
            set_flags(use_flash_attention=flash)
            dec = tlm.CachedDecoder(params, cfg, B, tp + max_len)
            dec.fill(prompt[:, :tp - 1])
            t = [tp - 1]

            def step_fn(carry, tokens, dec=dec, t=t):
                dec.k_cache, dec.v_cache = carry["k"].transpose(0, 1), carry["v"].transpose(0, 1)
                logits = dec.step(tokens, t[0])
                t[0] += 1
                return carry, torch.log_softmax(logits.float(), -1)

            carry = {"k": dec.k_cache.transpose(0, 1), "v": dec.v_cache.transpose(0, 1)}
            sides[name] = [step_fn, cf.beam_init(carry, **kw, bos_id=prompt[:, -1]), [], []]
        set_flags(use_flash_attention=True)
        diverged = {}
        for s in range(max_len):
            chosen = {}
            for name, side in sides.items():
                step_fn, state, toks, ptrs = side
                state, tok, src_beam, total = cf.beam_step(step_fn, state, **kw, vocab_size=V,
                                                           eos_id=1)
                side[1] = state
                toks.append(tok)
                ptrs.append(src_beam)
                chosen[name] = ((src_beam.long() * V + tok.long()).cpu(), total.cpu())
            (idx_f, _), (idx_c, tot_c) = chosen["flash"], chosen["composed"]
            for b in range(B):
                if b in diverged or torch.equal(idx_f[b], idx_c[b]):
                    continue
                r = int((idx_f[b] != idx_c[b]).nonzero()[0])
                a, c = int(idx_c[b, r]), int(idx_f[b, r])
                diverged[b] = (s, abs(float(tot_c[b, a]) - float(tot_c[b, c])))
        results = {name: cf.beam_finish(side[1], side[2], side[3], 1) for name, side in sides.items()}
    return results["flash"], results["composed"], diverged


def serve_phase(smi: str):
    """Phase 10: decode serving at BASE_CFG through DecodeEngine, and
    generate_beam. Returns its kernel launches by path and its checks."""
    import numpy as np
    import torch

    from paddle_tpu_torch.core.config import set_flags
    from paddle_tpu_torch.models import get_model, transformer_lm as tlm
    from paddle_tpu_torch.serving import DecodeConfig, DecodeEngine
    from paddle_tpu_torch.serving.metrics import _percentile

    set_flags(use_flash_attention=True, use_bf16_compute=False, check_nan_inf=False)
    marks = [time.perf_counter()]

    def lap():
        """Seconds since the previous lap (the part's host time)."""
        marks.append(time.perf_counter())
        return marks[-1] - marks[-2]

    spec = get_model("transformer_lm")  # BASE_CFG on CUDA
    cfg = spec.extra["cfg"]
    params = spec.model.init(0, *spec.synth_batch(1, np.random.RandomState(0))).params
    setup_s = lap()
    n_params = sum(p.numel() for p in params.values())
    rng = np.random.RandomState(0)
    lens = rng.randint(SERVE_PROMPT_LEN[0], SERVE_PROMPT_LEN[1] + 1, size=SERVE_REQUESTS)
    mnts = rng.randint(SERVE_NEW_TOKENS[0], SERVE_NEW_TOKENS[1] + 1, size=SERVE_REQUESTS)
    prompts = [rng.randint(1, cfg["vocab"], size=(int(n),)).astype(np.int32) for n in lens]
    reqs = [(p, int(n)) for p, n in zip(prompts, mnts)]
    checks, paths = {}, {}

    # (a) the mixed burst, then the same burst under the profiler
    outs_a, a = serve_burst(params, cfg, reqs, SERVE_CONFIG)
    outs_prof, a_prof = serve_burst(params, cfg, reqs, SERVE_CONFIG, profile=True)
    paths["serve"] = a["launches"]
    toks_a = [o.tokens for o in outs_a]
    # the profiled run batches the requests as its own timing falls, so its
    # steps may sum in another order: held to the near-tie rule too
    ok_prof, gaps_prof = held_against(params, cfg, prompts, toks_a, [o.tokens for o in outs_prof])
    set_flags(use_flash_attention=False)
    refs = [tlm.generate(params, torch.as_tensor(p[None], device="cuda"), n, cfg)[0].cpu().numpy()
            for p, n in reqs[:SERVE_CHECKED]]
    set_flags(use_flash_attention=True)
    ok_a, gaps_a = held_against(params, cfg, prompts, refs, toks_a[:SERVE_CHECKED])
    ttft = sorted(d["ttft_s"] for d in a["docs"])
    tpot = sorted(x for d in a["docs"] for x in d["tpot_s"])
    generated = sum(len(t) for t in toks_a)
    # one decode step at full occupancy, as the engine runs it: inputs to
    # the card, the step, the sampled tokens back (host clock + sync)
    engine = DecodeEngine(params, cfg, decode=DecodeConfig(**SERVE_CONFIG))
    try:
        S, P = SERVE_CONFIG["max_slots"], SERVE_CONFIG["max_context"] // SERVE_CONFIG["page_size"]
        tables = (1 + np.arange(S * P, dtype=np.int32)).reshape(S, P)
        positions = np.full((S,), SERVE_CONFIG["max_context"] * 11 // 16, np.int32)
        tokens = rng.randint(1, cfg["vocab"], size=(S,)).astype(np.int32)

        def one_step():
            with torch.no_grad():
                nxt = engine._step_call(engine._dev(tokens), engine._dev(positions),
                                        engine._dev(tables))
                return nxt.cpu()

        step_ms = best_step_ms(one_step, runs=21)
        step_launches, step_gemms = profiled_gemms(one_step)
    finally:
        engine.close(timeout=SERVE_WAIT_S)
    engine.kv.assert_no_leaks()
    checks.update({
        "a_tokens_equal_generate_or_near_tie": ok_a,
        "a_decode_step_one_shape": a["step_sizes"][0] == 1,
        "a_flash_launches_0": a["launches"]["flash_fwd"] == 0,
        "a_all_finished": all(o.finish_reason == "length" for o in outs_a),
        "a_lengths": [len(t) for t in toks_a] == [n for _, n in reqs],
        "a_profiled_run_equal_or_near_tie": ok_prof,
        "a_no_leaks": a["no_leaks"] and not a["unjoined"],
        "a_no_step_faults": not any(a["faults"].values()) and not any(a_prof["faults"].values()),
    })
    emit({"phase": "serve", "part": "a_mixed_burst", "setup_s": setup_s, "part_s": lap(),
          "profiler_post_s": a_prof.get("profiler_post_s"),
          "model": "transformer_lm", "params": n_params,
          "config": SERVE_CONFIG, "requests": SERVE_REQUESTS, "dtype": "float32",
          "prompt_len_mean": float(np.mean(lens)), "new_tokens_mean": float(np.mean(mnts)),
          "generated_tokens": generated, "wall_s": a["wall_s"],
          "generated_tokens_per_s": generated / a["wall_s"],
          "ttft_ms_p50": 1e3 * _percentile(ttft, 50), "ttft_ms_p99": 1e3 * _percentile(ttft, 99),
          "tpot_ms_p50": 1e3 * _percentile(tpot, 50), "tpot_ms_p99": 1e3 * _percentile(tpot, 99),
          "decode_step_ms_median": float(np.median(step_ms)), "decode_step_ms_runs": step_ms,
          "decode_step_ms_p50_engine_histogram": 1e3 * (a["step_p50_s_histogram"] or 0.0),
          "launches_per_decode_step": step_launches, "decode_step_gemms": step_gemms,
          "busy_ms_profiled": a_prof.get("busy_ms"), "wall_s_profiled": a_prof["wall_s"],
          "idle_share": a_prof.get("idle_share"),
          "faults": a["faults"], "faults_profiled": a_prof["faults"],
          "preemptions": a["metrics"]["preempted_total"],
          "steps": a["metrics"]["steps_total"], "prefill_chunks": a["metrics"]["prefill_chunks_total"],
          "peak_memory_bytes": a["peak_memory_bytes"],
          "burst_memory_bytes": a["burst_memory_bytes"],
          "profiled_run_first_differences": {str(i): {"index": j, "gap": g}
                                             for i, (j, g) in gaps_prof.items()},
          "decode_step_cache_size": a["step_sizes"][0], "prefill_cache_size": a["step_sizes"][1],
          "flash_launches": a["launches"]["flash_fwd"],
          "checked_vs_generate": SERVE_CHECKED,
          "first_differences": {str(i): {"index": j, "gap": g} for i, (j, g) in gaps_a.items()},
          "tie_tol": SERVE_TIE_TOL, "card": smi})

    # (b) the same burst on a starved page pool
    starved = dict(SERVE_CONFIG, num_pages=3 * (SERVE_CONFIG["max_context"]
                                                // SERVE_CONFIG["page_size"]) + 1)
    outs_b, b = serve_burst(params, cfg, reqs, starved)
    ok_b, gaps_b = held_against(params, cfg, prompts, toks_a, [o.tokens for o in outs_b])
    checks.update({
        "b_preemptions": b["metrics"]["preempted_total"] > 0,
        "b_tokens_equal_a_or_near_tie": ok_b,
        "b_decode_step_one_shape": b["step_sizes"][0] == 1,
        "b_no_leaks": b["no_leaks"] and not b["unjoined"],
        "b_no_step_faults": not any(b["faults"].values()),
    })
    emit({"phase": "serve", "part": "b_starved_pool", "part_s": lap(), "num_pages": starved["num_pages"],
          "wall_s": b["wall_s"], "generated_tokens_per_s": generated / b["wall_s"],
          "preemptions": b["metrics"]["preempted_total"],
          "resumes": b["metrics"]["resumed_total"], "flash_launches": b["launches"]["flash_fwd"],
          "faults": b["faults"],
          "first_differences": {str(i): {"index": j, "gap": g} for i, (j, g) in gaps_b.items()},
          "card": smi})

    # (c) a shared 512-token prefix: the first request prefills it (and the
    # tree takes its pages) before the other 15 arrive, with the cache and
    # without
    shared = rng.randint(1, cfg["vocab"], size=(SERVE_PREFIX,)).astype(np.int32)
    tails = rng.randint(SERVE_PREFIX_TAIL[0], SERVE_PREFIX_TAIL[1] + 1, size=SERVE_PREFIX_REQUESTS)
    pprompts = [np.concatenate([shared, rng.randint(1, cfg["vocab"], size=(int(n),)).astype(np.int32)])
                for n in tails]
    preqs = [(p, SERVE_PREFIX_NEW) for p in pprompts]
    outs_c, c, walls_c = {}, {}, {}
    for cached in (True, False):
        engine = DecodeEngine(params, cfg, decode=DecodeConfig(**SERVE_CONFIG, prefix_cache=cached))
        try:
            t0 = time.perf_counter()
            h0 = engine.submit(*preqs[0])
            deadline = time.monotonic() + SERVE_WAIT_S
            while not h0._req.generated and not h0.done():
                if time.monotonic() > deadline:
                    raise TimeoutError("serve (c): the first request never prefilled")
                time.sleep(0.001)
            handles = [h0] + [engine.submit(p, n) for p, n in preqs[1:]]
            outs_c[cached] = [h.result(timeout=SERVE_WAIT_S).tokens for h in handles]
            torch.cuda.synchronize()
            walls_c[cached] = time.perf_counter() - t0
            c[cached] = engine.metrics.snapshot()
        finally:
            unjoined = engine.close(timeout=SERVE_WAIT_S)
        engine.kv.assert_no_leaks()
        side = "cached" if cached else "uncached"
        checks[f"c_{side}_no_leaks"] = not unjoined
        checks[f"c_{side}_no_step_faults"] = not any(c[cached][k] for k in SERVE_FAULT_COUNTERS)
    ok_c, gaps_c = held_against(params, cfg, pprompts, outs_c[False], outs_c[True])
    checks.update({
        "c_prefix_hit_tokens": c[True]["prefix_hit_tokens_total"] >= (SERVE_PREFIX_REQUESTS - 1)
        * SERVE_PREFIX,
        "c_tokens_equal_uncached_or_near_tie": ok_c,
    })
    emit({"phase": "serve", "part": "c_prefix_cache", "part_s": lap(), "prefix": SERVE_PREFIX,
          "requests": SERVE_PREFIX_REQUESTS, "new_tokens": SERVE_PREFIX_NEW,
          "prefix_hit_tokens": c[True]["prefix_hit_tokens_total"],
          "saved_chunks": c[True]["prefix_saved_chunks_total"],
          "cow_copies": c[True]["cow_copies_total"],
          "prefill_chunks_cached": c[True]["prefill_chunks_total"],
          "prefill_chunks_uncached": c[False]["prefill_chunks_total"],
          "wall_s_cached": walls_c[True], "wall_s_uncached": walls_c[False],
          "faults": {side: {k: c[cached][k] for k in SERVE_FAULT_COUNTERS}
                     for side, cached in (("cached", True), ("uncached", False))},
          "first_differences": {str(i): {"index": j, "gap": g} for i, (j, g) in gaps_c.items()},
          "card": smi})

    # (d) speculative decoding, the target as its own draft
    sreqs = reqs[:SERVE_SPEC_REQUESTS]
    outs_d, d = serve_burst(params, cfg, sreqs, dict(SERVE_CONFIG, spec_tokens=SERVE_SPEC_TOKENS),
                            draft_variables=params)
    ok_d, gaps_d = held_against(params, cfg, prompts, toks_a[:SERVE_SPEC_REQUESTS],
                                [o.tokens for o in outs_d])
    checks.update({
        "d_tokens_equal_a_or_near_tie": ok_d,
        "d_verify_step_one_shape": d["step_sizes"][2] == 1,
        "d_no_leaks": d["no_leaks"] and not d["unjoined"],
        "d_no_step_faults": not any(d["faults"].values()),
    })
    emit({"phase": "serve", "part": "d_speculative", "part_s": lap(), "requests": SERVE_SPEC_REQUESTS,
          "spec_tokens": SERVE_SPEC_TOKENS, "acceptance_rate": d["spec_accept_rate"],
          "verify_steps": d["metrics"]["verify_steps_total"],
          "tokens_per_verify_step": (d["metrics"]["spec_tokens_total"]
                                     / max(d["metrics"]["verify_steps_total"], 1)),
          "wall_s": d["wall_s"], "faults": d["faults"],
          "first_differences": {str(i): {"index": j, "gap": g} for i, (j, g) in gaps_d.items()},
          "card": smi})

    # (e) generate_beam, flash prefill
    bprompt = torch.as_tensor(rng.randint(2, cfg["vocab"], size=(SERVE_BEAM_BATCH, SERVE_BEAM_PROMPT))
                              .astype(np.int32), device="cuda")
    zero_kernel_counts()
    t0 = time.perf_counter()
    seqs, scores = tlm.generate_beam(params, bprompt, BEAM_LEN, cfg, beam_size=BEAM)
    torch.cuda.synchronize()
    beam_s = time.perf_counter() - t0
    paths["generate_beam"] = kernel_launch_counts()
    (f_seqs, _), (c_seqs, c_scores), diverged = beam_flash_lockstep(params, cfg, bprompt, BEAM, BEAM_LEN)
    same = [r for r in range(SERVE_BEAM_BATCH) if r not in diverged]
    # the flash-routed entry point's scores against the composed search's,
    # on the rows whose beams agree
    scores_diff = float((scores[same] - c_scores[same]).abs().max()) if same else None
    checks.update({
        "e_flash_launches_eq_n_layers": paths["generate_beam"]["flash_fwd"] == cfg["n_layers"],
        "e_entry_point_equals_lockstep": torch.equal(seqs, f_seqs),
        "e_flash_equals_composed_or_near_tie": (
            torch.equal(f_seqs[same], c_seqs[same])
            and all(g < BEAM_TIE_TOL for _, g in diverged.values())),
        "e_shape": tuple(seqs.shape) == (SERVE_BEAM_BATCH, BEAM, BEAM_LEN),
        "e_scores_equal_rows_within_tol": scores_diff is None or scores_diff <= BEAM_TIE_TOL,
    })
    emit({"phase": "serve", "part": "e_generate_beam", "part_s": lap(), "batch": SERVE_BEAM_BATCH,
          "prompt_len": SERVE_BEAM_PROMPT, "beam": BEAM, "new_tokens": BEAM_LEN,
          "flash_launches": paths["generate_beam"]["flash_fwd"], "seconds": beam_s,
          "rows_equal": len(same),
          "diverged": {str(r): {"step": st, "gap": g} for r, (st, g) in diverged.items()},
          "scores_max_abs_diff_equal_rows": scores_diff,
          "tie_tol": BEAM_TIE_TOL, "card": smi})
    emit({"phase": "serve", "seconds": marks[-1] - marks[0], "checks": checks})
    set_flags(use_bf16_compute=True)
    return paths, checks


def tree_digest(tree) -> str:
    """sha256 over the bytes of every tensor leaf of ``tree`` in checkpoint
    order (and of the int leaves): two ranks' states are bit-equal exactly
    when their digests are."""
    import hashlib

    import torch

    from paddle_tpu_torch.core import tree as tree_mod

    h = hashlib.sha256()
    for leaf in tree_mod.leaves(tree):
        if isinstance(leaf, torch.Tensor):
            h.update(leaf.detach().contiguous().cpu().view(torch.uint8).numpy().tobytes())
        else:
            h.update(repr(leaf).encode())
    return h.hexdigest()


def dp_agreement(params, moment1, ref, init):
    """How a data-parallel run's state after DP_STEPS Adam steps stands
    against the one-rank run's (``ref``: its ``params`` and ``moment1``).
    - ``moment1``: Adam's first moment, a running mean of the reduced
      gradients: per parameter |m - m_ref|_2 / max(|m_ref|_2, TRAIN_GRAD_FLOOR
      x the largest |m_ref|_2), held to TRAIN_GRAD_TOL as phase train holds
      gradients. It also checks the gradients' scale, which Adam's update
      does not see.
    - ``movement``: the update, per parameter |p - p_ref|_2 / |p_ref -
      p_init|_2, held to DP_MOVEMENT_TOL. The attention k biases are left
      out: their gradient is zero in exact arithmetic (a constant added to
      all of a row's scores cancels in the softmax), so Adam moves them by
      ~lr in the direction of rounding noise in either run.
    Returns {metric: (worst value, its parameter, the median value)}."""
    import numpy as np

    def worst(rel):
        k = max(rel, key=rel.get)
        return rel[k], k, float(np.median(list(rel.values())))

    def norm(t):
        return float(t.float().norm())

    kbias = [k for k in ref["params"] if k.endswith("self_attn/k/b")]
    m_norm = {k: norm(t) for k, t in ref["moment1"].items()}
    m_floor = TRAIN_GRAD_FLOOR * max(m_norm.values())
    moved = {k: norm(ref["params"][k] - init[k]) for k in ref["params"] if k not in kbias}
    return {
        "moment1": worst({k: norm(moment1[k] - t) / max(m_norm[k], m_floor)
                          for k, t in ref["moment1"].items()}),
        "movement": worst({k: norm(params[k] - ref["params"][k]) / moved[k] for k in moved}),
    }


def nccl_kernel_ms(prof) -> dict:
    """Each NCCL event of a torch.profiler run, by name: its device ms (the
    kernels; c10d's ``nccl:*`` ranges carry their kernels' time) and its
    host ms."""
    out = {}
    for evt in prof.key_averages():
        if "nccl" in evt.key.lower():
            out[evt.key[:80]] = {"device_ms": evt.device_time_total / 1e3,
                                 "host_ms": evt.cpu_time_total / 1e3, "count": evt.count}
    return out


def dp_lm_rank(rank, work, profile):
    """One rank of phase dp (b)/(d): DataParallel steps of the LM at
    BASE_CFG on this rank's rows of the 8 x 1024 batch, plain and with
    ZeRO-1, from the seeded init; held against the one-rank run's
    parameters and Adam first moments in ``work/ref.pt``. The ZeRO-1 run
    saves a sharded checkpoint in ``work/ckpt``."""
    import numpy as np
    import torch

    from paddle_tpu_torch import checkpoint_sharded as cks
    from paddle_tpu_torch.core.config import set_flags
    from paddle_tpu_torch.models import get_model
    from paddle_tpu_torch.ops.cuda import build as kbuild
    from paddle_tpu_torch.parallel import DataParallel

    set_flags(use_flash_attention=True, use_bf16_compute=True, check_nan_inf=True)
    spec = get_model("transformer_lm")
    ids, labels = spec.synth_batch(TRAIN_BATCH, np.random.RandomState(0))
    v0 = spec.model.init(0, ids, labels)
    ref = torch.load(os.path.join(work, "ref.pt"), map_location=torch.device("cuda"))
    out = {"device": str(torch.cuda.current_device())}
    for zero in (False, True):
        dp = DataParallel(spec.model, spec.optimizer(), zero_shard_optimizer=zero)
        v, o = dp.init(0, ids, labels, variables=v0)
        losses, finite = [], []
        for kern in kbuild.KERNELS.values():
            kern.launches = 0
        for i in range(DP_STEPS):
            r = dp.step(v, o, ids, labels)
            v, o = r.variables, r.opt_state
            losses.append(float(r.loss))
            finite.append(bool(r.finite))
            if i == 0:
                first = {n: k.launches for n, k in kbuild.KERNELS.items()}
        slot_bytes = sum(t.numel() * t.element_size() for d in o.slots.values() for t in d.values())
        full = dp.full_state(v, o)[1]  # ZeRO-1's slots gathered whole
        res = out["zero1" if zero else "plain"] = {
            "losses": losses, "finite": all(finite), "launches_first_step": first,
            "rows": int(dp.put_batch(ids, labels)[0].shape[0]),
            "params_digest": tree_digest(v.params), "state_digest": tree_digest((v, full)),
            "agreement": dp_agreement(v.params, full.slots["moment1"], ref, v0.params),
            "slot_bytes": slot_bytes, "n_layers": spec.extra["cfg"]["n_layers"]}
        del full
        if zero:
            # with several ranks an async save is the sync save (the publish
            # barrier stays on the main thread): both timed here
            template = dp.state_template(v, o)
            t0 = time.perf_counter()
            path = cks.save_sharded(os.path.join(work, "ckpt"), (v, o), step=DP_STEPS,
                                    template=template)
            res["sync_save_s"] = time.perf_counter() - t0
            res["shard_bytes"] = os.path.getsize(os.path.join(path, f"shards_p{rank}.npz"))
            t0 = time.perf_counter()
            handle = cks.save_sharded_async(os.path.join(work, "ckpt_async"), (v, o),
                                            step=DP_STEPS, template=template)
            res["async_save_blocked_s"] = time.perf_counter() - t0
            res["async_save_published"] = os.path.isdir(handle.result(timeout=600))
        elif profile:
            from torch.profiler import ProfilerActivity, profile as tprofile

            torch.cuda.synchronize()
            with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                dp.step(v, o, ids, labels)
                torch.cuda.synchronize()
            out["nccl_ms"] = nccl_kernel_ms(prof)
        del dp, v, o, r
    return out


def rel_l2_from(a: dict, b: dict, base: dict) -> float:
    """|a - b|_2 over |b - base|_2, over every tensor of the dicts together
    (in f64): how far ``a`` is from ``b``, against how far ``b`` moved."""
    num = sum(float((a[k].double() - b[k].double()).norm()) ** 2 for k in b)
    den = sum(float((b[k].double() - base[k].double()).norm()) ** 2 for k in b)
    return (num / den) ** 0.5


def dp_resnet_rank(rank, work):
    """One rank of phase dp (c): one DataParallel step of ResNet-50 (64 x 64,
    f32) on this rank's 4 rows of the batch of 8, BN statistics over both
    ranks; the loss, the new BN state and the parameters' movement held
    against the one-rank step in ``work/resnet_ref.pt``."""
    import numpy as np
    import torch

    from paddle_tpu_torch.core.config import set_flags
    from paddle_tpu_torch.models import get_model
    from paddle_tpu_torch.parallel import DataParallel

    set_flags(use_bf16_compute=False, check_nan_inf=True)
    spec = get_model("resnet", dataset="flowers", depth=50, class_dim=1000,
                     image_size=DP_RESNET_SIZE)
    x, y = spec.synth_batch(DP_RESNET_BATCH, np.random.RandomState(1))
    v0 = spec.model.init(0, x, y)
    ref = torch.load(os.path.join(work, "resnet_ref.pt"), map_location=torch.device("cuda"))
    dp = DataParallel(spec.model, spec.optimizer())
    v, o = dp.init(0, x, y, variables=v0)
    r = dp.step(v, o, x, y)
    zeros = {k: torch.zeros_like(t) for k, t in ref["state"].items()}
    return {"loss": float(r.loss), "finite": bool(r.finite),
            "movement_rel_l2": rel_l2_from(r.variables.params, ref["params"], v0.params),
            "state_rel_l2": rel_l2_from(r.variables.state, ref["state"], zeros),
            "state_changed": all(not torch.equal(r.variables.state[k], v0.state[k])
                                 for k in v0.state),
            "digest": tree_digest(r.variables)}


def dp_reference(work: str):
    """The one-rank run phase dp (b) and (d) are held against: DP_STEPS of
    minimize's step of the LM at BASE_CFG on the 8 x 1024 batch from the
    seeded init; its parameters and Adam first moments go to
    ``work/ref.pt``. Then the control: the same steps on rank 0's rows
    alone (what a rank computes when the reduction does nothing), read by
    ``dp_agreement``. Returns the losses and the control's agreement."""
    import numpy as np
    import torch

    from paddle_tpu_torch.core.config import set_flags
    from paddle_tpu_torch.models import get_model

    set_flags(use_flash_attention=True, use_bf16_compute=True, check_nan_inf=True)
    spec = get_model("transformer_lm")
    ids, labels = spec.synth_batch(TRAIN_BATCH, np.random.RandomState(0))
    v0 = spec.model.init(0, ids, labels)
    opt = spec.optimizer()
    step, losses = opt.minimize(spec.model), []
    v, o = v0, opt.create_state(v0.params)
    for _ in range(DP_STEPS):
        r = step(v, o, ids, labels)
        v, o = r.variables, r.opt_state
        losses.append(float(r.loss))
    ref = {"params": v.params, "moment1": o.slots["moment1"]}
    os.makedirs(work, exist_ok=True)
    torch.save(ref, os.path.join(work, "ref.pt"))
    half = TRAIN_BATCH // 2
    v, o = v0, opt.create_state(v0.params)
    for _ in range(DP_STEPS):
        r = step(v, o, ids[:half], labels[:half])
        v, o = r.variables, r.opt_state
    control = dp_agreement(v.params, o.slots["moment1"], ref, v0.params)
    del v, o, r, ref, v0
    torch.cuda.empty_cache()
    return losses, control


def dp_control_exceeds_limits(control: dict) -> bool:
    """Whether the control run (rank 0's rows, no reduction) reads above
    both of phase dp's limits on its median parameter: a reduction that
    did nothing would fail them on most parameters, not on one."""
    return control["moment1"][2] > TRAIN_GRAD_TOL and control["movement"][2] > DP_MOVEMENT_TOL


def dp_held(res: dict, name: str, losses) -> dict:
    """Phase dp's checks of one rank's run (``dp_lm_rank``) against the
    one-rank run (``dp_reference``)."""
    return {
        f"{name}_losses_within_tol": all(
            abs(x - y) <= TRAIN_LOSS_TOL for x, y in zip(res["losses"], losses)),
        f"{name}_moment1_within_tol": res["agreement"]["moment1"][0] <= TRAIN_GRAD_TOL,
        f"{name}_movement_within_tol": res["agreement"]["movement"][0] <= DP_MOVEMENT_TOL,
        f"{name}_finite": res["finite"],
        f"{name}_six_launches_of_each_kernel": all(
            res["launches_first_step"][k] == res["n_layers"] for k in HOPPER_KERNELS)}


def dp_multi_card(smi: str, work: str, losses, control) -> dict:
    """Phase dp (d): one rank per card over NCCL (up to 4 cards), the LM
    plain and with ZeRO-1, held as (b) is; the NCCL kernels' device ms of
    one step. Returns its checks."""
    import torch

    from paddle_tpu_torch.parallel import launch

    n_cards = min(4, torch.cuda.device_count())
    ranks = launch.spawn(dp_lm_rank, n_cards, args=(work, True), device="cuda")
    checks = {}
    for r_i, res in enumerate(ranks):
        for name in ("plain", "zero1"):
            checks.update(dp_held(res[name], f"d_rank{r_i}_{name}", losses))
    checks["d_replicas_bit_equal"] = len({r["plain"]["params_digest"] for r in ranks}) == 1
    checks["d_zero1_equals_plain"] = all(
        r["zero1"]["params_digest"] == r["plain"]["params_digest"] for r in ranks)
    checks["d_one_rank_per_card"] = len({r["device"] for r in ranks}) == n_cards
    checks["d_control_exceeds_limits"] = dp_control_exceeds_limits(control)
    checks["d_async_saves_published"] = all(r["zero1"]["async_save_published"] for r in ranks)
    emit({"phase": "dp", "part": "d_nccl_multi", "cards": n_cards,
          "per_rank_batch": TRAIN_BATCH // n_cards, "one_rank_losses": losses, "ranks": ranks,
          "control": control, "loss_tol": TRAIN_LOSS_TOL, "moment1_tol": TRAIN_GRAD_TOL,
          "movement_tol": DP_MOVEMENT_TOL, "card": smi})
    return checks


def dp_phase(smi: str):
    """Phase 11: data parallelism. Returns its kernel launches by path and
    its checks."""
    import shutil
    import tempfile

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile as tprofile

    from paddle_tpu_torch import checkpoint_sharded as cks
    from paddle_tpu_torch.core import profiler as prof
    from paddle_tpu_torch.core.config import set_flags
    from paddle_tpu_torch.models import get_model
    from paddle_tpu_torch.ops.cuda import build as kbuild
    from paddle_tpu_torch.parallel import DataParallel, launch
    from paddle_tpu_torch.parallel import mesh as mesh_mod
    from paddle_tpu_torch.trainer import (BeginEpochEvent, BeginStepEvent, CheckpointConfig,
                                          EndStepEvent, Trainer)

    def counts():
        return {n: k.launches for n, k in kbuild.KERNELS.items()}

    def zero_counts():
        for kern in kbuild.KERNELS.values():
            kern.launches = 0

    checks, paths = {}, {}
    n_layers = None
    work = tempfile.mkdtemp(prefix="chip_smoke_dp_")
    mesh_mod.initialize_distributed(init_method=f"file://{work}/store", num_processes=1,
                                    process_id=0)
    try:
        # (a) one rank over NCCL: DataParallel's step against minimize's
        set_flags(use_flash_attention=True, use_bf16_compute=True, check_nan_inf=True)
        spec = get_model("transformer_lm")  # BASE_CFG, seq_len 1024, on CUDA
        n_layers = spec.extra["cfg"]["n_layers"]
        ids, labels = spec.synth_batch(TRAIN_BATCH, np.random.RandomState(0))
        v0 = spec.model.init(0, ids, labels)
        opt = spec.optimizer()
        o0 = opt.create_state(v0.params)
        direct = opt.minimize(spec.model)
        ref = direct(v0, o0, ids, labels)
        a = {}
        for zero in (False, True):
            dp = DataParallel(spec.model, spec.optimizer(), zero_shard_optimizer=zero)
            v, o = dp.init(0, ids, labels, variables=v0)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            zero_counts()
            out = dp.step(v, o, ids, labels)
            torch.cuda.synchronize()
            name = "zero1" if zero else "plain"
            a[name] = {"launches": counts(), "loss": float(out.loss),
                       "loss_equal": float(out.loss) == float(ref.loss),
                       "finite": bool(out.finite),
                       "state_max_abs_diff": state_max_abs_diff(
                           (out.variables, out.opt_state), (ref.variables, ref.opt_state)),
                       "peak_memory_bytes": torch.cuda.max_memory_allocated()}
            if not zero:
                paths["dp_step"] = a[name]["launches"]
                logits = out.outputs[2]
                a[name]["gathered_logits"] = {"shape": list(logits.shape),
                                              "bytes": logits.numel() * logits.element_size()}
                set_flags(check_nan_inf=False)  # timed as bench.py steps
                dp_ms, direct_ms = [], []
                for _ in range(3):  # in turns: direct, dp, direct, dp, ...
                    for fn, acc in ((lambda: direct(v0, o0, ids, labels), direct_ms),
                                    (lambda: dp.step(v, o, ids, labels), dp_ms)):
                        torch.cuda.synchronize()
                        t0 = time.perf_counter()
                        fn()
                        torch.cuda.synchronize()
                        acc.append(1e3 * (time.perf_counter() - t0))
                with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
                    dp.step(v, o, ids, labels)
                    torch.cuda.synchronize()
                set_flags(check_nan_inf=True)
                a[name].update(step_ms=min(dp_ms), step_ms_runs=dp_ms, direct_step_ms=min(direct_ms),
                               direct_step_ms_runs=direct_ms,
                               dp_minus_direct_ms=min(dp_ms) - min(direct_ms),
                               nccl_device_ms=nccl_kernel_ms(p))
            del dp, v, o, out
        for name, res in a.items():
            checks[f"a_{name}_bit_equal_to_minimize"] = res["loss_equal"] and \
                res["state_max_abs_diff"] == DP_ONE_RANK_TOL
            checks[f"a_{name}_six_launches_of_each_kernel"] = all(
                res["launches"][k] == n_layers for k in HOPPER_KERNELS)
            checks[f"a_{name}_finite"] = res["finite"]
        checks["a_nccl_kernels_ran"] = bool(a["plain"]["nccl_device_ms"])
        emit({"phase": "dp", "part": "a_one_rank_nccl", "model": "transformer_lm",
              "batch": TRAIN_BATCH, "seq_len": spec.extra["seq_len"], **a, "card": smi})

        del ref
        torch.cuda.empty_cache()
        # (b) two ranks on the one card over gloo
        b_dir = os.path.join(work, "b")
        losses, control = dp_reference(b_dir)
        t0 = time.perf_counter()
        ranks = launch.spawn(dp_lm_rank, 2, args=(b_dir, False), device="cuda:0", backend="gloo")
        b_s = time.perf_counter() - t0
        for r_i, res in enumerate(ranks):
            for name in ("plain", "zero1"):
                checks.update(dp_held(res[name], f"b_rank{r_i}_{name}", losses))
        checks["b_replicas_bit_equal"] = len({r["plain"]["params_digest"] for r in ranks}) == 1
        checks["b_zero1_equals_plain"] = all(
            r["zero1"]["params_digest"] == r["plain"]["params_digest"] for r in ranks)
        checks["b_zero1_slots_halved"] = all(
            2 * r["zero1"]["slot_bytes"] <= 1.01 * r["plain"]["slot_bytes"] for r in ranks)
        checks["b_rows_per_rank"] = all(r["plain"]["rows"] == TRAIN_BATCH // 2 for r in ranks)
        checks["b_control_exceeds_limits"] = dp_control_exceeds_limits(control)
        checks["b_async_saves_published"] = all(r["zero1"]["async_save_published"] for r in ranks)
        emit({"phase": "dp", "part": "b_two_ranks_gloo_one_card", "per_rank_batch": TRAIN_BATCH // 2,
              "one_rank_losses": losses, "ranks": ranks, "control": control, "seconds": b_s,
              "loss_tol": TRAIN_LOSS_TOL, "moment1_tol": TRAIN_GRAD_TOL,
              "movement_tol": DP_MOVEMENT_TOL, "card": smi,
              "note": "gloo carries every collective of this part on CUDA tensors (all_reduce, "
                      "broadcast, ZeRO-1's all_gather, barrier): it fails where one is refused"})

        # (c) BN across ranks: ResNet-50, 64 x 64, batch 8, f32
        set_flags(use_bf16_compute=False)
        rspec = get_model("resnet", dataset="flowers", depth=50, class_dim=1000,
                          image_size=DP_RESNET_SIZE)
        x, y = rspec.synth_batch(DP_RESNET_BATCH, np.random.RandomState(1))
        rv0 = rspec.model.init(0, x, y)
        ropt = rspec.optimizer()
        rstep = ropt.minimize(rspec.model)
        r1 = rstep(rv0, ropt.create_state(rv0.params), x, y)
        noise = torch.from_numpy(np.random.RandomState(2).randn(*x.shape).astype(np.float32))
        r2 = rstep(rv0, ropt.create_state(rv0.params), x * (1 + 1e-7 * noise.cuda()), y)

        zeros = {k: torch.zeros_like(t) for k, t in r1.variables.state.items()}
        spread = {"movement_rel_l2": rel_l2_from(r2.variables.params, r1.variables.params,
                                                 rv0.params),
                  "state_rel_l2": rel_l2_from(r2.variables.state, r1.variables.state, zeros)}
        c_dir = os.path.join(work, "c")
        os.makedirs(c_dir)
        torch.save({"params": r1.variables.params, "state": r1.variables.state},
                   os.path.join(c_dir, "resnet_ref.pt"))
        c_loss = float(r1.loss)
        del r1, r2, rv0, rstep, ropt, x, y
        torch.cuda.empty_cache()
        cranks = launch.spawn(dp_resnet_rank, 2, args=(c_dir,), device="cuda:0", backend="gloo")
        c_tol = {k: max(CONV_PARITY_MIN, CONV_PARITY_SPREAD * v) for k, v in spread.items()}
        for r_i, res in enumerate(cranks):
            checks[f"c_rank{r_i}_loss"] = abs(res["loss"] - c_loss) / abs(c_loss) <= CONV_PARITY_LOSS
            checks[f"c_rank{r_i}_params"] = res["movement_rel_l2"] <= c_tol["movement_rel_l2"]
            checks[f"c_rank{r_i}_bn_state"] = res["state_rel_l2"] <= c_tol["state_rel_l2"]
            checks[f"c_rank{r_i}_bn_state_changed"] = res["state_changed"] and res["finite"]
        checks["c_replicas_bit_equal"] = cranks[0]["digest"] == cranks[1]["digest"]
        emit({"phase": "dp", "part": "c_bn_two_ranks", "model": "resnet50",
              "image_size": DP_RESNET_SIZE, "batch": DP_RESNET_BATCH, "one_rank_loss": c_loss,
              "card_spread": spread, "tol": c_tol, "loss_tol": CONV_PARITY_LOSS, "ranks": cranks,
              "card": smi})
        set_flags(use_bf16_compute=True)

        # (d) one rank per card over NCCL
        if torch.cuda.device_count() >= 2:
            d_dir = os.path.join(work, "d")
            os.makedirs(d_dir)
            shutil.copy(os.path.join(b_dir, "ref.pt"), d_dir)
            checks.update(dp_multi_card(smi, d_dir, losses, control))
        else:
            emit({"phase": "dp", "nccl_multi": "not run: 1 device"})

        # (e) the LM through Trainer(parallel=True), sharded + async checkpoints
        rng = np.random.RandomState(0)
        batches = [spec.synth_batch(TRAIN_BATCH, rng) for _ in range(TRAINER_BATCHES)]
        root, copy = os.path.join(work, "e_ckpt"), os.path.join(work, "e_resume")

        def make_trainer(d):
            return Trainer(lambda: spec.model, spec.optimizer, parallel=True,
                           checkpoint_config=CheckpointConfig(
                               d, step_interval=TRAINER_CKPT_STEPS, max_num_checkpoints=2,
                               sharded=True, async_save=True))

        def handler(ev):
            if isinstance(ev, BeginStepEvent):
                marks["counts"] = counts()
            elif isinstance(ev, EndStepEvent):
                e_losses.append(ev.metrics)
                now = counts()
                per_step.append({n: now[n] - marks["counts"][n] for n in now})
            elif isinstance(ev, BeginEpochEvent) and ev.epoch == 1:
                shutil.copytree(root, copy)  # the epoch boundary's checkpoint

        e_losses, per_step, marks = [], [], {}
        trainer = make_trainer(root)
        prof.reset_metrics()
        zero_counts()
        trainer.train(num_epochs=TRAINER_EPOCHS, event_handler=handler,
                      reader=lambda: iter(batches))
        torch.cuda.synchronize()
        paths["dp_trainer"] = counts()
        writer_s = prof.histograms().get("checkpoint.async_write_seconds", {})
        resumed = make_trainer(copy)
        r_losses = []
        resumed.train(num_epochs=TRAINER_EPOCHS, reader=lambda: iter(batches),
                      event_handler=lambda ev: r_losses.append(ev.metrics)
                      if isinstance(ev, EndStepEvent) else None)
        resume_diff = state_max_abs_diff((trainer.variables, trainer.opt_state),
                                         (resumed.variables, resumed.opt_state))
        load_s = prof.histograms().get("checkpoint.load_seconds", {})
        tree = (trainer.variables, trainer.opt_state)
        template = trainer._dp.state_template(*tree)
        t0 = time.perf_counter()
        sync_dir = cks.save_sharded(os.path.join(work, "e_sync"), tree, step=99, template=template)
        sync_s = time.perf_counter() - t0
        sync_bytes = sum(os.path.getsize(os.path.join(sync_dir, f)) for f in os.listdir(sync_dir))
        t0 = time.perf_counter()
        handle = cks.save_sharded_async(os.path.join(work, "e_async"), tree, step=99,
                                        template=template)
        blocked_s = time.perf_counter() - t0
        handle.result(timeout=600)
        async_write = prof.histograms()["checkpoint.async_write_seconds"]
        # (b)'s two-rank ZeRO-1 checkpoint at one rank: every leaf whole
        (bv, bo), manifest = cks.load_sharded(os.path.join(b_dir, "ckpt"),
                                              (v0, opt.create_state(v0.params)))
        b_loaded = tree_digest((bv, bo)) == ranks[0]["plain"]["state_digest"]
        e_checks = {
            "e_steps": trainer.global_step == TRAINER_BATCHES * TRAINER_EPOCHS,
            "e_losses_finite": bool(np.isfinite(e_losses).all()),
            "e_six_launches_of_each_kernel_every_step": len(per_step) == len(e_losses) and all(
                c[k] == n_layers for c in per_step for k in HOPPER_KERNELS),
            "e_resumed_losses_equal": r_losses == e_losses[TRAINER_BATCHES:],
            "e_resumed_state_bit_equal": resume_diff == RESUME_TOL,
            "e_async_saves_published": writer_s.get("count", 0) >= 2,
            "e_two_rank_checkpoint_loads_at_one_rank": b_loaded and manifest["num_processes"] == 2,
        }
        checks.update(e_checks)
        emit({"phase": "dp", "part": "e_trainer_sharded_async", "batches": TRAINER_BATCHES,
              "epochs": TRAINER_EPOCHS, "launches": paths["dp_trainer"],
              "launches_per_step": per_step, "losses": e_losses,
              "resumed_losses": r_losses, "resume_max_abs_diff": resume_diff,
              "sync_save_s": sync_s, "sync_save_bytes": sync_bytes,
              "async_save_blocked_s": blocked_s, "async_writer_s": async_write.get("max"),
              "async_writer_s_in_training": writer_s, "load_s": load_s, "card": smi})
        del trainer, resumed, tree, template, bv, bo, v0, o0
    finally:
        mesh_mod.shutdown_distributed()
        shutil.rmtree(work, ignore_errors=True)
    return paths, checks


def lm_step_flops(cfg, batch, seq_len):
    """The LM step's model FLOPs: 6 x the products' weights x tokens
    (forward, and the two backward products), plus the causal attention's
    two products, 4·B·d·T(T+1)/2 a layer forward and 2.5 times that
    backward."""
    d, di, vocab, layers = cfg["d_model"], cfg["d_inner"], cfg["vocab"], cfg["n_layers"]
    weights = layers * (4 * d * d + 2 * d * di) + d * vocab
    attn = layers * 4 * batch * d * (seq_len * (seq_len + 1) // 2)
    return 6 * weights * batch * seq_len + attn * 7 // 2


def device_event_count(prof) -> int:
    """Device activities (kernels, copies, fills) a torch.profiler run
    recorded, from its raw events."""
    try:
        return sum(1 for e in prof.profiler.kineto_results.events()
                   if "CUDA" in str(e.device_type()) and not e.is_user_annotation())
    except AttributeError:
        return sum(evt.count for evt in prof.key_averages()
                   if "CUDA" in str(getattr(evt, "device_type", "")))


def telemetry_phase(smi: str):
    """Phase 12: the Trainer at BASE_CFG under the telemetry stack against
    the same Trainer without it, the exporter scraped while it trains,
    injected faults, and a DecodeEngine burst with tracing and the roofline
    ledger. Returns the telemetry-on run's kernel launches and the checks."""
    import shutil
    import tempfile
    import threading
    import urllib.request

    import numpy as np
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.profiler import ProfilerActivity, profile as tprofile

    from paddle_tpu_torch import observability as obs
    from paddle_tpu_torch import tracing
    from paddle_tpu_torch.core import profiler as prof
    from paddle_tpu_torch.core.config import set_flags
    from paddle_tpu_torch.models import get_model
    from paddle_tpu_torch.observability import exporter, mfu, roofline
    from paddle_tpu_torch.observability import runlog
    from paddle_tpu_torch.resilience import ResilienceConfig, faults
    from paddle_tpu_torch.trainer import BeginStepEvent, EndStepEvent, Trainer
    from paddle_tpu_torch.watch import RollingQuantileDetector, WatchConfig, WatchRule, default_hub

    set_flags(use_flash_attention=True, use_bf16_compute=True, check_nan_inf=False)
    spec = get_model("transformer_lm")  # BASE_CFG, seq_len 1024, on CUDA
    cfg, seq_len = spec.extra["cfg"], spec.extra["seq_len"]
    rng = np.random.RandomState(0)
    batches = [spec.synth_batch(TRAIN_BATCH, rng)
               for _ in range(max(TELEMETRY_STEPS, TELEMETRY_FAULT_STEPS))]
    init_vars = spec.model.init(0, *batches[0])
    init_state = spec.optimizer().create_state(init_vars.params)
    work = tempfile.mkdtemp(prefix="chip_smoke_telemetry_")
    watch_source = "watch.trainer.step_seconds"
    card = torch.device("cuda", torch.cuda.current_device())
    label = tracing.device_label(card)

    def scrape(url):
        with urllib.request.urlopen(url, timeout=30) as r:
            return r.read().decode()

    def run(on, steps, resilience=None, profile=False, log_dir=None, slow_step=None):
        """One Trainer from the initial state over ``steps`` batches, with the
        telemetry on or off: its losses, per-step launches, the ms between
        its step ends, and (on) what the exporter served. ``slow_step``: the
        step whose body runs TELEMETRY_STALL_S late (inside the timed step,
        as a slow step body is in the JAX package's Trainer too)."""
        tracing.reset_tracing()
        (tracing.enable_tracing if on else tracing.disable_tracing)()
        set_flags(roofline=on)
        kw = {}
        if on:
            kw["observability"] = obs.ObservabilityConfig(
                metrics_port=0, runlog_path=os.path.join(work, f"run{len(os.listdir(work))}.jsonl"))
            kw["watch"] = WatchConfig(enabled=True, use_default_rules=False, rules=[WatchRule(
                "trainer.step_seconds",
                RollingQuantileDetector(window=16, q=0.5, ratio=4.0, min_samples=4))])
        t = Trainer(lambda: spec.model, spec.optimizer, resilience=resilience, **kw)
        t.variables, t.opt_state = init_vars, init_state
        if slow_step is not None:
            run_step, calls = t._run_step, []

            def slow_run_step(batch):
                calls.append(1)
                if len(calls) == slow_step + 1:
                    time.sleep(TELEMETRY_STALL_S)
                return run_step(batch)

            t._run_step = slow_run_step
        losses, per_step, ends, marks, scrapes, scrape_errors = [], [], [], {}, [], []

        def handler(ev):
            if isinstance(ev, BeginStepEvent):
                marks["counts"] = kernel_launch_counts()
            elif isinstance(ev, EndStepEvent):
                ends.append(time.perf_counter())
                losses.append(ev.metrics)
                now = kernel_launch_counts()
                per_step.append({n: now[n] - marks["counts"][n] for n in now})

        stop = threading.Event()
        out = {}
        try:
            if on:
                url = obs.server().url

                def scraper():
                    while not stop.wait(0.2):
                        try:
                            scrapes.append(exporter.parse_text_exposition(scrape(url + "/metrics")))
                        except Exception as e:  # judged below: every scrape must parse
                            scrape_errors.append(repr(e))

                thread = threading.Thread(target=scraper, daemon=True)
                thread.start()
            p = tprofile(activities=[ProfilerActivity.CUDA]) if profile else None
            torch.cuda.synchronize()
            zero_kernel_counts()
            if p is not None:
                p.__enter__()
            if log_dir is not None:
                with prof.profiler(log_dir):
                    t.train(num_epochs=1, event_handler=handler,
                            reader=lambda: iter(batches[:steps]))
            else:
                t.train(num_epochs=1, event_handler=handler, reader=lambda: iter(batches[:steps]))
            torch.cuda.synchronize()
            if p is not None:
                p.__exit__(None, None, None)
                out["device_events"] = device_event_count(p)
            out["launches"] = kernel_launch_counts()
            if on:
                stop.set()
                thread.join(timeout=30)
                gauges = prof.gauges()
                rows = TRAIN_BATCH
                dt = rows / gauges["trainer.examples_per_sec"]  # the last good step's seconds
                peak = mfu.peak_flops(card)
                sample = tracing.sample_device_memory([card])[0]
                max_alloc = torch.cuda.max_memory_allocated()
                final = exporter.parse_text_exposition(scrape(url + "/metrics"))
                trace_doc = json.loads(scrape(url + "/trace"))
                out.update(
                    scrapes=len(scrapes), scrape_errors=scrape_errors, final=final,
                    mfu_gauge=gauges["trainer.mfu"], mfu_expected=t._step_flops / (dt * peak),
                    peak=peak, sample=sample, max_alloc=max_alloc, trace=trace_doc,
                    events=[e["kind"] for e in runlog.read_runlog(runlog.get_runlog().path)],
                    roofline=[r for r in roofline.snapshot() if r["kernel"] == "trainer_step"])
        finally:
            stop.set()
            t.stop()
            obs.shutdown()
        # the ms between step ends from the third step on (data wait and
        # handler included)
        out.update(step_flops=t._step_flops, goodput=t.goodput, losses=losses,
                   per_step=per_step, step_ms=[1e3 * (b - a) for a, b in zip(ends[1:-1], ends[2:])])
        return out

    def sample_of(fams, family, labels):
        for name, lbls, value in fams.get(family, {}).get("samples", []):
            if all(lbls.get(k) == v for k, v in labels.items()):
                return value
        return None

    checks = {}
    try:
        # (a) + (b): in turns, from the same weights and batches
        roofline.reset_ledger()
        turns = []
        for i in range(TELEMETRY_TURNS):
            for on in (False, True):
                turns.append((on, run(on, TELEMETRY_STEPS)))
        telemetry_launches = next(r for on, r in turns if on)["launches"]
        on_runs = [r for on, r in turns if on]
        off_runs = [r for on, r in turns if not on]
        prof_off, prof_on = (run(on, TELEMETRY_STEPS, profile=True) for on in (False, True))
        step_flops = on_runs[0]["step_flops"]
        analytic = lm_step_flops(cfg, TRAIN_BATCH, seq_len)
        # the CPU path's count of the same step: shapes only, no arithmetic
        cpu_spec = get_model("transformer_lm", device="cpu")
        with FakeTensorMode(allow_non_fake_inputs=True) as fake:
            ids, labels = (fake.from_tensor(b.cpu()) for b in batches[0])
            cpu_vars = cpu_spec.model.init(0, ids, labels, device="cpu")
            cpu_opt = cpu_spec.optimizer()
            with mfu.CostCounter() as cpu_count:
                cpu_opt.minimize(cpu_spec.model)(cpu_vars, cpu_opt.create_state(cpu_vars.params),
                                                 ids, labels)
        ledger = on_runs[0]["roofline"]
        last = on_runs[-1]
        final = last["final"]
        trace_events = last["trace"]["traceEvents"]
        compute_spans = [e for e in trace_events
                         if e.get("ph") == "X" and e.get("name") == "trainer.step_compute"]
        hbm_track = [e for e in trace_events
                     if e.get("ph") == "C" and e.get("name") == "device.hbm.bytes_in_use"]
        n_layers = cfg["n_layers"]
        checks.update({
            "a_losses_bit_equal_on_off": all(r["losses"] == off_runs[0]["losses"]
                                             for r in on_runs + off_runs),
            "a_launches_per_step_6_each_on_off": all(
                s == {k: n_layers for k in s} for r in on_runs + off_runs for s in r["per_step"]),
            "a_profiler_device_events_equal_on_off":
                prof_on["device_events"] == prof_off["device_events"] > 0,
            "a_mfu_gauge_is_counted_flops_over_step_s_x_peak": all(
                abs(r["mfu_gauge"] / r["mfu_expected"] - 1.0) <= 1e-9 for r in on_runs),
            "a_flops_within_tol_of_analytic":
                abs(step_flops / analytic - 1.0) <= TELEMETRY_FLOPS_TOL,
            "a_flops_equal_cpu_count": step_flops == cpu_count.flops,
            "a_ledger_row_counts_the_same_flops":
                len(ledger) == 1 and ledger[0]["flops"] == step_flops,
            "b_every_scrape_parsed": all(r["scrapes"] >= 1 and not r["scrape_errors"]
                                         for r in on_runs),
            "b_metrics_families": all(
                f in final for f in ("trainer_mfu", "trainer_goodput_frac", "trainer_step_seconds",
                                     "device_hbm_bytes_in_use", "device_hbm_peak_bytes_in_use",
                                     "device_hbm_bytes_limit")),
            "b_hbm_gauges_for_the_card": all(
                sample_of(final, f, {"device": label}) is not None
                for f in ("device_hbm_bytes_in_use", "device_hbm_peak_bytes_in_use",
                          "device_hbm_bytes_limit")),
            "b_memory_source_is_memory_stats": last["sample"]["source"] == "memory_stats",
            "b_peak_gauge_is_max_memory_allocated":
                last["sample"]["peak_bytes_in_use"] == last["max_alloc"]
                == sample_of(final, "device_hbm_peak_bytes_in_use", {"device": label}),
            "b_trace_validates": bool(tracing.validate_chrome_trace(last["trace"])),
            "b_trace_has_every_step_compute_span": len(compute_spans) == TELEMETRY_STEPS,
            "b_trace_has_memory_counter_track": len(hbm_track) >= TELEMETRY_STEPS,
        })

        # (b) core.profiler.profiler(log_dir) over two steps: torch.profiler's
        # trace holds the three kernels, six launches each a step
        log_dir = os.path.join(work, "profile")
        run(False, 2, log_dir=log_dir)
        with open(os.path.join(log_dir, "trace.chrome.json")) as f:
            names = [e.get("name", "") for e in json.load(f)["traceEvents"]
                     if e.get("cat") == "kernel"]
        traced = {k: sum(f"{k}_bf16_kernel" in n for n in names) for k in HOPPER_KERNELS}
        checks["b_profiler_trace_holds_the_three_kernels"] = all(
            n == 2 * n_layers for n in traced.values())

        # (c) faults: a NaN step under skip_step, then a slow step body
        flags0 = prof.counters().get("tracing.straggler.flags_total", 0.0)
        alerts0 = len(default_hub().alerts(source=watch_source))
        with faults.injected(
                faults.FaultSpec(faults.TRAINER_STEP, "nan", after=TELEMETRY_NAN_STEP)):
            fault_run = run(True, TELEMETRY_FAULT_STEPS,
                            resilience=ResilienceConfig(nan_policy="skip_step"),
                            slow_step=TELEMETRY_STALL_STEP)
        goodput = fault_run["goodput"]
        flags = prof.counters().get("tracing.straggler.flags_total", 0.0) - flags0
        alerts = default_hub().alerts(source=watch_source)[alerts0:]
        badput = goodput.badput_by_category()
        checks.update({
            "c_stall_flags_the_straggler_once": flags == 1,
            "c_stall_fires_the_watch_alert": len(alerts) >= 1,
            "c_nan_skip_badput": badput.get("nan_skip", 0.0) > 0,
            "c_goodput_frac_below_1": goodput.goodput_frac() < 1.0
            and sample_of(fault_run["final"], "trainer_goodput_frac", {}) < 1.0,
            "c_runlog_nan_skip_and_straggler": "nan_skip" in fault_run["events"]
            and "straggler" in fault_run["events"],
        })

        # (d) DecodeEngine: tracing and the ledger on, then both off
        set_flags(use_bf16_compute=False, roofline=True)
        tracing.enable_tracing()
        srng = np.random.RandomState(0)
        lens = srng.randint(SERVE_PROMPT_LEN[0], SERVE_PROMPT_LEN[1] + 1, size=SERVE_REQUESTS)
        mnts = srng.randint(SERVE_NEW_TOKENS[0], SERVE_NEW_TOKENS[1] + 1, size=SERVE_REQUESTS)
        prompts = [srng.randint(1, cfg["vocab"], size=(int(n),)).astype(np.int32) for n in lens]
        reqs = [(p, int(n)) for p, n in zip(prompts, mnts)][:TELEMETRY_SERVE_REQUESTS]
        params = spec.model.init(0, *spec.synth_batch(1, np.random.RandomState(0))).params
        roofline.reset_ledger()
        tracing.reset_tracing()
        outs_on, s_on = serve_burst(params, cfg, reqs, SERVE_CONFIG)
        rows = {r["kernel"]: r for r in roofline.snapshot()}
        trees = []
        for trace in s_on["traces"]:
            spans = tracing.spans_for_trace(trace.trace_id)
            trees.append({"problems": tracing.validate_trace(spans),
                          "names": sorted({s.name for s in spans})})
        tracing.disable_tracing()
        set_flags(roofline=False)
        outs_off, s_off = serve_burst(params, cfg, reqs, SERVE_CONFIG)
        tracing.enable_tracing()
        set_flags(roofline=True)
        ok_tokens, gaps = held_against(params, cfg, [p for p, _ in reqs],
                                       [o.tokens for o in outs_off], [o.tokens for o in outs_on])
        ledger_rows = {k: {f: rows[k].get(f) for f in (
            "key", "flops", "bytes", "bytes_source", "peak_hbm_bytes", "arithmetic_intensity",
            "predicted_device_s", "calls", "min_s", "total_s", "overhead_frac", "verdict")}
            for k in ("serving.decode.step", "serving.decode.prefill") if k in rows}
        checks.update({
            "d_tokens_equal_tracing_off_or_near_tie": ok_tokens,
            "d_every_request_has_a_complete_span_tree": all(
                not t["problems"] and {"serving.decode.request", "serving.decode.queue_wait",
                                       "serving.decode.prefill"} <= set(t["names"])
                for t in trees),
            "d_no_step_faults": all(v == 0 for s in (s_on, s_off) for v in s["faults"].values()),
            "d_ledger_rows_for_step_and_prefill": len(ledger_rows) == 2 and all(
                r["flops"] > 0 and r["bytes"] > 0 and r["calls"] > 0 and r["verdict"]
                for r in ledger_rows.values()),
            "d_flash_launches_0": s_on["launches"]["flash_fwd"] == 0,
        })
    finally:
        set_flags(roofline=True, use_bf16_compute=True)
        tracing.enable_tracing()
        shutil.rmtree(work, ignore_errors=True)

    def ms_stats(rs):
        all_ms = [m for r in rs for m in r["step_ms"]]
        return {"median": float(np.median(all_ms)), "min": min(all_ms), "runs": [r["step_ms"] for r in rs]}

    emit({"phase": "telemetry", "card": smi, "model": "transformer_lm", "batch": TRAIN_BATCH,
          "seq_len": seq_len, "steps_per_run": TELEMETRY_STEPS, "turns": TELEMETRY_TURNS,
          "step_ms_on": ms_stats(on_runs), "step_ms_off": ms_stats(off_runs),
          "step_ms_overhead_median": ms_stats(on_runs)["median"] - ms_stats(off_runs)["median"],
          "counted_flops": step_flops, "analytic_flops": analytic,
          "cpu_counted_flops": cpu_count.flops, "counted_bytes": ledger[0]["bytes"] if ledger else None,
          "cpu_flops_by_op": dict(cpu_count.by_op),
          "peak_flops": on_runs[-1]["peak"], "device_kind": mfu.device_kind(card),
          "mfu_gauges": [r["mfu_gauge"] for r in on_runs],
          "trainer_ledger": ledger[0] if ledger else None,
          "device_events_per_run": {"on": prof_on["device_events"], "off": prof_off["device_events"]},
          "scrapes_per_run": [r["scrapes"] for r in on_runs],
          "memory_sample": last["sample"], "max_memory_allocated": last["max_alloc"],
          "profiler_kernels": traced, "straggler_flags": flags, "watch_alerts": len(alerts),
          "badput": badput, "goodput_frac": goodput.goodput_frac(),
          "serve": {"requests": len(reqs), "wall_s_on": s_on["wall_s"], "wall_s_off": s_off["wall_s"],
                    "token_gaps": gaps, "span_names": trees[0]["names"] if trees else None,
                    "ledger": ledger_rows, "faults": s_on["faults"]},
          "checks": checks})
    print(smi, flush=True)
    return telemetry_launches, checks


def _rel_l2(a, b) -> float:
    """||a - b|| / ||b|| over float32 copies."""
    a, b = a.float(), b.float()
    return float((a - b).norm() / b.norm())


def infer_phase(smi: str):
    """Phase 13: the inference-deployment slice on the card — static serving
    of the LM through ServingEngine against the unbatched Inferencer,
    ResNet-50 eval with BN folded (direct and served), the exported LM
    program's round trip, and the fluid_benchmark CLI. Returns the kernel
    launches of its paths and the checks."""
    import shutil
    import tempfile

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile as tprofile

    import paddle_tpu_torch as pt
    from paddle_tpu_torch import benchmark, framework, io
    from paddle_tpu_torch.core.config import set_flags
    from paddle_tpu_torch.models import get_model, resnet, transformer_lm
    from paddle_tpu_torch.reader.feeder import FeedSpec
    from paddle_tpu_torch.serving import ServingConfig, ServingEngine
    from paddle_tpu_torch.transpiler.inference import find_conv_bn_pairs, inference_optimize

    checks, paths = {}, {}
    work = tempfile.mkdtemp(prefix="chip_smoke_infer_")
    try:
        # (a) static serving of the LM at BASE_CFG, ragged prompts in length buckets
        set_flags(use_flash_attention=True, use_bf16_compute=True, check_nan_inf=False)
        spec = get_model("transformer_lm")  # BASE_CFG, on CUDA
        cfg = spec.extra["cfg"]
        n_layers = cfg["n_layers"]
        rng = np.random.RandomState(0)
        variables = spec.model.init(0, *spec.synth_batch(1, rng))
        net = framework.build(
            lambda tokens: transformer_lm.lm_forward(tokens, tokens, cfg=cfg)[2],
            name="transformer_lm_logits")
        t0 = time.perf_counter()
        engine = ServingEngine(
            net, variables, [FeedSpec("tokens", (None,), "int32")],
            config=ServingConfig(max_batch_size=INFER_MAX_BATCH, num_replicas=1,
                                 length_buckets=INFER_LENGTH_BUCKETS, engine_label="infer_lm"))
        warm_s = time.perf_counter() - t0
        lengths = rng.randint(INFER_PROMPT_LENS[0], INFER_PROMPT_LENS[1] + 1, size=INFER_REQUESTS)
        prompts = [rng.randint(1, cfg["vocab"], size=(1, n)).astype(np.int32) for n in lengths]
        try:
            sizes0 = engine.aot_cache_sizes()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            zero_kernel_counts()
            t0 = time.perf_counter()
            pending = [engine.submit({"tokens": p}) for p in prompts]
            outs = [p.result(timeout=INFER_WAIT_S) for p in pending]
            wall = time.perf_counter() - t0
            paths["infer_serve"] = kernel_launch_counts()
            peak_a = torch.cuda.max_memory_allocated()
            snap = engine.metrics.snapshot()
            sizes1 = engine.aot_cache_sizes()
        finally:
            unjoined = engine.close(timeout=INFER_WAIT_S)
        param_dir = os.path.join(work, "lm_params")
        pt.io.save_params(param_dir, variables)
        inferencer = pt.Inferencer(net, param_dir)
        zero_kernel_counts()
        errs = [float((out[:, :p.shape[1]].float()
                       - inferencer.infer([p]).float().cpu()).abs().max())
                for p, out in zip(prompts, outs)]
        paths["infer_inferencer"] = kernel_launch_counts()
        del inferencer
        launches_per_batch = paths["infer_serve"]["flash_fwd"] / max(1, snap["batches_total"])
        a_checks = {
            "a_logits_vs_unbatched_inferencer": max(errs) <= INFER_LOGITS_TOL,
            "a_logits_shape": all(tuple(o.shape) == (1, min(b for b in INFER_LENGTH_BUCKETS
                                                          if b >= p.shape[1]), cfg["vocab"])
                                  for p, o in zip(prompts, outs)),
            "a_cache_sizes_steady": sizes1 == sizes0,
            "a_flash_launches_per_batch_eq_n_layers": launches_per_batch == n_layers,
            "a_no_error_or_fault": snap["errors_total"] == 0 and snap["timeouts_total"] == 0
            and snap["replica_ejections_total"] == 0 and snap["redispatches_total"] == 0,
            "a_all_answered_nothing_pending": snap["responses_total"] == INFER_REQUESTS
            and all(p.done() for p in pending) and unjoined == [],
            "a_mean_occupancy_above_1": snap["mean_batch_occupancy"] > 1.0,
        }
        checks.update(a_checks)
        emit({"phase": "infer", "part": "a_static_serving_lm", "card": smi,
              "requests": INFER_REQUESTS, "prompt_lens": [int(n) for n in lengths],
              "length_buckets": list(INFER_LENGTH_BUCKETS), "max_batch_size": INFER_MAX_BATCH,
              "warmup_s": warm_s, "wall_s": wall, "requests_per_s": INFER_REQUESTS / wall,
              "p50_ms": snap["p50_ms"], "p99_ms": snap["p99_ms"],
              "mean_batch_occupancy": snap["mean_batch_occupancy"],
              "batches": snap["batches_total"], "padded_batches": snap["padded_batches_total"],
              "aot_cache_sizes_before": sizes0, "aot_cache_sizes_after": sizes1,
              "flash_launches_per_batch": launches_per_batch,
              "launches": paths["infer_serve"], "inferencer_launches": paths["infer_inferencer"],
              "logits_dtype": str(outs[0].dtype), "logits_max_abs_err_vs_inferencer": max(errs),
              "logits_tol": INFER_LOGITS_TOL, "peak_memory_bytes": peak_a, "checks": a_checks})
        del outs, pending

        # (b) ResNet-50 eval at bench.py's cell, f32, BN folded
        set_flags(use_bf16_compute=False)
        rspec = get_model("resnet", dataset="flowers", depth=50, class_dim=1000,
                          image_size=INFER_IMAGE_SIZE)
        x, y = rspec.synth_batch(INFER_RESNET_BATCH, rng)
        rvars = rspec.model.init(0, x, y)
        state = rvars.state
        with torch.no_grad():  # moving statistics a few train-mode batches in
            for _ in range(INFER_BN_WARM_BATCHES):
                state = rspec.model.apply(framework.Variables(rvars.params, state),
                                          *rspec.synth_batch(INFER_RESNET_BATCH, rng),
                                          is_train=True)[1]
        rvars = framework.Variables(rvars.params, state)
        rnet = framework.build(lambda im: resnet.resnet_imagenet(im, class_dim=1000, depth=50),
                               name="resnet50_logits")
        predict, folded = inference_optimize(rnet, rvars)
        with torch.no_grad():
            ref = rnet.apply(rvars, x)[0]
            spread = _rel_l2(rnet.apply(rvars, x * (1 + 1e-7))[0], ref)
        fold_err = _rel_l2(predict(folded, x), ref)
        fold_tol = max(CONV_PARITY_MIN, CONV_PARITY_SPREAD * spread)
        x32 = rspec.synth_batch(INFER_RESNET_SERVE_MAX, rng)[0]

        def timed(v):
            with torch.no_grad():
                torch.cuda.synchronize()
                t = time.perf_counter()
                rnet.apply(v, x32)
                torch.cuda.synchronize()
                return time.perf_counter() - t

        timed(rvars), timed(folded)
        runs = {"unfolded": [], "folded": []}
        for name in ("unfolded", "folded", "folded", "unfolded") * 2:  # in turns
            runs[name].append(timed(rvars if name == "unfolded" else folded))
        side = INFER_IMAGE_SIZE
        images = rng.rand(INFER_RESNET_REQUESTS, side, side, 3).astype(np.float32)
        engine = ServingEngine(rnet, folded, [FeedSpec("image", (side, side, 3), "float32")],
                               config=ServingConfig(max_batch_size=INFER_RESNET_SERVE_MAX,
                                                    num_replicas=1, engine_label="infer_resnet"))
        try:
            sizes0 = engine.aot_cache_sizes()
            t0 = time.perf_counter()
            pending = [engine.submit({"image": images[i:i + 1]}) for i in range(len(images))]
            served = torch.cat([p.result(timeout=INFER_WAIT_S) for p in pending])
            served_s = time.perf_counter() - t0
            rsnap, sizes1 = engine.metrics.snapshot(), engine.aot_cache_sizes()
        finally:
            unjoined = engine.close(timeout=INFER_WAIT_S)
        direct = torch.cat([predict(folded, torch.from_numpy(images[i:i + 32]).cuda()).cpu()
                            for i in range(0, len(images), 32)])
        served_err = _rel_l2(served, direct)
        b_checks = {
            "b_pairs_found": len(find_conv_bn_pairs(rvars)) == INFER_RESNET_BN_PAIRS,
            "b_folded_vs_unfolded_within_card_spread": fold_err <= fold_tol,
            "b_served_vs_direct_folded": served_err <= fold_tol,
            "b_served_finite": bool(torch.isfinite(served).all()),
            "b_cache_sizes_steady": sizes0 == sizes1,
            "b_served_no_error": rsnap["errors_total"] == 0 and unjoined == []
            and rsnap["responses_total"] == len(images),
        }
        checks.update(b_checks)
        emit({"phase": "infer", "part": "b_resnet50_bn_folded", "card": smi,
              "batch": INFER_RESNET_BATCH, "bn_pairs": len(find_conv_bn_pairs(rvars)),
              "folded_rel_l2": fold_err, "card_spread_rel_l2": spread, "tol": fold_tol,
              "ms_batch32": {k: [1e3 * s for s in v] for k, v in runs.items()},
              "images_per_s_batch32": {k: INFER_RESNET_SERVE_MAX / min(v)
                                       for k, v in runs.items()},
              "served_images_per_s": len(images) / served_s, "served_requests": len(images),
              "served_mean_batch_occupancy": rsnap["mean_batch_occupancy"],
              "served_p50_ms": rsnap["p50_ms"], "served_p99_ms": rsnap["p99_ms"],
              "served_rel_l2_vs_direct": served_err, "checks": b_checks})
        del rvars, folded, served, direct

        # (c) the exported LM program: save, load, run on the card
        set_flags(use_bf16_compute=True, use_flash_attention=True)
        ids = torch.as_tensor(rng.randint(1, cfg["vocab"], size=INFER_EXPORT_SHAPE)
                              .astype(np.int32), device="cuda")
        d = os.path.join(work, "lm_export")
        t0 = time.perf_counter()
        io.save_inference_model(d, net, variables, [ids])
        save_s = time.perf_counter() - t0
        graph_ops = [n.target for n in torch.export.load(os.path.join(d, "program.pt2")).graph.nodes
                     if n.op == "call_function"]
        t0 = time.perf_counter()
        run, _ = io.load_inference_model(d)
        load_s = time.perf_counter() - t0
        with torch.no_grad():
            eager = net.apply(variables, ids)[0]
        run(ids)
        torch.cuda.synchronize()
        zero_kernel_counts()
        with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof_c:
            got = run(ids)
            torch.cuda.synchronize()
        paths["infer_export"] = kernel_launch_counts()
        names = [e.name for e in prof_c.events()]
        c_checks = {
            "c_loaded_logits_bit_equal_eager": bool(torch.equal(got, eager)),
            "c_loaded_program_flash_launches_eq_n_layers":
                paths["infer_export"]["flash_fwd"] == n_layers,
            "c_graph_holds_the_flash_operator": graph_ops.count(
                torch.ops.paddle_tpu_torch.flash_fwd.default) == n_layers,
            "c_no_library_attention": not any("scaled_dot_product" in n for n in names),
            "c_profiler_sees_the_kernel": sum("flash_fwd_bf16_kernel" in n for n in names)
            == n_layers,
        }
        checks.update(c_checks)
        emit({"phase": "infer", "part": "c_export_round_trip", "card": smi,
              "shape": list(INFER_EXPORT_SHAPE), "save_s": save_s, "load_s": load_s,
              "program_bytes": os.path.getsize(os.path.join(d, "program.pt2")),
              "launches": paths["infer_export"],
              "max_abs_diff": float((got.float() - eager.float()).abs().max()),
              "checks": c_checks})
        del got, eager, variables, run

        # (d) the fluid_benchmark CLI, in process
        records = {}
        for name, argv in INFER_CLI_RUNS:
            if name.endswith("profile"):
                argv = argv + ["--profile_dir", os.path.join(work, "profile")]
            zero_kernel_counts()
            t0 = time.perf_counter()
            rec = benchmark.run_benchmark(benchmark.parse_args(argv + ["--json", "--no_random"]))
            torch.cuda.synchronize()
            records[name] = {"record": rec, "seconds": time.perf_counter() - t0}
            paths[f"cli_{name}"] = kernel_launch_counts()
        steps = {n: int(a[a.index("--skip_batch_num") + 1]) + int(a[a.index("--iterations") + 1])
                 for n, a in INFER_CLI_RUNS}
        lm = paths["cli_transformer_lm"]
        with open(os.path.join(work, "profile", "trace.chrome.json")) as f:
            kernels = [e.get("name", "") for e in json.load(f)["traceEvents"]
                       if e.get("cat") == "kernel"]
        traced = {k: sum(f"{k}_bf16_kernel" in n for n in kernels) for k in HOPPER_KERNELS}
        d_checks = {
            "d_records_have_the_jax_keys": all(set(r["record"]) == INFER_RECORD_KEYS
                                               for r in records.values()),
            "d_losses_finite": all(np.isfinite(r["record"]["last_loss"]) for r in records.values()),
            "d_examples_per_sec_positive": all(r["record"]["examples_per_sec"] > 0
                                               for r in records.values()),
            "d_lm_backward_launches_eq_n_layers_per_step": all(
                lm[k] == n_layers * steps["transformer_lm"]
                for k in ("flash_bwd_dkv", "flash_bwd_dq")),
            "d_lm_forward_launches_per_step": lm["flash_fwd"] - n_layers * steps["transformer_lm"]
            in (0, n_layers),  # and the init forward's
            "d_profile_trace_holds_the_three_kernels": all(n >= n_layers for n in traced.values()),
        }
        checks.update(d_checks)
        emit({"phase": "infer", "part": "d_benchmark_cli", "card": smi,
              "runs": {n: {**r, "argv": a, "launches": paths[f"cli_{n}"]}
                       for (n, a), r in zip(INFER_CLI_RUNS, records.values())},
              "profile_trace_kernels": traced, "checks": d_checks})
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return paths, checks


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; nothing was run", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import numpy as np
    import torch.nn.functional as F

    from paddle_tpu_torch.backward import append_backward
    from paddle_tpu_torch.core.config import set_flags
    from paddle_tpu_torch.models import get_model, transformer_lm
    from paddle_tpu_torch.ops.cuda import build as kbuild
    from paddle_tpu_torch.ops.cuda.flash_attention import (
        _flash_bwd_dkv_cuda,
        _flash_bwd_dkv_reference,
        _flash_bwd_dq_cuda,
        _flash_bwd_dq_reference,
        _reference_attention_with_lse,
        flash_attention_bwd_block,
        flash_attention_with_lse,
    )

    # PyTorch's TF32 switches stay at their defaults: the port's f32 products
    # run in full f32 whatever they say (paddle_tpu_torch/core/dtypes.py)
    failures = []

    # 1. device
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    emit({"phase": "device", "name": name, "count": torch.cuda.device_count(),
          "torch": torch.__version__, "cuda": torch.version.cuda})
    print(smi, flush=True)

    # 2. build
    t0 = time.perf_counter()
    report = kbuild.build_all(extra_flags=("-Xptxas", "-v"))
    ptxas = {
        k: [re.sub(r"\s+", " ", ln.strip()) for ln in r["nvcc_output"].splitlines()
            if "registers" in ln or "spill" in ln]
        for k, r in report.items()
    }
    spills = {k: ptxas_spills(r["nvcc_output"]) for k, r in report.items()}
    cuobjdump = cuobjdump_path(kbuild.nvcc_path())
    sass = {k: sass_counts(cuobjdump, str(kern.library_path())) if cuobjdump else None
            for k, kern in kbuild.KERNELS.items()}
    emit({"phase": "build", "seconds": round(time.perf_counter() - t0, 3),
          "per_kernel_seconds": {k: round(r["seconds"], 3) for k, r in report.items()},
          "ptxas": ptxas, "spill_bytes": spills, "cuobjdump": cuobjdump, "sass_counts": sass})
    # bf16 instantiations' totals per kernel
    sass_totals = {k: {op: sum(c[op] for fn, c in counts.items() if "bf16" in fn)
                       for op in ("HGMMA", "UTMALDG")}
                   for k, counts in sass.items() if counts is not None}
    if cuobjdump is None:
        failures.append("build: no cuobjdump to count HGMMA/UTMALDG")
    for k in HOPPER_KERNELS:
        bad = {fn: n for fn, n in spills[k].items() if "bf16" in fn and n}
        if bad:
            failures.append(f"build: {k} spills {bad}")
        if k in sass_totals and not all(sass_totals[k].values()):
            failures.append(f"build: {k} has no wgmma or no TMA load: {sass_totals[k]}")

    # 3. kernel vs plain
    gen = torch.Generator(device="cuda").manual_seed(0)
    case_numbers = {}
    for case, B, H, H_kv, T, d, dt, causal, window, ragged in CASES:
        dtype = getattr(torch, dt)

        def rand(*shape):
            return torch.randn(*shape, generator=gen, device="cuda").to(dtype)

        q, k, v = rand(B, H, T, d), rand(B, H_kv, T, d), rand(B, H_kv, T, d)
        kv_len = draw_kv_len(ragged, B, T, gen)
        scale = 1.0 / d ** 0.5
        with torch.no_grad():
            out, lse = flash_attention_with_lse(q, k, v, causal=causal, kv_len=kv_len, window=window)
            ref, ref_lse = _reference_attention_with_lse(q, k, v, causal, scale, kv_len, window)
        torch.cuda.synchronize()
        err = float((out.float() - ref.float()).abs().max())
        err_lse = float((lse - ref_lse).abs().max())
        finite = bool(torch.isfinite(out).all() and torch.isfinite(lse).all())
        tol, tol_lse = TOL[dt]
        ok = finite and err <= tol and err_lse <= tol_lse
        line = {"phase": "kernel", "kernel": "flash_fwd", "case": case,
                "shape": [B, H, H_kv, T, d], "dtype": dt, "causal": causal,
                "window": window, "kv_len": kv_len.tolist() if ragged else None,
                "max_abs_err": err, "max_abs_err_lse": err_lse,
                "tol": tol, "tol_lse": tol_lse, "ok": ok}
        if case in TIMED_CASES:
            lib_mask = sdpa_mask(kv_len, T)
            with torch.no_grad():
                ms = time_ms(lambda: flash_attention_with_lse(q, k, v, causal=causal, kv_len=kv_len))
                plain = time_ms(lambda: _reference_attention_with_lse(q, k, v, causal, scale, kv_len))
                lib = time_ms(lambda: F.scaled_dot_product_attention(
                    q, k, v, attn_mask=lib_mask, is_causal=causal))
                host = host_us(lambda: flash_attention_with_lse(q, k, v, causal=causal, kv_len=kv_len))
            bms, bound_by = bound_ms(B, H, H_kv, T, d, dt, causal, window, kv_len)
            case_numbers[case] = {"max_abs_err": err, "ms": ms, "plain_ms": plain,
                                  "bound_ms": bms, "bound_by": bound_by, "library_ms": lib}
            line.update(host_us=host, ms=ms, plain_ms=plain, library_ms=lib, bound_ms=bms,
                        bound_by=bound_by, tflops=4 * d * live_pairs(
                            T, T, causal, None, kv_len, B, H) / ms / 1e9)
        emit(line)
        if not ok:
            failures.append(f"kernel case {case}: err {err} (tol {tol}), lse err {err_lse} "
                            f"(tol {tol_lse}), finite {finite}")
        del q, k, v, out, lse, ref, ref_lse

    # 3b. the backward pair vs its plain versions: the forward's cases, then
    # one block backward at global offsets
    bwd_numbers = {}
    bwd_cases = [(c, B, H, H_kv, T, T, d, dt, causal, window, 0, 0, ragged)
                 for c, B, H, H_kv, T, d, dt, causal, window, ragged in CASES]
    bwd_cases.append(BWD_BLOCK_CASE + (False,))
    for case, B, H, H_kv, T, T_kv, d, dt, causal, window, q_off, k_off, ragged in bwd_cases:
        dtype = getattr(torch, dt)

        def rand(*shape):
            return torch.randn(*shape, generator=gen, device="cuda").to(dtype)

        q, k, v = rand(B, H, T, d), rand(B, H_kv, T_kv, d), rand(B, H_kv, T_kv, d)
        g = rand(B, H, T, d)
        kv_len = draw_kv_len(ragged, B, T_kv, gen)
        scale = 1.0 / d ** 0.5
        mask = dict(kv_len=kv_len, window=window, q_off=q_off, k_off=k_off)
        with torch.no_grad():
            out, lse = flash_attention_with_lse(q, k, v, causal=causal, **mask)
            dq, dk, dv = flash_attention_bwd_block(q, k, v, out, lse, g, causal=causal, **mask)
            delta = (g.float() * out.float()).sum(-1, keepdim=True)
            args = (q, k, v, g, lse, delta, causal, scale, kv_len, window, q_off, k_off)
            ref_dk, ref_dv = _flash_bwd_dkv_reference(*args)
            ref_dq = _flash_bwd_dq_reference(*args)
        torch.cuda.synchronize()
        abs_errs = {n: float((a.float() - b.float()).abs().max())
                    for n, a, b in (("dq", dq, ref_dq), ("dk", dk, ref_dk), ("dv", dv, ref_dv))}
        errs = {n: abs_errs[n] / float(b.float().abs().max())
                for n, b in (("dq", ref_dq), ("dk", ref_dk), ("dv", ref_dv))}
        finite = all(bool(torch.isfinite(t).all()) for t in (dq, dk, dv))
        tol = BWD_TOL[dt]
        ok = finite and all(e <= tol for e in errs.values())
        line = {"phase": "kernel", "kernel": "flash_bwd_dkv+flash_bwd_dq", "case": case,
                "shape": [B, H, H_kv, T, T_kv, d], "dtype": dt, "causal": causal,
                "window": window, "q_off": q_off, "k_off": k_off,
                "kv_len": kv_len.tolist() if ragged else None,
                "max_abs_err": abs_errs, "max_rel_err": errs, "tol": tol, "ok": ok}
        if case in TIMED_CASES:
            with torch.no_grad():
                ms = {"flash_bwd_dkv": time_ms(lambda: _flash_bwd_dkv_cuda(*args)),
                      "flash_bwd_dq": time_ms(lambda: _flash_bwd_dq_cuda(*args))}
                plain = {"flash_bwd_dkv": time_ms(lambda: _flash_bwd_dkv_reference(*args), 3),
                         "flash_bwd_dq": time_ms(lambda: _flash_bwd_dq_reference(*args), 3)}
                host = {"flash_bwd_dkv": host_us(lambda: _flash_bwd_dkv_cuda(*args)),
                        "flash_bwd_dq": host_us(lambda: _flash_bwd_dq_cuda(*args))}
            # the library's backward computes dq, dk and dv together: forward
            # plus backward, less the forward, at the same shape
            qr, kr, vr = (t.detach().requires_grad_() for t in (q, k, v))
            lib_mask = sdpa_mask(kv_len, T_kv)

            def lib_fwd():
                return F.scaled_dot_product_attention(qr, kr, vr, attn_mask=lib_mask,
                                                      is_causal=causal)

            fwd_lib = time_ms(lib_fwd)
            both_lib = time_ms(lambda: torch.autograd.grad(lib_fwd(), (qr, kr, vr), g))
            lib = both_lib - fwd_lib
            numbers = bwd_numbers.setdefault(case, {})
            for kname, outs in (("flash_bwd_dkv", ("dk", "dv")), ("flash_bwd_dq", ("dq",))):
                bms, bound_by = bwd_bound_ms(kname, B, H, H_kv, T, T_kv, d, dt, causal, window, kv_len)
                numbers[kname] = {"max_abs_err": max(abs_errs[o] for o in outs),
                                  "max_rel_err": max(errs[o] for o in outs),
                                  "ms": ms[kname], "plain_ms": plain[kname],
                                  "bound_ms": bms, "bound_by": bound_by, "library_ms": lib}
            line.update(ms=ms, plain_ms=plain, host_us=host, library_ms_pair=lib,
                        pair_ms=ms["flash_bwd_dkv"] + ms["flash_bwd_dq"],
                        bound_ms={n: numbers[n]["bound_ms"] for n in ms},
                        bound_by={n: numbers[n]["bound_by"] for n in ms})
            del qr, kr, vr
        emit(line)
        if not ok:
            failures.append(f"backward case {case}: rel errs {errs} (tol {tol}), finite {finite}")
        del q, k, v, g, out, lse, dq, dk, dv, ref_dq, ref_dk, ref_dv, delta, args

    # 4. the serving slice
    set_flags(use_flash_attention=True, use_bf16_compute=True)
    spec = get_model("transformer_lm")  # BASE_CFG, seq_len 1024, on CUDA
    cfg = spec.extra["cfg"]
    rng = np.random.RandomState(0)
    variables = spec.model.init(0, *spec.synth_batch(1, rng))
    prompts = torch.as_tensor(
        rng.randint(1, cfg["vocab"], size=(PROMPTS, PROMPT_LEN)).astype(np.int32), device="cuda")
    for kern in kbuild.KERNELS.values():
        kern.launches = 0
    tokens = transformer_lm.generate(variables, prompts, NEW_TOKENS, cfg)
    torch.cuda.synchronize()
    launches = {n: kern.launches for n, kern in kbuild.KERNELS.items()}

    with torch.no_grad():
        dec = transformer_lm.CachedDecoder(variables.params, cfg, PROMPTS, PROMPT_LEN + NEW_TOKENS)
        logits_flash = dec.prefill(prompts)
        set_flags(use_flash_attention=False)
        logits_plain = transformer_lm.CachedDecoder(
            variables.params, cfg, PROMPTS, PROMPT_LEN + 1).prefill(prompts)
        tokens_plain = transformer_lm.generate(variables, prompts, NEW_TOKENS, cfg)
        set_flags(use_flash_attention=True)
        logits_err = float((logits_flash - logits_plain).abs().max())

        def prefill():
            return dec.prefill(prompts)

        prefill()
        torch.cuda.synchronize()
        prefill_s = []
        for _ in range(3):
            t0 = time.perf_counter()
            logits = prefill()
            torch.cuda.synchronize()
            prefill_s.append(time.perf_counter() - t0)
        tok = torch.argmax(logits, -1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for s in range(NEW_TOKENS - 1):
            tok = torch.argmax(dec.step(tok, PROMPT_LEN + s), -1)
        torch.cuda.synchronize()
        decode_s = time.perf_counter() - t0

    n_layers = cfg["n_layers"]
    checks = {
        "flash_launches_eq_n_layers": launches["flash_fwd"] == n_layers,
        "tokens_shape": tuple(tokens.shape) == (PROMPTS, NEW_TOKENS),
        "tokens_int32": tokens.dtype == torch.int32,
        "tokens_in_range": bool(((tokens >= 0) & (tokens < cfg["vocab"])).all()),
        "logits_finite": bool(torch.isfinite(logits_flash).all()),
        "first_token_is_argmax_of_prefill_logits": bool(
            (tokens[:, 0] == torch.argmax(logits_flash, -1)).all()),
        "first_logits_flash_vs_plain_within_tol": logits_err <= LOGITS_TOL,
    }
    emit({"phase": "slice", "model": "transformer_lm", "cfg": {
              k: cfg[k] for k in ("vocab", "d_model", "d_inner", "num_heads", "n_layers")},
          "params": sum(p.numel() for p in variables.params.values()),
          "prompts": PROMPTS, "prompt_len": PROMPT_LEN, "new_tokens": NEW_TOKENS,
          "launches": launches, "first_logits_max_abs_err": logits_err,
          "first_logits_tol": LOGITS_TOL,
          "token_agreement_flash_vs_plain": float((tokens == tokens_plain).float().mean()),
          "prefill_ms": 1e3 * min(prefill_s), "prefill_ms_runs": [1e3 * s for s in prefill_s],
          "decode_tokens_per_s": PROMPTS * (NEW_TOKENS - 1) / decode_s,
          "checks": checks})
    failures += [f"slice check {k}" for k, good in checks.items() if not good]
    del dec, logits_flash, logits_plain, variables

    # 5. the training slice
    set_flags(use_flash_attention=True, use_bf16_compute=True, check_nan_inf=True)
    spec = get_model("transformer_lm")  # BASE_CFG, seq_len 1024, on CUDA
    ids, labels = spec.synth_batch(TRAIN_BATCH, np.random.RandomState(0))
    variables = spec.model.init(0, ids, labels)
    opt = spec.optimizer()
    opt_state = opt.create_state(variables.params)
    step = opt.minimize(spec.model)
    for kern in kbuild.KERNELS.values():
        kern.launches = 0
    out = step(variables, opt_state, ids, labels)
    torch.cuda.synchronize()
    train_launches = {n: kern.launches for n, kern in kbuild.KERNELS.items()}
    losses = [float(out.loss)]
    finite = bool(out.finite)
    new_vars, new_state = out.variables, out.opt_state
    for _ in range(TRAIN_STEPS - 1):
        o = step(new_vars, new_state, ids, labels)
        new_vars, new_state = o.variables, o.opt_state
        losses.append(float(o.loss))
    del out, o, new_vars, new_state

    set_flags(check_nan_inf=False)  # timed as bench.py steps, without the finite checks
    torch.cuda.reset_peak_memory_stats()
    step_s = []
    for _ in range(3):
        t0 = time.perf_counter()
        o = step(variables, opt_state, ids, labels)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
    peak_bytes = torch.cuda.max_memory_allocated()
    del o

    def loss_and_grads(**fl):
        set_flags(**fl)
        loss, (grads, _, _) = append_backward(spec.model, ids, labels)(variables.params)
        return float(loss), grads

    loss_flash, g_flash = loss_and_grads(use_flash_attention=True, flash_fused_bwd=True)
    ref = {"recomputed_bwd": loss_and_grads(use_flash_attention=True, flash_fused_bwd=False)}
    ref["composed"] = loss_and_grads(use_flash_attention=False)
    set_flags(use_flash_attention=True, flash_fused_bwd=True)
    agreement = {}
    for rname, (loss_r, g_r) in ref.items():
        norms = {n: float(g.float().norm()) for n, g in g_r.items()}
        floor = TRAIN_GRAD_FLOOR * max(norms.values())
        rel = {n: float((g_flash[n].float() - g.float()).norm()) / max(norms[n], floor)
               for n, g in g_r.items()}
        worst = max(rel, key=rel.get)
        agreement[rname] = {"loss_abs_err": abs(loss_flash - loss_r), "grad_rel_l2_max": rel[worst],
                            "grad_rel_l2_worst_param": worst,
                            "grad_rel_l2_median": float(np.median(list(rel.values())))}
    del ref, g_flash

    n_layers = spec.extra["cfg"]["n_layers"]
    tokens_per_step = TRAIN_BATCH * spec.extra["seq_len"]
    train_checks = {
        "flash_fwd_launches_eq_n_layers": train_launches["flash_fwd"] == n_layers,
        "flash_bwd_dkv_launches_eq_n_layers": train_launches["flash_bwd_dkv"] == n_layers,
        "flash_bwd_dq_launches_eq_n_layers": train_launches["flash_bwd_dq"] == n_layers,
        "loss_finite": bool(np.isfinite(losses).all()),
        "check_nan_inf_finite": finite,
        "loss_falls_over_steps": losses[-1] < losses[0],
    }
    for rname, a in agreement.items():
        train_checks[f"loss_vs_{rname}_within_tol"] = a["loss_abs_err"] <= TRAIN_LOSS_TOL
        train_checks[f"grads_vs_{rname}_within_tol"] = a["grad_rel_l2_max"] <= TRAIN_GRAD_TOL
    emit({"phase": "train", "model": "transformer_lm", "optimizer": type(opt).__name__,
          "params": sum(p.numel() for p in variables.params.values()),
          "batch": TRAIN_BATCH, "seq_len": spec.extra["seq_len"], "launches": train_launches,
          "losses": losses, "step_ms": 1e3 * min(step_s), "step_ms_runs": [1e3 * s for s in step_s],
          "tokens_per_s": tokens_per_step / min(step_s), "peak_memory_bytes": peak_bytes,
          "agreement": agreement, "loss_tol": TRAIN_LOSS_TOL, "grad_tol": TRAIN_GRAD_TOL,
          "grad_floor": TRAIN_GRAD_FLOOR, "card": smi, "checks": train_checks})
    failures += [f"train check {k}" for k, good in train_checks.items() if not good]

    # 6. the trainer slice
    trainer_launches, trainer_checks = trainer_phase(smi)
    failures += [f"trainer check {k}" for k, good in trainer_checks.items() if not good]

    # 7. the conv zoo
    conv_checks = conv_phase(smi)
    failures += [f"conv check {k}" for k, good in conv_checks.items() if not good]

    # 8. the NMT Transformer
    nmt_paths, nmt_checks = nmt_phase(smi)
    failures += [f"nmt check {k}" for k, good in nmt_checks.items() if not good]

    # 9. the LSTM models and the beam search
    rnn_checks = rnn_phase(smi)
    failures += [f"rnn check {k}" for k, good in rnn_checks.items() if not good]

    # 10. decode serving and generate_beam
    serve_paths, serve_checks = serve_phase(smi)
    failures += [f"serve check {k}" for k, good in serve_checks.items() if not good]

    # 11. data parallelism
    dp_paths, dp_checks = dp_phase(smi)
    failures += [f"dp check {k}" for k, good in dp_checks.items() if not good]

    # 12. the telemetry stack over the Trainer and the DecodeEngine
    telemetry_launches, telemetry_checks = telemetry_phase(smi)
    failures += [f"telemetry check {k}" for k, good in telemetry_checks.items() if not good]

    # 13. the inference-deployment slice
    infer_paths, infer_checks = infer_phase(smi)
    failures += [f"infer check {k}" for k, good in infer_checks.items() if not good]

    # 14. kernels
    paths = {"generate": launches, "train_step": train_launches, "trainer": trainer_launches,
             **nmt_paths, **serve_paths, **dp_paths, "telemetry": telemetry_launches,
             **infer_paths}
    slice_numbers = case_numbers["slice"]
    numbers = {"flash_fwd": slice_numbers, **bwd_numbers["slice"]}
    extra = {n: {"design": DESIGNS[n],
                 "ratio_to_library": (numbers[n]["ms"] / numbers[n]["library_ms"]
                                      if numbers.get(n) else None),
                 "sass": sass_totals.get(n)}
             for n in DESIGNS}
    emit({"earlier_ms": EARLIER_MS,
          "earlier_ms_source": "copied from PERF.md section 6 (the mma.sync designs), not measured here"})
    emit({"kernels": [
        {"name": "flash_fwd", "route": "cuda", "source": "paddle_tpu_torch/csrc/flash_fwd.cu",
         "replaces": "paddle_tpu/ops/pallas/flash_attention.py:67 _flash_fwd_kernel, "
                     ":139 _flash_fwd_kernel_resident",
         "launches": train_launches["flash_fwd"],
         "launches_by_path": {p: n["flash_fwd"] for p, n in paths.items()}, **slice_numbers,
         **extra["flash_fwd"],
         "cases": {c: case_numbers[c] for c in TIMED_CASES if c != "slice"}},
        {"name": "flash_bwd_dkv", "route": "cuda", "source": "paddle_tpu_torch/csrc/flash_bwd_dkv.cu",
         "replaces": "paddle_tpu/ops/pallas/flash_attention.py:362 _flash_bwd_dkv_kernel",
         "launches": train_launches["flash_bwd_dkv"],
         "launches_by_path": {p: n["flash_bwd_dkv"] for p, n in paths.items()},
         **bwd_numbers["slice"]["flash_bwd_dkv"], **extra["flash_bwd_dkv"],
         "library_of": "F.scaled_dot_product_attention backward (dq, dk and dv together)",
         "cases": {c: bwd_numbers[c]["flash_bwd_dkv"] for c in TIMED_CASES if c != "slice"}},
        {"name": "flash_bwd_dq", "route": "cuda", "source": "paddle_tpu_torch/csrc/flash_bwd_dq.cu",
         "replaces": "paddle_tpu/ops/pallas/flash_attention.py:434 _flash_bwd_dq_kernel",
         "launches": train_launches["flash_bwd_dq"],
         "launches_by_path": {p: n["flash_bwd_dq"] for p, n in paths.items()},
         **bwd_numbers["slice"]["flash_bwd_dq"], **extra["flash_bwd_dq"],
         "library_of": "F.scaled_dot_product_attention backward (dq, dk and dv together)",
         "cases": {c: bwd_numbers[c]["flash_bwd_dq"] for c in TIMED_CASES if c != "slice"}},
    ]})
    print(smi, flush=True)

    if failures:
        for f in failures:
            print(f"chip_smoke: FAILED {f}", file=sys.stderr)
        return 1
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
