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
               steps) rounded to bf16, as amp's forward sees them.
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
               torch.profiler, the run between profile_markers and its
               session intact; (d) the fluid_benchmark CLI in process
               (run_benchmark(parse_args(...))): resnet, transformer,
               transformer_lm, mnist, resnet --infer_only and a profiled
               transformer_lm pass: the JAX record's keys, finite losses,
               examples/s, 6 launches of each kernel per LM step, the
               profile's trace holding the three kernels. Every
               ServingEngine of the phase lints its model first (the
               default lint_model=True): the log holds no "model lint
               skipped", and the folded ResNet-50's findings are printed.
 13b. analysis — the analysis slice (ANALYSIS_*): (a) the LM at BASE_CFG on
               the card linted on the meta device (analysis.lint_model over
               its variables, eval and training mode): no error finding,
               torch.cuda.memory_allocated() the same before and after, no
               launch counted and no device record in a torch.profiler
               session opened by profile_markers and closed by a fill, the
               lint's seconds; (b) a ServingEngine with the default
               lint_model=True (the infer phase's policy) serving 8 requests
               one at a time: no "model lint skipped" in the log, logits
               bit-equal to a lint_model=False engine's, 6 flash-forward
               launches a request, and the two engines' warm-ups launching
               alike; (c) python -m paddle_tpu_torch.analysis over the
               package, in process: exit 0, its seconds.
 14. sp      — sequence and expert parallelism (SP_*), two gloo ranks
               sharing the card, the LM at BASE_CFG (flash + bf16, Adam):
               (a) ring attention on seq=2, 8 x 1024 split P("data",
               "seq"): one step against the one-rank minimize step (loss,
               Adam's first moment, the update, as phase dp (b) holds its
               steps), two more timed;
               each rank's launches of each kernel (6 and 12: the causal
               ring skips rank 0's dead block); step ms and peak memory per
               rank; (b) the ring at 2 x 8192 (numbers: step ms, tokens/s,
               peak memory per rank beside the one-rank step); (c) Ulysses
               on seq=2, as (a), 6 launches a rank; (d) the MoE LM (8
               experts, top1) on expert=2: as (a), plus the routers' aux
               losses and kept tokens equal to the one-rank run's; (e) the
               ring's block math at (a)'s attention shape in one process
               against the single-device kernels and float64 (SP_RING_*).
               The route of each exchange (gloo_host: staged through host
               memory, point to point). tools/torch_sp_nccl.py runs (a)-(d)
               over NCCL, one rank per card.
 15. mp      — tensor and pipeline parallelism (MP_*), two gloo ranks
               sharing the card, flash, Adam: (a) the LM at BASE_CFG, 8 x
               1024, on model=2 (4 heads and half of every projection a
               rank); (b) the LM on pipe=2, 4 microbatches (GPipe, 3 layers
               a stage); (c) (b) with remat; (d) the NMT Transformer at full
               width, 2+2 layers, 32 x 256, dropout 0, on model=2. One step
               of each against the one-rank minimize step (loss, Adam's
               first moment, the update, with phase sp's limits; (a) and
               (d) hold that step in f32 and report their bf16 step's
               agreement as numbers), two more timed in bf16; each rank's
               launches of each kernel (6, 12, 24 forward with remat; 6),
               step ms, peak memory, the pipeline's exchange route.
               (e)-(h) the axes composed (four gloo ranks), (i) the MoE LM
               on model=2 x expert=2 with its rows over ("data",
               "expert"), (j) the LM on data=2 with every matrix stored
               over data and ZeRO-1 (see MP_PARTS).
               tools/torch_sp_nccl.py runs them over NCCL, one rank per
               card; tools/torch_mp_parts.py runs some parts alone.
 15b. elastic — elastic training (ELASTIC_*): the LM at BASE_CFG (flash +
               bf16, Adam) through Trainer(parallel=True,
               CheckpointConfig(sharded=True, step_interval=2),
               ResilienceConfig(elastic=True)), three gloo ranks sharing the
               card, an epoch of 6 batches of 6 x 1024 tokens, and a fourth
               process that joins back (launch.spawn's may_leave and join).
               (a) at step 3 DEVICE_LOST fires on every rank naming rank 2:
               it leaves, the survivors re-form at 2, restore step 2 from
               disk and replay the epoch; their losses against a cold restart
               of 2 ranks from that checkpoint (bit-equal expected, else
               TRAIN_LOSS_TOL); one elastic_shrink run-log event with a trace
               id. (c) the process started as rank 2 of generation 2 joins at
               the next checkpoint boundary: the world is 3 again, one
               elastic_regrow event, the next step against a 3-rank Trainer
               from the regrow's checkpoint, the joiner's steps equal to the
               survivors'. (b) on those three, rank 0 (the manifest's
               writer) ends its process during step 3: the survivors learn
               it from gloo's error, agree through the launcher's health
               endpoint and re-form; checked as (a). Every step on every
               rank launches each kernel 6 times; printed: detection ms,
               rendezvous ms, restore s and bytes, recovery s, step ms
               before and after each change of world, the phase's seconds.
 16. catalog — the Fluid catalog (CATALOG_*, BOOK_*, SRL_*): (a) every
               function of ops.math, the catalog's ops.nn functions,
               ops.losses, ops.control_flow, ops.nn3d and ops.vision at
               small shapes, on the card against the port on the CPU on the
               same inputs (forward, gradients of the differentiable ones,
               integer outputs equal, the random ops by shape and dtype),
               each op's card ms and kernel launches a call; (b) the book's
               chapters (fit_a_line, word2vec, recommender_system,
               label_semantic_roles, understand_sentiment,
               recognize_digits, image_classification) on synthetic rows of
               tests/test_book.py's shapes, 4 Adam steps on one batch from
               the same weights, card against CPU, the loss falls; (c) the
               SRL tagger at the reference book's widths (SRL_CFG): the loss
               falls over 8 steps, step ms, words/s, launches a step and the
               CRF's forward and backward apart, peak memory, Viterbi tags
               card against CPU equal or a near tie; (d)
               nets.scaled_dot_product_attention at [8, 1024, 512], 8
               heads, bf16, flash on: one launch of each flash kernel for a
               forward and backward, output and gradients against the
               composed route within TRAIN_GRAD_TOL. (a) also sweeps
               ops.detection, ops.detection_rpn, ops.quant and
               layers.multi_box_head, and the kinks and edge semantics of
               ops.math/ops.nn at exact zeros, ties, NaNs and indices out of
               range. (e) SSD300's head at its published widths (SSD300):
               4 Adam steps of multi_box_head -> ssd_loss at 8732 priors, 21
               classes, batch 8, card against CPU, the loss falls; step ms,
               launches a step and ssd_loss's forward and backward apart,
               then detection_output (400/200) and detection_map, ms and
               launches an image, peak memory; detection_output's own
               outputs card against CPU equal, or first differing at a
               counted near tie, and detection_map on the card's
               detections card against CPU. (f) Faster
               R-CNN's RPN (RPN_CFG) on a 50 x 84 x 512 map, 50,400
               anchors: rpn_target_assign and the loss, 4 Adam steps, card
               against CPU; generate_proposals (6000 -> 1000) and
               generate_proposal_labels, their ms, launches and peak memory,
               the proposals under the same near-tie rule, the labels of
               the card's proposals card against CPU.
 17. kernels — one line: each kernel with its launches on every path
               (phases 4-6, 8, 10-16, 13b; elastic: one rank's launches over (a)
               and (c), Model.init's forward included), its error and times at the
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
# batch and the same weights rounded to bf16 (amp's forward runs on every
# parameter cast to bf16): the loss, absolute. Measured bit-equal along 8
# steps from two batches; against the unrounded weights the two differ by
# 0.0003-0.040, the rounding of BN's scale and bias and the fc bias alone
# (tools/torch_amp_rounding.py).
AMP_LOSS_TOL = 1e-5
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
# Fleet serving (phase fleet): the LM at BASE_CFG behind the fleet entry
# points, f32 pages, SERVE_CONFIG per engine, phase serve's traffic. (a) the
# first FLEET_REQUESTS of serve's mixed requests through a DisaggRouter (one
# prefill and one decode worker) on the "device" transport, then on the
# "serialized" one, held against one DecodeEngine's burst of the same
# requests (held_against's near-tie rule). Device-to-host copies are counted
# under torch.profiler: on the device transport exactly the sampled-token
# readbacks (one per decode step, one per finished prefill), on the
# serialized one a copy more per handoff. The handoff's page copy alone
# (gather + implant of the median request's pages) is timed over
# FLEET_COPY_ITERS. (b) serve's shared-prefix requests on engine A over a
# HostPagePool of FLEET_HOST_TIER_BYTES, then on engine B (its radix tree
# cold, the same pool): B promotes the prefix's pages, the first request
# alone before the other 15. (c) a DecodeFleet of two engines, A journaled:
# A is killed once FLEET_KILL_TOKENS tokens are out and B resumes A's
# journal; then FLEET_MIGRATE_REQUESTS requests pinned to an engine whose
# steps fail after its first two (unhealthy_after 2) migrate to its peer.
# (d) a journaled burst killed once half its tokens are out, replayed and
# resumed on a fresh engine; the burst's tokens/s with the journal off and
# on; FLEET_FSYNCS appends each fsync'd, timed. (e) FleetView over (a)'s
# device router, and the exporter's /fleet and /trace/<id> of each request.
FLEET_REQUESTS, FLEET_COPY_ITERS, FLEET_HOST_TIER_BYTES = 24, 50, 256 << 20
FLEET_KILL_TOKENS, FLEET_MIGRATE_REQUESTS, FLEET_FSYNCS = 256, 8, 64
# Replica groups (phase group): the LM at BASE_CFG, f32 weights and pages,
# greedy, SERVE_CONFIG per engine, the first GROUP_REQUESTS of serve's
# requests. (a) a tp=2 group, both members on cuda:0, against a tp=1
# engine's burst (held_against's near-tie rule): one step shape, no flash
# launch; each member's page bytes and layout-sharded weight bytes half of
# tp=1's; the replicated hidden states bit-equal across members at one step;
# tokens/s, a decode step's ms and launches and peak memory at tp=1 and
# tp=2. (b) GROUP_VARIANTS (two kv heads with rope: the pages split; one kv
# head: the pages whole, k/v gathered), each tp=2 against tp=1. (c) the
# target as its own draft, GROUP_SPEC_TOKENS tokens, GROUP_SPEC_REQUESTS
# requests. (d) DecodeFleet.from_groups over two tp=2 groups (four members
# on the card): a GROUP_MEMBER error on member 1 of group 0 once
# GROUP_FAULT_TOKENS tokens are out ejects the whole group, its requests
# migrate, the half-open probe re-admits it; then a GROUP_STALL_S stall on
# member 1's canary is flagged at shard 1. (e) DisaggRouter on the device
# transport over GROUP_HANDOFF_REQUESTS requests, a tp=2 prefill group to a
# tp=2 decode group (adopted) and to a tp=1 engine (re-prefilled). (f) (a)
# with the members on cuda:0 and cuda:1, where the machine has two cards.
GROUP_REQUESTS, GROUP_SPEC_REQUESTS, GROUP_SPEC_TOKENS, GROUP_HANDOFF_REQUESTS = 24, 8, 4, 8
GROUP_FAULT_TOKENS, GROUP_STALL_S = 256, 0.02
GROUP_VARIANTS = {"gqa2_rope": dict(num_kv_heads=2, pos_encoding="rope"),
                  "gqa1": dict(num_kv_heads=1)}
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
# Elastic training (phase elastic): the LM at BASE_CFG (flash + bf16, Adam)
# through Trainer(parallel=True, CheckpointConfig(sharded=True,
# step_interval=ELASTIC_CKPT_STEPS), ResilienceConfig(elastic=True)) on
# ELASTIC_RANKS gloo ranks sharing the card: an epoch of ELASTIC_BATCHES
# global batches of ELASTIC_ROWS x 1024 tokens (the rows divide 3 and 2
# ranks); a rank is lost at step ELASTIC_LOST_STEP of the epoch, so the
# survivors restore step ELASTIC_CKPT_STEPS. The group's collective timeout
# is ELASTIC_TIMEOUT_S (the rendezvous deadline when nothing attributes a
# loss). Losses of the same world from the same checkpoint on the same
# batches are expected bit-equal (ELASTIC_LOSS_TOL: 0); where they are not,
# the check falls back to phase dp (b)'s TRAIN_LOSS_TOL and says so.
ELASTIC_RANKS, ELASTIC_ROWS, ELASTIC_BATCHES = 3, 6, 6
ELASTIC_CKPT_STEPS, ELASTIC_LOST_STEP, ELASTIC_TIMEOUT_S = 2, 3, 300.0
ELASTIC_LOSS_TOL = 0.0
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
# spin kernels launched before and after the work of a profiled run whose
# device records are counted. torch.profiler drops a session's first device
# records, more of them the longer the process has run
# (tools/torch_profiler_records.py on an H100: 0 to 18 markers of ~0.5 ms
# over 242 s; one session lost all of 64 one-cycle markers and 5 of the
# work's records; by phase telemetry 11 markers of ~0.5 ms, 10 of ~1 ms), so
# two runs of the same work counted apart. Each marker spins
# PROFILER_MARKER_CYCLES clock cycles (~1 ms at the H100's 1.98 GHz): the 64
# cover a session's first and last ~64 ms and are left out of the count; a
# session that kept no marker on either side is not intact
# (profile_intact), its loss may have reached the work
PROFILER_MARKERS, PROFILER_MARKER_CYCLES = 64, 2_000_000
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
# Phase analysis. (a) the model lint of the LM at BASE_CFG over a batch of
# ANALYSIS_LINT_BATCH rows; (b) ANALYSIS_REQUESTS prompts of
# ANALYSIS_PROMPT_LENS tokens (numpy seed 1) served one at a time by an
# engine with the lint and one without, under phase infer's policy (one
# request a batch, so both run the same shapes and must agree bit for bit).
ANALYSIS_LINT_BATCH, ANALYSIS_REQUESTS, ANALYSIS_PROMPT_LENS = 8, 8, (64, 512)
# Sequence and expert parallelism (phase sp): two gloo ranks on the one card
# (as phase dp (b)), the LM at BASE_CFG, flash + bf16, Adam: one step held
# against the one-rank minimize step on the whole batch as phase dp (b)
# holds its steps (TRAIN_LOSS_TOL on the loss, TRAIN_GRAD_TOL on Adam's
# first moment, DP_MOVEMENT_TOL on the update), then two more timed. One
# step: after it the MoE routers may route a token near a tie otherwise,
# and one such token moves its expert's gradient by more than the
# tolerances. (a) the ring on seq=2 with
# P("data", "seq"): 8 x 1024, 512 tokens of each row a rank; under causal
# masking rank r of the ring launches r + 1 forward kernels a layer (its
# dead blocks are skipped), so 6 and 12 of each kernel a step; (b) the ring
# at long context: SP_LONG_BATCH x SP_LONG_SEQ (4096 tokens of each row a
# rank), 3 layers (3 and 6 of each kernel a step), numbers only, beside the
# one-rank step on the same batch; (c)
# Ulysses on seq=2: 4 heads a rank after the exchange, 6 launches of each
# kernel a rank; (d) the MoE LM (SP_MOE: 8 experts, top1, capacity 1.25) on
# expert=2, 4 experts a rank: the losses, the routers' aux losses and the
# tokens each layer's router keeps (so the dropped ones) equal to the
# one-rank run's in the first step, and the update held as above.
SP_LONG_BATCH, SP_LONG_SEQ = 2, 8192
SP_MOE = dict(moe_experts=8, moe_router="top1", moe_capacity_factor=1.25, relu_dropout=0.0)
# each part: (seq_len, batch, the mesh axis the ranks lie on (data is 1),
# sequence-parallel mode, LM overrides, steps held against the one-rank run,
# steps timed after them)
SP_PARTS = {
    "a_ring": (1024, TRAIN_BATCH, "seq", "ring", {}, 1, 2),
    "b_ring_long": (SP_LONG_SEQ, SP_LONG_BATCH, "seq", "ring", {"n_layers": 3}, 0, 2),
    "c_ulysses": (1024, TRAIN_BATCH, "seq", "ulysses", {}, 1, 2),
    "d_moe": (1024, TRAIN_BATCH, "expert", None, SP_MOE, 1, 2),
}


def lm_layers(overrides: dict) -> int:
    """The LM's layers under a part's overrides (BASE_CFG's 6 by default)."""
    return overrides.get("n_layers", 6)


def sp_launches(part: str, rank: int) -> int:
    """A part's launches of each kernel a step on ``rank``: one a layer,
    (rank + 1) a layer on the causal ring (its live blocks)."""
    n = lm_layers(SP_PARTS[part][4])
    return n * (rank + 1) if SP_PARTS[part][3] == "ring" else n
# (e) the ring's block math at the LM's attention shape (8 x 8 x 1024 x 64,
# causal, two blocks of 512): both ranks emulated in one process through
# flash_attention_with_lse and flash_attention_bwd_block at their offsets,
# against the single-device kernels and a float64 reference. (a) reads a
# one-step gradient 1.7% (median) from the one-rank run's where Ulysses,
# which runs the single-device kernel on whole heads, reads 1e-7: the ring
# rounds each block's probabilities and partial output to bf16 and sums in
# another order. (e) shows that is rounding, not an error: in f32 out, dq,
# dk and dv within SP_RING_F32_TOL (rel L2) of float64 (f32 rounding over a
# 1024-key row), and in bf16 no farther from float64 than SP_RING_BF16_RATIO
# times the single-device kernels are.
SP_RING_SHAPE = (TRAIN_BATCH, 8, 1024, 64)
SP_RING_F32_TOL, SP_RING_BF16_RATIO = 1e-5, 1.5

# Tensor and pipeline parallelism (phase mp): two gloo ranks on the one card
# (as phases dp (b) and sp), bf16 + flash, Adam; one step of each part held
# against the one-rank minimize step on the whole batch with phase sp's
# limits (TRAIN_LOSS_TOL on the loss, TRAIN_GRAD_TOL on Adam's first moment,
# DP_MOVEMENT_TOL on the update), then two more timed. (a) the LM at
# BASE_CFG, 8 x 1024, on model=2: every rank holds 4 of the 8 heads, half of
# each projection's columns or rows and of the embedding's columns, and
# launches each kernel once a layer (6 a step); (b) the LM on pipe=2 with 4
# microbatches: each stage runs its 3 layers on every microbatch, 12 of each
# kernel a step (bubble steps skipped); (c) (b) with remat: the backward
# runs each step's forward again, 24 forward launches; (d) the NMT
# Transformer at full width (d_model 512, 8 heads, ffn 2048), depth 2+2,
# bench.py's 32 x 256 cell, dropout 0, on model=2: one forward launch for
# each encoder self-attention and each decoder self- and cross-attention, 6
# of each kernel a step. With more ranks (tools/torch_sp_nccl.py), model=n,
# and the pipeline on pipe=2 x data=n/2.
# The model-axis parts (a), (d) run two steps, each held against its own
# one-rank step: in f32 (the flash kernels' f32 instantiation) at phase sp's
# limits, and in bf16 against the one-rank f32 step, no further from it
# than MP_BF16_SPREAD times the one-rank bf16 step is (its first moment and
# update, worst parameter). A row-parallel layer sums two f32 partial
# products, which rounds the activations at other points than one rank
# does, and the bf16 casts carry that into the gradients: the bf16 step on
# model=2 is as far from the one-rank bf16 step as bf16 rounding puts
# either from f32 (PERF.md section 6). The pipeline runs each row's
# arithmetic unchanged and holds bf16 at phase sp's limits.
# (e)-(h): the axes composed as the JAX package's GSPMD composes them, the
# LM at BASE_CFG's widths, 8 x 1024, on four gloo ranks sharing the card
# ((h): the phase's two); (e)-(g) at 4 layers, to make room in the
# script's time. (e) pipe=2 x model=2, 4 microbatches: outside the stages
# the embedding and the logits split over model; inside, each rank runs its
# stage's 2 layers on its one row of each 2-row microbatch with the stage's
# weights gathered whole: 8 launches of each kernel a step. (f) the ring on
# seq=2 x model=2 with P("data", "seq"): 4 heads and 512 tokens of each row
# a rank, the ring within the rank's seq group: 4 or 8 of each kernel by
# its ring position. (g) Ulysses on the same mesh: 2 heads a rank after the
# exchange, 4 of each kernel. (e), (f) and (g) are held by (a)'s rule: their
# model axis sums partial products of each row (the row-parallel
# projections of (f) and (g); in (e) the logits' input gradient over the
# vocabulary's blocks and each stage weight's gradient over the two ranks'
# rows). (h) the MoE LM of phase sp on expert=2 with ZeRO-1 (each rank its
# 4 experts and their slots; the replicated parameters' slots split over
# data): after its held step its parameters equal the same step's without
# ZeRO-1 bit for bit, and the one-rank step at phase sp's limits; 6 of each
# kernel a rank.
# (i) the MoE LM of phase sp on model=2 x expert=2 (four ranks), the batch's
# rows split over ("data", "expert"): attention on each rank's 4 heads, its
# 4 experts (replicated over model), the experts' buffers exchanged by
# all-to-all over expert; held by (a)'s rule, each layer's kept tokens (over
# the whole batch) and aux loss those of the one-rank f32 step; 6 of each
# kernel a rank. (j) the LM on data=2 with every matrix stored over data
# (dim 0, FSDP-like: gathered whole for the step, each rank updates its
# rows) and ZeRO-1: each rank holds its windows at rest, half of every
# matrix's bytes and half of Adam's slot bytes; bit-equal to its step
# without ZeRO-1 and at phase sp's limits from the one-rank step; 6 of each
# kernel a rank.
MP_NMT = dict(n_layers=2, attn_dropout=0.0, relu_dropout=0.0, residual_dropout=0.0)
MP_F32_HELD = ("a_model2", "d_nmt_model2", "e_pipe2_model2", "f_ring_seq2_model2",
               "g_ulysses_seq2_model2", "i_moe_model2_expert2")
MP_BF16_SPREAD = 2.0
# each part: (model, seq_len, batch, the axis the ranks split (or the
# composed mesh's axes beside data=1 on MP_COMPOSED_RANKS ranks), LM or NMT
# overrides, each kernel's launches a step on a rank (forward, dK/dV, dQ);
# None: by the rank's ring position)
MP_PARTS = {
    "a_model2": ("transformer_lm", 1024, TRAIN_BATCH, "model", {}, (6, 6, 6)),
    "b_pipe2": ("transformer_lm", 1024, TRAIN_BATCH, "pipe", {"pipe_n_micro": 4}, (12, 12, 12)),
    "c_pipe2_remat": ("transformer_lm", 1024, TRAIN_BATCH, "pipe",
                      {"pipe_n_micro": 4, "remat": True}, (24, 12, 12)),
    "d_nmt_model2": ("transformer", NMT_SEQ, NMT_BATCH, "model", MP_NMT, (6, 6, 6)),
    "e_pipe2_model2": ("transformer_lm", 1024, TRAIN_BATCH, {"pipe": 2, "model": 2},
                       {"pipe_n_micro": 4, "n_layers": 4}, (8, 8, 8)),
    "f_ring_seq2_model2": ("transformer_lm", 1024, TRAIN_BATCH, {"seq": 2, "model": 2},
                           {"n_layers": 4}, None),
    "g_ulysses_seq2_model2": ("transformer_lm", 1024, TRAIN_BATCH, {"seq": 2, "model": 2},
                              {"n_layers": 4}, (4, 4, 4)),
    "h_moe_expert2_zero1": ("transformer_lm", 1024, TRAIN_BATCH, "expert", SP_MOE, (6, 6, 6)),
    "i_moe_model2_expert2": ("transformer_lm", 1024, TRAIN_BATCH, {"model": 2, "expert": 2},
                             SP_MOE, (6, 6, 6)),
    "j_lm_data2_stored": ("transformer_lm", 1024, TRAIN_BATCH, "data", {}, (6, 6, 6)),
}
MP_COMPOSED_RANKS = 4
# the sequence-parallel mode of a part over its mesh's seq axis, and the
# parts run with ZeRO-1
MP_SEQ_MODE = {"f_ring_seq2_model2": "ring", "g_ulysses_seq2_model2": "ulysses"}
MP_ZERO = ("h_moe_expert2_zero1", "j_lm_data2_stored")
# the parts whose batch rows split over several axes (their batch specs'
# dim 0), and those whose matrices are stored over data
MP_ROWS = {"i_moe_model2_expert2": ("data", "expert")}
MP_STORED = ("j_lm_data2_stored",)
MP_HELD, MP_TIMED = 1, 2


def mp_composed(part: str) -> bool:
    """Whether a phase mp part runs on a composed mesh of its own
    (MP_COMPOSED_RANKS ranks) rather than on the phase's ranks."""
    return isinstance(MP_PARTS[part][3], dict)


def mp_launches(part: str, rank: int):
    """A phase mp part's launches of each kernel a step on ``rank``
    (forward, dK/dV, dQ): the ring's by its seq coordinate (rank // model
    on data=1 x seq x model), as phase sp's."""
    want = MP_PARTS[part][5]
    if want is None:
        n = lm_layers(MP_PARTS[part][4]) * (rank // MP_PARTS[part][3]["model"] + 1)
        want = (n, n, n)
    return dict(zip(HOPPER_KERNELS, want))


# The Fluid catalog (phase catalog). (a) every op of the sweep, card against
# the port on the CPU on the same inputs: forward within CATALOG_FWD_TOL
# relative L2 (the recursions, CATALOG_REC_TOL: log-space sums over time
# steps in another order), gradients within CATALOG_GRAD_TOL, integer
# outputs equal. (b) the book's chapters (tests/test_book.py's nets on
# synthetic rows of the same shapes): BOOK_STEPS Adam steps on one batch,
# card against CPU within BOOK_LOSS_TOL relative, the loss falls.
CATALOG_FWD_TOL, CATALOG_REC_TOL, CATALOG_GRAD_TOL = 1e-5, 1e-4, 1e-4
BOOK_STEPS, BOOK_LOSS_TOL = 4, 1e-4
# (c) the label_semantic_roles tagger at the reference book's published
# widths: word_dim 32, mark_dim 5, hidden_dim 512 (each fc's width and each
# LSTM's 4H, fluid's dynamic_lstm size: H = 128), depth 8 LSTMs of
# alternating direction, a CRF over the 59 labels, the conll05
# vocabularies (paddle_tpu/dataset/conll05.py:13-15), batch 10 with
# lengths drawn in [5, 60]. Card against CPU Viterbi tags: equal, or the
# two paths' scores within SRL_TIE_TOL relative (a near tie).
SRL_CFG = dict(word_dim=32, mark_dim=5, hidden=512, depth=8, labels=59, words=44068,
               preds=3162, batch=10, min_len=5, max_len=60)
SRL_STEPS, SRL_LR, SRL_TIE_TOL = 8, 1e-3, 1e-4
# (d) nets.scaled_dot_product_attention, bf16 and flash on, against the
# composed route: [batch, T, width], heads
CATALOG_ATTN = (8, 1024, 512, 8)

# (e) SSD300's head at its published widths (Liu et al., "SSD: Single Shot
# MultiBox Detector", ECCV 2016, SSD300 on VOC): the six source maps (NHWC,
# the backbone left out, synthetic features from a seed) with their prior
# sizes and aspect ratios, flip on: 8732 priors, 21 classes; batch 8 with up
# to 16 padded ground-truth boxes an image. DET_STEPS Adam steps of
# multi_box_head -> ssd_loss (the mean over images), card against CPU within
# BOOK_LOSS_TOL, the loss falls; then detection_output (nms_top_k 400,
# keep_top_k 200, the JAX package's defaults) and detection_map on the
# trained head.
SSD300 = dict(maps=((38, 512), (19, 1024), (10, 512), (5, 256), (3, 256), (1, 256)),
              min_sizes=(30.0, 60.0, 111.0, 162.0, 213.0, 264.0),
              max_sizes=(60.0, 111.0, 162.0, 213.0, 264.0, 315.0),
              aspect_ratios=((2.0,), (2.0, 3.0), (2.0, 3.0), (2.0, 3.0), (2.0,), (2.0,)),
              image=(300, 300), classes=21, batch=8, max_gt=16, priors=8732,
              nms_top_k=400, keep_top_k=200, nms=0.3, score=0.01)
# (f) Faster R-CNN's RPN (Ren et al., "Faster R-CNN", NIPS 2015): the
# conv5 map of an 800 x 1344 image at stride 16 (50 x 84, 512 channels),
# anchor_generator at the JAX package's defaults (4 sizes x 3 ratios: 50,400
# anchors), a 3x3 conv of 512 and 1x1 heads of 12 and 48; 2 images with up
# to 16 ground-truth boxes. rpn_target_assign (256 an image) and the loss
# (sigmoid cross-entropy on the sampled anchors, smooth L1 on the fg),
# DET_STEPS Adam steps as in (e); then generate_proposals (6000 -> NMS 0.7 ->
# 1000) and generate_proposal_labels on the 1000 proposals, both devices
# given the CPU's priorities.
RPN_CFG = dict(map=(50, 84), channels=512, image=(800.0, 1344.0), batch=2, max_gt=16,
               anchors=50400, per_im=256, pre_nms=6000, post_nms=1000, nms=0.7, classes=21)
# Adam's learning rate: SSD's head 1e-3; the RPN's 3x3 conv (4608 inputs a
# unit) 1e-4, since at 1e-3 Adam's first step sends its loss up fivefold
DET_STEPS, SSD_LR, RPN_LR = 4, 1e-3, 1e-4
# NMS outputs card against CPU on the same inputs: equal, or first differing
# at a near tie (two scores, or an IoU and the threshold, within DET_TIE_TOL
# relative; output_divergence); DET_CHECK_IMAGES images of (e) are held so
DET_TIE_TOL, DET_CHECK_IMAGES = 1e-6, 2

# the book chapters' vocabularies (paddle_tpu/dataset: imikolov, imdb,
# movielens, conll05) and the SRL chapter's clipped word vocabulary
BOOK_VOCAB = dict(imikolov=2074, imdb=5149, users=6041, jobs=21, movies=3953, ages=7,
                  srl_words=2000, srl_labels=59)


def book_chapters(pt):
    """The book's chapters (tests/test_book.py) over the package ``pt`` —
    the port, or any package with its layer catalog: name → (net, Adam
    learning rate)."""
    L, V = pt.layers, BOOK_VOCAB

    def fit_a_line(x, y):
        return L.mean(pt.ops.nn.square_error_cost(L.fc(x, size=1), y))

    def word2vec(ngram, label):
        shared = pt.framework.ParamAttr(name="shared_emb")
        embs = [L.embedding(ngram[:, i], size=[V["imikolov"], 32], param_attr=shared)
                for i in range(4)]
        hidden = L.fc(L.concat(embs, axis=-1), size=64, act="sigmoid")
        logits = L.fc(hidden, size=V["imikolov"])
        return L.mean(L.softmax_with_cross_entropy(logits, L.unsqueeze(label, [1])))

    def recommender_system(user, gender, age, job, movie, score):
        with pt.name_scope("user_tower"):
            u = L.concat([L.embedding(user, size=[V["users"], 16]),
                          L.embedding(gender, size=[2, 4]),
                          L.embedding(age, size=[V["ages"], 4]),
                          L.embedding(job, size=[V["jobs"], 8])], axis=-1)
            u = L.fc(u, size=32, act="tanh")
        with pt.name_scope("movie_tower"):
            m = L.fc(L.embedding(movie, size=[V["movies"], 16]), size=32, act="tanh")
        pred = L.scale(L.cos_sim(u, m), 5.0)
        return L.mean(L.square(L.elementwise_sub(L.squeeze(pred, [1]), score)))

    def label_semantic_roles(words, mark, labels, lengths):
        k = V["srl_labels"]
        x = L.concat([L.embedding(words, size=[V["srl_words"], 32]),
                      L.embedding(mark, size=[2, 8])], axis=-1)
        hidden, _ = L.dynamic_lstm(L.fc(x, size=4 * 32, num_flatten_dims=2), size=32,
                                   lengths=lengths)
        emissions = L.fc(hidden, size=k, num_flatten_dims=2)
        trans = pt.create_parameter([k + 2, k], "float32", name="crf_transition")
        return L.mean(L.linear_chain_crf(emissions, labels, lengths, trans))

    def understand_sentiment(tokens, lengths, label):
        emb = L.embedding(tokens, size=[V["imdb"], 32])
        hidden, _ = L.dynamic_lstm(L.fc(emb, size=4 * 32, num_flatten_dims=2), size=32,
                                   lengths=lengths)
        pooled = L.sequence_pool(hidden, lengths, "max")
        return L.mean(L.softmax_with_cross_entropy(L.fc(pooled, size=2), L.unsqueeze(label, [1])))

    def recognize_digits(img, label):
        b = img.shape[0]
        conv = pt.nets.simple_img_conv_pool(L.reshape(img, [b, 28, 28, 1]), num_filters=8,
                                            filter_size=3, pool_size=2, pool_stride=2, act="relu")
        logits = L.fc(L.reshape(conv, [b, -1]), size=10)
        return L.mean(L.softmax_with_cross_entropy(logits, label))

    def image_classification(img, label):
        b = img.shape[0]
        x = L.transpose(L.reshape(img, [b, 3, 32, 32]), [0, 2, 3, 1])
        x = L.conv2d(x, num_filters=8, filter_size=3, padding=1, act="relu")
        x = L.pool2d(x, pool_size=2, pool_stride=2)
        x = L.conv2d(x, num_filters=16, filter_size=3, padding=1, act="relu")
        x = L.pool2d(x, pool_size=2, pool_stride=2)
        return L.mean(L.softmax_with_cross_entropy(L.fc(L.reshape(x, [b, -1]), size=10), label))

    return {"fit_a_line": (fit_a_line, 1e-2), "word2vec": (word2vec, 1e-3),
            "recommender_system": (recommender_system, 5e-3),
            "label_semantic_roles": (label_semantic_roles, 2e-3),
            "understand_sentiment": (understand_sentiment, 2e-3),
            "recognize_digits": (recognize_digits, 1e-3),
            "image_classification": (image_classification, 1e-3)}


def book_batch(name: str, seed: int = 0) -> tuple:
    """A synthetic batch of the chapter's shapes and dtypes (numpy arrays):
    tests/test_book.py's batch sizes, ids within the vocabularies,
    ragged lengths with zeros past them."""
    import numpy as np

    rng, V = np.random.RandomState(seed), BOOK_VOCAB

    def ids(high, *shape):
        return rng.randint(0, high, size=shape).astype(np.int32)

    def ragged(batch, t, lo):
        lengths = rng.randint(lo, t + 1, size=batch).astype(np.int32)
        return lengths, np.arange(t)[None, :] < lengths[:, None]

    if name == "fit_a_line":
        x = rng.randn(64, 13).astype(np.float32)
        return x, (x @ rng.randn(13, 1) * 0.3 + 0.1 * rng.randn(64, 1)).astype(np.float32)
    if name == "word2vec":
        return ids(V["imikolov"], 64, 4), ids(V["imikolov"], 64)
    if name == "recommender_system":
        return (ids(V["users"], 32), ids(2, 32), ids(V["ages"], 32), ids(V["jobs"], 32),
                ids(V["movies"], 32), rng.uniform(1, 5, size=32).astype(np.float32))
    if name == "label_semantic_roles":
        lengths, live = ragged(16, 30, 5)
        return (ids(V["srl_words"], 16, 30) * live, ids(2, 16, 30) * live,
                ids(V["srl_labels"], 16, 30) * live, lengths)
    if name == "understand_sentiment":
        lengths, live = ragged(32, 100, 10)
        return ids(V["imdb"], 32, 100) * live, lengths, ids(2, 32)
    if name == "recognize_digits":
        return rng.uniform(-1, 1, size=(32, 784)).astype(np.float32), ids(10, 32, 1)
    if name == "image_classification":
        return rng.uniform(-1, 1, size=(16, 3072)).astype(np.float32), ids(10, 16, 1)
    raise KeyError(name)


def srl_net(pt, cfg):
    """The label_semantic_roles tagger of the reference book (db_lstm) over
    the package ``pt``: six word-window embeddings from one table (``emb``,
    one lookup of the stacked windows), the
    predicate's and the mark's, a tanh fc of each summed (the hidden layer),
    an LSTM, then ``depth - 1`` blocks of two summed tanh fcs and an LSTM of
    alternating direction, two summed fcs to the label scores, and the CRF
    (``crfw``). Returns (mean NLL, emissions). The LSTMs take the fc's
    output as their gates (``proj_input=False``), as fluid's dynamic_lstm
    does; their activations are the standard sigmoid/tanh, where the book
    asks for a relu candidate and a sigmoid cell."""
    L, h = pt.layers, cfg["hidden"]

    def fc(x, size, act=None):
        return L.fc(x, size=size, num_flatten_dims=2, act=act)

    def net(word, ctx_n2, ctx_n1, ctx_0, ctx_p1, ctx_p2, predicate, mark, target, lengths):
        windows = L.stack([word, ctx_n2, ctx_n1, ctx_0, ctx_p1, ctx_p2], axis=0)
        embs = L.unstack(L.embedding(windows, size=[cfg["words"], cfg["word_dim"]], name="emb"))
        embs.append(L.embedding(predicate, size=[cfg["preds"], cfg["word_dim"]]))
        embs.append(L.embedding(mark, size=[2, cfg["mark_dim"]]))
        hidden = L.sums([fc(e, h, "tanh") for e in embs])
        lstm, _ = L.dynamic_lstm(hidden, h // 4, lengths, proj_input=False)
        pair = [hidden, lstm]
        for i in range(1, cfg["depth"]):
            mix = L.sums([fc(pair[0], h, "tanh"), fc(pair[1], h, "tanh")])
            lstm, _ = L.dynamic_lstm(mix, h // 4, lengths, is_reverse=i % 2 == 1, proj_input=False)
            pair = [mix, lstm]
        emissions = L.sums([fc(pair[0], cfg["labels"]), fc(pair[1], cfg["labels"])])
        trans = pt.create_parameter([cfg["labels"] + 2, cfg["labels"]], "float32", name="crfw")
        return L.mean(L.linear_chain_crf(emissions, target, lengths, trans)), emissions

    return net


def srl_batch(cfg, seed: int = 0) -> tuple:
    """A synthetic conll05 batch: 6 word windows, the predicate, the mark,
    the labels and the lengths (uniform in [min_len, max_len]; zeros past
    each row's length)."""
    import numpy as np

    rng = np.random.RandomState(seed)
    b, t = cfg["batch"], cfg["max_len"]
    lengths = rng.randint(cfg["min_len"], t + 1, size=b).astype(np.int32)
    live = np.arange(t)[None, :] < lengths[:, None]

    def ids(high):
        return (rng.randint(0, high, size=(b, t)) * live).astype(np.int32)

    words = [ids(cfg["words"]) for _ in range(6)]
    return (*words, ids(cfg["preds"]), ids(2), ids(cfg["labels"]), lengths)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def time_ms(fn, iters: int = 20, sleep_cycles: int = 100_000_000) -> float:
    """Device time of one call of ``fn``: CUDA events around ``iters`` calls
    enqueued behind a sleep kernel of ``sleep_cycles``, so the host's enqueue
    time is hidden (where the host enqueues ``iters`` calls slower than the
    sleep lasts, the host's time shows, as a caller would see it)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(sleep_cycles)
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
    from paddle_tpu_torch.framework import Variables
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

    # (e) amp_minimize against the bf16 minimize step on the weights after
    # those 8 steps rounded to bf16, which is what amp's forward computes on
    # (BN's scale and bias and the fc bias included); the unrounded
    # weights' loss beside it, as a number
    amp = amp_minimize(opt, spec.model, compute_dtype="bfloat16")(v, st, None, x, y)
    amp_loss = float(amp.loss)
    rounded = Variables({k: t.to(torch.bfloat16).float() for k, t in v.params.items()}, v.state)
    ref_loss = float(step(rounded, st, x, y).loss)
    unrounded_loss = float(step(v, st, x, y).loss)
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
          "amp_loss": amp_loss, "minimize_loss_bf16_weights": ref_loss, "amp_loss_abs_err": amp_err,
          "amp_loss_tol": AMP_LOSS_TOL, "minimize_loss_f32_weights": unrounded_loss,
          "amp_vs_f32_weights_abs_diff": abs(amp_loss - unrounded_loss), "card": smi})
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
                                           dropout_key=gen)
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
                                                dropout_key=gen).float() - ref
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
        stats["busy_ms"] = device_busy_ms(prof)
        stats["idle_share"] = 1.0 - stats["busy_ms"] / 1e3 / wall if stats["busy_ms"] else None
        stats["profiler_post_s"] = time.perf_counter() - t_post
    return outs, stats


def device_busy_ms(prof) -> float:
    """The summed durations of a torch.profiler run's device activities."""
    try:  # the raw device events: building the profiler's event tree
        # for a burst's ~10^5 kernels would take ~20 s of host time
        busy_us = 1e-3 * sum(e.duration_ns() for e in prof.profiler.kineto_results.events()
                             if "CUDA" in str(e.device_type()) and not e.is_user_annotation())
    except AttributeError:
        busy_us = sum(evt.self_device_time_total for evt in prof.key_averages()
                      if "CUDA" in str(getattr(evt, "device_type", ""))
                      and not getattr(evt, "is_user_annotation", False))
    return busy_us / 1e3


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


def serve_traffic(vocab: int) -> dict:
    """Phase serve's requests, drawn from RandomState(0) in the phase's
    order: the mixed burst (``lens``, ``mnts``, ``prompts``, ``reqs``),
    the decode step's ``step_tokens`` and the shared-prefix requests
    (``prefix_prompts``, ``prefix_reqs``); ``rng`` goes on from there.
    Phase fleet drives the same."""
    import numpy as np

    rng = np.random.RandomState(0)
    lens = rng.randint(SERVE_PROMPT_LEN[0], SERVE_PROMPT_LEN[1] + 1, size=SERVE_REQUESTS)
    mnts = rng.randint(SERVE_NEW_TOKENS[0], SERVE_NEW_TOKENS[1] + 1, size=SERVE_REQUESTS)
    prompts = [rng.randint(1, vocab, size=(int(n),)).astype(np.int32) for n in lens]
    step_tokens = rng.randint(1, vocab, size=(SERVE_CONFIG["max_slots"],)).astype(np.int32)
    shared = rng.randint(1, vocab, size=(SERVE_PREFIX,)).astype(np.int32)
    tails = rng.randint(SERVE_PREFIX_TAIL[0], SERVE_PREFIX_TAIL[1] + 1, size=SERVE_PREFIX_REQUESTS)
    pprompts = [np.concatenate([shared, rng.randint(1, vocab, size=(int(n),)).astype(np.int32)])
                for n in tails]
    return {"lens": lens, "mnts": mnts, "prompts": prompts,
            "reqs": [(p, int(n)) for p, n in zip(prompts, mnts)], "step_tokens": step_tokens,
            "prefix_prompts": pprompts, "prefix_reqs": [(p, SERVE_PREFIX_NEW) for p in pprompts],
            "rng": rng}


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
    traffic = serve_traffic(cfg["vocab"])
    lens, mnts, prompts, reqs = traffic["lens"], traffic["mnts"], traffic["prompts"], traffic["reqs"]
    rng = traffic["rng"]  # drawn on for generate_beam's prompts
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
        tokens = traffic["step_tokens"]

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
    pprompts, preqs = traffic["prefix_prompts"], traffic["prefix_reqs"]
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


def fleet_results(handles, rids, replayed, resumed):
    """Each request's tokens after an engine died under it: its handle's
    (done before the death, or on a surviving engine), else the journal's
    finished record, else its resumed handle's; None where none has it."""
    out = []
    for h, rid in zip(handles, rids):
        try:
            out.append(list(h.result(timeout=SERVE_WAIT_S).tokens))
            continue
        except Exception:
            pass
        rr = replayed.get(rid)
        if rr is not None and rr.finished:
            out.append(list(rr.generated))
        elif rid in resumed:
            out.append(list(resumed[rid][0].result(timeout=SERVE_WAIT_S).tokens))
        else:
            out.append(None)
    return out


def fleet_phase(smi: str):
    """Phase 10b: the rest of serving at BASE_CFG (DisaggRouter on both
    transports, the host KV tier, DecodeFleet, the journal, the fleet
    rollup). Returns its kernel launches by path and its checks."""
    import json
    import shutil
    import tempfile
    import urllib.error
    import urllib.request

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile as tprofile

    from paddle_tpu_torch import tracing
    from paddle_tpu_torch.core.config import set_flags
    from paddle_tpu_torch.models import get_model
    from paddle_tpu_torch.observability import fleet as obs_fleet
    from paddle_tpu_torch.observability import metrics as obs_metrics
    from paddle_tpu_torch.observability.exporter import MetricsServer
    from paddle_tpu_torch.resilience import faults
    from paddle_tpu_torch.resilience.circuit import OPEN
    from paddle_tpu_torch.serving import (DecodeConfig, DecodeEngine, DecodeFleet, DisaggRouter,
                                          HostPagePool, RequestJournal, ServingConfig,
                                          replay_journal, resume_incomplete)
    from paddle_tpu_torch.serving.disagg import DECODE, PREFILL

    set_flags(use_flash_attention=True, use_bf16_compute=False, check_nan_inf=False)
    marks = [time.perf_counter()]

    def lap():
        marks.append(time.perf_counter())
        return marks[-1] - marks[-2]

    spec = get_model("transformer_lm")  # BASE_CFG on CUDA
    cfg = spec.extra["cfg"]
    params = spec.model.init(0, *spec.synth_batch(1, np.random.RandomState(0))).params
    traffic = serve_traffic(cfg["vocab"])
    prompts, reqs = traffic["prompts"][:FLEET_REQUESTS], traffic["reqs"][:FLEET_REQUESTS]
    pprompts, preqs = traffic["prefix_prompts"], traffic["prefix_reqs"]
    ps = SERVE_CONFIG["page_size"]
    work = tempfile.mkdtemp(prefix="chip_smoke_fleet_")
    checks, paths = {}, {}

    def engine(label, host_tier=None, **kw):
        return DecodeEngine(params, cfg, config=ServingConfig(engine_label=label),
                            decode=DecodeConfig(**dict(SERVE_CONFIG, **kw)), host_tier=host_tier)

    def span_ms(handles, name):
        """(summed ms, summed "pages" attr, count) of the named spans of
        the handles' traces."""
        ms = pages = n = 0
        for h in handles:
            for sp in tracing.spans_for_trace(h.trace.trace_id):
                if sp.name == name:
                    ms += (sp.t1_us - sp.t0_us) / 1e3
                    pages += sp.attrs.get("pages", 0)
                    n += 1
        return ms, pages, n

    def no_faults(*engines):
        return not any(e.metrics.snapshot()[k] for e in engines for k in SERVE_FAULT_COUNTERS)

    def flash0(launches):
        return all(launches[k] == 0 for k in HOPPER_KERNELS)

    # (a) the disaggregated burst, device transport then serialized
    ref_outs, ref = serve_burst(params, cfg, reqs, SERVE_CONFIG)
    ref_toks = [o.tokens for o in ref_outs]
    generated = sum(len(t) for t in ref_toks)
    routers, a = {}, {}
    for transport in ("device", "serialized"):
        # the burst unprofiled (its wall time), then under the profiler on
        # fresh workers (its device records)
        pre, dec = engine(f"fleet-pre-{transport}-0"), engine(f"fleet-dec-{transport}-0")
        router = DisaggRouter([pre, dec], [PREFILL, DECODE], transport=transport)
        try:
            t0 = time.perf_counter()
            plain = [h.result(timeout=SERVE_WAIT_S) for h in [router.submit(p, n) for p, n in reqs]]
            torch.cuda.synchronize()
            plain_wall = time.perf_counter() - t0
            plain_clean = no_faults(pre, dec)
        finally:
            router.close(timeout=SERVE_WAIT_S)
        pre, dec = engine(f"fleet-pre-{transport}"), engine(f"fleet-dec-{transport}")
        router = routers[transport] = DisaggRouter([pre, dec], [PREFILL, DECODE], transport=transport)
        torch.cuda.synchronize()
        zero_kernel_counts()
        prof = tprofile(activities=[ProfilerActivity.CUDA])
        prof.__enter__()
        profile_markers()
        t0 = time.perf_counter()
        handles = [router.submit(p, n) for p, n in reqs]
        outs = [h.result(timeout=SERVE_WAIT_S) for h in handles]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        profile_markers()
        t_post = time.perf_counter()
        prof.__exit__(None, None, None)
        paths[f"fleet_{transport}"] = launches = kernel_launch_counts()
        names = device_records(prof)
        sp, sd = pre.metrics.snapshot(), dec.metrics.snapshot()
        # a decode step reads its sampled tokens back, so does a prefill's
        # last chunk: admits that did not come in by handoff, plus resumes
        readbacks = (sp["steps_total"] + sd["steps_total"] + sp["admitted_total"]
                     + sp["resumed_total"] + sd["admitted_total"] - sd["handoffs_in_total"]
                     + sd["resumed_total"])
        dtoh = sum("DtoH" in n for n in names)
        busy = device_busy_ms(prof)
        transfer_ms, _, n_transfer = span_ms(handles, "serving.handoff.transfer")
        adopt_ms, adopt_pages, _ = span_ms(handles, "serving.handoff.adopt")
        post_s = time.perf_counter() - t_post
        ok, gaps = held_against(params, cfg, prompts, ref_toks, [o.tokens for o in outs])
        ok_plain, _ = held_against(params, cfg, prompts, ref_toks, [o.tokens for o in plain])
        a[transport] = {"handles": handles, "wall_s_unprofiled": plain_wall,
                        "wall_s": wall, "profiler_post_s": post_s, "busy_ms": busy,
                        "idle_share": 1.0 - busy / 1e3 / wall, "device_records": len(names),
                        "kernels": sum(not n.startswith("Memcpy") and not n.startswith("Memset")
                                       for n in names),
                        "dtoh_copies": dtoh, "sampled_readbacks": readbacks,
                        "host_hops": dtoh - readbacks, "intact": profile_intact(prof),
                        "handoffs": router.handoffs_total, "rejects": router.handoff_rejects_total,
                        "transfer_ms_mean": transfer_ms / max(n_transfer, 1),
                        "adopt_pages": adopt_pages, "steps": sd["steps_total"],
                        "first_differences": {str(i): {"index": j, "gap": g}
                                              for i, (j, g) in gaps.items()}}
        t = transport
        checks.update({
            f"a_{t}_tokens_held": ok and ok_plain,
            f"a_{t}_lengths": [len(o.tokens) for o in outs] == [n for _, n in reqs],
            f"a_{t}_unprofiled_no_step_faults": plain_clean,
            f"a_{t}_handoffs_eq_requests": (router.handoffs_total == len(reqs)
                                           == sp["handoffs_out_total"] == sd["handoffs_in_total"]
                                           and router.handoff_rejects_total == 0),
            f"a_{t}_no_decode_on_prefill_worker": sp["steps_total"] == 0,
            f"a_{t}_profile_intact": a[t]["intact"],
            f"a_{t}_no_step_faults": no_faults(pre, dec),
            f"a_{t}_flash_launches_0": flash0(launches),
        })
        if transport == "serialized":
            router.close(timeout=SERVE_WAIT_S)
            pre.kv.assert_no_leaks()
            dec.kv.assert_no_leaks()
    checks["a_device_no_host_hop"] = a["device"]["host_hops"] == 0
    # the count sees copies: the wire format's one copy a handoff shows up
    checks["a_serialized_one_host_copy_per_handoff"] = (a["serialized"]["host_hops"]
                                                        == a["serialized"]["handoffs"])
    # the device transport's page copy alone, at the median request's pages
    pre, dec = routers["device"].engines
    n_pages = int(np.median([-(-len(p) // ps) for p in prompts]))
    pages = list(range(1, 1 + n_pages))  # free on both idle engines
    copy_ms = time_ms(lambda: dec._implant_pages(pages, *pre._gather_pages(pages)),
                      iters=FLEET_COPY_ITERS)
    # its device work alone: the same two copies a page array, indices
    # already on the card (the engine uploads them, a synchronizing copy)
    idx = pre._page_index(pages)

    def page_copies():
        for src, dst in ((pre._k_pages, dec._k_pages), (pre._v_pages, dec._v_pages)):
            dst.index_copy_(1, idx, src.index_select(1, idx))

    copy_device_ms = time_ms(page_copies, iters=FLEET_COPY_ITERS)
    page_bytes = pre._k_pages[:, 0].numel() * pre._k_pages.element_size()
    copy_bytes = 4 * n_pages * page_bytes  # K and V pages read once, written once
    emit({"phase": "fleet", "part": "a_disaggregated", "part_s": lap(), "model": "transformer_lm",
          "params": sum(p.numel() for p in params.values()), "config": SERVE_CONFIG,
          "dtype": "float32", "requests": len(reqs), "generated_tokens": generated,
          "one_engine_wall_s": ref["wall_s"],
          "one_engine_tokens_per_s": generated / ref["wall_s"],
          "one_engine_steps": ref["metrics"]["steps_total"],
          **{t: {k: v for k, v in r.items() if k != "handles"} | {
              "tokens_per_s": generated / r["wall_s"]} for t, r in a.items()},
          "handoff_copy": {"pages": n_pages, "page_bytes_k_or_v": page_bytes,
                           "ms": copy_ms, "device_ms": copy_device_ms, "bytes": copy_bytes,
                           "bound_ms": 1e3 * copy_bytes / PEAK_HBM_BYTES,
                           "design": "index_select (prefill pages) + index_copy_ (decode pages)"},
          "launches_device": paths["fleet_device"], "tie_tol": SERVE_TIE_TOL, "card": smi})

    # (b) the host KV tier shared by two engines
    pref_outs, pref = serve_burst(params, cfg, preqs, SERVE_CONFIG)
    pref_toks = [o.tokens for o in pref_outs]
    pool = HostPagePool(FLEET_HOST_TIER_BYTES, ps)
    b = {}
    zero_kernel_counts()
    for name in ("A", "B"):
        eng = engine(f"fleet-tier-{name}", prefix_cache=True, host_tier=pool)
        try:
            t0 = time.perf_counter()
            h0 = eng.submit(*preqs[0])
            first = h0.result(timeout=SERVE_WAIT_S)  # A: the tree takes the prefix; B: promotes
            handles = [h0] + [eng.submit(p, n) for p, n in preqs[1:]]
            toks = [first.tokens] + [h.result(timeout=SERVE_WAIT_S).tokens for h in handles[1:]]
            torch.cuda.synchronize()
            snap = eng.metrics.snapshot()
            demote_ms, demote_pages, _ = span_ms(handles, "serving.host_tier.demote")
            promote_p50 = obs_metrics.default_registry().quantile(
                "serving.host_tier.promote_seconds", 0.5, {"engine": eng.metrics.engine_label})
            ok, gaps = held_against(params, cfg, pprompts, pref_toks, toks)
            b[name] = {"wall_s": time.perf_counter() - t0, "tokens_held": ok,
                       "first_differences": {str(i): {"index": j, "gap": g}
                                             for i, (j, g) in gaps.items()},
                       "faults_clean": no_faults(eng),
                       **{k: snap[k] for k in ("host_tier_hits_total", "host_promoted_pages_total",
                                               "host_demoted_pages_total", "host_quarantined_total",
                                               "host_backpressure_total", "prefix_hit_tokens_total",
                                               "prefill_chunks_total")},
                       "demote_ms_per_page": demote_ms / demote_pages if demote_pages else None,
                       "promote_ms_p50_histogram": (1e3 * promote_p50 if promote_p50 else None)}
        finally:
            unjoined = eng.close(timeout=SERVE_WAIT_S)
        eng.kv.assert_no_leaks()
        b[name]["unjoined"] = unjoined
    paths["fleet_host_tier"] = kernel_launch_counts()
    # a demote's two costs alone, on an idle engine: the copy of 32 pages
    # to the host (one copy a page array), then the pool's put (CRC) a page
    eng = engine("fleet-tier-probe")
    try:
        probe_pages = list(range(1, 33))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        k, v = eng._gather_pages(probe_pages)
        k, v = k.contiguous().cpu(), v.contiguous().cpu()
        t1 = time.perf_counter()
        probe_pool = HostPagePool(FLEET_HOST_TIER_BYTES, ps)
        toks = np.arange(1, 32 * ps + 1, dtype=np.int32)
        for i in range(32):
            probe_pool.put(toks, i, k[i], v[i])
        t2 = time.perf_counter()
    finally:
        eng.close(timeout=SERVE_WAIT_S)
    b["demote_probe"] = {"pages": 32, "copy_ms_per_page": 1e3 * (t1 - t0) / 32,
                         "put_ms_per_page": 1e3 * (t2 - t1) / 32}
    checks.update({
        "b_tokens_held": b["A"]["tokens_held"] and b["B"]["tokens_held"],
        "b_A_demoted": b["A"]["host_demoted_pages_total"] >= SERVE_PREFIX // ps,
        "b_B_host_hits": b["B"]["host_tier_hits_total"] > 0,
        "b_B_promotes": b["B"]["host_promoted_pages_total"] >= SERVE_PREFIX // ps,
        "b_B_prefix_hits_after_promote": (b["B"]["prefix_hit_tokens_total"]
                                          >= (SERVE_PREFIX_REQUESTS - 1) * SERVE_PREFIX),
        "b_no_quarantine": b["B"]["host_quarantined_total"] == 0,
        "b_no_step_faults": b["A"]["faults_clean"] and b["B"]["faults_clean"],
        "b_no_leaks": not b["A"]["unjoined"] and not b["B"]["unjoined"],
        "b_flash_launches_0": flash0(paths["fleet_host_tier"]),
    })
    emit({"phase": "fleet", "part": "b_host_tier", "part_s": lap(), "requests": len(preqs),
          "prefix": SERVE_PREFIX, "pool_bytes": FLEET_HOST_TIER_BYTES, "pool": pool.stats(),
          "page_pair_bytes": 2 * page_bytes, "one_engine_wall_s": pref["wall_s"], **b,
          "card": smi})

    # (c) a killed engine's journal resumed on its peer; a tripped breaker
    zero_kernel_counts()
    jpath = os.path.join(work, "fleet_kill.wal")
    ea, eb = engine("fleet-kill-A", journal_path=jpath), engine("fleet-kill-B")
    fleet = DecodeFleet([ea, eb])
    try:
        handles = [fleet.submit(p, n) for p, n in reqs]
        rids = [h._req.rid for h in handles]
        on_a = sum(r.startswith("fleet-kill-A") for r in rids)
        deadline = time.monotonic() + SERVE_WAIT_S
        while ea.metrics.snapshot()["tokens_total"] < FLEET_KILL_TOKENS:
            if time.monotonic() > deadline:
                raise TimeoutError("fleet (c): engine A never generated its tokens")
            time.sleep(0.001)
        ea.kill()
        replayed = replay_journal(jpath)
        resumed = resume_incomplete(eb, jpath)
        toks_c = fleet_results(handles, rids, replayed, resumed)
        dedup = all(list(resumed[r][0].result(timeout=SERVE_WAIT_S).tokens)[:nd]
                    == replayed[r].generated[:nd] for r, (_, nd) in resumed.items())
        ok_c, gaps_c = held_against(params, cfg, prompts, ref_toks,
                                    [t if t is not None else [] for t in toks_c])
        c_kill = {"requests_on_A": on_a, "journaled": len(replayed),
                  "finished_before_kill": sum(r.finished for r in replayed.values()),
                  "resumed": len(resumed), "replayed_metric": eb.metrics.snapshot()["journal_replayed_total"],
                  "first_differences": {str(i): {"index": j, "gap": g} for i, (j, g) in gaps_c.items()}}
        checks.update({
            "c_kill_no_request_lost": all(t is not None and len(t) == n
                                          for t, (_, n) in zip(toks_c, reqs)),
            "c_kill_tokens_held": ok_c,
            "c_kill_journal_covers_A": len(replayed) == on_a and on_a > 0,
            "c_kill_resumed_prefix_dedup": dedup and len(resumed) > 0,
            "c_kill_B_no_step_faults": no_faults(eb),
        })
    finally:
        fleet.close(timeout=SERVE_WAIT_S)
    eb.kv.assert_no_leaks()
    mreqs = reqs[:FLEET_MIGRATE_REQUESTS]
    ec, ed = engine("fleet-sick-C", unhealthy_after=2), engine("fleet-sick-D")
    fleet = DecodeFleet([ec, ed])
    try:
        with faults.injected(faults.FaultSpec(faults.DECODE_STEP, "error", after=2, times=10 ** 9,
                                              match={"engine": "fleet-sick-C"})):
            t0 = time.perf_counter()
            outs = [h.result(timeout=SERVE_WAIT_S) for h in [ec.submit(p, n) for p, n in mreqs]]
            migrate_wall = time.perf_counter() - t0
            state = ec.breaker.state
        sc, sd = ec.metrics.snapshot(), ed.metrics.snapshot()
        ok_m, gaps_m = held_against(params, cfg, prompts, ref_toks[:len(mreqs)],
                                    [o.tokens for o in outs])
        c_migrate = {"requests": len(mreqs), "migrated": sc["migrated_total"],
                     "step_faults_C": sc["step_faults_total"], "wall_s": migrate_wall,
                     "first_differences": {str(i): {"index": j, "gap": g} for i, (j, g) in gaps_m.items()}}
        checks.update({
            "c_migrate_breaker_open": state == OPEN,
            "c_migrate_all_migrated": sc["migrated_total"] == len(mreqs),
            "c_migrate_no_request_lost": [len(o.tokens) for o in outs] == [n for _, n in mreqs],
            "c_migrate_tokens_held": ok_m,
            "c_migrate_D_no_step_faults": no_faults(ed),
        })
    finally:
        fleet.close(timeout=SERVE_WAIT_S)
    ed.kv.assert_no_leaks()
    paths["fleet_migration"] = kernel_launch_counts()
    checks["c_flash_launches_0"] = flash0(paths["fleet_migration"])
    emit({"phase": "fleet", "part": "c_decode_fleet", "part_s": lap(), "kill": c_kill,
          "kill_after_tokens": FLEET_KILL_TOKENS, "migrate": c_migrate, "card": smi})

    # (d) the journal: tokens/s off and on, an abandoned burst replayed
    zero_kernel_counts()
    d = {"off": {"wall_s": [], "tokens_held": True}, "on": {"wall_s": [], "tokens_held": True}}
    for turn, on in enumerate((False, True, True, False)):
        side = d["on" if on else "off"]
        eng = engine(f"fleet-journal-{turn}",
                     journal_path=os.path.join(work, f"fleet_on_{turn}.wal") if on else None)
        try:
            t0 = time.perf_counter()
            outs = [h.result(timeout=SERVE_WAIT_S) for h in [eng.submit(p, n) for p, n in reqs]]
            torch.cuda.synchronize()
            side["wall_s"].append(time.perf_counter() - t0)
            side["journal_records"] = eng.metrics.snapshot()["journal_records_total"]
        finally:
            eng.close(timeout=SERVE_WAIT_S)
        ok, _ = held_against(params, cfg, prompts, ref_toks, [o.tokens for o in outs])
        side["tokens_held"] = side["tokens_held"] and ok
    for side in d.values():
        side["tokens_per_s"] = [generated / w for w in side["wall_s"]]
    jpath = os.path.join(work, "fleet_abandon.wal")
    ej = engine("fleet-abandoned", journal_path=jpath)
    handles = [ej.submit(p, n) for p, n in reqs]
    rids = [h._req.rid for h in handles]
    deadline = time.monotonic() + SERVE_WAIT_S
    while ej.metrics.snapshot()["tokens_total"] < generated // 2:
        if time.monotonic() > deadline:
            raise TimeoutError("fleet (d): the journaled burst never reached half its tokens")
        time.sleep(0.001)
    ej.kill()
    replayed = replay_journal(jpath)
    ek = engine("fleet-replayed")
    try:
        t0 = time.perf_counter()
        resumed = resume_incomplete(ek, jpath)
        toks_d = fleet_results(handles, rids, replayed, resumed)
        resume_wall = time.perf_counter() - t0
        dedup = all(list(resumed[r][0].result(timeout=SERVE_WAIT_S).tokens)[:nd]
                    == replayed[r].generated[:nd] for r, (_, nd) in resumed.items())
        replayed_metric = ek.metrics.snapshot()["journal_replayed_total"]
        ek_clean = no_faults(ek)
    finally:
        ek.close(timeout=SERVE_WAIT_S)
    ek.kv.assert_no_leaks()
    paths["fleet_journal"] = kernel_launch_counts()
    ok_d, gaps_d = held_against(params, cfg, prompts, ref_toks,
                                [t if t is not None else [] for t in toks_d])
    probe = RequestJournal(os.path.join(work, "fsync.wal"), fsync_every=1)
    t0 = time.perf_counter()
    for i in range(FLEET_FSYNCS):
        probe.log_token("fsync-probe", i)
    fsync_ms = 1e3 * (time.perf_counter() - t0) / FLEET_FSYNCS
    probe.close()
    checks.update({
        "d_off_on_tokens_held": d["off"]["tokens_held"] and d["on"]["tokens_held"],
        "d_journal_records_every_token": d["on"]["journal_records"] >= generated + 2 * len(reqs),
        "d_replay_covers_burst": len(replayed) == len(reqs),
        "d_no_request_lost": all(t is not None and len(t) == n for t, (_, n) in zip(toks_d, reqs)),
        "d_tokens_held": ok_d,
        "d_resumed_prefix_dedup": dedup and len(resumed) > 0,
        "d_replayed_metric": replayed_metric == len(resumed),
        "d_no_step_faults": ek_clean,
        "d_flash_launches_0": flash0(paths["fleet_journal"]),
    })
    emit({"phase": "fleet", "part": "d_journal", "part_s": lap(), **d,
          "abandoned_after_tokens": generated // 2,
          "finished_before_kill": sum(r.finished for r in replayed.values()),
          "resumed": len(resumed), "resume_wall_s": resume_wall,
          "fsync_ms_per_append": fsync_ms, "fsync_appends": FLEET_FSYNCS,
          "first_differences": {str(i): {"index": j, "gap": g} for i, (j, g) in gaps_d.items()},
          "card": smi})

    # (e) the rollup and its endpoints over (a)'s device router
    router = routers["device"]
    view = obs_fleet.FleetView(router, name="fleet-smoke")
    obs_fleet.install(view)
    srv = MetricsServer(port=0).start()
    try:
        def get(path):
            try:
                with urllib.request.urlopen(srv.url + path, timeout=30) as resp:
                    return resp.status, json.loads(resp.read().decode("utf-8"))
            except urllib.error.HTTPError as e:
                return e.code, json.loads(e.read().decode("utf-8"))

        status, doc = get("/fleet")
        mine = [v for v in doc if v.get("fleet") == "fleet-smoke"] if status == 200 else []
        roll = mine[0]["rollup"] if mine else {}
        labels = [e.metrics.engine_label for e in router.engines]
        traces = [get("/trace/" + h.trace.trace_id) for h in a["device"]["handles"]]
        bad = [d.get("problems") or d.get("error") for st, d in traces
               if st != 200 or d["problems"] or d["engines"] != labels]
        checks.update({
            "e_fleet_endpoint": status == 200 and len(mine) == 1,
            "e_rollup_handoffs": roll.get("handoffs_total") == len(reqs),
            "e_rollup_engines_healthy": roll.get("engines") == roll.get("engines_healthy") == 2,
            "e_traces_valid_multi_engine": not bad and len(traces) == len(reqs),
        })
        emit({"phase": "fleet", "part": "e_rollup", "part_s": lap(), "rollup": roll,
              "traces": len(traces), "trace_problems": bad[:4],
              "spans_per_trace": float(np.mean([len(d["spans"]) for _, d in traces])), "card": smi})
    finally:
        obs_fleet.uninstall(view)
        srv.close()
        router.close(timeout=SERVE_WAIT_S)
    for e in router.engines:
        e.kv.assert_no_leaks()
    shutil.rmtree(work, ignore_errors=True)
    emit({"phase": "fleet", "seconds": marks[-1] - marks[0], "checks": checks})
    set_flags(use_bf16_compute=True)
    return paths, checks


def group_phase(smi: str, device: str = "cuda:0"):
    """Phase 10c: decode serving on tensor-parallel replica groups at
    BASE_CFG (``DecodeEngine(group=)``, ``DecodeFleet.from_groups``,
    ``DisaggRouter`` across groups), every member on ``device`` (part (f):
    on two cards). Returns its kernel launches by path and its checks."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from paddle_tpu_torch.core.config import set_flags
    from paddle_tpu_torch.core.dtypes import ieee_f32
    from paddle_tpu_torch.observability import metrics as obs_metrics
    from paddle_tpu_torch.observability import runlog
    from paddle_tpu_torch.models import get_model
    from paddle_tpu_torch.resilience import faults
    from paddle_tpu_torch.resilience.circuit import CLOSED, OPEN
    from paddle_tpu_torch.serving import (DecodeConfig, DecodeEngine, DecodeFleet, DisaggRouter,
                                          ServingConfig, default_layout, make_groups)
    from paddle_tpu_torch.serving.disagg import DECODE, PREFILL

    set_flags(use_flash_attention=True, use_bf16_compute=False, check_nan_inf=False)
    marks = [time.perf_counter()]

    def lap():
        marks.append(time.perf_counter())
        return marks[-1] - marks[-2]

    cuda0 = torch.device(device)

    def lm(**over):
        spec = get_model("transformer_lm", device=cuda0, **over)  # BASE_CFG
        batch = spec.synth_batch(1, np.random.RandomState(0))
        return spec.model.init(0, *batch, device=cuda0).params, spec.extra["cfg"]

    params, cfg = lm()
    traffic = serve_traffic(cfg["vocab"])
    prompts, reqs = traffic["prompts"][:GROUP_REQUESTS], traffic["reqs"][:GROUP_REQUESTS]
    checks, paths = {}, {}

    def flash0(launches):
        return all(launches[k] == 0 for k in HOPPER_KERNELS)

    def firsts(gaps):
        return {str(i): {"index": j, "gap": g} for i, (j, g) in gaps.items()}

    def nbytes(t):
        return t.numel() * t.element_size()

    def step_probe(eng):
        """One decode step at full occupancy as serve (a) times it: (host
        ms of 11 runs, kernel launches a step)."""
        S, P = SERVE_CONFIG["max_slots"], SERVE_CONFIG["max_context"] // SERVE_CONFIG["page_size"]
        tables = (1 + np.arange(S * P, dtype=np.int32)).reshape(S, P)
        positions = np.full((S,), SERVE_CONFIG["max_context"] * 11 // 16, np.int32)

        def one_step():
            with torch.no_grad(), ieee_f32():
                return eng._step_call(eng._dev(traffic["step_tokens"]), eng._dev(positions),
                                      eng._dev(tables)).cpu()

        return best_step_ms(one_step, runs=11), profiled_gemms(one_step)[0], tables, positions

    def tp_pair(params, cfg, members, name, probe=False):
        """The requests on one tp=1 engine, then on a tp=2 group over
        ``members``: the group's tokens held against the engine's."""
        outs1, r1 = serve_burst(params, cfg, reqs, SERVE_CONFIG, device=cuda0)
        group = make_groups(2, devices=members)[0]
        outs2, r2 = serve_burst(params, cfg, reqs, SERVE_CONFIG, group=group)
        toks1 = [o.tokens for o in outs1]
        ok, gaps = held_against(params, cfg, prompts, toks1, [o.tokens for o in outs2])
        generated = sum(len(t) for t in toks1)
        rec = {"tokens_held": ok, "first_differences": firsts(gaps), "generated_tokens": generated}
        for tp, r in ((1, r1), (2, r2)):
            rec[f"tp{tp}"] = {"wall_s": r["wall_s"], "tokens_per_s": generated / r["wall_s"],
                              "steps": r["metrics"]["steps_total"],
                              "peak_memory_bytes": r["peak_memory_bytes"],
                              "burst_memory_bytes": r["burst_memory_bytes"],
                              "launches": r["launches"], "faults": r["faults"],
                              "decode_step_cache_size": r["step_sizes"][0]}
        checks.update({
            f"{name}_tokens_equal_tp1_or_near_tie": ok,
            f"{name}_lengths": [len(o.tokens) for o in outs2] == [n for _, n in reqs],
            f"{name}_decode_step_one_shape": r2["step_sizes"][0] == 1,
            f"{name}_flash_launches_0": flash0(r2["launches"]) and flash0(r1["launches"]),
            f"{name}_no_leaks": not r1["unjoined"] and not r2["unjoined"],
            f"{name}_no_step_faults": not any(r1["faults"].values())
            and not any(r2["faults"].values()),
        })
        if probe:
            one = DecodeEngine(params, cfg, decode=DecodeConfig(**SERVE_CONFIG), device=cuda0)
            two = DecodeEngine(params, cfg, decode=DecodeConfig(**SERVE_CONFIG), group=group)
            try:
                for tp, eng in ((1, one), (2, two)):
                    ms, launches, tables, positions = step_probe(eng)
                    rec[f"tp{tp}"].update(decode_step_ms_median=float(np.median(ms)),
                                          decode_step_ms_runs=ms, launches_per_decode_step=launches)
                layout = default_layout()
                sharded = [n for n, v in params.items()
                           if any(a is not None for a in
                                  layout.param_spec(n, tuple(v.shape), group.mesh))]
                w1 = sum(nbytes(params[n]) for n in sharded)
                w2 = [sum(nbytes(mp[n]) for n in sharded) for mp in two._model.members]
                p1 = nbytes(one._k_pages) + nbytes(one._v_pages)
                p2 = [nbytes(k) + nbytes(v) for k, v in zip(two._k_pages, two._v_pages)]
                with torch.no_grad(), ieee_f32():
                    xs = two._model.run(two._dev(traffic["step_tokens"])[:, None],
                                        two._dev(positions)[:, None], two._dev(tables),
                                        two._k_pages, two._v_pages)
                    torch.cuda.synchronize()
                rec.update(sharded_weight_bytes={"tp1": w1, "tp2_members": w2},
                           page_bytes={"tp1": p1, "tp2_members": p2},
                           sharded_params=len(sharded))
                checks.update({
                    f"{name}_member_weight_bytes_half": all(2 * w == w1 for w in w2),
                    f"{name}_member_page_bytes_half": all(2 * p == p1 for p in p2),
                    f"{name}_replicated_hidden_bit_equal": all(torch.equal(xs[0], x)
                                                               for x in xs[1:]),
                    # so that the bit-equality tests the step: each member
                    # computes on its own copies, on one card as on two
                    f"{name}_members_hold_own_copies": all(
                        two._model.members[0][n].data_ptr() != two._model.members[1][n].data_ptr()
                        for n in params if n not in sharded),
                })
            finally:
                one.close(timeout=SERVE_WAIT_S)
                two.close(timeout=SERVE_WAIT_S)
            one.kv.assert_no_leaks()
            two.kv.assert_no_leaks()
        return outs1, r2, rec

    # (a) a tp=2 group, both members on cuda:0, against tp=1
    outs_ref, r2, rec = tp_pair(params, cfg, [cuda0, cuda0], "a", probe=True)
    paths["group"] = r2["launches"]
    ref_toks = [o.tokens for o in outs_ref]
    generated = rec["generated_tokens"]
    emit({"phase": "group", "part": "a_tp2_one_card", "part_s": lap(), "model": "transformer_lm",
          "params": sum(p.numel() for p in params.values()), "config": SERVE_CONFIG,
          "dtype": "float32", "requests": len(reqs), "members": ["cuda:0", "cuda:0"], **rec,
          "tie_tol": SERVE_TIE_TOL, "card": smi})

    # (b) grouped-query variants: the pages split (two kv heads), and whole
    # (one kv head: k/v gathered on each member)
    for name, over in GROUP_VARIANTS.items():
        vparams, vcfg = lm(**over)
        _, _, vrec = tp_pair(vparams, vcfg, [cuda0, cuda0], f"b_{name}")
        emit({"phase": "group", "part": f"b_{name}", "part_s": lap(), "overrides": over,
              **vrec, "card": smi})
        del vparams
        torch.cuda.empty_cache()

    # (c) speculative decoding under a group, the target as its own draft
    sreqs = reqs[:GROUP_SPEC_REQUESTS]
    group = make_groups(2, devices=[cuda0, cuda0])[0]
    outs_c, c = serve_burst(params, cfg, sreqs, dict(SERVE_CONFIG, spec_tokens=GROUP_SPEC_TOKENS),
                            draft_variables=params, group=group)
    ok_c, gaps_c = held_against(params, cfg, prompts, ref_toks[:len(sreqs)],
                                [o.tokens for o in outs_c])
    checks.update({
        "c_tokens_equal_tp1_or_near_tie": ok_c,
        "c_verify_step_one_shape": c["step_sizes"][2] == 1,
        "c_no_leaks": not c["unjoined"],
        "c_no_step_faults": not any(c["faults"].values()),
        "c_flash_launches_0": flash0(c["launches"]),
    })
    emit({"phase": "group", "part": "c_speculative", "part_s": lap(), "requests": len(sreqs),
          "spec_tokens": GROUP_SPEC_TOKENS, "acceptance_rate": c["spec_accept_rate"],
          "verify_steps": c["metrics"]["verify_steps_total"], "wall_s": c["wall_s"],
          "first_differences": firsts(gaps_c), "card": smi})

    # (d) a fleet of two groups (four members on the card): a member fault
    # ejects its whole group, then the group is re-admitted; a stall on one
    # member is localized
    zero_kernel_counts()
    fleet = DecodeFleet.from_groups(params, cfg, make_groups(2, devices=[cuda0] * 4),
                                    decode=DecodeConfig(**SERVE_CONFIG, group_probe_every_s=0.0))
    ga, gb = fleet.engines
    d = {}
    try:
        handles = [ga.submit(p, n) for p, n in reqs]  # pinned to group 0
        deadline = time.monotonic() + SERVE_WAIT_S
        while ga.metrics.snapshot()["tokens_total"] < GROUP_FAULT_TOKENS:
            if time.monotonic() > deadline:
                raise TimeoutError("group (d): group 0 never generated its tokens")
            time.sleep(0.001)
        t0 = time.perf_counter()
        with faults.injected(faults.FaultSpec(
                faults.GROUP_MEMBER, "error", match={"engine": ga.metrics.engine_label,
                                                     "shard": 1})) as plan:
            outs_d = [h.result(timeout=SERVE_WAIT_S) for h in handles]
            fired = plan.all_fired()
        d["burst_after_fault_s"] = time.perf_counter() - t0
        state = ga.breaker.state
        sa, sb = ga.metrics.snapshot(), gb.metrics.snapshot()
        ok_d, gaps_d = held_against(params, cfg, prompts, ref_toks, [o.tokens for o in outs_d])
        shortest = min(range(len(reqs)), key=lambda i: len(prompts[i]) + reqs[i][1])
        t0 = time.perf_counter()
        probes = 0
        deadline = time.monotonic() + 120
        while ga.breaker.state != CLOSED and time.monotonic() < deadline:
            out = fleet.submit(*reqs[shortest]).result(timeout=SERVE_WAIT_S)
            probes += 1
            ok_d = ok_d and held_against(params, cfg, [prompts[shortest]], [ref_toks[shortest]],
                                         [out.tokens])[0]
            time.sleep(0.02)
        d.update(readmit_s=time.perf_counter() - t0, readmit_requests=probes,
                 migrated=sa["migrated_total"], member_faults=sa["group_member_faults_total"],
                 first_differences=firsts(gaps_d))
        readmitted = ga.breaker.state == CLOSED
        # the stall: the watch names the flagged shard in the run log
        work = tempfile.mkdtemp(prefix="chip_smoke_group_")
        slog = runlog.RunLog(os.path.join(work, "group.runlog"))
        prev_log = runlog.set_runlog(slog)
        flagged = []
        try:
            with faults.injected(faults.FaultSpec(
                    faults.GROUP_MEMBER, "stall", stall_s=GROUP_STALL_S, times=10 ** 9,
                    match={"engine": ga.metrics.engine_label, "shard": 1})):
                deadline = time.monotonic() + 60
                while 1 not in flagged and time.monotonic() < deadline:
                    time.sleep(0.01)
                    flagged = [r["shard"] for r in runlog.read_runlog(slog.path)
                               if r["kind"] == "group_shard_straggler"
                               and r.get("engine") == ga.metrics.engine_label]
        finally:
            runlog.set_runlog(prev_log)
            slog.close()
            shutil.rmtree(work, ignore_errors=True)
        skew = obs_metrics.default_registry().get(
            "serving.group.shard_skew", labels={"engine": ga.metrics.engine_label})
    finally:
        fleet.close(timeout=SERVE_WAIT_S)
    paths["group_fleet"] = kernel_launch_counts()
    d.update(straggler_skew=skew, flagged_shards=flagged)
    checks.update({
        "d_member_fault_fired": fired,
        "d_group_ejected": state == OPEN and sa["group_member_faults_total"] >= 1,
        "d_requests_migrated": sa["migrated_total"] > 0,
        "d_no_request_lost": [len(o.tokens) for o in outs_d] == [n for _, n in reqs],
        "d_tokens_equal_tp1_or_near_tie": ok_d,
        "d_group_readmitted": readmitted,
        "d_stall_flagged_at_shard_1": 1 in flagged,
        "d_no_step_faults": not any(s[k] for s in (sa, sb) for k in SERVE_FAULT_COUNTERS),
        "d_flash_launches_0": flash0(paths["group_fleet"]),
    })
    for e in fleet.engines:
        e.kv.assert_no_leaks()
    emit({"phase": "group", "part": "d_from_groups", "part_s": lap(), "groups": 2,
          "members_on_card": 4, "fault_after_tokens": GROUP_FAULT_TOKENS,
          "stall_s": GROUP_STALL_S, **d, "card": smi})

    # (e) disaggregated prefill/decode across groups, device transport
    hreqs = reqs[:GROUP_HANDOFF_REQUESTS]
    zero_kernel_counts()
    e = {}
    for name, dec_group in (("tp2_to_tp2", True), ("tp2_to_tp1", False)):
        g0, g1 = make_groups(2, devices=[cuda0] * 4)
        pre = DecodeEngine(params, cfg, config=ServingConfig(engine_label=f"group-pre-{name}"),
                           decode=DecodeConfig(**SERVE_CONFIG), group=g0)
        dec = DecodeEngine(params, cfg, config=ServingConfig(engine_label=f"group-dec-{name}"),
                           decode=DecodeConfig(**SERVE_CONFIG), group=g1 if dec_group else None,
                           device=None if dec_group else cuda0)
        router = DisaggRouter([pre, dec], [PREFILL, DECODE], transport="device")
        try:
            t0 = time.perf_counter()
            outs = [h.result(timeout=SERVE_WAIT_S) for h in [router.submit(p, n) for p, n in hreqs]]
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            sd = dec.metrics.snapshot()
            clean = not any(en.metrics.snapshot()[k] for en in (pre, dec)
                            for k in SERVE_FAULT_COUNTERS)
        finally:
            router.close(timeout=SERVE_WAIT_S)
        pre.kv.assert_no_leaks()
        dec.kv.assert_no_leaks()
        ok, gaps = held_against(params, cfg, prompts, ref_toks[:len(hreqs)], [o.tokens for o in outs])
        e[name] = {"wall_s": wall, "handoffs_in": sd["handoffs_in_total"],
                   "recovered": sd["recovered_total"], "first_differences": firsts(gaps)}
        adopted = sd["handoffs_in_total"] == len(hreqs) and sd["recovered_total"] == 0
        reprefilled = sd["handoffs_in_total"] == 0 and sd["recovered_total"] == len(hreqs)
        checks.update({
            f"e_{name}_tokens_equal_tp1_or_near_tie": ok,
            f"e_{name}_{'adopted' if dec_group else 'reprefilled'}": adopted if dec_group
            else reprefilled,
            f"e_{name}_no_step_faults": clean,
        })
    paths["group_disagg"] = kernel_launch_counts()
    checks["e_flash_launches_0"] = flash0(paths["group_disagg"])
    emit({"phase": "group", "part": "e_disagg_device", "part_s": lap(), "requests": len(hreqs),
          **e, "card": smi})

    # (f) the members on two cards, where there are two
    if torch.cuda.device_count() >= 2:
        _, _, frec = tp_pair(params, cfg, [cuda0, torch.device("cuda", 1)], "f")
        emit({"phase": "group", "part": "f_two_cards", "part_s": lap(),
              "members": ["cuda:0", "cuda:1"], **frec, "card": smi})
    else:
        print("chip_smoke: group (f) did not run: one card visible, its two members need two",
              flush=True)
    emit({"phase": "group", "seconds": marks[-1] - marks[0], "checks": checks})
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
      out (self- and cross-attention's): their gradient is zero in exact
      arithmetic (a constant added to all of a row's scores cancels in the
      softmax), so Adam moves them by ~lr in the direction of rounding noise
      in either run.
    Returns {metric: (worst value, its parameter, the median value)}."""
    import numpy as np

    def worst(rel):
        k = max(rel, key=rel.get)
        return rel[k], k, float(np.median(list(rel.values())))

    def norm(t):
        return float(t.float().norm())

    kbias = [k for k in ref["params"] if k.endswith("attn/k/b")]
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


def profile_markers():
    """PROFILER_MARKERS spin kernels, run to their end: the first and the
    last device work of a profiled run whose records are counted."""
    import torch

    torch.cuda.synchronize()
    for _ in range(PROFILER_MARKERS):
        torch.cuda._sleep(PROFILER_MARKER_CYCLES)
    torch.cuda.synchronize()


def _records(prof) -> list:
    """The names of the device activities (kernels, copies, fills) a
    torch.profiler run recorded, from its raw events, in the order they
    started."""
    return [n for _, n in sorted(
        (e.start_ns(), e.name()) for e in prof.profiler.kineto_results.events()
        if "CUDA" in str(e.device_type()) and not e.is_user_annotation())]


def device_records(prof) -> list:
    """_records bar the markers of profile_markers."""
    return [n for n in _records(prof) if "spin_kernel" not in n]


def markers_kept(prof) -> tuple:
    """How many of profile_markers' spin kernels the run kept before its
    first counted record and after its last."""
    is_marker = ["spin_kernel" in n for n in _records(prof)]
    first = is_marker.index(False) if False in is_marker else len(is_marker)
    last = is_marker[::-1].index(False) if False in is_marker else 0
    return first, last


def profile_intact(prof) -> bool:
    """Whether the run kept markers on both sides of its counted records, so
    that no record of the work fell outside the session."""
    return min(markers_kept(prof)) > 0


class LogLines:
    """The warnings the port's logger emits while entered (warn_once's
    dedup set cleared on entry, so each finding shows again)."""

    def __enter__(self):
        import logging

        from paddle_tpu_torch.core import logging as ptlog

        class Handler(logging.Handler):
            def emit(handler, record):
                self.lines.append(record.getMessage())

        self.lines, self._handler = [], Handler(logging.WARNING)
        ptlog.reset_warn_once()
        ptlog.get_logger().addHandler(self._handler)
        return self

    def __exit__(self, *exc):
        from paddle_tpu_torch.core import logging as ptlog

        ptlog.get_logger().removeHandler(self._handler)

    def lint(self) -> list:
        """The model lint's lines: its findings, or that it was skipped."""
        return [ln for ln in self.lines if "model lint" in ln]


def records_diff(a: list, b: list) -> dict:
    """Which device records (names) one run kept and the other did not: the
    counts each side lacks, at most 8 names a side, and whether the shorter
    list is the longer one with its first or last records gone."""
    import collections

    short, long_ = sorted((a, b), key=len)
    k = len(long_) - len(short)
    place = ("none" if short == long_ else "start" if k and short == long_[k:]
             else "end" if k and short == long_[:len(short)] else "elsewhere")
    return {"a_lacks": dict((collections.Counter(b) - collections.Counter(a)).most_common(8)),
            "b_lacks": dict((collections.Counter(a) - collections.Counter(b)).most_common(8)),
            "shorter_lacks_at": place}


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
                profile_markers()
            if log_dir is not None:
                with prof.profiler(log_dir):
                    profile_markers()
                    t.train(num_epochs=1, event_handler=handler,
                            reader=lambda: iter(batches[:steps]))
                    profile_markers()
            else:
                t.train(num_epochs=1, event_handler=handler, reader=lambda: iter(batches[:steps]))
            torch.cuda.synchronize()
            if p is not None:
                profile_markers()
                p.__exit__(None, None, None)
                out["device_names"] = device_records(p)
                out["device_events"] = len(out["device_names"])
                out["markers_kept"] = markers_kept(p)
                out["intact"] = profile_intact(p)
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
                prof_on["device_events"] == prof_off["device_events"] > 0
                and prof_on["intact"] and prof_off["intact"],
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
          "profiler_markers_kept_before_after": {
              "on": prof_on["markers_kept"], "off": prof_off["markers_kept"], "of": PROFILER_MARKERS},
          "device_records_off_vs_on": records_diff(prof_off["device_names"], prof_on["device_names"]),
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
    """||a - b|| / ||b|| over float32 copies (a reference of norm below 1e-6
    divides by 1e-6: an all-zero gradient compares by its absolute error)."""
    a, b = a.float(), b.float()
    return float((a - b).norm()) / max(float(b.norm()), 1e-6)


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
        with LogLines() as log_a:
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
            "a_model_lint_ran_clean": log_a.lint() == [] and engine.lint_findings == [],
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
              "logits_tol": INFER_LOGITS_TOL, "peak_memory_bytes": peak_a,
              "model_lint_log": log_a.lint(), "checks": a_checks})
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
        with LogLines() as log_b:
            engine = ServingEngine(rnet, folded, [FeedSpec("image", (side, side, 3), "float32")],
                                   config=ServingConfig(max_batch_size=INFER_RESNET_SERVE_MAX,
                                                        num_replicas=1,
                                                        engine_label="infer_resnet"))
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
            "b_model_lint_ran": not any("model lint skipped" in ln for ln in log_b.lint())
            and engine.lint_findings is not None,
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
              "served_rel_l2_vs_direct": served_err, "model_lint_log": log_b.lint(),
              "model_lint_findings": [[d.code, d.where] for d in engine.lint_findings or ()],
              "checks": b_checks})
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
        # the run between profile_markers: the session's first device records
        # are dropped by this point of the process (PROFILER_MARKERS)
        with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof_c:
            profile_markers()
            got = run(ids)
            torch.cuda.synchronize()
            profile_markers()
        paths["infer_export"] = kernel_launch_counts()
        names = [e.name for e in prof_c.events()]
        c_kernels = device_records(prof_c)
        c_checks = {
            "c_loaded_logits_bit_equal_eager": bool(torch.equal(got, eager)),
            "c_loaded_program_flash_launches_eq_n_layers":
                paths["infer_export"]["flash_fwd"] == n_layers,
            "c_graph_holds_the_flash_operator": graph_ops.count(
                torch.ops.paddle_tpu_torch.flash_fwd.default) == n_layers,
            "c_no_library_attention": not any("scaled_dot_product" in n for n in names),
            "c_profile_intact": profile_intact(prof_c),
            "c_profiler_sees_the_kernel": sum("flash_fwd_bf16_kernel" in n for n in c_kernels)
            == n_layers,
        }
        checks.update(c_checks)
        emit({"phase": "infer", "part": "c_export_round_trip", "card": smi,
              "shape": list(INFER_EXPORT_SHAPE), "save_s": save_s, "load_s": load_s,
              "program_bytes": os.path.getsize(os.path.join(d, "program.pt2")),
              "launches": paths["infer_export"],
              "profiler_markers_kept_before_after": markers_kept(prof_c),
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


def analysis_phase(smi: str):
    """Phase 13b: the analysis slice on the card — the model lint of the LM
    at BASE_CFG on the meta device (no device bytes, no launch), a
    ServingEngine that lints before warm-up against one that does not, and
    the analysis CLI over the package. Returns the kernel launches of its
    paths and the checks."""
    import contextlib
    import io as io_mod

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile as tprofile

    from paddle_tpu_torch import framework
    from paddle_tpu_torch.analysis import has_errors, lint_model
    from paddle_tpu_torch.analysis.__main__ import main as analysis_main
    from paddle_tpu_torch.core.config import set_flags
    from paddle_tpu_torch.models import get_model, transformer_lm
    from paddle_tpu_torch.reader.feeder import FeedSpec
    from paddle_tpu_torch.serving import ServingConfig, ServingEngine

    checks, paths = {}, {}
    set_flags(use_flash_attention=True, use_bf16_compute=True, check_nan_inf=False)
    spec = get_model("transformer_lm")  # BASE_CFG, on CUDA
    cfg = spec.extra["cfg"]
    n_layers = cfg["n_layers"]
    rng = np.random.RandomState(1)
    variables = spec.model.init(0, *spec.synth_batch(1, rng))
    batch = spec.synth_batch(ANALYSIS_LINT_BATCH, rng)

    # (a) the lint on meta: nothing on the card moves
    torch.cuda.synchronize()
    zero_kernel_counts()
    bytes0 = torch.cuda.memory_allocated()
    with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof_a:
        profile_markers()
        t0 = time.perf_counter()
        found = {mode: lint_model(spec.model, batch, variables=variables, train=mode == "train")
                 for mode in ("eval", "train")}
        lint_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        bytes1 = torch.cuda.memory_allocated()
        closing = torch.full((1,), 7.0, device="cuda")  # a fill closes the window
        torch.cuda.synchronize()
    paths["analysis_lint"] = kernel_launch_counts()
    del closing
    records = _records(prof_a)
    spins = [i for i, n in enumerate(records) if "spin_kernel" in n]
    window = records[spins[-1] + 1:] if spins else records
    a_checks = {
        "a_no_error_finding": not any(has_errors(d) for d in found.values()),
        "a_device_bytes_unchanged": bytes1 == bytes0,
        "a_no_kernel_launch_counted": not any(paths["analysis_lint"].values()),
        "a_window_opened_and_closed": bool(spins) and len(window) >= 1
        and "fill" in window[-1].lower(),
        "a_no_device_record_in_window": len(window) == 1,
    }
    checks.update(a_checks)
    emit({"phase": "analysis", "part": "a_model_lint_on_meta", "card": smi,
          "batch": ANALYSIS_LINT_BATCH, "seq_len": spec.extra["seq_len"],
          "findings": {m: [str(d) for d in ds] for m, ds in found.items()},
          "lint_s_eval_and_train": lint_s, "device_bytes_before": bytes0,
          "device_bytes_after": bytes1, "launches": paths["analysis_lint"],
          "device_records_in_window": window[:-1], "checks": a_checks})

    # (b) serving after the lint, against an engine without it
    net = framework.build(
        lambda tokens: transformer_lm.lm_forward(tokens, tokens, cfg=cfg)[2],
        name="transformer_lm_logits")
    lengths = rng.randint(ANALYSIS_PROMPT_LENS[0], ANALYSIS_PROMPT_LENS[1] + 1,
                          size=ANALYSIS_REQUESTS)
    prompts = [rng.randint(1, cfg["vocab"], size=(1, n)).astype(np.int32) for n in lengths]
    runs = {}
    for lint in (True, False):
        zero_kernel_counts()
        t0 = time.perf_counter()
        with LogLines() as log:
            engine = ServingEngine(
                net, variables, [FeedSpec("tokens", (None,), "int32")],
                config=ServingConfig(max_batch_size=INFER_MAX_BATCH, num_replicas=1,
                                     length_buckets=INFER_LENGTH_BUCKETS, lint_model=lint,
                                     engine_label=f"analysis_lint_{lint}"))
        init_s = time.perf_counter() - t0
        warm = kernel_launch_counts()
        try:
            zero_kernel_counts()
            outs = [engine.submit({"tokens": p}).result(timeout=INFER_WAIT_S) for p in prompts]
            torch.cuda.synchronize()
            served = kernel_launch_counts()
            snap = engine.metrics.snapshot()
        finally:
            unjoined = engine.close(timeout=INFER_WAIT_S)
        runs[lint] = {"outs": outs, "init_s": init_s, "warm": warm, "served": served,
                      "log": log.lint(), "findings": engine.lint_findings,
                      "batches": snap["batches_total"],
                      "errors": snap["errors_total"], "unjoined": unjoined}
    paths["analysis_serve"] = runs[True]["served"]
    on, off = runs[True], runs[False]
    b_checks = {
        "b_no_model_lint_skipped": not any("skipped" in ln for ln in on["log"]),
        "b_lint_found_nothing": on["log"] == [],
        "b_lint_ran_only_when_on": on["findings"] == [] and off["findings"] is None,
        "b_logits_bit_equal_lint_on_off": all(torch.equal(a, b)
                                              for a, b in zip(on["outs"], off["outs"])),
        "b_flash_launches_per_request_eq_n_layers":
            on["served"]["flash_fwd"] == n_layers * ANALYSIS_REQUESTS == on["batches"] * n_layers,
        "b_warmup_launches_alike": on["warm"] == off["warm"],
        "b_no_error": on["errors"] == off["errors"] == 0 and on["unjoined"] == off["unjoined"] == [],
    }
    checks.update(b_checks)
    emit({"phase": "analysis", "part": "b_serving_after_the_lint", "card": smi,
          "requests": ANALYSIS_REQUESTS, "prompt_lens": [int(n) for n in lengths],
          "engine_init_s": {"lint": on["init_s"], "no_lint": off["init_s"]},
          "warmup_launches": {"lint": on["warm"], "no_lint": off["warm"]},
          "launches": on["served"], "model_lint_log": on["log"], "checks": b_checks})
    del runs, on, off

    # (c) the CLI over the package, in process
    out = io_mod.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = analysis_main([])
    cli_s = time.perf_counter() - t0
    c_checks = {"c_cli_exit_0": rc == 0}
    checks.update(c_checks)
    emit({"phase": "analysis", "part": "c_cli", "card": smi, "exit_code": rc,
          "seconds": cli_s, "summary": out.getvalue().strip().splitlines()[-1:],
          "checks": c_checks})
    return paths, checks


def router_calls() -> list:
    """The calls of the MoE routers (``parallel.moe._ROUTERS``, looked up at
    each call) from here on, each ``(token routes its dispatch keeps, its
    aux loss)``: the tokens a router drops are the routed ones minus the
    kept. Inside a data-parallel step the kept routes are summed over the
    step's token blocks (the whole batch's). The routers are wrapped once a
    process; the caller clears the list."""
    from paddle_tpu_torch.parallel import context as dp_context
    from paddle_tpu_torch.parallel import moe

    calls = getattr(router_calls, "calls", None)
    if calls is None:
        calls = router_calls.calls = []

        def wrap(fn):
            def gate(logits, capacity, token_mask=None, rows=None):
                dispatch, combine, aux = fn(logits, capacity, token_mask=token_mask, rows=rows)
                calls.append((int(dp_context.global_sum(dispatch.sum())), float(aux.detach())))
                return dispatch, combine, aux

            return gate

        for name, (fn, routes) in list(moe._ROUTERS.items()):
            moe._ROUTERS[name] = (wrap(fn), routes)
    return calls


def sp_spec(part: str, mesh=None):
    """The LM of a phase sp part (with its sequence-parallel mode over
    ``mesh`` when given)."""
    from paddle_tpu_torch.models import get_model

    seq_len, _, _, mode, overrides = SP_PARTS[part][:5]
    kw = {f"{mode}_mesh": mesh} if (mode and mesh is not None) else {}
    return get_model("transformer_lm", seq_len=seq_len, **kw, **overrides)


def sp_run(part: str, step, batch, counts=None):
    """The part's held and timed steps of ``step`` from the part's seeded
    init (``counts``: (held, timed), by default the sp part's): the losses,
    the first step's launches of each kernel and router calls, the step ms
    (the steps after the first), the peak memory, and the state after the
    held steps."""
    import torch

    from paddle_tpu_torch.ops.cuda import build as kbuild

    held, timed = counts or SP_PARTS[part][5:7]
    calls = router_calls()
    v, o, losses, ms = step["v"], step["o"], [], []
    end = (v, o)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for i in range(held + timed):
        for kern in kbuild.KERNELS.values():
            kern.launches = 0
        calls.clear()
        t0 = time.perf_counter()
        r = step["fn"](v, o, *batch)
        v, o = r.variables, r.opt_state
        losses.append(float(r.loss))
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0))
        if i == 0:
            launches = {n: k.launches for n, k in kbuild.KERNELS.items()}
            routers = list(calls)
        if i + 1 == held:
            end = (v, o)
    return {"losses": losses, "launches_first_step": launches, "routers": routers,
            "step_ms": min(ms[1:] or ms), "step_ms_runs": ms,
            "peak_memory_bytes": torch.cuda.max_memory_allocated()}, end[0], end[1]


def sp_reference(part: str, work: str):
    """The one-rank run a phase sp part is held against: its steps of
    minimize's step on the whole batch from the seeded init; its state goes
    to ``work/<part>.pt`` as phase dp's reference does."""
    import numpy as np
    import torch

    from paddle_tpu_torch.core.config import set_flags

    set_flags(use_flash_attention=True, use_bf16_compute=True, check_nan_inf=True)
    seq_len, batch_size = SP_PARTS[part][:2]
    spec = sp_spec(part)
    batch = spec.synth_batch(batch_size, np.random.RandomState(0))
    v0 = spec.model.init(0, *batch)
    opt = spec.optimizer()
    res, v, o = sp_run(part, {"fn": opt.minimize(spec.model), "v": v0,
                              "o": opt.create_state(v0.params)}, batch)
    os.makedirs(work, exist_ok=True)
    torch.save({"params": v.params, "moment1": o.slots["moment1"]},
               os.path.join(work, f"{part}.pt"))
    res["tokens_per_s"] = batch_size * seq_len / (res["step_ms"] / 1e3)
    del v, o, v0, batch
    torch.cuda.empty_cache()
    return res


def sp_rank(rank, work, part):
    """One rank of phase sp: the part's DataParallel steps on its mesh (a
    sequence-sharded batch for the ring and Ulysses, the whole batch and
    half the experts for MoE), held against the one-rank run in
    ``work/<part>.pt``; the routes its exchanges took."""
    import numpy as np
    import torch

    from paddle_tpu_torch.core.config import set_flags
    from paddle_tpu_torch.parallel import DataParallel, P, collective, make_mesh

    set_flags(use_flash_attention=True, use_bf16_compute=True, check_nan_inf=True)
    seq_len, batch_size, axis, mode = SP_PARTS[part][:4]
    mesh = make_mesh(data=1, **{axis: torch.distributed.get_world_size()})
    spec = sp_spec(part, mesh)
    batch = spec.synth_batch(batch_size, np.random.RandomState(0))
    v0 = spec.model.init(0, *batch)
    specs = [P("data", "seq")] * 2 if mode else None
    dp = DataParallel(spec.model, spec.optimizer(), mesh=mesh, batch_specs=specs)
    v, o = dp.init(0, *batch, variables=v0)
    local = dp.put_batch(*batch)
    collective.reset_routes()
    res, v, o = sp_run(part, {"fn": dp.step, "v": v, "o": o}, local)
    res["routes"] = collective.routes_taken()
    res["tokens_per_s"] = batch_size * seq_len / (res["step_ms"] / 1e3)
    res["local_batch"] = list(local[0].shape)
    ref = torch.load(os.path.join(work, f"{part}.pt"), map_location=torch.device("cuda"))
    fv, fo = dp.full_state(v, o)
    if SP_PARTS[part][5]:  # held steps
        res["agreement"] = dp_agreement(fv.params, fo.slots["moment1"], ref, v0.params)
    res["local_w_in_experts"] = next((int(t.shape[0]) for k, t in v.params.items()
                                      if k.endswith("moe_ffn/w_in")), None)
    del dp, v, o, fv, fo, ref, v0, batch, local
    torch.cuda.empty_cache()
    return res


def sp_ranks(rank, work):
    """One rank of phase sp: every part in turn (one spawn for the phase),
    each with its seconds."""
    out = {}
    for part in SP_PARTS:
        t0 = time.perf_counter()
        out[part] = sp_rank(rank, work, part)
        out[part]["seconds"] = time.perf_counter() - t0
    return out


def sp_ring_block_math():
    """Phase sp (e): the ring's block math for two ranks in one process at
    SP_RING_SHAPE, f32 and bf16: the merged forward and the block-backward
    ring (``ops/ring_attention.py``'s steps, through the kernels at their
    offsets) against the single-device kernels (``flash_attention``) and a
    float64 reference; rel L2 of out, dq, dk, dv. Returns its numbers and
    checks."""
    import torch

    from paddle_tpu_torch.ops.cuda.flash_attention import (
        flash_attention,
        flash_attention_bwd_block,
        flash_attention_with_lse,
    )
    from paddle_tpu_torch.ops.ring_attention import _merge_normalized

    B, H, T, d = SP_RING_SHAPE
    n, tl = 2, SP_RING_SHAPE[2] // 2
    gen = torch.Generator(device="cuda").manual_seed(0)
    base = [torch.randn(B, H, T, d, device="cuda", generator=gen) for _ in range(4)]

    def rel(a, b):
        return float((a.double() - b.double()).norm() / b.double().norm())

    def blk(t, r):
        return t[:, :, r * tl:(r + 1) * tl].contiguous()

    out, checks = {}, {}
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v, g = (t.to(dtype).contiguous() for t in base)
        q64, k64, v64 = (t.double().requires_grad_(True) for t in (q, k, v))
        s = torch.einsum("bhqd,bhkd->bhqk", q64, k64) / d ** 0.5
        s = s.masked_fill(torch.ones(T, T, device="cuda", dtype=torch.bool).triu(1), -torch.inf)
        o64 = torch.softmax(s, -1) @ v64
        ref = [o64.detach(), *torch.autograd.grad(o64, (q64, k64, v64), g.double())]
        del s, o64, q64, k64, v64
        qs, ks, vs = (t.clone().requires_grad_(True) for t in (q, k, v))
        o1 = flash_attention(qs, ks, vs, causal=True)
        single = [o1.detach(), *torch.autograd.grad(o1, (qs, ks, vs), g)]
        outs, lses = [], []
        for r in range(n):  # rank r: its diagonal block, then the live earlier ones
            o, lse = flash_attention_with_lse(blk(q, r), blk(k, r), blk(v, r), causal=True,
                                              q_off=r * tl, k_off=r * tl)
            o = o.float()
            for j in range(r):
                bo, blse = flash_attention_with_lse(blk(q, r), blk(k, j), blk(v, j), causal=True,
                                                    q_off=r * tl, k_off=j * tl)
                o, lse = _merge_normalized(o, lse, bo.float(), blse)
            outs.append(o.to(dtype).float())
            lses.append(lse)
        dq = [torch.zeros(B, H, tl, d, device="cuda") for _ in range(n)]
        dk = [torch.zeros_like(t) for t in dq]
        dv = [torch.zeros_like(t) for t in dq]
        for r in range(n):
            for j in range(r + 1):
                a, b, c = flash_attention_bwd_block(
                    blk(q, r), blk(k, j), blk(v, j), outs[r], lses[r], blk(g, r), causal=True,
                    q_off=r * tl, k_off=j * tl)
                dq[r] += a.float()
                dk[j] += b.float()
                dv[j] += c.float()
        ring = [torch.cat(t, 2) for t in (outs, dq, dk, dv)]
        name = "f32" if dtype == torch.float32 else "bf16"
        res = out[name] = {
            "ring_vs_float64": [rel(a, b) for a, b in zip(ring, ref)],
            "single_vs_float64": [rel(a, b) for a, b in zip(single, ref)],
            "ring_vs_single": [rel(a, b) for a, b in zip(ring, single)]}
        if name == "f32":
            checks["e_ring_f32_within_tol_of_float64"] = max(res["ring_vs_float64"]) <= \
                SP_RING_F32_TOL
        else:
            checks["e_ring_bf16_as_close_to_float64_as_single"] = all(
                a <= SP_RING_BF16_RATIO * b
                for a, b in zip(res["ring_vs_float64"], res["single_vs_float64"]))
        del ring, single, ref, outs, dq, dk, dv
    torch.cuda.empty_cache()
    return out, checks


def sp_phase(smi: str, ranks: int = 2, device: str = "cuda:0", backend="gloo"):
    """Phase 14: sequence and expert parallelism, by default on two gloo
    ranks sharing the card (``tools/torch_sp_nccl.py``: one rank per card
    over NCCL). Returns its kernel launches by path and its checks."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from paddle_tpu_torch.parallel import launch

    checks, paths = {}, {}
    work = tempfile.mkdtemp(prefix="chip_smoke_sp_")
    try:
        math, math_checks = sp_ring_block_math()
        checks.update(math_checks)
        emit({"phase": "sp", "part": "e_ring_block_math", "shape": list(SP_RING_SHAPE),
              "rel_l2_out_dq_dk_dv": math, "f32_tol": SP_RING_F32_TOL,
              "bf16_ratio": SP_RING_BF16_RATIO, "card": smi})
        t0 = time.perf_counter()
        refs = {}
        for part in SP_PARTS:
            t1 = time.perf_counter()
            refs[part] = sp_reference(part, work)
            refs[part]["seconds"] = time.perf_counter() - t1
        ref_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        by_rank = launch.spawn(sp_ranks, ranks, args=(work,), device=device, backend=backend)
        ranks_s = time.perf_counter() - t0
        route_want = "gloo_host" if backend == "gloo" else "nccl"
        for part, ref in refs.items():
            per_rank = [res[part] for res in by_rank]
            for r, res in enumerate(per_rank):
                paths[f"sp_{part}_rank{r}"] = res["launches_first_step"]
                checks[f"{part}_rank{r}_launches"] = all(
                    res["launches_first_step"][k] == sp_launches(part, r) for k in HOPPER_KERNELS)
                checks[f"{part}_rank{r}_finite"] = all(np.isfinite(res["losses"]))
                if part == "b_ring_long":
                    continue  # numbers only
                held = SP_PARTS[part][5]
                checks[f"{part}_rank{r}_losses_within_tol"] = all(
                    abs(x - y) <= TRAIN_LOSS_TOL
                    for x, y in zip(res["losses"][:held], ref["losses"][:held]))
                checks[f"{part}_rank{r}_moment1_within_tol"] = \
                    res["agreement"]["moment1"][0] <= TRAIN_GRAD_TOL
                checks[f"{part}_rank{r}_movement_within_tol"] = \
                    res["agreement"]["movement"][0] <= DP_MOVEMENT_TOL
            if part == "d_moe":
                n_layers = len(ref["routers"])
                for r, res in enumerate(per_rank):
                    checks[f"d_rank{r}_kept_tokens_equal"] = \
                        [k for k, _ in res["routers"]] == [k for k, _ in ref["routers"]]
                    checks[f"d_rank{r}_aux_within_tol"] = len(res["routers"]) == n_layers and all(
                        abs(a - b) <= TRAIN_LOSS_TOL
                        for (_, a), (_, b) in zip(res["routers"], ref["routers"]))
                    checks[f"d_rank{r}_its_experts"] = \
                        res["local_w_in_experts"] == SP_MOE["moe_experts"] // ranks
            else:
                route = "ppermute" if SP_PARTS[part][3] == "ring" else "all_to_all"
                for r, res in enumerate(per_rank):
                    checks[f"{part}_rank{r}_{route}_{route_want}"] = set(
                        res["routes"].get(route, {})) == {route_want}
            emit({"phase": "sp", "part": part, "seq_len": SP_PARTS[part][0],
                  "batch": SP_PARTS[part][1], "mesh": {"data": 1, SP_PARTS[part][2]: ranks},
                  "backend": backend, "one_rank": ref, "ranks": per_rank,
                  "loss_tol": TRAIN_LOSS_TOL, "moment1_tol": TRAIN_GRAD_TOL,
                  "movement_tol": DP_MOVEMENT_TOL, "card": smi,
                  "note": "ppermute and all_to_all go point to point: over NCCL with a card a "
                          "rank; with two gloo ranks sharing the card (route gloo_host), "
                          "staged through host memory"})
        emit({"phase": "sp", "ranks": ranks, "backend": backend, "one_rank_seconds": ref_s,
              "ranks_seconds": ranks_s, "checks": checks})
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return paths, checks


def mp_mesh(part: str, ranks: int):
    """The mesh of a phase mp part over ``ranks``: model=ranks,
    expert=ranks or data=ranks, the pipeline's pipe=2 beside data=ranks/2,
    or a composed part's own axes beside data=1."""
    from paddle_tpu_torch.parallel import make_mesh

    axis = MP_PARTS[part][3]
    if mp_composed(part):
        return make_mesh(data=1, **axis)
    if axis in ("model", "expert"):
        return make_mesh(data=1, **{axis: ranks})
    if axis == "data":
        return make_mesh(data=ranks)
    return make_mesh(data=ranks // 2, pipe=2)


def mp_spec(part: str, mesh=None):
    """The model of a phase mp part (with ``mesh`` as its pipe_mesh for the
    pipeline's parts, its ring or Ulysses mesh for the sequence-parallel
    ones)."""
    from paddle_tpu_torch.models import get_model

    name, seq_len, _, axis, overrides = MP_PARTS[part][:5]
    kw = dict(overrides)
    if mesh is not None and part in MP_SEQ_MODE:
        kw[f"{MP_SEQ_MODE[part]}_mesh"] = mesh
    elif mesh is not None and mesh.shape.get("pipe", 1) > 1:
        kw["pipe_mesh"] = mesh
    return get_model(name, seq_len=seq_len, **kw)


def exchange_timer():
    """A context that times the step's exchanges: every all-reduce,
    all-gather, broadcast and all-to-all through ``torch.distributed`` and
    every point-to-point permutation (``collective._permuted``, its host
    staging included), each between two synchronizations of the card so
    that queued kernels are not counted. Yields a dict whose ``ms`` and
    ``calls`` it fills."""
    import contextlib

    import torch
    import torch.distributed as dist

    from paddle_tpu_torch.parallel import collective

    @contextlib.contextmanager
    def run():
        got = {"ms": 0.0, "calls": 0}
        saved = []

        def timed(owner, attr):
            fn = getattr(owner, attr)
            saved.append((owner, attr, fn))

            def wrapper(*a, **k):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                try:
                    return fn(*a, **k)
                finally:
                    torch.cuda.synchronize()
                    got["ms"] += 1e3 * (time.perf_counter() - t0)
                    got["calls"] += 1

            setattr(owner, attr, wrapper)

        for attr in ("all_reduce", "all_gather", "broadcast", "all_to_all_single"):
            timed(dist, attr)
        timed(collective, "_permuted")
        try:
            yield got
        finally:
            for owner, attr, fn in reversed(saved):
                setattr(owner, attr, fn)

    return run()


def mp_runs(part: str):
    """The runs of a phase mp part: ``(compute, held steps, timed steps)``,
    bf16 held and timed, and for a model-axis part an f32 held step."""
    runs = [("bf16", MP_HELD, MP_TIMED)]
    return runs + [("f32", MP_HELD, 0)] if part in MP_F32_HELD else runs


def mp_reference(part: str, work: str, compute: str = "bf16", held: int = MP_HELD,
                 timed: int = MP_TIMED):
    """The one-rank run a phase mp part is held against: minimize's steps on
    the whole batch from the part's seeded init (the plain model: no mesh),
    in ``compute`` (bf16 or f32); its state goes to
    ``work/<part>_<compute>.pt``."""
    import numpy as np
    import torch

    from paddle_tpu_torch.core.config import set_flags

    set_flags(use_flash_attention=True, use_bf16_compute=compute == "bf16", check_nan_inf=True)
    _, seq_len, batch_size = MP_PARTS[part][:3]
    spec = mp_spec(part)
    batch = spec.synth_batch(batch_size, np.random.RandomState(0))
    v0 = spec.model.init(0, *batch)
    opt = spec.optimizer()
    res, v, o = sp_run(part, {"fn": opt.minimize(spec.model), "v": v0,
                              "o": opt.create_state(v0.params)}, batch, (held, timed))
    os.makedirs(work, exist_ok=True)
    state = {"params": v.params, "moment1": o.slots["moment1"]}
    torch.save(state, os.path.join(work, f"{part}_{compute}.pt"))
    if compute == "f32":  # bf16 rounding alone: the one-rank bf16 step against this
        b = torch.load(os.path.join(work, f"{part}_bf16.pt"), map_location=torch.device("cuda"))
        res["bf16_vs_f32"] = dp_agreement(b["params"], b["moment1"], state, v0.params)
        del b
    res["tokens_per_s"] = batch_size * seq_len / (res["step_ms"] / 1e3)
    del v, o, v0, batch, state
    torch.cuda.empty_cache()
    return res


def mp_rank(rank, work, part, compute="bf16", held=MP_HELD, timed=MP_TIMED):
    """One rank of phase mp: the part's DataParallel steps on its mesh (each
    rank its blocks over ``model`` or ``expert``, its stage over ``pipe``,
    its segment of each row over ``seq``) in ``compute``, held against the
    one-rank run in ``work/<part>_<compute>.pt``; the routes its exchanges
    took, their share of a step (one more step, timed with
    :func:`exchange_timer`) and the shapes of its blocks; under ZeRO-1 the
    held steps again without it, for the bit-equality."""
    import numpy as np
    import torch

    from paddle_tpu_torch.core.config import set_flags
    from paddle_tpu_torch.parallel import DataParallel, P, collective

    set_flags(use_flash_attention=True, use_bf16_compute=compute == "bf16", check_nan_inf=True)
    _, seq_len, batch_size = MP_PARTS[part][:3]
    mesh = mp_mesh(part, torch.distributed.get_world_size())
    spec = mp_spec(part, mesh)
    batch = spec.synth_batch(batch_size, np.random.RandomState(0))
    v0 = spec.model.init(0, *batch)
    if part in MP_STORED:  # every matrix's dim 0 stored over data
        for info in spec.model.param_info.values():
            if len(info.shape) >= 2:
                info.sharding = ("data",) + (None,) * (len(info.shape) - 1)
    specs = ([P("data", "seq")] * 2 if part in MP_SEQ_MODE else
             [P(MP_ROWS[part])] * 2 if part in MP_ROWS else None)

    def data_parallel(zero):
        return DataParallel(spec.model, spec.optimizer(), mesh=mesh, batch_outputs=(),
                            batch_specs=specs, zero_shard_optimizer=zero)

    dp = data_parallel(part in MP_ZERO)
    v, o = dp.init(0, *batch, variables=v0)
    local = dp.put_batch(*batch)
    collective.reset_routes()
    res, v, o = sp_run(part, {"fn": dp.step, "v": v, "o": o}, local, (held, timed))
    res["routes"] = collective.routes_taken()
    res["tokens_per_s"] = batch_size * seq_len / (res["step_ms"] / 1e3)
    res["mesh"] = dict(mesh.shape)
    res["local_batch"] = list(local[0].shape)
    if timed:  # one more step with its exchanges timed (synchronized around each)
        with exchange_timer() as ex:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            dp.step(v, o, *local)
            torch.cuda.synchronize()
        step_ms = 1e3 * (time.perf_counter() - t0)
        res["exchange"] = {"step_ms": step_ms, **ex, "share": ex["ms"] / step_ms}
    q = next((k for k in v.params if k.endswith("self_attn/q/w")), None)
    res["q_block"] = [list(v.params[q].shape), list(v0.params[q].shape)]
    res["local_experts"] = next((int(t.shape[0]) for k, t in v.params.items()
                                 if k.endswith("moe_ffn/w_in")), None)

    def nbytes(ts):
        return sum(t.numel() * t.element_size() for t in ts)

    # at rest: this rank's parameter and slot bytes, the whole model's, and
    # what its windows hold (a matrix stored over data: half its rows; under
    # ZeRO-1 a replicated parameter's slots split over data where it divides)
    n_data = mesh.shape["data"]
    res["bytes"] = {
        "params": nbytes(v.params.values()),
        "slots": nbytes(t for d in o.slots.values() for t in d.values()),
        "params_whole": nbytes(v0.params.values()),
        "slots_whole": 2 * sum(t.numel() * 4 for t in v0.params.values()),
        "params_windows": sum(t.numel() * t.element_size() // (
            n_data if part in MP_STORED and t.dim() >= 2 else 1) for t in v0.params.values()),
        "slots_windows": 2 * sum(t.numel() * 4 // (
            n_data if (part in MP_STORED and t.dim() >= 2) or (
                part in MP_ZERO and t.shape[0] % n_data == 0) else 1)
            for t in v0.params.values()),
    }
    ref = torch.load(os.path.join(work, f"{part}_{compute}.pt"),
                     map_location=torch.device("cuda"))
    fv, fo = dp.full_state(v, o)
    res["agreement"] = dp_agreement(fv.params, fo.slots["moment1"], ref, v0.params)
    if compute == "bf16" and part in MP_F32_HELD:  # against the one-rank f32 step
        del ref
        ref = torch.load(os.path.join(work, f"{part}_f32.pt"), map_location=torch.device("cuda"))
        res["agreement_f32"] = dp_agreement(fv.params, fo.slots["moment1"], ref, v0.params)
    if part in MP_ZERO:  # the held steps without ZeRO-1: the same parameters, bit for bit
        plain = data_parallel(False)
        pv, po = plain.init(0, *batch, variables=v0)
        plain_local = plain.put_batch(*batch)
        for _ in range(held):
            r = plain.step(pv, po, *plain_local)
            pv, po = r.variables, r.opt_state
        pfv, _ = plain.full_state(pv, po)
        res["zero_equals_plain"] = all(torch.equal(fv.params[k], pfv.params[k]) for k in pfv.params)
        res["slot_bytes"] = [sum(t.numel() * t.element_size() for d in st.slots.values()
                                 for t in d.values()) for st in (o, po)]
        del plain, pv, po, pfv, r, plain_local
    del dp, v, o, fv, fo, ref, v0, batch, local
    torch.cuda.empty_cache()
    return res


def mp_ranks(rank, work, parts):
    """One rank of phase mp: every run of each of ``parts`` in turn (one
    spawn for them), each with its seconds."""
    out = {}
    for part in parts:
        for run in mp_runs(part):
            t0 = time.perf_counter()
            out[(part, run[0])] = mp_rank(rank, work, part, *run)
            out[(part, run[0])]["seconds"] = time.perf_counter() - t0
    return out


def mp_phase(smi: str, ranks: int = 2, device: str = "cuda:0", backend="gloo"):
    """Phase 15: tensor and pipeline parallelism and the axes composed, by
    default on two gloo ranks sharing the card and four for the composed
    meshes (``tools/torch_sp_nccl.py``: one rank per card over NCCL, the
    composed meshes with four cards or more). Returns its kernel launches
    by path and its checks."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from paddle_tpu_torch.parallel import launch

    checks, paths = {}, {}
    work = tempfile.mkdtemp(prefix="chip_smoke_mp_")
    # one spawn of the phase's ranks, one of MP_COMPOSED_RANKS (one card a
    # rank over NCCL: only with that many cards)
    groups = [(ranks, [p for p in MP_PARTS if not mp_composed(p)])]
    if device != "cuda" or torch.cuda.device_count() >= MP_COMPOSED_RANKS:
        groups.append((MP_COMPOSED_RANKS, [p for p in MP_PARTS if mp_composed(p)]))
    try:
        t0 = time.perf_counter()
        refs = {}
        for _, parts in groups:
            for part in parts:
                for run in mp_runs(part):
                    t1 = time.perf_counter()
                    refs[(part, run[0])] = mp_reference(part, work, *run)
                    refs[(part, run[0])]["seconds"] = time.perf_counter() - t1
        ref_s = time.perf_counter() - t0
        by_rank, ranks_s = {}, {}
        for n, parts in groups:
            t0 = time.perf_counter()
            for rank, res in enumerate(launch.spawn(mp_ranks, n, args=(work, parts),
                                                    device=device, backend=backend)):
                for key, value in res.items():
                    by_rank.setdefault(key, []).append(value)
            ranks_s[n] = time.perf_counter() - t0
        route_want = "gloo_host" if backend == "gloo" else "nccl"
        for (part, compute), ref in refs.items():
            per_rank = by_rank[(part, compute)]
            # held at phase sp's limits: f32 for the model-axis parts
            # (MP_F32_HELD), whose bf16 step is held to the bf16 spread
            held = compute == ("f32" if part in MP_F32_HELD else "bf16")
            spread = refs[(part, "f32")]["bf16_vs_f32"] if part in MP_F32_HELD else None
            tag = part if compute == "bf16" else f"{part}_{compute}"
            for r, res in enumerate(per_rank):
                want = mp_launches(part, r)
                if compute == "bf16":
                    paths[f"mp_{part}_rank{r}"] = res["launches_first_step"]
                checks[f"{tag}_rank{r}_launches"] = all(
                    res["launches_first_step"][k] == n for k, n in want.items())
                checks[f"{tag}_rank{r}_finite"] = all(np.isfinite(res["losses"]))
                checks[f"{tag}_rank{r}_losses_within_tol"] = all(
                    abs(x - y) <= TRAIN_LOSS_TOL
                    for x, y in zip(res["losses"][:MP_HELD], ref["losses"][:MP_HELD]))
                if held:
                    checks[f"{tag}_rank{r}_moment1_within_tol"] = \
                        res["agreement"]["moment1"][0] <= TRAIN_GRAD_TOL
                    checks[f"{tag}_rank{r}_movement_within_tol"] = \
                        res["agreement"]["movement"][0] <= DP_MOVEMENT_TOL
                elif spread is not None:
                    for metric in ("moment1", "movement"):
                        checks[f"{tag}_rank{r}_{metric}_within_bf16_spread"] = \
                            res["agreement_f32"][metric][0] <= MP_BF16_SPREAD * spread[metric][0]
                if res["mesh"].get("model", 1) > 1:  # its heads: a block of q's columns
                    got, whole = res["q_block"]
                    checks[f"{tag}_rank{r}_holds_its_heads"] = \
                        got[1] * res["mesh"]["model"] == whole[1]
                # activations stage to stage and the ring's K/V point to point,
                # Ulysses' all-to-all
                route = ("ppermute" if res["mesh"].get("pipe", 1) > 1
                         or MP_SEQ_MODE.get(part) == "ring" else
                         "all_to_all" if part in MP_SEQ_MODE or part in MP_ROWS else None)
                if route is not None:
                    checks[f"{tag}_rank{r}_{route}_{route_want}"] = set(
                        res["routes"].get(route, {})) == {route_want}
                if part in MP_SEQ_MODE:  # its segment of every row
                    checks[f"{tag}_rank{r}_holds_its_segment"] = res["local_batch"] == [
                        MP_PARTS[part][2], MP_PARTS[part][1] // res["mesh"]["seq"]]
                if part in MP_ZERO:
                    checks[f"{tag}_rank{r}_equals_plain_bitwise"] = res["zero_equals_plain"]
                if res["local_experts"] is not None:
                    checks[f"{tag}_rank{r}_its_experts"] = \
                        res["local_experts"] * res["mesh"]["expert"] == SP_MOE["moe_experts"]
                if held and part in MP_ROWS:  # each layer's router over the whole batch
                    checks[f"{tag}_rank{r}_kept_tokens_equal"] = \
                        [k for k, _ in res["routers"]] == [k for k, _ in ref["routers"]]
                    checks[f"{tag}_rank{r}_aux_within_tol"] = len(res["routers"]) == len(
                        ref["routers"]) and all(abs(a - b) <= TRAIN_LOSS_TOL for (_, a), (_, b)
                                                in zip(res["routers"], ref["routers"]))
                if part in MP_STORED:  # its windows at rest
                    b = res["bytes"]
                    checks[f"{tag}_rank{r}_holds_its_windows"] = \
                        b["params"] == b["params_windows"] and b["slots"] == b["slots_windows"]
            emit({"phase": "mp", "part": part, "compute": compute,
                  "agreement_checked": held or spread is not None, "model": MP_PARTS[part][0],
                  "seq_len": MP_PARTS[part][1], "batch": MP_PARTS[part][2],
                  "mesh": per_rank[0]["mesh"], "overrides": MP_PARTS[part][4],
                  "seq_mode": MP_SEQ_MODE.get(part), "zero1": part in MP_ZERO,
                  "rows_over": MP_ROWS.get(part), "stored_over_data": part in MP_STORED,
                  "launches_predicted": [mp_launches(part, r) for r in range(len(per_rank))],
                  "backend": backend, "one_rank": ref,
                  "ranks": per_rank, "loss_tol": TRAIN_LOSS_TOL,
                  "moment1_tol": TRAIN_GRAD_TOL, "movement_tol": DP_MOVEMENT_TOL,
                  "bf16_spread": spread, "bf16_spread_factor": MP_BF16_SPREAD, "card": smi,
                  "note": "the model axis's collectives are all-reduces and all-gathers over "
                          "the backend; the pipeline's activations go point to point (with two "
                          "gloo ranks sharing the card, route gloo_host: staged through host "
                          "memory)"})
        emit({"phase": "mp", "ranks": [n for n, _ in groups], "backend": backend,
              "one_rank_seconds": ref_s, "ranks_seconds": ranks_s, "checks": checks})
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return paths, checks


def elastic_rank(rank, work):
    """One process of phase elastic (three ranks and one that joins back,
    sharing the card over gloo). (a) initial rank 2 is lost at step
    ELASTIC_LOST_STEP by a raised DeviceLostError on every rank: the
    survivors re-form at 2 and restore step 2; (c) the process that joins
    generation 2 as rank 2 regrows the world to 3 at the next checkpoint
    boundary, and the three finish the epoch; a 3-rank Trainer from the
    regrow's checkpoint takes the next batch, the reference of the regrown
    world's next step. (b) on those three, initial rank 0 (the manifest's
    writer) ends its process during step ELASTIC_LOST_STEP: the survivors
    learn it from gloo's error, agree through the launcher's health
    endpoint and re-form; then a 2-rank Trainer from (a)'s step-2
    checkpoint takes the epoch's first two batches, the reference of both
    shrinks. Each process writes what it measured to ``work`` as it goes
    (initial rank 0 does not come back from (b))."""
    import json
    import shutil

    import numpy as np
    import torch
    import torch.distributed as dist

    from paddle_tpu_torch.core.config import set_flags
    from paddle_tpu_torch.models import get_model
    from paddle_tpu_torch.observability.runlog import RunLog, read_runlog, set_runlog
    from paddle_tpu_torch.ops.cuda import build as kbuild
    from paddle_tpu_torch.parallel import mesh as mesh_mod
    from paddle_tpu_torch.parallel.mesh import EvictedError
    from paddle_tpu_torch.resilience import ResilienceConfig, faults
    from paddle_tpu_torch.resilience.faults import DeviceLostError
    from paddle_tpu_torch.trainer import BeginStepEvent, CheckpointConfig, EndStepEvent, Trainer

    set_flags(use_flash_attention=True, use_bf16_compute=True, check_nan_inf=False)
    # BASE_CFG, seq_len 1024, on this rank's card
    spec = get_model("transformer_lm", device=mesh_mod.process_device())
    batches = [spec.synth_batch(ELASTIC_ROWS, np.random.RandomState(i))
               for i in range(ELASTIC_BATCHES)]
    joined = mesh_mod.generation() > 0
    me = f"{mesh_mod.initial_rank()}{'_joined' if joined else ''}"
    out = {"rank": me}

    def reader(lo=0, hi=ELASTIC_BATCHES):
        return lambda: iter(batches[lo:hi])

    def save():
        with open(os.path.join(work, f"rank{me}.json"), "w") as f:
            json.dump(out, f)

    class Steps:
        """Per step: the global step, the step in its epoch, the world,
        the loss, ms (host clock to the loss's fetch) and the launches of
        each kernel (the counts' difference over the step)."""

        def __init__(self, die_at=None):
            self.rows, self.die_at, self.t = [], die_at, None

        def __call__(self, ev):
            if isinstance(ev, BeginStepEvent):
                if self.die_at is not None and ev.step == self.die_at:
                    with open(os.path.join(work, "death.json"), "w") as f:
                        json.dump({"time": time.time()}, f)
                    os._exit(1)  # a crashed host: no cleanup, no result
                torch.cuda.synchronize()
                self.t = (time.perf_counter(),
                          {n: k.launches for n, k in kbuild.KERNELS.items()})
            elif isinstance(ev, EndStepEvent):
                torch.cuda.synchronize()
                t0, before = self.t
                self.rows.append({
                    "step": self.trainer.global_step, "in_epoch": ev.step,
                    "world": mesh_mod.world_size(), "loss": ev.metrics,
                    "ms": 1e3 * (time.perf_counter() - t0),
                    "launches": {n: k.launches - before[n] for n, k in kbuild.KERNELS.items()}})

    def trainer(root, steps, elastic=True, interval=ELASTIC_CKPT_STEPS):
        t = Trainer(lambda: spec.model, spec.optimizer, parallel=True,
                    checkpoint_config=CheckpointConfig(root, step_interval=interval,
                                                       epoch_interval=10 ** 6,
                                                       max_num_checkpoints=10, sharded=True),
                    resilience=ResilienceConfig(elastic=elastic))
        steps.trainer = t
        return t

    def events(path):
        set_runlog(None)
        return [{k: e.get(k) for k in ("kind", "step", "devices_before", "devices_after",
                                       "source", "seconds", "trace_id")}
                for e in read_runlog(path) if e["kind"] in ("elastic_shrink", "elastic_regrow")]

    def copy_checkpoint(src_root, step, dst_root):
        """A directory holding only ``src_root``'s serial ``step``: what a
        cold restart from that checkpoint resumes."""
        if mesh_mod.process_rank() == 0:
            shutil.copytree(os.path.join(src_root, f"checkpoint_{step}"),
                            os.path.join(dst_root, f"checkpoint_{step}"))
        mesh_mod.barrier()

    # (a) shrink by a raised loss, then (c) the regrow
    log = os.path.join(work, f"runlog_a_{me}.jsonl")
    set_runlog(RunLog(log))
    steps = Steps()
    t = trainer(os.path.join(work, "a"), steps)
    lost = faults.FaultSpec(faults.DEVICE_LOST, "error", after=ELASTIC_LOST_STEP, times=1,
                            exc=DeviceLostError("injected: rank 2 lost", device_indices=(2,)))
    for kern in kbuild.KERNELS.values():
        kern.launches = 0
    t0 = time.perf_counter()
    try:
        with faults.injected(*([] if joined else [lost])):
            t.train(num_epochs=1, reader=reader(), event_handler=steps)
    except EvictedError as e:
        out["a"] = {"evicted": str(e), "steps": steps.rows}
        save()
        return out
    sup = t._elastic
    out["a"] = {"steps": steps.rows, "seconds": time.perf_counter() - t0,
                "launches": {n: k.launches for n, k in kbuild.KERNELS.items()},
                "global_step": t.global_step, "recovery": sup.last_recovery,
                "regrow": sup.last_regrow, "shrinks": sup.shrinks, "regrows": sup.regrows,
                "members": mesh_mod.members(), "events": events(log)}
    t.stop()
    del t
    torch.cuda.empty_cache()
    # the regrow's boundary, as the survivors took it
    at = [None]
    if not joined:
        regrow_step = sup.last_regrow["step"]
        after = [r for r in steps.rows if r["step"] == regrow_step + 1]
        at = [(regrow_step, after[0]["in_epoch"] if after else None)]
    dist.broadcast_object_list(at, src=0)
    regrow_step, next_batch = at[0]
    out["a"]["regrow_boundary"] = at[0]
    if next_batch is not None:
        copy_checkpoint(os.path.join(work, "a"), regrow_step, os.path.join(work, "r3"))
        ref = Steps()
        tr = trainer(os.path.join(work, "r3"), ref, elastic=False, interval=10 ** 6)
        tr.train(num_epochs=1, reader=reader(next_batch, next_batch + 1), event_handler=ref)
        out["r3"] = ref.rows
        tr.stop()
        del tr
    save()

    # (b) shrink by a real death: initial rank 0 ends its process
    log = os.path.join(work, f"runlog_b_{me}.jsonl")
    set_runlog(RunLog(log))
    steps = Steps(die_at=ELASTIC_LOST_STEP if mesh_mod.initial_rank() == 0 else None)
    t = trainer(os.path.join(work, "b"), steps)
    t0 = time.perf_counter()
    t.train(num_epochs=1, reader=reader(), event_handler=steps)
    sup = t._elastic
    out["b"] = {"steps": steps.rows, "seconds": time.perf_counter() - t0,
                "global_step": t.global_step, "recovery": sup.last_recovery,
                "shrinks": sup.shrinks, "members": mesh_mod.members(), "events": events(log)}
    t.stop()
    del t
    torch.cuda.empty_cache()
    # the reference of both shrinks: 2 ranks cold-restarted from (a)'s step 2
    copy_checkpoint(os.path.join(work, "a"), ELASTIC_CKPT_STEPS, os.path.join(work, "r2"))
    ref = Steps()
    tr = trainer(os.path.join(work, "r2"), ref, elastic=False, interval=10 ** 6)
    tr.train(num_epochs=1, reader=reader(0, 2), event_handler=ref)
    out["r2"] = ref.rows
    tr.stop()
    save()
    return out


def elastic_phase(smi: str, device: str = "cuda:0"):
    """Phase 15b: elastic training (see ELASTIC_*), gloo ranks sharing
    ``device``. Returns its kernel launches by path and its checks."""
    import json
    import shutil
    import tempfile

    from paddle_tpu_torch.parallel import launch

    checks = {}
    work = tempfile.mkdtemp(prefix="chip_smoke_elastic_")
    try:
        t0 = time.perf_counter()
        launch.spawn(elastic_rank, ELASTIC_RANKS, args=(work,), device=device, backend="gloo",
                     may_leave=(0,), join=[(2, 2)], collective_timeout_s=ELASTIC_TIMEOUT_S,
                     timeout_s=900)
        seconds = time.perf_counter() - t0
        ranks = {}
        for name in sorted(os.listdir(work)):
            if name.startswith("rank") and name.endswith(".json"):
                with open(os.path.join(work, name)) as f:
                    ranks[name[4:-5]] = json.load(f)
        with open(os.path.join(work, "death.json")) as f:
            death = json.load(f)["time"]
        ckpt_bytes = {p: sum(os.path.getsize(os.path.join(work, p, d, f))
                             for d in os.listdir(os.path.join(work, p))
                             for f in os.listdir(os.path.join(work, p, d)))
                      for p in ("r2", "r3") if os.path.isdir(os.path.join(work, p))}
    finally:
        shutil.rmtree(work, ignore_errors=True)
    from paddle_tpu_torch.models import get_model

    n_layers = get_model("transformer_lm", device="cpu").extra["cfg"]["n_layers"]
    survivors_a = [ranks[r] for r in ("0", "1")]
    joiner = ranks.get("2_joined", {})
    left = ranks.get("2", {}).get("a", {})
    survivors_b = [ranks[r] for r in ("1", "2_joined") if "b" in ranks.get(r, {})]

    def tol_equal(a, b):
        return len(a) == len(b) and all(abs(x - y) <= max(ELASTIC_LOSS_TOL, TRAIN_LOSS_TOL)
                                        for x, y in zip(a, b))

    def by_step(rows, lo, hi):
        return [r["loss"] for r in rows if lo <= r["step"] <= hi]

    all_rows = [r for rk in survivors_a for r in rk["a"]["steps"]] + left.get("steps", []) + \
        joiner.get("a", {}).get("steps", []) + \
        [r for rk in survivors_b for r in rk["b"]["steps"]]
    ref2 = [r["loss"] for r in survivors_b[0]["r2"]] if survivors_b else []
    def after_shrink(rows):
        """The losses of the steps the two survivors took from the restored
        checkpoint (before (a)'s regrow; to the end of the epoch in (b))."""
        return [r["loss"] for r in rows if r["world"] == 2][:2]

    a_losses = [after_shrink(rk["a"]["steps"]) for rk in survivors_a]
    b_rows = [rk["b"]["steps"] for rk in survivors_b]
    regrow_step = survivors_a[0]["a"]["regrow"]["step"] if survivors_a[0]["a"]["regrow"] else None
    ref3 = [r["loss"] for r in survivors_a[0].get("r3", [])]
    c_losses = [by_step(rk["a"]["steps"], regrow_step + 1, regrow_step + 1)
                for rk in survivors_a + [joiner]] if regrow_step is not None else []
    b_recovery = [rk["b"]["recovery"] for rk in survivors_b]
    detect_ms = [1e3 * (rec["detected_at"] - death) for rec in b_recovery]

    def one_event(rk, part, kind):
        evs = [e for e in rk[part]["events"] if e["kind"] == kind]
        return len(evs) == 1 and bool(evs[0]["trace_id"])

    checks.update({
        "a_rank2_left": "evicted" in left,
        "a_survivors_restored_step_2_from_disk": all(
            rk["a"]["recovery"]["restored_step"] == ELASTIC_CKPT_STEPS
            and rk["a"]["recovery"]["source"] == "disk" for rk in survivors_a),
        "a_one_shrink_event_with_trace_id": all(one_event(rk, "a", "elastic_shrink")
                                                for rk in survivors_a),
        "a_losses_vs_two_rank_cold_restart": bool(ref2) and all(
            len(l) == 2 and tol_equal(l, ref2) for l in a_losses),
        "c_regrew_to_three": all(rk["a"]["regrows"] == 1 and len(rk["a"]["members"]) == 3
                                 for rk in survivors_a + [joiner]),
        "c_one_regrow_event_with_trace_id": all(one_event(rk, "a", "elastic_regrow")
                                                for rk in survivors_a),
        "c_next_step_vs_three_rank_step": bool(ref3) and len(c_losses) == 3 and all(
            len(l) == 1 and tol_equal(l, ref3) for l in c_losses),
        "c_joiner_steps_equal_survivors": bool(joiner) and regrow_step is not None and [
            r["loss"] for r in joiner["a"]["steps"]] == by_step(
            survivors_a[0]["a"]["steps"], regrow_step + 1, 10 ** 6),
        "ac_epoch_finished": all(rk["a"]["global_step"] == ELASTIC_CKPT_STEPS + ELASTIC_BATCHES
                                 for rk in survivors_a + [joiner]),
        "b_rank0_died_survivors_reformed": len(survivors_b) == 2 and all(
            rk["b"]["members"] == [1, 2] for rk in survivors_b),
        "b_survivors_restored_step_2_from_disk": len(b_recovery) == 2 and all(
            rec["restored_step"] == ELASTIC_CKPT_STEPS and rec["source"] == "disk"
            for rec in b_recovery),
        "b_one_shrink_event_with_trace_id": all(one_event(rk, "b", "elastic_shrink")
                                                for rk in survivors_b),
        "b_detected_before_the_timeout": bool(detect_ms) and all(
            0 <= ms < 1e3 * ELASTIC_TIMEOUT_S for ms in detect_ms),
        "b_losses_vs_two_rank_cold_restart": bool(ref2) and all(
            tol_equal(after_shrink(rows), ref2) for rows in b_rows),
        "b_epoch_finished": all(rk["b"]["global_step"] == ELASTIC_CKPT_STEPS + ELASTIC_BATCHES
                                for rk in survivors_b),
        "every_step_six_launches_of_each_kernel": bool(all_rows) and all(
            r["launches"][k] == n_layers for r in all_rows for k in HOPPER_KERNELS),
    })
    bit_equal = {
        "a": bool(ref2) and all(l == ref2 for l in a_losses),
        "b": bool(ref2) and all(after_shrink(rows) == ref2 for rows in b_rows),
        "c": bool(ref3) and all(l == ref3 for l in c_losses),
    }

    def step_ms(rows, world):
        ms = [r["ms"] for r in rows if r["world"] == world]
        return {"median": float(sorted(ms)[len(ms) // 2]) if ms else None, "n": len(ms)}

    rank1 = ranks["1"]
    numbers = {
        "a": {"rendezvous_ms": [1e3 * rk["a"]["recovery"]["rendezvous_s"] for rk in survivors_a],
              "restore_s": [rk["a"]["recovery"]["restore_s"] for rk in survivors_a],
              "recovery_s": [rk["a"]["recovery"]["seconds"] for rk in survivors_a],
              "step_ms_3_ranks_before": step_ms(rank1["a"]["steps"][:ELASTIC_LOST_STEP], 3),
              "step_ms_2_ranks": step_ms(rank1["a"]["steps"], 2)},
        "c": {"regrow_s": [rk["a"]["regrow"]["seconds"] for rk in survivors_a],
              "rendezvous_ms": [1e3 * rk["a"]["regrow"]["rendezvous_s"] for rk in survivors_a],
              "regrow_step": regrow_step,
              "step_ms_3_ranks_after": step_ms(rank1["a"]["steps"][ELASTIC_LOST_STEP:], 3)},
        "b": {"detect_ms": detect_ms,
              "rendezvous_ms": [1e3 * rec["rendezvous_s"] for rec in b_recovery],
              "restore_s": [rec["restore_s"] for rec in b_recovery],
              "recovery_s": [rec["seconds"] for rec in b_recovery],
              "step_ms_3_ranks_before": step_ms(rank1["b"]["steps"], 3),
              "step_ms_2_ranks_after": step_ms(rank1["b"]["steps"], 2)},
        "restore_bytes": ckpt_bytes.get("r2"), "regrow_checkpoint_bytes": ckpt_bytes.get("r3"),
    }
    emit({"phase": "elastic", "model": "transformer_lm", "ranks": ELASTIC_RANKS,
          "global_batch": [ELASTIC_ROWS, 1024], "epoch_batches": ELASTIC_BATCHES,
          "checkpoint_every": ELASTIC_CKPT_STEPS, "lost_at_step": ELASTIC_LOST_STEP,
          "collective_timeout_s": ELASTIC_TIMEOUT_S, "numbers": numbers,
          "bit_equal_to_cold_restart": bit_equal, "loss_tol_if_not_bit_equal": TRAIN_LOSS_TOL,
          "losses": {"a": a_losses, "c": c_losses, "b": [after_shrink(rows) for rows in b_rows],
                     "ref_two_ranks": ref2, "ref_three_ranks": ref3},
          "seconds": seconds, "card": smi, "checks": checks})
    launches = rank1["a"]["launches"]
    return {"elastic": launches}, checks


def catalog_sweep_cases():
    """Phase catalog (a): every function of the port's ops.math, the ops.nn
    functions of the catalog slice, ops.losses, ops.control_flow, ops.nn3d
    and ops.vision at small shapes: (id, fn(ns, *tensors), numpy args, grad
    argnums, kind). ``ns`` holds the modules, the device and a seeded
    generator on it; kind "fwd" holds at CATALOG_FWD_TOL, "rec" (the
    recursions) at CATALOG_REC_TOL, "random" by shape, dtype and range. An
    id starts with the function's name."""
    import numpy as np
    import torch

    r = np.random.RandomState(0)

    def f(*shape, scale=1.0):
        x = r.randn(*shape) * scale
        return (x + np.sign(x) * 0.3).astype(np.float32)  # away from kinks

    def ids(high, *shape):
        return r.randint(0, high, size=shape).astype(np.int32)

    X, X3, P = f(4, 6), f(2, 3, 4), (np.abs(r.randn(4, 6)) + 0.5).astype(np.float32)
    TIES = np.array([[3.0, 1.0, 3.0, 2.0, 1.0, 3.0], [0.0, 0.0, -1.0, 0.0, 5.0, 5.0]], np.float32)
    BA, BB = r.rand(4, 6) > 0.5, r.rand(4, 6) > 0.5
    IMG, IMG8, VOL = f(2, 8, 8, 4), f(2, 4, 4, 8), f(2, 4, 6, 6, 3)
    SEQ, LENS = f(3, 6, 4), np.array([6, 2, 4], np.int32)
    PR = r.uniform(0.05, 0.95, (3, 5)).astype(np.float32)
    L01 = (r.rand(3, 5) > 0.5).astype(np.float32)
    LP = np.log(r.dirichlet(np.ones(6), size=(3, 9))).astype(np.float32)
    EM, TR = f(3, 7, 5), f(7, 5)
    BEAM_T = np.log(r.dirichlet(np.ones(5), size=(2, 4))).astype(np.float32)  # [B, T, V]
    fwd, rec, rnd = "fwd", "rec", "random"

    def beam_step(o, table):
        t_max = table.shape[1] - 1

        def step(carry, tokens):
            t, row = carry
            return (t + 1, row), table[row, min(int(t[0]), t_max)]

        return step

    def rnn_step(h, x):
        h = torch.tanh(h * 0.9 + x)
        return h, h * 2.0

    cases = [
        # ops.math
        ("elementwise_add", lambda o, x, y: o.m.elementwise_add(x, y, axis=1), [X3, f(3)], (0, 1), fwd),
        ("elementwise_sub", lambda o, x, y: o.m.elementwise_sub(x, y), [X, X * 0.5], (0, 1), fwd),
        ("elementwise_mul", lambda o, x, y: o.m.elementwise_mul(x, y), [X, X * 0.5], (0, 1), fwd),
        ("elementwise_div", lambda o, x, y: o.m.elementwise_div(x, y), [X, P], (0, 1), fwd),
        ("elementwise_min", lambda o, x, y: o.m.elementwise_min(x, y), [X, X[::-1].copy()], (0,), fwd),
        ("elementwise_max", lambda o, x, y: o.m.elementwise_max(x, y), [X, X[::-1].copy()], (0,), fwd),
        ("elementwise_pow", lambda o, x, y: o.m.elementwise_pow(x, y), [P, X * 0.5], (0, 1), fwd),
    ]
    for name in ("relu", "relu6", "sigmoid", "tanh", "softplus", "softsign", "square", "exp", "abs",
                 "gelu", "leaky_relu", "elu", "hard_sigmoid", "swish", "sign", "sin", "cos",
                 "floor", "ceil", "round"):
        cases.append((name, lambda o, x, n=name: getattr(o.m, n)(x), [X], (0,), fwd))
    for name in ("sqrt", "log", "reciprocal"):
        cases.append((name, lambda o, x, n=name: getattr(o.m, n)(x), [P], (0,), fwd))
    cases += [
        ("prelu_fn", lambda o, x, a: o.m.prelu_fn(x, a), [X, f(6) * 0.2], (0, 1), fwd),
        ("pow", lambda o, x: o.m.pow(x, 3.0), [X], (0,), fwd),
        ("scale", lambda o, x: o.m.scale(x, 2.5, 1.0, False), [X], (0,), fwd),
        ("clip", lambda o, x: o.m.clip(x, -1.0, 1.0), [X * 0.7], (0,), fwd),
        ("clip_by_norm", lambda o, x: o.m.clip_by_norm(x, 0.8), [X], (0,), fwd),
        ("matmul", lambda o, x, y: o.m.matmul(x, y, transpose_y=True, alpha=0.5),
         [f(2, 3, 4), f(2, 5, 4)], (0, 1), fwd),
        ("mul", lambda o, x, y: o.m.mul(x, y, 1, 2), [f(2, 3, 4), f(3, 4, 5)], (0, 1), fwd),
        ("dot", lambda o, x, y: o.m.dot(x, y), [X, X * 0.3], (0, 1), fwd),
        ("sum", lambda o, x, y: o.m.sum([x, y]) + o.m.sum(x), [X, X * 0.5], (0, 1), fwd),
        ("reduce_sum", lambda o, x: o.m.reduce_sum(x, [0, 2], keep_dim=True), [X3], (0,), fwd),
        ("reduce_mean", lambda o, x: o.m.reduce_mean(x, 1), [X3], (0,), fwd),
        ("reduce_max", lambda o, x: o.m.reduce_max(x, -1), [X3], (0,), fwd),
        ("reduce_min", lambda o, x: o.m.reduce_min(x), [X3], (0,), fwd),
        ("reduce_prod", lambda o, x: o.m.reduce_prod(x, [0, 2]), [X3], (0,), fwd),
        ("cumsum", lambda o, x: o.m.cumsum(x, -1, exclusive=True, reverse=True), [X3], (0,), fwd),
        ("argmax", lambda o, x: o.m.argmax(x), [TIES], (), fwd),
        ("argmin", lambda o, x: o.m.argmin(x, 0), [TIES], (), fwd),
        ("argsort", lambda o, x: o.m.argsort(x, descending=True), [TIES], (), fwd),
        ("topk", lambda o, x: o.m.topk(x, 3), [TIES], (), fwd),
        ("cast", lambda o, x: o.m.cast(x * 3, "int32"), [X], (), fwd),
        ("concat", lambda o, x, y: o.m.concat([x, y], axis=1), [X3, X3 * 2], (0, 1), fwd),
        ("split", lambda o, x: o.m.split(x, [1, 3], dim=-1), [X3], (0,), fwd),
        ("stack", lambda o, x, y: o.m.stack([x, y], axis=1), [X, X * 3], (0, 1), fwd),
        ("unstack", lambda o, x: o.m.unstack(x, 1), [X3], (0,), fwd),
        ("reshape", lambda o, x: o.m.reshape(x, [4, -1]), [X3], (0,), fwd),
        ("flatten", lambda o, x: o.m.flatten(x, 2), [X3], (0,), fwd),
        ("squeeze", lambda o, x: o.m.squeeze(x, [1]), [X3[:, :1]], (0,), fwd),
        ("unsqueeze", lambda o, x: o.m.unsqueeze(x, [0, 3]), [X], (0,), fwd),
        ("transpose", lambda o, x: o.m.transpose(x, [2, 0, 1]), [X3], (0,), fwd),
        ("expand", lambda o, x: o.m.expand(x, [2, 1, 3]), [X3], (0,), fwd),
        ("tile", lambda o, x: o.m.tile(x, (2, 1)), [X], (0,), fwd),
        ("slice", lambda o, x: o.m.slice(x, [1, 2], [1, -3], [3, 100]), [X3], (0,), fwd),
        ("gather", lambda o, x, i: o.m.gather(x, i, axis=1), [X3, np.array([2, 0, 2], np.int32)],
         (0,), fwd),
        ("gather_nd", lambda o, x, i: o.m.gather_nd(x, i), [X3, np.array([[1, 0], [0, 2]], np.int32)],
         (0,), fwd),
        ("scatter", lambda o, x, i, u: o.m.scatter(x, i, u), [X, np.array([3, 0], np.int32), f(2, 6)],
         (0, 2), fwd),
        ("scatter_add", lambda o, x, i, u: o.m.scatter_add(x, i, u),
         [X, np.array([3, 0, 3], np.int32), f(3, 6)], (0, 2), fwd),
        ("pad", lambda o, x: o.m.pad(x, [0, 1, 2, 0, 1, 1], pad_value=-1.5), [X3], (0,), fwd),
        ("crop", lambda o, x: o.m.crop(x, [1, 2, 3], [2, 2, 3]), [X3], (0,), fwd),
        ("reverse", lambda o, x: o.m.reverse(x, [0, 2]), [X3], (0,), fwd),
        ("shape", lambda o, x: o.m.shape(x), [X3], (), fwd),
        ("fill_constant", lambda o: o.m.fill_constant([2, 3], "float32", 1.5, device=o.dev), [], (), fwd),
        ("zeros", lambda o: o.m.zeros([3, 2], device=o.dev), [], (), fwd),
        ("ones", lambda o: o.m.ones([2], device=o.dev), [], (), fwd),
        ("zeros_like", lambda o, x: o.m.zeros_like(x), [X3], (), fwd),
        ("ones_like", lambda o, x: o.m.ones_like(x), [X3], (), fwd),
        ("arange", lambda o: o.m.arange(1, 4, 0.5, dtype="float32", device=o.dev), [], (), fwd),
        ("linspace", lambda o: o.m.linspace(-1.0, 2.0, 7, device=o.dev), [], (), fwd),
        ("uniform_random", lambda o: o.m.uniform_random([64, 8], key=o.gen(), device=o.dev), [], (),
         rnd),
        ("gaussian_random", lambda o: o.m.gaussian_random([64, 8], key=o.gen(), device=o.dev), [], (),
         rnd),
        ("uniform_random_batch_size_like",
         lambda o, x: o.m.uniform_random_batch_size_like(x, [-1, 5], key=o.gen()), [X], (), rnd),
        ("gaussian_random_batch_size_like",
         lambda o, x: o.m.gaussian_random_batch_size_like(x, [-1, 5], key=o.gen()), [X], (), rnd),
        ("truncated_gaussian_random",
         lambda o: o.m.truncated_gaussian_random([64, 8], key=o.gen(), device=o.dev), [], (), rnd),
        ("sampling_id", lambda o, p: o.m.sampling_id(p, key=o.gen()), [PR], (), rnd),
        ("isfinite", lambda o, x: o.m.isfinite(x), [X], (), fwd),
        ("mean", lambda o, x: o.m.mean(x), [X3], (0,), fwd),
        ("increment", lambda o, x: o.m.increment(x, 2.0), [X], (0,), fwd),
        ("where", lambda o, c, x, y: o.m.where(c, x, y), [BA, X, X * -2], (1, 2), fwd),
        ("maximum", lambda o, x, y: o.m.maximum(x, y), [X, X[::-1].copy()], (0, 1), fwd),
        ("minimum", lambda o, x, y: o.m.minimum(x, y), [X, X[::-1].copy()], (0, 1), fwd),
    ]
    for name in ("equal", "not_equal", "less_than", "less_equal", "greater_than", "greater_equal"):
        cases.append((name, lambda o, x, y, n=name: getattr(o.m, n)(x, y),
                      [TIES, TIES[:, ::-1].copy()], (), fwd))
    for name in ("logical_and", "logical_or", "logical_xor"):
        cases.append((name, lambda o, a, b, n=name: getattr(o.m, n)(a, b), [BA, BB], (), fwd))
    cases.append(("logical_not", lambda o, a: o.m.logical_not(a), [BA], (), fwd))
    # ops.nn: the functions of the catalog slice
    cases += [
        ("conv2d_transpose", lambda o, x, w: o.nn.conv2d_transpose(x, w, 2, 1, 1),
         [IMG, f(4, 3, 4, 5)], (0, 1), fwd),
        ("depthwise_conv2d", lambda o, x, w: o.nn.depthwise_conv2d(x, w, 1, 1), [IMG, f(3, 3, 1, 8)],
         (0, 1), fwd),
        ("maxout", lambda o, x: o.nn.maxout(x, 2), [IMG8], (0,), fwd),
        ("group_norm", lambda o, x, s, b: o.nn.group_norm(x, s, b, groups=2), [IMG, f(4), f(4)],
         (0, 1, 2), fwd),
        ("lrn", lambda o, x: o.nn.lrn(x), [IMG8], (0,), fwd),
        ("log_softmax", lambda o, x: o.nn.log_softmax(x), [SEQ], (0,), fwd),
        ("sigmoid_cross_entropy_with_logits",
         lambda o, x, y: o.nn.sigmoid_cross_entropy_with_logits(x, y), [f(3, 5) * 3, L01], (0,), fwd),
        ("smooth_l1", lambda o, x, y: o.nn.smooth_l1(x, y), [f(3, 2, 4), f(3, 2, 4)], (0, 1), fwd),
        ("huber_loss", lambda o, x, y: o.nn.huber_loss(x, y, 0.8), [f(3, 4), f(3, 4)], (0, 1), fwd),
        ("kldiv_loss", lambda o, x, t: o.nn.kldiv_loss(x, t), [np.log(PR), PR[::-1].copy()], (0, 1),
         fwd),
        ("log_loss", lambda o, p, y: o.nn.log_loss(p, y), [PR, L01], (0,), fwd),
        ("margin_rank_loss", lambda o, lab, a, b: o.nn.margin_rank_loss(lab, a, b, 0.2),
         [np.float32([1, -1, 1, -1]), f(4), f(4)], (1, 2), fwd),
        ("embedding_grad_dense", lambda o, i, g: o.nn.embedding_grad_dense((7, 4), i, g),
         [ids(7, 2, 3), f(2, 3, 4)], (1,), fwd),
        ("prelu", lambda o, x, a: o.nn.prelu(x, a), [IMG, f(4) * 0.2], (0, 1), fwd),
        ("pixel_shuffle", lambda o, x: o.nn.pixel_shuffle(x, 2), [IMG8], (0,), fwd),
        ("pad2d", lambda o, x: o.nn.pad2d(x, [2, 1, 1, 2], "reflect"), [IMG], (0,), fwd),
        ("resize_nearest", lambda o, x: o.nn.resize_nearest(x, (11, 5)), [IMG], (0,), fwd),
        ("resize_bilinear_up", lambda o, x: o.nn.resize_bilinear(x, (11, 13)), [IMG], (0,), fwd),
        ("resize_bilinear_down", lambda o, x: o.nn.resize_bilinear(x, (3, 5)), [IMG], (0,), fwd),
        ("resize_bilinear_aligned", lambda o, x: o.nn.resize_bilinear(x, (11, 3), True), [IMG], (0,),
         fwd),
        ("cos_sim", lambda o, x, y: o.nn.cos_sim(x, y), [SEQ, f(3, 6, 4)], (0, 1), fwd),
        ("l2_normalize", lambda o, x: o.nn.l2_normalize(x, 1), [SEQ], (0,), fwd),
        ("matmul_bias", lambda o, x, w, b: o.nn.matmul_bias(x, w, b), [SEQ, f(4, 5), f(5)], (0, 1, 2),
         fwd),
        ("multiplex", lambda o, a, b, i: o.nn.multiplex([a, b], i),
         [f(4, 3), f(4, 3), np.array([1, 0, 1, 1], np.int32)], (0, 1), fwd),
        ("row_conv", lambda o, x, w, l: o.nn.row_conv(x, w, l), [SEQ, f(3, 4), LENS], (0, 1), fwd),
        ("pad_constant_like", lambda o, x, y: o.nn.pad_constant_like(x, y, 1.5),
         [f(4, 5, 3), f(2, 5, 1)], (1,), fwd),
        ("rank_loss", lambda o, lab, a, b: o.nn.rank_loss(lab, a, b), [np.float32([1, 0, 1, .5]),
                                                                         f(4), f(4)], (1, 2), fwd),
        ("dice_loss", lambda o, p, y: o.nn.dice_loss(p, y), [PR, L01], (0,), fwd),
        ("mean_iou", lambda o, p, l: o.nn.mean_iou(p, l, 5), [ids(5, 2, 8), ids(5, 2, 8)], (), fwd),
        ("nce_loss", lambda o, x, w, b, y, s: o.nn.nce_loss(x, w, b, y, 3, None, 12, samples=s),
         [f(5, 4), f(12, 4), f(12), ids(12, 5), ids(12, 5, 3)], (0, 1, 2), fwd),
        ("hsigmoid_loss", lambda o, x, w, b, y: o.nn.hsigmoid_loss(x, w, b, y, 6),
         [f(4, 3), f(5, 3), f(5), ids(6, 4)], (0, 1, 2), fwd),
        # ops.nn3d
        ("conv3d", lambda o, x, w: o.n3.conv3d(x, w, (1, 2, 2), "SAME"), [VOL, f(2, 3, 2, 3, 4)],
         (0, 1), fwd),
        ("conv3d_transpose", lambda o, x, w: o.n3.conv3d_transpose(x, w, 2, 1, 1),
         [VOL, f(3, 3, 3, 3, 2)], (0, 1), fwd),
        ("pool3d_max", lambda o, x: o.n3.pool3d(x, 3, "max", 2, 1), [VOL], (0,), fwd),
        ("pool3d_avg", lambda o, x: o.n3.pool3d(x, 3, "avg", 2, 1), [VOL], (0,), fwd),
        # ops.vision
        ("image_resize", lambda o, x: o.v.image_resize(x, scale=1.5), [IMG], (0,), fwd),
        ("image_resize_short", lambda o, x: o.v.image_resize_short(x, 5), [IMG], (0,), fwd),
        ("random_crop", lambda o, x: o.v.random_crop(x, (5, 6), o.gen()), [IMG], (), rnd),
        ("roi_pool", lambda o, x, b, i: o.v.roi_pool(x, b, i, 2, 3, 0.5),
         [IMG, np.float32([[0, 0, 6, 6], [2, 4, 12, 10], [4, 2, 4, 2]]), np.array([0, 1, 1], np.int32)],
         (0,), fwd),
        ("im2sequence", lambda o, x: o.v.im2sequence(x, (3, 2), (2, 1), (1, 0)), [IMG], (0,), fwd),
        # ops.losses
        ("linear_chain_crf", lambda o, e, y, l, t: o.l.linear_chain_crf(e, y, l, t),
         [EM, ids(5, 3, 7), np.array([7, 3, 5], np.int32), TR], (0, 3), rec),
        ("crf_decoding", lambda o, e, l, t: o.l.crf_decoding(e, l, t),
         [EM, np.array([7, 3, 5], np.int32), TR], (), rec),
        ("ctc_loss", lambda o, p, y, il, ll: o.l.ctc_loss(p, y, il, ll),
         [LP, np.array([[1, 2, 2], [3, 0, 0], [4, 5, 1]], np.int32), np.array([9, 6, 8], np.int32),
          np.array([3, 0, 3], np.int32)], (0,), rec),
        ("ctc_greedy_decode", lambda o, p, l: o.l.ctc_greedy_decode(p, l),
         [LP, np.array([9, 6, 0], np.int32)], (), fwd),
        ("edit_distance", lambda o, h, hl, rf, rl: o.l.edit_distance(h, hl, rf, rl, normalized=True),
         [ids(4, 3, 6), np.array([6, 0, 4], np.int32), ids(4, 3, 5), np.array([5, 3, 0], np.int32)],
         (), fwd),
        # ops.control_flow
        ("while_loop", lambda o, x: o.cf.while_loop(lambda s: s[0] < 4,
                                                   lambda s: (s[0] + 1, torch.tanh(s[1] * 1.3)),
                                                   (0, x))[1], [X], (0,), rec),
        ("cond", lambda o, p, x: o.cf.cond(p, lambda v: v * 2, lambda v: v - 1, x),
         [np.array(True), X], (1,), fwd),
        ("switch_case", lambda o, x: o.cf.switch_case(torch.tensor(5), [torch.sin, torch.cos], x),
         [X], (0,), fwd),
        ("case", lambda o, x: o.cf.case([(x.sum() > 1e3, torch.sin), (x.sum() < 1e3, torch.cos)],
                                        torch.tanh, x), [X], (0,), fwd),
        ("TensorArray", lambda o, a, b: o.cf.TensorArray.create(3, (6,), device=o.dev)
         .write(0, a).append(b).stack(), [f(6), f(6)], (0, 1), fwd),
        ("create_array", lambda o, a: o.cf.array_read(o.cf.array_write(
            o.cf.create_array(4, (6,), device=o.dev), 2, a), 2), [f(6)], (0,), fwd),
        ("array_write", lambda o, a: o.cf.array_write(o.cf.create_array(2, (6,), device=o.dev), 1, a)
         .stack(), [f(6)], (0,), fwd),
        ("array_read", lambda o, a: o.cf.array_read(o.cf.create_array(2, (6,), device=o.dev)
                                                    .write(0, a), 0), [f(6)], (0,), fwd),
        ("array_length", lambda o, a: o.cf.array_length(o.cf.create_array(5, (6,), device=o.dev)
                                                        .write(3, a)), [f(6)], (), fwd),
        ("static_rnn", lambda o, x, h: o.cf.static_rnn(rnn_step, x, h), [SEQ, f(3, 4)], (0, 1), rec),
        ("dynamic_rnn", lambda o, x, l, h: o.cf.dynamic_rnn(rnn_step, x, l, h), [SEQ, LENS, f(3, 4)],
         (0, 2), rec),
        ("rank_by_length", lambda o, l: o.cf.rank_by_length(l), [np.array([2, 9, 5, 9, 2], np.int32)],
         (), fwd),
        ("beam_search", lambda o, tab: o.cf.beam_search(
            beam_step(o, tab), (torch.zeros(2, dtype=torch.long, device=tab.device),
                                torch.arange(2, device=tab.device)),
            batch_size=2, beam_size=3, vocab_size=5, max_len=4, bos_id=0, eos_id=1), [BEAM_T], (), rec),
        ("beam_search_decode", lambda o, tk, pt: o.cf.beam_search_decode(tk, pt),
         [ids(9, 4, 2, 3), ids(3, 4, 2, 3)], (), fwd),
        ("greedy_search", lambda o, tab: o.cf.greedy_search(
            lambda t, tok: (t + 1, tab[:, min(int(t), 3)]), torch.zeros((), device=tab.device),
            batch_size=2, max_len=4, bos_id=0, eos_id=1), [BEAM_T], (), rec),
    ]
    return cases + catalog_detection_cases(r, f)


def catalog_detection_cases(r, f):
    """Phase catalog (a), continued: every function of ops.detection,
    ops.detection_rpn and ops.quant and layers.multi_box_head at small
    sizes (zero-width boxes, shared edges and exactly tied scores among the
    inputs; the samplers given fixed priorities), then the kinks of §C.1
    and the edge semantics of §C.2 at exact zeros, ties, NaNs and indices
    out of range."""
    import numpy as np

    from paddle_tpu_torch.ops import detection as det

    fwd = "fwd"
    pri, pvar = (t.reshape(-1, 4).numpy() for t in det.prior_box(
        (5, 5), (100, 100), [20.0], [40.0], [2.0], flip=True, device="cpu"))  # 100 priors
    gt = np.array([[0.1, 0.1, 0.3, 0.3], [0.5, 0.3, 0.9, 0.7], [0.3, 0.3, 0.3, 0.7],
                   [0.0, 0.6, 0.4, 1.0], [0.6, 0.0, 1.0, 0.2], [0.3, 0.5, 0.7, 0.9],
                   [0.0, 0.0, 0.0, 0.0], [0.0, 0.0, 0.0, 0.0]], np.float32)
    gt_valid, gt_labels = np.array([True] * 6 + [False] * 2), np.array([1, 2, 1, 3, 2, 3, 0, 0], np.int32)
    loc = (r.randn(100, 4) * 0.1).astype(np.float32)
    conf = r.randn(100, 4).astype(np.float32)
    scores = np.exp(conf) / np.exp(conf).sum(-1, keepdims=True)
    nbox = np.concatenate([gt[:6], gt[:6] + 0.02, np.float32([[0.2, 0.2, 0.2, 0.5]]),
                           np.abs(r.randn(7, 4) * 0.3).cumsum(1).astype(np.float32)])
    ns = r.uniform(0, 1, 20).astype(np.float32)
    ns[[3, 9, 17]] = ns[5]
    cs = r.uniform(0, 1, (4, 20)).astype(np.float32)
    cs[2, [1, 4, 11]] = cs[2, 0]
    sim = np.round(r.uniform(0, 1, (5, 9)), 1).astype(np.float32)
    sim[2, 4] = sim[4, 7] = sim.max()
    anchors = det.anchor_generator((6, 7), (16.0, 32.0), (0.5, 1.0, 2.0), stride=(8.0, 8.0),
                                   device="cpu")[0].reshape(-1, 4).numpy()  # 252 anchors
    rgt = np.float32([[10, 12, 40, 36], [20, 4, 28, 44], [30, 30, 30, 40], [0, 0, 0, 0]])
    rvalid = np.array([True, True, True, False])
    rois = np.concatenate([rgt[:3] + 1.0, anchors[::6] + r.randn(42, 4).astype(np.float32) * 2.0])
    pscore = r.uniform(0, 1, len(anchors)).astype(np.float32)
    pscore[[7, 40, 41, 200]] = pscore[100]
    quad = np.float32([[1, 1, 9, 2, 10, 8, 0, 7], [3, 3, 11, 3, 11, 10, 3, 10],
                       [-4, 2, 20, 0, 18, 15, -1, 13]])
    kink = np.float32([[0, -0.0, 1.5, -2, 0, 6], [-1, 1, 0, 7, -3, 2.5]])
    kink_b = np.float32([[0, 1, 1.5, -2, -0.0, 5], [-1, 2, 0, 7, -3, -2.5]])
    nan_row = np.float32([[1, np.nan, 3, -1, np.nan, 3], [0, 2, np.nan, 2, -4, 0]])
    grid = np.arange(12, dtype=np.float32).reshape(4, 3)
    zlogit = np.float32([[0, 0, -0.0, 1.5, 0], [0, -2, 0, 0, 3], [0] * 5])
    l01 = (r.rand(3, 5) > 0.5).astype(np.float32)
    return [
        # ops.detection
        ("prior_box", lambda o: o.det.prior_box((5, 6), (120, 100), [20.0, 30.0], [40.0, 50.0],
                                                [2.0, 3.0], flip=True, clip=True, device=o.dev),
         [], (), fwd),
        ("anchor_generator", lambda o: o.det.anchor_generator((4, 5), device=o.dev), [], (), fwd),
        ("box_coder_encode", lambda o, p, v, t: o.det.box_coder(p, v, t), [pri, pvar, gt[[0, 1, 3]]],
         (0, 2), fwd),
        ("box_coder_decode", lambda o, p, v, c: o.det.box_coder(p, v, c, "decode_center_size"),
         [pri, pvar, loc], (0, 2), fwd),
        ("iou_similarity", lambda o, x, y: o.det.iou_similarity(x, y), [gt, pri], (0, 1), fwd),
        ("bipartite_match", lambda o, x: o.det.bipartite_match(x), [sim], (0,), fwd),
        ("nms", lambda o, b, x: o.det.nms(b, x, 8, 0.3, 0.1), [nbox, ns], (), fwd),
        ("nms_classes", lambda o, b, x: o.det.nms(b, x, 7, 0.35, 0.2), [nbox, cs], (), fwd),
        ("multiclass_nms", lambda o, b, x: o.det.multiclass_nms(b, x, 0.05, 0.4, 6, 10),
         [nbox, cs], (), fwd),
        ("target_assign", lambda o, t, i: o.det.target_assign(t, i, -1.5),
         [f(5, 3), np.array([2, -1, 0, 4, -1, 2], np.int32)], (0,), fwd),
        ("box_clip", lambda o, b: o.det.box_clip(b, (30.0, 40.0)),
         [np.float32([[0, -1, 40, 30], [5, 30, 50, 30], [-3, 10, 12, 31]])], (0,), fwd),
        ("detection_output", lambda o, l, x, p, v: o.det.detection_output(l, x, p, v, 0, 0.45, 30, 25),
         [loc, scores, pri, pvar], (), fwd),
        ("ssd_loss", lambda o, l, c, g, y, v, p, pv: o.det.ssd_loss(l, c, g, y, v, p, pv),
         [loc, conf, gt, gt_labels, gt_valid, pri, pvar], (0, 1, 2), fwd),
        ("detection_map", lambda o, l, x, p, v, g, y, gv: o.det.detection_map(
            *o.det.detection_output(l, x, p, v, 0, 0.45, 30, 25), g, y, gv, 4, 0.3),
         [loc, scores, pri, pvar, gt, gt_labels, gt_valid], (), fwd),
        # ops.detection_rpn (the samplers given fixed priorities)
        ("rpn_target_assign", lambda o, a, g, v, u: o.rpn.rpn_target_assign(
            a, g, v, None, 24, 0.25, 0.5, 0.2, uniforms=u),
         [anchors, rgt, rvalid, r.rand(2, len(anchors)).astype(np.float32)], (), fwd),
        ("generate_proposals", lambda o, x, d, a, v: o.rpn.generate_proposals(
            x, d, a, v, (50.0, 60.0), 120, 30, 0.6),
         [pscore, (r.randn(len(anchors), 4) * 0.2).astype(np.float32), anchors,
          np.full_like(anchors, 0.5)], (1,), fwd),
        ("generate_proposal_labels", lambda o, x, g, y, v, u: o.rpn.generate_proposal_labels(
            x, g, y, v, None, 16, 0.25, 0.4, 0.4, uniforms=u),
         [rois, rgt, np.array([3, 1, 2, 0], np.int32), rvalid, r.rand(2, len(rois)).astype(np.float32)],
         (0,), fwd),
        ("roi_perspective_transform", lambda o, x, q: o.rpn.roi_perspective_transform(
            x, q, 5, 6, 0.75), [f(1, 12, 14, 3), quad], (0, 1), fwd),
        ("polygon_box_transform", lambda o, x: o.rpn.polygon_box_transform(x), [f(2, 4, 3, 5)], (0,),
         fwd),
        # ops.quant
        ("fake_quantize_abs_max", lambda o, x: o.q.fake_quantize_abs_max(x, 4),
         [np.float32([[0.5, -2.0, 2.0], [0.0, 1.3, -0.7]])], (0,), fwd),
        ("fake_channel_wise_quantize_abs_max",
         lambda o, x: o.q.fake_channel_wise_quantize_abs_max(x, 8, -1), [f(3, 3, 2, 5)], (0,), fwd),
        ("fake_quantize_moving_average_abs_max",
         lambda o, x, m: o.q.fake_quantize_moving_average_abs_max(x, m, 6, 0.8),
         [f(4, 6), np.float32(1.5)], (0, 1), fwd),
        ("fake_dequantize_max_abs", lambda o, x, m: o.q.fake_dequantize_max_abs(x, m, 127.0),
         [np.round(f(4, 6) * 40), np.float32(2.5)], (0, 1), fwd),
        # layers.multi_box_head: two maps, weights from one seeded init
        ("multi_box_head", lambda o, a, b: multi_box_head_case(o.dev, a, b),
         [f(2, 4, 4, 6), f(2, 2, 2, 8)], (0, 1), fwd),
        # §C.1: exactly on the kinks and ties
        ("relu_at_kink", lambda o, x: o.m.relu(x), [kink], (0,), fwd),
        ("relu6_at_kink", lambda o, x: o.m.relu6(x), [kink], (0,), fwd),
        ("clip_at_kink", lambda o, x: o.m.clip(x, -1.0, 1.0), [kink], (0,), fwd),
        ("hard_sigmoid_at_kink", lambda o, x: o.m.hard_sigmoid(x), [kink], (0,), fwd),
        ("abs_at_kink", lambda o, x: o.m.abs(x), [kink], (0,), fwd),
        ("clip_by_norm_at_kink", lambda o, x: o.m.clip_by_norm(x, 5.0), [np.float32([[3, 0], [0, 4]])],
         (0,), fwd),
        ("maximum_ties", lambda o, x, y: o.m.maximum(x, y), [kink, kink_b], (0, 1), fwd),
        ("minimum_ties", lambda o, x, y: o.m.minimum(x, y), [kink, kink_b], (0, 1), fwd),
        ("sigmoid_cross_entropy_with_logits_at_kink",
         lambda o, x, y: o.nn.sigmoid_cross_entropy_with_logits(x, y), [zlogit, l01], (0,), fwd),
        ("margin_rank_loss_at_kink", lambda o, lab, a, b: o.nn.margin_rank_loss(lab, a, b, 0.25),
         [np.float32([1, -1, 1, -1]), np.float32([1.25, 1, 2, 0.5]), np.float32([1, 1.25, 1, 0.5])],
         (1, 2), fwd),
        ("hsigmoid_loss_at_kink", lambda o, x, w, b, y: o.nn.hsigmoid_loss(x, w, b, y, 6),
         [f(4, 3), np.concatenate([np.zeros((3, 3), np.float32), f(2, 3)]),
          np.float32([0, 0, 0, 0.5, -0.5]), np.array([0, 5, 2, 3], np.int32)], (0, 1, 2), fwd),
        ("nce_loss_at_kink", lambda o, x, w, b, y, s: o.nn.nce_loss(x, w, b, y, 5, None, 5, samples=s),
         [f(3, 4), np.zeros((5, 4), np.float32), np.zeros(5, np.float32), np.array([1, 4, 0], np.int32),
          r.randint(0, 5, (3, 5)).astype(np.int32)], (0, 1, 2), fwd),
        # §C.2: the edge semantics
        ("crop_negative_offset", lambda o, x: o.m.crop(x, [3, -1], [2, 2]), [grid], (0,), fwd),
        ("sign_nan", lambda o, x: o.m.sign(x), [nan_row], (), fwd),
        ("argsort_descending_nan", lambda o, x: o.m.argsort(x, descending=True), [nan_row], (), fwd),
        ("gather_out_of_range_fills", lambda o, x, i: o.m.gather(x, i),
         [grid, np.array([0, -1, 3, 4, -5], np.int32)], (0,), fwd),
        ("gather_nd_out_of_range_clamps", lambda o, x, i: o.m.gather_nd(x, i),
         [grid, np.array([[0, 1], [-1, 2], [5, 7], [-6, 0]], np.int32)], (0,), fwd),
        ("scatter_out_of_range_drops", lambda o, x, i, u: o.m.scatter(x, i, u),
         [f(3, 4), np.array([1, -1, 5, -6], np.int32), f(4, 4)], (0, 2), fwd),
    ]


_MULTI_BOX_HEAD = {}


def multi_box_head_case(dev: str, f1, f2):
    """layers.multi_box_head over two maps, its weights from one seeded
    init on the CPU, moved once to ``dev``."""
    import paddle_tpu_torch as pt

    def net(a, b):
        return pt.layers.multi_box_head([a, b], (64, 64), 3, [16.0, 32.0], [32.0, 48.0],
                                        [[2.0], [2.0, 3.0]])

    if dev not in _MULTI_BOX_HEAD:
        model = pt.build(net)
        params = model.init(0, f1.detach().cpu(), f2.detach().cpu(), device="cpu").params
        _MULTI_BOX_HEAD[dev] = (model, {k: t.to(dev) for k, t in params.items()})
    model, params = _MULTI_BOX_HEAD[dev]
    out, _ = model.apply(params, f1, f2)
    return out


def _catalog_namespace(dev: str):
    import types

    import torch

    from paddle_tpu_torch.ops import (control_flow, detection, detection_rpn, losses, math, nn, nn3d,
                                      quant, vision)

    return types.SimpleNamespace(
        m=math, nn=nn, n3=nn3d, v=vision, l=losses, cf=control_flow, det=detection,
        rpn=detection_rpn, q=quant, dev=dev,
        gen=lambda: torch.Generator(device=dev).manual_seed(0))


def _sweep_run(fn, args, argnums, dev, cotangents=None):
    """One case on ``dev``: its output leaves (on the CPU) and, with
    ``cotangents``, the gradients of sum(out * c) with respect to the
    argnums."""
    import torch

    from paddle_tpu_torch.core import tree

    ts = [torch.as_tensor(a).to(dev) for a in args]
    for i in argnums:
        ts[i].requires_grad_(True)
    outs = tree.leaves(fn(_catalog_namespace(dev), *ts))
    grads = None
    if cotangents is not None:
        loss = sum((o.float() * c.to(dev)).sum() for o, c in zip(outs, cotangents)
                   if o.is_floating_point())
        grads = [g.detach().cpu() for g in torch.autograd.grad(loss, [ts[i] for i in argnums])]
    return [o.detach().cpu() for o in outs], grads


def _rel_l2_nan(a, b) -> float:
    """:func:`_rel_l2` over the positions where ``b`` is finite; inf where
    the non-finite positions (NaN, ±inf) are not the same in both."""
    import torch

    finite = torch.isfinite(b)
    if not torch.equal(torch.isfinite(a), finite) or not torch.equal(
            torch.nan_to_num(a[~finite], 0.0), torch.nan_to_num(b[~finite], 0.0)) or not torch.equal(
            torch.isnan(a), torch.isnan(b)):
        return float("inf")
    return _rel_l2(torch.where(finite, a, 0.0), torch.where(finite, b, 0.0))


def launches_by_range(prof, prefix: str) -> dict:
    """Kernel launches (the CUDA runtime's launch calls) inside each
    ``record_function`` range whose name starts with ``prefix``, from one
    torch.profiler run: {range name: launches}."""
    import bisect

    events = prof.events()
    launches = sorted(e.time_range.start for e in events if "LaunchKernel" in e.name)
    out = {}
    for e in events:
        if e.name.startswith(prefix):
            lo = bisect.bisect_left(launches, e.time_range.start)
            hi = bisect.bisect_right(launches, e.time_range.end)
            out[e.name[len(prefix):]] = hi - lo
    return out


def detection_gt(rng, batch: int, max_gt: int, classes: int, scale=(1.0, 1.0)):
    """Padded ground truth (numpy): 1..max_gt boxes an image, [x1, y1, x2,
    y2] scaled by (width, height), labels in [1, classes), a validity mask."""
    import numpy as np

    n = rng.randint(1, max_gt + 1, size=batch)
    xy = rng.uniform(0.0, 0.7, (batch, max_gt, 2))
    wh = rng.uniform(0.04, 0.3, (batch, max_gt, 2))
    sx, sy = scale
    boxes = np.concatenate([xy, xy + wh], -1) * np.array([sx, sy, sx, sy])
    valid = np.arange(max_gt)[None, :] < n[:, None]
    labels = np.where(valid, rng.randint(1, classes, (batch, max_gt)), 0).astype(np.int32)
    return np.where(valid[..., None], boxes, 0.0).astype(np.float32), labels, valid


def ssd300_net(pt, cfg, head_only: bool = False):
    """SSD's multibox head over the source maps, then the mean ssd_loss of
    the batch's images (or, ``head_only``, the head's outputs)."""
    n_maps = len(cfg["maps"])

    def net(*args):
        locs, confs, boxes, variances = pt.layers.multi_box_head(
            list(args[:n_maps]), cfg["image"], cfg["classes"], cfg["min_sizes"], cfg["max_sizes"],
            [list(a) for a in cfg["aspect_ratios"]], flip=True)
        if head_only:
            return locs, confs, boxes, variances
        return ssd_batch_loss(pt, locs, confs, *args[n_maps:], boxes, variances)

    return net


def ssd_batch_loss(pt, locs, confs, gt, labels, valid, boxes, variances):
    """ssd_loss of each image (the op is single-image), averaged."""
    per = [pt.layers.ssd_loss(locs[i], confs[i], gt[i], labels[i], valid[i], boxes, variances)
           for i in range(locs.shape[0])]
    return sum(per) / len(per)


def rpn_net(pt, cfg, head_only: bool = False):
    """The RPN head on the conv5 map, then rpn_target_assign of each image
    against the anchors (the samplers given ``u`` [B, 2, A]) and the loss:
    sigmoid cross-entropy over the sampled anchors plus smooth L1 over the
    fg, each normalised by its count, averaged over images."""

    def net(feat, gt=None, valid=None, u=None):
        h = pt.layers.conv2d(feat, cfg["channels"], 3, padding=1, act="relu", name="rpn_conv")
        cls = pt.layers.conv2d(h, 12, 1, name="rpn_cls_score")
        box = pt.layers.conv2d(h, 48, 1, name="rpn_bbox_pred")
        if head_only:
            return cls, box
        anchors = pt.layers.anchor_generator(cfg["map"], device=feat.device)[0].reshape(-1, 4)
        total = 0.0
        for i in range(feat.shape[0]):
            labels, targets, loc_w, score_w = pt.layers.rpn_target_assign(
                anchors, gt[i], valid[i], None, cfg["per_im"], uniforms=u[i])
            ce = pt.layers.sigmoid_cross_entropy_with_logits(cls[i].reshape(-1), (labels == 1).float())
            sl1 = pt.layers.smooth_l1(box[i].reshape(-1, 4) * loc_w[:, None], targets * loc_w[:, None])
            total = total + ((ce * score_w).sum() / score_w.sum().clamp_min(1.0)
                             + sl1.sum() / loc_w.sum().clamp_min(1.0))
        return total / feat.shape[0]

    return net


def output_divergence(card, cpu, n_card: int, n_cpu: int, thr: float, by_class: bool) -> str:
    """One NMS output from the card and from the CPU on the same inputs (CPU
    tensors; rows [class,] score, x1, y1, x2, y2 in the output's order, the
    first ``n_*`` valid, then padding). "equal": every row agrees, padding
    included (classes exactly, scores and boxes each within
    CATALOG_FWD_TOL relative) and so do the counts. "near_tie": the first
    row that differs holds, on either side, a valid box whose IoU with an
    earlier box (of its class) is within DET_TIE_TOL relative of the NMS
    threshold ``thr``, or two valid detections with scores within
    DET_TIE_TOL relative of each other that swapped places (each is found
    in the other side's output). Else "other": a fault in the decode, the
    gather, the merge or the padding shows so. Rows before the first
    difference agree by construction."""
    from paddle_tpu_torch.ops.detection import iou_similarity

    c0 = 1 if by_class else 0

    def close(x, y):
        return float((x - y).norm()) <= CATALOG_FWD_TOL * max(float(y.norm()), 1e-30)

    def same(x, y):
        return (not by_class or x[0] == y[0]) and close(x[c0:c0 + 1], y[c0:c0 + 1]) and close(
            x[c0 + 1:], y[c0 + 1:])

    for j in range(cpu.shape[0]):
        a, b = card[j], cpu[j]
        if same(a, b):
            continue
        rows = [r for r, n in ((a, n_card), (b, n_cpu)) if j < n]
        if (len(rows) == 2 and abs(float(a[c0] - b[c0])) <= DET_TIE_TOL * abs(float(b[c0]))
                and any(same(a, r) for r in cpu[j + 1:n_cpu])
                and any(same(r, b) for r in card[j + 1:n_card])):
            return "near_tie"
        for r in rows:
            earlier = cpu[:j][cpu[:j, 0] == r[0]] if by_class else cpu[:j]
            iou = iou_similarity(r[None, c0 + 1:], earlier[:, c0 + 1:])
            if bool(((iou - thr).abs() <= DET_TIE_TOL * thr).any()):
                return "near_tie"
        return "other"
    return "equal" if n_card == n_cpu else "other"


def _det_train(pt, net, batch, dev: str, v0, lr: float):
    """DET_STEPS Adam steps of ``net`` on ``batch`` (numpy) on ``dev`` from
    the weights ``v0``: losses, step ms (host clock, synchronised), the
    final variables and optimizer state, the step function and the batch."""
    import torch

    model = pt.build(net)
    tb = [torch.from_numpy(a).to(dev) for a in batch]
    v = pt.Variables({k: t.to(dev) for k, t in v0.params.items()},
                     {k: t.to(dev) for k, t in v0.state.items()})
    opt = pt.optimizer.Adam(learning_rate=lr)
    state, step = opt.create_state(v.params), opt.minimize(model)
    losses, times = [], []
    for _ in range(DET_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = step(v, state, *tb)
        losses.append(float(out.loss))
        times.append(1e3 * (time.perf_counter() - t0))
        v, state = out.variables, out.opt_state
    return losses, times, v, state, step, tb


def _det_profiled(calls: dict) -> tuple:
    """Each callable of ``calls`` once, under a profiler of its own: {name:
    the kernels its session ran (device records, the markers left out)},
    and whether every session was intact (profile_intact)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    out, intact = {}, True
    for name, fn in calls.items():
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            profile_markers()
            fn()
            profile_markers()
        out[name] = sum(not n.startswith(("Memcpy", "Memset")) for n in device_records(prof))
        intact = intact and profile_intact(prof)
    return out, intact


def _peak_bytes(fn) -> int:
    """The card's peak allocated bytes over one call of ``fn``."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated()


def ssd300_part(pt, smi: str) -> tuple:
    """Phase catalog (e): SSD300's head trained on the card against the CPU,
    then its detections. Returns (the part's line, its checks)."""
    import numpy as np
    import torch

    from paddle_tpu_torch.ops import detection as det

    cfg = SSD300
    t_part = time.perf_counter()
    rng = np.random.RandomState(5)
    feats = [rng.randn(cfg["batch"], s, s, c).astype(np.float32) for s, c in cfg["maps"]]
    batch = (*feats, *detection_gt(rng, cfg["batch"], cfg["max_gt"], cfg["classes"]))
    net = ssd300_net(pt, cfg)
    v0 = pt.build(net).init(0, *(torch.from_numpy(a) for a in batch), device="cpu")
    cpu_l, _, _, _, _, _ = _det_train(pt, net, batch, "cpu", v0, SSD_LR)
    card_l, card_t, v, state, step, tb = _det_train(pt, net, batch, "cuda", v0, SSD_LR)
    rel = max(abs(a - b) / max(abs(b), 1e-12) for a, b in zip(card_l, cpu_l))
    checks = {"ssd300_card_vs_cpu": rel <= BOOK_LOSS_TOL, "ssd300_loss_falls": card_l[-1] < card_l[0],
              "ssd300_loss_finite": bool(np.isfinite(card_l).all())}
    peak_step = _peak_bytes(lambda: step(v, state, *tb))

    # the head's outputs, then ssd_loss's forward and backward apart
    n_maps = len(cfg["maps"])
    head = pt.build(ssd300_net(pt, cfg, head_only=True))
    with torch.no_grad():
        (locs, confs, boxes, variances), _ = head.apply(v.params, *tb[:n_maps])
    checks["ssd300_priors"] = locs.shape[1] == cfg["priors"] == boxes.shape[0]
    leaves = [locs.clone().requires_grad_(), confs.clone().requires_grad_()]
    gt_args = tb[n_maps:]
    held = {}

    def loss_fwd():
        held["loss"] = ssd_batch_loss(pt, *leaves, *gt_args, boxes, variances)

    def loss_bwd():
        torch.autograd.grad(held["loss"], leaves, retain_graph=True)

    launches, intact = _det_profiled({"ssd_step": lambda: step(v, state, *tb),
                                      "ssd_loss_fwd": loss_fwd, "ssd_loss_bwd": loss_bwd})
    fwd_ms, bwd_ms = min(best_step_ms(loss_fwd)), min(best_step_ms(loss_bwd))

    # detection_output and detection_map on the trained head
    probs = torch.softmax(confs, dim=-1)
    kw = dict(nms_threshold=cfg["nms"], nms_top_k=cfg["nms_top_k"], keep_top_k=cfg["keep_top_k"],
              score_threshold=cfg["score"])

    def detect(i, d="cuda"):
        return det.detection_output(*(t.to(d) for t in (locs[i], probs[i], boxes, variances)), **kw)

    def mean_ap(i, dets, n, d="cuda"):
        return float(det.detection_map(dets.to(d), n.to(d), *(t[i].to(d) for t in gt_args),
                                       cfg["classes"]))

    with torch.no_grad():
        outs = [detect(i) for i in range(cfg["batch"])]
        peak_det = _peak_bytes(lambda: detect(0))
        det_ms = best_step_ms(lambda: detect(0))
        det_launches, det_intact = _det_profiled({"detection_output": lambda: detect(0)})
        launches.update(det_launches)
        maps = [mean_ap(i, d, n) for i, (d, n) in enumerate(outs)]
        # card against CPU on the same inputs (the card's head outputs): the
        # outputs of detection_output, and detection_map of the card's
        # detections, on every checked image
        agree = {"equal": 0, "near_tie": 0, "other": 0}
        map_diff = 0.0
        for i in range(DET_CHECK_IMAGES):
            d_cpu, n_cpu = detect(i, "cpu")
            d_card, n_card = (t.cpu() for t in outs[i])
            agree[output_divergence(d_card, d_cpu, int(n_card), int(n_cpu), cfg["nms"], True)] += 1
            map_diff = max(map_diff, abs(mean_ap(i, d_card, n_card, "cpu") - maps[i]))
    checks["ssd300_detections_card_vs_cpu"] = agree["other"] == 0
    checks["ssd300_map_card_vs_cpu"] = map_diff <= 1e-6
    checks["ssd300_launch_counts_intact"] = intact and det_intact
    line = {"phase": "catalog", "part": "e_ssd300", "cfg": {k: cfg[k] for k in (
        "maps", "priors", "classes", "batch", "max_gt", "nms_top_k", "keep_top_k")},
        "card_losses": card_l, "cpu_losses": cpu_l, "max_rel_diff": rel, "loss_tol": BOOK_LOSS_TOL,
        "step_ms": min(card_t[1:]), "step_ms_runs": card_t, "launches_per_step": launches["ssd_step"],
        "ssd_loss_fwd_launches": launches["ssd_loss_fwd"],
        "ssd_loss_bwd_launches": launches["ssd_loss_bwd"],
        "ssd_loss_fwd_launches_per_image": launches["ssd_loss_fwd"] / cfg["batch"],
        "ssd_loss_fwd_ms": fwd_ms, "ssd_loss_bwd_ms": bwd_ms,
        "detection_output_ms_per_image": min(det_ms),
        "detection_output_launches_per_image": launches["detection_output"],
        "detections_per_image": [int(n) for _, n in outs], "map_per_image": maps,
        "map_card_vs_cpu_max_abs_diff": map_diff, "detections_card_vs_cpu": agree,
        "peak_memory_bytes_step": peak_step, "peak_memory_bytes_detection_output": peak_det,
        "seconds": time.perf_counter() - t_part, "card": smi}
    return line, checks


def rpn_part(pt, smi: str) -> tuple:
    """Phase catalog (f): Faster R-CNN's RPN trained on the card against the
    CPU, then its proposals and their labels. Returns (the part's line, its
    checks)."""
    import numpy as np
    import torch

    from paddle_tpu_torch.ops import detection_rpn as rpn

    cfg = RPN_CFG
    t_part = time.perf_counter()
    rng = np.random.RandomState(6)
    h, w = cfg["map"]
    img_h, img_w = cfg["image"]
    feat = rng.randn(cfg["batch"], h, w, cfg["channels"]).astype(np.float32)
    gt, labels, valid = detection_gt(rng, cfg["batch"], cfg["max_gt"], cfg["classes"], (img_w, img_h))
    u = rng.uniform(0, 1, (cfg["batch"], 2, cfg["anchors"])).astype(np.float32)
    batch = (feat, gt, valid, u)
    net = rpn_net(pt, cfg)
    v0 = pt.build(net).init(0, *(torch.from_numpy(a) for a in batch), device="cpu")
    cpu_l, _, _, _, _, _ = _det_train(pt, net, batch, "cpu", v0, RPN_LR)
    card_l, card_t, v, state, step, tb = _det_train(pt, net, batch, "cuda", v0, RPN_LR)
    rel = max(abs(a - b) / max(abs(b), 1e-12) for a, b in zip(card_l, cpu_l))
    checks = {"rpn_card_vs_cpu": rel <= BOOK_LOSS_TOL, "rpn_loss_falls": card_l[-1] < card_l[0],
              "rpn_loss_finite": bool(np.isfinite(card_l).all())}
    peak_step = _peak_bytes(lambda: step(v, state, *tb))

    anchors, variances = (t.reshape(-1, 4)
                          for t in pt.layers.anchor_generator(cfg["map"], device="cuda"))
    checks["rpn_anchors"] = anchors.shape[0] == cfg["anchors"]
    head = pt.build(rpn_net(pt, cfg, head_only=True))
    with torch.no_grad():
        (cls, box), _ = head.apply(v.params, tb[0])
    scores, deltas = torch.sigmoid(cls[0].reshape(-1)), box[0].reshape(-1, 4)
    kw = dict(pre_nms_top_n=cfg["pre_nms"], post_nms_top_n=cfg["post_nms"], nms_thresh=cfg["nms"])
    u_labels = torch.from_numpy(rng.uniform(0, 1, (2, cfg["post_nms"])).astype(np.float32))
    gt0 = [t[0] for t in (torch.from_numpy(gt), torch.from_numpy(labels), torch.from_numpy(valid))]

    def proposals(d="cuda"):
        ins = [t.to(d) for t in (scores, deltas, anchors, variances)]
        return rpn.generate_proposals(*ins, cfg["image"], **kw)

    def labels_of(props, d="cuda"):
        return rpn.generate_proposal_labels(props.to(d), *(t.to(d) for t in gt0), None,
                                            uniforms=u_labels.to(d))

    with torch.no_grad():
        props, pscores, count = proposals()
        peak_prop = _peak_bytes(proposals)
        prop_ms = best_step_ms(proposals)
        lab = labels_of(props)
        lab_ms = best_step_ms(lambda: labels_of(props))
        target, target_valid = gt0[0].cuda(), gt0[2].cuda()
        launches, intact = _det_profiled({
            "rpn_step": lambda: step(v, state, *tb),
            "rpn_target_assign": lambda: rpn.rpn_target_assign(anchors, target, target_valid, None,
                                                               cfg["per_im"], uniforms=tb[3][0]),
            "generate_proposals": proposals,
            "generate_proposal_labels": lambda: labels_of(props)})
        # card against CPU on the same inputs (the card's head outputs):
        # generate_proposals' own outputs, then generate_proposal_labels on
        # the card's proposals
        props_c, pscores_c, count_c = proposals("cpu")
        rows = [torch.cat([sc.cpu()[:, None], pr.cpu()], 1)
                for pr, sc in ((props, pscores), (props_c, pscores_c))]
        res = output_divergence(*rows, int(count), int(count_c), cfg["nms"], False)
        agree = {k: int(res == k) for k in ("equal", "near_tie", "other")}
        lab_c = labels_of(props, "cpu")
        labels_same = torch.equal(lab[0].cpu(), lab_c[0]) and all(
            _rel_l2(a.cpu(), b) <= CATALOG_FWD_TOL for a, b in zip(lab[1:], lab_c[1:]))
    checks["rpn_proposals_card_vs_cpu"] = agree["other"] == 0
    checks["rpn_proposal_labels_card_vs_cpu"] = labels_same
    checks["rpn_launch_counts_intact"] = intact
    line = {"phase": "catalog", "part": "f_rpn", "cfg": {k: cfg[k] for k in (
        "map", "channels", "anchors", "batch", "per_im", "pre_nms", "post_nms", "nms")},
        "card_losses": card_l, "cpu_losses": cpu_l, "max_rel_diff": rel, "loss_tol": BOOK_LOSS_TOL,
        "step_ms": min(card_t[1:]), "step_ms_runs": card_t, "launches_per_step": launches["rpn_step"],
        "rpn_target_assign_launches": launches["rpn_target_assign"],
        "generate_proposals_ms": min(prop_ms), "generate_proposals_launches": launches["generate_proposals"],
        "generate_proposal_labels_ms": min(lab_ms),
        "generate_proposal_labels_launches": launches["generate_proposal_labels"],
        "proposals": int(count), "fg_rois": int((lab[0] > 0).sum()), "bg_rois": int((lab[0] == 0).sum()),
        "proposals_card_vs_cpu": agree, "proposal_labels_equal": labels_same,
        "peak_memory_bytes_step": peak_step, "peak_memory_bytes_proposals": peak_prop,
        "seconds": time.perf_counter() - t_part, "card": smi}
    return line, checks


def catalog_phase(smi: str):
    """Phase 16: the Fluid catalog on the card. Returns the flash kernels'
    launches in (d) as a path, and the checks."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    import paddle_tpu_torch as pt
    from paddle_tpu_torch.core.config import set_flags
    from paddle_tpu_torch.ops import losses as olosses
    from paddle_tpu_torch.ops.cuda import build as kbuild

    t_phase = time.perf_counter()
    checks = {}
    set_flags(use_flash_attention=False, use_bf16_compute=False, check_nan_inf=False)

    # (a) the op sweep, card against the port on the CPU
    cases = catalog_sweep_cases()
    from paddle_tpu_torch.ops import (control_flow, detection, detection_rpn, losses, math, nn, nn3d,
                                      quant, vision)

    earlier_nn = {"conv2d", "pool2d", "softmax", "cross_entropy", "softmax_with_cross_entropy",
                  "square_error_cost", "accuracy", "layer_norm", "embedding_lookup", "dropout",
                  "adaptive_pool2d", "batch_norm_train", "batch_norm_infer", "one_hot",
                  "label_smooth"}
    names = (set(math.__all__) | (set(nn.__all__) - earlier_nn) | set(losses.__all__)
             | set(nn3d.__all__) | set(vision.__all__)
             | (set(control_flow.__all__) - {"BeamState"}) | set(detection.__all__)
             | set(detection_rpn.__all__) | set(quant.__all__) | {"multi_box_head"})
    swept = {c[0] for c in cases}
    unswept = sorted(n for n in names if not any(s == n or s.startswith(n + "_") for s in swept))
    checks["sweep_covers_every_function"] = not unswept
    rows, bad = [], []
    for name, fn, args, argnums, kind in cases:
        cpu_out, _ = _sweep_run(fn, args, (), "cpu")
        cts = [torch.from_numpy(np.asarray(np.random.RandomState(1).randn(*o.shape), np.float32))
               for o in cpu_out] if argnums else None
        if argnums:
            cpu_out, cpu_g = _sweep_run(fn, args, argnums, "cpu", cts)
            card_out, card_g = _sweep_run(fn, args, argnums, "cuda", cts)
        else:
            card_out, card_g = _sweep_run(fn, args, (), "cuda")
        tol = CATALOG_REC_TOL if kind == "rec" else CATALOG_FWD_TOL
        row = {"op": name, "kind": kind}
        ok = len(card_out) == len(cpu_out) and all(
            a.shape == b.shape and a.dtype == b.dtype for a, b in zip(card_out, cpu_out))
        if ok and kind == "random":
            ok = all(bool(torch.isfinite(a.float()).all()) for a in card_out)
        elif ok:
            errs = [_rel_l2_nan(a, b) if a.is_floating_point() else float(not torch.equal(a, b))
                    for a, b in zip(card_out, cpu_out)]
            row["fwd_rel_l2"] = max(errs)
            ok = all(e <= (tol if a.is_floating_point() else 0.0) for e, a in zip(errs, card_out))
            if argnums:
                row["grad_rel_l2"] = max(_rel_l2(a, b) for a, b in zip(card_g, cpu_g))
                ok = ok and row["grad_rel_l2"] <= CATALOG_GRAD_TOL
        row["ok"] = ok
        if not ok:
            bad.append(name)
        ts = [torch.as_tensor(a).cuda() for a in args]
        ns = _catalog_namespace("cuda")
        with torch.no_grad():
            row["ms"] = time_ms(lambda: fn(ns, *ts), 10, sleep_cycles=5_000_000)
        rows.append(row)
    # launches per call: every op once more under the profiler, one range each
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        ns = _catalog_namespace("cuda")
        for name, fn, args, _, _ in cases:
            ts = [torch.as_tensor(a).cuda() for a in args]
            torch.cuda.synchronize()
            with torch.no_grad(), record_function("catalog:" + name):
                fn(ns, *ts)
                torch.cuda.synchronize()
    launches = launches_by_range(prof, "catalog:")
    for row in rows:
        row["launches"] = launches.get(row["op"])
    for row in rows:
        emit({"phase": "catalog", "part": "a_sweep", **row})
    slowest = sorted(rows, key=lambda r: -r["ms"])[:8]
    checks["sweep_card_vs_cpu_within_tol"] = not bad
    emit({"phase": "catalog", "part": "a_sweep_summary", "ops": len(rows), "failed": bad,
          "unswept": unswept, "fwd_tol": CATALOG_FWD_TOL, "rec_tol": CATALOG_REC_TOL,
          "grad_tol": CATALOG_GRAD_TOL,
          "slowest": [{k: r.get(k) for k in ("op", "ms", "launches")} for r in slowest],
          "launches_total": sum(r["launches"] or 0 for r in rows), "card": smi})

    # (b) the book's chapters, card against CPU from the same weights
    book = {}
    for chapter, (net, lr) in book_chapters(pt).items():
        batch = book_batch(chapter)
        model = pt.build(net)
        v0 = model.init(0, *(torch.from_numpy(np.array(a)) for a in batch), device="cpu")
        runs = {}
        for dev in ("cpu", "cuda"):
            tb = [torch.from_numpy(np.array(a)).to(dev) for a in batch]
            v = pt.Variables({k: t.to(dev) for k, t in v0.params.items()},
                             {k: t.to(dev) for k, t in v0.state.items()})
            opt = pt.optimizer.Adam(learning_rate=lr)
            state, step = opt.create_state(v.params), opt.minimize(model)
            losses_, times = [], []
            for _ in range(BOOK_STEPS):
                if dev == "cuda":
                    torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = step(v, state, *tb)
                losses_.append(float(out.loss))
                times.append(1e3 * (time.perf_counter() - t0))
                v, state = out.variables, out.opt_state
            runs[dev] = (losses_, times)
        (cpu_l, _), (card_l, card_t) = runs["cpu"], runs["cuda"]
        rel = max(abs(a - b) / max(abs(b), 1e-12) for a, b in zip(card_l, cpu_l))
        book[chapter] = {"card_losses": card_l, "cpu_losses": cpu_l, "max_rel_diff": rel,
                         "step_ms": min(card_t[1:])}
        checks[f"book_{chapter}_card_vs_cpu"] = rel <= BOOK_LOSS_TOL
        checks[f"book_{chapter}_loss_falls"] = card_l[-1] < card_l[0]
    emit({"phase": "catalog", "part": "b_book", "steps": BOOK_STEPS, "loss_tol": BOOK_LOSS_TOL,
          "chapters": book})

    # (c) the SRL tagger at the reference book's widths
    cfg = SRL_CFG
    batch = srl_batch(cfg)
    model = pt.build(srl_net(pt, cfg))
    tb = [torch.from_numpy(a).cuda() for a in batch]
    v = model.init(0, *tb)
    opt = pt.optimizer.Adam(learning_rate=SRL_LR)
    state, step = opt.create_state(v.params), opt.minimize(model)
    srl_losses = []
    for _ in range(SRL_STEPS):
        out = step(v, state, *tb)
        v, state = out.variables, out.opt_state
        srl_losses.append(float(out.loss))
    torch.cuda.reset_peak_memory_stats()
    step_ms = best_step_ms(lambda: step(v, state, *tb))
    peak = torch.cuda.max_memory_allocated()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function("catalog:srl_step"):
            step(v, state, *tb)
            torch.cuda.synchronize()
    (_, emissions), _ = model.apply(v, *tb)
    emissions = emissions.detach()
    lengths, target = tb[-1], tb[-2]
    crfw = v.params["crfw"]
    em_leaf = emissions.clone().requires_grad_()
    tr_leaf = crfw.detach().clone().requires_grad_()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof_crf:
        with record_function("catalog:crf"):
            nll = olosses.linear_chain_crf(em_leaf, target, lengths, tr_leaf).mean()
            torch.autograd.grad(nll, (em_leaf, tr_leaf))
            torch.cuda.synchronize()
    step_launches = launches_by_range(prof, "catalog:").get("srl_step")
    crf_launches = launches_by_range(prof_crf, "catalog:").get("crf")
    with torch.no_grad():
        tags_card, score_card = olosses.crf_decoding(emissions, lengths, crfw)
        tags_cpu, score_cpu = olosses.crf_decoding(emissions.cpu(), lengths.cpu(), crfw.cpu())
    tags_card = tags_card.cpu()
    same = bool(torch.equal(tags_card, tags_cpu))
    tie_gap = 0.0
    if not same:  # the card's path scored under the CPU's arithmetic against the CPU's best
        em_c, tr_c, len_c = emissions.cpu(), crfw.cpu(), lengths.cpu()

        def path_score(tags):
            return olosses._crf_scores(em_c, tags.long(), len_c, tr_c[0], tr_c[1], tr_c[2:])

        rows_diff = (tags_card != tags_cpu).any(dim=1)
        gap = (path_score(tags_cpu) - path_score(tags_card)).abs() / path_score(tags_cpu).abs()
        tie_gap = float(gap[rows_diff].max())
    words = int(lengths.sum())
    checks["srl_loss_falls"] = srl_losses[-1] < srl_losses[0]
    checks["srl_loss_finite"] = bool(np.isfinite(srl_losses).all())
    checks["srl_viterbi_card_vs_cpu"] = same or tie_gap <= SRL_TIE_TOL
    emit({"phase": "catalog", "part": "c_srl", "cfg": cfg, "words_per_batch": words,
          "params": sum(p.numel() for p in v.params.values()), "losses": srl_losses,
          "step_ms": min(step_ms), "step_ms_runs": step_ms, "words_per_s": words / min(step_ms) * 1e3,
          "launches_per_step": step_launches, "crf_fwd_bwd_launches": crf_launches,
          "peak_memory_bytes": peak, "viterbi_equal": same, "viterbi_tie_gap": tie_gap,
          "viterbi_best_score_max_abs_diff": float((score_card.cpu() - score_cpu).abs().max()),
          "card": smi})
    del v, state, out, emissions, em_leaf

    # (d) nets.scaled_dot_product_attention through the flash kernels
    b, t, width, heads = CATALOG_ATTN
    gen = torch.Generator(device="cuda").manual_seed(0)
    qkv = [torch.randn(b, t, width, generator=gen, device="cuda").to(torch.bfloat16)
           for _ in range(3)]
    cot = torch.randn(b, t, width, generator=gen, device="cuda")

    def attend(flash: bool):
        set_flags(use_flash_attention=flash, use_bf16_compute=True)
        ins = [x.detach().clone().requires_grad_() for x in qkv]
        out = pt.nets.scaled_dot_product_attention(*ins, num_heads=heads)
        grads = torch.autograd.grad((out.float() * cot).sum(), ins)
        torch.cuda.synchronize()
        return out.detach().float(), [g.float() for g in grads]

    attend(True)  # warm
    zero_kernel_counts()
    out_f, g_f = attend(True)
    attn_launches = kernel_launch_counts()
    out_c, g_c = attend(False)
    flash_ms = best_step_ms(lambda: attend(True))
    composed_ms = best_step_ms(lambda: attend(False))
    set_flags(use_flash_attention=True, use_bf16_compute=True)
    out_rel = _rel_l2(out_f, out_c)
    grad_rel = {n: _rel_l2(a, r) for n, a, r in zip("qkv", g_f, g_c)}
    for k in ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq"):
        checks[f"attention_{k}_launched_once"] = attn_launches.get(k) == 1
    checks["attention_out_vs_composed"] = out_rel <= TRAIN_GRAD_TOL
    checks["attention_grads_vs_composed"] = max(grad_rel.values()) <= TRAIN_GRAD_TOL
    emit({"phase": "catalog", "part": "d_attention", "shape": [b, t, width], "heads": heads,
          "dtype": "bfloat16", "launches": attn_launches, "out_rel_l2": out_rel,
          "grad_rel_l2": grad_rel, "tol": TRAIN_GRAD_TOL, "fwd_bwd_ms_flash": min(flash_ms),
          "fwd_bwd_ms_composed": min(composed_ms), "card": smi})
    del qkv, cot, out_f, out_c, g_f, g_c

    # (e) SSD300's head and (f) Faster R-CNN's RPN, f32
    set_flags(use_flash_attention=False, use_bf16_compute=False)
    for part in (ssd300_part, rpn_part):
        line, part_checks = part(pt, smi)
        emit(line)
        checks.update(part_checks)
    set_flags(use_flash_attention=True, use_bf16_compute=True)

    emit({"phase": "catalog", "seconds": time.perf_counter() - t_phase, "checks": checks})
    return {"catalog": attn_launches}, checks


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
    # each phase's seconds, printed beside the kernels: where the script's
    # time goes
    phase_s, t_mark = {}, [time.perf_counter()]

    def mark(name):
        now = time.perf_counter()
        phase_s[name] = round(now - t_mark[0], 1)
        t_mark[0] = now

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
    mark("device_build_kernel_slice_train")

    # 6. the trainer slice
    trainer_launches, trainer_checks = trainer_phase(smi)
    failures += [f"trainer check {k}" for k, good in trainer_checks.items() if not good]
    mark("trainer")

    # 7. the conv zoo
    conv_checks = conv_phase(smi)
    failures += [f"conv check {k}" for k, good in conv_checks.items() if not good]
    mark("conv")

    # 8. the NMT Transformer
    nmt_paths, nmt_checks = nmt_phase(smi)
    failures += [f"nmt check {k}" for k, good in nmt_checks.items() if not good]
    mark("nmt")

    # 9. the LSTM models and the beam search
    rnn_checks = rnn_phase(smi)
    failures += [f"rnn check {k}" for k, good in rnn_checks.items() if not good]
    mark("rnn")

    # 10. decode serving and generate_beam
    serve_paths, serve_checks = serve_phase(smi)
    failures += [f"serve check {k}" for k, good in serve_checks.items() if not good]
    mark("serve")

    # 10b. the rest of serving: disaggregated prefill/decode, the host KV
    # tier, DecodeFleet, the journal, the fleet rollup
    fleet_paths, fleet_checks = fleet_phase(smi)
    failures += [f"fleet check {k}" for k, good in fleet_checks.items() if not good]
    mark("fleet")

    # 10c. tensor-parallel replica groups: DecodeEngine(group=),
    # DecodeFleet.from_groups, handoffs across groups
    group_paths, group_checks = group_phase(smi)
    failures += [f"group check {k}" for k, good in group_checks.items() if not good]
    mark("group")

    # 11. data parallelism
    dp_paths, dp_checks = dp_phase(smi)
    failures += [f"dp check {k}" for k, good in dp_checks.items() if not good]
    mark("dp")

    # 12. the telemetry stack over the Trainer and the DecodeEngine
    telemetry_launches, telemetry_checks = telemetry_phase(smi)
    failures += [f"telemetry check {k}" for k, good in telemetry_checks.items() if not good]
    mark("telemetry")

    # 13. the inference-deployment slice
    infer_paths, infer_checks = infer_phase(smi)
    failures += [f"infer check {k}" for k, good in infer_checks.items() if not good]
    mark("infer")

    # 13b. the analysis slice: the model lint on meta, serving after it, the CLI
    analysis_paths, analysis_checks = analysis_phase(smi)
    failures += [f"analysis check {k}" for k, good in analysis_checks.items() if not good]
    mark("analysis")

    # 14. sequence and expert parallelism
    sp_paths, sp_checks = sp_phase(smi)
    failures += [f"sp check {k}" for k, good in sp_checks.items() if not good]
    mark("sp")

    # 15. tensor and pipeline parallelism
    mp_paths, mp_checks = mp_phase(smi)
    failures += [f"mp check {k}" for k, good in mp_checks.items() if not good]
    mark("mp")

    # 15b. elastic training: a lost rank, a dead rank 0, a regrow
    elastic_paths, elastic_checks = elastic_phase(smi)
    failures += [f"elastic check {k}" for k, good in elastic_checks.items() if not good]
    mark("elastic")

    # 16. the Fluid catalog: the op sweep, the book's chapters, the SRL
    # tagger at the book's widths, nets.scaled_dot_product_attention
    catalog_paths, catalog_checks = catalog_phase(smi)
    failures += [f"catalog check {k}" for k, good in catalog_checks.items() if not good]
    mark("catalog")

    # 17. kernels
    paths = {"generate": launches, "train_step": train_launches, "trainer": trainer_launches,
             **nmt_paths, **serve_paths, **fleet_paths, **group_paths, **dp_paths,
             "telemetry": telemetry_launches,
             **infer_paths, **analysis_paths, **sp_paths, **mp_paths, **elastic_paths, **catalog_paths}
    slice_numbers = case_numbers["slice"]
    numbers = {"flash_fwd": slice_numbers, **bwd_numbers["slice"]}
    extra = {n: {"design": DESIGNS[n],
                 "ratio_to_library": (numbers[n]["ms"] / numbers[n]["library_ms"]
                                      if numbers.get(n) else None),
                 "sass": sass_totals.get(n)}
             for n in DESIGNS}
    emit({"phase_seconds": phase_s, "total_seconds": round(sum(phase_s.values()), 1)})
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
