#!/usr/bin/env python3
"""Where the time goes in the PyTorch/CUDA port's serving, training and
trainer slices, on one GPU.

    python3 tools/torch_profile_generate.py [--mode generate|train|trainer|resnet|nmt|serve]
                                            [--prompts 8] [--prompt-len 1024]
                                            [--new-tokens 32] [--batch 64]
                                            [--trace-dir DIR]

Runs ``paddle_tpu_torch``'s transformer LM at ``BASE_CFG`` (random weights
from seed 0) with ``use_flash_attention`` and ``use_bf16_compute`` on, as
``chip_smoke.py`` does, then times and profiles its phases separately.

``--mode generate`` (the default), the two phases of ``generate()``:

  prefill — one ``CachedDecoder.prefill`` over the prompts;
  decode  — ``new_tokens - 1`` greedy ``CachedDecoder.step`` calls.

``--mode train``, one Adam step on ``prompts`` sequences of ``prompt-len``
tokens (bench.py's LM cell at the defaults) and its two halves:

  train_step     — ``opt.minimize(model)``'s step, as a trainer calls it;
  train_fwd_bwd  — the loss and every gradient (``append_backward``);
  train_optimizer — ``opt.apply_gradients`` on those gradients.

``--mode trainer``, the same step driven two ways with ``check_nan_inf``
on, each call one step on one batch:

  trainer_step — ``Trainer.train`` over a one-batch reader: events, the
                 Executor, the step, ``float(loss)`` and ``bool(finite)``;
  direct_step  — the step of ``minimize`` called directly, with the same
                 two reads of the loss and the finite flag.

``--mode resnet``, ResNet-50 at bench.py's cell (224×224, 1000 classes,
bf16 compute, Momentum, ``--batch`` images, random weights from seed 0):

  resnet_step      — ``opt.minimize(model)``'s step, BN state included;
  resnet_fwd_bwd   — the loss and every gradient (``append_backward``);
  resnet_optimizer — ``opt.apply_gradients`` on those gradients;

with the device time by class. The optimizer's share of a step is its own
phase's busy time.

``--mode nmt``, the NMT Transformer at bench.py's cell (``BASE_CFG``, 32
sequences of 256 tokens, bf16 compute, flash on, Adam + Noam, random
weights from seed 0):

  nmt_step          — ``minimize``'s step at the published dropouts (0.1),
                      drawing from a CUDA generator: attention composes;
  nmt_step_dropout0 — the same step with every dropout at 0: attention
                      runs the flash kernels;
  nmt_eval          — ``Model.apply`` with ``is_train=False`` (flash).

``--mode serve``, decode serving through ``serving.DecodeEngine`` at
``chip_smoke.py`` phase ``serve``'s configuration (f32 weights and pages,
greedy; ``max_slots=16, page_size=16, max_context=1024,
prefill_chunk=256``) and traffic (``--requests`` prompts of lengths uniform
in [16, 768] with max_new_tokens uniform in [8, 128], numpy seed 0):

  serve_burst       — every request submitted together to one engine, and
                      all of them waited for: prefill chunks and decode
                      steps interleaved on the engine's loop thread;
  serve_decode_step — one decode step at full occupancy (16 slots), as the
                      engine runs it: the inputs to the card, the step, the
                      sampled tokens back;

with the device time by kernel class: GEMMs, the page gather and the
page writes (indexing kernels), softmax, copies (the gathered context's
permute), other.

Each of ``--mode nmt``'s phases also splits the device time by the layer
that ran it (``by_layer``):
composed attention (``ops.attention.scaled_dot_product_attention`` less
its dropout), projections (``layers.fc``'s product), dropout
(``ops.nn.dropout``), LayerNorm (``ops.nn.layer_norm``), the flash
kernels, and other (embeddings, residual adds, the loss, the optimizer).
A forward kernel belongs to the innermost of those calls that launched
it; a backward kernel to the call whose forward op created its autograd
node (the profiler's sequence numbers link the two).

For each phase it prints one JSON line: the wall time without the profiler
(host clock around work that ends in ``torch.cuda.synchronize()``, the
median of five calls after a warm-up call, each call's time beside it), the
device time summed over the profiler's kernels (one stream, so the sum is
the busy time), the idle share ``1 - busy / wall``, the number of kernel
launches, and the device time by kernel class (matrix products, each flash
kernel, other) and by the top kernel names. With ``--trace-dir`` the
Chrome trace of each phase goes to ``DIR/profile_<phase>.json``. The
card's name and power limit are printed beside the numbers. Exits 1
without CUDA.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# calls timed without the profiler; wall_ms is their median
WALL_RUNS = 5


def _classify(name: str) -> str:
    low = name.lower()
    for kernel in ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq"):
        if kernel in low:
            return kernel
    # cuDNN's convolution kernels (their names also say gemm/xmma), before
    # the dense products
    if any(s in low for s in ("conv2d", "convolution", "fprop", "dgrad", "wgrad", "cudnn",
                              "implicit", "winograd")):
        return "conv"
    if "batch_norm" in low:
        return "bn"
    if any(s in low for s in ("gemm", "gemv", "cutlass", "xmma", "sm90_", "cublas", "nvjet")):
        return "matmul"
    if any(s in low for s in ("copy", "transpose", "nchwtonhwc", "nhwctonchw", "permute")):
        return "copy"
    return "other"


def _op_class(evt) -> str:
    """The class of the PyTorch op that launched a kernel: the innermost op,
    or for an op of no class the nearest ancestor that has one (cuDNN runs
    some 1x1 convolutions as cuBLAS GEMMs, so kernel names alone would put
    them with the dense products)."""
    node = evt
    while node is not None:
        low = node.name.lower()
        if "convolution" in low:
            return "conv"
        if "batch_norm" in low:
            return "bn"
        if low in ("aten::mm", "aten::addmm", "aten::bmm", "aten::matmul"):
            return "matmul"
        if low in ("aten::copy_", "aten::_to_copy", "aten::clone", "aten::contiguous"):
            return "copy"
        node = node.cpu_parent
    return "other"


def _device_us(evt) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    return 0.0


def _serve_classify(name: str) -> str:
    """Kernel classes of the decode engine's work."""
    low = name.lower()
    if any(s in low for s in ("gemm", "gemv", "cutlass", "xmma", "sm90_", "cublas", "nvjet")):
        return "gemm"
    if any(s in low for s in ("index", "gather", "scatter")):
        return "page_gather"
    if "softmax" in low:
        return "softmax"
    if any(s in low for s in ("copy", "transpose", "permute")):
        return "copy"
    return "other"


def _profile(fn, name: str, trace_dir, by_layer: bool = False, classify=_classify) -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()  # warm
    torch.cuda.synchronize()
    wall_runs = []
    for _ in range(WALL_RUNS):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_runs.append(1e3 * (time.perf_counter() - t0))
    wall_ms = sorted(wall_runs)[len(wall_runs) // 2]

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    layer_ms = _by_layer(prof) if by_layer else None
    if trace_dir:
        prof.export_chrome_trace(os.path.join(trace_dir, f"profile_{name}.json"))
    by_class: dict = {}
    matmul_kernels: dict = {}
    rows = []
    launches = 0
    for evt in prof.key_averages():
        # kernels only: a CPU op's self device time repeats its kernels', and
        # a record_function range's device-side span covers them again
        us = _device_us(evt)
        if (us <= 0 or "CUDA" not in str(getattr(evt, "device_type", ""))
                or getattr(evt, "is_user_annotation", False)):
            continue
        launches += evt.count
        cls = classify(evt.key)
        by_class[cls] = by_class.get(cls, 0.0) + us / 1e3
        if cls in ("matmul", "gemm"):
            matmul_kernels[evt.key[:120]] = matmul_kernels.get(evt.key[:120], 0) + evt.count
        rows.append((us / 1e3, evt.count, evt.key[:120]))
    rows.sort(reverse=True)
    busy_ms = sum(by_class.values())
    by_op: dict = {}
    for evt in prof.events():
        for kern in getattr(evt, "kernels", ()):
            cls = _op_class(evt)
            by_op[cls] = by_op.get(cls, 0.0) + kern.duration / 1e3
    out = {
        "phase": name,
        "wall_ms": wall_ms,
        "wall_ms_runs": wall_runs,
        "device_busy_ms": busy_ms,
        "idle_share": (1.0 - busy_ms / wall_ms) if wall_ms > 0 and busy_ms > 0 else None,
        "kernel_launches": launches,
        "device_ms_by_class": by_class,
        "device_ms_by_launching_op": by_op,
        "matmul_kernels": matmul_kernels,
        "top_kernels": [{"ms": ms, "count": n, "name": k} for ms, n, k in rows[:8]],
    }
    if layer_ms is not None:
        out["device_ms_by_layer"] = layer_ms
    return out


def _train(spec, rng, args, smi) -> None:
    from paddle_tpu_torch.backward import append_backward

    ids, labels = spec.synth_batch(args.prompts, rng)
    variables = spec.model.init(0, ids, labels)
    opt = spec.optimizer()
    opt_state = opt.create_state(variables.params)
    step = opt.minimize(spec.model)
    grads = append_backward(spec.model, ids, labels)(variables.params)[1][0]
    phases = (
        ("train_step", lambda: step(variables, opt_state, ids, labels)),
        ("train_fwd_bwd", lambda: append_backward(spec.model, ids, labels)(variables.params)),
        ("train_optimizer", lambda: opt.apply_gradients(
            variables.params, grads, opt_state, spec.model.param_info)),
    )
    for name, fn in phases:
        line = _profile(fn, name, args.trace_dir)
        line.update(batch=args.prompts, seq_len=args.prompt_len, card=smi)
        if name == "train_step":
            line["tokens_per_s"] = args.prompts * args.prompt_len / (line["wall_ms"] / 1e3)
        print(json.dumps(line), flush=True)


def _trainer(spec, rng, args, smi) -> None:
    from paddle_tpu_torch.core.config import set_flags
    from paddle_tpu_torch.trainer import Trainer

    set_flags(check_nan_inf=True)
    batch = spec.synth_batch(args.prompts, rng)
    trainer = Trainer(lambda: spec.model, spec.optimizer)
    trainer.variables = spec.model.init(0, *batch)
    trainer.opt_state = trainer.optimizer.create_state(trainer.variables.params)
    step = spec.optimizer().minimize(spec.model)
    state = {"v": trainer.variables, "s": trainer.opt_state}

    def direct():
        out = step(state["v"], state["s"], *batch)
        float(out.loss), bool(out.finite)
        state["v"], state["s"] = out.variables, out.opt_state

    phases = (
        ("trainer_step", lambda: trainer.train(num_epochs=1, reader=lambda: iter([batch]))),
        ("direct_step", direct),
    )
    for name, fn in phases:
        line = _profile(fn, name, args.trace_dir)
        line.update(batch=args.prompts, seq_len=args.prompt_len, check_nan_inf=True, card=smi)
        line["tokens_per_s"] = args.prompts * args.prompt_len / (line["wall_ms"] / 1e3)
        print(json.dumps(line), flush=True)


def _resnet(args, smi) -> None:
    import numpy as np

    from paddle_tpu_torch.backward import append_backward
    from paddle_tpu_torch.models import get_model

    spec = get_model("resnet", dataset="flowers", depth=50, class_dim=1000)
    x, y = spec.synth_batch(args.batch, np.random.RandomState(0))
    variables = spec.model.init(0, x, y)
    opt = spec.optimizer()
    opt_state = opt.create_state(variables.params)
    step = opt.minimize(spec.model)
    grads = append_backward(spec.model, x, y, state=variables.state)(variables.params)[1][0]
    phases = (
        ("resnet_step", lambda: step(variables, opt_state, x, y)),
        ("resnet_fwd_bwd", lambda: append_backward(spec.model, x, y, state=variables.state)(
            variables.params)),
        ("resnet_optimizer", lambda: opt.apply_gradients(
            variables.params, grads, opt_state, spec.model.param_info)),
    )
    for name, fn in phases:
        line = _profile(fn, name, args.trace_dir)
        line.update(batch=args.batch, image_size=224, card=smi)
        if name == "resnet_step":
            line["images_per_s"] = args.batch / (line["wall_ms"] / 1e3)
        print(json.dumps(line), flush=True)


_LAYER_PREFIX = "layer."


def _wrap_layers():
    """Wrap the NMT's layer entry points in profiler ranges named
    ``layer.<name>``; returns a function that undoes it."""
    import torch

    from paddle_tpu_torch import layers
    from paddle_tpu_torch.ops import attention, nn

    targets = [(attention, "scaled_dot_product_attention", "attention"),
               (nn, "dropout", "dropout"), (nn, "layer_norm", "layer_norm"),
               (layers, "f32_matmul", "projection")]
    saved = []
    for mod, attr, label in targets:
        real = getattr(mod, attr)

        def wrapped(*a, _real=real, _label=label, **k):
            with torch.profiler.record_function(_LAYER_PREFIX + _label):
                return _real(*a, **k)

        saved.append((mod, attr, real))
        setattr(mod, attr, wrapped)

    def undo():
        for mod, attr, real in saved:
            setattr(mod, attr, real)

    return undo


def _by_layer(prof) -> dict:
    """Device ms by layer: each kernel goes to the innermost ``layer.*``
    range around the op that launched it, or, for a backward kernel, to the
    range around the forward op whose sequence number its autograd node
    carries; flash kernels by their names."""
    events = prof.events()

    def label_of(evt):
        node = evt
        while node is not None:
            if node.name.startswith(_LAYER_PREFIX):
                return node.name[len(_LAYER_PREFIX):]
            node = node.cpu_parent
        return None

    fwd_label = {}
    for evt in events:
        seq = getattr(evt, "sequence_nr", -1)
        if seq >= 0 and not evt.name.startswith("autograd::engine"):
            label = label_of(evt)
            if label is not None:
                fwd_label.setdefault(seq, label)
    out: dict = {}
    for evt in events:
        for kern in getattr(evt, "kernels", ()):
            name = kern.name.lower()
            label = "flash" if "flash_" in name else label_of(evt)
            if label is None:
                node = evt
                while node is not None and not node.name.startswith("autograd::engine::evaluate_function"):
                    node = node.cpu_parent
                if node is not None:
                    label = fwd_label.get(getattr(node, "sequence_nr", -1))
            label = label or "other"
            out[label] = out.get(label, 0.0) + kern.duration / 1e3
    return out


def _nmt(args, smi) -> None:
    import numpy as np
    import torch

    from paddle_tpu_torch.models import get_model

    seq_len, batch_size = 256, 32
    spec = get_model("transformer", seq_len=seq_len, scan_layers=True)
    spec0 = get_model("transformer", seq_len=seq_len, scan_layers=True, attn_dropout=0.0,
                      relu_dropout=0.0, residual_dropout=0.0)
    batch = spec.synth_batch(batch_size, np.random.RandomState(0))
    variables = spec.model.init(0, *batch)
    opt = spec.optimizer()
    opt_state = opt.create_state(variables.params)
    step, step0 = opt.minimize(spec.model), opt.minimize(spec0.model)
    gen = torch.Generator(device="cuda").manual_seed(0)

    def evaluate():
        with torch.no_grad():
            return spec.model.apply(variables, *batch)

    phases = (
        ("nmt_step", lambda: step(variables, opt_state, *batch, rng=gen)),
        ("nmt_step_dropout0", lambda: step0(variables, opt_state, *batch)),
        ("nmt_eval", evaluate),
    )
    for name, fn in phases:
        undo = _wrap_layers()
        try:
            line = _profile(fn, name, args.trace_dir, by_layer=True)
        finally:
            undo()
        line.update(batch=batch_size, seq_len=seq_len, card=smi)
        line["tokens_per_s"] = batch_size * seq_len / (line["wall_ms"] / 1e3)
        print(json.dumps(line), flush=True)


def _serve(args, smi) -> None:
    import numpy as np
    import torch

    from paddle_tpu_torch.core.config import set_flags
    from paddle_tpu_torch.models import get_model
    from paddle_tpu_torch.serving import DecodeConfig, DecodeEngine

    set_flags(use_bf16_compute=False)  # the reference serves in f32
    spec = get_model("transformer_lm")
    cfg = spec.extra["cfg"]
    params = spec.model.init(0, *spec.synth_batch(1, np.random.RandomState(0))).params
    rng = np.random.RandomState(0)
    lens = rng.randint(16, 769, size=args.requests)
    mnts = rng.randint(8, 129, size=args.requests)
    reqs = [(rng.randint(1, cfg["vocab"], size=(int(n),)).astype(np.int32), int(m))
            for n, m in zip(lens, mnts)]
    dconf = DecodeConfig(max_slots=16, page_size=16, max_context=1024, prefill_chunk=256)
    engine = DecodeEngine(params, cfg, decode=dconf)
    S, P = dconf.max_slots, dconf.max_context // dconf.page_size
    tables = (1 + np.arange(S * P, dtype=np.int32)).reshape(S, P)
    positions = np.full((S,), dconf.max_context * 11 // 16, np.int32)
    tokens = rng.randint(1, cfg["vocab"], size=(S,)).astype(np.int32)

    def burst():
        handles = [engine.submit(p, n) for p, n in reqs]
        for h in handles:
            h.result(timeout=600)

    def one_step():
        with torch.no_grad():
            return engine._step_call(engine._dev(tokens), engine._dev(positions),
                                     engine._dev(tables)).cpu()

    try:
        before = engine.metrics.snapshot()
        line = _profile(burst, "serve_burst", args.trace_dir, classify=_serve_classify)
        after = engine.metrics.snapshot()
        runs = 1 + WALL_RUNS + 1  # warm-up, timed, profiled
        generated = int(sum(mnts))
        line.update(requests=args.requests, generated_tokens=generated,
                    generated_tokens_per_s=generated / (line["wall_ms"] / 1e3),
                    decode_steps_per_burst=(after["steps_total"] - before["steps_total"]) / runs,
                    prefill_chunks_per_burst=(after["prefill_chunks_total"]
                                              - before["prefill_chunks_total"]) / runs,
                    preemptions_per_burst=(after["preempted_total"]
                                           - before["preempted_total"]) / runs, card=smi)
        print(json.dumps(line), flush=True)
        line = _profile(one_step, "serve_decode_step", args.trace_dir, classify=_serve_classify)
        line.update(slots=S, table_width=P, position=int(positions[0]), card=smi)
        print(json.dumps(line), flush=True)
    finally:
        engine.close(timeout=600)
    engine.kv.assert_no_leaks()


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_profile_generate: CUDA is not available; nothing was run", file=sys.stderr)
        return 1
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--mode", choices=("generate", "train", "trainer", "resnet", "nmt", "serve"),
                    default="generate")
    ap.add_argument("--requests", type=int, default=48, help="requests per burst (--mode serve)")
    ap.add_argument("--batch", type=int, default=64, help="images per ResNet-50 step (--mode resnet)")
    ap.add_argument("--prompts", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=1024)
    ap.add_argument("--new-tokens", type=int, default=32)
    ap.add_argument("--trace-dir", default=None, help="write each phase's Chrome trace here")
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    import numpy as np

    from paddle_tpu_torch.core.config import set_flags
    from paddle_tpu_torch.models import get_model, transformer_lm

    if args.trace_dir:
        os.makedirs(args.trace_dir, exist_ok=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)

    set_flags(use_flash_attention=True, use_bf16_compute=True)
    if args.mode in ("resnet", "nmt", "serve"):
        {"resnet": _resnet, "nmt": _nmt, "serve": _serve}[args.mode](args, smi)
        print(smi, flush=True)
        return 0
    spec = get_model("transformer_lm", seq_len=args.prompt_len)
    cfg = spec.extra["cfg"]
    rng = np.random.RandomState(0)
    if args.mode in ("train", "trainer"):
        (_train if args.mode == "train" else _trainer)(spec, rng, args, smi)
        print(smi, flush=True)
        return 0
    params = spec.model.init(0, *spec.synth_batch(1, rng)).params
    prompts = torch.as_tensor(
        rng.randint(1, cfg["vocab"], size=(args.prompts, args.prompt_len)).astype(np.int32),
        device="cuda")
    t_max = args.prompt_len + args.new_tokens
    with torch.no_grad():
        dec = transformer_lm.CachedDecoder(params, cfg, args.prompts, t_max)
        first = torch.argmax(dec.prefill(prompts), -1)

        def decode():
            tok = first
            for s in range(args.new_tokens - 1):
                tok = torch.argmax(dec.step(tok, args.prompt_len + s), -1)
            return tok

        for name, fn in (("prefill", lambda: dec.prefill(prompts)), ("decode", decode)):
            line = _profile(fn, name, args.trace_dir)
            line.update(prompts=args.prompts, prompt_len=args.prompt_len,
                        new_tokens=args.new_tokens, card=smi)
            print(json.dumps(line), flush=True)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
