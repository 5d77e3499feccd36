"""Benchmark CLI — the ``fluid_benchmark.py`` equivalent, port of
``paddle_tpu/benchmark.py``.

Reference: ``benchmark/fluid/fluid_benchmark.py:310`` (main: get_model,
train loop printing examples/sec per pass at ``:295-301``) and
``benchmark/fluid/args.py`` (flag surface). The JAX package's flags, model
list and JSON record keys are kept. What differs:

- ``--device`` is ``GPU`` (the default: CUDA, which must be present) or
  ``CPU``;
- ``--chips``/``--gpus N > 1`` runs ``parallel.DataParallel`` over N ranks
  (the GLOBAL batch split over them): ranks already in a process group
  (``torchrun``, or ``--update_method nccl2``/``collective`` through
  ``parallel.mesh.initialize_distributed``) run there; otherwise the CLI
  starts N ranks through ``parallel.launch.spawn`` (one per card over
  NCCL, gloo with ``--device CPU``), which raises before starting any rank
  where there are fewer cards than N. Rank 0 prints the records;
- ``--profile`` writes a ``torch.profiler`` trace (``trace.chrome.json``)
  and the host spans (``timeline.chrome.json``) to ``--profile_dir`` for
  the first pass, and prints ``core.profiler``'s per-step dispatch and
  device-wait breakdown;
- a training step draws its dropout masks from a ``torch.Generator`` on
  the step's device (seed 0 with ``--no_random``), as bench.py feeds its
  steps a key;
- ``--scan_layers`` reaches the transformer models, which run it as their
  plain layer loop; ``--moe_experts > 0`` trains the LM with
  mixture-of-experts FFNs (``parallel/moe.py``);
- ``--use_real_data`` raises ``NotImplementedError``: the dataset modules
  it reads need a download (``ROADMAP.md`` §A item 10).

The timed region of a pass ends on a host read of the last loss.

Usage:
    python -m paddle_tpu_torch.benchmark --model resnet --batch_size 64 \\
        --iterations 20 --pass_num 2
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import numpy as np

BENCHMARK_MODELS = [
    "machine_translation",
    "resnet",
    "se_resnext",
    "vgg",
    "mnist",
    "stacked_dynamic_lstm",
    "transformer",
    # decoder-only LM: the long-context flagship (not in the reference's
    # benchmark set — its list ends at the NMT transformer)
    "transformer_lm",
]


def parse_args(argv=None):
    parser = argparse.ArgumentParser("paddle_tpu_torch model benchmarks.")
    parser.add_argument("--model", type=str, choices=BENCHMARK_MODELS, default="resnet")
    parser.add_argument("--batch_size", type=int, default=32, help="per-step GLOBAL batch")
    parser.add_argument("--learning_rate", type=float, default=0.001)
    parser.add_argument("--skip_batch_num", type=int, default=5,
                        help="warmup steps excluded from timing (first-call costs)")
    parser.add_argument("--iterations", type=int, default=80, help="steps per pass")
    parser.add_argument("--pass_num", type=int, default=1)
    parser.add_argument("--device", type=str, default="GPU", choices=["CPU", "GPU"],
                        help="device to place the benchmark on")
    parser.add_argument("--chips", "--gpus", dest="chips", type=int, default=1,
                        help="data-parallel ranks; >1 uses the DataParallel path")
    parser.add_argument("--data_set", type=str, default="flowers",
                        choices=["cifar10", "flowers", "mnist"],
                        help="image models' shape: flowers (224, 102 classes) or cifar10")
    parser.add_argument("--infer_only", action="store_true", help="forward only")
    parser.add_argument("--use_real_data", action="store_true",
                        help="feed from the dataset readers (not ported: needs a download)")
    parser.add_argument("--profile", action="store_true",
                        help="write a torch.profiler trace of the first pass")
    parser.add_argument("--profile_dir", type=str,
                        default=os.path.join(tempfile.gettempdir(), "paddle_tpu_torch_profile"))
    parser.add_argument("--update_method", type=str, default="local",
                        choices=["local", "collective", "nccl2"],
                        help="'collective'/'nccl2': join the process group from the environment")
    parser.add_argument("--no_random", action="store_true")
    parser.add_argument("--json", action="store_true", help="print one JSON line per pass")
    parser.add_argument("--scan_layers", action="store_true",
                        help="transformer/transformer_lm: the JAX package's scanned layer "
                             "stack (the port runs the plain layer loop)")
    parser.add_argument("--moe_experts", type=int, default=0,
                        help="transformer_lm: expert-parallel MoE FFN (not ported)")
    return parser.parse_args(argv)


def _make_batch(args, spec, rng):
    """One benchmark batch: synthetic, made once and reused (the metric
    isolates step compute, as the reference's fake-data mode did)."""
    if args.use_real_data:
        raise NotImplementedError(
            "--use_real_data: the dataset readers it feeds from need a download and are not "
            "ported to paddle_tpu_torch (ROADMAP.md §A item 10); drop the flag for "
            "synthetic batches")
    return spec.synth_batch(args.batch_size, rng)


def _model_cfg(args, device) -> dict:
    model_cfg = {"learning_rate": args.learning_rate, "device": device}
    if args.model in ("resnet", "vgg", "se_resnext"):
        model_cfg["dataset"] = args.data_set
        if args.data_set == "cifar10":
            model_cfg.update(image_size=32, class_dim=10)
        elif args.data_set == "flowers":
            model_cfg.update(image_size=224, class_dim=102)
    if args.scan_layers and args.model in ("transformer", "transformer_lm"):
        model_cfg["scan_layers"] = True
    if args.moe_experts and args.model == "transformer_lm":
        model_cfg["moe_experts"] = args.moe_experts
    return model_cfg


def _rank_main(rank: int, arg_dict: dict) -> dict:
    """One spawned rank of a ``--chips N`` run (in its process group)."""
    return run_benchmark(argparse.Namespace(**arg_dict))


class _FwdOut:  # step-protocol shim for the forward-only path
    def __init__(self, v, o, loss):
        self.variables, self.opt_state, self.loss = v, o, loss


def _first(out):
    return out[0] if isinstance(out, (tuple, list)) else out


def run_benchmark(args, variables=None) -> dict:
    """Run the benchmark ``args`` describe; returns the last pass's record.
    ``variables`` (single-rank runs): the weights to start from instead of
    ``Model.init``'s (the tests carry the JAX package's across)."""
    import torch
    import torch.distributed as dist

    from paddle_tpu_torch import models
    from paddle_tpu_torch.core import profiler as prof
    from paddle_tpu_torch.executor import to_device
    from paddle_tpu_torch.parallel import mesh as mesh_mod

    device = "cuda" if args.device == "GPU" else "cpu"
    if args.update_method in ("collective", "nccl2") and not dist.is_initialized():
        mesh_mod.initialize_distributed(device=device)
    in_group = dist.is_initialized() and dist.get_world_size() > 1
    if args.chips > 1 and not in_group:
        from paddle_tpu_torch.parallel import launch

        return launch.spawn(_rank_main, args.chips, args=(vars(args),), device=device)[0]
    rank = dist.get_rank() if in_group else 0
    if in_group:
        if args.chips != dist.get_world_size():
            raise ValueError(f"--chips {args.chips} but the process group has "
                             f"{dist.get_world_size()} ranks")
        dev = mesh_mod.process_device() or torch.device(device)
    else:
        from paddle_tpu_torch.core.config import resolve_device

        dev = resolve_device(device)

    spec = models.get_model(args.model, **_model_cfg(args, dev))
    rng = np.random.RandomState(0 if args.no_random else None)
    batch = _make_batch(args, spec, rng)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0 if args.no_random else int(rng.randint(2 ** 31)))

    if in_group:
        from paddle_tpu_torch.parallel import DataParallel
        from paddle_tpu_torch.parallel.mesh import make_mesh

        dp = DataParallel(spec.model, spec.optimizer(),
                          mesh=make_mesh({"data": args.chips}), device=dev)
        variables, opt_state = dp.init(0, *batch)
        dev_batch = dp.put_batch(*batch)
        if args.infer_only:
            def step(v, o):
                return _FwdOut(v, o, _first(dp.eval_step(v, *dev_batch)))
        else:
            def step(v, o):
                return dp.step(v, o, *dev_batch, rng=gen)
    else:
        dev_batch = tuple(to_device(b, dev) for b in batch)
        if variables is None:
            variables = spec.model.init(0, *dev_batch, device=dev)
        optimizer = spec.optimizer()
        opt_state = optimizer.create_state(variables.params)
        if args.infer_only:
            def step(v, o):
                with torch.no_grad():
                    out, _ = spec.model.apply(v, *dev_batch, is_train=False)
                return _FwdOut(v, o, _first(out))
        else:
            step_fn = optimizer.minimize(spec.model)

            def step(v, o):
                return step_fn(v, o, *dev_batch, rng=gen)

    results = []
    for pass_id in range(args.pass_num):
        out = None
        for _ in range(max(1, args.skip_batch_num)):  # >= 1 warm step
            out = step(variables, opt_state)
            variables, opt_state = out.variables, out.opt_state
        float(out.loss)

        profiled = args.profile and pass_id == 0
        if profiled:
            prof.start_profiler(args.profile_dir)
        t0 = time.perf_counter()
        try:
            with prof.record_event(f"benchmark.pass_{pass_id}"):
                if profiled:
                    # per-step host dispatch vs device wait, synced each step
                    # so the phases are attributable
                    for _ in range(args.iterations):
                        with prof.record_event("benchmark.step_dispatch"):
                            out = step(variables, opt_state)
                            variables, opt_state = out.variables, out.opt_state
                        with prof.record_event("benchmark.device_wait"):
                            float(out.loss)
                else:
                    for _ in range(args.iterations):
                        out = step(variables, opt_state)
                        variables, opt_state = out.variables, out.opt_state
                    float(out.loss)
            dt = time.perf_counter() - t0
        finally:
            table = prof.stop_profiler() if profiled else None
        last_loss = float(out.loss)
        if profiled and rank == 0:
            print(f"trace: {os.path.join(args.profile_dir, 'trace.chrome.json')}")
            print(f"timeline: {os.path.join(args.profile_dir, 'timeline.chrome.json')}")
            breakdown = prof.step_breakdown(table)
            for phase, mean_s in sorted(breakdown.items(), key=lambda kv: -kv[1]):
                print(f"  {phase:24s} {mean_s * 1e3:9.3f} ms/step")
        examples_per_sec = args.batch_size * args.iterations / dt
        record = {
            "pass": pass_id,
            "model": args.model,
            "batch_size": args.batch_size,
            "chips": args.chips,
            "examples_per_sec": round(examples_per_sec * spec.examples_per_row, 2),
            "unit": spec.unit,
            "last_loss": last_loss,
            "elapsed_sec": round(dt, 3),
        }
        results.append(record)
        if rank == 0:
            if args.json:
                print(json.dumps(record), flush=True)
            else:
                print(f"Pass: {pass_id}, Loss: {record['last_loss']:.5f}, "
                      f"Speed: {record['examples_per_sec']:.2f} {spec.unit}", flush=True)
    return results[-1]


def main(argv=None):
    return run_benchmark(parse_args(argv))


if __name__ == "__main__":
    main()
