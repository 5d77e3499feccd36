"""How many device records a torch.profiler session keeps of the same work.

Each session profiles (CUDA activities only) ``--steps`` LM training steps at
``BASE_CFG`` (8 x 1024 tokens, bf16, the flash kernels, Adam through
``minimize``), after the session's spin-kernel markers, in one of three
variants: no markers, 64 one-cycle markers, and 64 markers of ``--cycles``
clock cycles each. Every session runs the same steps from the same state, so
every session should keep the same records. Prints the card's name and power
limit, one JSON line per session (records kept bar the markers, markers kept,
where the missing records lie against the variant's fullest session: at the
start, at the end or elsewhere, and the first kept record's start against
the host clock at its launch and against the trace's start), then one
summary line per variant. Then, over ``--span-s`` seconds, one session every
``--every-s`` seconds of 64 markers of ``--cycles`` cycles, one step and 64
more markers: the markers it kept before and after the step, and the time the
lost ones cover (lost x one marker's ms, timed by CUDA events), against the
seconds since the process's first session.

    python3 tools/torch_profiler_records.py [--sessions 4] [--steps 2] [--cycles 1000000]
        [--span-s 240] [--every-s 20]

Needs CUDA.
"""

import argparse
import collections
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MARKER = "spin_kernel"


def records(prof) -> list:
    """(start ns, name) of every device activity of a session, in time order."""
    return sorted((e.start_ns(), e.name()) for e in prof.profiler.kineto_results.events()
                  if "CUDA" in str(e.device_type()) and not e.is_user_annotation())


def where_lost(seq: list, ref: list) -> dict:
    """Where ``seq`` (names) lacks records of ``ref``: a prefix, a suffix, or
    elsewhere, and the names it lacks."""
    lost = collections.Counter(ref) - collections.Counter(seq)
    k = len(ref) - len(seq)
    if k == 0 and seq == ref:
        place = "none"
    elif k > 0 and seq == ref[k:]:
        place = "start"
    elif k > 0 and seq == ref[:len(seq)]:
        place = "end"
    else:
        place = "elsewhere"
    return {"lost": k, "place": place, "lost_names": dict(lost.most_common(8))}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sessions", type=int, default=4)
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--cycles", type=int, default=1_000_000)
    ap.add_argument("--span-s", type=float, default=240.0)
    ap.add_argument("--every-s", type=float, default=20.0)
    args = ap.parse_args()
    sys.path.insert(0, ROOT)

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from paddle_tpu_torch.core.config import set_flags
    from paddle_tpu_torch.models import get_model
    from paddle_tpu_torch.ops.cuda import build as kbuild

    if not torch.cuda.is_available():
        print("torch_profiler_records: CUDA is not available", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(smi, flush=True)
    kbuild.build_all()
    set_flags(use_flash_attention=True, use_bf16_compute=True, check_nan_inf=False)
    spec = get_model("transformer_lm")
    x = spec.synth_batch(8, np.random.RandomState(0))
    v0 = spec.model.init(0, *x)
    opt = spec.optimizer()
    st0, step = opt.create_state(v0.params), opt.minimize(spec.model)
    out = step(v0, st0, *x)  # warm-up: the kernels' loads and the allocator
    torch.cuda.synchronize()
    del out

    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    for _ in range(64):
        torch.cuda._sleep(args.cycles)
    ev[1].record()
    torch.cuda.synchronize()
    marker_ms = ev[0].elapsed_time(ev[1]) / 64

    t_first = time.perf_counter()
    variants = {"none": (0, 1), "short64": (64, 1), "long64": (64, args.cycles)}
    for variant, (markers, cycles) in variants.items():
        sessions = []
        for _ in range(args.sessions):
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                host_enter = time.time_ns()
                for _ in range(markers):
                    torch.cuda._sleep(cycles)
                torch.cuda.synchronize()
                host_first = time.time_ns()
                v, st = v0, st0
                for _ in range(args.steps):
                    o = step(v, st, *x)
                    v, st = o.variables, o.opt_state
                torch.cuda.synchronize()
            recs = records(prof)
            run = [r for r in recs if MARKER not in r[1]]
            trace_start = prof.profiler.kineto_results.trace_start_ns()
            sessions.append({
                "names": [n for _, n in run], "markers_kept": len(recs) - len(run),
                "first_run_start_minus_host_launch_us":
                    (run[0][0] - host_first) / 1e3 if run else None,
                "first_start_minus_trace_start_us": (recs[0][0] - trace_start) / 1e3 if recs else None,
                "trace_start_minus_host_enter_us": (trace_start - host_enter) / 1e3})
            del o, v, st
        ref = max((s["names"] for s in sessions), key=len)
        for i, s in enumerate(sessions):
            names = s.pop("names")
            s.update(variant=variant, session=i, markers=markers, cycles=cycles,
                     records=len(names), **where_lost(names, ref))
            print(json.dumps(s), flush=True)
        print(json.dumps({"variant": variant, "markers": markers, "cycles": cycles,
                          "steps": args.steps, "fullest": len(ref),
                          "records": [s["records"] for s in sessions],
                          "markers_kept": [s["markers_kept"] for s in sessions],
                          "card": smi}), flush=True)

    def fence():
        torch.cuda.synchronize()
        for _ in range(64):
            torch.cuda._sleep(args.cycles)
        torch.cuda.synchronize()

    t_end = time.perf_counter() + args.span_s
    while True:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fence()
            o = step(v0, st0, *x)
            fence()
        names = [n for _, n in records(prof)]
        is_marker = [MARKER in n for n in names]
        before = is_marker.index(False) if False in is_marker else len(names)
        after = is_marker[::-1].index(False) if False in is_marker else 0
        lost = 2 * 64 - before - after
        print(json.dumps({"since_first_session_s": time.perf_counter() - t_first,
                          "markers_before": before, "markers_after": after,
                          "marker_ms": marker_ms, "lost_ms": lost * marker_ms,
                          "step_records": len(names) - before - after, "card": smi}), flush=True)
        del o
        if time.perf_counter() + args.every_s > t_end:
            break
        time.sleep(args.every_s)
    return 0


if __name__ == "__main__":
    sys.exit(main())
