"""Decode-step times of the port's paged decoders against another
checkout's, in one process on one card. The LM at ``BASE_CFG`` in f32
(weights and pages), a 16-slot decode step at full occupancy, every slot
704 positions deep in 1024-position tables of 16-position pages (phase
serve's engine config, as ``chip_smoke.py``'s phase group probes it).
Cells: tp=1 (``PagedDecoder``), and a tp=2 group with both members on the
card (``GroupPagedDecoder`` over ``default_layout()``'s blocks) for
``num_kv_heads`` 8 (pages split) and 1 (pages whole, k/v gathered). In
each cell this checkout's decoder and the other's (its
``models/transformer_lm.py`` loaded beside this one) take turns, a
synchronised call each, ``--runs`` rounds after three warm-up rounds, so
the host's load falls on both alike; each reports the host-clock ms of
its calls and its kernel launches a step (torch.profiler). Prints the
card's name and power limit, then one JSON line per cell.

    python3 tools/torch_decode_step_ab.py --other DIR [--runs 41]

``--other`` is the root of the other checkout (for example a parent commit
unpacked with ``git archive`` into the git-ignored ``.chipcheck/``). A cell
the other checkout has no decoder for is reported as not run. Needs CUDA.
"""

import argparse
import importlib.util
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SLOTS, PAGE, CONTEXT = 16, 16, 1024
DEPTH = CONTEXT * 11 // 16


def launches(fn) -> int:
    """Kernel launches of one call of ``fn`` under torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages()
               if "CUDA" in str(getattr(e, "device_type", ""))
               and not getattr(e, "is_user_annotation", False))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", required=True)
    ap.add_argument("--runs", type=int, default=41)
    args = ap.parse_args()
    sys.path.insert(0, ROOT)

    import numpy as np
    import torch

    from paddle_tpu_torch.core.dtypes import ieee_f32
    from paddle_tpu_torch.models import get_model
    from paddle_tpu_torch.models import transformer_lm as this
    from paddle_tpu_torch.serving import default_layout, make_groups

    if not torch.cuda.is_available():
        print("torch_decode_step_ab: CUDA is not available", file=sys.stderr)
        return 1
    path = os.path.join(os.path.abspath(args.other), "paddle_tpu_torch", "models",
                        "transformer_lm.py")
    spec = importlib.util.spec_from_file_location("other_transformer_lm", path)
    other = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(other)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(smi, flush=True)
    cuda0 = torch.device("cuda", 0)
    P = CONTEXT // PAGE
    rng = np.random.RandomState(0)
    tables = torch.as_tensor((1 + np.arange(SLOTS * P, dtype=np.int32)).reshape(SLOTS, P),
                             device=cuda0)
    positions = torch.full((SLOTS,), DEPTH, dtype=torch.int32, device=cuda0)

    for kv_heads in (None, 1):
        mspec = get_model("transformer_lm", device=cuda0, num_kv_heads=kv_heads)
        params = mspec.model.init(0, *mspec.synth_batch(1, np.random.RandomState(0)),
                                  device=cuda0).params
        cfg = mspec.extra["cfg"]
        tokens = torch.as_tensor(rng.randint(1, cfg["vocab"], size=(SLOTS,)).astype(np.int32),
                                 device=cuda0)
        pshape = this.paged_cache_shape(cfg, 1 + SLOTS * P, PAGE)
        group = make_groups(2, devices=[cuda0, cuda0])[0]
        layout = default_layout()
        kv_split = layout.kv_page_spec(pshape, group.mesh)[2] is not None
        cells = [("tp1", 1)] if kv_heads is None else []
        cells.append(("tp2", 2))
        for name, tp in cells:
            decoders = {}
            for label, mod in (("this", this), ("other", other)):
                if tp == 1:
                    dec = mod.PagedDecoder(params, cfg, PAGE, P)
                    pages = [torch.zeros(pshape, device=cuda0) for _ in range(2)]
                elif hasattr(mod, "GroupPagedDecoder"):
                    dec = mod.GroupPagedDecoder(layout.shard_params(group, params),
                                                {n: v.shape for n, v in params.items()}, cfg,
                                                PAGE, P, kv_split)
                    mshape = list(pshape)
                    mshape[2] //= 2 if kv_split else 1
                    pages = [[torch.zeros(mshape, device=cuda0) for _ in range(2)]
                             for _ in range(2)]
                else:
                    continue
                decoders[label] = (dec, pages)

            def call(label):
                dec, (k, v) = decoders[label]
                with torch.no_grad(), ieee_f32():
                    return dec.decode_step(tokens, positions, tables, k, v)

            ms = {label: [] for label in decoders}
            for r in range(args.runs + 3):
                for label in decoders:
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    call(label)
                    torch.cuda.synchronize()
                    if r >= 3:
                        ms[label].append(1e3 * (time.perf_counter() - t0))
            logits = {label: call(label) for label in decoders}
            rec = {"cell": name, "num_kv_heads": kv_heads, "card": smi}
            for label in decoders:
                rec[label] = {"step_ms_median": statistics.median(ms[label]),
                              "step_ms_min": min(ms[label]), "step_ms": ms[label],
                              "launches_per_step": launches(lambda: call(label))}
            if "other" in decoders:
                rec["logits_max_abs_diff"] = float((logits["this"] - logits["other"]).abs().max())
            else:
                rec["other"] = "not run: the other checkout has no group decoder"
            print(json.dumps(rec), flush=True)
            del decoders, logits
            torch.cuda.empty_cache()
        del params
    return 0


if __name__ == "__main__":
    sys.exit(main())
