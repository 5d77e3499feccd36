#!/usr/bin/env python3
"""Device time of the port's three flash-attention kernels at several
shapes, beside PyTorch's own attention, on one GPU.

    python3 tools/torch_time_flash.py [--root DIR] [--label NAME]
                                      [--cases slice,t1000,d128,d32]

Imports ``paddle_tpu_torch`` from ``--root`` (default: this checkout), so
two trees can be timed on one card in one call: unpack another commit with
``git archive`` into a git-ignored directory and pass it as ``--root``
(run A, B, B, A to see the drift between runs). Builds the kernels of that
tree (one JSON line with ptxas' register and spill report of each kernel
it had to build), then for each case of ``CASES`` (bf16, causal) prints one
JSON line: the forward, dK/dV and dQ kernels' device times, and the library's
(``F.scaled_dot_product_attention``: its forward, and its backward as
forward plus backward less the forward, which computes dq, dk and dv
together). Times are CUDA events around ``ITERS`` calls enqueued behind
a sleep kernel, as ``chip_smoke.py`` times them. The card's name and power
limit come first. Exits 1 without CUDA.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (name, B, H, H_kv, T, d): chip_smoke.py's bf16 causal cases that the
# kernels' tiling treats differently (the slice shape, a T off the tile
# edges, and the head dims 128 and 32)
CASES = [
    ("slice", 8, 8, 8, 1024, 64),
    ("t1000", 4, 8, 8, 1000, 64),
    ("d128", 4, 8, 8, 1024, 128),
    ("d32", 4, 8, 8, 1024, 32),
]
ITERS = 20


def time_ms(fn) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(100_000_000)
    start.record()
    for _ in range(ITERS):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / ITERS


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=ROOT, help="checkout whose paddle_tpu_torch is timed")
    ap.add_argument("--label", default="", help="name printed with every line")
    ap.add_argument("--cases", default=",".join(c[0] for c in CASES),
                    help="comma-separated names from CASES")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("torch_time_flash: CUDA is not available; nothing was run", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(args.root))
    import torch.nn.functional as F

    from paddle_tpu_torch.ops.cuda import build as kbuild
    from paddle_tpu_torch.ops.cuda.flash_attention import (
        _flash_bwd_dkv_cuda,
        _flash_bwd_dq_cuda,
        flash_attention_with_lse,
    )

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    report = kbuild.build_all(extra_flags=("-Xptxas", "-v"))
    print(json.dumps({"label": args.label, "ptxas": {
        k: [" ".join(ln.split()) for ln in r["nvcc_output"].splitlines()
            if "registers" in ln or "spill" in ln]
        for k, r in report.items()}}), flush=True)

    gen = torch.Generator(device="cuda").manual_seed(0)
    wanted = args.cases.split(",")
    for case, B, H, H_kv, T, d in CASES:
        if case not in wanted:
            continue

        def rand(*shape):
            return torch.randn(*shape, generator=gen, device="cuda").to(torch.bfloat16)

        q, k, v, g = rand(B, H, T, d), rand(B, H_kv, T, d), rand(B, H_kv, T, d), rand(B, H, T, d)
        scale = 1.0 / d ** 0.5
        with torch.no_grad():
            out, lse = flash_attention_with_lse(q, k, v, causal=True)
            delta = (g.float() * out.float()).sum(-1, keepdim=True)
            bwd = (q, k, v, g, lse, delta, True, scale, None, None, 0, 0)
            ms = {"flash_fwd": time_ms(lambda: flash_attention_with_lse(q, k, v, causal=True)),
                  "flash_bwd_dkv": time_ms(lambda: _flash_bwd_dkv_cuda(*bwd)),
                  "flash_bwd_dq": time_ms(lambda: _flash_bwd_dq_cuda(*bwd))}
        qr, kr, vr = (t.detach().requires_grad_() for t in (q, k, v))
        lib_fwd = time_ms(lambda: F.scaled_dot_product_attention(qr, kr, vr, is_causal=True))
        lib_both = time_ms(lambda: torch.autograd.grad(
            F.scaled_dot_product_attention(qr, kr, vr, is_causal=True), (qr, kr, vr), g))
        print(json.dumps({"label": args.label, "case": case, "shape": [B, H, H_kv, T, d],
                          "dtype": "bfloat16", "causal": True, "ms": ms,
                          "library_fwd_ms": lib_fwd, "library_bwd_ms": lib_both - lib_fwd,
                          "card": smi}), flush=True)
        del q, k, v, g, out, lse, delta, bwd, qr, kr, vr
    return 0


if __name__ == "__main__":
    sys.exit(main())
