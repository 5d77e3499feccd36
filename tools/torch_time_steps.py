"""Training-step times of the port's main paths on one card: the LM at
``BASE_CFG`` (8 x 1024 tokens, bf16, the flash kernels, Adam through
``minimize``), ResNet-50 at batch 64 (bf16, Momentum) and the MNIST conv net
at batch 64 (f32, Adam), each the host-clock ms of ``--steps`` synchronised
steps after two warm-up steps; and ``ops.math.relu``'s forward and backward
on one ResNet-50 activation ([64, 56, 56, 256] bf16), by CUDA events over
10 calls. Prints the card's name and power limit, then one JSON line per
model.

    python3 tools/torch_time_steps.py [--root DIR] [--label NAME] [--steps 20]

``--root`` imports ``paddle_tpu_torch`` from another checkout (for example a
parent commit unpacked with ``git archive`` into the git-ignored
``.chipcheck/``), so two commits compare on one card in one call: run
parent, this, this, parent. Needs CUDA.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import time


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--label", default="this")
    ap.add_argument("--steps", type=int, default=20)
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)

    import numpy as np
    import torch

    import paddle_tpu_torch
    from paddle_tpu_torch.core.config import set_flags
    from paddle_tpu_torch.models import get_model
    from paddle_tpu_torch.ops import math as om
    from paddle_tpu_torch.ops.cuda import build as kbuild

    if not torch.cuda.is_available():
        print("torch_time_steps: CUDA is not available", file=sys.stderr)
        return 1
    assert paddle_tpu_torch.__file__.startswith(root), paddle_tpu_torch.__file__
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(smi, flush=True)
    kbuild.build_all()

    def steps_ms(spec, batch: int):
        x = spec.synth_batch(batch, np.random.RandomState(0))
        v = spec.model.init(0, *x)
        opt = spec.optimizer()
        st, step = opt.create_state(v.params), opt.minimize(spec.model)
        ms = []
        for k in range(args.steps + 2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = step(v, st, *x)
            torch.cuda.synchronize()
            if k >= 2:
                ms.append(1e3 * (time.perf_counter() - t0))
            v, st = out.variables, out.opt_state
        return {"step_ms_median": statistics.median(ms), "step_ms_min": min(ms), "step_ms": ms,
                "loss": float(out.loss)}

    cells = [("transformer_lm", dict(), 8, dict(use_flash_attention=True, use_bf16_compute=True)),
             ("resnet50", dict(dataset="flowers", depth=50, class_dim=1000), 64,
              dict(use_bf16_compute=True)),
             ("mnist", dict(), 64, dict(use_bf16_compute=False))]
    for name, cfg, batch, flags in cells:
        set_flags(check_nan_inf=False, **flags)
        spec = get_model("resnet" if name == "resnet50" else name, **cfg)
        print(json.dumps({"label": args.label, "model": name, "batch": batch,
                          **steps_ms(spec, batch), "card": smi}), flush=True)
        del spec
        torch.cuda.empty_cache()

    x = torch.randn(64, 56, 56, 256, device="cuda").to(torch.bfloat16).requires_grad_()
    g = torch.randn_like(x)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ms = []
    for k in range(args.steps + 2):
        ev[0].record()
        for _ in range(10):  # enqueued ahead of the card: its time, not the host's
            torch.autograd.grad(om.relu(x), x, g)
        ev[1].record()
        torch.cuda.synchronize()
        if k >= 2:
            ms.append(ev[0].elapsed_time(ev[1]) / 10)
    print(json.dumps({"label": args.label, "model": "relu_fwd_bwd", "shape": list(x.shape),
                      "dtype": "bfloat16", "ms_median": statistics.median(ms), "ms_min": min(ms),
                      "card": smi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
