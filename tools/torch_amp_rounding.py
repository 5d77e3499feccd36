"""How far ``amp_minimize``'s loss sits from the bf16 ``minimize`` step's along
ResNet-50's first Momentum steps (``chip_smoke.py`` phase ``conv`` (a) and
(e)): at each step, on the same weights and batch, against the minimize
step on the f32 master weights and on those weights rounded to bf16 (what
amp's forward computes on). Prints one JSON line per run.

    python3 tools/torch_amp_rounding.py [--root DIR] [--label NAME] [--seeds 0 1] [--steps 8]

``--root`` imports ``paddle_tpu_torch`` from another checkout (for example
a parent commit unpacked with ``git archive``), so two commits compare on
one card in one call. Needs CUDA.
"""

import argparse
import json
import os
import sys


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--label", default="this")
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1])
    ap.add_argument("--steps", type=int, default=8)
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)

    import numpy as np
    import torch

    import paddle_tpu_torch
    from paddle_tpu_torch.core.config import set_flags
    from paddle_tpu_torch.framework import Variables
    from paddle_tpu_torch.models import get_model
    from paddle_tpu_torch.transpiler import amp_minimize

    if not torch.cuda.is_available():
        print("torch_amp_rounding: CUDA is not available", file=sys.stderr)
        return 1
    assert paddle_tpu_torch.__file__.startswith(root), paddle_tpu_torch.__file__
    set_flags(use_bf16_compute=True, check_nan_inf=False)
    spec = get_model("resnet", dataset="flowers", depth=50, class_dim=1000)
    for seed in args.seeds:
        x, y = spec.synth_batch(64, np.random.RandomState(seed))
        v = spec.model.init(0, x, y)
        opt = spec.optimizer()
        st = opt.create_state(v.params)
        step = opt.minimize(spec.model)
        amp = amp_minimize(opt, spec.model, compute_dtype="bfloat16")
        rows = []
        for k in range(args.steps + 1):
            amp_loss = float(amp(v, st, None, x, y).loss)
            f32_loss = float(step(v, st, x, y).loss)
            rounded = Variables({n: t.to(torch.bfloat16).float() for n, t in v.params.items()},
                                v.state)
            bf16_loss = float(step(rounded, st, x, y).loss)
            rows.append({"step": k, "amp": amp_loss, "minimize_f32_weights": f32_loss,
                         "minimize_bf16_weights": bf16_loss,
                         "abs_diff_f32_weights": abs(amp_loss - f32_loss),
                         "abs_diff_bf16_weights": abs(amp_loss - bf16_loss)})
            out = step(v, st, x, y)
            v, st = out.variables, out.opt_state
        print(json.dumps({"label": args.label, "seed": seed, "card": torch.cuda.get_device_name(0),
                          "rows": rows}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
