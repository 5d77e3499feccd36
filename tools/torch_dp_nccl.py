#!/usr/bin/env python3
"""Phase dp (d) of ``chip_smoke.py`` on its own: the LM at ``BASE_CFG``
through ``DataParallel`` with one rank per card over NCCL (up to 4 cards),
plain and with ZeRO-1, held against the one-rank run on the same 8 x 1024
batch, with the NCCL kernels' device ms of one step and the seconds a
sharded checkpoint save (sync, and async, which blocks for the whole save
with several ranks) takes on each rank.

    python3 tools/torch_dp_nccl.py

Prints the card's name and power limit, the phase's JSON line, and last a
line with the failed checks (empty when all held). Exits 1 without two
cards or when a check fails.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> int:
    import torch

    import chip_smoke
    from paddle_tpu_torch.ops.cuda import build as kbuild

    if torch.cuda.device_count() < 2:
        print("torch_dp_nccl: needs two or more cards", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(smi, flush=True)
    kbuild.build_all()
    with tempfile.TemporaryDirectory() as work:
        losses, control = chip_smoke.dp_reference(work)
        checks = chip_smoke.dp_multi_card(smi.splitlines()[0], work, losses, control)
    failed = [k for k, good in checks.items() if not good]
    print(json.dumps({"failed": failed}), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
