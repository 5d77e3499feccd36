#!/usr/bin/env python3
"""Phases sp and mp of ``chip_smoke.py`` over NCCL, one rank per card (up
to 4): ring and Ulysses attention on ``seq=n`` and the MoE LM on
``expert=n`` at ``BASE_CFG`` (phase sp), and the LM and the NMT
Transformer on ``model=n``, the LM's GPipe pipeline on ``pipe=2`` (beside
``data=n/2``) and the MoE LM with ZeRO-1 on ``expert=n`` (phase mp), and
with four cards or more the composed meshes on four of them: the LM on
``pipe=2 x model=2`` and with the ring and Ulysses on ``seq=2 x model=2``
(phase mp (e)-(g)), each held against the one-rank step as the phases
hold their two gloo ranks, with ``ppermute`` and ``all_to_all`` on NCCL's
point-to-point and all-to-all (the route the phases' one card cannot
take); the ring's rank r launches r + 1 of each kernel a layer.

    python3 tools/torch_sp_nccl.py

Prints the card's name and power limit, the phases' JSON lines, and last a
line with the failed checks (empty when all held). Exits 1 without two
cards or when a check fails.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> int:
    import torch

    import chip_smoke
    from paddle_tpu_torch.ops.cuda import build as kbuild

    n = min(4, torch.cuda.device_count())
    if n < 2:
        print("torch_sp_nccl: needs two or more cards", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(smi, flush=True)
    kbuild.build_all()
    failed = []
    for name, run in (("sp", chip_smoke.sp_phase), ("mp", chip_smoke.mp_phase)):
        _, checks = run(smi.splitlines()[0], ranks=n, device="cuda", backend=None)
        failed += [f"{name} {k}" for k, good in checks.items() if not good]
    print(json.dumps({"failed": failed}), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
