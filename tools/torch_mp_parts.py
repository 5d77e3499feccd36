#!/usr/bin/env python3
"""Phase mp of ``chip_smoke.py`` on its own, or only some of its parts, on
the card: the kernels built as the script builds them, then each named
part (``a`` to ``j``, the first letter of its ``MP_PARTS`` key; all when
none is named) on its gloo ranks sharing the card, held as the script
holds it.

    python3 tools/torch_mp_parts.py i j

Prints the card's name and power limit, the phase's JSON lines, and last a
line with the failed checks (empty when all held). Exits 1 without a card
or when a check fails.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402  (after the path: the repo's root)

# at the top level, so that the spawned ranks, which import this module
# again, see the same parts
_NAMED = [a for a in sys.argv[1:] if len(a) == 1]
if _NAMED:
    chip_smoke.MP_PARTS = {k: v for k, v in chip_smoke.MP_PARTS.items() if k[0] in _NAMED}


def main() -> int:
    import torch

    from paddle_tpu_torch.ops.cuda import build as kbuild

    if not torch.cuda.is_available():
        print("torch_mp_parts: CUDA is not available", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(smi, flush=True)
    kbuild.build_all()
    _, checks = chip_smoke.mp_phase(smi.splitlines()[0])
    failed = [k for k, good in checks.items() if not good]
    print(json.dumps({"parts": sorted(chip_smoke.MP_PARTS), "checks": len(checks),
                      "failed": failed}), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
