"""Runs ``chip_smoke.py``'s phase ``elastic`` alone on one card: builds the
port's kernels, then calls ``chip_smoke.elastic_phase`` (three gloo ranks
sharing the card and a fourth process that joins back). Prints the card's
name and power limit, the phase's JSON line and the checks that failed;
exits 1 if any did.

    python3 tools/torch_elastic_phase.py
"""
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402

if __name__ == "__main__":
    from paddle_tpu_torch.ops.cuda import build as kbuild

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi, flush=True)
    t0 = time.perf_counter()
    kbuild.build_all()
    print("build_s", time.perf_counter() - t0, flush=True)
    t0 = time.perf_counter()
    paths, checks = chip_smoke.elastic_phase(smi)
    print("elastic_s", time.perf_counter() - t0, "paths", paths, flush=True)
    failed = [k for k, v in checks.items() if not v]
    print("FAILED", failed, flush=True)
    sys.exit(1 if failed else 0)
