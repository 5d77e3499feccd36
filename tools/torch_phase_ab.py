"""Runs named phases of ``chip_smoke.py`` on one card, from this checkout
and optionally from another one (``--other DIR``, e.g. the parent commit
unpacked with ``git archive`` into the git-ignored ``.chipcheck/``), in
turns: other, this, this, other. Each turn is a fresh process of that
tree: it builds the tree's kernels (the first turn of a tree builds them
cold and prints the build's seconds), then calls ``chip_smoke.<phase>_phase``
for each phase the tree has, and prints one JSON line with each phase's
seconds and the checks that failed; each turn's whole output (the phases'
own JSON lines) goes to ``--log-dir``. Exits 1 if any check failed.

    python3 tools/torch_phase_ab.py --phases infer,analysis --other .chipcheck/parent
    python3 tools/torch_phase_ab.py --phases elastic    # one phase alone
"""
import argparse
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# seconds one turn may take
TURN_TIMEOUT_S = 900.0

# what one turn runs in its own process, from the root of a tree
TURN = r"""
import json, subprocess, sys, time
sys.path.insert(0, ROOT)
import chip_smoke
from paddle_tpu_torch.ops.cuda import build as kbuild

smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                     capture_output=True, text=True, timeout=60).stdout.strip()
t0 = time.perf_counter()
report = kbuild.build_all()
out = {"tree": LABEL, "card": smi, "build_s": time.perf_counter() - t0,
       "nvcc_s": {k: r["seconds"] for k, r in report.items()}, "phases": {}}
for name in PHASES:
    fn = getattr(chip_smoke, name + "_phase", None)
    if fn is None:
        out["phases"][name] = None  # this tree has no such phase
        continue
    t0 = time.perf_counter()
    _paths, checks = fn(smi)
    out["phases"][name] = {"seconds": time.perf_counter() - t0,
                           "failed": [k for k, v in checks.items() if not v]}
print("TURN " + json.dumps(out), flush=True)
"""


def turn(root: str, label: str, phases, log: str) -> dict:
    code = f"ROOT = {root!r}\nLABEL = {label!r}\nPHASES = {list(phases)!r}\n" + TURN
    proc = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True,
                          text=True, timeout=TURN_TIMEOUT_S)
    with open(log, "w") as f:
        f.write(proc.stdout + proc.stderr)
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("TURN ")]
    if proc.returncode != 0 or not lines:
        sys.stderr.write(proc.stdout[-4000:] + proc.stderr[-4000:])
        return {"tree": label, "exit_code": proc.returncode, "phases": {}}
    return json.loads(lines[-1][5:])


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--phases", default="infer,analysis")
    ap.add_argument("--other", default=None, help="root of another checkout to run in turns")
    ap.add_argument("--log-dir", default=os.path.join(HERE, ".chipcheck", "phase_ab"))
    args = ap.parse_args()
    phases = args.phases.split(",")
    order = [("this", HERE)] if args.other is None else [
        ("other", os.path.abspath(args.other)), ("this", HERE), ("this", HERE),
        ("other", os.path.abspath(args.other))]
    os.makedirs(args.log_dir, exist_ok=True)
    bad = False
    for i, (label, root) in enumerate(order):
        res = turn(root, label, phases, os.path.join(args.log_dir, f"turn{i}_{label}.log"))
        print(json.dumps(res), flush=True)
        bad |= "exit_code" in res or any(p and p["failed"] for p in res["phases"].values())
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
