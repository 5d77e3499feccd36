"""Run a function as the N ranks of one process group on this machine.

    from paddle_tpu_torch.parallel import launch
    results = launch.spawn(fn, 2, args=(...))                 # cuda:r over NCCL
    results = launch.spawn(fn, 2, args=(...), device="cpu")   # gloo on the CPU

Each rank is a fresh process (``multiprocessing``'s spawn start method)
that joins a process group whose store is a file in a temporary directory
(``file://``: no TCP port, so concurrent runs cannot collide), calls
``fn(rank, *args)`` and leaves the group. ``spawn`` returns the ranks'
return values in rank order, or raises with every failed rank's traceback
(the other ranks are stopped). ``device`` defaults to ``"cuda"``, as every
entry point of the port does: rank r takes ``cuda:r`` over NCCL, and the
call raises before any rank starts where there is no card or fewer cards
than ranks. ``device="cpu"`` runs gloo on the CPU; two ranks share one card
only when the caller names both: ``device="cuda:0", backend="gloo"``. On a
cluster, launch with ``torchrun`` and call
:func:`~paddle_tpu_torch.parallel.mesh.initialize_distributed` instead.

``fn`` and ``args`` reach the ranks through a file in that directory, not
through the process's start pipe: a start blocks until the child has read
what the pipe carries, which it does only after importing the parent's main
module, so large arguments on the pipe would start the ranks one after the
other.
"""

from __future__ import annotations

import multiprocessing
import os
import pickle
import queue
import shutil
import tempfile
import time
import traceback
from multiprocessing.reduction import ForkingPickler
from typing import Any, Callable, List, Optional, Sequence

__all__ = ["spawn"]


def _rank_main(rank: int, nprocs: int, call_path: str, init_method: str,
               device: str, backend: Optional[str], results) -> None:
    import torch

    from paddle_tpu_torch.parallel import mesh as mesh_mod

    try:
        with open(call_path, "rb") as f:
            fn, args = pickle.load(f)
        if torch.device(device).type == "cpu":
            torch.set_num_threads(1)  # N ranks share the host's cores
        mesh_mod.initialize_distributed(
            init_method=init_method, num_processes=nprocs, process_id=rank,
            local_rank=rank, device=device, backend=backend)
        try:
            results.put((rank, True, fn(rank, *args)))
        finally:
            mesh_mod.shutdown_distributed()
    except BaseException:  # reported to the parent, which raises it
        results.put((rank, False, traceback.format_exc()))


def spawn(fn: Callable, nprocs: int, args: Sequence[Any] = (), *, device: str = "cuda",
          backend: Optional[str] = None, timeout_s: float = 600.0) -> List[Any]:
    """``fn(rank, *args)`` on ranks 0..nprocs-1 (``fn`` and ``args`` are
    pickled: a module-level function). Returns the ranks' results."""
    import torch

    from paddle_tpu_torch.core.config import resolve_device

    dev = resolve_device(device)  # raises without CUDA unless the caller asks for the CPU
    if dev.type == "cuda" and dev.index is None and torch.cuda.device_count() < nprocs:
        raise RuntimeError(f"spawn: {nprocs} ranks need {nprocs} cards (one rank per card), "
                           f"{torch.cuda.device_count()} visible; two ranks share one card "
                           "only with device='cuda:0', backend='gloo'")
    ctx = multiprocessing.get_context("spawn")
    workdir = tempfile.mkdtemp(prefix="paddle_tpu_torch_spawn_")
    init_method = "file://" + os.path.join(workdir, "store")
    call_path = os.path.join(workdir, "call.pkl")
    with open(call_path, "wb") as f:
        f.write(ForkingPickler.dumps((fn, tuple(args))))
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, daemon=True, args=(
        r, nprocs, call_path, init_method, device, backend, results)) for r in range(nprocs)]
    got, failures = {}, []
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout_s
        while len(got) + len(failures) < nprocs:
            try:
                rank, ok, value = results.get(timeout=0.2)
            except queue.Empty:
                dead = [r for r, p in enumerate(procs) if p.exitcode not in (None, 0)
                        and r not in got]
                if dead and results.empty():
                    failures.append(f"rank(s) {dead} exited with codes "
                                    f"{[procs[r].exitcode for r in dead]} and no result")
                    break
                if time.monotonic() > deadline:
                    failures.append(f"timed out after {timeout_s} s; finished ranks {sorted(got)}")
                    break
                continue
            if ok:
                got[rank] = value
            else:
                failures.append(f"rank {rank}:\n{value}")
                break  # the other ranks may be waiting on the failed one
    finally:
        for p in procs:
            if p.pid is None:  # never started
                continue
            if failures:
                p.terminate()
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join(timeout=30)
        results.close()
        shutil.rmtree(workdir, ignore_errors=True)
    if failures:
        raise RuntimeError("spawn failed: " + "\n".join(failures))
    return [got[r] for r in range(nprocs)]
