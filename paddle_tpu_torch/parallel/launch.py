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

Elastic runs (``resilience/elastic.py``): ``may_leave`` names the ranks
that may exit without a result (a rank the run kills on purpose) or end in
:class:`~paddle_tpu_torch.parallel.mesh.EvictedError` (one the survivors
evicted); their slots come back as None, and the other ranks go on. The
parent is the ranks' health endpoint: it marks each rank whose processes
have all exited, and :func:`health_probe` (in a rank) reads the
marks, the liveness ``probe`` the elastic supervisor polls while the
survivors' rendezvous waits. ``join`` starts further processes that join a later
generation of the group (``(rank, generation)``: the rank they take back in
the initial world, :func:`~paddle_tpu_torch.parallel.mesh.join_generation`);
their results follow the others'. ``collective_timeout_s`` is the group's
collective timeout. Every other caller keeps the default: a rank that
exits without a result fails the run and stops the others.

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
import uuid
from multiprocessing.reduction import ForkingPickler
from typing import Any, Callable, List, Optional, Sequence, Tuple

__all__ = ["spawn", "health_probe"]

# in a spawned rank: the directory where the parent marks exited ranks
_health_dir: Optional[str] = None
_health_size = 0


def health_probe() -> Optional[Callable[[], List[int]]]:
    """In a rank started by :func:`spawn`: a callable returning the
    initial ranks whose processes are still running (the parent's view);
    None elsewhere."""
    if _health_dir is None:
        return None
    root, n = _health_dir, _health_size

    def alive() -> List[int]:
        gone = set(os.listdir(root))
        return [r for r in range(n) if str(r) not in gone]

    return alive


def _rank_main(slot: int, rank: int, nprocs: int, call_path: str, init_method: str,
               job: str, device: str, backend: Optional[str], timeout_s: float,
               generation: Optional[int], results) -> None:
    import torch

    from paddle_tpu_torch.parallel import mesh as mesh_mod

    global _health_dir, _health_size
    try:
        with open(call_path, "rb") as f:
            fn, args = pickle.load(f)
        _health_dir, _health_size = os.path.join(os.path.dirname(call_path), "exited"), nprocs
        if torch.device(device).type == "cpu":
            torch.set_num_threads(1)  # N ranks share the host's cores
        if generation is None:
            mesh_mod.initialize_distributed(
                init_method=init_method, num_processes=nprocs, process_id=rank,
                local_rank=rank, device=device, backend=backend, timeout_s=timeout_s,
                job_id=job)
        else:
            mesh_mod.join_generation(init_method, generation, rank, nprocs, device=device,
                                     backend=backend, local_rank=rank, timeout_s=timeout_s,
                                     job_id=job)
        try:
            results.put((slot, "ok", fn(rank, *args)))
        finally:
            mesh_mod.shutdown_distributed()
    except mesh_mod.EvictedError:  # a leave where the parent allows one
        results.put((slot, "evicted", traceback.format_exc()))
    except BaseException:  # reported to the parent, which raises it
        results.put((slot, "failed", traceback.format_exc()))


def spawn(fn: Callable, nprocs: int, args: Sequence[Any] = (), *, device: str = "cuda",
          backend: Optional[str] = None, timeout_s: float = 600.0,
          may_leave: Sequence[int] = (), join: Sequence[Tuple[int, int]] = (),
          collective_timeout_s: float = 600.0) -> List[Any]:
    """``fn(rank, *args)`` on ranks 0..nprocs-1 (``fn`` and ``args`` are
    pickled: a module-level function), then on each ``join`` process.
    Returns the results in that order (None for a ``may_leave`` rank that
    exited without one or was evicted)."""
    import torch

    from paddle_tpu_torch.core.config import resolve_device

    dev = resolve_device(device)  # raises without CUDA unless the caller asks for the CPU
    if dev.type == "cuda" and dev.index is None and torch.cuda.device_count() < nprocs:
        raise RuntimeError(f"spawn: {nprocs} ranks need {nprocs} cards (one rank per card), "
                           f"{torch.cuda.device_count()} visible; two ranks share one card "
                           "only with device='cuda:0', backend='gloo'")
    ctx = multiprocessing.get_context("spawn")
    workdir = tempfile.mkdtemp(prefix="paddle_tpu_torch_spawn_")
    exited = os.path.join(workdir, "exited")
    os.makedirs(exited)
    init_method = "file://" + os.path.join(workdir, "store")
    job = uuid.uuid4().hex[:12]
    call_path = os.path.join(workdir, "call.pkl")
    with open(call_path, "wb") as f:
        f.write(ForkingPickler.dumps((fn, tuple(args))))
    results = ctx.Queue()
    slots = [(r, None) for r in range(nprocs)] + [(int(r), int(g)) for r, g in join]
    procs = [ctx.Process(target=_rank_main, daemon=True, args=(
        i, r, nprocs, call_path, init_method, job, device, backend, collective_timeout_s, g,
        results)) for i, (r, g) in enumerate(slots)]
    leave = {int(r) for r in may_leave}
    got, left, failures = {}, set(), []
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout_s
        while len(got) + len(left) < len(procs):
            try:
                slot, how, value = results.get(timeout=0.05)
            except queue.Empty:
                # the ranks' health endpoint: a rank is gone once every
                # process that holds it (the first, and any that joined
                # back) has ended
                for r in {r for r, _ in slots}:
                    if all(procs[i].exitcode is not None for i, (q, _) in enumerate(slots)
                           if q == r):
                        open(os.path.join(exited, str(r)), "w").close()
                ended = [i for i, p in enumerate(procs) if p.exitcode is not None
                         and i not in got and i not in left]
                dead = [i for i in ended if procs[i].exitcode != 0]
                if dead and results.empty():
                    quit_ok = [i for i in dead if i < nprocs and i in leave]
                    left.update(quit_ok)
                    dead = [i for i in dead if i not in quit_ok]
                    if dead:
                        failures.append(f"rank(s) {[slots[i][0] for i in dead]} exited with "
                                        f"codes {[procs[i].exitcode for i in dead]} and no result")
                        break
                if time.monotonic() > deadline:
                    failures.append(f"timed out after {timeout_s} s; finished ranks {sorted(got)}")
                    break
                continue
            if how == "ok":
                got[slot] = value
            elif how == "evicted" and slot < nprocs and slot in leave:
                left.add(slot)
            else:
                failures.append(f"rank {slots[slot][0]}:\n{value}")
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
    return [got.get(i) for i in range(len(procs))]
