"""PyTorch's CPU threads for the port's tests, set once per process.

Every ``tests/test_torch_*.py`` and every port helper ``tests/torch_*.py``
imports this module first. Under ``pytest -n N`` (pytest-xdist) N worker
processes run at once, and each would start PyTorch's default of one
intra-op thread per core: N times the host's cores in all. Each process
takes its share of the cores instead, ``cpu_count // N`` (at least one),
for the intra-op and the inter-op pools alike. Run without xdist, a
process keeps every core.
"""

import os

import torch


def threads_per_process() -> int:
    """The host's cores over the number of pytest-xdist workers."""
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    return max(1, (os.cpu_count() or 1) // workers)


THREADS = threads_per_process()
torch.set_num_threads(THREADS)
if torch.get_num_interop_threads() != THREADS:
    try:
        torch.set_num_interop_threads(THREADS)
    except RuntimeError:  # the pool already started: PyTorch fixes its size then
        pass
