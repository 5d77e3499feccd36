"""Per-device memory telemetry: live/peak/limit gauges and their history.

Port of ``paddle_tpu.tracing.memory``. The reference surfaced GPU memory
through ``FLAGS_benchmark`` prints in the executor (executor.cc:399-401).
On a card the sampler reads PyTorch's caching allocator:
``torch.cuda.memory_stats`` (``allocated_bytes.all.current`` / ``.peak``,
so the peak equals ``torch.cuda.max_memory_allocated``) and
``torch.cuda.mem_get_info`` (the card's capacity), with
``source="memory_stats"``. The samples go into the ``device.hbm.*`` gauge
families so an impending OOM is visible on the ``/metrics`` scrape before
the allocator raises, and a bounded history of samples feeds counter
tracks in the merged Chrome-trace export.

The CPU has no allocator statistics (where the JAX package sums
``jax.live_arrays()``): the sampler sums the ``nbytes`` of the tensors the
caller passes (the Trainer passes its variables and optimizer state) and
tracks its own running peak, with ``source="tensors"``, so the gauge
families exist on every platform. A per-call peak is the roofline
ledger's ``peak_hbm_bytes`` (``observability/roofline.py``).
:func:`record_executable_memory` is the analogue of the JAX function that
reads XLA's memory analysis of an executable: the allocator's peak over a
region the caller marks (``torch.cuda.reset_peak_memory_stats`` before
it).
"""

from __future__ import annotations

import time
from collections import deque
from typing import Dict, List, Optional

import torch

from paddle_tpu_torch.core import locks
from paddle_tpu_torch.core import profiler as prof
from paddle_tpu_torch.core import tree as tree_mod

__all__ = [
    "device_label",
    "sample_device_memory",
    "memory_history",
    "reset_memory_telemetry",
    "record_executable_memory",
]

_lock = locks.Lock("tracing.memory")
# the tensor-sum fallback needs its own running peak — the allocator
# tracks the real one only on a card
_live_peak: Dict[str, int] = {}
# bounded (t_pc_us, device_label, bytes_in_use) history for the trace
# export's counter track
_history: "deque[tuple]" = deque(maxlen=4096)


def device_label(dev) -> str:
    """Stable metric label for one device, e.g. ``cuda:0`` or ``cpu:0``."""
    dev = torch.device(dev)
    index = dev.index
    if index is None:
        index = torch.cuda.current_device() if dev.type == "cuda" else 0
    return f"{dev.type}:{index}"


def _tensor_bytes(tensors) -> int:
    return sum(int(t.numel() * t.element_size()) for t in tree_mod.leaves(tensors)
               if isinstance(t, torch.Tensor))


def sample_device_memory(devices=None, tensors=None) -> List[dict]:
    """Sample live/peak/limit bytes for each device into the
    ``device.hbm.*`` gauge families (labeled ``device=...``). Returns the
    per-device samples. ``devices`` defaults to the current card (the CPU
    without one); ``tensors`` (any tree) is what a CPU device counts.
    Called per training step."""
    if devices is None:
        devices = [torch.device("cuda") if torch.cuda.is_available() else torch.device("cpu")]
    now_us = time.perf_counter() * 1e6
    samples = []
    for dev in devices:
        dev = torch.device(dev)
        lbl = device_label(dev)
        if dev.type == "cuda":
            stats = torch.cuda.memory_stats(dev)
            in_use = int(stats.get("allocated_bytes.all.current", 0))
            peak = int(stats.get("allocated_bytes.all.peak", in_use))
            limit = int(torch.cuda.mem_get_info(dev)[1])
            source = "memory_stats"
        else:
            in_use = _tensor_bytes(tensors) if tensors is not None else 0
            with _lock:
                peak = max(_live_peak.get(lbl, 0), in_use)
                _live_peak[lbl] = peak
            limit = None
            source = "tensors"
        labels = {"device": lbl}
        prof.set_gauge("device.hbm.bytes_in_use", float(in_use), labels=labels)
        prof.set_gauge("device.hbm.peak_bytes_in_use", float(peak), labels=labels)
        if limit is not None:
            prof.set_gauge("device.hbm.bytes_limit", float(limit), labels=labels)
        with _lock:
            _history.append((now_us, lbl, in_use))
        samples.append({
            "device": lbl,
            "bytes_in_use": in_use,
            "peak_bytes_in_use": peak,
            "bytes_limit": limit,
            "source": source,
        })
    return samples


def memory_history() -> List[tuple]:
    """Snapshot of (t_pc_us, device_label, bytes_in_use) samples for the
    merged trace export's per-device counter track."""
    with _lock:
        return list(_history)


def reset_memory_telemetry() -> None:
    with _lock:
        _live_peak.clear()
        _history.clear()


def record_executable_memory(target: str, device=None) -> Optional[dict]:
    """Record the caching allocator's peak on ``device`` (the current card
    by default) since the caller's last ``torch.cuda.reset_peak_memory_stats``
    into the ``device.hbm.executable_peak_bytes`` gauge labeled
    ``target=...``; returns ``{"target", "peak_bytes"}``, or None without a
    card (the CPU has no allocator statistics)."""
    if not torch.cuda.is_available():
        return None
    peak = int(torch.cuda.max_memory_allocated(device))
    prof.set_gauge("device.hbm.executable_peak_bytes", float(peak), labels={"target": target})
    return {"target": target, "peak_bytes": peak}
