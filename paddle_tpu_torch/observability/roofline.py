"""Roofline cost-attribution ledger: FLOPs, bytes, and verdicts per callable.

Port of ``paddle_tpu.observability.roofline``. The JAX package's "kernel"
is a compiled executable whose costs come from XLA's cost model at compile
time. Here a ledger entry is an instrumented callable (the decode engine's
step, prefill, draft and verify calls; the Executor's prepared functions)
at one argument signature:

- its **first call** runs under :class:`~paddle_tpu_torch.observability.mfu.CostCounter`,
  which sums the FLOPs of its products and the bytes its ops move (the
  hand-written kernels report theirs), and — under ``roofline_memory`` —
  reads ``torch.cuda.max_memory_allocated`` over the call (the statistic
  is reset for it); that call is not timed, as the JAX package does not
  time a compiling call;
- every later call books its **device time** from a CUDA event pair
  recorded on the current stream around it. The pair is read when the
  next call of that entry begins, or on :func:`snapshot`, once the card
  has passed it: nothing on the instrumented path waits for the card. On
  the CPU a call books its wall seconds;
- on read it derives arithmetic intensity (FLOPs/byte), achieved vs. peak
  FLOP/s and bytes/s against ``mfu.PEAK_FLOPS_TABLE`` /
  ``mfu.PEAK_HBM_BW_TABLE``, and a **roofline verdict**:

  - ``compute_bound``  — the FLOP side of max(F/P_f, B/P_b) dominates;
  - ``memory_bound``   — the byte side dominates;
  - ``overhead_bound`` — the measured time exceeds the predicted device
    time by more than ``OVERHEAD_FRAC_THRESHOLD`` (the card waits on the
    host's launches, or the work is spread thin).

Entries are keyed ``kernel|shape_bucket|dtype|device_kind``, with the
shape bucket rendered by :func:`shape_bucket` (the JAX package's
``tune.search.shape_bucket``). The exporter serves the ledger at
``/roofline``, the Chrome-trace export emits its counter tracks, and
flight-recorder bundles embed a snapshot.

The ledger is bounded: it holds at most ``MAX_ENTRIES`` keys (oldest
evicted). Disable with ``PADDLE_TPU_ROOFLINE=0``; the memory
capture is ``PADDLE_TPU_ROOFLINE_MEMORY=auto|on|off`` — ``auto`` is on
for CUDA and off for the CPU, which has no allocator statistics.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional, Tuple

import torch

from paddle_tpu_torch.core import locks
from paddle_tpu_torch.core import tree as tree_mod
from paddle_tpu_torch.observability import mfu

__all__ = [
    "COMPUTE_BOUND",
    "MEMORY_BOUND",
    "OVERHEAD_BOUND",
    "OVERHEAD_FRAC_THRESHOLD",
    "RooflineLedger",
    "default_ledger",
    "reset_ledger",
    "enabled",
    "call_key",
    "device_kind",
    "shape_bucket",
    "instrument",
    "memory_capture_enabled",
    "note_compile",
    "observe_call",
    "snapshot",
    "summary",
    "history",
    "predicted_seconds",
]

SEP = "|"  # kernel|shape_bucket|dtype|device_kind

COMPUTE_BOUND = "compute_bound"
MEMORY_BOUND = "memory_bound"
OVERHEAD_BOUND = "overhead_bound"

# measured time more than this fraction above the roofline-predicted
# device time means dispatch/host overhead, not the work, is the bottleneck
OVERHEAD_FRAC_THRESHOLD = 0.5

MAX_ENTRIES = 4096

# bounded achieved-rate time series feeding the Chrome-trace counter
# tracks (tracing.export); oldest half dropped on overflow
MAX_HISTORY = 4096

# the smallest shape bucket (the JAX package's MXU lane width, kept so the
# two packages' ledger keys agree)
_BUCKET_FLOOR = 128


def enabled() -> bool:
    from paddle_tpu_torch.core import config

    return bool(config.flags().roofline)


def shape_bucket(t_q: int, t_kv: Optional[int] = None) -> str:
    """Bucket sequence lengths to the next power of two (floor 128) so one
    entry covers the whole bucket instead of one exact shape (a copy of
    ``paddle_tpu.tune.search.shape_bucket``)."""
    def _b(t: int) -> int:
        b = _BUCKET_FLOOR
        while b < t:
            b *= 2
        return b

    if t_kv is None or t_kv == t_q:
        return f"q{_b(t_q)}"
    return f"q{_b(t_q)}k{_b(t_kv)}"


def device_kind(device=None) -> str:
    """Sanitized device-name key segment: no spaces, no key separator."""
    try:
        kind = mfu.device_kind(device)
    except Exception:
        return "unknown"
    return str(kind).replace(" ", "_").replace(SEP, "_")


def _leaves(args: tuple, kwargs: dict) -> list:
    try:
        return tree_mod.leaves((args, kwargs))
    except Exception:
        return []


def _bucket_token(args: tuple, kwargs: dict) -> Tuple[str, str]:
    """(shape_bucket, dtype) segments from one call's arguments: the bucket
    of the largest axis across all tensor leaves (power-of-two bucketing
    keeps key cardinality bounded under ragged traffic) and the first
    floating dtype seen, in the JAX package's spelling (``float32``)."""
    max_dim = 1
    dtype = "-"
    for leaf in _leaves(args, kwargs):
        shape = getattr(leaf, "shape", None)
        if shape:
            try:
                max_dim = max(max_dim, max(int(d) for d in shape))
            except (TypeError, ValueError):
                pass
        if dtype == "-":
            dt = getattr(leaf, "dtype", None)
            if dt is not None and "float" in str(dt):
                dtype = str(dt).replace("torch.", "")
    return shape_bucket(max_dim), dtype


def call_key(kernel: str, args: tuple = (), kwargs: Optional[dict] = None,
             kind: Optional[str] = None) -> str:
    """Render the 4-part ledger key for one call signature."""
    bucket, dtype = _bucket_token(args, kwargs or {})
    kernel = str(kernel).replace(SEP, "_")
    return SEP.join((kernel, bucket, dtype, kind or device_kind()))


class _Entry:
    __slots__ = ("key", "flops", "bytes", "transcendentals",
                 "peak_hbm_bytes", "arg_bytes", "out_bytes", "bytes_source",
                 "calls", "total_s", "min_s", "last_s")

    def __init__(self, key: str):
        self.key = key
        self.flops = 0.0
        self.bytes = 0.0
        self.transcendentals = 0.0
        self.peak_hbm_bytes: Optional[int] = None
        self.arg_bytes = 0
        self.out_bytes = 0
        self.bytes_source = "cost_analysis"
        self.calls = 0
        self.total_s = 0.0
        self.min_s: Optional[float] = None
        self.last_s: Optional[float] = None


class RooflineLedger:
    """Thread-safe ledger of per-callable counted costs + measured times."""

    def __init__(self, max_entries: int = MAX_ENTRIES):
        self._lock = locks.Lock("observability.roofline")
        self._entries: Dict[str, _Entry] = {}
        self._max = max_entries
        # (t_pc_us, kernel, achieved_flops_per_s, achieved_bytes_per_s)
        self._history: List[Tuple[float, str, float, float]] = []
        # CUDA event pairs not read yet: [(key, start, end)]
        self._pending: List[tuple] = []

    def _entry(self, key: str) -> _Entry:
        # caller holds the lock
        e = self._entries.get(key)
        if e is None:
            if len(self._entries) >= self._max:
                self._entries.pop(next(iter(self._entries)))
            e = self._entries[key] = _Entry(key)
        return e

    def note_compile(self, key: str, flops: float, bytes_accessed: float,
                     transcendentals: float = 0.0,
                     peak_hbm_bytes: Optional[int] = None,
                     arg_bytes: int = 0, out_bytes: int = 0,
                     bytes_source: str = "cost_analysis") -> None:
        """Record one entry's static costs. A zero byte count falls back to
        argument + output sizes so arithmetic intensity stays finite, with
        the source labeled honestly."""
        with self._lock:
            e = self._entry(key)
            e.flops = float(flops)
            e.transcendentals = float(transcendentals)
            e.arg_bytes = int(arg_bytes)
            e.out_bytes = int(out_bytes)
            if bytes_accessed and bytes_accessed > 0:
                e.bytes = float(bytes_accessed)
                e.bytes_source = bytes_source
            else:
                e.bytes = float(max(arg_bytes + out_bytes, 1))
                e.bytes_source = "arg_out_estimate"
            if peak_hbm_bytes:
                e.peak_hbm_bytes = int(peak_hbm_bytes)

    def observe(self, key: str, wall_s: float) -> None:
        """Book one measured call's seconds against an entry."""
        if wall_s <= 0:
            return
        with self._lock:
            e = self._entry(key)
            e.calls += 1
            e.total_s += wall_s
            e.last_s = wall_s
            e.min_s = wall_s if e.min_s is None else min(e.min_s, wall_s)
            if e.flops > 0 or e.bytes > 0:
                if len(self._history) >= MAX_HISTORY:
                    del self._history[: MAX_HISTORY // 2]
                self._history.append(
                    (time.perf_counter() * 1e6, key.split(SEP, 1)[0],
                     e.flops / wall_s, e.bytes / wall_s))

    def observe_events(self, key: str, start, end) -> None:
        """Queue one call's CUDA event pair; booked once the card passed
        it (:meth:`drain`)."""
        with self._lock:
            self._pending.append((key, start, end))

    def drain(self, wait: bool = False) -> None:
        """Book every queued event pair the card has passed (every one,
        waiting on each end event, with ``wait``)."""
        with self._lock:
            pending, self._pending = self._pending, []
        keep = []
        for key, start, end in pending:
            if wait:
                end.synchronize()
            elif not end.query():
                keep.append((key, start, end))
                continue
            self.observe(key, start.elapsed_time(end) / 1e3)
        if keep:
            with self._lock:
                self._pending[:0] = keep

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def keys(self) -> List[str]:
        with self._lock:
            return list(self._entries)

    def reset(self) -> None:
        with self._lock:
            self._entries.clear()
            del self._history[:]
            del self._pending[:]

    def history(self) -> List[Tuple[float, str, float, float]]:
        """Achieved-rate samples ``(t_pc_us, kernel, flops_per_s,
        bytes_per_s)``, oldest first — the Chrome counter-track feed."""
        with self._lock:
            return list(self._history)

    def snapshot(self) -> List[dict]:
        """Derived rows: intensity, achieved vs. peak, verdicts. Books the
        queued event pairs first (waiting on the card for them); every row
        carries a verdict (the acceptance contract for ``/roofline``)."""
        self.drain(wait=True)
        with self._lock:
            entries = [(e.key, e.flops, e.bytes, e.transcendentals,
                        e.peak_hbm_bytes, e.bytes_source,
                        e.calls, e.total_s, e.min_s, e.last_s)
                       for e in self._entries.values()]
        rows = []
        for (key, flops, bytes_, transc, peak_hbm, bytes_source,
             calls, total_s, min_s, last_s) in entries:
            parts = key.split(SEP)
            kind = parts[3] if len(parts) == 4 else device_kind()
            peak_f = mfu.peak_flops_for_kind(kind.replace("_", " "))
            peak_b = mfu.peak_hbm_bw_for_kind(kind.replace("_", " "))
            intensity = flops / bytes_ if bytes_ > 0 else 0.0
            t_flops = flops / peak_f if peak_f else 0.0
            t_bytes = bytes_ / peak_b if peak_b else 0.0
            t_pred = max(t_flops, t_bytes)
            row = {
                "key": key,
                "kernel": parts[0] if parts else key,
                "shape_bucket": parts[1] if len(parts) > 1 else "-",
                "dtype": parts[2] if len(parts) > 2 else "-",
                "device_kind": kind,
                "flops": flops,
                "bytes": bytes_,
                "transcendentals": transc,
                "bytes_source": bytes_source,
                "peak_hbm_bytes": peak_hbm,
                "arithmetic_intensity": intensity,
                "predicted_device_s": t_pred,
                "calls": calls,
                "total_s": total_s,
                "min_s": min_s,
                "last_s": last_s,
            }
            # static classification: which roofline slope the callable sits
            # under at this intensity
            static = (COMPUTE_BOUND if t_flops >= t_bytes and flops > 0
                      else MEMORY_BOUND)
            wall = min_s  # the best time strips scheduler noise
            if wall and wall > 0:
                row["achieved_flops_per_s"] = flops / wall
                row["achieved_bytes_per_s"] = bytes_ / wall
                row["flops_frac_of_peak"] = (
                    flops / wall / peak_f if peak_f else None)
                row["bw_frac_of_peak"] = (
                    bytes_ / wall / peak_b if peak_b else None)
                overhead = max(0.0, (wall - t_pred) / wall)
                row["overhead_frac"] = overhead
                row["verdict"] = (OVERHEAD_BOUND
                                  if overhead > OVERHEAD_FRAC_THRESHOLD
                                  else static)
            else:
                # counted but never timed: classify on the static sides
                # alone; there is no honest overhead number yet
                row["achieved_flops_per_s"] = None
                row["achieved_bytes_per_s"] = None
                row["flops_frac_of_peak"] = None
                row["bw_frac_of_peak"] = None
                row["overhead_frac"] = 0.0
                row["verdict"] = static
            rows.append(row)
        rows.sort(key=lambda r: r["key"])
        return rows

    def summary(self) -> dict:
        """Verdict histogram + totals for bench JSON / flight bundles."""
        rows = self.snapshot()
        verdicts: Dict[str, int] = {}
        for r in rows:
            verdicts[r["verdict"]] = verdicts.get(r["verdict"], 0) + 1
        return {
            "entries": len(rows),
            "verdicts": verdicts,
            "total_flops": sum(r["flops"] for r in rows),
            "total_bytes": sum(r["bytes"] for r in rows),
            "calls": sum(r["calls"] for r in rows),
        }


_default = RooflineLedger()


def default_ledger() -> RooflineLedger:
    return _default


def reset_ledger() -> None:
    _default.reset()


def snapshot() -> List[dict]:
    return _default.snapshot()


def summary() -> dict:
    return _default.summary()


def history() -> List[Tuple[float, str, float, float]]:
    return _default.history()


def note_compile(key: str, **kw) -> None:
    _default.note_compile(key, **kw)


def observe_call(key: str, wall_s: float) -> None:
    _default.observe(key, wall_s)


def predicted_seconds(flops: float, bytes_accessed: float,
                      kind: Optional[str] = None) -> Optional[float]:
    """Roofline-predicted device seconds max(F/P_f, B/P_b); None when
    neither peak is known for the device kind."""
    kind = (kind or device_kind()).replace("_", " ")
    peak_f = mfu.peak_flops_for_kind(kind)
    peak_b = mfu.peak_hbm_bw_for_kind(kind)
    t_f = flops / peak_f if peak_f else None
    t_b = bytes_accessed / peak_b if peak_b else None
    if t_f is None and t_b is None:
        return None
    return max(t_f or 0.0, t_b or 0.0)


def memory_capture_enabled(device=None) -> bool:
    """Whether a first call's peak memory is captured:
    ``flags().roofline_memory`` is ``auto`` (on for a CUDA device, off for
    the CPU), ``on`` or ``off``."""
    from paddle_tpu_torch.core import config

    v = str(config.flags().roofline_memory).lower()
    if v in ("1", "on", "true", "yes"):
        return True
    if v in ("0", "off", "false", "no"):
        return False
    return device is not None and torch.device(device).type == "cuda"


def _tensor_bytes(tree) -> int:
    return sum(int(t.numel() * t.element_size()) for t in _leaves(tree, {})
               if isinstance(t, torch.Tensor))


def _call_device(args: tuple, kwargs: dict) -> torch.device:
    for leaf in _leaves(args, kwargs):
        if isinstance(leaf, torch.Tensor):
            return leaf.device
    return torch.device("cpu")


def capture_costs(fn: Callable, key: str, args: tuple, kwargs: dict):
    """Run ``fn`` once under the cost counter and note the counted FLOPs
    and bytes (and, under :func:`memory_capture_enabled`, the allocator's
    peak over the call) in the ledger. Returns ``fn``'s result."""
    dev = _call_device(args, kwargs)
    memory = dev.type == "cuda" and memory_capture_enabled(dev)
    if memory:
        torch.cuda.reset_peak_memory_stats(dev)
    with mfu.CostCounter() as counter:
        out = fn(*args, **kwargs)
    note_compile(
        key, flops=counter.flops, bytes_accessed=counter.bytes,
        peak_hbm_bytes=torch.cuda.max_memory_allocated(dev) if memory else None,
        arg_bytes=_tensor_bytes(args), out_bytes=_tensor_bytes(out),
        bytes_source="counted")
    return out


class Instrumented:
    """Wrap a callable so its first call at each key lands its counted
    costs in the ledger and every later call books its device time. The
    decode engine's step functions and ``Executor.prepare`` use this."""

    __slots__ = ("_fn", "_kernel", "_kind", "_seen")

    def __init__(self, fn: Callable, kernel: str):
        self._fn = fn
        self._kernel = kernel
        self._kind: Optional[str] = None
        self._seen: set = set()

    def __call__(self, *args, **kwargs):
        if not enabled():
            return self._fn(*args, **kwargs)
        dev = _call_device(args, kwargs)
        if self._kind is None:
            self._kind = device_kind(dev)
        key = call_key(self._kernel, args, kwargs, kind=self._kind)
        if key not in self._seen:
            self._seen.add(key)
            return capture_costs(self._fn, key, args, kwargs)
        if dev.type != "cuda":
            t0 = time.perf_counter()
            out = self._fn(*args, **kwargs)
            observe_call(key, time.perf_counter() - t0)
            return out
        _default.drain()
        stream = torch.cuda.current_stream(dev)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record(stream)
        out = self._fn(*args, **kwargs)
        end.record(stream)
        _default.observe_events(key, start, end)
        return out


def instrument(kernel: str, fn: Callable) -> Callable:
    """Ledger-instrument one callable."""
    return Instrumented(fn, kernel)
