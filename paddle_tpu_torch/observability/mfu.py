"""MFU, goodput, and the step FLOP and byte counter.

Port of ``paddle_tpu.observability.mfu``. MFU (model FLOPs utilization) =
achieved model FLOPs per second divided by the card's peak — the
achieved-vs-peak framing of Tensor Processing Primitives (arxiv
2104.05755). The JAX package reads the step's FLOPs from XLA's cost model;
here :class:`CostCounter`, a ``TorchDispatchMode``, runs the step once and
sums the FLOPs of every product through ``torch.utils.flop_counter``'s
formulas and the bytes of every op's inputs and outputs (views and
allocations move none), the analogue of XLA's "bytes accessed". The
hand-written flash kernels are launched through ``ctypes`` and are
invisible to a dispatch mode: their wrapper reports each call's FLOPs and
bytes itself (:func:`report_kernel`), and on the CPU runs its plain
version with the counter paused (:func:`paused`), so a step counts the
same FLOPs on the CPU and on the card.

Peak FLOPs resolve in priority order:

1. :func:`set_peak_flops`, then ``PADDLE_TPU_PEAK_FLOPS`` env /
   ``peak_flops`` flag (per-device override),
2. the device-name table below, matched by substring against
   ``torch.cuda.get_device_name()`` (first hit wins): dense bf16 peaks
   from NVIDIA's H100 datasheet; the ``cpu`` entry is a nominal
   placeholder so CPU runs still report a finite utilization — override
   it for a real host.

:func:`cost_flops` is the JAX function's analogue: one call's FLOPs,
counted while it runs. The JAX package's ``cost_analysis_totals`` and
``lowered_flops`` read XLA's cost analysis of a lowered computation,
which PyTorch's eager calls do not have: not applicable.

Goodput is the fraction of wall time spent making forward progress:
:class:`GoodputTracker` charges time lost to NaN-skipped steps, rollbacks,
retries, and stalls against per-category *badput* counters.
"""

from __future__ import annotations

import contextlib
from collections import defaultdict
from typing import Dict, Iterator, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode, _get_current_dispatch_mode_stack
from torch.utils._pytree import tree_flatten

from paddle_tpu_torch.core import locks

__all__ = [
    "PEAK_FLOPS_TABLE",
    "PEAK_HBM_BW_TABLE",
    "device_kind",
    "peak_flops",
    "peak_flops_for_kind",
    "peak_hbm_bw_for_kind",
    "set_peak_flops",
    "set_peak_hbm_bw",
    "CostCounter",
    "report_kernel",
    "paused",
    "cost_flops",
    "mfu",
    "GoodputTracker",
]

# dense bf16 peak FLOP/s per device, matched by substring against the
# lower-cased device name (e.g. "nvidia h100 80gb hbm3"). Order matters:
# first hit wins, so the PCIe and NVL parts precede the SXM5 "h100".
PEAK_FLOPS_TABLE: Tuple[Tuple[str, float], ...] = (
    ("h100 pcie", 756e12),
    ("h100 nvl", 835e12),
    ("h100", 989.4e12),
    # nominal host fallback (~a few AVX cores) so CPU runs report a finite
    # MFU; override with PADDLE_TPU_PEAK_FLOPS for a real number
    ("cpu", 5e10),
)

# Peak memory bandwidth (bytes/s) per device, same substring-match
# discipline as PEAK_FLOPS_TABLE — the denominator of the roofline's
# memory side. The ``cpu`` entry is a nominal DDR figure so CPU runs
# still classify; override with PADDLE_TPU_PEAK_HBM_BW.
PEAK_HBM_BW_TABLE: Tuple[Tuple[str, float], ...] = (
    ("h100 pcie", 2.0e12),
    ("h100 nvl", 3.9e12),
    ("h100", 3.35e12),
    ("cpu", 50e9),
)

_override_lock = locks.Lock("observability.mfu_override")
_override: Optional[float] = None
_bw_override: Optional[float] = None


def set_peak_flops(value: Optional[float]) -> None:
    """Programmatic per-device peak override (None clears it)."""
    global _override
    with _override_lock:
        _override = float(value) if value else None


def set_peak_hbm_bw(value: Optional[float]) -> None:
    """Programmatic peak-bandwidth override (None clears it)."""
    global _bw_override
    with _override_lock:
        _bw_override = float(value) if value else None


def _flag_override() -> Optional[float]:
    from paddle_tpu_torch.core import config

    v = config.flags().peak_flops
    return float(v) if v and v > 0 else None


def _bw_flag_override() -> Optional[float]:
    from paddle_tpu_torch.core import config

    v = config.flags().peak_hbm_bw
    return float(v) if v and v > 0 else None


def peak_flops_for_kind(device_kind: str) -> Optional[float]:
    """Peak FLOP/s for a device-name string; override beats the table."""
    with _override_lock:
        if _override is not None:
            return _override
    flagged = _flag_override()
    if flagged is not None:
        return flagged
    kind = (device_kind or "").lower()
    for marker, peak in PEAK_FLOPS_TABLE:
        if marker in kind:
            return peak
    return None


def peak_hbm_bw_for_kind(device_kind: str) -> Optional[float]:
    """Peak bytes/s for a device-name string; override beats the table.
    None when the name matches no row."""
    with _override_lock:
        if _bw_override is not None:
            return _bw_override
    flagged = _bw_flag_override()
    if flagged is not None:
        return flagged
    kind = (device_kind or "").lower()
    for marker, peak in PEAK_HBM_BW_TABLE:
        if marker in kind:
            return peak
    return None


def device_kind(device=None) -> str:
    """The name the peak tables match: ``torch.cuda.get_device_name`` for a
    card (default: the current one when CUDA is present), ``"cpu"`` for
    the CPU."""
    dev = torch.device(device) if device is not None else (
        torch.device("cuda") if torch.cuda.is_available() else torch.device("cpu"))
    if dev.type == "cuda":
        return torch.cuda.get_device_name(dev)
    return dev.type


def peak_flops(device=None) -> Optional[float]:
    """Peak FLOP/s for one device (default: the current card, else the
    CPU)."""
    return peak_flops_for_kind(device_kind(device))


# -- the step FLOP and byte counter ------------------------------------------

# ops that move no bytes although they return tensors (views are told
# apart by their schema; these allocate without writing)
_NO_TRAFFIC = frozenset(("empty", "empty_like", "empty_strided", "new_empty",
                         "new_empty_strided", "resize_", "set_"))
# gathers read only the rows they return from their first argument (an
# embedding table, a pool of KV pages), and indexed writes touch only the
# rows they write: both count their other arguments and the moved rows
_GATHERS = frozenset(("index", "index_select", "gather", "embedding", "take"))
_SCATTERS = frozenset(("index_put", "index_put_", "index_copy", "index_copy_",
                       "scatter", "scatter_", "index_add", "index_add_"))


def _nbytes(tree) -> int:
    leaves, _ = tree_flatten(tree)
    return sum(t.numel() * t.element_size() for t in leaves if isinstance(t, torch.Tensor))


def _op_bytes(name: str, args, kwargs, out) -> int:
    """Bytes one op moves: its tensor inputs read and outputs written once,
    a gather's source rows and an indexed write's target rows only as far
    as they are moved."""
    if name in _GATHERS:
        return _nbytes((args[1:], kwargs)) + 2 * _nbytes(out)
    if name in _SCATTERS:
        return 2 * _nbytes((args[1:], kwargs))
    return _nbytes((args, kwargs)) + _nbytes(out)


class CostCounter(TorchDispatchMode):
    """Sum FLOPs and bytes of everything dispatched while active (on this
    thread, and on the autograd threads its backward runs on):
    ``with CostCounter() as c: step(...)``, then ``c.flops``, ``c.bytes``.

    FLOPs: ``torch.utils.flop_counter.flop_registry``'s formula for each op
    that has one (products, convolutions, fused attention); elementwise
    ops count none, as in ``FlopCounterMode``. Bytes: each op's tensor
    inputs read once and outputs written once, except views and bare
    allocations, and gathers and indexed writes only as far as they move
    rows (:func:`_op_bytes`). The hand-written kernels add theirs through
    :func:`report_kernel`. ``by_op`` splits the FLOPs by op name."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.by_op: Dict[str, int] = defaultdict(int)
        self._paused = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not self._paused:
            from torch.utils.flop_counter import flop_registry

            packet = func._overloadpacket
            formula = flop_registry.get(packet)
            if formula is not None:
                # the formulas take shapes: an ``out_dtype`` overload's
                # ScalarType (``bmm.dtype``) is no operand of theirs
                n = int(formula(*(a for a in args if not isinstance(a, torch.dtype)),
                                **{k: v for k, v in kwargs.items() if k != "out_dtype"},
                                out_val=out))
                self.flops += n
                self.by_op[packet.__name__] += n
            if not func.is_view and packet.__name__ not in _NO_TRAFFIC:
                self.bytes += _op_bytes(packet.__name__, args, kwargs, out)
        return out

    def add(self, name: str, flops: int, nbytes: int) -> None:
        if not self._paused:
            self.flops += int(flops)
            self.bytes += int(nbytes)
            self.by_op[name] += int(flops)


def _active_counters() -> list:
    return [m for m in _get_current_dispatch_mode_stack() if isinstance(m, CostCounter)]


def report_kernel(name: str, flops: int, nbytes: int) -> None:
    """A hand-written kernel's call, reported by its wrapper to every
    :class:`CostCounter` active on this thread (a no-op without one)."""
    for counter in _active_counters():
        counter.add(name, flops, nbytes)


@contextlib.contextmanager
def paused() -> Iterator[None]:
    """Count nothing in this block: a kernel wrapper's plain version on the
    CPU, whose call the wrapper has already reported."""
    counters = _active_counters()
    for counter in counters:
        counter._paused += 1
    try:
        yield
    finally:
        for counter in counters:
            counter._paused -= 1


def cost_flops(fn, *args, **kwargs) -> float:
    """The FLOPs of one call ``fn(*args, **kwargs)``, counted by a
    :class:`CostCounter` while it runs (the call runs; its result is
    dropped)."""
    with CostCounter() as counter:
        fn(*args, **kwargs)
    return float(counter.flops)


def mfu(flops_per_step: float, step_time_s: float, device_count: int = 1,
        peak_per_device: Optional[float] = None) -> Optional[float]:
    """Model FLOPs utilization in [0, ~1]; None when peak is unknown."""
    if peak_per_device is None:
        peak_per_device = peak_flops()
    if not peak_per_device or step_time_s <= 0 or flops_per_step <= 0:
        return None
    return flops_per_step / (step_time_s * max(1, device_count) * peak_per_device)


class GoodputTracker:
    """Splits run time into goodput (productive step time) and badput
    (time charged to a failure category: nan_skip, rollback, stall, ...)."""

    def __init__(self):
        self._lock = locks.Lock("observability.goodput")
        self._good_s = 0.0
        self._bad_s: Dict[str, float] = {}

    def record_good(self, seconds: float) -> None:
        with self._lock:
            self._good_s += max(0.0, seconds)

    def record_bad(self, seconds: float, category: str) -> None:
        with self._lock:
            self._bad_s[category] = self._bad_s.get(category, 0.0) + max(0.0, seconds)

    def good_seconds(self) -> float:
        with self._lock:
            return self._good_s

    def bad_seconds(self) -> float:
        with self._lock:
            return sum(self._bad_s.values())

    def badput_by_category(self) -> Dict[str, float]:
        with self._lock:
            return dict(self._bad_s)

    def goodput_frac(self) -> float:
        """good / (good + bad); 1.0 for an untroubled (or empty) run."""
        with self._lock:
            total = self._good_s + sum(self._bad_s.values())
            return self._good_s / total if total > 0 else 1.0

    def snapshot(self) -> Dict[str, float]:
        with self._lock:
            total = self._good_s + sum(self._bad_s.values())
            snap = {
                "good_seconds": self._good_s,
                "bad_seconds": sum(self._bad_s.values()),
                "goodput_frac": self._good_s / total if total > 0 else 1.0,
            }
            for cat, s in self._bad_s.items():
                snap[f"bad_seconds.{cat}"] = s
            return snap
