"""Typed runtime flags and device selection.

The flags the ported slice reads, with the names, defaults and
``PADDLE_TPU_<NAME>`` environment overrides of ``paddle_tpu.core.config``.
The port keeps its own flag object: setting a flag here does not touch the
JAX package's flags.

Device selection replaces the JAX package's Places: entry points take a
``device`` argument that defaults to ``"cuda"`` and raise when CUDA is
absent, so a run never falls back to the CPU silently. The CPU runs only
when the caller asks for it (``device="cpu"``), as the tests do. Fluid's
Places are kept as selectors that :func:`resolve_device` accepts
(``Executor(CPUPlace())``, ``CUDAPlace(0)``); the JAX package's
``TPUPlace`` does not apply to a card, nor does ``apply_compile_cache``
(XLA's persistent compilation cache: the port compiles its kernels with
``nvcc`` into a cache keyed by the source's hash, ``ops/cuda/build.py``).
"""

from __future__ import annotations

import dataclasses
import os

import torch


@dataclasses.dataclass
class Flags:
    """Global runtime flags (gflags parity, typed)."""

    # verbosity for vlog()
    v: int = 0
    # numeric sanitizer: Optimizer.minimize's step reports in
    # StepOutput.finite whether the loss and every gradient are finite
    check_nan_inf: bool = False
    # what the Trainer does with a non-finite step when check_nan_inf is on:
    # "raise" | "skip_step" | "rollback" (see resilience.ResilienceConfig)
    check_nan_inf_policy: str = "raise"
    # consecutive bad steps before the "rollback" policy restores the last
    # good checkpoint
    nan_rollback_after: int = 3
    # mixed precision: bf16 tensor-core operands, f32 accumulation
    use_bf16_compute: bool = False
    # route unmasked/causal attention through the hand-written flash kernel
    use_flash_attention: bool = False
    # flash attention's backward: the fused dK/dV and dQ kernels when on,
    # else autograd through the recomputed plain attention (no kernel)
    flash_fused_bwd: bool = True
    # consult the autotune store for kernel block configs (the store is not
    # ported yet: resolve_blocks raises while this is on)
    autotune: bool = False
    # default seed for parameter initialization when none is given
    seed: int = 0
    # host data pipeline: batches the Trainer's prefetcher keeps in flight
    # (reference double_buffer reader, operators/reader/buffered_reader.cc)
    prefetch_depth: int = 2
    # multi-tenant serving (serving.admission / serving.scheduler):
    # per-tenant queued-request quota
    tenant_queue_capacity: int = 64
    # per-tenant queued-payload byte quota (0 = unlimited)
    tenant_byte_quota: int = 0
    # priority class of a request submitted without one
    tenant_default_class: str = "interactive"
    # batch-class drain share the scheduler guarantees under interactive
    # pressure
    tenant_batch_min_share: float = 0.1
    # directory for core.profiler.profiler() traces; empty = a directory
    # under the process's temporary directory
    profile_dir: str = ""
    # observability: Prometheus exporter bind port (-1 = disabled, 0 = pick
    # an ephemeral port; see paddle_tpu_torch.observability.ObservabilityConfig)
    metrics_port: int = -1
    metrics_host: str = "127.0.0.1"
    # append-only JSONL run-event log path; empty = disabled
    runlog_path: str = ""
    # size-based runlog rollover: rotate the active file when it would
    # exceed this many bytes (0 = never rotate), keeping runlog_keep
    # rotated segments (path.1 .. path.N, oldest dropped)
    runlog_max_bytes: int = 0
    runlog_keep: int = 3
    # per-device peak FLOP/s override for MFU accounting (0 = use the
    # device-name table in observability/mfu.py)
    peak_flops: float = 0.0
    # peak memory bandwidth (bytes/s) override for roofline classification
    # (0 = use the device-name table in observability/mfu.py)
    peak_hbm_bw: float = 0.0
    # roofline cost ledger: count each instrumented callable's FLOPs and
    # bytes on its first call and book later calls' device seconds
    # (observability/roofline.py; /roofline on the exporter)
    roofline: bool = True
    # peak-memory capture of that first call (torch.cuda.max_memory_allocated
    # around it): "auto" = on for CUDA, off for the CPU; "on"/"off" force it
    roofline_memory: str = "auto"
    # tracing: bounded in-memory span store size (oldest spans evicted;
    # evictions counted under tracing.spans_evicted)
    trace_max_spans: int = 200_000
    # straggler detector: flag a replica/step whose duration exceeds the
    # group median by this ratio (see paddle_tpu_torch.tracing.straggler)
    straggler_ratio: float = 2.5
    # lock-order deadlock detection for core.locks instrumented wrappers
    # (always on under pytest; this flag turns it on elsewhere — env
    # PADDLE_TPU_LOCK_CHECK=1)
    lock_check: bool = False
    # elastic training (see paddle_tpu_torch.resilience.elastic): re-form
    # the process group over the surviving ranks and keep training instead
    # of crashing
    elastic: bool = False
    # refuse to shrink below this many surviving ranks
    elastic_min_devices: int = 1
    # re-expand the world at a checkpoint boundary when lost ranks return
    elastic_regrow: bool = True
    # consecutive watchdog stalls that escalate to a liveness probe
    elastic_escalate_stalls: int = 2

    @staticmethod
    def _coerce(value: str, typ):
        if typ is bool:
            return value.lower() in ("1", "true", "yes", "on")
        return typ(value)

    def load_env(self) -> "Flags":
        """Override fields from PADDLE_TPU_<UPPERNAME> env vars."""
        for f in dataclasses.fields(self):
            env = os.environ.get(f"PADDLE_TPU_{f.name.upper()}")
            if env is not None:
                setattr(self, f.name, self._coerce(env, type(getattr(self, f.name))))
        return self


_flags = Flags().load_env()


def flags() -> Flags:
    return _flags


def set_flags(**kwargs) -> None:
    for k, v in kwargs.items():
        if not hasattr(_flags, k):
            raise AttributeError(f"unknown flag {k!r}")
        setattr(_flags, k, v)


class Place:
    """Fluid's device selector (``platform/place.h:134``): what
    :func:`resolve_device` turns into a ``torch.device``."""

    platform: str = "cpu"
    device_id: int = 0

    def torch_device(self) -> torch.device:
        return torch.device(self.platform if self.platform == "cpu"
                            else f"{self.platform}:{self.device_id}")

    def __repr__(self):
        return f"{type(self).__name__}()"

    def __eq__(self, other):
        return type(self) is type(other) and self.device_id == other.device_id

    def __hash__(self):
        return hash((type(self).__name__, self.device_id))


class CPUPlace(Place):
    platform = "cpu"


class CUDAPlace(Place):
    platform = "cuda"

    def __init__(self, device_id: int = 0):
        self.device_id = int(device_id)

    def __repr__(self):
        return f"CUDAPlace({self.device_id})"


def default_place() -> Place:
    """``CUDAPlace(0)``, the port's default device (the JAX package's
    default is its accelerator). There is no CPU fallback:
    :func:`resolve_device` raises on it where no card is visible, and the
    CPU is asked for with ``CPUPlace()``."""
    return CUDAPlace(0)


def resolve_device(device="cuda") -> torch.device:
    """The ``torch.device`` an entry point runs on (a name, a
    ``torch.device`` or a :class:`Place`). CUDA is the default and is
    required unless the caller passes ``device="cpu"``: there is no silent
    CPU fallback."""
    dev = device.torch_device() if isinstance(device, Place) else torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but CUDA is not available; pass "
            "device='cpu' to run the plain PyTorch path on the CPU"
        )
    return dev


def on_device(t: torch.Tensor, device: torch.device) -> bool:
    """Whether ``t`` lives on ``device`` (``cuda`` matches the current card)."""
    if t.device.type != device.type:
        return False
    if device.index is None:
        return t.device.type != "cuda" or t.device.index == torch.cuda.current_device()
    return t.device.index == device.index
