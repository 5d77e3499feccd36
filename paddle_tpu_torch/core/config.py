"""Typed runtime flags and device selection.

The flags the ported slice reads, with the names, defaults and
``PADDLE_TPU_<NAME>`` environment overrides of ``paddle_tpu.core.config``.
The port keeps its own flag object: setting a flag here does not touch the
JAX package's flags.

Device selection replaces the JAX package's Places: entry points take a
``device`` argument that defaults to ``"cuda"`` and raise when CUDA is
absent, so a run never falls back to the CPU silently. The CPU runs only
when the caller asks for it (``device="cpu"``), as the tests do.
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


def resolve_device(device="cuda") -> torch.device:
    """The ``torch.device`` an entry point runs on. CUDA is the default and
    is required unless the caller passes ``device="cpu"``: there is no
    silent CPU fallback."""
    dev = torch.device(device)
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
