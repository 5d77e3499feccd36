"""Memory optimization: rematerialization policies, port of
``paddle_tpu/transpiler/memory.py``.

Reference: ``python/paddle/fluid/transpiler/memory_optimization_transpiler.py``
(``memory_optimize`` at :384 — CFG liveness + in-place var reuse;
``release_memory`` inserts delete_var ops). PyTorch's caching allocator
already reuses freed blocks and frees a tensor at its last reference, so
what remains profitable is trading FLOPs for memory by rematerialization:
``torch.utils.checkpoint`` (the JAX package's ``jax.checkpoint``).

Named policies, as in the JAX package (what to KEEP, not recompute):

- ``full_remat``: keep nothing; the whole region recomputes in backward;
- ``save_dots``: keep the outputs of the products (``mm``, ``bmm``,
  ``addmm``, ``baddbmm``) and convolutions, recompute the rest —
  selective activation checkpointing
  (``torch.utils.checkpoint.create_selective_checkpoint_contexts``);
- ``save_dots_with_no_batch_dims``: the same without the batched products
  (``bmm``, ``baddbmm``), as JAX's ``dots_with_no_batch_dims_saveable``.

A callable policy passes through: ``policy(ctx, op, *args, **kwargs)``
returning a ``torch.utils.checkpoint.CheckpointPolicy``.
"""

from __future__ import annotations

from typing import Callable, Optional, Union

import torch
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

__all__ = ["memory_optimize", "release_memory", "POLICIES"]

_aten = torch.ops.aten
_NO_BATCH_DOTS = (_aten.mm.default, _aten.addmm.default, _aten.convolution.default)
_DOTS = _NO_BATCH_DOTS + (_aten.bmm.default, _aten.baddbmm.default)


def _saving(ops) -> Callable:
    def policy(ctx, op, *args, **kwargs):
        return CheckpointPolicy.MUST_SAVE if op in ops else CheckpointPolicy.PREFER_RECOMPUTE

    return policy


# named remat policies: what to KEEP (not recompute); None keeps nothing
POLICIES = {
    "full_remat": None,
    "save_dots": _saving(_DOTS),
    "save_dots_with_no_batch_dims": _saving(_NO_BATCH_DOTS),
}


def _remat(fn: Callable, policy: Optional[Callable], *args, rng=None):
    """``fn(*args)`` under ``torch.utils.checkpoint`` with ``policy``.
    ``rng`` (an explicit ``torch.Generator`` the region draws from) is
    rewound before the recompute, so dropout masks replay; the default
    generators are checkpoint's own ``preserve_rng_state``."""
    state0 = rng.get_state() if rng is not None else None

    def run(*a):
        if state0 is not None:
            rng.set_state(state0)
        return fn(*a)

    kwargs = {}
    if policy is not None:
        kwargs["context_fn"] = lambda: create_selective_checkpoint_contexts(policy)
    return checkpoint(run, *args, use_reentrant=False, **kwargs)


def memory_optimize(
    fn_or_model,
    policy: Union[str, Callable, None] = "full_remat",
    prevent_cse: bool = True,
):
    """Wrap a function (or a Model's apply) in rematerialization with a
    named policy — the ``fluid.memory_optimize(program)`` API shape,
    re-targeted at activation rematerialization: under autograd the
    wrapped region's activations are recomputed in the backward pass
    instead of being kept. ``prevent_cse`` is the JAX package's knob for
    XLA's common-subexpression elimination; eager PyTorch has none, so it
    is accepted and has no effect."""
    if isinstance(policy, str):
        if policy not in POLICIES:
            raise KeyError(f"unknown remat policy {policy!r}; known: {sorted(POLICIES)}")
        policy = POLICIES[policy]

    from paddle_tpu_torch.framework import Model

    if isinstance(fn_or_model, Model):
        return _RematModel(fn_or_model, policy)
    return lambda *args: _remat(fn_or_model, policy, *args)


class _RematModel:
    """Model wrapper whose apply() runs under rematerialization."""

    def __init__(self, inner, policy):
        self._inner = inner
        self._policy = policy
        self.name = inner.name + "_remat"

    @property
    def param_info(self):
        return self._inner.param_info

    def init(self, rng=None, *args, **kwargs):
        return self._inner.init(rng, *args, **kwargs)

    def apply(self, variables, *args, rng=None, is_train: bool = False, **kwargs):
        def fn(*a):
            return self._inner.apply(variables, *a, rng=rng, is_train=is_train, **kwargs)

        return _remat(fn, self._policy, *args, rng=rng)


def release_memory(*_args, **_kwargs) -> None:
    """No-op (API parity with ``fluid.release_memory``): the reference
    inserted delete_var ops to free dead tensors mid-program; PyTorch frees
    a tensor at its last reference."""
    return None
