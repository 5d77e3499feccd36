"""The global batch of a data-parallel step.

Under the JAX package's ``DataParallel`` the step is one program over the
global batch, so every reduction over the batch dimension is global. Here
each rank runs a forward over its own rows; while a ``DataParallel`` step
runs (and only then), :func:`global_batch` makes the few batch reductions
that need it global again:

- BatchNorm's statistics and their gradient terms
  (``ops/nn.py::batch_norm_train``);
- the normalizers of ratio losses (the LM's ragged ``sum(nll·valid) /
  n_tok``, the NMT's token-weighted loss): ``n_tok`` is summed over the
  group (a value, no gradient), and the rank's loss is scaled by the
  group's size, so that the MEAN over ranks of the losses and of their
  gradients — the one reduction ``DataParallel`` applies — is the global
  ratio and its gradient. A plain mean over equal shards needs nothing.

Outside the context every function here is an identity, so the
single-device paths are unchanged. The context is per thread, like the
framework's frames; a rematerialized block re-enters it in the backward
(``framework.checkpoint``).
"""

from __future__ import annotations

import contextlib
import threading
from typing import Iterator, Optional, Union

import torch
import torch.distributed as dist

__all__ = ["BatchGroup", "global_batch", "active", "global_sum", "global_count", "scale_ratio"]

_tls = threading.local()


class BatchGroup:
    """The process group a step's batch is split over, and its size."""

    def __init__(self, group, size: int):
        self.group = group
        self.size = int(size)

    def all_reduce_(self, t: torch.Tensor) -> torch.Tensor:
        """Sum ``t`` over the group, in place."""
        if self.group is not None:
            dist.all_reduce(t, group=self.group)
        return t


@contextlib.contextmanager
def global_batch(group: Optional[BatchGroup]) -> Iterator[None]:
    """Make batch reductions global over ``group`` (None: leave them
    local) for the calls inside."""
    prev = getattr(_tls, "group", None)
    _tls.group = group
    try:
        yield
    finally:
        _tls.group = prev


def active() -> Optional[BatchGroup]:
    """The group of the running data-parallel step, or None."""
    group = getattr(_tls, "group", None)
    return group if group is not None and group.group is not None else None


def global_sum(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over the step's group, as a value (no gradient)."""
    group = active()
    if group is None:
        return t
    return group.all_reduce_(t.detach().clone())


def global_count(n: Union[int, float]) -> Union[int, float]:
    """A count taken from static shapes, over the group: every rank holds
    an equal shard, so it is the rank's count times the group's size."""
    group = active()
    return n if group is None else n * group.size


def scale_ratio(loss: torch.Tensor) -> torch.Tensor:
    """A ratio loss whose normalizer is already global, scaled so that the
    mean over the group's ranks is the global ratio."""
    group = active()
    return loss if group is None else loss * group.size
