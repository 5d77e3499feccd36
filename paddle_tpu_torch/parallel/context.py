"""The global batch of a data-parallel step.

Under the JAX package's ``DataParallel`` the step is one program over the
global batch, so every reduction over the batch's tokens is global. Here
each rank runs a forward over its own block of the batch: its rows (split
over the axes the batch specs split dim 0 over, ``data`` by default, in the
JAX device order: row-major over the axes as listed, e.g.
``P(("data", "expert"))``) and, when the batch specs split the sequence dim
too (``P("data", "seq")``), its segment of every row (the ``seq`` axis). While
a ``DataParallel`` step runs (and only then), :func:`global_batch` makes
the reductions that need it global again:

- BatchNorm's statistics and their gradient terms
  (``ops/nn.py::batch_norm_train``);
- the normalizers of ratio losses (the LM's ragged ``sum(nll·valid) /
  n_tok``, the NMT's token-weighted loss): ``n_tok`` is summed over the
  group (a value, no gradient), and the rank's loss is scaled by the
  group's size, so that the MEAN over ranks of the losses and of their
  gradients — the one reduction ``DataParallel`` applies — is the global
  ratio and its gradient. A plain mean over equal shards needs nothing;
- the positions of a sequence-sharded rank's tokens (:func:`seq_offset`):
  embeddings, rope, the loss mask and the ragged token masks use GLOBAL
  positions;
- the mixture-of-experts router's global quantities (``parallel/moe.py``):
  the capacity's token count (:func:`global_count`), the buffer positions
  as an exclusive prefix of per-expert counts in the global ``(b, t)``
  order (:func:`row_prefix`), and the load-balance statistics
  (:func:`token_sum`, differentiable).

Outside the context every function here is an identity, so the
single-device paths are unchanged. The context is per thread, like the
framework's frames; a rematerialized block re-enters it in the backward
(``framework.checkpoint``).
"""

from __future__ import annotations

import contextlib
import threading
from typing import Iterator, Optional, Sequence, Tuple, Union

import torch

__all__ = ["BatchGroup", "global_batch", "active", "global_sum", "global_count", "scale_ratio",
           "seq_split", "rows_split_over", "seq_offset", "token_sum", "row_prefix"]

_tls = threading.local()


class BatchGroup:
    """The mesh axes a step's tokens are split over — the axes its rows are
    split over (row-major, as the batch specs list them) and, in a
    sequence-sharded step, ``seq`` (segments of each row) — with this
    rank's process group on each and the group's total size."""

    def __init__(self, mesh, axes: Sequence[str], seq_axis: Optional[str] = None):
        self.mesh = mesh
        self.axes = tuple(axes)
        self.seq_axis = seq_axis
        self.row_axes = tuple(a for a in self.axes if a != seq_axis)
        self.groups = [mesh.group(a) for a in self.axes]
        self.size = 1
        for a in self.axes:
            self.size *= int(mesh.shape[a])

    @property
    def group(self):
        """A process group of the step, None without one (then the context
        is inert)."""
        return next((g for g in self.groups if g is not None), None)

    def all_reduce_(self, t: torch.Tensor) -> torch.Tensor:
        """Sum ``t`` over the group (each axis in turn), in place."""
        import torch.distributed as dist

        for g in self.groups:
            if g is not None:
                dist.all_reduce(t, group=g)
        return t

    def index(self, axis: str) -> int:
        return self.mesh.axis_index(axis) if self.mesh.shape[axis] > 1 else 0

    def row_block(self) -> int:
        """This rank's block of the global batch's rows: row-major over the
        row axes."""
        i = 0
        for a in self.row_axes:
            i = i * int(self.mesh.shape[a]) + self.index(a)
        return i


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
    an equal block, so it is the rank's count times the group's size."""
    group = active()
    return n if group is None else n * group.size


def scale_ratio(loss: torch.Tensor) -> torch.Tensor:
    """A ratio loss whose normalizer is already global, scaled so that the
    mean over the group's ranks is the global ratio."""
    group = active()
    return loss if group is None else loss * group.size


def seq_split() -> Optional[Tuple[object, str, int, int]]:
    """``(mesh, axis, index, size)`` of the sequence split of the running
    step — each rank holds segment ``index`` of ``size`` of every row — or
    None when rows are whole."""
    group = active()
    if group is None or group.seq_axis is None:
        return None
    axis = group.seq_axis
    return group.mesh, axis, group.index(axis), int(group.mesh.shape[axis])


def rows_split_over(axis: str) -> bool:
    """Whether the running step splits the batch's rows over ``axis`` (of
    size > 1): the ranks of that axis hold different tokens."""
    group = active()
    return group is not None and axis in group.row_axes and int(group.mesh.shape[axis]) > 1


def seq_offset(t_local: int) -> int:
    """The global position of this rank's first token in each row."""
    split = seq_split()
    return 0 if split is None else split[2] * int(t_local)


def token_sum(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over the step's group, differentiable (the backward of
    a sum is a sum): a statistic over the global batch's tokens whose
    gradient reaches every rank's own tokens."""
    group = active()
    if group is None:
        return t
    from paddle_tpu_torch.parallel import collective

    with group.mesh:
        for axis in group.axes:
            t = collective.all_reduce(t, axis)
    return t


def row_prefix(counts: torch.Tensor) -> torch.Tensor:
    """Exclusive prefix sums in the global batch's ``(b, t)`` token order.

    ``counts`` [B_local, K] (integers) counts something per row of this
    rank's block (its segment of each of its rows). Returns [B_local, K]:
    for each local row, the sum of the counts of every (row, segment) that
    precedes this rank's segment of it in the global order — every earlier
    row whole, then the earlier segments of the same row. Outside a step:
    zeros."""
    group = active()
    if group is None:
        return torch.zeros_like(counts)
    from paddle_tpu_torch.parallel import collective

    b_local, k = counts.shape
    seq = group.seq_axis
    with torch.no_grad(), group.mesh:
        parts = counts[None]  # [n_seq, B_local, K]
        if seq is not None:
            parts = collective.all_gather(counts, seq, axis=0, tiled=False)
        for axis in reversed(group.row_axes):  # the innermost first
            parts = collective.all_gather(parts, axis, axis=0, tiled=False)
        n_seq = parts.shape[len(group.row_axes)]
        # global order: row blocks row-major, their rows, each row's segments
        full = parts.reshape(-1, n_seq, b_local, k)
        ordered = full.permute(0, 2, 1, 3).reshape(-1, k)
        before = (torch.cumsum(ordered, 0) - ordered).reshape(-1, b_local, n_seq, k)
        j = group.index(seq) if seq is not None else 0
        return before[group.row_block(), :, j]
