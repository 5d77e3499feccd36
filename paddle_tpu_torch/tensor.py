"""Ragged/LoD-compat tensor helpers (a copy of ``paddle_tpu.tensor``: host
numpy only).

Reference: ``python/paddle/fluid/lod_tensor.py`` (create_lod_tensor /
create_random_int_lodtensor building LoDTensors from offset tables). The
representation of variable-length data is a dense padded array
plus per-row lengths (masks derived where needed) —
these helpers convert LoD-style inputs into that form.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np

from paddle_tpu_torch.core.enforce import enforce

__all__ = ["RaggedBatch", "create_lod_tensor", "create_random_int_lodtensor"]


class RaggedBatch(NamedTuple):
    """Padded [B, T, ...] data + [B] int32 lengths — the LoD replacement."""

    data: np.ndarray
    lengths: np.ndarray

    def mask(self) -> np.ndarray:
        """[B, T] bool validity mask."""
        t = self.data.shape[1]
        return np.arange(t)[None, :] < self.lengths[:, None]


def create_lod_tensor(
    data, recursive_seq_lens: Optional[Sequence[Sequence[int]]] = None, place=None
) -> RaggedBatch:
    """Build a :class:`RaggedBatch` from either a list of per-row arrays or
    a flat array + one level of sequence lengths (reference
    ``lod_tensor.py create_lod_tensor``; deeper LoD levels flatten to one —
    nested raggedness beyond one level has no model-facing user in the
    benchmark suite). ``place`` is accepted for API parity and ignored
    (device placement happens at feed time)."""
    if recursive_seq_lens is None or isinstance(data, (list, tuple)):
        rows = [np.asarray(r) for r in data]
    else:
        enforce(len(recursive_seq_lens) >= 1, "need at least one LoD level")
        lens = list(recursive_seq_lens[-1])  # innermost level = row lengths
        flat = np.asarray(data)
        enforce(
            sum(lens) == flat.shape[0],
            f"sum of seq lens {sum(lens)} != data rows {flat.shape[0]}",
        )
        rows, off = [], 0
        for n in lens:
            rows.append(flat[off:off + n])
            off += n
    max_len = max((r.shape[0] for r in rows), default=0)
    shape = (len(rows), max_len) + tuple(rows[0].shape[1:] if rows else ())
    data_arr = np.zeros(shape, dtype=rows[0].dtype if rows else np.float32)
    lengths = np.zeros((len(rows),), np.int32)
    for i, r in enumerate(rows):
        data_arr[i, : r.shape[0]] = r
        lengths[i] = r.shape[0]
    return RaggedBatch(data=data_arr, lengths=lengths)


def create_random_int_lodtensor(
    recursive_seq_lens: Sequence[Sequence[int]],
    base_shape: Sequence[int],
    place=None,
    low: int = 0,
    high: int = 1,
    seed: Optional[int] = None,
) -> RaggedBatch:
    """Random-integer ragged batch (reference
    ``lod_tensor.py create_random_int_lodtensor``) — handy for tests."""
    rng = np.random.RandomState(seed)
    lens = list(recursive_seq_lens[-1])
    rows = [
        rng.randint(low, high + 1, size=(n,) + tuple(base_shape)).astype(np.int32)
        for n in lens
    ]
    return create_lod_tensor(rows, place=place)
