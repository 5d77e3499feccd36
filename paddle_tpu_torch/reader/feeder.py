"""DataFeeder: python samples → batched device-ready numpy arrays.

Reference: ``python/paddle/fluid/data_feeder.py:292`` (DataFeeder converts
per-sample tuples into LoDTensors per feed target, inferring batch layout).
A copy of ``paddle_tpu.reader.feeder``: dense numpy batches (and (padded,
lengths) pairs for ragged slots); no LoD.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np


class FeedSpec:
    """Describes one feed slot: name, per-sample shape (None = ragged lead
    dim), dtype."""

    def __init__(self, name: str, shape: Sequence[Optional[int]], dtype="float32", ragged: bool = False, max_len: Optional[int] = None):
        self.name = name
        self.shape = tuple(shape)
        self.dtype = np.dtype(dtype) if not isinstance(dtype, np.dtype) else dtype
        self.ragged = ragged
        self.max_len = max_len

    @property
    def is_ragged(self) -> bool:
        """True when any per-sample dim is variable (``ragged`` flag or a
        ``None`` dim) — such slots need length bucketing to serve
        (``paddle_tpu.serving.buckets``)."""
        return self.ragged or any(d is None for d in self.shape)

    def ragged_dims(self) -> Tuple[int, ...]:
        """Indices of the variable per-sample dims (``ragged`` with a fully
        fixed shape means the LEAD dim varies, DataFeeder-style)."""
        dims = tuple(i for i, d in enumerate(self.shape) if d is None)
        if self.ragged and not dims:
            dims = (0,)
        return dims

    def __repr__(self):
        return (
            f"FeedSpec({self.name!r}, shape={self.shape}, "
            f"dtype={self.dtype.name}, ragged={self.ragged})"
        )


class DataFeeder:
    def __init__(self, feed_list: Sequence[FeedSpec]):
        self.specs = list(feed_list)

    def feed(self, samples: Sequence[Sequence[Any]]) -> Dict[str, np.ndarray]:
        """samples: list of per-sample tuples aligned with specs. Returns
        name → batched array; ragged slots produce name and name_len."""
        out: Dict[str, np.ndarray] = {}
        for i, spec in enumerate(self.specs):
            column = [s[i] for s in samples]
            if spec.ragged:
                max_len = spec.max_len or max(len(np.atleast_1d(c)) for c in column)
                rows = [np.asarray(c, dtype=spec.dtype) for c in column]
                if rows[0].ndim == 1:
                    rows = [r[:, None] for r in rows]
                padded, lengths = sequence_pad(rows, max_len)
                if spec.shape and spec.shape[-1] == 1 and padded.shape[-1] == 1:
                    pass
                out[spec.name] = padded.astype(spec.dtype)
                out[spec.name + "_len"] = lengths
            else:
                arr = np.stack([np.asarray(c, dtype=spec.dtype).reshape(spec.shape) for c in column])
                out[spec.name] = arr
        return out


def sequence_pad(rows: list, max_len: int, pad_value=0.0):
    """Host-side helper (``paddle_tpu.ops.sequence.sequence_pad``): list of
    [Ti, D] numpy arrays → (padded [B,T,D], lengths)."""
    b = len(rows)
    d = rows[0].shape[-1] if rows[0].ndim > 1 else 1
    out = np.full((b, max_len, d), pad_value, dtype=np.asarray(rows[0]).dtype)
    lengths = np.zeros((b,), np.int32)
    for i, r in enumerate(rows):
        r = np.asarray(r).reshape(-1, d)
        n = min(len(r), max_len)
        out[i, :n] = r[:n]
        lengths[i] = n
    return out, lengths
