"""Shape buckets: the warm-up contract between requests and the engine
(a copy of ``paddle_tpu.serving.buckets``).

Under XLA every distinct argument shape is a distinct executable, so the
JAX package's engine compiles a finite set of padded shape buckets ahead
of time. PyTorch runs eagerly, but a new shape still pays on its first
call: cuBLAS and cuDNN pick algorithms for it, the caching allocator grows,
and the first call of the process builds the CUDA kernels with ``nvcc``.
The same finite vocabulary lets the engine run every shape once at startup
(TVM's shape-specialized functions, arxiv 1802.04799): a request is
rounded UP to the smallest bucket that fits, padded with zeros, and the
result rows are sliced back out.

Buckets are derived from :class:`paddle_tpu_torch.reader.feeder.FeedSpec`:

- fixed per-sample dims come straight from ``spec.shape``;
- ragged dims (``None`` in ``spec.shape``, or ``spec.ragged``) are rounded
  up to a configured ``length_buckets`` entry;
- the batch (row) dim is rounded up to a ``batch_buckets`` entry
  (default: powers of two up to ``max_batch_size``).

The full signature set is the cross product of ragged-dim buckets — one
warm-up run per (signature, batch bucket) pair at engine startup.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from paddle_tpu_torch.core.enforce import EnforceError, enforce
from paddle_tpu_torch.reader.feeder import FeedSpec

__all__ = ["ShapeBuckets"]

# per-slot per-sample padded shape, e.g. ((16, 4), (1,))
Signature = Tuple[Tuple[int, ...], ...]


def _pow2_buckets(max_value: int) -> Tuple[int, ...]:
    out = []
    b = 1
    while b < max_value:
        out.append(b)
        b *= 2
    out.append(max_value)
    return tuple(out)


class ShapeBuckets:
    """Maps request shapes to the finite padded-shape vocabulary."""

    def __init__(
        self,
        feed_specs: Sequence[FeedSpec],
        max_batch_size: int,
        batch_buckets: Optional[Sequence[int]] = None,
        length_buckets: Optional[Sequence[int]] = None,
    ):
        enforce(max_batch_size >= 1, "max_batch_size must be >= 1")
        self.specs = list(feed_specs)
        self.max_batch_size = int(max_batch_size)
        self.batch_buckets: Tuple[int, ...] = tuple(
            sorted(set(int(b) for b in batch_buckets))
            if batch_buckets
            else _pow2_buckets(self.max_batch_size)
        )
        enforce(
            self.batch_buckets[-1] == self.max_batch_size,
            "largest batch bucket must equal max_batch_size "
            f"({self.batch_buckets[-1]} != {self.max_batch_size})",
        )
        self.length_buckets: Optional[Tuple[int, ...]] = (
            tuple(sorted(set(int(b) for b in length_buckets)))
            if length_buckets
            else None
        )
        # which dims of each slot's per-sample shape are bucketable
        self._ragged_dims: List[Tuple[int, ...]] = []
        for spec in self.specs:
            dims = spec.ragged_dims()
            self._ragged_dims.append(dims)
            if dims and self.length_buckets is None:
                raise EnforceError(
                    f"feed slot {spec.name!r} has ragged dims {dims} but no "
                    "length_buckets were configured — the engine cannot "
                    "enumerate its compile set"
                )

    @property
    def has_ragged(self) -> bool:
        return any(self._ragged_dims)

    def _round_length(self, n: int) -> int:
        assert self.length_buckets is not None
        for b in self.length_buckets:
            if n <= b:
                return b
        raise EnforceError(
            f"sequence length {n} exceeds the largest length bucket "
            f"{self.length_buckets[-1]}"
        )

    def batch_bucket(self, rows: int) -> int:
        """Smallest batch bucket that holds ``rows``."""
        enforce(
            1 <= rows <= self.max_batch_size,
            f"rows={rows} outside [1, {self.max_batch_size}]",
        )
        for b in self.batch_buckets:
            if rows <= b:
                return b
        return self.batch_buckets[-1]

    def signature(self, sample_shapes: Sequence[Tuple[int, ...]]) -> Signature:
        """Round per-sample shapes up to the bucket vocabulary, validating
        fixed dims against the FeedSpecs."""
        enforce(
            len(sample_shapes) == len(self.specs),
            f"expected {len(self.specs)} feed slots, got {len(sample_shapes)}",
        )
        sig = []
        for spec, ragged, shape in zip(self.specs, self._ragged_dims, sample_shapes):
            shape = tuple(int(d) for d in shape)
            if len(shape) != len(spec.shape):
                raise EnforceError(
                    f"slot {spec.name!r}: rank {len(shape)} != spec rank "
                    f"{len(spec.shape)} (per-sample shape {spec.shape})"
                )
            padded = []
            for i, d in enumerate(shape):
                if i in ragged:
                    padded.append(self._round_length(d))
                else:
                    want = spec.shape[i]
                    if want is not None and d != want:
                        raise EnforceError(
                            f"slot {spec.name!r} dim {i}: got {d}, spec "
                            f"requires {want}"
                        )
                    padded.append(d)
            sig.append(tuple(padded))
        return tuple(sig)

    def all_signatures(self) -> List[Signature]:
        """Every signature the engine must pre-compile (cross product of
        ragged-dim length buckets; a single signature when all dims are
        static)."""
        per_slot: List[List[Tuple[int, ...]]] = []
        for spec, ragged in zip(self.specs, self._ragged_dims):
            variants: List[Tuple[int, ...]] = [()]
            for i, d in enumerate(spec.shape):
                choices = (
                    list(self.length_buckets) if i in ragged else [int(d)]
                )
                variants = [v + (c,) for v in variants for c in choices]
            per_slot.append(variants)
        sigs: List[Signature] = [()]
        for variants in per_slot:
            sigs = [s + (v,) for s in sigs for v in variants]
        return sigs

    # -- padding helpers ---------------------------------------------------

    def pad_to_signature(self, arrays: Sequence[np.ndarray], sig: Signature):
        """Zero-pad each slot's per-sample dims up to ``sig`` (row count
        untouched)."""
        out = []
        for arr, shape in zip(arrays, sig):
            arr = np.asarray(arr)
            pad = [(0, 0)] + [
                (0, t - s) for t, s in zip(shape, arr.shape[1:])
            ]
            if any(p[1] for p in pad):
                arr = np.pad(arr, pad)
            out.append(arr)
        return out

    @staticmethod
    def pad_rows(arrays: Sequence[np.ndarray], target_rows: int):
        """Zero-pad the leading (row) dim of every slot to ``target_rows``."""
        out = []
        for arr in arrays:
            arr = np.asarray(arr)
            short = target_rows - arr.shape[0]
            if short > 0:
                pad = [(0, short)] + [(0, 0)] * (arr.ndim - 1)
                arr = np.pad(arr, pad)
            out.append(arr)
        return out
