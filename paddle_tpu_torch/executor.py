"""Executor — the program runtime bound to a device.

Port of ``paddle_tpu/executor.py`` (reference
``paddle/fluid/framework/executor.cc:50-490`` Prepare/RunPreparedContext
caching and ``python/paddle/fluid/executor.py:256`` feed/fetch).

PyTorch runs eagerly, so "preparing" a function compiles nothing: it
caches the callable under the JAX package's LRU (and its
``executor.cache_misses_total`` counter and ``executor.cache_size``
gauge), and "running" calls it. ``put`` is the feed: it moves a batch to
the executor's device. ``run(fetch=True)`` copies the outputs to numpy and
applies ``check_nan_inf``.
"""

from __future__ import annotations

from typing import Any, Callable, Dict

import numpy as np
import torch

from paddle_tpu_torch.core import config as cfg
from paddle_tpu_torch.core import profiler as prof
from paddle_tpu_torch.core import tree as tree_mod
from paddle_tpu_torch.core.enforce import EnforceError

__all__ = ["Executor", "to_device"]


def to_device(value, device: torch.device, non_blocking: bool = False):
    """One batch field on ``device``: numpy arrays become tensors of the
    same dtype (int32 ids stay int32); tensors already there are returned
    as they are."""
    if isinstance(value, torch.Tensor):
        return value.to(device, non_blocking=non_blocking)
    arr = np.asarray(value)
    if not arr.flags.writeable:  # torch.from_numpy needs a writable buffer
        arr = arr.copy()
    return torch.from_numpy(np.ascontiguousarray(arr)).to(device, non_blocking=non_blocking)


class Executor:
    """Runs functions on one device (``exe = fluid.Executor(place)``).
    ``place``: a device (``"cuda"``, ``"cpu"``, a ``torch.device``); None
    means CUDA, which must then be available."""

    def __init__(self, place=None, max_cache: int = 64):
        self.place = place if place is not None else "cuda"
        self._device = cfg.resolve_device(self.place)
        self._cache: Dict[Any, Callable] = {}
        self._max_cache = max_cache

    @property
    def device(self) -> torch.device:
        return self._device

    def prepare(self, fn: Callable, key: Any = None) -> Callable:
        """Cache a function for this executor (Executor::Prepare parity)."""
        # key on the function object itself (kept alive by the cache) — an
        # id() key could collide after GC recycles the address
        cache_key = key if key is not None else fn
        if cache_key in self._cache:
            # LRU: refresh on hit so hot entries are never evicted by a burst
            # of cold ones
            self._cache[cache_key] = self._cache.pop(cache_key)
        else:
            if len(self._cache) >= self._max_cache:
                self._cache.pop(next(iter(self._cache)))
            prof.inc_counter("executor.cache_misses_total")
            self._cache[cache_key] = fn
            prof.set_gauge("executor.cache_size", len(self._cache))
        return self._cache[cache_key]

    def run(self, fn: Callable, *args, fetch: bool = False, **kwargs):
        """Run a (cached) function. With ``fetch=True`` the outputs are
        copied to numpy (FetchOpHandle parity) and NaN/Inf-checked when
        flags().check_nan_inf is set (FLAGS_check_nan_inf, reference
        operator.cc:725-737)."""
        prepared = self.prepare(fn)
        with prof.record_event(f"executor.run.{getattr(fn, '__name__', 'fn')}"):
            out = prepared(*args, **kwargs)
        if fetch:
            out = tree_mod.map_leaves(_to_numpy, out)
            if cfg.flags().check_nan_inf:
                self._check_nan_inf(out)
        return out

    @staticmethod
    def _check_nan_inf(tree):
        for leaf in tree_mod.leaves(tree):
            arr = np.asarray(leaf)
            if np.issubdtype(arr.dtype, np.floating) and not np.all(np.isfinite(arr)):
                raise EnforceError("NaN/Inf detected in fetched output (check_nan_inf)")

    def put(self, tree):
        """Place host arrays on this executor's device (feed parity)."""
        return tree_mod.map_leaves(lambda v: to_device(v, self._device), tree)

    def close(self):
        self._cache.clear()


def _to_numpy(leaf):
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return leaf
