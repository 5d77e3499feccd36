"""Unique name generation for parameters/layers.

Reference: ``python/paddle/fluid/unique_name.py`` (UniqueNameGenerator with
``guard`` switching). Names key the parameter pytree, so determinism across
init/apply traces matters: the generator is scoped per framework transform
frame (see ``paddle_tpu.framework``) rather than truly global.
"""

from __future__ import annotations

import contextlib
import threading
from collections import defaultdict


class Generator:
    def __init__(self):
        self._counters = defaultdict(int)

    def generate(self, key: str) -> str:
        n = self._counters[key]
        self._counters[key] += 1
        return f"{key}_{n}" if n else key

    def reset(self):
        self._counters.clear()

    def snapshot(self) -> dict:
        """The counters as they stand (for :meth:`restore`)."""
        return dict(self._counters)

    def restore(self, snapshot: dict) -> None:
        """Return the counters to a :meth:`snapshot`: names generated after
        it are generated again."""
        self._counters = defaultdict(int, snapshot)


_tls = threading.local()


def _stack():
    if not hasattr(_tls, "stack"):
        _tls.stack = [Generator()]
    return _tls.stack


def generate(key: str) -> str:
    return _stack()[-1].generate(key)


def reset():
    _stack()[-1].reset()


@contextlib.contextmanager
def guard(generator: Generator | None = None):
    """Switch to a fresh (or given) generator; restores the previous on exit."""
    _stack().append(generator or Generator())
    try:
        yield _stack()[-1]
    finally:
        _stack().pop()


def switch(new_generator=None):
    """Swap the CURRENT frame's generator (reference ``unique_name.py:61``):
    installs ``new_generator`` (or a fresh one) at the top of this thread's
    stack and returns the previous generator."""
    stack = _stack()
    old = stack[-1]
    stack[-1] = new_generator if new_generator is not None else Generator()
    return old
