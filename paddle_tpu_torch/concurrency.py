"""CSP concurrency primitives: Go-style channels, select, and goroutines.

A copy of ``paddle_tpu.concurrency`` (jax-free) for the PyTorch port.

Reference surface: ``python/paddle/fluid/concurrency.py:23-44`` exports
``make_channel / channel_send / channel_recv / channel_close / Select``
(plus the ``Go`` block guard) over the C++ buffered/unbuffered channel in
``paddle/fluid/framework/channel.h:25-130`` (``Send`` blocks, ``Receive``
returns an ok-flag, ``Close`` wakes all waiters, sender/receiver wait
queues feed ``Select``).

Re-design: the reference builds channel ops into the program graph and
runs them on its CSP-aware executor; a PyTorch program has no in-graph
concurrency either. What channels are actually FOR in a training framework is the
host side: decoupling producers from consumers around the device (readers,
prefetchers, async checkpoint writers, metric sinks). So these channels are
host-side primitives built on ``threading`` with Go semantics:

- ``capacity=0`` is a rendezvous channel: ``send`` completes only when a
  receiver takes the value (and vice versa).
- ``send`` on a closed channel raises :class:`ChannelClosedError`;
  ``recv`` drains any buffered/waiting values first, then returns
  ``(None, False)`` — exactly Go's ``v, ok := <-ch``.
- ``Select`` waits on several send/recv cases, picks a ready one at
  random (Go's fairness rule), and supports a default case.
- ``go(fn, *args)`` runs ``fn`` on a daemon thread (the reference's
  ``Go`` block guard spawns its captured block asynchronously).

Interop with the data pipeline: :func:`as_reader` adapts a channel into a
reader iterable (compose with ``reader.stack_batch`` / ``DevicePrefetcher``)
and :func:`from_reader` pumps a reader into a channel on a goroutine.
"""
from __future__ import annotations

import collections
import random
import threading
import time
from typing import Any, Callable, Iterable, Optional, Sequence

from paddle_tpu_torch.core import locks

__all__ = [
    "Channel",
    "ChannelClosedError",
    "ChannelFull",
    "make_channel",
    "channel_send",
    "channel_recv",
    "channel_close",
    "Select",
    "go",
    "as_reader",
    "from_reader",
]


class ChannelClosedError(RuntimeError):
    """Raised by ``send`` on a closed channel (Go panics; we raise)."""


class ChannelFull(RuntimeError):
    """Raised by :meth:`Channel.try_send` when the send cannot complete
    immediately — the typed signal load-shedding paths branch on (Go's
    ``select { case ch <- v: default: }`` taking the default)."""


class _Waiter:
    """A blocked sender parked in the channel's send queue with its value
    (the host-side analog of ``AddToSendQ`` in ``channel.h:47``)."""

    __slots__ = ("value", "taken", "closed")

    def __init__(self, value):
        self.value = value
        self.taken = False
        self.closed = False


class Channel:
    """Go-semantics channel; ``capacity=0`` means unbuffered (rendezvous).

    All operations are thread-safe. ``dtype`` is advisory metadata kept for
    API parity with ``make_channel(dtype, capacity)`` — host channels carry
    arbitrary Python payloads (numpy batches, pytrees, sentinel objects).
    """

    def __init__(self, capacity: int = 0, dtype: Any = None):
        if capacity < 0:
            raise ValueError(f"capacity must be >= 0, got {capacity}")
        self.capacity = int(capacity)
        self.dtype = dtype
        self._lock = locks.Lock("concurrency.channel")
        self._readable = locks.Condition(self._lock, name="concurrency.channel.readable")  # value available
        self._movement = locks.Condition(self._lock, name="concurrency.channel.movement")  # any state change
        self._buf: collections.deque = collections.deque()
        self._senders: collections.deque[_Waiter] = collections.deque()
        self._recv_waiting = 0  # receivers parked in recv() (select peeks)
        self._closed = False
        self.error: Optional[BaseException] = None  # set by from_reader

    # -- introspection (CanSend/CanReceive/IsClosed, channel.h:35-43) --

    def is_closed(self) -> bool:
        with self._lock:
            return self._closed

    def qsize(self) -> int:
        """Number of values a receiver could take right now: buffered items
        plus parked senders (a rendezvous sender counts — its value is
        available). Advisory under concurrency, like ``queue.Queue.qsize``;
        used for queue-depth gauges."""
        with self._lock:
            return len(self._buf) + len(self._senders)

    def _can_send_locked(self) -> bool:
        return not self._closed and (
            self.capacity > 0 and len(self._buf) < self.capacity
        )

    def _can_recv_locked(self) -> bool:
        return bool(self._buf) or bool(self._senders)

    def can_send(self) -> bool:
        """True when a buffered ``send`` would complete without blocking.
        (An unbuffered channel can never promise that — a receiver must be
        mid-``recv`` — so this reports False there, like ``CanSend`` on an
        empty send queue.)"""
        with self._lock:
            return self._can_send_locked()

    def can_recv(self) -> bool:
        with self._lock:
            return self._can_recv_locked()

    # -- core operations --

    def send(self, value, timeout: Optional[float] = None) -> None:
        """Blocks until the value is buffered (buffered channel) or taken
        by a receiver (unbuffered). Raises :class:`ChannelClosedError` if
        the channel is or becomes closed first, ``TimeoutError`` on
        timeout."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._lock:
            if self._closed:
                raise ChannelClosedError("send on closed channel")
            if self.capacity > 0 and len(self._buf) < self.capacity:
                self._buf.append(value)
                self._readable.notify()
                self._movement.notify_all()
                return
            # full or unbuffered: park in the send queue until a receiver
            # takes the value (or buffer space frees: _pump moves us in)
            w = _Waiter(value)
            self._senders.append(w)
            self._readable.notify()
            self._movement.notify_all()
            while not w.taken and not w.closed:
                remaining = None if deadline is None else deadline - time.monotonic()
                if remaining is not None and remaining <= 0:
                    try:
                        self._senders.remove(w)  # RemoveFromSendQ
                    except ValueError:
                        pass
                    if w.taken:
                        return
                    raise TimeoutError("channel send timed out")
                self._movement.wait(remaining)
            if w.closed and not w.taken:
                raise ChannelClosedError("channel closed while sending")

    def try_send(self, value) -> None:
        """Non-blocking send: complete immediately or raise
        :class:`ChannelFull` — never parks the caller (the primitive
        shedding paths need: reject work you cannot take NOW).

        Buffered: succeeds while buffer space is free. Unbuffered:
        succeeds only when a receiver is already parked in ``recv`` — the
        value is committed to the send queue for it to take. (If that
        receiver then times out before taking it, the value stays queued
        for the next receiver, exactly as a timed-out ``send`` that was
        taken mid-removal behaves.) Raises :class:`ChannelClosedError` on
        a closed channel."""
        with self._lock:
            if self._closed:
                raise ChannelClosedError("send on closed channel")
            if self.capacity > 0 and len(self._buf) < self.capacity:
                self._buf.append(value)
                self._readable.notify()
                self._movement.notify_all()
                return
            if self.capacity == 0 and self._recv_waiting > 0:
                w = _Waiter(value)
                w.taken = True  # committed: no sender will wait on it
                self._senders.append(w)
                self._readable.notify()
                self._movement.notify_all()
                return
            raise ChannelFull(
                "channel full" if self.capacity > 0
                else "no receiver waiting on unbuffered channel")

    def _pump_locked(self) -> None:
        """Move parked senders into freed buffer slots (FIFO)."""
        while self._senders and self.capacity > 0 and len(self._buf) < self.capacity:
            w = self._senders.popleft()
            w.taken = True
            self._buf.append(w.value)
        self._movement.notify_all()

    def recv(self, timeout: Optional[float] = None):
        """Returns ``(value, True)``, or ``(None, False)`` once the channel
        is closed AND drained (Go's ``v, ok``). ``TimeoutError`` on
        timeout."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._lock:
            while True:
                if self._buf:
                    value = self._buf.popleft()
                    self._pump_locked()
                    return value, True
                if self._senders:
                    w = self._senders.popleft()
                    w.taken = True
                    self._movement.notify_all()
                    return w.value, True
                if self._closed:
                    return None, False
                remaining = None if deadline is None else deadline - time.monotonic()
                if remaining is not None and remaining <= 0:
                    raise TimeoutError("channel recv timed out")
                self._recv_waiting += 1
                try:
                    self._readable.wait(remaining)
                finally:
                    self._recv_waiting -= 1

    def close(self) -> None:
        """Idempotent. Parked senders raise; future ``recv``s drain the
        buffer then return ``(None, False)`` (``Close``, channel.h:44)."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            for w in self._senders:
                w.closed = True
            self._senders.clear()
            self._readable.notify_all()
            self._movement.notify_all()

    # -- iteration: ``for v in ch`` drains until closed (Go's range) --

    def __iter__(self):
        while True:
            value, ok = self.recv()
            if not ok:
                return
            yield value


def make_channel(dtype: Any = None, capacity: int = 0) -> Channel:
    """API parity with ``concurrency.py:282`` (dtype kept as metadata)."""
    return Channel(capacity=capacity, dtype=dtype)


def channel_send(channel: Channel, value, timeout: Optional[float] = None) -> None:
    channel.send(value, timeout=timeout)


def channel_recv(channel: Channel, timeout: Optional[float] = None):
    """Returns ``(value, ok)`` — the reference's out-param + status pair
    (``concurrency.py:388``) as a Python tuple."""
    return channel.recv(timeout=timeout)


def channel_close(channel: Channel) -> None:
    channel.close()


class Select:
    """Multi-channel wait: add send/recv cases (+ optional default), then
    ``run()`` — or use as a context manager, which runs on exit.

    Ready-case choice is uniformly random among ready cases (Go's rule, so
    a busy channel cannot starve the others). With no ready case and no
    default, each wait round PARKS briefly in one randomly-chosen case
    (a blocking send/recv with a short timeout): a parked send sits in that
    channel's sender queue and a parked recv registers as a waiting
    receiver, so two Selects facing each other across an unbuffered channel
    rendezvous instead of livelocking. The reference instead parks one
    waiter in every channel's queue simultaneously (``channel.h:47-54``);
    parking in one case at a time trades a bounded extra latency (<= 50 ms
    per round) for not needing cross-channel wait-queue surgery — the right
    cost model for host-side IO.

    Example::

        done = []
        with Select() as s:
            s.recv(ch_a, lambda v, ok: done.append(("a", v, ok)))
            s.recv(ch_b, lambda v, ok: done.append(("b", v, ok)))
            s.default(lambda: done.append(("none",)))
    """

    def __init__(self):
        self._cases = []  # (kind, channel, payload, callback)
        self._default: Optional[Callable[[], Any]] = None
        self.result = None
        self._ran = False

    def send(self, channel: Channel, value, callback: Optional[Callable] = None) -> "Select":
        self._cases.append(("send", channel, value, callback))
        return self

    def recv(self, channel: Channel, callback: Optional[Callable] = None) -> "Select":
        self._cases.append(("recv", channel, None, callback))
        return self

    def default(self, callback: Optional[Callable] = None) -> "Select":
        self._default = callback if callback is not None else (lambda: None)
        return self

    def _try_case(self, kind, channel, value):
        """Attempt one case without blocking; returns (fired, result)."""
        with channel._lock:
            if kind == "recv":
                if channel._can_recv_locked() or channel._closed:
                    pass  # fall through to the blocking call below
                else:
                    return False, None
            else:
                if channel._closed:
                    raise ChannelClosedError("select send on closed channel")
                if not (
                    channel._can_send_locked()
                    # rendezvous ready: a receiver is already waiting
                    or (channel.capacity == 0 and channel._recv_waiting > 0)
                ):
                    return False, None
        if kind == "recv":
            try:
                return True, channel.recv(timeout=0.05)
            except TimeoutError:
                return False, None
        try:
            channel.send(value, timeout=0.05)
            return True, None
        except TimeoutError:
            return False, None

    def run(self, timeout: Optional[float] = None):
        if self._ran:
            raise RuntimeError(
                "Select.run() called twice (an explicit run() inside a "
                "with-block already consumed the select)"
            )
        if not self._cases and self._default is None:
            raise ValueError("select with no cases")
        deadline = None if timeout is None else time.monotonic() + timeout
        park_s = 1e-3

        def _fire(kind, callback, res):
            # consumed only when a case actually fires — a TimeoutError
            # leaves the Select retryable (nothing was taken from a channel)
            self._ran = True
            if callback is not None:
                if kind == "recv":
                    v, ok = res
                    self.result = callback(v, ok)
                else:
                    self.result = callback()
            return self.result

        while True:
            order = list(self._cases)
            random.shuffle(order)
            for kind, channel, value, callback in order:
                fired, res = self._try_case(kind, channel, value)
                if fired:
                    return _fire(kind, callback, res)
            if self._default is not None:
                self._ran = True
                self.result = self._default()
                return self.result
            if deadline is not None and time.monotonic() >= deadline:
                raise TimeoutError("select timed out")
            # nothing ready: park in ONE random case so the counterpart
            # side (another Select, or a plain send/recv) can find us
            kind, channel, value, callback = random.choice(self._cases)
            wait = park_s
            if deadline is not None:
                wait = max(1e-4, min(wait, deadline - time.monotonic()))
            try:
                if kind == "recv":
                    res = channel.recv(timeout=wait)
                    return _fire(kind, callback, res)
                channel.send(value, timeout=wait)
                return _fire(kind, callback, None)
            except TimeoutError:
                park_s = min(park_s * 2, 5e-2)

    def __enter__(self) -> "Select":
        return self

    def __exit__(self, exc_type, exc_val, exc_tb) -> bool:
        # an explicit run() inside the block already consumed the select —
        # running again would silently swallow an extra channel value
        if exc_type is None and not self._ran:
            self.run()
        return False


def go(fn: Callable, *args, **kwargs) -> threading.Thread:
    """Run ``fn`` on a daemon thread (the reference ``Go`` block guard,
    ``concurrency.py:28``, spawns its captured block asynchronously).
    Returns the started thread; ``.join()`` it for synchronization, or use
    a channel."""
    t = threading.Thread(target=fn, args=args, kwargs=kwargs, daemon=True)
    t.start()
    return t


# ---- data-pipeline glue -------------------------------------------------


def as_reader(channel: Channel) -> Callable[[], Iterable]:
    """Adapt a channel into a reader factory: each call returns an iterable
    draining the channel until it closes. Composes with
    ``reader.stack_batch`` and ``reader.DevicePrefetcher`` so a goroutine
    producer can feed the device input pipeline.

    If the producer recorded a failure (``channel.error``, set by
    :func:`from_reader`), it re-raises AFTER the drain — the same
    ExceptionHolder-style propagation as the rest of the reader stack, so
    a dying producer cannot silently truncate an epoch."""

    def _reader():
        def gen():
            for value in channel:
                yield value
            if channel.error is not None:
                raise channel.error

        return gen()

    return _reader


def from_reader(
    reader_factory: Callable[[], Iterable],
    capacity: int = 2,
    channel: Optional[Channel] = None,
) -> Channel:
    """Pump a reader through a channel on a goroutine; the channel closes
    when the reader is exhausted or raises (the exception is recorded on
    ``channel.error`` for the consumer to inspect after the drain — a
    closed-with-error channel, not a swallowed failure). The bounded
    capacity gives double-buffering:
    the producer runs ahead of the consumer by at most ``capacity``
    batches — the host-side analog of the reference's C++ double-buffered
    reader (``operators/reader/buffered_reader.cc``)."""
    ch = channel if channel is not None else Channel(capacity=capacity)

    def _pump():
        try:
            for item in reader_factory():
                try:
                    ch.send(item)
                except ChannelClosedError:
                    return  # consumer closed early: stop producing
        except BaseException as e:  # noqa: BLE001 — recorded, not swallowed
            ch.error = e
        finally:
            ch.close()

    go(_pump)
    return ch
