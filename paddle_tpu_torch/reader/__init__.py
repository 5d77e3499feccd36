"""Functional reader combinators + host→device pipeline.

Reference: ``python/paddle/reader/decorator.py:36-338`` (map_readers/shuffle/
chain/compose/buffered/firstn/xmap_readers/multiprocess_reader) and the C++
reader op chain (``paddle/fluid/operators/reader/`` — shuffle/batch/
double-buffer decorated readers over a blocking queue).

The combinators are copies of ``paddle_tpu.reader`` (jax-free): a reader is
a zero-arg callable returning a generator, and the same seeds give the same
sequences in both packages. The C++ double-buffer device prefetcher maps to
:class:`DevicePrefetcher`, which copies batches to the card from pinned
host memory on a side CUDA stream, ``depth`` batches ahead of the step.
The native recordio reader (``paddle_tpu.native``) is not ported.
"""

from __future__ import annotations

import itertools
import queue as queue_mod
import random
import threading
from typing import Any, Callable, Iterable, Iterator, List, Optional, Sequence

import numpy as np

from paddle_tpu_torch.reader.feeder import DataFeeder  # noqa: F401

Reader = Callable[[], Iterator[Any]]


class _RaisedInProducer:
    """Wrapper carrying a producer-thread exception across the queue so the
    consumer re-raises it instead of treating a dead producer as EOF
    (the reference's reader threads propagate via ExceptionHolder,
    ``details/exception_holder.h``)."""

    def __init__(self, exc: BaseException):
        self.exc = exc

__all__ = [
    "map_readers",
    "shuffle",
    "chain",
    "compose",
    "buffered",
    "firstn",
    "shard",
    "xmap_readers",
    "multiprocess_reader",
    "ReaderWorkerError",
    "batch",
    "stack_batch",
    "cache",
    "DataFeeder",
    "DevicePrefetcher",
]


def map_readers(func: Callable, *readers: Reader) -> Reader:
    """Apply func to the zipped outputs of several readers
    (reference decorator.py:36)."""

    def reader():
        rs = [r() for r in readers]
        for items in zip(*rs):
            yield func(*items)

    return reader


def shuffle(reader: Reader, buf_size: int, seed: Optional[int] = None) -> Reader:
    """Buffered shuffle (reference decorator.py shuffle)."""

    def shuffled():
        rng = random.Random(seed)
        buf: List[Any] = []
        for item in reader():
            buf.append(item)
            if len(buf) >= buf_size:
                rng.shuffle(buf)
                for b in buf:
                    yield b
                buf = []
        if buf:
            rng.shuffle(buf)
            for b in buf:
                yield b

    return shuffled


def chain(*readers: Reader) -> Reader:
    def reader():
        for r in readers:
            for item in r():
                yield item

    return reader


def compose(*readers: Reader, check_alignment: bool = True) -> Reader:
    """Zip outputs of several readers into flattened tuples
    (reference decorator.py compose)."""

    def make_tuple(x):
        return x if isinstance(x, tuple) else (x,)

    def reader():
        rs = [r() for r in readers]
        for items in zip(*rs):
            yield sum((make_tuple(i) for i in items), ())

    return reader


def buffered(reader: Reader, size: int) -> Reader:
    """Background-thread prefetch buffer (reference decorator.py buffered)."""

    end = object()

    def buffered_reader():
        q: queue_mod.Queue = queue_mod.Queue(maxsize=size)

        def fill():
            try:
                for item in reader():
                    q.put(item)
                q.put(end)
            except BaseException as e:  # propagate to consumer, don't fake EOF
                q.put(_RaisedInProducer(e))

        t = threading.Thread(target=fill, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is end:
                break
            if isinstance(item, _RaisedInProducer):
                raise item.exc
            yield item

    return buffered_reader


def firstn(reader: Reader, n: int) -> Reader:
    def reader_n():
        return itertools.islice(reader(), n)

    return reader_n


def shard(reader: Reader, num_shards: int, index: int) -> Reader:
    """The per-process sample slice for multi-host data parallelism: shard
    ``index`` yields every ``num_shards``-th sample, and only COMPLETE
    rounds are emitted so every shard sees exactly the same number of
    samples — a straggler shard would desync the collectives at epoch end.
    (Reference analogue: trainer_id-strided dispatch; file-level variant:
    ``dataset.common.cluster_files_reader``.)"""
    from paddle_tpu_torch.core.enforce import enforce

    enforce(num_shards >= 1, f"num_shards must be >= 1, got {num_shards}")
    enforce(
        0 <= index < num_shards,
        f"shard index {index} out of range for {num_shards} shards",
    )

    def sharded():
        # O(1) retained samples: only the index-th of each round is stashed
        pos = 0
        mine = None
        for sample in reader():
            if pos == index:
                mine = sample
            pos += 1
            if pos == num_shards:
                yield mine
                pos, mine = 0, None

    return sharded


def xmap_readers(mapper: Callable, reader: Reader, process_num: int, buffer_size: int, order: bool = False) -> Reader:
    """Multithreaded map over a reader (reference decorator.py:338
    xmap_readers). order=True preserves input order."""

    end = object()

    def xreader():
        in_q: queue_mod.Queue = queue_mod.Queue(buffer_size)
        out_q: queue_mod.Queue = queue_mod.Queue(buffer_size)

        def feed():
            for i, item in enumerate(reader()):
                in_q.put((i, item))
            for _ in range(process_num):
                in_q.put(end)

        def work():
            # a mapper exception must reach the consumer (not strand it in
            # out_q.get() forever) — mirror buffered()'s _RaisedInProducer
            try:
                while True:
                    got = in_q.get()
                    if got is end:
                        out_q.put(end)
                        return
                    i, item = got
                    out_q.put((i, mapper(item)))
            except BaseException as e:  # noqa: BLE001
                out_q.put(_RaisedInProducer(e))
                out_q.put(end)

        threading.Thread(target=feed, daemon=True).start()
        workers = [threading.Thread(target=work, daemon=True) for _ in range(process_num)]
        for w in workers:
            w.start()

        finished = 0
        if order:
            pending = {}
            next_i = 0
            while finished < process_num:
                got = out_q.get()
                if got is end:
                    finished += 1
                    continue
                if isinstance(got, _RaisedInProducer):
                    raise got.exc
                i, val = got
                pending[i] = val
                while next_i in pending:
                    yield pending.pop(next_i)
                    next_i += 1
            for i in sorted(pending):
                yield pending[i]
        else:
            while finished < process_num:
                got = out_q.get()
                if got is end:
                    finished += 1
                    continue
                if isinstance(got, _RaisedInProducer):
                    raise got.exc
                yield got[1]

    return xreader


class ReaderWorkerError(RuntimeError):
    """A multiprocess_reader worker failed. ``pid`` is the worker process;
    ``retryable`` distinguishes a transient crash (process killed hard —
    OOM/segfault/preemption; a retry may succeed) from a poison pill (the
    reader itself RAISED on some sample — deterministic, retrying replays
    the same failure)."""

    def __init__(self, message: str, pid: Optional[int], retryable: bool):
        super().__init__(message)
        self.pid = pid
        self.retryable = retryable


def multiprocess_reader(readers: Sequence[Reader], use_pipe: bool = True, queue_size: int = 1000) -> Reader:
    """Run each reader in its own OS PROCESS, interleaving their samples
    (reference ``decorator.py:338`` multiprocess_reader) — sidesteps the
    GIL for CPU-heavy decode, unlike the thread-based ``xmap_readers``.
    Samples must be picklable; ``use_pipe`` is accepted for API parity
    (one shared queue serves both modes here). Worker exceptions re-raise
    in the consumer as :class:`ReaderWorkerError` carrying the worker pid
    and whether the failure looks transient."""
    from paddle_tpu_torch.core.enforce import enforce as _enforce

    _enforce(len(readers) > 0, "multiprocess_reader needs at least one reader")
    if not use_pipe:
        from paddle_tpu_torch.core import logging as _ptlog

        _ptlog.warning(
            "multiprocess_reader(use_pipe=False): pipe/queue selection is a "
            "no-op here — one shared mp.Queue serves both modes"
        )

    def combined():
        import multiprocessing as mp
        import pickle
        import queue as _qm

        # fork lets closure readers cross the boundary; workers run only
        # the reader (no CUDA use), so forking after runtime init is
        # safe here. Platforms without fork (Windows) get the default
        # context — readers must then be module-level picklables.
        ctx = mp.get_context("fork") if "fork" in mp.get_all_start_methods() else mp.get_context()
        q = ctx.Queue(queue_size)

        def work(r):
            import os as _os

            try:
                for sample in r():
                    # pickle HERE, not in mp.Queue's feeder thread — a
                    # feeder-thread pickling error silently drops the item;
                    # this way it raises into the except and reaches the
                    # consumer as an error message
                    q.put(("item", pickle.dumps(sample)))
            except Exception as e:  # picklable summary, not the traceback
                q.put(("error", (_os.getpid(), f"{type(e).__name__}: {e}")))
            finally:
                q.put(("end", None))

        procs = [ctx.Process(target=work, args=(r,), daemon=True) for r in readers]
        for p in procs:
            p.start()
        finished = 0
        try:
            while finished < len(procs):
                try:
                    kind, payload = q.get(timeout=1.0)
                except _qm.Empty:
                    # a worker killed hard (OOM/segfault) never posts its
                    # sentinel — detect instead of blocking forever. That
                    # death is environmental, so a rerun may well succeed:
                    # retryable, attributed to the dead pid.
                    if not any(p.is_alive() for p in procs) and q.empty():
                        dead = next(
                            (p for p in procs if p.exitcode not in (0, None)),
                            None,
                        )
                        raise ReaderWorkerError(
                            "multiprocess_reader: worker process "
                            f"{dead.pid if dead else '?'} died without "
                            "finishing (killed or crashed, exitcode "
                            f"{dead.exitcode if dead else '?'})",
                            pid=dead.pid if dead else None,
                            retryable=True,
                        )
                    continue
                if kind == "end":
                    finished += 1
                elif kind == "error":
                    # the reader RAISED on a sample — a poison pill that a
                    # retry would deterministically replay: not retryable
                    wpid, msg = payload
                    raise ReaderWorkerError(
                        f"multiprocess_reader worker {wpid} failed: {msg}",
                        pid=wpid,
                        retryable=False,
                    )
                else:
                    yield pickle.loads(payload)
        finally:
            # early close: workers may be blocked on a full queue — stop
            # them first, then reap (no multi-second join stall per worker)
            for p in procs:
                if p.is_alive():
                    p.terminate()
            for p in procs:
                p.join(timeout=2)

    return combined


def batch(reader: Reader, batch_size: int, drop_last: bool = True) -> Reader:
    """Group samples into lists of batch_size (reference paddle.batch).
    drop_last defaults True, as in the JAX package (where a ragged final
    batch recompiles the step)."""

    def batch_reader():
        buf = []
        for item in reader():
            buf.append(item)
            if len(buf) == batch_size:
                yield buf
                buf = []
        if buf and not drop_last:
            yield buf

    return batch_reader


def stack_batch(reader: Reader, batch_size: int, drop_last: bool = True) -> Reader:
    """Like :func:`batch` but yields a tuple of stacked numpy arrays (one per
    sample field) instead of a list of sample tuples — the dense fast path
    feeding train steps directly (ragged fields need
    :class:`DataFeeder` instead)."""
    batched = batch(reader, batch_size, drop_last)

    def stacked():
        for samples in batched():
            n_fields = len(samples[0])
            yield tuple(
                np.stack([np.asarray(s[i]) for s in samples]) for i in range(n_fields)
            )

    return stacked


def cache(reader: Reader) -> Reader:
    """Materialize once, replay from memory."""
    data: List[Any] = []
    filled = [False]

    def cached():
        if not filled[0]:
            for item in reader():
                data.append(item)
                yield item
            filled[0] = True
        else:
            for item in data:
                yield item

    return cached


class DevicePrefetcher:
    """Async host→device double buffer (reference
    ``operators/reader/buffered_reader.cc`` double_buffer: dedicated thread +
    pinned→device copies). Wraps an iterator of tuples of numpy arrays (or
    tensors) and keeps ``depth`` batches transferred ahead of compute.

    On CUDA a producer thread copies each field into pinned host memory and
    from there to the card with ``non_blocking=True`` on its own stream,
    recording an event after the copies. ``__next__`` makes the consumer's
    current stream wait for that event and marks each tensor as used by
    that stream (``record_stream``), so the caching allocator does not hand
    the memory back to the copy stream while the step still reads it. The
    batch's values are those an unprefetched copy gives."""

    def __init__(self, it: Iterable, device=None, depth: Optional[int] = None):
        from paddle_tpu_torch.core import config as cfg

        self._it = iter(it)
        self._device = cfg.resolve_device("cuda" if device is None else device)
        self._depth = depth or cfg.flags().prefetch_depth
        self._q: queue_mod.Queue = queue_mod.Queue(maxsize=self._depth)
        self._end = object()
        self._thread = threading.Thread(target=self._fill, daemon=True, name="device-prefetch")
        self._thread.start()

    def _fill(self):
        import torch

        from paddle_tpu_torch.core.config import on_device
        from paddle_tpu_torch.executor import to_device

        try:
            cuda = self._device.type == "cuda"
            stream = torch.cuda.Stream(self._device) if cuda else None
            for item in self._it:
                if not cuda:
                    self._q.put((tuple(to_device(f, self._device) for f in item), None))
                    continue
                with torch.cuda.stream(stream):
                    dev_item = tuple(
                        f if isinstance(f, torch.Tensor) and on_device(f, self._device)
                        else to_device(to_device(f, torch.device("cpu")).pin_memory(),
                                       self._device, non_blocking=True)
                        for f in item)
                    done = torch.cuda.Event()
                    done.record(stream)
                self._q.put((dev_item, done))
            self._q.put(self._end)
        except BaseException as e:  # surface pipeline errors, don't fake EOF
            self._q.put(_RaisedInProducer(e))

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is self._end:
            raise StopIteration
        if isinstance(item, _RaisedInProducer):
            raise item.exc
        batch, done = item
        if done is not None:
            import torch

            consumer = torch.cuda.current_stream(self._device)
            consumer.wait_event(done)
            for t in batch:
                t.record_stream(consumer)
        return batch
