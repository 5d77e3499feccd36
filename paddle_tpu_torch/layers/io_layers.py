"""layers/io.py parity: graph-feeding readers as a host pipeline — port of
``paddle_tpu/layers/io_layers.py``.

Reference: ``python/paddle/fluid/layers/io.py`` — ``py_reader`` (:473,
LoDTensorBlockingQueue + read op), ``open_files``/``open_recordio_file``
(:344), ``double_buffer`` (:612-625 device prefetch), ``read_file``,
``random_data_generator``, ``layers/ops load``. As in the JAX package, the
program takes tensors as arguments and the pipeline runs on host threads
with device prefetch (:class:`paddle_tpu_torch.reader.DevicePrefetcher`,
pinned host memory and a copy stream on CUDA). The prefetching readers put
their batches on ``place``: CUDA by default, ``"cpu"`` for the CPU.

``open_recordio_file`` and ``open_files`` read the native RecordIO format
through the JAX package's ``native.RecordIOScanner``, which is not ported:
they raise ``NotImplementedError`` (ROADMAP §A item 8).
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np

from paddle_tpu_torch import reader as reader_mod
from paddle_tpu_torch.core.enforce import enforce

__all__ = [
    "PyReader",
    "Preprocessor",
    "py_reader",
    "double_buffer",
    "open_files",
    "open_recordio_file",
    "read_file",
    "random_data_generator",
    "load",
    "batch",
    "shuffle",
]

batch = reader_mod.batch
shuffle = reader_mod.shuffle


class PyReader:
    """Python-fed reader (reference ``layers/io.py:473`` py_reader): the
    fluid version creates a blocking queue + in-graph read op; here the queue
    is a host prefetch pipeline and ``__iter__`` yields batches already on
    ``place`` (default CUDA)::

        r = layers.py_reader(capacity=64, shapes=[...], dtypes=[...])
        r.decorate_paddle_reader(train_reader)
        for batch in r:
            step(*batch)
    """

    def __init__(self, capacity: int, shapes: Sequence[Sequence[int]],
                 dtypes: Sequence[str], name: Optional[str] = None, place=None):
        self.capacity = capacity
        self.shapes = [tuple(s) for s in shapes]
        self.dtypes = [np.dtype(d) for d in dtypes]
        self.place = place
        self._source: Optional[Callable] = None

    def decorate_paddle_reader(self, reader_fn: Callable) -> None:
        """Attach a sample reader (each item: tuple matching shapes/dtypes)."""
        self._source = reader_fn

    decorate_tensor_provider = decorate_paddle_reader

    def start(self):
        return iter(self)

    def __iter__(self):
        enforce(self._source is not None, "decorate_paddle_reader first")
        buffered = reader_mod.buffered(self._source, self.capacity)
        return iter(reader_mod.DevicePrefetcher(buffered(), device=self.place))


def py_reader(capacity: int, shapes: Sequence[Sequence[int]],
              dtypes: Sequence[str], name: Optional[str] = None, place=None) -> PyReader:
    return PyReader(capacity, shapes, dtypes, name, place)


class Preprocessor:
    """Reader-transform block (reference ``layers/io.py`` Preprocessor: a
    sub-block of ops applied between read and feed). Functional adapter:
    the block body is a mapper applied on the host pipeline::

        p = Preprocessor(reader)
        p.block(lambda *sample: transformed_sample)
        for item in p(): ...
    """

    def __init__(self, reader: Callable, name: Optional[str] = None):
        self._reader = reader
        self._mapper: Optional[Callable] = None

    def block(self, mapper: Callable) -> None:
        self._mapper = mapper

    def __call__(self):
        enforce(self._mapper is not None, "Preprocessor.block(mapper) first")
        m = self._mapper

        def apply(sample):
            return m(*sample) if isinstance(sample, tuple) else m(sample)

        return reader_mod.map_readers(apply, self._reader)()


def double_buffer(reader: Callable, place=None) -> Callable:
    """Device prefetch decorator (reference ``layers/io.py`` double_buffer /
    C++ buffered_reader): two batches copied to ``place`` (default CUDA)
    ahead of the step."""
    def decorated():
        return iter(reader_mod.DevicePrefetcher(reader(), device=place, depth=2))

    return decorated


def open_recordio_file(filename: str, shapes=None, dtypes=None) -> Callable:
    """Reader over a native RecordIO file (reference ``layers/io.py:344``):
    not ported — it stands on the JAX package's native RecordIO scanner."""
    raise NotImplementedError(
        "open_recordio_file reads through the native RecordIO scanner, which "
        "paddle_tpu_torch does not port yet (ROADMAP §A item 8)")


def open_files(filenames: Sequence[str], shapes=None, dtypes=None,
               thread_num: int = 1) -> Callable:
    """Multi-file RecordIO reader (reference ``layers/io.py`` open_files):
    not ported, as :func:`open_recordio_file`."""
    raise NotImplementedError(
        "open_files reads through the native RecordIO scanner, which "
        "paddle_tpu_torch does not port yet (ROADMAP §A item 8)")


def read_file(reader_obj) -> tuple:
    """Pull one item (reference ``layers/io.py`` read_file op)."""
    return next(iter(reader_obj() if callable(reader_obj) else reader_obj))


def random_data_generator(low: float, high: float,
                          shapes: Sequence[Sequence[int]],
                          seed: int = 0, count: int = 1 << 30) -> Callable:
    """Synthetic uniform reader (reference
    ``operators/reader/create_random_data_generator_op.cc``): f32 numpy
    arrays from ``np.random.RandomState(seed)``, the JAX package's stream."""
    def r():
        rng = np.random.RandomState(seed)
        for _ in range(count):
            yield tuple(rng.uniform(low, high, size=s).astype(np.float32) for s in shapes)

    return r


def load(dirname: str, device="cuda"):
    """Load saved persistables (reference ``layers/ops`` load op /
    ``io.load_persistables``): the Variables saved by ``io.save_params``,
    on ``device`` (default CUDA)."""
    from paddle_tpu_torch import io as io_mod

    return io_mod.load_params(dirname, device=device)
