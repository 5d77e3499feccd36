"""The port's reader package (``paddle_tpu_torch.reader``) on the CPU: the
decorators copied from ``paddle_tpu.reader`` give the same sequences as the
JAX package's on the same seeds (exact equality), the DataFeeder the same
arrays, and the DevicePrefetcher the same batches as an unprefetched loop.
Its CUDA path (pinned memory, a side stream) is tested on the card in
``tests/test_torch_cuda_kernels.py``.
"""

import torch_threads  # noqa: F401  (first: its share of the cores)
import numpy as np
import pytest
import torch

from paddle_tpu import reader as jreader
from paddle_tpu.reader import feeder as jfeeder
from paddle_tpu_torch import reader as treader
from paddle_tpu_torch.reader import feeder as tfeeder


def _samples(n=23, seed=0):
    def reader():
        rng = np.random.RandomState(seed)
        for i in range(n):
            yield rng.randn(3).astype(np.float32), i

    return reader


def _same(a, b):
    """Equal nested sequences of samples, field by field."""
    if isinstance(a, (tuple, list)) or hasattr(a, "__next__"):
        a, b = list(a), list(b)
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("build", [
    lambda r: r.shuffle(_samples(), buf_size=7, seed=3),
    lambda r: r.batch(_samples(), 5, drop_last=True),
    lambda r: r.batch(_samples(), 5, drop_last=False),
    lambda r: r.stack_batch(r.shuffle(_samples(), 10, seed=1), 4),
    lambda r: r.chain(_samples(5), _samples(4, seed=1)),
    lambda r: r.compose(_samples(6), _samples(6, seed=2)),
    lambda r: r.map_readers(lambda a, b: (a[0] + b[0], a[1] * b[1]), _samples(6), _samples(6, seed=4)),
    lambda r: r.firstn(_samples(), 9),
    lambda r: r.shard(_samples(), 3, 1),
    lambda r: r.buffered(_samples(), 4),
    lambda r: r.xmap_readers(lambda s: (s[0] * 2, s[1] + 1), _samples(), 3, 4, order=True),
    lambda r: r.cache(_samples(8)),
], ids=["shuffle", "batch", "batch_ragged", "stack_batch_shuffled", "chain", "compose",
        "map_readers", "firstn", "shard", "buffered", "xmap_ordered", "cache"])
def test_decorators_match_jax_package(build):
    _same(build(jreader)(), build(treader)())


def test_unordered_xmap_and_multiprocess_reader_keep_every_sample():
    got = sorted(s[1] for s in treader.xmap_readers(lambda s: s, _samples(), 4, 2)())
    assert got == list(range(23))
    got = sorted(s[1] for s in treader.multiprocess_reader([_samples(5), _samples(6, seed=1)])())
    assert got == sorted(list(range(5)) + list(range(6)))


def test_multiprocess_reader_poison_pill_not_retryable():
    def bad():
        yield 1
        raise ValueError("poison")

    with pytest.raises(treader.ReaderWorkerError) as ei:
        list(treader.multiprocess_reader([bad])())
    assert not ei.value.retryable and "poison" in str(ei.value)


def test_data_feeder_matches_jax_package():
    rng = np.random.RandomState(0)
    samples = [(rng.randn(4).astype(np.float32), rng.randint(0, 9, size=rng.randint(1, 5)))
               for _ in range(6)]
    specs = lambda m: [m.FeedSpec("x", (4,)), m.FeedSpec("ids", (None,), "int64", ragged=True)]  # noqa: E731
    j = jfeeder.DataFeeder(specs(jfeeder)).feed(samples)
    t = tfeeder.DataFeeder(specs(tfeeder)).feed(samples)
    assert sorted(j) == sorted(t) == ["ids", "ids_len", "x"]
    for k in j:
        assert j[k].dtype == t[k].dtype
        np.testing.assert_array_equal(j[k], t[k])


def test_device_prefetcher_cpu_matches_plain_and_raises():
    batches = list(treader.stack_batch(_samples(), 4)())
    got = list(treader.DevicePrefetcher(iter(batches), device="cpu", depth=2))
    assert len(got) == len(batches)
    for g, b in zip(got, batches):
        assert all(isinstance(t, torch.Tensor) for t in g)
        assert g[1].dtype == torch.int64
        for t, a in zip(g, b):
            np.testing.assert_array_equal(t.numpy(), a)

    def bad():
        yield batches[0]
        raise RuntimeError("producer died")

    it = treader.DevicePrefetcher(bad(), device="cpu")
    next(it)
    with pytest.raises(RuntimeError, match="producer died"):
        next(it)
