"""Two places where the port once answered differently from the JAX
package, each held against it on the CPU.

- The ``trainer.step`` fault point sits before the step's timed region in
  both Trainers: under the same seeded stall the step-time histogram's
  count, its sum (below the stall in both: the stall is not step time) and
  the ``StragglerDetector("trainer.step")`` flags agree.
- The metrics exporter serves ``/tenants`` and answers 404 to
  ``/admission`` in both packages.
"""

import torch_threads  # noqa: F401  (first: its share of the cores)
import urllib.error
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jpt
import paddle_tpu_torch as pt
from paddle_tpu import observability as jobs
from paddle_tpu import trainer as jtrainer
from paddle_tpu.core import config as jconfig
from paddle_tpu.core import profiler as jprof
from paddle_tpu.observability import metrics as jmetrics
from paddle_tpu.resilience import faults as jfaults
from paddle_tpu_torch import observability as tobs
from paddle_tpu_torch.core import config as tconfig
from paddle_tpu_torch.core import profiler as tprof
from paddle_tpu_torch.observability import metrics as tmetrics
from paddle_tpu_torch.resilience import faults
from paddle_tpu_torch.trainer import Trainer

STALL_S = 0.3  # ~300 steps of this model in either package
# the straggler watch's ratio for this test: far above the host's noise on
# millisecond steps, far below the stall, were it step time
STRAGGLER_RATIO = 100.0
WARM_BATCHES, BATCHES, STALL_AFTER = 2, 5, 2


def _reader(n):
    def reader():
        rng = np.random.RandomState(0)
        for _ in range(n):
            x = rng.randn(8, 4).astype(np.float32)
            yield x, x.sum(1, keepdims=True)

    return reader


def _port_net(x, y):
    return torch.mean(pt.ops.nn.square_error_cost(pt.layers.fc(x, size=1), y))


def _jax_net(x, y):
    return jnp.mean(jpt.ops.nn.square_error_cost(jpt.layers.fc(x, size=1), y))


def _stalled_run(trainer, prof, registry, fmod):
    """Warm the trainer (JAX compiles its step here), then train 2 epochs
    of BATCHES under one seeded stall of the trainer.step fault point.
    Returns that run's (step-time count, step-time sum, straggler flags)."""
    trainer.train(num_epochs=1, reader=_reader(WARM_BATCHES))

    def read():
        h = registry.default_registry().histogram_snapshot("trainer.step_seconds")
        flags = prof.counters().get("tracing.straggler.flags_total", 0.0)
        return h["count"], h["sum"], flags

    before = read()
    with fmod.injected(fmod.FaultSpec(fmod.TRAINER_STEP, "stall", after=STALL_AFTER,
                                      times=1, stall_s=STALL_S)):
        trainer.train(num_epochs=2, reader=_reader(BATCHES))
    return tuple(a - b for a, b in zip(read(), before))


def test_trainer_step_stall_is_outside_the_step_time_in_both():
    saved = (jconfig.flags().straggler_ratio, tconfig.flags().straggler_ratio)
    jconfig.set_flags(straggler_ratio=STRAGGLER_RATIO)
    tconfig.set_flags(straggler_ratio=STRAGGLER_RATIO)
    try:
        j = _stalled_run(jtrainer.Trainer(lambda: _jax_net,
                                          lambda: jpt.optimizer.SGD(learning_rate=0.1)),
                         jprof, jmetrics, jfaults)
        t = _stalled_run(Trainer(lambda: _port_net, lambda: pt.optimizer.SGD(learning_rate=0.1),
                                 place="cpu"), tprof, tmetrics, faults)
    finally:
        jfaults.clear()
        faults.clear()
        jconfig.set_flags(straggler_ratio=saved[0])
        tconfig.set_flags(straggler_ratio=saved[1])
    assert t[0] == j[0] == 2 * BATCHES
    assert t[1] < STALL_S and j[1] < STALL_S, (t, j)  # the stall is in neither sum
    assert t[2] == j[2] == 0.0


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=10) as r:
            return r.status
    except urllib.error.HTTPError as e:
        return e.code


@pytest.mark.parametrize("path", ["/tenants", "/admission"])
def test_exporter_tenant_paths_answer_as_the_jax_exporter(path):
    jobs.shutdown()
    tobs.shutdown()
    try:
        jurl = jobs.setup(jobs.ObservabilityConfig(metrics_port=0)).url
        turl = tobs.setup(tobs.ObservabilityConfig(metrics_port=0)).url
        assert _get(turl + path) == _get(jurl + path) == (200 if path == "/tenants" else 404)
    finally:
        jobs.shutdown()
        tobs.shutdown()


@pytest.mark.parametrize("op,shapes", [
    (torch.bmm, ((2, 3, 4), (2, 4, 5))),
    (torch.mm, ((3, 4), (4, 5))),
])
def test_cost_counter_counts_out_dtype_products(op, shapes):
    """The bf16 products with an f32 out_dtype (the port's tensor-core
    path on the card; ``bmm.dtype`` has no CPU kernel, so fake tensors
    here) count the FLOPs of the plain product, as the roofline ledger's
    first call of a composed-attention forward needs."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode

    from paddle_tpu_torch.observability import mfu

    with FakeTensorMode():
        a, b = (torch.randn(*s, dtype=torch.bfloat16) for s in shapes)
        with mfu.CostCounter() as counter:
            out = op(a, b, out_dtype=torch.float32)
        with FlopCounterMode(display=False) as plain:
            op(a.float(), b.float())
    assert out.dtype == torch.float32
    assert counter.flops == plain.get_total_flops() > 0
