"""The port's static serving path (``paddle_tpu_torch.serving``:
``ShapeBuckets``, ``MicroBatcher``, ``ServingMetrics``, ``TokenBucket``,
``ServingEngine``) and ``Inferencer`` against the JAX package's, on the CPU.

The MLP and the traffic of ``tests/test_serving.py``, with the JAX
``init``'s weights carried across (both packages load the same
``save_params`` directory), and ``num_replicas=2`` in both (the port's two
replicas share the CPU; the JAX engine's take two of the 8-device CPU
mesh). Tolerances: engine results against the JAX engine's at rtol 1e-5
(atol 1e-6: f32 products summed in other orders); against the port's
unbatched ``Inferencer`` as ``test_serving.py`` holds them (rtol 1e-4,
atol 1e-6); the tiny LM's logits, request by request, at rtol 1e-5 and
atol 1e-5. Every engine closes in ``finally``, and every wait on a thread
or a result has a time limit.
"""

import torch_threads  # noqa: F401  (first: its share of the cores)
import threading
import time

import jax
import numpy as np
import pytest
import torch

import paddle_tpu as jpt
import paddle_tpu_torch as pt
from paddle_tpu import concurrency as jcc
from paddle_tpu import models as jmodels
from paddle_tpu import tracing as jtracing
from paddle_tpu.observability import metrics as jmetrics
from paddle_tpu.reader.feeder import FeedSpec as JFeedSpec
from paddle_tpu.serving import MicroBatcher as JMicroBatcher
from paddle_tpu.serving import ServingConfig as JServingConfig
from paddle_tpu.serving import ServingEngine as JServingEngine
from paddle_tpu.serving import ShapeBuckets as JShapeBuckets
from paddle_tpu.serving import TokenBucket as JTokenBucket
from paddle_tpu.serving.admission import merge_histogram_snapshots as jmerge
from paddle_tpu.serving.metrics import ServingMetrics as JServingMetrics
from paddle_tpu_torch import concurrency as cc
from paddle_tpu_torch import convert, framework, tracing
from paddle_tpu_torch.core import profiler as prof
from paddle_tpu_torch.core.enforce import EnforceError
from paddle_tpu_torch.models import get_model, transformer_lm
from paddle_tpu_torch.observability import metrics as tmetrics
from paddle_tpu_torch.reader.feeder import FeedSpec
from paddle_tpu_torch.resilience import faults
from paddle_tpu_torch.serving import (
    AdmissionRejected,
    DeadlineExceeded,
    EngineClosedError,
    MicroBatcher,
    ReplicaDied,
    ServingConfig,
    ServingEngine,
    ShapeBuckets,
    TenantConfig,
    TokenBucket,
)
from paddle_tpu_torch.serving.admission import merge_histogram_snapshots
from paddle_tpu_torch.serving.metrics import ServingMetrics

D_IN = 5
WAIT_S = 60  # any one result, thread or drain; the CPU runs take well under a second
RTOL, ATOL = 1e-5, 1e-6


def _jit_init(model, *args):
    """The JAX model's init(0) jitted: the same values as the eager init,
    a compile instead of an op-by-op run (seconds at these sizes)."""
    return jax.jit(lambda *a: model.init(0, *a))(*args)


def _tnet(x):
    h = pt.layers.fc(x, size=8, act="relu", name="fc1")
    return pt.layers.fc(h, size=3, name="fc2")


def _jnet(x):
    h = jpt.layers.fc(x, size=8, act="relu", name="fc1")
    return jpt.layers.fc(h, size=3, name="fc2")


def _specs(mod):
    return [mod("x", (D_IN,), "float32")]


@pytest.fixture(scope="module")
def param_dir(tmp_path_factory):
    """The JAX init's weights in a save_params directory both packages load."""
    x0 = np.random.RandomState(0).randn(4, D_IN).astype(np.float32)
    variables = jpt.build(_jnet).init(0, x0)
    path = str(tmp_path_factory.mktemp("serving_static") / "params")
    jpt.io.save_params(path, variables)
    return path


@pytest.fixture(scope="module")
def served(param_dir):
    """The warmed port engine, its unbatched Inferencer, and the JAX engine."""
    cfg = dict(max_batch_size=8, max_queue_delay_s=0.02, queue_capacity=128, num_replicas=2)
    inferencer = pt.Inferencer(_tnet, param_dir, place="cpu", feed_order=_specs(FeedSpec))
    engine = inferencer.as_engine(_specs(FeedSpec), config=ServingConfig(**cfg))
    jengine = jpt.Inferencer(_jnet, param_dir, feed_order=_specs(JFeedSpec)).as_engine(
        _specs(JFeedSpec), config=JServingConfig(**cfg))
    try:
        yield engine, inferencer, jengine
    finally:
        engine.close(timeout=WAIT_S)
        jengine.close(timeout=WAIT_S)


def _concurrent(engine, feeds):
    results, errors = {}, []

    def client(i):
        try:
            results[i] = engine.infer({"x": feeds[i]})
        except Exception as e:  # surfaced by the assert below
            errors.append((i, e))

    threads = [threading.Thread(target=client, args=(i,)) for i in range(len(feeds))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=WAIT_S)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    return results


def test_concurrent_load_matches_jax_engine_and_unbatched_inferencer(served):
    engine, inferencer, jengine = served
    sizes_before = engine.aot_cache_sizes()
    assert engine.num_replicas == 2
    assert engine.metrics.warmup_executables == len(engine.buckets.batch_buckets) * 2
    assert sizes_before == [len(engine.buckets.batch_buckets)] * 2
    feeds = [np.random.RandomState(100 + i).randn(1 + i % 3, D_IN).astype(np.float32)
             for i in range(48)]  # mixed request batch sizes 1/2/3
    got = _concurrent(engine, feeds)
    ref = _concurrent(jengine, feeds)
    for i, x in enumerate(feeds):
        assert isinstance(got[i], torch.Tensor) and got[i].device.type == "cpu"
        np.testing.assert_allclose(got[i].numpy(), np.asarray(ref[i]), rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(got[i].numpy(), inferencer.infer([x]).numpy(),
                                   rtol=1e-4, atol=1e-6)
    snap = engine.metrics.snapshot()
    assert snap["responses_total"] >= len(feeds)
    assert snap["mean_batch_occupancy"] > 1.0, snap
    assert snap["padded_batches_total"] >= 1, snap
    assert snap["distinct_dispatch_shapes"] <= len(engine.buckets.batch_buckets)
    assert engine.aot_cache_sizes() == sizes_before  # no shape met for the first time
    assert set(snap) == set(jengine.metrics.snapshot())


def test_deadline_expired_gets_timeout_error(served):
    engine, _, _ = served
    x = np.zeros((1, D_IN), np.float32)
    before = engine.metrics.timeouts_total
    with pytest.raises(DeadlineExceeded):
        engine.infer({"x": x}, deadline_s=0.0)
    assert engine.metrics.timeouts_total == before + 1
    assert tuple(engine.infer({"x": x}).shape) == (1, 3)


def test_dict_feed_order_independent_and_bad_requests(served):
    engine, inferencer, _ = served
    x = np.random.RandomState(7).randn(2, D_IN).astype(np.float32)
    np.testing.assert_allclose(engine.infer({"x": x}).numpy(),
                               inferencer.infer({"x": x}).numpy(), rtol=1e-4, atol=1e-6)
    with pytest.raises(EnforceError):
        engine.infer({"wrong_name": x})
    with pytest.raises(EnforceError):
        engine.submit({"x": np.zeros((9, D_IN), np.float32)})  # > max_batch
    with pytest.raises(EnforceError):
        engine.submit({"x": np.zeros((1, D_IN + 1), np.float32)})  # bad dim


def _engine(param_dir, **cfg):
    variables = pt.io.load_params(param_dir, device="cpu")
    return ServingEngine(pt.build(_tnet), variables, _specs(FeedSpec),
                         config=ServingConfig(**cfg), place="cpu"), variables


def test_graceful_drain_on_close(param_dir):
    """close() completes every accepted request, then rejects new ones."""
    engine, variables = _engine(param_dir, max_batch_size=8, max_queue_delay_s=5.0,
                                num_replicas=1)
    rng = np.random.RandomState(1)
    pendings = [(x, engine.submit({"x": x}))
                for x in (rng.randn(1, D_IN).astype(np.float32) for _ in range(5))]
    assert not any(p.done() for _, p in pendings)  # parked in the batcher
    assert engine.close(timeout=WAIT_S) == []
    model = pt.build(_tnet)
    for x, p in pendings:
        with torch.no_grad():
            expect, _ = model.apply(variables, torch.from_numpy(x))
        np.testing.assert_allclose(p.result(timeout=5).numpy(), expect.numpy(), rtol=1e-4)
    with pytest.raises(EngineClosedError):
        engine.submit({"x": np.zeros((1, D_IN), np.float32)})
    assert engine.close() == []  # idempotent


def test_backpressure_bounded_queue(param_dir):
    """With the pipeline wedged, submit() blocks on the bounded queue and
    surfaces TimeoutError instead of growing an unbounded backlog."""
    engine, _ = _engine(param_dir, max_batch_size=2, max_queue_delay_s=0.001,
                        queue_capacity=2, num_replicas=1)
    release = threading.Event()
    try:
        orig_flush = engine._batcher._flush
        engine._batcher._flush = lambda g: (release.wait(WAIT_S), orig_flush(g))
        x0 = np.zeros((1, D_IN), np.float32)
        timed_out, pendings = 0, []
        for _ in range(8):
            try:
                pendings.append(engine.submit({"x": x0}, timeout=0.05))
            except TimeoutError:
                timed_out += 1
        assert timed_out >= 1
        release.set()
        for p in pendings:
            p.result(timeout=WAIT_S)
    finally:
        release.set()
        engine.close(timeout=WAIT_S)


def test_dispatch_faults_eject_a_replica_then_let_it_back_in(param_dir):
    """SERVING_DISPATCH errors on replica 0: its breaker ejects it, its
    batches redispatch to replica 1 (no caller fails), and once the fault
    is gone the half-open probe re-admits it."""
    engine, _ = _engine(param_dir, max_batch_size=4, max_queue_delay_s=0.001,
                        num_replicas=2, replica_failure_threshold=2,
                        replica_cooldown_s=0.05, replica_max_cooldown_s=0.2)
    x0 = np.zeros((1, D_IN), np.float32)
    try:
        with faults.injected(faults.FaultSpec(faults.SERVING_DISPATCH, "error",
                                              times=10_000, match={"replica": 0})):
            for _ in range(12):
                assert tuple(engine.infer({"x": x0}).shape) == (1, 3)
            snap = engine.metrics.snapshot()
            assert snap["replica_ejections_total"] >= 1, snap
            assert snap["redispatches_total"] >= 1, snap
            assert snap["errors_total"] == 0, snap
            assert any(h["state"] != "closed" for h in engine.replica_health())
        deadline = time.monotonic() + WAIT_S
        while time.monotonic() < deadline and engine.metrics.replica_recoveries_total < 1:
            engine.infer({"x": x0})
            time.sleep(0.02)
        assert engine.metrics.replica_recoveries_total >= 1
        assert all(h["state"] == "closed" for h in engine.replica_health())
    finally:
        faults.clear()
        assert engine.close(timeout=WAIT_S) == []


def test_worker_death_fails_fast_and_survivor_serves(param_dir):
    engine, _ = _engine(param_dir, max_batch_size=4, max_queue_delay_s=0.001, num_replicas=2)
    x0 = np.zeros((1, D_IN), np.float32)
    try:
        def bomb(*a, **k):
            raise SystemExit("simulated runtime abort")

        engine._replicas[0].compiled = bomb
        died = ok = 0
        for _ in range(10):
            try:
                engine.infer({"x": x0})
                ok += 1
            except ReplicaDied:
                died += 1
        assert died >= 1 and ok >= 1
        assert engine.metrics.replica_deaths_total == 1
        health = engine.replica_health()
        assert health[0]["dead"] and not health[1]["dead"]
        for _ in range(4):
            assert tuple(engine.infer({"x": x0}).shape) == (1, 3)
    finally:
        assert engine.close(timeout=WAIT_S) == []


def _wedged_tenant_run(engine, rejected_type):
    """Wedge the batcher on its first batch, then offer 6 requests to each
    of two tenants: returns {tenant: (accepted, shed)} once all resolve."""
    release, wedged = threading.Event(), threading.Event()
    orig_flush = engine._batcher._flush
    engine._batcher._flush = lambda g: (wedged.set(), release.wait(WAIT_S), orig_flush(g))
    x0 = np.zeros((1, D_IN), np.float32)
    try:
        first = engine.submit({"x": x0}, tenant="a")
        assert wedged.wait(WAIT_S), "batcher never reached the wedged flush"
        counts, pendings = {}, [first]
        for tenant in ("a", "b"):
            shed = 0
            for _ in range(6):
                try:
                    pendings.append(engine.submit({"x": x0}, tenant=tenant))
                except rejected_type as e:
                    assert e.reason == "queue_quota" and e.tenant == tenant
                    shed += 1
            counts[tenant] = shed
        release.set()
        for p in pendings:
            assert tuple(np.asarray(p.result(timeout=WAIT_S)).shape) == (1, 3)
        return counts
    finally:
        release.set()


def test_two_tenant_admission_sheds_as_the_jax_engine(param_dir):
    from paddle_tpu.serving import AdmissionRejected as JAdmissionRejected
    from paddle_tpu.serving import TenantConfig as JTenantConfig

    cfg = dict(max_batch_size=2, max_queue_delay_s=0.001, num_replicas=1)
    engine, _ = _engine(param_dir, tenants=[TenantConfig("a", queue_capacity=2),
                                            TenantConfig("b", queue_capacity=3)], **cfg)
    jengine = JServingEngine(
        jpt.build(_jnet), jpt.io.load_params(param_dir), _specs(JFeedSpec),
        config=JServingConfig(tenants=[JTenantConfig("a", queue_capacity=2),
                                       JTenantConfig("b", queue_capacity=3)], **cfg))
    try:
        got = _wedged_tenant_run(engine, AdmissionRejected)
        ref = _wedged_tenant_run(jengine, JAdmissionRejected)
        assert got == ref == {"a": 4, "b": 3}
        for tenant in ("a", "b"):
            assert engine.metrics.tenant_shed(tenant) == jengine.metrics.tenant_shed(tenant)
            assert engine.metrics.tenant_admitted(tenant) == \
                jengine.metrics.tenant_admitted(tenant)
        assert engine.metrics.shed_total() == jengine.metrics.shed_total() == 7
    finally:
        engine.close(timeout=WAIT_S)
        jengine.close(timeout=WAIT_S)


def _retry_storm(engine, rejected_type):
    """Wedge the batcher, fill tenant t's one-slot quota, then make 6 submits
    with retries=2: returns (retries_total, retry_budget_exhausted_total)."""
    release, wedged = threading.Event(), threading.Event()
    orig_flush = engine._batcher._flush
    engine._batcher._flush = lambda g: (wedged.set(), release.wait(WAIT_S), orig_flush(g))
    x0 = np.zeros((1, D_IN), np.float32)
    try:
        accepted = [engine.submit({"x": x0}, tenant="t")]
        assert wedged.wait(WAIT_S), "batcher never reached the wedged flush"
        while True:  # the batcher is blocked: fill the 1-slot quota
            try:
                accepted.append(engine.submit({"x": x0}, tenant="t"))
            except rejected_type:
                break
        for _ in range(6):
            with pytest.raises(rejected_type):
                engine.submit({"x": x0}, tenant="t", retries=2, backoff=0.001)
        snap = engine.metrics.snapshot()
        release.set()
        for p in accepted:
            p.result(timeout=WAIT_S)
        return snap["retries_total"], snap["retry_budget_exhausted_total"]
    finally:
        release.set()


def test_retry_budget_caps_retries_as_the_jax_engine(param_dir):
    """submit(retries=) retries typed rejections, but the per-engine
    TokenBucket (burst 3, refill 0) caps the retries at 3, in both."""
    from paddle_tpu.serving import AdmissionRejected as JAdmissionRejected
    from paddle_tpu.serving import TenantConfig as JTenantConfig

    cfg = dict(max_batch_size=2, max_queue_delay_s=0.001, num_replicas=1,
               retry_budget_per_s=0.0, retry_budget_burst=3.0)
    engine, _ = _engine(param_dir, tenants=[TenantConfig("t", queue_capacity=1)], **cfg)
    jengine = JServingEngine(
        jpt.build(_jnet), jpt.io.load_params(param_dir), _specs(JFeedSpec),
        config=JServingConfig(tenants=[JTenantConfig("t", queue_capacity=1)], **cfg))
    try:
        got = _retry_storm(engine, AdmissionRejected)
        assert got == _retry_storm(jengine, JAdmissionRejected)
        assert got[0] == 3 and got[1] >= 1
    finally:
        engine.close(timeout=WAIT_S)
        jengine.close(timeout=WAIT_S)


def _engine_families(registry, label):
    return sorted(f.name for f in registry.default_registry().collect()
                  if any(dict(k).get("engine") == label for k, _ in f.samples))


def test_one_request_writes_the_jax_engines_families_and_span_tree(param_dir):
    tracing.enable_tracing()
    jtracing.enable_tracing()
    cfg = dict(max_batch_size=4, max_queue_delay_s=0.001, num_replicas=1)
    engine, _ = _engine(param_dir, engine_label="static_parity_t", **cfg)
    jengine = JServingEngine(jpt.build(_jnet), jpt.io.load_params(param_dir),
                             _specs(JFeedSpec),
                             config=JServingConfig(engine_label="static_parity_j", **cfg))
    x = np.ones((2, D_IN), np.float32)
    try:
        pend, jpend = engine.submit({"x": x}), jengine.submit({"x": x})
        pend.result(timeout=WAIT_S)
        jpend.result(timeout=WAIT_S)
        names = sorted(s.name for s in tracing.spans_for_trace(pend.trace.trace_id))
        jnames = sorted(s.name for s in jtracing.spans_for_trace(jpend.trace.trace_id))
        assert names == jnames
        assert {"serving.request", "serving.enqueue", "serving.queue_wait", "serving.pad",
                "serving.dispatch", "serving.execute", "serving.reply"} == set(names)
        fams = _engine_families(tmetrics, "static_parity_t")
        assert fams == _engine_families(jmetrics, "static_parity_j")
        assert "serving.requests_total" in fams and "serving.replica_exec_seconds" in fams
    finally:
        engine.close(timeout=WAIT_S)
        jengine.close(timeout=WAIT_S)


def test_refusals_name_the_roadmap(param_dir):
    with pytest.raises(NotImplementedError, match="item 7"):
        _engine(param_dir, prewarm=True)
    engine, _ = _engine(param_dir, num_replicas=1, warmup=False)
    try:
        with pytest.raises(NotImplementedError, match="item 7"):
            engine.prewarm()
        assert engine.aot_cache_sizes() == [0]
    finally:
        engine.close(timeout=WAIT_S)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ServingEngine(pt.build(_tnet), pt.io.load_params(param_dir, device="cpu"),
                      _specs(FeedSpec))  # the card by default


LM = dict(seq_len=16, vocab=97, d_model=32, d_inner=64, num_heads=4, n_layers=2)
LENGTHS = [3, 8, 5, 12, 16, 7, 10, 1]


def _lm_logits_net(cfg, mod):
    return lambda tokens: mod.lm_forward(tokens, tokens, cfg=cfg)[2]


def test_ragged_lm_requests_match_the_jax_engine(both_flash):
    """A ragged token FeedSpec with length buckets on a tiny LM, flash on in
    both packages: each request's logits rows equal the JAX engine's."""
    from paddle_tpu.models import transformer_lm as jtlm

    jspec = jmodels.get_model("transformer_lm", **LM)
    ids, labels = jspec.synth_batch(2, np.random.RandomState(0))
    jvars = _jit_init(jspec.model, ids, labels)
    tspec = get_model("transformer_lm", device="cpu", **LM)
    tvars = framework.Variables(convert.params_from_jax(jvars.params, "cpu"),
                                convert.params_from_jax(jvars.state, "cpu"))
    # one batch bucket: the JAX engine compiles 2 shapes, not 6
    cfg = dict(max_batch_size=4, batch_buckets=(4,), max_queue_delay_s=0.02,
               length_buckets=(8, 16), num_replicas=1)
    engine = ServingEngine(framework.build(_lm_logits_net(tspec.extra["cfg"], transformer_lm)),
                           tvars, [FeedSpec("tokens", (None,), "int32")],
                           config=ServingConfig(**cfg), place="cpu")
    jengine = JServingEngine(jpt.build(_lm_logits_net(jspec.extra["cfg"], jtlm)), jvars,
                             [JFeedSpec("tokens", (None,), "int32")],
                             config=JServingConfig(**cfg))
    try:
        assert engine.metrics.warmup_executables == 2 * len(engine.buckets.batch_buckets)
        sizes = engine.aot_cache_sizes()
        rng = np.random.RandomState(1)
        prompts = [rng.randint(1, LM["vocab"], size=(1, n)).astype(np.int32) for n in LENGTHS]
        got = [engine.submit({"tokens": p}) for p in prompts]
        ref = [jengine.submit({"tokens": p}) for p in prompts]
        for p, g, r in zip(prompts, got, ref):
            n = p.shape[1]
            out = g.result(timeout=WAIT_S)
            assert tuple(out.shape) == (1, 8 if n <= 8 else 16, LM["vocab"])
            np.testing.assert_allclose(out[:, :n].numpy(), np.asarray(r.result(timeout=WAIT_S))[:, :n],
                                       rtol=1e-5, atol=1e-5)
        assert engine.aot_cache_sizes() == sizes
        assert engine.metrics.snapshot()["mean_batch_occupancy"] >= 1.0
    finally:
        engine.close(timeout=WAIT_S)
        jengine.close(timeout=WAIT_S)


@pytest.fixture
def both_flash():
    from paddle_tpu.core import config as jconfig
    from paddle_tpu_torch.core import config as tconfig

    saved = (jconfig.flags().use_flash_attention, tconfig.flags().use_flash_attention)
    jconfig.set_flags(use_flash_attention=True)
    tconfig.set_flags(use_flash_attention=True)
    yield
    jconfig.set_flags(use_flash_attention=saved[0])
    tconfig.set_flags(use_flash_attention=saved[1])


# ---- host logic: buckets, batcher, metrics, token bucket -------------------


@pytest.mark.parametrize("length_buckets,max_batch,batch_buckets", [
    ((4, 16), 8, None), ((8, 32, 128), 6, None), ((5,), 8, (2, 8)),
])
def test_shape_buckets_match_jax(length_buckets, max_batch, batch_buckets):
    specs = [("x", (None, 4)), ("y", (3,)), ("z", (None, None))]
    b = ShapeBuckets([FeedSpec(n, s) for n, s in specs], max_batch,
                     batch_buckets=batch_buckets, length_buckets=length_buckets)
    j = JShapeBuckets([JFeedSpec(n, s) for n, s in specs], max_batch,
                      batch_buckets=batch_buckets, length_buckets=length_buckets)
    assert b.batch_buckets == j.batch_buckets
    assert b.all_signatures() == j.all_signatures()
    for rows in range(1, max_batch + 1):
        assert b.batch_bucket(rows) == j.batch_bucket(rows)
    rng = np.random.RandomState(0)
    for _ in range(5):
        t, u = (int(rng.randint(1, length_buckets[-1] + 1)) for _ in range(2))
        shapes = [(t, 4), (3,), (u, t)]
        sig = b.signature(shapes)
        assert sig == j.signature(shapes)
        arrs = [rng.randn(2, *s).astype(np.float32) for s in shapes]
        for mine, theirs in zip(ShapeBuckets.pad_rows(b.pad_to_signature(arrs, sig), max_batch),
                                JShapeBuckets.pad_rows(j.pad_to_signature(arrs, sig), max_batch)):
            np.testing.assert_array_equal(mine, theirs)
    with pytest.raises(EnforceError):
        b.signature([(3, 5), (3,), (1, 1)])  # fixed dim mismatch
    with pytest.raises(EnforceError):
        ShapeBuckets([FeedSpec("x", (None,))], 4)  # ragged without buckets


class _Req:
    def __init__(self, sig, n, deadline=None):
        self.sig, self.n, self.deadline = sig, n, deadline


def _scripted_groups(batcher_cls, channel_mod):
    """The micro-batcher on a scripted arrival sequence under a fake clock:
    the groups it flushes, in order, as (sig, rows, [request ns])."""
    now, flushed, expired = [0.0], [], []
    q = channel_mod.Channel(capacity=16)
    mb = batcher_cls(q, max_batch_rows=4, max_delay_s=1.0,
                     flush=lambda g: flushed.append((g.sig, g.rows, [r.n for r in g.requests])),
                     on_expired=expired.append, clock=lambda: now[0])
    t = channel_mod.go(mb.run)

    def wait_for(k):
        deadline = time.monotonic() + WAIT_S
        while len(flushed) < k and time.monotonic() < deadline:
            time.sleep(0.001)

    q.send(_Req("A", 2))
    q.send(_Req("A", 2))  # size-triggered flush
    wait_for(1)
    q.send(_Req("A", 1))
    q.send(_Req("B", 1))
    q.send(_Req("D", 1, deadline=-1.0))  # expired before grouping
    time.sleep(0.05)
    now[0] = 2.0  # past the delay: A and B age out on the next wake-up
    q.send(_Req("B", 1))
    wait_for(3)
    q.send(_Req("C", 3))
    q.send(_Req("C", 2))  # overflow splits
    wait_for(4)
    q.close()  # drains the leftover C(2)
    t.join(timeout=WAIT_S)
    assert not t.is_alive()
    return flushed[:1] + sorted(flushed[1:3]) + flushed[3:], [r.sig for r in expired]


def test_micro_batcher_forms_the_jax_groups():
    got = _scripted_groups(MicroBatcher, cc)
    assert got == _scripted_groups(JMicroBatcher, jcc)
    assert got[0] == [("A", 4, [2, 2]), ("A", 1, [1]), ("B", 2, [1, 1]), ("C", 3, [3]),
                      ("C", 2, [2])]
    assert got[1] == ["D"]


def test_serving_metrics_percentiles_and_registry():
    m, j = ServingMetrics(), JServingMetrics()
    for ms in range(1, 101):
        m.record_response(ms / 1e3)
        j.record_response(ms / 1e3)
    m.record_batch(3, 4, ((5,),))
    j.record_batch(3, 4, ((5,),))
    snap, jsnap = m.snapshot(), j.snapshot()
    assert snap.keys() == jsnap.keys()
    assert {k: v for k, v in snap.items() if k != "engine"} == \
        {k: v for k, v in jsnap.items() if k != "engine"}
    assert snap["p50_ms"] == pytest.approx(50.0) and snap["p99_ms"] == pytest.approx(99.0)
    assert snap["engine"].startswith("serving")
    assert prof.counters()["serving.responses_total"] >= 100
    assert m.latency_quantile(0.5) == pytest.approx(j.latency_quantile(0.5))


def test_token_bucket_and_histogram_merge_match_jax():
    now = [0.0]
    tb = TokenBucket(rate_per_s=1.0, burst=2.0, clock=lambda: now[0])
    jtb = JTokenBucket(rate_per_s=1.0, burst=2.0, clock=lambda: now[0])
    seq = []
    for t in (0.0, 0.0, 0.0, 0.5, 1.0, 1.2, 3.0, 3.0, 3.0, 100.0):
        now[0] = t
        seq.append((tb.try_take(), jtb.try_take(), tb.available(), jtb.available()))
    assert all(a == b and c == pytest.approx(d) for a, b, c, d in seq)
    assert [s[0] for s in seq[:3]] == [True, True, False]
    a = {"edges": [1.0, 2.0], "cumulative": [1, 3], "sum": 4.0, "count": 3}
    b = {"edges": [1.0, 2.0], "cumulative": [2, 2], "sum": 2.0, "count": 2}
    snaps = [a, None, b, {"edges": [1.0], "cumulative": [0], "sum": 0.0, "count": 0}]
    assert merge_histogram_snapshots(snaps) == jmerge(snaps) == {
        "edges": [1.0, 2.0], "cumulative": [3, 5], "sum": 6.0, "count": 5}
    assert merge_histogram_snapshots([None, None]) is None
    with pytest.raises(EnforceError):
        merge_histogram_snapshots([a, {"edges": [9.0], "cumulative": [1], "sum": 1.0,
                                       "count": 1}])


def test_inferencer_matches_jax_inferencer(param_dir):
    feed = np.random.RandomState(3).randn(3, D_IN).astype(np.float32)
    inf = pt.Inferencer(_tnet, param_dir, place="cpu", feed_order=["x"])
    jinf = jpt.Inferencer(_jnet, param_dir, feed_order=["x"])
    out = inf.infer({"x": feed})
    np.testing.assert_allclose(out.numpy(), np.asarray(jinf.infer({"x": feed})),
                               rtol=RTOL, atol=ATOL)
    # the prepared-function cache: one entry, however often infer runs
    inf.infer([feed])
    assert len(inf.executor._cache) == 1
    with pytest.raises(EnforceError):
        inf.infer({"y": feed})
    from_factory = pt.Inferencer(lambda: pt.build(_tnet), param_dir, place="cpu")
    np.testing.assert_array_equal(from_factory.infer([feed]).numpy(), out.numpy())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pt.Inferencer(_tnet, param_dir)  # the card by default
