"""The port's host-side serving bookkeeping against the JAX package's
classes, driven through the same seeded operation sequences: the page
allocator, the paged KV cache's slot/page tables, the radix prefix cache
and the weighted-fair scheduler must return the same page ids, refcounts,
tables and dequeue order. Also the copied jax-free modules the engine
leans on: the metric registry's histograms and quantiles, the token
waterfall, and the Go-style channel."""

import torch_threads  # noqa: F401  (first: its share of the cores)
import threading
import types

import numpy as np
import pytest

from paddle_tpu import concurrency as jconc
from paddle_tpu.observability import metrics as jmetrics
from paddle_tpu.serving import admission as jadm
from paddle_tpu.serving import kv_cache as jkv
from paddle_tpu.serving import prefix_cache as jpc
from paddle_tpu.serving import scheduler as jsched
from paddle_tpu.tracing import waterfall as jwf
from paddle_tpu_torch import concurrency as tconc
from paddle_tpu_torch.observability import metrics as tmetrics
from paddle_tpu_torch.serving import admission as tadm
from paddle_tpu_torch.serving import kv_cache as tkv
from paddle_tpu_torch.serving import prefix_cache as tpc
from paddle_tpu_torch.serving import scheduler as tsched
from paddle_tpu_torch.tracing import waterfall as twf


def _same(a, b):
    """Run the same call on both packages' objects: equal results, or the
    same exception type."""
    out = []
    for obj in (a, b):
        try:
            out.append(("ok", obj()))
        except Exception as e:  # both must refuse alike
            out.append(("err", type(e).__name__))
    assert out[0] == out[1], out
    return out[0][1]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_page_allocator_matches_jax(seed):
    rng = np.random.RandomState(seed)
    ja, ta = jkv.PageAllocator(12), tkv.PageAllocator(12)
    held = []
    for _ in range(200):
        op = rng.randint(4)
        if op == 0:
            n = int(rng.randint(0, 5))
            got = _same(lambda: ja.alloc(n), lambda: ta.alloc(n))
            if got:
                held.extend(got)
        elif op == 1 and held:
            k = int(rng.randint(1, len(held) + 1))
            pages = [held.pop(int(rng.randint(len(held)))) for _ in range(k)]
            _same(lambda: ja.free(pages), lambda: ta.free(pages))
        elif op == 2 and held:
            page = held[int(rng.randint(len(held)))]
            _same(lambda: ja.ref([page]), lambda: ta.ref([page]))
            held.append(page)
        else:  # refused operations: double free, scratch, out of range
            bad = int(rng.choice([0, 12, 3]))
            if bad not in held:
                _same(lambda: ja.free([bad]), lambda: ta.free([bad]))
        assert ja.refcounts() == ta.refcounts()
        assert (ja.num_free, ja.in_use) == (ta.num_free, ta.in_use)
    ja.free(held)
    ta.free(held)
    ja.assert_empty()
    ta.assert_empty()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_paged_kv_cache_matches_jax(seed):
    rng = np.random.RandomState(seed)
    geo = dict(max_slots=3, page_size=4, num_pages=12, pages_per_slot=5)
    jc, tc = jkv.PagedKVCache(**geo), tkv.PagedKVCache(**geo)
    assert jc.geometry() == tc.geometry()
    spare = []  # pages held outside the slots, adoptable as a "prefix"
    for _ in range(300):
        op = rng.randint(7)
        active = tc.active_slots()
        if op == 0:
            _same(jc.acquire_slot, tc.acquire_slot)
        elif op == 1 and active:
            s, n = int(rng.choice(active)), int(rng.randint(0, 21))
            _same(lambda: jc.ensure_capacity(s, n), lambda: tc.ensure_capacity(s, n))
        elif op == 2 and active:
            s, n = int(rng.choice(active)), int(rng.randint(0, 21))
            _same(lambda: jc.trim(s, n), lambda: tc.trim(s, n))
        elif op == 3 and active:
            s = int(rng.choice(active))
            _same(lambda: jc.release_slot(s), lambda: tc.release_slot(s))
        elif op == 4 and active and spare:
            s = int(rng.choice(active))
            pages = spare[:int(rng.randint(1, len(spare) + 1))]
            _same(lambda: jc.adopt_pages(s, pages), lambda: tc.adopt_pages(s, pages))
        elif op == 5 and active:
            s = int(rng.choice(active))
            shared = tc.shared_indices(s)
            assert shared == jc.shared_indices(s)
            if shared:
                li = int(rng.choice(shared))
                _same(lambda: jc.private_copy(s, li), lambda: tc.private_copy(s, li))
        elif op == 6:
            if spare and rng.rand() < 0.5:
                p = spare.pop()
                jc.allocator.free([p])
                tc.allocator.free([p])
            else:
                got = _same(lambda: jc.allocator.alloc(1), lambda: tc.allocator.alloc(1))
                spare.extend(got or [])
        np.testing.assert_array_equal(jc.page_tables, tc.page_tables)
        np.testing.assert_array_equal(jc.seq_lens, tc.seq_lens)
        assert jc.allocator.refcounts() == tc.allocator.refcounts()
        for s in range(3):
            assert jc.slot_pages(s) == tc.slot_pages(s)
    _same(jc.release_all, tc.release_all)
    jc.allocator.free(spare)
    tc.allocator.free(spare)
    jc.assert_no_leaks()
    tc.assert_no_leaks()


@pytest.mark.parametrize("seed", [0, 1])
def test_radix_prefix_cache_matches_jax(seed):
    rng = np.random.RandomState(seed)
    ps = 4
    ja, ta = jkv.PageAllocator(40), tkv.PageAllocator(40)
    jr, tr = jpc.RadixPrefixCache(ja, ps, max_pages=12), tpc.RadixPrefixCache(ta, ps, max_pages=12)
    # prompts over a tiny alphabet share prefixes often
    prompts = [rng.randint(1, 3, size=(int(rng.randint(4, 20)),)) for _ in range(12)]
    for _ in range(150):
        op = rng.randint(4)
        toks = prompts[int(rng.randint(len(prompts)))]
        if op == 0:
            n = len(toks) // ps
            got = _same(lambda: ja.alloc(n), lambda: ta.alloc(n))
            if got is not None:
                _same(lambda: jr.insert(toks, got), lambda: tr.insert(toks, got))
                ja.free(got)  # the tree's refs keep what it took
                ta.free(got)
        elif op == 1:
            cap = int(rng.randint(0, 5)) or None
            _same(lambda: jr.match(toks, cap), lambda: tr.match(toks, cap))
        elif op == 2:
            _same(lambda: jr.peek(toks), lambda: tr.peek(toks))
        else:
            n = int(rng.randint(0, 3))
            _same(lambda: jr.evict(n), lambda: tr.evict(n))
        assert jr.stats() == tr.stats()
        assert jr.digests() == tr.digests() and jr.digest_version == tr.digest_version
        assert ja.refcounts() == ta.refcounts()
    _same(jr.clear, tr.clear)
    ja.assert_empty()
    ta.assert_empty()


def _tenants(adm):
    return {
        "a": adm.TenantConfig("a", weight=3.0, queue_capacity=50).resolved(),
        "b": adm.TenantConfig("b", weight=1.0, queue_capacity=50).resolved(),
        "c": adm.TenantConfig("c", weight=2.0, queue_capacity=50, byte_quota=4000).resolved(),
    }


def _scheduler(mod, adm):
    return mod.WeightedFairScheduler(_tenants(adm), quantum_rows=16, batch_min_share=0.25)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_weighted_fair_scheduler_dequeue_order_matches_jax(seed):
    rng = np.random.RandomState(seed)
    js, ts = _scheduler(jsched, jadm), _scheduler(tsched, tadm)
    rid = 0
    order_j, order_t = [], []
    for _ in range(120):
        if rng.rand() < 0.6:
            req = types.SimpleNamespace(
                rid=rid, tenant=str(rng.choice(["a", "b", "c"])),
                cls=str(rng.choice(tsched.CLASSES)), n=int(rng.randint(1, 40)),
                deadline=None, bytes=int(rng.randint(0, 900)))
            rid += 1
            _same(lambda: js.try_put(req), lambda: ts.try_put(req))
        else:
            for sched, order in ((js, order_j), (ts, order_t)):
                try:
                    order.append(sched.recv(timeout=0)[0].rid)
                except TimeoutError:
                    order.append(None)
        assert js.depths() == ts.depths() and js.qsize() == ts.qsize()
    js.close()
    ts.close()
    for sched, order in ((js, order_j), (ts, order_t)):
        order.extend(r.rid for r in sched)
    assert order_t == order_j
    assert tsched.CLASSES == jsched.CLASSES


def test_admission_rejections_match_jax():
    """Quota and unknown-tenant sheds, typed alike."""
    out = []
    for mod, adm in ((jsched, jadm), (tsched, tadm)):
        sched = _scheduler(mod, adm)
        metrics = types.SimpleNamespace(
            engine_label="e", record_admit=lambda *a: None, record_shed=lambda *a: None,
            set_brownout_level=lambda *a: None)
        ctl = adm.AdmissionController(sched, metrics, _tenants(adm), request_cost=lambda r: 5.0)
        reasons = []
        for i in range(60):
            req = types.SimpleNamespace(tenant=["a", "c", "zz"][i % 3], cls="batch", n=1,
                                        deadline=None if i % 2 else 1e18, bytes=300)
            try:
                ctl.admit(req)
                reasons.append(None)
            except adm.AdmissionRejected as e:
                reasons.append(e.reason)
        ctl.enter_brownout("critical", "test")
        try:
            ctl.admit(types.SimpleNamespace(tenant="a", cls="interactive", n=1, deadline=None,
                                            bytes=1))
        except adm.AdmissionRejected as e:
            reasons.append(e.reason)
        out.append(reasons)
    assert out[0] == out[1]
    assert {"unknown_tenant", "byte_quota", "brownout"} <= set(out[1])


def test_metric_registry_histogram_quantiles_match_jax():
    rng = np.random.RandomState(0)
    edges = tmetrics.exponential_buckets(0.001, 2.0, 10)
    assert edges == jmetrics.exponential_buckets(0.001, 2.0, 10)
    assert tmetrics.linear_buckets(0.1, 0.1, 10) == jmetrics.linear_buckets(0.1, 0.1, 10)
    jr, tr = jmetrics.MetricRegistry(), tmetrics.MetricRegistry()
    for r in (jr, tr):
        r.histogram("serving.decode.ttft_seconds", buckets=edges)
    for v in rng.exponential(0.05, size=500):
        for r in (jr, tr):
            r.observe("serving.decode.ttft_seconds", float(v), labels={"engine": "e"})
            r.inc("serving.decode.tokens_total", 2, labels={"engine": "e"})
    for q in (0.5, 0.9, 0.99):
        assert tr.quantile("serving.decode.ttft_seconds", q, {"engine": "e"}) == jr.quantile(
            "serving.decode.ttft_seconds", q, {"engine": "e"})
    assert tr.flat_counters() == jr.flat_counters()
    assert tr.histogram_snapshot("serving.decode.ttft_seconds", {"engine": "e"}) == \
        jr.histogram_snapshot("serving.decode.ttft_seconds", {"engine": "e"})
    with pytest.raises(Exception):
        tr.set("serving.decode.tokens_total", 1.0, labels={"engine": "e"})  # a counter


def test_waterfall_books_ttft_and_speculative_tpot_like_jax():
    out = []
    for wf in (jwf, twf):
        wf.reset()
        wf.start("r1", 10.0, engine="e", cls="interactive")
        booked = [wf.on_tokens("r1", 10.5, 1, "prefill"), wf.on_tokens("r1", 10.9, 4, "verify"),
                  wf.on_tokens("r1", 11.0, 1, "decode")]
        wf.finish("r1", 11.1, "length")
        booked.append(wf.on_tokens("r1", 12.0, 1))  # finished: refused
        out.append((booked, wf.doc("r1"), wf.rids(finished_only=True)))
        wf.reset()
    assert out[0] == out[1]
    booked, doc, _ = out[1]
    assert booked[0][0] == pytest.approx(0.5) and len(booked[1][1]) == 4
    assert doc["tokens"] == 6 and doc["reason"] == "length"


def test_channel_semantics_match_jax():
    for mod in (jconc, tconc):
        ch = mod.Channel(capacity=2)
        ch.send(1)
        ch.send(2)
        with pytest.raises(mod.ChannelFull):
            ch.try_send(3)
        got = []
        t = mod.go(lambda: got.extend(v for v in ch))
        ch.send(3, timeout=5)
        ch.close()
        t.join(5)
        assert not t.is_alive() and got == [1, 2, 3]
        assert ch.recv() == (None, False)
        with pytest.raises(mod.ChannelClosedError):
            ch.send(4)
    assert tconc.ChannelClosedError is not jconc.ChannelClosedError
    assert issubclass(tconc.ChannelClosedError, RuntimeError)


def test_scheduler_recv_times_out_and_poke_bounces():
    sched = _scheduler(tsched, tadm)
    with pytest.raises(TimeoutError):
        sched.recv(timeout=0.01)
    done = threading.Event()

    def waiter():
        try:
            sched.recv(timeout=30)
        except TimeoutError:
            done.set()

    t = threading.Thread(target=waiter, daemon=True)
    t.start()
    deadline = 50
    while not done.is_set() and deadline:
        sched.poke()
        done.wait(0.1)
        deadline -= 1
    t.join(5)
    assert done.is_set() and not t.is_alive()
