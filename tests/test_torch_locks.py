"""The port's lock-order graph (``paddle_tpu_torch.core.locks``) against the
JAX package's (``paddle_tpu.core.locks``): the same acquisition scripts give
the same order graph, the same cycles and the same diagnostics, exactly.
Then the checker over the port's own threaded code — the decode engine
(prefix cache, a starved pool, self-draft, a recovered step fault, kill
with a flight recorder), a Trainer with async sharded checkpoints, the
watchdog, the prefetcher, a watch and a scraped exporter — finds no
violation.

The checker is on under pytest in both packages (``PYTEST_CURRENT_TEST``);
each test resets both graphs first.
"""

import torch_threads  # noqa: F401  (first: its share of the cores)
import threading
import urllib.request

import numpy as np
import pytest
import torch

from paddle_tpu.core import locks as jlocks
from paddle_tpu.core import profiler as jprof
from paddle_tpu_torch.core import locks as tlocks
from paddle_tpu_torch.core import profiler as tprof

PACKAGES = [(jlocks, jprof), (tlocks, tprof)]


@pytest.fixture(autouse=True)
def _fresh_graphs():
    for lk, _ in PACKAGES:
        lk.set_enabled(None)
        lk.reset()
    yield
    for lk, _ in PACKAGES:
        lk.reset()


def _pair(lk):
    return lk.Lock("t.alpha"), lk.Lock("t.beta")


def _script_two_orders(lk):
    a, b = _pair(lk)
    with a:
        with b:
            pass
    with b:
        with a:
            pass


def _script_three_cycle(lk):
    a, b, c = lk.Lock("t.a"), lk.RLock("t.b"), lk.Lock("t.c")
    for first, second in ((a, b), (b, c), (c, a)):
        with first:
            with second:
                pass


def _script_two_threads(lk):
    a, b = _pair(lk)

    def one():
        with a, b:
            pass

    def two():
        with b, a:
            pass

    for fn in (one, two):  # sequential: the ordering, not the wedge
        t = threading.Thread(target=fn)
        t.start()
        t.join()


def _script_reentrant_and_condition(lk):
    r = lk.RLock("t.r")
    other = lk.Lock("t.other")
    cond = lk.Condition(r)
    with r:
        with r:
            with other:
                pass
        cond.wait(timeout=0.01)  # releases r while parked
    with other:
        pass


def _script_self_deadlock(lk):
    a = lk.Lock("t.self")
    with a:
        got = a.acquire(timeout=0.01)
    return got


SCRIPTS = [_script_two_orders, _script_three_cycle, _script_two_threads,
           _script_reentrant_and_condition, _script_self_deadlock]


def _ours(name):
    return name.startswith("t.")


def _run(lk, prof, script):
    """The script's graph, cycles and diagnostics: only its own locks
    (``t.*``), so a thread another test left running cannot add to them."""
    before = prof.counters().get("locks.order_violations_total", 0)
    lk.reset()
    assert lk.enabled()
    out = script(lk)
    violations = [v for v in lk.violations() if all(map(_ours, v["cycle"]))]
    return {
        "out": out,
        "graph": {src: {dst: n for dst, n in dsts.items() if _ours(dst)}
                  for src, dsts in lk.graph_snapshot().items() if _ours(src)},
        "cycles": [v["cycle"] for v in violations],
        "self": [bool(v.get("self_deadlock")) for v in violations],
        "diagnostics": [(d.code, d.where, d.severity) for d in lk.order_violations()
                        if d.where.startswith("t.")],
        "counted": prof.counters().get("locks.order_violations_total", 0) - before,
        "held_after": [r["lock"] for r in lk.held_snapshot() if _ours(r["lock"])],
    }


@pytest.mark.parametrize("script", SCRIPTS, ids=lambda f: f.__name__[len("_script_"):])
def test_same_scripts_give_same_graph_and_cycles(script):
    j = _run(jlocks, jprof, script)
    t = _run(tlocks, tprof, script)
    assert t == j
    if script in (_script_two_orders, _script_three_cycle, _script_two_threads):
        assert len(t["cycles"]) == 1 and t["cycles"][0][0] == t["cycles"][0][-1]
        with pytest.raises(AssertionError, match="lock-order violation"):
            tlocks.assert_no_violations()
    if script is _script_reentrant_and_condition:
        assert t["cycles"] == [] and t["graph"] == {"t.r": {"t.other": 1}}
    if script is _script_self_deadlock:
        assert t["out"] is False and t["self"] == [True]


def test_self_deadlock_raises_instead_of_hanging():
    for lk, _ in PACKAGES:
        a = lk.Lock("t.hang")
        with a:
            with pytest.raises(RuntimeError, match="self-deadlock"):
                a.acquire()


def test_disabled_checker_records_nothing():
    for lk, _ in PACKAGES:
        lk.set_enabled(False)
        try:
            _script_two_orders(lk)
            assert lk.graph_snapshot() == {} and lk.violations() == []
        finally:
            lk.set_enabled(None)


def test_held_registry_and_table():
    a = tlocks.Lock("t.held")
    with a:
        rows = [r for r in tlocks.held_snapshot() if r["lock"] == "t.held"]
        assert len(rows) == 1 and rows[0]["thread"] == threading.current_thread().name
        assert "t.held" in tlocks.render_held_table()
        assert tlocks.max_hold_seconds() >= 0.0
    assert not [r for r in tlocks.held_snapshot() if r["lock"] == "t.held"]


def test_port_threaded_code_has_no_order_violation(tmp_path):
    """The decode engine's loop, the async checkpoint writer, the watchdog,
    the prefetcher, a watch and the exporter under the checker."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import models as tmodels
    from paddle_tpu_torch import observability as obs
    from paddle_tpu_torch.observability import flight_recorder as fr
    from paddle_tpu_torch.resilience import ResilienceConfig, faults
    from paddle_tpu_torch.serving import DecodeConfig, DecodeEngine, ServingConfig, TenantConfig
    from paddle_tpu_torch.trainer import CheckpointConfig, Trainer
    from paddle_tpu_torch.watch import WatchConfig

    spec = tmodels.get_model("transformer_lm", device="cpu", seq_len=64, vocab=97, d_model=32,
                             d_inner=64, num_heads=4, n_layers=2)
    ids = torch.randint(1, 97, (2, 64), dtype=torch.int32, generator=torch.Generator().manual_seed(0))
    params = spec.model.init(0, ids, ids, device="cpu").params
    cfg = spec.extra["cfg"]
    prompt = np.arange(1, 10, dtype=np.int32)
    geometry = dict(max_slots=3, page_size=4, max_context=40, prefill_chunk=8)
    fr.install(fr.FlightRecorder(str(tmp_path / "flight")))
    try:
        for kw in (dict(prefix_cache=True), dict(num_pages=14)):
            eng = DecodeEngine(params, cfg, decode=DecodeConfig(**geometry, **kw), device="cpu",
                               config=ServingConfig(tenants=[TenantConfig("a"), TenantConfig("b")]))
            try:
                hs = [eng.submit(prompt, 12, tenant=t) for t in ("a", "b", "a")]
                assert all(len(h.result(timeout=60).tokens) == 12 for h in hs)
            finally:
                eng.close(timeout=30)
        eng = DecodeEngine(params, cfg, decode=DecodeConfig(**geometry, spec_tokens=2),
                           device="cpu", draft_variables=params, draft_cfg=cfg)
        with faults.injected(faults.FaultSpec(faults.DECODE_STEP, "error", after=2, times=1)):
            hs = [eng.submit(prompt, 12) for _ in range(3)]
            assert all(len(h.result(timeout=60).tokens) == 12 for h in hs)
        eng.kill()
    finally:
        fr.uninstall()

    def net(x, y):
        return torch.mean(pt.ops.nn.square_error_cost(pt.layers.fc(x, size=1), y))

    def reader():
        rng = np.random.RandomState(0)
        for _ in range(6):
            x = rng.randn(8, 4).astype(np.float32)
            yield x, 2 * x[:, :1]

    t = Trainer(lambda: net, lambda: pt.optimizer.SGD(learning_rate=0.1), place="cpu",
                checkpoint_config=CheckpointConfig(str(tmp_path / "ckpt"), step_interval=2,
                                                   sharded=True, async_save=True),
                resilience=ResilienceConfig(stall_timeout_s=30.0), prefetch=True,
                observability=obs.ObservabilityConfig(metrics_port=0,
                                                      runlog_path=str(tmp_path / "run.jsonl")),
                watch=WatchConfig(enabled=True))
    try:
        t.train(num_epochs=2, reader=reader)
        for endpoint in ("/metrics", "/locks", "/trace", "/roofline", "/alerts", "/slo"):
            urllib.request.urlopen(obs.server().url + endpoint, timeout=10).read()
    finally:
        t.stop()
        obs.shutdown()
    tlocks.assert_no_violations()
    graph = tlocks.graph_snapshot()
    assert "checkpoint.async_pending" in graph["checkpoint.save"]
    assert "observability.flight_recorder.dump" in graph
