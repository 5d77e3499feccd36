"""The port's watch layer (``paddle_tpu_torch.watch``) against the JAX
package's (``paddle_tpu.watch``): the same observation streams give the
same detector results, alerts, SLO statuses and burn rates, and straggler
flags, exactly.

Every stream is made from numpy seeds; SLO engines run on an injected
clock, so no test sleeps.
"""

import torch_threads  # noqa: F401  (first: its share of the cores)
import numpy as np
import pytest

from paddle_tpu.observability import metrics as jmetrics
from paddle_tpu.tracing import straggler as jstraggler
from paddle_tpu import watch as jwatch
from paddle_tpu_torch.observability import metrics as tmetrics
from paddle_tpu_torch.tracing import straggler as tstraggler
from paddle_tpu_torch import watch as twatch

PACKAGES = [(jwatch, jmetrics), (twatch, tmetrics)]


def _stream(seed, n=200, spikes=(50, 120, 121, 180)):
    rng = np.random.RandomState(seed)
    x = 0.04 + 0.002 * rng.randn(n)
    for i in spikes:
        x[i] *= 8.0
    return [float(v) for v in x]


def _results(det, stream, keys=("a", "b")):
    out = []
    observe = getattr(det, "observe", None) or det.record
    for i, v in enumerate(stream):
        r = observe(keys[i % len(keys)], v)
        out.append(None if r is None else r.as_dict())
    return out


def _skewed(seed, n=180):
    """Three replicas; the third turns 6x slower from observation 90 on."""
    stream = _stream(seed, n=n, spikes=())
    return [v * 6.0 if i >= 90 and i % 3 == 2 else v for i, v in enumerate(stream)]


@pytest.mark.parametrize("make, stream, keys", [
    (lambda w: w.EwmaDetector(alpha=0.25, z_threshold=6.0, min_samples=8), _stream(0), "ab"),
    (lambda w: w.EwmaDetector(alpha=0.1, z_threshold=3.0, min_samples=4), _stream(0), "ab"),
    (lambda w: w.RollingQuantileDetector(window=32, q=0.9, ratio=3.0, min_samples=8),
     _stream(0), "ab"),
    (lambda w: w.SkewDetector(ratio=2.5, window=16, min_samples=5), _skewed(0), "abc"),
], ids=["ewma", "ewma_tight", "quantile", "skew"])
def test_detectors_same_results(make, stream, keys):
    j, t = (_results(make(w), stream, keys) for w, _ in PACKAGES)
    assert t == j
    assert any(r and r["flagged"] for r in t)


def test_straggler_flags_match():
    stream = _stream(1, n=120, spikes=(30, 31, 90))
    flagged = []
    for mod, (_, metrics) in zip((jstraggler, tstraggler), PACKAGES):
        det = mod.StragglerDetector("trainer.step", ratio=2.5)
        flagged.append([det.record("step", v) for v in stream])
        flagged[-1].append(det.snapshot())
    assert flagged[1] == flagged[0]
    assert sum(flagged[1][:-1]) >= 2


class _Clock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t


def _slo_run(w, m):
    reg = m.MetricRegistry()
    hub = w.AlertHub(capacity=64)
    clock = _Clock()
    eng = w.SloEngine(registry=reg, hub=hub, clock=clock, min_interval_s=0.0)
    eng.add(w.SLO("lat", w.slo.LATENCY, "serve.latency_seconds", 0.1, window_s=60.0, quantile=0.9))
    eng.add(w.SLO("err", w.slo.ERROR_RATE, "serve.errors_total", 0.05, window_s=60.0,
                  total_metric="serve.requests_total"))
    eng.add(w.SLO("mfu", w.slo.GAUGE_BOUND, "trainer.mfu", 0.3, window_s=60.0, bound="min"))
    for name in w.slo.decode_token_slos("decode0", window_s=30.0):
        eng.add(name)
    rng = np.random.RandomState(3)
    statuses = []
    for i in range(120):
        clock.t += 0.5
        bad_phase = 40 <= i < 80
        reg.observe("serve.latency_seconds",
                    float((0.3 if bad_phase else 0.02) * (1 + 0.1 * rng.rand())))
        reg.inc("serve.requests_total")
        if bad_phase and i % 3 == 0:
            reg.inc("serve.errors_total")
        reg.set("trainer.mfu", 0.2 if bad_phase else 0.45)
        labels = {"engine": "decode0", "cls": "default"}
        reg.observe("serving.decode.ttft_seconds", 2.0 if bad_phase else 0.2, labels=labels)
        reg.observe("serving.decode.tpot_seconds", 0.01, labels=labels)
        statuses.append(eng.tick())
    return statuses, [a.as_dict() for a in hub.alerts()]


def _without_ts(alerts):
    return [{k: v for k, v in a.items() if k != "ts"} for a in alerts]


def test_slo_burn_rates_and_alerts_match():
    (js, ja), (ts, ta) = (_slo_run(w, m) for w, m in PACKAGES)
    assert ts == js
    assert _without_ts(ta) == _without_ts(ja)
    assert {a["source"] for a in ta} == {"slo.lat", "slo.err", "slo.mfu",
                                         "slo.decode_decode0_default_ttft_p99"}
    assert any(s["burn_rate"] and s["burn_rate"] > 1 for s in ts[79])
    assert [s.name for s in twatch.slo.disagg_slos(["d0", "d1"])] == \
        [s.name for s in jwatch.slo.disagg_slos(["d0", "d1"])]


def _watcher_run(w, m):
    reg = m.MetricRegistry()
    hub = w.AlertHub(capacity=64)
    watcher = w.MetricWatcher(registry=reg, hub=hub, rules=[
        w.WatchRule("trainer.step_seconds", w.EwmaDetector(alpha=0.25, z_threshold=6.0,
                                                           min_samples=8)),
        w.WatchRule("trainer.mfu", w.EwmaDetector(alpha=0.25, z_threshold=4.0, min_samples=8),
                    invert=True),
    ]).start()
    try:
        for i, v in enumerate(_stream(4, n=80, spikes=(40,))):
            reg.observe("trainer.step_seconds", v)
            reg.set("trainer.mfu", 0.05 if i == 60 else 0.4 + 0.001 * (i % 5))
    finally:
        watcher.close()
    return _without_ts([a.as_dict() for a in hub.alerts()])


def test_watcher_alerts_match():
    j, t = (_watcher_run(w, m) for w, m in PACKAGES)
    assert t == j
    assert {a["source"] for a in t} == {"watch.trainer.step_seconds", "watch.trainer.mfu"}


def test_build_from_config_and_default_rules():
    cfg = twatch.WatchConfig(enabled=True)
    watcher = twatch.build(cfg)
    try:
        assert [r.metric for r in watcher.rules] == \
            [r.metric for r in jwatch.default_rules()]
    finally:
        watcher.close()
    assert twatch.build(twatch.WatchConfig()) is None


def test_baseline_store_verdicts_match(tmp_path):
    out = []
    for w, _ in PACKAGES:
        store = w.BaselineStore()
        for v in (100.0, 101.0, 99.5, 100.4, 100.2):
            store.update("lm_tokens_per_sec", v, device_kind="h100")
            store.update("step_ms", 40.0 + v / 100, device_kind="h100")
        out.append([store.check("lm_tokens_per_sec", 60.0, device_kind="h100"),
                    store.check("step_ms", 41.0, device_kind="h100"),
                    store.check("new_metric", 1.0)])
    assert out[1] == out[0]
    assert [c["verdict"] for c in out[1]] == ["regression", "ok", "new"]
