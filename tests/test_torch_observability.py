"""The port's observability stack (``paddle_tpu_torch.observability`` and
``core.profiler``) against the JAX package's, on the CPU.

- ``core.profiler`` writes through the typed labeled registry, as the JAX
  package's does: after ``inc_counter("x", labels={"engine": "a"})`` the
  default registry holds the ``x{engine="a"}`` child in both.
- The same registry writes render byte-equal ``/metrics`` text, labeled
  children, histograms and special values included, and each package's
  strict parser reads the other's text.
- Goodput and MFU arithmetic are the same; the exporter serves every
  endpoint (``/fleet`` and ``/trace/<id>`` answer 404 with no fleet view
  installed and no span of the id);
  the run log gains trace ids inside spans; the flight recorder writes and
  prunes bundles; the profiler's host spans and ``torch.profiler`` trace
  land in ``log_dir``.
"""

import json
import math
import os
import urllib.error
import urllib.request

import pytest
import torch

from paddle_tpu.core import profiler as jprof
from paddle_tpu.observability import exporter as jexporter
from paddle_tpu.observability import metrics as jmetrics
from paddle_tpu.observability import mfu as jmfu
from paddle_tpu_torch import observability as obs
from paddle_tpu_torch import tracing
from paddle_tpu_torch.core import profiler as prof
from paddle_tpu_torch.observability import exporter as texporter
from paddle_tpu_torch.observability import flight_recorder as fr
from paddle_tpu_torch.observability import metrics as tmetrics
from paddle_tpu_torch.observability import mfu as tmfu
from paddle_tpu_torch.observability import runlog


def _both(fn):
    return fn(jprof, jmetrics), fn(prof, tmetrics)


def test_profiler_writes_keep_their_labels():
    def write(p, m):
        p.reset_metrics()
        p.inc_counter("x", labels={"engine": "a"})
        p.inc_counter("x", 2, labels={"engine": "b"})
        p.set_gauge("g", 3.0, labels={"device": "cuda:0"})
        return ([(f.name, f.samples) for f in m.default_registry().collect()
                 if f.name in ("x", "g")],
                {k: v for k, v in p.counters().items() if k == "x"},
                {k: v for k, v in p.gauges().items() if k == "g"})

    j, t = _both(write)
    assert t == j
    assert t[0][1] == ("x", [((("engine", "a"),), 1.0), ((("engine", "b"),), 2.0)])
    assert t[0][0] == ("g", [((("device", "cuda:0"),), 3.0)])
    assert t[1] == {"x": 3.0}


def _writes(registry):
    registry.histogram("serve.latency_seconds", "request latency",
                       buckets=registry_buckets(registry))
    for v in (0.003, 0.02, 0.02, 0.7, 12.0):
        registry.observe("serve.latency_seconds", v, labels={"cls": "interactive"})
    registry.observe("serve.latency_seconds", 0.5, labels={"cls": "batch"})
    registry.observe("trainer.step_seconds", 0.041)
    registry.inc("serving.requests_total", 3, labels={"engine": "e0", "tenant": 'q"uote'})
    registry.inc("serving.requests_total", 1, labels={"engine": "e1", "tenant": "back\\slash"})
    registry.set("trainer.mfu", 0.0412345678901)
    registry.set("device.hbm.bytes_limit", 85520809984, labels={"device": "cuda:0"})
    registry.set("odd.values", math.inf, labels={"k": "inf"})
    registry.set("odd.values", -math.inf, labels={"k": "-inf"})
    registry.set("odd.values", math.nan, labels={"k": "nan"})
    registry.counter("declared.only_total", "declared, never written")


def registry_buckets(registry):
    mod = jmetrics if isinstance(registry, jmetrics.MetricRegistry) else tmetrics
    return mod.exponential_buckets(0.001, 4.0, 6)


def test_same_writes_render_byte_equal_metrics():
    jreg, treg = jmetrics.MetricRegistry(), tmetrics.MetricRegistry()
    _writes(jreg)
    _writes(treg)
    jtext, ttext = jexporter.render_text(jreg), texporter.render_text(treg)
    assert ttext == jtext
    assert 'serving_requests_total{engine="e0",tenant="q\\"uote"} 3' in ttext
    assert jexporter.parse_text_exposition(ttext).keys() == \
        texporter.parse_text_exposition(jtext).keys()
    with pytest.raises(texporter.ExpositionError):
        texporter.parse_text_exposition("orphan_sample 1\n")


def test_histograms_flat_view_keeps_extremes():
    prof.reset_metrics()
    for v in (0.2, 0.05, 0.9):
        prof.observe("checkpoint.save_seconds", v, labels={"kind": "sync"})
    h = prof.histograms()["checkpoint.save_seconds"]
    assert h["count"] == 3 and h["min"] == 0.05 and h["max"] == 0.9
    assert abs(h["sum"] - 1.15) < 1e-12


def test_goodput_and_mfu_arithmetic_match():
    trackers = [jmfu.GoodputTracker(), tmfu.GoodputTracker()]
    for tr in trackers:
        tr.record_good(1.5)
        tr.record_bad(0.25, "nan_skip")
        tr.record_good(0.5)
        tr.record_bad(0.125, "stall")
        tr.record_bad(-1.0, "stall")  # clamped
    j, t = (tr.snapshot() for tr in trackers)
    assert t == j and t["goodput_frac"] == 2.0 / 2.375
    assert trackers[1].badput_by_category() == {"nan_skip": 0.25, "stall": 0.125}
    assert tmfu.mfu(1.9e12, 0.04, peak_per_device=989.4e12) == \
        jmfu.mfu(1.9e12, 0.04, peak_per_device=989.4e12)


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=10) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def test_exporter_endpoints(tmp_path):
    obs.shutdown()
    srv = obs.setup(obs.ObservabilityConfig(metrics_port=0,
                                            runlog_path=str(tmp_path / "run.jsonl")))
    try:
        assert obs.setup(obs.ObservabilityConfig(metrics_port=0)) is srv  # idempotent
        prof.inc_counter("trainer.steps_total")
        runlog.emit("step", step=1)
        base = srv.url
        status, text = _get(base + "/metrics")
        assert status == 200 and "trainer_steps_total" in text
        texporter.parse_text_exposition(text)
        for path in ("/healthz", "/runlog/tail?n=5", "/trace", "/roofline", "/alerts",
                     "/slo", "/tenants", "/locks"):
            status, body = _get(base + path)
            assert status == 200, path
            json.loads(body)
        assert json.loads(_get(base + "/runlog/tail?n=1")[1])[-1]["kind"] == "step"
        # no fleet view installed, no span of this trace id: both 404
        status, body = _get(base + "/fleet")
        assert status == 404 and json.loads(body) == {"error": "no fleet views installed"}
        status, body = _get(base + "/trace/" + "0" * 32)
        assert status == 404 and json.loads(body)["error"] == "unknown trace id"
        assert _get(base + "/trace/not-hex")[0] == 400
        assert _get(base + "/nope")[0] == 404
        assert _get(base + "/admission")[0] == 404  # the JAX exporter's /tenants only
    finally:
        obs.shutdown()
    assert obs.server() is None and runlog.get_runlog() is None


def test_runlog_events_carry_trace_ids_inside_spans(tmp_path):
    log = runlog.RunLog(str(tmp_path / "r.jsonl"))
    prev = runlog.set_runlog(log)
    try:
        with tracing.start_trace("trainer.step") as span:
            runlog.emit("nan_skip", step=3)
        runlog.emit("step", step=4)
    finally:
        runlog.set_runlog(prev)
        log.close()
    inside, outside = runlog.read_runlog(str(tmp_path / "r.jsonl"))
    assert inside["trace_id"] == span.context.trace_id and "trace_id" not in outside


def test_flight_recorder_bundles_and_prunes(tmp_path):
    rec = fr.install(fr.FlightRecorder(str(tmp_path), keep=2))
    try:
        with tracing.start_trace("serving.decode.request"):
            pass
        paths = [fr.maybe_dump(f"fault{i}") for i in range(3)]
    finally:
        fr.uninstall()
    assert fr.maybe_dump("after") is None
    assert rec.bundles() == paths[1:]
    bundle = json.load(open(paths[-1]))
    assert bundle["reason"] == "fault2" and bundle["spans"]
    assert {"locks", "roofline", "alerts", "runlog"} <= set(bundle)


def test_host_spans_and_profiler_trace(tmp_path):
    prof.enable_profiler()
    for _ in range(2):
        with prof.record_event("trainer.step_compute"):
            torch.ones(4) @ torch.ones(4)
    assert len(prof.spans()) == 2 and prof.step_breakdown().keys() == {"trainer.step_compute"}
    path = prof.export_chrome_trace(str(tmp_path / "host.json"))
    table = prof.disable_profiler()
    assert table["trainer.step_compute"]["calls"] == 2 and prof.spans() == []
    assert "trainer.step_compute" in prof.summary_string(table)
    assert json.load(open(path))["traceEvents"][0]["name"] == "trainer.step_compute"

    log_dir = str(tmp_path / "trace")
    with prof.profiler(log_dir):
        with prof.record_event("probe.region"):
            torch.ones(8, 8) @ torch.ones(8, 8)
    names = {e.get("name") for e in json.load(open(os.path.join(log_dir, "trace.chrome.json")))
             ["traceEvents"]}
    assert "probe.region" in names and any("mm" in str(n) for n in names)
    host = json.load(open(os.path.join(log_dir, "timeline.chrome.json")))["traceEvents"]
    assert [e["name"] for e in host if e["ph"] == "X"] == ["probe.region"]
    with pytest.raises(RuntimeError, match="no profiler session"):
        prof.stop_profiler()
