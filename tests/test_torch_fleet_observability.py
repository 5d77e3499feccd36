"""The port's fleet rollup (``paddle_tpu_torch.observability.fleet``) and
the exporter's ``/fleet`` and ``/trace/<trace_id>`` against the JAX
package's, on the CPU.

- ``FleetView.rollup`` over the same stub fleet gives the JAX package's
  dict, keys and numbers, and publishes the same ``serving.fleet.*``
  gauges; ``doc`` and ``trace_doc`` carry the JAX package's keys.
- A live ``DisaggRouter`` of the tiny LM of ``tests/torch_fleet_lm.py``:
  the view's handoff count equals the requests, ``/fleet`` serves it, and
  ``/trace/<id>`` returns each request's spans from both engines, valid
  as one multi-engine trace.
- A flight-recorder bundle of an engine with a host tier carries the
  tier's stats, as the JAX package's does.
"""

import torch_threads  # noqa: F401  (first: its share of the cores)
import json
import types
import urllib.error
import urllib.request

import pytest

import torch_fleet_lm as flm
from paddle_tpu import tracing as jtracing
from paddle_tpu.observability import fleet as jfleet
from paddle_tpu_torch import tracing
from paddle_tpu_torch.observability import fleet as obs_fleet
from paddle_tpu_torch.observability import flight_recorder
from paddle_tpu_torch.observability import metrics as obs_metrics
from paddle_tpu_torch.observability.exporter import MetricsServer
from paddle_tpu_torch.serving import DisaggRouter, HostPagePool
from paddle_tpu_torch.serving.disagg import DECODE, PREFILL


@pytest.fixture(scope="module")
def lm():
    return flm.tiny_lm()


class _StubBreaker:
    def __init__(self, state):
        self._state = state

    def snapshot(self):
        return {"state": self._state, "consecutive_failures": 0, "trips_total": 0,
                "recoveries_total": 0, "retry_in_s": 0.0}


class _StubEngine:
    closed = False

    def __init__(self, label, snap, state="closed"):
        self.metrics = types.SimpleNamespace(engine_label=label, snapshot=lambda s=snap: dict(s))
        self.breaker = _StubBreaker(state)

    def load(self):
        return 0.25


class _StubFleet:
    def __init__(self, engines):
        self.engines = engines

    def snapshot(self):
        return {"engines": [{"engine": e.metrics.engine_label} for e in self.engines],
                "rescued_total": 3, "rescue_failed_total": 1}


def _stub_fleet(prefix):
    snap = dict(prompt_tokens_total=100, prefix_hit_tokens_total=30, requests_total=10,
                host_tier_hits_total=4, host_promoted_pages_total=5, handoffs_in_total=2,
                migrated_total=1, step_faults_total=0)
    return _StubFleet([_StubEngine(prefix + "a", snap),
                       _StubEngine(prefix + "b", dict(snap, prefix_hit_tokens_total=20,
                                                      host_tier_hits_total=6,
                                                      step_faults_total=2), state="open")])


def test_rollup_equals_jax():
    scaler = types.SimpleNamespace(actions_total={"scale_decode": 2})
    mine = obs_fleet.FleetView(_stub_fleet("t"), name="t-fleet", autoscaler=scaler).rollup()
    theirs = jfleet.FleetView(_stub_fleet("j"), name="j-fleet", autoscaler=scaler).rollup()
    assert mine == theirs
    assert mine["engines"] == 2 and mine["engines_healthy"] == 1
    assert mine["prefix_hit_frac"] == 50 / 200 and mine["host_tier_promote_rate"] == 1.0
    reg = obs_metrics.default_registry()
    labels = {"fleet": "t-fleet"}
    assert reg.get("serving.fleet.engines_healthy", labels) == 1.0
    assert reg.get("serving.fleet.breaker_open", {"fleet": "t-fleet", "engine": "tb"}) == 1.0
    assert reg.get("serving.fleet.autoscaler_actions",
                   {"fleet": "t-fleet", "action": "scale_decode"}) == 2.0


def test_rollup_zero_denominators():
    roll = obs_fleet.FleetView(_StubFleet([_StubEngine("z", {})]), name="zero").rollup()
    assert roll["prefix_hit_frac"] == roll["host_tier_hit_rate"] == 0.0
    assert roll["host_tier_promote_rate"] == 0.0


def test_fleet_view_requires_engines_and_installs_once():
    with pytest.raises(Exception):
        obs_fleet.FleetView(object())
    view = obs_fleet.FleetView(_stub_fleet("i"), name="once")
    obs_fleet.install(view)
    obs_fleet.install(view)
    try:
        assert obs_fleet.installed_views().count(view) == 1
    finally:
        obs_fleet.uninstall(view)
    assert view not in obs_fleet.installed_views()


def _cross_engine_trace(tr):
    """A root on engine "b" with a prefill child that ran on engine "a"
    before the root's interval opened (a handoff's shape)."""
    root = tr.SpanContext.new_trace()
    tr.record_span("serving.decode.prefill", 1.0, 1.1, parent=root, engine="a")
    tr.record_span("serving.decode.request", 1.2, 1.5, context=root, engine="b")
    return root


def test_trace_doc_keys_equal_jax():
    mine = obs_fleet.trace_doc(_cross_engine_trace(tracing).trace_id)
    theirs = jfleet.trace_doc(_cross_engine_trace(jtracing).trace_id)
    assert set(mine) == set(theirs)
    assert set(mine["spans"][0]) == set(theirs["spans"][0])
    assert mine["engines"] == theirs["engines"] == ["a", "b"]
    assert mine["problems"] == theirs["problems"] == []
    assert [s["name"] for s in mine["spans"]] == [s["name"] for s in theirs["spans"]]
    assert obs_fleet.trace_doc("f" * 32)["problems"] == ["trace has no spans"]


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=10) as resp:
            return resp.status, json.loads(resp.read().decode("utf-8"))
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read().decode("utf-8"))


def test_fleet_and_trace_endpoints_on_a_live_router(lm):
    pre, dec = flm.port_engine(lm), flm.port_engine(lm)
    router = DisaggRouter([pre, dec], [PREFILL, DECODE], transport="device")
    view = obs_fleet.FleetView(router, name="live")
    srv = MetricsServer(port=0).start()
    try:
        handles = [router.submit(p, n) for p, n, _ in lm.mixed]
        assert flm.tokens(handles) == flm.refs(lm.mixed)
        assert _get(srv.url + "/fleet")[0] == 404  # nothing installed yet
        obs_fleet.install(view)
        status, doc = _get(srv.url + "/fleet")
        assert status == 200
        (mine,) = [d for d in doc if d["fleet"] == "live"]
        stub_doc = jfleet.FleetView(_stub_fleet("k"), name="keys").doc()
        assert set(mine) == set(stub_doc)
        assert mine["rollup"]["handoffs_total"] == len(lm.mixed)
        assert mine["rollup"]["engines"] == mine["rollup"]["engines_healthy"] == 2
        assert set(mine["metrics"]) == {pre.metrics.engine_label, dec.metrics.engine_label}
        assert [e["role"] for e in mine["engines"]] == [PREFILL, DECODE]
        for h in handles:
            status, tdoc = _get(srv.url + "/trace/" + h.trace.trace_id)
            assert status == 200 and tdoc["problems"] == []
            assert tdoc["engines"] == [pre.metrics.engine_label, dec.metrics.engine_label]
        assert _get(srv.url + "/trace/not-a-trace-id")[0] == 400
        assert _get(srv.url + "/trace/" + "e" * 32)[0] == 404
    finally:
        obs_fleet.uninstall(view)
        srv.close()
        router.close(flm.WAIT_S)


def test_flight_recorder_bundle_has_host_tier(lm, tmp_path):
    pool = HostPagePool(1 << 20, flm.DC_PREFIX["page_size"])
    eng = flm.port_engine(lm, pool=pool, base=flm.DC_PREFIX)
    try:
        prompt, n, ref = lm.prefixed[0]
        assert flm.tokens([eng.submit(prompt, n)]) == [ref.tolist()]
        rec = flight_recorder.FlightRecorder(str(tmp_path))
        with open(rec.dump("test", engine=eng)) as f:
            bundle = json.load(f)
        assert bundle["host_tier"] == pool.stats()
        assert bundle["breaker"]["state"] == "closed"
    finally:
        eng.close(timeout=flm.WAIT_S)
