"""The port's tracing (``paddle_tpu_torch.tracing``) against the JAX
package's (``paddle_tpu.tracing``) on the CPU.

- W3C trace contexts read each other's ``traceparent``.
- The same recorded spans give the same ``validate_trace`` verdicts and
  ``phase_totals``; the merged Chrome trace validates, with a memory
  counter track.
- The memory sampler on the CPU sums the tensors it is given
  (``source="tensors"``) into the ``device.hbm.*`` families.
- Both packages' decode engines, on the same tiny LM and the same
  requests, give every request a complete span tree with the same span
  names and parents.
"""

import torch_threads  # noqa: F401  (first: its share of the cores)
import numpy as np
import pytest
import torch

from paddle_tpu import models as jmodels
from paddle_tpu import tracing as jtracing
from paddle_tpu.serving import DecodeConfig as JDecodeConfig
from paddle_tpu.serving import DecodeEngine as JDecodeEngine
from paddle_tpu_torch import convert
from paddle_tpu_torch import tracing as ttracing
from paddle_tpu_torch.core import profiler as tprof
from paddle_tpu_torch.serving import DecodeConfig, DecodeEngine

PACKAGES = (jtracing, ttracing)


@pytest.fixture(autouse=True)
def _fresh_stores():
    for tr in PACKAGES:
        tr.reset_tracing()
        tr.enable_tracing()
    yield
    for tr in PACKAGES:
        tr.reset_tracing()
        tr.enable_tracing()


def test_traceparents_cross_packages():
    for src, dst in ((jtracing, ttracing), (ttracing, jtracing)):
        ctx = src.SpanContext.new_trace().child()
        back = dst.SpanContext.from_traceparent(ctx.to_traceparent())
        assert (back.trace_id, back.span_id) == (ctx.trace_id, ctx.span_id)


def _record(tr, broken):
    root = tr.SpanContext("a" * 32, "b" * 16)
    tr.record_span("serving.decode.request", 10.0, 11.0, context=root)
    tr.record_span("serving.decode.queue_wait", 10.0, 10.2, parent=root)
    tr.record_span("serving.decode.prefill", 10.2, 10.5, parent=root)
    if broken:  # an orphan and a child outside its parent's interval
        tr.record_span("serving.decode.prefill", 10.5, 10.6,
                       context=tr.SpanContext("a" * 32, "c" * 16, "d" * 16))
        tr.record_span("serving.decode.queue_wait", 9.0, 12.5, parent=root)
    problems = tr.validate_trace(tr.spans_for_trace("a" * 32))
    names = sorted(s.name for s in tr.spans_for_trace("a" * 32))
    return problems, names, tr.phase_totals(["serving.decode.prefill"])


@pytest.mark.parametrize("broken", [False, True], ids=["complete", "broken"])
def test_validate_trace_and_phase_totals_match(broken):
    j, t = (_record(tr, broken) for tr in PACKAGES)
    assert len(t[0]) == len(j[0]) and (t[0] == []) is (not broken)
    assert t[1:] == j[1:]


def test_memory_sampler_on_cpu_and_chrome_trace():
    ttracing.reset_memory_telemetry()
    tprof.reset_metrics()
    state = {"w": torch.zeros(256, 4), "b": torch.zeros(4, dtype=torch.float64)}
    (s1,) = ttracing.sample_device_memory(["cpu"], tensors=state)
    (s2,) = ttracing.sample_device_memory(["cpu"], tensors={"w": state["w"]})
    assert s1 == {"device": "cpu:0", "bytes_in_use": 256 * 4 * 4 + 32,
                  "peak_bytes_in_use": 256 * 4 * 4 + 32, "bytes_limit": None,
                  "source": "tensors"}
    assert s2["bytes_in_use"] == 4096 and s2["peak_bytes_in_use"] == s1["bytes_in_use"]
    assert tprof.gauges()["device.hbm.peak_bytes_in_use"] == s1["bytes_in_use"]
    with ttracing.start_trace("trainer.step"):
        with ttracing.start_span("trainer.step_compute"):
            pass
    doc = ttracing.chrome_trace_doc()
    counts = ttracing.validate_chrome_trace(doc)
    assert counts["X"] >= 2 and counts["C"] >= 2
    assert any(e["ph"] == "C" and "cpu:0" in str(e.get("args", {})) for e in doc["traceEvents"])


def _trees(tr, handles):
    out = []
    for h in handles:
        spans = tr.spans_for_trace(h.trace.trace_id)
        assert tr.validate_trace(spans) == []
        names = {s.context.span_id: s.name for s in spans}
        out.append(sorted((s.name, names.get(s.context.parent_id)) for s in spans))
    return out


def test_decode_engine_request_trees_match_jax():
    spec = jmodels.get_model("transformer_lm", seq_len=64, vocab=97, d_model=32, d_inner=64,
                             num_heads=4, n_layers=2)
    rng = np.random.RandomState(2)
    jvars = spec.model.init(0, *spec.synth_batch(2, rng))
    tparams = convert.params_from_jax({n: np.asarray(a) for n, a in jvars.params.items()}, "cpu")
    prompts = [rng.randint(1, 97, size=(n,)).astype(np.int32) for n in (5, 19, 11)]
    geometry = dict(max_slots=3, page_size=4, max_context=40, prefill_chunk=8)
    jeng = JDecodeEngine(jvars, spec.extra["cfg"], decode=JDecodeConfig(**geometry))
    teng = DecodeEngine(tparams, spec.extra["cfg"], decode=DecodeConfig(**geometry), device="cpu")
    try:
        jh = [jeng.submit(p, 6) for p in prompts]
        jout = [h.result(timeout=120) for h in jh]
        th = [teng.submit(p, 6) for p in prompts]
        tout = [h.result(timeout=120) for h in th]
    finally:
        jeng.close(timeout=30)
        teng.close(timeout=30)
    assert [list(o.tokens) for o in tout] == [list(o.tokens) for o in jout]
    t_trees = _trees(ttracing, th)
    assert t_trees == _trees(jtracing, jh)
    # the 19-token prompt prefilled in 3 chunks of 8 under its request span
    assert t_trees[1].count(("serving.decode.prefill", "serving.decode.request")) == 3
    loop = [s for s in ttracing.spans() if s.name == "serving.decode.step"]
    assert loop and len({s.context.trace_id for s in loop}) == 1
