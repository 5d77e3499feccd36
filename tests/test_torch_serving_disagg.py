"""The port's disaggregated prefill/decode serving
(``paddle_tpu_torch.serving.disagg``) against the JAX package's, on the CPU.

The tiny LM of ``tests/torch_fleet_lm.py``: the same prompts go through a
JAX ``DisaggRouter`` and the port's, on the ``"device"`` and the
``"serialized"`` transport, through a faulted transfer
(``faults.DISAGG_HANDOFF``) that falls back to a re-prefill, and through an
unacked ``hof`` journal record resumed by ``resume_incomplete``: the tokens
are equal to each other and to the JAX engine's references. The wire format
is the JAX package's byte for byte (f32 and bf16 pages), each package reads
the other's blob, torn and corrupt blobs raise ``HandoffCorrupt``, and
``Autoscaler.decide`` answers as the JAX package's on the same signals.
Every engine closes in ``finally`` and every wait has a time limit.
"""

import torch_threads  # noqa: F401  (first: its share of the cores)
import itertools
import os
import types

import numpy as np
import pytest
import torch

import torch_fleet_lm as flm
from paddle_tpu.resilience import faults as jfaults
from paddle_tpu.serving import disagg as jdisagg
from paddle_tpu_torch import tracing
from paddle_tpu_torch.resilience import faults
from paddle_tpu_torch.serving import (
    Autoscaler,
    AutoscalerConfig,
    DisaggRouter,
    HandoffCorrupt,
    HandoffPayload,
    RequestJournal,
    replay_journal,
    resume_incomplete,
)
from paddle_tpu_torch.serving.disagg import DECODE, PREFILL, _trace_from_header


@pytest.fixture(autouse=True)
def _no_leftover_faults():
    yield
    faults.clear()
    jfaults.clear()


@pytest.fixture(scope="module")
def lm():
    return flm.tiny_lm()


def _hof_journal(path, prompt, n, first, rid):
    """A prefill worker's journal cut between the handoff record and the
    receiver's ack: admitted, one token, handed off, nothing after."""
    j = RequestJournal(path, fsync_every=1)
    j.log_admit(rid, prompt, n, [], "default", "interactive")
    j.log_token(rid, first)
    j.log_handoff(rid, prompt, n, [first], "default", "interactive", src="pre0", dst=None)
    j.close()


@pytest.fixture(scope="module")
def jax_flows(lm, tmp_path_factory):
    """The JAX package's tokens for every flow below, on one prefill and
    one decode engine (routers rewire the same two engines)."""
    from paddle_tpu.serving import resume_incomplete as jresume

    pre, dec = flm.jax_engine(lm), flm.jax_engine(lm)
    out = {}
    try:
        for transport in ("device", "serialized"):
            router = jdisagg.DisaggRouter([pre, dec], [PREFILL, DECODE], transport=transport)
            out[transport] = flm.tokens([router.submit(p, n) for p, n, _ in lm.mixed])
            out[transport + "_handoffs"] = router.handoffs_total
        router = jdisagg.DisaggRouter([pre, dec], [PREFILL, DECODE], transport="serialized")
        with jfaults.injected(jfaults.FaultSpec(jfaults.DISAGG_HANDOFF, "error", times=1)):
            prompt, n, ref = lm.mixed[0]
            out["faulted"] = flm.tokens([router.submit(prompt, n)])
        out["faulted_reprefills"] = router.handoff_reprefills_total
        path = os.fspath(tmp_path_factory.mktemp("jax_hof") / "disagg.wal")
        _hof_journal(path, prompt, n, int(ref[0]), "h-1")
        resumed = jresume(dec, path)
        out["resumed"] = flm.tokens([resumed["h-1"][0]])
    finally:
        pre.close(timeout=flm.WAIT_S)
        dec.close(timeout=flm.WAIT_S)
    return out


def _router(lm, transport, **kw):
    pre, dec = flm.port_engine(lm), flm.port_engine(lm)
    return pre, dec, DisaggRouter([pre, dec], [PREFILL, DECODE], transport=transport, **kw)


def _close(router, *engines):
    router.close(flm.WAIT_S)
    for e in engines:
        e.kv.assert_no_leaks()


# ---- the wire format --------------------------------------------------------


def _fields(rng):
    return dict(rid="r-1", prompt=np.array([3, 5, 8], np.int32), generated=[11, 13], mnt=16,
                cur_len=5, last_tok=13, page_size=4, tenant="t0", cls="interactive",
                t_submit=1.5, n_preemptions=2, src="pre0")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_handoff_payload_bytes_equal_jax(dtype):
    """The same fields and page values serialize to the same bytes in both
    packages, and each package's ``from_bytes`` reads the other's blob."""
    import jax.numpy as jnp

    rng = np.random.RandomState(7)
    vals = [rng.randn(2, 4, 4, 8).astype(np.float32) for _ in range(4)]
    tpages = [torch.from_numpy(v).to(getattr(torch, dtype)) for v in vals]
    jpages = [np.asarray(jnp.asarray(v, getattr(jnp, dtype))) for v in vals]
    tblob = HandoffPayload(k_pages=tpages[:2], v_pages=tpages[2:], **_fields(rng)).to_bytes()
    jblob = jdisagg.HandoffPayload(k_pages=jpages[:2], v_pages=jpages[2:], **_fields(rng)).to_bytes()
    assert tblob == jblob
    mine = HandoffPayload.from_bytes(jblob)
    theirs = jdisagg.HandoffPayload.from_bytes(tblob)
    for t, j, want in zip(mine.k_pages + mine.v_pages, theirs.k_pages + theirs.v_pages, tpages):
        assert t.dtype == want.dtype and torch.equal(t, want)
        np.testing.assert_array_equal(np.asarray(j, np.float32), want.float().numpy())
    assert (mine.rid, mine.generated, mine.cur_len, mine.last_tok) == ("r-1", [11, 13], 5, 13)
    assert mine.prompt.tolist() == [3, 5, 8] and mine.handle is None and mine.trace is None


def test_handoff_payload_rejects_torn_and_corrupt():
    pages = [torch.randn(2, 4, 4, 8, generator=torch.Generator().manual_seed(i)) for i in range(2)]
    blob = HandoffPayload(k_pages=pages[:1], v_pages=pages[1:],
                          **_fields(np.random.RandomState(0))).to_bytes()
    with pytest.raises(HandoffCorrupt, match="torn"):
        HandoffPayload.from_bytes(blob[:-5])
    flipped = bytearray(blob)
    flipped[-10] ^= 0xFF  # inside the last page
    with pytest.raises(HandoffCorrupt, match="CRC mismatch"):
        HandoffPayload.from_bytes(bytes(flipped))
    hdr = bytearray(blob)
    hdr[12] ^= 0xFF  # inside the JSON header
    with pytest.raises(HandoffCorrupt, match="header CRC"):
        HandoffPayload.from_bytes(bytes(hdr))
    with pytest.raises(HandoffCorrupt, match="magic"):
        HandoffPayload.from_bytes(b"nope" + blob)
    # the JAX package rejects the port's torn blob the same way
    with pytest.raises(jdisagg.HandoffCorrupt, match="torn"):
        jdisagg.HandoffPayload.from_bytes(blob[:-5])


def test_handoff_payload_trace_rides_the_wire():
    p = HandoffPayload(k_pages=[], v_pages=[], **_fields(np.random.RandomState(0)))
    p.trace = tracing.SpanContext.new_trace()
    q = HandoffPayload.from_bytes(p.to_bytes())
    assert (q.trace.trace_id, q.trace.span_id) == (p.trace.trace_id, p.trace.span_id)
    rp = q.to_rescue_packet()
    assert rp.rid == p.rid and rp.generated == p.generated and rp.trace is q.trace
    for bad in (None, "not-a-traceparent", "00-zz-bad-01"):
        assert _trace_from_header(bad) is None


# ---- end to end: the JAX flows' tokens ----------------------------------------


@pytest.mark.parametrize("transport", ["device", "serialized"])
def test_disagg_tokens_equal_jax(lm, jax_flows, transport, monkeypatch):
    """Every request is prefilled on the prefill worker and decoded on the
    decode worker from the handed-off pages; on the ``"device"`` transport
    the payload never goes through the wire format."""
    if transport == "device":
        def no_wire(self):
            raise AssertionError("the device transport serialized a payload")
        monkeypatch.setattr(HandoffPayload, "to_bytes", no_wire)
    pre, dec, router = _router(lm, transport)
    try:
        got = flm.tokens([router.submit(p, n) for p, n, _ in lm.mixed])
        assert got == jax_flows[transport] == flm.refs(lm.mixed)
        assert router.handoffs_total == jax_flows[transport + "_handoffs"] == len(lm.mixed)
        assert pre.metrics.snapshot()["handoffs_out_total"] == len(lm.mixed)
        assert dec.metrics.snapshot()["handoffs_in_total"] == len(lm.mixed)
        assert pre.metrics.snapshot()["steps_total"] == 0  # no decode on the prefill worker
        assert router.handoff_rejects_total == 0
    finally:
        _close(router, pre, dec)


def test_handoff_trace_one_id_no_orphans(lm):
    pre, dec, router = _router(lm, "device")
    try:
        prompt, n, ref = lm.mixed[0]
        h = router.submit(prompt, n)
        assert flm.tokens([h]) == [ref.tolist()]
        spans = tracing.spans_for_trace(h.trace.trace_id)
        assert tracing.validate_trace(spans, multi_engine=True) == []
        names = {s.name for s in spans}
        assert {"serving.decode.queue_wait", "serving.decode.prefill", "serving.handoff.transfer",
                "serving.handoff.adopt", "serving.decode.request"} <= names, names
        roots = [s for s in spans if s.context.parent_id is None]
        assert [r.attrs["engine"] for r in roots] == [dec.metrics.engine_label]
    finally:
        _close(router, pre, dec)


def test_faulted_transfer_reprefills_equal_jax(lm, jax_flows):
    pre, dec, router = _router(lm, "serialized")
    try:
        with faults.injected(faults.FaultSpec(faults.DISAGG_HANDOFF, "error", times=1)) as plan:
            prompt, n, ref = lm.mixed[0]
            h = router.submit(prompt, n)
            got = flm.tokens([h])
            assert plan.all_fired()
        assert got == jax_flows["faulted"] == [ref.tolist()]
        assert router.handoff_rejects_total == 1
        assert router.handoff_reprefills_total == jax_flows["faulted_reprefills"] == 1
        spans = tracing.spans_for_trace(h.trace.trace_id)
        assert "serving.rescue" in {s.name for s in spans}
        assert tracing.validate_trace(spans, multi_engine=True) == []
    finally:
        _close(router, pre, dec)


def test_torn_transfer_reprefills(lm, monkeypatch):
    """A blob torn on the wire is rejected whole and re-prefilled."""
    real = HandoffPayload.to_bytes
    monkeypatch.setattr(HandoffPayload, "to_bytes", lambda self: real(self)[:-3])
    pre, dec, router = _router(lm, "serialized")
    try:
        got = flm.tokens([router.submit(p, n) for p, n, _ in lm.mixed])
        assert got == flm.refs(lm.mixed)
        assert router.handoff_rejects_total == len(lm.mixed)
        assert dec.metrics.snapshot()["handoffs_in_total"] == 0
    finally:
        _close(router, pre, dec)


def test_unacked_handoff_resumes_equal_jax(lm, jax_flows, tmp_path):
    path = os.fspath(tmp_path / "disagg.wal")
    prompt, n, ref = lm.mixed[0]
    _hof_journal(path, prompt, n, int(ref[0]), "h-1")
    rep = replay_journal(path)
    assert rep["h-1"].handed_off and not rep["h-1"].acked and not rep["h-1"].finished
    eng = flm.port_engine(lm, journal_path=path)
    try:
        resumed = resume_incomplete(eng, path)
        assert set(resumed) == {"h-1"}
        handle, n_delivered = resumed["h-1"]
        got = flm.tokens([handle])
        assert got == jax_flows["resumed"] == [ref.tolist()]
        assert got[0][:n_delivered] == [int(ref[0])]
    finally:
        eng.close(timeout=flm.WAIT_S)
    eng.kv.assert_no_leaks()


def test_router_shares_journal_and_acks(lm, tmp_path):
    """A router-owned journal covers both workers: every request is
    acked and finished in the one file."""
    path = os.fspath(tmp_path / "fleet.wal")
    pre, dec, router = _router(lm, "device", journal_path=path)
    try:
        got = flm.tokens([router.submit(p, n) for p, n, _ in lm.mixed])
        assert got == flm.refs(lm.mixed)
        assert pre._journal is dec._journal is router._journal
    finally:
        _close(router, pre, dec)
    rep = replay_journal(path)
    assert len(rep) == len(lm.mixed)
    # the adopter's admit snapshot supersedes the hof record; the
    # receiver's ack proves the transfer completed
    assert all(r.acked and not r.handed_off and r.finished for r in rep.values())
    assert sorted(r.generated for r in rep.values()) == sorted(flm.refs(lm.mixed))


def test_no_decode_worker_decodes_locally(lm):
    pre, dec, router = _router(lm, "device")
    try:
        router._draining.add(id(dec))
        prompt, n, ref = lm.mixed[0]
        assert flm.tokens([router.submit(prompt, n)]) == [ref.tolist()]
        assert router.handoffs_total == 0 and pre.metrics.snapshot()["handoffs_out_total"] == 0
    finally:
        router._draining.discard(id(dec))
        _close(router, pre, dec)


def test_tp_degree_mismatch_reprefills(lm):
    """A payload gathered under another tensor-parallel degree is not
    adopted: the decode worker re-prefills it, token-exact."""
    pre, dec = flm.port_engine(lm), flm.port_engine(lm)
    try:
        def sink(src, payload):
            payload.tp_degree = 2
            dec.adopt_handoff(payload, from_engine=src.metrics.engine_label)

        pre._handoff_sink = sink
        prompt, n, ref = lm.mixed[0]
        assert flm.tokens([pre.submit(prompt, n)]) == [ref.tolist()]
        snap = dec.metrics.snapshot()
        assert snap["handoffs_in_total"] == 0 and snap["recovered_total"] == 1
    finally:
        for e in (pre, dec):
            e.close(timeout=flm.WAIT_S)
            e.kv.assert_no_leaks()


def test_convert_drains_and_swaps_role(lm):
    built = []

    def factory(role):
        built.append(role)
        return flm.port_engine(lm)

    p1, p2, d1 = flm.port_engine(lm), flm.port_engine(lm), flm.port_engine(lm)
    router = DisaggRouter([p1, p2, d1], [PREFILL, PREFILL, DECODE], factory=factory)
    try:
        new = router.convert(p2, DECODE, timeout=10)
        assert p2.closed and built == [DECODE]
        assert (router.n_prefill, router.n_decode) == (1, 2) and router.role(new) == DECODE
        prompt, n, ref = lm.mixed[0]
        assert flm.tokens([router.submit(prompt, n)]) == [ref.tolist()]
        assert router.convert(new, DECODE) is new
    finally:
        router.close(flm.WAIT_S)


# ---- the autoscaler -----------------------------------------------------------


def test_autoscaler_decide_equals_jax():
    """Every signal combination of a grid gets the same action from both
    packages' decision cores, under default and tightened policies."""
    quiet = types.SimpleNamespace(observe=lambda *a, **k: None)
    grid = itertools.product((None, 0.0, 0.9, 2.5), (0.0, 4.0, 20.0), (0.0, 3.0),
                             (1, 2, 4), (1, 2, 3), (False, True))
    for over in ({}, dict(floor_prefill=2, spike_depth=3.0, burn_threshold=2.0)):
        mine = Autoscaler(types.SimpleNamespace(), AutoscalerConfig(**over), detector=quiet)
        theirs = jdisagg.Autoscaler(types.SimpleNamespace(), jdisagg.AutoscalerConfig(**over),
                                    detector=quiet)
        for burn, pd, dd, npf, nd, spike in grid:
            kw = dict(burn_rate=burn, prefill_depth=pd, decode_depth=dd, n_prefill=npf,
                      n_decode=nd, queue_spike=spike)
            assert mine.decide(**kw) == theirs.decide(**kw), kw


def test_autoscaler_tick_converts_and_cools_down(lm):
    def factory(role):
        return flm.port_engine(lm)

    p1, p2, d1 = flm.port_engine(lm), flm.port_engine(lm), flm.port_engine(lm)
    router = DisaggRouter([p1, p2, d1], [PREFILL, PREFILL, DECODE], factory=factory)
    now = {"t": 100.0}
    slo = types.SimpleNamespace(status=lambda: [{"name": "decode_p99", "burn_rate": 9.0}])
    scaler = Autoscaler(router, AutoscalerConfig(slo_name="decode_p99", cooldown_s=30.0),
                        slo_engine=slo, detector=types.SimpleNamespace(observe=lambda *a, **k: None),
                        clock=lambda: now["t"])
    try:
        assert scaler.tick() == Autoscaler.SCALE_DECODE
        assert (router.n_prefill, router.n_decode) == (1, 2)
        assert scaler.tick() is None  # cooling down
        now["t"] += 31.0
        assert scaler.tick() is None  # the prefill floor
        assert scaler.actions_total == {Autoscaler.SCALE_DECODE: 1}
    finally:
        router.close(flm.WAIT_S)


def test_router_guards():
    eng = types.SimpleNamespace()
    with pytest.raises(Exception):
        DisaggRouter([eng], [PREFILL])  # no decode worker
    with pytest.raises(Exception):
        DisaggRouter([eng], [DECODE], transport="carrier-pigeon")
