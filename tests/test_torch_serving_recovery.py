"""The port's request journal and engine migration
(``paddle_tpu_torch.serving.recovery``) against the JAX package's, on the
CPU.

- The journal's records are the JAX package's byte for byte: the same
  appends write the same file in both packages, and a journal written by
  either replays in the other to equal ``ReplayedRequest``\\ s (torn tails
  and compaction included).
- The tiny LM of ``tests/torch_fleet_lm.py``: a ``DecodeFleet`` whose
  engine trips its breaker migrates every live request to its peer, and a
  killed engine's journaled requests resume on its peer through
  ``resume_incomplete``; in both packages, with tokens equal to each other
  and to the JAX engine's references.

Every engine closes in ``finally`` and every wait has a time limit.
"""

import torch_threads  # noqa: F401  (first: its share of the cores)
import dataclasses
import os
import time

import numpy as np
import pytest
import torch

import torch_fleet_lm as flm
from paddle_tpu.resilience import faults as jfaults
from paddle_tpu.serving import recovery as jrecovery
from paddle_tpu_torch import tracing
from paddle_tpu_torch.resilience import faults
from paddle_tpu_torch.resilience.circuit import CLOSED, OPEN
from paddle_tpu_torch.serving import (
    DecodeFleet,
    EngineUnhealthy,
    RequestJournal,
    replay_journal,
    resume_incomplete,
)
from paddle_tpu_torch.serving import recovery as trecovery
from paddle_tpu_torch.serving.recovery import _decode_record, _encode_record


@pytest.fixture(autouse=True)
def _no_leftover_faults():
    yield
    faults.clear()
    jfaults.clear()


@pytest.fixture(scope="module")
def lm():
    return flm.tiny_lm()


def _sick(f, label):
    """Every decode step of engine ``label`` fails after its first."""
    return f.FaultSpec(f.DECODE_STEP, "error", after=1, times=10 ** 9, match={"engine": label})


def _wait_tokens(eng, n):
    deadline = time.monotonic() + flm.WAIT_S
    while eng.metrics.snapshot()["tokens_total"] < n and time.monotonic() < deadline:
        time.sleep(0.002)


def _kill_and_resume(lm, mod, fleet_cls, make, path):
    """Requests pinned to engine A of a two-engine fleet; A is killed once
    it has generated some tokens, and B resumes A's journal (each resumed
    output starts with the tokens the journal proves delivered). Returns
    the tokens in prompt order and B's replay count."""
    ea, eb = make(lm, label="a", journal_path=path, journal_fsync_every=4), make(lm, label="b")
    fleet = fleet_cls([ea, eb])
    try:
        handles = [ea.submit(p, n) for p, n, _ in lm.mixed]
        _wait_tokens(ea, 6)
        ea.kill()
        for h in handles:  # the killed engine's futures fail typed, not hang
            with pytest.raises(Exception):
                h.result(timeout=flm.WAIT_S)
        rep = mod.replay_journal(path)
        assert len(rep) == len(lm.mixed) and not any(r.finished for r in rep.values())
        resumed = mod.resume_incomplete(eb, path)
        by_prompt = {}
        for rid, (handle, n_delivered) in resumed.items():
            got = flm.tokens([handle])[0]
            assert got[:n_delivered] == rep[rid].generated[:n_delivered]
            by_prompt[tuple(rep[rid].prompt.tolist())] = got
        return ([by_prompt[tuple(p.tolist())] for p, _, _ in lm.mixed],
                eb.metrics.snapshot()["journal_replayed_total"])
    finally:
        fleet.close(timeout=flm.WAIT_S)


def _migrate(lm, f, fleet_cls, make):
    """Requests pinned to engine A, whose steps all fail after the first:
    its breaker trips and the fleet migrates them to B."""
    ea, eb = make(lm, label="ma"), make(lm, label="mb")
    fleet = fleet_cls([ea, eb])
    try:
        with f.injected(_sick(f, ea.metrics.engine_label)):
            got = flm.tokens([ea.submit(p, n) for p, n, _ in lm.mixed])
            state = ea.breaker.state
        return got, state, ea.metrics.snapshot()["migrated_total"], eb
    finally:
        fleet.close(timeout=flm.WAIT_S)


@pytest.fixture(scope="module")
def jax_flows(lm, tmp_path_factory):
    path = os.fspath(tmp_path_factory.mktemp("jax_kill") / "decode.wal")
    killed, replayed = _kill_and_resume(lm, jrecovery, jrecovery.DecodeFleet, flm.jax_engine, path)
    migrated, state, n_migrated, _ = _migrate(lm, jfaults, jrecovery.DecodeFleet, flm.jax_engine)
    return dict(killed=killed, replayed=replayed, migrated=migrated, state=state,
                n_migrated=n_migrated)


# ---- the journal's format -------------------------------------------------------


def _appends(j):
    j.log_admit("r1", np.array([5, 6], np.int32), 4, [], "default", "interactive",
                trace="00-" + "a" * 32 + "-" + "b" * 16 + "-01")
    j.log_token("r1", 7)
    j.log_handoff("r1", np.array([5, 6], np.int32), 4, [7], "t0", "batch", src="pre0", dst=None)
    j.log_handoff_ack("r1", "dec0")
    j.log_token("r1", 8)
    j.log_finish("r1", "length")
    j.log_admit("r2", np.array([9], np.int32), 3, [1], "default", "interactive")
    j.log_token("r2", 2)


def test_journal_bytes_equal_jax(tmp_path):
    for rec in ({"k": "tok", "rid": "r2", "t": 3}, {"k": "admit", "rid": "é", "prompt": [1]}):
        assert _encode_record(rec) == jrecovery._encode_record(rec)
        assert _decode_record(_encode_record(rec)) == rec
    paths = {}
    for name, cls in (("torch", RequestJournal), ("jax", jrecovery.RequestJournal)):
        paths[name] = os.fspath(tmp_path / f"{name}.wal")
        j = cls(paths[name], fsync_every=3)
        _appends(j)
        j.close()
    with open(paths["torch"], "rb") as a, open(paths["jax"], "rb") as b:
        assert a.read() == b.read()


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_journal_replays_across_packages(tmp_path, writer):
    """A journal written by either package, a torn tail appended, replays
    in both to equal requests."""
    path = os.fspath(tmp_path / "j.wal")
    j = (jrecovery.RequestJournal if writer == "jax" else RequestJournal)(path, fsync_every=2)
    _appends(j)
    j.close()
    with open(path, "ab") as f:
        f.write(b"deadbeef|{\"k\":\"tok\",\"rid\":\"r2\"")  # a torn append
    mine, theirs = replay_journal(path), jrecovery.replay_journal(path)
    assert list(mine) == list(theirs) == ["r1", "r2"]
    for rid in mine:
        a, b = dataclasses.asdict(mine[rid]), dataclasses.asdict(theirs[rid])
        assert a.pop("prompt").tolist() == b.pop("prompt").tolist()
        assert a == b
    assert mine["r1"].finished and mine["r1"].acked and mine["r1"].generated == [7, 8]
    # the hof record carried no traceparent: the admit record's stands
    assert mine["r1"].trace == "00-" + "a" * 32 + "-" + "b" * 16 + "-01"
    assert not mine["r2"].finished and mine["r2"].generated == [1, 2]


def test_journal_compaction_keeps_incomplete(tmp_path):
    """A size-triggered compaction drops finished requests; the compacted
    file replays in both packages to the incomplete ones, unchanged."""
    path = os.fspath(tmp_path / "j.wal")
    j = RequestJournal(path, fsync_every=1, compact_bytes=400)
    for i in range(6):
        j.log_admit(f"r{i}", np.arange(1, 9, dtype=np.int32), 8, [], "default", "interactive")
        j.log_token(f"r{i}", 40 + i)
        if i % 2 == 0:
            j.log_finish(f"r{i}", "length")
    j.close()
    assert j.compactions_total >= 1
    mine, theirs = replay_journal(path), jrecovery.replay_journal(path)
    assert sorted(mine) == sorted(theirs) == ["r1", "r3", "r5"]
    assert all(mine[r].generated == theirs[r].generated == [40 + int(r[1])] for r in mine)


# ---- the fleet: migration and a killed engine -------------------------------------


def test_tripped_breaker_migrates_equal_jax(lm, jax_flows):
    got, state, n_migrated, eb = _migrate(lm, faults, DecodeFleet, flm.port_engine)
    assert got == jax_flows["migrated"] == flm.refs(lm.mixed)
    assert state == jax_flows["state"] == OPEN
    assert n_migrated == jax_flows["n_migrated"] == len(lm.mixed)
    assert eb.metrics.snapshot()["errors_total"] == 0 and eb.decode_step_cache_size() == 1


def test_killed_engine_resumes_on_peer_equal_jax(lm, jax_flows, tmp_path):
    got, replayed = _kill_and_resume(lm, trecovery, DecodeFleet, flm.port_engine,
                                     os.fspath(tmp_path / "decode.wal"))
    assert got == jax_flows["killed"] == flm.refs(lm.mixed)
    assert replayed == jax_flows["replayed"] == len(lm.mixed)


def test_breaker_readmits_after_fault_clears(lm):
    """Once the fault is gone, routed traffic spends the half-open probe
    on the tripped engine and its breaker closes again."""
    ea, eb = flm.port_engine(lm), flm.port_engine(lm)
    fleet = DecodeFleet([ea, eb])
    try:
        with faults.injected(_sick(faults, ea.metrics.engine_label)):
            prompt, n, ref = lm.mixed[0]
            assert flm.tokens([ea.submit(prompt, n)]) == [ref.tolist()]
        assert ea.breaker.state == OPEN
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline and ea.breaker.state != CLOSED:
            assert flm.tokens([fleet.submit(prompt, n)]) == [ref.tolist()]
            time.sleep(0.02)
        assert ea.breaker.state == CLOSED and ea.breaker.recoveries_total >= 1
    finally:
        fleet.close(timeout=flm.WAIT_S)


def test_fault_during_recovery_escalates_to_migration(lm):
    ea, eb = flm.port_engine(lm), flm.port_engine(lm)
    fleet = DecodeFleet([ea, eb])
    try:
        handles = [ea.submit(p, n) for p, n, _ in lm.mixed]
        chunks = sum(-(-len(p) // ea.decode_config.prefill_chunk) for p, _, _ in lm.mixed)
        deadline = time.monotonic() + flm.WAIT_S
        while ea.metrics.snapshot()["prefill_chunks_total"] < chunks and time.monotonic() < deadline:
            time.sleep(0.002)
        with faults.injected(
            faults.FaultSpec(faults.DECODE_STEP, "error", after=1,
                             match={"engine": ea.metrics.engine_label}),
            faults.FaultSpec(faults.DECODE_RECOVER, "error",
                             match={"engine": ea.metrics.engine_label}),
        ) as plan:
            assert flm.tokens(handles) == flm.refs(lm.mixed)
            assert plan.all_fired()
        assert ea.metrics.snapshot()["migrated_total"] == len(lm.mixed)
    finally:
        fleet.close(timeout=flm.WAIT_S)


def test_migration_keeps_one_trace(lm):
    ea, eb = flm.port_engine(lm), flm.port_engine(lm)
    fleet = DecodeFleet([ea, eb])
    try:
        with faults.injected(_sick(faults, ea.metrics.engine_label)):
            prompt, n, ref = lm.mixed[0]
            h = ea.submit(prompt, n)
            assert flm.tokens([h]) == [ref.tolist()]
        spans = tracing.spans_for_trace(h.trace.trace_id)
        assert tracing.validate_trace(spans, multi_engine=True) == []
        assert "serving.rescue" in {s.name for s in spans}
        assert {s.attrs.get("engine") for s in spans} >= {ea.metrics.engine_label,
                                                          eb.metrics.engine_label}
    finally:
        fleet.close(timeout=flm.WAIT_S)


def test_restart_resume_continues_original_trace(lm, tmp_path):
    path = os.fspath(tmp_path / "decode.wal")
    e1 = flm.port_engine(lm, journal_path=path, journal_fsync_every=1)
    prompt, n, ref = lm.mixed[0]
    h = e1.submit(prompt, n)
    _wait_tokens(e1, 2)
    e1.kill()
    e2 = flm.port_engine(lm)
    try:
        (handle, _), = resume_incomplete(e2, path).values()
        assert flm.tokens([handle]) == [ref.tolist()]
        assert handle.trace.trace_id == h.trace.trace_id
    finally:
        e2.close(timeout=flm.WAIT_S)


def test_pick_is_least_loaded_with_a_stable_tiebreak(lm):
    ea, eb = flm.port_engine(lm), flm.port_engine(lm)
    fleet = DecodeFleet([ea, eb])
    try:
        assert {id(fleet._pick()) for _ in range(8)} == {id(ea)}
        ea.load = lambda: 50.0
        assert {id(fleet._pick()) for _ in range(4)} == {id(eb)}
        snap = fleet.snapshot()
        assert [e["engine"] for e in snap["engines"]] == [ea.metrics.engine_label,
                                                        eb.metrics.engine_label]
    finally:
        fleet.close(timeout=flm.WAIT_S)


def test_fleet_no_healthy_engine_rejects_typed(lm):
    eng = flm.port_engine(lm)
    fleet = DecodeFleet([eng])
    try:
        eng.breaker.trip()
        with pytest.raises(EngineUnhealthy):
            fleet.submit(lm.mixed[0][0], 4)
    finally:
        fleet.close(timeout=flm.WAIT_S)


def test_from_groups_refused_naming_its_item(lm):
    """Once refused, now ported: one engine per replica group (two tp=2
    groups on four CPU members), labeled by the group, serving the fleet's
    traffic token-exactly (``tests/test_torch_shardgroup.py`` holds the
    member-fault migration)."""
    from paddle_tpu_torch.serving import DecodeConfig, make_groups

    fleet = DecodeFleet.from_groups(lm.params, lm.cfg,
                                    make_groups(2, devices=[torch.device("cpu")] * 4),
                                    decode=DecodeConfig(**flm.DC))
    try:
        assert [e.metrics.engine_label for e in fleet.engines] == ["group0", "group1"]
        assert [e.tp_degree for e in fleet.engines] == [2, 2]
        assert flm.tokens([fleet.submit(p, n) for p, n, _ in lm.mixed]) == flm.refs(lm.mixed)
    finally:
        fleet.close(timeout=flm.WAIT_S)
    for e in fleet.engines:
        e.kv.assert_no_leaks()
