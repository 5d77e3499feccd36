"""The port's tensor-parallel replica groups (``paddle_tpu_torch.serving.
shardgroup``, ``DecodeEngine(group=)``, ``DecodeFleet.from_groups``)
against the JAX package, on the CPU.

Groups run in this one process with ``devices=[cpu] * 4`` (members may
repeat a device; no process is spawned). The model is the JAX test's
``_build`` (vocab 97, d_model 32, 4 heads, 2 layers) in the variants
``mha``, ``gqa`` (``num_kv_heads=2``: the pages split over the members),
``gqa1`` (``num_kv_heads=1``: the pages stay whole, k/v's ``dh`` columns
split and are gathered), ``rope`` and ``window``; the port's init (key 0,
data seed 1) gives both packages' weights, carried to JAX with
``convert.params_to_numpy`` as in ``tests/torch_fleet_lm.py``. References
are the JAX ``generate()``'s tokens, every reference step's top-1/top-2
logit gap asserted above ``torch_fleet_lm.MARGIN`` (1e-3), so equal tokens
cannot hinge on a near tie. The group decoder's logits are held within
``LOGITS_ATOL`` (1e-5) of the JAX forward's, its pages within the same of
the JAX ``paged_prefill_chunk``/``paged_decode_step``'s. Every engine
closes in ``finally`` and every wait has a time limit.
"""

import torch_threads  # noqa: F401  (first: its share of the cores)
import functools
import time
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_fleet_lm as flm
from paddle_tpu import models as jmodels
from paddle_tpu.framework import Variables as JVariables
from paddle_tpu.models import transformer_lm as jlm
from paddle_tpu.parallel.mesh import tp_submesh as jtp_submesh
from paddle_tpu.serving import shardgroup as jsg
from paddle_tpu_torch import convert
from paddle_tpu_torch import models as tmodels
from paddle_tpu_torch.core.enforce import EnforceError
from paddle_tpu_torch.models import transformer_lm as tlm
from paddle_tpu_torch.parallel.mesh import TP_AXIS, partition_devices
from paddle_tpu_torch.parallel.sharding import P
from paddle_tpu_torch.resilience import faults
from paddle_tpu_torch.resilience.circuit import CLOSED, OPEN
from paddle_tpu_torch.serving import (
    DecodeConfig,
    DecodeEngine,
    DecodeFleet,
    DisaggRouter,
    GroupLayout,
    GroupStragglerWatch,
    ReplicaGroup,
    ServingConfig,
    default_layout,
    make_groups,
    probe_members,
)
from paddle_tpu_torch.serving.shardgroup import _TRANSFORMER_LM_RULES
from paddle_tpu_torch.serving.disagg import DECODE, PREFILL

VOCAB = 97
CPU4 = [torch.device("cpu")] * 4
LOGITS_ATOL = 1e-5
# the JAX test's engine policy
DC = dict(max_slots=3, page_size=4, max_context=40, prefill_chunk=8, num_pages=14)
VARIANTS = {
    "mha": {},
    "gqa": dict(num_kv_heads=2),
    "gqa1": dict(num_kv_heads=1),
    "rope": dict(pos_encoding="rope"),
    "window": dict(attention_window=8),
}
# a vocabulary that tp=2 divides, for layouts that cut the embedding and logits
EVEN_VOCAB = dict(vocab=96)


@pytest.fixture(autouse=True)
def _no_leftover_faults():
    yield
    faults.clear()


@functools.lru_cache(maxsize=None)
def _build(variant: str = "mha"):
    """The tiny LM in ``variant`` (or ``"even_vocab"``): its config, the
    port's parameters, the JAX package's (the same values) and three
    requests (4-11 prompt tokens, 8-15 new, drawn from seed 1 as the JAX
    test draws them) with their JAX ``generate()`` references (jitted: one
    compile per request's shapes)."""
    dims = dict(dict(seq_len=64, vocab=VOCAB, d_model=32, d_inner=64, num_heads=4, n_layers=2),
                **(EVEN_VOCAB if variant == "even_vocab" else VARIANTS[variant]))
    cfg = jmodels.get_model("transformer_lm", **dims).extra["cfg"]
    tspec = tmodels.get_model("transformer_lm", device="cpu", **dims)
    assert tspec.extra["cfg"] == cfg
    rng = np.random.RandomState(1)
    tparams = tspec.model.init(0, *tspec.synth_batch(2, rng), device="cpu").params
    jvars = JVariables({n: jnp.asarray(a) for n, a in convert.params_to_numpy(tparams).items()},
                       {})
    cases = []
    for _ in range(3):
        t = int(rng.randint(4, 12))
        n = int(rng.randint(8, 16))
        prompt = rng.randint(1, cfg["vocab"], size=(t,)).astype(np.int32)
        gen = jax.jit(functools.partial(jlm.generate, max_new_tokens=n, cfg=cfg))
        ref = np.asarray(gen(jvars.params, jnp.asarray(prompt[None])))[0]
        flm._assert_margin(tparams, cfg, prompt, ref)
        cases.append((prompt, n, ref))
    return types.SimpleNamespace(cfg=cfg, params=tparams, jvars=jvars, cases=cases)


def _group(i: int = 0, tp: int = 2):
    return make_groups(tp, devices=CPU4)[i]


def _engine(lm, group=None, label=None, **over):
    return DecodeEngine(lm.params, lm.cfg, decode=DecodeConfig(**dict(DC, **over)),
                        group=group, config=ServingConfig(engine_label=label),
                        device=None if group is not None else "cpu")


def _tokens(handles):
    return [np.asarray(h.result(timeout=flm.WAIT_S).tokens).tolist() for h in handles]


def _refs(lm):
    return [r.tolist() for _, _, r in lm.cases]


# ---- tentpole: tp=2 token-exact vs generate() -------------------------------


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_group_token_exact_vs_generate(variant):
    """A tp=2 group on two CPU members reproduces the JAX ``generate()``
    tokens under mixed in-flight traffic, with one step shape."""
    lm = _build(variant)
    eng = _engine(lm, group=_group(), label=f"tp2-{variant}")
    try:
        assert _tokens([eng.submit(p, n) for p, n, _ in lm.cases]) == _refs(lm)
        assert eng.decode_step_cache_size() == 1
        assert eng.tp_degree == 2 and eng.group.tp == 2
        snap = eng.metrics.snapshot()
        assert snap["errors_total"] == 0 and snap["step_faults_total"] == 0, snap
    finally:
        eng.close(timeout=flm.WAIT_S)
    eng.kv.assert_no_leaks()


def test_group_speculative_decode_token_exact():
    """Draft-and-verify under a group (the target as its own draft): the
    draft's parameters and pages are placed on the same members, and the
    verify step keeps one shape."""
    lm = _build()
    eng = DecodeEngine(lm.params, lm.cfg, decode=DecodeConfig(spec_tokens=3, **DC),
                       draft_variables=lm.params, group=_group())
    try:
        assert _tokens([eng.submit(p, n) for p, n, _ in lm.cases]) == _refs(lm)
        assert eng.decode_step_cache_size() == 1
        assert eng.verify_step_cache_size() == 1
        assert isinstance(eng._dk_pages, list) and len(eng._dk_pages) == 2
    finally:
        eng.close(timeout=flm.WAIT_S)
    eng.kv.assert_no_leaks()


# ---- the group decoder against the JAX paged functions ----------------------


@pytest.mark.parametrize("variant", ["gqa", "gqa1"])
def test_group_decoder_logits_and_pages_vs_jax(variant):
    """One prefill chunk and two decode steps: the group decoder's logits
    against the JAX forward's at the same positions, its tokens against
    the JAX ``paged_prefill_chunk``/``paged_decode_step``'s, and its pages
    (gathered whole from the members) against theirs."""
    lm = _build(variant)
    cfg, ps, n_pages = lm.cfg, DC["page_size"], DC["num_pages"]
    group = _group()
    layout = default_layout()
    pshape = tlm.paged_cache_shape(cfg, n_pages, ps)
    kv_split = layout.kv_page_spec(pshape, group.mesh)[2] is not None
    mshape = (pshape[:2] + (pshape[2] // 2,) + pshape[3:]) if kv_split else pshape
    k = [torch.zeros(mshape) for _ in range(2)]
    v = [torch.zeros(mshape) for _ in range(2)]
    table = np.array([3, 7, 1, 12, 5, 2, 4, 6, 8, 9], np.int32)
    dec = tlm.GroupPagedDecoder(layout.shard_params(group, lm.params),
                                {n: t.shape for n, t in lm.params.items()}, cfg, ps,
                                len(table), kv_split)
    chunk = np.random.RandomState(4).randint(1, VOCAB, size=(8,)).astype(np.int32)
    jk = jnp.zeros(pshape, jnp.float32)
    jv = jnp.zeros(pshape, jnp.float32)
    with torch.no_grad():
        logits = [dec.prefill_chunk(torch.from_numpy(chunk), 0, 7, torch.from_numpy(table), k, v)]
    jtok, jk, jv = jax.jit(functools.partial(jlm.paged_prefill_chunk, cfg=cfg, page_size=ps))(
        lm.jvars, jnp.asarray(chunk), jnp.int32(0), jnp.int32(7), jnp.asarray(table), jk, jv)
    toks = [int(torch.argmax(logits[0]))]
    assert toks[0] == int(jtok)
    jstep = jax.jit(functools.partial(jlm.paged_decode_step, cfg=cfg, page_size=ps))
    for s in range(2):
        pos = np.array([8 + s], np.int32)
        with torch.no_grad():
            lg = dec.decode_step(torch.tensor([toks[-1]], dtype=torch.int32),
                                 torch.from_numpy(pos), torch.from_numpy(table[None]), k, v)
        jn, jk, jv = jstep(lm.jvars, jnp.asarray([toks[-1]], jnp.int32), jnp.asarray(pos),
                           jnp.asarray(table[None]), jk, jv)
        logits.append(lg[0])
        toks.append(int(torch.argmax(lg[0])))
        assert toks[-1] == int(jn[0])
    # the JAX forward over the same ten tokens: the logits at positions 7-9
    ids = np.concatenate([chunk, toks[:2]]).astype(np.int32)[None]
    jspec = jmodels.get_model("transformer_lm", seq_len=10, vocab=VOCAB, d_model=32, d_inner=64,
                              num_heads=4, n_layers=2, **VARIANTS[variant])
    (_, _, jlogits), _ = jspec.model.apply(lm.jvars, jnp.asarray(ids), jnp.asarray(ids),
                                           is_train=False)
    np.testing.assert_allclose(torch.stack(logits).numpy(), np.asarray(jlogits)[0, 7:10],
                               rtol=0, atol=LOGITS_ATOL)
    whole = (lambda t: torch.cat(t, 2)) if kv_split else (lambda t: t[0])
    used = table[:3]  # positions 0-9 live on the table's first three pages
    for mine, theirs in ((whole(k), jk), (whole(v), jv)):
        np.testing.assert_allclose(mine[:, used].numpy(), np.asarray(theirs)[:, used], rtol=0,
                                   atol=LOGITS_ATOL)
    if not kv_split:  # replicated pages: bit-equal copies on the members
        assert torch.equal(k[0], k[1]) and torch.equal(v[0], v[1])


def test_group_replicated_hidden_states_bit_equal():
    """The row-parallel sums are copied to every member, so the replicated
    hidden states after the last layer are bit-equal across members (four
    members here)."""
    lm = _build()
    group = _group(tp=4)
    pshape = tlm.paged_cache_shape(lm.cfg, DC["num_pages"], DC["page_size"])
    mshape = pshape[:2] + (1,) + pshape[3:]
    dec = tlm.GroupPagedDecoder(default_layout().shard_params(group, lm.params),
                                {n: t.shape for n, t in lm.params.items()}, lm.cfg,
                                DC["page_size"], 10, True)
    k = [torch.zeros(mshape) for _ in range(4)]
    v = [torch.zeros(mshape) for _ in range(4)]
    tables = torch.arange(1, 11, dtype=torch.int32)[None]
    with torch.no_grad():
        xs = dec.run(torch.tensor([[5, 9, 17]], dtype=torch.int32),
                     torch.tensor([[0, 1, 2]], dtype=torch.int32), tables, k, v)
    assert len(xs) == 4 and all(torch.equal(xs[0], x) for x in xs[1:])
    assert [tuple(t.shape[2:3]) for t in k] == [(1,)] * 4


# ---- placement ---------------------------------------------------------------


@pytest.mark.parametrize("variant", ["mha", "gqa1"])
def test_member_blocks_match_jax_layout(variant):
    """Each member's block shape equals the JAX ``GroupLayout``'s on a
    ``tp_submesh`` over two of the eight virtual devices; so does the KV
    page spec."""
    lm = _build(variant)
    group, layout, jlayout = _group(), default_layout(), jsg.default_layout()
    jmesh = jtp_submesh(jax.devices()[:2])
    members = layout.shard_params(group, lm.params)
    assert len(members) == 2
    for name, t in lm.params.items():
        jspec = jlayout.param_spec(name, tuple(t.shape), jmesh)
        assert tuple(layout.param_spec(name, tuple(t.shape), group.mesh)) == \
            tuple(jspec) + (None,) * (t.dim() - len(jspec))
        want = tuple(s // 2 if a == TP_AXIS else s
                     for s, a in zip(t.shape, tuple(jspec) + (None,) * t.dim()))
        for m, mp in enumerate(members):
            assert tuple(mp[name].shape) == want, name
            assert mp[name].device == group.devices[m]
    pshape = tlm.paged_cache_shape(lm.cfg, DC["num_pages"], DC["page_size"])
    assert tuple(layout.kv_page_spec(pshape, group.mesh)) == \
        tuple(jlayout.kv_page_spec(pshape, jmesh))
    assert members[0]["layer_0/self_attn/q/w"].shape == (32, 16)
    assert members[1]["layer_0/self_attn/out/w"].shape == (16, 32)
    assert members[0]["project/logits/w"].shape == (32, VOCAB)  # 97 does not divide


def test_make_groups_slices_devices_in_order():
    devs = [torch.device("cpu")] * 4
    groups = make_groups(2, devs)
    assert [g.tp for g in groups] == [2, 2] and [len(g) for g in groups] == [2, 2]
    assert groups[0].name == "group0" and groups[1].name == "group1"
    assert groups[0].devices == (torch.device("cpu"),) * 2
    assert groups[0].mesh.shape == {TP_AXIS: 2} and groups[0].mesh.local
    assert ReplicaGroup(devs[:3]).name == "group[cpu,cpu,cpu]"
    assert partition_devices(2, devs[:3]) == [tuple(devs[:2])]
    with pytest.raises(EnforceError):
        partition_devices(0, devs)
    with pytest.raises(EnforceError):
        ReplicaGroup(())


def test_make_groups_without_devices_needs_cards():
    """``make_groups`` defaults to every visible card: with fewer than
    ``tp`` (none here) it raises rather than falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    with pytest.raises(EnforceError, match="CUDA devices"):
        make_groups(2)


def test_manifest_name_carries_the_degree():
    lm = _build()
    eng = _engine(lm, group=_group(), warmup=False)
    try:
        assert eng._manifest_name() == "decode_L2_D32_S3_P4_C8_tp2"
    finally:
        eng.close(timeout=flm.WAIT_S)


# ---- the layout lint at engine init -----------------------------------------


def test_engine_init_rejects_bad_layout_before_placement(monkeypatch):
    lm = _build()
    placed = []
    monkeypatch.setattr(GroupLayout, "shard_params",
                        lambda self, *a: placed.append(1) or [])
    bad = GroupLayout(rules=(("*/self_attn/qq/w", P(None, TP_AXIS)),), optional=())
    with pytest.raises(EnforceError, match="shard-dead-rule"):
        DecodeEngine(lm.params, lm.cfg, decode=DecodeConfig(**DC), group=_group(), layout=bad)
    assert placed == []  # raised before any parameter was placed


def test_engine_init_lint_layout_off_places_anyway():
    """With the lint off the dead rule places every parameter replicated,
    and the group still serves token-exactly."""
    lm = _build()
    bad = GroupLayout(rules=(("*/self_attn/qq/w", P(None, TP_AXIS)),), optional=())
    eng = DecodeEngine(lm.params, lm.cfg, decode=DecodeConfig(lint_layout=False, **DC),
                       group=_group(), layout=bad)
    try:
        assert bad.shard_params(eng.group, lm.params)[1]["layer_0/self_attn/q/w"].shape == \
            (32, 32)
        # member 1 computes with its two query heads of the whole weight
        assert torch.equal(eng._model.members[1]["layer_0/self_attn/q/w"],
                           lm.params["layer_0/self_attn/q/w"][:, 16:])
        assert _tokens([eng.submit(p, n) for p, n, _ in lm.cases[:1]]) == _refs(lm)[:1]
    finally:
        eng.close(timeout=flm.WAIT_S)


def _wide_layout() -> GroupLayout:
    """The default layout, plus rules that cut what no member computes
    with as a block: the embedding's and the logits' vocabulary, the layer
    norms, the out/fc2 biases, and q's rows (in place of its columns)."""
    cuts = (("emb/embedding/word_emb", P(TP_AXIS, None)),
            ("project/logits/w", P(None, TP_AXIS)),
            ("*layer_norm*", P(TP_AXIS)),
            ("*/self_attn/out/b", P(TP_AXIS)),
            ("*/ffn/fc2/b", P(TP_AXIS)),
            ("*/self_attn/q/w", P(TP_AXIS, None)))
    return GroupLayout(rules=cuts + tuple(r for r in _TRANSFORMER_LM_RULES
                                          if r[0] != "*/self_attn/q/w"))


def test_group_serves_a_layout_that_cuts_emb_ln_and_logits():
    """At a vocabulary tp divides, a layout that shards the embedding, the
    layer norms and the logits passes the lint and is placed as written;
    each member gathers those whole once at placement, and the group
    serves the JAX ``generate()`` tokens."""
    lm = _build("even_vocab")
    layout, group = _wide_layout(), _group()
    blocks = layout.shard_params(group, lm.params)
    for name, cut in (("emb/embedding/word_emb", (48, 32)), ("project/logits/w", (32, 48)),
                      ("layer_norm/scale", (16,)), ("layer_1/layer_norm_1/bias", (16,)),
                      ("layer_0/self_attn/out/b", (16,)), ("layer_0/self_attn/q/w", (16, 32))):
        assert tuple(blocks[1][name].shape) == cut, name
    eng = DecodeEngine(lm.params, lm.cfg, decode=DecodeConfig(**DC), group=group, layout=layout)
    try:
        for m, held in enumerate(eng._model.members):
            for name in ("emb/embedding/word_emb", "project/logits/w", "layer_norm/scale",
                         "layer_0/self_attn/out/b", "layer_1/ffn/fc2/b"):
                assert torch.equal(held[name], lm.params[name]), (m, name)
            assert torch.equal(held["layer_0/self_attn/q/w"],
                               lm.params["layer_0/self_attn/q/w"][:, 16 * m:16 * (m + 1)])
        assert _tokens([eng.submit(p, n) for p, n, _ in lm.cases]) == _refs(lm)
        assert eng.decode_step_cache_size() == 1
    finally:
        eng.close(timeout=flm.WAIT_S)
    eng.kv.assert_no_leaks()


def test_group_engine_runs_on_its_members_without_fallback():
    """A group engine runs on its members: a ``device=`` other than member
    0 raises, and so do CUDA members without CUDA (no CPU fallback)."""
    lm = _build()
    with pytest.raises(EnforceError, match="member 0"):
        DecodeEngine(lm.params, lm.cfg, decode=DecodeConfig(**DC), group=_group(),
                     device="meta")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            DecodeEngine(lm.params, lm.cfg, decode=DecodeConfig(**DC),
                         group=ReplicaGroup([torch.device("cuda", 0)] * 2))


# ---- handoff across groups ---------------------------------------------------


@pytest.mark.parametrize("transport", ["device", "serialized"])
def test_same_degree_handoff_adopts_pages(transport):
    """tp=2 prefill group → tp=2 decode group (pages split on heads): the
    gathered whole pages implant directly into the decode group's members
    — no re-prefill."""
    lm = _build("gqa")
    pre = _engine(lm, group=_group(0), label=f"pre-g0-{transport}")
    dec = _engine(lm, group=_group(1), label=f"dec-g1-{transport}")
    router = DisaggRouter([pre, dec], [PREFILL, DECODE], transport=transport)
    try:
        assert _tokens([router.submit(p, n) for p, n, _ in lm.cases]) == _refs(lm)
        snap = dec.metrics.snapshot()
        assert snap["handoffs_in_total"] == len(lm.cases), snap
        assert snap["recovered_total"] == 0, snap
    finally:
        router.close(flm.WAIT_S)
    pre.kv.assert_no_leaks()
    dec.kv.assert_no_leaks()


@pytest.mark.parametrize("transport", ["device", "serialized"])
def test_cross_degree_handoff_degrades_to_reprefill(transport):
    """tp=2 prefill → tp=1 decode: another degree's pages are refused and
    the decode worker re-prefills, token-exact."""
    lm = _build()
    pre = _engine(lm, group=_group(), label=f"pre-tp2-{transport}")
    dec = _engine(lm, label=f"dec-tp1-{transport}")
    router = DisaggRouter([pre, dec], [PREFILL, DECODE], transport=transport)
    try:
        assert _tokens([router.submit(p, n) for p, n, _ in lm.cases]) == _refs(lm)
        snap = dec.metrics.snapshot()
        assert snap["handoffs_in_total"] == 0, snap
        assert snap["recovered_total"] == len(lm.cases), snap
    finally:
        router.close(flm.WAIT_S)
    pre.kv.assert_no_leaks()
    dec.kv.assert_no_leaks()


# ---- per-member canary + straggler localization -------------------------------


def test_probe_members_times_every_shard():
    times = probe_members(_group(), engine_label="probe-test")
    assert sorted(times) == [0, 1] and all(t >= 0.0 for t in times.values())


def test_probe_members_fault_targets_one_shard():
    hit = []
    with faults.injected(faults.FaultSpec(faults.GROUP_MEMBER, "error",
                                          match={"shard": 1})) as plan:
        with pytest.raises(OSError):
            probe_members(_group(), engine_label="probe-test")
        assert plan.all_fired()
        hit.append(plan.specs[0].hits)
    assert hit == [1]  # shard 0 passed the point without matching


def test_straggler_watch_localizes_slow_shard():
    watch = GroupStragglerWatch(_group(), ratio=4.0, min_samples=3)
    flagged = None
    for _ in range(8):
        skew, shard = watch.observe({0: 0.001, 1: 0.050})
        if shard is not None:
            flagged = shard
    assert flagged == 1 and skew > 4.0


def test_straggler_watch_quiet_when_balanced():
    watch = GroupStragglerWatch(_group(), ratio=4.0, min_samples=3)
    for _ in range(8):
        skew, shard = watch.observe({0: 0.002, 1: 0.002})
        assert shard is None
    assert skew == pytest.approx(1.0, abs=0.5)


def test_engine_probe_flags_a_stalled_member():
    """A ``stall`` on member 1's canary is flagged at that shard index by
    the engine's straggler watch (``serving.group.shard_stragglers_total``,
    the ``shard_skew`` gauge)."""
    lm = _build()
    eng = _engine(lm, group=_group(), label="stall-g0", group_probe_every_s=0.0,
                  group_skew_ratio=2.0)
    try:
        with faults.injected(faults.FaultSpec(faults.GROUP_MEMBER, "stall", stall_s=0.01,
                                              match={"engine": "stall-g0", "shard": 1})):
            deadline = time.monotonic() + flm.WAIT_S
            while (eng.metrics.snapshot()["shard_stragglers_total"] == 0
                   and time.monotonic() < deadline):
                time.sleep(0.01)
        assert eng.metrics.snapshot()["shard_stragglers_total"] >= 1
        assert eng._straggler.observe({})[1] == 1
    finally:
        eng.close(timeout=flm.WAIT_S)


# ---- DecodeFleet.from_groups ----------------------------------------------------


def test_from_groups_member_fault_migrates_and_readmits():
    """ONE member's canary fault ejects the WHOLE group (breaker trip),
    every live request finishes token-exactly on the other group, and the
    half-open probe re-admits the group once the member heals."""
    lm = _build()
    fleet = DecodeFleet.from_groups(lm.params, lm.cfg, make_groups(2, devices=CPU4),
                                    decode=DecodeConfig(group_probe_every_s=0.0, **DC))
    ga, gb = fleet.engines
    try:
        assert [e.metrics.engine_label for e in fleet.engines] == ["group0", "group1"]
        handles = [ga.submit(p, n) for p, n, _ in lm.cases]  # pinned to A
        chunks = sum(-(-len(p) // DC["prefill_chunk"]) for p, _, _ in lm.cases)
        deadline = time.monotonic() + flm.WAIT_S
        while (ga.metrics.snapshot()["prefill_chunks_total"] < chunks
               and time.monotonic() < deadline):
            time.sleep(0.002)
        with faults.injected(faults.FaultSpec(
                faults.GROUP_MEMBER, "error", times=1,
                match={"engine": ga.metrics.engine_label, "shard": 1})) as plan:
            assert _tokens(handles) == _refs(lm)
            assert plan.all_fired()
        assert ga.breaker.state == OPEN
        snap = ga.metrics.snapshot()
        assert snap["group_member_faults_total"] == 1, snap
        assert snap["migrated_total"] == len(lm.cases), snap
        assert snap["errors_total"] == 0 and gb.metrics.snapshot()["errors_total"] == 0
        assert gb.decode_step_cache_size() == 1
        deadline = time.monotonic() + 30
        p, n, ref = lm.cases[0]
        while time.monotonic() < deadline and ga.breaker.state != CLOSED:
            assert _tokens([fleet.submit(p, n)]) == [ref.tolist()]
            time.sleep(0.02)
        assert ga.breaker.state == CLOSED
    finally:
        fleet.close(timeout=flm.WAIT_S)
    for e in fleet.engines:
        e.kv.assert_no_leaks()
