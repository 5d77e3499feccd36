"""The port's static sharding-layout analyzer
(``paddle_tpu_torch/analysis/shard_analysis.py``) against the JAX
package's, on the same shapes, rule tables and mesh sizes.

Each case builds one layout in both packages (the JAX package's
``PartitionSpec`` and the port's ``P``) and holds the port's diagnostics
— ``(code, severity, where)``, in order — and its ``tp_comm_report`` equal
to the JAX module's, for each of the six codes: ``shard-dead-rule``,
``shard-rank-mismatch``, ``shard-silent-degrade`` (its memory cost in the
message too), ``shard-unknown-axis``, ``shard-conflict`` and
``shard-kv-geometry``. Whole-model analysis compares the port's ``meta``
init with ``jax.eval_shape``; the engine hook raises before placement.
"""

import torch_threads  # noqa: F401  (first: its share of the cores)
import jax
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from paddle_tpu.analysis import shard_analysis as jsa
from paddle_tpu.serving import shardgroup as jsg
from paddle_tpu_torch.analysis import shard_analysis as tsa
from paddle_tpu_torch.core import logging as ptlog
from paddle_tpu_torch.core import profiler as prof
from paddle_tpu_torch.core.enforce import EnforceError
from paddle_tpu_torch.parallel.mesh import tp_submesh
from paddle_tpu_torch.parallel.sharding import P, degrade_spec
from paddle_tpu_torch.serving import shardgroup as tsg

TP4 = {"tp": 4}

PARAMS = {
    "layer_0/self_attn/q/w": (512, 512),
    "layer_0/self_attn/q/b": (512,),
    "layer_0/self_attn/out/w": (512, 512),
    "layer_0/ffn/fc1/w": (512, 2048),
    "layer_0/ffn/fc2/w": (2048, 512),
    "emb/embedding/word_emb": (97, 512),
}
KV_SHAPE = (2, 14, 4, 4, 8)  # [L, num_pages, H_kv, page_size, dh]
KV_GEO = {"num_pages": 14, "page_size": 4, "max_slots": 3, "pages_per_slot": 10}


def _pair(rules, optional=(), kv_rule=None):
    """One layout in each package: (port, JAX)."""
    tl = tsg.GroupLayout(rules=tuple((pat, P(*spec)) for pat, spec in rules), optional=optional,
                         kv_rule=None if kv_rule is None else P(*kv_rule))
    jl = jsg.GroupLayout(rules=tuple((pat, JP(*spec)) for pat, spec in rules), optional=optional,
                         kv_rule=None if kv_rule is None else JP(*kv_rule))
    return tl, jl


def _key(diags):
    return [(d.code, d.severity, d.where) for d in diags]


LAYOUT_CASES = {
    "clean": (dict(rules=[("*/self_attn/q/w", (None, "tp")),
                          ("*/self_attn/out/w", ("tp", None))]), TP4, []),
    "dead_rule": (dict(rules=[("*/self_attn/qq/w", (None, "tp")),
                              ("*/self_attn/q/w", (None, "tp"))]), TP4, ["shard-dead-rule"]),
    "optional_exempt": (dict(rules=[("*/ffn/gate/w", (None, "tp")),
                                    ("*/self_attn/q/w", (None, "tp"))],
                             optional=("*/ffn/gate/w",)), TP4, []),
    "rank_mismatch": (dict(rules=[("*/self_attn/q/b", (None, "tp"))]), TP4,
                      ["shard-rank-mismatch"]),
    "silent_degrade": (dict(rules=[("emb/*", ("tp", None))]), TP4, ["shard-silent-degrade"]),
    "unknown_axis": (dict(rules=[("*/self_attn/q/w", (None, "model"))]), TP4,
                     ["shard-unknown-axis"]),
    "every_offender": (dict(rules=[("*/self_attn/qq/w", (None, "tp")),
                                   ("*/self_attn/q/b", (None, "tp")),
                                   ("emb/*", ("tp", None)),
                                   ("*/self_attn/q/w", (None, "mp"))]), TP4,
                       ["shard-dead-rule", "shard-rank-mismatch", "shard-silent-degrade",
                        "shard-unknown-axis"]),
    # the shipped layout over a partial tree: its k/v and fc1-bias rules
    # match nothing here; at tp=3 every split dim also degrades
    "default_tp2": (None, {"tp": 2}, ["shard-dead-rule"] * 5),
    "default_tp3": (None, {"tp": 3}, ["shard-dead-rule"] * 5 + ["shard-silent-degrade"] * 5),
}


@pytest.mark.parametrize("case", list(LAYOUT_CASES))
def test_analyze_layout_equals_jax(case):
    spec, axes, codes = LAYOUT_CASES[case]
    tl, jl = (tsg.default_layout(), jsg.default_layout()) if spec is None else _pair(**spec)
    got = tsa.analyze_layout(PARAMS, tl, axes, where="lay")
    want = jsa.analyze_layout(PARAMS, jl, axes, where="lay")
    assert _key(got) == _key(want)
    assert sorted(d.code for d in got) == sorted(codes)
    for g, w in zip(got, want):  # the degrade's memory cost, the axis, the names
        if g.code in ("shard-silent-degrade", "shard-unknown-axis", "shard-rank-mismatch"):
            assert g.message == w.message


def test_silent_degrade_costs_what_jax_reports():
    tl, _ = _pair([("emb/*", ("tp", None))])
    (d,) = tsa.analyze_layout(PARAMS, tl, TP4)
    assert d.severity == "warning" and "145.5KiB" in d.message


def test_bare_rule_table_is_accepted():
    got = tsa.analyze_layout(PARAMS, (("*/nope", P("tp")),), TP4)
    want = jsa.analyze_layout(PARAMS, (("*/nope", JP("tp")),), TP4)
    assert _key(got) == _key(want) == [("shard-dead-rule", "error", "layout:rule[0]")]


KV_CASES = {
    "default_passes": (dict(rules=[]), {"tp": 2}, KV_SHAPE, []),
    "page_ids_sharded": (dict(rules=[], kv_rule=(None, "tp", None, None, None)), {"tp": 2},
                         KV_SHAPE, ["shard-kv-geometry"]),
    "offsets_sharded": (dict(rules=[], kv_rule=(None, None, None, "tp", None)), {"tp": 2},
                        KV_SHAPE, ["shard-kv-geometry"]),
    "shape_vs_geometry": (dict(rules=[]), {"tp": 2}, (2, 99, 4, 4, 8), ["shard-kv-geometry"]),
    "heads_non_divisible": (dict(rules=[]), {"tp": 3}, KV_SHAPE, ["shard-silent-degrade"]),
}


@pytest.mark.parametrize("case", list(KV_CASES))
def test_kv_geometry_equals_jax(case):
    spec, axes, shape, codes = KV_CASES[case]
    tl, jl = _pair(**spec)
    got = tsa.analyze_layout({}, tl, axes, kv_page_shape=shape, kv_geometry=KV_GEO)
    want = jsa.analyze_layout({}, jl, axes, kv_page_shape=shape, kv_geometry=KV_GEO)
    assert _key(got) == _key(want)
    assert [d.code for d in got] == codes
    assert [d.message for d in got] == [d.message for d in want]


def test_conflicting_layouts_equal_jax():
    (ts, js), (tt, jt) = _pair([("*/q/w", (None, "tp"))]), _pair([("*/q/w", ("tp", None))])
    got = tsa.compare_layouts({"serving": ts, "training": tt}, PARAMS, TP4)
    want = jsa.compare_layouts({"serving": js, "training": jt}, PARAMS, TP4)
    assert _key(got) == _key(want) == [("shard-conflict", "error", "layer_0/self_attn/q/w")]
    assert "serving" in got[0].message and "training" in got[0].message
    # textually different rules, the same effective spec after the degrade
    (ta, _), (tb, _) = _pair([("emb/*", ("tp", None))]), _pair([])
    assert tsa.compare_layouts({"a": ta, "b": tb}, {"emb/embedding/word_emb": (97, 512)},
                               TP4) == []


@pytest.mark.parametrize("axes", [TP4, {"tp": 1}, {"tp": 2}], ids=["tp4", "tp1", "tp2"])
def test_comm_report_equals_jax(axes):
    got = tsa.tp_comm_report(PARAMS, tsg.default_layout(), axes)
    want = jsa.tp_comm_report(PARAMS, jsg.default_layout(), axes)
    assert [tuple(vars(b).values()) for b in got.boundaries] == \
        [tuple(vars(b).values()) for b in want.boundaries]
    assert (got.tp, got.total_payload_bytes, got.total_wire_bytes) == \
        (want.tp, want.total_payload_bytes, want.total_wire_bytes)
    assert got.format() == want.format()
    # a row-parallel weight whose dim 0 the axis does not divide never reduces
    tl, _ = _pair([("emb/*", ("tp", None))])
    assert tsa.tp_comm_report({"emb/embedding/word_emb": (97, 512)}, tl, TP4).boundaries == ()


def test_eval_param_shapes_equals_jax():
    dims = dict(d_model=32, d_inner=64, num_heads=4, n_layers=2, vocab=97, max_len=64,
                num_kv_heads=2, ffn_activation="swiglu")
    got, tcfg = tsa.eval_param_shapes(**dims)
    want, jcfg = jsa.eval_param_shapes(**dims)
    assert {n: tuple(t.shape) for n, t in got.items()} == \
        {n: tuple(s.shape) for n, s in want.items()}
    assert all(t.device.type == "meta" for t in got.values())
    assert tcfg == jcfg


@pytest.mark.parametrize("tp", [1, 2, 4])
def test_default_layout_is_clean_on_transformer_lm(tp):
    diags, report = tsa.analyze_model(tp=tp)
    assert diags == []
    assert len(report.boundaries) == 12  # 2 row-parallel weights x 6 layers


def test_analyze_model_flags_seeded_bad_layout_as_jax():
    rules = [("*/self_attn/qq/w", (None, "tp")), ("*/self_attn/q/b", (None, "tp"))]
    tl, jl = _pair(rules)
    small = dict(d_model=32, d_inner=64, num_heads=4, n_layers=2, vocab=97, max_len=64)
    got, treport = tsa.analyze_model(tp=2, layout=tl, **small)
    want, jreport = jsa.analyze_model(tp=2, layout=jl, **small)
    assert _key(got) == _key(want)
    assert sum(d.code == "shard-rank-mismatch" for d in got) == 2
    assert treport.format() == jreport.format()


def test_lint_group_layout_or_raise_raises_on_errors():
    tl, _ = _pair([("*/nope", ("tp",))])
    with pytest.raises(EnforceError, match="shard-dead-rule"):
        tsa.lint_group_layout_or_raise(PARAMS, tl, tp_submesh([torch.device("cpu")]),
                                       where="test")


def test_lint_group_layout_or_raise_warns_but_returns_on_warnings():
    ptlog.reset_warn_once()
    tl, jl = _pair([("*/q/w", (None, "model"))])
    got = tsa.lint_group_layout_or_raise(PARAMS, tl, tp_submesh([torch.device("cpu")]),
                                         where="test")
    want = jsa.lint_group_layout_or_raise(PARAMS, jl, jax.make_mesh((1,), ("tp",)),
                                          where="test")
    assert _key(got) == _key(want) == [("shard-unknown-axis", "warning", "layer_0/self_attn/q/w")]


def test_runtime_degrade_counter_agrees_with_static_report():
    """What the analyzer reports as shard-silent-degrade is exactly what
    degrade_spec counts at runtime."""
    ptlog.reset_warn_once()
    prof.reset_metrics()
    mesh = tp_submesh([torch.device("cpu")] * 4)
    assert degrade_spec(mesh, P("tp", None), (97, 512), name="emb") == P(None, None)
    assert prof.counters().get("sharding.degraded_total") == 1.0
    degrade_spec(mesh, P("tp", None), (97, 512), name="emb")
    assert prof.counters().get("sharding.degraded_total") == 2.0
    tl, _ = _pair([("emb", ("tp", None))])
    assert [d.code for d in tsa.analyze_layout({"emb": (97, 512)}, tl, {"tp": 4})] == \
        ["shard-silent-degrade"]
    # the documented any-mesh fallback (a missing axis) neither counts nor warns
    prof.reset_metrics()
    assert degrade_spec(tp_submesh([torch.device("cpu")]), P("data", None), (8, 8),
                        name="w") == P(None, None)
    assert "sharding.degraded_total" not in prof.counters()
