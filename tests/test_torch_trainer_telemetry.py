"""The port's Trainer under the telemetry stack, held against the JAX
package's Trainer on the CPU.

A 4-step small-LM run in each package, with tracing on, a run log and an
exporter on an ephemeral port, and one NaN injected at step 2 under
``nan_policy="skip_step"``: each step's span names and parents, the run
log's event kinds in order, the metric families the run wrote with their
label keys (scraped from ``/metrics``), and the badput categories must be
the same (XLA's second compile of the step, at step 1, aside). The port's
step FLOP count (``observability.mfu.CostCounter``, the flash wrapper
reporting its kernels' share) equals the analytic count exactly; against XLA's ``cost_analysis`` FLOPs of the same step with flash
off the ratio is held at 0.9516 ± 0.005 (XLA also counts elementwise work;
the port counts products only). The ``trainer.mfu`` gauge is the counted
FLOPs over the last step's seconds times the peak.
"""

import json
import urllib.request

import jax
import numpy as np
import pytest
import torch

from paddle_tpu import models as jmodels
from paddle_tpu import observability as jobs
from paddle_tpu import tracing as jtracing
from paddle_tpu import trainer as jtrainer
from paddle_tpu.core import config as jconfig
from paddle_tpu.core import profiler as jprof
from paddle_tpu.observability import exporter as jexporter
from paddle_tpu.observability import mfu as jmfu
from paddle_tpu.resilience import ResilienceConfig as JResilienceConfig
from paddle_tpu.resilience import faults as jfaults
from paddle_tpu_torch import models as tmodels
from paddle_tpu_torch import observability as tobs
from paddle_tpu_torch import tracing as ttracing
from paddle_tpu_torch.core import config as tconfig
from paddle_tpu_torch.core import profiler as tprof
from paddle_tpu_torch.observability import exporter as texporter
from paddle_tpu_torch.observability import mfu as tmfu
from paddle_tpu_torch.observability import runlog as trunlog
from paddle_tpu_torch.resilience import ResilienceConfig, faults
from paddle_tpu_torch.trainer import EndStepEvent, Trainer

SMALL_LM = dict(seq_len=64, vocab=512, d_model=64, d_inner=128, num_heads=4, n_layers=2)
STEPS = 4
NAN_STEP = 2
# the families a Trainer step writes (other tests' writes are filtered out)
PREFIXES = ("trainer.", "executor.", "device.", "resilience.", "faults.")
JAX_FLOPS_RATIO = 0.9516  # port (products) / XLA (everything), flash off


@pytest.fixture
def both_flags():
    names = ("use_flash_attention", "use_bf16_compute", "check_nan_inf")
    saved_j = {f: getattr(jconfig.flags(), f) for f in names}
    saved_t = {f: getattr(tconfig.flags(), f) for f in names}
    yield lambda **kw: (jconfig.set_flags(**kw), tconfig.set_flags(**kw))
    jconfig.set_flags(**saved_j)
    tconfig.set_flags(**saved_t)
    jfaults.clear()
    faults.clear()


def _batches():
    jspec = jmodels.get_model("transformer_lm", **SMALL_LM)
    rng = np.random.RandomState(0)
    return [tuple(np.asarray(a) for a in jspec.synth_batch(2, rng)) for _ in range(STEPS)]


def _scrape(url):
    with urllib.request.urlopen(url + "/metrics", timeout=10) as r:
        return r.read().decode()


def _families(text, parse):
    """{family: sorted label keys} of the run's families in a scrape."""
    out = {}
    for name, fam in parse(text).items():
        if not name.replace("_", ".").startswith(PREFIXES) or not fam["samples"]:
            continue
        keys = set()
        for _, labels, _ in fam["samples"]:
            keys |= set(labels) - {"le"}
        out[name] = sorted(keys)
    return out


def _step_trees(spans):
    """Per step trace, sorted (span name, parent name) pairs."""
    by_trace = {}
    for s in spans:
        by_trace.setdefault(s.context.trace_id, []).append(s)
    trees = []
    for group in by_trace.values():
        names = {s.context.span_id: s.name for s in group}
        root = [s for s in group if s.context.parent_id is None]
        if len(root) != 1 or root[0].name != "trainer.step":
            continue
        trees.append((root[0].t0_us, sorted(
            (s.name, names.get(s.context.parent_id)) for s in group)))
    return [t for _, t in sorted(trees)]


def _run_jax(tmp_path, batches):
    jprof.reset_metrics()
    jtracing.reset_tracing()
    jtracing.enable_tracing()
    spec = jmodels.get_model("transformer_lm", **SMALL_LM)
    cfg = jobs.ObservabilityConfig(metrics_port=0, runlog_path=str(tmp_path / "jax.jsonl"))
    t = jtrainer.Trainer(lambda: spec.model, spec.optimizer, observability=cfg,
                         resilience=JResilienceConfig(nan_policy="skip_step"))
    try:
        with jfaults.injected(jfaults.FaultSpec(jfaults.TRAINER_STEP, "nan", after=NAN_STEP,
                                                times=1)):
            t.train(num_epochs=1, reader=lambda: iter(batches))
        text = _scrape(jobs.server().url)
    finally:
        jobs.shutdown()
    events = [json.loads(line)["kind"] for line in open(tmp_path / "jax.jsonl")]
    return t, _step_trees(jtracing.spans()), events, _families(text, jexporter.parse_text_exposition)


def _run_port(tmp_path, batches):
    tprof.reset_metrics()
    ttracing.reset_tracing()
    ttracing.enable_tracing()
    spec = tmodels.get_model("transformer_lm", device="cpu", **SMALL_LM)
    cfg = tobs.ObservabilityConfig(metrics_port=0, runlog_path=str(tmp_path / "port.jsonl"))
    t = Trainer(lambda: spec.model, spec.optimizer, place="cpu", observability=cfg,
                resilience=ResilienceConfig(nan_policy="skip_step"))
    losses = []
    try:
        with faults.injected(faults.FaultSpec(faults.TRAINER_STEP, "nan", after=NAN_STEP,
                                              times=1)):
            t.train(num_epochs=1, reader=lambda: iter(batches),
                    event_handler=lambda ev: losses.append(ev.metrics)
                    if isinstance(ev, EndStepEvent) else None)
        text = _scrape(tobs.server().url)
    finally:
        tobs.shutdown()
    events = [e["kind"] for e in trunlog.read_runlog(str(tmp_path / "port.jsonl"))]
    families = _families(text, texporter.parse_text_exposition)
    return t, _step_trees(ttracing.spans()), events, families, losses


@pytest.mark.parametrize("flash", [False, True], ids=["composed", "flash"])
def test_trainer_telemetry_matches_jax(tmp_path, both_flags, flash):
    both_flags(use_flash_attention=flash, use_bf16_compute=False, check_nan_inf=False)
    batches = _batches()
    jt, j_trees, j_events, j_fams = _run_jax(tmp_path, batches)
    tt, t_trees, t_events, t_fams, losses = _run_port(tmp_path, batches)

    assert len(t_trees) == len(j_trees) == STEPS
    # XLA compiles the step twice: step 0 takes the init's uncommitted
    # arrays, step 1 the step's own device-committed outputs. The port
    # prepares once. Past that second compile the two runs are the same.
    compile_span = ("executor.compile", "trainer.step_compute")
    assert j_trees[1].count(compile_span) == 1 and j_events.count("compile") == 2
    j_trees[1].remove(compile_span)
    del j_events[j_events.index("compile", 1)]
    assert t_trees == j_trees
    # the first step's compile span sits under its step_compute span
    assert compile_span in t_trees[0]
    assert t_events == j_events
    assert t_events.count("step") == STEPS - 1 and "nan_skip" in t_events
    assert t_fams == j_fams
    assert t_fams["device_hbm_bytes_in_use"] == ["device"]
    assert set(tt.goodput.badput_by_category()) == set(jt.goodput.badput_by_category()) \
        == {"nan_skip"}
    assert tt.goodput.goodput_frac() < 1.0
    assert np.isnan(losses[NAN_STEP]) and all(np.isfinite(losses[i]) for i in (0, 1, 3))


def _analytic_step_flops(B, T):
    """6·P·T over the products' weights, plus the causal attention's two
    products forward (4·B·d·T(T+1)/2 a layer) and 2.5 times that backward."""
    d, di, V, L = (SMALL_LM[k] for k in ("d_model", "d_inner", "vocab", "n_layers"))
    P = L * (4 * d * d + 2 * d * di) + d * V
    attn = L * 4 * B * d * (T * (T + 1) // 2)
    return 6 * P * B * T + attn * 7 // 2


def test_step_flops_equal_the_analytic_count(both_flags):
    both_flags(use_flash_attention=True, use_bf16_compute=False, check_nan_inf=False)
    batches = _batches()
    spec = tmodels.get_model("transformer_lm", device="cpu", **SMALL_LM)
    t = Trainer(lambda: spec.model, spec.optimizer, place="cpu")
    t.train(num_epochs=1, reader=lambda: iter(batches[:2]))
    B, T = batches[0][0].shape
    assert t._step_flops == _analytic_step_flops(B, T)
    # the gauge is the last step's counted FLOPs over its seconds and the
    # CPU's nominal peak
    last = tprof.histograms()["trainer.step_seconds"]
    assert last["count"] >= 2
    mfu_gauge = tprof.gauges()["trainer.mfu"]
    step_s = t._step_flops / (mfu_gauge * tmfu.peak_flops("cpu"))
    assert last["min"] - 1e-9 <= step_s <= last["max"] + 1e-9


def test_step_flops_against_xla_cost_analysis(both_flags):
    """Flash off in both packages (XLA counts no Pallas call): the port
    counts the products, XLA every op, so the port's count is the smaller,
    by a stated ratio."""
    both_flags(use_flash_attention=False, use_bf16_compute=False, check_nan_inf=False)
    ids, labels = _batches()[0]
    jspec = jmodels.get_model("transformer_lm", **SMALL_LM)
    jv = jspec.model.init(jax.random.PRNGKey(0), ids, labels)
    jopt = jspec.optimizer()
    xla = jmfu.lowered_flops(jax.jit(jopt.minimize(jspec.model)), jv, jopt.create_state(jv.params),
                             ids, labels)
    tspec = tmodels.get_model("transformer_lm", device="cpu", **SMALL_LM)
    tids, tlabels = torch.from_numpy(ids), torch.from_numpy(labels)
    tv = tspec.model.init(0, tids, tlabels, device="cpu")
    topt = tspec.optimizer()
    with tmfu.CostCounter() as counter:
        topt.minimize(tspec.model)(tv, topt.create_state(tv.params), tids, tlabels)
    assert xla > 0
    assert abs(counter.flops / xla - JAX_FLOPS_RATIO) < 5e-3, counter.flops / xla
    assert counter.by_op.keys() == {"mm", "bmm"}


def test_parallel_trainer_counts_its_rows_step(both_flags):
    """Under parallel=True at one rank (no process group) the count is the
    rank's rows' step: the whole batch here, so the plain step's count."""
    both_flags(use_flash_attention=True, use_bf16_compute=False, check_nan_inf=False)
    batches = _batches()
    spec = tmodels.get_model("transformer_lm", device="cpu", **SMALL_LM)
    t = Trainer(lambda: spec.model, spec.optimizer, place="cpu", parallel=True)
    t.train(num_epochs=1, reader=lambda: iter(batches[:1]))
    B, T = batches[0][0].shape
    assert t._step_flops == _analytic_step_flops(B, T)
    assert tprof.gauges()["trainer.mfu"] > 0
