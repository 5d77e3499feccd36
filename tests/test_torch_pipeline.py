"""The port's pipeline parallelism over ``pipe`` on gloo ranks (CPU)
against the JAX package: ``pipeline_apply`` (the GPipe schedule, values
and gradients, with and without remat; microbatch rows split over
``data`` on ``pipe=2 x data=2``) against ``tests/test_parallel_extensions.py``'s
sequential, differentiable and remat cases, and the LM with ``pipe_mesh``
against ``tests/test_lm_pipeline.py``'s: the plain forward and every
parameter's gradient on every rank, remat, ``scan_layers`` subsumed,
``DataParallel`` on ``pipe=2`` and ``pipe=2 x data=2`` against the JAX
single-device step on the global batch, and the guards with the JAX
package's messages.

The JAX side runs ``pipeline_apply`` on its 8-device CPU mesh
(``pipe=2 x data=4``) and the plain LM on one device. The port's ranks run
one spawn of two gloo ranks and one of four (rank bodies in
``torch_parallel_cases.py``). Tolerances are the JAX tests': forward rtol
2e-4, atol 2e-5; gradients rtol 2e-4, atol 2e-4; LM losses rtol 1e-4
(1e-5 over three steps); parameters after three Adam steps atol 1e-4, the
attention k biases at the scheduled rates' sum.
"""

import torch_threads  # noqa: F401  (first: its share of the cores)
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_cases as cases
from paddle_tpu import models as jmodels
from paddle_tpu.core import config as jconfig
from paddle_tpu.framework import Variables as JVariables
from paddle_tpu.parallel.mesh import make_mesh as jmake_mesh
from paddle_tpu.parallel.pipeline import pipeline_apply as jpipeline_apply
from paddle_tpu.parallel.pipeline import split_microbatches as jsplit
from paddle_tpu.parallel.pipeline import stack_stage_params as jstack
from paddle_tpu_torch import models as tmodels
from paddle_tpu_torch.parallel import launch, make_mesh

FWD = dict(rtol=2e-4, atol=2e-5)
GRAD = dict(rtol=2e-4, atol=2e-4)
P2, P2D2 = dict(data=1, pipe=2), dict(pipe=2, data=2)


@pytest.fixture(scope="module", autouse=True)
def jax_composed():
    saved = (jconfig.flags().use_flash_attention, jconfig.flags().use_bf16_compute)
    jconfig.set_flags(use_flash_attention=False, use_bf16_compute=False)
    yield
    jconfig.set_flags(use_flash_attention=saved[0], use_bf16_compute=saved[1])


# -- pipeline_apply ----------------------------------------------------------------
def _apply_cases():
    """name -> (stage kind, per-stage params, x, n_micro, remat, w): the
    JAX tests' cases at two stages (their rows grown to split over data)."""
    rng = np.random.RandomState(0)
    out = {}

    def add(name, n_micro, mb, d, bias, remat):
        ps = [{"w": (rng.randn(d, d) * 0.3).astype(np.float32)} for _ in range(2)]
        if bias:
            for p in ps:
                p["b"] = (rng.randn(d) * 0.1).astype(np.float32)
        x = rng.randn(n_micro * mb, d).astype(np.float32)
        w = rng.randn(n_micro, mb, d).astype(np.float32)
        out[name] = ("tanh", ps, x, n_micro, remat, w)

    add("sequential", 8, 4, 16, True, False)
    add("differentiable", 4, 4, 8, False, False)
    out["remat"] = out["sequential"][:4] + (True,) + out["sequential"][5:]
    return out


@functools.lru_cache(maxsize=None)
def _jax_pipeline_of(name):
    return _jax_pipeline(_apply_cases()[name])


def _jax_pipeline(case):
    """The JAX package's outputs and the gradients of ``sum(w * out)`` in
    the input and the stacked parameters, on ``pipe=2 x data=4``."""
    _, ps, x, n_micro, remat, w = case
    mesh = jmake_mesh(pipe=2, data=4)

    def stage_fn(p, h):
        y = h @ p["w"] + p["b"] if "b" in p else h @ p["w"]
        return jnp.tanh(y)

    def f(x, sp):
        return jpipeline_apply(stage_fn, sp, jsplit(x, n_micro), mesh, remat=remat)

    def value_and_vjp(x, sp, w):
        out, vjp = jax.vjp(f, x, sp)
        return (out,) + vjp(w)

    stacked = jstack([{k: jnp.asarray(a) for k, a in p.items()} for p in ps])
    out, dx, dp = jax.jit(value_and_vjp)(jnp.asarray(x), stacked, jnp.asarray(w))
    out = np.asarray(out)
    seq = x
    for p in ps:  # the unpipelined computation
        seq = np.tanh(seq @ p["w"] + p.get("b", 0))
    return out, np.asarray(dx), {k: np.asarray(g) for k, g in dp.items()}, seq


# -- the LM --------------------------------------------------------------------------
def _lm_kw(**kw):
    return dict(cases.PIPE_LM, flash=True, **kw)


# name -> the LM's kwargs with the pipeline's (every case runs one batch
# of 8 rows and one set of weights, so one JAX run is their reference)
LM_CASES = {
    "fwd_bwd": _lm_kw(pipe_n_micro=4),
    "remat": _lm_kw(pipe_n_micro=2, remat=True),
    "scan_layers": _lm_kw(pipe_n_micro=2, scan_layers=True),
}


@functools.lru_cache(maxsize=None)
def _lm_inputs():
    spec = tmodels.get_model("transformer_lm", device="cpu", **cases.PIPE_LM)
    batch = tuple(b.numpy() for b in spec.synth_batch(8, np.random.RandomState(0)))
    v = spec.model.init(0, *(torch.from_numpy(b) for b in batch), device="cpu")
    return batch, {k: t.numpy() for k, t in v.params.items()}


@functools.lru_cache(maxsize=None)
def _jax_lm():
    """The JAX plain LM's training loss, logits and every gradient."""
    batch, params = _lm_inputs()
    spec = jmodels.get_model("transformer_lm", **cases.PIPE_LM)

    def loss(p):
        (l, _, logits), _ = spec.model.apply(JVariables(p, {}), *batch, is_train=True)
        return l, logits

    (value, logits), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        {k: jnp.asarray(a) for k, a in params.items()})
    return float(value), np.asarray(logits), {k: np.asarray(g) for k, g in grads.items()}


@functools.lru_cache(maxsize=None)
def _jax_steps():
    """``STEPS`` single-device steps of the JAX plain LM on the global batch."""
    batch, params = _lm_inputs()
    spec = jmodels.get_model("transformer_lm", **cases.PIPE_LM)
    opt = spec.optimizer()
    step = jax.jit(opt.minimize(spec.model))
    v = JVariables({k: jnp.asarray(a) for k, a in params.items()}, {})
    o = opt.create_state(v.params)
    losses = []
    for _ in range(cases.STEPS):
        out = step(v, o, *batch)
        v, o = out.variables, out.opt_state
        losses.append(float(out.loss))
    return losses, {k: np.asarray(a) for k, a in v.params.items()}


# DataParallel runs: name -> (mesh axes, kwargs, ranks)
DP_RUNS = {
    "pipe2": (P2, _lm_kw(pipe_n_micro=4), 2),
    "pipe2_remat": (P2, _lm_kw(pipe_n_micro=4, remat=True), 2),
    "pipe2_data2": (P2D2, _lm_kw(pipe_n_micro=4), 4),
}


@pytest.fixture(scope="module")
def pipe():
    apply_cases = _apply_cases()
    dp_batch, dp_params = _lm_inputs()
    lm_cases = {name: ("lm", kw, dp_batch, dp_params) for name, kw in LM_CASES.items()}

    def runs(n):
        return {name: (axes, "lm", kw, False, dp_batch, dp_params)
                for name, (axes, kw, ranks) in DP_RUNS.items() if ranks == n}

    two = {"apply": ("mp_pipeline", (P2, apply_cases)),
           "lm": ("mp_apply", (P2, lm_cases)),
           "dp": ("mp_dp_steps", (runs(2),))}
    four = {"apply": ("mp_pipeline", (P2D2, apply_cases)),
            "dp": ("mp_dp_steps", (runs(4),))}
    got2 = launch.spawn(cases.calls, 2, args=(two,), device="cpu")
    got4 = launch.spawn(cases.calls, 4, args=(four,), device="cpu")
    return dict(two=got2, four=got4)


@pytest.mark.parametrize("name", ["sequential", "differentiable", "remat"])
@pytest.mark.parametrize("where", ["two", "four"])
def test_pipeline_apply_matches_jax(pipe, where, name):
    """``pipeline_apply`` on ``pipe=2`` (two ranks) and ``pipe=2 x data=2``
    (four: the microbatch rows split over ``data``): the outputs on every
    rank, and the gradients in the input and the stacked parameters (whole
    on every rank: the backward sums the stages' over ``pipe``), against the JAX
    package's on ``pipe=2 x data=4`` and the unpipelined computation; the
    activations went point to point (gloo)."""
    out, dx, dp, seq = _jax_pipeline_of(name)
    np.testing.assert_allclose(out.reshape(seq.shape), seq, rtol=2e-5, atol=2e-6)
    for rank in pipe[where]:
        got = rank["apply"][name]
        np.testing.assert_allclose(got["out"], out, err_msg=name, **FWD)
        np.testing.assert_allclose(got["dx"], dx, err_msg=name, **GRAD)
        for k, g in got["grads"].items():
            np.testing.assert_allclose(g, dp[k], err_msg=f"{name} {k}", **GRAD)
        assert set(got["routes"]["ppermute"]) == {"gloo"}


def test_pipeline_remat_equals_plain(pipe):
    """``remat=True`` recomputes each step in the backward: values and
    gradients equal the plain schedule's on the same inputs (the JAX
    test's rtol 1e-5, atol 1e-6)."""
    for where in ("two", "four"):
        for rank in pipe[where]:
            plain, remat = rank["apply"]["sequential"], rank["apply"]["remat"]
            for key in ("out", "dx"):
                np.testing.assert_allclose(remat[key], plain[key], rtol=1e-5, atol=1e-6)
            for k, g in plain["grads"].items():
                np.testing.assert_allclose(remat["grads"][k], g, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name", list(LM_CASES))
def test_lm_pipeline_matches_plain_lm(pipe, name):
    """The LM with ``pipe_mesh`` on two ranks (global arrays on each): the
    loss, the logits (every stage holds them) and every parameter's
    gradient on every rank (the pipeline's backward sums the stages' over
    ``pipe``), against the JAX plain LM."""
    loss, logits, grads = _jax_lm()
    for rank in pipe["two"]:
        got = rank["lm"][name]
        np.testing.assert_allclose(got["loss"], loss, rtol=1e-4, err_msg=name)
        np.testing.assert_allclose(got["logits"], logits, err_msg=name, **FWD)
        assert set(got["grads"]) == set(grads)
        for k, g in got["grads"].items():
            np.testing.assert_allclose(g, grads[k], err_msg=f"{name} {k}", **GRAD)


@pytest.mark.parametrize("name", list(DP_RUNS))
def test_dataparallel_on_pipe_matches_jax_step(pipe, name):
    """Three Adam steps of ``DataParallel`` on ``pipe=2`` (with and without
    remat) and ``pipe=2 x data=2`` against the JAX single-device step on the
    global batch; every rank's parameters bit-equal (every gradient whole
    on every stage)."""
    losses, want = _jax_steps()
    opt = tmodels.get_model("transformer_lm", device="cpu", **cases.PIPE_LM).optimizer()
    lr = sum(opt.scheduler(t) for t in range(cases.STEPS))
    ranks = pipe["two"] if DP_RUNS[name][2] == 2 else pipe["four"]
    for rank in ranks:
        got = rank["dp"][name]
        np.testing.assert_allclose(got["losses"], losses, rtol=1e-5)
        for k, a in want.items():
            atol = lr if k.endswith("self_attn/k/b") else 1e-4
            np.testing.assert_allclose(got["state"][0][k], a, rtol=0, atol=atol, err_msg=k)
        assert got["eval_shapes"][-1] == (8, cases.PIPE_LM["seq_len"], cases.PIPE_LM["vocab"])
    assert len({rank["dp"][name]["digest"] for rank in ranks}) == 1


def test_lm_pipeline_guards():
    """The JAX package's refusals, with its messages: dropout, ragged
    ``seq_lens``, and layers the stages do not divide."""
    mesh = make_mesh(pipe=2, devices=[0, 1])
    kw = dict(cases.PIPE_LM, residual_dropout=0.1)
    spec = tmodels.get_model("transformer_lm", device="cpu", pipe_mesh=mesh, **kw)
    batch = spec.synth_batch(8, np.random.RandomState(0))
    v = spec.model.init(0, *batch, device="cpu")
    with pytest.raises(Exception, match="dropout"):
        spec.model.apply(v, *batch, rng=torch.Generator().manual_seed(0), is_train=True)
    spec2 = tmodels.get_model("transformer_lm", device="cpu", pipe_mesh=mesh, **cases.PIPE_LM)
    v2 = spec2.model.init(0, *batch, device="cpu")
    with pytest.raises(Exception, match="seq_lens"):
        spec2.model.apply(v2, *batch, torch.full((8,), 8, dtype=torch.int32))
    spec3 = tmodels.get_model("transformer_lm", device="cpu",
                              pipe_mesh=make_mesh(pipe=3, devices=[0, 1, 2]), **cases.PIPE_LM)
    v3 = spec3.model.init(0, *batch, device="cpu")
    with pytest.raises(Exception, match="divisible"):
        spec3.model.apply(v3, *batch)
