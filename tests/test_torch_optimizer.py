"""The port's optimizers, learning-rate schedules, regularizers and gradient
clipping (``paddle_tpu_torch.optimizer`` and friends) against the JAX
package's, on the same numpy-seeded arrays, on the CPU.

Tolerances: parameters and slots at rtol=1e-5, atol=1e-6 after three f32
updates (both run the same f32 update rules; the port computes the scalar
step factors, such as Adam's bias correction, in Python's float64 where
the JAX package rounds them to f32, a 1e-7 relative difference).
Schedules at rtol=1e-6 (the JAX package evaluates them in f32).
"""

import torch_threads  # noqa: F401  (first: its share of the cores)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu import clip as jclip
from paddle_tpu import lr_scheduler as jlrs
from paddle_tpu import models as jmodels
from paddle_tpu import optimizer as jopt
from paddle_tpu import regularizer as jreg
from paddle_tpu.framework import ParamInfo as JParamInfo
from paddle_tpu_torch import clip as tclip
from paddle_tpu_torch import convert
from paddle_tpu_torch import lr_scheduler as tlrs
from paddle_tpu_torch import models as tmodels
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch import regularizer as treg
from paddle_tpu_torch.framework import ParamInfo as TParamInfo
from paddle_tpu_torch.framework import Variables

TOL = dict(rtol=1e-5, atol=1e-6)
SHAPES = {"layer/fc/w": (6, 4), "layer/fc/b": (4,), "layer_norm/scale": (4,), "frozen/w": (3, 3)}


def _arrays(seed):
    rng = np.random.RandomState(seed)
    return {n: rng.randn(*s).astype(np.float32) for n, s in SHAPES.items()}


def _infos(regularizer=(None, None)):
    """(jax, port) param_info: one frozen parameter, one with a 0.5
    learning-rate multiplier (and the per-parameter regularizer, if any)."""
    out = []
    for cls, reg in zip((JParamInfo, TParamInfo), regularizer):
        info = {n: cls(name=n, shape=s, dtype=np.float32) for n, s in SHAPES.items()}
        info["frozen/w"].trainable = False
        info["layer/fc/w"].learning_rate = 0.5
        info["layer/fc/w"].regularizer = reg
        out.append(info)
    return out


def _run_both(make_j, make_t, steps=3, infos=None):
    """``steps`` apply_gradients calls in both packages on the same params
    and per-step gradients; returns (jax params, jax state, port params,
    port state) as numpy."""
    p0 = _arrays(0)
    jinfo, tinfo = infos or _infos()
    jo, to = make_j(), make_t()
    jp = {n: jnp.asarray(a) for n, a in p0.items()}
    tp = convert.params_from_jax(p0, "cpu")
    js, ts = jo.create_state(jp), to.create_state(tp)
    for i in range(steps):
        g = _arrays(100 + i)
        jp, js = jo.apply_gradients(jp, {n: jnp.asarray(a) for n, a in g.items()}, js, jinfo)
        tp, ts = to.apply_gradients(tp, convert.params_from_jax(g, "cpu"), ts, tinfo)
    return ({n: np.asarray(a) for n, a in jp.items()}, js, convert.params_to_numpy(tp),
            convert.opt_state_to_numpy(ts))


def _assert_same(jp, js, tp, ts):
    assert set(tp) == set(jp)
    for n in jp:
        np.testing.assert_allclose(tp[n], jp[n], err_msg=n, **TOL)
    assert ts["step"] == int(js.step)
    assert set(ts["slots"]) == set(js.slots)
    for s, d in js.slots.items():
        for n, a in d.items():
            np.testing.assert_allclose(ts["slots"][s][n], np.asarray(a), err_msg=f"{s}/{n}", **TOL)


OPTIMIZERS = {
    "sgd": lambda m: m.SGD(0.1),
    "momentum": lambda m: m.Momentum(0.05, momentum=0.9),
    "nesterov": lambda m: m.Momentum(0.05, momentum=0.9, use_nesterov=True),
    "lars": lambda m: m.LARS(0.1),
    "adagrad": lambda m: m.Adagrad(0.1, initial_accumulator_value=0.1),
    "adam": lambda m: m.Adam(0.01),
    "adamw": lambda m: m.AdamW(0.01, weight_decay=0.1),
    "lamb": lambda m: m.Lamb(0.01),
    "adamax": lambda m: m.Adamax(0.01),
    "decayed_adagrad": lambda m: m.DecayedAdagrad(0.05),
    "adadelta": lambda m: m.Adadelta(1.0),
    "rmsprop": lambda m: m.RMSProp(0.01, momentum=0.5),
    "rmsprop_centered": lambda m: m.RMSProp(0.01, centered=True),
    "ftrl": lambda m: m.Ftrl(0.1, l1=0.01, l2=0.01),
}


@pytest.mark.parametrize("name", list(OPTIMIZERS))
def test_apply_gradients_matches_jax(name):
    """Three updates with a frozen parameter (left as it was) and a 0.5
    learning-rate multiplier."""
    make = OPTIMIZERS[name]
    jp, js, tp, ts = _run_both(lambda: make(jopt), lambda: make(topt))
    _assert_same(jp, js, tp, ts)
    np.testing.assert_array_equal(tp["frozen/w"], _arrays(0)["frozen/w"])


def test_adam_with_a_schedule_matches_jax():
    jp, js, tp, ts = _run_both(
        lambda: jopt.Adam(jlrs.LinearWarmup(jlrs.CosineDecay(0.05, 10), 2)),
        lambda: topt.Adam(tlrs.LinearWarmup(tlrs.CosineDecay(0.05, 10), 2)), steps=4)
    _assert_same(jp, js, tp, ts)


@pytest.mark.parametrize("kind", ["l2_default", "l1_default", "l2_per_param"])
def test_regularized_updates_match_jax(kind):
    """``apply_gradients`` adds the regularizer's gradient term: the
    optimizer-wide default, or a ParamAttr regularizer on one parameter
    (which takes precedence)."""
    if kind == "l2_per_param":
        infos = _infos((jreg.L2Decay(0.3), treg.L2Decay(0.3)))
        make_j, make_t = (lambda: jopt.SGD(0.1, regularization=jreg.L1Decay(0.01)),
                          lambda: topt.SGD(0.1, regularization=treg.L1Decay(0.01)))
    else:
        jr, tr = (jreg.L2Decay, treg.L2Decay) if kind == "l2_default" else (jreg.L1Decay, treg.L1Decay)
        infos = None
        make_j, make_t = (lambda: jopt.Momentum(0.1, regularization=jr(0.05)),
                          lambda: topt.Momentum(0.1, regularization=tr(0.05)))
    _assert_same(*_run_both(make_j, make_t, infos=infos))


@pytest.mark.parametrize("reg", ["L2Decay", "L1Decay"])
def test_regularizer_terms_match_jax(reg):
    p = _arrays(1)["layer/fc/w"]
    j, t = getattr(jreg, reg)(0.2), getattr(treg, reg)(0.2)
    np.testing.assert_allclose(t.grad_term(torch.from_numpy(p)).numpy(),
                               np.asarray(j.grad_term(jnp.asarray(p))), **TOL)
    np.testing.assert_allclose(float(t.loss_term(torch.from_numpy(p))),
                               float(j.loss_term(jnp.asarray(p))), rtol=1e-6)


CLIPS = {
    "by_value": lambda m: m.GradientClipByValue(0.5),
    "by_value_asym": lambda m: m.GradientClipByValue(0.5, min=-0.1),
    "by_norm": lambda m: m.GradientClipByNorm(1.0),
    "by_global_norm": lambda m: m.GradientClipByGlobalNorm(2.0),
}


@pytest.mark.parametrize("name", list(CLIPS))
def test_grad_clip_matches_jax(name):
    g = _arrays(2)
    j = CLIPS[name](jclip)({n: jnp.asarray(a) for n, a in g.items()})
    t = CLIPS[name](tclip)(convert.params_from_jax(g, "cpu"))
    for n in g:
        np.testing.assert_allclose(t[n].numpy(), np.asarray(j[n]), err_msg=n, **TOL)
    np.testing.assert_allclose(float(tclip.global_norm(convert.params_from_jax(g, "cpu"))),
                               float(jclip.global_norm({n: jnp.asarray(a) for n, a in g.items()})),
                               rtol=1e-6)


def test_clipped_adam_matches_jax():
    _assert_same(*_run_both(lambda: jopt.Adam(0.01, grad_clip=jclip.GradientClipByGlobalNorm(1.0)),
                            lambda: topt.Adam(0.01, grad_clip=tclip.GradientClipByGlobalNorm(1.0))))


def test_error_clip_clips_the_gradient_only():
    x = torch.tensor([1.0, -2.0, 3.0], requires_grad=True)
    y = tclip.ErrorClipByValue(max=0.5, min=-0.25).apply(x)
    assert torch.equal(y.detach(), x.detach())
    (y * torch.tensor([2.0, -1.0, 0.1])).sum().backward()
    j = jax.grad(lambda a: jnp.sum(jclip.ErrorClipByValue(max=0.5, min=-0.25).apply(a)
                                   * jnp.asarray([2.0, -1.0, 0.1])))(jnp.asarray([1.0, -2.0, 3.0]))
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(j), rtol=1e-6)


SCHEDULES = {
    "constant": lambda m: m.Constant(0.3),
    "exponential": lambda m: m.ExponentialDecay(0.5, 4, 0.7),
    "exponential_staircase": lambda m: m.ExponentialDecay(0.5, 4, 0.7, staircase=True),
    "natural_exp": lambda m: m.NaturalExpDecay(0.5, 4, 0.3, staircase=True),
    "inverse_time": lambda m: m.InverseTimeDecay(0.5, 3, 0.5),
    "polynomial": lambda m: m.PolynomialDecay(0.5, 10, 0.01, power=2.0),
    "polynomial_cycle": lambda m: m.PolynomialDecay(0.5, 6, 0.01, cycle=True),
    "piecewise": lambda m: m.PiecewiseDecay([3, 9], [0.3, 0.1, 0.01]),
    "noam": lambda m: m.NoamDecay(64, 5),
    "cosine": lambda m: m.CosineDecay(0.4, 12, alpha=0.1),
    "warmup": lambda m: m.LinearWarmup(m.ExponentialDecay(0.5, 4, 0.7), 5, start_lr=0.01),
}


@pytest.mark.parametrize("name", list(SCHEDULES))
def test_lr_schedule_matches_jax(name):
    j, t = SCHEDULES[name](jlrs), SCHEDULES[name](tlrs)
    assert isinstance(tlrs.resolve(t), tlrs.LRScheduler)
    for step in range(0, 25):
        got = t(step)
        assert isinstance(got, float)
        np.testing.assert_allclose(got, float(j(jnp.asarray(step, jnp.int32))), rtol=1e-6,
                                   err_msg=f"step {step}")


def test_resolve_wraps_a_number_and_piecewise_checks_lengths():
    assert tlrs.resolve(0.25)(7) == 0.25
    with pytest.raises(Exception, match="len"):
        tlrs.PiecewiseDecay([1, 2], [0.1])


def test_append_lars_matches_jax():
    p, g = _arrays(3)["layer/fc/w"], _arrays(8)["layer/fc/w"]
    t = tlrs.append_LARS(0.1, torch.from_numpy(p), torch.from_numpy(g))
    j = jlrs.append_LARS(0.1, jnp.asarray(p), jnp.asarray(g))
    np.testing.assert_allclose(float(t), float(j), rtol=1e-6)


def test_model_average_matches_jax():
    j, t = jopt.ModelAverage(0.5, 2, 3), topt.ModelAverage(0.5, 2, 3)
    p0 = _arrays(4)
    js, ts = j.create_state({n: jnp.asarray(a) for n, a in p0.items()}), t.create_state(
        convert.params_from_jax(p0, "cpu"))
    for i in range(6):
        p = _arrays(10 + i)
        js = j.update(js, {n: jnp.asarray(a) for n, a in p.items()})
        ts = t.update(ts, convert.params_from_jax(p, "cpu"))
        assert ts["count"] == int(js["count"]) and ts["updates"] == int(js["updates"])
    ja = j.average(js, {n: jnp.asarray(a) for n, a in p0.items()})
    ta = t.average(ts, convert.params_from_jax(p0, "cpu"))
    for n in p0:
        np.testing.assert_allclose(ta[n].numpy(), np.asarray(ja[n]), err_msg=n, **TOL)


def test_opt_state_round_trips_through_jax():
    """A JAX OptState converts to the port's and back unchanged."""
    p0 = _arrays(5)
    jo = jopt.Adam(0.01)
    jp = {n: jnp.asarray(a) for n, a in p0.items()}
    js = jo.create_state(jp)
    jp, js = jo.apply_gradients(jp, {n: jnp.asarray(a) for n, a in _arrays(6).items()}, js, {})
    ts = convert.opt_state_from_jax(js, "cpu")
    assert isinstance(ts, topt.OptState) and ts.step == 1
    back = convert.opt_state_to_numpy(ts)
    for s, d in js.slots.items():
        for n, a in d.items():
            np.testing.assert_array_equal(back["slots"][s][n], np.asarray(a))
    assert convert.opt_state_from_jax(back, "cpu").step == 1
    # the port continues from the converted state as the JAX package does
    g = _arrays(7)
    jp2, _ = jo.apply_gradients(jp, {n: jnp.asarray(a) for n, a in g.items()}, js, {})
    tp2, _ = topt.Adam(0.01).apply_gradients(convert.params_from_jax(
        {n: np.asarray(a) for n, a in jp.items()}, "cpu"), convert.params_from_jax(g, "cpu"), ts, {})
    for n in p0:
        np.testing.assert_allclose(tp2[n].numpy(), np.asarray(jp2[n]), err_msg=n, **TOL)


SMALL = dict(seq_len=16, vocab=64, d_model=32, d_inner=64, num_heads=4, n_layers=2)


def test_accum_steps_matches_full_batch_and_jax():
    """``minimize(accum_steps=2)`` on a batch of 4: the same update as one
    full-batch step (the loss is a mean over tokens), in the port and in the
    JAX package; ``outputs`` gain a leading [2] dim. The k projections'
    biases are left out of the parameter comparison: their gradient is zero
    in exact arithmetic, so Adam's m / sqrt(v) turns rounding noise into
    steps of up to lr."""
    jspec = jmodels.get_model("transformer_lm", **SMALL)
    tspec = tmodels.get_model("transformer_lm", device="cpu", **SMALL)
    ids, labels = jspec.synth_batch(4, np.random.RandomState(0))
    jvars = jspec.model.init(jax.random.PRNGKey(0), ids, labels)
    tparams = convert.params_from_jax({n: np.asarray(a) for n, a in jvars.params.items()}, "cpu")
    tspec.model.init(0, torch.from_numpy(ids), torch.from_numpy(labels), device="cpu")
    jo, to = jspec.optimizer(), tspec.optimizer()
    j_acc = jax.jit(jo.minimize(jspec.model, accum_steps=2))(jvars, jo.create_state(jvars.params), ids, labels)
    t_state = to.create_state(tparams)
    batch = (torch.from_numpy(ids), torch.from_numpy(labels))
    t_acc = to.minimize(tspec.model, accum_steps=2)(Variables(tparams, {}), t_state, *batch)
    t_full = to.minimize(tspec.model)(Variables(tparams, {}), t_state, *batch)
    assert t_acc.outputs[0].shape == (2,) and t_acc.outputs[2].shape[0] == 2
    np.testing.assert_allclose(float(t_acc.loss), float(t_full.loss), rtol=1e-5)
    np.testing.assert_allclose(float(t_acc.loss), float(j_acc.loss), rtol=1e-5)
    for n, p in t_acc.variables.params.items():
        if n.endswith("self_attn/k/b"):
            continue
        np.testing.assert_allclose(p.numpy(), t_full.variables.params[n].numpy(), rtol=0, atol=1e-5,
                                   err_msg=n)
        np.testing.assert_allclose(p.numpy(), np.asarray(j_acc.variables.params[n]), rtol=0,
                                   atol=1e-5, err_msg=n)
    with pytest.raises(Exception, match="divisible"):
        to.minimize(tspec.model, accum_steps=3)(Variables(tparams, {}), t_state, *batch)


@pytest.fixture
def nan_guard_on():
    from paddle_tpu.core import config as jconfig
    from paddle_tpu_torch.core import config as tconfig

    saved = (jconfig.flags().check_nan_inf, tconfig.flags().check_nan_inf)
    jconfig.set_flags(check_nan_inf=True)
    tconfig.set_flags(check_nan_inf=True)
    yield
    jconfig.set_flags(check_nan_inf=saved[0])
    tconfig.set_flags(check_nan_inf=saved[1])


@pytest.mark.parametrize("value, finite", [(1e30, True), (float("inf"), False), (float("nan"), False)],
                         ids=["huge_finite", "inf", "nan"])
def test_nan_guard_matches_jax(value, finite, nan_guard_on):
    """``check_nan_inf``'s finite flag, port and JAX package, on a step whose
    weight gradient is the input: a finite 1e30 (whose square overflows, so
    a norm-based guard would flag it) is not flagged; one inf or NaN entry
    in one gradient is. Then the predicate itself on many gradients."""
    import jax.numpy as jnp

    import paddle_tpu as jpt
    import paddle_tpu_torch as tpt

    x = np.array([[1.0, 2.0, value, 3.0]], np.float32)
    fns = ((jpt, lambda h: jnp.mean(h)), (tpt, lambda h: torch.mean(h)))
    flags = []
    for pkg, mean in fns:
        model = pkg.build(lambda x, pkg=pkg, mean=mean: mean(pkg.layers.fc(x, 1)))
        xin = x if pkg is jpt else torch.from_numpy(x)
        v = model.init(0, xin) if pkg is jpt else model.init(0, xin, device="cpu")
        opt = pkg.optimizer.SGD(learning_rate=0.1)
        flags.append(bool(opt.minimize(model)(v, opt.create_state(v.params), xin).finite))
    assert flags == [finite, finite]
    grads = [torch.ones(3), torch.full((5, 2), 1e30), torch.zeros(0), torch.ones(2, dtype=torch.bfloat16)]
    assert bool(topt.all_finite(grads, torch.tensor(2.0)))
    for i in (0, 1, 3):
        bad = [g.clone() for g in grads]
        bad[i].view(-1)[-1] = value
        assert bool(topt.all_finite(bad)) is finite
    assert not bool(topt.all_finite(grads, torch.tensor(float("inf"))))
