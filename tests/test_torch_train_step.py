"""The port's training slice against the JAX package's, on the CPU: the
small LM (2 layers, d_model 64, 4 heads, T 64, vocab 512) trained by
``spec.optimizer().minimize(spec.model)`` (Adam) from the JAX ``init``'s
weights, carried across with ``params_from_jax``. The JAX step is jitted,
with its Pallas flash kernels in interpret mode; the port runs the flash
kernels' plain versions.

Tolerances, f32 (``use_bf16_compute`` off): losses at rtol=1e-5;
gradients at rtol=1e-4, atol=1e-6 (f32 sums in other orders); parameters
after three Adam steps at atol=1e-4 and the Adam slots at rtol=1e-4,
atol=1e-7. The k projections' biases have zero gradient in exact arithmetic
(a constant added to all of a row's scores cancels in the softmax): their
gradients are rounding noise, compared at atol=1e-6 only, and Adam's
m / sqrt(v) turns that noise into steps of up to lr, so their parameters
are held to the 3 * lr that three steps can move them. bf16 compute, a
looser comparison: losses at 2e-3 absolute and gradients at 0.1 relative
L2 per parameter. bf16 operands round at 2^-8 relative in every product of
both packages, but XLA on the CPU and PyTorch do not round the cotangents
at all the same points, so the gradients differ by a few percent relative
L2, and Adam's m / sqrt(v) amplifies such differences in near-zero
gradient elements: parameters after bf16 steps are not compared element
by element.
"""

import torch_threads  # noqa: F401  (first: its share of the cores)
import jax
import numpy as np
import pytest
import torch

from paddle_tpu import backward as jbackward
from paddle_tpu import models as jmodels
from paddle_tpu.core import config as jconfig
from paddle_tpu_torch import backward as tbackward
from paddle_tpu_torch import convert
from paddle_tpu_torch import models as tmodels
from paddle_tpu_torch.core import config as tconfig
from paddle_tpu_torch.framework import Variables

SMALL = dict(seq_len=64, vocab=512, d_model=64, d_inner=128, num_heads=4, n_layers=2)
LR = 1e-3  # get_model's default Adam learning rate
STEPS = 3


def _is_k_bias(name):
    return name.endswith("self_attn/k/b")


@pytest.fixture
def set_both_flags():
    names = ("use_flash_attention", "use_bf16_compute", "check_nan_inf")
    saved_j = {f: getattr(jconfig.flags(), f) for f in names}
    saved_t = {f: getattr(tconfig.flags(), f) for f in names}

    def set_(**kw):
        jconfig.set_flags(**kw)
        tconfig.set_flags(**kw)

    yield set_
    jconfig.set_flags(**saved_j)
    tconfig.set_flags(**saved_t)


def _setup(seed=0):
    jspec = jmodels.get_model("transformer_lm", **SMALL)
    tspec = tmodels.get_model("transformer_lm", device="cpu", **SMALL)
    ids, labels = jspec.synth_batch(2, np.random.RandomState(seed))
    jvars = jspec.model.init(jax.random.PRNGKey(seed), ids, labels)
    tparams = convert.params_from_jax({n: np.asarray(a) for n, a in jvars.params.items()}, "cpu")
    tspec.model.init(0, torch.from_numpy(ids), torch.from_numpy(labels), device="cpu")
    return jspec, tspec, jvars, Variables(tparams, {}), ids, labels


def _train_both(jspec, tspec, jvars, tvars, ids, labels, steps=STEPS):
    jopt, topt = jspec.optimizer(), tspec.optimizer()
    jstep, tstep = jax.jit(jopt.minimize(jspec.model)), topt.minimize(tspec.model)
    js, ts = jopt.create_state(jvars.params), topt.create_state(tvars.params)
    tids, tlabels = torch.from_numpy(ids), torch.from_numpy(labels)
    jl, tl = [], []
    for _ in range(steps):
        jo = jstep(jvars, js, ids, labels)
        to = tstep(tvars, ts, tids, tlabels)
        jvars, js, tvars, ts = jo.variables, jo.opt_state, to.variables, to.opt_state
        jl.append(float(jo.loss))
        tl.append(float(to.loss))
    return jl, tl, jvars, js, tvars, ts


@pytest.mark.parametrize("flash", [False, True], ids=["composed", "flash"])
def test_three_adam_steps_match_jax_f32(set_both_flags, flash):
    set_both_flags(use_flash_attention=flash, use_bf16_compute=False)
    jl, tl, jvars, js, tvars, ts = _train_both(*_setup())
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert tl[-1] < tl[0]
    tparams = convert.params_to_numpy(tvars.params)
    for n, a in jvars.params.items():
        atol = STEPS * LR if _is_k_bias(n) else 1e-4
        np.testing.assert_allclose(tparams[n], np.asarray(a), rtol=0, atol=atol, err_msg=n)
    tstate = convert.opt_state_to_numpy(ts)
    assert tstate["step"] == int(js.step) == STEPS
    for s, d in js.slots.items():
        for n, a in d.items():
            if _is_k_bias(n):
                continue
            np.testing.assert_allclose(tstate["slots"][s][n], np.asarray(a), rtol=1e-4, atol=1e-7,
                                       err_msg=f"{s}/{n}")


@pytest.mark.parametrize("flash", [False, True], ids=["composed", "flash"])
def test_gradients_match_jax_f32(set_both_flags, flash):
    """``append_backward`` in both packages at the same weights: the loss
    and every parameter's gradient."""
    set_both_flags(use_flash_attention=flash, use_bf16_compute=False)
    jspec, tspec, jvars, tvars, ids, labels = _setup(1)
    jloss, (jgrads, _, _) = jbackward.append_backward(jspec.model, ids, labels)(jvars.params)
    tloss, (tgrads, _, _) = tbackward.append_backward(
        tspec.model, torch.from_numpy(ids), torch.from_numpy(labels))(tvars.params)
    assert not tloss.requires_grad
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    assert set(tgrads) == set(jgrads)
    for n, g in jgrads.items():
        rtol = 0 if _is_k_bias(n) else 1e-4
        np.testing.assert_allclose(tgrads[n].numpy(), np.asarray(g), rtol=rtol, atol=1e-6, err_msg=n)


def test_three_adam_steps_close_to_jax_bf16(set_both_flags):
    """bf16 compute: the loss of three Adam steps, and the gradients at the
    initial weights by relative L2 per parameter (floored at 1e-2 of the
    largest parameter's gradient norm, for the k biases' noise)."""
    set_both_flags(use_flash_attention=True, use_bf16_compute=True)
    jspec, tspec, jvars, tvars, ids, labels = _setup(2)
    jl, tl, *_ = _train_both(jspec, tspec, jvars, tvars, ids, labels)
    np.testing.assert_allclose(tl, jl, rtol=0, atol=2e-3)
    _, (jgrads, _, _) = jbackward.append_backward(jspec.model, ids, labels)(jvars.params)
    _, (tgrads, _, _) = tbackward.append_backward(
        tspec.model, torch.from_numpy(ids), torch.from_numpy(labels))(tvars.params)
    norms = {n: np.linalg.norm(np.asarray(g)) for n, g in jgrads.items()}
    floor = 1e-2 * max(norms.values())
    for n, g in jgrads.items():
        rel = np.linalg.norm(tgrads[n].numpy() - np.asarray(g)) / max(norms[n], floor)
        assert rel <= 0.1, (n, rel)


def test_step_is_functional_and_reports_finite(set_both_flags):
    """The step leaves the caller's variables and state as they were, and
    with check_nan_inf on reports whether loss and gradients are finite:
    true here, false (as in the JAX package) once a weight is NaN."""
    set_both_flags(use_flash_attention=True, check_nan_inf=True)
    jspec, tspec, jvars, tvars, ids, labels = _setup(3)
    opt = tspec.optimizer()
    state = opt.create_state(tvars.params)
    before = {n: p.clone() for n, p in tvars.params.items()}
    batch = (torch.from_numpy(ids), torch.from_numpy(labels))
    out = opt.minimize(tspec.model)(tvars, state, *batch)
    assert out.finite.dtype == torch.bool and bool(out.finite)
    assert state.step == 0 and out.opt_state.step == 1
    for n, p in tvars.params.items():
        assert torch.equal(p, before[n]), n
        assert not out.variables.params[n].requires_grad
    assert out.loss.shape == () and not out.loss.requires_grad
    loss, n_tok, logits = out.outputs
    assert n_tok == 2 * SMALL["seq_len"] and tuple(logits.shape) == (2, SMALL["seq_len"], SMALL["vocab"])
    bad = dict(tvars.params)
    bad["layer_0/ffn/fc1/w"] = bad["layer_0/ffn/fc1/w"].clone()
    bad["layer_0/ffn/fc1/w"][0, 0] = float("nan")
    assert not bool(opt.minimize(tspec.model)(Variables(bad, {}), state, *batch).finite)
    jbad = dict(jvars.params)
    jbad["layer_0/ffn/fc1/w"] = jbad["layer_0/ffn/fc1/w"].at[0, 0].set(np.nan)
    jopt = jspec.optimizer()
    jout = jax.jit(jopt.minimize(jspec.model))(type(jvars)(jbad, {}), jopt.create_state(jbad), ids, labels)
    assert not bool(jout.finite)


def test_finite_is_none_without_check_nan_inf(set_both_flags):
    set_both_flags(check_nan_inf=False)
    _, tspec, _, tvars, ids, labels = _setup(4)
    opt = tspec.optimizer()
    out = opt.minimize(tspec.model)(tvars, opt.create_state(tvars.params),
                                    torch.from_numpy(ids), torch.from_numpy(labels))
    assert out.finite is None


def test_append_backward_no_grad_set_gives_zeros():
    _, tspec, _, tvars, ids, labels = _setup(5)
    frozen = {"layer_0/ffn/fc1/w", "emb/embedding/word_emb"}
    _, (grads, state, out) = tbackward.append_backward(
        tspec.model, torch.from_numpy(ids), torch.from_numpy(labels), no_grad_set=frozen)(tvars.params)
    assert set(grads) == set(tvars.params) and state == {}
    for n in frozen:
        assert not grads[n].any()
    assert grads["layer_0/ffn/fc2/w"].abs().sum() > 0


def test_value_and_grad_calc_gradient_stop_gradient_match_jax():
    import jax.numpy as jnp

    x = np.random.RandomState(6).randn(5).astype(np.float32)
    w = {"a": np.float32(1.5) * x, "b": np.ones(5, np.float32)}

    def jf(w_, x_):
        return jnp.sum(jnp.tanh(w_["a"] * x_) + jbackward.stop_gradient(w_["b"]) * x_ ** 2)

    def tf(w_, x_):
        return torch.sum(torch.tanh(w_["a"] * x_) + tbackward.stop_gradient(w_["b"]) * x_ ** 2)

    jw = {k: jnp.asarray(v) for k, v in w.items()}
    tw = {k: torch.from_numpy(v) for k, v in w.items()}
    jv, jg = jbackward.value_and_grad(jf)(jw, jnp.asarray(x))
    tv, tg = tbackward.value_and_grad(tf)(tw, torch.from_numpy(x))
    np.testing.assert_allclose(float(tv), float(jv), rtol=1e-6)
    for k in w:
        np.testing.assert_allclose(tg[k].numpy(), np.asarray(jg[k]), rtol=1e-6, atol=1e-7)
    jgx = jbackward.calc_gradient(jf, argnums=1)(jw, jnp.asarray(x))
    tgx = tbackward.calc_gradient(tf, argnums=1)(tw, torch.from_numpy(x))
    np.testing.assert_allclose(tgx.numpy(), np.asarray(jgx), rtol=1e-6, atol=1e-7)
    (_, aux), g2 = tbackward.value_and_grad(lambda a, b: (tf(a, b), {"x": b * 2}), argnums=(0, 1),
                                            has_aux=True)(tw, torch.from_numpy(x))
    assert isinstance(g2, tuple) and len(g2) == 2 and not aux["x"].requires_grad


def test_apply_accepts_rng_and_runs_with_gradients():
    _, tspec, _, tvars, ids, labels = _setup(7)
    params = {n: p.clone().requires_grad_() for n, p in tvars.params.items()}
    for rng in (None, torch.Generator().manual_seed(3)):
        (loss, _, _), state = tspec.model.apply(params, torch.from_numpy(ids), torch.from_numpy(labels),
                                                rng=rng, is_train=True)
        assert loss.requires_grad and state == {}


def test_remat_and_data_parallel_raise_not_ported():
    """``remat`` is ported (its step equals the plain model's; the parity
    itself is in ``test_torch_transformer_lm.py``)."""
    tspec = tmodels.get_model("transformer_lm", device="cpu", remat=True, **SMALL)
    plain = tmodels.get_model("transformer_lm", device="cpu", **SMALL)
    ids, labels = tspec.synth_batch(1, np.random.RandomState(8))
    tvars = tspec.model.init(0, ids, labels, device="cpu")
    opt = tspec.optimizer()
    out = opt.minimize(tspec.model)(tvars, opt.create_state(tvars.params), ids, labels)
    ref = opt.minimize(plain.model)(tvars, opt.create_state(tvars.params), ids, labels)
    assert float(out.loss) == float(ref.loss)
