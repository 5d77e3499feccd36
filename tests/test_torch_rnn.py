"""The port's sequence ops, recurrent ops, beam search and the two LSTM
models (``stacked_dynamic_lstm``, ``machine_translation``) against the JAX
package's, on the CPU in f32, on the same numpy-seeded inputs and (for the
models) the JAX ``init``'s weights carried across with ``params_from_jax``.

Tolerances: values at 1e-5 absolute (f32 sums in another order), losses at
1e-5 relative, every gradient at 1e-4 relative L2. The JAX package runs the
recurrences as ``lax.scan``, the port as a loop of the same steps. Beam
search is token-exact: candidates rank by score, then by index, in both.
"""

import torch_threads  # noqa: F401  (first: its share of the cores)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu import backward as jbackward
from paddle_tpu import models as jmodels
from paddle_tpu.ops import control_flow as jcf
from paddle_tpu.ops import rnn as jrnn
from paddle_tpu.ops import sequence as jseq
from paddle_tpu_torch import backward as tbackward
from paddle_tpu_torch import convert
from paddle_tpu_torch import layers as tlayers
from paddle_tpu_torch import models as tmodels
from paddle_tpu_torch.ops import control_flow as tcf
from paddle_tpu_torch.ops import rnn as trnn
from paddle_tpu_torch.ops import sequence as tseq

ATOL, LOSS_RTOL, GRAD_RTOL = 1e-5, 1e-5, 1e-4
LENS = np.array([7, 3, 0, 5], np.int32)  # ragged, one empty row


def _x(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _ids(seed, *shape, high=9):
    return np.random.RandomState(seed).randint(0, high, size=shape).astype(np.int32)


def _both(fn_j, fn_t, *arrays):
    """Run the JAX and the port's function on the same numpy arrays."""
    j = fn_j(*(jnp.asarray(a) for a in arrays))
    t = fn_t(*(torch.from_numpy(np.asarray(a)) for a in arrays))
    return j, t


def _close(t, j, atol=ATOL):
    if isinstance(j, (tuple, list)):
        assert len(t) == len(j)
        for a, b in zip(t, j):
            _close(a, b, atol)
        return
    t = t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    np.testing.assert_allclose(t, np.asarray(j), rtol=0, atol=atol)


# ------------------------------------------------------------ sequence ops
SEQ_CASES = {
    "length_mask": (lambda m, l: m.length_mask(l, 7), (LENS,)),
    "pool_sum": (lambda m, x, l: m.sequence_pool(x, l, "sum"), (_x(1, 4, 7, 3), LENS)),
    "pool_average": (lambda m, x, l: m.sequence_pool(x, l, "average"), (_x(1, 4, 7, 3), LENS)),
    "pool_sqrt": (lambda m, x, l: m.sequence_pool(x, l, "sqrt"), (_x(1, 4, 7, 3), LENS)),
    "pool_max": (lambda m, x, l: m.sequence_pool(x, l, "max"), (_x(1, 4, 7, 3), LENS)),
    "last_step": (lambda m, x, l: m.sequence_last_step(x, l), (_x(2, 4, 7, 3), LENS)),
    "first_step": (lambda m, x, l: m.sequence_first_step(x, l), (_x(2, 4, 7, 3), LENS)),
    "softmax": (lambda m, x, l: m.sequence_softmax(x, l), (_x(3, 4, 7), LENS)),
    "softmax_3d": (lambda m, x, l: m.sequence_softmax(x, l), (_x(3, 4, 7, 2), LENS)),
    "expand": (lambda m, x, l: m.sequence_expand(x, l, 7), (_x(4, 4, 3), LENS)),
    "expand_as": (lambda m, x, l: m.sequence_expand_as(x, l, 7), (_x(4, 4, 3), LENS)),
    "reverse": (lambda m, x, l: m.sequence_reverse(x, l), (_x(5, 4, 7, 3), LENS)),
    "reverse_ids": (lambda m, x, l: m.sequence_reverse(x, l), (_ids(5, 4, 7), LENS)),
    "unpad_mask": (lambda m, x, l: m.sequence_unpad_mask(x, l), (_x(6, 4, 7, 3), LENS)),
    "conv": (lambda m, x, l, w: m.sequence_conv(x, l, w, 3), (_x(7, 4, 7, 3), LENS, _x(8, 9, 5))),
    "conv_start": (lambda m, x, l, w: m.sequence_conv(x, l, w, 2, context_start=0),
                   (_x(7, 4, 7, 3), LENS, _x(8, 6, 5))),
    "erase": (lambda m, x, l, tok: m.sequence_erase(x, l, tok),
              (_ids(9, 4, 7, high=5), LENS, np.array([1, 3], np.int32))),
    "concat": (lambda m, x, xl, y, yl: m.sequence_concat(x, xl, y, yl),
               (_x(10, 4, 7, 2), LENS, _x(11, 4, 3, 2), np.array([1, 3, 2, 0], np.int32))),
    "concat_ids": (lambda m, x, xl, y, yl: m.sequence_concat(x, xl, y, yl),
                   (_ids(10, 4, 7), LENS, _ids(11, 4, 3), np.array([1, 3, 2, 0], np.int32))),
    "enumerate": (lambda m, x, l: m.sequence_enumerate(x, l, 3, pad_value=-1), (_ids(12, 4, 7), LENS)),
    "mask": (lambda m, l: m.sequence_mask(l, 9), (LENS,)),
    "reshape": (lambda m, x, l: m.sequence_reshape(x, l, 2), (_x(13, 4, 7, 4), LENS)),
    "scatter": (lambda m, x, i, l, u: m.sequence_scatter(x, i, l, u),
                (_x(14, 4, 6), _ids(15, 4, 3, high=6), np.array([3, 1, 0, 2], np.int32),
                 _x(16, 4, 3))),
    "slice": (lambda m, x, l, o, n: m.sequence_slice(x, l, o, n),
              (_x(17, 4, 7, 2), LENS, np.array([1, 0, 0, 2], np.int32),
               np.array([4, 3, 0, 2], np.int32))),
    "lod_reset": (lambda m, x, l: m.lod_reset(x, l), (_x(18, 4, 7), LENS[::-1].copy())),
    "reorder_by_rank": (lambda m, x, r: m.reorder_by_rank(x, r),
                        (_x(19, 4, 3), np.array([2, 0, 3, 1], np.int32))),
}


@pytest.mark.parametrize("case", list(SEQ_CASES))
def test_sequence_op_matches_jax(case):
    fn, arrays = SEQ_CASES[case]
    j, t = _both(lambda *a: fn(jseq, *a), lambda *a: fn(tseq, *a), *arrays)
    _close(t, j)


def test_sequence_pad_is_the_host_helper():
    rows = [np.ones((3, 2), np.float32), np.zeros((5, 2), np.float32)]
    for a, b in zip(tseq.sequence_pad(rows, 4), jseq.sequence_pad(rows, 4)):
        np.testing.assert_array_equal(a, b)


# ------------------------------------------------------------ recurrent ops
def _rnn_grads(fn_j, fn_t, arrays, proj):
    """Gradients of ``sum(proj * outputs)`` with respect to every array."""
    jg = jax.grad(lambda *a: jnp.sum(jnp.asarray(proj) * fn_j(*a)), argnums=tuple(
        range(len(arrays))))(*(jnp.asarray(a) for a in arrays))
    ts = [torch.from_numpy(a).requires_grad_() for a in arrays]
    (torch.from_numpy(proj) * fn_t(*ts)).sum().backward()
    return jg, [t.grad for t in ts]


def _assert_rel_l2(t, j, tol=GRAD_RTOL):
    j = np.asarray(j)
    rel = np.linalg.norm(t.numpy() - j) / max(np.linalg.norm(j), 1e-12)
    assert rel <= tol, rel


@pytest.mark.parametrize("reverse", [False, True], ids=["forward", "reverse"])
@pytest.mark.parametrize("ragged", [False, True], ids=["full", "ragged"])
@pytest.mark.parametrize("proj_input", [True, False], ids=["w_ih", "preprojected"])
def test_dynamic_lstm_matches_jax(reverse, ragged, proj_input):
    b, t, d, h = 4, 7, 5, 6
    lens = LENS if ragged else None
    x = _x(20, b, t, d if proj_input else 4 * h)
    w_ih, w_hh, bias = _x(21, d, 4 * h) * 0.5, _x(22, h, 4 * h) * 0.5, _x(23, 4 * h) * 0.1

    def run(mod, lib):
        def f(x_, wi, wh, b_):
            le = None if lens is None else lib(lens)
            outs, st = mod.dynamic_lstm(x_, wi if proj_input else None, wh, b_, lengths=le,
                                        reverse=reverse)
            return outs, st
        return f

    arrays = (x, w_ih, w_hh, bias)
    j, tt = _both(run(jrnn, jnp.asarray), run(trnn, torch.from_numpy), *arrays)
    _close(tt[0], j[0])
    _close(tuple(tt[1]), tuple(j[1]))
    proj = _x(24, b, t, h)
    jg, tg = _rnn_grads(lambda *a: run(jrnn, jnp.asarray)(*a)[0],
                        lambda *a: run(trnn, torch.from_numpy)(*a)[0], arrays, proj)
    for k, (a, g) in enumerate(zip(tg, jg)):
        if proj_input or k != 1:
            _assert_rel_l2(a, g)


@pytest.mark.parametrize("reverse", [False, True], ids=["forward", "reverse"])
@pytest.mark.parametrize("ragged", [False, True], ids=["full", "ragged"])
def test_dynamic_gru_matches_jax(reverse, ragged):
    b, t, d, h = 4, 7, 5, 6
    lens = LENS if ragged else None
    arrays = (_x(30, b, t, d), _x(31, d, 3 * h) * 0.5, _x(32, h, 3 * h) * 0.5, _x(33, 3 * h) * 0.1)

    def run(mod, lib):
        def f(x_, wi, wh, b_):
            return mod.dynamic_gru(x_, wi, wh, b_, lengths=None if lens is None else lib(lens),
                                   reverse=reverse)
        return f

    j, tt = _both(run(jrnn, jnp.asarray), run(trnn, torch.from_numpy), *arrays)
    _close(tt, j)
    jg, tg = _rnn_grads(lambda *a: run(jrnn, jnp.asarray)(*a)[0],
                        lambda *a: run(trnn, torch.from_numpy)(*a)[0], arrays, _x(34, b, t, h))
    for a, g in zip(tg, jg):
        _assert_rel_l2(a, g)


@pytest.mark.parametrize("clip", [None, 0.5], ids=["noclip", "clip"])
def test_dynamic_lstmp_matches_jax(clip):
    b, t, d, h, p = 4, 7, 5, 6, 3
    arrays = (_x(40, b, t, d), _x(41, d, 4 * h) * 0.5, _x(42, p, 4 * h) * 0.5, _x(43, h, p) * 0.5,
              _x(44, 4 * h) * 0.1)

    def run(mod, lib):
        def f(x_, wi, wh, wp, b_):
            return mod.dynamic_lstmp(x_, wi, wh, wp, b_, lengths=lib(LENS), cell_clip=clip,
                                     proj_clip=clip, proj_act="tanh")
        return f

    j, tt = _both(run(jrnn, jnp.asarray), run(trnn, torch.from_numpy), *arrays)
    _close(tt[0], j[0])
    _close(tuple(tt[1]), tuple(j[1]))


def test_units_match_jax():
    b, h = 3, 4
    xp4, xp3, hp, cp = _x(50, b, 4 * h), _x(51, b, 3 * h), _x(52, b, h), _x(53, b, h)
    w4, w3, b4, b3 = _x(54, h, 4 * h), _x(55, h, 3 * h), _x(56, 4 * h), _x(57, 3 * h)
    j, t = _both(lambda *a: jrnn.lstm_unit(*a, forget_bias=1.0),
                 lambda *a: trnn.lstm_unit(*a, forget_bias=1.0), xp4, hp, cp, w4, b4)
    _close(t, j)
    j, t = _both(jrnn.gru_unit, trnn.gru_unit, xp3, hp, w3, b3)
    _close(t, j)


def test_dynamic_lstm_layer_matches_jax_names_and_values():
    import paddle_tpu as jpt

    from paddle_tpu_torch import framework

    x, lens = _x(60, 4, 7, 5), LENS
    jm = jpt.build(lambda a, l: jpt.layers.dynamic_lstm(a, 6, lengths=l, name="enc"))
    tm = framework.build(lambda a, l: tlayers.dynamic_lstm(a, 6, lengths=l, name="enc"))
    jv = jm.init(jax.random.PRNGKey(0), x, lens)
    tv = tm.init(0, torch.from_numpy(x), torch.from_numpy(lens), device="cpu")
    assert set(tv.params) == set(jv.params) == {"enc/w_ih", "enc/w_hh", "enc/b"}
    tp = convert.params_from_jax({n: np.asarray(a) for n, a in jv.params.items()}, "cpu")
    (jo, jst), _ = jm.apply(jv, x, lens)
    (to, tst), _ = tm.apply(tp, torch.from_numpy(x), torch.from_numpy(lens))
    _close(to, jo)
    _close(tuple(tst), tuple(jst))


# ------------------------------------------------------------ beam search
def _uniform_step(vocab):
    """A decoder whose every candidate ties: log-probs all equal."""
    def step(lib):
        def fn(carry, tokens):
            return carry, lib.zeros((tokens.shape[0], vocab)) - np.log(vocab)
        return fn
    return step


def test_beam_search_ties_pick_as_jax():
    """Every candidate scores the same: both packages keep the lowest flat
    indices (score, then index), so tokens and backpointers agree."""
    b, k, v = 2, 3, 5
    step = _uniform_step(v)
    kw = dict(batch_size=b, beam_size=k, vocab_size=v, max_len=4, bos_id=0, eos_id=v - 1)
    js, jsc = jcf.beam_search(step(jnp), jnp.zeros((b, 1)), **kw)
    ts, tsc = tcf.beam_search(step(torch), torch.zeros((b, 1)), **kw)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    _close(tsc, jsc)


def test_beam_search_decode_matches_jax():
    rng = np.random.RandomState(70)
    tok = rng.randint(0, 9, size=(5, 2, 3)).astype(np.int32)
    ptr = rng.randint(0, 3, size=(5, 2, 3)).astype(np.int32)
    j, t = _both(jcf.beam_search_decode, lambda a, p: tcf.beam_search_decode(a, p.long()), tok, ptr)
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


# ------------------------------------------------------------ models
SMALL = {
    "stacked_dynamic_lstm": dict(vocab_size=50, emb_dim=16, hidden_dim=16, stacked_num=2,
                                 seq_len=10),
    "machine_translation": dict(vocab_size=50, emb_dim=16, hidden_dim=16, seq_len=10),
}


def _models(name, seed=0):
    jspec = jmodels.get_model(name, **SMALL[name])
    tspec = tmodels.get_model(name, device="cpu", **SMALL[name])
    batch = jspec.synth_batch(3, np.random.RandomState(seed))
    jvars = jspec.model.init(jax.random.PRNGKey(seed), *batch)
    tparams = convert.params_from_jax({n: np.asarray(a) for n, a in jvars.params.items()}, "cpu")
    return jspec, tspec, jvars, tparams, batch


def _t(batch):
    return tuple(torch.from_numpy(np.asarray(a)) for a in batch)


@pytest.mark.parametrize("name", list(SMALL))
def test_model_params_and_synth_batch_match_jax(name):
    jspec, tspec, jvars, _, batch = _models(name)
    tvars = tspec.model.init(0, *_t(batch), device="cpu")
    assert set(tvars.params) == set(jvars.params)
    for n, p in tvars.params.items():
        assert tuple(p.shape) == jvars.params[n].shape, n
    tb = tspec.synth_batch(3, np.random.RandomState(0))
    for a, b in zip(tb, batch):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert tspec.unit == jspec.unit == "words/sec"


@pytest.mark.parametrize("name", list(SMALL))
def test_model_loss_and_every_gradient_match_jax(name):
    jspec, tspec, jvars, tparams, batch = _models(name, 1)
    jloss, (jgrads, _, jout) = jbackward.append_backward(jspec.model, *batch)(jvars.params)
    tloss, (tgrads, _, tout) = tbackward.append_backward(tspec.model, *_t(batch))(tparams)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=LOSS_RTOL)
    _close(tout[2], jout[2])
    assert set(tgrads) == set(jgrads)
    for n, g in jgrads.items():
        g = np.asarray(g)
        rel = np.linalg.norm(tgrads[n].numpy() - g) / max(np.linalg.norm(g), 1e-12)
        assert rel <= GRAD_RTOL, (n, rel)


@pytest.mark.parametrize("name", list(SMALL))
def test_model_adam_steps_match_jax(name):
    jspec, tspec, jvars, tparams, batch = _models(name, 2)
    from paddle_tpu_torch.framework import Variables

    jopt, topt = jspec.optimizer(), tspec.optimizer()
    jstep, tstep = jax.jit(jopt.minimize(jspec.model)), topt.minimize(tspec.model)
    js, ts, tv = jopt.create_state(jvars.params), topt.create_state(tparams), Variables(tparams, {})
    jl, tl = [], []
    for _ in range(3):
        jo, to = jstep(jvars, js, *batch), tstep(tv, ts, *_t(batch))
        jvars, js, tv, ts = jo.variables, jo.opt_state, to.variables, to.opt_state
        jl.append(float(jo.loss))
        tl.append(float(to.loss))
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    assert tl[-1] < tl[0]


@pytest.mark.parametrize("beam", [1, 3])
def test_machine_translation_beam_search_token_exact(beam):
    """The beam-search inference model on the trained model's weights: the
    same sequences (token-exact) and scores as the JAX package's."""
    jspec, tspec, jvars, tparams, batch = _models("machine_translation", 3)
    kw = dict(beam_size=beam, max_len=8, bos_id=0, eos_id=1)
    jinfer, tinfer = jspec.extra["make_infer_model"](**kw), tspec.extra["make_infer_model"](**kw)
    (jseqs, jscores), _ = jinfer.apply(jvars, batch[0], batch[1])
    (tseqs, tscores), _ = tinfer.apply(tparams, *_t(batch[:2]))
    assert tseqs.shape == (3, beam, 8) and tseqs.dtype == torch.int32
    np.testing.assert_array_equal(tseqs.numpy(), np.asarray(jseqs))
    np.testing.assert_allclose(tscores.numpy(), np.asarray(jscores), rtol=1e-5, atol=1e-5)
    assert bool((tscores[:, :-1] >= tscores[:, 1:]).all())
