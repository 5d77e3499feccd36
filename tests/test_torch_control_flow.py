"""The port's control-flow ops against the JAX package's, on the CPU: the
cases of ``tests/test_control_flow.py`` run through both packages on the
same numpy-seeded inputs.

Tolerances: loop outputs within 1e-5 absolute (f32 in another order);
gradients through the loops within 1e-4 relative L2; indices, tokens and
counts equal. The JAX package lowers the loops onto ``lax`` control flow,
the port runs them as Python loops.
"""

import torch_threads  # noqa: F401  (first: its share of the cores)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops import control_flow as jcf
from paddle_tpu_torch.core.dtypes import INDEX_DTYPE
from paddle_tpu_torch.ops import control_flow as tcf

ATOL, GRAD_RTOL = 1e-5, 1e-4


def _x(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-12)


def test_while_loop_counter():
    def cond(s):
        return s[0] < 10

    def body(s):
        return s[0] + 1, s[1] + s[0]

    ji, jacc = jax.jit(lambda: jcf.while_loop(cond, body, (0, 0)))()
    ti, tacc = tcf.while_loop(cond, body, (torch.tensor(0), torch.tensor(0)))
    assert int(ti) == int(ji) == 10 and int(tacc) == int(jacc) == sum(range(10))


def test_while_loop_tensor_state_and_gradient():
    x0 = _x(1, 3)

    def body_j(s):
        return s[0] + 1, jnp.tanh(s[1] * 1.3)

    def body_t(s):
        return s[0] + 1, torch.tanh(s[1] * 1.3)

    j = jcf.while_loop(lambda s: s[0] < 4, body_j, (0, jnp.asarray(x0)))[1]
    x = torch.from_numpy(x0).requires_grad_()
    t = tcf.while_loop(lambda s: s[0] < 4, body_t, (0, x))[1]
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), atol=ATOL)
    # the JAX while_loop has no reverse mode; its unrolled equivalent does
    def unrolled(v):
        for _ in range(4):
            v = jnp.tanh(v * 1.3)
        return jnp.sum(v * jnp.arange(3.0))

    (g,) = torch.autograd.grad(torch.sum(t * torch.arange(3.0)), x)
    assert _rel(g, jax.grad(unrolled)(jnp.asarray(x0))) <= GRAD_RTOL


@pytest.mark.parametrize("pred", [True, False])
def test_cond(pred):
    j = jax.jit(lambda p, x: jcf.cond(p, lambda v: v * 2, lambda v: v - 1, x))(pred, 3.0)
    t = tcf.cond(torch.tensor(pred), lambda v: v * 2, lambda v: v - 1, torch.tensor(3.0))
    assert float(t) == float(j)


def test_cond_runs_only_the_taken_branch():
    ran = []

    def branch(tag):
        def fn(v):
            ran.append(tag)
            return v

        return fn

    tcf.cond(torch.tensor(False), branch("t"), branch("f"), torch.tensor(1.0))
    assert ran == ["f"]


@pytest.mark.parametrize("index", [-3, 0, 1, 2, 7])
def test_switch_case_clamps_like_lax_switch(index):
    fns = [lambda v: v, lambda v: v * 10, lambda v: -v]
    j = jax.jit(lambda i, x: jcf.switch_case(i, fns, x))(index, 2.0)
    t = tcf.switch_case(torch.tensor(index), fns, torch.tensor(2.0))
    assert float(t) == float(j)


@pytest.mark.parametrize("x", [20.0, 5.0, -1.0])
def test_case_first_true_wins(x):
    def run(m, v, zeros_like):
        return m.case([(v > 10.0, lambda u: u * 100.0), (v > 0.0, lambda u: u * 2.0)],
                      lambda u: zeros_like(u), v)

    j = jax.jit(lambda v: run(jcf, v, jnp.zeros_like))(x)
    t = run(tcf, torch.tensor(x), torch.zeros_like)
    assert float(t) == float(j)


def test_tensor_array_roundtrip_against_jax():
    def run(m, arr, write_vals):
        arr = m.array_write(arr, 0, write_vals[0])
        arr = arr.append(write_vals[1])
        arr = arr.write(9, write_vals[2])  # past the capacity: clamped to the last slot
        return m.array_read(arr, 1), m.array_length(arr), arr.stack(), arr.read(-4)

    vals = [_x(2, 2), _x(3, 2), _x(4, 2)]
    j = run(jcf, jcf.create_array(4, (2,), jnp.float32), [jnp.asarray(v) for v in vals])
    t = run(tcf, tcf.create_array(4, (2,), torch.float32, device="cpu"),
            [torch.from_numpy(v) for v in vals])
    for a, b in zip(t, j):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert t[1].dtype == torch.int32 and int(t[1]) == 10


def test_tensor_array_write_keeps_the_graph():
    v = torch.ones(2, requires_grad=True)
    arr = tcf.create_array(3, (2,), device="cpu").write(1, v * 3)
    (g,) = torch.autograd.grad(arr.stack().sum(), v)
    assert torch.equal(g, torch.full((2,), 3.0))


def _step_j(h, x):
    h = jnp.tanh(h + x["a"] * x["b"])
    return h, (h * 2.0, jnp.sum(h, -1))


def _step_t(h, x):
    h = torch.tanh(h + x["a"] * x["b"])
    return h, (h * 2.0, torch.sum(h, -1))


@pytest.mark.parametrize("time_major", [False, True])
def test_static_rnn_matches_jax(time_major):
    B, T, D = 3, 5, 4
    shape = (T, B, D) if time_major else (B, T, D)
    a, b, h0 = _x(1, *shape), _x(2, *shape), _x(3, B, D)

    def j_fn(a, b, h0):
        return jcf.static_rnn(_step_j, {"a": a, "b": b}, h0, time_major)

    jf, (jy, js) = j_fn(*(jnp.asarray(v) for v in (a, b, h0)))
    ta, tb, th = (torch.from_numpy(v).requires_grad_() for v in (a, b, h0))
    tf, (ty, ts) = tcf.static_rnn(_step_t, {"a": ta, "b": tb}, th, time_major)
    for got, want in ((tf, jf), (ty, jy), (ts, js)):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=ATOL)
    c = _x(4, *ty.shape)

    def j_loss(*v):
        f, (y, _) = j_fn(*v)
        return jnp.sum(y * c) + jnp.sum(f)

    want = jax.grad(j_loss, (0, 1, 2))(*(jnp.asarray(v) for v in (a, b, h0)))
    got = torch.autograd.grad(torch.sum(ty * torch.from_numpy(c)) + tf.sum(), (ta, tb, th))
    for g, w in zip(got, want):
        assert _rel(g, w) <= GRAD_RTOL


def test_dynamic_rnn_matches_jax():
    B, T, D = 3, 6, 2
    xs, h0 = _x(5, B, T, D), _x(6, B, D)
    lens = np.array([3, 6, 0], np.int32)

    def step_j(state, x):
        h, n = state
        h = h * 0.9 + x
        return (h, n + 1), h * h

    def step_t(state, x):
        h, n = state
        h = h * 0.9 + x
        return (h, n + 1), h * h

    (jh, jn), jy = jcf.dynamic_rnn(step_j, jnp.asarray(xs), jnp.asarray(lens),
                                   (jnp.asarray(h0), jnp.zeros((), jnp.int32)))
    tx, th = torch.from_numpy(xs).requires_grad_(), torch.from_numpy(h0).requires_grad_()
    (h, n), y = tcf.dynamic_rnn(step_t, tx, torch.from_numpy(lens),
                                (th, torch.zeros((), dtype=torch.int32)))
    np.testing.assert_allclose(h.detach().numpy(), np.asarray(jh), atol=ATOL)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy), atol=ATOL)
    assert int(n) == int(jn) == T  # the counter has no batch dim: it steps every time
    assert np.all(y.detach().numpy()[0, 3:] == 0.0) and np.all(y.detach().numpy()[2] == 0.0)
    np.testing.assert_array_equal(h.detach().numpy()[2], h0[2])

    def j_loss(x, h0):
        (hf, _), yy = jcf.dynamic_rnn(step_j, x, jnp.asarray(lens), (h0, jnp.zeros((), jnp.int32)))
        return jnp.sum(yy) + jnp.sum(hf * 3.0)

    want = jax.grad(j_loss, (0, 1))(jnp.asarray(xs), jnp.asarray(h0))
    got = torch.autograd.grad(y.sum() + (h * 3.0).sum(), (tx, th))
    for g, w in zip(got, want):
        assert _rel(g, w) <= GRAD_RTOL


def test_rank_by_length_is_a_stable_descending_sort():
    lengths = np.array([2, 9, 5, 9, 2, 5], np.int32)
    jo, ji = jcf.rank_by_length(jnp.asarray(lengths))
    to, ti = tcf.rank_by_length(torch.from_numpy(lengths))
    assert to.dtype == ti.dtype == INDEX_DTYPE
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(to.numpy(), [1, 3, 2, 5, 0, 4])


def test_greedy_search_stops_at_eos_as_jax():
    V, B, T, eos = 4, 2, 5, 3
    lp0 = np.full((B, V), -10.0, np.float32)
    lp0[:, 2] = 0.0
    lp1 = np.full((B, V), -10.0, np.float32)
    lp1[:, eos] = 0.0
    tables = np.stack([lp0, lp1] + [lp1] * (T - 2))

    def step(m, tab):
        return lambda t, tokens: (t + 1, tab[min(int(t), T - 1)] if m is tcf else
                                  tab[jnp.minimum(t, T - 1)])

    j = jcf.greedy_search(step(jcf, jnp.asarray(tables)), jnp.zeros((), jnp.int32),
                          batch_size=B, max_len=T, bos_id=0, eos_id=eos)
    t = tcf.greedy_search(step(tcf, torch.from_numpy(tables)), torch.zeros((), dtype=torch.int32),
                          batch_size=B, max_len=T, bos_id=0, eos_id=eos)
    assert t.dtype == torch.int32
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    np.testing.assert_array_equal(t.numpy()[:, 0], [2, 2])


def test_greedy_search_ties_take_the_first_maximum():
    V, B, T = 5, 3, 4
    r = np.random.RandomState(8)
    tables = np.round(r.randn(T, B, V), 0).astype(np.float32)  # many exact ties

    def step_j(t, tokens):
        return t + 1, jnp.asarray(tables)[t] + 0.0 * tokens[:, None]

    def step_t(t, tokens):
        return t + 1, torch.from_numpy(tables)[t] + 0.0 * tokens[:, None]

    j = jcf.greedy_search(step_j, 0, batch_size=B, max_len=T, bos_id=1, eos_id=V + 1)
    t = tcf.greedy_search(step_t, 0, batch_size=B, max_len=T, bos_id=1, eos_id=V + 1)
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))
