"""The port's structured-prediction losses against the JAX package's, on the
CPU in f32: the linear-chain CRF's NLL and gradients, Viterbi decoding, CTC
(empty labels, repeated labels, ragged lengths) and its gradients, greedy
CTC decoding and the edit distance, on the same numpy-seeded inputs.

Tolerances: the recursions' values within 1e-4 relative (log-space sums
over T steps in another order), gradients within 1e-4 relative L2; decoded
tags, tokens, lengths and distances equal.
"""

import torch_threads  # noqa: F401  (first: its share of the cores)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops import losses as jl
from paddle_tpu_torch.core.dtypes import NEG_INF
from paddle_tpu_torch.ops import losses as tl

RTOL, GRAD_RTOL = 1e-4, 1e-4


def _x(seed, *shape, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(np.float32)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-12)


B, T, K = 4, 7, 5
EMIT = _x(1, B, T, K, scale=2.0)
TRANS = _x(2, K + 2, K)
TAGS = np.random.RandomState(3).randint(0, K, size=(B, T)).astype(np.int32)
LENS = np.array([7, 3, 1, 5], np.int32)


def test_linear_chain_crf_nll_and_gradients():
    args = (EMIT, TAGS, LENS, TRANS)
    want = jl.linear_chain_crf(*(jnp.asarray(a) for a in args))
    jg = jax.grad(lambda e, tr: jnp.sum(jl.linear_chain_crf(e, jnp.asarray(TAGS), jnp.asarray(LENS),
                                                            tr) * jnp.arange(1.0, B + 1)),
                  (0, 1))(jnp.asarray(EMIT), jnp.asarray(TRANS))
    e, tr = torch.from_numpy(EMIT).requires_grad_(), torch.from_numpy(TRANS).requires_grad_()
    got = tl.linear_chain_crf(e, torch.from_numpy(TAGS), torch.from_numpy(LENS), tr)
    assert got.shape == (B,) and bool((got > 0).all())
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=RTOL)
    tg = torch.autograd.grad(torch.sum(got * torch.arange(1.0, B + 1)), (e, tr))
    for g, w in zip(tg, jg):
        assert _rel(g, w) <= GRAD_RTOL
    # steps past a row's length carry no gradient
    assert float(tg[0][1, 3:].abs().max()) == 0.0


def test_linear_chain_crf_is_the_log_partition_by_enumeration():
    """Two steps, three tags: the NLL equals log Σ exp(path score) - gold by
    brute force."""
    e, tr = _x(4, 1, 2, 3), _x(5, 5, 3)
    tags = np.array([[2, 0]], np.int32)
    got = float(tl.linear_chain_crf(torch.from_numpy(e), torch.from_numpy(tags),
                                    torch.tensor([2]), torch.from_numpy(tr))[0])

    def score(a, b):
        return tr[0, a] + e[0, 0, a] + tr[2 + a, b] + e[0, 1, b] + tr[1, b]

    log_z = np.log(sum(np.exp(score(a, b)) for a in range(3) for b in range(3)))
    np.testing.assert_allclose(got, log_z - score(2, 0), rtol=1e-5)


def test_crf_decoding_matches_jax():
    jt, js = jl.crf_decoding(jnp.asarray(EMIT), jnp.asarray(LENS), jnp.asarray(TRANS))
    tt, ts = tl.crf_decoding(torch.from_numpy(EMIT), torch.from_numpy(LENS), torch.from_numpy(TRANS))
    assert tt.dtype == torch.int32 and tt.shape == (B, T)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-6)
    assert np.all(tt.numpy()[1, 3:] == 0)


def test_crf_decoding_ties_take_the_first_maximum():
    e = np.zeros((2, 4, 3), np.float32)  # every path scores the same
    tr = np.zeros((5, 3), np.float32)
    lens = np.array([4, 2], np.int32)
    jt, _ = jl.crf_decoding(jnp.asarray(e), jnp.asarray(lens), jnp.asarray(tr))
    tt, _ = tl.crf_decoding(torch.from_numpy(e), torch.from_numpy(lens), torch.from_numpy(tr))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(tt.numpy(), np.zeros((2, 4)))


V = 6
CTC_T = 9


def _log_probs(seed, b):
    x = _x(seed, b, CTC_T, V, scale=2.0)
    return (x - np.log(np.exp(x).sum(-1, keepdims=True))).astype(np.float32)


CTC_CASES = {
    # labels [B, L], label lengths, input lengths
    "plain": (np.array([[1, 2, 3], [4, 5, 1]], np.int32), [3, 2], [9, 7]),
    "repeats": (np.array([[2, 2, 3], [1, 1, 1]], np.int32), [3, 3], [9, 9]),
    "empty_label": (np.array([[3, 1, 0], [0, 0, 0]], np.int32), [2, 0], [8, 5]),
    "tight": (np.array([[1, 2, 1, 2]], np.int32), [4], [4]),
}


@pytest.mark.parametrize("name", sorted(CTC_CASES))
def test_ctc_loss_and_gradients(name):
    labels, llens, ilens = CTC_CASES[name]
    llens, ilens = np.array(llens, np.int32), np.array(ilens, np.int32)
    lp = _log_probs(len(name), labels.shape[0])
    args = [jnp.asarray(a) for a in (labels, ilens, llens)]
    want = jl.ctc_loss(jnp.asarray(lp), *args)
    jg = jax.grad(lambda x: jnp.sum(jl.ctc_loss(x, *args)))(jnp.asarray(lp))
    x = torch.from_numpy(lp).requires_grad_()
    got = tl.ctc_loss(x, *(torch.from_numpy(a) for a in (labels, ilens, llens)))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=RTOL)
    (g,) = torch.autograd.grad(got.sum(), x)
    assert bool(torch.isfinite(g).all())
    assert _rel(g, jg) <= GRAD_RTOL


def test_ctc_empty_label_is_the_all_blank_path():
    lp = _log_probs(3, 1)
    got = float(tl.ctc_loss(torch.from_numpy(lp), torch.zeros(1, 2, dtype=torch.int32),
                            torch.tensor([6]), torch.tensor([0]))[0])
    np.testing.assert_allclose(got, -lp[0, :6, 0].sum(), rtol=1e-6)
    assert NEG_INF == -1.0e9


def test_ctc_greedy_decode_matches_jax():
    lp = _log_probs(11, 3)
    lp[0, :4] = np.log(np.eye(V, dtype=np.float32)[[2, 2, 0, 2]] * 0.9 + 0.02)  # repeat, blank, repeat
    ilens = np.array([9, 4, 0], np.int32)
    jt, jn = jl.ctc_greedy_decode(jnp.asarray(lp), jnp.asarray(ilens))
    tt, tn = tl.ctc_greedy_decode(torch.from_numpy(lp), torch.from_numpy(ilens))
    assert tt.dtype == tn.dtype == torch.int32
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    assert list(tt.numpy()[0, :2]) == [2, 2] and int(tn[2]) == 0


@pytest.mark.parametrize("normalized", [False, True])
def test_edit_distance_matches_jax(normalized):
    r = np.random.RandomState(12)
    hyp = r.randint(0, 4, size=(5, 6)).astype(np.int32)
    ref = r.randint(0, 4, size=(5, 7)).astype(np.int32)
    hl = np.array([6, 0, 3, 6, 2], np.int32)
    rl = np.array([7, 4, 0, 5, 2], np.int32)
    want = jl.edit_distance(*(jnp.asarray(a) for a in (hyp, hl, ref, rl)), normalized=normalized)
    got = tl.edit_distance(*(torch.from_numpy(a) for a in (hyp, hl, ref, rl)), normalized=normalized)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


def test_edit_distance_against_the_textbook_table():
    def lev(a, b):
        d = np.arange(len(b) + 1, dtype=float)
        for i, ca in enumerate(a, 1):
            prev, d[0] = d[0], i
            for j, cb in enumerate(b, 1):
                prev, d[j] = d[j], min(d[j] + 1, d[j - 1] + 1, prev + (ca != cb))
        return d[-1]

    hyp, ref = [1, 2, 3, 4, 2], [2, 3, 1, 4]
    got = tl.edit_distance(torch.tensor([hyp]), torch.tensor([5]), torch.tensor([ref]),
                           torch.tensor([4]))
    assert float(got[0]) == lev(hyp, ref)
