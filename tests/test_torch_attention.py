"""The port's ``scaled_dot_product_attention`` and its helpers against the
JAX package's ``paddle_tpu.ops.attention``, with ``use_flash_attention`` on
and off.

Inputs come from a numpy seed and go through both packages. f32 is compared
at rtol=2e-4, atol=2e-5; with ``use_bf16_compute`` on, both round q/k/v to
bf16 and accumulate in f32, and are compared at 2e-2 absolute (the plain
versions round the probabilities to bf16 before the P V product, the JAX
flash kernel keeps them in f32).
"""

import torch_threads  # noqa: F401  (first: its share of the cores)
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.core import config as jconfig
from paddle_tpu.ops import attention as jattn
from paddle_tpu_torch.core import config as tconfig
from paddle_tpu_torch.ops import attention as tattn

tfa = importlib.import_module("paddle_tpu_torch.ops.cuda.flash_attention")

F32_TOL = dict(rtol=2e-4, atol=2e-5)


@pytest.fixture
def set_both_flags():
    """Set a flag in both packages; restore both afterwards."""
    saved_j = {f: getattr(jconfig.flags(), f) for f in ("use_flash_attention", "use_bf16_compute")}
    saved_t = {f: getattr(tconfig.flags(), f) for f in saved_j}

    def set_(**kw):
        jconfig.set_flags(**kw)
        tconfig.set_flags(**kw)

    yield set_
    jconfig.set_flags(**saved_j)
    tconfig.set_flags(**saved_t)


@pytest.fixture
def flash_calls(monkeypatch):
    """Records each call the port's sdpa routes into the flash wrapper."""
    calls = []
    real = tfa.flash_attention

    def spy(*a, **kw):
        calls.append(kw)
        return real(*a, **kw)

    monkeypatch.setattr(tfa, "flash_attention", spy)
    return calls


def _qkv(seed, B, H, H_kv, T, d, T_kv=None):
    rng = np.random.RandomState(seed)
    T_kv = T if T_kv is None else T_kv
    return (rng.randn(B, H, T, d).astype(np.float32),
            rng.randn(B, H_kv, T_kv, d).astype(np.float32),
            rng.randn(B, H_kv, T_kv, d).astype(np.float32))


def _run(arrays, mask=None, kv_len=None, **kw):
    j = jattn.scaled_dot_product_attention(
        *(jnp.asarray(a) for a in arrays),
        mask=None if mask is None else jnp.asarray(mask),
        kv_len=None if kv_len is None else jnp.asarray(kv_len, jnp.int32), **kw)
    t = tattn.scaled_dot_product_attention(
        *(torch.from_numpy(a) for a in arrays),
        mask=None if mask is None else torch.from_numpy(mask),
        kv_len=None if kv_len is None else torch.tensor(kv_len, dtype=torch.int32), **kw)
    assert t.dtype == torch.float32 and tuple(t.shape) == j.shape
    return np.asarray(j), t.numpy()


# (case, B, H, H_kv, T, T_kv, d, kwargs, routes through flash when the flag is on)
CASES = [
    ("noncausal", 2, 2, 2, 32, 32, 8, dict(), True),
    ("causal", 2, 2, 2, 32, 32, 8, dict(causal=True), True),
    ("gqa_causal", 2, 4, 2, 32, 32, 8, dict(causal=True), True),
    ("mqa", 1, 4, 1, 16, 16, 8, dict(), True),
    ("kv_len", 2, 2, 2, 32, 32, 8, dict(kv_len=[20, 32]), True),
    ("window", 1, 2, 2, 32, 32, 8, dict(causal=True, window=5), True),
    ("scale", 1, 2, 2, 16, 16, 8, dict(causal=True, scale=0.5), True),
    # the routing guard: the kernel is top-left aligned, the composed causal
    # mask bottom-right aligned, so causal Tq != Tk stays composed
    ("causal_tq_ne_tk", 1, 2, 2, 8, 32, 8, dict(causal=True), False),
    ("noncausal_tq_ne_tk", 1, 2, 2, 8, 32, 8, dict(), True),
    # no tile-friendly divisor of T: composed
    ("t_not_div8", 1, 2, 2, 12, 12, 8, dict(causal=True), False),
    ("gqa_t_not_div8", 1, 4, 2, 12, 12, 8, dict(causal=True), False),
]


@pytest.mark.parametrize("flash", [False, True], ids=["composed", "flash"])
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_sdpa_matches_jax(set_both_flags, flash_calls, case, flash):
    name, B, H, H_kv, T, T_kv, d, kw, routes = case
    set_both_flags(use_flash_attention=flash)
    j, t = _run(_qkv(len(name), B, H, H_kv, T, d, T_kv), **kw)
    np.testing.assert_allclose(t, j, **F32_TOL)
    assert len(flash_calls) == int(flash and routes)


@pytest.mark.parametrize("flash", [False, True], ids=["composed", "flash"])
def test_sdpa_additive_mask_never_routes(set_both_flags, flash_calls, flash):
    set_both_flags(use_flash_attention=flash)
    q, k, v = _qkv(1, 2, 2, 2, 16, 8)
    mask = np.where(np.random.RandomState(2).rand(2, 1, 16, 16) < 0.3, -np.inf, 0.0).astype(np.float32)
    mask[..., 0] = 0.0  # every row keeps one key
    j, t = _run((q, k, v), mask=mask)
    np.testing.assert_allclose(t, j, **F32_TOL)
    assert flash_calls == []


def test_sdpa_gqa_head_broadcast_mask(set_both_flags):
    q, k, v = _qkv(3, 1, 4, 2, 16, 8)
    mask = np.zeros((1, 1, 16, 16), np.float32)
    mask[..., 8:] = -np.inf
    j, t = _run((q, k, v), mask=mask)
    np.testing.assert_allclose(t, j, **F32_TOL)


@pytest.mark.parametrize("flash", [False, True], ids=["composed", "flash"])
@pytest.mark.parametrize("h_kv", [4, 2])
def test_sdpa_bf16_compute_matches_jax(set_both_flags, flash, h_kv):
    set_both_flags(use_flash_attention=flash, use_bf16_compute=True)
    j, t = _run(_qkv(4, 2, 4, h_kv, 32, 16), causal=True)
    np.testing.assert_allclose(t, j, rtol=0, atol=2e-2)


def test_sdpa_window_requires_causal():
    from paddle_tpu_torch.core.enforce import EnforceError

    q = torch.zeros(1, 1, 8, 4)
    with pytest.raises(EnforceError, match="causal"):
        tattn.scaled_dot_product_attention(q, q, q, window=2)


@pytest.mark.parametrize("flash", [False, True], ids=["composed", "flash"])
def test_rope_then_sdpa_matches_jax(set_both_flags, flash):
    """The RoPE attention core of the LM: rotate q/k, then causal sdpa."""
    set_both_flags(use_flash_attention=flash)
    q, k, v = _qkv(5, 2, 4, 2, 32, 16)
    jc, js = jattn.rope_tables(16, 32)
    tc, ts = tattn.rope_tables(16, 32)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-6, atol=1e-6)
    j = jattn.scaled_dot_product_attention(
        jattn.apply_rope(jnp.asarray(q), jc, js), jattn.apply_rope(jnp.asarray(k), jc, js),
        jnp.asarray(v), causal=True)
    t = tattn.scaled_dot_product_attention(
        tattn.apply_rope(torch.from_numpy(q), tc, ts), tattn.apply_rope(torch.from_numpy(k), tc, ts),
        torch.from_numpy(v), causal=True)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), **F32_TOL)


@pytest.mark.parametrize("pos0", [0, 100])
def test_rope_tables_and_apply_match_jax(pos0):
    x = np.random.RandomState(6).randn(2, 3, 10, 8).astype(np.float32)
    jc, js = jattn.rope_tables(8, 10, pos0=pos0)
    tc, ts = tattn.rope_tables(8, 10, pos0=pos0)
    np.testing.assert_allclose(
        tattn.apply_rope(torch.from_numpy(x), tc, ts).numpy(),
        np.asarray(jattn.apply_rope(jnp.asarray(x), jc, js)), rtol=1e-5, atol=1e-5)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    assert tattn.apply_rope(xb, tc, ts).dtype == torch.bfloat16


@pytest.mark.parametrize("t_q,t_k", [(8, 8), (4, 8), (8, 4)])
def test_causal_mask_matches_jax(t_q, t_k):
    np.testing.assert_array_equal(tattn.causal_mask(t_q, t_k).numpy(),
                                  np.asarray(jattn.causal_mask(t_q, t_k)))


def test_split_combine_heads_match_jax():
    x = np.random.RandomState(7).randn(2, 5, 12).astype(np.float32)
    th = tattn.split_heads(torch.from_numpy(x), 3)
    np.testing.assert_array_equal(th.numpy(), np.asarray(jattn.split_heads(jnp.asarray(x), 3)))
    np.testing.assert_array_equal(tattn.combine_heads(th).numpy(), x)


def _composed_before_r1(q, k, v, mask=None, scale=None):
    """The composed attention as the port computed it before its products
    moved to ``f32_bmm``: f32 einsums on f32 copies of the operands."""
    scale = scale if scale is not None else 1.0 / np.sqrt(q.shape[-1])
    if k.shape[1] != q.shape[1]:
        b, h, t, d = q.shape
        g = h // k.shape[1]
        logits = torch.einsum("bkgqd,bktd->bkgqt", q.reshape(b, k.shape[1], g, t, d).float(),
                              k.float()) * scale
        if mask is not None:
            logits = logits + mask.float().unsqueeze(-3)
        w = torch.softmax(logits, dim=-1)
        return torch.einsum("bkgqt,bktd->bkgqd", w, v.float()).reshape(b, h, t, -1)
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if mask is not None:
        logits = logits + mask.float()
    return torch.matmul(torch.softmax(logits, dim=-1), v.float())


@pytest.mark.parametrize("h_kv", [4, 2], ids=["mha", "gqa"])
def test_composed_products_unchanged_on_cpu(set_both_flags, h_kv):
    """The composed products run through ``f32_bmm`` (tensor cores on the
    card); on the CPU the result and the gradients of q, k and v are the
    f32 einsums' to f32 rounding."""
    set_both_flags(use_flash_attention=False)
    arrays = _qkv(8, 2, 4, h_kv, 16, 8, T_kv=12)
    mask = np.where(np.random.RandomState(9).rand(2, 1, 16, 12) < 0.2, -np.inf, 0.0).astype(np.float32)
    mask[..., 0] = 0.0
    g = torch.from_numpy(np.random.RandomState(10).randn(2, 4, 16, 8).astype(np.float32))
    outs, grads = [], []
    for fn in (tattn.scaled_dot_product_attention, _composed_before_r1):
        qkv = [torch.from_numpy(a).requires_grad_() for a in arrays]
        out = fn(*qkv, mask=torch.from_numpy(mask))
        outs.append(out.detach())
        grads.append(torch.autograd.grad(out, qkv, g))
    np.testing.assert_allclose(outs[0].numpy(), outs[1].numpy(), rtol=1e-6, atol=1e-6)
    for a, b in zip(*grads):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-6)


def test_sdpa_broadcast_leading_dims_match_jax():
    """Plain (non-GQA) composed attention over 3-D inputs, with k/v
    broadcast along a leading dim."""
    rng = np.random.RandomState(11)
    q = rng.randn(3, 5, 4).astype(np.float32)
    k, v = rng.randn(1, 6, 4).astype(np.float32), rng.randn(1, 6, 4).astype(np.float32)
    j, t = _run((q, k, v))
    np.testing.assert_allclose(t, j, **F32_TOL)


# attention dropout's statistics (the two packages' random streams differ):
# q = k = 0 gives uniform weights 1/T_k over the keys, and v = I (T_k = D)
# makes each output row the dropped weight row itself, so out * T_k * keep
# is the keep mask, exactly.
DROP_B, DROP_H, DROP_T, DROP_RATE = 4, 4, 64, 0.1


@pytest.mark.parametrize("h_kv", [DROP_H, 1], ids=["mha", "mqa"])
def test_attention_dropout_keep_rate(set_both_flags, flash_calls, h_kv):
    set_both_flags(use_flash_attention=True)
    q = torch.zeros(DROP_B, DROP_H, DROP_T, DROP_T)
    k = torch.zeros(DROP_B, h_kv, DROP_T, DROP_T)
    v = torch.eye(DROP_T).expand(DROP_B, h_kv, DROP_T, DROP_T).contiguous()
    keep = 1.0 - DROP_RATE
    gen = torch.Generator().manual_seed(0)
    out = tattn.scaled_dot_product_attention(q, k, v, dropout_rate=DROP_RATE, is_test=False,
                                             dropout_generator=gen)
    mask = out * DROP_T * keep
    np.testing.assert_allclose(mask.numpy(), np.round(mask.numpy()), atol=1e-5)
    n = mask.numel()
    rate = float(mask.sum()) / n
    assert abs(rate - keep) <= 4 * np.sqrt(keep * (1 - keep) / n), rate
    assert flash_calls == []  # training-mode dropout composes attention
    # the same seed draws the same mask; is_test drops nothing
    again = tattn.scaled_dot_product_attention(q, k, v, dropout_rate=DROP_RATE, is_test=False,
                                               dropout_generator=torch.Generator().manual_seed(0))
    assert torch.equal(out, again)
    plain = tattn.scaled_dot_product_attention(q, k, v, dropout_rate=DROP_RATE, is_test=True)
    np.testing.assert_allclose(plain.numpy(), 1.0 / DROP_T, rtol=1e-6)


def test_attention_dropout_expectation_is_the_undropped_output(set_both_flags):
    """Over many mask draws the mean output is the undropped output: the
    total and a random-sign projection of the difference, each within 4
    sigma of 0 (sigma from the draws' spread)."""
    set_both_flags(use_flash_attention=False)
    q, k, v = (torch.from_numpy(a) for a in _qkv(12, 2, 2, 2, 16, 8))
    ref = tattn.scaled_dot_product_attention(q, k, v)
    signs = torch.from_numpy(np.random.RandomState(13).choice([-1.0, 1.0], size=ref.shape)
                             .astype(np.float32))
    gen = torch.Generator().manual_seed(1)
    stats = []
    for _ in range(400):
        d = tattn.scaled_dot_product_attention(q, k, v, dropout_rate=0.3, is_test=False,
                                               dropout_generator=gen) - ref
        stats.append([float(d.sum()), float((d * signs).sum())])
    stats = np.asarray(stats)
    z = stats.mean(0) / (stats.std(0, ddof=1) / np.sqrt(len(stats)))
    assert np.all(np.abs(z) <= 4), z


def test_attention_dropout_draws_from_the_frame_generator():
    """Inside a training apply, attention dropout draws from the apply's
    ``rng`` (none given: the framework's error), and init draws nothing."""
    from paddle_tpu_torch import framework
    from paddle_tpu_torch.core.enforce import EnforceError

    q = torch.from_numpy(_qkv(14, 1, 2, 2, 8, 4)[0])
    model = framework.build(lambda x: tattn.scaled_dot_product_attention(
        x, x, x, dropout_rate=0.5, is_test=not framework.is_training()))
    params = {"unused": torch.zeros(1)}
    model.init(0, q, device="cpu")
    a, _ = model.apply(params, q, is_train=True, rng=torch.Generator().manual_seed(2))
    b, _ = model.apply(params, q, is_train=True, rng=torch.Generator().manual_seed(2))
    assert torch.equal(a, b)
    with pytest.raises(EnforceError, match="rng"):
        model.apply(params, q, is_train=True)
    ev, _ = model.apply(params, q)
    assert torch.equal(ev, tattn.scaled_dot_product_attention(q, q, q))
