"""The port's flash-attention backward (``paddle_tpu_torch.ops.cuda``)
against the JAX package's.

On the CPU the port's ``flash_attention`` is a ``torch.autograd.Function``
whose backward runs the plain versions of the dK/dV and dQ kernels (or,
with ``flash_fused_bwd`` off, autograd through the plain attention); the JAX
side is ``jax.grad`` of its ``flash_attention`` with the Pallas kernels in
interpret mode, as ``tests/test_pallas_kernels.py`` runs them. Inputs and
the output cotangent come from a numpy seed and go through both.

Tolerances: f32 gradients at rtol=2e-4, atol=2e-5 (the forward's; both
compute in f32 and differ by summation order). bf16 at 1e-2 absolute and
relative: both read the same bf16 inputs and compute in f32, and round the
gradients to bf16 once at the end, where one ulp is 2^-8 relative.

The CUDA kernels themselves are held against the plain versions on the
card by ``chip_smoke.py`` and ``tests/test_torch_cuda_kernels.py``.
"""

import torch_threads  # noqa: F401  (first: its share of the cores)
import importlib
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.core import config as jconfig
from paddle_tpu_torch.core import config as tconfig

jfa = importlib.import_module("paddle_tpu.ops.pallas.flash_attention")
tfa = importlib.import_module("paddle_tpu_torch.ops.cuda.flash_attention")

F32_TOL = dict(rtol=2e-4, atol=2e-5)
BF16_TOL = dict(rtol=1e-2, atol=1e-2)


@pytest.fixture
def fused_bwd():
    saved = (jconfig.flags().flash_fused_bwd, tconfig.flags().flash_fused_bwd)

    def set_(on: bool):
        jconfig.set_flags(flash_fused_bwd=on)
        tconfig.set_flags(flash_fused_bwd=on)

    yield set_
    jconfig.set_flags(flash_fused_bwd=saved[0])
    tconfig.set_flags(flash_fused_bwd=saved[1])


def _inputs(seed, B, H, H_kv, T, d, T_kv=None):
    rng = np.random.RandomState(seed)
    T_kv = T if T_kv is None else T_kv
    return (rng.randn(B, H, T, d).astype(np.float32), rng.randn(B, H_kv, T_kv, d).astype(np.float32),
            rng.randn(B, H_kv, T_kv, d).astype(np.float32), rng.randn(B, H, T, d).astype(np.float32))


def _grads_both(q, k, v, g, dtype="float32", kv_len=None, **kw):
    """(jax (dq, dk, dv), port (dq, dk, dv)) as f32 numpy arrays, the
    gradients of sum(flash_attention(q, k, v) * g)."""
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    jlen = None if kv_len is None else jnp.asarray(kv_len, jnp.int32)
    gj = jnp.asarray(g).astype(jdt)

    def loss(a, b, c):
        return jnp.sum((jfa.flash_attention(a, b, c, kv_len=jlen, **kw) * gj).astype(jnp.float32))

    jg = jax.grad(loss, argnums=(0, 1, 2))(*(jnp.asarray(a).astype(jdt) for a in (q, k, v)))
    prim = [torch.from_numpy(a).to(tdt).requires_grad_() for a in (q, k, v)]
    out = tfa.flash_attention(
        *prim, kv_len=None if kv_len is None else torch.tensor(kv_len, dtype=torch.int32), **kw)
    tg = torch.autograd.grad(out, prim, torch.from_numpy(g).to(tdt))
    for a, t in zip(prim, tg):
        assert t.dtype == tdt and t.shape == a.shape
    return ([np.asarray(a.astype(jnp.float32)) for a in jg], [t.float().numpy() for t in tg])


# (case, B, H, H_kv, T, d, kwargs) — every row keeps a live key
CASES = [
    ("causal", 2, 2, 2, 64, 16, dict(causal=True)),
    ("noncausal", 1, 2, 2, 64, 16, dict(causal=False)),
    ("t192", 1, 2, 2, 192, 16, dict(causal=True)),
    ("gqa", 1, 4, 2, 64, 16, dict(causal=True)),
    ("window", 1, 2, 2, 64, 16, dict(causal=True, window=24, block_q=16, block_k=16)),
    ("kv_len", 2, 2, 2, 64, 16, dict(causal=False, kv_len=[40, 64], block_q=16, block_k=16)),
    ("kv_len_causal", 2, 2, 1, 64, 16, dict(causal=True, kv_len=[64, 17], block_q=16, block_k=16)),
]


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_flash_bwd_matches_jax_f32(case):
    name, B, H, H_kv, T, d, kw = case
    q, k, v, g = _inputs(len(name), B, H, H_kv, T, d)
    jg, tg = _grads_both(q, k, v, g, **kw)
    for a, b in zip(tg, jg):
        np.testing.assert_allclose(a, b, **F32_TOL)


def test_flash_bwd_matches_jax_bf16():
    q, k, v, g = _inputs(3, 2, 4, 2, 64, 16)
    jg, tg = _grads_both(q, k, v, g, "bfloat16", causal=True, window=40)
    for a, b in zip(tg, jg):
        np.testing.assert_allclose(a, b, **BF16_TOL)


@pytest.mark.parametrize("kw", [dict(causal=True), dict(causal=True, window=20, kv_len=[64, 50])],
                         ids=["causal", "window_kv_len"])
def test_recomputed_bwd_matches_jax(fused_bwd, kw):
    """flash_fused_bwd off: autograd through the plain attention in the
    port, ``jax.vjp`` of ``_reference_attention`` in the JAX package."""
    fused_bwd(False)
    q, k, v, g = _inputs(11, 2, 4, 2, 64, 16)
    jg, tg = _grads_both(q, k, v, g, **kw)
    for a, b in zip(tg, jg):
        np.testing.assert_allclose(a, b, **F32_TOL)


def test_fused_and_recomputed_bwd_agree(fused_bwd):
    q, k, v, g = _inputs(12, 1, 4, 1, 96, 16)
    grads = []
    for on in (True, False):
        fused_bwd(on)
        prim = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
        grads.append(torch.autograd.grad(
            tfa.flash_attention(*prim, causal=True, window=30), prim, torch.from_numpy(g)))
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("kw", [
    dict(causal=True, q_off=64, k_off=0),
    dict(causal=True, q_off=64, k_off=32, window=40),
], ids=["q_off", "offsets_window"])
def test_flash_bwd_block_matches_jax(kw):
    """One block pair's backward against GLOBAL residuals (the forward's
    out and lse), at nonzero offsets: q rows at global positions 64..127
    against keys from ``k_off``; every row keeps a live key."""
    q, k, v, g = _inputs(13, 1, 2, 2, 64, 16, T_kv=96)
    jq, jk, jv, jgr = (jnp.asarray(a) for a in (q, k, v, g))
    j_out, j_lse = jfa.flash_attention_with_lse(jq, jk, jv, block_q=16, block_k=16, **kw)
    jd = jfa.flash_attention_bwd_block(jq, jk, jv, j_out, j_lse, jgr, block_q=16, block_k=16, **kw)
    tq, tk, tv, tg = (torch.from_numpy(a) for a in (q, k, v, g))
    t_out, t_lse = tfa.flash_attention_with_lse(tq, tk, tv, **kw)
    td = tfa.flash_attention_bwd_block(tq, tk, tv, t_out, t_lse, tg, **kw)
    for a, b in zip(td, jd):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **F32_TOL)


def test_plain_backward_passes_gradcheck():
    """Finite differences of the forward against the custom backward's
    plain versions, in f32 (the plain versions compute in f32): eps 1e-2
    keeps f32 rounding of the difference quotient near 1e-5; atol/rtol 2e-3
    cover the O(eps^2) truncation at these unit-scale inputs."""
    q, k, v, _ = _inputs(14, 1, 2, 1, 12, 4, T_kv=12)
    prim = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    with warnings.catch_warnings():  # gradcheck warns on inputs that are not f64
        warnings.simplefilter("ignore", UserWarning)
        assert torch.autograd.gradcheck(
            lambda a, b, c: tfa.flash_attention(a, b, c, causal=True, window=5),
            prim, eps=1e-2, atol=2e-3, rtol=2e-3)


def test_bwd_kernel_plain_versions_are_what_autograd_runs():
    """On CPU tensors the autograd Function's backward is exactly the two
    plain versions on the forward's residuals, and no launch is counted."""
    q, k, v, g = (torch.from_numpy(a) for a in _inputs(15, 1, 4, 2, 32, 8))
    prim = [t.clone().requires_grad_() for t in (q, k, v)]
    before = (tfa.FLASH_BWD_DKV.launches, tfa.FLASH_BWD_DQ.launches)
    grads = torch.autograd.grad(tfa.flash_attention(*prim, causal=True), prim, g)
    assert (tfa.FLASH_BWD_DKV.launches, tfa.FLASH_BWD_DQ.launches) == before
    out, lse = tfa.flash_attention_with_lse(q, k, v, causal=True)
    delta = (g * out).sum(-1, keepdim=True)
    args = (q, k, v, g, lse, delta, True, 8 ** -0.5)
    dk, dv = tfa._flash_bwd_dkv_reference(*args)
    dq = tfa._flash_bwd_dq_reference(*args)
    for a, b in zip(grads, (dq, dk, dv)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_with_lse_and_bwd_block_carry_no_gradient():
    """Like the JAX package's, the blockwise building blocks are not
    differentiable: their outputs never require a gradient."""
    q, k, v, g = (torch.from_numpy(a).requires_grad_() for a in _inputs(16, 1, 2, 2, 16, 8))
    out, lse = tfa.flash_attention_with_lse(q, k, v, causal=True)
    assert not out.requires_grad and not lse.requires_grad
    assert not any(t.requires_grad for t in tfa.flash_attention_bwd_block(q, k, v, out, lse, g, causal=True))


def test_kv_len_gets_no_gradient():
    q, k, v, g = (torch.from_numpy(a) for a in _inputs(17, 2, 2, 2, 16, 8))
    prim = [t.requires_grad_() for t in (q, k, v)]
    kv_len = torch.tensor([16.0, 9.0], requires_grad=True)
    out = tfa.flash_attention(*prim, causal=True, kv_len=kv_len)
    out.backward(g)
    assert kv_len.grad is None and all(t.grad is not None for t in prim)
