"""The port's flash-attention forward (``paddle_tpu_torch.ops.cuda``) against
the JAX package's Pallas kernel.

On the CPU the port's wrappers run their plain PyTorch version; the JAX
kernel runs in Pallas interpret mode, as ``tests/test_pallas_kernels.py``
runs it. Inputs come from a numpy seed and go through both. f32 is compared
at rtol=2e-4, atol=2e-5 (the same tolerance the JAX package holds its own
kernel to); bf16 at 2e-2 absolute on ``out`` (both read the same bf16
inputs, but the plain version rounds the probabilities to bf16 before the
P V product as ``_reference_attention`` does, and ``out`` is stored in
bf16) and 1e-4 on the f32 ``lse``.

The CUDA kernel itself is held against the plain version on the card by
``chip_smoke.py`` and ``tests/test_torch_cuda_kernels.py``.
"""

import torch_threads  # noqa: F401  (first: its share of the cores)
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

jfa = importlib.import_module("paddle_tpu.ops.pallas.flash_attention")
tfa = importlib.import_module("paddle_tpu_torch.ops.cuda.flash_attention")

F32_TOL = dict(rtol=2e-4, atol=2e-5)
BF16_OUT_ATOL = 2e-2
BF16_LSE_ATOL = 1e-4


def _inputs(seed, B, H, H_kv, T, d, T_kv=None):
    rng = np.random.RandomState(seed)
    T_kv = T if T_kv is None else T_kv
    q = rng.randn(B, H, T, d).astype(np.float32)
    k = rng.randn(B, H_kv, T_kv, d).astype(np.float32)
    v = rng.randn(B, H_kv, T_kv, d).astype(np.float32)
    return q, k, v


def _both(q, k, v, dtype="float32", kv_len=None, **kw):
    """(jax out, jax lse, port out, port lse) as f32 numpy arrays."""
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    j_out, j_lse = jfa.flash_attention_with_lse(
        *(jnp.asarray(a).astype(jdt) for a in (q, k, v)),
        kv_len=None if kv_len is None else jnp.asarray(kv_len, jnp.int32), **kw,
    )
    t_out, t_lse = tfa.flash_attention_with_lse(
        *(torch.from_numpy(a).to(tdt) for a in (q, k, v)),
        kv_len=None if kv_len is None else torch.tensor(kv_len, dtype=torch.int32), **kw,
    )
    assert t_out.dtype == tdt and t_lse.dtype == torch.float32
    assert tuple(t_out.shape) == j_out.shape and tuple(t_lse.shape) == j_lse.shape
    return (np.asarray(j_out.astype(jnp.float32)), np.asarray(j_lse),
            t_out.float().numpy(), t_lse.numpy())


# (case, B, H, H_kv, T, T_kv, d, kwargs)
F32_CASES = [
    ("noncausal", 2, 4, 4, 64, 64, 16, dict(causal=False)),
    ("causal", 2, 4, 4, 64, 64, 16, dict(causal=True)),
    ("causal_blocks16", 2, 2, 2, 64, 64, 16, dict(causal=True, block_q=16, block_k=16)),
    ("gqa", 2, 4, 2, 64, 64, 16, dict(causal=True)),
    ("mqa", 1, 4, 1, 32, 32, 8, dict(causal=False)),
    ("window", 2, 2, 2, 64, 64, 16, dict(causal=True, window=24, block_q=16, block_k=16)),
    ("gqa_window", 1, 4, 2, 64, 64, 16, dict(causal=True, window=9, block_q=16, block_k=16)),
    ("kv_len", 2, 2, 2, 64, 64, 16, dict(causal=False, kv_len=[40, 64], block_q=16, block_k=16)),
    ("kv_len_causal", 2, 2, 2, 64, 64, 16, dict(causal=True, kv_len=[64, 17], block_q=16, block_k=16)),
    ("q_off", 1, 2, 2, 32, 64, 16, dict(causal=True, q_off=32, block_q=16, block_k=16)),
    ("q_off_window", 1, 2, 2, 32, 64, 16, dict(causal=True, q_off=32, window=20, block_q=16, block_k=16)),
    ("t192", 1, 2, 2, 192, 192, 16, dict(causal=True)),
    ("t192_noncausal", 1, 2, 1, 192, 192, 32, dict(causal=False)),
    ("sm_scale", 1, 2, 2, 32, 32, 16, dict(causal=True, sm_scale=0.3)),
]


@pytest.mark.parametrize("case", F32_CASES, ids=[c[0] for c in F32_CASES])
def test_flash_fwd_matches_jax_f32(case):
    name, B, H, H_kv, T, T_kv, d, kw = case
    q, k, v = _inputs(len(name), B, H, H_kv, T, d, T_kv)
    j_out, j_lse, t_out, t_lse = _both(q, k, v, **kw)
    np.testing.assert_allclose(t_out, j_out, **F32_TOL)
    np.testing.assert_allclose(t_lse, j_lse, **F32_TOL)


def test_flash_fwd_matches_jax_bf16():
    q, k, v = _inputs(3, 2, 4, 2, 64, 16)
    j_out, j_lse, t_out, t_lse = _both(q, k, v, "bfloat16", causal=True, window=40)
    np.testing.assert_allclose(t_out, j_out, rtol=0, atol=BF16_OUT_ATOL)
    np.testing.assert_allclose(t_lse, j_lse, rtol=0, atol=BF16_LSE_ATOL)


def test_flash_fwd_rows_without_live_key():
    """k_off places every key after the first q rows: those rows have no
    live key. Only rows with a live key are compared; the others are defined
    by lse < -1e8 alone (the JAX kernel skips their tiles and writes 0, the
    plain version averages V), in both packages."""
    q, k, v = _inputs(5, 1, 2, 2, 64, 16)
    j_out, j_lse, t_out, t_lse = _both(q, k, v, causal=True, k_off=24, block_q=16, block_k=16)
    dead = np.arange(64) < 24  # q_pos < k_off: no key at or before it
    np.testing.assert_allclose(t_out[:, :, ~dead], j_out[:, :, ~dead], **F32_TOL)
    np.testing.assert_allclose(t_lse[:, :, ~dead], j_lse[:, :, ~dead], **F32_TOL)
    assert (t_lse[:, :, dead] < -1e8).all() and (j_lse[:, :, dead] < -1e8).all()


def test_flash_attention_out_equals_with_lse_out():
    q, k, v = (torch.from_numpy(a) for a in _inputs(6, 1, 2, 2, 32, 16))
    out = tfa.flash_attention(q, k, v, causal=True, window=7)
    out2, _ = tfa.flash_attention_with_lse(q, k, v, causal=True, window=7)
    torch.testing.assert_close(out, out2, rtol=0, atol=0)
    jout = jfa.flash_attention(*(jnp.asarray(a.numpy()) for a in (q, k, v)), causal=True, window=7)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **F32_TOL)


def test_flash_cpu_path_does_not_count_launches():
    """The launch count rises only where the CUDA kernel launches; the plain
    version on CPU tensors is not a launch."""
    q, k, v = (torch.from_numpy(a) for a in _inputs(7, 1, 2, 2, 32, 16))
    before = tfa.FLASH_FWD.launches
    tfa.flash_attention(q, k, v, causal=True)
    assert tfa.FLASH_FWD.launches == before


def test_flash_window_requires_causal():
    from paddle_tpu_torch.core.enforce import EnforceError

    q, k, v = (torch.from_numpy(a) for a in _inputs(8, 1, 1, 1, 16, 8))
    with pytest.raises(EnforceError, match="causal"):
        tfa.flash_attention(q, k, v, causal=False, window=4)
    with pytest.raises(EnforceError, match="window"):
        tfa.flash_attention(q, k, v, causal=True, window=0)


def test_flash_rejects_indivisible_heads():
    from paddle_tpu_torch.core.enforce import EnforceError

    q, k, v = (torch.from_numpy(a) for a in _inputs(9, 1, 3, 2, 16, 8))
    with pytest.raises(EnforceError, match="not divisible"):
        tfa.flash_attention(q, k, v)


@pytest.mark.parametrize("block,total", [
    (128, 64), (128, 192), (128, 1024), (96, 192), (128, 100), (64, 7),
    (128, 8192), (128, 136), (17, 34), (128, 1), (0, 12), (128, 384),
])
def test_fit_block_matches_jax(block, total):
    assert tfa.fit_block(block, total) == jfa.fit_block(block, total)


@pytest.mark.parametrize("t_q,t_kv", [(64, 64), (1024, 1024), (192, 192), (4096, 2048), (8, 8)])
def test_tuned_blocks_matches_jax(monkeypatch, t_q, t_kv):
    assert tfa.tuned_blocks(t_q, t_kv) == jfa.tuned_blocks(t_q, t_kv)
    assert tfa.resolve_blocks(t_q, t_kv) == jfa.resolve_blocks(t_q, t_kv)
    table = [(256, 64, 128), (2048, 256, 512)]
    monkeypatch.setattr(jfa, "_TUNED_BLOCKS", table)
    monkeypatch.setattr(tfa, "_TUNED_BLOCKS", table)
    assert tfa.tuned_blocks(t_q, t_kv) == jfa.tuned_blocks(t_q, t_kv)


def test_resolve_blocks_refuses_unported_autotune():
    from paddle_tpu_torch.core.config import set_flags

    set_flags(autotune=True)
    try:
        with pytest.raises(NotImplementedError, match="autotune"):
            tfa.resolve_blocks(64, 64)
    finally:
        set_flags(autotune=False)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kw", [dict(causal=False), dict(causal=True, window=6),
                                dict(causal=True, kv_len=[9, 32])], ids=["plain", "window", "kv_len"])
def test_reference_attention_matches_jax(dtype, kw):
    """The plain version against the JAX package's ``_reference_attention``:
    both round the probabilities to the input dtype before the P V product
    and accumulate in f32, so bf16 agrees to bf16 output rounding."""
    kw = dict(kw)
    q, k, v = _inputs(10, 2, 4, 2, 32, 16)
    kv_len = kw.pop("kv_len", None)
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if dtype == "bfloat16" else (jnp.float32, torch.float32)
    j = jfa._reference_attention(
        *(jnp.asarray(a).astype(jdt) for a in (q, k, v)), sm_scale=0.25,
        kv_len=None if kv_len is None else jnp.asarray(kv_len), **kw)
    t = tfa._reference_attention(
        *(torch.from_numpy(a).to(tdt) for a in (q, k, v)), sm_scale=0.25,
        kv_len=None if kv_len is None else torch.tensor(kv_len), **kw)
    assert t.dtype == tdt
    tol = dict(rtol=0, atol=1e-2) if dtype == "bfloat16" else F32_TOL
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j.astype(jnp.float32)), **tol)
