"""The port's paged-cache functions and ``generate_beam``
(``paddle_tpu_torch.models.transformer_lm``) against the JAX package's, on
identical weights (the JAX ``init``'s parameters carried across with
``convert.params_from_jax``), pages, page tables and tokens.

Small sizes (2 layers, d_model 32, vocab 97) on the CPU, f32, in the
``base``, ``gqa_rope`` and ``window_swiglu`` variants. The pages each
function returns agree within atol 1e-5 (the two packages sum the same f32
products in another order: ~1e-6) and its tokens are equal. The port writes
the pages in place and returns the tensors it was given.
"""

import torch_threads  # noqa: F401  (first: its share of the cores)
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu import models as jmodels
from paddle_tpu.core import config as jconfig
from paddle_tpu.models import transformer_lm as jlm
from paddle_tpu_torch import convert
from paddle_tpu_torch.core import config as tconfig
from paddle_tpu_torch.models import transformer_lm as tlm

VOCAB = 97
SMALL = dict(seq_len=16, vocab=VOCAB, d_model=32, d_inner=64, num_heads=4, n_layers=2)
VARIANTS = {
    "base": {},
    "gqa_rope": dict(num_kv_heads=2, pos_encoding="rope"),
    "window_swiglu": dict(attention_window=5, ffn_activation="swiglu"),
}
PAGES_ATOL = 1e-5
PAGE_SIZE, NUM_PAGES = 4, 20
# three slots' page tables, 6 pages (24 positions) each, no page shared
TABLES = np.array([[3, 7, 1, 9, 2, 5], [4, 6, 8, 10, 11, 12], [13, 14, 15, 16, 17, 18]], np.int32)


@pytest.fixture(scope="module", params=list(VARIANTS))
def model(request):
    jspec = jmodels.get_model("transformer_lm", **SMALL, **VARIANTS[request.param])
    cfg = jspec.extra["cfg"]
    rng = np.random.RandomState(0)
    jvars = jspec.model.init(jax.random.PRNGKey(0), *jspec.synth_batch(2, rng))
    tparams = convert.params_from_jax({n: np.asarray(a) for n, a in jvars.params.items()}, "cpu")
    shape = jlm.paged_cache_shape(cfg, NUM_PAGES, PAGE_SIZE)
    pages = (rng.randn(*shape).astype(np.float32), rng.randn(*shape).astype(np.float32))
    return cfg, jvars.params, tparams, pages


def _jit(fn, cfg):
    """The JAX function jitted, as the JAX package's engine runs it (one
    compile instead of one per primitive)."""
    return jax.jit(functools.partial(fn, cfg=cfg, page_size=PAGE_SIZE))


def _assert_pages(jpages, tpages):
    for j, t in zip(jpages, tpages):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0, atol=PAGES_ATOL)


def test_paged_cache_shape_matches_jax(model):
    cfg = model[0]
    assert tlm.paged_cache_shape(cfg, NUM_PAGES, PAGE_SIZE) == jlm.paged_cache_shape(
        cfg, NUM_PAGES, PAGE_SIZE)


@pytest.mark.parametrize("pos0,last", [(0, 7), (4, 5), (16, 7)], ids=["first", "mid", "last_pages"])
def test_paged_prefill_chunk_matches_jax(model, pos0, last):
    cfg, jparams, tparams, (kp, vp) = model
    toks = np.random.RandomState(pos0).randint(1, VOCAB, size=(8,)).astype(np.int32)
    jtok, jk, jv = _jit(jlm.paged_prefill_chunk, cfg)(
        jparams, jnp.asarray(toks), jnp.int32(pos0), jnp.int32(last), jnp.asarray(TABLES[0]),
        jnp.asarray(kp), jnp.asarray(vp))
    tk, tv = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
    ttok, rk, rv = tlm.paged_prefill_chunk(
        tparams, torch.from_numpy(toks), pos0, last, torch.from_numpy(TABLES[0]), tk, tv,
        cfg=cfg, page_size=PAGE_SIZE)
    assert rk is tk and rv is tv  # written in place
    assert ttok.dtype == torch.int32 and ttok.dim() == 0
    assert int(ttok) == int(jtok)
    _assert_pages((jk, jv), (tk, tv))


def test_paged_decode_step_matches_jax(model):
    cfg, jparams, tparams, (kp, vp) = model
    rng = np.random.RandomState(5)
    toks = rng.randint(1, VOCAB, size=(3,)).astype(np.int32)
    pos = np.array([11, 3, 23], np.int32)  # mid-page, first page, last position
    jn, jk, jv = _jit(jlm.paged_decode_step, cfg)(
        jparams, jnp.asarray(toks), jnp.asarray(pos), jnp.asarray(TABLES),
        jnp.asarray(kp), jnp.asarray(vp))
    tk, tv = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
    tn, _, _ = tlm.paged_decode_step(
        tparams, torch.from_numpy(toks), torch.from_numpy(pos), torch.from_numpy(TABLES), tk, tv,
        cfg=cfg, page_size=PAGE_SIZE)
    assert tn.dtype == torch.int32 and tuple(tn.shape) == (3,)
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    _assert_pages((jk, jv), (tk, tv))


def test_paged_verify_step_matches_jax(model):
    cfg, jparams, tparams, (kp, vp) = model
    rng = np.random.RandomState(6)
    block = rng.randint(1, VOCAB, size=(3, 4)).astype(np.int32)
    pos = np.array([11, 0, 18], np.int32)  # blocks that cross page boundaries
    jo, jk, jv = _jit(jlm.paged_verify_step, cfg)(
        jparams, jnp.asarray(block), jnp.asarray(pos), jnp.asarray(TABLES),
        jnp.asarray(kp), jnp.asarray(vp))
    tk, tv = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
    to, _, _ = tlm.paged_verify_step(
        tparams, torch.from_numpy(block), torch.from_numpy(pos), torch.from_numpy(TABLES), tk, tv,
        cfg=cfg, page_size=PAGE_SIZE)
    assert to.dtype == torch.int32 and tuple(to.shape) == (3, 4)
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    _assert_pages((jk, jv), (tk, tv))


def test_paged_scatter_shape_pins_advanced_indexing():
    """``pages[i][phys, :, off] = v``: the two index arrays around a slice
    put their broadcast dims first ([N, Q, H_kv, dh]), in PyTorch as in
    NumPy (and so JAX's ``.at[i, phys, :, off]``)."""
    pages = np.zeros((2, 5, 3, 4, 2), np.float32)
    phys, off = np.array([[1, 4]]), np.array([[2, 0]])
    val = np.arange(2 * 3 * 2, dtype=np.float32).reshape(1, 2, 3, 2)
    pages[1][phys, :, off] = val
    t = torch.zeros(2, 5, 3, 4, 2)
    t[1][torch.from_numpy(phys), :, torch.from_numpy(off)] = torch.from_numpy(val)
    np.testing.assert_array_equal(t.numpy(), pages)
    assert tuple(t[1][torch.from_numpy(phys), :, torch.from_numpy(off)].shape) == (1, 2, 3, 2)


def test_paged_sampling_needs_a_generator(model):
    cfg, _, tparams, (kp, vp) = model
    with pytest.raises(Exception, match="Generator"):
        tlm.paged_decode_step(tparams, torch.ones(3, dtype=torch.int32),
                              torch.zeros(3, dtype=torch.int32), torch.from_numpy(TABLES),
                              torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy()),
                              cfg=cfg, page_size=PAGE_SIZE, temperature=0.7)


@pytest.fixture
def flash_flag():
    saved = tconfig.flags().use_flash_attention
    yield
    tconfig.set_flags(use_flash_attention=saved)


@pytest.fixture(scope="module")
def beam_refs(model):
    """The JAX package's beams (composed attention) for a prompt of 17
    tokens (a 16-position prefill, which the flash tiling divides) and of
    1 token (no prefill), with a length penalty."""
    cfg, jparams, _, _ = model
    assert not jconfig.flags().use_flash_attention
    rng = np.random.RandomState(7)
    beam = jax.jit(functools.partial(jlm.generate_beam, max_new_tokens=6, cfg=cfg, beam_size=3,
                                     length_penalty_alpha=0.6))
    refs = []
    for tp in (17, 1):
        prompt = rng.randint(2, VOCAB, size=(2, tp)).astype(np.int32)
        js, jsc = beam(jparams, jnp.asarray(prompt))
        refs.append((prompt, np.asarray(js), np.asarray(jsc)))
    return refs


@pytest.mark.parametrize("flash", [False, True], ids=["composed", "flash"])
def test_generate_beam_matches_jax(model, beam_refs, flash_flag, flash):
    """Sequences equal and scores within 1e-5, the port's prefill composed
    or through the flash wrapper (its plain version on the CPU)."""
    cfg, _, tparams, _ = model
    tconfig.set_flags(use_flash_attention=flash)
    for prompt, js, jsc in beam_refs:
        ts, tsc = tlm.generate_beam(tparams, torch.from_numpy(prompt), 6, cfg, beam_size=3,
                                    length_penalty_alpha=0.6, device="cpu")
        assert tuple(ts.shape) == (2, 3, 6) and tuple(tsc.shape) == (2, 3)
        np.testing.assert_array_equal(ts.numpy(), js)
        np.testing.assert_allclose(tsc.numpy(), jsc, rtol=0, atol=1e-5)


def test_generate_beam_prefill_routes_flash_once_per_layer(model, flash_flag, monkeypatch):
    import importlib

    cfg, _, tparams, _ = model
    tfa = importlib.import_module("paddle_tpu_torch.ops.cuda.flash_attention")
    calls = []
    real = tfa.flash_attention
    monkeypatch.setattr(tfa, "flash_attention", lambda *a, **k: calls.append(1) or real(*a, **k))
    tconfig.set_flags(use_flash_attention=True)
    prompt = torch.from_numpy(np.random.RandomState(8).randint(2, VOCAB, size=(2, 17)).astype(np.int32))
    tlm.generate_beam(tparams, prompt, 4, cfg, beam_size=2, device="cpu")
    assert len(calls) == SMALL["n_layers"]
    calls.clear()
    tlm.generate_beam(tparams, prompt[:, :16], 4, cfg, beam_size=2, device="cpu")
    assert not calls  # a 15-position prefill has no flash tiling: it composes
