"""The book's chapters (``tests/test_book.py``: fit_a_line, word2vec,
recommender_system, label_semantic_roles, understand_sentiment,
recognize_digits, image_classification) trained through the port and
through the JAX package on the CPU in f32, from the same weights (the JAX
init carried across) on the same synthetic batches of the chapters' shapes.

The chapter nets and batches are ``chip_smoke.book_chapters`` /
``book_batch``, written once against either package's layer catalog; the
card phase ``catalog`` trains the same nets. Each chapter takes 4 Adam
steps on one batch: the losses agree within 1e-4 relative at every step,
and the loss falls. The reference book's SRL tagger (``srl_net``) runs at
small widths the same way, and its Viterbi tags agree.
"""

import torch_threads  # noqa: F401  (first: its share of the cores)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import paddle_tpu as jpt
import paddle_tpu_torch as tpt
from paddle_tpu_torch import convert

STEPS, LOSS_RTOL = 4, 1e-4
CHAPTERS = sorted(chip_smoke.book_chapters(tpt))


def _train_both(j_net, t_net, lr, batch, steps):
    jm, tm = jpt.build(j_net), tpt.build(t_net)
    jb = [jnp.asarray(a) for a in batch]
    tb = [torch.from_numpy(np.array(a)) for a in batch]
    jv = jm.init(0, *jb)
    tv = convert.variables_from_jax(jv, "cpu")
    jopt, topt = jpt.optimizer.Adam(learning_rate=lr), tpt.optimizer.Adam(learning_rate=lr)
    js, ts = jopt.create_state(jv.params), topt.create_state(tv.params)
    jstep, tstep = jax.jit(jopt.minimize(jm)), topt.minimize(tm)
    jl, tl = [], []
    for _ in range(steps):
        jo, to = jstep(jv, js, *jb), tstep(tv, ts, *tb)
        jv, js, tv, ts = jo.variables, jo.opt_state, to.variables, to.opt_state
        jl.append(float(jo.loss))
        tl.append(float(to.loss))
    return jl, tl, jv, tv


@pytest.mark.parametrize("chapter", CHAPTERS)
def test_chapter_trains_as_the_jax_package(chapter):
    (j_net, lr), (t_net, _) = (chip_smoke.book_chapters(p)[chapter] for p in (jpt, tpt))
    jl, tl, _, _ = _train_both(j_net, t_net, lr, chip_smoke.book_batch(chapter), STEPS)
    np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL)
    assert tl[-1] < tl[0], tl


def test_book_batches_have_the_chapters_shapes():
    shapes = {n: [a.shape for a in chip_smoke.book_batch(n)] for n in CHAPTERS}
    assert shapes["fit_a_line"] == [(64, 13), (64, 1)]
    assert shapes["label_semantic_roles"] == [(16, 30)] * 3 + [(16,)]
    assert shapes["understand_sentiment"] == [(32, 100), (32,), (32,)]
    words, _, _, lengths = chip_smoke.book_batch("label_semantic_roles")
    assert np.all(words[np.arange(30)[None, :] >= lengths[:, None]] == 0)


def test_srl_tagger_at_small_widths():
    cfg = dict(chip_smoke.SRL_CFG, word_dim=8, mark_dim=3, hidden=16, depth=3, labels=7,
               words=50, preds=11, batch=4, min_len=3, max_len=9)
    batch = chip_smoke.srl_batch(cfg)
    jl, tl, jv, tv = _train_both(chip_smoke.srl_net(jpt, cfg), chip_smoke.srl_net(tpt, cfg),
                                 chip_smoke.SRL_LR, batch, 3)
    np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL)
    assert tuple(tv.params["emb/w"].shape) == (50, 8) and tuple(tv.params["crfw"].shape) == (9, 7)
    # Viterbi over the trained emissions, from each package's own weights
    jm, tm = jpt.build(chip_smoke.srl_net(jpt, cfg)), tpt.build(chip_smoke.srl_net(tpt, cfg))
    (_, j_em), _ = jm.apply(jv, *(jnp.asarray(a) for a in batch))
    (_, t_em), _ = tm.apply(tv, *(torch.from_numpy(a) for a in batch))
    np.testing.assert_allclose(t_em.detach().numpy(), np.asarray(j_em), rtol=1e-4, atol=1e-5)
    lengths = batch[-1]
    j_tags, _ = jpt.ops.losses.crf_decoding(j_em, jnp.asarray(lengths), jv.params["crfw"])
    t_tags, _ = tpt.ops.losses.crf_decoding(t_em.detach(), torch.from_numpy(lengths),
                                            tv.params["crfw"])
    np.testing.assert_array_equal(t_tags.numpy(), np.asarray(j_tags))
