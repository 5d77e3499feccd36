"""Seq2seq LSTM with attention (machine_translation config) — port of
``paddle_tpu/models/machine_translation.py``.

Reference: ``benchmark/fluid/models/machine_translation.py`` — WMT16
encoder-decoder: embedding → fc → dynamic_lstm encoder; a decoder
DynamicRNN with dot-product attention over the encoder states and an fc
softmax per step; Adam. The reference's DynamicRNN + LoD sequence walk is
a loop over padded [B, T] steps with length masks (the JAX package's
``lax.scan``); the beam-search inference model decodes with
``ops/control_flow.py::beam_search``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from paddle_tpu_torch import framework, initializer, layers, optimizer
from paddle_tpu_torch.core.config import resolve_device
from paddle_tpu_torch.core.dtypes import f32_bmm, f32_project
from paddle_tpu_torch.framework import create_parameter, name_scope
from paddle_tpu_torch.models import ModelSpec
from paddle_tpu_torch.ops import control_flow as ocf
from paddle_tpu_torch.ops import rnn as orn
from paddle_tpu_torch.ops import sequence as oseq
from paddle_tpu_torch.parallel import context as dp_context


def _on_device(*xs):
    dev = framework.current_device()
    return tuple(torch.as_tensor(x, device=dev) for x in xs)


def encoder(src_ids, src_lens, *, vocab_size, emb_dim, hidden_dim):
    with name_scope("encoder"):
        emb = layers.embedding(src_ids, size=[vocab_size, emb_dim])
        # fluid structure: the fc IS the LSTM input projection (reference
        # machine_translation.py:59-65), dynamic_lstm carries only w_hh
        proj = layers.fc(emb, size=hidden_dim * 4, num_flatten_dims=2, act=None)
        out, (h, c) = layers.dynamic_lstm(proj, size=hidden_dim, lengths=src_lens, proj_input=False)
        return out, (h, c)


def attention_step(dec_h, enc_out, enc_mask):
    """Dot-product attention: scores over encoder steps, masked softmax,
    context vector (reference simple_attention in machine_translation.py);
    both products batched over rows with f32 results."""
    scores = f32_bmm(enc_out, dec_h[:, :, None])[..., 0]  # [B, T]
    weights = torch.softmax(torch.where(enc_mask, scores, -torch.inf), dim=-1)
    return f32_bmm(weights[:, None, :], enc_out)[:, 0]  # [B, H]


def _decoder_params(vocab_size, emb_dim, hidden_dim, dtype):
    """Decoder parameter set, created once so the train and beam-decode graphs
    share names AND initializers (must be called inside name_scope('decoder'),
    right after the target embedding)."""
    d = emb_dim + hidden_dim
    w_ih = create_parameter([d, 4 * hidden_dim], dtype, name="w_ih")
    w_hh = create_parameter([hidden_dim, 4 * hidden_dim], dtype, name="w_hh")
    b = create_parameter([4 * hidden_dim], dtype, name="b",
                         default_initializer=initializer.Constant(0.0))
    w_out = create_parameter([hidden_dim, vocab_size], dtype, name="w_out")
    b_out = create_parameter([vocab_size], dtype, name="b_out",
                             default_initializer=initializer.Constant(0.0))
    return w_ih, w_hh, b, w_out, b_out


def _cell(x_t, ctx, state, w_ih, w_hh, b):
    """One decoder step: the LSTM cell on [x_t; context]."""
    inp = torch.cat([x_t, ctx], dim=-1)
    return orn.lstm_cell(f32_project(inp, w_ih).to(inp.dtype), state, w_hh, b)


def decoder_train(trg_ids, enc_out, enc_mask, init_state, *, vocab_size, emb_dim, hidden_dim):
    """Teacher-forced decoder: per step, LSTM cell on [emb; context]."""
    with name_scope("decoder"):
        emb = layers.embedding(trg_ids, size=[vocab_size, emb_dim])
        w_ih, w_hh, b, w_out, b_out = _decoder_params(vocab_size, emb_dim, hidden_dim, emb.dtype)
        state, hs = orn.LSTMState(*init_state), []
        for t in range(emb.shape[1]):
            state = _cell(emb[:, t], attention_step(state.h, enc_out, enc_mask), state,
                          w_ih, w_hh, b)
            hs.append(state.h)
        hs = torch.stack(hs, dim=1)  # [B, T, H]
        return (f32_project(hs, w_out) + b_out).float()


def infer_decoder(src_ids, src_lens, *, vocab_size, emb_dim, hidden_dim, beam_size):
    """The beam decoder's pieces: ``(step_fn, init_carry)`` for
    :func:`~paddle_tpu_torch.ops.control_flow.beam_search`. Parameter
    creation order mirrors :func:`seq_to_seq_net` exactly so the trained
    parameters resolve by name."""
    src_ids, src_lens = _on_device(src_ids, src_lens)
    enc_out, (h, c) = encoder(
        src_ids, src_lens, vocab_size=vocab_size, emb_dim=emb_dim, hidden_dim=hidden_dim)
    enc_mask = oseq.length_mask(src_lens, src_ids.shape[1])
    with name_scope("decoder"):
        with name_scope("embedding"):
            table = create_parameter([vocab_size, emb_dim], enc_out.dtype, name="w")
        w_ih, w_hh, b, w_out, b_out = _decoder_params(vocab_size, emb_dim, hidden_dim,
                                                      enc_out.dtype)

    # enc_out/enc_mask are beam-invariant: tile once and close over them so
    # the beam gather only permutes the (small) LSTM state, not [B*K, T, H]
    enc_out_k = torch.repeat_interleave(enc_out, beam_size, dim=0)
    enc_mask_k = torch.repeat_interleave(enc_mask, beam_size, dim=0)

    def step_fn(state, tokens):
        new = _cell(table[tokens.long()], attention_step(state.h, enc_out_k, enc_mask_k), state,
                    w_ih, w_hh, b)
        logits = f32_project(new.h, w_out) + b_out
        return new, torch.log_softmax(logits.float(), dim=-1)

    return step_fn, orn.LSTMState(h, c)


def seq_to_seq_infer(src_ids, src_lens, *, vocab_size, emb_dim, hidden_dim, beam_size, max_len,
                     bos_id, eos_id):
    """Beam-search decode (reference ``machine_translation.py`` decode() built
    on beam_search/beam_search_decode ops): ``(sequences [B, K, max_len],
    scores [B, K])``, best first."""
    step_fn, carry = infer_decoder(src_ids, src_lens, vocab_size=vocab_size, emb_dim=emb_dim,
                                   hidden_dim=hidden_dim, beam_size=beam_size)
    with torch.no_grad():
        return ocf.beam_search(
            step_fn, carry, batch_size=src_ids.shape[0], beam_size=beam_size,
            vocab_size=vocab_size, max_len=max_len, bos_id=bos_id, eos_id=eos_id,
        )


def seq_to_seq_net(src_ids, src_lens, trg_ids, labels, trg_lens, *, vocab_size, emb_dim,
                   hidden_dim):
    src_ids, src_lens, trg_ids, labels, trg_lens = _on_device(
        src_ids, src_lens, trg_ids, labels, trg_lens)
    enc_out, (h, c) = encoder(src_ids, src_lens, vocab_size=vocab_size, emb_dim=emb_dim,
                              hidden_dim=hidden_dim)
    enc_mask = oseq.length_mask(src_lens, src_ids.shape[1])
    logits = decoder_train(trg_ids, enc_out, enc_mask, (h, c),
                           vocab_size=vocab_size, emb_dim=emb_dim, hidden_dim=hidden_dim)
    tok_loss = layers.softmax_with_cross_entropy(logits, labels)[..., 0]
    weight = oseq.length_mask(trg_lens, trg_ids.shape[1], torch.float32)
    n_tok = torch.clamp_min(dp_context.global_sum(weight.sum()), 1.0)
    return dp_context.scale_ratio((tok_loss * weight).sum() / n_tok), n_tok, logits


def get_model(
    vocab_size: int = 10000,
    emb_dim: int = 512,
    hidden_dim: int = 512,
    seq_len: int = 50,
    learning_rate: float = 2e-4,
    device="cuda",
    **_unused,
) -> ModelSpec:
    """``device`` (default CUDA; raises if CUDA is absent unless
    ``device="cpu"``) is where ``synth_batch`` puts its tensors: ``(src,
    src_lens, trg, labels, trg_lens)``, lengths in [T/2, T].
    ``extra["make_infer_model"](beam_size=4, max_len=32, bos_id=0,
    eos_id=1)`` builds the beam-search model on the same parameters."""
    dev = resolve_device(device)
    dims = dict(vocab_size=vocab_size, emb_dim=emb_dim, hidden_dim=hidden_dim)
    model = framework.build(functools.partial(seq_to_seq_net, **dims), name="machine_translation")

    def synth_batch(batch_size: int, rng: np.random.RandomState):
        src = rng.randint(0, vocab_size, size=(batch_size, seq_len)).astype(np.int32)
        trg = rng.randint(0, vocab_size, size=(batch_size, seq_len)).astype(np.int32)
        labels = rng.randint(0, vocab_size, size=(batch_size, seq_len)).astype(np.int32)
        src_lens = rng.randint(seq_len // 2, seq_len + 1, size=(batch_size,)).astype(np.int32)
        trg_lens = rng.randint(seq_len // 2, seq_len + 1, size=(batch_size,)).astype(np.int32)
        return tuple(torch.as_tensor(a, device=dev) for a in (src, src_lens, trg, labels, trg_lens))

    def make_infer_model(beam_size: int = 4, max_len: int = 32, bos_id: int = 0, eos_id: int = 1):
        return framework.build(
            functools.partial(seq_to_seq_infer, **dims, beam_size=beam_size, max_len=max_len,
                              bos_id=bos_id, eos_id=eos_id),
            name="machine_translation_infer",
        )

    return ModelSpec(
        name="machine_translation",
        model=model,
        synth_batch=synth_batch,
        optimizer=lambda: optimizer.Adam(learning_rate=learning_rate),
        unit="words/sec",
        examples_per_row=seq_len,
        extra={"make_infer_model": make_infer_model, "device": dev, **dims},
    )
