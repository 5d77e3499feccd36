"""Stacked LSTM sentiment model (stacked_dynamic_lstm) — port of
``paddle_tpu/models/stacked_lstm.py``.

Reference: ``benchmark/fluid/models/stacked_dynamic_lstm.py`` — IMDB
sentiment: embedding(512) → stacked fc+LSTM layers → [max,last] pooling →
fc(2) softmax, Adam(lr=0.002). Variable-length LoD input becomes padded
[B, T] + lengths; the masked loop of ``ops/rnn.py::dynamic_lstm`` replaces
the dynamic_lstm C++ sequence kernel (``operators/lstm_op.cc``), and the
pooling masks pad positions.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from paddle_tpu_torch import framework, layers, optimizer
from paddle_tpu_torch.core.config import resolve_device
from paddle_tpu_torch.models import ModelSpec


def stacked_lstm_net(word_ids, lengths, labels, *, vocab_size, emb_dim, hidden_dim, stacked_num,
                     class_dim):
    dev = framework.current_device()
    word_ids, lengths, labels = (torch.as_tensor(a, device=dev) for a in (word_ids, lengths, labels))
    emb = layers.embedding(word_ids, size=[vocab_size, emb_dim])
    x = layers.fc(emb, size=hidden_dim, num_flatten_dims=2, act="tanh", name="fc0")
    for i in range(stacked_num):
        # fluid structure: fc to 4H is the LSTM input projection (dynamic_lstm
        # itself carries only recurrent weights, proj_input=False)
        proj = layers.fc(x, size=hidden_dim * 4, num_flatten_dims=2, name=f"fc_{i}")
        x, _ = layers.dynamic_lstm(
            proj, size=hidden_dim, lengths=lengths, proj_input=False, name=f"lstm_{i}"
        )
    max_pool = layers.sequence_pool(x, lengths, pool_type="max")
    last = layers.sequence_last_step(x, lengths)
    feat = torch.cat([max_pool, last], dim=-1)
    logits = layers.fc(feat, size=class_dim)
    loss = layers.softmax_with_cross_entropy(logits, labels)
    avg_loss = layers.reduce_mean(loss)
    acc = layers.accuracy(logits, labels)
    return avg_loss, acc, logits


def get_model(
    vocab_size: int = 5147,
    emb_dim: int = 512,
    hidden_dim: int = 512,
    stacked_num: int = 3,
    class_dim: int = 2,
    seq_len: int = 80,
    learning_rate: float = 0.002,
    device="cuda",
    **_unused,
) -> ModelSpec:
    """``device`` (default CUDA; raises if CUDA is absent unless
    ``device="cpu"``) is where ``synth_batch`` puts its tensors:
    ``(word_ids [B, T], lengths [B] in [T/2, T], labels [B])``."""
    dev = resolve_device(device)
    model = framework.build(
        functools.partial(
            stacked_lstm_net, vocab_size=vocab_size, emb_dim=emb_dim, hidden_dim=hidden_dim,
            stacked_num=stacked_num, class_dim=class_dim,
        ),
        name="stacked_dynamic_lstm",
    )

    def synth_batch(batch_size: int, rng: np.random.RandomState):
        ids = rng.randint(0, vocab_size, size=(batch_size, seq_len)).astype(np.int32)
        lens = rng.randint(seq_len // 2, seq_len + 1, size=(batch_size,)).astype(np.int32)
        labels = rng.randint(0, class_dim, size=(batch_size,)).astype(np.int32)
        return tuple(torch.as_tensor(a, device=dev) for a in (ids, lens, labels))

    return ModelSpec(
        name="stacked_dynamic_lstm",
        model=model,
        synth_batch=synth_batch,
        optimizer=lambda: optimizer.Adam(learning_rate=learning_rate),
        unit="words/sec",
        examples_per_row=seq_len,
        extra={"device": dev},
    )
