"""Transformer building blocks — the parts of ``paddle_tpu/models/transformer.py``
(:40-176) that the decoder-only LM uses: projections, multi-head attention,
the position-wise FFN, post-LN residual blocks and the sinusoid embedding.
Parameter names and sharding annotations match the JAX package."""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from paddle_tpu_torch import framework, layers
from paddle_tpu_torch.framework import ParamAttr, name_scope
from paddle_tpu_torch.ops import attention as oattn

# canonical tensor-parallel mesh axis name (recorded in ParamAttr.sharding)
TP = "model"


def _proj(x, size, *, shard_out: bool, name: str, bias: bool = True):
    """Linear projection over the last axis of [B, T, D] with a tensor-
    parallel sharding annotation (column- or row-parallel)."""
    sharding = (None, TP) if shard_out else (TP, None)
    return layers.fc(
        x,
        size=size,
        num_flatten_dims=x.dim() - 1,
        param_attr=ParamAttr(sharding=sharding),
        bias_attr=None if bias else False,
        name=name,
    )


def multi_head_attention(
    queries,
    keys,
    values,
    d_model: int,
    num_heads: int,
    mask=None,
    dropout_rate: float = 0.0,
    name: str = "mha",
    causal: bool = False,
    core=None,
    kv_len=None,
    num_kv_heads: Optional[int] = None,
    window: Optional[int] = None,
):
    """Projected multi-head attention (q/k/v/out linear maps + fused core).
    ``core`` overrides the attention core ``(qh, kh, vh, kv_len=None) -> ctx``
    (the RoPE core). ``num_kv_heads`` < num_heads is grouped-query
    attention."""
    h_kv = num_kv_heads or num_heads
    if num_heads % h_kv:
        raise ValueError(f"num_heads {num_heads} not divisible by num_kv_heads {h_kv}")
    d_kv = d_model // num_heads * h_kv
    with name_scope(name):
        q = _proj(queries, d_model, shard_out=True, name="q")
        k = _proj(keys, d_kv, shard_out=True, name="k")
        v = _proj(values, d_kv, shard_out=True, name="v")
        qh = oattn.split_heads(q, num_heads)
        kh = oattn.split_heads(k, h_kv)
        vh = oattn.split_heads(v, h_kv)
        if core is not None:
            from paddle_tpu_torch.core.enforce import enforce

            enforce(
                mask is None and (dropout_rate == 0.0 or not framework.is_training()),
                "multi_head_attention: a custom attention core supports neither "
                "an additive mask nor attention dropout",
            )
            ctx = core(qh, kh, vh, kv_len=kv_len)
        else:
            ctx = oattn.scaled_dot_product_attention(
                qh, kh, vh, mask=mask, dropout_rate=dropout_rate,
                is_test=not framework.is_training(), causal=causal,
                kv_len=kv_len, window=window,
            )
        out = oattn.combine_heads(ctx)
        return _proj(out, d_model, shard_out=False, name="out")


def positionwise_ffn(x, d_inner: int, d_model: int, dropout_rate: float,
                     name: str = "ffn", activation: str = "relu"):
    """``activation='swiglu'`` gates the up-projection with a SiLU branch."""
    with name_scope(name):
        if activation == "swiglu":
            up = _proj(x, d_inner, shard_out=True, name="fc1")
            gate = _proj(x, d_inner, shard_out=True, name="gate")
            hidden = up * F.silu(gate)
        else:
            hidden = _proj(x, d_inner, shard_out=True, name="fc1")
            hidden = layers.relu(hidden)
        if dropout_rate:
            hidden = layers.dropout(hidden, dropout_rate)
        return _proj(hidden, d_model, shard_out=False, name="fc2")


def _post_process(prev, out, dropout_rate):
    """residual add + LayerNorm (post-LN, reference-era transformer)."""
    if dropout_rate:
        out = layers.dropout(out, dropout_rate)
    return layers.layer_norm(prev + out, begin_norm_axis=prev.dim() - 1)


def sinusoid_position_encoding(max_len: int, d_model: int, dtype=torch.float32, device=None):
    """[max_len, d_model] fixed encoding (computed in float64, then cast)."""
    pos = np.arange(max_len)[:, None].astype(np.float64)
    dim = np.arange(d_model // 2)[None, :].astype(np.float64)
    angle = pos / np.power(10000.0, 2 * dim / d_model)
    enc = np.concatenate([np.sin(angle), np.cos(angle)], axis=1)
    return torch.as_tensor(enc, dtype=dtype, device=device)


@functools.lru_cache(maxsize=8)
def _position_table(max_len: int, d_model: int, dtype, device):
    """:func:`sinusoid_position_encoding`, built once per shape, dtype and
    device and only read afterwards: it is a constant, and rebuilding it
    (float64 sin/cos on the host over all ``max_len`` rows) would add that
    host work to every forward, which the JAX package does once, at trace
    time."""
    return sinusoid_position_encoding(max_len, d_model, dtype, device)


def prepare_embedding(ids, vocab_size, d_model, max_len, dropout_rate, name,
                      pos_offset: int = 0, add_position_encoding: bool = True):
    """token embedding * sqrt(d) (+ fixed sinusoid position encoding unless
    ``add_position_encoding=False``). ``pos_offset`` shifts positions."""
    with name_scope(name):
        emb = layers.embedding(
            ids,
            size=[vocab_size, d_model],
            param_attr=ParamAttr(name="word_emb", sharding=(None, TP)),
        )
        emb = emb * (d_model ** 0.5)
        if add_position_encoding:
            t = ids.shape[-1]
            pe = _position_table(max_len, d_model, emb.dtype, emb.device)
            emb = emb + pe[pos_offset:pos_offset + t]
        if dropout_rate:
            emb = layers.dropout(emb, dropout_rate)
        return emb
