"""Attention ops.

Port of ``paddle_tpu/ops/attention.py``: one composed attention function,
and the hand-written flash kernel (``ops/cuda/flash_attention.py``) takes
over under ``flags().use_flash_attention`` on exactly the JAX package's
routing conditions. Head dims lead ([..., T, D]).
"""

from __future__ import annotations

import math
from typing import Optional

import torch

__all__ = [
    "scaled_dot_product_attention", "split_heads", "combine_heads",
    "causal_mask", "rope_tables", "apply_rope",
]


def rope_tables(dim: int, t: int, base: float = 10000.0, pos0: int = 0, device=None):
    """Rotary position embedding cos/sin tables: [t, dim//2] each, f32,
    indexing GLOBAL positions from ``pos0``."""
    half = dim // 2
    freqs = base ** (-torch.arange(half, dtype=torch.float32, device=device) / half)
    angles = (pos0 + torch.arange(t, dtype=torch.float32, device=device))[:, None] * freqs[None, :]
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate feature pairs of [..., T, d] by position angle (half-split
    pairing): out = (x1*cos - x2*sin, x1*sin + x2*cos)."""
    half = x.shape[-1] // 2
    xf1, xf2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([xf1 * cos - xf2 * sin, xf1 * sin + xf2 * cos], dim=-1).to(x.dtype)


def causal_mask(t_q: int, t_k: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """[Tq, Tk] additive mask, -inf above the diagonal (bottom-right aligned
    when Tq != Tk)."""
    i = torch.arange(t_q, device=device)[:, None]
    j = torch.arange(t_k, device=device)[None, :]
    return torch.where(j <= i + (t_k - t_q), 0.0, -math.inf).to(dtype)


def split_heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    """[B, T, H*D] → [B, num_heads, T, D]."""
    b, t, hd = x.shape
    return x.reshape(b, t, num_heads, hd // num_heads).permute(0, 2, 1, 3)


def combine_heads(x: torch.Tensor) -> torch.Tensor:
    """[B, N, T, D] → [B, T, N*D]."""
    b, n, t, d = x.shape
    return x.permute(0, 2, 1, 3).reshape(b, t, n * d)


def _flash_block(t: int):
    """Largest tile-friendly block size dividing t (None = no fit): the JAX
    package's routing condition, kept so both packages route alike."""
    for b in (128, 64, 32, 16, 8):
        if t % b == 0:
            return b
    return None


def scaled_dot_product_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    dropout_rate: float = 0.0,
    is_test: bool = True,
    scale: Optional[float] = None,
    causal: bool = False,
    kv_len: Optional[torch.Tensor] = None,
    window: Optional[int] = None,
    dropout_generator: Optional[torch.Generator] = None,
    dropout_block=None,
) -> torch.Tensor:
    """Attention over [..., T, D] tensors. ``mask`` is additive, broadcastable
    to [..., Tq, Tk] (0 keep, -inf drop); ``causal=True`` masks structurally
    (bottom-right aligned on the composed path); ``kv_len`` ([B] int) masks
    key positions >= kv_len[b]; ``window`` (causal only) keeps the last
    ``window`` keys.

    Softmax in f32; Q K^T and P V with operands in the compute dtype and f32
    accumulation (:func:`~paddle_tpu_torch.core.dtypes.f32_bmm`: on the card
    bf16 operands on the tensor cores, f32 operands in full f32). With
    ``dropout_rate`` > 0 and not ``is_test``, dropout (``ops.nn.dropout``)
    masks the softmax weights before the P V product, drawing from
    ``dropout_generator`` (the JAX package's ``dropout_key``), by default
    the frame's generator (``framework.next_rng``); ``dropout_block`` says
    which block of the heads ``q`` holds under tensor parallelism (the
    mask's ``block``, ``ops.nn.dropout``). With
    ``flags().use_flash_attention``, the mask-free 4-D case without dropout
    routes through the flash kernel when the block tiling divides the
    sequence lengths — the JAX package's conditions, verbatim.
    """
    from paddle_tpu_torch.core import config as _cfg
    from paddle_tpu_torch.core.dtypes import NEG_INF, f32_bmm, mxu_operands
    from paddle_tpu_torch.core.enforce import enforce

    d = q.shape[-1]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)

    if window is not None and not causal:
        enforce(False, "window requires causal=True (sliding-window attention "
                       "is defined over the causal band)")

    if (
        _cfg.flags().use_flash_attention
        and mask is None
        and (dropout_rate == 0.0 or is_test)
        and q.dim() == 4
        and k.shape == v.shape
        and q.shape[0] == k.shape[0]
        and q.shape[1] % k.shape[1] == 0  # equal heads or GQA/MQA grouping
        # the kernel's causal mask is top-left aligned (q_pos >= k_pos);
        # causal_mask below is bottom-right aligned for Tq != Tk — only
        # route equal-length causal calls so the two paths agree
        and (not causal or q.shape[-2] == k.shape[-2])
        and (window is None or causal)
    ):
        bq = _flash_block(q.shape[-2])
        bk = _flash_block(k.shape[-2])
        if bq and bk:
            from paddle_tpu_torch.ops.cuda.flash_attention import flash_attention

            out_dtype = q.dtype
            # bf16 halves K/V traffic; the kernel reads [B, H, T, d] rows
            q, k, v = (t.contiguous() for t in mxu_operands(q, k, v))
            return flash_attention(
                q, k, v, causal=causal, sm_scale=scale,
                block_q=None if bq == 128 else bq,
                block_k=None if bk == 128 else bk,
                kv_len=kv_len, window=window,
            ).to(out_dtype)
    if kv_len is not None:
        k_pos = torch.arange(k.shape[-2], device=k.device)
        len_mask = torch.where(k_pos[None, :] < kv_len[:, None].to(k.device), 0.0, NEG_INF)
        len_mask = len_mask.reshape((kv_len.shape[0],) + (1,) * (q.dim() - 2) + (k.shape[-2],))
        mask = len_mask if mask is None else mask + len_mask
    if causal:
        mask_c = causal_mask(q.shape[-2], k.shape[-2], device=q.device)
        mask = mask_c if mask is None else mask + mask_c
    if window is not None:
        t_q, t_k = q.shape[-2], k.shape[-2]
        i = torch.arange(t_q, device=q.device)[:, None] + (t_k - t_q)  # align ends
        jpos = torch.arange(t_k, device=q.device)[None, :]
        wmask = torch.where(i - jpos < window, 0.0, -math.inf)
        mask = wmask if mask is None else mask + wmask
    out_dtype = q.dtype
    q, k, v = mxu_operands(q, k, v)
    drop = dropout_rate > 0.0 and not is_test

    def dropped(weights):
        if not drop:
            return weights
        from paddle_tpu_torch.ops.nn import dropout

        return dropout(weights, dropout_rate, is_test=False, generator=dropout_generator,
                       block=dropout_block)

    if q.dim() == 4 and k.dim() == 4 and k.shape[1] != q.shape[1]:
        # grouped-query attention: each kv head's query group is one batch
        # entry of the products, so K/V stay at H_kv heads
        b, h, t_q, d_ = q.shape
        h_kv, t_k = k.shape[1], k.shape[2]
        if h % h_kv:
            raise ValueError(f"GQA: {h} query heads not divisible by {h_kv} kv heads")
        if mask is not None and mask.dim() >= 3 and mask.shape[-3] not in (1, h_kv):
            raise ValueError("GQA: per-query-head masks are unsupported; use a "
                             "head-broadcastable mask (head dim 1)")
        g = h // h_kv
        qg = q.reshape(b * h_kv, g * t_q, d_)
        kt = k.reshape(b * h_kv, t_k, d_).transpose(1, 2)
        logits = f32_bmm(qg, kt).reshape(b, h_kv, g, t_q, t_k) * scale
        if mask is not None:
            m = mask.float()
            if m.dim() >= 3:  # insert the group dim after the (1|h_kv) head dim
                m = m.unsqueeze(-3)
            logits = logits + m
        weights = dropped(torch.softmax(logits, dim=-1))
        out = f32_bmm(weights.to(v.dtype).reshape(b * h_kv, g * t_q, t_k),
                      v.reshape(b * h_kv, t_k, v.shape[-1]))
        return out.reshape(b, h, t_q, v.shape[-1]).to(out_dtype)

    def batched(x, lead):  # [..., R, C] broadcast to `lead` -> [N, R, C]
        return x.expand(*lead, *x.shape[-2:]).reshape(-1, *x.shape[-2:])

    t_q, t_k = q.shape[-2], k.shape[-2]
    lead = torch.broadcast_shapes(q.shape[:-2], k.shape[:-2])
    logits = f32_bmm(batched(q, lead), batched(k, lead).transpose(1, 2))
    logits = logits.reshape(*lead, t_q, t_k) * scale
    if mask is not None:
        logits = logits + mask.float()
    weights = dropped(torch.softmax(logits, dim=-1))
    lead = torch.broadcast_shapes(weights.shape[:-2], v.shape[:-2])
    out = f32_bmm(batched(weights.to(v.dtype), lead), batched(v, lead))
    return out.reshape(*lead, t_q, v.shape[-1]).to(out_dtype)
