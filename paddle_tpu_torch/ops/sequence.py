"""Variable-length sequence ops over a padded batch and its lengths — port of
``paddle_tpu/ops/sequence.py``.

Reference: the LoDTensor sequence-op family (``sequence_pool_op.cc``,
``sequence_softmax_op.cc``, ``sequence_expand_op.cc``, ...). A batch is a
padded dense tensor [B, T, ...] plus an int ``lengths`` [B] vector; masks
are ``arange(T) < lengths[:, None]``. Every op computes over the padded
buffer and masks, with the JAX package's semantics.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from paddle_tpu_torch.core.dtypes import f32_project

__all__ = [
    "length_mask",
    "sequence_pool",
    "sequence_softmax",
    "sequence_expand",
    "sequence_reverse",
    "sequence_pad",
    "sequence_unpad_mask",
    "sequence_last_step",
    "sequence_first_step",
    "sequence_conv",
    "sequence_erase",
    "sequence_concat",
    "sequence_enumerate",
    "sequence_expand_as",
    "sequence_mask",
    "sequence_reshape",
    "sequence_scatter",
    "sequence_slice",
    "lod_reset",
    "reorder_by_rank",
]


def _gather_time(x, idx):
    """``x[b, idx[b, t], ...]`` for [B, T'] indices (``take_along_axis`` on
    axis 1, trailing feature dims carried along)."""
    idx = idx.long()
    if x.dim() == 3:
        idx = idx[..., None].expand(-1, -1, x.shape[-1])
    return torch.gather(x, 1, idx)


def length_mask(lengths: torch.Tensor, max_len: int, dtype=torch.bool) -> torch.Tensor:
    """[B, T] validity mask from lengths."""
    lengths = torch.as_tensor(lengths)
    mask = torch.arange(max_len, device=lengths.device)[None, :] < lengths[:, None]
    return mask.to(dtype)


def sequence_pool(x: torch.Tensor, lengths: torch.Tensor, pool_type: str = "sum") -> torch.Tensor:
    """Pool [B, T, D] over valid timesteps → [B, D].
    pool_types: sum/average/max/last/first/sqrt (reference sequence_pool)."""
    t = x.shape[1]
    mask = length_mask(lengths, t)[..., None]  # [B, T, 1]
    xf = x.float()
    n = lengths[:, None].float().clamp_min(1.0)  # integer lengths: not differentiated
    if pool_type == "sum":
        out = torch.where(mask, xf, 0.0).sum(1)
    elif pool_type in ("average", "avg", "mean"):
        out = torch.where(mask, xf, 0.0).sum(1) / n
    elif pool_type == "sqrt":
        out = torch.where(mask, xf, 0.0).sum(1) / torch.sqrt(n)
    elif pool_type == "max":
        out = torch.where(mask, xf, -torch.inf).amax(1)
        out = torch.where(lengths[:, None] > 0, out, 0.0)
    elif pool_type == "last":
        idx = (lengths - 1).clamp_min(0)  # an integer index
        out = _gather_time(xf, idx[:, None])[:, 0]
        out = torch.where(lengths[:, None] > 0, out, 0.0)
    elif pool_type == "first":
        out = torch.where(lengths[:, None] > 0, xf[:, 0], 0.0)
    else:
        raise ValueError(f"unknown pool_type {pool_type!r}")
    return out.to(x.dtype)


def sequence_first_step(x, lengths):
    return sequence_pool(x, lengths, "first")


def sequence_last_step(x, lengths):
    return sequence_pool(x, lengths, "last")


def _mask_like(lengths, x):
    """The [B, T] length mask with trailing unit dims up to x's rank."""
    mask = length_mask(lengths, x.shape[1])
    return mask.reshape(mask.shape + (1,) * (x.dim() - 2))


def sequence_softmax(x: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Softmax within each row's valid prefix, zeros on padding."""
    mask = _mask_like(lengths, x)
    out = torch.softmax(torch.where(mask, x.float(), -torch.inf), dim=1)
    return torch.where(mask, out, 0.0).to(x.dtype)


def sequence_expand(x: torch.Tensor, lengths: torch.Tensor, t: int) -> torch.Tensor:
    """Broadcast per-sequence vectors [B, D] along time → [B, T, D] masked by
    lengths (the padded-batch analogue of reference sequence_expand)."""
    out = x[:, None, :].expand(x.shape[0], t, x.shape[-1])
    mask = length_mask(lengths, t)[..., None]
    return torch.where(mask, out, 0.0).to(x.dtype)


def sequence_reverse(x: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Reverse each row's valid prefix in place, keep padding at the tail
    (reference ``sequence_reverse_op.cc``)."""
    t = x.shape[1]
    pos = torch.arange(t, device=x.device)[None, :]
    n = lengths[:, None].to(x.device)
    src = torch.where(pos < n, n - 1 - pos, pos)
    return _gather_time(x, src)


def sequence_pad(rows: list, max_len: int, pad_value=0.0):
    """Host-side helper: list of [Ti, D] numpy arrays → (padded [B,T,D], lengths)."""
    import numpy as np

    b = len(rows)
    d = rows[0].shape[-1] if rows[0].ndim > 1 else 1
    out = np.full((b, max_len, d), pad_value, dtype=np.asarray(rows[0]).dtype)
    lengths = np.zeros((b,), np.int32)
    for i, r in enumerate(rows):
        r = np.asarray(r).reshape(-1, d)
        n = min(len(r), max_len)
        out[i, :n] = r[:n]
        lengths[i] = n
    return out, lengths


def sequence_unpad_mask(x: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Zero out padding (the in-graph stand-in for unpad; true unpad is a
    host-side op since it produces ragged shapes)."""
    return torch.where(_mask_like(lengths, x), x, 0.0).to(x.dtype)


def sequence_conv(x: torch.Tensor, lengths: torch.Tensor, weight: torch.Tensor,
                  context_length: int, context_start: Optional[int] = None) -> torch.Tensor:
    """Sequence convolution (reference ``sequence_conv_op.cc``): a sliding
    window of ``context_length`` steps (centered unless context_start given)
    projected by ``weight`` [context_length * D, H]: shifted copies of the
    masked input, concatenated, then one product with an f32 result."""
    b, t, d = x.shape
    start = context_start if context_start is not None else -(context_length // 2)
    xm = sequence_unpad_mask(x, lengths)
    cols = []
    for off in range(start, start + context_length):
        if off < 0:
            shifted = torch.nn.functional.pad(xm[:, : t + off], (0, 0, -off, 0))
        elif off > 0:
            shifted = torch.nn.functional.pad(xm[:, off:], (0, 0, 0, off))
        else:
            shifted = xm
        cols.append(shifted)
    stacked = torch.cat(cols, dim=-1)  # [B, T, ctx*D]
    out = f32_project(stacked, weight).to(x.dtype)
    return sequence_unpad_mask(out, lengths)


def sequence_erase(x: torch.Tensor, lengths: torch.Tensor,
                   tokens: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Remove listed token ids from each row, compacting left (reference
    ``sequence_erase_op.cc``). Works on int id matrices [B, T]. Returns
    (new_ids, new_lengths); vacated tail positions are 0."""
    t = x.shape[1]
    valid = length_mask(lengths, t)
    keep = valid & ~torch.isin(x, torch.as_tensor(tokens, device=x.device))
    pos = torch.arange(t, device=x.device)[None, :]
    # stable compaction: sort positions by (not keep, position)
    order = torch.argsort(torch.where(keep, pos, t + pos), dim=1, stable=True)
    compacted = torch.gather(torch.where(keep, x, 0), 1, order)
    new_len = keep.sum(1).to(torch.int32)
    compacted = torch.where(length_mask(new_len, t), compacted, 0)
    return compacted, new_len


def sequence_concat(x: torch.Tensor, x_lens: torch.Tensor, y: torch.Tensor,
                    y_lens: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Row-wise sequence concatenation (reference ``sequence_concat_op.cc``):
    output row b is x[b,:x_lens[b]] followed by y[b,:y_lens[b]], padded to
    Tx+Ty; a gather over the padded buffers."""
    tx, ty = x.shape[1], y.shape[1]
    pos = torch.arange(tx + ty, device=x.device)[None, :]
    xl = x_lens[:, None]
    from_x = pos < xl
    # integer positions (here and below): no gradient reaches a clamp of them
    gx = _gather_time(x, pos.clamp(0, tx - 1).expand(x.shape[0], -1))
    gy = _gather_time(y, (pos - xl).clamp(0, ty - 1))
    sel = from_x if x.dim() == 2 else from_x[..., None]
    out = torch.where(sel, gx, gy)
    new_lens = x_lens + y_lens
    valid = pos < new_lens[:, None]
    if x.dim() == 3:
        valid = valid[..., None]
    return torch.where(valid, out, 0).to(x.dtype), new_lens


def sequence_enumerate(ids: torch.Tensor, lengths: torch.Tensor, win_size: int,
                       pad_value: int = 0) -> torch.Tensor:
    """All length-``win_size`` windows starting at each position (reference
    ``sequence_enumerate_op.cc``): [B, T] int ids → [B, T, win]; positions
    past a row's length are pad_value."""
    t = ids.shape[1]
    pos = (torch.arange(t, device=ids.device)[:, None]
           + torch.arange(win_size, device=ids.device)[None, :])  # [T, win]
    gathered = ids[:, pos.clamp(0, t - 1)]  # [B, T, win]; integer positions
    valid = pos[None, :, :] < lengths[:, None, None]
    return torch.where(valid, gathered, pad_value).to(ids.dtype)


def sequence_expand_as(x: torch.Tensor, y_lens: torch.Tensor, t: int) -> torch.Tensor:
    """Expand per-sequence vectors [B, D] to y's padded layout [B, T, D]
    (reference ``sequence_expand_as_op.cc``)."""
    return sequence_expand(x, y_lens, t)


def sequence_mask(lengths: torch.Tensor, maxlen: int, dtype=torch.float32) -> torch.Tensor:
    """fluid ``layers.sequence_mask`` (reference sequence_mask op): [B] int
    lengths → [B, maxlen] 0/1 mask."""
    return length_mask(lengths, maxlen, dtype)


def sequence_reshape(x: torch.Tensor, lengths: torch.Tensor,
                     new_dim: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Re-chunk each row's flattened valid data into ``new_dim``-wide
    timesteps (reference ``sequence_reshape_op.cc``): [B, T, D] →
    [B, T*D/new_dim, new_dim], lengths scaled by D/new_dim. Rows whose
    ``lengths[b]*D`` is not divisible by new_dim are a caller error."""
    b, t, d = x.shape
    total = t * d
    if total % new_dim != 0:
        raise ValueError(f"T*D={total} not divisible by new_dim={new_dim}")
    return x.reshape(b, total // new_dim, new_dim), (lengths * d) // new_dim


def sequence_scatter(x: torch.Tensor, ids: torch.Tensor, id_lens: torch.Tensor,
                     updates: torch.Tensor) -> torch.Tensor:
    """Per-row scatter-add (reference ``sequence_scatter_op.cc``): for row b
    and valid j, x[b, ids[b, j]] += updates[b, j] — the JAX package's dense
    one-hot formulation, summed in f32."""
    from paddle_tpu_torch.ops.nn import one_hot

    m, s = x.shape[1], ids.shape[1]
    valid = length_mask(id_lens, s, torch.float32)  # [B, S]
    onehot = one_hot(ids, m)  # [B, S, M]
    upd = (updates.float() * valid)[:, :, None]  # [B, S, 1]
    return (x.float() + (onehot * upd).sum(1)).to(x.dtype)


def sequence_slice(x: torch.Tensor, lengths: torch.Tensor, offset: torch.Tensor,
                   length: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row subsequence x[b, offset[b]:offset[b]+length[b]] (reference
    ``sequence_slice_op.cc``), left-aligned into the padded output."""
    t = x.shape[1]
    pos = torch.arange(t, device=x.device)[None, :]
    out = _gather_time(x, (offset[:, None] + pos).clamp(0, t - 1))  # integer positions
    valid = pos < length[:, None]
    if x.dim() == 3:
        valid = valid[..., None]
    return torch.where(valid, out, 0).to(x.dtype), length.to(torch.int32)


def lod_reset(x: torch.Tensor, new_lengths: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Replace a padded batch's sequence metadata (reference
    ``lod_reset_op.cc``): data unchanged, lengths swapped."""
    return x, new_lengths.to(torch.int32)


def reorder_by_rank(x: torch.Tensor, rank: torch.Tensor) -> torch.Tensor:
    """Gather rows into rank order (reference
    ``reorder_lod_tensor_by_rank_op.cc``; the rank table is an argsort of
    lengths)."""
    return torch.index_select(x, 0, rank.long())
