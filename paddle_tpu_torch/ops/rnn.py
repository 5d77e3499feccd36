"""Recurrent ops: LSTM/GRU cells and masked time loops — port of
``paddle_tpu/ops/rnn.py``.

Reference: ``operators/lstm_op.cc`` / ``gru_op.cc`` /
``operators/math/lstm_compute.cc`` (gate math) and the dynamic-RNN
machinery. The JAX package runs the recurrence as one ``lax.scan`` over a
padded [T, B, ...] tensor with a length mask; here it is a plain Python
loop over the same steps, each one [B, H] × [H, 4H] product
(:func:`~paddle_tpu_torch.core.dtypes.f32_project`: f32 operands in full
f32 on the card) and the gate math. Steps past a row's length carry the state
through unchanged, so the final state is the variable-length result. Gate
order i, f, c, o (LSTM) and u, r, c (GRU), one bias, as in the reference —
not cuDNN's layout, whose two biases and padded-step treatment differ.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from paddle_tpu_torch.core.dtypes import f32_project as _mm
from paddle_tpu_torch.ops import math as om

__all__ = [
    "LSTMState", "LSTMPState", "lstm_cell", "gru_cell", "dynamic_lstm", "dynamic_gru",
    "lstmp_cell", "dynamic_lstmp", "gru_unit", "lstm_unit",
]


class LSTMState(NamedTuple):
    h: torch.Tensor
    c: torch.Tensor


class LSTMPState(NamedTuple):
    h: torch.Tensor  # projected recurrent state [B, P]
    c: torch.Tensor  # cell state [B, H]


def lstm_cell(x_proj: torch.Tensor, state: LSTMState, w_hh: torch.Tensor,
              bias: Optional[torch.Tensor] = None, forget_bias: float = 0.0) -> LSTMState:
    """One LSTM step. ``x_proj`` = x @ W_ih (precomputed outside the loop so
    the input projection is one [T*B, 4H] product). Gate order i,f,c,o
    (reference lstm_compute gate layout)."""
    h, c = state
    gates = x_proj + _mm(h, w_hh).to(x_proj.dtype)
    if bias is not None:
        gates = gates + bias
    i, f, g, o = torch.chunk(gates, 4, dim=-1)
    i = torch.sigmoid(i)
    f = torch.sigmoid(f + forget_bias)
    g = torch.tanh(g)
    o = torch.sigmoid(o)
    new_c = f * c + i * g
    new_h = o * torch.tanh(new_c)
    return LSTMState(new_h, new_c)


def gru_cell(x_proj: torch.Tensor, h: torch.Tensor, w_hh: torch.Tensor, bias=None) -> torch.Tensor:
    """One GRU step (reference ``gru_op.cc`` gate math). x_proj: [B, 3H],
    w_hh: [H, 3H] with gate order u (update), r (reset), c (candidate).
    ``bias`` [3H] is added to the input projection (callers that pre-add it,
    like dynamic_gru, pass None)."""
    if bias is not None:
        x_proj = x_proj + bias
    hsize = h.shape[-1]
    h_proj = _mm(h, w_hh[:, : 2 * hsize]).to(h.dtype)
    xu, xr, xc = torch.chunk(x_proj, 3, dim=-1)
    hu, hr = torch.chunk(h_proj, 2, dim=-1)
    u = torch.sigmoid(xu + hu)
    r = torch.sigmoid(xr + hr)
    hc = _mm(r * h, w_hh[:, 2 * hsize:]).to(h.dtype)
    c = torch.tanh(xc + hc)
    return u * h + (1.0 - u) * c


def _step_masks(t: int, lengths, reverse: bool, device):
    """[T, B, 1] bool: whether loop step s updates row b. The loop walks the
    flipped sequence when ``reverse``: step s touches original index
    t-1-s, valid iff t-1-s < length."""
    if lengths is None:
        return None
    steps = torch.arange(t, device=device)
    idx = (t - 1 - steps) if reverse else steps
    return (idx[:, None] < lengths.to(device)[None, :])[..., None]


def _mask_outputs(outs, lengths):
    """Zero the [T, B, H] outputs at padded steps."""
    if lengths is None:
        return outs
    t = outs.shape[0]
    mask = torch.arange(t, device=outs.device)[:, None] < lengths.to(outs.device)[None, :]
    return torch.where(mask[..., None], outs, 0.0)


def dynamic_lstm(
    x: torch.Tensor,
    w_ih: Optional[torch.Tensor],
    w_hh: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    lengths: Optional[torch.Tensor] = None,
    init_state: Optional[LSTMState] = None,
    reverse: bool = False,
    time_major: bool = False,
) -> Tuple[torch.Tensor, LSTMState]:
    """Full-sequence LSTM over a padded batch [B, T, D] (or [T, B, D] when
    ``time_major``), masked: steps past a row's length carry the state
    through unchanged. Returns (outputs [B, T, H], final LSTMState).

    ``w_ih=None`` means the input is already projected to [.., 4H] by an
    upstream fc — fluid ``dynamic_lstm`` semantics (reference
    ``benchmark/fluid/models/machine_translation.py:59``)."""
    if not time_major:
        x = x.transpose(0, 1)  # [T, B, D]
    t, b, _ = x.shape
    hsize = w_hh.shape[0]
    if init_state is None:
        zeros = torch.zeros((b, hsize), dtype=x.dtype, device=x.device)
        init_state = LSTMState(zeros, zeros)
    x_proj = x if w_ih is None else _mm(x, w_ih).to(x.dtype)  # [T, B, 4H]
    if reverse:
        x_proj = torch.flip(x_proj, (0,))
    masks = _step_masks(t, lengths, reverse, x.device)
    state, outs = LSTMState(*init_state), []
    for s in range(t):
        new = lstm_cell(x_proj[s], state, w_hh, bias)
        if masks is not None:
            new = LSTMState(torch.where(masks[s], new.h, state.h),
                            torch.where(masks[s], new.c, state.c))
        state = new
        outs.append(new.h)
    outs = torch.stack(outs)
    if reverse:
        outs = torch.flip(outs, (0,))
    outs = _mask_outputs(outs, lengths)
    if not time_major:
        outs = outs.transpose(0, 1)
    return outs, state


def dynamic_gru(
    x: torch.Tensor,
    w_ih: Optional[torch.Tensor],
    w_hh: torch.Tensor,
    bias=None,
    lengths: Optional[torch.Tensor] = None,
    init_h: Optional[torch.Tensor] = None,
    reverse: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence GRU over padded [B, T, D]. ``w_ih=None`` means the input
    is already projected to [.., 3H] (fluid dynamic_gru semantics)."""
    x = x.transpose(0, 1)
    t, b, _ = x.shape
    hsize = w_hh.shape[0]
    h = init_h if init_h is not None else torch.zeros((b, hsize), dtype=x.dtype, device=x.device)
    x_proj = x if w_ih is None else _mm(x, w_ih).to(x.dtype)
    if bias is not None:
        x_proj = x_proj + bias
    if reverse:
        x_proj = torch.flip(x_proj, (0,))
    masks = _step_masks(t, lengths, reverse, x.device)
    outs = []
    for s in range(t):
        new_h = gru_cell(x_proj[s], h, w_hh)
        if masks is not None:
            new_h = torch.where(masks[s], new_h, h)
        h = new_h
        outs.append(h)
    outs = torch.stack(outs)
    if reverse:
        outs = torch.flip(outs, (0,))
    return _mask_outputs(outs, lengths).transpose(0, 1), h


def lstmp_cell(
    x_proj: torch.Tensor,
    state: LSTMPState,
    w_hh: torch.Tensor,
    w_proj: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    cell_clip: Optional[float] = None,
    proj_clip: Optional[float] = None,
    proj_act: Optional[str] = None,
) -> LSTMPState:
    """One LSTMP (LSTM-with-projection) step — reference ``lstmp_op.cc``:
    the recurrent state fed back into the gates is ``r = act(h @ W_proj)``
    ([B, P] with P < H). ``w_hh`` is [P, 4H], ``w_proj`` is [H, P]."""
    r, c = state
    gates = x_proj + _mm(r, w_hh).to(x_proj.dtype)
    if bias is not None:
        gates = gates + bias
    i, f, g, o = torch.chunk(gates, 4, dim=-1)
    new_c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    if cell_clip is not None:
        new_c = om.clip(new_c, -cell_clip, cell_clip)
    new_h = torch.sigmoid(o) * torch.tanh(new_c)
    new_r = _mm(new_h, w_proj).to(new_h.dtype)
    if proj_act == "tanh":
        new_r = torch.tanh(new_r)
    elif proj_act == "sigmoid":
        new_r = torch.sigmoid(new_r)
    if proj_clip is not None:
        new_r = om.clip(new_r, -proj_clip, proj_clip)
    return LSTMPState(new_r, new_c)


def dynamic_lstmp(
    x: torch.Tensor,
    w_ih: Optional[torch.Tensor],
    w_hh: torch.Tensor,
    w_proj: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    lengths: Optional[torch.Tensor] = None,
    init_state: Optional[LSTMPState] = None,
    cell_clip: Optional[float] = None,
    proj_clip: Optional[float] = None,
    proj_act: Optional[str] = None,
) -> Tuple[torch.Tensor, LSTMPState]:
    """Full-sequence projected LSTM over padded [B, T, D] (reference
    ``lstmp_op.cc`` / fluid ``layers.dynamic_lstmp``), masked as
    :func:`dynamic_lstm`. Returns the projected outputs [B, T, P] and the
    final state."""
    x = x.transpose(0, 1)  # [T, B, D]
    t, b, _ = x.shape
    hsize, psize = w_proj.shape
    if init_state is None:
        init_state = LSTMPState(torch.zeros((b, psize), dtype=x.dtype, device=x.device),
                                torch.zeros((b, hsize), dtype=x.dtype, device=x.device))
    x_proj = x if w_ih is None else _mm(x, w_ih).to(x.dtype)
    masks = _step_masks(t, lengths, False, x.device)
    state, outs = LSTMPState(*init_state), []
    for s in range(t):
        new = lstmp_cell(x_proj[s], state, w_hh, w_proj, bias, cell_clip, proj_clip, proj_act)
        if masks is not None:
            new = LSTMPState(torch.where(masks[s], new.h, state.h),
                             torch.where(masks[s], new.c, state.c))
        state = new
        outs.append(new.h)
    return _mask_outputs(torch.stack(outs), lengths).transpose(0, 1), state


def gru_unit(x_proj: torch.Tensor, h_prev: torch.Tensor, w_hh: torch.Tensor,
             bias=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single GRU step with the fluid ``layers.gru_unit`` return contract
    (reference ``gru_unit_op.cc``): returns (new_hidden, new_hidden).
    ``x_proj`` [B, 3H] is the pre-projected input."""
    new_h = gru_cell(x_proj, h_prev, w_hh, bias)
    return new_h, new_h


def lstm_unit(x_proj: torch.Tensor, h_prev: torch.Tensor, c_prev: torch.Tensor,
              w_hh: torch.Tensor, bias: Optional[torch.Tensor] = None,
              forget_bias: float = 0.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single LSTM step with the fluid ``layers.lstm_unit`` return contract
    (reference ``lstm_unit_op.cc``): returns (hidden, cell)."""
    st = lstm_cell(x_proj, LSTMState(h_prev, c_prev), w_hh, bias, forget_bias)
    return st.h, st.c
