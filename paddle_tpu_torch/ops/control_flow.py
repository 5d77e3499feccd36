"""Control-flow ops — the beam search of ``paddle_tpu/ops/control_flow.py``
(``beam_search`` and ``beam_search_decode``); the other control-flow ops are
not ported yet.

Reference: the beam-search ops (``operators/beam_search_op.cc`` grow,
``beam_search_decode_op.cc`` backtrace) driven by a While block. The JAX
package runs the steps as one ``lax.scan``; here they are a Python loop
over :func:`beam_step`. Candidates are ranked by score, then by flat index
(beam * V + token): a stable descending sort, which is the order
``jax.lax.top_k`` gives equal scores, so the two packages pick the same
beams at f32 even through exact ties.
"""

from __future__ import annotations

import numbers
from typing import Any, Callable, NamedTuple

import torch

from paddle_tpu_torch.core import tree
from paddle_tpu_torch.core.dtypes import NEG_INF

__all__ = ["BeamState", "beam_search", "beam_search_decode", "beam_init", "beam_step",
           "beam_finish"]


class BeamState(NamedTuple):
    carry: Any  # model carry, leaves shaped [B*K, ...]
    tokens: torch.Tensor  # [B, K] last emitted token
    scores: torch.Tensor  # [B, K] cumulative log-prob
    finished: torch.Tensor  # [B, K] bool


def _gather_beams(carry, beam_indices: torch.Tensor, batch_size: int, beam_size: int):
    """Reindex [B*K, ...] leaves by per-batch beam indices [B, K]."""
    flat = (beam_indices + beam_size * torch.arange(
        batch_size, device=beam_indices.device)[:, None]).reshape(-1)
    return tree.map_leaves(lambda leaf: torch.index_select(leaf, 0, flat.to(leaf.device)), carry)


def _top_k(x: torch.Tensor, k: int):
    """The k largest entries of each row and their indices, ties broken by
    the lower index (``jax.lax.top_k``'s order)."""
    values, indices = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], indices[..., :k]


def beam_init(init_carry, *, batch_size: int, beam_size: int, bos_id, device=None) -> BeamState:
    """The search's first state: ``init_carry`` leaves ([B, ...]) tiled
    across the K beams, every beam at ``bos_id`` (a vocabulary id, or [B]
    per-row start tokens), and only beam 0 live (the others at NEG_INF, so
    K identical copies do not crowd the frontier)."""
    carry = tree.map_leaves(lambda leaf: torch.repeat_interleave(leaf, beam_size, dim=0),
                            init_carry)
    if device is None:
        device = tree.leaves(init_carry)[0].device
    if isinstance(bos_id, numbers.Integral):
        tokens = torch.full((batch_size, beam_size), int(bos_id), dtype=torch.int32, device=device)
    else:
        tokens = torch.as_tensor(bos_id, device=device).to(torch.int32)[:, None].repeat(1, beam_size)
    scores = torch.tensor([0.0] + [NEG_INF] * (beam_size - 1), device=device).repeat(batch_size, 1)
    finished = torch.zeros((batch_size, beam_size), dtype=torch.bool, device=device)
    return BeamState(carry, tokens, scores, finished)


def beam_step(step_fn: Callable, state: BeamState, *, batch_size: int, beam_size: int,
              vocab_size: int, eos_id: int):
    """One grow step: ``(new_state, tokens [B, K], src_beam [B, K], total
    [B, K*V])`` — the chosen tokens, the beam each extends, and every
    candidate's cumulative score (what the selection ranked)."""
    new_carry, log_probs = step_fn(state.carry, state.tokens.reshape(-1))
    log_probs = log_probs.float().reshape(batch_size, beam_size, vocab_size)
    # finished beams may only emit eos at zero cost
    eos_only = torch.full((vocab_size,), NEG_INF, device=log_probs.device)
    eos_only[eos_id] = 0.0
    log_probs = torch.where(state.finished[..., None], eos_only, log_probs)
    total = (state.scores[..., None] + log_probs).reshape(batch_size, beam_size * vocab_size)
    top_scores, top_idx = _top_k(total, beam_size)  # [B, K]
    src_beam = torch.div(top_idx, vocab_size, rounding_mode="floor")
    new_tokens = (top_idx % vocab_size).to(torch.int32)
    carry = _gather_beams(new_carry, src_beam, batch_size, beam_size)
    was_finished = torch.gather(state.finished, 1, src_beam)
    now_finished = was_finished | (new_tokens == eos_id)
    return BeamState(carry, new_tokens, top_scores, now_finished), new_tokens, src_beam, total


def beam_search(
    step_fn: Callable,
    init_carry,
    *,
    batch_size: int,
    beam_size: int,
    vocab_size: int,
    max_len: int,
    bos_id,
    eos_id: int,
    length_penalty_alpha: float = 0.0,
):
    """Batched beam search (reference ``operators/beam_search_op.cc`` grow +
    ``beam_search_decode_op.cc`` backtrace).

    ``step_fn(carry, tokens[B*K]) -> (new_carry, log_probs[B*K, V])`` is the
    per-step decoder. ``init_carry`` leaves are [B, ...] and are tiled across
    beams. Returns ``(sequences [B, K, max_len], scores [B, K])`` sorted
    best-first per batch row."""
    state = beam_init(init_carry, batch_size=batch_size, beam_size=beam_size, bos_id=bos_id)
    tok_hist, ptr_hist = [], []
    for _ in range(max_len):
        state, tokens, src_beam, _ = beam_step(
            step_fn, state, batch_size=batch_size, beam_size=beam_size,
            vocab_size=vocab_size, eos_id=eos_id)
        tok_hist.append(tokens)
        ptr_hist.append(src_beam)
    return beam_finish(state, tok_hist, ptr_hist, eos_id, length_penalty_alpha)


def beam_finish(state: BeamState, tok_hist, ptr_hist, eos_id: int,
                length_penalty_alpha: float = 0.0):
    """The search's result from its last state and the per-step tokens and
    source beams ([B, K] each): ``(sequences [B, K, T], scores [B, K])``,
    best first (after the optional length penalty)."""
    sequences = beam_search_decode(torch.stack(tok_hist), torch.stack(ptr_hist))  # [B, K, T]
    scores = state.scores
    if length_penalty_alpha:
        lengths = (sequences != eos_id).float().sum(-1) + 1.0
        scores = scores / ((5.0 + lengths) / 6.0) ** length_penalty_alpha
    order = torch.argsort(-scores, dim=1, stable=True)
    sequences = torch.gather(sequences, 1, order[..., None].expand_as(sequences))
    return sequences, torch.gather(scores, 1, order)


def beam_search_decode(tok_hist: torch.Tensor, ptr_hist: torch.Tensor) -> torch.Tensor:
    """Backtrace per-step beam selections into final sequences (reference
    ``beam_search_decode_op.cc``): walk the backpointers from the last
    step's beams to the start. ``tok_hist``/``ptr_hist`` are [T, B, K]
    stacks of the chosen token and source-beam index at each step. Returns
    sequences [B, K, T]."""
    t, batch_size, beam_size = tok_hist.shape
    beam_idx = torch.arange(beam_size, device=tok_hist.device)[None, :].repeat(batch_size, 1)
    rev = []
    for s in range(t - 1, -1, -1):
        rev.append(torch.gather(tok_hist[s], 1, beam_idx))
        beam_idx = torch.gather(ptr_hist[s], 1, beam_idx)
    return torch.stack(rev[::-1], dim=-1)
