"""Structured-prediction losses: linear-chain CRF and CTC — port of
``paddle_tpu/ops/losses.py``.

Reference: ``paddle/fluid/operators/linear_chain_crf_op.cc`` /
``crf_decoding_op.cc`` (forward-algorithm log-likelihood + Viterbi decode
over LoD sequences; the transition matrix carries start/stop weights in its
first two rows, ``linear_chain_crf_op.cc`` op doc) and the warpctc
integration (``operators/warpctc_op.cc``) plus ``ctc_align_op.cc`` (greedy
path collapse) and ``edit_distance_op.cc``.

Both are log-space dynamic programs over the time axis. The JAX package
writes them as ``lax.scan``; here each is a Python loop of a few launches
per time step over the whole batch [B], and gradients come from autograd
through the loop (no hand-written backward, as in the JAX package).
Variable length is handled by masking the updates past each row's length.
The recursions use the finite ``NEG_INF`` (-1e9, ``core/dtypes.py``), not
-inf: ``logaddexp(-inf, -inf)`` has NaN gradients. Viterbi backpointers and
the greedy CTC path take the first maximum (``torch.argmax``, as
``jnp.argmax``). Decoded tags, tokens and lengths are int32, as the JAX
package writes them.
"""

from __future__ import annotations

from typing import Tuple

import torch

from paddle_tpu_torch.core.dtypes import NEG_INF
from paddle_tpu_torch.ops.sequence import length_mask

__all__ = [
    "linear_chain_crf",
    "crf_decoding",
    "ctc_loss",
    "ctc_greedy_decode",
    "edit_distance",
]


# ---------------------------------------------------------------------------
# Linear-chain CRF
# ---------------------------------------------------------------------------


def _crf_scores(emissions, labels, lengths, start, end, trans):
    """Unnormalized score of the gold path, batched."""
    B, T, K = emissions.shape
    labels = labels.long()
    lengths = lengths.to(emissions.device)
    mask = length_mask(lengths, T, emissions.dtype)  # [B, T]
    # emission score of the labeled tag per step
    emit = torch.gather(emissions, -1, labels[..., None])[..., 0]
    score = torch.sum(emit * mask, dim=1)
    # transition scores between consecutive live steps
    tr = trans[labels[:, :-1], labels[:, 1:]]  # [B, T-1]
    score = score + torch.sum(tr * mask[:, 1:], dim=1)
    # start weight on tag_0, end weight on the last live tag (index -1, as
    # JAX's take_along_axis wraps it, for an empty row)
    score = score + start[labels[:, 0]]
    last = torch.gather(labels, 1, ((lengths.long() - 1) % T)[:, None])[:, 0]
    return score + end[last]


def linear_chain_crf(
    emissions: torch.Tensor,
    labels: torch.Tensor,
    lengths: torch.Tensor,
    transition: torch.Tensor,
) -> torch.Tensor:
    """Negative log-likelihood of a linear-chain CRF, per sequence.

    ``emissions``: [B, T, K] unaries; ``labels``: [B, T] int gold tags;
    ``lengths``: [B]; ``transition``: [K+2, K] in the reference's layout —
    row 0 = start weights, row 1 = end weights, rows 2.. = the KxK transition
    matrix (``linear_chain_crf_op.cc`` op documentation).

    Returns [B] NLL (minimize the mean of this). The forward algorithm runs
    T - 1 steps of one [B, K, K] logsumexp each.
    """
    B, T, K = emissions.shape
    start, end, trans = transition[0], transition[1], transition[2:]
    emissions = emissions.float()
    lengths = lengths.to(emissions.device)

    gold = _crf_scores(emissions, labels, lengths, start, end, trans)

    # forward algorithm: alpha[b, k] = logsumexp over paths ending in tag k
    alpha = start[None, :] + emissions[:, 0, :]  # [B, K]
    for t in range(1, T):
        scores = alpha[:, :, None] + trans[None, :, :] + emissions[:, t, None, :]
        new_alpha = torch.logsumexp(scores, dim=1)
        alpha = torch.where((t < lengths)[:, None], new_alpha, alpha)
    log_z = torch.logsumexp(alpha + end[None, :], dim=1)
    return log_z - gold


def crf_decoding(
    emissions: torch.Tensor,
    lengths: torch.Tensor,
    transition: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Viterbi decode (reference ``crf_decoding_op.cc``): returns
    ``(tags [B, T] int32, best_score [B])``; entries past a row's length
    are 0. Backpointers take the first maximum; a row past its length keeps
    identity backpointers, so the backtrace passes through."""
    B, T, K = emissions.shape
    start, end, trans = transition[0], transition[1], transition[2:]
    emissions = emissions.float()
    lengths = lengths.to(emissions.device)
    identity = torch.arange(K, device=emissions.device)[None, :]

    v = start[None, :] + emissions[:, 0, :]
    back = []
    for t in range(1, T):
        scores = v[:, :, None] + trans[None, :, :]  # [B, K_prev, K_next]
        best_prev = torch.argmax(scores, dim=1)  # [B, K]
        new_v = torch.amax(scores, dim=1) + emissions[:, t, :]
        live = (t < lengths)[:, None]
        v = torch.where(live, new_v, v)
        back.append(torch.where(live, best_prev, identity))

    final = v + end[None, :]
    best_score = torch.amax(final, dim=1)
    tag = torch.argmax(final, dim=1)  # [B]
    tags = [tag]
    for ptr in reversed(back):
        tag = torch.gather(ptr, 1, tag[:, None])[:, 0]
        tags.append(tag)
    tags = torch.stack(tags[::-1], dim=1)  # [B, T]
    t_idx = torch.arange(T, device=emissions.device)
    tags = torch.where(t_idx[None, :] < lengths[:, None], tags, 0)
    return tags.to(torch.int32), best_score


# ---------------------------------------------------------------------------
# CTC
# ---------------------------------------------------------------------------


def ctc_loss(
    log_probs: torch.Tensor,
    labels: torch.Tensor,
    input_lengths: torch.Tensor,
    label_lengths: torch.Tensor,
    blank: int = 0,
) -> torch.Tensor:
    """CTC negative log-likelihood per sequence (warpctc parity,
    ``operators/warpctc_op.cc``; the alpha recursion of Graves et al. in log
    space).

    ``log_probs``: [B, T, V] log-softmax outputs; ``labels``: [B, L] (no
    blanks); lengths as [B] int tensors. Returns [B] NLL. T - 1 steps over
    the extended label sequence [B, 2L + 1].
    """
    B, T, V = log_probs.shape
    L = labels.shape[1]
    S = 2 * L + 1
    log_probs = log_probs.float()
    dev = log_probs.device
    input_lengths = input_lengths.to(dev)
    label_lengths = label_lengths.to(dev)

    # extended label sequence: blank z1 blank z2 ... blank
    ext = torch.full((B, S), blank, dtype=torch.long, device=dev)
    ext[:, 1::2] = labels.long()
    ext_len = 2 * label_lengths.long() + 1

    # allow-skip mask: alpha[s] may come from s-2 when ext[s] != blank and
    # ext[s] != ext[s-2]
    ext_prev2 = torch.nn.functional.pad(ext[:, :-2], (2, 0), value=-1)[:, :S]
    can_skip = (ext != blank) & (ext != ext_prev2)  # [B, S]

    alpha = torch.full((B, S), NEG_INF, device=dev)
    alpha[:, 0] = log_probs[:, 0, blank]
    if S > 1:
        e0 = torch.gather(log_probs[:, 0], 1, ext[:, 1:2])[:, 0]
        alpha[:, 1] = torch.where(label_lengths > 0, e0, NEG_INF)
    neg = torch.full((B, 1), NEG_INF, device=dev)

    for t in range(1, T):
        a_prev1 = torch.cat([neg, alpha[:, :-1]], dim=1)
        a_prev2 = torch.cat([neg, neg, alpha[:, :-2]], dim=1)[:, :S]
        a_prev2 = torch.where(can_skip, a_prev2, NEG_INF)
        merged = torch.logaddexp(torch.logaddexp(alpha, a_prev1), a_prev2)
        new_alpha = merged + torch.gather(log_probs[:, t], 1, ext)
        alpha = torch.where((t < input_lengths)[:, None], new_alpha, alpha)

    # total = logaddexp(alpha[ext_len-1], alpha[ext_len-2])
    a_last = torch.gather(alpha, 1, (ext_len - 1)[:, None])[:, 0]
    a_prev = torch.gather(alpha, 1, torch.clamp_min(ext_len - 2, 0)[:, None])[:, 0]  # an index
    # empty label (ext_len==1): only the all-blank cell counts
    a_prev = torch.where(ext_len >= 2, a_prev, NEG_INF)
    return -torch.logaddexp(a_last, a_prev)


def ctc_greedy_decode(
    log_probs: torch.Tensor,
    input_lengths: torch.Tensor,
    blank: int = 0,
    pad_value: int = -1,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Best-path decode + collapse (reference ``ctc_align_op.cc``): argmax
    per step (the first maximum), merge repeats, drop blanks. Returns
    ``(tokens [B, T] int32 padded with pad_value, out_lengths [B] int32)``."""
    B, T, V = log_probs.shape
    path = torch.argmax(log_probs, dim=-1)  # [B, T]
    live = length_mask(input_lengths.to(path.device), T)
    prev = torch.nn.functional.pad(path[:, :-1], (1, 0), value=-1)
    keep = live & (path != blank) & (path != prev)
    # stable compaction: position of each kept token in the output row
    pos = torch.cumsum(keep.long(), dim=1) - 1
    scatter_pos = torch.where(keep, pos, T)  # dropped tokens land off the row
    out = torch.full((B, T + 1), pad_value, dtype=torch.long, device=path.device)
    out = out.scatter(1, scatter_pos, torch.where(keep, path, pad_value))[:, :T]
    return out.to(torch.int32), keep.sum(dim=1).to(torch.int32)


def edit_distance(
    hyp: torch.Tensor,
    hyp_lengths: torch.Tensor,
    ref: torch.Tensor,
    ref_lengths: torch.Tensor,
    normalized: bool = False,
) -> torch.Tensor:
    """Levenshtein distance per pair (reference ``edit_distance_op.cc``), a
    DP with one step per hyp token; the left-neighbour dependency within a
    row is resolved in parallel by the cummin identity
    ``new_row[j] = min_{k<=j}(d[k] - k) + j`` where ``d`` holds the
    diagonal/up candidates. ``hyp``: [B, N], ``ref``: [B, M]; returns [B]
    f32 (divided by the reference length when ``normalized``)."""
    B, N = hyp.shape
    M = ref.shape[1]
    dev = hyp.device
    hyp_lengths, ref_lengths = hyp_lengths.to(dev), ref_lengths.to(dev)
    m_idx = torch.arange(M + 1, dtype=torch.float32, device=dev)
    row = m_idx[None, :].repeat(B, 1)  # [B, M+1]
    for i in range(N):
        sub_cost = (ref != hyp[:, i:i + 1]).float()  # [B, M]
        d = torch.minimum(row[:, :-1] + sub_cost, row[:, 1:] + 1.0)  # j = 1..M
        d_full = torch.cat([torch.full((B, 1), float(i + 1), device=dev), d], dim=1)
        new_row = torch.cummin(d_full - m_idx[None, :], dim=1).values + m_idx[None, :]
        row = torch.where((i < hyp_lengths)[:, None], new_row, row)
    dist = torch.gather(row, 1, ref_lengths.long()[:, None])[:, 0]
    if normalized:
        dist = dist / torch.clamp_min(ref_lengths.float(), 1.0)  # integer lengths
    return dist
