"""Control-flow ops — port of ``paddle_tpu/ops/control_flow.py``.

Reference: ``paddle/fluid/operators/while_op.cc:36`` (While + StepScopes),
``operators/recurrent_op.cc``, ``operators/conditional_block_op.cc``,
``python/paddle/fluid/layers/control_flow.py`` (While/Switch/IfElse/
StaticRNN/DynamicRNN/array ops/lod_rank_table), and the beam-search ops
(``operators/beam_search_op.cc`` grow, ``beam_search_decode_op.cc``
backtrace).

The JAX package lowers these onto ``lax.while_loop``/``cond``/``switch``/
``scan``; PyTorch runs eagerly, so here they are Python control flow over
tensors, and gradients come from autograd through the loop:
- :func:`while_loop` tests its predicate on the host every iteration: on a
  CUDA tensor that is one device-to-host sync per iteration (the eager
  semantics; nothing hides it).
- :func:`cond`, :func:`switch_case` and :func:`case` run only the taken
  branch (JAX traces both and runs one); a tensor predicate or index is read
  on the host (one sync). :func:`switch_case` clamps its index into range,
  as ``lax.switch`` does.
- :func:`static_rnn`, :func:`dynamic_rnn`, :func:`greedy_search` and the
  beam search are Python loops of a few launches per time step.
- :class:`TensorArray` is a fixed-capacity tensor written out of place
  (indices clamped into range, as ``lax.dynamic_update_index_in_dim``).

Beam candidates are ranked by score, then by flat index (beam * V + token):
a stable descending sort, which is the order ``jax.lax.top_k`` gives equal
scores, so the two packages pick the same beams at f32 even through exact
ties; :func:`greedy_search` takes the first maximum, as ``jnp.argmax``.
"""

from __future__ import annotations

import numbers
from typing import Any, Callable, NamedTuple, Sequence, Tuple

import torch

from paddle_tpu_torch.core import tree
from paddle_tpu_torch.core.dtypes import INDEX_DTYPE, NEG_INF
from paddle_tpu_torch.core.enforce import enforce

__all__ = [
    "while_loop", "cond", "switch_case", "case", "TensorArray", "create_array", "array_write",
    "array_read", "array_length", "static_rnn", "dynamic_rnn", "rank_by_length", "beam_search",
    "beam_search_decode", "greedy_search", "BeamState",
]  # the JAX package's; beam_init/beam_step/beam_finish are the port's own steps of beam_search

# ---------------------------------------------------------------------------
# Structured control flow (While / IfElse / Switch)
# ---------------------------------------------------------------------------


def while_loop(cond: Callable, body: Callable, loop_vars):
    """``fluid.layers.While`` parity (reference ``while_op.cc:36``): run
    ``body(loop_vars) -> loop_vars`` while ``cond(loop_vars)`` is true.
    ``loop_vars`` is any tree; ``cond`` returns a bool or a one-element
    tensor, read on the host each iteration (a sync on CUDA)."""
    while bool(cond(loop_vars)):
        loop_vars = body(loop_vars)
    return loop_vars


def cond(pred, true_fn: Callable, false_fn: Callable, *operands):
    """``fluid.layers.IfElse``/``conditional_block_op`` parity: run the one
    branch ``pred`` selects (read on the host)."""
    return true_fn(*operands) if bool(pred) else false_fn(*operands)


def switch_case(branch_index, branch_fns: Sequence[Callable], *operands):
    """``fluid.layers.Switch`` parity via an integer index, clamped into
    [0, len(branch_fns) - 1] as ``lax.switch`` clamps it."""
    fns = list(branch_fns)
    i = min(max(int(branch_index), 0), len(fns) - 1)
    return fns[i](*operands)


def case(pred_fn_pairs: Sequence[Tuple[Any, Callable]], default: Callable, *operands):
    """Fluid ``Switch`` block semantics: the FIRST true predicate's branch
    runs, else ``default`` (reference ``layers/control_flow.py`` Switch);
    predicates after the first true one are not read."""
    pairs = list(pred_fn_pairs)
    enforce(len(pairs) > 0, "case needs at least one (pred, fn) pair")
    for pred, fn in pairs:
        if bool(pred):
            return fn(*operands)
    return default(*operands)


# ---------------------------------------------------------------------------
# TensorArray (LoDTensorArray replacement)
# ---------------------------------------------------------------------------


def _clamp_index(index, capacity: int) -> int:
    return min(max(int(index), 0), capacity - 1)


class TensorArray(NamedTuple):
    """Fixed-capacity tensor array (reference LoDTensorArray +
    ``tensor_array_read_write_op.cc``). ``data`` [capacity, *item_shape];
    ``size`` (int32 scalar) is the write frontier, the reference's array
    length. Writes return a new array (the old one is unchanged) and keep
    autograd's graph through ``data``."""

    data: torch.Tensor
    size: torch.Tensor

    @staticmethod
    def create(capacity: int, item_shape: Sequence[int], dtype=torch.float32,
               device="cuda") -> "TensorArray":
        """An empty array on ``device`` (default CUDA)."""
        from paddle_tpu_torch.core.config import resolve_device
        from paddle_tpu_torch.core.dtypes import convert

        device = resolve_device(device)
        return TensorArray(
            data=torch.zeros((capacity, *item_shape), dtype=convert(dtype), device=device),
            size=torch.zeros((), dtype=torch.int32, device=device),
        )

    def write(self, index, value) -> "TensorArray":
        i = _clamp_index(index, self.data.shape[0])
        data = torch.cat([self.data[:i], value.to(self.data.dtype)[None], self.data[i + 1:]])
        new_size = torch.clamp_min(self.size, int(index) + 1)  # an integer size
        return TensorArray(data=data, size=new_size)

    def append(self, value) -> "TensorArray":
        return self.write(self.size, value)

    def read(self, index) -> torch.Tensor:
        return self.data[_clamp_index(index, self.data.shape[0])]

    def stack(self) -> torch.Tensor:
        """Every entry, written or not (the logical length is ``size``)."""
        return self.data

    def length(self) -> torch.Tensor:
        return self.size


def create_array(capacity: int, item_shape: Sequence[int], dtype=torch.float32,
                 device="cuda") -> TensorArray:
    return TensorArray.create(capacity, item_shape, dtype, device)


def array_write(arr: TensorArray, index, value) -> TensorArray:
    return arr.write(index, value)


def array_read(arr: TensorArray, index) -> torch.Tensor:
    return arr.read(index)


def array_length(arr: TensorArray) -> torch.Tensor:
    return arr.length()


# ---------------------------------------------------------------------------
# RNN builders (StaticRNN / DynamicRNN replacements)
# ---------------------------------------------------------------------------


def _stack_steps(ys: list, axis: int):
    """Per-step output trees → one tree of tensors stacked on ``axis``."""
    if not ys:
        return None
    cols = zip(*(tree.leaves(y) for y in ys))
    return tree.unflatten(ys[0], [torch.stack(list(c), dim=axis) for c in cols])


def static_rnn(step_fn: Callable, inputs, init_state, time_major: bool = False):
    """``fluid.layers.StaticRNN`` parity: run ``step_fn(state, x_t) ->
    (new_state, y_t)`` over the time axis of ``inputs`` (axis 1 unless
    ``time_major``; any tree). Returns ``(final_state, outputs)`` with the
    outputs stacked on the same time axis."""
    axis = 0 if time_major else 1
    xs = tree.leaves(inputs)
    state, ys = init_state, []
    for t in range(xs[0].shape[axis]):
        state, y = step_fn(state, tree.unflatten(inputs, [x.select(axis, t) for x in xs]))
        ys.append(y)
    return state, _stack_steps(ys, axis)


def dynamic_rnn(step_fn: Callable, inputs, lengths: torch.Tensor, init_state,
                time_major: bool = False):
    """``fluid.layers.DynamicRNN`` parity for padded batches: like
    :func:`static_rnn`, but a row's state stops evolving after its
    ``lengths`` (the reference shrinks the batch per step,
    ``layers/control_flow.py``; here the state is kept by a mask) and its
    outputs past its length are zero. Masking applies to leaves whose
    leading dim is the batch size; other leaves (a scalar step counter in
    the state) update every step."""
    axis = 0 if time_major else 1
    xs = tree.leaves(inputs)
    batch = int(lengths.shape[0])

    def masked(new, old, alive):
        if new.dim() == 0 or new.shape[0] != batch:
            return new
        return torch.where(alive.reshape((-1,) + (1,) * (new.dim() - 1)), new, old)

    state, ys = init_state, []
    for t in range(xs[0].shape[axis]):
        new_state, y = step_fn(state, tree.unflatten(inputs, [x.select(axis, t) for x in xs]))
        leaves = tree.leaves(new_state)
        alive = t < lengths.to(leaves[0].device if leaves else lengths.device)
        state = tree.unflatten(new_state, [masked(n, o, alive) for n, o in
                                           zip(leaves, tree.leaves(state))])
        ys.append(tree.map_leaves(lambda v: masked(v, torch.zeros_like(v), alive.to(v.device)), y))
    return state, _stack_steps(ys, axis)


def rank_by_length(lengths: torch.Tensor):
    """``lod_rank_table`` + ``reorder_lod_tensor_by_rank`` parity (reference
    ``layers/control_flow.py`` lod_rank_table): ``(order, inverse)``, where
    ``order`` sorts rows by descending length (a stable sort: equal lengths
    keep their order) and ``inverse`` undoes it; int64 (``INDEX_DTYPE``)."""
    order = torch.sort(lengths, descending=True, stable=True).indices
    inverse = torch.argsort(order, stable=True)
    return order.to(INDEX_DTYPE), inverse.to(INDEX_DTYPE)


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


def greedy_search(step_fn: Callable, init_carry, *, batch_size: int, max_len: int, bos_id: int,
                  eos_id: int):
    """Greedy decode, the beam_size=1 path (reference ``beam_search`` with
    beam_size=1 / argmax decode in ``layers/control_flow.py``):
    ``step_fn(carry, tokens[B]) -> (carry, log_probs[B, V])``; a row that
    emitted ``eos_id`` emits it from then on. Returns tokens [B, max_len]
    int32 on the log-probabilities' device. The first step's ``bos_id``
    tokens are on the first carry leaf's device (the CPU for a carry
    without tensors)."""
    leaves = tree.leaves(init_carry)
    dev = leaves[0].device if leaves and isinstance(leaves[0], torch.Tensor) else "cpu"
    tok = torch.full((batch_size,), bos_id, dtype=torch.int32, device=dev)
    fin = torch.zeros((batch_size,), dtype=torch.bool, device=dev)
    carry, toks = init_carry, []
    for _ in range(max_len):
        carry, log_probs = step_fn(carry, tok)
        nxt = torch.argmax(log_probs, dim=-1).to(torch.int32)
        fin = fin.to(nxt.device)
        tok = torch.where(fin, eos_id, nxt).to(torch.int32)
        fin = fin | (tok == eos_id)
        toks.append(tok)
    return torch.stack(toks, dim=1)
