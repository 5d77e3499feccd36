"""Mixture-of-Experts with expert parallelism over an ``expert`` mesh axis —
port of ``paddle_tpu/parallel/moe.py``.

The GShard/Switch dense-dispatch pattern: top-k gating builds a
[tokens, experts, capacity] dispatch tensor, and the expert FFNs run
batched over their [E, ...] parameters. Everything is fixed-shape:
per-expert token capacity bounds the routed tokens, overflow tokens are
dropped (standard Switch behavior), and the auxiliary load-balancing loss
pushes the router toward uniform occupancy.

Global semantics on blocks. The JAX package routes the GLOBAL batch's
tokens (its model runs on global arrays). Inside a data-parallel step each
rank holds a block of the batch (``parallel/context.py``), so the router's
global quantities are computed over the step's group: the capacity's
token count N, each token's buffer position — an exclusive prefix of
per-expert counts over the global ``(b, t)`` order
(``context.row_prefix``) — and the load-balance ``density``,
``density_proxy`` and ``n_real`` (``context.token_sum``, differentiable).
So the same tokens are dropped as in the JAX package when an expert
overflows.

Expert parallelism. The expert parameters carry sharding ``('expert',
...)``; under a mesh whose ``expert`` axis has size n each rank holds
(``parallel/sharding.py::shard_variables``) and computes its E/n experts,
replicated over every other axis (``model`` too, as in the JAX package).
The work is summed over the ``expert`` group: the ranks that share every
other coordinate. Two cases, by the batch specs:

- the ranks of the group hold the same tokens (``P("data")``): each
  dispatches them to its local experts, and the partial outputs are summed
  over the axis (``collective.reduce_from_axis``: sum forward, identity
  backward). Where the replicated router feeds the split work — the tokens
  into the dispatch product and the router logits into the gate — sits the
  conjugate (``collective.copy_to_axis``: identity forward, sum backward),
  and the aux loss's gradient, which every rank computes whole, is divided
  by n before that sum. So the router's and the upstream layers' gradients
  come out whole and equal on every expert rank, and none is summed twice;
- the rows are split over ``expert`` too (``P(("data", "expert"))``): each
  rank routes its own tokens (the positions global, so no two tokens of
  the group share a buffer slot) into all E experts' buffers and sends
  each expert block's buffers to the rank that holds it
  (``collective.all_to_all``: GShard's dispatch exchange), which sums
  what it received (each slot filled by one sender), runs its experts and
  hands their outputs to the whole group (``collective.all_gather``) for
  each rank to combine its own tokens. The backward of the all-to-all is
  the inverse all-to-all, of the gather a reduce-scatter, so every
  gradient is its rank's tokens' own.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch

from paddle_tpu_torch.core.enforce import enforce
from paddle_tpu_torch.framework import ParamAttr, create_parameter, name_scope
from paddle_tpu_torch.parallel import collective
from paddle_tpu_torch.parallel import context as dp_context
from paddle_tpu_torch.parallel import mesh as mesh_mod

__all__ = ["switch_gate", "top2_gate", "moe_ffn", "MoEOutput"]


class MoEOutput(NamedTuple):
    output: torch.Tensor
    aux_loss: torch.Tensor  # load-balancing loss (add to the model loss)


def _one_hot(idx: torch.Tensor, n: int, dtype) -> torch.Tensor:
    """``jax.nn.one_hot``: all zeros where ``idx`` is outside [0, n)."""
    return (idx[:, None] == torch.arange(n, device=idx.device)).to(dtype)


def _before(mask_i: torch.Tensor, rows: Optional[int]) -> torch.Tensor:
    """[N, E]: per token and expert, the count of ``mask_i`` over the tokens
    before it in the global ``(b, t)`` order (the local cumsum outside a
    data-parallel step; the N tokens form ``rows`` rows)."""
    if dp_context.active() is None:
        return torch.cumsum(mask_i, 0) - mask_i
    n, e = mask_i.shape
    m = mask_i.reshape(rows, n // rows, e)
    before = dp_context.row_prefix(m.sum(1))
    return (torch.cumsum(m, 1) - m + before[:, None, :]).reshape(n, e)


def _aux_loss(tm, probs, route_mask):
    """The load-balance loss over the global batch (Switch eq. 4): E *
    sum_e density_e * density_proxy_e, the density from ``route_mask`` (no
    gradient), the proxy from ``probs`` (differentiable), both over the
    real tokens."""
    n_real = torch.clamp_min(dp_context.global_sum(tm.sum()), 1.0)
    density = dp_context.global_sum(route_mask.sum(0)) / n_real
    density_proxy = dp_context.token_sum((probs * tm[:, None]).sum(0)) / n_real
    return probs.shape[1] * torch.sum(density * density_proxy)


def switch_gate(
    logits: torch.Tensor, capacity: int,
    token_mask: Optional[torch.Tensor] = None,
    rows: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Top-1 (Switch) routing. ``logits``: [N, E]. Returns
    ``(dispatch [N, E, C] bool, combine [N, E, C] float, aux_loss)``.

    Position within each expert's buffer is the token's rank among tokens
    routed to that expert (integer counts); ranks >= capacity are dropped.
    ``token_mask`` ([N], 1 = real token): masked (padding) tokens are
    excluded from routing entirely. ``rows``: the rows the N tokens form,
    for the global order inside a data-parallel step."""
    N, E = logits.shape
    probs = torch.softmax(logits.float(), dim=-1)
    expert_idx = torch.argmax(probs, dim=-1)  # [N]
    expert_mask = _one_hot(expert_idx, E, probs.dtype)  # [N, E]
    # an all-ones mask reproduces the dense mean statistics exactly
    tm = torch.ones(N, dtype=probs.dtype, device=probs.device) if token_mask is None \
        else token_mask.to(probs.dtype)
    expert_mask = expert_mask * tm[:, None]
    aux_loss = _aux_loss(tm, probs, expert_mask)

    # position of each token in its expert's buffer — integer counts
    mask_i = expert_mask.to(torch.int64)
    pos = (_before(mask_i, rows) * mask_i).sum(-1)  # [N]
    keep = pos < capacity
    gate = torch.amax(probs * expert_mask, dim=-1) * keep  # [N]
    dispatch = (expert_mask.bool() & keep[:, None])[..., None] & \
        _one_hot(pos, capacity, torch.bool)[:, None, :]
    combine = gate[:, None, None] * dispatch.to(probs.dtype)
    return dispatch, combine, aux_loss


def top2_gate(
    logits: torch.Tensor, capacity: int,
    token_mask: Optional[torch.Tensor] = None,
    rows: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Top-2 (GShard) routing: each token goes to its two highest-prob
    experts, gate weights renormalized over the pair; second-choice tokens
    queue AFTER all first choices in each expert's buffer (GShard's
    priority rule), so overflow drops second choices first. Same
    ``(dispatch, combine, aux_loss)``, ``token_mask`` and ``rows`` contract
    as :func:`switch_gate`."""
    N, E = logits.shape
    enforce(E >= 2, f"top2_gate needs >= 2 experts, got {E}")
    probs = torch.softmax(logits.float(), dim=-1)

    idx1 = torch.argmax(probs, dim=-1)  # [N]
    mask1 = _one_hot(idx1, E, probs.dtype)
    probs2 = probs * (1.0 - mask1)
    idx2 = torch.argmax(probs2, dim=-1)
    # saturated softmax: probs2 can be exactly zero everywhere — argmax then
    # points at expert 0 and a phantom zero-gate route would eat a real
    # capacity slot there; drop the second route entirely in that case
    has2 = (torch.amax(probs2, dim=-1) > 0).to(probs.dtype)
    mask2 = _one_hot(idx2, E, probs.dtype) * has2[:, None]
    tm = torch.ones(N, dtype=probs.dtype, device=probs.device) if token_mask is None \
        else token_mask.to(probs.dtype)
    mask1 = mask1 * tm[:, None]
    mask2 = mask2 * tm[:, None]
    # aux loss uses FIRST-choice density (GShard eq. for l_aux)
    aux_loss = _aux_loss(tm, probs, mask1)

    # renormalized pair gates
    g1 = torch.sum(probs * mask1, dim=-1)
    g2 = torch.sum(probs * mask2, dim=-1)
    denom = torch.clamp_min(g1 + g2, 1e-9)
    g1, g2 = g1 / denom, g2 / denom

    # buffer positions: first choices rank first, then second choices
    m1_i = mask1.to(torch.int64)
    m2_i = mask2.to(torch.int64)
    pos1 = _before(m1_i, rows) * m1_i  # [N, E]
    count1 = dp_context.global_sum(m1_i.sum(0))[None, :]  # [1, E]
    pos2 = _before(m2_i, rows) * m2_i + count1 * m2_i

    def one_route(mask_i, pos_ne, gate):
        pos = pos_ne.sum(-1)  # [N]
        keep = pos < capacity
        dispatch = (mask_i.bool() & keep[:, None])[..., None] & \
            _one_hot(pos, capacity, torch.bool)[:, None, :]
        combine = (gate * keep)[:, None, None] * dispatch.to(probs.dtype)
        return dispatch, combine

    d1, c1 = one_route(m1_i, pos1, g1)
    d2, c2 = one_route(m2_i, pos2, g2)
    return d1 | d2, c1 + c2, aux_loss


# router table: (gate_fn, dispatched routes per token) — capacity scales
# with the route count, so new routers declare it here
_ROUTERS = {"top1": (switch_gate, 1), "switch": (switch_gate, 1), "top2": (top2_gate, 2)}


class _ScaleGrad(torch.autograd.Function):
    """Identity forward, gradient times ``scale`` backward."""

    @staticmethod
    def forward(ctx, x, scale):
        ctx.scale = scale
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.scale, None


def _expert_block(num_experts: int, local: int):
    """``(mesh, n, first expert)`` of this rank's block of ``local`` of the
    ``num_experts`` experts; ``None`` when the rank holds them all."""
    if local == num_experts:
        return None
    mesh = mesh_mod.entered_mesh()
    n = mesh.shape.get(mesh_mod.EXPERT_AXIS, 1) if mesh is not None else 1
    enforce(n > 1 and local * n == num_experts,
            f"moe_ffn: this rank holds {local} of {num_experts} experts, which needs a mesh "
            f"with an {mesh_mod.EXPERT_AXIS!r} axis of size {num_experts // max(local, 1)} "
            "entered (with mesh:); the current one is "
            f"{mesh.shape if mesh is not None else None}")
    return mesh, n, mesh.axis_index(mesh_mod.EXPERT_AXIS) * local


def moe_ffn(
    x: torch.Tensor,
    num_experts: int,
    d_ff: int,
    capacity_factor: float = 1.25,
    act=torch.relu,
    name: Optional[str] = None,
    router: str = "top1",
    token_mask: Optional[torch.Tensor] = None,
) -> MoEOutput:
    """Expert-parallel FFN layer: ``x`` [B, T, D] (or [N, D]) through
    ``num_experts`` independent two-layer FFNs selected by a router —
    ``router='top1'`` (Switch) or ``'top2'`` (GShard pair dispatch).

    Per-expert weights are created as [E, D, d_ff] / [E, d_ff, D] with
    sharding ('expert', None, None); a rank that holds a block of them
    computes its experts' share and sums the outputs over the ``expert``
    axis (module docstring).

    ``token_mask`` (same leading shape as ``x`` minus the feature dim,
    1 = real token): ragged batches — padding tokens are excluded from
    routing (no expert capacity consumed, no load-balance contribution)
    and their output rows are zero.
    """
    enforce(router in _ROUTERS, f"unknown router {router!r}; known: {sorted(_ROUTERS)}")
    squeeze = x.dim() == 2
    if squeeze:
        x = x[None]
        if token_mask is not None and token_mask.dim() == 1:
            token_mask = token_mask[None]
    B, T, D = x.shape
    N = B * T
    tokens = x.reshape(N, D)
    flat_mask = None if token_mask is None else token_mask.reshape(N)
    gate_fn, routes = _ROUTERS[router]
    n_global = dp_context.global_count(N)
    capacity = max(1, int(math.ceil(routes * n_global / num_experts * capacity_factor)))

    with name_scope(name or "moe"):
        wg = create_parameter([D, num_experts], x.dtype, name="w_gate")
        w_in = create_parameter(
            [num_experts, D, d_ff], x.dtype, name="w_in",
            attr=ParamAttr(sharding=(mesh_mod.EXPERT_AXIS, None, None)),
        )
        b_in = create_parameter(
            [num_experts, d_ff], x.dtype, name="b_in",
            attr=ParamAttr(sharding=(mesh_mod.EXPERT_AXIS, None)),
        )
        w_out = create_parameter(
            [num_experts, d_ff, D], x.dtype, name="w_out",
            attr=ParamAttr(sharding=(mesh_mod.EXPERT_AXIS, None, None)),
        )
        b_out = create_parameter(
            [num_experts, D], x.dtype, name="b_out",
            attr=ParamAttr(sharding=(mesh_mod.EXPERT_AXIS, None)),
        )

    logits = torch.matmul(tokens.float(), wg.float())
    block = _expert_block(num_experts, w_in.shape[0])
    # the rows split over expert too: the buffers move, not the tokens
    exchange = block is not None and dp_context.rows_split_over(mesh_mod.EXPERT_AXIS)
    if block is not None and not exchange:
        mesh, n_exp, e0 = block
        with mesh:
            logits = collective.copy_to_axis(logits, mesh_mod.EXPERT_AXIS)
            tokens = collective.copy_to_axis(tokens, mesh_mod.EXPERT_AXIS)
    dispatch, combine, aux = gate_fn(logits, capacity, token_mask=flat_mask, rows=B)
    if block is not None and not exchange:
        aux = _ScaleGrad.apply(aux, 1.0 / n_exp)
        dispatch = dispatch[:, e0:e0 + w_in.shape[0]]
        combine = combine[:, e0:e0 + w_in.shape[0]]

    # dispatch: [N, E, C] × [N, D] → expert inputs [E, C, D]
    expert_in = torch.einsum("nec,nd->ecd", dispatch.to(x.dtype), tokens)
    if exchange:  # the group's tokens in this rank's experts' buffers
        mesh, n_exp = block[:2]
        with mesh:
            sent = collective.all_to_all(expert_in, mesh_mod.EXPERT_AXIS, 0, 0)
        expert_in = sent.view(n_exp, w_in.shape[0], *sent.shape[1:]).sum(0)
    h = act(torch.einsum("ecd,edf->ecf", expert_in, w_in) + b_in[:, None, :])
    expert_out = torch.einsum("ecf,efd->ecd", h, w_out) + b_out[:, None, :]
    if exchange:  # every expert's outputs, for this rank's tokens to combine
        with block[0]:
            expert_out = collective.all_gather(expert_out, mesh_mod.EXPERT_AXIS, axis=0)
    # combine: [N, E, C] × [E, C, D] → [N, D] (the weighted sum)
    out = torch.einsum("nec,ecd->nd", combine.to(x.dtype), expert_out)
    if block is not None and not exchange:
        with block[0]:
            out = collective.reduce_from_axis(out, mesh_mod.EXPERT_AXIS)

    out = out.reshape(B, T, D)
    if squeeze:
        out = out[0]
    return MoEOutput(output=out, aux_loss=aux.float())
