"""Pipeline parallelism: GPipe-style microbatching over a ``pipe`` mesh
axis — port of ``paddle_tpu/parallel/pipeline.py``.

No reference counterpart (the reference's only cross-device strategies are
data parallelism and the parameter server). Each rank along the ``pipe``
axis runs one stage; microbatch activations pass stage to stage by
point-to-point ``ppermute`` (``collective._permuted``: NCCL, gloo, or gloo
staged through host memory).

The schedule is the JAX package's: ``n_micro + S - 1`` steps; at step t
stage s runs microbatch ``t - s`` (stage 0 reads it from the feed, the
others from what the stage before sent at step t - 1), and every stage
sends its output on at every step. A stage skips its compute at the bubble
steps, where it holds no real microbatch, and still takes part in every
exchange. The last stage's outputs are summed over the axis (every other
stage adds zeros), so every rank holds them; that sum's backward is the
identity, as ``reduce_from_axis``'s: each rank computes the same loss from
them, and only the last stage's gradient enters the schedule.

The JAX package differentiates its ``scan`` globally. Here each rank has
its own autograd graph, and a stage's outputs do not reach its own loss
(only the last stage's do), so the backward schedule is written out
(:class:`_Pipeline`): the steps in reverse, each live stage taking its
output's gradient (the loss's at the last stage, else what the next stage
sent back), backpropagating through its step, and sending the input's
gradient to the stage before — one exchange a step on every rank, in
lockstep. ``remat=True`` keeps no step's activations: the backward runs
each step's forward again before its backward (``jax.checkpoint`` of each
step, the 1F1B memory profile), so a stage runs its forward twice.

A stage's parameters (a slice of ``stacked_params``) and the microbatches
(stage 0's input) get their gradient on the stage that used them, zeros on
the others; the backward sums both over the axis (one all-reduce), the
adjoint of handing every stage the same replicated inputs, as ``shard_map``
does in the JAX package. So every gradient is whole on every rank: what
fed the microbatches and what reads the outputs alike.

Microbatch rows split over the non-``pipe`` axes of size > 1 as in the JAX
package (``pipeline.py:121-136``, ``mb_spec = P(None, other_axes)``): each
rank runs its rows of every microbatch and the outputs are gathered back
(the microbatches' and the parameters' gradients summed over those axes,
as ``shard_map`` sums a replicated input's). Called on global arrays the
rows split over every such axis, in mesh order; inside a ``DataParallel``
step the rows over the step's token axes (``data``, ``seq``) are already
the rank's, and they split over the others (``model``: the ranks of a
``model`` group hold the same rows outside the stages).

Inside a stage the body runs on the stage's WHOLE parameters, as the JAX
package's ``shard_map`` hands every rank its stage's parameters whole
(``P("pipe")``): a leaf a rank holds as its block over ``model``
(``blocks``) is gathered over that axis at stage entry, and its gradient
is the rows' sum kept as the rank's block (the gather's adjoint, a sum
over the axis cut to the block).
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import torch

from paddle_tpu_torch import framework
from paddle_tpu_torch.core import tree as tree_mod
from paddle_tpu_torch.core.enforce import enforce
from paddle_tpu_torch.parallel import collective
from paddle_tpu_torch.parallel import context as dp_context
from paddle_tpu_torch.parallel import mesh as mesh_mod

__all__ = ["pipeline_apply", "stack_stage_params", "split_microbatches"]


def stack_stage_params(stage_params: Sequence):
    """Stack per-stage parameter trees along a new leading 'stage' dim: each
    leaf becomes ``[S, ...]``, stage s's values at index s."""
    per_stage = [tree_mod.leaves(p) for p in stage_params]
    return tree_mod.unflatten(stage_params[0], [torch.stack(xs) for xs in zip(*per_stage)])


def split_microbatches(x: torch.Tensor, n_micro: int) -> torch.Tensor:
    """[B, ...] → [n_micro, B/n_micro, ...]."""
    enforce(
        x.shape[0] % n_micro == 0,
        f"batch {x.shape[0]} not divisible into {n_micro} microbatches",
    )
    return x.reshape((n_micro, x.shape[0] // n_micro) + tuple(x.shape[1:]))


class _Schedule:
    """One rank's part of the GPipe schedule: its stage, the step count and
    the exchanges with its neighbours."""

    def __init__(self, stage_fn, params, mbs, ax, remat: bool):
        self.stage_fn, self.params, self.mbs, self.ax = stage_fn, params, mbs, ax
        self.remat = remat
        self.s, self.n = ax.index, ax.size
        self.n_micro = mbs.shape[0]
        self.steps = self.n_micro + self.n - 1
        # activations go to the next stage, gradients back to the one before
        self.fwd = [(i, i + 1) for i in range(self.n - 1)]
        self.bwd = [(i + 1, i) for i in range(self.n - 1)]
        frame = getattr(framework._tls, "frame", None)
        # a stage that builds layers re-enters the model's frame (its names
        # and group) when the backward recomputes it on another thread
        self.replay = framework._Replay(frame) if frame is not None else None

    def micro(self, t: int) -> Optional[int]:
        """The microbatch this stage runs at step t, None at a bubble."""
        m = t - self.s
        return m if 0 <= m < self.n_micro else None

    def run(self, params, x):
        if self.replay is None:
            return self.stage_fn(params, x)
        with self.replay.replay():
            return self.stage_fn(params, x)

    def exchange(self, y: torch.Tensor, perm) -> torch.Tensor:
        return collective._permuted(y, self.ax, perm)

    def forward(self, grad: bool):
        """The forward schedule: the last stage's outputs ``[n_micro, ...]``
        (zeros on the other stages) and, with ``grad``, each live step's
        ``(input, output)`` with its graph (its input alone under remat)."""
        zeros = torch.zeros_like(self.mbs[0])
        cur, outs, saved = zeros, [zeros] * self.n_micro, {}
        for t in range(self.steps):
            m = self.micro(t)
            y = zeros
            if m is not None:
                x = self.mbs[m] if self.s == 0 else cur
                if grad and not self.remat:
                    x = x.detach().requires_grad_(x.is_floating_point())
                    with torch.enable_grad():
                        y = self.run(self.params, x)
                    saved[t] = (x, y)
                    y = y.detach()
                else:
                    with torch.no_grad():
                        y = self.run(self.params, x)
                    if grad:
                        saved[t] = (x.detach(), None)
                if self.s == self.n - 1:
                    outs[m] = y
            cur = self.exchange(y.to(zeros.dtype), self.fwd)
        return torch.stack(outs), saved

    def backward(self, saved, g_outs, leaves: List[torch.Tensor]):
        """The backward schedule: the gradient of the microbatches (stage
        0's; zeros elsewhere) and of ``leaves`` (the stage's parameters)."""
        d_mbs = torch.zeros_like(self.mbs)
        d_leaves = [None] * len(leaves)
        zeros = torch.zeros_like(self.mbs[0])
        dcur = zeros
        for t in reversed(range(self.steps)):
            m = self.micro(t)
            dx = zeros
            if m is not None:
                dy = g_outs[m] if self.s == self.n - 1 else dcur
                x, y = saved[t]
                if y is None:  # remat: this step's forward again
                    x = x.requires_grad_(x.is_floating_point())
                    with torch.enable_grad():
                        y = self.run(self.params, x)
                inputs = ([x] if x.requires_grad else []) + leaves
                got = torch.autograd.grad(y, inputs, dy.to(y.dtype), allow_unused=True)
                if x.requires_grad:
                    dx, got = got[0].to(zeros.dtype), got[1:]
                for i, g in enumerate(got):
                    if g is not None:
                        d_leaves[i] = g if d_leaves[i] is None else d_leaves[i] + g
                if self.s == 0:
                    d_mbs[m] = dx
                saved.pop(t)
            dcur = self.exchange(dx, self.bwd)
        return d_mbs, d_leaves


class _Pipeline(torch.autograd.Function):
    """The schedule as one node of each rank's graph: forward the GPipe
    steps, backward the reverse steps (module docstring)."""

    @staticmethod
    def forward(ctx, sched: _Schedule, mbs, *stacked_leaves):
        leaves = [t.detach()[sched.s].requires_grad_(t.is_floating_point())
                  for t in stacked_leaves]
        sched.params = tree_mod.unflatten(sched.params, leaves)
        sched.mbs = mbs.detach()
        outs, saved = sched.forward(grad=True)
        ctx.sched, ctx.saved, ctx.leaves = sched, saved, leaves
        ctx.shapes = [t.shape for t in stacked_leaves]
        return sched.ax.reduce(outs)

    @staticmethod
    def backward(ctx, g_outs):
        sched = ctx.sched
        d_mbs, d_leaves = sched.backward(ctx.saved, g_outs, ctx.leaves)
        grads = []
        for shape, leaf, g in zip(ctx.shapes, ctx.leaves, d_leaves):
            full = torch.zeros(shape, dtype=leaf.dtype, device=leaf.device)
            if g is not None:
                full[sched.s] = g
            grads.append(full)
        # each entry is nonzero on one stage only: the f32 sum over the axis
        # is exact, and leaves every gradient whole on every stage
        parts = [d_mbs] + grads
        flat = sched.ax.reduce(torch.cat([t.float().reshape(-1) for t in parts]))
        out, off = [], 0
        for t in parts:
            out.append(flat[off:off + t.numel()].view(t.shape).to(t.dtype))
            off += t.numel()
        return (None, *out)


def _row_axes(mesh, axis: str) -> List[str]:
    """The non-pipe axes of size > 1 the microbatch rows split over, in
    mesh order; inside a DataParallel step not its token axes (the rank's
    rows over those are already its own)."""
    group = dp_context.active()
    done = set(group.axes) if group is not None else set()
    return [a for a in mesh.axis_names if a != axis and a not in done and mesh.shape[a] > 1]


def _whole(t: torch.Tensor, dims, rows: Sequence[str]) -> torch.Tensor:
    """A stacked leaf as the stage body takes it: gathered whole over each
    (row) axis it is a block on, whose adjoint sums the ranks' gradients
    and cuts the block (``all_gather``), and its gradient summed over the
    other row axes (the ranks' rows join)."""
    for dim, a in dims:
        enforce(a in rows, f"pipeline_apply: a block over {a!r}, which the rows do not split")
        t = collective.all_gather(t, a, axis=dim)
    for a in rows:
        if a not in {b for _, b in dims}:
            t = collective.copy_to_axis(t, a)
    return t


def pipeline_apply(
    stage_fn: Callable,
    stacked_params,
    microbatches: torch.Tensor,
    mesh: mesh_mod.Mesh,
    axis: str = mesh_mod.PIPE_AXIS,
    remat: bool = False,
    blocks=None,
):
    """Run ``y_mb = stage_{S-1}(...stage_0(x_mb))`` for each microbatch with
    the stages laid out along the ``axis`` mesh dimension (every rank of the
    mesh calls it with the same arguments).

    ``stage_fn(params_one_stage, x) -> y`` must be shape-preserving across
    stages. ``stacked_params`` leaves are ``[S, ...]`` (see
    :func:`stack_stage_params`); rank s runs ``stage_fn`` on index s.
    ``microbatches`` is ``[n_micro, mb, ...]``. Returns ``[n_micro, mb,
    ...]`` outputs, held by every rank. ``remat=True`` recomputes each
    step's activations in the backward pass (module docstring).
    ``blocks`` (``stacked_params`` a flat dict): ``{name: [(dim, axis),
    ...]}``, the dims of each leaf the rank holds as its block over that
    axis; such leaves enter the stage whole."""
    n_micro = microbatches.shape[0]
    enforce(axis in mesh.shape, f"pipeline_apply: axis {axis!r} not in mesh axes "
            f"{mesh.axis_names}")
    rows = _row_axes(mesh, axis)
    other_size = 1
    for a in rows:
        other_size *= mesh.shape[a]
    enforce(
        microbatches.shape[1] % other_size == 0,
        f"microbatch size {microbatches.shape[1]} not divisible by the "
        f"non-pipe mesh axes {tuple(rows)} (size {other_size})",
    )
    leaves = tree_mod.leaves(stacked_params)
    enforce(all(t.shape[0] == mesh.shape[axis] for t in leaves),
            f"pipeline_apply: stacked_params need a leading stage dim of {mesh.shape[axis]}")
    split = [()] * len(leaves)
    if blocks:
        enforce(isinstance(stacked_params, dict),
                "pipeline_apply: blocks= needs stacked_params as a flat dict")
        split = [tuple(blocks.get(k, ())) for k in sorted(stacked_params)]
    with mesh:
        mbs = microbatches
        for a in rows:
            mbs = collective.shard_replicated(mbs, a, 1)
        leaves = [_whole(t, dims, rows) for t, dims in zip(leaves, split)]
        sched = _Schedule(stage_fn, stacked_params, mbs, collective._Axis(axis), remat)
        grad = torch.is_grad_enabled() and (mbs.requires_grad or any(
            t.requires_grad for t in leaves))
        if grad:
            out = _Pipeline.apply(sched, mbs, *leaves)
        else:
            sched.params = tree_mod.unflatten(stacked_params, [t[sched.s] for t in leaves])
            outs, _ = sched.forward(grad=False)
            out = sched.ax.reduce(outs)
        for a in reversed(rows):
            out = collective.gather_replicated(out, a, 1)
    return out
