"""Collective communication primitives — port of
``paddle_tpu/parallel/collective.py``.

Reference: the op-handle collectives —
``details/all_reduce_op_handle.cc:48`` (grouped ncclAllReduce),
``details/reduce_op_handle.cc``, ``details/broadcast_op_handle.cc``
(ncclBcast), ``operators/nccl/nccl_op.cc``.

Each call runs over the process group of a mesh axis: the innermost
``with mesh:`` or, outside one, :func:`~paddle_tpu_torch.parallel.mesh.default_mesh`.
Every rank of the axis makes the same calls in the same order, as every
device runs the same ``shard_map`` body in JAX. On an axis of size 1 (or
without a process group) they are identities. They are differentiable
where the JAX package's are: the backward of a sum is a sum, of a gather a
reduce-scatter, of a scatter a gather, of a permutation the inverse
permutation, of a broadcast a sum returned to the root; ``max``/``min``
carry no gradient. ``reduce_scatter`` and ``ppermute`` are built on
``all_reduce`` and ``all_gather``, which every backend offers.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
import torch.distributed as dist

from paddle_tpu_torch.parallel import mesh as mesh_mod

__all__ = ["all_reduce", "all_gather", "reduce_scatter", "broadcast", "ppermute", "ring_shift",
           "axis_index", "axis_size", "gather_kv_page", "scatter_kv_page"]

_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX, "min": dist.ReduceOp.MIN}


class _Axis:
    """What a collective needs of one mesh axis for this rank."""

    def __init__(self, axis_name: str):
        mesh = mesh_mod.current_mesh()
        self.group = mesh.group(axis_name)
        self.size = mesh.shape[axis_name]
        self.ranks = mesh.axis_ranks(axis_name) if self.group is not None else [mesh_mod.process_rank()]
        self.index = self.ranks.index(mesh_mod.process_rank())

    def reduce(self, x: torch.Tensor, op: str = "sum") -> torch.Tensor:
        y = x.detach().clone()
        if self.group is not None:
            dist.all_reduce(y, op=_OPS[op], group=self.group)
        return y

    def gather(self, x: torch.Tensor) -> List[torch.Tensor]:
        """Every member's ``x``, in axis order."""
        x = x.detach().contiguous()
        if self.group is None:
            return [x]
        outs = [torch.empty_like(x) for _ in self.ranks]
        dist.all_gather(outs, x, group=self.group)
        by_rank = dict(zip(sorted(self.ranks), outs))
        return [by_rank[r] for r in self.ranks]


class _Sum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax, scale):
        ctx.ax, ctx.scale = ax, scale
        y = ax.reduce(x)
        return y * scale if scale != 1 else y

    @staticmethod
    def backward(ctx, g):
        y = ctx.ax.reduce(g)
        return (y * ctx.scale if ctx.scale != 1 else y), None, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax, axis, tiled):
        ctx.ax, ctx.axis, ctx.tiled = ax, axis, tiled
        parts = ax.gather(x)
        return torch.cat(parts, dim=axis) if tiled else torch.stack(parts, dim=axis)

    @staticmethod
    def backward(ctx, g):
        total = ctx.ax.reduce(g)
        if ctx.tiled:
            n = total.shape[ctx.axis] // ctx.ax.size
            return total.narrow(ctx.axis, ctx.ax.index * n, n), None, None, None
        return total.select(ctx.axis, ctx.ax.index), None, None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax, dim):
        ctx.ax, ctx.dim = ax, dim
        n = x.shape[dim] // ax.size
        return ax.reduce(x).narrow(dim, ax.index * n, n).contiguous()

    @staticmethod
    def backward(ctx, g):
        return torch.cat(ctx.ax.gather(g), dim=ctx.dim), None, None


class _Broadcast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax, root):
        ctx.ax, ctx.root = ax, root
        y = x.detach().clone()
        if ax.group is not None:
            dist.broadcast(y, src=ax.ranks[root], group=ax.group)
        return y

    @staticmethod
    def backward(ctx, g):
        total = ctx.ax.reduce(g)
        return (total if ctx.ax.index == ctx.root else torch.zeros_like(total)), None, None


class _Permute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax, perm):
        ctx.ax, ctx.perm = ax, perm
        return _permuted(x, ax, perm)

    @staticmethod
    def backward(ctx, g):
        return _permuted(g, ctx.ax, [(d, s) for s, d in ctx.perm]), None, None


def _permuted(x, ax, perm) -> torch.Tensor:
    """The value the member at ``src`` sends to this member (``(src, dst)``
    pairs over axis indices); zeros where none is sent to it, as in JAX."""
    srcs = [s for s, d in perm if d == ax.index]
    parts = ax.gather(x)
    return parts[srcs[0]].clone() if srcs else torch.zeros_like(x)


def _check_perm(perm, n: int) -> List[Tuple[int, int]]:
    perm = [(int(s), int(d)) for s, d in perm]
    srcs, dsts = [s for s, _ in perm], [d for _, d in perm]
    if len(set(srcs)) != len(srcs) or len(set(dsts)) != len(dsts) or any(
            not 0 <= i < n for i in srcs + dsts):
        raise ValueError(f"ppermute: {perm} is not a partial permutation of {n} indices")
    return perm


def all_reduce(x: torch.Tensor, axis_name: str, op: str = "sum") -> torch.Tensor:
    """AllReduceOpHandle parity: ``sum``, ``mean``, ``max`` or ``min`` over
    the axis."""
    if op not in ("sum", "mean", "max", "min"):
        raise ValueError(f"unknown reduce op {op!r}")
    ax = _Axis(axis_name)
    if op in ("max", "min"):
        return ax.reduce(x, op)
    return _Sum.apply(x, ax, 1.0 / ax.size if op == "mean" else 1)


def all_gather(x: torch.Tensor, axis_name: str, axis: int = 0, tiled: bool = True) -> torch.Tensor:
    """Every member's ``x`` in axis order: concatenated on ``axis``
    (``tiled``) or stacked on a new ``axis``."""
    return _Gather.apply(x, _Axis(axis_name), axis, tiled)


def reduce_scatter(x: torch.Tensor, axis_name: str, scatter_dimension: int = 0) -> torch.Tensor:
    """The sum over the axis, split on ``scatter_dimension``: member i keeps
    the i-th chunk (``lax.psum_scatter(..., tiled=True)``)."""
    ax = _Axis(axis_name)
    if x.shape[scatter_dimension] % ax.size:
        raise ValueError(f"reduce_scatter: dim {scatter_dimension} of size "
                         f"{x.shape[scatter_dimension]} does not split over {ax.size}")
    return _ReduceScatter.apply(x, ax, scatter_dimension)


def broadcast(x: torch.Tensor, axis_name: str, root: int = 0) -> torch.Tensor:
    """BroadcastOpHandle parity: every member takes root's value."""
    return _Broadcast.apply(x, _Axis(axis_name), root)


def ppermute(x: torch.Tensor, axis_name: str, perm: Sequence[Tuple[int, int]]) -> torch.Tensor:
    """Send ``x`` from axis index ``src`` to ``dst`` for each pair of
    ``perm``; a member no pair sends to receives zeros."""
    ax = _Axis(axis_name)
    return _Permute.apply(x, ax, _check_perm(perm, ax.size))


def ring_shift(x: torch.Tensor, axis_name: str, shift: int = 1) -> torch.Tensor:
    n = axis_size(axis_name)
    return ppermute(x, axis_name, [(i, (i + shift) % n) for i in range(n)])


def axis_index(axis_name: str) -> int:
    return _Axis(axis_name).index


def axis_size(axis_name: str) -> int:
    return _Axis(axis_name).size


# -- KV-page transfer primitives (serving.disagg) ---------------------------
# Page arrays are ``[L, num_pages, H_kv, page_size, dh]``; one page is the
# fixed-shape ``[L, H_kv, page_size, dh]`` slice.

def gather_kv_page(pages: torch.Tensor, page_id: int) -> torch.Tensor:
    """Extract one physical page from a paged KV array (device-side)."""
    return pages[:, page_id]


def scatter_kv_page(pages: torch.Tensor, page_id: int, page: torch.Tensor) -> torch.Tensor:
    """``pages`` with ``page`` implanted at ``page_id`` (a new tensor, as
    JAX's functional ``.at[].set``)."""
    idx = torch.tensor([int(page_id)], device=pages.device)
    return pages.index_copy(1, idx, page.unsqueeze(1).to(pages.dtype))
