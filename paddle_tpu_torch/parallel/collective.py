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
permutation, of an all-to-all the inverse all-to-all, of a broadcast a sum
returned to the root; ``max``/``min`` carry no gradient.
``reduce_scatter`` is built on ``all_reduce``.

``ppermute`` and ``all_to_all`` move each member's data to its
destinations only (one block per step of a ring, not the whole axis). How
they travel is chosen from the axis's backend and the tensor's device,
never by catching an error (``_route``):

- ``"nccl"``: NCCL point-to-point (``batch_isend_irecv``) and
  ``all_to_all_single`` on the card;
- ``"gloo"``: gloo's point-to-point and ``all_to_all_single`` on CPU
  tensors;
- ``"gloo_host"``: gloo with CUDA tensors (two ranks sharing one card):
  gloo's point-to-point and all-to-all take CPU tensors, so the tensor is
  staged through host memory and the same CPU exchange runs.

:func:`routes_taken` records the route of each exchange since
:func:`reset_routes`. :func:`shard_replicated` / :func:`gather_replicated`
and :func:`copy_to_axis` / :func:`reduce_from_axis` are the conjugate pairs
that let every rank of an axis hold a replicated value and its whole
gradient while the work between them is split over the axis (JAX's
``shard_map`` in/out specs; Megatron's f and g operators).
"""

from __future__ import annotations

import datetime
from typing import Dict, List, Sequence, Tuple

import torch
import torch.distributed as dist

from paddle_tpu_torch.parallel import mesh as mesh_mod

__all__ = ["all_reduce", "all_gather", "reduce_scatter", "broadcast", "ppermute", "ring_shift",
           "all_to_all", "axis_index", "axis_size", "shard_replicated", "gather_replicated",
           "copy_to_axis", "reduce_from_axis", "routes_taken", "reset_routes",
           "gather_kv_page", "scatter_kv_page"]

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
        # NCCL takes contiguous tensors only (a gradient may come transposed)
        y = x.detach().clone(memory_format=torch.contiguous_format)
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
        y = x.detach().clone(memory_format=torch.contiguous_format)
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


# the route of each exchange since reset_routes(): {op: {route: calls}}
_ROUTES: Dict[str, Dict[str, int]] = {}


def _route(ax: _Axis, x: torch.Tensor) -> str:
    """How a point-to-point or all-to-all exchange of ``x`` over ``ax``
    travels: ``"local"`` (one rank, no process group), ``"nccl"``,
    ``"gloo"`` (CPU tensors) or ``"gloo_host"`` (CUDA tensors under gloo,
    staged through host memory). Decided by the group's backend and the
    tensor's device."""
    if ax.group is None:
        return "local"
    if dist.get_backend(ax.group) == "nccl":
        return "nccl"
    return "gloo" if x.device.type == "cpu" else "gloo_host"


def _note_route(op: str, route: str) -> None:
    by = _ROUTES.setdefault(op, {})
    by[route] = by.get(route, 0) + 1


def routes_taken() -> Dict[str, Dict[str, int]]:
    """``{op: {route: calls}}`` of ``ppermute`` and ``all_to_all`` since
    :func:`reset_routes`."""
    return {op: dict(by) for op, by in _ROUTES.items()}


def reset_routes() -> None:
    _ROUTES.clear()


def _wire(x: torch.Tensor, route: str) -> torch.Tensor:
    """``x`` as the exchange sends it: contiguous, on the host for
    ``gloo_host``."""
    x = x.detach().contiguous()
    return x.cpu() if route == "gloo_host" else x


def _wait_all(works, route: str) -> None:
    """Wait for each of ``ppermute``'s ``works``.

    Under gloo the host waits, up to the process group's collective timeout
    (``initialize_distributed(timeout_s=)``); one that does not complete in
    it (a peer that died or hangs) raises
    :class:`~paddle_tpu_torch.resilience.faults.DeviceLostError`, which the
    elastic supervisor classifies as a lost rank. Under NCCL only the
    current stream waits (``synchronize``): a timed ``wait`` would block the
    host until the exchange ends; the bound there is NCCL's watchdog, which
    aborts the communicators after the same timeout
    (``TORCH_NCCL_ASYNC_ERROR_HANDLING=2``, set by ``initialize_distributed``)."""
    if route == "nccl":
        for work in works:
            work.synchronize()
        return
    from paddle_tpu_torch.resilience.faults import DeviceLostError

    timeout_s = mesh_mod.collective_timeout_s()
    lost = DeviceLostError(f"ppermute: a point-to-point exchange did not complete within "
                           f"the collective timeout of {timeout_s} s")
    for work in works:
        try:
            done = work.wait(timeout=datetime.timedelta(seconds=timeout_s))
        except RuntimeError as e:
            if "timed out" not in str(e).lower():
                raise
            raise lost from e
        if done is False:
            raise lost


def _permuted(x, ax, perm) -> torch.Tensor:
    """The value the member at ``src`` sends to this member (``(src, dst)``
    pairs over axis indices); zeros where none is sent to it, as in JAX.
    Each member sends its tensor to its destination and receives from its
    source, point to point."""
    srcs = [s for s, d in perm if d == ax.index]
    dsts = [d for s, d in perm if s == ax.index]
    route = _route(ax, x)
    _note_route("ppermute", route)
    send = _wire(x, route)
    recv = torch.empty_like(send) if srcs else None
    ops = []
    if dsts and dsts[0] != ax.index:
        ops.append(dist.P2POp(dist.isend, send, peer=ax.ranks[dsts[0]], group=ax.group))
    if srcs and srcs[0] != ax.index:
        ops.append(dist.P2POp(dist.irecv, recv, peer=ax.ranks[srcs[0]], group=ax.group))
    if ops:
        _wait_all(dist.batch_isend_irecv(ops), route)
    if not srcs:
        return torch.zeros_like(x)
    if srcs[0] == ax.index:  # sent to itself
        return x.detach().clone()
    return recv.to(x.device)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax, split_axis, concat_axis):
        ctx.ax, ctx.split_axis, ctx.concat_axis = ax, split_axis, concat_axis
        return _exchanged(x, ax, split_axis, concat_axis)

    @staticmethod
    def backward(ctx, g):
        return _exchanged(g, ctx.ax, ctx.concat_axis, ctx.split_axis), None, None, None


def _exchanged(x, ax, split_axis: int, concat_axis: int) -> torch.Tensor:
    """Tiled all-to-all: chunk i of ``x`` on ``split_axis`` goes to axis
    member i; the chunks received are concatenated on ``concat_axis`` in
    the order of their senders."""
    n = ax.size
    route = _route(ax, x)
    _note_route("all_to_all", route)
    if ax.group is None:
        return x.clone()
    chunks = x.detach().chunk(n, dim=split_axis)
    # all_to_all_single exchanges dim-0 slices with the group's members in
    # the order of their global ranks
    order = sorted(range(n), key=lambda i: ax.ranks[i])
    send = _wire(torch.stack([chunks[i] for i in order]), route)
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=ax.group)
    recv = recv.to(x.device)
    parts = [None] * n
    for slot, i in enumerate(order):
        parts[i] = recv[slot]
    return torch.cat(parts, dim=concat_axis)


class _ShardReplicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax, dim):
        ctx.ax, ctx.dim = ax, dim
        k = x.shape[dim] // ax.size
        return x.narrow(dim, ax.index * k, k).contiguous()

    @staticmethod
    def backward(ctx, g):
        return torch.cat(ctx.ax.gather(g), dim=ctx.dim), None, None


class _GatherReplicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax, dim):
        ctx.ax, ctx.dim = ax, dim
        return torch.cat(ax.gather(x), dim=dim)

    @staticmethod
    def backward(ctx, g):
        k = g.shape[ctx.dim] // ctx.ax.size
        return g.narrow(ctx.dim, ctx.ax.index * k, k).contiguous(), None, None


class _CopyToAxis(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax):
        ctx.ax = ax
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.ax.reduce(g), None


class _ReduceFromAxis(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax):
        return ax.reduce(x)

    @staticmethod
    def backward(ctx, g):
        return g, None


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
    ``perm``, point to point; a member no pair sends to receives zeros."""
    ax = _Axis(axis_name)
    return _Permute.apply(x, ax, _check_perm(perm, ax.size))


def all_to_all(x: torch.Tensor, axis_name: str, split_axis: int, concat_axis: int,
               tiled: bool = True) -> torch.Tensor:
    """``jax.lax.all_to_all``: ``x`` split into the axis's size of chunks on
    ``split_axis``, chunk i sent to member i, the received chunks joined on
    ``concat_axis`` in member order. ``tiled=False`` takes a ``split_axis``
    of the axis's size, removes it and stacks the received pieces on a new
    ``concat_axis``. Differentiable: the backward is the inverse exchange."""
    ax = _Axis(axis_name)
    split_axis %= x.dim()
    if not tiled:
        if x.shape[split_axis] != ax.size:
            raise ValueError(f"all_to_all(tiled=False): dim {split_axis} of size "
                             f"{x.shape[split_axis]} is not the axis size {ax.size}")
        y = _AllToAll.apply(x, ax, split_axis, split_axis)
        return torch.movedim(y, split_axis, concat_axis)
    if x.shape[split_axis] % ax.size:
        raise ValueError(f"all_to_all: dim {split_axis} of size {x.shape[split_axis]} does not "
                         f"split over {ax.size}")
    return _AllToAll.apply(x, ax, split_axis, concat_axis % x.dim())


def shard_replicated(x: torch.Tensor, axis_name: str, dim: int) -> torch.Tensor:
    """This member's chunk of ``dim`` of a tensor every member holds whole;
    the backward gathers the chunks' gradients, so each member gets the
    whole gradient (a ``shard_map`` in-spec over a replicated array)."""
    ax = _Axis(axis_name)
    if x.shape[dim] % ax.size:
        raise ValueError(f"shard_replicated: dim {dim} of size {x.shape[dim]} does not split "
                         f"over {ax.size}")
    return _ShardReplicated.apply(x, ax, dim % x.dim())


def gather_replicated(x: torch.Tensor, axis_name: str, dim: int) -> torch.Tensor:
    """Every member's chunk joined on ``dim``, held by every member; the
    backward keeps this member's chunk of the (replicated) gradient (a
    ``shard_map`` out-spec). :func:`shard_replicated` is its inverse."""
    return _GatherReplicated.apply(x, _Axis(axis_name), dim % x.dim())


def copy_to_axis(x: torch.Tensor, axis_name: str) -> torch.Tensor:
    """Identity forward, sum over the axis backward: where a value every
    member holds alike feeds work split over the axis."""
    return _CopyToAxis.apply(x, _Axis(axis_name))


def reduce_from_axis(x: torch.Tensor, axis_name: str) -> torch.Tensor:
    """Sum over the axis forward, identity backward: the conjugate of
    :func:`copy_to_axis`, where the split work's partial results join into
    a value every member holds alike."""
    return _ReduceFromAxis.apply(x, _Axis(axis_name))


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
