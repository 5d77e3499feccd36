"""Sharding rules — port of ``paddle_tpu/parallel/sharding.py``.

Reference mapping: MultiDevSSAGraphBuilder replicated params everywhere and
all-reduced gradients (``multi_devices_graph_pass.cc:397-435``). The spec
arithmetic (``spec_for``, ``mesh_axis_sizes``, ``degraded_dims``,
``degrade_spec``) is the JAX package's, whole.

Placement is read from each parameter's spec, as GSPMD reads it: every
parameter and state entry is replicated — a broadcast from the first rank
of each mesh axis (``BCastParamsToDevices``) — except on the dims its spec
splits over an axis of size > 1, where each rank keeps its block. A dim's
entry is an axis or a tuple of axes; a rank's block of a tuple is the one
at its coordinates taken row-major over the axes as listed (the JAX
device order). The blocks are of two kinds (:func:`split_blocks`):

- held: ``expert`` on dim 0 (the mixture-of-experts weights,
  ``parallel/moe.py``) and ``model`` on any dim (Megatron's column- and
  row-parallel weights, ``models/transformer.py::_proj``). The layers
  consume these blocks as they are;
- stored: any other axis, or a tuple of axes on one dim (FSDP-like). A
  rank keeps only its block at rest; ``DataParallel`` gathers it whole
  for the step (:func:`gather_blocks`) and updates its block.

A dim that the axes' size does not divide stays whole (the JAX package's
degradation), and so does an axis the mesh does not have.
"""

from __future__ import annotations

import fnmatch
import math
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from paddle_tpu_torch.core.enforce import enforce
from paddle_tpu_torch.framework import ParamInfo, Variables
from paddle_tpu_torch.parallel.mesh import DATA_AXIS, EXPERT_AXIS, MODEL_AXIS, Mesh, local_shape

# why a sharded dim was dropped to replicated (degraded_dims reasons)
MISSING_AXIS = "missing-axis"
NON_DIVISIBLE = "non-divisible"


class P(tuple):
    """A PartitionSpec: one entry per dim, each a mesh-axis name, a tuple
    of names, or None (``jax.sharding.PartitionSpec``)."""

    def __new__(cls, *dims):
        return super().__new__(cls, dims)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


# A rule table: ordered (glob-pattern, PartitionSpec) pairs, first match wins.
ShardingRules = Sequence[Tuple[str, P]]


class NamedSharding:
    """A spec over a mesh (``jax.sharding.NamedSharding``)."""

    def __init__(self, mesh: Mesh, spec: P):
        self.mesh = mesh
        self.spec = P(*spec)

    def __repr__(self) -> str:
        return f"NamedSharding({self.mesh!r}, {self.spec!r})"


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def spec_for(
    param_name: str,
    rules: ShardingRules,
    *,
    ndim: Optional[int] = None,
    fallback: P = P(),
) -> P:
    """Look up the PartitionSpec for ``param_name`` in an ordered rule table
    of ``(glob_pattern, PartitionSpec)`` pairs — first match wins, unknown
    params fall back to ``fallback`` (replicated by default). When ``ndim``
    is given, a matched spec naming more dims than the param has rank is an
    EnforceError."""
    for pattern, spec in rules:
        if fnmatch.fnmatchcase(param_name, pattern):
            if ndim is not None:
                enforce(
                    len(spec) <= ndim,
                    f"spec_for({param_name!r}): rule {pattern!r} names "
                    f"{len(spec)} dims but param has rank {ndim}",
                )
            return spec
    return fallback


def mesh_axis_sizes(mesh: Mesh) -> Dict[str, int]:
    """``{axis_name: size}`` for a mesh."""
    return dict(mesh.shape)


def degraded_dims(
    axis_sizes: Mapping[str, int], spec: P, shape: Tuple[int, ...]
) -> List[Tuple[int, str, str]]:
    """Which sharded dims :func:`degrade_spec` would drop to replicated, as
    ``(dim_index, axis_name, reason)`` — ``MISSING_AXIS`` or
    ``NON_DIVISIBLE``. A pure function of the mesh's axis sizes."""
    dims = tuple(spec) + (None,) * max(0, len(shape) - len(spec))
    out: List[Tuple[int, str, str]] = []
    for i, (dim_size, axis) in enumerate(zip(shape, dims)):
        if axis is None:
            continue
        n = axis_sizes.get(axis)
        if n is None:
            out.append((i, axis, MISSING_AXIS))
        elif dim_size % n != 0:
            out.append((i, axis, NON_DIVISIBLE))
    return out


def degrade_spec(
    mesh: Mesh,
    spec: P,
    shape: Tuple[int, ...],
    *,
    name: Optional[str] = None,
    quiet: bool = False,
) -> P:
    """Per-dim degradation to replicated: drop a sharded dim when its mesh
    axis is missing or its size doesn't divide the dim; the spec is
    right-padded with None to the array rank. A NON-DIVISIBLE drop logs a
    ``warn_once`` per (param, axis) and counts ``sharding.degraded_total``
    unless ``quiet``; a missing axis stays silent (the documented fallback
    that lets one model definition run on any mesh shape)."""
    axis_sizes = mesh_axis_sizes(mesh)
    dropped = degraded_dims(axis_sizes, spec, shape)
    if not quiet:
        from paddle_tpu_torch.core import logging as ptlog
        from paddle_tpu_torch.core import profiler as prof

        label = name or "<unnamed>"
        for dim, axis, reason in dropped:
            if reason != NON_DIVISIBLE:
                continue
            prof.inc_counter("sharding.degraded_total",
                             labels={"param": label, "axis": axis})
            ptlog.warn_once(
                ("sharding.degrade", label, axis, dim),
                "sharding: dim %d (size %d) of %s is not divisible by mesh "
                "axis %r (size %d) — degrading to replicated, losing the "
                "per-device memory split on that dim",
                dim, shape[dim], label, axis, axis_sizes[axis],
            )
    drop = {i for i, _, _ in dropped}
    dims = tuple(spec) + (None,) * max(0, len(shape) - len(spec))
    return P(*(None if i in drop else axis for i, axis in enumerate(dims[: len(shape)])))


def batch_sharding(mesh: Mesh, axis: str = DATA_AXIS, ndim: int = 2) -> NamedSharding:
    """Shard the leading (batch) dim over ``axis``."""
    return NamedSharding(mesh, P(axis, *([None] * (ndim - 1))))


def spec_axes(entry) -> Tuple[str, ...]:
    """The axes one spec entry splits its dim over: ``()`` for None, the
    names of a tuple in order."""
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


def block_dims(sharding: NamedSharding) -> List[Tuple[int, object]]:
    """``(dim, entry)`` of each dim the spec splits over axes of size > 1:
    the dims of a parameter that each rank holds a block of, the entry the
    axis (or the tuple of axes, those of size 1 left out) it is split over;
    empty when replicated."""
    out = []
    for dim, entry in enumerate(sharding.spec):
        axes = tuple(a for a in spec_axes(entry) if sharding.mesh.shape.get(a, 1) > 1)
        if axes:
            out.append((dim, axes if isinstance(entry, tuple) else axes[0]))
    return out


def is_held(dim: int, entry) -> bool:
    """Whether a block split on ``dim`` over ``entry`` is one the layers
    consume as it is (experts over ``expert`` on dim 0, a ``model`` split),
    rather than a stored one that the step gathers whole."""
    return entry == MODEL_AXIS or (entry == EXPERT_AXIS and dim == 0)


def split_blocks(shardings: Mapping[str, NamedSharding]):
    """``(held, stored)``: ``{name: [(dim, entry), ...]}`` of the dims of
    each parameter that this rank holds a block of, by kind
    (:func:`is_held`); a parameter may have dims of both."""
    held, stored = {}, {}
    for name, sh in shardings.items():
        for dim, entry in block_dims(sh):
            (held if is_held(dim, entry) else stored).setdefault(name, []).append((dim, entry))
    return held, stored


def block_axes(dims: Sequence[Tuple[int, object]]) -> Tuple[str, ...]:
    """Every axis a block of ``dims`` is split over, each once."""
    return tuple(dict.fromkeys(a for _, e in dims for a in spec_axes(e)))


def _coord(entry, mesh: Mesh) -> Tuple[int, int]:
    """``(index, count)`` of this rank's block of a dim split over
    ``entry``: row-major over the axes as listed."""
    i, n = 0, 1
    for a in spec_axes(entry):
        i = i * mesh.shape[a] + mesh.axis_index(a)
        n *= mesh.shape[a]
    return i, n


def block_window(shape: Sequence[int], dims: Sequence[Tuple[int, object]], mesh: Mesh):
    """This rank's window ``((start, stop), ...)`` of a parameter of whole
    ``shape`` split on ``dims`` (:func:`block_dims`)."""
    window = [(0, int(s)) for s in shape]
    for dim, entry in dims:
        i, n = _coord(entry, mesh)
        k = int(shape[dim]) // n
        window[dim] = (i * k, (i + 1) * k)
    return tuple(window)


def cut_block(t: torch.Tensor, dims: Sequence[Tuple[int, object]], mesh: Mesh) -> torch.Tensor:
    """This rank's block of a whole tensor split on ``dims``."""
    for dim, (a, b) in enumerate(block_window(t.shape, dims, mesh)):
        if (a, b) != (0, t.shape[dim]):
            t = t.narrow(dim, a, b - a)
    return t.clone()


def gather_blocks(tensors: Mapping[str, torch.Tensor],
                  dims: Mapping[str, Sequence[Tuple[int, object]]],
                  mesh: Mesh) -> Dict[str, torch.Tensor]:
    """The whole tensors of the blocks ``tensors`` split on ``dims`` (a
    collective: every rank calls it): per axis, the innermost of a tuple
    first, one all-gather of a flat buffer per dtype holding every block
    split over it. No gradient."""
    from paddle_tpu_torch.parallel import collective

    out = dict(tensors)
    # the (dim, axis) gathers each tensor still needs, innermost axis first
    todo = {k: [(d, a) for d, e in dims[k] for a in reversed(spec_axes(e))] for k in tensors}
    with torch.no_grad(), mesh:
        while any(todo.values()):
            level: Dict[Tuple[str, torch.dtype], List[str]] = {}
            for k, steps in todo.items():
                if steps:
                    level.setdefault((steps[0][1], out[k].dtype), []).append(k)
            for (axis, _), names in level.items():
                flat = torch.cat([out[k].reshape(-1) for k in names])
                parts = collective.all_gather(flat, axis, axis=0, tiled=False)
                off = 0
                for k in names:
                    t, dim = out[k], todo[k].pop(0)[0]
                    out[k] = torch.cat([parts[r, off:off + t.numel()].view(t.shape)
                                        for r in range(parts.shape[0])], dim=dim)
                    off += t.numel()
    return out


def param_shardings(
    mesh: Mesh,
    param_info: Dict[str, ParamInfo],
    params: Dict[str, torch.Tensor],
) -> Dict[str, NamedSharding]:
    """Per-parameter shardings: honor ParamAttr.sharding tuples; default
    replicated. Axes not present in the mesh degrade to None (a tp spec on a
    dp-only mesh is replicated; of a tuple entry, the axes the mesh lacks
    are left out), and so does a dim the axes' size does not divide
    (:func:`degrade_spec`, against the parameter's whole shape)."""
    out = {}
    mesh_axes = set(mesh.axis_names)
    for name, p in params.items():
        info = param_info.get(name)
        spec = None
        if info is not None and info.sharding is not None:
            dims = tuple((tuple(a for a in e if a in mesh_axes) or None)
                         if isinstance(e, tuple) else e if e in mesh_axes else None
                         for e in info.sharding)
            dims = tuple(dims[: p.dim()]) + (None,) * max(0, p.dim() - len(dims))
            # degrade_spec reads one axis a dim; a tuple's size is its product
            single = P(*(None if isinstance(e, tuple) else e for e in dims))
            spec = list(degrade_spec(mesh, single, info.shape, name=name, quiet=True))
            for i, e in enumerate(dims):
                if isinstance(e, tuple) and info.shape[i] % math.prod(
                        mesh.shape[a] for a in e) == 0:
                    spec[i] = e
            spec = P(*spec)
        out[name] = NamedSharding(mesh, spec if spec is not None else P())
    return out


def broadcast_tensors(tensors: Sequence[torch.Tensor], mesh: Mesh,
                      axis: str = DATA_AXIS) -> List[torch.Tensor]:
    """The first rank's values of ``tensors`` on every rank of ``axis``:
    one broadcast per dtype of a flat buffer holding them all. Identities
    on an axis of size 1."""
    group = mesh.group(axis) if axis in mesh.shape else None
    if group is None:
        return list(tensors)
    src = mesh.axis_ranks(axis)[0]
    out: List[Optional[torch.Tensor]] = [None] * len(tensors)
    by_dtype: Dict[torch.dtype, List[int]] = {}
    for i, t in enumerate(tensors):
        by_dtype.setdefault(t.dtype, []).append(i)
    for idx in by_dtype.values():
        flat = torch.cat([tensors[i].detach().reshape(-1) for i in idx])
        dist.broadcast(flat, src=src, group=group)
        off = 0
        for i in idx:
            n = tensors[i].numel()
            out[i] = flat[off:off + n].view_as(tensors[i])
            off += n
    return out


def shard_variables(
    mesh: Mesh,
    variables: Variables,
    param_info: Dict[str, ParamInfo],
) -> Variables:
    """Place a Variables tree on the mesh (BCastParamsToDevices parity,
    reference parallel_executor.cc:249): every rank takes the first rank's
    values — a broadcast over each axis in turn — and of a parameter split
    over axes of size > 1 (held or stored) keeps its block (a parameter
    that is already its block is not broadcast over the axes it is split
    on)."""
    shardings = param_shardings(mesh, param_info, variables.params)
    names = [("p", k) for k in variables.params] + [("s", k) for k in variables.state]
    values = {n: variables.params[n[1]] if n[0] == "p" else variables.state[n[1]] for n in names}
    split = {k: block_dims(sh) for k, sh in shardings.items() if block_dims(sh)}

    def is_block(n):
        if n[0] != "p" or n[1] not in split:
            return False
        info = param_info[n[1]]
        return tuple(values[n].shape) == local_shape(info.shape, info.sharding, mesh) \
            != tuple(info.shape)

    for axis in mesh.axis_names:
        if axis != DATA_AXIS and mesh.shape[axis] == 1:
            continue
        todo = [n for n in names if not (is_block(n) and axis in block_axes(split[n[1]]))]
        for n, t in zip(todo, broadcast_tensors([values[n] for n in todo], mesh, axis)):
            values[n] = t
    for name, dims in split.items():
        n = ("p", name)
        if not is_block(n):
            values[n] = cut_block(values[n], dims, mesh)
    return Variables(params={k: values[("p", k)] for k in variables.params},
                     state={k: values[("s", k)] for k in variables.state})


class LeafLayout:
    """Where one leaf of a training state lives on this rank — the port's
    ``jax.ShapeDtypeStruct`` with a ``.sharding``: the global ``shape`` and
    ``dtype``, this rank's ``device``, the global ``window`` it holds
    (``(start, stop)`` per dim) and whether it is the ``owner`` that writes
    that block to a sharded checkpoint (JAX's ``replica_id == 0``)."""

    def __init__(self, shape, dtype: torch.dtype, device, window=None, owner: bool = True):
        self.shape = tuple(int(s) for s in shape)
        self.dtype = dtype
        self.device = torch.device(device)
        self.window = tuple((0, s) for s in self.shape) if window is None else tuple(
            (int(a), int(b)) for a, b in window)
        self.owner = bool(owner)

    @property
    def local_shape(self) -> Tuple[int, ...]:
        return tuple(b - a for a, b in self.window)

    def __repr__(self) -> str:
        return (f"LeafLayout(shape={self.shape}, dtype={self.dtype}, window={self.window}, "
                f"owner={self.owner})")
