"""Rank meshes and process-group initialization — port of
``paddle_tpu/parallel/mesh.py``.

Reference: ``platform/nccl_helper.h:81-126`` (NCCLContextMap: per-device
communicators, ncclCommInitRank multi-node) and the env-var cluster wiring
(``trainer.py:229-295`` PADDLE_TRAINER_ID etc.).

One rank is one process on one card. This is where the port differs from
the JAX package, whose one process per host drives every local device of a
single-controller program: here ``torch.distributed`` runs one process per
card (``torchrun --nproc-per-node=N``, or :func:`paddle_tpu_torch.parallel.launch.spawn`),
and a :class:`Mesh` lays global ranks out on named axes exactly as JAX lays
out devices (the last axis varies fastest). Each axis of size > 1 owns the
process group its collectives run over (NCCL on CUDA, gloo on the CPU).
Without an initialized process group, :func:`default_mesh` is this
process's one-rank mesh and its collectives are identities — JAX's
``default_mesh()`` over one device.
"""

from __future__ import annotations

import datetime
import os
import threading
from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from paddle_tpu_torch.core import logging as ptlog
from paddle_tpu_torch.core.config import resolve_device
from paddle_tpu_torch.core.enforce import enforce

# Canonical axis names (used by layers' default sharding rules)
DATA_AXIS = "data"
MODEL_AXIS = "model"
SEQ_AXIS = "seq"
PIPE_AXIS = "pipe"
EXPERT_AXIS = "expert"
TP_AXIS = "tp"

# how long a collective waits for the other ranks before it fails
_TIMEOUT_S = 600.0
# the card (or the CPU) of this process once initialize_distributed ran:
# process-wide, as torch.distributed's default group is
_process_device: Optional[torch.device] = None


def _env_int(name: str) -> Optional[int]:
    v = os.environ.get(name)
    return int(v) if v is not None else None


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    *,
    init_method: Optional[str] = None,
    backend: Optional[str] = None,
    device=None,
    local_rank: Optional[int] = None,
) -> torch.device:
    """Join the process group (replaces gen_nccl_id_op + NCCLContextMap
    InitRank) and return this rank's device.

    Explicit arguments win; then torchrun's ``RANK``/``WORLD_SIZE``/
    ``LOCAL_RANK``/``MASTER_ADDR``; then the reference's ``PADDLE_*``
    contract (``PADDLE_COORDINATOR_ADDR``, ``PADDLE_TRAINERS``,
    ``PADDLE_TRAINER_ID``). ``init_method`` (``file://`` for a store on a
    shared file system — what the tests use, no TCP port — or
    ``tcp://host:port``) overrides the address.

    ``device`` defaults to CUDA: the rank takes ``cuda:LOCAL_RANK``
    (``torch.cuda.set_device`` before the group is made) and the backend is
    NCCL; it raises without CUDA. Gloo runs only when the caller asks for
    the CPU (``device="cpu"``) or names ``backend="gloo"``; two ranks may
    share one card only when the caller names both that card and gloo."""
    global _process_device
    enforce(not dist.is_initialized(), "initialize_distributed: a process group already exists")
    if process_id is None:
        process_id = _env_int("RANK")
    if process_id is None:
        process_id = _env_int("PADDLE_TRAINER_ID")
    if num_processes is None:
        num_processes = _env_int("WORLD_SIZE")
    if num_processes is None:
        num_processes = _env_int("PADDLE_TRAINERS")
    if local_rank is None:
        local_rank = _env_int("LOCAL_RANK")
    if init_method is None:
        coordinator_address = coordinator_address or os.environ.get("PADDLE_COORDINATOR_ADDR")
        if coordinator_address is not None:
            init_method = f"tcp://{coordinator_address}"
        elif os.environ.get("MASTER_ADDR"):
            init_method = "env://"
    enforce(init_method is not None,
            "initialize_distributed: no address (pass init_method=, set MASTER_ADDR as "
            "torchrun does, or PADDLE_COORDINATOR_ADDR)")
    enforce(num_processes is not None and process_id is not None,
            "initialize_distributed: the world size and this process's rank are unknown "
            "(pass num_processes= and process_id=, or set WORLD_SIZE/RANK)")
    dev = resolve_device("cuda" if device is None else device)
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", local_rank if local_rank is not None else process_id)
        torch.cuda.set_device(dev)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    enforce(backend in ("nccl", "gloo"), f"unknown backend {backend!r} (nccl or gloo)")
    enforce(backend == "gloo" or dev.type == "cuda", "the NCCL backend needs a CUDA device")
    dist.init_process_group(
        backend=backend, init_method=init_method, world_size=int(num_processes),
        rank=int(process_id), timeout=datetime.timedelta(seconds=_TIMEOUT_S))
    _process_device = dev
    ptlog.info("distributed initialized: rank %d/%d on %s over %s",
               dist.get_rank(), dist.get_world_size(), dev, backend)
    return dev


def shutdown_distributed() -> None:
    """Leave the process group (a no-op without one)."""
    global _process_device
    if dist.is_initialized():
        dist.destroy_process_group()
    _process_device = None


def process_device() -> Optional[torch.device]:
    """This rank's device, or None when no process group was initialized."""
    return _process_device if dist.is_initialized() else None


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def barrier() -> None:
    """Every rank of the world reaches this point before any goes on (a
    no-op on one rank; NCCL's barrier runs on this rank's card)."""
    if world_size() > 1:
        if dist.get_backend() == "nccl":
            dist.barrier(device_ids=[torch.cuda.current_device()])
        else:
            dist.barrier()


_current = threading.local()


class Mesh:
    """Global ranks laid out on named axes (``jax.sharding.Mesh`` with
    ranks for devices). ``devices`` is the rank array, ``shape`` maps axis
    → size. ``with mesh:`` makes it the mesh that collectives resolve axis
    names against (as JAX's ``with mesh:``)."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str], *, local: bool = False):
        self.devices = np.asarray(devices)
        self.axis_names = tuple(axis_names)
        self.shape: Dict[str, int] = {
            n: int(s) for n, s in zip(self.axis_names, self.devices.shape)}
        self._groups: Dict[str, Optional[object]] = {}
        # this rank's fellow members of each axis, in axis order
        self._members: Dict[str, list] = {}
        # a local mesh lays out this process's own devices (a serving
        # replica group's members): it owns no process group
        self.local = local
        if not local:
            self._make_groups()

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def _axis_members(self, axis: str):
        """Every group of ranks that differ only in ``axis``."""
        i = self.axis_names.index(axis)
        moved = np.moveaxis(self.devices, i, -1).reshape(-1, self.shape[axis])
        return [[int(r) for r in row] for row in moved]

    def _make_groups(self) -> None:
        """The process group of each axis, once a process group exists (an
        axis of one rank too: a data-parallel step at one rank still runs
        its all-reduce). Creating a subgroup is collective (every rank of
        the world makes the same calls in the same order), as building a
        mesh is in JAX's SPMD programs; an axis that spans the whole world
        uses the default group."""
        if not dist.is_initialized():
            return
        world = dist.get_world_size()
        enforce(all(0 <= int(r) < world for r in self.devices.flat),
                f"mesh ranks {self.devices.ravel().tolist()} outside the world of {world}")
        me = dist.get_rank()
        for axis in self.axis_names:
            members = self._axis_members(axis)
            for m in members:
                if me in m:
                    self._members[axis] = m
            if len(members) == 1 and sorted(members[0]) == list(range(world)) \
                    and members[0] == sorted(members[0]):
                self._groups[axis] = dist.group.WORLD
                continue
            covered = {r for m in members for r in m}
            lists = members + [[r] for r in range(world) if r not in covered]
            mine, _ = dist.new_subgroups_by_enumeration(lists)
            if any(me in m for m in members):
                self._groups[axis] = mine

    def group(self, axis: str):
        """The process group of ``axis`` for this rank; None for an axis of
        one rank without a process group (its collectives are identities)."""
        enforce(axis in self.shape, f"axis {axis!r} not in mesh axes {self.axis_names}")
        if self.shape[axis] == 1 and not dist.is_initialized():
            return None
        enforce(dist.is_initialized(),
                f"mesh axis {axis!r} of size {self.shape[axis]} needs an initialized "
                "process group (initialize_distributed)")
        enforce(axis in self._groups,
                f"rank {dist.get_rank()} is not a member of this mesh's axis {axis!r}")
        return self._groups[axis]

    def axis_ranks(self, axis: str) -> list:
        """The global ranks of this rank's group on ``axis``, in axis
        order (``torch.distributed`` orders a group's members by global
        rank; collectives reorder to this)."""
        self.group(axis)
        return self._members[axis]

    def axis_index(self, axis: str) -> int:
        """This rank's coordinate on ``axis`` (0 on a one-rank mesh)."""
        pos = np.argwhere(self.devices == process_rank())
        enforce(len(pos) == 1, f"rank {process_rank()} is not in this mesh")
        return int(pos[0][self.axis_names.index(axis)])

    def __enter__(self) -> "Mesh":
        stack = getattr(_current, "stack", None)
        if stack is None:
            stack = _current.stack = []
        stack.append(self)
        return self

    def __exit__(self, *exc) -> None:
        _current.stack.pop()

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, ranks={self.devices.ravel().tolist()})"


def current_mesh() -> Mesh:
    """The innermost ``with mesh:``, else :func:`default_mesh`."""
    stack = getattr(_current, "stack", None)
    return stack[-1] if stack else default_mesh()


def entered_mesh() -> Optional[Mesh]:
    """The innermost ``with mesh:``, or None outside one (no default mesh
    is built: building one makes process groups, a collective)."""
    stack = getattr(_current, "stack", None)
    return stack[-1] if stack else None


def local_shape(shape: Sequence[int], sharding, mesh: Optional[Mesh]) -> tuple:
    """The block of a parameter of global ``shape`` that a rank holds under
    ``sharding`` (a ParamAttr sharding tuple) on ``mesh``: each dim named
    with mesh axes (one, or a tuple: the product of their sizes; axes the
    mesh lacks left out) of size n > 1 that n divides, cut n ways."""
    out = []
    for i, size in enumerate(shape):
        entry = sharding[i] if sharding is not None and i < len(sharding) else None
        axes = () if entry is None else entry if isinstance(entry, tuple) else (entry,)
        n = int(np.prod([mesh.shape.get(a, 1) for a in axes])) if mesh is not None else 1
        out.append(size // n if n > 1 and size % n == 0 else size)
    return tuple(out)


def make_mesh(axes: Optional[Dict[str, int]] = None, devices=None, **axis_sizes: int) -> Mesh:
    """Build a Mesh from axis name → size over global ranks. Use -1 for one
    axis to absorb all remaining ranks. Example: ``make_mesh(data=-1)`` or
    ``make_mesh(data=2, model=4)``. ``devices`` is a list of ranks (default:
    every rank of the world, or ``[0]`` without a process group); the LAST
    mesh axis varies fastest, as in the JAX package."""
    sizes = dict(axes or {})
    sizes.update(axis_sizes)
    enforce(sizes, "make_mesh needs at least one axis")
    devices = list(devices if devices is not None else range(world_size()))
    n = len(devices)
    unknown = [k for k, v in sizes.items() if v == -1]
    enforce(len(unknown) <= 1, "only one axis may be -1")
    known = int(np.prod([v for v in sizes.values() if v != -1]))
    if unknown:
        enforce(n % known == 0, f"{n} devices not divisible by {known}")
        sizes[unknown[0]] = n // known
    total = int(np.prod(list(sizes.values())))
    enforce(
        total == n,
        f"mesh wants {total} devices ({sizes}) but {n} are available",
    )
    arr = np.array(devices, dtype=np.int64).reshape(tuple(sizes.values()))
    return Mesh(arr, tuple(sizes.keys()))


def default_mesh() -> Mesh:
    """Every rank on a single data axis (pure DP — the reference
    ParallelExecutor default)."""
    return make_mesh({DATA_AXIS: -1})


def tp_submesh(devices: Sequence) -> Mesh:
    """A single-axis ``tp`` mesh over an explicit ordered member tuple — the
    program scope of one serving replica group. The members are devices
    that this process drives (``torch.device``\\ s, which may repeat: four
    members on one card), so the mesh lays out member indices ``0..n-1``
    and owns no process group. Member ORDER is the caller's contract."""
    devices = list(devices)
    enforce(devices, "tp_submesh needs at least one device")
    return Mesh(np.arange(len(devices), dtype=np.int64), (TP_AXIS,), local=True)


def partition_devices(tp: int, devices: Optional[Sequence] = None):
    """Slice a device list (member devices, or ranks) into contiguous
    groups of ``tp``. Leftover devices that don't fill a group are dropped —
    returns a list of tuples. Without ``devices``: every rank of the world."""
    devices = list(devices if devices is not None else range(world_size()))
    enforce(tp >= 1, f"partition_devices: tp must be >= 1, got {tp}")
    return [
        tuple(devices[i : i + tp])
        for i in range(0, len(devices) - tp + 1, tp)
    ]


def remesh(mesh: Mesh, devices: Sequence, resize_axis: str = DATA_AXIS) -> Mesh:
    """Rebuild ``mesh`` over a different rank set: every axis keeps its
    size except ``resize_axis``, which absorbs the new count. Axis ORDER is
    preserved. The non-resized axes' product must divide the new count."""
    sizes = dict(mesh.shape)
    enforce(
        resize_axis in sizes,
        f"remesh: axis {resize_axis!r} not in mesh axes {tuple(sizes)}",
    )
    sizes[resize_axis] = -1
    return make_mesh(sizes, devices=devices)
