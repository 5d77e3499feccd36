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

Elastic re-forming. The JAX package shrinks a mesh inside one process; here
a process group cannot drop a member in place, so the survivors of a lost
rank leave the group and form a new one, the next *generation*
(:func:`reform`): each leaves (``destroy_process_group``), registers its
rank in the initial world at the next generation's rendezvous, waits until
every rank of the old group has registered or been attributed as lost (by
the caller, by a liveness ``probe``, or at a deadline taken from the
collective timeout), and joins the new group, the survivors in the order of
their old ranks. The rendezvous of generation g is ``<path>.<job>.gen<g>``
for a ``file://`` store (``<job>`` is an id drawn for each run of the job,
so a job relaunched on the same path never reads the generations its
earlier run left behind) and, for ``tcp://``/``env://``, a store that the lowest
surviving rank hosts at the coordinator's port + g × the initial world + its
initial rank (the lowest member hosts the next generation's store in
advance). A process that returns joins a
later generation with :func:`join_generation`. A :class:`Mesh` made before
a re-form holds the old group's handles and raises if it is used. On CUDA
the NCCL communicators are aborted on a collective timeout
(``TORCH_NCCL_ASYNC_ERROR_HANDLING=2``), so a dead peer surfaces as an
error instead of a hang.
"""

from __future__ import annotations

import dataclasses
import datetime
import json
import os
import socket
import threading
import time
import uuid
from typing import Callable, Dict, Iterable, List, Optional, Sequence
from urllib.parse import urlparse

import numpy as np
import torch
import torch.distributed as dist

from paddle_tpu_torch.core import logging as ptlog
from paddle_tpu_torch.core.config import resolve_device
from paddle_tpu_torch.core.enforce import EnforceError, enforce

# Canonical axis names (used by layers' default sharding rules)
DATA_AXIS = "data"
MODEL_AXIS = "model"
SEQ_AXIS = "seq"
PIPE_AXIS = "pipe"
EXPERT_AXIS = "expert"
TP_AXIS = "tp"

# how long a collective waits for the other ranks before it fails (the
# default of initialize_distributed's timeout_s)
_TIMEOUT_S = 600.0
# the key of the initial store under which rank 0 publishes the job's id
_JOB_KEY = "paddle_tpu_torch/job"
# the card (or the CPU) of this process once initialize_distributed ran:
# process-wide, as torch.distributed's default group is
_process_device: Optional[torch.device] = None


@dataclasses.dataclass
class _World:
    """What re-forming the process group needs: how it was made, and who
    is in it now. Process-wide, as the default group is."""

    init_method: str
    backend: str
    timeout_s: float
    initial_rank: int  # this process's rank in the initial world
    initial_size: int
    job: str = ""  # this run's id: names the file:// generation stores
    generation: int = 0
    # initial-world ranks of the current generation, in new-rank order
    members: List[int] = dataclasses.field(default_factory=list)
    hosts: Optional[List[str]] = None  # per initial rank (tcp:// rendezvous)
    next_store: object = None  # the next generation's store, hosted here
    # set by join_generation: the new rank to take the training position
    # from (a survivor), until the Trainer reads it (take_join_source)
    join_source: Optional[int] = None


_world: Optional[_World] = None


class EvictedError(RuntimeError):
    """This process is not a member of the re-formed process group: its
    rank was attributed as lost (it leaves), or it reached the rendezvous
    after the survivors closed it."""


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
    timeout_s: float = _TIMEOUT_S,
    job_id: Optional[str] = None,
) -> torch.device:
    """Join the process group (replaces gen_nccl_id_op + NCCLContextMap
    InitRank) and return this rank's device. ``timeout_s`` is how long a
    collective waits for the other ranks before it fails (and the deadline
    of an elastic re-form's rendezvous).

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
    share one card only when the caller names both that card and gloo.

    ``job_id`` names this run's elastic rendezvous files over ``file://``
    (``<path>.<job_id>.gen<g>``); every rank passes the same one, and so
    does a process that returns later (:func:`join_generation`). Without
    it rank 0 draws a fresh id and shares it through the initial store; no
    process can then return over ``file://``."""
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
    dev, backend = _device_backend(device, backend, local_rank, process_id)
    dist.init_process_group(
        backend=backend, init_method=init_method, world_size=int(num_processes),
        rank=int(process_id), timeout=datetime.timedelta(seconds=timeout_s))
    if job_id is None and init_method.startswith("file://"):
        store = dist.distributed_c10d._get_default_store()
        if int(process_id) == 0:
            store.set(_JOB_KEY, uuid.uuid4().hex[:12])
        job_id = store.get(_JOB_KEY).decode()
    global _world
    _world = _World(init_method, backend, float(timeout_s), int(process_id),
                    int(num_processes), job=job_id or "",
                    members=list(range(int(num_processes))))
    _process_device = dev
    ptlog.info("distributed initialized: rank %d/%d on %s over %s",
               dist.get_rank(), dist.get_world_size(), dev, backend)
    return dev


def _device_backend(device, backend, local_rank, process_id):
    """This rank's device (its card selected) and the backend to reach the
    others with."""
    dev = resolve_device("cuda" if device is None else device)
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", local_rank if local_rank is not None else process_id)
        torch.cuda.set_device(dev)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    enforce(backend in ("nccl", "gloo"), f"unknown backend {backend!r} (nccl or gloo)")
    enforce(backend == "gloo" or dev.type == "cuda", "the NCCL backend needs a CUDA device")
    if backend == "nccl":
        # abort the communicators on a collective timeout and raise in the
        # caller (a dead peer otherwise hangs NCCL or tears the process down)
        os.environ.setdefault("TORCH_NCCL_ASYNC_ERROR_HANDLING", "2")
    return dev, backend


def shutdown_distributed() -> None:
    """Leave the process group (a no-op without one)."""
    global _process_device, _world
    if dist.is_initialized():
        dist.destroy_process_group()
    _process_device = None
    _world = None


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


# -- elastic re-forming -------------------------------------------------------
def collective_timeout_s() -> float:
    """How long a collective waits for the other ranks before it fails:
    the ``timeout_s`` the process group was made with (the default
    without one)."""
    return _world.timeout_s if _world is not None else _TIMEOUT_S


def generation() -> int:
    """How many times the process group was re-formed (0 without one)."""
    return _world.generation if _world is not None and dist.is_initialized() else 0


def initial_rank() -> int:
    """This process's rank in the initial world (the elastic supervisor's
    device index); its rank now is :func:`process_rank`."""
    return _world.initial_rank if _world is not None else process_rank()


def initial_world_size() -> int:
    return _world.initial_size if _world is not None else world_size()


def members() -> List[int]:
    """The initial-world ranks of the current generation, in rank order."""
    return list(_world.members) if _world is not None else list(range(world_size()))


def _tcp_address(init_method: str):
    """``(host, port)`` of a ``tcp://`` or ``env://`` rendezvous."""
    if init_method.startswith("env://"):
        return os.environ["MASTER_ADDR"], int(os.environ["MASTER_PORT"])
    u = urlparse(init_method)
    return u.hostname, int(u.port)


def _tcp_store(host: str, port: int, master: bool, timeout_s: float):
    return dist.TCPStore(host, port, is_master=master, wait_for_workers=False,
                         timeout=datetime.timedelta(seconds=timeout_s))


def _store_port(w: "_World", gen: int, host_rank: int) -> int:
    """The port of generation ``gen``'s rendezvous when initial rank
    ``host_rank`` hosts it: one port per (generation, host), so two
    processes on one host never contend for it."""
    return _tcp_address(w.init_method)[1] + gen * w.initial_size + host_rank


def prepare_reform() -> None:
    """Collective, once before a re-form can be needed (every rank calls
    it; the elastic supervisor does when it starts): over ``tcp://`` or
    ``env://``, every rank learns every rank's host, and the lowest member
    hosts the next generation's rendezvous store. A ``file://`` rendezvous
    needs nothing."""
    w = _world
    if w is None or w.init_method.startswith("file://"):
        return
    if w.hosts is None:
        hosts = [None] * world_size()
        dist.all_gather_object(hosts, socket.gethostname())
        w.hosts = [None] * w.initial_size
        for r, h in zip(w.members, hosts):
            w.hosts[r] = h
    _host_next(w)


def _host_next(w: _World) -> None:
    if w.init_method.startswith("file://") or w.hosts is None or w.members[0] != w.initial_rank:
        return
    if w.next_store is not None and w.next_store[0] == w.generation + 1:
        return
    gen = w.generation + 1
    w.next_store = (gen, _tcp_store(w.hosts[w.initial_rank], _store_port(w, gen, w.initial_rank),
                                    True, w.timeout_s))


def _file_store(init_method: str, job: str, gen: int):
    """Generation ``gen``'s ``file://`` rendezvous of run ``job``: a file
    beside the initial store."""
    return dist.FileStore(init_method[len("file://"):] + f".{job}.gen{gen}", -1)


def _generation_store(w: _World, gen: int, candidates: Sequence[int], lost: Iterable[int]):
    """The rendezvous store of generation ``gen``: a file beside the
    initial store, or the TCP store of the lowest candidate that answers
    (this process hosts it when every lower candidate is lost or silent)."""
    if w.init_method.startswith("file://"):
        return _file_store(w.init_method, w.job, gen)
    enforce(w.hosts is not None, "re-form over tcp:// needs prepare_reform() first")
    wait_s = min(30.0, w.timeout_s / 4)
    for c in (r for r in candidates if r not in set(lost)):
        if c == w.initial_rank:
            if w.next_store is not None and w.next_store[0] == gen:
                return w.next_store[1]
            return _tcp_store(w.hosts[c], _store_port(w, gen, c), True, w.timeout_s)
        try:
            return _tcp_store(w.hosts[c], _store_port(w, gen, c), False, wait_s)
        except (RuntimeError, TimeoutError):  # nobody there: the next candidate hosts
            continue
    raise EvictedError(f"no rendezvous for generation {gen}")


def _rendezvous(store, me: int, candidates: Sequence[int], lost: Iterable[int],
                probe: Optional[Callable[[], Iterable[int]]], deadline: float,
                survivors: Sequence[int]) -> dict:
    """Register ``me`` and wait until the member set of this generation is
    closed: every candidate registered or was attributed as lost (``lost``,
    the ``probe``'s dead, or silence at ``deadline``). The first process to
    close it writes the record (``compare_set``), so every process reads
    the same one: ``{"members": [...], "source": the lowest survivor}``."""
    store.set(f"alive/{me}", "1")
    for r in lost:
        store.set(f"lost/{r}", "1")
    next_probe = 0.0
    while not store.check(["members"]):
        pending = [c for c in candidates
                   if not store.check([f"alive/{c}"]) and not store.check([f"lost/{c}"])]
        now = time.monotonic()
        if pending and probe is not None and now >= next_probe:
            alive = set(probe())
            for c in pending:
                if c not in alive:
                    store.set(f"lost/{c}", "1")
            next_probe = now + 0.05
            continue
        if not pending or now > deadline:
            got = [c for c in candidates
                   if store.check([f"alive/{c}"]) and not store.check([f"lost/{c}"])]
            rec = {"members": got, "source": min([c for c in got if c in survivors] or got or [me])}
            store.compare_set("members", "", json.dumps(rec))
            break
        time.sleep(0.005)
    return json.loads(store.get("members"))


def reform(lost: Iterable[int] = (), *, probe: Optional[Callable[[], Iterable[int]]] = None,
           include: Iterable[int] = (), min_members: int = 1) -> dict:
    """Leave the current process group and join generation g+1 over the
    survivors (and ``include``: returning ranks registered there). ``lost``
    and ``probe`` name initial-world ranks: the ranks attributed as lost,
    and a liveness view polled while the rendezvous waits. Raises
    :class:`EvictedError` when this rank is lost (after leaving: a rank
    waiting on it sees the closed connection) or was left out, and
    ``EnforceError`` naming ``elastic`` when fewer than ``min_members``
    survive (no group is formed then). Returns the timings and the new
    member list: ``{"generation", "members", "source", "leave_s",
    "rendezvous_s", "join_s"}``."""
    w = _world
    enforce(w is not None, "reform: no process group was initialized")
    lost = sorted(set(int(r) for r in lost))
    gen = w.generation + 1
    survivors = [r for r in w.members if r not in lost]
    t0 = time.perf_counter()
    if dist.is_initialized():
        dist.destroy_process_group()
    t1 = time.perf_counter()
    if w.initial_rank in lost:
        w.next_store = None  # a store this rank hosts goes with it
        raise EvictedError(f"rank {w.initial_rank} was attributed as lost; it leaves "
                           f"(generation {gen} re-forms over {survivors})")
    candidates = sorted(set(w.members) | set(int(r) for r in include))
    store = _generation_store(w, gen, candidates, lost)
    rec = _rendezvous(store, w.initial_rank, candidates, lost, probe,
                      time.monotonic() + w.timeout_s, survivors)
    t2 = time.perf_counter()
    got = rec["members"]
    if w.initial_rank not in got:
        raise EvictedError(f"rank {w.initial_rank} is not a member of generation {gen} "
                           f"({got}): it reached the rendezvous after it closed")
    enforce(len(got) >= max(1, min_members),
            f"elastic re-form: {len(got)} ranks survive ({got}), fewer than the "
            f"{min_members} required (elastic_min_devices)")
    _join(w, store, gen, got)
    return {"generation": gen, "members": got, "source": rec["source"],
            "leave_s": t1 - t0, "rendezvous_s": t2 - t1, "join_s": time.perf_counter() - t2}


def _join(w: _World, store, gen: int, got: List[int]) -> None:
    dist.init_process_group(
        backend=w.backend, store=dist.PrefixStore("pg", store), rank=got.index(w.initial_rank),
        world_size=len(got), timeout=datetime.timedelta(seconds=w.timeout_s))
    w.generation, w.members = gen, list(got)
    _host_next(w)
    ptlog.info("process group re-formed: generation %d, rank %d/%d (initial rank %d), "
               "members %s", gen, dist.get_rank(), len(got), w.initial_rank, got)


def registered(gen: int, ranks: Iterable[int]) -> List[int]:
    """Which of ``ranks`` (initial-world) have registered at generation
    ``gen``'s rendezvous, waiting to join it: a returning process
    (:func:`join_generation`). Does not wait. Over ``tcp://`` only the
    store's host (the lowest member) can look."""
    w = _world
    if w is None:
        return []
    if w.init_method.startswith("file://"):
        store = _file_store(w.init_method, w.job, gen)
    elif w.next_store is not None and w.next_store[0] == gen:
        store = w.next_store[1]
    else:
        return []
    return [r for r in ranks if store.check([f"alive/{r}"])]


def join_generation(init_method: str, gen: int, rank: int, initial_size: int, *,
                    backend: Optional[str] = None, device=None,
                    local_rank: Optional[int] = None, timeout_s: float = _TIMEOUT_S,
                    job_id: Optional[str] = None) -> torch.device:
    """Join generation ``gen`` of a running group as initial-world rank
    ``rank``: a process that returns after its rank was lost. It registers
    at that generation's rendezvous (``init_method``: the initial
    ``file://`` store, whose ``.<job_id>.gen<g>`` file it reads — the
    ``job_id`` the job's ranks were initialized with — or over ``tcp://``
    the address of the store the lowest member hosts for that generation:
    its host, at the coordinator's port + g × the initial world + its
    initial rank)
    and waits, up to ``timeout_s``, until the members close it (at a
    checkpoint boundary, ``ElasticSupervisor.maybe_regrow``). Returns this
    rank's device; the Trainer then takes its training position from a
    survivor (:func:`take_join_source`)."""
    global _world, _process_device
    enforce(not dist.is_initialized(), "join_generation: a process group already exists")
    dev, backend = _device_backend(device, backend, local_rank, rank)
    if init_method.startswith("file://"):
        enforce(bool(job_id), "join_generation over file:// needs the job_id its ranks were "
                              "initialized with (initialize_distributed(job_id=))")
        store = _file_store(init_method, job_id, gen)
    else:
        host, port = _tcp_address(init_method)
        store = _tcp_store(host, port, False, timeout_s)
    store.set(f"alive/{rank}", "1")
    deadline = time.monotonic() + timeout_s
    while not store.check(["members"]):
        if time.monotonic() > deadline:
            raise EvictedError(f"join_generation: generation {gen} did not close within "
                               f"{timeout_s} s")
        time.sleep(0.01)
    rec = json.loads(store.get("members"))
    if rank not in rec["members"]:
        raise EvictedError(f"rank {rank} is not a member of generation {gen} ({rec['members']})")
    w = _World(init_method, backend, float(timeout_s), int(rank), int(initial_size),
               job=job_id or "")
    _join(w, store, gen, rec["members"])
    w.join_source = rec["members"].index(rec["source"])
    _world = w
    _process_device = dev
    return dev


def take_join_source() -> Optional[int]:
    """Once after :func:`join_generation`: the rank (in the new group) of
    the survivor that hands this process its training position; None for
    a process that did not join late."""
    if _world is None or _world.join_source is None:
        return None
    src, _world.join_source = _world.join_source, None
    return src


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
        # the process-group generation whose handles _groups holds
        self._generation: Optional[int] = None
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
        self._generation = generation()
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
        self._check_generation()
        if self.shape[axis] == 1 and not dist.is_initialized():
            return None
        enforce(dist.is_initialized(),
                f"mesh axis {axis!r} of size {self.shape[axis]} needs an initialized "
                "process group (initialize_distributed)")
        enforce(axis in self._groups,
                f"rank {dist.get_rank()} is not a member of this mesh's axis {axis!r}")
        return self._groups[axis]

    def _check_generation(self) -> None:
        """A mesh made before the process group was re-formed holds the
        old group's handles (and ranks): using it raises."""
        if self._generation is not None and (not dist.is_initialized()
                                             or self._generation != generation()):
            raise EnforceError(
                f"this Mesh was built over the process group of generation "
                f"{self._generation}, which was re-formed since (now generation "
                f"{generation()}): rebuild it over the new group (remesh, or "
                "DataParallel.resize)")

    def axis_ranks(self, axis: str) -> list:
        """The global ranks of this rank's group on ``axis``, in axis
        order (``torch.distributed`` orders a group's members by global
        rank; collectives reorder to this)."""
        self.group(axis)
        return self._members[axis]

    def axis_index(self, axis: str) -> int:
        """This rank's coordinate on ``axis`` (0 on a one-rank mesh)."""
        self._check_generation()
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
