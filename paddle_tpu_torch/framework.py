"""Program/parameter framework — port of ``paddle_tpu/framework.py``.

A model is a plain Python function that calls layer functions; :func:`build`
wraps it into a :class:`Model` with ``init`` (create the named parameters)
and ``apply`` (run against given parameters). Parameters are named tensors
in a flat dict; ``name_scope`` gives them the JAX package's hierarchical
names byte for byte — the names are the parity contract between the two
packages (checkpoints and the tests address parameters by name).

PyTorch runs eagerly, so ``init`` runs the function once and keeps the
tensors it created, and ``apply`` runs it again reading them. Mutable
non-trainable state (BatchNorm's moving statistics) lives in
``Variables.state``, a second flat dict of named tensors:
:func:`create_state` creates an entry at init and reads it at apply,
:func:`update_state` records its new value, and ``apply`` returns the
given state with the recorded values merged in. State names follow the
parameters' scopes, byte for byte the JAX package's. Randomness in a
training-mode apply (dropout) draws from the ``torch.Generator`` given as
``rng`` (:func:`next_rng`). :func:`checkpoint` rematerializes a block of
layers in the backward pass (``jax.checkpoint``), replaying its names and
random draws.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple, Union

import torch

from paddle_tpu_torch.core import dtypes as dtypes_mod
from paddle_tpu_torch.core import logging as ptlog
from paddle_tpu_torch.core import unique_name
from paddle_tpu_torch.core.config import flags, resolve_device
from paddle_tpu_torch.core.enforce import EnforceError


class ParamAttr:
    """Per-parameter attributes (reference ``python/paddle/fluid/param_attr.py``):
    name, initializer, regularizer, trainable, learning-rate multiplier and a
    logical sharding spec (tuple of mesh-axis names or None per dim)."""

    def __init__(
        self,
        name: Optional[str] = None,
        initializer=None,
        regularizer=None,
        trainable: bool = True,
        learning_rate: float = 1.0,
        sharding: Optional[Tuple[Optional[str], ...]] = None,
    ):
        self.name = name
        self.initializer = initializer
        self.regularizer = regularizer
        self.trainable = trainable
        self.learning_rate = learning_rate
        self.sharding = sharding

    @staticmethod
    def to_attr(attr: Union["ParamAttr", str, bool, None]) -> "ParamAttr":
        if isinstance(attr, ParamAttr):
            return attr
        if isinstance(attr, str):
            return ParamAttr(name=attr)
        if attr is False:
            return ParamAttr(trainable=False)
        return ParamAttr()


@dataclasses.dataclass
class ParamInfo:
    """Static metadata recorded at creation time for each parameter."""

    name: str
    shape: Tuple[int, ...]
    dtype: torch.dtype
    trainable: bool = True
    learning_rate: float = 1.0
    regularizer: Any = None
    sharding: Optional[Tuple[Optional[str], ...]] = None


class Variables(NamedTuple):
    """The full variable set of a model: trainable params + mutable state."""

    params: Dict[str, torch.Tensor]
    state: Dict[str, torch.Tensor]


class _Frame:
    def __init__(self, mode: str, params, device: torch.device, generator, is_train: bool,
                 state=None):
        assert mode in ("init", "apply")
        self.mode = mode
        self.params: Dict[str, torch.Tensor] = params
        self.state: Dict[str, torch.Tensor] = {} if state is None else state
        self.new_state: Dict[str, torch.Tensor] = {}
        self.param_info: Dict[str, ParamInfo] = {}
        self.device = device
        self.generator: Optional[torch.Generator] = generator
        self.is_train = is_train
        self.name_stack: list[str] = []
        self.names = unique_name.Generator()
        # the whole parameters' records (the init's) where a run under an
        # entered mesh may hold blocks of them (tensor parallelism)
        self.whole: Dict[str, "ParamInfo"] = {}
        # values that stand in for parameters by name (overlay_frame)
        self.overlay: Dict[str, torch.Tensor] = {}


_tls = threading.local()


def _current_frame() -> _Frame:
    frame = getattr(_tls, "frame", None)
    if frame is None:
        raise EnforceError(
            "no active framework frame: layer functions that create parameters "
            "must run inside Model.init/Model.apply (wrap your network with "
            "paddle_tpu_torch.build)"
        )
    return frame


def in_frame() -> bool:
    """Whether a ``Model.init``/``apply`` is running on this thread."""
    return getattr(_tls, "frame", None) is not None


def is_training() -> bool:
    """Whether the current run is a training-mode apply (dropout switch)."""
    return _current_frame().is_train


def is_initializing() -> bool:
    """Whether the current run is Model.init (parameter creation)."""
    return _current_frame().mode == "init"


def current_device() -> torch.device:
    """The device the current Model.init/apply runs on: init's ``device``,
    or the device of the parameters apply was given."""
    return _current_frame().device


def next_rng() -> torch.Generator:
    """The ``torch.Generator`` of a training-mode apply's random draws
    (dropout): the ``rng`` given to ``Model.apply``. Successive draws
    advance it, so one seed gives one stream per run. The JAX package's
    ``next_rng_key`` (``paddle_tpu/framework.py:357``) raises the same
    error when no ``rng`` was given."""
    frame = _current_frame()
    if frame.generator is None:
        raise EnforceError(
            "this program uses randomness (dropout/random ops): pass rng= to "
            "Model.init/Model.apply"
        )
    return frame.generator


@contextlib.contextmanager
def name_scope(prefix: str):
    """Hierarchical name scope (fluid.name_scope parity). Scope names are
    uniquified per frame so loops create block_0, block_1, ..."""
    frame = _current_frame()
    scoped = frame.names.generate("/".join(frame.name_stack + [prefix]))
    leaf = scoped.rsplit("/", 1)[-1] if "/" in scoped else scoped
    frame.name_stack.append(leaf)
    try:
        yield
    finally:
        frame.name_stack.pop()


def _full_name(frame: _Frame, key: str, given: Optional[str]) -> str:
    if given is not None:
        return "/".join(frame.name_stack + [given])
    return frame.names.generate("/".join(frame.name_stack + [key]))


def create_parameter(
    shape: Sequence[int],
    dtype="float32",
    name: Optional[str] = None,
    attr: Union[ParamAttr, str, None] = None,
    default_initializer=None,
) -> torch.Tensor:
    """Create (init mode) or fetch (apply mode) a named parameter: resolves
    ParamAttr, applies the default initializer (Xavier unless overridden) and
    records the metadata the optimizer reads."""
    from paddle_tpu_torch import initializer as init_mod

    frame = _current_frame()
    attr = ParamAttr.to_attr(attr)
    t_dtype = dtypes_mod.convert(dtype)
    full = _full_name(frame, "param", attr.name or name)
    shape = tuple(int(s) for s in shape)
    if full in frame.overlay:
        return frame.overlay[full]
    frame.param_info[full] = ParamInfo(
        name=full, shape=shape, dtype=t_dtype, trainable=attr.trainable,
        learning_rate=attr.learning_rate, regularizer=attr.regularizer,
        sharding=attr.sharding,
    )

    if frame.mode == "init":
        if full in frame.params:
            raise EnforceError(f"duplicate parameter name {full!r}")
        initializer = attr.initializer or default_initializer or init_mod.Xavier()
        frame.params[full] = initializer(frame.generator, shape, t_dtype, frame.device)
        return frame.params[full]
    if full not in frame.params:
        raise EnforceError(
            f"parameter {full!r} not found in provided params; model structure "
            "must match between init and apply"
        )
    value = frame.params[full]
    if tuple(value.shape) != shape and not _is_local_block(tuple(value.shape), shape, attr.sharding):
        raise EnforceError(
            f"parameter {full!r} shape mismatch: created with {shape}, got {tuple(value.shape)}"
        )
    return value


def _block_of(value: torch.Tensor, sharding, mesh, axis: str) -> torch.Tensor:
    """This rank's block of a whole parameter: each dim annotated with
    ``axis`` that the axis's size divides, cut to the rank's slice (the JAX
    package's degradation keeps the others whole)."""
    if sharding is None:
        return value
    n = mesh.shape[axis]
    for dim, name in enumerate(sharding[: value.dim()]):
        if name == axis and value.shape[dim] % n == 0:
            k = value.shape[dim] // n
            value = value.narrow(dim, mesh.axis_index(axis) * k, k).clone()
    return value


def split_axis(name: str, dim: int) -> Optional[str]:
    """The mesh axis over which dim ``dim`` of the parameter ``name`` (in
    the current scope) is split in this run, each rank holding its block,
    or None when this rank holds that dim whole: read from the parameter
    the run was given against the whole shape its init recorded, so a dim
    that the axis does not divide, held whole, reads as whole."""
    frame = _current_frame()
    return dict(held_blocks("/".join(frame.name_stack + [name]))).get(dim)


def held_blocks(full_name: str) -> List[Tuple[int, str]]:
    """``(dim, axis)`` of each dim of the parameter ``full_name`` that this
    run holds as its block over that mesh axis (its shape against the whole
    shape its init recorded); empty where it is whole."""
    frame = _current_frame()
    info, got = frame.whole.get(full_name), frame.params.get(full_name)
    if info is None or got is None or info.sharding is None:
        return []
    return [(d, info.sharding[d]) for d in range(min(got.dim(), len(info.sharding)))
            if got.shape[d] != info.shape[d]]


@contextlib.contextmanager
def overlay_frame(values: Dict[str, torch.Tensor]):
    """Run a block of layer calls with ``values`` standing in for the
    parameters of those names (a pipeline stage's slice of stacked layers
    under a template name), its name scopes uniquified afresh: each entry
    of the block creates the same names (the JAX package's
    ``overlay_frame`` inside a ``lax.scan`` body)."""
    frame = _current_frame()
    prev, counters = frame.overlay, frame.names.snapshot()
    frame.overlay = {**prev, **values}
    try:
        yield
    finally:
        frame.overlay = prev
        frame.names.restore(counters)


def gather_layer_params(n_layers: int, prefix_of: Callable[[int], str]) -> Dict[str, torch.Tensor]:
    """The parameters of ``n_layers`` identically built layers stacked per
    name suffix, ``{suffix: [n_layers, ...]}`` (layer i's names start with
    ``prefix_of(i) + "/"``); differentiable, so each layer's parameters
    take their slice of the stack's gradient."""
    frame = _current_frame()
    per_layer = []
    for i in range(n_layers):
        pre = prefix_of(i) + "/"
        names = sorted(k for k in frame.params if k.startswith(pre))
        if per_layer and [k[len(pre):] for k in names] != sorted(per_layer[0]):
            raise EnforceError(f"layer {prefix_of(i)!r} has other parameters than layer "
                               f"{prefix_of(0)!r}")
        per_layer.append({k[len(pre):]: frame.params[k] for k in names})
    return {s: torch.stack([p[s] for p in per_layer]) for s in per_layer[0]}


def _is_local_block(got: tuple, shape: tuple, sharding) -> bool:
    """Whether ``got`` is a block of a parameter of global ``shape`` that
    this rank holds under ``sharding`` on the entered mesh (an expert-
    parallel MoE's experts: ``parallel/sharding.py::shard_variables``):
    each dim this rank's block of it, or whole (a stored dim that the
    data-parallel step gathered)."""
    if sharding is None:
        return False
    from paddle_tpu_torch.parallel import mesh as mesh_mod

    mesh = mesh_mod.entered_mesh()
    if mesh is None or len(got) != len(shape):
        return False
    local = mesh_mod.local_shape(shape, sharding, mesh)
    return all(g in (w, b) for g, w, b in zip(got, shape, local))


def create_state(name: str, shape: Sequence[int], dtype="float32", init=None) -> torch.Tensor:
    """Create (init mode) or fetch (apply mode) a mutable, non-trainable
    state entry, e.g. BatchNorm's moving mean, named in the current scope.
    ``init(shape, dtype)`` makes its initial value (zeros by default; it is
    moved to the frame's device). In apply mode a value recorded earlier in
    the same run with :func:`update_state` is returned."""
    frame = _current_frame()
    t_dtype = dtypes_mod.convert(dtype)
    full = _full_name(frame, name, name)
    shape = tuple(int(s) for s in shape)
    if frame.mode == "init":
        value = (init or (lambda s, d: torch.zeros(s, dtype=d)))(shape, t_dtype)
        frame.state[full] = value.to(frame.device)
        return frame.state[full]
    if full not in frame.state:
        raise EnforceError(f"state {full!r} missing from provided state dict")
    return frame.new_state.get(full, frame.state[full])


def update_state(name: str, value: torch.Tensor) -> None:
    """Record a new value for a state entry, addressed by the local name it
    was created with in the same scope. The value should carry no autograd
    graph (compute it under ``torch.no_grad()``).

    A bare name that misses in the current scope falls back to the root
    name, as in the JAX package; since that can silently update a different
    layer's state when names collide across scopes, the fallback warns once
    per key."""
    frame = _current_frame()
    scoped = "/".join(frame.name_stack + [name])
    full = scoped if (scoped in frame.state or scoped in frame.new_state) else name
    if full is name and scoped != name and name in frame.state:
        ptlog.warn_once(
            ("update_state-cross-scope", scoped),
            "update_state(%r): no state entry at scope %r; falling back to the "
            "root-level name %r — a cross-scope state update resolves by "
            "accident when names collide. Address state from within the "
            "name_scope that created it.",
            name, scoped, name,
        )
    if full not in frame.state:
        raise EnforceError(f"unknown state {name!r} (create_state first)")
    if frame.mode == "init":
        return  # init keeps the initial value
    frame.new_state[full] = value


@contextlib.contextmanager
def _enter(frame: _Frame):
    prev = getattr(_tls, "frame", None)
    _tls.frame = frame
    try:
        with unique_name.guard(frame.names):
            yield
    finally:
        _tls.frame = prev


class _Replay:
    """What a block of layer calls reads from its frame when it starts: the
    name stack, the name counters, the generator's state, the
    data-parallel step's group and the entered mesh. Entering it
    runs the block again as it first ran (same parameter names, same random
    draws), on whatever thread, and puts the frame back as it was after."""

    def __init__(self, frame: _Frame):
        from paddle_tpu_torch.parallel import context as dp_context
        from paddle_tpu_torch.parallel import mesh as mesh_mod

        self.frame = frame
        # the data-parallel step's group, if the block runs inside one, and
        # the mesh its collectives run over
        self.batch_group = dp_context.active()
        self.mesh = mesh_mod.entered_mesh()
        self.name_stack = list(frame.name_stack)
        self.counters = frame.names.snapshot()
        self.overlay = frame.overlay
        gen = frame.generator
        self.gen_state = gen.get_state() if gen is not None else None

    @contextlib.contextmanager
    def replay(self):
        frame, gen = self.frame, self.frame.generator
        stack, counters, overlay = frame.name_stack, frame.names.snapshot(), frame.overlay
        gen_state = gen.get_state() if gen is not None else None
        frame.name_stack = list(self.name_stack)
        frame.names.restore(self.counters)
        frame.overlay = self.overlay
        if gen is not None:
            gen.set_state(self.gen_state)
        from paddle_tpu_torch.parallel import context as dp_context

        try:
            with _enter(frame), dp_context.global_batch(self.batch_group), \
                    (self.mesh if self.mesh is not None else contextlib.nullcontext()):
                yield
        finally:
            frame.name_stack = stack
            frame.names.restore(counters)
            frame.overlay = overlay
            if gen is not None:
                gen.set_state(gen_state)


def checkpoint(fn: Callable, *args):
    """``fn(*args)`` rematerialized: its activations are not kept for the
    backward pass but recomputed there (``torch.utils.checkpoint``, the
    JAX package's ``jax.checkpoint``), so training memory holds one block's
    activations instead of all of them. ``torch.utils.checkpoint`` restores
    only PyTorch's global generators, and the backward may run on another
    thread after ``Model.apply`` has returned; so the recompute re-enters
    this frame with the name scopes and counters it started with (the same
    parameter names) and the frame's generator at the state it started from
    (the same dropout masks), then restores all three."""
    from torch.utils import checkpoint as tcp

    replay = _Replay(_current_frame())
    runs = [0]

    def run(*xs):
        runs[0] += 1
        if runs[0] == 1:
            return fn(*xs)
        with replay.replay():
            return fn(*xs)

    return tcp.checkpoint(run, *args, use_reentrant=False, preserve_rng_state=False)


class Model:
    """A built program: ``init`` creates its parameters, ``apply`` runs it."""

    def __init__(self, fn: Callable, name: Optional[str] = None):
        self._fn = fn
        self.name = name or getattr(fn, "__name__", "model")
        self.param_info: Dict[str, ParamInfo] = {}

    def init(self, seed: Union[int, torch.Generator, None] = None, *args,
             device="cuda", **kwargs) -> Variables:
        """Run the program once, creating its parameters on ``device``
        (default CUDA; raises if CUDA is absent unless ``device="cpu"``).
        ``seed``: an int, a CPU ``torch.Generator``, or None for
        ``flags().seed``."""
        dev = resolve_device(device)
        if isinstance(seed, torch.Generator):
            gen = seed
        else:
            gen = torch.Generator().manual_seed(flags().seed if seed is None else int(seed))
        frame = _Frame("init", params={}, device=dev, generator=gen, is_train=True)
        with _enter(frame), torch.no_grad():
            self._fn(*args, **kwargs)
        self.param_info = frame.param_info
        from paddle_tpu_torch.parallel import mesh as mesh_mod

        # under an entered mesh with a model axis, each rank keeps its block
        # of the parameters annotated over it: the slice of this init
        mesh, params = mesh_mod.entered_mesh(), frame.params
        if mesh is not None and mesh.shape.get(mesh_mod.MODEL_AXIS, 1) > 1:
            params = {k: _block_of(v, frame.param_info[k].sharding, mesh, mesh_mod.MODEL_AXIS)
                      for k, v in params.items()}
        return Variables(params=params, state=frame.state)

    def apply(
        self,
        variables: Union[Variables, Dict[str, torch.Tensor], Tuple],
        *args,
        rng: Optional[torch.Generator] = None,
        is_train: bool = False,
        **kwargs,
    ):
        """Run the program against ``variables``. Returns ``(output,
        new_state)``: the given state with the entries this run updated
        (BatchNorm's moving statistics in training mode) replaced. It runs
        on the device that holds the parameters (or, for a program with
        none, its state).

        ``rng``: the ``torch.Generator`` of a training-mode run's random
        draws (dropout), on the device the draws should run on; None when
        nothing random runs.
        Gradients flow: apply does not disable autograd, so a loss it
        returns differentiates with respect to the parameters given."""
        if isinstance(variables, Variables):
            params, state = variables.params, variables.state
        elif isinstance(variables, tuple) and len(variables) == 2:
            params, state = variables
        else:
            params, state = variables, {}
        held = list(params.values()) or list(state.values())
        if not held:
            raise EnforceError("Model.apply: no parameters or state given (run Model.init first)")
        device = held[0].device
        frame = _Frame("apply", params=params, device=device, generator=rng, is_train=is_train,
                       state=state)
        from paddle_tpu_torch.parallel import mesh as mesh_mod

        if mesh_mod.entered_mesh() is not None:  # the layers read which params are blocks
            frame.whole = self.param_info
        with _enter(frame):
            out = self._fn(*args, **kwargs)
        if not self.param_info:
            self.param_info = frame.param_info
        return out, {**state, **frame.new_state}


def build(fn: Callable, name: Optional[str] = None) -> Model:
    """Wrap a layer-calling function into a Model."""
    return Model(fn, name=name)
