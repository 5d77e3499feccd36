"""DataParallel — the ParallelExecutor replacement, port of
``paddle_tpu/parallel/data_parallel.py``.

Reference: ``fluid.ParallelExecutor`` (``python/paddle/fluid/parallel_executor.py:32``,
C++ ``framework/parallel_executor.cc:134``): replicate the program per GPU,
scale the loss grad by 1/N, allreduce every gradient over NCCL, split the
feed minibatch per device.

The JAX package runs ONE pjit program over a mesh, so its step is the
single-device step on the global batch. Here each rank is a process on one
card that computes a forward over its own rows ``[r·B/N, (r+1)·B/N)`` (JAX's
``P('data')`` in device order). The invariant the port holds is the JAX
package's: ``step`` on N ranks equals the single-device step on the global
batch. Three things keep it:

- while the step runs, :mod:`~paddle_tpu_torch.parallel.context` makes the
  batch reductions that need it global (BatchNorm's statistics and their
  gradient terms; ratio losses' normalizers);
- the gradients, the loss and the scalar outputs are then MEAN-reduced
  over the group in one all-reduce of a flat f32 buffer (NCCL on CUDA, gloo
  on the CPU); a ratio loss is scaled so that this mean is its global value;
- the model's batch outputs (``batch_outputs``: by default every output
  that is not a scalar) are gathered to the global batch, as JAX
  replicates them, and ``finite`` is computed from the reduced values, so
  the NaN guard decides alike on every rank.

Each rank then applies the same update to the same values, so the replicas
stay bit-equal. ``zero_shard_optimizer`` (ZeRO-1) keeps each rank's rows of
the optimizer slots only; see :meth:`DataParallel._apply`.

Placement is read from the specs, as GSPMD reads them, so any mesh and
spec that the JAX package's ``DataParallel`` takes runs here and gives the
same step:

- the batch (``batch_specs``): dim 0 split over any axis or tuple of axes
  (``P("data")``, ``P(("data", "expert"))``, ``P(("data", "seq"))``), a
  rank's rows in the JAX device order (row-major over the axes as listed),
  and dim 1 split over ``seq`` (``P("data", "seq")``: each rank holds the
  ``[B/n_rows, T/n_seq]`` block, and the step runs the model on it in the
  sequence-sharded context: positions, attention over the ring or by
  all-to-all, ``parallel/context.py``). These are the step's token axes.
  A batch dim split over an axis the layers consume (``model``, ``pipe``)
  is gathered whole over that axis at the step's entry, the reshard GSPMD
  inserts there, and so is any other dim's split; where the args split
  dim 0 differently, their rows follow the axes they all split over;
- an axis of size > 1 that the batch does not split and no parameter is
  split over (``tp`` on a training mesh, ``seq`` or ``pipe`` beside a model
  without a sequence core or pipeline) holds replicas: the step does not
  reduce over it, and they stay bit-equal;
- the parameters (``parallel/sharding.py``): a block over ``expert`` on
  dim 0 (the experts, ``parallel/moe.py``: each rank its E/n, the partial
  outputs summed over the ``expert`` group) or over ``model`` (Megatron's
  column- and row-parallel projections, ``layers.fc``, the embedding split
  over d_model; the layers' conjugate collectives leave every gradient
  whole on each rank of the group, a block's for its block) is held: the
  layers consume it. A block over any other axis, or a tuple of axes, is
  stored (FSDP-like): a rank keeps only its window at rest, the step
  gathers it whole before ``Model.apply`` (one flat all-gather,
  :func:`~paddle_tpu_torch.parallel.sharding.gather_blocks`), reduces its
  gradient as a whole gradient and cuts that to the window (reduce-
  scatter's arithmetic), and the optimizer updates the block. On a
  ``pipe`` axis every rank runs its stage of the model's pipeline
  (``parallel/pipeline.py``), whose backward sums the stages' gradients
  over ``pipe``.

Gradients are reduced by placement: the sum over every token axis, a held
block's over those it is not split on, divided by the number of token
blocks (the mean over the tokens). A norm clip reads the whole gradients'
norms (:meth:`DataParallel._sq_norms`). ZeRO-1 follows the JAX package's
rule (``paddle_tpu/parallel/data_parallel.py:221-229``): the slots of a
parameter split over any axis keep its blocks, those of a replicated one
split over ``data``. ``pipe`` beside ``seq`` and MoE in the pipelined path
are refused by the LM with the JAX package's messages
(``models/transformer_lm.py``).
"""

from __future__ import annotations

import math
import weakref
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from paddle_tpu_torch import clip as clip_mod
from paddle_tpu_torch.core import tree as tree_mod
from paddle_tpu_torch.core.config import resolve_device
from paddle_tpu_torch.core.enforce import enforce
from paddle_tpu_torch.executor import to_device
from paddle_tpu_torch.framework import Model, Variables
from paddle_tpu_torch.optimizer import Optimizer, OptState, StepOutput
from paddle_tpu_torch.parallel import collective
from paddle_tpu_torch.parallel import context as dp_context
from paddle_tpu_torch.parallel import mesh as mesh_mod
from paddle_tpu_torch.parallel.sharding import (
    LeafLayout,
    NamedSharding,
    P,
    block_axes,
    block_window,
    broadcast_tensors,
    cut_block,
    gather_blocks,
    param_shardings,
    shard_variables,
    spec_axes,
    split_blocks,
)


# the axes the layers consume: a batch dim split over one is gathered whole
# over it at the step's entry (the reshard GSPMD inserts there)
_CONSUMED = (mesh_mod.MODEL_AXIS, mesh_mod.PIPE_AXIS)


def _check_spec(spec, mesh: mesh_mod.Mesh) -> None:
    """The JAX package's refusals of a batch spec (``NamedSharding``): an
    axis the mesh lacks, an axis named twice."""
    named = [a for entry in spec for a in spec_axes(entry)]
    for a in named:
        if a not in mesh.shape:
            raise ValueError(f"Resource axis: {a} of PartitionSpec{tuple(spec)!r} is not found "
                             f"in mesh: {tuple(mesh.axis_names)}.")
    for a in dict.fromkeys(named):
        if named.count(a) > 1:
            raise ValueError("A single NamedSharding spec specification can map every mesh axis "
                             "to at most one positional dimension, but "
                             f"PartitionSpec{tuple(spec)!r} has duplicate entries for `{a}`")


def _split_axes(entry) -> Tuple[str, ...]:
    """The axes a batch dim's entry splits the step's tokens over: those
    the layers do not consume."""
    return tuple(a for a in spec_axes(entry) if a not in _CONSUMED)


class DataParallel:
    """Data-parallel training, one rank per card.

    Usage (every rank runs the same code on the same global batch):
        dp = DataParallel(model, optimizer, mesh=make_mesh(data=-1))
        variables, opt_state = dp.init(seed, *example_batch)
        out = dp.step(variables, opt_state, *batch)

    ``device`` is this rank's card: by default the one
    ``initialize_distributed`` chose, or CUDA without a process group
    (``device="cpu"`` for the plain PyTorch path).
    """

    def __init__(
        self,
        model: Model,
        optimizer: Optimizer,
        mesh: Optional[mesh_mod.Mesh] = None,
        batch_axis: str = mesh_mod.DATA_AXIS,
        loss_index: int = 0,
        donate: bool = True,
        batch_specs: Optional[Sequence[Optional[P]]] = None,
        zero_shard_optimizer: bool = False,
        device=None,
        batch_outputs: Optional[Sequence[int]] = None,
    ):
        """``batch_specs``: optional per-batch-arg PartitionSpecs overriding
        the default leading-dim data split: ``P()`` (or None) feeds that arg
        whole to every rank; dim 0 may split over any axes
        (``P(("data", "expert"))``), dim 1 over ``seq`` (``P("data",
        "seq")``, sequence parallelism); see the module docstring. A spec
        naming an axis the mesh lacks, or one axis twice, raises the JAX
        package's error.

        ``zero_shard_optimizer`` (ZeRO-1): the slots of each replicated
        parameter are kept sharded on their first dim divisible by the
        data-axis size, each rank updating its own rows; the reference's
        Reduce+Broadcast BuildStrategy (``multi_devices_graph_pass.cc:397-446``)
        solved the same problem by placing each param's update on one owner
        device.

        ``donate`` is accepted and has no effect: the step is functional
        and never overwrites the caller's tensors (as the JAX package's
        donation on the CPU).

        ``batch_outputs``: the positions, among the leaves of the model's
        outputs (the index in an output tuple of tensors), of the outputs
        that hold one row per batch row; ``step`` and ``eval_step`` gather
        them to the global batch. Default: every output that is not a 0-d
        tensor; ``()`` gathers none, so each rank keeps its own rows (the
        Trainer's choice: it reads only the loss). A named output whose
        leading dim is not this rank's rows raises. 0-d float outputs are
        averaged over the group whatever this says."""
        self.model = model
        self.optimizer = optimizer
        self.mesh = mesh if mesh is not None else mesh_mod.default_mesh()
        self.batch_axis = batch_axis
        self.loss_index = loss_index
        self.donate = donate
        self.batch_specs = tuple(batch_specs) if batch_specs is not None else None
        self.zero_shard_optimizer = zero_shard_optimizer
        self.batch_outputs = None if batch_outputs is None else tuple(batch_outputs)
        enforce(
            batch_axis in self.mesh.axis_names,
            f"batch axis {batch_axis!r} not in mesh axes {self.mesh.axis_names}",
        )
        # the axes the step's tokens are split over: rows (row-major), then seq
        self._row_axes, self._seq_axis = self._token_layout()
        self._token_axes = self._row_axes + ((self._seq_axis,) if self._seq_axis else ())
        if device is None:
            device = mesh_mod.process_device() or "cuda"
        self.device = resolve_device(device)
        self._step_fn = None
        self._ragged_fn = None
        self._batch_rows = 0  # this rank's rows in the running step
        self._layout = None  # (param_info, names, their blocks): _blocks
        # tensors put_batch returned: already this rank's rows
        self._placed: "weakref.WeakValueDictionary[int, torch.Tensor]" = weakref.WeakValueDictionary()

    def _token_layout(self) -> Tuple[Tuple[str, ...], Optional[str]]:
        """``(row axes, seq axis)`` from the batch specs: the axes that
        every arg splitting dim 0 splits it over (in the first such arg's
        order), and ``seq`` where an arg splits dim 1 over it."""
        if self.batch_specs is None:
            return (self.batch_axis,), None
        rows, seq = None, None
        for spec in self.batch_specs:
            spec = tuple(spec or ())
            _check_spec(spec, self.mesh)
            if spec and spec[0] is not None:
                axes = _split_axes(spec[0])
                rows = axes if rows is None else tuple(a for a in rows if a in axes)
            if len(spec) > 1 and _split_axes(spec[1]) == (mesh_mod.SEQ_AXIS,):
                seq = mesh_mod.SEQ_AXIS
        return rows or (), seq

    # -- the group ------------------------------------------------------------
    @property
    def num_devices(self) -> int:
        return self.mesh.size

    def _axis_index(self, axis: str) -> int:
        return self.mesh.axis_index(axis) if self.mesh.shape.get(axis, 1) > 1 else 0

    @property
    def _n_rows(self) -> int:
        """The number of row blocks of the global batch."""
        return math.prod(self.mesh.shape[a] for a in self._row_axes)

    def _token_index(self) -> int:
        """This rank's block among the step's token blocks (row-major)."""
        i = 0
        for axis in self._token_axes:
            i = i * self.mesh.shape[axis] + self._axis_index(axis)
        return i

    def _batch_group(self) -> dp_context.BatchGroup:
        return dp_context.BatchGroup(self.mesh, self._token_axes, self._seq_axis)

    # -- setup --------------------------------------------------------------
    def init(self, rng, *example_batch, variables: Optional[Variables] = None) -> Tuple[Variables, OptState]:
        """Initialize (or adopt) variables + optimizer state and place them
        on every rank: the first rank's values, broadcast
        (BCastParamsToDevices parity), each rank keeping its block of a
        split parameter. Adopted ``variables`` are whole; the model's
        parameter metadata (their shardings) comes from an init on the
        example batch when no init or apply has recorded it yet."""
        example = tuple(to_device(b, self.device) for b in example_batch)
        if variables is None:
            variables = self.model.init(rng, *example, device=self.device)
        else:
            if not self.model.param_info:
                self.model.init(rng, *example, device=self.device)
            variables = tree_mod.map_leaves(lambda t: t.to(self.device), variables)
        variables = shard_variables(self.mesh, variables, self.model.param_info)
        opt_state = self.optimizer.create_state(variables.params)
        return variables, self._shard_slots(opt_state, variables.params)

    def _blocks(self, params: Dict[str, torch.Tensor]):
        """``(held, stored)``: ``{name: [(dim, entry), ...]}`` of the dims of
        each parameter this rank holds a block of, by kind
        (:func:`~paddle_tpu_torch.parallel.sharding.split_blocks`). Read
        once for a set of parameter names and the model's ``param_info``:
        the step asks several times."""
        info, names = self.model.param_info, tuple(params)
        if self._layout is None or self._layout[0] is not info or self._layout[1] != names:
            self._layout = (info, names, split_blocks(param_shardings(self.mesh, info, params)))
        return self._layout[2]

    def _zero_dims(self, params: Dict[str, torch.Tensor]) -> Dict[str, int]:
        """ZeRO-1: the dim each parameter's slots are sharded on — the first
        whose size the data-axis size divides (the JAX package's rule);
        none for an optimizer whose update reads whole parameters, nor for
        a parameter split over any axis (its slots keep its layout, as in
        the JAX package)."""
        if not self.zero_shard_optimizer or not self.optimizer.elementwise:
            return {}
        n, out = self.mesh.shape[self.batch_axis], {}
        held, stored = self._blocks(params)
        for name, p in params.items():
            if name in held or name in stored:
                continue
            for dim, size in enumerate(p.shape):
                if size % n == 0 and size >= n:
                    out[name] = dim
                    break
        return out

    def _zero_rows(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        k = t.shape[dim] // self.mesh.shape[self.batch_axis]
        return t.narrow(dim, self._axis_index(self.batch_axis) * k, k)

    def _shard_slots(self, opt_state: OptState, params: Dict[str, torch.Tensor]) -> OptState:
        """Every leaf on this rank's device, and under ZeRO-1 each whole
        slot cut to this rank's rows (a slot already cut is kept)."""
        dims = self._zero_dims(params)

        def place(name, v):
            if name in dims and v.shape == params[name].shape:
                v = self._zero_rows(v, dims[name]).clone()
            return v.to(self.device)

        return OptState(step=opt_state.step, slots={
            s: {k: place(k, v) for k, v in d.items()} for s, d in opt_state.slots.items()})

    # -- batches --------------------------------------------------------------
    def _batch_shardings(self, batch: Sequence[Any]):
        if self.batch_specs is not None:
            enforce(
                len(self.batch_specs) == len(batch),
                f"batch_specs has {len(self.batch_specs)} entries for {len(batch)} batch args",
            )
            return tuple(NamedSharding(self.mesh, spec if spec is not None else P())
                         for spec in self.batch_specs)
        return tuple(
            NamedSharding(self.mesh, P(self.batch_axis, *([None] * (len(np.shape(b)) - 1))))
            for b in batch
        )

    def batch_divisible(self, *batch) -> bool:
        """True iff EVERY arg's leading dim divides its own dim-0 shard
        extent (per arg: a replicated side input must not veto the split
        args, and vice versa)."""
        for b, s in zip(batch, self._batch_shardings(batch)):
            shape = np.shape(b)
            if not shape:
                continue
            axes = s.spec[0] if len(s.spec) else None
            if shape[0] % self._spec_dim_size(axes) != 0:
                return False
        return True

    def leading_multiple(self, *batch) -> int:
        """The multiple every arg's leading dim must divide to shard on this
        mesh: LCM over each arg's dim-0 sharding extent (batch specs may
        split dim 0 over several axes, e.g. ``P(("data", "seq"))``)."""
        mult = 1
        for s in self._batch_shardings(batch):
            axes = s.spec[0] if len(s.spec) else None
            mult = math.lcm(mult, self._spec_dim_size(axes))
        return mult

    def _spec_dim_size(self, axes) -> int:
        """Total mesh extent a spec entry shards one dim over (1 if None)."""
        return math.prod(self.mesh.shape[a] for a in spec_axes(axes))

    def _validate_batch(self, batch, shards):
        """Divisibility of each arg dim by the mesh-axis sizes its spec
        shards it over."""
        for b, s in zip(batch, shards):
            shape = np.shape(b)
            for dim, axes in enumerate(s.spec[: len(shape)]):
                if axes is None:
                    continue
                size = self._spec_dim_size(axes)
                enforce(
                    shape[dim] % size == 0,
                    f"batch arg dim {dim} of size {shape[dim]} not divisible by "
                    f"mesh axes {axes} (size {size}) (static shapes: drop or "
                    "pad the last partial batch)",
                )

    def put_batch(self, *batch):
        """This rank's part of a global host batch, on its device (the
        per-device feed split of ParallelExecutor.run,
        parallel_executor.py:173): its rows (:meth:`rank_rows`) of each arg
        whose spec splits dim 0 (and, for an arg whose spec splits dim 1
        over ``seq``, this rank's segment of each row), an arg split
        otherwise or not at all whole. ``step`` takes these as they are."""
        shards = self._batch_shardings(batch)
        self._validate_batch(batch, shards)
        out = []
        for b, s in zip(batch, shards):
            if len(s.spec) and s.spec[0] is not None:
                b = self.rank_rows(b)
            if self._seq_axis and len(s.spec) > 1 and _split_axes(s.spec[1]) == (self._seq_axis,):
                n = self.mesh.shape[self._seq_axis]
                k = np.shape(b)[1] // n
                j = self._axis_index(self._seq_axis)
                b = b[:, j * k:(j + 1) * k]
            t = to_device(b, self.device)
            self._placed[id(t)] = t
            out.append(t)
        return tuple(out)

    def rank_rows(self, b):
        """This rank's rows ``[r·B/R, (r+1)·B/R)`` of one global batch arg
        (a host array or a tensor, sliced where it lies): ``r`` its block
        row-major over the row axes, ``R`` their number."""
        k = np.shape(b)[0] // self._n_rows
        r = self._batch_group().row_block()
        return b[r * k:(r + 1) * k]

    def _local(self, batch) -> tuple:
        """``batch`` as this rank's rows: tensors from :meth:`put_batch` as
        they are, a global batch split."""
        if batch and all(self._placed.get(id(b)) is b for b in batch):
            return tuple(batch)
        return self.put_batch(*batch)

    def pad_batch(self, *batch, to: Optional[int] = None):
        """Pad a (possibly ragged) batch's leading dim up to ``to`` — or the
        next shard multiple — by repeating the final row; returns
        ``(padded_batch, valid_mask)`` with a float32 [B_padded] mask that is
        1 for real rows, 0 for padding (the reference's data_balance op,
        ``details/data_balance_op_handle.cc:154``: every sample evaluates
        exactly once). Padding repeats a real row, never zeros."""
        n = int(np.shape(batch[0])[0])
        for b in batch[1:]:
            enforce(
                int(np.shape(b)[0]) == n,
                "pad_batch: all batch args must share the leading dim",
            )
        mult = self.leading_multiple(*batch)
        target = to if to is not None else -(-n // mult) * mult
        enforce(
            target >= n and target % mult == 0,
            f"pad_batch: target {target} must be >= batch size {n} and "
            f"divisible by the leading-dim shard multiple {mult} (LCM of "
            "each arg's dim-0 sharding extents)",
        )
        mask = np.zeros((target,), np.float32)
        mask[:n] = 1.0
        if target == n:
            return batch, mask

        def pad(b):
            if isinstance(b, torch.Tensor):
                return torch.cat([b, b[-1:].expand(target - n, *b.shape[1:])])
            b = np.asarray(b)
            return np.concatenate([b, np.repeat(b[-1:], target - n, axis=0)])

        return tuple(pad(b) for b in batch), mask

    # -- reductions -----------------------------------------------------------
    def _mean(self, tensors: List[torch.Tensor],
              held: Optional[Sequence[Sequence[str]]] = None) -> List[torch.Tensor]:
        """The mean over the step's token blocks of each tensor: its sum
        over every token axis — for a held block (``held[i]``: the axes it
        is split over) over those it is not split on — divided by the
        number of token blocks. One all-reduce per axis of a flat f32
        buffer holding every tensor summed over the same axes (identities
        on one rank without a process group)."""
        group = self._batch_group()
        if group.group is None or not tensors:
            return list(tensors)
        by_axes: Dict[Tuple[str, ...], List[int]] = {}
        for i in range(len(tensors)):
            skip = held[i] if held is not None else ()
            by_axes.setdefault(tuple(a for a in group.axes if a not in skip), []).append(i)
        out: List[Optional[torch.Tensor]] = [None] * len(tensors)
        for axes, idx in by_axes.items():
            flat = torch.cat([tensors[i].detach().float().reshape(-1) for i in idx])
            for g in (group.groups[group.axes.index(a)] for a in axes):
                if g is not None:
                    torch.distributed.all_reduce(flat, group=g)
            flat.div_(group.size)
            off = 0
            for i in idx:
                n = tensors[i].numel()
                out[i] = flat[off:off + n].view(tensors[i].shape).to(tensors[i].dtype)
                off += n
        return out

    def sum_over_ranks(self, values: Sequence[float]) -> List[float]:
        """Python numbers summed over the row blocks, in float64 (each row
        counted once: not over replicas, nor over ``seq``, whose ranks
        hold whole rows in eval)."""
        group = self._batch_group()
        if group.group is None or not group.row_axes:
            return list(values)
        t = torch.tensor(list(values), dtype=torch.float64, device=self.device)
        for a in group.row_axes:
            torch.distributed.all_reduce(t, group=self.mesh.group(a))
        return t.tolist()

    def _gather_outputs(self, outputs, rows: int, rows_whole: bool = False):
        """The model's outputs as the JAX package returns them: the batch
        outputs (``batch_outputs``) gathered to the global batch, 0-d float
        tensors averaged over the group (a loss, an accuracy: means over
        equal shards), anything else as it is. ``rows_whole``: the outputs
        already hold whole rows (:meth:`eval_local` gathered the segments
        of a sequence split)."""
        leaves = tree_mod.leaves(outputs)
        scalars = [i for i, t in enumerate(leaves) if isinstance(t, torch.Tensor)
                   and t.dim() == 0 and t.is_floating_point()]
        new = list(leaves)
        for i, v in zip(scalars, self._mean([leaves[i] for i in scalars])):
            new[i] = v
        if self.batch_outputs is None:
            batch = [i for i, t in enumerate(leaves) if isinstance(t, torch.Tensor) and t.dim()]
        else:
            batch = list(self.batch_outputs)
        for i in batch:
            t = leaves[i] if 0 <= i < len(leaves) else None
            if not (isinstance(t, torch.Tensor) and t.dim() and t.shape[0] == rows):
                shape = None if t is None else tuple(getattr(t, "shape", ()))
                raise ValueError(
                    f"DataParallel: output {i} (shape {shape}) is taken as a batch output but "
                    f"does not hold this rank's {rows} rows on its leading dim; name the batch "
                    f"outputs with batch_outputs= (() gathers none)")
        if self._batch_group().group is not None:
            with self.mesh, torch.no_grad():
                for i in batch:
                    t = leaves[i].detach()
                    if self._seq_axis is not None and t.dim() > 1 and not rows_whole:
                        # the row segments: positions on dim 1
                        t = collective.all_gather(t, self._seq_axis, axis=1)
                    for axis in reversed(self._row_axes):  # the innermost first
                        t = collective.all_gather(t, axis)
                    new[i] = t
        return tree_mod.unflatten(outputs, new)

    def _reduce_global(self, loss, grads, new_state, state, outputs):
        """The step's one reduction: the mean over the token blocks of the
        gradients (a held block's by :meth:`_mean`'s rule) and the loss,
        then the outputs gathered."""
        with torch.no_grad():
            names = list(grads)
            held, _ = self._blocks(grads)
            axes = [block_axes(held.get(k, ())) for k in names] + [()]
            red = self._mean([grads[k] for k in names] + [loss], axes)
            grads = dict(zip(names, red[:-1]))
            return red[-1], grads, new_state, self._gather_outputs(outputs, self._batch_rows)

    def _reduce_first_rank(self, loss, grads, new_state, state, outputs):
        """step_ragged: every rank computed the whole batch; all take the
        first rank's gradients and loss, so the replicas stay bit-equal."""
        with torch.no_grad():
            names = list(grads)
            red = broadcast_tensors([grads[k] for k in names] + [loss.reshape(1)], self.mesh,
                                    self.batch_axis)
            return red[-1].reshape(()), dict(zip(names, red[:-1])), new_state, outputs

    # -- the update -----------------------------------------------------------
    def _apply(self, params, grads, opt_state, param_info):
        """The update where a rank holds blocks or ZeRO-1 rows: the
        regularization and the clip on the reduced gradients (a held
        block's clipped by the whole gradients' norms), each stored
        parameter and its gradient, whole here, cut to the rank's window,
        and the rule on the blocks; under ZeRO-1 each rank's rule on its
        rows of every replicated parameter (with its rows of the slots),
        then one all-gather per dtype of the updated rows. Elementwise rules
        give each entry what the whole update gives it, so the step equals
        the step of one rank. A rule that reads whole parameters updates a
        stored one whole, its slots gathered, and keeps the window."""
        opt = self.optimizer
        grads = opt.prepare_gradients(params, grads, param_info, sq_norms=self._sq_norms)
        _, stored = self._blocks(params)
        if stored and not opt.elementwise:
            slots = {s: {**d, **gather_blocks({k: d[k] for k in stored if k in d}, stored,
                                              self.mesh)} for s, d in opt_state.slots.items()}
            new_params, new_opt = opt.update(params, grads, OptState(opt_state.step, slots),
                                             param_info)
            new_params.update({k: cut_block(new_params[k], d, self.mesh)
                               for k, d in stored.items()})
            for d in new_opt.slots.values():
                d.update({k: cut_block(d[k], stored[k], self.mesh) for k in stored if k in d})
            return new_params, new_opt
        for k, d in stored.items():
            params = {**params, k: cut_block(params[k], d, self.mesh)}
            grads = {**grads, k: cut_block(grads[k], d, self.mesh)}
        dims = self._zero_dims(params)
        rows_p = {k: self._zero_rows(p, dims[k]) if k in dims else p for k, p in params.items()}
        rows_g = {k: self._zero_rows(g, dims[k]) if k in dims else g for k, g in grads.items()}
        new_rows, new_opt = opt.update(rows_p, rows_g, opt_state, param_info)
        new_params = dict(new_rows)
        by_dtype: Dict[torch.dtype, List[str]] = {}
        for k in dims:
            by_dtype.setdefault(new_rows[k].dtype, []).append(k)
        n = self.mesh.shape[self.batch_axis]
        with torch.no_grad(), self.mesh:
            for names in by_dtype.values():
                flat = torch.cat([new_rows[k].reshape(-1) for k in names])
                parts = collective.all_gather(flat, self.batch_axis, axis=0, tiled=False)
                off = 0
                for k in names:
                    shape = new_rows[k].shape
                    size = new_rows[k].numel()
                    new_params[k] = torch.cat(
                        [parts[r, off:off + size].view(shape) for r in range(n)], dim=dims[k])
                    off += size
        return new_params, new_opt

    def _apply_fn(self):
        """The update hook of the step: :meth:`_apply` under ZeRO-1 or
        where a parameter is split over an axis, else the optimizer's
        own."""
        shapes = {k: torch.empty(i.shape, device="meta") for k, i in self.model.param_info.items()}
        held, stored = self._blocks(shapes)
        return self._apply if self.zero_shard_optimizer or held or stored else None

    def _sq_norms(self, grads: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Each gradient's squared norm, whole: a held block's (over
        ``expert`` or ``model``) summed over the axes it is split on, one
        all-reduce per axis (what a norm clip reads, ``clip.py``); a stored
        parameter's gradient is whole here."""
        sq = clip_mod.squared_norms(grads)
        by_axis: Dict[str, List[str]] = {}
        held, _ = self._blocks(grads)
        for name, dims in held.items():
            for axis in block_axes(dims):
                by_axis.setdefault(axis, []).append(name)
        with torch.no_grad(), self.mesh:
            for axis, names in by_axis.items():
                total = collective.all_reduce(torch.stack([sq[k] for k in names]), axis)
                sq.update(zip(names, total))
        return sq

    # -- steps ----------------------------------------------------------------
    def _rank_rng(self, rng: Optional[torch.Generator]) -> Optional[torch.Generator]:
        """Each rank's dropout stream: a seed drawn from ``rng`` (the same
        draw on every rank) offset by the rank's token block, so blocks do
        not repeat each other's masks (the ranks that hold the same tokens
        draw the same)."""
        if rng is None:
            return None
        seed = int(torch.randint(2 ** 62, (), generator=rng, device=rng.device))
        return torch.Generator(device=rng.device).manual_seed(seed + self._token_index())

    def _whole_stored(self, variables: Variables) -> Variables:
        """``variables`` with each stored parameter gathered whole over its
        stored dims (held dims stay blocks): what ``Model.apply`` reads."""
        _, stored = self._blocks(variables.params)
        if not stored:
            return variables
        whole = gather_blocks({k: variables.params[k] for k in stored}, stored, self.mesh)
        return Variables(params={**variables.params, **whole}, state=variables.state)

    def step(self, variables: Variables, opt_state: OptState, *batch, rng=None) -> StepOutput:
        """One data-parallel train step on the global ``batch`` (or on what
        :meth:`put_batch` returned for it): each stored parameter gathered
        whole, this rank's forward and backward with the batch reductions
        made global, the mean of the gradients and the loss over the token
        blocks, the update. Equals the single-device step on the global
        batch."""
        local = self._local(batch)
        if self._step_fn is None:
            self._step_fn = self.optimizer.train_step(
                self.model, self.loss_index, reduce=self._reduce_global, apply=self._apply_fn())
        self._batch_rows = _leading(local)
        variables = self._whole_stored(variables)
        with self.mesh, dp_context.global_batch(self._batch_group()):
            return self._step_fn(variables, opt_state, *local, rng=self._rank_rng(rng))

    def step_ragged(self, variables: Variables, opt_state: OptState, *batch, rng=None) -> StepOutput:
        """Train step for a batch whose leading dim does NOT divide the
        mesh: every rank computes the whole small batch (numerically the
        single-device step), and all take the first rank's gradients, so
        the replicas stay bit-equal (data_balance parity on the train side,
        ``details/data_balance_op_handle.cc:154``: every sample trains)."""
        if self._ragged_fn is None:
            self._ragged_fn = self.optimizer.train_step(
                self.model, self.loss_index, reduce=self._reduce_first_rank,
                apply=self._apply_fn())
        whole = tuple(to_device(b, self.device) for b in batch)
        variables = self._whole_stored(variables)
        with self.mesh:
            return self._ragged_fn(variables, opt_state, *whole, rng=rng)

    def eval_local(self, variables: Variables, *local, rng=None):
        """This rank's rows (from :meth:`put_batch`) through the model in
        eval mode, batch reductions global; the outputs stay this rank's
        rows — whole rows under a sequence split: each output with a dim 1
        is gathered over ``seq`` on it (what ``Trainer.evaluate``'s per-row
        metrics read)."""
        variables = self._whole_stored(variables)
        with torch.no_grad(), self.mesh, dp_context.global_batch(self._batch_group()):
            out, _ = self.model.apply(variables, *local, rng=rng, is_train=False)
            if self._seq_axis is None:
                return out
            leaves = [collective.all_gather(t, self._seq_axis, axis=1)
                      if isinstance(t, torch.Tensor) and t.dim() > 1 else t
                      for t in tree_mod.leaves(out)]
        return tree_mod.unflatten(out, leaves)

    def eval_step(self, variables: Variables, *batch, rng=None):
        """The model's eval-mode outputs on the global ``batch``, as one
        device would return them (split over the ranks, then gathered)."""
        local = self._local(batch)
        with torch.no_grad():
            return self._gather_outputs(self.eval_local(variables, *local, rng=rng),
                                        _leading(local), rows_whole=True)

    # -- state ----------------------------------------------------------------
    def resize(self, devices: Sequence) -> mesh_mod.Mesh:
        """Elastic mesh shrink/regrow is the elastic supervisor's
        (``resilience/elastic.py``), not ported yet."""
        raise NotImplementedError(
            "DataParallel.resize: elastic training (resilience/elastic.py) is not ported to "
            "paddle_tpu_torch yet; see ROADMAP.md")

    def state_template(self, variables: Variables, opt_state: OptState):
        """The layout of ``(variables, opt_state)`` on this rank — a tree of
        :class:`~paddle_tpu_torch.parallel.sharding.LeafLayout` (the
        optimizer's step stays an int) — the target handed to
        ``checkpoint_sharded.load_sharded`` and the owner map its saves
        read. Replicated leaves are owned by the mesh's first rank; a
        ZeRO-1 slot by the first rank of each data block, for its rows; a
        parameter split over any axes (held or stored) and its slots by the
        first rank of each block, for its window."""
        idx = {a: self._axis_index(a) for a in self.mesh.axis_names}

        def first_but(*axes):
            return all(i == 0 for a, i in idx.items() if a not in axes)

        dims = self._zero_dims(variables.params)
        held, stored = self._blocks(variables.params)
        blocks = {k: held.get(k, []) + stored.get(k, []) for k in {**held, **stored}}
        info = self.model.param_info

        def leaf(name, t):
            if name in blocks:  # its block, on each split dim
                window = block_window(info[name].shape, blocks[name], self.mesh)
                return LeafLayout(info[name].shape, t.dtype, self.device, window,
                                  owner=first_but(*block_axes(blocks[name])))
            return LeafLayout(t.shape, t.dtype, self.device, owner=first_but())

        def slot(name, t):
            if name not in dims:
                return leaf(name, t)
            shape = tuple(variables.params[name].shape)
            n = self.mesh.shape[self.batch_axis]
            d, k, i = dims[name], shape[dims[name]] // n, self._axis_index(self.batch_axis)
            window = [(0, s) for s in shape]
            window[d] = (i * k, (i + 1) * k)
            return LeafLayout(shape, t.dtype, self.device, window,
                              owner=first_but(self.batch_axis))

        var_t = Variables(params={k: leaf(k, t) for k, t in variables.params.items()},
                          state={k: leaf(k, t) for k, t in variables.state.items()})
        opt_t = OptState(step=opt_state.step, slots={
            s: {k: slot(k, v) for k, v in d.items()} for s, d in opt_state.slots.items()})
        return var_t, opt_t

    def place_state(self, variables: Variables, opt_state: OptState):
        """Re-place a state tree on this rank: every leaf on its device, a
        whole parameter split over any axes (and its slots) cut to this
        rank's block, and under ZeRO-1 a whole slot cut to this rank's
        rows."""
        variables = tree_mod.map_leaves(lambda t: t.to(self.device), variables)
        held, stored = self._blocks(variables.params)
        if held or stored:
            info = self.model.param_info

            def block(name, t):
                dims = held.get(name, []) + stored.get(name, [])
                if not dims or tuple(t.shape) != tuple(info[name].shape):
                    return t
                return cut_block(t, dims, self.mesh)

            variables = Variables(params={k: block(k, t) for k, t in variables.params.items()},
                                  state=variables.state)
            opt_state = OptState(step=opt_state.step, slots={
                s: {k: block(k, v) for k, v in d.items()} for s, d in opt_state.slots.items()})
        return variables, self._shard_slots(opt_state, variables.params)

    def full_state(self, variables: Variables, opt_state: OptState):
        """The state with every ZeRO-1 slot gathered whole and every
        parameter split over any axes (and its slots) gathered over them (a
        collective: every rank calls it) — what a plain-format checkpoint
        holds."""
        dims = self._zero_dims(variables.params)
        held, stored = self._blocks(variables.params)
        blocks = {k: held.get(k, []) + stored.get(k, []) for k in {**held, **stored}}
        if not dims and not blocks:
            return variables, opt_state
        split = {**{k: [(d, self.batch_axis)] for k, d in dims.items()}, **blocks}

        def whole(tree):
            cut = {k: t for k, t in tree.items() if k in blocks or (
                k in dims and t.shape != variables.params[k].shape)}
            return {**tree, **gather_blocks(cut, split, self.mesh)}

        slots = {s: whole(d) for s, d in opt_state.slots.items()}
        params = whole(variables.params)
        return Variables(params=params, state=variables.state), OptState(step=opt_state.step,
                                                                         slots=slots)


def _leading(batch) -> int:
    """The leading dim of a batch's first arg (0 for a scalar)."""
    return int(batch[0].shape[0]) if batch and batch[0].dim() else 0
