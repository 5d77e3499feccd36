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
the optimizer slots only; see :meth:`DataParallel._zero_apply`.

Sequence and expert parallelism. A mesh may also have a ``seq`` and an
``expert`` axis. With batch specs that split the sequence dim
(``P("data", "seq")``) each rank holds the ``[B/n_data, T/n_seq]`` block of
the batch, and the step runs the model on it in the sequence-sharded
context (positions, attention over the ring or by all-to-all, the MoE
router's global quantities: ``parallel/context.py``). The ranks of an
``expert`` axis hold the same tokens and each its block of the experts
(``parallel/moe.py``).

Tensor and pipeline parallelism. On a ``data × model`` mesh the ranks of a
``model`` group hold the same rows and each its block of every parameter
annotated over ``model`` (Megatron's column- and row-parallel projections,
``layers.fc``, the embedding split over d_model); the layers' conjugate
collectives (``copy_to_axis``/``reduce_from_axis``) leave every gradient
whole on each rank of the group, a block's for its block. On a ``pipe``
axis every rank runs its stage of the model's pipeline
(``parallel/pipeline.py``), whose backward sums the stages' gradients over
``pipe``: every gradient leaves it whole on each stage.

The axes compose as the JAX package's GSPMD composes them:

- ``pipe × model`` (× ``data``): outside the stages the model runs as on
  ``model``; inside them each rank runs its stage on its rows of every
  microbatch (split over ``model``) with the stage's parameters gathered
  whole, and a block's gradient is the rows' sum cut to the block;
- ``seq × model`` (× ``data``): the sequence-sharded step with Megatron's
  projections; the ring or Ulysses runs within the ``seq`` group of the
  ranks that share a ``model`` coordinate, on that rank's heads;
- ``seq × expert`` (× ``data``) as before, and ZeRO-1 beside ``expert``:
  the slots of an expert-sharded parameter keep its blocks, those of a
  replicated one split over ``data`` (the JAX package's rule,
  ``paddle_tpu/parallel/data_parallel.py:221-229``).

Gradients are reduced by placement: a mean over every axis the tokens are
split over (``data``, and ``seq`` when the batch specs split it), never
over ``expert``, ``model`` or ``pipe``, a block's within its block. A norm
clip reads the whole gradients' norms (:meth:`DataParallel._sq_norms`).
Still refused, with ``NotImplementedError`` naming ROADMAP.md (§A item
4c): a ``tp`` axis, ``model`` beside ``expert``, ``pipe`` beside ``seq``
or ``expert``, and batch specs over other axes.
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
    _not_ported,
    block_dims,
    block_window,
    broadcast_tensors,
    cut_block,
    param_shardings,
    shard_variables,
)


# the split axes (beside data) a step may hold together: the JAX package's
# compositions the port runs
_COMPOSED = ((mesh_mod.SEQ_AXIS, mesh_mod.EXPERT_AXIS), (mesh_mod.PIPE_AXIS, mesh_mod.MODEL_AXIS),
             (mesh_mod.SEQ_AXIS, mesh_mod.MODEL_AXIS))


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
        whole to every rank; ``P("data", "seq")`` splits dim 1 over the
        ``seq`` axis too (sequence parallelism). A spec over any other axis
        or dim raises.

        ``zero_shard_optimizer`` (ZeRO-1): the slots of each parameter are
        kept sharded on their first dim divisible by the data-axis size,
        each rank updating its own rows; the reference's Reduce+Broadcast
        BuildStrategy (``multi_devices_graph_pass.cc:397-446``) solved the
        same problem by placing each param's update on one owner device.

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
        big = {a for a, n in self.mesh.shape.items() if n > 1}
        for axis in big:
            if axis not in (batch_axis, mesh_mod.SEQ_AXIS, mesh_mod.EXPERT_AXIS,
                            mesh_mod.MODEL_AXIS, mesh_mod.PIPE_AXIS):
                raise _not_ported(f"DataParallel over mesh axis {axis!r} of size "
                                  f"{self.mesh.shape[axis]}")
        split = big & {mesh_mod.SEQ_AXIS, mesh_mod.EXPERT_AXIS, mesh_mod.MODEL_AXIS,
                       mesh_mod.PIPE_AXIS}
        if not any(split <= set(axes) for axes in _COMPOSED):
            raise _not_ported(f"DataParallel over {sorted(split)} together")
        # the axis each batch dim may split over: rows over data, positions over seq
        dim_axes = (batch_axis, mesh_mod.SEQ_AXIS)
        self._seq_axis = None
        for spec in self.batch_specs or ():
            for dim, entry in enumerate(spec or ()):
                axes = entry if isinstance(entry, tuple) else (entry,)
                if any(a is not None and (dim >= len(dim_axes) or a != dim_axes[dim]
                                          or a not in self.mesh.shape) for a in axes):
                    raise _not_ported(f"batch_specs entry {spec} (only dim 0 over "
                                      f"{batch_axis!r} and dim 1 over 'seq' split)")
                if dim == 1 and entry is not None:
                    self._seq_axis = mesh_mod.SEQ_AXIS
        # the axes this step's tokens are split over, data first
        self._token_axes = (batch_axis,) + ((self._seq_axis,) if self._seq_axis else ())
        if device is None:
            device = mesh_mod.process_device() or "cuda"
        self.device = resolve_device(device)
        self._step_fn = None
        self._ragged_fn = None
        self._batch_rows = 0  # this rank's rows in the running step
        # tensors put_batch returned: already this rank's rows
        self._placed: "weakref.WeakValueDictionary[int, torch.Tensor]" = weakref.WeakValueDictionary()

    # -- the group ------------------------------------------------------------
    @property
    def num_devices(self) -> int:
        return self.mesh.size

    @property
    def _n(self) -> int:
        return self.mesh.shape[self.batch_axis]

    def _group(self):
        return self.mesh.group(self.batch_axis)

    def _index(self) -> int:
        return self._axis_index(self.batch_axis)

    def _axis_index(self, axis: str) -> int:
        return self.mesh.axis_index(axis) if self.mesh.shape.get(axis, 1) > 1 else 0

    def _token_index(self) -> int:
        """This rank's block among the step's token blocks (data-major)."""
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
        (BCastParamsToDevices parity), each rank keeping its block of an
        expert-sharded parameter. Adopted ``variables`` are whole; the
        model's parameter metadata (their shardings) comes from an init on
        the example batch when no init or apply has recorded it yet."""
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

    def _zero_dims(self, params: Dict[str, torch.Tensor]) -> Dict[str, int]:
        """ZeRO-1: the dim each parameter's slots are sharded on — the first
        whose size the data-axis size divides (the JAX package's rule);
        none for an optimizer whose update reads whole parameters, nor for
        a parameter split over ``model`` or ``expert`` (its slots keep its
        layout, as in the JAX package)."""
        if not self.zero_shard_optimizer or not self.optimizer.elementwise:
            return {}
        n, out, blocks = self._n, {}, self._blocks(params)
        for name, p in params.items():
            if name in blocks:
                continue
            for dim, size in enumerate(p.shape):
                if size % n == 0 and size >= n:
                    out[name] = dim
                    break
        return out

    def _rows(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        k = t.shape[dim] // self._n
        return t.narrow(dim, self._index() * k, k)

    def _shard_slots(self, opt_state: OptState, params: Dict[str, torch.Tensor]) -> OptState:
        """Every leaf on this rank's device, and under ZeRO-1 each whole
        slot cut to this rank's rows (a slot already cut is kept)."""
        dims = self._zero_dims(params)

        def place(name, v):
            if name in dims and v.shape == params[name].shape:
                v = self._rows(v, dims[name]).clone()
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
        mesh: LCM over each arg's dim-0 sharding extent."""
        mult = 1
        for s in self._batch_shardings(batch):
            axes = s.spec[0] if len(s.spec) else None
            mult = math.lcm(mult, self._spec_dim_size(axes))
        return mult

    def _spec_dim_size(self, axes) -> int:
        """Total mesh extent a spec entry shards one dim over (1 if None)."""
        if axes is None:
            return 1
        size = 1
        for a in (axes if isinstance(axes, tuple) else (axes,)):
            size *= self.mesh.shape[a]
        return size

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
        parallel_executor.py:173): rows ``[r·B/N, (r+1)·B/N)`` of each split
        arg (and, for an arg whose spec splits dim 1 over ``seq``, this
        rank's segment of each row), a replicated arg whole. ``step`` takes
        these as they are."""
        shards = self._batch_shardings(batch)
        self._validate_batch(batch, shards)
        out = []
        for b, s in zip(batch, shards):
            if len(s.spec) and s.spec[0] is not None:
                b = self.rank_rows(b)
            if len(s.spec) > 1 and s.spec[1] is not None:
                n = self.mesh.shape[self._seq_axis]
                k = np.shape(b)[1] // n
                j = self._axis_index(self._seq_axis)
                b = b[:, j * k:(j + 1) * k]
            t = to_device(b, self.device)
            self._placed[id(t)] = t
            out.append(t)
        return tuple(out)

    def rank_rows(self, b):
        """This rank's rows ``[r·B/N, (r+1)·B/N)`` of one global batch arg
        (a host array or a tensor, sliced where it lies)."""
        k = np.shape(b)[0] // self._n
        return b[self._index() * k:(self._index() + 1) * k]

    def _local(self, batch) -> tuple:
        """``batch`` as this rank's rows: tensors from :meth:`put_batch` as
        they are, a global batch split."""
        if batch and all(self._placed.get(id(b)) is b for b in batch):
            return tuple(batch)
        return self.put_batch(*batch)

    def pad_batch(self, *batch, to: Optional[int] = None):
        """Pad a (possibly ragged) batch's leading dim up to ``to`` — or the
        next data-axis multiple — by repeating the final row; returns
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
    def _mean(self, tensors: List[torch.Tensor]) -> List[torch.Tensor]:
        """The mean over the step's token blocks of each tensor: one
        all-reduce of a flat f32 buffer holding them all per axis the tokens
        are split over (identities on one rank without a process group)."""
        group = self._batch_group()
        if group.group is None or not tensors:
            return list(tensors)
        flat = torch.cat([t.detach().float().reshape(-1) for t in tensors])
        group.all_reduce_(flat).div_(group.size)
        out, off = [], 0
        for t in tensors:
            n = t.numel()
            out.append(flat[off:off + n].view(t.shape).to(t.dtype))
            off += n
        return out

    def sum_over_ranks(self, values: Sequence[float]) -> List[float]:
        """Python numbers summed over the group, in float64."""
        group = self._group()
        if group is None:
            return list(values)
        t = torch.tensor(list(values), dtype=torch.float64, device=self.device)
        torch.distributed.all_reduce(t, group=group)
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
        if self._group() is not None:
            with self.mesh, torch.no_grad():
                for i in batch:
                    t = leaves[i].detach()
                    if self._seq_axis is not None and t.dim() > 1 and not rows_whole:
                        # the row segments: positions on dim 1
                        t = collective.all_gather(t, self._seq_axis, axis=1)
                    new[i] = collective.all_gather(t, self.batch_axis)
        return tree_mod.unflatten(outputs, new)

    def _reduce_global(self, loss, grads, new_state, state, outputs):
        """The step's one reduction: the mean over the group of the
        gradients and the loss (one buffer), then the outputs gathered."""
        with torch.no_grad():
            names = list(grads)
            red = self._mean([grads[k] for k in names] + [loss])
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

    # -- ZeRO-1 ---------------------------------------------------------------
    def _zero_apply(self, params, grads, opt_state, param_info):
        """The update under ZeRO-1: regularization and clipping on the whole
        reduced gradients, each rank's rule on its rows of every sharded
        parameter (with its rows of the slots), then one all-gather per
        dtype of the updated rows. Elementwise rules give each row what the
        whole update gives it, so the step equals the step without ZeRO-1."""
        opt = self.optimizer
        grads = opt.prepare_gradients(params, grads, param_info, sq_norms=self._sq_norms)
        dims = self._zero_dims(params)
        rows_p = {k: self._rows(p, dims[k]) if k in dims else p for k, p in params.items()}
        rows_g = {k: self._rows(g, dims[k]) if k in dims else g for k, g in grads.items()}
        new_rows, new_opt = opt.update(rows_p, rows_g, opt_state, param_info)
        new_params = dict(new_rows)
        by_dtype: Dict[torch.dtype, List[str]] = {}
        for k in dims:
            by_dtype.setdefault(new_rows[k].dtype, []).append(k)
        with torch.no_grad(), self.mesh:
            for names in by_dtype.values():
                flat = torch.cat([new_rows[k].reshape(-1) for k in names])
                parts = collective.all_gather(flat, self.batch_axis, axis=0, tiled=False)
                off = 0
                for k in names:
                    shape = new_rows[k].shape
                    n = new_rows[k].numel()
                    new_params[k] = torch.cat(
                        [parts[r, off:off + n].view(shape) for r in range(self._n)], dim=dims[k])
                    off += n
        return new_params, new_opt

    # -- steps ----------------------------------------------------------------
    def _rank_rng(self, rng: Optional[torch.Generator]) -> Optional[torch.Generator]:
        """Each rank's dropout stream: a seed drawn from ``rng`` (the same
        draw on every rank) offset by the rank's token block, so blocks do
        not repeat each other's masks (the ranks of an ``expert`` group,
        which hold the same tokens, draw the same)."""
        if rng is None:
            return None
        seed = int(torch.randint(2 ** 62, (), generator=rng, device=rng.device))
        return torch.Generator(device=rng.device).manual_seed(seed + self._token_index())

    def _apply_fn(self):
        if self.zero_shard_optimizer:
            return self._zero_apply
        if any(self.mesh.shape.get(a, 1) > 1 for a in (mesh_mod.MODEL_AXIS, mesh_mod.EXPERT_AXIS)):
            return self._block_apply
        return None

    def _block_apply(self, params, grads, opt_state, param_info):
        """The update where a rank holds blocks of parameters: clipped by the
        whole gradients' norms."""
        grads = self.optimizer.prepare_gradients(params, grads, param_info,
                                                 sq_norms=self._sq_norms)
        return self.optimizer.update(params, grads, opt_state, param_info)

    def _sq_norms(self, grads: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Each gradient's squared norm, whole: a block's (over ``expert`` or
        ``model``) summed over the axes it is split on, one all-reduce per
        axis (what a norm clip reads, ``clip.py``)."""
        sq = clip_mod.squared_norms(grads)
        by_axis: Dict[str, List[str]] = {}
        for name, dims in self._blocks(grads).items():
            for axis in dict.fromkeys(a for _, a in dims):
                by_axis.setdefault(axis, []).append(name)
        with torch.no_grad(), self.mesh:
            for axis, names in by_axis.items():
                total = collective.all_reduce(torch.stack([sq[k] for k in names]), axis)
                sq.update(zip(names, total))
        return sq

    def step(self, variables: Variables, opt_state: OptState, *batch, rng=None) -> StepOutput:
        """One data-parallel train step on the global ``batch`` (or on what
        :meth:`put_batch` returned for it): this rank's forward and backward
        with the batch reductions made global, the mean of the gradients
        and the loss over the group, the update. Equals the single-device
        step on the global batch."""
        local = self._local(batch)
        if self._step_fn is None:
            self._step_fn = self.optimizer.train_step(
                self.model, self.loss_index, reduce=self._reduce_global, apply=self._apply_fn())
        self._batch_rows = _leading(local)
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
        with self.mesh:
            return self._ragged_fn(variables, opt_state, *whole, rng=rng)

    def eval_local(self, variables: Variables, *local, rng=None):
        """This rank's rows (from :meth:`put_batch`) through the model in
        eval mode, batch reductions global; the outputs stay this rank's
        rows — whole rows under a sequence split: each output with a dim 1
        is gathered over ``seq`` on it (what ``Trainer.evaluate``'s per-row
        metrics read)."""
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

    def _blocks(self, params: Dict[str, torch.Tensor]) -> Dict[str, list]:
        """``{name: [(dim, axis), ...]}`` of each parameter this rank holds a
        block of (experts over ``expert``, a ``model`` split)."""
        shardings = param_shardings(self.mesh, self.model.param_info, params)
        return {k: block_dims(sh) for k, sh in shardings.items() if block_dims(sh)}

    def state_template(self, variables: Variables, opt_state: OptState):
        """The layout of ``(variables, opt_state)`` on this rank — a tree of
        :class:`~paddle_tpu_torch.parallel.sharding.LeafLayout` (the
        optimizer's step stays an int) — the target handed to
        ``checkpoint_sharded.load_sharded`` and the owner map its saves
        read. Replicated leaves are owned by the mesh's first rank; a
        ZeRO-1 slot by the first rank of each data block, for its rows; a
        parameter split over ``expert`` or ``model`` and its slots by the
        first rank of each block, for its window."""
        idx = {a: self._axis_index(a) for a in self.mesh.axis_names}

        def first_but(*axes):
            return all(i == 0 for a, i in idx.items() if a not in axes)

        dims = self._zero_dims(variables.params)
        blocks = self._blocks(variables.params)
        info = self.model.param_info

        def leaf(name, t):
            if name in blocks:  # its block, on each split dim
                window = block_window(info[name].shape, blocks[name], self.mesh)
                return LeafLayout(info[name].shape, t.dtype, self.device, window,
                                  owner=first_but(*(a for _, a in blocks[name])))
            return LeafLayout(t.shape, t.dtype, self.device, owner=first_but())

        def slot(name, t):
            if name not in dims:
                return leaf(name, t)
            shape = tuple(variables.params[name].shape)
            d, k = dims[name], shape[dims[name]] // self._n
            window = [(0, s) for s in shape]
            window[d] = (self._index() * k, (self._index() + 1) * k)
            return LeafLayout(shape, t.dtype, self.device, window,
                              owner=first_but(self.batch_axis))

        var_t = Variables(params={k: leaf(k, t) for k, t in variables.params.items()},
                          state={k: leaf(k, t) for k, t in variables.state.items()})
        opt_t = OptState(step=opt_state.step, slots={
            s: {k: slot(k, v) for k, v in d.items()} for s, d in opt_state.slots.items()})
        return var_t, opt_t

    def place_state(self, variables: Variables, opt_state: OptState):
        """Re-place a state tree on this rank: every leaf on its device, a
        whole parameter split over ``expert`` or ``model`` (and its slots)
        cut to this rank's block, and under ZeRO-1 a whole slot cut to this
        rank's rows."""
        variables = tree_mod.map_leaves(lambda t: t.to(self.device), variables)
        blocks = self._blocks(variables.params)
        if blocks:
            info = self.model.param_info

            def block(name, t):
                if name not in blocks or tuple(t.shape) != tuple(info[name].shape):
                    return t
                return cut_block(t, blocks[name], self.mesh)

            variables = Variables(params={k: block(k, t) for k, t in variables.params.items()},
                                  state=variables.state)
            opt_state = OptState(step=opt_state.step, slots={
                s: {k: block(k, v) for k, v in d.items()} for s, d in opt_state.slots.items()})
        return variables, self._shard_slots(opt_state, variables.params)

    def full_state(self, variables: Variables, opt_state: OptState):
        """The state with every ZeRO-1 slot gathered whole and every
        parameter split over ``expert`` or ``model`` (and its slots)
        gathered over those axes (a collective: every rank calls it) — what
        a plain-format checkpoint holds."""
        dims = self._zero_dims(variables.params)
        blocks = self._blocks(variables.params)
        if not dims and not blocks:
            return variables, opt_state

        def whole(name, t):
            if name in dims and t.shape != variables.params[name].shape:
                t = collective.all_gather(t, self.batch_axis, axis=dims[name])
            for dim, axis in blocks.get(name, ()):
                t = collective.all_gather(t, axis, axis=dim)
            return t

        with torch.no_grad(), self.mesh:
            slots = {s: {k: whole(k, v) for k, v in d.items()} for s, d in opt_state.slots.items()}
            params = {k: whole(k, t) if k in blocks else t for k, t in variables.params.items()}
        return Variables(params=params, state=variables.state), OptState(step=opt_state.step,
                                                                         slots=slots)


def _leading(batch) -> int:
    """The leading dim of a batch's first arg (0 for a scalar)."""
    return int(batch[0].shape[0]) if batch and batch[0].dim() else 0
