"""Parallelism: rank meshes, collectives, data, sequence and expert
parallelism — port of ``paddle_tpu/parallel``.

Reference: ``framework/parallel_executor.cc:134`` (ParallelExecutor),
``platform/nccl_helper.h:81`` (NCCLContextMap) and the gen_nccl_id
bootstrap (``operators/gen_nccl_id_op.cc:31``).

One rank is one process on one card (``torch.distributed``: NCCL on CUDA,
gloo on the CPU); a :class:`~paddle_tpu_torch.parallel.mesh.Mesh` names
axes over the ranks. Ported: the mesh, the collectives (``ppermute`` and
``all_to_all`` point to point), the sharding spec arithmetic and placement
read from the specs (held blocks over ``expert`` and ``model``, stored
blocks over any other axes), ``DataParallel`` (with ZeRO-1) on any mesh
and spec the JAX package's GSPMD runs, the global-batch context its step
runs in, the mixture-of-experts layer (``moe``: ``moe_ffn``,
``switch_gate``, ``top2_gate``, ``MoEOutput``) and the GPipe schedule
(``pipeline``: ``pipeline_apply``, ``stack_stage_params``,
``split_microbatches``). Not ported yet, raising ``NotImplementedError``
naming ``ROADMAP.md``: ``DataParallel.resize`` (elastic training).
"""

from paddle_tpu_torch.parallel import context  # noqa: F401  (first: ops/nn.py imports it)
from paddle_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    EXPERT_AXIS,
    MODEL_AXIS,
    PIPE_AXIS,
    SEQ_AXIS,
    TP_AXIS,
    Mesh,
    default_mesh,
    initialize_distributed,
    make_mesh,
    partition_devices,
    remesh,
    shutdown_distributed,
    tp_submesh,
)
from paddle_tpu_torch.parallel import collective  # noqa: F401
from paddle_tpu_torch.parallel.sharding import (
    LeafLayout,
    NamedSharding,
    P,
    batch_sharding,
    degrade_spec,
    param_shardings,
    replicated,
    shard_variables,
    spec_for,
)
from paddle_tpu_torch.parallel.data_parallel import DataParallel
from paddle_tpu_torch.parallel.moe import MoEOutput, moe_ffn, switch_gate, top2_gate
from paddle_tpu_torch.parallel.pipeline import (
    pipeline_apply,
    split_microbatches,
    stack_stage_params,
)

__all__ = [
    "make_mesh",
    "default_mesh",
    "initialize_distributed",
    "shutdown_distributed",
    "partition_devices",
    "tp_submesh",
    "remesh",
    "Mesh",
    "DATA_AXIS",
    "MODEL_AXIS",
    "SEQ_AXIS",
    "PIPE_AXIS",
    "EXPERT_AXIS",
    "TP_AXIS",
    "collective",
    "context",
    "degrade_spec",
    "param_shardings",
    "replicated",
    "batch_sharding",
    "shard_variables",
    "spec_for",
    "P",
    "NamedSharding",
    "LeafLayout",
    "DataParallel",
    "moe_ffn",
    "switch_gate",
    "top2_gate",
    "MoEOutput",
    "pipeline_apply",
    "stack_stage_params",
    "split_microbatches",
]
