"""Distributed topology wiring — the DistributeTranspiler successor, port of
``paddle_tpu/transpiler/distributed.py``.

Reference: ``python/paddle/fluid/transpiler/distribute_transpiler.py:142``
(transpile(trainer_id, pservers, trainers, sync_mode) rewriting programs into
send/recv + listen_and_serv) and the NCCL2 mode (``:193`` config with
trainers/trainer_id for multi-node allreduce), wired from env vars
(``trainer.py:229-295`` PADDLE_TRAINING_ROLE/PADDLE_PSERVER_IPS/
PADDLE_TRAINERS/PADDLE_TRAINER_ID).

There are no pserver programs — dense training uses collectives over the
mesh (the nccl2 path is the surviving analogue). What is left of
"transpilation" is joining the process group from the same PADDLE_* env
contract (:func:`~paddle_tpu_torch.parallel.mesh.initialize_distributed`,
one rank per card) and building a mesh whose data axis spans the ranks.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, Optional

from paddle_tpu_torch.core import logging as ptlog
from paddle_tpu_torch.core.enforce import enforce
from paddle_tpu_torch.parallel import mesh as mesh_mod

__all__ = ["DistributedRole", "DistributeTranspiler", "parse_cluster_env"]


@dataclass
class DistributedRole:
    """Parsed cluster wiring (the env contract of trainer.py:229-295)."""

    trainer_id: int = 0
    num_trainers: int = 1
    coordinator: Optional[str] = None
    role: str = "TRAINER"

    @property
    def is_chief(self) -> bool:
        return self.trainer_id == 0


def parse_cluster_env(env: Optional[Dict[str, str]] = None) -> DistributedRole:
    """Read the PADDLE_* env contract. PSERVER roles are rejected: the dense
    path has no parameter server."""
    env = dict(os.environ if env is None else env)
    role = env.get("PADDLE_TRAINING_ROLE", "TRAINER").upper()
    enforce(
        role != "PSERVER",
        "parameter-server mode is not part of the framework: dense "
        "training uses mesh collectives (update_method='collective')",
    )
    coordinator = env.get("PADDLE_COORDINATOR_ADDR")
    if coordinator is None:
        # reference nccl2 mode used PADDLE_TRAINER_ENDPOINTS with trainer 0
        # as the id broadcaster (gen_nccl_id); rank 0 is the coordinator
        endpoints = env.get("PADDLE_TRAINER_ENDPOINTS", "")
        if endpoints:
            coordinator = endpoints.split(",")[0].strip()
    return DistributedRole(
        trainer_id=int(env.get("PADDLE_TRAINER_ID", "0")),
        num_trainers=int(env.get("PADDLE_TRAINERS", env.get("PADDLE_TRAINERS_NUM", "1"))),
        coordinator=coordinator,
        role=role,
    )


class DistributeTranspiler:
    """API-parity shell for the reference transpiler, producing a mesh
    instead of rewritten programs.

    Usage (replaces transpile(...) + get_trainer_program()):

        t = DistributeTranspiler()
        t.transpile(trainer_id=..., trainers=N)     # joins the process group
        mesh = t.trainer_mesh()                     # data axis over the ranks
    """

    def __init__(self):
        self.role: Optional[DistributedRole] = None
        self._initialized = False

    def transpile(
        self,
        trainer_id: Optional[int] = None,
        pservers: Optional[str] = None,
        trainers: Optional[int] = None,
        sync_mode: bool = True,
        startup_program=None,
        device=None,
    ) -> "DistributeTranspiler":
        """``device`` is passed to ``initialize_distributed`` (default
        CUDA and NCCL; ``"cpu"`` for gloo) when there is more than one
        trainer and no process group yet."""
        enforce(pservers is None, "pserver mode unsupported (dense/collective only)")
        enforce(sync_mode, "async SGD unsupported: collectives are synchronous")
        role = parse_cluster_env()
        if trainer_id is not None:
            role.trainer_id = trainer_id
        if trainers is not None:
            role.num_trainers = trainers
        self.role = role
        if role.num_trainers > 1 and not self._initialized and mesh_mod.process_device() is None:
            mesh_mod.initialize_distributed(
                coordinator_address=role.coordinator,
                num_processes=role.num_trainers,
                process_id=role.trainer_id,
                device=device,
            )
            self._initialized = True
        ptlog.vlog(
            0,
            "distribute transpile: trainer %d/%d (coordinator %s)",
            role.trainer_id,
            role.num_trainers,
            role.coordinator,
        )
        return self

    def trainer_mesh(self, model_axis: int = 1, seq_axis: int = 1, **extra_axes: int):
        """Global mesh: the data axis spans the ranks left over by the
        model/seq axes."""
        axes = {mesh_mod.DATA_AXIS: -1}
        if model_axis > 1:
            axes[mesh_mod.MODEL_AXIS] = model_axis
        if seq_axis > 1:
            axes[mesh_mod.SEQ_AXIS] = seq_axis
        axes.update(extra_axes)
        return mesh_mod.make_mesh(axes)

    def get_trainer_program(self):
        """API-parity stub: there is no rewritten program — the train step
        runs through DataParallel over the mesh; returns None."""
        return None

    def get_pserver_program(self, *_a, **_k):
        raise NotImplementedError(
            "no parameter server in the framework (dense path; "
            "reference listen_and_serv_op.cc:305 has no counterpart)"
        )
