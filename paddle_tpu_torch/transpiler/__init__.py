"""Program-to-program rewrites, port of ``paddle_tpu.transpiler``:
automatic mixed precision (:mod:`.amp`), rematerialization policies
(:mod:`.memory`), BN folding for eval (:mod:`.inference`) and the
distributed wiring (:mod:`.distributed`)."""

from paddle_tpu_torch.transpiler import amp, distributed, inference, memory  # noqa: F401
from paddle_tpu_torch.transpiler.amp import (  # noqa: F401
    DynamicLossScale,
    amp_minimize,
    cast_params,
)
from paddle_tpu_torch.transpiler.distributed import (  # noqa: F401
    DistributedRole,
    DistributeTranspiler,
    parse_cluster_env,
)
from paddle_tpu_torch.transpiler.inference import fuse_batch_norm, inference_optimize  # noqa: F401
from paddle_tpu_torch.transpiler.memory import memory_optimize, release_memory  # noqa: F401

__all__ = ["amp", "memory", "inference", "distributed", "DynamicLossScale", "amp_minimize",
           "cast_params", "DistributedRole", "DistributeTranspiler", "parse_cluster_env",
           "inference_optimize", "fuse_batch_norm", "memory_optimize", "release_memory"]
