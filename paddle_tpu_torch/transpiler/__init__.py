"""Program-to-program rewrites — the part of ``paddle_tpu.transpiler`` the
ported slices use: automatic mixed precision (:mod:`.amp`) and the
distributed wiring (:mod:`.distributed`). The memory and inference
transpilers are not ported yet (ROADMAP.md §A)."""

from paddle_tpu_torch.transpiler import amp, distributed  # noqa: F401
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

__all__ = ["amp", "DynamicLossScale", "amp_minimize", "cast_params", "distributed",
           "DistributedRole", "DistributeTranspiler", "parse_cluster_env"]
