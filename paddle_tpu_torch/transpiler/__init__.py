"""Program-to-program rewrites — the part of ``paddle_tpu.transpiler`` the
ported slices use: automatic mixed precision (:mod:`.amp`). The memory,
inference and distributed transpilers are not ported yet (ROADMAP.md §A)."""

from paddle_tpu_torch.transpiler import amp  # noqa: F401
from paddle_tpu_torch.transpiler.amp import (  # noqa: F401
    DynamicLossScale,
    amp_minimize,
    cast_params,
)

__all__ = ["amp", "DynamicLossScale", "amp_minimize", "cast_params"]
