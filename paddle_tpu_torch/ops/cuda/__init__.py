"""Hand-written CUDA C++ kernels for Hopper (``sm_90a``) and their wrappers.

The counterpart of ``paddle_tpu.ops.pallas``: every Pallas TPU kernel the
port reaches becomes a kernel here. Each wrapper launches its kernel for
CUDA tensors (or raises) and runs its plain PyTorch version for CPU tensors.
"""

from paddle_tpu_torch.ops.cuda.build import KERNELS, build_all  # noqa: F401
from paddle_tpu_torch.ops.cuda.flash_attention import (  # noqa: F401
    FLASH_BWD_DKV,
    FLASH_BWD_DQ,
    FLASH_FWD,
    fit_block,
    flash_attention,
    flash_attention_bwd_block,
    flash_attention_with_lse,
    resolve_blocks,
    tuned_blocks,
)
