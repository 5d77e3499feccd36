"""Ops: plain PyTorch functions on tensors, and the hand-written CUDA kernels
under :mod:`paddle_tpu_torch.ops.cuda`.

As in the JAX package, the functions of ``math``, ``nn``, ``control_flow``,
``losses``, ``detection`` and ``quant`` are also names of this package
(``ops.relu is ops.math.relu``), and ``__all__`` is the JAX package's: those
modules' ``__all__`` in that order, then the submodule names.
"""

from paddle_tpu_torch.ops.math import *  # noqa: F401,F403
from paddle_tpu_torch.ops.nn import *  # noqa: F401,F403
from paddle_tpu_torch.ops.control_flow import *  # noqa: F401,F403
from paddle_tpu_torch.ops.losses import *  # noqa: F401,F403
from paddle_tpu_torch.ops.detection import *  # noqa: F401,F403
from paddle_tpu_torch.ops.quant import *  # noqa: F401,F403
from paddle_tpu_torch.ops import (  # noqa: F401
    attention, control_flow, cuda, detection, detection_rpn, losses, math, nn, nn3d, quant,
    ring_attention, rnn, sequence, vision,
)

__all__ = (
    list(math.__all__)
    + list(nn.__all__)
    + list(control_flow.__all__)
    + list(losses.__all__)
    + list(detection.__all__)
    + list(quant.__all__)
    + ["math", "nn", "rnn", "sequence", "attention", "ring_attention", "control_flow", "losses",
       "detection", "quant"]
)
