"""Ops: plain PyTorch functions on tensors, and the hand-written CUDA kernels
under :mod:`paddle_tpu_torch.ops.cuda`."""

from paddle_tpu_torch.ops import (  # noqa: F401
    attention, control_flow, cuda, losses, math, nn, nn3d, rnn, sequence, vision,
)
