"""Ops: plain PyTorch functions on tensors, and the hand-written CUDA kernels
under :mod:`paddle_tpu_torch.ops.cuda`."""

from paddle_tpu_torch.ops import attention, cuda, math, nn  # noqa: F401
