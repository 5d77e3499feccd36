"""Parameter initializers.

Port of ``paddle_tpu/initializer.py`` (reference
``python/paddle/fluid/initializer.py``): callables
``(generator, shape, dtype, device) -> tensor``. Values are drawn on the CPU
from the ``torch.Generator`` the framework passes, then moved to the
device, so a seed gives the same parameters on every device. They are not
the JAX package's values (a ``torch.Generator`` is not a JAX key); tests
that compare the two packages carry weights across with
:mod:`paddle_tpu_torch.convert`.
"""

from __future__ import annotations

import contextlib
import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch


def _fan_in_out(shape: Tuple[int, ...]) -> Tuple[int, int]:
    # reference initializer.py _compute_fans: matrices are [in, out]; conv
    # weights [H, W, Cin, Cout] multiply both fans by the receptive field
    if len(shape) < 1:
        return 1, 1
    if len(shape) == 1:
        return shape[0], shape[0]
    if len(shape) == 2:
        return shape[0], shape[1]
    receptive = int(np.prod(shape[:-2]))
    return shape[-2] * receptive, shape[-1] * receptive


class Initializer:
    def __call__(self, generator: torch.Generator, shape: Sequence[int], dtype, device) -> torch.Tensor:
        raise NotImplementedError


class Constant(Initializer):
    def __init__(self, value: float = 0.0):
        self.value = value

    def __call__(self, generator, shape, dtype, device):
        return torch.full(tuple(shape), self.value, dtype=dtype, device=device)


class Uniform(Initializer):
    def __init__(self, low: float = -1.0, high: float = 1.0):
        self.low, self.high = low, high

    def __call__(self, generator, shape, dtype, device):
        x = torch.rand(tuple(shape), generator=generator, dtype=torch.float32)
        return (self.low + (self.high - self.low) * x).to(device=device, dtype=dtype)


class Normal(Initializer):
    def __init__(self, loc: float = 0.0, scale: float = 1.0):
        self.loc, self.scale = loc, scale

    def __call__(self, generator, shape, dtype, device):
        x = torch.randn(tuple(shape), generator=generator, dtype=torch.float32)
        return (self.loc + self.scale * x).to(device=device, dtype=dtype)


class TruncatedNormal(Initializer):
    """``loc + scale * x`` with ``x`` a standard normal truncated to
    [-2, 2], as ``jax.random.truncated_normal(key, -2, 2)``."""

    def __init__(self, loc: float = 0.0, scale: float = 1.0):
        self.loc, self.scale = loc, scale

    def __call__(self, generator, shape, dtype, device):
        x = torch.empty(tuple(shape), dtype=torch.float32)
        torch.nn.init.trunc_normal_(x, 0.0, 1.0, -2.0, 2.0, generator=generator)
        return (self.loc + self.scale * x).to(device=device, dtype=dtype)


class Xavier(Initializer):
    """Glorot init (reference XavierInitializer): uniform or normal scaled by
    fan_in+fan_out."""

    def __init__(self, uniform: bool = True, fan_in: Optional[int] = None, fan_out: Optional[int] = None):
        self.uniform = uniform
        self.fan_in, self.fan_out = fan_in, fan_out

    def __call__(self, generator, shape, dtype, device):
        fin, fout = _fan_in_out(tuple(shape))
        fin = self.fan_in or fin
        fout = self.fan_out or fout
        if self.uniform:
            limit = math.sqrt(6.0 / (fin + fout))
            x = torch.rand(tuple(shape), generator=generator, dtype=torch.float32) * (2 * limit) - limit
        else:
            std = math.sqrt(2.0 / (fin + fout))
            x = std * torch.randn(tuple(shape), generator=generator, dtype=torch.float32)
        return x.to(device=device, dtype=dtype)


class MSRA(Initializer):
    """He init (reference MSRAInitializer), fan_in scaled."""

    def __init__(self, uniform: bool = True, fan_in: Optional[int] = None):
        self.uniform = uniform
        self.fan_in = fan_in

    def __call__(self, generator, shape, dtype, device):
        fin, _ = _fan_in_out(tuple(shape))
        fin = self.fan_in or fin
        if self.uniform:
            limit = math.sqrt(6.0 / fin)
            x = torch.rand(tuple(shape), generator=generator, dtype=torch.float32) * (2 * limit) - limit
        else:
            std = math.sqrt(2.0 / fin)
            x = std * torch.randn(tuple(shape), generator=generator, dtype=torch.float32)
        return x.to(device=device, dtype=dtype)


class Bilinear(Initializer):
    """Bilinear upsampling kernel for conv_transpose (reference
    BilinearInitializer) — weight shape [H, W, Cin, Cout] NHWC: the same
    filter on each channel's diagonal, zeros elsewhere. Deterministic."""

    def __call__(self, generator, shape, dtype, device):
        shape = tuple(shape)
        if len(shape) != 4:
            raise ValueError("Bilinear initializer expects a 4-D conv weight")
        h, w = shape[0], shape[1]
        f = math.ceil(w / 2.0)
        c = (2 * f - 1 - f % 2) / (2.0 * f)
        filt = (1 - np.abs(np.arange(h) / f - c))[:, None] * (1 - np.abs(np.arange(w) / f - c))[None, :]
        weight = np.zeros(shape, dtype=np.float32)
        for i in range(min(shape[2], shape[3])):
            weight[:, :, i, i] = filt
        return torch.from_numpy(weight).to(device=device, dtype=dtype)


# Fluid-style aliases
ConstantInitializer = Constant
UniformInitializer = Uniform
NormalInitializer = Normal
TruncatedNormalInitializer = TruncatedNormal
XavierInitializer = Xavier
MSRAInitializer = MSRA
BilinearInitializer = Bilinear


# -- init placement hints (reference initializer.py:32-66) -------------------
_force_init_on_cpu = False


def force_init_on_cpu() -> bool:
    """Reference ``initializer.py:32``: query the init-on-CPU flag. A hint
    only here: every initializer already draws its values on the CPU (so a
    seed gives the same parameters on every device) and then moves them."""
    return _force_init_on_cpu


@contextlib.contextmanager
def init_on_cpu():
    """Reference ``initializer.py:49``: run initializers under the CPU-init
    hint (see :func:`force_init_on_cpu`)."""
    global _force_init_on_cpu
    prev = _force_init_on_cpu
    _force_init_on_cpu = True
    try:
        yield
    finally:
        _force_init_on_cpu = prev
