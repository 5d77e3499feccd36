"""Core runtime: flags and devices, dtypes, enforcement, naming, logging,
locks, retries and the metrics registry."""

from paddle_tpu_torch.core import (  # noqa: F401
    config, dtypes, enforce, locks, logging, profiler, retry, unique_name,
)
from paddle_tpu_torch.core import logging as ptlog  # noqa: F401  (the JAX package's name)
