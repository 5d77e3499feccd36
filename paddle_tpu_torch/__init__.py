"""paddle_tpu_torch — the PyTorch/CUDA port of ``paddle_tpu``.

A second package beside the JAX one, for one NVIDIA H100 (Hopper,
``sm_90a``): plain tensor code is PyTorch, and every Pallas TPU kernel the
port reaches is a hand-written CUDA C++ kernel under ``csrc/``, built with
``nvcc`` at first use. It imports ``torch`` and never ``jax`` or
``paddle_tpu``; the JAX package is the reference it is tested against
(same parameter names, same inputs, outputs compared with a tolerance).

Entry points run on CUDA unless the caller passes ``device="cpu"`` (or
``place="cpu"``). Ported so far: the serving slice —
``models.get_model("transformer_lm")`` → ``Model.init`` →
``models.transformer_lm.generate`` with flash-attention prefill — the
training slice — ``Model.init`` → ``spec.optimizer().minimize(spec.model)``
steps with the flash-attention forward and backward kernels — and the
trainer slice — ``trainer.Trainer(...).train(num_epochs, event_handler,
reader)`` through the ``executor.Executor``, with CRC'd checkpoints in the
JAX package's format and auto-resume, on the LM and the MNIST conv net —
and data parallelism: ``parallel.DataParallel`` and
``Trainer(parallel=True)`` over ``torch.distributed`` (one rank per card,
NCCL; gloo on the CPU), ZeRO-1, and sharded/async checkpoints
(``checkpoint_sharded``) in the JAX package's format — and the
inference-deployment slice: ``serving.ServingEngine`` (micro-batching over
shape buckets, replicas behind breakers) and ``Inferencer``,
``io.save_inference_model``/``load_inference_model`` (a ``torch.export``
program that calls the flash kernel through the operator
``paddle_tpu_torch::flash_fwd``), BN folding for eval
(``transpiler.inference``), remat policies (``transpiler.memory``) and the
``fluid_benchmark`` CLI (``python -m paddle_tpu_torch.benchmark``) — and
the Fluid op and layer catalog (``layers``, ``nets`` and ``ops``: math, nn,
control flow, the CRF/CTC losses, 3-D conv, vision) but detection.
"""

from paddle_tpu_torch.version import __version__  # noqa: F401

from paddle_tpu_torch.core import config, dtypes, enforce, unique_name  # noqa: F401
from paddle_tpu_torch.core.enforce import EnforceError, enforce as check  # noqa: F401
from paddle_tpu_torch import framework  # noqa: F401
from paddle_tpu_torch.framework import (  # noqa: F401
    Model,
    ParamAttr,
    Variables,
    build,
    create_parameter,
    name_scope,
)
from paddle_tpu_torch import initializer, layers, models, ops  # noqa: F401
from paddle_tpu_torch import backward, clip, lr_scheduler, optimizer, regularizer  # noqa: F401
from paddle_tpu_torch import (  # noqa: F401
    checkpoint, checkpoint_sharded, dataset, executor, io, metrics, nets, observability, parallel,
    reader, resilience, trainer, transpiler,
)
from paddle_tpu_torch import average, debugger, evaluator, tensor  # noqa: F401
from paddle_tpu_torch.tensor import create_lod_tensor, create_random_int_lodtensor  # noqa: F401
from paddle_tpu_torch.inferencer import Inferencer  # noqa: F401
from paddle_tpu_torch.convert import params_from_jax, params_to_numpy  # noqa: F401
