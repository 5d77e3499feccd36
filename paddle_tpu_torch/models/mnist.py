"""MNIST conv net (recognize_digits) — port of ``paddle_tpu/models/mnist.py``.

Reference: ``benchmark/fluid/models/mnist.py`` (cnn_model: two
simple_img_conv_pool blocks then fc softmax, Adam lr=0.001) and the book test
``python/paddle/fluid/tests/book/test_recognize_digits.py``.
"""

from __future__ import annotations

import numpy as np
import torch

from paddle_tpu_torch import layers, nets, optimizer
from paddle_tpu_torch.core.config import resolve_device
from paddle_tpu_torch.framework import build
from paddle_tpu_torch.models import ModelSpec

IMG_SHAPE = (28, 28, 1)  # NHWC (reference feeds NCHW [1,28,28])
NUM_CLASSES = 10


def cnn_model(images, labels):
    """Forward: images [B,28,28,1] float, labels [B] int32 →
    (avg_loss, accuracy, logits)."""
    conv1 = nets.simple_img_conv_pool(
        images, num_filters=20, filter_size=5, pool_size=2, pool_stride=2, act="relu"
    )
    conv2 = nets.simple_img_conv_pool(
        conv1, num_filters=50, filter_size=5, pool_size=2, pool_stride=2, act="relu"
    )
    logits = layers.fc(conv2, size=NUM_CLASSES)
    loss = layers.softmax_with_cross_entropy(logits, labels)
    avg_loss = layers.reduce_mean(loss)
    acc = layers.accuracy(logits, labels)
    return avg_loss, acc, logits


def get_model(learning_rate: float = 0.001, device="cuda", **_unused) -> ModelSpec:
    """``device`` (default CUDA; raises if CUDA is absent unless
    ``device="cpu"``) is where ``synth_batch`` puts its tensors."""
    dev = resolve_device(device)

    def synth_batch(batch_size: int, rng: np.random.RandomState):
        images = rng.rand(batch_size, *IMG_SHAPE).astype(np.float32)
        labels = rng.randint(0, NUM_CLASSES, size=(batch_size,)).astype(np.int32)
        return torch.as_tensor(images, device=dev), torch.as_tensor(labels, device=dev)

    return ModelSpec(
        name="mnist",
        model=build(cnn_model, name="mnist"),
        synth_batch=synth_batch,
        optimizer=lambda: optimizer.Adam(learning_rate=learning_rate),
        unit="images/sec",
        extra={"device": dev},
    )
