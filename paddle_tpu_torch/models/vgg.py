"""VGG-16 with batch norm (cifar10 / flowers configs) — port of
``paddle_tpu/models/vgg.py``.

Reference: ``benchmark/fluid/models/vgg.py`` — five img_conv_group blocks
(all convs BN+dropout, 3×3 SAME), two dropout+fc(512)+BN head layers, final
fc softmax; Adam(lr=1e-3). Dropout draws from the apply's ``rng`` in
training mode.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from paddle_tpu_torch import layers, nets, optimizer
from paddle_tpu_torch.core.config import resolve_device
from paddle_tpu_torch.framework import build
from paddle_tpu_torch.models import ModelSpec


def vgg16_bn_drop(input):
    def conv_block(ipt, num_filter, groups, dropouts):
        return nets.img_conv_group(
            ipt,
            conv_num_filter=[num_filter] * groups,
            pool_size=2,
            pool_stride=2,
            conv_filter_size=3,
            conv_act="relu",
            conv_with_batchnorm=True,
            conv_batchnorm_drop_rate=dropouts,
            pool_type="max",
        )

    conv1 = conv_block(input, 64, 2, [0.3, 0])
    conv2 = conv_block(conv1, 128, 2, [0.4, 0])
    conv3 = conv_block(conv2, 256, 3, [0.4, 0.4, 0])
    conv4 = conv_block(conv3, 512, 3, [0.4, 0.4, 0])
    conv5 = conv_block(conv4, 512, 3, [0.4, 0.4, 0])

    drop = layers.dropout(conv5, dropout_prob=0.5)
    fc1 = layers.fc(drop, size=512)
    bn = layers.batch_norm(fc1[:, None, None, :], act="relu")[:, 0, 0, :]
    drop2 = layers.dropout(bn, dropout_prob=0.5)
    fc2 = layers.fc(drop2, size=512)
    return fc2


def _forward(images, labels, *, class_dim):
    feat = vgg16_bn_drop(images)
    logits = layers.fc(feat, size=class_dim)
    loss = layers.softmax_with_cross_entropy(logits, labels)
    avg_loss = layers.reduce_mean(loss)
    acc = layers.accuracy(logits, labels)
    return avg_loss, acc, logits


def get_model(
    dataset: str = "cifar10",
    class_dim: int = None,
    image_size: int = None,
    learning_rate: float = 1e-3,
    device="cuda",
    **_unused,
) -> ModelSpec:
    """The JAX package's configs; ``device`` (default CUDA; raises if CUDA
    is absent unless ``device="cpu"``) is where ``synth_batch`` puts its
    tensors."""
    dev = resolve_device(device)
    if dataset == "cifar10":
        class_dim = class_dim or 10
        image_size = image_size or 32
    else:
        class_dim = class_dim or 102
        image_size = image_size or 224

    model = build(functools.partial(_forward, class_dim=class_dim), name=f"vgg16_{dataset}")

    def synth_batch(batch_size: int, rng: np.random.RandomState):
        images = rng.rand(batch_size, image_size, image_size, 3).astype(np.float32)
        labels = rng.randint(0, class_dim, size=(batch_size,)).astype(np.int32)
        return torch.as_tensor(images, device=dev), torch.as_tensor(labels, device=dev)

    return ModelSpec(
        name="vgg16",
        model=model,
        synth_batch=synth_batch,
        optimizer=lambda: optimizer.Adam(learning_rate=learning_rate),
        unit="images/sec",
        extra={"class_dim": class_dim, "image_size": image_size, "device": dev},
    )
