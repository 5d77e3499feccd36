"""SE-ResNeXt (50/101/152) — grouped convolutions + squeeze-and-excitation;
port of ``paddle_tpu/models/se_resnext.py``.

Reference: ``benchmark/fluid/models/se_resnext.py`` — bottleneck_block with
cardinality-32 grouped 3×3 conv, squeeze_excitation (global pool → fc/r →
fc sigmoid scale), reduction_ratio 16, three-conv stem for depth 152,
Momentum + piecewise-decay LR. The grouped conv is cuDNN's
(``groups=cardinality``); the head's dropout draws from the apply's
``rng`` in training mode.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from paddle_tpu_torch import layers, lr_scheduler, optimizer, regularizer
from paddle_tpu_torch.core.config import resolve_device
from paddle_tpu_torch.core.enforce import enforce
from paddle_tpu_torch.framework import build
from paddle_tpu_torch.models import ModelSpec


def conv_bn_layer(input, num_filters, filter_size, stride=1, groups=1, act=None):
    conv = layers.conv2d(
        input,
        num_filters=num_filters,
        filter_size=filter_size,
        stride=stride,
        padding=(filter_size - 1) // 2,
        groups=groups,
        act=None,
        bias_attr=False,
    )
    return layers.batch_norm(conv, act=act)


def squeeze_excitation(input, num_channels, reduction_ratio):
    pool = layers.pool2d(input, pool_size=0, pool_type="avg", global_pooling=True)
    squeeze = layers.fc(pool, size=num_channels // reduction_ratio, act="relu")
    excitation = layers.fc(squeeze, size=num_channels, act="sigmoid")
    return input * excitation[:, None, None, :]


def shortcut(input, ch_out, stride):
    ch_in = input.shape[-1]
    if ch_in != ch_out or stride != 1:
        return conv_bn_layer(input, ch_out, 1, stride)
    return input


def bottleneck_block(input, num_filters, stride, cardinality, reduction_ratio):
    conv0 = conv_bn_layer(input, num_filters, 1, act="relu")
    conv1 = conv_bn_layer(conv0, num_filters, 3, stride=stride, groups=cardinality, act="relu")
    conv2 = conv_bn_layer(conv1, num_filters * 2, 1, act=None)
    scale = squeeze_excitation(conv2, num_filters * 2, reduction_ratio)
    short = shortcut(input, num_filters * 2, stride)
    return layers.relu(short + scale)


def se_resnext(images, class_dim=1000, layers_depth=50):
    cardinality = 64 if layers_depth == 152 else 32
    reduction_ratio = 16
    cfg = {
        50: ([3, 4, 6, 3], [128, 256, 512, 1024]),
        101: ([3, 4, 23, 3], [128, 256, 512, 1024]),
        152: ([3, 8, 36, 3], [128, 256, 512, 1024]),
    }
    enforce(layers_depth in cfg, f"unsupported se_resnext depth {layers_depth}")
    depth, num_filters = cfg[layers_depth]

    if layers_depth == 152:
        conv = conv_bn_layer(images, 64, 3, stride=2, act="relu")
        conv = conv_bn_layer(conv, 64, 3, act="relu")
        conv = conv_bn_layer(conv, 128, 3, act="relu")
    else:
        conv = conv_bn_layer(images, 64, 7, stride=2, act="relu")
    conv = layers.pool2d(conv, pool_size=3, pool_stride=2, pool_padding=1, pool_type="max")

    for block in range(len(depth)):
        for i in range(depth[block]):
            conv = bottleneck_block(
                conv,
                num_filters=num_filters[block],
                stride=2 if i == 0 and block != 0 else 1,
                cardinality=cardinality,
                reduction_ratio=reduction_ratio,
            )

    pool = layers.pool2d(conv, pool_size=7, pool_type="avg", global_pooling=True)
    drop = layers.dropout(pool, dropout_prob=0.2)
    return layers.fc(drop, size=class_dim)


def _forward(images, labels, *, class_dim, depth):
    logits = se_resnext(images, class_dim=class_dim, layers_depth=depth)
    loss = layers.softmax_with_cross_entropy(logits, labels)
    avg_loss = layers.reduce_mean(loss)
    acc = layers.accuracy(logits, labels)
    return avg_loss, acc, logits


def get_model(
    depth: int = 50,
    class_dim: int = 102,
    image_size: int = 224,
    learning_rate: float = 0.1,
    batch_size: int = 32,
    device="cuda",
    **_unused,
) -> ModelSpec:
    """The JAX package's config; ``device`` (default CUDA; raises if CUDA
    is absent unless ``device="cpu"``) is where ``synth_batch`` puts its
    tensors."""
    dev = resolve_device(device)
    model = build(
        functools.partial(_forward, class_dim=class_dim, depth=depth),
        name=f"se_resnext{depth}",
    )

    # piecewise decay on epoch boundaries (reference se_resnext.py optimizer)
    epochs = [40, 80, 100]
    total_images = 6149
    step = max(1, int(total_images / batch_size + 1))
    bd = [e * step for e in epochs]
    lr_values = [learning_rate * (0.1 ** i) for i in range(len(bd) + 1)]

    def synth_batch(bs: int, rng: np.random.RandomState):
        images = rng.rand(bs, image_size, image_size, 3).astype(np.float32)
        labels = rng.randint(0, class_dim, size=(bs,)).astype(np.int32)
        return torch.as_tensor(images, device=dev), torch.as_tensor(labels, device=dev)

    return ModelSpec(
        name=f"se_resnext{depth}",
        model=model,
        synth_batch=synth_batch,
        optimizer=lambda: optimizer.Momentum(
            learning_rate=lr_scheduler.PiecewiseDecay(bd, lr_values),
            momentum=0.9,
            regularization=regularizer.L2Decay(1e-4),
        ),
        unit="images/sec",
        extra={"class_dim": class_dim, "image_size": image_size, "device": dev},
    )
