"""ResNet (cifar10 / flowers-ImageNet configs) — port of
``paddle_tpu/models/resnet.py``.

Reference: ``benchmark/fluid/models/resnet.py`` — basicblock (cifar10,
ResNet-32-style depth arg) and bottleneck (flowers 224×224, ResNet-50/101/152)
residual towers, conv_bn_layer building block, Momentum(lr=0.01, momentum=0.9).

NHWC throughout, as in the JAX package; the BN moving statistics thread
through ``Model.apply``'s state. Convolutions run on cuDNN (bf16 operands
under ``flags().use_bf16_compute``, f32 activations between layers),
batch norm on PyTorch's fused kernel; parameters stay f32.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from paddle_tpu_torch import layers, optimizer
from paddle_tpu_torch.core.config import resolve_device
from paddle_tpu_torch.core.enforce import enforce
from paddle_tpu_torch.framework import build
from paddle_tpu_torch.models import ModelSpec


def conv_bn_layer(input, ch_out, filter_size, stride, padding, act="relu"):
    """conv → BN(act) with no conv bias (reference resnet.py conv_bn_layer)."""
    conv = layers.conv2d(
        input,
        num_filters=ch_out,
        filter_size=filter_size,
        stride=stride,
        padding=padding,
        act=None,
        bias_attr=False,
    )
    return layers.batch_norm(conv, act=act)


def shortcut(input, ch_out, stride):
    ch_in = input.shape[-1]
    if ch_in != ch_out or stride != 1:
        return conv_bn_layer(input, ch_out, 1, stride, 0, act=None)
    return input


def basicblock(input, ch_out, stride):
    short = shortcut(input, ch_out, stride)
    conv1 = conv_bn_layer(input, ch_out, 3, stride, 1)
    conv2 = conv_bn_layer(conv1, ch_out, 3, 1, 1, act=None)
    return layers.relu(conv2 + short)


def bottleneck(input, ch_out, stride):
    short = shortcut(input, ch_out * 4, stride)
    conv1 = conv_bn_layer(input, ch_out, 1, 1, 0)
    conv2 = conv_bn_layer(conv1, ch_out, 3, stride, 1)
    conv3 = conv_bn_layer(conv2, ch_out * 4, 1, 1, 0, act=None)
    return layers.relu(conv3 + short)


def layer_warp(block_func, input, ch_out, count, stride):
    res = block_func(input, ch_out, stride)
    for _ in range(count - 1):
        res = block_func(res, ch_out, 1)
    return res


RESNET_IMAGENET_CFG = {
    18: ([2, 2, 2, 2], basicblock),
    34: ([3, 4, 6, 3], basicblock),
    50: ([3, 4, 6, 3], bottleneck),
    101: ([3, 4, 23, 3], bottleneck),
    152: ([3, 8, 36, 3], bottleneck),
}


def resnet_imagenet(images, class_dim=1000, depth=50):
    """Bottleneck tower for 224×224 inputs (reference resnet.py
    resnet_imagenet)."""
    enforce(depth in RESNET_IMAGENET_CFG, f"unsupported resnet depth {depth}")
    stages, block_func = RESNET_IMAGENET_CFG[depth]
    conv1 = conv_bn_layer(images, ch_out=64, filter_size=7, stride=2, padding=3)
    pool1 = layers.pool2d(conv1, pool_size=3, pool_stride=2, pool_padding=1, pool_type="max")
    res1 = layer_warp(block_func, pool1, 64, stages[0], 1)
    res2 = layer_warp(block_func, res1, 128, stages[1], 2)
    res3 = layer_warp(block_func, res2, 256, stages[2], 2)
    res4 = layer_warp(block_func, res3, 512, stages[3], 2)
    pool2 = layers.pool2d(res4, pool_size=7, pool_stride=1, global_pooling=True, pool_type="avg")
    return layers.fc(pool2, size=class_dim)


def resnet_cifar10(images, class_dim=10, depth=32):
    """Basic-block tower for 32×32 inputs (reference resnet.py
    resnet_cifar10)."""
    enforce((depth - 2) % 6 == 0, "cifar resnet depth must be 6n+2")
    n = (depth - 2) // 6
    conv1 = conv_bn_layer(images, ch_out=16, filter_size=3, stride=1, padding=1)
    res1 = layer_warp(basicblock, conv1, 16, n, 1)
    res2 = layer_warp(basicblock, res1, 32, n, 2)
    res3 = layer_warp(basicblock, res2, 64, n, 2)
    pool = layers.pool2d(res3, pool_size=8, pool_stride=1, global_pooling=True, pool_type="avg")
    return layers.fc(pool, size=class_dim)


def _forward(images, labels, *, net, class_dim):
    logits = net(images, class_dim=class_dim)
    loss = layers.softmax_with_cross_entropy(logits, labels)
    avg_loss = layers.reduce_mean(loss)
    acc = layers.accuracy(logits, labels)
    return avg_loss, acc, logits


def get_model(
    dataset: str = "flowers",
    depth: int = 50,
    class_dim: int = None,
    learning_rate: float = 0.01,
    image_size: int = None,
    dtype: str = "float32",
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
        net = functools.partial(resnet_cifar10, depth=depth if depth != 50 else 32)
    else:
        class_dim = class_dim or (102 if dataset == "flowers" else 1000)
        image_size = image_size or 224
        net = functools.partial(resnet_imagenet, depth=depth)

    model = build(
        functools.partial(_forward, net=net, class_dim=class_dim),
        name=f"resnet{depth}_{dataset}",
    )

    np_dtype = np.dtype(dtype) if dtype != "bfloat16" else np.float32

    def synth_batch(batch_size: int, rng: np.random.RandomState):
        images = rng.rand(batch_size, image_size, image_size, 3).astype(np_dtype)
        labels = rng.randint(0, class_dim, size=(batch_size,)).astype(np.int32)
        return torch.as_tensor(images, device=dev), torch.as_tensor(labels, device=dev)

    return ModelSpec(
        name=f"resnet{depth}",
        model=model,
        synth_batch=synth_batch,
        optimizer=lambda: optimizer.Momentum(learning_rate=learning_rate, momentum=0.9),
        unit="images/sec",
        extra={"class_dim": class_dim, "image_size": image_size, "device": dev},
    )
