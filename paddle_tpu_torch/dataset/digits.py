"""REAL handwritten digits, bundled — no egress required.

The UCI "Optical Recognition of Handwritten Digits" set ships inside
scikit-learn (``sklearn.datasets.load_digits``: 1797 samples, 8x8 grayscale,
10 classes; scikit-learn is imported only when the data is first needed), so
this is the real-data
path the reference's book tests get by downloading MNIST
(``python/paddle/dataset/common.py:33-70`` ``download()``; here the bundled
copy IS the local mirror). First use materializes
``<DATA_HOME>/digits/{train,test}.npz`` through the same cache layout as
every other dataset module, then reads only the cache.

Split: stratified, disjoint 80/20 by per-class order (deterministic — no
RNG, so train/test can never overlap across runs).

Readers yield ``(image, label)``:
- :func:`train` / :func:`test` — image [64] float32 in [-1, 1];
- :func:`train_as_mnist` / :func:`test_as_mnist` — image [784] float32,
  the 8x8 digit nearest-upsampled x3 to 24x24 and zero-padded to 28x28, so
  the stock 28x28 MNIST convnet consumes real data unchanged.

A copy of ``paddle_tpu.dataset.digits``: the same split and cache files.
"""
from __future__ import annotations

import os

import numpy as np

from paddle_tpu_torch.dataset import common

__all__ = ["available", "train", "test", "train_as_mnist", "test_as_mnist"]

NUM_CLASSES = 10


def available() -> bool:
    try:
        import sklearn.datasets  # noqa: F401
        return True
    except ImportError:
        return False


def _materialize() -> None:
    """Write the stratified 80/20 split into the dataset cache (once)."""
    if common.cached_npz("digits", "train") and common.cached_npz("digits", "test"):
        return
    from sklearn.datasets import load_digits

    d = load_digits()
    images = (d.data.astype(np.float32) / 8.0) - 1.0  # 0..16 -> [-1, 1]
    labels = d.target.astype(np.int64)
    train_idx, test_idx = [], []
    for c in range(NUM_CLASSES):
        idx = np.flatnonzero(labels == c)
        cut = int(round(len(idx) * 0.8))
        train_idx.extend(idx[:cut])
        test_idx.extend(idx[cut:])
    os.makedirs(common.data_home("digits"), exist_ok=True)
    for split, sel in (("train", train_idx), ("test", test_idx)):
        # atomic: an interrupted direct write would leave a truncated npz
        # that cached_npz treats as valid forever
        final = common.data_home("digits", f"{split}.npz")
        tmp = f"{final}.tmp.{os.getpid()}.npz"  # unique per process: two
        # concurrent materializers must not clobber each other's tmp file
        np.savez(tmp, images=images[np.asarray(sel)], labels=labels[np.asarray(sel)])
        os.replace(tmp, final)


def _upsample_to_mnist(img64: np.ndarray) -> np.ndarray:
    """8x8 -> 28x28: nearest x3 to 24x24, zero-pad 2 on every side."""
    x = img64.reshape(8, 8)
    x = np.repeat(np.repeat(x, 3, axis=0), 3, axis=1)
    out = np.full((28, 28), -1.0, np.float32)  # background = -1 (as MNIST)
    out[2:26, 2:26] = x
    return out.reshape(784)


def _reader_creator(split: str, as_mnist: bool):
    def reader():
        _materialize()
        data = common.cached_npz("digits", split)
        for img, lbl in zip(data["images"], data["labels"]):
            yield (_upsample_to_mnist(img) if as_mnist else img), int(lbl)

    return reader


def train():
    return _reader_creator("train", as_mnist=False)


def test():
    return _reader_creator("test", as_mnist=False)


def train_as_mnist():
    return _reader_creator("train", as_mnist=True)


def test_as_mnist():
    return _reader_creator("test", as_mnist=True)
