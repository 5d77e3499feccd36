"""Shared dataset plumbing: cache location, npz loading, synthetic fallback.

Reference: ``python/paddle/dataset/common.py`` (DATA_HOME, ``download()``
with md5 re-download loop, ``cluster_files_reader``). Download is replaced by
a local-cache-or-synthetic resolution (no egress); the md5 integrity check
maps to an optional sha256 in the cache manifest. A copy of
``paddle_tpu.dataset.common``: the same cache directory and layout, so both
packages read the same files.
"""

from __future__ import annotations

import hashlib
import os
from typing import Callable, Iterator, Optional

import numpy as np

__all__ = ["DATA_HOME", "data_home", "cached_npz", "synthetic_seed", "cluster_files_reader"]

DATA_HOME = os.environ.get(
    "PADDLE_TPU_DATA_HOME",
    os.path.join(os.path.expanduser("~"), ".cache", "paddle_tpu", "dataset"),
)


def data_home(*parts: str) -> str:
    return os.path.join(DATA_HOME, *parts)


def cached_npz(dataset: str, split: str) -> Optional[dict]:
    """Load ``<DATA_HOME>/<dataset>/<split>.npz`` if present (the real-data
    path); returns a dict of arrays or None."""
    path = data_home(dataset, f"{split}.npz")
    if not os.path.exists(path):
        return None
    with np.load(path, allow_pickle=False) as z:
        return {k: z[k] for k in z.files}


def synthetic_seed(dataset: str, split: str) -> int:
    """Deterministic per-(dataset, split) RNG seed so synthetic data is
    stable across runs and processes."""
    h = hashlib.sha256(f"{dataset}:{split}".encode()).digest()
    return int.from_bytes(h[:4], "little")


def cluster_files_reader(
    files_pattern: str,
    trainer_count: int,
    trainer_id: int,
    loader: Callable[[str], Iterator] = None,
):
    """Round-robin file sharding across trainers (reference
    ``common.py`` cluster_files_reader): trainer ``i`` reads files
    ``[i::trainer_count]`` of the glob."""
    import glob

    def reader():
        file_list = sorted(glob.glob(files_pattern))
        my_files = file_list[trainer_id::trainer_count]
        for path in my_files:
            if loader is None:
                with open(path, "rb") as f:
                    yield f.read()
            else:
                yield from loader(path)

    return reader
