"""Training checkpoints with auto-resume — port of ``paddle_tpu/checkpoint.py``.

Reference: Trainer-level auto-checkpoint — ``python/paddle/fluid/trainer.py:100``
(CheckpointConfig: dirname, max_num_checkpoints, epoch/step intervals),
``trainer.py:663`` save_checkpoint (serial-numbered dirs, trainer metadata),
``trainer.py:594`` auto-resume on init; Go pserver's atomic tmp-file+rename
with CRC (``go/pserver/service.go:346-450``).

The format is the JAX package's, so a checkpoint written by either package
resumes in the other: ``checkpoint_<serial>/shard_<trainer_id>.npz`` with
members ``leaf_0 .. leaf_{n-1}`` in ``jax.tree_util`` leaf order
(:mod:`paddle_tpu_torch.core.tree`) and ``checkpoint.json`` with ``step``,
``epoch``, ``serial``, ``num_leaves``, the Trainer's ``next_epoch`` and the
npz's ``crc32``. Writes go to a tmp dir, are fsync'd and published by an
atomic rename, so a preempted save never corrupts the latest checkpoint; a
corrupt serial is quarantined (``*.corrupt``) and the one before it loaded.

A Python ``int`` leaf (``OptState.step``) is written as a 0-d int32, the
dtype JAX gives it. A bfloat16 leaf has no npz dtype and is refused.
"""

from __future__ import annotations

import io
import json
import os
import shutil
import time
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from paddle_tpu_torch.core import logging as ptlog
from paddle_tpu_torch.core import profiler as prof
from paddle_tpu_torch.core import tree as tree_mod
from paddle_tpu_torch.core.enforce import EnforceError, enforce
from paddle_tpu_torch.core.retry import retry_call
from paddle_tpu_torch.observability import runlog
from paddle_tpu_torch.resilience import faults, integrity
from paddle_tpu_torch.resilience.integrity import CheckpointCorruptError

__all__ = ["CheckpointConfig", "save_checkpoint", "latest_checkpoint", "load_checkpoint",
           "update_meta"]

_META = "checkpoint.json"


class CheckpointConfig:
    """Mirrors reference CheckpointConfig (trainer.py:100). ``sharded``:
    None picks the sharded layout (:mod:`paddle_tpu_torch.checkpoint_sharded`,
    one shard file per rank) when the world has more than one rank, this
    module's single-file layout otherwise; ``async_save`` overlaps the file
    writing with training (sharded layout only; at one rank only: with
    several ranks the save is synchronous, see ``save_sharded_async``)."""

    def __init__(
        self,
        checkpoint_dir: str,
        max_num_checkpoints: int = 3,
        epoch_interval: int = 1,
        step_interval: int = 10,
        sharded: Optional[bool] = None,
        async_save: bool = False,
    ):
        self.checkpoint_dir = checkpoint_dir
        self.max_num_checkpoints = max_num_checkpoints
        self.epoch_interval = max(1, epoch_interval)
        self.step_interval = max(1, step_interval)
        self.sharded = sharded
        self.async_save = async_save
        if async_save and sharded is None:
            # async lives in the sharded module; the single-rank auto
            # default (unsharded) would silently disable it
            self.sharded = True
        if async_save and sharded is False:
            raise ValueError("async_save=True requires the sharded checkpoint layout")

    def use_sharded(self) -> bool:
        if self.sharded is not None:
            return self.sharded
        from paddle_tpu_torch.parallel.mesh import world_size

        return world_size() > 1


def _serial_dir(root: str, serial: int) -> str:
    return os.path.join(root, f"checkpoint_{serial}")


def _is_bf16(value) -> bool:
    return (isinstance(value, torch.Tensor) and value.dtype == torch.bfloat16) or (
        isinstance(value, np.ndarray) and value.dtype.name == "bfloat16")


def _to_host(i: int, leaf) -> np.ndarray:
    """One leaf as a numpy array (one device-to-host copy per tensor)."""
    if _is_bf16(leaf):
        raise EnforceError(
            f"checkpoint leaf {i} is bfloat16, which npz cannot store: keep f32 "
            "master weights (use_bf16_compute casts operands, not parameters)")
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    if isinstance(leaf, int) and not isinstance(leaf, bool):
        return np.asarray(leaf, np.int32)
    return np.asarray(leaf)


def save_checkpoint(
    root: str,
    tree: Any,
    step: int,
    epoch: int = 0,
    max_num_checkpoints: int = 3,
    trainer_id: int = 0,
    extra_meta: Optional[dict] = None,
) -> str:
    """Save a full training tree under a new serial dir; prune old serials
    (reference save_checkpoint + _scroll_delete, trainer.py:663).

    Durability contract (Go pserver parity, ``service.go:346-450``): shard
    npz + META are written to a tmp dir, fsync'd, CRC32 of the npz recorded
    in META, published by atomic rename, and the parent dir fsync'd — a
    crash at any point leaves the previous serial intact. Transient IO
    errors retry with backoff (``core.retry``)."""
    os.makedirs(root, exist_ok=True)
    serials = sorted(_existing_serials(root))
    serial = (serials[-1] + 1) if serials else 0
    final_dir = _serial_dir(root, serial)
    tmp_dir = final_dir + ".tmp"

    # host snapshot once; only the file IO below is retried
    leaves = tree_mod.leaves(tree)
    arrays = {f"leaf_{i}": _to_host(i, l) for i, l in enumerate(leaves)}
    meta = {
        "step": int(step),
        "epoch": int(epoch),
        "serial": serial,
        "trainer_id": trainer_id,
        "time": time.time(),
        "num_leaves": len(leaves),
    }
    if extra_meta:
        meta.update(extra_meta)

    def write_and_publish():
        faults.inject(faults.CHECKPOINT_SAVE, root=root, serial=serial)
        if os.path.exists(tmp_dir):  # idempotent across retries
            shutil.rmtree(tmp_dir)
        os.makedirs(tmp_dir)
        shard_path = os.path.join(tmp_dir, f"shard_{trainer_id}.npz")
        np.savez(shard_path, **arrays)
        integrity.fsync_file(shard_path)
        meta["crc32"] = {os.path.basename(shard_path): integrity.crc32_file(shard_path)}
        integrity.write_json_durable(os.path.join(tmp_dir, _META), meta)
        integrity.fsync_dir(tmp_dir)
        os.rename(tmp_dir, final_dir)  # atomic publish
        integrity.fsync_dir(root)  # make the rename itself durable

    t0 = time.perf_counter()
    retry_call(
        write_and_publish,
        retries=2, base_delay=0.02, max_delay=0.5,
        decorrelated=True, budget="default",
        what=f"checkpoint save (serial {serial})",
    )
    save_s = time.perf_counter() - t0
    prof.inc_counter("checkpoint.saves_total")
    prof.observe("checkpoint.save_seconds", save_s)
    runlog.emit("checkpoint_save", step=int(step), path=final_dir,
                serial=serial, seconds=round(save_s, 6), sharded=False)

    for old in serials[: max(0, len(serials) + 1 - max_num_checkpoints)]:
        shutil.rmtree(_serial_dir(root, old), ignore_errors=True)
    ptlog.vlog(1, "checkpoint %d saved at step %d -> %s", serial, step, final_dir)
    return final_dir


def _existing_serials(root: str):
    out = []
    if not os.path.isdir(root):
        return out
    for name in os.listdir(root):
        if (
            name.startswith("checkpoint_")
            and not name.endswith(".tmp")
            and integrity.CORRUPT_SUFFIX not in name  # quarantined serials
        ):
            try:
                out.append(int(name.split("_")[-1]))
            except ValueError:
                pass
    return out


def latest_checkpoint(root: str) -> Optional[str]:
    serials = _existing_serials(root)
    return _serial_dir(root, max(serials)) if serials else None


def _load_serial(path: str, trainer_id: int) -> Tuple[List[np.ndarray], dict]:
    """Read + verify one serial dir. Raises CheckpointCorruptError (or an
    IO/parse error) on any integrity failure; callers decide fallback."""
    faults.inject(faults.CHECKPOINT_LOAD, path=path)
    meta_path = os.path.join(path, _META)
    try:
        with open(meta_path) as f:
            meta = json.load(f)
    except (json.JSONDecodeError, UnicodeDecodeError) as e:
        raise CheckpointCorruptError(f"{meta_path}: unparseable META ({e})") from e
    shard_name = f"shard_{trainer_id}.npz"
    shard_path = os.path.join(path, shard_name)
    # CRC recorded at save time (absent on pre-integrity checkpoints:
    # verify what we can, stay loadable)
    expected = (meta.get("crc32") or {}).get(shard_name)
    # one read: the CRC is taken over the very bytes np.load parses
    with open(shard_path, "rb") as f:
        data = f.read()
    if expected is not None:
        integrity.verify_crc_bytes(data, expected, what=shard_path)
    try:
        with np.load(io.BytesIO(data)) as z:
            leaves = [z[f"leaf_{i}"] for i in range(meta["num_leaves"])]
    except (ValueError, KeyError, OSError, EOFError) as e:
        # truncated zip / missing member / bad pickle header all land here
        raise CheckpointCorruptError(f"{shard_path}: unreadable ({e})") from e
    return leaves, meta


def _restore(i: int, arr: np.ndarray, like):
    """Leaf ``i`` as ``like``'s type: a tensor of its dtype on its device, a
    Python int, or a numpy array of its dtype."""
    if _is_bf16(like) or arr.dtype.kind == "V":  # ml_dtypes' bf16 saves as raw bytes
        raise EnforceError(
            f"checkpoint leaf {i}: bfloat16 leaves are not supported (npz has no bf16 dtype)")
    if isinstance(like, torch.Tensor):
        np_dtype = torch.empty((), dtype=like.dtype).numpy().dtype
        host = torch.from_numpy(np.ascontiguousarray(arr, dtype=np_dtype))
        return host.to(like.device)
    if isinstance(like, int) and not isinstance(like, bool):
        return int(arr)
    return np.asarray(arr, dtype=np.asarray(like).dtype)


def load_checkpoint(path_or_root: str, tree_like: Any, trainer_id: int = 0) -> Tuple[Any, dict]:
    """Load into the structure of ``tree_like``; returns (tree, meta).
    Auto-resolves the latest serial when given the root dir (the auto-resume
    path of Trainer.__init__, trainer.py:594).

    Integrity: each candidate serial's META CRC32 is verified against the
    shard npz. A corrupt/truncated serial is QUARANTINED (renamed
    ``*.corrupt``) and — when loading from the root — the previous good
    serial is tried instead, so one torn write never kills auto-resume.
    The seconds of each load (verification and the copies to the device
    included) go to the ``checkpoint.load_seconds`` histogram."""
    t0 = time.perf_counter()
    explicit = os.path.exists(os.path.join(path_or_root, _META))
    if explicit:
        candidates = [path_or_root]
    else:
        serials = sorted(_existing_serials(path_or_root), reverse=True)
        enforce(bool(serials), f"no checkpoint found under {path_or_root}")
        candidates = [_serial_dir(path_or_root, s) for s in serials]

    last_err: Optional[Exception] = None
    leaves, meta = None, None
    for path in candidates:
        try:
            leaves, meta = _load_serial(path, trainer_id)
            break
        except (CheckpointCorruptError, OSError) as e:
            last_err = e
            ptlog.error("checkpoint %s failed verification: %s", path, e)
            integrity.quarantine(path)
    enforce(
        leaves is not None,
        f"no loadable checkpoint under {path_or_root} "
        f"(all candidates corrupt; last error: {last_err})",
    )
    like_leaves = tree_mod.leaves(tree_like)
    enforce(
        len(like_leaves) == len(leaves),
        f"checkpoint has {len(leaves)} leaves but target structure has {len(like_leaves)}",
    )
    restored = [_restore(i, l, ref) for i, (l, ref) in enumerate(zip(leaves, like_leaves))]
    prof.inc_counter("checkpoint.restores_total")
    prof.observe("checkpoint.load_seconds", time.perf_counter() - t0)
    runlog.emit("checkpoint_restore", step=int(meta.get("step", 0)),
                path=path, sharded=False)
    return tree_mod.unflatten(tree_like, restored), meta


def update_meta(path_or_root: str, updates: dict) -> None:
    """Merge fields into the latest checkpoint's metadata (used by Trainer to
    bump next_epoch at epoch boundaries without re-saving identical state)."""
    path = path_or_root
    if not os.path.exists(os.path.join(path, _META)):
        latest = latest_checkpoint(path_or_root)
        if latest is None:
            return
        path = latest
    meta_path = os.path.join(path, _META)
    with open(meta_path) as f:
        meta = json.load(f)
    meta.update(updates)
    # atomic + durable publish: a crash mid-write must not corrupt the
    # latest checkpoint's metadata (auto-resume reads it)
    integrity.write_json_durable(meta_path, meta)
