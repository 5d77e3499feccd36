"""Sharded checkpoints: one shard file per rank, in the JAX package's format
— port of ``paddle_tpu/checkpoint_sharded.py``.

Reference mechanics: PS-mode checkpointing saves each pserver's shard plus
per-trainer metadata and reloads sliced vars
(``python/paddle/fluid/trainer.py:663`` save_checkpoint, ``io.py:882``
_load_slice_up_vars; Go pserver CRC+rename ``go/pserver/service.go:346-450``).

The layout is the JAX package's, byte for byte, so either package loads
the other's: ``checkpoint_<step>/shards_p<rank>.npz`` holds the blocks that
rank owns, keyed ``leaf_<i>|<start>:<stop>,...`` (the leaf's index in
``jax.tree_util`` order, :mod:`paddle_tpu_torch.core.tree`, and the
block's global window); a ``.crc`` sidecar beside each shard file holds
its CRC32; ``manifest.json`` (written by rank 0) holds ``step``,
``epoch``, ``time``, ``num_processes``, ``num_leaves``, each leaf's global
``shape`` and ``dtype``, and ``treedef`` — here the port's own description
of the tree, which the JAX loader never parses.

Where each leaf lives comes from a template tree of
:class:`~paddle_tpu_torch.parallel.sharding.LeafLayout` (what
``DataParallel.state_template`` returns, the port's ShapeDtypeStruct with a
sharding): a replicated leaf is written once, by its owner (the first
rank), a ZeRO-1 slot by every rank for its rows. Without a template every
leaf is whole and replicated. Restore assembles each rank's window from the
saved blocks — one block when the windows match, pieces of several when
they do not (a checkpoint saved at N ranks loads at M). Assumes the
checkpoint root is on a file system every rank sees.
"""

from __future__ import annotations

import glob
import json
import os
import shutil
import threading
import time
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from paddle_tpu_torch import tracing
from paddle_tpu_torch.core import locks
from paddle_tpu_torch.core import logging as ptlog
from paddle_tpu_torch.core import profiler as prof
from paddle_tpu_torch.core import tree as tree_mod
from paddle_tpu_torch.core.enforce import EnforceError, enforce
from paddle_tpu_torch.core.retry import retry_call
from paddle_tpu_torch.observability import runlog
from paddle_tpu_torch.parallel.mesh import barrier, process_rank, world_size
from paddle_tpu_torch.parallel.sharding import LeafLayout
from paddle_tpu_torch.resilience import faults, integrity
from paddle_tpu_torch.resilience.integrity import CheckpointCorruptError

__all__ = ["save_sharded", "save_sharded_async", "AsyncSaveHandle", "wait_pending_save",
           "latest_sharded_checkpoint", "load_sharded", "restore_from_snapshot",
           "set_snapshot_listener", "update_manifest"]

_MANIFEST = "manifest.json"
# per-shard CRC32 sidecar: shards_pN.npz.crc (each rank writes its own
# shard file, so the rank-0 manifest cannot carry every shard's checksum)
_CRC_SUFFIX = ".crc"

# Optional observer of every single-process save's host snapshot (the
# elastic supervisor's freshest state). Called with (shard_data, manifest).
_snapshot_listener = None


def set_snapshot_listener(fn) -> None:
    """Install a ``(shard_data, manifest) -> None`` observer invoked with
    the host-side shard blocks of every single-process save (sync and
    async), BEFORE any file IO. ``None`` clears it. The listener must not
    mutate the arrays — the async writer thread is still serializing them."""
    global _snapshot_listener
    _snapshot_listener = fn


def _notify_snapshot(shard_data, manifest) -> None:
    fn = _snapshot_listener
    if fn is None:
        return
    try:
        fn(shard_data, manifest)
    except Exception as e:  # an observer must never break the save
        ptlog.warning("checkpoint snapshot listener failed: %s", e)


def _index_key(leaf_i: int, window: Tuple[Tuple[int, int], ...]) -> str:
    return f"leaf_{leaf_i}|{','.join(f'{a}:{b}' for a, b in window)}"


def _parse_key(key: str):
    name, _, idx = key.partition("|")
    leaf_i = int(name.split("_")[1])
    slices = []
    if idx:
        for p in idx.split(","):
            a, b = p.split(":")
            slices.append((int(a), int(b)))
    return leaf_i, tuple(slices)


def _host_copy(leaf) -> np.ndarray:
    """``leaf`` as a numpy array that owns its memory: a later in-place
    write to the tensor must not reach the async writer."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        return t.cpu().numpy() if t.device.type != "cpu" else t.numpy().copy()
    if isinstance(leaf, int) and not isinstance(leaf, bool):
        return np.asarray(leaf, np.int32)
    return np.array(leaf, copy=True)


def _describe(tree: Any) -> str:
    """The port's description of the tree's structure (the manifest's
    ``treedef``; informational, never parsed)."""
    if tree is None:
        return "None"
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {_describe(tree[k])}" for k in sorted(tree)) + "}"
    if isinstance(tree, (tuple, list)):
        inner = ", ".join(_describe(c) for c in tree)
        return f"{type(tree).__name__}({inner})"
    return "*"


def _snapshot(tree: Any, step: int, epoch: int, extra_meta: Optional[dict], template: Any = None):
    """Device->host snapshot of the blocks this rank owns + the manifest
    (the shared half of sync and async saves)."""
    leaves = tree_mod.leaves(tree)
    layouts = tree_mod.leaves(template) if template is not None else [None] * len(leaves)
    enforce(len(layouts) == len(leaves),
            f"template has {len(layouts)} leaves, the tree {len(leaves)}")
    first = process_rank() == 0
    shard_data: Dict[str, np.ndarray] = {}
    manifest_leaves = []
    for i, (leaf, lay) in enumerate(zip(leaves, layouts)):
        local = tuple(np.shape(leaf))
        if isinstance(lay, LeafLayout):
            enforce(local == lay.local_shape,
                    f"leaf {i}: shape {local} is not its window {lay.window}")
            shape, window, owner = lay.shape, lay.window, lay.owner
        else:
            shape, window, owner = local, tuple((0, s) for s in local), first
        if isinstance(leaf, torch.Tensor):
            dtype = _np_dtype(leaf.dtype)
        elif isinstance(leaf, int) and not isinstance(leaf, bool):
            dtype = np.dtype(np.int32)  # OptState.step: JAX's 0-d int32
        else:
            dtype = np.asarray(leaf).dtype
        manifest_leaves.append({"shape": list(shape), "dtype": str(dtype)})
        if owner:  # one writer per block (JAX's replica_id == 0)
            shard_data[_index_key(i, window)] = _host_copy(leaf)
    manifest = {
        "step": int(step),
        "epoch": int(epoch),
        "time": time.time(),
        "num_processes": world_size(),
        "num_leaves": len(leaves),
        "leaves": manifest_leaves,
        "treedef": "paddle_tpu_torch " + _describe(tree),
    }
    if extra_meta:
        manifest.update(extra_meta)
    return shard_data, manifest


def _write_local(tmp_dir: str, pid: int, shard_data, manifest, write_manifest: bool):
    """Write one rank's shard npz (+ CRC sidecar, fsync'd) and, for the
    manifest owner, the durable manifest JSON."""
    faults.inject(faults.CHECKPOINT_SAVE, dir=tmp_dir, pid=pid)
    shard_path = os.path.join(tmp_dir, f"shards_p{pid}.npz")
    np.savez(shard_path, **shard_data)
    integrity.fsync_file(shard_path)
    crc_path = shard_path + _CRC_SUFFIX
    with open(crc_path, "w") as f:
        f.write(str(integrity.crc32_file(shard_path)))
        f.flush()
        os.fsync(f.fileno())
    if write_manifest:
        integrity.write_json_durable(os.path.join(tmp_dir, _MANIFEST), manifest)


def _write_publish_local(root: str, step: int, shard_data, manifest, max_num: int) -> str:
    """Single-process write + atomic publish + prune, shared by the sync
    path and the async writer thread: fsync'd files, an atomic rename, the
    parent dir fsync'd; transient IO errors retry with backoff."""
    final_dir = os.path.join(root, f"checkpoint_{step}")
    tmp_dir = final_dir + ".tmp"

    def write_and_publish():
        os.makedirs(root, exist_ok=True)
        if os.path.exists(tmp_dir):  # idempotent across retries
            shutil.rmtree(tmp_dir)
        os.makedirs(tmp_dir)
        _write_local(tmp_dir, 0, shard_data, manifest, write_manifest=True)
        integrity.fsync_dir(tmp_dir)
        os.rename(tmp_dir, final_dir)  # atomic publish
        integrity.fsync_dir(root)  # make the rename itself durable

    t0 = time.perf_counter()
    retry_call(
        write_and_publish,
        retries=2, base_delay=0.02, max_delay=0.5,
        decorrelated=True, budget="default",
        what=f"sharded checkpoint save (step {step})",
    )
    save_s = time.perf_counter() - t0
    prof.inc_counter("checkpoint.saves_total")
    prof.observe("checkpoint.save_seconds", save_s)
    runlog.emit("checkpoint_save", step=int(step), path=final_dir,
                seconds=round(save_s, 6), sharded=True)
    _prune(root, max_num)
    return final_dir


def save_sharded(
    root: str,
    tree: Any,
    step: int,
    epoch: int = 0,
    max_num_checkpoints: int = 3,
    extra_meta: Optional[dict] = None,
    template: Any = None,
) -> str:
    """Save the training tree with each rank writing only the blocks it
    owns (``template``: see the module docstring). Returns the published
    checkpoint dir (every rank). With more than one rank this is
    collective: every rank calls it."""
    if world_size() == 1:
        with _save_lock:
            _drain_pending_for_save()  # never interleave with an in-flight async save
            shard_data, manifest = _snapshot(tree, step, epoch, extra_meta, template)
            _notify_snapshot(shard_data, manifest)
            final_dir = _write_publish_local(root, step, shard_data, manifest, max_num_checkpoints)
        ptlog.vlog(1, "sharded checkpoint step %d -> %s", step, final_dir)
        return final_dir
    wait_pending_save()
    pid = process_rank()

    final_dir = os.path.join(root, f"checkpoint_{step}")
    tmp_dir = final_dir + ".tmp"
    if pid == 0:
        os.makedirs(root, exist_ok=True)
        if os.path.exists(tmp_dir):
            shutil.rmtree(tmp_dir)
        os.makedirs(tmp_dir)
    _barrier("ckpt_mkdir")

    shard_data, manifest = _snapshot(tree, step, epoch, extra_meta, template)
    _write_local(tmp_dir, pid, shard_data, manifest, write_manifest=pid == 0)
    _barrier("ckpt_written")
    if pid == 0:
        integrity.fsync_dir(tmp_dir)
        os.rename(tmp_dir, final_dir)  # atomic publish
        integrity.fsync_dir(root)  # make the rename itself durable
        _prune(root, max_num_checkpoints)
        prof.inc_counter("checkpoint.saves_total")
        runlog.emit("checkpoint_save", step=int(step), path=final_dir, sharded=True)
    _barrier("ckpt_published")
    ptlog.vlog(1, "sharded checkpoint step %d -> %s (rank %d)", step, final_dir, pid)
    return final_dir


class AsyncSaveHandle:
    """Handle for an in-flight async save: ``result()`` blocks until the
    checkpoint is published and returns its dir (re-raising any writer
    error); ``done`` polls."""

    def __init__(self):
        self._thread: Optional[threading.Thread] = None
        self._dir: Optional[str] = None
        self._error: Optional[BaseException] = None

    @property
    def done(self) -> bool:
        return self._thread is None or not self._thread.is_alive()

    def result(self, timeout: Optional[float] = None) -> str:
        if self._thread is not None:
            self._thread.join(timeout)
            enforce(not self._thread.is_alive(), "async checkpoint save timed out")
        if self._error is not None:
            raise self._error
        return self._dir


_pending: Optional[AsyncSaveHandle] = None
# guards the _pending slot itself (read/clear); cheap, never held across IO
_pending_lock = locks.Lock("checkpoint.async_pending")
# serializes whole save entries: two threads calling save_sharded_async
# concurrently would otherwise both drain, snapshot, and race the slot
_save_lock = locks.RLock("checkpoint.save")


def wait_pending_save(timeout: Optional[float] = None) -> Optional[str]:
    """Block until a previous :func:`save_sharded_async` finishes (no-op if
    none is in flight). On writer ERROR the pending slot is cleared (one
    failure must not re-raise forever); on TIMEOUT it stays pending — the
    writer thread is still alive and must not be raced by a new save."""
    global _pending
    with _pending_lock:
        pending = _pending
    if pending is None:
        return None
    if pending._thread is not None:
        pending._thread.join(timeout)
        enforce(not pending._thread.is_alive(), "async checkpoint save timed out")
    with _pending_lock:
        if _pending is pending:  # joined (or never started): done or errored
            _pending = None
    if pending._error is not None:
        raise pending._error
    return pending._dir


def _drain_pending_for_save() -> None:
    """Join any in-flight async save before starting a NEW one. A previous
    save's writer error must not abort the new save (it carries fresher
    state), so it is surfaced as a runlog ``alert`` +
    ``checkpoint.async_errors_total`` instead of re-raised."""
    try:
        wait_pending_save()
    except BaseException as e:
        prof.inc_counter("checkpoint.async_errors_total")
        runlog.emit("alert", source="checkpoint", key="async_save_failed",
                    severity="error", error=str(e))
        ptlog.error("previous async checkpoint save failed (%s); proceeding with new save", e)


def save_sharded_async(
    root: str,
    tree: Any,
    step: int,
    epoch: int = 0,
    max_num_checkpoints: int = 3,
    extra_meta: Optional[dict] = None,
    template: Any = None,
) -> AsyncSaveHandle:
    """Async save: the device->host copy of the owned blocks is taken
    SYNCHRONOUSLY (the next step may overwrite the tensors), then file
    writing + atomic publish run in a background thread, so checkpoint IO
    overlaps training. A new save first waits for the previous one (a
    previous FAILURE is alerted, not re-raised). One rank only: with
    several ranks the publish barrier cannot run off the main thread (it
    would interleave with the step's collectives), so it saves
    synchronously and every rank's step waits for the whole save. The JAX
    package falls back the same way with several processes, but there one
    process drives every chip of a host; here each card is a process, so
    any multi-card run takes this path (ROADMAP.md §A item 5)."""
    global _pending
    if world_size() > 1:
        wait_pending_save()
        h = AsyncSaveHandle()
        h._dir = save_sharded(root, tree, step, epoch, max_num_checkpoints, extra_meta, template)
        return h

    with _save_lock:
        _drain_pending_for_save()
        shard_data, manifest = _snapshot(tree, step, epoch, extra_meta, template)
        _notify_snapshot(shard_data, manifest)
        handle = AsyncSaveHandle()

        def writer():
            t0 = time.perf_counter()
            try:
                handle._dir = _write_publish_local(
                    root, step, shard_data, manifest, max_num_checkpoints
                )
                t1 = time.perf_counter()
                # make the IO-overlap window visible next to trainer.step:
                # histogram + runlog event + a Chrome-trace span from the
                # writer thread (record_span is cross-thread safe)
                prof.observe("checkpoint.async_write_seconds", t1 - t0)
                runlog.emit("checkpoint_async_write", step=int(step),
                            path=handle._dir, seconds=round(t1 - t0, 6))
                tracing.record_span("checkpoint.async_write", t0, t1, step=int(step))
                ptlog.vlog(1, "async sharded checkpoint step %d -> %s", step, handle._dir)
            except BaseException as e:  # surfaced on result()
                handle._error = e

        handle._thread = threading.Thread(target=writer, daemon=True, name=f"ckpt-save-{step}")
        handle._thread.start()
        with _pending_lock:
            _pending = handle
    return handle


def latest_sharded_checkpoint(root: str) -> Optional[str]:
    steps = _existing_steps(root)
    return os.path.join(root, f"checkpoint_{max(steps)}") if steps else None


def _verify_serial(path: str) -> dict:
    """Parse the manifest and CRC-verify every shard npz of one serial;
    raises CheckpointCorruptError on any integrity failure."""
    faults.inject(faults.CHECKPOINT_LOAD, path=path)
    mpath = os.path.join(path, _MANIFEST)
    try:
        with open(mpath) as f:
            manifest = json.load(f)
    except (json.JSONDecodeError, UnicodeDecodeError) as e:
        raise CheckpointCorruptError(f"{mpath}: unparseable manifest ({e})") from e
    shard_files = sorted(glob.glob(os.path.join(path, "shards_p*.npz")))
    if not shard_files:
        raise CheckpointCorruptError(f"{path}: no shard files")
    for fn in shard_files:
        crc_path = fn + _CRC_SUFFIX
        if not os.path.exists(crc_path):
            continue  # pre-integrity checkpoint: stays loadable
        try:
            with open(crc_path) as f:
                expected = int(f.read().strip())
        except ValueError as e:
            raise CheckpointCorruptError(f"{crc_path}: unreadable CRC ({e})") from e
        integrity.verify_crc(fn, expected, what=fn)
    return manifest


def load_sharded(path_or_root: str, tree_like: Any) -> Tuple[Any, dict]:
    """Restore into the structure of ``tree_like`` — tensors (each taken
    whole, on its device, in its dtype), ints, numpy arrays, or
    :class:`LeafLayout` s (this rank's window only). Returns (tree,
    manifest).

    Integrity: every shard npz is CRC32-verified against its sidecar before
    any bytes are trusted. A corrupt serial is quarantined (``*.corrupt``)
    and — when resolving from the root — the previous good serial is used
    instead (every rank applies the same fallback order). The seconds of
    each load go to the ``checkpoint.load_seconds`` histogram."""
    t0 = time.perf_counter()
    explicit = os.path.exists(os.path.join(path_or_root, _MANIFEST))
    if explicit:
        candidates = [path_or_root]
    else:
        steps = sorted(_existing_steps(path_or_root), reverse=True)
        enforce(bool(steps), f"no sharded checkpoint under {path_or_root}")
        candidates = [os.path.join(path_or_root, f"checkpoint_{s}") for s in steps]

    manifest, path, last_err = None, None, None
    for cand in candidates:
        try:
            manifest = _verify_serial(cand)
            path = cand
            break
        except (CheckpointCorruptError, OSError) as e:
            last_err = e
            ptlog.error("sharded checkpoint %s failed verification: %s", cand, e)
            integrity.quarantine(cand)
    enforce(
        manifest is not None,
        f"no loadable sharded checkpoint under {path_or_root} "
        f"(all candidates corrupt; last error: {last_err})",
    )

    # shard index: leaf -> [(slices, ref)] with ref = (file, npz_key)
    index: Dict[int, list] = {}
    for fn in sorted(glob.glob(os.path.join(path, "shards_p*.npz"))):
        with np.load(fn) as z:
            for key in z.files:
                leaf_i, slices = _parse_key(key)
                index.setdefault(leaf_i, []).append((slices, (fn, key)))

    opened: Dict[str, Any] = {}

    def read_block(ref) -> np.ndarray:
        fn, key = ref
        if fn not in opened:
            opened[fn] = np.load(fn)
        return opened[fn][key]

    try:
        tree = _assemble_tree(index, manifest, tree_like, read_block)
    finally:
        for z in opened.values():
            z.close()
    prof.inc_counter("checkpoint.restores_total")
    prof.observe("checkpoint.load_seconds", time.perf_counter() - t0)
    runlog.emit("checkpoint_restore", step=int(manifest.get("step", 0)),
                path=path, sharded=True)
    return tree, manifest


def _np_dtype(dtype: torch.dtype) -> np.dtype:
    if dtype == torch.bfloat16:
        raise EnforceError(
            "bfloat16 checkpoint leaves are not supported (npz has no bf16 dtype): keep f32 "
            "master weights (use_bf16_compute casts operands, not parameters)")
    return torch.empty((), dtype=dtype).numpy().dtype


def _assemble_tree(index: Dict[int, list], manifest: dict, tree_like: Any, read_block) -> Any:
    """Rebuild ``tree_like`` from indexed shard blocks — the shared core of
    the disk restore and the in-memory snapshot restore. ``index`` maps
    leaf -> [(slices, ref)]; ``read_block(ref)`` returns that block's
    ndarray. Exact window matches read one block; other windows assemble
    from the overlapping blocks."""
    like_leaves = tree_mod.leaves(tree_like)
    enforce(
        len(like_leaves) == manifest["num_leaves"],
        f"checkpoint has {manifest['num_leaves']} leaves, target has {len(like_leaves)}",
    )

    restored = []
    for i, like in enumerate(like_leaves):
        info = manifest["leaves"][i]
        shape = tuple(info["shape"])
        blocks = index.get(i, [])
        if isinstance(like, LeafLayout):
            want_shape, window, dtype = like.shape, like.window, _np_dtype(like.dtype)
        elif isinstance(like, torch.Tensor):
            want_shape, window, dtype = tuple(like.shape), None, _np_dtype(like.dtype)
        elif isinstance(like, int) and not isinstance(like, bool):
            want_shape, window, dtype = (), None, np.dtype(info["dtype"])
        else:
            arr = np.asarray(like)
            want_shape, window, dtype = arr.shape, None, arr.dtype
        enforce(tuple(want_shape) == shape,
                f"leaf {i}: checkpoint shape {shape} != target {tuple(want_shape)}")
        want = window if window is not None else tuple((0, s) for s in shape)
        host = _fetch(i, want, blocks, read_block, dtype)
        if isinstance(like, (LeafLayout, torch.Tensor)):
            restored.append(torch.from_numpy(host).to(like.device))
        elif isinstance(like, int) and not isinstance(like, bool):
            restored.append(int(host))
        else:
            restored.append(host)
    return tree_mod.unflatten(tree_like, restored)


def _fetch(i: int, want, blocks, read_block, dtype) -> np.ndarray:
    """The window ``want`` of leaf ``i``: one saved block when one matches
    it exactly, else assembled piece by piece (resharded restore)."""
    for sl, ref in blocks:
        if tuple(sl) == tuple(want):
            return np.array(read_block(ref), dtype=dtype, order="C")  # keeps a 0-d shape
    out = np.zeros([b - a for a, b in want], dtype=dtype)
    covered = 0
    for sl, ref in blocks:
        inter = [(max(a, c), min(b, d)) for (a, b), (c, d) in zip(want, sl)]
        if any(a >= b for a, b in inter):
            continue
        block = read_block(ref)
        src = tuple(slice(a - c, b - c) for (a, b), (c, d) in zip(inter, sl))
        dst = tuple(slice(a - w[0], b - w[0]) for (a, b), w in zip(inter, want))
        out[dst] = np.asarray(block[src], dtype=dtype)
        covered += int(np.prod([b - a for a, b in inter]))
    enforce(
        covered == out.size,
        f"leaf {i}: shard window {want} not fully covered by checkpoint",
    )
    return out


def restore_from_snapshot(shard_data: Dict[str, np.ndarray], manifest: dict, tree_like: Any) -> Tuple[Any, dict]:
    """Rebuild the training tree from an IN-MEMORY snapshot — the host
    shard blocks captured by the save path (:func:`set_snapshot_listener`)
    — without touching disk; blocks are reassembled exactly as by a
    resharded disk restore. Same contract as :func:`load_sharded`."""
    index: Dict[int, list] = {}
    for key in shard_data:
        leaf_i, slices = _parse_key(key)
        index.setdefault(leaf_i, []).append((slices, key))
    tree = _assemble_tree(index, manifest, tree_like, shard_data.__getitem__)
    prof.inc_counter("checkpoint.snapshot_restores_total")
    runlog.emit("checkpoint_restore", step=int(manifest.get("step", 0)),
                source="snapshot", sharded=True)
    return tree, manifest


def _existing_steps(root: str):
    out = []
    if not os.path.isdir(root):
        return out
    for name in os.listdir(root):
        if (
            name.startswith("checkpoint_")
            and not name.endswith(".tmp")
            and integrity.CORRUPT_SUFFIX not in name  # quarantined serials
        ):
            sub = os.path.join(root, name)
            if os.path.exists(os.path.join(sub, _MANIFEST)):
                try:
                    out.append(int(name.split("_")[-1]))
                except ValueError:
                    pass
    return out


def _prune(root: str, keep: int) -> None:
    steps = sorted(_existing_steps(root))
    for old in steps[: max(0, len(steps) - keep)]:
        shutil.rmtree(os.path.join(root, f"checkpoint_{old}"), ignore_errors=True)


def _barrier(tag: str) -> None:
    barrier()


def update_manifest(path_or_root: str, updates: dict) -> None:
    """Merge fields into the latest checkpoint's manifest (rank 0 writes;
    atomic tmp+rename, same contract as checkpoint.update_meta). Collective
    with several ranks."""
    # an in-flight async save is about to publish a NEWER checkpoint —
    # updating "latest" before it lands would write to a stale dir
    _drain_pending_for_save()
    if process_rank() != 0:
        _barrier("manifest_update")
        return
    path = path_or_root
    if not os.path.exists(os.path.join(path, _MANIFEST)):
        latest = latest_sharded_checkpoint(path_or_root)
        if latest is None:
            _barrier("manifest_update")
            return
        path = latest
    mpath = os.path.join(path, _MANIFEST)
    with open(mpath) as f:
        manifest = json.load(f)
    manifest.update(updates)
    tmp = mpath + ".tmp"
    with open(tmp, "w") as f:
        json.dump(manifest, f, indent=1)
        f.flush()
        os.fsync(f.fileno())
    os.rename(tmp, mpath)
    _barrier("manifest_update")
