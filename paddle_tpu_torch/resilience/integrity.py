"""Checkpoint durability + integrity helpers: CRC32, fsync, quarantine.

Reference: the Go pserver wrote checkpoints as tmp-file + CRC32 + atomic
rename and verified the checksum on load (``go/pserver/service.go:346-450``
— ``Checkpoint{MD5/CRC}`` column, rename-into-place). These helpers give
the Python checkpoint modules the same contract:

- :func:`crc32_file` — streaming CRC32 of a file's bytes;
- :func:`fsync_file` / :func:`fsync_dir` — force file data AND the
  directory entry durable, the half the original ``os.rename`` "atomic
  publish" was missing (a rename is atomic in the namespace but not
  durable until the parent directory is synced);
- :func:`write_json_durable` — tmp + fsync + rename + dir-fsync JSON
  writes (META/manifest files);
- :func:`quarantine` — rename a corrupt checkpoint serial to
  ``*.corrupt`` so serial scans never pick it again while the bytes stay
  on disk for post-mortem;
- :class:`CheckpointCorruptError` — the typed failure load paths catch to
  fall back to an older serial.
"""

from __future__ import annotations

import json
import os
import zlib
from typing import Any, Dict, Optional

from paddle_tpu_torch.core import logging as ptlog

__all__ = [
    "CheckpointCorruptError",
    "crc32_file",
    "verify_crc",
    "verify_crc_bytes",
    "fsync_file",
    "fsync_dir",
    "write_json_durable",
    "quarantine",
    "CORRUPT_SUFFIX",
]

CORRUPT_SUFFIX = ".corrupt"


class CheckpointCorruptError(RuntimeError):
    """A checkpoint file failed CRC/structure verification on load."""


def crc32_file(path: str, chunk_size: int = 1 << 20) -> int:
    """CRC32 of the file's bytes (streamed; matches ``zlib.crc32``)."""
    crc = 0
    with open(path, "rb") as f:
        while True:
            chunk = f.read(chunk_size)
            if not chunk:
                break
            crc = zlib.crc32(chunk, crc)
    return crc & 0xFFFFFFFF


def verify_crc(path: str, expected: int, what: Optional[str] = None) -> None:
    """Raise :class:`CheckpointCorruptError` unless ``path``'s CRC32 matches
    ``expected`` (a truncated write, bit rot, or a torn copy all land
    here)."""
    _check_crc(crc32_file(path), expected, what or os.path.basename(path))


def verify_crc_bytes(data: bytes, expected: int, what: str) -> None:
    """:func:`verify_crc` on bytes already read (the file is read once)."""
    _check_crc(zlib.crc32(data) & 0xFFFFFFFF, expected, what)


def _check_crc(actual: int, expected: int, what: str) -> None:
    if actual != int(expected):
        raise CheckpointCorruptError(
            f"{what}: crc32 mismatch (expected {int(expected):#010x}, got {actual:#010x})"
        )


def fsync_file(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def fsync_dir(path: str) -> None:
    """Sync a directory's entry table — required after creating/renaming
    children for the rename itself to be durable. Best-effort on platforms
    whose filesystems reject directory fsync (the data-file fsyncs still
    hold)."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:  # e.g. some network/overlay filesystems
        pass
    finally:
        os.close(fd)


def write_json_durable(path: str, obj: Dict[str, Any]) -> None:
    """Durable JSON publish: tmp file + flush + fsync + atomic rename +
    parent-dir fsync. A crash at any point leaves either the old file or
    the new one — never a torn half-write."""
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(obj, f, indent=1)
        f.flush()
        os.fsync(f.fileno())
    os.rename(tmp, path)
    fsync_dir(os.path.dirname(path) or ".")


def quarantine(path: str) -> Optional[str]:
    """Rename a corrupt checkpoint dir/file to ``<path>.corrupt`` (suffixed
    ``.corrupt.N`` if taken) so serial scans skip it while the bytes remain
    for diagnosis. Returns the new path, or None if the rename failed (the
    caller falls back regardless)."""
    dest = path + CORRUPT_SUFFIX
    n = 0
    while os.path.exists(dest):
        n += 1
        dest = f"{path}{CORRUPT_SUFFIX}.{n}"
    try:
        os.rename(path, dest)
    except OSError as e:
        ptlog.error("failed to quarantine corrupt checkpoint %s: %s", path, e)
        return None
    ptlog.warning("quarantined corrupt checkpoint: %s -> %s", path, dest)
    return dest
