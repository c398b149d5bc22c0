"""Durable file-write primitives shared by every meta/checkpoint writer.

One implementation of the write-tmp -> flush -> fsync -> rename -> fsync-dir
sequence (torn writes invisible, rename durable) so the log store's meta,
LS checkpoints, and node meta cannot drift apart in their crash behavior.
"""

from __future__ import annotations

import os


def atomic_write(path: str, data: bytes, fsync: bool = True) -> None:
    """Atomically replace `path` with `data`. With fsync, both the file and
    its directory entry are durable when this returns."""
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(data)
        f.flush()
        if fsync:
            os.fsync(f.fileno())
    os.replace(tmp, path)
    if fsync and d:
        try:
            dfd = os.open(d, os.O_RDONLY)
        except OSError:
            return
        try:
            os.fsync(dfd)
        finally:
            os.close(dfd)
