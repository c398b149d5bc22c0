"""Tmp-file manager: spill storage for the grace-hash route and the spill
operators (ops/spill.py).

Counterpart of `oceanbase_tpu/storage/tmp_file.py` without the per-tenant
IO manager and the fault-injection arms: numpy column segments go to
.npz files under a spill directory inside the integrity envelope
(storage/integrity.py), bytes are tracked against a limit, and the
directory is removed when the manager closes. A corrupt segment raises
CorruptBlock on read and is deleted, so it is never read again.
"""

from __future__ import annotations

import io
import os
import shutil
import tempfile
import threading

import numpy as np

from .integrity import CorruptBlock, unwrap, wrap


class TmpFileManager:
    def __init__(self, limit_bytes: int = 8 << 30):
        self.root = tempfile.mkdtemp(prefix="ob_torch_spill_")
        self.limit_bytes = limit_bytes
        self._bytes = 0
        self._seq = 0
        self._lock = threading.Lock()

    def write_segment(self, cols: dict[str, np.ndarray]) -> str:
        """Spill one segment (a dict of equal-length column arrays)."""
        with self._lock:
            self._seq += 1
            path = os.path.join(self.root, f"seg_{self._seq:06d}.npz")
        buf = io.BytesIO()
        np.savez(buf, **cols)
        # spill is transient (a crash loses the statement anyway): no
        # fsync or rename, but the envelope still guards every read
        with open(path, "wb") as f:
            f.write(wrap(buf.getbuffer()))
        sz = os.path.getsize(path)
        with self._lock:
            self._bytes += sz
            if self._bytes > self.limit_bytes:
                self._bytes -= sz
                os.unlink(path)
                raise RuntimeError(
                    f"spill limit exceeded: {self._bytes + sz} > "
                    f"{self.limit_bytes}")
        return path

    def read_segment(self, path: str) -> dict[str, np.ndarray]:
        with open(path, "rb") as f:
            data = f.read()
        try:
            payload = unwrap(data, path)
        except CorruptBlock:
            self.free_segment(path)
            raise
        with np.load(io.BytesIO(payload)) as z:
            return {k: z[k] for k in z.files}

    def free_segment(self, path: str) -> None:
        try:
            sz = os.path.getsize(path)
            os.unlink(path)
            with self._lock:
                self._bytes -= sz
        except FileNotFoundError:
            pass

    @property
    def bytes_used(self) -> int:
        return self._bytes

    def close(self) -> None:
        shutil.rmtree(self.root, ignore_errors=True)
        self._bytes = 0

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
