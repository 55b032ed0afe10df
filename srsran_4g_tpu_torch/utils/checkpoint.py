"""Checkpoint/resume for long benchmark and BLER sweeps.

The reference has no training-style checkpointing (SURVEY §5: its only
persistent state is the FFTW wisdom cache and the HSS DB).  The TPU
build's long-running artifacts are SNR×MCS sweep grids, which can take
minutes-to-hours at high frame counts on real hardware; this module gives
them orbax-style resume semantics at the granularity of one grid point:
each completed point is persisted immediately (atomic tmp+rename), and a
restarted sweep skips everything already measured.

Keys are caller-chosen strings (e.g. "ldpc/ebn0=2.5"); values are any
JSON-serializable row.
"""

from __future__ import annotations

import json
import os
import tempfile


class SweepCheckpoint:
    def __init__(self, path: str, meta: dict | None = None):
        """`meta` identifies the sweep configuration; a checkpoint written
        under a different meta is discarded (the grid changed)."""
        self.path = path
        self.meta = meta or {}
        self.rows: dict[str, object] = {}
        if os.path.exists(path):
            try:
                with open(path) as f:
                    saved = json.load(f)
                if saved.get("meta") == self.meta:
                    self.rows = saved.get("rows", {})
            except (json.JSONDecodeError, OSError):
                pass  # corrupt/partial checkpoint: start fresh

    def __contains__(self, key: str) -> bool:
        return key in self.rows

    def get(self, key: str):
        return self.rows.get(key)

    def put(self, key: str, row) -> None:
        """Record one completed grid point and persist atomically."""
        self.rows[key] = row
        d = os.path.dirname(os.path.abspath(self.path))
        os.makedirs(d, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=d, suffix=".ckpt")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump({"meta": self.meta, "rows": self.rows}, f)
            os.replace(tmp, self.path)
        except BaseException:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise

    def done(self) -> None:
        """Sweep finished: remove the checkpoint file."""
        if os.path.exists(self.path):
            os.unlink(self.path)
