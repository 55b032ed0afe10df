"""IQ sample file source/sink (reference: lib/src/phy/io/filesource.c).

Binary complex-float32 format identical to the reference's
SRSRAN_COMPLEX_FLOAT_BIN, so IQ captures recorded by the C tools (and the
`*_file_test` vectors) can be decoded by this framework and vice versa.
"""

from __future__ import annotations

import numpy as np


def write_iq(path: str, samples: np.ndarray) -> None:
    np.asarray(samples, dtype=np.complex64).tofile(path)


def read_iq(path: str, count: int = -1, offset: int = 0) -> np.ndarray:
    return np.fromfile(path, dtype=np.complex64, count=count, offset=offset * 8)


class FileSource:
    """Streaming reader with the reference's filesource semantics."""

    def __init__(self, path: str):
        self._data = read_iq(path)
        self._pos = 0
        self.last_read_short = 0   # samples zero-padded past EOF

    def read(self, n: int) -> np.ndarray:
        out = np.zeros(n, dtype=np.complex64)
        take = min(n, self._data.size - self._pos)
        if take > 0:
            out[:take] = self._data[self._pos:self._pos + take]
            self._pos += take
        self.last_read_short = n - max(take, 0)
        return out

    def seek(self, pos: int) -> None:
        self._pos = pos


class FileSink:
    def __init__(self, path: str):
        self._f = open(path, "wb")

    def write(self, samples: np.ndarray) -> None:
        np.asarray(samples, dtype=np.complex64).tofile(self._f)

    def close(self) -> None:
        self._f.close()
