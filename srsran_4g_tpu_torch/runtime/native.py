"""ctypes bindings to the repo's C++ host runtime (``native/runtime.cc``).

Port counterpart of ``srsran_4g_tpu/runtime/native.py``: the same classes
(the SPSC IQ ring buffer, the TCP IQ bridge that plays the reference's ZMQ
virtual radio with the sample count as the clock, the pcap writer) over the
same library, ``native/libsrsran_tpu_rt.so``, which lies outside both
packages and is built from ``native/runtime.cc`` by ``native/Makefile`` at
first use.  See ``native/runtime.cc`` for the component ↔ reference mapping.
The bridge's RX end connects with a fresh socket each attempt (``IqBridgeRx``).

The build is guarded by an exclusive ``fcntl.flock`` on ``build/native.lock``
under the checkout, not only by a thread lock: the apps of a deployment
start as several processes at once, and on a fresh checkout each would
otherwise run ``make`` into the same file while another loads it.
"""

from __future__ import annotations

import ctypes
import fcntl
import subprocess
import threading
import time
from pathlib import Path

import numpy as np

_ROOT = Path(__file__).resolve().parents[2]
NATIVE_DIR = _ROOT / "native"
LIB_NAME = "libsrsran_tpu_rt.so"
LOCK_PATH = _ROOT / "build" / "native.lock"
_lock = threading.Lock()
_lib = None


def build_library(native_dir: Path = NATIVE_DIR, lock_path: Path = LOCK_PATH) -> bool:
    """Build ``native_dir``'s library with its Makefile unless it is newer
    than ``runtime.cc``, holding an exclusive lock on ``lock_path`` while it
    checks and builds; True if this call ran the build.  A process that
    waited on the lock finds the library built and builds nothing."""
    lib, src = native_dir / LIB_NAME, native_dir / "runtime.cc"
    lock_path.parent.mkdir(parents=True, exist_ok=True)
    with open(lock_path, "a") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            if lib.exists() and lib.stat().st_mtime >= src.stat().st_mtime:
                return False
            subprocess.run(["make", "-C", str(native_dir), "-s", LIB_NAME], check=True)
            return True
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    c = ctypes
    lib.rt_rb_create.restype = c.c_void_p
    lib.rt_rb_create.argtypes = [c.c_size_t]
    lib.rt_rb_destroy.argtypes = [c.c_void_p]
    for f in (lib.rt_rb_size, lib.rt_rb_space):
        f.restype = c.c_size_t
        f.argtypes = [c.c_void_p]
    for f in (lib.rt_rb_write, lib.rt_rb_read):
        f.restype = c.c_size_t
        f.argtypes = [c.c_void_p, c.POINTER(c.c_float), c.c_size_t]

    lib.rt_bridge_tx_create.restype = c.c_void_p
    lib.rt_bridge_tx_create.argtypes = [c.c_uint16]
    lib.rt_bridge_tx_accept.restype = c.c_int
    lib.rt_bridge_tx_accept.argtypes = [c.c_void_p]
    lib.rt_bridge_tx_send.restype = c.c_int
    lib.rt_bridge_tx_send.argtypes = [c.c_void_p, c.POINTER(c.c_float), c.c_uint32]
    lib.rt_bridge_tx_destroy.argtypes = [c.c_void_p]
    lib.rt_bridge_rx_connect.restype = c.c_void_p
    lib.rt_bridge_rx_connect.argtypes = [c.c_char_p, c.c_uint16, c.c_int]
    lib.rt_bridge_rx_read.restype = c.c_int
    lib.rt_bridge_rx_read.argtypes = [c.c_void_p, c.POINTER(c.c_float), c.c_uint32]
    lib.rt_bridge_rx_count.restype = c.c_uint64
    lib.rt_bridge_rx_count.argtypes = [c.c_void_p]
    lib.rt_bridge_rx_destroy.argtypes = [c.c_void_p]

    lib.rt_pcap_open.restype = c.c_void_p
    lib.rt_pcap_open.argtypes = [c.c_char_p]
    lib.rt_pcap_write.restype = c.c_int
    lib.rt_pcap_write.argtypes = [c.c_void_p, c.POINTER(c.c_uint8), c.c_uint32]
    lib.rt_pcap_close.argtypes = [c.c_void_p]
    return lib


def load() -> ctypes.CDLL:
    """Build (under the file lock) and load the runtime library, once a
    process."""
    global _lib
    with _lock:
        if _lib is None:
            build_library()
            _lib = _bind(ctypes.CDLL(str(NATIVE_DIR / LIB_NAME)))
        return _lib


def _fptr(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _iq(samples) -> np.ndarray:
    return np.ascontiguousarray(samples, dtype=np.complex64).view(np.float32)


class RingBuffer:
    """SPSC IQ ring buffer (reference ringbuffer.c)."""

    def __init__(self, capacity_samples: int):
        self._lib = load()
        self._h = self._lib.rt_rb_create(capacity_samples)

    def write(self, samples: np.ndarray) -> int:
        return self._lib.rt_rb_write(self._h, _fptr(_iq(samples)), samples.size)

    def read(self, n: int) -> np.ndarray:
        out = np.zeros(2 * n, dtype=np.float32)
        got = self._lib.rt_rb_read(self._h, _fptr(out), n)
        return out.view(np.complex64)[:got]

    @property
    def size(self) -> int:
        return self._lib.rt_rb_size(self._h)

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.rt_rb_destroy(self._h)
            self._h = None


class IqBridgeTx:
    """TX side of the virtual-radio TCP sample bridge (reference rf_zmq)."""

    def __init__(self, port: int):
        self._lib = load()
        self._h = self._lib.rt_bridge_tx_create(port)
        if not self._h:
            raise OSError(f"cannot bind IQ bridge on port {port}")

    def accept(self) -> None:
        if self._lib.rt_bridge_tx_accept(self._h) != 0:
            raise OSError("accept failed")

    def send(self, samples: np.ndarray) -> None:
        if self._lib.rt_bridge_tx_send(self._h, _fptr(_iq(samples)), samples.size) != 0:
            raise OSError("bridge send failed")

    def close(self) -> None:
        if self._h:
            self._lib.rt_bridge_tx_destroy(self._h)
            self._h = None


class IqBridgeRx:
    """RX side: reads advance the virtual sample clock.

    Connects until ``timeout_ms`` has passed, one attempt on a fresh socket
    each 10 ms: ``rt_bridge_rx_connect`` retries ``connect`` on the socket a
    refused attempt left behind, which some kernels never let succeed, so
    the port gives it no time of its own (timeout 0: a single attempt)."""

    def __init__(self, host: str, port: int, timeout_ms: int = 5000):
        self._lib = load()
        deadline = time.monotonic() + timeout_ms / 1e3
        while not (h := self._lib.rt_bridge_rx_connect(host.encode(), port, 0)):
            if time.monotonic() > deadline:
                raise OSError(f"cannot connect IQ bridge to {host}:{port}")
            time.sleep(0.01)
        self._h = h

    def read(self, n: int) -> np.ndarray:
        out = np.zeros(2 * n, dtype=np.float32)
        if self._lib.rt_bridge_rx_read(self._h, _fptr(out), n) != 0:
            raise OSError("bridge read failed")
        return out.view(np.complex64)

    @property
    def sample_count(self) -> int:
        return self._lib.rt_bridge_rx_count(self._h)

    def close(self) -> None:
        if self._h:
            self._lib.rt_bridge_rx_destroy(self._h)
            self._h = None


class PcapWriter:
    """Async pcap writer (reference mac_pcap_base: worker thread + queue)."""

    def __init__(self, path: str):
        self._lib = load()
        self._h = self._lib.rt_pcap_open(path.encode())
        if not self._h:
            raise OSError(f"cannot open pcap {path}")

    def write(self, packet: bytes) -> bool:
        buf = (ctypes.c_uint8 * len(packet)).from_buffer_copy(packet)
        return self._lib.rt_pcap_write(self._h, buf, len(packet)) == 0

    def close(self) -> None:
        if self._h:
            self._lib.rt_pcap_close(self._h)
            self._h = None
