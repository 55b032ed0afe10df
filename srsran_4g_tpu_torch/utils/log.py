"""Async logging + chrome-trace events (reference: lib/src/srslog/).

The reference's srslog pushes log entries through a lock-free queue to a
backend worker thread that formats and writes to sinks (file/stdout/syslog,
text or JSON), plus chrome://tracing duration events
(srslog/event_trace.cpp).  Python equivalent with the same shape:
non-blocking producers → queue → one backend thread → sinks, with
`trace_duration` / `trace_complete_event` emitting chrome-trace JSON that
loads in chrome://tracing or Perfetto alongside `jax.profiler` dumps.
"""

from __future__ import annotations

import atexit
import json
import queue
import sys
import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass

LEVELS = {"debug": 10, "info": 20, "warning": 30, "error": 40, "none": 99}


@dataclass
class _Entry:
    t: float
    level: str
    tag: str
    msg: str


class _Backend:
    """Single backend worker draining a bounded queue (srslog backend_worker)."""

    def __init__(self):
        self.q: queue.Queue = queue.Queue(maxsize=8192)
        self.sinks: list = [None]  # None = current sys.stdout
        self.json_format = False
        self.trace_events: list[dict] = []
        self.trace_enabled = False
        self._thread: threading.Thread | None = None
        self._stop = threading.Event()

    def start(self):
        if self._thread is None:
            self._thread = threading.Thread(target=self._run, daemon=True)
            self._thread.start()
            atexit.register(self.flush)

    def _run(self):
        while not self._stop.is_set():
            try:
                e = self.q.get(timeout=0.2)
            except queue.Empty:
                continue
            self._write(e)

    def _write(self, e: _Entry):
        if self.json_format:
            line = json.dumps(
                dict(ts=e.t, level=e.level, tag=e.tag, msg=e.msg)
            )
        else:
            line = f"{e.t:.6f} [{e.tag:<4}] [{e.level[0].upper()}] {e.msg}"
        for s in self.sinks:
            print(line, file=s if s is not None else sys.stdout)

    def flush(self):
        try:
            while not self.q.empty():
                try:
                    self._write(self.q.get_nowait())
                except queue.Empty:
                    break
            for s in self.sinks:
                (s if s is not None else sys.stdout).flush()
        except ValueError:
            pass  # sink already closed (interpreter shutdown)


_backend = _Backend()


def init(filename: str | None = None, json_format: bool = False,
         tracing: bool = False) -> None:
    """Initialise the logging backend (srslog::init equivalent)."""
    _backend.json_format = json_format
    if filename:
        _backend.sinks = [open(filename, "a")]
    _backend.trace_enabled = tracing
    _backend.start()


class Logger:
    """Front-end logger (srslog::fetch_basic_logger equivalent)."""

    def __init__(self, tag: str, level: str = "warning"):
        self.tag = tag
        self.level = LEVELS[level]

    def _log(self, level: str, msg: str, *args):
        if LEVELS[level] < self.level:
            return
        _backend.start()
        try:
            _backend.q.put_nowait(
                _Entry(time.time(), level, self.tag, msg % args if args else msg)
            )
        except queue.Full:
            pass  # drop like the reference's non-blocking frontends

    def debug(self, msg, *a):
        self._log("debug", msg, *a)

    def info(self, msg, *a):
        self._log("info", msg, *a)

    def warning(self, msg, *a):
        self._log("warning", msg, *a)

    def error(self, msg, *a):
        self._log("error", msg, *a)


def fetch_logger(tag: str, level: str = "warning") -> Logger:
    return Logger(tag, level)


@contextmanager
def trace_duration(name: str, threshold_us: float = 0.0):
    """Chrome-trace complete event; only recorded if it exceeds the
    threshold (reference trace_threshold_complete_event, mac.cc:645)."""
    t0 = time.perf_counter()
    yield
    dur_us = (time.perf_counter() - t0) * 1e6
    if _backend.trace_enabled and dur_us >= threshold_us:
        _backend.trace_events.append(
            dict(name=name, ph="X", ts=t0 * 1e6, dur=dur_us, pid=0, tid=0)
        )


def dump_trace(path: str) -> None:
    with open(path, "w") as f:
        json.dump({"traceEvents": _backend.trace_events}, f)
