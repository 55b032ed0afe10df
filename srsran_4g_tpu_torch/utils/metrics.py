"""Metrics hub (reference: lib/include/srsran/common/metrics_hub.h).

Every processing layer exposes `get_metrics()`; the hub polls them
periodically from a helper thread and fans snapshots out to listeners
(stdout table / CSV / JSON writers — srsue/src/metrics_*.cc equivalents).
"""

from __future__ import annotations

import csv
import json
import threading
import time
from typing import Callable


class MetricsHub:
    def __init__(self, period_s: float = 1.0):
        self.period_s = period_s
        self._sources: list[tuple[str, Callable[[], dict]]] = []
        self._listeners: list[Callable[[float, dict], None]] = []
        self._thread: threading.Thread | None = None
        self._stop = threading.Event()

    def add_source(self, name: str, fn: Callable[[], dict]) -> None:
        self._sources.append((name, fn))

    def add_listener(self, fn: Callable[[float, dict], None]) -> None:
        self._listeners.append(fn)

    def poll_once(self) -> dict:
        snap = {name: fn() for name, fn in self._sources}
        t = time.time()
        for listener in self._listeners:
            listener(t, snap)
        return snap

    def start(self) -> None:
        def run():
            while not self._stop.wait(self.period_s):
                self.poll_once()

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=2)


def stdout_listener(t: float, snap: dict) -> None:
    cols = []
    for src, metrics in snap.items():
        for k, v in metrics.items():
            cols.append(f"{src}.{k}={v:.4g}" if isinstance(v, float) else
                        f"{src}.{k}={v}")
    print(f"[metrics {time.strftime('%H:%M:%S', time.localtime(t))}] "
          + " ".join(cols))


class CsvListener:
    def __init__(self, path: str):
        self._f = open(path, "w", newline="")
        self._writer = None

    def __call__(self, t: float, snap: dict) -> None:
        row = {"time": t}
        for src, metrics in snap.items():
            for k, v in metrics.items():
                row[f"{src}.{k}"] = v
        if self._writer is None:
            self._writer = csv.DictWriter(self._f, fieldnames=list(row))
            self._writer.writeheader()
        self._writer.writerow(row)
        self._f.flush()


class JsonListener:
    def __init__(self, path: str):
        self._f = open(path, "w")

    def __call__(self, t: float, snap: dict) -> None:
        self._f.write(json.dumps({"time": t, **snap}) + "\n")
        self._f.flush()
