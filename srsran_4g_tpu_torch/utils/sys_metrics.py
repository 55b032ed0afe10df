"""System metrics from /proc (CPU, memory, threads).

Counterpart of `lib/src/system/sys_metrics_processor.cc` (271 LoC):
process CPU share from /proc/self/stat deltas against /proc/stat,
memory from /proc/self/status (VmRSS) and /proc/meminfo, thread count.
Feeds the MetricsHub like every other `get_metrics()` source.
"""

from __future__ import annotations

import os
from dataclasses import dataclass


@dataclass
class SysMetrics:
    process_cpu_percent: float = 0.0
    process_rss_kb: int = 0
    process_threads: int = 0
    system_mem_percent: float = 0.0


class SysMetricsProcessor:
    def __init__(self) -> None:
        self._last_proc = self._read_proc_ticks()
        self._last_total = self._read_total_ticks()

    @staticmethod
    def _read_proc_ticks() -> int:
        with open("/proc/self/stat") as f:
            parts = f.read().split()
        return int(parts[13]) + int(parts[14])  # utime + stime

    @staticmethod
    def _read_total_ticks() -> int:
        with open("/proc/stat") as f:
            line = f.readline().split()[1:]
        return sum(int(x) for x in line)

    def get_metrics(self) -> SysMetrics:
        m = SysMetrics()
        proc = self._read_proc_ticks()
        total = self._read_total_ticks()
        dp, dt = proc - self._last_proc, total - self._last_total
        self._last_proc, self._last_total = proc, total
        ncpu = os.cpu_count() or 1
        m.process_cpu_percent = 100.0 * ncpu * dp / dt if dt > 0 else 0.0
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    m.process_rss_kb = int(line.split()[1])
                elif line.startswith("Threads:"):
                    m.process_threads = int(line.split()[1])
        tot = avail = 0
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemTotal:"):
                    tot = int(line.split()[1])
                elif line.startswith("MemAvailable:"):
                    avail = int(line.split()[1])
        if tot:
            m.system_mem_percent = 100.0 * (tot - avail) / tot
        return m
