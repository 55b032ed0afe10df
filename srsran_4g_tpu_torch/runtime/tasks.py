"""Host task runtime: scheduler, multiqueue, ordered commit, procedures, FSM.

Counterpart of the reference's common runtime (SURVEY §2.3):
`task_scheduler` (timer wheel + internal queue + external multiqueue
with per-producer ports, `common/task_scheduler.h:33`,
`common/multiqueue.h:54`), `tti_semaphore` FIFO ordered commit
(`common/tti_sempahore.h:41`), stackless `proc_t` procedures
(`common/stack_procedure.h:205`) and the template FSM (`adt/fsm.h`).

The TPU build's data plane is batched dataflow, so these primitives
orchestrate the *host* side: stack actors, timers, in-order TX commit
of asynchronously finished subframe batches, and multi-step control
procedures — single-threaded, deterministic, testable.
"""

from __future__ import annotations

import heapq
from collections import deque
from dataclasses import dataclass, field
from enum import Enum
from typing import Callable, Generator, Optional


class TimerHandler:
    """ms-resolution timer wheel (common/timers.h)."""

    def __init__(self) -> None:
        self.now_ms = 0
        self._heap: list[tuple[int, int, Callable[[], None]]] = []
        self._next_id = 0
        self._cancelled: set[int] = set()

    def start(self, duration_ms: int, callback: Callable[[], None]) -> int:
        tid = self._next_id
        self._next_id += 1
        heapq.heappush(self._heap, (self.now_ms + duration_ms, tid, callback))
        return tid

    def stop(self, tid: int) -> None:
        self._cancelled.add(tid)

    def tick(self, ms: int = 1) -> None:
        self.now_ms += ms
        while self._heap and self._heap[0][0] <= self.now_ms:
            _, tid, cb = heapq.heappop(self._heap)
            if tid not in self._cancelled:
                cb()
            self._cancelled.discard(tid)


class MultiQueue:
    """Per-producer ports fanned into one consumer (multiqueue.h:54)."""

    def __init__(self) -> None:
        self._ports: list[deque] = []
        self._rr = 0

    def add_port(self) -> "QueuePort":
        q: deque = deque()
        self._ports.append(q)
        return QueuePort(q)

    def pop(self):
        """Round-robin across ports; None when all empty."""
        n = len(self._ports)
        for i in range(n):
            q = self._ports[(self._rr + i) % n]
            if q:
                self._rr = (self._rr + i + 1) % n
                return q.popleft()
        return None

    def empty(self) -> bool:
        return all(not q for q in self._ports)


@dataclass
class QueuePort:
    _q: deque

    def push(self, item) -> None:
        self._q.append(item)


class TaskScheduler:
    """Single-consumer event loop: timers + internal + external queues
    (task_scheduler.h:33).  `run_pending()` drains everything runnable;
    `tick()` advances time."""

    def __init__(self) -> None:
        self.timers = TimerHandler()
        self._internal: deque[Callable[[], None]] = deque()
        self.external = MultiQueue()

    def defer(self, task: Callable[[], None]) -> None:
        self._internal.append(task)

    def make_port(self) -> QueuePort:
        return self.external.add_port()

    def run_pending(self, max_tasks: int = 10_000) -> int:
        n = 0
        while n < max_tasks:
            if self._internal:
                self._internal.popleft()()
            else:
                t = self.external.pop()
                if t is None:
                    break
                t()
            n += 1
        return n

    def tick(self, ms: int = 1) -> None:
        self.timers.tick(ms)
        self.run_pending()


class TtiSemaphore:
    """FIFO in-order commit (tti_sempahore.h:41): producers `push` their
    token at dispatch; `can_commit(token)` is true only for the oldest
    outstanding; `release(token)` retires it.  The reference blocks
    worker threads here; the TPU build reorders finished batch results."""

    def __init__(self) -> None:
        self._fifo: deque = deque()

    def push(self, token) -> None:
        self._fifo.append(token)

    def can_commit(self, token) -> bool:
        return bool(self._fifo) and self._fifo[0] == token

    def release(self, token) -> None:
        assert self.can_commit(token), "out-of-order commit"
        self._fifo.popleft()

    def commit_ready(self, done: dict) -> list:
        """Given {token: result} of finished work, pop the in-order
        prefix and return their results oldest-first."""
        out = []
        while self._fifo and self._fifo[0] in done:
            tok = self._fifo.popleft()
            out.append(done.pop(tok))
        return out


class ProcState(Enum):
    IDLE = 0
    RUNNING = 1
    SUCCESS = 2
    ERROR = 3


class Proc:
    """Resumable procedure over a generator (stack_procedure.h proc_t):
    the generator yields to suspend (awaiting an event), returns a bool
    for success.  `trigger(event)` resumes it; `then(cb)` chains."""

    def __init__(self, gen_fn: Callable[..., Generator]) -> None:
        self._gen_fn = gen_fn
        self._gen: Optional[Generator] = None
        self.state = ProcState.IDLE
        self._then: list[Callable[[bool], None]] = []

    def launch(self, *args, **kwargs) -> None:
        assert self.state != ProcState.RUNNING, "already running"
        self._gen = self._gen_fn(*args, **kwargs)
        self.state = ProcState.RUNNING
        self._step(None)

    def trigger(self, event=None) -> None:
        if self.state == ProcState.RUNNING:
            self._step(event)

    def _step(self, event) -> None:
        try:
            self._gen.send(event)
        except StopIteration as stop:
            ok = bool(stop.value) if stop.value is not None else True
            self.state = ProcState.SUCCESS if ok else ProcState.ERROR
            for cb in self._then:
                cb(ok)
        except Exception:
            self.state = ProcState.ERROR
            for cb in self._then:
                cb(False)

    def then(self, cb: Callable[[bool], None]) -> "Proc":
        self._then.append(cb)
        return self

    @property
    def is_busy(self) -> bool:
        return self.state == ProcState.RUNNING


class Fsm:
    """Minimal typed FSM (adt/fsm.h): states are strings, transitions
    are (state, event) -> (next_state, action)."""

    def __init__(self, initial: str) -> None:
        self.state = initial
        self._table: dict[tuple[str, str], tuple[str, Optional[Callable]]] = {}
        self._on_enter: dict[str, Callable[[], None]] = {}
        self.history: list[str] = [initial]

    def add(self, state: str, event: str, next_state: str,
            action: Callable | None = None) -> "Fsm":
        self._table[(state, event)] = (next_state, action)
        return self

    def on_enter(self, state: str, cb: Callable[[], None]) -> "Fsm":
        self._on_enter[state] = cb
        return self

    def fire(self, event: str) -> bool:
        key = (self.state, event)
        if key not in self._table:
            return False
        nxt, action = self._table[key]
        if action:
            action()
        changed = nxt != self.state
        self.state = nxt
        self.history.append(nxt)
        if changed and nxt in self._on_enter:
            self._on_enter[nxt]()
        return True
