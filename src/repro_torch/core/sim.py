"""Deterministic discrete-event concurrency engine (virtual time).

The paper's headline claim is scalability *under heavy access
concurrency* (§5: up to 175 Grid'5000 nodes of concurrent readers,
writers and appenders).  Real Python threads cannot reproduce that —
they are slow, nondeterministic and capped by the GIL — so this module
provides a **virtual clock plus an event scheduler** that runs client
programs as cooperatively-scheduled tasks:

* exactly one task runs at any instant; every blocking point in the
  core (wire transfers, SYNC/publication waits) yields back to the
  scheduler through the :class:`Clock` interface,
* virtual time advances only when the scheduler dispatches the next
  event, so a 100-second simulated experiment takes milliseconds of
  wall time,
* events at the same virtual instant are ordered by a **seeded
  tie-break** drawn from a private RNG: every run with the same seed
  replays the exact same interleaving (the scheduler records a trace
  you can digest and compare), while different seeds explore different
  schedules.

The default backend, :class:`WallClock`, preserves the pre-existing
behavior exactly: real ``time.monotonic()``, real ``threading``
primitives, no virtual scheduling.  Components never import
``threading.Condition`` or call ``time.monotonic()`` directly any more;
they ask their clock, so the same code runs under both backends.

Scheduling model for the wire (see ``transport.Wire.transfer``): the
per-endpoint queueing the wire always *accounted*
(``start = max(now, busy_until)``; ``busy_until = start + cost``) is
promoted to actual scheduling — the issuing task sleeps until its
request's completion instant, so two clients hitting the same provider
really do serialize there in virtual time, exactly the §4.3 contention
the paper measures.
"""

from __future__ import annotations

import hashlib
import heapq
import itertools
import random
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple


class SimDeadlock(RuntimeError):
    """The event heap drained while tasks were still blocked."""


class Clock:
    """Time + blocking interface the core components schedule against.

    ``is_virtual`` tells call sites whether blocking charges virtual
    time (simulation) or real time (default threads backend).
    """

    is_virtual = False

    def now(self) -> float:
        raise NotImplementedError

    def sleep(self, seconds: float) -> None:
        raise NotImplementedError

    def sleep_until(self, t: float) -> None:
        raise NotImplementedError

    def condition(self, lock=None):
        """A condition variable bound to this clock's notion of blocking."""
        raise NotImplementedError


class WallClock(Clock):
    """Default backend: real time, real threads (pre-harness behavior)."""

    is_virtual = False

    def now(self) -> float:
        return time.monotonic()

    def sleep(self, seconds: float) -> None:
        if seconds > 0:
            time.sleep(seconds)

    def sleep_until(self, t: float) -> None:
        self.sleep(t - self.now())

    def condition(self, lock=None):
        return threading.Condition(lock)


class _Task:
    """One cooperatively-scheduled client program."""

    __slots__ = ("name", "fn", "thread", "resume", "done", "started",
                 "result", "error", "gen", "waiting_on")

    def __init__(self, name: str, fn: Callable[[], object]) -> None:
        self.name = name
        self.fn = fn
        self.thread: Optional[threading.Thread] = None
        self.resume = threading.Event()
        self.done = False
        self.started = False
        self.result: object = None
        self.error: Optional[BaseException] = None
        self.gen = 0                 # bumped at every resume; stale events skip
        self.waiting_on: Optional["SimCondition"] = None

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return f"<task {self.name} done={self.done}>"


class Simulator(Clock):
    """Deterministic virtual clock + event scheduler.

    Usage::

        sim = Simulator(seed=7)
        svc = BlobSeerService(wire=Wire(clock=sim))
        sim.spawn(lambda: svc.client("w0").append(bid, b"x" * 4096), name="w0")
        sim.run()

    ``run()`` drives tasks until all finish; ``sim.now()`` is then the
    virtual makespan.  Called from a *task*, ``sleep``/``sleep_until``
    advance virtual time; called from the driver thread (scenario
    setup) they are free — setup work happens "before" the experiment.
    """

    is_virtual = True

    def __init__(self, seed: int = 0, record_trace: bool = True) -> None:
        self.seed = seed
        self._rng = random.Random(seed)
        self._now = 0.0
        self._seq = itertools.count()
        self._heap: List[Tuple[float, float, int, int, _Task, str]] = []
        self._tasks: List[_Task] = []
        self._current: Optional[_Task] = None
        self._sched_evt = threading.Event()
        self._driver = None  # thread identity of whoever calls run()
        self._record_trace = record_trace
        self.trace: List[Tuple[float, str, str]] = []
        self._trace_hash = hashlib.sha256()
        self.events_dispatched = 0

    # ----------------------------------------------------------- Clock API
    def now(self) -> float:
        return self._now

    def sleep(self, seconds: float) -> None:
        self.sleep_until(self._now + max(0.0, seconds))

    def sleep_until(self, t: float) -> None:
        task = self._current_task()
        if task is None:
            # Driver-thread (scenario setup) work is free: it happens
            # logically before t=0 of the experiment.
            return
        self._schedule(task, max(t, self._now), "wake")
        self._switch_out(task)

    def condition(self, lock=None) -> "SimCondition":
        return SimCondition(self, lock)

    # ------------------------------------------------------------ task API
    def spawn(self, fn: Callable[[], object], name: Optional[str] = None) -> _Task:
        """Register a client program; it starts running at ``run()``."""
        task = _Task(name if name is not None else f"task-{len(self._tasks)}", fn)
        self._tasks.append(task)
        self._schedule(task, self._now, "spawn")
        return task

    def spawn_at(self, t: float, fn: Callable[[], object],
                 name: Optional[str] = None) -> _Task:
        """Register a task that starts at virtual instant ``t`` — the
        failure-injection primitive (kill endpoint X at t=0.8).  Same
        as a spawned task whose first statement sleeps to ``t``, minus
        the extra wake event in the trace."""
        task = _Task(name if name is not None else f"task-{len(self._tasks)}", fn)
        self._tasks.append(task)
        self._schedule(task, max(t, self._now), "spawn")
        return task

    def run(self, raise_errors: bool = True) -> None:
        """Dispatch events until the heap drains; detects deadlock."""
        if self._current is not None:
            raise RuntimeError("run() called from inside a task")
        while self._heap:
            t, _tie, _seq, gen, task, label = heapq.heappop(self._heap)
            if task.done or gen != task.gen:
                continue  # cancelled/stale event (e.g. timeout after notify)
            self._now = max(self._now, t)
            self.events_dispatched += 1
            task.gen += 1
            if self._record_trace:
                self.trace.append((self._now, task.name, label))
            self._trace_hash.update(
                f"{self._now:.9f}|{task.name}|{label}\n".encode()
            )
            self._dispatch(task)
            if raise_errors and task.done and task.error is not None:
                raise task.error
        blocked = [t for t in self._tasks if t.started and not t.done]
        if blocked:
            raise SimDeadlock(
                "event heap empty but tasks still blocked: "
                + ", ".join(t.name for t in blocked)
            )

    def results(self) -> Dict[str, object]:
        return {t.name: t.result for t in self._tasks}

    def errors(self) -> Dict[str, BaseException]:
        return {t.name: t.error for t in self._tasks if t.error is not None}

    def trace_digest(self) -> str:
        """Stable digest of the full dispatch trace (determinism checks)."""
        return self._trace_hash.hexdigest()

    # ----------------------------------------------------------- internals
    def _current_task(self) -> Optional[_Task]:
        cur = self._current
        if cur is not None and cur.thread is threading.current_thread():
            return cur
        return None

    def _require_task(self) -> _Task:
        task = self._current_task()
        if task is None:
            raise RuntimeError(
                "this operation blocks and must run inside a simulated task "
                "(Simulator.spawn), not the driver thread"
            )
        return task

    def _schedule(self, task: _Task, t: float, label: str) -> None:
        # Seeded tie-break: events at the same virtual instant dispatch
        # in an order fully determined by the seed.  The final seq field
        # makes heap entries totally ordered (tasks are never compared).
        heapq.heappush(
            self._heap, (t, self._rng.random(), next(self._seq), task.gen, task, label)
        )

    def _dispatch(self, task: _Task) -> None:
        """Hand the CPU to ``task`` until it yields back or finishes."""
        if not task.started:
            task.started = True
            task.thread = threading.Thread(
                target=self._task_main, args=(task,), name=f"sim:{task.name}",
                daemon=True,
            )
            self._current = task
            task.thread.start()
        else:
            self._current = task
            task.resume.set()
        self._sched_evt.wait()
        self._sched_evt.clear()
        self._current = None

    def _task_main(self, task: _Task) -> None:
        try:
            task.result = task.fn()
        except BaseException as e:  # noqa: BLE001 - surfaced via run()/errors()
            task.error = e
        task.done = True
        self._sched_evt.set()

    def _switch_out(self, task: _Task) -> None:
        """Yield the CPU back to the scheduler; returns when re-dispatched."""
        self._sched_evt.set()
        task.resume.wait()
        task.resume.clear()


class SimCondition:
    """Condition variable blocking in virtual time.

    Drop-in for ``threading.Condition`` at the call sites the core
    uses: ``with cond: ... cond.wait(timeout) ... cond.notify_all()``.
    The underlying lock is a real (but never contended — only one task
    runs at a time) ``threading.RLock``; ``wait`` releases it around a
    scheduler yield and re-acquires on resume, exactly like the real
    Condition does.
    """

    def __init__(self, sim: Simulator, lock=None) -> None:
        self._sim = sim
        self._lock = lock if lock is not None else threading.RLock()
        self._waiters: List[_Task] = []
        # mirror threading.Condition's lock-state save/restore protocol
        self._release_save = getattr(self._lock, "_release_save", None)
        self._acquire_restore = getattr(self._lock, "_acquire_restore", None)

    # lock protocol -------------------------------------------------------
    def __enter__(self):
        self._lock.acquire()
        return self

    def __exit__(self, *exc):
        self._lock.release()
        return False

    def acquire(self, *a, **kw):
        return self._lock.acquire(*a, **kw)

    def release(self):
        self._lock.release()

    # condition protocol --------------------------------------------------
    def wait(self, timeout: Optional[float] = None) -> bool:
        task = self._sim._require_task()
        task.waiting_on = self
        self._waiters.append(task)
        if timeout is not None:
            self._sim._schedule(task, self._sim._now + max(0.0, timeout),
                                "timeout")
        if self._release_save is not None:
            saved = self._release_save()
        else:  # pragma: no cover - plain Lock fallback
            saved = None
            self._lock.release()
        try:
            self._sim._switch_out(task)
        finally:
            if self._acquire_restore is not None:
                self._acquire_restore(saved)
            else:  # pragma: no cover
                self._lock.acquire()
            task.waiting_on = None
        if task in self._waiters:  # resumed by the timeout event
            self._waiters.remove(task)
            return False
        return True

    def notify_all(self) -> None:
        waiters, self._waiters = self._waiters, []
        for task in waiters:
            # bump gen so a pending timeout event for this wait is stale
            task.gen += 1
            self._sim._schedule(task, self._sim._now, "notify")

    def notify(self, n: int = 1) -> None:
        for _ in range(min(n, len(self._waiters))):
            task = self._waiters.pop(0)
            task.gen += 1
            self._sim._schedule(task, self._sim._now, "notify")
