"""Fault detection and injection: liveness, retry, seeded crash plans.

Detection: the coordinator calls ``Monitor.record(worker, step)`` on
every heartbeat and ``Monitor.check()`` on its own cadence.  A worker
whose last beat is older than ``deadline_s`` is dead (fires ``on_dead``
once, permanently excluded); a live worker ``straggler_factor`` or more
steps behind the fastest is a straggler (fires ``on_straggler`` on the
transition, re-arms when it catches back up).  Dead workers keep their
last known step out of the straggler baseline so one corpse cannot mark
the whole fleet slow.

Injection: a :class:`FaultPlan` arms ONE named site -- the durable
online service threads :data:`SITES` through its write path -- and
trips it on the n-th visit, either by raising :class:`InjectedFault`
(in-process crash-point sweeps) or by ``SIGKILL``-ing the process (the
CI kill-and-restart soak).  Plans are seeded so a failure reproduces
from its seed alone.  ``retry`` never retries an :class:`InjectedFault`
-- injection simulates process death, not a transient error.
"""
from __future__ import annotations

import os
import random
import signal
import threading
import time
from typing import Callable

# injection sites threaded through OnlineCompactionService, in the
# order they occur along one submit -> apply -> checkpoint lifecycle
SITES = ("wal.append", "apply", "pre_swap", "post_swap",
         "checkpoint.write", "redetect")


class InjectedFault(RuntimeError):
    """A deliberately injected crash (see :class:`FaultPlan`)."""

    def __init__(self, site: str, occurrence: int):
        super().__init__(f"injected fault at {site!r} "
                         f"(occurrence {occurrence})")
        self.site = site
        self.occurrence = occurrence


class FaultPlan:
    """One seeded crash: trip ``site`` on its ``occurrence``-th visit.

    ``mode="raise"`` raises :class:`InjectedFault` (the sweep recovers
    in-process); ``mode="kill"`` sends the process ``SIGKILL`` (the CI
    soak restarts the command).  A plan fires at most once; ``fire``
    is a no-op for unarmed plans, so production code can call it
    unconditionally with ``plan=None`` handled by the caller.
    """

    def __init__(self, site: str | None, *, occurrence: int = 0,
                 mode: str = "raise") -> None:
        if mode not in ("raise", "kill"):
            raise ValueError(f"unknown fault mode {mode!r}")
        if site is not None and site not in SITES:
            raise ValueError(f"unknown fault site {site!r} "
                             f"(sites: {', '.join(SITES)})")
        self.site = site
        self.occurrence = int(occurrence)
        self.mode = mode
        self.fired = False
        self._counts: dict[str, int] = {}
        self._lock = threading.Lock()

    @classmethod
    def seeded(cls, seed: int, *, sites=SITES, mode: str = "raise",
               max_occurrence: int = 2) -> "FaultPlan":
        """Deterministic plan from a seed: uniform site, occurrence in
        ``[0, max_occurrence]``."""
        rng = random.Random(int(seed))
        return cls(rng.choice(list(sites)),
                   occurrence=rng.randint(0, max_occurrence), mode=mode)

    def seen(self, site: str) -> int:
        """How many times ``site`` has been visited so far."""
        return self._counts.get(site, 0)

    def fire(self, site: str) -> None:
        """Visit ``site``; trip if this is the armed occurrence."""
        with self._lock:
            n = self._counts.get(site, 0)
            self._counts[site] = n + 1
            trip = (not self.fired and site == self.site
                    and n == self.occurrence)
            if trip:
                self.fired = True
        if trip:
            if self.mode == "kill":     # pragma: no cover - kills pytest
                os.kill(os.getpid(), signal.SIGKILL)
            raise InjectedFault(site, n)

    def __repr__(self) -> str:
        return (f"FaultPlan(site={self.site!r}, "
                f"occurrence={self.occurrence}, mode={self.mode!r}, "
                f"fired={self.fired})")


class Monitor:
    def __init__(self, *, deadline_s: float, straggler_factor: int = 3,
                 on_dead: Callable[[str], None] | None = None,
                 on_straggler: Callable[[str], None] | None = None,
                 clock: Callable[[], float] = time.monotonic):
        self.deadline_s = deadline_s
        self.straggler_factor = straggler_factor
        self._on_dead = on_dead or (lambda w: None)
        self._on_straggler = on_straggler or (lambda w: None)
        self._clock = clock
        self._beats: dict[str, tuple[float, int]] = {}  # worker -> (t, step)
        self._dead: set[str] = set()
        self._flagged: set[str] = set()

    def record(self, worker: str, step: int) -> None:
        if worker in self._dead:
            return                      # no resurrection: restart re-joins
        self._beats[worker] = (self._clock(), step)

    def check(self) -> None:
        now = self._clock()
        for w, (t, _) in self._beats.items():
            if w not in self._dead and now - t > self.deadline_s:
                self._dead.add(w)
                self._flagged.discard(w)
                self._on_dead(w)
        alive = {w: s for w, (_, s) in self._beats.items()
                 if w not in self._dead}
        if not alive:
            return
        front = max(alive.values())
        for w, s in alive.items():
            if front - s >= self.straggler_factor:
                if w not in self._flagged:
                    self._flagged.add(w)
                    self._on_straggler(w)
            else:
                self._flagged.discard(w)

    def healthy_workers(self) -> list[str]:
        return sorted(w for w in self._beats if w not in self._dead)

    def stragglers(self) -> list[str]:
        return sorted(self._flagged)


def retry(fn: Callable, *, attempts: int = 3, base_s: float = 0.5,
          factor: float = 2.0, max_s: float = 30.0, jitter: bool = True,
          deadline_s: float | None = None, exceptions=(Exception,),
          sleep: Callable[[float], None] = time.sleep,
          clock: Callable[[], float] = time.monotonic,
          rng: random.Random | None = None,
          on_retry: Callable[[int, float, BaseException], None] | None
          = None) -> Callable:
    """Wrap ``fn`` with backoff retries under an overall time budget.

    Delays use decorrelated jitter (``min(max_s, uniform(base_s,
    prev * 3))`` -- independent retriers de-synchronize instead of
    thundering in lockstep); ``jitter=False`` falls back to the plain
    ``base_s * factor**k`` exponential, still capped at ``max_s``.
    ``deadline_s`` bounds the WHOLE call: once the budget is spent no
    further attempt starts (and a pending sleep is clipped to the
    remainder), so a slow callee cannot block its caller unboundedly.
    The final exception propagates with ``retry_attempts`` (attempts
    made) and ``retry_elapsed_s`` attached; ``on_retry(attempt, delay,
    exc)`` fires before each sleep.  ``sleep``/``clock``/``rng`` are
    injectable for tests.  :class:`InjectedFault` is never retried --
    it models process death.
    """
    if attempts < 1:
        raise ValueError("attempts must be >= 1")
    _rng = rng or random.Random()

    def wrapped(*args, **kwargs):
        t0 = clock()
        prev = base_s
        for attempt in range(attempts):
            try:
                return fn(*args, **kwargs)
            except InjectedFault:
                raise
            except exceptions as e:
                made = attempt + 1
                elapsed = clock() - t0
                out_of_time = (deadline_s is not None
                               and elapsed >= deadline_s)
                if made >= attempts or out_of_time:
                    e.retry_attempts = made
                    e.retry_elapsed_s = elapsed
                    raise
                if jitter:
                    delay = min(max_s, _rng.uniform(base_s, prev * 3.0))
                    prev = delay
                else:
                    delay = min(max_s, base_s * factor ** attempt)
                if deadline_s is not None:
                    delay = min(delay, max(0.0, deadline_s - elapsed))
                if on_retry is not None:
                    on_retry(made, delay, e)
                sleep(delay)
        raise AssertionError("unreachable")

    return wrapped
