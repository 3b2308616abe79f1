"""Accumulator-channel metrics: per-batch value + running summary.

One :class:`Channel` per measured quantity (queue depth, batch latency,
recompaction latency, per-class savings, swap count, ...): ``observe``
records the latest value and folds it into the running count / total /
min / max, so a dashboard (or the bench snapshot) can read both "what
happened this batch" and "how has it gone overall" off the same surface
without the service keeping history lists.  The hub is just a name ->
channel map with auto-vivification; channels are cheap enough that
callers never pre-register.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class Channel:
    """One metric stream: last observed value plus running aggregates."""

    name: str
    last: float = 0.0
    count: int = 0
    total: float = 0.0
    min: float = 0.0
    max: float = 0.0

    def observe(self, value: float) -> None:
        v = float(value)
        self.last = v
        if self.count == 0:
            self.min = self.max = v
        else:
            self.min = min(self.min, v)
            self.max = max(self.max, v)
        self.count += 1
        self.total += v

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def summary(self) -> dict:
        return {"last": self.last, "count": self.count,
                "total": self.total, "min": self.min, "max": self.max,
                "mean": self.mean}


class MetricsHub:
    """Name -> :class:`Channel` map with observe-creates semantics."""

    def __init__(self) -> None:
        self.channels: dict[str, Channel] = {}

    def channel(self, name: str) -> Channel:
        ch = self.channels.get(name)
        if ch is None:
            ch = self.channels[name] = Channel(name=name)
        return ch

    def observe(self, name: str, value: float) -> Channel:
        ch = self.channel(name)
        ch.observe(value)
        return ch

    def summary(self) -> dict[str, dict]:
        return {name: ch.summary()
                for name, ch in sorted(self.channels.items())}
