"""Hierarchical profiler + user counters (E13).

Rebuild of the MRPT ``CTimeLogger`` usage pattern in the reference:
RAII scopes (``ProfilerEntry(profiler_, "name")``, e.g. reference
src/LidarOdometry.cpp:154, :198), manual ``enter``/``leave`` pairs that span
async boundaries (``delay_onNewObs_to_process`` entered in the sensor thread
:180, left in the worker :199 — measuring queue latency), and scalar
counters via ``registerUserMeasure`` (``queue_length`` :172,
``drop_observation`` :177).

A copy of ``mola_fe_lidar_tpu/utils/profiler.py``: the port imports nothing of the
JAX package. ``tests/test_torch_copies.py`` holds the two equal where they
overlap.

The JAX package's device-blocking helpers are not carried over: the port's
scopes end where the code reads a result back from the device.
"""

from __future__ import annotations

import threading
import time
from collections import defaultdict, deque
from dataclasses import dataclass
from typing import Dict, Optional


@dataclass
class _Stat:
    count: int = 0
    total: float = 0.0
    minimum: float = float("inf")
    maximum: float = 0.0

    def add(self, v: float) -> None:
        self.count += 1
        self.total += v
        self.minimum = min(self.minimum, v)
        self.maximum = max(self.maximum, v)

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0


class Profiler:
    """Thread-safe named-scope timer + counter registry.

    Dotted names form the hierarchy by convention, matching the reference's
    ``doProcessNewObservation.3.icp_latest`` style.
    """

    def __init__(self, name: str = "profiler", enabled: bool = True):
        self.name = name
        self.enabled = enabled
        self._lock = threading.Lock()
        self._stats: Dict[str, _Stat] = defaultdict(_Stat)
        # FIFO of open enter() timestamps per scope: a scope may be entered
        # several times before any leave() (e.g. the queue-latency span is
        # entered per ENQUEUED scan in the sensor thread and left in the
        # worker — deliberately cross-thread, so keying by thread would
        # break it; a single slot per name lost all but the newest sample)
        self._open: Dict[str, deque] = defaultdict(deque)
        self._counters: Dict[str, _Stat] = defaultdict(_Stat)

    # -- scoped / manual timing ------------------------------------------
    def enter(self, scope: str) -> None:
        if self.enabled:
            with self._lock:
                self._open[scope].append(time.perf_counter())

    def leave(self, scope: str) -> None:
        if not self.enabled:
            return
        now = time.perf_counter()
        with self._lock:
            q = self._open.get(scope)
            if q:
                # FIFO: the oldest open enter() closes first (queue order)
                self._stats[scope].add(now - q.popleft())

    def record(self, scope: str, seconds: float) -> None:
        if self.enabled:
            with self._lock:
                self._stats[scope].add(seconds)

    # -- counters (registerUserMeasure analogue) -------------------------
    def register_user_measure(self, name: str, value: float) -> None:
        if self.enabled:
            with self._lock:
                self._counters[name].add(value)

    # -- reporting --------------------------------------------------------
    def stats(self) -> Dict[str, dict]:
        with self._lock:
            out = {}
            for k, s in sorted(self._stats.items()):
                out[k] = {"count": s.count, "mean_s": s.mean,
                          "min_s": s.minimum, "max_s": s.maximum, "total_s": s.total}
            for k, s in sorted(self._counters.items()):
                out[f"counter:{k}"] = {"count": s.count, "mean": s.mean,
                                       "min": s.minimum, "max": s.maximum, "total": s.total}
            return out

    def report(self) -> str:
        lines = [f"=== {self.name} ==="]
        for k, v in self.stats().items():
            if k.startswith("counter:"):
                lines.append(f"{k:60s} n={v['count']:<7d} mean={v['mean']:.3f} total={v['total']:.1f}")
            else:
                lines.append(
                    f"{k:60s} n={v['count']:<7d} mean={v['mean_s']*1e3:8.3f}ms "
                    f"min={v['min_s']*1e3:8.3f}ms max={v['max_s']*1e3:8.3f}ms"
                )
        return "\n".join(lines)


class ProfilerEntry:
    """RAII scope: ``with ProfilerEntry(profiler, "name"): ..."""

    def __init__(self, profiler: Optional[Profiler], scope: str):
        self.profiler = profiler
        self.scope = scope

    def __enter__(self):
        if self.profiler:
            self.profiler.enter(self.scope)
        return self

    def __exit__(self, *exc):
        if self.profiler:
            self.profiler.leave(self.scope)
        return False
