"""Hierarchical profiler + user counters (E13).

Rebuild of the MRPT ``CTimeLogger`` usage pattern in the reference:
RAII scopes (``ProfilerEntry(profiler_, "name")``, e.g. reference
src/LidarOdometry.cpp:154, :198), manual ``enter``/``leave`` pairs that span
async boundaries (``delay_onNewObs_to_process`` entered in the sensor thread
:180, left in the worker :199 — measuring queue latency), and scalar
counters via ``registerUserMeasure`` (``queue_length`` :172,
``drop_observation`` :177).

Begun as a copy of ``mola_fe_lidar_tpu/utils/profiler.py`` (the port imports
nothing of the JAX package); the port adds span capture, below.
``tests/test_torch_copies.py`` holds the two equal where they overlap.

The JAX package's device-blocking helpers are not carried over: the port's
scopes end where the code reads a result back from the device.

Span capture. ``span(name, **attrs)`` opens a span; ``ProfilerEntry``
scopes and ``enter``/``leave`` pairs also make spans, under their scope
names. Capture is on exactly while a ``torch.profiler`` session is active
in the process; otherwise opening a span is one flag check and records
nothing. A captured span holds its name, ``start_ns``/``end_ns`` on
``time.time_ns()`` (the clock the profiler stamps its events on), an id,
its parent's id (the thread's innermost open span), the id of its root as
the request id, the thread, and attributes that the code may update until
it closes (counters). ``enter``/``leave`` pairs may cross threads and make
flat spans, with no parent. Leaf spans (``leaf=True``) also open a
``torch.profiler.record_function`` range, which names the host work under
the device trace's idle gaps; enclosing spans open none, so that a gap is
put down to the innermost phase. Spans never synchronise with the device:
a span's time is host time, and only spans around a read hold device waits.
``spans()`` returns the records of the latest capture: the spans of the
latest profiler session that recorded any. A session's start begins a new
capture (the module wraps torch's ``_run_on_profiler_start``, which every
session calls as it turns the flag on), as does a span that sees the
flag off, so two sessions never share one.
"""

from __future__ import annotations

import itertools
import threading
import time
from collections import defaultdict, deque
from dataclasses import dataclass
from typing import Dict, List, Optional

import torch.autograd.profiler as _tap


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
        self._begin(scope, _flat_span(scope))

    def _begin(self, scope: str, flat: Optional["Span"]) -> None:
        if self.enabled or flat is not None:
            with self._lock:
                self._open[scope].append((time.perf_counter(), flat))

    def leave(self, scope: str) -> None:
        now = time.perf_counter()
        if not self._open.get(scope):
            return
        with self._lock:
            q = self._open.get(scope)
            if not q:
                return
            # FIFO: the oldest open enter() closes first (queue order)
            t0, flat = q.popleft()
            if self.enabled:
                self._stats[scope].add(now - t0)
        if flat is not None:
            flat.end_ns = time.time_ns()

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
        self._span = _OFF

    def __enter__(self):
        if self.profiler:
            self.profiler._begin(self.scope, None)  # the span below is nested, not flat
        self._span = span(self.scope).__enter__()
        return self

    def __exit__(self, *exc):
        self._span.__exit__(*exc)
        if self.profiler:
            self.profiler.leave(self.scope)
        return False


class Span:
    """One captured span (see the module docstring). ``end_ns`` is None
    while it is open; ``set`` updates its attributes."""

    __slots__ = ("name", "leaf", "attrs", "id", "parent", "request", "thread",
                 "start_ns", "end_ns", "_range")

    def __init__(self, name: str, leaf: bool, attrs: dict):
        self.name = name
        self.leaf = leaf
        self.attrs = attrs
        self.id = next(_CAPTURE.ids)
        self.parent: Optional[int] = None
        self.request = self.id
        self.thread = threading.get_ident()
        self.start_ns = 0
        self.end_ns: Optional[int] = None
        self._range = None

    def set(self, **attrs) -> None:
        self.attrs.update(attrs)

    def __enter__(self) -> "Span":
        stack = _CAPTURE.stack()
        if stack:
            self.parent, self.request = stack[-1].id, stack[-1].request
        _CAPTURE.add(self)
        stack.append(self)
        # the span encloses its range: the range's own stamps are taken
        # inside record_function's calls, whose first call is slow
        self.start_ns = time.time_ns()
        if self.leaf:
            self._range = _tap.record_function(self.name)
            self._range.__enter__()
        return self

    def __exit__(self, *exc) -> bool:
        if self._range is not None:
            self._range.__exit__(*exc)
            self._range = None
        self.end_ns = time.time_ns()
        _CAPTURE.stack().remove(self)
        return False

    def __repr__(self) -> str:
        return (f"Span({self.name!r}, id={self.id}, parent={self.parent}, "
                f"request={self.request}, ns={self.start_ns}..{self.end_ns}, {self.attrs})")


class _Off:
    """The span handed out while capture is off: it does nothing."""

    __slots__ = ()

    def set(self, **attrs) -> None:
        pass

    def __enter__(self) -> "_Off":
        return self

    def __exit__(self, *exc) -> bool:
        return False


_OFF = _Off()


class _Capture:
    """The process-wide span buffer and the per-thread stacks of open
    spans."""

    def __init__(self):
        self.records: List[Span] = []
        self.fresh = True  # the last span saw capture off
        self.ids = itertools.count(1)
        self._lock = threading.Lock()
        self._local = threading.local()

    def stack(self) -> List[Span]:
        try:
            return self._local.stack
        except AttributeError:
            self._local.stack = []
            return self._local.stack

    def add(self, s: Span) -> None:
        with self._lock:
            if self.fresh:
                self.records, self.fresh = [], False
            self.records.append(s)


_CAPTURE = _Capture()


def _begin_capture_at_session_start() -> None:
    """Wrap torch's session-start hook so that each session begins a new
    capture, also where no span runs between two sessions. Without the
    hook (another torch), a span that sees the flag off still does."""
    start = getattr(_tap, "_run_on_profiler_start", None)
    if start is None or getattr(start, "begins_capture", False):
        return

    def on_start():
        _CAPTURE.fresh = True
        start()

    on_start.begins_capture = True
    _tap._run_on_profiler_start = on_start


_begin_capture_at_session_start()


def span(name: str, leaf: bool = False, **attrs):
    """A span as a context manager (``with span("icp.align") as s: ...;
    s.set(blocks=3)``); with capture off, a shared object that does
    nothing."""
    if not _tap._is_profiler_enabled:
        _CAPTURE.fresh = True
        return _OFF
    return Span(name, leaf, attrs)


def _flat_span(name: str) -> Optional[Span]:
    """An open flat span (no parent) for an ``enter``, or None with
    capture off."""
    if not _tap._is_profiler_enabled:
        _CAPTURE.fresh = True
        return None
    s = Span(name, False, {})
    _CAPTURE.add(s)
    s.start_ns = time.time_ns()
    return s


def spans() -> List[Span]:
    """The spans of the latest capture (the latest session that recorded
    any), in the order they opened (a span still open has ``end_ns``
    None)."""
    return list(_CAPTURE.records)
