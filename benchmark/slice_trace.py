"""The traced slice of a ``--trace 1`` run: ``torch.profiler`` over a few
queries in the middle of the window, reduced to what the
per-layer readers and the ``breakdown`` need.

Only a slice is traced: a gated query alone makes about 120,000 launches.
The slice is bounded by a ``bench.slice`` range; its length is the
window the idle share is taken over. The K1/K2 launch counters of the
program (``launches_by_shape``) are read at both ends, so the roofline
readers see the shapes launched inside the slice; the feed adds the real
sizes behind those padded shapes (``valid``).
"""

from __future__ import annotations

import time
from collections import Counter, defaultdict
from typing import Dict, List, Optional, Tuple

import torch


def _is_annotation(e, name: str) -> bool:
    """Whether a device event is the profiler's copy of a host range
    (``record_function``) rather than device work."""
    kind = getattr(e, "activity_type", None)
    if kind is not None:
        return kind() not in ("kernel", "gpu_memcpy", "gpu_memset")
    flag = getattr(e, "is_user_annotation", None)
    return (flag is not None and flag()) or name.startswith("bench.")


def _device_kind(e, name: str) -> str:
    """``kernel``, or ``copy`` for a memory copy or fill."""
    kind = getattr(e, "activity_type", None)
    if kind is not None:
        return "kernel" if kind() == "kernel" else "copy"
    return "copy" if name.startswith(("Memcpy", "Memset")) else "kernel"


def _counters() -> Dict[str, Counter]:
    from mola_fe_lidar_tpu_torch.ops import knn_kernel, nn_kernel
    return {"knn": Counter(knn_kernel.launches_by_shape),
            "nn": Counter(nn_kernel.launches_by_shape)}


def _sync() -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


class Slice:
    """Start and stop a traced slice; after :meth:`stop` and
    :meth:`reduce` the reduced trace is in the attributes."""

    def __init__(self, unit: str):
        self.unit = unit            # what a unit of work is, e.g. "query"
        self.units = 0              # units completed in the slice
        self.window_s = 0.0
        self.busy_s = 0.0
        self.kernel_launches = 0
        self.kernel_time: Dict[str, float] = {}     # kernel name -> device seconds
        self.shapes: Dict[str, Counter] = {}        # "knn"/"nn" -> (B, n, m, k) counts
        self.idle_gaps: List[Tuple[str, float]] = []
        self.range_s = 0.0          # the bench.slice range's length in the trace
        # the real sizes behind padded search shapes, set by the feed:
        # {"n": {padded: real}, "m": {padded: real, "other": real}}
        self.valid: Optional[dict] = None
        self._prof = None
        self._range = None
        self._before = None
        self._closed = None         # (profiler, end) of a slice not yet reduced

    @property
    def open(self) -> bool:
        return self._prof is not None

    def start(self) -> None:
        _sync()
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self._prof = torch.profiler.profile(activities=acts)
        self._prof.__enter__()
        self._range = torch.profiler.record_function("bench.slice")
        self._range.__enter__()
        self._before = _counters()
        self._ns0 = time.time_ns()

    def stop(self, units: int) -> None:
        """Close the slice over ``units`` units. The trace is reduced later,
        by :meth:`reduce`, so that closing the slice stalls nothing."""
        _sync()
        ns1 = time.time_ns()
        after = _counters()
        prof, self._prof = self._prof, None
        self._range.__exit__(None, None, None)
        prof.__exit__(None, None, None)
        self.units = units
        self.shapes = {k: after[k] - self._before[k] for k in after}
        self._closed = (prof, ns1)

    def reduce(self) -> None:
        """Reduce the closed slice's trace (once)."""
        if self._closed is not None:
            prof, ns1 = self._closed
            self._closed = None
            self._reduce(prof.profiler.kineto_results.events(), self._ns0, ns1)

    def abort(self) -> None:
        """Leave the profiler if the slice is still open (an error path)."""
        if self._prof is not None:
            self._range.__exit__(None, None, None)
            self._prof.__exit__(None, None, None)
            self._prof = None

    def _reduce(self, events, ns0: int, ns1: int) -> None:
        """Device intervals and host operations of the trace, clipped to the
        slice. The slice's ends are the host clock's at start and stop
        (the profiler stamps its events on the same system clock); the
        ``bench.slice`` range only checks that the two agree."""
        lo, hi = ns0, ns1
        ranges = []
        dev, cpu = [], []
        cuda = torch.autograd.DeviceType.CUDA
        for e in events:
            name = e.name()
            on_device = e.device_type() == cuda
            if on_device and _is_annotation(e, name):
                continue  # the device-side copy of a host range, not work
            if on_device:
                dev.append((e.start_ns(), e.end_ns(), name, _device_kind(e, name)))
            elif name == "bench.slice":
                ranges.append((e.start_ns(), e.end_ns()))
            else:
                cpu.append((e.start_ns(), e.end_ns(), name))
        self.range_s = max((b - a for a, b in ranges), default=0) * 1e-9
        self.window_s = (hi - lo) * 1e-9
        busy = 0
        end = lo
        gaps = []
        by_name = defaultdict(int)
        for s, t, name, kind in sorted(dev):
            s, t = max(s, lo), min(t, hi)
            if t <= s:
                continue
            if kind == "kernel":
                self.kernel_launches += 1
            by_name[name] += t - s
            if s > end:
                gaps.append((s - end, end, s))
            busy += max(0, t - max(s, end))
            end = max(end, t)
        if hi > end:
            gaps.append((hi - end, end, hi))
        self.busy_s = busy * 1e-9
        self.kernel_time = {k: v * 1e-9 for k, v in by_name.items()}
        gaps.sort(reverse=True)
        self.idle_gaps = [(_label(cpu, a, b), g * 1e-9) for g, a, b in gaps[:10]]

    def search_seconds(self) -> Dict[str, float]:
        """Device seconds of the K1 (``knn``) and K2 (``nn``) kernels."""
        from roofline import kernel_of
        out: Dict[str, float] = defaultdict(float)
        for name, t in self.kernel_time.items():
            if kernel_of(name) is not None:
                out[kernel_of(name)] += t
        return dict(out)

    def top_device_ops(self, n: int = 10) -> List[Tuple[str, float]]:
        return sorted(self.kernel_time.items(), key=lambda kv: -kv[1])[:n]


def _label(cpu, a: int, b: int) -> str:
    """The host operation that overlaps the idle gap [a, b] the most; the
    benchmark's own ``bench.*`` ranges only where no operation of the
    program overlaps it."""
    best = {True: ("host", 0), False: ("host", 0)}
    for s, t, name in cpu:
        if name == "bench.slice":
            continue
        ov = min(t, b) - max(s, a)
        own = name.startswith("bench.")
        if ov > best[own][1]:
            best[own] = (name, ov)
    return best[False][0] if best[False][1] > 0 else best[True][0]


def breakdown(sl: Optional[Slice]) -> Optional[dict]:
    if sl is None:
        return None
    return {"device_ops": [[k, v] for k, v in sl.top_device_ops(10)],
            "idle_gaps": [[k, v] for k, v in sl.idle_gaps[:10]]}
