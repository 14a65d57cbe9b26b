"""Span capture (``utils/profiler.py``) and the spans of the map localizer
and the ICP loop.

Capture is on only under a ``torch.profiler`` session: without one a
gated query records nothing and opens no ``record_function`` range. Under
a CPU session the query makes one ``localize`` root whose ``localize.base``
and ``localize.probes`` hold the aligns' ``icp.align`` spans and their
leaves, all under the root's request id; the counters agree with the
result; each leaf's range in the profiler's own events lies within 1 ms of
the span's stamps; and the answer is the same to the bit with capture on
and off.

Scene: three 256-point keyframes of a small synthetic world and a query
on the middle one from 5 cm / 1 degree off, ``multi_start`` 3 (two probe
lanes from 5 cm), so every align converges within a block or two; the
two queries take ~0.8 s of the CPU.
"""

import threading

import numpy as np
import pytest
import torch

from mola_fe_lidar_tpu_torch.cloud.metric_map import from_points
from mola_fe_lidar_tpu_torch.frontend.localizer import MapLocalizer
from mola_fe_lidar_tpu_torch.geometry import se3
from mola_fe_lidar_tpu_torch.obs.synthetic import SyntheticWorld
from mola_fe_lidar_tpu_torch.utils import profiler

torch.set_num_threads(1)

LEAVES = {"localize.read", "icp.refresh", "icp.match", "icp.solve", "icp.read", "icp.final"}


def _yaw(a):
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])


def _session():
    """A CPU profiler session: the Kineto session that
    ``torch.profiler.profile`` wraps, without the wrapper's first start in a
    process, which imports torch's compiler stack (~2.5 s of the CPU)."""
    return torch.autograd.profiler.profile(use_kineto=True, use_cpu=True)


class _CountRanges:
    """Stands in for ``record_function`` and counts the ranges opened."""

    def __init__(self, real):
        self.real, self.entered = real, 0

    def __call__(self, name, *a, **k):
        self.entered += 1
        return self.real(name, *a, **k)


@pytest.fixture(scope="module")
def run():
    """One gated query with capture off (ranges counted), then the same
    query under a CPU profiler session."""
    w = SyntheticWorld(extent=30.0, n_world_points=8000, points_per_scan=256,
                       max_range=30.0, seed=6)
    kfs = []
    for i, (x, a) in enumerate(((0.0, 0.0), (3.0, 0.05), (6.0, -0.04))):
        R, t = _yaw(a), np.array([x, 0.5 * i, 0.0])
        kfs.append(({"raw": from_points(w.scan_at(R, t), capacity=256, device="cpu")}, (R, t)))
    loc = MapLocalizer(map_capacity=1024, voxel_size=0.25, multi_start=3,
                       start_sigma_xyz=0.05, device="cpu")
    loc.build(kfs)
    scan = kfs[1][0]
    init = se3.Pose(_yaw(0.07).astype(np.float32), np.array([3.05, 0.5, 0.0], np.float32))

    before = profiler.spans()
    counter = _CountRanges(torch.autograd.profiler.record_function)
    mp = pytest.MonkeyPatch()
    mp.setattr(torch.autograd.profiler, "record_function", counter)
    try:
        off = loc.localize(scan, init)
    finally:
        mp.undo()
    off_spans = profiler.spans()
    with _session() as prof:
        on = loc.localize(scan, init)
    return {"off": off, "on": on, "before": before, "off_spans": off_spans,
            "ranges_off": counter.entered, "spans": profiler.spans(),
            "events": prof.kineto_results.events()}


def test_no_session_records_nothing_and_opens_no_range(run):
    assert run["ranges_off"] == 0
    assert [id(s) for s in run["off_spans"]] == [id(s) for s in run["before"]]
    with profiler.span("outside") as s:
        s.set(n=1)
    assert all(x.name != "outside" for x in profiler.spans())


def test_gated_query_makes_one_tree(run):
    sp = run["spans"]
    assert run["on"].accepted and run["on"].n_starts == 3
    by_id = {s.id: s for s in sp}
    roots = [s for s in sp if s.parent is None]
    assert [r.name for r in roots] == ["localize"]
    root = roots[0]
    assert all(s.request == root.id and s.end_ns is not None for s in sp)
    assert all(s.parent in by_id for s in sp if s is not root)
    kids = [s.name for s in sp if s.parent == root.id]
    assert kids == ["localize.base", "localize.read", "localize.probes"]
    for s in sp:
        parent = by_id.get(s.parent)
        if s.name == "icp.align":
            assert parent.name in ("localize.base", "localize.probes")
        elif s.name.startswith("icp."):
            assert parent.name == "icp.align"
        assert parent is None or parent.start_ns <= s.start_ns <= s.end_ns <= parent.end_ns
        assert s.leaf == (s.name in LEAVES)
    probes = next(s for s in sp if s.name == "localize.probes")
    assert [s.name for s in sp if s.parent == probes.id] == ["icp.align"] * 3 + ["localize.read"]
    names = {s.name for s in sp}
    assert LEAVES <= names


def test_counters_agree_with_the_result(run):
    sp = run["spans"]
    by_id = {s.id: s for s in sp}
    aligns = [s for s in sp if s.name == "icp.align"]
    for a in aligns:
        c = a.attrs
        assert c["iterations"] == c["blocks"] * c["block"] and c["blocks"] >= 1
        assert 0 < c["lane_iterations"] <= c["lanes"] * c["iterations"]
        kids = [s.name for s in sp if s.parent == a.id]
        assert kids.count("icp.read") == c["blocks"]
        assert kids.count("icp.match") == kids.count("icp.solve") == c["iterations"]
    base = [a for a in aligns if by_id[a.parent].name == "localize.base"]
    probe = [a for a in aligns if by_id[a.parent].name == "localize.probes"]
    assert len(base) == len(probe) == 3
    assert {a.attrs["lanes"] for a in base} == {1} and {a.attrs["lanes"] for a in probe} == {2}
    assert base[-1].attrs["lane_iterations"] == run["on"].n_iterations


def test_leaf_ranges_lie_on_the_spans_clock(run):
    """Leaves of one name follow one another, so the n-th span and the n-th
    range of a name are the same phase; the span's stamps enclose its
    range (to 1 ms: a thread descheduled between them only widens it)."""
    events, leaves = {}, {}
    for e in run["events"]:
        if e.name() in LEAVES:
            events.setdefault(e.name(), []).append((e.start_ns(), e.end_ns()))
    for s in run["spans"]:
        if s.leaf:
            leaves.setdefault(s.name, []).append(s)
    assert events.keys() == leaves.keys() == LEAVES
    ms = 1_000_000
    for name, spans in leaves.items():
        assert len(events[name]) == len(spans), name
        for s, (a, b) in zip(spans, sorted(events[name])):
            assert s.start_ns - ms <= a <= b <= s.end_ns + ms, s


def test_capture_leaves_the_answer_bitwise_equal(run):
    off, on = run["off"], run["on"]
    for field in off._fields:
        a, b = getattr(off, field), getattr(on, field)
        if isinstance(a, se3.Pose):
            assert np.array_equal(a.R, b.R) and np.array_equal(a.t, b.t)
        elif isinstance(a, np.ndarray):
            assert np.array_equal(a, b)
        else:
            assert a == b, field


def test_scopes_and_flat_pairs_join_the_capture():
    """``ProfilerEntry`` scopes nest and keep their aggregates; an
    ``enter``/``leave`` pair left on another thread is one flat span; each
    session starts a new capture, also with no span between two sessions."""
    p = profiler.Profiler("p")
    with _session():
        with profiler.ProfilerEntry(p, "outer"):
            with profiler.span("inner", leaf=True, k=2) as s:
                s.set(k=3)
            p.enter("queue")
        t = threading.Thread(target=p.leave, args=("queue",))
        t.start()
        t.join(10)
    assert not t.is_alive()
    sp = profiler.spans()
    assert [s.name for s in sp] == ["outer", "inner", "queue"]
    outer, inner, queue = sp
    assert inner.parent == outer.id and inner.request == outer.id and inner.attrs == {"k": 3}
    assert queue.parent is None and queue.request == queue.id and queue.end_ns is not None
    assert p.stats()["outer"]["count"] == p.stats()["queue"]["count"] == 1
    with _session():  # straight after the first: no span saw the flag off
        with profiler.span("next"):
            pass
    assert [s.name for s in profiler.spans()] == ["next"]
    with profiler.span("between"):  # capture off: records nothing
        pass
    with _session():
        with profiler.span("last"):
            pass
    assert [s.name for s in profiler.spans()] == ["last"]
