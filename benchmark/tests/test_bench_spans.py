"""The readers of the program's spans and counters (``probe_batch_ms``,
``host_issue_ms``, ``icp_iterations_per_query``, ``useful_iteration_pct``,
``match_host_ms``, ``solve_host_ms``) on span lists made here: a gated
query and two tracking queries, numbers worked out by hand. Each reader
gives None where its spans are absent: a program without span capture
(the parent of the change that added it), an empty capture, no slice,
and for ``probe_batch_ms`` a gated query rejected before its probes."""

from types import SimpleNamespace

import pytest

import common
from mola_fe_lidar_tpu_torch.utils import profiler

MS = 1_000_000
METRICS = ("probe_batch_ms", "host_issue_ms", "icp_iterations_per_query",
           "useful_iteration_pct", "match_host_ms", "solve_host_ms")


class _Spans:
    """Builds span records: ids in order, each under a parent (or a root)."""

    def __init__(self):
        self.out = []

    def add(self, name, parent, t0_ms, t1_ms, **attrs):
        sid = len(self.out) + 1
        request = sid if parent is None else self.out[parent - 1].request
        self.out.append(SimpleNamespace(name=name, id=sid, parent=parent, request=request,
                                        start_ns=int(t0_ms * MS), end_ns=int(t1_ms * MS),
                                        attrs=attrs))
        return sid

    def align(self, parent, t0, lanes, blocks, lane_its, match_ms, solve_ms, read_ms):
        """An ``icp.align`` of ``blocks`` blocks of 4, its leaves back to back."""
        a = self.add("icp.align", parent, t0, t0, lanes=lanes, block=4, blocks=blocks,
                     iterations=4 * blocks, lane_iterations=lane_its)
        t = t0
        for _ in range(blocks):
            for _ in range(4):
                self.add("icp.match", a, t, t + match_ms)
                self.add("icp.solve", a, t + match_ms, t + match_ms + solve_ms)
                t += match_ms + solve_ms
            self.add("icp.read", a, t, t + read_ms)
            t += read_ms
        self.out[a - 1].end_ns = int(t * MS)
        return t


def _gated(probes=True):
    """One gated query: a base align of 2 blocks (6 lane iterations), its
    read, and a probe batch of 10 lanes and 3 blocks (90 lane iterations)
    with its read; iterations 1 ms of matching and 2 of solving, block
    reads 3 ms, the two localize reads 5 and 2 ms. Plus a flat span of
    another thread, outside any query."""
    s = _Spans()
    root = s.add("localize", None, 0, 0)
    base = s.add("localize.base", root, 0, 0)
    t = s.align(base, 0, lanes=1, blocks=2, lane_its=6, match_ms=1, solve_ms=2, read_ms=3)
    s.out[base - 1].end_ns = int(t * MS)                    # base: 30 ms
    s.add("localize.read", root, t, t + 5)
    t += 5
    if probes:
        pb = s.add("localize.probes", root, t, t)
        t = s.align(pb, t, lanes=10, blocks=3, lane_its=90, match_ms=1, solve_ms=2, read_ms=3)
        s.add("localize.read", pb, t, t + 2)
        t += 2
        s.out[pb - 1].end_ns = int(t * MS)                  # probes: 47 ms
    s.out[root - 1].end_ns = int(t * MS)                    # root: 82 ms (35 without probes)
    s.add("doProcess.readback_wait", None, 0, 500)
    return s.out


def _tracking():
    """Two ``localize_raw`` queries, aligns of 2 and 3 blocks (5 and 11
    lane iterations); the caller's read is outside the roots."""
    s = _Spans()
    for blocks, lane_its in ((2, 5), (3, 11)):
        root = s.add("localize_raw", None, 0, 0)
        t = s.align(root, 0, lanes=1, blocks=blocks, lane_its=lane_its,
                    match_ms=1, solve_ms=2, read_ms=3)
        s.out[root - 1].end_ns = int(t * MS)
    return s.out


# (gated, rejected before the probes, tracking): the expected readings
EXPECTED = {
    # the probes span: 12 iterations x 3 ms + 3 reads x 3 ms + the read's 2 ms
    "probe_batch_ms": (47.0, None, None),
    # root less its reads: 82 - (5 + 2 + 5 x 3); 35 - (5 + 2 x 3); (30 - 6 + 45 - 9) / 2
    "host_issue_ms": (60.0, 24.0, 30.0),
    "icp_iterations_per_query": (20.0, 8.0, 10.0),
    # 100 x (6 + 90) / (1 x 8 + 10 x 12); 100 x 6 / 8; 100 x 16 / 20
    "useful_iteration_pct": (100.0 * 96 / 128, 75.0, 80.0),
    "match_host_ms": (1.0, 1.0, 1.0),
    "solve_host_ms": (2.0, 2.0, 2.0),
}


def _read(name, spans, monkeypatch, sl=object()):
    monkeypatch.setattr(profiler, "spans", lambda: list(spans))
    return common.load_reader(name).read({"slice": sl})


@pytest.mark.parametrize("name", METRICS)
def test_reader_on_made_spans(name, monkeypatch):
    for spans, want in zip((_gated(), _gated(probes=False), _tracking()), EXPECTED[name]):
        got = _read(name, spans, monkeypatch)
        assert got == (None if want is None else pytest.approx(want, rel=1e-12)), spans[0].name


@pytest.mark.parametrize("name", METRICS)
def test_reader_without_spans_gives_none(name, monkeypatch):
    assert _read(name, [], monkeypatch) is None
    assert _read(name, _tracking(), monkeypatch, sl=None) is None
    monkeypatch.delattr(profiler, "spans")
    assert common.load_reader(name).read({"slice": object()}) is None
