"""The feed of the ``stream`` mixes: a LiDAR scan stream through the
odometry front-end (``LidarOdometry.on_new_observation``), scan by scan.

Set-up makes every scan the window can use on the card (the mix's
warm-up, then ``rate_hz`` x the window's seconds, then the traced slice's
spare), builds the module from the configuration's ``module`` block (the
port's ``obs/runner.py::realtime_config()`` as data) with its recording
back-end, and runs the warm-up scans through it, at most ``max_pending``
pending. The window then hands scan after scan over at its sensor time
(the sensor's rate from the window's start), or, while ``max_pending``
scans are pending, as soon as one completes: the replay slows to the
program's pace and the module's overload drop never fires. A scan's latency runs
from its hand-over to the completion of the future that
``on_new_observation`` returned, when its pose is in the module's state.

The reference gets the raw scans, the program's poses (the module's
localization adverts, each relative to its keyframe, and the odometry
factors between keyframes), the timing that decides which deskew twist
the pipelined step used for a scan (``prefetch``) and each scan's filtered
layers as the program made them (``layers``): when a scan's future
completes, its layers (``state.last_points``) are copied to pinned host
buffers made in set-up, behind the program's work on the card, with no
wait. While the traced slice is open the local map's masks are kept the
same way, for the real sizes behind the slice's padded searches.
"""

from __future__ import annotations

import copy
import gc
import math
import threading
import time

import numpy as np
import torch

import traffic as traffic_mod
import common
from common import BenchError
from slice_trace import Slice

# the mix's key for how many of the window's scans the reference checks
SAMPLE = "sample_scans"
# a scan handed over within this long of the start of its predecessor's
# processing is in the intake when the predecessor prefetches (an align
# takes several blocks of device reads, tens of milliseconds at the least)
PREFETCH_SURE_S = 0.02
# the layers the front-end's registration and its checks read
LAYERS = ("decimated", "planes", "edges")


class _Kept:
    """Host copies of what the program produced, one row a scan: each
    scan's filtered layers (xyz, mask; the planes' normal and planarity)
    and, while ``maps_on``, the local map's masks. The buffers are pinned
    (on a card) and made in set-up: the layers' here, at the capacities
    ``caps`` ({layer: slots}), the map's by :meth:`alloc_maps` once the
    warm-up has built a map. A copy is queued behind the program's work and
    never waited for until :meth:`sync`."""

    def __init__(self, n_scans: int, n_maps: int, caps: dict, device):
        self.n_scans, self.n_maps, self.device = n_scans, n_maps, device
        self.pin = device.type == "cuda"
        self.buf = {}          # layer -> attr -> [n_scans, cap, ...]
        for name in LAYERS:
            self.buf[name] = {"xyz": self._alloc((n_scans, caps[name], 3)),
                              "mask": self._alloc((n_scans, caps[name]))}
        self.buf["planes"]["normal"] = self._alloc((n_scans, caps["planes"], 3))
        self.buf["planes"]["planarity"] = self._alloc((n_scans, caps["planes"]))
        self.have = set()
        self.map_buf = None    # layer -> [n_maps, cap]
        self.map_row = {}      # scan -> row of map_buf
        self._map_next = 0
        self.maps_on = False

    def _alloc(self, shape):
        return torch.empty(shape, dtype=torch.float32, pin_memory=self.pin)

    def put(self, j: int, mm) -> None:
        for name in LAYERS:
            pc, dst = mm[name], self.buf[name]
            dst["xyz"][j].copy_(pc.xyz, non_blocking=True)
            dst["mask"][j].copy_(pc.mask, non_blocking=True)
            if name == "planes":
                dst["normal"][j].copy_(pc.attrs["normal"], non_blocking=True)
                dst["planarity"][j].copy_(pc.attrs["planarity"].reshape(-1), non_blocking=True)
        self.have.add(j)

    def alloc_maps(self, local_map) -> None:
        """Make the map buffers at the capacities of ``local_map``."""
        self.map_buf = {name: self._alloc((self.n_maps, local_map[name].mask.shape[0]))
                        for name in LAYERS}

    def put_map(self, j: int, local_map) -> None:
        row = self._map_next % self.n_maps
        self._map_next += 1
        self.map_row = {k: r for k, r in self.map_row.items() if r != row}
        for name in LAYERS:
            self.map_buf[name][row].copy_(local_map[name].mask, non_blocking=True)
        self.map_row[j] = row

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize()

    def layers(self, j: int):
        """Scan ``j``'s layers as numpy arrays, or None where none was kept."""
        if j not in self.have:
            return None
        out = {}
        for name, d in self.buf.items():
            out[name] = {k: v[j].numpy() for k, v in d.items()}
        return out

    def map_masks(self, j: int):
        """The local map's masks as scan ``j``'s completion left them."""
        row = self.map_row.get(j)
        return None if row is None else {n: b[row].numpy() for n, b in self.map_buf.items()}


def module_config(ctx) -> dict:
    """The configuration's module block; at rehearsal sizes with the
    rehearsal block's capacity overrides (``key.path`` -> value)."""
    cfg = copy.deepcopy(ctx.cfg["module"])
    if ctx.rehearse:
        for key, val in ctx.cfg["rehearsal"]["module_overrides"].items():
            node = cfg["params"]
            parts = [int(x) if x.isdigit() else x for x in key.split(".")]
            for part in parts[:-1]:
                node = node[part]
            node[parts[-1]] = val
    return cfg


class _Stream:
    """Hands scans over on a schedule, at most ``max_pending`` pending, and
    records each one's hand-over and completion on the host clock. A scan
    that is due when another completes is handed over in that one's
    completion callback, on the module's scan thread before it takes its
    next scan: a scan handed over while its predecessor waits is then in
    the intake when the predecessor prefetches, whatever the feed's own
    thread is doing."""

    def __init__(self, module, scans, max_pending: int, kept: _Kept):
        self.module, self.scans, self.max_pending = module, scans, max_pending
        self.kept = kept
        self.records = {}        # scan index -> {"hand", "done", "dropped"}
        self.completed = []      # scan indices in the order they completed
        self.in_flight = 0
        self.next = 0            # the next scan to hand over
        self.stop_at = 0         # scans from here on are not handed over
        self.due = lambda j: float("-inf")   # host time scan j is due at
        self._cv = threading.Condition(threading.RLock())

    def schedule(self, stop_at: int, due) -> None:
        with self._cv:
            self.stop_at, self.due = stop_at, due
            self._feed()

    def _feed(self) -> None:
        """Hand over every scan that is due while there is room (lock held)."""
        now = time.perf_counter()
        while (self.next < self.stop_at and self.in_flight < self.max_pending
               and now >= self.due(self.next)):
            j = self.next
            self.next += 1
            rec = {"hand": time.perf_counter(), "done": None, "dropped": False}
            self.records[j] = rec
            fut = self.module.on_new_observation(self.scans[j])
            if fut is None:
                rec["dropped"] = True
                continue
            self.in_flight += 1
            fut.add_done_callback(lambda f, j=j: self._done(j))

    def _done(self, j: int) -> None:
        with self._cv:
            self.records[j]["done"] = time.perf_counter()
            self.in_flight -= 1
            self.completed.append(j)
            self._keep(j)
            self._feed()
            self._cv.notify_all()

    def _keep(self, j: int) -> None:
        """Queue the copies of scan ``j``'s layers (and, while the slice is
        open, the local map's masks). The future completes on the scan
        thread before it takes the next scan, so the module's last scan is
        ``j`` unless ``j`` was skipped or dropped as degenerate."""
        st = self.module.state
        if (st.last_points is None
                or st.last_obs_tim != float(self.scans[j].get("timestamp", 0.0))):
            return
        self.kept.put(j, st.last_points)
        if self.kept.maps_on and st.local_map is not None:
            self.kept.put_map(j, st.local_map)

    def step(self, until: float) -> None:
        """Hand over what is due, then wait for a completion, the next due
        time or ``until``, whichever comes first."""
        with self._cv:
            self._feed()
            now = time.perf_counter()
            wake = until
            if self.next < self.stop_at and self.in_flight < self.max_pending:
                wake = min(wake, self.due(self.next))
            if wake > now:
                self._cv.wait(wake - now)

    def finish(self) -> None:
        """Hand over nothing more and wait for the pending scans."""
        with self._cv:
            self.stop_at = self.next
            while self.in_flight:
                self._cv.wait(1.0)


def run(ctx) -> dict:
    from mola_fe_lidar_tpu_torch.frontend.backend import OptimizingBackend
    from mola_fe_lidar_tpu_torch.obs.runner import build_module

    cfg, mix, args, dev = ctx.cfg, ctx.traffic, ctx.args, ctx.device
    period = 1.0 / float(cfg["sensor"]["rate_hz"])
    n_warm = int(mix["warmup_scans"])
    n_slice = int(mix["slice_scans"])
    n_scans = n_warm + int(math.ceil(args.seconds / period)) + n_slice
    scans, _ = traffic_mod.scans(cfg, mix, args.seed, n_scans, ctx.sensor_azimuths, dev)
    ctx.mark("inputs_made")

    mcfg = module_config(ctx)
    backend = OptimizingBackend(device=dev)
    module = build_module(mcfg, backend=backend, device=dev)
    fep = next(f["params"] for f in mcfg["params"]["pointcloud_filter"]
               if f["class"].endswith("FilterEdgesPlanes"))
    kept = _Kept(n_scans, n_slice + 4, {n: int(fep[f"{n}_capacity"]) for n in LAYERS}, dev)
    stream = _Stream(module, scans, int(mix["max_pending"]), kept)
    try:
        # set-up: the first scans, each handed over once fewer than
        # max_pending are pending: the first scan, scan to scan, scan to
        # map, keyframes with their map rebuilds and a nearby check
        stream.schedule(n_warm, lambda j: float("-inf"))
        while len(stream.completed) + sum(r["dropped"] for r in stream.records.values()) < n_warm:
            stream.step(time.perf_counter() + 1.0)
        stream.finish()
        if module.drain() != 0:
            raise BenchError("the warm-up scans left work running")
        if dev.type == "cuda":
            torch.cuda.synchronize()
        if module.state.local_map is None:
            raise BenchError("the warm-up scans built no local map")
        kept.alloc_maps(module.state.local_map)
        ctx.mark("warmed_up")
        ctx.ready()
        out = _window(ctx, stream, n_warm, n_scans, period, n_slice)
        stream.finish()
        abandoned = module.drain()
        if dev.type == "cuda":
            torch.cuda.synchronize()
        ctx.read_memory()
    finally:
        module.shutdown()
        backend.flush()
        backend.shutdown()
    return _result(ctx, out, stream, backend, scans, mcfg, period, abandoned)


def _window(ctx, stream, n_warm, n_scans, period, n_slice) -> dict:
    """The measured window: it opens at the sensor time of its second
    scan, with the first already waiting, so scan ``j`` is due at ``(j -
    n_warm - 1) x period`` after the window's start; it is handed over once
    due and not held back by ``max_pending``. A traced run opens its slice
    after ``slice_after`` of the window and closes it once ``n_slice``
    scans have completed in it; a slice still open at the close runs on,
    outside the window, until it holds its scans."""
    args, mix = ctx.args, ctx.traffic
    sl = Slice("scan") if args.trace else None
    t_start = time.perf_counter()
    t_end = t_start + args.seconds
    slice_at = t_start + float(mix["slice_after"]) * args.seconds
    stream.next = n_warm
    stream.schedule(n_scans, lambda j: t_start + (j - n_warm - 1) * period)
    opened = None   # completions before the slice opened
    cpu0, gc0 = time.process_time(), sum(g["collections"] for g in gc.get_stats())
    try:
        while True:
            now = time.perf_counter()
            if sl is not None and opened is None and now >= slice_at:
                stream.kept.maps_on = True
                sl.start()
                opened = len(stream.completed)
            if (sl is not None and opened is not None and sl.units == 0
                    and len(stream.completed) - opened >= n_slice):
                sl.stop(len(stream.completed) - opened)
                stream.kept.maps_on = False
            slice_open = sl is not None and sl.units == 0
            if now >= t_end and not (slice_open and opened is not None):
                break
            until = t_end if now < t_end else now + 1.0
            if sl is not None and opened is None:
                until = min(until, slice_at)
            stream.step(until)
    finally:
        if sl is not None:
            sl.abort()
    host = {"window_cpu_s": time.process_time() - cpu0,
            "gc_collections": sum(g["collections"] for g in gc.get_stats()) - gc0}
    window = sorted(j for j, r in stream.records.items() if j >= n_warm and r["hand"] <= t_end)
    slice_scans = (stream.completed[opened:opened + sl.units]
                   if sl is not None and sl.units > 0 else [])
    return {"t_end": t_end, "window": window, "host": host,
            "slice": sl if slice_scans else None, "slice_scans": slice_scans}


def _quality_rows(n: int, keep: int) -> np.ndarray:
    """The rows of a scan's ``decimated`` that the program's quality reads:
    its fixed subsample (``models/icp.py``, seed 0xC0FFEE)."""
    return np.sort(np.random.default_rng(0xC0FFEE).permutation(n)[:keep])


def _slice_sizes(kept: _Kept, backend_log, period, scan_ids, mcfg):
    """The real sizes behind the padded searches of the traced slice's
    scans, as ``roofline.real_shape`` reads them (by pair of buffers), from
    the program's own masks: a scan's layers against the local map as the
    scan's completion left it, its quality subsample of ``decimated``
    against the map's ``decimated``, and, for the nearby checks, the
    layers of the last keyframes against each other."""
    q_max = int(mcfg["params"].get("local_map_quality_max_points", 0))
    window = int(mcfg["params"].get("local_map_keyframes", 10))

    def real(lay):
        r = {k: float(v["mask"].sum()) for k, v in lay.items()}
        n = lay["decimated"]["mask"].shape[0]
        if q_max and n > q_max:
            r["sub"] = float(lay["decimated"]["mask"][_quality_rows(n, q_max)].sum())
        else:
            r["sub"] = r["decimated"]
        return r

    acc = {}

    def add(key, a, b):
        acc.setdefault(key, []).append((a, b))

    for j in scan_ids:
        lay, masks = kept.layers(j), kept.map_masks(j)
        if lay is None or masks is None:
            continue
        r = real(lay)
        caps = {k: v["mask"].shape[0] for k, v in lay.items()}
        q_rows = min(q_max or caps["decimated"], caps["decimated"])
        mcap = {k: m.shape[0] for k, m in masks.items()}
        mreal = {k: float(m.sum()) for k, m in masks.items()}
        add((caps["decimated"], mcap["planes"]), r["decimated"], mreal["planes"])
        add((caps["edges"], mcap["edges"]), r["edges"], mreal["edges"])
        add((q_rows, mcap["decimated"]), r["sub"], mreal["decimated"])
    kf_scans = sorted(int(round(ts / period)) for ts in backend_log["keyframes"].values())
    last = max(scan_ids, default=-1)
    for k in [k for k in kf_scans if k <= last][-window:]:
        lay = kept.layers(k)
        if lay is None:
            continue
        r = real(lay)
        caps = {n: v["mask"].shape[0] for n, v in lay.items()}
        q_rows = min(q_max or caps["decimated"], caps["decimated"])
        add((caps["decimated"], caps["planes"]), r["decimated"], r["planes"])
        add((caps["edges"], caps["edges"]), r["edges"], r["edges"])
        add((q_rows, caps["decimated"]), r["sub"], r["decimated"])
    if not acc:
        return None
    return {"pairs": {f"{n}x{m}": [sum(a for a, _ in v) / len(v), sum(b for _, b in v) / len(v)]
                      for (n, m), v in acc.items()}}


def _result(ctx, out, stream, backend, scans, mcfg, period, abandoned) -> dict:
    t_end = out["t_end"]
    recs = stream.records
    window = out["window"]
    if not window:
        raise BenchError("no scan was handed over inside the window")
    backend_log = {
        "localizations": [(float(a.timestamp), int(a.reference_kf), a.pose.R, a.pose.t)
                          for a in backend.localizations],
        "keyframes": {int(k): float(v.timestamp) for k, v in backend.keyframes.items()},
        "factors": [(int(f.kf_from), int(f.kf_to), f.rel_pose.R, f.rel_pose.t)
                    for f in backend.factors],
    }
    posed = {int(round(ts / period)) for ts, *_ in backend_log["localizations"]}
    lost = [j for j in window if j not in posed]
    dropped = [j for j in window if recs[j]["dropped"]]
    lat = [(recs[j]["done"] - recs[j]["hand"]) * 1e3 for j in window
           if recs[j]["done"] is not None]
    in_time = sum(1 for j in window if recs[j]["done"] is not None and recs[j]["done"] <= t_end)
    if not lat:
        raise BenchError("no scan completed")
    done = [{"scan": j, "latency_s": (recs[j]["done"] - recs[j]["hand"])} for j in window
            if recs[j]["done"] is not None and j in posed]
    # scan j was in the intake while j - 1 prefetched: certain when it was
    # handed over before j - 1 could have reached its prefetch, certainly
    # not when it came after j - 1 had completed
    prefetch, lead = {}, []
    for j in sorted(recs):
        prev = recs.get(j - 1)
        if j < 2 or prev is None or prev["done"] is None or recs[j - 2]["done"] is None:
            prefetch[j] = False if j < 2 else None
            continue
        begun = max(prev["hand"], recs[j - 2]["done"])   # j - 1's processing began
        if recs[j]["hand"] <= prev["done"]:
            lead.append((recs[j]["hand"] - begun) * 1e3)
        if recs[j]["hand"] <= begun + PREFETCH_SURE_S:
            prefetch[j] = True
        elif recs[j]["hand"] >= prev["done"]:
            prefetch[j] = False
        else:
            prefetch[j] = None
    stream.kept.sync()
    state = {"scans": scans, "module": mcfg, "period": period, "backend": backend_log,
             "window": window, "done": done, "prefetch": prefetch,
             "layers": {j: stream.kept.layers(j) for j in sorted(stream.kept.have)}}
    sl = out["slice"]
    if sl is not None:
        sl.valid = _slice_sizes(stream.kept, backend_log, period, out["slice_scans"], mcfg)
    return {
        "e2e": {"scans_per_s": in_time / ctx.args.seconds,
                "pose_latency_p90_ms": common.percentile(lat, 90)},
        "latencies_ms": lat,
        "attempted": len(window),
        "failed": len(set(lost) | set(dropped)),
        "slice": sl,
        "info": {"scans_in_window": len(window), "poses_in_window": in_time,
                 "latency_samples": len(lat), "scans_made": len(scans),
                 "scans_lost": len(lost), "scans_dropped": len(dropped),
                 "keyframes": len(backend_log["keyframes"]),
                 "nearby_factors": sum(1 for a, b, *_ in backend_log["factors"] if b != a + 1),
                 "jobs_abandoned": abandoned,
                 "prefetch_unsure": sum(1 for j in recs if prefetch.get(j) is None),
                 "handover_after_start_ms_max": max(lead, default=None),
                 # the process's CPU seconds (all threads) and garbage
                 # collections from the window's start to the loop's end
                 **out["host"]},
        "state": state,
    }
