"""The feed of the ``localize`` mixes: queries against a prior map, one at
a time, through ``MapLocalizer.localize`` (the gated query) or
``MapLocalizer.localize_raw``.

Set-up makes the configuration's map scans on the card, builds the map
from the keyframes among them at their ground-truth poses (the full raw
cloud plus an ``edges`` layer the benchmark extracts itself), prepares
the held-out scans of the middle ``query_scans`` as queries (0.5 m voxel
dedup into the query capacity, plus its edges) and warms the call. The
window then cycles through the queries in an order drawn from the seed,
each from its ground-truth pose perturbed by a draw of the mix; a query's
latency is its wall time up to its result on the host.

A traced run also hands the roofline readers the real sizes behind the
padded search shapes: the map's points and its edges (the benchmark's
own voxel dedup of the keyframes) and the mean query sizes of the slice.
"""

from __future__ import annotations

import time

import numpy as np
import torch

import traffic as traffic_mod
import common
from common import BenchError
from slice_trace import Slice

# the mix's key for how many of the window's queries the reference checks
SAMPLE = "sample_queries"


def _result_host(call: str, res) -> dict:
    """The answer of a query on the host (a gated result already is)."""
    if call == "localize":
        return {"R": np.asarray(res.pose.R, np.float64), "t": np.asarray(res.pose.t, np.float64),
                "quality": float(res.quality), "accepted": bool(res.accepted),
                "reason": res.reject_reason}
    packed = torch.cat([res.pose.R.reshape(9), res.pose.t,
                        res.quality.reshape(1).to(torch.float32)]).cpu().numpy()
    return {"R": packed[:9].reshape(3, 3).astype(np.float64),
            "t": packed[9:12].astype(np.float64), "quality": float(packed[12])}


def run(ctx) -> dict:
    from mola_fe_lidar_tpu_torch.cloud.metric_map import from_points
    from mola_fe_lidar_tpu_torch.frontend.localizer import MapLocalizer
    from mola_fe_lidar_tpu_torch.geometry import se3

    cfg, mix, args, dev = ctx.cfg, ctx.traffic, ctx.args, ctx.device
    lc, mp = cfg["localizer"], cfg["map"]
    rh = cfg.get("rehearsal", {}) if ctx.rehearse else {}
    n_map = int(rh.get("map_scans", mp["scans"]))
    n_query = int(rh.get("query_scans", mp["query_scans"]))
    capacity = int(rh.get("map_capacity", lc["map_capacity"]))
    q_cap = int(rh.get("query_points", mix["query_points"]))
    edge_cap = int(mp["edges_capacity"])
    scans, gt = traffic_mod.scans(cfg, mix, args.seed, n_map, ctx.sensor_azimuths, dev)
    kf_idx = list(range(0, n_map, int(mp["keyframe_every"])))
    first = (n_map - n_query) // 2
    held_out = [i for i in range(first, first + n_query) if i not in kf_idx]
    edge = lambda pts: traffic_mod.edge_points(pts, float(mp["edges_voxel_m"]), edge_cap, dev)
    kf_raw = [traffic_mod.valid_points(scans[i]) for i in kf_idx]
    kf_edges = [edge(p) for p in kf_raw]
    q_raw = [traffic_mod.spread_subsample(
        traffic_mod.voxel_first(traffic_mod.valid_points(scans[i]), float(mix["query_voxel_m"])),
        q_cap) for i in held_out]
    q_edges = [edge(traffic_mod.valid_points(scans[i])) for i in held_out]
    ctx.mark("inputs_made")

    multi_start = int(rh.get("multi_start", lc["multi_start"]))
    loc = MapLocalizer(map_capacity=capacity, voxel_size=float(lc["voxel_size"]),
                       start_sigma_xyz=float(lc["start_sigma_xyz"]),
                       agree_tol_m=float(lc["agree_tol_m"]), multi_start=multi_start, device=dev)
    loc.build([({"raw": from_points(p, capacity=capacity, device=dev),
                 "edges": from_points(e, capacity=edge_cap, device=dev)}, gt[i])
               for p, e, i in zip(kf_raw, kf_edges, kf_idx)])
    queries = [{"raw": from_points(p, capacity=q_cap, device=dev),
                "edges": from_points(e, capacity=edge_cap, device=dev)}
               for p, e in zip(q_raw, q_edges)]
    order = traffic_mod.query_order(args.seed, len(held_out))
    n_draws = 100000
    draws = traffic_mod.perturbations(args.seed, n_draws, float(mix["sigma_xyz_m"]),
                                      float(mix["sigma_yaw_deg"]))
    call = mix["call"]
    fn = getattr(loc, call)

    sl = Slice("query") if args.trace else None
    in_slice = []     # the queries the traced slice ran

    def query(j: int):
        q = int(order[j % len(order)])
        if sl is not None and sl.open:
            in_slice.append(q)
        R0, t0 = traffic_mod.perturbed(gt[held_out[q]], draws[j % n_draws])
        init = se3.Pose(np.asarray(R0, np.float32), np.asarray(t0, np.float32))
        with torch.profiler.record_function(f"bench.{call}"):
            res = fn(queries[q], init)
            return q, (R0, t0), _result_host(call, res)

    for j in range(int(mix["warmup_queries"])):  # set-up: every shape of the call, once
        query(n_draws - 1 - j)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    ctx.ready()

    done = []
    t_start = time.perf_counter()
    t_end = t_start + args.seconds
    slice_at = t_start + float(mix["slice_after"]) * args.seconds
    j = 0
    started = None
    try:
        while True:
            now = time.perf_counter()
            if now >= t_end:
                break
            if sl is not None and started is None and now >= slice_at:
                sl.start()
                started = len(done)
            t0 = time.perf_counter()
            q, init, ans = query(j)
            t1 = time.perf_counter()
            if t1 <= t_end:
                done.append({"j": j, "query": q, "scan": held_out[q], "init": init,
                             "latency_s": t1 - t0, **ans})
            j += 1
            if (sl is not None and started is not None and sl.units == 0
                    and len(done) - started >= int(mix["slice_queries"])):
                sl.stop(len(done) - started)
        if sl is not None and started is not None and sl.units == 0:
            # a slice still open at the close runs on, outside the window,
            # until it holds its queries
            extra = len(done) - started
            while extra < int(mix["slice_queries"]):
                query(j)
                j += 1
                extra += 1
            sl.stop(extra)
    finally:
        if sl is not None:
            sl.abort()
    if dev.type == "cuda":
        torch.cuda.synchronize()
    ctx.read_memory()
    if not done:
        raise BenchError("no query completed inside the window")
    if sl is not None and sl.units > 0:
        dense, edges = traffic_mod.map_sizes(kf_raw, kf_edges, [gt[i] for i in kf_idx],
                                             float(lc["voxel_size"]))
        mean = lambda xs: sum(len(x) for x in xs) / len(xs)
        sl.valid = {"n": {q_cap: mean([q_raw[q] for q in in_slice]),
                          edge_cap: mean([q_edges[q] for q in in_slice])},
                    "m": {capacity: dense, "other": edges}}
    lat = [d["latency_s"] * 1e3 for d in done]
    accepted = [d.get("accepted") for d in done if "accepted" in d]
    return {
        "e2e": {"localize_p90_ms": common.percentile(lat, 90)},
        "latencies_ms": lat,
        "attempted": len(done),
        "failed": 0,
        "slice": sl if (sl is not None and sl.units > 0) else None,
        "info": {"queries_in_window": len(done), "latency_samples": len(lat),
                 "queries": len(held_out),
                 "accepted_share": (sum(accepted) / len(accepted)) if accepted else None},
        "state": {"scans": scans, "gt": gt, "kf_idx": kf_idx, "kf_raw": kf_raw,
                  "kf_edges": kf_edges, "q_raw": q_raw, "q_edges": q_edges, "done": done,
                  "capacity": capacity, "call": call, "multi_start": multi_start},
    }
