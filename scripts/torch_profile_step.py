"""Per-program time of the port's scan step (port of the reference
repository's ``scripts/profile_step.py``).

The replay's profiler spans mix a program's own time with the time it
waits behind the other thread's launches, so each program of the scan
step is timed here ALONE, warm, each call ended by a read of a small
result to the host (median and minimum of ``--reps``):

  ingest_host    ``apply_generators`` (the raw cloud padded on the host and
                 copied to the device)
  filter         the scan filter (deskew, voxel statistics, edges / planes /
                 decimated) and its sanity values
  align_map      the scan-to-local-map align at the operating point, packed
  map_build      the rolling local map's rebuild (once a keyframe)
  nearby_batch   the nearby-keyframe batch (``max_nearby_align_checks``
                 lanes against the newest keyframe)

after a warm replay of ``--scans`` scans, which builds the kernels and the
rolling map and twist state the programs run on. The scans are the first
of the 500-scan block sequence that ``torch_run_accuracy.py --sim-cache``
caches, or simulated anew when that cache is missing.

    python3 scripts/torch_profile_step.py [--scans 60] [--reps 10]
    python3 scripts/torch_profile_step.py --scans 6 --azimuth 256 --reps 2 --device cpu
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))


def timed(fn, reps, readback):
    """Median and least wall ms of ``fn()`` with ``readback`` of its result
    copied to the host inside each call's time."""
    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        readback(fn()).cpu()
        out.append(time.perf_counter() - t0)
    return {"median_ms": round(1e3 * sorted(out)[len(out) // 2], 2),
            "min_ms": round(1e3 * min(out), 2), "reps": reps}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scans", type=int, default=60)
    ap.add_argument("--azimuth", type=int, default=2048)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--config", default="realtime", choices=["realtime", "local_map", "s2s"],
                    help="realtime (the operating point), local_map (scan-to-map without "
                         "the realtime levers) or s2s (scan-to-scan)")
    ap.add_argument("--override", action="append", default=[], metavar="KEY=VALUE",
                    help="extra module param overrides on top of --config")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the plain twins)")
    args = ap.parse_args(argv)

    import numpy as np
    import torch
    from mola_fe_lidar_tpu_torch.filters.generators import apply_generators
    from mola_fe_lidar_tpu_torch.frontend.backend import InMemoryBackend
    from mola_fe_lidar_tpu_torch.frontend.odometry import (_pack_icp_result, _packed_align,
                                                           _stack_maps)
    from mola_fe_lidar_tpu_torch.frontend.worldmodel import ANNOTATION_NAME_PC_LAYERS
    from mola_fe_lidar_tpu_torch.models.config import AlignKind
    from mola_fe_lidar_tpu_torch.obs import accuracy
    from mola_fe_lidar_tpu_torch.obs.runner import build_module

    cache = accuracy.sim_cache_path(500, args.azimuth, 0, "block", 8.0)
    if cache.exists() and args.scans <= 500:
        obs = accuracy.simulate(500, args.azimuth, cache=True)[0][:args.scans]
    else:
        obs = accuracy.simulate(args.scans, args.azimuth)[0]

    name = {"realtime": "realtime", "local_map": "local_map", "s2s": "deskew"}[args.config]
    device = torch.device(args.device)
    module = build_module(accuracy.config(name, args.azimuth, args.override),
                          backend=InMemoryBackend(), device=device)
    try:
        t0 = time.perf_counter()
        for o in obs:
            while module._pending > module.params.max_queue_length // 2:
                time.sleep(0.002)  # lossless feed, as run_replay's
            module.on_new_observation(o)
        module.drain()
        warm_s = time.perf_counter() - t0
        st = module.state
        table = {"device": accuracy.device_line(args.device), "config": args.config,
                 "warm_replay_scans": len(obs),
                 "warm_scans_per_sec": round(len(obs) / warm_s, 2)}

        nxt = obs[-1]
        table["ingest_host"] = timed(lambda: apply_generators(module.generators, nxt),
                                     args.reps, lambda r: next(iter(r.values())).mask[:1])
        raw = apply_generators(module.generators, nxt)
        tw = module._on_device(st.twist_smooth)
        table["filter"] = timed(lambda: module._filter_core(raw, tw), args.reps,
                                lambda r: r[1])
        mm_f, _ = module._filter_core(raw, tw)
        if st.local_map is not None:
            prev = (st.world_R, st.world_t)
            table["align_map"] = timed(
                lambda: module._align_core(AlignKind.LIDAR_ODOMETRY, True, mm_f, st.local_map,
                                           st.world_R, st.world_t, tw, prev, 0.1),
                args.reps, lambda r: _pack_icp_result(r[1]))
            builder = module._local_map_builder
            if builder is not None:
                table["map_build"] = timed(builder.build, args.reps,
                                           lambda r: next(iter(r.values())).mask.sum())

        # the nearby batch on the newest keyframe, as _check_nearby_batch runs it
        wm = module.worldmodel
        kfs = sorted(module.slam_backend.keyframes)
        if len(kfs) >= 2:
            cur = wm.annotation(kfs[-1], ANNOTATION_NAME_PC_LAYERS)
            oth = wm.annotation(kfs[-2], ANNOTATION_NAME_PC_LAYERS)
            if cur is not None and oth is not None:
                k = max(1, module.params.max_nearby_align_checks)
                to_pcs = _stack_maps([oth] * k)
                gRs = module._on_device(np.stack([np.eye(3)] * k))
                gts = module._on_device(np.full((k, 3), 3.0))
                stages = module._nearby_stages()
                table["nearby_batch"] = dict(
                    timed(lambda: _packed_align(to_pcs, cur, gRs, gts, stages), args.reps,
                          lambda r: r),
                    batch=k, max_iterations=max(s.max_iterations for s in stages))
    finally:
        module.shutdown()
    print(json.dumps(table, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
