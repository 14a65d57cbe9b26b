#!/usr/bin/env python3
"""Time the nearby-keyframe and loop-closure batches of the PyTorch port on
one CUDA card: alone, under ``torch.profiler``, and beside a second thread
that runs scan-to-map aligns (the scan step's align), with the batch on the
default stream and on a side stream.

    python3 scripts/torch_search_profile.py [--out PATH]

Inputs: 8 simulated full-resolution HDL-64 scans (131,072 rays) filtered by
the port on the card. The nearby batch aligns scans 0-4 onto scan 7 with the
module's nearby stages (B = 5, the realtime preset's ``max_nearby_align_
checks``); the loop-closure batch aligns scan 7 onto a submap of scans 0-6
(the module's submap builder, centre scan 3) from 10 Monte-Carlo guesses
(B = 10) with the loop-closure stages. Every timing ends in the batch's one
readback. Prints one JSON object and writes it to ``--out`` (default: the
git-ignored ``mola_fe_lidar_tpu_torch/build/search_profile.json``).
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import threading
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent


def _events(prof):
    """(top CPU ops by self time, sync/copy counts, device ms) of a trace."""
    rows = prof.key_averages()
    dev = lambda e: getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0.0))
    top = sorted(rows, key=lambda e: e.self_cpu_time_total, reverse=True)[:12]
    count = lambda word: sum(e.count for e in rows if word in e.key)
    return ([{"op": e.key, "calls": e.count, "self_cpu_ms": e.self_cpu_time_total / 1e3}
             for e in top],
            {"cudaStreamSynchronize": count("cudaStreamSynchronize"),
             "cudaMemcpyAsync": count("cudaMemcpyAsync"),
             "cudaLaunchKernel": count("cudaLaunchKernel") + count("cudaLaunchKernelEx"),
             "device_ms": sum(dev(e) for e in rows) / 1e3})


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=str(REPO / "mola_fe_lidar_tpu_torch" / "build"
                                         / "search_profile.json"))
    args = ap.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("torch_search_profile: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    from mola_fe_lidar_tpu_torch.filters.generators import apply_generators
    from mola_fe_lidar_tpu_torch.frontend.odometry import _packed_align, _stack_maps
    from mola_fe_lidar_tpu_torch.geometry import se3, se3_np
    from mola_fe_lidar_tpu_torch.models.config import AlignKind
    from mola_fe_lidar_tpu_torch.obs.hdl64 import hdl64_sequence
    from mola_fe_lidar_tpu_torch.obs.runner import build_module, realtime_config
    from mola_fe_lidar_tpu_torch.parallel.batch import monte_carlo_guesses

    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60).stdout.strip().splitlines()[0]
    module = build_module(realtime_config(), device=dev)
    obs, gt = hdl64_sequence(n_scans=8, n_azimuth=2048)
    layers = [module._filter_core(apply_generators(module.generators, o),
                                  torch.zeros(6, device=dev))[0] for o in obs]

    def rel(i, j):  # pose of scan j in scan i's frame
        return se3_np.compose(se3_np.inverse(gt[i]), gt[j])

    def f32(x):
        return torch.as_tensor(np.asarray(x), dtype=torch.float32, device=dev)

    # nearby batch: scans 0-4 onto scan 7
    guesses = [rel(7, i) for i in range(5)]
    nearby_src = _stack_maps([layers[i] for i in range(5)])
    nearby_R, nearby_t = f32([R for R, _ in guesses]), f32([t for _, t in guesses])
    nearby_stages = module._nearby_stages()
    nearby = lambda: _packed_align(nearby_src, layers[7], nearby_R, nearby_t,
                                   nearby_stages).cpu()
    one = lambda: _packed_align(layers[0], layers[7], nearby_R[0], nearby_t[0],
                                nearby_stages).cpu()
    # loop-closure batch: scan 7 onto the submap around scan 3
    builder = module._lc_submap_builder()
    for i in range(7):
        builder.add_keyframe(layers[i], rel(3, i))
    submap = builder.build()
    center = rel(3, 7)
    mc = monte_carlo_guesses(torch.Generator().manual_seed(1),
                             se3.Pose(f32(center[0]), f32(center[1])),
                             module.params.loop_closure_montecarlo_samples,
                             0.1 * module.params.max_dist_to_loop_closure, np.deg2rad(2.0))
    lc_stages = module.icp_cases[AlignKind.LOOP_CLOSURE]
    lc = lambda: _packed_align(layers[7], submap, mc.R, mc.t, lc_stages).cpu()
    # the scan step's align: scan 7 onto the map of scans 0-6
    map_builder = module._make_map_builder()
    for i in range(7):
        map_builder.add_keyframe(layers[i], gt[i])
    local_map = map_builder.build()
    map_stages = module._stages_for(AlignKind.LIDAR_ODOMETRY, True)
    scan_guess = (f32(gt[7][0]), f32(gt[7][1] + np.array([0.05, -0.03, 0.0])))
    scan = lambda: _packed_align(layers[7], local_map, *scan_guess, map_stages).cpu()

    def timed(fn, reps=3):
        fn()  # warm-up
        ts = []
        for _ in range(reps):
            t0 = time.perf_counter()
            out = fn()
            ts.append(time.perf_counter() - t0)
        return statistics.median(ts) * 1e3, out

    result = {"card": card, "torch": torch.__version__}
    for name, fn in (("nearby_B5", nearby), ("nearby_B1", one), ("lc_B10", lc),
                     ("scan_align", scan)):
        ms, out = timed(fn)
        out = np.atleast_2d(out.numpy())
        result[name] = {"ms": ms, "iterations": out[:, 49].tolist(),
                        "quality": out[:, 48].tolist()}
        print(f"{name}: {ms:.1f} ms, iterations {out[:, 49].tolist()}")
    for name, fn in (("nearby_B5", nearby), ("lc_B10", lc), ("scan_align", scan)):
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            wall = (time.perf_counter() - t0) * 1e3
        top, counts = _events(prof)
        result[name]["profile"] = {"wall_ms_profiled": wall, **counts, "top_cpu": top}
        print(f"{name} profiled: wall {wall:.1f} ms, {counts}")

    # beside a thread that aligns scans back to back
    for label, side in (("default_stream", False), ("side_stream", True)):
        stop = threading.Event()
        scans = []

        def scan_loop():
            while not stop.is_set():
                t0 = time.perf_counter()
                scan()
                scans.append(time.perf_counter() - t0)

        worker = threading.Thread(target=scan_loop)
        worker.start()
        time.sleep(1.0)
        stream = torch.cuda.Stream(dev) if side else None
        batch_ms = {}
        for name, fn in (("nearby_B5", nearby), ("lc_B10", lc)):
            t0 = time.perf_counter()
            if stream is not None:
                with torch.cuda.stream(stream):
                    fn()
            else:
                fn()
            batch_ms[name] = (time.perf_counter() - t0) * 1e3
        stop.set()
        worker.join(timeout=600)
        result[label] = {**{f"{k}_ms": v for k, v in batch_ms.items()},
                         "scan_align_ms_median": statistics.median(scans) * 1e3,
                         "scan_aligns": len(scans)}
        print(f"{label}: {result[label]}")

    module.shutdown()
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(result, indent=1))
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
