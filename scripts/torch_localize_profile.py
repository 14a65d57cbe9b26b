#!/usr/bin/env python3
"""Where the time goes in a gated localize of the PyTorch port's map
localizer, on one CUDA card: host wall time (each call ends in its reads),
then one run under ``torch.profiler`` for the kernel launches, the device
time and K1's and K2's shares of it.

    python3 scripts/torch_localize_profile.py [--out PATH]

The scene is ``chip_smoke.py``'s localizer phase: 30 simulated HDL-64
scans, keyframes every 4 scans in a 2^17-point map, query scan 10 from the
phase's perturbed init (0.5 m / 2 degrees, seed 11). Three calls are
profiled apart: the gated ``localize`` (base pipeline, then the 10-lane
probe batch), its base pipeline alone (``localize`` with
``multi_start=1``), and ``localize_raw``.

Prints one JSON object and writes it to ``--out`` (default: the git-
ignored ``mola_fe_lidar_tpu_torch/build/localize_profile.json``).
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent


def _module(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=str(REPO / "mola_fe_lidar_tpu_torch" / "build"
                                         / "localize_profile.json"))
    args = ap.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("torch_localize_profile: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    from mola_fe_lidar_tpu_torch.frontend.localizer import MapLocalizer
    from mola_fe_lidar_tpu_torch.geometry import se3, se3_np
    from mola_fe_lidar_tpu_torch.obs.hdl64 import hdl64_sequence

    smoke = _module("chip_smoke", REPO / "chip_smoke.py")
    events = _module("torch_search_profile", REPO / "scripts" / "torch_search_profile.py")._events
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    out = {"card": smi.stdout.strip().splitlines()[0]}

    obs, gt = hdl64_sequence(n_scans=smoke.N_SCANS, n_azimuth=2048)
    items, query, _ = smoke.localizer_scene(dev, obs, gt)
    kw = dict(map_capacity=1 << 17, voxel_size=0.5, start_sigma_xyz=1.0, agree_tol_m=1.5,
              device=dev)
    gated, base = MapLocalizer(**kw), MapLocalizer(multi_start=1, **kw)
    gated.build(items)
    base.build(items)
    # the phase's init of its second query (scan 10)
    rng = np.random.default_rng(smoke.LOC_SEED)
    for i in smoke.LOC_QUERIES[:2]:
        dt, dyaw = rng.normal(0, 0.5, 3), rng.normal(0, np.deg2rad(2.0))
    true = (np.asarray(gt[i][0]), np.asarray(gt[i][1]))
    R, t = se3_np.compose(true, se3_np.exp(np.array([*dt, 0, 0, dyaw])))
    init = se3.Pose(np.asarray(R, np.float32), np.asarray(t, np.float32))
    scan = query(i)
    runs = {"localize": lambda: gated.localize(scan, init),
            "base_pipeline": lambda: base.localize(scan, init),
            "localize_raw": lambda: float(gated.localize_raw(scan, init).quality)}
    for name, fn in runs.items():
        fn()
        walls = []
        for _ in range(3):
            t0 = time.perf_counter()
            fn()
            walls.append(time.perf_counter() - t0)
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            fn()
        top, counts = events(prof)
        rows = prof.key_averages()
        dev_time = lambda e: getattr(e, "self_device_time_total",
                                     getattr(e, "self_cuda_time_total", 0.0))
        # the search's list length (demangled "knn_search<K, R>" or mangled
        # "knn_searchILiKE..."): K = 1 is K2
        lengths = {e.key: re.search(r"knn_search(?:_shared)?(?:<|ILi)(\d+)", e.key) for e in rows}
        k1 = [e for e in rows if lengths[e.key] and lengths[e.key].group(1) != "1"]
        k2 = [e for e in rows if lengths[e.key] and lengths[e.key].group(1) == "1"]
        wall = statistics.median(walls) * 1e3
        out[name] = {
            "wall_ms": wall,
            "launches": counts["cudaLaunchKernel"],
            "device_ms": counts["device_ms"],
            "device_busy_share": counts["device_ms"] / wall,
            "k1_launches": sum(e.count for e in k1),
            "k1_device_ms": sum(dev_time(e) for e in k1) / 1e3,
            "k2_launches": sum(e.count for e in k2),
            "k2_device_ms": sum(dev_time(e) for e in k2) / 1e3,
            "syncs": counts["cudaStreamSynchronize"], "copies": counts["cudaMemcpyAsync"],
            "top_cpu_ops": top[:8],
        }
        r = out[name]
        print(f"{name}: wall {wall:.1f} ms, {r['launches']} launches, device "
              f"{r['device_ms']:.2f} ms ({100 * r['device_busy_share']:.1f} % busy), K1 "
              f"{r['k1_launches']} launches {r['k1_device_ms']:.3f} ms, K2 {r['k2_launches']} "
              f"launches {r['k2_device_ms']:.3f} ms, {r['syncs']} syncs")
    print(json.dumps(out))
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
