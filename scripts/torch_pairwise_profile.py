#!/usr/bin/env python3
"""Where the time goes in a kNN = 6 point-to-plane align of the PyTorch
port, on one CUDA card: host wall time (ended by the result's readback),
then one run under ``torch.profiler`` for the kernel launches, the device
time and K1's share of it.

    python3 scripts/torch_pairwise_profile.py [--out PATH]

Two aligns:

* ``quickstart``: the kNN = 6 stage of the reference runner's quickstart
  configuration (``DEFAULT_CFG``: 30 iterations, 8 Gauss-Newton steps, K1
  at 8192 x 8192 every iteration) between two consecutive synthetic circle
  scans filtered by the port (0.7 m voxels, 8192 points), from the pose its
  point-to-point Horn stage reaches;
* ``pairs``: ``icp_settings_regular`` (100 iterations, 20 Gauss-Newton
  steps, the scale-outlier gate) on bench.py's 64 scan pairs of 2048
  points as one batch of 64 lanes from identity.

Prints one JSON object and writes it to ``--out`` (default: the git-
ignored ``mola_fe_lidar_tpu_torch/build/pairwise_profile.json``).
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent


def _search_profile():
    spec = importlib.util.spec_from_file_location(
        "torch_search_profile", REPO / "scripts" / "torch_search_profile.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=str(REPO / "mola_fe_lidar_tpu_torch" / "build"
                                         / "pairwise_profile.json"))
    args = ap.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("torch_pairwise_profile: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    from mola_fe_lidar_tpu_torch.filters.generators import apply_generators
    from mola_fe_lidar_tpu_torch.frontend.icp_config import icp_stages_from_config
    from mola_fe_lidar_tpu_torch.geometry import se3
    from mola_fe_lidar_tpu_torch.models import align, icp_settings_regular
    from mola_fe_lidar_tpu_torch.obs.runner import DEFAULT_CFG, build_module, default_config
    from mola_fe_lidar_tpu_torch.obs.scan_pairs import make_pairs, stack_pairs
    from mola_fe_lidar_tpu_torch.obs.synthetic import synthetic_sequence

    events = _search_profile()._events
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    out = {"card": smi.stdout.strip().splitlines()[0]}

    obs, _ = synthetic_sequence(kind="circle", n_scans=40, loop_side=40 / math.pi)
    module = build_module(default_config(), device=dev)
    try:
        tgt, src = (module._filter_core(apply_generators(module.generators, o),
                                        torch.zeros(6, device=dev))[0] for o in obs[:2])
    finally:
        module.shutdown()
    horn, knn6 = icp_stages_from_config(DEFAULT_CFG["params"]["icp_settings_with_vel"])
    eye = se3.Pose(torch.eye(3, device=dev), torch.zeros(3, device=dev))
    start = align(src, tgt, eye, horn).pose

    src64, tgt64, _ = stack_pairs(make_pairs(np.random.default_rng(7), 64, 2048), 2048,
                                  device=dev)
    eye64 = se3.Pose(torch.eye(3, device=dev).expand(64, 3, 3).contiguous(),
                     torch.zeros(64, 3, device=dev))
    runs = {"quickstart": lambda: align(src, tgt, start, knn6),
            "pairs": lambda: align(src64, tgt64, eye64, icp_settings_regular())}
    for name, fn in runs.items():
        res = fn()
        res.quality.cpu()
        walls = []
        for _ in range(3):
            t0 = time.perf_counter()
            res = fn()
            res.quality.cpu()
            walls.append(time.perf_counter() - t0)
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            res = fn()
            res.quality.cpu()
        top, counts = events(prof)
        rows = prof.key_averages()
        dev_time = lambda e: getattr(e, "self_device_time_total",
                                     getattr(e, "self_cuda_time_total", 0.0))
        k1 = [e for e in rows if "knn_search" in e.key]
        iters = res.n_iterations.cpu().numpy().reshape(-1)
        out[name] = {
            "wall_ms": statistics.median(walls) * 1e3,
            "iterations_max": int(iters.max()), "iterations_mean": float(iters.mean()),
            "launches": counts["cudaLaunchKernel"],
            "launches_per_iteration": counts["cudaLaunchKernel"] / max(int(iters.max()), 1),
            "device_ms": counts["device_ms"],
            "device_busy_share": counts["device_ms"] / (statistics.median(walls) * 1e3),
            "k1_launches": sum(e.count for e in k1),
            "k1_device_ms": sum(dev_time(e) for e in k1) / 1e3,
            "syncs": counts["cudaStreamSynchronize"], "copies": counts["cudaMemcpyAsync"],
            "top_cpu_ops": top[:8],
        }
        print(f"{name}: wall {out[name]['wall_ms']:.1f} ms, {out[name]['launches']} launches "
              f"({out[name]['launches_per_iteration']:.0f} an iteration, "
              f"{out[name]['iterations_max']} iterations), device {out[name]['device_ms']:.2f} ms "
              f"({100 * out[name]['device_busy_share']:.1f} % busy), K1 "
              f"{out[name]['k1_launches']} launches {out[name]['k1_device_ms']:.3f} ms")
    print(json.dumps(out))
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
