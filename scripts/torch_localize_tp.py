#!/usr/bin/env python3
"""Tensor-parallel align of the PyTorch port over a ``model`` mesh axis:
``make_sharded_align`` at TP 1, 2, 4 and 8 against a map of
``--tp-capacity`` points (the port of ``scripts/bench_localize_tp.py
--mode tp``).

    python3 scripts/torch_localize_tp.py [--tp-capacity 32768] [--iters 20]
        [--rounds 4] [--device cuda] [--out docs/torch_localize_tp.json]

The map is the reference script's: simulated HDL-64 scans at their true
poses, deduplicated in 0.15 m voxels until it holds ``--tp-capacity``
distinct points, a random ``--tp-capacity`` of them; the source is 2048 of
those points moved by a small random pose (seed 11). Point-to-point Horn,
20 iterations. The mesh has 8 positions (``force_device_count(8)``), laid
over the cards there are: on a one-card machine every position is that
card, so the rows measure the cost of splitting the search, not copies
between cards. After one call of each TP, the TPs take turns over
``--rounds`` rounds (1, 2, 4, 8, then 8, 4, 2, 1, ...), ``--iters`` calls
each, every call ending in a read of the result. Each row: ``tp``,
``wall_ms`` (the median of all its calls) and each round's median,
``per_chip_points``, the pose difference to the single-device align and
the error to the true pose, quality, and the K1/K2 launches of one call.
Prints one JSON object and writes it to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import numpy as np  # noqa: E402

SEED = 11


def _timed(fn, iters):
    """``iters`` calls, each ending in a read: (the last result, ms each)."""
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        res = fn()
        res.quality.cpu()
        times.append(1e3 * (time.perf_counter() - t0))
    return res, times


def _world(cap: int) -> np.ndarray:
    """The reference script's map: enough simulated coverage that ``cap``
    voxels of 0.15 m are distinct points."""
    from mola_fe_lidar_tpu_torch.cloud.voxel import voxel_first_indices_np
    from mola_fe_lidar_tpu_torch.obs.hdl64 import hdl64_sequence

    scans, az, vox = 12, 1024, 0.15
    while True:
        obs, gt = hdl64_sequence(n_scans=scans, n_azimuth=az)
        world = np.concatenate([
            o["xyz"][o["valid"] > 0] @ np.asarray(R, np.float32).T + np.asarray(t, np.float32)
            for o, (R, t) in zip(obs, gt)])
        world = world[voxel_first_indices_np(world, vox)]
        if len(world) >= cap or az >= 4096:
            break
        az *= 2
    if len(world) < cap:
        raise SystemExit(f"simulated world too small: {len(world)} < {cap}")
    return world


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tp-capacity", type=int, default=1 << 15)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=str(REPO / "docs" / "torch_localize_tp.json"))
    args = ap.parse_args(argv)

    import torch

    from mola_fe_lidar_tpu_torch.cloud.metric_map import from_points
    from mola_fe_lidar_tpu_torch.geometry import se3, se3_np
    from mola_fe_lidar_tpu_torch.models import ICPParams, Matcher, PairWeights, Solver, align
    from mola_fe_lidar_tpu_torch.ops import knn_kernel, nn_kernel
    from mola_fe_lidar_tpu_torch.parallel import make_mesh, make_sharded_align, mesh

    kind = torch.device(args.device).type
    if kind == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda needs a CUDA card")
    p2p = ICPParams(max_iterations=20,
                    matchers=(Matcher(kind="point2point", distance_threshold=2.0),),
                    solver=Solver(kind="horn"),
                    weights=PairWeights(use_scale_outlier_detector=False))
    rng = np.random.default_rng(SEED)
    cap = args.tp_capacity
    world = _world(cap)
    world = world[rng.permutation(len(world))[:cap]].astype(np.float32)
    tau = rng.normal(0, 0.05, 6)
    true = se3_np.exp(tau)
    sel = rng.permutation(cap)[:2048]
    Ri, ti = se3_np.inverse(true)
    src_pts = (world[sel] @ Ri.T + ti).astype(np.float32)
    src = {"raw": from_points(src_pts, capacity=2048, device=args.device)}
    tgt = {"raw": from_points(world, capacity=cap, device=args.device)}
    eye = se3.Pose(torch.eye(3, device=args.device), torch.zeros(3, device=args.device))
    ref_t = align(src, tgt, eye, p2p).pose.t.cpu().numpy()

    tps = (1, 2, 4, 8)
    previous = mesh.force_device_count(8)
    try:
        positions = mesh.devices(kind)
        rows, runs, times = {}, {}, {tp: [] for tp in tps}
        for tp in tps:
            runs[tp] = f = make_sharded_align(make_mesh({"model": tp}, positions), p2p)
            before = (knn_kernel.launches, nn_kernel.launches)
            res = f(src, tgt, eye)
            R, t = res.pose.R.cpu().numpy().astype(np.float64), res.pose.t.cpu().numpy()
            err = np.linalg.norm(se3_np.compose((R, t), se3_np.inverse(true))[1])
            rows[tp] = {"tp": tp, "per_chip_points": cap // tp,
                        "pose_diff_vs_single_m": float(np.linalg.norm(t - ref_t)),
                        "trans_err_vs_true_m": float(err), "quality": float(res.quality),
                        "kernel_launches": {"knn": knn_kernel.launches - before[0],
                                            "nearest_neighbors": nn_kernel.launches - before[1]}}
        for r in range(args.rounds):
            for tp in (tps if r % 2 == 0 else tps[::-1]):
                times[tp].append(_timed(lambda: runs[tp](src, tgt, eye), args.iters)[1])
        for tp in tps:
            rows[tp]["wall_ms"] = float(np.median(np.concatenate(times[tp])))
            rows[tp]["wall_ms_by_round"] = [float(np.median(x)) for x in times[tp]]
            print(json.dumps(rows[tp]), file=sys.stderr)
    finally:
        mesh.force_device_count(previous)

    cards = sorted({str(d) for d in positions})
    if kind == "cuda":
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60, check=True).stdout.strip().splitlines()
        card = f"{torch.cuda.get_device_name(0)} ({smi[0]})"
    else:
        card = "CPU (no device time)"
    out = {"backend": f"8 mesh positions on {len(cards)} device(s) {cards}, {card}"
                      + ("; the positions share one device: no copies between devices"
                         if len(cards) == 1 else ""),
           "target_capacity": cap, "src_capacity": 2048, "rows": [rows[tp] for tp in tps]}
    text = json.dumps(out, indent=1)
    print(text)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
