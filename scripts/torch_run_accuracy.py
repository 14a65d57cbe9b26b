"""Accuracy harness of the PyTorch/CUDA port: HDL-64 replays at the KITTI
operating point, scored on the keyframe and per-scan trajectories and,
with ``--pgo``, on the optimized ones, with the loop-closure audit and
(``--inject-false-lc``) the false-loop-closure study. The command line of
the reference repository's ``scripts/run_accuracy.py``, with ``--device``
in place of ``--cpu``; the rows carry the same keys.

Run on the card (the revisiting ``relap`` route, then the default block):

    python3 scripts/torch_run_accuracy.py --scans 800 --route relap \\
        --parked-cars 400 --configs realtime --pgo --pgo-robust cauchy \\
        --inject-false-lc --sim-cache
    python3 scripts/torch_run_accuracy.py --scans 500 --configs realtime --pgo

Smoke on the CPU: ``--scans 12 --azimuth 256 --configs realtime --device cpu``.

Writes ``docs/torch_accuracy.json`` (``--out``) and prints one JSON line a
configuration; on the card a row also holds the K1/K2 launches of its
replay by shape (``kernel_launches``). A run on the same card (by name), azimuth and moving-car
count as the file's keeps the file's other rows; otherwise it replaces it.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import numpy as np  # noqa: E402


def round_trip_s(device: str) -> float:
    """The least time, of 30, of a one-element add on ``device`` read back
    to the host (``.item()``): on a card, a launch plus a synchronising
    device-to-host copy over PCIe, the floor under the scan step's one
    readback a scan."""
    import torch

    x = torch.zeros(1, device=device)
    (x + 1.0).item()
    times = []
    for _ in range(30):
        t0 = time.perf_counter()
        (x + 1.0).item()
        times.append(time.perf_counter() - t0)
    return min(times)


def launch_counts(reset: bool = False) -> dict:
    """The kernels' launches since the last reset, by shape
    (``"B=b nxm k=k"``), only of kernels that launched; ``reset`` zeroes
    the counts after reading them."""
    from mola_fe_lidar_tpu_torch.ops import knn_kernel, nn_kernel

    out = {}
    for name, mod in (("knn", knn_kernel), ("nearest_neighbors", nn_kernel)):
        if mod.launches_by_shape:
            out[name] = {f"B={b} {n}x{m} k={k}": c
                         for (b, n, m, k), c in sorted(mod.launches_by_shape.items())}
        if reset:
            mod.launches = 0
            mod.launches_by_shape.clear()
    return out


def merge_previous(path: Path, out: dict) -> dict:
    """``out`` with the rows of the file at ``path`` that ``out`` does not
    replace, when that file was written on the same card (by name), azimuth
    and moving-car count."""
    if not path.exists():
        return out
    try:
        prev = json.loads(path.read_text())
        card = lambda d: str(d.get("device", "")).split(",")[0]
        if card(prev) == card(out) and all(prev.get(k) == out[k]
                                           for k in ("azimuth", "moving_cars")):
            out = dict(out, results={**prev.get("results", {}), **out["results"]})
    except (json.JSONDecodeError, KeyError, AttributeError):
        pass
    return out


def main(argv=None) -> int:
    from mola_fe_lidar_tpu_torch.obs import accuracy

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scans", type=int, default=500)
    ap.add_argument("--azimuth", type=int, default=2048)
    ap.add_argument("--moving-cars", type=int, default=0)
    ap.add_argument("--parked-cars", type=int, default=0,
                    help="static near-field cars lining the streets "
                         "(obs.hdl64.add_parked_cars); raises the LC "
                         "paired-ratio ceiling on revisit routes")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the plain twins)")
    ap.add_argument("--configs", default="local_map,deskew,no_deskew",
                    help="comma list of: local_map (scan-to-map + deskew), "
                         "local_map_nodeskew, deskew, no_deskew (both "
                         "scan-to-scan), realtime (the 10 Hz operating point)")
    ap.add_argument("--route", default="block",
                    choices=["block", "snake", "outback", "relap"],
                    help="trajectory (obs.hdl64.make_route); 'relap' revisits "
                         "every street same-direction, 6 m off the first lap")
    ap.add_argument("--speed", type=float, default=8.0,
                    help="cruise speed m/s (corners are lat-accel limited)")
    ap.add_argument("--sim-cache", action="store_true",
                    help="cache the simulated sequence under "
                         "mola_fe_lidar_tpu_torch/build/sim/ (git-ignored)")
    ap.add_argument("--override", action="append", default=[], metavar="KEY=VALUE",
                    help="set a module param in every config (JSON value)")
    ap.add_argument("--warm-start", action="store_true",
                    help="build the kernels and run the primary per-scan paths on "
                         "the first observation before the replay clock starts "
                         "(recorded as warm_s)")
    ap.add_argument("--pgo", action="store_true",
                    help="also optimize the pose graph over the factor stream and "
                         "record *_pgo metric rows")
    ap.add_argument("--pgo-robust", default="none", choices=["none", "huber", "cauchy"],
                    help="robust kernel for the *_pgo rows")
    ap.add_argument("--inject-false-lc", action="store_true",
                    help="after the replay, inject one false loop-closure factor and "
                         "record the clean/poisoned/robust PGO ATE triplet "
                         "(requires --pgo)")
    ap.add_argument("--out", default=str(REPO / "docs" / "torch_accuracy.json"))
    ap.add_argument("--dump-traj", default="",
                    help="directory for per-config est/gt trajectory npz")
    args = ap.parse_args(argv)

    names = args.configs.split(",")
    for name in names:
        if name not in accuracy.CONFIGS:
            # a typo would silently run another configuration and record a bogus row
            raise SystemExit(f"unknown config {name!r}; choose from {accuracy.CONFIGS}")

    from mola_fe_lidar_tpu_torch.obs.runner import run_replay

    device = accuracy.device_line(args.device)
    rtt_s = round_trip_s(args.device)
    print(f"{device}: one-element add + read-back floor {rtt_s * 1e3:.3f} ms", file=sys.stderr)

    t0 = time.perf_counter()
    obs, gt, cached = accuracy.simulate(args.scans, args.azimuth, args.moving_cars,
                                        args.parked_cars, args.route, args.speed,
                                        cache=args.sim_cache)
    print(f"{'loaded' if cached else 'simulated'} {args.scans} scans "
          f"({args.azimuth * 64} rays each) in {time.perf_counter() - t0:.0f}s", file=sys.stderr)

    results = {}
    for name in names:
        cfg = accuracy.config(name, args.azimuth, args.override)
        launch_counts(reset=True)
        res = run_replay(obs, cfg, gt_poses=gt, device=args.device, pgo=args.pgo,
                         pgo_robust=args.pgo_robust, warm_start=args.warm_start)
        try:
            key, row = accuracy.accuracy_row(
                res, obs, gt, name, pgo=args.pgo, pgo_robust=args.pgo_robust,
                inject_false_lc=args.inject_false_lc, rtt_s=rtt_s, overrides=args.override,
                route=args.route, parked_cars=args.parked_cars)
            launches = launch_counts()
            if launches:  # the card's kernels (the CPU runs their twins)
                row["kernel_launches"] = launches
            if args.dump_traj and res.get("scan_poses"):
                d = Path(args.dump_traj)
                d.mkdir(parents=True, exist_ok=True)
                sp = res["scan_poses"]
                np.savez(d / f"{key}.npz", t=np.array([x[0] for x in sp]),
                         est_t=np.stack([x[1][1] for x in sp]),
                         est_R=np.stack([x[1][0] for x in sp]),
                         gt_t=np.stack([p for _, p in gt]), gt_R=np.stack([R for R, _ in gt]))
        finally:
            res["module"].shutdown()
        results[key] = row
        print(json.dumps({k: v for k, v in row.items() if k != "profile"}, default=float))

    out = {"device": device, "scans": args.scans, "azimuth": args.azimuth,
           "rays_per_scan": args.azimuth * 64, "moving_cars": args.moving_cars,
           "route": args.route, "speed": args.speed,
           "operating_point": "kitti-default.yaml (voxel 1.0 m, KF 3 m)",
           "results": results}
    path = Path(args.out)
    out = merge_previous(path, out)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(out, indent=1, default=float))
    print(json.dumps({"wrote": args.out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
