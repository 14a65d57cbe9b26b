"""Diagnose loop-closure aligns offline (port of the reference repository's
``scripts/diag_lc.py``).

Picks true revisit pairs (in the loop-closure metric window, far apart in
scans) of a simulated HDL-64 sequence by GROUND TRUTH, runs the scan
filter on both scans, and aligns them with the LOOP_CLOSURE ICP case
three ways:

  gt        from the exact ground-truth relative pose (what the stages can
            score when handed the answer)
  gt+mc     a Monte-Carlo batch around the ground truth (the module's
            search, centred on the truth)
  drift+mc  a Monte-Carlo batch around a drifted guess (1.5 m and 1 degree
            off, as a graph estimate with odometry drift would be)

plus the paired-ratio ceiling at the true pose, the best goodness of any
align that converged far from the truth from street-lattice shifts, and
per-layer paired ratios at both poses. This separates "the Monte-Carlo
search misses the basin" from "the quality gate cannot score a correct
align" -- the two causes of a loop-closure acceptance drought.

With ``--replay`` it instead replays the sequence at the realtime
operating point with a drained feed: each scan is handed over once the
previous one and every check it started have finished, so every accepted
edge is in the graph before the next scan picks its checks, whatever the
checks cost. It prints each loop-closure check (keyframes, goodness,
verdict) and then the accuracy row (``+drained`` appended to its name).
This takes timing out of which revisits become loop-closure checks.

Run on the card, on the sequence ``torch_run_accuracy.py --sim-cache``
cached (the route arguments name the cache):

    python3 scripts/torch_diag_lc.py --scans 800 --route relap --speed 8 \\
        --parked-cars 400
    python3 scripts/torch_diag_lc.py --fresh-sim --scans 140 --azimuth 256 \\
        --route outback --speed 16 --device cpu   # CPU-sized smoke
    python3 scripts/torch_diag_lc.py --replay --scans 800 --route relap \\
        --speed 8 --parked-cars 400

Prints one JSON line per pair (or per loop-closure check).
"""

from __future__ import annotations

import argparse
import json
import logging
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import numpy as np  # noqa: E402


def revisit_pairs(t: np.ndarray, n_pairs: int, min_sep: int):
    """(i, j): every 10th scan i and the middle scan j of those 5-15 m
    from it and more than ``min_sep`` scans apart, up to ``n_pairs``."""
    pairs = []
    for i in range(0, len(t), 10):
        d = np.linalg.norm(t - t[i], axis=1)
        js = np.nonzero((d > 5.0) & (d < 15.0) & (np.abs(np.arange(len(t)) - i) > min_sep))[0]
        if len(js):
            pairs.append((i, int(js[len(js) // 2])))
        if len(pairs) >= n_pairs:
            break
    return pairs


class _DrainedFeed(list):
    """The observations, each handed out on the first pass once ``module``
    has no scan queued or running and no check or map build in flight."""

    module = None
    _done = False

    def __iter__(self):
        if self._done:
            yield from list.__iter__(self)
            return
        for o in list.__iter__(self):
            while self.module is not None:
                m = self.module
                with m._pending_lock:
                    if m._pending == 0 and m._nearby_inflight == 0:
                        break
                time.sleep(0.002)
            yield o
        self._done = True


class _LCChecks(logging.Handler):
    """The module's loop-closure verdicts, as logged."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.lines = []

    def emit(self, record):
        msg = record.getMessage()
        if msg.startswith(("lc rejected", "loop closure ACCEPTED")):
            self.lines.append(msg)


def drained_replay(args, obs, gt, device) -> None:
    """The realtime configuration over ``obs`` with a drained feed; prints
    each loop-closure verdict, then the accuracy row."""
    from mola_fe_lidar_tpu_torch.obs import accuracy, runner

    feed = _DrainedFeed(obs)
    build = runner.build_module

    def build_and_watch(*a, **kw):
        feed.module = build(*a, **kw)
        return feed.module

    checks = _LCChecks()
    logger = logging.getLogger("mola_fe_lidar_tpu_torch")
    logger.setLevel(logging.INFO)
    logger.addHandler(checks)
    runner.build_module = build_and_watch
    try:
        res = runner.run_replay(feed, accuracy.config("realtime", args.azimuth), gt_poses=gt,
                                device=device, pgo=True, pgo_robust="cauchy")
    finally:
        runner.build_module = build
        logger.removeHandler(checks)
    try:
        name, row = accuracy.accuracy_row(res, obs, gt, "realtime", pgo=True,
                                          pgo_robust="cauchy", inject_false_lc=True,
                                          route=args.route, parked_cars=args.parked_cars)
    finally:
        res["module"].shutdown()
    for line in checks.lines:
        print(json.dumps({"lc": line}), flush=True)
    row.pop("profile")
    print(json.dumps({name + "+drained": row}, default=float), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cache", default=None,
                    help="a pickled (observations, gt) sequence; by default the "
                         "--sim-cache file of the route arguments below")
    ap.add_argument("--azimuth", type=int, default=2048,
                    help="sim resolution (capacities scale along, as in the harness)")
    ap.add_argument("--fresh-sim", action="store_true",
                    help="ignore the cache; simulate the --route sequence at --azimuth")
    ap.add_argument("--route", default="outback")
    ap.add_argument("--speed", type=float, default=16.0)
    ap.add_argument("--parked-cars", type=int, default=0)
    ap.add_argument("--scans", type=int, default=260)
    ap.add_argument("--pairs", type=int, default=4)
    ap.add_argument("--min-sep-scans", type=int, default=60)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the plain twins)")
    ap.add_argument("--replay", action="store_true",
                    help="replay the sequence with a drained feed instead of aligning pairs")
    args = ap.parse_args(argv)

    import pickle

    import torch
    from mola_fe_lidar_tpu_torch.filters.generators import apply_generators
    from mola_fe_lidar_tpu_torch.frontend.backend import InMemoryBackend
    from mola_fe_lidar_tpu_torch.frontend.odometry import _packed_align, _unpack_icp_result
    from mola_fe_lidar_tpu_torch.geometry import se3, se3_np
    from mola_fe_lidar_tpu_torch.models.config import AlignKind
    from mola_fe_lidar_tpu_torch.obs import accuracy
    from mola_fe_lidar_tpu_torch.obs.runner import build_module
    from mola_fe_lidar_tpu_torch.ops.nn_kernel import nearest_neighbors
    from mola_fe_lidar_tpu_torch.parallel.batch import monte_carlo_guesses
    from mola_fe_lidar_tpu_torch.solve.quality import paired_ratio

    if args.fresh_sim:
        obs, gt, _ = accuracy.simulate(args.scans, args.azimuth, 0, args.parked_cars,
                                       args.route, args.speed)
    else:
        cache = Path(args.cache) if args.cache else accuracy.sim_cache_path(
            args.scans, args.azimuth, 0, args.route, args.speed, args.parked_cars)
        with open(cache, "rb") as fh:  # written by obs.accuracy.simulate
            obs, gt = pickle.load(fh)
    if args.replay:
        drained_replay(args, obs, gt, args.device)
        return 0
    t = np.stack([p for _, p in gt])
    R = np.stack([Rm for Rm, _ in gt])
    pairs = revisit_pairs(t, args.pairs, args.min_sep_scans)
    if not pairs:
        raise SystemExit("no revisit pairs in this sequence")

    device = torch.device(args.device)
    module = build_module(accuracy.config("realtime", args.azimuth),
                          backend=InMemoryBackend(), device=device)
    lc_stages = module.icp_cases[AlignKind.LOOP_CLOSURE]
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)

    def filtered(k):
        """Scan k's layers, deskewed with the sensor-frame twist from the
        ground truth, as keyframe clouds are stored deskewed."""
        k2 = min(k + 1, len(gt) - 1)
        rel = se3_np.compose(se3_np.inverse((R[k], t[k])), (R[k2], t[k2]))
        mm, _ = module._filter_core(apply_generators(module.generators, obs[k]),
                                    f32(se3_np.log(*rel) / 0.1))
        return mm

    def moved_ratio(li, lj, Rm, tm, thr):
        """Paired ratio of layer ``li`` against ``lj`` moved by (Rm, tm)."""
        moved = lj.xyz @ f32(Rm).T + f32(tm)
        nn = nearest_neighbors(li.xyz, li.mask, moved, lj.mask)
        return round(float(paired_ratio(nn.dist, li.mask, thr)), 3)

    n_mc = module.params.loop_closure_montecarlo_samples
    sig = 0.1 * module.params.max_dist_to_loop_closure
    try:
        for i, j in pairs:
            mm_i, mm_j = filtered(i), filtered(j)
            # pose of scan j (to) in the frame of scan i (from)
            Rrel, trel = se3_np.compose(se3_np.inverse((R[i], t[i])), (R[j], t[j]))

            def align(gR, gt_):
                """The best-goodness lane of an LC align of j onto i."""
                flats = _packed_align(mm_j, mm_i, f32(gR), f32(gt_), lc_stages).cpu().numpy()
                return flats, _unpack_icp_result(flats[int(np.argmax(flats[:, 48]))])

            def scored(gR, gt_):
                out = align(gR, gt_)[1]
                Rf = np.asarray(out.found_pose_to_wrt_from.R, np.float64)
                tf = np.asarray(out.found_pose_to_wrt_from.t, np.float64)
                rerr = np.degrees(np.arccos(np.clip((np.trace(Rrel.T @ Rf) - 1) / 2, -1, 1)))
                return {"goodness": round(float(out.goodness), 3),
                        "trans_err_m": round(float(np.linalg.norm(tf - trel)), 3),
                        "rot_err_deg": round(float(rerr), 2)}

            def guesses(Rc, tc, seed):
                g = monte_carlo_guesses(torch.Generator().manual_seed(seed),
                                        se3.Pose(f32(Rc), f32(tc)), n_mc, sig, np.radians(2.0))
                return g.R.cpu().numpy(), g.t.cpu().numpy()

            row = {"pair": [i, j], "metric_dist_m": round(float(np.linalg.norm(t[j] - t[i])), 1)}
            # the paired-ratio ceiling at the TRUE pose: below the gate, no
            # optimizer can pass this pair
            row["gt_quality_ceiling"] = moved_ratio(mm_i["decimated"], mm_j["decimated"],
                                                    Rrel, trel, 0.30)
            row["gt"] = scored(Rrel[None], trel[None])
            row["gt+mc"] = scored(*guesses(Rrel, trel, 1000 + i))
            cy, sy = np.cos(np.radians(1.0)), np.sin(np.radians(1.0))
            Rd = np.array([[cy, -sy, 0], [sy, cy, 0], [0, 0, 1]]) @ Rrel
            row["drift+mc"] = scored(*guesses(Rd, trel + np.array([0.9, 1.2, 0.0]), 2000 + i))
            # the wrong-basin margin: the same align from street-lattice
            # shifted guesses; the gate must sit between the best goodness
            # found far from the truth and the true pose's
            shifts = np.array([[8, 0, 0], [-8, 0, 0], [0, 8, 0], [0, -8, 0],
                               [4, 0, 0], [0, 4, 0], [12, 0, 0], [0, 12, 0]], float)
            flats, _ = align(np.broadcast_to(Rrel, (len(shifts), 3, 3)), trel[None] + shifts)

            def layer_ratios(Rm, tm):
                """Per-layer paired ratios at a pose of j in i's frame."""
                out = {}
                for layer, thrs in (("decimated", (0.30,)), ("edges", (0.50, 0.80, 1.20))):
                    for thr in thrs:
                        key = layer if len(thrs) == 1 else f"{layer}@{thr:g}"
                        out[key] = moved_ratio(mm_i[layer], mm_j[layer], Rm, tm, thr)
                return out

            wrong_best, n_far, wrong_pose = 0.0, 0, None
            for f in flats:
                out = _unpack_icp_result(f)
                tf = np.asarray(out.found_pose_to_wrt_from.t, np.float64)
                if np.linalg.norm(tf - trel) > 1.5:
                    n_far += 1
                    if float(out.goodness) > wrong_best:
                        wrong_best = float(out.goodness)
                        wrong_pose = (np.asarray(out.found_pose_to_wrt_from.R, np.float64), tf)
            row["wrong_basin"] = {"best_goodness": round(wrong_best, 3), "n_stayed_far": n_far,
                                  "n_inits": len(shifts)}
            row["layers_true"] = layer_ratios(Rrel, trel)
            if wrong_pose is not None:
                row["layers_wrong"] = layer_ratios(*wrong_pose)
            print(json.dumps(row), flush=True)
    finally:
        module.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
