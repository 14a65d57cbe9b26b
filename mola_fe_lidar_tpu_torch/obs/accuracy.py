"""The accuracy harness's library half (port of the functions of the
reference repository's ``scripts/run_accuracy.py``; the command line is
``scripts/torch_run_accuracy.py``).

An HDL-64 replay (``obs/hdl64.py``) at the KITTI operating point is scored
on its keyframe and per-scan trajectories, and, on a revisiting route, on
its loop closures: how many were checked and accepted (the profiler's
``checkNonAdjacent.{lc,nearby}.accepted`` counters), whether the accepted
loop-closure factors lower the optimized trajectory's error
(:func:`lc_ablation_study`) and whether the robust pose-graph optimizer
holds one injected false loop closure off (:func:`false_lc_study`). The
rows carry the reference's keys, so a port row and a reference row read
side by side.
"""

from __future__ import annotations

import pickle
import subprocess
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

from ..frontend.backend import FactorRelativePose3, HostPose
from .metrics import ate_rmse
from .runner import REALTIME, _associate, build_config, per_scan_trajectory

# the harness's configurations: scan-to-scan with and without deskew, scan-
# to-map with and without deskew, and the realtime operating point
CONFIGS = ("deskew", "no_deskew", "local_map", "local_map_nodeskew", "realtime")
# simulated sequences cached by --sim-cache (git-ignored)
SIM_CACHE_DIR = Path(__file__).resolve().parent.parent / "build" / "sim"
# the run_replay keys a row copies, when present
ROW_KEYS = (
    "n_scans", "n_keyframes", "n_factors", "wall_s", "n_scan_poses",
    "jobs_abandoned", "wall_to_steady_s", "warm_s",
    "ate_rmse", "rpe_trans", "rpe_rot",
    "ate_rmse_scan", "rpe_trans_scan", "rpe_rot_scan",
    "kitti_t_rel_pct", "kitti_r_rel_deg_per_m", "kitti_segments",
    "ate_rmse_pgo", "ate_rmse_scan_pgo",
    "kitti_t_rel_pct_pgo")


def build_cfg(deskew: bool, scale: float = 1.0, local_map: bool = False, overrides=()):
    """The KITTI preset with optional deskew (``FilterDeskew`` first, scan-
    start anchor), scan-to-map odometry, capacities scaled by ``scale`` and
    ``key.path=json`` overrides; scan-to-scan unless ``local_map``."""
    return build_config(deskew=deskew, scale=scale, local_map=local_map, overrides=overrides)


def config(name: str, azimuth: int = 2048, overrides: Sequence[str] = ()) -> dict:
    """The configuration ``name`` (one of :data:`CONFIGS`) at ``azimuth``
    rays a beam; ``overrides`` come after the realtime levers, so they win."""
    if name not in CONFIGS:
        raise ValueError(f"unknown config {name!r}; choose from {CONFIGS}")
    over = (REALTIME if name == "realtime" else ()) + tuple(overrides)
    return build_cfg(deskew=name in ("deskew", "local_map", "realtime"), scale=azimuth / 2048,
                     local_map=name in ("local_map", "local_map_nodeskew", "realtime"),
                     overrides=over)


def device_line(device) -> str:
    """``name, power limit`` of the card as nvidia-smi prints it, or the
    device's type off the card: every time a script records names it."""
    if not str(device).startswith("cuda"):
        return str(device)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return smi.stdout.strip().splitlines()[0]


def sim_cache_path(scans: int, azimuth: int, moving_cars: int, route: str, speed: float,
                   parked_cars: int = 0) -> Path:
    """Where ``--sim-cache`` keeps a simulated sequence (the reference's
    file name)."""
    return SIM_CACHE_DIR / (f"hdl64_{scans}_{azimuth}_{moving_cars}_{route}_{speed:g}"
                            f"{'_p%d' % parked_cars if parked_cars else ''}.pkl")


def simulate(scans: int, azimuth: int = 2048, moving_cars: int = 0, parked_cars: int = 0,
             route: str = "block", speed: float = 8.0, cache: bool = False):
    """(observations, ground truth) of an HDL-64 sequence; with ``cache``,
    read from :func:`sim_cache_path` when it is there and written to it
    when it is not. Returns (observations, gt, loaded from the cache)."""
    from .hdl64 import hdl64_sequence

    path = sim_cache_path(scans, azimuth, moving_cars, route, speed, parked_cars)
    if cache and path.exists():
        with open(path, "rb") as fh:  # written by this function
            obs, gt = pickle.load(fh)
        return obs, gt, True
    obs, gt = hdl64_sequence(n_scans=scans, n_azimuth=azimuth, moving_cars=moving_cars,
                             parked_cars=parked_cars, route_kind=route, speed=speed)
    if cache:
        path.parent.mkdir(parents=True, exist_ok=True)
        with open(path, "wb") as fh:
            pickle.dump((obs, gt), fh, protocol=4)
    return obs, gt, False


def eval_scan_ate(backend, kf_poses, observations, gt_poses) -> float:
    """Scan-rate ATE of the per-scan trajectory that ``kf_poses`` implies
    (ground-truth index = scan index)."""
    return ate_rmse(*_associate(per_scan_trajectory(backend, kf_poses), observations, gt_poses))


def false_lc_study(res, obs, gt, robust: str) -> dict:
    """Inject ONE false loop closure (20 m lateral, 40 degrees of yaw,
    between the first keyframe and the middle one) and optimize three ways:
    clean with ``robust``, poisoned with plain least squares, poisoned with
    ``robust``. A robust kernel holds the poisoned ATE near the clean one
    while plain least squares is dragged off."""
    backend = res["backend"]
    kf_ids = sorted(backend.keyframes)
    a, b = kf_ids[0], kf_ids[len(kf_ids) // 2]
    cy, sy = np.cos(0.7), np.sin(0.7)
    Rbad = np.array([[cy, -sy, 0.0], [sy, cy, 0.0], [0.0, 0.0, 1.0]])
    bad = FactorRelativePose3(kf_from=a, kf_to=b,
                              rel_pose=HostPose(Rbad, np.array([20.0, -15.0, 0.0])))
    out = {"ate_clean_robust": eval_scan_ate(
        backend, backend.optimized_poses(robust=robust), obs, gt)}
    backend.factors.append(bad)
    try:
        out["ate_poisoned_plain"] = eval_scan_ate(
            backend, backend.optimized_poses(robust="none"), obs, gt)
        out["ate_poisoned_robust"] = eval_scan_ate(
            backend, backend.optimized_poses(robust=robust), obs, gt)
    finally:
        backend.factors.pop()
    out["injected_pair"] = [int(a), int(b)]
    return out


def lc_ablation_study(res, obs, gt, robust: str) -> dict:
    """The optimized scan-rate ATE with and without the accepted loop-
    closure factors (the pairs the module recorded in ``lc_pairs``)."""
    backend = res["backend"]
    pairs = {tuple(sorted(p)) for p in res["module"].state.lc_pairs}
    all_factors = list(backend.factors)
    ate_with = eval_scan_ate(backend, backend.optimized_poses(robust=robust), obs, gt)
    try:
        backend.factors[:] = [f for f in all_factors
                              if tuple(sorted((f.kf_from, f.kf_to))) not in pairs]
        ate_without = eval_scan_ate(backend, backend.optimized_poses(robust=robust), obs, gt)
    finally:
        backend.factors[:] = all_factors
    n_lc = sum(1 for f in all_factors if tuple(sorted((f.kf_from, f.kf_to))) in pairs)
    return {"n_lc_factors": n_lc, "ate_pgo_with_lc": ate_with,
            "ate_pgo_without_lc": ate_without}


def accuracy_row(res, obs, gt, name: str, *, pgo: bool = False, pgo_robust: str = "none",
                 inject_false_lc: bool = False, rtt_s: Optional[float] = None,
                 overrides: Sequence[str] = (), route: str = "block",
                 parked_cars: int = 0):
    """(row name, row) of one replay ``res`` of config ``name``: the
    run_replay metrics, rates, the loop-closure audit (``n_{lc,nearby}
    _checked`` / ``_accepted``), with ``pgo`` the false-loop-closure and
    loop-closure ablation studies, trajectory length and the profiler's
    stats. Overrides, a route other than ``block`` and parked cars key the
    name, so such a row never replaces a default one."""
    row = {k: res[k] for k in ROW_KEYS if k in res}
    row["scans_per_sec"] = res["n_scans"] / max(res["wall_s"], 1e-9)
    if res.get("scans_per_sec_steady"):
        row["scans_per_sec_steady"] = res["scans_per_sec_steady"]
        if rtt_s is not None:
            row["tunnel_rtt_ms"] = round(rtt_s * 1e3, 2)
            per_scan = 1.0 / res["scans_per_sec_steady"]
            if per_scan > rtt_s:
                row["scans_per_sec_steady_tunnel_adj"] = 1.0 / (per_scan - rtt_s)
    # the counters' count is the checks, their total the accepts
    pstats = res["module"].profiler.stats()
    for kind in ("lc", "nearby"):
        c = pstats.get(f"counter:checkNonAdjacent.{kind}.accepted")
        row[f"n_{kind}_checked"] = int(c["count"]) if c else 0
        row[f"n_{kind}_accepted"] = int(c["total"]) if c else 0
    study_kernel = pgo_robust if pgo_robust != "none" else "cauchy"
    if inject_false_lc and pgo:
        row["false_lc_study"] = false_lc_study(res, obs, gt, study_kernel)
    if pgo and row.get("n_lc_accepted", 0) > 0:
        row["lc_ablation"] = lc_ablation_study(res, obs, gt, study_kernel)
    length = sum(float(np.linalg.norm(gt[i + 1][1] - gt[i][1])) for i in range(len(gt) - 1))
    row["trajectory_m"] = round(length, 1)
    if "ate_rmse_scan" in row:
        row["ate_pct_of_traj"] = round(100.0 * row["ate_rmse_scan"] / length, 4)
    row["profile"] = pstats
    if overrides:
        row["overrides"] = list(overrides)
        name = name + "+" + ",".join(overrides)
    if route != "block":
        row["route"] = route
        row["scans"] = len(obs)
        name = f"{route}:{name}"
    if parked_cars:
        row["parked_cars"] = parked_cars
        name = f"{name}+parked{parked_cars}"
    return name, row
