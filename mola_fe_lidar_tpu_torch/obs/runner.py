"""Dataset replay runner (port of ``mola_fe_lidar_tpu/obs/runner.py``).

Builds the front-end by registry name, replays a dataset through it on a
chosen device and reports the trajectory metrics; ``--pgo`` also optimizes
the keyframe pose graph (``OptimizingBackend``) and reports ``*_pgo``
metrics, ``--out`` writes the keyframe trajectory in TUM format,
``--viz-out`` the trajectory and keyframe clouds as PLY files,
``--profile`` prints the module's profiler report and ``--mesh
data=N[,model=M]`` runs the front-end on a device mesh (``mesh_data`` /
``mesh_model``); ``--device cpu`` lays 8 positions over the CPU, as the
reference's ``--cpu`` makes 8 virtual CPU devices.

    python -m mola_fe_lidar_tpu_torch.obs.runner --dataset synthetic --scans 20
    python -m mola_fe_lidar_tpu_torch.obs.runner --dataset kitti --sequence 00 \
        --kitti-root /data/kitti --config mola_fe_lidar_tpu_torch/params/kitti-default.yaml \
        --device cuda --pgo --out traj.txt

Without ``--config`` the runner uses :data:`DEFAULT_CFG`, the reference
runner's quickstart configuration; :func:`realtime_config` is the KITTI
preset at the realtime operating point.
"""

from __future__ import annotations

import argparse
import copy
import json
import sys
import time
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..frontend import odometry as _odometry  # noqa: F401 -- registers LidarOdometry
from ..frontend.backend import OptimizingBackend
from ..frontend.module_base import MODULE_REGISTRY
from ..parallel import mesh
from ..utils.config import load_yaml
from .metrics import ate_rmse, kitti_segment_errors, rpe_rmse

PARAMS_DIR = Path(__file__).resolve().parent.parent / "params"

# The realtime operating point (scripts/run_accuracy.py REALTIME in the
# reference repository).
REALTIME = (
    "local_map_max_match_distance=0.75",
    "local_map_min_abs_step_trans=0.001",
    "local_map_min_abs_step_rot=0.0002",
    "local_map_max_iterations=15",
    "local_map_cand_knn=true",
    "local_map_nn_backend=mxu",
    "nearby_cand_knn=true",
    "local_map_quality_max_points=1024",
    "local_map_build_mode=hash",
    "nearby_max_iterations=10",
    "pointcloud_filter.1.params.stats_mode=scan",
)

# The reference runner's configuration for a replay without --config, a
# copy of ``mola_fe_lidar_tpu/obs/runner.py::DEFAULT_CFG`` (held equal by
# tests/test_torch_copies.py): a 0.7 m voxel downsample to 8192 points, a
# wide point-to-point Horn stage, then kNN = 6 point-to-plane
# (:func:`default_config`).
DEFAULT_CFG = {"params": {
    "min_time_between_scans": 0.01,
    "min_dist_xyz_between_keyframes": 3.0,
    "min_icp_goodness": 0.30,
    "min_icp_goodness_lc": 0.40,
    "min_dist_to_matching": 4.0,
    "max_dist_to_matching": 10.0,
    "max_dist_to_loop_closure": 14.0,
    "min_topo_dist_to_consider_loopclosure": 8,
    "loop_closure_montecarlo_samples": 6,
    "pointcloud_generator": [
        {"class": "GeneratorRawPoints", "params": {"capacity": 8192}}],
    "pointcloud_filter": [
        {"class": "FilterVoxelDownsample",
         "params": {"voxel_size": 0.7, "output_capacity": 8192}}],
    # coarse-to-fine stage vector: the wide point-to-point stage captures
    # large per-scan motion/rotation before the fine point-to-plane polish
    "icp_settings_with_vel": [
        {
            "params": {"maxIterations": 10},
            "matchers": [{"class": "Matcher_Points_DistanceThreshold",
                          "params": {"distanceThreshold": 6.0,
                                     "src_layer": "decimated",
                                     "tgt_layer": "decimated"}}],
            "solvers": [{"class": "Solver_Horn"}],
            "quality": [{"class": "QualityEvaluator_PairedRatio",
                         "params": {"thresholdDistance": 0.3,
                                    "src_layer": "raw", "tgt_layer": "raw"}}],
        },
        {
            "params": {"maxIterations": 30},
            "matchers": [{"class": "Matcher_Point2Plane",
                          "params": {"distanceThreshold": 2.0, "knn": 6,
                                     "planeEigenThreshold": 0.2,
                                     "src_layer": "decimated",
                                     "tgt_layer": "decimated"}}],
            "solvers": [{"class": "Solver_GaussNewton",
                         "params": {"maxIterations": 8}}],
            "quality": [{"class": "QualityEvaluator_PairedRatio",
                         "params": {"thresholdDistance": 0.3,
                                    "src_layer": "raw", "tgt_layer": "raw"}}],
        },
    ],
}}


def _apply_overrides(p: dict, overrides) -> None:
    """``key.path=json`` overrides into the ``params`` dict ``p``."""
    for kv in overrides:
        key, _, val = kv.partition("=")
        try:
            parsed = json.loads(val)
        except json.JSONDecodeError:
            parsed = val
        parts = [int(x) if x.lstrip("-").isdigit() else x for x in key.split(".")]
        node = p
        for part in parts[:-1]:
            node = node[part]
        node[parts[-1]] = parsed


def default_config(overrides=()) -> dict:
    """:data:`DEFAULT_CFG` plus ``key.path=json`` overrides."""
    cfg = copy.deepcopy(DEFAULT_CFG)
    _apply_overrides(cfg["params"], overrides)
    return cfg


def build_config(deskew: bool = True, scale: float = 1.0, local_map: bool = True,
                 overrides=()) -> dict:
    """The KITTI preset (``params/kitti-default.yaml``) with optional deskew,
    scan-to-map odometry, capacities scaled by ``scale`` (256-bucketed;
    for reduced-azimuth scans) and ``key.path=json`` overrides -- the same
    construction as the reference repository's accuracy harness."""
    cfg = copy.deepcopy(load_yaml(str(PARAMS_DIR / "kitti-default.yaml")))
    p = cfg["params"]
    if scale < 1.0:
        bucket = lambda v: max(256, int(v * scale) // 256 * 256)
        p["pointcloud_generator"][0]["params"]["capacity"] = bucket(131072)
        for f in p["pointcloud_filter"]:
            for key in ("edges_capacity", "planes_capacity", "decimated_capacity"):
                if key in f.get("params", {}):
                    f["params"][key] = bucket(f["params"][key])
    if deskew:
        p["pointcloud_generator"][0]["params"]["keep_time"] = True
        p["pointcloud_filter"] = (
            [{"class": "FilterDeskew",
              "params": {"input_layer": "raw", "scan_period": 0.1, "anchor": "start"}}]
            + p["pointcloud_filter"])
    if local_map:
        p["odometry_reference"] = "local_map"
    _apply_overrides(p, overrides)
    return cfg


def realtime_config(scale: float = 1.0) -> dict:
    """The configuration of the main path: KITTI preset, deskew,
    scan-to-local-map, realtime levers, the preset's nearby/LC window --
    the reference accuracy harness's ``realtime`` configuration."""
    return build_config(deskew=True, scale=scale, local_map=True, overrides=REALTIME)


def build_module(cfg: Optional[dict], backend=None, device="cuda"):
    cfg = cfg or realtime_config()
    module = MODULE_REGISTRY.get(cfg.get("module", "LidarOdometry"))(device=device)
    module.slam_backend = backend if backend is not None else OptimizingBackend(device=device)
    module.initialize(cfg)
    return module


def non_adjacent_edges(module) -> Tuple[int, int]:
    """(accepted nearby edges, accepted loop closures): the graph edges of
    checked keyframe pairs, odometry edges being never checked."""
    with module._state_lock:
        st = module.state
        checked = sum((min(a, b), max(a, b)) in st.checked_KF_pairs
                      for a, b, _, _ in st.edge_log)
        n_lc = len(st.lc_pairs)
    return checked - n_lc, n_lc


def estimated_trajectory(module) -> Dict[int, Tuple[np.ndarray, np.ndarray]]:
    """Keyframe poses in the first keyframe's frame (Dijkstra over the
    local pose graph)."""
    with module._state_lock:
        graph = module.state.local_pose_graph
        poses, _ = graph.dijkstra_nodes_estimate(graph.root)
    return poses


def per_scan_trajectory(backend, kf_poses):
    """Per-scan poses: keyframe pose composed with each advertised
    odometry since that keyframe, sorted by timestamp."""
    out = []
    for loc in backend.localizations:
        if loc.reference_kf not in kf_poses:
            continue
        Rk, tk = kf_poses[loc.reference_kf]
        Ra = np.asarray(loc.pose.R, np.float64)
        ta = np.asarray(loc.pose.t, np.float64)
        out.append((loc.timestamp, (Rk @ Ra, Rk @ ta + tk)))
    out.sort(key=lambda x: x[0])
    return out


def _associate(items, observations, gt_poses):
    """(timestamp, pose) pairs -> matched (estimated, ground truth) lists;
    ground truth index = scan index."""
    dt = (observations[1]["timestamp"] - observations[0]["timestamp"]
          if len(observations) > 1 else 1.0)
    t0 = observations[0]["timestamp"]
    gt_sel, est_sel = [], []
    for ts, pose in items:
        idx = int(round((ts - t0) / dt))
        if 0 <= idx < len(gt_poses):
            gt_sel.append(gt_poses[idx])
            est_sel.append(pose)
    return est_sel, gt_sel


def run_replay(observations, cfg: Optional[dict] = None, gt_poses=None,
               device="cuda", realtime: bool = False, pgo: bool = False,
               pgo_robust: str = "none", warm_start: bool = False):
    """Replay ``observations`` through the front-end on ``device``. The feed
    is lossless (throttled instead of tripping the overload drop) unless
    ``realtime``, which feeds a scan every 10 ms. The first ``min(25, n/5)``
    scans are a warm-up; ``scans_per_sec_steady`` times the rest.
    ``warm_start`` runs :meth:`LidarOdometry.warm_start` on the first
    observation before the clock starts (``warm_s``). ``pgo`` optimizes
    the recorded pose graph (robust kernel ``pgo_robust`` on non-odometry
    edges) and adds the ``*_pgo`` metrics."""
    backend = OptimizingBackend(device=device)
    module = build_module(cfg, backend=backend, device=device)
    warm_s = module.warm_start(observations[0]) if warm_start and observations else None
    n_total = len(observations)
    warmup = min(25, n_total // 5)
    t0 = time.perf_counter()
    t_steady = None
    for n_fed, obs in enumerate(observations):
        while not realtime:
            with module._pending_lock:
                if module._pending <= module.params.max_queue_length // 2:
                    break
            time.sleep(0.002)
        if n_fed == warmup and warmup > 0:
            while True:  # barrier: the warm-up scans finish entirely
                with module._pending_lock:
                    if module._pending == 0:
                        break
                time.sleep(0.002)
            t_steady = time.perf_counter()
        module.on_new_observation(obs)
        if realtime:
            time.sleep(0.01)
    jobs_abandoned = module.drain()
    backend.flush()  # the last scans' calls may still sit in its queue
    t_end = time.perf_counter()
    steady = ((n_total - warmup) / max(t_end - t_steady, 1e-9)
              if t_steady is not None and n_total > warmup else None)

    kf_poses = estimated_trajectory(module)
    kf_pgo = backend.optimized_poses(robust=pgo_robust) if pgo and backend.factors else None
    n_nearby, n_lc = non_adjacent_edges(module)
    result = {
        "n_scans": n_total,
        "n_keyframes": len(backend.keyframes),
        "n_factors": len(backend.factors),
        "n_nearby_edges": n_nearby,
        "n_loop_closures": n_lc,
        "wall_s": t_end - t0,
        "jobs_abandoned": jobs_abandoned,
        "scans_per_sec_steady": steady,
        "wall_to_steady_s": (t_steady - t0) if t_steady is not None else None,
        "warm_s": warm_s,
        "kf_poses": kf_poses,
        "backend": backend,
        "module": module,
    }
    if kf_pgo:
        result["kf_poses_pgo"] = kf_pgo
    if gt_poses is not None and backend.keyframes and kf_poses:
        kf_ids = sorted(kf_poses)
        est, gt = _associate([(backend.keyframes[k].timestamp, kf_poses[k]) for k in kf_ids],
                             observations, gt_poses)
        if len(gt) >= 3:
            result["ate_rmse"] = ate_rmse(est, gt)
            result["rpe_trans"], result["rpe_rot"] = rpe_rmse(est, gt)
        scan_traj = per_scan_trajectory(backend, kf_poses)
        est, gt = _associate(scan_traj, observations, gt_poses)
        if len(gt) >= 3:
            result["n_scan_poses"] = len(est)
            result["ate_rmse_scan"] = ate_rmse(est, gt)
            result["rpe_trans_scan"], result["rpe_rot_scan"] = rpe_rmse(est, gt)
            t_rel, r_rel, nseg = kitti_segment_errors(est, gt)
            if nseg:
                result["kitti_t_rel_pct"] = t_rel
                result["kitti_r_rel_deg_per_m"] = r_rel
                result["kitti_segments"] = nseg
        result["scan_poses"] = scan_traj
        if kf_pgo:
            # the same evaluations over the optimized keyframe poses
            est, gt = _associate([(backend.keyframes[k].timestamp, kf_pgo[k])
                                  for k in kf_ids if k in kf_pgo], observations, gt_poses)
            if len(gt) >= 3:
                result["ate_rmse_pgo"] = ate_rmse(est, gt)
            est, gt = _associate(per_scan_trajectory(backend, kf_pgo), observations, gt_poses)
            if len(gt) >= 3:
                result["ate_rmse_scan_pgo"] = ate_rmse(est, gt)
                t_rel, _, nseg = kitti_segment_errors(est, gt)
                if nseg:
                    result["kitti_t_rel_pct_pgo"] = t_rel
    return result


def _rot_to_quat(R):
    """(x, y, z, w) by Shepperd's method (the largest pivot), stable near
    180 degrees."""
    t = R[0, 0] + R[1, 1] + R[2, 2]
    if t > max(R[0, 0], R[1, 1], R[2, 2]):
        s = 2.0 * np.sqrt(1.0 + t)
        return (R[2, 1] - R[1, 2]) / s, (R[0, 2] - R[2, 0]) / s, (R[1, 0] - R[0, 1]) / s, 0.25 * s
    if R[0, 0] >= R[1, 1] and R[0, 0] >= R[2, 2]:
        s = 2.0 * np.sqrt(max(0.0, 1.0 + R[0, 0] - R[1, 1] - R[2, 2]))
        return 0.25 * s, (R[0, 1] + R[1, 0]) / s, (R[0, 2] + R[2, 0]) / s, (R[2, 1] - R[1, 2]) / s
    if R[1, 1] >= R[2, 2]:
        s = 2.0 * np.sqrt(max(0.0, 1.0 + R[1, 1] - R[0, 0] - R[2, 2]))
        return (R[0, 1] + R[1, 0]) / s, 0.25 * s, (R[1, 2] + R[2, 1]) / s, (R[0, 2] - R[2, 0]) / s
    s = 2.0 * np.sqrt(max(0.0, 1.0 + R[2, 2] - R[0, 0] - R[1, 1]))
    return (R[0, 2] + R[2, 0]) / s, (R[1, 2] + R[2, 1]) / s, 0.25 * s, (R[1, 0] - R[0, 1]) / s


def save_trajectory_tum(path: str, kf_poses, backend) -> None:
    """Keyframe poses in TUM format: ``timestamp tx ty tz qx qy qz qw``."""
    with open(path, "w") as f:
        for k in sorted(kf_poses):
            R, t = kf_poses[k]
            ts = backend.keyframes[k].timestamp if k in backend.keyframes else float(k)
            qx, qy, qz, qw = _rot_to_quat(R)
            f.write(f"{ts:.6f} {t[0]:.6f} {t[1]:.6f} {t[2]:.6f} "
                    f"{qx:.6f} {qy:.6f} {qz:.6f} {qw:.6f}\n")


# summary keys the port prints beside the reference runner's
SUMMARY_EXTRA_KEYS = ("n_nearby_edges", "n_loop_closures", "jobs_abandoned", "ate_rmse_scan",
                      "scans_per_sec_steady")


def parser() -> argparse.ArgumentParser:
    """The replay CLI's arguments."""
    ap = argparse.ArgumentParser(description="mola_fe_lidar_tpu_torch dataset replay")
    ap.add_argument("--config", type=str, default=None,
                    help="module YAML (default: DEFAULT_CFG, the quickstart configuration: "
                         "0.7 m voxel downsample, point-to-point then kNN point-to-plane)")
    ap.add_argument("--dataset", choices=["synthetic", "kitti"], default="synthetic")
    ap.add_argument("--sequence", type=str, default="00")
    ap.add_argument("--kitti-root", type=str, default=None)
    ap.add_argument("--scans", type=int, default=40)
    ap.add_argument("--kind", type=str, default="circle", help="synthetic trajectory kind")
    ap.add_argument("--loop-side", type=float, default=0.0,
                    help="loop/circle size; 0 = auto-size so step ~= 1 m")
    ap.add_argument("--device", type=str, default="cuda",
                    help="torch device (default cuda; cpu runs the plain twins)")
    ap.add_argument("--out", type=str, default=None,
                    help="write the keyframe trajectory (TUM format; optimized with --pgo)")
    ap.add_argument("--pgo", action="store_true",
                    help="optimize the keyframe pose graph and report *_pgo metrics")
    ap.add_argument("--pgo-robust", choices=["none", "huber", "cauchy"], default="none",
                    help="IRLS kernel on non-odometry edges during --pgo")
    ap.add_argument("--profile", action="store_true",
                    help="print the hierarchical profiler report after the replay")
    ap.add_argument("--viz-out", type=str, default=None,
                    help="export the trajectory and keyframe clouds as PLY to this directory")
    ap.add_argument("--mesh", type=str, default=None,
                    help="device mesh, e.g. 'data=4' or 'data=2,model=2': splits the nearby / "
                         "loop-closure batches over 'data' and the map align's target points "
                         "over 'model'; with fewer devices the module warns and runs on one")
    return ap


def main(argv=None) -> int:
    ap = parser()
    args = ap.parse_args(argv)
    if torch.device(args.device).type != "cpu":
        return _main(ap, args)
    previous = mesh.force_device_count(8)  # the CPU as 8 positions
    try:
        return _main(ap, args)
    finally:
        mesh.force_device_count(previous)


def _main(ap: argparse.ArgumentParser, args) -> int:
    cfg = load_yaml(args.config) if args.config else default_config()
    if args.mesh:
        cfg = copy.deepcopy(cfg)
        params = cfg.setdefault("params", {})
        for part in args.mesh.split(","):
            axis, _, n = part.partition("=")
            if axis.strip() not in ("data", "model") or not n.strip().isdigit():
                ap.error(f"bad --mesh component {part!r} (want data=N[,model=M])")
            params[f"mesh_{axis.strip()}"] = int(n)
    if args.dataset == "synthetic":
        import math
        from .synthetic import synthetic_sequence
        side = args.loop_side or args.scans * 1.0 / math.pi
        observations, gt = synthetic_sequence(kind=args.kind, n_scans=args.scans,
                                              loop_side=side)
    else:
        from .kitti import KittiOdometrySequence
        seq = KittiOdometrySequence(args.sequence, root=args.kitti_root,
                                    max_scans=args.scans or None)
        observations = list(seq)
        gt = seq.gt_poses_velo
    res = run_replay(observations, cfg, gt_poses=gt, device=args.device, pgo=args.pgo,
                     pgo_robust=args.pgo_robust)
    module = res["module"]
    try:
        # the reference's summary keys, then the port's own
        summary = {k: v for k, v in res.items()
                   if k in ("n_scans", "n_keyframes", "n_factors", "wall_s",
                            "ate_rmse", "rpe_trans", "rpe_rot",
                            "ate_rmse_pgo", "ate_rmse_scan_pgo")}
        summary["scans_per_sec"] = (res["n_scans"] or 0) / max(res["wall_s"], 1e-9)
        summary.update({k: res[k] for k in SUMMARY_EXTRA_KEYS if k in res})
        summary["device"] = args.device
        print(json.dumps(summary, indent=2, default=float))
        if args.out:
            save_trajectory_tum(args.out, res.get("kf_poses_pgo") or res["kf_poses"],
                                res["backend"])
            print(f"trajectory written to {args.out}")
        if args.viz_out:
            from .viz import export_run
            export_run(args.viz_out, module)
            print(f"PLY exports written to {args.viz_out}")
        if args.profile:
            print(module.profiler.report())
    finally:
        module.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
