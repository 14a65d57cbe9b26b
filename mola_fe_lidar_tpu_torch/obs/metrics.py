"""Trajectory accuracy metrics: ATE / RPE (the BASELINE parity metric).

Standard KITTI-odometry-style evaluation: absolute trajectory error after
Umeyama (similarity, scale fixed to 1) alignment, and relative pose error
over a fixed frame delta.

A copy of ``mola_fe_lidar_tpu/obs/metrics.py``: the port imports nothing of the
JAX package. ``tests/test_torch_copies.py`` holds the two equal.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

Pose = Tuple[np.ndarray, np.ndarray]  # (R 3x3, t 3)


def umeyama_align(est: np.ndarray, gt: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Rigid (R, t) aligning est→gt positions [N,3], scale = 1."""
    mu_e, mu_g = est.mean(0), gt.mean(0)
    H = (est - mu_e).T @ (gt - mu_g)
    U, _, Vt = np.linalg.svd(H)
    D = np.diag([1.0, 1.0, np.sign(np.linalg.det(Vt.T @ U.T))])
    R = Vt.T @ D @ U.T
    t = mu_g - R @ mu_e
    return R, t


def ate_rmse(est_poses: Sequence[Pose], gt_poses: Sequence[Pose]) -> float:
    """Absolute trajectory error RMSE (meters) after rigid alignment."""
    est = np.stack([t for _, t in est_poses])
    gt = np.stack([t for _, t in gt_poses])
    R, t = umeyama_align(est, gt)
    aligned = est @ R.T + t
    return float(np.sqrt(np.mean(np.sum((aligned - gt) ** 2, axis=-1))))


def kitti_segment_errors(
    est_poses: Sequence[Pose],
    gt_poses: Sequence[Pose],
    lengths: Sequence[float] = (100, 200, 300, 400, 500, 600, 700, 800),
    step: int = 10,
) -> Tuple[float, float, int]:
    """KITTI odometry devkit drift: (t_rel %, r_rel deg/m, n_segments).

    The official KITTI metric (devkit ``evaluate_odometry.cpp``): for
    every ``step``-th start frame and every segment length L, find the
    frame where the ground-truth path length first exceeds L, form the
    relative SE(3) error between the estimated and true segment deltas,
    and average translation error / L (percent) and rotation angle / L
    (deg per meter) over all segments. This is what published KITTI
    numbers mean by "drift %" — ATE is not directly comparable.
    Returns (nan, nan, 0) if the trajectory is shorter than min(lengths).
    """
    n = min(len(est_poses), len(gt_poses))
    if n < 2:
        return float("nan"), float("nan"), 0
    # cumulative ground-truth path length per frame
    gt_t = np.stack([t for _, t in gt_poses[:n]])
    seg = np.linalg.norm(np.diff(gt_t, axis=0), axis=-1)
    dist = np.concatenate([[0.0], np.cumsum(seg)])
    t_errs, r_errs = [], []
    for first in range(0, n, step):
        for L in lengths:
            # first frame whose path length from `first` exceeds L
            target = dist[first] + L
            last = int(np.searchsorted(dist, target))
            if last >= n:
                continue
            Rg1, tg1 = gt_poses[first]
            Rg2, tg2 = gt_poses[last]
            Re1, te1 = est_poses[first]
            Re2, te2 = est_poses[last]
            dRg = Rg1.T @ Rg2
            dtg = Rg1.T @ (tg2 - tg1)
            dRe = Re1.T @ Re2
            dte = Re1.T @ (te2 - te1)
            E_R = dRe.T @ dRg
            E_t = dRe.T @ (dtg - dte)
            seg_len = dist[last] - dist[first]
            t_errs.append(np.linalg.norm(E_t) / seg_len)
            c = np.clip((np.trace(E_R) - 1) / 2, -1.0, 1.0)
            r_errs.append(np.arccos(c) / seg_len)
    if not t_errs:
        return float("nan"), float("nan"), 0
    return (float(np.mean(t_errs) * 100.0),
            float(np.degrees(np.mean(r_errs))),
            len(t_errs))


def rpe_rmse(
    est_poses: Sequence[Pose], gt_poses: Sequence[Pose], delta: int = 1
) -> Tuple[float, float]:
    """Relative pose error RMSE over ``delta`` frames:
    (translational meters, rotational radians)."""
    terrs, rerrs = [], []
    for i in range(len(est_poses) - delta):
        Re1, te1 = est_poses[i]
        Re2, te2 = est_poses[i + delta]
        Rg1, tg1 = gt_poses[i]
        Rg2, tg2 = gt_poses[i + delta]
        dRe = Re1.T @ Re2
        dte = Re1.T @ (te2 - te1)
        dRg = Rg1.T @ Rg2
        dtg = Rg1.T @ (tg2 - tg1)
        E_R = dRg.T @ dRe
        E_t = dtg - dte
        terrs.append(np.sum(E_t**2))
        c = np.clip((np.trace(E_R) - 1) / 2, -1, 1)
        rerrs.append(np.arccos(c) ** 2)
    return float(np.sqrt(np.mean(terrs))), float(np.sqrt(np.mean(rerrs)))
