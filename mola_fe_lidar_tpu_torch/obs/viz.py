"""Visualization export (port of ``mola_fe_lidar_tpu/obs/viz.py``): point
clouds and keyframe trajectories as ASCII PLY files, which every point-cloud
viewer (CloudCompare, Meshlab, Open3D) opens. The bytes written are the
reference's for the same points.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np

from ..cloud.metric_map import MetricMap, to_numpy

_LAYER_COLORS = {
    "raw": (180, 180, 180),
    "decimated": (130, 130, 255),
    "planes": (90, 200, 90),
    "edges": (230, 90, 90),
}


def write_ply(path: str, xyz: np.ndarray, colors: Optional[np.ndarray] = None) -> None:
    """ASCII PLY point cloud. xyz [n,3] float; colors [n,3] uint8 optional."""
    xyz = np.asarray(xyz, np.float32)
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {len(xyz)}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        if colors is not None:
            f.write("property uchar red\nproperty uchar green\nproperty uchar blue\n")
        f.write("end_header\n")
        if colors is None:
            for p in xyz:
                f.write(f"{p[0]:.4f} {p[1]:.4f} {p[2]:.4f}\n")
        else:
            for p, c in zip(xyz, np.asarray(colors, np.uint8)):
                f.write(f"{p[0]:.4f} {p[1]:.4f} {p[2]:.4f} {c[0]} {c[1]} {c[2]}\n")


def export_metric_map(path: str, mm: MetricMap) -> None:
    """One PLY with all layers, color-coded by layer."""
    pts, cols = [], []
    for i, (name, pc) in enumerate(sorted(mm.items())):
        p = to_numpy(pc)
        if len(p) == 0:
            continue
        c = _LAYER_COLORS.get(name, (200, 160 + 30 * (i % 3), 60))
        pts.append(p)
        cols.append(np.tile(np.array(c, np.uint8), (len(p), 1)))
    if not pts:
        write_ply(path, np.zeros((0, 3), np.float32))
        return
    write_ply(path, np.concatenate(pts), np.concatenate(cols))


def export_trajectory(path: str, poses: Dict[int, Tuple[np.ndarray, np.ndarray]],
                      axis_len: float = 0.5) -> None:
    """Keyframe trajectory as a PLY: position points (white) plus small
    RGB axis ticks per pose for orientation."""
    pts, cols = [], []
    for k in sorted(poses):
        R, t = poses[k]
        pts.append(t[None, :])
        cols.append(np.array([[255, 255, 255]], np.uint8))
        for ax, col in zip(range(3), ((255, 60, 60), (60, 255, 60), (90, 90, 255))):
            for s in (0.33, 0.66, 1.0):
                pts.append((t + axis_len * s * R[:, ax])[None, :])
                cols.append(np.array([col], np.uint8))
    write_ply(path, np.concatenate(pts), np.concatenate(cols))


def export_run(out_dir: str, module, max_keyframes: int = 50) -> None:
    """A replay's artifacts: ``trajectory.ply`` (the local pose graph's
    keyframe poses) and ``kf_NNNN.ply`` (each of the first
    ``max_keyframes`` keyframes' layered cloud)."""
    from ..frontend.worldmodel import ANNOTATION_NAME_PC_LAYERS

    d = Path(out_dir)
    d.mkdir(parents=True, exist_ok=True)
    # the traversal must not see a search worker's edge insertion
    with module._state_lock:
        graph = module.state.local_pose_graph
        poses, _ = graph.dijkstra_nodes_estimate(graph.root)
    export_trajectory(str(d / "trajectory.ply"), poses)
    wm = module.worldmodel
    if wm is None:
        return
    for kf in sorted(poses)[:max_keyframes]:
        mm = wm.annotation(kf, ANNOTATION_NAME_PC_LAYERS)
        if mm is not None:
            export_metric_map(str(d / f"kf_{kf:04d}.ply"), mm)
