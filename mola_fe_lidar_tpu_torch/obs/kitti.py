"""KITTI odometry dataset reader — the mola dataset-source analogue.

Reads the standard KITTI odometry layout:

    <root>/sequences/<seq>/velodyne/000000.bin   (float32 [n,4]: x,y,z,ref)
    <root>/sequences/<seq>/calib.txt             (Tr: cam0←velo)
    <root>/sequences/<seq>/times.txt
    <root>/poses/<seq>.txt                       (cam0 poses, 3x4 row-major)

Ground-truth poses are converted into the velodyne frame
(T_velo = Tr⁻¹ · T_cam · Tr) so ATE/RPE compares like with like.
Dataset root resolves from the ``KITTI_ROOT`` env var when not given.

A copy of ``mola_fe_lidar_tpu/obs/kitti.py``: the port imports nothing of the
JAX package. ``tests/test_torch_copies.py`` holds the two equal.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np


def read_velodyne_bin(path: str) -> np.ndarray:
    """Load one KITTI velodyne scan: returns [n,4] float32 (x,y,z,reflectance)."""
    data = np.fromfile(path, dtype=np.float32)
    return data.reshape(-1, 4)


class KittiOdometrySequence:
    def __init__(self, sequence: str = "00", root: Optional[str] = None,
                 max_scans: Optional[int] = None):
        root = root or os.environ.get("KITTI_ROOT", "")
        self.root = Path(root)
        self.sequence = sequence
        self.seq_dir = self.root / "sequences" / sequence
        self.max_scans = max_scans
        if not self.seq_dir.exists():
            raise FileNotFoundError(
                f"KITTI sequence dir not found: {self.seq_dir} "
                "(set KITTI_ROOT or pass root=)")
        self.velo_files = sorted((self.seq_dir / "velodyne").glob("*.bin"))
        if max_scans:
            self.velo_files = self.velo_files[:max_scans]
        self.times = self._read_times()
        self.T_cam_velo = self._read_calib()
        self.gt_poses_velo = self._read_gt_poses()

    def _read_times(self) -> np.ndarray:
        f = self.seq_dir / "times.txt"
        if f.exists():
            return np.loadtxt(str(f))[: len(self.velo_files)]
        return np.arange(len(self.velo_files), dtype=np.float64) * 0.1

    def _read_calib(self) -> np.ndarray:
        f = self.seq_dir / "calib.txt"
        T = np.eye(4)
        if f.exists():
            for line in f.read_text().splitlines():
                if line.startswith("Tr"):
                    vals = np.array([float(v) for v in line.split()[1:]])
                    T[:3, :4] = vals.reshape(3, 4)
        return T

    def _read_gt_poses(self) -> Optional[List[Tuple[np.ndarray, np.ndarray]]]:
        f = self.root / "poses" / f"{self.sequence}.txt"
        if not f.exists():
            return None
        raw = np.loadtxt(str(f))[: len(self.velo_files)]
        Tr = self.T_cam_velo
        Tr_inv = np.linalg.inv(Tr)
        out = []
        for row in raw:
            T_cam = np.eye(4)
            T_cam[:3, :4] = row.reshape(3, 4)
            T_velo = Tr_inv @ T_cam @ Tr
            out.append((T_velo[:3, :3], T_velo[:3, 3]))
        return out

    def __len__(self) -> int:
        return len(self.velo_files)

    def __iter__(self) -> Iterator[Dict]:
        for i, f in enumerate(self.velo_files):
            scan = read_velodyne_bin(str(f))
            yield {
                "xyz": scan[:, :3],
                "intensity": scan[:, 3],
                "timestamp": float(self.times[i]),
                "sensor_label": "lidar",
                "index": i,
            }
