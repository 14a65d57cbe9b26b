"""SLAM back-end protocol, future-based (port of
``mola_fe_lidar_tpu/frontend/backend.py``): the payloads, the recording
``InMemoryBackend`` and the ``OptimizingBackend``, which refines every
keyframe pose by Levenberg-Marquardt over the recorded factor stream
(``solve/pose_graph_gn.py``) on its device.
"""

from __future__ import annotations

import itertools
import threading
from concurrent.futures import Future, ThreadPoolExecutor, wait
from dataclasses import dataclass
from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch


class HostPose(NamedTuple):
    """A pose on the host: ``x_world = R @ x_local + t`` (numpy)."""

    R: np.ndarray
    t: np.ndarray


@dataclass
class ProposeKFInput:
    timestamp: float
    observations: Optional[list] = None


@dataclass
class ProposeKFOutput:
    success: bool
    new_kf_id: Optional[int] = None


@dataclass
class FactorRelativePose3:
    """SE(3) relative-pose factor between two keyframes."""

    kf_from: int
    kf_to: int
    rel_pose: HostPose
    noise_model_diag_xyz: float = 0.10             # meters
    noise_model_diag_rot: float = np.deg2rad(1.0)  # radians


@dataclass
class AddFactorOutput:
    success: bool
    new_factor_id: Optional[int] = None


@dataclass
class AdvertiseLocalization:
    timestamp: float
    reference_kf: int
    pose: HostPose


class BackEndBase:
    """Protocol: all calls return futures; the back-end runs elsewhere."""

    def add_keyframe(self, kf: ProposeKFInput) -> "Future[ProposeKFOutput]":
        raise NotImplementedError

    def add_factor(self, f: FactorRelativePose3) -> "Future[AddFactorOutput]":
        raise NotImplementedError

    def advertise_updated_localization(self, loc: AdvertiseLocalization) -> "Future[None]":
        raise NotImplementedError


class InMemoryBackend(BackEndBase):
    """Thread-backed recording back-end: assigns ids and stores the factor
    stream. After :meth:`shutdown` every call returns an already-resolved
    "not accepted" future and counts ``refused_after_shutdown``."""

    def __init__(self, max_workers: int = 1):
        self._pool = ThreadPoolExecutor(max_workers=max_workers, thread_name_prefix="backend")
        self._lock = threading.Lock()
        self._kf_ids = itertools.count(0)
        self._factor_ids = itertools.count(0)
        self.keyframes: Dict[int, ProposeKFInput] = {}
        self.factors: List[FactorRelativePose3] = []
        self.localizations: List[AdvertiseLocalization] = []
        self.refused_after_shutdown = 0
        self._submitted: List[Future] = []

    def _submit(self, work, refused):
        try:
            fut = self._pool.submit(work)
            with self._lock:
                self._submitted.append(fut)
            return fut
        except RuntimeError:  # cannot schedule new futures after shutdown
            with self._lock:
                self.refused_after_shutdown += 1
            fut: Future = Future()
            fut.set_result(refused)
            return fut

    def add_keyframe(self, kf: ProposeKFInput) -> Future:
        def work():
            with self._lock:
                kf_id = next(self._kf_ids)
                self.keyframes[kf_id] = kf
            return ProposeKFOutput(True, kf_id)

        return self._submit(work, ProposeKFOutput(False, -1))

    def add_factor(self, f: FactorRelativePose3) -> Future:
        def work():
            with self._lock:
                fid = next(self._factor_ids)
                self.factors.append(f)
            return AddFactorOutput(True, fid)

        return self._submit(work, AddFactorOutput(False, -1))

    def advertise_updated_localization(self, loc: AdvertiseLocalization) -> Future:
        def work():
            with self._lock:
                self.localizations.append(loc)

        return self._submit(work, None)

    def flush(self) -> None:
        """Wait until every call submitted so far is recorded."""
        with self._lock:
            pending, self._submitted = self._submitted, []
        wait(pending)

    def shutdown(self):
        self._pool.shutdown(wait=True)


class OptimizingBackend(InMemoryBackend):
    """A recording back-end that can optimize the keyframe pose graph
    (the mola-slam-gtsam analogue): :meth:`optimized_poses` runs the LM of
    ``solve/pose_graph_gn.py`` over the factors recorded so far, on
    ``device``."""

    def __init__(self, max_workers: int = 1, device="cuda"):
        super().__init__(max_workers)
        self.device = torch.device(device)

    def optimized_poses(self, iters: int = 30, robust: str = "none",
                        robust_delta: float = 2.0):
        """{kf_id: (R 3x3, t 3) float64} after the global LM.

        Initial values compose the factors in insertion order (the
        odometry factor of a keyframe arrives first). ``robust`` ("huber",
        "cauchy") re-weights only non-consecutive edges (nearby and loop-
        closure hypotheses); odometry edges stay trusted. Keyframe 0 (the
        smallest id) is the gauge."""
        from ..geometry import se3_np
        from ..solve.pose_graph_gn import optimize_pose_graph

        with self._lock:
            factors = list(self.factors)
        if not factors:
            return {}
        init, edges = {}, []
        for f in factors:
            R = np.asarray(f.rel_pose.R, np.float64)
            t = np.asarray(f.rel_pose.t, np.float64)
            if not init:
                init[f.kf_from] = (np.eye(3), np.zeros(3))
            if f.kf_from in init and f.kf_to not in init:
                Ra, ta = init[f.kf_from]
                init[f.kf_to] = (Ra @ R, Ra @ t + ta)
            elif f.kf_to in init and f.kf_from not in init:
                Rb, tb = init[f.kf_to]
                init[f.kf_from] = (Rb @ R.T, tb - Rb @ R.T @ t)
            elif f.kf_from not in init and f.kf_to not in init:
                # a disconnected component: anchored at the identity
                init[f.kf_from] = (np.eye(3), np.zeros(3))
                init[f.kf_to] = (R, t)
            edges.append((f.kf_from, f.kf_to, R, t, 1.0 / f.noise_model_diag_xyz ** 2,
                          1.0 / f.noise_model_diag_rot ** 2))
        ids = sorted(init)
        index = {k: i for i, k in enumerate(ids)}
        f32 = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(self.device)
        i64 = lambda a: torch.from_numpy(np.asarray(a, np.int64)).to(self.device)
        R_opt, t_opt, _ = optimize_pose_graph(
            f32([init[k][0] for k in ids]), f32([init[k][1] for k in ids]),
            f32(np.ones(len(ids))), i64([index[a] for a, *_ in edges]),
            i64([index[b] for _, b, *_ in edges]), f32([e[2] for e in edges]),
            f32([e[3] for e in edges]), f32([e[4] for e in edges]), f32([e[5] for e in edges]),
            f32(np.ones(len(edges))), iters=iters, robust=robust, robust_delta=robust_delta,
            e_robust=f32([1.0 if abs(b - a) > 1 else 0.0 for a, b, *_ in edges]))
        R_opt = R_opt.cpu().numpy().astype(np.float64)
        t_opt = t_opt.cpu().numpy().astype(np.float64)
        return {k: (se3_np.orthonormalize(R_opt[i]), t_opt[i]) for k, i in index.items()}
