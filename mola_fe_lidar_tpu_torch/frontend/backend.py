"""SLAM back-end protocol, future-based (port of
``mola_fe_lidar_tpu/frontend/backend.py``: the payloads and the recording
``InMemoryBackend``; the optimizing back-end waits for the pose-graph
solver, ROADMAP Queue 1 item 13).
"""

from __future__ import annotations

import itertools
import threading
from concurrent.futures import Future, ThreadPoolExecutor, wait
from dataclasses import dataclass
from typing import Dict, List, NamedTuple, Optional

import numpy as np


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
