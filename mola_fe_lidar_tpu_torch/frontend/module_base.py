"""Module interface layer (E7): FrontEndBase + module registry.

Rebuild of the mola-kernel ``FrontEndBase`` contract (reference
include/mola-fe-lidar/LidarOdometry.h:29: initialize / spinOnce /
onNewObservation, plus ``raw_sensor_label_``, ``profiler_``,
``slam_backend_``, ``findService<T>()``) and the RTTI module factory that
lets the system runner instantiate modules by string name from YAML
(reference src/LidarOdometry.cpp:44-53).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Type, TypeVar

from ..utils.profiler import Profiler
from ..utils.registry import Registry
from ..utils.logging import get_logger

MODULE_REGISTRY: Registry = Registry("module")

# A raw observation is a host dict: {"xyz": np[n,3], "timestamp": float,
# "sensor_label": str, ...} — the CObservation analogue.
RawObservation = Dict[str, Any]

T = TypeVar("T")


class FrontEndBase:
    """Base class for front-end modules."""

    def __init__(self, name: Optional[str] = None):
        self.name = name or type(self).__name__
        self.raw_sensor_label: str = ""
        self.profiler = Profiler(self.name)
        self.slam_backend = None  # BackEndBase
        self.log = get_logger(self.name)
        self._services: Dict[type, Any] = {}

    # -- service discovery (findService<T>() analogue) --------------------
    def provide_service(self, obj: Any) -> None:
        self._services[type(obj)] = obj

    def find_service(self, cls: Type[T]) -> Optional[T]:
        for t, obj in self._services.items():
            if issubclass(t, cls):
                return obj
        return None

    # -- lifecycle ----------------------------------------------------------
    def initialize(self, cfg: Dict[str, Any]) -> None:
        raise NotImplementedError

    def spin_once(self) -> None:
        """Periodic hook — intentionally light; all work is event-driven
        (reference src/LidarOdometry.cpp:150-158)."""

    def on_new_observation(self, obs: RawObservation) -> None:
        raise NotImplementedError
