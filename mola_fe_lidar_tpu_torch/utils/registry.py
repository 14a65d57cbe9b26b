"""String-keyed class/factory registry (E16).

Rebuild of the MRPT RTTI factory the reference uses to instantiate ICP
engines, matchers, solvers, generators and filters by YAML class name
(``mrpt::rtti::classFactory(icp_class)``, reference
src/LidarOdometry.cpp:66-75; filter classes from YAML at :135-140).
This pluggability is load-bearing (SURVEY.md §5 config system).

A copy of ``mola_fe_lidar_tpu/utils/registry.py``: the port imports nothing of the
JAX package. ``tests/test_torch_copies.py`` holds the two equal.
"""

from __future__ import annotations

from typing import Callable, Dict, Generic, TypeVar

T = TypeVar("T")


class Registry(Generic[T]):
    def __init__(self, kind: str):
        self.kind = kind
        self._entries: Dict[str, T] = {}

    def register(self, name: str) -> Callable[[T], T]:
        def deco(obj: T) -> T:
            if name in self._entries:
                raise ValueError(f"{self.kind} {name!r} already registered")
            self._entries[name] = obj
            return obj

        return deco

    def get(self, name: str) -> T:
        if name not in self._entries:
            raise KeyError(
                f"unknown {self.kind} {name!r}; registered: {sorted(self._entries)}"
            )
        return self._entries[name]

    def names(self):
        return sorted(self._entries)

    def __contains__(self, name: str) -> bool:
        return name in self._entries
