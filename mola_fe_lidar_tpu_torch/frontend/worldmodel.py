"""WorldModel -- entity/annotation store with a read/write lock and disk
spill (port of ``mola_fe_lidar_tpu/frontend/worldmodel.py``).

Keyframes are entities; each carries annotations, among them its layered
cloud under ``"lidar-pointcloud-layers"``, and a set of neighbours (the
keyframes it shares a factor with). Least-recently-used keyframe clouds
beyond ``max_resident`` are written to ``spill_dir`` as npz (through
``metric_map.to_numpy_layers``) and reloaded on access onto the model's
``device`` (through ``from_numpy_layers``). Without a ``spill_dir`` every
cloud stays resident.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from pathlib import Path
from typing import Any, Dict, List, Optional, Set

import torch

from ..cloud.metric_map import MetricMap, load_metric_map, save_metric_map

ANNOTATION_NAME_PC_LAYERS = "lidar-pointcloud-layers"
ANNOTATION_NAME_RENDER_DECORATION = "render_decoration"


class WorldModel:
    def __init__(self, spill_dir: Optional[str] = None, max_resident: int = 64,
                 device="cuda"):
        self.device = torch.device(device)
        self._lock = threading.RLock()
        self._entities: Set[int] = set()
        self._annotations: Dict[int, Dict[str, Any]] = {}
        self._neighbors: Dict[int, Set[int]] = {}
        self._spill_dir = Path(spill_dir) if spill_dir else None
        self._max_resident = max_resident
        self._resident: "OrderedDict[int, bool]" = OrderedDict()  # LRU of resident clouds

    # -- locks (one reentrant lock serves readers and writers) --------------
    def lock_for_read(self):
        return self._lock

    def lock_for_write(self):
        return self._lock

    # -- entities -----------------------------------------------------------
    def add_entity(self, entity_id: int) -> None:
        with self._lock:
            self._entities.add(entity_id)
            self._annotations.setdefault(entity_id, {})
            self._neighbors.setdefault(entity_id, set())

    def entities(self) -> List[int]:
        with self._lock:
            return sorted(self._entities)

    def add_neighbors(self, a: int, b: int) -> None:
        """Record a factor between two entities."""
        with self._lock:
            self._neighbors.setdefault(a, set()).add(b)
            self._neighbors.setdefault(b, set()).add(a)

    def entity_neighbors(self, entity_id: int) -> Set[int]:
        with self._lock:
            return set(self._neighbors.get(entity_id, set()))

    # -- annotations --------------------------------------------------------
    def annotate(self, entity_id: int, key: str, value: Any) -> None:
        with self._lock:
            self.add_entity(entity_id)
            self._annotations[entity_id][key] = value
            if key == ANNOTATION_NAME_PC_LAYERS:
                self._touch(entity_id)
                self._maybe_spill()

    def annotation(self, entity_id: int, key: str) -> Any:
        """Read an annotation; a spilled cloud is reloaded onto ``device``."""
        with self._lock:
            ann = self._annotations.get(entity_id, {})
            if key == ANNOTATION_NAME_PC_LAYERS and key not in ann:
                loaded = self._load_spilled(entity_id)
                if loaded is not None:
                    ann[key] = loaded
                    self._touch(entity_id)
                    self._maybe_spill()
            return ann.get(key)

    def has_annotation(self, entity_id: int, key: str) -> bool:
        with self._lock:
            if key in self._annotations.get(entity_id, {}):
                return True
            path = self._spill_path(entity_id)
            return key == ANNOTATION_NAME_PC_LAYERS and path is not None and path.exists()

    def resident_count(self) -> int:
        with self._lock:
            return len(self._resident)

    # -- spill ----------------------------------------------------------------
    def _touch(self, entity_id: int) -> None:
        self._resident.pop(entity_id, None)
        self._resident[entity_id] = True

    def _spill_path(self, entity_id: int) -> Optional[Path]:
        if self._spill_dir is None:
            return None
        return self._spill_dir / f"kf_{entity_id:08d}.npz"

    def _maybe_spill(self) -> None:
        if self._spill_dir is None:
            return
        self._spill_dir.mkdir(parents=True, exist_ok=True)
        while len(self._resident) > self._max_resident:
            victim, _ = self._resident.popitem(last=False)
            cloud: Optional[MetricMap] = self._annotations[victim].pop(
                ANNOTATION_NAME_PC_LAYERS, None)
            if cloud is not None:
                save_metric_map(str(self._spill_path(victim)), cloud)

    def _load_spilled(self, entity_id: int) -> Optional[MetricMap]:
        path = self._spill_path(entity_id)
        if path is not None and path.exists():
            return load_metric_map(str(path), device=self.device)
        return None
