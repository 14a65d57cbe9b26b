"""Filter/generator plumbing (E6): registry-by-name + pipeline-from-config.

Rebuild of ``mp2p_icp_filters::generators_from_yaml`` /
``filter_pipeline_from_yaml`` / ``apply_generators`` /
``apply_filter_pipeline`` (reference src/LidarOdometry.cpp:135-140 for
construction, :216-224 for per-scan application). Stages are chosen by
string class name from config — the same pluggability contract as the
reference's RTTI factory.
"""

from __future__ import annotations

from typing import Any, Dict, List, Sequence

from ..cloud.metric_map import MetricMap
from ..utils.registry import Registry

# A filter maps MetricMap -> MetricMap (pure: it returns new layers).
FILTER_REGISTRY: Registry = Registry("filter")
# A generator maps a raw observation (host dict) -> MetricMap layers.
GENERATOR_REGISTRY: Registry = Registry("generator")


def make_filter(class_name: str, params: Dict[str, Any]):
    return FILTER_REGISTRY.get(class_name)(**(params or {}))


def make_generator(class_name: str, params: Dict[str, Any]):
    return GENERATOR_REGISTRY.get(class_name)(**(params or {}))


class FilterPipeline:
    """Ordered list of filters built from a config list:

    ``[{class: FilterEdgesPlanes, params: {...}}, ...]``
    """

    def __init__(self, filters: Sequence = ()):
        self.filters = list(filters)

    @classmethod
    def from_config(cls, cfg: List[Dict[str, Any]] | None) -> "FilterPipeline":
        filters = []
        for item in cfg or []:
            filters.append(make_filter(item["class"], item.get("params", {})))
        return cls(filters)

    def __call__(self, mm: MetricMap) -> MetricMap:
        for f in self.filters:
            mm = f(mm)
        return mm
