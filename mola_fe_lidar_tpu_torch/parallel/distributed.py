"""Multi-device ICP: tensor-parallel and DP×TP layouts (port of
``mola_fe_lidar_tpu/parallel/distributed.py``).

* **DP** (``batch.make_batched_align`` with a mesh): the lane axis split
  over the ``data`` axis, one batched align a position.
* **TP** (:func:`make_sharded_align`): ONE align whose target point axis
  is split over the ``model`` axis; the source, the pose and every solve
  stay on the lead position, and each search's per-slice champions come
  back to it to be merged (``ops/tp.py``).
* **DP×TP** (:func:`make_dp_tp_align`): lanes over ``data``, each lane's
  target points over ``model``.

The reference places one program across the devices with ``shard_map``;
here one process issues each position's launches (``parallel/mesh.py``).
"""

from __future__ import annotations

import dataclasses

from ..cloud.metric_map import MetricMap, split_cloud
from ..geometry import se3
from ..models.config import ICPParams
from ..models.icp import ICPResult, align
from .mesh import Mesh, gather_batch, run_per_position, shard_batch, tree_map


def shard_points(mm: MetricMap, positions) -> MetricMap:
    """Every layer's point axis split over ``positions`` (``ShardedCloud``);
    a capacity that does not divide by their number raises ValueError, as
    ``shard_map`` refuses it."""
    return {name: split_cloud(pc, positions) for name, pc in mm.items()}


def make_sharded_align(mesh: Mesh, params: ICPParams, model_axis: str = "model"):
    """Tensor-parallel align: ``run(src_map, tgt_map, init_pose)`` with
    whole clouds; the target is split on its point axis over
    ``model_axis``, the source and pose go to the lead position, and so
    does the result."""
    params_tp = dataclasses.replace(params, shard_axis=model_axis)
    positions = mesh.axis_devices(model_axis)
    lead = positions[0]

    def run(src_map: MetricMap, tgt_map: MetricMap, init_pose: se3.Pose) -> ICPResult:
        to_lead = lambda x: x.to(lead)
        return align(tree_map(to_lead, src_map), shard_points(tgt_map, positions),
                     tree_map(to_lead, init_pose), params_tp)

    return run


def make_dp_tp_align(mesh: Mesh, params: ICPParams, data_axis: str = "data",
                     model_axis: str = "model"):
    """2-D-parallel align: ``run(src_maps, tgt_maps, init_poses)`` with a
    leading lane axis divisible by the data-axis size; each data position's
    lanes align on its row of the mesh, their targets split over
    ``model_axis`` (capacities divisible by its size). Results come back to
    the mesh's lead position in lane order."""
    params_tp = dataclasses.replace(params, shard_axis=model_axis)
    rows = mesh.devices if mesh.axis_names.index(data_axis) == 0 else mesh.devices.T
    rows = [list(r.reshape(-1)) for r in rows]

    def run(src_maps: MetricMap, tgt_maps: MetricMap, init_poses: se3.Pose) -> ICPResult:
        lanes = shard_batch(mesh, (src_maps, tgt_maps, init_poses), data_axis)
        args = [(s, shard_points(t, row), g) for (s, t, g), row in zip(lanes, rows)]
        parts = run_per_position(lambda s, t, g: align(s, t, g, params_tp), args,
                                 [row[0] for row in rows])
        return gather_batch(parts, mesh.devices.flat[0])

    return run
