"""Port parity for the rolling-map builds beyond the hash ring: the sort
build (``DeviceLocalMap(mode="sort")``, the reference's default: stable
voxel sort, the oldest keyframe's point wins, hash-uniform compaction when
the voxels overflow the capacity), the host ``LocalMap`` with the multi-
view transient filter (``local_map_min_views=2``), and the asynchronous
rebuild (``local_map_async_build``), whose last build must leave the
module with the map a synchronous build of its keyframes gives.

Inputs, made from seeds with numpy: keyframe layers of random points over
+-500 m with a quarter on integer coordinates (shared voxels, so the dedup
has work), normals, planarity and sweep times, placed by world poses whose
products are exact in f32 (axis permutations, integer translations); and,
for the replay, the first scans of the synthetic circle of the reference
runner's quickstart.

Tolerance: identical masks, points and attributes (the builds are integer
logic and gathers on exact coordinates).
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mola_fe_lidar_tpu.cloud.metric_map import PointCloud as JPointCloud
from mola_fe_lidar_tpu.cloud import voxel as jvoxel
from mola_fe_lidar_tpu.frontend import local_map as jlm
from mola_fe_lidar_tpu_torch.cloud import voxel
from mola_fe_lidar_tpu_torch.cloud.metric_map import PointCloud
from mola_fe_lidar_tpu_torch.frontend import local_map
from mola_fe_lidar_tpu_torch.obs import runner
from mola_fe_lidar_tpu_torch.obs.synthetic import SyntheticWorld, synthetic_sequence

torch.set_num_threads(1)
RES = 0.25


def _keyframes(seed, n_kf, n=512, spread=500.0):
    """[(port layers, reference layers, world pose)] of ``n_kf`` keyframes."""
    rng = np.random.default_rng(seed)
    perm = np.eye(3)[[1, 0, 2]] * np.array([1, -1, 1])
    out = []
    for i in range(n_kf):
        xyz = rng.uniform(-spread, spread, size=(n, 3)).astype(np.float32)
        xyz[: n // 4] = np.round(xyz[: n // 4])
        mask = (rng.uniform(size=n) > 0.2).astype(np.float32)
        xyz[mask < 0.5] = 1e6
        attrs = {"normal": rng.standard_normal((n, 3)).astype(np.float32),
                 "planarity": rng.uniform(size=(n, 1)).astype(np.float32),
                 "time": rng.uniform(size=(n, 1)).astype(np.float32)}
        pose = (perm if i % 2 else np.eye(3), rng.integers(-20, 20, size=3).astype(np.float64))
        out.append(({"planes": PointCloud(torch.from_numpy(xyz), torch.from_numpy(mask),
                                          {k: torch.from_numpy(v) for k, v in attrs.items()})},
                    {"planes": JPointCloud(jnp.asarray(xyz), jnp.asarray(mask),
                                           {k: jnp.asarray(v) for k, v in attrs.items()})},
                    pose))
    return out


def _same(out, want):
    assert set(out) == set(want)
    for name in out:
        np.testing.assert_array_equal(out[name].mask.numpy(), np.asarray(want[name].mask))
        np.testing.assert_array_equal(out[name].xyz.numpy(), np.asarray(want[name].xyz))
        assert set(out[name].attrs) == set(want[name].attrs)
        for k, v in out[name].attrs.items():
            np.testing.assert_array_equal(v.numpy(), np.asarray(want[name].attrs[k]))


@pytest.mark.parametrize("capacity_mult", [4, 1], ids=["fits", "overflows"])
def test_sort_build_matches_reference(capacity_mult):
    """Five keyframes through a window of three, built after each."""
    port = local_map.DeviceLocalMap(window=3, capacity_mult=capacity_mult, dedup_voxel=RES,
                                    mode="sort")
    ref = jlm.DeviceLocalMap(window=3, capacity_mult=capacity_mult, dedup_voxel=RES, mode="sort")
    for mm, jmm, pose in _keyframes(1, 5):
        port.add_keyframe(mm, pose)
        ref.add_keyframe(jmm, pose)
        out, want = port.build(), ref.build()
        _same(out, want)
        assert "time" not in out["planes"].attrs
    valid = int(out["planes"].mask.sum())
    assert 0 < valid <= out["planes"].capacity
    # overflow: more voxels than slots, the compaction had to choose
    assert (valid == out["planes"].capacity) == (capacity_mult == 1)
    # an entries snapshot builds the same map
    _same(port.build(port.entries()), want)


def test_host_local_map_with_min_views_matches_reference():
    """The host builder with the multi-view transient filter (two views,
    the newest two keyframes exempt), on exact poses; the map lands on the
    builder's device."""
    kw = dict(window=4, capacity_mult=2, dedup_voxel=RES, transient_min_views=2,
              transient_protect_recent=2)
    port = local_map.LocalMap(device="cpu", **kw)
    ref = jlm.LocalMap(**kw)
    plain = local_map.LocalMap(device="cpu", **{**kw, "transient_min_views": 1})
    for mm, jmm, pose in _keyframes(2, 6, spread=40.0):
        port.add_keyframe(mm, pose)
        ref.add_keyframe(jmm, pose)
        plain.add_keyframe(mm, pose)
        out, want = port.build(), ref.build()
        _same(out, want)
    assert out["planes"].xyz.device.type == "cpu"
    # the port's copy of the reference's numpy dedup helper
    xyz = out["planes"].xyz.numpy()[out["planes"].mask.numpy() > 0.5]
    np.testing.assert_array_equal(voxel.voxel_first_indices_np(xyz, 2.0),
                                  jvoxel.voxel_first_indices_np(xyz, 2.0))
    # the filter dropped single-view voxels of the older keyframes
    assert int(plain.build()["planes"].mask.sum()) > int(out["planes"].mask.sum())


def test_async_replay_ends_with_the_sync_map():
    """With ``local_map_async_build`` the rebuilds after the first run on
    the pool (one in flight, a dirty flag, a follow-up build); once the
    replay drains, the module's map is what a synchronous build of its
    keyframes gives."""
    world = SyntheticWorld(extent=60.0, n_world_points=30_000, points_per_scan=2048,
                           max_range=35.0, seed=1)
    obs, gt = synthetic_sequence(kind="circle", n_scans=40, loop_side=40 / math.pi, world=world)
    cfg = runner.default_config(("pointcloud_generator.0.params.capacity=2048",
                                 "pointcloud_filter.0.params.output_capacity=1024",
                                 "min_dist_xyz_between_keyframes=1.5",
                                 "min_icp_goodness=0.2",
                                 "odometry_reference=local_map",
                                 "local_map_async_build=true",
                                 "local_map_capacity_mult=2",
                                 "local_map_quality_max_points=512",
                                 "min_dist_to_matching=500"))
    res = runner.run_replay(obs[:6], cfg, gt_poses=gt[:6], device="cpu")
    m = res["module"]
    try:
        stats = m.profiler.stats()
        assert res["jobs_abandoned"] == 0 and res["n_keyframes"] >= 3
        assert stats["doProcess.local_map_build"]["count"] == 1  # the first map, inline
        assert stats["doProcess.local_map_build_async"]["count"] >= 1
        assert not m._map_build_inflight and not m._map_build_dirty
        builder = m._local_map_builder
        assert len(builder) == res["n_keyframes"]
        _same(m.state.local_map, builder.build())
    finally:
        m.shutdown()
