"""Port parity for the slice as a whole: an HDL-64 replay through both
packages' ``run_replay`` with the realtime KITTI configuration scaled to
azimuth 256 (16,384 rays), plus the port's standalone import (no JAX, no
reference package), its refusal of the settings it has not ported and its
acceptance of those it has.

Replay tolerance: 5 mm / 1 mrad per scan pose (measured agreement on this
sequence is ~0.1 mm / 0.2 mrad), with equal keyframe and factor counts.
At 1/8 of the sensor's azimuth resolution the paired-ratio goodness sits
near 0.3, so both packages run with ``min_icp_goodness: 0.25``; at the
preset's 0.5 every map align would fall back to scan-to-scan and no second
keyframe would be made.

The replay runs the preset's nearby-keyframe / loop-closure window, with
test-only overrides (``REPLAY_OVERRIDES``) that make both kinds of check
happen within 14 scans. Accepted non-adjacent edges must be the same set
with poses within 5 mm / 1 mrad. What makes the runs comparable: both
packages take the same Monte-Carlo guesses (made here with numpy; torch
cannot reproduce ``jax.random``), and each module finishes every scan and
every check it started before the next scan is fed, with one pool worker,
so which checks run and which edges they see does not depend on timing.
(That feed also leaves the pipelined step nothing queued to prefetch; the
prefetch itself is held to the reference in ``test_torch_pipelined.py``.)
"""

import importlib.util
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest
import torch

from mola_fe_lidar_tpu.obs import hdl64 as jhdl64
from mola_fe_lidar_tpu.obs import runner as jrunner
from mola_fe_lidar_tpu_torch.obs import hdl64, runner

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parent.parent
AZIMUTH = 256
SCANS = 8
# test-only: keyframes every ~2 scans and a window from 2.5 m, so that
# nearby checks (2 keyframes apart) and a loop-closure check (3 apart) run
# within 8 scans; two nearby lanes, four Monte-Carlo lanes of at most 25
# iterations, and a loop-closure gate that the low-resolution goodness can
# pass
REPLAY_OVERRIDES = (
    "min_icp_goodness=0.25",
    "min_dist_xyz_between_keyframes=1.5",
    "min_dist_to_matching=2.5",
    "min_topo_dist_to_consider_loopclosure=3",
    "max_nearby_align_checks=2",
    "loop_closure_montecarlo_samples=4",
    "icp_settings_loop_closure.params.maxIterations=25",
    "min_icp_goodness_lc=0.3",
    "min_icp_goodness_lc_auto=false",
)


def _run_accuracy():
    spec = importlib.util.spec_from_file_location(
        "run_accuracy", REPO / "scripts" / "run_accuracy.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _reference_config(scale, extra=()):
    ra = _run_accuracy()
    return ra.build_cfg(deskew=True, scale=scale, local_map=True,
                        overrides=ra.REALTIME + tuple(extra))


@pytest.mark.parametrize("scale", [1.0, AZIMUTH / 2048])
def test_realtime_config_is_the_reference_construction(scale):
    assert runner.REALTIME == _run_accuracy().REALTIME
    assert runner.realtime_config(scale) == _reference_config(scale)


def test_simulator_copy_is_the_reference():
    obs, gt = hdl64.hdl64_sequence(n_scans=2, n_azimuth=64)
    obs_j, gt_j = jhdl64.hdl64_sequence(n_scans=2, n_azimuth=64)
    for a, b in zip(obs, obs_j):
        for key in ("xyz", "valid", "time"):
            np.testing.assert_array_equal(a[key], b[key])
    for (R, t), (Rj, tj) in zip(gt, gt_j):
        np.testing.assert_array_equal(R, Rj)
        np.testing.assert_array_equal(t, tj)


def _guesses(center_R, center_t, n):
    """The Monte-Carlo guesses both packages take: yaw and translation
    perturbations of the centre, from a fixed numpy stream."""
    rng = np.random.default_rng(11)
    yaw = rng.normal(0, 0.02, n)
    c, s = np.cos(yaw), np.sin(yaw)
    Rz = np.zeros((n, 3, 3))
    Rz[:, 0, 0], Rz[:, 0, 1], Rz[:, 1, 0], Rz[:, 1, 1], Rz[:, 2, 2] = c, -s, s, c, 1.0
    R = Rz @ np.asarray(center_R, np.float64)
    t = Rz @ np.asarray(center_t, np.float64) + rng.normal(0, 0.25, (n, 3))
    return R.astype(np.float32), t.astype(np.float32)


def _serial(monkeypatch, cls):
    """Each scan and the checks it starts finish before the next scan is
    fed, on one pool worker."""
    feed = cls.on_new_observation

    def serial_feed(self, obs):
        if self._nearby_pool._max_workers != 1:
            self._nearby_pool.shutdown()
            self._nearby_pool = ThreadPoolExecutor(1)
        fut = feed(self, obs)
        self.drain()
        return fut

    monkeypatch.setattr(cls, "on_new_observation", serial_feed)


def _non_adjacent(module):
    st = module.state
    return {(a, b): (R, t) for a, b, R, t in st.edge_log
            if (min(a, b), max(a, b)) in st.checked_KF_pairs}


def test_replay_matches_reference(monkeypatch):
    import jax.numpy as jnp
    from mola_fe_lidar_tpu.frontend import odometry as jodometry
    from mola_fe_lidar_tpu.geometry import se3 as jse3
    from mola_fe_lidar_tpu_torch.frontend import odometry
    from mola_fe_lidar_tpu_torch.geometry import se3

    def port_guesses(gen, center, n, sigma_xyz, sigma_rot):
        R, t = _guesses(center.R.cpu().numpy(), center.t.cpu().numpy(), n)
        return se3.Pose(torch.from_numpy(R), torch.from_numpy(t))

    def ref_guesses(key, center, n, sigma_xyz, sigma_rot):
        R, t = _guesses(np.asarray(center.R), np.asarray(center.t), n)
        return jse3.Pose(jnp.asarray(R), jnp.asarray(t))

    monkeypatch.setattr(odometry, "monte_carlo_guesses", port_guesses)
    monkeypatch.setattr(jodometry, "monte_carlo_guesses", ref_guesses)
    _serial(monkeypatch, odometry.LidarOdometry)
    _serial(monkeypatch, jodometry.LidarOdometry)
    obs, gt = hdl64.hdl64_sequence(n_scans=SCANS, n_azimuth=AZIMUTH)
    cfg = runner.build_config(scale=AZIMUTH / 2048, overrides=(
        runner.REALTIME + REPLAY_OVERRIDES))
    assert cfg == _reference_config(AZIMUTH / 2048, REPLAY_OVERRIDES)
    # the reference spends most of its run compiling; replay both at once
    # (precompile_rare_paths only schedules more reference compiles)
    with ThreadPoolExecutor(1) as pool:
        ref_future = pool.submit(jrunner.run_replay, obs, _reference_config(
            AZIMUTH / 2048, REPLAY_OVERRIDES + ("precompile_rare_paths=false",)),
            gt_poses=gt)
        res = runner.run_replay(obs, cfg, gt_poses=gt, device="cpu")
        ref = ref_future.result()
    try:
        assert res["jobs_abandoned"] == 0 and ref["jobs_abandoned"] == 0
        assert res["n_keyframes"] == ref["n_keyframes"] >= 4
        assert res["n_factors"] == ref["n_factors"]
        stats = res["module"].profiler.stats()
        ref_stats = ref["module"].profiler.stats()
        # both kinds of check ran, the same number of times in both
        for kind in ("nearby", "lc"):
            key = f"counter:checkNonAdjacent.{kind}.accepted"
            assert stats[key]["count"] >= 1
            assert stats[key]["count"] == ref_stats[key]["count"]
            assert stats[key]["total"] == ref_stats[key]["total"]
        assert stats["checkNonAdjacent.nearby_batch_align"]["count"] >= 1
        edges, ref_edges = _non_adjacent(res["module"]), _non_adjacent(ref["module"])
        assert set(edges) == set(ref_edges)
        assert res["n_nearby_edges"] + res["n_loop_closures"] == len(edges)
        assert res["n_loop_closures"] == len(ref["module"].state.lc_pairs)
        for pair, (R, t) in edges.items():
            Rj, tj = ref_edges[pair]
            assert np.linalg.norm(t - tj) < 5e-3
            dR = R.T @ Rj
            assert np.linalg.norm(dR - dR.T) / (2 * np.sqrt(2)) < 1e-3  # sin of the angle
        # the map path ran: some map aligns were accepted, not all fell back
        assert stats["counter:icp_latest.goodness"]["count"] == SCANS - 1
        assert stats.get("counter:doProcess.map_align_weak", {"total": 0})["total"] < SCANS - 2
        assert len(res["scan_poses"]) == len(ref["scan_poses"]) == SCANS
        for (ts, (R, t)), (tsj, (Rj, tj)) in zip(res["scan_poses"], ref["scan_poses"]):
            assert ts == tsj
            assert np.linalg.norm(t - tj) < 5e-3
            dR = R.T @ Rj
            assert np.arccos(np.clip((np.trace(dR) - 1) / 2, -1, 1)) < 1e-3
        assert abs(res["ate_rmse_scan"] - ref["ate_rmse_scan"]) < 5e-3
    finally:
        res["module"].shutdown()
        ref["module"].shutdown()


_BLOCKED = r"""
import importlib.abc, json, sys
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        top = name.split(".")[0]
        if top in ("jax", "jaxlib") or top == "mola_fe_lidar_tpu":
            raise ImportError(f"blocked: {name}")
        return None
sys.meta_path.insert(0, Block())
sys.path.insert(0, sys.argv[1])
import torch
torch.set_num_threads(1)
import numpy as np
from mola_fe_lidar_tpu_torch.geometry import se3
from mola_fe_lidar_tpu_torch.models import align, icp_settings_regular
from mola_fe_lidar_tpu_torch.obs import accuracy, viz  # noqa: F401 -- the tools import too
from mola_fe_lidar_tpu_torch.obs.hdl64 import hdl64_sequence
from mola_fe_lidar_tpu_torch.obs.runner import default_config, realtime_config, run_replay
from mola_fe_lidar_tpu_torch.obs.scan_pairs import make_pairs, stack_pairs
from mola_fe_lidar_tpu_torch.obs.synthetic import SyntheticWorld, synthetic_sequence
obs, gt = hdl64_sequence(n_scans=2, n_azimuth=128)
res = run_replay(obs, realtime_config(128 / 2048), gt_poses=gt, device="cpu")
res["module"].shutdown()
# the pairwise path: a quickstart replay and a kNN = 6 align of a scan pair
world = SyntheticWorld(extent=60.0, n_world_points=20_000, points_per_scan=512, seed=1)
qobs, qgt = synthetic_sequence(kind="circle", n_scans=40, loop_side=40 / 3.14159, world=world)
quick = run_replay(qobs[:2], default_config(("pointcloud_generator.0.params.capacity=512",
                                             "pointcloud_filter.0.params.output_capacity=512")),
                   gt_poses=qgt[:2], device="cpu")
quick["module"].shutdown()
src, tgt, _ = stack_pairs(make_pairs(np.random.default_rng(7), 2, 256), 256, device="cpu")
pair = align(src, tgt, se3.Pose(torch.eye(3).expand(2, 3, 3), torch.zeros(2, 3)),
             icp_settings_regular())
# the device meshes: two positions on the CPU
from mola_fe_lidar_tpu_torch import parallel
parallel.mesh.force_device_count(2)
mesh2 = parallel.make_mesh({"data": 2}, parallel.mesh.devices("cpu"))
print(json.dumps({"n_keyframes": res["n_keyframes"], "jobs_abandoned": res["jobs_abandoned"],
                  "n_poses": len(res["scan_poses"]), "quick_poses": len(quick["scan_poses"]),
                  "pair_finite": bool(torch.isfinite(pair.pose.t).all()),
                  "mesh": mesh2.shape,
                  "loaded": sorted(m for m in sys.modules
                                   if m.split(".")[0] in ("jax", "jaxlib", "mola_fe_lidar_tpu"))}))
"""


def test_backend_flush_waits_for_submitted_calls():
    """``run_replay`` reads the recorded localizations after ``flush``: a
    call still queued on the back-end's thread must be recorded by then."""
    import threading

    from mola_fe_lidar_tpu_torch.frontend.backend import InMemoryBackend

    backend = InMemoryBackend()
    gate = threading.Event()
    backend._submit(gate.wait, None)  # holds the back-end's one worker
    backend.advertise_updated_localization("loc")
    threading.Timer(0.2, gate.set).start()
    backend.flush()
    assert backend.localizations == ["loc"]
    backend.shutdown()


def test_port_runs_with_jax_and_the_reference_blocked():
    proc = subprocess.run([sys.executable, "-E", "-c", _BLOCKED, str(REPO)],
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out == {"n_keyframes": 1, "jobs_abandoned": 0, "n_poses": 2, "quick_poses": 2,
                   "pair_finite": True, "mesh": {"data": 2}, "loaded": []}


@pytest.mark.parametrize("override, first_filter", [
    ("decimate_to_point_count=4096", "FilterDecimateToCount"),
    ("pointcloud_filter.1.params.stats_mode=segment", "FilterDeskew"),
    ("fused_scan_step=false", "FilterDeskew"),
    ("deskew_in_loop=true", "FilterDeskew"),
    ("local_map_build_mode=sort", "FilterDeskew"),
    ("local_map_min_views=2,local_map_async_build=true", "FilterDeskew"),
    ("local_map_cand_motion_trans=0.05", "FilterDeskew"),
    ("local_map_nn_backend=grid", "FilterDeskew"),
])
def test_settings_ported_since_build(override, first_filter):
    cfg = runner.build_config(overrides=runner.REALTIME + tuple(override.split(",")))
    module = runner.build_module(cfg, device="cpu")
    try:
        assert type(module.filter_pipeline.filters[0]).__name__ == first_filter
        if "min_views" in override:  # the host builder
            assert type(module._make_map_builder()).__name__ == "LocalMap"
        if "cand_motion" in override:  # the motion-conditional refresh
            from mola_fe_lidar_tpu_torch.models.config import AlignKind
            stages = module._stages_for(AlignKind.LIDAR_ODOMETRY, True)
            assert {s.cand_refresh_min_trans for s in stages} == {0.05}
        if "nn_backend" in override:  # the voxel-hash grid on the map stages
            from mola_fe_lidar_tpu_torch.models.config import AlignKind
            stages = module._stages_for(AlignKind.LIDAR_ODOMETRY, True)
            assert {m.nn_backend for s in stages for m in s.matchers} == {"grid"}
    finally:
        module.shutdown()


def test_spin_once_registers_queue_metrics():
    """``spin_once`` opens its span and records the queue depth and the
    nearby checks in flight (``tests/test_deskew_pyramid.py``'s case of
    the reference)."""
    from mola_fe_lidar_tpu_torch.obs.synthetic import SyntheticWorld, synthetic_sequence

    w = SyntheticWorld(extent=60.0, n_world_points=30_000, points_per_scan=1024,
                       max_range=35.0, seed=4)
    obs, _ = synthetic_sequence(kind="straight", n_scans=3, world=w)
    cfg = runner.default_config(overrides=("pointcloud_generator.0.params.capacity=1024",
                                           "pointcloud_filter.0.params.output_capacity=1024"))
    m = runner.build_module(cfg, device="cpu")
    try:
        for o in obs:
            m.on_new_observation(o)
            m.spin_once()
        m.drain()
        st = m.profiler.stats()
    finally:
        m.shutdown()
    assert "counter:spinOnce.pending_scans" in st
    assert "counter:spinOnce.nearby_inflight" in st
    assert st["spinOnce"]["count"] == 3
