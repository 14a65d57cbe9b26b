"""Port parity for the scan step as the reference runs it by default: the
pipelined split step (the next queued scan is ingested and filtered behind
the current scan's align, with the damped deskew twist as it stands before
the current scan's gates and twist update), a time-gated duplicate whose
prefetch is thrown away, the kill switch after a failed prefetch, the
unfused step (filter, sanity readback, align) and ``warm_start``.

Inputs: the first 8 scans (4,096 points each) of the reference runner's
quickstart circle (1 m and 9 degrees a scan) in the synthetic world
without its poles (whose line-like kNN neighbourhoods make the reference's
own align follow f32 round-off, see ``tests/test_torch_pairwise.py``),
made from seeds with numpy, each point stamped with its azimuth as its
sweep time. The configuration is the reference tests' small odometry
configuration (``odom_test_cfg`` of ``tests/test_frontend.py``) with a
scan-start deskew in front, a 0.7 m voxel downsample to 1024 points with
kNN normals, and point-to-plane on those normals; so the prefetch's one-
scan-staler twist changes the clouds. Test-only: the search window is out
of reach (the trajectory must not depend on when the pool's checks land)
and ``min_icp_goodness`` is 0.2 (keyframes by distance).

Every observation is queued before the first scan finishes, in both
packages: the first scan has no align and prefetches nothing, the last has
nothing to prefetch, so both count n - 2 prefetches. Tolerances: 5 mm /
1 mrad a scan pose, equal keyframe ids, edge sets and prefetch counts.
"""

import copy
import math

import numpy as np
import pytest
import torch

from mola_fe_lidar_tpu.obs import runner as jrunner
from mola_fe_lidar_tpu_torch.obs import runner
from mola_fe_lidar_tpu_torch.obs.synthetic import SyntheticWorld, synthetic_sequence

torch.set_num_threads(1)
SCANS = 8

_ICP = {
    "params": {"maxIterations": 30},
    "matchers": [{"class": "Matcher_Point2Plane_Normals",
                  "params": {"distanceThreshold": 2.0,
                             "src_layer": "decimated", "tgt_layer": "decimated"}}],
    "solvers": [{"class": "Solver_GaussNewton", "params": {"maxIterations": 8}}],
    "quality": [{"class": "QualityEvaluator_PairedRatio",
                 "params": {"thresholdDistance": 0.3, "src_layer": "raw", "tgt_layer": "raw"}}],
}
CFG = {"params": {
    "precompile_rare_paths": False,
    "min_time_between_scans": 0.01,
    "min_dist_xyz_between_keyframes": 3.0,
    "min_icp_goodness": 0.2,
    "min_icp_goodness_lc": 0.35,
    # test-only: no nearby or loop-closure candidate within reach
    "min_dist_to_matching": 500.0,
    "max_dist_to_matching": 600.0,
    "max_dist_to_loop_closure": 600.0,
    "max_nearby_align_checks": 2,
    "min_topo_dist_to_consider_loopclosure": 8,
    "loop_closure_montecarlo_samples": 6,
    "pointcloud_generator": [
        {"class": "GeneratorRawPoints", "params": {"capacity": 4096, "keep_time": True}}],
    "pointcloud_filter": [
        {"class": "FilterDeskew",
         "params": {"input_layer": "raw", "scan_period": 0.1, "anchor": "start"}},
        {"class": "FilterVoxelDownsample", "params": {"voxel_size": 0.7, "output_capacity": 1024}},
        {"class": "FilterNormals", "params": {"input_layer": "decimated", "knn": 8}}],
    "icp_settings_with_vel": _ICP,
}}


@pytest.fixture(scope="module")
def seq():
    world = SyntheticWorld(extent=60.0, n_world_points=60_000, points_per_scan=4096,
                           max_range=35.0, seed=1)
    p = world._points
    on_grid = lambda x: np.abs((x + 52.5) / 15 - np.round((x + 52.5) / 15)) * 15 < 0.1
    world._points = p[~(on_grid(p[:, 0]) & on_grid(p[:, 1]) & (p[:, 2] > 0))]
    obs, gt = synthetic_sequence(kind="circle", n_scans=40, loop_side=40 / math.pi, world=world)
    for o in obs[:SCANS]:
        xy = o["xyz"][:, :2]
        o["time"] = ((np.arctan2(xy[:, 1], xy[:, 0]) + np.pi) / (2 * np.pi)).astype(np.float32)
    return obs[:SCANS], gt[:SCANS]


def _cfg(**over):
    cfg = copy.deepcopy(CFG)
    cfg["params"].update(over)
    return cfg


def _replay(pkg, obs, cfg, module_hook=None):
    """Queue every observation, then drain; (state, profiler stats,
    localizations, module)."""
    kw = {} if pkg is jrunner else {"device": "cpu"}
    m = pkg.build_module(cfg, **kw)
    if module_hook:
        module_hook(m)
    for o in obs:
        m.on_new_observation(o)
    m.drain()
    m.slam_backend._pool.submit(lambda: None).result()  # its queued calls landed
    return m.state_copy(), m.profiler.stats(), list(m.slam_backend.localizations), m


def _poses(locs):
    return [(loc.timestamp, loc.reference_kf, np.asarray(loc.pose.R, np.float64),
             np.asarray(loc.pose.t, np.float64)) for loc in sorted(locs, key=lambda x: x.timestamp)]


def _same_run(a, b):
    """Equal keyframe ids and edge sets, scan poses within 5 mm / 1 mrad."""
    (st, _, locs, _), (jst, _, jlocs, _) = a, b
    assert st.last_kf == jst.last_kf
    assert set(st.local_pose_graph.nodes) == set(jst.local_pose_graph.nodes)
    assert [(x, y) for x, y, *_ in st.edge_log] == [(x, y) for x, y, *_ in jst.edge_log]
    assert len(locs) == len(jlocs) > 0
    for (ts, kf, R, t), (jts, jkf, jR, jt) in zip(_poses(locs), _poses(jlocs)):
        assert ts == jts and kf == jkf
        assert np.linalg.norm(t - jt) < 5e-3
        dR = R.T @ jR
        assert np.arccos(np.clip((np.trace(dR) - 1) / 2, -1, 1)) < 1e-3
    np.testing.assert_allclose(st.world_t, jst.world_t, atol=5e-3)


def _count(stats, key):
    return stats.get(key, {"count": 0})["count"]


def _shutdown(*runs):
    for run in runs:
        run[3].shutdown()


def test_pipelined_replay_matches_reference(seq):
    obs, _ = seq
    run = _replay(runner, obs, _cfg())
    ref = _replay(jrunner, obs, _cfg())
    try:
        _same_run(run, ref)
        for stats in (run[1], ref[1]):
            assert _count(stats, "doProcess.prefetch_ingest") == SCANS - 2
            assert _count(stats, "doProcess.align_dispatch") == SCANS - 1
            assert _count(stats, "doProcess.generators") == 2
        assert run[3]._pipelined_ok and _count(run[1], "counter:doProcess.prefetch_disabled") == 0
        # the prefetch's staler twist changed the trajectory: the serial
        # step gives other poses
        serial = _replay(runner, obs, _cfg(pipelined_scan_step=False))
        _shutdown(serial)
        assert max(np.abs(a[3] - b[3]).max() for a, b in
                   zip(_poses(run[2]), _poses(serial[2]))) > 1e-6
    finally:
        _shutdown(run, ref)


def test_time_gated_duplicate_discards_its_prefetch(seq):
    obs, _ = seq
    dup = dict(obs[3])
    dup["timestamp"] = obs[3]["timestamp"] + 1e-4
    gated = obs[:4] + [dup] + obs[4:]
    run = _replay(runner, gated, _cfg(min_time_between_scans=0.05))
    ref = _replay(jrunner, gated, _cfg(min_time_between_scans=0.05))
    try:
        _same_run(run, ref)
        for stats in (run[1], ref[1]):
            assert stats["counter:doProcess.skip_too_soon"]["count"] == 1
            # the duplicate was prefetched and thrown away (the scan after
            # it ingests again), and it aligned nothing, so prefetched
            # nothing: n - 3 prefetches
            assert _count(stats, "doProcess.prefetch_ingest") == len(gated) - 3
            assert _count(stats, "doProcess.generators") == 3
    finally:
        _shutdown(run, ref)


def test_kill_switch(seq, caplog):
    """A prefetch that raises disables the pipeline for good, with a
    warning and a counter; the scan it was for and every later one take
    the fused serial step."""
    obs, _ = seq
    bad_ts = obs[4]["timestamp"]
    calls = {"n": 0}

    def hook(m):
        gen = m.generators[0]

        def flaky(o):
            if o["timestamp"] == bad_ts and calls["n"] == 0:
                calls["n"] += 1
                raise RuntimeError("injected ingest failure")
            return type(gen).__call__(gen, o)

        m.generators = [flaky]

    run = _replay(runner, obs, _cfg(), module_hook=hook)
    off = _replay(runner, obs, _cfg(), module_hook=lambda m: setattr(m, "_pipelined_ok", False))
    try:
        assert calls["n"] == 1 and not run[3]._pipelined_ok
        assert run[1]["counter:doProcess.prefetch_disabled"]["total"] == 1
        assert any("disabling the pipelined scan step" in r.message for r in caplog.records)
        # the prefetches of scans 2 and 3, and the failed one of scan 4
        assert _count(run[1], "doProcess.prefetch_ingest") == 3
        assert _count(off[1], "doProcess.prefetch_ingest") == 0
        assert off[0].last_kf is not None and run[0].last_kf is not None
    finally:
        _shutdown(run, off)


def test_unfused_step_matches_fused(seq):
    obs, _ = seq
    fused = _replay(runner, obs, _cfg(pipelined_scan_step=False))
    unfused = _replay(runner, obs, _cfg(fused_scan_step=False))
    try:
        _same_run(unfused, fused)
        assert _count(unfused[1], "doProcess.fused_step") == 0
        assert _count(unfused[1], "doProcess.filter") == SCANS
        assert _count(unfused[1], "run_one_icp.icp_latest") == SCANS - 1
        assert _count(unfused[1], "doProcess.prefetch_ingest") == 0
    finally:
        _shutdown(fused, unfused)


def test_warm_start_does_not_perturb(seq):
    """Scan-to-map with the default sort build, so the warm-up runs the
    map build and both align targets."""
    obs, gt = seq
    cfg = _cfg(odometry_reference="local_map", local_map_capacity_mult=2,
               local_map_quality_max_points=512)
    warm = runner.run_replay(obs[:3], cfg, gt_poses=gt[:3], device="cpu", warm_start=True)
    cold = runner.run_replay(obs[:3], cfg, gt_poses=gt[:3], device="cpu")
    try:
        assert warm["warm_s"] > 0 and cold["warm_s"] is None
        assert len(warm["scan_poses"]) == len(cold["scan_poses"]) == 3
        for (ts, (R, t)), (ts2, (R2, t2)) in zip(warm["scan_poses"], cold["scan_poses"]):
            assert ts == ts2
            np.testing.assert_array_equal(t, t2)
            np.testing.assert_array_equal(R, R2)
        assert cold["module"].profiler.stats()["doProcess.local_map_build"]["count"] >= 1
    finally:
        warm["module"].shutdown()
        cold["module"].shutdown()
