"""The front-end on a device mesh: ``mesh_model`` splits the map align's
target over a ``model`` axis and ``mesh_data`` the search's batches over a
``data`` axis, on 8 CPU positions (``force_device_count(8)``), as the JAX
package's ``tests/test_mesh_frontend.py`` runs its own on 8 virtual CPU
devices.

Each mesh replay is held to the port's own single-device replay, as the
reference holds its mesh replays to its single-device ones
(``tests/test_torch_odometry.py`` holds the port's single-device replay to
the reference's): keyframe translations and factor translations within
1e-4 m, the same keyframes and factor set. The scenes are the reference
test's (``odom_test_cfg``, the synthetic straight run) with half its
points a scan (2048, decimated to 1024), to keep the file quick. The JAX
side here is only the loop-closure Monte-Carlo count, read from the
reference's ``_dp_pad`` without a replay.
"""

import dataclasses
import logging

import numpy as np
import pytest
import torch

from mola_fe_lidar_tpu.obs import runner as jrunner
from mola_fe_lidar_tpu_torch.frontend import odometry
from mola_fe_lidar_tpu_torch.models.config import AlignKind
from mola_fe_lidar_tpu_torch.obs import runner
from mola_fe_lidar_tpu_torch.obs.synthetic import SyntheticWorld, synthetic_sequence
from mola_fe_lidar_tpu_torch.parallel import mesh
from tests.test_frontend import odom_test_cfg

torch.set_num_threads(1)
POINTS = 2048


@pytest.fixture
def cpu8():
    previous = mesh.force_device_count(8)
    try:
        yield mesh.devices("cpu")
    finally:
        mesh.force_device_count(previous)


def _cfg(**over):
    cfg = odom_test_cfg(**over)
    cfg["params"]["pointcloud_generator"][0]["params"]["capacity"] = POINTS
    cfg["params"]["pointcloud_filter"][0]["params"]["output_capacity"] = POINTS // 2
    return cfg


def _scans(n):
    world = SyntheticWorld(extent=60.0, n_world_points=60_000, points_per_scan=POINTS,
                           max_range=35.0, seed=1)
    return synthetic_sequence(kind="straight", n_scans=n, speed=2.0, rate_hz=2.0, world=world)


def _replays(obs, gt, cfg_one, cfg_mesh):
    one = runner.run_replay(obs, cfg_one, gt_poses=gt, device="cpu")
    try:
        return one, runner.run_replay(obs, cfg_mesh, gt_poses=gt, device="cpu")
    except BaseException:
        one["module"].shutdown()
        raise


def test_tp_map_align_matches_single_device(cpu8):
    """mesh_model=2: every map align runs with the local map split on its
    point axis over 2 positions, re-split after each rebuild."""
    obs, gt = _scans(10)
    base = dict(odometry_reference="local_map", local_map_keyframes=4,
                local_map_capacity_mult=2)
    one, tp = _replays(obs, gt, _cfg(**base), _cfg(mesh_model=2, **base))
    try:
        assert tp["module"]._mesh is not None and tp["module"]._mesh.shape == {"data": 1,
                                                                               "model": 2}
        split_of, split = tp["module"]._map_split
        assert split_of is tp["module"].state.local_map and len(split["decimated"].xyz) == 2
        t1 = {k: np.asarray(t) for k, (R, t) in one["kf_poses"].items()}
        t2 = {k: np.asarray(t) for k, (R, t) in tp["kf_poses"].items()}
        assert set(t1) == set(t2) and len(t1) >= 3
        for k in t1:
            np.testing.assert_allclose(t2[k], t1[k], atol=1e-4, err_msg=f"KF {k} under TP")
    finally:
        one["module"].shutdown()
        tp["module"].shutdown()


@pytest.fixture(scope="module")
def dp_replays():
    """The reference test's nearby window, on one device and on data=4."""
    previous = mesh.force_device_count(8)
    try:
        obs, gt = _scans(14)
        over = dict(min_dist_to_matching=2.0, max_dist_to_matching=9.0,
                    max_nearby_align_checks=3)
        one, dp = _replays(obs, gt, _cfg(**over), _cfg(mesh_data=4, **over))
    finally:
        mesh.force_device_count(previous)
    yield one, dp
    one["module"].shutdown()
    dp["module"].shutdown()


def test_dp_nearby_batch_matches_single_device(dp_replays):
    one, dp = dp_replays
    f1 = {(f.kf_from, f.kf_to): np.asarray(f.rel_pose.t) for f in one["backend"].factors}
    f2 = {(f.kf_from, f.kf_to): np.asarray(f.rel_pose.t) for f in dp["backend"].factors}
    assert any(abs(a - b) > 1 for a, b in f1), f1.keys()  # nearby edges exist
    assert set(f1) == set(f2)
    for k in f1:
        np.testing.assert_allclose(f2[k], f1[k], atol=1e-4, err_msg=f"factor {k}")
    # the batches ran over the data axis: 3 checks padded to 4 lanes
    lanes = dp["module"].profiler.stats()["counter:checkNonAdjacent.nearby.dp_lanes"]
    assert lanes["count"] >= 1 and lanes["min"] == lanes["max"] == 4


def test_loop_closure_monte_carlo_count_rounds_up(dp_replays, monkeypatch):
    """10 Monte-Carlo samples on a data mesh of 4 draw 12 guesses, in both
    packages (the reference's rule: more coverage, not padding)."""
    cfg = odom_test_cfg(mesh_data=4, loop_closure_montecarlo_samples=10)
    ref = jrunner.build_module(cfg)
    try:
        assert ref._mesh is not None
        assert ref._dp_pad(ref.params.loop_closure_montecarlo_samples) == 12
    finally:
        ref.shutdown()
    module = dp_replays[1]["module"]
    module.params.loop_closure_montecarlo_samples = 10
    module.icp_cases[AlignKind.LOOP_CLOSURE] = tuple(
        dataclasses.replace(s, max_iterations=2) for s in module.icp_cases[AlignKind.LOOP_CLOSURE])
    drawn = []
    guesses = odometry.monte_carlo_guesses
    monkeypatch.setattr(odometry, "monte_carlo_guesses",
                        lambda gen, center, n, *a, **kw: drawn.append(n) or guesses(
                            gen, center, n, *a, **kw))
    kfs = sorted(module.worldmodel.entities())
    R, t = module.state.local_pose_graph.dijkstra_nodes_estimate(kfs[-1])[0][kfs[0]]
    module._check_non_adjacent("lc", kfs[-1], kfs[0], R, t)
    assert drawn == [12]
    lanes = module.profiler.stats()["counter:checkNonAdjacent.lc.dp_lanes"]
    assert lanes["count"] == 1 and lanes["max"] == 12


def test_insufficient_devices_falls_back(cpu8, caplog):
    obs, gt = _scans(4)
    with caplog.at_level(logging.WARNING, logger="mola_fe_lidar_tpu_torch"):
        res = runner.run_replay(obs, _cfg(mesh_data=64), gt_poses=gt, device="cpu")
    try:
        assert res["module"]._mesh is None
        assert res["n_keyframes"] >= 1 and len(res["scan_poses"]) == 4
        assert any("mesh data=64 model=1 needs 64 devices, found 8" in r.getMessage()
                   and "falling back to single-device" in r.getMessage()
                   for r in caplog.records)
    finally:
        res["module"].shutdown()


def test_mesh_setting_builds_the_mesh(cpu8):
    module = runner.build_module(runner.build_config(overrides=runner.REALTIME + ("mesh_data=2",)),
                                 device="cpu")
    try:
        assert module._mesh is not None and module._mesh.shape == {"data": 2, "model": 1}
        assert module._dp_pad(5) == 6
    finally:
        module.shutdown()


def test_runner_mesh_flag(monkeypatch, capsys):
    """``--mesh`` writes the mesh parameters; ``--device cpu`` gives 8 CPU
    positions for the run (and only for it); a bad component is the
    reference's parser error."""
    seen = {}

    def stub(observations, cfg, gt_poses=None, device="cuda", **kw):
        seen.update(params=cfg["params"], positions=len(mesh.devices("cpu")))
        raise SystemExit(0)

    monkeypatch.setattr(runner, "run_replay", stub)
    with pytest.raises(SystemExit):
        runner.main(["--scans", "2", "--device", "cpu", "--mesh", "data=4,model=2"])
    assert seen["params"]["mesh_data"] == 4 and seen["params"]["mesh_model"] == 2
    assert seen["positions"] == 8 and len(mesh.devices("cpu")) == 1
    assert "mesh_data" not in runner.default_config()["params"]
    capsys.readouterr()
    errors = []
    for main, argv in ((runner.main, ["--device", "cpu", "--mesh", "data=2,rows=3"]),
                       (jrunner.main, ["--mesh", "data=2,rows=3"])):
        with pytest.raises(SystemExit) as exc:
            main(argv)
        assert exc.value.code == 2
        errors.append(capsys.readouterr().err.strip().splitlines()[-1].split(": error: ")[1])
    assert errors[0] == errors[1] == "bad --mesh component 'rows=3' (want data=N[,model=M])"
