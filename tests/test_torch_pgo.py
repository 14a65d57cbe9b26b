"""Port parity for the pose-graph back-end and for checkpoints:
``optimize_pose_graph`` with each robust kernel, ``OptimizingBackend``
over a recorded factor stream, the runner's ``pgo=True`` rows, and a
checkpoint written by the reference's ``save_checkpoint`` loaded and
resumed by the port.

Inputs, made from seeds with numpy: a noisy odometry chain around a
square with one true loop closure and one false one (two far-apart nodes
said to coincide), as in the reference's ``tests/test_pgo.py``; for the
replays, the first scans (4,096 points) of the quickstart circle in the
synthetic world without its poles, with kNN normals and point-to-plane
(the configuration of ``tests/test_torch_pipelined.py``).

Tolerances: optimized poses within 1 mm / 0.2 mrad; the resumed scans'
world poses within 5 mm / 1 mrad, with equal keyframe ids and edge sets.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mola_fe_lidar_tpu.frontend import backend as jbackend
from mola_fe_lidar_tpu.frontend import checkpoint as jcheckpoint
from mola_fe_lidar_tpu.obs import runner as jrunner
from mola_fe_lidar_tpu.solve import pose_graph_gn as jpgo
from mola_fe_lidar_tpu_torch.frontend import backend, checkpoint
from mola_fe_lidar_tpu_torch.frontend.worldmodel import ANNOTATION_NAME_PC_LAYERS
from mola_fe_lidar_tpu_torch.geometry import se3_np
from mola_fe_lidar_tpu_torch.obs import runner
from mola_fe_lidar_tpu_torch.obs.synthetic import SyntheticWorld, synthetic_sequence
from mola_fe_lidar_tpu_torch.solve import pose_graph_gn

torch.set_num_threads(1)
W_T = 1.0 / 0.1 ** 2
W_R = 1.0 / np.deg2rad(1.0) ** 2


def _square_loop(rng, n=12, noise=0.02):
    """(initial poses, ground truth, edges [(i, j, R, t, w_t, w_r)]): a
    noisy chain around a square, the true loop closure n-1 -> 0 and a false
    one 3 -> 9."""
    gt = [(np.eye(3), np.zeros(3))]
    taus = [np.array([2.0, 0, 0, 0, 0, np.pi / 4 if k % 2 else 0.0]) for k in range(n - 1)]
    for tau in taus:
        gt.append(se3_np.compose(gt[-1], se3_np.exp(tau)))
    init, edges = [(np.eye(3), np.zeros(3))], []
    for k, tau in enumerate(taus):
        R, t = se3_np.exp(tau + rng.normal(0, noise, 6))
        edges.append((k, k + 1, R, t, W_T, W_R))
        init.append(se3_np.compose(init[-1], (R, t)))
    edges.append((n - 1, 0, *se3_np.compose(se3_np.inverse(gt[-1]), gt[0]), W_T, W_R))
    edges.append((3, 9, np.eye(3), np.zeros(3), W_T, W_R))
    return init, gt, edges


def _close(R, t, jR, jt):
    R, t, jR, jt = (np.asarray(x, np.float64) for x in (R, t, jR, jt))
    assert np.abs(t - jt).max() < 1e-3
    dR = np.swapaxes(R, -1, -2) @ jR
    assert (np.linalg.norm(dR - np.swapaxes(dR, -1, -2), axis=(-2, -1)) / (2 * np.sqrt(2))).max() \
        < 2e-4


@pytest.mark.parametrize("robust", ["none", "huber", "cauchy"])
def test_optimize_pose_graph_matches_reference(robust):
    init, gt, edges = _square_loop(np.random.default_rng(0))
    arrays = [np.stack([R for R, _ in init]), np.stack([t for _, t in init]),
              np.ones(len(init)), np.array([e[0] for e in edges]), np.array([e[1] for e in edges]),
              np.stack([e[2] for e in edges]), np.stack([e[3] for e in edges]),
              np.array([e[4] for e in edges]), np.array([e[5] for e in edges]),
              np.ones(len(edges))]
    e_robust = np.zeros(len(edges), np.float32)
    e_robust[-2:] = 1.0  # the loop closures are hypotheses
    dt = [np.float32] * 3 + [np.int32] * 2 + [np.float32] * 5
    R, t, cost = pose_graph_gn.optimize_pose_graph(
        *(torch.from_numpy(np.asarray(a, d)) for a, d in zip(arrays, dt)), iters=40,
        robust=robust, e_robust=torch.from_numpy(e_robust))
    jR, jt, jcost = jpgo.optimize_pose_graph(
        *(jnp.asarray(np.asarray(a, d)) for a, d in zip(arrays, dt)), iters=40,
        robust=robust, e_robust=jnp.asarray(e_robust))
    _close(R.numpy(), t.numpy(), jR, jt)
    assert abs(float(cost) - float(jcost)) <= 1e-3 * float(jcost)
    np.testing.assert_array_equal(t[0].numpy(), init[0][1].astype(np.float32))  # the gauge
    ate = lambda tt: float(np.sqrt(np.mean(np.sum(
        (np.asarray(tt, np.float64) - np.stack([p for _, p in gt])) ** 2, -1))))
    if robust == "cauchy":  # the false closure is switched off
        assert ate(t.numpy()) < 0.5


def test_optimizing_backend_matches_reference():
    init, _, edges = _square_loop(np.random.default_rng(1))
    port, ref = backend.OptimizingBackend(device="cpu"), jbackend.OptimizingBackend()
    try:
        for b, mod in ((port, backend), (ref, jbackend)):
            for a, c, R, t, *_ in edges:
                b.add_factor(mod.FactorRelativePose3(
                    kf_from=a, kf_to=c,
                    rel_pose=backend.HostPose(np.float32(R), np.float32(t)))).result()
        for robust in ("none", "cauchy"):
            got, want = port.optimized_poses(robust=robust), ref.optimized_poses(robust=robust)
            assert sorted(got) == sorted(want) == list(range(len(init)))
            for k in got:
                _close(got[k][0], got[k][1], want[k][0], want[k][1])
    finally:
        port.shutdown()
        ref.shutdown()


@pytest.fixture(scope="module")
def seq():
    world = SyntheticWorld(extent=60.0, n_world_points=60_000, points_per_scan=4096,
                           max_range=35.0, seed=1)
    p = world._points
    on_grid = lambda x: np.abs((x + 52.5) / 15 - np.round((x + 52.5) / 15)) * 15 < 0.1
    world._points = p[~(on_grid(p[:, 0]) & on_grid(p[:, 1]) & (p[:, 2] > 0))]
    return synthetic_sequence(kind="circle", n_scans=40, loop_side=40 / math.pi, world=world)


def _cfg(**over):
    icp = {"params": {"maxIterations": 30},
           "matchers": [{"class": "Matcher_Point2Plane_Normals",
                         "params": {"distanceThreshold": 2.0, "src_layer": "decimated",
                                    "tgt_layer": "decimated"}}],
           "solvers": [{"class": "Solver_GaussNewton", "params": {"maxIterations": 8}}],
           "quality": [{"class": "QualityEvaluator_PairedRatio",
                        "params": {"thresholdDistance": 0.3, "src_layer": "raw",
                                   "tgt_layer": "raw"}}]}
    params = {
        "precompile_rare_paths": False, "min_time_between_scans": 0.01,
        "min_dist_xyz_between_keyframes": 1.5, "min_icp_goodness": 0.2,
        # test-only: no nearby or loop-closure candidate within reach
        "min_dist_to_matching": 500.0, "max_dist_to_matching": 600.0,
        "max_dist_to_loop_closure": 600.0,
        "pointcloud_generator": [{"class": "GeneratorRawPoints", "params": {"capacity": 4096}}],
        "pointcloud_filter": [
            {"class": "FilterVoxelDownsample", "params": {"voxel_size": 0.7,
                                                          "output_capacity": 1024}},
            {"class": "FilterNormals", "params": {"input_layer": "decimated", "knn": 8}}],
        "icp_settings_with_vel": icp}
    params.update(over)
    return {"params": params}


def test_runner_pgo_rows_match_reference(seq):
    obs, gt = seq
    res = runner.run_replay(obs[:8], _cfg(), gt_poses=gt[:8], device="cpu", pgo=True,
                            pgo_robust="cauchy")
    ref = jrunner.run_replay(obs[:8], _cfg(), gt_poses=gt[:8], pgo=True, pgo_robust="cauchy")
    try:
        assert res["n_keyframes"] == ref["n_keyframes"] >= 3
        assert sorted(res["kf_poses_pgo"]) == sorted(ref["kf_poses_pgo"])
        for k, (R, t) in res["kf_poses_pgo"].items():
            _close(R, t, *ref["kf_poses_pgo"][k])
        for key in ("ate_rmse_pgo", "ate_rmse_scan_pgo"):
            assert np.isfinite(res[key]) and abs(res[key] - ref[key]) < 5e-3
    finally:
        res["module"].shutdown()
        ref["module"].shutdown()


def _feed(m, observations):
    """One scan at a time, drained: the world pose after each."""
    poses = []
    for o in observations:
        m.on_new_observation(o)
        m.drain()
        poses.append((np.array(m.state.world_R), np.array(m.state.world_t)))
    return poses


def test_reference_checkpoint_resumes_in_the_port(seq, tmp_path):
    obs, _ = seq
    first = jrunner.build_module(_cfg())
    _feed(first, obs[:5])
    jcheckpoint.save_checkpoint(first, str(tmp_path / "ckpt"))
    first.shutdown()
    ref = jrunner.build_module(_cfg())
    port = runner.build_module(_cfg(), device="cpu")
    try:
        jcheckpoint.load_checkpoint(ref, str(tmp_path / "ckpt"))
        checkpoint.load_checkpoint(port, str(tmp_path / "ckpt"))
        st, jst = port.state_copy(), ref.state_copy()
        assert st.last_kf == jst.last_kf is not None
        assert sorted(port.worldmodel.entities()) == sorted(ref.worldmodel.entities())
        for kf in port.worldmodel.entities():
            mm = port.worldmodel.annotation(kf, ANNOTATION_NAME_PC_LAYERS)
            jmm = ref.worldmodel.annotation(kf, ANNOTATION_NAME_PC_LAYERS)
            for name, pc in mm.items():
                np.testing.assert_array_equal(pc.xyz.numpy(), np.asarray(jmm[name].xyz))
        assert [(a, b) for a, b, *_ in st.edge_log] == [(a, b) for a, b, *_ in jst.edge_log]
        got, want = _feed(port, obs[5:9]), _feed(ref, obs[5:9])
        for (R, t), (jR, jt) in zip(got, want):
            assert np.linalg.norm(t - jt) < 5e-3
            dR = R.T @ jR
            assert np.arccos(np.clip((np.trace(dR) - 1) / 2, -1, 1)) < 1e-3
        st, jst = port.state_copy(), ref.state_copy()
        assert st.last_kf == jst.last_kf
        assert [(a, b) for a, b, *_ in st.edge_log] == [(a, b) for a, b, *_ in jst.edge_log]
        # and the port's own checkpoint reads back into the reference
        checkpoint.save_checkpoint(port, str(tmp_path / "port"))
        back = jrunner.build_module(_cfg())
        jcheckpoint.load_checkpoint(back, str(tmp_path / "port"))
        assert back.state.last_kf == st.last_kf
        back.shutdown()
    finally:
        port.shutdown()
        ref.shutdown()
