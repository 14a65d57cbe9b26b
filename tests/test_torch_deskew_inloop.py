"""Port parity for in-loop (two-pass) deskew: ``delta_redeskew`` against
the reference, and the scan step's align with ``deskew_in_loop`` on a
skewed scan pair -- against the previous scan, and against a map target
in the world frame, where the implied twist comes from the relative pose
``prev^-1 * world``.

Inputs, made from seeds with numpy: random clouds with sweep times for
``delta_redeskew``; for the align, a structured scene (ground, two walls,
scatter) measured by a sensor moving at 8 m/s and turning at 1 rad/s
during a 0.1 s sweep, each point in the sensor frame of its own fire time,
aligned from a zero deskew twist (the lagged twist after a corner starts).

Tolerances: ``delta_redeskew`` 1e-5 m and 1e-5 on normals and
covariances; the align 1 mm / 0.2 mrad with equal iteration counts.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mola_fe_lidar_tpu.cloud.metric_map import from_points as jfrom_points
from mola_fe_lidar_tpu.filters import pipeline as jpipe
from mola_fe_lidar_tpu.frontend.odometry import AlignKind as JAlignKind
from mola_fe_lidar_tpu.obs import runner as jrunner
from mola_fe_lidar_tpu_torch.cloud.metric_map import from_points
from mola_fe_lidar_tpu_torch.filters import pipeline
from mola_fe_lidar_tpu_torch.frontend.odometry import _pack_icp_result, _unpack_icp_result
from mola_fe_lidar_tpu_torch.geometry import se3
from mola_fe_lidar_tpu_torch.models.config import AlignKind
from mola_fe_lidar_tpu_torch.obs import runner

torch.set_num_threads(1)
PERIOD = 0.1


@pytest.mark.parametrize("to_end", [True, False], ids=["end", "start"])
def test_delta_redeskew_matches_reference(to_end):
    rng = np.random.default_rng(3)
    n = 400
    pts = (rng.standard_normal((n, 3)) * 15).astype(np.float32)
    attrs = {"time": rng.random((n, 1)).astype(np.float32),
             "normal": rng.standard_normal((n, 3)).astype(np.float32),
             "cov": rng.standard_normal((n, 9)).astype(np.float32)}
    xi0 = np.array([1.0, -0.5, 0.2, 0.05, -0.02, 0.8], np.float32)
    xi1 = np.array([3.0, 0.5, 0.0, -0.03, 0.04, -1.2], np.float32)
    pc = from_points(pts, capacity=512, attrs=attrs, device="cpu")
    out = pipeline.delta_redeskew(pc, torch.from_numpy(xi0), torch.from_numpy(xi1), PERIOD, to_end)
    ref = jpipe.delta_redeskew(jfrom_points(pts, capacity=512, attrs=attrs), xi0, xi1, PERIOD,
                               to_end)
    np.testing.assert_allclose(out.xyz.numpy(), np.asarray(ref.xyz), atol=1e-5)
    np.testing.assert_array_equal(out.mask.numpy(), np.asarray(ref.mask))
    for k in ("normal", "cov"):
        np.testing.assert_allclose(out.attrs[k].numpy(), np.asarray(ref.attrs[k]), atol=1e-5)
    np.testing.assert_array_equal(out.attrs["time"].numpy(), np.asarray(ref.attrs["time"]))
    # exact as a re-warp: deskewing the raw points with xi1 directly
    warped = pipeline._deskew(pc, torch.from_numpy(xi0), PERIOD, to_end)
    again = pipeline.delta_redeskew(warped, torch.from_numpy(xi0), torch.from_numpy(xi1),
                                    PERIOD, to_end)
    direct = pipeline._deskew(pc, torch.from_numpy(xi1), PERIOD, to_end)
    np.testing.assert_allclose(again.xyz[:n].numpy(), direct.xyz[:n].numpy(), atol=2e-4)


def _cfg():
    icp = {"params": {"maxIterations": 40},
           "matchers": [{"class": "Matcher_Point2Plane",
                         "params": {"distanceThreshold": 2.0, "knn": 6, "planeEigenThreshold": 0.2,
                                    "src_layer": "raw", "tgt_layer": "raw"}}],
           "solvers": [{"class": "Solver_GaussNewton", "params": {"maxIterations": 8}}],
           "quality": [{"class": "QualityEvaluator_PairedRatio",
                        "params": {"thresholdDistance": 0.3, "src_layer": "raw",
                                   "tgt_layer": "raw"}}]}
    return {"params": {
        "precompile_rare_paths": False,
        "pointcloud_generator": [{"class": "GeneratorRawPoints",
                                  "params": {"capacity": 2048, "keep_time": True}}],
        "pointcloud_filter": [{"class": "FilterDeskew",
                               "params": {"input_layer": "raw", "scan_period": PERIOD,
                                          "anchor": "start"}}],
        "icp_settings_with_vel": icp,
        "deskew_in_loop": True, "deskew_refine_iters": 20, "deskew_refine_rounds": 3}}


def _scene(rng, n=2048, extent=20.0):
    k = n // 4
    ground = np.stack([rng.uniform(-extent, extent, k), rng.uniform(-extent, extent, k),
                       rng.normal(0, 0.02, k)], -1)
    wall1 = np.stack([rng.uniform(-extent, extent, k),
                      np.full(k, extent) + rng.normal(0, 0.02, k), rng.uniform(0, 5, k)], -1)
    wall2 = np.stack([np.full(k, -extent) + rng.normal(0, 0.02, k),
                      rng.uniform(-extent, extent, k), rng.uniform(0, 5, k)], -1)
    scatter = rng.uniform(-extent, extent, (n - 3 * k, 3)) * np.array([1.0, 1.0, 0.1])
    return np.concatenate([ground, wall1, wall2, scatter]).astype(np.float32)


@pytest.fixture(scope="module")
def skewed_pair():
    """(scene, measured skewed scan, sweep times, true scan-start pose)."""
    rng = np.random.default_rng(7)
    world = _scene(rng)
    xi = torch.tensor([8.0, 0.0, 0.0, 0.0, 0.0, 1.0], dtype=torch.float64)
    p_start = se3.exp(xi * PERIOD)
    t_frac = rng.random(world.shape[0]).astype(np.float32)
    poses = se3.compose(se3.Pose(p_start.R[None], p_start.t[None]),
                        se3.exp(torch.from_numpy(t_frac.astype(np.float64))[:, None] * PERIOD * xi))
    inv = se3.inverse(poses)
    meas = ((inv.R @ torch.from_numpy(world).double()[..., None])[..., 0] + inv.t).numpy()
    return world, meas.astype(np.float32), t_frac, p_start


@pytest.mark.parametrize("use_map", [False, True], ids=["scan", "map"])
def test_two_pass_align_matches_reference(skewed_pair, use_map):
    world, meas, t_frac, p_start = skewed_pair
    # a map target sits in the world frame of the previous pose
    prev = se3.exp(torch.tensor([2.0, -1.0, 0.1, 0.0, 0.0, 0.4], dtype=torch.float64)) \
        if use_map else se3.Pose(torch.eye(3, dtype=torch.float64), torch.zeros(3, dtype=torch.float64))
    tgt = ((prev.R @ torch.from_numpy(world).double()[..., None])[..., 0] + prev.t).numpy()
    guess = se3.compose(prev, p_start)
    f32 = lambda x: np.asarray(x, np.float32)
    m = runner.build_module(_cfg(), device="cpu")
    jm = jrunner.build_module(_cfg())
    try:
        raw = {"raw": from_points(meas, capacity=2048, attrs={"time": t_frac[:, None]},
                                  device="cpu")}
        tgt_map = {"raw": from_points(f32(tgt), capacity=2048, device="cpu")}
        tw = torch.zeros(6)
        mm, _ = m._filter_core(raw, tw)
        _, res = m._align_core(AlignKind.LIDAR_ODOMETRY, use_map, mm, tgt_map, guess.R.numpy(),
                               guess.t.numpy(), tw, (prev.R.numpy(), prev.t.numpy()), PERIOD)
        out = _unpack_icp_result(_pack_icp_result(res).numpy())
        step = jm._get_fused_step(JAlignKind.LIDAR_ODOMETRY, use_map)
        _, flat = step({"raw": jfrom_points(meas, capacity=2048, attrs={"time": t_frac[:, None]})},
                       {"raw": jfrom_points(f32(tgt), capacity=2048)},
                       jnp.asarray(f32(guess.R)), jnp.asarray(f32(guess.t)), jnp.zeros(6),
                       jnp.asarray(f32(prev.R)), jnp.asarray(f32(prev.t)), jnp.float32(PERIOD))
        ref = _unpack_icp_result(np.asarray(flat))
    finally:
        m.shutdown()
        jm.shutdown()
    R, t = out.found_pose_to_wrt_from
    jR, jt = ref.found_pose_to_wrt_from
    dR = np.asarray(R, np.float64).T @ np.asarray(jR, np.float64)
    assert np.linalg.norm(dR - dR.T) / (2 * np.sqrt(2)) < 2e-4  # sin of the angle
    assert np.linalg.norm(np.asarray(t) - np.asarray(jt)) < 1e-3
    assert out.n_iterations == ref.n_iterations
    assert abs(out.goodness - ref.goodness) < 1e-3
    # the refinement found the true scan-start pose (0.6 degrees)
    true = se3.compose(prev, p_start)
    err = se3.log(se3.compose(se3.Pose(torch.from_numpy(np.asarray(R, np.float64)),
                                       torch.from_numpy(np.asarray(t, np.float64))),
                              se3.inverse(true)))
    assert float(torch.linalg.vector_norm(err[3:])) < 0.01
