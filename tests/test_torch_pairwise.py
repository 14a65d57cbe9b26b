"""Port parity for the pairwise-registration path: the new matchers'
pairings, one align per built-in preset (and robust-Cauchy, GICP and OLAE
stages), ``align_with_normal_precompute``, chunked batched align with Horn
lanes, the front-end's preset fallback, and a replay of the reference
runner's quickstart configuration (``DEFAULT_CFG``) through both packages.

Inputs are bench.py's synthetic scan pairs (ground and two walls of
uniform random points, built by the port's copy of ``make_pairs``) and the
synthetic circle of the runner's quickstart, made from seeds with numpy.

Tolerances: pairings agree to f32 round-off (weights exactly where no
distance sits within round-off of a threshold); align poses within 1 mm /
0.2 mrad with equal iteration counts; replayed scan poses within 5 mm /
1 mrad. The reference's CPU searches use the norm expansion and the port's
the difference form (the Pallas kernels' contract): equal distances and
near-ties may resolve differently, which the pair data makes rare.

The replay's world has no poles. A pole sampled by a 0.7 m voxel filter
gives kNN neighbourhoods that are lines (λ0 ≈ λ1 ≪ λ2), which the
reference's planar gate keeps; their normals are set by f32 round-off, and
the reference's own compiled align differs from the same align run op by
op (``jax.disable_jit``) by 7 mm on such a scan pair. The port follows the
op-by-op arithmetic (``test_line_like_neighbourhoods_follow_the_reference``)
but cannot follow XLA's fusion choices, so the poled world is compared an
iteration at a time, and the replay on the world without poles.
"""

import copy
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mola_fe_lidar_tpu.cloud.metric_map import PointCloud as JPointCloud
from mola_fe_lidar_tpu.cloud.metric_map import from_points as jfrom_points
from mola_fe_lidar_tpu.filters import pipeline as jpipe
from mola_fe_lidar_tpu.geometry import se3 as jse3
from mola_fe_lidar_tpu.models import icp as jicp
from mola_fe_lidar_tpu.models import presets as jpresets
from mola_fe_lidar_tpu.parallel import batch as jbatch
from mola_fe_lidar_tpu_torch.cloud.metric_map import from_points
from mola_fe_lidar_tpu_torch.filters import pipeline
from mola_fe_lidar_tpu_torch.geometry import se3
from mola_fe_lidar_tpu_torch.models import icp, presets
from mola_fe_lidar_tpu_torch.models.config import (ICPParams, Matcher, PairWeights, Quality,
                                                   Solver)
from mola_fe_lidar_tpu_torch.obs import runner
from mola_fe_lidar_tpu_torch.obs.scan_pairs import make_pairs, pair_clouds, pose_errors
from mola_fe_lidar_tpu_torch.parallel import batch

torch.set_num_threads(1)
N = 512


@pytest.fixture(scope="module")
def pair():
    """One bench.py scan pair of N points, source moved by exp(-tau)."""
    (src,), (tgt,), (tau,) = pair_clouds(make_pairs(np.random.default_rng(7), 1, N))
    return src, tgt, tau


def _maps(src, tgt, layer="raw"):
    return ({layer: from_points(src, capacity=N, device="cpu")},
            {layer: from_points(tgt, capacity=N, device="cpu")},
            {layer: jfrom_points(src, capacity=N)}, {layer: jfrom_points(tgt, capacity=N)})


def _pose(R=None, t=None):
    R = np.eye(3, dtype=np.float32) if R is None else np.asarray(R, np.float32)
    t = np.zeros(3, np.float32) if t is None else np.asarray(t, np.float32)
    return se3.Pose(torch.from_numpy(R), torch.from_numpy(t)), jse3.Pose(jnp.asarray(R),
                                                                         jnp.asarray(t))


def _close(res, jres, trans=1e-3, rot=2e-4, iterations=True):
    R = res.pose.R.numpy().astype(np.float64)
    dR = np.swapaxes(R, -1, -2) @ np.asarray(jres.pose.R, np.float64)
    skew = np.linalg.norm(dR - np.swapaxes(dR, -1, -2), axis=(-2, -1)) / (2 * np.sqrt(2))
    assert np.all(skew < rot)  # sin of the angle, per lane
    assert np.all(np.linalg.norm(res.pose.t.numpy() - np.asarray(jres.pose.t), axis=-1) < trans)
    if iterations:
        np.testing.assert_array_equal(res.n_iterations.numpy(), np.asarray(jres.n_iterations))
    np.testing.assert_allclose(res.quality.numpy(), np.asarray(jres.quality), atol=2.0 / N)


def _same_params(stages, jstages):
    assert [dataclasses.asdict(s) for s in stages] == [dataclasses.asdict(s) for s in jstages]


def _with(attach, jattach, maps):
    s, t, js, jt = maps
    return ({"raw": attach(s["raw"])}, {"raw": attach(t["raw"])},
            {"raw": jattach(js["raw"])}, {"raw": jattach(jt["raw"])})


NORMALS = (lambda pc: pipeline._attach_normals_knn(pc.xyz, pc.mask, 8),
           lambda pc: jpipe._attach_normals_knn(pc.xyz, pc.mask, 8))
GICP_COVS = (lambda pc: pipeline._attach_gicp_covs(pc.xyz, pc.mask, 10, 1e-3),
             lambda pc: jpipe._attach_gicp_covs(pc.xyz, pc.mask, 10, 1e-3))


@pytest.mark.parametrize("kind, cand_k", [("point2point", 0), ("point2point", 4),
                                          ("point2plane_knn", 0), ("point2plane_knn", 9),
                                          ("gicp", 0)])
def test_matcher_pairings(pair, kind, cand_k):
    src, tgt, tau = pair
    maps = _maps(src, tgt)
    if kind == "gicp":
        maps = _with(*GICP_COVS, maps)
    s, t, js, jt = maps
    m = Matcher(kind=kind, distance_threshold=1.0, knn=6, plane_eigen_threshold=0.2,
                cand_k=cand_k)
    params = ICPParams(matchers=(m,), solver=Solver(kind="horn" if kind == "point2point"
                                                    else "gauss_newton"),
                       weights=PairWeights(use_scale_outlier_detector=True))
    # a pose near the solution: the candidates come from the truth, the
    # pairings are taken 5 cm / 10 mrad off it
    near = se3.compose(se3.exp(torch.tensor([0.05, 0.0, 0.0, 0.0, 0.0, 0.01])),
                       se3.exp(torch.from_numpy(tau)))
    pose, jpose = _pose(near.R, near.t)
    truth, _ = _pose(*(x.numpy() for x in se3.exp(torch.from_numpy(tau))))
    cands = jcands = None
    if cand_k:
        cands = (icp._refresh_cands(m, truth, s["raw"], t["raw"]),)
        jcands = (jnp.asarray(cands[0].numpy()),)
    it = torch.zeros((), dtype=torch.int32)
    plane, p2p = icp._gather(pose, it, s, t, params, cands)
    jplane, jp2p = jax.jit(lambda pose_, cands_: jicp._gather(
        pose_, jnp.zeros((), jnp.int32), js, jt, params, cands=cands_))(jpose, jcands)
    assert len(p2p) == len(jp2p) == (kind == "point2point")
    w, jw = plane.w.numpy(), np.asarray(jplane.w)
    np.testing.assert_array_equal(w > 0, jw > 0)
    assert (w > 0).mean() > 0.3
    ok = w > 0
    np.testing.assert_allclose(w[ok], jw[ok], rtol=1e-5)
    np.testing.assert_allclose(plane.q.numpy()[ok], np.asarray(jplane.q)[ok], atol=1e-5)
    # GICP's rows of M⁻¹ reach 1/√ε: relative round-off of the Cholesky
    np.testing.assert_allclose(np.abs(plane.n.numpy()[ok]), np.abs(np.asarray(jplane.n)[ok]),
                               rtol=1e-3, atol=1e-4)
    # one solver step from these pairings
    new = icp._solve(pose, plane, p2p, params, pose, None)
    jnew = jicp._solve(jpose, jplane, jp2p, params, jpose)
    np.testing.assert_allclose(new.t.numpy(), np.asarray(jnew.t), atol=1e-5)
    np.testing.assert_allclose(new.R.numpy(), np.asarray(jnew.R), atol=1e-5)


ROBUST = ICPParams(
    max_iterations=40,
    matchers=(Matcher(kind="point2plane_knn", distance_threshold=1.0, knn=6,
                      plane_eigen_threshold=0.2),),
    solver=Solver(kind="gauss_newton", max_iterations=10),
    quality=(Quality(threshold_distance=0.3),),
    weights=PairWeights(use_scale_outlier_detector=False, use_robust_kernel=True,
                        robust_kernel="cauchy", robust_kernel_param=0.2))
GICP = ICPParams(max_iterations=20, matchers=(Matcher(kind="gicp", distance_threshold=1.0),),
                 solver=Solver(kind="gauss_newton", max_iterations=5),
                 weights=PairWeights(use_scale_outlier_detector=False))
OLAE = ICPParams(max_iterations=30,
                 matchers=(Matcher(kind="point2point", distance_threshold=2.0),),
                 solver=Solver(kind="olae"), weights=PairWeights(use_scale_outlier_detector=False))


@pytest.mark.parametrize("name", ["icp_settings_regular", "icp_coarse_to_fine",
                                  "icp_pyramid_3level", "robust_cauchy", "gicp", "olae"])
def test_align_per_preset(pair, name):
    src, tgt, tau = pair
    maps = _maps(src, tgt)
    if name in ("icp_settings_regular",):
        stages = (presets.icp_settings_regular(),)
        _same_params(stages, (jpresets.icp_settings_regular(),))
    elif name in ("icp_coarse_to_fine", "icp_pyramid_3level"):
        stages = getattr(presets, name)()
        _same_params(stages, getattr(jpresets, name)())
        maps = _with(*NORMALS, maps)
    else:
        stages = ({"robust_cauchy": ROBUST, "gicp": GICP, "olae": OLAE}[name],)
        if name == "gicp":
            maps = _with(*GICP_COVS, maps)
    s, t, js, jt = maps
    pose, jpose = _pose()
    res = icp.align_pipeline(s, t, pose, stages)
    jres = jicp.align_pipeline(js, jt, jpose, stages)
    _close(res, jres)
    if name != "olae":  # a 2 m point-to-point OLAE stage stops short in both packages
        assert pose_errors(se3.Pose(res.pose.R[None], res.pose.t[None]), [tau])[0] < 0.05
    # the pairs are noise-free, so the residual variance is round-off; the
    # shape of the covariance (the normal matrix's inverse) is compared
    cov, jcov = res.cov.numpy(), np.asarray(jres.cov)
    cov, jcov = cov / np.trace(cov), jcov / np.trace(jcov)
    np.testing.assert_allclose(cov, jcov, rtol=5e-2, atol=5e-2 * np.abs(jcov).max())


def test_align_with_normal_precompute(pair):
    src, tgt, _ = pair
    s, t, js, jt = _maps(src, tgt)
    params = presets.icp_coarse_to_fine()[1]
    pose, jpose = _pose(*(x.numpy() for x in se3.exp(torch.tensor(
        [0.2, -0.1, 0.0, 0.0, 0.0, 0.05]))))
    res = icp.align_with_normal_precompute(s, t, pose, params)
    jres = jicp.align_with_normal_precompute(js, jt, jpose, params)
    _close(res, jres)


def test_chunked_batched_horn_lanes(pair):
    """Four pairs, Horn lanes in chunks of two: each lane is the reference's
    vmapped lane and the port's own unbatched align (frozen lanes keep
    their pose and count)."""
    pairs = make_pairs(np.random.default_rng(3), 4, 512, tau_sigma=0.1)
    srcs, tgts, _ = pair_clouds(pairs)
    params = ICPParams(max_iterations=12,
                       matchers=(Matcher(kind="point2point", distance_threshold=2.0),),
                       solver=Solver(kind="horn"),
                       weights=PairWeights(use_scale_outlier_detector=False))
    stack = lambda clouds, f, st: {"raw": type(f(clouds[0], capacity=512))(
        *(st([getattr(f(c, capacity=512), k) for c in clouds]) for k in ("xyz", "mask")), {})}
    tf = lambda c, capacity: from_points(c, capacity=capacity, device="cpu")
    s, t = stack(srcs, tf, torch.stack), stack(tgts, tf, torch.stack)
    js, jt = stack(srcs, jfrom_points, jnp.stack), stack(tgts, jfrom_points, jnp.stack)
    eye = se3.Pose(torch.eye(3).expand(4, 3, 3), torch.zeros(4, 3))
    res = batch.make_chunked_batched_align(params, chunk=2)(s, t, eye)
    jres = jbatch.make_chunked_batched_align(params, chunk=2)(
        js, jt, jse3.Pose(jnp.broadcast_to(jnp.eye(3), (4, 3, 3)), jnp.zeros((4, 3))))
    _close(res, jres)
    assert len(set(res.n_iterations.tolist())) > 1  # lanes stop at their own counts
    for b in range(4):
        one = icp.align({"raw": type(s["raw"])(s["raw"].xyz[b], s["raw"].mask[b], {})},
                        {"raw": type(t["raw"])(t["raw"].xyz[b], t["raw"].mask[b], {})},
                        se3.Pose(torch.eye(3), torch.zeros(3)), params)
        np.testing.assert_allclose(one.pose.t.numpy(), res.pose.t[b].numpy(), atol=1e-6)
        assert int(one.n_iterations) == int(res.n_iterations[b])


def test_front_end_falls_back_to_the_kitti_presets():
    from mola_fe_lidar_tpu.frontend.odometry import LidarOdometry as JLidarOdometry

    cfg = runner.default_config()
    del cfg["params"]["icp_settings_with_vel"]
    cfg["params"]["pointcloud_filter"] = [
        {"class": "FilterBoundingBox", "params": {"min_corner": [-40, -40, -5],
                                                  "max_corner": [40, 40, 10]}},
        {"class": "FilterVoxelDownsample", "params": {"voxel_size": 0.7}},
        {"class": "FilterNormals", "params": {"input_layer": "decimated"}},
        {"class": "FilterGICPCovariances", "params": {"input_layer": "decimated"}},
    ]
    cfg["params"]["decimate_to_point_count"] = 4096
    module = runner.build_module(cfg, device="cpu")
    ref = JLidarOdometry()
    ref.initialize(copy.deepcopy(cfg))
    try:
        assert ({k.value: [dataclasses.asdict(s) for s in v] for k, v in module.icp_cases.items()}
                == {k.value: [dataclasses.asdict(s) for s in v] for k, v in ref.icp_cases.items()})
        assert [type(f).__name__ for f in module.filter_pipeline.filters] == [
            type(f).__name__ for f in ref.filter_pipeline.filters]
        assert type(module.filter_pipeline.filters[0]).__name__ == "FilterDecimateToCount"
    finally:
        module.shutdown()
        ref.shutdown()


def _poled_pair():
    """Two filtered quickstart scans (2048 points, with poles)."""
    from mola_fe_lidar_tpu_torch.cloud.metric_map import to_numpy_layers
    from mola_fe_lidar_tpu_torch.filters.generators import apply_generators
    from mola_fe_lidar_tpu_torch.obs.synthetic import SyntheticWorld, synthetic_sequence

    world = SyntheticWorld(extent=60.0, n_world_points=60_000, points_per_scan=4096,
                           max_range=35.0, seed=1)
    obs, _ = synthetic_sequence(kind="straight", n_scans=2, world=world)
    module = runner.build_module(runner.default_config(REPLAY_CAPACITY), device="cpu")
    try:
        return [to_numpy_layers(module._filter_core(apply_generators(module.generators, o),
                                                    torch.zeros(6))[0]) for o in obs]
    finally:
        module.shutdown()


def test_line_like_neighbourhoods_follow_the_reference():
    """kNN = 6 point-to-plane on a scan pair with poles, one iteration from
    the same pose: pairings, normals included, and the step agree with the
    reference's matcher and solver run op by op to f32 round-off."""
    from mola_fe_lidar_tpu_torch.cloud.metric_map import from_numpy_layers
    from mola_fe_lidar_tpu_torch.frontend.icp_config import icp_stages_from_config

    tgt, src = _poled_pair()
    stage = icp_stages_from_config(runner.DEFAULT_CFG["params"]["icp_settings_with_vel"])[1]
    s, t = from_numpy_layers(src, "cpu"), from_numpy_layers(tgt, "cpu")
    jmap = lambda layers: {n: JPointCloud(jnp.asarray(e["xyz"]), jnp.asarray(e["mask"]), {})
                           for n, e in layers.items()}
    js, jt = jmap(src), jmap(tgt)
    pose, jpose = _pose()
    plane, p2p = icp._gather(pose, torch.zeros((), dtype=torch.int32), s, t, stage)
    jplane, jp2p = jicp._gather(jpose, jnp.zeros((), jnp.int32), js, jt, stage)
    np.testing.assert_array_equal(plane.w.numpy(), np.asarray(jplane.w))
    ok = plane.w.numpy() > 0
    np.testing.assert_allclose(np.abs(plane.n.numpy()[ok]), np.abs(np.asarray(jplane.n)[ok]),
                               atol=1e-3)
    new = icp._solve(pose, plane, p2p, stage, pose, None)
    jnew = jicp._solve(jpose, jplane, jp2p, stage, jpose)
    np.testing.assert_allclose(new.t.numpy(), np.asarray(jnew.t), atol=1e-5)
    np.testing.assert_allclose(new.R.numpy(), np.asarray(jnew.R), atol=1e-5)


REPLAY_SCANS = 5
REPLAY_CAPACITY = ("pointcloud_generator.0.params.capacity=2048",
                   "pointcloud_filter.0.params.output_capacity=2048",
                   "precompile_rare_paths=false")


def test_default_cfg_replay_matches_reference():
    """The quickstart (synthetic circle of 40 scans, 1 m and 9 degrees a
    scan), its first scans at 2048 points, in a world without poles."""
    from concurrent.futures import ThreadPoolExecutor

    from mola_fe_lidar_tpu.obs import runner as jrunner
    from mola_fe_lidar_tpu_torch.obs.synthetic import SyntheticWorld, synthetic_sequence

    world = SyntheticWorld(extent=60.0, n_world_points=60_000, points_per_scan=4096,
                           max_range=35.0, seed=1)
    p = world._points
    pole = ((np.abs((p[:, 0] + 52.5) / 15 - np.round((p[:, 0] + 52.5) / 15)) * 15 < 0.1)
            & (np.abs((p[:, 1] + 52.5) / 15 - np.round((p[:, 1] + 52.5) / 15)) * 15 < 0.1)
            & (p[:, 2] > 0))
    world._points = p[~pole]
    obs, gt = synthetic_sequence(kind="circle", n_scans=40, loop_side=40 / math.pi, world=world)
    obs, gt = obs[:REPLAY_SCANS], gt[:REPLAY_SCANS]
    cfg = runner.default_config(REPLAY_CAPACITY)
    jcfg = copy.deepcopy(jrunner.DEFAULT_CFG)
    runner._apply_overrides(jcfg["params"], REPLAY_CAPACITY)
    assert cfg == jcfg
    with ThreadPoolExecutor(1) as pool:
        ref_future = pool.submit(jrunner.run_replay, obs, jcfg, gt)
        res = runner.run_replay(obs, cfg, gt_poses=gt, device="cpu")
        ref = ref_future.result()
    try:
        assert res["jobs_abandoned"] == 0 and ref["jobs_abandoned"] == 0
        assert res["n_keyframes"] == ref["n_keyframes"] >= 2
        assert res["n_factors"] == ref["n_factors"]
        assert len(res["scan_poses"]) == len(ref["scan_poses"]) == REPLAY_SCANS
        for (ts, (R, t)), (tsj, (Rj, tj)) in zip(res["scan_poses"], ref["scan_poses"]):
            assert ts == tsj
            assert np.linalg.norm(t - tj) < 5e-3
            dR = R.T @ Rj
            assert np.linalg.norm(dR - dR.T) / (2 * np.sqrt(2)) < 1e-3
        assert abs(res["ate_rmse_scan"] - ref["ate_rmse_scan"]) < 5e-3
    finally:
        res["module"].shutdown()
        ref["module"].shutdown()
