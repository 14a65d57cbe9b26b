"""Port parity: ICP (mola_fe_lidar_tpu_torch.models.icp) against the JAX
reference on the same filtered HDL-64 layers, with the main path's stage
parameters: the scan-to-scan stages and the scan-to-map stages (candidate
cache, tight match distance, 15-iteration cap, quality subsample).

Tolerances: both sides run the same f32 algorithm; sums over thousands of
pairings are taken in another order, so poses agree to ~1e-5 m and a
pairing can flip where a distance sits within round-off of a threshold.
Bounds: 1 mm / 0.2 mrad on the pose, equal iteration counts, quality
within 2 pairings of the quality subsample, covariance within 5 %.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mola_fe_lidar_tpu.cloud.metric_map import PointCloud as JPointCloud
from mola_fe_lidar_tpu.geometry import se3 as jse3
from mola_fe_lidar_tpu.models import config as jconfig
from mola_fe_lidar_tpu.models import icp as jicp
from mola_fe_lidar_tpu.models.config import AlignKind as JAlignKind
from mola_fe_lidar_tpu.obs.hdl64 import hdl64_sequence
from mola_fe_lidar_tpu.frontend.odometry import LidarOdometry as JLidarOdometry
from mola_fe_lidar_tpu_torch.cloud.metric_map import PointCloud, from_numpy_layers, to_numpy_layers
from mola_fe_lidar_tpu_torch.filters.generators import apply_generators
from mola_fe_lidar_tpu_torch.geometry import se3
from mola_fe_lidar_tpu_torch.models import config, icp
from mola_fe_lidar_tpu_torch.models.config import AlignKind
from mola_fe_lidar_tpu_torch.obs.runner import build_module, realtime_config

torch.set_num_threads(1)
AZIMUTH = 512


@pytest.fixture(scope="module")
def setup():
    """Filtered layers of scans 0 and 2 (numpy, from the port's filter
    chain, which tests/test_torch_filters.py holds to the reference's) and
    both modules' stage parameters."""
    cfg = realtime_config(scale=AZIMUTH / 2048)
    port = build_module(cfg, device="cpu")
    ref = JLidarOdometry()
    ref.initialize(cfg)
    obs, gt = hdl64_sequence(n_scans=3, n_azimuth=AZIMUTH)
    layers = []
    for o in (obs[0], obs[2]):
        mm = port._filter_core(apply_generators(port.generators, o), torch.zeros(6))[0]
        layers.append({name: e for name, e in to_numpy_layers(mm).items() if name != "raw"})
    # ground-truth relative motion 0 -> 2 as the guess, perturbed
    (R0, p0), (R2, p2) = gt[0], gt[2]
    rel_R = R0.T @ R2
    rel_t = R0.T @ (p2 - p0) + np.array([0.15, -0.1, 0.02])
    yield port, ref, layers, (rel_R.astype(np.float32), rel_t.astype(np.float32))
    port.shutdown()
    ref.shutdown()


def _jmap(layers):
    return {n: JPointCloud(jnp.asarray(e["xyz"]), jnp.asarray(e["mask"]),
                           {k: jnp.asarray(v) for k, v in e["attrs"].items()})
            for n, e in layers.items()}


def _with_backend(stages, backend):
    return tuple(dataclasses.replace(s, matchers=tuple(
        dataclasses.replace(m, nn_backend=backend) for m in s.matchers)) for s in stages)


@pytest.mark.parametrize("for_map, backend", [(False, ""), (True, ""), (True, "grid")],
                         ids=["scan_stages", "map_stages", "map_stages_grid"])
def test_align_pipeline_matches_reference(setup, for_map, backend):
    """``map_stages_grid``: the map stages with ``nn_backend="grid"``, as
    ``local_map_nn_backend: grid`` sets them: the candidate cache serves
    the point-to-plane matcher's loop and the grid its final system."""
    port, ref, (tgt, src), (gR, gt_) = setup
    stages = port._stages_for(AlignKind.LIDAR_ODOMETRY, for_map)
    jstages = ref._stages_for(JAlignKind.LIDAR_ODOMETRY, for_map)
    if backend:
        stages, jstages = _with_backend(stages, backend), _with_backend(jstages, backend)
    assert [dataclasses.asdict(s) for s in stages] == [dataclasses.asdict(s) for s in jstages]
    res = icp.align_pipeline(from_numpy_layers(src, "cpu"), from_numpy_layers(tgt, "cpu"),
                             se3.Pose(torch.from_numpy(gR), torch.from_numpy(gt_)), stages)
    jres = jicp.align_pipeline(_jmap(src), _jmap(tgt),
                               jse3.Pose(jnp.asarray(gR), jnp.asarray(gt_)), jstages)
    dR = res.pose.R.numpy().astype(np.float64).T @ np.asarray(jres.pose.R, np.float64)
    ang = np.arccos(np.clip((np.trace(dR) - 1) / 2, -1, 1))
    assert np.linalg.norm(res.pose.t.numpy() - np.asarray(jres.pose.t)) < 1e-3
    assert ang < 2e-4
    assert int(res.n_iterations) == int(jres.n_iterations)
    assert int(res.term_reason) == int(jres.term_reason)
    n_q = min(s.quality[0].max_points or 10**9 for s in stages[-1:])
    n_q = min(n_q, int(src["decimated"]["mask"].sum()))
    assert abs(float(res.quality) - float(jres.quality)) <= 2.0 / n_q
    np.testing.assert_allclose(res.cov.numpy(), np.asarray(jres.cov), rtol=5e-2,
                               atol=5e-2 * np.abs(np.asarray(jres.cov)).max())


def test_unported_stage_settings_raise(setup):
    port = setup[0]
    stage = port._stages_for(AlignKind.LIDAR_ODOMETRY, False)[0]

    def backend(name):
        return dataclasses.replace(stage, matchers=(dataclasses.replace(
            stage.matchers[0], nn_backend=name),))

    # every stage setting is ported: the voxel-hash grid is accepted, an
    # unknown backend is refused as in the reference
    icp.check_params(backend("grid"))
    with pytest.raises(ValueError, match="unknown nn_backend"):
        icp.check_params(backend("kdtree"))
    # ported since: tensor parallelism (its target must be split over the
    # mesh: parallel.make_sharded_align), Anderson acceleration, the
    # motion-conditional candidate refresh, point-to-point matching with
    # the closed-form solvers; like the reference, those solvers need a
    # point-to-point matcher
    tp_stage = dataclasses.replace(stage, shard_axis="model")
    icp.check_params(tp_stage)
    whole = PointCloud(torch.zeros(8, 3), torch.ones(8), {})
    layers = {m.tgt_layer for m in stage.matchers} | {q.tgt_layer for q in stage.quality}
    with pytest.raises(ValueError, match="split over the mesh"):
        icp._check_sharding(tp_stage, {name: whole for name in layers})
    icp.check_params(dataclasses.replace(stage, anderson_m=3))
    icp.check_params(dataclasses.replace(stage, cand_refresh_min_trans=0.05))
    p2p = dataclasses.replace(stage.matchers[0], kind="point2point")
    for kind in ("horn", "olae"):
        solver = dataclasses.replace(stage.solver, kind=kind)
        icp.check_params(dataclasses.replace(stage, solver=solver, matchers=(p2p,)))
        with pytest.raises(ValueError):
            icp.check_params(dataclasses.replace(stage, solver=solver))


@pytest.mark.parametrize("lanes", [0, 2], ids=["unbatched", "lanes"])
def test_motion_conditional_refresh_matches_reference(setup, lanes, monkeypatch):
    """``cand_refresh_min_*`` (the reference's ``body_cands_cond``,
    mirroring ``tests/test_icp.py``'s case): point-to-point Horn from the
    decimated layer to the planes layer with top-4 candidates. The port's
    conditional run gives the reference's conditional pose (1 mm / 0.2
    mrad, equal iterations), unbatched (the refresh skipped for real) and
    with lanes (both branches, selected per lane), and from the first start
    it agrees with the fixed cadence within the reference test's tolerance
    (1e-4 m / 1e-5 on R)."""
    _, _, (tgt, src), (gR, gt_) = setup
    # 512 decimated points against the planes layer: the reference's eager
    # align takes seconds a call on the CPU
    src = {"decimated": {"xyz": src["decimated"]["xyz"][:512],
                         "mask": src["decimated"]["mask"][:512], "attrs": {}}}
    mk = dict(kind="point2point", src_layer="decimated", tgt_layer="planes",
              distance_threshold=2.0, cand_k=4)
    params = {}
    for name, c in (("port", config), ("ref", jconfig)):
        fixed = c.ICPParams(
            max_iterations=60, cand_refresh=4, matchers=(c.Matcher(**mk),),
            solver=c.Solver(kind="horn"), weights=c.PairWeights(use_scale_outlier_detector=False),
            quality=(c.Quality(src_layer="decimated", tgt_layer="planes"),))
        # thresholds at which this run's last block head has not moved
        params[name] = (fixed, dataclasses.replace(fixed, cand_refresh_min_trans=0.05,
                                                   cand_refresh_min_rot=0.002))
    inits_t = np.stack([gt_, gt_ + np.array([0.3, -0.2, 0.0], np.float32)])[:max(lanes, 1)]
    inits_R = np.stack([gR] * len(inits_t))
    psrc, ptgt = from_numpy_layers(src, "cpu"), from_numpy_layers(tgt, "cpu")
    pose = (se3.Pose(torch.from_numpy(inits_R), torch.from_numpy(inits_t)) if lanes
            else se3.Pose(torch.from_numpy(gR), torch.from_numpy(gt_)))
    refreshes = []
    with monkeypatch.context() as mp:
        count = icp._refresh_cands
        mp.setattr(icp, "_refresh_cands", lambda *a: refreshes.append(1) or count(*a))
        fixed = icp.align(psrc, ptgt, pose, params["port"][0])
        n_fixed = len(refreshes)
        cond = icp.align(psrc, ptgt, pose, params["port"][1])
    # unbatched, a block head without motion skips the refresh
    assert (len(refreshes) - n_fixed < n_fixed) == (not lanes)
    for b in range(max(lanes, 1)):
        # the reference's vmap runs each lane's conditional as the
        # unbatched align does (lax.cond lowered to a select per lane)
        jres = jicp.align(_jmap(src), _jmap(tgt), jse3.Pose(jnp.asarray(gR), jnp.asarray(inits_t[b])),
                          params["ref"][1])
        at = (b,) if lanes else ()
        R, t = cond.pose.R.numpy()[at], cond.pose.t.numpy()[at]
        jR, jt = np.asarray(jres.pose.R), np.asarray(jres.pose.t)
        dR = R.astype(np.float64).T @ jR.astype(np.float64)
        assert np.linalg.norm(t - jt) < 1e-3
        assert 0.5 * np.linalg.norm([dR[2, 1] - dR[1, 2], dR[0, 2] - dR[2, 0],
                                     dR[1, 0] - dR[0, 1]]) < 2e-4
        assert int(cond.n_iterations.numpy()[at]) == int(jres.n_iterations)
        if b == 0:  # from the second lane's start the skipped refresh moves
            # both packages' answer by ~1 mm: no longer the fixed cadence's
            np.testing.assert_allclose(t, fixed.pose.t.numpy()[at], atol=1e-4)
            np.testing.assert_allclose(R, fixed.pose.R.numpy()[at], atol=1e-5)
