"""Port parity: the map localizer (``mola_fe_lidar_tpu_torch.frontend.
localizer``) against the JAX package's, on the same numpy inputs.

Scenes: a synthetic world (``obs/synthetic.py``) seen from three keyframe
poses with an ``edges`` layer, for the map build and the ungated query;
the reference tests' periodic grid of identical L-shaped clusters (the
aliasing worst case, ``tests/test_localizer.py``) for the gate, where the
base query snaps to the wrong tile and the probes find the identical
rivals: a clear-cut verdict, far from the thresholds; and the reference
tests' 12-scan straight mapping run, replayed through the port's
front-end, its keyframes built into a map, and a new scan localized in
it with two starts and with four (a unique scene: the gate accepts). The
mapping run is checked against the sequence's ground truth, not against
the JAX package: the JAX twins of its two cases take minutes each on the
CPU and are marked ``slow``.

Tolerances: the map build and the probe starts are numpy in both packages
and must be equal to the last bit. Aligns run the same f32 algorithm with
sums in another order: 1 mm / 0.2 mrad on poses, equal iteration counts,
equal verdicts and probe counts. At most one JAX probe batch runs (a
module fixture): it costs ~50 s of compile on the CPU.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mola_fe_lidar_tpu.cloud import metric_map as jmetric_map
from mola_fe_lidar_tpu.frontend import localizer as jlocalizer
from mola_fe_lidar_tpu.frontend.worldmodel import WorldModel as JWorldModel
from mola_fe_lidar_tpu.geometry import se3 as jse3
from mola_fe_lidar_tpu.obs.synthetic import SyntheticWorld
from mola_fe_lidar_tpu_torch.cloud import metric_map
from mola_fe_lidar_tpu_torch.frontend import localizer
from mola_fe_lidar_tpu_torch.frontend.worldmodel import ANNOTATION_NAME_PC_LAYERS, WorldModel
from mola_fe_lidar_tpu_torch.geometry import se3
from mola_fe_lidar_tpu_torch.obs import runner, synthetic
from tests.test_frontend import odom_test_cfg

torch.set_num_threads(1)


def _yaw(a):
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])


def _grid_map(period=10.0, n=5):
    """Identical L-shaped clusters on an n x n grid (a copy of
    ``tests/test_localizer.py``'s)."""
    rng = np.random.default_rng(3)
    cluster = np.concatenate([
        np.stack([np.linspace(0, 3, 40), np.zeros(40), rng.uniform(0, 2, 40)], -1),
        np.stack([np.zeros(40), np.linspace(0, 3, 40), rng.uniform(0, 2, 40)], -1),
    ]).astype(np.float32)
    tiles = [cluster + np.array([i, j, 0]) * period for i in range(n) for j in range(n)]
    return np.concatenate(tiles).astype(np.float32), cluster


@pytest.fixture(scope="module")
def world():
    """Three keyframes of a synthetic world (raw cloud + every 9th point
    as ``edges``) at poses along x with some yaw, and a query between the
    first two."""
    w = SyntheticWorld(extent=60.0, n_world_points=30_000, points_per_scan=1024,
                       max_range=35.0, seed=6)
    kfs = []
    for i, (x, yaw) in enumerate(((0.0, 0.0), (3.0, 0.05), (6.0, -0.04))):
        R, t = _yaw(yaw), np.array([x, 0.5 * i, 0.0])
        pts = w.scan_at(R, t)
        kfs.append((pts, pts[::9], (R, t)))
    Rq, tq = _yaw(0.02), np.array([1.6, 0.4, 0.0])
    return kfs, w.scan_at(Rq, tq), (Rq, tq)


def _maps(pts, edges):
    """The same keyframe cloud in both packages."""
    j = {"raw": jmetric_map.from_points(pts, capacity=1024),
         "edges": jmetric_map.from_points(edges, capacity=256)}
    p = {"raw": metric_map.from_points(pts, capacity=1024, device="cpu"),
         "edges": metric_map.from_points(edges, capacity=256, device="cpu")}
    return j, p


def _pose_close(R, t, jR, jt):
    """1 mm / 0.2 mrad. The angle is read from the skew part of the
    relative rotation (linear in it), not from its trace: the arccos of a
    trace of f32 matrices is noise at ~3e-4 rad."""
    dR = np.asarray(R, np.float64).T @ np.asarray(jR, np.float64)
    ang = 0.5 * np.linalg.norm([dR[2, 1] - dR[1, 2], dR[0, 2] - dR[2, 0], dR[1, 0] - dR[0, 1]])
    assert np.linalg.norm(np.asarray(t) - np.asarray(jt)) < 1e-3
    assert ang < 2e-4


@pytest.mark.parametrize("capacity", [1024, 4096], ids=["subsampled", "padded"])
def test_build_matches_reference(world, capacity):
    """The same map points in the same order (the hash subsample past
    capacity included), and the same ``map_edges`` layer, from (cloud,
    pose) pairs and from a WorldModel."""
    kfs = world[0]
    jloc = jlocalizer.MapLocalizer(map_capacity=capacity, voxel_size=0.5)
    ploc = localizer.MapLocalizer(map_capacity=capacity, voxel_size=0.5, device="cpu")
    jwm, pwm = JWorldModel(), WorldModel(device="cpu")
    jitems, pitems, poses = [], [], {}
    for i, (pts, edges, pose) in enumerate(kfs):
        j, p = _maps(pts, edges)
        jitems.append((j, pose))
        pitems.append((p, pose))
        for wm, mm in ((jwm, j), (pwm, p)):
            wm.add_entity(i)
            wm.annotate(i, ANNOTATION_NAME_PC_LAYERS, mm)
        poses[i] = pose
    for build in ("build", "build_from_worldmodel"):
        if build == "build":
            jloc.build(jitems)
            ploc.build(pitems)
        else:
            jloc.build_from_worldmodel(jwm, poses)
            ploc.build_from_worldmodel(pwm, poses)
        assert sorted(ploc._map) == sorted(jloc._map) == ["map", "map_edges"]
        for name, pc in ploc._map.items():
            np.testing.assert_array_equal(pc.xyz.numpy(), np.asarray(jloc._map[name].xyz))
            np.testing.assert_array_equal(pc.mask.numpy(), np.asarray(jloc._map[name].mask))
        np.testing.assert_array_equal(metric_map.to_numpy(ploc.map_cloud),
                                      jmetric_map.to_numpy(jloc.map_cloud))
    n = int(ploc.map_cloud.count())
    assert n == capacity if capacity == 1024 else 1024 < n < capacity


def test_probe_starts_are_the_references_bits(rng):
    """The star, the yaw probes and the Gaussian tail (14 starts)."""
    kw = dict(multi_start=14, start_sigma_xyz=1.7, start_sigma_rot=0.07, yaw_probe=1.2)
    Rb = (_yaw(0.3) @ np.array([[1, 0, 0], [0, 0.9998, -0.02], [0, 0.02, 0.9998]])
          ).astype(np.float32)
    tb = rng.normal(0, 10, 3).astype(np.float32)
    for seed in (0, 5):
        want = jlocalizer.MapLocalizer(**kw)._probe_starts(Rb, tb, 13, seed)
        got = localizer.MapLocalizer(**kw, device="cpu")._probe_starts(Rb, tb, 13, seed)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


def test_localize_raw_matches_reference(world):
    """The ungated query with the edges quality term (both sides carry
    ``edges``) from a perturbed init."""
    kfs, scan, (Rq, tq) = world
    jloc = jlocalizer.MapLocalizer(map_capacity=4096, voxel_size=0.5)
    ploc = localizer.MapLocalizer(map_capacity=4096, voxel_size=0.5, device="cpu")
    items = [(_maps(p, e), pose) for p, e, pose in kfs]
    jloc.build([(j, pose) for (j, _), pose in items])
    ploc.build([(p, pose) for (_, p), pose in items])
    jscan, pscan = _maps(scan, scan[::9])
    R0 = (_yaw(0.03) @ Rq).astype(np.float32)
    t0 = (tq + np.array([0.4, -0.3, 0.05])).astype(np.float32)
    jres = jloc.localize_raw(jscan, jse3.Pose(jnp.asarray(R0), jnp.asarray(t0)))
    res = ploc.localize_raw(pscan, se3.Pose(torch.from_numpy(R0), torch.from_numpy(t0)))
    _pose_close(res.pose.R.numpy(), res.pose.t.numpy(), jres.pose.R, jres.pose.t)
    assert int(res.n_iterations) == int(jres.n_iterations)
    assert abs(float(res.quality) - float(jres.quality)) < 1e-3
    assert np.linalg.norm(res.pose.t.numpy() - tq) < 0.1  # and it converged


@pytest.fixture(scope="module")
def grid():
    """The grid map in both packages, the cluster as the scan, and one
    gated localize of each from near the neighbouring tile (the JAX
    package's probe batch runs once, here)."""
    pts, cluster = _grid_map()
    kw = dict(map_capacity=1 << 13, voxel_size=0.25, multi_start=8, start_sigma_xyz=4.0)
    jloc = jlocalizer.MapLocalizer(**kw)
    ploc = localizer.MapLocalizer(**kw, device="cpu")
    jloc.build([({"raw": jmetric_map.from_points(pts, capacity=1 << 13)}, (np.eye(3), np.zeros(3)))])
    ploc.build([({"raw": metric_map.from_points(pts, capacity=1 << 13, device="cpu")},
                 (np.eye(3), np.zeros(3)))])
    jscan = {"raw": jmetric_map.from_points(cluster, capacity=256)}
    pscan = {"raw": metric_map.from_points(cluster, capacity=256, device="cpu")}
    init = np.array([10.3, 0.2, 0.0], np.float32)
    jout = jloc.localize(jscan, jse3.Pose(jnp.eye(3), jnp.asarray(init)))
    out = ploc.localize(pscan, se3.Pose(torch.eye(3), torch.from_numpy(init)))
    return jloc, ploc, jscan, pscan, jout, out


def _same_verdict(out, jout):
    _pose_close(out.pose.R, out.pose.t, jout.pose.R, jout.pose.t)
    assert (out.accepted, out.reject_reason, out.n_agree, out.n_compete, out.n_starts,
            out.n_iterations, out.term_reason) == (
        jout.accepted, jout.reject_reason, jout.n_agree, jout.n_compete, jout.n_starts,
        jout.n_iterations, jout.term_reason)
    assert abs(out.quality - float(jout.quality)) < 1e-3
    assert abs(out.correction_m - jout.correction_m) < 1e-3


def test_gated_localize_matches_reference(grid):
    """The aliased scene: the base query snaps to the wrong identical tile
    and the probe batch flags it. Same verdict, counts and base pose."""
    *_, jout, out = grid
    _same_verdict(out, jout)
    assert not out.accepted and out.reject_reason == "consistency" and out.n_compete >= 1
    assert abs(out.rival_quality - jout.rival_quality) < 1e-3
    assert abs(out.dispersion_m - jout.dispersion_m) < 1e-3


def test_early_exits_match_reference(grid):
    """The quality exit (init in empty space) and the correction exit (a
    correction beyond ``max_correction_m``): no probe batch."""
    jloc, ploc, jscan, pscan, *_ = grid
    far = np.array([500.0, 500.0, 0.0], np.float32)
    jout = jloc.localize(jscan, jse3.Pose(jnp.eye(3), jnp.asarray(far)))
    out = ploc.localize(pscan, se3.Pose(torch.eye(3), torch.from_numpy(far)))
    _same_verdict(out, jout)
    assert out.reject_reason == "quality"
    jloc.max_correction_m = ploc.max_correction_m = 0.1
    try:
        near = np.array([0.3, -0.2, 0.0], np.float32)
        jout = jloc.localize(jscan, jse3.Pose(jnp.eye(3), jnp.asarray(near)))
        out = ploc.localize(pscan, se3.Pose(torch.eye(3), torch.from_numpy(near)))
    finally:
        jloc.max_correction_m = ploc.max_correction_m = 8.0
    _same_verdict(out, jout)
    assert out.reject_reason == "correction" and out.quality > 0.5


def test_queries_before_build_raise_and_helpers_match_reference():
    loc = localizer.MapLocalizer(device="cpu")
    scan = {"raw": metric_map.from_points(np.zeros((4, 3), np.float32), device="cpu")}
    for query in (loc.localize, loc.localize_raw):
        with pytest.raises(RuntimeError):
            query(scan, se3.identity(device="cpu"))
    # the se3 helpers the tests and chip_smoke.py use
    args = (1.0, -2.0, 0.5, 0.3, -0.1, 0.05)
    p, jp = se3.from_xyz_ypr(*args, device="cpu"), jse3.from_xyz_ypr(*args)
    np.testing.assert_allclose(p.R.numpy(), np.asarray(jp.R), atol=1e-6)
    np.testing.assert_array_equal(p.t.numpy(), np.asarray(jp.t))
    assert abs(float(se3.translation_norm(p)) - float(jse3.translation_norm(jp))) < 1e-6
    ident, jident = se3.identity((2,), device="cpu"), jse3.identity((2,))
    np.testing.assert_array_equal(ident.R.numpy(), np.asarray(jident.R))
    np.testing.assert_array_equal(ident.t.numpy(), np.asarray(jident.t))


@pytest.fixture(scope="module")
def mapping_run():
    """The reference tests' mapping run: 12 straight scans (2 m/s, 2 Hz)
    through the port's front-end, a map of its keyframes at their
    estimated poses, and a new scan taken at ``gt[5]`` with its true pose
    in the map frame (the first keyframe's, ``gt[0]``)."""
    w = synthetic.SyntheticWorld(extent=60.0, n_world_points=60_000, points_per_scan=4096,
                                 max_range=35.0, seed=6)
    obs, gt = synthetic.synthetic_sequence(kind="straight", n_scans=12, speed=2.0, rate_hz=2.0,
                                           world=w)
    m = runner.run_replay(obs, odom_test_cfg(), device="cpu")["module"]
    try:
        # 1 << 13 holds the whole map (~7.5k voxels): the CPU's brute-force
        # searches scan every slot, and the reference tests' 1 << 14 would
        # double them for padding
        loc = localizer.MapLocalizer(map_capacity=1 << 13, voxel_size=0.5, device="cpu")
        loc.build_from_worldmodel(m.worldmodel, runner.estimated_trajectory(m))
        (R0, t0), (Rq, tq) = gt[0], gt[5]
        scan = {"raw": metric_map.from_points(w.scan_at(Rq, tq), capacity=4096, device="cpu")}
        yield loc, scan, R0.T @ Rq, R0.T @ (tq - t0)
    finally:
        m.shutdown()


@pytest.mark.parametrize("case", ["mapping_run", "unique_scene"])
def test_mapping_run_localizes_to_ground_truth(mapping_run, case):
    """From ``+[0.5, -0.3, 0]`` m off the true pose: within 0.25 m of it
    at quality > 0.5 with two starts, and accepted by the gate with at
    least 3 agreeing of four starts (the scene is unique)."""
    loc, scan, R_true, t_true = mapping_run
    loc.multi_start, loc.start_sigma_xyz = {"mapping_run": (2, 1.0),
                                            "unique_scene": (4, 1.5)}[case]
    assert 1000 < int(loc.map_cloud.count()) < loc.map_capacity  # not subsampled
    init = se3.Pose(torch.tensor(R_true, dtype=torch.float32),
                    torch.tensor(t_true + np.array([0.5, -0.3, 0.0]), dtype=torch.float32))
    out = loc.localize(scan, init)
    err = np.linalg.norm(np.asarray(out.pose.t) - t_true)
    assert err < 0.25, err
    if case == "mapping_run":
        assert float(out.quality) > 0.5
    else:
        assert out.accepted, out.reject_reason
        assert out.n_agree >= 3
