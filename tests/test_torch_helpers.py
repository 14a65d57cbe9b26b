"""Port parity for the public helpers: the SE(3) conversions
(``so3_exp``, ``relative_to``, ``from_matrix`` / ``to_matrix``,
``to_xyz_ypr``, ``rotation_log``), the twist and pose-PDF modules,
``empty_cloud`` / ``concat_clouds``, ``voxel_coords`` and
``make_batched_align`` on two lanes, against the JAX package on the same
numpy inputs (and, on a data mesh of two CPU positions, against itself
without one: equal iterations, termination and quality, poses within
1e-6, since a lane alone takes the Gauss-Newton system's batched matrix
products in another order than two lanes together).

Tolerances: f32 geometry within 1e-6 relative to the values' scale
(1 for rotations, 10-20 m for translations); integers, masks and shapes
exact; the batched align per lane 1 mm / 0.2 mrad with equal
iteration counts and termination.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mola_fe_lidar_tpu import geometry as jgeometry
from mola_fe_lidar_tpu.cloud import metric_map as jmetric_map
from mola_fe_lidar_tpu.cloud import voxel as jvoxel
from mola_fe_lidar_tpu.models import config as jconfig
from mola_fe_lidar_tpu.parallel import batch as jbatch
from mola_fe_lidar_tpu_torch import geometry
from mola_fe_lidar_tpu_torch.cloud import metric_map, voxel
from mola_fe_lidar_tpu_torch.geometry import se3_np
from mola_fe_lidar_tpu_torch.models import config
from mola_fe_lidar_tpu_torch.parallel import batch, mesh

torch.set_num_threads(1)
RTOL = 1e-6


def _close(got, want, scale=1.0, atol=0.0):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=max(atol, RTOL * scale))


def _poses(rng, n=6):
    tau = np.concatenate([rng.normal(0, 5, (n, 3)), rng.normal(0, 0.8, (n, 3))], -1)
    tau[0, 3:] = 0.0
    return tau.astype(np.float32)


def test_se3_helpers_match_reference(rng):
    w = rng.normal(0, 0.8, (6, 3)).astype(np.float32)
    w[0] = 0.0
    w[1] *= 1e-4  # the Taylor branch
    _close(geometry.se3.so3_exp(w, device="cpu"), jgeometry.se3.so3_exp(jnp.asarray(w)))
    ta, tb = _poses(rng), _poses(rng)
    a, b = geometry.exp(torch.from_numpy(ta)), geometry.exp(torch.from_numpy(tb))
    ja, jb = jgeometry.exp(jnp.asarray(ta)), jgeometry.exp(jnp.asarray(tb))
    rel, jrel = geometry.relative_to(a, b), jgeometry.relative_to(ja, jb)
    _close(rel.R, jrel.R)
    _close(rel.t, jrel.t, scale=20.0)
    T, jT = geometry.to_matrix(a), jgeometry.to_matrix(ja)
    _close(T, jT)
    p, jp = geometry.from_matrix(np.array(jT), device="cpu"), jgeometry.from_matrix(jT)
    _close(p.R, jp.R)
    _close(p.t, jp.t)
    for got, want in zip(geometry.to_xyz_ypr(a), jgeometry.to_xyz_ypr(ja)):
        _close(got, want, scale=10.0)
    # from_xyz_ypr inverts to_xyz_ypr
    back = geometry.to_xyz_ypr(geometry.from_xyz_ypr(*(x.numpy() for x in geometry.to_xyz_ypr(a)),
                                                    device="cpu"))
    for got, want in zip(back, geometry.to_xyz_ypr(a)):
        _close(got, want, scale=10.0)
    _close(geometry.rotation_log(a), jgeometry.rotation_log(ja), scale=3.0)
    assert geometry.identity(device="cpu").R.shape == (3, 3)


def test_twist_matches_reference(rng):
    tau = _poses(rng, 4) * 0.1
    rel, jrel = geometry.exp(torch.from_numpy(tau)), jgeometry.exp(jnp.asarray(tau))
    for dt in (0.1, 0.0, -0.1):
        got, want = geometry.twist_from_delta(rel, dt), jgeometry.twist_from_delta(jrel, dt)
        _close(got, want, scale=float(np.abs(np.asarray(want)).max() or 1.0))
        if dt <= 0:
            assert not got.any()
    tw = rng.normal(0, 2, 6).astype(np.float32)
    p = geometry.propagate_pose(torch.from_numpy(tw), 0.1)
    jp = jgeometry.propagate_pose(jnp.asarray(tw), 0.1)
    _close(p.R, jp.R)
    _close(p.t, jp.t)
    z = geometry.twist_zero(device="cpu")
    assert z.shape == (6,) and z.dtype == torch.float32 and not z.any()
    np.testing.assert_array_equal(z.numpy(), np.asarray(jgeometry.twist_zero()))


def test_pose_pdf_matches_reference(rng):
    tau = _poses(rng, 3)
    for pose, jpose in ((geometry.exp(torch.from_numpy(tau)), jgeometry.exp(jnp.asarray(tau))),
                        (geometry.exp(torch.from_numpy(tau[0])),
                         jgeometry.exp(jnp.asarray(tau[0])))):
        pdf = geometry.pdf_from_pose(pose, 0.10, np.deg2rad(1.0))
        jpdf = jgeometry.pdf_from_pose(jpose, 0.10, np.deg2rad(1.0))
        assert isinstance(pdf, geometry.PosePDF)
        _close(pdf.cov, jpdf.cov, scale=0.01)
        assert pdf.mean is pose


def test_empty_and_concat_clouds_match_reference(rng):
    e = metric_map.empty_cloud(300, attrs=(("normals", 3), ("time", 1)), device="cpu")
    je = jmetric_map.empty_cloud(300, attrs=(("normals", 3), ("time", 1)))
    for got, want in ((e.xyz, je.xyz), (e.mask, je.mask)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert {k: tuple(v.shape) for k, v in e.attrs.items()} == \
        {k: tuple(v.shape) for k, v in je.attrs.items()}
    pts = rng.normal(0, 10, (700, 3)).astype(np.float32)
    nrm = rng.normal(0, 1, (700, 3)).astype(np.float32)
    a = metric_map.from_points(pts, attrs={"normals": nrm}, device="cpu")
    ja = jmetric_map.from_points(pts, attrs={"normals": nrm})
    for left, jleft in ((a, ja), (e, je)):
        c, jc = metric_map.concat_clouds(left, a), jmetric_map.concat_clouds(jleft, ja)
        np.testing.assert_array_equal(c.xyz.numpy(), np.asarray(jc.xyz))
        np.testing.assert_array_equal(c.mask.numpy(), np.asarray(jc.mask))
        assert sorted(c.attrs) == sorted(jc.attrs)
        for k in c.attrs:
            np.testing.assert_array_equal(c.attrs[k].numpy(), np.asarray(jc.attrs[k]))
        assert c.capacity == jc.capacity == left.capacity + a.capacity


def test_voxel_coords_match_reference(rng):
    xyz = rng.uniform(-50, 50, (2, 500, 3)).astype(np.float32)
    xyz[0, :3] = [[0.5, 0.5, 0.5], [-0.5, 1.0, 2.0], [1e-7, -1e-7, 0.0]]  # cell borders
    origin = np.array([[-49.7, -50.2, -3.0]], np.float32)
    for res in (0.5, 1.0, 0.3):
        got = voxel.voxel_coords(torch.from_numpy(xyz), res, torch.from_numpy(origin))
        want = np.asarray(jvoxel.voxel_coords(jnp.asarray(xyz), res, jnp.asarray(origin)))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)


def test_make_batched_align_matches_reference_on_two_lanes(rng):
    src = rng.uniform(-20, 20, (400, 3)).astype(np.float32)
    src[:, 2] *= 0.2
    tau = np.array([[0.3, -0.2, 0.05, 0.0, 0.0, 0.04],
                    [-0.4, 0.1, 0.0, 0.01, 0.0, -0.06]], np.float32)
    truth = [se3_np.exp(t.astype(np.float64)) for t in tau]
    tgt = np.stack([src @ R.T + t for R, t in truth]).astype(np.float32)
    params = dataclasses.replace(config.ICPParams(), max_iterations=20,
                                 matchers=(config.Matcher(distance_threshold=2.0),),
                                 solver=config.Solver(max_iterations=5))
    jparams = dataclasses.replace(jconfig.ICPParams(), max_iterations=20,
                                  matchers=(jconfig.Matcher(distance_threshold=2.0),),
                                  solver=jconfig.Solver(max_iterations=5))
    src_mm = {"raw": metric_map.from_points(src, device="cpu")}
    tgt_mm = {"raw": metric_map.PointCloud(torch.from_numpy(tgt),
                                           torch.ones(tgt.shape[:2]), {})}
    jsrc = {"raw": jmetric_map.PointCloud(jnp.broadcast_to(jnp.asarray(src_mm["raw"].xyz.numpy()),
                                                           (2, 512, 3)),
                                          jnp.broadcast_to(jnp.asarray(src_mm["raw"].mask.numpy()),
                                                           (2, 512)), {})}
    jtgt = {"raw": jmetric_map.PointCloud(jnp.asarray(tgt), jnp.ones(tgt.shape[:2]), {})}
    R0, t0 = np.broadcast_to(np.eye(3, dtype=np.float32), (2, 3, 3)), np.zeros((2, 3), np.float32)
    res = batch.make_batched_align(params)(src_mm, tgt_mm,
                                           geometry.Pose(torch.from_numpy(R0.copy()),
                                                         torch.from_numpy(t0)))
    jres = jbatch.make_batched_align(jparams)(jsrc, jtgt,
                                              jgeometry.Pose(jnp.asarray(R0), jnp.asarray(t0)))
    np.testing.assert_array_equal(res.n_iterations.numpy(), np.asarray(jres.n_iterations))
    np.testing.assert_array_equal(res.term_reason.numpy(), np.asarray(jres.term_reason))
    assert np.abs(res.pose.t.numpy() - np.asarray(jres.pose.t)).max() < 1e-3
    assert np.abs(res.pose.R.numpy() - np.asarray(jres.pose.R)).max() < 2e-4
    for b, (R, t) in enumerate(truth):  # each lane found its own motion
        assert np.abs(res.pose.t[b].numpy() - t).max() < 0.05
    # on a data mesh of 2 positions (one lane each): the same per-lane result
    previous = mesh.force_device_count(2)
    try:
        split = batch.make_batched_align(params, mesh=mesh.make_mesh({"data": 2},
                                                                     mesh.devices("cpu")))(
            src_mm, tgt_mm, geometry.Pose(torch.from_numpy(R0.copy()), torch.from_numpy(t0)))
    finally:
        mesh.force_device_count(previous)
    for f in ("n_iterations", "term_reason", "quality"):
        assert torch.equal(getattr(split, f), getattr(res, f)), f
    torch.testing.assert_close(split.pose.t, res.pose.t, atol=1e-6, rtol=0)
    torch.testing.assert_close(split.pose.R, res.pose.R, atol=1e-6, rtol=0)
