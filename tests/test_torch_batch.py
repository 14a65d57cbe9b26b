"""Port parity for batches: the plain twins of K1/K2 with a leading batch
axis, the batched Gauss-Newton solve, and the batched align
(mola_fe_lidar_tpu_torch.parallel.batch) against the JAX package's vmapped
``batched_align``.

Tolerances: a batched twin is B separate searches, so it is held bit for
bit to B unbatched calls. A batched solve or align takes its sums in
another order than one lane alone (batched matrix products), so lanes agree
with the unbatched port to 1e-5 m / 1e-5 rad and equal iteration counts.
Against JAX on the same filtered HDL-64 layers (azimuth 256): per lane
1 mm / 0.2 mrad on the pose, equal iteration counts and termination, and
quality within 1e-3.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mola_fe_lidar_tpu.cloud.metric_map import PointCloud as JPointCloud
from mola_fe_lidar_tpu.frontend.odometry import LidarOdometry as JLidarOdometry
from mola_fe_lidar_tpu.geometry import se3 as jse3
from mola_fe_lidar_tpu.parallel import batch as jbatch
from mola_fe_lidar_tpu_torch.filters.generators import apply_generators
from mola_fe_lidar_tpu_torch.frontend.odometry import _stack_maps
from mola_fe_lidar_tpu_torch.geometry import se3
from mola_fe_lidar_tpu_torch.models import icp
from mola_fe_lidar_tpu_torch.obs.hdl64 import hdl64_sequence
from mola_fe_lidar_tpu_torch.obs.runner import build_module, realtime_config
from mola_fe_lidar_tpu_torch.ops import knn_kernel, matching, nn_kernel
from mola_fe_lidar_tpu_torch.parallel import batch, mesh
from mola_fe_lidar_tpu_torch.solve import gauss_newton

torch.set_num_threads(1)
AZIMUTH = 256
B = 3


def _clouds(rng, n, m, lanes):
    def cloud(k):
        xyz = (rng.standard_normal((lanes, k, 3)) * 20).astype(np.float32)
        mask = (rng.uniform(size=(lanes, k)) < 0.9).astype(np.float32)
        xyz[mask < 0.5] = 1e6
        return torch.from_numpy(xyz), torch.from_numpy(mask)
    return (*cloud(n), *cloud(m))


def _share(x, shared):
    """Lane 0 of ``x`` for every lane, as a stride-0 expand."""
    return x[:1].expand_as(x) if shared else x


@pytest.mark.parametrize("share", ["none", "tgt", "both"])
@pytest.mark.parametrize("k", knn_kernel.REGISTER_K)
def test_batched_twins_are_separate_calls(rng, k, share):
    src, sm, tgt, tm = _clouds(rng, 70, 130, B)
    src, sm = _share(src, share == "both"), _share(sm, share == "both")
    tgt, tm = _share(tgt, share != "none"), _share(tm, share != "none")
    got = knn_kernel.knn(src, sm, tgt, tm, k)
    assert got.idx.shape == (B, 70, k)
    for b in range(B):
        want = matching.knn(src[b].contiguous(), sm[b].contiguous(), tgt[b].contiguous(),
                            tm[b].contiguous(), k)
        assert torch.equal(got.idx[b], want.idx) and torch.equal(got.dist[b], want.dist)
    if k == 1:
        got1 = nn_kernel.nearest_neighbors(src, sm, tgt, tm)
        assert torch.equal(got1.idx, got.idx[..., 0]) and torch.equal(got1.dist, got.dist[..., 0])


def test_check_inputs_takes_lanes_and_shared_operands(rng):
    src, sm, tgt, tm = _clouds(rng, 40, 50, B)
    assert knn_kernel.check_inputs(src, sm, tgt[:1].expand_as(tgt), tm[:1].expand_as(tm)) == B
    assert knn_kernel.check_inputs(src[0], sm[0], tgt[0], tm[0]) == 1
    bad = [(src, sm, tgt[:2], tm[:2]),                      # lanes differ
           (src.transpose(1, 2).contiguous().transpose(1, 2), sm, tgt, tm),  # lane not contiguous
           (src, sm[:, :5], tgt, tm),                       # mask length
           (src[:0], sm[:0], tgt[:0], tm[:0])]               # empty batch
    for args in bad:
        with pytest.raises(ValueError):
            knn_kernel.check_inputs(*args)


@pytest.mark.cuda
def test_cuda_batched_kernels_match_twins_and_unbatched_launches(rng):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run: python3 chip_smoke.py, or pytest -m cuda on one)")
    src, sm, tgt, tm = (x.cuda() for x in _clouds(rng, 1500, 9000, B))
    for shared in (False, True):
        t, m = _share(tgt, shared), _share(tm, shared)
        for k in knn_kernel.COMPILED_K + (3, 100):
            got = knn_kernel.knn(src, sm, t, m, k)
            want = matching.knn(src, sm, t, m, k)
            assert torch.equal(got.idx, want.idx) and torch.equal(got.dist, want.dist)
            one = knn_kernel.knn(src[1], sm[1], t[1].contiguous(), m[1].contiguous(), k)
            assert torch.equal(got.idx[1], one.idx) and torch.equal(got.dist[1], one.dist)
        got1 = nn_kernel.nearest_neighbors(src, sm, t, m)
        want1 = matching.nearest_neighbors(src, sm, t, m)
        assert torch.equal(got1.idx, want1.idx) and torch.equal(got1.dist, want1.dist)


def test_batched_gauss_newton_is_per_lane(rng):
    poses = se3.exp(torch.from_numpy(rng.normal(0, 0.05, (B, 6)).astype(np.float32)))
    p, q, n = (torch.from_numpy(rng.normal(0, 5, (B, 200, 3)).astype(np.float32))
               for _ in range(3))
    n = n / torch.linalg.vector_norm(n, dim=-1, keepdim=True)
    w = torch.from_numpy((rng.uniform(size=(B, 200)) < 0.8).astype(np.float32))
    prior_w = torch.tensor([1.0] * 3 + [16.0] * 3)
    res = gauss_newton.point_to_plane_step(poses, p, q, n, w, inner_iterations=5,
                                           prior_pose=poses, prior_w=prior_w)
    cov = gauss_newton.covariance_from_normal_matrix(res.normal_matrix, res.sq_residual_sum,
                                                     res.weight_sum)
    for b in range(B):
        pb = se3.Pose(poses.R[b], poses.t[b])
        one = gauss_newton.point_to_plane_step(pb, p[b], q[b], n[b], w[b], inner_iterations=5,
                                               prior_pose=pb, prior_w=prior_w)
        torch.testing.assert_close(res.pose.t[b], one.pose.t, atol=1e-5, rtol=0)
        torch.testing.assert_close(res.pose.R[b], one.pose.R, atol=1e-5, rtol=0)
        cov_one = gauss_newton.covariance_from_normal_matrix(
            one.normal_matrix, one.sq_residual_sum, one.weight_sum)
        torch.testing.assert_close(cov[b], cov_one, rtol=1e-4,
                                   atol=1e-4 * float(cov_one.abs().max()))


@pytest.fixture(scope="module")
def setup():
    """Filtered layers of four HDL-64 scans (the port's filter chain, which
    tests/test_torch_filters.py holds to the reference's), both modules'
    nearby stages, and graph-style guesses: the ground-truth pose of each
    source scan in the target scan's frame, perturbed by 0.1 m."""
    cfg = realtime_config(AZIMUTH / 2048)
    port = build_module(cfg, device="cpu")
    ref = JLidarOdometry()
    ref.initialize(cfg)
    obs, gt = hdl64_sequence(n_scans=9, n_azimuth=AZIMUTH)
    layers = []
    for i in (0, 3, 6, 8):
        mm = port._filter_core(apply_generators(port.generators, obs[i]), torch.zeros(6))[0]
        layers.append({n: pc for n, pc in mm.items() if n != "raw"})
    rng = np.random.default_rng(3)
    (R8, p8) = gt[8]
    gR = np.stack([R8.T @ gt[i][0] for i in (0, 3, 6)]).astype(np.float32)
    gt_ = np.stack([R8.T @ (gt[i][1] - p8) + rng.normal(0, 0.1, 3)
                    for i in (0, 3, 6)]).astype(np.float32)
    yield port, ref, layers, (gR, gt_)
    port.shutdown()
    ref.shutdown()


def _jmap(mm, lanes=None):
    out = {n: JPointCloud(jnp.asarray(pc.xyz.numpy()), jnp.asarray(pc.mask.numpy()),
                          {k: jnp.asarray(v.numpy()) for k, v in pc.attrs.items()})
           for n, pc in mm.items()}
    if lanes:
        out = jax.tree.map(lambda x: jnp.broadcast_to(x, (lanes, *x.shape)), out)
    return out


def rot_err(Ra, Rb) -> np.ndarray:
    """Angle of Ra^T Rb from its skew part (the trace form loses ~3e-4 rad
    to f32 round-off near the identity)."""
    dR = np.swapaxes(np.asarray(Ra, np.float64), -1, -2) @ np.asarray(Rb, np.float64)
    skew = dR - np.swapaxes(dR, -1, -2)
    w = np.stack([skew[..., 2, 1], skew[..., 0, 2], skew[..., 1, 0]], -1) / 2
    return np.arcsin(np.clip(np.linalg.norm(w, axis=-1), 0, 1))


def _assert_lanes_match(res, jres, pose_tol=1e-3, rot_tol=2e-4, q_tol=1e-3):
    assert rot_err(res.pose.R.numpy(), jres.pose.R).max() < rot_tol
    assert np.abs(res.pose.t.numpy() - np.asarray(jres.pose.t)).max() < pose_tol
    np.testing.assert_array_equal(res.n_iterations.numpy(), np.asarray(jres.n_iterations))
    np.testing.assert_array_equal(res.term_reason.numpy(), np.asarray(jres.term_reason))
    assert np.abs(res.quality.numpy() - np.asarray(jres.quality)).max() <= q_tol


def test_batched_align_matches_reference_nearby_stages(setup):
    """The nearby batch's shape: three keyframe clouds, one shared target."""
    port, ref, layers, (gR, gt_) = setup
    stages, jstages = port._nearby_stages(), ref._nearby_stages()
    assert [dataclasses.asdict(s) for s in stages] == [dataclasses.asdict(s) for s in jstages]
    res = batch.batched_align(_stack_maps(layers[:3]), layers[3],
                              se3.Pose(torch.from_numpy(gR), torch.from_numpy(gt_)), stages[0])
    jsrc = jax.tree.map(lambda *x: jnp.stack(x), *[_jmap(m) for m in layers[:3]])
    jres = jbatch.batched_align(jsrc, _jmap(layers[3], B),
                                jse3.Pose(jnp.asarray(gR), jnp.asarray(gt_)), jstages[0])
    _assert_lanes_match(res, jres)
    assert float(res.quality.min()) > 0.1  # real alignments, not empty pairings


def test_batched_align_lanes_are_unbatched_aligns(setup):
    """Per-lane freezing: every lane of a batch ends where the same align
    alone ends, at its own iteration count, however long the others run."""
    port, _, layers, (gR, gt_) = setup
    params = dataclasses.replace(port._nearby_stages()[0], max_iterations=30)
    gt_ = gt_.copy()
    gt_[2] += np.array([0.6, -0.4, 0.0], np.float32)  # a slow lane
    res = batch.batched_align(_stack_maps(layers[:3]), layers[3],
                              se3.Pose(torch.from_numpy(gR), torch.from_numpy(gt_)), params)
    its = res.n_iterations.tolist()
    assert len(set(its)) > 1  # lanes finished at different iterations
    for b in range(B):
        one = icp.align(layers[b], layers[3], se3.Pose(torch.from_numpy(gR[b]),
                                                       torch.from_numpy(gt_[b])), params)
        assert int(one.n_iterations) == its[b]
        assert int(one.term_reason) == int(res.term_reason[b])
        torch.testing.assert_close(res.pose.t[b], one.pose.t, atol=1e-5, rtol=0)
        torch.testing.assert_close(res.pose.R[b], one.pose.R, atol=1e-5, rtol=0)
        assert abs(float(res.quality[b]) - float(one.quality)) < 1e-6


def test_chunked_batched_align_is_the_batched_align(setup):
    port, _, layers, (gR, gt_) = setup
    params = port._nearby_stages()[0]
    src = _stack_maps(layers[:3] + layers[:1])
    R4 = torch.from_numpy(np.concatenate([gR, gR[:1]]))
    t4 = torch.from_numpy(np.concatenate([gt_, gt_[:1] + 0.05]))
    whole = batch.batched_align(src, layers[3], se3.Pose(R4, t4), params)
    chunked = batch.make_chunked_batched_align(params, chunk=2)(src, layers[3], se3.Pose(R4, t4))
    assert torch.equal(whole.n_iterations, chunked.n_iterations)
    torch.testing.assert_close(whole.pose.t, chunked.pose.t, atol=1e-5, rtol=0)
    torch.testing.assert_close(whole.quality, chunked.quality, atol=1e-6, rtol=0)
    with pytest.raises(ValueError):
        batch.make_chunked_batched_align(params, chunk=3)(src, layers[3], se3.Pose(R4, t4))
    # a data mesh of 2 positions: 2 lanes each, the same per-lane result
    previous = mesh.force_device_count(2)
    try:
        split = batch.batched_align(src, layers[3], se3.Pose(R4, t4), params,
                                    mesh=mesh.make_mesh({"data": 2}, mesh.devices("cpu")))
    finally:
        mesh.force_device_count(previous)
    assert torch.equal(whole.n_iterations, split.n_iterations)
    assert torch.equal(whole.term_reason, split.term_reason)
    torch.testing.assert_close(whole.pose.t, split.pose.t, atol=1e-5, rtol=0)
    torch.testing.assert_close(whole.pose.R, split.pose.R, atol=1e-5, rtol=0)
    torch.testing.assert_close(whole.quality, split.quality, atol=1e-6, rtol=0)
