"""Port parity for the device meshes: the mesh helpers, the tensor-parallel
searches (``ops/tp.py``), ``make_sharded_align``, ``make_dp_tp_align`` and
``make_batched_align`` with a mesh, against the JAX package on its 8
virtual CPU devices (``tests/conftest.py``) and against the port's own
unsharded searches and aligns. The port's positions are 8 CPU positions
(``force_device_count(8)``).

Tolerances: the sharded searches are bit-identical to the unsharded twin
(integer-grid ties, rows with fewer valid neighbours than k split over the
slices, masked sources); against the reference's ``tp_*`` inside
``shard_map`` index sets are equal on the rows ``tests/test_torch_knn.py``
keeps (neighbours separated by more than 1e-3 m) and distances within its
1e-3 rule for the XLA path. Sharded aligns: poses within 1 mm / 0.2 mrad
of the reference's, quality within 1e-5, and bit-identical to the port's
unsharded align. A batch split over a data mesh equals the unsplit batch
lane by lane, bit for bit: each lane freezes on its own.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from mola_fe_lidar_tpu.cloud import from_points as jfrom_points
from mola_fe_lidar_tpu.geometry import se3 as jse3
from mola_fe_lidar_tpu.models import config as jconfig
from mola_fe_lidar_tpu.models.icp import align as jalign
from mola_fe_lidar_tpu.ops import matching as jmatching
from mola_fe_lidar_tpu.parallel import distributed as jdistributed
from mola_fe_lidar_tpu.parallel import mesh as jmesh
from mola_fe_lidar_tpu_torch.cloud.metric_map import PointCloud, from_points, split_cloud
from mola_fe_lidar_tpu_torch.geometry import se3
from mola_fe_lidar_tpu_torch.models import config
from mola_fe_lidar_tpu_torch.models.icp import align
from mola_fe_lidar_tpu_torch.ops import matching, tp
from mola_fe_lidar_tpu_torch.parallel import (batch, default_mesh, make_dp_tp_align, make_mesh,
                                              make_sharded_align, mesh, pad_batch, shard_batch)
from tests.test_icp import structured_world

torch.set_num_threads(1)
SEP = 1e-3


@pytest.fixture
def cpu8():
    """8 positions on the CPU, restored after the test."""
    previous = mesh.force_device_count(8)
    try:
        yield mesh.devices("cpu")
    finally:
        mesh.force_device_count(previous)


def test_mesh_helpers_match_reference(cpu8):
    for axes in ({"data": 4, "model": 2}, {"model": 8}, {"data": 2}):
        m, jm = make_mesh(axes, cpu8), jmesh.make_mesh(axes)
        assert m.axis_names == jm.axis_names
        assert m.devices.shape == jm.devices.shape
        assert m.shape == dict(jm.shape)
    with pytest.raises(ValueError, match="mesh needs 9 devices, have 8"):
        make_mesh({"data": 9}, cpu8)
    with pytest.raises(ValueError, match="mesh needs 9 devices, have 8"):
        jmesh.make_mesh({"data": 9})
    assert default_mesh(cpu8).shape == dict(jmesh.default_mesh().shape) == {"data": 8}
    # the positions lie on the real devices in turn
    assert [d.type for d in cpu8] == ["cpu"] * 8
    assert mesh.force_device_count(None) == 8 and len(mesh.devices("cpu")) == 1
    mesh.force_device_count(8)

    x = np.arange(15, dtype=np.float32).reshape(5, 3)
    (padded, b), (jpadded, jb) = pad_batch({"x": torch.from_numpy(x)}, 8), \
        jmesh.pad_batch({"x": jnp.asarray(x)}, 8)
    assert b == jb == 5
    np.testing.assert_array_equal(padded["x"].numpy(), np.asarray(jpadded["x"]))
    assert pad_batch({"x": torch.from_numpy(x)}, 5)[1] == 5

    tree = {"a": np.arange(48, dtype=np.float32).reshape(8, 6),
            "b": np.arange(8, dtype=np.float32)}
    m, jm = make_mesh({"data": 4, "model": 2}, cpu8), jmesh.make_mesh({"data": 4, "model": 2})
    parts = shard_batch(m, {k: torch.from_numpy(v) for k, v in tree.items()})
    jparts = jmesh.shard_batch(jm, {k: jnp.asarray(v) for k, v in tree.items()})
    assert len(parts) == 4
    for name in tree:
        # the reference's shards along "data" (replicated over "model")
        shards = {s.index[0].start or 0: np.asarray(s.data)
                  for s in jparts[name].addressable_shards}
        for i, part in enumerate(parts):
            np.testing.assert_array_equal(part[name].numpy(), shards[2 * i])
    with pytest.raises(ValueError):
        shard_batch(m, {"b": torch.zeros(6)})


def _tie_clouds(rng, n, m, extent=2):
    src = rng.integers(-extent, extent + 1, (n, 3)).astype(np.float32)
    tgt = rng.integers(-extent, extent + 1, (m, 3)).astype(np.float32)
    sm = (rng.uniform(size=n) < 0.9).astype(np.float32)
    tm = (rng.uniform(size=m) < 0.9).astype(np.float32)
    src[sm < 0.5] = 1e6
    tgt[tm < 0.5] = 1e6
    return src, sm, tgt, tm


def _street_clouds(rng, n=300, m=512, scale=30.0):
    src = (rng.standard_normal((n, 3)) * scale).astype(np.float32)
    tgt = (rng.standard_normal((m, 3)) * scale).astype(np.float32)
    sm = (rng.uniform(size=n) < 0.9).astype(np.float32)
    tm = (rng.uniform(size=m) < 0.9).astype(np.float32)
    src[sm < 0.5] = 1e6
    tgt[tm < 0.5] = 1e6
    return src, sm, tgt, tm


def _few_valid():
    """Every source has two valid targets, in different slices, for k = 4."""
    tgt = np.full((16, 3), 1e6, np.float32)
    tm = np.zeros(16, np.float32)
    tgt[3], tgt[12] = (1.0, 0.0, 0.0), (0.0, 2.0, 0.0)
    tm[[3, 12]] = 1.0
    src = np.zeros((3, 3), np.float32)
    src[1] = (0.5, 0.5, 0.0)
    return src, np.array([1.0, 1.0, 0.0], np.float32), tgt, tm


def _reference_tp(fn, p, *args):
    """A reference ``tp_*`` inside ``shard_map`` over a ``model`` axis of p
    devices: source replicated, target split on its point axis."""
    jm = jmesh.make_mesh({"model": p})
    specs = (JP(), JP(), JP("model", None), JP("model"))
    return jax.shard_map(lambda s, sm, t, tm: fn(s, sm, t, tm, "model"), mesh=jm,
                         in_specs=specs, out_specs=JP(), check_vma=False)(
        *(jnp.asarray(a) for a in args))


@pytest.mark.parametrize("scene", ["ties", "streets"])
def test_tp_searches_are_the_unsharded_search(cpu8, rng, scene):
    cases = ([_tie_clouds(rng, 200, 512), _few_valid()] if scene == "ties"
             else [_street_clouds(rng)])
    for src, sm, tgt, tm in cases:
        s, smt, t, tmt = (torch.from_numpy(a) for a in (src, sm, tgt, tm))
        normal = torch.from_numpy(rng.standard_normal((t.shape[0], 1)).astype(np.float32))
        for p in (2, 4, 8):
            split = split_cloud(PointCloud(t, tmt, {"n": normal}), cpu8[:p])
            assert all(x.data_ptr() == t[i * (t.shape[0] // p)].data_ptr()
                       for i, x in enumerate(split.xyz))  # views, not copies
            got = tp.tp_nearest_neighbors(s, smt, split.xyz, split.mask)
            want = matching.nearest_neighbors(s, smt, t, tmt)
            assert torch.equal(got.idx, want.idx) and torch.equal(got.dist, want.dist), (p, "nn")
            assert torch.equal(tp.tp_gather_points(split.attrs["n"], want.idx),
                               normal[want.idx.long()])
            for k in (1, 4, 5, 8):
                got = tp.tp_knn(s, smt, split.xyz, split.mask, k)
                want = matching.knn(s, smt, t, tmt, k)
                assert torch.equal(got.idx, want.idx) and torch.equal(got.dist, want.dist), (p, k)
                assert torch.equal(tp.tp_gather_points(split.xyz, want.idx), t[want.idx.long()])
                if src.shape[0] == 3 and k == 4:  # two valid neighbours: slice 0's index 0 fills
                    assert got.idx[:2, 2:].tolist() == [[0, 0]] * 2
                    assert bool((got.dist[:2, 2:] > 1e14).all())
            if scene != "streets":
                continue
            # the reference's own sharded searches
            ok = sm > 0.5
            jnn = _reference_tp(lambda *a: jmatching.tp_nearest_neighbors(*a), p,
                                src, sm, tgt, tm)
            nn = tp.tp_nearest_neighbors(s, smt, split.xyz, split.mask)
            np.testing.assert_array_equal(nn.idx.numpy()[ok], np.asarray(jnn.idx)[ok])
            np.testing.assert_allclose(nn.dist.numpy()[ok], np.asarray(jnn.dist)[ok],
                                       rtol=1e-3, atol=1e-3)
            for k in (4, 5):
                jk = _reference_tp(lambda a, b, c, d, ax: jmatching.tp_knn(a, b, c, d, k, ax), p,
                                   src, sm, tgt, tm)
                got = tp.tp_knn(s, smt, split.xyz, split.mask, k)
                d = got.dist.numpy()
                np.testing.assert_allclose(d[ok], np.asarray(jk.dist)[ok], rtol=1e-3, atol=1e-3)
                sep = ok & np.all(np.diff(d, axis=1) > SEP, axis=1)
                assert sep.mean() > 0.5
                np.testing.assert_array_equal(np.sort(got.idx.numpy()[sep], axis=1),
                                              np.sort(np.asarray(jk.idx)[sep], axis=1))
            jg = jax.shard_map(lambda pts, idx: jmatching.tp_gather_points(pts, idx, "model"),
                               mesh=jmesh.make_mesh({"model": p}),
                               in_specs=(JP("model", None), JP()), out_specs=JP(),
                               check_vma=False)(jnp.asarray(tgt), jnp.asarray(want.idx.numpy()))
            np.testing.assert_array_equal(tp.tp_gather_points(split.xyz, want.idx).numpy(),
                                          np.asarray(jg))


P2P = dict(max_iterations=25, matchers=(("point2point", dict(distance_threshold=2.0)),),
           solver=dict(kind="horn"))
P2PLANE_KNN = dict(max_iterations=15,
                   matchers=(("point2plane_knn", dict(distance_threshold=2.0, knn=6,
                                                      plane_eigen_threshold=0.1)),),
                   solver=dict(kind="gauss_newton", max_iterations=8))


def _params(cfg, mod, quality=()):
    return mod.ICPParams(
        max_iterations=cfg["max_iterations"],
        matchers=tuple(mod.Matcher(kind=k, **kw) for k, kw in cfg["matchers"]),
        solver=mod.Solver(**cfg["solver"]),
        quality=tuple(mod.Quality(**q) for q in quality),
        weights=mod.PairWeights(use_scale_outlier_detector=False))


def _pair(rng, n, sigma):
    world = structured_world(rng, n=n)
    true = jse3.exp(jnp.asarray(rng.normal(0, sigma, 6).astype(np.float32)))
    return np.array(jse3.transform(jse3.inverse(true), jnp.asarray(world))), world


def _close_pose(pose, jpose):
    assert np.abs(pose.t.numpy() - np.asarray(jpose.t)).max() < 1e-3
    assert np.abs(pose.R.numpy() - np.asarray(jpose.R)).max() < 2e-4


@pytest.mark.parametrize("case", ["p2p_model8", "p2plane_knn_model4", "symmetric_model4"])
def test_sharded_align_matches_reference(cpu8, rng, case):
    cfg, p, n = ((P2P, 8, 1024) if case == "p2p_model8" else
                 (P2PLANE_KNN, 4, 512) if case == "p2plane_knn_model4" else (P2P, 4, 1024))
    src_pts, world = _pair(rng, n, 0.08 if p == 8 else 0.05)
    quality = ()
    if case == "symmetric_model4":
        # the target's first slice (the ground) is moved out of the
        # source's reach and the source carries a quarter of points the
        # target lacks: both ratios are 3/4, and each row of the other
        # slices is paired
        q = n // 4
        src_pts = np.concatenate([src_pts[q:], src_pts[q:2 * q] + np.float32([0.0, 0.0, 40.0])])
        world = world.copy()
        world[:q, 2] += 60.0
        quality = ({"threshold_distance": 0.3, "symmetric": True},)
    params, jparams = _params(cfg, config, quality), _params(cfg, jconfig, quality)
    src = {"raw": from_points(src_pts, capacity=n, device="cpu")}
    tgt = {"raw": from_points(world, capacity=n, device="cpu")}
    jsrc, jtgt = {"raw": jfrom_points(src_pts, capacity=n)}, {"raw": jfrom_points(world, capacity=n)}
    eye = se3.Pose(torch.eye(3), torch.zeros(3))
    res = make_sharded_align(make_mesh({"model": p}, cpu8), params)(src, tgt, eye)
    jres = jdistributed.make_sharded_align(jmesh.make_mesh({"model": p}), jparams)(
        jsrc, jtgt, jse3.identity())
    one = align(src, tgt, eye, params)
    assert torch.equal(res.pose.t, one.pose.t) and torch.equal(res.pose.R, one.pose.R)
    assert torch.equal(res.quality, one.quality) and int(res.n_iterations) == int(one.n_iterations)
    _close_pose(res.pose, jres.pose)
    if case != "symmetric_model4":
        assert abs(float(res.quality) - float(jres.quality)) < 1e-5
        return
    # the port pairs the whole target in the reverse direction, as the
    # reference does unsharded; the reference's sharded quality keeps
    # device 0's slice (ROADMAP Queue 3): its reverse ratio counts slice
    # 0's mask against, per row, the nearest of the slices' row-mates
    jone = jalign(jsrc, jtgt, jse3.identity(), jparams)
    assert abs(float(res.quality) - float(jone.quality)) < 1e-5
    R, t = np.asarray(jres.pose.R, np.float64), np.asarray(jres.pose.t, np.float64)
    fwd = _ratio(src_pts @ R.T + t, world, np.ones(n), 0.3)
    back = (world - t) @ R
    d = np.stack([_nn_dist(sl, src_pts) for sl in np.split(back, p)])
    mask0 = np.ones(n // p)
    one_slice = float(np.sum(mask0 * (d.min(axis=0) < 0.3)) / np.sum(mask0))
    whole = _ratio(back, src_pts, np.ones(n), 0.3)
    assert one_slice > whole + 0.2  # the case shows the fault
    assert abs(float(jres.quality) - max(fwd, one_slice)) < 1e-5
    assert abs(float(jone.quality) - max(fwd, whole)) < 1e-5


def _nn_dist(a, b):
    return np.sqrt(((a[:, None, :] - b[None, :, :]) ** 2).sum(-1)).min(axis=1)


def _ratio(a, b, mask, thr):
    return float(np.sum(mask * (_nn_dist(a, b) < thr)) / np.sum(mask))


def _pairs(rng, b, n=512):
    srcs, tgts = [], []
    for _ in range(b):
        s, w = _pair(rng, n, 0.1)
        srcs.append(s)
        tgts.append(w)
    return np.stack(srcs).astype(np.float32), np.stack(tgts).astype(np.float32)


def _stacked(pts, jax_side=False):
    clouds = [jfrom_points(x, capacity=x.shape[0]) if jax_side
              else from_points(x, capacity=x.shape[0], device="cpu") for x in pts]
    if jax_side:
        return {"raw": jax.tree.map(lambda *x: jnp.stack(x), *clouds)}
    return {"raw": PointCloud(torch.stack([c.xyz for c in clouds]),
                              torch.stack([c.mask for c in clouds]), {})}


def test_dp_tp_and_data_parallel_batches(cpu8, rng):
    params, jparams = _params(P2P, config), _params(P2P, jconfig)
    # DP x TP: 4 lanes over data, each lane's target over model
    src, tgt = _pairs(rng, 4)
    eye = se3.Pose(torch.eye(3).expand(4, 3, 3).contiguous(), torch.zeros(4, 3))
    res = make_dp_tp_align(make_mesh({"data": 4, "model": 2}, cpu8), params)(
        _stacked(src), _stacked(tgt), eye)
    jres = jdistributed.make_dp_tp_align(jmesh.make_mesh({"data": 4, "model": 2}), jparams)(
        _stacked(src, True), _stacked(tgt, True), jse3.identity((4,)))
    _close_pose(res.pose, jres.pose)
    np.testing.assert_allclose(res.quality.numpy(), np.asarray(jres.quality), atol=1e-5)
    unsplit = align(_stacked(src), _stacked(tgt), eye, params)
    assert torch.equal(res.pose.t, unsplit.pose.t) and torch.equal(res.pose.R, unsplit.pose.R)

    # DP: 8 lanes over data = 8 against the unsplit batch, whole and as
    # shard_batch's slices, with a target shared by every lane
    src, tgt = _pairs(rng, 8)
    guesses = se3.Pose(torch.eye(3).expand(8, 3, 3).contiguous(), torch.zeros(8, 3))
    m = make_mesh({"data": 8}, cpu8)
    run = batch.make_batched_align(dataclasses.replace(params, max_iterations=12), m)
    whole = batch.make_batched_align(dataclasses.replace(params, max_iterations=12))
    for s_map, t_map in ((_stacked(src), _stacked(tgt)),
                         (_stacked(src), {"raw": from_points(tgt[0], device="cpu")})):
        want = whole(s_map, t_map, guesses)
        assert len(set(want.n_iterations.tolist())) > 1  # lanes stop at different iterations
        outs = [run(s_map, t_map, guesses)]
        if t_map["raw"].xyz.dim() == 3:
            outs.append(run(shard_batch(m, s_map), shard_batch(m, t_map),
                            shard_batch(m, guesses)))
        for got in outs:
            for f in ("quality", "n_iterations", "term_reason", "cov"):
                assert torch.equal(getattr(got, f), getattr(want, f)), f
            assert torch.equal(got.pose.t, want.pose.t) and torch.equal(got.pose.R, want.pose.R)
