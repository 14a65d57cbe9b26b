"""Port parity: the voxel-hash grid search (mola_fe_lidar_tpu_torch.ops.grid_nn)
and ``nn_backend="grid"`` in the ICP engine against the JAX package.

Tolerance: the tables, origins and indices are equal (``assert_array_equal``).
The distances are equal too, with one exception that is XLA's and not the
port's: some of XLA's CPU loops (the scalar tail of each parallel
partition; the whole loop under ``vmap``) fuse ``dx*dx + dy*dy + dz*dz``
into ``fma(dz, dz, fma(dx, dx, dy*dy))``, while its other loops and the
port round each operation. Where the two differ, the JAX distance must be
exactly the fused rounding of the same (source, target) pair and the
port's exactly the unfused one (both recomputed here in extended
precision, with correctly rounded square roots). An align with the grid is
held to the JAX align at 1 mm / 0.2 mrad with equal iteration counts.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mola_fe_lidar_tpu.cloud.metric_map import PointCloud as JPointCloud
from mola_fe_lidar_tpu.geometry import se3 as jse3
from mola_fe_lidar_tpu.models import config as jconfig
from mola_fe_lidar_tpu.ops import grid_nn as jgrid
from mola_fe_lidar_tpu.parallel.batch import make_batched_align
from mola_fe_lidar_tpu_torch.geometry import se3
from mola_fe_lidar_tpu_torch.models import config, icp
from mola_fe_lidar_tpu_torch.obs.scan_pairs import make_pairs, stack_pairs
from mola_fe_lidar_tpu_torch.ops import grid_nn

torch.set_num_threads(1)
_L = np.longdouble


def _f32(x):
    return np.float32(x)


def _unfused(d):
    x, y, z = d
    return _f32(_f32(_f32(x * x) + _f32(y * y)) + _f32(z * z))


def _fused(d):
    x, y, z = (_L(v) for v in d)
    inner = _f32(x * x + _L(_f32(d[1] * d[1])))
    return _f32(z * z + _L(inner))


def assert_dist_equal(port, ref, src, tgt, idx):
    """Equal distances, or the two roundings of one pair (module doc)."""
    port, ref = np.asarray(port), np.asarray(ref)
    for i in np.flatnonzero(port != ref):
        d = (tgt[idx[i]] - src[i]).astype(np.float32)
        assert port[i] == np.sqrt(_unfused(d)) and ref[i] == np.sqrt(_fused(d)), (
            i, port[i], ref[i])


def _case(name, rng):
    if name == "masked":  # masked sources and targets, sentinels beyond the cell
        src = (rng.standard_normal((400, 3)) * 15).astype(np.float32)
        tgt = (rng.standard_normal((800, 3)) * 15).astype(np.float32)
        return (src, (rng.random(400) > 0.1).astype(np.float32), tgt,
                (rng.random(800) > 0.1).astype(np.float32), 2.0, 8)
    if name == "bucket_overflow":  # ~31 points a cell in buckets of 8
        src = (rng.random((200, 3)) * 4).astype(np.float32)
        tgt = (rng.random((2000, 3)) * 4).astype(np.float32)
        return src, np.ones(200, np.float32), tgt, np.ones(2000, np.float32), 1.0, 8
    if name == "all_masked":  # origin near 1e9: saturating cell casts
        src = (rng.standard_normal((300, 3)) * 5).astype(np.float32)
        tgt = (rng.standard_normal((500, 3)) * 5).astype(np.float32)
        return src, np.ones(300, np.float32), tgt, np.zeros(500, np.float32), 0.1, 8
    # cells past 2^31 / P: the int32 products wrap; every other source has
    # a target a few mm away
    src = (rng.standard_normal((300, 3)) * 3e3).astype(np.float32)
    near = src[rng.permutation(300)[:150]] + rng.standard_normal((150, 3)).astype(np.float32) * 3e-3
    tgt = np.concatenate([near, (rng.standard_normal((450, 3)) * 3e3)]).astype(np.float32)
    return src, np.ones(300, np.float32), tgt, np.ones(600, np.float32), 0.01, 8


@pytest.mark.parametrize("name", ["masked", "bucket_overflow", "all_masked", "hash_overflow"])
def test_grid_matches_reference(name):
    src, smask, tgt, tmask, cell, bucket = _case(name, np.random.default_rng(0))
    j = [jnp.asarray(a) for a in (src, smask, tgt, tmask)]
    t = [torch.from_numpy(a) for a in (src, smask, tgt, tmask)]
    jg = jgrid.build_grid(j[2], j[3], cell, bucket=bucket)
    g = grid_nn.build_grid(t[2], t[3], cell, bucket=bucket)
    np.testing.assert_array_equal(g.table.numpy(), np.asarray(jg.table))
    np.testing.assert_array_equal(g.origin.numpy(), np.asarray(jg.origin))
    for got, want in ((grid_nn.grid_nearest_neighbors(t[0], t[1], g, t[2], t[3]),
                       jgrid.grid_nearest_neighbors(j[0], j[1], jg, j[2], j[3])),
                      (grid_nn.grid_nn(*t, cell=cell, bucket=bucket),
                       jgrid.grid_nn(*j, cell=cell, bucket=bucket))):
        np.testing.assert_array_equal(got.idx.numpy(), np.asarray(want.idx))
        assert_dist_equal(got.dist.numpy(), want.dist, src, tgt, np.asarray(want.idx))
    found = got.dist.numpy() < 1e10
    if name == "all_masked":
        assert not found.any() and (g.table.numpy() == -1).all()
    elif name == "bucket_overflow":
        assert (g.table.numpy() >= 0).all(axis=-1).any()  # full buckets
    else:
        assert 0 < found.mean() < 1


def test_grid_lanes_match_reference():
    """Per-lane targets against the JAX functions under ``vmap``; a target
    shared by every lane (stride-0 expand) is built once and answers as
    the unbatched search does."""
    rng = np.random.default_rng(1)
    B, n, m, cell = 3, 256, 512, 1.5
    src = (rng.standard_normal((B, n, 3)) * 6).astype(np.float32)
    tgt = (rng.standard_normal((B, m, 3)) * 6).astype(np.float32)
    smask = (rng.random((B, n)) > 0.1).astype(np.float32)
    tmask = (rng.random((B, m)) > 0.1).astype(np.float32)
    jg = jax.vmap(lambda a, b: jgrid.build_grid(a, b, cell))(jnp.asarray(tgt), jnp.asarray(tmask))
    g = grid_nn.build_grid(torch.from_numpy(tgt), torch.from_numpy(tmask), cell)
    np.testing.assert_array_equal(g.table.numpy(), np.asarray(jg.table))
    np.testing.assert_array_equal(g.origin.numpy(), np.asarray(jg.origin))
    want = jax.vmap(jgrid.grid_nearest_neighbors)(
        jnp.asarray(src), jnp.asarray(smask), jg, jnp.asarray(tgt), jnp.asarray(tmask))
    got = grid_nn.grid_nearest_neighbors(torch.from_numpy(src), torch.from_numpy(smask), g,
                                         torch.from_numpy(tgt), torch.from_numpy(tmask))
    np.testing.assert_array_equal(got.idx.numpy(), np.asarray(want.idx))
    for b in range(B):
        assert_dist_equal(got.dist[b].numpy(), np.asarray(want.dist)[b], src[b], tgt[b],
                          np.asarray(want.idx)[b])

    t0, m0 = torch.from_numpy(tgt[0]), torch.from_numpy(tmask[0])
    shared = grid_nn.build_grid(t0.expand(B, m, 3), m0.expand(B, m), cell)
    assert shared.table.stride(0) == 0
    one = grid_nn.build_grid(t0, m0, cell)
    lanes = grid_nn.grid_nn(torch.from_numpy(src), torch.from_numpy(smask), t0.expand(B, m, 3),
                            m0.expand(B, m), cell)
    for b in range(B):
        r = grid_nn.grid_nearest_neighbors(torch.from_numpy(src[b]), torch.from_numpy(smask[b]),
                                           one, t0, m0)
        assert torch.equal(lanes.idx[b], r.idx) and torch.equal(lanes.dist[b], r.dist)


def _jmap(pc):
    return {"raw": JPointCloud(jnp.asarray(pc.xyz.numpy()), jnp.asarray(pc.mask.numpy()), {})}


def test_align_with_grid_matches_reference():
    """A batched point-to-point align (each lane its own pair) with
    ``nn_backend="grid"`` against the JAX package's ``vmap`` of it."""
    B, cap = 3, 1024
    src, tgt, _ = stack_pairs(make_pairs(np.random.default_rng(3), B, cap), cap, device="cpu")

    def params(mod):
        return mod.ICPParams(
            max_iterations=30,
            matchers=(mod.Matcher(kind="point2point", distance_threshold=1.0, nn_backend="grid"),),
            solver=mod.Solver(kind="gauss_newton", max_iterations=10),
            quality=(mod.Quality(threshold_distance=0.3),),
            weights=mod.PairWeights(use_scale_outlier_detector=False))

    res = icp.align(src, tgt, se3.Pose(torch.eye(3).expand(B, 3, 3), torch.zeros(B, 3)),
                    params(config))
    jres = make_batched_align(params(jconfig))(
        _jmap(src["raw"]), _jmap(tgt["raw"]),
        jse3.Pose(jnp.broadcast_to(jnp.eye(3), (B, 3, 3)), jnp.zeros((B, 3))))
    dR = np.swapaxes(res.pose.R.numpy().astype(np.float64), -1, -2) @ np.asarray(jres.pose.R,
                                                                                  np.float64)
    ang = np.arccos(np.clip((np.trace(dR, axis1=-2, axis2=-1) - 1) / 2, -1, 1))
    assert np.abs(res.pose.t.numpy() - np.asarray(jres.pose.t)).max() < 1e-3
    assert ang.max() < 2e-4
    np.testing.assert_array_equal(res.n_iterations.numpy(), np.asarray(jres.n_iterations))
    np.testing.assert_allclose(res.quality.numpy(), np.asarray(jres.quality), atol=2.0 / cap)
