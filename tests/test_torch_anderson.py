"""Port parity for Anderson-accelerated ICP (``ICPParams.anderson_m``):
aligns of bench.py's scan pairs through ``icp_settings_regular`` with
``anderson_m=5`` (the configuration ``chip_smoke.py`` runs on the card),
one at a time and as a batch of lanes against the reference's ``vmap`` of
``align``; the first iterates on a slowly contracting (damped) map; and
the configuration error with candidate-cached matchers.

Inputs: bench.py's pairs (the port's copy of ``make_pairs``, seed 7) and a
structured scene (ground, two walls, scatter), made from seeds with numpy.

Tolerances: poses within 1 mm / 0.2 mrad and iteration counts within 1
(measured: 3e-6 m and equal counts). The damped map is compared over its
first three iterations only: there the extrapolation solves an ``m x m``
system whose f32 condition number reaches 1e7, and the reference itself
moves by up to 2 mm and 17 to 60 iterations when its initial guess moves
by 1e-7 m -- no f32 implementation can follow it further.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mola_fe_lidar_tpu.cloud.metric_map import from_points as jfrom_points
from mola_fe_lidar_tpu.geometry import se3 as jse3
from mola_fe_lidar_tpu.models import icp as jicp
from mola_fe_lidar_tpu.models import presets as jpresets
from mola_fe_lidar_tpu_torch.cloud.metric_map import PointCloud, from_points
from mola_fe_lidar_tpu_torch.geometry import se3
from mola_fe_lidar_tpu_torch.models import icp, presets
from mola_fe_lidar_tpu_torch.models.config import ICPParams, Matcher, PairWeights, Solver
from mola_fe_lidar_tpu_torch.obs.scan_pairs import make_pairs, pair_clouds
from mola_fe_lidar_tpu_torch.parallel import batch

torch.set_num_threads(1)

N = 1024
REGULAR = dataclasses.replace(presets.icp_settings_regular(), anderson_m=5)
JREGULAR = dataclasses.replace(jpresets.icp_settings_regular(), anderson_m=5)
# heavy Levenberg damping turns the outer loop into a slow linear
# contraction, the regime the accelerator is for
SLOW = ICPParams(
    max_iterations=3,
    matchers=(Matcher(kind="point2plane_knn", distance_threshold=2.0, knn=6,
                      plane_eigen_threshold=0.1),),
    solver=Solver(kind="gauss_newton", max_iterations=1, damping=0.1),
    weights=PairWeights(use_scale_outlier_detector=False),
    anderson_m=4)


def _world(rng, n=1024, extent=20.0):
    k = n // 4
    ground = np.stack([rng.uniform(-extent, extent, k), rng.uniform(-extent, extent, k),
                       rng.normal(0, 0.02, k)], -1)
    wall1 = np.stack([rng.uniform(-extent, extent, k),
                      np.full(k, extent) + rng.normal(0, 0.02, k), rng.uniform(0, 5, k)], -1)
    wall2 = np.stack([np.full(k, -extent) + rng.normal(0, 0.02, k),
                      rng.uniform(-extent, extent, k), rng.uniform(0, 5, k)], -1)
    scatter = rng.uniform(-extent, extent, (n - 3 * k, 3)) * np.array([1.0, 1.0, 0.1])
    return np.concatenate([ground, wall1, wall2, scatter]).astype(np.float32)


def _maps(src, tgt, cap=N):
    return ({"raw": from_points(src, capacity=cap, device="cpu")},
            {"raw": from_points(tgt, capacity=cap, device="cpu")},
            {"raw": jfrom_points(src, capacity=cap)}, {"raw": jfrom_points(tgt, capacity=cap)})


def _scene_pair(seed, tau, cap=N):
    """A scene and the scene seen from exp(tau)."""
    world = _world(np.random.default_rng(seed), n=cap)
    true = se3.exp(torch.tensor(tau, dtype=torch.float64))
    R, t = true.R.numpy(), true.t.numpy()
    return _maps(((world - t) @ R).astype(np.float32), world, cap)


def _bench_pairs(n):
    return pair_clouds(make_pairs(np.random.default_rng(7), n, N))[:2]


def _eye(lanes=()):
    eye = np.broadcast_to(np.eye(3, dtype=np.float32), (*lanes, 3, 3)).copy()
    zero = np.zeros((*lanes, 3), np.float32)
    return (se3.Pose(torch.from_numpy(eye), torch.from_numpy(zero)),
            jse3.Pose(jnp.asarray(eye), jnp.asarray(zero)))


def _close(res, jres):
    R = res.pose.R.numpy().astype(np.float64)
    dR = np.swapaxes(R, -1, -2) @ np.asarray(jres.pose.R, np.float64)
    skew = np.linalg.norm(dR - np.swapaxes(dR, -1, -2), axis=(-2, -1)) / (2 * np.sqrt(2))
    assert np.all(skew < 2e-4)  # sin of the angle
    assert np.all(np.linalg.norm(res.pose.t.numpy() - np.asarray(jres.pose.t), axis=-1) < 1e-3)
    n_it, jn_it = res.n_iterations.numpy(), np.asarray(jres.n_iterations)
    assert np.all(np.abs(n_it.astype(int) - jn_it.astype(int)) <= 1), (n_it, jn_it)


@pytest.mark.parametrize("case", ["pairs", "damped"])
def test_anderson_align_matches_reference(case):
    pose, jpose = _eye()
    if case == "pairs":
        srcs, tgts = _bench_pairs(4)
        runs = [(_maps(s, t), REGULAR, JREGULAR) for s, t in zip(srcs, tgts)]
    else:
        runs = [(_scene_pair(3, [0.5, -0.3, 0.05, 0.0, 0.01, 0.06]), SLOW, SLOW)]
    for (s, t, js, jt), params, jparams in runs:
        res = icp.align(s, t, pose, params)
        _close(res, jicp.align(js, jt, jpose, jparams))
        # the accelerator changed the iterates
        plain = icp.align(s, t, pose, dataclasses.replace(params, anderson_m=0))
        assert not torch.equal(plain.pose.t, res.pose.t)


def test_anderson_lanes_match_reference():
    """Six lanes against the reference's vmap: each lane's history and
    freezing are its own."""
    srcs, tgts = _bench_pairs(6)
    stack = lambda clouds: {"raw": PointCloud(*(torch.stack(x) for x in zip(
        *((pc.xyz, pc.mask) for pc in clouds))), {})}
    s = stack([from_points(x, capacity=N, device="cpu") for x in srcs])
    t = stack([from_points(x, capacity=N, device="cpu") for x in tgts])
    jstack = lambda clouds: {"raw": jax.tree.map(lambda *x: jnp.stack(x), *clouds)}
    js = jstack([jfrom_points(x, capacity=N) for x in srcs])
    jt = jstack([jfrom_points(x, capacity=N) for x in tgts])
    pose, jpose = _eye((6,))
    res = batch.batched_align(s, t, pose, REGULAR)
    jres = jax.vmap(lambda a, b, p: jicp.align(a, b, p, JREGULAR))(js, jt, jpose)
    _close(res, jres)
    assert len(set(res.n_iterations.tolist())) > 1  # the lanes stop apart


def test_anderson_with_candidate_cache_raises():
    s, t, js, jt = _scene_pair(1, [0.0] * 6, cap=512)
    bad = ICPParams(matchers=(Matcher(kind="point2point", cand_k=8),), anderson_m=4)
    pose, jpose = _eye()
    with pytest.raises(ValueError, match="anderson_m"):
        jicp.align(js, jt, jpose, bad)
    with pytest.raises(ValueError, match="anderson_m"):
        icp.align(s, t, pose, bad)
