"""Port parity: the closed-form 3x3 algebra, the pairing re-weighting and the
closed-form solvers (mola_fe_lidar_tpu_torch.{ops.eigen3, solve.robust,
solve.horn, solve.olae}) against the JAX package on the same seeded numpy
inputs.

Tolerances: element-wise f32 formulas agree to a few ulps; poses within
1e-5 (rotation entries and metres). Horn's rotation is compared as a
rotation: the SVDs may pick other signs and orders of their vectors, which
changes nothing where the rotation is unique (rank ≥ 2). The scale-outlier
gate is compared away from its threshold: a ratio within f32 round-off of
it may fall either way.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mola_fe_lidar_tpu.ops import eigen3 as jeigen3
from mola_fe_lidar_tpu.solve import horn as jhorn
from mola_fe_lidar_tpu.solve import olae as jolae
from mola_fe_lidar_tpu.solve import robust as jrobust
from mola_fe_lidar_tpu_torch.geometry import se3
from mola_fe_lidar_tpu_torch.ops import eigen3
from mola_fe_lidar_tpu_torch.solve import horn, olae, robust

torch.set_num_threads(1)


def _t(x):
    return torch.from_numpy(np.array(x))


def _spd(rng, n=400):
    B = rng.standard_normal((n, 3, 3)).astype(np.float32)
    A = B @ np.swapaxes(B, 1, 2)
    line = np.outer([1.0, 2.0, 0.5], [1.0, 2.0, 0.5]).astype(np.float32)
    return np.concatenate([A, line[None] + 1e-3 * np.eye(3, dtype=np.float32)[None]])


def test_eigen3_extras(rng):
    A = _spd(rng)
    ev = np.sort(rng.uniform(0, 2, (500, 3)).astype(np.float32), axis=1)
    ev[:50, 1] = ev[:50, 2] * 1e-4  # line-like spectra: gated to 0
    np.testing.assert_allclose(eigen3.planarity_score_3x3(_t(ev)).numpy(),
                               np.asarray(jeigen3.planarity_score_3x3(jnp.asarray(ev))),
                               rtol=1e-6, atol=1e-7)
    L = eigen3.cholesky_3x3(_t(A)).numpy()
    Lj = np.asarray(jeigen3.cholesky_3x3(jnp.asarray(A)))
    np.testing.assert_allclose(L, Lj, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(eigen3.invert_lower_3x3(_t(Lj)).numpy(),
                               np.asarray(jeigen3.invert_lower_3x3(jnp.asarray(Lj))),
                               rtol=1e-5, atol=1e-5)


def test_neighbourhood_covariance_rounds_like_the_reference(rng):
    """The centroid and covariance of kNN neighbourhoods, bit for bit, as
    the reference computes them (``_attach_normals_knn``)."""
    import jax

    neigh = (rng.standard_normal((3000, 6, 3)) * np.float32([0.02, 0.02, 1.0])
             + rng.uniform(-30, 30, (3000, 1, 3))).astype(np.float32)
    valid = (rng.uniform(size=(3000, 6)) > 0.1).astype(np.float32)

    def ref(nb, v):
        cnt = jnp.maximum(jnp.sum(v, axis=-1), 1.0)
        c = jnp.sum(nb * v[..., None], axis=-2) / cnt[..., None]
        d = (nb - c[..., None, :]) * v[..., None]
        return cnt, c, jnp.einsum("...ki,...kj->...ij", d, d, precision="highest") / cnt[
            ..., None, None]

    got = eigen3.neighbourhood_covariance(_t(neigh), _t(valid))
    want = jax.jit(ref)(jnp.asarray(neigh), jnp.asarray(valid))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("kernel", sorted(jrobust.ROBUST_KERNELS))
@pytest.mark.parametrize("scale", [1.0, 400.0])
def test_robust_kernels(rng, kernel, scale):
    r = np.concatenate([rng.standard_normal(1000) * 0.3, [0.0, 0.2, -0.2, 5.0]]).astype(np.float32)
    got = robust.robust_weights(_t(r), kernel, 0.2, scale).numpy()
    want = np.asarray(jrobust.robust_weights(jnp.asarray(r), kernel, 0.2, scale))
    np.testing.assert_allclose(got, want, rtol=2e-6, atol=1e-7)
    with pytest.raises(ValueError):
        robust.robust_weights(_t(r), "nope", 0.2)


def test_scale_outlier_weights(rng):
    p = rng.uniform(-20, 20, (2, 3000, 3)).astype(np.float32)
    q = p + rng.normal(0, 0.01, p.shape).astype(np.float32)
    q[:, ::7] *= rng.uniform(0.5, 2.0, (2, q[:, ::7].shape[1], 1)).astype(np.float32)
    w = (rng.uniform(size=(2, 3000)) > 0.2).astype(np.float32)
    got = robust.scale_outlier_weights(_t(p), _t(q), _t(w), 1.1).numpy()
    want = np.asarray(jrobust.scale_outlier_weights(jnp.asarray(p), jnp.asarray(q),
                                                    jnp.asarray(w), 1.1))
    # the ratio each pairing is gated on, in f64: compare away from 1.1
    mu = lambda x: (x * w[..., None]).sum(-2, keepdims=True) / w.sum(-1)[..., None, None]
    ds = np.linalg.norm(p.astype(np.float64) - mu(p.astype(np.float64)), axis=-1)
    dt = np.linalg.norm(q.astype(np.float64) - mu(q.astype(np.float64)), axis=-1)
    ratio = np.maximum(ds, dt) / np.maximum(np.minimum(ds, dt), 1e-6)
    clear = np.abs(ratio - 1.1) > 1e-5
    assert clear.mean() > 0.99 and 0.05 < (want[clear] == 0).mean() < 0.5
    np.testing.assert_array_equal(got[clear], want[clear])


def _pairings(rng, n=200, kind="general"):
    p = (rng.standard_normal((n, 3)) * [10.0, 6.0, 2.0]).astype(np.float32)
    if kind == "planar":
        p[:, 2] = 0.0
    axis = rng.standard_normal(3)
    angle = 0.7 if kind != "small" else 1e-3
    R = se3.exp(torch.tensor(np.r_[rng.standard_normal(3) * 3, axis / np.linalg.norm(axis) * angle],
                             dtype=torch.float32))
    q = (p @ R.R.numpy().T + R.t.numpy() + rng.normal(0, 0.01, p.shape)).astype(np.float32)
    if kind == "reflected":
        q = -q  # the best proper rotation needs the reflection guard
    w = rng.uniform(0.1, 1.0, n).astype(np.float32)
    w[rng.uniform(size=n) < 0.1] = 0.0
    return p, q, w


# OLAE's Cayley parameters are singular at 180 degrees: no reflected case
@pytest.mark.parametrize("solver, kind", [
    ("horn", "general"), ("horn", "planar"), ("horn", "reflected"), ("horn", "small"),
    ("olae", "general"), ("olae", "planar"), ("olae", "small")])
def test_closed_form_solvers(rng, solver, kind):
    p, q, w = _pairings(rng, kind=kind)
    f, jf = ((horn.weighted_horn, jhorn.weighted_horn) if solver == "horn"
             else (olae.weighted_olae, jolae.weighted_olae))
    got = f(_t(p), _t(q), _t(w))
    want = jf(jnp.asarray(p), jnp.asarray(q), jnp.asarray(w))
    np.testing.assert_allclose(got.R.numpy(), np.asarray(want.R), atol=1e-5)
    np.testing.assert_allclose(got.t.numpy(), np.asarray(want.t), rtol=1e-5, atol=1e-5)
    assert abs(np.linalg.det(got.R.numpy()) - 1.0) < 1e-5


@pytest.mark.parametrize("solver", ["horn", "olae"])
def test_closed_form_solvers_batched_and_degenerate(rng, solver):
    f = horn.weighted_horn if solver == "horn" else olae.weighted_olae
    lanes = [_pairings(rng, n=64) for _ in range(3)]
    p, q, w = (np.stack([x[i] for x in lanes]) for i in range(3))
    w[1] = 0.0  # no weight: identity
    got = f(_t(p), _t(q), _t(w))
    np.testing.assert_array_equal(got.R[1].numpy(), np.eye(3, dtype=np.float32))
    np.testing.assert_array_equal(got.t[1].numpy(), np.zeros(3, np.float32))
    for b in (0, 2):
        one = f(_t(p[b]), _t(q[b]), _t(w[b]))
        np.testing.assert_allclose(got.R[b].numpy(), one.R.numpy(), atol=1e-6)
        np.testing.assert_allclose(got.t[b].numpy(), one.t.numpy(), atol=1e-5)


def test_horn_collinear_pairings_give_a_rotation_that_fits(rng):
    """Rank 1: the rotation about the line is free (the reference's SVD
    picks one); the port's must still be proper and map the line."""
    d = np.float32([1.0, 2.0, -0.5])
    p = (rng.uniform(-5, 5, (50, 1)) * d).astype(np.float32)
    w = np.ones(50, np.float32)
    got = horn.weighted_horn(_t(p), _t(p + 1.0), _t(w))
    assert abs(np.linalg.det(got.R.numpy()) - 1.0) < 1e-5
    mapped = p @ got.R.numpy().T + got.t.numpy()
    np.testing.assert_allclose(mapped, p + 1.0, atol=1e-4)


def test_point_to_point_normal_matrix(rng):
    p, _, w = _pairings(rng)
    pose = se3.exp(torch.tensor([0.3, -0.2, 0.1, 0.05, -0.02, 0.4]))
    got = horn.point_to_point_normal_matrix(_t(p), pose, _t(w)).numpy()
    jpose = jhorn.se3.Pose(jnp.asarray(pose.R.numpy()), jnp.asarray(pose.t.numpy()))
    want = np.asarray(jhorn.point_to_point_normal_matrix(jnp.asarray(p), jpose, jnp.asarray(w)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())
