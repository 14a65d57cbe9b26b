"""Port parity: SE(3) on tensors (mola_fe_lidar_tpu_torch.geometry) against
the JAX reference (mola_fe_lidar_tpu.geometry), on the same numpy inputs.

Tolerances: both sides evaluate the same f32 formulas; transcendental
implementations differ by an ulp or two, and the near-0/near-pi branches
amplify that into ~1e-5 relative, so 2e-5 absolute on unit-scale values.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mola_fe_lidar_tpu.geometry import se3 as jse3
from mola_fe_lidar_tpu.geometry import se3_np as jse3_np
import mola_fe_lidar_tpu_torch  # noqa: F401 -- sets the TF32 flags
from mola_fe_lidar_tpu_torch.geometry import se3, se3_np

torch.set_num_threads(1)
ATOL = 2e-5


def _taus(rng):
    """Random twists plus the branch edges: θ = 0, θ² just under/over the
    1e-5 Taylor cutoff, and θ within 1e-4 of π."""
    taus = [rng.standard_normal(6) * s for s in (0.1, 1.0)]
    for theta in (0.0, 1e-4, 3.0e-3, 3.2e-3, 0.5, np.pi - 1e-4, np.pi - 5e-4):
        axis = rng.standard_normal(3)
        axis /= np.linalg.norm(axis)
        taus.append(np.concatenate([rng.standard_normal(3), theta * axis]))
    return np.stack(taus).astype(np.float32)


def _pose_t(tau):
    return se3.exp(torch.from_numpy(tau))


def _pose_j(tau):
    return jse3.exp(jnp.asarray(tau))


def test_exp_matches_reference(rng):
    tau = _taus(rng)
    pt, pj = _pose_t(tau), _pose_j(tau)
    np.testing.assert_allclose(pt.R.numpy(), np.asarray(pj.R), atol=ATOL)
    np.testing.assert_allclose(pt.t.numpy(), np.asarray(pj.t), atol=ATOL)


def test_log_matches_reference_including_small_and_near_pi(rng):
    tau = _taus(rng)
    pj = _pose_j(tau)
    Rn, tn = np.array(pj.R), np.array(pj.t)
    lt = se3.log(se3.Pose(torch.from_numpy(Rn), torch.from_numpy(tn))).numpy()
    lj = np.asarray(jse3.log(jse3.Pose(jnp.asarray(Rn), jnp.asarray(tn))))
    # near π, arccos of a trace near -1 leaves θ only ~sqrt(f32 eps) ≈ 3e-4
    # accurate in either package, so those rows get 1e-3
    near_pi = np.linalg.norm(tau[:, 3:], axis=1) > np.pi - 1e-3
    np.testing.assert_allclose(lt[~near_pi], lj[~near_pi], atol=1e-4)
    np.testing.assert_allclose(lt[near_pi], lj[near_pi], atol=1e-3)


def test_compose_inverse_transform(rng):
    a_tau, b_tau = _taus(rng), _taus(rng)
    pts = (rng.standard_normal((len(a_tau), 50, 3)) * 30).astype(np.float32)
    at, bt, aj, bj = _pose_t(a_tau), _pose_t(b_tau), _pose_j(a_tau), _pose_j(b_tau)
    ct, cj = se3.compose(at, se3.inverse(bt)), jse3.compose(aj, jse3.inverse(bj))
    np.testing.assert_allclose(ct.R.numpy(), np.asarray(cj.R), atol=ATOL)
    np.testing.assert_allclose(ct.t.numpy(), np.asarray(cj.t), atol=1e-4)
    xt = se3.transform(at, torch.from_numpy(pts)).numpy()
    xj = np.asarray(jse3.transform(aj, jnp.asarray(pts)))
    np.testing.assert_allclose(xt, xj, atol=1e-4)  # 30 m points: 1e-4 m


def test_rotation_angle(rng):
    tau = _taus(rng)
    np.testing.assert_allclose(se3.rotation_angle(_pose_t(tau)).numpy(),
                               np.asarray(jse3.rotation_angle(_pose_j(tau))), atol=1e-4)


def test_numpy_mirror_is_the_reference_copy(rng):
    for tau in _taus(rng).astype(np.float64):
        R, t = se3_np.exp(tau)
        Rj, tj = jse3_np.exp(tau)
        np.testing.assert_array_equal(R, Rj)
        np.testing.assert_array_equal(t, tj)
        np.testing.assert_array_equal(se3_np.log(R, t), jse3_np.log(R, t))


def test_tf32_is_off_after_import():
    # the reference pins precision="highest" on metric contractions
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


@pytest.mark.parametrize("theta_sq", [0.0, 5e-6, 2e-5])
def test_sinc_coeffs_branch(theta_sq):
    A, B, C = se3._sinc_coeffs(torch.tensor([theta_sq], dtype=torch.float32))
    Aj, Bj, Cj = jse3._sinc_coeffs(jnp.asarray([theta_sq], jnp.float32))
    for x, y in ((A, Aj), (B, Bj), (C, Cj)):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), rtol=1e-5)
