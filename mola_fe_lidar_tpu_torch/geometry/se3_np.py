"""Host-side (numpy) SE(3) mirror of :mod:`se3` for frontend bookkeeping.

The front-end does O(1)-sized pose math per scan (twist update, odometry
accumulation, KF thresholds). Doing that with device tensors costs a
launch and a readback per op; these numpy twins keep the host bookkeeping
on the host. Same conventions as :mod:`se3`
(tau = [v, w], f64 for accumulation stability).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

Pose = Tuple[np.ndarray, np.ndarray]  # (R 3x3, t 3)


def _hat(w):
    return np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]])


def exp(tau: np.ndarray) -> Pose:
    v, w = np.asarray(tau[:3], float), np.asarray(tau[3:], float)
    th = np.linalg.norm(w)
    W = _hat(w)
    if th < 1e-8:
        R = np.eye(3) + W + 0.5 * W @ W
        V = np.eye(3) + 0.5 * W
    else:
        A = np.sin(th) / th
        B = (1 - np.cos(th)) / th**2
        C = (th - np.sin(th)) / th**3
        R = np.eye(3) + A * W + B * W @ W
        V = np.eye(3) + B * W + C * W @ W
    return R, V @ v


def log(R: np.ndarray, t: np.ndarray) -> np.ndarray:
    tr = np.clip((np.trace(R) - 1) / 2, -1, 1)
    th = np.arccos(tr)
    if th < 1e-6:
        w = 0.5 * np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    elif th > np.pi - 1e-4:
        # symmetric-part axis recovery
        aa = np.eye(3) + (0.5 * (R + R.T) - np.eye(3)) / (1 - tr)
        k = int(np.argmax(np.diag(aa)))
        a = aa[:, k] / np.sqrt(max(aa[k, k], 1e-12))
        w = th * a / max(np.linalg.norm(a), 1e-12)
    else:
        w = (th / (2 * np.sin(th))) * np.array(
            [R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    W = _hat(w)
    th2 = float(w @ w)
    if th2 < 1e-10:
        Vinv = np.eye(3) - 0.5 * W + (1.0 / 12.0) * W @ W
    else:
        th = np.sqrt(th2)
        A = np.sin(th) / th
        B = (1 - np.cos(th)) / th2
        Vinv = np.eye(3) - 0.5 * W + ((1 - A / (2 * B)) / th2) * W @ W
    return np.concatenate([Vinv @ t, w])


def rotation_angle(R: np.ndarray) -> float:
    return float(np.arccos(np.clip((np.trace(R) - 1) / 2, -1, 1)))


def orthonormalize(R: np.ndarray) -> np.ndarray:
    """Nearest rotation matrix (Frobenius) via SVD projection.

    Device aligns return f32 rotations with ~1e-5 orthonormality error
    (up to 100 f32 retraction composes inside the ICP loop). Chaining
    hundreds of them into the world pose compounds to det(R) drift of
    ~1e-3 per 500 scans, which shears map-building transforms and
    inflates trace-based rotation metrics — re-project at every host
    accumulation point.
    """
    U, _, Vt = np.linalg.svd(np.asarray(R, float))
    D = np.diag([1.0, 1.0, float(np.sign(np.linalg.det(U @ Vt)))])
    return U @ D @ Vt


def compose(a: Pose, b: Pose) -> Pose:
    Ra, ta = a
    Rb, tb = b
    return Ra @ Rb, Ra @ tb + ta


def inverse(p: Pose) -> Pose:
    R, t = p
    return R.T, -R.T @ t
