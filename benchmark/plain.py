"""Plain float64 helpers for the configurations' references: exact k
nearest neighbours and the angle between rotations. Plain PyTorch and
numpy; nothing of the program."""

from __future__ import annotations

import numpy as np
import torch

F64 = torch.float64


def rotation_gap(Ra: np.ndarray, Rb: np.ndarray) -> float:
    """The angle between two rotations, from the skew part of Ra^T Rb
    (well conditioned near zero, where the trace's arccos is not)."""
    A = np.asarray(Ra, np.float64).T @ np.asarray(Rb, np.float64)
    s = 0.5 * np.linalg.norm([A[2, 1] - A[1, 2], A[0, 2] - A[2, 0], A[1, 0] - A[0, 1]])
    return float(np.arcsin(min(1.0, s)))


def knn(p: torch.Tensor, m: torch.Tensor, k: int) -> torch.Tensor:
    """Indices [R, k] of the ``k`` nearest points of ``m`` [M, 3] to each
    row of ``p`` [R, 3], nearest first: f32 candidates from the expanded
    squared distance on centred coordinates (TF32 off), ranked exactly in
    float64."""
    center = m.to(F64).mean(0)
    q = (p.to(F64) - center).to(torch.float32)
    qn = (q * q).sum(-1, keepdim=True)
    pre = min(k + 4, m.shape[0])
    chunk = max(4096, (1 << 28) // max(1, q.shape[0]))
    best_d = best_i = None
    for s in range(0, m.shape[0], chunk):
        mc = (m[s:s + chunk].to(F64) - center).to(torch.float32)
        d = torch.addmm(qn + (mc * mc).sum(-1)[None], q, mc.T, alpha=-2.0)
        dk, ik = torch.topk(d, min(pre, d.shape[1]), dim=1, largest=False)
        if best_d is None:
            best_d, best_i = dk, ik + s
        else:
            cd, ci = torch.cat([best_d, dk], 1), torch.cat([best_i, ik + s], 1)
            o = torch.topk(cd, pre, dim=1, largest=False).indices
            best_d, best_i = torch.gather(cd, 1, o), torch.gather(ci, 1, o)
    exact = ((m[best_i].to(F64) - p.to(F64)[:, None]) ** 2).sum(-1)
    # nearest first, ties to the lower index
    order = torch.argsort(best_i, dim=1)
    exact, best_i = torch.gather(exact, 1, order), torch.gather(best_i, 1, order)
    o = torch.argsort(exact, dim=1, stable=True)[:, :k]
    return torch.gather(best_i, 1, o)
