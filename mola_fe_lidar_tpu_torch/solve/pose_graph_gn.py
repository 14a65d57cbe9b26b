"""SE(3) pose-graph optimization by Levenberg-Marquardt on tensors (port of
``mola_fe_lidar_tpu/solve/pose_graph_gn.py``).

Right-perturbation Gauss-Newton with the standard SLAM linearization: the
residual of edge e is ``r_e = log(Z_e^-1 X_i^-1 X_j)``, with Jacobians
``Jr_inv(r)`` for node j and ``-Jr_inv(r) Ad(X_j^-1 X_i)`` for node i, and
``Jr_inv(r) ~ I + ad(r)/2``. The normal system is a dense ``[6N, 6N]``
matrix assembled by 6x6 block ``index_add_``; node 0 is the gauge: its rows
and columns are zeroed and its diagonal set to one, so it never moves. Each
LM step solves the damped system by Cholesky (``cholesky_ex``, which reads
no status back to the host), accepts the step if the cost fell and adapts
the damping; a failed factorization gives a non-finite cost and a rejected
step. ``robust`` re-weights edges by an IRLS M-estimator (Huber or Cauchy)
of their whitened residual norm. The reference pads nodes and edges to
fixed buckets for its compiler; the port takes the graph as it is.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..geometry import se3


def _jr_inv(r: torch.Tensor) -> torch.Tensor:
    """Inverse right Jacobian of SE(3) to second order, ``I + ad(r)/2``,
    in the [v, w] tangent layout."""
    hw, hv = se3.hat(r[..., 3:]), se3.hat(r[..., :3])
    ad = torch.cat([torch.cat([hw, hv], dim=-1),
                    torch.cat([torch.zeros_like(hw), hw], dim=-1)], dim=-2)
    return torch.eye(6, dtype=r.dtype, device=r.device) + 0.5 * ad


def _adjoint(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """SE(3) adjoint in [v, w] layout: ``[[R, hat(t) R], [0, R]]``."""
    return torch.cat([torch.cat([R, se3.hat(t) @ R], dim=-1),
                      torch.cat([torch.zeros_like(R), R], dim=-1)], dim=-2)


def _edge_residuals(nodes: se3.Pose, e_from, e_to, rel: se3.Pose):
    """``r_e = log(Z_e^-1 X_i^-1 X_j)`` of every edge, and ``X_i^-1 X_j``."""
    Xi = se3.Pose(nodes.R[e_from], nodes.t[e_from])
    Xj = se3.Pose(nodes.R[e_to], nodes.t[e_to])
    d = se3.compose(se3.inverse(Xi), Xj)
    return se3.log(se3.compose(se3.inverse(rel), d)), d


def _assemble(nodes: se3.Pose, e_from, e_to, rel, w_diag, e_w, dof_mask):
    """Dense H ``[6N, 6N]``, b ``[6N]`` and the weighted cost; ``dof_mask``
    (1 = free) zeroes the gauge node's rows and columns and puts ones on
    their diagonal."""
    n = nodes.t.shape[0]
    r, d = _edge_residuals(nodes, e_from, e_to, rel)
    Jri = _jr_inv(r)
    dRt = d.R.transpose(-1, -2)
    Ad_inv = _adjoint(dRt, -(dRt @ d.t[..., None])[..., 0])  # Ad(d^-1)
    Ji = -(Jri @ Ad_inv)
    Jj = Jri
    wr = w_diag * e_w[:, None]
    cost = torch.sum(wr * r * r)
    # J is [E, residual, parameter]: the weights scale the residual rows
    JiW, JjW = Ji * wr[:, :, None], Jj * wr[:, :, None]
    Hii = JiW.transpose(-1, -2) @ Ji
    Hij = JiW.transpose(-1, -2) @ Jj
    Hjj = JjW.transpose(-1, -2) @ Jj
    bi = (JiW.transpose(-1, -2) @ r[..., None])[..., 0]
    bj = (JjW.transpose(-1, -2) @ r[..., None])[..., 0]
    Hb = torch.zeros((n * n, 6, 6), dtype=r.dtype, device=r.device)
    Hb.index_add_(0, e_from * n + e_from, Hii)
    Hb.index_add_(0, e_from * n + e_to, Hij)
    Hb.index_add_(0, e_to * n + e_from, Hij.transpose(-1, -2))
    Hb.index_add_(0, e_to * n + e_to, Hjj)
    H = Hb.reshape(n, n, 6, 6).permute(0, 2, 1, 3).reshape(6 * n, 6 * n)
    b = torch.zeros((n, 6), dtype=r.dtype, device=r.device)
    b.index_add_(0, e_from, bi)
    b.index_add_(0, e_to, bj)
    b = b.reshape(6 * n) * dof_mask
    H = dof_mask[:, None] * H * dof_mask[None, :]
    H = H + torch.diag(torch.where(dof_mask > 0, 0.0, 1.0))
    return H, b, cost


def _cost(nodes, e_from, e_to, rel, w_diag, e_w) -> torch.Tensor:
    r, _ = _edge_residuals(nodes, e_from, e_to, rel)
    return torch.sum(w_diag * e_w[:, None] * r * r)


def _retract(nodes: se3.Pose, delta: torch.Tensor, free: torch.Tensor) -> se3.Pose:
    """``X_i <- X_i exp(delta_i)`` for the free nodes."""
    upd = se3.exp(delta)
    newR = nodes.R @ upd.R
    newt = (nodes.R @ upd.t[..., None])[..., 0] + nodes.t
    m = free[:, None] > 0
    return se3.Pose(torch.where(m[..., None], newR, nodes.R), torch.where(m, newt, nodes.t))


def optimize_pose_graph(nodes_R: torch.Tensor, nodes_t: torch.Tensor, node_mask: torch.Tensor,
                        e_from: torch.Tensor, e_to: torch.Tensor, rel_R: torch.Tensor,
                        rel_t: torch.Tensor, w_trans: torch.Tensor, w_rot: torch.Tensor,
                        e_mask: torch.Tensor, iters: int = 20, robust: str = "none",
                        robust_delta: float = 2.0, e_robust: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """LM over the pose graph; returns (R ``[N,3,3]``, t ``[N,3]``, cost).

    Nodes ``[N]`` (``node_mask`` 1 = real), edges ``[E]`` from ``e_from``
    to ``e_to`` with measured ``X_from^-1 X_to`` and weights ``1/sigma^2``
    for translation and rotation (``e_mask`` 1 = real; a padded edge points
    at node 0 with the identity). ``robust`` ("none", "huber", "cauchy")
    re-weights each edge per step by ``psi(chi)/chi`` of its whitened
    residual norm ``chi``, with ``robust_delta`` the kernel width, on the
    edges where ``e_robust`` is 1 (default: all). Runs ``iters`` steps
    with no host read."""
    if robust not in ("none", "huber", "cauchy"):
        raise ValueError(f"unknown robust kernel {robust!r}")
    nodes = se3.Pose(nodes_R, nodes_t)
    rel = se3.Pose(rel_R, rel_t)
    e_from, e_to = e_from.to(torch.int64), e_to.to(torch.int64)
    w_diag = torch.cat([w_trans[:, None].expand(-1, 3), w_rot[:, None].expand(-1, 3)], dim=-1)
    n = nodes_t.shape[0]
    free = node_mask.clone()
    free[0] = 0.0  # the gauge node never moves
    dof_mask = free.repeat_interleave(6)
    if e_robust is None:
        e_robust = torch.ones_like(e_mask)

    def edge_weights(nodes):
        if robust == "none":
            return e_mask
        r, _ = _edge_residuals(nodes, e_from, e_to, rel)
        chi = torch.sqrt(torch.clamp(torch.sum(w_diag * r * r, dim=-1), min=1e-12))
        if robust == "huber":
            w = torch.clamp(robust_delta / chi, max=1.0)
        else:
            w = 1.0 / (1.0 + (chi / robust_delta) ** 2)
        return e_mask * torch.where(e_robust > 0.5, w, torch.ones_like(w))

    lam = torch.full((), 1e-3, dtype=nodes_t.dtype, device=nodes_t.device)
    for _ in range(iters):
        e_w = edge_weights(nodes)
        H, b, cost = _assemble(nodes, e_from, e_to, rel, w_diag, e_w, dof_mask)
        Hd = H + torch.diag(lam * torch.diagonal(H) * dof_mask + 1e-8)
        L, _ = torch.linalg.cholesky_ex(Hd)
        delta = torch.cholesky_solve(-b[:, None], L)[:, 0].reshape(n, 6)
        cand = _retract(nodes, delta, free)
        # the IRLS weights stay frozen within the step
        ok = _cost(cand, e_from, e_to, rel, w_diag, e_w) < cost
        nodes = se3.Pose(torch.where(ok, cand.R, nodes.R), torch.where(ok, cand.t, nodes.t))
        lam = torch.where(ok, torch.clamp(lam * 0.5, min=1e-6), torch.clamp(lam * 10.0, max=1e4))
    return nodes.R, nodes.t, _cost(nodes, e_from, e_to, rel, w_diag, e_mask)
