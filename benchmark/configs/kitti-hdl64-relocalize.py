"""Plain reference of ``kitti-hdl64-relocalize``: a map localizer worked
out again in plain PyTorch (float64 poses, exact nearest neighbours) from
the inputs the benchmark handed the program. It imports nothing of the
program and takes none of its state: it builds its own map from the
keyframe clouds and poses, and reads the program's answers only to judge
them.

The semantics are those the configuration states
(``mola_fe_lidar_tpu_torch/frontend/localizer.py`` documents them):

* map: each keyframe's cloud placed at its pose and deduplicated in
  ``voxel_size`` voxels (the first point of a voxel), the concatenation
  deduplicated again; the same for the ``edges`` layer;
* a stage: point-to-point ICP with Horn's closed form over the pairs
  nearer than the stage's distance, unweighted, from the previous stage's
  pose, until a step below 5e-5 m and 1e-5 rad or the stage's iterations;
* the gated query: coarse (max(3 m, 1.5 sigma), 25), fine (the voxel cell
  1 m, 25), sharp (max(0.35 m, 0.7 voxel), 15); quality = (dense paired
  ratio at 0.3 m + 0.5 x edges paired ratio at 0.8 m) / 1.5; rejected
  below ``min_quality`` or past ``max_correction_m``, else 10 probes (the
  +-sigma and +-2 sigma star in x and y with alternating +-5 degrees of
  yaw, then +-90 degrees of yaw) re-aligned through the same stages, and
  rejected when one settles outside 1.5 m / 3 degrees at a quality of at
  least 0.7 of the answer's;
* ``localize_raw``: one stage (the 1 m cell, 30 iterations).

A verdict is compared only where the reference's own margin to every
threshold it crossed is clear (``VERDICT_MARGIN``): a probe's quality a
hair from 0.7 of the answer's decides nothing.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from plain import F64, knn, rotation_gap

STEP_T, STEP_R = 5e-5, 1e-5
CAND_K, CAND_REFRESH = 4, 4     # default_localize_params: cand_k, cand_refresh
QUALITY_DENSE, QUALITY_EDGES, EDGES_WEIGHT = 0.3, 0.8, 0.5
MIN_QUALITY, MAX_CORRECTION = 0.5, 8.0
AGREE_M, AGREE_ROT = 1.5, np.deg2rad(3.0)
ALIAS_RATIO = 0.7
START_ROT, YAW_PROBE = np.deg2rad(5.0), np.pi / 2
VERDICT_MARGIN = {"quality": 0.01, "trans_m": 0.05, "rot_rad": np.deg2rad(0.2)}



def voxel_first(points: np.ndarray, res: float) -> np.ndarray:
    cells = np.floor(points / res).astype(np.int64)
    _, first = np.unique(cells, axis=0, return_index=True)
    return points[np.sort(first)]


def build_map(kf_points: List[np.ndarray], kf_edges: List[np.ndarray], poses, voxel: float,
              capacity: int) -> Tuple[np.ndarray, np.ndarray]:
    def place(pts, pose):
        R, t = np.asarray(pose[0], np.float64), np.asarray(pose[1], np.float64)
        return (pts.astype(np.float32) @ R.T + t).astype(np.float32)

    dense = voxel_first(np.concatenate([voxel_first(place(p, q), voxel)
                                        for p, q in zip(kf_points, poses)]), voxel)
    edges = voxel_first(np.concatenate([voxel_first(place(e, q), voxel)
                                        for e, q in zip(kf_edges, poses) if len(e)]), voxel)
    if len(dense) > capacity:
        raise ValueError(f"map of {len(dense)} points exceeds its capacity {capacity}; "
                         "the reference does not subsample")
    return dense, edges


def nearest(p: torch.Tensor, m: torch.Tensor):
    """Exact nearest neighbour of each point of p [L, N, 3] in m [M, 3]:
    (distance, index) [L, N], in p's dtype."""
    L, N, _ = p.shape
    idx = knn(p.reshape(-1, 3), m, 1)[:, 0].reshape(L, N)
    d = torch.linalg.vector_norm(m[idx].to(p.dtype) - p, dim=-1)
    return d, idx


def _horn(p: torch.Tensor, q: torch.Tensor, w: torch.Tensor):
    """Per lane: the rigid (R, t) minimising sum w |R p + t - q|^2."""
    tot = w.sum(-1, keepdim=True).clamp(min=1e-12)
    mp = (p * w[..., None]).sum(-2) / tot
    mq = (q * w[..., None]).sum(-2) / tot
    H = ((p - mp[:, None]) * w[..., None]).transpose(-1, -2) @ (q - mq[:, None])
    U, _, Vh = torch.linalg.svd(H)
    d = torch.sign(torch.linalg.det(Vh.transpose(-1, -2) @ U.transpose(-1, -2)))
    D = torch.diag_embed(torch.stack([torch.ones_like(d), torch.ones_like(d), d], -1))
    R = Vh.transpose(-1, -2) @ D @ U.transpose(-1, -2)
    t = mq - (R @ mp[..., None])[..., 0]
    return R, t


def _log_step(R, t, R0, t0):
    """|translation| and rotation angle of (R, t) o (R0, t0)^-1."""
    Rd = R @ R0.transpose(-1, -2)
    td = t - (Rd @ t0[..., None])[..., 0]
    cos = ((Rd.diagonal(dim1=-2, dim2=-1).sum(-1) - 1.0) / 2.0).clamp(-1.0, 1.0)
    return torch.linalg.vector_norm(td, dim=-1), torch.arccos(cos)


def align(src: torch.Tensor, m: torch.Tensor, R: torch.Tensor, t: torch.Tensor,
          stages) -> Tuple[torch.Tensor, torch.Tensor]:
    """Lanes of point-to-point ICP (R [L,3,3], t [L,3]) through ``stages``
    of (distance, iterations), in float64. Each stage keeps the
    configuration's candidate cache: the exact ``CAND_K`` nearest map
    points of every source point, refreshed every ``CAND_REFRESH``
    iterations at the current pose; in between a point pairs with the
    nearest of its candidates."""
    L = R.shape[0]
    for dist, iters in stages:
        done = torch.zeros(L, dtype=torch.bool, device=R.device)
        cand = None
        for it in range(iters):
            p = src[None] @ R.transpose(-1, -2) + t[:, None]
            if it % CAND_REFRESH == 0:
                cand = knn(p.reshape(-1, 3), m, CAND_K).reshape(L, -1, CAND_K)
            cd = ((m[cand] - p[:, :, None]) ** 2).sum(-1)
            d2, o = cd.min(-1)
            idx = torch.gather(cand, 2, o[..., None])[..., 0]
            w = (d2.sqrt() < dist).to(F64)
            Rn, tn = _horn(src[None].expand_as(p), m[idx], w)
            enough = w.sum(-1) >= 6.0
            ok = enough & ~done
            step_t, step_r = _log_step(Rn, tn, R, t)
            R = torch.where(ok[:, None, None], Rn, R)
            t = torch.where(ok[:, None], tn, t)
            done = done | (ok & (step_t < STEP_T) & (step_r < STEP_R)) | ~enough
            if bool(done.all()):
                break
    return R, t


def quality(src, src_edges, m, m_edges, R, t) -> torch.Tensor:
    """(dense paired ratio + EDGES_WEIGHT x edges paired ratio) / the
    weights' sum, per lane."""

    def ratio(pts, tgt, thr):
        if pts.shape[0] == 0 or tgt.shape[0] == 0:
            return torch.zeros(R.shape[0], dtype=F64, device=R.device)
        d, _ = nearest(pts[None] @ R.transpose(-1, -2) + t[:, None], tgt)
        return (d < thr).to(F64).mean(-1)
    return (ratio(src, m, QUALITY_DENSE)
            + EDGES_WEIGHT * ratio(src_edges, m_edges, QUALITY_EDGES)) / (1.0 + EDGES_WEIGHT)


def probe_starts(Rb: np.ndarray, tb: np.ndarray, n: int, sigma: float):
    star = [(sigma, 0.0), (-sigma, 0.0), (0.0, sigma), (0.0, -sigma),
            (2 * sigma, 0.0), (-2 * sigma, 0.0), (0.0, 2 * sigma), (0.0, -2 * sigma)]
    offs, yaws = [], []
    for i in range(min(n, len(star))):
        offs.append((star[i][0], star[i][1], 0.0))
        yaws.append(START_ROT if i % 2 == 0 else -START_ROT)
    for sign in (1.0, -1.0):
        if len(offs) < n:
            offs.append((0.0, 0.0, 0.0))
            yaws.append(sign * YAW_PROBE)
    if len(offs) < n:
        raise ValueError("the reference draws no Gaussian probes; use multi_start <= 11")
    out_R, out_t = [], []
    for (dx, dy, dz), a in zip(offs, yaws):
        c, s = np.cos(a), np.sin(a)
        Rz = np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])
        out_R.append(Rz @ Rb)
        out_t.append(tb + np.array([dx, dy, dz]))
    return np.stack(out_R), np.stack(out_t)


def _stages(cfg):
    lc = cfg["localizer"]
    sigma, vox = float(lc["start_sigma_xyz"]), float(lc["voxel_size"])
    return ((max(3.0, 1.5 * sigma), 25), (1.0, 25), (max(0.35, 0.7 * vox), 15))


def check_localize(cfg: dict, state: dict, sample: List[int], device) -> dict:
    """The compared numbers of a run over the sampled queries, and the
    reference map's size."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return _check(cfg, state, sample, device)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _answer(src, src_e, m, me, init, stages, gated, cfg, multi_start) -> dict:
    """A query's answer by the reference."""
    R, t = align(src, m, init[0][None], init[1][None], stages)
    q = float(quality(src, src_e, m, me, R, t)[0])
    out = {"R": R[0].cpu().numpy(), "t": t[0].cpu().numpy(), "quality": q}
    if gated:
        out.update(_verdict(cfg, src, src_e, m, me, out["R"], out["t"], q, init, stages,
                            multi_start))
    return out


def _check(cfg, state, sample, device) -> dict:
    lc = cfg["localizer"]
    kf_poses = [state["gt"][i] for i in state["kf_idx"]]
    dense, edges = build_map(state["kf_raw"], state["kf_edges"], kf_poses,
                             float(lc["voxel_size"]), state["capacity"])
    as_t = lambda a: torch.as_tensor(np.asarray(a, np.float64), dtype=F64, device=device)
    m, me = as_t(dense), as_t(edges)
    gated = state["call"] == "localize"
    stages = _stages(cfg) if gated else ((1.0, 30),)
    rows = []
    for k in sample:
        d = state["done"][k]
        src, src_e = as_t(state["q_raw"][d["query"]]), as_t(state["q_edges"][d["query"]])
        # the prior as the program got it (float32)
        init = tuple(as_t(np.asarray(x, np.float32)) for x in d["init"])
        ref = _answer(src, src_e, m, me, init, stages, gated, cfg, state["multi_start"])
        ans = d
        row = {"scan": d["scan"], "trans_m": float(np.linalg.norm(ref["t"] - ans["t"])),
               "rot_rad": rotation_gap(ref["R"], ans["R"]),
               "quality_gap": abs(ref["quality"] - ans["quality"])}
        if gated:
            row.update(accepted=ref["accepted"], clear=ref["clear"],
                       mismatch=bool(ref["clear"] and ref["accepted"] != ans["accepted"]))
        rows.append(row)
    out = {"pose_gap_m": max(r["trans_m"] for r in rows),
           "rot_gap_rad": max(r["rot_rad"] for r in rows),
           "quality_gap": max(r["quality_gap"] for r in rows),
           "pose_gap_median_m": float(np.median([r["trans_m"] for r in rows])),
           "checked_queries": len(rows), "map_points": len(dense),
           "map_edges_points": len(edges), "rows": rows}
    if gated:
        out["verdict_mismatches"] = sum(r["mismatch"] for r in rows)
        out["verdicts_clear"] = sum(r["clear"] for r in rows)
    return out


def _verdict(cfg, src, src_e, m, me, Rb, tb, q, init, stages, multi_start) -> Dict:
    """The gate's verdict on an answer, and whether every threshold it
    turned on was cleared by a clear margin."""
    mg = VERDICT_MARGIN
    correction = float(np.linalg.norm(tb - init[1].cpu().numpy()))
    if q < MIN_QUALITY or correction > MAX_CORRECTION:
        clear = (abs(q - MIN_QUALITY) > mg["quality"]
                 and abs(correction - MAX_CORRECTION) > mg["trans_m"])
        return {"accepted": False, "clear": clear}
    sR, st = probe_starts(Rb, tb, multi_start - 1, float(cfg["localizer"]["start_sigma_xyz"]))
    as_t = lambda a: torch.as_tensor(a, dtype=F64, device=src.device)
    R, t = align(src, m, as_t(sR), as_t(st), stages)
    qs = quality(src, src_e, m, me, R, t).cpu().numpy()
    Rs, ts = R.cpu().numpy(), t.cpu().numpy()
    dts = np.linalg.norm(ts - tb[None], axis=-1)
    drot = np.arccos(np.clip((np.einsum("kij,ij->k", Rs, Rb) - 1.0) / 2.0, -1.0, 1.0))
    agree = (dts <= AGREE_M) & (drot <= AGREE_ROT)
    compete = (~agree) & (qs >= ALIAS_RATIO * q)
    agree_clear = (dts < AGREE_M - mg["trans_m"]) & (drot < AGREE_ROT - mg["rot_rad"])
    apart_clear = (dts > AGREE_M + mg["trans_m"]) | (drot > AGREE_ROT + mg["rot_rad"])
    rival_clear = np.abs(qs - ALIAS_RATIO * q) > mg["quality"]
    clear = (abs(q - MIN_QUALITY) > mg["quality"]
             and bool(np.all(agree_clear | (apart_clear & rival_clear))))
    return {"accepted": not bool(compete.any()), "clear": clear}
