"""Plain reference of ``kitti-hdl64-realtime``: the odometry front-end's
registration of a scan, worked out again in plain PyTorch in float64, and
a float64 check of the program's filter. It imports nothing of the
program; it reads the program's answers (the poses of the module's
adverts and factors, its keyframes) and its filtered layers, to anchor
each checked scan on them and to judge them.

Anchoring. A scan's pose depends on every earlier pose through the
constant-velocity guess, the deskew twist and the local map, so a
reference run alone would drift from a sound program by far more than
round-off. For a checked scan ``i`` the reference therefore takes the
program's poses of the earlier scans: those of ``i - 2`` and ``i - 1``
for the guess, the earlier scans' for the damped deskew twist, and the
program's keyframes at their poses for the map. Then it registers scan
``i`` and compares the pose it finds with the program's.

The filter's layers are the program's. Which points the filter keeps is
discontinuous: a return across a voxel face in the last bit of a float32
coordinate shifts the voxel sort, and with it which tenth of the scan
``decimated`` keeps, so an exact filter would register other points than
any sound float32 one. The reference registers the program's layers (its
points, the planes' normals and planarity) and checks them by themselves
(:func:`check_filter`): from the raw scan and the deskew twist, in
float64, every kept point is a deskewed return, every clear plane or edge
voxel keeps every 10th of its points (a full layer: at most that) and no
other voxel keeps any, and ``decimated`` keeps every 10th point of each
clear voxel. A decision within its error of its threshold (a return near
a voxel face, an eigen-ratio near its bound) is not judged.

The semantics are those the configuration's ``module`` block states
(``mola_fe_lidar_tpu_torch/frontend/odometry.py`` documents them):

* the scan: the raw returns nearer than ``min_range`` dropped, deskewed
  to the sweep's start with the damped twist (the EMA of the scan twists
  with its acceleration clamp; the pipelined step deskews a scan with the
  twist as it stood before its predecessor's update, ``prefetch``), then
  ``FilterEdgesPlanes``: 1 m voxels, each voxel's covariance, the
  eigen-ratio plane and vertical-edge rules, every 10th point of a voxel
  into ``planes`` / ``edges`` and every 10th point of the voxel sort into
  ``decimated``, each cut to its capacity;
* the map: the last ``local_map_keyframes`` keyframes' layers at their
  poses, deduplicated by a table of 0.25 m voxel hashes in which the
  oldest keyframe's first point wins, compacted in table order to 4x a
  layer's capacity;
* the registration: one stage from the guess ``world[i-1] o exp(twist
  dt)``, at most 15 iterations: point-to-plane against the map's planes
  (pairs nearer than 0.75 m, weighted by the plane's planarity, among 4
  cached candidates) and point-to-line against its edges (a line fit to
  the 5 nearest of 8 cached candidates, pairs nearer than 0.7 m, its
  linearity gate), the candidates refreshed every 4 iterations; 20
  Gauss-Newton steps an iteration with the weak prior toward the guess;
  done at a step under 1 mm and 0.2 mrad.

Everything the reference computes is float64, with TF32 off.
"""

from __future__ import annotations

import math
from functools import lru_cache
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from plain import F64, knn, rotation_gap

INT32_MAX = 2**31 - 1
# settings the module block leaves at the module's defaults
EDGE_MIN_VERTICALITY = 0.6
MIN_ROT_BETWEEN_KEYFRAMES = math.radians(30.0)
CAND_K, CAND_REFRESH = 4, 4
GN_DAMPING = 1e-6
TWIST_SMOOTHING, MAX_ACCEL, MAX_ROT_ACCEL, TWIST_MAX_AGE = 0.5, 10.0, 5.0, 5
QUALITY_SEED = 0xC0FFEE
# a keyframe decision within this far of the distance threshold, or a
# goodness within this far of its gate, decides nothing
KEYFRAME_MARGIN_M, GOODNESS_MARGIN = 1e-3, 0.01


# ---------------------------------------------------------------------------
# settings
# ---------------------------------------------------------------------------

class Settings:
    """What the reference reads of the configuration's module block."""

    def __init__(self, module: dict):
        p = module["params"]
        gen = p["pointcloud_generator"][0]["params"]
        self.capacity = int(gen["capacity"])
        self.min_range = float(gen.get("min_range", 0.0))
        dsk, fep = (f["params"] for f in p["pointcloud_filter"])
        self.period = float(dsk["scan_period"])
        if dsk.get("anchor") != "start" or fep.get("stats_mode") != "scan":
            raise ValueError("the reference follows a start-anchored deskew and scan statistics")
        self.res = float(fep["voxel_filter_resolution"])
        self.full_decim = int(fep["full_pointcloud_decimation"])
        self.voxel_decim = int(fep["voxel_filter_decimation"])
        self.min_e2_e0 = float(fep["voxel_filter_min_e2_e0"])
        self.max_e1_e0 = float(fep["voxel_filter_max_e1_e0"])
        self.min_e1_e0 = float(fep["voxel_filter_min_e1_e0"])
        self.caps = {"edges": int(fep["edges_capacity"]), "planes": int(fep["planes_capacity"]),
                     "decimated": int(fep["decimated_capacity"])}
        self.min_dist_kf = float(p["min_dist_xyz_between_keyframes"])
        self.min_goodness = float(p["min_icp_goodness"])
        self.window = int(p.get("local_map_keyframes", 10))
        self.map_mult = int(p.get("local_map_capacity_mult", 4))
        self.dedup = float(p.get("local_map_dedup_voxel", 0.25))
        if p.get("local_map_build_mode") != "hash" or p.get("odometry_reference") != "local_map":
            raise ValueError("the reference follows the hash-built local map")
        icp = p["icp_settings_with_vel"]
        ip = icp["params"]
        self.max_iterations = min(int(ip["maxIterations"]), int(p["local_map_max_iterations"]))
        self.step_t = max(float(ip["minAbsStep_trans"]), float(p["local_map_min_abs_step_trans"]))
        self.step_r = max(float(ip["minAbsStep_rot"]), float(p["local_map_min_abs_step_rot"]))
        cap_d = float(p["local_map_max_match_distance"])
        planes, lines = icp["matchers"]
        self.plane_dist = min(float(planes["params"]["distanceThreshold"]), cap_d)
        self.line_dist = min(float(lines["params"]["distanceThreshold"]), cap_d)
        self.line_knn = int(lines["params"]["knn"])
        self.line_eig = float(lines["params"]["planeEigenThreshold"])
        self.line_cands = max(CAND_K, self.line_knn + 3)
        solver = icp["solvers"][0]["params"]
        self.gn_inner = int(solver["maxIterations"])
        self.prior_w = np.array([1.0 / float(solver["priorSigmaTrans"]) ** 2] * 3
                                + [1.0 / float(solver["priorSigmaRot"]) ** 2] * 3)
        q = icp["quality"][0]["params"]
        self.quality_dist = float(q["thresholdDistance"])
        self.quality_points = int(p["local_map_quality_max_points"])


# ---------------------------------------------------------------------------
# SE(3), float64 on the host
# ---------------------------------------------------------------------------

def _hat(w):
    return np.array([[0.0, -w[2], w[1]], [w[2], 0.0, -w[0]], [-w[1], w[0], 0.0]])


def se3_exp(tau) -> Tuple[np.ndarray, np.ndarray]:
    v, w = np.asarray(tau[:3], float), np.asarray(tau[3:], float)
    th = float(np.linalg.norm(w))
    W = _hat(w)
    if th < 1e-8:
        A, B, C = 1.0, 0.5, 1.0 / 6.0
    else:
        A, B, C = math.sin(th) / th, (1 - math.cos(th)) / th**2, (th - math.sin(th)) / th**3
    return np.eye(3) + A * W + B * W @ W, (np.eye(3) + B * W + C * W @ W) @ v


def se3_log(R, t) -> np.ndarray:
    c = min(1.0, max(-1.0, (np.trace(R) - 1.0) / 2.0))
    th = math.acos(c)
    skew = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    w = 0.5 * skew if th < 1e-6 else th / (2 * math.sin(th)) * skew
    W = _hat(w)
    th2 = float(w @ w)
    if th2 < 1e-10:
        coef = 1.0 / 12.0
    else:
        th = math.sqrt(th2)
        coef = (1 - (math.sin(th) / th) / (2 * (1 - math.cos(th)) / th2)) / th2
    return np.concatenate([(np.eye(3) - 0.5 * W + coef * W @ W) @ t, w])


def compose(a, b):
    return a[0] @ b[0], a[0] @ b[1] + a[1]


def inverse(p):
    return p[0].T, -p[0].T @ p[1]


def orthonormal(R) -> np.ndarray:
    U, _, Vt = np.linalg.svd(np.asarray(R, np.float64))
    return U @ np.diag([1.0, 1.0, float(np.sign(np.linalg.det(U @ Vt)))]) @ Vt


def rot_angle(R) -> float:
    return math.acos(min(1.0, max(-1.0, (np.trace(R) - 1.0) / 2.0)))


# ---------------------------------------------------------------------------
# the filter, checked in float64
# ---------------------------------------------------------------------------

# Which points the program's float32 filter keeps can differ from an exact
# filter's where a decision sits near its threshold; such decisions are not
# judged:
# a return this near a voxel face (or the range gate) may fall either side
FACE_MARGIN_M = 2e-4
# The configuration's voxel statistics (``stats_mode: scan``) are float32
# differences of prefix sums over the voxel-sorted scan: a voxel's sums
# carry an error of about an ulp of the prefix's magnitude at its place in
# the sort, divided by its count. A rule is judged only where its two sides
# differ by more than STATS_ULPS ulps of those magnitudes, carried through
# to the eigenvalues, plus EIG_REL of the largest eigenvalue (the float32
# closed-form eigenvalues); the verticality gate only where it clears its
# bound by VERTICAL_MARGIN plus the eigenvector's share of that error. At
# one ulp, 1e-4 and 0.01 the program's decisions against the exact rule
# lay within a quarter of the error on the card; the constants are twice
# those.
STATS_ULPS, EIG_REL, VERTICAL_MARGIN = 2.0, 2e-4, 0.02
# a kept point farther than this from every deskewed return is none of them
POINT_GAP_M = 1e-3


def _hat_b(w):
    z = torch.zeros_like(w[..., 0])
    return torch.stack([torch.stack([z, -w[..., 2], w[..., 1]], -1),
                        torch.stack([w[..., 2], z, -w[..., 0]], -1),
                        torch.stack([-w[..., 1], w[..., 0], z], -1)], dim=-2)


def deskew(obs: dict, twist: np.ndarray, s: Settings, device):
    """The scan's returns in float64, each moved to the sweep's start with
    the twist over its fire time: (xyz [n, 3] of every slot, valid [n],
    near_gate [n]: valid returns within the margin of the range gate)."""
    raw = torch.as_tensor(np.asarray(obs["xyz"], np.float64), device=device)
    valid = torch.as_tensor(np.asarray(obs["valid"]) > 0, device=device)
    rng = torch.linalg.vector_norm(raw, dim=-1)
    near_gate = valid & ((rng - s.min_range).abs() < FACE_MARGIN_M)
    valid = valid & (rng >= s.min_range)
    tfrac = torch.as_tensor(np.asarray(obs["time"], np.float64), device=device)
    tau = tfrac[:, None] * torch.as_tensor(np.asarray(twist, np.float64) * s.period,
                                           device=device)
    v, w = tau[:, :3], tau[:, 3:]
    th2 = (w * w).sum(-1)
    th = torch.sqrt(th2)
    small = th2 < 1e-12
    safe = torch.where(small, torch.ones_like(th), th)
    A = torch.where(small, 1.0 - th2 / 6.0, torch.sin(safe) / safe)
    B = torch.where(small, 0.5 - th2 / 24.0, (1.0 - torch.cos(safe)) / safe**2)
    C = torch.where(small, 1.0 / 6.0 - th2 / 120.0, (safe - torch.sin(safe)) / safe**3)
    W = _hat_b(w)
    W2 = W @ W
    eye = torch.eye(3, dtype=F64, device=device)
    R = eye + A[:, None, None] * W + B[:, None, None] * W2
    V = eye + B[:, None, None] * W + C[:, None, None] * W2
    xyz = (R @ raw[:, :, None])[:, :, 0] + (V @ v[:, :, None])[:, :, 0]
    return xyz, valid, near_gate


def voxels(xyz, valid, near_gate, s: Settings):
    """The filter's voxels of the valid returns, exactly: (vox [n] each
    valid return's voxel, -1 elsewhere; a dict of per-voxel tensors: count,
    is_plane, is_edge, m_plane, m_edge (how far each rule's decision lies
    from its threshold, in margins) and clear (no return of its own or of
    a neighbour within the margin of a face between them))."""
    dev = xyz.device
    p = xyz[valid]
    origin = p.amin(0) - 0.5 * s.res
    u = (p - origin) / s.res
    cells = torch.floor(u).to(torch.int64)

    def key(c):
        return (c[:, 0] << 42) | (c[:, 1] << 21) | c[:, 2]

    uk, inv = torch.unique(key(cells), return_inverse=True)
    nv = uk.shape[0]
    count = torch.zeros(nv, dtype=F64, device=dev).index_add_(0, inv, torch.ones_like(p[:, 0]))
    mean = torch.zeros(nv, 3, dtype=F64, device=dev).index_add_(0, inv, p) / count[:, None]
    r = p - mean[inv]
    cov = (torch.zeros(nv, 9, dtype=F64, device=dev)
           .index_add_(0, inv, (r[:, :, None] * r[:, None, :]).reshape(-1, 9))
           .reshape(nv, 3, 3) / count[:, None, None])
    ev, vec = torch.linalg.eigh(cov)
    floor = (0.01 * s.res) ** 2
    e0, e1, e2 = (torch.clamp(ev[:, k], min=floor) for k in range(3))
    enough = count >= 5.0
    is_plane = enough & (e1 >= s.min_e1_e0 * e0)
    vert = vec[:, 2, 2].abs() - EDGE_MIN_VERTICALITY
    is_edge = (enough & ~is_plane & (e2 >= s.min_e2_e0 * e0) & (e1 <= s.max_e1_e0 * e0)
               & (vert >= 0))
    # the float32 statistics' error at each voxel's place in the sort
    # (voxels sort by their keys, as ``uk`` is): the prefix magnitudes of
    # the coordinates and of the residuals' squares at the voxel's end
    ulp = STATS_ULPS * 2.0 ** -24
    p_x = torch.zeros(nv, 3, dtype=F64, device=dev).index_add_(0, inv, p.abs()).cumsum(0).amax(1)
    p_r = torch.zeros(nv, dtype=F64, device=dev).index_add_(0, inv, (r * r).sum(-1)).cumsum(0)
    d_mean = ulp * p_x / count
    d_eig = 3.0 * (ulp * p_r / count + d_mean**2) + EIG_REL * e2
    # how far each decision lies from its threshold, in its error: judged at
    # 1 or more (a voxel of fewer than 5 returns is neither, whatever else)
    big = torch.full_like(count, float("inf"))
    m_plane = torch.where(enough, (e1 - s.min_e1_e0 * e0).abs()
                          / ((1.0 + s.min_e1_e0) * d_eig), big)
    m_vert = vert.abs() / (VERTICAL_MARGIN + 2.0 * d_eig / torch.clamp(e2 - e1, min=1e-12))
    m_edge = torch.stack([m_plane,
                          (e2 - s.min_e2_e0 * e0).abs() / ((1.0 + s.min_e2_e0) * d_eig),
                          (s.max_e1_e0 * e0 - e1).abs() / ((1.0 + s.max_e1_e0) * d_eig),
                          m_vert]).amin(0)
    m_edge = torch.where(enough & ~is_plane, m_edge, m_plane)
    # a voxel is clear when no return of it, or of another voxel, lies
    # within the margin of a face between them (a float32 key may put such
    # a return on the other side), and none sits on the range gate
    clear = torch.ones(nv, dtype=torch.bool, device=dev)
    m = FACE_MARGIN_M / s.res
    lo, hi = torch.floor(u - m).to(torch.int64), torch.floor(u + m).to(torch.int64)
    near = (lo != hi).any(-1)
    for corner in range(8):
        c = torch.where(torch.tensor([(corner >> k) & 1 for k in range(3)], device=dev,
                                     dtype=torch.bool), hi[near], lo[near])
        kk = key(c)
        pos = torch.clamp(torch.searchsorted(uk, kk), max=nv - 1)
        hit = uk[pos] == kk
        clear[pos[hit]] = False
    gate = near_gate[valid]
    if bool(gate.any()):
        clear[inv[gate]] = False
    vox = torch.full((xyz.shape[0],), -1, dtype=torch.int64, device=dev)
    vox[valid] = inv
    return vox, {"count": count, "is_plane": is_plane, "is_edge": is_edge,
                 "m_plane": m_plane, "m_edge": m_edge, "clear": clear}


def check_filter(obs: dict, twist: np.ndarray, layers: Dict[str, dict], s: Settings,
                 device) -> dict:
    """The program's filtered layers of a scan against the configuration's
    rules, worked out in float64 from the raw scan and the deskew twist.
    Counted as breaks (each a fault): a kept point that is no deskewed
    return; a kept plane or edge point in a voxel whose rule clearly says
    otherwise; a clear plane or edge voxel that does not keep every
    ``voxel_filter_decimation``-th of its points; a clear voxel whose share
    of ``decimated`` is not every ``full_pointcloud_decimation``-th of its
    points (at most that, where the layer is full: a full layer keeps a
    part of what its rules flag)."""
    xyz, valid, near_gate = deskew(obs, twist, s, device)
    vox, v = voxels(xyz, valid, near_gate, s)
    nv = v["count"].shape[0]
    idx_valid = torch.nonzero(valid)[:, 0]
    pts = xyz[idx_valid]
    info = {"clear_voxel_share": float(v["clear"].double().mean()), "point_gap_m": 0.0}
    breaks = 0
    for name, decim in (("planes", s.voxel_decim), ("edges", s.voxel_decim),
                        ("decimated", s.full_decim)):
        lay = layers[name]
        m = lay["mask"] > 0.5
        kept = lay["xyz"][m].to(F64)
        cap = lay["mask"].shape[0]
        full = int(m.sum()) >= cap
        n_kept = torch.zeros(nv, dtype=F64, device=device)
        if kept.shape[0]:
            j = knn(kept, pts, 1)[:, 0]
            gap = torch.linalg.vector_norm(pts[j] - kept, dim=-1)
            info["point_gap_m"] = max(info["point_gap_m"], float(gap.max()))
            breaks += int((gap > POINT_GAP_M).sum())
            n_kept.index_add_(0, vox[idx_valid[j]], torch.ones_like(gap))
        c, clear = v["count"], v["clear"]
        if name == "decimated":
            lo = torch.zeros_like(c) if full else torch.floor(c / decim)
            bad = clear & ((n_kept < lo) | (n_kept > torch.ceil(c / decim)))
        else:
            rule = v["is_plane"] if name == "planes" else v["is_edge"]
            margin = v["m_plane"] if name == "planes" else v["m_edge"]
            # a full layer keeps a part of its voxels' points: only a kept
            # point against the rule is a flip there
            flip = clear & (n_kept > 0) & ~rule if full else clear & ((n_kept > 0) != rule)
            info[f"{name}_flip_margin_max"] = float(margin[flip].max()) if bool(flip.any()) else 0.0
            judged = clear & (margin >= 1.0)
            enough = clear & (c >= 5.0)
            info[f"{name}_judged_share"] = float(judged[enough].double().mean())
            want = torch.where(rule, torch.ceil(c / decim), torch.zeros_like(c))
            if full:   # a full layer keeps a part of its voxels' points
                bad = judged & (((n_kept > 0) & ~rule) | (n_kept > want))
            else:
                bad = judged & (n_kept != want)
        breaks += int(bad.sum())
        info[f"{name}_kept"] = int(m.sum())
    info["breaks"] = breaks
    return info


# ---------------------------------------------------------------------------
# the local map
# ---------------------------------------------------------------------------

def _voxel_hash(cell, size: int):
    c = cell.to(torch.int64)
    m32 = (1 << 32) - 1
    h = (((c[:, 0] * 73856093) & m32) ^ ((c[:, 1] * 19349663) & m32)
         ^ ((c[:, 2] * 83492791) & m32))
    return h & (size - 1)


def build_map(keyframes: List[Tuple[Dict[str, dict], Tuple[np.ndarray, np.ndarray]]],
              s: Settings, device) -> Dict[str, dict]:
    """The map of ``keyframes`` (layers, world pose), oldest first:
    {name: {"xyz" f64 [m, 3], "normal", "planarity"}} of its valid points."""
    out = {}
    for name in ("planes", "edges", "decimated"):
        C = s.caps[name]
        cap = max(256, (C * s.map_mult + 255) // 256 * 256)
        size = 1 << max(int(cap * 4 - 1).bit_length(), 8)
        flat, pri, normal = [], [], []
        for rank, (layers, (R, t)) in enumerate(keyframes):
            lay = layers[name]
            Rt = torch.as_tensor(np.asarray(R, np.float64), device=device)
            tt = torch.as_tensor(np.asarray(t, np.float64), device=device)
            flat.append(lay["xyz"].to(F64) @ Rt.T + tt)
            rows = torch.arange(C, dtype=torch.int64, device=device)
            pri.append(torch.where(lay["mask"] > 0.5, rank * C + rows,
                                   torch.full_like(rows, INT32_MAX)))
            if name == "planes":
                normal.append(lay["normal"].to(F64) @ Rt.T)
        flat, pri = torch.cat(flat), torch.cat(pri)
        slot = _voxel_hash(torch.floor(flat / s.dedup).to(torch.int64), size)
        table = torch.full((size,), INT32_MAX, dtype=torch.int64, device=device)
        table.scatter_reduce_(0, slot, pri, reduce="amin", include_self=True)
        # the winners' rows (rank x C + row), occupied slots in table order
        row = table[table < INT32_MAX][:cap]
        layer = {"xyz": flat[row]}
        if name == "planes":
            layer["normal"] = torch.cat(normal)[row]
            layer["planarity"] = torch.cat([k[0]["planes"]["planarity"] for k in keyframes])[row].to(F64)
        out[name] = layer
    return out


# ---------------------------------------------------------------------------
# the registration, float64
# ---------------------------------------------------------------------------

def _transform(R, t, p):
    return p @ R.T + t


def _line_rows(src, R, t, tgt, cand, s: Settings):
    """Point-to-line pairings of the edges: (p, anchor, two normals, w)."""
    sp = _transform(R, t, src)
    d2 = ((tgt[cand] - sp[:, None]) ** 2).sum(-1)
    o = torch.argsort(d2, dim=1, stable=True)[:, :s.line_knn]
    nb = tgt[torch.gather(cand, 1, o)]
    near = torch.sqrt(torch.gather(d2, 1, o[:, :1]))[:, 0]
    c = nb.mean(1)
    d = nb - c[:, None]
    cov = d.transpose(1, 2) @ d / s.line_knn
    ev, vec = torch.linalg.eigh(cov)
    dirv = vec[..., 2]
    linear = ev[:, 2] >= (1.0 / max(s.line_eig, 1e-3)) * torch.clamp(ev[:, 1], min=1e-9)
    use_x = (dirv[:, 0:1].abs() < 0.9).to(F64)
    a = torch.cat([use_x, 1.0 - use_x, torch.zeros_like(use_x)], -1)
    n1 = torch.linalg.cross(dirv, a, dim=-1)
    n1 = n1 / torch.clamp(torch.linalg.vector_norm(n1, dim=-1, keepdim=True), min=1e-9)
    n2 = torch.linalg.cross(dirv, n1, dim=-1)
    w = ((near < s.line_dist) & linear).to(F64)
    return (torch.cat([src, src]), torch.cat([c, c]), torch.cat([n1, n2]), torch.cat([w, w]))


def _plane_rows(src, R, t, mp, cand, s: Settings):
    sp = _transform(R, t, src)
    d2 = ((mp["xyz"][cand] - sp[:, None]) ** 2).sum(-1)
    j = torch.argmin(d2, dim=1)
    sel = torch.gather(cand, 1, j[:, None])[:, 0]
    near = torch.sqrt(torch.gather(d2, 1, j[:, None])[:, 0])
    w = (near < s.plane_dist).to(F64) * mp["planarity"][sel]
    return src, mp["xyz"][sel], mp["normal"][sel], w


def _gauss_newton(R, t, P, Q, N, W, prior, s: Settings):
    dev = P.device
    pw = torch.as_tensor(s.prior_w, dtype=F64, device=dev)
    for _ in range(s.gn_inner):
        Rt, tt = (torch.as_tensor(x, dtype=F64, device=dev) for x in (R, t))
        rp = _transform(Rt, tt, P)
        r = ((rp - Q) * N).sum(-1)
        J = torch.cat([N, torch.linalg.cross(rp, N, dim=-1)], -1)
        Jw = J * W[:, None]
        A = Jw.T @ J + torch.diag(pw)
        b = -(Jw.T @ r) + pw * torch.as_tensor(se3_log(*compose(prior, inverse((R, t)))),
                                              dtype=F64, device=dev)
        lam = GN_DAMPING * max(float(torch.diagonal(A).max()), 1.0)
        delta = torch.linalg.solve(A + lam * torch.eye(6, dtype=F64, device=dev), b)
        R, t = compose(se3_exp(delta.cpu().numpy()), (R, t))
    return R, t


def register(layers: Dict[str, dict], mp: Dict[str, dict], guess, s: Settings):
    """The scan's pose against the map from ``guess``: (R, t, iterations)."""
    dev = mp["planes"]["xyz"].device
    dec = layers["decimated"]["xyz"][layers["decimated"]["mask"] > 0.5].to(F64)
    edg = layers["edges"]["xyz"][layers["edges"]["mask"] > 0.5].to(F64)
    R, t = (np.asarray(x, np.float64) for x in guess)
    cand_p = cand_e = None
    it = 0
    while it < s.max_iterations:
        Rt, tt = (torch.as_tensor(x, dtype=F64, device=dev) for x in (R, t))
        if it % CAND_REFRESH == 0:
            cand_p = knn(_transform(Rt, tt, dec), mp["planes"]["xyz"], CAND_K)
            cand_e = knn(_transform(Rt, tt, edg), mp["edges"]["xyz"], s.line_cands)
        rows = [_plane_rows(dec, Rt, tt, mp["planes"], cand_p, s),
                _line_rows(edg, Rt, tt, mp["edges"]["xyz"], cand_e, s)]
        P, Q, N, W = (torch.cat([r[k] for r in rows]) for k in range(4))
        if float(W.sum()) >= 6.0:
            Rn, tn = _gauss_newton(R, t, P, Q, N, W, guess, s)
        else:
            Rn, tn = R, t
        step = se3_log(*compose((Rn, tn), inverse((R, t))))
        R, t = Rn, tn
        it += 1
        if np.linalg.norm(step[:3]) < s.step_t and np.linalg.norm(step[3:]) < s.step_r:
            break
    return R, t, it


@lru_cache(maxsize=None)
def _quality_rows(n: int, keep: int) -> np.ndarray:
    return np.sort(np.random.default_rng(QUALITY_SEED).permutation(n)[:keep])


def quality(layers, mp, R, t, s: Settings) -> float:
    """The paired ratio of the scan's fixed subsample of ``decimated`` at
    the map's ``decimated`` within the quality distance."""
    dec = layers["decimated"]
    n = dec["xyz"].shape[0]
    sel = (torch.as_tensor(_quality_rows(n, s.quality_points), device=dec["xyz"].device)
           if s.quality_points and n > s.quality_points else torch.arange(n, device=dec["xyz"].device))
    m = dec["mask"][sel] > 0.5
    p = dec["xyz"][sel][m].to(F64)
    tgt = mp["decimated"]["xyz"]
    Rt, tt = (torch.as_tensor(x, dtype=F64, device=tgt.device) for x in (R, t))
    sp = _transform(Rt, tt, p)
    j = knn(sp, tgt, 1)[:, 0]
    d = torch.linalg.vector_norm(tgt[j] - sp, dim=-1)
    return float((d < s.quality_dist).sum()) / max(int(m.sum()), 1)


# ---------------------------------------------------------------------------
# the program's poses
# ---------------------------------------------------------------------------

class Track:
    """The program's answers on the host: each posed scan's world pose
    (its keyframe's pose, the keyframes chained by the odometry factors,
    composed with the scan's advert), the keyframes and the damped deskew
    twist after each scan."""

    def __init__(self, state: dict):
        period = state["period"]
        log = state["backend"]
        self.ts = {j: float(o["timestamp"]) for j, o in enumerate(state["scans"])}
        self.kf_scan = {k: int(round(ts / period)) for k, ts in log["keyframes"].items()}
        kf_pose = {min(self.kf_scan): (np.eye(3), np.zeros(3))}
        rel = {}
        for a, b, R, t in log["factors"]:
            if b == a + 1 and b not in rel:   # a keyframe's odometry factor comes first
                rel[b] = (orthonormal(R), np.asarray(t, np.float64))
        for b in sorted(rel):
            if b - 1 in kf_pose:
                kf_pose[b] = compose(kf_pose[b - 1], rel[b])
        self.kf_pose = kf_pose
        self.world = {}
        for ts, kf, R, t in log["localizations"]:
            if kf in kf_pose:
                self.world[int(round(ts / period))] = compose(
                    kf_pose[kf], (orthonormal(R), np.asarray(t, np.float64)))
        self._twists()

    def _twists(self) -> None:
        """The scan twists and the damped twist after each scan, every
        scan taken as good."""
        self.twist, self.deskew_after = {}, {0: np.zeros(6)}
        smooth, age = np.zeros(6), 10**9
        j = 1
        while j in self.world and j - 1 in self.world:
            dt = self.ts[j] - self.ts[j - 1]
            rel = compose(inverse(self.world[j - 1]), self.world[j])
            if dt > 0:
                self.twist[j] = se3_log(*rel) / dt
                if age > TWIST_MAX_AGE:
                    smooth = np.array(self.twist[j])
                else:
                    dv = self.twist[j] - smooth
                    span = dt * (1 + age)
                    dv[:3] = np.clip(dv[:3], -MAX_ACCEL * span, MAX_ACCEL * span)
                    dv[3:] = np.clip(dv[3:], -MAX_ROT_ACCEL * span, MAX_ROT_ACCEL * span)
                    smooth = smooth + TWIST_SMOOTHING * dv
                age = 0
            else:
                age += 1
            self.deskew_after[j] = smooth.copy() if age <= TWIST_MAX_AGE else np.zeros(6)
            j += 1

    def deskew_twist(self, j: int, prefetched) -> Optional[np.ndarray]:
        """The twist scan ``j`` was deskewed with; None where unknown."""
        if j == 0:
            return np.zeros(6)
        if prefetched is None:
            return None
        return self.deskew_after.get(j - 2 if prefetched else j - 1)

    def keyframes_before(self, j: int, window: int) -> List[int]:
        """The keyframes made before scan ``j``, the last ``window``."""
        ks = sorted(k for k, sc in self.kf_scan.items() if sc < j and k in self.kf_pose)
        return ks[-window:]


class _Scans:
    """The program's filtered layers of the stream's scans on the device,
    and the float64 check of each scan's layers that the reference used."""

    def __init__(self, state, track: Track, s: Settings, device):
        self.state, self.track, self.s, self.device = state, track, s, device
        self.cache = {}
        self.used = set()

    def layers(self, j: int):
        if j not in self.cache:
            lay = self.state["layers"].get(j)
            self.cache[j] = None if lay is None else {
                name: {k: torch.as_tensor(np.asarray(v, np.float32), device=self.device)
                       for k, v in d.items()} for name, d in lay.items()}
        if self.cache[j] is not None:
            self.used.add(j)
        return self.cache[j]

    def local_map(self, j: int):
        tr = self.track
        kfs = tr.keyframes_before(j, self.s.window)
        if not kfs:
            return None
        entries = []
        for k in kfs:
            lay = self.layers(tr.kf_scan[k])
            if lay is None:
                return None
            entries.append((lay, tr.kf_pose[k]))
        return build_map(entries, self.s, self.device)

    def check_filters(self) -> Tuple[int, int, List[dict]]:
        """The float64 check of every scan whose layers were used: (breaks,
        scans whose deskew twist is unknown, each scan's readings)."""
        breaks, unsure, rows = 0, 0, []
        for j in sorted(self.used):
            tw = self.track.deskew_twist(j, self.state["prefetch"].get(j))
            if tw is None:
                unsure += 1
                continue
            r = check_filter(self.state["scans"][j], tw, self.cache[j], self.s, self.device)
            breaks += r["breaks"]
            rows.append({"scan": j, **r})
        return breaks, unsure, rows


def _answer(j: int, scans: _Scans, s: Settings):
    """The reference's pose of scan ``j`` anchored on the program's poses
    of the scans before it, with its quality; None where the program's
    record lacks what it needs."""
    tr = scans.track
    if j - 1 not in tr.world or j - 1 not in tr.twist:
        return None
    layers, mp = scans.layers(j), scans.local_map(j)
    if layers is None or mp is None:
        return None
    dt = tr.ts[j] - tr.ts[j - 1]
    guess = compose(tr.world[j - 1], se3_exp(tr.twist[j - 1] * dt))
    R, t, its = register(layers, mp, guess, s)
    return R, t, its, quality(layers, mp, R, t, s)


# ---------------------------------------------------------------------------
# the check
# ---------------------------------------------------------------------------

def check_stream(cfg: dict, state: dict, sample: List[int], device) -> dict:
    """The compared numbers of a run over the sampled scans: the median
    pose gap, the keyframe decisions against the preset's rule, the scans
    handed over without a pose."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.no_grad():
            return _check(cfg, state, sample, device)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _check(cfg, state, sample, device) -> dict:
    s = Settings(state["module"])
    tr = Track(state)
    scans = _Scans(state, tr, s, device)
    rows = []
    for k in sample:
        j = state["done"][k]["scan"]
        row = {"scan": j, "prefetch": state["prefetch"].get(j)}
        ans = _answer(j, scans, s) if j in tr.world else None
        if ans is None:
            row["unsure"] = True
        else:
            R, t, its, q = ans
            Rp, tp = tr.world[j]
            row.update(trans_m=float(np.linalg.norm(t - tp)), rot_rad=rotation_gap(R, Rp),
                       iterations=its, quality=q)
        rows.append(row)
    gaps = [r["trans_m"] for r in rows if "trans_m" in r]
    mismatches, unclear = _keyframe_mismatches(tr, scans, s)
    breaks, filter_unsure, filter_rows = scans.check_filters()
    inf = float("inf")
    return {"pose_gap_median_m": float(np.median(gaps)) if gaps else inf,
            "pose_gap_m": max(gaps, default=inf),
            "rot_gap_rad": max((r["rot_rad"] for r in rows if "rot_rad" in r), default=inf),
            "quality_min": min((r["quality"] for r in rows if "quality" in r), default=None),
            "filter_breaks": breaks if filter_rows else inf,
            "filter_scans": len(filter_rows), "filter_unsure_scans": filter_unsure,
            "filter_point_gap_m": max((r["point_gap_m"] for r in filter_rows), default=None),
            "filter_flip_margin_max": max((max(r["planes_flip_margin_max"], r["edges_flip_margin_max"])
                                           for r in filter_rows), default=None),
            "clear_voxel_share_min": min((r["clear_voxel_share"] for r in filter_rows),
                                         default=None),
            "keyframe_mismatches": mismatches, "keyframe_decisions_unclear": unclear,
            "scans_lost": sum(1 for j in state["window"] if j not in tr.world),
            "checked_scans": len(gaps), "unsure_scans": sum(1 for r in rows if r.get("unsure")),
            "rows": rows, "filter_rows": filter_rows}


def _keyframe_mismatches(tr: Track, scans: _Scans, s: Settings) -> Tuple[int, int]:
    """Posed scans whose keyframe decision differs from the rule on the
    program's poses (moved more than the distance or turned more than the
    angle since the scan of the last keyframe, with a goodness over the
    gate), and the decisions too close to a threshold to judge."""
    kf_scans = sorted(set(tr.kf_scan.values()))
    made = set(kf_scans)
    bad = unclear = 0
    for j in sorted(tr.world):
        before = [k for k in kf_scans if k < j]
        if not before or before[-1] not in tr.world:
            continue
        R, t = compose(inverse(tr.world[before[-1]]), tr.world[j])
        dist, rot = float(np.linalg.norm(t)), rot_angle(R)
        if (abs(dist - s.min_dist_kf) < KEYFRAME_MARGIN_M
                or abs(rot - MIN_ROT_BETWEEN_KEYFRAMES) < 1e-4):
            unclear += 1
            continue
        moved = dist > s.min_dist_kf or rot > MIN_ROT_BETWEEN_KEYFRAMES
        kf = j in made
        if kf and not moved:
            bad += 1
        elif moved and not kf:
            # the rule passes only at a goodness over the gate: judge it
            layers, mp = scans.layers(j), scans.local_map(j)
            if layers is None or mp is None:
                unclear += 1
                continue
            q = quality(layers, mp, *tr.world[j], s)
            if abs(q - s.min_goodness) < GOODNESS_MARGIN:
                unclear += 1
            elif q > s.min_goodness:
                bad += 1
    return bad, unclear
