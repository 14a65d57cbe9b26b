"""Map-based localization: align scans against an aggregated keyframe map
(port of ``mola_fe_lidar_tpu/frontend/localizer.py``).

:class:`MapLocalizer` aggregates keyframe clouds (from a ``WorldModel`` or
any ``(cloud, pose)`` list) into one padded map cloud on the host, in
numpy, exactly as the reference does, and sends it to the device once.
``localize(scan, init)`` then runs the ICP engine against it.

The acceptance gate is the reference's multi-start rival-basin probe: the
paired-ratio quality cannot tell a query snapped to the wrong one of two
self-similar places from the right one, so ``localize`` re-aligns
``multi_start - 1`` displaced copies of its answer (a deterministic star,
two yaw probes, then a Gaussian tail, all made in numpy from ``seed``) and
rejects the answer when a probe settles in a different basin at a
comparable quality. The reference runs the probes as one ``jax.vmap``
batch; here they are one align with a lane axis (``init_pose`` of shape
``[multi_start - 1]``), the scan and the map shared by every lane as
stride-0 expands, so each search of a block is one K1/K2 launch for all
probes. A localize reads the device twice: the base align's result, then
the probes' poses and qualities.

Everything runs on the map's device (``device``, the card unless the
caller passes ``device="cpu"``); the scan and the initial pose must be
there too.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..cloud.metric_map import MetricMap, PointCloud, from_points, to_numpy
from ..cloud.voxel import hash_subsample_np, voxel_first_indices_np
from ..geometry import se3
from ..models.config import ICPParams, Matcher, PairWeights, Quality, Solver
from ..models.icp import ICPResult, align, align_pipeline
from .worldmodel import ANNOTATION_NAME_PC_LAYERS, WorldModel


def default_localize_params(cell: float = 1.0) -> ICPParams:
    """Point-to-point Horn ICP sized for scan-vs-map queries, with the
    candidate cache (top-4 refresh every 4 iterations). No motion-
    conditional refresh: on map queries it froze candidate recruiting,
    and the gate's probes then out-scored the base answer from a metre
    away (the reference's finding)."""
    return ICPParams(
        max_iterations=30,
        cand_refresh=4,
        matchers=(Matcher(kind="point2point", distance_threshold=cell,
                          nn_backend="auto", cand_k=4),),
        solver=Solver(kind="horn"),
        quality=(Quality(threshold_distance=0.3),),
        weights=PairWeights(use_scale_outlier_detector=False),
    )


class LocalizeResult(NamedTuple):
    """Gated localization answer: the base align's result plus the
    multi-start consistency verdict. ``accepted=False`` means do not trust
    ``pose``; ``reject_reason`` says why ("quality" / "consistency" /
    "correction"). Host values (numpy arrays and Python numbers)."""

    pose: se3.Pose
    cov: np.ndarray
    quality: float
    n_iterations: int
    term_reason: int
    accepted: bool
    n_agree: int          # starts that re-converged to the solution basin
    n_compete: int        # probes in a different basin at comparable quality
    n_starts: int
    rival_quality: float  # best quality among non-agreeing probes (0 if none)
    dispersion_m: float   # median translation spread of probes vs solution
    correction_m: float   # |best pose - init| translation
    reject_reason: str    # "" when accepted


class MapLocalizer:
    """Aggregate keyframe clouds into one map; localize scans against it.
    The arguments are the reference's (their meaning is documented
    there), plus ``device``."""

    def __init__(self, map_capacity: int = 1 << 17, voxel_size: float = 0.5,
                 layer: str = "raw", params: Optional[ICPParams] = None,
                 multi_start: int = 11, start_sigma_xyz: float = 3.0,
                 start_sigma_rot: float = np.deg2rad(5.0),
                 agree_tol_m: float = 1.5,
                 agree_tol_rot: float = np.deg2rad(3.0),
                 alias_quality_ratio: float = 0.7,
                 yaw_probe: float = np.pi / 2,
                 min_quality: float = 0.5,
                 max_correction_m: float = 8.0,
                 device="cuda"):
        self.map_capacity = int(map_capacity)
        self.voxel_size = float(voxel_size)
        self.layer = layer
        self.params = params or default_localize_params()
        self.multi_start = int(multi_start)
        self.start_sigma_xyz = float(start_sigma_xyz)
        self.start_sigma_rot = float(start_sigma_rot)
        self.agree_tol_m = float(agree_tol_m)
        self.agree_tol_rot = float(agree_tol_rot)
        self.alias_quality_ratio = float(alias_quality_ratio)
        self.yaw_probe = float(yaw_probe)
        self.min_quality = float(min_quality)
        self.max_correction_m = float(max_correction_m)
        self.device = torch.device(device)
        self._map: Optional[MetricMap] = None

    # -- map construction ---------------------------------------------------
    @staticmethod
    def _voxel_first_np(points: np.ndarray, res: float) -> np.ndarray:
        """Host-side exact "first point per voxel" dedup."""
        if len(points) == 0:
            return points
        return points[voxel_first_indices_np(points, res)]

    def build(self, clouds_and_poses: List[Tuple[MetricMap, Tuple[np.ndarray, np.ndarray]]]) -> None:
        """Aggregate (cloud, world_pose) pairs into the map frame: each
        keyframe voxel-deduplicated in the world frame, then the
        concatenation, hash-uniformly subsampled past ``map_capacity``.
        Keyframes that all carry an ``edges`` layer also make a
        ``map_edges`` layer, the gate's discriminative quality term."""
        pts, edge_pts = [], []
        for mm, (R, t) in clouds_and_poses:
            layer = mm.get(self.layer) or next(iter(mm.values()))
            local = to_numpy(layer)
            Rf = np.asarray(R, np.float64).T
            world_kf = (local @ Rf + np.asarray(t))
            pts.append(self._voxel_first_np(world_kf.astype(np.float32), self.voxel_size))
            if "edges" in mm:
                e = to_numpy(mm["edges"]) @ Rf + np.asarray(t)
                edge_pts.append(self._voxel_first_np(e.astype(np.float32), self.voxel_size))
        world = np.concatenate(pts).astype(np.float32) if pts else np.zeros((0, 3), np.float32)
        world = self._voxel_first_np(world, self.voxel_size)
        if len(world) > self.map_capacity:
            logging.getLogger(__name__).warning(
                "MapLocalizer: aggregate map has %d voxels > capacity %d; "
                "keeping a uniform subsample", len(world), self.map_capacity)
            world = world[hash_subsample_np(np.arange(len(world)), self.map_capacity)]
        self._map = {"map": from_points(world, capacity=self.map_capacity, device=self.device)}
        if edge_pts and len(edge_pts) == len(pts):
            e = self._voxel_first_np(np.concatenate(edge_pts).astype(np.float32),
                                     self.voxel_size)
            cap = max(256, min(self.map_capacity // 4, -(-len(e) // 256) * 256))
            if len(e) > cap:
                e = e[hash_subsample_np(np.arange(len(e)), cap)]
            self._map["map_edges"] = from_points(e, capacity=cap, device=self.device)

    def build_from_worldmodel(self, wm: WorldModel,
                              kf_poses: Dict[int, Tuple[np.ndarray, np.ndarray]]) -> None:
        """Aggregate every keyframe that has a cloud annotation, placed at
        its pose (e.g. from the local pose graph's Dijkstra estimate)."""
        items = []
        for kf, pose in sorted(kf_poses.items()):
            mm = wm.annotation(kf, ANNOTATION_NAME_PC_LAYERS)
            if mm is not None:
                items.append((mm, pose))
        self.build(items)

    @property
    def map_cloud(self) -> Optional[PointCloud]:
        return None if self._map is None else self._map["map"]

    # -- queries --------------------------------------------------------------
    def _query_params(self, with_edges: bool = False) -> ICPParams:
        p = self.params
        matchers = tuple(dataclasses.replace(m, src_layer="scan", tgt_layer="map")
                         for m in p.matchers)
        quality = tuple(dataclasses.replace(q, src_layer="scan", tgt_layer="map")
                        for q in p.quality)
        if with_edges:
            # the vertical-structure term at half the dense ratio's weight
            quality = quality + (Quality(
                kind="paired_ratio", threshold_distance=0.8,
                src_layer="scan_edges", tgt_layer="map_edges", weight=0.5),)
        return dataclasses.replace(p, matchers=matchers, quality=quality)

    def _query_src(self, scan: MetricMap) -> MetricMap:
        """Scan layers routed to the query/probe aligns: the dense layer
        always, plus the edges layer when both sides carry one."""
        layer = scan.get(self.layer) or next(iter(scan.values()))
        src = {"scan": layer}
        if self._map is not None and "map_edges" in self._map and "edges" in scan:
            src["scan_edges"] = scan["edges"]
        return src

    def _pose_on_device(self, pose: se3.Pose) -> se3.Pose:
        return se3.Pose(torch.as_tensor(pose.R, dtype=torch.float32, device=self.device),
                        torch.as_tensor(pose.t, dtype=torch.float32, device=self.device))

    def localize_raw(self, scan: MetricMap, init_pose: se3.Pose) -> ICPResult:
        """Ungated single-start query, for benchmarks and callers that vet
        the answer themselves; :meth:`localize` is the gated query."""
        if self._map is None:
            raise RuntimeError("MapLocalizer.build() first")
        src = self._query_src(scan)
        return align(src, self._map, self._pose_on_device(init_pose),
                     self._query_params(with_edges="scan_edges" in src))

    def _probe_stages(self, with_edges: bool = False) -> tuple:
        """The coarse -> fine -> sharp pipeline of the base query and the
        probes: a wide first stage (max(3 m, 1.5 sigma)) that can pull a
        probe home from 2 sigma, the query stage, and a tight polish; no
        motion-conditional refresh."""
        fine = self._query_params(with_edges=with_edges)
        fine = dataclasses.replace(fine, max_iterations=25,
                                   cand_refresh_min_trans=0.0, cand_refresh_min_rot=0.0)
        wide = max(3.0, 1.5 * self.start_sigma_xyz)
        coarse = dataclasses.replace(
            fine, max_iterations=25,
            matchers=tuple(dataclasses.replace(m, distance_threshold=wide)
                           for m in fine.matchers))
        sharp = dataclasses.replace(
            fine, max_iterations=15,
            matchers=tuple(dataclasses.replace(
                m, distance_threshold=max(0.35, 0.7 * self.voxel_size))
                for m in fine.matchers))
        return (coarse, fine, sharp)

    def localize(self, scan: MetricMap, init_pose: se3.Pose, seed: int = 0) -> LocalizeResult:
        """Gated pose of the scan in the map frame, from an initial guess.

        1. The base query: the probe pipeline from ``init_pose``, one
           unbatched run. Quality below ``min_quality`` or a correction
           beyond ``max_correction_m`` rejects without probing.
        2. The rival-basin probe: ``multi_start - 1`` displaced copies of
           the solution through the same pipeline as one lane batch.

        A probe competes when it settles outside (``agree_tol_m``,
        ``agree_tol_rot``) of the solution with quality >=
        ``alias_quality_ratio`` x the solution's; any competitor rejects
        with reason "consistency". Probes that stall at low quality do not
        reject."""
        if self._map is None:
            raise RuntimeError("MapLocalizer.build() first")
        init_pose = self._pose_on_device(init_pose)
        src = self._query_src(scan)
        stages = self._probe_stages(with_edges="scan_edges" in src)
        base = align_pipeline(src, self._map, init_pose, stages)
        # one read of the base result
        packed = torch.cat([base.pose.R.reshape(9), base.pose.t, base.cov.reshape(36),
                            torch.stack([base.quality.to(torch.float32),
                                         base.n_iterations.to(torch.float32),
                                         base.term_reason.to(torch.float32)])]).cpu().numpy()
        Rb, tb, cov = packed[:9].reshape(3, 3), packed[9:12], packed[12:48].reshape(6, 6)
        quality = float(packed[48])
        correction = float(np.linalg.norm(tb - init_pose.t.cpu().numpy()))
        k = max(1, self.multi_start)

        def result(reason, n_agree, n_compete, rival_q, dispersion):
            return LocalizeResult(
                pose=se3.Pose(Rb, tb), cov=cov, quality=quality,
                n_iterations=int(packed[49]), term_reason=int(packed[50]),
                accepted=(reason == ""), n_agree=n_agree, n_compete=n_compete,
                n_starts=k, rival_quality=rival_q, dispersion_m=dispersion,
                correction_m=correction, reject_reason=reason)

        if quality < self.min_quality:
            return result("quality", 1, 0, 0.0, 0.0)
        if correction > self.max_correction_m:
            return result("correction", 1, 0, 0.0, 0.0)
        if k == 1:
            return result("", 1, 0, 0.0, 0.0)

        gR, gt = self._probe_starts(Rb, tb, k - 1, seed)
        starts = se3.Pose(torch.as_tensor(gR, dtype=torch.float32, device=self.device),
                          torch.as_tensor(gt, dtype=torch.float32, device=self.device))
        probes = align_pipeline(src, self._map, starts, stages)
        # one read for the whole probe batch
        out = torch.cat([probes.pose.R.reshape(k - 1, 9), probes.pose.t,
                         probes.quality.to(torch.float32)[:, None]], dim=-1).cpu().numpy()
        Rs, ts, qs = out[:, :9].reshape(k - 1, 3, 3), out[:, 9:12], out[:, 12]

        dts = np.linalg.norm(ts - tb[None], axis=-1)
        tr = np.clip((np.einsum("kij,ij->k", Rs, Rb) - 1.0) / 2.0, -1.0, 1.0)
        drot = np.arccos(tr)
        agree = (dts <= self.agree_tol_m) & (drot <= self.agree_tol_rot)
        compete = (~agree) & (qs >= self.alias_quality_ratio * quality)
        n_agree = int(agree.sum()) + 1          # + the solution itself
        n_compete = int(compete.sum())
        rival_q = float(qs[~agree].max()) if (~agree).any() else 0.0
        dispersion = float(np.median(dts))
        reason = "" if n_compete == 0 else "consistency"
        return result(reason, n_agree, n_compete, rival_q, dispersion)

    def _probe_starts(self, Rb: np.ndarray, tb: np.ndarray, n: int,
                      seed: int) -> Tuple[np.ndarray, np.ndarray]:
        """``n`` probe start poses around the solution ``(Rb, tb)``: the
        {+-sigma, +-2 sigma}.{x, y} translation star with alternating
        +-``start_sigma_rot`` yaw, then pure-yaw +-``yaw_probe`` probes,
        then a Gaussian tail from ``np.random.default_rng(seed)`` (the
        reference's numbers, bit for bit)."""
        s = self.start_sigma_xyz
        star = [(s, 0.0), (-s, 0.0), (0.0, s), (0.0, -s),
                (2 * s, 0.0), (-2 * s, 0.0), (0.0, 2 * s), (0.0, -2 * s)]
        offsets, yaws = [], []
        for i in range(min(n, len(star))):
            offsets.append((star[i][0], star[i][1], 0.0))
            yaws.append(self.start_sigma_rot * (1 if i % 2 == 0 else -1))
        for sign in (1.0, -1.0):
            if len(offsets) >= n:
                break
            offsets.append((0.0, 0.0, 0.0))
            yaws.append(sign * self.yaw_probe)
        if len(offsets) < n:
            rng = np.random.default_rng(seed)
            m = n - len(offsets)
            offsets.extend(rng.normal(0.0, s, (m, 3)).tolist())
            yaws.extend(rng.normal(0.0, self.start_sigma_rot, m).tolist())
        offsets = np.asarray(offsets, np.float64)
        yaws = np.asarray(yaws, np.float64)
        c, si = np.cos(yaws), np.sin(yaws)
        Rz = np.zeros((n, 3, 3))
        Rz[:, 0, 0], Rz[:, 0, 1] = c, -si
        Rz[:, 1, 0], Rz[:, 1, 1] = si, c
        Rz[:, 2, 2] = 1.0
        return Rz @ Rb[None], tb[None] + offsets
