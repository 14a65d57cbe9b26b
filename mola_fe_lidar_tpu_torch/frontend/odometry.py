"""LidarOdometry -- the front-end module on tensors (port of the main path
of ``mola_fe_lidar_tpu/frontend/odometry.py``).

Per scan (``_process``): time gate -> generators (host -> device ingest)
-> the scan step (filters with the damped deskew twist, then the coarse-
to-fine ICP against the rolling local map or the previous scan, then,
with ``deskew_in_loop``, rounds that re-warp the filtered layers with the
twist the align implies and re-align) -> ONE readback of the packed
result -> resilience gates (weak map align falls back to scan-to-scan;
unphysical steps hold the motion model) -> twist and odometry bookkeeping
-> keyframe decision -> factor emission and the local-map rebuild (inline,
or on the pool with ``local_map_async_build``) -> the localization advert
-> the search for extra edges.

The scan step comes in three forms, as in the reference:

* pipelined (``pipelined_scan_step``, the default): the filter (or the
  output of the previous scan's prefetch), the align, then -- before this
  scan's result is read back, and before its gates and twist update --
  the next queued scan's ingest and filter with the damped twist as it
  stands now (``_prefetch_next``). A prefetch whose timestamp is not the
  next processed scan's is thrown away. A prefetch that raises disables
  the pipeline for good (``doProcess.prefetch_disabled``).
* fused (``pipelined_scan_step: false``): filter and align, one readback.
* unfused (``fused_scan_step: false``): the filter, a sanity readback,
  then the align.

On CUDA the result is copied into pinned memory behind an event before the
prefetch is enqueued, and ingests go through pinned memory without
blocking, so the next scan's ingest and filter queue behind the align
instead of waiting for it.

The search (``check_for_nearby_kfs``) walks the local pose graph from the
newest keyframe. Keyframes in the distance window become nearby-align
checks, all of one scan aligned as ONE batch (``_check_nearby_batch``);
the nearest keyframe at a large graph distance becomes a loop-closure
check, an align of Monte-Carlo-perturbed guesses as one batch against a
submap around the candidate (``_check_non_adjacent``). Both run on a
two-worker pool beside the scan thread; accepted results become factors
and graph edges.

Every setting of the reference's front-end is ported.
``precompile_rare_paths`` is accepted and does nothing: the port compiles
no programs, and :meth:`LidarOdometry.warm_start` builds the CUDA kernels
and runs every primary program once.

Device mesh (``mesh_data`` x ``mesh_model`` positions of
``parallel/mesh.py::devices``, the chip analogue of the reference's worker
fan-out): ``mesh_data`` > 1 splits the lanes of the nearby batch and of the
loop-closure Monte-Carlo batch over a ``data`` axis (the nearby batch pads
to a multiple of it, the Monte-Carlo sample count rounds up to one);
``mesh_model`` > 1 splits the map align's target (the rolling local map,
split anew after every rebuild) on its point axis over a ``model`` axis,
without the candidate cache. With fewer positions than the mesh needs the
module warns and runs on its one device, as the reference does.

Threads and streams: the pool's jobs launch their kernels on the same CUDA
stream as the scan step (each thread's current stream is the device's
default stream), so device work of the search and of the scan is ordered,
never concurrent. That is correct without events or ``record_stream``: a
keyframe cloud the scan thread made is complete before any later launch
reads it, and no allocation is reused under a running batch. A side stream
for the pool measured no faster: both threads are host-bound (PERF.md).
"""

from __future__ import annotations

import dataclasses
import functools
import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Set, Tuple

import numpy as np
import torch

from ..cloud.metric_map import MetricMap, PointCloud, host_to_device
from ..filters.base import FilterPipeline
from ..filters.generators import apply_generators, generators_from_config
from ..filters.pipeline import FilterDeskew, delta_redeskew
from ..geometry import se3, se3_np
from ..models.config import AlignKind
from ..models.icp import (_CAND_KINDS, _CAND_KNN_KINDS, ICPResult, align_pipeline,
                          check_params)
from ..models.presets import icp_cases_kitti
from ..parallel import mesh as mesh_mod
from ..parallel.batch import data_parallel, monte_carlo_guesses
from ..parallel.distributed import shard_points
from ..utils.config import DEG2RAD, yaml_get
from ..utils.profiler import ProfilerEntry
from .backend import (AdvertiseLocalization, FactorRelativePose3, HostPose,
                      ProposeKFInput)
from .icp_config import icp_stages_from_config
from .local_map import DeviceLocalMap, LocalMap
from .module_base import MODULE_REGISTRY, FrontEndBase, RawObservation
from .pose_graph import PoseGraph, make_pose_graph
from .worldmodel import (ANNOTATION_NAME_PC_LAYERS, ANNOTATION_NAME_RENDER_DECORATION,
                         WorldModel)


def _pack_icp_result(res: ICPResult) -> torch.Tensor:
    """One f32 vector per align (``[B, 51]`` for a batch), so the host
    reads the result back once."""
    lanes = res.pose.t.shape[:-1]
    return torch.cat([
        res.pose.R.reshape(*lanes, 9), res.pose.t, res.cov.reshape(*lanes, 36),
        torch.stack([res.quality.to(torch.float32),
                     res.n_iterations.to(torch.float32),
                     res.term_reason.to(torch.float32)], dim=-1),
    ], dim=-1)


def _packed_align(src_map: MetricMap, tgt_map: MetricMap, guess_R, guess_t,
                  stages) -> torch.Tensor:
    """``align_pipeline`` packed per lane: the guesses ``[3,3]``/``[3]`` give
    one align, ``[B,3,3]``/``[B,3]`` a batch (layers ``[N,3]`` shared by
    every lane, ``[B,N,3]`` per lane) -- one dispatch sequence and one
    readback for every nearby candidate or Monte-Carlo guess of a check."""
    return _pack_icp_result(align_pipeline(src_map, tgt_map, se3.Pose(guess_R, guess_t), stages))


@functools.lru_cache(maxsize=None)
def _decim_sel(n: int, keep: int) -> np.ndarray:
    """Fixed hash-decorrelated subsample indices, sorted (a permutation
    slice: layer buffers are voxel/azimuth-sorted, so a prefix would be a
    spatial slab)."""
    return np.sort(np.random.default_rng(0xD15CA7E).permutation(n)[:keep])


def _decimate_layers(mm: MetricMap, k: int) -> MetricMap:
    """1/k hash-stratified subsample of every layer; capacities stay
    256-bucketed and layers at or below 256 points are kept whole."""
    if k <= 1:
        return mm
    out = {}
    for name, pc in mm.items():
        n = pc.capacity
        keep = max(256, (n // k) // 256 * 256)
        if keep >= n:
            out[name] = pc
            continue
        sel = torch.from_numpy(_decim_sel(n, keep)).to(pc.xyz.device)
        out[name] = PointCloud(
            pc.xyz[..., sel, :], pc.mask[..., sel],
            {a: (v[..., sel] if v.dim() == pc.mask.dim() else v[..., sel, :])
             for a, v in pc.attrs.items()})
    return out


def _stack_maps(clouds: List[MetricMap]) -> MetricMap:
    """Lane-stack maps of one layer structure; ValueError when the layers,
    attributes or capacities differ."""
    first = clouds[0]
    for mm in clouds[1:]:
        if set(mm) != set(first):
            raise ValueError("clouds with different layers")
        for name, pc in mm.items():
            ref = first[name]
            if (pc.xyz.shape != ref.xyz.shape or set(pc.attrs) != set(ref.attrs)
                    or any(v.shape != ref.attrs[a].shape for a, v in pc.attrs.items())):
                raise ValueError(f"layer {name!r} differs between clouds")
    return {name: PointCloud(torch.stack([mm[name].xyz for mm in clouds]),
                             torch.stack([mm[name].mask for mm in clouds]),
                             {a: torch.stack([mm[name].attrs[a] for mm in clouds])
                              for a in pc.attrs})
            for name, pc in first.items()}


class _Readback:
    """A device vector on its way to the host: on CUDA, a copy into pinned
    memory behind an event, so launches enqueued after it (the prefetch)
    do not delay it; :meth:`wait` blocks until it has landed."""

    def __init__(self, x: torch.Tensor):
        if x.device.type == "cuda":
            self._buf = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
            self._buf.copy_(x, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record()
        else:
            self._buf, self._event = x, None

    def wait(self) -> np.ndarray:
        if self._event is not None:
            self._event.synchronize()
        return self._buf.numpy()


@dataclass
class ICPOutput:
    success: bool
    goodness: float
    found_pose_to_wrt_from: HostPose  # f32 numpy
    cov: np.ndarray
    n_iterations: int = 0


def _unpack_icp_result(flat: np.ndarray) -> ICPOutput:
    R = np.asarray(flat[:9], np.float64).reshape(3, 3)
    t = np.asarray(flat[9:12], np.float64)
    quality = float(flat[48])
    return ICPOutput(
        success=bool(np.isfinite(quality)),
        goodness=quality if np.isfinite(quality) else 0.0,
        found_pose_to_wrt_from=HostPose(R.astype(np.float32), t.astype(np.float32)),
        cov=np.asarray(flat[12:48], np.float64).reshape(6, 6),
        n_iterations=int(flat[49]))


def _np_pose(p: HostPose) -> Tuple[np.ndarray, np.ndarray]:
    # project the device f32 rotation back onto SO(3) before it chains
    # into world/accum state and graph edges (see the reference)
    return (se3_np.orthonormalize(np.asarray(p.R, np.float64)),
            np.asarray(p.t, np.float64))


def _f32_pose(R, t) -> HostPose:
    return HostPose(np.asarray(R, np.float32), np.asarray(t, np.float32))


@dataclass
class LidarOdometryParameters:
    """The ported tunables; defaults and meaning as in the reference's
    ``LidarOdometryParameters``."""

    min_time_between_scans: float = 0.2
    min_dist_xyz_between_keyframes: float = 1.0
    min_rotation_between_keyframes: float = 30.0 * DEG2RAD
    min_icp_goodness: float = 0.4
    min_icp_goodness_lc: float = 0.6
    min_icp_goodness_lc_auto: bool = False
    lc_submap_keyframes: int = 0
    lc_submap_capacity_mult: int = 2
    min_dist_to_matching: float = 6.0
    max_dist_to_matching: float = 12.0
    max_dist_to_loop_closure: float = 30.0
    loop_closure_montecarlo_samples: int = 10
    max_nearby_align_checks: int = 2
    min_topo_dist_to_consider_loopclosure: int = 20
    max_KFs_local_graph: int = 50000
    viz_decor_decimation: int = 5
    viz_decor_pointsize: float = 2.0
    max_queue_length: int = 10
    max_correction_ratio: float = 0.2
    fused_scan_step: bool = True
    pipelined_scan_step: bool = True
    # accepted for the reference's configurations: the port compiles
    # nothing ahead of time, so there is nothing to precompile
    precompile_rare_paths: bool = True
    deskew_twist_smoothing: float = 0.5
    deskew_max_accel: float = 10.0
    deskew_max_rot_accel: float = 5.0
    deskew_twist_max_age: int = 5
    deskew_in_loop: bool = False
    deskew_refine_iters: int = 10
    deskew_refine_min_quality: float = 0.3
    deskew_refine_rounds: int = 2
    odometry_reference: str = "last_scan"
    local_map_keyframes: int = 10
    local_map_capacity_mult: Any = 4
    local_map_dedup_voxel: float = 0.25
    local_map_reseed_after: int = 10
    local_map_async_build: bool = False
    local_map_min_abs_step_trans: float = 5e-5
    local_map_min_abs_step_rot: float = 1e-5
    local_map_max_match_distance: float = 0.0
    local_map_cand_k: int = 4
    local_map_cand_knn: bool = False
    local_map_max_iterations: int = 0
    local_map_nn_backend: str = ""
    local_map_quality_max_points: int = 8192
    local_map_tight_requires_prior: bool = True
    local_map_cand_motion_trans: float = 0.0
    local_map_cand_motion_rot: float = 0.0
    local_map_gn_inner: int = 0
    local_map_build_mode: str = "sort"
    local_map_device_build: bool = True
    local_map_min_views: int = 1
    local_map_transient_voxel: float = 0.0
    local_map_protect_recent: int = 2
    nearby_max_iterations: int = 0
    nearby_cand_knn: bool = False
    nearby_decimate: int = 1
    nearby_cand_k: int = 4
    max_sensor_speed: float = 30.0
    max_sensor_rot_rate: float = 2.0
    # device mesh: data positions for the search's batches, model positions
    # for the map align's target (1/1 = one device)
    mesh_data: int = 1
    mesh_model: int = 1


@dataclass
class MethodState:
    last_obs_tim: Optional[float] = None
    last_points: Optional[MetricMap] = None
    twist: np.ndarray = field(default_factory=lambda: np.zeros(6))
    twist_is_good: bool = False
    twist_smooth: np.ndarray = field(default_factory=lambda: np.zeros(6))
    twist_smooth_age: int = 10**9
    world_R: np.ndarray = field(default_factory=lambda: np.eye(3))
    world_t: np.ndarray = field(default_factory=lambda: np.zeros(3))
    local_map: Optional[MetricMap] = None
    last_kf: Optional[int] = None
    accum_since_last_kf_R: np.ndarray = field(default_factory=lambda: np.eye(3))
    accum_since_last_kf_t: np.ndarray = field(default_factory=lambda: np.zeros(3))
    kf_decor_counter: int = 0
    local_pose_graph: PoseGraph = field(default_factory=make_pose_graph)
    checked_KF_pairs: Set[Tuple[int, int]] = field(default_factory=set)
    mc_seed: int = 0
    # append-only mirror of the graph's edges (a, b, R, t), and the
    # accepted loop-closure pairs
    edge_log: list = field(default_factory=list)
    lc_pairs: list = field(default_factory=list)


@MODULE_REGISTRY.register("LidarOdometry")
@MODULE_REGISTRY.register("mola::LidarOdometry")
class LidarOdometry(FrontEndBase):
    """LiDAR odometry front-end: scans in -> keyframes + SE(3) factors out.
    All device tensors live on ``device``."""

    def __init__(self, name: Optional[str] = None, device="cuda"):
        super().__init__(name)
        self.device = torch.device(device)
        self.params = LidarOdometryParameters()
        self.icp_cases: Dict[AlignKind, tuple] = {}
        self.generators = []
        self.filter_pipeline = FilterPipeline()
        self.worldmodel: Optional[WorldModel] = None
        self.state = MethodState()
        self._state_lock = threading.Lock()  # local graph, checked pairs, seeds
        self._pipeline_pool = ThreadPoolExecutor(1, thread_name_prefix="scan")
        self._nearby_pool = ThreadPoolExecutor(2, thread_name_prefix="pastkf")
        self._pending = 0
        self._nearby_inflight = 0
        self._pending_lock = threading.Lock()
        # accepted nearby-align goodness: the evidence of the auto LC gate
        self._nearby_goodness = deque(maxlen=64)
        self._last_positive_dt: Optional[float] = None
        self._local_map_builder = None  # made at the first keyframe in local_map mode
        self._map_fail_streak = 0
        # pipelined scan step: the intake-order mirror of the scan queue
        # (one observation of lookahead), the prefetched (timestamp,
        # layers, sanity) and the kill switch
        self._lookahead = deque()
        self._prefetched = None
        self._pipelined_ok = True
        # asynchronous map rebuild: one build in flight, a dirty flag
        self._map_build_lock = threading.Lock()
        self._map_build_inflight = False
        self._map_build_dirty = False
        # device mesh (``initialize``) and the local map split over its
        # model axis: (the map, its split)
        self._mesh = None
        self._map_split = (None, None)

    # ------------------------------------------------------------------
    def initialize(self, cfg: Dict[str, Any]) -> None:
        """Parse the module's ``params`` block; raise ValueError for
        settings the reference rejects."""
        c = cfg.get("params", cfg)
        p = self.params
        for f in dataclasses.fields(p):
            if f.name in ("min_rotation_between_keyframes", "min_icp_goodness_lc",
                          "min_icp_goodness_lc_auto"):
                continue
            v = yaml_get(c, f.name, default=getattr(p, f.name))
            if f.name == "local_map_capacity_mult":
                v = {str(k): int(x) for k, x in v.items()} if isinstance(v, dict) else int(v)
            elif isinstance(f.default, bool):
                v = bool(v)
            elif isinstance(f.default, (int, float, str)):
                v = type(f.default)(v)
            setattr(p, f.name, v)
        if "min_rotation_between_keyframes" in c:
            p.min_rotation_between_keyframes = yaml_get(
                c, "min_rotation_between_keyframes", deg_to_rad=True)
        lc_gate = yaml_get(c, "min_icp_goodness_lc", default=p.min_icp_goodness_lc)
        if isinstance(lc_gate, str) and lc_gate.strip().lower() == "auto":
            p.min_icp_goodness_lc_auto = True
        else:
            p.min_icp_goodness_lc = float(lc_gate)
        p.min_icp_goodness_lc_auto = bool(yaml_get(c, "min_icp_goodness_lc_auto",
                                                   default=p.min_icp_goodness_lc_auto))
        if p.odometry_reference not in ("last_scan", "local_map"):
            raise ValueError(f"odometry_reference must be last_scan|local_map, "
                             f"got {p.odometry_reference!r}")
        if p.local_map_build_mode not in ("sort", "hash"):
            raise ValueError(f"local_map_build_mode must be sort|hash, "
                             f"got {p.local_map_build_mode!r}")

        self.icp_cases = {}
        for key, kind in (("icp_settings_with_vel", AlignKind.LIDAR_ODOMETRY),
                          ("icp_settings_without_vel", AlignKind.NEARBY_ALIGN),
                          ("icp_settings_loop_closure", AlignKind.LOOP_CLOSURE)):
            if c.get(key):
                self.icp_cases[kind] = icp_stages_from_config(c[key])
        if not self.icp_cases:
            self.icp_cases = {k: (v,) for k, v in icp_cases_kitti().items()}
        for kind in AlignKind:
            self.icp_cases.setdefault(kind, next(iter(self.icp_cases.values())))
        # every stage the odometry and the search can run
        for kind in AlignKind:
            for for_map in (False, True):
                for stage in self._stages_for(kind, for_map):
                    check_params(stage)
        for stage in self._nearby_stages():
            check_params(stage)

        gen_cfg = c.get("pointcloud_generator")
        filt_cfg = list(c.get("pointcloud_filter") or [])
        if filt_cfg == [] and "pointcloud_filter_class" in c:
            filt_cfg = [{"class": c["pointcloud_filter_class"],
                         "params": c.get("pointcloud_filter_params", {})}]
        # the reference preset's point-count cap, a real filter here
        cap_count = int(yaml_get(c, "decimate_to_point_count", default=0) or 0)
        if cap_count > 0:
            filt_cfg.insert(0, {"class": "FilterDecimateToCount", "params": {"count": cap_count}})
        self.generators = generators_from_config(gen_cfg, device=self.device)
        self.filter_pipeline = FilterPipeline.from_config(filt_cfg)
        if self.worldmodel is None:
            self.worldmodel = self.find_service(WorldModel) or WorldModel(device=self.device)

        self._mesh = None
        if p.mesh_data > 1 or p.mesh_model > 1:
            need = p.mesh_data * p.mesh_model
            have = mesh_mod.devices(self.device.type)
            if len(have) >= need:
                self._mesh = mesh_mod.make_mesh({"data": p.mesh_data, "model": p.mesh_model}, have)
                self.log.info("device mesh: data=%d model=%d", p.mesh_data, p.mesh_model)
            else:
                self.log.warning("mesh data=%d model=%d needs %d devices, found %d — "
                                 "falling back to single-device",
                                 p.mesh_data, p.mesh_model, need, len(have))

    def reset(self) -> None:
        """Start over from an empty state (keyframes in the world model
        stay)."""
        with self._state_lock:
            self.state = MethodState()
            self._local_map_builder = None
            self._map_fail_streak = 0
            self._last_positive_dt = None
            self._prefetched = None

    def state_copy(self) -> MethodState:
        """A deep snapshot: its own pose graph (rebuilt from the edge log,
        without pruned nodes), edge log, checked pairs and arrays, so the
        caller can read it while the pipeline goes on."""
        with self._state_lock:
            st = self.state
            g = make_pose_graph()
            live = set(st.local_pose_graph.nodes)
            if st.local_pose_graph.root is not None:
                g.insert_node(st.local_pose_graph.root)
            for n in sorted(live):
                g.insert_node(n)
            for a, b, R, t in st.edge_log:
                if a in live and b in live:
                    g.insert_edge(a, b, R, t)
            return dataclasses.replace(
                st, twist=np.array(st.twist), twist_smooth=np.array(st.twist_smooth),
                world_R=np.array(st.world_R), world_t=np.array(st.world_t),
                accum_since_last_kf_R=np.array(st.accum_since_last_kf_R),
                accum_since_last_kf_t=np.array(st.accum_since_last_kf_t),
                local_pose_graph=g, checked_KF_pairs=set(st.checked_KF_pairs),
                edge_log=list(st.edge_log), lc_pairs=list(st.lc_pairs))

    def spin_once(self) -> None:
        """Periodic heartbeat: records the scan queue's depth and the
        nearby checks in flight (the reference's ``spin_once``)."""
        with ProfilerEntry(self.profiler, "spinOnce"):
            with self._pending_lock:
                self.profiler.register_user_measure("spinOnce.pending_scans", self._pending)
                self.profiler.register_user_measure("spinOnce.nearby_inflight",
                                                    self._nearby_inflight)

    # ------------------------------------------------------------------
    def on_new_observation(self, obs: RawObservation):
        if self.raw_sensor_label and obs.get("sensor_label") != self.raw_sensor_label:
            return None
        with self._pending_lock:
            queued = self._pending
            self.profiler.register_user_measure("onNewObservation.queue_length", queued)
            if queued > self.params.max_queue_length:
                self.profiler.register_user_measure("onNewObservation.drop_observation", 1)
                self.log.error_throttle(
                    1.0, "Dropping observation due to pipeline overload (%d queued)", queued)
                return None
            self._pending += 1
            self._lookahead.append(obs)
        self.profiler.enter("delay_onNewObs_to_process")
        return self._pipeline_pool.submit(self._process_safe, obs)

    def _process_safe(self, obs: RawObservation) -> None:
        try:
            self._process(obs)
        except Exception:  # noqa: BLE001 -- per-scan error isolation
            self.log.exception("exception processing scan")
        finally:
            with self._pending_lock:
                self._pending -= 1

    def _process(self, obs: RawObservation) -> None:
        prof = self.profiler
        prof.leave("delay_onNewObs_to_process")
        prof.enter("doProcessNewObservation")
        try:
            self._process_scan(obs)
        finally:
            prof.leave("doProcessNewObservation")

    def _process_scan(self, obs: RawObservation) -> None:
        prof = self.profiler
        pp = self.params
        tim = float(obs.get("timestamp", 0.0))
        st = self.state
        # this observation leaves the intake mirror (a direct call that
        # bypassed the intake is simply not in it)
        with self._pending_lock:
            if self._lookahead and self._lookahead[0] is obs:
                self._lookahead.popleft()
        if st.last_obs_tim is not None and tim - st.last_obs_tim < pp.min_time_between_scans:
            prof.register_user_measure("doProcess.skip_too_soon", 1)
            return

        # the previous scan's prefetch of this one: its ingest and filter
        # are already queued on the device
        pf, self._prefetched = self._prefetched, None
        if pf is not None and pf[0] != tim:
            pf = None  # time-gated or reordered: discard
        raw_map = None
        if pf is None:
            prof.enter("doProcess.generators")
            raw_map = apply_generators(self.generators, obs)
            prof.leave("doProcess.generators")

        last_points, last_tim = st.last_points, st.last_obs_tim
        icp_out = None
        result_is_world = False
        dt = 0.0
        if last_points is not None:
            dt = tim - last_tim if last_tim is not None else 0.0
            if dt > 1e-3:
                self._last_positive_dt = dt
            if st.twist_is_good and dt > 0:
                gR, gt_ = se3_np.exp(st.twist * dt)
                kind = AlignKind.LIDAR_ODOMETRY
            else:
                gR, gt_ = np.eye(3), np.zeros(3)
                kind = AlignKind.NEARBY_ALIGN
            use_map = pp.odometry_reference == "local_map" and st.local_map is not None
            if use_map:
                gR, gt_ = se3_np.compose((st.world_R, st.world_t), (gR, gt_))
                icp_target = st.local_map
            else:
                icp_target = last_points
            # deskew only with the DAMPED twist (see the reference's docs)
            deskew_twist = self._deskew_twist()
            if pp.fused_scan_step:
                this_points, flat = self._scan_step(obs, raw_map, pf, kind, use_map, icp_target,
                                                    gR, gt_, deskew_twist, dt)
                if self._degenerate(flat[51:53]):
                    return
                icp_out = _unpack_icp_result(flat)
            else:
                this_points = self._filtered(obs, raw_map, pf, deskew_twist)
                if this_points is None:
                    return
                icp_out = self.run_one_icp(this_points, icp_target, gR, gt_,
                                           stages=self._stages_for(kind, use_map),
                                           tag="icp_latest")
            icp_out, result_is_world = self._gate(icp_out, use_map, kind, dt,
                                                  this_points, last_points)
        else:
            this_points = self._filtered(obs, raw_map, pf, np.zeros(6))
            if this_points is None:
                return

        st.last_points = this_points
        st.last_obs_tim = tim

        create_keyframe = last_points is None  # first scan
        if last_points is not None:
            R, t = _np_pose(icp_out.found_pose_to_wrt_from)
            if result_is_world:
                # ICP returned the WORLD pose; bookkeeping uses the relative
                # pose rel = world_prev^-1 * world_new
                world_new = (R, np.asarray(t, float))
                R = st.world_R.T @ world_new[0]
                t = st.world_R.T @ (world_new[1] - st.world_t)
                st.world_R, st.world_t = world_new
            else:
                st.world_R, st.world_t = se3_np.compose((st.world_R, st.world_t), (R, t))
            if dt > 0 and icp_out.success:
                st.twist = se3_np.log(R, t) / dt
            st.twist_is_good = icp_out.success and icp_out.goodness >= pp.min_icp_goodness
            self._update_deskew_twist(dt)
            st.accum_since_last_kf_R, st.accum_since_last_kf_t = (
                st.accum_since_last_kf_R @ R,
                st.accum_since_last_kf_R @ t + st.accum_since_last_kf_t)
            dist = float(np.linalg.norm(st.accum_since_last_kf_t))
            rot = se3_np.rotation_angle(st.accum_since_last_kf_R)
            create_keyframe = icp_out.goodness > pp.min_icp_goodness and (
                dist > pp.min_dist_xyz_between_keyframes
                or rot > pp.min_rotation_between_keyframes)
            prof.register_user_measure("icp_latest.goodness", icp_out.goodness)
            prof.register_user_measure("icp_latest.n_iter", icp_out.n_iterations)

        if create_keyframe:
            self._create_keyframe(tim, this_points)

        if self.slam_backend is not None and st.last_kf is not None:
            self.slam_backend.advertise_updated_localization(AdvertiseLocalization(
                timestamp=tim, reference_kf=st.last_kf,
                pose=_f32_pose(st.accum_since_last_kf_R, st.accum_since_last_kf_t)))
        # search for extra edges
        with self._state_lock:
            graph_nonempty = len(st.local_pose_graph) > 0
        if graph_nonempty:
            self.check_for_nearby_kfs()

    def _deskew_twist(self) -> np.ndarray:
        st = self.state
        return (st.twist_smooth if st.twist_smooth_age <= self.params.deskew_twist_max_age
                else np.zeros(6))

    def _filtered(self, obs, raw_map, pf, twist) -> Optional[MetricMap]:
        """The filter with a sanity readback (the first scan and the
        unfused step); None, counted, for a degenerate scan."""
        prof = self.profiler
        prof.enter("doProcess.filter")
        if pf is not None:
            points, sanity = pf[1], pf[2]
        else:
            if raw_map is None:
                raw_map = apply_generators(self.generators, obs)
            points, sanity = self._filter_core(raw_map, self._on_device(twist))
        sanity = sanity.cpu().numpy()
        prof.leave("doProcess.filter")
        return None if self._degenerate(sanity) else points

    def _degenerate(self, sanity) -> bool:
        """True, counted and logged, for a scan with fewer than 10 valid
        points or a non-finite one (``sanity`` = [total, all-finite])."""
        if sanity[1] < 0.5 or sanity[0] < 10.0:
            self.profiler.register_user_measure("doProcess.drop_insane_scan", 1)
            self.log.error_throttle(1.0, "Dropping degenerate scan (empty/non-finite)")
            return True
        return False

    def _scan_step(self, obs, raw_map, pf, kind, use_map, target, guess_R, guess_t,
                   twist, dt):
        """Filter + align + pack, ending in the scan's one readback: 51
        result values and the 2 sanity values. Pipelined, the filter may be
        the prefetch's, and the next queued scan is ingested and filtered
        behind the align before the readback is awaited."""
        prof, st = self.profiler, self.state
        prof.enter("doProcess.fused_step")
        try:
            tw = self._on_device(twist)
            prev = (st.world_R, st.world_t) if use_map else (np.eye(3), np.zeros(3))
            pipelined = self.params.pipelined_scan_step and self._pipelined_ok
            if pipelined and pf is not None:
                mm, sanity = pf[1], pf[2]
            else:
                if raw_map is None:  # prefetched, but the pipeline is off now
                    raw_map = apply_generators(self.generators, obs)
                mm, sanity = self._filter_core(raw_map, tw)
            if pipelined:
                prof.enter("doProcess.align_dispatch")
            mm, res = self._align_core(kind, use_map, mm, target, guess_R, guess_t, tw,
                                       prev, dt)
            host = _Readback(torch.cat([_pack_icp_result(res), sanity]))
            if pipelined:
                prof.leave("doProcess.align_dispatch")
                self._prefetch_next()
            prof.enter("doProcess.readback_wait")
            flat = host.wait()  # the single readback
            prof.leave("doProcess.readback_wait")
        finally:
            prof.leave("doProcess.fused_step")
        return mm, flat

    def _prefetch_next(self) -> None:
        """Ingest and filter the next queued scan while this scan's align
        runs, deskewed with the damped twist as it stands now (one scan
        staler than the serial path). A scan the time gate drops later
        discards its prefetch. An error disables the pipeline for good:
        later scans take the fused path, where errors raise."""
        if not (self.params.pipelined_scan_step and self._pipelined_ok
                and self.params.fused_scan_step):
            return
        with self._pending_lock:
            nxt = self._lookahead[0] if self._lookahead else None
        if nxt is None:
            return
        tim = float(nxt.get("timestamp", 0.0))
        prof = self.profiler
        prof.enter("doProcess.prefetch_ingest")
        try:
            raw = apply_generators(self.generators, nxt)
            mm, sanity = self._filter_core(raw, self._on_device(self._deskew_twist()))
            self._prefetched = (tim, mm, sanity)
        except Exception:  # noqa: BLE001 -- speculative work only
            self._pipelined_ok = False
            self._prefetched = None
            prof.register_user_measure("doProcess.prefetch_disabled", 1)
            self.log.warning("prefetch filter failed; disabling the pipelined scan step",
                             exc_info=True)
        finally:
            prof.leave("doProcess.prefetch_ingest")

    def _gate(self, icp_out: ICPOutput, use_map: bool, kind: AlignKind, dt: float,
              this_points: MetricMap, last_points: MetricMap):
        """Resilience gates: a weak or unphysical map align retries scan-to-
        scan and keeps the better result, and a persistently failing map is
        dropped; an unphysical result holds the motion model. Returns
        (output, result_is_world)."""
        st, pp, prof = self.state, self.params, self.profiler
        dt_gate = dt if dt > 1e-3 else (self._last_positive_dt or 0.1)
        max_step = pp.max_sensor_speed * dt_gate
        max_rot_step = pp.max_sensor_rot_rate * dt_gate
        motion = (se3_np.exp(st.twist * dt) if (st.twist_is_good and dt > 0)
                  else (np.eye(3), np.zeros(3)))

        def rel_norm(out, is_world):
            Rp, tp = _np_pose(out.found_pose_to_wrt_from)
            if is_world:
                tp = st.world_R.T @ (tp - st.world_t)
                Rp = st.world_R.T @ Rp
            return float(np.linalg.norm(tp)), se3_np.rotation_angle(Rp)

        def jump(out, is_world):
            tn, ra = rel_norm(out, is_world)
            return tn > max_step or ra > max_rot_step

        def motion_model_output():
            return ICPOutput(success=False, goodness=0.0,
                             found_pose_to_wrt_from=_f32_pose(*motion),
                             cov=np.eye(6) * 1e6)

        if not use_map:
            if jump(icp_out, False):
                prof.register_user_measure("doProcess.reject_unphysical", 1)
                self.log.warning("odometry align rejected: unphysical step %.1fm/%.2frad "
                                 "(max %.1fm/%.2frad)", *rel_norm(icp_out, False),
                                 max_step, max_rot_step)
                return motion_model_output(), False
            return icp_out, False

        map_jump = jump(icp_out, True)
        if not (map_jump or icp_out.goodness < pp.min_icp_goodness):
            self._map_fail_streak = 0
            return icp_out, True
        self._map_fail_streak += 1
        prof.register_user_measure("doProcess.map_align_weak", 1)
        if map_jump:
            self.log.warning("map align rejected: unphysical step %.1fm/%.2frad "
                             "(max %.1fm/%.2frad)", *rel_norm(icp_out, True),
                             max_step, max_rot_step)
        fb = self.run_one_icp(this_points, last_points, *motion,
                              stages=self.icp_cases[kind], tag="icp_latest_s2s_fallback")
        out, is_world = icp_out, True
        if not jump(fb, False) and (map_jump or fb.goodness > icp_out.goodness):
            out, is_world = fb, False
        elif map_jump:  # both unphysical: hold the motion model
            prof.register_user_measure("doProcess.reject_unphysical", 1)
            out, is_world = motion_model_output(), False
        if self._map_fail_streak > pp.local_map_reseed_after:
            self.log.warning("local map failing for %d scans; reseeding at next "
                             "keyframe", self._map_fail_streak)
            with self._state_lock:
                self._local_map_builder = None
                st.local_map = None
            self._map_fail_streak = 0
        return out, is_world

    def _update_deskew_twist(self, dt: float) -> None:
        """Damped deskew twist: EMA over validated raw estimates plus a
        physical acceleration clamp."""
        st, pp = self.state, self.params
        if dt > 0 and st.twist_is_good:
            if st.twist_smooth_age > pp.deskew_twist_max_age:
                st.twist_smooth = np.array(st.twist, np.float64)
            else:
                dv = np.array(st.twist, np.float64) - st.twist_smooth
                span = dt * (1 + st.twist_smooth_age)
                np.clip(dv[:3], -pp.deskew_max_accel * span, pp.deskew_max_accel * span,
                        out=dv[:3])
                np.clip(dv[3:], -pp.deskew_max_rot_accel * span,
                        pp.deskew_max_rot_accel * span, out=dv[3:])
                st.twist_smooth = st.twist_smooth + pp.deskew_twist_smoothing * dv
            st.twist_smooth_age = 0
        else:
            st.twist_smooth_age += 1

    def _stages_for(self, kind: AlignKind, for_map: bool):
        """Stage params of an align; map targets get the module's map-align
        levers (see the reference's parameter docs)."""
        stages = self.icp_cases[kind]
        if not for_map:
            return stages
        p = self.params
        tight = kind == AlignKind.LIDAR_ODOMETRY or not p.local_map_tight_requires_prior
        out = []
        for s in stages:
            matchers = s.matchers
            if tight and p.local_map_max_match_distance > 0:
                matchers = tuple(dataclasses.replace(
                    m, distance_threshold=min(m.distance_threshold,
                                              p.local_map_max_match_distance))
                    for m in matchers)
            if p.local_map_cand_k > 0:
                matchers = tuple(dataclasses.replace(m, cand_k=p.local_map_cand_k)
                                 if m.kind in _CAND_KINDS else m for m in matchers)
            if p.local_map_cand_knn and p.local_map_cand_k > 0:
                # knn + 3 slack so the between-refresh re-argmin can move
                matchers = tuple(dataclasses.replace(m, cand_k=max(p.local_map_cand_k, m.knn + 3))
                                 if m.kind in _CAND_KNN_KINDS else m for m in matchers)
            if p.local_map_nn_backend:
                matchers = tuple(dataclasses.replace(m, nn_backend=p.local_map_nn_backend)
                                 for m in matchers)
            solver = s.solver
            step_t = max(s.min_abs_step_trans, p.local_map_min_abs_step_trans)
            step_r = max(s.min_abs_step_rot, p.local_map_min_abs_step_rot)
            if p.local_map_gn_inner > 0 and solver.kind == "gauss_newton":
                ratio = p.local_map_gn_inner / max(solver.max_iterations, 1)
                step_t, step_r = step_t * ratio, step_r * ratio
                solver = dataclasses.replace(solver, max_iterations=p.local_map_gn_inner)
            repl = dict(matchers=matchers, solver=solver,
                        min_abs_step_trans=step_t, min_abs_step_rot=step_r)
            if p.local_map_quality_max_points > 0:
                repl["quality"] = tuple(dataclasses.replace(
                    q, max_points=(p.local_map_quality_max_points if q.max_points == 0
                                   else min(q.max_points, p.local_map_quality_max_points)))
                    for q in s.quality)
            if tight and p.local_map_max_iterations > 0:
                repl["max_iterations"] = min(s.max_iterations, p.local_map_max_iterations)
            if p.local_map_cand_motion_trans > 0:
                repl["cand_refresh_min_trans"] = p.local_map_cand_motion_trans
            if p.local_map_cand_motion_rot > 0:
                repl["cand_refresh_min_rot"] = p.local_map_cand_motion_rot
            out.append(dataclasses.replace(s, **repl))
        return tuple(out)

    def _filter_core(self, raw_map: MetricMap, twist: torch.Tensor):
        """Filters -> (layers, [total valid points, all-finite flag])."""
        mm = raw_map
        for f in self.filter_pipeline.filters:
            mm = f(mm, twist=twist) if isinstance(f, FilterDeskew) else f(mm)
        total = torch.zeros((), dtype=torch.float32, device=self.device)
        finite = torch.ones((), dtype=torch.float32, device=self.device)
        for pc in mm.values():
            total = total + torch.sum(pc.mask)
            masked = torch.where(pc.mask[..., None] > 0.5, pc.xyz, torch.zeros_like(pc.xyz))
            finite = finite * torch.isfinite(torch.sum(masked)).to(torch.float32)
        return mm, torch.stack([total, finite])

    def _deskew_filter(self) -> Optional[FilterDeskew]:
        return next((f for f in self.filter_pipeline.filters if isinstance(f, FilterDeskew)),
                    None)

    def _align_core(self, kind, use_map, mm, target, guess_R, guess_t, twist, prev, dt):
        """The scan's coarse-to-fine align and, with ``deskew_in_loop``,
        the two-pass rounds: the twist implied by the align (relative to
        ``prev``, the previous world pose, for a map target), clamped to
        the physical rates, re-warps the filtered layers
        (``delta_redeskew``) and a short align re-runs from the last pose.
        A round whose align is weak or whose ``dt`` is too small keeps the
        current twist, an identity warp -- selected on the device, never
        on the host. Returns (layers, ICPResult)."""
        pp = self.params
        stages = self._stages_for(kind, use_map)
        if use_map and self._mesh is not None and pp.mesh_model > 1:
            # tensor parallel: the map's point axis over the "model" axis
            stages = tuple(dataclasses.replace(s, shard_axis="model") for s in stages)
            target = self._split_map(target)
        res = align_pipeline(mm, target, se3.Pose(self._on_device(guess_R),
                                                  self._on_device(guess_t)), stages)
        dsk = self._deskew_filter()
        if not (pp.deskew_in_loop and dsk is not None):
            return mm, res
        refine = (dataclasses.replace(stages[-1], max_iterations=pp.deskew_refine_iters),)
        dt_d = self._on_device(np.float32(max(dt, 0.0)))
        prev_pose = se3.Pose(self._on_device(prev[0]), self._on_device(prev[1]))
        max_v, max_w = pp.max_sensor_speed, pp.max_sensor_rot_rate
        xi_cur = twist
        self.profiler.register_user_measure("doProcess.deskew_refine_rounds",
                                            pp.deskew_refine_rounds)
        for _ in range(pp.deskew_refine_rounds):
            rel = se3.compose(se3.inverse(prev_pose), res.pose) if use_map else res.pose
            xi = se3.log(rel) / torch.clamp(dt_d, min=1e-3)
            xi = torch.cat([torch.clamp(xi[:3], -max_v, max_v), torch.clamp(xi[3:], -max_w, max_w)])
            ok = (res.quality >= pp.deskew_refine_min_quality) & (dt_d > 1e-3) & torch.all(
                torch.isfinite(xi))
            xi_new = torch.where(ok, xi, xi_cur)
            mm = {name: (delta_redeskew(pc, xi_cur, xi_new, dsk.scan_period, dsk.anchor == "end")
                         if "time" in pc.attrs else pc)
                  for name, pc in mm.items()}
            res = align_pipeline(mm, target, res.pose, refine)
            xi_cur = xi_new
        return mm, res

    def _split_map(self, local_map: MetricMap) -> MetricMap:
        """The local map split over the mesh's model axis; split once per
        map (every rebuild makes a new one), views where a position is the
        module's device."""
        if self._map_split[0] is not local_map:
            self._map_split = (local_map,
                               shard_points(local_map, self._mesh.axis_devices("model")))
        return self._map_split[1]

    def _dp_pad(self, n: int) -> int:
        """Round a batch size up to a multiple of the data-axis size."""
        d = self.params.mesh_data if self._mesh is not None else 1
        return -(-n // max(d, 1)) * max(d, 1)

    def _dp_packed_align(self, kind: str, src_map, tgt_map, guess_R, guess_t,
                         stages) -> torch.Tensor:
        """``_packed_align`` of a ``kind`` ("nearby" or "lc") batch; on a
        data mesh (the reference's ``_dp_shard`` and its jitted batch) its
        lanes split over the "data" axis (layers ``[N,3]`` go to every
        position whole), the packed rows back on the module's device in
        lane order, and the counter ``checkNonAdjacent.{kind}.dp_lanes``
        records the lanes."""
        if self._mesh is None or self.params.mesh_data <= 1:
            return _packed_align(src_map, tgt_map, guess_R, guess_t, stages)
        out = data_parallel(self._mesh, lambda s, t, R, tt: _packed_align(s, t, R, tt, stages),
                            src_map, tgt_map, guess_R, guess_t)
        self.profiler.register_user_measure(f"checkNonAdjacent.{kind}.dp_lanes", out.shape[0])
        return out.to(self.device)

    def _on_device(self, x) -> torch.Tensor:
        return host_to_device(np.asarray(x, np.float32), self.device)

    # ------------------------------------------------------------------
    def _create_keyframe(self, tim: float, points: MetricMap) -> None:
        """Keyframe proposal + annotations + odometry factor + local-map
        update."""
        st = self.state
        prof = self.profiler
        if self.slam_backend is not None:
            prof.enter("doProcess.addKeyFrame")
            out = self.slam_backend.add_keyframe(ProposeKFInput(timestamp=tim)).result()
            prof.leave("doProcess.addKeyFrame")
            if not out.success:
                self.log.error("addKeyFrame failed")
                return
            kf_id = out.new_kf_id
        else:
            kf_id = (st.last_kf + 1) if st.last_kf is not None else 0

        wm = self.worldmodel
        with wm.lock_for_write():
            wm.add_entity(kf_id)
            # the filtered layered cloud, which the nearby/LC checks align
            wm.annotate(kf_id, ANNOTATION_NAME_PC_LAYERS, points)
            if st.kf_decor_counter % self.params.viz_decor_decimation == 0:
                decor = points.get("decimated") or next(iter(points.values()))
                wm.annotate(kf_id, ANNOTATION_NAME_RENDER_DECORATION, {
                    "points": decor.xyz.cpu().numpy(),
                    "mask": decor.mask.cpu().numpy(),
                    "point_size": self.params.viz_decor_pointsize,
                })
            st.kf_decor_counter += 1

        if st.last_kf is not None:
            rel = _f32_pose(st.accum_since_last_kf_R, st.accum_since_last_kf_t)
            if self.slam_backend is not None:
                self.slam_backend.add_factor(FactorRelativePose3(
                    kf_from=st.last_kf, kf_to=kf_id, rel_pose=rel)).result()
            wm.add_neighbors(st.last_kf, kf_id)
            with self._state_lock:
                st.local_pose_graph.insert_edge(st.last_kf, kf_id, st.accum_since_last_kf_R,
                                                st.accum_since_last_kf_t)
                st.edge_log.append((st.last_kf, kf_id, st.accum_since_last_kf_R.copy(),
                                    st.accum_since_last_kf_t.copy()))
        else:
            with self._state_lock:
                st.local_pose_graph.insert_node(kf_id)

        self.log.info("New KF #%s (dist=%.2fm)", kf_id,
                      float(np.linalg.norm(st.accum_since_last_kf_t)))
        st.accum_since_last_kf_R = np.eye(3)
        st.accum_since_last_kf_t = np.zeros(3)
        st.last_kf = kf_id

        if self.params.odometry_reference == "local_map":
            if self._local_map_builder is None:
                self._local_map_builder = self._make_map_builder()
            self._local_map_builder.add_keyframe(points, (st.world_R, st.world_t))
            if st.local_map is None or not self.params.local_map_async_build:
                # the first map must exist before the next scan: inline
                prof.enter("doProcess.local_map_build")
                st.local_map = self._local_map_builder.build()
                prof.leave("doProcess.local_map_build")
            else:
                self._schedule_map_build()

    def _make_map_builder(self):
        """A rolling-map builder holding every layer a matcher or quality
        evaluator of the odometry stages targets: on the device, or the
        host ``LocalMap`` when ``local_map_device_build`` is off or the
        multi-view transient filter (``local_map_min_views > 1``) is on."""
        keep = set()
        for kind in (AlignKind.LIDAR_ODOMETRY, AlignKind.NEARBY_ALIGN):
            for stage in self.icp_cases.get(kind, ()):
                keep.update(mt.tgt_layer for mt in stage.matchers)
                keep.update(q.tgt_layer for q in stage.quality)
        p = self.params
        common = dict(window=p.local_map_keyframes, capacity_mult=p.local_map_capacity_mult,
                      dedup_voxel=p.local_map_dedup_voxel, keep_layers=keep or None)
        if p.local_map_device_build and p.local_map_min_views <= 1:
            return DeviceLocalMap(mode=p.local_map_build_mode, **common)
        return LocalMap(transient_min_views=p.local_map_min_views,
                        transient_protect_recent=p.local_map_protect_recent,
                        transient_voxel=p.local_map_transient_voxel or None,
                        device=self.device, **common)

    def _schedule_map_build(self) -> None:
        """Rebuild the map on the pool: one build in flight; a keyframe
        arriving meanwhile marks it dirty and one follow-up build takes a
        fresh snapshot. ``drain`` counts the build."""
        with self._map_build_lock:
            if self._map_build_inflight:
                self._map_build_dirty = True
                return
            self._map_build_inflight = True
        self._submit(self._map_build_worker, self._local_map_builder)

    def _map_build_worker(self, builder) -> None:
        prof = self.profiler
        while True:
            prof.enter("doProcess.local_map_build_async")
            try:
                mm = builder.build(builder.entries())
                # check and swap in one step under the lock the reseed and
                # reset paths take, so a stale build cannot bring back a
                # map that was just dropped
                with self._state_lock:
                    if self._local_map_builder is builder:
                        self.state.local_map = mm
            except Exception:  # noqa: BLE001 -- the previous map stays
                self.log.warning("async local-map build failed", exc_info=True)
            finally:
                prof.leave("doProcess.local_map_build_async")
            handoff = None
            with self._map_build_lock:
                if self._map_build_dirty:
                    self._map_build_dirty = False
                    cur = self._local_map_builder
                    if cur is builder:
                        continue  # one more pass with a fresh snapshot
                    # requested for a builder that replaced this one
                    # (reseed): hand the slot to a build of the current one
                    handoff = cur
                if handoff is None:
                    self._map_build_inflight = False
            if handoff is not None:
                self._submit(self._map_build_worker, handoff)
            return

    def warm_start(self, obs: RawObservation) -> float:
        """Make the first scans run at full speed: load (or build) the CUDA
        kernels, then run the filter, the map build and each primary align
        kind against each target once on the sample ``obs``; the results
        are thrown away and the state is untouched. Returns wall seconds."""
        t0 = time.monotonic()
        if self.device.type == "cuda":
            from ..ops import cuda_build
            cuda_build.library()
        raw = apply_generators(self.generators, obs)
        eye, zero = np.eye(3), np.zeros(3)
        tw = self._on_device(np.zeros(6))
        mm, sanity = self._filter_core(raw, tw)
        sanity.cpu()
        targets = [(False, mm)]
        if self.params.odometry_reference == "local_map":
            b = self._make_map_builder()
            b.add_keyframe(mm, (eye, zero))
            targets.append((True, b.build()))
        for for_map, tgt in targets:
            for kind in (AlignKind.LIDAR_ODOMETRY, AlignKind.NEARBY_ALIGN):
                _, res = self._align_core(kind, for_map, mm, tgt, eye, zero, tw, (eye, zero), 0.1)
                res.quality.cpu()
        dt = time.monotonic() - t0
        self.log.info("warm_start: primary paths ready in %.1f s", dt)
        return dt

    # ------------------------------------------------------------------
    # the nearby-keyframe / loop-closure search
    # ------------------------------------------------------------------
    def check_for_nearby_kfs(self) -> None:
        """Prune the local graph, then pick this keyframe's checks: nearby
        keyframes in ``[min_dist_to_matching, max_dist_to_matching]``
        (decimated by stride to ``max_nearby_align_checks``; none when it
        is 0, where the reference divides by zero) and the nearest keyframe
        at least ``min_topo_dist_to_consider_loopclosure`` edges away within
        ``max_dist_to_loop_closure``. Pairs already checked, already linked
        or without a stored cloud are skipped. The checks run on the pool."""
        st, p, prof = self.state, self.params, self.profiler
        prof.enter("checkForNearbyKFs")
        try:
            with self._state_lock:
                if st.last_kf is None:
                    return
                poses, topo = st.local_pose_graph.dijkstra_nodes_estimate(st.last_kf)
                if len(st.local_pose_graph) > p.max_KFs_local_graph:
                    by_dist = sorted(((np.linalg.norm(t_), n) for n, (R_, t_) in poses.items()),
                                     reverse=True)
                    for _, victim in by_dist[: len(st.local_pose_graph) - p.max_KFs_local_graph]:
                        st.local_pose_graph.remove_node(victim)

            d_max = max(p.max_dist_to_loop_closure, p.max_dist_to_matching)
            nearby: List[Tuple[float, int, np.ndarray, np.ndarray]] = []
            lc_best = None
            wm = self.worldmodel
            for node, (R_, t_) in poses.items():
                if node == st.last_kf:
                    continue
                d = float(np.linalg.norm(t_))
                if d < p.min_dist_to_matching or d > d_max:
                    continue
                is_lc = topo.get(node, 0) >= p.min_topo_dist_to_consider_loopclosure
                if not is_lc and d > p.max_dist_to_matching:
                    continue
                pair = (min(node, st.last_kf), max(node, st.last_kf))
                with self._state_lock:
                    if pair in st.checked_KF_pairs or st.local_pose_graph.has_edge(*pair):
                        continue
                if node in wm.entity_neighbors(st.last_kf):
                    continue
                if not wm.has_annotation(node, ANNOTATION_NAME_PC_LAYERS):
                    continue
                if is_lc:
                    if lc_best is None or d < lc_best[0]:
                        lc_best = (d, node, R_, t_)
                else:
                    nearby.append((d, node, R_, t_))

            nearby.sort(key=lambda c: (c[0], c[1]))
            if p.max_nearby_align_checks <= 0:
                nearby = []
            elif len(nearby) > p.max_nearby_align_checks:
                stride = max(1, len(nearby) // p.max_nearby_align_checks)
                nearby = nearby[::stride][: p.max_nearby_align_checks]

            cur = st.last_kf
            with self._state_lock:
                for _, node, _, _ in nearby + ([lc_best] if lc_best is not None else []):
                    st.checked_KF_pairs.add((min(node, cur), max(node, cur)))
            if nearby:
                jobs = [(node, R_, t_) for _, node, R_, t_ in nearby]
                self.log.info("nearby batch: KF %s vs %s", cur, [n for n, *_ in jobs])
                self._submit(self._check_nearby_batch, cur, jobs)
            if lc_best is not None:
                _, node, R_, t_ = lc_best
                self.log.info("LC check: KF %s <-> %s", cur, node)
                self._submit(self._check_non_adjacent, "lc", cur, node, R_, t_)
        finally:
            prof.leave("checkForNearbyKFs")

    def _submit(self, fn, *args) -> None:
        """Run a check (or a map build) on the pool; ``drain`` counts it
        until it ends."""
        with self._pending_lock:
            self._nearby_inflight += 1
        self._nearby_pool.submit(self._run_check, fn, *args)

    def _run_check(self, fn, *args) -> None:
        try:
            fn(*args)
        except Exception:  # noqa: BLE001 -- per-check error isolation
            self.log.exception("exception in %s", fn.__name__)
        finally:
            with self._pending_lock:
                self._nearby_inflight -= 1

    def _check_nearby_batch(self, cur_kf: int, jobs) -> None:
        """All nearby checks of one keyframe as ONE batched align, padded
        to ``max_nearby_align_checks`` lanes; clouds of another layer
        structure go through per-pair checks instead."""
        wm, p = self.worldmodel, self.params
        cur_pc = wm.annotation(cur_kf, ANNOTATION_NAME_PC_LAYERS)
        if cur_pc is None:
            return
        clouds, keep = [], []
        for node, R_, t_ in jobs:
            pc = wm.annotation(node, ANNOTATION_NAME_PC_LAYERS)
            if pc is not None:
                clouds.append(pc)
                keep.append((node, R_, t_))
        if not clouds:
            return
        k_real = len(clouds)
        # source side only: the target keeps full density, the scale of the
        # paired-ratio goodness
        clouds = [_decimate_layers(c, p.nearby_decimate) for c in clouds]
        k_pad = self._dp_pad(max(1, p.max_nearby_align_checks))
        clouds = (clouds + [clouds[0]] * k_pad)[:k_pad]
        keep = keep[:k_pad]
        try:
            to_pcs = _stack_maps(clouds)
        except ValueError:
            for node, R_, t_ in keep:
                self._check_non_adjacent("nearby", cur_kf, node, R_, t_)
            return
        eye, zero = np.eye(3), np.zeros(3)
        pad = k_pad - len(keep)
        gRs = self._on_device(np.stack([R_ for _, R_, _ in keep] + [eye] * pad))
        gts = self._on_device(np.stack([t_ for _, _, t_ in keep] + [zero] * pad))
        prof = self.profiler
        prof.enter("checkNonAdjacent.nearby_batch_align")
        try:
            flats = self._dp_packed_align("nearby", to_pcs, cur_pc, gRs, gts,
                                          self._nearby_stages()).cpu().numpy()  # one readback
        finally:
            prof.leave("checkNonAdjacent.nearby_batch_align")
        for i in range(k_real):
            node, R_, t_ = keep[i]
            out = _unpack_icp_result(flats[i])
            self._accept_non_adjacent("nearby", cur_kf, node, R_, t_, out.goodness,
                                      out.found_pose_to_wrt_from)

    def _nearby_stages(self):
        """NEARBY_ALIGN stages with the nearby batch's candidate cache and
        iteration cap (loop-closure stages are never patched: the Monte-
        Carlo wide-basin search needs the unrestricted nearest neighbour)."""
        stages = self.icp_cases[AlignKind.NEARBY_ALIGN]
        p = self.params
        if p.nearby_cand_k > 0:
            stages = tuple(dataclasses.replace(s, matchers=tuple(
                dataclasses.replace(m, cand_k=p.nearby_cand_k) if m.kind in _CAND_KINDS else m
                for m in s.matchers)) for s in stages)
        if p.nearby_cand_knn and p.nearby_cand_k > 0:
            stages = tuple(dataclasses.replace(s, matchers=tuple(
                dataclasses.replace(m, cand_k=max(p.nearby_cand_k, m.knn + 3))
                if m.kind in _CAND_KNN_KINDS else m for m in s.matchers)) for s in stages)
        if p.nearby_max_iterations > 0:
            stages = tuple(dataclasses.replace(
                s, max_iterations=min(s.max_iterations, p.nearby_max_iterations))
                for s in stages)
        return stages

    def _lc_gate(self) -> float:
        """Loop-closure goodness gate: fixed, or (``min_icp_goodness_lc_auto``)
        0.9 x the lower quartile of the accepted nearby goodness once 8 are
        known, clipped to [0.40, 0.75]."""
        p = self.params
        vals = list(self._nearby_goodness)
        if not p.min_icp_goodness_lc_auto or len(vals) < 8:
            return p.min_icp_goodness_lc
        return float(np.clip(0.9 * np.quantile(vals, 0.25), 0.40, 0.75))

    def _lc_submap_builder(self) -> DeviceLocalMap:
        """A map builder for the loop-closure target: window 2K + 1 slots,
        the layers the loop-closure stages target."""
        p = self.params
        keep = set()
        for stage in self.icp_cases[AlignKind.LOOP_CLOSURE]:
            keep.update(mt.tgt_layer for mt in stage.matchers)
            keep.update(q.tgt_layer for q in stage.quality)
        return DeviceLocalMap(window=2 * p.lc_submap_keyframes + 1,
                              capacity_mult=p.lc_submap_capacity_mult,
                              dedup_voxel=p.local_map_dedup_voxel,
                              keep_layers=keep or None, mode=p.local_map_build_mode)

    def _build_lc_submap(self, center_kf: int) -> Optional[MetricMap]:
        """The candidate keyframe and its graph neighbours up to
        ``lc_submap_keyframes`` edges away (at most 2K + 1, nearest first),
        aggregated in the candidate's frame."""
        p, st, wm = self.params, self.state, self.worldmodel
        K = p.lc_submap_keyframes
        with self._state_lock:
            poses, topo = st.local_pose_graph.dijkstra_nodes_estimate(center_kf)
        if center_kf not in poses:
            return None
        picks = [center_kf]
        for d, n in sorted((topo.get(n, 10**9), n) for n in poses if n != center_kf):
            if d > K or len(picks) >= 2 * K + 1:
                break
            picks.append(n)
        builder = self._lc_submap_builder()
        n_added = 0
        for n in picks:
            pc = wm.annotation(n, ANNOTATION_NAME_PC_LAYERS)
            if pc is None:
                continue
            builder.add_keyframe(pc, (np.eye(3), np.zeros(3)) if n == center_kf else poses[n])
            n_added += 1
        return builder.build() if n_added else None

    def _check_non_adjacent(self, kind: str, cur_kf: int, other_kf: int,
                            R_: np.ndarray, t_: np.ndarray) -> None:
        """One loop-closure check (all Monte-Carlo guesses as one batch,
        the best quality wins) or one per-pair nearby check. ``(R_, t_)``
        is the graph's pose of ``other_kf`` in ``cur_kf``'s frame."""
        st, p, wm = self.state, self.params, self.worldmodel
        cur_pc = wm.annotation(cur_kf, ANNOTATION_NAME_PC_LAYERS)
        oth_pc = wm.annotation(other_kf, ANNOTATION_NAME_PC_LAYERS)
        if cur_pc is None or oth_pc is None:
            return
        min_goodness = None
        if kind == "lc":
            with self._state_lock:  # two pool workers must not share a seed
                st.mc_seed += 1
                mc_seed = st.mc_seed
            submap = self._build_lc_submap(other_kf) if p.lc_submap_keyframes > 0 else None
            if submap is not None:
                # the current keyframe (one lane per guess) onto the submap
                # around the candidate: the guess is the pose of current in
                # the candidate's frame
                center = se3_np.inverse((np.asarray(R_, float), np.asarray(t_, float)))
                src_pc, tgt_pc = cur_pc, submap
            else:
                center, src_pc, tgt_pc = (R_, t_), oth_pc, cur_pc
            guesses = monte_carlo_guesses(
                torch.Generator().manual_seed(mc_seed),
                se3.Pose(self._on_device(center[0]), self._on_device(center[1])),
                # on a data mesh the count rounds UP to fill every position
                self._dp_pad(p.loop_closure_montecarlo_samples),
                0.1 * p.max_dist_to_loop_closure, 2.0 * DEG2RAD)
            prof = self.profiler
            prof.enter("checkNonAdjacent.lc_batch_align")
            try:
                flats = self._dp_packed_align("lc", src_pc, tgt_pc, guesses.R, guesses.t,
                                              self.icp_cases[AlignKind.LOOP_CLOSURE]).cpu().numpy()
            finally:
                prof.leave("checkNonAdjacent.lc_batch_align")
            out = _unpack_icp_result(flats[int(np.argmax(flats[:, 48]))])
            goodness, pose = out.goodness, out.found_pose_to_wrt_from
            if submap is not None:
                # the edge wants the pose of the candidate in current's frame
                pose = _f32_pose(*se3_np.inverse(_np_pose(pose)))
            min_goodness = self._lc_gate()
        else:
            # the batch path's stages and decimation, so both make the same
            # edge decisions
            out = self.run_one_icp(_decimate_layers(oth_pc, p.nearby_decimate), cur_pc, R_, t_,
                                   stages=self._nearby_stages(), tag="nearby")
            goodness, pose = out.goodness, out.found_pose_to_wrt_from
        self._accept_non_adjacent(kind, cur_kf, other_kf, R_, t_, goodness, pose,
                                  min_goodness=min_goodness)

    def _accept_non_adjacent(self, kind, cur_kf, other_kf, R_, t_, goodness, pose,
                             min_goodness=None) -> None:
        """Acceptance gate and factor/edge emission: goodness at least the
        gate and, for nearby checks, a correction of the graph's guess
        under ``max_correction_ratio`` of its length."""
        p, st = self.params, self.state
        if min_goodness is None:
            min_goodness = self._lc_gate() if kind == "lc" else p.min_icp_goodness
        Rp, tp_ = _np_pose(pose)
        Ri, ti = se3_np.inverse((np.asarray(R_, float), np.asarray(t_, float)))
        corr = float(np.linalg.norm(se3_np.compose((Ri, ti), (Rp, tp_))[1]))
        init_norm = max(float(np.linalg.norm(t_)), 0.1)
        accept = goodness >= min_goodness and (
            kind == "lc" or corr < p.max_correction_ratio * init_norm)
        self.profiler.register_user_measure(f"checkNonAdjacent.{kind}.goodness", goodness)
        # 1/0 per check: the counter's count is the checks, its total the accepts
        self.profiler.register_user_measure(f"checkNonAdjacent.{kind}.accepted", float(accept))
        if not accept:
            self.log.info("%s rejected: KF %s <-> %s goodness=%.2f corr=%.2fm",
                          kind, cur_kf, other_kf, goodness, corr)
            return
        if kind == "nearby":
            self._nearby_goodness.append(float(goodness))
        if self.slam_backend is not None:
            self.slam_backend.add_factor(FactorRelativePose3(
                kf_from=cur_kf, kf_to=other_kf, rel_pose=pose)).result()
        self.worldmodel.add_neighbors(cur_kf, other_kf)
        with self._state_lock:
            st.local_pose_graph.insert_edge(cur_kf, other_kf, Rp, tp_)
            st.edge_log.append((cur_kf, other_kf, Rp.copy(), tp_.copy()))
            if kind == "lc":
                st.lc_pairs.append((cur_kf, other_kf))
        self.log.info("%s ACCEPTED: KF %s <-> %s goodness=%.2f",
                      "loop closure" if kind == "lc" else "nearby edge",
                      cur_kf, other_kf, goodness)

    def run_one_icp(self, to_pc: MetricMap, from_pc: MetricMap, guess_R, guess_t,
                    stages, tag: str = "icp") -> ICPOutput:
        """Align ``to_pc`` onto ``from_pc`` from the guess; one readback."""
        self.profiler.enter(f"run_one_icp.{tag}")
        try:
            flat = _packed_align(to_pc, from_pc, self._on_device(guess_R),
                                 self._on_device(guess_t), stages)
            return _unpack_icp_result(flat.cpu().numpy())
        finally:
            self.profiler.leave(f"run_one_icp.{tag}")

    # ------------------------------------------------------------------
    def drain(self, timeout: float = 600.0) -> int:
        """Block until queued scans, nearby/LC checks and map builds finish;
        returns the number still in flight at the timeout (also recorded as
        ``drain.jobs_abandoned``)."""
        t0 = time.monotonic()
        abandoned = 0
        while time.monotonic() - t0 < timeout:
            with self._pending_lock:
                if self._pending == 0 and self._nearby_inflight == 0:
                    break
            time.sleep(0.005)
        else:
            with self._pending_lock:
                abandoned = self._pending + self._nearby_inflight
            self.log.warning("drain(): %d scans or nearby/LC checks still running at timeout",
                             abandoned)
        self.profiler.register_user_measure("drain.jobs_abandoned", abandoned)
        return abandoned

    def shutdown(self) -> None:
        self._pipeline_pool.shutdown(wait=True)
        self._nearby_pool.shutdown(wait=True)
