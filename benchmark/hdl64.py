"""HDL-64 LiDAR simulator: analytic ray-cast world with occlusion.

The reference's validation regime is KITTI replay with an HDL-64E sensor
(reference params/kitti-default.yaml — 131072-point raw clouds, voxel 1.0 m,
KF 3 m). No KITTI data ships with this environment, so this module provides
an *honest* stand-in with the properties that actually stress a LiDAR
odometry pipeline:

* **64-beam ring geometry**: HDL-64E-like elevation table (upper block
  +2°…−8.3° at 1/3° spacing, lower block −8.8°…−24.3° at 1/2°), a full
  360° azimuth sweep of ``n_azimuth`` columns → 64·2048 = 131072 rays/scan;
* **azimuth-ordered points with per-point timestamps** (fraction of the
  0.1 s sweep) — the scan is captured while the sensor MOVES, so points are
  motion-skewed exactly like a real spinning LiDAR and ``FilterDeskew`` has
  real work to do;
* **occlusion** by nearest-hit ray casting against analytic primitives
  (ground plane, axis-aligned building boxes, cylindrical poles);
* **range noise, dropout, and max-range no-returns** (fixed-shape output:
  invalid rays are masked, never removed);
* optional **dynamic objects** (constant-velocity boxes = moving cars)
  whose position advances per *column* time — the outlier source for the
  robustness benchmarks.

Everything is deterministic given ``seed``.

The benchmark's own copy of ``mola_fe_lidar_tpu_torch/obs/hdl64.py``, so
the yardstick does not move when the program does. It adds
:meth:`RoutePose.poses`, the same pose arithmetic over an array of times;
``hdl64_torch.py`` ray-casts the scans of a run on the card and
``tests/test_bench_generator.py`` holds it to :meth:`HDL64World.scan`.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

SWEEP_PERIOD = 0.1  # s, 10 Hz rotation (HDL-64E default)
_BEAM_ELEVATIONS = np.concatenate([
    np.linspace(2.0, -8.33, 32), np.linspace(-8.83, -24.33, 32),
]) * np.pi / 180.0


# ---------------------------------------------------------------------------
# analytic primitives (all vectorized over rays)
# ---------------------------------------------------------------------------

def _ray_ground(o, d, z=0.0):
    """Ray ∩ plane z=const → ranges (inf = miss)."""
    dz = d[:, 2]
    t = (z - o[:, 2]) / np.where(np.abs(dz) < 1e-9, 1e-9, dz)
    return np.where((t > 0.1) & (dz < 0), t, np.inf)


def _ray_box(o, d, lo, hi):
    """Ray ∩ axis-aligned box [lo, hi] (slab method) → entry ranges."""
    inv = 1.0 / np.where(np.abs(d) < 1e-9, 1e-9, d)
    t0 = (lo[None, :] - o) * inv
    t1 = (hi[None, :] - o) * inv
    tnear = np.minimum(t0, t1).max(axis=1)
    tfar = np.maximum(t0, t1).min(axis=1)
    hit = (tnear < tfar) & (tfar > 0) & (tnear > 0.1)
    return np.where(hit, tnear, np.inf)


def _ray_cylinder(o, d, cx, cy, r, h):
    """Ray ∩ vertical cylinder (center (cx,cy), radius r, 0≤z≤h)."""
    ox, oy = o[:, 0] - cx, o[:, 1] - cy
    dx, dy = d[:, 0], d[:, 1]
    a = dx * dx + dy * dy
    b = 2 * (ox * dx + oy * dy)
    c = ox * ox + oy * oy - r * r
    disc = b * b - 4 * a * c
    a_safe = np.where(a < 1e-12, 1e-12, a)
    t = (-b - np.sqrt(np.maximum(disc, 0.0))) / (2 * a_safe)
    z = o[:, 2] + t * d[:, 2]
    hit = (disc > 0) & (t > 0.1) & (z >= 0) & (z <= h)
    return np.where(hit, t, np.inf)


@dataclass
class Box:
    lo: np.ndarray
    hi: np.ndarray

    def center(self):
        return 0.5 * (self.lo + self.hi)

    def radius(self):
        return 0.5 * float(np.linalg.norm(self.hi - self.lo))


@dataclass
class MovingBox:
    """Constant-velocity dynamic object (a car-sized outlier source)."""

    lo: np.ndarray           # extents at t=0
    hi: np.ndarray
    velocity: np.ndarray     # m/s, world frame


@dataclass
class HDL64World:
    """City-grid world: ground + building boxes + poles (+ moving boxes)."""

    extent: float = 200.0
    block_pitch: float = 40.0
    building_fill: float = 0.7   # fraction of grid cells with a building
    seed: int = 0
    max_range: float = 80.0
    range_noise: float = 0.02
    dropout: float = 0.02
    boxes: List[Box] = field(default_factory=list)
    poles: List[Tuple[float, float, float, float]] = field(default_factory=list)
    moving: List[MovingBox] = field(default_factory=list)

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        e, p = self.extent, self.block_pitch
        for gx in np.arange(-e + p / 2, e, p):
            for gy in np.arange(-e + p / 2, e, p):
                if rng.uniform() > self.building_fill:
                    continue
                w = rng.uniform(8, 16)
                dpt = rng.uniform(8, 16)
                h = rng.uniform(5, 18)
                cx = gx + rng.uniform(-4, 4)
                cy = gy + rng.uniform(-4, 4)
                self.boxes.append(Box(
                    np.array([cx - w / 2, cy - dpt / 2, 0.0]),
                    np.array([cx + w / 2, cy + dpt / 2, h])))
        # street poles midway between blocks, offset ~4.5 m off the street
        # centerline (vehicles drive the centerline — poles live on curbs)
        for gx in np.arange(-e, e + 1, p / 2):
            for gy in np.arange(-e, e + 1, p / 2):
                if (gx / p) % 1 == 0.5 or (gy / p) % 1 == 0.5:
                    self.poles.append(
                        (gx + 4.5 + rng.uniform(-0.5, 0.5),
                         gy + 4.5 + rng.uniform(-0.5, 0.5),
                         0.15, rng.uniform(3, 6)))
        self._rng = rng

    def add_parked_cars(self, n: int) -> None:
        """Line streets with car-sized STATIC boxes on the curbs.

        Real urban LiDAR (the KITTI regime the reference validates on)
        is dense with near-field structure — parked cars, curbs, bins —
        that dominates the paired-ratio quality between 5–10 m-offset
        viewpoint pairs. A bare box-and-pole world caps that ratio near
        0.3 (measured: scripts/diag_lc.py gt_quality_ceiling) and no
        loop closure can pass the reference's 0.70 acceptance gate
        (reference params/kitti-default.yaml:14) however well the ICP
        converges. Parked cars at ±5.5–7 m off the street centerlines
        restore a KITTI-like pairing density while leaving the ±3 m
        driving lanes clear."""
        rng = self._rng
        for _ in range(n):
            along_x = rng.uniform() < 0.5
            line = rng.choice(np.arange(-self.extent, self.extent + 1,
                                        self.block_pitch))
            pos = rng.uniform(-self.extent, self.extent)
            # inner face stays >= 5.2 m off the centerline: >= 2.2 m of
            # clearance from the relap route's +-3 m lanes
            side = rng.choice([-1.0, 1.0]) * rng.uniform(6.2, 7.2)
            cx, cy = (pos, line + side) if along_x else (line + side, pos)
            L, W = (2.2, 0.9) if rng.uniform() < 0.8 else (2.8, 1.0)
            if not along_x:
                L, W = W, L
            h = rng.uniform(1.4, 1.9)
            self.boxes.append(Box(
                np.array([cx - L, cy - W, 0.0]),
                np.array([cx + L, cy + W, h])))

    def add_moving_cars(self, n: int, speed: float = 8.0) -> None:
        """Sprinkle constant-velocity car-sized boxes along the streets."""
        rng = self._rng
        for _ in range(n):
            along_x = rng.uniform() < 0.5
            lane = rng.choice(np.arange(-self.extent, self.extent,
                                        self.block_pitch)) + self.block_pitch / 2
            pos = rng.uniform(-self.extent, self.extent)
            cx, cy = (pos, lane - 3.0) if along_x else (lane - 3.0, pos)
            v = np.array([speed, 0, 0]) if along_x else np.array([0, speed, 0])
            v = v * rng.choice([-1.0, 1.0])
            self.moving.append(MovingBox(
                np.array([cx - 2.2, cy - 0.9, 0.0]),
                np.array([cx + 2.2, cy + 0.9, 1.6]), v))

    # -- casting -------------------------------------------------------------
    def cast(self, origins: np.ndarray, dirs: np.ndarray,
             times: np.ndarray) -> np.ndarray:
        """Nearest-hit ranges for rays (origin, dir) fired at absolute
        ``times`` (dynamic objects move per ray time)."""
        t_best = _ray_ground(origins, dirs)
        center = origins.mean(0)
        reach = self.max_range + float(np.linalg.norm(
            origins - center, axis=1).max())
        for b in self.boxes:
            if np.linalg.norm(b.center()[:2] - center[:2]) > reach + b.radius():
                continue
            t_best = np.minimum(t_best, _ray_box(origins, dirs, b.lo, b.hi))
        for (px, py, r, h) in self.poles:
            if np.linalg.norm(np.array([px, py]) - center[:2]) > reach:
                continue
            t_best = np.minimum(t_best, _ray_cylinder(origins, dirs, px, py, r, h))
        for mb in self.moving:
            # per-ray displacement: origin shifted into the object frame
            disp = mb.velocity[None, :] * times[:, None]
            t_best = np.minimum(
                t_best, _ray_box(origins - disp, dirs, mb.lo, mb.hi))
        return t_best

    def scan(self, pose_fn, t0: float, n_azimuth: int = 2048,
             beams: Optional[np.ndarray] = None) -> Dict:
        """One full 360° sweep starting at absolute time ``t0``.

        ``pose_fn(t) -> (R, t)`` is the continuous sensor trajectory; each
        azimuth column is fired from the pose at its own time, and each hit
        point is expressed in the sensor frame **at its own fire time** —
        the real spinning-LiDAR convention (xyz from range + encoder
        angle in the instantaneous sensor frame). The accumulated cloud
        therefore mixes frames across the sweep (motion skew); deskew maps
        every point to the common scan-end frame via the twist.
        """
        beams = _BEAM_ELEVATIONS if beams is None else beams
        n_beams = len(beams)
        tau = np.arange(n_azimuth) / n_azimuth                 # [A]
        az = 2 * np.pi * tau                                   # sensor-frame azimuth
        times = t0 + tau * SWEEP_PERIOD

        Rs = np.empty((n_azimuth, 3, 3))
        ps = np.empty((n_azimuth, 3))
        for j, t in enumerate(times):                          # host loop: 2048 poses
            Rs[j], ps[j] = pose_fn(t)

        ce, se = np.cos(beams), np.sin(beams)                  # [B]
        ca, sa = np.cos(az), np.sin(az)                        # [A]
        # sensor-frame directions [B, A, 3]
        d_sensor = np.stack([
            np.outer(ce, ca), np.outer(ce, sa),
            np.broadcast_to(se[:, None], (n_beams, n_azimuth))], -1)
        d_world = np.einsum("ajk,bak->baj", Rs, d_sensor)      # [B, A, 3]
        o_world = np.broadcast_to(ps[None], (n_beams, n_azimuth, 3))
        t_flat = np.broadcast_to(times[None], (n_beams, n_azimuth)).reshape(-1)

        rays_o = o_world.reshape(-1, 3)
        rays_d = d_world.reshape(-1, 3)
        rng_hit = self.cast(rays_o, rays_d, t_flat)

        rng = self._rng
        valid = (rng_hit < self.max_range) & (rng.uniform(size=rng_hit.shape)
                                              > self.dropout)
        rng_noisy = np.where(valid, rng_hit, 0.0) + rng.normal(
            0, self.range_noise, rng_hit.shape)
        # instantaneous-frame coordinates: range * sensor-frame direction —
        # exactly what the sensor computes from (range, encoder angles)
        p_local = (d_sensor.reshape(-1, 3) * rng_noisy[:, None])
        p_local = np.where(valid[:, None], p_local, 0.0).astype(np.float32)
        return {
            "xyz": p_local,
            "valid": valid.astype(np.float32),
            "time": np.broadcast_to(
                tau[None], (n_beams, n_azimuth)).reshape(-1).astype(np.float32),
            "timestamp": float(t0),
            "sensor_label": "lidar",
        }


# ---------------------------------------------------------------------------
# trajectories
# ---------------------------------------------------------------------------

class RoutePose:
    """Pose along a piecewise-linear route with rounded corners; yaw follows
    the path tangent, and speed drops in corners to respect a lateral-
    acceleration limit (as real traffic does: KITTI-style urban turns are
    a few °/scan because cars slow down). ``__call__(t) -> (R, t)``."""

    def __init__(self, waypoints: np.ndarray, speed: float = 8.0,
                 height: float = 1.73, corner_radius: float = 10.0,
                 lat_accel: float = 1.5):
        from scipy.ndimage import uniform_filter1d

        wp = np.asarray(waypoints, np.float64)
        self.speed = float(speed)
        self.height = float(height)
        # densify: sample the closed polyline at 0.25 m resolution
        pts = []
        for i in range(len(wp)):
            a = wp[i]
            b = wp[(i + 1) % len(wp)]
            seg = b - a
            L = np.linalg.norm(seg)
            n = max(2, int(L / 0.25))
            for s in np.linspace(0, 1, n, endpoint=False):
                pts.append(a + s * seg)
        path = np.asarray(pts)
        # rounded corners: two passes of circular moving average over
        # ~corner_radius of arc (seam-free; the old one-sided convolve left a
        # kink at the start). Corner turn rate ≈ speed/corner_radius.
        win = max(1, int(corner_radius / 0.25))
        smooth = uniform_filter1d(path, size=win, axis=0, mode="wrap")
        smooth = uniform_filter1d(smooth, size=win, axis=0, mode="wrap")
        # start mid-first-segment, away from any corner
        first_len = int(np.linalg.norm(wp[1] - wp[0]) / 0.25)
        smooth = np.roll(smooth, -first_len // 2, axis=0)
        d = np.diff(np.vstack([smooth, smooth[:1]]), axis=0)
        step = np.linalg.norm(d, axis=1)
        self._s = np.concatenate([[0.0], np.cumsum(step)])    # arc length
        self._xy = np.vstack([smooth, smooth[:1]])
        self.total_length = float(self._s[-1])
        # curvature-limited speed profile: v = min(v_max, sqrt(a_lat / κ)),
        # smoothed so accel/decel ramps are gentle
        heading = np.unwrap(np.arctan2(d[:, 1], d[:, 0]))
        kappa = np.abs(np.gradient(heading) / np.maximum(step, 1e-9))
        kappa = uniform_filter1d(kappa, size=win, mode="wrap")
        from scipy.ndimage import minimum_filter1d
        v = np.minimum(self.speed, np.sqrt(lat_accel / np.maximum(kappa, 1e-6)))
        # widen each slowdown (min filter), then a gentle ramp (average) —
        # a plain average would wash the corner slowdowns out
        v = minimum_filter1d(v, size=2 * win, mode="wrap")
        v = np.maximum(uniform_filter1d(v, size=win, mode="wrap"), 0.5)
        # time to traverse each sample -> cumulative time as function of s
        dt_samp = step / v
        self._t = np.concatenate([[0.0], np.cumsum(dt_samp)])
        self.lap_time = float(self._t[-1])

    def poses(self, times: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """:meth:`__call__` over an array of times: (R [..., 3, 3], t
        [..., 3]), the same arithmetic element by element."""
        tt = np.asarray(times, np.float64) % self.lap_time
        i = np.minimum(np.searchsorted(self._t, tt, side="right") - 1, len(self._xy) - 2)
        f = (tt - self._t[i]) / np.maximum(self._t[i + 1] - self._t[i], 1e-9)
        xy = self._xy[i] * (1 - f)[..., None] + self._xy[i + 1] * f[..., None]
        heading = self._xy[i + 1] - self._xy[i]
        yaw = np.arctan2(heading[..., 1], heading[..., 0])
        c, sn = np.cos(yaw), np.sin(yaw)
        R = np.zeros(tt.shape + (3, 3))
        R[..., 0, 0], R[..., 0, 1] = c, -sn
        R[..., 1, 0], R[..., 1, 1] = sn, c
        R[..., 2, 2] = 1.0
        t = np.stack([xy[..., 0], xy[..., 1], np.full(tt.shape, self.height)], -1)
        return R, t

    def __call__(self, t: float) -> Tuple[np.ndarray, np.ndarray]:
        tt = t % self.lap_time
        i = int(np.searchsorted(self._t, tt, side="right")) - 1
        i = min(i, len(self._xy) - 2)
        f = (tt - self._t[i]) / max(self._t[i + 1] - self._t[i], 1e-9)
        xy = self._xy[i] * (1 - f) + self._xy[i + 1] * f
        heading = self._xy[i + 1] - self._xy[i]
        yaw = np.arctan2(heading[1], heading[0])
        c, sn = np.cos(yaw), np.sin(yaw)
        R = np.array([[c, -sn, 0], [sn, c, 0], [0, 0, 1]])
        return R, np.array([xy[0], xy[1], self.height])


def make_route(kind: str, world: HDL64World, speed: float = 8.0) -> RoutePose:
    """Named routes over the city grid.

    Streets that avoid buildings run on EVEN multiples of ``block_pitch``
    (x or y ∈ {0, ±40, ±80, …}): building rows sit on odd multiples of
    ``block_pitch/2`` with half-extent ≤ 12 m, so those lines keep ≥ 8 m of
    clearance. (The legacy "block" route predates this and clips building
    rows — kept verbatim so its recorded accuracy rows stay comparable.)

    * ``block`` — the original one-block circuit (~630 m lap). 500 scans at
      8 m/s cover barely half a lap: it can never close a loop.
    * ``snake`` — 1760 m boustrophedon: three 320 m east-west rows joined on
      the edges, then a return leg that RE-DRIVES the x=+160 edge and the
      first row in the opposite direction. The revisit happens ≈ 880 m of
      path (~290 keyframes at 3 m) after the first pass, far beyond
      ``min_topo_dist_to_consider_loopclosure`` — the end-to-end
      loop-closure demonstration — and its long
      straights make the official KITTI 100–800 m drift segments
      meaningful (reference params/kitti-default.yaml operating
      point).
    * ``outback`` — a 330 m stadium loop inside ONE street: out along
      y=−4 m, back along y=+4 m (both inside the street's ±8 m clear
      corridor), joined by smooth end caps. The return pass runs 8 m from
      the out pass — inside the loop-closure window (min_dist_to_matching
      6 m … max_dist_to_loop_closure 30 m) — at high topological distance
      almost immediately. The cheap CPU-smoke loop closure. (A literal
      zero-width out-and-back does NOT work: the turnaround is an
      instantaneous π heading flip — infinite curvature — that breaks the
      constant-velocity ICP prior and trips the rotation-rate gate.)
      NOTE: the outback revisit is OPPOSITE-direction, and a reverse
      revisit has an intrinsic paired-ratio ceiling of ~0.3 (occlusion:
      each pass sees only its own facing sides of every building), far
      below the 0.70 acceptance gate — measured with ground-truth-posed
      clouds by scripts/diag_lc.py. Neither this framework nor the
      reference (same gate, reference src/LidarOdometry.cpp:809-816) can
      accept reverse revisits; use ``relap`` for the accepting regime.
    * ``relap`` — ~640 m: two concentric SAME-direction laps around a
      2x2-block square, lane-offset ±3 m (lap separation 6 m — inside
      the 5–30 m loop-closure window). Same heading ⇒ same occlusion
      sides ⇒ high paired-ratio at the true pose: the end-to-end
      loop-closure ACCEPTANCE demonstration, the simulator analogue of a
      same-direction KITTI-00 revisit (the regime where the reference's
      loop closures actually fire).
    """
    p = world.block_pitch
    if kind == "block":
        e = p
        wp = np.array([[-e, -e], [e * 3, -e], [e * 3, e * 3], [-e, e * 3]],
                      float) + e / 2
    elif kind == "snake":
        wp = np.array([
            [-160, -120], [160, -120], [160, 0], [-160, 0],
            [-160, 120], [160, 120], [160, -120]], float) * (p / 40.0)
    elif kind == "outback":
        wp = np.array([[-2 * p, -4.0], [2 * p, -4.0],
                       [2 * p, 4.0], [-2 * p, 4.0]], float)
        return RoutePose(wp, speed=speed, corner_radius=6.0)
    elif kind == "relap":
        # outer lap (3 edges; the 4th is the lane-change transition down
        # the x=0 street), then the inner lap 6 m to the inside — every
        # edge re-driven same-direction at 6 m lateral offset
        s = p * 2  # square side = 2 blocks
        wp = np.array([
            [-3, -3], [s + 3, -3], [s + 3, s + 3], [-3, s + 3],   # outer
            [3, 3], [s - 3, 3], [s - 3, s - 3], [3, s - 3],       # inner
        ], float)
    else:
        raise ValueError(f"unknown route kind {kind!r}; "
                         "choose block, snake, outback, or relap")
    return RoutePose(wp, speed=speed)
