"""Scan-to-map odometry: LocalMap aggregation + front-end integration."""

import numpy as np
import pytest

from mola_fe_lidar_tpu.cloud import from_points
from mola_fe_lidar_tpu.frontend.local_map import LocalMap
from mola_fe_lidar_tpu.geometry import se3_np


def _cloud(points, attrs=None, capacity=None):
    return from_points(np.asarray(points, np.float32),
                       capacity=capacity, attrs=attrs)


class TestLocalMap:
    def test_world_transform_and_normal_rotation(self):
        lm = LocalMap(window=4, capacity_mult=2, dedup_voxel=0.05)
        pts = np.array([[1, 0, 0], [0, 2, 0]], np.float32)
        normals = np.array([[1, 0, 0], [0, 1, 0]], np.float32)
        # yaw 90deg: x -> y
        R, t = se3_np.exp(np.array([0, 0, 0, 0, 0, np.pi / 2]))
        lm.add_keyframe({"planes": _cloud(pts, {"normal": normals},
                                          capacity=256)}, (R, t))
        mp = lm.build()
        pc = mp["planes"]
        m = np.asarray(pc.mask) > 0.5
        xyz = np.asarray(pc.xyz)[m]
        n = np.asarray(pc.attrs["normal"])[m]
        got = {tuple(np.round(p, 3)) for p in xyz}
        assert (0.0, 1.0, 0.0) in got and (-2.0, 0.0, 0.0) in got
        gotn = {tuple(np.round(p, 3)) for p in n}
        assert (0.0, 1.0, 0.0) in gotn and (-1.0, 0.0, 0.0) in gotn

    def test_window_and_dedup(self):
        lm = LocalMap(window=2, capacity_mult=4, dedup_voxel=0.5)
        I = (np.eye(3), np.zeros(3))
        a = np.array([[0, 0, 0], [5, 0, 0]], np.float32)
        lm.add_keyframe({"decimated": _cloud(a, capacity=256)}, I)
        lm.add_keyframe({"decimated": _cloud(a + 0.01, capacity=256)}, I)
        mp = lm.build()
        # near-duplicates land in the same 0.5 m voxel: deduped to 2 points
        assert int(np.asarray(mp["decimated"].mask).sum()) == 2
        # window=2 evicts the oldest keyframe
        b = np.array([[9, 9, 9]], np.float32)
        lm.add_keyframe({"decimated": _cloud(b, capacity=256)}, I)
        lm.add_keyframe({"decimated": _cloud(b + 3, capacity=256)}, I)
        mp = lm.build()
        xyz = np.asarray(mp["decimated"].xyz)[np.asarray(mp["decimated"].mask) > 0.5]
        assert not (np.abs(xyz) < 1e-3).all(axis=1).any()  # origin evicted
        assert len(lm) == 2

    def test_mixed_attrs_intersect_and_time_dropped(self):
        """Keyframes recorded with different attr sets (e.g. a resume from a
        pre-upgrade checkpoint) aggregate on the COMMON keys instead of
        KeyError'ing; per-sweep "time" never reaches the aggregated map."""
        lm = LocalMap(window=4, capacity_mult=4, dedup_voxel=0.05)
        I = (np.eye(3), np.zeros(3))
        a = np.array([[0, 0, 0], [5, 0, 0]], np.float32)
        lm.add_keyframe({"planes": _cloud(
            a, {"normal": np.tile([0, 0, 1], (2, 1)).astype(np.float32),
                "time": np.linspace(0, 1, 2, dtype=np.float32)[:, None]},
            capacity=256)}, I)
        lm.add_keyframe({"planes": _cloud(
            a + 10, {"normal": np.tile([0, 1, 0], (2, 1)).astype(np.float32)},
            capacity=256)}, I)
        mp = lm.build()
        assert set(mp["planes"].attrs) == {"normal"}
        assert int(np.asarray(mp["planes"].mask).sum()) == 4

    def test_keep_layers_filters_unused(self):
        lm = LocalMap(window=2, keep_layers={"decimated"})
        a = np.array([[0, 0, 0]], np.float32)
        lm.add_keyframe({"decimated": _cloud(a, capacity=256),
                         "raw": _cloud(a, capacity=256)},
                        (np.eye(3), np.zeros(3)))
        mp = lm.build()
        assert set(mp) == {"decimated"}

    def test_capacity_overflow_is_uniform(self):
        rng = np.random.default_rng(0)
        lm = LocalMap(window=1, capacity_mult=1, dedup_voxel=0.01)
        pts = rng.uniform(-50, 50, (600, 3)).astype(np.float32)
        lm.add_keyframe({"decimated": _cloud(pts, capacity=256)},
                        (np.eye(3), np.zeros(3)))
        mp = lm.build()
        pc = mp["decimated"]
        assert pc.capacity == 256
        kept = np.asarray(pc.xyz)[np.asarray(pc.mask) > 0.5]
        # hash-uniform subsample, not a spatial slab: kept points span the
        # extent on every axis
        assert (kept.max(0) - kept.min(0) > 60).all()


class TestSnapshotBuild:
    def test_build_from_entries_snapshot_matches_inline(self):
        """build(entries) off a snapshot == build() off live state, and the
        snapshot is isolated from later add_keyframe (async rebuild)."""
        rng = np.random.default_rng(1)
        lm = LocalMap(window=4, capacity_mult=2, dedup_voxel=0.1)
        I = (np.eye(3), np.zeros(3))
        for _ in range(3):
            pts = rng.uniform(-10, 10, (100, 3)).astype(np.float32)
            lm.add_keyframe({"decimated": _cloud(pts, capacity=256)}, I)
        snap = lm.entries()
        ref = lm.build()
        lm.add_keyframe(
            {"decimated": _cloud(rng.uniform(-10, 10, (50, 3)).astype(
                np.float32), capacity=256)}, I)
        got = lm.build(snap)  # snapshot unaffected by the new keyframe
        np.testing.assert_array_equal(np.asarray(ref["decimated"].xyz),
                                      np.asarray(got["decimated"].xyz))
        np.testing.assert_array_equal(np.asarray(ref["decimated"].mask),
                                      np.asarray(got["decimated"].mask))

    def test_per_layer_capacity_mult(self):
        lm = LocalMap(window=2, capacity_mult={"planes": 4},
                      dedup_voxel=0.01)
        a = np.array([[0, 0, 0]], np.float32)
        lm.add_keyframe({"planes": _cloud(a, capacity=256),
                         "decimated": _cloud(a, capacity=256)},
                        (np.eye(3), np.zeros(3)))
        mp = lm.build()
        assert mp["planes"].capacity == 1024
        assert mp["decimated"].capacity == 256  # default mult 1


class TestDeviceLocalMap:
    """Device-resident aggregate build (DeviceLocalMap) — parity with the
    host builder's semantics: world transform + normal rotation, oldest-
    wins voxel dedup, window eviction, fixed capacities."""

    def _mk(self, **kw):
        from mola_fe_lidar_tpu.frontend.local_map import DeviceLocalMap
        return DeviceLocalMap(**kw)

    def test_matches_host_build_point_set(self):
        """Under-capacity, distinct-voxel input: device and host builds
        keep exactly the same world points (order may differ)."""
        from mola_fe_lidar_tpu.frontend.local_map import LocalMap

        rng = np.random.default_rng(7)
        host = LocalMap(window=4, capacity_mult=4, dedup_voxel=0.05)
        dev = self._mk(window=4, capacity_mult=4, dedup_voxel=0.05)
        for i in range(3):
            pts = rng.uniform(-20, 20, (64, 3)).astype(np.float32)
            nrm = rng.normal(size=(64, 3)).astype(np.float32)
            nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
            R, t = se3_np.exp(rng.normal(scale=0.3, size=6))
            mm = {"planes": _cloud(pts, {"normal": nrm}, capacity=256)}
            host.add_keyframe(mm, (R, t))
            dev.add_keyframe(mm, (R, t))
        a = host.build()["planes"]
        b = dev.build()["planes"]
        pa = np.asarray(a.xyz)[np.asarray(a.mask) > 0.5]
        pb = np.asarray(b.xyz)[np.asarray(b.mask) > 0.5]
        assert pa.shape == pb.shape
        order_a = np.lexsort(pa.T)
        order_b = np.lexsort(pb.T)
        np.testing.assert_allclose(pa[order_a], pb[order_b], atol=1e-4)
        na = np.asarray(a.attrs["normal"])[np.asarray(a.mask) > 0.5]
        nb = np.asarray(b.attrs["normal"])[np.asarray(b.mask) > 0.5]
        np.testing.assert_allclose(na[order_a], nb[order_b], atol=1e-4)

    def test_dedup_oldest_wins_and_window(self):
        dev = self._mk(window=2, capacity_mult=4, dedup_voxel=0.5)
        I = (np.eye(3), np.zeros(3))
        a = np.array([[0, 0, 0], [5, 0, 0]], np.float32)
        dev.add_keyframe({"decimated": _cloud(a, capacity=256)}, I)
        dev.add_keyframe({"decimated": _cloud(a + 0.01, capacity=256)}, I)
        mp = dev.build()
        pc = mp["decimated"]
        assert int(np.asarray(pc.mask).sum()) == 2
        kept = np.asarray(pc.xyz)[np.asarray(pc.mask) > 0.5]
        # oldest keyframe's exact coordinates survive the dedup
        assert (np.abs(kept - np.sort(a, axis=0)) < 1e-6).all() or \
               (np.abs(np.sort(kept, axis=0) - a) < 1e-6).all()
        # window eviction
        b = np.array([[9, 9, 9]], np.float32)
        dev.add_keyframe({"decimated": _cloud(b, capacity=256)}, I)
        dev.add_keyframe({"decimated": _cloud(b + 3, capacity=256)}, I)
        mp = dev.build()
        xyz = np.asarray(mp["decimated"].xyz)[
            np.asarray(mp["decimated"].mask) > 0.5]
        assert not (np.abs(xyz) < 1e-3).all(axis=1).any()
        assert len(dev) == 2

    def test_time_attr_dropped_and_capacity(self):
        dev = self._mk(window=2, capacity_mult={"planes": 4},
                       dedup_voxel=0.01)
        a = np.array([[0, 0, 0], [1, 1, 1]], np.float32)
        mm = {"planes": _cloud(
            a, {"normal": np.tile([0, 0, 1], (2, 1)).astype(np.float32),
                "time": np.linspace(0, 1, 2, dtype=np.float32)[:, None]},
            capacity=256)}
        dev.add_keyframe(mm, (np.eye(3), np.zeros(3)))
        mp = dev.build()
        assert set(mp["planes"].attrs) == {"normal"}
        assert mp["planes"].capacity == 1024

    def test_build_from_entries_snapshot(self):
        rng = np.random.default_rng(3)
        dev = self._mk(window=4, capacity_mult=2, dedup_voxel=0.1)
        I = (np.eye(3), np.zeros(3))
        for _ in range(3):
            pts = rng.uniform(-10, 10, (100, 3)).astype(np.float32)
            dev.add_keyframe({"decimated": _cloud(pts, capacity=256)}, I)
        snap = dev.entries()
        ref = dev.build()
        dev.add_keyframe(
            {"decimated": _cloud(rng.uniform(-10, 10, (50, 3)).astype(
                np.float32), capacity=256)}, I)
        got = dev.build(snap)
        np.testing.assert_array_equal(np.asarray(ref["decimated"].xyz),
                                      np.asarray(got["decimated"].xyz))


class TestDeviceLocalMapHash:
    """Sort-free hash-scatter build (DeviceLocalMap mode="hash") — same
    dedup/window/capacity semantics as the sort build, modulo a few % of
    hash-collision loss between DIFFERENT voxels."""

    def _mk(self, **kw):
        from mola_fe_lidar_tpu.frontend.local_map import DeviceLocalMap
        return DeviceLocalMap(mode="hash", **kw)

    def test_dedup_oldest_wins_and_window(self):
        dev = self._mk(window=2, capacity_mult=4, dedup_voxel=0.5)
        I = (np.eye(3), np.zeros(3))
        a = np.array([[0, 0, 0], [5, 0, 0]], np.float32)
        dev.add_keyframe({"decimated": _cloud(a, capacity=256)}, I)
        dev.add_keyframe({"decimated": _cloud(a + 0.01, capacity=256)}, I)
        mp = dev.build()
        pc = mp["decimated"]
        assert int(np.asarray(pc.mask).sum()) == 2
        kept = np.asarray(pc.xyz)[np.asarray(pc.mask) > 0.5]
        # oldest keyframe's exact coordinates survive the dedup
        assert (np.abs(np.sort(kept, axis=0) - np.sort(a, axis=0))
                < 1e-6).all()
        b = np.array([[9, 9, 9]], np.float32)
        dev.add_keyframe({"decimated": _cloud(b, capacity=256)}, I)
        dev.add_keyframe({"decimated": _cloud(b + 3, capacity=256)}, I)
        mp = dev.build()
        xyz = np.asarray(mp["decimated"].xyz)[
            np.asarray(mp["decimated"].mask) > 0.5]
        assert not (np.abs(xyz) < 1e-3).all(axis=1).any()  # origin evicted

    def test_coverage_close_to_sort_build(self):
        """On realistic random clouds the hash build keeps ≥90 % of the
        sort build's unique voxels (collision loss only) with the same
        world transform + normal rotation."""
        from mola_fe_lidar_tpu.frontend.local_map import DeviceLocalMap

        rng = np.random.default_rng(11)
        srt = DeviceLocalMap(window=4, capacity_mult=4, dedup_voxel=0.25)
        hsh = self._mk(window=4, capacity_mult=4, dedup_voxel=0.25)
        for i in range(3):
            pts = rng.uniform(-30, 30, (512, 3)).astype(np.float32)
            nrm = rng.normal(size=(512, 3)).astype(np.float32)
            nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
            R, t = se3_np.exp(rng.normal(scale=0.2, size=6))
            mm = {"planes": _cloud(pts, {"normal": nrm}, capacity=512)}
            srt.add_keyframe(mm, (R, t))
            hsh.add_keyframe(mm, (R, t))
        a, b = srt.build()["planes"], hsh.build()["planes"]
        na = int(np.asarray(a.mask).sum())
        nb = int(np.asarray(b.mask).sum())
        assert nb >= 0.9 * na, (na, nb)
        # hash-kept points are a subset of the input world points, and
        # normals ride along rotated: check one kept row against inputs
        kept = np.asarray(b.xyz)[np.asarray(b.mask) > 0.5]
        assert np.isfinite(kept).all() and (np.abs(kept) < 50).all()

    def test_capacity_overflow_is_uniform(self):
        rng = np.random.default_rng(2)
        dev = self._mk(window=1, capacity_mult=1, dedup_voxel=0.01)
        pts = rng.uniform(-50, 50, (600, 3)).astype(np.float32)
        dev.add_keyframe({"decimated": _cloud(pts, capacity=256)},
                         (np.eye(3), np.zeros(3)))
        pc = dev.build()["decimated"]
        assert pc.capacity == 256
        kept = np.asarray(pc.xyz)[np.asarray(pc.mask) > 0.5]
        # hash-slot order truncation is spatially uniform, not a slab
        assert (kept.max(0) - kept.min(0) > 60).all()


class TestTransientFilter:
    """Multi-view consistency suppression of dynamic objects in the
    rolling map (LocalMap.transient_min_views)."""

    @staticmethod
    def _fill(lm, n_kf=5):
        wall = np.stack([np.linspace(0, 10, 50), np.full(50, 5.0),
                         np.ones(50)], -1).astype(np.float32)
        for i in range(n_kf):
            rng = np.random.default_rng(i)
            car = (np.array([[3.0 * i, -5.0, 0.5]], np.float32)
                   + rng.normal(0, 0.05, (20, 3)).astype(np.float32))
            lm.add_keyframe({"raw": _cloud(np.concatenate([wall, car]),
                                           capacity=256)},
                            (np.eye(3), np.zeros(3)))

    def test_min_views_drops_old_transients_keeps_static(self):
        lm = LocalMap(window=6, capacity_mult=4, dedup_voxel=0.25,
                      transient_min_views=2)
        self._fill(lm)
        pc = lm.build()["raw"]
        kept = np.asarray(pc.xyz)[np.asarray(pc.mask) > 0.5]
        wall_kept = kept[kept[:, 1] > 0]
        car_kept = kept[kept[:, 1] < 0]
        assert len(wall_kept) > 30                      # static stays
        # cars from keyframes older than the protected newest-2 are gone
        assert np.all(car_kept[:, 0] > 3.0 * 3 - 1.0)

    def test_min_views_1_disables(self):
        on = LocalMap(window=6, capacity_mult=4, dedup_voxel=0.25,
                      transient_min_views=2)
        off = LocalMap(window=6, capacity_mult=4, dedup_voxel=0.25)
        self._fill(on), self._fill(off)
        n_on = int(np.sum(np.asarray(on.build()["raw"].mask)))
        n_off = int(np.sum(np.asarray(off.build()["raw"].mask)))
        assert n_off > n_on

    def test_protect_recent_keeps_fresh_territory(self):
        """Points seen only by the newest keyframes survive (they cover
        the territory the next scans enter)."""
        lm = LocalMap(window=6, capacity_mult=4, dedup_voxel=0.25,
                      transient_min_views=2, transient_protect_recent=2)
        self._fill(lm)
        pc = lm.build()["raw"]
        kept = np.asarray(pc.xyz)[np.asarray(pc.mask) > 0.5]
        car_kept = kept[kept[:, 1] < 0]
        # newest two cars sit at x=9 and x=12
        assert np.any(car_kept[:, 0] > 8.0)


class TestMapStageFloor:
    def test_default_keeps_reference_thresholds(self):
        """Default floor values equal the reference minAbsStep and the
        distance cap is off (the ablation showed both cost accuracy);
        the only default map-stage deviations are the two measured wins:
        the candidate cache (cand_k=4 — faster AND more accurate) and the
        quality-source subsample (max_points=8192 — an unbiased paired-
        ratio estimator over the 32k-cap map layers)."""
        import dataclasses
        from mola_fe_lidar_tpu.frontend.odometry import LidarOdometry
        from mola_fe_lidar_tpu.models.config import AlignKind
        from mola_fe_lidar_tpu.models.icp import _CAND_KINDS

        m = LidarOdometry()
        m.initialize({"params": {"odometry_reference": "local_map"}})
        kind = AlignKind.LIDAR_ODOMETRY
        for s0, s1 in zip(m.icp_cases[kind], m._stages_for(kind, True)):
            undone = dataclasses.replace(
                s1,
                matchers=tuple(
                    dataclasses.replace(mm, cand_k=0)
                    if mm.kind in _CAND_KINDS else mm for mm in s1.matchers),
                quality=tuple(
                    dataclasses.replace(q, max_points=q0.max_points)
                    for q, q0 in zip(s1.quality, s0.quality)))
            assert undone == s0
            for mm in s1.matchers:
                if mm.kind in _CAND_KINDS:
                    assert mm.cand_k == 4
            for q in s1.quality:
                assert q.max_points == 8192
        m.shutdown()

    def test_quality_max_points_respects_tighter_stage_value(self):
        """A stage whose YAML configures a SMALLER quality max_points keeps
        it — the module-level knob only ever tightens, never loosens."""
        import dataclasses
        from mola_fe_lidar_tpu.frontend.odometry import LidarOdometry
        from mola_fe_lidar_tpu.models.config import AlignKind

        m = LidarOdometry()
        m.initialize({"params": {"odometry_reference": "local_map"}})
        kind = AlignKind.LIDAR_ODOMETRY
        m.icp_cases[kind] = tuple(
            dataclasses.replace(s, quality=tuple(
                dataclasses.replace(q, max_points=2048) for q in s.quality))
            for s in m.icp_cases[kind])
        for s in m._stages_for(kind, True):
            for q in s.quality:
                assert q.max_points == 2048
        m.shutdown()

    def test_cand_motion_thresholds_apply_to_map_stages(self):
        """local_map_cand_motion_* land on the map-align stages as
        ICPParams.cand_refresh_min_*; scan-to-scan stages keep the fixed
        cadence (they run batched where the cond lowers to select)."""
        from mola_fe_lidar_tpu.frontend.odometry import LidarOdometry
        from mola_fe_lidar_tpu.models.config import AlignKind

        m = LidarOdometry()
        m.initialize({"params": {
            "odometry_reference": "local_map",
            "local_map_cand_motion_trans": 0.02,
            "local_map_cand_motion_rot": 0.001,
        }})
        kind = AlignKind.LIDAR_ODOMETRY
        for s in m._stages_for(kind, True):
            assert s.cand_refresh_min_trans == 0.02
            assert s.cand_refresh_min_rot == 0.001
        for s in m._stages_for(kind, False):
            assert s.cand_refresh_min_trans == 0.0
            assert s.cand_refresh_min_rot == 0.0
        m.shutdown()

    def test_gn_inner_override_applies_to_map_stages(self):
        """local_map_gn_inner caps the GN solver's inner iterations on map
        stages only (0 = keep the reference's 20)."""
        from mola_fe_lidar_tpu.frontend.odometry import LidarOdometry
        from mola_fe_lidar_tpu.models.config import AlignKind

        m = LidarOdometry()
        m.initialize({"params": {
            "odometry_reference": "local_map",
            "local_map_gn_inner": 2,
        }})
        kind = AlignKind.LIDAR_ODOMETRY
        for s in m._stages_for(kind, True):
            if s.solver.kind == "gauss_newton":
                assert s.solver.max_iterations == 2
        for s0, s1 in zip(m.icp_cases[kind], m._stages_for(kind, False)):
            assert s1.solver.max_iterations == s0.solver.max_iterations
        m.shutdown()

    def test_realtime_knobs_apply_to_map_stages(self):
        """local_map_max_iterations caps outer iterations, _nn_backend
        overrides the matcher NN route, and _cand_knn opts the kNN-kind
        matchers into the candidate cache — map stages only (the realtime
        operating point's levers; all default off)."""
        from mola_fe_lidar_tpu.frontend.odometry import LidarOdometry
        from mola_fe_lidar_tpu.models.config import AlignKind
        from mola_fe_lidar_tpu.models.icp import _CAND_KNN_KINDS

        m = LidarOdometry()
        m.initialize({"params": {
            "odometry_reference": "local_map",
            "local_map_max_iterations": 12,
            "local_map_nn_backend": "mxu",
            "local_map_cand_knn": True,
        }})
        kind = AlignKind.LIDAR_ODOMETRY
        for s0, s1 in zip(m.icp_cases[kind], m._stages_for(kind, True)):
            assert s1.max_iterations == min(s0.max_iterations, 12)
            for m0, m1 in zip(s0.matchers, s1.matchers):
                assert m1.nn_backend == "mxu"
                if m1.kind in _CAND_KNN_KINDS:
                    assert m1.cand_k == max(4, m1.knn + 3)
        # scan-to-scan untouched
        assert m._stages_for(kind, False) == m.icp_cases[kind]
        # the without-vel (cold-start) map case keeps the wide recruiting
        # stages: the truncating levers require the velocity prior
        cold = AlignKind.NEARBY_ALIGN
        for s0, s1 in zip(m.icp_cases[cold], m._stages_for(cold, True)):
            assert s1.max_iterations == s0.max_iterations
            for m0, m1 in zip(s0.matchers, s1.matchers):
                assert m1.distance_threshold == m0.distance_threshold
                # the non-truncating accelerations still apply
                assert m1.nn_backend == "mxu"
        m.shutdown()

    def test_tight_requires_prior_opt_out(self):
        """local_map_tight_requires_prior=false restores unconditional
        tightening (both align kinds capped)."""
        from mola_fe_lidar_tpu.frontend.odometry import LidarOdometry
        from mola_fe_lidar_tpu.models.config import AlignKind

        m = LidarOdometry()
        m.initialize({"params": {
            "odometry_reference": "local_map",
            "local_map_max_match_distance": 0.6,
            "local_map_max_iterations": 9,
            "local_map_tight_requires_prior": False,
        }})
        for kind in (AlignKind.LIDAR_ODOMETRY, AlignKind.NEARBY_ALIGN):
            for s0, s1 in zip(m.icp_cases[kind], m._stages_for(kind, True)):
                assert s1.max_iterations == min(s0.max_iterations, 9)
                for m0, m1 in zip(s0.matchers, s1.matchers):
                    assert m1.distance_threshold == min(
                        m0.distance_threshold, 0.6)
        m.shutdown()

    def test_distance_cap_applies_to_map_matchers(self):
        from mola_fe_lidar_tpu.frontend.odometry import LidarOdometry
        from mola_fe_lidar_tpu.models.config import AlignKind

        m = LidarOdometry()
        m.initialize({"params": {
            "odometry_reference": "local_map",
            "local_map_max_match_distance": 0.5,
        }})
        kind = AlignKind.LIDAR_ODOMETRY
        for s0, s1 in zip(m.icp_cases[kind], m._stages_for(kind, True)):
            for m0, m1 in zip(s0.matchers, s1.matchers):
                assert m1.distance_threshold == min(m0.distance_threshold, 0.5)
        # scan-to-scan untouched
        assert m._stages_for(kind, False) == m.icp_cases[kind]
        m.shutdown()

    def test_stages_for_raises_thresholds_only_for_map(self):
        """Map-align stages get the convergence floor; scan-to-scan keeps
        the reference minAbsStep values untouched."""
        from mola_fe_lidar_tpu.frontend.odometry import LidarOdometry
        from mola_fe_lidar_tpu.models.config import AlignKind

        m = LidarOdometry()
        m.initialize({"params": {
            "odometry_reference": "local_map",
            "local_map_min_abs_step_trans": 2e-3,
            "local_map_min_abs_step_rot": 4e-4,
        }})
        kind = AlignKind.LIDAR_ODOMETRY
        plain = m._stages_for(kind, for_map=False)
        assert plain == m.icp_cases[kind]
        raised = m._stages_for(kind, for_map=True)
        for s0, s1 in zip(plain, raised):
            assert s1.min_abs_step_trans == max(s0.min_abs_step_trans, 2e-3)
            assert s1.min_abs_step_rot == max(s0.min_abs_step_rot, 4e-4)
            # beyond the convergence knobs, only the default map-stage
            # accelerations (candidate cache, quality subsample) differ
            import dataclasses
            from mola_fe_lidar_tpu.models.icp import _CAND_KINDS
            assert dataclasses.replace(
                s1, min_abs_step_trans=s0.min_abs_step_trans,
                min_abs_step_rot=s0.min_abs_step_rot,
                matchers=tuple(
                    dataclasses.replace(mm, cand_k=0)
                    if mm.kind in _CAND_KINDS else mm for mm in s1.matchers),
                quality=tuple(
                    dataclasses.replace(q, max_points=q0.max_points)
                    for q, q0 in zip(s1.quality, s0.quality))) == s0
        m.shutdown()


class TestLocalMapOdometry:
    @pytest.mark.slow
    def test_local_map_mode_tracks_synthetic_run(self):
        """Full front-end in local_map mode on a synthetic sequence: map
        forms, keyframes appear, world pose advances consistently with the
        factor chain (rel factors compose to the world pose at last KF)."""
        from mola_fe_lidar_tpu.obs.runner import build_module
        from mola_fe_lidar_tpu.obs.synthetic import synthetic_sequence

        obs, gt = synthetic_sequence(n_scans=10, kind="straight")
        cfg = {"params": {
            "odometry_reference": "local_map",
            "local_map_keyframes": 5,
            "min_dist_xyz_between_keyframes": 0.5,
            "min_icp_goodness": 0.3,
        }}
        m = build_module(cfg)
        for o in obs:
            m.on_new_observation(o)
        m.drain()
        st = m.state_copy()
        assert st.local_map is not None
        assert st.last_kf is not None and st.last_kf >= 1
        # compose the ODOMETRY factor chain (consecutive KF ids only — the
        # edge log also records nearby-KF extra edges, which would double-
        # count) to the last KF's pose; world estimate at the last
        # processed scan = KF pose + residual accumulation
        Rw, tw = np.eye(3), np.zeros(3)
        for (a, b, R, t) in st.edge_log:
            if b == a + 1:
                Rw, tw = Rw @ R, Rw @ t + tw
        Rw, tw = Rw @ st.accum_since_last_kf_R, Rw @ st.accum_since_last_kf_t + tw
        np.testing.assert_allclose(tw, st.world_t, atol=1e-5)
        m.shutdown()


class TestDegeneratePrior:
    """Weak MAP prior pins degenerate directions to the initial guess.

    A corridor (ground + two parallel walls along x) leaves x-translation
    unobservable: without a prior, noise can slide the solution along the
    corridor by many meters while quality stays high (measured 11 m/scan
    teleports on the HDL-64 sim city). With the prior, x sticks to the
    guess while the observable directions are still solved from data.
    """

    def _corridor(self, rng, n=3072):
        g = np.stack([rng.uniform(-30, 30, n // 2),
                      rng.uniform(-4, 4, n // 2),
                      rng.normal(0, 0.02, n // 2)], -1)
        w1 = np.stack([rng.uniform(-30, 30, n // 4),
                       np.full(n // 4, 4.0) + rng.normal(0, 0.02, n // 4),
                       rng.uniform(0, 5, n // 4)], -1)
        w2 = np.stack([rng.uniform(-30, 30, n // 4),
                       np.full(n // 4, -4.0) + rng.normal(0, 0.02, n // 4),
                       rng.uniform(0, 5, n // 4)], -1)
        return np.concatenate([g, w1, w2]).astype(np.float32)

    def test_prior_pins_corridor_axis(self):
        import dataclasses
        import jax.numpy as jnp
        from mola_fe_lidar_tpu.geometry import se3
        from mola_fe_lidar_tpu.models import (
            ICPParams, Matcher, PairWeights, Quality, Solver)
        from mola_fe_lidar_tpu.models.icp import align

        rng = np.random.default_rng(5)
        # independent samplings of the SAME corridor surfaces: a real
        # observable offset in (y, z, yaw) plus nothing observable in x
        tgt_pts = self._corridor(rng)
        src_pts = self._corridor(rng)
        true = se3.exp(jnp.asarray(
            np.array([0.0, 0.25, 0.1, 0, 0, 0.02], np.float32)))
        src_pts = np.asarray(se3.transform(se3.inverse(true), jnp.asarray(src_pts)))
        src = {"raw": from_points(src_pts, capacity=3072)}
        tgt = {"raw": from_points(tgt_pts, capacity=3072)}
        base = ICPParams(
            max_iterations=40,
            matchers=(Matcher(kind="point2plane_knn", distance_threshold=1.0,
                              knn=6, plane_eigen_threshold=0.2),),
            solver=Solver(kind="gauss_newton", max_iterations=10,
                          prior_sigma_trans=1.0, prior_sigma_rot=0.25),
            quality=(Quality(threshold_distance=0.3),),
            weights=PairWeights(use_scale_outlier_detector=False),
        )
        res = align(src, tgt, se3.identity(), base)
        t = np.asarray(res.pose.t)
        tau = np.asarray(se3.log(res.pose))
        # observable axes recovered from data
        assert abs(t[1] - 0.25) < 0.05, t
        assert abs(t[2] - 0.1) < 0.05, t
        assert abs(tau[5] - 0.02) < 0.01, tau
        # unobservable corridor axis pinned to the guess, no slide
        assert abs(t[0]) < 0.25, t


class TestRealtimeLatencyKnobs:
    def test_quality_subsample_applies_to_map_stages(self):
        """local_map_quality_max_points (default 8192) patches
        Quality.max_points onto BOTH map align kinds (statistics, not
        truncation); scan-to-scan stages keep full-layer quality."""
        from mola_fe_lidar_tpu.frontend.odometry import LidarOdometry
        from mola_fe_lidar_tpu.models.config import AlignKind

        m = LidarOdometry()
        m.initialize({"params": {"odometry_reference": "local_map"}})
        for kind in (AlignKind.LIDAR_ODOMETRY, AlignKind.NEARBY_ALIGN):
            for s in m._stages_for(kind, True):
                assert all(q.max_points == 8192 for q in s.quality)
            for s in m._stages_for(kind, False):
                assert all(q.max_points == 0 for q in s.quality)
        m.shutdown()

    def test_quality_subsample_unbiased(self):
        """Subsampled paired-ratio quality tracks the full evaluation."""
        import numpy as np
        import jax.numpy as jnp
        from mola_fe_lidar_tpu.cloud import from_points
        from mola_fe_lidar_tpu.geometry import se3
        from mola_fe_lidar_tpu.models import ICPParams, Matcher, Quality, Solver
        from mola_fe_lidar_tpu.models.icp import align

        rng = np.random.default_rng(3)
        pts = rng.uniform(-20, 20, (4096, 3)).astype(np.float32)
        src = {"raw": from_points(pts, capacity=4096)}
        tgt = {"raw": from_points(
            (pts + rng.normal(0, 0.03, pts.shape)).astype(np.float32),
            capacity=4096)}
        base = ICPParams(
            max_iterations=1,
            matchers=(Matcher(kind="point2point", distance_threshold=0.5),),
            solver=Solver(kind="horn"),
            quality=(Quality(threshold_distance=0.10),))
        import dataclasses
        sub = dataclasses.replace(base, quality=(
            Quality(threshold_distance=0.10, max_points=1024),))
        qf = float(align(src, tgt, se3.identity(), base).quality)
        qs = float(align(src, tgt, se3.identity(), sub).quality)
        assert 0.2 < qf < 1.0
        assert abs(qf - qs) < 0.05, (qf, qs)

    def test_nearby_caps(self):
        """nearby_max_iterations caps the batch stages; nearby_cand_knn
        opts the kNN matchers into the candidate cache."""
        from mola_fe_lidar_tpu.frontend.odometry import LidarOdometry
        from mola_fe_lidar_tpu.models.config import AlignKind
        from mola_fe_lidar_tpu.models.icp import _CAND_KNN_KINDS

        m = LidarOdometry()
        m.initialize({"params": {
            "nearby_max_iterations": 25,
            "nearby_cand_knn": True,
        }})
        for s0, s1 in zip(m.icp_cases[AlignKind.NEARBY_ALIGN],
                          m._nearby_stages()):
            assert s1.max_iterations == min(s0.max_iterations, 25)
            for mm in s1.matchers:
                if mm.kind in _CAND_KNN_KINDS:
                    assert mm.cand_k == max(m.params.nearby_cand_k,
                                            mm.knn + 3)
        m.shutdown()
