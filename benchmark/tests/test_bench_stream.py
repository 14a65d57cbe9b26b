"""The stream's reference (``configs/kitti-hdl64-realtime.py``) on a run
of the program on the CPU at the rehearsal sizes: the program's own
answers pass, and each of these fails the check: the program's poses
nudged by 1 mm, one keyframe moved by one scan, a scan handed over and
never posed, a kept plane point moved by 1 cm, a plane layer that keeps
half its points, a plane layer that keeps a point of a voxel that is no
plane. Then the feed's roofline sizes and pacing records: every scan of
the run has a known deskew twist."""

import copy

import numpy as np
import pytest
import torch

import common
import run as bench_run

CELL = "odom-snake"


@pytest.fixture(scope="module")
def stream_run():
    spec = common.load_spec()
    cell = common.workload(spec, CELL)
    cfg = common.load_config(cell["config"])
    mix = common.load_traffic(cell["traffic"])
    args = bench_run.parse(["--workload", CELL, "--seed", str(2**31 + 41), "--seconds", "10",
                            "--trace", "0", "--rehearse"])
    ctx = bench_run.Context(args, spec, cell, cfg, mix, torch.device("cpu"), True)
    out = common.load_feed(mix["kind"]).run(ctx)
    return cfg, mix, out, common.load_reference(cell["config"])


def _check(stream_run, state):
    cfg, mix, out, ref = stream_run
    sample = list(range(min(len(state["done"]), int(mix["sample_scans"]))))
    r = ref.check_stream(cfg, state, sample, torch.device("cpu"))
    limits = cfg["limits"][mix["call"]]
    return r, {n: r[n] <= lim for n, lim in limits.items()}


def test_the_programs_answers_pass(stream_run):
    _, _, out, _ = stream_run
    assert out["attempted"] >= 3 and out["failed"] == 0
    r, ok = _check(stream_run, out["state"])
    assert all(ok.values()), r
    assert r["checked_scans"] >= 3 and r["unsure_scans"] == 0
    # the program on the CPU and the reference agree to round-off
    assert r["pose_gap_median_m"] < 1e-5
    # the filter's layers of every scan the reference used were judged
    assert r["filter_scans"] >= r["checked_scans"] and r["filter_unsure_scans"] == 0


def _nudged(state, dx=1e-3):
    """Every scan's pose but the keyframes' moved by ``dx`` along x of its
    keyframe (the adverts, not the chain of keyframes)."""
    st = copy.deepcopy(state)
    locs = []
    for ts, kf, R, t in st["backend"]["localizations"]:
        if not np.allclose(t, 0.0):
            t = np.asarray(t, np.float32) + np.float32(dx) * np.array([1, 0, 0], np.float32)
        locs.append((ts, kf, R, t))
    st["backend"]["localizations"] = locs
    return st


def test_poses_nudged_by_a_millimetre_fail(stream_run):
    r, ok = _check(stream_run, _nudged(stream_run[2]["state"]))
    assert not ok["pose_gap_median_m"], r["pose_gap_median_m"]


def test_a_keyframe_moved_by_one_scan_fails(stream_run):
    st = copy.deepcopy(stream_run[2]["state"])
    kfs = st["backend"]["keyframes"]
    k = sorted(kfs)[len(kfs) // 2]
    kfs[k] = kfs[k] + st["period"]
    r, ok = _check(stream_run, st)
    assert r["keyframe_mismatches"] >= 1 and not ok["keyframe_mismatches"]


def test_a_scan_without_a_pose_fails(stream_run):
    st = copy.deepcopy(stream_run[2]["state"])
    j = st["window"][-1]
    st["backend"]["localizations"] = [
        x for x in st["backend"]["localizations"] if int(round(x[0] / st["period"])) != j]
    r, ok = _check(stream_run, st)
    assert r["scans_lost"] == 1 and not ok["scans_lost"]


def _sampled_scan(state):
    """The first scan of the window that the check reads."""
    return state["done"][0]["scan"]


def _with_planes(state, edit):
    st = copy.deepcopy(state)
    j = _sampled_scan(st)
    planes = st["layers"][j]["planes"]
    edit(st, j, planes)
    return st


def test_a_plane_point_moved_by_a_centimetre_fails(stream_run):
    def edit(st, j, planes):
        k = int(np.nonzero(planes["mask"] > 0.5)[0][0])
        planes["xyz"][k] += np.float32(0.01)
    r, ok = _check(stream_run, _with_planes(stream_run[2]["state"], edit))
    assert r["filter_breaks"] >= 1 and not ok["filter_breaks"]


def test_a_plane_layer_keeping_half_its_points_fails(stream_run):
    def edit(st, j, planes):
        kept = np.nonzero(planes["mask"] > 0.5)[0]
        planes["mask"][kept[::2]] = 0.0
    r, ok = _check(stream_run, _with_planes(stream_run[2]["state"], edit))
    assert r["filter_breaks"] >= 1 and not ok["filter_breaks"]


def test_a_plane_point_of_a_voxel_that_is_no_plane_fails(stream_run):
    _, _, out, ref = stream_run
    state = out["state"]
    j = _sampled_scan(state)
    s = ref.Settings(state["module"])
    tr = ref.Track(state)
    tw = tr.deskew_twist(j, state["prefetch"][j])
    xyz, valid, near_gate = ref.deskew(state["scans"][j], tw, s, torch.device("cpu"))
    vox, v = ref.voxels(xyz, valid, near_gate, s)
    # a return of a clear voxel of enough returns that is clearly no plane
    no_plane = v["clear"] & (v["count"] >= 5) & ~v["is_plane"] & (v["m_plane"] >= 10)
    k = int(torch.nonzero(valid & (vox >= 0) & no_plane[vox.clamp(min=0)])[0, 0])

    def edit(st, j, planes):
        slot = int(np.nonzero(planes["mask"] > 0.5)[0][0])
        planes["xyz"][slot] = xyz[k].numpy().astype(np.float32)
    r, ok = _check(stream_run, _with_planes(state, edit))
    assert r["filter_breaks"] >= 1 and not ok["filter_breaks"]


def test_every_scan_has_a_known_deskew_twist(stream_run):
    state = stream_run[2]["state"]
    assert all(v is not None for v in state["prefetch"].values())
    assert state["prefetch"][0] is False and state["prefetch"][1] is False


def test_slice_sizes_name_the_padded_buffers(stream_run):
    cfg, mix, out, _ = stream_run
    state = out["state"]
    feed = common.load_feed(mix["kind"])
    fep = state["module"]["params"]["pointcloud_filter"][1]["params"]
    dec, planes = fep["decimated_capacity"], fep["planes_capacity"]

    class Kept:   # the program's layers; a local map of 4x a layer, half full
        def layers(self, j):
            return state["layers"].get(j)

        def map_masks(self, j):
            return {n: np.repeat([1.0, 0.0], 2 * fep[f"{n}_capacity"]).astype(np.float32)
                    for n in ("decimated", "planes", "edges")}

    sizes = feed._slice_sizes(Kept(), state["backend"], state["period"], state["window"][:2],
                              state["module"])
    real_n, real_m = sizes["pairs"][f"{dec}x{4 * planes}"]
    lay = state["layers"][state["window"][0]]
    assert 0 < real_n <= dec and real_m == 2 * planes
    assert real_n == pytest.approx(np.mean([state["layers"][j]["decimated"]["mask"].sum()
                                            for j in state["window"][:2]]))
    assert lay["planes"]["mask"].shape[0] == planes
    real_n, real_m = sizes["pairs"][f"{dec}x{planes}"]   # the nearby checks
    assert 0 < real_n <= dec and 0 < real_m <= planes


def test_the_module_block_is_the_realtime_configuration():
    import json
    from mola_fe_lidar_tpu_torch.obs.runner import realtime_config
    cfg = common.load_config("kitti-hdl64-realtime")
    assert cfg["module"] == json.loads(json.dumps(realtime_config()))
