"""The port's copies of the JAX package's numpy-only modules (trajectory
metrics, synthetic and KITTI readers, YAML config, registry, profiler,
logger) against their originals. The port may not import the JAX package,
so it carries copies; these tests keep them from drifting.

Tolerance: exact. Both sides run the same numpy code on the same inputs.
"""

import logging
from pathlib import Path

import numpy as np
import pytest

from mola_fe_lidar_tpu.obs import kitti as jkitti
from mola_fe_lidar_tpu.obs import metrics as jmetrics
from mola_fe_lidar_tpu.obs import synthetic as jsynthetic
from mola_fe_lidar_tpu.utils import config as jconfig
from mola_fe_lidar_tpu.utils import logging as jlogging
from mola_fe_lidar_tpu.utils import profiler as jprofiler
from mola_fe_lidar_tpu.utils import registry as jregistry
from mola_fe_lidar_tpu_torch.obs import kitti, metrics, synthetic
from mola_fe_lidar_tpu_torch.utils import config, profiler, registry
from mola_fe_lidar_tpu_torch.utils import logging as tlogging

REPO = Path(__file__).resolve().parent.parent


def _yaw(a):
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])


def _trajectories(n=320):
    """A 1 m-a-step drive with turns (long enough for KITTI's 100-800 m
    segments) and a noisy estimate of it."""
    rng = np.random.default_rng(7)
    yaw = np.cumsum(rng.normal(0.0, 0.02, n))
    t = np.cumsum(np.stack([np.cos(yaw), np.sin(yaw), np.zeros(n)], -1), 0)
    gt = [(_yaw(a), p) for a, p in zip(yaw, t)]
    est = [(_yaw(a + 0.01 * i / n), p + rng.normal(0.0, 0.05, 3))
           for i, (a, p) in enumerate(zip(yaw, t))]
    return est, gt


@pytest.mark.parametrize("fn, kwargs", [
    ("ate_rmse", {}),
    ("rpe_rmse", {"delta": 1}),
    ("rpe_rmse", {"delta": 10}),
    ("kitti_segment_errors", {}),
    ("kitti_segment_errors", {"lengths": (50, 100), "step": 3}),
])
def test_metrics_copy_is_the_reference(fn, kwargs):
    est, gt = _trajectories()
    got = getattr(metrics, fn)(est, gt, **kwargs)
    want = getattr(jmetrics, fn)(est, gt, **kwargs)
    assert np.all(np.isfinite(np.asarray(got, float)))
    assert got == want


def test_umeyama_copy_is_the_reference():
    est, gt = _trajectories()
    e = np.stack([t for _, t in est])
    g = np.stack([t for _, t in gt])
    for a, b in zip(metrics.umeyama_align(e, g), jmetrics.umeyama_align(e, g)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", [
    "kitti-default.yaml", "icp-settings-regular.yaml", "icp-settings-loop-closure.yaml"])
def test_load_yaml_copy_reads_the_reference_presets(name):
    port_file = REPO / "mola_fe_lidar_tpu_torch" / "params" / name
    ref_file = REPO / "mola_fe_lidar_tpu" / "params" / name
    assert port_file.read_bytes() == ref_file.read_bytes()
    got = config.load_yaml(str(port_file))
    assert got == jconfig.load_yaml(str(ref_file))
    if name == "kitti-default.yaml":
        # the includes were resolved, not left as strings
        assert isinstance(got["params"]["icp_settings_with_vel"], dict)


@pytest.mark.parametrize("key, kwargs", [
    ("a", {"cast": float}),
    ("b", {"deg_to_rad": True}),
    ("missing", {"default": 3}),
    ("none", {"default": "x"}),
])
def test_yaml_get_copy_is_the_reference(key, kwargs):
    cfg = {"a": "2.5", "b": 90, "none": None}
    assert config.yaml_get(cfg, key, **kwargs) == jconfig.yaml_get(cfg, key, **kwargs)
    with pytest.raises(config.MissingKey):
        config.yaml_get(cfg, "missing", required=True)


def test_synthetic_copy_is_the_reference():
    kw = dict(n_world_points=4000, points_per_scan=256, extent=60.0)
    obs, gt = synthetic.synthetic_sequence(
        "loop", n_scans=4, world=synthetic.SyntheticWorld(**kw))
    obs_j, gt_j = jsynthetic.synthetic_sequence(
        "loop", n_scans=4, world=jsynthetic.SyntheticWorld(**kw))
    for a, b in zip(obs, obs_j):
        np.testing.assert_array_equal(a["xyz"], b["xyz"])
        assert a["timestamp"] == b["timestamp"]
    for (R, t), (Rj, tj) in zip(gt, gt_j):
        np.testing.assert_array_equal(R, Rj)
        np.testing.assert_array_equal(t, tj)


def test_kitti_reader_copy_is_the_reference(tmp_path):
    rng = np.random.default_rng(3)
    seq = tmp_path / "sequences" / "00"
    (seq / "velodyne").mkdir(parents=True)
    (tmp_path / "poses").mkdir()
    for i in range(3):
        rng.normal(0, 20, (50, 4)).astype(np.float32).tofile(seq / "velodyne" / f"{i:06d}.bin")
    Tr = np.hstack([_yaw(0.3), [[0.1], [-0.2], [0.3]]])
    (seq / "calib.txt").write_text("P0: " + " ".join(["0"] * 12) + "\n"
                                   "Tr: " + " ".join(f"{v!r}" for v in Tr.ravel().tolist()) + "\n")
    (seq / "times.txt").write_text("0.0\n0.1\n0.2\n")
    poses = [np.hstack([_yaw(0.1 * i), [[i], [0.5 * i], [0.0]]]).ravel() for i in range(3)]
    np.savetxt(tmp_path / "poses" / "00.txt", poses)
    got = kitti.KittiOdometrySequence("00", root=str(tmp_path))
    want = jkitti.KittiOdometrySequence("00", root=str(tmp_path))
    assert len(got) == len(want) == 3
    np.testing.assert_array_equal(got.T_cam_velo, want.T_cam_velo)
    for (R, t), (Rj, tj) in zip(got.gt_poses_velo, want.gt_poses_velo):
        np.testing.assert_array_equal(R, Rj)
        np.testing.assert_array_equal(t, tj)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a["xyz"], b["xyz"])
        np.testing.assert_array_equal(a["intensity"], b["intensity"])
        assert (a["timestamp"], a["index"]) == (b["timestamp"], b["index"])


def test_registry_copy_is_the_reference():
    for mod in (registry, jregistry):
        reg = mod.Registry("matcher")
        reg.register("b")(1)
        reg.register("a")(2)
        assert reg.names() == ["a", "b"] and "a" in reg and reg.get("b") == 1
        with pytest.raises(ValueError):
            reg.register("a")(3)
        with pytest.raises(KeyError):
            reg.get("c")


def test_profiler_copy_is_the_reference():
    def fill(mod):
        p = mod.Profiler("p")
        for s in (0.25, 0.5, 0.125):
            p.record("doProcess.fused_step", s)
        p.register_user_measure("queue_length", 2.0)
        p.register_user_measure("queue_length", 4.0)
        with mod.ProfilerEntry(p, "scope"):
            pass
        return p.stats()

    got, want = fill(profiler), fill(jprofiler)
    assert got.keys() == want.keys()
    for k in ("doProcess.fused_step", "counter:queue_length"):
        assert got[k] == want[k]
    assert got["scope"]["count"] == want["scope"]["count"] == 1


def test_logger_throttle_copy_is_the_reference():
    class Keep(logging.Handler):
        def __init__(self):
            super().__init__()
            self.records = []

        def emit(self, record):
            self.records.append(record.getMessage())

    for mod in (tlogging, jlogging):
        log = mod.get_logger("copies_test")
        keep = Keep()
        log.logger.addHandler(keep)
        try:
            for i in range(3):
                log.error_throttle(3600.0, "dropped scan %d", i)
        finally:
            log.logger.removeHandler(keep)
        assert keep.records == ["dropped scan 0"]


def test_default_cfg_copy_is_the_reference():
    from mola_fe_lidar_tpu.obs import runner as jrunner
    from mola_fe_lidar_tpu_torch.obs import runner

    assert runner.DEFAULT_CFG == jrunner.DEFAULT_CFG
    assert runner.default_config() == jrunner.DEFAULT_CFG


def _bench():
    import importlib.util

    spec = importlib.util.spec_from_file_location("bench", REPO / "bench.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)  # defines functions only; its main is guarded
    return mod


def test_scan_pair_copies_are_the_reference():
    from mola_fe_lidar_tpu_torch.obs import scan_pairs

    bench = _bench()
    for n in (8, 2048, 2047):
        np.testing.assert_array_equal(scan_pairs.make_world(np.random.default_rng(n), n),
                                      bench.make_world(np.random.default_rng(n), n))
    got = scan_pairs.make_pairs(np.random.default_rng(7), 3, 256, tau_sigma=0.2)
    want = bench.make_pairs(np.random.default_rng(7), 3, 256, tau_sigma=0.2)
    for (w, tau), (wj, tauj) in zip(got, want):
        np.testing.assert_array_equal(w, wj)
        np.testing.assert_array_equal(tau, tauj)
    for tau in (np.zeros(6), np.r_[1.0, -2.0, 0.5, 1e-9, 0.0, 0.0], np.r_[0.3, 0.1, -0.2, 0.4, -0.3, 1.2]):
        for a, b in zip(scan_pairs._cpu_se3_exp(tau), bench._cpu_se3_exp(tau)):
            np.testing.assert_array_equal(a, b)
    # the stacked pair clouds (outlier pairs: a separate target world)
    pairs = got[:2] + [((got[2][0], got[2][0][::-1].copy()), got[2][1])]
    srcs, tgts, taus = scan_pairs.stack_pairs(pairs, 256, device="cpu")
    jsrcs, jtgts, jtaus = bench._stack_pairs(pairs, 256)
    np.testing.assert_array_equal(srcs["raw"].xyz.numpy(), np.asarray(jsrcs["raw"].xyz))
    np.testing.assert_array_equal(tgts["raw"].xyz.numpy(), np.asarray(jtgts["raw"].xyz))
    np.testing.assert_array_equal(srcs["raw"].mask.numpy(), np.asarray(jsrcs["raw"].mask))


@pytest.mark.parametrize("name", ["pose_graph.cpp", "io.cpp"])
def test_native_sources_are_the_reference(name):
    """The port's C++ runtime (``native/``) builds from copies of the JAX
    package's sources."""
    port = (REPO / "mola_fe_lidar_tpu_torch" / "native" / name).read_bytes()
    assert port == (REPO / "mola_fe_lidar_tpu" / "native" / name).read_bytes()


def test_crossover_clouds_are_the_reference():
    """``scripts/torch_bench_nn_backends.py`` times the reference
    crossover's clouds."""
    import importlib.util

    mods = []
    for name in ("bench_nn_backends", "torch_bench_nn_backends"):
        spec = importlib.util.spec_from_file_location(name, REPO / "scripts" / f"{name}.py")
        mods.append(importlib.util.module_from_spec(spec))
        spec.loader.exec_module(mods[-1])  # defines functions only; main is guarded
    for n in (64, 2048, 2047):
        for got, want in zip(mods[1].make_cloud(n, np.random.default_rng(n)),
                             mods[0].make_cloud(n, np.random.default_rng(n))):
            np.testing.assert_array_equal(got, want)
