"""Port parity for the accuracy entry point: ``obs/accuracy.py`` and
``scripts/torch_run_accuracy.py`` against the functions of the JAX
package's ``scripts/run_accuracy.py`` (loaded by path), the runner CLI
against the JAX runner's, and the simulator's routes.

Inputs, made from seeds with numpy: a hand-built pose graph (8 keyframes
every 3 scans around a circle of 24 scans, noisy odometry factors, a
nearby factor and two true loop closures) and per-scan localizations,
fed to both packages' ``OptimizingBackend``; replays are replaced by stubs
that return that graph, so no test here aligns a scan.

Tolerances: every ATE within 1 mm of the reference's; configurations,
row keys, counters, names, injected pairs, printed summaries and
simulated scans exactly equal.
"""

import importlib.util
import json
import math
import sys
from pathlib import Path
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from mola_fe_lidar_tpu.frontend import backend as jbackend
from mola_fe_lidar_tpu.geometry import se3 as jse3
from mola_fe_lidar_tpu.obs import hdl64 as jhdl64
from mola_fe_lidar_tpu.obs import runner as jrunner
from mola_fe_lidar_tpu_torch.frontend import backend
from mola_fe_lidar_tpu_torch.geometry import se3_np
from mola_fe_lidar_tpu_torch.obs import accuracy, hdl64, runner

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parent.parent
ATE_TOL = 1e-3
N_SCANS, KF_EVERY = 24, 3
LC_PAIRS = [(7, 0), (6, 1)]
# the profiler counters the loop-closure audit reads: count = checks,
# total = accepts
STATS = {"counter:checkNonAdjacent.lc.accepted": {"count": 3, "total": 2.0, "mean": 2 / 3},
         "counter:checkNonAdjacent.nearby.accepted": {"count": 5, "total": 1.0, "mean": 0.2}}


def _load_script(name):
    spec = importlib.util.spec_from_file_location(name, REPO / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def ra():
    return _load_script("run_accuracy")


def _scenario():
    """(observations, ground truth, factors, localizations): keyframe k at
    scan 3k; factors (from, to, R, t) in insertion order; localizations
    (scan, keyframe, R, t)."""
    rng = np.random.default_rng(5)
    gt = [se3_np.exp(np.array([6.0 * math.sin(a), 6.0 * (1 - math.cos(a)), 0.0, 0.0, 0.0, a]))
          for a in np.arange(N_SCANS) * 2 * math.pi / N_SCANS]
    rel = lambda i, j: se3_np.compose(se3_np.inverse(gt[i]), gt[j])
    noisy = lambda p, s: se3_np.compose(p, se3_np.exp(rng.normal(0, s, 6) * [1, 1, 1, .1, .1, .1]))
    n_kf = N_SCANS // KF_EVERY
    factors = [(k, k + 1, *noisy(rel(KF_EVERY * k, KF_EVERY * (k + 1)), 0.08))
               for k in range(n_kf - 1)]
    factors.append((2, 0, *noisy(rel(6, 0), 0.02)))  # a nearby edge
    factors += [(a, b, *noisy(rel(KF_EVERY * a, KF_EVERY * b), 0.02)) for a, b in LC_PAIRS]
    locs = [(s, s // KF_EVERY, *noisy(rel(KF_EVERY * (s // KF_EVERY), s), 0.01))
            for s in range(N_SCANS)]
    obs = [{"timestamp": 0.1 * s} for s in range(N_SCANS)]
    return obs, gt, factors, locs


def _backend(pkg, pose, factors, locs, **kw):
    """``pkg``'s OptimizingBackend holding the scenario's graph."""
    b = pkg.OptimizingBackend(**kw)
    for k in range(N_SCANS // KF_EVERY):
        b.add_keyframe(pkg.ProposeKFInput(timestamp=0.1 * KF_EVERY * k)).result()
    for a, c, R, t in factors:
        b.add_factor(pkg.FactorRelativePose3(kf_from=a, kf_to=c, rel_pose=pose(R, t))).result()
    for s, k, R, t in locs:
        b.advertise_updated_localization(pkg.AdvertiseLocalization(
            timestamp=0.1 * s, reference_kf=k, pose=pose(R, t))).result()
    return b


@pytest.fixture(scope="module")
def graphs():
    """(obs, gt, port replay result, reference replay result): stub results
    holding each package's back-end and the module's loop-closure pairs."""
    obs, gt, factors, locs = _scenario()
    pb = _backend(backend, lambda R, t: backend.HostPose(np.float32(R), np.float32(t)),
                  factors, locs, device="cpu")
    jb = _backend(jbackend, lambda R, t: jse3.Pose(np.float32(R), np.float32(t)), factors, locs)
    results = []
    for b in (pb, jb):
        module = SimpleNamespace(state=SimpleNamespace(lc_pairs=list(LC_PAIRS)),
                                 profiler=SimpleNamespace(stats=lambda: json.loads(json.dumps(STATS))),
                                 shutdown=lambda: None)
        results.append({"n_scans": N_SCANS, "n_keyframes": len(b.keyframes),
                        "n_factors": len(b.factors), "wall_s": 12.5, "n_scan_poses": N_SCANS,
                        "n_nearby_edges": 1, "n_loop_closures": len(LC_PAIRS),
                        "jobs_abandoned": 0, "wall_to_steady_s": 2.5, "warm_s": None,
                        "ate_rmse": 0.25, "rpe_trans": 0.05, "rpe_rot": 0.01,
                        "ate_rmse_scan": 0.3, "kitti_t_rel_pct": 1.5,
                        "ate_rmse_pgo": 0.2, "ate_rmse_scan_pgo": 0.21,
                        "scans_per_sec_steady": 2.0, "backend": b, "module": module})
    yield obs, gt, results[0], results[1]
    pb.shutdown()
    jb.shutdown()


def test_build_cfg_is_the_reference_construction(ra):
    indexed = ("pointcloud_filter.0.params.voxel_size=0.5", "min_icp_goodness=0.25")
    for scale in (1.0, 0.25):
        for deskew in (False, True):
            assert accuracy.build_cfg(deskew, scale) == ra.build_cfg(deskew, scale)
            assert accuracy.build_cfg(deskew, scale, True, indexed) == \
                ra.build_cfg(deskew, scale, True, indexed)
        for name in accuracy.CONFIGS:
            # the reference harness's loop over --configs
            over = (ra.REALTIME if name == "realtime" else ()) + indexed
            want = ra.build_cfg(deskew=name in ("deskew", "local_map", "realtime"), scale=scale,
                                local_map=name in ("local_map", "local_map_nodeskew", "realtime"),
                                overrides=over)
            assert accuracy.config(name, int(2048 * scale), indexed) == want
    assert accuracy.CONFIGS == ("deskew", "no_deskew", "local_map", "local_map_nodeskew",
                                "realtime")
    with pytest.raises(ValueError):
        accuracy.config("realtim")


def _ate_close(got, want):
    assert np.isfinite(got) and abs(got - want) < ATE_TOL


def test_studies_match_reference(ra, graphs):
    obs, gt, res, jres = graphs
    pb, jb = res["backend"], jres["backend"]
    for robust in ("none", "cauchy"):
        _ate_close(accuracy.eval_scan_ate(pb, pb.optimized_poses(robust=robust), obs, gt),
                   ra.eval_scan_ate(jb, jb.optimized_poses(robust=robust), obs, gt))
    abl, jabl = (accuracy.lc_ablation_study(res, obs, gt, "cauchy"),
                 ra.lc_ablation_study(jres, obs, gt, "cauchy"))
    assert abl["n_lc_factors"] == jabl["n_lc_factors"] == len(LC_PAIRS)
    for key in ("ate_pgo_with_lc", "ate_pgo_without_lc"):
        _ate_close(abl[key], jabl[key])
    flc, jflc = (accuracy.false_lc_study(res, obs, gt, "cauchy"),
                 ra.false_lc_study(jres, obs, gt, "cauchy"))
    assert flc["injected_pair"] == jflc["injected_pair"] == [0, 4]
    for key in ("ate_clean_robust", "ate_poisoned_plain", "ate_poisoned_robust"):
        _ate_close(flc[key], jflc[key])
    # the studies leave the factor stream as they found it
    assert len(pb.factors) == len(jb.factors) == res["n_factors"]


def _compare_rows(row, jrow):
    assert sorted(row) == sorted(jrow)
    for key, want in jrow.items():
        got = row[key]
        if key in ("tunnel_rtt_ms", "scans_per_sec_steady_tunnel_adj"):
            continue  # timed in each run
        if key in ("false_lc_study", "lc_ablation"):
            assert sorted(got) == sorted(want)
            for k, v in want.items():
                if k.startswith("ate_"):
                    _ate_close(got[k], v)
                else:
                    assert got[k] == v
        else:
            assert got == want, key


def test_harness_rows_match_reference(ra, graphs, monkeypatch, tmp_path, capsys):
    """Both harnesses' command lines over the same stubbed replay: the same
    configurations reach ``run_replay``, and the rows (names with the
    override, route and parked-car suffixes; the loop-closure audit; the
    studies; trajectory length) are equal."""
    obs, gt, res, jres = graphs
    argv = ["--scans", str(N_SCANS), "--configs", "realtime,local_map", "--route", "relap",
            "--parked-cars", "7", "--override", "min_icp_goodness=0.25", "--pgo",
            "--pgo-robust", "cauchy", "--inject-false-lc"]
    seen = {"port": [], "ref": []}

    def stub(side, result):
        def run_replay(observations, cfg, **kw):
            assert observations is obs
            seen[side].append((cfg, kw.get("pgo"), kw.get("pgo_robust")))
            return result
        return run_replay

    monkeypatch.setattr(jax.config, "update", lambda *a, **k: None)  # no compile-cache setup
    monkeypatch.setattr(jhdl64, "hdl64_sequence", lambda **kw: (obs, gt))
    monkeypatch.setattr(jrunner, "run_replay", stub("ref", jres))
    monkeypatch.setattr(sys, "argv", ["run_accuracy.py", *argv, "--out", str(tmp_path / "j.json")])
    ra.main()
    monkeypatch.setattr(hdl64, "hdl64_sequence", lambda **kw: (obs, gt))
    monkeypatch.setattr(runner, "run_replay", stub("port", res))
    script = _load_script("torch_run_accuracy")
    assert script.main([*argv, "--device", "cpu", "--out", str(tmp_path / "p.json")]) == 0
    capsys.readouterr()
    assert seen["port"] == seen["ref"] and len(seen["ref"]) == 2
    got, want = (json.loads((tmp_path / f).read_text()) for f in ("p.json", "j.json"))
    assert {k: v for k, v in got.items() if k != "results"} == \
        {k: v for k, v in want.items() if k != "results"}
    assert sorted(want["results"]) == sorted(got["results"]) == [
        "relap:local_map+min_icp_goodness=0.25+parked7",
        "relap:realtime+min_icp_goodness=0.25+parked7"]
    for name, jrow in want["results"].items():
        _compare_rows(got["results"][name], jrow)
    # a second run of another route keeps the file's rows (same card and azimuth)
    assert script.main(["--scans", str(N_SCANS), "--configs", "realtime", "--device", "cpu",
                        "--out", str(tmp_path / "p.json")]) == 0
    assert len(json.loads((tmp_path / "p.json").read_text())["results"]) == 3
    with pytest.raises(SystemExit, match="unknown config"):
        script.main(["--configs", "realtime,realtim", "--device", "cpu"])


def test_runner_cli_runs_the_reference_default_and_summary(graphs, monkeypatch, capsys):
    """Without --config both runners replay DEFAULT_CFG, and the port's
    summary carries every key of the reference's with the same value."""
    _, _, res, _ = graphs
    result = dict(res, kf_poses={})
    seen = []

    def run_replay(observations, cfg, **kw):
        seen.append((len(observations), cfg, kw.get("pgo"), kw.get("pgo_robust")))
        return result

    monkeypatch.setattr(jrunner, "run_replay", run_replay)
    monkeypatch.setattr(runner, "run_replay", run_replay)
    argv = ["--scans", "3", "--pgo", "--pgo-robust", "cauchy"]
    assert jrunner.main(argv) == 0
    want = json.loads(capsys.readouterr().out)
    assert runner.main([*argv, "--device", "cpu"]) == 0
    got = json.loads(capsys.readouterr().out)
    assert seen[0] == seen[1] and seen[0][1] == jrunner.DEFAULT_CFG
    assert {k: got[k] for k in want} == want
    assert set(want) >= {"rpe_trans", "rpe_rot", "scans_per_sec"}
    assert sorted(set(got) - set(want)) == sorted((*runner.SUMMARY_EXTRA_KEYS, "device"))


def test_simulator_routes_are_the_reference():
    for kind in ("block", "relap", "snake", "outback"):
        route = hdl64.make_route(kind, hdl64.HDL64World(), speed=8.0)
        jroute = jhdl64.make_route(kind, jhdl64.HDL64World(), speed=8.0)
        for key in ("_s", "_xy", "_t"):
            np.testing.assert_array_equal(getattr(route, key), getattr(jroute, key))
        assert route.lap_time == jroute.lap_time and route.total_length == jroute.total_length
        for t in np.linspace(0.0, 1.2 * route.lap_time, 7):
            for a, b in zip(route(t), jroute(t)):
                np.testing.assert_array_equal(a, b)
    obs, gt = hdl64.hdl64_sequence(n_scans=2, n_azimuth=64, route_kind="relap", parked_cars=40)
    jobs, jgt = jhdl64.hdl64_sequence(n_scans=2, n_azimuth=64, route_kind="relap",
                                      parked_cars=40)
    for a, b in zip(obs, jobs):
        for key in ("xyz", "valid", "time"):
            np.testing.assert_array_equal(a[key], b[key])
    for (R, t), (jR, jt) in zip(gt, jgt):
        np.testing.assert_array_equal(R, jR)
        np.testing.assert_array_equal(t, jt)
