"""The harness finds a cell's files by name, refuses unknown names, and
``BENCHMARK.json`` keeps to the benchmark's format and limits."""

import json
import re

import pytest

import common

SPEC = common.load_spec()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_every_cell_finds_its_files():
    for cell in SPEC["workloads"]:
        cfg = common.load_config(cell["config"])
        mix = common.load_traffic(cell["traffic"])
        assert cfg["name"] == cell["config"]
        feed = common.load_feed(mix["kind"])
        assert callable(feed.run) and isinstance(mix[feed.SAMPLE], int)
        assert callable(getattr(common.load_reference(cell["config"]), f"check_{mix['kind']}"))
        assert mix["call"] in cfg["limits"]
    for m in SPEC["per_layer"]:
        assert callable(common.load_reader(m["name"]).read)


def test_a_kind_without_a_feed_is_refused(monkeypatch, capsys):
    import run as bench_run
    with pytest.raises(common.BenchError, match="no feed"):
        common.load_feed("no-such-kind")
    real = common.load_traffic
    monkeypatch.setattr(common, "load_traffic", lambda n: {**real(n), "kind": "no-such-kind"})
    rc = bench_run.main(["--workload", "loc-track", "--seed", "1", "--seconds", "1",
                         "--trace", "0", "--rehearse"])
    captured = capsys.readouterr()
    assert rc != 0 and captured.out == "" and "no-such-kind" in captured.err


_ECHO_FEED = """
import time
SAMPLE = "sample_ticks"

def run(ctx):
    ctx.mark("inputs_made")
    ctx.ready()
    t_end = time.perf_counter() + ctx.args.seconds
    done = []
    while time.perf_counter() < t_end:
        done.append(len(done))
        time.sleep(0.01)
    return {"e2e": {"ticks_per_s": len(done) / ctx.args.seconds}, "latencies_ms": [10.0],
            "attempted": len(done), "failed": 0, "slice": None, "info": {},
            "state": {"done": done}}
"""
_ECHO_REFERENCE = """
def check_echo(cfg, state, sample, device):
    return {"ticks_missing": sum(1 for k in sample if state["done"][k] != k), "rows": []}
"""


def test_a_new_kind_is_new_files_alone(tmp_path):
    """A copy of the benchmark takes a cell of a kind it has never seen
    from new files and new entries in BENCHMARK.json alone: a feed, a
    configuration with its reference, a mix; no file of the copy changes."""
    import shutil
    import subprocess
    import sys
    root = tmp_path / "checkout"
    shutil.copytree(common.BENCH, root / "benchmark",
                    ignore=shutil.ignore_patterns("cache", "__pycache__", "tests"))
    (root / "mola_fe_lidar_tpu_torch").symlink_to(common.ROOT / "mola_fe_lidar_tpu_torch")
    before = {p: p.read_bytes() for p in (root / "benchmark").rglob("*") if p.is_file()}
    bench = root / "benchmark"
    (bench / "drive_echo.py").write_text(_ECHO_FEED)
    (bench / "configs" / "echo-config.json").write_text(json.dumps(
        {"name": "echo-config", "sensor": {"azimuths": 1}, "rehearsal": {"azimuths": 1},
         "limits": {"tick": {"ticks_missing": 0}}}))
    (bench / "configs" / "echo-config.py").write_text(_ECHO_REFERENCE)
    (bench / "traffic" / "echo-mix.json").write_text(json.dumps(
        {"kind": "echo", "call": "tick", "sample_ticks": 5}))
    spec = json.loads(json.dumps(SPEC))
    spec["configs"].append({"name": "echo-config", "source": "a test", "reduced": [],
                            "file": "benchmark/configs/echo-config.json", "why": "a test"})
    spec["workloads"].append({"name": "echo", "config": "echo-config", "traffic": "echo-mix",
                              "chips": 1, "why": "a test"})
    spec["end_to_end"].append({"name": "ticks_per_s", "unit": "1/s", "better": "higher",
                               "bound": 0.1, "source": "host_clock", "workloads": ["echo"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    proc = subprocess.run([sys.executable, str(bench / "run.py"), "--workload", "echo", "--seed",
                           "3", "--seconds", "1", "--trace", "0", "--rehearse"], cwd=root,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    last = json.loads(proc.stdout.strip().splitlines()[-1])
    assert last["correct"] is True
    assert set(last["metrics"]) == {"setup_s", "ticks_per_s"}
    assert last["checks"] == {"ticks_missing": {"value": 0, "limit": 0}}
    assert all(p.read_bytes() == b for p, b in before.items())


@pytest.mark.parametrize("loader,name", [
    (lambda n: common.workload(SPEC, n), "no-such-cell"),
    (common.load_config, "no-such-config"),
    (common.load_traffic, "no-such-mix"),
    (common.load_reader, "no_such_metric"),
    (common.load_reference, "no-such-config"),
    (common.load_feed, "no-such-kind"),
    (common.load_feed, "../drive_localize"),
    (common.load_config, "../configs/kitti-hdl64-relocalize"),
])
def test_unknown_names_are_refused(loader, name):
    with pytest.raises(common.BenchError):
        loader(name)


def test_benchmark_json_keeps_to_its_format():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert 1 <= SPEC["run_seconds"] <= 51 and isinstance(SPEC["run_seconds"], int)
    assert len(json.dumps(SPEC)) < 64 * 1024
    configs = {c["name"]: c for c in SPEC["configs"]}
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/") and (common.ROOT / c["file"]).is_file()
        assert 0 < len(c["source"]) <= 200 and 0 < len(c["why"]) <= 200
    cells = set()
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in configs and w["chips"] in (1, 4) and len(w["why"]) <= 200
        assert (w["config"], w["traffic"]) not in cells
        cells.add((w["config"], w["traffic"]))
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in SPEC["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    layers = set()
    for m in SPEC["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["moves"] in e2e and m["source"] in ("device_trace", "program_span",
                                                     "program_counter", "host_clock")
        layers.add(m["layer"])
        for cell in m.get("workloads", []):
            reports = [n for n, e in e2e.items() if cell in e.get("workloads", [cell])]
            assert m["moves"] in reports
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for w in SPEC["workloads"]:
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        reported = [m for m in SPEC["per_layer"] if w["name"] in m.get("workloads", [])]
        assert reported, w["name"]
    for c in SPEC["configs"]:
        assert NAME.match(c["name"])


def test_percentile_is_numpys_linear():
    import numpy as np
    xs = [5.0, 1.0, 9.0, 3.0, 7.0, 2.0]
    for q in (0, 10, 50, 90, 100):
        assert common.percentile(xs, q) == pytest.approx(float(np.percentile(xs, q)))
