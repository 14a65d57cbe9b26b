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
        assert mix["kind"] == "localize"
        assert hasattr(common.load_reference(cell["config"]), "check_localize")
    for m in SPEC["per_layer"]:
        assert callable(common.load_reader(m["name"]).read)


@pytest.mark.parametrize("loader,name", [
    (lambda n: common.workload(SPEC, n), "no-such-cell"),
    (common.load_config, "no-such-config"),
    (common.load_traffic, "no-such-mix"),
    (common.load_reader, "no_such_metric"),
    (common.load_reference, "no-such-config"),
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
