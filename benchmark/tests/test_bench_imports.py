"""A tiny run of a cell on the CPU (``--rehearse``) in its own process:
its last line is the result object with the expected keys (the
localizer's as they always were; the stream's whole path), and nothing
it loaded has the top-level name of JAX or of the JAX package (the run
itself refuses to print a result then; the sources are checked too)."""

import ast
import json
import os
import subprocess
import sys

import pytest

import common

RESULT_KEYS = {"correct", "attempted", "failed", "metrics", "device", "checks"}


def _run(*argv, timeout=900):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, str(common.BENCH / "run.py"), *argv],
                          cwd=common.ROOT, capture_output=True, text=True, timeout=timeout,
                          env=env)


# the end-to-end metrics each cell reports with --trace 0
E2E = {"loc-track": {"setup_s", "localize_p90_ms"},
       "odom-snake": {"setup_s", "scans_per_s", "pose_latency_p90_ms"}}


@pytest.mark.parametrize("cell,trace", [("loc-track", 0), ("loc-track", 1), ("odom-snake", 0)])
def test_tiny_run_prints_the_result_last(cell, trace):
    proc = _run("--workload", cell, "--seed", str(2**31 + 5), "--seconds", "12",
                "--trace", str(trace), "--rehearse")
    assert proc.returncode == 0, proc.stderr[-3000:]
    last = json.loads(proc.stdout.strip().splitlines()[-1])
    assert RESULT_KEYS <= set(last)
    assert set(last["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    assert last["device"]["platform"] == "cpu"
    assert proc.stderr.strip().splitlines()[-1].startswith("check ")
    spec = common.load_spec()
    if trace:
        assert {"busy_s", "window_s"} <= set(last["device"]) and "breakdown" in last
        assert set(last["metrics"]) <= {m["name"] for m in spec["per_layer"]}
    else:
        assert set(last["metrics"]) == E2E[cell]
    for m in last["metrics"].values():
        assert m["value"] > 0 and m["unit"]


def test_no_source_imports_jax():
    for path in common.BENCH.rglob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            for n in names:
                assert n.split(".")[0] not in common.FORBIDDEN_MODULES, (path, n)


def test_forbidden_modules_compare_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "mola_fe_lidar_tpu_torch_like", object())
    assert "mola_fe_lidar_tpu" not in common.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jaxlib.xla_client", object())
    assert common.forbidden_modules() == ["jaxlib"]


def test_unknown_workload_and_no_card_exit_nonzero():
    proc = _run("--workload", "no-such-cell", "--seed", "1", "--seconds", "1", "--trace", "0")
    assert proc.returncode != 0 and proc.stdout.strip() == ""
    import torch
    if torch.cuda.is_available():
        return  # the run without a card cannot be tried on a machine with one
    proc = _run("--workload", "loc-track", "--seed", "1", "--seconds", "1", "--trace", "0")
    assert proc.returncode != 0 and "CUDA" in proc.stderr and proc.stdout.strip() == ""
