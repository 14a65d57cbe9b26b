"""What every cell shares: finding a workload's files by name, the card and
host readings, percentiles and the result line."""

from __future__ import annotations

import importlib.util
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path
from typing import Dict, Optional

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
# module names that must not be loaded in the process that prints a result,
# compared with each loaded module's top-level name whole
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "mola_fe_lidar_tpu")


class BenchError(RuntimeError):
    """A run that cannot give a result: the harness prints why and exits
    with a non-zero code."""


def _name_ok(name: str) -> bool:
    return (0 < len(name) <= 64 and (name[0].isalnum() or name[0] == "_")
            and all(c.isascii() and (c.isalnum() or c in "_.-") for c in name))


def load_spec(root: Path = ROOT) -> dict:
    path = root / "BENCHMARK.json"
    if not path.is_file():
        raise BenchError(f"no BENCHMARK.json at {root}")
    return json.loads(path.read_text())


def workload(spec: dict, name: str) -> dict:
    for w in spec["workloads"]:
        if w["name"] == name:
            return w
    raise BenchError(f"unknown workload {name!r}; BENCHMARK.json has "
                     f"{[w['name'] for w in spec['workloads']]}")


def _data_file(kind: str, name: str) -> Path:
    if not _name_ok(name):
        raise BenchError(f"bad {kind} name {name!r}")
    path = BENCH / kind / f"{name}.json"
    if not path.is_file():
        raise BenchError(f"no {kind} file for {name!r} (looked for {path.relative_to(ROOT)})")
    return path


def load_config(name: str) -> dict:
    """``configs/<name>.json``: the deployment's sizes and guarantees."""
    return json.loads(_data_file("configs", name).read_text())


def load_traffic(name: str) -> dict:
    """``traffic/<name>.json``: a traffic mix, read by ``traffic.py``."""
    return json.loads(_data_file("traffic", name).read_text())


def _load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_reference(config_name: str):
    """``configs/<name>.py``: the configuration's plain reference."""
    path = BENCH / "configs" / f"{config_name}.py"
    if not _name_ok(config_name) or not path.is_file():
        raise BenchError(f"no reference for configuration {config_name!r}")
    return _load_module(path, f"bench_reference_{config_name.replace('-', '_')}")


def load_feed(kind: str):
    """``drive_<kind>.py``: the feed of a traffic kind, whose ``run(ctx)``
    drives the program through the mix and whose ``SAMPLE`` names the
    mix's key for the number of units the reference checks."""
    path = BENCH / f"drive_{kind}.py"
    if not _name_ok(kind) or not path.is_file():
        raise BenchError(f"traffic kind {kind!r} has no feed (looked for drive_{kind}.py)")
    return _load_module(path, "bench_feed_" + kind.replace(".", "_").replace("-", "_"))


def load_reader(metric: str):
    """``metrics/<metric>.py``: a per-layer metric's reader, whose
    ``read(ctx)`` returns a number or None."""
    path = BENCH / "metrics" / f"{metric}.py"
    if not _name_ok(metric) or not path.is_file():
        raise BenchError(f"no reader for per-layer metric {metric!r}")
    return _load_module(path, "bench_metric_" + metric.replace(".", "_").replace("-", "_"))


def applies(metric: dict, cell: str, e2e_names) -> bool:
    """Whether a metric of BENCHMARK.json is reported by ``cell``: listed
    in its ``workloads``, or, without that key, in every cell that reports
    its end-to-end metric (``moves``) or, for an end-to-end metric, in all."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves") is None or metric["moves"] in e2e_names


def percentile(values, q: float) -> float:
    """The ``q``-th percentile (0-100) of all values, linear between the
    closest ranks (numpy's default)."""
    xs = sorted(values)
    if not xs:
        raise BenchError("percentile of no samples")
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def card_info() -> Dict[str, str]:
    """The card's name, power limit and SM clock as ``nvidia-smi`` reads
    them (empty values where it is missing)."""
    keys = ("name", "power.limit", "clocks.sm", "clocks.max.sm", "temperature.gpu")
    try:
        out = subprocess.run(["nvidia-smi", f"--query-gpu={','.join(keys)}",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30, check=True).stdout.strip().splitlines()[0]
        return dict(zip(keys, (v.strip() for v in out.split(","))))
    except (OSError, subprocess.SubprocessError, IndexError):
        return {k: "" for k in keys}


def host_probe() -> float:
    """Seconds a fixed numpy workload takes on this host (matrix products
    and a sort; the median of 5), to read host speed beside the times."""
    import numpy as np
    rng = np.random.default_rng(12345)
    a = rng.standard_normal((384, 384))
    v = rng.standard_normal(1 << 19)
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        b = a
        for _ in range(8):
            b = np.tanh(b @ a)
        np.sort(v)
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is one the benchmark must not
    load (JAX or the JAX package), compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN_MODULES))


def emit(result: dict, checks: list, info: dict) -> None:
    """Print the comparisons (each number beside its limit) as the last
    lines of standard error, the information line, then the result as the
    last line of standard output with the comparisons under ``checks``."""
    print(json.dumps({"info": info}, default=float), flush=True)
    for c in checks:
        print(f"check {c['name']}: {c['value']!r} (limit {c['limit']!r}, "
              f"{'ok' if c['ok'] else 'FAILED'})", file=sys.stderr)
    out = dict(result)
    out["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"]} for c in checks}
    sys.stderr.flush()
    print(json.dumps(out, default=float), flush=True)


def check(name: str, value, limit, ok: Optional[bool] = None) -> dict:
    """One compared number: passes when ``value <= limit`` unless ``ok``
    says otherwise."""
    return {"name": name, "value": value, "limit": limit,
            "ok": bool(value <= limit) if ok is None else bool(ok)}
