#!/usr/bin/env python3
"""Benchmark of ``mola_fe_lidar_tpu_torch`` on one CUDA card: one run of
one cell.

    python3 benchmark/run.py --workload loc-track --seed 7 --seconds 51 --trace 0

The cell's entry in ``BENCHMARK.json`` names its configuration
(``benchmark/configs/<config>.json`` and its plain reference
``<config>.py``) and its traffic mix (``benchmark/traffic/<mix>.json``);
the mix's ``kind`` picks the feed that runs it (``benchmark/drive_<kind>.py``)
and the reference's comparison (``check_<kind>`` of ``<config>.py``);
each per-layer metric has its reader in ``benchmark/metrics/<metric>.py``.
A cell of a new kind is new files and entries in ``BENCHMARK.json``. With
``--trace 0`` the result line holds the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics, read from a traced slice of the
window.

Set-up (``setup_s``) runs from the process's start to the window's: the
imports, CUDA, loading or building the kernels, the scans made on the
card, the module or map and the cell's warm-up. After the window the
reference checks what the window produced; the comparisons close standard
error and the result line (``checks``); ``correct`` is false when any
fails. Exits non-zero, with no result line, without a CUDA card (or fewer
than the cell asks for), when JAX or the JAX package got loaded, or when
the program is not beside the benchmark.

``--rehearse`` runs a cell's path on the CPU at the tiny sizes of the
files' ``rehearsal`` blocks (the CPU tests use it). ``--precision tf32``
runs the program with TF32 matrix products, the configuration's control:
the run must then come out not correct.
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
for p in (str(ROOT), str(BENCH)):  # the program beside the benchmark, then the benchmark
    if p not in sys.path:
        sys.path.insert(0, p)
# build caches of the libraries at fixed places inside the checkout
os.environ["TORCH_EXTENSIONS_DIR"] = str(BENCH / "cache" / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(BENCH / "cache" / "triton")

import common  # noqa: E402
from common import BenchError  # noqa: E402

class Context:
    """What a feed gets: the cell's files, the arguments, the device, and
    the set-up clock."""

    def __init__(self, args, spec, cell, cfg, mix, device, rehearse):
        self.args, self.spec, self.cell = args, spec, cell
        self.cfg, self.traffic, self.device, self.rehearse = cfg, mix, device, rehearse
        self.sensor_azimuths = int(cfg["sensor"]["azimuths"] if not rehearse
                                   else cfg["rehearsal"]["azimuths"])
        self.marks = {}
        self.setup_s = None
        self.memory_peak = 0

    def mark(self, what: str) -> None:
        self.marks[what] = time.perf_counter() - T_PROCESS
        if what == "inputs_made":
            self._reset_peak()

    def _reset_peak(self) -> None:
        # the generator's temporaries are the benchmark's, not the program's
        import torch
        if self.device.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()

    def ready(self) -> None:
        self.setup_s = time.perf_counter() - T_PROCESS

    def read_memory(self) -> None:
        import torch
        if self.device.type == "cuda":
            self.memory_peak = int(torch.cuda.max_memory_allocated())


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--rehearse", action="store_true",
                    help="the cell's path on the CPU at the files' rehearsal sizes")
    ap.add_argument("--precision", choices=("f32", "tf32"), default="f32",
                    help="tf32: the program with TF32 matrix products (the control)")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    try:
        return _main(args)
    except BenchError as exc:
        print(f"benchmark: {exc}", file=sys.stderr)
        return 2


def _main(args) -> int:
    spec = common.load_spec()
    cell = common.workload(spec, args.workload)
    cfg = common.load_config(cell["config"])
    mix = common.load_traffic(cell["traffic"])
    feed = common.load_feed(mix["kind"])
    reference = common.load_reference(cell["config"])
    check = getattr(reference, f"check_{mix['kind']}", None)
    if check is None:
        raise BenchError(f"the reference of {cell['config']!r} has no check_{mix['kind']}")
    import torch
    if args.rehearse:
        device = torch.device("cpu")
    else:
        if not torch.cuda.is_available():
            raise BenchError("no CUDA card: the benchmark measures the program on one")
        if torch.cuda.device_count() < int(cell["chips"]):
            raise BenchError(f"the cell needs {cell['chips']} cards, "
                             f"{torch.cuda.device_count()} found")
        device = torch.device("cuda", 0)
        torch.cuda.set_device(device)
    import mola_fe_lidar_tpu_torch  # noqa: F401  (fixes its precision flags)
    if args.precision == "tf32":
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
    card = common.card_info() if device.type == "cuda" else {}
    probe_s = common.host_probe()
    ctx = Context(args, spec, cell, cfg, mix, device, args.rehearse)

    out = feed.run(ctx)
    if ctx.setup_s is None:
        raise BenchError("the feed never opened the window")
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    checks, ref_info = _checks(check, feed.SAMPLE, cfg, mix, args, out["state"], device)
    ref_s = time.perf_counter() - t_ref

    e2e_names = [m["name"] for m in spec["end_to_end"] if common.applies(m, cell["name"], ())]
    lat = out["latencies_ms"]
    values = {**out["e2e"], "setup_s": ctx.setup_s}
    units = {m["name"]: m["unit"] for m in spec["end_to_end"] + spec["per_layer"]}
    metrics = {}
    sl = out["slice"]
    if sl is not None:
        sl.reduce()
    if args.trace:
        rctx = {"slice": sl}
        for m in spec["per_layer"]:
            if not common.applies(m, cell["name"], e2e_names):
                continue
            v = common.load_reader(m["name"]).read(rctx)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    else:
        for name in e2e_names:
            if values.get(name) is None:
                raise BenchError(f"the feed gave no {name}")
            metrics[name] = {"value": float(values[name]), "unit": units[name]}

    device_line = {"platform": "gpu" if device.type == "cuda" else "cpu",
                   "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
                   "count": 1, "memory_peak_bytes": ctx.memory_peak}
    result = {"correct": all(c["ok"] for c in checks), "attempted": int(out["attempted"]),
              "failed": int(out["failed"]), "metrics": metrics, "device": device_line}
    if args.trace:
        if sl is None:
            raise BenchError("the traced slice never closed inside the window")
        device_line["busy_s"] = sl.busy_s
        device_line["window_s"] = sl.window_s
        out["info"].update(slice_units=sl.units, slice_range_s=sl.range_s,
                           slice_kernels=sl.kernel_launches, slice_real_sizes=sl.valid,
                           slice_search_shapes={k: {str(sh): c for sh, c in v.items()}
                                                for k, v in sl.shapes.items()},
                           slice_search_s=sl.search_seconds())
        from slice_trace import breakdown
        result["breakdown"] = breakdown(sl)
    info = {"workload": cell["name"], "seed": args.seed, "seconds": args.seconds,
            "trace": args.trace, "precision": args.precision, "card": card,
            "host_probe_s": probe_s, "setup_marks_s": ctx.marks, "reference_s": ref_s,
            "tail_samples": len(lat), "latency_ms_median": common.percentile(lat, 50),
            "end_to_end_all": values, **out["info"], **ref_info}
    found = common.forbidden_modules()
    if found:
        raise BenchError(f"loaded modules the benchmark must not load: {found}")
    common.emit(result, checks, info)
    return 0


def _checks(check, sample_key, cfg, mix, args, st, device):
    """The reference's comparisons of this run, each with its limit, and
    its readings for the information line: ``check`` judges a sample,
    drawn from the seed, of the units the feed completed (``st["done"]``),
    as many as the mix's ``sample_key`` says."""
    import traffic as traffic_mod
    sample = traffic_mod.sample(args.seed, len(st["done"]), int(mix[sample_key]), 0x10C)
    r = check(cfg, st, sample, device)
    info = {"reference_rows": r["rows"],
            "reference_readings": {k: v for k, v in r.items() if k != "rows"}}
    return [common.check(n, r[n], lim) for n, lim in cfg["limits"][mix["call"]].items()], info


if __name__ == "__main__":
    sys.exit(main())
