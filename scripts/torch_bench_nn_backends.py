#!/usr/bin/env python3
"""Nearest-neighbour backend crossover of the PyTorch port on one GPU (the
port of ``scripts/bench_nn_backends.py``).

    python3 scripts/torch_bench_nn_backends.py [--sizes 2048,8192,32768,131072]
        [--reps 9] [--out docs/torch_nn_crossover.json]

At each size N = M (the reference script's clouds, ``make_cloud``: a ground
plane and walls over 120 m x 120 m, 5 % masked padding, seed 0) it times:

* ``k2_nn``: K2, the exact 1-NN kernel (``ops/nn_kernel.py``);
* ``k1_knn6``: K1 at k = 6 (``ops/knn_kernel.py``);
* ``grid_build_query``: the voxel-hash grid (``ops/grid_nn.py``, cell 1 m,
  buckets of 8) built and queried in one call (``grid_nn``);
* ``grid_build``: the build alone; ``grid_query``: the query alone on a
  prebuilt index, which is what an ICP iteration pays (the index is built
  once per align);
* ``grid_query_floor``: the query of 64 sources against the same index --
  the launch floor of the query's chain of PyTorch operations.

``ms`` is the median of ``--reps`` calls, each timed with CUDA events after
two warm-up calls; ``loop10_ms`` is the time a call within 10 calls chained
through a data dependency (each call's source moved by 0 x the previous
result's least distance), with no host read in between: the in-loop cost,
as the reference's ``time_call(chain=8)`` column. Every row is checked
against a scipy ``cKDTree`` on the CPU: the exact searches by the share of
sources (``recall``) whose distances match within 1 mm; the grid by that
share among sources whose true neighbour lies within 0.9 of the cell
(``exact_within_cell``; a miss there is a neighbour dropped from an
overfull bucket) and over all sources (``recall``). Writes one JSON object
(the rows, a per-size summary of grid / K2 ratios, the card's name and
power limit from ``nvidia-smi``) to ``--out`` and prints it.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import numpy as np  # noqa: E402

K = 6
CELL = 1.0       # the reference script's grid cell
RADIUS = 0.9     # ... and the radius its grid rows are judged within
CHAIN = 10
FLOOR_SOURCES = 64


def make_cloud(n, rng, extent=60.0):
    """LiDAR-ish scene: ground plane + structures, ~5% padding (a copy of
    ``scripts/bench_nn_backends.py::make_cloud``)."""
    n_valid = int(n * 0.95)
    ground = np.stack([
        rng.uniform(-extent, extent, n_valid // 2),
        rng.uniform(-extent, extent, n_valid // 2),
        rng.normal(0, 0.05, n_valid // 2)], -1)
    walls = np.stack([
        rng.uniform(-extent, extent, n_valid - n_valid // 2),
        rng.uniform(-extent, extent, n_valid - n_valid // 2),
        rng.uniform(0, 6, n_valid - n_valid // 2)], -1)
    pts = np.concatenate([ground, walls]).astype(np.float32)
    xyz = np.zeros((n, 3), np.float32)
    xyz[:n_valid] = pts
    mask = np.zeros(n, np.float32)
    mask[:n_valid] = 1.0
    return xyz, mask


def _event_ms(torch, fn, reps):
    """Median and all of ``reps`` calls, each timed with CUDA events, after
    two warm-up calls."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times)), times


def _chained_ms(torch, fn, src, reps):
    """The median time a call within CHAIN calls chained through their
    results (no host read between them)."""
    def chain():
        s = src
        for _ in range(CHAIN):
            s = s + fn(s).dist.min() * 0.0
        return s

    ms, _ = _event_ms(torch, chain, max(3, reps // 2))
    return ms / CHAIN


def card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sizes", default="2048,8192,32768,131072")
    ap.add_argument("--reps", type=int, default=9)
    ap.add_argument("--out", default=str(REPO / "docs" / "torch_nn_crossover.json"))
    args = ap.parse_args(argv)
    if args.reps < 5:
        ap.error("--reps must be at least 5")

    import torch
    from scipy.spatial import cKDTree

    from mola_fe_lidar_tpu_torch.ops import grid_nn, knn_kernel, nn_kernel

    if not torch.cuda.is_available():
        print("torch_bench_nn_backends: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    stamp = card()
    print(f"card: {stamp}", file=sys.stderr)
    rng = np.random.default_rng(0)
    rows, summary = [], []
    for n in [int(s) for s in args.sizes.split(",")]:
        src, smask = make_cloud(n, rng)
        tgt, tmask = make_cloud(n, rng)
        d_ref, _ = cKDTree(tgt[tmask > 0.5]).query(src, k=K)
        d1 = d_ref[:, 0]
        ok = smask > 0.5
        s, sm, t, tm = (torch.from_numpy(a).to(dev) for a in (src, smask, tgt, tmask))
        index = grid_nn.build_grid(t, tm, CELL)
        fns = {
            "k2_nn": ("1nn", lambda x: nn_kernel.nearest_neighbors(x, sm, t, tm)),
            "k1_knn6": ("knn", lambda x: knn_kernel.knn(x, sm, t, tm, K)),
            "grid_build_query": ("1nn", lambda x: grid_nn.grid_nn(x, sm, t, tm, CELL)),
            "grid_query": ("1nn", lambda x: grid_nn.grid_nearest_neighbors(x, sm, index, t, tm)),
        }
        times = {}
        for name, (kind, fn) in fns.items():
            ms, all_ms = _event_ms(torch, lambda: fn(s), args.reps)
            loop_ms = _chained_ms(torch, fn, s, args.reps)
            dist = fn(s).dist.cpu().numpy()
            ref = d_ref if kind == "knn" else d1
            match = np.abs(dist - ref) < 1e-3
            if kind == "knn":
                match = match.all(axis=-1)
            row = {"backend": name, "kind": kind, "n": n, "ms": ms, "loop10_ms": loop_ms,
                   "ms_all": all_ms, "recall": float(match[ok].mean())}
            if name.startswith("grid"):
                within = ok & (d1 < RADIUS)
                row["exact_within_cell"] = float(match[within].mean())
                row["within_cell_share"] = float(within[ok].mean())
            times[name] = (ms, loop_ms)
            rows.append(row)
            print(json.dumps({k: v for k, v in row.items() if k != "ms_all"}), file=sys.stderr)
        ms, all_ms = _event_ms(torch, lambda: grid_nn.build_grid(t, tm, CELL), args.reps)
        rows.append({"backend": "grid_build", "kind": "build", "n": n, "ms": ms, "ms_all": all_ms})
        few, few_m = s[:FLOOR_SOURCES].contiguous(), sm[:FLOOR_SOURCES].contiguous()
        floor, all_ms = _event_ms(
            torch, lambda: grid_nn.grid_nearest_neighbors(few, few_m, index, t, tm), args.reps)
        rows.append({"backend": "grid_query_floor", "kind": "1nn", "n": FLOOR_SOURCES, "m": n,
                     "ms": floor, "ms_all": all_ms})
        summary.append({
            "n": n, "k2_ms": times["k2_nn"][0], "grid_query_ms": times["grid_query"][0],
            "grid_build_query_ms": times["grid_build_query"][0],
            "grid_query_over_k2": times["grid_query"][0] / times["k2_nn"][0],
            "grid_query_over_k2_loop10": times["grid_query"][1] / times["k2_nn"][1],
            "grid_build_query_over_k2": times["grid_build_query"][0] / times["k2_nn"][0],
            "grid_query_floor_ms": floor,
            "grid_query_launch_bound_share": floor / times["grid_query"][0]})
        print(json.dumps(summary[-1]), file=sys.stderr)
    out = {"card": stamp, "k": K, "cell": CELL, "radius": RADIUS, "reps": args.reps,
           "chain": CHAIN, "torch": torch.__version__, "cuda": torch.version.cuda,
           "rows": rows, "summary": summary,
           "script": "scripts/torch_bench_nn_backends.py"}
    path = Path(args.out)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(out, indent=1) + "\n")
    print(json.dumps({"card": stamp, "summary": summary, "wrote": str(path)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
