#!/usr/bin/env python3
"""Run the PyTorch/CUDA port (``mola_fe_lidar_tpu_torch``) once on one GPU.

    python3 chip_smoke.py    # build kernels, check them, replay 30 scans

Phases, each of which fails the run (non-zero exit) when it fails:

1. print the card's name and power limit (``nvidia-smi``);
2. build the CUDA kernels from ``mola_fe_lidar_tpu_torch/csrc`` and print
   the build seconds;
3. hold each kernel (K1 ``knn``, K2 ``nearest_neighbors``) against its plain
   PyTorch twin on the card, at the main path's shapes and at edge cases,
   and time both with CUDA events;
4. simulate full-resolution HDL-64 scans (131,072 rays each) and replay
   them through the port's ``run_replay`` with the KITTI preset at the
   realtime operating point on ``cuda``, with every kernel's launch count
   reset just before and read just after; check the trajectory.

The second-to-last line is ``{"kernels": [...]}`` and the last line is
``{"ok": true, "device": {...}}``. Without a CUDA card, or without the
package beside it, the script exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
ATE_BOUND_M = 0.5  # scan-rate ATE bound for the replay (metres)
N_SCANS = 30  # full-resolution HDL-64 scans in the replay


def fail(msg: str) -> int:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    return 1


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def make_cloud(gen, n: int, valid_frac: float, device):
    """Street-scale cloud: x, y in [-60, 60] m, z in [-2, 10] m; masked
    rows sit at the 1e6 padding position, as the filters leave them."""
    import torch
    xyz = torch.rand((n, 3), generator=gen) * torch.tensor([120.0, 120.0, 12.0]) \
        - torch.tensor([60.0, 60.0, 2.0])
    mask = (torch.rand((n,), generator=gen) < valid_frac).float()
    xyz = torch.where(mask[:, None] > 0.5, xyz, torch.full_like(xyz, 1e6))
    return xyz.to(device).contiguous(), mask.to(device).contiguous()


def compare(kernel_out, plain_out):
    """(max |dist| error over valid slots, index mismatches not explained by
    equal distances)."""
    import torch
    dk, dp = kernel_out.dist.float(), plain_out.dist.float()
    err = float((dk - dp).abs().max()) if dk.numel() else 0.0
    bad = kernel_out.idx != plain_out.idx
    unexplained = int((bad & (dk != dp)).sum())
    return err, unexplained


def check_kernels(device):
    """Phase 3. Returns the kernel rows of the final JSON line."""
    import torch
    from mola_fe_lidar_tpu_torch.ops import knn_kernel, matching, nn_kernel

    gen = torch.Generator().manual_seed(0)
    rows = []
    # (kind, k, n sources, m targets, what the main path uses it for)
    main_shapes = [
        ("knn", 4, 8192, 32768, "candidate refresh: decimated -> planes map"),
        ("knn", 8, 2048, 8192, "candidate refresh: edges -> edges map"),
        ("knn", 5, 2048, 8192, "point-to-line pairing for the covariance"),
        ("knn", 5, 2048, 2048, "scan-to-scan point-to-line"),
        ("nn", 1, 1024, 32768, "paired-ratio quality"),
        ("nn", 1, 8192, 32768, "point-to-plane pairing for the covariance"),
        ("nn", 1, 8192, 8192, "scan-to-scan point-to-plane"),
    ]
    tol = 1e-5  # metres: bit-identical is expected; see compare()
    per_kernel = {"knn": [], "nn": []}
    for kind, k, n, m, what in main_shapes:
        src, sm = make_cloud(gen, n, 0.95, device)
        tgt, tm = make_cloud(gen, m, 0.9, device)
        if kind == "knn":
            kern = lambda: knn_kernel.knn(src, sm, tgt, tm, k)
            plain = lambda: matching.knn(src, sm, tgt, tm, k)
        else:
            kern = lambda: nn_kernel.nearest_neighbors(src, sm, tgt, tm)
            plain = lambda: matching.nearest_neighbors(src, sm, tgt, tm)
        out_k, out_p = kern(), plain()
        torch.cuda.synchronize()
        err, unexplained = compare(out_k, out_p)
        ms = cuda_ms(kern, reps=20)
        plain_ms = cuda_ms(plain, reps=3, warmup=1)
        print(f"{kind} k={k} {n}x{m} ({what}): max|ddist|={err:.3g} m, "
              f"unexplained idx diffs={unexplained}, kernel {ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms")
        if err > tol or unexplained:
            raise AssertionError(f"{kind} k={k} {n}x{m} disagrees with its twin")
        per_kernel[kind].append((n, m, k, err, ms, plain_ms))

    # edge cases: masked sources/targets, M not a multiple of the tile,
    # fewer valid targets than k, duplicate points, every supported k
    edge = []
    src, sm = make_cloud(gen, 300, 0.8, device)
    for m in (1, 7, 1000, 1500, 5000):
        tgt, tm = make_cloud(gen, m, 0.7, device)
        tm[0] = 1.0
        tgt[0] = torch.tensor([1.0, 2.0, 3.0], device=device)
        for k in knn_kernel.SUPPORTED_K:
            edge.append(("knn", k, src, sm, tgt, tm))
        edge.append(("nn", 1, src, sm, tgt, tm))
    dup = torch.tensor([[0.1, 0.0, 0.0]] * 6 + [[9.0, 9.0, 9.0]] * 20, device=device)
    edge.append(("knn", 4, torch.zeros((5, 3), device=device),
                 torch.ones(5, device=device), dup, torch.ones(26, device=device)))
    for kind, k, s, smk, t, tmk in edge:
        if kind == "knn":
            a, b = knn_kernel.knn(s, smk, t, tmk, k), matching.knn(s, smk, t, tmk, k)
        else:
            a = nn_kernel.nearest_neighbors(s, smk, t, tmk)
            b = matching.nearest_neighbors(s, smk, t, tmk)
        torch.cuda.synchronize()
        err, unexplained = compare(a, b)
        if err > tol or unexplained or not torch.equal(a.idx, b.idx):
            raise AssertionError(f"edge case {kind} k={k} m={t.shape[0]} disagrees")
    print(f"edge cases: {len(edge)} kernel calls agree with the twins")

    for name, key, source, replaces in (
            ("knn", "knn", "mola_fe_lidar_tpu_torch/csrc/knn.cu",
             "mola_fe_lidar_tpu/ops/pallas_knn.py:47"),
            ("nearest_neighbors", "nn", "mola_fe_lidar_tpu_torch/csrc/nn.cu",
             "mola_fe_lidar_tpu/ops/pallas_nn.py:35")):
        runs = per_kernel[key]
        # the headline shape of each kernel is its largest main-path call
        n, m, k, _, ms, plain_ms = max(runs, key=lambda r: r[0] * r[1])
        rows.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces, "shape": f"{n}x{m} k={k}",
                     "max_abs_err": max(r[3] for r in runs),
                     "ms": ms, "plain_ms": plain_ms})
    return rows


def replay(device):
    """Phase 4: the port's main path. Returns the launch counts."""
    import numpy as np
    import torch
    from mola_fe_lidar_tpu_torch.obs.hdl64 import hdl64_sequence
    from mola_fe_lidar_tpu_torch.obs.runner import realtime_config, run_replay
    from mola_fe_lidar_tpu_torch.ops import knn_kernel, nn_kernel

    t0 = time.perf_counter()
    obs, gt = hdl64_sequence(n_scans=N_SCANS, n_azimuth=2048)
    print(f"simulated {N_SCANS} HDL-64 scans ({len(obs[0]['xyz'])} rays each) "
          f"in {time.perf_counter() - t0:.1f} s")
    cfg = realtime_config()
    torch.cuda.reset_peak_memory_stats(device)
    knn_kernel.launches = 0
    nn_kernel.launches = 0
    res = run_replay(obs, cfg, gt_poses=gt, device=device)
    counts = {"knn": knn_kernel.launches, "nearest_neighbors": nn_kernel.launches}
    peak_mib = torch.cuda.max_memory_allocated(device) / 2**20
    module = res["module"]
    try:
        layers = module.state.last_points
        for name, pc in layers.items():
            if pc.xyz.device.type != "cuda":
                raise AssertionError(f"layer {name} is on {pc.xyz.device}")
        ate = res.get("ate_rmse_scan")
        sps = res.get("scans_per_sec_steady")
        print(f"replay: {res['n_scans']} scans, {res['n_keyframes']} keyframes, "
              f"{res['n_factors']} factors, jobs_abandoned={res['jobs_abandoned']}, "
              f"wall {res['wall_s']:.2f} s, peak device memory {peak_mib:.1f} MiB")
        print(f"scan ATE {ate} m (bound {ATE_BOUND_M} m), steady {sps} scans/s"
              + (f" = {1e3 / sps:.1f} ms/scan" if sps else ""))
        stats = module.profiler.stats()
        for key in ("doProcess.fused_step", "doProcess.generators",
                    "doProcess.local_map_build"):
            if key in stats:
                s = stats[key]
                print(f"  {key}: n={s['count']} mean {s['mean_s'] * 1e3:.2f} ms "
                      f"max {s['max_s'] * 1e3:.2f} ms")
        print(f"launch counts during the replay: {counts}")
        if res["jobs_abandoned"] != 0:
            raise AssertionError("jobs abandoned")
        if res["n_keyframes"] < 3:
            raise AssertionError(f"only {res['n_keyframes']} keyframes")
        if ate is None or not np.isfinite(ate) or ate > ATE_BOUND_M:
            raise AssertionError(f"scan ATE {ate} outside the bound {ATE_BOUND_M} m")
        for name, c in counts.items():
            if c <= 0:
                raise AssertionError(f"kernel {name} was not launched by the replay")
    finally:
        module.shutdown()
    return counts


def main() -> int:
    if not (REPO / "mola_fe_lidar_tpu_torch" / "csrc").is_dir():
        return fail(f"the port (mola_fe_lidar_tpu_torch) is not beside {__file__}")
    import torch
    if not torch.cuda.is_available():
        return fail("torch.cuda.is_available() is false: this script needs a CUDA card")
    sys.path.insert(0, str(REPO))
    device = torch.device("cuda", 0)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0])
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")

    from mola_fe_lidar_tpu_torch.ops import cuda_build
    t0 = time.perf_counter()
    cuda_build.library()
    print(f"kernels built in {time.perf_counter() - t0:.1f} s "
          f"(nvcc {cuda_build.build_seconds:.1f} s)")
    for line in cuda_build.build_log.splitlines():
        if "Used" in line or "spill" in line:
            print("  ptxas:", line.strip())

    rows = check_kernels(device)
    counts = replay(device)
    for row in rows:
        row["launches"] = counts[row["name"]]
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
