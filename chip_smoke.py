#!/usr/bin/env python3
"""Run the PyTorch/CUDA port (``mola_fe_lidar_tpu_torch``) once on one GPU.

    python3 chip_smoke.py    # build kernels, check them, replay, align scan pairs

Phases, each of which fails the run (non-zero exit) when it fails:

1. print the card's name and power limit (``nvidia-smi``);
2. build the CUDA kernels from ``mola_fe_lidar_tpu_torch/csrc`` and print
   the build seconds and the ``ptxas`` registers and spills of every
   instantiation (a spill fails the run);
3. hold each kernel (K1 ``knn``, K2 ``nearest_neighbors``) bit for bit
   against its plain PyTorch twin on the card, at the main path's shapes,
   at K1's other list lengths (``NEW_KS``: lengths routed to a longer
   compiled one and the shared-memory lists 32, 64, 128) at 2048 x 8192,
   at edge cases and at every compiled launch plan; per main-path shape,
   print its launch plan (blocks, cluster, R, and the warps on the busiest
   SM from the runtime's occupancy query) and time it: ``ms`` (CUDA events over 20 eager
   calls), ``graph_ms`` (a CUDA graph of 20 calls, no host gaps),
   ``host_us`` (the wrapper's host time a call), ``bound_ms`` (8 f32
   operations a pair at 67 TFLOP/s) and its share, ``library_ms``
   (``torch.cdist`` + ``topk`` / ``min``, a yardstick the port never calls)
   and ``plain_ms`` (the twin);
4. simulate full-resolution HDL-64 scans (131,072 rays each) and replay
   them through the port's ``run_replay`` with the KITTI preset at the
   realtime operating point on ``cuda`` -- the pipelined scan step (the
   reference's default) and the preset's nearby-keyframe window -- with
   every kernel's launch count (in all and per shape) reset just before and
   read just after; check the trajectory, that nearby batches ran and that
   the pipeline prefetched all but 3 scans and never switched itself off;
   then :func:`scan_step_forms`: the same scans with the serial one-
   dispatch step (steady scans/s and readback wait beside the pipelined
   ones), ``warm_start`` on the replay's module, and the first 12 scans
   through the default step and each other form of it (in-loop deskew, the
   sort map build,
   the host map with the two-view transient filter, the asynchronous
   rebuild, the unfused step, the motion-conditional candidate refresh),
   each with an ATE bound and a proof that its path ran; and
   :func:`checkpoint_round_trip`: a checkpoint after scan 15 loaded into a
   fresh module on the card, its keyframe clouds and pose
   graph equal to the saved ones, two more scans resumed;
5. replay the same scans with loop-closure candidates from 3 keyframes
   back (``min_topo_dist_to_consider_loopclosure=3``), so that full-width
   Monte-Carlo batches (10 lanes against a +-3-keyframe submap) run, with
   the counts reset and read around it; check that loop-closure checks ran;
   then optimize that replay's pose graph (:func:`pgo`, the back-end's
   Levenberg-Marquardt without and with the Cauchy kernel) and bound its
   keyframe ATE; then :func:`accuracy_tools`: the accuracy harness's
   loop-closure ablation and false-loop-closure study on that graph, with
   bounds, its PLY export and the runner CLI with ``--profile --viz-out``;
6. the pairwise-registration path (:func:`pairwise`): the reference
   runner's quickstart configuration (``DEFAULT_CFG``: voxel downsample,
   point-to-point Horn, kNN = 6 point-to-plane) replayed over 40 synthetic
   circle scans of 8192 points, with an ATE bound; bench.py's 64 scan pairs
   of 2048 points as one batch through coarse-to-fine with kNN normals,
   ``icp_settings_regular`` (kNN = 6 with the scale-outlier gate), the same
   with Anderson acceleration (``anderson_m=5``),
   point-to-point Horn and robust Cauchy on pairs with 20 % outliers, each
   with pairs/s, the accepted share and the largest accepted pose error
   against bounds; one GICP align of two 8192-point clouds (K1 at k = 10
   for the covariances), with a pose-error bound;
7. the map localizer (:func:`localizer`): a 131,072-point map of the
   replay's keyframes, four gated localize queries (the multi-start
   rival-basin gate: a 10-lane probe batch against the shared map), each
   timed, at least 2 accepted and every accepted one within 0.5 m; an
   adversarial query from 6 m off, which must be rejected; ``localize_raw``
   against 32,768- and 131,072-point maps, timed;
8. hold every batched shape those phases launched (``launches_by_shape``
   keys with B > 1), and the localizer's unbatched searches, bit for bit
   against the twin and a batch against B unbatched launches, once with
   every operand per lane and once with the target and the source mask
   shared by all lanes (stride-0 expands), and time it as in phase 3 (the
   bound counts B * n * m pairs);
9. the voxel-hash grid and the native runtime (:func:`grid_and_native`):
   the grid's 1-NN (``ops/grid_nn.py``, plain PyTorch, not a kernel) at
   8192 x 32768 and 4096 x 131,072, bit for bit against the same function
   on the CPU and against K2 wherever the true neighbour lies within the
   cell (a difference only where that neighbour was dropped from a full
   bucket), both timed; the 64 pairs through ``icp_settings_regular`` with
   target normals on its 1-NN matcher (``point2plane_normals``), with
   ``nn_backend: grid`` and with K2 (pairs/s, accepted share and pose
   bound; the kNN preset's matcher stays on K1 under ``grid``); 12 scans
   with ``local_map_nn_backend=grid`` (ATE bound, the grid queried); the
   replay's pose graph a ``NativePoseGraph`` (``native/``, built with
   ``g++``) and ``kitti_read_bin_native`` byte-equal to ``obs/kitti.py``'s
   reader on a written ``.bin``.

The second-to-last line is ``{"kernels": [...]}`` (one row per kernel at
its largest main-path shape, with every shape, batched ones included,
under ``shapes``) and the last line is
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
ATE_BOUND_M = 0.5  # scan-rate ATE bound for the replays (metres)
# the kernels' bound: 8 f32 operations a (source, target) pair (3 sub, 3 mul,
# 2 add) at the H100 SXM's 67 TFLOP/s f32 peak (NVIDIA data sheet, 700 W)
FLOP_PER_PAIR = 8
F32_PEAK_FLOPS = 67e12
N_SCANS = 30  # full-resolution HDL-64 scans in each replay
VARIANT_SCANS = 12  # scans through each other form of the scan step
CKPT_SCAN = 15  # scans before the checkpoint
LC_TOPO = 3  # keyframes back from which the loop-closure phase looks
# the accuracy studies on the loop-closure replay: the Cauchy-optimized ATE
# with one injected false loop closure within 10 % of the clean one, the
# plain least-squares one more than 5 times it
FALSE_LC_ROBUST_TOL = 0.10
FALSE_LC_PLAIN_FACTOR = 5.0
CLI_SCANS = 5  # quickstart scans through the runner CLI
# the mesh phase: positions on the card, the map align's searches split over
# P positions ((kind, k, sources, targets): the planes map, the edges map),
# timed as the median of MESH_REPS calls; the sharded aligns' bounds against
# the single-device align without the candidate cache
MESH_POSITIONS = 4
MESH_PS = (2, 4)
MESH_SEARCHES = (("nn", 1, 8192, 32768), ("knn", 4, 8192, 32768), ("knn", 5, 8192, 32768),
                 ("knn", 5, 2048, 8192))
MESH_REPS = 7
MESH_POSE_TOL_M = 1e-4
MESH_QUALITY_TOL = 1e-5
# each form of the scan step beside the default, and the proof its path ran
VARIANTS = (
    ("default (pipelined)", ()),
    ("in-loop deskew", ("deskew_in_loop=true",)),
    ("sort map build", ("local_map_build_mode=sort",)),
    ("host map, two views", ("local_map_device_build=false", "local_map_min_views=2")),
    ("asynchronous map rebuild", ("local_map_async_build=true",)),
    ("unfused step", ("fused_scan_step=false",)),
    ("motion-conditional refresh", ("local_map_cand_motion_trans=0.02",
                                    "local_map_cand_motion_rot=0.004")),
)
# the pairwise-registration phase: the reference runner's quickstart replay
# (DEFAULT_CFG, synthetic circle, 8192-point scans), bench.py's 64 scan
# pairs of 2048 points (seed 7) as one batch, one GICP align of 8192 points
QUICK_SCANS = 40
PAIRS, PAIR_CAP, PAIR_SEED = 64, 2048, 7
PAIR_REPS = 2  # timed batches a configuration, after one warm-up
GICP_POINTS = 8192
# Bounds, several times what an NVIDIA H100 80GB HBM3 (700 W) measured
# (PERF.md), to catch breakage: the quickstart's scan ATE (0.034 m),
# each pair configuration's (least accepted share, largest accepted pose
# error in m) -- accepted 1.0 / 1.0 / 1.0 / 0.984 with 1e-5, 0.0084,
# 0.028 and 0.033 m -- and the GICP pose error (2e-6 m)
QUICK_ATE_BOUND_M = 0.2
PAIR_BOUNDS = {"c2f": (0.9, 0.001), "regular": (0.9, 0.05), "anderson": (0.9, 0.05),
               "horn": (0.9, 0.15), "robust": (0.9, 0.15)}
GICP_ERR_BOUND_M = 0.001
# the localizer phase (scripts/bench_localize_tp.py's recipe): keyframes
# every 4 scans, four held-out queries from a prior of 0.5 m / 2 degrees
# (seed 11), each timed over LOC_REPS calls after a warm one; at least 2
# accepted, each within LOC_ERR_BOUND_M; the adversarial query from 6 m
LOC_KF_EVERY = 4
LOC_QUERIES = (2, 10, 18, 26)
LOC_SEED = 11
LOC_REPS = 3
LOC_ERR_BOUND_M = 0.5
LOC_ADVERSARIAL_M = 6.0
# the grid phase: (sources, targets) of the grid's 1-NN against K2, its
# cell (scripts/torch_bench_nn_backends.py's), the timed calls a shape
GRID_SHAPES = ((8192, 32768), (4096, 1 << 17))
GRID_CELL = 1.0
GRID_REPS = 10


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
    """(max |dist| error, bit-identical dist and idx)."""
    import torch
    dk, dp = kernel_out.dist, plain_out.dist
    err = float((dk - dp).abs().max()) if dk.numel() else 0.0
    same = torch.equal(dk, dp) and torch.equal(kernel_out.idx, plain_out.idx)
    return err, same


def graph_ms(fn, reps: int = 20, replays: int = 5) -> float:
    """Device time per call from replaying a CUDA graph that holds ``reps``
    calls: no host gaps between the launches."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()  # warm-up on the capture stream
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / (reps * replays)


def host_us(fn, reps: int = 200) -> float:
    """Median host time of one wrapper call (enqueue only, no sync)."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    return sorted(times)[reps // 2] * 1e6


def ptxas_report(log: str):
    """(per-instantiation lines, spilling instantiations) from ``-Xptxas -v``."""
    import re
    lines, spills, current = [], [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            t = re.search(r"knn_searchILi(\d+)ELi(\d+)E", m.group(1))
            sh = re.search(r"knn_search_sharedILi(\d+)E", m.group(1))
            current = (f"K={t.group(1)} R={t.group(2)}" if t
                       else f"K={sh.group(1)} R=1 shared" if sh else m.group(1))
        elif line.startswith("== "):
            current = line[3:]
        elif current and "spill" in line:
            nums = [int(x) for x in re.findall(r"(\d+) bytes spill", line)]
            lines.append(f"{current}: {line.split(':', 1)[-1].strip()}")
            if any(nums):
                spills.append(current)
        elif current and "Used" in line:
            lines.append(f"{current}: {line.split(':', 1)[-1].strip()}")
    return lines, spills


def tie_cloud(gen, n: int, extent: int, device):
    """Points on an integer grid in a small box: squared distances are exact
    integers, so equal distances straddle every part and cluster-rank
    boundary of any plan."""
    import torch
    xyz = torch.randint(-extent, extent + 1, (n, 3), generator=gen).float()
    mask = (torch.rand((n,), generator=gen) < 0.9).float()
    xyz = torch.where(mask[:, None] > 0.5, xyz, torch.full_like(xyz, 1e6))
    return xyz.to(device).contiguous(), mask.to(device).contiguous()


#: K1's list lengths beyond the main path's, each held to the twin at
#: 2048 x 8192 and in the edge cases (fewer valid targets than k)
NEW_KS = (2, 3, 7, 9, 12, 17, 32, 33, 64, 100, 128)
#: beside every compiled list length, the plan battery checks a length
#: routed to a register list (3 -> 4) and one routed to a shared-memory
#: list (100 -> 128)
PLAN_ROUTED_KS = (3, 100)


def check_plans(device, ks=None) -> int:
    """Every compiled R at every cluster size and two staging budgets,
    forced through ``knn_kernel.launch``, and the wrappers with their own
    plans, bit for bit against the twins: tie-heavy clouds with n not a
    multiple of any tile, m below one part and m = 1, all targets masked,
    and a staging budget small enough to stream a part in chunks. A routed
    length launches its compiled one and keeps the first k columns. ``ks``:
    the list lengths to check (default: every compiled one and
    ``PLAN_ROUTED_KS``). Returns the number of
    forced launches checked."""
    import torch
    from mola_fe_lidar_tpu_torch.ops import knn_kernel, matching, nn_kernel

    gen = torch.Generator().manual_seed(1)
    s, sm = tie_cloud(gen, 777, 3, device)
    clouds = [("ties", *tie_cloud(gen, 2500, 3, device))]
    clouds.append(("m=37", *tie_cloud(gen, 37, 3, device)))
    clouds.append(("m=1", torch.tensor([[1.0, 0.0, 0.0]], device=device),
                   torch.ones(1, device=device)))
    clouds.append(("all masked", tie_cloud(gen, 700, 3, device)[0],
                   torch.zeros(700, device=device)))
    checked = 0
    for label, t, tm in clouds:
        n, m = s.shape[0], t.shape[0]
        for k in ks or knn_kernel.COMPILED_K + PLAN_ROUTED_KS:
            kc = knn_kernel.compiled_k(k)
            want = matching.knn(s, sm, t, tm, k)
            wants = [((n, kc), want, knn_kernel.knn(s, sm, t, tm, k))]
            if k == 1:  # K2's own entry point as well
                want1 = matching.nearest_neighbors(s, sm, t, tm)
                wants.append(((n,), want1, nn_kernel.nearest_neighbors(s, sm, t, tm)))
            for dims, want, wrapped in wants:
                if not compare(wrapped, want)[1]:
                    raise AssertionError(f"{label}: k={k} wrapper {dims} disagrees with the twin")
                for r in knn_kernel.rows_for(k):
                    for c in knn_kernel.CLUSTERS:
                        for stage in (knn_kernel.STAGE_TARGETS, 64):
                            plan = knn_kernel.make_plan(n, m, k, r, c, stage)
                            dist = torch.full(dims, -1.0, device=device)
                            idx = torch.full(dims, -1, dtype=torch.int32, device=device)
                            knn_kernel.launch(s, sm, t, tm, kc if len(dims) > 1 else 1,
                                              plan, dist, idx)
                            torch.cuda.synchronize()
                            if len(dims) > 1:
                                dist, idx = dist[:, :k], idx[:, :k]
                            if not (torch.equal(dist, want.dist) and torch.equal(idx, want.idx)):
                                raise AssertionError(
                                    f"{label}: k={k} {dims} {plan} disagrees with the twin")
                            checked += 1
    return checked


def check_kernels(device):
    """Phase 3. Returns the kernel rows of the final JSON line."""
    import torch
    from mola_fe_lidar_tpu_torch.ops import cuda_build, knn_kernel, matching, nn_kernel

    gen = torch.Generator().manual_seed(0)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    lib = cuda_build.library()
    # (kind, k, n sources, m targets, what the main path uses it for)
    main_shapes = [
        ("knn", 4, 8192, 32768, "candidate refresh: decimated -> planes map"),
        ("knn", 8, 2048, 8192, "candidate refresh: edges -> edges map"),
        ("knn", 5, 2048, 8192, "point-to-line pairing for the covariance"),
        ("knn", 5, 2048, 2048, "scan-to-scan point-to-line"),
        ("nn", 1, 1024, 32768, "paired-ratio quality"),
        ("nn", 1, 8192, 32768, "point-to-plane pairing for the covariance"),
        ("nn", 1, 8192, 8192, "scan-to-scan point-to-plane"),
        ("knn", 6, 8192, 8192, "point2plane_knn pairing (quickstart replay)"),
        ("knn", 10, 8192, 8192, "GICP covariances (self-kNN)"),
    ] + [("knn", k, 2048, 8192, f"list length {k} (runs at {knn_kernel.compiled_k(k)})")
         for k in NEW_KS]
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
        # the same exact function in library calls, on the parked clouds
        sp, tp = matching._prepare(src, sm, tgt, tm)
        if kind == "knn":
            library = lambda: torch.topk(torch.cdist(
                sp, tp, compute_mode="donot_use_mm_for_euclid_dist"), k, dim=1, largest=False)
        else:
            library = lambda: torch.cdist(
                sp, tp, compute_mode="donot_use_mm_for_euclid_dist").min(dim=1)
        out_k, out_p = kern(), plain()
        torch.cuda.synchronize()
        err, same = compare(out_k, out_p)
        plan = knn_kernel.cached_plan(device, n, m, k)
        clusters = lib.mola_knn_max_active_clusters(knn_kernel.compiled_k(k), plan.rows,
                                                    plan.cluster, plan.smem)
        per_sm = max(1, clusters * plan.cluster // sms) if clusters > 0 else 0
        warps = 4 * min(-(-plan.blocks // sms), per_sm)
        row = {"kind": kind, "n": n, "m": m, "k": k, "use": what, "max_abs_err": err,
               "ms": cuda_ms(kern, reps=20), "graph_ms": graph_ms(kern),
               "host_us": host_us(kern),
               "bound_ms": n * m * FLOP_PER_PAIR / F32_PEAK_FLOPS * 1e3,
               "library_ms": cuda_ms(library, reps=5, warmup=1),
               "plain_ms": cuda_ms(plain, reps=3, warmup=1)}
        row["bound_share"] = row["bound_ms"] / row["ms"]
        print(f"{kind} k={k} {n}x{m} ({what}): max|ddist|={err:.3g} m, bit-identical={same}; "
              f"kernel {row['ms']:.4f} ms, graph {row['graph_ms']:.4f} ms, "
              f"host {row['host_us']:.1f} us, bound {row['bound_ms']:.4f} ms "
              f"({100 * row['bound_share']:.1f} %), library {row['library_ms']:.4f} ms, "
              f"plain {row['plain_ms']:.4f} ms")
        print(f"  launch: {plan.blocks} blocks, cluster {plan.cluster}, R={plan.rows}, "
              f"{plan.parts} parts of {plan.part_len}, "
              f"{plan.smem} B shared, {clusters} clusters resident, "
              f"{warps} warps on the busiest SM")
        if not same:
            raise AssertionError(f"{kind} k={k} {n}x{m} is not bit-identical to its twin")
        per_kernel[kind].append(row)

    # edge cases through the wrappers: masked sources/targets, M not a
    # multiple of the tile, fewer valid targets than k, duplicates
    edge = []
    src, sm = make_cloud(gen, 300, 0.8, device)
    for m in (1, 7, 1000, 1500, 5000):
        tgt, tm = make_cloud(gen, m, 0.7, device)
        tm[0] = 1.0
        tgt[0] = torch.tensor([1.0, 2.0, 3.0], device=device)
        for k in sorted(set(knn_kernel.COMPILED_K + NEW_KS)):
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
        if not compare(a, b)[1]:
            raise AssertionError(f"edge case {kind} k={k} m={t.shape[0]} disagrees")
    print(f"edge cases: {len(edge)} wrapper calls bit-identical to the twins")
    print(f"plan battery: {check_plans(device)} forced-plan launches bit-identical "
          f"to the twins")

    rows = []
    for name, key, source, replaces in (
            ("knn", "knn", "mola_fe_lidar_tpu_torch/csrc/knn.cu",
             "mola_fe_lidar_tpu/ops/pallas_knn.py:47"),
            ("nearest_neighbors", "nn", "mola_fe_lidar_tpu_torch/csrc/nn.cu",
             "mola_fe_lidar_tpu/ops/pallas_nn.py:35")):
        runs = per_kernel[key]
        # the headline shape of each kernel is its largest main-path call
        top = max(runs, key=lambda r: r["n"] * r["m"])
        rows.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces, "shape": f"{top['n']}x{top['m']} k={top['k']}",
                     "max_abs_err": max(r["max_abs_err"] for r in runs),
                     **{f: top[f] for f in ("ms", "graph_ms", "host_us", "plain_ms",
                                            "bound_ms", "bound_share", "library_ms")},
                     "bound_by": "operations", "shapes": runs})
    return rows


def _reset_counts():
    from mola_fe_lidar_tpu_torch.ops import knn_kernel, nn_kernel
    for mod in (knn_kernel, nn_kernel):
        mod.launches = 0
        mod.launches_by_shape.clear()


def _read_counts():
    from mola_fe_lidar_tpu_torch.ops import knn_kernel, nn_kernel
    return ({"knn": knn_kernel.launches, "nearest_neighbors": nn_kernel.launches},
            {"knn": dict(knn_kernel.launches_by_shape),
             "nearest_neighbors": dict(nn_kernel.launches_by_shape)})


def _span(stats, key):
    """(count, mean ms, total s) of a profiler span, zeros if it never ran."""
    s = stats.get(key)
    return (s["count"], s["mean_s"] * 1e3, s["total_s"]) if s else (0, 0.0, 0.0)


def run_phase(device, obs, gt, cfg, label, ate_bound=ATE_BOUND_M, pgo=False):
    """One replay of ``obs`` on ``device`` with the counts reset just before
    and read just after. Returns (result, counts, counts per shape, stats)."""
    import numpy as np
    import torch
    from mola_fe_lidar_tpu_torch.obs.runner import run_replay

    torch.cuda.reset_peak_memory_stats(device)
    _reset_counts()
    res = run_replay(obs, cfg, gt_poses=gt, device=device, pgo=pgo)
    counts, by_shape = _read_counts()
    peak_mib = torch.cuda.max_memory_allocated(device) / 2**20
    module = res["module"]
    try:
        for name, pc in module.state.last_points.items():
            if pc.xyz.device.type != torch.device(device).type:
                raise AssertionError(f"layer {name} is on {pc.xyz.device}")
        ate = res.get("ate_rmse_scan")
        sps = res.get("scans_per_sec_steady")
        print(f"{label}: {res['n_scans']} scans, {res['n_keyframes']} keyframes, "
              f"{res['n_factors']} factors ({res['n_nearby_edges']} nearby edges, "
              f"{res['n_loop_closures']} loop closures), jobs_abandoned={res['jobs_abandoned']}, "
              f"wall {res['wall_s']:.2f} s, peak device memory {peak_mib:.1f} MiB")
        print(f"  scan ATE {ate} m (bound {ate_bound} m), steady {sps} scans/s"
              + (f" = {1e3 / sps:.1f} ms/scan" if sps else ""))
        stats = module.profiler.stats()
        _, _, scan_total = _span(stats, "doProcessNewObservation")
        for key in ("doProcessNewObservation", "doProcess.fused_step", "doProcess.generators",
                    "doProcess.prefetch_ingest", "doProcess.align_dispatch",
                    "doProcess.readback_wait", "doProcess.filter", "run_one_icp.icp_latest",
                    "doProcess.local_map_build", "doProcess.local_map_build_async",
                    "checkNonAdjacent.nearby_batch_align", "checkNonAdjacent.lc_batch_align"):
            n, mean_ms, total = _span(stats, key)
            if n:
                print(f"  {key}: n={n} mean {mean_ms:.2f} ms total {total:.3f} s"
                      f" ({100 * total / max(scan_total, 1e-9):.1f} % of the scans' time)")
        for kind in ("nearby", "lc"):
            acc = stats.get(f"counter:checkNonAdjacent.{kind}.accepted")
            good = stats.get(f"counter:checkNonAdjacent.{kind}.goodness")
            if acc:
                print(f"  {kind} checks: {acc['count']}, accepted {acc['total']:.0f}, goodness "
                      f"mean {good['mean']:.4f} min {good['min']:.4f} max {good['max']:.4f}")
        print(f"  launch counts: {counts}")
        for name, shapes in by_shape.items():
            for (b, n, m, k), c in sorted(shapes.items()):
                print(f"    {name} B={b} {n}x{m} k={k}: {c} launches, "
                      f"{c / res['n_scans']:.3f} per scan")
        if res["jobs_abandoned"] != 0:
            raise AssertionError("jobs abandoned")
        if res["n_keyframes"] < 3:
            raise AssertionError(f"only {res['n_keyframes']} keyframes")
        if ate is None or not np.isfinite(ate) or ate > ate_bound:
            raise AssertionError(f"scan ATE {ate} outside the bound {ate_bound} m")
        for name, c in counts.items():
            if c <= 0:
                raise AssertionError(f"kernel {name} was not launched by the {label}")
    finally:
        module.shutdown()
    return res, counts, by_shape, stats


def replay(device, obs, gt):
    """Phase 4: the port's main path (the pipelined scan step) with the
    preset's nearby window."""
    from mola_fe_lidar_tpu_torch.obs.runner import realtime_config

    res, counts, by_shape, stats = run_phase(device, obs, gt, realtime_config(), "replay")
    if stats.get("counter:checkNonAdjacent.nearby.accepted", {}).get("count", 0) < 1:
        raise AssertionError("no nearby check ran in the replay")
    if not any(b > 1 for shapes in by_shape.values() for b, *_ in shapes):
        raise AssertionError("no batched launch in the replay")
    prefetched = _span(stats, "doProcess.prefetch_ingest")[0]
    disabled = stats.get("counter:doProcess.prefetch_disabled", {}).get("total", 0)
    print(f"  pipelined step: {prefetched} of {len(obs)} scans prefetched, "
          f"prefetch_disabled={disabled}, pipelined_ok={res['module']._pipelined_ok}")
    # the first scan aligns nothing, the last has nothing to prefetch, and
    # the warm-up barrier empties the queue once
    if prefetched < len(obs) - 3 or disabled or not res["module"]._pipelined_ok:
        raise AssertionError(f"the pipelined step prefetched {prefetched} of {len(obs)} scans "
                             f"(prefetch_disabled={disabled})")
    return res, counts, by_shape, stats


def _rate(res, stats):
    """(steady scans/s, mean readback wait ms)."""
    return res["scans_per_sec_steady"], _span(stats, "doProcess.readback_wait")[1]


def scan_step_forms(device, obs, gt, main_res, main_stats):
    """Phase 4, continued: the serial one-dispatch step over the same scans
    beside the pipelined one, ``warm_start`` on the replay's module, and the
    first VARIANT_SCANS scans through the default and each other form of
    the scan step."""
    from mola_fe_lidar_tpu_torch.frontend.local_map import LocalMap
    from mola_fe_lidar_tpu_torch.models.config import AlignKind
    from mola_fe_lidar_tpu_torch.obs.runner import REALTIME, build_config

    cfg = build_config(overrides=REALTIME + ("pipelined_scan_step=false",))
    res, _, _, stats = run_phase(device, obs, gt, cfg, "serial replay (pipelined_scan_step=false)")
    if _span(stats, "doProcess.prefetch_ingest")[0]:
        raise AssertionError("the serial step prefetched")
    (p_sps, p_wait), (s_sps, s_wait) = _rate(main_res, main_stats), _rate(res, stats)
    print(f"serial vs pipelined: steady {s_sps} vs {p_sps} scans/s, readback_wait "
          f"{s_wait:.2f} vs {p_wait:.2f} ms, prefetched "
          f"{_span(main_stats, 'doProcess.prefetch_ingest')[0]} of {len(obs)} scans")
    warm_s = main_res["module"].warm_start(obs[0])
    print(f"warm_start on the replay's module: {warm_s:.3f} s")

    proofs = {
        "default (pipelined)": lambda m, st: _span(
            st, "doProcess.prefetch_ingest")[0] >= VARIANT_SCANS - 3,
        "in-loop deskew": lambda m, st: st.get(
            "counter:doProcess.deskew_refine_rounds", {}).get("count", 0) >= 1,
        "sort map build": lambda m, st: (m._local_map_builder.mode == "sort"
                                         and _span(st, "doProcess.local_map_build")[0] >= 1),
        "host map, two views": lambda m, st: isinstance(m._local_map_builder, LocalMap),
        "asynchronous map rebuild": lambda m, st: _span(
            st, "doProcess.local_map_build_async")[0] >= 1,
        "unfused step": lambda m, st: (_span(st, "doProcess.fused_step")[0] == 0
                                       and _span(st, "run_one_icp.icp_latest")[0] >= 1),
        "motion-conditional refresh": lambda m, st: all(
            s.cand_refresh_min_trans == 0.02 for s in m._stages_for(AlignKind.LIDAR_ODOMETRY, True)),
    }
    for label, overrides in VARIANTS:
        cfg = build_config(overrides=REALTIME + overrides)
        res, _, _, stats = run_phase(device, obs[:VARIANT_SCANS], gt[:VARIANT_SCANS], cfg,
                                     f"variant: {label} ({', '.join(overrides) or 'realtime'})")
        if not proofs[label](res["module"], stats):
            raise AssertionError(f"variant {label}: its path did not run")
        print(f"variant {label}: steady {res['scans_per_sec_steady']} scans/s, "
              f"scan ATE {res['ate_rmse_scan']} m")


def checkpoint_round_trip(device, obs):
    """Phase 4, continued: a checkpoint after CKPT_SCAN scans, loaded into a
    fresh module on the card; its keyframe clouds and pose graph must equal
    the saved ones, and it resumes two more scans."""
    import tempfile

    import numpy as np
    import torch
    from mola_fe_lidar_tpu_torch.frontend.checkpoint import load_checkpoint, save_checkpoint
    from mola_fe_lidar_tpu_torch.frontend.worldmodel import ANNOTATION_NAME_PC_LAYERS
    from mola_fe_lidar_tpu_torch.obs.runner import build_module, realtime_config

    saved = build_module(realtime_config(), device=device)
    loaded = build_module(realtime_config(), device=device)
    try:
        for o in obs[:CKPT_SCAN]:
            while saved._pending > saved.params.max_queue_length // 2:
                time.sleep(0.002)  # lossless, as run_replay feeds
            saved.on_new_observation(o)
        if saved.drain() or saved.state.last_obs_tim != obs[CKPT_SCAN - 1]["timestamp"]:
            raise AssertionError(f"the first {CKPT_SCAN} scans did not all run")
        with tempfile.TemporaryDirectory() as d:
            t0 = time.perf_counter()
            save_checkpoint(saved, d)
            t1 = time.perf_counter()
            load_checkpoint(loaded, d)
            t2 = time.perf_counter()
        kfs = saved.worldmodel.entities()
        if sorted(loaded.worldmodel.entities()) != sorted(kfs) or len(kfs) < 2:
            raise AssertionError(f"keyframes {loaded.worldmodel.entities()} after the load, "
                                 f"{kfs} saved")
        for kf in kfs:
            a = saved.worldmodel.annotation(kf, ANNOTATION_NAME_PC_LAYERS)
            b = loaded.worldmodel.annotation(kf, ANNOTATION_NAME_PC_LAYERS)
            for name, pc in a.items():
                if b[name].xyz.device != pc.xyz.device or not (
                        torch.equal(pc.xyz, b[name].xyz) and torch.equal(pc.mask, b[name].mask)):
                    raise AssertionError(f"keyframe {kf} layer {name} differs after the load")
        st, st2 = saved.state_copy(), loaded.state_copy()
        same_edges = len(st.edge_log) == len(st2.edge_log) and all(
            (a, b) == (a2, b2) and np.array_equal(R, R2) and np.array_equal(t, t2)
            for (a, b, R, t), (a2, b2, R2, t2) in zip(st.edge_log, st2.edge_log))
        if not (same_edges and st.local_pose_graph.nodes == st2.local_pose_graph.nodes
                and st.local_pose_graph.root == st2.local_pose_graph.root
                and st.last_kf == st2.last_kf):
            raise AssertionError("the pose graph differs after the load")
        for o in obs[CKPT_SCAN:CKPT_SCAN + 2]:
            loaded.on_new_observation(o)
        if loaded.drain() or not np.all(np.isfinite(loaded.state.world_t)) \
                or loaded.state.last_obs_tim != obs[CKPT_SCAN + 1]["timestamp"]:
            raise AssertionError("the loaded module did not resume")
        print(f"checkpoint after {CKPT_SCAN} scans: {len(kfs)} keyframe clouds and "
              f"{len(st.edge_log)} edges equal after the load onto {device}; saved in "
              f"{1e3 * (t1 - t0):.1f} ms, loaded in {1e3 * (t2 - t1):.1f} ms; resumed 2 scans")
    finally:
        saved.shutdown()
        loaded.shutdown()


def _median_ms(fn, reps: int = MESH_REPS) -> float:
    """Median of ``reps`` single calls, each timed by CUDA events, after a
    warm-up call."""
    import statistics

    import torch
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


def mesh_searches(device, power):
    """The mesh phase, step 1: ``tp_nearest_neighbors`` / ``tp_knn`` at the
    map align's shapes (MESH_SEARCHES) with the target split over P in
    MESH_PS positions, each bit-identical to the unsharded kernel and to
    the twin, timed beside the unsharded kernel."""
    import torch
    from mola_fe_lidar_tpu_torch.cloud.metric_map import PointCloud, split_cloud
    from mola_fe_lidar_tpu_torch.ops import knn_kernel, matching, nn_kernel, tp
    from mola_fe_lidar_tpu_torch.parallel import mesh

    gen = torch.Generator().manual_seed(3)
    positions = mesh.devices("cuda")
    for kind, k, n, m in MESH_SEARCHES:
        src, sm = make_cloud(gen, n, 0.95, device)
        tgt, tm = make_cloud(gen, m, 0.9, device)
        if kind == "knn":
            whole = lambda: knn_kernel.knn(src, sm, tgt, tm, k)
            plain = matching.knn(src, sm, tgt, tm, k)
        else:
            whole = lambda: nn_kernel.nearest_neighbors(src, sm, tgt, tm)
            plain = matching.nearest_neighbors(src, sm, tgt, tm)
        want = whole()
        line = [f"{kind} k={k} {n}x{m}: unsharded {_median_ms(whole):.4f} ms"]
        for p in MESH_PS:
            split = split_cloud(PointCloud(tgt, tm, {}), positions[:p])
            if kind == "knn":
                sharded = lambda: tp.tp_knn(src, sm, split.xyz, split.mask, k)
            else:
                sharded = lambda: tp.tp_nearest_neighbors(src, sm, split.xyz, split.mask)
            got = sharded()
            torch.cuda.synchronize()
            if not (compare(got, want)[1] and compare(got, plain)[1]):
                raise AssertionError(f"tp {kind} k={k} {n}x{m} P={p} is not bit-identical to the "
                                     "unsharded kernel and the twin")
            line.append(f"P={p} {_median_ms(sharded):.4f} ms")
        print("mesh search, " + ", ".join(line) + f" (median of {MESH_REPS}; bit-identical to "
              f"the unsharded kernel and the twin; {power})")


def mesh_aligns(device, main_res):
    """The mesh phase, step 2: ``make_sharded_align`` (model = 4) of the
    replay's last scan onto its local map with the realtime preset's map
    stages, and ``make_dp_tp_align`` (data = 2, model = 2) of its last 4
    keyframes onto the map, each against the single-device align with the
    candidate cache off."""
    import dataclasses

    import numpy as np
    import torch
    from mola_fe_lidar_tpu_torch.frontend.odometry import _stack_maps
    from mola_fe_lidar_tpu_torch.frontend.worldmodel import ANNOTATION_NAME_PC_LAYERS
    from mola_fe_lidar_tpu_torch.geometry import se3, se3_np
    from mola_fe_lidar_tpu_torch.models import align_pipeline
    from mola_fe_lidar_tpu_torch.models.config import AlignKind
    from mola_fe_lidar_tpu_torch.parallel import (make_dp_tp_align, make_mesh,
                                                  make_sharded_align, mesh)

    module = main_res["module"]
    st = module.state
    stages = module._stages_for(AlignKind.LIDAR_ODOMETRY, True)
    no_cache = tuple(dataclasses.replace(s, matchers=tuple(
        dataclasses.replace(mt, cand_k=0) for mt in s.matchers)) for s in stages)
    positions = mesh.devices("cuda")

    def chain(run, pose):
        res = None
        for st_ in stages:
            res = run(st_, pose)
            pose = res.pose
        return res

    def gap(a, b):
        return (float((a.pose.t - b.pose.t).abs().max()),
                float((a.quality - b.quality).abs().max()))

    # one scan, TP over 4 positions, from 0.1 m / 0.01 rad off its pose
    off = se3_np.compose((st.world_R, st.world_t), se3_np.exp(np.array([0.1, -0.05, 0, 0, 0, 0.01])))
    guess = se3.Pose(torch.tensor(off[0], dtype=torch.float32, device=device),
                     torch.tensor(off[1], dtype=torch.float32, device=device))
    tp_mesh = make_mesh({"model": 4}, positions)
    t0 = time.perf_counter()
    tp_res = chain(lambda p, g: make_sharded_align(tp_mesh, p)(st.last_points, st.local_map, g),
                   guess)
    tp_res.quality.cpu()
    t1 = time.perf_counter()
    one = align_pipeline(st.last_points, st.local_map, guess, no_cache)
    one.quality.cpu()
    t2 = time.perf_counter()
    dt, dq = gap(tp_res, one)
    print(f"make_sharded_align (model=4) of the last scan onto the local map "
          f"({ {n: pc.capacity for n, pc in st.local_map.items()} }): {1e3 * (t1 - t0):.1f} ms "
          f"against {1e3 * (t2 - t1):.1f} ms on one device without the cache; pose gap {dt:.3g} m, "
          f"quality gap {dq:.3g}, {int(tp_res.n_iterations)} iterations")
    if not (dt <= MESH_POSE_TOL_M and dq <= MESH_QUALITY_TOL):
        raise AssertionError(f"make_sharded_align is {dt} m / {dq} off the single-device align")

    # DP x TP: the last 4 keyframes, 2 lanes a data position, each lane's
    # map split over 2 model positions
    kfs = sorted(main_res["kf_poses"])[-4:]
    clouds = [module.worldmodel.annotation(kf, ANNOTATION_NAME_PC_LAYERS) for kf in kfs]
    src = _stack_maps(clouds)
    tgt = {name: type(pc)(pc.xyz.expand(4, *pc.xyz.shape), pc.mask.expand(4, *pc.mask.shape),
                          {a: v.expand(4, *v.shape) for a, v in pc.attrs.items()})
           for name, pc in st.local_map.items()}
    poses = [main_res["kf_poses"][kf] for kf in kfs]
    guesses = se3.Pose(torch.tensor(np.stack([R for R, _ in poses]), dtype=torch.float32,
                                    device=device),
                       torch.tensor(np.stack([t for _, t in poses]), dtype=torch.float32,
                                    device=device) + 0.05)
    dp_mesh = make_mesh({"data": 2, "model": 2}, positions)
    t0 = time.perf_counter()
    dp_res = chain(lambda p, g: make_dp_tp_align(dp_mesh, p)(src, tgt, g), guesses)
    dp_res.quality.cpu()
    t1 = time.perf_counter()
    one = align_pipeline(src, st.local_map, guesses, no_cache)
    dt, dq = gap(dp_res, one)
    print(f"make_dp_tp_align (data=2, model=2) of 4 keyframes onto the local map: "
          f"{1e3 * (t1 - t0):.1f} ms; pose gap {dt:.3g} m, quality gap {dq:.3g} against the "
          f"single-device batch without the cache")
    if not (dt <= MESH_POSE_TOL_M and dq <= MESH_QUALITY_TOL):
        raise AssertionError(f"make_dp_tp_align is {dt} m / {dq} off the single-device align")


def mesh_replay(device, obs, gt, main_res):
    """The mesh phase, step 3: the replay's scans with ``mesh_data=2,
    mesh_model=2``, counts reset and read around it. Returns (counts,
    counts per shape)."""
    import numpy as np
    from mola_fe_lidar_tpu_torch.obs.runner import realtime_config

    cfg = realtime_config()
    cfg["params"].update(mesh_data=2, mesh_model=2)
    res, counts, by_shape, stats = run_phase(device, obs, gt, cfg,
                                             "mesh replay (mesh_data=2, mesh_model=2)")
    if res["module"]._mesh is None or res["module"]._mesh.shape != {"data": 2, "model": 2}:
        raise AssertionError("the mesh replay built no 2 x 2 mesh")
    dp = stats.get("counter:checkNonAdjacent.nearby.dp_lanes", {"count": 0})
    if dp["count"] < 1:
        raise AssertionError("no nearby batch ran over the data axis")
    if res["n_keyframes"] != main_res["n_keyframes"]:
        raise AssertionError(f"{res['n_keyframes']} keyframes on the mesh, "
                             f"{main_res['n_keyframes']} on one device")
    common = set(res["kf_poses"]) & set(main_res["kf_poses"])
    worst = max(float(np.linalg.norm(np.asarray(res["kf_poses"][k][1])
                                     - np.asarray(main_res["kf_poses"][k][1]))) for k in common)
    print(f"  mesh vs one device: {res['n_keyframes']} keyframes each, largest keyframe "
          f"translation gap {worst:.4g} m; steady {res['scans_per_sec_steady']} vs "
          f"{main_res['scans_per_sec_steady']} scans/s, scan ATE {res['ate_rmse_scan']} vs "
          f"{main_res['ate_rmse_scan']} m; {dp['count']} nearby batches over the data axis "
          f"({dp['max']:.0f} lanes)")
    return counts, by_shape


def mesh_phase(device, obs, gt, main_res, power):
    """The mesh phase: MESH_POSITIONS positions on the card
    (``force_device_count``), reset after. Returns the mesh replay's
    (counts, counts per shape)."""
    from mola_fe_lidar_tpu_torch.parallel import mesh

    t0 = time.perf_counter()
    previous = mesh.force_device_count(MESH_POSITIONS)
    try:
        print(f"mesh phase: {MESH_POSITIONS} positions {mesh.devices('cuda')}")
        mesh_searches(device, power)
        mesh_aligns(device, main_res)
        out = mesh_replay(device, obs, gt, main_res)
    finally:
        mesh.force_device_count(previous)
    print(f"mesh phase: {time.perf_counter() - t0:.1f} s")
    return out


def pgo(res, obs, gt):
    """Phase 5, continued: the loop-closure replay's pose graph optimized
    by the back-end without and with the Cauchy kernel."""
    import numpy as np
    from mola_fe_lidar_tpu_torch.obs.metrics import ate_rmse
    from mola_fe_lidar_tpu_torch.obs.runner import _associate

    backend = res["backend"]
    kf_ids = sorted(res["kf_poses"])
    stamps = [backend.keyframes[k].timestamp for k in kf_ids]
    est, ref = _associate(list(zip(stamps, (res["kf_poses"][k] for k in kf_ids))), obs, gt)
    ate_graph = ate_rmse(est, ref)
    for robust in ("none", "cauchy"):
        t0 = time.perf_counter()
        poses = backend.optimized_poses(robust=robust)
        ms = 1e3 * (time.perf_counter() - t0)
        est, ref = _associate(list(zip(stamps, (poses[k] for k in kf_ids))), obs, gt)
        ate = ate_rmse(est, ref)
        finite = all(np.all(np.isfinite(R)) and np.all(np.isfinite(t)) for R, t in poses.values())
        print(f"PGO robust={robust}: {ms:.1f} ms, {len(poses)} nodes, {len(backend.factors)} "
              f"edges, ate_rmse_pgo {ate} m, ate_rmse {ate_graph} m (graph estimate)")
        if not finite or not ate <= ATE_BOUND_M:
            raise AssertionError(f"PGO robust={robust}: ate_rmse_pgo {ate} m, finite={finite}")


def loop_closure(device, obs, gt):
    """Phase 5: the same scans with loop-closure candidates from LC_TOPO
    keyframes back: full-width Monte-Carlo batches against the submap."""
    from mola_fe_lidar_tpu_torch.obs.runner import realtime_config

    cfg = realtime_config()
    cfg["params"]["min_topo_dist_to_consider_loopclosure"] = LC_TOPO
    res, counts, by_shape, stats = run_phase(device, obs, gt, cfg, "loop-closure replay",
                                             pgo=True)
    if stats.get("counter:checkNonAdjacent.lc.accepted", {}).get("count", 0) < 1:
        raise AssertionError("no loop-closure check ran")
    lanes = cfg["params"]["loop_closure_montecarlo_samples"]
    if not any(b == lanes for b, *_ in by_shape["nearest_neighbors"]):
        raise AssertionError(f"no {lanes}-lane Monte-Carlo batch was launched")
    pgo(res, obs, gt)
    return res, counts, by_shape


def accuracy_tools(device, lc_res, obs, gt):
    """Phase 5, continued: the accuracy harness's studies on the loop-
    closure replay (``obs/accuracy.py``) -- its loop-closure factors must
    lower the optimized scan ATE, and Cauchy PGO must hold one injected
    false loop closure to within FALSE_LC_ROBUST_TOL of the clean ATE
    while plain least squares is dragged more than FALSE_LC_PLAIN_FACTOR
    times off --; the PLY export of that replay (``obs/viz.py``, two
    keyframes) and the runner CLI with ``--profile --viz-out`` over
    CLI_SCANS quickstart scans, with the counts reset and read around it.
    Returns the CLI's launches per shape."""
    import contextlib
    import io
    import tempfile

    from mola_fe_lidar_tpu_torch.obs import accuracy, runner, viz

    t0 = time.perf_counter()
    abl = accuracy.lc_ablation_study(lc_res, obs, gt, "cauchy")
    print(f"LC ablation (Cauchy PGO): {abl['n_lc_factors']} loop-closure factors, scan ATE "
          f"{abl['ate_pgo_with_lc']} m with them, {abl['ate_pgo_without_lc']} m without")
    if abl["n_lc_factors"] < 1 or not abl["ate_pgo_with_lc"] <= abl["ate_pgo_without_lc"]:
        raise AssertionError(f"the loop-closure factors do not lower the optimized ATE: {abl}")
    flc = accuracy.false_lc_study(lc_res, obs, gt, "cauchy")
    clean = flc["ate_clean_robust"]
    print(f"false LC {flc['injected_pair']}: scan ATE clean (Cauchy) {clean} m, poisoned plain "
          f"{flc['ate_poisoned_plain']} m, poisoned Cauchy {flc['ate_poisoned_robust']} m")
    if not (abs(flc["ate_poisoned_robust"] - clean) <= FALSE_LC_ROBUST_TOL * clean
            and flc["ate_poisoned_plain"] > FALSE_LC_PLAIN_FACTOR * clean):
        raise AssertionError(f"the false loop-closure study is outside its bounds: {flc}")
    with tempfile.TemporaryDirectory() as d:
        viz.export_run(f"{d}/export", lc_res["module"], max_keyframes=2)
        sizes = {p.name: p.stat().st_size for p in sorted(Path(d, "export").iterdir())}
        print(f"export_run (2 keyframes): {sizes} bytes")
        if len(sizes) != 3 or "trajectory.ply" not in sizes or min(sizes.values()) < 200:
            raise AssertionError(f"export_run wrote {sizes}")
        _reset_counts()
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = runner.main(["--scans", str(CLI_SCANS), "--profile", "--viz-out",
                              f"{d}/runner", "--device", str(device)])
        _, by_shape = _read_counts()
        text = out.getvalue()
        summary = json.loads(text[:text.index("\n}\n") + 2])
        report = text.split(f"PLY exports written to {d}/runner\n", 1)[-1].splitlines()
        sizes = {p.name: p.stat().st_size for p in sorted(Path(d, "runner").iterdir())}
        print(f"runner CLI --scans {CLI_SCANS} --profile --viz-out: rc {rc}, "
              f"{summary['n_keyframes']} keyframes, scans_per_sec {summary['scans_per_sec']}, "
              f"PLY {sizes} bytes")
        print(f"  profiler report, first line: {report[0] if report else ''}")
        if rc != 0 or summary["n_scans"] != CLI_SCANS or "trajectory.ply" not in sizes \
                or len(report) < 2 or not report[0].strip():
            raise AssertionError("the runner CLI's --profile / --viz-out output is missing")
    print(f"accuracy tools: {time.perf_counter() - t0:.1f} s")
    return by_shape


def _timed_batches(fn, reps: int):
    """(result, median seconds, launches per call by shape): one warm-up
    call, then ``reps`` calls, each ended by a read of the result to the
    host, with the counts reset after the warm-up."""
    import torch
    fn()
    torch.cuda.synchronize()
    _reset_counts()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        res = fn()
        res.quality.cpu()
        times.append(time.perf_counter() - t0)
    counts, by_shape = _read_counts()
    return res, sorted(times)[reps // 2], counts, by_shape


def pairwise(device):
    """Phase 6: the pairwise-registration path. The reference runner's
    quickstart (``DEFAULT_CFG``: 0.7 m voxel downsample, point-to-point
    Horn, then kNN = 6 point-to-plane, which launches K1 at k = 6 every
    iteration) replayed over QUICK_SCANS synthetic circle scans; bench.py's
    PAIRS scan pairs through four configurations, each one batch of PAIRS
    lanes; one GICP align of two GICP_POINTS-point clouds (K1 at k = 10).
    Counts are reset just before and read just after each run. Returns
    {(kernel, (B, n, m, k)): (launches, runs, unit)}."""
    import dataclasses
    import math

    import numpy as np
    import torch
    from mola_fe_lidar_tpu_torch.cloud.metric_map import from_points
    from mola_fe_lidar_tpu_torch.filters.pipeline import (FilterGICPCovariances,
                                                          _attach_normals_knn)
    from mola_fe_lidar_tpu_torch.geometry import se3
    from mola_fe_lidar_tpu_torch.models import (ICPParams, Matcher, PairWeights, Quality, Solver,
                                                align, align_pipeline, icp_coarse_to_fine,
                                                icp_settings_regular)
    from mola_fe_lidar_tpu_torch.obs.runner import default_config
    from mola_fe_lidar_tpu_torch.obs.scan_pairs import (make_pairs, make_world, pair_clouds,
                                                        pose_errors, stack_pairs)
    from mola_fe_lidar_tpu_torch.obs.synthetic import synthetic_sequence

    shapes = {}

    def record(by_shape, runs, unit):
        for name, per_shape in by_shape.items():
            for key, c in per_shape.items():
                shapes.setdefault((name, key), (c, runs, unit))

    t0 = time.perf_counter()
    obs, gt = synthetic_sequence(kind="circle", n_scans=QUICK_SCANS,
                                 loop_side=QUICK_SCANS / math.pi)
    print(f"simulated {QUICK_SCANS} synthetic circle scans ({len(obs[0]['xyz'])} points each) "
          f"in {time.perf_counter() - t0:.1f} s")
    _, _, by_shape, _ = run_phase(device, obs, gt, default_config(),
                                  "quickstart replay (DEFAULT_CFG)", ate_bound=QUICK_ATE_BOUND_M)
    record(by_shape, QUICK_SCANS, "scan (quickstart)")

    rng = np.random.default_rng(PAIR_SEED)
    pairs = make_pairs(rng, PAIRS, PAIR_CAP)
    src, tgt, taus = stack_pairs(pairs, PAIR_CAP, device=device)
    # bench.py's outlier pairs: 20 % of each target replaced by an off-pose
    # cluster that the source lacks
    orng = np.random.default_rng(PAIR_SEED + 1)
    out_pairs = []
    for world, tau in pairs:
        w = world.copy()
        k = len(w) // 5
        c = orng.uniform(-20, 20, 3).astype(np.float32)
        c[2] = 1.0
        w[-k:] = c + orng.normal(0, 1.0, (k, 3)).astype(np.float32)
        out_pairs.append(((world, w), tau))
    src_o, tgt_o, _ = stack_pairs(out_pairs, PAIR_CAP, device=device)
    eye = se3.Pose(torch.eye(3, device=device).expand(PAIRS, 3, 3).contiguous(),
                   torch.zeros(PAIRS, 3, device=device))
    p2p = ICPParams(max_iterations=40,
                    matchers=(Matcher(kind="point2point", distance_threshold=2.0),),
                    solver=Solver(kind="horn"),
                    weights=PairWeights(use_scale_outlier_detector=False))
    robust = ICPParams(
        max_iterations=40,
        matchers=(Matcher(kind="point2plane_knn", distance_threshold=1.0, knn=6,
                          plane_eigen_threshold=0.2),),
        solver=Solver(kind="gauss_newton", max_iterations=10),
        quality=(Quality(threshold_distance=0.3),),
        weights=PairWeights(use_scale_outlier_detector=False, use_robust_kernel=True,
                            robust_kernel="cauchy", robust_kernel_param=0.2))

    def c2f():
        tgt_n = {"raw": _attach_normals_knn(tgt["raw"].xyz, tgt["raw"].mask, 8)}
        return align_pipeline(src, tgt_n, eye, icp_coarse_to_fine())

    runs = (("c2f", "coarse-to-fine with kNN normals", c2f),
            ("regular", "kNN = 6 point-to-plane, icp_settings_regular",
             lambda: align(src, tgt, eye, icp_settings_regular())),
            ("anderson", "icp_settings_regular with Anderson acceleration (anderson_m=5)",
             lambda: align(src, tgt, eye,
                           dataclasses.replace(icp_settings_regular(), anderson_m=5))),
            ("horn", "point-to-point Horn", lambda: align(src, tgt, eye, p2p)),
            ("robust", "robust Cauchy point-to-plane, 20 % outliers",
             lambda: align(src_o, tgt_o, eye, robust)))
    for key, label, fn in runs:
        res, sec, counts, by_shape = _timed_batches(fn, PAIR_REPS)
        errs = pose_errors(res.pose, taus)
        acc = res.quality.cpu().numpy() > 0.5
        worst = float(errs[acc].max()) if acc.any() else float("inf")
        n_it = res.n_iterations.cpu().numpy()
        print(f"pairs, {label}: {PAIRS / sec:.1f} pairs/s ({1e3 * sec:.1f} ms a batch of "
              f"{PAIRS}), accepted {acc.mean():.3f}, largest accepted error {worst:.5f} m, "
              f"mean error {errs.mean():.5f} m, iterations {n_it.min()}-{n_it.max()} "
              f"(mean {n_it.mean():.2f}), "
              f"launches a batch {({k: v / PAIR_REPS for k, v in counts.items()})}")
        record(by_shape, PAIR_REPS, f"batch ({key})")
        least, largest = PAIR_BOUNDS[key]
        if acc.mean() < least or worst > largest:
            raise AssertionError(f"{label}: accepted {acc.mean():.3f} (bound {least}), largest "
                                 f"accepted error {worst} m (bound {largest} m)")

    grng = np.random.default_rng(PAIR_SEED + 2)
    world = make_world(grng, GICP_POINTS)
    tau = grng.normal(0, 0.08, 6).astype(np.float32)
    (s_np,), (t_np,), _ = pair_clouds([(world, tau)])
    gicp = ICPParams(max_iterations=30,
                     matchers=(Matcher(kind="gicp", distance_threshold=1.0),),
                     solver=Solver(kind="gauss_newton", max_iterations=10),
                     weights=PairWeights(use_scale_outlier_detector=False))

    def gicp_align():
        covs = FilterGICPCovariances()
        s_map = covs({"raw": from_points(s_np, capacity=GICP_POINTS, device=device)})
        t_map = covs({"raw": from_points(t_np, capacity=GICP_POINTS, device=device)})
        return align(s_map, t_map, se3.Pose(torch.eye(3, device=device),
                                            torch.zeros(3, device=device)), gicp)

    res, sec, counts, by_shape = _timed_batches(gicp_align, PAIR_REPS)
    err = float(pose_errors(se3.Pose(res.pose.R[None], res.pose.t[None]), [tau])[0])
    print(f"GICP {GICP_POINTS} points (covariances + align): {1e3 * sec:.1f} ms, error "
          f"{err:.6f} m (bound {GICP_ERR_BOUND_M} m), {int(res.n_iterations)} iterations, "
          f"quality {float(res.quality):.4f}, launches {counts}")
    record(by_shape, PAIR_REPS, "align (GICP)")
    if not err <= GICP_ERR_BOUND_M:
        raise AssertionError(f"GICP error {err} m outside the bound {GICP_ERR_BOUND_M} m")
    for name in ("knn", "nearest_neighbors"):
        if not any(n == name for n, _ in shapes):
            raise AssertionError(f"kernel {name} was not launched by the pairwise phase")
    return shapes


def localizer_scene(device, obs, gt):
    """The localizer phase's inputs (``scripts/bench_localize_tp.py``'s):
    (keyframes every LOC_KF_EVERY scans as (layers, ground-truth pose), the
    query layers of scan i, the valid points of scan i). A keyframe is the
    full raw cloud plus the ``edges`` layer of ``FilterEdgesPlanes``; a
    query is the cloud deduplicated in 0.5 m voxels into 4096 points, plus
    its edges."""
    from mola_fe_lidar_tpu_torch.cloud.metric_map import from_points
    from mola_fe_lidar_tpu_torch.cloud.voxel import voxel_first_indices_np
    from mola_fe_lidar_tpu_torch.filters.pipeline import FilterEdgesPlanes

    edge_filter = FilterEdgesPlanes(voxel_filter_resolution=1.0, edges_capacity=2048,
                                    stats_mode="scan")

    def points(i):
        return obs[i]["xyz"][obs[i]["valid"] > 0]

    def with_edges(pts):
        raw = from_points(pts, capacity=1 << 17, device=device)
        return {"raw": raw, "edges": edge_filter({"raw": raw})["edges"]}

    def query(i):
        pts = points(i)
        return {"raw": from_points(pts[voxel_first_indices_np(pts, 0.5)], capacity=4096,
                                   device=device),
                "edges": with_edges(pts)["edges"]}

    return ([(with_edges(points(i)), gt[i]) for i in range(0, len(obs), LOC_KF_EVERY)],
            query, points)


def localizer(device, obs, gt):
    """Phase 7: the map localizer (``frontend/localizer.py``) on the
    replay's simulated scans, as ``scripts/bench_localize_tp.py`` runs the
    JAX package's: keyframes every LOC_KF_EVERY scans (full raw cloud plus
    an ``edges`` layer) at their ground-truth poses in a 2^17-point map;
    the queries LOC_QUERIES (0.5 m voxel dedup into 4096 points, with
    edges) from perturbed inits, each timed; an adversarial query from
    LOC_ADVERSARIAL_M to the side with a 3 m probe sigma, which must be
    rejected; ``localize_raw`` against 32,768- and 131,072-point maps.
    Counts are reset just before and read just after. Returns the
    launches of one gated localize and of one ``localize_raw`` by shape,
    {(kernel, (B, n, m, k)): (launches, 1, unit)}, and the phase's counts."""
    import numpy as np
    import torch
    from mola_fe_lidar_tpu_torch.cloud.metric_map import from_points
    from mola_fe_lidar_tpu_torch.cloud.voxel import voxel_first_indices_np
    from mola_fe_lidar_tpu_torch.frontend.localizer import MapLocalizer
    from mola_fe_lidar_tpu_torch.geometry import se3, se3_np

    t_phase = time.perf_counter()
    _reset_counts()
    items, query, points = localizer_scene(device, obs, gt)

    def pose_f32(R, t):
        return se3.Pose(np.asarray(R, np.float32), np.asarray(t, np.float32))

    def trans_err(R, t, true):
        """|translation of pose (R, t) composed with the inverse of true|"""
        return float(np.linalg.norm(np.asarray(R, np.float64) @ se3_np.inverse(true)[1] + t))

    kw = dict(map_capacity=1 << 17, voxel_size=0.5, agree_tol_m=1.5, device=device)
    loc = MapLocalizer(start_sigma_xyz=1.0, **kw)
    t0 = time.perf_counter()
    loc.build(items)
    map_pts = int(loc.map_cloud.count())
    edge_pts = int(loc._map["map_edges"].count())
    print(f"localizer map: {len(items)} keyframes, {map_pts} points in {loc.map_capacity}, "
          f"{edge_pts} edge points in {loc._map['map_edges'].capacity}, built in "
          f"{time.perf_counter() - t0:.2f} s")

    def per_call(fn, unit):
        """fn's result and its launches by shape: {(kernel, key): (n, 1, unit)}."""
        before = _read_counts()[1]
        out = fn()
        torch.cuda.synchronize()
        return out, {(name, key): (c - before[name].get(key, 0), 1, unit)
                     for name, shapes in _read_counts()[1].items() for key, c in shapes.items()
                     if c > before[name].get(key, 0)}

    rng = np.random.default_rng(LOC_SEED)
    per_localize = None
    accepted_errs, n_acc = [], 0
    for i in LOC_QUERIES:
        scan, true = query(i), (np.asarray(gt[i][0]), np.asarray(gt[i][1]))
        # the bench's prior: 0.5 m translation, 2 degrees of yaw
        dt = rng.normal(0, 0.5, 3)
        dyaw = rng.normal(0, np.deg2rad(2.0))
        init = pose_f32(*se3_np.compose(true, se3_np.exp(np.array([*dt, 0, 0, dyaw]))))
        res, counted = per_call(lambda: loc.localize(scan, init), "localize")  # warm
        per_localize = per_localize or counted
        times = []
        for _ in range(LOC_REPS):
            t0 = time.perf_counter()
            res = loc.localize(scan, init)  # one read of the base, one of the probes
            times.append(time.perf_counter() - t0)
        err = trans_err(*res.pose, true)
        print(f"localize scan {i}: {1e3 * sorted(times)[LOC_REPS // 2]:.1f} ms (median of "
              f"{LOC_REPS}), quality {res.quality:.4f}, {res.n_iterations} iterations, "
              f"trans_err {err:.4f} m, init off by {np.linalg.norm(dt):.3f} m, accepted "
              f"{res.accepted} {res.reject_reason!r}, n_agree {res.n_agree}, n_compete "
              f"{res.n_compete} of {res.n_starts}, rival quality {res.rival_quality:.4f}, "
              f"dispersion {res.dispersion_m:.3f} m")
        if res.accepted:
            n_acc += 1
            accepted_errs.append(err)
    if n_acc < 2 or any(e > LOC_ERR_BOUND_M for e in accepted_errs):
        raise AssertionError(f"localizer: {n_acc} of {len(LOC_QUERIES)} accepted, accepted "
                             f"errors {accepted_errs} (bound {LOC_ERR_BOUND_M} m)")

    i = LOC_QUERIES[0]
    true = (np.asarray(gt[i][0]), np.asarray(gt[i][1]))
    init = pose_f32(*se3_np.compose(true, se3_np.exp(np.array([0.0, LOC_ADVERSARIAL_M, 0, 0, 0, 0]))))
    wide = MapLocalizer(start_sigma_xyz=3.0, **kw)
    wide.build(items)
    res = wide.localize(query(i), init)
    print(f"adversarial: scan {i} from {LOC_ADVERSARIAL_M} m to the side (probe sigma 3 m): "
          f"accepted {res.accepted} {res.reject_reason!r}, quality {res.quality:.4f}, "
          f"trans_err {trans_err(*res.pose, true):.4f} m, n_agree {res.n_agree}, n_compete "
          f"{res.n_compete}, rival quality {res.rival_quality:.4f}")
    if res.accepted:
        raise AssertionError("the adversarial localize query was accepted")

    pts = points(i)
    scan = {"raw": from_points(pts[voxel_first_indices_np(pts, 0.5)], capacity=4096,
                               device=device)}
    shapes = dict(per_localize)
    for cap in (1 << 15, 1 << 17):
        anchor = MapLocalizer(map_capacity=cap, voxel_size=0.5, device=device)
        anchor.build([({"raw": loc.map_cloud}, (np.eye(3), np.zeros(3)))])
        init = pose_f32(*true)
        _, counted = per_call(lambda: anchor.localize_raw(scan, init), "localize_raw")  # warm
        for key, val in counted.items():
            shapes.setdefault(key, val)
        times = []
        for _ in range(LOC_REPS):
            t0 = time.perf_counter()
            res = anchor.localize_raw(scan, init)
            res.quality.cpu()
            times.append(time.perf_counter() - t0)
        print(f"localize_raw against {int(anchor.map_cloud.count())} points (capacity {cap}) "
              f"from the true pose: {1e3 * sorted(times)[LOC_REPS // 2]:.1f} ms, "
              f"{int(res.n_iterations)} iterations, quality {float(res.quality):.4f}, trans_err "
              f"{trans_err(res.pose.R.cpu().numpy(), res.pose.t.cpu().numpy(), true):.4f} m")
    counts, _ = _read_counts()
    print(f"  launch counts (phase): {counts}; one gated localize, one localize_raw:")
    for (name, (b, n, m, k)), (c, _, unit) in sorted(shapes.items()):
        print(f"    {name} B={b} {n}x{m} k={k}: {c} launches a {unit}")
    for name, c in counts.items():
        if c <= 0:
            raise AssertionError(f"kernel {name} was not launched by the localizer phase")
    if not any(b == loc.multi_start - 1 for (_, (b, *_)) in per_localize):
        raise AssertionError("no probe batch was launched")
    print(f"localizer phase: {time.perf_counter() - t_phase:.1f} s")
    return shapes, counts


def check_batched(device, shape_counts, unbatched=frozenset()):
    """Phase 8: every batched shape the replays, the pairwise phase and
    the localizer launched, and the unbatched shapes in ``unbatched``.
    ``shape_counts``: {(kernel name, (B, n, m, k)): (launches, scans or
    batches, unit)}. Returns the rows per kernel."""
    import torch
    from mola_fe_lidar_tpu_torch.ops import knn_kernel, matching, nn_kernel

    gen = torch.Generator().manual_seed(2)
    rows = {"knn": [], "nearest_neighbors": []}
    for (name, (b, n, m, k)), (launched, per, unit) in sorted(shape_counts.items()):
        if b == 1 and (name, (b, n, m, k)) not in unbatched:
            continue
        lanes = [make_cloud(gen, n, 0.95, device) for _ in range(b)]
        src = torch.stack([x for x, _ in lanes])
        sm = torch.stack([x for _, x in lanes])
        lanes = [make_cloud(gen, m, 0.9, device) for _ in range(b)]
        tgt = torch.stack([x for x, _ in lanes])
        tm = torch.stack([x for _, x in lanes])
        if name == "knn":
            kern = lambda *a: knn_kernel.knn(*a, k)
            plain = lambda *a: matching.knn(*a, k)
        else:
            kern, plain = nn_kernel.nearest_neighbors, matching.nearest_neighbors
        if b == 1:  # one unbatched search
            shared = (src[0], sm[0], tgt[0], tm[0])
            variants = (shared,)
        else:
            shared = (src, sm[:1].expand_as(sm), tgt[:1].expand_as(tgt), tm[:1].expand_as(tm))
            variants = ((src, sm, tgt, tm), shared)
        err = 0.0
        for args in variants:
            got, want = kern(*args), plain(*args)
            torch.cuda.synchronize()
            e, same = compare(got, want)
            err = max(err, e)
            if not same:
                raise AssertionError(f"{name} B={b} {n}x{m} k={k} is not bit-identical to its twin")
            for lane in range(b if b > 1 else 0):
                one = kern(*(x[lane].contiguous() for x in args))
                if not (torch.equal(one.idx, got.idx[lane]) and torch.equal(one.dist, got.dist[lane])):
                    raise AssertionError(f"{name} B={b} {n}x{m} k={k}: lane {lane} differs from "
                                         "an unbatched launch")
        s_ = torch.where(shared[1][..., None] > 0.5, shared[0], torch.zeros((), device=device))
        t_ = torch.where(shared[3][..., None] > 0.5, shared[2],
                         torch.full((), matching.PARK, device=device))
        if name == "knn":
            library = lambda: torch.topk(torch.cdist(
                s_, t_, compute_mode="donot_use_mm_for_euclid_dist"), k, dim=-1, largest=False)
        else:
            library = lambda: torch.cdist(
                s_, t_, compute_mode="donot_use_mm_for_euclid_dist").min(dim=-1)
        call = lambda: kern(*shared)
        row = {"kind": "knn" if name == "knn" else "nn", "B": b, "n": n, "m": m, "k": k,
               "use": unit, "max_abs_err": err,
               "ms": cuda_ms(call, reps=20), "graph_ms": graph_ms(call),
               "host_us": host_us(call),
               "bound_ms": b * n * m * FLOP_PER_PAIR / F32_PEAK_FLOPS * 1e3,
               "library_ms": cuda_ms(library, reps=5, warmup=1),
               "plain_ms": cuda_ms(lambda: plain(*shared), reps=3, warmup=1),
               "launches": launched, "per": unit, "launches_per": launched / per}
        row["bound_share"] = row["bound_ms"] / row["ms"]
        print(f"{name} B={b} k={k} {n}x{m}: bit-identical "
              + ("to the twin" if b == 1 else f"per lane (own and shared operands, twin and "
                 f"{b} unbatched launches)") + f"; kernel {row['ms']:.4f} ms, graph "
              f"{row['graph_ms']:.4f} ms, host {row['host_us']:.1f} us, bound "
              f"{row['bound_ms']:.4f} ms ({100 * row['bound_share']:.1f} %), library "
              f"{row['library_ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, "
              f"{row['launches_per']:.3f} launches per {unit}")
        rows[name].append(row)
    return rows


def _grid_search(device, n, m):
    """The grid's 1-NN at n x m: bit for bit against the CPU run of the
    same function, and against K2 where the true neighbour lies within the
    cell; returns the line to print."""
    import torch
    from mola_fe_lidar_tpu_torch.ops import grid_nn, nn_kernel

    gen = torch.Generator().manual_seed(n + m)
    src, smask = make_cloud(gen, n, 0.95, device)
    tgt, tmask = make_cloud(gen, m, 0.95, device)
    got = grid_nn.grid_nn(src, smask, tgt, tmask, GRID_CELL)
    cpu = grid_nn.grid_nn(src.cpu(), smask.cpu(), tgt.cpu(), tmask.cpu(), GRID_CELL)
    if not (torch.equal(got.idx.cpu(), cpu.idx) and torch.equal(got.dist.cpu(), cpu.dist)):
        raise AssertionError(f"grid {n}x{m}: the card's result differs from the CPU's")
    k2 = nn_kernel.nearest_neighbors(src, smask, tgt, tmask)
    ok = smask > 0.5
    found = ok & (got.dist < 1e10)
    if bool((got.dist[found] < k2.dist[found]).any()):
        raise AssertionError(f"grid {n}x{m}: a distance below the exact one")
    within = ok & (k2.dist <= GRID_CELL)
    same = got.idx == k2.idx
    if not torch.equal(got.dist[within & same], k2.dist[within & same]):
        raise AssertionError(f"grid {n}x{m}: a distance differs from K2's for the same pair")
    differ = within & ~same & (got.dist != k2.dist)  # not a tie: a missed neighbour
    index = grid_nn.build_grid(tgt, tmask, GRID_CELL)
    true_idx = k2.idx[differ].long()
    slots = grid_nn._cell_hash(grid_nn._to_cells(tgt[true_idx], index.origin, index.cell),
                               index.table.shape[-2])
    bucket = index.table[slots]
    dropped = (bucket >= 0).all(-1) & ~(bucket == true_idx[:, None].to(bucket.dtype)).any(-1)
    if not bool(dropped.all()):
        raise AssertionError(f"grid {n}x{m}: {int((~dropped).sum())} sources within the cell "
                             "miss a neighbour that no full bucket dropped")
    grid_ms = cuda_ms(lambda: grid_nn.grid_nn(src, smask, tgt, tmask, GRID_CELL), GRID_REPS)
    query_ms = cuda_ms(lambda: grid_nn.grid_nearest_neighbors(src, smask, index, tgt, tmask),
                       GRID_REPS)
    k2_ms = cuda_ms(lambda: nn_kernel.nearest_neighbors(src, smask, tgt, tmask), GRID_REPS)
    return (f"grid {n}x{m} (cell {GRID_CELL} m): equal to the CPU run; {int(within.sum())} "
            f"sources within the cell, {int((within & ~differ).sum())} equal to K2, "
            f"{int(differ.sum())} dropped by full buckets; build+query {grid_ms:.4f} ms, "
            f"query {query_ms:.4f} ms, K2 {k2_ms:.4f} ms")


def grid_and_native(device, obs, gt, main_res):
    """Phase 9: the voxel-hash grid (searches, the 64 pairs, a replay with
    ``local_map_nn_backend=grid``) and the native runtime (the replay's
    pose graph, the KITTI reader)."""
    import dataclasses
    import tempfile

    import numpy as np
    import torch
    from mola_fe_lidar_tpu_torch import native
    from mola_fe_lidar_tpu_torch.filters.pipeline import _attach_normals_knn
    from mola_fe_lidar_tpu_torch.geometry import se3
    from mola_fe_lidar_tpu_torch.models import align, icp_settings_regular
    from mola_fe_lidar_tpu_torch.obs import kitti
    from mola_fe_lidar_tpu_torch.obs.runner import REALTIME, build_config
    from mola_fe_lidar_tpu_torch.obs.scan_pairs import make_pairs, pose_errors, stack_pairs
    from mola_fe_lidar_tpu_torch.ops import grid_nn

    t_phase = time.perf_counter()
    for n, m in GRID_SHAPES:
        print(_grid_search(device, n, m))

    queries = [0]
    query = grid_nn.grid_nearest_neighbors

    def counted(*args):
        queries[0] += 1
        return query(*args)

    grid_nn.grid_nearest_neighbors = counted  # the ICP engine calls it through the module
    try:
        src, tgt, taus = stack_pairs(make_pairs(np.random.default_rng(PAIR_SEED), PAIRS, PAIR_CAP),
                                     PAIR_CAP, device=device)
        tgt_n = {"raw": _attach_normals_knn(tgt["raw"].xyz, tgt["raw"].mask, 8)}
        eye = se3.Pose(torch.eye(3, device=device).expand(PAIRS, 3, 3).contiguous(),
                       torch.zeros(PAIRS, 3, device=device))
        least, largest = PAIR_BOUNDS["regular"]
        poses = {}
        for backend in ("grid", "auto"):
            params = icp_settings_regular(matcher_kind="point2plane_normals")
            params = dataclasses.replace(params, matchers=tuple(
                dataclasses.replace(mt, nn_backend=backend) for mt in params.matchers))
            queries[0] = 0
            res, sec, counts, _ = _timed_batches(lambda: align(src, tgt_n, eye, params), PAIR_REPS)
            errs = pose_errors(res.pose, taus)
            acc = res.quality.cpu().numpy() > 0.5
            worst = float(errs[acc].max()) if acc.any() else float("inf")
            label = "grid" if backend == "grid" else "K2"
            print(f"pairs, icp_settings_regular point2plane_normals on the {label}: "
                  f"{PAIRS / sec:.1f} pairs/s ({1e3 * sec:.1f} ms a batch of {PAIRS}), accepted "
                  f"{acc.mean():.3f}, largest accepted error {worst:.6f} m, grid queries "
                  f"{queries[0]}, launches {counts}")
            if acc.mean() < least or worst > largest:
                raise AssertionError(f"{label} pairs: accepted {acc.mean():.3f} (bound {least}), "
                                     f"largest accepted error {worst} m (bound {largest} m)")
            if (queries[0] > 0) != (backend == "grid"):
                raise AssertionError(f"{label} pairs: {queries[0]} grid queries")
            poses[backend] = res.pose.t
        print(f"  grid vs K2 pose gap {float((poses['grid'] - poses['auto']).abs().max()):.3g} m")
        # the kNN preset's matcher stays on K1 under nn_backend: grid
        knn_grid = icp_settings_regular()
        knn_grid = dataclasses.replace(knn_grid, matchers=tuple(
            dataclasses.replace(mt, nn_backend="grid") for mt in knn_grid.matchers))
        queries[0] = 0
        _reset_counts()
        align(src, tgt, eye, knn_grid).quality.cpu()
        counts, _ = _read_counts()
        if queries[0] or counts["knn"] == 0:
            raise AssertionError(f"kNN matcher under grid: {queries[0]} grid queries, {counts}")

        cfg = build_config(overrides=REALTIME + ("local_map_nn_backend=grid",))
        queries[0] = 0
        res, _, _, _ = run_phase(device, obs[:VARIANT_SCANS], gt[:VARIANT_SCANS], cfg,
                                 "grid replay (local_map_nn_backend=grid)")
        print(f"grid replay: {queries[0]} grid queries, steady {res['scans_per_sec_steady']} "
              f"scans/s, scan ATE {res['ate_rmse_scan']} m")
        if queries[0] < 1:
            raise AssertionError("the grid replay queried no grid")
    finally:
        grid_nn.grid_nearest_neighbors = query

    graph = main_res["module"].state.local_pose_graph
    if type(graph) is not native.NativePoseGraph:
        raise AssertionError(f"the replay's pose graph is a {type(graph).__name__}: the native "
                             f"library did not build ({native.build_error})")
    t0 = time.perf_counter()
    poses_kf, _ = graph.dijkstra_nodes_estimate(graph.root)
    print(f"native pose graph: {len(graph)} nodes, {graph.num_edges} edges, Dijkstra "
          f"{1e3 * (time.perf_counter() - t0):.3f} ms ({len(poses_kf)} poses)")
    with tempfile.TemporaryDirectory() as d:
        path = Path(d) / "000000.bin"
        rows = np.concatenate([obs[0]["xyz"], np.linspace(0, 1, len(obs[0]["xyz"]))[:, None]], 1)
        rows.astype(np.float32).tofile(path)
        xyz, inten = native.kitti_read_bin_native(str(path))
        want = kitti.read_velodyne_bin(str(path))
        if not (xyz.tobytes() == np.ascontiguousarray(want[:, :3]).tobytes()
                and inten.tobytes() == np.ascontiguousarray(want[:, 3]).tobytes()):
            raise AssertionError("kitti_read_bin_native differs from obs/kitti.py's reader")
    print(f"kitti_read_bin_native: {len(xyz)} points byte-equal to obs/kitti.py's reader")
    print(f"grid and native phase: {time.perf_counter() - t_phase:.1f} s")


def main() -> int:
    if not (REPO / "mola_fe_lidar_tpu_torch" / "csrc").is_dir():
        return fail(f"the port (mola_fe_lidar_tpu_torch) is not beside {__file__}")
    import torch
    if not torch.cuda.is_available():
        return fail("torch.cuda.is_available() is false: this script needs a CUDA card")
    sys.path.insert(0, str(REPO))
    device = torch.device("cuda", 0)
    t_start = time.perf_counter()

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    power = smi.stdout.strip().splitlines()[0]
    print(power)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")

    from mola_fe_lidar_tpu_torch.ops import cuda_build
    t0 = time.perf_counter()
    cuda_build.library()
    print(f"kernels built in {time.perf_counter() - t0:.1f} s "
          f"(nvcc {cuda_build.build_seconds:.1f} s)")
    lines, spills = ptxas_report(cuda_build.build_log)
    for line in lines:
        print("  ptxas:", line)
    if spills:
        return fail(f"ptxas reports spills in {spills}")

    rows = check_kernels(device)
    from mola_fe_lidar_tpu_torch.obs.hdl64 import hdl64_sequence
    t0 = time.perf_counter()
    obs, gt = hdl64_sequence(n_scans=N_SCANS, n_azimuth=2048)
    print(f"simulated {N_SCANS} HDL-64 scans ({len(obs[0]['xyz'])} rays each) "
          f"in {time.perf_counter() - t0:.1f} s")
    main_res, counts, by_shape, main_stats = replay(device, obs, gt)
    scan_step_forms(device, obs, gt, main_res, main_stats)
    checkpoint_round_trip(device, obs)
    lc_res, lc_counts, lc_by_shape = loop_closure(device, obs, gt)
    cli_by_shape = accuracy_tools(device, lc_res, obs, gt)
    mesh_counts, mesh_by_shape = mesh_phase(device, obs, gt, main_res, power)
    launched = {}
    for shapes, unit in ((by_shape, "scan"), (lc_by_shape, "scan (loop-closure phase)"),
                         (mesh_by_shape, "scan (mesh replay)")):
        for name, per_shape in shapes.items():
            for key, c in per_shape.items():
                launched.setdefault((name, key), (c, N_SCANS, unit))
    for key, val in pairwise(device).items():
        launched.setdefault(key, val)
    loc_shapes, loc_counts = localizer(device, obs, gt)
    for key, val in loc_shapes.items():
        launched.setdefault(key, val)
    for name, per_shape in cli_by_shape.items():
        for key, c in per_shape.items():
            launched.setdefault((name, key), (c, CLI_SCANS, "scan (runner CLI)"))
    # the localizer's unbatched searches against the 32k and 131k maps, and
    # the mesh replay's target slices
    single = {(name, key) for name, per_shape in by_shape.items() for key in per_shape}
    batched_rows = check_batched(device, launched, unbatched={
        key for key in loc_shapes if key[1][0] == 1 and key[1][2] >= 1 << 15} | {
        (name, key) for name, per_shape in mesh_by_shape.items() for key in per_shape
        if key[0] == 1 and (name, key) not in single})
    for row in rows:
        row["launches"] = counts[row["name"]]
        row["launches_lc_phase"] = lc_counts[row["name"]]
        row["launches_localizer_phase"] = loc_counts[row["name"]]
        row["launches_mesh_phase"] = mesh_counts[row["name"]]
        for shape in row["shapes"]:
            c, per, unit = launched.get(
                (row["name"], (1, shape["n"], shape["m"], shape["k"])), (0, N_SCANS, "scan"))
            shape.update(launches=c, per=unit, launches_per=c / per)
        row["shapes"] += batched_rows[row["name"]]
    grid_and_native(device, obs, gt, main_res)
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
