#!/usr/bin/env python3
"""Time every launch plan of the port's k-NN kernels (K1/K2) at the main
path's shapes on one CUDA card, check each against the plain twin, and
split the chosen plan's time into its phases.

    python3 scripts/torch_knn_sweep.py [--out FILE]   # default: the package's build/knn_sweep.json

For each shape (the seven that ``chip_smoke.py`` measures) it runs every
compiled rows-per-thread R and portable cluster size through
``knn_kernel.launch`` (CUDA events over 20 launches after a warm-up, the
``chip_smoke.py`` method), checks the output bit for bit against
``ops/matching.py``, and prints the plans from the fastest beside the one
that ``plan_launch`` picks. Then, at the picked plan, it times as CUDA
graphs the whole kernel and two builds of the same source that stop early
(``-DMOLA_KNN_PHASES``): staging and merge without the scan, and the merge
alone. Their differences are the scan's, the staging's and the fixed
(launch, list write, cluster sync, merge) shares of the kernel time. The
JSON file holds every timing.
"""

from __future__ import annotations

import argparse
import itertools
import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent

SHAPES = [  # (k, n sources, m targets); k = 1 is K2
    (4, 8192, 32768), (8, 2048, 8192), (5, 2048, 8192), (5, 2048, 2048),
    (1, 1024, 32768), (1, 8192, 32768), (1, 8192, 8192)]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=str(REPO / "mola_fe_lidar_tpu_torch" / "build"
                                         / "knn_sweep.json"))
    ap.add_argument("--k", type=int, nargs="*", help="only the shapes of these k")
    ap.add_argument("--stage", type=int, nargs="*",
                    help="staging budgets in targets a block (default: the wrapper's)")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("torch_knn_sweep: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    from chip_smoke import cuda_ms, graph_ms, make_cloud
    from mola_fe_lidar_tpu_torch.ops import cuda_build, knn_kernel, matching

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "unknown"
    print(card)
    dev = torch.device("cuda", 0)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    gen = torch.Generator().manual_seed(0)
    # the timing builds: 2 = staging and merge, 1 = merge alone
    phase_libs = {p: cuda_build.load(cuda_build.build((f"-DMOLA_KNN_PHASES={p}",)))
                  for p in (2, 1)}

    report = {"card": card, "sm_count": sms, "shapes": []}
    for k, n, m in SHAPES:
        if args.k and k not in args.k:
            continue
        src, sm = make_cloud(gen, n, 0.95, dev)
        tgt, tm = make_cloud(gen, m, 0.9, dev)
        want = (matching.nearest_neighbors(src, sm, tgt, tm) if k == 1
                else matching.knn(src, sm, tgt, tm, k))
        shape_dims = (n,) if k == 1 else (n, k)
        dist = torch.empty(shape_dims, dtype=torch.float32, device=dev)
        idx = torch.empty(shape_dims, dtype=torch.int32, device=dev)
        chosen = knn_kernel.plan_launch(n, m, k, sms)
        rows = []
        for r, c, stage in itertools.product(
                knn_kernel.ROWS, knn_kernel.CLUSTERS, args.stage or [knn_kernel.STAGE_TARGETS]):
            plan = knn_kernel.make_plan(n, m, k, r, c, stage)
            run = lambda: knn_kernel.launch(src, sm, tgt, tm, k, plan, dist, idx)
            run()
            torch.cuda.synchronize()
            exact = bool(torch.equal(dist, want.dist) and torch.equal(idx, want.idx))
            rows.append({"rows": r, "cluster": c, "stage": stage, "blocks": plan.blocks,
                         "parts": plan.parts, "part_len": plan.part_len, "chunk": plan.chunk,
                         "smem": plan.smem, "exact": exact, "ms": cuda_ms(run, reps=20),
                         "chosen": plan == chosen})
        rows.sort(key=lambda x: x["ms"])
        pick = next((x for x in rows if x["chosen"]), None)
        pick = pick["ms"] if pick else float("nan")
        print(f"k={k} {n}x{m}: plan_launch picks R={chosen.rows} C={chosen.cluster} "
              f"{pick:.4f} ms; all exact: {all(x['exact'] for x in rows)}")
        for x in rows:
            print(f"   R={x['rows']} C={x['cluster']} S={x['stage']} blocks={x['blocks']:4d} "
                  f"parts={x['parts']:2d} len={x['part_len']:5d} {x['ms']:.4f} ms"
                  + ("  <- plan_launch" if x["chosen"] else ""))
        # phases of the chosen plan, each as a CUDA graph (no host gaps)
        phases = {}
        for name, lib in (("all", None), ("stage+merge", phase_libs[2]),
                          ("merge", phase_libs[1])):
            phases[name] = graph_ms(
                lambda: knn_kernel.launch(src, sm, tgt, tm, k, chosen, dist, idx, lib))
        total = phases["all"]
        shares = {"scan": (total - phases["stage+merge"]) / total,
                  "stage": (phases["stage+merge"] - phases["merge"]) / total,
                  "merge+fixed": phases["merge"] / total}
        print("   phases (graph ms): " + ", ".join(f"{a} {b:.4f}" for a, b in phases.items())
              + "; shares: " + ", ".join(f"{a} {100 * b:.1f} %" for a, b in shares.items()))
        report["shapes"].append({"k": k, "n": n, "m": m, "plans": rows,
                                 "phases_graph_ms": phases, "phase_shares": shares})
        if not all(x["exact"] for x in rows):
            print("  NOT EXACT:", [x for x in rows if not x["exact"]])
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(report, indent=1))
    return 0 if all(x["exact"] for s in report["shapes"] for x in s["plans"]) else 1


if __name__ == "__main__":
    sys.exit(main())
