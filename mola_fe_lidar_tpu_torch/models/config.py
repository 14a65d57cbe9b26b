"""ICP engine configuration — static, hashable dataclasses.

Mirrors the pluggable stage stack of the reference's mp2p_icp config
(reference params/icp-settings-regular.yaml: ``params`` / ``solvers`` /
``matchers`` / ``quality`` blocks, loaded at reference
src/LidarOdometry.cpp:57-88) as frozen dataclasses. A copy of
``mola_fe_lidar_tpu/models/config.py``, so both packages parse one YAML into
equal objects. The field comments are the reference's and describe its
backends: in this port every exact ``nn_backend`` is the same search (the
K1/K2 kernels, ``models/icp.py::_resolve_backend``) and ``"grid"`` is the
reference's voxel hash (``ops/grid_nn.py``).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Tuple


class AlignKind(enum.Enum):
    """The three ICP cases of the front-end (reference
    include/mola-fe-lidar/LidarOdometry.h:45-50 and the per-case param sets
    at src/LidarOdometry.cpp:122-128)."""

    LIDAR_ODOMETRY = "lidar_odometry"   # consecutive scans, twist prior
    NEARBY_ALIGN = "nearby_align"       # non-adjacent keyframes
    LOOP_CLOSURE = "loop_closure"       # Monte-Carlo perturbed wide search


@dataclass(frozen=True)
class Matcher:
    """One correspondence stage (reference Matcher_Point2Plane block,
    params/icp-settings-regular.yaml:32-39).

    kinds:
      - ``point2point``          1-NN pairing
      - ``point2plane_knn``      kNN neighborhood eigen-fit per iteration
                                 (reference-parity behavior)
      - ``point2plane_normals``  1-NN + precomputed target normals/planarity
                                 attrs (fast path; normals from the filter
                                 pipeline's voxel eigenanalysis)
    ``run_up_to_iteration == 0`` means "no upper bound", matching the
    reference convention (runFromIteration/runUpToIteration).
    """

    kind: str = "point2point"
    src_layer: str = "raw"
    tgt_layer: str = "raw"
    distance_threshold: float = 0.70
    knn: int = 6
    plane_eigen_threshold: float = 0.07
    run_from_iteration: int = 0
    run_up_to_iteration: int = 0
    # kNN backend for point2plane_knn: approx_min_k (TPU top-k unit, ~95%
    # recall) wins at every size on v5e (docs/nn_crossover.json) and is the
    # default; exact (approx_knn=False) routes to the fused Pallas kNN on
    # TPU (the scan-merge XLA path takes minutes to compile at >=8k points)
    # and to the exact scan-merge on CPU. Exact is forced under tensor
    # parallelism.
    approx_knn: bool = True
    # 1-NN backend: "auto" resolves by measured IN-LOOP crossover
    # (docs/nn_crossover.json loop10 columns; models/icp.py::
    # _resolve_backend): on TPU, "fused" — the distance expansion fused
    # into `lax.approx_min_k` (MXU cross term at HIGHEST precision, no
    # [N, M] materialization; recall@1 measured 1.0 at 8k/32k, distances
    # carry ~1e-3 m cancellation noise) — wins at every size and under
    # vmap, where both the Pallas kernels and the XLA tiled scan
    # serialize. CPU always XLA (exact tiled scan). The voxel-hash "grid"
    # is gather-bound and loses to brute force on TPU at all sizes, kept
    # for radius-limited semantics. "mxu" runs the bf16x3 cross-term
    # candidate pass on the MXU and re-scores the top candidates exactly
    # in f32 difference form (ops/matching.py::knn_mxu) — ~2-6x slower
    # in-loop than "fused" but exact (recall >= 0.999): use it where
    # exactness is consumed sparsely (candidate-cache refreshes, map
    # localization). Explicit: "fused", "xla", "pallas", "grid", "mxu".
    nn_backend: str = "auto"
    # Candidate-cached matching (1-NN kinds only: point2point /
    # point2plane_normals). 0 = off (full NN every iteration, reference
    # behavior). K > 0: every ``ICPParams.cand_refresh`` outer iterations
    # the matcher refreshes a per-source top-K candidate list (TPU top-k
    # unit via approx_min_k); in-between iterations re-argmin over those K
    # gathered candidates — O(N*K) instead of O(N*M) — which preserves the
    # local reassignment that drives late-iteration descent. Ignored under
    # tensor parallelism (shard_axis).
    cand_k: int = 0


@dataclass(frozen=True)
class PairWeights:
    """Pairing-weight options (reference ``pairingsWeightParameters``,
    params/icp-settings-regular.yaml:14-21)."""

    use_scale_outlier_detector: bool = True
    scale_outlier_threshold: float = 1.1
    use_robust_kernel: bool = False
    robust_kernel: str = "cauchy"
    robust_kernel_param: float = 0.1
    # kernel sharpening: residuals are pre-scaled by sqrt(scale) (for
    # Cauchy: 1/(1 + scale*(r/param)^2), the reference knob's algebra).
    # Default 1.0 = nominal width; reference-shaped YAMLs load their own
    # value (the reference files ship 400.0, frontend/icp_config.py:67).
    robust_kernel_scale: float = 1.0


@dataclass(frozen=True)
class Solver:
    """Solver stage (reference Solver_GaussNewton, maxIterations: 20)."""

    kind: str = "gauss_newton"  # or "horn" (closed-form point-to-point)
    max_iterations: int = 20
    damping: float = 1e-6
    # Weak MAP prior anchoring the solve to the initial guess (0 = off).
    # Pins near-degenerate directions (corridor along-track slide) to the
    # motion model; data dominates everywhere else. GN only — the
    # closed-form horn/olae solvers ignore it.
    prior_sigma_trans: float = 0.0  # [m]
    prior_sigma_rot: float = 0.0    # [rad]


@dataclass(frozen=True)
class Quality:
    """Quality stage (reference QualityEvaluator_PairedRatio @ 0.10 m)."""

    kind: str = "paired_ratio"
    threshold_distance: float = 0.10
    src_layer: str = "raw"
    tgt_layer: str = "raw"
    # Evaluate the ratio on a fixed hash-decorrelated subsample of the
    # source layer (0 = every point). paired_ratio is a mask-weighted MEAN
    # over source points, so a uniform subsample is an unbiased estimator
    # (±~1/sqrt(n) absolute error: 8192 samples ≈ ±0.01 on a 0.7 ratio) —
    # while the 1-NN under it is the align's single most expensive fixed
    # op at map capacities (measured ~48 ms of a 233 ms 32k-cap align).
    # The subsample is an index PERMUTATION chosen at trace time, never a
    # [:n] slab (clouds are spatially ordered).
    max_points: int = 0
    # Multi-evaluator combination (mp2p_icp runs a weighted mean over its
    # quality evaluators): overall quality = Σ wᵢqᵢ / Σ wᵢ. weight=0
    # evaluators contribute nothing to the mean but still evaluate —
    # useful together with required_min.
    weight: float = 1.0
    # Conjunctive gate: if THIS evaluator's ratio falls below
    # required_min, the overall quality is forced to 0 (align rejected)
    # regardless of the weighted mean. Discriminative-layer loop-closure
    # verification: a street-lattice-aliased "rival basin" alignment
    # pairs ground/facade points freely (decimated ratio ~0.4–0.55) but
    # pairs almost NO sparse vertical structure (edges ratio ≤ 0.06 vs
    # ≥ 0.13 at the true pose — measured, scripts/diag_lc.py), so
    # requiring a minimum edges ratio rejects exactly the aliased
    # basins the reference's goodness-only gate cannot see
    # (reference src/LidarOdometry.cpp:809-816 + TODO'd check :891).
    required_min: float = 0.0
    # Evaluate the ratio in BOTH directions (src→tgt under pose and
    # tgt→src under pose⁻¹) and keep the max. Loop-closure viewpoint
    # pairs are occlusion-asymmetric — each scan sees structure the
    # other doesn't, so one direction's ratio can collapse on a correct
    # alignment while aliased (wrong-basin) alignments collapse in BOTH
    # directions (measured, scripts/diag_lc.py). Costs one extra NN
    # pass over this evaluator's layers.
    symmetric: bool = False


@dataclass(frozen=True)
class ICPParams:
    """One full ICP case (reference mp2p_icp::Parameter block:
    maxIterations: 100, minAbsStep_trans: 5e-5, minAbsStep_rot: 1e-5)."""

    max_iterations: int = 100
    min_abs_step_trans: float = 5e-5
    min_abs_step_rot: float = 1e-5
    matchers: Tuple[Matcher, ...] = (Matcher(),)
    solver: Solver = field(default_factory=Solver)
    quality: Tuple[Quality, ...] = (Quality(),)
    weights: PairWeights = field(default_factory=PairWeights)
    nn_tile: int = 512
    # Refresh period (outer iterations) for candidate-cached matchers
    # (any Matcher with cand_k > 0). The align loop becomes two-level:
    # refresh candidates, then cand_refresh cheap re-argmin iterations.
    cand_refresh: int = 4
    # Motion-conditional refresh: skip a block-head candidate refresh when
    # the pose has moved less than these thresholds since the LAST refresh
    # (translation [m] / rotation [rad]; 0 = always refresh, the fixed
    # cadence above). Regime-dependent: for sharp-prior queries that
    # re-argmin among near-ties (MapLocalizer) it cuts latency ~20 % with
    # per-query identical poses, but on the scan-to-map odometry crawl the
    # refreshes ARE the candidate-recruiting step and skipping them costs
    # 47-80 % ATE for <=5 % step savings (docs/accuracy.md ablation) — keep
    # 0 there. Unbatched aligns take a real `lax.cond` branch; under vmap
    # the cond lowers to select (both branches execute), so leave these at
    # 0 for batched stages.
    cand_refresh_min_trans: float = 0.0
    cand_refresh_min_rot: float = 0.0
    # Anderson acceleration (AA-ICP, arXiv:1709.05479): treat the outer
    # match→solve iteration as a fixed-point map on the SE(3) tangent chart
    # at the initial guess and extrapolate from the last `anderson_m`
    # iterates (type-II AA, regularized least squares over the residual
    # differences). 0 = off (plain Picard iteration, reference behavior).
    # Safeguard: each accelerated iterate is accepted provisionally and
    # REVERTED to the stored plain Picard step (history reset) if its
    # Picard residual blows past `anderson_reset_ratio`x the best seen or
    # goes non-finite (match reassignment makes the map non-smooth; a
    # step-length cap would instead forbid acceleration on slow
    # contractions where the distance to the fixed point is
    # fnorm/(1-rate) >> fnorm). AA is also disabled when the chart
    # rotation ||log||_rot exceeds pi/2 — se3.log is discontinuous near
    # angle pi and history differences must not cross the chart cut. Only
    # worth turning on for slow (e.g. heavily damped) contractions; the
    # undamped GN+MAP map converges in a handful of outer iterations on
    # its own. Incompatible with candidate-cached matchers (cand_k > 0) —
    # the cache's block structure already amortizes the per-iteration cost
    # that AA would skip.
    anderson_m: int = 0
    anderson_reset_ratio: float = 2.0
    # When set, the engine runs tensor-parallel: target clouds are sharded
    # on the point axis over this mesh axis name (use inside shard_map —
    # see parallel.distributed). None = single-device semantics.
    shard_axis: str | None = None
