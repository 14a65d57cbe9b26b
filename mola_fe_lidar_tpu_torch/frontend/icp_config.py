"""Convert mp2p_icp-style YAML ICP configs into :class:`ICPParams`.

Accepts the reference's file shape (reference
params/icp-settings-regular.yaml: ``icp_class`` + ``params`` + ``solvers`` +
``matchers`` + ``quality`` blocks, loaded by ``load_icp_set_of_params`` at
reference src/LidarOdometry.cpp:57-88) with both fully-qualified
(``mp2p_icp::Matcher_Point2Plane``) and short class names.
"""

from __future__ import annotations

from typing import Any, Dict

from ..models.config import ICPParams, Matcher, PairWeights, Quality, Solver

_MATCHER_KINDS = {
    "Matcher_Point2Plane": "point2plane_knn",
    "Matcher_Point2Plane_Normals": "point2plane_normals",
    "Matcher_Point2Line": "point2line_knn",
    "Matcher_Points_DistanceThreshold": "point2point",
    "Matcher_Points": "point2point",
    # native names pass through
    "point2point": "point2point",
    "point2plane_knn": "point2plane_knn",
    "point2plane_normals": "point2plane_normals",
    "point2line_knn": "point2line_knn",
}

_SOLVER_KINDS = {
    "Solver_GaussNewton": "gauss_newton",
    "Solver_Horn": "horn",
    "Solver_OLAE": "olae",  # linear CGR attitude solve (solve/olae.py)
    "gauss_newton": "gauss_newton",
    "horn": "horn",
    "olae": "olae",
}

_QUALITY_KINDS = {
    "QualityEvaluator_PairedRatio": "paired_ratio",
    "paired_ratio": "paired_ratio",
}


def _short(name: str) -> str:
    return name.split("::")[-1]


def icp_stages_from_config(cfg) -> tuple:
    """An ICP case may be ONE stage (dict) or a coarse-to-fine LIST of
    stages — the reference documents ``ICP_case`` as "a vector of ICP
    stages, to be run as a sequence of coarser to finer detail"
    (reference include/mola-fe-lidar/LidarOdometry.h:92-99)."""
    if isinstance(cfg, (list, tuple)):
        return tuple(icp_params_from_config(c) for c in cfg)
    return (icp_params_from_config(cfg),)


def icp_params_from_config(cfg: Dict[str, Any]) -> ICPParams:
    p = cfg.get("params", {}) or {}
    w = p.get("pairingsWeightParameters", {}) or {}
    weights = PairWeights(
        use_scale_outlier_detector=bool(w.get("use_scale_outlier_detector", False)),
        scale_outlier_threshold=float(w.get("scale_outlier_threshold", 1.1)),
        use_robust_kernel=bool(w.get("use_robust_kernel", False)),
        robust_kernel=str(w.get("robust_kernel", "cauchy")),
        robust_kernel_param=float(w.get("robust_kernel_param", 0.1)),
        robust_kernel_scale=float(w.get("robust_kernel_scale", 400.0)),
    )

    matchers = []
    for m in cfg.get("matchers", []) or []:
        kind = _MATCHER_KINDS.get(_short(m["class"]))
        if kind is None:
            raise KeyError(f"unknown matcher class {m['class']!r}")
        mp = m.get("params", {}) or {}
        matchers.append(Matcher(
            kind=kind,
            src_layer=str(mp.get("src_layer", mp.get("pointLayerMatches", "raw"))),
            tgt_layer=str(mp.get("tgt_layer", mp.get("pointLayerMatches", "raw"))),
            distance_threshold=float(mp.get("distanceThreshold", 0.70)),
            knn=int(mp.get("knn", 6)),
            plane_eigen_threshold=float(mp.get("planeEigenThreshold", 0.07)),
            run_from_iteration=int(mp.get("runFromIteration", 0)),
            run_up_to_iteration=int(mp.get("runUpToIteration", 0)),
            cand_k=int(mp.get("candidateCacheK", 0)),
        ))
    if not matchers:
        matchers.append(Matcher())

    solver = Solver()
    solvers_cfg = cfg.get("solvers", []) or []
    if solvers_cfg:
        s = solvers_cfg[0]
        kind = _SOLVER_KINDS.get(_short(s["class"]))
        if kind is None:
            raise KeyError(f"unknown solver class {s['class']!r}")
        sp = s.get("params", {}) or {}
        solver = Solver(
            kind=kind, max_iterations=int(sp.get("maxIterations", 20)),
            prior_sigma_trans=float(sp.get("priorSigmaTrans", 0.0)),
            prior_sigma_rot=float(sp.get("priorSigmaRot", 0.0)))

    qualities = []
    for q in cfg.get("quality", []) or []:
        kind = _QUALITY_KINDS.get(_short(q["class"]))
        if kind is None:
            raise KeyError(f"unknown quality class {q['class']!r}")
        qp = q.get("params", {}) or {}
        qualities.append(Quality(
            kind=kind,
            threshold_distance=float(qp.get("thresholdDistance", 0.10)),
            src_layer=str(qp.get("src_layer", matchers[0].src_layer)),
            tgt_layer=str(qp.get("tgt_layer", matchers[0].tgt_layer)),
            weight=float(qp.get("weight", 1.0)),
            required_min=float(qp.get("requiredMin", 0.0)),
            symmetric=bool(qp.get("symmetric", False)),
        ))
    if not qualities:
        qualities.append(Quality(src_layer=matchers[0].src_layer,
                                 tgt_layer=matchers[0].tgt_layer))
    if not any(q.weight > 0.0 or q.required_min > 0.0 for q in qualities):
        # all-zero weights with no gates would make _quality() return 1.0
        # unconditionally (models/icp.py::_quality) — a config typo (weight: 0
        # without requiredMin) would silently accept every align
        raise ValueError(
            "quality config has no evaluator with weight>0 or requiredMin>0 "
            "— every align would score a perfect 1.0; give at least one "
            "evaluator a positive weight or a requiredMin gate")

    return ICPParams(
        max_iterations=int(p.get("maxIterations", 100)),
        min_abs_step_trans=float(p.get("minAbsStep_trans", 5e-5)),
        min_abs_step_rot=float(p.get("minAbsStep_rot", 1e-5)),
        cand_refresh=int(p.get("candidateCacheRefresh", 4)),
        cand_refresh_min_trans=float(p.get("candidateCacheMinMotionTrans", 0.0)),
        cand_refresh_min_rot=float(p.get("candidateCacheMinMotionRot", 0.0)),
        matchers=tuple(matchers),
        solver=solver,
        quality=tuple(qualities),
        weights=weights,
    )
