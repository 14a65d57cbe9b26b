"""ICP presets (port of ``mola_fe_lidar_tpu/models/presets.py``).

``icp_settings_regular`` is the reference's params/icp-settings-regular.yaml
(100 iterations, steps 5e-5 m / 1e-5 rad, kNN = 6 point-to-plane at 0.70 m
with plane eigen-threshold 0.07, Gauss-Newton with 20 inner iterations,
paired-ratio quality at 0.10 m, the scale-outlier gate at 1.1);
``icp_settings_loop_closure`` is the loop-closure file, whose content is the
same. ``icp_coarse_to_fine`` and ``icp_pyramid_3level`` are stage tuples
for ``models.align_pipeline``; ``icp_cases_kitti`` keys the three align
cases of the front-end.
"""

from __future__ import annotations

from typing import Dict

from .config import AlignKind, ICPParams, Matcher, PairWeights, Quality, Solver


def icp_settings_regular(src_layer: str = "raw", tgt_layer: str = "raw",
                         matcher_kind: str = "point2plane_knn") -> ICPParams:
    return ICPParams(
        max_iterations=100,
        min_abs_step_trans=5e-5,
        min_abs_step_rot=1e-5,
        matchers=(Matcher(kind=matcher_kind, src_layer=src_layer, tgt_layer=tgt_layer,
                          distance_threshold=0.70, knn=6, plane_eigen_threshold=0.07),),
        solver=Solver(kind="gauss_newton", max_iterations=20),
        quality=(Quality(kind="paired_ratio", threshold_distance=0.10,
                         src_layer=src_layer, tgt_layer=tgt_layer),),
        weights=PairWeights(use_scale_outlier_detector=True, scale_outlier_threshold=1.1,
                            use_robust_kernel=False),
    )


def icp_settings_loop_closure(src_layer: str = "raw", tgt_layer: str = "raw",
                              matcher_kind: str = "point2plane_knn") -> ICPParams:
    return icp_settings_regular(src_layer, tgt_layer, matcher_kind)


def icp_coarse_to_fine(tgt_layer: str = "raw", src_layer: str = "raw",
                       coarse_threshold: float = 5.0, fine_threshold: float = 1.0):
    """A short wide point-to-point Horn stage that rescues poor guesses,
    then a point-to-plane (target normals) polish."""
    coarse = ICPParams(
        max_iterations=10,
        matchers=(Matcher(kind="point2point", src_layer=src_layer, tgt_layer=tgt_layer,
                          distance_threshold=coarse_threshold),),
        solver=Solver(kind="horn"),
        quality=(Quality(src_layer=src_layer, tgt_layer=tgt_layer),),
        weights=PairWeights(use_scale_outlier_detector=False),
    )
    fine = ICPParams(
        max_iterations=30,
        matchers=(Matcher(kind="point2plane_normals", src_layer=src_layer,
                          tgt_layer=tgt_layer, distance_threshold=fine_threshold),),
        solver=Solver(kind="gauss_newton", max_iterations=10),
        quality=(Quality(src_layer=src_layer, tgt_layer=tgt_layer),),
        weights=PairWeights(use_scale_outlier_detector=False),
    )
    return (coarse, fine)


def icp_pyramid_3level(tgt_layer: str = "raw", src_layer: str = "raw"):
    """Very wide point-to-point, mid point-to-point, fine point-to-plane."""
    def stage(thresh, iters, kind, solver):
        return ICPParams(
            max_iterations=iters,
            matchers=(Matcher(kind=kind, src_layer=src_layer, tgt_layer=tgt_layer,
                              distance_threshold=thresh),),
            solver=solver,
            quality=(Quality(src_layer=src_layer, tgt_layer=tgt_layer),),
            weights=PairWeights(use_scale_outlier_detector=False),
        )

    return (stage(10.0, 8, "point2point", Solver(kind="horn")),
            stage(3.0, 10, "point2point", Solver(kind="horn")),
            stage(1.0, 25, "point2plane_normals", Solver(kind="gauss_newton", max_iterations=10)))


def icp_cases_kitti(src_layer: str = "raw", tgt_layer: str = "raw",
                    matcher_kind: str = "point2plane_knn") -> Dict[AlignKind, ICPParams]:
    """The front-end's three align cases (odometry with and without a
    velocity prior, loop closure)."""
    return {
        AlignKind.LIDAR_ODOMETRY: icp_settings_regular(src_layer, tgt_layer, matcher_kind),
        AlignKind.NEARBY_ALIGN: icp_settings_regular(src_layer, tgt_layer, matcher_kind),
        AlignKind.LOOP_CLOSURE: icp_settings_loop_closure(src_layer, tgt_layer, matcher_kind),
    }
