"""See the module of the same name in ``mola_fe_lidar_tpu``."""
from .config import Matcher, Solver, Quality, PairWeights, ICPParams, AlignKind
from .icp import ICPResult, align, align_pipeline, TERM_CONVERGED, TERM_MAX_ITERS
from .presets import (
    icp_settings_regular, icp_settings_loop_closure, icp_cases_kitti,
    icp_coarse_to_fine, icp_pyramid_3level,
)

__all__ = [
    "Matcher", "Solver", "Quality", "PairWeights", "ICPParams", "AlignKind",
    "ICPResult", "align", "align_pipeline", "TERM_CONVERGED", "TERM_MAX_ITERS",
    "icp_settings_regular", "icp_settings_loop_closure", "icp_cases_kitti",
    "icp_coarse_to_fine", "icp_pyramid_3level",
]
