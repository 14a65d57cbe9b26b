"""See the module of the same name in ``mola_fe_lidar_tpu``."""
from .se3 import (
    Pose,
    identity,
    exp,
    log,
    compose,
    inverse,
    transform,
    relative_to,
    from_matrix,
    to_matrix,
    from_xyz_ypr,
    to_xyz_ypr,
    rotation_log,
    rotation_angle,
    translation_norm,
)
from .pdf import PosePDF, pdf_from_pose
from .twist import Twist, twist_from_delta, propagate_pose, twist_zero

__all__ = [
    "Pose", "identity", "exp", "log", "compose", "inverse", "transform",
    "relative_to", "from_matrix", "to_matrix", "from_xyz_ypr", "to_xyz_ypr",
    "rotation_log", "rotation_angle", "translation_norm",
    "PosePDF", "pdf_from_pose",
    "Twist", "twist_from_delta", "propagate_pose", "twist_zero",
]
