"""Host-side visual odometry: pose recovery, trajectory, camera HAL
(`pytorch_model/vo/`, SURVEY.md §2.9)."""

from .pose import (
    CameraIntrinsics,
    estimate_pose_ransac,
    recover_pose,
    triangulate_points,
    compose_transformation,
    transformation_to_matrix,
    matrix_to_transformation,
)
from .trajectory import Trajectory
from .camera import (
    BaseCamera,
    OpenCVCamera,
    RealSenseCamera,
    OrbbecCamera,
    OAKCamera,
    create_camera,
)

__all__ = [
    "CameraIntrinsics",
    "estimate_pose_ransac",
    "recover_pose",
    "triangulate_points",
    "compose_transformation",
    "transformation_to_matrix",
    "matrix_to_transformation",
    "Trajectory",
    "BaseCamera",
    "OpenCVCamera",
    "RealSenseCamera",
    "OrbbecCamera",
    "OAKCamera",
    "create_camera",
]
