"""SO3/SE3/Sim3 maps, the camera model, triangulation and Horn's Sim3
(port of orb_slam_tpu/geometry/, whose `__init__.py`:10-25 re-exports
these names)."""

from orb_slam_tpu_torch.geometry.so3 import (
    so3_exp, so3_log, quat_to_rot, rot_to_quat, quat_mul, quat_normalize,
)
from orb_slam_tpu_torch.geometry.se3 import (
    se3_exp, se3_log, se3_compose, se3_inverse, se3_apply,
    se3_from_rt, se3_rotation, se3_translation, se3_identity,
)
from orb_slam_tpu_torch.geometry.sim3 import (
    sim3_exp, sim3_log, sim3_compose, sim3_inverse, sim3_apply,
    sim3_from_srt, sim3_identity, sim3_to_se3,
)
from orb_slam_tpu_torch.geometry.camera import (
    CameraModel, project, unproject, distort, undistort_points,
)
from orb_slam_tpu_torch.geometry.triangulation import (
    triangulate_dlt, depth_in_frame, parallax_cos,
)
from orb_slam_tpu_torch.geometry.horn import horn_sim3
