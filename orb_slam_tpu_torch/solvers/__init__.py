"""Two-view initialisation, pose optimization (kernel K2), local BA, EPnP,
Sim3 and the essential graph (port of orb_slam_tpu/solvers/, whose
`__init__.py`:9-10 re-exports these names)."""

from orb_slam_tpu_torch.solvers.two_view import TwoViewResult, initialize_two_view
from orb_slam_tpu_torch.solvers.pose_opt import pose_optimize
