"""The multi-device mode: a mesh of devices and the sharded solvers over
it (port of orb_slam_tpu/parallel/).

`mesh.py` holds the `Mesh`, `make_mesh` and the three collectives every
sharded function goes through; `sharding.py` holds `sharded_ba_step`,
`sharded_hamming_argmin` and `sharded_ransac_best`. The whole sharded
bundle adjustment is `solvers/local_ba.bundle_adjust(mesh=...)`, which
`SlamConfig.mesh` turns on for every BA of the system.
"""

from orb_slam_tpu_torch.parallel.mesh import Mesh, make_mesh
from orb_slam_tpu_torch.parallel.sharding import (
    sharded_ba_step, sharded_hamming_argmin, sharded_ransac_best,
)

__all__ = ["Mesh", "make_mesh", "sharded_ba_step", "sharded_hamming_argmin",
           "sharded_ransac_best"]
