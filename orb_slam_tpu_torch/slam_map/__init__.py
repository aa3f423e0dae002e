"""The map as a dataclass of tensors (port of orb_slam_tpu/slam_map/,
whose `__init__.py`:10-16 re-exports these names)."""

from orb_slam_tpu_torch.slam_map.map_state import MapState, MapConfig, empty_map
from orb_slam_tpu_torch.slam_map.covisibility import (
    incidence_matrix, covisibility_weights, observation_counts,
)
from orb_slam_tpu_torch.slam_map.observations import (
    flatten_observations, refresh_point_stats,
)
