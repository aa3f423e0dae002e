"""The map as a dataclass of tensors (orb_slam_tpu/slam_map/)."""
