"""Event log and stage timing (port of orb_slam_tpu/utils/)."""
