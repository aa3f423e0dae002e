"""Pose optimization (orb_slam_tpu/solvers/)."""
