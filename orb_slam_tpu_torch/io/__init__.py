"""Synthetic data sources (orb_slam_tpu/io/)."""
