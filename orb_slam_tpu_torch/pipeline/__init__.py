"""Tracking and the extract-and-track chunk (orb_slam_tpu/pipeline/)."""
