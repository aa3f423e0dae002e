"""Feature extraction front end (orb_slam_tpu/frontend/)."""
