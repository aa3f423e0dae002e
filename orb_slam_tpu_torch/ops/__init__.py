"""Device ops of the port: FAST, pyramid, selection, descriptors, matching
(orb_slam_tpu/ops/)."""
