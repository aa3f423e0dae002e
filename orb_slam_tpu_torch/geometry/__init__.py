"""SO3/SE3 maps and the camera model (orb_slam_tpu/geometry/)."""
