"""The benchmark of orb_slam_tpu_torch, the PyTorch and CUDA port: the
harness (`run.py`, `harness.py`), its configurations, traffic mixes,
metric readers and check limits by name, and the plain references that
decide `correct` (`reference/`). See README.md."""
