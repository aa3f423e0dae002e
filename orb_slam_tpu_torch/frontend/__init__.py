"""Feature extraction front end (port of orb_slam_tpu/frontend/, whose
`__init__.py`:3 re-exports these names)."""

from orb_slam_tpu_torch.frontend.orb_extractor import ORBExtractor, ORBFeatures
