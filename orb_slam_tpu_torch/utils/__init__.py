"""Event log and stage timing (port of orb_slam_tpu/utils/, whose
`__init__.py`:3 re-exports these names)."""

from orb_slam_tpu_torch.utils.timing import StageTimer, trace_to
