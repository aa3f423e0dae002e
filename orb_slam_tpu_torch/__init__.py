"""orb_slam_tpu_torch: the PyTorch + CUDA port of orb_slam_tpu.

The JAX package `orb_slam_tpu/` stays the reference; this package holds
the part of it that is ported so far, module for module, and never imports
JAX. Ported: the extract-and-track main path, i.e. the body of
orb_slam_tpu/pipeline/system.py:377-408 (`_chunk_extract_track`) that
bench.py times: ORB extraction, undistortion and tracking against a fixed
map snapshot, chained through the motion model over a chunk of frames.

Layout (each subpackage mirrors its JAX counterpart):
  ops/        FAST, pyramid, selection, descriptors, matching; kernel K1
  frontend/   ORBExtractor (an nn.Module)
  geometry/   SO3/SE3 maps, camera model
  slam_map/   MapState (a dataclass of tensors)
  solvers/    pose-only Gauss-Newton; kernel K2
  pipeline/   per-frame tracking and the fused extract+track chunk
  io/         numpy-only synthetic scene
  csrc/       the hand-written CUDA kernels, built by _build.py

Every kernel wrapper launches its CUDA kernel for a CUDA tensor and runs
its plain PyTorch version only for a CPU tensor.
"""

__version__ = "0.1.0"
