"""orb_slam_tpu_torch: the PyTorch + CUDA port of orb_slam_tpu.

The JAX package `orb_slam_tpu/` stays the reference; this package holds
the part of it that is ported so far, module for module, and never imports
JAX. Ported: the extract-and-track main path, i.e. the body of
orb_slam_tpu/pipeline/system.py:377-408 (`_chunk_extract_track`) that
bench.py times: ORB extraction, undistortion and tracking against a fixed
map snapshot, chained through the motion model over a chunk of frames;
with it the whole ORB extraction layer: FAST or Harris (nScoreType=0)
ranking, the stacked and the per-level extractor, the cell-fused
detector, and the settings file that selects them; local mapping; the
two-view initialisation with the tracking recovery ladder, so that
`pipeline/system.py::SLAMSystem` runs from raw frames; and place
recognition with relocalisation, so that a lost frame is recovered
against the keyframe database; loop closing; and the product around the
system: the three-thread AsyncSLAMSystem, sessions, datasets, viz and the
command line.

Layout (each subpackage mirrors its JAX counterpart):
  ops/        FAST, Harris, pyramid, selection, descriptors, matching;
              kernels K1 (fast_score_nms), K3 (fast_score_rect), K4
              (fast_cell_topk)
  frontend/   ORBExtractor (an nn.Module)
  geometry/   SO3/SE3 maps, quaternions, camera model, triangulation,
              Horn's Sim3
  slam_map/   MapState (a dataclass of tensors), covisibility, observations,
              sessions (serialization.py, the JAX package's file format)
  solvers/    pose-only Gauss-Newton (kernel K2), local BA, two-view
              initialisation, EPnP and its batched RANSAC
  place/      vocabulary tree (transform, BoW vectors, L1 score, training,
              npz and DBoW2 text files), the shipped vocabulary, the
              keyframe database and its candidate queries
  native/     the host C++ DBoW2 text parser, built with g++ at first use
  pipeline/   per-frame tracking, the fused extract+track chunk, mapping
              kernels, loop closing, the SLAMSystem and the threaded
              AsyncSLAMSystem (async_system.py)
  io/         numpy-only synthetic scene, settings files, trajectories,
              image-directory and video datasets, the frame overlay and
              map plot
  utils/      the SLAM_DEBUG event log, the stage timer, profiler traces
  cli.py      `run` and `eval` (python -m orb_slam_tpu_torch.cli)
  csrc/       the hand-written CUDA kernels, built by _build.py
  device.py   the default device of the entry points: the CUDA card

Every kernel wrapper launches its CUDA kernel for a CUDA tensor and runs
its plain PyTorch version only for a CPU tensor. Every entry point that
builds tensors builds them on the card unless told otherwise.
"""

__version__ = "0.1.0"
