"""The fused extract-and-track chunk: the main path of the port.

Port of the body of orb_slam_tpu/pipeline/system.py:377-408
(`SLAMSystem._chunk_extract_track`'s scan step), which bench.py:83-109
also times: for each frame of a chunk, extract ORB features, undistort
them and track the frame against one map snapshot, chaining pose and
velocity through the motion model. The low-inlier retry is off
(retry=False), as there: the caller re-enters at a weak frame. Nothing in
the loop waits for the device. `span`, where given, names the parts of
the chunk for the caller's tracer: `chunk.extract` and `chunk.track` once
per frame, `chunk.stack` for the results.
"""

from __future__ import annotations

import contextlib

import torch

from orb_slam_tpu_torch.frontend.orb_extractor import ORBExtractor, ORBFeatures
from orb_slam_tpu_torch.geometry.camera import CameraModel, undistort_points
from orb_slam_tpu_torch.ops.matching import TH_HIGH
from orb_slam_tpu_torch.pipeline.track_kernels import (
    ChunkResult, chunk_track_step,
)
from orb_slam_tpu_torch.slam_map.map_state import MapState


def extract_track_chunk(imgs: torch.Tensor, extractor: ORBExtractor,
                        camera: CameraModel, state: MapState, pose0, vel0, K,
                        pt_mask=None, *, p_local: int = 4096,
                        radius: float = 15.0, bounds=None,
                        min_inliers: int = 30, use_motion_model: bool = True,
                        max_dist: int = TH_HIGH, span=None):
    """imgs [B, H, W] float32 grayscale; pose0 / vel0 [4, 4] the pose of the
    frame before the chunk and the velocity entering it; K [3, 3]; span,
    if given, span(name) -> a context manager around each named part.

    Returns (features: ORBFeatures with a leading [B] axis on every field,
    xy_und [B, N, 2], ChunkResult)."""
    cfg = extractor.config
    span = span or (lambda name: contextlib.nullcontext())
    carry = (pose0, vel0)
    feats, xy_und, outs = [], [], []
    for img in imgs:
        with span("chunk.extract"):
            f = extractor(img)
            xy = undistort_points(camera, f.xy)
        with span("chunk.track"):
            carry, out = chunk_track_step(
                state, xy, f.desc_i32, f.octave, f.valid, carry, K, pt_mask,
                p_local=p_local, width=camera.width, height=camera.height,
                radius=radius, bounds=bounds, scale_factor=cfg.scale_factor,
                n_levels=cfg.n_levels, max_dist=max_dist,
                min_inliers=min_inliers, use_motion_model=use_motion_model,
                retry=False)
        feats.append(f)
        xy_und.append(xy)
        outs.append(out)
    with span("chunk.stack"):
        features = ORBFeatures(*(torch.stack([getattr(f, k) for f in feats])
                                 for k in ORBFeatures.__dataclass_fields__))
        chunk = ChunkResult(*(torch.stack(v) for v in zip(*outs)))
        return features, torch.stack(xy_und), chunk
