"""MapState: the whole SLAM map as one dataclass of fixed-shape tensors.

Port of orb_slam_tpu/slam_map/map_state.py: `MapConfig` (:18-32),
`MapState` (:35-98), `empty_map` (:101-125), `insert_keyframe` (:128-144)
and `add_points` (:147-174). Slot pools with validity masks, as in JAX.
The update functions return a new MapState whose changed fields are new
tensors, so a state a caller holds never changes under it. Descriptors
are int32 bit patterns of the JAX uint32 words.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

from orb_slam_tpu_torch.device import require_device


@dataclass(frozen=True)
class MapConfig:
    """Static capacities."""

    max_keyframes: int = 256   # K
    max_points: int = 16384    # P
    n_features: int = 1000     # N per keyframe
    n_levels: int = 8
    scale_factor: float = 1.2


@dataclass(frozen=True)
class MapState:
    """Keyframe fields [K, ...], point fields [P, ...] and graph fields, as
    documented field by field in orb_slam_tpu/slam_map/map_state.py:36-74."""

    kf_pose: torch.Tensor        # [K, 4, 4] f32 T_cw
    kf_valid: torch.Tensor       # [K] bool
    kf_frame_id: torch.Tensor    # [K] int32
    kf_xy: torch.Tensor          # [K, N, 2] f32 undistorted keypoints
    kf_octave: torch.Tensor      # [K, N] int32
    kf_angle: torch.Tensor       # [K, N] f32
    kf_desc: torch.Tensor        # [K, N, 8] int32 descriptor words
    kf_feat_valid: torch.Tensor  # [K, N] bool
    kf_obs: torch.Tensor         # [K, N] int32 point id per feature, -1 none
    pt_pos: torch.Tensor         # [P, 3] f32 world position
    pt_valid: torch.Tensor       # [P] bool
    pt_desc: torch.Tensor        # [P, 8] int32 descriptor words
    pt_normal: torch.Tensor      # [P, 3] f32 mean viewing direction
    pt_min_dist: torch.Tensor    # [P] f32
    pt_max_dist: torch.Tensor    # [P] f32
    pt_ref_kf: torch.Tensor      # [P] int32
    pt_first_kf: torch.Tensor    # [P] int32
    pt_visible: torch.Tensor     # [P] int32
    pt_found: torch.Tensor       # [P] int32
    spanning_parent: torch.Tensor  # [K] int32, -1 for the root
    loop_edges: torch.Tensor     # [K, 8] int32, -1 empty

    def replace(self, **fields) -> "MapState":
        return dataclasses.replace(self, **fields)


def empty_map(cfg: MapConfig, device="cuda") -> MapState:
    """An empty map on `device` (the card unless the caller names another)."""
    device = require_device(device)
    K, P, N = cfg.max_keyframes, cfg.max_points, cfg.n_features
    i32, f32 = torch.int32, torch.float32

    def full(shape, v, dtype):
        return torch.full(shape, v, dtype=dtype, device=device)

    return MapState(
        kf_pose=torch.eye(4, dtype=f32, device=device).repeat(K, 1, 1),
        kf_valid=full((K,), False, torch.bool),
        kf_frame_id=full((K,), -1, i32),
        kf_xy=full((K, N, 2), 0.0, f32),
        kf_octave=full((K, N), 0, i32),
        kf_angle=full((K, N), 0.0, f32),
        kf_desc=full((K, N, 8), 0, i32),
        kf_feat_valid=full((K, N), False, torch.bool),
        kf_obs=full((K, N), -1, i32),
        pt_pos=full((P, 3), 0.0, f32),
        pt_valid=full((P,), False, torch.bool),
        pt_desc=full((P, 8), 0, i32),
        pt_normal=full((P, 3), 0.0, f32),
        pt_min_dist=full((P,), 0.0, f32),
        pt_max_dist=full((P,), float("inf"), f32),
        pt_ref_kf=full((P,), -1, i32),
        pt_first_kf=full((P,), -1, i32),
        pt_visible=full((P,), 0, i32),
        pt_found=full((P,), 0, i32),
        spanning_parent=full((K,), -1, i32),
        loop_edges=full((K, 8), -1, i32),
    )


def _set(field: torch.Tensor, idx, value) -> torch.Tensor:
    out = field.clone()
    out[idx] = value
    return out


def insert_keyframe(state: MapState, slot: int, pose, frame_id, xy, octave,
                    angle, desc, feat_valid, obs, parent) -> MapState:
    """Write a keyframe into `slot` (KeyFrame ctor + Map::AddKeyFrame,
    KeyFrame.cc:30-54, Map.cc:38-44)."""
    return state.replace(
        kf_pose=_set(state.kf_pose, slot, pose),
        kf_valid=_set(state.kf_valid, slot, True),
        kf_frame_id=_set(state.kf_frame_id, slot, frame_id),
        kf_xy=_set(state.kf_xy, slot, xy),
        kf_octave=_set(state.kf_octave, slot, octave),
        kf_angle=_set(state.kf_angle, slot, angle),
        kf_desc=_set(state.kf_desc, slot, desc),
        kf_feat_valid=_set(state.kf_feat_valid, slot, feat_valid),
        kf_obs=_set(state.kf_obs, slot, obs),
        spanning_parent=_set(state.spanning_parent, slot, parent),
    )


def add_points(state: MapState, slots, positions, desc, ref_kf, first_kf,
               active) -> MapState:
    """Write new map points into `slots` ([M], unique); rows where `active`
    is False write nothing (MapPoint ctor + Map::AddMapPoint)."""
    slots = torch.as_tensor(slots, device=state.pt_pos.device).to(torch.int64)
    active = torch.as_tensor(active, device=slots.device)
    rows = slots[active]

    def put(field, values):
        values = torch.as_tensor(values, device=slots.device)
        return _set(field, rows, values[active].to(field.dtype)
                    if values.ndim else values)

    return state.replace(
        pt_pos=put(state.pt_pos, positions),
        pt_desc=put(state.pt_desc, desc),
        pt_valid=_set(state.pt_valid, rows, True),
        pt_ref_kf=put(state.pt_ref_kf, ref_kf),
        pt_first_kf=put(state.pt_first_kf, first_kf),
        pt_visible=_set(state.pt_visible, rows, 1),
        pt_found=_set(state.pt_found, rows, 1),
    )
