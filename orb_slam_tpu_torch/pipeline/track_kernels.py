"""Per-frame tracking against a fixed map snapshot.

Port of orb_slam_tpu/pipeline/track_kernels.py: `project_points`
(:38-44), `frustum_gate` (:47-88), `_track_body` as `track_frame`
(:91-222), `_prev_frame_ladder_body` as `track_prev_frame` (:225-337),
`ChunkResult` (:340-347), `chunk_track_step` (:404-444) and
`_track_chunk_body` as `track_chunk` (:350-401). `lax.scan` is a Python
loop and the low-inlier retry a plain `if`; the main path runs with
retry=False (track_kernels.py:414-418), which needs no host sync.

One step: project every map point under the predicted pose and gate it
(Frame::isInFrustum, src/Frame.cc:137-198), take the first p_local
visible slots, match them by Hamming distance inside a radius and octave
window, then optimize the pose on the matched rows (kernel K2 on a CUDA
device). The projections are f32 matmuls of f32 values: they need TF32
off, which is PyTorch's default for matmuls.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from orb_slam_tpu_torch.geometry.se3 import se3_inverse
from orb_slam_tpu_torch.ops.matching import TH_HIGH, match, window_gate
from orb_slam_tpu_torch.ops.sort import first_k_true
from orb_slam_tpu_torch.slam_map.map_state import MapState
from orb_slam_tpu_torch.solvers.pose_opt import pose_optimize


class TrackResult(NamedTuple):
    pose: torch.Tensor         # [4, 4] optimized T_cw
    obs: torch.Tensor          # [N] int32 point id per feature (-1 none)
    n_inliers: torch.Tensor    # int32
    n_matches: torch.Tensor    # int (pre-optimization matches)
    visible_inc: torch.Tensor  # [P] int32 (MapPoint::IncreaseVisible)
    found_inc: torch.Tensor    # [P] int32 (MapPoint::IncreaseFound)


class ChunkResult(NamedTuple):
    """Per-frame outputs of a chained tracking chunk (leading axis B)."""

    pose: torch.Tensor       # [B, 4, 4]
    obs: torch.Tensor        # [B, N] int32
    n_inliers: torch.Tensor  # [B] int32
    n_matches: torch.Tensor  # [B]
    visible: torch.Tensor    # [B, P] bool


def project_points(pt_pos, T_cw, K_mat):
    pc = pt_pos @ T_cw[:3, :3].T + T_cw[:3, 3]
    z = pc[:, 2]
    zs = torch.where(z.abs() < 1e-9, 1e-9, z)
    u = K_mat[0, 0] * pc[:, 0] / zs + K_mat[0, 2]
    v = K_mat[1, 1] * pc[:, 1] / zs + K_mat[1, 2]
    return torch.stack([u, v], -1), z


def frustum_gate(state: MapState, T_cw, K_mat, width, height,
                 view_cos_limit=0.5, scale_factor: float = 1.2,
                 n_levels: int = 8, bounds=None):
    """Frame::isInFrustum for every map point. Returns (visible [P],
    proj [P, 2], pred_level [P] int64, dist [P]). bounds = undistorted
    (min_x, max_x, min_y, max_y); None = (0, width, 0, height)."""
    if bounds is None:
        bounds = (0.0, float(width), 0.0, float(height))
    min_x, max_x, min_y, max_y = bounds
    proj, z = project_points(state.pt_pos, T_cw, K_mat)
    in_img = ((z > 0.0) & (proj[:, 0] >= min_x) & (proj[:, 0] < max_x)
              & (proj[:, 1] >= min_y) & (proj[:, 1] < max_y))
    C = -T_cw[:3, :3].T @ T_cw[:3, 3]
    rays = state.pt_pos - C
    dist = torch.linalg.norm(rays, dim=-1)
    # scale band with the reference's 0.8 / 1.2 slack (Frame.cc:170-177)
    dist_ok = (dist >= 0.8 * state.pt_min_dist) & (dist <= 1.2 * state.pt_max_dist)
    view_cos = (rays * state.pt_normal).sum(-1) / torch.clamp(dist, min=1e-9)
    visible = state.pt_valid & in_img & dist_ok & (view_cos > view_cos_limit)
    # predicted octave (Frame.cc:181-190)
    ratio = (torch.clamp(state.pt_max_dist, min=1e-9)
             / torch.clamp(dist, min=1e-9))
    log_sf = torch.log(torch.tensor(scale_factor, dtype=torch.float32))
    pred = torch.ceil(torch.log(torch.clamp(ratio, min=1e-9)) / float(log_sf))
    pred = torch.clamp(pred.to(torch.int64), 0, n_levels - 1)
    return visible, proj, pred, dist


def track_frame(state: MapState, feat_xy, feat_desc, feat_octave, feat_valid,
                T_pred, K_mat, pt_mask=None, *, p_local: int = 4096,
                width: int = 640, height: int = 480, radius: float = 15.0,
                scale_factor: float = 1.2, n_levels: int = 8,
                max_dist: int = TH_HIGH, bounds=None) -> TrackResult:
    """One fused tracking step (`_track_body`). feat_xy [N, 2] undistorted
    pixels, feat_desc [N, 8] int32 words, feat_octave [N], feat_valid [N]
    bool, T_pred [4, 4] predicted pose; pt_mask [P] restricts candidates
    to the local map (None = the whole map)."""
    P = state.pt_valid.shape[0]
    N = feat_xy.shape[0]
    dev = feat_xy.device
    visible, proj, pred_level, _ = frustum_gate(
        state, T_pred, K_mat, width, height, scale_factor=scale_factor,
        n_levels=n_levels, bounds=bounds)
    if pt_mask is not None:
        visible = visible & pt_mask

    # up to p_local visible candidates, lowest slot id first
    # (track_kernels.py:127-136: keeps chunked == sequential tracking)
    sel = first_k_true(visible, p_local)
    sel_ok = visible[sel]
    cand_proj = proj[sel]
    cand_level = pred_level[sel]

    # radius scaled by the predicted level (ORBmatcher.cc:85-90), octave
    # within [pred - 1, pred + 1]
    r = radius * scale_factor ** cand_level.to(torch.float32)
    d = cand_proj[:, None, :] - feat_xy[None, :, :]
    gate = (d * d).sum(-1) <= (r * r)[:, None]
    octv = feat_octave.to(torch.int64)
    gate = gate & (octv[None, :] >= cand_level[:, None] - 1) & (
        octv[None, :] <= cand_level[:, None] + 1)
    best_idx, _, matched = match(
        state.pt_desc[sel], feat_desc, allowed=gate, valid_a=sel_ok,
        valid_b=feat_valid, max_dist=max_dist, nn_ratio=0.9, unique=True)

    # pose optimization on the matched rows, compacted to ceil(N/128)*128
    # slots (track_kernels.py:164-193)
    n_c = min(-(-N // 128) * 128, p_local)
    crow = first_k_true(matched, n_c) if n_c < p_local else torch.arange(
        p_local, device=dev)
    c_idx = best_idx[crow]
    inv_sigma2 = 1.0 / (scale_factor ** (2.0 * feat_octave[c_idx].to(torch.float32)))
    T_opt, inl_c, n_in = pose_optimize(
        T_pred.contiguous(), state.pt_pos[sel[crow]], feat_xy[c_idx],
        inv_sigma2, matched[crow], K_mat, iters=(4, 3, 2, 2))
    inlier = torch.zeros_like(matched).index_put((crow,), inl_c)

    # bindings: feature -> point id for inlier matches
    good = matched & inlier
    tgt = torch.where(good, best_idx, N)                  # dump slot N
    obs = torch.full((N + 1,), -1, dtype=torch.int32, device=dev)
    obs = obs.scatter(0, tgt, torch.where(good, sel, -1).to(torch.int32))[:N]
    found_inc = torch.zeros((P,), dtype=torch.int32, device=dev).index_add(
        0, torch.where(good, sel, 0), good.to(torch.int32))
    return TrackResult(T_opt, obs, n_in, matched.sum(), visible.to(torch.int32),
                       found_inc)


def track_prev_frame(state: MapState, prev_xy, prev_desc, prev_octave,
                     prev_angle, prev_obs, cur_xy, cur_desc, cur_octave,
                     cur_angle, cur_valid, T_last, K_mat, coarse_min_octave,
                     *, width: int = 640, height: int = 480,
                     scale_factor: float = 1.2, n_levels: int = 8):
    """TrackPreviousFrame (src/Tracking.cc:486-552): the current frame's
    pose from matches against the previous FRAME's bound points, for when
    the motion-model map tracking fails. prev_* [N] the previous frame's
    features and prev_obs [N] their point ids (-1 none); cur_* [M];
    T_last [4, 4] the previous pose; coarse_min_octave the least octave of
    stage 1 (maxOctave/2 + 1 once the map has more than 5 keyframes, else
    0).

    1. WindowSearch at 200 px over the coarse octaves, same octave, ratio
       0.9 and the rotation histogram (ORBmatcher.cc:409-517);
    2. the same at 100 px over every octave, taken when stage 1 has under
       10 matches (both are computed, the choice is by count on the
       device);
    3. with >= 10 matches a pose GN (K2 on the card) and its outliers
       dropped, then SearchByProjection of the unmatched points at 15 px
       from that pose; else at 50 px from T_last (ORBmatcher.cc:519-594);
    4. the final pose GN (K2) over all the matches.
    Nothing reads the device. Returns (T [4, 4], n_inliers, n_matches)."""
    P = state.pt_valid.shape[0]
    M = cur_xy.shape[0]
    obs_c = prev_obs.clamp(0, P - 1).long()
    pt_ok = (prev_obs >= 0) & state.pt_valid[obs_c]
    pts = state.pt_pos[obs_c]
    mkw = dict(valid_b=cur_valid, angle_a=prev_angle, angle_b=cur_angle,
               max_dist=TH_HIGH, nn_ratio=0.9, check_rotation=True,
               unique=True)

    gate1 = window_gate(prev_xy, cur_xy, 200.0, octave_b=cur_octave,
                        min_level=prev_octave, max_level=prev_octave)
    i1, _, m1 = match(prev_desc, cur_desc, allowed=gate1,
                      valid_a=pt_ok & (prev_octave >= coarse_min_octave), **mkw)
    n1 = m1.sum()
    gate2 = window_gate(prev_xy, cur_xy, 100.0, octave_b=cur_octave,
                        min_level=prev_octave, max_level=prev_octave)
    i2, _, m2 = match(prev_desc, cur_desc, allowed=gate2, valid_a=pt_ok, **mkw)
    use2 = n1 < 10
    best_idx = torch.where(use2, i2, i1)
    matched = torch.where(use2, m2, m1)
    n12 = torch.where(use2, m2.sum(), n1)

    # intermediate pose GN and its outliers dropped (Tracking.cc:514-527)
    inv_sigma2_of = lambda idx: 1.0 / (
        scale_factor ** (2.0 * cur_octave[idx].to(torch.float32)))
    T1, inl1, _ = pose_optimize(
        T_last.contiguous(), pts, cur_xy[best_idx], inv_sigma2_of(best_idx),
        matched, K_mat, iters=(4, 3, 2, 2))
    good = n12 >= 10
    matched = matched & torch.where(good, inl1, True)
    T_proj = torch.where(good, T1, T_last)
    rad = torch.where(good, 15.0, 50.0)

    # projection top-up: the unmatched previous-frame points through
    # T_proj; current features already bound (vpMapPointMatches2) and
    # points already found are excluded
    proj, z = project_points(pts, T_proj, K_mat)
    gate_p = window_gate(proj, cur_xy, rad, octave_b=cur_octave,
                         min_level=prev_octave, max_level=prev_octave)
    col_taken = torch.zeros((M + 1,), dtype=torch.bool, device=cur_xy.device)
    col_taken = col_taken.index_fill(
        0, torch.where(matched, best_idx, M), True)[:M]
    ip, _, mp_ = match(prev_desc, cur_desc, allowed=gate_p,
                       valid_a=pt_ok & ~matched & (z > 0),
                       valid_b=cur_valid & ~col_taken, max_dist=TH_HIGH,
                       nn_ratio=0.9, unique=True)
    best_all = torch.where(matched, best_idx, ip)
    matched_all = matched | mp_

    # final pose GN over all the matches (Tracking.cc:541)
    T_f, _, n_in = pose_optimize(
        T_proj.contiguous(), pts, cur_xy[best_all], inv_sigma2_of(best_all),
        matched_all, K_mat, iters=(4, 3, 2, 2))
    return T_f, n_in, matched_all.sum()


def chunk_track_step(state, xy, desc, octv, val, carry, K_mat, pt_mask=None,
                     *, p_local, width, height, radius, max_dist, min_inliers,
                     use_motion_model, retry=True, scale_factor=1.2,
                     n_levels=8, bounds=None):
    """One frame of the chunk recurrence: motion-model prediction, the
    optional wide-window retry from the last pose on low inliers
    (Tracking.cc:486-552; it reads the inlier count on the host) and the
    velocity update T_new inv(T_last) (Tracking.cc:282-295). A lost frame
    holds the carried pose and resets the velocity."""
    pose, vel = carry
    T_pred = vel @ pose if use_motion_model else pose
    kw = dict(p_local=p_local, width=width, height=height,
              scale_factor=scale_factor, n_levels=n_levels,
              max_dist=max_dist, bounds=bounds)
    res = track_frame(state, xy, desc, octv, val, T_pred, K_mat, pt_mask,
                      radius=radius, **kw)
    if retry and int(res.n_inliers) < min_inliers:
        res = track_frame(state, xy, desc, octv, val, pose, K_mat, pt_mask,
                          radius=radius * 2.0, **kw)
    ok = res.n_inliers >= min_inliers
    new_pose = torch.where(ok, res.pose, pose)
    eye = torch.eye(4, dtype=pose.dtype, device=pose.device)
    new_vel = torch.where(ok, res.pose @ se3_inverse(pose), eye)
    out = (res.pose, res.obs, res.n_inliers, res.n_matches,
           res.visible_inc.to(torch.bool))
    return (new_pose, new_vel), out


def track_chunk(state, feats_xy, feats_desc, feats_octave, feats_valid, pose0,
                vel0, K_mat, pt_mask=None, *, p_local=4096, width=640,
                height=480, radius=15.0, scale_factor=1.2, n_levels=8,
                max_dist=TH_HIGH, min_inliers=30, use_motion_model=True,
                bounds=None) -> ChunkResult:
    """Track B frames against one map snapshot (`_track_chunk_body`,
    retry on)."""
    carry = (pose0, vel0)
    outs = []
    for b in range(feats_xy.shape[0]):
        carry, out = chunk_track_step(
            state, feats_xy[b], feats_desc[b], feats_octave[b],
            feats_valid[b], carry, K_mat, pt_mask, p_local=p_local,
            width=width, height=height, radius=radius, max_dist=max_dist,
            min_inliers=min_inliers, use_motion_model=use_motion_model,
            scale_factor=scale_factor, n_levels=n_levels, bounds=bounds)
        outs.append(out)
    return ChunkResult(*(torch.stack(v) for v in zip(*outs)))
