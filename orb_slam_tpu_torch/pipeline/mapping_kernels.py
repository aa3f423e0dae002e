"""Local-mapping kernels: new-point triangulation, fuse and culling stats.

Port of orb_slam_tpu/pipeline/mapping_kernels.py:29-341 and :482-518:
`_fundamental_from_poses`, `TriangulationCandidates`,
`triangulate_new_points`, `insert_new_points`, `fuse_into_keyframe`,
`point_cull_stats` and `keyframe_redundancy` (LocalMapping.cc
CreateNewMapPoints 205-371, SearchInNeighbors/Fuse 373-450,
MapPointCulling 175-203, KeyFrameCulling 524-578). The loop closer's
`fuse_points_into_keyframes` (:344-479) comes with loop closing.

Two of JAX's scatters write duplicate targets and let the last row win
(:193-197 and :287-288): a later row that writes a column back with its
old value undoes an earlier row's binding. They go through
`ops/scatter.set_last`, which reproduces that order on every device.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from orb_slam_tpu_torch.geometry.triangulation import triangulate_dlt
from orb_slam_tpu_torch.ops.matching import TH_LOW, match
from orb_slam_tpu_torch.ops.scatter import set_last
from orb_slam_tpu_torch.slam_map.map_state import MapState
from orb_slam_tpu_torch.slam_map.observations import observation_table

CHI2_2D = 5.991


def _fundamental_from_poses(T_a, T_b, K_mat):
    """F_ab with x_b^T F x_a = 0 from world->camera poses
    (LocalMapping::ComputeF12, src/LocalMapping.cc:452-469)."""
    T_ba = T_b @ torch.linalg.inv_ex(T_a)[0]
    R = T_ba[:3, :3]
    t = T_ba[:3, 3]
    z = torch.zeros((), dtype=t.dtype, device=t.device)
    tx = torch.stack([torch.stack([z, -t[2], t[1]]),
                      torch.stack([t[2], z, -t[0]]),
                      torch.stack([-t[1], t[0], z])])
    Kinv = torch.linalg.inv_ex(K_mat)[0]
    return Kinv.T @ tx @ R @ Kinv


class TriangulationCandidates(NamedTuple):
    pos: torch.Tensor      # [N, 3] world positions
    feat_a: torch.Tensor   # [N] feature index in kf_a
    feat_b: torch.Tensor   # [N] feature index in kf_b
    valid: torch.Tensor    # [N] bool


def _pow(base: float, exponent: torch.Tensor) -> torch.Tensor:
    """base ** exponent in f32, as JAX raises a weak-typed float."""
    return torch.pow(torch.tensor(base, dtype=torch.float32,
                                  device=exponent.device),
                     exponent.to(torch.float32))


def triangulate_new_points(state: MapState, kf_a: int, kf_b: int, K_mat,
                           scale_factor: float = 1.2) -> TriangulationCandidates:
    """Match the unbound features of kf_a against those of kf_b under the
    epipolar constraint, triangulate and gate: positive depth in both
    views, parallax, reprojection chi2 < 5.991 sigma^2 in both views, scale
    consistency (src/LocalMapping.cc:269-352)."""
    N = state.kf_obs.shape[1]
    dev = state.kf_obs.device
    fx, fy, cx, cy = K_mat[0, 0], K_mat[1, 1], K_mat[0, 2], K_mat[1, 2]
    T_a, T_b = state.kf_pose[kf_a], state.kf_pose[kf_b]
    xy_a, xy_b = state.kf_xy[kf_a], state.kf_xy[kf_b]
    oct_a, oct_b = state.kf_octave[kf_a], state.kf_octave[kf_b]
    free_a = (state.kf_obs[kf_a] < 0) & state.kf_feat_valid[kf_a]
    free_b = (state.kf_obs[kf_b] < 0) & state.kf_feat_valid[kf_b]

    # epipolar gate: distance of x_b to the line F x_a under 3.84 sigma_b^2
    # (ORBmatcher::CheckDistEpipolarLine, src/ORBmatcher.cc:136-153)
    F = _fundamental_from_poses(T_a, T_b, K_mat)
    ha = torch.cat([xy_a, torch.ones((N, 1), device=dev)], 1)
    lines = ha @ F.T
    num = (lines[:, None, 0] * xy_b[None, :, 0]
           + lines[:, None, 1] * xy_b[None, :, 1] + lines[:, None, 2])
    den = (lines[:, 0] ** 2 + lines[:, 1] ** 2).clamp(min=1e-12)[:, None]
    epi_d2 = num * num / den
    sigma2_b = _pow(scale_factor, 2.0 * oct_b.to(torch.float32))
    gate = epi_d2 < 3.84 * sigma2_b[None, :]

    best_idx, _, matched = match(
        state.kf_desc[kf_a], state.kf_desc[kf_b], allowed=gate,
        valid_a=free_a, valid_b=free_b, max_dist=TH_LOW, nn_ratio=1.0,
        unique=True)

    xn_a = torch.stack([(xy_a[:, 0] - cx) / fx, (xy_a[:, 1] - cy) / fy], -1)
    xb = xy_b[best_idx]
    xn_b = torch.stack([(xb[:, 0] - cx) / fx, (xb[:, 1] - cy) / fy], -1)
    X = triangulate_dlt(xn_a, xn_b, T_a[:3, :4].expand(N, 3, 4),
                        T_b[:3, :4].expand(N, 3, 4))
    finite = torch.isfinite(X).all(-1)
    X = torch.where(finite[:, None], X, 0.0)

    Ca = -T_a[:3, :3].T @ T_a[:3, 3]
    Cb = -T_b[:3, :3].T @ T_b[:3, 3]
    r_a, r_b = X - Ca, X - Cb
    na = torch.linalg.norm(r_a, dim=-1)
    nb = torch.linalg.norm(r_b, dim=-1)
    cos_par = (r_a * r_b).sum(-1) / (na * nb).clamp(min=1e-12)
    parallax_ok = cos_par < 0.9998

    pca = X @ T_a[:3, :3].T + T_a[:3, 3]
    pcb = X @ T_b[:3, :3].T + T_b[:3, 3]
    depth_ok = (pca[:, 2] > 0) & (pcb[:, 2] > 0)
    za = torch.where(pca[:, 2].abs() < 1e-9, 1e-9, pca[:, 2])
    zb = torch.where(pcb[:, 2].abs() < 1e-9, 1e-9, pcb[:, 2])
    ua, va = fx * pca[:, 0] / za + cx, fy * pca[:, 1] / za + cy
    ub, vb = fx * pcb[:, 0] / zb + cx, fy * pcb[:, 1] / zb + cy
    sigma2_a = _pow(scale_factor, 2.0 * oct_a.to(torch.float32))
    e_a = (ua - xy_a[:, 0]) ** 2 + (va - xy_a[:, 1]) ** 2
    e_b = (ub - xb[:, 0]) ** 2 + (vb - xb[:, 1]) ** 2
    reproj_ok = (e_a < CHI2_2D * sigma2_a) & (e_b < CHI2_2D * sigma2_b[best_idx])

    # scale consistency (LocalMapping.cc:335-352)
    ratio_dist = na / nb.clamp(min=1e-12)
    ratio_oct = _pow(scale_factor, (oct_a - oct_b[best_idx]).to(torch.float32))
    ratio_factor = 1.5 * scale_factor
    scale_ok = ((ratio_dist * ratio_factor > ratio_oct)
                & (ratio_dist < ratio_oct * ratio_factor))

    valid = matched & finite & parallax_ok & depth_ok & reproj_ok & scale_ok
    return TriangulationCandidates(
        pos=X, feat_a=torch.arange(N, dtype=torch.int32, device=dev),
        feat_b=best_idx.to(torch.int32), valid=valid)


def insert_new_points(state: MapState, kf_a: int, kf_b: int,
                      cand: TriangulationCandidates, free_slots):
    """Give the valid candidates slots from `free_slots` ([F] int32 from
    the host allocator, -1 padding) and bind both observations. Returns
    (new_state, n_created as a 0-dim tensor)."""
    P = state.pt_valid.shape[0]
    N = state.kf_obs.shape[1]
    free_slots = free_slots.long()
    F_cap = free_slots.shape[0]
    rank = torch.cumsum(cand.valid.to(torch.int64), 0) - 1
    has_slot = cand.valid & (rank < F_cap) & (rank >= 0)
    slot = torch.where(has_slot, free_slots[rank.clamp(0, F_cap - 1)], -1)
    active = has_slot & (slot >= 0)

    # write the points; active slots are distinct, the others go to dump row P
    slot_safe = torch.where(active, slot, P)

    def put(field, value, pad):
        padded = torch.cat([field, torch.full((1,) + field.shape[1:], pad,
                                              dtype=field.dtype,
                                              device=field.device)])
        cur = padded[slot_safe]
        a = active.reshape((-1,) + (1,) * (cur.dim() - 1))
        padded[slot_safe] = torch.where(a, value, cur)
        return padded[:P]

    kfa = torch.full_like(slot, kf_a, dtype=torch.int32)
    one = torch.ones_like(kfa)
    pt_valid = torch.cat([state.pt_valid, state.pt_valid.new_zeros(1)])
    pt_valid[slot_safe] = active | pt_valid[slot_safe]

    # bind: kf_a's rows are its features in order (feat_a = 0..N-1);
    # kf_b's may collide
    obs = state.kf_obs.clone()
    slot32 = slot.to(torch.int32)
    obs[kf_a] = torch.where(active, slot32, obs[kf_a])
    feat_b = cand.feat_b.long().clamp(0, N - 1)
    row_b = obs[kf_b]
    obs[kf_b] = set_last(row_b, feat_b, torch.where(active, slot32, row_b[feat_b]))

    new_state = state.replace(
        pt_pos=put(state.pt_pos, cand.pos, 0.0),
        pt_valid=pt_valid[:P],
        pt_desc=put(state.pt_desc, state.kf_desc[kf_a], 0),
        pt_ref_kf=put(state.pt_ref_kf, kfa, -1),
        pt_first_kf=put(state.pt_first_kf, kfa, -1),
        pt_visible=put(state.pt_visible, one, 0),
        pt_found=put(state.pt_found, one, 0),
        kf_obs=obs,
    )
    return new_state, active.sum()


def _merge(state: MapState, obs_all, has_existing, loser, winner):
    """Rebind every observation of each loser to its winner, resolving
    chains by pointer doubling (mapping_kernels.py:295-341): returns the
    merged (kf_obs, pt_valid, pt_visible, pt_found) and the resolved remap
    ([P], -1 where the chain ends at a killed point)."""
    P = state.pt_valid.shape[0]
    dev = obs_all.device
    ident = torch.arange(P, device=dev)
    remap_pad = torch.cat([ident, torch.full((1,), -1, device=dev,
                                             dtype=torch.int64)])
    remap_pad = set_last(remap_pad, torch.where(has_existing, loser, P),
                         torch.where(has_existing, winner, -1))
    remap = remap_pad[:P]
    killed = remap != ident
    for _ in range(max(P.bit_length(), 1)):
        remap = remap[remap]
    o = obs_all.long()
    obs_remapped = torch.where(o >= 0, remap[o.clamp(0, P - 1)], -1)
    obs_remapped = torch.where(
        (obs_remapped >= 0) & killed[obs_remapped.clamp(0, P - 1)], -1,
        obs_remapped)
    tgt = torch.where(killed, remap, P)
    zeros = torch.zeros(P + 1, dtype=torch.int32, device=dev)
    add_vis = zeros.index_add(0, tgt, torch.where(killed, state.pt_visible, 0))[:P]
    add_fnd = zeros.index_add(0, tgt, torch.where(killed, state.pt_found, 0))[:P]
    remap_out = torch.where(killed & killed[remap.clamp(0, P - 1)], -1, remap)
    return (obs_remapped.to(torch.int32), state.pt_valid & ~killed,
            state.pt_visible + add_vis, state.pt_found + add_fnd,
            remap_out.to(torch.int32))


def fuse_into_keyframe(state: MapState, src_kf: int, dst_kf: int, K_mat,
                       width: int = 640, height: int = 480,
                       scale_factor: float = 1.2, n_levels: int = 8,
                       bounds=None):
    """Project src_kf's bound points into dst_kf and match; bind unbound
    features, or merge duplicate points, the one with more observations
    winning (ORBmatcher::Fuse + MapPoint::Replace, ORBmatcher.cc:1016-1134,
    MapPoint.cc:124-158). Returns (new_state, n_bound, n_merged, remap [P]
    int32 for the host's forwarding table)."""
    P = state.pt_valid.shape[0]
    dev = state.kf_obs.device
    pids = state.kf_obs[src_kf].long()
    pid_safe = pids.clamp(0, P - 1)
    is_pt = (pids >= 0) & state.pt_valid[pid_safe]

    T_dst = state.kf_pose[dst_kf]
    pos = state.pt_pos[pid_safe]
    pc = pos @ T_dst[:3, :3].T + T_dst[:3, 3]
    z = pc[:, 2]
    zs = torch.where(z.abs() < 1e-9, 1e-9, z)
    u = K_mat[0, 0] * pc[:, 0] / zs + K_mat[0, 2]
    v = K_mat[1, 1] * pc[:, 1] / zs + K_mat[1, 2]
    proj = torch.stack([u, v], -1)
    mnx, mxx, mny, mxy = bounds if bounds is not None else (
        0.0, float(width), 0.0, float(height))
    in_img = (z > 0) & (u >= mnx) & (u < mxx) & (v >= mny) & (v < mxy)

    C = -T_dst[:3, :3].T @ T_dst[:3, 3]
    dist = torch.linalg.norm(pos - C, dim=-1)
    band_ok = ((dist >= 0.8 * state.pt_min_dist[pid_safe])
               & (dist <= 1.2 * state.pt_max_dist[pid_safe]))
    candidate = is_pt & in_img & band_ok

    # 3-sigma radius at the predicted level (Fuse: th = 3.0 * scale)
    ratio = (state.pt_max_dist[pid_safe].clamp(min=1e-9) / dist.clamp(min=1e-9))
    log_sf = float(torch.log(torch.tensor(scale_factor, dtype=torch.float32)))
    pred = torch.ceil(torch.log(ratio.clamp(min=1e-9)) / log_sf)
    pred = pred.to(torch.int64).clamp(0, n_levels - 1)
    r = 3.0 * _pow(scale_factor, pred.to(torch.float32))
    d = proj[:, None, :] - state.kf_xy[dst_kf][None, :, :]
    gate = (d * d).sum(-1) <= (r * r)[:, None]
    oct_dst = state.kf_octave[dst_kf].long()
    gate = gate & (oct_dst[None, :] >= pred[:, None] - 1) & (
        oct_dst[None, :] <= pred[:, None] + 1)

    best_idx, _, matched = match(
        state.pt_desc[pid_safe], state.kf_desc[dst_kf], allowed=gate,
        valid_a=candidate, valid_b=state.kf_feat_valid[dst_kf],
        max_dist=TH_LOW, nn_ratio=1.0, unique=True)

    o = state.kf_obs.long()
    obs_counts = torch.zeros(P + 1, dtype=torch.int32, device=dev).index_add(
        0, torch.where(o >= 0, o, P).reshape(-1),
        (o >= 0).to(torch.int32).reshape(-1))[:P]

    row = state.kf_obs[dst_kf]
    dst_bound = row[best_idx].long()
    dst_bound_safe = dst_bound.clamp(0, P - 1)
    has_existing = (matched & (dst_bound >= 0) & state.pt_valid[dst_bound_safe]
                    & (dst_bound != pids))

    # case 1: bind free features to the source point (last writer wins)
    bind_free = matched & (dst_bound < 0)
    obs_all = state.kf_obs.clone()
    obs_all[dst_kf] = set_last(row, best_idx,
                               torch.where(bind_free, pids.to(torch.int32),
                                           row[best_idx]))

    # case 2: merge duplicates, the point with more observations winning
    src_wins = obs_counts[pid_safe] >= obs_counts[dst_bound_safe]
    loser = torch.where(src_wins, dst_bound, pids)
    winner = torch.where(src_wins, pids, dst_bound)
    kf_obs, pt_valid, pt_visible, pt_found, remap = _merge(
        state, obs_all, has_existing, loser, winner)
    return (state.replace(kf_obs=kf_obs, pt_valid=pt_valid,
                          pt_visible=pt_visible, pt_found=pt_found),
            bind_free.sum(), has_existing.sum(), remap)


def point_cull_stats(state: MapState, current_kf_counter):
    """(found_ratio [P], n_obs [P], age_kfs [P]) for MapPointCulling
    (LocalMapping.cc:175-203)."""
    P = state.pt_valid.shape[0]
    o = state.kf_obs.long()
    counted = ((o >= 0) & state.kf_valid[:, None]).to(torch.int32)
    obs_counts = torch.zeros(P + 1, dtype=torch.int32, device=o.device).index_add(
        0, torch.where(o >= 0, o, P).reshape(-1), counted.reshape(-1))[:P]
    ratio = state.pt_found.to(torch.float32) / state.pt_visible.to(
        torch.float32).clamp(min=1.0)
    return ratio, obs_counts, current_kf_counter - state.pt_first_kf


def keyframe_redundancy(state: MapState, kf: int):
    """(share of kf's bound points seen by >= 3 other KFs at the same or a
    finer scale, number of bound points) for KeyFrameCulling
    (LocalMapping.cc:524-578)."""
    K, N = state.kf_obs.shape
    P = state.pt_valid.shape[0]
    pids = state.kf_obs[kf].long()
    pid_safe = pids.clamp(0, P - 1)
    bound = (pids >= 0) & state.pt_valid[pid_safe]
    my_oct = state.kf_octave[kf]

    obs_kf, obs_feat, obs_valid = observation_table(state)
    o_kf = obs_kf[pid_safe]
    o_feat = obs_feat[pid_safe].long().clamp(0, N - 1)
    o_valid = obs_valid[pid_safe]
    o_oct = state.kf_octave[o_kf.long().clamp(0, K - 1), o_feat]
    other = o_valid & (o_kf != kf)
    finer = other & (o_oct <= my_oct[:, None] + 1)
    redundant = bound & (finer.sum(-1) >= 3)
    n_bound = bound.sum()
    return redundant.sum() / n_bound.clamp(min=1), n_bound
