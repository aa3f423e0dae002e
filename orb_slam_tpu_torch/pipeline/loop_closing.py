"""Loop closing: detection, the Sim3 of a loop, and its correction.

Port of orb_slam_tpu/pipeline/loop_closing.py: `search_by_sim3` (:38-82),
`project_loop_points` (:85-148) and `LoopCloser` (:151-579: `detect`
:161-209, `compute_sim3` :213-325, `correct` :329-566, `process`
:570-579); the reference's LoopClosing (src/LoopClosing.cc: DetectLoop
107-219, ComputeSim3 225-394, CorrectLoop 397-550).

The host logic is the JAX package's numpy, verbatim: the consistent groups
as Python sets, the covisibility lists from `np.where`, the sorted edge
set, `np.isin`, the one-gather point corrections and the loop-edge insert.
Matching, the Sim3 RANSAC and refinement, the verification projection,
the fuse and the essential graph run in torch on the system's device.
The RANSAC sets come from `_sim3_sets`, which draws from a
`torch.Generator` seeded with `cfg.seed` on the database's device:
`jax.random`'s draws cannot be repeated, so the parity tests replace it
to inject JAX's. Each stage runs under the system's `_stage` ("loop
detect", "loop match", "loop ransac", "loop guided", "loop
optimize_sim3", "loop project", "loop correct group", "loop fuse", "loop
graph", "loop essential graph", "loop remap"), so a stage clock can split
a call. The feature-to-point inversion of `project_loop_points` goes
through `ops/scatter.set_last` as JAX's other last-writer scatters do.
With SLAM_DEBUG set, detection and the Sim3 stage log their events at
JAX's sites (:183-323) from values already on the host.
"""

from __future__ import annotations

import numpy as np
import torch

from orb_slam_tpu_torch.ops.matching import TH_LOW, match
from orb_slam_tpu_torch.ops.scatter import set_last
from orb_slam_tpu_torch.pipeline.mapping_kernels import (
    _pow, fuse_points_into_keyframes,
)
from orb_slam_tpu_torch.place.database import KeyFrameDatabase
from orb_slam_tpu_torch.slam_map.covisibility import covisibility_weights
from orb_slam_tpu_torch.slam_map.observations import refresh_point_stats
from orb_slam_tpu_torch.solvers.essential_graph import (
    optimize_essential_graph, relative_sim3_batch,
)
from orb_slam_tpu_torch.utils.log import dbg
from orb_slam_tpu_torch.solvers.sim3 import _project, optimize_sim3, sim3_ransac
from orb_slam_tpu_torch.solvers.two_view import sample_minimal_sets


def search_by_sim3(state, kf1: int, kf2: int, s, R, t, K_mat,
                   radius: float = 7.5):
    """Guided Sim3 matching (ORBmatcher::SearchBySim3, ORBmatcher.cc:
    1267-1505): each keyframe's bound points go into the other camera
    through S12 / S21, gated by the projection radius, Hamming-matched and
    kept where both directions agree. Returns (idx2_of_1 [N], ok [N])."""
    P = state.pt_valid.shape[0]
    pid1 = state.kf_obs[kf1].long()
    pid2 = state.kf_obs[kf2].long()
    b1 = (pid1 >= 0) & state.pt_valid[pid1.clamp(0, P - 1)]
    b2 = (pid2 >= 0) & state.pt_valid[pid2.clamp(0, P - 1)]
    T1, T2 = state.kf_pose[kf1], state.kf_pose[kf2]
    c1 = state.pt_pos[pid1.clamp(0, P - 1)] @ T1[:3, :3].T + T1[:3, 3]
    c2 = state.pt_pos[pid2.clamp(0, P - 1)] @ T2[:3, :3].T + T2[:3, 3]
    # S12: p1 = s R p2 + t; S21 its inverse
    c2_in1 = s * c2 @ R.T + t
    c1_in2 = (1.0 / s) * (c1 - t) @ R
    uv2_in1, z21 = _project(c2_in1, K_mat), c2_in1[:, 2]
    uv1_in2, z12 = _project(c1_in2, K_mat), c1_in2[:, 2]
    d_a = state.kf_xy[kf1][:, None, :] - uv2_in1[None, :, :]
    d_b = uv1_in2[:, None, :] - state.kf_xy[kf2][None, :, :]
    gate = ((d_a * d_a).sum(-1) < radius * radius) & (z21 > 0)[None, :]
    gate = gate & ((d_b * d_b).sum(-1) < radius * radius) & (z12 > 0)[:, None]
    idx, _, ok = match(state.kf_desc[kf1], state.kf_desc[kf2], allowed=gate,
                       valid_a=b1, valid_b=b2, max_dist=TH_LOW, nn_ratio=1.0,
                       mutual=True, unique=True)
    return idx, ok


def project_loop_points(state, new_kf: int, loop_mask, matched_feat,
                        matched_pts, s, R, t, T_cand, K_mat, width: float,
                        height: float, th: float = 10.0,
                        scale_factor: float = 1.2, n_levels: int = 8,
                        bounds=None):
    """The loop verification matcher (SearchByProjection(KF, Scw, ...),
    ORBmatcher.cc:286-407, from ComputeSim3, LoopClosing.cc:375-394): the
    loop neighbourhood's points (`loop_mask` [P], less `matched_pts`, those
    the Sim3 inliers already bind) projected into the current keyframe
    through the corrected Sim3, gated by the image bounds, the scale band,
    the viewing angle and the predicted level's radius, and matched
    against the features not in `matched_feat`. Returns (point_of_feat [N]
    int32, ok [N])."""
    P = state.pt_valid.shape[0]
    N = state.kf_obs.shape[1]
    dev = state.pt_pos.device
    # de-scaled camera coordinates (ORBmatcher.cc:306-310)
    p_cand = state.pt_pos @ T_cand[:3, :3].T + T_cand[:3, 3]
    p_cur = p_cand @ R.T + (t / s)
    z = p_cur[:, 2]
    zs = torch.where(z.abs() < 1e-9, 1e-9, z)
    u = K_mat[0, 0] * p_cur[:, 0] / zs + K_mat[0, 2]
    v = K_mat[1, 1] * p_cur[:, 1] / zs + K_mat[1, 2]
    dist = torch.linalg.norm(p_cur, dim=-1)
    mnx, mxx, mny, mxy = bounds if bounds is not None else (
        0.0, float(width), 0.0, float(height))
    in_img = (z > 0) & (u >= mnx) & (u < mxx) & (v >= mny) & (v < mxy)
    band = (dist >= state.pt_min_dist) & (dist <= state.pt_max_dist)
    # viewing angle under 60 degrees from the current camera centre
    R_cur = R @ T_cand[:3, :3]
    t_cur = (t / s) + (T_cand[:3, 3] @ R.T)
    C_cur = -(R_cur.T @ t_cur)
    PO = state.pt_pos - C_cur
    view_ok = (PO * state.pt_normal).sum(-1) > 0.5 * dist
    pt_ok = state.pt_valid & loop_mask & ~matched_pts & in_img & band & view_ok
    ratio = (state.pt_max_dist / dist.clamp(min=1e-9)).clamp(min=1.0)
    log_sf = float(torch.log(torch.tensor(scale_factor, dtype=torch.float32)))
    pred = torch.clamp(torch.ceil(torch.log(ratio) / log_sf), 0, n_levels - 1)
    radius = th * _pow(scale_factor, pred)
    d = torch.stack([u, v], -1)[:, None, :] - state.kf_xy[new_kf][None, :, :]
    gate = (d * d).sum(-1) <= (radius * radius)[:, None]
    octv = state.kf_octave[new_kf].to(torch.float32)
    gate = gate & (octv[None, :] >= pred[:, None] - 1) & (octv[None, :] <= pred[:, None])
    idx, _, ok = match(state.pt_desc, state.kf_desc[new_kf], allowed=gate,
                       valid_a=pt_ok,
                       valid_b=state.kf_feat_valid[new_kf] & ~matched_feat,
                       max_dist=TH_LOW, nn_ratio=1.0, unique=True)
    # invert: feature -> point; only the padding row N repeats
    rows = torch.where(ok, idx, N)
    src = torch.arange(P, dtype=torch.int32, device=dev)
    feat_pt = set_last(torch.full((N + 1,), -1, dtype=torch.int32, device=dev),
                       rows, torch.where(ok, src, -1))[:N]
    return feat_pt, feat_pt >= 0


class LoopCloser:
    """DetectLoop, ComputeSim3 and CorrectLoop for the SLAMSystem; its
    database and generator live on `db.device`."""

    def __init__(self, db: KeyFrameDatabase, cfg):
        self.db = db
        self.cfg = cfg
        self.consistent_groups = []  # list[(set(kf), count)]
        self.last_loop_kf_counter = -100
        self._gen = torch.Generator(device=db.device).manual_seed(cfg.seed)
        # what the last accepted correction did: the group corrected, the
        # points merged by the fuse, the essential graph's edges
        self.last_correction = None

    def _sim3_sets(self, valid):
        """The [300, 3] minimal sets of one candidate's Sim3 RANSAC (JAX
        splits its key for each candidate that reaches RANSAC, :264)."""
        return sample_minimal_sets(valid, 300, 3, generator=self._gen)

    # ------------------------------------------------------------- detection

    def detect(self, system, new_kf: int):
        """DetectLoop: (the consistent candidate slots, the keyframe's BoW
        ids and weights). The keyframe joins the database whatever the
        outcome (LoopClosing.cc:141, 216)."""
        m = system.map
        ids, w, _ = self.db.compute_bow(m.kf_desc[new_kf], m.kf_feat_valid[new_kf])
        W_np = covisibility_weights(m).cpu().numpy()
        covis = [int(k) for k in np.where(W_np[new_kf] > 0)[0]]
        try:
            if system.kf_counter - self.last_loop_kf_counter < 10:
                return [], ids, w
            # the least score among the covisible keyframes
            # (LoopClosing.cc:114-131); none admits no candidate
            min_score = self.db.min_covisible_score(ids, w, covis)
            cands = self.db.detect_loop_candidates(
                ids, w, new_kf, covis, min_score, W_np)
            dbg(f"loop kf{new_kf}: min_score={min_score:.3f} "
                f"cands={cands} covis={len(covis)}")
            if not cands:
                self.consistent_groups = []
                return [], ids, w
            # covisibility-consistency over 3 consecutive keyframes
            # (LoopClosing.cc:146-219)
            enough = []
            new_groups = []
            for c in cands:
                group = set(np.where(W_np[c] > 0)[0].tolist()) | {c}
                best_count = 0
                for prev_group, count in self.consistent_groups:
                    if group & prev_group:
                        best_count = max(best_count, count + 1)
                new_groups.append((group, best_count))
                if best_count >= 3:
                    enough.append(c)
            self.consistent_groups = new_groups
            dbg(f"loop kf{new_kf}: consistent={enough} "
                f"groups={[c for _, c in new_groups]}")
            return enough, ids, w
        finally:
            self.db.add(new_kf, ids, w)

    # ------------------------------------------------------------ sim3 stage

    def compute_sim3(self, system, new_kf: int, candidates):
        """Per candidate: SearchByBoW-like matching, Sim3 RANSAC, the guided
        SearchBySim3, optimize_sim3, the >= 40 verification. Returns (cand,
        (s, R, t) taking candidate-frame points into the current frame,
        inliers) or None."""
        m = system.map
        P = m.pt_valid.shape[0]
        sf = system.cfg.map.scale_factor
        for cand in candidates:
            cand = int(cand)
            with system._stage("loop match"):
                # one-directional ratio 0.75 with the rotation check,
                # features with bound points on both sides
                # (ORBmatcher.cc:715-850; LoopClosing.cc:255)
                bound_cur = (m.kf_obs[new_kf] >= 0) & m.kf_feat_valid[new_kf]
                bound_cand = (m.kf_obs[cand] >= 0) & m.kf_feat_valid[cand]
                idx, _, ok = match(
                    m.kf_desc[new_kf], m.kf_desc[cand],
                    valid_a=bound_cur, valid_b=bound_cand,
                    angle_a=m.kf_angle[new_kf], angle_b=m.kf_angle[cand],
                    max_dist=TH_LOW, nn_ratio=0.75, mutual=False,
                    check_rotation=True, unique=True)
                n_matches = int(ok.sum())
            dbg(f"sim3 kf-cand {cand}: matches={n_matches}")
            if n_matches < 20:
                continue
            with system._stage("loop ransac"):
                pid_cur = m.kf_obs[new_kf].long()
                pid_cand = m.kf_obs[cand][idx].long()
                ok = ok & (pid_cur >= 0) & (pid_cand >= 0)
                pid_cur_s = pid_cur.clamp(0, P - 1)
                pid_cand_s = pid_cand.clamp(0, P - 1)
                ok = ok & m.pt_valid[pid_cur_s] & m.pt_valid[pid_cand_s]
                T_cur, T_cand = m.kf_pose[new_kf], m.kf_pose[cand]
                p1 = m.pt_pos[pid_cur_s] @ T_cur[:3, :3].T + T_cur[:3, 3]
                p2 = m.pt_pos[pid_cand_s] @ T_cand[:3, :3].T + T_cand[:3, 3]
                uv1 = m.kf_xy[new_kf]
                uv2 = m.kf_xy[cand][idx]
                s2_1 = _pow(sf, 2.0 * m.kf_octave[new_kf].to(torch.float32))
                s2_2 = _pow(sf, 2.0 * m.kf_octave[cand][idx].to(torch.float32))
                s, R, t, inl, n_in = sim3_ransac(
                    p1, p2, uv1, uv2, ok, s2_1, s2_2, system.K_dev,
                    idx=self._sim3_sets(ok))
                n_in = int(n_in)
            dbg(f"sim3 cand {cand}: ransac_inliers={n_in}")
            if n_in < 20:
                continue
            with system._stage("loop guided"):
                # SearchBySim3 under the RANSAC Sim3 (LoopClosing.cc:341-345)
                g_idx, g_ok = search_by_sim3(m, new_kf, cand, s, R, t, system.K_dev)
                idx2 = torch.where(g_ok, g_idx, idx)
                ok2 = inl | g_ok
                pid_cand2 = m.kf_obs[cand][idx2].long()
                ok2 = ok2 & (pid_cur >= 0) & (pid_cand2 >= 0)
                pc2s = pid_cand2.clamp(0, P - 1)
                ok2 = ok2 & m.pt_valid[pid_cur_s] & m.pt_valid[pc2s]
                p2m = m.pt_pos[pc2s] @ T_cand[:3, :3].T + T_cand[:3, 3]
                uv2m = m.kf_xy[cand][idx2]
                s2_2m = _pow(sf, 2.0 * m.kf_octave[cand][idx2].to(torch.float32))
            with system._stage("loop optimize_sim3"):
                s, R, t, inl, n_in = optimize_sim3(
                    s, R, t, p1, p2m, uv1, uv2m, ok2, 1.0 / s2_1, 1.0 / s2_2m,
                    system.K_dev)
                n_in = int(n_in)
            if n_in < 20:
                continue
            with system._stage("loop project"):
                # the candidate's covisible neighbourhood's points projected
                # into the current keyframe; >= 40 matches in all
                # (LoopClosing.cc:347-394)
                W_np = covisibility_weights(m).cpu().numpy()
                group = np.where(W_np[cand] > 0)[0].tolist() + [cand]
                loop_mask = np.zeros(P, bool)
                obs_g = m.kf_obs[torch.as_tensor(group, device=m.kf_obs.device)].cpu().numpy()
                loop_mask[obs_g[obs_g >= 0]] = True
                matched_pts = np.zeros(P, bool)
                found_pids = pid_cand2.cpu().numpy()[inl.cpu().numpy()]
                matched_pts[found_pids[found_pids >= 0]] = True
                dev = m.pt_pos.device
                _, proj_ok = project_loop_points(
                    m, new_kf, torch.from_numpy(loop_mask).to(dev), inl,
                    torch.from_numpy(matched_pts).to(dev), s, R, t,
                    m.kf_pose[cand], system.K_dev,
                    width=float(system.cfg.camera.width),
                    height=float(system.cfg.camera.height),
                    scale_factor=sf, n_levels=system.cfg.map.n_levels,
                    bounds=system.img_bounds)
                n_proj = int(proj_ok.sum())
                n_total = int(inl.sum()) + n_proj
            dbg(f"sim3 cand {cand}: opt_inliers={n_in} "
                f"projected={n_proj} total={n_total}")
            if n_total < 40:
                continue
            dbg(f"sim3 cand {cand}: ACCEPTED total={n_total}")
            return cand, (s, R, t), inl
        return None

    # ------------------------------------------------------------ correction

    def correct(self, system, new_kf: int, cand: int, S12):
        """CorrectLoop (LoopClosing.cc:397-550). S12 = (s, R, t) with
        p_cur = s R p_cand + t."""
        cfg = system.cfg
        _sf, _nl = cfg.map.scale_factor, cfg.map.n_levels
        dev = system.map.pt_pos.device
        T = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
        with system._stage("loop correct group"):
            m = refresh_point_stats(system.map, scale_factor=_sf, n_levels=_nl)
            K = m.kf_valid.shape[0]
            P = m.pt_valid.shape[0]
            kf_valid = m.kf_valid.cpu().numpy()
            poses = m.kf_pose.cpu().numpy()

            s12 = float(S12[0])
            R12 = S12[1].cpu().numpy()
            t12 = S12[2].cpu().numpy()

            # the corrected Sim3 of the current keyframe: S_cw = S12 o T_cand
            T_cand = poses[cand]
            S_cw_s = s12
            S_cw_R = R12 @ T_cand[:3, :3]
            S_cw_t = s12 * (R12 @ T_cand[:3, 3]) + t12

            # the current keyframe's covisible group, corrected through
            # its relative poses
            W_np = covisibility_weights(m).cpu().numpy()
            group = [new_kf] + [int(k) for k in np.where(W_np[new_kf] > 0)[0]]
            T_cur = poses[new_kf]
            T_cur_inv = np.linalg.inv(T_cur)

            base_s = np.ones(K, np.float32)
            base_R = poses[:, :3, :3].copy()
            base_t = poses[:, :3, 3].copy()
            old_s = base_s.copy()
            old_R = base_R.copy()
            old_t = base_t.copy()
            for k in group:
                T_rel = poses[k] @ T_cur_inv  # k <- cur
                base_s[k] = s12
                base_R[k] = T_rel[:3, :3] @ S_cw_R
                base_t[k] = T_rel[:3, :3] @ S_cw_t + T_rel[:3, 3]

            # the group's points: x' = S_new^-1(S_old(x)) through each
            # point's reference keyframe in the group (LoopClosing.cc:438-472)
            pt_ref = m.pt_ref_kf.cpu().numpy()
            pt_valid = m.pt_valid.cpu().numpy()
            pos = m.pt_pos.cpu().numpy().copy()
            in_group = np.isin(pt_ref, group) & pt_valid
            if in_group.any():
                ref = np.clip(pt_ref, 0, K - 1)
                p_cam = (np.einsum("pij,pj->pi", old_R[ref], pos) + old_t[ref])
                x_new = np.einsum(
                    "pji,pj->pi", base_R[ref], p_cam - base_t[ref]
                ) / base_s[ref][:, None]
                pos = np.where(in_group[:, None], x_new, pos)
            m = m.replace(pt_pos=T(pos.astype(np.float32)))

            # the group's corrected SE3 before the pose graph: [R, t/s]
            poses_corr = poses.copy()
            for k in group:
                poses_corr[k][:3, :3] = base_R[k]
                poses_corr[k][:3, 3] = base_t[k] / base_s[k]
            m = m.replace(kf_pose=T(poses_corr))

            # the group's neighbour sets before the fuse, the baseline for
            # new cross-loop connections (LoopClosing.cc:521-525)
            prev_nb = {k: set(np.where(W_np[k] >= 15)[0].tolist()) for k in group}

        with system._stage("loop fuse"):
            # the loop side's point set into every corrected keyframe
            # (SearchAndFuse, LoopClosing.cc:557-570)
            cand_group = [cand] + [int(k) for k in np.where(W_np[cand] > 0)[0]]
            loop_pts = np.zeros(P, bool)
            obs_cg = m.kf_obs[torch.as_tensor(cand_group, device=dev)].cpu().numpy()
            loop_pts[obs_cg[obs_cg >= 0]] = True
            dsts = [d for d in group if kf_valid[d]]
            n_valid_before = int(m.pt_valid.sum())
            m, remap = fuse_points_into_keyframes(
                m, T(loop_pts), dsts, system.K_dev,
                width=cfg.camera.width, height=cfg.camera.height,
                scale_factor=_sf, n_levels=_nl, bounds=system.img_bounds)
            n_merged = n_valid_before - int(m.pt_valid.sum())
            system._compose_forward(remap)
            system._reclaim_points(m)

        with system._stage("loop graph"):
            W_np2 = covisibility_weights(m).cpu().numpy()
            # new loop connections: post-fuse links of the group to
            # keyframes outside it that were not neighbours before
            # (LoopClosing.cc:518-537), plus the current-loop edge
            loop_conn = set()
            group_set = set(group)
            for i in group:
                if not kf_valid[i]:
                    continue
                for j in np.where(W_np2[i] >= 15)[0]:
                    j = int(j)
                    if (not kf_valid[j] or j in group_set
                            or j in prev_nb.get(i, set())):
                        continue
                    if W_np2[i, j] >= 100 or {i, j} == {new_kf, cand}:
                        loop_conn.add((min(i, j), max(i, j)))
            loop_conn.add((min(new_kf, cand), max(new_kf, cand)))
            sp = m.spanning_parent.cpu().numpy()
            loop_edges_np = m.loop_edges.cpu().numpy()
            edges = set()
            for k in np.where(kf_valid & (sp >= 0))[0]:
                p = int(sp[k])
                if kf_valid[p]:
                    edges.add((min(int(k), p), max(int(k), p)))
            strong = np.argwhere(np.triu(W_np2, 1) >= 100)
            for a, b in strong:
                if kf_valid[a] and kf_valid[b]:
                    edges.add((int(a), int(b)))
            for k, le in np.argwhere(loop_edges_np >= 0):
                j = int(loop_edges_np[k, le])
                if kf_valid[k] and kf_valid[j]:
                    edges.add((min(int(k), j), max(int(k), j)))
            edges |= loop_conn
            edges = sorted(edges)

            E_pad = 1
            while E_pad < max(len(edges), 4):
                E_pad *= 2
            ei = np.zeros(E_pad, np.int32)
            ej = np.zeros(E_pad, np.int32)
            ev = np.zeros(E_pad, bool)
            n_e = len(edges)
            ms_ = np.ones(E_pad, np.float32)
            mR_ = np.tile(np.eye(3, dtype=np.float32), (E_pad, 1, 1))
            mt_ = np.zeros((E_pad, 3), np.float32)
            if n_e:
                ea = np.asarray([a for a, _ in edges], np.int32)
                eb = np.asarray([b for _, b in edges], np.int32)
                ei[:n_e], ej[:n_e], ev[:n_e] = ea, eb, True
                # measurements from the poses before the correction, but
                # the new loop connections use the group's corrected Sim3s
                # (vScw, Optimizer.cc:578-636)
                is_loop = np.asarray([(a, b) in loop_conn for a, b in edges])
                in_grp = np.isin(np.arange(K), list(group_set))
                use_corr_a = is_loop & in_grp[ea]
                use_corr_b = is_loop & in_grp[eb]
                sa = np.where(use_corr_a, base_s[ea], old_s[ea])
                Ra = np.where(use_corr_a[:, None, None], base_R[ea], old_R[ea])
                ta = np.where(use_corr_a[:, None], base_t[ea], old_t[ea])
                sb = np.where(use_corr_b, base_s[eb], old_s[eb])
                Rb = np.where(use_corr_b[:, None, None], base_R[eb], old_R[eb])
                tb = np.where(use_corr_b[:, None], base_t[eb], old_t[eb])
                rs, rR, rt = relative_sim3_batch(T(sa), T(Ra), T(ta),
                                                 T(sb), T(Rb), T(tb))
                ms_[:n_e] = rs.cpu().numpy()
                mR_[:n_e] = rR.cpu().numpy()
                mt_[:n_e] = rt.cpu().numpy()
            fixed = ~kf_valid.copy()
            fixed[cand] = True

        with system._stage("loop essential graph"):
            # dense up to a few hundred keyframe slots, matrix-free PCG
            # past them (g2o's sparse solver, Optimizer.cc:548-550)
            solver = "dense" if len(base_s) <= 384 else "cg"
            s_o, R_o, t_o = optimize_essential_graph(
                T(base_s), T(base_R), T(base_t), T(ei), T(ej), T(ms_), T(mR_),
                T(mt_), T(ev), T(fixed), iters=15, solver=solver)
            s_o = s_o.cpu().numpy()
            R_o = R_o.cpu().numpy()
            t_o = t_o.cpu().numpy()

        with system._stage("loop remap"):
            # every point through its reference keyframe's correction
            # (Optimizer.cc:749-789), one gather by pt_ref
            pos = m.pt_pos.cpu().numpy().copy()
            pt_ref = m.pt_ref_kf.cpu().numpy()
            pt_valid = m.pt_valid.cpu().numpy()
            in_grp = np.isin(np.arange(K), group)
            v_s = np.where(in_grp, base_s, old_s)
            v_R = np.where(in_grp[:, None, None], base_R, old_R)
            v_t = np.where(in_grp[:, None], base_t, old_t)
            ref = np.clip(pt_ref, 0, K - 1)
            sel = pt_valid & kf_valid[ref] & (pt_ref >= 0) & (pt_ref < K)
            if sel.any():
                p_cam = (v_s[ref][:, None]
                         * np.einsum("pij,pj->pi", v_R[ref], pos) + v_t[ref])
                x_new = np.einsum(
                    "pji,pj->pi", R_o[ref], p_cam - t_o[ref]
                ) / s_o[ref][:, None]
                pos = np.where(sel[:, None], x_new, pos)

            # the SE3 poses [R, t/s]
            poses_new = poses_corr.copy()
            poses_new[:, :3, :3] = np.where(
                kf_valid[:, None, None], R_o, poses_corr[:, :3, :3])
            poses_new[:, :3, 3] = np.where(
                kf_valid[:, None], t_o / s_o[:, None], poses_corr[:, :3, 3])

            # the loop edge both ways (KeyFrame::AddLoopEdge)
            le = m.loop_edges.cpu().numpy().copy()
            for a, b in ((new_kf, cand), (cand, new_kf)):
                row = le[a]
                for i in range(len(row)):
                    if row[i] < 0:
                        row[i] = b
                        break
            m = m.replace(pt_pos=T(pos.astype(np.float32)),
                          kf_pose=T(poses_new.astype(np.float32)),
                          loop_edges=T(le))
            system.map = refresh_point_stats(m, scale_factor=_sf, n_levels=_nl)
        system.last_pose = poses_new[new_kf].copy()
        system.velocity = np.eye(4, dtype=np.float32)
        self.last_loop_kf_counter = system.kf_counter
        self.consistent_groups = []
        self.last_correction = dict(new_kf=int(new_kf), cand=int(cand),
                                    group=len(group), merged=n_merged,
                                    edges=n_e, loop_connections=len(loop_conn),
                                    solver=solver)
        return True

    # ----------------------------------------------------------------- entry

    def process(self, system, new_kf: int) -> bool:
        """One loop-closing pass for a keyframe just integrated."""
        with system._stage("loop detect"):
            candidates, _, _ = self.detect(system, new_kf)
        if not candidates:
            return False
        hit = self.compute_sim3(system, new_kf, candidates)
        if hit is None:
            return False
        cand, S12, _ = hit
        return self.correct(system, new_kf, cand, S12)
