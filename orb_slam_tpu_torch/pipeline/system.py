"""SLAMSystem: the sequential system, from a map already in WORKING state.

Port of the slice of orb_slam_tpu/pipeline/system.py that tracks and maps
once the map exists: `SlamConfig` (:64-170), `FrameData` (:172-183),
`reset` without the place-recognition, relocalisation and loop-closing
fields (:251-287), `process_batch`
(:316-347) over `extract_track_chunk` (the chunk of :349-415),
`_apply_chunk` (:417-492), `_refresh_local_mask` and `_track_mask`
(:692-715), `_apply_counters`, `_mapper_accepting`, `_need_new_keyframe`,
`_alloc_kf`, `_create_keyframe`, `_dispatch_keyframe` (:816-871),
`_integrate_keyframe` (:873-901), `_local_mapping` (:988-1176),
`_publish_mapped_pose`, `_compose_forward`, `_resolve_obs`,
`_reclaim_points` and `_repair_spanning_tree` (:1178-1242).

The host policy is the JAX package's numpy, verbatim: the neighbour
orders (`np.argsort`, quicksort order on equal weights), the free lists,
the gauge choice. Not ported yet, and refused with NotImplementedError:
initialisation (a state other than WORKING; ROADMAP A item 2), the
`_track` recovery ladder and relocalisation for a frame under
`min_track_inliers` (item 4), loop closing (item 5), and the sharded BA
(`mesh`). The chunk is not padded to `track_chunk_size`: frame b of a
chunk depends only on frames 0..b, so the padded frames JAX computes and
drops change nothing.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass, field, replace
from types import SimpleNamespace
import numpy as np
import torch

from orb_slam_tpu_torch.device import require_device
from orb_slam_tpu_torch.frontend.orb_extractor import ORBConfig, ORBExtractor
from orb_slam_tpu_torch.geometry.camera import CameraModel, undistorted_bounds
from orb_slam_tpu_torch.ops.matching import TH_HIGH
from orb_slam_tpu_torch.pipeline.chunk import extract_track_chunk
from orb_slam_tpu_torch.pipeline.mapping_kernels import (
    fuse_into_keyframe, insert_new_points, keyframe_redundancy,
    point_cull_stats, triangulate_new_points,
)
from orb_slam_tpu_torch.slam_map.covisibility import (
    covisibility_weights, local_point_mask,
)
from orb_slam_tpu_torch.slam_map.map_state import (
    MapConfig, MapState, empty_map, insert_keyframe, remove_keyframe,
    remove_points,
)
from orb_slam_tpu_torch.slam_map.observations import refresh_point_stats
from orb_slam_tpu_torch.solvers.local_ba import apply_edge_outliers, bundle_adjust

# Tracking states (reference: include/Tracking.h:57-64)
NO_IMAGES_YET = 0
NOT_INITIALIZED = 1
INITIALIZING = 2
WORKING = 3
LOST = 4

STATE_NAMES = {0: "NO_IMAGES_YET", 1: "NOT_INITIALIZED", 2: "INITIALIZING",
               3: "WORKING", 4: "LOST"}


def _np_se3_inverse(T):
    """Analytic SE3 inverse on the host (system.py:54-61)."""
    Rt = T[:3, :3].T
    out = np.eye(4, dtype=np.float32)
    out[:3, :3] = Rt
    out[:3, 3] = -(Rt @ T[:3, 3])
    return out


@dataclass
class SlamConfig:
    """The JAX SlamConfig's fields and defaults; the comments there give
    each one's reference."""

    camera: CameraModel = None
    orb: ORBConfig = field(default_factory=ORBConfig)
    map: MapConfig = None
    min_init_matches: int = 100
    min_init_keypoints: int = 100
    min_track_inliers: int = 30
    min_frames_between_kf: int = 0
    max_frames_between_kf: int = 18
    kf_tracked_ratio: float = 0.9
    n_triangulation_neighbors: int = 20
    n_fuse_neighbors: int = 20
    n_fuse_second_neighbors: int = 5
    local_ba_window: int = 0
    p_local: int = 4096
    track_radius: float = 15.0
    kf_cull_redundancy: float = 0.9
    enable_loop_closing: bool = True
    enable_relocalisation: bool = True
    vocabulary: object = None
    bow_slots: int = 0
    min_reloc_inliers: int = 50
    use_motion_model: bool = True
    track_local_map: bool = True
    track_chunk_size: int = 8
    mesh: object = None
    max_ba_cams: int = 80
    max_ba_points: int = 2048
    mapper_latency_frames: int = 0
    seed: int = 0

    def __post_init__(self):
        if self.camera is None:
            self.camera = CameraModel(500.0, 500.0, 320.0, 240.0)
        if self.map is None:
            self.map = MapConfig(n_features=self.orb.n_features,
                                 n_levels=self.orb.n_levels,
                                 scale_factor=self.orb.scale_factor)
        elif self.orb is not None and (
                self.map.n_levels != self.orb.n_levels
                or self.map.scale_factor != self.orb.scale_factor):
            # the extractor settings are authoritative for the pyramid
            self.map = replace(self.map, n_levels=self.orb.n_levels,
                               scale_factor=self.orb.scale_factor)
        self.p_local = min(self.p_local, self.map.max_points)
        self.max_ba_cams = min(self.max_ba_cams, self.map.max_keyframes)
        if self.max_ba_points:
            self.max_ba_points = min(
                max(256, (self.max_ba_points // 256) * 256),
                self.map.max_points)
        if not self.bow_slots:
            self.bow_slots = (self.orb.n_features if self.orb is not None
                              else self.map.n_features)


class FrameData:
    """One frame's features on the device: undistorted keypoints,
    descriptor words (int32), octave, angle, validity."""

    def __init__(self, xy_und, desc, octave, angle, valid, frame_id,
                 timestamp=0.0):
        self.xy = xy_und
        self.desc = desc
        self.octave = octave
        self.angle = angle
        self.valid = valid
        self.frame_id = frame_id
        self.timestamp = timestamp


class SLAMSystem:
    """Camera frames in, a pose per frame and a map out, on `device` (the
    card unless the caller names another). A system starts WORKING once
    its map holds a keyframe and points; the tests and chip_smoke.py set
    those fields from a seeded map (io/synthetic.py::seed_keyframe_map)."""

    def __init__(self, cfg: SlamConfig = None, device="cuda"):
        self.cfg = cfg or SlamConfig()
        self.device = require_device(device)
        cam = self.cfg.camera
        self.extractor = (ORBExtractor(self.cfg.orb, cam.height, cam.width,
                                       device=self.device)
                          if self.cfg.orb is not None else None)
        self.K = np.array([[cam.fx, 0.0, cam.cx], [0.0, cam.fy, cam.cy],
                           [0.0, 0.0, 1.0]], np.float32)
        self.K_dev = torch.from_numpy(self.K).to(self.device)
        self.img_bounds = tuple(float(v) for v in undistorted_bounds(cam))
        # per-stage timer of the local mapping (None = off): a callable
        # taking a stage name and returning a context manager
        self._stage_timer = None
        self.reset()

    # ------------------------------------------------------------------ setup

    def reset(self):
        """Full reset (Tracking::Reset, src/Tracking.cc:1026-1094)."""
        cfg = self.cfg
        self.state = NO_IMAGES_YET
        self.map = empty_map(cfg.map, self.device)
        self.free_kf = list(range(cfg.map.max_keyframes))
        self.free_pt = list(range(cfg.map.max_points))
        self.kf_order = np.full(cfg.map.max_keyframes, -1, np.int64)
        self.kf_counter = 0
        self.frame_id = 0
        self.last_pose = np.eye(4, dtype=np.float32)
        self.velocity = np.eye(4, dtype=np.float32)
        self.last_kf_frame = -10**9
        self.last_kf_slot = -1
        self.ref_kf_tracked = 0
        self.trajectory = []  # (frame_id, timestamp, T_cw numpy)
        self.loop_closer = None
        # merge-forwarding table (MapPoint::Replace's mpReplaced pointer)
        self.pt_forward = np.arange(cfg.map.max_points, dtype=np.int32)
        self.local_mask = None
        # LM iterations (phase 1, phase 2) of each local BA call, and the
        # counts of the last local mapping: points culled, created per
        # triangulation neighbour, features bound and points merged by fuse,
        # keyframes culled
        self.ba_iterations = []
        self.mapping_counts = {}

    # ------------------------------------------------------------------ entry

    def process_batch(self, images, timestamps=None, chunk_size=None):
        """Process frames in chunks, each one `extract_track_chunk` against
        the current map; the host replays each chunk's results and
        re-enters after a keyframe. Returns the list of poses."""
        B = len(images)
        if timestamps is None:
            timestamps = [None] * B
        C = max(chunk_size or self.cfg.track_chunk_size, 1)
        poses = []
        i = 0
        while i < B:
            if self.state != WORKING:
                raise NotImplementedError(
                    f"process_batch in state {STATE_NAMES[self.state]}: "
                    "initialisation is not ported yet (ROADMAP A item 2)")
            n = min(C, B - i)
            feats, xy_und, chunk = self._chunk_extract_track(images[i:i + n])
            consumed, chunk_poses = self._apply_chunk(
                feats, xy_und, chunk, n, timestamps[i:i + n])
            poses.extend(chunk_poses)
            i += consumed
        return poses

    def _chunk_extract_track(self, images):
        cfg = self.cfg
        imgs = torch.stack([torch.as_tensor(im) for im in images]).to(
            self.device, torch.float32)
        return extract_track_chunk(
            imgs, self.extractor, cfg.camera, self.map,
            torch.from_numpy(self.last_pose).to(self.device),
            torch.from_numpy(self.velocity).to(self.device), self.K_dev,
            self._track_mask(), p_local=cfg.p_local, radius=cfg.track_radius,
            bounds=self.img_bounds, min_inliers=cfg.min_track_inliers,
            use_motion_model=cfg.use_motion_model, max_dist=TH_HIGH)

    def _apply_chunk(self, feats, xy_und, chunk, n, ts_list):
        """Host replay of a chunk's per-frame results: trajectory, velocity,
        visibility counters, keyframe policy. Stops at the first keyframe;
        returns (frames consumed, poses)."""
        cfg = self.cfg
        cn_in = chunk.n_inliers.cpu().numpy()
        cposes = chunk.pose.cpu().numpy()
        cobs = chunk.obs.cpu().numpy()
        cvis = chunk.visible.cpu().numpy()
        P = cvis.shape[1]
        vis_sum = np.zeros(P, np.int32)
        found_sum = np.zeros(P, np.int32)
        counters_dirty = False

        def _flush_counters():
            nonlocal counters_dirty
            if counters_dirty:
                self._apply_counters(SimpleNamespace(
                    visible_inc=torch.from_numpy(vis_sum).to(self.device),
                    found_inc=torch.from_numpy(found_sum).to(self.device)))
                counters_dirty = False

        def _frame_data(b, fid, ts):
            return FrameData(xy_und[b], feats.desc_i32[b], feats.octave[b],
                             feats.angle[b], feats.valid[b], fid, ts)

        poses_out = []
        for b in range(n):
            fid = self.frame_id
            self.frame_id += 1
            ts = ts_list[b] if ts_list[b] is not None else fid / 30.0
            n_in = int(cn_in[b])
            if n_in < cfg.min_track_inliers:
                _flush_counters()
                self._track(_frame_data(b, fid, ts))    # raises, not ported
            self.state = WORKING
            T_new = cposes[b]
            vis_sum += cvis[b]
            pids = cobs[b][cobs[b] >= 0]
            np.add.at(found_sum, pids, 1)
            counters_dirty = True
            self.velocity = (
                T_new @ _np_se3_inverse(self.last_pose)).astype(np.float32)
            self.last_pose = T_new.astype(np.float32)
            self.trajectory.append((fid, ts, self.last_pose.copy()))
            poses_out.append(self.last_pose.copy())

            if self._need_new_keyframe(fid, n_in):
                _flush_counters()
                self._create_keyframe(_frame_data(b, fid, ts), chunk.obs[b],
                                      n_in)
                return b + 1, poses_out

        _flush_counters()
        return n, poses_out

    def _track(self, frame: FrameData):
        raise NotImplementedError(
            f"frame {frame.frame_id} tracked under min_track_inliers="
            f"{self.cfg.min_track_inliers}: the _track recovery ladder and "
            "relocalisation are not ported yet (ROADMAP A item 4)")

    # ---------------------------------------------------------------- tracking

    def _refresh_local_mask(self, ref_kf: int = None):
        """The local-map candidate mask from the reference keyframe (the
        newest surviving one if the reference was culled)."""
        if not self.cfg.track_local_map:
            self.local_mask = None
            return
        ref = self.last_kf_slot if ref_kf is None else ref_kf
        valid = self.map.kf_valid.cpu().numpy()
        if ref is None or ref < 0 or not valid[ref]:
            live = np.where(valid)[0]
            if len(live) == 0:
                self.local_mask = None
                return
            ref = int(live[np.argmax(self.kf_order[live])])
        self.local_mask = local_point_mask(self.map, int(ref))

    def _track_mask(self):
        return (self.local_mask if self.local_mask is not None
                else self.map.pt_valid)

    def _apply_counters(self, res):
        """MapPoint::IncreaseVisible/Found."""
        self.map = self.map.replace(
            pt_visible=self.map.pt_visible + res.visible_inc,
            pt_found=self.map.pt_found + res.found_inc)

    def _mapper_accepting(self) -> bool:
        """SetAcceptKeyFrames backpressure as a fixed latency
        (LocalMapping.cc:507-517)."""
        return (self.frame_id - self.last_kf_frame
                >= self.cfg.mapper_latency_frames)

    def _need_new_keyframe(self, frame_id: int, n_inliers: int) -> bool:
        """Reference policy c1a/c1b/c2 (src/Tracking.cc:625-663)."""
        cfg = self.cfg
        if not self.free_pt or not self.free_kf:
            return False
        since = frame_id - self.last_kf_frame
        c1a = since >= cfg.max_frames_between_kf
        c1b = since >= cfg.min_frames_between_kf and self._mapper_accepting()
        degraded = n_inliers < self.ref_kf_tracked * cfg.kf_tracked_ratio
        starving = n_inliers < 2 * cfg.min_track_inliers
        c2 = (degraded or starving) and n_inliers > 15
        return (c1a or c1b) and c2

    # ----------------------------------------------------------- local mapping

    def _alloc_kf(self) -> int:
        slot = self.free_kf.pop(0)
        self.kf_order[slot] = self.kf_counter
        self.kf_counter += 1
        return slot

    def _create_keyframe(self, frame: FrameData, obs, n_inliers: int):
        self.last_kf_frame = frame.frame_id
        self.ref_kf_tracked = n_inliers
        self._dispatch_keyframe(frame, obs, n_inliers, self.last_pose.copy())

    def _dispatch_keyframe(self, frame: FrameData, obs, n_inliers: int, pose):
        """Sequential mode: the whole mapping pipeline inline."""
        self._integrate_keyframe(frame, obs, n_inliers, pose)

    def _integrate_keyframe(self, frame: FrameData, obs, n_inliers: int,
                            pose=None, abort=None):
        """KF insertion + LocalMapping (Tracking::CreateNewKeyFrame +
        LocalMapping::Run). `abort` is polled between stages
        (InterruptBA, LocalMapping.cc:519-522)."""
        if pose is None:
            pose = self.last_pose
        obs = self._resolve_obs(obs)
        slot = self._alloc_kf()
        self.map = insert_keyframe(
            self.map, slot, torch.as_tensor(pose).to(self.device),
            frame.frame_id, frame.xy, frame.octave, frame.angle, frame.desc,
            frame.valid, obs, self.last_kf_slot)
        self.last_kf_slot = slot
        self._local_mapping(slot, abort=abort)
        if (self.cfg.enable_loop_closing and self.loop_closer is not None
                and bool(self.map.kf_valid[slot])):
            raise NotImplementedError(
                "loop closing is not ported yet (ROADMAP A item 5)")
        return slot

    def _stage(self, name):
        """The stage timer's context for `name`, or a no-op."""
        if self._stage_timer is None:
            return contextlib.nullcontext()
        return self._stage_timer(name)

    def _covisible_neighbors(self, m, kf: int):
        """(W [K, K] as numpy, kf_valid as numpy, the live keyframes sharing
        >= 15 points with `kf`, by weight as np.argsort(-W) orders them)."""
        W_np = covisibility_weights(m).cpu().numpy()
        kf_valid = m.kf_valid.cpu().numpy()
        order = np.argsort(-W_np[kf])
        neighbors = [int(k) for k in order if W_np[kf, k] >= 15
                     and bool(kf_valid[k]) and k != kf]
        return W_np, kf_valid, neighbors

    def _local_ba_sets(self, m, new_kf: int, neighbors):
        """(cam_opt [K], pt_opt [P]) of the local BA around `new_kf`: it and
        its first neighbours up to the window, minus the two oldest
        keyframes (the gauge), and every live point they observe."""
        cfg = self.cfg
        ba_window = cfg.local_ba_window or len(neighbors)
        if cfg.max_ba_cams:
            ba_window = min(ba_window, cfg.max_ba_cams - 1)
        local = [new_kf] + neighbors[:ba_window]
        cam_opt_np = np.zeros(cfg.map.max_keyframes, bool)
        cam_opt_np[local] = True
        # gauge: keep the two oldest keyframes fixed
        order_vals = self.kf_order.copy()
        fixed_gauge = np.argsort(np.where(order_vals >= 0, order_vals,
                                          10**9))[:2]
        cam_opt_np[fixed_gauge] = False
        cam_opt = torch.from_numpy(cam_opt_np).to(self.device) & m.kf_valid
        local_pts_mask = np.zeros(cfg.map.max_points, bool)
        obs_np = m.kf_obs[torch.as_tensor(local)].cpu().numpy()
        local_pts_mask[obs_np[obs_np >= 0]] = True
        pt_opt = torch.from_numpy(local_pts_mask).to(self.device) & m.pt_valid
        return cam_opt, pt_opt

    def _local_mapping(self, new_kf: int, abort=None):
        cfg = self.cfg
        m = self.map
        aborted = lambda: abort is not None and abort()
        sf, nl = cfg.map.scale_factor, cfg.map.n_levels

        # --- covisibility + spanning parent (ProcessNewKeyFrame) ---
        with self._stage("covisibility+point culling"):
            W_np, kf_valid, neighbors = self._covisible_neighbors(m, new_kf)
            if neighbors:
                sp = m.spanning_parent.clone()
                sp[new_kf] = neighbors[0]
                m = m.replace(spanning_parent=sp)

            # --- MapPointCulling (LocalMapping.cc:175-203) ---
            ratio, n_obs, _ = point_cull_stats(m, self.kf_counter)
            ratio, n_obs = ratio.cpu().numpy(), n_obs.cpu().numpy()
            first = m.pt_first_kf.cpu().numpy()
            first_order = np.where(first >= 0,
                                   self.kf_order[np.clip(first, 0, None)], -1)
            age = self.kf_counter - first_order
            valid = m.pt_valid.cpu().numpy()
            kill = valid & (
                ((age <= 3) & (ratio < 0.25))
                | ((age >= 2) & (age <= 3) & (n_obs <= 2)))
            counts = self.mapping_counts = dict(
                culled=int(kill.sum()), created=[], fuse_bound=0, merged=0,
                kf_culled=0)
            if kill.any():
                m = remove_points(m, torch.from_numpy(kill).to(self.device))
                self.free_pt.extend(int(i) for i in np.where(kill)[0])
                self.free_pt = sorted(set(self.free_pt))

        # --- CreateNewMapPoints with the top covisible neighbours, behind
        # the baseline gate (LocalMapping.cc:230-235) ---
        with self._stage("triangulation+insertion"):
            poses_np = m.kf_pose.cpu().numpy()
            pos_np = m.pt_pos.cpu().numpy()
            obs_new = m.kf_obs[new_kf].cpu().numpy()
            bound_pts = pos_np[obs_new[obs_new >= 0]]
            if len(bound_pts):
                pc = (bound_pts @ poses_np[new_kf][:3, :3].T
                      + poses_np[new_kf][:3, 3])
                median_depth = max(float(np.median(pc[:, 2])), 1e-6)
            else:
                median_depth = 1.0
            C_new = -poses_np[new_kf][:3, :3].T @ poses_np[new_kf][:3, 3]
            tri_neighbors = []
            for nb in neighbors:
                C_nb = -poses_np[nb][:3, :3].T @ poses_np[nb][:3, 3]
                if np.linalg.norm(C_new - C_nb) / median_depth > 0.01:
                    tri_neighbors.append(nb)
                if len(tri_neighbors) >= cfg.n_triangulation_neighbors:
                    break
            for nb in tri_neighbors:
                if not self.free_pt or aborted():
                    break
                cand = triangulate_new_points(m, new_kf, nb, self.K_dev,
                                              scale_factor=sf)
                n_free = min(len(self.free_pt), 512)
                free = np.full(512, -1, np.int32)
                free[:n_free] = self.free_pt[:n_free]
                m, n_created = insert_new_points(
                    m, new_kf, nb, cand, torch.from_numpy(free).to(self.device))
                n_created = int(n_created)
                counts["created"].append(n_created)
                if n_created:
                    # recycled slots hold new points: forwarding entries
                    # aimed at them die, the slots become identities again
                    reused = np.asarray(self.free_pt[:n_created])
                    stale = np.isin(self.pt_forward, reused)
                    stale[reused] = False
                    self.pt_forward[stale] = -1
                    self.pt_forward[reused] = reused
                    self.free_pt = self.free_pt[n_created:]

        # --- SearchInNeighbors: two-way fuse with the first neighbours and
        # 5 second-order covisibles of each, deduplicated
        # (LocalMapping.cc:373-450) ---
        with self._stage("fuse"):
            fuse_targets = []
            seen_t = {new_kf}
            for nb in neighbors[: cfg.n_fuse_neighbors]:
                if nb not in seen_t:
                    fuse_targets.append(nb)
                    seen_t.add(nb)
                order2 = np.argsort(-W_np[nb])
                n2 = 0
                for k2 in order2:
                    if n2 >= cfg.n_fuse_second_neighbors:
                        break
                    k2 = int(k2)
                    if W_np[nb, k2] < 15 or not bool(kf_valid[k2]):
                        continue
                    n2 += 1
                    if k2 not in seen_t:
                        fuse_targets.append(k2)
                        seen_t.add(k2)
            fkw = dict(width=cfg.camera.width, height=cfg.camera.height,
                       scale_factor=sf, n_levels=nl, bounds=self.img_bounds)
            for nb in fuse_targets:
                m, b1, g1, remap1 = fuse_into_keyframe(m, new_kf, nb,
                                                       self.K_dev, **fkw)
                m, b2, g2, remap2 = fuse_into_keyframe(m, nb, new_kf,
                                                       self.K_dev, **fkw)
                self._compose_forward(remap1)
                self._compose_forward(remap2)
                counts["fuse_bound"] += int(b1) + int(b2)
                counts["merged"] += int(g1) + int(g2)
            self._reclaim_points(m)

        with self._stage("refresh_point_stats"):
            m = refresh_point_stats(m, scale_factor=sf, n_levels=nl)

        # --- Local BA (Optimizer.cc:287-536) ---
        cam_opt, pt_opt = self._local_ba_sets(m, new_kf, neighbors)
        bkw = dict(mesh=cfg.mesh, max_opt_cams=cfg.max_ba_cams or None,
                   max_opt_pts=cfg.max_ba_points or None, scale_factor=sf,
                   iterations=self.ba_iterations)
        # two abortable phases (g2o's setForceStopFlag, Optimizer.cc:351-352)
        with self._stage("BA phase 1"):
            m, outlier, (okf, ofeat) = bundle_adjust(
                m, self.K_dev, cam_opt, pt_opt, iters1=5, iters2=0, **bkw)
            m = apply_edge_outliers(m, outlier, okf, ofeat)
        if not aborted():
            with self._stage("BA phase 2"):
                m, outlier, (okf, ofeat) = bundle_adjust(
                    m, self.K_dev, cam_opt, pt_opt, iters1=0, iters2=10, **bkw)
                m = apply_edge_outliers(m, outlier, okf, ofeat)
        self._reclaim_points(m)

        # --- KeyFrameCulling over all covisible keyframes of the new one
        # (LocalMapping.cc:524-578) ---
        with self._stage("keyframe culling"):
            for nb in neighbors:
                if self.kf_order[nb] < 2:
                    continue  # never cull the gauge keyframes
                red, n_bound = keyframe_redundancy(m, nb)
                if float(red) > cfg.kf_cull_redundancy and int(n_bound) > 20:
                    m = remove_keyframe(m, nb)
                    m = self._repair_spanning_tree(m, nb)
                    self.free_kf.append(nb)
                    self.kf_order[nb] = -1
                    counts["kf_culled"] += 1

        with self._stage("final refresh+local mask"):
            self.map = refresh_point_stats(m, scale_factor=sf, n_levels=nl)
            self._refresh_local_mask(
                new_kf if bool(self.map.kf_valid[new_kf]) else None)
            self._publish_mapped_pose(new_kf)

    def _publish_mapped_pose(self, new_kf: int):
        """The tracker adopts the BA-refined keyframe pose."""
        self.last_pose = self.map.kf_pose[new_kf].cpu().numpy()

    def _compose_forward(self, remap):
        """Fold a fuse remap ([P], -1 = dead end) into the forwarding
        table."""
        r = remap.cpu().numpy() if torch.is_tensor(remap) else np.asarray(remap)
        f = self.pt_forward
        ok = f >= 0
        f[ok] = r[f[ok]]
        self.pt_forward = f

    def _resolve_obs(self, obs):
        """Stale feature->point bindings through the forwarding table and
        current validity (the mpReplaced chase, then isBad())."""
        obs_np = obs.cpu().numpy() if torch.is_tensor(obs) else np.asarray(obs)
        P = self.pt_forward.shape[0]
        tgt = np.where(obs_np >= 0,
                       self.pt_forward[np.clip(obs_np, 0, P - 1)], -1)
        pt_valid = self.map.pt_valid.cpu().numpy()
        live = (tgt >= 0) & pt_valid[np.clip(tgt, 0, P - 1)]
        return torch.from_numpy(np.where(live, tgt, -1).astype(np.int32)).to(
            self.device)

    def _reclaim_points(self, m: MapState):
        """The point free list from validity (pt_valid is authoritative)."""
        valid = m.pt_valid.cpu().numpy()
        self.free_pt = [int(i) for i in np.where(~valid)[0]]

    def _repair_spanning_tree(self, m: MapState, removed_kf: int):
        """Re-parent a culled keyframe's children with the reference's
        greedy candidate loop (KeyFrame::SetBadFlag, KeyFrame.cc:497-588)."""
        sp = m.spanning_parent.cpu().numpy()
        parent = int(sp[removed_kf])
        children = set(int(c) for c in np.where(sp == removed_kf)[0])
        if not children:
            return m
        spn = np.array(sp)
        if parent >= 0:
            W = covisibility_weights(m).cpu().numpy()
            candidates = {parent}
            while children:
                best_w, best_child, best_parent = 0, -1, -1
                for c in children:
                    for p in candidates:
                        if W[c, p] > best_w:
                            best_w, best_child, best_parent = W[c, p], c, p
                if best_child < 0:
                    break
                spn[best_child] = best_parent
                candidates.add(best_child)
                children.remove(best_child)
        for c in children:
            spn[c] = parent
        return m.replace(spanning_parent=torch.from_numpy(spn).to(self.device))

    # ------------------------------------------------------------------ output

    @property
    def n_keyframes(self):
        return int(self.map.kf_valid.sum())

    @property
    def n_points(self):
        return int(self.map.pt_valid.sum())
