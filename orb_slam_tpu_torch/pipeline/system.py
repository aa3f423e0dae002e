"""SLAMSystem: the sequential system, from raw frames to a tracked,
mapped camera path that recovers a lost frame against its keyframe
database and closes loops.

Port of orb_slam_tpu/pipeline/system.py: `SlamConfig` (:64-170),
`FrameData` (:172-183), the 2x-feature init extractor (:194-202), `reset`
(:251-287), `make_frame` (:291-312), `process_batch` (:316-347) over
`extract_track_chunk` (the chunk of :349-415), `_apply_chunk` (:417-492),
`process` (:494-508), `_first_initialization` and `_try_initialize`
(:512-657), `_setup_place_recognition` with the loop closer (:659-689),
`_refresh_local_mask` and `_track_mask` (:692-715), `_track` with the
recovery ladder (:717-814), `_apply_counters`, `_mapper_accepting`,
`_need_new_keyframe`, `_alloc_kf`, `_create_keyframe`,
`_dispatch_keyframe` (:816-871), `_integrate_keyframe` with its loop
branch and BoW add (:873-901), `_run_loop_closing` (:903-910),
`_relocalize` (:912-986), `_local_mapping` with the database erase of a
culled keyframe (:988-1176), `_publish_mapped_pose`, `_compose_forward`,
`_resolve_obs`, `_reclaim_points`, `_repair_spanning_tree` (:1178-1242)
and `keyframe_trajectory` (:1246-1262).

The host policy is the JAX package's numpy, verbatim: the neighbour
orders (`np.argsort`, quicksort order on equal weights), the free lists,
the gauge choice, the 2N -> N compaction of the initial keyframes, the
relocalisation candidates and their order. The keyframe database and the
loop closer (pipeline/loop_closing.py) are built once the initial map
exists, from the shipped vocabulary; while the loop closer is set, each
integrated keyframe goes through `LoopCloser.process`, whose detection
adds its BoW to the database, else the keyframe takes the database's BoW
add. `SlamConfig.mesh` (:103-105), a `parallel.Mesh`, shards every
bundle adjustment of the system over the mesh's devices, as JAX passes it
to each `bundle_adjust` (:639, :1137, :1148): the initial two-view BA of
`_try_initialize` and both local-BA phases of `_local_mapping`. The map,
the tracker and every other stage stay on the system's device; only BA's
point arrays go out to the shards, and the new points, poses and outlier
table come back before `bundle_adjust` returns (solvers/local_ba.py).
`max_ba_points` stays a multiple of 256 (:159), so a `data` axis of 2, 4
or 8 divides it. The RANSAC draws of the
initialisation, the relocalisation and the loop closer come from
`torch.Generator`s seeded with `cfg.seed` on the system's device: they
cannot repeat `jax.random`'s, and the parity tests replace
`_minimal_sets`, `_reloc_sets` and `LoopCloser._sim3_sets` to inject
JAX's. The chunk is not padded to `track_chunk_size`: frame b of a chunk
depends only on frames 0..b, so the padded frames JAX computes and drops
change nothing. `_relocalize` and the loop closer run their stages under
`_stage` ("reloc ...", "loop ...") so a stage timer can split them.
Spans (`_span`, which never synchronize) name the rest of the path for
the same timer: the chunk's `chunk.upload`, `chunk.extract`,
`chunk.track`, `chunk.stack`, its host replay `chunk.replay` with its
only two children, a weak frame's `chunk.retrack` and a keyframe's
`chunk.keyframe` (so the replay's self time is its total less theirs),
`frame.single` around `process`, and
`mapping.integrate` around each keyframe integration with its
`mapping.insert`, `local_ba.sets` and `mapping.reclaim`; counters
(`_count`) record each chunk's frames extracted and used and why it
stopped, the frames through `process`, each integration's neighbours,
and each tracked frame (`track.frames`) with its inliers
(`track.inliers`), on the chunk's replay and on `_track` alike, from
the counts the host reads anyway. Both live on the timer: with none
installed a span is a `nullcontext` and a counter nothing, and neither
reads the device.
With SLAM_DEBUG set, local mapping logs its events through `utils/log.py`
at JAX's sites (:1019-1164); a message that reads the device sits behind
`if DEBUG:`, so without it the log adds no host sync. The threaded system
is pipeline/async_system.py, which overrides the hooks `_apply_counters`,
`_mapper_accepting`, `_dispatch_keyframe`, `_run_loop_closing` and
`_publish_mapped_pose`.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass, field, replace
from types import SimpleNamespace
import numpy as np
import torch

from orb_slam_tpu_torch.device import require_device
from orb_slam_tpu_torch.frontend.orb_extractor import ORBConfig, ORBExtractor
from orb_slam_tpu_torch.geometry.camera import (
    CameraModel, undistort_points, undistorted_bounds,
)
from orb_slam_tpu_torch.geometry.se3 import se3_inverse
from orb_slam_tpu_torch.geometry.so3 import rot_to_quat
from orb_slam_tpu_torch.ops.image import to_grayscale
from orb_slam_tpu_torch.ops.matching import TH_HIGH, TH_LOW, match, window_gate
from orb_slam_tpu_torch.pipeline.chunk import extract_track_chunk
from orb_slam_tpu_torch.pipeline.loop_closing import LoopCloser
from orb_slam_tpu_torch.pipeline.mapping_kernels import (
    fuse_into_keyframe, insert_new_points, keyframe_redundancy,
    point_cull_stats, triangulate_new_points,
)
from orb_slam_tpu_torch.pipeline.track_kernels import (
    track_frame, track_prev_frame,
)
from orb_slam_tpu_torch.place import KeyFrameDatabase, train_vocabulary
from orb_slam_tpu_torch.place.pretrained import load_pretrained
from orb_slam_tpu_torch.slam_map.covisibility import (
    covisibility_weights, local_point_mask,
)
from orb_slam_tpu_torch.slam_map.map_state import (
    MapConfig, MapState, add_points, empty_map, insert_keyframe,
    remove_keyframe, remove_points,
)
from orb_slam_tpu_torch.slam_map.observations import refresh_point_stats
from orb_slam_tpu_torch.solvers.epnp import epnp_ransac
from orb_slam_tpu_torch.solvers.local_ba import apply_edge_outliers, bundle_adjust
from orb_slam_tpu_torch.solvers.pose_opt import pose_optimize
from orb_slam_tpu_torch.solvers.two_view import (
    initialize_two_view, sample_minimal_sets,
)
from orb_slam_tpu_torch.utils.log import DEBUG, dbg

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
    mesh: object = None          # a parallel.Mesh: every BA shards over it
    max_ba_cams: int = 80
    max_ba_points: int = 2048
    mapper_latency_frames: int = 0
    seed: int = 0

    def __post_init__(self):
        if self.camera is None:
            self.camera = CameraModel.create(500.0, 500.0, 320.0, 240.0)
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
        # a multiple of 256, so the sharded BA divides a small `data` axis
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
    """Camera frames (or oracle features) in, a pose per frame and a map
    out, on `device` (the card unless the caller names another)."""

    def __init__(self, cfg: SlamConfig = None, device="cuda"):
        self.cfg = cfg or SlamConfig()
        self.device = require_device(device)
        cam = self.cfg.camera
        if self.cfg.orb is not None:
            self.extractor = ORBExtractor(self.cfg.orb, cam.height, cam.width,
                                          device=self.device)
            # the initialisation extracts twice the features (the
            # reference's mpIniORBextractor, Tracking.cc:111,126); the
            # initial keyframes are compacted back to n_features
            self.extractor_init = ORBExtractor(
                replace(self.cfg.orb, n_features=2 * self.cfg.orb.n_features),
                cam.height, cam.width, device=self.device)
        else:
            # oracle features only: process(features=...)
            self.extractor = self.extractor_init = None
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
        self.init_ref = None
        # the previous frame and its feature->point bindings, for the
        # TrackPreviousFrame ladder (Tracking.cc:486-552)
        self._prev_frame = None
        self.last_kf_frame = -10**9
        self.last_kf_slot = -1
        self.ref_kf_tracked = 0
        self.trajectory = []  # (frame_id, timestamp, T_cw numpy)
        self.lost_count = 0
        # the RANSAC draws of the initialisation and the relocalisation
        # (JAX: a PRNGKey from cfg.seed, split per draw)
        self._gen = torch.Generator(device=self.device).manual_seed(cfg.seed)
        self.vocab = cfg.vocabulary
        self.db = None
        self.loop_closer = None
        self.n_loops_closed = 0
        self.n_relocs = 0
        # merge-forwarding table (MapPoint::Replace's mpReplaced pointer)
        self.pt_forward = np.arange(cfg.map.max_points, dtype=np.int32)
        self.local_mask = None
        # LM iterations (phase 1, phase 2) of each local BA call, and the
        # counts of the last local mapping: points culled, created per
        # triangulation neighbour, features bound and points merged by fuse,
        # keyframes culled
        self.ba_iterations = []
        self.mapping_counts = {}

    # --------------------------------------------------------------- frontend

    def make_frame(self, img=None, features=None, timestamp=None) -> FrameData:
        """FrameData from an image (ORB extraction and undistortion; the 2x
        init extractor before WORKING, Tracking.cc:199-202) or from oracle
        features (a dict of xy, desc as uint32 words, octave, angle, valid,
        as numpy; the words become int32 tensors of the same bits)."""
        ts = self.frame_id / 30.0 if timestamp is None else timestamp
        dev = self.device
        if features is not None:
            desc = np.asarray(features["desc"]).astype(np.uint32).view(np.int32)
            return FrameData(
                torch.as_tensor(np.asarray(features["xy"], np.float32)).to(dev),
                torch.from_numpy(np.ascontiguousarray(desc)).to(dev),
                torch.as_tensor(np.asarray(features["octave"], np.int32)).to(dev),
                torch.as_tensor(np.asarray(features["angle"], np.float32)).to(dev),
                torch.as_tensor(np.asarray(features["valid"], bool)).to(dev),
                self.frame_id, ts)
        gray = to_grayscale(torch.as_tensor(img).to(dev))
        init = self.state in (NO_IMAGES_YET, NOT_INITIALIZED, INITIALIZING)
        f = (self.extractor_init if init else self.extractor)(gray)
        return FrameData(undistort_points(self.cfg.camera, f.xy), f.desc_i32,
                         f.octave, f.angle, f.valid, self.frame_id, ts)

    # ------------------------------------------------------------------ entry

    def process_batch(self, images, timestamps=None, chunk_size=None):
        """Process frames in chunks, each one `extract_track_chunk` against
        the current map; the host replays each chunk's results and
        re-enters after a keyframe or a weak frame. Frames before
        initialisation, while LOST, at a chunk size of 1 and the last
        single frame go through `process`, as in JAX. Returns the list of
        poses (None where untracked)."""
        B = len(images)
        if timestamps is None:
            timestamps = [None] * B
        C = chunk_size or self.cfg.track_chunk_size
        poses = []
        i = 0
        while i < B:
            if self.state != WORKING or C <= 1 or B - i == 1:
                poses.append(self.process(img=images[i],
                                          timestamp=timestamps[i]))
                i += 1
                continue
            n = min(C, B - i)
            feats, xy_und, chunk = self._chunk_extract_track(images[i:i + n])
            consumed, chunk_poses = self._apply_chunk(
                feats, xy_und, chunk, n, timestamps[i:i + n])
            self._count("chunk.frames_extracted", n)
            self._count("chunk.frames_used", consumed)
            poses.extend(chunk_poses)
            i += consumed
        return poses

    def _chunk_extract_track(self, images):
        cfg = self.cfg
        fid = self.frame_id
        with self._span("chunk.upload", fid):
            imgs = to_grayscale(torch.stack([torch.as_tensor(im) for im in images])
                                .to(self.device))
            pose = torch.from_numpy(self.last_pose).to(self.device)
            vel = torch.from_numpy(self.velocity).to(self.device)
        return extract_track_chunk(
            imgs, self.extractor, cfg.camera, self.map, pose, vel, self.K_dev,
            self._track_mask(), p_local=cfg.p_local, radius=cfg.track_radius,
            bounds=self.img_bounds, min_inliers=cfg.min_track_inliers,
            use_motion_model=cfg.use_motion_model, max_dist=TH_HIGH,
            span=lambda name: self._span(name, fid))

    def _apply_chunk(self, feats, xy_und, chunk, n, ts_list):
        """Host replay of a chunk's per-frame results: trajectory, velocity,
        visibility counters, keyframe policy. Stops at the first keyframe;
        re-tracks a weak frame through `_track` (the ladder, LOST) and stops
        there too, each under a span of its own (`chunk.keyframe`,
        `chunk.retrack`); returns (frames consumed, poses). Counts why it
        stopped (`chunk.exit_keyframe`, `chunk.exit_weak`,
        `chunk.exit_end`)."""
        with self._span("chunk.replay", self.frame_id):
            return self._replay_chunk(feats, xy_und, chunk, n, ts_list)

    def _replay_chunk(self, feats, xy_und, chunk, n, ts_list):
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
                # the chunk runs without the ladder: this frame again
                # through _track, which sees frame b-1 as _prev_frame
                _flush_counters()
                with self._span("chunk.retrack", fid):
                    T = self._track(_frame_data(b, fid, ts))
                poses_out.append(None if T is None else self.last_pose.copy())
                self._count("chunk.exit_weak")
                return b + 1, poses_out
            self.state = WORKING
            self._count_tracked(n_in)
            T_new = cposes[b]
            vis_sum += cvis[b]
            pids = cobs[b][cobs[b] >= 0]
            np.add.at(found_sum, pids, 1)
            counters_dirty = True
            self._prev_frame = (_frame_data(b, fid, ts), chunk.obs[b])
            self.velocity = (
                T_new @ _np_se3_inverse(self.last_pose)).astype(np.float32)
            self.last_pose = T_new.astype(np.float32)
            self.trajectory.append((fid, ts, self.last_pose.copy()))
            poses_out.append(self.last_pose.copy())

            if self._need_new_keyframe(fid, n_in):
                _flush_counters()
                with self._span("chunk.keyframe", fid):
                    self._create_keyframe(_frame_data(b, fid, ts),
                                          chunk.obs[b], n_in)
                self._count("chunk.exit_keyframe")
                return b + 1, poses_out

        _flush_counters()
        self._count("chunk.exit_end")
        return n, poses_out

    def process(self, img=None, features=None, timestamp=None):
        """Process one frame; returns its pose (numpy [4, 4]) or None while
        not initialised or lost."""
        self._count("frames.single")
        with self._span("frame.single", self.frame_id):
            frame = self.make_frame(img, features, timestamp)
            self.frame_id += 1
            if self.state in (NO_IMAGES_YET, NOT_INITIALIZED):
                self._first_initialization(frame)
                return None
            if self.state == INITIALIZING:
                ok = self._try_initialize(frame)
                return self.last_pose.copy() if ok else None
            if self.state in (WORKING, LOST):
                return self._track(frame)
            return None

    # --------------------------------------------------------- initialization

    def _first_initialization(self, frame: FrameData):
        """Tracking::FirstInitialization (src/Tracking.cc:320-338)."""
        if int(frame.valid.sum()) > self.cfg.min_init_keypoints:
            self.init_ref = frame
            self.state = INITIALIZING

    def _minimal_sets(self, valid):
        """The [200, 8] minimal sets of one initialisation attempt (JAX
        splits its key for each attempt, system.py:544)."""
        return sample_minimal_sets(valid, 200, 8, generator=self._gen)

    def _reloc_sets(self, valid):
        """The [128, 4] minimal sets of one candidate's EPnP RANSAC (JAX
        splits its key for each candidate that reaches EPnP,
        system.py:942)."""
        return sample_minimal_sets(valid, 128, 4, generator=self._gen)

    def _try_initialize(self, frame: FrameData) -> bool:
        """Tracking::Initialize + CreateInitialMap (src/Tracking.cc:341-483):
        match against the reference frame, the two-view bootstrap, the map
        scaled to unit median depth, two keyframes and their points, and a
        global BA of the two views."""
        cfg = self.cfg
        dev = self.device
        ref = self.init_ref
        if int(frame.valid.sum()) <= cfg.min_init_keypoints:
            self.state = NOT_INITIALIZED
            self.init_ref = None
            return False

        # SearchForInitialization: 100 px window, mutual best, every level,
        # rotation check on
        gate = window_gate(ref.xy, frame.xy, 100.0)
        idx, _, ok = match(
            ref.desc, frame.desc, allowed=gate, valid_a=ref.valid,
            valid_b=frame.valid, angle_a=ref.angle, angle_b=frame.angle,
            max_dist=TH_LOW, nn_ratio=0.9, mutual=True, check_rotation=True,
            unique=True)
        if int(ok.sum()) < cfg.min_init_matches:
            self.init_ref = frame       # the reference resets; JAX rolls
            return False

        res = initialize_two_view(ref.xy, frame.xy[idx], ok, self.K_dev,
                                  idx=self._minimal_sets(ok))
        if not bool(res.success):
            return False

        # ---- the initial map ----
        tri = res.is_triangulated.cpu().numpy()
        pts = res.points3d.cpu().numpy()
        T1 = np.eye(4, dtype=np.float32)
        T2 = np.eye(4, dtype=np.float32)
        T2[:3, :3] = res.R21.cpu().numpy()
        T2[:3, 3] = res.t21.cpu().numpy()

        # median-depth scale normalisation (Tracking.cc:439-463)
        depths = pts[tri][:, 2]
        if len(depths) < 30:
            return False
        med = float(np.median(depths))
        if med <= 0:
            return False
        inv_med = 1.0 / med
        pts = pts * inv_med
        T2[:3, 3] *= inv_med

        N = cfg.map.n_features
        Nf = int(ref.xy.shape[0])   # 2N with the init extractor
        pt_slots = np.full(Nf, -1, np.int32)
        tri_idx = np.where(tri)[0]
        # new points capped by the free list and (after compaction) N
        n_new = min(len(tri_idx), len(self.free_pt), N)
        tri_idx = tri_idx[:n_new]
        slots = [self.free_pt.pop(0) for _ in range(n_new)]
        pt_slots[tri_idx] = slots

        idx_np = idx.cpu().numpy()
        ok_np = ok.cpu().numpy()
        tri_dev = torch.from_numpy(tri_idx).to(dev)
        point_desc = ref.desc[tri_dev]      # before the compaction
        cur_pt = np.full(Nf, -1, np.int32)
        cur_pt[idx_np[tri_idx]] = pt_slots[tri_idx]

        if Nf > N:
            # the 2x-feature init frames compacted to the map's N feature
            # slots: point-bearing features first, then matched, then any
            # valid detection
            vr = ref.valid.cpu().numpy()
            prio_ref = np.where(pt_slots >= 0, 0,
                                np.where(ok_np & vr, 1, np.where(vr, 2, 3)))
            order_ref = np.argsort(prio_ref, kind="stable")[:N]
            vc = frame.valid.cpu().numpy()
            prio_cur = np.where(cur_pt >= 0, 0, np.where(vc, 2, 3))
            order_cur = np.argsort(prio_cur, kind="stable")[:N]

            def _subset(fr, order):
                o = torch.from_numpy(order).to(dev)
                return FrameData(fr.xy[o], fr.desc[o], fr.octave[o],
                                 fr.angle[o], fr.valid[o], fr.frame_id,
                                 fr.timestamp)

            ref = _subset(ref, order_ref)
            frame = _subset(frame, order_cur)
            obs1, obs2 = pt_slots[order_ref], cur_pt[order_cur]
        else:
            obs1, obs2 = pt_slots, cur_pt

        k1 = self._alloc_kf()
        k2 = self._alloc_kf()
        t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
        m = insert_keyframe(self.map, k1, t(T1), ref.frame_id, ref.xy,
                            ref.octave, ref.angle, ref.desc, ref.valid,
                            t(obs1), -1)
        m = insert_keyframe(m, k2, t(T2), frame.frame_id, frame.xy,
                            frame.octave, frame.angle, frame.desc, frame.valid,
                            t(obs2), k1)
        n_pts = len(tri_idx)
        m = add_points(m, t(pt_slots[tri_idx]), t(pts[tri_idx]), point_desc,
                       torch.full((n_pts,), k1, dtype=torch.int32, device=dev),
                       torch.full((n_pts,), k1, dtype=torch.int32, device=dev),
                       torch.ones(n_pts, dtype=torch.bool, device=dev))
        # global BA of the two views (GlobalBundleAdjustemnt(map, 20)), the
        # first keyframe fixed
        cam_opt = torch.arange(cfg.map.max_keyframes, device=dev) == k2
        sf = cfg.map.scale_factor
        m, outlier, (okf, ofeat) = bundle_adjust(
            m, self.K_dev, cam_opt, m.pt_valid, iters1=10, iters2=10,
            mesh=cfg.mesh, max_opt_pts=cfg.max_ba_points or None,
            scale_factor=sf)
        m = apply_edge_outliers(m, outlier, okf, ofeat, kill_starved=False)
        self.map = refresh_point_stats(m, scale_factor=sf,
                                       n_levels=cfg.map.n_levels)

        self.last_pose = self.map.kf_pose[k2].cpu().numpy().copy()
        self.velocity = np.eye(4, dtype=np.float32)
        self.last_kf_frame = frame.frame_id
        self.last_kf_slot = k2
        self.ref_kf_tracked = n_pts
        self.trajectory.append((ref.frame_id, ref.timestamp, T1.copy()))
        self.trajectory.append(
            (frame.frame_id, frame.timestamp, self.last_pose.copy()))
        self.state = WORKING
        self._refresh_local_mask()
        self._setup_place_recognition(k1, k2, ref, frame)
        return True

    def _setup_place_recognition(self, k1, k2, ref, frame):
        """The vocabulary (the shipped one unless the config names one; a
        small tree trained on the two initial frames if none is shipped)
        and the keyframe database on the system's device, with both
        initial keyframes added, and the loop closer, once the initial map
        exists (JAX system.py:659-689; the reference loads ORBvoc.txt at
        startup, main.cc:94-108)."""
        cfg = self.cfg
        if not (cfg.enable_loop_closing or cfg.enable_relocalisation):
            return
        if self.vocab is None:
            self.vocab = load_pretrained()
        if self.vocab is None:
            descs = np.concatenate([
                ref.desc[ref.valid].cpu().numpy(),
                frame.desc[frame.valid].cpu().numpy(),
            ])
            self.vocab = train_vocabulary(descs, k=10, L=3, seed=cfg.seed)
        self.db = KeyFrameDatabase(self.vocab, cfg.map.max_keyframes,
                                   cfg.bow_slots, device=self.device)
        self.loop_closer = LoopCloser(self.db, cfg)
        for slot, fr in ((k1, ref), (k2, frame)):
            ids, w, _ = self.db.compute_bow(fr.desc, fr.valid)
            self.db.add(slot, ids, w)

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

    def _track(self, frame: FrameData):
        """Fused motion-model and local-map tracking, with the recovery
        ladder for a frame under `min_track_inliers`: TrackPreviousFrame
        and a re-track from its pose, then the map again at twice the
        radius from the unmoved pose, then LOST (Tracking.cc:206-298)."""
        cfg = self.cfg
        dev = self.device
        kw = dict(p_local=cfg.p_local, width=cfg.camera.width,
                  height=cfg.camera.height, bounds=self.img_bounds,
                  scale_factor=cfg.map.scale_factor,
                  n_levels=cfg.map.n_levels)
        pose = torch.from_numpy(self.last_pose).to(dev)
        # the prediction formed on the device as the chunk step forms it,
        # so a frame tracked here and in a chunk of one get the same bits
        # (JAX forms it in numpy)
        T_pred = (torch.from_numpy(self.velocity).to(dev) @ pose
                  if cfg.use_motion_model else pose)
        res = track_frame(self.map, frame.xy, frame.desc, frame.octave,
                          frame.valid, T_pred, self.K_dev, self._track_mask(),
                          radius=cfg.track_radius, **kw)
        n_in = int(res.n_inliers)
        if n_in < cfg.min_track_inliers and self._prev_frame is not None:
            # TrackPreviousFrame (Tracking.cc:486-552), its bindings taken
            # through the forwarding table (Replace), then the local-map
            # step from the recovered pose (Tracking.cc:245-270)
            pf, pobs = self._prev_frame
            pobs_np = pobs.cpu().numpy()
            P = len(self.pt_forward)
            pobs_np = np.where(pobs_np >= 0,
                               self.pt_forward[np.clip(pobs_np, 0, P - 1)], -1)
            coarse = ((cfg.map.n_levels - 1) // 2 + 1
                      if self.n_keyframes > 5 else 0)
            T_rec, _, n_rec = track_prev_frame(
                self.map, pf.xy, pf.desc, pf.octave, pf.angle,
                torch.from_numpy(pobs_np.astype(np.int32)).to(dev),
                frame.xy, frame.desc, frame.octave, frame.angle, frame.valid,
                pose, self.K_dev, coarse, width=cfg.camera.width,
                height=cfg.camera.height, scale_factor=cfg.map.scale_factor,
                n_levels=cfg.map.n_levels)
            if int(n_rec) >= 10:
                res = track_frame(self.map, frame.xy, frame.desc,
                                  frame.octave, frame.valid, T_rec, self.K_dev,
                                  self._track_mask(), radius=cfg.track_radius,
                                  **kw)
                n_in = int(res.n_inliers)
        if n_in < cfg.min_track_inliers:
            # the last rung: the map at twice the radius from the unmoved
            # pose (no reference analog; catches a motion-model overshoot)
            res = track_frame(self.map, frame.xy, frame.desc, frame.octave,
                              frame.valid, pose, self.K_dev,
                              self._track_mask(),
                              radius=cfg.track_radius * 2.0, **kw)
            n_in = int(res.n_inliers)

        if n_in < cfg.min_track_inliers:
            self.state = LOST
            self.lost_count += 1
            self._prev_frame = None
            self.velocity = np.eye(4, dtype=np.float32)
            # lost soon after the initialisation: reset (Tracking.cc:272-279)
            if self.n_keyframes <= 5 and self.kf_counter <= 5:
                self.reset()
                return None
            if cfg.enable_relocalisation and self.db is not None:
                if self._relocalize(frame):
                    return self.last_pose.copy()
            return None

        self.state = WORKING
        self._count_tracked(n_in)
        T_new = res.pose.cpu().numpy()
        self._apply_counters(res)
        self._prev_frame = (frame, res.obs)
        # motion model: velocity = T_new inv(T_last) (Tracking.cc:282-295)
        self.velocity = (T_new @ _np_se3_inverse(self.last_pose)).astype(
            np.float32)
        self.last_pose = T_new
        self.trajectory.append((frame.frame_id, frame.timestamp, T_new.copy()))
        if self._need_new_keyframe(frame.frame_id, n_in):
            self._create_keyframe(frame, res.obs, n_in)
        return T_new

    def _relocalize(self, frame: FrameData) -> bool:
        """Tracking::Relocalisation (src/Tracking.cc:841-1010): BoW
        candidates from the database; for each of the first 5, a match
        against its bound features (TH_LOW, ratio 0.75), EPnP RANSAC,
        pose optimisation, and the guided search (radius 10, distance 100,
        then radius 3, distance 64 when the inliers land in [30, 50));
        accepted at `min_reloc_inliers`, when the local map re-anchors on
        the candidate."""
        cfg = self.cfg
        dev = self.device
        m = self.map
        P = m.pt_valid.shape[0]
        kw = dict(p_local=cfg.p_local, width=cfg.camera.width,
                  height=cfg.camera.height, bounds=self.img_bounds,
                  scale_factor=cfg.map.scale_factor,
                  n_levels=cfg.map.n_levels)
        with self._stage("reloc BoW"):
            ids, w, _ = self.db.compute_bow(frame.desc, frame.valid)
        with self._stage("reloc candidates"):
            W_np = covisibility_weights(m).cpu().numpy()
            cands = self.db.detect_relocalisation_candidates(ids, w, W_np)
        inv_s2 = 1.0 / (cfg.map.scale_factor
                        ** (2.0 * frame.octave.to(torch.float32)))
        xy = frame.xy.contiguous()
        for cand in cands[:5]:
            with self._stage("reloc match"):
                bound = (m.kf_obs[cand] >= 0) & m.kf_feat_valid[cand]
                idx, _, ok = match(
                    frame.desc, m.kf_desc[cand], valid_a=frame.valid,
                    valid_b=bound, max_dist=TH_LOW, nn_ratio=0.75, unique=True)
                n_match = int(ok.sum())
            if n_match < 15:
                continue
            with self._stage("reloc EPnP RANSAC"):
                pids = m.kf_obs[cand][idx]
                ok = ok & (pids >= 0)
                pid_s = pids.clamp(0, P - 1).long()
                ok = ok & m.pt_valid[pid_s]
                pw = m.pt_pos[pid_s]
                R, t, inl, n_in = epnp_ransac(pw, xy, ok, inv_s2, self.K_dev,
                                              idx=self._reloc_sets(ok))
                n_in = int(n_in)
            if n_in < 10:
                continue
            with self._stage("reloc pose_optimize"):
                T0 = torch.eye(4, device=dev)
                T0[:3, :3] = R
                T0[:3, 3] = t
                T_opt, _, n_opt = pose_optimize(T0, pw, xy, inv_s2, inl, self.K_dev)
                n_opt = int(n_opt)
            if n_opt < 10:
                continue
            with self._stage("reloc guided rounds"):
                res = track_frame(m, frame.xy, frame.desc, frame.octave,
                                  frame.valid, T_opt, self.K_dev, radius=10.0,
                                  max_dist=100, **kw)
                n_good = int(res.n_inliers)
                if 30 <= n_good < cfg.min_reloc_inliers:
                    res2 = track_frame(m, frame.xy, frame.desc, frame.octave,
                                       frame.valid, res.pose, self.K_dev,
                                       radius=3.0, max_dist=64, **kw)
                    if int(res2.n_inliers) > n_good:
                        res, n_good = res2, int(res2.n_inliers)
            if n_good >= cfg.min_reloc_inliers:
                self.last_pose = res.pose.cpu().numpy()
                self.velocity = np.eye(4, dtype=np.float32)
                self.state = WORKING
                self.n_relocs += 1
                # re-anchor the local map on the candidate's neighbourhood
                # (Tracking.cc:851-858)
                self._refresh_local_mask(int(cand))
                self.trajectory.append(
                    (frame.frame_id, frame.timestamp, self.last_pose.copy()))
                return True
        return False

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
        """KF insertion + LocalMapping + loop closing
        (Tracking::CreateNewKeyFrame, LocalMapping::Run, LoopClosing::Run).
        `abort` is polled between stages (InterruptBA,
        LocalMapping.cc:519-522)."""
        with self._span("mapping.integrate", frame.frame_id):
            if pose is None:
                pose = self.last_pose
            with self._span("mapping.insert"):
                obs = self._resolve_obs(obs)
                slot = self._alloc_kf()
                self.map = insert_keyframe(
                    self.map, slot, torch.as_tensor(pose).to(self.device),
                    frame.frame_id, frame.xy, frame.octave, frame.angle,
                    frame.desc, frame.valid, obs, self.last_kf_slot)
            self.last_kf_slot = slot
            self._local_mapping(slot, abort=abort)
            if (self.cfg.enable_loop_closing and self.loop_closer is not None
                    and bool(self.map.kf_valid[slot])):
                # LocalMapping hands the keyframe to LoopClosing
                # (LocalMapping.cc:87); the sequential system runs it inline
                self._run_loop_closing(slot)
            elif self.db is not None and bool(self.map.kf_valid[slot]):
                with self._stage("BoW add"):
                    ids, w, _ = self.db.compute_bow(frame.desc, frame.valid)
                    self.db.add(slot, ids, w)
            return slot

    def _run_loop_closing(self, slot: int):
        """One loop-closing pass inline (its detection adds the
        keyframe's BoW to the database)."""
        if self.loop_closer.process(self, slot):
            self.n_loops_closed += 1
            # the map moved: the tracker re-anchors on the corrected local
            # neighbourhood
            self._refresh_local_mask(slot)

    def _stage(self, name):
        """The stage timer's context for `name`, or a no-op."""
        if self._stage_timer is None:
            return contextlib.nullcontext()
        return self._stage_timer(name)

    def _span(self, name, frame=None):
        """The stage timer's span for `name` and `frame`, which never
        synchronizes (a stage where the hook has no `span`, as
        `torch.profiler.record_function`), or a no-op."""
        timer = self._stage_timer
        if timer is None:
            return contextlib.nullcontext()
        span = getattr(timer, "span", None)
        return timer(name) if span is None else span(name, frame)

    def _count(self, name, value=1):
        """One event's `value` for the stage timer's counter `name`, where
        the hook keeps counters. Counters live on the timer, never on the
        system."""
        count = getattr(self._stage_timer, "count", None)
        if count is not None:
            count(name, value)

    def _count_tracked(self, n_inliers: int):
        """Count one tracked frame and its inliers."""
        self._count("track.frames")
        self._count("track.inliers", n_inliers)

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
            self._count("mapping.neighbors", len(neighbors))
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
                dbg(f"kf{new_kf}: point-cull {int(kill.sum())}")
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
                dbg(f"kf{new_kf}: triangulated {n_created} with kf{nb}")
                if n_created:
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
                if DEBUG:
                    dbg(f"kf{new_kf}<->kf{nb}: fuse bound {int(b1)}+{int(b2)} "
                        f"merged {int(g1)}+{int(g2)}")
            with self._span("mapping.reclaim"):
                self._reclaim_points(m)

        with self._stage("refresh_point_stats"):
            m = refresh_point_stats(m, scale_factor=sf, n_levels=nl)

        # --- Local BA (Optimizer.cc:287-536) ---
        with self._span("local_ba.sets"):
            cam_opt, pt_opt = self._local_ba_sets(m, new_kf, neighbors)
        bkw = dict(mesh=cfg.mesh, max_opt_cams=cfg.max_ba_cams or None,
                   max_opt_pts=cfg.max_ba_points or None, scale_factor=sf,
                   iterations=self.ba_iterations)
        # two abortable phases (g2o's setForceStopFlag, Optimizer.cc:351-352)
        with self._stage("BA phase 1"):
            m, outlier, (okf, ofeat) = bundle_adjust(
                m, self.K_dev, cam_opt, pt_opt, iters1=5, iters2=0, **bkw)
            if DEBUG:
                dbg(f"kf{new_kf}: BA1 outlier-edges {int(outlier.sum())} "
                    f"valid {int(m.pt_valid.sum())}")
            m = apply_edge_outliers(m, outlier, okf, ofeat)
            if DEBUG:
                dbg(f"kf{new_kf}: after BA1 eject valid {int(m.pt_valid.sum())}")
        if not aborted():
            with self._stage("BA phase 2"):
                m, outlier, (okf, ofeat) = bundle_adjust(
                    m, self.K_dev, cam_opt, pt_opt, iters1=0, iters2=10, **bkw)
                if DEBUG:
                    dbg(f"kf{new_kf}: BA2 outlier-edges {int(outlier.sum())}")
                m = apply_edge_outliers(m, outlier, okf, ofeat)
                if DEBUG:
                    dbg(f"kf{new_kf}: after BA2 eject valid "
                        f"{int(m.pt_valid.sum())}")
        with self._span("mapping.reclaim"):
            self._reclaim_points(m)

        # --- KeyFrameCulling over all covisible keyframes of the new one
        # (LocalMapping.cc:524-578) ---
        with self._stage("keyframe culling"):
            for nb in neighbors:
                if self.kf_order[nb] < 2:
                    continue  # never cull the gauge keyframes
                red, n_bound = keyframe_redundancy(m, nb)
                if float(red) > cfg.kf_cull_redundancy and int(n_bound) > 20:
                    dbg(f"kf{new_kf}: culling redundant kf{nb} "
                        f"(red={float(red):.2f})")
                    m = remove_keyframe(m, nb)
                    m = self._repair_spanning_tree(m, nb)
                    self.free_kf.append(nb)
                    self.kf_order[nb] = -1
                    counts["kf_culled"] += 1
                    if self.db is not None:
                        self.db.erase(nb)

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

    def keyframe_trajectory(self):
        """(frame id, t_wc [3], q_wc [4] xyzw) of each live keyframe in
        insertion order, the rows of the reference's KeyFrameTrajectory.txt
        (src/main.cc:160-185)."""
        rows = []
        kf_valid = self.map.kf_valid.cpu().numpy()
        poses = self.map.kf_pose.cpu()
        fids = self.map.kf_frame_id.cpu().numpy()
        for slot in np.argsort(self.kf_order):
            if self.kf_order[slot] < 0 or not kf_valid[slot]:
                continue
            T_wc = se3_inverse(poses[slot])
            rows.append((int(fids[slot]), T_wc[:3, 3].numpy(),
                         rot_to_quat(T_wc[:3, :3]).numpy()))
        return rows

    @property
    def n_keyframes(self):
        return int(self.map.kf_valid.sum())

    @property
    def n_points(self):
        return int(self.map.pt_valid.sum())
