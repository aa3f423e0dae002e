"""Where the time goes on the card: the FAST and the Harris (nScoreType=0)
extract-and-track paths and the mapping path of chip_smoke.py, timed and
profiled, and local BA's solver stages.

    python -m orb_slam_tpu_torch.profile_paths [--frames 64] [--spread]
        [--async-periods SECONDS ...] [--capacity K,P,SWEEP,LEGS ...]

The scene, map and settings are chip_smoke.py's (640x480, 1000 features,
8 levels; the tracking paths against an 8192-slot map seeded from frame 0,
p_local 4096; the mapping path a SLAMSystem at the SlamConfig defaults,
seeded with frames 0 and 1 as keyframes, moving MAPPING_STEP and turning
MAPPING_YAW per frame). The paths run in turns, FAST, Harris, mapping,
mapping, Harris, FAST, then the loop turn. For a tracking path each turn prints the host-clock ms/frame of the
extraction alone and of the whole path (a warmup window, then the median
of 3 windows), then profiles one more window with torch.profiler: device
kernel time per frame, kernel launches per frame, the device's busy share
(kernel time over the unprofiled whole-path time), the heaviest kernels
and the device time per launch of each of the port's own kernels. For the
mapping path (process_batch at the default chunk of 8 frames, so the
frames of a chunk after a keyframe are extracted and tracked again; the
launch check of chip_smoke.py runs one frame per chunk instead) each turn
runs the frames once with a host clock on every local-mapping stage (the
device synchronized at each end), then once more under torch.profiler
with each stage labelled, and prints per keyframe
integration and per stage the host-clock ms, the device time, the device
work items launched (kernels, copies, fills) and the busy share; the rest
of the path is tracking and the host's replay. Last, the split of one
local-BA solver step (`ba_stage_split`) at chip_smoke.py's two shapes.
With --spread, only `mapping_spread`: the mapping path's keyframe ATE
after a Sim3 alignment and centre error over scene seeds and the order
of BA's float sums, on the card and the CPU, and per seed the system
from raw frames through its own initialisation, and the relocalisation
path (`reloc_path`: a blackout, then a revisit of a mapped stretch).
Needs a CUDA card.

`reloc_system`, `reloc_frames`, `reloc_path` and `relocalize_split` are
also chip_smoke.py's phase 12: the system with relocalisation on and the
shipped vocabulary, its frames, one run of the path with a record of
every `_relocalize` call, and the stage clock that splits one call into
BoW, candidate query and, per candidate, match, EPnP RANSAC,
pose_optimize and the guided rounds. `loop_scene`, `loop_frames`,
`loop_system`, `inject_drift`, `loop_path`, `loop_split`,
`loop_snapshot`, `loop_restore` and `chain_pose_graph` are phases 14-15:
the loop path (a sideways path out and back over a wide scene, the map
drifted through a Sim3 on the way out), its record of every loop-closing
pass and of the state before each accepted correction, the stage clock
that splits a pass, and the PCG pose graph at K = 1024. `async_system`,
`async_path` and `async_summary` are phase 16: the loop path's frames
through AsyncSLAMSystem with the mapper and loop threads live (the port
of scripts/bench_async_pipeline.py), paced by `PacedFeed` as a camera
sending one frame every ASYNC_FRAME_PERIOD seconds; `--async-periods`
runs only that path, once at each pace given. The loop turn
after the paths' turns (`profile_loop`) profiles the accepted pass per
stage; `--spread` also runs the loop path per scene seed.
`capacity_system`, `capacity_poses`, `capacity_path`, `SlotRecord`,
`slot_failures` and `capacity_failures` are phase 20: the system on a map
small enough that both slot pools fill, swept over the loop scene, with a
record of every slot written, allocated and culled; `--capacity` runs only
that path, once per map size and sweep given.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import statistics
import subprocess
import tempfile
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from orb_slam_tpu_torch.convert import database_from_numpy, loop_closer_from_state
from orb_slam_tpu_torch.frontend.orb_extractor import ORBConfig, ORBExtractor
from orb_slam_tpu_torch.geometry.horn import horn_sim3
from orb_slam_tpu_torch.io.settings import settings_text, slam_config_from_settings
from orb_slam_tpu_torch.io.synthetic import (
    SyntheticScene, lateral_trajectory, seed_keyframe_map, seed_map,
)
from orb_slam_tpu_torch.io.trajectory import ate_rmse, camera_centers_from_cw
from orb_slam_tpu_torch.pipeline import system as slam
from orb_slam_tpu_torch.pipeline.async_system import AsyncSLAMSystem
from orb_slam_tpu_torch.pipeline.chunk import extract_track_chunk
from orb_slam_tpu_torch.place.pretrained import load_pretrained
from orb_slam_tpu_torch.slam_map.map_state import MapConfig, MapState
from orb_slam_tpu_torch.slam_map.observations import refresh_point_stats
from orb_slam_tpu_torch.solvers import local_ba as ba
from orb_slam_tpu_torch.utils.timing import StageTimer, synchronize_card as _sync

# the hand-written kernels of csrc/, whose time per launch is printed
PORT_KERNELS = ("fast_score_nms_kernel", "pose_gn_kernel",
                "fast_score_rect_kernel", "fast_cell_topk_kernel")


# the mapping path's trajectory: lateral_trajectory's step per frame, and
# its yaw per frame, which turns the camera toward the scene's centre as it
# moves (on the card a pure sideways path drifts in scale by ~9 cm over its
# 5 m; this one stayed within 2.6 cm)
MAPPING_STEP = 0.08
MAPPING_YAW = 0.01
# device work in a torch.profiler chrome trace, and its launch calls
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def start_working(s: slam.SLAMSystem, scene, poses, frames) -> int:
    """Seed `s` with frames 0 and 1 as keyframes 0 and 1, as the two-view
    initialisation leaves a system, ready to track frame 2. Returns the
    number of seeded points."""
    feats = [s.extractor(frames[i]) for i in (0, 1)]
    m, n, n1 = seed_keyframe_map(scene, poses[:2], feats, scene.K, s.cfg.map,
                                 device=s.device)
    s.map = m
    s.free_kf = list(range(2, s.cfg.map.max_keyframes))
    s.free_pt = list(range(n, s.cfg.map.max_points))
    s.kf_order[:2] = [0, 1]
    s.kf_counter, s.frame_id = 2, 2
    s.last_pose = m.kf_pose[1].cpu().numpy().copy()
    s.last_kf_frame, s.last_kf_slot, s.ref_kf_tracked = 1, 1, n1
    s.trajectory = [(0, 0.0, np.asarray(poses[0], np.float32)),
                    (1, 1 / 30.0, s.last_pose.copy())]
    s.state = slam.WORKING
    s._refresh_local_mask()
    return n


def mapping_system(scene, poses, frames, device) -> slam.SLAMSystem:
    """A SLAMSystem at the SlamConfig defaults (MapConfig(): 256
    keyframes, 16384 points; ORBConfig(); max_ba_cams 80, max_ba_points
    2048) for the scene's camera, started from frames 0 and 1."""
    camera = scene.camera_model()
    s = slam.SLAMSystem(slam.SlamConfig(camera=camera), device=device)
    start_working(s, scene, poses, frames)
    return s


def keyframe_center_errors(s: slam.SLAMSystem, poses):
    """(frame ids [n], camera centres [n, 3], distance of each centre to
    the ground truth of its frame [n]) of the live keyframes of `s`, as
    float64 numpy."""
    m = s.map
    live = m.kf_valid.cpu().numpy()
    fid = m.kf_frame_id.cpu().numpy()[live]
    center = lambda T: -np.einsum("kji,kj->ki", T[:, :3, :3], T[:, :3, 3])
    c = center(m.kf_pose.cpu().double().numpy()[live])
    g = center(np.asarray(poses, np.float64)[fid])
    return fid, c, np.linalg.norm(c - g, axis=1)


def keyframe_ate(s: slam.SLAMSystem, poses):
    """(RMSE of the live keyframes' camera centres against the ground
    truth of their frames after a Sim3 alignment, the alignment's scale,
    the ground-truth path length from the first keyframe's frame to the
    last's, the keyframes' frame ids) of `s`: the monocular check, since
    the map's scale is its own (the two-view initialisation scales it to
    unit median depth)."""
    rows = s.keyframe_trajectory()
    fid = np.array([r[0] for r in rows])
    est = np.stack([r[1] for r in rows]).astype(np.float64)
    gt_all = camera_centers_from_cw(np.asarray(poses, np.float64))
    gt = gt_all[fid]
    rmse, _ = ate_rmse(est, gt)
    scale = float(horn_sim3(torch.from_numpy(gt.astype(np.float32)),
                            torch.from_numpy(est.astype(np.float32)))[0])
    seg = gt_all[fid.min():fid.max() + 1]
    length = float(np.linalg.norm(np.diff(seg, axis=0), axis=1).sum())
    return rmse, scale, length, fid


def init_system(scene, device) -> slam.SLAMSystem:
    """A SLAMSystem at the SlamConfig defaults for the scene's camera,
    loop closing and relocalisation off, to start from raw frames."""
    camera = scene.camera_model()
    return slam.SLAMSystem(slam.SlamConfig(
        camera=camera, enable_loop_closing=False,
        enable_relocalisation=False), device=device)


def reloc_system(scene, device) -> slam.SLAMSystem:
    """A SLAMSystem at the SlamConfig defaults for the scene's camera, with
    relocalisation on, loop closing off and the shipped vocabulary, to
    start from raw frames."""
    camera = scene.camera_model()
    return slam.SLAMSystem(slam.SlamConfig(
        camera=camera, enable_loop_closing=False, enable_relocalisation=True,
        vocabulary=load_pretrained()), device=device)


# the relocalisation path: raw frames 0..RELOC_MAPPED-1 along the mapping
# trajectory, RELOC_BLACKOUT uniform-gray frames, then the frames of poses
# RELOC_REVISIT[0]..RELOC_REVISIT[1]-1 again
RELOC_MAPPED = 48
RELOC_BLACKOUT = 3
RELOC_REVISIT = (20, 36)
BLACKOUT_GRAY = 128.0


def reloc_frames(scene, device):
    """(the ground-truth pose of each frame id [n, 4, 4], NaN for the
    blackout frames; the frames [n, H, W] on `device`) of the
    relocalisation path."""
    poses = lateral_trajectory(RELOC_MAPPED, step=MAPPING_STEP, yaw_rate=MAPPING_YAW)
    imgs = np.stack([scene.render_image(p) for p in poses])
    revisit = list(range(*RELOC_REVISIT))
    gray = np.full((RELOC_BLACKOUT,) + imgs.shape[1:], BLACKOUT_GRAY, imgs.dtype)
    frames = np.concatenate([imgs, gray, imgs[revisit]])
    gt = np.concatenate([poses, np.full((RELOC_BLACKOUT, 4, 4), np.nan, np.float32),
                         poses[revisit]])
    return gt, torch.from_numpy(frames).to(device)


def relocalize_split(s: slam.SLAMSystem, frame, relocalize=None):
    """One `s._relocalize(frame)` (or `relocalize(frame)`, a wrapped one)
    under a stage clock: (its result,
    {stage: [seconds of each time it ran]}) over the stages "reloc BoW",
    "reloc candidates" and, for each candidate tried, "reloc match",
    "reloc EPnP RANSAC", "reloc pose_optimize" and "reloc guided rounds"
    (each reached only past the previous one's gate)."""
    record = {}
    timer = s._stage_timer
    s._stage_timer = StageTimer(times=record)
    try:
        ok = (relocalize or s._relocalize)(frame)
    finally:
        s._stage_timer = timer
    return ok, record


def reloc_path(scene, device, record=True, system=None):
    """The relocalisation path on a fresh `reloc_system`: the mapped
    frames, the blackout and the revisit, each one `process_batch` at the
    config's chunk of 8 frames. With `record`, every
    `_relocalize` call runs through `relocalize_split` and is kept with
    the frame id, its result and the minimal sets it drew. `system`: a
    `reloc_system` the caller made (and wrapped) itself. Returns a dict:
    the system, the ground truth by frame id, the poses of the mapped and
    the revisit frames, the state and keyframe count after the blackout,
    the calls, the seconds of the whole run."""
    gt, frames = reloc_frames(scene, device)
    s = system or reloc_system(scene, device)
    calls = []
    if record:
        relocalize, sets = s._relocalize, s._reloc_sets

        def recorded_sets(valid):
            idx = sets(valid)
            calls[-1]["sets"].append(idx.clone())
            return idx

        def recorded(frame):
            calls.append(dict(frame_id=frame.frame_id, frame=frame, sets=[]))
            ok, split = relocalize_split(s, frame, relocalize)
            calls[-1].update(ok=ok, split=split)
            return ok

        s._relocalize, s._reloc_sets = recorded, recorded_sets
    sync = torch.cuda.synchronize if frames.is_cuda else (lambda: None)
    n_map, n_black = RELOC_MAPPED, RELOC_BLACKOUT
    sync()
    t = time.perf_counter()
    mapped = s.process_batch(frames[:n_map])
    s.process_batch(frames[n_map:n_map + n_black])
    after_blackout = dict(state=s.state, n_keyframes=s.n_keyframes,
                          lost_count=s.lost_count)
    revisit = s.process_batch(frames[n_map + n_black:])
    sync()
    return dict(system=s, gt=gt, mapped=mapped, revisit=revisit,
                after_blackout=after_blackout, calls=calls,
                seconds=time.perf_counter() - t, n_frames=len(frames))


def reloc_alignment(s: slam.SLAMSystem, gt):
    """(the live keyframes' ATE after a Sim3 alignment onto the ground
    truth of their frame ids, the alignment as a function of camera
    centres [n, 3], the ground-truth path length of the mapped frames)."""
    rows = s.keyframe_trajectory()
    fid = np.array([r[0] for r in rows])
    est = np.stack([r[1] for r in rows]).astype(np.float64)
    gt_c = camera_centers_from_cw(np.asarray(gt, np.float64))
    rmse, _ = ate_rmse(est, gt_c[fid])
    sc, R, t = horn_sim3(torch.from_numpy(gt_c[fid].astype(np.float32)),
                         torch.from_numpy(est.astype(np.float32)))
    align = lambda c: float(sc) * np.asarray(c, np.float64) @ R.double().numpy().T \
        + t.double().numpy()
    mapped = gt_c[:RELOC_MAPPED]
    length = float(np.linalg.norm(np.diff(mapped, axis=0), axis=1).sum())
    return rmse, align, length


# the loop path: a wide version of the mapping scene (2400 points over
# x in [-24, 24] m, the mapping scene's 800 over [-8, 8] at the same
# density) and a sideways path LOOP_OUT frames out at MAPPING_STEP and the
# same poses back, so the return revisits the start; just after the first
# keyframe at or past frame LOOP_DRIFT_AT the recent half of the map goes
# through the Sim3 LOOP_DRIFT (scale, translation), as
# tests/test_loop_reloc_e2e.py:86-118 injects it, so the revisit must be
# recognised by appearance and corrected by the loop closer. The loop
# keyframe must lie among the frames before LOOP_CAND_BEFORE (the first
# quarter of the path out).
LOOP_OUT = 160
LOOP_DRIFT_AT = 100
LOOP_DRIFT = (1.15, (0.4, 0.0, 0.2))
LOOP_CAND_BEFORE = LOOP_OUT // 4
# the async path's pace: the loop path's frames as a camera sends them,
# one every ASYNC_FRAME_PERIOD seconds, MAPPING_STEP per frame: a slow
# hand-held sweep at 0.08 m/s. The path needs a keyframe nearly every frame
# and a lost camera is not found again before the return, so one
# integration must fit in a frame with room to spare: on the card they
# took 160-290 ms (median) and up to 0.56-0.72 s over runs, and the camera
# was lost at 0.2 s and at 0.4 s and kept at 1/3 s, 1/2 s and 1 s (PERF.md,
# PR 9).
ASYNC_FRAME_PERIOD = 1.0
LOOP_SCENE_TEXT = (f"SyntheticScene(n_points=2400, extent=(24, 5, 4)), "
                   f"lateral_trajectory({LOOP_OUT}, step={MAPPING_STEP}) out and the "
                   f"same poses back")


def loop_scene(seed: int = 0):
    return SyntheticScene(n_points=2400, width=640, height=480,
                          extent=(24.0, 5.0, 4.0), seed=seed)


def loop_poses():
    out = lateral_trajectory(LOOP_OUT, step=MAPPING_STEP, yaw_rate=0.0)
    return np.concatenate([out, out[::-1][1:]])


def loop_frames(scene, device):
    """(ground-truth poses [n, 4, 4], frames [n, H, W] on `device`) of the
    loop path."""
    poses = loop_poses()
    imgs = np.stack([scene.render_image(p) for p in poses])
    return poses, torch.from_numpy(imgs).to(device)


def loop_system(scene, device) -> slam.SLAMSystem:
    """A SLAMSystem at the SlamConfig defaults (loop closing and
    relocalisation on, ORBConfig(), MapConfig(), chunk 8) with the shipped
    vocabulary, for the scene's camera, to start from raw frames."""
    camera = scene.camera_model()
    return slam.SLAMSystem(slam.SlamConfig(
        camera=camera, vocabulary=load_pretrained()), device=device)


def inject_drift(s: slam.SLAMSystem, scale: float, t):
    """Remap the most recent half of the keyframes (by insertion order)
    and the points they reference through x -> scale x + t, their poses
    rewritten so that every projection stays the same, and move the
    tracker into the drifted frame at the last keyframe's pose
    (tests/test_loop_reloc_e2e.py:86-118):
    a self-consistent recent section that disagrees with the old one.
    Returns the drifted keyframe slots."""
    m = s.map
    slots = np.where(m.kf_valid.cpu().numpy())[0]
    orders = s.kf_order[slots]
    recent = set(int(k) for k in slots[orders > np.median(orders)])
    poses = m.kf_pose.cpu().numpy().copy()
    t = np.asarray(t, np.float32)
    for k in recent:
        poses[k][:3, 3] = scale * poses[k][:3, 3] - poses[k][:3, :3] @ t
    pos = m.pt_pos.cpu().numpy().copy()
    sel = m.pt_valid.cpu().numpy() & np.isin(m.pt_ref_kf.cpu().numpy(), list(recent))
    pos[sel] = scale * pos[sel] + t
    dev = s.device
    s.map = refresh_point_stats(m.replace(kf_pose=torch.from_numpy(poses).to(dev),
                                          pt_pos=torch.from_numpy(pos).to(dev)))
    s.last_pose = poses[s.last_kf_slot].copy()
    s.velocity = np.eye(4, dtype=np.float32)
    return recent


def drive_loop_frames(s, frames, inject, working=slam.WORKING, feed=None):
    """The loop path's frames through `s.process_batch` (a SLAMSystem of
    the port or of the JAX package, `working` its WORKING state), or
    through `feed(s, frames[i:j], i)` where given, with
    `inject(s)` called once: just after the first keyframe at or past frame
    LOOP_DRIFT_AT, where the tracker's pose is the keyframe's (at any other
    frame the drifted tracker would start frames behind). Returns (the
    poses out, the frame after which the drift went in, what `inject`
    returned)."""
    if feed is None:
        feed = lambda system, batch, start: system.process_batch(batch)
    out = feed(s, frames[:LOOP_DRIFT_AT], 0)
    i = LOOP_DRIFT_AT
    while i < len(frames) and not (s.state == working
                                   and s.last_kf_frame == s.frame_id - 1):
        out += feed(s, frames[i:i + 1], i)
        i += 1
    injected = inject(s)
    out += feed(s, frames[i:], i)
    return out, i - 1, injected


class PacedFeed:
    """A `drive_loop_frames` feed that hands the frames over as a camera
    sending one every `period` seconds would: frame i arrives `i * period`
    after the first, the caller waits for the next frame to arrive and
    then gives `process_batch` every frame that has arrived, at most
    `chunk` of them, with their arrival times as timestamps. The
    reference's examples pace the same way, sleeping after each frame
    until the next one's timestamp (Examples/Monocular/mono_tum.cc). Keeps
    the host-clock seconds spent inside `process_batch` (`busy`: the
    tracking thread's own time, vTimesTrack in mono_tum.cc), the calls
    and the frames handed over in a call of more than one (the tracker
    behind the camera). `pause(seconds)` holds the camera for a window the
    caller does not count."""

    def __init__(self, period: float, chunk: int):
        self.period, self.chunk = period, chunk
        self.t0 = None
        self.busy = 0.0
        self.calls = 0
        self.behind = 0

    def pause(self, seconds: float):
        self.t0 += seconds

    def __call__(self, s, frames, start):
        if self.t0 is None:
            self.t0 = time.perf_counter() - start * self.period
        out, i, n = [], 0, len(frames)
        while i < n:
            due = self.t0 + (start + i) * self.period
            now = time.perf_counter()
            if now < due:
                time.sleep(due - now)
                now = time.perf_counter()
            arrived = int((now - self.t0) / self.period) + 1 - start
            j = min(n, i + self.chunk, max(i + 1, arrived))
            stamps = [(start + k) * self.period for k in range(i, j)]
            t = time.perf_counter()
            out += s.process_batch(frames[i:j], timestamps=stamps)
            self.busy += time.perf_counter() - t
            self.calls += 1
            self.behind += (j - i) if j - i > 1 else 0
            i = j
        return out


def loop_snapshot(s: slam.SLAMSystem):
    """A copy of everything LoopCloser.process reads and writes: the map,
    the host lists and counters, the database rows, the loop closer's
    consistent groups and counter."""
    m = s.map
    return dict(
        cfg=s.cfg, vocab=s.vocab,
        map={f.name: getattr(m, f.name).clone() for f in dataclasses.fields(m)},
        lists={k: list(getattr(s, k)) for k in ("free_kf", "free_pt")},
        arrays={k: getattr(s, k).copy() for k in ("kf_order", "pt_forward",
                                                  "last_pose", "velocity")},
        scalars={k: getattr(s, k) for k in ("kf_counter", "frame_id", "state",
                                            "last_kf_frame", "last_kf_slot",
                                            "ref_kf_tracked", "n_loops_closed")},
        db=dict(bow_ids=s.db.bow_ids.cpu().numpy(), bow_w=s.db.bow_w.cpu().numpy(),
                active=s.db.active.copy()),
        loop=dict(consistent_groups=[(set(g), c) for g, c in
                                     s.loop_closer.consistent_groups],
                  last_loop_kf_counter=s.loop_closer.last_loop_kf_counter))


def loop_restore(snap, device) -> slam.SLAMSystem:
    """A SLAMSystem on `device` holding a `loop_snapshot`."""
    s = slam.SLAMSystem(snap["cfg"], device=device)
    s.map = MapState(**{k: v.to(device) for k, v in snap["map"].items()})
    for k, v in snap["lists"].items():
        setattr(s, k, list(v))
    for k, v in snap["arrays"].items():
        setattr(s, k, v.copy())
    for k, v in snap["scalars"].items():
        setattr(s, k, v)
    s.vocab = snap["vocab"]
    s.db = database_from_numpy(s.vocab, snap["db"], device=device)
    s.loop_closer = loop_closer_from_state(s.db, s.cfg, **snap["loop"])
    s._refresh_local_mask()
    return s


def loop_split(s: slam.SLAMSystem, slot: int, process=None):
    """One `s.loop_closer.process(s, slot)` (or `process(s, slot)`, a
    wrapped one) under a stage clock: (its result, {stage: [seconds of
    each time it ran]}) over "loop detect" and, per candidate tried, "loop
    match", "loop ransac", "loop guided", "loop optimize_sim3", "loop
    project", then for an accepted loop "loop correct group", "loop fuse",
    "loop graph", "loop essential graph" and "loop remap"."""
    record = {}
    timer = s._stage_timer
    s._stage_timer = StageTimer(times=record)
    try:
        ok = (process or s.loop_closer.process)(s, slot)
    finally:
        s._stage_timer = timer
    return ok, record


def loop_replay(closure, device, stage_timer=None, within=None):
    """A `loop_path` closure's accepted loop-closing pass again on
    `device`: the state restored from its snapshot, the minimal sets it
    drew injected through `_sim3_sets`, `stage_timer` (if given) as the
    system's stage clock and the pass run inside `within` (a context
    manager, if given). Returns (the system after the pass, {"cand", "S12"}
    that `correct` was called with, host-clock seconds of the pass, the
    device synchronized at both ends)."""
    s = loop_restore(closure["snap"], device)
    queue = [idx.to(device) for idx in closure["sets"]]
    s.loop_closer._sim3_sets = lambda valid: queue.pop(0)
    hit = {}
    correct = s.loop_closer.correct

    def watched(system, new_kf, cand, S12):
        hit.update(cand=int(cand), S12=[x.cpu() for x in S12])
        return correct(system, new_kf, cand, S12)

    s.loop_closer.correct = watched
    if stage_timer is not None:
        s._stage_timer = stage_timer
    _sync()
    t = time.perf_counter()
    with within or contextlib.nullcontext():
        s._run_loop_closing(closure["slot"])
        _sync()
    return s, hit, time.perf_counter() - t


def loop_path(scene, device, record=True, system=None):
    """The loop path on a fresh `loop_system` (or `system`): the frames
    through process_batch at the config's chunk, with LOOP_DRIFT injected
    as `drive_loop_frames` places it. With
    `record`, every loop-closing pass runs through `loop_split` and is
    kept (frame id, keyframe slot, split, the minimal sets it drew), and
    the state before each accepted correction is saved (`loop_snapshot`)
    with the keyframe ATE after a Sim3 alignment before and after it.
    Returns a dict: the system, the ground-truth poses, the poses out,
    the frame after which the drift went in and the keyframe ATE just
    before it, the passes, the closures, the seconds of the whole run."""
    poses, frames = loop_frames(scene, device)
    s = system or loop_system(scene, device)
    passes, closures = [], []
    if record:
        def run_loop_closing(slot, run=s._run_loop_closing):
            lc = s.loop_closer
            sets, correct = lc._sim3_sets, lc.correct
            rec = dict(frame_id=s.frame_id - 1, slot=int(slot), sets=[])

            def recorded_sets(valid):
                idx = sets(valid)
                rec["sets"].append(idx.clone())
                return idx

            def recorded_correct(system, new_kf, cand, S12):
                snap = loop_snapshot(system)
                before = keyframe_ate(system, poses)[0]
                ok = correct(system, new_kf, cand, S12)
                closures.append(dict(rec, snap=snap, S12=S12, ate_before=before,
                                     ate_after=keyframe_ate(system, poses)[0],
                                     **lc.last_correction))
                return ok

            lc._sim3_sets, lc.correct = recorded_sets, recorded_correct
            try:
                ok, split = loop_split(s, slot, lambda sys_, k: run(k) or True)
            finally:
                lc._sim3_sets, lc.correct = sets, correct
            rec.update(split=split, closed=bool(closures) and
                       closures[-1]["frame_id"] == rec["frame_id"])
            passes.append(rec)

        s._run_loop_closing = run_loop_closing

    def inject(system):
        before = keyframe_ate(system, poses)[0]
        inject_drift(system, *LOOP_DRIFT)
        return before

    _sync()
    t = time.perf_counter()
    out, drift_after, ate_drift = drive_loop_frames(s, frames, inject)
    _sync()
    return dict(system=s, poses=poses, out=out, drift=(drift_after, ate_drift),
                passes=passes, closures=closures,
                seconds=time.perf_counter() - t, n_frames=len(frames))


def loop_summary(r):
    """One line on a `loop_path` result: the first frame tracked, the share
    of later frames tracked, lost_count, n_loops_closed, each closure's
    frame, keyframe pair (and the candidate's frame), merges, edges and
    keyframe ATE before and after, the keyframe ATE at the end, ms/frame."""
    s, out = r["system"], r["out"]
    first = next((i for i, p in enumerate(out) if p is not None), None)
    tracked = 0 if first is None else sum(p is not None for p in out[first:])
    n_after = 0 if first is None else len(out) - first
    fid = s.map.kf_frame_id.cpu().numpy()
    cl = "; ".join(
        f"closure at frame {c['frame_id']}: keyframe {c['new_kf']} (frame "
        f"{fid[c['new_kf']]}) to {c['cand']} (frame {fid[c['cand']]}), group "
        f"{c['group']}, {c['merged']} points merged, {c['edges']} edges, keyframe "
        f"ATE {c['ate_before']:.5f} -> {c['ate_after']:.5f}"
        for c in r["closures"]) or ("no closure" if not s.n_loops_closed else
                                    "closures not recorded")
    ate, scale, length, _ = keyframe_ate(s, r["poses"])
    return (f"first frame tracked {first}, {tracked} of {n_after} after it tracked, "
            f"lost_count {s.lost_count}, n_relocs {s.n_relocs}, n_loops_closed "
            f"{s.n_loops_closed}; drift after frame {r['drift'][0]}, keyframe ATE "
            f"before it {r['drift'][1]:.5f}; "
            f"{cl}; keyframe ATE at the end {ate:.5f} ({ate / length:.5f} of the "
            f"{length:.3f} m path, scale {scale:.4f}); {s.kf_counter} keyframes, "
            f"{s.n_keyframes} live; {r['seconds'] * 1e3 / r['n_frames']:.3f} ms/frame")


def async_system(scene, device) -> AsyncSLAMSystem:
    """`loop_system`'s configuration as an AsyncSLAMSystem: the mapper and
    loop threads start with it."""
    camera = scene.camera_model()
    return AsyncSLAMSystem(slam.SlamConfig(
        camera=camera, vocabulary=load_pretrained()), device=device)


def async_path(scene, device, system=None, period=ASYNC_FRAME_PERIOD):
    """The loop path's frames through a fresh `async_system` (or `system`)
    with its threads live: process_batch on the caller's thread, fed by a
    `PacedFeed` at one frame every `period` seconds and at most the
    config's chunk per call, local mapping and loop closing on their
    threads (the port of scripts/bench_async_pipeline.py, paced as the
    reference's examples pace a sequence). Only the mapper writes the map,
    so LOOP_DRIFT goes in inside an exclusive window where
    `drive_loop_frames` places it: `finish()` (the queue drains to the
    keyframe at or after LOOP_DRIFT_AT; `release()` would drop queued
    keyframes, as LocalMapping::Release does), `request_stop()`,
    `inject_drift`, `release()`; the camera waits out that window. Each
    loop correction is recorded on the loop thread (frame, keyframe pair,
    group, merges, keyframe ATE before and after).
    Returns a dict: the system (its threads still running: the caller
    closes it), the ground-truth poses, the frames, the poses out, the drift's frame
    and the keyframe ATE just before it, the closures, the period, and
    host-clock seconds of the tracking thread inside process_batch
    (`track_s`), of the whole paced run without the injection window
    (`wall_s`), of the final `finish()` (`drain_s`) and of the injection
    window (`inject_s`), the feed's calls and frames handed over
    behind the camera, and per keyframe integration on the mapper thread
    (the keyframe's frame, the tracker's frame when it ended, host-clock
    seconds)."""
    poses, frames = loop_frames(scene, device)
    s = system or async_system(scene, device)
    closures = []
    setup = s._setup_place_recognition

    def setup_recorded(*args):
        setup(*args)
        lc = s.loop_closer
        if lc is None:
            return
        correct = lc.correct

        def recorded_correct(system, new_kf, cand, S12):
            before = keyframe_ate(system, poses)[0]
            ok = correct(system, new_kf, cand, S12)
            closures.append(dict(frame_id=system.frame_id - 1, ate_before=before,
                                 ate_after=keyframe_ate(system, poses)[0],
                                 **lc.last_correction))
            return ok

        lc.correct = recorded_correct

    s._setup_place_recognition = setup_recorded
    integrations = []
    integrate = s._integrate_keyframe

    def timed_integrate(frame, *args, **kw):
        t = time.perf_counter()
        try:
            return integrate(frame, *args, **kw)
        finally:
            integrations.append((frame.frame_id, s.frame_id, time.perf_counter() - t))

    s._integrate_keyframe = timed_integrate
    feed = PacedFeed(period, s.cfg.track_chunk_size)
    window = {}

    def inject(system):
        t = time.perf_counter()
        system.finish()
        before = keyframe_ate(system, poses)[0]
        system.request_stop()
        try:
            inject_drift(system, *LOOP_DRIFT)
        finally:
            system.release()
        window["s"] = time.perf_counter() - t
        feed.pause(window["s"])
        return before

    try:
        _sync()
        t = time.perf_counter()
        out, drift_after, ate_drift = drive_loop_frames(s, frames, inject, feed=feed)
        _sync()
        wall_s = time.perf_counter() - t - window["s"]
        t = time.perf_counter()
        s.finish()
        _sync()
        drain_s = time.perf_counter() - t
    except BaseException:
        s.close()
        raise
    return dict(system=s, poses=poses, frames=frames, out=out,
                drift=(drift_after, ate_drift), closures=closures, period=period,
                track_s=feed.busy, wall_s=wall_s, drain_s=drain_s,
                inject_s=window["s"], calls=feed.calls, behind=feed.behind,
                integrations=integrations, n_frames=len(frames))


def _ranges(ids):
    """'a-b, c' for sorted integers."""
    out, start = [], None
    for i, v in enumerate(ids):
        if start is None:
            start = v
        if i + 1 == len(ids) or ids[i + 1] != v + 1:
            out.append(f"{start}" if start == v else f"{start}-{v}")
            start = None
    return ", ".join(out)


def async_summary(r):
    """One line on an `async_path` result: the pace, the first frame
    tracked, the share of later frames tracked and the frames lost,
    n_relocs, n_loops_closed, each closure (its frame, keyframe pair and
    the candidate's frame, merges, keyframe ATE before and after), the
    keyframe ATE at the end, keyframes, the tracking thread's ms/frame
    inside process_batch, the paced run's wall ms/frame, the final drain,
    and the frames handed over behind the camera."""
    s, out = r["system"], r["out"]
    first = next((i for i, p in enumerate(out) if p is not None), None)
    tracked = 0 if first is None else sum(p is not None for p in out[first:])
    n_after = 0 if first is None else len(out) - first
    lost = [] if first is None else [i for i in range(first, len(out))
                                     if out[i] is None]
    fid = s.map.kf_frame_id.cpu().numpy()
    cl = "; ".join(
        f"closure near frame {c['frame_id']}: keyframe {c['new_kf']} (frame "
        f"{fid[c['new_kf']]}) to {c['cand']} (frame {fid[c['cand']]}), group "
        f"{c['group']}, {c['merged']} points merged, keyframe ATE "
        f"{c['ate_before']:.5f} -> {c['ate_after']:.5f}"
        for c in r["closures"]) or "no closure"
    if s.n_keyframes:
        ate, scale, length, _ = keyframe_ate(s, r["poses"])
        ate_text = (f"keyframe ATE at the end {ate:.5f} ({ate / length:.5f} of the "
                    f"{length:.3f} m path, scale {scale:.4f})")
    else:
        ate_text = "no keyframe at the end"
    n = r["n_frames"]
    integ = r["integrations"]
    lag = [done - kf for kf, done, _ in integ]
    integ_text = (f"{len(integ)} integrations on the mapper thread, "
                  f"{statistics.median(x for _, _, x in integ) * 1e3:.1f} ms median, "
                  f"{max(x for _, _, x in integ) * 1e3:.1f} max, the tracker "
                  f"{statistics.median(lag)} frames on (median, max {max(lag)}) when "
                  f"each ended" if integ else "no integration")
    return (f"one frame every {r['period'] * 1e3:.0f} ms: first frame tracked {first}, "
            f"{tracked} of {n_after} after it tracked "
            f"(lost: {_ranges(lost) or 'none'}), n_relocs {s.n_relocs}, "
            f"n_loops_closed {s.n_loops_closed}; drift after frame {r['drift'][0]}, "
            f"keyframe ATE before it {r['drift'][1]:.5f}; {cl}; {ate_text}; "
            f"lost_count {s.lost_count}, state {s.state}; {integ_text}; "
            f"{s.kf_counter} keyframes, {s.n_keyframes} live; tracking "
            f"thread {r['track_s'] * 1e3 / n:.3f} ms/frame inside process_batch, "
            f"wall {r['wall_s'] * 1e3 / n:.3f} ms/frame, the final drain "
            f"{r['drain_s'] * 1e3:.1f} ms; {r['calls']} calls, {r['behind']} frames "
            f"handed over behind the camera; the injection window "
            f"{r['inject_s'] * 1e3:.1f} ms (not counted)")


# the capacity path: a map small enough that both pools fill. The camera
# sweeps a short stretch of the loop scene sideways, out and back
# CAPACITY_LEGS times, so that it stays over mapped ground while the
# keyframe pool is full: a full pool admits no keyframe, and it gets a slot
# back only if the integration that took its last one culls a neighbour,
# which none did on the card in nine configurations, so a camera that
# moves on to new ground is lost (ROADMAP C18). The loop scene leaves
# ~350 live points at 640x480 (a 4096-point pool never wrapped), hence 512
CAPACITY_KEYFRAMES = 16
CAPACITY_POINTS = 512
CAPACITY_SWEEP = 30
CAPACITY_LEGS = 6


def capacity_poses(sweep: int = CAPACITY_SWEEP, legs: int = CAPACITY_LEGS):
    """`legs` sideways legs over the first `sweep` poses of the loop
    path, out, back, out, ... (each turn point once)."""
    out = lateral_trajectory(sweep, step=MAPPING_STEP, yaw_rate=0.0)
    parts = [out] + [(out[::-1] if leg % 2 else out)[1:] for leg in range(1, legs)]
    return np.concatenate(parts)


def capacity_system(scene, device, max_keyframes: int = CAPACITY_KEYFRAMES,
                    max_points: int = CAPACITY_POINTS) -> slam.SLAMSystem:
    """A SLAMSystem at the SlamConfig defaults (ORBConfig(), chunk 8,
    relocalisation on with the shipped vocabulary, loop closing off) for
    the scene's camera, with a map of `max_keyframes` keyframes and
    `max_points` points, to start from raw frames."""
    return slam.SLAMSystem(slam.SlamConfig(
        camera=scene.camera_model(),
        map=MapConfig(max_keyframes=max_keyframes, max_points=max_points),
        enable_loop_closing=False, enable_relocalisation=True,
        vocabulary=load_pretrained()), device=device)


class SlotRecord:
    """The slot traffic of a SLAMSystem: each point slot that the
    initialisation or a triangulation writes (`recycled` when it held a
    point before), each keyframe slot allocated and culled, the keyframe
    decisions met with a full keyframe pool, and each integration's
    host-clock ms (the device synchronized at both ends) with whether it
    took the pool's last free slot. Attach with `recording()`, which also
    wraps `insert_new_points` of pipeline/system.py while it is open."""

    def __init__(self, s: slam.SLAMSystem):
        self.s = s
        self.written = []        # point slots, in the order written
        self.recycled = 0
        self.kf_allocs = []      # (integration index, slot)
        self.culls = []          # (integration index, slot, pool full)
        self.refused_full = 0
        self.integrations = []   # (ms, pool full)
        self._seen = set()

    def _write(self, slots):
        for p in slots:
            self.recycled += p in self._seen
            self._seen.add(p)
            self.written.append(p)

    @contextlib.contextmanager
    def recording(self):
        s, insert = self.s, slam.insert_new_points
        methods = {k: getattr(s, k) for k in (
            "_try_initialize", "_need_new_keyframe", "_integrate_keyframe")}

        def try_initialize(frame):
            ok = methods["_try_initialize"](frame)
            if ok:
                self._write(int(p) for p in np.where(
                    s.map.pt_valid.cpu().numpy())[0])
            return ok

        def need_new_keyframe(frame_id, n_inliers):
            need = methods["_need_new_keyframe"](frame_id, n_inliers)
            self.refused_full += not s.free_kf and not need
            return need

        def integrate_keyframe(*args, **kw):
            free = list(s.free_kf)
            full = len(free) == 1
            _sync()
            t = time.perf_counter()
            slot = methods["_integrate_keyframe"](*args, **kw)
            _sync()
            i = len(self.integrations)
            self.integrations.append(((time.perf_counter() - t) * 1e3, full))
            self.kf_allocs.append((i, slot))
            self.culls += [(i, k, full) for k in s.free_kf if k not in free[1:]]
            return slot

        def insert_new_points(m, kf, nb, cand, free):
            m, n = insert(m, kf, nb, cand, free)
            self._write(int(p) for p in free[:int(n)].cpu())
            return m, n

        s._try_initialize = try_initialize
        s._need_new_keyframe = need_new_keyframe
        s._integrate_keyframe = integrate_keyframe
        slam.insert_new_points = insert_new_points
        try:
            yield self
        finally:
            slam.insert_new_points = insert
            for k, v in methods.items():
                setattr(s, k, v)

    def replaced(self, culls):
        """Those of `culls` ((integration, slot, pool full) entries) whose
        slot a later keyframe took."""
        return [c for c in culls
                if any(j > c[0] and slot == c[1] for j, slot in self.kf_allocs)]


def slot_failures(s: slam.SLAMSystem) -> list:
    """What is wrong with the slot bookkeeping of `s`: `free_pt` must hold
    exactly the invalid point slots, once each; `free_kf` no live keyframe,
    once each; every `pt_forward` entry -1 or a slot, and a live point
    forwarding to itself (a free slot forwards to itself as well, as the
    table starts, and a merged point to the point it became); the spanning
    parents of the live keyframes a tree: no cycle, every parent live, one
    root."""
    out = []
    pt_valid = s.map.pt_valid.cpu().numpy()
    kf_valid = s.map.kf_valid.cpu().numpy()
    if sorted(s.free_pt) != [int(i) for i in np.where(~pt_valid)[0]]:
        out.append(f"free_pt ({len(s.free_pt)}) is not the "
                   f"{int((~pt_valid).sum())} invalid point slots")
    if len(set(s.free_pt)) != len(s.free_pt):
        out.append("free_pt repeats a slot")
    if len(set(s.free_kf)) != len(s.free_kf) or any(kf_valid[s.free_kf]):
        out.append(f"free_kf {s.free_kf} repeats a slot or holds a live keyframe")
    f = np.asarray(s.pt_forward)
    P = len(pt_valid)
    live = np.where(pt_valid)[0]
    if ((f < -1) | (f >= P)).any() or (f[live] != live).any():
        out.append("pt_forward has an entry out of range or a live point "
                   "forwarding elsewhere")
    sp = s.map.spanning_parent.cpu().numpy()
    roots = set()
    for k in np.where(kf_valid)[0]:
        seen, cur = set(), int(k)
        while sp[cur] >= 0 and cur not in seen:
            seen.add(cur)
            cur = int(sp[cur])
            if not kf_valid[cur]:
                out.append(f"keyframe {k}'s spanning chain reaches culled {cur}")
                break
        if cur in seen:
            out.append(f"spanning tree cycle through keyframe {k}")
        roots.add(cur)
    if len(roots) != 1:
        out.append(f"spanning tree roots {sorted(roots)}")
    return out


def capacity_path(scene, device, system=None, poses=None):
    """The capacity path on a fresh `capacity_system` (or `system`): the
    frames of `poses` (capacity_poses()) through process_batch at the
    config's chunk, under a SlotRecord. Returns a dict: the system, the
    ground-truth poses, the poses out, the record, the seconds of the run
    and the number of frames."""
    poses = capacity_poses() if poses is None else poses
    s = system or capacity_system(scene, device)
    frames = torch.from_numpy(np.stack([scene.render_image(p) for p in poses])).to(device)
    record = SlotRecord(s)
    _sync()
    t = time.perf_counter()
    with record.recording():
        out = s.process_batch(frames)
    _sync()
    return dict(system=s, poses=poses, out=out, record=record,
                seconds=time.perf_counter() - t, n_frames=len(poses))


def capacity_failures(r) -> list:
    """The capacity path's checks on a `capacity_path` result: the point
    pool wrapped (more slots written than it holds), the keyframe pool
    full at some keyframe decision, each keyframe culled while it was full
    replaced by a later one, `slot_failures`, >= 90% of the frames after
    the first tracked one tracked, WORKING at the end, the keyframe ATE
    after a Sim3 alignment at most 2% of the path; and, since a cull with
    the pool full is rare (C18), a keyframe culled and every culled slot,
    full or not, taken by a later keyframe."""
    s, rec = r["system"], r["record"]
    cfg = s.cfg.map
    out = []
    if len(rec.written) <= cfg.max_points:
        out.append(f"{len(rec.written)} point slots written, not more than "
                   f"the {cfg.max_points} of the pool")
    if not rec.refused_full:
        out.append("the keyframe pool was never full at a keyframe decision")
    kept = [c for c in rec.culls if c not in rec.replaced(rec.culls)]
    if not rec.culls or kept:
        out.append(f"culls {rec.culls}, never replaced: {kept}")
    out += slot_failures(s)
    first = next((i for i, p in enumerate(r["out"]) if p is not None), None)
    after = r["out"][first:] if first is not None else []
    tracked = sum(p is not None for p in after)
    if first is None or tracked < 0.9 * len(after):
        out.append(f"{tracked} of {len(after)} frames tracked")
    if s.state != slam.WORKING:
        out.append(f"state {slam.STATE_NAMES[s.state]} at the end")
    ate, _, length, _ = keyframe_ate(s, r["poses"])
    if not ate <= 0.02 * length:
        out.append(f"keyframe ATE {ate:.5f} over 2% of the {length:.4f} m path")
    return out


def capacity_summary(r) -> str:
    """One line on a `capacity_path` result."""
    s, rec = r["system"], r["record"]
    full = [c for c in rec.culls if c[2]]
    before = [ms for ms, f in rec.integrations if not f]
    at = [ms for ms, f in rec.integrations if f]
    med = lambda v: f"{statistics.median(v):.1f}" if v else "-"
    first = next((i for i, p in enumerate(r["out"]) if p is not None), 0)
    tracked = sum(p is not None for p in r["out"])
    ate, _, length, _ = keyframe_ate(s, r["poses"])
    return (f"{r['n_frames']} frames, first tracked {first}, {tracked} tracked, "
            f"state {slam.STATE_NAMES[s.state]}, lost_count {s.lost_count}, "
            f"n_relocs {s.n_relocs}; point slots written {len(rec.written)} "
            f"(recycled {rec.recycled}) into {s.cfg.map.max_points}, "
            f"{s.n_points} live; keyframe slots allocated {s.kf_counter} "
            f"into {s.cfg.map.max_keyframes}, culled {len(rec.culls)} "
            f"({len(full)} with the pool full), {len(rec.replaced(rec.culls))} "
            f"of them replaced, {s.n_keyframes} live; {rec.refused_full} keyframe "
            f"decisions at capacity; integrations {len(before)} before capacity "
            f"(median {med(before)} ms) and {len(at)} at it (median {med(at)} "
            f"ms); keyframe ATE {ate:.5f} on a {length:.4f} m path "
            f"({ate / length:.5f}); {r['seconds'] * 1e3 / r['n_frames']:.3f} "
            f"ms/frame")


def chain_pose_graph(K: int, seed: int = 0):
    """The arguments of optimize_essential_graph for a chain of K keyframe
    Sim3s on a circle, drifted (rotation 0.01 rad, translation 0.02 and
    scale 0.003 of random walk per keyframe), with the true relative
    measurements of the chain and of loop edges from keyframe 0 to every
    16th, the first keyframe fixed and the edges padded to a power of two
    (the PCG cell of chip_smoke.py's phase 15 at K = 1024)."""
    from scipy.spatial.transform import Rotation

    from orb_slam_tpu_torch.solvers.essential_graph import relative_sim3_batch

    rng = np.random.default_rng(seed)
    ang = np.linspace(0, 2 * np.pi, K, endpoint=False)
    true_R = Rotation.from_rotvec(np.stack([0 * ang, ang, 0 * ang], 1)).as_matrix()
    true_t = np.stack([4 * np.sin(ang), 0 * ang, 4 * np.cos(ang)], 1)
    est_R = Rotation.from_rotvec(rng.normal(0, 0.01, (K, 3))).as_matrix() @ true_R
    est_t = true_t + np.cumsum(rng.normal(0, 0.02, (K, 3)), 0)
    est_s = np.exp(np.cumsum(rng.normal(0, 0.003, K)))
    pairs = [(k, k + 1) for k in range(K - 1)] + [(0, k) for k in range(16, K, 16)]
    E = 1
    while E < len(pairs):
        E *= 2
    ei = np.zeros(E, np.int64)
    ej = np.zeros(E, np.int64)
    ev = np.zeros(E, bool)
    ei[:len(pairs)], ej[:len(pairs)] = zip(*pairs)
    ev[:len(pairs)] = True
    f32 = lambda a: torch.from_numpy(np.asarray(a, np.float32))
    ms, mR, mt = relative_sim3_batch(
        torch.ones(E), f32(true_R[ei]), f32(true_t[ei]),
        torch.ones(E), f32(true_R[ej]), f32(true_t[ej]))
    fixed = torch.zeros(K, dtype=torch.bool)
    fixed[0] = True
    return [f32(est_s), f32(est_R), f32(est_t), torch.from_numpy(ei),
            torch.from_numpy(ej), ms, mR, mt, torch.from_numpy(ev), fixed]


def synthetic_tree(k: int, L: int, seed: int = 0):
    """A complete k-ary vocabulary tree of depth L with random node
    descriptors (scripts/vocab_scale_study.py::synth_full_tree, which
    imports the JAX package): at k=10, L=6 the 1,111,111 nodes and
    1,000,000 words of the reference's ORBvoc.txt, ~36 MB of node
    descriptors."""
    from orb_slam_tpu_torch.place.vocabulary import Vocabulary

    rng = np.random.default_rng(seed)
    n_nodes = (k ** (L + 1) - 1) // (k - 1)
    n_words = k ** L
    n_internal = n_nodes - n_words
    children = np.full((n_nodes, k), -1, np.int32)
    internal = np.arange(n_internal, dtype=np.int64)
    children[:n_internal] = internal[:, None] * k + 1 + np.arange(k)[None, :]
    node_desc = rng.integers(0, 2 ** 32, (n_nodes, 8), dtype=np.uint32).view(np.int32)
    node_desc[0] = 0
    is_leaf = np.zeros(n_nodes, bool)
    is_leaf[n_internal:] = True
    word_of_node = np.full(n_nodes, -1, np.int32)
    word_of_node[n_internal:] = np.arange(n_words)
    level = np.repeat(np.arange(L + 1, dtype=np.int32), [k ** i for i in range(L + 1)])
    return Vocabulary(
        children=children, node_desc=node_desc, is_leaf=is_leaf,
        word_of_node=word_of_node,
        node_of_word=np.arange(n_internal, n_nodes, dtype=np.int32),
        word_weight=rng.uniform(0.1, 2.0, n_words).astype(np.float32),
        level_of_node=level, k=k, L=L)


def aligned_centre_error(align, gt, T, fid):
    """Metres between the camera centre of pose T, through a
    `reloc_alignment` alignment, and the ground truth of frame `fid`."""
    c = -T[:3, :3].T.astype(np.float64) @ np.asarray(T[:3, 3], np.float64)
    c_gt = camera_centers_from_cw(np.asarray(gt[fid:fid + 1], np.float64))[0]
    return float(np.linalg.norm(align(c[None])[0] - c_gt))


def _atomic_scatter_add_(out, rows, index, values, live):
    """local_ba._scatter_add_ with CUDA's atomic index_add_ on the card,
    whose order of addition changes from run to run."""
    spare = torch.arange(rows, rows + index.shape[0], device=index.device)
    return out.index_add_(0, torch.where(live, index, spare), values)


def mapping_spread(card, N, seeds=(0, 1, 2, 3), cpu_seeds=(0, 1), device=None):
    """How far the mapping path's keyframe centres move with the order of
    its float sums: chip_smoke.py's phase 9 (one frame per chunk) for each
    scene seed on the card with BA's ordered scatter-adds (the port's,
    which repeat), twice with CUDA's atomic index_add_ in their place, and
    on the CPU for `cpu_seeds`. Prints per run the keyframes inserted, the
    least inliers of a frame, the keyframe ATE after a Sim3 alignment
    (`keyframe_ate`, over the path length) and the keyframe centre error's
    max and mean, and per CPU run the largest distance between its
    keyframe centres and the card's (ordered run) over the keyframes of
    the same frames. Then per seed chip_smoke.py's phase 10 on the card,
    the system from raw frames through its own initialisation, and its
    keyframe ATE. `device`: the card (default cuda:0)."""
    cpu = torch.device("cpu")
    card_dev = device or torch.device("cuda", 0)
    for seed in seeds:
        scene = SyntheticScene(n_points=800, width=640, height=480, seed=seed)
        poses = lateral_trajectory(N + 2, step=MAPPING_STEP, yaw_rate=MAPPING_YAW)
        frames = torch.from_numpy(np.stack([scene.render_image(p) for p in poses]))
        runs = [("card, ordered", card_dev, False), ("card, atomic", card_dev, True),
                ("card, atomic", card_dev, True)]
        if seed in cpu_seeds:
            runs.append(("CPU", cpu, False))
        ref = None
        for label, dev, atomic in runs:
            fr = frames.to(dev)
            s = mapping_system(scene, poses, fr, dev)
            inl = []
            need = s._need_new_keyframe

            def recorded(frame_id, n_in, need=need, inl=inl):
                inl.append(n_in)
                return need(frame_id, n_in)

            s._need_new_keyframe = recorded
            ordered = ba._scatter_add_
            if atomic:
                ba._scatter_add_ = _atomic_scatter_add_
            t = time.perf_counter()
            try:
                s.process_batch(fr[2:N + 2], chunk_size=1)
            finally:
                ba._scatter_add_ = ordered
            run_s = time.perf_counter() - t
            fid, c, err = keyframe_center_errors(s, poses)
            ate, scale, length, _ = keyframe_ate(s, poses)
            vs = ""
            if ref is None:
                ref = dict(zip(fid.tolist(), c))
            else:
                both = [i for i, f in enumerate(fid.tolist()) if f in ref]
                d = max((np.linalg.norm(c[i] - ref[fid[i]]) for i in both), default=0.0)
                vs = (f"; vs the card's ordered run: {len(both)} keyframes of the "
                      f"same frames ({len(fid) - len(both)} not), centres up to "
                      f"{d:.4f} apart")
            print(f"spread seed {seed} {label}: {s.kf_counter - 2} keyframes, "
                  f"{len(fid)} live, inliers min {min(inl)}, keyframe ATE "
                  f"{ate:.5f} ({ate / length:.5f} of the path, scale "
                  f"{scale:.4f}), keyframe centre error max {err.max():.4f} "
                  f"mean {err.mean():.4f} ({run_s:.1f} s){vs}; {card}", flush=True)
        s = init_system(scene, card_dev)
        t = time.perf_counter()
        out = s.process_batch(frames.to(card_dev)[:N + 2])
        run_s = time.perf_counter() - t
        first = next((i for i, p in enumerate(out) if p is not None), None)
        ate, scale, length, fid = keyframe_ate(s, poses)
        print(f"spread seed {seed} init path, card: initialised at frame {first}, "
              f"{sum(p is not None for p in out)} of {len(out)} frames tracked, "
              f"lost_count {s.lost_count}, {s.kf_counter} keyframes, {len(fid)} "
              f"live, keyframe ATE {ate:.5f} ({ate / length:.5f} of the path, "
              f"scale {scale:.4f}) ({run_s:.1f} s); {card}", flush=True)
        r = reloc_path(scene, card_dev, record=False)
        print(f"spread seed {seed} reloc path, card: {reloc_summary(r)}; {card}",
              flush=True)
        r = loop_path(loop_scene(seed), card_dev, record=False)
        print(f"spread seed {seed} loop path, card: {loop_summary(r)}; {card}",
              flush=True)


def reloc_summary(r):
    """One line on a `reloc_path` result: the state after the blackout,
    n_relocs, the first revisit frame tracked and its aligned camera-centre
    error over the mapped path's length, the revisit frames tracked, the
    keyframe ATE's share of the path."""
    s, gt = r["system"], r["gt"]
    rmse, align, length = reloc_alignment(s, gt)
    rev = r["revisit"]
    first = next((i for i, p in enumerate(rev) if p is not None), None)
    err = (float("nan") if first is None else aligned_centre_error(
        align, gt, rev[first], RELOC_MAPPED + RELOC_BLACKOUT + first))
    ab = r["after_blackout"]
    return (f"after the blackout {slam.STATE_NAMES[ab['state']]} with "
            f"{ab['n_keyframes']} keyframes; n_relocs {s.n_relocs}, first revisit "
            f"frame tracked {first}, its aligned centre {err:.5f} m off "
            f"({err / length:.5f} of the {length:.4f} m mapped path); "
            f"{sum(p is not None for p in rev)} of {len(rev)} revisit frames tracked; "
            f"keyframe ATE {rmse:.5f} ({rmse / length:.5f}); {s.kf_counter} keyframes; "
            f"{r['seconds'] * 1e3 / r['n_frames']:.3f} ms/frame")


def device_work_by_label(trace_path):
    """{label: (device us, work items)} of a chrome trace: each kernel,
    copy or fill is charged to the innermost user annotation whose host
    span holds the runtime call that launched it (matched by correlation
    id); work launched outside every annotation is charged to None."""
    with open(trace_path) as f:
        tr = json.load(f)
    evs = tr["traceEvents"] if isinstance(tr, dict) else tr
    spans = sorted(((e["ts"], e["ts"] + e.get("dur", 0), e["name"])
                    for e in evs if e.get("cat") == "user_annotation"),
                   key=lambda x: x[1] - x[0])
    launch_ts = {e["args"]["correlation"]: e["ts"] for e in evs
                 if e.get("cat") == "cuda_runtime" and "correlation" in e.get("args", {})}
    out = {}
    for e in evs:
        if e.get("cat") not in DEVICE_CATS:
            continue
        t = launch_ts.get(e.get("args", {}).get("correlation"))
        label = None
        if t is not None:
            label = next((n for a, b, n in spans if a <= t <= b), None)
        us, n = out.get(label, (0.0, 0))
        out[label] = (us + e.get("dur", 0), n + 1)
    return out


def ba_stage_inputs(P, O, Kl, dev, seed=0):
    """The synthetic inputs of scripts/profile_ba.py: 128 identity
    cameras, 90 of them optimized (slot 0 fixed), P points, O observations
    each to a random camera, one edge in five live."""
    K = 128
    rng = np.random.default_rng(seed)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    return dict(
        kf_pose=torch.eye(4, device=dev).repeat(K, 1, 1),
        pt_pos=t(np.stack([rng.uniform(-3, 3, P), rng.uniform(-2, 2, P),
                           rng.uniform(4, 10, P)], 1).astype(np.float32)),
        obs_kf=t(rng.integers(0, 90, (P, O)).astype(np.int32)),
        uv=t(rng.uniform([0, 0], [640, 480], (P, O, 2)).astype(np.float32)),
        w=t((rng.random((P, O)) < 0.2).astype(np.float32)),
        cam_opt=(torch.arange(K, device=dev) < 90) & (torch.arange(K, device=dev) > 0),
        pt_opt=torch.ones(P, dtype=torch.bool, device=dev),
        K_mat=t(np.array([[500.0, 0, 320], [0, 500.0, 240], [0, 0, 1]], np.float32)),
        Kl=Kl)


def _event_ms(fn, reps):
    """Median CUDA-event ms of fn() over `reps` runs after one warmup."""
    fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def ba_stage_split(dev, P, O=32, Kl=80, reps=5):
    """CUDA-event medians (ms) of the stages of one local-BA solver step
    on ba_stage_inputs, through local_ba's own stage helpers and cumulative
    as scripts/profile_ba.py times them: B1 `_edge_terms`; B2 = B1 +
    `_point_blocks` (3x3 inverse, Cholesky); B3 = B2 + `_camera_system`
    (the Schur terms and their assembly into the reduced camera system);
    B5 `_solve_cameras` alone, the dense [6 Kl] solve. Also
    `_schur_assembly` alone, JAX's form of it (a loop over the second
    observation, :279-285, each round scattered by CUDA's atomic
    `index_add_` with the dead edges on one dump row; and that loop's
    einsums alone), and the whole `_solve_iteration`."""
    x = ba_stage_inputs(P, O, Kl, dev)
    Kk = x["kf_pose"].shape[0]
    local_id = ba._camera_compaction(x["cam_opt"], Kl)[0]
    kf_idx = torch.where(x["w"] > 0, local_id[x["obs_kf"].long().clamp(0, Kk - 1)], Kl)
    damping = torch.tensor(1e-3, device=dev)

    def b1():
        return ba._edge_terms(x["kf_pose"], x["pt_pos"], x["obs_kf"], x["uv"], x["K_mat"])

    def b2():
        r, Jc, Jp, _ = b1()
        w = x["w"][..., None, None]
        return (r, Jc, Jp, Jc * w) + ba._point_blocks(Jp * w, Jp, r, x["pt_opt"],
                                                      damping)

    def b3():
        r, Jc, Jp, wJc, Hpp_inv, L, bp = b2()
        return ba._camera_system(wJc, Jc, Jp, r, Hpp_inv, L, bp, kf_idx,
                                 x["pt_opt"], Kl)

    def jax_loop(D, atomic):
        S = torch.zeros(((Kl + 1) * (Kl + 1), 6, 6), device=dev)
        for q in range(O):
            V = torch.einsum("poxz,pyz->poxy", D, D[:, q])
            if atomic:
                cell = (kf_idx * (Kl + 1) + kf_idx[:, q:q + 1]).reshape(-1)
                S.index_add_(0, cell, -V.reshape(-1, 6, 6))
        return S

    L = b2()[5]
    Hcc, S, b, C = b3()
    D = torch.einsum("poxy,pyz->poxz", C, L)
    d = torch.arange(Kl, device=dev)
    Hs = ba._reduced_system(Hcc, S)[:Kl, :Kl]
    Hs[d, d] += damping * torch.eye(6, device=dev)
    return {
        "B1 edge terms": _event_ms(b1, reps),
        "B2 ..+ point blocks": _event_ms(b2, reps),
        "B3 ..+ camera system": _event_ms(b3, reps),
        "B5 dense solve": _event_ms(lambda: ba._solve_cameras(Hs, b[:Kl]), reps),
        "Schur assembly alone": _event_ms(lambda: ba._schur_assembly(D, kf_idx, Kl),
                                          reps),
        "JAX's O loop, atomic index_add_": _event_ms(lambda: jax_loop(D, True), reps),
        "JAX's O loop, einsums alone": _event_ms(lambda: jax_loop(D, False), reps),
        "whole _solve_iteration": _event_ms(lambda: ba._solve_iteration(
            x["kf_pose"], x["pt_pos"], x["w"], x["obs_kf"], x["uv"], x["K_mat"],
            x["cam_opt"], x["pt_opt"], damping, Kl=Kl), reps),
    }


def _ms_per_frame(fn, n_frames, windows=3):
    """Median host-clock ms/frame of fn() over `windows` runs, after one
    warmup run, each ended by a device synchronize."""
    fn()
    torch.cuda.synchronize()
    dts = []
    for _ in range(windows):
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        dts.append(time.perf_counter() - t)
    return statistics.median(dts) * 1e3 / n_frames


def profile_tracking(name, cfg, cam, scene, poses, frames, K, N, card):
    """One turn of a tracking path (see the module docstring)."""
    dev = frames.device
    H, W = frames.shape[1:]
    ex = ORBExtractor(cfg, H, W, device=dev)
    f0 = ex(frames[0])
    state = seed_map(scene, poses[0], f0.xy, f0.desc_i32, f0.octave, f0.valid,
                     MapConfig(max_keyframes=64, max_points=8192,
                               n_features=cfg.n_features), device=dev)

    def run(shift):
        return extract_track_chunk(
            frames[1:] + shift, ex, cam, state,
            torch.from_numpy(poses[0]).to(dev), torch.eye(4, device=dev),
            K, p_local=4096, radius=15.0, min_inliers=30,
            use_motion_model=True, max_dist=100)

    extract_ms = _ms_per_frame(lambda: [ex(f) for f in frames[1:]], N)
    path_ms = _ms_per_frame(lambda: run(0.31), N)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run(0.62)
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type.name == "CUDA" and e.self_device_time_total > 0]
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / N
    launches = sum(e.count for e in kernels) / N
    print(f"{name}: extraction {extract_ms:.3f} ms/frame, whole path "
          f"{path_ms:.3f} ms/frame; device kernels {device_ms:.3f} "
          f"ms/frame ({launches:.1f} launches/frame), busy share "
          f"{device_ms / path_ms:.3f}; {card}")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]:
        print(f"    {e.self_device_time_total / N:9.1f} us/frame "
              f"{e.count / N:6.1f}/frame  {e.key[:90]}")
    for e in kernels:
        if any(k in e.key for k in PORT_KERNELS):
            print(f"    port kernel {e.key[:60]}: "
                  f"{e.self_device_time_total / e.count:.2f} us per launch, "
                  f"{e.count / N:.1f} launches/frame")


def profile_mapping(scene, poses, frames, N, card):
    """One turn of the mapping path (see the module docstring)."""
    dev = frames.device
    s = mapping_system(scene, poses, frames, dev)
    timer = s._stage_timer = StageTimer()
    torch.cuda.synchronize()
    t = time.perf_counter()
    s.process_batch(frames[2:N + 2])
    torch.cuda.synchronize()
    path_s = time.perf_counter() - t
    n_kf = s.kf_counter - 2

    s = mapping_system(scene, poses, frames, dev)
    s._stage_timer = record_function
    with tempfile.TemporaryDirectory() as tmp:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            s.process_batch(frames[2:N + 2])
            torch.cuda.synchronize()
        trace = os.path.join(tmp, "mapping.json")
        prof.export_chrome_trace(trace)
        work = device_work_by_label(trace)
    n_kf_prof = s.kf_counter - 2
    # the stages alone; work under the program's spans outside every stage
    # counts as tracking and replay
    host = {n: v for n, v in timer.times.items() if n in timer.stage_names}
    outside = [w for label, w in work.items() if label not in host]
    work = {label: w for label, w in work.items() if label in host}
    work[None] = tuple(map(sum, zip(*outside))) if outside else (0.0, 0)
    stage_s = sum(sum(v) for v in host.values())
    dev_us = sum(us for us, _ in work.values())
    items = sum(n for _, n in work.values())
    print(f"mapping: {N} frames, {n_kf} keyframes ({n_kf_prof} in the profiled "
          f"run), whole path {path_s * 1e3 / N:.3f} ms/frame, local mapping "
          f"{stage_s * 1e3 / max(n_kf, 1):.3f} ms per keyframe integration; "
          f"device {dev_us / 1e3 / N:.3f} ms/frame, {items / N:.1f} work items/"
          f"frame, busy share {dev_us * 1e-6 / path_s:.3f}; {card}")
    for name in list(host) + [None]:
        us, n = work.get(name, (0.0, 0))
        if name is None:
            label, h = "tracking and replay (outside the stages)", path_s - stage_s
        else:
            label, h = name, sum(host[name])
        per = max(n_kf_prof, 1)
        print(f"    {label}: host {h * 1e3 / max(n_kf, 1):.3f} ms, device "
              f"{us / 1e3 / per:.3f} ms, {n / per:.1f} work items per keyframe "
              f"integration; busy share {us * 1e-6 / max(h, 1e-9):.3f}")


def profile_loop(card, dev):
    """The loop turn: the loop path once with its passes recorded
    (`loop_summary`), then its accepted pass again from the saved state
    under torch.profiler with each stage labelled: per stage the host-clock
    ms (the recorded run's stage clock), the device time, the device work
    items (kernels, copies, fills) and the busy share."""
    scene = loop_scene()
    r = loop_path(scene, dev)
    print(f"loop: {loop_summary(r)}; {card}", flush=True)
    if not r["closures"]:
        return
    c = r["closures"][0]
    split = next(p for p in r["passes"] if p["frame_id"] == c["frame_id"])["split"]
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    loop_replay(c, dev, stage_timer=record_function, within=prof)
    with tempfile.TemporaryDirectory() as tmp:
        trace = os.path.join(tmp, "loop.json")
        prof.export_chrome_trace(trace)
        work = device_work_by_label(trace)
    host_s = sum(sum(v) for v in split.values())
    dev_us = sum(us for us, _ in work.values())
    print(f"loop: the accepted pass (frame {c['frame_id']}, keyframe {c['new_kf']} to "
          f"{c['cand']}) from its saved state: host {host_s * 1e3:.3f} ms by the stage "
          f"clock, device {dev_us / 1e3:.3f} ms, {sum(n for _, n in work.values())} work "
          f"items, busy share {dev_us * 1e-6 / host_s:.3f}; {card}")
    for name, times in split.items():
        us, n = work.get(name, (0.0, 0))
        h = sum(times)
        print(f"    {name}: host {h * 1e3:.3f} ms ({len(times)} runs), device "
              f"{us / 1e3:.3f} ms, {n} work items; busy share {us * 1e-6 / max(h, 1e-9):.3f}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=64)
    ap.add_argument("--spread", action="store_true",
                    help="run only mapping_spread: the mapping path's keyframe "
                         "centre error over scene seeds and scatter orders")
    ap.add_argument("--async-periods", type=float, nargs="+", metavar="SECONDS",
                    help="run only async_path, once at each pace (seconds "
                         "between frames)")
    ap.add_argument("--capacity", nargs="+", metavar="K,P,SWEEP,LEGS",
                    help="run only capacity_path, once per map size (keyframes, "
                         "points) and sweep (frames per leg, legs) given")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_paths needs a CUDA device; none is visible")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(f"device: {card}")

    if args.spread:
        mapping_spread(card, args.frames)
        return
    if args.async_periods:
        scene = loop_scene()
        # warm-up: the kernels built and the libraries loaded, as in
        # chip_smoke.py's phase 16, which runs after phase 14
        _, frames = loop_frames(scene, torch.device("cuda", 0))
        loop_system(scene, torch.device("cuda", 0)).process_batch(frames[:24])
        for period in args.async_periods:
            r = async_path(scene, torch.device("cuda", 0), period=period)
            r["system"].close()
            print(f"async path: {async_summary(r)}; {card}", flush=True)
        return
    if args.capacity:
        scene, dev = loop_scene(), torch.device("cuda", 0)
        for spec in args.capacity:
            K, P, sweep, legs = (int(v) for v in spec.split(","))
            r = capacity_path(scene, dev, capacity_system(scene, dev, K, P),
                              capacity_poses(sweep, legs))
            print(f"capacity path (max_keyframes {K}, max_points {P}, "
                  f"{legs} legs of {sweep} frames): {capacity_summary(r)}; "
                  f"failures {capacity_failures(r)}; {card}", flush=True)
        return
    dev = torch.device("cuda", 0)
    W, H, N = 640, 480, args.frames
    scene = SyntheticScene(n_points=800, width=W, height=H)
    render = lambda ps: torch.from_numpy(
        np.stack([scene.render_image(p) for p in ps])).to(dev)
    poses = lateral_trajectory(N + 1, step=0.01)
    frames = render(poses)
    m_poses = lateral_trajectory(N + 2, step=MAPPING_STEP, yaw_rate=MAPPING_YAW)
    m_frames = render(m_poses)
    K = torch.from_numpy(scene.K).to(dev)
    camera = scene.camera_model()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "harris.yaml")
        with open(path, "w") as f:
            f.write(settings_text(camera, ORBConfig(score_harris=True)))
        h_cam, h_orb, _ = slam_config_from_settings(path)
    paths = {"FAST": (ORBConfig(), camera), "Harris": (h_orb, h_cam)}

    for name in ("FAST", "Harris", "mapping", "mapping", "Harris", "FAST"):
        if name == "mapping":
            profile_mapping(scene, m_poses, m_frames, N, card)
        else:
            profile_tracking(name, *paths[name], scene, poses, frames, K, N, card)
    profile_loop(card, dev)
    for P in (2048, 16384):
        split = ba_stage_split(dev, P)
        print(f"BA solver step at P={P}, O=32, Kl=80 (CUDA-event medians, "
              f"{card}): " + ", ".join(f"{k} {v:.3f} ms" for k, v in split.items()))


if __name__ == "__main__":
    main()
