"""The seeded starting state of every episode, and its snapshot.

`seed_keyframe_map` and `start_working` are frozen copies of
orb_slam_tpu_torch/io/synthetic.py::seed_keyframe_map (with the part of
`seed_map` it uses) and orb_slam_tpu_torch/profile_paths.py::start_working:
frames 0 and 1 become keyframes 0 and 1 with the points frame 0 sees,
back-projected at the rendered depth, as the two-view initialisation
leaves a system. They drive the program's own map functions; the numbers
they start from (poses, depths) are the benchmark's ground truth.

`snapshot` and `restore` extend chip_smoke.py::system_state: they copy
every attribute of a SLAMSystem except its configuration and its built
modules, so that an episode starts from the same state however many
episodes ran before it.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from orb_slam_tpu_torch.geometry.camera import undistort_points
from orb_slam_tpu_torch.pipeline import system as slam
from orb_slam_tpu_torch.pipeline.track_kernels import track_frame
from orb_slam_tpu_torch.slam_map.map_state import (
    MapState, add_points, empty_map, insert_keyframe,
)
from orb_slam_tpu_torch.slam_map.observations import refresh_point_stats

# attributes a restore leaves alone: configuration, built modules and
# constants, and the hooks the harness installs
FIXED = ("cfg", "device", "extractor", "extractor_init", "K", "K_dev",
         "img_bounds", "_stage_timer")


def _frame_points(scene, T_cw, xy, octave, valid, camera, cfg):
    """(world points, max distance, min distance, normal, kept mask) of the
    keypoints of one frame that lie on a rendered square, at its depth."""
    z = scene.billboard_depth(T_cw, xy)
    keep = valid & np.isfinite(z)
    und = undistort_points(camera, torch.from_numpy(xy)).numpy()
    pc = np.stack([(und[:, 0] - scene.cx) / scene.fx * z,
                   (und[:, 1] - scene.cy) / scene.fy * z, z], 1)[keep]
    R, t = T_cw[:3, :3], T_cw[:3, 3]
    pw = ((pc - t) @ R).astype(np.float32)
    center = -R.T @ t
    ray = pw - center
    dist = np.linalg.norm(ray, axis=1)
    level_scale = cfg.scale_factor ** octave[keep].astype(np.float64)
    max_dist = (dist * level_scale).astype(np.float32)
    min_dist = (max_dist / cfg.scale_factor ** (cfg.n_levels - 1)).astype(
        np.float32)
    normal = (ray / dist[:, None]).astype(np.float32)
    return pw, max_dist, min_dist, normal, keep


def seed_keyframe_map(scene, poses, features, camera, cfg, device,
                      p_local: int = 4096):
    """(map, number of points, keyframe 1's inliers): frames 0 and 1 as
    keyframes 0 and 1 and the points of frame 0 on a rendered square."""
    host = [{k: np.asarray(getattr(f, k).cpu())
             for k in ("xy", "desc_i32", "octave", "angle", "valid")}
            for f in features]
    T0 = np.asarray(poses[0], np.float32)
    f0 = host[0]
    pw, max_dist, min_dist, normal, keep = _frame_points(
        scene, T0, f0["xy"], f0["octave"], f0["valid"], camera, cfg)
    n = int(keep.sum())
    if n > cfg.max_points:
        raise ValueError(f"{n} seed points exceed max_points={cfg.max_points}")
    state = empty_map(cfg, device)
    state = add_points(state, torch.arange(n), torch.from_numpy(pw),
                       torch.from_numpy(f0["desc_i32"][keep]),
                       torch.zeros(n, dtype=torch.int32),
                       torch.zeros(n, dtype=torch.int32),
                       torch.ones(n, dtype=torch.bool))
    as_t = lambda a: torch.as_tensor(np.ascontiguousarray(a)).to(device)
    pt_max = np.full(cfg.max_points, 30.0, np.float32)
    pt_min = np.zeros(cfg.max_points, np.float32)
    pt_normal = np.tile(np.float32([0.0, 0.0, 1.0]), (cfg.max_points, 1))
    pt_max[:n], pt_min[:n], pt_normal[:n] = max_dist, min_dist, normal
    state = state.replace(pt_max_dist=as_t(pt_max), pt_min_dist=as_t(pt_min),
                          pt_normal=as_t(pt_normal))
    obs0 = np.full(len(keep), -1, np.int32)
    obs0[keep] = np.arange(n, dtype=np.int32)
    und = [undistort_points(camera, as_t(f["xy"])) for f in host]
    K = as_t(scene.K)

    def keyframe(state, slot, pose, f, xy, obs, parent):
        return insert_keyframe(state, slot, pose, slot, xy, as_t(f["octave"]),
                               as_t(f["angle"]), as_t(f["desc_i32"]),
                               as_t(f["valid"]), obs, parent)

    state = keyframe(state, 0, as_t(T0), f0, und[0], as_t(obs0), -1)
    f1 = host[1]
    res = track_frame(state, und[1], as_t(f1["desc_i32"]), as_t(f1["octave"]),
                      as_t(f1["valid"]), as_t(np.asarray(poses[1], np.float32)),
                      K, p_local=min(p_local, cfg.max_points),
                      width=scene.width, height=scene.height,
                      scale_factor=cfg.scale_factor, n_levels=cfg.n_levels)
    state = keyframe(state, 1, res.pose, f1, und[1], res.obs, 0)
    state = refresh_point_stats(state, cfg.scale_factor, cfg.n_levels)
    return state, n, int(res.n_inliers)


def start_working(s, scene, poses, frames) -> int:
    """Seed `s` with frames 0 and 1 as keyframes 0 and 1, ready to track
    frame 2. Returns the number of seeded points."""
    feats = [s.extractor(frames[i]) for i in (0, 1)]
    m, n, n1 = seed_keyframe_map(scene, poses[:2], feats, s.cfg.camera,
                                 s.cfg.map, s.device)
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


def _copy(v):
    if torch.is_tensor(v):
        return v.clone()
    if isinstance(v, np.ndarray):
        return v.copy()
    if isinstance(v, MapState):
        return MapState(**{f.name: getattr(v, f.name).clone()
                           for f in dataclasses.fields(v)})
    if isinstance(v, torch.Generator):
        return v.get_state()
    if isinstance(v, (list, tuple)):
        return type(v)(_copy(x) for x in v)
    if isinstance(v, dict):
        return {k: _copy(x) for k, x in v.items()}
    return v


def snapshot(s) -> dict:
    """A copy of every attribute of `s` an episode can change."""
    return {k: _copy(v) for k, v in vars(s).items() if k not in FIXED}


def restore(s, snap: dict):
    """Put `s` back into the state `snapshot` saved."""
    for k, v in snap.items():
        if isinstance(getattr(s, k, None), torch.Generator):
            getattr(s, k).set_state(v)
        else:
            setattr(s, k, _copy(v))
