"""Synthetic scene in numpy: ground-truth points, poses and rendered images.

Port of orb_slam_tpu/io/synthetic.py: `SyntheticScene` (:21-244: the
point cloud, `K` and `render_image`; the ring layout is not ported) and
`lateral_trajectory` (:257-267),
without JAX, so a script on a machine without JAX has an image source.
Added here: `billboard_depth`, the depth of the front-most rendered
square under each pixel, `seed_map`, which builds the map the port's
main path tracks against (chip_smoke.py and tests/test_torch_slice.py),
and `seed_keyframe_map`, a map as the two-view initialisation leaves it
(two keyframes and the points both see), from which the port's SLAMSystem
tracks and maps.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from orb_slam_tpu_torch.device import require_device
from orb_slam_tpu_torch.geometry.camera import CameraModel, undistort_points
from orb_slam_tpu_torch.slam_map.map_state import (
    MapConfig, MapState, add_points, empty_map, insert_keyframe,
)


@dataclass
class SyntheticScene:
    n_points: int = 600
    width: int = 640
    height: int = 480
    fx: float = 500.0
    fy: float = 500.0
    cx: float = 320.0
    cy: float = 240.0
    seed: int = 0
    extent: tuple = (8.0, 5.0, 4.0)
    depth_range: tuple = (4.0, 12.0)
    dist: tuple = (0.0, 0.0, 0.0, 0.0)

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        self.points = np.stack([
            rng.uniform(-self.extent[0], self.extent[0], self.n_points),
            rng.uniform(-self.extent[1], self.extent[1], self.n_points),
            rng.uniform(*self.depth_range, self.n_points)],
            1).astype(np.float32)
        self.descriptors = rng.integers(0, 2 ** 32, (self.n_points, 8),
                                        dtype=np.uint32)
        self.rng = rng

    @property
    def K(self):
        return np.array([[self.fx, 0, self.cx], [0, self.fy, self.cy],
                         [0, 0, 1]], np.float32)

    def _project_px(self, pc):
        """Camera-frame points [N, 3] -> distorted pixel coordinates."""
        z = np.maximum(pc[:, 2], 1e-6)
        x = pc[:, 0] / z
        y = pc[:, 1] / z
        k1, k2, p1, p2 = self.dist
        if any(c != 0.0 for c in self.dist):
            r2 = x * x + y * y
            radial = 1.0 + k1 * r2 + k2 * r2 * r2
            xd = x * radial + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
            yd = y * radial + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
            x, y = xd, yd
        return np.stack([self.fx * x + self.cx, self.fy * y + self.cy], 1)

    def _squares(self, T_cw, patch):
        """(index, depth, x0, y0, half size) of every square render_image
        paints, far first (painter's order)."""
        R, t = T_cw[:3, :3], T_cw[:3, 3]
        pc = self.points @ R.T + t
        z = pc[:, 2]
        uv = self._project_px(pc)
        for i in np.argsort(-z):
            if z[i] < 0.5:
                continue
            u, v = uv[i]
            s = max(3, int(round(patch * 6.0 / z[i])))
            yield i, z[i], int(round(u)) - s, int(round(v)) - s, s

    def render_image(self, T_cw, patch=5, exposure=1.0, bias=0.0,
                     vignette=0.0, noise=0.0, quantize=False,
                     photo_seed=None):
        """Textured square billboards on a textured background; the
        photometric options are those of the JAX version."""
        rng_local = np.random.default_rng(123)
        img = rng_local.uniform(30, 60, (self.height, self.width)).astype(
            np.float32)
        for i, _, x0, y0, s in self._squares(T_cw, patch):
            x1, y1 = x0 + 2 * s, y0 + 2 * s
            if x1 < 0 or y1 < 0 or x0 >= self.width or y0 >= self.height:
                continue
            rng_i = np.random.default_rng(1000 + i)
            base = rng_i.uniform(80, 255, (4, 4)).astype(np.float32)
            tex = np.kron(base, np.ones((max(1, s // 2), max(1, s // 2)),
                                        np.float32))[:2 * s, :2 * s]
            th, tw = tex.shape
            ys0, xs0 = max(0, y0), max(0, x0)
            ys1 = min(self.height, y0 + th)
            xs1 = min(self.width, x0 + tw)
            if ys1 <= ys0 or xs1 <= xs0:
                continue
            img[ys0:ys1, xs0:xs1] = tex[ys0 - y0:ys1 - y0, xs0 - x0:xs1 - x0]
        k = np.array([0.25, 0.5, 0.25], np.float32)
        p = np.pad(img, ((1, 1), (0, 0)), mode="edge")
        img = k[0] * p[:-2] + k[1] * p[1:-1] + k[2] * p[2:]
        p = np.pad(img, ((0, 0), (1, 1)), mode="edge")
        img = k[0] * p[:, :-2] + k[1] * p[:, 1:-1] + k[2] * p[:, 2:]
        if vignette:
            yy = (np.arange(self.height, dtype=np.float32)
                  - self.cy)[:, None] / self.fy
            xx = (np.arange(self.width, dtype=np.float32)
                  - self.cx)[None, :] / self.fx
            r2 = xx * xx + yy * yy
            r2 = r2 / max(float(r2.max()), 1e-9)
            img = img * (1.0 - vignette * r2)
        if exposure != 1.0 or bias != 0.0:
            img = img * exposure + bias
        if noise:
            nrng = np.random.default_rng(
                photo_seed if photo_seed is not None else 7)
            img = img + nrng.normal(0.0, noise, img.shape)
        img = np.clip(img, 0.0, 255.0)
        if quantize:
            img = np.round(img)
        return img.astype(np.float32)

    def billboard_depth(self, T_cw, xy, patch=5):
        """Depth of the front-most square render_image paints under each
        pixel xy [n, 2] (rounded to the pixel grid); NaN on background."""
        px = np.round(np.asarray(xy, np.float64)).astype(np.int64)
        depth = np.full(len(px), np.nan, np.float32)
        for _, z, x0, y0, s in self._squares(T_cw, patch):
            n = 4 * max(1, s // 2)          # painted texture extent
            ext = min(n, 2 * s)
            inside = ((px[:, 0] >= x0) & (px[:, 0] < x0 + ext)
                      & (px[:, 1] >= y0) & (px[:, 1] < y0 + ext))
            depth[inside] = z               # nearer squares paint later
        return depth


def lateral_trajectory(n_frames, step=0.08, yaw_rate=0.0):
    """World->camera poses [n, 4, 4] f32 for a sideways-translating camera."""
    poses = []
    for i in range(n_frames):
        yaw = yaw_rate * i
        R = np.array([[np.cos(yaw), 0, np.sin(yaw)], [0, 1, 0],
                      [-np.sin(yaw), 0, np.cos(yaw)]], np.float32)
        C = np.array([step * i, 0.02 * np.sin(i * 0.3), 0.0], np.float32)
        T = np.eye(4, dtype=np.float32)
        T[:3, :3] = R
        T[:3, 3] = -R @ C
        poses.append(T)
    return np.stack(poses)


def seed_map(scene: SyntheticScene, T_cw, xy, desc_i32, octave, valid,
             cfg: MapConfig, device="cuda", n_extra: int = 2000,
             seed: int = 0) -> MapState:
    """The map the main path tracks against, built from one extracted frame.

    Every valid keypoint (xy [N, 2] raw level-0 pixels, desc_i32 [N, 8],
    octave [N], valid [N]; numpy or tensors) that lies on a rendered
    square is undistorted and back-projected at that square's depth
    through pose T_cw and
    keeps its descriptor; its distance band and normal follow
    MapPoint::UpdateNormalAndDepth (src/MapPoint.cc:313-360). Then
    `n_extra` scene points jittered by 1 cm with random descriptors fill
    the following slots, as bench.py:69-86 builds its map, so the frustum
    gate and the candidate pool see bench-sized traffic. Keypoints on the
    background are left out: it does not move with the camera. The map is
    built on `device`, the card unless the caller names another."""
    device = require_device(device)
    xy, desc, octave, valid = (np.asarray(torch.as_tensor(v).cpu())
                               for v in (xy, desc_i32, octave, valid))
    T_cw = np.asarray(T_cw, np.float32)
    z = scene.billboard_depth(T_cw, xy)
    keep = valid & np.isfinite(z)
    camera = CameraModel(scene.fx, scene.fy, scene.cx, scene.cy, *scene.dist,
                         width=scene.width, height=scene.height)
    und = undistort_points(camera, torch.from_numpy(xy)).numpy()
    pc = np.stack([(und[:, 0] - scene.cx) / scene.fx * z,
                   (und[:, 1] - scene.cy) / scene.fy * z, z], 1)[keep]
    R, t = T_cw[:3, :3], T_cw[:3, 3]
    pw = ((pc - t) @ R).astype(np.float32)           # R^T (pc - t)
    center = -R.T @ t
    ray = pw - center
    dist = np.linalg.norm(ray, axis=1)
    level_scale = cfg.scale_factor ** octave[keep].astype(np.float64)
    max_dist = (dist * level_scale).astype(np.float32)
    min_dist = (max_dist / cfg.scale_factor ** (cfg.n_levels - 1)).astype(
        np.float32)
    normal = (ray / dist[:, None]).astype(np.float32)

    rng = np.random.default_rng(seed)
    extra = scene.points[rng.integers(0, scene.n_points, n_extra)] + rng.normal(
        0, 0.01, (n_extra, 3)).astype(np.float32)
    extra_desc = rng.integers(0, 2 ** 32, (n_extra, 8),
                              dtype=np.uint32).view(np.int32)
    n_kp = int(keep.sum())
    pos = np.concatenate([pw, extra]).astype(np.float32)
    n = len(pos)
    if n > cfg.max_points:
        raise ValueError(f"{n} seed points exceed max_points={cfg.max_points}")
    state = empty_map(cfg, device)
    state = add_points(state, torch.arange(n), torch.from_numpy(pos),
                       torch.from_numpy(np.concatenate([desc[keep], extra_desc])),
                       torch.zeros(n, dtype=torch.int32),
                       torch.zeros(n, dtype=torch.int32),
                       torch.ones(n, dtype=torch.bool))
    as_t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    pt_max = np.full(cfg.max_points, 30.0, np.float32)
    pt_min = np.zeros(cfg.max_points, np.float32)
    pt_normal = np.tile(np.float32([0.0, 0.0, 1.0]), (cfg.max_points, 1))
    pt_max[:n_kp], pt_min[:n_kp], pt_normal[:n_kp] = max_dist, min_dist, normal
    return state.replace(pt_max_dist=as_t(pt_max), pt_min_dist=as_t(pt_min),
                         pt_normal=as_t(pt_normal))


def seed_keyframe_map(scene: SyntheticScene, poses, features, K,
                      cfg: MapConfig, device="cuda", p_local: int = 4096):
    """A map as the two-view initialisation leaves it: frames 0 and 1 as
    keyframes 0 and 1, and points seen by both, from which a SLAMSystem
    tracks and maps.

    poses: the two frames' T_cw [2, 4, 4]; features: their ORBFeatures
    (raw keypoints, descriptors, octave, angle, validity); K [3, 3]. The
    points are seed_map's with no extra points: every valid keypoint of
    frame 0 on a rendered square, at that square's depth, with its
    descriptor, bound to its feature of keyframe 0. Frame 1 is tracked
    against them from its pose (track_frame); its optimized pose and
    inlier bindings make keyframe 1, whose spanning parent is keyframe 0.
    The point statistics are then refreshed from both observations.
    Returns (state, the number of points, keyframe 1's inliers)."""
    from orb_slam_tpu_torch.pipeline.track_kernels import track_frame
    from orb_slam_tpu_torch.slam_map.observations import refresh_point_stats

    device = require_device(device)
    camera = CameraModel(scene.fx, scene.fy, scene.cx, scene.cy, *scene.dist,
                         width=scene.width, height=scene.height)
    host = [{k: np.asarray(torch.as_tensor(getattr(f, k)).cpu())
             for k in ("xy", "desc_i32", "octave", "angle", "valid")}
            for f in features]
    T0 = np.asarray(poses[0], np.float32)
    f0 = host[0]
    state = seed_map(scene, T0, f0["xy"], f0["desc_i32"], f0["octave"],
                     f0["valid"], cfg, device=device, n_extra=0)
    keep = f0["valid"] & np.isfinite(scene.billboard_depth(T0, f0["xy"]))
    n = int(keep.sum())
    obs0 = np.full(len(keep), -1, np.int32)
    obs0[keep] = np.arange(n, dtype=np.int32)
    as_t = lambda a: torch.as_tensor(a).to(device)
    und = [undistort_points(camera, as_t(f["xy"])) for f in host]
    K = as_t(np.asarray(K, np.float32))

    def keyframe(state, slot, pose, f, xy, obs, parent):
        return insert_keyframe(state, slot, pose, slot, xy, as_t(f["octave"]),
                               as_t(f["angle"]), as_t(f["desc_i32"]),
                               as_t(f["valid"]), obs, parent)

    state = keyframe(state, 0, as_t(T0), f0, und[0], as_t(obs0), -1)
    f1 = host[1]
    res = track_frame(state, und[1], as_t(f1["desc_i32"]), as_t(f1["octave"]),
                      as_t(f1["valid"]), as_t(np.asarray(poses[1], np.float32)),
                      K, p_local=min(p_local, cfg.max_points),
                      width=scene.width,
                      height=scene.height, scale_factor=cfg.scale_factor,
                      n_levels=cfg.n_levels)
    state = keyframe(state, 1, res.pose, f1, und[1], res.obs, 0)
    state = refresh_point_stats(state, cfg.scale_factor, cfg.n_levels)
    return state, n, int(res.n_inliers)
