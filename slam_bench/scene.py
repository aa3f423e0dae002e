"""The benchmark's scene and trajectories, frozen.

A copy of `SyntheticScene` (the point cloud, its random descriptors,
`_project_px`, `_squares`, `render_image` and `billboard_depth`) and of
`lateral_trajectory` from orb_slam_tpu_torch/io/synthetic.py, in numpy, so
that the inputs the benchmark feeds the program stay the same whatever a
later change does to the program's own generator. The point cloud is drawn
from the rng in the same order, so a seed gives the same bits as there
(slam_bench/tests/test_bench_scene.py). The ring layout, the oracle
features and the photometric options are left out; the harness adds the
sensor noise on the card. Added here: `billboard_index`, the square under
each pixel (the ground truth of which scene point a feature shows), a
cache of each square's base texture that leaves the bits as they are,
two trajectory options
for sequences longer than the program's own paths, a street layout
(`layout="street"`: two facades and a road) beside the box the program
draws, the squares' size as a field (`patch`, the program's 5 by
default), and `forward_trajectory`, a camera that drives along its
optical axis. The box and `lateral_trajectory` at their defaults are the
program's bits.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


STREET_KEYS = ("half_width", "facade_depth", "facade_height", "camera_height",
               "road_share", "z_range")


def street_points(rng, n, *, half_width, facade_depth, facade_height,
                  camera_height, road_share, z_range):
    """[n, 3] f32 points along a street that runs along world z, y pointing
    down: a share `road_share` on the road, the plane y = camera_height at
    |x| < half_width, the others on a facade at |x| in [half_width,
    half_width + facade_depth], y in [camera_height - facade_height,
    camera_height], its side drawn at random; z in `z_range` for both."""
    on_road = rng.uniform(0.0, 1.0, n) < road_share
    side = np.where(rng.uniform(0.0, 1.0, n) < 0.5, -1.0, 1.0)
    x_facade = side * rng.uniform(half_width, half_width + facade_depth, n)
    y_facade = rng.uniform(camera_height - facade_height, camera_height, n)
    x_road = rng.uniform(-half_width, half_width, n)
    z = rng.uniform(*z_range, n)
    return np.stack([np.where(on_road, x_road, x_facade),
                     np.where(on_road, camera_height, y_facade), z],
                    1).astype(np.float32)


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
    extent: tuple = None        # box: (8.0, 5.0, 4.0)
    depth_range: tuple = None   # box: (4.0, 12.0)
    dist: tuple = (0.0, 0.0, 0.0, 0.0)
    # a square's half size: max(3, round(6 patch / z)) pixels at depth z m
    patch: float = 5
    layout: str = "box"
    # street (layout="street"), all in metres but the share
    half_width: float = None
    facade_depth: float = None
    facade_height: float = None
    camera_height: float = None
    road_share: float = None
    z_range: tuple = None

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        street = {k: getattr(self, k) for k in STREET_KEYS}
        if self.layout == "box":
            if any(v is not None for v in street.values()):
                raise ValueError("a box scene takes no street keys")
            self.extent = (8.0, 5.0, 4.0) if self.extent is None else self.extent
            self.depth_range = ((4.0, 12.0) if self.depth_range is None
                                else self.depth_range)
            self.points = np.stack([
                rng.uniform(-self.extent[0], self.extent[0], self.n_points),
                rng.uniform(-self.extent[1], self.extent[1], self.n_points),
                rng.uniform(*self.depth_range, self.n_points)], 1).astype(np.float32)
        elif self.layout == "street":
            if self.extent is not None or self.depth_range is not None:
                raise ValueError("a street scene reads no extent or depth_range")
            missing = [k for k, v in street.items() if v is None]
            if missing:
                raise ValueError(f"a street scene needs {missing}")
            self.points = street_points(rng, self.n_points, **street)
        else:
            raise ValueError(f"unknown scene layout {self.layout!r}")
        self.descriptors = rng.integers(0, 2 ** 32, (self.n_points, 8),
                                        dtype=np.uint32)

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

    def _squares(self, T_cw):
        """(index, depth, x0, y0, half size) arrays of every square
        render_image paints, far first (painter's order)."""
        R, t = T_cw[:3, :3], T_cw[:3, 3]
        pc = self.points @ R.T + t
        z = pc[:, 2]
        uv = self._project_px(pc)
        order = np.argsort(-z)
        order = order[z[order] >= 0.5]
        zi = z[order]
        s = np.maximum(3, np.round(self.patch * 6.0 / zi).astype(np.int64))
        x0 = np.round(uv[order, 0]).astype(np.int64) - s
        y0 = np.round(uv[order, 1]).astype(np.int64) - s
        return order, zi, x0, y0, s

    def _texture(self, i, s):
        """The painted texture of square i at half size s: its 4x4 base
        (cached) with each texel repeated s // 2 times each way, the bits
        of the program's np.kron with ones. Only the bases are cached: a
        square the camera nears takes a new size every frame."""
        bases = self.__dict__.setdefault("_bases", {})
        if i not in bases:
            rng_i = np.random.default_rng(1000 + int(i))
            bases[i] = rng_i.uniform(80, 255, (4, 4)).astype(np.float32)
        k = max(1, s // 2)
        return np.repeat(np.repeat(bases[i], k, 0), k, 1)[:2 * s, :2 * s]

    def _in_view(self, sq):
        """The squares of `sq` that reach into the image, in their order."""
        order, zi, x0, y0, s = sq
        keep = ~((x0 + 2 * s < 0) | (y0 + 2 * s < 0) | (x0 >= self.width)
                 | (y0 >= self.height))
        return order[keep], zi[keep], x0[keep], y0[keep], s[keep]

    def render_image(self, T_cw):
        """Textured square billboards on a textured background, blurred
        by a 3-tap binomial filter: float32 [height, width] in [0, 255]."""
        rng_local = np.random.default_rng(123)
        img = rng_local.uniform(30, 60, (self.height, self.width)).astype(
            np.float32)
        for i, _, x0, y0, s in zip(*self._in_view(self._squares(T_cw))):
            x0, y0, s = int(x0), int(y0), int(s)
            tex = self._texture(i, s)
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
        return np.clip(img, 0.0, 255.0).astype(np.float32)

    def billboard_index(self, T_cw):
        """[height, width] int32: the index of the front-most square
        render_image paints at each pixel, -1 on background."""
        out = np.full((self.height, self.width), -1, np.int32)
        for i, _, x0, y0, s in zip(*self._in_view(self._squares(T_cw))):
            ext = min(4 * max(1, int(s) // 2), 2 * int(s))
            out[max(0, y0):max(0, y0 + ext), max(0, x0):max(0, x0 + ext)] = i
        return out

    def billboard_depth(self, T_cw, xy):
        """Depth of the front-most square render_image paints under each
        pixel xy [n, 2] inside the image (rounded to the pixel grid); NaN
        on background. A square out of view covers no such pixel."""
        px = np.round(np.asarray(xy, np.float64)).astype(np.int64)
        depth = np.full(len(px), np.nan, np.float32)
        for _, z, x0, y0, s in zip(*self._in_view(self._squares(T_cw))):
            n = 4 * max(1, s // 2)          # painted texture extent
            ext = min(n, 2 * s)
            inside = ((px[:, 0] >= x0) & (px[:, 0] < x0 + ext)
                      & (px[:, 1] >= y0) & (px[:, 1] < y0 + ext))
            depth[inside] = z               # nearer squares paint later
        return depth


def lateral_trajectory(n_frames, step=0.08, yaw_rate=0.0, start_x=0.0,
                       yaw_period=0):
    """World->camera poses [n, 4, 4] f32 for a sideways-translating camera.
    The camera starts at x = `start_x` and moves `step` per frame; the yaw
    grows by `yaw_rate` per frame, or with `yaw_period` frames swings as a
    sine whose steepest rate is `yaw_rate`, so that a sequence longer than
    the program's own paths keeps facing the scene (both additions leave
    the program's path as it is at their defaults)."""
    poses = []
    for i in range(n_frames):
        if yaw_period:
            yaw = yaw_rate * yaw_period / (2 * np.pi) * np.sin(
                2 * np.pi * i / yaw_period)
        else:
            yaw = yaw_rate * i
        R = np.array([[np.cos(yaw), 0, np.sin(yaw)], [0, 1, 0],
                      [-np.sin(yaw), 0, np.cos(yaw)]], np.float32)
        C = np.array([start_x + step * i, 0.02 * np.sin(i * 0.3), 0.0],
                     np.float32)
        T = np.eye(4, dtype=np.float32)
        T[:3, :3] = R
        T[:3, 3] = -R @ C
        poses.append(T)
    return np.stack(poses)


def forward_trajectory(n_frames, step=0.8, yaw_rate=0.0, yaw_period=0,
                       start_x=0.0, start_z=0.0):
    """World->camera poses [n, 4, 4] f32 for a camera that drives forward.
    The yaw follows `lateral_trajectory`'s rule (yaw 0 looks along world
    +z), the centre starts at (start_x, 0, start_z) and moves `step` from
    frame i to i + 1 along frame i's optical axis, and bobs by
    0.02 sin(0.3 i) in y."""
    poses = []
    ground = np.array([start_x, 0.0, start_z], np.float64)
    for i in range(n_frames):
        if yaw_period:
            yaw = yaw_rate * yaw_period / (2 * np.pi) * np.sin(
                2 * np.pi * i / yaw_period)
        else:
            yaw = yaw_rate * i
        R = np.array([[np.cos(yaw), 0, np.sin(yaw)], [0, 1, 0],
                      [-np.sin(yaw), 0, np.cos(yaw)]])
        C = ground + [0.0, 0.02 * np.sin(i * 0.3), 0.0]
        T = np.eye(4, dtype=np.float32)
        T[:3, :3] = R
        T[:3, 3] = -R @ C
        poses.append(T)
        ground = ground + step * R[2]
    return np.stack(poses)


TRAJECTORIES = {"lateral": lateral_trajectory, "forward": forward_trajectory}
