"""The frozen scene renders the bits of the program's io/synthetic.py."""

import numpy as np
import pytest

from orb_slam_tpu_torch.io import synthetic as port
from slam_bench import scene as frozen


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_frozen_scene_matches_the_programs(seed):
    kw = dict(n_points=800, seed=seed)
    a, b = frozen.SyntheticScene(**kw), port.SyntheticScene(**kw)
    assert np.array_equal(a.points, b.points)
    assert np.array_equal(a.descriptors, b.descriptors)
    assert np.array_equal(a.K, b.K)
    poses = frozen.lateral_trajectory(6, step=0.08, yaw_rate=0.01)
    assert np.array_equal(poses, port.lateral_trajectory(6, step=0.08, yaw_rate=0.01))
    for T in poses[::5]:
        assert np.array_equal(a.render_image(T), b.render_image(T))
        xy = np.stack(np.meshgrid(np.arange(0, 640, 7), np.arange(0, 480, 11)), -1)
        xy = xy.reshape(-1, 2)
        assert np.array_equal(a.billboard_depth(T, xy), b.billboard_depth(T, xy),
                              equal_nan=True)


def test_a_large_seed_draws_a_scene():
    s = frozen.SyntheticScene(n_points=10, seed=2 ** 31 + 12345)
    assert s.points.shape == (10, 3)


def test_the_index_map_shows_the_squares_the_depth_lookup_sees():
    s = frozen.SyntheticScene(n_points=800, seed=1)
    T = frozen.lateral_trajectory(3, step=0.08, yaw_rate=0.01)[2]
    ids = s.billboard_index(T)
    xy = np.stack(np.meshgrid(np.arange(0, 640, 3), np.arange(0, 480, 5)), -1).reshape(-1, 2)
    depth = s.billboard_depth(T, xy)
    hit = ids[xy[:, 1], xy[:, 0]]
    assert np.array_equal(hit >= 0, np.isfinite(depth))
    R, t = T[:3, :3], T[:3, 3]
    z = (s.points @ R.T + t)[:, 2]
    assert np.allclose(z[hit[hit >= 0]], depth[hit >= 0])


def test_a_swinging_yaw_stays_bounded_and_starts_where_asked():
    poses = frozen.lateral_trajectory(400, step=0.08, yaw_rate=0.01, start_x=-7.8,
                                      yaw_period=128)
    yaw = np.arctan2(poses[:, 0, 2], poses[:, 0, 0])
    assert np.abs(yaw).max() == pytest.approx(0.01 * 128 / (2 * np.pi), rel=1e-3)
    assert np.abs(np.diff(yaw)).max() <= 0.01 + 1e-6
    centre = -poses[0, :3, :3].T @ poses[0, :3, 3]
    assert centre[0] == pytest.approx(-7.8)
