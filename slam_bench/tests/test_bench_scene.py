"""The frozen scene renders the bits of the program's io/synthetic.py; the
creep cell renders the bits it always has; the street layout and the
forward path keep to what they say."""

import hashlib
import json

import numpy as np
import pytest

from orb_slam_tpu_torch.io import synthetic as port
from slam_bench import harness
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


# SHA-256 of tum-fast.creep-batch's scene, path, frames and index map as
# harness.scene_frames builds them from the repository's files, computed
# once before the street layout and the forward path were added
CREEP_DIGESTS = {
    "points": "a72d7a3844a5086cceba81caa2fe6cce548ea2946b0d089482bc173bad0e7f4e",
    "descriptors": "547a99f975ce5e0ab3495992ce47675beed377eeb83e1c97bf9215787be514f5",
    "poses": "5ffad701baa62b1f92e2662a019c8635a620a970c29a5c5c9ddf2ba8a0ff8111",
    "frame 0": "ee59cc4118010fd653c50d36d10ae1c8d6d5dae9759015bb903260f7ae0df1da",
    "frame 1": "dfa904b3246c93df9288cdb886eb5f6d806e951f7f2aeabfacb1586286f0817b",
    "frame 2": "87c659a3b0a71e4999e236efb1428b7b348e9497bd6801cbcc690e47165ec507",
    "frame 193": "b0dbc5977fcdc0abe37046a1ded735ca6070b5e95b0b828a6d58ae5ad51f529b",
    "frame 385": "93a0d0572fb276d12ad066e0fe3353b72e0fe1f5dd04ac9ab4df121c50f30123",
    "frame 449": "ad015b4aaf1f708fa2fffd904b6b76d241565a4622b4b6e9c598fdde52dc3292",
    "index 385": "549ad003610e321f6f6d3c0f17df851c911e4f9bdac561e12cee5246e3cc1af0",
}


def digest(a):
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def test_the_creep_cell_renders_the_bits_it_always_has():
    cell = harness.Cell("tum-fast.creep-batch")
    scene, poses, frames = harness.scene_frames(cell.config, cell.traffic)
    assert frames.shape == (450, 480, 640) and poses.shape == (450, 4, 4)
    got = {"points": digest(scene.points), "descriptors": digest(scene.descriptors),
           "poses": digest(poses), "index 385": digest(scene.billboard_index(poses[385]))}
    got.update({f"frame {i}": digest(frames[i]) for i in (0, 1, 2, 193, 385, 449)})
    assert got == CREEP_DIGESTS


STREET = dict(half_width=6.0, facade_depth=3.0, facade_height=6.0, camera_height=1.65,
              road_share=0.3, z_range=(0.0, 290.0))


def street(n=4000, seed=3, **kw):
    return frozen.SyntheticScene(
        n_points=n, width=620, height=188, fx=359.4, fy=359.4, cx=303.6, cy=92.6,
        seed=seed, layout="street", **{**STREET, **kw})


def test_the_forward_path_drives_along_its_optical_axis():
    step, rate, period = 0.8, 0.004, 128
    poses = frozen.forward_trajectory(300, step=step, yaw_rate=rate, yaw_period=period,
                                      start_x=1.5, start_z=-2.0)
    R = poses[:, :3, :3].astype(np.float64)
    centre = -np.einsum("nji,nj->ni", R, poses[:, :3, 3])
    assert centre[0] == pytest.approx([1.5, 0.0, -2.0], abs=1e-5)
    bob = 0.02 * np.sin(0.3 * np.arange(300))
    assert centre[:, 1] == pytest.approx(bob, abs=1e-5)
    ground = centre - bob[:, None] * [0.0, 1.0, 0.0]
    # frame i's optical axis in the world: the third row of its rotation
    assert np.diff(ground, axis=0) == pytest.approx(step * R[:-1, 2], abs=1e-4)
    yaw = np.arctan2(poses[:, 0, 2], poses[:, 0, 0])
    assert np.abs(yaw).max() == pytest.approx(rate * period / (2 * np.pi), rel=1e-3)
    assert centre[-1, 2] > 299 * step * np.cos(np.abs(yaw).max()) - 2.0


def test_the_street_keeps_its_roadway_clear_and_its_road_share():
    s = street(n=20000)
    x, y, z = s.points.T
    hw, h = np.float32(STREET["half_width"]), np.float32(STREET["camera_height"])
    assert not ((np.abs(x) < hw) & (y < h)).any()
    on_road = np.abs(x) < hw
    assert (y[on_road] == h).all()
    facade = ~on_road
    assert (np.abs(x[facade]) <= hw + np.float32(STREET["facade_depth"])).all()
    assert (y[facade] >= h - np.float32(STREET["facade_height"])).all()
    assert ((z >= 0.0) & (z <= 290.0)).all()
    # the road's share within four standard errors of a binomial draw
    share, p = on_road.mean(), STREET["road_share"]
    assert abs(share - p) < 4 * np.sqrt(p * (1 - p) / len(x))
    # both sides of the street, about evenly
    assert abs((x[facade] > 0).mean() - 0.5) < 0.02
    assert s.descriptors.shape == (20000, 8)


def test_the_squares_grow_with_patch_and_nearness():
    T = frozen.forward_trajectory(1)[0]
    small, large = street(), street(patch=60)
    assert np.array_equal(small.points, large.points)
    _, z, _, _, s5 = small._squares(T)
    _, _, _, _, s60 = large._squares(T)
    assert (s5 == np.maximum(3, np.round(30.0 / z))).all()
    assert (s60 == np.maximum(3, np.round(360.0 / z))).all()
    assert (large.billboard_index(T) >= 0).mean() > (small.billboard_index(T) >= 0).mean()


def test_a_street_is_drawn_from_its_seed():
    a, b, c = street(seed=7), street(seed=7), street(seed=8)
    assert np.array_equal(a.points, b.points)
    assert np.array_equal(a.descriptors, b.descriptors)
    assert not np.array_equal(a.points, c.points)


@pytest.mark.parametrize("kw", [
    dict(layout="street", extent=(8.0, 5.0, 4.0), **STREET),
    dict(layout="street", depth_range=(4.0, 12.0), **STREET),
    dict(layout="street", **{k: v for k, v in STREET.items() if k != "road_share"}),
    dict(layout="box", half_width=6.0),
    dict(layout="ring"),
])
def test_a_scene_that_would_read_as_something_else_raises(kw):
    with pytest.raises(ValueError):
        frozen.SyntheticScene(n_points=10, **kw)


def test_an_unknown_path_kind_or_key_raises():
    cell = harness.Cell("tum-fast.creep-batch")
    mix = json.loads(json.dumps(cell.traffic))
    mix.update(prefix_frames=0, episode_frames=1)
    mix["trajectory"]["kind"] = "orbit"
    with pytest.raises(ValueError):
        harness.scene_frames(cell.config, mix)
    mix["trajectory"].update(kind="lateral", start_z=1.0)
    with pytest.raises(TypeError):
        harness.scene_frames(cell.config, mix)


def depth_over_every_square(scene, T_cw, xy):
    """billboard_depth as it was: every square in front of the camera."""
    px = np.round(np.asarray(xy, np.float64)).astype(np.int64)
    depth = np.full(len(px), np.nan, np.float32)
    for _, z, x0, y0, s in zip(*scene._squares(T_cw)):
        ext = min(4 * max(1, s // 2), 2 * s)
        inside = ((px[:, 0] >= x0) & (px[:, 0] < x0 + ext)
                  & (px[:, 1] >= y0) & (px[:, 1] < y0 + ext))
        depth[inside] = z
    return depth


@pytest.mark.parametrize("layout,patch", [("box", 5), ("street", 5), ("street", 60)])
def test_the_depth_lookup_skips_only_squares_out_of_view(layout, patch):
    if layout == "box":
        s = frozen.SyntheticScene(n_points=2400, extent=(24.0, 5.0, 4.0), seed=0)
        poses = frozen.lateral_trajectory(40, step=0.01, start_x=-2.25)
    else:
        s = street(patch=patch)
        poses = frozen.forward_trajectory(40, step=0.8, yaw_rate=0.004, yaw_period=128)
    # every third pixel of the image each way, its corners included
    xs = np.unique(np.r_[np.arange(0, s.width, 3), s.width - 1])
    ys = np.unique(np.r_[np.arange(0, s.height, 3), s.height - 1])
    xy = np.stack(np.meshgrid(xs, ys), -1).reshape(-1, 2)
    for T in poses[::13]:
        got = s.billboard_depth(T, xy)
        assert np.array_equal(got, depth_over_every_square(s, T, xy), equal_nan=True)
        assert np.isfinite(got).any()
        squares = s._squares(T)
        assert len(s._in_view(squares)[0]) < len(squares[0])
