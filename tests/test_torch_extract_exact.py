"""The per-level extractor (`ORBExtractor(stacked=False)`, the cv2-exact
oracle of the JAX tests) and its parts against the JAX package, 320x240.

Tolerances and why:
- `detect_fast_keypoints` (FAST and Harris ranking) and `gather_patches`:
  exact on the same input (the same f32 operations in the same order,
  exact selections);
- `gaussian_blur`: the same sums in the same order, but XLA fuses them
  (multiply-adds), so values agree to rtol 1e-6 (a few ulp) and at least
  99.9% of them round to the same integer;
- `build_pyramid`: level 0 is the image; JAX resizes with
  jax.image.resize and the port with F.interpolate, which weight the same
  two pixels but round differently; at the edge the clamped index and the
  renormalised weight give the same value. Levels >= 1 agree to 5e-4
  intensity everywhere, the edge rows and columns included (measured: at
  most 2.5e-4, level 7 included, and the edge no worse than the inside);
- `ic_angles`: the moment sums run in another order and torch's atan2 is
  not XLA's: 1e-6 rad (measured: 2.4e-7);
- `rbrief_descriptors` fed the same angles: cos/sin may differ in the last
  ulp and flip a rotated offset that rounds at .5, so at least 99% of
  the descriptors are bit-equal and none differs in more than 8 bits
  (measured: all equal);
- the whole `_extract`: level 0 is exact but for the angle (1e-6 rad) and
  the descriptors (99% bit-equal); levels >= 1 see the pyramid's last
  bits, so at least 98% of their keypoints are identical (measured: 100%
  of keypoints and descriptors, FAST and Harris, on all three images).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam_tpu.frontend.orb_extractor import ORBConfig as JaxConfig
from orb_slam_tpu.frontend.orb_extractor import _extract
from orb_slam_tpu.io.synthetic import SyntheticScene, lateral_trajectory
from orb_slam_tpu.ops import fast as jfast
from orb_slam_tpu.ops import image as jimage
from orb_slam_tpu.ops import orb_descriptor as jod
from orb_slam_tpu_torch.frontend.orb_extractor import ORBConfig, ORBExtractor
from orb_slam_tpu_torch.ops import fast as tfast
from orb_slam_tpu_torch.ops import image as timage
from orb_slam_tpu_torch.ops import orb_descriptor as tod

W, H, NF, L = 320, 240, 300, 4


def image(kind):
    if kind == "textured":
        rng = np.random.default_rng(5)
        img = rng.uniform(30, 70, (H, W)).astype(np.float32)
        for _ in range(150):
            y, x = rng.integers(8, H - 8), rng.integers(8, W - 8)
            s = int(rng.integers(2, 7))
            img[y - s:y + s, x - s:x + s] = float(rng.uniform(100, 255))
        return img
    scene = SyntheticScene(n_points=400, width=W, height=H, fx=250.0, fy=250.0,
                           cx=160.0, cy=120.0)
    return scene.render_image(lateral_trajectory(3, step=0.05)[2],
                              quantize=kind == "quantized")


KINDS = ["rendered", "quantized", "textured"]


@pytest.mark.parametrize("kind", KINDS)
def test_build_pyramid_matches_jax(kind):
    img = image(kind)
    want = jimage.build_pyramid(jnp.asarray(img), 8, 1.2)
    got = timage.build_pyramid(torch.from_numpy(img), 8, 1.2)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    for g, w in zip(got[1:], want[1:]):
        g, w = g.numpy(), np.asarray(w)
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=0, atol=5e-4)
        for edge in (np.s_[0], np.s_[-1], np.s_[:, 0], np.s_[:, -1]):
            np.testing.assert_allclose(g[edge], w[edge], rtol=0, atol=5e-4)


@pytest.mark.parametrize("kind", KINDS)
def test_gaussian_blur_matches_jax(kind):
    img = image(kind)
    got = timage.gaussian_blur(torch.from_numpy(img)).numpy()
    want = np.asarray(jimage.gaussian_blur(jnp.asarray(img)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    assert np.mean(np.round(got) == np.round(want)) >= 0.999


def level_keypoints(img, use_harris=False, quota=120):
    xy, s, v = jfast.detect_fast_keypoints(jnp.asarray(img), quota,
                                           use_harris=use_harris,
                                           aspect_ratio=W / H)
    return np.array(xy), np.array(s), np.array(v)


@pytest.mark.parametrize("use_harris", [False, True])
@pytest.mark.parametrize("kind", KINDS)
def test_detect_fast_keypoints_matches_jax(kind, use_harris):
    img = image(kind)
    for level, quota in ((img, 120), (np.array(jimage.build_pyramid(
            jnp.asarray(img), 3, 1.2)[2]), 60)):
        want = level_keypoints(level, use_harris, quota)
        got = tfast.detect_fast_keypoints(torch.from_numpy(level), quota,
                                          use_harris=use_harris,
                                          aspect_ratio=W / H)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), w)


@pytest.mark.parametrize("kind", KINDS)
def test_ic_angles_and_rbrief_match_jax(kind):
    img = image(kind)
    blurred = np.array(jnp.round(jimage.gaussian_blur(jnp.asarray(img))))
    xy, _, _ = level_keypoints(img)
    xy_t = torch.from_numpy(xy)
    np.testing.assert_array_equal(
        tod.gather_patches(torch.from_numpy(img), xy_t, 31).numpy(),
        np.asarray(jod.gather_patches(jnp.asarray(img), jnp.asarray(xy), 31)))
    ang_j = np.array(jod.ic_angles(jnp.asarray(img), jnp.asarray(xy)))
    ang_t = tod.ic_angles(torch.from_numpy(img), xy_t).numpy()
    np.testing.assert_allclose(ang_t, ang_j, rtol=0, atol=1e-6)
    dj = np.asarray(jod.rbrief_descriptors(jnp.asarray(blurred), jnp.asarray(xy),
                                           jnp.asarray(ang_j)))
    dt = tod.rbrief_descriptors(torch.from_numpy(blurred), xy_t,
                                torch.from_numpy(ang_j)).numpy()
    same = np.all(dt == dj, 1)
    assert same.mean() >= 0.99, same.mean()
    bits = np.unpackbits(dt ^ dj, axis=1).sum(1)
    assert bits.max() <= 8, bits.max()


@pytest.mark.parametrize("harris", [False, True])
@pytest.mark.parametrize("kind", KINDS)
def test_per_level_extractor_matches_jax(kind, harris):
    img = image(kind)
    jc = JaxConfig(n_features=NF, n_levels=L, score_harris=harris)
    fj = jax.jit(lambda im: _extract(im, config=jc))(jnp.asarray(img))
    ex = ORBExtractor(ORBConfig(n_features=NF, n_levels=L, score_harris=harris),
                      H, W, stacked=False, device="cpu")
    ft = ex(torch.from_numpy(img))
    octave = np.asarray(fj.octave)
    np.testing.assert_array_equal(ft.octave.numpy(), octave)
    l0 = octave == 0
    xy_j, xy_t = np.asarray(fj.xy), ft.xy.numpy()
    np.testing.assert_array_equal(xy_t[l0], xy_j[l0])
    np.testing.assert_array_equal(ft.response.numpy()[l0],
                                  np.asarray(fj.response)[l0])
    np.testing.assert_array_equal(ft.valid.numpy()[l0], np.asarray(fj.valid)[l0])
    np.testing.assert_allclose(ft.angle.numpy()[l0], np.asarray(fj.angle)[l0],
                               rtol=0, atol=1e-6)
    desc_j = np.asarray(fj.desc_u32).view(np.int32)
    same_desc = np.all(ft.desc_i32.numpy()[l0] == desc_j[l0], 1)
    assert same_desc.mean() >= 0.99, same_desc.mean()
    up = ~l0
    same = np.all(xy_t[up] == xy_j[up], 1) & (ft.valid.numpy()[up]
                                              == np.asarray(fj.valid)[up])
    assert same.mean() >= 0.98, same.mean()
    assert int(ft.valid.sum()) > 0.8 * NF
