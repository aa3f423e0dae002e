"""The port's whole `_extract_stacked` against the JAX one (XLA detector,
the reference on the CPU) on the same image, 320x240, 300 features, 4
levels.

Tolerances and why:
- level 0: xy, response, valid, octave and descriptors are bit-equal (the
  canvas is the image itself and every step after it is exact); angles
  agree to 1e-6 rad, since torch's and XLA's atan2 differ in the last ulp;
- levels >= 1: the pyramid's f32 sums run in another order and can flip a
  rare bf16 rounding, so responses agree to rtol 1e-5 and at least 98% of
  the keypoints and descriptors must be identical (measured: 100%).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam_tpu.frontend.orb_extractor import ORBConfig as JaxConfig
from orb_slam_tpu.frontend.orb_extractor import ORBExtractor as JaxExtractor
from orb_slam_tpu.frontend.orb_extractor import _extract_stacked
from orb_slam_tpu.io.synthetic import SyntheticScene, lateral_trajectory
from orb_slam_tpu.ops import descriptor_stack as jds
from orb_slam_tpu.ops import fast_stack as jfs
from orb_slam_tpu_torch.frontend.orb_extractor import ORBConfig, ORBExtractor
from orb_slam_tpu_torch.ops.descriptor_stack import angles_desc_fused, lut_sample_indices
from orb_slam_tpu_torch.ops.orb_descriptor import _WX, _WY

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


def extract_both(img):
    jc = JaxConfig(n_features=NF, n_levels=L)
    consts = JaxExtractor(jc, use_pallas=False).pyramid_consts((H, W))
    fj = jax.jit(lambda im, c: _extract_stacked(im, c, config=jc, use_pallas=False))(
        jnp.asarray(img), consts)
    ft = ORBExtractor(ORBConfig(n_features=NF, n_levels=L), H, W, device="cpu")(
        torch.from_numpy(img))
    return fj, ft


@pytest.mark.parametrize("kind", ["rendered", "quantized", "textured"])
def test_extract_stacked_matches_jax(kind):
    fj, ft = extract_both(image(kind))
    octave = np.asarray(fj.octave)
    np.testing.assert_array_equal(ft.octave.numpy(), octave)
    xy_j, xy_t = np.asarray(fj.xy), ft.xy.numpy()
    desc_j = np.asarray(fj.desc_u32).view(np.int32)
    desc_t = ft.desc_i32.numpy()
    np.testing.assert_array_equal(ft.desc_u8.numpy().reshape(-1, 8, 4)[..., 0],
                                  desc_t.astype(np.uint32) & 0xFF)
    l0 = octave == 0
    np.testing.assert_array_equal(xy_t[l0], xy_j[l0])
    np.testing.assert_array_equal(ft.response.numpy()[l0], np.asarray(fj.response)[l0])
    np.testing.assert_array_equal(ft.valid.numpy()[l0], np.asarray(fj.valid)[l0])
    np.testing.assert_array_equal(desc_t[l0], desc_j[l0])
    np.testing.assert_allclose(ft.angle.numpy(), np.asarray(fj.angle), atol=1e-6)
    up = ~l0
    same_kp = np.all(xy_t[up] == xy_j[up], 1) & (ft.valid.numpy()[up]
                                                  == np.asarray(fj.valid)[up])
    assert same_kp.mean() >= 0.98, same_kp.mean()
    same_desc = np.all(desc_t[up] == desc_j[up], 1)
    assert same_desc.mean() >= 0.98, same_desc.mean()
    np.testing.assert_allclose(ft.response.numpy()[up][same_kp],
                               np.asarray(fj.response)[up][same_kp], rtol=1e-5)
    assert int(ft.valid.sum()) > 0.8 * NF


@pytest.mark.parametrize("kind", ["rendered", "quantized"])
def test_angles_desc_fused_matches_jax(kind):
    """Same canvas and keypoints into both heads: bit-equal descriptors,
    angles to 1e-6 rad (atan2 ulp)."""
    img = image(kind)
    stack, shapes = jfs.build_pyramid_stack(jnp.asarray(img), L, 1.2)
    shapes = tuple(tuple(s) for s in shapes)
    quotas = tuple(JaxConfig(n_features=NF, n_levels=L).level_quotas())
    xy_l, _, _ = jfs.detect_keypoints_stack(stack, shapes, quotas)
    table = jnp.asarray(jds.rbrief_lut_table(30), jnp.bfloat16)
    aj, dj = jds.angles_desc_fused(stack, xy_l, shapes, table, 30, quotas=quotas)
    at, dt = angles_desc_fused(
        torch.from_numpy(np.array(stack)), torch.from_numpy(np.array(xy_l)),
        torch.tensor(shapes), torch.from_numpy(lut_sample_indices(30)),
        torch.from_numpy(_WX), torch.from_numpy(_WY), quotas=quotas)
    np.testing.assert_array_equal(dt.numpy(), np.asarray(dj))
    np.testing.assert_allclose(at.numpy(), np.asarray(aj), atol=1e-6)


def test_extractor_buffers():
    ex = ORBExtractor(ORBConfig(n_features=NF, n_levels=L), H, W, device="cpu")
    names = {n for n, _ in ex.named_buffers()}
    assert {"Rp", "Cp", "lut_idx", "wx", "wy"} <= names
    assert ex.Rp.shape == (L - 1, H, H) and ex.Cp.shape == (L - 1, W, W)
    with pytest.raises(ValueError):
        ex(torch.zeros(H + 1, W))


def test_to_grayscale_matches_jax():
    from orb_slam_tpu.ops.image import to_grayscale as jax_gray
    from orb_slam_tpu_torch.ops.image import to_grayscale

    rgb = np.random.default_rng(2).integers(0, 256, (2, 24, 32, 3)).astype(np.uint8)
    np.testing.assert_array_equal(to_grayscale(torch.from_numpy(rgb)).numpy(),
                                  np.asarray(jax_gray(rgb)))
    np.testing.assert_array_equal(to_grayscale(torch.from_numpy(rgb[0, ..., 0])).numpy(),
                                  np.asarray(jax_gray(rgb[0, ..., 0])))
