"""The stacked extractor's two other descriptor variants against the JAX
package: without the LUT (`desc_lut_bins=0`: `ic_angles_batch`,
`gaussian_blur_stack`, `rbrief_batch` at continuous rotation) and with
`patch_method="rowgather"` (`ic_angles_batch`, `rbrief_batch_lut`), at
320x240, 300 features, 4 levels.

Tolerances and why, as tests/test_torch_extractor.py states them for the
LUT path:
- whole extractions: level 0 bit-equal in keypoints, responses, validity
  and descriptors; angles within 1e-6 rad (atan2's last ulp); levels >= 1
  at least 98% of keypoints and of descriptors identical (the pyramid's
  sums run in another order);
- the helpers on the same canvas, keypoints and angles: the blur within
  1e-4 (the same order of f32 sums; XLA may contract a product into an
  FMA), the rounded blur equal on >= 99.9% of pixels, angles within 1e-5
  rad (the moment sums' order), descriptors bit-equal for the LUT (an
  integer comparison) and on >= 99% of keypoints at continuous rotation
  (a rotated offset at a rounding tie may fall the other way).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam_tpu.frontend.orb_extractor import ORBConfig as JaxConfig
from orb_slam_tpu.frontend.orb_extractor import ORBExtractor as JaxExtractor
from orb_slam_tpu.frontend.orb_extractor import _extract_stacked
from orb_slam_tpu.ops import descriptor_stack as jds
from orb_slam_tpu.ops import fast_stack as jfs
from orb_slam_tpu_torch.frontend.orb_extractor import ORBConfig, ORBExtractor
from orb_slam_tpu_torch.ops import descriptor_stack as tds
from orb_slam_tpu_torch.ops.orb_descriptor import _PAT, _WX, _WY
from tests.test_torch_extractor import H, L, NF, W, image

VARIANTS = {"no_lut": dict(desc_lut_bins=0),
            "rowgather": dict(patch_method="rowgather")}


@pytest.fixture(scope="module")
def canvas():
    """(JAX stack, shapes, keypoints [L, Q, 2], the same as tensors)."""
    stack, shapes = jfs.build_pyramid_stack(jnp.asarray(image("rendered")), L, 1.2)
    shapes = tuple(tuple(s) for s in shapes)
    quotas = tuple(JaxConfig(n_features=NF, n_levels=L).level_quotas())
    xy_l, _, _ = jfs.detect_keypoints_stack(stack, shapes, quotas)
    T = lambda a: torch.from_numpy(np.array(a))
    return stack, shapes, xy_l, (T(stack), torch.tensor(shapes), T(xy_l))


@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("kind", ["rendered", "textured"])
def test_extract_stacked_variant_matches_jax(variant, kind):
    img = image(kind)
    jc = JaxConfig(n_features=NF, n_levels=L, **VARIANTS[variant])
    consts = JaxExtractor(jc, use_pallas=False).pyramid_consts((H, W))
    fj = jax.jit(lambda im, c: _extract_stacked(im, c, config=jc, use_pallas=False))(
        jnp.asarray(img), consts)
    ft = ORBExtractor(ORBConfig(n_features=NF, n_levels=L, **VARIANTS[variant]),
                      H, W, device="cpu")(torch.from_numpy(img))
    octave = np.asarray(fj.octave)
    np.testing.assert_array_equal(ft.octave.numpy(), octave)
    xy_j, xy_t = np.asarray(fj.xy), ft.xy.numpy()
    desc_j = np.asarray(fj.desc_u32).view(np.int32)
    desc_t = ft.desc_i32.numpy()
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
    assert int(ft.valid.sum()) > 0.8 * NF


def test_gaussian_blur_stack_matches_jax(canvas):
    stack, _, _, (st, _, _) = canvas
    bj = np.asarray(jds.gaussian_blur_stack(stack))
    bt = tds.gaussian_blur_stack(st).numpy()
    np.testing.assert_allclose(bt, bj, atol=1e-4)
    assert (np.round(bt) == np.round(bj)).mean() >= 0.999


@pytest.mark.parametrize("method", ["onehot", "rowgather"])
def test_ic_angles_batch_matches_jax(canvas, method):
    stack, shapes, xy_l, (st, hw, xt) = canvas
    aj = np.asarray(jds.ic_angles_batch(stack, xy_l, shapes, method=method))
    at = tds.ic_angles_batch(st, xt, hw, torch.from_numpy(_WX), torch.from_numpy(_WY))
    np.testing.assert_allclose(at.numpy(), aj, atol=1e-5)


@pytest.mark.parametrize("method", ["onehot", "rowgather"])
def test_rbrief_batch_lut_matches_jax(canvas, method):
    """Same blurred canvas and angles into both: bit-equal."""
    stack, shapes, xy_l, (_, hw, xt) = canvas
    blurred = jnp.round(jds.gaussian_blur_stack(stack))
    ang = jds.ic_angles_batch(stack, xy_l, shapes)
    table = jnp.asarray(jds.rbrief_lut_table(30), jnp.bfloat16)
    dj = jds.rbrief_batch_lut(blurred, xy_l, ang, shapes, table, 30, method=method)
    dt = tds.rbrief_batch_lut(
        torch.from_numpy(np.array(blurred)), xt, torch.from_numpy(np.array(ang)),
        hw, torch.from_numpy(tds.lut_sample_indices(30)))
    np.testing.assert_array_equal(dt.numpy(), np.asarray(dj))


def test_rbrief_batch_matches_jax(canvas):
    """Continuous rotation on the same blurred canvas and angles."""
    stack, shapes, xy_l, (_, hw, xt) = canvas
    blurred = jnp.round(jds.gaussian_blur_stack(stack))
    ang = jds.ic_angles_batch(stack, xy_l, shapes)
    dj = np.asarray(jds.rbrief_batch(blurred, xy_l, ang, shapes))
    dt = tds.rbrief_batch(torch.from_numpy(np.array(blurred)), xt,
                          torch.from_numpy(np.array(ang)), hw,
                          torch.from_numpy(_PAT)).numpy()
    same = np.all(dt == dj, axis=-1)
    assert same.mean() >= 0.99, same.mean()


def test_variant_buffers():
    """The no-LUT extractor holds the rBRIEF pattern, the LUT one the LUT
    indices."""
    no_lut = ORBExtractor(ORBConfig(n_features=NF, n_levels=L, desc_lut_bins=0),
                          H, W, device="cpu")
    names = {n for n, _ in no_lut.named_buffers()}
    assert "pat" in names and "lut_idx" not in names
    rg = ORBExtractor(ORBConfig(n_features=NF, n_levels=L, patch_method="rowgather"),
                      H, W, device="cpu")
    names = {n for n, _ in rg.named_buffers()}
    assert "lut_idx" in names and "pat" not in names
