"""The port's copied constants and static tables equal the JAX package's.

Everything here is exact: the constants are copies, and the tables are
built by the same numpy code on the same inputs.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam_tpu.frontend.orb_extractor import ORBConfig as JaxORBConfig
from orb_slam_tpu.ops import descriptor_stack as jds
from orb_slam_tpu.ops import fast as jfast
from orb_slam_tpu.ops import fast_stack as jfs
from orb_slam_tpu.ops import image as jimage
from orb_slam_tpu.ops import orb_descriptor as jod
from orb_slam_tpu.ops.orb_pattern import ORB_PATTERN as JAX_PATTERN
from orb_slam_tpu_torch.frontend.orb_extractor import ORBConfig
from orb_slam_tpu_torch.ops import descriptor_stack as tds
from orb_slam_tpu_torch.ops import fast as tfast
from orb_slam_tpu_torch.ops import fast_stack as tfs
from orb_slam_tpu_torch.ops import image as timage
from orb_slam_tpu_torch.ops import orb_descriptor as tod
from orb_slam_tpu_torch.ops.orb_pattern import ORB_PATTERN
from orb_slam_tpu_torch.ops.sort import first_k_true, top_k

CONFIGS = [dict(), dict(n_features=300, n_levels=4),
           dict(n_features=2000, n_levels=8, scale_factor=1.2),
           dict(n_features=500, n_levels=5, scale_factor=1.3)]


def test_fast_circle():
    np.testing.assert_array_equal(tfast.FAST_CIRCLE, jfast.FAST_CIRCLE)
    assert tfast.FAST_CIRCLE.dtype == jfast.FAST_CIRCLE.dtype


def test_orb_pattern():
    np.testing.assert_array_equal(ORB_PATTERN, JAX_PATTERN)
    assert ORB_PATTERN.dtype == JAX_PATTERN.dtype


@pytest.mark.parametrize("name", ["_WX", "_WY", "_PAT"])
def test_descriptor_arrays(name):
    a, b = getattr(tod, name), getattr(jod, name)
    assert a.dtype == b.dtype
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", ["PATCH", "HALF_PATCH", "_RB_HALF", "_RB_SIZE"])
def test_descriptor_scalars(name):
    assert getattr(tod, name) == getattr(jod, name)


@pytest.mark.parametrize("n_bins", [30, 12])
def test_lut_sample_indices(n_bins):
    np.testing.assert_array_equal(tds.lut_sample_indices(n_bins),
                                  jds.lut_sample_indices(n_bins))


def test_rbrief_lut_table():
    np.testing.assert_array_equal(tds.rbrief_lut_table(30),
                                  jds.rbrief_lut_table(30))


@pytest.mark.parametrize("hw,levels", [((240, 320), 4), ((480, 640), 8),
                                       ((100, 180), 3)])
def test_pyramid_matrices(hw, levels):
    Rt, Ct = tfs.pyramid_matrices(*hw, levels, 1.2)
    Rj, Cj = jfs.pyramid_matrices(*hw, levels, 1.2)
    np.testing.assert_array_equal(Rt, Rj)
    np.testing.assert_array_equal(Ct, Cj)


@pytest.mark.parametrize("kw", CONFIGS)
def test_level_quotas_and_scales(kw):
    a, b = ORBConfig(**kw), JaxORBConfig(**kw)
    assert a.level_quotas() == b.level_quotas()
    assert a.scale_factors() == b.scale_factors()
    assert a.sigma2() == b.sigma2()
    assert dataclasses.asdict(a) == dataclasses.asdict(b)


@pytest.mark.parametrize("kw", CONFIGS)
def test_pyramid_shapes(kw):
    c = ORBConfig(**kw)
    for hw in [(480, 640), (240, 320), (376, 1241)]:
        assert (timage.pyramid_shapes(*hw, c.n_levels, c.scale_factor)
                == jimage.pyramid_shapes(*hw, c.n_levels, c.scale_factor))


def test_gaussian_kernel():
    np.testing.assert_array_equal(timage.gaussian_kernel1d(7, 2.0),
                                  jimage.gaussian_kernel1d(7, 2.0))


@pytest.mark.parametrize("kw", CONFIGS)
def test_reference_grid(kw):
    c = ORBConfig(**kw)
    shapes = timage.pyramid_shapes(480, 640, c.n_levels, c.scale_factor)
    for (h, w), q in zip(shapes, c.level_quotas()):
        for border in (16, 3):
            assert (tfast.reference_grid(h, w, q, 640 / 480, border)
                    == jfast.reference_grid(h, w, q, 640 / 480, border))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_lut_gather_equals_table(seed):
    """The port's gather form of the descriptor bit equals the JAX int8 LUT
    product (descriptor_stack.py:439-451) on integer patches."""
    rng = np.random.default_rng(seed)
    n = 64
    flat = rng.integers(0, 256, (n, 39 * 39)).astype(np.float32)
    bins = rng.integers(0, 30, n)
    # JAX form: (p - 128) int8 @ table int8 -> int32, pick the bin, > 0
    y = ((flat - 128).astype(np.int64) @ jds.rbrief_lut_table(30).astype(np.int64))
    table_bits = y.reshape(n, 30, 256)[np.arange(n), bins] > 0
    idx = torch.from_numpy(tds.lut_sample_indices(30))[torch.from_numpy(bins)]
    vals = torch.gather(torch.from_numpy(flat), 1, idx)
    gather_bits = (vals[:, 1::2] > vals[:, 0::2]).numpy()
    np.testing.assert_array_equal(gather_bits, table_bits)


@pytest.mark.parametrize("seed", [0, 1])
def test_pack_i32_is_pack_u32_bits(seed):
    rng = np.random.default_rng(seed)
    d = rng.integers(0, 256, (50, 32)).astype(np.uint8)
    want = np.asarray(jod.pack_u32(jnp.asarray(d))).view(np.int32)
    got = tod.pack_i32(torch.from_numpy(d)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_top_k_tie_order_is_lax_top_k(seed):
    """Ties, negative values and signed zeros: the lowest index wins."""
    rng = np.random.default_rng(seed)
    x = rng.integers(-3, 4, (3, 200)).astype(np.float32)
    x[0, :5] = [0.0, -0.0, 0.0, -0.0, 0.0]
    for k in (1, 17, 200):
        v, i = top_k(torch.from_numpy(x), k)
        vj, ij = jax.lax.top_k(jnp.asarray(x), k)
        np.testing.assert_array_equal(i.numpy(), np.asarray(ij))
        np.testing.assert_array_equal(v.numpy(), np.asarray(vj))
    m = rng.random(300) > 0.7
    _, ij = jax.lax.top_k(jnp.asarray(m.astype(np.float32)), 100)
    np.testing.assert_array_equal(first_k_true(torch.from_numpy(m), 100).numpy(),
                                  np.asarray(ij))
