"""Kernel K1's module and the FAST selection tail against the JAX package.

- `fast_score_nms_plain` equals the Pallas packed kernel in interpret mode
  (`tree=True, border=16`) and the XLA score + reduce_window + border
  mask, exactly, inside every level: both compute min/max of the same
  exactly rounded differences.
- `KeypointSelector` equals `_select_from_masked` exactly (xy, score,
  valid) on the same numpy canvas, including tie-heavy canvases.
- `reference_quota` equals the JAX while_loop on random cell counts.
- `build_pyramid_stack`: level 0 bit-equal; levels >= 1 may flip a rare
  bf16 rounding of the row pass (summation order), so at least 99.9% of
  their pixels are equal and none differs by more than 1.5 intensity.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam_tpu.io.synthetic import SyntheticScene, lateral_trajectory
from orb_slam_tpu.ops import fast as jfast
from orb_slam_tpu.ops import fast_stack as jfs
from orb_slam_tpu.ops.pallas_fast import fast_score_nms_packed
from orb_slam_tpu_torch.ops import fast as tfast
from orb_slam_tpu_torch.ops import fast_stack as tfs
from orb_slam_tpu_torch.ops.fast_score_nms import (
    fast_score_nms, fast_score_nms_plain, fast_score_stack,
)
from orb_slam_tpu_torch.ops.image import pyramid_shapes


def textured(rng, h=128, w=256):
    img = rng.uniform(30, 70, (h, w)).astype(np.float32)
    for _ in range(60):
        y, x = rng.integers(8, h - 8), rng.integers(8, w - 8)
        s = int(rng.integers(2, 6))
        img[y - s:y + s, x - s:x + s] = float(rng.uniform(100, 255))
    return img


def rendered(quantize, h=240, w=320):
    scene = SyntheticScene(n_points=300, width=w, height=h, fx=250.0, fy=250.0,
                           cx=w / 2, cy=h / 2)
    return scene.render_image(lateral_trajectory(2, step=0.05)[1],
                              quantize=quantize)


def jax_stack(img, levels):
    stack, shapes = jfs.build_pyramid_stack(jnp.asarray(img), levels, 1.2)
    return np.array(stack), tuple(tuple(s) for s in shapes)


def xla_masked(stack, shapes, border=16):
    """The XLA detector front: score, 3x3 NMS, border mask."""
    score = jfs.fast_score_stack(jnp.asarray(stack))
    mx = jax.lax.reduce_window(score, -jnp.inf, jax.lax.max, (1, 3, 3),
                               (1, 1, 1), "SAME")
    base = np.where(np.asarray(score >= mx), np.asarray(score), 0.0)
    L, H, W = stack.shape
    ys, xs = np.arange(H)[:, None], np.arange(W)[None, :]
    for l, (h, w) in enumerate(shapes):
        inner = (ys >= border) & (ys < h - border) & (xs >= border) & (xs < w - border)
        base[l][~inner] = 0.0
    return base.astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1])
def test_score_stack_matches_xla(seed):
    stack, _ = jax_stack(textured(np.random.default_rng(seed)), 4)
    got = fast_score_stack(torch.from_numpy(stack)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jfs.fast_score_stack(jnp.asarray(stack))))


@pytest.mark.parametrize("seed", [0, 1])
def test_plain_k1_matches_pallas_interpret(seed):
    stack, shapes = jax_stack(textured(np.random.default_rng(seed)), 4)
    want = np.asarray(fast_score_nms_packed(
        jnp.asarray(stack), shapes, BH=64, BW=256, tree=True, interpret=True,
        border=16))
    got = fast_score_nms_plain(torch.from_numpy(stack), shapes).numpy()
    for l, (h, w) in enumerate(shapes):
        np.testing.assert_array_equal(got[l, :h, :w], want[l, :h, :w])


@pytest.mark.parametrize("quantize", [False, True])
def test_plain_k1_matches_xla_path(quantize):
    stack, shapes = jax_stack(rendered(quantize), 4)
    got = fast_score_nms_plain(torch.from_numpy(stack), shapes).numpy()
    want = xla_masked(stack, shapes)
    for l, (h, w) in enumerate(shapes):
        np.testing.assert_array_equal(got[l, :h, :w], want[l, :h, :w])


def test_wrapper_runs_plain_on_cpu():
    stack, shapes = jax_stack(textured(np.random.default_rng(3)), 3)
    t = torch.from_numpy(stack)
    np.testing.assert_array_equal(fast_score_nms(t, shapes).numpy(),
                                  fast_score_nms_plain(t, shapes).numpy())


def select_both(base, shapes, quotas):
    got = tfs.KeypointSelector(shapes, quotas, device="cpu")(torch.from_numpy(base))
    want = jfs._select_from_masked(jnp.asarray(base), shapes, quotas)
    return [g.numpy() for g in got], [np.asarray(w) for w in want]


@pytest.mark.parametrize("quantize", [False, True])
def test_selection_exact_on_rendered(quantize):
    """Quantized images give integer FAST scores, so many ties."""
    stack, shapes = jax_stack(rendered(quantize), 4)
    base = xla_masked(stack, shapes)
    (gxy, gs, gv), (wxy, ws, wv) = select_both(base, shapes, (120, 80, 60, 40))
    np.testing.assert_array_equal(gxy, wxy)
    np.testing.assert_array_equal(gs, ws)
    np.testing.assert_array_equal(gv, wv)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_selection_exact_on_integer_canvas(seed):
    """Random integer scores on sparse maxima: ties everywhere, skewed
    cells that trigger the redistribution loop and the fallback threshold,
    and unwritten (garbage) canvas outside the levels."""
    rng = np.random.default_rng(seed)
    shapes = tuple(tuple(s) for s in pyramid_shapes(240, 320, 4, 1.2))
    base = np.full((4, 240, 320), 1e6, np.float32)      # outside: garbage
    for l, (h, w) in enumerate(shapes):
        lvl = rng.integers(0, 40, (h, w)).astype(np.float32)
        lvl[rng.random((h, w)) > 0.08] = 0.0
        lvl[:, : w // 3] *= rng.random() < 0.5           # starve some cells
        lvl[:16], lvl[h - 16:], lvl[:, :16], lvl[:, w - 16:] = 0, 0, 0, 0
        base[l, :h, :w] = lvl
    (gxy, gs, gv), (wxy, ws, wv) = select_both(base, shapes, (150, 100, 70, 50))
    np.testing.assert_array_equal(gxy, wxy)
    np.testing.assert_array_equal(gs, ws)
    np.testing.assert_array_equal(gv, wv)


@pytest.mark.parametrize("seed", range(6))
def test_reference_quota_random(seed):
    rng = np.random.default_rng(seed)
    L, C = 5, 30
    avail = rng.integers(0, 25, (L, C)).astype(np.int32)
    avail[:, rng.integers(0, C, 8)] = 0
    n_real = rng.integers(1, C + 1, L)
    active = np.arange(C)[None, :] < n_real[:, None]
    quotas = rng.integers(1, 400, L).astype(np.int32)
    want = np.asarray(jax.vmap(jfast.reference_quota)(
        jnp.asarray(avail), jnp.asarray(quotas), jnp.asarray(active)))
    got = tfast.reference_quota(torch.from_numpy(avail), torch.from_numpy(quotas),
                                torch.from_numpy(active)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("quantize", [False, True])
def test_pyramid_stack(quantize):
    img = rendered(quantize)
    want, _ = jax_stack(img, 4)
    Rp, Cp = tfs.pyramid_matrices(240, 320, 4, 1.2)
    got = tfs.build_pyramid_stack(torch.from_numpy(img), torch.from_numpy(Rp),
                                  torch.from_numpy(Cp)).numpy()
    np.testing.assert_array_equal(got[0], want[0])
    same = np.mean(got[1:] == want[1:])
    assert same >= 0.999, same
    assert np.abs(got[1:] - want[1:]).max() <= 1.5
