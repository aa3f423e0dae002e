"""The algebra of the shared FAST stencil (csrc/fast_score.cuh) and of
kernel K3's early-out, on the CPU.

- A torch mirror of `fast::circ9` and `fast::score`, in the header's order
  (prefix P and suffix S over the two 8-blocks of the 16 circle pixels,
  arc s < 8 = op(S[0][s], P[1][s]), arc s >= 8 = op(S[1][s-8], P[0][s-8]),
  the arcs combined left to right, the centre subtracted from the two
  results), with fmin/fmax for the CUDA fminf/fmaxf. On tie-heavy
  quantized canvases it equals `ops/fast.py::fast_score_stack` bit for
  bit; its 16 arc minima and maxima equal the JAX package's
  `_circ9_minmax` on the same planes exactly; and on continuous random
  canvases, subtracting the centre after the arcs gives the arcs of the 16
  differences exactly (x -> fl(x - c) is monotone).
- The identity K3's early-out relies on: where the canvas holds one value
  over a region, K3's plain version gives score 0 and keep True at every
  pixel whose stencil and NMS neighbourhood lie in the region, and the
  Pallas kernel in interpret mode agrees over the whole canvas; on the
  pyramid canvas the main path builds, every 32x32 tile whose clamped
  40x40 window holds one bit pattern has exactly the outputs the kernel
  writes for it without the stencil.
All comparisons are exact: every value is a min or max of exactly rounded
differences. They are bit for bit up to the sign of a zero score
(`same_bits` adds +0.0 first): on the CPU torch's maximum returns its
second operand when both are zeros (x86 maxps), so the plain version
scores a flat pixel -0.0 here, while fmax and the kernel's fmaxf need
not. On the card, torch's maximum and the kernel both use fmaxf, and the
card tests compare them bit for bit, signs included.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from orb_slam_tpu.ops.pallas_fast import _circ9_minmax, fast_score_nms_pallas
from orb_slam_tpu_torch.ops.fast import FAST_CIRCLE, fast_score_stack
from orb_slam_tpu_torch.ops.fast_score_rect import fast_score_nms_rect_plain
from orb_slam_tpu_torch.ops.fast_stack import build_pyramid_stack, pyramid_matrices
from orb_slam_tpu_torch.io.synthetic import SyntheticScene, lateral_trajectory

TILE, HALO = 32, 4   # K3's output tile and its window halo (stencil 3 + NMS 1)


def quantized(seed, shape=(2, 64, 96), levels=4, step=20.0):
    """Few distinct values, so most differences tie."""
    rng = np.random.default_rng(seed)
    return (rng.integers(0, levels, shape) * step).astype(np.float32)


def circle(stack):
    """[16, L, H, W] planes I(p + circle_k), the canvas read edge-replicated
    (as fast_score_stack)."""
    L, H, W = stack.shape
    padded = F.pad(stack[None], (3, 3, 3, 3), mode="replicate")[0]
    return torch.stack([padded[:, 3 + dy:3 + dy + H, 3 + dx:3 + dx + W]
                        for dy, dx in FAST_CIRCLE.tolist()])


def circ9(d, op):
    """fast::circ9 on the 16 planes d: the 16 circular 9-arc reductions."""
    P = [[d[8 * b]] for b in range(2)]
    S = [[None] * 7 + [d[8 * b + 7]] for b in range(2)]
    for b in range(2):
        for i in range(1, 8):
            P[b].append(op(P[b][i - 1], d[8 * b + i]))
        for i in range(6, -1, -1):
            S[b][i] = op(d[8 * b + i], S[b][i + 1])
    return ([op(S[0][s], P[1][s]) for s in range(8)]
            + [op(S[1][s], P[0][s]) for s in range(8)])


def score_mirror(stack):
    """fast::score over the whole canvas."""
    v = circle(stack)
    mn, mx = circ9(v, torch.fmin), circ9(v, torch.fmax)
    hi, lo = mn[0], mx[0]
    for s in range(1, 16):
        hi = torch.fmax(hi, mn[s])
        lo = torch.fmin(lo, mx[s])
    return torch.fmax(hi - stack, -(lo - stack))


def same_bits(a, b):
    """Equal bit patterns once -0.0 is taken to +0.0 (see the docstring)."""
    bits = lambda t: (t + 0.0).contiguous().view(torch.int32)
    return a.shape == b.shape and torch.equal(bits(a), bits(b))


@pytest.mark.parametrize("seed,levels,step", [
    (0, 3, 20.0), (1, 4, 7.5), (2, 2, 100.0)])
def test_mirror_equals_fast_score_stack(seed, levels, step):
    stack = torch.from_numpy(quantized(seed, levels=levels, step=step))
    assert same_bits(score_mirror(stack), fast_score_stack(stack))


def test_mirror_equals_fast_score_stack_on_rendered_canvas():
    scene = SyntheticScene(n_points=300, width=160, height=120, fx=125.0,
                           fy=125.0, cx=80.0, cy=60.0, seed=4)
    img = torch.from_numpy(scene.render_image(lateral_trajectory(2)[1],
                                              quantize=True))
    Rp, Cp = pyramid_matrices(120, 160, 3, 1.2)
    stack = build_pyramid_stack(img, torch.from_numpy(Rp), torch.from_numpy(Cp))
    assert same_bits(score_mirror(stack), fast_score_stack(stack))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_mirror_arcs_equal_jax_circ9(seed):
    v = circle(torch.from_numpy(quantized(seed)))
    want_mn, want_mx = _circ9_minmax([jnp.asarray(p.numpy()) for p in v])
    for got, want in ((circ9(v, torch.fmin), want_mn),
                      (circ9(v, torch.fmax), want_mx)):
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("seed,scale", [(0, 255.0), (1, 1e-3), (2, 3e4)])
def test_centre_subtracted_after_the_arcs_is_exact(seed, scale):
    """Arcs of the intensities minus the centre = arcs of the differences,
    bit for bit, on continuous values where every subtraction rounds."""
    rng = np.random.default_rng(seed)
    stack = torch.from_numpy((rng.random((2, 48, 64)) * scale).astype(np.float32))
    v = circle(stack)
    for op in (torch.fmin, torch.fmax):
        for after, before in zip(circ9(v, op), circ9(v - stack, op)):
            assert same_bits(after - stack, before)


@pytest.mark.parametrize("value", [0.0, 93.25])
@pytest.mark.parametrize("rows,cols", [((20, 70), (30, 90)), ((0, 40), (0, 48))])
def test_constant_region_scores_zero_and_keeps(value, rows, cols):
    """Inside a region of one value, at least HALO pixels from its edge
    (canvas edges excepted: the reads clamp into the region), K3 scores 0
    and keeps every pixel; the Pallas kernel agrees everywhere."""
    stack = quantized(7, shape=(2, 96, 128), levels=5, step=11.0)
    (r0, r1), (c0, c1) = rows, cols
    stack[:, r0:r1, c0:c1] = value
    score, keep = fast_score_nms_rect_plain(torch.from_numpy(stack))
    y0, x0 = (r0 + HALO if r0 else 0), (c0 + HALO if c0 else 0)
    inner = (slice(None), slice(y0, r1 - HALO), slice(x0, c1 - HALO))
    assert torch.equal(score[inner], torch.zeros_like(score[inner]))
    assert bool(keep[inner].all())
    want_s, want_k = fast_score_nms_pallas(jnp.asarray(stack), interpret=True)
    np.testing.assert_array_equal(score.numpy(), np.asarray(want_s))
    np.testing.assert_array_equal(keep.numpy(), np.asarray(want_k))


def uniform_tiles(stack):
    """[L, H/32, W/32] bool: the tile's clamped 40x40 window holds one bit
    pattern (K3's test; tiles at the canvas edge read clamped pixels)."""
    L, H, W = stack.shape
    th, tw = -(-H // TILE), -(-W // TILE)
    ys = np.clip(np.arange(-HALO, th * TILE + HALO), 0, H - 1)
    xs = np.clip(np.arange(-HALO, tw * TILE + HALO), 0, W - 1)
    b = stack.numpy().view(np.int32)[:, ys][:, :, xs]
    out = np.zeros((L, th, tw), dtype=bool)
    for i in range(th):
        for j in range(tw):
            win = b[:, i * TILE:i * TILE + TILE + 2 * HALO,
                    j * TILE:j * TILE + TILE + 2 * HALO].reshape(L, -1)
            out[:, i, j] = (win == win[:, :1]).all(1)
    return out


def test_uniform_tiles_take_the_early_out_values():
    """On the main path's 8-level canvas of a 640x480 frame, most tiles are
    uniform (zero padding outside the levels), and each one's plain K3
    outputs are what the kernel writes without the stencil:
    fmax(v, -v) with v = c - c, and keep = (s >= s)."""
    scene = SyntheticScene(n_points=800, width=640, height=480)
    img = torch.from_numpy(scene.render_image(lateral_trajectory(2)[1]))
    Rp, Cp = pyramid_matrices(480, 640, 8, 1.2)
    stack = build_pyramid_stack(img, torch.from_numpy(Rp), torch.from_numpy(Cp))
    uni = uniform_tiles(stack)
    assert uni.mean() > 0.5, uni.mean()
    score, keep = fast_score_nms_rect_plain(stack)
    for l, i, j in zip(*np.nonzero(uni)):
        sl = (l, slice(i * TILE, i * TILE + TILE), slice(j * TILE, j * TILE + TILE))
        c = stack[l, max(i * TILE - HALO, 0), max(j * TILE - HALO, 0)]
        v = c - c
        s = torch.fmax(v, -v)
        assert same_bits(score[sl], s.expand_as(score[sl])), (l, i, j)
        assert bool((keep[sl] == bool(s >= s)).all()), (l, i, j)
