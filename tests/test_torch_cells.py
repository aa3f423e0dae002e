"""Kernel K4's module and the cell-fused detector against the JAX package.

- `cell_block_table` equals the JAX table;
- `fast_cell_topk_plain` equals the Pallas kernel `fast_cell_topk_packed`
  in interpret mode exactly (vals and packed positions): on textured and
  rendered frames, on a frame with flat (empty) cells, and on quantized
  frames whose integer scores tie everywhere (ties go to the lowest y,
  then x);
- `DetectCellsFused` equals `_detect_cells_fused(..., interpret=True)`
  exactly (xy, score, valid): every step of its tail is exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam_tpu.io.synthetic import SyntheticScene, lateral_trajectory
from orb_slam_tpu.ops import fast_stack as jfs
from orb_slam_tpu.ops import pallas_fast as jpf
from orb_slam_tpu_torch.ops import fast_stack as tfs
from orb_slam_tpu_torch.ops.fast_cell_topk import (
    cell_block_table, fast_cell_topk, fast_cell_topk_plain,
)
from orb_slam_tpu_torch.ops.image import pyramid_shapes


def textured(rng, h=160, w=320, flat_half=False):
    img = rng.uniform(30, 70, (h, w)).astype(np.float32)
    for _ in range(80):
        y, x = rng.integers(8, h - 8), rng.integers(8, w - 8)
        s = int(rng.integers(2, 6))
        img[y - s:y + s, x - s:x + s] = float(rng.uniform(100, 255))
    if flat_half:                      # empty cells: no corner at all
        img[:, : w // 2] = 50.0
    return img


def rendered(quantize, h=240, w=320):
    scene = SyntheticScene(n_points=300, width=w, height=h, fx=250.0, fy=250.0,
                           cx=w / 2, cy=h / 2)
    return scene.render_image(lateral_trajectory(2, step=0.05)[1],
                              quantize=quantize)


IMAGES = {
    "textured": lambda: textured(np.random.default_rng(0)),
    "flat_cells": lambda: textured(np.random.default_rng(1), flat_half=True),
    "rendered": lambda: rendered(False),
    "quantized": lambda: rendered(True),
}


def jax_stack(img, levels=4):
    stack, shapes = jfs.build_pyramid_stack(jnp.asarray(img), levels, 1.2)
    return np.array(stack), tuple(tuple(s) for s in shapes)


@pytest.mark.parametrize("hw,levels,border", [((480, 640), 8, 16),
                                               ((240, 320), 4, 16),
                                               ((100, 90), 3, 40)])
def test_cell_block_table_matches_jax(hw, levels, border):
    shapes = tuple(tuple(s) for s in pyramid_shapes(*hw, levels, 1.2))
    assert cell_block_table(shapes, 32, 256, border) == jpf.cell_block_table(
        shapes, 32, 256, border)
    assert tfs.cell_block_table is cell_block_table


@pytest.mark.parametrize("kind", list(IMAGES))
def test_plain_k4_matches_pallas_interpret(kind):
    stack, shapes = jax_stack(IMAGES[kind]())
    wv, wp = jpf.fast_cell_topk_packed(jnp.asarray(stack), shapes, K=4, BH=32,
                                       BW=256, border=16, interpret=True)
    gv, gp = fast_cell_topk_plain(torch.from_numpy(stack), shapes)
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
    np.testing.assert_array_equal(gp.numpy(), np.asarray(wp))
    if kind == "flat_cells":   # the fixture really has empty cells
        assert (gp.numpy() == 2 ** 30).any() and (gv.numpy() == 0.0).any()


def test_k4_wrapper_runs_plain_on_cpu():
    stack, shapes = jax_stack(textured(np.random.default_rng(3)), 3)
    t = torch.from_numpy(stack)
    for a, b in zip(fast_cell_topk(t, shapes), fast_cell_topk_plain(t, shapes)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("kind", list(IMAGES))
def test_detect_cells_fused_matches_jax(kind):
    stack, shapes = jax_stack(IMAGES[kind]())
    quotas = (120, 80, 60, 40)
    want = jfs._detect_cells_fused(jnp.asarray(stack), shapes, quotas,
                                   interpret=True)
    det = tfs.DetectCellsFused(shapes, quotas, device="cpu")
    got = det(torch.from_numpy(stack))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    sel = tfs.KeypointSelector(shapes, quotas, device="cpu")
    ref = tfs.detect_keypoints_stack(torch.from_numpy(stack), sel)
    assert [g.shape for g in got] == [r.shape for r in ref]
