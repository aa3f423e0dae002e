"""The block mappings of kernels K1 and K4 around their shared 32x32
masked-score tile (csrc/fast_tile.cuh), on the CPU.

- K1's tile table (`ops/fast_score_nms.py::tile_table`), decoded block by
  block as csrc/fast_score_nms.cu decodes it, lists every 32x32 tile that
  holds a pixel of a level exactly once and nothing else (a brute-force
  count over the level pixels), levels narrower than one tile included,
  the inner tile rows of the levels before their top and bottom rows.
- The score rows the tile leaves unscored (canvas rows outside
  [border - 1, h - border] of the level) change no masked output: set to
  a huge score, K1's plain output is the same bit for bit.
- K4's empty cells (`ops/fast_cell_topk.py::empty_cells`, the kernel's
  test) are exactly the cells with no pixel in the level's detectable
  interior, and `fast_cell_topk_plain` gives them value +0.0 (bit pattern
  0) and position 2^30 in every slot: what the kernel writes there without
  the stencil.
- A torch mirror of K4's block-wide arg-max (each thread's 4 pixels of one
  row, the 5-step xor-shuffle tree in each warp, the 8 warps' candidates
  in a 3-step xor tree over 8 lanes, the winner zeroed) equals
  `fast_cell_topk_plain`, and the Pallas kernel in interpret mode, on
  tie-heavy canvases: quantized renders and canvases with large constant
  patches. The mirror recomputes every warp's candidate in every round;
  the kernel recomputes only the winner's warp, whose pixels alone
  changed, which gives the same candidates.
All comparisons are exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from orb_slam_tpu.ops import pallas_fast as jpf
from orb_slam_tpu_torch.io.synthetic import SyntheticScene, lateral_trajectory
from orb_slam_tpu_torch.ops.fast_cell_topk import (
    SENTINEL, cell_block_table, empty_cells, fast_cell_topk_plain, masked_strips,
)
from orb_slam_tpu_torch.ops.fast import fast_score_stack, level_interior
from orb_slam_tpu_torch.ops.fast_score_nms import TILE, fast_score_nms_plain, tile_table
from orb_slam_tpu_torch.ops.fast_stack import build_pyramid_stack, pyramid_matrices
from orb_slam_tpu_torch.ops.image import pyramid_shapes

WARPS, LANES = 8, 32     # K4's block: 256 threads, each 4 pixels of a row


def rendered_canvas(h, w, levels, quantize, seed=1):
    scene = SyntheticScene(n_points=300, width=w, height=h, fx=w * 0.78,
                           fy=w * 0.78, cx=w / 2, cy=h / 2, seed=seed)
    img = torch.from_numpy(scene.render_image(lateral_trajectory(2)[1],
                                              quantize=quantize))
    Rp, Cp = pyramid_matrices(h, w, levels, 1.2)
    stack = build_pyramid_stack(img, torch.from_numpy(Rp), torch.from_numpy(Cp))
    return stack, [tuple(s) for s in pyramid_shapes(h, w, levels, 1.2)]


def patched_canvas(seed, shapes, H, W):
    """Few distinct values (integer scores tie everywhere), with large
    constant patches that NMS keeps whole rows and columns of."""
    rng = np.random.default_rng(seed)
    stack = (rng.integers(0, 4, (len(shapes), H, W)) * 20.0).astype(np.float32)
    for l in range(len(shapes)):
        for _ in range(4):
            y, x = rng.integers(0, H - 24), rng.integers(0, W - 24)
            dy, dx = rng.integers(8, 48, 2)
            stack[l, y:y + dy, x:x + dx] = float(rng.integers(0, 4) * 20)
    return torch.from_numpy(stack)


# -- K1's tile table --------------------------------------------------------

TILE_SHAPES = {
    "480x640x8": pyramid_shapes(480, 640, 8, 1.2),
    "241x319x3": pyramid_shapes(241, 319, 3, 1.2),
    "100x90x2": pyramid_shapes(100, 90, 2, 1.2),
    "narrow": [(70, 20), (8, 8), (33, 31), (32, 33), (1, 100)],
}


def decode_k1_blocks(shapes):
    """(level, r0, c0) of each block, decoded as fast_score_nms_kernel does
    from the segment rows."""
    n_blocks, rows = tile_table(shapes)
    segs = rows[2 * len(shapes):]
    lvl, start, r0, n_tx = segs[0::4], segs[1::4], segs[2::4], segs[3::4]
    out = []
    for b in range(n_blocks):
        s = 0
        while s + 1 < len(start) and b >= start[s + 1]:
            s += 1
        ty, tx = divmod(b - start[s], max(n_tx[s], 1))
        out.append((lvl[s], r0[s] + ty * TILE, tx * TILE))
    return out


@pytest.mark.parametrize("name", list(TILE_SHAPES))
def test_k1_tile_table_lists_the_tiles_that_meet_a_level(name):
    shapes = TILE_SHAPES[name]
    H = max(h for h, _ in shapes)
    W = max(w for _, w in shapes)
    want = set()
    for l, (h, w) in enumerate(shapes):
        level = np.zeros((-(-H // TILE) * TILE, -(-W // TILE) * TILE), bool)
        level[:h, :w] = True
        tiles = level.reshape(level.shape[0] // TILE, TILE, -1, TILE).any((1, 3))
        want |= {(l, i * TILE, j * TILE) for i, j in zip(*np.nonzero(tiles))}
    got = decode_k1_blocks(shapes)
    assert len(got) == len(set(got)) == tile_table(shapes)[0]
    assert set(got) == want
    # inner tile rows first, then the top and bottom rows of the levels
    edge = [r0 == 0 or r0 + TILE >= shapes[l][0] for l, r0, _ in got]
    assert edge == sorted(edge)
    if name == "480x640x8":
        assert len(got) == 998


@pytest.mark.parametrize("border", [3, 16])
def test_unscored_rows_change_no_output(border):
    stack, shapes = rendered_canvas(241, 319, 3, quantize=True)
    L, H, W = stack.shape
    halo = F.pad(stack[None], (1, 1, 1, 1), mode="replicate")[0]
    score = fast_score_stack(halo)            # row i is canvas row i - 1
    rows = torch.arange(H + 2) - 1
    for l, (h, w) in enumerate(shapes):
        score[l, (rows < border - 1) | (rows > h - border)] = 1e30
    mx = F.max_pool2d(score[None], 3, stride=1)[0]
    center = score[:, 1:1 + H, 1:1 + W]
    inner = level_interior(shapes, H, W, border, stack.device)
    got = torch.where((center >= mx) & inner, center, 0.0)
    want = fast_score_nms_plain(stack, shapes, border)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert bool((want > 0).any())


# -- K4's empty cells -------------------------------------------------------

@pytest.mark.parametrize("h,w,levels,n_empty", [(480, 640, 8, 255),
                                                (241, 319, 3, None)])
def test_k4_empty_cells_are_zero_and_sentinel(h, w, levels, n_empty):
    stack, shapes = rendered_canvas(h, w, levels, quantize=False)
    border, K = 16, 4
    empty = empty_cells(shapes, 32, 256, border)
    nb = len(cell_block_table(shapes, 32, 256, border)[0])
    assert empty.shape == (nb, 8) and empty.any()
    if n_empty is not None:
        assert int(empty.sum()) == n_empty
    # the kernel's test against the pixels: no strip pixel of the cell lies
    # in its level's detectable interior
    _, y, x = masked_strips(stack, shapes, 32, 256, border)
    lvl = torch.tensor(cell_block_table(shapes, 32, 256, border)[0])
    hs = torch.tensor([shapes[l][0] for l in lvl.tolist()])[:, None, None]
    ws = torch.tensor([shapes[l][1] for l in lvl.tolist()])[:, None, None]
    inner = (y >= border) & (y < hs - border) & (x >= border) & (x < ws - border)
    assert torch.equal(~inner.reshape(nb, 32, 8, 32).any(3).any(1), empty)
    vals, pos = fast_cell_topk_plain(stack, shapes, K=K)
    assert torch.equal(vals[empty].view(torch.int32),
                       torch.zeros((int(empty.sum()), K), dtype=torch.int32))
    assert bool((pos[empty] == SENTINEL).all())
    assert bool((pos[~empty][:, 0] != SENTINEL).any())


# -- K4's block-wide arg-max ------------------------------------------------

def arg_max(m, p, m2, p2):
    """fast_cell_topk.cu's arg_max: the larger value, the smaller position
    among the candidates holding it."""
    mm = torch.fmax(m, m2)
    p = torch.minimum(torch.where(m == mm, p, SENTINEL),
                      torch.where(m2 == mm, p2, SENTINEL))
    return mm, p


def block_topk_mirror(stack, shapes, K, BW=256, border=16):
    """fast_cell_topk_kernel's top-K rounds in its reduction order, on every
    cell."""
    s, y, x = masked_strips(stack, shapes, 32, BW, border)
    nb, nc = s.shape[0], BW // 32
    as_cells = lambda t: t.reshape(nb, 32, nc, 32).permute(0, 2, 1, 3).reshape(-1, 256, 4)
    # thread t holds pixels 4t .. 4t+3 of the cell's row-major 32x32 block:
    # row t >> 3, columns (t & 7) * 4 + q
    v, e = as_cells(s).clone(), as_cells(y * 65536 + x)
    lanes, warps = torch.arange(LANES), torch.arange(WARPS)
    vals, poss = [], []
    for _ in range(K):
        m = torch.fmax(torch.fmax(torch.fmax(v[..., 0], v[..., 1]), v[..., 2]),
                       v[..., 3])
        p = torch.full_like(m, SENTINEL, dtype=torch.int64)
        for q in (3, 2, 1, 0):
            p = torch.where((v[..., q] == m) & (v[..., q] > 0), e[..., q], p)
        m, p = m.reshape(-1, WARPS, LANES), p.reshape(-1, WARPS, LANES)
        for off in (16, 8, 4, 2, 1):
            m, p = arg_max(m, p, m[..., lanes ^ off], p[..., lanes ^ off])
        # warp 0's lanes 0..7 hold the 8 warps' candidates (lane 0 of each)
        M, P = m[:, :, 0], p[:, :, 0]
        for off in (4, 2, 1):
            M, P = arg_max(M, P, M[:, warps ^ off], P[:, warps ^ off])
        M, P = M[:, 0], P[:, 0]
        v = torch.where(e == P[:, None, None], 0.0, v)
        vals.append(M)
        poss.append(P)
    return (torch.stack(vals, -1).reshape(nb, nc, K),
            torch.stack(poss, -1).reshape(nb, nc, K).to(torch.int32))


def patched_small():
    shapes = [(96, 160), (80, 133)]
    return patched_canvas(5, shapes, 96, 160), shapes


CANVASES = {
    "quantized render": lambda: rendered_canvas(240, 320, 4, quantize=True),
    "quantized render 480x640x8": lambda: rendered_canvas(480, 640, 8, quantize=True,
                                                          seed=2),
    "constant patches": patched_small,
    "constant patches, 3 levels": lambda: (
        patched_canvas(6, pyramid_shapes(200, 300, 3, 1.2), 200, 300),
        pyramid_shapes(200, 300, 3, 1.2)),
}


@pytest.mark.parametrize("kind", list(CANVASES))
@pytest.mark.parametrize("K", [1, 8])
def test_block_argmax_mirror_equals_plain(kind, K):
    stack, shapes = CANVASES[kind]()
    got_v, got_p = block_topk_mirror(stack, shapes, K)
    want_v, want_p = fast_cell_topk_plain(stack, shapes, K=K)
    assert torch.equal(got_p, want_p)
    assert torch.equal(got_v.view(torch.int32), want_v.view(torch.int32))
    # the canvases really tie: some cell's round-1 maximum is held by
    # several pixels
    s, _, _ = masked_strips(stack, shapes)
    cells = s.reshape(s.shape[0], 32, 8, 32).permute(0, 2, 1, 3).reshape(-1, 1024)
    top = cells.amax(1, keepdim=True)
    assert bool((((cells == top) & (top > 0)).sum(1) > 1).any())


@pytest.mark.parametrize("BW", [32, 128])
def test_block_argmax_mirror_equals_pallas_interpret(BW):
    stack, shapes = patched_small()
    got_v, got_p = block_topk_mirror(stack, shapes, 4, BW=BW)
    want_v, want_p = jpf.fast_cell_topk_packed(
        jnp.asarray(stack.numpy()), tuple(shapes), K=4, BH=32, BW=BW, border=16,
        interpret=True)
    np.testing.assert_array_equal(got_p.numpy(), np.asarray(want_p))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
