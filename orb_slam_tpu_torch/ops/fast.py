"""FAST score, Harris response, 3x3 NMS, the reference's cell grid, its
quota redistribution and the per-level detector.

Port of orb_slam_tpu/ops/fast.py: `FAST_CIRCLE` (:27), `fast_score_map`
(:36-61), `harris_score_map` (:64-91), `nms3x3` (:94-100),
`reference_quota` (:103-159), `reference_grid` (:162-180), `_level_pool`
(:183-217), `_select_level` (:220-235) and `detect_fast_keypoints`
(:238-296); and of the stacked score `fast_score_stack`
(orb_slam_tpu/ops/fast_stack.py:99-123), which the per-level score and the
plain versions of kernels K1, K3 and K4 share.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from orb_slam_tpu_torch.ops.sort import top_k

# Bresenham circle of radius 3 in circular order (dy, dx), as in the JAX
# package; tests/test_torch_constants.py asserts the copy is equal.
FAST_CIRCLE = np.array(
    [
        (-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
        (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1),
    ],
    dtype=np.int32,
)


def fast_score_stack(stack: torch.Tensor) -> torch.Tensor:
    """[L, H, W] -> [L, H, W] FAST scores, the canvas edge-padded by 3.

    score = max over the 16 circular 9-arcs of the arc minimum of
    (neighbour - centre), or of (centre - neighbour) for dark arcs."""
    L, H, W = stack.shape
    padded = F.pad(stack[None], (3, 3, 3, 3), mode="replicate")[0]
    D = torch.stack([padded[:, 3 + dy:3 + dy + H, 3 + dx:3 + dx + W]
                     for dy, dx in FAST_CIRCLE.tolist()], 1) - stack[:, None]

    def run9(op, x):
        r2 = op(x, torch.roll(x, -1, 1))
        r4 = op(r2, torch.roll(r2, -2, 1))
        r8 = op(r4, torch.roll(r4, -4, 1))
        return op(r8, torch.roll(x, -8, 1))

    bright = run9(torch.minimum, D).amax(1)
    dark = -run9(torch.maximum, D).amin(1)
    return torch.maximum(bright, dark)


def level_interior(shapes, H: int, W: int, border: int, device) -> torch.Tensor:
    """[L, H, W] bool: pixel (y, x) of level l lies in [border, h-border) x
    [border, w-border), (h, w) = shapes[l]."""
    ys = torch.arange(H, device=device)[:, None]
    xs = torch.arange(W, device=device)[None, :]
    return torch.stack([(ys >= border) & (ys < h - border)
                        & (xs >= border) & (xs < w - border) for h, w in shapes])


def fast_score_map(img: torch.Tensor) -> torch.Tensor:
    """[H, W] f32 -> [H, W] FAST score, 0 on the 3-pixel ring where the
    circle leaves the image."""
    H, W = img.shape
    score = fast_score_stack(img[None])[0]
    return torch.where(level_interior([(H, W)], H, W, 3, img.device)[0],
                       score, 0.0)


def harris_score_map(img: torch.Tensor, k: float = 0.04,
                     block: int = 7) -> torch.Tensor:
    """Harris response at every pixel of [..., H, W] f32 images (the
    reference's nScoreType=0 with HARRIS_K=0.04, src/ORBextractor.cc:73,
    616-620): Sobel gradients of the edge-padded image, the structure
    tensor summed over a zero-padded block x block window, det - k trace^2,
    scaled as OpenCV's HarrisResponses.

    The sums run in the JAX operation order, so the result is bit-equal to
    the XLA version on the CPU: each Sobel derivative as its six-term sum,
    and the window sum as shifted planes added in row-major order from 0,
    the order of XLA's reduce_window (the sums reach ~5e7, past 2^24, so
    the order shows in the last bits, and the Harris ranking of the
    stacked detector breaks near-ties by them)."""
    H, W = img.shape[-2:]
    lead = img.shape[:-2]
    x = img.reshape(-1, 1, H, W)
    p = F.pad(x, (1, 1, 1, 1), mode="replicate")[:, 0]
    gx = ((p[:, 0:-2, 2:] + 2.0 * p[:, 1:-1, 2:] + p[:, 2:, 2:])
          - (p[:, 0:-2, 0:-2] + 2.0 * p[:, 1:-1, 0:-2] + p[:, 2:, 0:-2]))
    gy = ((p[:, 2:, 0:-2] + 2.0 * p[:, 2:, 1:-1] + p[:, 2:, 2:])
          - (p[:, 0:-2, 0:-2] + 2.0 * p[:, 0:-2, 1:-1] + p[:, 0:-2, 2:]))
    r = block // 2
    q = F.pad(torch.stack([gx * gx, gy * gy, gx * gy]), (r, r, r, r))
    # in place: one accumulator instead of block^2 temporaries of 3 planes;
    # box.add_(x) rounds as box + x, so the order and the result are the same
    box = torch.zeros((3,) + gx.shape, dtype=img.dtype, device=img.device)
    for i in range(block):
        for j in range(block):
            box.add_(q[:, :, i:i + H, j:j + W])
    A, B, C = box
    scale = (1.0 / (4 * 255 * block)) ** 4   # OpenCV HarrisResponses scaling
    trace = A + B
    return ((A * B - C * C - k * (trace * trace)) * scale).reshape(
        *lead, H, W)


def harris_rank(score: torch.Tensor, keep: torch.Tensor, harris: torch.Tensor,
                th_ini: float, th_min: float):
    """The nScoreType=0 ranking (fast.py:273-282, fast_stack.py:153-161):
    detection and thresholds stay FAST, but corners whose FAST score passes
    th_min are ranked by the Harris response, shifted positive past th_ini
    by the minimum over all of `harris`. Returns (score, keep)."""
    passing = score > th_min
    shifted = torch.clamp(harris - harris.min(), min=1e-6) + th_ini + 1.0
    return torch.where(passing, shifted, score), keep & passing


def nms3x3(score: torch.Tensor) -> torch.Tensor:
    """3x3 non-maximum suppression mask of [H, W]; neighbours outside the
    image are ignored; ties keep all."""
    mx = F.max_pool2d(score[None, None], 3, stride=1, padding=1)[0, 0]
    return score >= mx


def _ceil_div(a, b):
    return -torch.div(-a, b, rounding_mode="floor")


def reference_quota(avail, max_kp, active):
    """Per-cell retained-corner counts of the reference's starved-cell
    redistribution loop (src/ORBextractor.cc:644-670), batched over levels.

    avail: [L, C] int32 corner counts; max_kp: [L] int32 level quotas;
    active: [L, C] bool cells that exist in the level's grid.
    Returns retain [L, C] int32 (0 on inactive cells).

    The JAX version is a while_loop; here it is a bounded loop of C passes
    with no host sync. C passes suffice: the loop only runs when some cell
    is already saturated, and every pass but the last saturates at least
    one more. Passes after convergence change nothing, because the body is
    a fixed point there (the proof is the JAX docstring,
    orb_slam_tpu/ops/fast.py:127-134)."""
    avail = avail.to(torch.int32)
    max_kp = max_kp.to(torch.int32)
    zero = torch.zeros_like(avail)
    n_cells = active.sum(1, dtype=torch.int32)
    fair = _ceil_div(max_kp, n_cells.clamp(min=1))
    no_more = active & (avail <= fair[:, None])
    d = torch.where(no_more, fair[:, None] - avail, zero).sum(1, dtype=torch.int32)
    q = fair
    for _ in range(avail.shape[1]):
        u = n_cells - no_more.sum(1, dtype=torch.int32)
        q = torch.where(d > 0, fair + _ceil_div(d, u.clamp(min=1)), q)
        newly = active & ~no_more & (avail <= q[:, None])
        d = torch.where(newly, q[:, None] - avail, zero).sum(1, dtype=torch.int32)
        no_more = no_more | newly
    retain = torch.where(no_more, avail, q[:, None].expand_as(avail))
    return torch.where(active, retain, zero)


def reference_grid(h: int, w: int, quota: int, aspect_ratio: float,
                   border: int):
    """The reference's quota-adaptive cell grid (src/ORBextractor.cc:528-543,
    int-truncation quirks kept). Returns (rows, cols, cellH, cellW)."""
    Wb = max(1, w - 2 * border)
    Hb = max(1, h - 2 * border)
    cols = int(np.sqrt(quota / (5.0 * aspect_ratio)))
    rows = int(aspect_ratio * cols)
    cols = max(1, min(cols, Wb))
    rows = max(1, min(rows, Hb))
    cellW = -(-Wb // cols)
    cellH = -(-Hb // rows)
    return rows, cols, cellH, cellW


def _level_pool(lvl: torch.Tensor, quota: int, rows: int, cols: int,
                cellH: int, cellW: int, border: int, th_ini: float,
                th_min: float):
    """Candidate pool of one level from a masked score [H, W] (non-maxima
    and out-of-border pixels 0): the threshold fallback, then each cell's
    k_cell best by score, ties to the lower index (lax.approx_max_k off the
    TPU). Returns (top [n_cells, k_cell], abs_x, abs_y, avail [n_cells])."""
    H, W = lvl.shape
    need_h, need_w = border + rows * cellH, border + cols * cellW
    lvl = F.pad(lvl, (0, max(0, need_w - W), 0, max(0, need_h - H)))
    n_cells, area = rows * cols, cellH * cellW
    cells = (lvl[border:need_h, border:need_w]
             .reshape(rows, cellH, cols, cellW)
             .permute(0, 2, 1, 3)
             .reshape(n_cells, area))
    # threshold fallback: the reference retries a cell at th_min when FAST
    # at th_ini yields <= 3 corners (src/ORBextractor.cc:607-614)
    n_ini = (cells > th_ini).sum(1)
    cell_th = torch.where(n_ini > 3, th_ini, th_min)
    cells = torch.where(cells > cell_th[:, None], cells, 0.0)
    avail = (cells > 0.0).sum(1, dtype=torch.int32)
    fair = -(-quota // n_cells)
    k_cell = int(min(area, max(16, 4 * fair)))
    top, idx = top_k(cells, k_cell)
    cid = torch.arange(n_cells, device=lvl.device)[:, None]
    abs_y = border + (cid // cols) * cellH + idx // cellW
    abs_x = border + (cid % cols) * cellW + idx % cellW
    return top, abs_x, abs_y, avail


def _select_level(lvl: torch.Tensor, quota: int, rows: int, cols: int,
                  cellH: int, cellW: int, border: int, th_ini: float,
                  th_min: float):
    """`_level_pool` with the redistribution quota applied: scores of rank
    >= the cell's retained count are zeroed. Returns (pool
    [n_cells*k_cell], abs_x, abs_y), flattened."""
    top, abs_x, abs_y, avail = _level_pool(
        lvl, quota, rows, cols, cellH, cellW, border, th_ini, th_min)
    dev = lvl.device
    active = torch.ones((1, avail.shape[0]), dtype=torch.bool, device=dev)
    max_kp = torch.full((1,), quota, dtype=torch.int32, device=dev)
    retain = reference_quota(avail[None], max_kp, active)[0]
    rank = torch.arange(top.shape[1], device=dev)[None, :]
    top = torch.where(rank < retain[:, None], top, 0.0)
    return top.reshape(-1), abs_x.reshape(-1), abs_y.reshape(-1)


def detect_fast_keypoints(img: torch.Tensor, max_kp: int,
                          th_ini: float = 20.0, th_min: float = 7.0,
                          border: int = 16, use_harris: bool = False,
                          aspect_ratio: float | None = None):
    """FAST detection on one pyramid level [H, W] f32: the reference's
    quota-adaptive grid, per-cell threshold fallback, starved-cell quota
    redistribution and global retainBest cut (src/ORBextractor.cc:528-702).
    `use_harris` ranks by Harris response (nScoreType=0); `aspect_ratio` is
    the reference's imageRatio, the level-0 W/H (defaults to this image's).

    Returns (xy [max_kp, 2] int32 (x, y), score [max_kp] f32, valid
    [max_kp] bool)."""
    H, W = img.shape
    score = fast_score_map(img)
    keep = nms3x3(score)
    if use_harris:
        score, keep = harris_rank(score, keep, harris_score_map(img),
                                  th_ini, th_min)
    in_border = level_interior([(H, W)], H, W, border, img.device)[0]
    base = torch.where(keep & in_border, score, 0.0)
    ratio = aspect_ratio if aspect_ratio is not None else W / H
    rows, cols, cellH, cellW = reference_grid(H, W, max_kp, ratio, border)
    pool, abs_x, abs_y = _select_level(
        base, max_kp, rows, cols, cellH, cellW, border, th_ini, th_min)
    top_score, sel = top_k(pool, max_kp)           # global retainBest
    xy = torch.stack([abs_x[sel], abs_y[sel]], -1).to(torch.int32)
    return xy, top_score, top_score > 0.0
