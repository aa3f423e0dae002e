"""FAST circle, the reference's cell grid and its quota redistribution.

Port of orb_slam_tpu/ops/fast.py: `FAST_CIRCLE` (:27), `reference_quota`
(:103-159) and `reference_grid` (:162-180). The FAST score itself lives in
ops/fast_stack.py and the score+NMS kernel in ops/fast_score_nms.py.
"""

from __future__ import annotations

import numpy as np
import torch

# Bresenham circle of radius 3 in circular order (dy, dx), as in the JAX
# package; tests/test_torch_constants.py asserts the copy is equal.
FAST_CIRCLE = np.array(
    [
        (-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
        (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1),
    ],
    dtype=np.int32,
)


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
