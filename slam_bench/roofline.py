"""The least time each hand-written kernel could take on an H100, counted
from the cell's shapes.

A frozen copy of chip_smoke.py's yardstick (`bound_ms`, the published
H100 SXM peaks and the operation counts per pixel and per row). The work
is counted from the shapes the cell feeds the kernel, each input byte read
once and each output byte written once, never from how the kernel tiles
it, so the yardstick reads the same whatever implements the kernel.
"""

from __future__ import annotations

# published H100 SXM peaks (NVIDIA data sheet, 700 W): HBM3 bandwidth and
# f32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# operations per pixel: the FAST score at its leanest (two circular
# 9-window minima and maxima of the 16 circle pixels at 44 each, 15 + 15
# to combine the 16 arcs, the centre subtracted from the 2 results, one
# final max), the 3x3 non-maximum test (8 max + 1 compare) and the border
# mask (4 compares + 1 select)
FAST_SCORE_OPS = 2 * 44 + 2 * 15 + 2 + 1
NMS_OPS = 9
MASK_OPS = 5
# K2 per row and Gauss-Newton iteration: projection, residual, Huber
# weight, Jacobian and the 27 weighted sums of the normal equations
GN_OPS_PER_ROW_ITER = 150
# the tracking call of K2 (pipeline/track_kernels.py::track_frame): its
# rounds of Gauss-Newton iterations, and its rows, the matched features
# compacted to a multiple of 128
TRACK_GN_ITERS = (4, 3, 2, 2)
GN_ROW_BLOCK = 128


def bound_s(n_bytes: float, n_ops: float):
    """(least seconds, what sets it) for the given bytes and f32 ops."""
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = n_ops / F32_OPS_PER_S
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def pyramid_shapes(height: int, width: int, n_levels: int, scale_factor: float):
    """Per-level (H, W) sizes, rounded as the reference rounds them."""
    return [(max(8, int(round(height / scale_factor ** l))),
             max(8, int(round(width / scale_factor ** l))))
            for l in range(n_levels)]


def k1_work(shapes):
    """(bytes, ops) of K1, FAST score + NMS + border mask, over the level
    pixels of the canvas: each pixel read once and its score written."""
    px = sum(h * w for h, w in shapes)
    return 8 * px, px * (FAST_SCORE_OPS + NMS_OPS + MASK_OPS)


def k2_rows(n_features: int, p_local: int) -> int:
    """Rows of the tracking call of K2."""
    return min(-(-n_features // GN_ROW_BLOCK) * GN_ROW_BLOCK, p_local)


def k2_work(rows: int, iters=TRACK_GN_ITERS):
    """(bytes, ops) of K2: inputs T, K, points, pixels, 1/sigma^2 and the
    valid flags; outputs T, the inlier mask and its count."""
    n_bytes = 64 + 36 + rows * (12 + 8 + 4 + 1) + 64 + rows + 4
    return n_bytes, sum(iters) * rows * GN_OPS_PER_ROW_ITER


def roofline_pct(work, device_seconds_per_launch: float) -> float:
    """Share of the roofline, in %, of a kernel whose launches took
    `device_seconds_per_launch` on average for `work` = (bytes, ops)."""
    return 100.0 * bound_s(*work)[0] / device_seconds_per_launch
