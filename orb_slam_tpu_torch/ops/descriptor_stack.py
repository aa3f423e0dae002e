"""Orientation and rBRIEF descriptors for all levels at once.

Port of orb_slam_tpu/ops/descriptor_stack.py: `rbrief_lut_table`
(:270-288), `lut_sample_indices` (:291-305), `quantize_angle` (:308-311)
and `angles_desc_fused` (:369-453) in its default `rowfirst` patch mode,
with the two-group quota split (:398-417): the extractor's default, one
patch pass. Also the stacked extractor's other two variants: without the
LUT (`desc_lut_bins=0`), `ic_angles_batch` (:167), `gaussian_blur_stack`
(:456) and `rbrief_batch` (:244) at continuous rotation; with
`patch_method="rowgather"`, `ic_angles_batch` and `rbrief_batch_lut`
(:334) over the blurred canvas. JAX's "onehot" (`extract_patches_batch`
:72) and "rowgather" (`extract_patches_batch_rowgather` :141) are two TPU
strategies for gathering the same patches, both exact selections of
bf16-rounded canvas values; here one gather (`extract_patches`) serves
both.

Where JAX runs gathers as one-hot matmuls (for the TPU's matrix unit),
this port gathers. The values are the same: a one-hot selection is exact,
so a patch value is the bf16-rounded canvas value in both. The moment sums
are f32 matmuls of bf16-valued operands, as in JAX (exact products; only
the summation order may differ). The descriptor bit of pair p in bin a is
`patch[idx[a, 2p+1]] > patch[idx[a, 2p]]`, the exact value of the JAX int8
LUT product `(patch - 128) . table[:, a*256+p] > 0`: each table column
holds one +1 and one -1 (tests/test_torch_constants.py shows the two
forms agree). The gather form needs no int8 matmul, which torch returns
in int8 and which would wrap.
"""

from __future__ import annotations

import numpy as np
import torch

from orb_slam_tpu_torch.ops.image import gaussian_kernel1d
from orb_slam_tpu_torch.ops.orb_descriptor import _PAT, _RB_HALF, _RB_SIZE, PATCH


def lut_sample_indices(n_bins: int = 30) -> np.ndarray:
    """[n_bins, 512] flattened within-patch sample index of each rotated
    pattern point per orientation bin (samples 2p / 2p+1 = pair p)."""
    px = _PAT[:, :, 0].reshape(512)
    py = _PAT[:, :, 1].reshape(512)
    out = np.zeros((n_bins, 512), np.int64)
    for a in range(n_bins):
        th = 2.0 * np.pi * a / n_bins
        ca, sa = np.cos(th), np.sin(th)
        col = np.round(px * ca - py * sa).astype(np.int64)
        row = np.round(px * sa + py * ca).astype(np.int64)
        r_in = np.clip(row + _RB_HALF, 0, _RB_SIZE - 1)
        c_in = np.clip(col + _RB_HALF, 0, _RB_SIZE - 1)
        out[a] = r_in * _RB_SIZE + c_in
    return out


def rbrief_lut_table(n_bins: int = 30) -> np.ndarray:
    """[39*39, n_bins*256] f32 rotated-pattern comparison table: column
    (a*256 + p) holds +1 at pair p's second sample and -1 at its first.
    The port samples with `lut_sample_indices` instead; the table is kept
    to show that the two forms agree."""
    idx = lut_sample_indices(n_bins)
    D = np.zeros((_RB_SIZE * _RB_SIZE, n_bins * 256), np.float32)
    for a in range(n_bins):
        for p in range(256):
            D[idx[a, 2 * p + 1], a * 256 + p] += 1.0
            D[idx[a, 2 * p], a * 256 + p] -= 1.0
    return D


def quantize_angle(angles: torch.Tensor, n_bins: int = 30) -> torch.Tensor:
    """Angle (radians) -> orientation bin in [0, n_bins)."""
    step = 2.0 * np.pi / n_bins
    return torch.remainder(torch.round(angles / step).to(torch.int64), n_bins)


def extract_patches(stack: torch.Tensor, xy_l: torch.Tensor,
                    level_hw: torch.Tensor, size: int) -> torch.Tensor:
    """[L, H, W] canvas, [L, Q, 2] level-local (x, y) -> [L, Q, size, size]
    f32 patches holding bf16-rounded canvas values; indices clamp within
    each level's true [0, h) x [0, w), given as level_hw [L, 2] int64
    (descriptor_stack.py:96-138)."""
    L, H, W = stack.shape
    dev = stack.device
    offs = torch.arange(size, device=dev) - size // 2
    xy = xy_l.to(torch.int64)
    rows = torch.minimum(torch.clamp(xy[:, :, 1:2] + offs, min=0),
                         level_hw[:, 0, None, None] - 1)        # [L, Q, S]
    cols = torch.minimum(torch.clamp(xy[:, :, 0:1] + offs, min=0),
                         level_hw[:, 1, None, None] - 1)
    lvl = torch.arange(L, device=dev)[:, None, None, None]
    flat = (lvl * H + rows[..., :, None]) * W + cols[..., None, :]
    return stack.reshape(-1)[flat].to(torch.bfloat16).to(torch.float32)


def _lut_descriptors(flat: torch.Tensor, angles: torch.Tensor,
                     lut_idx: torch.Tensor) -> torch.Tensor:
    """[L, Q, 32] uint8 from flattened [L, Q, 39*39] integer-valued
    patches: pair p's bit is sample 2p+1 > sample 2p of the pattern
    rotated to the angle's bin."""
    L, Q = flat.shape[0], flat.shape[1]
    n_bins = lut_idx.shape[0]
    samples = lut_idx[quantize_angle(angles, n_bins)]   # [L, Q, 512]
    vals = torch.gather(flat, 2, samples)
    bits = (vals[..., 1::2] > vals[..., 0::2]).to(torch.int32)
    shifts = torch.arange(8, device=flat.device, dtype=torch.int32)
    return (bits.reshape(L, Q, 32, 8) << shifts).sum(-1).to(torch.uint8)


def angles_desc_fused(stack: torch.Tensor, xy_l: torch.Tensor,
                      level_hw: torch.Tensor, lut_idx: torch.Tensor,
                      wx: torch.Tensor, wy: torch.Tensor, quotas=None):
    """(angles [L, Q] f32, desc [L, Q, 32] uint8) from one 45x45 patch per
    keypoint: IC-angle moments on its 31x31 centre, the 7x7 sigma-2 blur
    in-patch (45 -> 39), then rBRIEF sampling at the quantized angle.

    level_hw = the [L, 2] true level sizes, lut_idx = lut_sample_indices(n_bins)
    and wx, wy = _WX, _WY, all on the canvas's device (ORBExtractor
    buffers, so that a call copies nothing from the host).

    quotas: per-level quotas; when given, levels run in two groups split
    at L/2, each padded only to its group's quota, and slots past it come
    back as zeros (the JAX layout). JAX also crops each group's canvas to
    cut its one-hot matmuls; a gather gains nothing from that, and the
    clamped indices make the values the same."""
    L, Q = xy_l.shape[0], xy_l.shape[1]
    if quotas is not None and L > 1:
        L2 = L // 2
        q_hi, q_lo = max(quotas[:L2]), max(quotas[L2:])
        if q_lo < Q or q_hi < Q:
            angs, descs = [], []
            for a, b, qg in ((0, L2, q_hi), (L2, L, q_lo)):
                ag, dg = angles_desc_fused(
                    stack[a:b], xy_l[a:b, :qg], level_hw[a:b], lut_idx,
                    wx, wy)
                angs.append(torch.nn.functional.pad(ag, (0, Q - qg)))
                descs.append(torch.nn.functional.pad(dg, (0, 0, 0, Q - qg)))
            return torch.cat(angs, 0), torch.cat(descs, 0)

    S = _RB_SIZE + 6                                    # 45
    p45 = extract_patches(stack, xy_l, level_hw, S)     # [L, Q, 45, 45]
    m = (S - PATCH) // 2
    center = p45[:, :, m:m + PATCH, m:m + PATCH].reshape(L, Q, PATCH * PATCH)
    m10 = center @ wx.reshape(-1)
    m01 = center @ wy.reshape(-1)
    angles = torch.atan2(m01, m10)

    # separable blur in the JAX summation order ((0 + k0 p0) + k1 p1) + ...;
    # each weight is an f32 value, so the scalar products round as in JAX
    k = [float(v) for v in gaussian_kernel1d(7, 2.0)]
    rows = 0.0
    for i in range(7):
        rows = rows + k[i] * p45[:, :, i:i + _RB_SIZE, :]
    blurred = 0.0
    for i in range(7):
        blurred = blurred + k[i] * rows[:, :, :, i:i + _RB_SIZE]
    flat = torch.round(blurred).reshape(L, Q, _RB_SIZE * _RB_SIZE)
    return angles, _lut_descriptors(flat, angles, lut_idx)


def ic_angles_batch(stack: torch.Tensor, xy_l: torch.Tensor,
                    level_hw: torch.Tensor, wx: torch.Tensor,
                    wy: torch.Tensor) -> torch.Tensor:
    """[L, Q] orientations from 31x31 patches of the raw canvas
    (descriptor_stack.py:167-184): the moments of bf16-rounded pixel
    values, f32 sums."""
    L, Q = xy_l.shape[0], xy_l.shape[1]
    p = extract_patches(stack, xy_l, level_hw, PATCH).reshape(L, Q, PATCH * PATCH)
    return torch.atan2(p @ wy.reshape(-1), p @ wx.reshape(-1))


def gaussian_blur_stack(stack: torch.Tensor, ksize: int = 7,
                        sigma: float = 2.0) -> torch.Tensor:
    """Separable 7x7 blur over the [L, H, W] canvas, reflect padding at
    the canvas's edges (descriptor_stack.py:456-473): levels in the
    top-left corner see zeros past their true edge. The sums run in the
    JAX order, rows then columns, each ((0 + k0 p0) + k1 p1) + ..."""
    F = torch.nn.functional
    k = [float(v) for v in gaussian_kernel1d(ksize, sigma)]
    r = ksize // 2
    H, W = stack.shape[1], stack.shape[2]
    p = F.pad(stack, (0, 0, r, r), mode="reflect")
    out = 0.0
    for i in range(ksize):
        out = out + k[i] * p[:, i:i + H, :]
    p = F.pad(out, (r, r), mode="reflect")
    out2 = 0.0
    for i in range(ksize):
        out2 = out2 + k[i] * p[:, :, i:i + W]
    return out2


def rbrief_batch(blurred_stack: torch.Tensor, xy_l: torch.Tensor,
                 angles_l: torch.Tensor, level_hw: torch.Tensor,
                 pat: torch.Tensor) -> torch.Tensor:
    """[L, Q, 32] uint8 rBRIEF at continuous rotation from 39x39 patches
    of the blurred, rounded canvas (descriptor_stack.py:244-265): offsets
    rotated in f32 and rounded half to even; pair p's bit is
    I(A) < I(B). pat = `_PAT` [256, 2, 2] on the canvas's device."""
    L, Q = xy_l.shape[0], xy_l.shape[1]
    flat = extract_patches(blurred_stack, xy_l, level_hw, _RB_SIZE).reshape(
        L, Q, _RB_SIZE * _RB_SIZE)
    ca = torch.cos(angles_l)[..., None]
    sa = torch.sin(angles_l)[..., None]
    px, py = pat[:, :, 0].reshape(512), pat[:, :, 1].reshape(512)
    col = torch.round(px * ca - py * sa).to(torch.int64)
    row = torch.round(px * sa + py * ca).to(torch.int64)
    r_in = (row + _RB_HALF).clamp(0, _RB_SIZE - 1)
    c_in = (col + _RB_HALF).clamp(0, _RB_SIZE - 1)
    vals = torch.gather(flat, 2, r_in * _RB_SIZE + c_in)   # [L, Q, 512]
    bits = (vals[..., 0::2] < vals[..., 1::2]).to(torch.int32)
    shifts = torch.arange(8, device=flat.device, dtype=torch.int32)
    return (bits.reshape(L, Q, 32, 8) << shifts).sum(-1).to(torch.uint8)


def rbrief_batch_lut(blurred_stack: torch.Tensor, xy_l: torch.Tensor,
                     angles_l: torch.Tensor, level_hw: torch.Tensor,
                     lut_idx: torch.Tensor) -> torch.Tensor:
    """[L, Q, 32] uint8 rBRIEF at the angle's orientation bin from 39x39
    patches of the blurred, rounded canvas (descriptor_stack.py:334-366;
    the bit of JAX's int8 LUT product, as in `angles_desc_fused`)."""
    L, Q = xy_l.shape[0], xy_l.shape[1]
    flat = extract_patches(blurred_stack, xy_l, level_hw, _RB_SIZE).reshape(
        L, Q, _RB_SIZE * _RB_SIZE)
    return _lut_descriptors(flat, angles_l, lut_idx)
