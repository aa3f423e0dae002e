"""Per-level orientation and continuous-rotation rBRIEF, their constants
and descriptor packing.

Port of orb_slam_tpu/ops/orb_descriptor.py: the constants (`PATCH` :20,
`_WX`/`_WY` :48, `_PAT` :92, `_RB_HALF`/`_RB_SIZE` :95-96),
`gather_patches` (:53-77), `ic_angles` (:80-90), `rbrief_descriptors`
(:100-130) and `pack_u32` (:133). Descriptors are carried as int32 bit
patterns of the JAX package's uint32 words: torch's uint32 lacks shifts on
the CPU, and an int32 holds the same 32 bits (`np_u32.view(np.int32)`).

Where JAX gathers patches as bf16 one-hot matmuls (for the TPU's matrix
unit), this port gathers: a one-hot selection is exact, so a patch value
is the bf16-rounded image value in both.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from orb_slam_tpu_torch.ops.orb_pattern import ORB_PATTERN

HALF_PATCH = 15
PATCH = 31


def _umax() -> np.ndarray:
    """Circular-patch row bounds (src/ORBextractor.cc:493-510)."""
    umax = np.zeros(HALF_PATCH + 1, np.int32)
    vmax = int(math.floor(HALF_PATCH * math.sqrt(2.0) / 2 + 1))
    vmin = int(math.ceil(HALF_PATCH * math.sqrt(2.0) / 2))
    hp2 = HALF_PATCH * HALF_PATCH
    for v in range(vmax + 1):
        umax[v] = int(round(math.sqrt(hp2 - v * v)))
    v0 = 0
    for v in range(HALF_PATCH, vmin - 1, -1):
        while umax[v0] == umax[v0 + 1]:
            v0 += 1
        umax[v] = v0
        v0 += 1
    return umax


def _moment_weights():
    """[31, 31] x/y moment weights over the circular patch."""
    um = _umax()
    dy, dx = np.mgrid[-HALF_PATCH:HALF_PATCH + 1, -HALF_PATCH:HALF_PATCH + 1]
    mask = np.abs(dx) <= um[np.abs(dy)]
    return (dx * mask).astype(np.float32), (dy * mask).astype(np.float32)


_WX, _WY = _moment_weights()

# pattern as float32 [256 pairs, 2 points, (x, y)]
_PAT = ORB_PATTERN.astype(np.float32).reshape(256, 2, 2)
_RB_HALF = 19               # max rotated offset: ceil(13 * sqrt(2))
_RB_SIZE = 2 * _RB_HALF + 1  # 39


def gather_patches(img: torch.Tensor, xy: torch.Tensor, size: int):
    """[K, size, size] patches of [H, W] centred at integer xy [K, 2] (x, y),
    indices clamped to the image, values rounded to bf16."""
    H, W = img.shape
    offs = torch.arange(size, device=img.device) - size // 2
    xy = xy.to(torch.int64)
    rows = (xy[:, 1:2] + offs).clamp(0, H - 1)                # [K, size]
    cols = (xy[:, 0:1] + offs).clamp(0, W - 1)
    patches = img[rows[:, :, None], cols[:, None, :]]
    return patches.to(torch.bfloat16).to(torch.float32)


def ic_angles(img: torch.Tensor, xy: torch.Tensor, wx: torch.Tensor = None,
              wy: torch.Tensor = None) -> torch.Tensor:
    """Intensity-centroid orientation [K] (radians) of keypoints xy [K, 2]
    on the unblurred level image [H, W] (src/ORBextractor.cc:718-744).
    wx, wy: `_WX`, `_WY` as tensors on the image's device (built here when
    not given)."""
    if wx is None:
        wx, wy = (torch.from_numpy(w).to(img.device) for w in (_WX, _WY))
    patches = gather_patches(img, xy, PATCH).reshape(xy.shape[0], -1)
    m10 = patches @ wx.reshape(-1)
    m01 = patches @ wy.reshape(-1)
    return torch.atan2(m01, m10)


def rbrief_descriptors(blurred: torch.Tensor, xy: torch.Tensor,
                       angles: torch.Tensor, pat: torch.Tensor = None):
    """256-bit rBRIEF at continuous rotation: [K, 32] uint8 in OpenCV's
    layout (byte i, bit j is pattern pair 8i+j; set iff I(pA) < I(pB)).
    blurred: the blurred level image [H, W], rounded to integers; xy [K, 2]
    int keypoint centres; angles [K] radians; pat: `_PAT` as a tensor on the
    image's device (built here when not given). Offsets rotate and round
    half to even as the reference's cvRound."""
    if pat is None:
        pat = torch.from_numpy(_PAT).to(blurred.device)
    K = xy.shape[0]
    ca = torch.cos(angles)[:, None, None]
    sa = torch.sin(angles)[:, None, None]
    px, py = pat[None, :, :, 0], pat[None, :, :, 1]           # [1, 256, 2]
    col = torch.round(px * ca - py * sa).to(torch.int64)
    row = torch.round(px * sa + py * ca).to(torch.int64)
    r_in = (row + _RB_HALF).clamp(0, _RB_SIZE - 1)
    c_in = (col + _RB_HALF).clamp(0, _RB_SIZE - 1)
    flat_idx = (r_in * _RB_SIZE + c_in).reshape(K, 512)
    patches = gather_patches(blurred, xy, _RB_SIZE).reshape(K, -1)
    vals = torch.gather(patches, 1, flat_idx)
    bits = (vals[:, 0::2] < vals[:, 1::2]).to(torch.int32).reshape(K, 32, 8)
    shifts = torch.arange(8, device=blurred.device, dtype=torch.int32)
    return (bits << shifts).sum(-1).to(torch.uint8)


def pack_i32(desc_u8: torch.Tensor) -> torch.Tensor:
    """[K, 32] uint8 -> [K, 8] int32, little-endian within each word: the
    bit pattern of the JAX package's uint32 words."""
    d = desc_u8.to(torch.int64).reshape(-1, 8, 4)
    shifts = 8 * torch.arange(4, dtype=torch.int64, device=desc_u8.device)
    words = (d << shifts).sum(-1)
    return torch.where(words >= 2 ** 31, words - 2 ** 32, words).to(torch.int32)
