"""Orientation-moment weights, the rBRIEF pattern layout and packing.

Port of the constants of orb_slam_tpu/ops/orb_descriptor.py (`PATCH`
:20, `_WX`/`_WY` :48, `_PAT` :92, `_RB_HALF`/`_RB_SIZE` :95-96) and of
`pack_u32` (:133). Descriptors are carried as int32 bit patterns of the
JAX package's uint32 words: torch's uint32 lacks shifts on the CPU, and an
int32 holds the same 32 bits (`np_u32.view(np.int32)`).
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


def pack_i32(desc_u8: torch.Tensor) -> torch.Tensor:
    """[K, 32] uint8 -> [K, 8] int32, little-endian within each word: the
    bit pattern of the JAX package's uint32 words."""
    d = desc_u8.to(torch.int64).reshape(-1, 8, 4)
    shifts = 8 * torch.arange(4, dtype=torch.int64, device=desc_u8.device)
    words = (d << shifts).sum(-1)
    return torch.where(words >= 2 ** 31, words - 2 ** 32, words).to(torch.int32)
