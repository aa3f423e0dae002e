"""ORB feature extraction on one grayscale image.

Port of orb_slam_tpu/frontend/orb_extractor.py: `ORBConfig` (:35-76),
`ORBFeatures` (:79-111), `ORBExtractor` (:121-185) and `_extract_stacked`
(:188-278), in the form the main path runs it: FAST scoring through the
score+NMS kernel K1, and the one-pass angle + LUT-descriptor head. Harris
scoring and the per-level exact `_extract` path are not ported yet.

Pipeline: pyramid canvas -> K1 (FAST score, 3x3 NMS, border mask) ->
per-cell quota selection -> IC angle + rBRIEF -> level-0 coordinates.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from orb_slam_tpu_torch.ops.descriptor_stack import (
    angles_desc_fused, lut_sample_indices,
)
from orb_slam_tpu_torch.ops.fast_stack import (
    KeypointSelector, build_pyramid_stack, detect_keypoints_stack,
    pyramid_matrices,
)
from orb_slam_tpu_torch.ops.image import pyramid_shapes
from orb_slam_tpu_torch.ops.orb_descriptor import _WX, _WY, pack_i32


@dataclass(frozen=True)
class ORBConfig:
    n_features: int = 1000
    n_levels: int = 8
    scale_factor: float = 1.2
    fast_th_ini: float = 20.0
    fast_th_min: float = 7.0
    edge_threshold: int = 16
    cell_size: int = 32
    # reference nScoreType: 1 = FAST score; 0 (Harris) is not ported yet
    score_harris: bool = False
    # rBRIEF orientation bins of the LUT descriptor (2*pi/30 steps)
    desc_lut_bins: int = 30
    patch_method: str = "onehot"

    def level_quotas(self):
        """Geometric per-level feature quotas (src/ORBextractor.cc:476-487)."""
        f = 1.0 / self.scale_factor
        n0 = self.n_features * (1.0 - f) / (1.0 - f ** self.n_levels)
        quotas, total = [], 0
        for lvl in range(self.n_levels - 1):
            q = int(round(n0 * f ** lvl))
            quotas.append(q)
            total += q
        quotas.append(max(self.n_features - total, 0))
        return quotas

    def scale_factors(self):
        return [self.scale_factor ** l for l in range(self.n_levels)]

    def sigma2(self):
        return [s * s for s in self.scale_factors()]


@dataclass
class ORBFeatures:
    """Fixed-shape per-frame features (N = config.n_features):
      xy        [N, 2] f32   level-0 (distorted) pixel coordinates, -1 if invalid
      response  [N]    f32
      angle     [N]    f32   radians
      octave    [N]    int32 pyramid level
      desc_u8   [N, 32] uint8 OpenCV-layout rBRIEF
      desc_i32  [N, 8]  int32 bit patterns of the JAX uint32 words
      valid     [N]    bool
    """

    xy: torch.Tensor
    response: torch.Tensor
    angle: torch.Tensor
    octave: torch.Tensor
    desc_u8: torch.Tensor
    desc_i32: torch.Tensor
    valid: torch.Tensor


class ORBExtractor(torch.nn.Module):
    """Extractor for [height, width] float32 images in [0, 255].

    Buffers: the pyramid matrices (Rp, Cp), the LUT sample indices, the
    moment weights and the per-level tables of the keypoint selector, so
    `.to(device)` moves everything a call needs and a call copies nothing
    from the host."""

    def __init__(self, config: ORBConfig = ORBConfig(), height: int = 480,
                 width: int = 640):
        super().__init__()
        if config.score_harris:
            raise NotImplementedError("Harris scoring is not ported yet")
        if not config.desc_lut_bins or config.patch_method != "onehot":
            raise NotImplementedError(
                "only the LUT descriptor with one-pass patches is ported")
        self.config = config
        self.height, self.width = height, width
        self.shapes = pyramid_shapes(height, width, config.n_levels,
                                     config.scale_factor)
        self.quotas = config.level_quotas()
        Rp, Cp = pyramid_matrices(height, width, config.n_levels,
                                  config.scale_factor)
        self.register_buffer("Rp", torch.from_numpy(Rp))
        self.register_buffer("Cp", torch.from_numpy(Cp))
        self.register_buffer(
            "lut_idx", torch.from_numpy(lut_sample_indices(config.desc_lut_bins)))
        self.register_buffer("wx", torch.from_numpy(_WX))
        self.register_buffer("wy", torch.from_numpy(_WY))
        self.register_buffer("level_hw", torch.tensor(self.shapes))
        self.register_buffer("level_scale", torch.tensor(
            np.asarray(config.scale_factors(), np.float32)))
        self.selector = KeypointSelector(
            self.shapes, self.quotas, th_ini=config.fast_th_ini,
            th_min=config.fast_th_min, border=config.edge_threshold)

    def forward(self, img: torch.Tensor) -> ORBFeatures:
        if tuple(img.shape) != (self.height, self.width):
            raise ValueError(f"image {tuple(img.shape)} != extractor "
                             f"{(self.height, self.width)}")
        return _extract_stacked(self, img.to(torch.float32))


def _extract_stacked(ex: ORBExtractor, img: torch.Tensor) -> ORBFeatures:
    """The stacked extraction of one image (orb_extractor.py:188-278)."""
    stack = build_pyramid_stack(img, ex.Rp, ex.Cp)
    xy_l, score_l, valid_l = detect_keypoints_stack(stack, ex.selector)
    angle_l, desc_l = angles_desc_fused(stack, xy_l, ex.level_hw, ex.lut_idx,
                                        ex.wx, ex.wy, quotas=ex.quotas)
    keep = [(l, q) for l, q in enumerate(ex.quotas) if q > 0]
    xy = torch.cat([xy_l[l, :q] for l, q in keep])
    resp = torch.cat([score_l[l, :q] for l, q in keep])
    valid = torch.cat([valid_l[l, :q] for l, q in keep])
    angle = torch.cat([angle_l[l, :q] for l, q in keep])
    desc_u8 = torch.cat([desc_l[l, :q] for l, q in keep])
    octave = torch.cat([torch.full((q,), l, dtype=torch.int32, device=img.device)
                        for l, q in keep])
    xy_f = xy.to(torch.float32) * ex.level_scale[octave][:, None]
    xy_f = torch.where(valid[:, None], xy_f, -1.0)
    return ORBFeatures(xy_f, resp, angle, octave, desc_u8, pack_i32(desc_u8),
                       valid)
