"""ORB feature extraction on one grayscale image.

Port of orb_slam_tpu/frontend/orb_extractor.py: `ORBConfig` (:35-76),
`ORBFeatures` (:79-111), `ORBExtractor` (:121-185), `_extract_stacked`
(:188-278) and `_extract` (:281-325).

Stacked (the default): pyramid canvas -> FAST detection -> per-cell quota
selection -> IC angle + LUT rBRIEF from one patch pass -> level-0
coordinates. The detection is kernel K1 (score, NMS and border mask) for
the FAST score (nScoreType=1), and kernel K3 (score and NMS) followed by
the Harris ranking for nScoreType=0 (`score_harris`), the XLA detector
the JAX extractor runs for Harris on every backend. The stacked
descriptors route as JAX's (orb_extractor.py:235-250): the LUT with
`patch_method="onehot"` takes the one-pass `angles_desc_fused`; any other
setting takes `ic_angles_batch` on the canvas and, on the canvas blurred
by `gaussian_blur_stack` and rounded, `rbrief_batch_lut` (the LUT) or
`rbrief_batch` (`desc_lut_bins=0`, continuous rotation).

Per level (`stacked=False`, the cv2-exact oracle of the JAX tests): each
level resized from the previous one, FAST (or Harris) detection on it,
IC angle, 7x7 blur and continuous-rotation rBRIEF.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from orb_slam_tpu_torch.device import require_device
from orb_slam_tpu_torch.ops.descriptor_stack import (
    angles_desc_fused, gaussian_blur_stack, ic_angles_batch,
    lut_sample_indices, rbrief_batch, rbrief_batch_lut,
)
from orb_slam_tpu_torch.ops.fast import detect_fast_keypoints
from orb_slam_tpu_torch.ops.fast_stack import (
    KeypointSelector, build_pyramid_stack, detect_keypoints_packed,
    detect_keypoints_stack, pyramid_matrices,
)
from orb_slam_tpu_torch.ops.image import build_pyramid, gaussian_blur, pyramid_shapes
from orb_slam_tpu_torch.ops.orb_descriptor import (
    _PAT, _WX, _WY, ic_angles, pack_i32, rbrief_descriptors,
)


@dataclass(frozen=True)
class ORBConfig:
    n_features: int = 1000
    n_levels: int = 8
    scale_factor: float = 1.2
    fast_th_ini: float = 20.0
    fast_th_min: float = 7.0
    edge_threshold: int = 16
    cell_size: int = 32
    # reference nScoreType: 1 = FAST score (default), 0 = Harris ranking
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
    """Extractor for [height, width] float32 images in [0, 255], built on
    `device` (the card unless the caller names another).

    stacked=True (default): all levels as one [L, H, W] canvas (the main
    path); stacked=False: the per-level pipeline.

    Buffers: the pyramid matrices (Rp, Cp), the LUT sample indices (or
    the rBRIEF pattern without the LUT), the moment weights and the
    per-level tables of the keypoint selector, so a call copies nothing
    from the host."""

    def __init__(self, config: ORBConfig = ORBConfig(), height: int = 480,
                 width: int = 640, stacked: bool = True, device="cuda"):
        super().__init__()
        device = require_device(device)
        self.config = config
        self.stacked = stacked
        self.height, self.width = height, width
        self.shapes = pyramid_shapes(height, width, config.n_levels,
                                     config.scale_factor)
        self.quotas = config.level_quotas()
        self.register_buffer("wx", torch.from_numpy(_WX))
        self.register_buffer("wy", torch.from_numpy(_WY))
        self.register_buffer("level_scale", torch.tensor(
            np.asarray(config.scale_factors(), np.float32)))
        if stacked:
            Rp, Cp = pyramid_matrices(height, width, config.n_levels,
                                      config.scale_factor)
            self.register_buffer("Rp", torch.from_numpy(Rp))
            self.register_buffer("Cp", torch.from_numpy(Cp))
            if config.desc_lut_bins:
                self.register_buffer("lut_idx", torch.from_numpy(
                    lut_sample_indices(config.desc_lut_bins)))
            self.register_buffer("level_hw", torch.tensor(self.shapes))
            self.selector = KeypointSelector(
                self.shapes, self.quotas, th_ini=config.fast_th_ini,
                th_min=config.fast_th_min, border=config.edge_threshold,
                device=device)
        if not (stacked and config.desc_lut_bins):
            self.register_buffer("pat", torch.from_numpy(_PAT))
        self.to(device)

    def forward(self, img: torch.Tensor) -> ORBFeatures:
        if tuple(img.shape) != (self.height, self.width):
            raise ValueError(f"image {tuple(img.shape)} != extractor "
                             f"{(self.height, self.width)}")
        img = img.to(torch.float32)
        return _extract_stacked(self, img) if self.stacked else _extract(self, img)


def _extract_stacked(ex: ORBExtractor, img: torch.Tensor) -> ORBFeatures:
    """The stacked extraction of one image (orb_extractor.py:188-278)."""
    stack = build_pyramid_stack(img, ex.Rp, ex.Cp)
    if ex.config.score_harris:
        xy_l, score_l, valid_l = detect_keypoints_stack(stack, ex.selector,
                                                        use_harris=True)
    else:
        xy_l, score_l, valid_l = detect_keypoints_packed(stack, ex.selector)
    cfg = ex.config
    if cfg.desc_lut_bins and cfg.patch_method == "onehot":
        angle_l, desc_l = angles_desc_fused(stack, xy_l, ex.level_hw, ex.lut_idx,
                                            ex.wx, ex.wy, quotas=ex.quotas)
    else:
        angle_l = ic_angles_batch(stack, xy_l, ex.level_hw, ex.wx, ex.wy)
        blurred = torch.round(gaussian_blur_stack(stack))
        if cfg.desc_lut_bins:
            desc_l = rbrief_batch_lut(blurred, xy_l, angle_l, ex.level_hw,
                                      ex.lut_idx)
        else:
            desc_l = rbrief_batch(blurred, xy_l, angle_l, ex.level_hw, ex.pat)
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


def _extract(ex: ORBExtractor, img: torch.Tensor) -> ORBFeatures:
    """The per-level extraction of one image (orb_extractor.py:281-325)."""
    cfg = ex.config
    levels = build_pyramid(img, cfg.n_levels, cfg.scale_factor)
    parts = []
    for lvl, (level_img, quota, scale) in enumerate(
            zip(levels, ex.quotas, cfg.scale_factors())):
        if quota == 0:
            continue
        xy, resp, valid = detect_fast_keypoints(
            level_img, quota, th_ini=cfg.fast_th_ini, th_min=cfg.fast_th_min,
            border=cfg.edge_threshold, use_harris=cfg.score_harris,
            # the reference's imageRatio is the level-0 aspect on every level
            # (src/ORBextractor.cc:527)
            aspect_ratio=float(img.shape[1]) / float(img.shape[0]))
        angle = ic_angles(level_img, xy, ex.wx, ex.wy)
        # blurred image rounded to integers: cv2's uint8 rounding after
        # GaussianBlur, which makes descriptors bit-exact against OpenCV
        blurred = torch.round(gaussian_blur(level_img))
        desc = rbrief_descriptors(blurred, xy, angle, ex.pat)
        octave = torch.full((quota,), lvl, dtype=torch.int32, device=img.device)
        parts.append((xy.to(torch.float32) * scale, resp, angle, octave, desc,
                      valid))
    xy, resp, angle, octave, desc_u8, valid = (torch.cat(p) for p in zip(*parts))
    xy = torch.where(valid[:, None], xy, -1.0)
    return ORBFeatures(xy, resp, angle, octave, desc_u8, pack_i32(desc_u8),
                       valid)
