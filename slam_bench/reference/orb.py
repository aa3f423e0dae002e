"""Plain ORB extraction, the benchmark's reference for the program's
extractor.

A frozen copy, in plain PyTorch and numpy, of the stacked extraction the
program runs on every frame (orb_slam_tpu_torch/frontend/orb_extractor.py
with ops/fast_stack.py, ops/fast.py, ops/descriptor_stack.py,
ops/orb_descriptor.py, ops/image.py and ops/sort.py): the level canvas
through bf16 bilinear matrices, the FAST score with the 3x3 maximum and
the border mask (what kernel K1 computes) or the FAST score with the 3x3
maximum over the whole canvas (kernel K3) and the Harris ranking
(nScoreType 0), the per-cell threshold fallback, the starved-cell quota
redistribution and retainBest, the intensity-centroid angle and the LUT
rBRIEF descriptor from one 45x45 patch. It imports nothing of the program
and builds its own tables from the configuration's numbers.

`Extractor(..., control=True)` is the control of the comparison: every
stage's result is rounded to bfloat16, the precision below the float32
the configuration states, as a change that computed the extraction in
bf16 would round it.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from slam_bench.reference.orb_pattern import ORB_PATTERN

# ORB-SLAM's constants the settings file does not carry: minThFAST, the
# border the detector keeps clear, the rBRIEF orientation bins of the LUT
FAST_TH_MIN = 7.0
EDGE_THRESHOLD = 16
LUT_BINS = 30
# Bresenham circle of radius 3 in circular order (dy, dx)
FAST_CIRCLE = [(-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2),
               (3, 1), (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3),
               (-2, -2), (-3, -1)]
HALF_PATCH = 15
PATCH = 31
RB_HALF = 19                  # max rotated pattern offset: ceil(13 sqrt 2)
RB_SIZE = 2 * RB_HALF + 1     # 39
PAT = ORB_PATTERN.astype(np.float32).reshape(256, 2, 2)


def bf16(x: torch.Tensor) -> torch.Tensor:
    """The value a bf16 operand has, as float32."""
    return x.to(torch.bfloat16).to(torch.float32)


def level_quotas(n_features: int, n_levels: int, scale_factor: float):
    """Geometric per-level feature quotas (src/ORBextractor.cc:476-487)."""
    f = 1.0 / scale_factor
    n0 = n_features * (1.0 - f) / (1.0 - f ** n_levels)
    quotas, total = [], 0
    for lvl in range(n_levels - 1):
        q = int(round(n0 * f ** lvl))
        quotas.append(q)
        total += q
    quotas.append(max(n_features - total, 0))
    return quotas


def pyramid_shapes(height, width, n_levels, scale_factor):
    shapes = []
    for lvl in range(n_levels):
        s = 1.0 / (scale_factor ** lvl)
        shapes.append((max(8, int(round(height * s))),
                       max(8, int(round(width * s)))))
    return shapes


def _bilinear_matrix(n_in: int, n_out: int) -> np.ndarray:
    scale = n_in / n_out
    src = (np.arange(n_out) + 0.5) * scale - 0.5
    i0 = np.clip(np.floor(src).astype(np.int64), 0, n_in - 1)
    i1 = np.clip(i0 + 1, 0, n_in - 1)
    w1 = np.clip(src - i0, 0.0, 1.0)
    M = np.zeros((n_out, n_in), np.float32)
    M[np.arange(n_out), i0] += 1.0 - w1
    M[np.arange(n_out), i1] += w1
    return M


def pyramid_matrices(height, width, n_levels, scale_factor):
    """Level-0 -> level-l bilinear matrices Rp [L-1, H, H], Cp [L-1, W, W]."""
    shapes = pyramid_shapes(height, width, n_levels, scale_factor)
    Rs = [np.eye(height, dtype=np.float32)]
    Cs = [np.eye(width, dtype=np.float32)]
    for lvl in range(1, n_levels):
        h0, w0 = shapes[lvl - 1]
        h1, w1 = shapes[lvl]
        Rs.append(_bilinear_matrix(h0, h1) @ Rs[-1])
        Cs.append(_bilinear_matrix(w0, w1) @ Cs[-1])
    Rp = np.zeros((n_levels - 1, height, height), np.float32)
    Cp = np.zeros((n_levels - 1, width, width), np.float32)
    for lvl in range(1, n_levels):
        Rp[lvl - 1, :Rs[lvl].shape[0]] = Rs[lvl]
        Cp[lvl - 1, :Cs[lvl].shape[0]] = Cs[lvl]
    return Rp, Cp


def top_k(x: torch.Tensor, k: int):
    """The k largest along the last axis, ties to the lower index."""
    n = x.shape[-1]
    idx = torch.arange(n, dtype=torch.int64, device=x.device)
    b = x.to(torch.float32).contiguous().view(torch.int32).to(torch.int64)
    key = (torch.where(b < 0, b ^ 0x7FFFFFFF, b) << 32) | (n - 1 - idx)
    _, sel = torch.topk(key, k, dim=-1)
    return torch.gather(x, -1, sel), sel


def fast_score(stack: torch.Tensor) -> torch.Tensor:
    """[L, H, W] -> FAST scores, the canvas edge-padded by 3: the max over
    the 16 circular 9-arcs of the arc minimum of (neighbour - centre), or
    of (centre - neighbour) for dark arcs."""
    L, H, W = stack.shape
    padded = F.pad(stack[None], (3, 3, 3, 3), mode="replicate")[0]
    D = torch.stack([padded[:, 3 + dy:3 + dy + H, 3 + dx:3 + dx + W]
                     for dy, dx in FAST_CIRCLE], 1) - stack[:, None]

    def run9(op, x):
        r2 = op(x, torch.roll(x, -1, 1))
        r4 = op(r2, torch.roll(r2, -2, 1))
        r8 = op(r4, torch.roll(r4, -4, 1))
        return op(r8, torch.roll(x, -8, 1))

    bright = run9(torch.minimum, D).amax(1)
    dark = -run9(torch.maximum, D).amin(1)
    return torch.maximum(bright, dark)


def level_interior(shapes, H, W, border, device):
    ys = torch.arange(H, device=device)[:, None]
    xs = torch.arange(W, device=device)[None, :]
    return torch.stack([(ys >= border) & (ys < h - border)
                        & (xs >= border) & (xs < w - border) for h, w in shapes])


def harris_response(img: torch.Tensor, k: float = 0.04, block: int = 7):
    """Harris response of [L, H, W] planes scaled as OpenCV's
    HarrisResponses, the sums in the order of the program's."""
    L, H, W = img.shape
    p = F.pad(img[:, None], (1, 1, 1, 1), mode="replicate")[:, 0]
    gx = ((p[:, 0:-2, 2:] + 2.0 * p[:, 1:-1, 2:] + p[:, 2:, 2:])
          - (p[:, 0:-2, 0:-2] + 2.0 * p[:, 1:-1, 0:-2] + p[:, 2:, 0:-2]))
    gy = ((p[:, 2:, 0:-2] + 2.0 * p[:, 2:, 1:-1] + p[:, 2:, 2:])
          - (p[:, 0:-2, 0:-2] + 2.0 * p[:, 0:-2, 1:-1] + p[:, 0:-2, 2:]))
    r = block // 2
    q = F.pad(torch.stack([gx * gx, gy * gy, gx * gy]), (r, r, r, r))
    box = torch.zeros((3,) + gx.shape, dtype=img.dtype, device=img.device)
    for i in range(block):
        for j in range(block):
            box.add_(q[:, :, i:i + H, j:j + W])
    A, B, C = box
    scale = (1.0 / (4 * 255 * block)) ** 4
    trace = A + B
    return (A * B - C * C - k * (trace * trace)) * scale


def _ceil_div(a, b):
    return -torch.div(-a, b, rounding_mode="floor")


def reference_quota(avail, max_kp, active):
    """Per-cell retained counts of the starved-cell redistribution loop
    (src/ORBextractor.cc:644-670), C passes over [L, C] cells."""
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


def reference_grid(h, w, quota, aspect_ratio, border):
    """The quota-adaptive cell grid (src/ORBextractor.cc:528-543)."""
    Wb = max(1, w - 2 * border)
    Hb = max(1, h - 2 * border)
    cols = int(np.sqrt(quota / (5.0 * aspect_ratio)))
    rows = int(aspect_ratio * cols)
    cols = max(1, min(cols, Wb))
    rows = max(1, min(rows, Hb))
    return rows, cols, -(-Hb // rows), -(-Wb // cols)


def _umax():
    umax = np.zeros(HALF_PATCH + 1, np.int32)
    vmax = int(math.floor(HALF_PATCH * math.sqrt(2.0) / 2 + 1))
    vmin = int(math.ceil(HALF_PATCH * math.sqrt(2.0) / 2))
    for v in range(vmax + 1):
        umax[v] = int(round(math.sqrt(HALF_PATCH * HALF_PATCH - v * v)))
    v0 = 0
    for v in range(HALF_PATCH, vmin - 1, -1):
        while umax[v0] == umax[v0 + 1]:
            v0 += 1
        umax[v] = v0
        v0 += 1
    return umax


def moment_weights():
    """[31, 31] x and y moment weights over the circular patch."""
    um = _umax()
    dy, dx = np.mgrid[-HALF_PATCH:HALF_PATCH + 1, -HALF_PATCH:HALF_PATCH + 1]
    mask = np.abs(dx) <= um[np.abs(dy)]
    return (dx * mask).astype(np.float32), (dy * mask).astype(np.float32)


def lut_sample_indices(n_bins: int) -> np.ndarray:
    """[n_bins, 512] in-patch sample index of each rotated pattern point."""
    px = PAT[:, :, 0].reshape(512)
    py = PAT[:, :, 1].reshape(512)
    out = np.zeros((n_bins, 512), np.int64)
    for a in range(n_bins):
        th = 2.0 * np.pi * a / n_bins
        ca, sa = np.cos(th), np.sin(th)
        col = np.round(px * ca - py * sa).astype(np.int64)
        row = np.round(px * sa + py * ca).astype(np.int64)
        out[a] = (np.clip(row + RB_HALF, 0, RB_SIZE - 1) * RB_SIZE
                  + np.clip(col + RB_HALF, 0, RB_SIZE - 1))
    return out


def gaussian_kernel1d(ksize=7, sigma=2.0):
    x = np.arange(ksize) - (ksize - 1) / 2.0
    k = np.exp(-(x * x) / (2.0 * sigma * sigma))
    return (k / k.sum()).astype(np.float32)


def pack_i32(desc_u8: torch.Tensor) -> torch.Tensor:
    """[K, 32] uint8 -> [K, 8] int32 little-endian words."""
    d = desc_u8.to(torch.int64).reshape(-1, 8, 4)
    shifts = 8 * torch.arange(4, dtype=torch.int64, device=desc_u8.device)
    words = (d << shifts).sum(-1)
    return torch.where(words >= 2 ** 31, words - 2 ** 32, words).to(torch.int32)


class Extractor:
    """The reference extraction of [H, W] float32 frames on `device`.
    Returns a dict of xy [N, 2] (level-0 pixels, -1 where invalid), angle
    [N], octave [N] int32, desc [N, 8] int32 words and valid [N] bool,
    the field layout of the program's ORBFeatures."""

    def __init__(self, n_features, n_levels, scale_factor, fast_th,
                 score_harris, height, width, device, control=False):
        self.device = torch.device(device)
        self.rnd = bf16 if control else (lambda x: x)
        self.th_ini, self.th_min, self.border = float(fast_th), FAST_TH_MIN, EDGE_THRESHOLD
        self.harris = bool(score_harris)
        self.H, self.W = height, width
        self.shapes = pyramid_shapes(height, width, n_levels, scale_factor)
        self.quotas = level_quotas(n_features, n_levels, scale_factor)
        t = lambda a: torch.as_tensor(a).to(self.device)
        Rp, Cp = pyramid_matrices(height, width, n_levels, scale_factor)
        self.Rp, self.Cp = t(Rp), t(Cp)
        self.level_scale = t(np.asarray([scale_factor ** l for l in range(n_levels)],
                                        np.float32))
        self.level_hw = t(np.asarray(self.shapes, np.int64))
        wx, wy = moment_weights()
        self.wx, self.wy = t(wx), t(wy)
        self.lut_idx = t(lut_sample_indices(LUT_BINS))
        ratio = self.shapes[0][1] / self.shapes[0][0]
        self.grids = [reference_grid(h, w, q, ratio, self.border)
                      for (h, w), q in zip(self.shapes, self.quotas)]
        self.k_tots = [int(min(rows * cH * cols * cW, 2 * q))
                       for (rows, cols, cH, cW), q in zip(self.grids, self.quotas)]
        n_real = torch.tensor([r * c for r, c, _, _ in self.grids])
        self.quota_t = t(np.asarray(self.quotas, np.int32))
        self.active = t(torch.arange(int(n_real.max()))[None, :] < n_real[:, None])

    def canvas(self, img):
        """[L, H, W]: level 0 is the image; levels >= 1 are
        bf16(bf16(Rp) @ bf16(img)) @ bf16(Cp)^T with f32 sums."""
        img = self.rnd(img)
        rows = bf16(self.Rp) @ bf16(img)
        rest = bf16(rows) @ bf16(self.Cp).transpose(1, 2)
        return self.rnd(torch.cat([img[None], rest], 0))

    def masked_scores(self, stack):
        """FAST score, 0 off the 3x3 maxima and outside each level's
        border; with the Harris ranking for nScoreType 0."""
        L, H, W = stack.shape
        inner = level_interior(self.shapes, H, W, self.border, stack.device)
        if not self.harris:
            halo = F.pad(stack[None], (1, 1, 1, 1), mode="replicate")[0]
            score = self.rnd(fast_score(halo))
            mx = F.max_pool2d(score[None], 3, stride=1)[0]
            center = score[:, 1:1 + H, 1:1 + W]
            return torch.where((center >= mx) & inner, center, 0.0)
        score = self.rnd(fast_score(stack))
        keep = score >= F.max_pool2d(score[None], 3, stride=1, padding=1)[0]
        resp = self.rnd(harris_response(stack))
        passing = score > self.th_min
        shifted = torch.clamp(resp - resp.min(), min=1e-6) + self.th_ini + 1.0
        score = self.rnd(torch.where(passing, shifted, score))
        return torch.where(keep & passing & inner, score, 0.0)

    def select(self, base):
        """(xy [L, Q, 2] int32 level-local, valid [L, Q]): the per-cell
        threshold fallback, the redistribution and retainBest."""
        L, H, W = base.shape
        dev, border = base.device, self.border
        base = base.clone()
        for l, (h, w) in enumerate(self.shapes):
            base[l, h:] = 0.0
            base[l, :, w:] = 0.0
        P, C = max(self.k_tots), self.active.shape[1]
        vals, pxs, pys, cellids, ranks, avails = [], [], [], [], [], []
        for l, ((rows, cols, cellH, cellW), k_tot) in enumerate(
                zip(self.grids, self.k_tots)):
            RH, RW = rows * cellH, cols * cellW
            region = base[l, border:min(border + RH, H), border:min(border + RW, W)]
            region = F.pad(region, (0, RW - region.shape[1], 0, RH - region.shape[0]))
            cells4 = region.reshape(rows, cellH, cols, cellW)
            n_ini = (cells4 > self.th_ini).sum((1, 3))
            cell_th = torch.where(n_ini > 3, self.th_ini, self.th_min)
            masked4 = torch.where(cells4 > cell_th[:, None, :, None], cells4, 0.0)
            avail = (masked4 > 0.0).sum((1, 3), dtype=torch.int32)
            val, idx = top_k(masked4.reshape(RH * RW), k_tot)
            y, x = idx // RW, idx % RW
            ci = (y // cellH) * cols + x // cellW
            ci = torch.where(val > 0.0, ci, rows * cols)
            ci, order = torch.sort(ci, stable=True)
            val, x, y = val[order], x[order], y[order]
            ar = torch.arange(k_tot, device=dev)
            first = torch.ones(k_tot, dtype=torch.bool, device=dev)
            first[1:] = ci[1:] != ci[:-1]
            rank = ar - torch.cummax(torch.where(first, ar, 0), 0).values
            pad = P - k_tot
            vals.append(F.pad(val, (0, pad)))
            pxs.append(F.pad(x + border, (0, pad)))
            pys.append(F.pad(y + border, (0, pad)))
            cellids.append(F.pad(torch.clamp(ci, max=rows * cols - 1), (0, pad)))
            ranks.append(F.pad(rank, (0, pad), value=P))
            avails.append(F.pad(avail.reshape(-1), (0, C - rows * cols)))
        retain = reference_quota(torch.stack(avails), self.quota_t, self.active)
        cid = torch.stack(cellids)
        pool = torch.where(torch.stack(ranks) < torch.gather(retain, 1, cid),
                           torch.stack(vals), 0.0)
        top_score, sel = top_k(pool, max(self.quotas))
        xy = torch.stack([torch.gather(torch.stack(pxs), 1, sel),
                          torch.gather(torch.stack(pys), 1, sel)], -1).to(torch.int32)
        slot = torch.arange(sel.shape[1], device=dev)[None, :]
        return xy, (top_score > 0.0) & (slot < self.quota_t[:, None])

    def angles_desc(self, stack, xy_l):
        """(angles [L, Q], desc [L, Q, 32] uint8) from one 45x45 patch per
        keypoint, levels in two groups padded to their group's quota."""
        L, Q = xy_l.shape[:2]
        L2 = L // 2
        if L > 1:
            q_hi, q_lo = max(self.quotas[:L2]), max(self.quotas[L2:])
            if q_lo < Q or q_hi < Q:
                angs, descs = [], []
                for a, b, qg in ((0, L2, q_hi), (L2, L, q_lo)):
                    ag, dg = self._angles_desc(stack[a:b], xy_l[a:b, :qg],
                                               self.level_hw[a:b])
                    angs.append(F.pad(ag, (0, Q - qg)))
                    descs.append(F.pad(dg, (0, 0, 0, Q - qg)))
                return torch.cat(angs, 0), torch.cat(descs, 0)
        return self._angles_desc(stack, xy_l, self.level_hw)

    def _angles_desc(self, stack, xy_l, level_hw):
        L, Q = xy_l.shape[:2]
        _, H, W = stack.shape
        S = RB_SIZE + 6
        offs = torch.arange(S, device=stack.device) - S // 2
        xy = xy_l.to(torch.int64)
        rows = torch.minimum(torch.clamp(xy[:, :, 1:2] + offs, min=0),
                             level_hw[:, 0, None, None] - 1)
        cols = torch.minimum(torch.clamp(xy[:, :, 0:1] + offs, min=0),
                             level_hw[:, 1, None, None] - 1)
        lvl = torch.arange(L, device=stack.device)[:, None, None, None]
        flat = (lvl * H + rows[..., :, None]) * W + cols[..., None, :]
        p45 = bf16(stack.reshape(-1)[flat])
        m = (S - PATCH) // 2
        center = p45[:, :, m:m + PATCH, m:m + PATCH].reshape(L, Q, PATCH * PATCH)
        m10 = self.rnd(center @ self.wx.reshape(-1))
        m01 = self.rnd(center @ self.wy.reshape(-1))
        angles = self.rnd(torch.atan2(m01, m10))
        k = [float(v) for v in gaussian_kernel1d(7, 2.0)]
        rws = 0.0
        for i in range(7):
            rws = rws + k[i] * p45[:, :, i:i + RB_SIZE, :]
        rws = self.rnd(rws)
        blurred = 0.0
        for i in range(7):
            blurred = blurred + k[i] * rws[:, :, :, i:i + RB_SIZE]
        flat = torch.round(self.rnd(blurred)).reshape(L, Q, RB_SIZE * RB_SIZE)
        n_bins = self.lut_idx.shape[0]
        step = 2.0 * np.pi / n_bins
        bins = torch.remainder(torch.round(angles / step).to(torch.int64), n_bins)
        vals = torch.gather(flat, 2, self.lut_idx[bins])
        bits = (vals[..., 1::2] > vals[..., 0::2]).to(torch.int32)
        shifts = torch.arange(8, device=stack.device, dtype=torch.int32)
        desc = (bits.reshape(L, Q, 32, 8) << shifts).sum(-1).to(torch.uint8)
        return angles, desc

    def __call__(self, img: torch.Tensor) -> dict:
        img = img.to(self.device, torch.float32)
        stack = self.canvas(img)
        xy_l, valid_l = self.select(self.masked_scores(stack))
        angle_l, desc_l = self.angles_desc(stack, xy_l)
        keep = [(l, q) for l, q in enumerate(self.quotas) if q > 0]
        xy = torch.cat([xy_l[l, :q] for l, q in keep])
        valid = torch.cat([valid_l[l, :q] for l, q in keep])
        octave = torch.cat([torch.full((q,), l, dtype=torch.int32, device=img.device)
                            for l, q in keep])
        xy_f = self.rnd(xy.to(torch.float32) * self.level_scale[octave][:, None])
        xy_f = torch.where(valid[:, None], xy_f, -1.0)
        return dict(xy=xy_f, angle=torch.cat([angle_l[l, :q] for l, q in keep]),
                    octave=octave, valid=valid,
                    desc=pack_i32(torch.cat([desc_l[l, :q] for l, q in keep])))
