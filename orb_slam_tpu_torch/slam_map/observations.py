"""Observation bookkeeping: the capped per-point observation table and the
point statistics derived from it.

Port of orb_slam_tpu/slam_map/observations.py:32-169: `OBS_CAP`,
`flatten_observations`, `observation_table` and `refresh_point_stats`.
kf_obs is the single source of truth: every (point, kf, feature) triple is
flattened, sorted by point id and written into a [P, O] table, and all
statistics refresh as batched masked reductions (MapPoint.cc:185-250,
273-312).

The table reproduces JAX's CPU scatter exactly, including its quirk:
entries that do not fit (invalid or past the cap) are sent to row P-1
with the table's initial -1 and sort after point P-1's own entries, so
row P-1 is always left empty (`ops/scatter.py`).
"""

from __future__ import annotations

import os

import torch

from orb_slam_tpu_torch.ops.matching import INVALID_DIST, unpack_pm1
from orb_slam_tpu_torch.ops.scatter import last_writer
from orb_slam_tpu_torch.slam_map.map_state import MapState

# observations per point kept for statistics and BA edges; the same
# variable as the JAX package reads (observations.py:22-32)
OBS_CAP = int(os.environ.get("SLAM_OBS_CAP", "32"))


def flatten_observations(state: MapState):
    """(pid [M], kf [M], feat [M], valid [M]), M = K * N, sorted stably by
    point id with invalid entries (pid = P) last."""
    K, N = state.kf_obs.shape
    P = state.pt_valid.shape[0]
    dev = state.kf_obs.device
    pid = state.kf_obs.reshape(-1).long()
    kf = torch.arange(K, device=dev).repeat_interleave(N)
    feat = torch.arange(N, device=dev).repeat(K)
    valid = ((pid >= 0) & state.kf_valid[kf]
             & state.pt_valid[pid.clamp(0, P - 1)])
    key = torch.where(valid, pid, P)
    order = torch.argsort(key, stable=True)
    return key[order], kf[order], feat[order], valid[order]


def observation_table(state: MapState, cap: int = 0):
    """(obs_kf [P, O], obs_feat [P, O], obs_valid [P, O]): the first O = cap
    (default OBS_CAP) observations of each point, -1 where empty."""
    cap = cap or OBS_CAP
    P = state.pt_valid.shape[0]
    s_pid, s_kf, s_feat, s_valid = flatten_observations(state)
    M = s_pid.shape[0]
    idx = torch.arange(M, device=s_pid.device)
    first = torch.ones(M, dtype=torch.bool, device=s_pid.device)
    first[1:] = s_pid[1:] != s_pid[:-1]
    seg_start = torch.cummax(torch.where(first, idx, 0), 0).values
    pos = idx - seg_start

    ok = s_valid & (pos < cap)
    rows = torch.where(ok, s_pid, P - 1)
    cols = pos.clamp(0, cap - 1)
    # last writer per cell; a non-ok writer writes the initial -1 back
    w = last_writer(P * cap, rows * cap + cols)
    wc = w.clamp(min=0)
    live = (w >= 0) & ok[wc]
    obs_kf = torch.where(live, s_kf[wc], -1).to(torch.int32).reshape(P, cap)
    obs_feat = torch.where(live, s_feat[wc], -1).to(torch.int32).reshape(P, cap)
    return obs_kf, obs_feat, obs_kf >= 0


def _pow_f32(base: float, exponent: torch.Tensor) -> torch.Tensor:
    return torch.pow(torch.tensor(base, dtype=torch.float32,
                                  device=exponent.device),
                     exponent.to(torch.float32))


def refresh_point_stats(state: MapState, scale_factor: float = 1.2,
                        n_levels: int = 8) -> MapState:
    """Distinctive descriptors (min median pairwise Hamming,
    MapPoint::ComputeDistinctiveDescriptors), normals, scale bands and
    reference keyframes (MapPoint::UpdateNormalAndDepth) of every valid
    point in one pass. The [P, O, O] Hamming table is a batched +-1 matmul,
    exact as in ops/matching.py."""
    P = state.pt_valid.shape[0]
    K, N = state.kf_obs.shape
    obs_kf, obs_feat, obs_valid = observation_table(state)
    O = obs_kf.shape[1]
    kf_safe = obs_kf.long().clamp(0, K - 1)
    feat_safe = obs_feat.long().clamp(0, N - 1)

    # --- distinctive descriptor: min median pairwise Hamming ---
    descs = state.kf_desc[kf_safe, feat_safe]                 # [P, O, 8]
    pm1 = unpack_pm1(descs.reshape(P * O, 8)).reshape(P, O, 256)
    ham = ((256.0 - torch.bmm(pm1, pm1.transpose(1, 2))) * 0.5).to(torch.int32)
    pair_ok = obs_valid[:, :, None] & obs_valid[:, None, :]
    ham = torch.where(pair_ok, ham, INVALID_DIST)
    ham_sorted = torch.sort(ham, dim=-1).values
    n_obs_cap = obs_valid.sum(-1)
    med_idx = torch.div(n_obs_cap - 1, 2, rounding_mode="floor").clamp(0, O - 1)
    med = torch.gather(ham_sorted, 2,
                       med_idx[:, None, None].expand(P, O, 1))[..., 0]
    med = torch.where(obs_valid, med, INVALID_DIST)
    best_o = torch.argmin(med, dim=-1)                        # first minimum
    new_desc = torch.gather(descs, 1, best_o[:, None, None].expand(P, 1, 8))[:, 0]

    # --- reference KF: keep the current one if it still observes ---
    ref_ok = ((obs_kf == state.pt_ref_kf[:, None]) & obs_valid).any(-1)
    new_ref = torch.where(ref_ok, state.pt_ref_kf, obs_kf[:, 0])

    # --- normal: mean unit ray from the observing camera centres ---
    R = state.kf_pose[:, :3, :3]
    t = state.kf_pose[:, :3, 3]
    centers = -torch.einsum("kij,ki->kj", R, t)
    rays = state.pt_pos[:, None, :] - centers[kf_safe]
    norms = torch.linalg.norm(rays, dim=-1, keepdim=True)
    unit = rays / norms.clamp(min=1e-9)
    w = obs_valid[..., None].to(torch.float32)
    mean_dir = (unit * w).sum(1) / w.sum(1).clamp(min=1.0)
    new_normal = mean_dir / torch.linalg.norm(
        mean_dir, dim=-1, keepdim=True).clamp(min=1e-9)

    # --- scale-invariance band from the reference KF's observation ---
    ref_safe = new_ref.long().clamp(0, K - 1)
    dist = torch.linalg.norm(state.pt_pos - centers[ref_safe], dim=-1)
    is_ref = (obs_kf == new_ref[:, None]) & obs_valid
    ref_slot = torch.argmax(is_ref.to(torch.uint8), dim=-1)
    ref_feat = torch.gather(feat_safe, 1, ref_slot[:, None])[:, 0]
    octv = state.kf_octave[ref_safe, ref_feat]
    new_max = dist * _pow_f32(scale_factor, octv)
    new_min = new_max / _pow_f32(scale_factor, torch.tensor(
        float(n_levels - 1), device=octv.device))

    upd = state.pt_valid & (n_obs_cap > 0)
    return state.replace(
        pt_desc=torch.where(upd[:, None], new_desc, state.pt_desc),
        pt_normal=torch.where(upd[:, None], new_normal, state.pt_normal),
        pt_ref_kf=torch.where(upd, new_ref, state.pt_ref_kf),
        pt_min_dist=torch.where(upd, new_min, state.pt_min_dist),
        pt_max_dist=torch.where(upd, new_max, state.pt_max_dist),
    )
