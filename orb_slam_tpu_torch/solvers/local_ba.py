"""Bundle adjustment: Schur-complement Levenberg-Marquardt over the MapState.

Port of orb_slam_tpu/solvers/local_ba.py:43-82, :134-644 on its CPU
branches: `_edge_terms`, `_camera_compaction`, `_point_compaction`,
`_solve_iteration` (here `_solve_step`, with its single-device form
`_solve_iteration`), `_edge_chi2`, `_ba_core`, `_ba_inputs`,
`_bundle_adjust_single` and `_bundle_adjust_sharded` (one function here,
`_bundle_adjust`), `bundle_adjust` and `apply_edge_outliers`
(Optimizer::LocalBundleAdjustment, src/Optimizer.cc:287-536). Edges live
in the capped [P, O] observation table; the reduced camera system is
assembled by scatter-adds in a compact [Kl+1] camera space, the Schur
term by one scatter over every pair of a point's observations (JAX's loop
over the second observation, :279-285, in its order). The TPU's one-hot
matmul assembly and its closed-form 3x3 blocks are not ported.

The multi-device mode (`bundle_adjust(mesh=...)`, JAX's :498-559 and
:598-611). The map stays on the state's device. The point compaction
gathers BA's [Pl] (or [P]) point and edge arrays there, and only those go
out to the shards, split along axis 0 in contiguous blocks over the mesh's
`data` axis, as PartitionSpec('data') splits them, one block on the
first device of each `data` row (parallel/mesh.py). The cameras live on
the mesh's first device. In every LM iteration each shard computes its
partial Hcc, S and b with the same helpers as one device, on its own
device; `psum` reduces the three on the first device (JAX's psums,
:287-291), which solves the cameras once and sends the step back to every
shard; each shard back-substitutes its own points. The robust costs of
the LM test are reduced the same way before the comparison (:364-371).
The new points and the outlier table come back to the state's device.
One device is the same code over one shard, with the same operations.
A point space that the `data` axis does not divide raises JAX's
ValueError.

Every scatter-add sums each target's entries in their order, through
`index_put_(accumulate=True)` on the card and `index_add_` on the CPU
(`_scatter_add_`), and `psum` adds the shards in their order, so a run
gives the same result every time; the products before them round
differently on the two devices, so card and CPU agree to a tolerance, not
bit for bit, and so do a mesh and one device. `_solve_step` runs its
stages through named helpers (`_point_blocks`, `_camera_system` with
`_schur_assembly`, `_reduced_system`, `_solve_cameras`), which
`profile_paths.ba_stage_split` times one by one. The factorizations use
the `_ex` forms, which report failure in a tensor instead of checking on
the host: a point block whose Cholesky fails is zeroed, as JAX zeroes the
NaN block its CPU Cholesky returns. The LM loop reads its stop flag on
the host once per iteration, as the `while_loop` cond does (:397-430).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from orb_slam_tpu_torch.geometry.se3 import se3_exp
from orb_slam_tpu_torch.parallel.mesh import psum, replicate, split_rows
from orb_slam_tpu_torch.slam_map.map_state import MapState
from orb_slam_tpu_torch.slam_map.observations import observation_table

CHI2_MONO = 5.991
# jnp.sqrt(5.991) and its square, in f32 as JAX computes them
HUBER_DELTA = float(torch.sqrt(torch.tensor(CHI2_MONO, dtype=torch.float32)))
HUBER_DELTA2 = float(torch.tensor(HUBER_DELTA, dtype=torch.float32) ** 2)


def _edge_terms(kf_pose, pt_pos, obs_kf, uv, K_mat):
    """Residuals and Jacobians of every (point, observation) edge:
    r [P, O, 2], Jc [P, O, 2, 6] (camera, left-multiplied), Jp [P, O, 2, 3]
    and the depth z [P, O]. uv [P, O, 2] are the observed pixels."""
    Kk = kf_pose.shape[0]
    T = kf_pose[obs_kf.long().clamp(0, Kk - 1)]               # [P, O, 4, 4]
    fx, fy, cx, cy = K_mat[0, 0], K_mat[1, 1], K_mat[0, 2], K_mat[1, 2]
    pc = torch.einsum("poij,pj->poi", T[..., :3, :3], pt_pos) + T[..., :3, 3]
    x, y, z = pc[..., 0], pc[..., 1], pc[..., 2]
    zs = torch.where(z.abs() < 1e-9, 1e-9, z)
    u = fx * x / zs + cx
    v = fy * y / zs + cy
    r = torch.stack([u - uv[..., 0], v - uv[..., 1]], -1)

    iz = 1.0 / zs
    iz2 = iz * iz
    zero = torch.zeros_like(iz)
    du = torch.stack([fx * iz, zero, -fx * x * iz2], -1)
    dv = torch.stack([zero, fy * iz, -fy * y * iz2], -1)
    duv_dpc = torch.stack([du, dv], -2)                       # [P, O, 2, 3]
    hat = torch.stack([torch.stack([zero, -z, y], -1),
                       torch.stack([z, zero, -x], -1),
                       torch.stack([-y, x, zero], -1)], -2)
    I3 = torch.eye(3, device=pc.device).expand(hat.shape)
    dpc_dxi = torch.cat([I3, -hat], -1)                       # [P, O, 3, 6]
    Jc = duv_dpc @ dpc_dxi
    Jp = duv_dpc @ T[..., :3, :3]
    return r, Jc, Jp, z


def _camera_compaction(cam_opt, Kl: int):
    """(local_id [K]: camera slot -> compact slot or the dump Kl,
    opt_cams [Kl]: compact slot -> camera slot, slot_used [Kl]). Cameras
    past Kl land in the dump, i.e. are held fixed."""
    K = cam_opt.shape[0]
    rank = torch.cumsum(cam_opt.to(torch.int64), 0) - 1
    local_id = torch.where(cam_opt & (rank < Kl), rank, Kl)
    order = torch.argsort((~cam_opt).to(torch.uint8), stable=True)
    slot_used = torch.arange(Kl, device=cam_opt.device) < cam_opt.sum()
    return local_id, order[:Kl], slot_used


def _point_compaction(pt_opt, Pl: int):
    """(opt_pts [Pl]: compact slot -> point slot, slot_used [Pl]); the
    optimized points first, in slot order."""
    order = torch.argsort((~pt_opt).to(torch.uint8), stable=True)
    slot_used = torch.arange(Pl, device=pt_opt.device) < pt_opt.sum()
    return order[:Pl], slot_used


def _with_spare(rows: int, n: int, shape, device):
    """Zeros for `rows` rows plus `n` spare rows (see _scatter_add_)."""
    return torch.zeros((rows + n,) + shape, device=device)


def _scatter_add_(out, rows: int, index, values, live):
    """out[index[i]] += values[i] for the live entries, each row's entries
    added in their order (the order of JAX's CPU scatter). The others,
    which JAX adds to a dump row it then drops, go to the spare rows past
    `rows`, one each, so no row gathers them all. On the card
    `index_put_(accumulate=True)` sorts the indices stably and sums each
    row's run in that order, so the result does not change from run to
    run (the atomics of CUDA's `index_add_` would). On the CPU that call
    splits the entries over threads and adds them in no fixed order, while
    `index_add_` adds them serially, so each device keeps its own ordered
    call. Returns out."""
    spare = torch.arange(rows, rows + index.shape[0], device=index.device)
    index = torch.where(live, index, spare)
    if out.is_cuda:
        return out.index_put_((index,), values, accumulate=True)
    return out.index_add_(0, index, values)


def _eye(n, shape, device):
    return torch.eye(n, device=device).expand(shape + (n, n))


def _point_blocks(wJp, Jp, r, pt_opt, damping):
    """Each point's damped 3x3 block: (Hpp^-1 [P, 3, 3], the Cholesky
    factor L of its symmetrized inverse, zeroed where that fails, and bp
    [P, 3]). Fixed points get identity blocks and no update."""
    P = Jp.shape[0]
    dev = Jp.device
    Hpp = torch.einsum("pokx,poky->pxy", wJp, Jp)
    bp = torch.einsum("pokx,pok->px", wJp, r)
    Hpp = Hpp + damping * _eye(3, (P,), dev)
    Hpp = torch.where(pt_opt[:, None, None], Hpp, _eye(3, (P,), dev))
    bp = torch.where(pt_opt[:, None], bp, 0.0)
    Hpp_inv = torch.linalg.inv_ex(Hpp)[0]
    L, info = torch.linalg.cholesky_ex(
        0.5 * (Hpp_inv + Hpp_inv.transpose(-1, -2)) + 1e-12 * _eye(3, (P,), dev))
    L = torch.where((info == 0)[:, None, None] & torch.isfinite(L), L, 0.0)
    return Hpp_inv, L, bp


def _schur_assembly(D, kf_idx, Kl: int):
    """S [Kl+1, Kl+1, 6, 6] with S[a, b] = -sum D[p, o] D[p, q]^T over
    a = kf_idx[p, o], b = kf_idx[p, q] below Kl: JAX's loop over q
    (:279-285) as one scatter whose entries run q-major, then p, then o, so
    each cell sums them in JAX's order."""
    R = (Kl + 1) * (Kl + 1)
    V = torch.einsum("poxz,pqyz->qpoxy", D, D)                 # [O, P, O, 6, 6]
    cell = kf_idx[None] * (Kl + 1) + kf_idx.T[:, :, None]      # [O, P, O]
    both = (kf_idx[None] < Kl) & (kf_idx.T[:, :, None] < Kl)
    S = _scatter_add_(_with_spare(R, cell.numel(), (6, 6), D.device), R,
                      cell.reshape(-1), -V.reshape(-1, 6, 6), both.reshape(-1))
    return S[:R].reshape(Kl + 1, Kl + 1, 6, 6)


def _camera_system(wJc, Jc, Jp, r, Hpp_inv, L, bp, kf_idx, pt_opt, Kl: int):
    """The reduced camera system in the [Kl+1] camera space (the last slot
    the dump), as three parts JAX's sharded path reduces one by one
    (:287-291): (Hcc [Kl+1, 6, 6], S [Kl+1, Kl+1, 6, 6], b [Kl+1, 6] =
    bc - sum_o C Hpp^-1 bp, C), where C = Jc^T W Jp and S = -sum_o,q C_o
    L L^T C_q^T; `_reduced_system` adds Hcc to S's diagonal."""
    dev = Jp.device
    C = torch.einsum("pokx,poky->poxy", wJc, Jp) * pt_opt[:, None, None, None]
    D = torch.einsum("poxy,pyz->poxz", C, L)
    Hib = torch.einsum("pxy,py->px", Hpp_inv, bp)
    bred_contrib = torch.einsum("poxy,py->pox", C, Hib)

    flat = kf_idx.reshape(-1)
    live = flat < Kl
    n = flat.shape[0]
    Hcc = _scatter_add_(_with_spare(Kl + 1, n, (6, 6), dev), Kl + 1, flat,
                        torch.einsum("pokx,poky->poxy", wJc, Jc).reshape(-1, 6, 6),
                        live)[:Kl + 1]
    bc = _scatter_add_(_with_spare(Kl + 1, n, (6,), dev), Kl + 1, flat,
                       torch.einsum("pokx,pok->pox", wJc, r).reshape(-1, 6), live)
    S = _schur_assembly(D, kf_idx, Kl)
    bc = _scatter_add_(bc, Kl + 1, flat, -bred_contrib.reshape(-1, 6), live)[:Kl + 1]
    return Hcc, S, bc, C


def _reduced_system(Hcc, S):
    """H = S with Hcc added to its diagonal blocks."""
    diag = torch.arange(S.shape[0], device=S.device)
    H = S.clone()
    H[diag, diag] += Hcc
    return H


def _solve_cameras(H, b):
    """The dense solve of the [Kl, Kl, 6, 6] system H dx = -b; a failed
    solve gives no step."""
    Kl = H.shape[0]
    Hd = H.permute(0, 2, 1, 3).reshape(Kl * 6, Kl * 6)
    dxc = torch.linalg.solve_ex(Hd, -b.reshape(Kl * 6))[0].reshape(Kl, 6)
    return torch.where(torch.isfinite(dxc), dxc, 0.0)


class _Edges(NamedTuple):
    """One shard's edges, constant over a BA run, on the shard's device:
    obs_kf [P_s, O], uv [P_s, O, 2], inv_sigma2 [P_s, O] and pt_opt [P_s]."""

    obs_kf: torch.Tensor
    uv: torch.Tensor
    inv_sigma2: torch.Tensor
    pt_opt: torch.Tensor


def _solve_step(kf_pose, K_mat, cam_opt, damping, pts, edges, weights,
                Kl: int | None = None, terms=None):
    """One damped Gauss-Newton step over point shards (JAX's
    `_solve_iteration` with `axis_name`, :134-370). kf_pose [K, 4, 4],
    K_mat, cam_opt [K] and damping (a scalar tensor) live on the first
    shard's device; pts[s] [P_s, 3], edges[s] and weights[s] [P_s, O] (0
    = no edge, else information x Huber) on shard s's, with terms[s] its
    _edge_terms at this state if the caller has them. Each shard assembles
    its partial Hcc, S and b; `psum` reduces them on the first device,
    which solves the cameras once; the camera step goes back to every
    shard, which back-substitutes its own points. Kl bounds the optimized
    cameras (compact Schur space); None = the full capacity. Returns (new
    kf_pose on the first device, [new pt_pos of each shard])."""
    Kk = kf_pose.shape[0]
    root = kf_pose.device
    devs = [p.device for p in pts]
    compact = Kl is not None
    if compact:
        local_id, opt_cams, slot_used = _camera_compaction(cam_opt, Kl)
        local_ids = replicate(local_id, devs)
    else:
        Kl = Kk
    poses = replicate(kf_pose, devs)
    Kmats = replicate(K_mat, devs)
    cam_opts = replicate(cam_opt, devs)
    dampings = replicate(damping, devs)

    parts, backsub = [], []
    for s, e in enumerate(edges):
        r, Jc, Jp, z = (terms[s] if terms is not None else
                        _edge_terms(poses[s], pts[s], e.obs_kf, e.uv, Kmats[s]))
        w = weights[s] * (z > 0)
        obs_kf_safe = e.obs_kf.long().clamp(0, Kk - 1)
        cam_is_opt = cam_opts[s][obs_kf_safe]
        Jc = torch.where(cam_is_opt[..., None, None], Jc, 0.0)
        wJc = Jc * w[..., None, None]
        wJp = Jp * w[..., None, None]
        Hpp_inv, L, bp = _point_blocks(wJp, Jp, r, e.pt_opt, dampings[s])
        if compact:
            kf_idx = torch.where((w > 0) & cam_is_opt, local_ids[s][obs_kf_safe],
                                 Kl)
        else:
            kf_idx = torch.where(w > 0, e.obs_kf.long(), Kk)
        Hcc, S, bc, C = _camera_system(wJc, Jc, Jp, r, Hpp_inv, L, bp, kf_idx,
                                       e.pt_opt, Kl)
        parts.append((Hcc, S, bc))
        backsub.append((C, kf_idx, Hpp_inv, bp))

    # the collective: the partial normal equations reduced over the shards
    Hcc, S, bc = (psum(list(p)) for p in zip(*parts))
    H = _reduced_system(Hcc, S)[:Kl, :Kl]
    b = bc[:Kl]
    d = torch.arange(Kl, device=root)
    if compact:
        # padding slots get identity rows, live ones the LM boost
        boost = torch.where(slot_used, damping, 1.0)
        H[d, d] += boost[:, None, None] * torch.eye(6, device=root)
        b = torch.where(slot_used[:, None], b, 0.0)
    else:
        H[d, d] += torch.where(cam_opt, damping, 0.0)[:, None, None] * torch.eye(
            6, device=root)
        fixed = ~cam_opt
        H = torch.where(fixed[:, None, None, None], 0.0, H)
        H = torch.where(fixed[None, :, None, None], 0.0, H)
        H[d, d] += fixed[:, None, None].to(H.dtype) * torch.eye(6, device=root)
        b = torch.where(fixed[:, None], 0.0, b)

    dxc = _solve_cameras(H, b)
    if compact:
        dxc = dxc * slot_used[:, None]

    # back-substitute each shard's points: dxp = Hpp^-1 (-bp - sum_o C^T dxc)
    dxc_pads = replicate(torch.cat([dxc, torch.zeros((1, 6), device=root)]), devs)
    new_pts = []
    for s, (C, kf_idx, Hpp_inv, bp) in enumerate(backsub):
        Ct_dx = torch.einsum("poxy,pox->py", C, dxc_pads[s][kf_idx])
        dxp = torch.einsum("pxy,py->px", Hpp_inv, -bp - Ct_dx)
        dxp = torch.where(torch.isfinite(dxp), dxp, 0.0) * edges[s].pt_opt[:, None]
        new_pts.append(pts[s] + dxp)

    if compact:
        dxc_g = torch.zeros((Kk, 6), device=root).index_add_(
            0, opt_cams, dxc * slot_used[:, None])
    else:
        dxc_g = dxc
    new_pose = torch.where(cam_opt[:, None, None], se3_exp(dxc_g) @ kf_pose,
                           kf_pose)
    return new_pose, new_pts


def _solve_iteration(kf_pose, pt_pos, edge_w, obs_kf, uv, K_mat, cam_opt,
                     pt_opt, damping, Kl: int | None = None, terms=None):
    """One damped Gauss-Newton step on one device (JAX's
    `_solve_iteration` without `axis_name`): `_solve_step` over a single
    shard. Returns (new kf_pose, new pt_pos)."""
    damping = torch.as_tensor(damping, dtype=torch.float32, device=pt_pos.device)
    new_pose, (new_pts,) = _solve_step(
        kf_pose, K_mat, cam_opt, damping, [pt_pos],
        [_Edges(obs_kf, uv, None, pt_opt)], [edge_w], Kl=Kl,
        terms=None if terms is None else [terms])
    return new_pose, new_pts


def _edge_chi2(kf_pose, pt_pos, obs_kf, uv, K_mat, inv_sigma2):
    r, _, _, z = _edge_terms(kf_pose, pt_pos, obs_kf, uv, K_mat)
    return (r * r).sum(-1) * inv_sigma2, z


def _robust_cost(chi2, z, edge_on):
    """Total Huber cost over the active edges (the LM acceptance metric)."""
    e = torch.sqrt(chi2.clamp(min=1e-12))
    rho = torch.where(e <= HUBER_DELTA, chi2, 2.0 * HUBER_DELTA * e - HUBER_DELTA2)
    return (rho * (edge_on & (z > 0))).sum()


def _ba_core(kf_pose, K_mat, cam_opt, pts, edges, edge_on, *, iters1, iters2,
             damping, Kl=None):
    """Two LM phases over point shards, each followed by the chi2 re-gate
    (Optimizer.cc:442-515). Each iteration proposes a step at the current
    lambda and takes it only if the robust cost falls (lambda / 2), else
    lambda x 10; a phase stops early once a taken step gains under 1e-4
    relative, or lambda reaches its ceiling. The costs of the test are
    each shard's partial reduced by `psum` (:364-371), so every shard takes
    the same decision. kf_pose, K_mat and cam_opt live on the first
    shard's device, pts[s], edges[s] and edge_on[s] on shard s's. Returns
    (kf_pose, [pt_pos], [edge_on], (iterations of phase 1, of phase 2))."""
    root = kf_pose.device
    devs = [p.device for p in pts]
    Kmats = replicate(K_mat, devs)

    def chi2s(kf_pose, pts):
        return [_edge_chi2(T, p, e.obs_kf, e.uv, Km, e.inv_sigma2)
                for T, p, e, Km in zip(replicate(kf_pose, devs), pts, edges, Kmats)]

    def phase(kf_pose, pts, edge_on, lam, n_iters):
        i = 0
        done = False
        while i < n_iters and not done:
            terms, weights, cost0 = [], [], []
            for T, p, e, on, Km in zip(replicate(kf_pose, devs), pts, edges,
                                       edge_on, Kmats):
                t = _edge_terms(T, p, e.obs_kf, e.uv, Km)
                r, _, _, z = t
                chi2 = (r * r).sum(-1) * e.inv_sigma2
                err = torch.sqrt(chi2.clamp(min=1e-12))
                w_huber = torch.where(err <= HUBER_DELTA, 1.0, HUBER_DELTA / err)
                terms.append(t)
                weights.append(e.inv_sigma2 * w_huber * on * (z > 0))
                cost0.append(_robust_cost(chi2, z, on))
            new_pose, new_pts = _solve_step(kf_pose, K_mat, cam_opt, lam, pts,
                                            edges, weights, Kl=Kl, terms=terms)
            cost0 = psum(cost0)
            cost1 = psum([_robust_cost(c, z, on) for (c, z), on in
                          zip(chi2s(new_pose, new_pts), edge_on)])
            accept = cost1 < cost0
            rel_gain = (cost0 - cost1) / cost0.clamp(min=1e-12)
            kf_pose = torch.where(accept, new_pose, kf_pose)
            pts = [torch.where(a, n, p) for a, n, p in
                   zip(replicate(accept, devs), new_pts, pts)]
            lam = torch.where(accept, lam * 0.5, lam * 10.0).clamp(1e-9, 1e6)
            i += 1
            done = bool((accept & (rel_gain < 1e-4)) | (~accept & (lam >= 1e6)))
        edge_on = [on & (c <= CHI2_MONO) & (z > 0)
                   for (c, z), on in zip(chi2s(kf_pose, pts), edge_on)]
        return kf_pose, pts, edge_on, lam, i

    lam = torch.tensor(damping, dtype=torch.float32, device=root)
    kf_pose, pts, edge_on, lam, n1 = phase(kf_pose, pts, edge_on, lam, iters1)
    kf_pose, pts, edge_on, lam, n2 = phase(kf_pose, pts, edge_on, lam, iters2)
    return kf_pose, pts, edge_on, (n1, n2)


def _ba_inputs(state: MapState, pt_opt, scale_factor: float = 1.2):
    """The observation table with each edge's pixel, information and
    initial mask (mvInvLevelSigma2, Optimizer.cc:120)."""
    obs_kf, obs_feat, obs_valid = observation_table(state)
    Kk, N = state.kf_xy.shape[:2]
    kf_safe = obs_kf.long().clamp(0, Kk - 1)
    feat_safe = obs_feat.long().clamp(0, N - 1)
    uv = state.kf_xy[kf_safe, feat_safe]
    octv = state.kf_octave[kf_safe, feat_safe]
    sf = torch.tensor(scale_factor, dtype=torch.float32, device=uv.device)
    inv_sigma2 = 1.0 / torch.pow(sf, 2.0 * octv.to(torch.float32))
    edge_on = obs_valid & pt_opt[:, None]
    return obs_kf, obs_feat, obs_valid, uv, inv_sigma2, edge_on


def _bundle_adjust(state, K_mat, cam_opt, pt_opt, devices, iters1, iters2,
                   damping, Kl=None, Pl=None, scale_factor=1.2):
    """BA with its [P] or compact [Pl] point arrays split over `devices` in
    contiguous blocks, the cameras on devices[0] (JAX's
    `_bundle_adjust_single` on one device, `_bundle_adjust_sharded` on
    several, :466-559). The compaction gathers [Pl] on the state's device
    first; the new points and the outlier table come back to it. Returns
    (new_state, outlier [P, O], (obs_kf, obs_feat), iterations)."""
    dev = state.pt_pos.device
    root = devices[0]
    obs_kf, obs_feat, obs_valid, uv, inv_sigma2, edge_on = _ba_inputs(
        state, pt_opt, scale_factor)
    if Pl is None:
        rows, used = slice(None), pt_opt
    else:
        # compact point space: every pass runs over [Pl, O]
        rows, used = _point_compaction(pt_opt, Pl)
        edge_on = edge_on[rows] & used[:, None]
    split = lambda x: split_rows(x, devices)
    edges = [_Edges(*e) for e in zip(split(obs_kf[rows]), split(uv[rows]),
                                     split(inv_sigma2[rows]), split(used))]
    kf_pose, pts, edge_in, its = _ba_core(
        state.kf_pose.to(root), K_mat.to(root), cam_opt.to(root),
        split(state.pt_pos[rows]), edges,
        split(edge_on), iters1=iters1,
        iters2=iters2, damping=damping, Kl=Kl)
    kf_pose = kf_pose.to(dev)
    pt_pos_c = torch.cat([p.to(dev) for p in pts])
    edge_in = torch.cat([e.to(dev) for e in edge_in])
    if Pl is None:
        pt_pos = pt_pos_c
        outlier = obs_valid & pt_opt[:, None] & ~edge_in
    else:
        pt_pos = state.pt_pos.clone()
        pt_pos[rows] = torch.where(used[:, None], pt_pos_c, state.pt_pos[rows])
        outlier = torch.zeros_like(obs_valid)
        outlier[rows] = obs_valid[rows] & used[:, None] & ~edge_in
    return (state.replace(kf_pose=kf_pose, pt_pos=pt_pos), outlier,
            (obs_kf, obs_feat), its)


def bundle_adjust(state: MapState, K_mat, cam_opt, pt_opt, iters1: int = 5,
                  iters2: int = 10, damping: float = 1e-3, mesh=None,
                  max_opt_cams: int | None = None,
                  max_opt_pts: int | None = None, scale_factor: float = 1.2,
                  iterations: list | None = None):
    """Local or global BA over the map. cam_opt [K] bool: cameras to
    optimize (the fixed ones still constrain points); pt_opt [P] bool:
    points to optimize, edges to the others ignored (Optimizer.cc:289-338).
    max_opt_cams / max_opt_pts bound the compact camera and point spaces
    (None = the full capacity). mesh: a `parallel.Mesh`; the point arrays
    then split over its `data` axis, whose size must divide the point
    space, and the cameras are solved on its first device (:562-611).
    `iterations`, if given, gets the LM iterations each phase ran appended
    as a pair. Returns (new_state, edge_outlier [P, O] bool, (obs_kf,
    obs_feat)), on the state's device."""
    P = state.pt_valid.shape[0]
    if max_opt_pts is not None and max_opt_pts >= P:
        max_opt_pts = None
    devices = [state.pt_pos.device] if mesh is None else mesh.data_devices
    n_data = len(devices)
    P_sh = max_opt_pts if max_opt_pts is not None else P
    if P_sh % n_data:
        raise ValueError(
            f"bundle_adjust: point space {P_sh} must divide the mesh "
            f"'data' axis ({n_data})")
    new_state, outlier, table, its = _bundle_adjust(
        state, K_mat, cam_opt, pt_opt, devices, iters1, iters2, damping,
        Kl=max_opt_cams, Pl=max_opt_pts, scale_factor=scale_factor)
    if iterations is not None:
        iterations.append(its)
    return new_state, outlier, table


def apply_edge_outliers(state: MapState, outlier, obs_kf, obs_feat,
                        kill_starved: bool = True) -> MapState:
    """Unbind the observations BA flagged (Optimizer.cc:497-515); with
    kill_starved, a point that lost one and is left with <= 2 observations
    dies (MapPoint::EraseObservation -> SetBadFlag, MapPoint.cc:93-103).
    The flagged (kf, feature) pairs are distinct, so the scatter has no
    duplicate target outside the dump row."""
    Kk, N = state.kf_obs.shape
    rows = torch.where(outlier, obs_kf.long(), Kk)
    cols = obs_feat.long().clamp(0, N - 1)
    obs = torch.cat([state.kf_obs, torch.full((1, N), -1, dtype=torch.int32,
                                              device=rows.device)])
    obs[rows, cols] = torch.where(outlier, -1, obs[rows, cols])
    obs = obs[:Kk]
    if not kill_starved:
        return state.replace(kf_obs=obs)
    P = state.pt_valid.shape[0]
    o = obs.long()
    remaining = torch.zeros(P + 1, dtype=torch.int32, device=o.device).index_add(
        0, torch.where(o >= 0, o, P).reshape(-1),
        ((o >= 0) & state.kf_valid[:, None]).to(torch.int32).reshape(-1))[:P]
    killed = state.pt_valid & outlier.any(1) & (remaining <= 2)
    obs = torch.where((o >= 0) & killed[o.clamp(0, P - 1)], -1, obs)
    return state.replace(kf_obs=obs, pt_valid=state.pt_valid & ~killed)
