"""Essential-graph optimization: the Sim3 pose graph of loop closing.

Port of orb_slam_tpu/solvers/essential_graph.py: `_vertex` (:28-33),
`_edge_residual` (:36-45), `optimize_essential_graph` (:48-205) with its
dense and PCG solvers, `relative_sim3` and `relative_sim3_batch`
(:208-224); the reference's Optimizer::OptimizeEssentialGraph
(src/Optimizer.cc:540-789): every keyframe a Sim3 vertex, a [K, 7] tangent
update over its base Sim3, edges [E] with measured relative Sim3s and the
residual log(S_meas^-1 S_j S_i^-1), adaptive-lambda Levenberg-Marquardt
from lambda 1e-16 with the fixed vertices held.

The per-edge Jacobians, JAX's `vmap(jacfwd)` (:105-106), are one
forward-mode pass of `torch.func.jvp` over the edges batched 14 times, one
tangent direction per copy (7 for each endpoint): each edge's residual
depends only on its two endpoints, so copy k carries column k of every
edge's Jacobian. The passes go through so3_log's argmax and gather and
sim3_log's 3x3 solve.

The scatter-adds over edge endpoints (b :122-126, the dense H :130-143,
the PCG's Hx and block diagonal :154-169) go through
`solvers/local_ba._scatter_add_`: on the card one sorted
`index_put_(accumulate=True)` per sum, so two runs give the same bits; on
the CPU `index_add_` in JAX's order. The dense [7K, 7K] solve and the
[K, 7, 7] inverses of the PCG are `solve_ex` and `inv_ex` with NaN where
they fail, as JAX returns, and a non-finite step is zeroed (:184). The LM
loop's accept test and lambda stay on the device: nothing is read on the
host in the `iters` iterations.
"""

from __future__ import annotations

import torch
from torch.func import jvp

from orb_slam_tpu_torch.geometry.sim3 import (
    _solve_nan, sim3_compose, sim3_exp, sim3_inverse, sim3_log,
)
from orb_slam_tpu_torch.solvers.local_ba import _scatter_add_
from orb_slam_tpu_torch.solvers.two_view import _inv


def _vertex(xi, base_s, base_R, base_t):
    ds, dR, dt = sim3_exp(xi)
    s = base_s * ds
    R = dR @ base_R
    t = ds[..., None] * (dR @ base_t[..., None])[..., 0] + dt
    return s, R, t


def _edge_residual(xi_i, xi_j, base_i, base_j, meas):
    """r = log(S_meas^-1 S_j S_i^-1) in R^7, the g2o EdgeSim3 error
    (types_seven_dof_expmap.h:99)."""
    Si = _vertex(xi_i, *base_i)
    Sj = _vertex(xi_j, *base_j)
    rel = sim3_compose(Sj, sim3_inverse(Si))
    return sim3_log(sim3_compose(sim3_inverse(meas), rel))


def _residual_and_jacobians(xi_i, xi_j, base_i, base_j, meas):
    """(r [E, 7], Ji [E, 7, 7], Jj [E, 7, 7]) by forward mode: 14 copies
    of the edges, copy k < 7 moving xi_i along axis k, copy k >= 7 xi_j
    along axis k - 7."""
    E = xi_i.shape[0]
    eye = torch.eye(7, dtype=xi_i.dtype, device=xi_i.device)
    zero = torch.zeros_like(eye)
    ti = torch.cat([eye, zero])[:, None, :].repeat(1, E, 1)
    tj = torch.cat([zero, eye])[:, None, :].repeat(1, E, 1)
    r, dr = jvp(lambda a, b: _edge_residual(a, b, base_i, base_j, meas),
                (xi_i.repeat(14, 1, 1), xi_j.repeat(14, 1, 1)), (ti, tj))
    J = dr.permute(1, 2, 0)                                  # [E, out, 14]
    return r[0], J[..., :7], J[..., 7:]


def _scatter_rows(rows: int, index, values, live):
    """out[index[i]] += values[i] over the live entries ([rows, ...])."""
    out = torch.zeros((rows + index.shape[0],) + values.shape[1:],
                      dtype=values.dtype, device=values.device)
    return _scatter_add_(out, rows, index, values, live)[:rows]


def optimize_essential_graph(base_s, base_R, base_t, edges_i, edges_j,
                             meas_s, meas_R, meas_t, edge_valid, fixed,
                             iters: int = 20, solver: str = "dense",
                             cg_iters: int = 100):
    """Optimized (s [K], R [K, 3, 3], t [K, 3]) from the base vertex Sim3s,
    the edges (edges_i, edges_j [E] int, the measured S_ji, edge_valid [E]
    bool) and `fixed` [K] bool (the loop keyframe and the empty slots).

    solver "dense" solves the [7K, 7K] normal equations at once; "cg" runs
    `cg_iters` steps of block-Jacobi preconditioned conjugate gradient on
    the same equations, matrix-free (the split the loop closer makes at 384
    keyframe slots)."""
    K = base_s.shape[0]
    dev = base_s.device
    ei = edges_i.long().clamp(0, K - 1)
    ej = edges_j.long().clamp(0, K - 1)
    base_i = (base_s[ei], base_R[ei], base_t[ei])
    base_j = (base_s[ej], base_R[ej], base_t[ej])
    meas = (meas_s, meas_R, meas_t)
    valid_f = edge_valid.to(base_s.dtype)
    free = ~fixed
    eye7 = torch.eye(7, dtype=base_s.dtype, device=dev)
    # an edge's contributions to its endpoints' rows (JAX sends an invalid
    # edge's to a dump row K it then drops)
    both = torch.cat([ei, ej])
    live2 = torch.cat([edge_valid, edge_valid])

    def total_cost(xi):
        r = _edge_residual(xi[ei], xi[ej], base_i, base_j, meas)
        return ((r * r).sum(-1) * valid_f).sum()

    def step(xi, lam):
        r, Ji, Jj = _residual_and_jacobians(xi[ei], xi[ej], base_i, base_j, meas)
        # a fixed endpoint takes nothing from the system; its edges still
        # constrain the free endpoint through the residual
        Ji = Ji * (edge_valid & free[ei]).to(Ji.dtype)[:, None, None]
        Jj = Jj * (edge_valid & free[ej]).to(Jj.dtype)[:, None, None]
        rw = r * valid_f[:, None]
        b = _scatter_rows(K, both, torch.cat([
            torch.einsum("eki,ek->ei", Ji, rw),
            torch.einsum("eki,ek->ei", Jj, rw)]), live2)
        b = torch.where(fixed[:, None], torch.zeros_like(b), b)

        if solver == "dense":
            cells = torch.cat([ei * K + ei, ej * K + ej, ei * K + ej, ej * K + ei])
            blocks = torch.cat([
                torch.einsum("eki,ekj->eij", Ji, Ji),
                torch.einsum("eki,ekj->eij", Jj, Jj),
                torch.einsum("eki,ekj->eij", Ji, Jj),
                torch.einsum("eki,ekj->eij", Jj, Ji)])
            live4 = torch.cat([edge_valid] * 4)
            H = _scatter_rows(K * K, cells, blocks, live4).reshape(K, K, 7, 7)
            d = torch.arange(K, device=dev)
            H = H + (d[:, None] == d[None, :]).to(H.dtype)[:, :, None, None] * (lam * eye7)
            # fixed vertices: identity rows and columns
            keep = (free[:, None] & free[None, :]).to(H.dtype)[:, :, None, None]
            H = H * keep + ((d[:, None] == d[None, :]) & fixed[:, None]).to(
                H.dtype)[:, :, None, None] * eye7
            Hd = H.permute(0, 2, 1, 3).reshape(7 * K, 7 * K)
            dx = _solve_nan(Hd, -b.reshape(7 * K, 1)).reshape(K, 7)
        else:
            def Hx(x):
                u = (torch.einsum("eij,ej->ei", Ji, x[ei])
                     + torch.einsum("eij,ej->ei", Jj, x[ej]))
                y = _scatter_rows(K, both, torch.cat([
                    torch.einsum("eik,ei->ek", Ji, u),
                    torch.einsum("eik,ei->ek", Jj, u)]), live2)
                y = y + lam * x
                return torch.where(fixed[:, None], x, y)

            Dg = _scatter_rows(K, both, torch.cat([
                torch.einsum("eki,ekj->eij", Ji, Ji),
                torch.einsum("eki,ekj->eij", Jj, Jj)]), live2)
            Dg = Dg + (lam + 1e-8) * eye7
            Dg = torch.where(fixed[:, None, None], eye7.expand(K, 7, 7), Dg)
            D_inv = _inv(Dg)
            precond = lambda v: torch.einsum("kij,kj->ki", D_inv, v)

            x = torch.zeros((K, 7), dtype=b.dtype, device=dev)
            rr = -b
            p = precond(rr)
            rz = (rr * p).sum()
            zero = torch.zeros((), dtype=b.dtype, device=dev)
            for _ in range(cg_iters):
                Ap = Hx(p)
                denom = (p * Ap).sum()
                alpha = torch.where(denom.abs() > 1e-30, rz / denom, zero)
                x = x + alpha * p
                rr = rr - alpha * Ap
                z = precond(rr)
                rz_new = (rr * z).sum()
                beta = torch.where(rz.abs() > 1e-30, rz_new / rz, zero)
                p = z + beta * p
                rz = rz_new
            dx = x
        dx = torch.where(torch.isfinite(dx), dx, torch.zeros_like(dx))
        dx = dx * free[:, None].to(dx.dtype)
        new_xi = xi + dx
        accept = total_cost(new_xi) < total_cost(xi)
        xi = torch.where(accept, new_xi, xi)
        lam = torch.clamp(torch.where(accept, lam * 0.5, lam * 10.0), 1e-16, 1e6)
        return xi, lam

    xi = torch.zeros((K, 7), dtype=base_s.dtype, device=dev)
    # lambda_init 1e-16, the reference's essential-graph setting
    # (Optimizer.cc:553)
    lam = torch.full((), 1e-16, dtype=base_s.dtype, device=dev)
    for _ in range(iters):
        xi, lam = step(xi, lam)
    return _vertex(xi, base_s, base_R, base_t)


def relative_sim3(s_i, R_i, t_i, s_j, R_j, t_j):
    """The measured S_ji = S_j S_i^-1 of two vertex Sim3s (how the reference
    measures spanning-tree and covisibility edges, Optimizer.cc:620-700)."""
    return sim3_compose((s_j, R_j, t_j), sim3_inverse((s_i, R_i, t_i)))


def relative_sim3_batch(s_i, R_i, t_i, s_j, R_j, t_j):
    """relative_sim3 over [E] edges at once (the loop closer's edge
    measurements, one batch)."""
    return relative_sim3(s_i, R_i, t_i, s_j, R_j, t_j)
