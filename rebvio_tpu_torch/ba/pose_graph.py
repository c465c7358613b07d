"""Pose-graph optimization over keyframe odometry and loop-closure factors
(rebvio_tpu/ba/pose_graph.py).

Nodes are keyframe poses, factors are relative SE3 measurements
(sequential odometry from the VIO front end, plus loop closures).  Residual
of factor (i, j, R_ij, t_ij):

    r_R = log(R_ij^T (R_i^T R_j))          (rotation, 3)
    r_t = R_i^T (t_j - t_i) - t_ij         (translation, 3)

Damped Gauss-Newton.  The per-factor Jacobians are forward-mode derivatives
of the residual at a zero perturbation (``torch.func.jvp`` over a batch of
unit tangents; ``so3.exp`` and ``so3.log`` are written with selects, so
they trace).  The [6F, 6F] normal matrix is one dense product: every factor's
two 6x6 Jacobian blocks are placed into a [6M, 6F] matrix by one-hot
products, so no duplicate-index scatter-add (unordered on CUDA) is needed.
Each iteration's accept/reject is a select on the device: the loop never
reads a value back.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from rebvio_tpu_torch.geometry import so3

f32 = torch.float32


class PoseGraph(NamedTuple):
    R: torch.Tensor         # [F,3,3] world-from-camera
    t: torch.Tensor         # [F,3]
    f_i: torch.Tensor       # [M] int32 factor endpoints
    f_j: torch.Tensor       # [M] int32
    f_Rij: torch.Tensor     # [M,3,3] measured relative rotation R_i^T R_j
    f_tij: torch.Tensor     # [M,3] measured relative translation R_i^T (t_j - t_i)
    f_w: torch.Tensor       # [M] rotation-residual weight (1/sigma)
    f_valid: torch.Tensor   # [M] bool
    # translation-residual weight; None -> f_w for both components.  Loop
    # closures registered from edge-map pairs observe rotation much more
    # strongly than (depth-limited) translation, so they get a split weight
    # (ba/loop_closure.build_graph_from_run).
    f_wt: Optional[torch.Tensor] = None


def factors_from_trajectory(R, t, stride: int = 1, w: float = 1.0):
    """Sequential odometry factors from a trajectory (i, i+stride), numpy."""
    F = len(t)
    fi = np.arange(0, F - stride, dtype=np.int32)
    fj = fi + stride
    Rij = np.einsum("fji,fjk->fik", R[fi], R[fj])  # R_i^T R_j
    tij = np.einsum("fji,fj->fi", R[fi], t[fj] - t[fi])
    return (fi, fj, Rij.astype(np.float32), tij.astype(np.float32),
            np.full(len(fi), w, np.float32))


def _factor_residual(dpi, dpj, Ri, ti, Rj, tj, Rij, tij):
    """Residual [..., 6] of factors under the perturbations ``dpi``, ``dpj``
    [..., 6] of their endpoint poses; every argument carries the same
    (broadcastable) leading dimensions."""
    Ri_p = Ri @ so3.exp(dpi[..., :3])
    ti_p = ti + dpi[..., 3:]
    Rj_p = Rj @ so3.exp(dpj[..., :3])
    tj_p = tj + dpj[..., 3:]
    r_R = so3.log(Rij.mT @ (Ri_p.mT @ Rj_p))
    r_t = (Ri_p.mT @ (tj_p - ti_p)[..., None])[..., 0] - tij
    return torch.cat([r_R, r_t], dim=-1)


def factor_jacobians(Ri, ti, Rj, tj, Rij, tij):
    """(residual [M,6], d residual / d dp_i [M,6,6], d residual / d dp_j
    [M,6,6]) of M factors at zero perturbation.  The 12 forward-mode columns
    come from one ``jvp`` over a leading [12] copy of the factors, each copy
    with one unit tangent (``jax.jacfwd`` under ``vmap`` in the JAX
    package)."""
    M = Ri.shape[0]
    z = torch.zeros((12, M, 6), dtype=Ri.dtype, device=Ri.device)
    basis = torch.eye(12, dtype=Ri.dtype, device=Ri.device)
    tan_i = basis[:, None, :6].expand(12, M, 6)
    tan_j = basis[:, None, 6:].expand(12, M, 6)
    r12, J12 = torch.func.jvp(
        lambda a, b: _factor_residual(a, b, Ri, ti, Rj, tj, Rij, tij), (z, z), (tan_i, tan_j))
    J = J12.permute(1, 2, 0)                 # [M, residual, perturbation]
    return r12[0], J[:, :, :6], J[:, :, 6:]


def optimize(g: PoseGraph, iters: int = 10, lam0: float = 1e-4,
             fix_first: bool = True) -> Tuple[PoseGraph, torch.Tensor]:
    """Damped GN over the pose graph; returns (graph, cost history [iters])."""
    F = g.R.shape[0]
    F6 = 6 * F
    dev = g.R.device
    i = torch.clamp(g.f_i, 0, F - 1).to(torch.int64)
    j = torch.clamp(g.f_j, 0, F - 1).to(torch.int64)
    nodes = torch.arange(F, device=dev)
    Si = (i[:, None] == nodes[None, :]).to(f32)      # [M,F] one-hot endpoints
    Sj = (j[:, None] == nodes[None, :]).to(f32)
    w_rot = torch.where(g.f_valid, g.f_w, 0.0)
    w_tr = torch.where(g.f_valid, g.f_w if g.f_wt is None else g.f_wt, 0.0)
    wc = torch.cat([w_rot[:, None].expand(-1, 3), w_tr[:, None].expand(-1, 3)], dim=1)  # [M,6]
    M = wc.shape[0]

    def build(R, t):
        r, Ji, Jj = factor_jacobians(R[i], t[i], R[j], t[j], g.f_Rij, g.f_tij)
        r = r * wc
        Ji = Ji * wc[:, :, None]
        Jj = Jj * wc[:, :, None]
        # J[(m,c), (a,k)] = Ji[m,c,k] [a == i_m] + Jj[m,c,k] [a == j_m]
        J = (torch.einsum("ma,mck->mcak", Si, Ji)
             + torch.einsum("ma,mck->mcak", Sj, Jj)).reshape(6 * M, F6)
        rf = r.reshape(6 * M)
        return J.T @ J, J.T @ rf, torch.sum(r * r)

    def apply(R, t, dp):
        d = dp.reshape(F, 6)
        return R @ so3.exp(d[:, :3]), t + d[:, 3:]

    mask = torch.arange(F6, device=dev) >= 6
    mask2 = mask[:, None] & mask[None, :]
    pin = torch.diag((~mask).to(f32))

    R, t = g.R, g.t
    lam = torch.full((), lam0, dtype=f32, device=dev)
    _, _, cost_prev = build(R, t)
    hist = []
    for _ in range(iters):
        H, b, _ = build(R, t)
        A = H + lam * torch.diag(torch.clamp(torch.diagonal(H), min=1e-8))
        if fix_first:
            A = torch.where(mask2, A, 0.0) + pin
            b = torch.where(mask, b, 0.0)
        # solve_ex: no host read of the factorization's status; a singular
        # system gives a step that the accept test below rejects
        dp = torch.linalg.solve_ex(A, -b)[0]
        R_new, t_new = apply(R, t, dp)
        _, _, cost_new = build(R_new, t_new)
        accept = cost_new < cost_prev
        hist.append(cost_prev)
        R = torch.where(accept, R_new, R)
        t = torch.where(accept, t_new, t)
        lam = torch.where(accept, lam * 0.5, lam * 4.0)
        cost_prev = torch.where(accept, cost_new, cost_prev)
    hist_t = torch.stack(hist) if hist else torch.zeros((0,), dtype=f32, device=dev)
    return g._replace(R=R, t=t), hist_t
