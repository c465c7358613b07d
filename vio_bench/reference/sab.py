"""Scale/Attitude/Bias MAP estimator (rebvio_tpu/ops/sab.py; reference
``SABEstimator``, sab_estimator.cpp, and ``Core::estimateBias``,
core.cpp:349-414).

The filter estimates X = [alpha, g(3), b(3)]: the scale angle alpha
(metric scale K = tan alpha), the gravity vector g and the visual rotation
bias b, by fusing the visual acceleration a_v against the accelerometer's
a_s (Eq. 40 of Tarrio & Pedre 2017).

``estimate_bias`` does the KF predict in PyTorch, then hands the solve to
kernel K3 (``kernels.estimate_bias``: the CUDA kernel on a CUDA tensor, its
plain version on a CPU tensor).  ``sab_problem`` / ``sab_gauss_newton`` are
the JAX package's XLA form (adjugate 3x3 inverse, Cholesky posterior),
ported for completeness and for the tests; ``estimate_bias(kernel=False)``
runs it.  It is not on the card's path.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch

from vio_bench.reference import linalg, so3
from vio_bench.reference import kernels

f32 = torch.float32


class SabProblem(NamedTuple):
    a_v: torch.Tensor   # [3] visual acceleration
    a_s: torch.Tensor   # [3] gravity-corrected acceleration
    G: torch.Tensor     # [] gravity norm
    x_p: torch.Tensor   # [7] prior state
    Pp: torch.Tensor    # [7,7] prior covariance
    W_pp: torch.Tensor  # [7,7] inverse of Pp
    Rv: torch.Tensor    # [3,3] visual acceleration noise
    Rs: torch.Tensor    # [3,3] accelerometer noise
    Rg: torch.Tensor    # [] gravity-norm noise
    W_rest: Optional[torch.Tensor] = None  # [8,11] bottom block of the weight matrix


def _w_rest(p: SabProblem) -> torch.Tensor:
    """The [8,11] bottom block of the residual weight: the 1/Rg row and the
    W_pp block, constant across Gauss-Newton iterations."""
    z = dict(dtype=f32, device=p.W_pp.device)
    r1 = torch.cat([torch.zeros((1, 3), **z), (1.0 / p.Rg).reshape(1, 1),
                    torch.zeros((1, 7), **z)], dim=1)
    r2 = torch.cat([torch.zeros((7, 4), **z), p.W_pp], dim=1)
    return torch.cat([r1, r2])


def sab_problem(p: SabProblem, X: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(JtJ, JtF) of the weighted 11-D residual at X (sab_estimator.cpp:40-165),
    with the dW/dalpha terms of the alpha-dependent measurement covariance."""
    z = dict(dtype=f32, device=X.device)
    a, g, b = X[0], X[1:4], X[4:7]
    sa, ca = torch.sin(a), torch.cos(a)
    eye3 = torch.eye(3, **z)
    z33 = torch.zeros((3, 3), **z)

    da = a - p.x_p[0]
    da = torch.where(da > math.pi, da - 2 * math.pi,
                     torch.where(da < -math.pi, da + 2 * math.pi, da))
    Rb = so3.exp(b)
    Rg_vec = Rb @ g
    F = torch.cat([(p.a_s + g) * ca - p.a_v * sa,
                   torch.stack([torch.dot(g, g) - p.G * p.G, da]),
                   Rg_vec - p.x_p[1:4], b - p.x_p[4:7]])
    dFda = torch.cat([-(p.a_s + g) * sa - p.a_v * ca, torch.tensor([0.0, 1.0], **z),
                      torch.zeros(6, **z)])
    dFdx1 = torch.cat([
        torch.cat([eye3 * ca, z33], dim=1),
        torch.cat([2.0 * g, torch.zeros(3, **z)])[None, :],
        torch.zeros((1, 6), **z),
        torch.cat([Rb, -so3.hat(Rg_vec)], dim=1),
        torch.cat([z33, eye3], dim=1),
    ])

    Pz = sa * sa * p.Rv + ca * ca * p.Rs
    W0 = linalg.invert3(Pz)  # symmetric 3x3: closed form
    rest = p.W_rest if p.W_rest is not None else _w_rest(p)
    W = torch.cat([torch.cat([W0, torch.zeros((3, 8), **z)], dim=1), rest])

    # dW/da and dW@P@dW are nonzero only in the leading 3x3 block
    dP0 = 2.0 * sa * ca * (p.Rv - p.Rs)
    dWda0 = -W0 @ dP0 @ W0
    dWPdW0 = dWda0 @ Pz @ dWda0
    F0, dFda0 = F[0:3], dFda[0:3]

    WF = W @ F
    WdFda = W @ dFda
    j00 = 0.25 * F0 @ dWPdW0 @ F0 + dFda0 @ (dWda0 @ F0) + dFda @ WdFda
    dWdaF_pad = torch.cat([dWda0 @ F0, torch.zeros(8, **z)])
    col = dFdx1.T @ (0.5 * dWdaF_pad + WdFda)
    JtJ = torch.cat([
        torch.cat([j00.reshape(1), col])[None, :],
        torch.cat([col[:, None], dFdx1.T @ W @ dFdx1], dim=1),
    ])
    JtF = torch.cat([(0.5 * F0 @ (dWda0 @ F0) + dFda @ WF).reshape(1), dFdx1.T @ WF])
    return JtJ, JtF


_BIAS_SAT = 5e-1 / 25  # saturation limit on b (sab_estimator.cpp:34)


def sab_gauss_newton(p: SabProblem, X0: torch.Tensor, iters: int = 8) -> torch.Tensor:
    """Fixed-iteration Gauss-Newton with angle wrapping and bias saturation
    (sab_estimator.cpp:21-38); the 7x7 solve is the pivot-free Gauss-Jordan
    with gj_solve's NaN semantics (linalg.sym_solve)."""
    X = X0
    for _ in range(iters):
        JtJ, JtF = sab_problem(p, X)
        X = X + linalg.sym_solve(JtJ, -JtF)
        X = torch.cat([torch.atan2(torch.sin(X[0]), torch.cos(X[0])).reshape(1), X[1:4],
                       torch.clamp(X[4:7], -_BIAS_SAT, _BIAS_SAT)])
    return X


class EstimateBiasOut(NamedTuple):
    K: torch.Tensor       # [] metric scale tan(alpha)
    X: torch.Tensor       # [7] posterior state
    P: torch.Tensor       # [7,7] posterior covariance
    g_est: torch.Tensor   # [3]
    b_est: torch.Tensor   # [3]
    Xvw: torch.Tensor     # [6] bias-refused rigid transform correction


def _blocks_7x7(a: torch.Tensor, M: torch.Tensor, N: torch.Tensor) -> torch.Tensor:
    """The 7x7 block diagonal diag(a, M, N) of a [] and two [3,3], zeros
    elsewhere, assembled out of place (so that it batches under vmap)."""
    z3 = torch.zeros((3, 3), dtype=M.dtype, device=M.device)
    zc = torch.zeros((3, 1), dtype=M.dtype, device=M.device)
    row0 = torch.cat([a.reshape(1), torch.zeros(6, dtype=M.dtype, device=M.device)])[None]
    return torch.cat([row0, torch.cat([zc, M, z3], dim=1), torch.cat([zc, z3, N], dim=1)])


def estimate_bias(a_s, a_v, kP, Rot, X, P, Qg, Qrot, Qbias, QKp, Rg, Rs, Rv, Wvw, Xvw,
                  g_gravit, iters: int = 20, kernel: bool = True) -> EstimateBiasOut:
    """7-state KF predict + SAB Gauss-Newton update + re-fusion of the rigid
    transform with the bias information (core.cpp:349-414).  ``kernel``
    (the default) solves with K3; ``kernel=False`` with the XLA form."""
    z = dict(dtype=f32, device=X.device)
    # --- predict (core.cpp:355-373) ---
    F = _blocks_7x7(torch.as_tensor(kP, **z), Rot.T, torch.eye(3, **z))
    tan_a = torch.tan(X[0])
    GProd = -so3.hat(X[1:4])
    Q = _blocks_7x7(QKp / (1.0 + tan_a * tan_a), GProd.T @ Qrot @ GProd + Qg, Qbias)
    X = F @ X
    Pp = F @ P @ F.T + Q

    # --- nonlinear posterior (core.cpp:376-384) ---
    W_pp = linalg.chol_inverse(Pp)
    prob = SabProblem(a_v=a_v, a_s=a_s, G=g_gravit, x_p=X, Pp=Pp, W_pp=W_pp, Rv=Rv, Rs=Rs,
                      Rg=Rg)
    prob = prob._replace(W_rest=_w_rest(prob))
    if kernel:
        K, Xo, Po, Xvw_o = kernels.estimate_bias(
            *(t.contiguous() for t in (a_s, a_v, X, prob.W_rest, Rs, Rv, Wvw, Xvw, g_gravit)),
            iters)
        return EstimateBiasOut(K=K, X=Xo, P=Po, g_est=Xo[1:4], b_est=Xo[4:7], Xvw=Xvw_o)
    X = sab_gauss_newton(prob, X, iters)
    JtJ, _ = sab_problem(prob, X)
    P = linalg.chol_inverse(JtJ)
    k = torch.tan(X[0])
    k = torch.where((k < 0) | ~torch.isfinite(k), 0.0, k)
    b_est = X[4:7]
    # --- re-fuse the rigid transform with the bias information (core.cpp:394-405) ---
    WVBias = JtJ[4:7, 4:7]
    z3 = torch.zeros((3, 3), **z)
    Wb = torch.cat([torch.cat([z3, z3], dim=1), torch.cat([z3, WVBias], dim=1)])
    WXc = torch.cat([torch.zeros(3, **z), WVBias @ (Xvw[3:6] - b_est)])
    Xc = linalg.chol_inverse(Wb + Wvw) @ (Wvw @ Xvw + WXc)
    return EstimateBiasOut(K=k, X=X, P=P, g_est=X[1:4], b_est=b_est, Xvw=Xc)
