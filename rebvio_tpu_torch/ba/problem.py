"""Inverse-depth bundle adjustment with Schur-complement reduction
(rebvio_tpu/ba/problem.py).

Keyframe poses plus 1-DoF inverse-depth landmarks (REBVO's per-keyline rho),
optimized by damped Gauss-Newton.  The landmark block H_ll is diagonal, so
the camera system reduces to

    S  = H_pp - (B / H_ll)^T B
    dp = (S + lam D)^-1 (b_p - (B / H_ll)^T b_l)
    drho = -(b_l + B dp) / (H_ll + lam H_ll)

Fixed shapes with validity masks, as in JAX.  The observation Jacobians are
forward-mode derivatives of the reprojection residual at a zero
perturbation: one ``torch.func.jvp`` over a leading [13] copy of the
observations, each copy with one unit tangent (three ``jax.jacfwd`` under
``vmap`` in the JAX package).

No sum here depends on the order of a scatter: the pose blocks come from
one dense product of the observations' [O, 2, 6F] pose Jacobians (their
6x6 blocks placed by one-hot products over the F keyframes), and the
per-landmark sums (H_ll, b_l, B) from a segmented scan over the
observations sorted by landmark.  So two runs on the card give the same
bits, and ``optimize``'s accept/reject (a device select) cannot flip on a
last-bit difference.  Nothing in ``optimize`` reads a value back to the
host: the solve is ``torch.linalg.solve_ex`` without its error check.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import torch

from rebvio_tpu_torch.geometry import so3

f32 = torch.float32


class BAProblem(NamedTuple):
    """Fixed-shape BA problem: F keyframes, L landmarks, O observations.

    Landmark l is anchored in keyframe ``anchor_kf[l]`` at normalized image
    ray ``anchor_ray[l]`` (unit z), with inverse depth ``rho[l]``.
    Observation o sees landmark ``obs_lm[o]`` in keyframe ``obs_kf[o]`` at
    normalized coordinates ``obs_uv[o]`` (x/z, y/z)."""

    R: torch.Tensor            # [F,3,3] world-from-camera rotation
    t: torch.Tensor            # [F,3] camera position in world
    rho: torch.Tensor          # [L] inverse depth in the anchor frame
    anchor_kf: torch.Tensor    # [L] int32
    anchor_ray: torch.Tensor   # [L,3] (x, y, 1) normalized anchor ray
    obs_lm: torch.Tensor       # [O] int32 (-1 = invalid)
    obs_kf: torch.Tensor       # [O] int32
    obs_uv: torch.Tensor       # [O,2] normalized observed coords
    obs_w: torch.Tensor        # [O] observation weight (1/sigma)
    lm_valid: torch.Tensor     # [L] bool
    obs_valid: torch.Tensor    # [O] bool


class BATerms(NamedTuple):
    """Normal-equation accumulations of one problem (or one landmark shard):
    everything the reduced camera system and the landmark back-substitution
    need."""

    H_pp: torch.Tensor   # [F6, F6]
    b_p: torch.Tensor    # [F6]
    H_ll: torch.Tensor   # [L]
    b_l: torch.Tensor    # [L]
    B: torch.Tensor      # [L, F6] pose-landmark coupling, a row per landmark
    cost: torch.Tensor   # [] sum of squared weighted residuals
    n_obs: torch.Tensor  # [] int32


def _residual_local(dpa, dpb, drho, Ra, ta, Rb, tb, rho, ray, uv):
    """Reprojection residual [..., 2] under right-perturbations ``dpa``,
    ``dpb`` [..., 6] = (dw, dv) of the anchor and target poses and ``drho``
    [...] of the inverse depth; every argument broadcasts over the leading
    dimensions."""
    Ra_p = Ra @ so3.exp(dpa[..., :3])
    ta_p = ta + dpa[..., 3:]
    Rb_p = Rb @ so3.exp(dpb[..., :3])
    tb_p = tb + dpb[..., 3:]
    d = 1.0 / (rho + drho)
    Xw = (Ra_p @ (ray * d[..., None])[..., None])[..., 0] + ta_p
    Xb = (Rb_p.mT @ (Xw - tb_p)[..., None])[..., 0]
    z = Xb[..., 2]
    z_safe = torch.where(torch.abs(z) > 1e-9, z, 1e-9)
    return Xb[..., :2] / z_safe[..., None] - uv


def obs_jacobians(Ra, ta, Rb, tb, rho, ray, uv):
    """(residual [O,2], d r / d dpa [O,2,6], d r / d dpb [O,2,6], d r / d rho
    [O,2]) of O observations at zero perturbation: one ``jvp`` over 13 unit
    tangents."""
    O = rho.shape[0]
    dev, dt = rho.device, rho.dtype
    basis = torch.eye(13, dtype=dt, device=dev)
    z6 = torch.zeros((13, O, 6), dtype=dt, device=dev)
    z1 = torch.zeros((13, O), dtype=dt, device=dev)
    tangents = (basis[:, None, :6].expand(13, O, 6), basis[:, None, 6:12].expand(13, O, 6),
                basis[:, None, 12].expand(13, O))
    r13, J13 = torch.func.jvp(
        lambda a, b, c: _residual_local(a, b, c, Ra, ta, Rb, tb, rho, ray, uv),
        (z6, z6, z1), tangents)
    J = J13.permute(1, 2, 0)                  # [O, residual, perturbation]
    return r13[0], J[:, :, :6], J[:, :, 6:12], J[:, :, 12]


def _finite(x: torch.Tensor) -> torch.Tensor:
    return torch.where(torch.isfinite(x), x, 0.0)


def _gather_obs(p: BAProblem):
    """Clamped indices and the validity of every observation, as JAX clips
    them before its gathers: (landmark, keyframe, anchor keyframe) int64, ok."""
    F, L = p.R.shape[0], p.rho.shape[0]
    lm = torch.clamp(p.obs_lm, 0, L - 1).long()
    kf = torch.clamp(p.obs_kf, 0, F - 1).long()
    akf = torch.clamp(p.anchor_kf[lm], 0, F - 1).long()
    ok = p.obs_valid & (p.obs_lm >= 0) & p.lm_valid[lm]
    return lm, kf, akf, ok


def _weights(p: BAProblem, r: torch.Tensor, ok: torch.Tensor, huber_delta: float):
    w = torch.where(ok, p.obs_w, 0.0)
    if huber_delta > 0:
        rn = torch.linalg.vector_norm(r, dim=-1)
        w = w * torch.where(rn > huber_delta,
                            torch.sqrt(huber_delta / torch.where(rn > 0, rn, 1.0)), 1.0)
    return w


def _cost(rw: torch.Tensor, ok: torch.Tensor) -> torch.Tensor:
    """Sum of the squared weighted (finite) residuals of valid observations."""
    return torch.sum(torch.where(ok[:, None], rw * rw, 0.0))


def problem_cost(p: BAProblem, huber_delta: float = 0.0) -> torch.Tensor:
    """``accumulate_terms(p, huber_delta).cost`` without the Jacobians."""
    lm, kf, akf, ok = _gather_obs(p)
    r = _residual_local(torch.zeros(6, dtype=f32, device=p.rho.device),
                        torch.zeros(6, dtype=f32, device=p.rho.device),
                        torch.zeros((), dtype=f32, device=p.rho.device),
                        p.R[akf], p.t[akf], p.R[kf], p.t[kf], p.rho[lm], p.anchor_ray[lm],
                        p.obs_uv)
    return _cost(_finite(r * _weights(p, r, ok, huber_delta)[:, None]), ok)


def segment_sums(values: torch.Tensor, key: torch.Tensor, n: int) -> torch.Tensor:
    """Rows of ``values`` [O, C] summed by ``key`` [O] (in [0, n)) into [n, C],
    in an order fixed by the keys alone: a stable sort by key, then a
    Hillis-Steele segmented inclusive scan (log2 O steps), and each
    segment's last row gathered (zero for an empty segment)."""
    O = key.shape[0]
    k, order = torch.sort(key, stable=True)
    v = values[order]
    d = 1
    while d < O:
        same = (k[d:] == k[:-d])[:, None]
        v = torch.cat([v[:d], v[d:] + torch.where(same, v[:-d], 0.0)])
        d *= 2
    ids = torch.arange(n, dtype=k.dtype, device=k.device)
    start = torch.searchsorted(k, ids)
    end = torch.searchsorted(k, ids, right=True)
    return torch.where((end > start)[:, None], v[torch.clamp(end - 1, min=0)], 0.0)


def accumulate_terms(p: BAProblem, huber_delta: float = 0.0) -> BATerms:
    """The (masked) normal equations of all observations."""
    F, L = p.R.shape[0], p.rho.shape[0]
    F6 = 6 * F
    lm, kf, akf, ok = _gather_obs(p)
    r, Ja, Jb, Jr = obs_jacobians(p.R[akf], p.t[akf], p.R[kf], p.t[kf], p.rho[lm],
                                  p.anchor_ray[lm], p.obs_uv)
    w = _weights(p, r, ok, huber_delta)
    r = _finite(r * w[:, None])
    cost = _cost(r, ok)
    Ja = _finite(Ja * w[:, None, None])
    Jb = _finite(Jb * w[:, None, None])
    Jr = _finite(Jr * w[:, None])

    # the observations' pose Jacobians [O, 2, 6F]: Ja in keyframe akf's
    # block, Jb in kf's (their sum where the two coincide)
    frames = torch.arange(F, device=p.R.device)
    Sa = (akf[:, None] == frames).to(f32)
    Sb = (kf[:, None] == frames).to(f32)
    Jp = (Sa[:, None, :, None] * Ja[:, :, None, :]
          + Sb[:, None, :, None] * Jb[:, :, None, :]).reshape(-1, F6)
    H_pp = Jp.T @ Jp
    b_p = Jp.T @ r.reshape(-1)
    # per landmark: B's row (Jp^T Jr), H_ll (Jr^T Jr), b_l (Jr^T r)
    JpTJr = torch.einsum("ocp,oc->op", Jp.reshape(-1, 2, F6), Jr)
    okf = ok.to(f32)
    per_obs = torch.cat([JpTJr, (torch.sum(Jr * Jr, -1) * okf)[:, None],
                         (torch.sum(Jr * r, -1) * okf)[:, None]], dim=1)
    per_lm = segment_sums(per_obs, lm, L)
    return BATerms(H_pp=H_pp, b_p=b_p, H_ll=per_lm[:, F6], b_l=per_lm[:, F6 + 1],
                   B=per_lm[:, :F6], cost=cost, n_obs=torch.sum(ok).to(torch.int32))


def _landmark_inverse(terms: BATerms, lam: torch.Tensor) -> torch.Tensor:
    H_ll_d = terms.H_ll + lam * torch.clamp(terms.H_ll, min=1e-12)   # LM-style scaling
    return torch.where(terms.H_ll > 0, 1.0 / H_ll_d, 0.0)


def schur_reduce(terms: BATerms, lam: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Reduced camera system (S, rhs) of one shard's terms; landmarks with
    no observation (H_ll == 0) contribute nothing."""
    Bw = terms.B * _landmark_inverse(terms, lam)[:, None]
    return terms.H_pp - terms.B.T @ Bw, terms.b_p - Bw.T @ terms.b_l


def solve_reduced(S: torch.Tensor, rhs: torch.Tensor, lam: torch.Tensor,
                  fix_first: bool = True) -> torch.Tensor:
    """The damped reduced system's pose update; the gauge is fixed by
    clamping keyframe 0 (its rows and columns zeroed, an identity block).
    ``solve_ex`` without the error check: no host read of the
    factorization's status (a singular system gives a step that the
    caller's accept test rejects)."""
    F6 = S.shape[0]
    A = S + lam * torch.diag(torch.clamp(torch.diagonal(S), min=1e-8))
    if fix_first:
        mask = torch.arange(F6, device=S.device) >= 6
        A = torch.where(mask[:, None] & mask[None, :], A, 0.0) + torch.diag((~mask).to(f32))
        rhs = torch.where(mask, rhs, 0.0)
    return torch.linalg.solve_ex(A, -rhs, check_errors=False)[0]


def backsub_landmarks(terms: BATerms, dp: torch.Tensor, lam: torch.Tensor) -> torch.Tensor:
    return -(terms.b_l + terms.B @ dp) * _landmark_inverse(terms, lam)


def apply_update(p: BAProblem, dp: torch.Tensor, drho: torch.Tensor,
                 rho_min: float = 1e-4, rho_max: float = 1e3) -> BAProblem:
    d = dp.reshape(p.R.shape[0], 6)
    return p._replace(R=p.R @ so3.exp(d[:, :3]), t=p.t + d[:, 3:],
                      rho=torch.clamp(p.rho + drho, rho_min, rho_max))


def optimize(p: BAProblem, iters: int = 10, lam0: float = 1e-3, fix_first: bool = True,
             huber_delta: float = 0.0,
             reduce: Optional[Callable[[torch.Tensor], torch.Tensor]] = None
             ) -> Tuple[BAProblem, torch.Tensor]:
    """Damped Gauss-Newton with accept/reject (Levenberg-Marquardt style),
    the decision a device select.  Returns (optimized problem, [iters] cost
    history: the cost after each iteration's decision).  ``reduce`` sums a
    tensor over landmark shards (``ba/distributed.py``: an all-reduce),
    applied to S, rhs and each cost; None for one problem."""
    red = reduce if reduce is not None else (lambda x: x)
    lam = torch.full((), lam0, dtype=f32, device=p.rho.device)
    cost_prev = red(problem_cost(p, huber_delta))
    hist = []
    for _ in range(iters):
        terms = accumulate_terms(p, huber_delta)
        S, rhs = schur_reduce(terms, lam)
        dp = solve_reduced(red(S), red(rhs), lam, fix_first)
        p_new = apply_update(p, dp, backsub_landmarks(terms, dp, lam))
        cost_new = red(problem_cost(p_new, huber_delta))
        accept = cost_new < cost_prev
        p = p._replace(R=torch.where(accept, p_new.R, p.R), t=torch.where(accept, p_new.t, p.t),
                       rho=torch.where(accept, p_new.rho, p.rho))
        lam = torch.where(accept, lam * 0.5, lam * 4.0)
        cost_prev = torch.where(accept, cost_new, cost_prev)
        hist.append(cost_prev)
    hist_t = torch.stack(hist) if hist else torch.zeros((0,), dtype=f32, device=p.rho.device)
    return p, hist_t
