"""Tracker core: the translation LM against the attribute field, the 6-DoF
linear refinement and the per-keyline depth update (rebvio_tpu/ops/
tracker.py; reference core.cpp).  The LM solve with all its tryVel passes is
kernel K2 (kernels.minimize_vel; kernels.try_vel is its single pass) and the
depth stage is kernel K5 (kernels.reg_ekf).  The reference's raster id field
reaches K2 through ``raster_att``, a table in the attribute field's layout."""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from vio_bench.reference import types as T
from vio_bench.reference.configs import CameraConfig, CoreConfig
from vio_bench.reference import linalg
from vio_bench.reference import kernels
from vio_bench.reference.matching import estimate_quantile

f32 = torch.float32


def _use_mask(old: T.EdgeMap, sigma_rho_min) -> torch.Tensor:
    """Participation gate of tryVel (core.cpp:88-91) as a float mask."""
    use = old.valid & (old.sigma_rho <= sigma_rho_min)
    use = use & ((old.threshold <= 0.0) | (old.grad_norm >= old.threshold))
    return use.to(f32)


class TryVelOut(NamedTuple):
    """One tryVel pass (tracker.TryVelOut)."""

    score: torch.Tensor             # [] f32
    JtJ: torch.Tensor               # [3, 3]
    JtF: torch.Tensor               # [3]
    residuals: torch.Tensor         # [K]
    match_id_forward: torch.Tensor  # [K] int32


def pack_target_fields(new: T.EdgeMap) -> torch.Tensor:
    """``[K, 8]`` per-keyline fields of the field's map
    (tracker.pack_target_fields): grad x, y, grad_norm, pos x, y, then three
    zero columns."""
    z = torch.zeros((new.kmax, 3), dtype=f32, device=new.pos.device)
    return torch.cat([new.grad, new.grad_norm[:, None], new.pos, z], dim=-1)


def raster_att(new: T.EdgeMap, field_ids: torch.Tensor) -> torch.Tensor:
    """The id-field route of tryVel (rebvio_tpu/ops/tracker.py:146-160,
    ``use_att=False``) as a ``[8, N]`` table in the attribute field's plane
    layout, for kernel K2 at ``field_scale`` 1: plane ATT_ID holds the field's
    id as float32 (-1: empty), planes ATT_GX..ATT_POSY the target keyline's
    grad, grad_norm and pos (pack_target_fields) gathered at the id clipped
    to the target map's size.  K2 reads planes 2-7 only; planes 0-1 are
    zero.  Per cell this is exactly JAX's two chained gathers: a negative id
    never matches, so the clipped row it reads is never used."""
    N = field_ids.shape[0]
    pack = pack_target_fields(new)[:, :5].T
    return torch.cat([torch.zeros((2, N), dtype=f32, device=field_ids.device),
                      field_ids.to(f32)[None],
                      pack[:, torch.clamp(field_ids, 0, new.kmax - 1).to(torch.int64)]])


def try_vel(old: T.EdgeMap, att: torch.Tensor, vel, sigma_rho_min, residuals,
            cfg: CoreConfig, cam: CameraConfig, field_scale: int = 1):
    """One residual/Jacobian pass of the translation tracker (core.cpp:78-148)
    against the new map's ``[8, N]`` attribute field.  Returns a TryVelOut
    (score, JtJ, JtF, residuals, match_id_forward)."""
    H, W = old.kl_id_img.shape
    geom = _try_vel_geom(H, W, field_scale, cfg, cam)
    return TryVelOut(*kernels.try_vel(old.pos_img.contiguous(), old.rho, old.sigma_rho,
                                      old.grad.contiguous(), _use_mask(old, sigma_rho_min),
                                      residuals, vel, att, geom))


def _try_vel_geom(H, W, field_scale, cfg: CoreConfig, cam: CameraConfig):
    return kernels.TryVelGeom(H=H, W=W, field_scale=field_scale, fm=cam.fm, cx=cam.cx,
                              cy=cam.cy, R=float(cfg.search_range),
                              rw=float(cfg.reweight_distance),
                              mthr=float(cfg.match_threshold))


def minimize_vel(old: T.EdgeMap, att: torch.Tensor, vel0: torch.Tensor, cfg: CoreConfig,
                 cam: CameraConfig, field_scale: int = 1):
    """Levenberg-Marquardt translation estimation (core.cpp:150-189).

    Returns (vel, Rvel, old map with the forward matches, score).  The
    forward matches and residuals are those of the LAST pass, accepted or
    not, as in the reference.  The whole loop (1 + ``cfg.iterations`` tryVel
    passes and the LM update between them) is one launch of kernel K2
    (kernels.minimize_vel), without host round trips."""
    H, W = old.kl_id_img.shape
    geom = _try_vel_geom(H, W, field_scale, cfg, cam)
    sigma_rho_min = estimate_quantile(old, cfg.quantile_cutoff, cfg.quantile_num_bins)
    use_f = _use_mask(old, sigma_rho_min)
    pos_img = old.pos_img.contiguous()
    grad = old.grad.contiguous()
    att = att.contiguous()

    vel, JtJ, _JtF, F, _residuals, mif = kernels.minimize_vel(
        pos_img, old.rho, old.sigma_rho, grad, use_f, vel0.contiguous(), att, geom,
        cfg.iterations)
    Rvel = linalg.invert3(JtJ)
    return vel, Rvel, old.replace(match_id_forward=mif), F


def ext_rot_vel(new: T.EdgeMap, vel: torch.Tensor, cfg: CoreConfig,
                cam: CameraConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """Linearized 6-DoF refinement from the forward matches
    (core.cpp:191-261).  Returns (X, Wx = JtJ)."""
    fm = cam.fm
    m = new.valid & (new.match_id >= 0)
    gn_safe = torch.where(new.grad_norm > 0, new.grad_norm, 1.0)
    u_x = new.grad[:, 0] / gn_safe
    u_y = new.grad[:, 1] / gn_safe
    rho_t = 1.0 / (1.0 / torch.where(new.rho != 0, new.rho, 1e-20) + vel[2])
    mpx, mpy = new.match_pos_img[:, 0], new.match_pos_img[:, 1]
    qtx = mpx + rho_t * (vel[0] * fm - vel[2] * mpx)
    qty = mpy + rho_t * (vel[1] * fm - vel[2] * mpy)
    q_x = new.pos_img[:, 0]
    q_y = new.pos_img[:, 1]
    phi = torch.stack([
        u_x * rho_t * fm,
        u_y * rho_t * fm,
        u_x * (-rho_t * q_x) + u_y * (-rho_t * q_y),
        -u_x * q_x * q_y / fm - u_y * (fm + q_y * q_y / fm),
        u_y * q_x * q_y / fm + u_x * (fm + q_x * q_x / fm),
        -u_x * q_y + u_y * q_x,
    ], dim=-1)
    Y = u_x * (q_x - qtx) + u_y * (q_y - qty)
    dqvel = u_x * (vel[0] * fm - vel[2] * mpx) + u_y * (vel[1] * fm - vel[2] * mpy)
    s_y = torch.sqrt((new.sigma_rho * new.sigma_rho) * (dqvel * dqvel)
                     + cfg.pixel_uncertainty ** 2)
    w = torch.where(torch.abs(Y) > cfg.reweight_distance,
                    torch.abs(Y) / cfg.reweight_distance, 1.0)
    scale = 1.0 / (s_y * w)
    phi = torch.where(m[:, None], phi * scale[:, None], 0.0)
    Y = torch.where(m, Y * scale, 0.0)
    A = torch.cat([phi, Y[:, None]], dim=-1)
    G = linalg.lane_matmul(A.T, A)
    JtJ = G[:6, :6]
    JtF = G[:6, 6]
    return linalg.sym_solve(JtJ, JtF), JtJ


def gyro_bias_correction(X: torch.Tensor, Wx: torch.Tensor, Wb: torch.Tensor,
                         Rg: torch.Tensor, Rb: torch.Tensor):
    """Information-form gyro-bias fusion, Eq. 27 of the 2017 paper
    (core.cpp:264-282).  Returns (X', Wx', Wb', dgbias)."""
    Wg = linalg.invert3(Rg)
    Wb1 = linalg.invert3(linalg.invert3(Wb) + Rb)
    iWgWb = linalg.invert3(Wg + Wb1)
    eye3 = torch.eye(3, dtype=f32, device=X.device)
    Wxb = _add_lower_right(Wx, Wg @ (eye3 - iWgWb @ Wg))
    X1 = Wx @ X  # (the dgbias-prior term is identically zero, core.cpp:276)
    X_new = linalg.chol_inverse(Wxb) @ X1
    dgbias = iWgWb @ (Wg @ X_new[3:])
    return X_new, _add_lower_right(Wx, Wg), Wg + Wb1, dgbias


def _add_lower_right(M: torch.Tensor, D: torch.Tensor) -> torch.Tensor:
    """``M`` [6,6] with ``D`` [3,3] added to its lower-right block, out of
    place (so that it batches under vmap whatever is batched)."""
    return torch.cat([M[:3], torch.cat([M[3:, :3], M[3:, 3:] + D], dim=1)])


def regularize_and_update_depth(em: T.EdgeMap, vel: torch.Tensor, threshold: float,
                                cfg: CoreConfig, cam: CameraConfig) -> T.EdgeMap:
    """regularize_1iter + updateInverseDepthARLU as one stage (kernel K5)."""
    p = kernels.RegEkfParams(threshold=float(threshold), q_abs2=cfg.reshape_q_abs ** 2,
                             pu2=float(cfg.pixel_uncertainty) ** 2, fm=cam.fm)
    rho, sr = kernels.reg_ekf(em.rho, em.sigma_rho, em.grad.contiguous(), em.grad_norm,
                              em.id_next, em.id_prev, em.valid, em.match_id,
                              em.pos_img.contiguous(), em.match_pos_img.contiguous(),
                              em.match_grad.contiguous(), em.match_grad_norm,
                              vel.contiguous(), p)
    return em.replace(rho=rho, sigma_rho=sr)


def update_inverse_depth(em: T.EdgeMap, vel: torch.Tensor, cfg: CoreConfig,
                         cam: CameraConfig) -> T.EdgeMap:
    """Per-keyline scalar inverse-depth EKF (core.cpp:417-456)."""
    rho, sr = kernels.ekf_plain(em.rho, em.sigma_rho, em.valid, em.match_id, em.pos_img,
                                em.match_pos_img, em.match_grad, em.match_grad_norm, vel,
                                cfg.reshape_q_abs ** 2, float(cfg.pixel_uncertainty) ** 2,
                                cam.fm)
    return em.replace(rho=rho, sigma_rho=sr)
