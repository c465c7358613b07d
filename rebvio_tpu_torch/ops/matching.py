"""Edge-map operations: rotation, sigma quantile, forward matching, the tube
matcher and depth regularization (rebvio_tpu/ops/matching.py; reference
edge_map.cpp)."""

from __future__ import annotations

import math
from typing import Tuple

import torch

from rebvio_tpu_torch import types as T
from rebvio_tpu_torch.configs import CameraConfig, CoreConfig, EdgeMapConfig
from rebvio_tpu_torch.ops import kernels

_F32_MAX = torch.finfo(torch.float32).max
f32, i32 = torch.float32, torch.int32


def rotate_keylines(em: T.EdgeMap, R: torch.Tensor, fm: float) -> T.EdgeMap:
    """Forward-rotate keyline positions, gradients and inverse depth
    (edge_map.cpp:58-71); the gradient norm stays stale, as in the
    reference.  ``R`` may carry leading candidate dimensions ``[..., 3, 3]``:
    the rotated fields then come back as ``[..., K, 2]`` / ``[..., K]``."""
    x = em.pos_img[:, 0] / fm
    y = em.pos_img[:, 1] / fm
    q = torch.stack([x, y, torch.ones_like(x)], dim=-1) @ R.mT
    qz = q[..., 2]
    ok = torch.abs(qz) > 0.0
    qz_safe = torch.where(ok, qz, 1.0)
    new_pos_img = torch.stack([q[..., 0] / qz_safe * fm, q[..., 1] / qz_safe * fm], dim=-1)
    pos_img = torch.where(ok[..., None], new_pos_img, em.pos_img)
    rho = torch.where(ok, em.rho / qz_safe, em.rho)
    sigma_rho = torch.where(ok, em.sigma_rho / qz_safe, em.sigma_rho)
    g = torch.stack([em.grad[:, 0], em.grad[:, 1], torch.zeros_like(x)], dim=-1) @ R.mT
    return em.replace(pos_img=pos_img, rho=rho, sigma_rho=sigma_rho,
                      grad=g[..., :2].contiguous())


def estimate_quantile(em: T.EdgeMap, percentile: float, num_bins: int) -> torch.Tensor:
    """sigma_rho histogram percentile (edge_map.cpp:39-56): the lower edge
    of the first bin whose preceding cumulative count exceeds
    percentile * size."""
    span = T.RHO_MAX - T.RHO_MIN
    b = (num_bins * (em.sigma_rho - T.RHO_MIN) / span).to(torch.int64)
    b = torch.clamp(b, 0, num_bins - 1)
    hist = torch.zeros((num_bins,), dtype=torch.int64, device=b.device)
    hist = hist.index_add(0, b, em.valid.to(torch.int64))
    csum = torch.cumsum(hist, 0)
    prefix = torch.cat([torch.zeros((1,), dtype=torch.int64, device=b.device), csum[:-1]])
    cut = percentile * em.count.to(f32)
    found = prefix.to(f32) > cut
    i = torch.argmax(found.to(torch.int32))
    val = i.to(f32) * span / num_bins + T.RHO_MIN
    return torch.where(found.any(), val, 1e3)


def forward_match(old: T.EdgeMap, new: T.EdgeMap) -> Tuple[T.EdgeMap, torch.Tensor]:
    """Propagate depth from the tracked old keylines into the new map
    (edge_map.cpp:73-99).  Per target the candidate with the largest rho
    wins, ties to the largest keyline index: a stable ascending sort of rho
    ranks candidates by (rho, index), and one scatter-max of rank+1 per
    target picks the winner deterministically."""
    kmax = new.kmax
    dev = new.rho.device
    cand = old.valid & (old.match_id_forward >= 0)
    tgt = torch.where(cand, old.match_id_forward, kmax).to(torch.int64)
    order = torch.argsort(torch.where(cand, old.rho, -_F32_MAX), stable=True)
    rank_of = torch.empty_like(order)
    rank_of[order] = torch.arange(kmax, device=dev)
    win_key = torch.zeros((kmax + 1,), dtype=torch.int64, device=dev)
    win_key = win_key.scatter_reduce(0, tgt, torch.where(cand, rank_of + 1, 0),
                                     reduce="amax")[:kmax]
    matched = win_key > 0
    w = order[torch.clamp(win_key - 1, 0, kmax - 1)]
    mv = matched[:, None]
    new = new.replace(
        rho=torch.where(matched, old.rho[w], new.rho),
        sigma_rho=torch.where(matched, old.sigma_rho[w], new.sigma_rho),
        matches=torch.where(matched, old.matches[w] + 1, new.matches),
        match_id=torch.where(matched, w.to(i32), new.match_id),
        match_pos_img=torch.where(mv, old.pos_img[w], new.match_pos_img),
        match_grad=torch.where(mv, old.grad[w], new.match_grad),
        match_grad_norm=torch.where(matched, old.grad_norm[w], new.match_grad_norm),
        match_id_keyframe=torch.where(matched, old.match_id_keyframe[w],
                                      new.match_id_keyframe),
    )
    return new, matched.sum().to(i32)


def _tube_match(new: T.EdgeMap, old: T.EdgeMap, vel, Rvel, Rback, cfg: EdgeMapConfig,
                core_cfg: CoreConfig, cam: CameraConfig, n_probes: int, field_scale: int,
                grad_rot2):
    """The epipolar geometry of every new keyline, then kernel K4: returns
    K4's [12, K] output (kernels.TUBE_OUT) and R_tot = Rback.T."""
    kmax = new.kmax
    H, W = old.kl_id_img.shape
    dev = new.rho.device
    fm = cam.fm
    max_radius = core_cfg.search_range
    pum = cfg.pixel_uncertainty_match
    P = n_probes or cfg.tube_probes

    vel_b = Rback @ vel
    Rvel_b = Rback @ Rvel @ Rback.T
    p = torch.cat([new.pos_img, torch.full((kmax, 1), fm, dtype=f32, device=dev)],
                  dim=-1) @ Rback.T
    pz = torch.where(p[:, 2] != 0, p[:, 2], 1e-20)
    pmx = p[:, 0] * fm / pz
    pmy = p[:, 1] * fm / pz
    k_rho = new.rho * fm / pz
    pi0x = pmx + cam.cx
    pi0y = pmy + cam.cy

    t_x = -(vel_b[0] * fm - vel_b[2] * pmx)
    t_y = -(vel_b[1] * fm - vel_b[2] * pmy)
    norm_t = torch.sqrt(t_x * t_x + t_y * t_y)
    DrDv = torch.stack([torch.full_like(pmx, fm), torch.full_like(pmx, fm), -(pmx + pmy)],
                       dim=-1)
    sigma2_t = torch.einsum("ki,ij,kj->k", DrDv, Rvel_b, DrDv)

    main = norm_t > 1e-6
    nt_safe = torch.where(main, norm_t, 1.0)
    dq_rho_m = norm_t * k_rho
    dq_min_m = torch.clamp(norm_t * (k_rho - new.sigma_rho), min=0.0) - pum
    dq_max_m = torch.clamp(norm_t * (k_rho + new.sigma_rho), max=max_radius) + pum
    over = dq_rho_m > dq_max_m
    dq_rho_m2 = torch.where(over, 0.5 * (dq_max_m + dq_min_m), dq_rho_m)
    gn_safe = torch.where(new.grad_norm > 0, new.grad_norm, 1.0)
    tx = torch.where(main, t_x / nt_safe, new.grad[:, 0] / gn_safe)
    ty = torch.where(main, t_y / nt_safe, new.grad[:, 1] / gn_safe)
    nt_eff = torch.where(main, norm_t, 1.0)
    dq_rho = torch.where(main, dq_rho_m2, 0.0)
    dq_min = torch.where(main, dq_min_m, -max_radius - pum)
    dq_max = torch.where(main, dq_max_m, max_radius + pum)

    R_tot = Rback.T
    M2 = (R_tot[:2, :2] if grad_rot2 is None else grad_rot2).contiguous()
    kl = torch.stack([tx, ty, pi0x, pi0y, dq_min, dq_max, dq_rho, nt_eff, sigma2_t,
                      new.grad[:, 0], new.grad[:, 1], new.grad_norm, new.valid.to(f32)])
    dyn = torch.stack([old.rho, old.sigma_rho, old.matches.to(f32),
                       old.match_id_keyframe.to(f32)])
    geom = kernels.TubeGeom(P=P, H=H, W=W, field_scale=field_scale, pum=float(pum),
                            cang_min=math.cos(cfg.match_threshold_angle * math.pi / 180.0),
                            norm_thr=float(cfg.match_threshold_norm))
    return kernels.tube_match(kl, old.att_img.contiguous(), dyn, M2, geom), R_tot


def directed_match_tube(new: T.EdgeMap, old: T.EdgeMap, vel, Rvel, Rback,
                        cfg: EdgeMapConfig, core_cfg: CoreConfig, cam: CameraConfig,
                        n_probes: int = 0, field_scale: int = 1,
                        grad_rot2: torch.Tensor = None) -> Tuple[T.EdgeMap, torch.Tensor]:
    """Epipolar matching through the old map's nearest-keyline field (the
    TPU redesign of searchMatch, edge_map.cpp:101-184): per new keyline, the
    epipolar geometry here, then the probes, gathers, gates and winner in
    kernel K4 (kernels.tube_match), then the winner's fields into the map
    (kernels.match_tail_plain).  Returns (map, klm).

    ``grad_rot2`` is the exact 2x2 replay of the old map's two in-flight
    gradient rotations (default Rback.T[:2, :2])."""
    o, R_tot = _tube_match(new, old, vel, Rvel, Rback, cfg, core_cfg, cam, n_probes,
                           field_scale, grad_rot2)
    planes, klm = kernels.match_tail_plain(
        o, *(getattr(new, k) for k in kernels.MATCH_PLANES), R_tot, cam.fm, cam.cx, cam.cy)
    return new.replace(**dict(zip(kernels.MATCH_PLANES, planes))), klm


def match_and_update_depth(new: T.EdgeMap, old: T.EdgeMap, vel, Rvel, Rback, fail_nan,
                           cfg: EdgeMapConfig, core_cfg: CoreConfig, cam: CameraConfig,
                           n_probes: int = 0, field_scale: int = 1,
                           grad_rot2: torch.Tensor = None):
    """The step's matcher and depth stage (rebvio_tpu/pipeline.py:227-253):
    directed_match_tube's geometry and kernel K4, then kernel K5 in one
    call: the winners into the map, the match count klm, the failure gate
    (``fail_nan`` [] bool: the velocity is NaN) and, where the frame did not
    fail, regularization and the depth EKF (kernels.match_reg_ekf).  Returns
    (post-depth map, klm [] int32, failed [] bool), all on the device."""
    o, R_tot = _tube_match(new, old, vel, Rvel, Rback, cfg, core_cfg, cam, n_probes,
                           field_scale, grad_rot2)
    p = kernels.MatchRegEkfParams(
        threshold=float(cfg.regularization_threshold), q_abs2=core_cfg.reshape_q_abs ** 2,
        pu2=float(core_cfg.pixel_uncertainty) ** 2, fm=cam.fm, cx=cam.cx, cy=cam.cy,
        min_matches=int(core_cfg.global_min_matches_threshold))
    out = kernels.match_reg_ekf(
        o, new.rho, new.sigma_rho, new.grad.contiguous(), new.grad_norm, new.id_next,
        new.id_prev, new.valid, new.match_id, new.matches, new.match_id_keyframe,
        new.pos_img.contiguous(), new.match_pos_img.contiguous(), new.match_grad.contiguous(),
        new.match_grad_norm, vel.contiguous(), R_tot.contiguous(), fail_nan, p)
    return new.replace(**dict(zip(kernels.MATCH_PLANES, out[:8]))), out[8], out[9]


def regularize_1iter(em: T.EdgeMap, threshold: float) -> T.EdgeMap:
    """One Jacobi-style depth regularization pass (edge_map.cpp:220-259)."""
    rho, sr = kernels.regularize_plain(em.rho, em.sigma_rho, em.grad, em.grad_norm,
                                       em.id_next, em.id_prev, em.valid, threshold)
    return em.replace(rho=rho, sigma_rho=sr)
