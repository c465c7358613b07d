"""Edge-map operations: rotation, sigma quantile, forward matching, the tube
matcher, the reference's pixel-walk matcher and depth regularization
(rebvio_tpu/ops/matching.py; reference edge_map.cpp)."""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import numpy as np
import torch

from vio_bench.reference import types as T
from vio_bench.reference.configs import CameraConfig, CoreConfig, EdgeMapConfig
from vio_bench.reference import kernels
from vio_bench.reference.edge_detect import compact_raster

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
    rank_of = torch.empty_like(order).scatter(0, order, torch.arange(kmax, device=dev))
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


class _Epipolar(NamedTuple):
    """Per new keyline, the epipolar search line in the old image
    (edge_map.cpp:106-149): direction, seed pixel, window and the
    translation's pixel scale and variance; ``t_steps`` (with ``walk``, else
    None): the reference's walk length, float32 (cast as astype(int32) does:
    truncated toward zero, saturated, NaN to 0)."""

    tx: torch.Tensor
    ty: torch.Tensor
    pi0x: torch.Tensor
    pi0y: torch.Tensor
    dq_min: torch.Tensor
    dq_max: torch.Tensor
    dq_rho: torch.Tensor
    nt_eff: torch.Tensor
    sigma2_t: torch.Tensor
    t_steps: torch.Tensor


def _trunc_i32(x: torch.Tensor) -> torch.Tensor:
    """``x.astype(int32)`` as float32: truncation toward zero, saturated at
    the int32 range (whose top, 2^31 - 1, is 2^31 in float32), NaN to 0."""
    return torch.clamp(torch.trunc(torch.nan_to_num(x, nan=0.0)), -2.0 ** 31, 2.0 ** 31)


def _epipolar(new: T.EdgeMap, vel, Rvel, Rback, cfg: EdgeMapConfig, core_cfg: CoreConfig,
              cam: CameraConfig, walk: bool = False) -> _Epipolar:
    kmax = new.kmax
    dev = new.rho.device
    fm = cam.fm
    max_radius = core_cfg.search_range
    pum = cfg.pixel_uncertainty_match

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
    t_steps = None
    if walk:
        t_steps_m = torch.where(over, _trunc_i32(dq_rho_m2 + 0.5),
                                _trunc_i32(torch.maximum(dq_max_m - dq_rho_m2,
                                                         dq_rho_m2 - dq_min_m)))
        # the zero-velocity branch walks the whole window (edge_map.cpp:138-149)
        t_steps_z = math.trunc(float(np.float32(max_radius + pum)))
        t_steps = torch.where(main, t_steps_m, float(t_steps_z))
    gn_safe = torch.where(new.grad_norm > 0, new.grad_norm, 1.0)
    return _Epipolar(
        tx=torch.where(main, t_x / nt_safe, new.grad[:, 0] / gn_safe),
        ty=torch.where(main, t_y / nt_safe, new.grad[:, 1] / gn_safe),
        pi0x=pi0x, pi0y=pi0y,
        dq_min=torch.where(main, dq_min_m, -max_radius - pum),
        dq_max=torch.where(main, dq_max_m, max_radius + pum),
        dq_rho=torch.where(main, dq_rho_m2, 0.0),
        nt_eff=torch.where(main, norm_t, 1.0),
        sigma2_t=sigma2_t, t_steps=t_steps)


def _tube_match(new: T.EdgeMap, old: T.EdgeMap, vel, Rvel, Rback, cfg: EdgeMapConfig,
                core_cfg: CoreConfig, cam: CameraConfig, n_probes: int, field_scale: int,
                grad_rot2):
    """The epipolar geometry of every new keyline, then kernel K4: returns
    K4's [12, K] output (kernels.TUBE_OUT) and R_tot = Rback.T."""
    H, W = old.kl_id_img.shape
    P = n_probes or cfg.tube_probes
    e = _epipolar(new, vel, Rvel, Rback, cfg, core_cfg, cam)
    R_tot = Rback.T
    M2 = (R_tot[:2, :2] if grad_rot2 is None else grad_rot2).contiguous()
    kl = torch.stack([e.tx, e.ty, e.pi0x, e.pi0y, e.dq_min, e.dq_max, e.dq_rho, e.nt_eff,
                      e.sigma2_t, new.grad[:, 0], new.grad[:, 1], new.grad_norm,
                      new.valid.to(f32)])
    dyn = torch.stack([old.rho, old.sigma_rho, old.matches.to(f32),
                       old.match_id_keyframe.to(f32)])
    geom = kernels.TubeGeom(P=P, H=H, W=W, field_scale=field_scale,
                            pum=float(cfg.pixel_uncertainty_match),
                            cang_min=math.cos(cfg.match_threshold_angle * math.pi / 180.0),
                            norm_thr=float(cfg.match_threshold_norm))
    return kernels.tube_match(kl, old.att_img.contiguous(), dyn, M2, geom), R_tot


# the pixel walk's two phases (rebvio_tpu/ops/matching.py:255-258)
WALK_J_NEAR = 17        # phase 1: offsets m in [-8, 8] for every keyline
WALK_CAP = 4096         # phase 2: the keylines it re-walks over the whole window


def _walk(old: T.EdgeMap, q: dict, m_start: torch.Tensor, J: int, pum: float, cang_min: float,
          norm_thr: float):
    """Visit offsets m = m_start + 0..J-1 of each query keyline's walk
    t = dq_rho + m and return (found, old keyline id or -1) of the first hit
    in the reference's visit order: the tn side (m <= 0) at priority -2m, the
    tp side (m >= 1) at 2m - 1, the winner the priority argmin of the
    candidates that pass every gate (priorities are unique, so the first
    index of torch.argmin is jnp.argmin's)."""
    H, W = old.kl_id_img.shape
    kmax = old.rho.shape[0]
    m = m_start[:, None] + torch.arange(J, dtype=f32, device=m_start.device)[None, :]
    t = q["dq_rho"][:, None] + m
    ts_f = q["t_steps"][:, None]
    visited = torch.where(m <= 0, -m <= ts_f - 1.0, m <= ts_f)
    in_window = (t >= q["dq_min"][:, None]) & (t <= q["dq_max"][:, None])
    prio = torch.where(m <= 0, -2.0 * m, 2.0 * m - 1.0)

    cx_pix = q["tx"][:, None] * t + q["pi0x"][:, None]
    cy_pix = q["ty"][:, None] * t + q["pi0y"][:, None]
    col = torch.sign(cx_pix) * torch.floor(torch.abs(cx_pix) + 0.5)
    row = torch.sign(cy_pix) * torch.floor(torch.abs(cy_pix) + 0.5)
    inb = (row >= 0) & (row < H) & (col >= 0) & (col < W)
    pix = torch.where(inb, row * W + col, 0.0).to(torch.int64)
    oid = torch.where(inb, old.kl_id_img.reshape(-1)[pix], -1)
    has = oid >= 0
    os_ = torch.clamp(oid, 0, kmax - 1).to(torch.int64)

    grad_q, gn_q, nt_q = q["grad"], q["grad_norm"][:, None], q["nt_eff"][:, None]
    g_old = old.grad[os_]
    gn_old = old.grad_norm[os_]
    gdot = g_old[..., 0] * grad_q[:, None, 0] + g_old[..., 1] * grad_q[:, None, 1]
    denom = torch.where(gn_old * gn_q > 0, gn_old * gn_q, 1.0)
    gate_ang = gdot / denom >= cang_min
    gate_norm = torch.abs(gn_old / torch.where(gn_q > 0, gn_q, 1.0) - 1.0) <= norm_thr
    rho_old = old.rho[os_]
    sr_old = old.sigma_rho[os_]
    v_rho_dr = (pum * pum + sr_old * sr_old * nt_q ** 2
                + q["sigma2_t"][:, None] * rho_old * rho_old)
    resid = t - nt_q * rho_old
    gate_depth = ~(resid * resid > v_rho_dr)        # a NaN residual passes, as in JAX

    ok = (q["valid"][:, None] & visited & in_window & has & gate_ang & gate_norm
          & gate_depth)
    best = torch.argmin(torch.where(ok, prio, 1e9), dim=1, keepdim=True)
    found = torch.gather(ok, 1, best)[:, 0]
    return found, torch.where(found, torch.gather(oid, 1, best)[:, 0], -1)


def directed_match(new: T.EdgeMap, old: T.EdgeMap, vel, Rvel, Rback, cfg: EdgeMapConfig,
                   core_cfg: CoreConfig, cam: CameraConfig) -> Tuple[T.EdgeMap, torch.Tensor]:
    """The reference's epipolar pixel walk (searchMatch, edge_map.cpp:101-218;
    rebvio_tpu/ops/matching.py:138-307): every new keyline walks its
    epipolar line in the old frame's keyline-id image outward from the
    predicted disparity, alternating sides, and takes the first old keyline
    that passes the gradient-angle, gradient-norm and depth gates.  Returns
    (map with the winners' depth, ids and match fields, klm [] int32).

    Two fixed-size phases, as in JAX: phase 1 walks the WALK_J_NEAR offsets
    nearest the prediction for every keyline; the keylines whose window
    reaches past them and that found nothing are compacted in index order
    into WALK_CAP slots (a prefix sum and a binary search; past WALK_CAP
    they are dropped, as ``jnp.nonzero(size=CAP)`` drops them) and walk the
    whole window in phase 2.  Every phase-1 offset precedes every
    phase-2-only one in the visit order, so the first hit is kept."""
    kmax = new.kmax
    max_radius = core_cfg.search_range
    pum = float(cfg.pixel_uncertainty_match)
    JMAX = int(2 * (max_radius + pum) + 4)
    walk_args = (pum, math.cos(cfg.match_threshold_angle * math.pi / 180.0),
                 float(cfg.match_threshold_norm))
    e = _epipolar(new, vel, Rvel, Rback, cfg, core_cfg, cam, walk=True)
    q = {**e._asdict(), "valid": new.valid, "grad": new.grad, "grad_norm": new.grad_norm}

    m0_full = torch.ceil(e.dq_min - e.dq_rho)
    found1, match1 = _walk(old, q, torch.full_like(m0_full, -8.0), WALK_J_NEAR, *walk_args)
    lo_m = torch.maximum(m0_full, -(e.t_steps - 1.0))
    hi_m = torch.minimum(torch.floor(e.dq_max - e.dq_rho), e.t_steps)
    need2 = new.valid & ~found1 & ((lo_m < -8.0) | (hi_m > 8.0))
    sel, sv, _total = compact_raster(need2, WALK_CAP)
    q2 = {k: v[sel] for k, v in q.items()}
    q2["valid"] = sv
    found2s, match2s = _walk(old, q2, m0_full[sel], JMAX, *walk_args)
    # back to the keylines; an empty slot writes a dump cell of its own
    to = torch.where(sv, sel, kmax + torch.arange(WALK_CAP, device=sel.device))
    found2 = torch.zeros((kmax + WALK_CAP,), dtype=torch.bool, device=sel.device)
    found2 = found2.scatter(0, to, found2s)[:kmax]
    match2 = torch.full((kmax + WALK_CAP,), -1, dtype=i32, device=sel.device)
    match2 = match2.scatter(0, to, match2s.to(i32))[:kmax]

    found = found1 | found2
    match = torch.where(found1, match1.to(i32), match2)
    ms = torch.clamp(match, 0, kmax - 1).to(torch.int64)
    fv = found[:, None]
    new = new.replace(
        rho=torch.where(found, old.rho[ms], new.rho),
        sigma_rho=torch.where(found, old.sigma_rho[ms], new.sigma_rho),
        match_id=torch.where(found, match, new.match_id),
        matches=torch.where(found, old.matches[ms] + 1, new.matches),
        match_pos_img=torch.where(fv, old.pos_img[ms], new.match_pos_img),
        match_grad=torch.where(fv, old.grad[ms], new.match_grad),
        match_grad_norm=torch.where(found, old.grad_norm[ms], new.match_grad_norm),
        match_id_keyframe=torch.where(found, old.match_id_keyframe[ms], new.match_id_keyframe),
    )
    return new, found.sum().to(i32)


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
    return T.finish(match_and_update_depth_stages(new, old, vel, Rvel, Rback, fail_nan, cfg,
                                                  core_cfg, cam, n_probes, field_scale,
                                                  grad_rot2))


def match_and_update_depth_stages(new: T.EdgeMap, old: T.EdgeMap, vel, Rvel, Rback, fail_nan,
                                  cfg: EdgeMapConfig, core_cfg: CoreConfig, cam: CameraConfig,
                                  n_probes: int = 0, field_scale: int = 1,
                                  grad_rot2: torch.Tensor = None):
    """``match_and_update_depth`` as a generator for the step's stages
    (pipeline.STAGES): yields "directed_match" once the geometry and K4 are
    issued, then issues K5 and returns what ``match_and_update_depth``
    returns."""
    o, R_tot = _tube_match(new, old, vel, Rvel, Rback, cfg, core_cfg, cam, n_probes,
                           field_scale, grad_rot2)
    yield "directed_match"
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
