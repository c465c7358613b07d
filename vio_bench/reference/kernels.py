"""Plain PyTorch versions of the port's CUDA kernels (a frozen copy of
``rebvio_tpu_torch/ops/kernels.py``'s ``*_plain`` functions): the jump
flood (K1), the scatter-seeded field (K1b), the tracker's LM solve (K2),
the tube matcher (K4), the depth stage (K5, fused and alone) and the SAB
solve (K3).  The public names are the plain versions on every device: the
reference launches no kernel of the program."""

from __future__ import annotations

import math
from typing import NamedTuple

import torch


f32, i32 = torch.float32, torch.int32


def _full(like: torch.Tensor, value: float) -> torch.Tensor:
    """``value`` as a tensor: ``x / _full(x, c)`` is a true division on every
    device (PyTorch's CUDA division by a Python scalar multiplies by the
    rounded reciprocal, which the kernels do not)."""
    return torch.full_like(like, value)


def flood_layout(rows: int, search_range: int):
    from vio_bench.reference.distance_field import flood_pad

    pad = flood_pad(search_range)
    return pad, rows + pad


def att_flood_plain(stack, search_range: int, rows: int, cols: int, scale: int):
    """_att_flood as rolls of the whole stack and best-of-9 selects."""
    from vio_bench.reference.distance_field import flood_steps

    pad, Rp = flood_layout(rows, search_range)
    dev = stack.device
    yy = torch.arange(Rp, dtype=f32, device=dev)[:, None]
    xx = torch.arange(cols, dtype=f32, device=dev)[None, :]
    row_ok = (torch.arange(Rp, device=dev) < rows)[:, None]

    def d2_of(stk):
        a = yy - stk[0:Rp]
        b = xx - stk[Rp:2 * Rp]
        return a * a + b * b

    st = stack
    bd2 = d2_of(st)
    for s in flood_steps(search_range):
        best, best_d2 = st, bd2
        for dy in (-s, 0, s):
            ry = torch.roll(st, dy, 0) if dy else st
            for dx in (-s, 0, s):
                if dy == 0 and dx == 0:
                    continue
                cand = torch.roll(ry, dx, 1) if dx else ry
                cd2 = d2_of(cand)
                better = (cd2 < best_d2) & row_ok
                best = torch.where(better.repeat(5, 1), cand, best)
                best_d2 = torch.where(better, cd2, best_d2)
        st, bd2 = best, best_d2
    gx = st[3 * Rp:3 * Rp + rows]
    gy = st[4 * Rp:4 * Rp + rows]
    bd2r = bd2[:rows]
    idf = torch.where(bd2r <= float(search_range * search_range),
                      st[2 * Rp:2 * Rp + rows], -1.0)
    # |g| correctly rounded, as the kernel's __fsqrt_rn: the float32 sum's
    # sqrt in float64, then rounded (PyTorch's float32 CPU sqrt is not
    # correctly rounded, nor repeatable between processes)
    out = torch.stack([torch.zeros_like(bd2r), bd2r, idf, gx, gy,
                       torch.sqrt((gx * gx + gy * gy).to(torch.float64)).to(f32),
                       st[Rp:Rp + rows] * float(scale), st[0:rows] * float(scale)])
    return out.reshape(8, rows * cols)


BIG = 1e9


def _seed_cells(pos, use, rows: int, cols: int, inv_s: float):
    """Seed coordinates (py, px) = pos * inv_s, and per keyline its field
    cell, ``rows*cols`` for a keyline that is not kept or falls outside."""
    inv = torch.full((), inv_s, dtype=f32, device=pos.device)
    px = pos[:, 0] * inv
    py = pos[:, 1] * inv
    fc = torch.floor(px + 0.5)
    fr = torch.floor(py + 0.5)
    inb = use & (fr >= 0) & (fr < rows) & (fc >= 0) & (fc < cols)
    cell = torch.where(inb, fr.to(torch.int64) * cols + fc.to(torch.int64), rows * cols)
    return py, px, cell, inb


def seed_winner_plain(pos, use, rows: int, cols: int, inv_s: float):
    """Per field cell the largest kept keyline index that rounds into it
    (the sequential scatter's last writer), -1 where none; one scatter-max.
    Returns (winner [rows*cols] int32, py [K], px [K])."""
    K = pos.shape[0]
    n = rows * cols
    py, px, cell, inb = _seed_cells(pos, use, rows, cols, inv_s)
    k = torch.arange(K, dtype=i32, device=pos.device)
    win = torch.full((n + 1,), -1, dtype=i32, device=pos.device)
    win = win.scatter_reduce(0, cell, torch.where(inb, k, -1), reduce="amax")
    return win[:n], py, px


def _at_winner(v: torch.Tensor, winner: torch.Tensor, fill: float) -> torch.Tensor:
    """``v[winner]`` on the cells a keyline won, ``fill`` elsewhere (an
    empty table too)."""
    w = torch.where(winner >= 0, winner.to(torch.int64), v.shape[0])
    return torch.cat([v, v.new_full((1,), fill)])[w]


def seed_stack_plain(pos, grad, use, search_range: int, rows: int, cols: int, scale: int):
    """The flood's ``[5*(frows+PAD), fcols]`` region stack seeded from the
    keyline table: each cell takes the five values (py, px, id, gx, gy) of
    its winner, every other cell the sentinels (BIG, BIG, -1, 0, 0)."""
    from vio_bench.reference.distance_field import field_geometry

    frows, fcols, sr = field_geometry(search_range, rows, cols, scale)
    pad, Rp = flood_layout(frows, sr)
    winner, py, px = seed_winner_plain(pos, use, frows, fcols, 1.0 / scale)
    planes = torch.stack([
        _at_winner(py, winner, BIG), _at_winner(px, winner, BIG),
        torch.where(winner >= 0, winner.to(f32), -1.0),
        _at_winner(grad[:, 0], winner, 0.0), _at_winner(grad[:, 1], winner, 0.0)])
    fill = torch.tensor([BIG, BIG, -1.0, 0.0, 0.0], dtype=f32, device=pos.device)
    stack = torch.cat([planes.reshape(5, frows, fcols),
                       fill[:, None, None].expand(5, Rp - frows, fcols)], dim=1)
    return stack.reshape(5 * Rp, fcols)


def att_field_plain(pos, grad, use, search_range: int, rows: int, cols: int, scale: int):
    """att_field_pallas: the seeding as a scatter-max and a gather of the
    winners, then ``att_flood_plain``."""
    from vio_bench.reference.distance_field import field_geometry

    frows, fcols, sr = field_geometry(search_range, rows, cols, scale)
    stack = seed_stack_plain(pos, grad, use, search_range, rows, cols, scale)
    return att_flood_plain(stack, sr, frows, fcols, scale)


class TryVelGeom(NamedTuple):
    """Static geometry and thresholds of a tryVel pass."""

    H: int
    W: int
    field_scale: int
    fm: float
    cx: float
    cy: float
    R: float          # search range (saturation residual)
    rw: float         # Huber reweight distance
    mthr: float       # gradient-similarity threshold


def try_vel_plain(pos_img, rho, sigma_rho, grad, use_f, residuals, vel, att, g: TryVelGeom):
    """tracker.try_vel's attribute path (core.cpp:78-148) in torch."""
    use = use_f > 0.5
    weight = torch.where(residuals > g.rw, _full(residuals, g.rw) / residuals, 1.0)
    inv_sr = 1.0 / torch.where(sigma_rho > 0, sigma_rho, 1.0)
    z_p = 1.0 / torch.where(rho != 0, rho, 1e-20) + vel[2]
    front = z_p > 0.0
    rho_p = 1.0 / torch.where(front, z_p, 1.0)
    p_x = rho_p * (vel[0] * g.fm - vel[2] * pos_img[:, 0]) + pos_img[:, 0]
    p_y = rho_p * (vel[1] * g.fm - vel[2] * pos_img[:, 1]) + pos_img[:, 1]
    p_xc = p_x + g.cx
    p_yc = p_y + g.cy
    x = torch.floor(p_xc + 0.5).to(torch.int64)
    y = torch.floor(p_yc + 0.5).to(torch.int64)
    inb = (x >= 1) & (y >= 1) & (x < g.W - 1) & (y < g.H - 1)
    lookup_ok = use & front & inb
    xs = torch.clamp(x, 0, g.W - 1)
    ys = torch.clamp(y, 0, g.H - 1)
    s = g.field_scale
    Wf = (g.W + s - 1) // s
    fidx = (ys // s) * Wf + xs // s if s > 1 else ys * g.W + xs
    row8 = att[:, fidx]
    fid = torch.where(lookup_ok, row8[2].to(i32), -1)
    gNx, gNy, gnN, posNx, posNy = row8[3], row8[4], row8[5], row8[6], row8[7]
    dot = gNx * grad[:, 0] + gNy * grad[:, 1]
    n2 = gnN * gnN
    matched = (fid >= 0) & (torch.abs(dot - n2) <= g.mthr * n2)
    gsafe = torch.where(gnN > 0, gnN, 1.0)
    ux = gNx / gsafe
    uy = gNy / gsafe
    fi = (p_xc - posNx) * ux + (p_yc - posNy) * uy
    f = torch.where(matched, fi * inv_sr, g.R * inv_sr) * weight
    score = torch.sum(torch.where(use, f * f, 0.0))
    m = matched & use
    df_dx = torch.where(m, ux * inv_sr, 0.0)
    df_dy = torch.where(m, uy * inv_sr, 0.0)
    jx = rho_p * g.fm * df_dx * weight
    jy = rho_p * g.fm * df_dy * weight
    jz = -rho_p * (p_x * df_dx + p_y * df_dy) * weight
    Jm = torch.stack([jx, jy, jz, torch.where(m, f, 0.0)], dim=-1)
    G = Jm.T @ Jm
    res = torch.where(m, torch.abs(fi), residuals)
    mif = torch.where(m, fid, -1)
    return score, G[:3, :3], G[:3, 3], res, mif


def minimize_vel_plain(pos_img, rho, sigma_rho, grad, use_f, vel0, att, g: TryVelGeom,
                       iterations: int, debug: bool = False):
    """tracker.minimize_vel's loop over ``try_vel_plain``: each accept
    decision is a select, nothing is read back."""
    from vio_bench.reference import linalg

    def pass_(vel, residuals):
        return try_vel_plain(pos_img, rho, sigma_rho, grad, use_f, residuals, vel, att, g)

    F, JtJ, JtF, residuals, mif = pass_(vel0, torch.zeros_like(rho))
    vel = vel0
    u = 1e-3 * torch.max(JtJ)
    v = torch.tensor(2.0, dtype=f32, device=vel.device)
    eye = torch.eye(3, dtype=f32, device=vel.device)
    gains, accepts, trials = [], [], []
    for _ in range(iterations):
        h = linalg.invert3(JtJ + eye * u) @ (-JtF)
        vel_new = vel + h
        score2, JtJ2, JtF2, residuals, mif = pass_(vel_new, residuals)
        gain = (F - score2) / (0.5 * torch.dot(h, u * h - JtF))
        accept = gain > 0.0
        F = torch.where(accept, score2, F)
        vel = torch.where(accept, vel_new, vel)
        JtJ = torch.where(accept, JtJ2, JtJ)
        JtF = torch.where(accept, JtF2, JtF)
        t = 2.0 * gain - 1.0
        u = torch.where(accept, u * torch.clamp(1.0 - t * t * t, min=0.33), u * v)
        v = torch.where(accept, 2.0, v * 2.0)
        gains.append(gain)
        accepts.append(accept)
        trials.append(score2)
    ret = (vel, JtJ, JtF, F, residuals, mif)
    if debug:
        empty = torch.zeros(0, dtype=f32, device=vel.device)
        ret += (torch.stack(gains) if gains else empty,
                torch.stack(accepts) if accepts else empty > 0.5,
                torch.stack(trials) if trials else empty)
    return ret


class TubeGeom(NamedTuple):
    """Static geometry and gate thresholds of the tube matcher."""

    P: int            # probes per keyline
    H: int
    W: int
    field_scale: int
    pum: float        # pixel uncertainty of a match (tube half-width)
    cang_min: float   # cos of the angle gate
    norm_thr: float   # gradient-norm gate


TUBE_PLANES = ("tx", "ty", "pi0x", "pi0y", "dq_min", "dq_max", "dq_rho", "nt_eff",
               "sigma2_t", "ngx", "ngy", "ngn", "valid")


TUBE_OUT = ("found", "match_id", "rho", "sigma_rho", "grad_x", "grad_y", "grad_norm",
            "seed_x", "seed_y", "matches", "kf", "prio")


def tube_probes(kl, att, dyn, M2, g: TubeGeom) -> torch.Tensor:
    """Every probe of every keyline before the winner is chosen: ``[11, P,
    K]`` rows (old keyline id, its rho, sigma_rho, rotated gradient x, y,
    gradient norm, position x, y, matches, keyframe id, priority), the
    priority 1e9 where a gate fails."""
    K = kl.shape[1]
    dev = kl.device
    (tx, ty, pi0x, pi0y, dq_min, dq_max, dq_rho, nt_eff, sigma2_t,
     ngx, ngy, ngn, valid_f) = kl
    valid = valid_f > 0.5
    lam = torch.arange(g.P, dtype=f32, device=dev)[:, None]
    lam = lam / _full(lam, g.P - 1)
    t_probe = dq_min + (dq_max - dq_min) * lam                # [P,K]
    px = tx * t_probe + pi0x
    py = ty * t_probe + pi0y
    col = torch.clamp(torch.floor(px + 0.5).to(torch.int64), 0, g.W - 1)
    row = torch.clamp(torch.floor(py + 0.5).to(torch.int64), 0, g.H - 1)
    inb = (px >= -0.5) & (px < g.W - 0.5) & (py >= -0.5) & (py < g.H - 0.5)
    s = g.field_scale
    Wf = (g.W + s - 1) // s
    pidx = (row // s) * Wf + col // s if s > 1 else row * g.W + col
    a = att[:, pidx]                                          # [8,P,K]
    oid, g0x, g0y, gn_old, sx, sy = a[2], a[3], a[4], a[5], a[6], a[7]
    gx_r = g0x * M2[0, 0] + g0y * M2[0, 1]
    gy_r = g0x * M2[1, 0] + g0y * M2[1, 1]
    os_ = torch.clamp(torch.where(inb, oid.to(torch.int64), -1), 0, K - 1)
    d = dyn[:, os_]                                           # [4,P,K]
    rho_o, sr_o = d[0], d[1]
    has = inb & (oid >= 0)

    dxs = sx - pi0x
    dys = sy - pi0y
    t_eff = dxs * tx + dys * ty
    perp = torch.abs(-dxs * ty + dys * tx)
    g_tube = perp <= g.pum
    g_win = (t_eff >= dq_min) & (t_eff <= dq_max)
    gdot = gx_r * ngx + gy_r * ngy
    den = torch.where(gn_old * ngn > 0, gn_old * ngn, 1.0)
    g_ang = gdot / den >= g.cang_min
    g_norm = torch.abs(gn_old / torch.where(ngn > 0, ngn, 1.0) - 1.0) <= g.norm_thr
    v_rho_dr = g.pum * g.pum + sr_o * sr_o * (nt_eff * nt_eff) + sigma2_t * rho_o * rho_o
    resid = t_eff - nt_eff * rho_o
    g_depth = ~(resid * resid > v_rho_dr)
    ok = valid & has & g_tube & g_win & g_ang & g_norm & g_depth
    prio = torch.abs(t_eff - dq_rho)
    prio = torch.where(ok & ~torch.isnan(prio), prio, 1e9)   # the kernel's strict < skips NaN
    return torch.stack([oid, rho_o, sr_o, gx_r, gy_r, gn_old, sx, sy, d[2], d[3], prio])


def tube_match_plain(kl, att, dyn, M2, g: TubeGeom) -> torch.Tensor:
    """tube_match_pallas plus the probe projection and both gathers, as
    [P, K] tensors (tube_probes), then each keyline's winning probe."""
    K = kl.shape[1]
    payload = tube_probes(kl, att, dyn, M2, g)
    best = torch.argmin(payload[10], dim=0)  # first minimum: the first probe wins ties
    win = torch.gather(payload, 1, best[None, None, :].expand(11, 1, K))[:, 0]
    best_prio = win[10]
    found = best_prio < 1e9
    payload_out = torch.where(found, win[:10], 0.0)
    out = torch.cat([found.to(f32)[None], torch.where(found, payload_out[0], -1.0)[None],
                     payload_out[1:], best_prio[None]])
    return out


class RegEkfParams(NamedTuple):
    threshold: float   # regularization threshold (EdgeMapConfig)
    q_abs2: float      # reshape_q_abs ** 2
    pu2: float         # pixel_uncertainty ** 2
    fm: float


class MatchRegEkfParams(NamedTuple):
    """The fused stage's constants: the depth update's, then the tail's
    principal point and the gate's match-count threshold."""

    threshold: float
    q_abs2: float
    pu2: float
    fm: float
    cx: float
    cy: float
    min_matches: int   # CoreConfig.global_min_matches_threshold


# the eight map planes the fused stage writes, in its output order
MATCH_PLANES = ("rho", "sigma_rho", "match_id", "matches", "match_pos_img", "match_grad",
                "match_grad_norm", "match_id_keyframe")


def match_tail_plain(tube_out, rho, sigma_rho, match_id, matches, match_pos_img, match_grad,
                     match_grad_norm, match_id_keyframe, R_tot, fm: float, cx: float,
                     cy: float):
    """The tube matcher's write-back (directed_match_tube's tail): found
    keylines take the winner's depth, id, match count + 1, gradient and
    keyframe id, and as match position the winner's seed through ``R_tot``
    and the perspective divide (the 3x3 product summed in a fixed order, as
    csrc/reg_ekf.cu does).  Returns (the MATCH_PLANES, klm [] int32)."""
    o = tube_out
    found = o[0] > 0.5
    fmt = _full(o[7], fm)
    vx = (o[7] - cx) / fmt
    vy = (o[8] - cy) / fmt
    p0x = (vx * R_tot[0, 0] + vy * R_tot[0, 1]) + R_tot[0, 2]
    p0y = (vx * R_tot[1, 0] + vy * R_tot[1, 1]) + R_tot[1, 2]
    p0z = (vx * R_tot[2, 0] + vy * R_tot[2, 1]) + R_tot[2, 2]
    sc = fmt / torch.where(p0z != 0, p0z, 1e-20)
    fv = found[:, None]
    planes = (torch.where(found, o[2], rho), torch.where(found, o[3], sigma_rho),
              torch.where(found, o[1].to(i32), match_id),
              torch.where(found, o[9].to(i32) + 1, matches),
              torch.where(fv, torch.stack([p0x * sc, p0y * sc], dim=-1), match_pos_img),
              torch.where(fv, torch.stack([o[4], o[5]], dim=-1), match_grad),
              torch.where(found, o[6], match_grad_norm),
              torch.where(found, o[10].to(i32), match_id_keyframe))
    return planes, found.sum().to(i32)


def match_reg_ekf_plain(tube_out, rho, sigma_rho, grad, grad_norm, id_next, id_prev, valid,
                        match_id, matches, match_id_keyframe, pos_img, match_pos_img, match_grad,
                        match_grad_norm, vel, R_tot, fail_nan, p: MatchRegEkfParams):
    """match_tail_plain, the gate and reg_ekf_plain as the JAX step composes
    them (rebvio_tpu/pipeline.py:241-250): every result is a select."""
    new = (rho, sigma_rho, match_id, matches, match_pos_img, match_grad, match_grad_norm,
           match_id_keyframe)
    matched, klm = match_tail_plain(tube_out, *new, R_tot, p.fm, p.cx, p.cy)
    post = tuple(torch.where(fail_nan, a, b) for a, b in zip(new, matched))
    klm = torch.where(fail_nan, torch.zeros_like(klm), klm)
    failed = fail_nan | (klm < p.min_matches)
    r, s = reg_ekf_plain(post[0], post[1], grad, grad_norm, id_next, id_prev, valid, post[2],
                         pos_img, post[4], post[5], post[6], vel, RegEkfParams(*p[:4]))
    return (torch.where(failed, post[0], r), torch.where(failed, post[1], s), *post[2:], klm,
            failed)


def reg_ekf_plain(rho, sigma_rho, grad, grad_norm, id_next, id_prev, valid, match_id,
                  pos_img, match_pos_img, match_grad, match_grad_norm, vel, p: RegEkfParams):
    """regularize_plain composed with ekf_plain (the pipeline's order)."""
    rho1, sr1 = regularize_plain(rho, sigma_rho, grad, grad_norm, id_next, id_prev, valid,
                                 p.threshold)
    return ekf_plain(rho1, sr1, valid, match_id, pos_img, match_pos_img, match_grad,
                     match_grad_norm, vel, p.q_abs2, p.pu2, p.fm)


def regularize_plain(rho, sigma_rho, grad, grad_norm, id_next, id_prev, valid, thr: float):
    """One Jacobi depth-regularization pass (regularize_1iter,
    edge_map.cpp:220-259): every update reads pre-pass values."""
    K = rho.shape[0]
    has_nb = valid & (id_next >= 0) & (id_prev >= 0)
    nx = torch.clamp(id_next, 0, K - 1).to(torch.int64)
    pv = torch.clamp(id_prev, 0, K - 1).to(torch.int64)
    rn, rp = rho[nx], rho[pv]
    sn, sp = sigma_rho[nx], sigma_rho[pv]
    gn_, gp_ = grad[nx], grad[pv]
    gnn, gnp_ = grad_norm[nx], grad_norm[pv]
    test1 = (rn - rp) * (rn - rp) <= (sn * sn + sp * sp)
    denom = torch.where(gnn * gnp_ > 0, gnn * gnp_, 1.0)
    alpha = (gn_[:, 0] * gp_[:, 0] + gn_[:, 1] * gp_[:, 1]) / denom
    apply = has_nb & test1 & (alpha >= thr)
    alpha2 = (alpha - thr) / _full(alpha, 1.0 - thr)
    alpha2 = alpha2 / (torch.abs(rn - rp) / torch.where(sn + sp > 0, sn + sp, 1.0) + 1.0)
    sr_safe = torch.where(sigma_rho > 0, sigma_rho, 1.0)
    wr = 1.0 / (sr_safe * sr_safe)
    wrn = alpha2 / torch.where(sn > 0, sn * sn, 1.0)
    wrp = alpha2 / torch.where(sp > 0, sp * sp, 1.0)
    wsum = wr + wrn + wrp
    rho1 = torch.where(apply, (rho * wr + rn * wrn + rp * wrp) / wsum, rho)
    sr1 = torch.where(apply, (sigma_rho * wr + sn * wrn + sp * wrp) / wsum, sigma_rho)
    return rho1, sr1


def ekf_plain(rho, sigma_rho, valid, match_id, pos_img, match_pos_img, match_grad,
              match_grad_norm, vel, q_abs2: float, pu2: float, fm: float):
    """Per-keyline scalar inverse-depth EKF (updateInverseDepthARLU,
    core.cpp:417-456) with its clamps and NaN reset."""
    from vio_bench.reference.types import RHO_INIT, RHO_MAX, RHO_MIN

    m = valid & (match_id >= 0)
    gn = torch.where(match_grad_norm > 0, match_grad_norm, 1.0)
    ux = match_grad[:, 0] / gn
    uy = match_grad[:, 1] / gn
    qx, qy = pos_img[:, 0], pos_img[:, 1]
    q0x, q0y = match_pos_img[:, 0], match_pos_img[:, 1]
    Y = ux * (qx - q0x) + uy * (qy - q0y)
    Hm = ux * (vel[0] * fm - vel[2] * q0x) + uy * (vel[1] * fm - vel[2] * q0y)
    v_rho = sigma_rho * sigma_rho
    rho_p = 1.0 / (1.0 / torch.where(rho != 0, rho, 1e-20) + vel[2])
    F1 = 1.0 / (1.0 + rho * vel[2])
    F2 = F1 * F1
    p_p = F2 * v_rho * F2 + q_abs2
    e = Y - Hm * rho_p
    S = Hm * p_p * Hm + pu2
    Kk = p_p * Hm / S
    rho_new = rho_p + Kk * e
    sigma_new = torch.sqrt((1.0 - Kk * Hm) * p_p)
    sigma_new = torch.where(rho_new < RHO_MIN, sigma_new + (RHO_MIN - rho_new), sigma_new)
    rho_new = torch.clamp(rho_new, RHO_MIN, RHO_MAX)
    bad = ~torch.isfinite(rho_new) | ~torch.isfinite(sigma_new)
    rho_new = torch.where(bad, RHO_INIT, rho_new)
    sigma_new = torch.where(bad, RHO_MAX, sigma_new)
    return torch.where(m, rho_new, rho), torch.where(m, sigma_new, sigma_rho)


_PI = math.pi


_TWO_PI = 2.0 * math.pi


_BIAS_SAT = 5e-1 / 25  # sab_estimator.cpp:34


def wrap_angle(a: torch.Tensor) -> torch.Tensor:
    """a - 2pi round(a / 2pi), the Pallas body's atan2-free wrap; torch.round
    rounds half to even, as jnp.round and the kernel's rintf do."""
    return a - _TWO_PI * torch.round(a * (1.0 / _TWO_PI))


def gj_inverse_mosaic(m: torch.Tensor) -> torch.Tensor:
    """_gj_inverse_mosaic: pivot-free Gauss-Jordan with the pivot row
    multiplied by 1/piv (linalg.gj_inverse divides)."""
    n = m.shape[-1]
    a = torch.cat([m, torch.eye(n, dtype=m.dtype, device=m.device)], dim=-1)
    for i in range(n):
        piv_row = a[i:i + 1, :] * (1.0 / a[i, i])
        a = a - a[:, i:i + 1] * piv_row
        a = torch.cat([a[:i], piv_row, a[i + 1:]])
    return a[:, n:]


def estimate_bias_plain(a_s, a_v, x_p, W_rest, Rs, Rv, Wvw, Xvw, g_gravit, iters: int):
    """estimate_bias_pallas's body, op for op, in torch (the bias block of
    JtJ is read by slicing where the Pallas body multiplies by 0/1
    selectors: the same values for finite input)."""
    from vio_bench.reference import so3

    dev = a_s.device
    z = dict(dtype=f32, device=dev)
    eye3 = torch.eye(3, **z)

    def problem(Xc):
        a, g, b = Xc[0], Xc[1:4], Xc[4:7]
        sa, ca = torch.sin(a), torch.cos(a)
        da = a - x_p[0]
        da = torch.where(da > _PI, da - _TWO_PI, torch.where(da < -_PI, da + _TWO_PI, da))
        Rb = so3.exp(b)
        Rg_vec = Rb @ g
        F0 = (a_s + g) * ca - a_v * sa
        F = torch.cat([F0, (torch.sum(g * g) - g_gravit * g_gravit).reshape(1), da.reshape(1),
                       Rg_vec - x_p[1:4], b - x_p[4:7]])
        dFda0 = -(a_s + g) * sa - a_v * ca
        dFda = torch.cat([dFda0, torch.tensor([0.0, 1.0], **z), torch.zeros(6, **z)])
        z33 = torch.zeros((3, 3), **z)
        dFdx1 = torch.cat([
            torch.cat([eye3 * ca, z33], dim=1),
            torch.cat([2.0 * g, torch.zeros(3, **z)])[None],
            torch.zeros((1, 6), **z),
            torch.cat([Rb, -so3.hat(Rg_vec)], dim=1),
            torch.cat([z33, eye3], dim=1)])                       # [11,6]
        Pz = sa * sa * Rv + ca * ca * Rs
        W0 = gj_inverse_mosaic(Pz)
        W = torch.cat([torch.cat([W0, torch.zeros((3, 8), **z)], dim=1), W_rest])
        dP0 = (2.0 * sa * ca) * (Rv - Rs)
        dWda0 = -((W0 @ dP0) @ W0)
        dWPdW0 = (dWda0 @ Pz) @ dWda0
        F0v, dFda0v = F[0:3], dFda[0:3]
        WF = W @ F
        WdFda = W @ dFda
        d3 = dWda0 @ F0v
        j00 = 0.25 * (F0v @ (dWPdW0 @ F0v)) + dFda0v @ d3 + dFda @ WdFda
        col = dFdx1.T @ (0.5 * torch.cat([d3, torch.zeros(8, **z)]) + WdFda)
        blk = dFdx1.T @ (W @ dFdx1)
        JtJ = torch.cat([torch.cat([j00.reshape(1), col])[None],
                         torch.cat([col[:, None], blk], dim=1)])
        JtF = torch.cat([(0.5 * (F0v @ d3) + dFda @ WF).reshape(1), dFdx1.T @ WF])
        return JtJ, JtF

    Xc = x_p
    for _ in range(iters):
        JtJ, JtF = problem(Xc)
        hx = gj_inverse_mosaic(JtJ) @ (-JtF)
        fin = torch.isfinite(JtJ).all() & torch.isfinite(JtF).all()
        hx = torch.where(fin & ~torch.isfinite(hx).all(), 0.0, hx)   # gj_solve semantics
        Xc = Xc + hx
        Xc = torch.cat([wrap_angle(Xc[0]).reshape(1), Xc[1:4],
                        torch.clamp(Xc[4:7], -_BIAS_SAT, _BIAS_SAT)])

    JtJ, _ = problem(Xc)
    P = gj_inverse_mosaic(JtJ)
    k = torch.sin(Xc[0]) / torch.cos(Xc[0])
    k = torch.where((k < 0) | ~torch.isfinite(k), 0.0, k)
    # re-fuse the rigid transform with the bias information (core.cpp:394-405)
    WVBias = JtJ[4:7, 4:7]
    M6 = torch.cat([Wvw[:3], torch.cat([Wvw[3:, :3], WVBias + Wvw[3:, 3:]], dim=1)])
    wc = Xvw[3:6] - Xc[4:7]
    rhs = Wvw @ Xvw + torch.cat([torch.zeros(3, **z), WVBias @ wc])
    return k, Xc, P, gj_inverse_mosaic(M6) @ rhs


att_flood = att_flood_plain
att_field = att_field_plain
try_vel = try_vel_plain
minimize_vel = minimize_vel_plain
tube_match = tube_match_plain
match_reg_ekf = match_reg_ekf_plain
reg_ekf = reg_ekf_plain
estimate_bias = estimate_bias_plain
