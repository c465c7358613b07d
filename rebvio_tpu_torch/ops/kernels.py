"""Wrappers of the seven CUDA kernels of the port (five of the VIO step, two
of the loop-closure and field tools), their plain PyTorch versions, and
their launch counters.

| kernel      | CUDA source           | replaces (rebvio_tpu/ops/pallas_kernels.py) |
|-------------|-----------------------|---------------------------------------------|
| att_flood   | csrc/flood.cu         | _att_flood (K1)                             |
| try_vel     | csrc/try_vel.cu       | try_vel_math_pallas (K2; also try_vel_pallas)|
| tube_match  | csrc/tube_match.cu    | tube_match_pallas (K4)                      |
| reg_ekf     | csrc/reg_ekf.cu       | reg_ekf_pallas (K5)                         |
| estimate_bias | csrc/sab.cu         | estimate_bias_pallas (K3)                   |
| att_field   | csrc/seed_scatter.cu, csrc/flood.cu | att_field_pallas (K1b)        |
| nn_field    | csrc/seed_scatter.cu, csrc/nn_flood.cu | nn_field_pallas (K7)       |

Each wrapper checks device, dtype, shape and contiguity, allocates its
outputs with ``torch.empty`` and launches on the current stream.  A tensor
on the CPU goes to the plain version beside it (same inputs, same
outputs); a CUDA tensor launches the kernel or raises.  ``LAUNCHES[name]``
counts the wrapper's kernel launches (a multi-kernel call counts once).
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch

from rebvio_tpu_torch.ops import _build

LAUNCHES = {"att_flood": 0, "try_vel": 0, "tube_match": 0, "reg_ekf": 0, "estimate_bias": 0,
            "att_field": 0, "nn_field": 0}

f32, i32 = torch.float32, torch.int32


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _on_cuda(*ts) -> bool:
    devs = {t.device.type for t in ts}
    if devs == {"cpu"}:
        return False
    if devs != {"cuda"} or len({t.device for t in ts}) != 1:
        raise ValueError(f"kernel inputs on mixed devices: {[str(t.device) for t in ts]}")
    return True


def _check(t: torch.Tensor, dtype, shape, name):
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) or not t.is_contiguous():
        raise ValueError(f"{name}: expected contiguous {dtype} {tuple(shape)}, got "
                         f"{t.dtype} {tuple(t.shape)} contiguous={t.is_contiguous()}")


def _ptr(t: torch.Tensor):
    return ctypes.c_void_p(t.data_ptr())


def _stream(t: torch.Tensor):
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def _full(like: torch.Tensor, value: float) -> torch.Tensor:
    """``value`` as a tensor: ``x / _full(x, c)`` is a true division on every
    device (PyTorch's CUDA division by a Python scalar multiplies by the
    rounded reciprocal, which the kernels do not)."""
    return torch.full_like(like, value)


def _raise_on(err: int, name: str):
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {err}")


# --------------------------------------------------------------------------
# K1: jump flood


def flood_layout(rows: int, search_range: int):
    from rebvio_tpu_torch.ops.distance_field import flood_pad

    pad = flood_pad(search_range)
    return pad, rows + pad


def att_flood(stack: torch.Tensor, search_range: int, rows: int, cols: int,
              scale: int) -> torch.Tensor:
    """Jump flood over the seeded region stack ``[5*(rows+PAD), cols]``;
    returns the ``[8, rows*cols]`` attribute planes (see csrc/flood.cu)."""
    if not _on_cuda(stack):
        return att_flood_plain(stack, search_range, rows, cols, scale)
    pad, Rp = flood_layout(rows, search_range)
    _check(stack, f32, (5 * Rp, cols), "att_flood stack")
    lib = _build.load()
    a = torch.empty_like(stack)
    b = torch.empty_like(stack)
    out = torch.empty((8, rows * cols), dtype=f32, device=stack.device)
    err = lib.rk_att_flood(_ptr(stack), _ptr(a), _ptr(b), _ptr(out), rows, cols, pad,
                           search_range, float(scale), _stream(stack))
    _raise_on(err, "att_flood")
    LAUNCHES["att_flood"] += 1
    return out


def att_flood_plain(stack, search_range: int, rows: int, cols: int, scale: int):
    """_att_flood as rolls of the whole stack and best-of-9 selects."""
    from rebvio_tpu_torch.ops.distance_field import flood_steps

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
    out = torch.stack([torch.zeros_like(bd2r), bd2r, idf, gx, gy,
                       torch.sqrt(gx * gx + gy * gy),
                       st[Rp:Rp + rows] * float(scale), st[0:rows] * float(scale)])
    return out.reshape(8, rows * cols)


# --------------------------------------------------------------------------
# K1b: scatter-seeded attribute field; K7: id-only nearest field

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


def _check_table(pos, grad, use, name):
    K = pos.shape[0]
    _check(pos, f32, (K, 2), name + " pos")
    if grad is not None:
        _check(grad, f32, (K, 2), name + " grad")
    _check(use, torch.bool, (K,), name + " use")
    if K >= 1 << 24:
        raise ValueError(f"{name}: keyline ids ride as float32, exact only below 2^24")
    return K


def _seed_winner(lib, pos, use, rows: int, cols: int, inv_s: float) -> torch.Tensor:
    winner = torch.empty((rows * cols,), dtype=i32, device=pos.device)
    err = lib.rk_seed_winner(_ptr(pos), _ptr(use), pos.shape[0], inv_s, rows, cols,
                             _ptr(winner), _stream(pos))
    _raise_on(err, "seed_winner")
    return winner


def att_field(pos, grad, use, search_range: int, rows: int, cols: int,
              scale: int) -> torch.Tensor:
    """Attribute field from the keyline table (csrc/seed_scatter.cu, then
    csrc/flood.cu): ``pos``, ``grad`` [K, 2] and the gate ``use`` [K] bool
    seed the region stack (largest index wins a shared cell, whole row from
    the winner), and K1's flood runs on it.  ``search_range``, ``rows``,
    ``cols`` in image units; returns the ``[8, N]`` planes of the
    ``ceil(rows/scale) x ceil(cols/scale)`` field."""
    from rebvio_tpu_torch.ops.distance_field import field_geometry

    if not _on_cuda(pos, grad, use):
        return att_field_plain(pos, grad, use, search_range, rows, cols, scale)
    _check_table(pos, grad, use, "att_field")
    frows, fcols, sr = field_geometry(search_range, rows, cols, scale)
    pad, Rp = flood_layout(frows, sr)
    lib = _build.load()
    inv_s = 1.0 / scale
    winner = _seed_winner(lib, pos, use, frows, fcols, inv_s)
    stack = torch.empty((5 * Rp, fcols), dtype=f32, device=pos.device)
    err = lib.rk_seed_stack(_ptr(pos), _ptr(grad), _ptr(winner), inv_s, frows, fcols, pad,
                            _ptr(stack), _stream(pos))
    _raise_on(err, "att_field")
    LAUNCHES["att_field"] += 1
    return att_flood(stack, sr, frows, fcols, scale)


def seed_stack_plain(pos, grad, use, search_range: int, rows: int, cols: int, scale: int):
    """The flood's ``[5*(frows+PAD), fcols]`` region stack seeded from the
    keyline table: each cell takes the five values (py, px, id, gx, gy) of
    its winner, every other cell the sentinels (BIG, BIG, -1, 0, 0)."""
    from rebvio_tpu_torch.ops.distance_field import field_geometry

    frows, fcols, sr = field_geometry(search_range, rows, cols, scale)
    pad, Rp = flood_layout(frows, sr)
    winner, py, px = seed_winner_plain(pos, use, frows, fcols, 1.0 / scale)
    has = winner >= 0
    w = torch.clamp(winner, min=0).to(torch.int64)
    planes = torch.stack([
        torch.where(has, py[w], BIG), torch.where(has, px[w], BIG),
        torch.where(has, winner.to(f32), -1.0),
        torch.where(has, grad[w, 0], 0.0), torch.where(has, grad[w, 1], 0.0)])
    fill = torch.tensor([BIG, BIG, -1.0, 0.0, 0.0], dtype=f32, device=pos.device)
    stack = fill[:, None, None].expand(5, Rp, fcols).contiguous()
    stack[:, :frows, :] = planes.reshape(5, frows, fcols)
    return stack.reshape(5 * Rp, fcols)


def att_field_plain(pos, grad, use, search_range: int, rows: int, cols: int, scale: int):
    """att_field_pallas: the seeding as a scatter-max and a gather of the
    winners, then ``att_flood_plain``."""
    from rebvio_tpu_torch.ops.distance_field import field_geometry

    frows, fcols, sr = field_geometry(search_range, rows, cols, scale)
    stack = seed_stack_plain(pos, grad, use, search_range, rows, cols, scale)
    return att_flood_plain(stack, sr, frows, fcols, scale)


def nn_field(pos, use, search_range: int, rows: int, cols: int) -> torch.Tensor:
    """Nearest-keyline id field (csrc/seed_scatter.cu, then csrc/nn_flood.cu):
    ``[rows*cols]`` int32 ids, -1 beyond ``search_range``.  ``pos`` [K, 2],
    ``search_range``, ``rows`` and ``cols`` are all in field units (the
    caller scales the positions)."""
    if not _on_cuda(pos, use):
        return nn_field_plain(pos, use, search_range, rows, cols)
    _check_table(pos, None, use, "nn_field")
    n = rows * cols
    dev = pos.device
    lib = _build.load()
    winner = _seed_winner(lib, pos, use, rows, cols, 1.0)
    sid = torch.empty((2, n), dtype=i32, device=dev)
    fst = torch.empty((2, 3 * n), dtype=f32, device=dev)
    out = torch.empty((n,), dtype=i32, device=dev)
    err = lib.rk_nn_flood(_ptr(pos), _ptr(winner), _ptr(sid[0]), _ptr(fst[0]), _ptr(sid[1]),
                          _ptr(fst[1]), _ptr(out), rows, cols, int(search_range),
                          _stream(pos))
    _raise_on(err, "nn_field")
    LAUNCHES["nn_field"] += 1
    return out


def nn_field_plain(pos, use, search_range: int, rows: int, cols: int):
    """nn_field_pallas's body: per-plane rolls (rows wrap modulo ``rows``,
    columns modulo ``cols``) and selects, the state updated after every
    direction."""
    from rebvio_tpu_torch.ops.distance_field import flood_steps

    dev = pos.device
    winner, py, px = seed_winner_plain(pos, use, rows, cols, 1.0)
    has = winner >= 0
    w = torch.clamp(winner, min=0).to(torch.int64)
    sid = winner.reshape(rows, cols)
    sy = torch.where(has, py[w], BIG).reshape(rows, cols)
    sx = torch.where(has, px[w], BIG).reshape(rows, cols)
    yy = torch.arange(rows, dtype=f32, device=dev)[:, None]
    xx = torch.arange(cols, dtype=f32, device=dev)[None, :]

    def d2_of(cid, csy, csx):
        a = yy - csy
        b = xx - csx
        return torch.where(cid >= 0, a * a + b * b, BIG)

    best = d2_of(sid, sy, sx)
    for s in flood_steps(search_range):
        for dy in (-s, 0, s):
            for dx in (-s, 0, s):
                if dy == 0 and dx == 0:
                    continue
                cid, csy, csx = (torch.roll(p, (dy, dx), (0, 1)) for p in (sid, sy, sx))
                cd2 = d2_of(cid, csy, csx)
                better = cd2 < best
                sid = torch.where(better, cid, sid)
                sy = torch.where(better, csy, sy)
                sx = torch.where(better, csx, sx)
                best = torch.where(better, cd2, best)
    r2 = float(search_range * search_range)
    return torch.where(best <= r2, sid, -1).reshape(-1)


# --------------------------------------------------------------------------
# K2: fused tryVel pass


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


def try_vel(pos_img, rho, sigma_rho, grad, use_f, residuals, vel, att, g: TryVelGeom):
    """One tryVel pass (csrc/try_vel.cu).  Returns (score [], JtJ [3,3],
    JtF [3], residuals [K], match_id_forward [K] int32)."""
    ins = (pos_img, rho, sigma_rho, grad, use_f, residuals, vel, att)
    if not _on_cuda(*ins):
        return try_vel_plain(*ins, g)
    K = rho.shape[0]
    N = att.shape[1]
    for t, shape, name in ((pos_img, (K, 2), "pos_img"), (rho, (K,), "rho"),
                           (sigma_rho, (K,), "sigma_rho"), (grad, (K, 2), "grad"),
                           (use_f, (K,), "use_f"), (residuals, (K,), "residuals"),
                           (vel, (3,), "vel"), (att, (8, N), "att")):
        _check(t, f32, shape, "try_vel " + name)
    lib = _build.load()
    dev = rho.device
    partials = torch.empty((lib.rk_try_vel_blocks(K), 11), dtype=f32, device=dev)
    G = torch.empty((4, 4), dtype=f32, device=dev)
    score = torch.empty((), dtype=f32, device=dev)
    res = torch.empty((K,), dtype=f32, device=dev)
    mif = torch.empty((K,), dtype=i32, device=dev)
    err = lib.rk_try_vel(*(_ptr(t) for t in ins), K, N, g.H, g.W, g.field_scale,
                         g.fm, g.cx, g.cy, g.R, g.rw, g.mthr, _ptr(partials), _ptr(G),
                         _ptr(score), _ptr(res), _ptr(mif), _stream(rho))
    _raise_on(err, "try_vel")
    LAUNCHES["try_vel"] += 1
    return score, G[:3, :3], G[:3, 3], res, mif


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


# --------------------------------------------------------------------------
# K4: tube matcher


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


def tube_match(kl, att, dyn, M2, g: TubeGeom) -> torch.Tensor:
    """Probe, gather, gate and pick the winner for every new keyline
    (csrc/tube_match.cu).

    kl: [13, K] per-keyline planes (TUBE_PLANES); att: the old map's [8, N]
    field; dyn: [4, K] old-map (rho, sigma_rho, matches, keyframe id) with
    the counters as exact f32; M2: [2, 2] gradient replay matrix.
    Returns [12, K] (TUBE_OUT)."""
    if not _on_cuda(kl, att, dyn, M2):
        return tube_match_plain(kl, att, dyn, M2, g)
    K = kl.shape[1]
    N = att.shape[1]
    _check(kl, f32, (len(TUBE_PLANES), K), "tube_match kl")
    _check(att, f32, (8, N), "tube_match att")
    _check(dyn, f32, (4, K), "tube_match dyn")
    _check(M2, f32, (2, 2), "tube_match M2")
    if g.P < 2:
        raise ValueError("tube_match needs at least 2 probes")
    lib = _build.load()
    out = torch.empty((len(TUBE_OUT), K), dtype=f32, device=kl.device)
    err = lib.rk_tube_match(_ptr(kl), _ptr(att), _ptr(dyn), _ptr(M2), K, N, g.P, g.H, g.W,
                            g.field_scale, g.pum, g.cang_min, g.norm_thr, _ptr(out),
                            _stream(kl))
    _raise_on(err, "tube_match")
    LAUNCHES["tube_match"] += 1
    return out


def tube_match_plain(kl, att, dyn, M2, g: TubeGeom) -> torch.Tensor:
    """tube_match_pallas plus the probe projection and both gathers, as
    [P, K] tensors."""
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
    best = torch.argmin(prio, dim=0)        # first minimum: the first probe wins ties
    payload = torch.stack([oid, rho_o, sr_o, gx_r, gy_r, gn_old, sx, sy, d[2], d[3], prio])
    win = torch.gather(payload, 1, best[None, None, :].expand(11, 1, K))[:, 0]
    best_prio = win[10]
    found = best_prio < 1e9
    payload_out = torch.where(found, win[:10], 0.0)
    out = torch.cat([found.to(f32)[None], torch.where(found, payload_out[0], -1.0)[None],
                     payload_out[1:], best_prio[None]])
    return out


# --------------------------------------------------------------------------
# K5: regularization + depth EKF


class RegEkfParams(NamedTuple):
    threshold: float   # regularization threshold (EdgeMapConfig)
    q_abs2: float      # reshape_q_abs ** 2
    pu2: float         # pixel_uncertainty ** 2
    fm: float


def reg_ekf(rho, sigma_rho, grad, grad_norm, id_next, id_prev, valid, match_id,
            pos_img, match_pos_img, match_grad, match_grad_norm, vel, p: RegEkfParams):
    """regularize_1iter then the inverse-depth EKF (csrc/reg_ekf.cu).
    Returns (rho, sigma_rho)."""
    ins = (rho, sigma_rho, grad, grad_norm, id_next, id_prev, valid, match_id,
           pos_img, match_pos_img, match_grad, match_grad_norm, vel)
    if not _on_cuda(*ins):
        return reg_ekf_plain(*ins, p)
    K = rho.shape[0]
    for t, dtype, shape, name in (
            (rho, f32, (K,), "rho"), (sigma_rho, f32, (K,), "sigma_rho"),
            (grad, f32, (K, 2), "grad"), (grad_norm, f32, (K,), "grad_norm"),
            (id_next, i32, (K,), "id_next"), (id_prev, i32, (K,), "id_prev"),
            (valid, torch.bool, (K,), "valid"), (match_id, i32, (K,), "match_id"),
            (pos_img, f32, (K, 2), "pos_img"), (match_pos_img, f32, (K, 2), "match_pos_img"),
            (match_grad, f32, (K, 2), "match_grad"),
            (match_grad_norm, f32, (K,), "match_grad_norm"), (vel, f32, (3,), "vel")):
        _check(t, dtype, shape, "reg_ekf " + name)
    lib = _build.load()
    rho_out = torch.empty_like(rho)
    sr_out = torch.empty_like(sigma_rho)
    err = lib.rk_reg_ekf(*(_ptr(t) for t in ins), K, p.threshold, p.q_abs2, p.pu2, p.fm,
                         _ptr(rho_out), _ptr(sr_out), _stream(rho))
    _raise_on(err, "reg_ekf")
    LAUNCHES["reg_ekf"] += 1
    return rho_out, sr_out


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
    from rebvio_tpu_torch.types import RHO_INIT, RHO_MAX, RHO_MIN

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


# --------------------------------------------------------------------------
# K3: SAB Gauss-Newton solve, posterior and re-fusion

_PI = math.pi
_TWO_PI = 2.0 * math.pi
_BIAS_SAT = 5e-1 / 25  # sab_estimator.cpp:34


def estimate_bias(a_s, a_v, x_p, W_rest, Rs, Rv, Wvw, Xvw, g_gravit, iters: int):
    """The SAB solve from the KF-predicted prior ``x_p`` (csrc/sab.cu).
    Shapes: a_s, a_v [3]; x_p [7]; W_rest [8,11]; Rs, Rv [3,3]; Wvw [6,6];
    Xvw [6]; g_gravit [].  Returns (K [], X [7], P [7,7], Xvw [6])."""
    ins = (a_s, a_v, x_p, W_rest, Rs, Rv, Wvw, Xvw, g_gravit)
    if not _on_cuda(*ins):
        return estimate_bias_plain(*ins, iters)
    for t, shape, name in ((a_s, (3,), "a_s"), (a_v, (3,), "a_v"), (x_p, (7,), "x_p"),
                           (W_rest, (8, 11), "W_rest"), (Rs, (3, 3), "Rs"),
                           (Rv, (3, 3), "Rv"), (Wvw, (6, 6), "Wvw"), (Xvw, (6,), "Xvw"),
                           (g_gravit, (), "g_gravit")):
        _check(t, f32, shape, "estimate_bias " + name)
    lib = _build.load()
    dev = a_s.device
    K = torch.empty((), dtype=f32, device=dev)
    X = torch.empty((7,), dtype=f32, device=dev)
    P = torch.empty((7, 7), dtype=f32, device=dev)
    Xc = torch.empty((6,), dtype=f32, device=dev)
    err = lib.rk_estimate_bias(*(_ptr(t) for t in ins), int(iters), _ptr(K), _ptr(X),
                               _ptr(P), _ptr(Xc), _stream(a_s))
    _raise_on(err, "estimate_bias")
    LAUNCHES["estimate_bias"] += 1
    return K, X, P, Xc


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
    from rebvio_tpu_torch.geometry import so3

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
    M6 = Wvw.clone()
    M6[3:, 3:] = WVBias + Wvw[3:, 3:]
    wc = Xvw[3:6] - Xc[4:7]
    rhs = Wvw @ Xvw + torch.cat([torch.zeros(3, **z), WVBias @ wc])
    return k, Xc, P, gj_inverse_mosaic(M6) @ rhs
