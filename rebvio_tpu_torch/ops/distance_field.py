"""Nearest-keyline fields (rebvio_tpu/ops/distance_field.py).  The attribute
field: dense seeding from the detector planes and the jump flood (kernel
K1, kernels.att_flood), or scatter seeding from the keyline table and the
same flood (kernel K1b, kernels.att_field).  The id-only field: the
exact-metric flood of kernel K7 (kernels.nn_field)."""

from __future__ import annotations

import torch

from rebvio_tpu_torch.ops import kernels

# Plane layout of the attribute field (build_att_field)
ATT_PACKED, ATT_D2, ATT_ID, ATT_GX, ATT_GY, ATT_GN, ATT_POSX, ATT_POSY = range(8)

BIG = 1e9


def _round_half_away(x: torch.Tensor) -> torch.Tensor:
    """std::round semantics (half away from zero), unlike torch.round's
    banker's rounding (core.hpp:66-71)."""
    return torch.sign(x) * torch.floor(torch.abs(x) + 0.5)


def field_geometry(search_range: int, rows: int, cols: int, scale: int):
    """(field rows, field cols, search range) in field units."""
    sr = search_range if scale == 1 else max(1, round(search_range / scale))
    return (rows + scale - 1) // scale, (cols + scale - 1) // scale, sr


def flood_pad(search_range: int) -> int:
    """Sentinel rows between the stacked seed regions: the largest jump
    step rounded up to 8 (pallas_kernels._flood_pad)."""
    s = 1
    while 2 * s < search_range:
        s *= 2
    return -(-s // 8) * 8


def flood_steps(search_range: int):
    """Jump-flood step schedule: powers of two from the smallest >=
    search_range/2 down to 1, plus one extra pass at 1."""
    s = 1
    while 2 * s < search_range:
        s *= 2
    steps = []
    while s >= 1:
        steps.append(s)
        s //= 2
    return steps + [1]


def seed_stack_dense(kl_id_img, sub_x, sub_y, gx, gy, threshold,
                     search_range: int, rows: int, cols: int, scale: int) -> torch.Tensor:
    """The flood's seeded region stack ``[5*(frows+PAD), fcols]``: regions
    (sy, sx, id, gx, gy) in field units, separated by PAD sentinel rows
    (BIG, BIG, -1, 0, 0).

    A keyline pixel (r, c) seeds field cell (floor((r+sub_y)/s + 0.5),
    floor((c+sub_x)/s + 0.5)); where several pixels seed one cell the
    largest keyline id wins (ids are raster-order ranks, so this is the
    scatter's last-writer rule).  Written here as one deterministic
    scatter-max over the pixels, then a write of the unique winners'
    payload; the JAX version reaches the same stack with a 9-tap reduce."""
    H, W = kl_id_img.shape
    dev = kl_id_img.device
    s = scale
    frows, fcols, sr = field_geometry(search_range, rows, cols, scale)

    g2 = gx * gx + gy * gy
    use = (kl_id_img >= 0) & torch.where(threshold > 0.0, g2 >= threshold * threshold,
                                         torch.ones_like(g2, dtype=torch.bool))
    inv_s = 1.0 / s
    rr = torch.arange(H, dtype=torch.float32, device=dev)[:, None]
    cc = torch.arange(W, dtype=torch.float32, device=dev)[None, :]
    py = (rr + sub_y) * inv_s
    px = (cc + sub_x) * inv_s
    fr = torch.floor(py + 0.5)
    fc = torch.floor(px + 0.5)
    inb = use & (fr >= 0) & (fr < frows) & (fc >= 0) & (fc < fcols)
    n = frows * fcols
    cell = torch.where(inb, fr * fcols + fc, float(n)).to(torch.int64).reshape(-1)
    ids = kl_id_img.reshape(-1)
    best = torch.full((n + 1,), -1, dtype=torch.int32, device=dev)
    best = best.scatter_reduce(0, cell, torch.where(inb.reshape(-1), ids, -1), reduce="amax")
    win = inb.reshape(-1) & (best[cell] == ids)        # one winner per cell
    wcell = cell[win]

    PAD = flood_pad(sr)
    Rp = frows + PAD
    fill = torch.tensor([BIG, BIG, -1.0, 0.0, 0.0], dtype=torch.float32, device=dev)
    stack = fill[:, None, None].expand(5, Rp, fcols).contiguous()
    data = stack[:, :frows, :].reshape(5, n)
    for r, plane in enumerate((py, px, kl_id_img.to(torch.float32), gx, gy)):
        data[r, wcell] = plane.reshape(-1)[win]
    stack[:, :frows, :] = data.reshape(5, frows, fcols)
    return stack.reshape(5 * Rp, fcols)


def att_rows(att_planes: torch.Tensor) -> torch.Tensor:
    """[8, N] attribute planes -> [N, 8] gatherable rows (a view)."""
    return att_planes.T


def keyline_gate(em) -> torch.Tensor:
    """Which keylines seed a field: valid, and at or above the map's
    threshold on the stored gradient norm when that threshold is set."""
    return em.valid & ((em.threshold <= 0.0) | (em.grad_norm >= em.threshold))


def build_att_field(em, search_range: int, rows: int, cols: int, scale: int = 1,
                    seed_stack: torch.Tensor = None) -> torch.Tensor:
    """Dense nearest-keyline attribute field, ``[8, N]`` planes of
    (0, d2, id, grad_x, grad_y, grad_norm, pos_x, pos_y) with id = -1
    beyond ``search_range``.  With ``seed_stack`` (the detector's dense
    stack, ``seed_stack_dense``) only the flood runs (K1) and ``em`` is not
    read; without one the keyline table of ``em`` is scattered into the
    stack first (K1b)."""
    if seed_stack is not None:
        frows, fcols, sr = field_geometry(search_range, rows, cols, scale)
        return kernels.att_flood(seed_stack, sr, frows, fcols, scale)
    return kernels.att_field(em.pos.contiguous(), em.grad.contiguous(), keyline_gate(em),
                             search_range, rows, cols, scale)


def build_nn_field(em, search_range: int, rows: int, cols: int, scale: int = 1) -> torch.Tensor:
    """Dense nearest-keyline id field: ``[frows*fcols]`` int32, -1 where no
    keyline lies within ``search_range``.  ``scale`` > 1 builds it on the
    decimated grid (positions divided by ``scale``, search range in field
    units); consumers index it with pixel // scale.  Computed by K7's flood
    on the exact subpixel metric."""
    frows, fcols, sr = field_geometry(search_range, rows, cols, scale)
    pos = em.pos if scale == 1 else em.pos / torch.full_like(em.pos, float(scale))
    return kernels.nn_field(pos.contiguous(), keyline_gate(em), sr, frows, fcols)
