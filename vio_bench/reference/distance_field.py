"""Nearest-keyline fields (rebvio_tpu/ops/distance_field.py).  The attribute
field: dense seeding from the detector planes and the jump flood (kernel
K1, kernels.att_flood), or scatter seeding from the keyline table and the
same flood (kernel K1b, kernels.att_field).  The id-only field: the
exact-metric flood of kernel K7 (kernels.nn_field).  The reference's own
field (``df_mode="raster"``): gradient rays rasterized with one scatter-min
(build_distance_field, field_id)."""

from __future__ import annotations

import torch

from vio_bench.reference import kernels

# Plane layout of the attribute field (build_att_field)
ATT_PACKED, ATT_D2, ATT_ID, ATT_GX, ATT_GY, ATT_GN, ATT_POSX, ATT_POSY = range(8)

BIG = 1e9
_EMPTY = torch.iinfo(torch.int32).max


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
    scatter-max of the ids over the pixels, a second of the pixel index over
    the pixels that hold their cell's winning id (ids are unique, so one per
    cell), then a gather of the five planes at that pixel: no host sync.  The
    JAX version reaches the same stack with a 9-tap reduce."""
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
    inb = (use & (fr >= 0) & (fr < frows) & (fc >= 0) & (fc < fcols)).reshape(-1)
    n = frows * fcols
    # a pixel that seeds no cell writes a slot of its own past the n cells:
    # sent to one shared slot, all the pixels but the kept keylines would
    # serialize on a single atomic address
    pix = torch.arange(H * W, dtype=torch.int64, device=dev)
    slot = torch.where(inb, (fr * fcols + fc).reshape(-1).to(torch.int64), n + pix)
    ids = kl_id_img.reshape(-1)
    best = torch.full((n + H * W,), -1, dtype=torch.int32, device=dev)
    best = best.scatter_reduce(0, slot, torch.where(inb, ids, -1), reduce="amax")
    won = inb & (best[slot] == ids)
    wpix = torch.full((n + H * W,), -1, dtype=torch.int64, device=dev)
    wpix = wpix.scatter_reduce(0, torch.where(won, slot, n + pix), torch.where(won, pix, -1),
                               reduce="amax")[:n]
    has = wpix >= 0
    gathered = torch.stack([py, px, kl_id_img.to(torch.float32), gx, gy]).reshape(5, H * W)[
        :, wpix.clamp(min=0)]

    # the sentinels (BIG, BIG, -1, 0, 0) made on the device, not copied from
    # the host; the stack assembled out of place (a write into a fresh buffer
    # would not batch under torch.func.vmap)
    plane = torch.arange(5, device=dev)[:, None]
    sentinel = torch.where(plane == 2, -1.0, torch.where(plane >= 3, 0.0, BIG))
    PAD = flood_pad(sr)
    stack = torch.cat([torch.where(has, gathered, sentinel).reshape(5, frows, fcols),
                       sentinel[:, :, None].expand(5, PAD, fcols)], dim=1)
    return stack.reshape(5 * (frows + PAD), fcols)


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


def build_distance_field(em, search_range: int, rows: int, cols: int) -> torch.Tensor:
    """The reference's rasterized field (DistanceField::build, core.hpp:37-59):
    each gated keyline writes 2R samples along its unit gradient, at offsets
    -R..R-1, each rounded half away from zero.  Returns a packed
    ``[rows*cols]`` int32 field: -1 where empty, else ``dist * kmax + (kmax -
    1 - id)`` of the nearest sample, ties to the largest id (the sequential
    loop's last writer).

    One ``scatter_reduce`` "amin" over int32 keys: the min of unique keys
    does not depend on the order the atomics land in.  A sample off the
    image or of a gated-out keyline goes to a dump cell of its keyline past
    the field (sent to one shared cell, they would serialize on one
    address)."""
    kmax = em.kmax
    dev = em.pos.device
    use = keyline_gate(em)
    gn = torch.where(em.grad_norm > 0, em.grad_norm, 1.0)
    ux = em.grad[:, 0] / gn
    uy = em.grad[:, 1] / gn
    r = torch.arange(-search_range, search_range, dtype=torch.float32, device=dev)
    col = _round_half_away(ux[:, None] * r[None, :] + em.pos[:, 0:1])      # [K, 2R]
    row = _round_half_away(uy[:, None] * r[None, :] + em.pos[:, 1:2])
    inb = (row >= 0) & (row < rows) & (col >= 0) & (col < cols) & use[:, None]
    n = rows * cols
    ids = torch.arange(kmax, dtype=torch.int64, device=dev)[:, None]
    # in the field the flat index is exact in float32 (rows * cols < 2^24)
    cell = torch.where(inb, row * cols + col, 0.0).to(torch.int64)
    flat = torch.where(inb, cell, n + ids)
    dist = torch.abs(r).to(torch.int32)[None, :]
    key = (dist * kmax + (kmax - 1 - ids.to(torch.int32))).expand(flat.shape)
    field = torch.full((n + kmax,), _EMPTY, dtype=torch.int32, device=dev)
    field = field.scatter_reduce(0, flat.reshape(-1), key.reshape(-1), reduce="amin")[:n]
    return torch.where(field == _EMPTY, -1, field)


def field_id(field: torch.Tensor, kmax: int) -> torch.Tensor:
    """Keyline id of a packed field entry; -1 where empty."""
    return torch.where(field < 0, -1, kmax - 1 - field % kmax)
