"""The CPU emulation of csrc/flood.cu's flood, shared by the tests of K1
(tests/test_torch_flood_schedule.py: seeds read from the region stack) and
K1b (tests/test_torch_seed_flood.py: seeds read from the keyline table), and
the field comparison both hold it to.  Test helpers, on no path; no JAX."""

from __future__ import annotations

import numpy as np
import torch

from rebvio_tpu_torch.ops import kernels

BIG = 1e9


def dist2(y, x, sy, sx):
    a = y - sy
    b = x - sx
    return a * a + b * b


def emulate_seeded_flood(seed, attrs, sr: int, rows: int, cols: int, scale: int, tile: int):
    """csrc/flood.cu's ``flood`` over a seed policy, as the kernel runs it:
    a state of (sy, sx, src) per cell; long steps as full-grid passes; short
    steps on tiles with a halo, loaded once, updated with overlapped tiling
    (step s on the tile grown by the sum of the steps after it); rows
    outside the data read from the seeds, columns wrapping; the finish
    taking (id, gx, gy) from src, the gradient norm correctly rounded (the
    kernel's __fsqrt_rn; numpy's, as PyTorch's CPU sqrt is not always
    repeatable).  ``seed(yv, c)`` gives (sy, sx, src) of virtual cells, yv
    in [-PAD, rows + PAD); ``attrs(src)`` (id, gx, gy)."""
    pad, _ = kernels.flood_layout(rows, sr)
    long_steps, short_steps, halo = kernels.flood_schedule(sr)
    yy = torch.arange(rows)[:, None].expand(rows, cols)
    xx = torch.arange(cols)[None, :].expand(rows, cols)
    sy, sx, src = seed(yy, xx)

    def read(yv, c):                 # the state on data rows, the seeds elsewhere
        inside = (yv >= 0) & (yv < rows)
        yc = yv.clamp(0, rows - 1)
        ssy, ssx, ssrc = seed(yv, c)
        return (torch.where(inside, sy[yc, c], ssy), torch.where(inside, sx[yc, c], ssx),
                torch.where(inside, src[yc, c], ssrc))

    # long steps: full-grid passes
    for s in long_steps:
        best = dist2(yy.float(), xx.float(), sy, sx)
        nsy, nsx, nsrc = sy, sx, src
        for dy in (-s, 0, s):
            for dx in (-s, 0, s):
                if dy == 0 and dx == 0:
                    continue
                csy, csx, csrc = read(yy - dy, (xx - dx) % cols)
                cd2 = dist2(yy.float(), xx.float(), csy, csx)
                b = cd2 < best
                best = torch.where(b, cd2, best)
                nsy, nsx, nsrc = (torch.where(b, v, w) for v, w in
                                  ((csy, nsy), (csx, nsx), (csrc, nsrc)))
        sy, sx, src = nsy, nsx, nsrc

    # short steps: every tile with its halo at once, [tiles, side, side]
    side = tile + 2 * halo
    ty, tx = -(-rows // tile), -(-cols // tile)
    y0 = (torch.arange(ty) * tile).repeat_interleave(tx)
    x0 = (torch.arange(tx) * tile).repeat(ty)
    loc = torch.arange(side) - halo
    yv = (y0[:, None] + loc)[:, :, None].expand(-1, side, side)
    c = ((x0[:, None] + loc) % cols)[:, None, :].expand(-1, side, side)
    inside = (yv >= 0) & (yv < rows)
    in_pad = ~inside & (yv >= -pad) & (yv < rows + pad)
    yc, yp = yv.clamp(0, rows - 1), yv.clamp(-pad, rows + pad - 1)
    psy, psx, psrc = seed(yp, c)
    t_sy = torch.where(inside, sy[yc, c], torch.where(in_pad, psy, BIG))
    t_sx = torch.where(inside, sx[yc, c], torch.where(in_pad, psx, BIG))
    t_src = torch.where(inside, src[yc, c], torch.where(in_pad, psrc, -1))
    tyf, txf = yv.float(), c.float()
    m = halo
    for s in short_steps:
        m -= s
        lo, hi = halo - m, halo + tile + m
        reg = (slice(None), slice(lo, hi), slice(lo, hi))
        best = dist2(tyf[reg], txf[reg], t_sy[reg], t_sx[reg])
        nsy, nsx, nsrc = t_sy[reg], t_sx[reg], t_src[reg]
        for dy in (-s, 0, s):
            for dx in (-s, 0, s):
                if dy == 0 and dx == 0:
                    continue
                cand = (slice(None), slice(lo - dy, hi - dy), slice(lo - dx, hi - dx))
                cd2 = dist2(tyf[reg], txf[reg], t_sy[cand], t_sx[cand])
                b = (cd2 < best) & inside[reg]
                best = torch.where(b, cd2, best)
                nsy, nsx, nsrc = (torch.where(b, v[cand], w) for v, w in
                                  ((t_sy, nsy), (t_sx, nsx), (t_src, nsrc)))
        t_sy, t_sx, t_src = t_sy.clone(), t_sx.clone(), t_src.clone()
        t_sy[reg], t_sx[reg], t_src[reg] = nsy, nsx, nsrc

    # the finish on each tile's own cells
    ctr = (slice(None), slice(halo, halo + tile), slice(halo, halo + tile))
    fx_raw = x0[:, None, None] + torch.arange(tile)[None, None, :]
    real = (yv[ctr] < rows) & (fx_raw < cols)
    fy, fx = yv[ctr][real], c[ctr][real]
    fsy, fsx, fsrc = t_sy[ctr][real], t_sx[ctr][real], t_src[ctr][real]
    idv, gx, gy = attrs(fsrc)
    d2 = dist2(fy.float(), fx.float(), fsy, fsx)
    out = torch.full((8, rows, cols), float("nan"))
    out[:, fy, fx] = torch.stack([
        torch.zeros_like(d2), d2, torch.where(d2 <= float(sr * sr), idv, -1.0), gx, gy,
        norm(gx, gy), fsx * float(scale), fsy * float(scale)])
    return out.reshape(8, rows * cols)


def norm(gx: torch.Tensor, gy: torch.Tensor) -> torch.Tensor:
    """sqrt(gx*gx + gy*gy) in float32, each operation correctly rounded."""
    return torch.from_numpy(np.sqrt((gx * gx + gy * gy).numpy()))


def bits(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().view(torch.int32)


EXACT_PLANES = [0, 1, 2, 3, 4, 6, 7]


def assert_same_field(got: torch.Tensor, want: torch.Tensor):
    """Seven planes bit for bit; the gradient norm (plane 5, a function of
    planes 3 and 4 alone) of both, bit for bit, the correctly rounded norm
    of the plain version's planes 3 and 4 (the kernel's __fsqrt_rn; the
    plain version takes its float32 sum's sqrt in float64, as PyTorch's
    float32 CPU sqrt is not correctly rounded)."""
    assert torch.equal(bits(got[EXACT_PLANES]), bits(want[EXACT_PLANES]))
    assert torch.equal(bits(got[5]), bits(norm(want[3], want[4])))
    assert torch.equal(bits(want[5]), bits(norm(want[3], want[4])))


def normed(field: torch.Tensor) -> torch.Tensor:
    """An [8, N] field with its gradient-norm plane (5) replaced by the
    correctly rounded norm of planes 3 and 4 (``norm``): what the kernels
    give on the card (__fsqrt_rn) and the plain versions everywhere."""
    return torch.cat([field[:5], norm(field[3], field[4])[None], field[6:]])
