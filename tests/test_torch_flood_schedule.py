"""The schedule of K1's kernel (``kernels.flood_schedule``, which the
wrapper hands to csrc/flood.cu) and an emulation of the kernel's two phases,
held to ``att_flood_plain``: seven planes bit for bit, the gradient norm
within one ulp (see ``_assert_same_field``).

The kernel runs only on the card.  The emulation repeats its design in
PyTorch: a state of (sy, sx, src) per cell, src indexing the virtual grid
[-PAD, rows + PAD) x cols; long steps as full-grid passes; short steps on
tiles with a halo, loaded once, updated with overlapped tiling (step s on
the tile grown by the sum of the steps after it); rows outside the data
read from the stack's pad rows, columns wrapping; the finish gathering id
and gradient at src.  A halo, wrap or schedule error shows here first."""

from __future__ import annotations

import functools

import numpy as np
import pytest
import torch

from rebvio_tpu_torch.ops import kernels
from rebvio_tpu_torch.ops.distance_field import flood_pad, flood_steps

BIG = 1e9


@pytest.mark.parametrize("sr,want", [
    (20, ([16, 8], [4, 2, 1, 1], 8)),          # the parity field
    (40, ([32, 16, 8], [4, 2, 1, 1], 8)),
    (10, ([8], [4, 2, 1, 1], 8)),              # the fast profile's loop-closure field
    (5, ([], [4, 2, 1, 1], 8)),                # no long step
    (3, ([], [2, 1, 1], 4)),
    (1, ([], [1, 1], 2)),
])
def test_flood_schedule_split(sr, want):
    assert kernels.flood_schedule(sr) == want


@pytest.mark.parametrize("sr", range(1, 130, 7))
def test_flood_schedule_invariants(sr):
    """The split keeps every step in order, the halo is the short steps' sum
    and at most the largest halo, and PAD covers every step and the halo,
    so a read outside the data rows always lands in a pad row."""
    long_steps, short_steps, halo = kernels.flood_schedule(sr)
    assert long_steps + short_steps == flood_steps(sr)
    assert halo == sum(short_steps) <= kernels.FLOOD_HALO_MAX
    assert short_steps and (not long_steps or long_steps[-1] + halo > kernels.FLOOD_HALO_MAX)
    assert max(long_steps + short_steps) <= flood_pad(sr) and halo <= flood_pad(sr)


def _dist2(y, x, sy, sx):
    a = y - sy
    b = x - sx
    return a * a + b * b


def emulate_flood(stack, sr: int, rows: int, cols: int, scale: int, tile: int):
    """csrc/flood.cu's algorithm on the CPU (test helper, on no path)."""
    pad, Rp = kernels.flood_layout(rows, sr)
    long_steps, short_steps, halo = kernels.flood_schedule(sr)
    SR = 5 * Rp
    st = stack.reshape(SR, cols)

    def stack_at(r, yv, c):          # rows above 0 wrap to the stack's end for plane 0
        row = r * Rp + yv
        return st[torch.where(row < 0, row + SR, row), c]

    def enc(yv, c):
        return (yv + pad) * cols + c

    yy = torch.arange(rows)[:, None].expand(rows, cols)
    xx = torch.arange(cols)[None, :].expand(rows, cols)
    sy, sx, src = stack_at(0, yy, xx), stack_at(1, yy, xx), enc(yy, xx)

    def read(yv, c):                 # the state on data rows, the stack's pad rows elsewhere
        inside = (yv >= 0) & (yv < rows)
        yc = yv.clamp(0, rows - 1)
        return (torch.where(inside, sy[yc, c], stack_at(0, yv, c)),
                torch.where(inside, sx[yc, c], stack_at(1, yv, c)),
                torch.where(inside, src[yc, c], enc(yv, c)))

    # long steps: full-grid passes
    for s in long_steps:
        best = _dist2(yy.float(), xx.float(), sy, sx)
        nsy, nsx, nsrc = sy, sx, src
        for dy in (-s, 0, s):
            for dx in (-s, 0, s):
                if dy == 0 and dx == 0:
                    continue
                csy, csx, csrc = read(yy - dy, (xx - dx) % cols)
                cd2 = _dist2(yy.float(), xx.float(), csy, csx)
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
    t_sy = torch.where(inside, sy[yc, c], torch.where(in_pad, stack_at(0, yp, c), BIG))
    t_sx = torch.where(inside, sx[yc, c], torch.where(in_pad, stack_at(1, yp, c), BIG))
    t_src = torch.where(inside, src[yc, c], torch.where(in_pad, enc(yp, c), -1))
    tyf, txf = yv.float(), c.float()
    m = halo
    for s in short_steps:
        m -= s
        lo, hi = halo - m, halo + tile + m
        reg = (slice(None), slice(lo, hi), slice(lo, hi))
        best = _dist2(tyf[reg], txf[reg], t_sy[reg], t_sx[reg])
        nsy, nsx, nsrc = t_sy[reg], t_sx[reg], t_src[reg]
        for dy in (-s, 0, s):
            for dx in (-s, 0, s):
                if dy == 0 and dx == 0:
                    continue
                cand = (slice(None), slice(lo - dy, hi - dy), slice(lo - dx, hi - dx))
                cd2 = _dist2(tyf[reg], txf[reg], t_sy[cand], t_sx[cand])
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
    gy_, gc = fsrc // cols - pad, fsrc % cols
    idv, gx, gy = (stack_at(r, gy_, gc) for r in (2, 3, 4))
    d2 = _dist2(fy.float(), fx.float(), fsy, fsx)
    out = torch.full((8, rows, cols), float("nan"))
    out[:, fy, fx] = torch.stack([
        torch.zeros_like(d2), d2, torch.where(d2 <= float(sr * sr), idv, -1.0), gx, gy,
        torch.sqrt(gx * gx + gy * gy), fsx * float(scale), fsy * float(scale)])
    return out.reshape(8, rows * cols)


def _seeded_stack(rows: int, cols: int, sr: int, density: float, seed: int):
    """A seed stack in the flood's layout: random seeds plus seeds on the top
    and bottom rows and on the first and last columns (the column wrap),
    coordinates within half a cell of their cell, unique ids."""
    rng = np.random.RandomState(seed)
    pad, Rp = kernels.flood_layout(rows, sr)
    st = np.zeros((5, Rp, cols), np.float32)
    st[0] = st[1] = BIG
    st[2] = -1.0
    mask = rng.rand(rows, cols) < density
    for r in (0, rows - 1):
        mask[r, rng.choice(cols, 3, replace=False)] = True
    for col in (0, cols - 1):
        mask[rng.choice(rows, 3, replace=False), col] = True
    ys, xs = np.nonzero(mask)
    st[0, ys, xs] = ys + rng.uniform(-0.5, 0.5, len(ys))
    st[1, ys, xs] = xs + rng.uniform(-0.5, 0.5, len(xs))
    st[2, ys, xs] = rng.permutation(len(ys))
    st[3, ys, xs] = rng.normal(0, 100, len(ys))
    st[4, ys, xs] = rng.normal(0, 100, len(ys))
    return torch.as_tensor(st.reshape(5 * Rp, cols))


DENSITY = {"sparse": 0.002, "dense": 0.2}


@functools.lru_cache(maxsize=None)
def _case(sr: int, rows: int, cols: int, seeds: str):
    stack = _seeded_stack(rows, cols, sr, DENSITY[seeds], seed=sr * 7 + rows)
    return stack, kernels.att_flood_plain(stack, sr, rows, cols, 2)


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().view(torch.int32)


EXACT_PLANES = [0, 1, 2, 3, 4, 6, 7]


def _assert_same_field(got: torch.Tensor, want: torch.Tensor):
    """Seven planes bit for bit; the gradient norm (plane 5), a function of
    planes 3 and 4 alone, within one float32 ulp: PyTorch's CPU sqrt of
    ``gx*gx + gy*gy`` is not repeatable in the last bit (the plain version
    differs from itself between runs)."""
    assert torch.equal(_bits(got[EXACT_PLANES]), _bits(want[EXACT_PLANES]))
    torch.testing.assert_close(got[5], want[5], rtol=2.4e-7, atol=0)


@pytest.mark.parametrize("seeds", ["sparse", "dense"])
@pytest.mark.parametrize("tile", [16, 32])
@pytest.mark.parametrize("rows,cols", [(240, 376), (37, 53)])
@pytest.mark.parametrize("sr", [3, 5, 20, 40])
def test_emulated_kernel_matches_plain(sr, rows, cols, tile, seeds):
    stack, want = _case(sr, rows, cols, seeds)
    got = emulate_flood(stack, sr, rows, cols, 2, tile)
    assert not torch.isnan(got).any()
    _assert_same_field(got, want)


def test_reads_above_row_zero_take_the_rotated_sentinel():
    """Why the kernel reads pad rows from the stack: far from every seed, a
    cell near the top takes the previous region's pad (plane 0 from plane
    4's), the sentinel rotated to (0, BIG, BIG, -1, 0), and the flood
    spreads it (gx -1, seed y 0 in the output) where (BIG, BIG, -1, 0, 0)
    would leave gx 0 and seed y BIG."""
    rows, cols, sr = 60, 94, 20
    pad, Rp = kernels.flood_layout(rows, sr)
    st = np.zeros((5, Rp, cols), np.float32)
    st[0] = st[1] = BIG
    st[2] = -1.0
    st[:, 55, 10] = (55.0, 10.0, 7.0, 1.0, 2.0)
    out = kernels.att_flood_plain(torch.as_tensor(st.reshape(5 * Rp, cols)), sr, rows, cols, 2)
    out = out.reshape(8, rows, cols)
    rotated = (out[3] == -1.0) & (out[7] == 0.0) & (out[2] == -1.0)
    assert rotated.any() and (out[2] == 7.0).any()
    _assert_same_field(emulate_flood(torch.as_tensor(st.reshape(5 * Rp, cols)), sr, rows, cols, 2,
                                     32), out.reshape(8, -1))
