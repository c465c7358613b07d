"""The schedule of K1's kernel (``kernels.flood_schedule``, which the
wrapper hands to csrc/flood.cu) and an emulation of the kernel's two phases,
held to ``att_flood_plain``: seven planes bit for bit, the gradient norm
bit for bit against the correctly rounded norm of its planes 3 and 4
(see ``torch_flood.assert_same_field``).

The kernel runs only on the card.  The emulation repeats its design in
PyTorch: a state of (sy, sx, src) per cell, src indexing the virtual grid
[-PAD, rows + PAD) x cols; long steps as full-grid passes; short steps on
tiles with a halo, loaded once, updated with overlapped tiling (step s on
the tile grown by the sum of the steps after it); rows outside the data
read from the stack's pad rows, columns wrapping; the finish gathering id
and gradient at src (tests/torch_flood.py, shared with K1b's test).  A
halo, wrap or schedule error shows here first."""

from __future__ import annotations

import functools
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from torch_flood import BIG, assert_same_field, emulate_seeded_flood  # noqa: E402

from rebvio_tpu_torch.ops import kernels  # noqa: E402
from rebvio_tpu_torch.ops.distance_field import flood_pad, flood_steps  # noqa: E402


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


def emulate_flood(stack, sr: int, rows: int, cols: int, scale: int, tile: int):
    """csrc/flood.cu's algorithm on the CPU (test helper, on no path) with
    K1's seeds: src indexes the virtual grid [-PAD, rows + PAD) x cols of
    the stack, whose pad rows the reads outside the data take."""
    pad, Rp = kernels.flood_layout(rows, sr)
    SR = 5 * Rp
    st = stack.reshape(SR, cols)

    def stack_at(r, yv, c):          # rows above 0 wrap to the stack's end for plane 0
        row = r * Rp + yv
        return st[torch.where(row < 0, row + SR, row), c]

    def seed(yv, c):
        return stack_at(0, yv, c), stack_at(1, yv, c), (yv + pad) * cols + c

    def attrs(src):
        gy_, gc = src // cols - pad, src % cols
        return tuple(stack_at(r, gy_, gc) for r in (2, 3, 4))

    return emulate_seeded_flood(seed, attrs, sr, rows, cols, scale, tile)


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


@pytest.mark.parametrize("seeds", ["sparse", "dense"])
@pytest.mark.parametrize("tile", [16, 32])
@pytest.mark.parametrize("rows,cols", [(240, 376), (37, 53)])
@pytest.mark.parametrize("sr", [3, 5, 20, 40])
def test_emulated_kernel_matches_plain(sr, rows, cols, tile, seeds):
    stack, want = _case(sr, rows, cols, seeds)
    got = emulate_flood(stack, sr, rows, cols, 2, tile)
    assert not torch.isnan(got).any()
    assert_same_field(got, want)


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
    assert_same_field(emulate_flood(torch.as_tensor(st.reshape(5 * Rp, cols)), sr, rows, cols, 2,
                                     32), out.reshape(8, -1))
