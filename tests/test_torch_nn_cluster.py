"""The layout of K7's cluster kernel (``kernels.nn_cluster_plan``, which the
wrapper hands to csrc/nn_flood.cu) and an emulation of the kernel, held to
``nn_field_plain`` bit for bit.

The kernel runs only on the card.  The emulation repeats its design in
PyTorch: rows split over C CTAs in contiguous blocks of R (the last CTAs
owning fewer, or none); H threads to a column, thread h owning rows h,
h + H, ... of its CTA, with its own ``best`` per cell; the ids alone as shared state, ping-ponging between two buffers per CTA, a
candidate read from the buffer of the CTA that owns its row through the row
table; the candidate's (sy, sx) gathered as pos[id]; the radius gate last.
Every read must land on a slot written before it.  A partition, wrap or
ownership error shows here first."""

from __future__ import annotations

import functools

import numpy as np
import pytest
import torch

from rebvio_tpu_torch.ops import kernels
from rebvio_tpu_torch.ops.distance_field import flood_steps

BIG = 1e9


def _d2(y, x, sy, sx):
    a = y - sy
    b = x - sx
    return a * a + b * b


def emulate_nn_cluster(pos, use, sr: int, rows: int, cols: int, C: int):
    """csrc/nn_flood.cu's algorithm on the CPU (test helper, on no path)."""
    R, T, rt, _pos_smem, _smem = kernels.nn_cluster_plan(rows, cols, pos.shape[0], C)
    winner, _, _ = kernels.seed_winner_plain(pos, use, rows, cols, 1.0)
    # thread t owns column t % Tc, rows t // Tc + H*k (k < rt) of its CTA's
    # rows i < min(R, rows - r0): [C, rt, T]
    Tc = -(-cols // 32) * 32
    H = T // Tc
    t = torch.arange(T)[None, None, :]
    X = t % Tc
    YL = t // Tc + H * torch.arange(rt)[None, :, None]
    q = torch.arange(C)[:, None, None]                            # CTA rank
    own = (YL < (rows - q * R).clamp(0, R)) & (X < cols)
    y = q * R + YL
    li = YL * cols + X
    qq, li_o, y_o, x_o = (a.expand(own.shape)[own] for a in (q, li, y, X))
    assert T % Tc == 0 and H * rt >= R
    cover = torch.zeros(rows * cols, dtype=torch.long)
    cover.index_add_(0, y_o * cols + x_o, torch.ones_like(y_o))
    assert torch.equal(cover, torch.ones_like(cover)), "every cell owned exactly once"
    assert (li_o < R * cols).all()

    r = torch.arange(rows)
    row_q, row_base = r // R, (r - (r // R) * R) * cols           # the row table
    buf = torch.full((2, C, R * cols), -1, dtype=torch.int32)
    written = torch.zeros((2, C, R * cols), dtype=torch.bool)
    px, py = pos[:, 0], pos[:, 1]
    yf, xf = y_o.float(), x_o.float()

    w = winner[y_o * cols + x_o]
    best = torch.where(w >= 0, _d2(yf, xf, py[w.clamp(min=0)], px[w.clamp(min=0)]), BIG)
    buf[0, qq, li_o], written[0, qq, li_o] = w, True
    p = 0
    for s in flood_steps(sr):
        for dy in (-s, 0, s):
            for dx in (-s, 0, s):
                if dy == 0 and dx == 0:
                    continue
                sy = y_o - dy % rows
                sy = torch.where(sy < 0, sy + rows, sy)
                sx = x_o - dx % cols
                sx = torch.where(sx < 0, sx + cols, sx)
                src_q, src_li = row_q[sy], row_base[sy] + sx
                assert written[p & 1, src_q, src_li].all() and written[p & 1, qq, li_o].all()
                cid = buf[p & 1, src_q, src_li]
                c = cid.clamp(min=0).long()
                cd2 = _d2(yf, xf, py[c], px[c])
                take = (cid >= 0) & (cd2 < best)
                best = torch.where(take, cd2, best)
                nxt = torch.where(take, cid, buf[p & 1, qq, li_o])
                buf[(p + 1) & 1, qq, li_o], written[(p + 1) & 1, qq, li_o] = nxt, True
                p += 1
    out = torch.empty(rows * cols, dtype=torch.int32)
    out[y_o * cols + x_o] = torch.where(best <= float(sr * sr), buf[p & 1, qq, li_o], -1)
    return out


@functools.lru_cache(maxsize=None)
def _table(rows: int, cols: int):
    """Keylines over the field and a margin outside it, the second half
    within 0.4 of the first half's positions (several keylines per cell), a
    tenth gated out."""
    rng = np.random.RandomState(rows + cols)
    K = rows * cols // 10
    half = K // 2
    pos = np.stack([rng.uniform(-3, cols + 3, K), rng.uniform(-3, rows + 3, K)], -1)
    pos[half:] = pos[:half] + rng.uniform(-0.4, 0.4, (K - half, 2))
    return torch.as_tensor(pos.astype(np.float32)), torch.as_tensor(rng.rand(K) < 0.9)


@functools.lru_cache(maxsize=None)
def _plain(sr: int, rows: int, cols: int):
    pos, use = _table(rows, cols)
    return kernels.nn_field_plain(pos, use, sr, rows, cols)


@pytest.mark.parametrize("C", [8, 16])
@pytest.mark.parametrize("rows,cols", [(37, 53), (240, 376)])
@pytest.mark.parametrize("sr", [3, 5, 20])
def test_emulated_cluster_kernel_matches_plain(sr, rows, cols, C):
    pos, use = _table(rows, cols)
    want = _plain(sr, rows, cols)
    got = emulate_nn_cluster(pos, use, sr, rows, cols, C)
    assert torch.equal(got, want)
    assert (want >= 0).sum() > rows * cols // 4


def test_table_has_collisions_and_gated_keylines():
    pos, use = _table(240, 376)
    winner, _, _ = kernels.seed_winner_plain(pos, use, 240, 376, 1.0)
    inside = int(kernels._seed_cells(pos, use, 240, 376, 1.0)[3].sum())
    assert int((winner >= 0).sum()) < inside and not use.all()


def test_seed_coordinates_are_the_positions():
    """The kernel reads a cell's (sy, sx) as pos[id]: the plain version's seed
    coordinates, pos * 1.0, are the positions bit for bit."""
    pos, use = _table(37, 53)
    py, px, _cell, _inb = kernels._seed_cells(pos, use, 37, 53, 1.0)
    assert torch.equal(py.view(torch.int32), pos[:, 1].contiguous().view(torch.int32))
    assert torch.equal(px.view(torch.int32), pos[:, 0].contiguous().view(torch.int32))


@pytest.mark.parametrize("rows,cols", [(240, 376), (480, 752), (37, 53), (5, 7), (240, 752)])
@pytest.mark.parametrize("K", [8192, 16000])
def test_cluster_plan(rows, cols, K):
    """A thread per column in whole warps, the CTA's rows within the
    kernel's count, the shared memory the two id buffers and row tables
    (plus the keyline table where it fits) within the H100's 227 KB; the
    full-resolution EuRoC field fits at C = 16 only, without the table."""
    for C in kernels.NN_CLUSTERS:
        plan = kernels.nn_cluster_plan(rows, cols, K, C)
        if plan is None:
            assert (rows, cols, C) == (480, 752, 8)
            continue
        R, T, rt, pos_smem, smem = plan
        Tc = -(-cols // 32) * 32
        assert R == -(-rows // C) and T % Tc == 0 and (T // Tc) * rt >= R
        assert T <= dict(kernels.NN_RT)[rt]
        ids = 8 * R * cols + 8 * rows
        assert smem == ids + 8 * K * pos_smem <= kernels.NN_SMEM_MAX
        assert pos_smem == (ids + 8 * K <= kernels.NN_SMEM_MAX)
    assert kernels.nn_cluster_plan(240, 376, 16000, 16)[3]           # the tool's field
    assert not kernels.nn_cluster_plan(480, 752, 16000, 16)[3]
    assert kernels.nn_cluster_plan(960, 1504, K, 16) is None
