"""K1b as one launch (csrc/flood.cu's att_field_kernel) emulated on the CPU
and held to ``kernels.att_field_plain``, and the two wrappers whose routes
are one launch each (``kernels.att_field``, ``kernels.reg_ekf``).

The kernel runs only on the card.  The emulation repeats its design in
PyTorch: phase 0, the winner plane by an integer max per keyline (in a
shuffled order, as the atomics land); then K1's flood (tests/torch_flood.py)
on the schedule ``kernels.flood_schedule`` hands the kernel, its state
(sy, sx, keyline id), seeds read from the table through the winner plane,
pad rows synthesised: the region's own sentinel below the data, the rotated
one (0, BIG, BIG, -1, 0) above row 0.  Every plane bit for bit: seven
against the plain version, the gradient norm against the correctly rounded
sqrt of the plain version's gx, gy (the kernel's __fsqrt_rn, which the
plain version also gives).  No JAX:
the plain version is held to ``att_field_pallas`` by
tests/test_torch_nn_field.py."""

from __future__ import annotations

import inspect
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from torch_flood import BIG, EXACT_PLANES, bits, emulate_seeded_flood, norm  # noqa: E402

from rebvio_tpu_torch.ops import kernels  # noqa: E402
from rebvio_tpu_torch.ops.distance_field import field_geometry  # noqa: E402

OWN, ROTATED = -1, -2          # csrc/flood.cu kOwn, kRotated
H, W, SR = 120, 188, 20        # image rows, cols, search range (the small preset's frame)


def table_seeds(pos, grad, use, search_range: int, rows: int, cols: int, scale: int,
                order_seed: int = 0):
    """att_field_kernel's phase 0 and its TableSeeds: (seed, attrs, the
    winner plane, the field geometry)."""
    frows, fcols, sr = field_geometry(search_range, rows, cols, scale)
    K = pos.shape[0]
    inv = torch.full((), 1.0 / scale, dtype=torch.float32)
    px, py = pos[:, 0] * inv, pos[:, 1] * inv
    fc, fr = torch.floor(px + 0.5), torch.floor(py + 0.5)
    inb = use & (fr >= 0) & (fr < frows) & (fc >= 0) & (fc < fcols)
    winner = [-1] * (frows * fcols)
    for k in np.random.RandomState(order_seed).permutation(K).tolist():   # atomicMax
        if inb[k]:
            cell = int(fr[k]) * fcols + int(fc[k])
            winner[cell] = max(winner[cell], k)
    winner = torch.tensor(winner, dtype=torch.int64).reshape(frows, fcols)
    # a dummy row so that the gathers of sentinel codes stay in range on an empty table
    py1, px1 = torch.cat([py, torch.zeros(1)]), torch.cat([px, torch.zeros(1)])
    grad1 = torch.cat([grad, torch.zeros(1, 2)])

    def seed(yv, c):
        w = torch.where((yv >= 0) & (yv < frows), winner[yv.clamp(0, frows - 1), c], OWN)
        w = torch.where(yv < 0, ROTATED, w)
        wk = torch.where(w >= 0, w, K)
        sy = torch.where(w >= 0, py1[wk], torch.where(w == ROTATED, 0.0, BIG))
        sx = torch.where(w >= 0, px1[wk], BIG)
        return sy, sx, w

    def attrs(src):
        wk = torch.where(src >= 0, src, K)
        rot = src == ROTATED
        idv = torch.where(src >= 0, src.float(), torch.where(rot, BIG, -1.0))
        gx = torch.where(src >= 0, grad1[wk, 0], torch.where(rot, -1.0, 0.0))
        gy = torch.where(src >= 0, grad1[wk, 1], 0.0)
        return idv, gx, gy

    return seed, attrs, winner, (frows, fcols, sr)


def emulate_att_field(pos, grad, use, search_range: int, rows: int, cols: int, scale: int,
                      tile: int = 16):
    seed, attrs, _, (frows, fcols, sr) = table_seeds(pos, grad, use, search_range, rows, cols,
                                                     scale)
    return emulate_seeded_flood(seed, attrs, sr, frows, fcols, scale, tile)


def _table(case: str, scale: int):
    """A keyline table over the H x W image (image units)."""
    rng = np.random.RandomState({"collisions": 1, "gated": 2, "edges": 3, "sparse": 4,
                                 "empty": 5}[case] * 10 + scale)
    if case == "empty":
        pos, use = np.zeros((0, 2)), np.zeros(0, bool)
    elif case == "collisions":
        # the second half on the cells of the first half, a tenth gated out
        K = 600
        pos = np.stack([rng.uniform(-6, W + 6, K), rng.uniform(-6, H + 6, K)], -1)
        pos[K // 2:] = pos[:K // 2] + rng.uniform(-0.4, 0.4, (K - K // 2, 2)) * scale
        use = rng.rand(K) < 0.9
    elif case == "gated":
        # every other keyline gated off, each on the cell of the kept one
        # before it: a larger index that is gated out must not win the cell
        K = 400
        pos = np.repeat(np.stack([rng.uniform(0, W, K // 2), rng.uniform(0, H, K // 2)], -1),
                        2, axis=0)
        use = np.tile([True, False], K // 2)
    elif case == "edges":
        # on the field's first and last rows and columns (a cell's half-way
        # line in both directions), just outside, far out and NaN
        s = float(scale)
        fr, fc = -(-H // scale), -(-W // scale)
        xs = [0.0, 0.49 * s, (fc - 1) * s, (fc - 0.51) * s, (fc - 0.5) * s, -0.5 * s,
              -0.51 * s, 1e9, float("nan")]
        ys = [0.0, 0.49 * s, (fr - 1) * s, (fr - 0.51) * s, (fr - 0.5) * s, -0.5 * s,
              -0.51 * s, -1e9, 3.0]
        edge = [(x, y) for x in xs for y in (ys[0], ys[2])] + \
               [(x, y) for y in ys for x in (xs[0], xs[2])]
        inner = np.stack([rng.uniform(0, W, 20), rng.uniform(0, H, 20)], -1)
        pos = np.concatenate([np.asarray(edge), inner])
        use = np.ones(len(pos), bool)
    else:   # sparse: far from most cells, so the sentinels spread, the rotated one too
        K = 6
        pos = np.stack([rng.uniform(0, W, K), rng.uniform(0.6 * H, H, K)], -1)
        use = np.ones(K, bool)
    K = len(pos)
    grad = rng.normal(0, 100, (K, 2))
    return (torch.as_tensor(pos, dtype=torch.float32).reshape(K, 2),
            torch.as_tensor(grad, dtype=torch.float32).reshape(K, 2), torch.as_tensor(use))


CASES = ["collisions", "gated", "edges", "sparse", "empty"]


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("scale", [1, 2])
def test_emulated_kernel_matches_plain(scale, case):
    pos, grad, use = _table(case, scale)
    want = kernels.att_field_plain(pos, grad, use, SR, H, W, scale)
    got = emulate_att_field(pos, grad, use, SR, H, W, scale)
    assert not torch.isnan(got).any()
    assert torch.equal(bits(got[EXACT_PLANES]), bits(want[EXACT_PLANES]))
    assert torch.equal(bits(got[5]), bits(norm(want[3], want[4])))
    if case == "sparse":            # the rotated sentinel reached the output
        assert ((want[3] == -1.0) & (want[7] == 0.0)).any()


@pytest.mark.parametrize("case", ["collisions", "gated", "edges"])
def test_winner_plane_is_order_free(case):
    """The winner plane is the same whatever order the atomics land in, and
    is the plain scatter-max's."""
    pos, grad, use = _table(case, 2)
    frows, fcols, _ = field_geometry(SR, H, W, 2)
    want, _, _ = kernels.seed_winner_plain(pos, use, frows, fcols, 0.5)
    for order in range(3):
        winner = table_seeds(pos, grad, use, SR, H, W, 2, order_seed=order)[2]
        assert torch.equal(winner.reshape(-1).to(torch.int32), want)
    if case != "edges":
        assert int((want >= 0).sum()) < int(use.sum())      # collisions were forced


@pytest.mark.parametrize("scale", [1, 2])
def test_synthesised_seeds_equal_the_stack(scale):
    """The table's seeds on every virtual row, pad rows included, are the
    plain version's stack read as K1 reads it (rows above 0 from the
    previous region's pad), and the finish's (id, gx, gy) of each src are
    that stack's planes 2-4 at the same cell."""
    pos, grad, use = _table("collisions", scale)
    seed, attrs, _, (frows, fcols, sr) = table_seeds(pos, grad, use, SR, H, W, scale)
    pad, Rp = kernels.flood_layout(frows, sr)
    st = kernels.seed_stack_plain(pos, grad, use, SR, H, W, scale)
    yv = torch.arange(-pad, frows + pad)[:, None].expand(-1, fcols)
    c = torch.arange(fcols)[None, :].expand(frows + 2 * pad, -1)

    def stack_at(r, y):
        row = r * Rp + y
        return st[torch.where(row < 0, row + 5 * Rp, row), c]

    sy, sx, src = seed(yv, c)
    assert torch.equal(sy, stack_at(0, yv)) and torch.equal(sx, stack_at(1, yv))
    for got, r in zip(attrs(src), (2, 3, 4)):
        assert torch.equal(got, stack_at(r, yv))


@pytest.mark.parametrize("wrapper,entry,absent", [
    ("att_field", "rk_att_field", ("rk_seed_stack", "rk_seed_winner", "att_flood(")),
    ("_launch_reg_ekf", "rk_reg_ekf", ("match_reg_ekf", "zeros", "eye")),
])
def test_card_route_is_one_launch(wrapper, entry, absent):
    """On CUDA tensors each wrapper makes one launch of its own kernel: K1b
    no longer seeds a stack for K1's flood, and K5 alone no longer runs the
    fused stage on an all-zero K4 output, eye(3) and a flag."""
    src = inspect.getsource(getattr(kernels, wrapper))
    assert src.count("lib." + entry if wrapper == "att_field" else entry) == 1
    assert not [a for a in absent if a in src]
    cuda_branch = inspect.getsource(kernels.reg_ekf).split("reg_ekf_plain(*ins, p)")[1]
    assert "match_reg_ekf" not in cuda_branch and "torch.ops.rebvio.reg_ekf" in cuda_branch
