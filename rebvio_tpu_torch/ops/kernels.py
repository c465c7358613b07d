"""Wrappers of the CUDA kernels of the port (the VIO step's, two of the
loop-closure and field tools), their plain PyTorch versions, and their
launch counters.

| kernel      | CUDA source           | replaces (rebvio_tpu/ops/pallas_kernels.py) |
|-------------|-----------------------|---------------------------------------------|
| att_flood   | csrc/flood.cu         | _att_flood (K1)                             |
| try_vel     | csrc/try_vel.cu       | try_vel_math_pallas (K2; also try_vel_pallas)|
| minimize_vel| csrc/try_vel.cu       | the same, 1 + iterations passes + LM update |
| tube_match  | csrc/tube_match.cu    | tube_match_pallas (K4)                      |
| match_reg_ekf | csrc/reg_ekf.cu     | reg_ekf_pallas (K5), with the matcher's tail and the gate |
| reg_ekf     | csrc/reg_ekf.cu       | reg_ekf_pallas (K5) alone, one launch       |
| estimate_bias | csrc/sab.cu         | estimate_bias_pallas (K3)                   |
| att_field   | csrc/flood.cu         | att_field_pallas (K1b): seeding and flood, one launch |
| nn_field    | csrc/seed_scatter.cu, csrc/nn_flood.cu | nn_field_pallas (K7)       |
| band_matmul | csrc/band_matmul.cu   | none: the frontend's band-operator products |

Each wrapper checks device, dtype, shape and contiguity, allocates its
outputs with ``torch.empty`` and launches on the current stream.  A tensor
on the CPU goes to the plain version beside it (same inputs, same
outputs); a CUDA tensor launches the kernel or raises.  ``LAUNCHES[name]``
counts the wrapper's kernel launches (a multi-kernel call counts once;
``reg_ekf`` counts the fused stage, ``reg_ekf_alone`` K5 alone).
``chol_inverse`` (csrc/chol_inverse.cu, launched by geometry/linalg.py)
and ``band_matmul`` (csrc/band_matmul.cu, the frontend's band-operator
products, which JAX leaves to XLA) replace no TPU kernel and are counted
here too.

On the card the step's kernels (att_flood, minimize_vel / try_vel,
tube_match, match_reg_ekf, reg_ekf, estimate_bias, chol_inverse,
band_matmul) are reached through PyTorch operators
(``torch.ops.rebvio.*``) with a vmap rule: under
``torch.func.vmap`` (parallel/batch.py) each launches ONCE over all B lanes,
its inputs [B, ...], as ``jax.vmap`` of a ``pallas_call`` adds a grid axis.
Each kernel takes a lane count and keeps its arithmetic per lane, so a lane
gives the bits of an unbatched launch; the unbatched call is the launch of
one lane.  The rule never loops over lanes and raises on CPU tensors (the
plain versions, which run under vmap as they are, serve the CPU).
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import List, NamedTuple, Optional

import torch
from torch.library import custom_op

from rebvio_tpu_torch.ops import _build

LAUNCHES = {"att_flood": 0, "try_vel": 0, "minimize_vel": 0, "tube_match": 0, "reg_ekf": 0,
            "reg_ekf_alone": 0, "estimate_bias": 0, "att_field": 0, "nn_field": 0,
            "chol_inverse": 0, "band_matmul": 0}

f32, i32 = torch.float32, torch.int32


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _on_cuda(*ts) -> bool:
    devs = {t.get_device() for t in ts}      # -1 on the CPU, else the CUDA index
    if devs == {-1}:
        return False
    if len(devs) != 1 or not ts[0].is_cuda:
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


def _floats(params) -> list:
    """A NamedTuple of kernel constants as the operators' ``float[]`` (every
    int here is exact in a double)."""
    return [float(x) for x in params]


def _raise_on(err: int, name: str):
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {err}")


_COOP_BLOCKS = {}      # (C entry point, device index) -> co-resident block limit


def _coop_limit(lib, entry: str, dev: torch.device) -> int:
    """The most blocks of ``entry``'s cooperative kernel that can be
    co-resident on ``dev`` (``<entry>_max_blocks``), queried once per device."""
    key = (entry, dev.index)
    if key not in _COOP_BLOCKS:
        with torch.cuda.device(dev):
            _COOP_BLOCKS[key] = getattr(lib, entry + "_max_blocks")()
    if _COOP_BLOCKS[key] < 1:
        raise RuntimeError(f"{entry}: the occupancy query for the cooperative launch failed")
    return _COOP_BLOCKS[key]


# --------------------------------------------------------------------------
# K1: jump flood


def flood_layout(rows: int, search_range: int):
    from rebvio_tpu_torch.ops.distance_field import flood_pad

    pad = flood_pad(search_range)
    return pad, rows + pad


FLOOD_HALO_MAX = 8      # csrc/flood.cu kHaloMax: the tile phase's largest halo


def flood_schedule(search_range: int):
    """csrc/flood.cu's split of ``flood_steps``: (long steps, run as full-grid
    passes; short steps, run on shared-memory tiles; halo, the short steps'
    sum).  A step is short while it and the steps after it sum to at most
    ``FLOOD_HALO_MAX``."""
    from rebvio_tpu_torch.ops.distance_field import flood_steps

    steps = flood_steps(search_range)
    k = len(steps)
    while k > 0 and sum(steps[k - 1:]) <= FLOOD_HALO_MAX:
        k -= 1
    return steps[:k], steps[k:], sum(steps[k:])


@functools.lru_cache(maxsize=None)
def _flood_args(search_range: int, pad: int):
    """The schedule as rk_att_flood's arguments: (int array of the long then
    short steps, long count, short count, halo)."""
    long_steps, short_steps, halo = flood_schedule(search_range)
    if max(long_steps + short_steps) > pad or halo > pad:
        raise ValueError(f"att_flood: a step or the halo {halo} exceeds PAD {pad}: pad rows "
                         f"would no longer stand for every read outside the data rows")
    steps = long_steps + short_steps
    return (ctypes.c_int * len(steps))(*steps), len(long_steps), len(short_steps), halo


def att_flood(stack: torch.Tensor, search_range: int, rows: int, cols: int,
              scale: int) -> torch.Tensor:
    """Jump flood over the seeded region stack ``[5*(rows+PAD), cols]``;
    returns the ``[8, rows*cols]`` attribute planes (see csrc/flood.cu: one
    cooperative launch; its (sy, sx, src) state ping-pongs in a
    ``[2, 3, rows*cols]`` scratch; the stack is only read)."""
    if not _on_cuda(stack):
        return att_flood_plain(stack, search_range, rows, cols, scale)
    return torch.ops.rebvio.att_flood(stack, search_range, rows, cols, scale)


def _launch_att_flood(stack: torch.Tensor, search_range: int, rows: int, cols: int,
                      scale: int) -> torch.Tensor:
    """One launch of csrc/flood.cu over the B lanes of ``stack`` [B,
    5*(rows+PAD), cols]; returns [B, 8, rows*cols]."""
    B = stack.shape[0]
    pad, Rp = flood_layout(rows, search_range)
    _check(stack, f32, (B, 5 * Rp, cols), "att_flood stack")
    steps, n_long, n_short, halo = _flood_args(search_range, pad)
    lib = _build.load()
    n = rows * cols
    state = torch.empty((2, 3, B * n), dtype=f32, device=stack.device)
    out = torch.empty((B, 8, n), dtype=f32, device=stack.device)
    err = lib.rk_att_flood(_ptr(stack), _ptr(state), _ptr(out), B, rows, cols, pad,
                           search_range, float(scale), steps, n_long, n_short, halo,
                           _coop_limit(lib, "rk_att_flood", stack.device), _stream(stack))
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
    # |g| correctly rounded, as the kernel's __fsqrt_rn: the float32 sum's
    # sqrt in float64, then rounded (PyTorch's float32 CPU sqrt is not
    # correctly rounded, nor repeatable between processes)
    out = torch.stack([torch.zeros_like(bd2r), bd2r, idf, gx, gy,
                       torch.sqrt((gx * gx + gy * gy).to(torch.float64)).to(f32),
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


def _at_winner(v: torch.Tensor, winner: torch.Tensor, fill: float) -> torch.Tensor:
    """``v[winner]`` on the cells a keyline won, ``fill`` elsewhere (an
    empty table too)."""
    w = torch.where(winner >= 0, winner.to(torch.int64), v.shape[0])
    return torch.cat([v, v.new_full((1,), fill)])[w]


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
    """Attribute field from the keyline table (csrc/flood.cu's
    att_field_kernel, one cooperative launch: the winner plane, then K1's
    flood over seeds read from the table): ``pos``, ``grad`` [K, 2] and the
    gate ``use`` [K] bool seed the field (largest index wins a shared cell,
    whole row from the winner).  ``search_range``, ``rows``, ``cols`` in
    image units; returns the ``[8, N]`` planes of the ``ceil(rows/scale) x
    ceil(cols/scale)`` field."""
    from rebvio_tpu_torch.ops.distance_field import field_geometry

    if not _on_cuda(pos, grad, use):
        return att_field_plain(pos, grad, use, search_range, rows, cols, scale)
    K = _check_table(pos, grad, use, "att_field")
    frows, fcols, sr = field_geometry(search_range, rows, cols, scale)
    pad, _ = flood_layout(frows, sr)
    steps, n_long, n_short, halo = _flood_args(sr, pad)
    lib = _build.load()
    n = frows * fcols
    scratch = torch.empty((7 * n,), dtype=f32, device=pos.device)   # state, then the winners
    out = torch.empty((8, n), dtype=f32, device=pos.device)
    err = lib.rk_att_field(_ptr(pos), _ptr(grad), _ptr(use), K, 1.0 / scale, _ptr(scratch),
                           _ptr(out), 1, frows, fcols, pad, sr, float(scale), steps, n_long,
                           n_short, halo, _coop_limit(lib, "rk_att_field", pos.device),
                           _stream(pos))
    _raise_on(err, "att_field")
    LAUNCHES["att_field"] += 1
    return out


def seed_stack_plain(pos, grad, use, search_range: int, rows: int, cols: int, scale: int):
    """The flood's ``[5*(frows+PAD), fcols]`` region stack seeded from the
    keyline table: each cell takes the five values (py, px, id, gx, gy) of
    its winner, every other cell the sentinels (BIG, BIG, -1, 0, 0)."""
    from rebvio_tpu_torch.ops.distance_field import field_geometry

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
    from rebvio_tpu_torch.ops.distance_field import field_geometry

    frows, fcols, sr = field_geometry(search_range, rows, cols, scale)
    stack = seed_stack_plain(pos, grad, use, search_range, rows, cols, scale)
    return att_flood_plain(stack, sr, frows, fcols, scale)


# csrc/nn_flood.cu's instantiations: (rows per thread, most threads per CTA)
NN_RT = ((4, 1024), (8, 768), (16, 384), (32, 768))
NN_SMEM_MAX = 232448         # shared memory a block can use on the H100 (227 KB)
NN_CLUSTERS = (16, 8)        # cluster sizes tried, in order (16 is non-portable)
_NN_PLANS = {}               # (rows, cols, K, device index) -> (C, R, T, rt, pos_smem, smem)
NN_PLAN_INFO = {}            # (rows, cols, K) -> the plan and each size's occupancy answer


def nn_cluster_plan(rows: int, cols: int, K: int, C: int):
    """csrc/nn_flood.cu's layout of a ``rows x cols`` field of ``K``
    keylines on one cluster of ``C`` CTAs: (R rows per CTA, the last CTAs
    owning fewer; T threads, H = T / ceil32(cols) to a column; rt rows a
    thread, the kernel's count; pos_smem, whether the keyline table is
    copied into each CTA's shared memory; the dynamic shared memory: two id
    buffers of R*cols int32, two row tables, the table where it fits), or
    None where the ids do not fit.  The most threads that fit win: a pass
    is bound by latency on the cluster's 16 SMs."""
    R = -(-rows // C)
    Tc = -(-cols // 32) * 32
    ids = 8 * R * cols + 8 * rows
    for rt, tmax in NN_RT:
        T = Tc * -(-R // rt)
        if T <= tmax and ids <= NN_SMEM_MAX:
            pos_smem = ids + 8 * K <= NN_SMEM_MAX
            return R, T, rt, pos_smem, ids + 8 * K * pos_smem
    return None


def _nn_plan(lib, rows: int, cols: int, K: int, dev: torch.device):
    """The cluster size and layout for this field on ``dev``: the first of
    NN_CLUSTERS whose plan fits and that cudaOccupancyMaxActiveClusters
    accepts, queried once per shape and device.  Raises where none does."""
    key = (rows, cols, K, dev.index)
    if key not in _NN_PLANS:
        tried = {}
        with torch.cuda.device(dev):
            for C in NN_CLUSTERS:
                plan = nn_cluster_plan(rows, cols, K, C)
                n = lib.rk_nn_cluster_occupancy(C, *plan[1:]) if plan else 0
                if n < 0:
                    raise RuntimeError(f"nn_field: the cluster occupancy query failed with "
                                       f"cudaError {-n}")
                tried[C] = n
                if n >= 1:
                    _NN_PLANS[key] = (C, *plan)
                    NN_PLAN_INFO[key[:3]] = dict(
                        zip(("C", "R", "T", "rt", "pos_smem", "smem"), _NN_PLANS[key]),
                        max_active_clusters=tried)
                    break
        if key not in _NN_PLANS:
            raise ValueError(f"nn_field: the ids of a {rows}x{cols} field ({8 * rows * cols} "
                             f"bytes in two buffers) fit no cluster of {NN_CLUSTERS} CTAs "
                             f"(clusters that can run at once: {tried})")
    return _NN_PLANS[key]


def nn_field(pos, use, search_range: int, rows: int, cols: int) -> torch.Tensor:
    """Nearest-keyline id field (csrc/seed_scatter.cu's winner plane, then
    csrc/nn_flood.cu: one cluster launch whose ids stay in distributed shared
    memory): ``[rows*cols]`` int32 ids, -1 beyond ``search_range``.  ``pos``
    [K, 2], ``search_range``, ``rows`` and ``cols`` are all in field units
    (the caller scales the positions).  A field whose ids do not fit one
    cluster's shared memory raises."""
    if not _on_cuda(pos, use):
        return nn_field_plain(pos, use, search_range, rows, cols)
    _check_table(pos, None, use, "nn_field")
    lib = _build.load()
    K = pos.shape[0]
    plan = _nn_plan(lib, rows, cols, K, pos.device)
    winner = _seed_winner(lib, pos, use, rows, cols, 1.0)
    out = torch.empty((rows * cols,), dtype=i32, device=pos.device)
    err = lib.rk_nn_cluster(_ptr(pos), _ptr(winner), _ptr(out), K, rows, cols,
                            int(search_range), *plan, _stream(pos))
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
    sid = winner.reshape(rows, cols)
    sy = _at_winner(py, winner, BIG).reshape(rows, cols)
    sx = _at_winner(px, winner, BIG).reshape(rows, cols)
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
# K2: the tryVel pass and the LM solve around it


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


def _launch_minimize_vel(name, pos_img, rho, sigma_rho, grad, use_f, residuals, vel, att,
                         g: TryVelGeom, iterations: int):
    """Checks, allocates once and launches csrc/try_vel.cu's cooperative
    kernel over the B lanes of its [B, ...] inputs: 1 + ``iterations`` passes
    from ``residuals`` (None: zeros).  Returns (out [B, 16 + 3*iterations],
    residuals [B, K], match_id_forward [B, K])."""
    B, K = rho.shape
    N = att.shape[-1]
    for t, shape, what in ((pos_img, (B, K, 2), "pos_img"), (rho, (B, K), "rho"),
                           (sigma_rho, (B, K), "sigma_rho"), (grad, (B, K, 2), "grad"),
                           (use_f, (B, K), "use_f"), (residuals, (B, K), "residuals"),
                           (vel, (B, 3), "vel"), (att, (B, 8, N), "att")):
        if t is not None:
            _check(t, f32, shape, f"{name} {what}")
    if iterations < 0 or K < 1:
        raise ValueError(f"{name}: needs iterations >= 0 and at least one keyline")
    lib = _build.load()
    dev = rho.device
    items = B * lib.rk_minimize_vel_blocks(K)
    limit = _coop_limit(lib, "rk_minimize_vel", dev)
    per_block = -(-items // min(items, limit))
    if B > lib.rk_minimize_vel_lanes_max() or per_block > lib.rk_minimize_vel_items_max():
        raise ValueError(f"{name}: {B} lanes of {K} keylines are {items} blocks of work, "
                         f"{per_block} a block over the {limit} that can be co-resident for "
                         f"the grid sync; the kernel takes at most "
                         f"{lib.rk_minimize_vel_items_max()} a block and "
                         f"{lib.rk_minimize_vel_lanes_max()} lanes")
    n_out = 16 + 3 * iterations
    out = torch.empty((B, n_out), dtype=f32, device=dev)
    partials = torch.empty((2 * items * 11,), dtype=f32, device=dev)
    res = torch.empty((B, K), dtype=f32, device=dev)
    mif = torch.empty((B, K), dtype=i32, device=dev)
    err = lib.rk_minimize_vel(
        _ptr(pos_img), _ptr(rho), _ptr(sigma_rho), _ptr(grad), _ptr(use_f),
        _ptr(residuals) if residuals is not None else None, _ptr(vel), _ptr(att), B, K, N,
        g.H, g.W, g.field_scale, g.fm, g.cx, g.cy, g.R, g.rw, g.mthr, iterations,
        _ptr(partials), _ptr(out), _ptr(res), _ptr(mif), limit, _stream(rho))
    _raise_on(err, name)
    LAUNCHES[name] += 1
    return out, res, mif


def try_vel(pos_img, rho, sigma_rho, grad, use_f, residuals, vel, att, g: TryVelGeom):
    """One tryVel pass (csrc/try_vel.cu: the solve's kernel with no LM
    iteration).  Returns (score [], JtJ [3,3], JtF [3], residuals [K],
    match_id_forward [K] int32)."""
    ins = (pos_img, rho, sigma_rho, grad, use_f, residuals, vel, att)
    if not _on_cuda(*ins):
        return try_vel_plain(*ins, g)
    out, res, mif = torch.ops.rebvio.minimize_vel("try_vel", *ins, _floats(g), 0)
    return out[15], out[3:12].view(3, 3), out[12:15], res, mif


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


def minimize_vel(pos_img, rho, sigma_rho, grad, use_f, vel0, att, g: TryVelGeom,
                 iterations: int, debug: bool = False):
    """The Levenberg-Marquardt translation solve (core.cpp:150-189): 1 +
    ``iterations`` tryVel passes from zero residuals with the LM update
    between them, one cooperative launch of csrc/try_vel.cu.  Returns (vel
    [3], JtJ [3,3], JtF [3], score [], residuals [K], match_id_forward [K]
    int32); the last two are those of the LAST pass, accepted or not.  With
    ``debug`` also (gains [iterations], accepts [iterations] bool, trial
    scores [iterations]): each iteration's decision and what it rests on."""
    ins = (pos_img, rho, sigma_rho, grad, use_f, vel0, att)
    if not _on_cuda(*ins):
        return minimize_vel_plain(*ins, g, iterations, debug)
    out, res, mif = torch.ops.rebvio.minimize_vel("minimize_vel", pos_img, rho, sigma_rho,
                                                  grad, use_f, None, vel0, att, _floats(g),
                                                  int(iterations))
    ret = (out[0:3], out[3:12].view(3, 3), out[12:15], out[15], res, mif)
    if debug:
        it = int(iterations)
        ret += (out[16:16 + it], out[16 + it:16 + 2 * it] > 0.5, out[16 + 2 * it:])
    return ret


def minimize_vel_plain(pos_img, rho, sigma_rho, grad, use_f, vel0, att, g: TryVelGeom,
                       iterations: int, debug: bool = False):
    """tracker.minimize_vel's loop over ``try_vel_plain``: each accept
    decision is a select, nothing is read back."""
    from rebvio_tpu_torch.geometry import linalg

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
    return torch.ops.rebvio.tube_match(kl, att, dyn, M2, _floats(g))


def _launch_tube_match(kl, att, dyn, M2, g: TubeGeom) -> torch.Tensor:
    """One launch of csrc/tube_match.cu over the B lanes of kl [B, 13, K],
    att [B, 8, N], dyn [B, 4, K], M2 [B, 2, 2]; returns [B, 12, K]."""
    B, _, K = kl.shape
    N = att.shape[-1]
    _check(kl, f32, (B, len(TUBE_PLANES), K), "tube_match kl")
    _check(att, f32, (B, 8, N), "tube_match att")
    _check(dyn, f32, (B, 4, K), "tube_match dyn")
    _check(M2, f32, (B, 2, 2), "tube_match M2")
    if g.P < 2:
        raise ValueError("tube_match needs at least 2 probes")
    lib = _build.load()
    out = torch.empty((B, len(TUBE_OUT), K), dtype=f32, device=kl.device)
    err = lib.rk_tube_match(_ptr(kl), _ptr(att), _ptr(dyn), _ptr(M2), B, K, N, g.P, g.H, g.W,
                            g.field_scale, g.pum, g.cang_min, g.norm_thr, _ptr(out),
                            _stream(kl))
    _raise_on(err, "tube_match")
    LAUNCHES["tube_match"] += 1
    return out


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


# --------------------------------------------------------------------------
# K5: the depth stage -- regularization + depth EKF, and on the step's path
# with the tube matcher's tail and the failure gate in the same call


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
_MRE_THREADS = 128      # csrc/reg_ekf.cu kThreads: one keyline a thread
_MRE_NAMES = ("rho", "sigma_rho", "grad", "grad_norm", "id_next", "id_prev", "valid",
              "match_id", "pos_img", "match_pos_img", "match_grad", "match_grad_norm", "vel",
              "tube_out", "matches", "match_id_keyframe", "R_tot", "fail_nan")
_MRE_SLOTS = 29         # csrc/reg_ekf.cu N_SLOTS: the 18 inputs above, then the outputs
_REG_SLOTS = 13         # K5 alone's inputs: rho .. vel


@functools.lru_cache(maxsize=None)
def _mre_specs(K: int):
    """(dtype, shape) of each of _MRE_NAMES at K keylines."""
    f, f2, i = (f32, (K,)), (f32, (K, 2)), (i32, (K,))
    return (f, f, f2, f, i, i, (torch.bool, (K,)), i, f2, f2, f2, f, (f32, (3,)),
            (f32, (12, K)), i, i, (f32, (3, 3)), (torch.bool, ()))


def _check_mre(ts, specs, name: str):
    """One pass over the inputs; the per-tensor messages only on a mismatch."""
    if tuple((t.dtype, t.shape) for t in ts) == specs and all(t.is_contiguous() for t in ts):
        return
    for t, (dtype, shape), what in zip(ts, specs, _MRE_NAMES):
        _check(t, dtype, shape, f"{name} {what}")


def reg_ekf(rho, sigma_rho, grad, grad_norm, id_next, id_prev, valid, match_id,
            pos_img, match_pos_img, match_grad, match_grad_norm, vel, p: RegEkfParams):
    """regularize_1iter then the inverse-depth EKF.  Returns (rho,
    sigma_rho).  On the card one launch of csrc/reg_ekf.cu's reg_ekf_alone
    (its inputs are the first _REG_SLOTS of the fused stage's)."""
    ins = (rho, sigma_rho, grad, grad_norm, id_next, id_prev, valid, match_id,
           pos_img, match_pos_img, match_grad, match_grad_norm, vel)
    if not _on_cuda(*ins):
        return reg_ekf_plain(*ins, p)
    out = torch.ops.rebvio.reg_ekf(list(ins), _floats(p))
    return out[0], out[1]


def _launch_reg_ekf(ins, p: RegEkfParams) -> torch.Tensor:
    """One launch of csrc/reg_ekf.cu's reg_ekf_alone over the B lanes of its
    [B, ...] inputs (the first _REG_SLOTS of _MRE_NAMES).  Returns [B, 2, K]
    float32: rho, sigma_rho."""
    B, K = ins[0].shape
    _check_mre(ins, tuple((dt, (B,) + shape) for dt, shape in _mre_specs(K)[:_REG_SLOTS]),
               "reg_ekf")
    out = torch.empty((B, 2, K), dtype=f32, device=ins[0].device)
    ts = tuple(ins) + (out[:, 0], out[:, 1])
    ptrs = (ctypes.c_void_p * len(ts))(*[t.data_ptr() for t in ts])
    strides = (ctypes.c_longlong * len(ts))(*[t.stride(0) * t.element_size() for t in ts])
    err = _build.load().rk_reg_ekf(ptrs, strides, B, K, p.threshold, p.q_abs2, p.pu2, p.fm,
                                   _stream(ins[0]))
    _raise_on(err, "reg_ekf")
    LAUNCHES["reg_ekf_alone"] += 1
    return out


def match_reg_ekf(tube_out, rho, sigma_rho, grad, grad_norm, id_next, id_prev, valid, match_id,
                  matches, match_id_keyframe, pos_img, match_pos_img, match_grad,
                  match_grad_norm, vel, R_tot, fail_nan, p: MatchRegEkfParams):
    """The step's depth stage as csrc/reg_ekf.cu (one call, two launches:
    the count, then the rest):
    K4's winners (``tube_out`` [12, K], TUBE_OUT) written into the new map's
    planes, the found count klm, the gate (``fail_nan`` [] bool on the
    device: the unmatched map and klm 0; failed = fail_nan or klm <
    min_matches), then regularization and the depth EKF on the matched map
    where not failed.  ``R_tot`` [3, 3] takes the winner's seed to the new
    frame.  Returns (the MATCH_PLANES, klm [] int32, failed [] bool), all on
    the device: nothing is read back."""
    ins = (rho, sigma_rho, grad, grad_norm, id_next, id_prev, valid, match_id, pos_img,
           match_pos_img, match_grad, match_grad_norm, vel, tube_out, matches,
           match_id_keyframe, R_tot, fail_nan)
    if not _on_cuda(*ins):
        return match_reg_ekf_plain(tube_out, rho, sigma_rho, grad, grad_norm, id_next, id_prev,
                                   valid, match_id, matches, match_id_keyframe, pos_img,
                                   match_pos_img, match_grad, match_grad_norm, vel, R_tot,
                                   fail_nan, p)
    K = rho.shape[0]
    fo, io, failed = torch.ops.rebvio.match_reg_ekf(list(ins), _floats(p))
    rho_o, sr_o, mgn_o = fo[:K], fo[K:2 * K], fo[2 * K:3 * K]
    mpos_o, mgrad_o = fo[3 * K:5 * K].view(K, 2), fo[5 * K:].view(K, 2)
    mid_o, matches_o, mkf_o, klm = io[:K], io[K:2 * K], io[2 * K:3 * K], io[3 * K]
    return rho_o, sr_o, mid_o, matches_o, mpos_o, mgrad_o, mgn_o, mkf_o, klm, failed


def _launch_match_reg_ekf(ins, p: MatchRegEkfParams):
    """One call of csrc/reg_ekf.cu (two launches) over the B lanes of its
    [B, ...] inputs (_MRE_NAMES).  Returns (fo [B, 7K] float32: rho,
    sigma_rho, match_grad_norm, match_pos_img, match_grad; io [B, 3K + 1 +
    blocks] int32: match_id, matches, keyframe id, klm, then the count's
    partials; failed [B] bool)."""
    B, K = ins[0].shape
    _check_mre(ins, tuple((dt, (B,) + shape) for dt, shape in _mre_specs(K)), "match_reg_ekf")
    dev = ins[0].device
    fo = torch.empty((B, 7 * K), dtype=f32, device=dev)
    io = torch.empty((B, 3 * K + 1 + -(-K // _MRE_THREADS)), dtype=i32, device=dev)
    failed = torch.empty((B,), dtype=torch.bool, device=dev)
    outs = (fo[:, :K], fo[:, K:2 * K], io[:, :K], io[:, K:2 * K], fo[:, 3 * K:5 * K],
            fo[:, 5 * K:], fo[:, 2 * K:3 * K], io[:, 2 * K:3 * K], io[:, 3 * K], failed,
            io[:, 3 * K + 1:])
    ts = tuple(ins) + outs
    ptrs = (ctypes.c_void_p * _MRE_SLOTS)(*[t.data_ptr() for t in ts])
    strides = (ctypes.c_longlong * _MRE_SLOTS)(*[t.stride(0) * t.element_size() for t in ts])
    err = _build.load().rk_match_reg_ekf(ptrs, strides, B, K, p.min_matches, p.threshold,
                                         p.q_abs2, p.pu2, p.fm, p.cx, p.cy, _stream(ins[0]))
    _raise_on(err, "match_reg_ekf")
    LAUNCHES["reg_ekf"] += 1
    return fo, io, failed


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
    return torch.ops.rebvio.estimate_bias(*ins, int(iters))


_SAB_SHAPES = (("a_s", (3,)), ("a_v", (3,)), ("x_p", (7,)), ("W_rest", (8, 11)),
               ("Rs", (3, 3)), ("Rv", (3, 3)), ("Wvw", (6, 6)), ("Xvw", (6,)), ("g_gravit", ()))


def _launch_estimate_bias(ins, iters: int):
    """One launch of csrc/sab.cu over the B lanes of its [B, ...] inputs
    (_SAB_SHAPES).  Returns (K [B], X [B, 7], P [B, 7, 7], Xvw [B, 6])."""
    B = ins[0].shape[0]
    for t, (name, shape) in zip(ins, _SAB_SHAPES):
        _check(t, f32, (B,) + shape, "estimate_bias " + name)
    lib = _build.load()
    dev = ins[0].device
    K = torch.empty((B,), dtype=f32, device=dev)
    X = torch.empty((B, 7), dtype=f32, device=dev)
    P = torch.empty((B, 7, 7), dtype=f32, device=dev)
    Xc = torch.empty((B, 6), dtype=f32, device=dev)
    err = lib.rk_estimate_bias(*(_ptr(t) for t in ins), int(iters), _ptr(K), _ptr(X),
                               _ptr(P), _ptr(Xc), B, _stream(ins[0]))
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
    M6 = torch.cat([Wvw[:3], torch.cat([Wvw[3:, :3], WVBias + Wvw[3:, 3:]], dim=1)])
    wc = Xvw[3:6] - Xc[4:7]
    rhs = Wvw @ Xvw + torch.cat([torch.zeros(3, **z), WVBias @ wc])
    return k, Xc, P, gj_inverse_mosaic(M6) @ rhs


# --------------------------------------------------------------------------
# The frontend's band-operator products (ops/scale_space.py::mxu_dot)

BAND_TILE_LINES = 32    # csrc/band_matmul.cu kLines: the band lines a block takes
BAND_MAX_SPLITS = 8     # the most partial sums band_library_splits tries


class Band(NamedTuple):
    """The band of a band operator (ops/scale_space.py builds it from the
    float32 matrix).  A line is an output row of ``L @ X`` (``left``) or an
    output column of ``X @ R``; ``k0`` [lines] int32 is its first k,
    ``coef`` [lines, taps] float32 the matrix's entries at k0 .. k0 + taps - 1
    (zeros inside the band kept), ``tiles`` [n, 3] int32 the blocks' runs of
    lines (band_tiles), ``left``, ``depth`` the matrix's k extent, ``splits``
    [1] int32 the partial sums an output is summed in (band_library_splits;
    1 off the card)."""
    k0: torch.Tensor
    coef: torch.Tensor
    tiles: torch.Tensor
    left: bool
    depth: int
    splits: torch.Tensor


def band_tiles(k0, taps: int) -> list:
    """csrc/band_matmul.cu's blocks: the lines cut, in order, into runs of at
    most BAND_TILE_LINES whose k ranges (k0 .. k0 + taps) span at most
    BAND_TILE_LINES + taps - 1, the rows a block stages.  A run ends early
    where one more line would pass that span, as where the stacked cascades'
    second half starts again at k = 0.  Returns [(first line, lines, first k
    staged), ...]."""
    cap = BAND_TILE_LINES + taps - 1
    tiles, first = [], 0
    while first < len(k0):
        lo, hi, end = int(k0[first]), int(k0[first]) + taps, first + 1
        while end < len(k0) and end - first < BAND_TILE_LINES:
            lo2, hi2 = min(lo, int(k0[end])), max(hi, int(k0[end]) + taps)
            if hi2 - lo2 > cap:
                break
            lo, hi, end = lo2, hi2, end + 1
        tiles.append((first, end - first, lo))
        first = end
    return tiles


def band_library_splits(dense: torch.Tensor, band: Band, shape) -> torch.Tensor:
    """[1] int32 on ``dense``'s device: the least S of 1 .. BAND_MAX_SPLITS
    for which csrc/band_matmul.cu's result equals the library's dense
    product bit for bit on a random operand of ``shape`` (the product's
    own); 1 where none does.  The library's SGEMM picks its split of k by
    the shape and strides, so this is read once a product, at set-up; it
    reads nothing back to the host and counts no launch."""
    dev = dense.device
    x = torch.randn(shape, generator=torch.Generator(device=dev).manual_seed(0), device=dev)
    want = dense @ x if band.left else x @ dense
    found = torch.ones((1,), dtype=i32, device=dev)
    for s in range(BAND_MAX_SPLITS, 0, -1):
        trial = torch.full((1,), s, dtype=i32, device=dev)
        got = _launch_band_matmul(x[None], band.k0, band.coef, band.tiles, trial, band.left,
                                  count=False)[0]
        found = torch.where((got == want).all(), trial, found)
    return found


def band_matmul(x: torch.Tensor, dense: torch.Tensor, band: Band) -> torch.Tensor:
    """``dense @ x`` for a left band operator, ``x @ dense`` for a right one
    (``band``: the band of ``dense``).  On the card one launch of
    csrc/band_matmul.cu that visits only the band, in the library's
    summation order for the product (band_library_splits); on the CPU the
    dense product (band_matmul_plain)."""
    if x.ndim != 2 or x.shape[-2 if band.left else -1] != band.depth:
        raise ValueError(f"band_matmul: x {tuple(x.shape)} does not meet a "
                         f"{'left' if band.left else 'right'} operator of depth {band.depth}")
    if not _on_cuda(x, band.coef):
        return band_matmul_plain(x, dense, band.left)
    return torch.ops.rebvio.band_matmul(x, band.k0, band.coef, band.tiles, band.splits,
                                        band.left)


def band_matmul_plain(x: torch.Tensor, dense: torch.Tensor, left: bool) -> torch.Tensor:
    """The dense product, one a lane under vmap (linalg.lane_matmul)."""
    from rebvio_tpu_torch.geometry.linalg import lane_matmul

    return lane_matmul(dense, x) if left else lane_matmul(x, dense)


def _launch_band_matmul(x, k0, coef, tiles, splits, left: bool, count: bool = True):
    """One launch of csrc/band_matmul.cu over the B lanes of ``x``, [B, K, Q]
    for a left operator or [B, Q, K] for a right one, each lane row-major
    (any lane stride: a slice of rows needs no copy); returns [B, lines, Q]
    or [B, Q, lines].  ``count``: add it to LAUNCHES."""
    if x.dtype != f32 or x.ndim != 3:
        raise ValueError(f"band_matmul: expected float32 [B, ., .] lanes, got {x.dtype} "
                         f"{tuple(x.shape)}")
    if x.stride(2) != 1 or x.stride(1) != x.shape[2]:
        x = x.contiguous()
    B = x.shape[0]
    lines, taps = coef.shape
    K, Q = (x.shape[1], x.shape[2]) if left else (x.shape[2], x.shape[1])
    _check(k0, i32, (lines,), "band_matmul k0")
    _check(coef, f32, (lines, taps), "band_matmul coef")
    _check(tiles, i32, (tiles.shape[0], 3), "band_matmul tiles")
    _check(splits, i32, (1,), "band_matmul splits")
    out = torch.empty((B, lines, Q) if left else (B, Q, lines), dtype=f32, device=x.device)
    err = _build.load().rk_band_matmul(_ptr(x), x.stride(0), _ptr(k0), _ptr(coef), _ptr(tiles),
                                       tiles.shape[0], _ptr(splits), _ptr(out), B, K, Q, lines,
                                       taps, int(left), _stream(x))
    _raise_on(err, "band_matmul")
    if count:
        LAUNCHES["band_matmul"] += 1
    return out


# --------------------------------------------------------------------------
# The step's kernels as PyTorch operators.  The unbatched call launches one
# lane; the vmap rule launches once over every lane of a torch.func.vmap
# (parallel/batch.py), with the lane axis first and contiguous.


def _lanes(info, in_dims, args):
    """``args`` as [B, ...] lanes: a vmapped tensor with its lane axis moved
    first, an unbatched one expanded to B lanes, both contiguous; None and
    non-tensors pass.  Raises on a tensor that is not on the card: the
    rule never falls back to a plain version or a loop over lanes."""
    out = []
    for a, d in zip(args, in_dims):
        if torch.is_tensor(a):
            if not _on_cuda(a):
                raise ValueError("rebvio kernels under vmap take CUDA tensors; CPU tensors "
                                 "go to the plain versions")
            a = a.movedim(d, 0) if d is not None else a.expand(info.batch_size, *a.shape)
            a = a.contiguous()
        out.append(a)
    return out


@custom_op("rebvio::att_flood", mutates_args=())
def _att_flood_op(stack: torch.Tensor, search_range: int, rows: int, cols: int,
                  scale: int) -> torch.Tensor:
    return _launch_att_flood(stack.contiguous()[None], search_range, rows, cols, scale)[0]


@_att_flood_op.register_vmap
def _att_flood_lanes(info, in_dims, stack, search_range, rows, cols, scale):
    (stack,) = _lanes(info, in_dims[:1], (stack,))
    return _launch_att_flood(stack, search_range, rows, cols, scale), 0


def _try_vel_geom(g: List[float]) -> TryVelGeom:
    return TryVelGeom(int(g[0]), int(g[1]), int(g[2]), *g[3:])


@custom_op("rebvio::minimize_vel", mutates_args=())
def _minimize_vel_op(name: str, pos_img: torch.Tensor, rho: torch.Tensor,
                     sigma_rho: torch.Tensor, grad: torch.Tensor, use_f: torch.Tensor,
                     residuals: Optional[torch.Tensor], vel: torch.Tensor, att: torch.Tensor,
                     g: List[float], iterations: int
                     ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    ins = [None if t is None else t[None] for t in (pos_img, rho, sigma_rho, grad, use_f,
                                                    residuals, vel, att)]
    out, res, mif = _launch_minimize_vel(name, *ins, _try_vel_geom(g), iterations)
    return out[0], res[0], mif[0]


@_minimize_vel_op.register_vmap
def _minimize_vel_lanes(info, in_dims, name, *args):
    ins = _lanes(info, in_dims[1:9], args[:8])
    g, iterations = args[8:]
    return _launch_minimize_vel(name, *ins, _try_vel_geom(g), iterations), (0, 0, 0)


def _tube_geom(g: List[float]) -> TubeGeom:
    return TubeGeom(int(g[0]), int(g[1]), int(g[2]), int(g[3]), *g[4:])


@custom_op("rebvio::tube_match", mutates_args=())
def _tube_match_op(kl: torch.Tensor, att: torch.Tensor, dyn: torch.Tensor, M2: torch.Tensor,
                   g: List[float]) -> torch.Tensor:
    ins = [t.contiguous()[None] for t in (kl, att, dyn, M2)]
    return _launch_tube_match(*ins, _tube_geom(g))[0]


@_tube_match_op.register_vmap
def _tube_match_lanes(info, in_dims, kl, att, dyn, M2, g):
    ins = _lanes(info, in_dims[:4], (kl, att, dyn, M2))
    return _launch_tube_match(*ins, _tube_geom(g)), 0


def _mre_params(p: List[float]) -> MatchRegEkfParams:
    return MatchRegEkfParams(*p[:6], min_matches=int(p[6]))


@custom_op("rebvio::match_reg_ekf", mutates_args=())
def _match_reg_ekf_op(ins: List[torch.Tensor], p: List[float]
                      ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    fo, io, failed = _launch_match_reg_ekf([t[None] for t in ins], _mre_params(p))
    return fo[0], io[0], failed[0]


@_match_reg_ekf_op.register_vmap
def _match_reg_ekf_lanes(info, in_dims, ins, p):
    return _launch_match_reg_ekf(_lanes(info, in_dims[0], ins), _mre_params(p)), (0, 0, 0)


@custom_op("rebvio::reg_ekf", mutates_args=())
def _reg_ekf_op(ins: List[torch.Tensor], p: List[float]) -> torch.Tensor:
    return _launch_reg_ekf([t[None] for t in ins], RegEkfParams(*p))[0]


@_reg_ekf_op.register_vmap
def _reg_ekf_lanes(info, in_dims, ins, p):
    return _launch_reg_ekf(_lanes(info, in_dims[0], ins), RegEkfParams(*p)), 0


@custom_op("rebvio::estimate_bias", mutates_args=())
def _estimate_bias_op(a_s: torch.Tensor, a_v: torch.Tensor, x_p: torch.Tensor,
                      W_rest: torch.Tensor, Rs: torch.Tensor, Rv: torch.Tensor,
                      Wvw: torch.Tensor, Xvw: torch.Tensor, g_gravit: torch.Tensor, iters: int
                      ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    ins = [t.contiguous()[None] for t in (a_s, a_v, x_p, W_rest, Rs, Rv, Wvw, Xvw, g_gravit)]
    return tuple(t[0] for t in _launch_estimate_bias(ins, iters))


@_estimate_bias_op.register_vmap
def _estimate_bias_lanes(info, in_dims, *args):
    ins = _lanes(info, in_dims[:9], args[:9])
    return _launch_estimate_bias(ins, args[9]), (0, 0, 0, 0)


@custom_op("rebvio::chol_inverse", mutates_args=())
def _chol_inverse_op(m: torch.Tensor) -> torch.Tensor:
    return _launch_chol_inverse(m)


@_chol_inverse_op.register_vmap
def _chol_inverse_lanes(info, in_dims, m):
    (m,) = _lanes(info, in_dims, (m,))
    return _launch_chol_inverse(m), 0


def _launch_chol_inverse(m: torch.Tensor) -> torch.Tensor:
    """One launch of csrc/chol_inverse.cu over the ``[..., n, n]`` batch
    (one thread a matrix): the lanes of a vmap are more leading dims."""
    n = m.shape[-1]
    if m.dtype != f32 or m.ndim < 2 or m.shape[-2] != n or not 1 <= n <= 8:
        raise ValueError(f"chol_inverse: expected float32 [..., n, n] with n <= 8, got "
                         f"{m.dtype} {tuple(m.shape)}")
    a = m.detach().contiguous()
    out = torch.empty_like(a)
    err = _build.load().rk_chol_inverse(_ptr(a), _ptr(out), n, a.numel() // (n * n),
                                        _stream(a))
    _raise_on(err, "chol_inverse")
    LAUNCHES["chol_inverse"] += 1
    return out


@custom_op("rebvio::band_matmul", mutates_args=())
def _band_matmul_op(x: torch.Tensor, k0: torch.Tensor, coef: torch.Tensor,
                    tiles: torch.Tensor, splits: torch.Tensor, left: bool) -> torch.Tensor:
    return _launch_band_matmul(x[None], k0, coef, tiles, splits, left)[0]


@_band_matmul_op.register_vmap
def _band_matmul_lanes(info, in_dims, x, k0, coef, tiles, splits, left):
    """The lanes are ``x``'s; the band is one operator for every lane and is
    read by each lane in place (not expanded to B copies)."""
    if any(d is not None for d in in_dims[1:5]):
        raise ValueError("band_matmul: the band operator must be the same for every lane")
    if not _on_cuda(x):
        raise ValueError("rebvio kernels under vmap take CUDA tensors; CPU tensors go to the "
                         "plain versions")
    return _launch_band_matmul(x.movedim(in_dims[0], 0), k0, coef, tiles, splits, left), 0
