"""JtJ-kernel roofline report (BASELINE.json's "JtJ kernel % of roofline"),
the port of the JAX package's tools/roofline.py.

    python -m rebvio_tpu_torch.tools.roofline [--stages]

The tracker's single pass (kernel K2, ``kernels.try_vel``) is bound by the
latency of its data-dependent gathers, not by operations or bytes: per
keyline it projects, gathers the attribute field at the projected cell and
sums a 3x3 Gram.  ``measure`` times dependent chains, each captured as one
CUDA graph and replayed, and counts each graph's nodes:

  * the pass chain: 128 links, each one K2 pass (``kernels.try_vel``, its
    participation mask computed once before the chain) and one operation
    that takes the next velocity from the pass's score (the dependency of
    the LM loop);
  * the gather chain: 128 links, each ONE kernel: a gather of K rows of 8
    int32 (32 bytes a row, as the field's [K, 8] float32 rows) from a table
    whose gathered values are the next link's indices
    (``torch.index_select`` on the flattened table, the rows in a seeded
    random order): the latency of a bare dependent row gather, the least
    time any algorithm with the pass's access pattern takes a link;

and reports µs a pass, µs a link and their ratio ``gather_ceiling_fraction``
(BASELINE.json's metric, ``jtj_roofline_fraction`` in the bench): the
ceiling of a single dependent gather over the pass, 1.0 when the pass costs
no more than its gather.  Nothing is clamped: above 1 the chain is slower
than the pass, which says a count is wrong.  The JAX tool's gather link
(index, add, cast, remainder, sum) was one fused operation under XLA; in
PyTorch it would be six kernels, so the link here is built to be one.

``measure_stages`` (``--stages``): the detector against the chain of its
own band-matrix products at their shapes; the attribute field (the
scatter-seeded route, kernel K1b, as the JAX tool times it) against one
read and one write of its planes at the measured copy bandwidth; the tube
matcher against its gather volume at the row-gather throughput of one
``torch.index_select`` kernel of K*P rows a link (each link one kernel).
Beside each fraction, the bound PERF.md's kernel table uses: bytes over
3.35 TB/s or float32 operations over 67 TFLOP/s (``bound_ms``): the band
products' operations, and the byte and operation counts of K1b and K4 at
the parity shapes (``kernel_bounds``, which also has K1's and K2's single
pass).  Needs a GPU.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from rebvio_tpu_torch import resolve_device
from rebvio_tpu_torch import types as T
from rebvio_tpu_torch.configs import PipelineConfig
from rebvio_tpu_torch.ops import distance_field as DF
from rebvio_tpu_torch.ops import edge_detect, kernels, matching, tracker
from rebvio_tpu_torch.graph import CapturedGraph

CHAIN = 128             # links of the pass and gather chains
STAGE_CHAIN = 32        # links of the stage chains
HBM_BYTES_PER_S = 3.35e12   # H100 SXM memory rate
F32_FLOP_PER_S = 67e12      # H100 SXM float32 peak outside the tensor cores


def bound_ms(nbytes: float, flops: float):
    """(ms, "bytes" or "operations"): the larger of the bytes over the
    memory rate and the float32 operations over the peak rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def att_flood_counts(config: PipelineConfig):
    """(bytes, operations) of one K1 flood: the seed stack read once, the 8
    planes written once; 8 candidates a cell a step, 7 operations each, and
    4 a cell to finish."""
    cam = config.camera
    frows, fcols, sr = DF.field_geometry(config.core.search_range_px, cam.rows, cam.cols,
                                         config.field_scale)
    n = frows * fcols
    stack = 5 * (frows + DF.flood_pad(sr)) * fcols
    return stack * 4 + 8 * n * 4, len(DF.flood_steps(sr)) * 8 * 7 * n + 4 * n


def try_vel_counts(K: int):
    """(bytes, operations) of one K2 pass over K keylines: per keyline the
    position, gradient, depth, mask and residual planes and 6 gathered field
    values read, the residual and forward id written; ~75 operations."""
    return K * (8 * 4 + 6 * 4 + 8) + 12 + 68, K * 75


def tube_match_counts(K: int, P: int):
    """(bytes, operations) of one K4 call: the 13 keyline planes read, 10
    gathered values a probe, the [12, K] output written; ~55 operations a
    probe."""
    return K * 13 * 4 + P * K * 10 * 4 + 16 + 12 * K * 4, P * K * 55


def att_field_counts(config: PipelineConfig):
    """(bytes, operations) of one K1b call: the keyline table (positions,
    gradients, the gate byte) read once, the 8 planes written once; the
    flood's operations as K1's without the stack, plus the seeding's 6 a
    keyline."""
    cam = config.camera
    frows, fcols, sr = DF.field_geometry(config.core.search_range_px, cam.rows, cam.cols,
                                         config.field_scale)
    n, K = frows * fcols, config.detector.keylines_max
    return K * 17 + 8 * n * 4, len(DF.flood_steps(sr)) * 8 * 7 * n + 4 * n + 6 * K


def kernel_bounds(config: PipelineConfig) -> dict:
    """name -> (bound ms, bound by) of K1, K1b, K2's single pass and K4 at
    ``config``'s shapes."""
    K, P = config.detector.keylines_max, config.edge_map.tube_probes
    return {"att_flood": bound_ms(*att_flood_counts(config)),
            "att_field": bound_ms(*att_field_counts(config)),
            "try_vel": bound_ms(*try_vel_counts(K)),
            "tube_match": bound_ms(*tube_match_counts(K, P))}


def _warm_state(config: PipelineConfig, dev, n_warm: int = 6):
    """A realistic state: ``n_warm`` steps over synthetic seed 0, and the
    next frame.  Returns (state, frame, mats)."""
    from rebvio_tpu_torch.bench import chunk_inputs, sequence
    from rebvio_tpu_torch.pipeline import frontend_matrices, step

    mats = frontend_matrices(config, dev)
    frames, imu, dts = chunk_inputs(config, n_warm + 1, sequence(config.camera, 8), dev)
    state = T.init_vio_state(config, dev)
    for i in range(n_warm):
        state, _odo = step(state, frames[i], T.tree_map(lambda x: x[i], imu), dts[i], config,
                           mats)
    torch.cuda.synchronize()
    return state, frames[n_warm], mats


def _floor_s(x: torch.Tensor) -> float:
    """One replay of a graph of one small reduction: the replay floor."""
    return CapturedGraph(lambda: x.reshape(-1)[:8].sum()).seconds(n=10)


def copy_bandwidth(dev) -> float:
    """Bytes/s of a dense elementwise pass (one read, one write) over 64 MiB,
    a chain of 16 in one graph."""
    nbig = 1 << 24
    a = torch.arange(nbig, dtype=torch.float32, device=dev)
    b = torch.empty_like(a)

    def chain():
        for _ in range(8):
            torch.mul(a, 1.0000001, out=b)
            torch.mul(b, 1.0000001, out=a)
        return a

    t = CapturedGraph(chain).seconds(n=5) / 16
    return 2 * nbig * 4 / t


def gather_table(rows: int, seed: int, dev) -> torch.Tensor:
    """[rows * 8] int32: the flattened [rows, 8] table of a dependent row
    gather.  Element j of row r holds element j of row next(r), ``next`` a
    seeded random permutation, so gathering K rows' elements gives the
    next link's indices."""
    nxt = torch.as_tensor(np.random.default_rng(seed).permutation(rows).astype(np.int32))
    table = nxt[:, None] * 8 + torch.arange(8, dtype=torch.int32)[None, :]
    return table.reshape(-1).to(dev)


def row_indices(rows: int, k: int, seed: int, dev) -> torch.Tensor:
    """[k * 8] int32: the elements of ``k`` seeded random rows of a [rows,
    8] table, row by row."""
    r = torch.as_tensor(np.random.default_rng(seed).integers(0, rows, k).astype(np.int32))
    return (r[:, None] * 8 + torch.arange(8, dtype=torch.int32)[None, :]).reshape(-1).to(dev)


def measure(device="cuda") -> dict:
    """The pass chain against the gather chain at the parity profile;
    returns the metrics (µs a pass, µs a link, their ratio, each graph's
    nodes a link)."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise RuntimeError("roofline.measure times CUDA graphs: it needs a GPU")
    config = PipelineConfig()
    cam, core_cfg = config.camera, config.core
    K = config.detector.keylines_max
    copy_bw = copy_bandwidth(dev)
    state, frame, mats = _warm_state(config, dev)
    from rebvio_tpu_torch.pipeline import detect_map

    new_map = detect_map(frame, state.detector_threshold, mats, config)
    att = new_map.att_img.contiguous()
    old_map = state.edge_map
    vel0 = torch.tensor([0.01, 0.0, 0.02], dtype=torch.float32, device=dev)
    res0 = torch.zeros((K,), dtype=torch.float32, device=dev)
    t_floor = _floor_s(old_map.rho)

    # the pass's inputs as tracker.try_vel hands them to the kernel
    geom = tracker._try_vel_geom(cam.rows, cam.cols, config.field_scale, core_cfg, cam)
    ins = (old_map.pos_img.contiguous(), old_map.rho, old_map.sigma_rho,
           old_map.grad.contiguous(), tracker._use_mask(old_map, 10.0), res0)

    def pass_chain():
        v = vel0
        for _ in range(CHAIN):
            score, _JtJ, _JtF, _res, _mif = kernels.try_vel(*ins, v, att, geom)
            v = torch.addcmul(v, v, score, value=1e-12)     # the next velocity
        return v

    g_pass = CapturedGraph(pass_chain, keep_graph=True)
    pass_us = (g_pass.seconds(n=10) - t_floor) / CHAIN * 1e6

    nf = att.shape[1]                       # the field's cells: rows of the table
    table = gather_table(nf, 0, dev)
    idx0 = row_indices(nf, K, 0, dev)

    def gather_chain():
        idx = idx0
        for _ in range(CHAIN):
            idx = torch.index_select(table, 0, idx)          # [K, 8] rows, one kernel
        return idx

    g_gather = CapturedGraph(gather_chain, keep_graph=True)
    gather_us = (g_gather.seconds(n=10) - t_floor) / CHAIN * 1e6
    n_pass, n_gather = g_pass.nodes(), g_gather.nodes()
    if n_gather is not None and n_gather != CHAIN:
        raise RuntimeError(f"the gather chain has {n_gather} graph nodes, not one a link")
    flops = K * (80 + 32)
    b_ms, b_by = kernel_bounds(config)["try_vel"]
    return {
        "keylines_max": K,
        "field_scale": config.field_scale,
        "copy_bw_gbs": copy_bw / 1e9,
        "dispatch_floor_us": t_floor * 1e6,
        "try_vel_pass_us": pass_us,
        "gather_chain_us": gather_us,
        "gather_ceiling_fraction": gather_us / pass_us,
        "pass_chain_nodes_per_link": None if n_pass is None else n_pass / CHAIN,
        "gather_chain_nodes_per_link": None if n_gather is None else n_gather / CHAIN,
        "tflops": flops / (pass_us * 1e-6) / 1e12,
        "try_vel_bound_us": b_ms * 1e3,
        "try_vel_bound_by": b_by,
    }


def measure_stages(device="cuda") -> dict:
    """The stage ceilings at the parity profile (fractions = ceiling /
    measured; 1.0 at the ceiling), each chain one CUDA graph of
    STAGE_CHAIN dependent links."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise RuntimeError("roofline.measure_stages times CUDA graphs: it needs a GPU")
    config = PipelineConfig()
    cam, core_cfg = config.camera, config.core
    H, W = cam.rows, cam.cols
    K, P = config.detector.keylines_max, config.edge_map.tube_probes
    CH = STAGE_CHAIN
    state, img, mats = _warm_state(config, dev)
    thr = state.detector_threshold
    t_floor = _floor_s(img)
    z = dict(dtype=torch.float32, device=dev)

    def detect_chain():
        t, acc = thr, torch.zeros((), **z)
        for _ in range(CH):
            m = edge_detect.detect(img, t, mats, config.detector, cam,
                                   field_scale=config.field_scale)
            s = m.grad_norm.sum()
            t, acc = t * (1.0 + 1e-12 * s), acc + s
        return acc + t

    t_detect = (CapturedGraph(detect_chain).seconds(n=3) - t_floor) / CH

    # the frontend's band products at their shapes: 4 per link, 8 a detection
    LL, R = mats.LL, mats.R0

    def mm_chain():
        x = img
        for _ in range(CH):
            y = torch.matmul(torch.matmul(LL, x)[:H], R)
            y = torch.matmul(torch.matmul(LL, y)[:H], R)
            x = y * (1.0 / 1e6)
        return x.sum()

    t_mm = (CapturedGraph(mm_chain).seconds(n=3) - t_floor) / CH * 2.0
    mm_flops = 4 * (2 * (2 * H) * H * W + 2 * H * W * W)

    new_map = edge_detect.detect(img, thr, mats, config.detector, cam,
                                 field_scale=config.field_scale)

    def att_chain():
        g, acc = torch.zeros((), **z), torch.zeros((), **z)
        for _ in range(CH):
            att = DF.build_att_field(new_map.replace(grad_norm=new_map.grad_norm + 1e-12 * g),
                                     core_cfg.search_range_px, H, W, config.field_scale)
            g = att[DF.ATT_ID].sum()
            acc = acc + g
        return acc

    t_att = (CapturedGraph(att_chain).seconds(n=3) - t_floor) / CH
    frows, fcols, _sr = DF.field_geometry(core_cfg.search_range_px, H, W, config.field_scale)
    n_field = frows * fcols
    copy_bw = copy_bandwidth(dev)
    jfa_bytes = (5 + 8) * n_field * 4 * 2
    jfa_floor = jfa_bytes / copy_bw

    att = DF.build_att_field(new_map, core_cfg.search_range_px, H, W, config.field_scale)
    old_map = state.edge_map.replace(att_img=att)
    vel = torch.tensor([0.01, 0.0, 0.02], **z)
    Rvel = torch.eye(3, **z) * 1e-5
    Rback = torch.eye(3, **z)

    def tube_chain():
        v, acc = vel, torch.zeros((), **z)
        for _ in range(CH):
            _m2, klm = matching.directed_match_tube(new_map, old_map, v, Rvel, Rback,
                                                    config.edge_map, core_cfg, cam,
                                                    field_scale=config.field_scale)
            s = klm.to(torch.float32)
            v, acc = v * (1.0 + 1e-12 * s), acc + s
        return acc + v.sum()

    t_tube = (CapturedGraph(tube_chain).seconds(n=3) - t_floor) / CH

    # row-gather throughput: K*P seeded random rows of the field's [N, 8]
    # rows a link, one kernel (torch.index_select of the rows' elements from
    # the flattened table, into the same output; the [N, 8] form,
    # index_select along dim 0, runs ~15x slower on the card), repeated
    M = K * P
    rows = att.T.contiguous().reshape(-1)
    gidx = row_indices(att.shape[1], M, 1, dev)
    gathered = torch.empty((M * 8,), **z)

    def big_gather():
        for _ in range(CH):
            torch.index_select(rows, 0, gidx, out=gathered)
        return gathered

    g_big = CapturedGraph(big_gather, keep_graph=True)
    t_bg = (g_big.seconds(n=3) - t_floor) / CH
    gather_bw = M * 8 * 4 / t_bg
    n_big = g_big.nodes()
    if n_big is not None and n_big != CH:
        raise RuntimeError(f"the row gather has {n_big} graph nodes, not one a link")
    tube_bytes = K * P * (8 + 4) * 4
    tube_floor = tube_bytes / gather_bw
    out = {
        "detect_ms": t_detect * 1e3,
        "detect_mxu_floor_ms": t_mm * 1e3,
        "detect_ceiling_fraction": t_mm / t_detect,
        "jfa_ms": t_att * 1e3,
        "jfa_hbm_floor_ms": jfa_floor * 1e3,
        "jfa_ceiling_fraction": jfa_floor / t_att,
        "tube_ms": t_tube * 1e3,
        "tube_gather_floor_ms": tube_floor * 1e3,
        "tube_ceiling_fraction": tube_floor / t_tube,
        "gather_row_bw_gbs": gather_bw / 1e9,
        "gather_nodes_per_link": None if n_big is None else n_big / CH,
        "copy_bw_gbs": copy_bw / 1e9,
    }
    # PERF.md's bounds beside the fractions: the 8 band products' operations,
    # K1b's and K4's bytes and operations (kernel_bounds)
    kb = kernel_bounds(config)
    for key, (ms, by) in (("detect", bound_ms(0, mm_flops)), ("jfa", kb["att_field"]),
                          ("tube", kb["tube_match"])):
        out[key + "_bound_ms"], out[key + "_bound_by"] = ms, by
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--stages", action="store_true", help="also the stage ceilings")
    args = ap.parse_args(argv)
    out = {"roofline": measure()}
    if args.stages:
        out["stage_ceilings"] = measure_stages()
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
