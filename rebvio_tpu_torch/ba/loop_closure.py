"""Loop-closure registration and pose-graph construction from a VIO run
(rebvio_tpu/ba/loop_closure.py).

The tracking machinery is a registration engine: rotate one edge map by a
pose prior (edge_map.cpp:58-71), run the translation LM against the other
map's attribute field (core.cpp:150-189), then the 6-DoF linear refinement
(core.cpp:191-261).  Applied to a keyframe pair with the prior seeded from
the current pose estimates, it measures the relative pose from the edge
images: the visual correction on top of the drifted odometry chain is the
loop-closure information.

Pipeline: propose revisit candidates (estimated positions within a radius,
temporal gap above a floor) -> coarse rotation sweep -> register each pair
with the tracker -> gate on forward-match count and correction size -> SE3
factors for ba/pose_graph.optimize beside the sequential odometry factors.

The target map's field is rebuilt from its keyline table on every call:
kernel K1b (kernels.att_field).  Every tryVel pass is kernel K2.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from rebvio_tpu_torch import types as T
from rebvio_tpu_torch.ba import pose_graph as PG
from rebvio_tpu_torch.configs import PipelineConfig
from rebvio_tpu_torch.geometry import so3
from rebvio_tpu_torch.ops import distance_field as DF
from rebvio_tpu_torch.ops import matching, tracker

f32, i32 = torch.float32, torch.int32


def _target_field(em_j: T.EdgeMap, config: PipelineConfig) -> torch.Tensor:
    return DF.build_att_field(em_j, int(config.core.search_range), config.camera.rows,
                              config.camera.cols, config.field_scale)


def register_pair(em_i: T.EdgeMap, em_j: T.EdgeMap, R_prior: torch.Tensor,
                  config: PipelineConfig, iters: int = 4):
    """Register edge map i against edge map j with rotation prior
    R_prior = R_i^T R_j (world-from-camera convention).

    Returns (R_ij, V, n_matches, score): the measured relative rotation, the
    visual-scale translation of the i->j camera motion in the composed
    convention of the pipeline (t_j - t_i = -R_i @ R_ij @ V * K,
    rebvio.cpp:263-271), the forward-match count (quality gate), and the
    tracker's final LM score, all on the maps' device: nothing is read back.

    Each iteration re-rotates map i by the improved rotation and reruns the
    translation LM and the 6-DoF refinement.  Capture basin: association
    through the nearest-edge field is only valid while the prior's
    reprojection error is below the inter-edge spacing: priors good to
    ~1 deg converge; multi-degree errors alias onto neighbouring edges and
    stall (``coarse_align`` is for those).
    """
    cam = config.camera
    core = config.core
    dev = em_i.rho.device
    # the target map's attribute field, rebuilt from its keyline table
    # rather than trusting em_j.att_img
    att = _target_field(em_j, config)

    R_cur = R_prior
    V = torch.zeros(3, dtype=f32, device=dev)
    nfm = torch.zeros((), dtype=i32, device=dev)
    score = torch.zeros((), dtype=f32, device=dev)
    for _ in range(iters):
        # rotate map i into j's predicted frame (rebvio.cpp:163-165)
        old = matching.rotate_keylines(em_i, R_cur.T, cam.fm)
        vel, _P_V, old, score = tracker.minimize_vel(
            old, att, torch.zeros(3, dtype=f32, device=dev), core, cam,
            field_scale=config.field_scale)
        new2, nfm = matching.forward_match(old, em_j)
        Xv, _W_Xv = tracker.ext_rot_vel(new2, vel, core, cam)
        # compose as the estimation loop does (pipeline.py: R_T = R0 @
        # R_prior_T; world-from-camera R_ij = R_prior @ R0^T; V = R0@Vg + dV)
        R0 = so3.exp(Xv[3:6])
        R_cur = R_cur @ R0.T
        V = R0 @ vel + Xv[0:3]
    return R_cur, V, nfm, score


def match_counts(em_i: T.EdgeMap, att_j: torch.Tensor, Rcands: torch.Tensor,
                 config: PipelineConfig) -> torch.Tensor:
    """[C] int32 gradient-compatible nearest-edge hit counts of map i
    rotated by each candidate ``Rcands[c]`` ([C,3,3]), against map j's
    ``[8, N]`` attribute field: the tracker's own association measure
    (try_vel's lookup and similarity gate, core.cpp:56) with no LM.  All
    candidates go through one batched pass; the scoring function of the
    coarse alignment sweep."""
    cam = config.camera
    fs = config.field_scale
    H, W = cam.rows, cam.cols
    Wf = (W + fs - 1) // fs
    thr = config.core.match_threshold

    old = matching.rotate_keylines(em_i, Rcands.mT, cam.fm)       # fields [C,K,..]
    px = old.pos_img[..., 0] + cam.cx
    py = old.pos_img[..., 1] + cam.cy
    x = torch.floor(px + 0.5).to(torch.int64)
    y = torch.floor(py + 0.5).to(torch.int64)
    inb = (x >= 1) & (y >= 1) & (x < W - 1) & (y < H - 1)
    fidx = (torch.clamp(y, 0, H - 1) // fs) * Wf + torch.clamp(x, 0, W - 1) // fs
    fid, gx, gy, gn = att_j[DF.ATT_ID:DF.ATT_GN + 1][:, fidx]     # each [C,K]
    has = inb & em_i.valid & (fid >= 0)
    dot = gx * old.grad[..., 0] + gy * old.grad[..., 1]
    n2 = gn * gn
    sim = torch.abs(dot - n2) <= thr * n2
    return torch.sum(has & sim, dim=-1).to(i32)


def _unit(v) -> np.ndarray:
    v = np.asarray(v, np.float64)
    return v / max(np.linalg.norm(v), 1e-12)


def _exp_f32(w: np.ndarray) -> np.ndarray:
    """so3.exp of a float32 rotation vector on the host."""
    return so3.exp(torch.as_tensor(np.asarray(w, np.float32))).numpy()


def coarse_align(em_i: T.EdgeMap, em_j: T.EdgeMap, R_prior: torch.Tensor,
                 config: PipelineConfig, axis_i: np.ndarray, sweep_deg: float = 8.0,
                 steps: int = 17, att_j: torch.Tensor = None, axis2_i: np.ndarray = None,
                 sweep2_deg: float = 3.0, steps2: int = 13):
    """Rotation-sweep coarse alignment: registration alone only converges
    from priors good to ~1 deg, and drift beyond that aliases onto
    neighbouring edges.

    Sweeps ``steps`` rotation offsets up to +-``sweep_deg`` about ``axis_i``
    (the world up axis expressed in camera i: VIO drift is dominantly about
    gravity), conjugated onto the prior: R(d) = exp(axis_i * d) @ R_prior.
    With ``axis2_i`` the sweep is the 2-D grid R(d1, d2) = exp(axis_i * d1)
    @ exp(axis2_i * d2) @ R_prior over steps x steps2 candidates.  Each
    candidate is scored by ``match_counts`` in one batched pass; the best
    (the first of equal counts) re-seeds the LM registration.  The
    candidates are built on the host in float32.  Returns (aligned prior
    [3,3] on the device, chosen offset [rad] about axis_i, best count)."""
    if att_j is None:
        att_j = _target_field(em_j, config)
    offs = np.linspace(-sweep_deg, sweep_deg, steps) * np.pi / 180.0
    ax = _unit(axis_i)
    if axis2_i is not None:
        ax2 = _unit(axis2_i)
        offs2 = np.linspace(-sweep2_deg, sweep2_deg, steps2) * np.pi / 180.0
    else:
        ax2, offs2 = None, np.zeros(1)
    Rp = R_prior.detach().cpu().numpy()
    cand_l, off_l = [], []
    for d2 in offs2:
        R2 = _exp_f32(ax2 * d2) @ Rp if ax2 is not None else Rp
        for d in offs:
            cand_l.append(_exp_f32(ax * d) @ R2)
            off_l.append(d)
    cands = torch.as_tensor(np.stack(cand_l).astype(np.float32)).to(R_prior.device)
    counts = match_counts(em_i, att_j, cands, config).cpu().numpy()
    best = int(np.argmax(counts))
    return cands[best], float(off_l[best]), int(counts[best])


def propose_candidates(positions: np.ndarray, min_gap: int = 8, radius: float = 0.6,
                       max_pairs: int = 32) -> List[Tuple[int, int]]:
    """Revisit candidates among keyframe positions: pairs (i, j), i < j,
    separated by >= min_gap keyframes with estimated positions within
    ``radius``.  Nearest first, capped at max_pairs."""
    F = len(positions)
    cands = []
    for i in range(F):
        for j in range(i + min_gap, F):
            d = float(np.linalg.norm(positions[j] - positions[i]))
            if d <= radius:
                cands.append((d, i, j))
    cands.sort()
    return [(i, j) for _, i, j in cands[:max_pairs]]


def build_graph_from_run(kf_R: np.ndarray, kf_t: np.ndarray, kf_maps: List[T.EdgeMap],
                         config: PipelineConfig, K_scale: float = 1.0, min_gap: int = 8,
                         radius: float = 0.6, min_matches: int = 300, w_seq: float = 1.0,
                         w_loop: float = 0.3, w_loop_t: float = 0.1,
                         max_correction: float = 0.025, coarse_sweep_deg: float = 8.0,
                         coarse_steps: int = 17, up: Tuple[float, float, float] = (0.0, 1.0, 0.0),
                         coarse_sweep2_deg: float = 0.0, coarse_steps2: int = 13,
                         reg_iters: int = 4) -> Tuple[PG.PoseGraph, int]:
    """Sequential odometry factors from the VIO keyframe chain ``kf_R``
    [F,3,3], ``kf_t`` [F,3] plus tracker-registered loop-closure factors
    from the F stored keyframe maps.  Returns (graph on the maps' device,
    n_loop_factors).

    Each candidate pair first runs the ``coarse_align`` rotation sweep
    (disable with coarse_sweep_deg=0), so priors drifted by several degrees
    land inside the LM registration's ~1-deg capture basin.
    ``coarse_sweep2_deg`` > 0 also sweeps in-plane roll about the camera's
    optical axis (2-D grid): needed when roll drift exceeds the basin, but
    opt-in, since on pure-yaw drift the extra candidates add selection noise.

    Loop factors get split weights: rotation at ``w_loop``, translation at
    ``w_loop_t`` (depth-limited).  Pairs with fewer than ``min_matches``
    forward matches are dropped, and pairs whose measured rotation
    correction relative to the coarse-aligned prior exceeds
    ``max_correction`` rad: within-basin corrections beyond that are
    aliasing, not measurement.  Per pair the match count, the translation
    and the correction are read back to the host."""
    dev = kf_maps[0].rho.device
    fi, fj, Rij, tij, fw = PG.factors_from_trajectory(kf_R, kf_t, w=w_seq)
    fwt = fw.copy()

    lf_i, lf_j, lf_R, lf_t = [], [], [], []
    for (i, j) in propose_candidates(kf_t, min_gap, radius):
        R_prior = torch.as_tensor((kf_R[i].T @ kf_R[j]).astype(np.float32)).to(dev)
        if coarse_sweep_deg > 0:
            att_j = _target_field(kf_maps[j], config)
            axis_i = kf_R[i].T @ np.asarray(up, np.float64)
            # 2-D sweep: gravity (yaw, the dominant VIO drift mode) x the
            # camera's optical axis (in-plane roll, the secondary mode)
            axis2_i = np.asarray([0.0, 0.0, 1.0]) if coarse_sweep2_deg > 0 else None
            R_prior, _off, _cnt = coarse_align(
                kf_maps[i], kf_maps[j], R_prior, config, axis_i,
                sweep_deg=coarse_sweep_deg, steps=coarse_steps, att_j=att_j,
                axis2_i=axis2_i, sweep2_deg=coarse_sweep2_deg, steps2=coarse_steps2)
        R_m, V, nfm, _score = register_pair(kf_maps[i], kf_maps[j], R_prior, config,
                                            iters=reg_iters)
        V = V.cpu().numpy()
        if int(nfm) < min_matches or not bool(np.isfinite(V).all()):
            continue
        corr = so3.log(R_prior.T @ R_m).cpu().numpy()
        if float(np.linalg.norm(corr)) > max_correction:
            continue
        R_m = R_m.cpu().numpy().astype(np.float64)
        lf_i.append(i)
        lf_j.append(j)
        lf_R.append(R_m)
        lf_t.append(-(R_m @ V.astype(np.float64)) * float(K_scale))

    n_loops = len(lf_i)
    if n_loops:
        fi = np.concatenate([fi, np.asarray(lf_i, np.int32)])
        fj = np.concatenate([fj, np.asarray(lf_j, np.int32)])
        Rij = np.concatenate([Rij, np.stack(lf_R).astype(np.float32)])
        tij = np.concatenate([tij, np.stack(lf_t).astype(np.float32)])
        fw = np.concatenate([fw, np.full(n_loops, w_loop, np.float32)])
        fwt = np.concatenate([fwt, np.full(n_loops, w_loop_t, np.float32)])

    def up_(a, dtype):
        return torch.as_tensor(np.asarray(a, dtype)).to(dev)

    g = PG.PoseGraph(
        R=up_(kf_R, np.float32), t=up_(kf_t, np.float32),
        f_i=up_(fi, np.int32), f_j=up_(fj, np.int32),
        f_Rij=up_(Rij, np.float32), f_tij=up_(tij, np.float32),
        f_w=up_(fw, np.float32), f_valid=torch.ones(len(fi), dtype=torch.bool, device=dev),
        f_wt=up_(fwt, np.float32))
    return g, n_loops
