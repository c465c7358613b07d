"""Keyline detection: dense gates, 5x5 plane fit as band-matrix products,
raster-order compaction, edge joining and the histogram auto-threshold
(rebvio_tpu/ops/edge_detect.py; reference edge_detector.cpp:45-186)."""

from __future__ import annotations

from typing import Tuple

import torch

from rebvio_tpu_torch import types as T
from rebvio_tpu_torch.configs import CameraConfig, EdgeDetectorConfig
from rebvio_tpu_torch.ops.scale_space import FrontendMatrices, build_scale_space, mxu_dot

f32, i32 = torch.float32, torch.int32


def detect(image: torch.Tensor, threshold: torch.Tensor, mats: FrontendMatrices,
           cfg: EdgeDetectorConfig, cam: CameraConfig, field_scale: int = 1) -> T.EdgeMap:
    """Detect keylines in an (already undistorted, gain-applied) float image;
    ``threshold`` is the auto-gained detection threshold carried in VioState."""
    em, _aux = _detect_core(image, threshold, mats, cfg, cam, field_scale)
    return em


def detect_with_seeds(image: torch.Tensor, threshold: torch.Tensor, mats: FrontendMatrices,
                      cfg: EdgeDetectorConfig, cam: CameraConfig, field_scale: int,
                      search_range: int):
    """Detection plus the flood's seed stack, built densely from the
    detector's per-pixel planes (distance_field.seed_stack_dense).
    Returns (EdgeMap, seed_stack)."""
    from rebvio_tpu_torch.ops import distance_field as DF

    em, (xs, ys, t0, t1) = _detect_core(image, threshold, mats, cfg, cam, field_scale)
    H, W = image.shape
    stack = DF.seed_stack_dense(em.kl_id_img, xs, ys, t0, t1, em.threshold,
                                search_range, H, W, field_scale)
    return em, stack


def _detect_core(image, threshold, mats: FrontendMatrices, cfg: EdgeDetectorConfig,
                 cam: CameraConfig, field_scale: int = 1):
    H, W = image.shape
    dev = image.device
    pfs = cfg.plane_fit_size
    kmax = cfg.keylines_max
    bf16 = cfg.frontend_bf16

    s0, dog, mag = build_scale_space(image, mats, bf16=bf16)

    n_win = (2 * pfs + 1) ** 2
    pn_threshold = float(n_win) * cfg.pos_neg_threshold
    gthr = threshold * cfg.max_image_value * cfg.dog_threshold
    gradient_threshold_sq = gthr * gthr
    mthr = threshold * cfg.max_image_value
    mag_threshold = mthr * mthr

    sxx = float((2 * pfs + 1) * sum(i * i for i in range(-pfs, pfs + 1)))
    sign_map = torch.where(dog > 0.0, 1.0, -1.0)
    dogXW = mxu_dot(dog, mats.XW, bf16)
    lcat = mxu_dot(mats.S5H, torch.cat([sign_map, dog, dogXW], dim=1), bf16)
    S5Hsign = lcat[:, :W]
    S5Hdog = lcat[:, W:2 * W]
    t0 = lcat[:, 2 * W:] / sxx
    YHdog = mxu_dot(mats.YH, dog, bf16)
    rcat = mxu_dot(torch.cat([S5Hsign, S5Hdog, YHdog], dim=0), mats.S5W, bf16)
    pn = rcat[:H]
    t2 = rcat[H:2 * H] / float(n_win)
    t1 = rcat[2 * H:] / sxx
    g2 = t0 * t0 + t1 * t1
    tmp = t2 / torch.where(g2 > 0, g2, torch.ones_like(g2))
    xs = -t0 * tmp
    ys = -t1 * tmp

    rr = torch.arange(H, device=dev)[:, None]
    cc = torch.arange(W, device=dev)[None, :]
    interior = (rr >= pfs) & (rr < H - pfs) & (cc >= pfs) & (cc < W - pfs)
    cand = (interior & (mag >= mag_threshold) & (torch.abs(pn) <= pn_threshold)
            & (torch.abs(xs) <= 0.5) & (torch.abs(ys) <= 0.5)
            & (g2 >= gradient_threshold_sq) & (g2 > 0))

    # raster-order compaction with the keylines_max cutoff: nonzero returns
    # raster order, so slot s holds the (s+1)-th candidate
    cand_flat = cand.reshape(-1)
    total = cand_flat.sum(dtype=torch.int64)
    count = torch.clamp(total, max=kmax).to(i32)
    idx = torch.nonzero(cand_flat).squeeze(1)[:kmax]
    n = idx.shape[0]
    safe_idx = torch.zeros((kmax,), dtype=torch.int64, device=dev)
    safe_idx[:n] = idx
    valid = torch.arange(kmax, device=dev) < n
    prow = torch.div(safe_idx, W, rounding_mode="floor").to(f32)
    pcol = (safe_idx % W).to(f32)
    planes = torch.stack([xs, ys, t0, t1], dim=-1).reshape(H * W, 4)
    rowk = planes[safe_idx]
    xs_k, ys_k, g0_k, g1_k = rowk[:, 0], rowk[:, 1], rowk[:, 2], rowk[:, 3]

    vm = valid[:, None]
    pos = torch.where(vm, torch.stack([pcol + xs_k, prow + ys_k], dim=-1), 0.0)
    grad = torch.where(vm, torch.stack([g0_k, g1_k], dim=-1), 0.0)
    grad_norm = torch.sqrt(torch.sum(grad * grad, dim=-1))
    pp = torch.tensor([cam.cx, cam.cy], dtype=f32, device=dev)
    pos_img = torch.where(vm, pos - pp, 0.0)

    kl_id_img = torch.full((H * W,), -1, dtype=i32, device=dev)
    kl_id_img[idx] = torch.arange(n, dtype=i32, device=dev)   # unique indices
    kl_id_img = kl_id_img.reshape(H, W)

    id_next, id_prev = _join_edges(pos, grad, valid, kl_id_img)
    map_threshold = _tune_threshold(grad_norm, valid, cfg)

    em = T.empty_edge_map(kmax, H, W, field_scale, dev).replace(
        pos=pos, pos_img=pos_img, match_pos_img=pos_img.clone(),
        grad=grad, grad_norm=grad_norm,
        id_prev=id_prev, id_next=id_next,
        valid=valid, count=count, kl_id_img=kl_id_img,
        threshold=map_threshold,
    )
    return em, (xs, ys, t0, t1)


def _join_edges(pos, grad, valid, kl_id_img) -> Tuple[torch.Tensor, torch.Tensor]:
    """Link keylines along the edge tangent by probing 3 neighbours in the
    reference's priority order (edge_detector.cpp:138-165)."""
    H, W = kl_id_img.shape
    kmax = pos.shape[0]
    x = (pos[:, 0] + 0.5).to(torch.int64)       # truncation, as astype(int32)
    y = (pos[:, 1] + 0.5).to(torch.int64)
    tx = -grad[:, 1]
    ty = grad[:, 0]
    pad = torch.nn.functional.pad(kl_id_img, (1, 1, 1, 1), value=-1).reshape(-1)
    Wp = W + 2
    one = torch.ones_like(x)
    sx = torch.where(tx > 0, one, -one)
    sx_neg = torch.where(tx < 0, -one, one)
    px = torch.where(ty > 0, sx, sx_neg)
    py = torch.where(ty > 0, one, -one)
    base = (y + 1) * Wp + (x + 1)

    def probe(off):
        return pad[torch.clamp(base + off, 0, pad.numel() - 1)]

    c1 = probe(px)
    c2 = probe(py * Wp)
    c3 = probe(py * Wp + px)
    id_next = torch.where(c1 >= 0, c1, torch.where(c2 >= 0, c2, c3))
    id_next = torch.where(valid, id_next, -1)

    # id_prev[target] = max index with id_next[index] == target (the later
    # index wins, edge_detector.cpp:133): one scatter-max
    tgt = torch.where(valid & (id_next >= 0), id_next, kmax).to(torch.int64)
    id_prev = torch.full((kmax + 1,), -1, dtype=i32, device=pos.device)
    id_prev = id_prev.scatter_reduce(0, tgt, torch.arange(kmax, dtype=i32, device=pos.device),
                                     reduce="amax")
    return id_next, id_prev[:kmax]


def _tune_threshold(grad_norm, valid, cfg: EdgeDetectorConfig) -> torch.Tensor:
    """Histogram auto-threshold over keyline gradient norms (tuneThreshold,
    edge_detector.cpp:167-186), including its skip-bin-0 loop quirk."""
    nb = cfg.num_bins
    big = 3.4e38
    max_dog = torch.max(torch.where(valid, grad_norm, -big))
    min_dog = torch.min(torch.where(valid, grad_norm, big))
    rng = torch.where(max_dog > min_dog, max_dog - min_dog, 1.0)
    bins = (nb * (max_dog - grad_norm) / rng).to(torch.int64)
    bins = torch.clamp(bins, 0, nb - 1)
    hist = torch.zeros((nb,), dtype=torch.int64, device=grad_norm.device)
    hist = hist.index_add(0, bins, valid.to(torch.int64))
    hist[0] = 0
    csum = torch.cumsum(hist, 0)
    reached = csum >= cfg.keylines_max
    first = torch.argmax(reached.to(torch.int32))
    i_star = torch.where(reached.any(), first, nb).to(f32)
    return max_dog - i_star * (max_dog - min_dog) / float(nb)


def autogain_threshold(threshold, keylines_count, cfg: EdgeDetectorConfig):
    """Proportional threshold controller toward keylines_ref
    (edge_detector.cpp:33-36)."""
    if cfg.gain <= 0:
        return threshold
    t = threshold - cfg.gain * (cfg.keylines_ref - keylines_count.to(f32))
    return torch.clamp(t, cfg.min_threshold, cfg.max_threshold)
