"""Keyline-sharded tracking: the LM translation tracker over a
``torch.distributed`` group (rebvio_tpu/parallel/keyline_shard.py).

The [K] keyline axis of the old map is split over the ranks; the new map
and its field are replicated.  Each LM evaluation is one launch of K2's
single pass (``kernels.try_vel``, csrc/try_vel.cu with no LM iteration) on
the rank's shard, then ONE all-reduce of its 13 sums (score, JtJ, JtF); the
LM update runs on the device, the same on every rank, as the unsharded
``kernels.minimize_vel_plain`` has it.  Nothing is read back: the accept
decisions are device selects, and the all-reduce is enqueued on the stream.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.distributed as dist

from rebvio_tpu_torch import types as T
from rebvio_tpu_torch.configs import CameraConfig, CoreConfig
from rebvio_tpu_torch.geometry import linalg
from rebvio_tpu_torch.ops import kernels, tracker

f32 = torch.float32

# the EdgeMap fields with the keyline axis first; the others (count,
# kl_id_img, att_img, threshold) are the map's as a whole
KEYLINE_FIELDS = ("pos", "pos_img", "match_pos_img", "grad", "match_grad", "grad_norm",
                  "match_grad_norm", "rho", "sigma_rho", "id_prev", "id_next", "match_id",
                  "match_id_forward", "match_id_keyframe", "matches", "valid")


def shard_edge_map(em: T.EdgeMap, group: Optional[dist.ProcessGroup] = None,
                   shard_keylines: bool = True) -> T.EdgeMap:
    """This rank's contiguous block of the map's [K] planes (K divisible by
    the group's size); with ``shard_keylines=False`` the map as it is
    (replicated)."""
    if not shard_keylines:
        return em
    rank, world = dist.get_rank(group), dist.get_world_size(group)
    K = em.kmax
    if K % world:
        raise ValueError(f"shard_edge_map: {K} keylines not divisible by {world} ranks")
    per = K // world
    return em.replace(**{f: getattr(em, f)[rank * per:(rank + 1) * per].contiguous()
                         for f in KEYLINE_FIELDS})


def _quantile_sharded(em: T.EdgeMap, percentile: float, num_bins: int,
                      group: Optional[dist.ProcessGroup]) -> torch.Tensor:
    """``matching.estimate_quantile`` with the sigma_rho histogram and the
    valid count all-reduced over the group (one all-reduce of num_bins + 1
    integers)."""
    span = T.RHO_MAX - T.RHO_MIN
    b = (num_bins * (em.sigma_rho - T.RHO_MIN) / span).to(torch.int64)
    b = torch.clamp(b, 0, num_bins - 1)
    hist = torch.zeros((num_bins,), dtype=torch.int64, device=b.device)
    hist = hist.index_add(0, b, em.valid.to(torch.int64))
    red = torch.cat([hist, em.valid.sum().reshape(1)])
    dist.all_reduce(red, group=group)
    hist, count = red[:num_bins], red[num_bins]
    csum = torch.cumsum(hist, 0)
    prefix = torch.cat([torch.zeros((1,), dtype=torch.int64, device=b.device), csum[:-1]])
    found = prefix.to(f32) > percentile * count.to(f32)
    i = torch.argmax(found.to(torch.int32))
    val = i.to(f32) * span / num_bins + T.RHO_MIN
    return torch.where(found.any(), val, 1e3)


def make_minimize_vel_sharded(group: Optional[dist.ProcessGroup], cfg: CoreConfig,
                              cam: CameraConfig, field_scale: int = 1,
                              use_att: bool = False) -> Callable:
    """Returns ``fn(old_shard, new_repl, field) -> (vel, Rvel, old_shard',
    score)``.  With ``use_att`` ``field`` is the new map's [8, N] attribute
    field (distance_field.build_att_field) at ``field_scale``, the product
    configuration; otherwise the [N] id field at full resolution
    (distance_field.field_id), read through ``tracker.raster_att``'s table,
    as the port's raster route reads it."""
    if not use_att and field_scale != 1:
        raise ValueError("the id-field route reads the full-resolution field (field_scale 1)")

    def fn(old: T.EdgeMap, new: T.EdgeMap, field: torch.Tensor):
        H, W = old.kl_id_img.shape
        srm = _quantile_sharded(old, cfg.quantile_cutoff, cfg.quantile_num_bins, group)
        use_f = tracker._use_mask(old, srm)
        att = field.contiguous() if use_att else tracker.raster_att(new, field)
        geom = tracker._try_vel_geom(H, W, field_scale, cfg, cam)
        pos_img, grad = old.pos_img.contiguous(), old.grad.contiguous()

        def eval_vel(vel, residuals):
            score, JtJ, JtF, res, mif = kernels.try_vel(pos_img, old.rho, old.sigma_rho, grad,
                                                        use_f, residuals, vel, att, geom)
            red = torch.cat([score.reshape(1), JtJ.reshape(9), JtF])
            dist.all_reduce(red, group=group)
            return red[0], red[1:10].view(3, 3), red[10:13], res, mif

        vel = torch.zeros(3, dtype=f32, device=old.rho.device)
        F, JtJ, JtF, residuals, mif = eval_vel(vel, torch.zeros_like(old.rho))
        u = 1e-3 * torch.max(JtJ)
        v = torch.full((), 2.0, dtype=f32, device=vel.device)
        eye = torch.eye(3, dtype=f32, device=vel.device)
        for _ in range(cfg.iterations):
            h = linalg.invert3(JtJ + eye * u) @ (-JtF)
            vel_new = vel + h
            F2, JtJ2, JtF2, residuals, mif = eval_vel(vel_new, residuals)
            gain = (F - F2) / (0.5 * torch.dot(h, u * h - JtF))
            accept = gain > 0.0
            F = torch.where(accept, F2, F)
            vel = torch.where(accept, vel_new, vel)
            JtJ = torch.where(accept, JtJ2, JtJ)
            JtF = torch.where(accept, JtF2, JtF)
            t = 2.0 * gain - 1.0
            u = torch.where(accept, u * torch.clamp(1.0 - t * t * t, min=0.33), u * v)
            v = torch.where(accept, 2.0, v * 2.0)
        return vel, linalg.invert3(JtJ), old.replace(match_id_forward=mif), F

    return fn
