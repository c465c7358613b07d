"""Landmark-sharded bundle adjustment over a ``torch.distributed`` group
(rebvio_tpu/ba/distributed.py).

The map (landmarks and their observations) is split across ranks; each
rank accumulates its shard's share of the reduced camera system, and one
all-reduce (SUM) of S, rhs and the cost per iteration combines them.  The
camera system is small ([6F, 6F]); the Jacobians, the landmark blocks and
the [6F, L_shard] x [L_shard, 6F] product stay on the shard.  Poses are
replicated: every rank solves the same summed system and makes the same
accept decision from the summed cost.

Sharding contract: ``shard_problem`` pads L and O to multiples of the rank
count and moves each landmark's observations into its landmark's shard
(contiguous blocks).  ``obs_lm`` stays global in the shards; ``optimize``
rebases it to the shard while it runs and restores it after, as the JAX
package's shard-local rebasing does.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.distributed as dist

from rebvio_tpu_torch.ba import problem as bap


def shard_problem(p: bap.BAProblem, n_shards: int, device=None) -> bap.BAProblem:
    """Host-side repartition (numpy): pad L and O to multiples of
    ``n_shards`` and reorder the observations so that each landmark's lie in
    its landmark's shard.  Returns the whole padded problem on ``device``
    (default: the problem's); shard s is rows [s L/n, (s+1) L/n) of the
    landmark leaves and [s O/n, (s+1) O/n) of the observation leaves
    (``local_shard``)."""
    dev = p.rho.device if device is None else torch.device(device)
    L = p.rho.shape[0]
    Lp = ((L + n_shards - 1) // n_shards) * n_shards
    per_shard_L = Lp // n_shards

    lm = p.obs_lm.cpu().numpy()
    valid_o = p.obs_valid.cpu().numpy() & (lm >= 0)
    shard_of_lm = np.arange(Lp) // per_shard_L

    # bucket observations by shard of their landmark
    obs_shard = np.where(valid_o, shard_of_lm[np.clip(lm, 0, Lp - 1)], -1)
    counts = [int((obs_shard == s).sum()) for s in range(n_shards)]
    per_shard_O = max(counts) if counts else 1
    Op = per_shard_O * n_shards

    def gather_obs(x, fill):
        arr = x.cpu().numpy()
        out = np.full((n_shards, per_shard_O) + arr.shape[1:], fill, arr.dtype)
        for s in range(n_shards):
            sel = np.nonzero(obs_shard == s)[0]
            out[s, : len(sel)] = arr[sel]
        return torch.as_tensor(out.reshape((Op,) + arr.shape[1:])).to(dev)

    def pad_lm(x, fill):
        arr = x.cpu().numpy()
        out = np.full((Lp,) + arr.shape[1:], fill, arr.dtype)
        out[:L] = arr
        return torch.as_tensor(out).to(dev)

    return bap.BAProblem(
        R=p.R.to(dev), t=p.t.to(dev),
        rho=pad_lm(p.rho, 1.0),
        anchor_kf=pad_lm(p.anchor_kf, 0),
        anchor_ray=pad_lm(p.anchor_ray, 0.0),
        obs_lm=gather_obs(p.obs_lm, -1),
        obs_kf=gather_obs(p.obs_kf, 0),
        obs_uv=gather_obs(p.obs_uv, 0.0),
        obs_w=gather_obs(p.obs_w, 0.0),
        lm_valid=pad_lm(p.lm_valid, False),
        obs_valid=gather_obs(p.obs_valid, False),
    )


_LANDMARK_LEAVES = ("rho", "anchor_kf", "anchor_ray", "lm_valid")
_OBS_LEAVES = ("obs_lm", "obs_kf", "obs_uv", "obs_w", "obs_valid")


def local_shard(p: bap.BAProblem, rank: int, n_shards: int) -> bap.BAProblem:
    """Shard ``rank`` of a ``shard_problem`` result (poses replicated)."""
    Ls, Os = p.rho.shape[0] // n_shards, p.obs_lm.shape[0] // n_shards
    kw = {k: getattr(p, k)[rank * Ls:(rank + 1) * Ls] for k in _LANDMARK_LEAVES}
    kw.update({k: getattr(p, k)[rank * Os:(rank + 1) * Os] for k in _OBS_LEAVES})
    return p._replace(**kw)


def optimize(p_shard: bap.BAProblem, group=None, iters: int = 10, huber_delta: float = 0.0
             ) -> Tuple[bap.BAProblem, torch.Tensor]:
    """The landmark-sharded damped Gauss-Newton (JAX's
    ``make_distributed_optimize``: lam0 1e-3, keyframe 0 fixed) on this
    rank's shard of ``group``.  Per iteration one all-reduce each of S, rhs
    and the cost; every rank holds the same poses and cost history.
    Returns (this rank's shard, optimized, with global ``obs_lm``; [iters]
    cost history)."""
    base = dist.get_rank(group) * p_shard.rho.shape[0]
    p_loc = p_shard._replace(obs_lm=torch.where(p_shard.obs_lm >= 0, p_shard.obs_lm - base, -1))

    def all_reduce(x: torch.Tensor) -> torch.Tensor:
        x = x.clone()
        dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
        return x

    p_fin, hist = bap.optimize(p_loc, iters, 1e-3, True, huber_delta, reduce=all_reduce)
    return p_fin._replace(obs_lm=torch.where(p_fin.obs_lm >= 0, p_fin.obs_lm + base, -1)), hist
