"""The port's pose graph against the JAX package on the same graphs: the
forward-mode Jacobians of the factors against ``jax.jacfwd``, and the damped
Gauss-Newton's cost history and poses."""

from __future__ import annotations

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from torch_helpers import t2n, to_np  # noqa: E402

from rebvio_tpu.ba import pose_graph as jpg  # noqa: E402
from rebvio_tpu.geometry import so3 as jso3  # noqa: E402
from rebvio_tpu_torch import interop  # noqa: E402
from rebvio_tpu_torch.ba import pose_graph as tpg  # noqa: E402


def make_graph(rng, F=12, loop=True, split_weights=False):
    """tests/test_pose_graph.py's circular trajectory with accumulating
    drift, as a JAX PoseGraph."""
    ang = np.linspace(0, 1.5 * np.pi, F)
    t_gt = np.stack([np.cos(ang), np.sin(ang), 0.1 * ang], -1).astype(np.float32)
    R_gt = np.stack([np.asarray(jso3.exp(jnp.asarray([0.0, 0.0, a], jnp.float32)))
                     for a in ang])
    fi, fj, Rij, tij, w = jpg.factors_from_trajectory(R_gt, t_gt)
    if loop:
        for a, b, wl in ((0, F - 1, 3.0), (1, F - 2, 2.0), (0, F - 2, 2.0)):
            fi = np.concatenate([fi, [a]]).astype(np.int32)
            fj = np.concatenate([fj, [b]]).astype(np.int32)
            Rij = np.concatenate([Rij, (R_gt[a].T @ R_gt[b])[None]])
            tij = np.concatenate([tij, (R_gt[a].T @ (t_gt[b] - t_gt[a]))[None]])
            w = np.concatenate([w, [wl]]).astype(np.float32)
    R0, t0 = R_gt.copy(), t_gt.copy()
    drift = np.zeros(3)
    for f in range(1, F):
        drift += rng.randn(3) * 0.02
        t0[f] = t_gt[f] + drift
        R0[f] = R_gt[f] @ np.asarray(
            jso3.exp(jnp.asarray(rng.randn(3).astype(np.float32) * 0.01)))
    g = jpg.PoseGraph(
        R=jnp.asarray(R0, jnp.float32), t=jnp.asarray(t0, jnp.float32),
        f_i=jnp.asarray(fi), f_j=jnp.asarray(fj), f_Rij=jnp.asarray(Rij, jnp.float32),
        f_tij=jnp.asarray(tij, jnp.float32), f_w=jnp.asarray(w),
        f_valid=jnp.ones(len(fi), bool),
        f_wt=jnp.asarray(w * 0.5) if split_weights else None)
    return g, (R_gt, t_gt)


def to_port(g):
    return interop.pose_graph_from_numpy(
        {k: None if v is None else np.asarray(v) for k, v in g._asdict().items()}, device="cpu")


def test_factors_from_trajectory_equal():
    rng = np.random.RandomState(5)
    g, (R_gt, t_gt) = make_graph(rng, F=7, loop=False)
    for stride in (1, 2):
        a = jpg.factors_from_trajectory(R_gt, t_gt, stride=stride, w=0.7)
        b = tpg.factors_from_trajectory(R_gt, t_gt, stride=stride, w=0.7)
        for x, y in zip(a, b):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)


def test_factor_jacobians_match_jacfwd():
    """One jvp over 12 unit tangents against jax.jacfwd under vmap, on the
    sequential factors (evaluated exactly at identity, where log's series
    branch and the clipped arccos are live) and the loop factors (rotation
    residuals of a few degrees)."""
    rng = np.random.RandomState(0)
    g, _ = make_graph(rng)
    i, j = np.asarray(g.f_i), np.asarray(g.f_j)
    args = [np.array(a) for a in (g.R[i], g.t[i], g.R[j], g.t[j], g.f_Rij, g.f_tij)]
    jr, jJi, jJj = jax.vmap(jpg._factor_jac)(*[jnp.asarray(a) for a in args])
    tr, tJi, tJj = tpg.factor_jacobians(*[torch.as_tensor(a) for a in args])
    assert tJi.shape == (len(i), 6, 6) and np.isfinite(t2n(tJi)).all()
    # measured: residuals within 6e-8, Jacobians within 1.8e-7 (entries up
    # to 1.7); bounds ~10x that
    np.testing.assert_allclose(t2n(tr), np.asarray(jr), atol=1e-6)
    np.testing.assert_allclose(t2n(tJi), np.asarray(jJi), atol=2e-6)
    np.testing.assert_allclose(t2n(tJj), np.asarray(jJj), atol=2e-6)
    assert np.abs(np.asarray(jJi)).max() > 0.5


@pytest.mark.parametrize("seed,loop,split,fix_first,masked", [
    (0, True, False, True, False), (1, True, True, True, False),
    (2, False, False, True, True), (3, True, True, False, False)])
def test_optimize_matches_jax(seed, loop, split, fix_first, masked):
    rng = np.random.RandomState(seed)
    g, (R_gt, t_gt) = make_graph(rng, loop=loop, split_weights=split)
    if masked:
        fv = np.array(g.f_valid)
        fv[-2:] = False
        g = g._replace(f_valid=jnp.asarray(fv))
    jg, jhist = jpg.optimize(g, iters=15, fix_first=fix_first)
    tg, thist = tpg.optimize(to_port(g), iters=15, fix_first=fix_first)
    jhist, thist = np.asarray(jhist), t2n(thist)
    assert thist.shape == jhist.shape == (15,)
    # the same damped steps in float32 with the normal matrix summed in
    # another order.  The history falls from ~1e-1 to float32 noise (~1e-14),
    # so the absolute floor is relative to its start: measured within 2.2e-7
    # of hist[0]; 1e-6.  Poses: measured within 1.2e-7 with the first pose
    # fixed, 2.1e-5 with a free gauge (the damping alone holds it); 1e-6, 1e-4
    np.testing.assert_allclose(thist, jhist, rtol=1e-3, atol=1e-6 * jhist[0])
    pose_atol = 1e-6 if fix_first else 1e-4
    np.testing.assert_allclose(t2n(tg.t), np.asarray(jg.t), atol=pose_atol)
    np.testing.assert_allclose(t2n(tg.R), np.asarray(jg.R), atol=pose_atol)
    assert thist[-1] <= thist[0]
    if loop and fix_first:
        assert thist[-1] < thist[0] * 1e-2
    if fix_first:
        np.testing.assert_array_equal(t2n(tg.t[0]), np.asarray(g.t[0]))


def test_pose_graph_interop_round_trip():
    rng = np.random.RandomState(4)
    for split in (False, True):
        g, _ = make_graph(rng, F=6, split_weights=split)
        tg = to_port(g)
        assert tg.f_i.dtype == torch.int32 and tg.f_valid.dtype == torch.bool
        assert (tg.f_wt is None) == (not split)
        back = interop.to_numpy(tg)
        for k, v in to_np(g).items() if split else g._asdict().items():
            if v is None:
                assert back[k] is None
            else:
                np.testing.assert_array_equal(back[k], np.asarray(v))
