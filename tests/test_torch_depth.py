"""The port's depth stage (kernel K5's plain version: regularization then the
inverse-depth EKF) against the JAX ``regularize_and_update_depth`` with
``reg_ekf_pallas`` in interpret mode, and each half against its JAX
reference-shaped function; and the step's fused stage
(``matching.match_and_update_depth``: K4, then K5 with the matcher's tail
and the failure gate) against the JAX step's composition of the same
functions."""

from __future__ import annotations

import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from torch_helpers import edge_map_t, small_frame_pair, t2n, use_pallas  # noqa: E402

from rebvio_tpu.configs import CameraConfig as JCam, CoreConfig as JCore  # noqa: E402
from rebvio_tpu.configs import EdgeMapConfig as JEdgeMapConfig  # noqa: E402
from rebvio_tpu.ops import matching as jM, tracker as jTr  # noqa: E402
from rebvio_tpu.pipeline import _tree_where  # noqa: E402
from rebvio_tpu_torch.configs import CameraConfig, CoreConfig, EdgeMapConfig  # noqa: E402
from rebvio_tpu_torch.geometry import so3 as tso3  # noqa: E402
from rebvio_tpu_torch.ops import matching as tM, tracker as tTr  # noqa: E402

H, W = 48, 64


def _map(seed, K=200, kmax=256):
    """A random map with edge chains, matches and a few degenerate keylines
    (zero depth, zero gradient norm, NaN depth) so every branch runs."""
    from tests.helpers import make_random_map

    rng = np.random.RandomState(seed)
    em, _ = make_random_map(rng, K, kmax, H, W)
    idn = np.full(kmax, -1, np.int32)
    idp = np.full(kmax, -1, np.int32)
    idn[:K - 1] = np.arange(1, K)
    idp[1:K] = np.arange(K - 1)
    idn[rng.rand(kmax) < 0.1] = -1
    mid = np.full(kmax, -1, np.int32)
    sel = rng.rand(K) < 0.6
    mid[:K][sel] = rng.randint(0, K, sel.sum())
    mg = rng.randn(kmax, 2).astype(np.float32) * 100
    mg[5] = 0.0
    mgn = np.linalg.norm(mg, axis=-1).astype(np.float32)
    mpi = (np.asarray(em.pos_img) + rng.randn(kmax, 2) * 2).astype(np.float32)
    rho = np.asarray(em.rho).copy()
    rho[3] = 0.0
    rho[7] = np.nan
    sr = np.asarray(em.sigma_rho).copy()
    sr[:20] = rng.uniform(0.01, 0.2, 20)
    return em.replace(id_next=jnp.asarray(idn), id_prev=jnp.asarray(idp),
                      match_id=jnp.asarray(mid), match_grad=jnp.asarray(mg),
                      match_grad_norm=jnp.asarray(mgn), match_pos_img=jnp.asarray(mpi),
                      rho=jnp.asarray(rho), sigma_rho=jnp.asarray(sr))


def _cfgs():
    kw = dict(rows=H, cols=W, cx=W / 2, cy=H / 2, fx=100, fy=100, k1=0, k2=0, k3=0,
              p1=0, p2=0)
    return JCam(**kw), JCore(search_range=8), CameraConfig(**kw), CoreConfig(search_range=8)


@pytest.mark.parametrize("seed,vel", [(0, (0.01, -0.004, 0.02)), (1, (0.0, 0.0, 0.0)),
                                      (2, (-0.03, 0.02, -0.05))])
def test_reg_ekf_matches_pallas(monkeypatch, seed, vel):
    jcam, jcore, tcam, tcore = _cfgs()
    em = _map(seed)
    v = jnp.asarray(vel, jnp.float32)
    got = tTr.regularize_and_update_depth(edge_map_t(em), torch.tensor(vel), 0.5, tcore, tcam)
    composed = jTr.update_inverse_depth(jM.regularize_1iter(em, 0.5), v, jcore, jcam)
    use_pallas(monkeypatch, "REGEKF")
    fused = jTr.regularize_and_update_depth(em, v, 0.5, jcore, jcam)
    jax.clear_caches()
    for k in ("rho", "sigma_rho"):
        g = t2n(getattr(got, k))
        for want, rtol in ((composed, 2e-6), (fused, 5e-5)):
            w = np.asarray(getattr(want, k))
            np.testing.assert_array_equal(np.isnan(g), np.isnan(w))
            # the same per-keyline float32 arithmetic; XLA:CPU contracts some
            # products into FMAs, and the EKF's cancellations (innovation,
            # 1 - K*H) lift that ulp -- the JAX package's own fused and
            # composed paths differ by up to 3e-5 relative on these maps
            np.testing.assert_allclose(g, w, rtol=rtol, atol=1e-6, err_msg=k)


def test_regularize_and_ekf_halves_match_jax():
    jcam, jcore, tcam, tcore = _cfgs()
    em = _map(3)
    vel = (0.01, 0.003, -0.02)
    r = jM.regularize_1iter(em, 0.5)
    tr = tM.regularize_1iter(edge_map_t(em), 0.5)
    np.testing.assert_allclose(t2n(tr.rho), np.asarray(r.rho), rtol=2e-6, atol=1e-6)
    np.testing.assert_allclose(t2n(tr.sigma_rho), np.asarray(r.sigma_rho), rtol=2e-6,
                               atol=1e-6)
    assert (t2n(tr.rho) != np.asarray(em.rho)).sum() > 10
    u = jTr.update_inverse_depth(r, jnp.asarray(vel, jnp.float32), jcore, jcam)
    tu = tTr.update_inverse_depth(tr, torch.tensor(vel), tcore, tcam)
    np.testing.assert_allclose(t2n(tu.rho), np.asarray(u.rho), rtol=2e-6, atol=1e-6)
    np.testing.assert_allclose(t2n(tu.sigma_rho), np.asarray(u.sigma_rho), rtol=2e-6,
                               atol=1e-6)


@pytest.fixture(scope="module")
def matched_pair():
    """(new map after forward matching, old map rotated by a small rotation,
    vel, Rvel, Rback, the 2x2 gradient replay, config) from a real small
    frame pair, with evolved depths on the old map."""
    with pytest.MonkeyPatch.context() as mp:
        m0, m1, jc = small_frame_pair(mp)
        use_pallas(mp, "TRYVEL", "TUBE", "REGEKF")
        rng = np.random.RandomState(11)
        K = m0.kmax
        m0 = m0.replace(rho=jnp.asarray(rng.uniform(0.3, 1.5, K).astype(np.float32)),
                        sigma_rho=jnp.asarray(rng.uniform(0.05, 1.0, K).astype(np.float32)),
                        matches=jnp.asarray(rng.randint(0, 7, K).astype(np.int32)),
                        match_id_keyframe=jnp.asarray(rng.randint(-1, 30, K).astype(np.int32)))
        v, Rv, old, _ = jTr.minimize_vel(m0, m1, m1.att_img, jnp.zeros(3, jnp.float32),
                                         jc.core, jc.camera, jc.field_scale, use_att=True)
        new, _ = jM.forward_match(old, m1)
        R = t2n(tso3.exp(torch.tensor([0.004, -0.006, 0.003])))
        old_r = jM.rotate_keylines(old, jnp.asarray(R), jc.camera.fm)
        yield new, old_r, v, Rv, R.T.copy(), R[:2, :2].copy(), jc
        jax.clear_caches()


def _jax_stage(new, old_r, V, Rv, Rback, M2, jc, jcore):
    """rebvio_tpu/pipeline.py:227-250: match, NaN gate, count gate, depth."""
    jem = JEdgeMapConfig()
    fail_nan = jnp.any(jnp.isnan(V))
    dm, klm = jM.directed_match_tube(new, old_r, V, Rv, jnp.asarray(Rback), jem, jcore,
                                     jc.camera, field_scale=jc.field_scale,
                                     grad_rot2=jnp.asarray(M2), use_pallas=True)
    post = _tree_where(fail_nan, new, dm)
    klm = jnp.where(fail_nan, 0, klm)
    failed = fail_nan | ((~fail_nan) & (klm < jcore.global_min_matches_threshold))
    reg = jTr.regularize_and_update_depth(post, V, jem.regularization_threshold, jcore,
                                          jc.camera)
    return _tree_where(failed, post, reg), int(klm), bool(failed)


@pytest.mark.parametrize("case", ["success", "too few matches", "NaN velocity"])
def test_fused_depth_stage_matches_jax_composition(matched_pair, case):
    new, old_r, v, Rv, Rback, M2, jc = matched_pair
    jcore = jc.core
    if case == "too few matches":
        jcore = dataclasses.replace(jcore, global_min_matches_threshold=10 ** 6)
    if case == "NaN velocity":
        v = jnp.asarray(np.asarray(v)).at[1].set(jnp.nan)
    want, wklm, wfailed = _jax_stage(new, old_r, v, Rv, Rback, M2, jc, jcore)
    cam = CameraConfig(**{k: getattr(jc.camera, k) for k in jc.camera.__dataclass_fields__})
    core = CoreConfig(**{k: getattr(jcore, k) for k in jcore.__dataclass_fields__})
    V = torch.as_tensor(np.array(v))
    got, klm, failed = tM.match_and_update_depth(
        edge_map_t(new), edge_map_t(old_r), V, torch.as_tensor(np.array(Rv)),
        torch.as_tensor(Rback), torch.isnan(V).any(), EdgeMapConfig(), core, cam,
        field_scale=jc.field_scale, grad_rot2=torch.as_tensor(M2))
    assert (int(klm), bool(failed)) == (wklm, wfailed)
    assert wfailed == (case != "success") and (wklm == 0) == (case == "NaN velocity")
    assert case == "NaN velocity" or wklm > 300
    for k in ("match_id", "matches", "match_id_keyframe"):
        np.testing.assert_array_equal(t2n(getattr(got, k)), np.asarray(getattr(want, k)),
                                      err_msg=k)
    for k in ("rho", "sigma_rho"):
        g, w = t2n(getattr(got, k)), np.asarray(getattr(want, k))
        np.testing.assert_array_equal(np.isnan(g), np.isnan(w))
        np.testing.assert_allclose(g, w, rtol=5e-5, atol=1e-6, err_msg=k)
    np.testing.assert_allclose(t2n(got.match_pos_img), np.asarray(want.match_pos_img),
                               rtol=1e-6, atol=1e-4)
    # the post-depth map is the matched map exactly where the frame failed
    unmatched = case == "NaN velocity"
    assert np.array_equal(t2n(got.rho), np.asarray(new.rho)) == unmatched
