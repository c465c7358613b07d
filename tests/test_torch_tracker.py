"""The port's tracker against the JAX package on a real small frame pair:
one tryVel pass (kernel K2's plain version against ``try_vel_math_pallas``
in interpret mode), the LM loop, forward matching (duplicate targets and
rho ties), the 6-DoF refinement, and the acceleration estimators."""

from __future__ import annotations

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from torch_helpers import edge_map_t, small_frame_pair, t2n, to_np, use_pallas  # noqa: E402

from rebvio_tpu import types as jT  # noqa: E402
from rebvio_tpu.ops import imu as jimu, matching as jM, tracker as jTr  # noqa: E402
from rebvio_tpu_torch.configs import CameraConfig, CoreConfig  # noqa: E402
from rebvio_tpu_torch.ops import imu as timu, matching as tM, tracker as tTr  # noqa: E402


def _tcfg(jc):
    """The port's config objects with the same field values."""
    return (CameraConfig(**{k: getattr(jc.camera, k) for k in jc.camera.__dataclass_fields__}),
            CoreConfig(**{k: getattr(jc.core, k) for k in jc.core.__dataclass_fields__}))


@pytest.fixture(scope="module")
def pair():
    with pytest.MonkeyPatch.context() as mp:
        m0, m1, jc = small_frame_pair(mp)
        rng = np.random.RandomState(5)
        # spread depths so the participation gate and the reweight act
        K = m0.kmax
        m0 = m0.replace(rho=jnp.asarray(rng.uniform(0.2, 2.0, K).astype(np.float32)),
                        sigma_rho=jnp.asarray(rng.uniform(0.5, 25.0, K).astype(np.float32)))
        use_pallas(mp, "TRYVEL")
        yield m0, m1, jc, mp
        jax.clear_caches()


@pytest.mark.parametrize("vel", [(0.0, 0.0, 0.0), (0.004, -0.003, 0.01), (-0.02, 0.01, -0.03)])
def test_try_vel_pass_matches_pallas(pair, vel):
    m0, m1, jc, _ = pair
    cam, core = _tcfg(jc)
    rng = np.random.RandomState(int(1000 * abs(sum(vel))))
    res0 = np.abs(rng.randn(m0.kmax)).astype(np.float32) * 3
    srm = 12.0
    want = jTr.try_vel(m0, m1, m1.att_img, jnp.asarray(vel, jnp.float32), jnp.float32(srm),
                       jnp.asarray(res0), jc.core, jc.camera, field_scale=jc.field_scale,
                       att_f=m1.att_img.T)
    got = tTr.try_vel(edge_map_t(m0), torch.as_tensor(np.asarray(m1.att_img)),
                      torch.tensor(vel, dtype=torch.float32), torch.tensor(srm),
                      torch.as_tensor(res0), core, cam, jc.field_scale)
    score, JtJ, JtF, res, mif = (t2n(x) for x in got)
    # per-keyline outputs are the same float32 arithmetic; the Gram sums and
    # the score add 2048 terms in another order
    np.testing.assert_array_equal(mif, np.asarray(want.match_id_forward))
    assert (mif >= 0).sum() > 500
    np.testing.assert_allclose(res, np.asarray(want.residuals), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(score, float(want.score), rtol=1e-5)
    np.testing.assert_allclose(JtJ, np.asarray(want.JtJ), rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(JtF, np.asarray(want.JtF), rtol=1e-4, atol=1e-3)


def test_try_vel_pass_matches_fused_pallas(pair):
    """The port's pass computes what the fused try_vel_pallas (K6) computes:
    projection, field-row gather, gates and Gram sums in one kernel."""
    from rebvio_tpu.ops.pallas_kernels import try_vel_pallas

    m0, m1, jc, _ = pair
    cam, core = _tcfg(jc)
    vel = (0.004, -0.003, 0.01)
    res0 = np.abs(np.random.RandomState(8).randn(m0.kmax)).astype(np.float32) * 3
    srm = 12.0
    score, G, res, mif = try_vel_pallas(
        m0, m1.att_img.T, jnp.asarray(vel, jnp.float32), jnp.float32(srm), jnp.asarray(res0),
        jc.core, jc.camera, field_scale=jc.field_scale, block=512, interpret=True)
    got = tTr.try_vel(edge_map_t(m0), torch.as_tensor(np.asarray(m1.att_img)),
                      torch.tensor(vel, dtype=torch.float32), torch.tensor(srm),
                      torch.as_tensor(res0), core, cam, jc.field_scale)
    t_score, JtJ, JtF, t_res, t_mif = (t2n(x) for x in got)
    G = np.asarray(G)
    np.testing.assert_array_equal(t_mif, np.asarray(mif))
    assert (t_mif >= 0).sum() > 500
    # K6 forms the residual with its own operation order (a few keylines
    # differ in the last digits; the JAX suite holds K6 to its XLA pass at
    # rtol 1e-2), and the Gram sums add 2048 terms in another order
    np.testing.assert_allclose(t_res, np.asarray(res), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(t_score, float(np.asarray(score).sum()), rtol=1e-5)
    np.testing.assert_allclose(JtJ, G[:3, :3], rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(JtF, G[:3, 3], rtol=1e-4, atol=1e-3)


def test_minimize_vel_matches_jax(pair):
    m0, m1, jc, _ = pair
    cam, core = _tcfg(jc)
    vel0 = jnp.zeros(3, jnp.float32)
    v, Rv, old, F = jTr.minimize_vel(m0, m1, m1.att_img, vel0, jc.core, jc.camera,
                                     jc.field_scale, use_att=True)
    tv, tRv, told, tF = tTr.minimize_vel(edge_map_t(m0), torch.as_tensor(np.asarray(m1.att_img)),
                                         torch.zeros(3), core, cam, jc.field_scale)
    # six dependent LM steps on float32 Gram sums: the velocity to 1e-5
    np.testing.assert_allclose(t2n(tv), np.asarray(v), atol=1e-5, rtol=1e-3)
    np.testing.assert_allclose(t2n(tRv), np.asarray(Rv), rtol=1e-3, atol=1e-9)
    np.testing.assert_allclose(float(tF), float(F), rtol=1e-4)
    agree = np.mean(t2n(told.match_id_forward) == np.asarray(old.match_id_forward))
    assert agree > 0.999


def _fm_maps(seed, K=300, kmax=384):
    """Old/new maps for forward_match with duplicate targets and rho ties."""
    from tests.helpers import make_random_map

    rng = np.random.RandomState(seed)
    old, _ = make_random_map(rng, K, kmax, 40, 60)
    new, _ = make_random_map(rng, K, kmax, 40, 60)
    mif = np.full(kmax, -1, np.int32)
    mif[:K] = rng.randint(0, K // 4, K)          # ~4 candidates per target
    mif[rng.rand(kmax) < 0.2] = -1
    rho = np.asarray(old.rho).copy()
    rho[:K] = rng.choice([0.5, 1.0, 1.5], K).astype(np.float32)   # many exact ties
    matches = rng.randint(0, 9, kmax).astype(np.int32)
    kf = rng.randint(-1, 50, kmax).astype(np.int32)
    old = old.replace(match_id_forward=jnp.asarray(mif), rho=jnp.asarray(rho),
                      matches=jnp.asarray(matches), match_id_keyframe=jnp.asarray(kf))
    return old, new


@pytest.mark.parametrize("seed", [0, 1])
def test_forward_match_ties_and_duplicates(seed):
    old, new = _fm_maps(seed)
    want, n = jM.forward_match(old, new)
    got, tn = tM.forward_match(edge_map_t(old), edge_map_t(new))
    assert int(tn) == int(n) > 20
    w, g = to_np(want), {k: t2n(v) for k, v in vars(got).items()}
    for k in w:
        np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def test_ext_rot_vel_matches_jax(pair):
    m0, m1, jc, _ = pair
    cam, core = _tcfg(jc)
    v, _, old, _ = jTr.minimize_vel(m0, m1, m1.att_img, jnp.zeros(3, jnp.float32), jc.core,
                                    jc.camera, jc.field_scale, use_att=True)
    new, _ = jM.forward_match(old, m1)
    X, W = jTr.ext_rot_vel(new, v, jc.core, jc.camera)
    tX, tW = tTr.ext_rot_vel(edge_map_t(new), torch.as_tensor(np.asarray(v)), core, cam)
    # 6x6 Gram over ~2000 matches in another order, then a 6x6 solve
    np.testing.assert_allclose(t2n(tW), np.asarray(W), rtol=1e-4, atol=1e-2)
    np.testing.assert_allclose(t2n(tX), np.asarray(X), rtol=1e-3, atol=1e-6)


def test_rotate_and_quantile_match_jax(pair):
    m0, _, jc, _ = pair
    from rebvio_tpu_torch.geometry import so3 as tso3

    w = np.array([0.01, -0.02, 0.015], np.float32)
    R = tso3.exp(torch.as_tensor(w))
    want = jM.rotate_keylines(m0, jnp.asarray(t2n(R)), jc.camera.fm)
    got = tM.rotate_keylines(edge_map_t(m0), R, jc.camera.fm)
    for k in ("pos_img", "rho", "sigma_rho", "grad"):
        np.testing.assert_allclose(t2n(getattr(got, k)), np.asarray(getattr(want, k)),
                                   rtol=1e-6, atol=1e-5, err_msg=k)
    q = jM.estimate_quantile(m0, jc.core.quantile_cutoff, jc.core.quantile_num_bins)
    tq = tM.estimate_quantile(edge_map_t(m0), jc.core.quantile_cutoff,
                              jc.core.quantile_num_bins)
    assert float(tq) == float(q)


def test_acceleration_estimators_match_jax():
    rng = np.random.RandomState(2)
    vh = rng.randn(5, 3).astype(np.float32)
    dh = rng.uniform(0.04, 0.06, 4).astype(np.float32)
    ah = rng.randn(4, 3).astype(np.float32)
    v = rng.randn(3).astype(np.float32)
    from rebvio_tpu_torch.geometry import so3 as tso3

    R = t2n(tso3.exp(torch.tensor([0.02, -0.01, 0.03])))
    a, nh, nd = jimu.estimate_ls4_acceleration(jnp.asarray(v), jnp.asarray(R),
                                               jnp.float32(0.05), jnp.asarray(vh),
                                               jnp.asarray(dh))
    ta, tnh, tnd = timu.estimate_ls4_acceleration(torch.as_tensor(v), torch.as_tensor(R),
                                                  torch.tensor(0.05), torch.as_tensor(vh),
                                                  torch.as_tensor(dh))
    np.testing.assert_allclose(t2n(ta), np.asarray(a), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(t2n(tnh), np.asarray(nh), rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(t2n(tnd), np.asarray(nd))
    m, mh = jimu.estimate_mean_acceleration(jnp.asarray(v), jnp.asarray(R), jnp.asarray(ah))
    tm, tmh = timu.estimate_mean_acceleration(torch.as_tensor(v), torch.as_tensor(R),
                                              torch.as_tensor(ah))
    np.testing.assert_allclose(t2n(tm), np.asarray(m), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(t2n(tmh), np.asarray(mh), rtol=1e-6, atol=1e-6)


def test_pack_imu_window_matches_jax():
    rng = np.random.RandomState(4)
    ts = np.cumsum(rng.randint(4000, 6000, 9)).astype(np.int64) + 1_000_000
    g = rng.randn(9, 3).astype(np.float32)
    a = rng.randn(9, 3).astype(np.float32)
    for n in (0, 1, 9):
        want = to_np(jimu.pack_imu_window(g[:n], a[:n], ts[:n], 32))
        got = timu.pack_imu_window(g[:n], a[:n], ts[:n], 32, device="cpu")
        for k in want:
            np.testing.assert_array_equal(t2n(getattr(got, k)), want[k], err_msg=k)
    assert isinstance(jT.empty_imu_frame(4).n, jax.Array)
