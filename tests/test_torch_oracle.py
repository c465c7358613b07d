"""The port against the sequential numpy oracles of tests/oracle.py: the
composed vision-only master loop (the port's counterpart of
tests/test_oracle_pipeline.py: the reference-semantics configuration, raster
field and pixel walk, no IMU), and the plain versions of the kernels of that
path one by one: K2's tryVel pass and LM solve on the raster table, K5's
regularization and inverse-depth EKF, the sigma_rho quantile, the raster
field and the pixel walk.  CPU, seeded numpy inputs, the JAX package's own
oracle tolerances (tests/test_tracker.py, test_distance_field.py,
test_matching.py)."""

from __future__ import annotations

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from torch_helpers import edge_map_t, small_config, t2n  # noqa: E402

from tests import oracle  # noqa: E402
from tests.helpers import cam_dict, make_random_map  # noqa: E402

import rebvio_tpu_torch.configs as tcfg  # noqa: E402
from rebvio_tpu_torch import eval as tev  # noqa: E402
from rebvio_tpu_torch.data import synthetic as tsyn  # noqa: E402
from rebvio_tpu_torch.ops import distance_field as tDF  # noqa: E402
from rebvio_tpu_torch.ops import matching as tM, tracker as tTr  # noqa: E402
from rebvio_tpu_torch.ops.scale_space import build_scale_space  # noqa: E402
from rebvio_tpu_torch.pipeline import frontend_matrices  # noqa: E402
from rebvio_tpu_torch.runner import VioRunner  # noqa: E402

N_FRAMES = 12


def _cam(H, W):
    return tcfg.CameraConfig(rows=H, cols=W, cx=W / 2, cy=H / 2, fx=100, fy=100,
                             k1=0, k2=0, k3=0, p1=0, p2=0)


def _raster_setup(seed=0, H=48, W=64, K=80, kmax=128, R=8):
    """(rng, old, old dict, new, new dict, raster ids [H*W], cam, cfg) as
    tests/test_tracker.py's _setup, the maps as the port's."""
    rng = np.random.RandomState(seed)
    old_j, old_d = make_random_map(rng, K, kmax, H, W)
    new_j, new_d = make_random_map(rng, K, kmax, H, W)
    new = edge_map_t(new_j)
    ids = tDF.field_id(tDF.build_distance_field(new, R, H, W), kmax)
    return rng, edge_map_t(old_j), old_d, new, new_d, ids, _cam(H, W), tcfg.CoreConfig(
        search_range=R)


def test_distance_field_matches_oracle():
    """The raster field's ids equal the oracle's sequential rasterization,
    with and without the threshold gate."""
    rng = np.random.RandomState(0)
    H, W, K, kmax, R = 48, 64, 100, 128, 8
    em_j, d = make_random_map(rng, K, kmax, H, W)
    em = edge_map_t(em_j)
    for thr in (-1.0, float(np.median(d["grad_norm"]))):
        em = em.replace(threshold=torch.tensor(thr))
        ids = t2n(tDF.field_id(tDF.build_distance_field(em, R, H, W), kmax))
        use = np.ones(K, bool) if thr < 0 else d["grad_norm"] >= thr
        idf, _ = oracle.build_distance_field(list(d["pos"]), d["grad"], d["grad_norm"], use, R,
                                             H, W)
        np.testing.assert_array_equal(ids, idf)


def test_try_vel_plain_matches_oracle():
    """K2's plain tryVel pass on the raster table (tracker.try_vel on CPU
    tensors: kernels.try_vel_plain at field_scale 1) against oracle.try_vel
    on the same id field: tests/test_tracker.py's tolerances."""
    rng, old, old_d, new, new_d, ids, cam, cfg = _raster_setup()
    att = tTr.raster_att(new, ids)
    idf = t2n(ids)
    cam_d = cam_dict(cam.rows, cam.cols, cam.fm)
    cfg_d = dict(search_range=cfg.search_range, reweight_distance=cfg.reweight_distance,
                 match_threshold=cfg.match_threshold)
    K = int(old.count)
    for vel_np in (np.zeros(3), np.array([0.01, -0.02, 0.005])):
        residuals = (np.abs(rng.randn(old.kmax)) * 3).astype(np.float32)
        srm = 8.0
        score, JtJ, JtF, res, mif = tTr.try_vel(
            old, att, torch.as_tensor(vel_np, dtype=torch.float32), torch.tensor(srm),
            torch.as_tensor(residuals), cfg, cam, field_scale=1)
        old_d2 = dict(old_d, valid=t2n(old.valid)[:K])
        o_score, o_JtJ, o_JtF, o_res, o_mif = oracle.try_vel(
            old_d2, new_d, idf, residuals[:K].astype(np.float64), vel_np, srm, cfg_d, cam_d)
        assert np.allclose(float(score), o_score, rtol=1e-3), (float(score), o_score)
        assert np.allclose(t2n(JtJ), o_JtJ, rtol=1e-3, atol=1e-3)
        assert np.allclose(t2n(JtF), o_JtF, rtol=1e-3, atol=1e-3)
        assert np.array_equal(t2n(mif)[:K], o_mif)
        assert (o_mif >= 0).any()
        assert np.allclose(t2n(res)[:K], o_res, rtol=1e-3, atol=1e-4)


def test_minimize_vel_plain_matches_oracle():
    """K2's plain LM solve on the raster table against oracle.minimize_vel
    (float64, numpy's solve): the same velocity to 1e-4 and forward ids."""
    _, old, old_d, new, new_d, ids, cam, cfg = _raster_setup(seed=3, K=100)
    cam_d = cam_dict(cam.rows, cam.cols, cam.fm)
    cfg_d = dict(search_range=cfg.search_range, reweight_distance=cfg.reweight_distance,
                 match_threshold=cfg.match_threshold, iterations=cfg.iterations,
                 quantile_cutoff=cfg.quantile_cutoff)
    vel0 = np.array([0.002, -0.003, 0.001])
    vel, _Rvel, old_m, score = tTr.minimize_vel(old, tTr.raster_att(new, ids),
                                                torch.as_tensor(vel0, dtype=torch.float32),
                                                cfg, cam, 1)
    K = int(old.count)
    o_vel, _o_Rvel, o_mif, o_score = oracle.minimize_vel(dict(old_d), new_d, t2n(ids), vel0,
                                                         cfg_d, cam_d)
    np.testing.assert_allclose(t2n(vel), o_vel, atol=1e-4, rtol=1e-3)
    np.testing.assert_allclose(float(score), o_score, rtol=1e-3)
    assert np.mean(t2n(old_m.match_id_forward)[:K] == o_mif) > 0.97


def test_quantile_matches_oracle():
    rng = np.random.RandomState(3)
    em_j, d = make_random_map(rng, 90, 128, 48, 64)
    em = edge_map_t(em_j)
    for p in (0.5, 0.9):
        got = float(tM.estimate_quantile(em, p, 100))
        want = oracle.estimate_quantile(d["sigma_rho"], d["valid"], p, 100)
        assert np.isclose(got, want, atol=1e-5), (p, got, want)


def _chain(K, kmax):
    id_next = np.full(kmax, -1, np.int32)
    id_prev = np.full(kmax, -1, np.int32)
    id_next[: K - 1] = np.arange(1, K)
    id_prev[1:K] = np.arange(0, K - 1)
    return id_next, id_prev


def _fabricated_matches(rng, d, K, kmax):
    """Random matches as tests/test_tracker.py fabricates them."""
    mid = np.full(kmax, -1, np.int32)
    mid[:K] = rng.randint(0, K, K)
    mpos = d["pos_img"] + rng.randn(K, 2) * 0.5
    mgrad = d["grad"] + rng.randn(K, 2) * 5
    mgn = np.linalg.norm(mgrad, axis=-1)
    pad = ((0, kmax - K), (0, 0))
    return (mid, np.pad(mpos, pad).astype(np.float32), np.pad(mgrad, pad).astype(np.float32),
            np.pad(mgn, (0, kmax - K)).astype(np.float32), mpos, mgrad, mgn)


def test_regularize_plain_matches_oracle():
    """K5's regularization pass (kernels.regularize_plain) against
    oracle.regularize."""
    rng = np.random.RandomState(6)
    K, kmax = 50, 64
    em_j, d = make_random_map(rng, K, kmax, 48, 64)
    id_next, id_prev = _chain(K, kmax)
    em = edge_map_t(em_j).replace(id_next=torch.as_tensor(id_next),
                                  id_prev=torch.as_tensor(id_prev))
    out = tM.regularize_1iter(em, 0.5)
    r, s = oracle.regularize(d["rho"], d["sigma_rho"], d["grad"], d["grad_norm"],
                             id_next[:K], id_prev[:K], d["valid"], 0.5)
    assert np.allclose(t2n(out.rho)[:K], r, rtol=1e-4, atol=1e-5)
    assert np.allclose(t2n(out.sigma_rho)[:K], s, rtol=1e-4, atol=1e-5)
    assert not np.allclose(r, d["rho"])


def test_update_inverse_depth_plain_matches_oracle():
    """K5's depth EKF (kernels.ekf_plain) against
    oracle.update_inverse_depth_arlu, keyline by keyline."""
    rng = np.random.RandomState(5)
    K, kmax = 40, 64
    em_j, d = make_random_map(rng, K, kmax, 48, 64)
    mid, mpos_p, mgrad_p, mgn_p, mpos, mgrad, mgn = _fabricated_matches(rng, d, K, kmax)
    em = edge_map_t(em_j).replace(match_id=torch.as_tensor(mid),
                                  match_pos_img=torch.as_tensor(mpos_p),
                                  match_grad=torch.as_tensor(mgrad_p),
                                  match_grad_norm=torch.as_tensor(mgn_p))
    cam, cfg = _cam(48, 64), tcfg.CoreConfig()
    vel = np.array([0.02, -0.01, 0.003])
    out = tTr.update_inverse_depth(em, torch.as_tensor(vel, dtype=torch.float32), cfg, cam)
    cam_d = cam_dict(48, 64, cam.fm)
    cfg_d = dict(reshape_q_abs=cfg.reshape_q_abs, pixel_uncertainty=cfg.pixel_uncertainty)
    for i in range(K):
        kl = dict(pos_img=d["pos_img"][i], match_pos_img=mpos[i], match_grad=mgrad[i],
                  match_grad_norm=mgn[i], rho=d["rho"][i], sigma_rho=d["sigma_rho"][i])
        r, s = oracle.update_inverse_depth_arlu(kl, vel, cfg_d, cam_d)
        assert np.isclose(float(out.rho[i]), r, rtol=1e-3, atol=1e-5), i
        assert np.isclose(float(out.sigma_rho[i]), s, rtol=1e-3, atol=1e-5), i


def test_reg_ekf_plain_matches_oracle():
    """K5 as the walk path runs it (tracker.regularize_and_update_depth:
    kernels.reg_ekf_plain on CPU tensors) against oracle.regularize, then
    oracle.update_inverse_depth_arlu on the matched keylines, as
    oracle_step composes them."""
    rng = np.random.RandomState(7)
    K, kmax = 50, 64
    em_j, d = make_random_map(rng, K, kmax, 48, 64)
    id_next, id_prev = _chain(K, kmax)
    mid, mpos_p, mgrad_p, mgn_p, mpos, mgrad, mgn = _fabricated_matches(rng, d, K, kmax)
    mid[:K:3] = -1          # every third keyline unmatched: regularized, not updated
    em = edge_map_t(em_j).replace(
        id_next=torch.as_tensor(id_next), id_prev=torch.as_tensor(id_prev),
        match_id=torch.as_tensor(mid), match_pos_img=torch.as_tensor(mpos_p),
        match_grad=torch.as_tensor(mgrad_p), match_grad_norm=torch.as_tensor(mgn_p))
    cam, cfg = _cam(48, 64), tcfg.CoreConfig()
    vel = np.array([0.02, -0.01, 0.003])
    thr = 0.5
    out = tTr.regularize_and_update_depth(em, torch.as_tensor(vel, dtype=torch.float32), thr,
                                          cfg, cam)
    r1, s1 = oracle.regularize(d["rho"], d["sigma_rho"], d["grad"], d["grad_norm"],
                               id_next[:K], id_prev[:K], d["valid"], thr)
    cam_d = cam_dict(48, 64, cam.fm)
    cfg_d = dict(reshape_q_abs=cfg.reshape_q_abs, pixel_uncertainty=cfg.pixel_uncertainty)
    for i in range(K):
        r, s = r1[i], s1[i]
        if mid[i] >= 0:
            kl = dict(pos_img=d["pos_img"][i], match_pos_img=mpos[i], match_grad=mgrad[i],
                      match_grad_norm=mgn[i], rho=r, sigma_rho=s)
            r, s = oracle.update_inverse_depth_arlu(kl, vel, cfg_d, cam_d)
        assert np.isclose(float(out.rho[i]), r, rtol=1e-3, atol=1e-5), i
        assert np.isclose(float(out.sigma_rho[i]), s, rtol=1e-3, atol=1e-5), i


@pytest.mark.parametrize("moving", [True, False], ids=["moving", "zero_velocity"])
def test_directed_match_matches_oracle(moving):
    """The pixel walk against oracle.search_match, keyline by keyline, at
    tests/test_matching.py's agreement (97 %)."""
    rng = np.random.RandomState(1 if moving else 2)
    H, W, K, kmax = 64, 96, 120, 128
    new_j, new_d = make_random_map(rng, K, kmax, H, W)
    old_j, old_d = make_random_map(rng, K, kmax, H, W)
    cam = _cam(H, W)
    core_cfg, em_cfg = tcfg.CoreConfig(search_range=10), tcfg.EdgeMapConfig()
    cam_d = cam_dict(H, W, cam.fm)
    cfg_d = dict(pixel_uncertainty_match=em_cfg.pixel_uncertainty_match,
                 match_threshold_norm=em_cfg.match_threshold_norm,
                 match_threshold_angle=em_cfg.match_threshold_angle)
    if moving:
        from rebvio_tpu_torch.geometry import so3

        Rback = so3.exp(torch.tensor([0.005, -0.008, 0.002])).numpy().astype(np.float64)
        vel, Rvel = np.array([0.01, -0.02, 0.004]), np.diag([1e-4, 1e-4, 1e-5])
    else:
        Rback, vel, Rvel = np.eye(3), np.zeros(3), np.eye(3) * 1e-6
    out, n = tM.directed_match(edge_map_t(new_j), edge_map_t(old_j),
                               *(torch.as_tensor(np.asarray(a, np.float32))
                                 for a in (vel, Rvel, Rback)), em_cfg, core_cfg, cam)
    got = t2n(out.match_id)[:K]
    vel_b, Rvel_b = Rback @ vel, Rback @ Rvel @ Rback.T
    want = np.empty(K, np.int32)
    for i in range(K):
        kl = dict(pos_img=new_d["pos_img"][i], rho=new_d["rho"][i],
                  sigma_rho=new_d["sigma_rho"][i], grad=new_d["grad"][i],
                  grad_norm=new_d["grad_norm"][i])
        want[i] = oracle.search_match(kl, old_d, vel_b, Rvel_b, Rback, core_cfg.search_range,
                                      cfg_d, cam_d)
    assert np.mean(got == want) >= 0.97
    assert int(n) == int((got >= 0).sum())


def test_pipeline_matches_composed_oracle():
    """tests/test_oracle_pipeline.py's contract for the port: the runner on
    the reference-semantics configuration (raster field, pixel walk, no IMU)
    over 12 synthetic frames at 120x188 / 2048 keylines, against
    oracle.oracle_step fed the port's own scale space (build_scale_space on
    the same frames): per-frame match counts within 5 % from frame 2, and a
    drift below 0.05 of the span."""
    cfg = small_config(tcfg, df_mode="raster", matcher="walk")
    cam, det, core = cfg.camera, cfg.detector, cfg.core
    seq = tsyn.generate(cam, n_frames=N_FRAMES, seed=0)
    res = VioRunner(cfg, undistort=False, device="cpu").run(seq)
    assert res.run_ok.all()

    cfg_det = dict(plane_fit_size=det.plane_fit_size, pos_neg_threshold=det.pos_neg_threshold,
                   max_image_value=det.max_image_value, dog_threshold=det.dog_threshold,
                   keylines_max=det.keylines_max, keylines_ref=det.keylines_ref,
                   gain=det.gain, min_threshold=det.min_threshold,
                   max_threshold=det.max_threshold)
    cfg_core = dict(search_range=core.search_range, reweight_distance=core.reweight_distance,
                    match_threshold=core.match_threshold, iterations=core.iterations,
                    quantile_cutoff=core.quantile_cutoff,
                    pixel_uncertainty=core.pixel_uncertainty,
                    reshape_q_abs=core.reshape_q_abs,
                    global_min_matches_threshold=core.global_min_matches_threshold)
    em = cfg.edge_map
    cfg_em = dict(pixel_uncertainty_match=em.pixel_uncertainty_match,
                  match_threshold_norm=em.match_threshold_norm,
                  match_threshold_angle=em.match_threshold_angle,
                  regularization_threshold=em.regularization_threshold)
    cam_d = dict(rows=cam.rows, cols=cam.cols, fm=cam.fm, cx=cam.cx, cy=cam.cy)

    mats = frontend_matrices(cfg, "cpu")
    st = dict(map=None, threshold=det.threshold, keylines_count=0, R_global=np.eye(3),
              Pos=np.zeros(3), run_ok=True)
    pos_o, nm_o = [], []
    for i in range(N_FRAMES):
        img = torch.as_tensor(seq.images[i] * cfg.image_gain, dtype=torch.float32)
        _s0, dog, mag = build_scale_space(img, mats)
        st, odo = oracle.oracle_step(st, t2n(dog).astype(np.float64),
                                     t2n(mag).astype(np.float64), cfg_det, cfg_core, cfg_em,
                                     cam_d)
        pos_o.append(odo["position"])
        nm_o.append(odo["num_matches"])
        assert odo["run_ok"], i
    pos_o = np.stack(pos_o)
    nm_o = np.asarray(nm_o)

    nm_p = res.num_matches
    for i in range(2, N_FRAMES):
        assert abs(int(nm_p[i]) - int(nm_o[i])) <= 0.05 * max(nm_o[i], 1), (i, nm_p[i], nm_o[i])
    span = float(np.linalg.norm(seq.gt_pos[:N_FRAMES].max(0) - seq.gt_pos[:N_FRAMES].min(0)))
    drift = tev.ate_rmse(res.position, pos_o, align=False)
    assert drift < 0.05 * span, (drift, span)
