"""The per-frame step, a frozen copy of ``rebvio_tpu_torch/pipeline.py``
(rebvio_tpu/pipeline.py; reference
``Rebvio::stateEstimationProcess``, rebvio.cpp:92-293).

    step(state, frame, imu, frame_dt, config) -> (state', odometry)

Eager PyTorch that never syncs the host: as in JAX, ``estimate`` runs on
every frame and the first-frame, failure-latch and recovery choices are
device selects, so the step can be captured into a CUDA graph
(``runner.VioRunner``).  Both fields (``df_mode``: "jfa", the jump-flood
attribute field; "raster", the reference's rasterized id field) and both
matchers (``matcher``: "tube" on the jfa field; "walk", the reference's
pixel walk), with and without the IMU (``PipelineConfig().use_imu``).

The step's body is written once, as generators that yield the name of each
stage of ``STAGES`` once its operations are issued (``step_stages``); the
public functions run them to their end (``types.finish``), and
tools/profile_stages.py times the prefixes.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from vio_bench.reference import types as T
from vio_bench.reference.configs import PipelineConfig
from vio_bench.reference import linalg, so3
from vio_bench.reference import distance_field as DF
from vio_bench.reference import edge_detect, imu as imu_ops, kernels, matching, sab, tracker
from vio_bench.reference.scale_space import FrontendMatrices, ScaleSpaceParams

_F32_MAX = torch.finfo(torch.float32).max
_SS_CACHE = {}
f32 = torch.float32
# the stage boundaries at which ``step_stages`` yields: the JAX package's
# tools/profile_stages.py's nine stages plus "sab" (the gyro-bias fusion,
# the composed motion, the acceleration estimators, the SAB filter K3 and
# the second rotation of the old map).  With df_mode "jfa", "detect" ends
# before the flood's seed stack, which "att_field" builds and floods (K1);
# with the tube matcher "directed_match" is the epipolar geometry and K4,
# "reg+ekf(fused)" K5 with the matcher's tail and the failure gate;
# "(product path)" is the pose integration and ``advance``'s device selects
STAGES = ("detect", "att_field", "imu+rotate", "minimize_vel", "forward_match", "ext_rot_vel",
          "sab", "directed_match", "reg+ekf(fused)", "(product path)")


def frontend_matrices(config: PipelineConfig, device="cuda") -> FrontendMatrices:
    """Banded frontend operators for this camera geometry, on ``device``."""
    key = (config.camera.rows, config.camera.cols, config.detector.plane_fit_size)
    if key not in _SS_CACHE:
        _SS_CACHE[key] = ScaleSpaceParams(*key)
    return _SS_CACHE[key].matrices(device)


def _check_config(config: PipelineConfig):
    """JAX's rule (rebvio_tpu/pipeline.py:229): the tube matcher probes the
    jump-flood field, so it needs ``df_mode="jfa"``."""
    if config.df_mode not in ("jfa", "raster") or config.matcher not in ("tube", "walk"):
        raise ValueError(f"unknown df_mode {config.df_mode!r} or matcher {config.matcher!r}")
    if config.matcher == "tube" and config.df_mode != "jfa":
        raise ValueError("tube matcher requires the JFA field")


def detect_map(frame: torch.Tensor, threshold: torch.Tensor, mats: FrontendMatrices,
               config: PipelineConfig) -> T.EdgeMap:
    """Keyline detection at ``threshold``; with ``df_mode="jfa"`` also the
    attribute field (rebvio.cpp:56-75, 142).  The raster field is built from
    the map in ``estimate``, as in JAX."""
    return T.finish(detect_map_stages(frame, threshold, mats, config))


def detect_map_stages(frame: torch.Tensor, threshold: torch.Tensor, mats: FrontendMatrices,
                      config: PipelineConfig):
    """``detect_map`` as a stage generator: "detect", then with the jfa
    field "att_field" (the dense seed stack and the flood)."""
    cam = config.camera
    if config.df_mode != "jfa":
        new_map = edge_detect.detect(frame, threshold, mats, config.detector, cam,
                                     field_scale=config.field_scale)
        yield "detect"
        return new_map
    sr = config.core.search_range_px
    new_map, (xs, ys, t0, t1) = edge_detect._detect_core(frame, threshold, mats,
                                                         config.detector, cam,
                                                         config.field_scale)
    yield "detect"
    H, W = frame.shape
    stack = DF.seed_stack_dense(new_map.kl_id_img, xs, ys, t0, t1, new_map.threshold, sr, H, W,
                                config.field_scale)
    att = DF.build_att_field(new_map, sr, cam.rows, cam.cols, config.field_scale,
                             seed_stack=stack)
    yield "att_field"
    return new_map.replace(att_img=att)


def detect_frame(state: T.VioState, frame: torch.Tensor, mats: FrontendMatrices,
                 config: PipelineConfig):
    """Frontend: the auto-gain threshold, then ``detect_map``."""
    return T.finish(detect_frame_stages(state, frame, mats, config))


def detect_frame_stages(state: T.VioState, frame: torch.Tensor, mats: FrontendMatrices,
                        config: PipelineConfig):
    """``detect_frame`` as a stage generator (``detect_map_stages``)."""
    threshold = edge_detect.autogain_threshold(state.detector_threshold,
                                               state.keylines_count, config.detector)
    new_map = yield from detect_map_stages(frame, threshold, mats, config)
    return new_map, threshold


def _imu_constants(config: PipelineConfig, dev) -> dict:
    """The camera extrinsics and the filter's constant tensors on ``dev``,
    uploaded once (a per-frame host-to-device copy would sync the host)."""
    key = ("imu", config.camera, config.imu, str(dev))
    if key not in _SS_CACHE:
        cam, icfg = config.camera, config.imu
        up = {"R_c2i": cam.R_c2i_np(), "t_c2i": cam.t_c2i_np(),
              "bias_guess": icfg.init_bias_guess, "one": 1.0,
              "Rg": icfg.g_norm_uncertainty ** 2, "g_norm": icfg.g_norm,
              "ex": [1.0, 0.0, 0.0], "ey": [0.0, 1.0, 0.0]}
        _SS_CACHE[key] = {k: torch.as_tensor(np.asarray(v, np.float32)).to(dev)
                          for k, v in up.items()}
    return _SS_CACHE[key]


def estimate(state: T.VioState, old_map: T.EdgeMap, new_map: T.EdgeMap,
             imu_data: T.ImuFrameData, frame_dt: torch.Tensor,
             config: PipelineConfig) -> Tuple[T.VioState, T.Odometry]:
    """One estimation iteration over an (old, new) map pair.  With
    ``config.use_imu`` the bias-init window, the gyro prior, the gyro-bias
    fusion, the SAB filter (kernel K3) and the gravity-aligned pose run as
    device-side selects: no host sync decides them."""
    return T.finish(estimate_stages(state, old_map, new_map, imu_data, frame_dt, config))


def estimate_stages(state: T.VioState, old_map: T.EdgeMap, new_map: T.EdgeMap,
                    imu_data: T.ImuFrameData, frame_dt: torch.Tensor, config: PipelineConfig):
    """``estimate`` as a stage generator: with the raster field
    "att_field" first, then "imu+rotate" through "reg+ekf(fused)"."""
    _check_config(config)
    cam = config.camera
    core_cfg = config.core
    icfg = config.imu
    fm = cam.fm
    ist = state.imu_state
    sst = state.sab_state
    use_imu = config.use_imu
    dev = state.Pos.device
    z = dict(dtype=f32, device=dev)
    eye3 = torch.eye(3, **z)

    # the new map's field for the tracker: the attribute field, or the
    # full-resolution raster id field as K2's table
    if config.df_mode == "jfa":
        att, field_scale = new_map.att_img, config.field_scale
    else:
        field = DF.build_distance_field(new_map, core_cfg.search_range_px, cam.rows, cam.cols)
        att, field_scale = tracker.raster_att(new_map, DF.field_id(field, new_map.kmax)), 1
        yield "att_field"

    Bg, W_Bg, sab_X = ist.Bg, ist.W_Bg, sst.X
    initialized = ist.initialized
    gyro_acc, g_acc, n_init = ist.gyro_init_acc, ist.g_init_acc, ist.num_gyro_init
    if use_imu:
        c = _imu_constants(config, dev)
        ii = imu_ops.integrate_imu(imu_data, c["R_c2i"], c["t_c2i"])
        # --- bias init window (rebvio.cpp:146-160) ---
        if icfg.init_bias > 0:
            in_init = (~ist.initialized) & (state.num_frames > 0)
            gyro_acc = torch.where(in_init, ist.gyro_init_acc + ii.gyro * ii.dt_s,
                                   ist.gyro_init_acc)
            g_acc = torch.where(in_init, ist.g_init_acc - ii.cacc, ist.g_init_acc)
            n_init = torch.where(in_init, ist.num_gyro_init + 1, ist.num_gyro_init)
            done = in_init & (n_init > icfg.init_bias_frame_num)
            nf = torch.clamp(n_init.to(f32), min=1.0)
            Bg = torch.where(done, gyro_acc / nf, Bg)
            W_Bg = torch.where(done, linalg.invert3(ist.RGBias * 1e2), W_Bg)
            sab_X = torch.where(done, torch.cat([sab_X[:1], g_acc / nf, sab_X[4:]]), sab_X)
            initialized = ist.initialized | done
        else:
            newly = (~ist.initialized) & (state.num_frames > 0)
            Bg = torch.where(newly, c["bias_guess"] * ii.dt_s, Bg)
            initialized = ist.initialized | newly
        # gyro-bias-corrected inter-frame rotation prior (rebvio.cpp:163-164)
        R_prior_T = so3.exp(Bg) @ ii.R.T
        cacc = ii.cacc
    else:
        R_prior_T = eye3
        cacc = torch.zeros(3, **z)

    # forward-rotate old keylines by the rotation prior (rebvio.cpp:165)
    old_map = matching.rotate_keylines(old_map, R_prior_T, fm)
    yield "imu+rotate"
    # translation-only LM against the new map's field (rebvio.cpp:142, 169)
    Vg = torch.zeros(3, **z)
    Vg, _P_Vg, old_map, _score = tracker.minimize_vel(old_map, att, Vg, core_cfg, cam,
                                                      field_scale)
    yield "minimize_vel"
    # forward matching into the new map (rebvio.cpp:172)
    new_map, _nfm = matching.forward_match(old_map, new_map)
    yield "forward_match"
    # 6-DoF linear refinement (rebvio.cpp:177)
    Xgv, W_Xgv = tracker.ext_rot_vel(new_map, Vg, core_cfg, cam)
    yield "ext_rot_vel"

    # gyro bias correction (rebvio.cpp:186-190)
    bias_dt = icfg.gyro_bias_std_dev * frame_dt
    RGBias = eye3 * (bias_dt * bias_dt)
    if use_imu:
        gyro_dt = icfg.gyro_std_dev * frame_dt
        Xgv, W_Xgv, W_Bg, dgbias = tracker.gyro_bias_correction(
            Xgv, W_Xgv, W_Bg, eye3 * (gyro_dt * gyro_dt), RGBias)
        Bg = Bg + dgbias
    dVgv, dWgv = Xgv[0:3], Xgv[3:6]
    # compose the visually corrected motion (rebvio.cpp:192-200)
    R0 = so3.exp(dWgv)
    R = (R0 @ R_prior_T).T
    Vgv = R0 @ Vg + dVgv
    R_Xgv = linalg.chol_inverse(W_Xgv)
    P_V, P_W = R_Xgv[0:3, 0:3], R_Xgv[3:6, 3:6]

    # acceleration estimators (rebvio.cpp:203-204)
    dt_safe = torch.clamp(frame_dt, min=1e-6)
    Av, vel_hist, dt_hist = imu_ops.estimate_ls4_acceleration(
        -Vgv / dt_safe, R, frame_dt, ist.vel_hist, ist.dt_hist)
    As, acc_hist = imu_ops.estimate_mean_acceleration(cacc, R, ist.acc_hist)

    # SAB scale filter (rebvio.cpp:206-233): K3 runs on every estimated
    # frame and its result is selected once the filter is engaged
    K, P_Kp = state.K, state.P_Kp
    sab_P, g_est, b_est = sst.P, sst.g_est, sst.b_est
    Xgva = Xgv
    if use_imu:
        engaged = state.num_frames > (4 + icfg.init_bias_frame_num)
        dt2 = dt_safe * dt_safe
        out = sab.estimate_bias(
            As, Av, c["one"], R, sab_X, sab_P, eye3 * icfg.g_uncertainty ** 2, P_W,
            eye3 * icfg.vbias_std_dev ** 2, P_Kp, c["Rg"], eye3 * icfg.acc_std_dev ** 2,
            P_V / (dt2 * dt2), W_Xgv, Xgva, c["g_norm"], iters=icfg.sab_iterations)
        K = torch.where(engaged, out.K, K)
        sab_X = torch.where(engaged, out.X, sab_X)
        sab_P = torch.where(engaged, out.P, sab_P)
        g_est = torch.where(engaged, out.g_est, g_est)
        b_est = torch.where(engaged, out.b_est, b_est)
        Xgva = torch.where(engaged, out.Xvw, Xgva)

    dVgva, dWgva = Xgva[0:3], Xgva[3:6]
    R0gva = so3.exp(dWgva)
    # engaged: Rgva.T = R0gva @ R_prior.T ; else Rgva = R (rebvio.cpp:193,217-232)
    Rgva = (R0gva @ R_prior_T).T
    Vgva = R0gva @ Vg + dVgva
    # second forward rotation of the old map (rebvio.cpp:223,232)
    old_map = matching.rotate_keylines(old_map, R0gva, fm)

    # failure gates (rebvio.cpp:236-252) as device flags, the matcher and
    # regularization + depth EKF on success (rebvio.cpp:245, 256-259): always
    # run, as JAX always matches and regularizes, so no host sync decides them
    fail_nan = torch.isnan(Vgva).any()
    yield "sab"
    if config.matcher == "tube":
        # the tube matcher (K4) and, in one call of K5, its tail, the gates
        # and the depth stage; the exact gradient replay of the two in-flight
        # rotations of the old map
        Mg = R0gva[:2, :2] @ R_prior_T[:2, :2]
        new_map_post, klm, failed = yield from matching.match_and_update_depth_stages(
            new_map, old_map, Vgva, P_V, Rgva, fail_nan, config.edge_map, core_cfg, cam,
            field_scale=config.field_scale, grad_rot2=Mg)
    else:
        # the pixel walk, the gates, then K5 alone (rebvio_tpu/pipeline.py:238-250)
        walked, klm = matching.directed_match(new_map, old_map, Vgva, P_V, Rgva,
                                              config.edge_map, core_cfg, cam)
        new_map_post = _select_planes(fail_nan, new_map, walked, kernels.MATCH_PLANES)
        klm = torch.where(fail_nan, torch.zeros_like(klm), klm)
        failed = fail_nan | (klm < core_cfg.global_min_matches_threshold)
        yield "directed_match"
        reg = tracker.regularize_and_update_depth(
            new_map_post, Vgva, config.edge_map.regularization_threshold, core_cfg, cam)
        new_map_post = _select_planes(failed, new_map_post, reg, ("rho", "sigma_rho"))
    yield "reg+ekf(fused)"
    P_Kp = torch.where(failed, _F32_MAX, P_Kp)

    # global pose integration (rebvio.cpp:263-271)
    u_est = ist.u_est
    if use_imu:
        # gravity-aligned, once the SAB filter is engaged
        u1 = Rgva.T @ ist.u_est
        gden = torch.clamp(torch.dot(g_est, g_est), min=1e-20)
        u1 = u1 - (torch.dot(u1, g_est) / gden) * g_est
        u1 = u1 / torch.clamp(torch.linalg.norm(u1), min=1e-20)
        R1 = so3.rotation_between(g_est, c["ey"])
        R2 = so3.rotation_between(R1 @ u1, c["ex"])
        R_global_new = R2 @ R1
        Pos_new = state.Pos - R_global_new @ Vgva * K
        R_global = torch.where(engaged, R_global_new, state.R_global)
        Pos = torch.where(engaged, Pos_new, state.Pos)
        u_est = torch.where(engaged, u1, ist.u_est)
    else:
        # vision-only: compose the inter-frame motion (R_wc,new = R_wc,old @ Rgva)
        R_global = state.R_global @ Rgva
        Pos = state.Pos - R_global @ Vgva * K
    run_ok = state.run_ok & ~failed
    new_state = state.replace(
        edge_map=new_map_post,
        imu_state=ist.replace(Bg=Bg, W_Bg=W_Bg, RGBias=RGBias, u_est=u_est,
                              initialized=initialized, num_gyro_init=n_init,
                              gyro_init_acc=gyro_acc, g_init_acc=g_acc,
                              vel_hist=vel_hist, dt_hist=dt_hist, acc_hist=acc_hist),
        sab_state=sst.replace(X=sab_X, P=sab_P, g_est=g_est, b_est=b_est),
        K=K, Pos=Pos, R_global=R_global, P_Kp=P_Kp,
        num_frames=state.num_frames + 1,
        run_ok=run_ok,
    )
    odo = T.Odometry(orientation=so3.log(R_global), position=Pos,
                     num_matches=klm.to(torch.int32), run_ok=run_ok)
    return new_state, odo


def _select_planes(cond: torch.Tensor, a: T.EdgeMap, b: T.EdgeMap, names) -> T.EdgeMap:
    """``b`` with its planes ``names`` taken from ``a`` where ``cond`` ([]
    bool) holds: T.tree_where over the planes that can differ."""
    return b.replace(**{k: torch.where(cond, getattr(a, k), getattr(b, k)) for k in names})


def advance(state: T.VioState, new_map: T.EdgeMap, threshold: torch.Tensor,
            imu_data: T.ImuFrameData, frame_dt: torch.Tensor,
            config: PipelineConfig) -> Tuple[T.VioState, T.Odometry]:
    """Everything after detection: estimation, first-frame handling, the
    failure latch and recovery, bookkeeping (rebvio.cpp:119-292).  As in JAX
    (rebvio_tpu/pipeline.py:451-489), ``estimate`` always runs and its result
    is selected on the device."""
    return T.finish(advance_stages(state, new_map, threshold, imu_data, frame_dt, config))


def advance_stages(state: T.VioState, new_map: T.EdgeMap, threshold: torch.Tensor,
                   imu_data: T.ImuFrameData, frame_dt: torch.Tensor, config: PipelineConfig):
    """``advance`` as a stage generator: ``estimate_stages``, then the
    selects, "(product path)"."""
    est_state, est_odo = yield from estimate_stages(state, state.edge_map, new_map, imu_data,
                                                    frame_dt, config)
    # first frame: only store the detection (rebvio.cpp:122-131)
    first_state = state.replace(edge_map=new_map)
    idle_odo = T.Odometry(orientation=so3.log(state.R_global), position=state.Pos,
                          num_matches=torch.zeros_like(est_odo.num_matches),
                          run_ok=state.run_ok)
    is_first = state.frames_seen == 0
    frozen = ~state.run_ok      # failure latch (rebvio.cpp:241,252)
    use_est = ~is_first & ~frozen
    out_state = T.tree_where(use_est, est_state, first_state)
    odo = T.tree_where(use_est, est_odo, idle_odo)
    if config.recover_on_failure:
        # re-seed from the fresh detection with cleared histories
        ist0 = state.imu_state
        recovered = out_state.replace(
            edge_map=new_map,
            imu_state=ist0.replace(vel_hist=torch.zeros_like(ist0.vel_hist),
                                   dt_hist=torch.zeros_like(ist0.dt_hist),
                                   acc_hist=torch.zeros_like(ist0.acc_hist)),
            run_ok=torch.ones_like(state.run_ok))
        out_state = T.tree_where(frozen, recovered, out_state)
    out_state = out_state.replace(frames_seen=state.frames_seen + 1,
                                  detector_threshold=threshold,
                                  keylines_count=new_map.count)
    yield "(product path)"
    return out_state, odo


def step(state: T.VioState, frame: torch.Tensor, imu_data: T.ImuFrameData, frame_dt,
         config: PipelineConfig, mats: FrontendMatrices = None):
    """Process one frame: detect keylines, then run the estimation iteration
    and select its result on the device.  ``frame_dt``: a [] float32 tensor on
    the state's device (the runner's staging slot) or a Python float, filled
    on the device (no upload)."""
    return T.finish(step_stages(state, frame, imu_data, frame_dt, config, mats))


def step_stages(state: T.VioState, frame: torch.Tensor, imu_data: T.ImuFrameData, frame_dt,
                config: PipelineConfig, mats: FrontendMatrices = None):
    """``step`` as a generator that yields each name of ``STAGES`` in order
    once that stage's operations are issued, and returns (state',
    odometry)."""
    _check_config(config)
    dev = state.Pos.device
    if mats is None:
        mats = frontend_matrices(config, dev)
    if not torch.is_tensor(frame_dt):
        frame_dt = torch.full((), frame_dt, dtype=f32, device=dev)
    new_map, threshold = yield from detect_frame_stages(state, frame, mats, config)
    return (yield from advance_stages(state, new_map, threshold, imu_data, frame_dt, config))
