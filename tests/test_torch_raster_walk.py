"""The reference-semantics step on the CPU against the JAX package: the
rasterized distance field (``df_mode="raster"``) and the pixel-walk matcher
(``matcher="walk"``), each op and then the step, with ``jfa`` + ``walk``
beside them (the runner, the pipelined chunk and the CLI:
tests/test_torch_pipelined.py).  Inputs
come from seeded numpy at the small preset (120x188, 2048 keylines); the
Pallas kernels JAX reaches run in interpret mode.

Run as a script, this file writes the JAX goldens that chip_smoke.py holds
the port to on the card (Pallas in interpret mode, then the XLA path, whose
spread it prints; JAX's cross-ATE against the reference binary too): the
reference-semantics step streaming and in pipelined chunks, VO and VIO, and
the fast profile's VIO stream (all of them without arguments):

    JAX_PLATFORMS=cpu python tests/test_torch_raster_walk.py [vo] [vio] \
        [vo_pipelined] [vio_pipelined] [fast]
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from torch_helpers import (PALLAS_FLAGS, edge_map_t, empty_window, jax_windows,  # noqa: E402
                           make_random_map, map_from_table, small_config, small_frame_pair, t2n,
                           to_np, use_pallas, variant_configs)

import rebvio_tpu.configs as jcfg  # noqa: E402
import rebvio_tpu_torch.configs as tcfg  # noqa: E402
from rebvio_tpu import pipeline as jpipe, types as jT  # noqa: E402
from rebvio_tpu.data import synthetic as jsyn  # noqa: E402
from rebvio_tpu.ops import distance_field as jDF, matching as jM  # noqa: E402
from rebvio_tpu.ops import tracker as jTr  # noqa: E402
from rebvio_tpu_torch import camera as tcam, interop, pipeline as tpipe  # noqa: E402
from rebvio_tpu_torch import eval as tev  # noqa: E402
from rebvio_tpu_torch import types as tT  # noqa: E402
from rebvio_tpu_torch.data import synthetic as tsyn  # noqa: E402
from rebvio_tpu_torch.ops import distance_field as tDF  # noqa: E402
from rebvio_tpu_torch.ops import matching as tM, tracker as tTr  # noqa: E402
from rebvio_tpu_torch.runner import VioRunner  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
DATA = REPO / "tests" / "data"
VO_GOLDEN = DATA / "torch_golden_rw_vo_euroc_seed0_24.txt"
VIO_GOLDEN = DATA / "torch_golden_rw_vio_euroc_seed0_120.txt"
VO_PIPE_GOLDEN = DATA / "torch_golden_rw_vo_pipelined5_euroc_seed0_24.txt"
VIO_PIPE_GOLDEN = DATA / "torch_golden_rw_vio_pipelined8_euroc_seed0_120.txt"
FAST_GOLDEN = DATA / "torch_golden_fast_vio_euroc_seed0_60.txt"
REF_GOLDEN = DATA / "anchor_ref_trajectory_seed0_120.txt"
VIO_FLAGS = PALLAS_FLAGS + ("SAB",)
ODO = ("orientation", "position", "num_matches", "run_ok")
VARIANTS = [("raster", "walk"), ("jfa", "walk")]


def _tcam_core(jc):
    cam = tcfg.CameraConfig(**{k: getattr(jc.camera, k) for k in jc.camera.__dataclass_fields__})
    core = tcfg.CoreConfig(**{k: getattr(jc.core, k) for k in jc.core.__dataclass_fields__})
    return cam, core


# ---------------------------------------------------------------------------
# the rasterized field


@pytest.mark.parametrize("R,unique,thr", [(3, True, None), (8, False, None), (20, False, None),
                                          (8, False, "median")],
                         ids=["R3", "R8_shared_cells", "R20_shared_cells", "R8_gated"])
def test_distance_field_matches_jax(R, unique, thr):
    """build_distance_field and field_id bit for bit: several keylines per
    cell (positions free of the one-per-pixel rule, and a second half of the
    table on the first half's cells: equal distances, the larger id wins),
    rays leaving the image (keylines within R of every border), the map's
    threshold gate."""
    rng = np.random.RandomState(R)
    H, W, K, kmax = 48, 64, 100, 128
    jem, tem = make_random_map(rng, K, kmax, H, W, margin=1, unique_cells=unique)
    if not unique:
        pos = np.asarray(jem.pos).copy()
        pos[K // 2:K] = pos[:K - K // 2] + rng.uniform(-0.3, 0.3, (K - K // 2, 2))
        grad = np.asarray(jem.grad)[:K]
        jem, tem = map_from_table(pos[:K], grad, kmax, H, W)
    if thr is not None:
        t = float(np.median(np.asarray(jem.grad_norm)[:K]))
        jem = jem.replace(threshold=jnp.asarray(t, jnp.float32))
        tem = tem.replace(threshold=torch.tensor(t))
    jf = np.asarray(jDF.build_distance_field(jem, R, H, W))
    tf = tDF.build_distance_field(tem, R, H, W)
    assert tf.dtype == torch.int32 and tf.shape == (H * W,)
    np.testing.assert_array_equal(t2n(tf), jf)
    np.testing.assert_array_equal(t2n(tDF.field_id(tf, kmax)),
                                  np.asarray(jDF.field_id(jnp.asarray(jf), kmax)))
    filled = (jf >= 0).mean()
    assert 0.05 < filled < 0.98
    # rays off the image were dropped, not wrapped: some keyline's ray leaves it
    gn = np.asarray(jem.grad_norm)[:K, None]
    u = np.asarray(jem.grad)[:K] / gn
    ends = np.asarray(jem.pos)[:K, None, :] + u[:, None, :] * np.array([-R, R - 1])[None, :, None]
    assert ((ends[..., 0] < 0) | (ends[..., 0] >= W) | (ends[..., 1] < 0)
            | (ends[..., 1] >= H)).any()


def test_distance_field_tie_rule():
    """Two keylines writing one pixel at equal distance: the larger id wins,
    as the sequential loop's last writer (tests/test_distance_field.py)."""
    H, W, kmax = 16, 16, 8
    pos = np.array([[5.0, 8.0], [11.0, 8.0]], np.float32)
    grad = np.array([[1.0, 0.0], [1.0, 0.0]], np.float32)
    jem, tem = map_from_table(pos, grad, kmax, H, W)
    ids = t2n(tDF.field_id(tDF.build_distance_field(tem, 3, H, W), kmax))
    want = np.asarray(jDF.field_id(jDF.build_distance_field(jem, 3, H, W), kmax))
    np.testing.assert_array_equal(ids, want)
    assert ids[8 * W + 8] == 1          # 3 px from keyline 0 and from keyline 1


# ---------------------------------------------------------------------------
# the pixel walk


@pytest.fixture(scope="module")
def walk_pair():
    """A real small frame pair as JAX maps, with evolved depths on the old
    map, rotated by a small rotation: (new, old, JAX config)."""
    with pytest.MonkeyPatch.context() as mp:
        m0, m1, jc = small_frame_pair(mp)
        rng = np.random.RandomState(11)
        K = m0.kmax
        m0 = m0.replace(rho=jnp.asarray(rng.uniform(0.3, 1.5, K).astype(np.float32)),
                        sigma_rho=jnp.asarray(rng.uniform(0.05, 1.0, K).astype(np.float32)),
                        matches=jnp.asarray(rng.randint(0, 7, K).astype(np.int32)),
                        match_id_keyframe=jnp.asarray(rng.randint(-1, 30, K).astype(np.int32)))
        yield m1, m0, jc
        jax.clear_caches()


def _so3(w):
    from rebvio_tpu.geometry import so3

    return np.asarray(so3.exp(jnp.asarray(w, jnp.float32)))


def _walk_both(new_j, old_j, jc, vel, Rvel, Rback, em_cfg=None):
    cam, core = _tcam_core(jc)
    em_j = em_cfg or jc.edge_map
    em_t = tcfg.EdgeMapConfig(**{k: getattr(em_j, k) for k in em_j.__dataclass_fields__})
    args = [np.array(a, np.float32) for a in (vel, Rvel, Rback)]
    jm, jn = jM.directed_match(new_j, old_j, *(jnp.asarray(a) for a in args), em_j, jc.core,
                               jc.camera)
    tm, tn = tM.directed_match(edge_map_t(new_j), edge_map_t(old_j),
                               *(torch.as_tensor(a) for a in args), em_t, core, cam)
    return jm, int(jn), tm, int(tn)


_WALK_PLANES = ("rho", "sigma_rho", "match_id", "matches", "match_pos_img", "match_grad",
                "match_grad_norm", "match_id_keyframe")


@pytest.mark.parametrize("vel,w", [((0.004, -0.006, 0.003), (0.002, -0.003, 0.001)),
                                   ((0.0, 0.0, 0.0), (0.0, 0.0, 0.0)),
                                   ((-0.01, 0.004, -0.02), (0.0, 0.004, 0.0))],
                         ids=["moving", "zero_velocity", "forward"])
def test_directed_match_matches_jax(walk_pair, vel, w):
    """match_id and klm exact on a real frame pair (and the fields the
    winners carry), in the epipolar branch and the zero-velocity branch."""
    new, old, jc = walk_pair
    Rvel = np.diag([2e-5, 2e-5, 5e-6])
    jm, jn, tm, tn = _walk_both(new, old, jc, vel, Rvel, _so3(w))
    assert tn == jn > 300
    for k in _WALK_PLANES:
        np.testing.assert_array_equal(t2n(getattr(tm, k)), np.asarray(getattr(jm, k)), err_msg=k)


def test_directed_match_truncates_phase_two():
    """More than WALK_CAP keylines need the full window: the first WALK_CAP
    in index order walk it, the rest keep no match, as
    ``jnp.nonzero(size=CAP)`` truncates.  Each new keyline's only old
    keyline along its gradient sits 12 px away (beyond phase 1's 8), at zero
    velocity (the walk spans the whole window)."""
    H, W, step_y = 30 * 62, 200, 30
    xs = np.arange(3, W - 3, 2, dtype=np.float32)
    ys = np.arange(5, H - 20, step_y, dtype=np.float32)
    new_pos = np.stack(np.meshgrid(xs, ys), -1).reshape(-1, 2)
    K = len(new_pos)
    assert K > tM.WALK_CAP + 500
    grad = np.tile(np.array([[0.0, 120.0]], np.float32), (K, 1))
    kmax = K
    sig = np.full(K, 20.0, np.float32)
    rho = np.ones(K, np.float32)
    new_j, _ = map_from_table(new_pos, grad, kmax, H, W, rho=rho, sigma_rho=sig)
    old_j, _ = map_from_table(new_pos + np.array([0.0, 12.0], np.float32), grad, kmax, H, W,
                              rho=rho, sigma_rho=sig)
    jc = dataclasses.replace(small_config(jcfg), camera=jcfg.CameraConfig(
        rows=H, cols=W, fx=100.0, fy=100.0, cx=W / 2.0, cy=H / 2.0, k1=0, k2=0, k3=0, p1=0,
        p2=0), core=jcfg.CoreConfig(search_range=20))
    jm, jn, tm, tn = _walk_both(new_j, old_j, jc, np.zeros(3), np.eye(3) * 1e-6, np.eye(3))
    assert tn == jn == tM.WALK_CAP
    mid = t2n(tm.match_id)
    np.testing.assert_array_equal(mid, np.asarray(jm.match_id))
    assert (mid[:tM.WALK_CAP] == np.arange(tM.WALK_CAP)).all()
    assert (mid[tM.WALK_CAP:] == -1).all()


# ---------------------------------------------------------------------------
# the tracker's id-field route


@pytest.fixture(scope="module")
def raster_pair():
    with pytest.MonkeyPatch.context() as mp:
        m0, m1, jc = small_frame_pair(mp)
        rng = np.random.RandomState(5)
        K = m0.kmax
        m0 = m0.replace(rho=jnp.asarray(rng.uniform(0.2, 2.0, K).astype(np.float32)),
                        sigma_rho=jnp.asarray(rng.uniform(0.5, 25.0, K).astype(np.float32)))
        yield m0, m1, jc
        jax.clear_caches()


def test_raster_att_table():
    """raster_att: plane 2 the id as float32, planes 3-7 the target keyline's
    grad, grad_norm and pos at the clipped id, planes 0-1 zero."""
    rng = np.random.RandomState(2)
    _, em = make_random_map(rng, 40, 64, 24, 32)
    ids = torch.as_tensor(rng.randint(-1, 64, 24 * 32).astype(np.int32))
    att = tTr.raster_att(em, ids)
    assert att.shape == (8, 24 * 32) and att.dtype == torch.float32
    assert torch.equal(att[:2], torch.zeros(2, 24 * 32))
    assert torch.equal(att[2], ids.to(torch.float32))
    c = ids.clamp(min=0).long()
    for plane, want in ((3, em.grad[c, 0]), (4, em.grad[c, 1]), (5, em.grad_norm[c]),
                        (6, em.pos[c, 0]), (7, em.pos[c, 1])):
        assert torch.equal(att[plane], want), plane


@pytest.mark.parametrize("iterations", [0, 1, 5])
def test_raster_minimize_vel_matches_jax(raster_pair, iterations):
    """tracker.minimize_vel on the raster table (kernel K2's plain version at
    field_scale 1) against JAX's id-field route (use_att=False, two chained
    gathers in XLA), at test_torch_lm_solve.py's tolerances."""
    m0, m1, jc = raster_pair
    H, W = jc.camera.rows, jc.camera.cols
    sr = int(jc.core.search_range)
    jcore = dataclasses.replace(jc.core, iterations=iterations)
    jids = jDF.field_id(jDF.build_distance_field(m1, sr, H, W), m1.kmax)
    v, Rv, old, F = jTr.minimize_vel(m0, m1, jids, jnp.zeros(3, jnp.float32), jcore,
                                     jc.camera, 1, use_att=False)
    cam, core = _tcam_core(jc)
    core = dataclasses.replace(core, iterations=iterations)
    new_t = edge_map_t(m1)
    tids = tDF.field_id(tDF.build_distance_field(new_t, sr, H, W), new_t.kmax)
    np.testing.assert_array_equal(t2n(tids), np.asarray(jids))
    tv, tRv, told, tF = tTr.minimize_vel(edge_map_t(m0), tTr.raster_att(new_t, tids),
                                         torch.zeros(3), core, cam, 1)
    np.testing.assert_allclose(t2n(tv), np.asarray(v), atol=1e-5, rtol=1e-3)
    np.testing.assert_allclose(t2n(tRv), np.asarray(Rv), rtol=1e-3, atol=1e-9)
    np.testing.assert_allclose(float(tF), float(F), rtol=1e-4)
    mif = t2n(told.match_id_forward)
    assert np.mean(mif == np.asarray(old.match_id_forward)) > 0.999
    assert (mif >= 0).sum() > 500


# ---------------------------------------------------------------------------
# the step, against JAX


def _step_both(vio: bool, df_mode: str, matcher: str, n: int):
    """JAX ``pipeline.step`` and the port's over ``n`` small frames from the
    same interop-converted state; VIO on distorted frames, each package
    undistorting with its own Undistorter."""
    with pytest.MonkeyPatch.context() as mp:
        use_pallas(mp, *VIO_FLAGS)
        jc, tc = variant_configs(vio, df_mode, matcher)
        seq = jsyn.generate(jc.camera, n_frames=n, seed=0, distort=vio,
                            imu_preroll_s=0.1 if vio else 0.0)
        jstate = jT.init_vio_state(jc)
        tstate = interop.state_from_numpy(to_np(jstate), device="cpu")
        mats = jpipe.frontend_matrices(jc)
        tmats = interop.matrices_from_numpy(to_np(mats), device="cpu")
        if vio:
            from rebvio_tpu import camera as jcam

            jund = jcam.Undistorter(jc.camera, jc.image_gain)
            tund = tcam.Undistorter(tc.camera, tc.image_gain, device="cpu")
        jout, tout = [], []
        for i, jwin in enumerate(jax_windows(seq, n, jc.imu.sample_max)):
            twin = interop.imu_frame_from_numpy(to_np(jwin), device="cpu")
            dt = 0.0 if i == 0 else float(seq.ts_us[i] - seq.ts_us[i - 1]) / 1e6
            if vio:
                jimg, timg = jund(jnp.asarray(seq.images[i])), tund(torch.as_tensor(seq.images[i]))
            else:
                img = seq.images[i].astype(np.float32) * jc.image_gain
                jimg, timg = jnp.asarray(img), torch.as_tensor(img)
            jstate, jodo = jpipe.step(jstate, jimg, jwin, jnp.float32(dt), jc, mats)
            tstate, todo = tpipe.step(tstate, timg, twin, dt, tc, tmats)
            jout.append({**to_np(jodo), "R_global": np.asarray(jstate.R_global)})
            tout.append({**{k: t2n(getattr(todo, k)) for k in ODO},
                         "R_global": t2n(tstate.R_global)})
        jax.clear_caches()
        return jout, tout, to_np(jstate), interop.to_numpy(tstate)


@pytest.mark.parametrize("vio", [False, True], ids=["vo", "vio"])
@pytest.mark.parametrize("df_mode,matcher", VARIANTS, ids=["raster_walk", "jfa_walk"])
def test_step_matches_jax(vio, df_mode, matcher):
    """pipeline.step over 8 (VO) or 10 (VIO: SAB engaged from frame 8)
    frames, at test_torch_pipeline.py's and test_torch_vio.py's tolerances:
    matches within 1 % from frame 1, positions within 2 % of the travelled
    span, rotations within 2e-3 (Frobenius / sqrt 2), run_ok on every frame."""
    n = 10 if vio else 8
    jout, tout, js, ts = _step_both(vio, df_mode, matcher, n)
    jm = np.array([o["num_matches"] for o in jout])
    tm = np.array([o["num_matches"] for o in tout])
    assert all(o["run_ok"] for o in tout) and all(o["run_ok"] for o in jout)
    assert jm[0] == tm[0] == 0 and (jm[1:] > 1000).all()
    np.testing.assert_allclose(tm[1:], jm[1:], rtol=0.01)
    jp = np.stack([o["position"] for o in jout])
    tp = np.stack([o["position"] for o in tout])
    span = np.linalg.norm(jp[-1] - jp[0])
    assert span > 0
    assert np.max(np.linalg.norm(tp - jp, axis=-1)) < 0.02 * span
    Rj = np.stack([o["R_global"] for o in jout])
    Rt = np.stack([o["R_global"] for o in tout])
    assert np.max(np.linalg.norm(Rt - Rj, axis=(1, 2))) / np.sqrt(2) < 2e-3
    assert int(ts["num_frames"]) == int(js["num_frames"]) == n - 1
    if vio:
        np.testing.assert_allclose(ts["K"], js["K"], rtol=1e-3)


def test_tube_on_the_raster_field_is_refused():
    """JAX's rule (rebvio_tpu/pipeline.py:229): the tube matcher needs the
    jump-flood field; both packages refuse raster + tube with its message."""
    jc, tc = variant_configs(False, "raster", "tube")
    seq = jsyn.generate(jc.camera, n_frames=1, seed=0)
    img = seq.images[0].astype(np.float32) * jc.image_gain
    with pytest.raises(AssertionError, match="tube matcher requires the JFA field"):
        jpipe.step(jT.init_vio_state(jc), jnp.asarray(img),
                   jT.empty_imu_frame(jc.imu.sample_max), jnp.float32(0.0), jc)
    jax.clear_caches()
    state = tT.init_vio_state(tc, device="cpu")
    with pytest.raises(ValueError, match="tube matcher requires the JFA field"):
        tpipe.step(state, torch.as_tensor(img), empty_window(tc), 0.0, tc)
    with pytest.raises(ValueError, match="tube matcher requires the JFA field"):
        VioRunner(tc, undistort=False, device="cpu").run(tsyn.generate(tc.camera, n_frames=2,
                                                                       seed=0))


# ---------------------------------------------------------------------------
# the goldens (run as a script)


def _stream(n: int, distort: bool):
    return jsyn.generate(jcfg.CameraConfig(), n_frames=n, seed=0, distort=distort,
                         imu_preroll_s=0.1 if distort else 0.0)


def _jax_run(config, seq, undistort: bool, pallas: bool, chunk: int = 0):
    """The JAX runner (streaming, or with ``chunk`` the pipelined chunk
    mode); the Pallas kernels of the path in interpret mode or XLA.  Returns
    (RunResult, final K, final g_est)."""
    from rebvio_tpu.runner import VioRunner as JRunner

    for f in VIO_FLAGS:
        os.environ["REBVIO_PALLAS_" + f] = "1" if pallas else "0"
    jax.clear_caches()
    runner = JRunner(config, undistort=undistort)
    res = runner.run(seq, chunk=chunk, pipelined=chunk > 1)
    return res, float(runner.state.K), np.asarray(runner.state.sab_state.g_est)


def _rw(**kw):
    return jcfg.PipelineConfig(df_mode="raster", matcher="walk", **kw)


_VIO_STREAM = "synthetic seed 0 distorted, imu_preroll_s 0.1, undistort=True"
GOLDENS = {
    # name: (path, config, frames, distorted stream, pipelined chunk (0: streaming), header);
    # chip_smoke.py runs the pipelined chunks at its VO_CHUNK (5) and VIO_CHUNK (8)
    "vo": (VO_GOLDEN, lambda: _rw(use_imu=False), 24, False, 0,
           "PipelineConfig(use_imu=False, df_mode='raster', matcher='walk'), synthetic seed 0"),
    "vio": (VIO_GOLDEN, _rw, 120, True, 0,
            f"PipelineConfig(df_mode='raster', matcher='walk'), {_VIO_STREAM}"),
    "vo_pipelined": (VO_PIPE_GOLDEN, lambda: _rw(use_imu=False), 24, False, 5,
                     "PipelineConfig(use_imu=False, df_mode='raster', matcher='walk'), "
                     "run(chunk=5, pipelined=True), synthetic seed 0"),
    "vio_pipelined": (VIO_PIPE_GOLDEN, _rw, 120, True, 8,
                      "PipelineConfig(df_mode='raster', matcher='walk'), "
                      f"run(chunk=8, pipelined=True), {_VIO_STREAM}"),
    "fast": (FAST_GOLDEN, lambda: jcfg.fast_profile(), 60, True, 0,
             f"fast_profile(), {_VIO_STREAM}"),
}


def write_golden(name: str) -> dict:
    """Write one JAX golden (Pallas interpret) and return the spread to the
    XLA path and JAX's numbers against the reference binary.  Columns:
    ts_us, orientation (3), position (3), num_matches; the header's last
    line holds the final K and g_est."""
    path, make, n, distorted, chunk, what = GOLDENS[name]
    cfg = make()
    seq = _stream(n, distorted)
    t0 = time.time()
    g, gK, gg = _jax_run(cfg, seq, distorted, pallas=True, chunk=chunk)
    assert g.run_ok.all()
    np.savetxt(path, np.column_stack([g.ts_us, g.orientation, g.position, g.num_matches]),
               fmt=["%d"] + ["%.9g"] * 6 + ["%d"],
               header=f"ts_us ox oy oz px py pz num_matches (JAX, Pallas interpret, {what})\n"
                      f"final K {gK:.9g} g_est {gg[0]:.9g} {gg[1]:.9g} {gg[2]:.9g}")
    t_pallas = time.time() - t0
    x, xK, xg = _jax_run(cfg, seq, distorted, pallas=False, chunk=chunk)
    m = np.maximum(g.num_matches[1:], 1)
    out = {"golden": path.name, "frames": n, "seconds_pallas": t_pallas,
           "xla_vs_pallas": {"ate_sim3_m": tev.ate_rmse(x.position, g.position),
                             "ate_rigid_m": tev.ate_rmse(x.position, g.position,
                                                         with_scale=False),
                             "match_rel": float(np.max(np.abs(x.num_matches[1:]
                                                              - g.num_matches[1:]) / m)),
                             "K_abs": abs(xK - gK), "g_est_abs": float(np.abs(xg - gg).max())},
           "span_m": float(np.linalg.norm(g.position[-1] - g.position[0]))}
    if distorted:
        ref = np.loadtxt(REF_GOLDEN)[: n - 1, 4:7]
        gt = seq.gt_pos[1:n]
        out["reference_binary"] = {
            "ref_ate_gt_m": tev.ate_rmse(ref, gt),
            **{f"jax_{k}_cross_ate_sim3_m": tev.ate_rmse(r.position[1:n], ref)
               for k, r in (("pallas", g), ("xla", x))},
            **{f"jax_{k}_ate_gt_m": tev.ate_rmse(r.position[1:n], gt)
               for k, r in (("pallas", g), ("xla", x))}}
    if chunk:
        # the pipelined chunk against the streaming golden: JAX's own deviation
        s_pos = np.loadtxt(GOLDENS[name.split("_")[0]][0])[:, 4:7]
        out["pipelined_vs_streaming_max_pos_abs_m"] = float(np.abs(g.position - s_pos).max())
    if name == "vo":
        # the fast profile's ATE band (tests/test_fast_profile.py:17-32), in JAX
        seq16 = _stream(16, False)
        d, _, _ = _jax_run(jcfg.PipelineConfig(use_imu=False), seq16, False, pallas=True)
        f, _, _ = _jax_run(jcfg.fast_profile(use_imu=False), seq16, False, pallas=True)
        out["fast_band_jax"] = {
            "ate_default": tev.ate_rmse(d.position, seq16.gt_pos),
            "ate_fast": tev.ate_rmse(f.position, seq16.gt_pos),
            "span": float(np.linalg.norm(seq16.gt_pos[-1] - seq16.gt_pos[0]))}
    return out


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    for which in sys.argv[1:] or list(GOLDENS):
        print(json.dumps(write_golden(which)), flush=True)
