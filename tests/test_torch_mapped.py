"""The port's mapping at chunk speed: ``KeyframeMapBuilder.build_problem``
against the JAX package's builder on identical host arrays,
``pipeline.step_chunk_traced`` against ``step_chunk`` and the per-frame
maps, ``VioRunner.run_mapped`` against the per-frame builder
(tests/test_keyframe_map.py:52-86, ported, at the small preset), and the
CLI's ``--ba``."""

from __future__ import annotations

import json
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from torch_helpers import empty_window, small_configs, t2n, to_np  # noqa: E402

from rebvio_tpu.ba.keyframe_map import KeyframeMapBuilder as JBuilder  # noqa: E402
from rebvio_tpu_torch import pipeline as tpipe, types as tT  # noqa: E402
from rebvio_tpu_torch.ba.keyframe_map import KeyframeMapBuilder  # noqa: E402
from rebvio_tpu_torch.data import synthetic as tsyn  # noqa: E402
from rebvio_tpu_torch.runner import VioRunner  # noqa: E402

ODO = ("orientation", "position", "num_matches", "run_ok")


def _feed(builder, frames):
    for f in frames:
        builder.add_frame_arrays(*f)


def _random_frames(rng, n, kmax):
    """Host arrays of ``n`` frames as a run would feed them: each keyline
    valid with probability 0.9, matched to the same slot of the previous
    frame with probability 0.75 and to a random one with 0.15 (so tracks
    continue, split and end), positions, inverse depths, a slowly turning
    pose."""
    out = []
    for i in range(n):
        valid = rng.rand(kmax) < 0.9
        u = rng.rand(kmax)
        match_id = np.where(u < 0.75, np.arange(kmax),
                            np.where(u < 0.9, rng.randint(0, kmax, kmax), -1)).astype(np.int32)
        pos_img = rng.uniform(-90, 90, (kmax, 2)).astype(np.float32)
        rho = rng.uniform(0.05, 2.0, kmax).astype(np.float32)
        ori = np.array([0.01 * i, 0.02 * i, -0.005 * i], np.float32)
        pos = np.array([0.05 * i, 0.01 * i, 0.0], np.float32)
        out.append((valid, match_id, pos_img, rho, ori, pos, 0.5 + 0.1 * i))
    return out


@pytest.mark.parametrize("min_obs", [2, 3])
def test_build_problem_matches_jax(min_obs):
    """Both packages' builders fed identical host arrays (12 frames, a
    keyframe every 3 frames, 80 tracks at most per keyframe): every array of
    the problem equal, R within 1e-6 (each package's own so3.exp)."""
    jc, tc = small_configs()
    frames = _random_frames(np.random.RandomState(min_obs), 12, 96)
    jb = JBuilder(jc, kf_every=3, kf_phase=2, max_tracks_per_kf=80)
    tb = KeyframeMapBuilder(tc, kf_every=3, kf_phase=2, max_tracks_per_kf=80)
    _feed(jb, frames)
    _feed(tb, frames)
    assert jb.n_keyframes() == tb.n_keyframes() == 4
    jp = to_np(jb.build_problem(min_obs=min_obs))
    tp = tb.build_problem(min_obs=min_obs, device="cpu")
    assert tp.rho.shape[0] > 20 and tp.obs_lm.shape[0] > 20
    for k, j in jp.items():
        t = t2n(getattr(tp, k))
        assert t.dtype == j.dtype and t.shape == j.shape, k
        if k == "R":
            np.testing.assert_allclose(t, j, rtol=0, atol=1e-6)
        else:
            np.testing.assert_array_equal(t, j, err_msg=k)
    # too few keyframes, or no track seen often enough: no problem
    one = KeyframeMapBuilder(tc, kf_every=3, kf_phase=2)
    _feed(one, frames[:3])
    assert one.build_problem(device="cpu") is None
    assert tb.build_problem(min_obs=99, device="cpu") is None


def test_step_chunk_traced_equals_step_chunk():
    """The traced chunk is step_chunk (state and odometry bit for bit) plus,
    per frame, the post-step map's valid, match_id, pos_img, rho and K."""
    _, tc = small_configs()
    n = 4
    seq = tsyn.generate(tc.camera, n_frames=n, seed=0)
    frames = torch.as_tensor(np.stack(seq.images).astype(np.float32) * tc.image_gain)
    win = empty_window(tc)
    imu = tT.tree_map(lambda x: torch.stack([x] * n), win)
    dts = torch.full((n,), 0.05)
    s0 = tT.init_vio_state(tc, device="cpu")
    sa, oa = tpipe.step_chunk(s0, frames, imu, dts, tc)
    sb, ob, trace = tpipe.step_chunk_traced(s0, frames, imu, dts, tc)
    for x, y in zip(tT.tree_leaves(sa), tT.tree_leaves(sb)):
        assert torch.equal(x, y)
    for f in ODO:
        assert torch.equal(getattr(oa, f), getattr(ob, f)), f
    st = s0
    for i in range(n):
        st, _ = tpipe.step(st, frames[i], win, dts[i], tc)
        em = st.edge_map
        for k in ("valid", "match_id", "pos_img", "rho"):
            assert torch.equal(trace[k][i], getattr(em, k)), (i, k)
        assert torch.equal(trace["K"][i], st.K)
    assert int(trace["valid"][-1].sum()) > 100 and (trace["match_id"][-1] >= 0).any()


def test_run_mapped_matches_per_frame_builder():
    """run_mapped (chunks of 4 frames from step_chunk_traced, one readback
    each, the edge map snapshotted at chunk boundaries; then two tail frames
    with the per-frame builder) builds the same keyframe map as the
    per-frame loop with the same schedule, and the same trajectory, bit for
    bit (tests/test_keyframe_map.py::test_run_mapped_matches_per_frame_builder)."""
    _, tc = small_configs()
    N, kf_every = 22, 4
    seq = tsyn.generate(tc.camera, n_frames=N, seed=1)

    r1 = VioRunner(tc, undistort=False, device="cpu")
    b1 = KeyframeMapBuilder(tc, kf_every=kf_every, kf_phase=kf_every - 1, store_maps=True)
    rows = []
    for i in range(N):
        odo = r1.process_frame(seq.images[i], int(seq.ts_us[i]), seq.imu_ts_us, seq.imu_gyro,
                               seq.imu_acc)
        o, p = t2n(odo.orientation), t2n(odo.position)
        b1.add_frame(r1.state.edge_map, o, p, K_scale=float(r1.state.K))
        rows.append((o, p, int(odo.num_matches), bool(odo.run_ok)))

    r2 = VioRunner(tc, undistort=False, device="cpu")
    b2 = KeyframeMapBuilder(tc, kf_every=kf_every, kf_phase=kf_every - 1, store_maps=True)
    res2 = r2.run_mapped(seq, b2, chunk=kf_every)
    assert sorted(r2._programs) == [(1, "exact"), (kf_every, "traced")]

    for f, col in zip(ODO, zip(*rows)):
        np.testing.assert_array_equal(getattr(res2, f), np.asarray(col), err_msg=f)
    np.testing.assert_array_equal(res2.ts_us, seq.ts_us)
    assert res2.run_ok.all()
    assert b1.n_keyframes() == b2.n_keyframes() == N // kf_every
    assert len(b2.kf_maps) == b2.n_keyframes()        # every keyframe has its map
    for k1, k2 in zip(b1.keyframes, b2.keyframes):
        assert k1.index == k2.index
        for f in ("R_wc", "t_wc", "obs_tracks", "obs_uv", "obs_rho"):
            np.testing.assert_array_equal(getattr(k1, f), getattr(k2, f), err_msg=f)
    for m1, m2 in zip(b1.kf_maps, b2.kf_maps):
        for x, y in zip(tT.tree_leaves(m1), tT.tree_leaves(m2)):
            assert torch.equal(x, y)
    for x, y in zip(tT.tree_leaves(r1.state), tT.tree_leaves(r2.state)):
        assert torch.equal(x, y)

    with pytest.raises(ValueError, match="chunk-aligned"):
        r2.run_mapped(seq, KeyframeMapBuilder(tc, kf_every=4, kf_phase=0), chunk=4)
    with pytest.raises(ValueError, match="chunk-aligned"):
        r2.run_mapped(seq, KeyframeMapBuilder(tc, kf_every=4, kf_phase=3), chunk=6)


def test_run_cli_ba(capsys):
    """The CLI's --ba (tests/test_e2e.py's BA check on the port): the run maps
    at chunk speed and the bundle adjustment lowers the RMS reprojection
    error; --chunk with --pose-graph is accepted (the mapped run's chunk is
    --kf-every)."""
    from rebvio_tpu_torch import run as run_mod

    rc = run_mod.main(["--device", "cpu", "--preset", "small", "--ba", "--mode", "vo",
                       "--frames", "16", "--kf-every", "4"])
    assert rc == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["run_ok"] and out["frames"] == 16
    assert out["ba_keyframes"] == 4 and out["ba_landmarks"] > 50
    assert out["ba_rms_after_px"] < out["ba_rms_before_px"]
    assert np.isfinite(out["ba_ate_sim3"]) and np.isfinite(out["ate_sim3"])
    assert "pg_keyframes" not in out
    rc = run_mod.main(["--device", "cpu", "--preset", "small", "--pose-graph", "--chunk", "8",
                       "--mode", "vo", "--frames", "12", "--kf-every", "3"])
    assert rc == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["pg_keyframes"] == 4 and out["frames"] == 12 and "ba_keyframes" not in out
    for flags in (["--realtime", "1", "--ba"], ["--realtime", "1", "--pose-graph"]):
        with pytest.raises(SystemExit):
            run_mod.main(["--device", "cpu", "--preset", "small"] + flags)
    capsys.readouterr()
