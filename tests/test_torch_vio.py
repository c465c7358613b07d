"""The VIO slice end to end: twelve distorted frames of the small preset with
IMU through JAX ``pipeline.step`` (the five Pallas kernels of the path in
interpret mode) and through the port's ``pipeline.step`` on the CPU, from
the same interop-converted state; and the port's streaming runner with
on-device undistortion.

Run as a script, this file writes the JAX golden that chip_smoke.py holds
the port's VIO step to on the card, and prints the spread between the JAX
package's own two paths (Pallas interpret vs XLA) that sizes its bounds:

    JAX_PLATFORMS=cpu python tests/test_torch_vio.py
"""

from __future__ import annotations

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

from torch_helpers import PALLAS_FLAGS, small_vio_configs, t2n, to_np, use_pallas  # noqa: E402

from rebvio_tpu import camera as jcam, pipeline as jpipe, types as jT  # noqa: E402
from rebvio_tpu.data import synthetic as jsyn  # noqa: E402
from rebvio_tpu.ops import imu as jimu  # noqa: E402
from rebvio_tpu_torch import camera as tcam, interop, pipeline as tpipe  # noqa: E402
from rebvio_tpu_torch import eval as tev  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
GOLDEN = REPO / "tests" / "data" / "torch_golden_vio_euroc_seed0_120.txt"
REF_GOLDEN = REPO / "tests" / "data" / "anchor_ref_trajectory_seed0_120.txt"
VIO_FLAGS = PALLAS_FLAGS + ("SAB",)
N_FRAMES = 12


def _small_stream():
    jc, _ = small_vio_configs()
    return jsyn.generate(jc.camera, n_frames=N_FRAMES, seed=0, distort=True,
                         imu_preroll_s=0.1)


@pytest.fixture(scope="module")
def both_runs():
    """JAX and the port over the same distorted frames and IMU windows (the
    runner's drain rule), each package undistorting with its own
    Undistorter.  Returns per-frame odometry and final states of both."""
    with pytest.MonkeyPatch.context() as mp:
        use_pallas(mp, *VIO_FLAGS)
        jc, tc = small_vio_configs()
        seq = _small_stream()
        jstate = jT.init_vio_state(jc)
        tstate = interop.state_from_numpy(to_np(jstate), device="cpu")
        mats = jpipe.frontend_matrices(jc)
        tmats = interop.matrices_from_numpy(to_np(mats), device="cpu")
        jund = jcam.Undistorter(jc.camera, jc.image_gain)
        tund = tcam.Undistorter(tc.camera, tc.image_gain, device="cpu")
        jout, tout, cursor = [], [], 0
        for i in range(N_FRAMES):
            j = cursor
            while j < len(seq.imu_ts_us) and seq.imu_ts_us[j] <= seq.ts_us[i]:
                j += 1
            jwin = jimu.pack_imu_window(seq.imu_gyro[cursor:j], seq.imu_acc[cursor:j],
                                        seq.imu_ts_us[cursor:j], jc.imu.sample_max)
            twin = interop.imu_frame_from_numpy(to_np(jwin), device="cpu")
            cursor = j
            dt = 0.0 if i == 0 else float(seq.ts_us[i] - seq.ts_us[i - 1]) / 1e6
            jstate, jodo = jpipe.step(jstate, jund(jnp.asarray(seq.images[i])), jwin,
                                      jnp.float32(dt), jc, mats)
            tstate, todo = tpipe.step(tstate, tund(torch.as_tensor(seq.images[i])), twin, dt,
                                      tc, tmats)
            jout.append({**to_np(jodo), "R_global": np.asarray(jstate.R_global)})
            tout.append({**{k: t2n(getattr(todo, k)) for k in jout[-1] if k != "R_global"},
                         "R_global": t2n(tstate.R_global)})
        jax.clear_caches()
        return jout, tout, to_np(jstate), interop.to_numpy(tstate)


def test_vio_slice_matches_per_frame(both_runs):
    jout, tout, _, _ = both_runs
    jm = np.array([o["num_matches"] for o in jout])
    tm = np.array([o["num_matches"] for o in tout])
    assert all(o["run_ok"] for o in tout) and all(o["run_ok"] for o in jout)
    # as the VO slice: a few of ~1000 matches flip on float32 sums taken in
    # another order (measured at most 0.3 % here); 1 %
    assert jm[0] == tm[0] == 0
    np.testing.assert_allclose(tm[1:], jm[1:], rtol=0.01)


def test_vio_slice_trajectory(both_runs):
    jout, tout, js, _ = both_runs
    jp = np.stack([o["position"] for o in jout])
    tp = np.stack([o["position"] for o in tout])
    jo = np.stack([o["orientation"] for o in jout])
    to = np.stack([o["orientation"] for o in tout])
    # the pose integrates only once SAB is engaged (frame 8 on: num_frames > 4 + 2);
    # before that both hold the origin
    assert int(js["num_frames"]) == N_FRAMES - 1
    assert np.abs(jp[-1]).max() > 0
    span = np.linalg.norm(jp[-1] - jp[0])
    # 2 % of the travelled span, as the VO slice
    assert np.max(np.linalg.norm(tp - jp, axis=-1)) < 0.02 * span
    # attitude: the gravity-aligned pose sits near a half turn, where the
    # float32 log of the odometry's rotation vector is ill-conditioned (the
    # two packages' vectors differ by up to 0.015 rad there, on both sides
    # of pi, for rotations ~1e-7 apart), so compare the rotations: the
    # Frobenius distance ~ angle, 2e-3 rad as the VO slice
    Rj = np.stack([o["R_global"] for o in jout])
    Rt = np.stack([o["R_global"] for o in tout])
    assert np.max(np.linalg.norm(Rt - Rj, axis=(1, 2))) / np.sqrt(2) < 2e-3


def test_vio_slice_filter_state(both_runs):
    _, _, js, ts = both_runs
    # metric scale, SAB state and gyro bias after 4 engaged SAB updates: the
    # same filter on inputs that differ at float32 noise.  Measured: K equal,
    # |dX[:4]| 4.4e-6, |dX[4:]| 4e-15 (b ~ 1e-11 under the ~1e13 prior
    # information of the bias block), Bg 1.2e-6 relative; bounds ~5x that
    np.testing.assert_allclose(ts["K"], js["K"], rtol=1e-4)
    np.testing.assert_allclose(ts["sab_state"]["X"][:4], js["sab_state"]["X"][:4], atol=2e-5)
    np.testing.assert_allclose(ts["sab_state"]["X"][4:], js["sab_state"]["X"][4:], atol=2e-14)
    np.testing.assert_allclose(ts["imu_state"]["Bg"], js["imu_state"]["Bg"], rtol=1e-5,
                               atol=1e-10)
    assert bool(ts["imu_state"]["initialized"]) and bool(js["imu_state"]["initialized"])


def test_runner_undistorts_and_streams(both_runs):
    """VioRunner(undistort=True) on the raw distorted stream reproduces the
    step-by-step run above: the same undistortion, IMU drain rule and step."""
    from rebvio_tpu_torch.runner import VioRunner

    _, tout, _, _ = both_runs
    _, tc = small_vio_configs()
    res = VioRunner(tc, undistort=True, device="cpu").run(_small_stream())
    assert res.run_ok.all()
    np.testing.assert_array_equal(res.num_matches, [o["num_matches"] for o in tout])
    np.testing.assert_allclose(res.position, np.stack([o["position"] for o in tout]),
                               rtol=0, atol=1e-6)


def _anchor_stream(n_frames):
    from rebvio_tpu.configs import CameraConfig

    return jsyn.generate(CameraConfig(), n_frames=n_frames, seed=0, distort=True,
                         imu_preroll_s=0.1)


def _jax_vio_run(seq, pallas: bool):
    """The JAX streaming runner over ``seq`` at ``PipelineConfig()`` with
    undistortion; the five Pallas kernels of the path on (interpret mode)
    or off (XLA).  Returns (RunResult, final K, final g_est)."""
    for f in VIO_FLAGS:
        os.environ["REBVIO_PALLAS_" + f] = "1" if pallas else "0"
    jax.clear_caches()
    from rebvio_tpu.configs import PipelineConfig
    from rebvio_tpu.runner import VioRunner

    runner = VioRunner(PipelineConfig(), undistort=True)
    res = runner.run(seq)
    return res, float(runner.state.K), np.asarray(runner.state.sab_state.g_est)


def write_golden(path=GOLDEN, n_frames=120):
    """The JAX trajectory that chip_smoke.py holds the port's VIO step to:
    ``PipelineConfig()`` (752x480, 16000 keylines, 8 tube probes,
    field_scale 2, IMU with the SAB filter, 5 Gauss-Newton iterations) over
    the seed-0 reference-anchor stream (distorted frames, 0.1 s IMU
    preroll), undistorted on the device, with the five Pallas kernels of
    the path in interpret mode.  Columns: ts_us, orientation (3),
    position (3), num_matches; the header's last line holds the final K
    and g_est."""
    seq = _anchor_stream(n_frames)
    res, K, g_est = _jax_vio_run(seq, pallas=True)
    assert res.run_ok.all()
    np.savetxt(path, np.column_stack([res.ts_us, res.orientation, res.position,
                                      res.num_matches]),
               fmt=["%d"] + ["%.9g"] * 6 + ["%d"],
               header="ts_us ox oy oz px py pz num_matches (JAX, Pallas interpret, "
                      "PipelineConfig(), synthetic seed 0 distorted, imu_preroll_s 0.1, "
                      "undistort=True)\n"
                      f"final K {K:.9g} g_est {g_est[0]:.9g} {g_est[1]:.9g} {g_est[2]:.9g}")
    return seq, res, K, g_est


def read_golden(path=GOLDEN):
    """(table [N, 8], final K, final g_est [3]) of a golden written above."""
    final = [ln for ln in Path(path).read_text().splitlines() if ln.startswith("# final K")]
    parts = final[0].split()
    return np.loadtxt(path), float(parts[3]), np.array([float(v) for v in parts[5:8]])


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    t0 = time.time()
    seq, gres, gK, gg = write_golden()
    print(f"wrote {GOLDEN} ({time.time() - t0:.0f} s); final K {gK:.6g} g_est {gg}")
    t0 = time.time()
    xres, xK, xg = _jax_vio_run(seq, pallas=False)
    print(f"JAX XLA path ({time.time() - t0:.0f} s); final K {xK:.6g} g_est {xg}")
    # the spread between the two JAX paths sizes chip_smoke.py's bounds
    print("cross-ATE sim3 XLA vs Pallas [m]:", tev.ate_rmse(xres.position, gres.position))
    print("cross-ATE rigid XLA vs Pallas [m]:",
          tev.ate_rmse(xres.position, gres.position, with_scale=False))
    m = gres.num_matches[1:]
    print("max |dnum_matches|/num_matches:", np.max(np.abs(xres.num_matches[1:] - m) / m))
    print("|dK|:", abs(xK - gK), " max |dg_est|:", np.max(np.abs(xg - gg)))
    ref = np.loadtxt(REF_GOLDEN)
    n = len(seq.images)
    gt = seq.gt_pos[1:n]
    print("reference binary: ATE vs ground truth [m]:",
          tev.ate_rmse(ref[: n - 1, 4:7], gt))
    for name, r in (("Pallas", gres), ("XLA", xres)):
        print(f"JAX {name}: cross-ATE sim3 vs reference binary [m]:",
              tev.ate_rmse(r.position[1:n], ref[: n - 1, 4:7]),
              " ATE vs ground truth [m]:", tev.ate_rmse(r.position[1:n], gt))
