"""The vision-only slice end to end: eight frames at the small preset
through JAX ``pipeline.step`` (with the four Pallas kernels of the path in
interpret mode) and through the port's ``pipeline.step`` on the CPU, from
the same interop-converted state.  Also the port's guards: no JAX import,
the runner refuses a missing GPU, the interop round trip.

Run as a script, this file writes the JAX golden that chip_smoke.py holds
the port to on the card:

    JAX_PLATFORMS=cpu python tests/test_torch_pipeline.py
"""

from __future__ import annotations

import ast
import os
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from torch_helpers import PALLAS_FLAGS, small_configs, t2n, to_np, use_pallas  # noqa: E402

from rebvio_tpu import pipeline as jpipe, types as jT  # noqa: E402
from rebvio_tpu.data import synthetic as jsyn  # noqa: E402
from rebvio_tpu_torch import interop, pipeline as tpipe  # noqa: E402
from rebvio_tpu_torch import eval as tev  # noqa: E402
from rebvio_tpu_torch import types as tT  # noqa: E402
from rebvio_tpu_torch.data import synthetic as tsyn  # noqa: E402
from rebvio_tpu_torch.ops.imu import pack_imu_window  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
GOLDEN = REPO / "tests" / "data" / "torch_golden_vo_euroc_seed0_24.txt"
N_FRAMES = 8


@pytest.fixture(scope="module")
def both_runs():
    with pytest.MonkeyPatch.context() as mp:
        use_pallas(mp, *PALLAS_FLAGS)
        jc, tc = small_configs()
        seq = jsyn.generate(jc.camera, n_frames=N_FRAMES, seed=0)
        jstate = jT.init_vio_state(jc)
        tstate = interop.state_from_numpy(to_np(jstate), device="cpu")
        mats = jpipe.frontend_matrices(jc)
        tmats = interop.matrices_from_numpy(to_np(mats), device="cpu")
        empty = pack_imu_window(np.zeros((0, 3)), np.zeros((0, 3)), np.zeros(0, np.int64),
                                tc.imu.sample_max, device="cpu")
        jempty = jT.empty_imu_frame(jc.imu.sample_max)
        jout, tout = [], []
        for i in range(N_FRAMES):
            dt = 0.0 if i == 0 else float(seq.ts_us[i] - seq.ts_us[i - 1]) / 1e6
            img = seq.images[i].astype(np.float32) * jc.image_gain
            jstate, jodo = jpipe.step(jstate, jnp.asarray(img), jempty, jnp.float32(dt), jc, mats)
            tstate, todo = tpipe.step(tstate, torch.as_tensor(img), empty, dt, tc, tmats)
            jout.append(to_np(jodo))
            tout.append({k: t2n(getattr(todo, k)) for k in jout[-1]})
        jax.clear_caches()
        return jout, tout, to_np(jstate), interop.to_numpy(tstate)


def test_slice_matches_per_frame(both_runs):
    jout, tout, _, _ = both_runs
    jm = np.array([o["num_matches"] for o in jout])
    tm = np.array([o["num_matches"] for o in tout])
    assert all(o["run_ok"] for o in tout)
    # thousands of matches per frame; a few flip on float32 sums taken in
    # another order (XLA vs PyTorch reductions): within 1 %
    assert jm[0] == tm[0] == 0
    np.testing.assert_allclose(tm[1:], jm[1:], rtol=0.01)


def test_slice_trajectory(both_runs):
    jout, tout, _, _ = both_runs
    jp = np.stack([o["position"] for o in jout])
    tp = np.stack([o["position"] for o in tout])
    jo = np.stack([o["orientation"] for o in jout])
    to = np.stack([o["orientation"] for o in tout])
    span = np.linalg.norm(jp[-1] - jp[0])
    # 2 % of the travelled span, per frame: the trajectories are the same
    # computation in float32 with other reduction orders
    assert np.max(np.linalg.norm(tp - jp, axis=-1)) < 0.02 * span
    assert np.max(np.abs(to - jo)) < 2e-3


def test_slice_final_state(both_runs):
    _, _, js, ts = both_runs
    assert int(ts["frames_seen"]) == int(js["frames_seen"]) == N_FRAMES
    assert int(ts["num_frames"]) == int(js["num_frames"])
    np.testing.assert_allclose(ts["detector_threshold"], js["detector_threshold"], rtol=1e-5)
    jem, tem = js["edge_map"], ts["edge_map"]
    # the last detection is bit-identical (same frame, same threshold up to
    # the auto-gain's float32 rounding)
    frac = np.mean(jem["kl_id_img"] == tem["kl_id_img"])
    assert frac > 0.99
    assert abs(int(tem["count"]) - int(jem["count"])) <= 0.01 * int(jem["count"])


def test_port_imports_no_jax():
    """No module of the port, and not chip_smoke.py, imports jax or rebvio_tpu."""
    files = sorted((REPO / "rebvio_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 10
    walked = {p.relative_to(REPO).as_posix() for p in files}
    for module in ("ops/sab.py", "ops/imu.py", "ops/kernels.py", "camera.py", "pipeline.py",
                   "runner.py", "interop.py", "profile_step.py", "run.py",
                   "ba/pose_graph.py", "ba/loop_closure.py", "ba/keyframe_map.py",
                   "tools/jfa_ab.py"):
        assert "rebvio_tpu_torch/" + module in walked, module
    for path in files:
        tree = ast.parse(path.read_text(), str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                top = name.split(".")[0]
                assert top not in ("jax", "jaxlib", "rebvio_tpu", "flax"), (path, name)


def test_runner_without_gpu_raises():
    from rebvio_tpu_torch.runner import VioRunner

    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    _, tc = small_configs()
    with pytest.raises(RuntimeError, match="cuda"):
        VioRunner(tc)
    with pytest.raises(RuntimeError, match="cuda"):
        tT.init_vio_state(tc)


def test_interop_round_trip():
    jc, tc = small_configs()
    js = to_np(jT.init_vio_state(jc))
    rng = np.random.RandomState(3)
    js["edge_map"]["rho"] = rng.rand(*js["edge_map"]["rho"].shape).astype(np.float32)
    ts = interop.state_from_numpy(js, device="cpu")
    assert ts.edge_map.kl_id_img.dtype == torch.int32
    assert ts.edge_map.valid.dtype == torch.bool
    assert ts.edge_map.att_img.shape == (8, 60 * 94)
    back = interop.to_numpy(ts)

    def same(a, b):
        if isinstance(a, dict):
            assert a.keys() == b.keys()
            for k in a:
                same(a[k], b[k])
        else:
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)

    same(js, back)
    fresh = interop.to_numpy(tT.init_vio_state(tc, device="cpu"))
    js0 = to_np(jT.init_vio_state(jc))
    same(js0, fresh)


def test_runner_streams_small_sequence():
    from rebvio_tpu_torch.runner import VioRunner

    _, tc = small_configs()
    seq = tsyn.generate(tc.camera, n_frames=6, seed=1)
    res = VioRunner(tc, undistort=False, device="cpu").run(seq)
    assert res.run_ok.all()
    assert res.position.shape == (6, 3) and np.isfinite(res.position).all()
    assert (res.num_matches[1:] > tc.core.global_min_matches_threshold).all()


def test_step_chunk_equals_steps():
    """step_chunk over N frames is N calls of step, odometry stacked."""
    _, tc = small_configs()
    seq = tsyn.generate(tc.camera, n_frames=3, seed=4)
    imgs = torch.as_tensor(np.stack(seq.images).astype(np.float32) * tc.image_gain)
    empty = pack_imu_window(np.zeros((0, 3)), np.zeros((0, 3)), np.zeros(0, np.int64),
                            tc.imu.sample_max, device="cpu")
    dts = [0.0] + [float(d) / 1e6 for d in np.diff(seq.ts_us)]
    s0 = tT.init_vio_state(tc, device="cpu")
    sc, oc = tpipe.step_chunk(s0, imgs, [empty] * 3, dts, tc)
    st = s0
    for i in range(3):
        st, o = tpipe.step(st, imgs[i], empty, dts[i], tc)
        for name in ("orientation", "position", "num_matches", "run_ok"):
            assert torch.equal(getattr(oc, name)[i], getattr(o, name)), (i, name)
    assert torch.equal(sc.Pos, st.Pos) and torch.equal(sc.edge_map.rho, st.edge_map.rho)
    assert int(oc.num_matches[2]) > tc.core.global_min_matches_threshold


def write_golden(path=GOLDEN, n_frames=24):
    """The JAX trajectory that chip_smoke.py holds the port to: the parity
    profile's vision-only step (752x480, 16000 keylines, 8 tube probes,
    field_scale 2) over synthetic seed 0, with the four Pallas kernels of
    the path in interpret mode.  Columns: ts_us, orientation (3),
    position (3), num_matches."""
    for f in PALLAS_FLAGS:
        os.environ["REBVIO_PALLAS_" + f] = "1"
    from rebvio_tpu.configs import CameraConfig, PipelineConfig
    from rebvio_tpu.runner import VioRunner

    seq = jsyn.generate(CameraConfig(), n_frames=n_frames, seed=0)
    res = VioRunner(PipelineConfig(use_imu=False), undistort=False).run(seq)
    assert res.run_ok.all()
    np.savetxt(path, np.column_stack([res.ts_us, res.orientation, res.position,
                                      res.num_matches]),
               fmt=["%d"] + ["%.9g"] * 6 + ["%d"],
               header="ts_us ox oy oz px py pz num_matches (JAX, Pallas interpret, "
                      "PipelineConfig(use_imu=False), synthetic seed 0)")
    return res


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    write_golden()
    print("wrote", GOLDEN, "and the JAX XLA path for comparison:")
    # the spread between the two JAX paths sizes chip_smoke.py's bounds
    for f in PALLAS_FLAGS:
        os.environ["REBVIO_PALLAS_" + f] = "0"
    jax.clear_caches()
    from rebvio_tpu.configs import CameraConfig, PipelineConfig
    from rebvio_tpu.runner import VioRunner

    g = np.loadtxt(GOLDEN)
    xla = VioRunner(PipelineConfig(use_imu=False), undistort=False).run(
        jsyn.generate(CameraConfig(), n_frames=len(g), seed=0))
    print("cross-ATE (sim3) XLA vs Pallas:", tev.ate_rmse(xla.position, g[:, 4:7]))
    print("max |dnum_matches|/num_matches:",
          np.max(np.abs(xla.num_matches[1:] - g[1:, 7]) / g[1:, 7]))
