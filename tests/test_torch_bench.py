"""The port's measurement programs on the CPU (they time only on a GPU):
``rebvio_tpu_torch.bench``'s inputs against the JAX bench's (bench.py at
the repo root) at a 48x64 camera, its result line's keys against the JAX
bench's on fixed numbers, the entry points refusing to run without a GPU,
the roofline tool's byte and operation counts against PERF.md's kernel
bounds, ``utils.timing.device_trace``, the staged step of
``tools/profile_stages.py`` against ``pipeline.step`` bit for bit (VO and
VIO, tube and walk, the small preset), and the staging of inputs already on
the device.  No JAX compile of the step."""

from __future__ import annotations

import dataclasses
import json
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from torch_helpers import EUROC_DISTORTION, small_config, small_vio_config  # noqa: E402

import rebvio_tpu.configs as jcfg  # noqa: E402
import rebvio_tpu_torch.configs as tcfg  # noqa: E402
from rebvio_tpu_torch import bench as tbench, pipeline as tpipe, types as T  # noqa: E402
from rebvio_tpu_torch.data import synthetic as tsyn  # noqa: E402
from rebvio_tpu_torch.graph import SlotLayout, StepProgram, odometry_view  # noqa: E402
from rebvio_tpu_torch.tools import profile_stages, roofline, scaling_bench  # noqa: E402
from rebvio_tpu_torch.utils import timing  # noqa: E402

TINY_CAMERA = dict(rows=48, cols=64, fx=45.0, fy=45.0, cx=31.5, cy=23.5, **EUROC_DISTORTION)


def _tiny(mod):
    return mod.PipelineConfig(camera=mod.CameraConfig(**TINY_CAMERA))


# ---------------------------------------------------------------------------
# inputs


def test_chunk_inputs_match_jax_bench():
    """``chunk_inputs`` is the JAX bench's ``_chunk_inputs``: the gained
    frames, the packed IMU windows and the dts, over 4 frames."""
    import bench as jbench

    jc, tc = _tiny(jcfg), _tiny(tcfg)
    jf, jimu, jdts = jbench._chunk_inputs(jc, 4)
    tf, timu, tdts = tbench.chunk_inputs(tc, 4, device="cpu")
    assert np.array_equal(np.asarray(jf), tf.numpy())
    for name in ("gyro", "acc", "dt", "n", "dt_interval"):
        assert np.array_equal(np.asarray(getattr(jimu, name)), getattr(timu, name).numpy()), name
    assert np.array_equal(np.asarray(jdts), tdts.numpy())
    assert int(timu.n.sum()) > 0


def test_streaming_seq_matches_jax_bench():
    """The streaming sections' distorted uint8 stream is the JAX bench's."""
    import bench as jbench

    js = jbench._streaming_seq(_tiny(jcfg).camera, 4)
    ts = tbench.streaming_seq(_tiny(tcfg).camera, 4)
    assert ts.images.dtype == np.uint8
    for name in ("images", "ts_us", "imu_ts_us", "imu_gyro", "imu_acc"):
        assert np.array_equal(getattr(js, name), getattr(ts, name)), name


# ---------------------------------------------------------------------------
# the entry points need a GPU


@pytest.mark.parametrize("entry", ["bench", "roofline", "roofline_stages", "profile_stages",
                                   "scaling_bench"])
def test_entry_points_raise_without_gpu(entry, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    call = {"bench": tbench.main, "roofline": roofline.measure,
            "roofline_stages": roofline.measure_stages,
            "profile_stages": lambda: profile_stages.main([]),
            "scaling_bench": lambda: scaling_bench.main(["--batch-sweep", "1,2"])}[entry]
    with pytest.raises(RuntimeError, match="cuda"):
        call()


# ---------------------------------------------------------------------------
# the result line


def _keys(tree):
    """Nested key structure of a JSON value (lists by their first item)."""
    if isinstance(tree, dict):
        return {k: _keys(v) for k, v in tree.items()}
    if isinstance(tree, list) and tree and isinstance(tree[0], dict):
        return [_keys(tree[0])]
    return None


def test_result_keys_match_jax_bench(monkeypatch, capsys):
    """Both benches' ``main`` with every timed section replaced by the same
    fixed numbers: the port's line has the JAX bench's keys, nested, plus
    ``device``."""
    import bench as jbench
    import tools.roofline as jroof

    stream = {"streaming_fps": 200.0, "streaming_spread": [190.0, 210.0],
              "streaming_fps_resident": 250.0, "resident_spread": [240.0, 260.0], "runs": 5}
    env = [{"speed": 1.0, "processed": 120, "dropped": 0, "worst_latency_ms": 9.0}]
    rt = {"frames": 120, "frame_budget_ms": 50.0, "queue_size": 20, "envelope": env,
          "max_zero_drop_speed": 1.0}
    mapped = {"chunk": 8, "plain_fps": 300.0, "mapped_fps": 280.0, "plain_spread": [1.0, 2.0],
              "mapped_spread": [1.0, 2.0], "mapped_over_plain": 1.07,
              "device_chunk_ms_plain": 24.0, "device_chunk_ms_traced": 25.0}
    roof = {"gather_ceiling_fraction": 0.5, "try_vel_pass_us": 10.0}
    stages = {k: 1.0 for k in ("detect_ceiling_fraction", "jfa_ceiling_fraction",
                               "tube_ceiling_fraction", "detect_ms", "jfa_ms", "tube_ms",
                               "gather_row_bw_gbs")}
    monkeypatch.setenv("BENCH_CHUNK", "1")
    monkeypatch.setattr(jbench, "bench_chunked", lambda *a, **k: 400.0)
    monkeypatch.setattr(jbench, "bench_streaming", lambda *a, **k: dict(stream))
    monkeypatch.setattr(jbench, "bench_realtime", lambda *a, **k: dict(rt))
    monkeypatch.setattr(jbench, "bench_mapped", lambda *a, **k: dict(mapped))
    monkeypatch.setattr(jroof, "measure", lambda *a, **k: dict(roof))
    monkeypatch.setattr(jroof, "measure_stages", lambda *a, **k: dict(stages))
    jbench.main()
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])

    monkeypatch.setattr(tbench, "resolve_device", lambda *a, **k: torch.device("cpu"))
    monkeypatch.setattr(tbench, "sequence", lambda *a, **k: None)
    monkeypatch.setattr(tbench, "nvidia_smi", lambda *a, **k: ["card", "700.00 W", "1980 MHz"])
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(tbench, "bench_chunked", lambda *a, **k: 400.0)
    monkeypatch.setattr(tbench, "bench_streaming", lambda *a, **k: dict(stream))
    monkeypatch.setattr(tbench, "bench_realtime", lambda *a, **k: dict(rt))
    monkeypatch.setattr(tbench, "bench_mapped", lambda *a, **k: dict(mapped))
    monkeypatch.setattr(roofline, "measure", lambda *a, **k: dict(roof))
    monkeypatch.setattr(roofline, "measure_stages", lambda *a, **k: dict(stages))
    got = tbench.main()
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == got
    assert set(got) == set(tbench.RESULT_KEYS)
    assert all(set(p) == set(tbench.PROFILE_KEYS) for p in got["profiles"].values())
    device = got.pop("device")
    assert _keys(got) == _keys(want)
    assert set(device) == {"name", "power_limit", "sm_clock_before", "sm_clock_after", "count"}
    assert got["vs_baseline"] == pytest.approx(want["vs_baseline"], abs=0.005)
    assert got["reference_fps_measured"] == want["reference_fps_measured"] == 31.71


def test_reference_fps_raises_when_missing(tmp_path):
    with pytest.raises(FileNotFoundError):
        tbench.reference_fps(tmp_path / "REFERENCE_BASELINE.json")


# ---------------------------------------------------------------------------
# the roofline's counts: PERF.md's kernel table (section 6) at the parity
# profile, bytes over 3.35 TB/s


@pytest.mark.parametrize("name,perf_ms", [("att_flood", 0.00144), ("try_vel", 0.000306),
                                          ("tube_match", 0.00201)])
def test_kernel_bounds_match_perf_table(name, perf_ms):
    ms, by = roofline.kernel_bounds(tcfg.PipelineConfig())[name]
    assert by == "bytes"
    assert ms == pytest.approx(perf_ms, rel=0.01)


# ---------------------------------------------------------------------------
# device_trace


def test_device_trace_writes_chrome_trace(tmp_path):
    with timing.device_trace(str(tmp_path / "trace")):
        (torch.arange(64, dtype=torch.float32) * 2.0).sum()
    files = list((tmp_path / "trace").glob("trace_*.json"))
    assert len(files) == 1
    trace = json.loads(files[0].read_text())
    assert trace["traceEvents"]


# ---------------------------------------------------------------------------
# the staged step is the step


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().view(torch.uint8) if t.dim() else t.reshape(1).view(torch.uint8)


def _assert_same_tree(a, b):
    la, lb = T.tree_leaves(a), T.tree_leaves(b)
    assert len(la) == len(lb)
    for i, (x, y) in enumerate(zip(la, lb)):
        assert x.dtype == y.dtype and x.shape == y.shape, i
        assert torch.equal(_bits(x), _bits(y)), i


@pytest.mark.parametrize("vio", [False, True], ids=["vo", "vio"])
@pytest.mark.parametrize("matcher", ["tube", "walk"])
def test_staged_step_is_pipeline_step(vio, matcher):
    """From the same state, on the first frame and on the first estimate
    (VIO: the IMU integration, the bias window and K3, its result selected
    away until the filter engages, all of which run on every estimate), the
    tool's staged step (``pipeline.step_stages`` driven stage by stage, each
    name checked against STAGES) returns ``pipeline.step``'s state and
    odometry bit for bit.  The prefixes stop where asked."""
    cfg = small_vio_config(tcfg) if vio else small_config(tcfg)
    cfg = dataclasses.replace(cfg, matcher=matcher,
                              df_mode="jfa" if matcher == "tube" else "raster")
    n = 2
    seq = tsyn.generate(cfg.camera, n_frames=n, seed=0, imu_preroll_s=0.1 if vio else 0.0)
    frames, imu, dts = tbench.chunk_inputs(cfg, n, seq, device="cpu")
    mats = tpipe.frontend_matrices(cfg, "cpu")
    state = T.init_vio_state(cfg, "cpu")
    for i in range(n):
        win = T.tree_map(lambda x: x[i], imu)
        want = tpipe.step(state, frames[i], win, dts[i], cfg, mats)
        got = profile_stages.staged_step(state, frames[i], win, dts[i], cfg, mats)
        _assert_same_tree(got[0], want[0])
        _assert_same_tree(got[1], want[1])
        state = want[0]
    assert int(state.num_frames) == n - 1 and bool(state.run_ok)
    seen = []
    assert profile_stages.staged_step(state, frames[0], T.tree_map(lambda x: x[0], imu), dts[0],
                                      cfg, mats, upto=2, around=_recorder(seen)) is None
    assert seen == list(profile_stages.STAGES[:3])


def _recorder(seen):
    from contextlib import contextmanager

    @contextmanager
    def around(name):
        seen.append(name)
        yield
    return around


# ---------------------------------------------------------------------------
# staging inputs already on the device


def test_stage_resident_runs_the_chunk():
    """``StepProgram.stage_resident`` copies stacked inputs into a slot; run
    from it, the program gives ``step_chunk``'s result, and a second run of
    the same slot reads the same inputs."""
    cfg = small_config(tcfg)
    n = 3
    seq = tsyn.generate(cfg.camera, n_frames=n, seed=0)
    frames, imu, dts = tbench.chunk_inputs(cfg, n, seq, device="cpu")
    mats = tpipe.frontend_matrices(cfg, "cpu")
    layout = SlotLayout(n, (cfg.camera.rows, cfg.camera.cols), np.float32, cfg.imu.sample_max)
    prog = StepProgram(lambda s, f, w, d: tpipe.step_chunk(s, f, w, d, cfg, mats), layout,
                       torch.device("cpu"), 1, graph=False)
    k = prog.stage_resident(frames, imu, dts)
    s0 = T.init_vio_state(cfg, "cpu")
    want_state, want_odo = tpipe.step_chunk(s0, frames, imu, dts, cfg, mats)
    got_state, packed, _ev = prog.run(k, s0)
    _assert_same_tree(got_state, want_state)
    _assert_same_tree(odometry_view(packed), want_odo)
    again_state, _packed, _ev = prog.run(k, got_state)
    assert int(again_state.frames_seen) == 2 * n
