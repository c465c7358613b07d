"""Benchmark: full-resolution VIO frames/s on one GPU (the JAX package's
bench.py, section by section, with its environment switches and its
output keys).

    python -m rebvio_tpu_torch.bench

Runs the complete per-frame step (undistorted full-resolution EuRoC-shaped
frames, the full VIO path) on synthetic seed-0 imagery with the inputs on
the card, and reports steady-state frames/s for both profiles:

  fast    throughput profile (configs.fast_profile: 8192 keylines, 4 probes)
  parity  the reference's own operating point (PipelineConfig(): 16000
          keylines, 8 probes)

Per profile: the exact chunk of BENCH_CHUNK frames (default 512) replayed
as one CUDA graph (graph.StepProgram, mode "exact"), and the latency-2
chunk (low_latency_fps); the streaming runner (one replay a frame,
undistortion on the card, 16 distorted uint8 frames; the median over 5 runs
with [min, max]) and its resident variant (``process_frame`` on frames
already on the card); the keep-up sweep (``run_realtime`` at 1.0, 1.5, 2.0,
3.0 x the sensor rate, queue 20); then ``run_mapped`` against the plain
chunked run with the device ms of the exact and traced chunk programs, and
the roofline and stage-ceiling sections (tools/roofline.py).
BENCH_PROFILE=fast|parity keeps one profile; BENCH_STREAMING=0,
BENCH_REALTIME=0, BENCH_MAPPED=0, BENCH_ROOFLINE=0, BENCH_LOWLAT=0 skip
sections.

Departures from the JAX bench: times are host clocks around
``torch.cuda.synchronize`` (no read-back round trip is subtracted: a
co-located card has none worth the name); a section that fails fails the
run; no ceiling fraction is clamped; values are not rounded; without a
GPU the entry point raises.  The last line is one JSON object with the JAX
bench's keys plus ``device`` (nvidia-smi's name and power limit, the SM
clock before and after the run, the device count).  vs_baseline divides by
REFERENCE_BASELINE.json's reference_fps: the C++ reference on a 2-core x86
host, a CPU figure.
"""

from __future__ import annotations

import functools
import json
import os
import subprocess
import time
from pathlib import Path

import numpy as np
import torch

from rebvio_tpu_torch import resolve_device
from rebvio_tpu_torch import types as T
from rebvio_tpu_torch.configs import PipelineConfig, fast_profile
from rebvio_tpu_torch.data import synthetic
from rebvio_tpu_torch.graph import SlotLayout, StepProgram, odometry_view, pack_trace, trace_words
from rebvio_tpu_torch.ops.imu import pack_imu_window
from rebvio_tpu_torch.pipeline import frontend_matrices, step_chunk, step_chunk_traced

REFERENCE_BASELINE = Path(__file__).resolve().parent.parent / "REFERENCE_BASELINE.json"
SPEEDS = (1.0, 1.5, 2.0, 3.0)
# the result line's keys at the defaults (the JAX bench's), and each profile's
RESULT_KEYS = ("metric", "value", "unit", "vs_baseline", "reference_fps_measured", "profiles",
               "streaming", "streaming_fps", "streaming_fps_resident", "realtime", "realtime_1x",
               "mapped", "jtj_roofline_fraction", "try_vel_pass_us", "stage_ceilings", "device")
PROFILE_KEYS = ("fps", "vs_baseline", "keylines_max", "tube_probes", "low_latency_fps")


def reference_fps(path: Path = REFERENCE_BASELINE) -> float:
    """The C++ reference's measured frames/s (REFERENCE_BASELINE.json);
    raises if the file is missing."""
    with open(path) as f:
        return float(json.load(f)["reference_fps"])


@functools.lru_cache(maxsize=8)
def sequence(cam, n_frames: int, distort: bool = False):
    """Synthetic seed 0: ``n_frames`` undistorted float frames (the chunked
    and mapped sections), or with ``distort`` the streaming sections'
    ``streaming_seq``.  Made once a process for each (camera, n, distort)."""
    if distort:
        return streaming_seq(cam, n_frames)
    return synthetic.generate(cam, n_frames=n_frames, seed=0)


def imu_windows(seq, n_frames: int, sample_max: int, device="cuda"):
    """The packed IMU window of each of the first ``n_frames`` frames: the
    samples since the previous frame with ts <= the frame's ts."""
    windows, cursor = [], 0
    for i in range(n_frames):
        j = cursor
        while j < len(seq.imu_ts_us) and seq.imu_ts_us[j] <= seq.ts_us[i]:
            j += 1
        windows.append(pack_imu_window(seq.imu_gyro[cursor:j], seq.imu_acc[cursor:j],
                                       seq.imu_ts_us[cursor:j], sample_max, device=device))
        cursor = j
    return windows


def chunk_inputs(config: PipelineConfig, n_frames: int, seq=None, device="cuda"):
    """(frames [n, H, W] float32 with the gain applied, windows with leaves
    [n, ...], dts [n] of 0.05 s) on ``device``: the JAX bench's
    ``_chunk_inputs``."""
    dev = resolve_device(device)
    if seq is None:
        seq = synthetic.generate(config.camera, n_frames=n_frames, seed=0)
    assert len(seq.images) >= n_frames
    frames = torch.stack([torch.from_numpy(np.asarray(seq.images[i] * config.image_gain))
                          for i in range(n_frames)]).to(dev)
    wins = imu_windows(seq, n_frames, config.imu.sample_max, dev)
    imu = T.tree_map(lambda *xs: torch.stack(xs), *wins)
    dts = torch.full((n_frames,), 0.05, dtype=torch.float32, device=dev)
    return frames, imu, dts


def streaming_seq(cam, n_frames: int, seed: int = 0):
    """Distorted frames as uint8 (EuRoC's, and the reference consumes MONO8),
    with 0.1 s of IMU before the first frame: the JAX bench's
    ``_streaming_seq``."""
    import dataclasses

    seq = synthetic.generate(cam, n_frames=n_frames, seed=seed, distort=True,
                             imu_preroll_s=0.1)
    return dataclasses.replace(
        seq, images=np.clip(np.round(seq.images), 0, 255).astype(np.uint8))


def median_spread(samples):
    s = sorted(samples)
    return float(np.median(s)), [s[0], s[-1]]


def chunk_program(config: PipelineConfig, n: int, device, traced: bool = False,
                  keep_graph: bool = False) -> StepProgram:
    """The exact chunk of ``n`` frames (``traced``: with the mapping trace)
    as one CUDA graph over a staging slot of float32 frames."""
    mats = frontend_matrices(config, device)
    cam = config.camera

    def fn(state, frames, imu, dts):
        if traced:
            s, odo, trace = step_chunk_traced(state, frames, imu, dts, config, mats)
            return s, odo, pack_trace(trace)
        return step_chunk(state, frames, imu, dts, config, mats)

    layout = SlotLayout(n, (cam.rows, cam.cols), np.float32, config.imu.sample_max)
    words = trace_words(config.detector.keylines_max) if traced else 0
    return StepProgram(fn, layout, device, 1, graph=True, copy_stream=torch.cuda.Stream(device),
                       trace_words=words, keep_graph=keep_graph)


def bench_chunked(config: PipelineConfig, n_frames: int, seq=None, label: str = "") -> float:
    """Steady-state frames/s of the exact chunk of ``n_frames`` frames, its
    inputs on the card, replayed as one CUDA graph from a state that each
    replay carries on.  Prints the program's capture seconds, graph nodes
    and peak device memory on a line of its own."""
    dev = resolve_device("cuda")
    frames, imu, dts = chunk_inputs(config, n_frames, seq, dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    prog = chunk_program(config, n_frames, dev, keep_graph=True)
    k = prog.stage_resident(frames, imu, dts)
    state = T.init_vio_state(config, dev)
    t0 = time.perf_counter()
    state, _odo, _ev = prog.run(k, state)       # warm-up twice, capture, replay
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t0
    state, _odo, _ev = prog.run(k, state)
    torch.cuda.synchronize()
    n_iter = max(48 // n_frames, 2)
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(n_iter):
            state, odo, _ev = prog.run(k, state)
        torch.cuda.synchronize()
        best = min(best, time.perf_counter() - t0)
    if not bool(torch.isfinite(odometry_view(odo).position).all()):
        raise RuntimeError(f"bench_chunked {label} n={n_frames}: non-finite positions")
    print(json.dumps({"chunk_program": label, "n": n_frames, "capture_s": capture_s,
                      "graph_nodes": prog._graph.nodes(),
                      "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 2 ** 30}),
          flush=True)
    return n_iter * n_frames / best


def bench_streaming(config: PipelineConfig, runs: int = 5, n_s: int = 16) -> dict:
    """Streaming: one replay a frame, undistortion on the card, frame i+1
    uploaded while step i runs (the reference's live regime; its 31.71
    frames/s is a streaming number).  The median over ``runs`` passes with
    [min, max]; then the resident variant: ``process_frame`` on frames
    already on the card, which must give the streaming run's odometry bit
    for bit."""
    from rebvio_tpu_torch.runner import VioRunner

    dev = resolve_device("cuda")
    seq = sequence(config.camera, n_s, True)
    runner = VioRunner(config, undistort=True, device=dev)
    res = runner.run(seq)                       # capture + warm
    fps_s = []
    for _ in range(runs):
        runner.reset()
        t0 = time.perf_counter()
        res = runner.run(seq)
        fps_s.append(n_s / (time.perf_counter() - t0))

    dev_frames = [torch.from_numpy(seq.images[i]).to(dev) for i in range(n_s)]
    torch.cuda.synchronize()
    fps_r = []
    for _ in range(runs):
        runner.reset()
        t0 = time.perf_counter()
        for i in range(n_s):
            odo = runner.process_frame(dev_frames[i], int(seq.ts_us[i]), seq.imu_ts_us,
                                       seq.imu_gyro, seq.imu_acc)
        last = odo.position.cpu().numpy()
        fps_r.append(n_s / (time.perf_counter() - t0))
    if not np.array_equal(last, res.position[-1]):
        raise RuntimeError(f"bench_streaming: the resident run ends at {last}, the streaming "
                           f"run at {res.position[-1]}")
    s_med, s_spread = median_spread(fps_s)
    r_med, r_spread = median_spread(fps_r)
    return {"streaming_fps": s_med, "streaming_spread": s_spread,
            "streaming_fps_resident": r_med, "resident_spread": r_spread, "runs": runs}


def bench_realtime(config: PipelineConfig, n_frames: int = 120, speeds=SPEEDS) -> dict:
    """Keep-up envelope: frames paced at the sensor rate x speed with a
    queue of 20 (the reference's image subscriber queue), the speed swept
    until frames drop; worst latency against the 20 Hz sensor's 50 ms."""
    from rebvio_tpu_torch.runner import VioRunner

    seq = sequence(config.camera, n_frames, True)
    runner = VioRunner(config, undistort=True, device="cuda")
    runner.run(sequence(config.camera, min(4, n_frames), True))   # capture + warm
    envelope = []
    max_ok = 0.0
    for sp in speeds:
        runner.reset()
        rt = runner.run_realtime(seq, speed=sp, queue_size=20)
        envelope.append({"speed": sp, "processed": rt.processed, "dropped": rt.dropped,
                         "worst_latency_ms": rt.worst_latency_s * 1e3})
        if rt.dropped == 0:
            max_ok = sp
        else:
            break
    return {"frames": n_frames, "frame_budget_ms": 50.0, "queue_size": 20,
            "envelope": envelope, "max_zero_drop_speed": max_ok}


def bench_mapped(config: PipelineConfig, chunk: int = 8, n_frames: int = 64) -> dict:
    """``run_mapped`` (the keyframe-map builder fed from the traced chunk)
    against the plain chunked run at the same chunk size, interleaved 5
    times, medians; then the device ms of one replay of the exact and the
    traced chunk programs, their inputs on the card, timed in turns: CUDA
    events on the replaying stream around 6 replays queued back to back
    (the device's clock, not the host's)."""
    from rebvio_tpu_torch.ba.keyframe_map import KeyframeMapBuilder
    from rebvio_tpu_torch.runner import VioRunner

    dev = resolve_device("cuda")
    seq = sequence(config.camera, n_frames)
    runner = VioRunner(config, undistort=False, device=dev)

    def plain():
        runner.reset()
        t0 = time.perf_counter()
        runner.run(seq, chunk=chunk)
        return n_frames / (time.perf_counter() - t0)

    def mapped():
        runner.reset()
        builder = KeyframeMapBuilder(config, kf_every=chunk, kf_phase=chunk - 1,
                                     store_maps=True)
        t0 = time.perf_counter()
        runner.run_mapped(seq, builder, chunk=chunk)
        return n_frames / (time.perf_counter() - t0)

    plain(), mapped()
    ps, ms = [], []
    for _ in range(5):
        ps.append(plain())
        ms.append(mapped())
    plain_fps, mapped_fps = float(np.median(ps)), float(np.median(ms))

    frames, imu, dts = chunk_inputs(config, chunk, None, dev)
    progs = {}
    for traced in (False, True):
        prog = chunk_program(config, chunk, dev, traced=traced)
        k = prog.stage_resident(frames, imu, dts)
        s = T.init_vio_state(config, dev)
        for _ in range(2):
            s, _o, _e = prog.run(k, s)
        progs[traced] = [prog, k, s, float("inf")]
    torch.cuda.synchronize()
    # the two programs in turns, each its best round (the card's speed
    # drifts between rounds: PERF.md section 7)
    for _ in range(3):
        for p in progs.values():
            prog, k, s, best = p
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            for _ in range(6):
                s, _o, _e = prog.run(k, s)
            end.record()
            end.synchronize()
            p[2], p[3] = s, min(best, start.elapsed_time(end) / 6 / 1e3)

    return {"chunk": chunk, "plain_fps": plain_fps, "mapped_fps": mapped_fps,
            "plain_spread": [min(ps), max(ps)], "mapped_spread": [min(ms), max(ms)],
            "mapped_over_plain": plain_fps / mapped_fps,
            "device_chunk_ms_plain": progs[False][3] * 1e3,
            "device_chunk_ms_traced": progs[True][3] * 1e3}


def nvidia_smi(query: str = "name,power.limit,clocks.sm") -> list:
    """One card's ``nvidia-smi --query-gpu=<query>`` fields."""
    out = subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return [f.strip() for f in out.stdout.strip().splitlines()[0].split(",")]


def assemble(profiles: dict, n_frames: int, ref_fps: float, streaming: dict, roofline: dict,
             device: dict) -> dict:
    """The result line: the JAX bench's keys (its print at the end of
    main), plus ``device``.  ``profiles``: name -> {"fps", "vs_baseline",
    "keylines_max", "tube_probes"[, "low_latency_fps"]}."""
    head_name = "fast" if "fast" in profiles else list(profiles)[0]
    head = profiles[head_name]
    return {
        "metric": "vio_frames_per_second_single_chip",
        "value": head["fps"],
        "unit": f"frames/s (752x480 full-res VIO, {head_name} profile headline, "
                f"{head['keylines_max']} keylines max, {n_frames}-frame chunks as one CUDA "
                f"graph; 'profiles' carries fast AND the reference's 16k-keyline parity "
                f"setting)",
        "vs_baseline": head["vs_baseline"],
        "reference_fps_measured": ref_fps,
        "profiles": profiles,
        **streaming,
        **roofline,
        "device": device,
    }


def main(runs: int = 5, speeds=SPEEDS, rt_frames: int = 120, mapped_frames: int = 64) -> dict:
    """The whole bench; the keyword arguments cut the streaming, realtime
    and mapped sections (the defaults are the JAX bench's).  Prints the
    result line and returns it."""
    resolve_device("cuda")
    only = os.environ.get("BENCH_PROFILE", "")
    n_frames = int(os.environ.get("BENCH_CHUNK", "512"))
    ref_fps = reference_fps()
    clock_before = nvidia_smi()
    configs = {}
    if only in ("", "fast"):
        configs["fast"] = fast_profile()
    if only in ("", "parity"):
        configs["parity"] = PipelineConfig()
    cam = next(iter(configs.values())).camera
    seq = sequence(cam, n_frames)

    profiles = {}
    for name, cfg in configs.items():
        fps = bench_chunked(cfg, n_frames, seq, name)
        p = {"fps": fps, "vs_baseline": fps / ref_fps,
             "keylines_max": cfg.detector.keylines_max, "tube_probes": cfg.edge_map.tube_probes}
        if os.environ.get("BENCH_LOWLAT", "1") != "0":
            p["low_latency_fps"] = bench_chunked(cfg, 2, seq, name)
        profiles[name] = p

    head_cfg = configs.get("fast", next(iter(configs.values())))
    streaming = {}
    if os.environ.get("BENCH_STREAMING", "1") != "0":
        streaming["streaming"] = {name: bench_streaming(cfg, runs)
                                  for name, cfg in configs.items()}
        fast_s = streaming["streaming"].get("fast", next(iter(streaming["streaming"].values())))
        streaming["streaming_fps"] = fast_s["streaming_fps"]
        streaming["streaming_fps_resident"] = fast_s["streaming_fps_resident"]
    if os.environ.get("BENCH_REALTIME", "1") != "0":
        streaming["realtime"] = {name: bench_realtime(cfg, rt_frames, speeds)
                                 for name, cfg in configs.items()}
        rt_f = streaming["realtime"].get("fast", next(iter(streaming["realtime"].values())))
        streaming["realtime_1x"] = rt_f["envelope"][0]
    if os.environ.get("BENCH_MAPPED", "1") != "0":
        streaming["mapped"] = bench_mapped(head_cfg, n_frames=mapped_frames)

    roofline = {}
    if os.environ.get("BENCH_ROOFLINE", "1") != "0":
        from rebvio_tpu_torch.tools import roofline as rf

        r = rf.measure()
        roofline = {"jtj_roofline_fraction": r["gather_ceiling_fraction"],
                    "try_vel_pass_us": r["try_vel_pass_us"]}
        sc = rf.measure_stages()
        roofline["stage_ceilings"] = {
            "detect_vs_mxu": sc["detect_ceiling_fraction"],
            "jfa_vs_hbm": sc["jfa_ceiling_fraction"],
            "tube_vs_gather": sc["tube_ceiling_fraction"],
            "detect_ms": sc["detect_ms"], "jfa_ms": sc["jfa_ms"], "tube_ms": sc["tube_ms"],
            "gather_row_bw_gbs": sc["gather_row_bw_gbs"]}
        print(json.dumps({"roofline": r, "stage_ceilings": sc}), flush=True)

    clock_after = nvidia_smi()
    device = {"name": clock_before[0], "power_limit": clock_before[1],
              "sm_clock_before": clock_before[2], "sm_clock_after": clock_after[2],
              "count": torch.cuda.device_count()}
    out = assemble(profiles, n_frames, ref_fps, streaming, roofline, device)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
