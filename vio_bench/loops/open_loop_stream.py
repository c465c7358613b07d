"""Open loop: one live stream at the sensor rate.

Frame k of the window is due at t0 + k / rate whether or not the frames
before it are done; the harness hands the distorted uint8 frame (in host
memory, as a camera delivers it) and the IMU stream to
``VioRunner(config, undistort=True).process_frame`` and reads that frame's
pose back to the host.  A frame's latency runs from its due time to its
pose on the host, so a stall delays every frame queued behind it; a frame
over ``latency_budget_ms``, or one whose pose comes back with tracking
lost, counts as failed.  The warm-up frames (the first of them captures the
step's CUDA graph) go before the window, unpaced.

Traffic keys: ``rate_hz``, ``warmup_frames``, ``latency_budget_ms``,
``check_steps`` (window frames held to the reference besides the stream's
first), ``trace_frames`` (the last window frames under the profiler in a
``--trace 1`` run), ``stage_steps`` (staged steps profiled after the
window), ``scene`` (frames.make_stream)."""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import time

import numpy as np
import torch

from vio_bench import check, frames, stats
from vio_bench.harness import Outcome, Sample, snapshot
from vio_bench.trace import Profile, Trace, span, stage_device_ms

SPIN_S = 0.002      # the last stretch before a due time is spun, not slept


def _wait_until(t: float) -> None:
    while True:
        left = t - time.perf_counter()
        if left <= 0:
            return
        if left > SPIN_S:
            time.sleep(left - SPIN_S)


def _read(odo) -> dict:
    """The pose of one frame on the host: one copy."""
    row = torch.cat([odo.orientation, odo.position, odo.num_matches.view(torch.float32)[None],
                     odo.run_ok.to(torch.float32)[None]]).cpu()
    return {"orientation": row[0:3].numpy(), "position": row[3:6].numpy(),
            "num_matches": row[6:7].view(torch.int32).numpy()[0], "run_ok": bool(row[7] > 0.5)}


def run(ctx) -> Outcome:
    from rebvio_tpu_torch import pipeline as P
    from rebvio_tpu_torch import types as T
    from rebvio_tpu_torch.ops.imu import pack_imu_window
    from rebvio_tpu_torch.runner import VioRunner

    tr, cfg = ctx.traffic, ctx.config
    parts = {"start": time.perf_counter() - ctx.t_start}
    rate = float(tr["rate_hz"])
    n_warm, n = int(tr["warmup_frames"]), int(round(rate * ctx.seconds))
    made = frames.make_stream(cfg.camera, tr["scene"], n_warm + n + 1, ctx.seed, 0, ctx.device)
    stream = dataclasses.replace(made, images=made.images.cpu().numpy())
    del made
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(ctx.device)
    images, ts = stream.images, stream.ts_us
    imu = (stream.imu_ts_us, stream.imu_gyro, stream.imu_acc)
    parts["frames"] = time.perf_counter() - ctx.t_start
    runner = VioRunner(cfg, undistort=True, device=ctx.device)
    parts["runner"] = time.perf_counter() - ctx.t_start

    # the stream's first frame (from the initial state) and window frames
    # drawn from the seed
    picks = ctx.check_rng.choice(n, int(tr["check_steps"]), replace=False) + n_warm
    sampled = {0, *(int(i) for i in picks)}
    before, after = {}, {}

    def step(i: int, traced: bool):
        with span("process_frame", traced):
            t_call = time.perf_counter()
            odo = runner.process_frame(images[i], int(ts[i]), *imu)
            t_ret = time.perf_counter()
        with span("read_pose", traced):
            pose = _read(odo)
        return pose, t_call, t_ret

    def keep(i: int, pose) -> None:
        """The states around sampled steps, copied once frame i's pose is
        on the host (in the wait for the next frame)."""
        if i in sampled:
            after[i] = (pose, snapshot(runner.state))
        if i + 1 in sampled:
            before[i + 1] = snapshot(runner.state)

    for i in range(n_warm):
        keep(i, step(i, False)[0])
        if i == 0:
            parts["first_frame"] = time.perf_counter() - ctx.t_start
    ctx.sync()
    # what set-up left is never collected in the window
    gc.collect()
    gc.freeze()
    out = Outcome()
    out.setup_s = time.perf_counter() - ctx.t_start

    n_traced = min(int(tr["trace_frames"]), n) if ctx.trace else 0
    prof = Profile(ctx.device) if n_traced else None
    lat, late, host_s, after_s = [], [], [], []
    failed = 0
    t0 = time.perf_counter() + SPIN_S
    for k in range(n):
        traced = k >= n - n_traced
        if traced and k == n - n_traced:
            prof.start()
        due = t0 + k / rate
        with span("wait_due", traced):
            _wait_until(due)
        pose, t_call, t_ret = step(n_warm + k, traced)
        done = time.perf_counter()
        keep(n_warm + k, pose)
        lat.append(done - due)
        late.append(t_call - due)
        if not traced:
            host_s.append(t_ret - t_call)
            after_s.append(done - t_ret)
        failed += (done - due) * 1e3 > tr["latency_budget_ms"] or not pose["run_ok"]
    t_end = time.perf_counter()
    if prof is not None:
        prof.stop()
    if ctx.device.type == "cuda":
        out.memory_peak_bytes = int(torch.cuda.max_memory_allocated(ctx.device))

    stages = {}
    if ctx.trace:
        # the staged step (pipeline.step_stages, the body pipeline.step runs)
        # on a copy of the runner's state and the next frame
        i = n_warm + n
        st = T.tree_map(torch.clone, runner.state)
        lo = int(np.searchsorted(imu[0], ts[i - 1], side="right"))
        hi = int(np.searchsorted(imu[0], ts[i], side="right"))
        win = pack_imu_window(stream.imu_gyro[lo:hi], stream.imu_acc[lo:hi], imu[0][lo:hi],
                              cfg.imu.sample_max, device=ctx.device)
        frame = runner.undistorter(torch.as_tensor(images[i]).to(ctx.device))
        dt = (int(ts[i]) - int(ts[i - 1])) / 1e6
        mats = P.frontend_matrices(cfg, ctx.device)

        def staged(around):
            gen = P.step_stages(st, frame, win, dt, cfg, mats)
            for name in P.STAGES:
                with around(name):
                    got = next(gen)
                if got != name:
                    raise RuntimeError(f"stage {got!r} where {name!r} was expected")
            T.finish(gen)

        staged(lambda name: contextlib.nullcontext())            # warm
        stages = stage_device_ms(staged, int(tr["stage_steps"]), ctx.device, P.STAGES)
        out.trace = Trace(prof, n_traced, 1, {}, {"process_frame": host_s,
                                                  "frame_latency": lat[:n - n_traced]}, stages)

    ms = [x * 1e3 for x in lat]
    out.metrics = {"latency_p50_ms": stats.percentile(ms, 50)}
    out.attempted, out.failed = n, int(failed)
    out.notes = {"frames": n, "window_s": t_end - t0, "setup_parts_s": parts,
                 "generator_late_ms_p50": stats.percentile([x * 1e3 for x in late], 50),
                 "generator_late_ms_max": max(late) * 1e3,
                 "latency_ms_percentiles": {q: stats.percentile(ms, q) for q in (5, 25, 75, 95, 99)},
                 "latency_ms_max": max(ms),
                 "latency_ms_top": sorted(((x, k) for k, x in enumerate(ms)), reverse=True)[:5],
                 "call_ms_p50": stats.percentile([x * 1e3 for x in host_s], 50) if host_s else None,
                 "return_to_pose_ms_p50": (stats.percentile([x * 1e3 for x in after_s], 50)
                                           if after_s else None),
                 "over_budget": int(sum(x > tr["latency_budget_ms"] for x in ms)),
                 # the card's slow state (a replay ~0.6 ms longer) shows as
                 # a step in this series
                 "return_to_pose_ms_p50_by_100": [
                     stats.percentile([x * 1e3 for x in after_s[i:i + 100]], 50)
                     for i in range(0, len(after_s), 100)]}
    for i in sorted(sampled):
        pose, st_after = after[i]
        out.samples.append(Sample(stream, i, before.get(i), check.record(pose, st_after)))
    del runner
    return out

