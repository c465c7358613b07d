"""Per-stage timing of the VIO step (the JAX package's
tools/profile_stages.py).

    python -m rebvio_tpu_torch.tools.profile_stages [--matcher tube|walk]
        [--df jfa|raster] [--profile parity|fast] [--iters 20] [--out FILE]

The staged function is ``pipeline.step`` itself: ``pipeline.step_stages``,
which ``step`` runs to its end, yields at the stage boundaries of
``pipeline.STAGES`` (JAX's nine stages plus "sab": JAX's prefix leaves the
gyro-bias fusion, the acceleration estimators and the SAB filter to its
"step (scalar out)" remainder).

Two readings, on the VIO step with the SAB filter engaged (16 warm-up
frames of synthetic seed 0, undistorted, as profile_step --vio warms up):

  * JAX's method: the prefix up to each stage captured as one CUDA graph
    and replayed (PyTorch runs every operation issued, so no scalar
    reduction is needed to keep work alive); cumulative ms and deltas,
    beside the replayed ``pipeline.step``; every graph timed once a round,
    ROUNDS rounds; each prefix's time is its median share of
    ``pipeline.step``'s time in the same round, times the step's median:
    the card switches between two speeds ~20 % apart, and a round that
    straddles the switch would otherwise mix them;
  * ``torch.profiler``: the whole staged step eagerly, each stage inside a
    ``record_function`` range of this tool that ends with a device
    synchronization, so each device operation falls in the range that
    launched it: device ms and operations a stage, and its share of the
    step's operations.

Each stage is printed beside REFERENCE_BASELINE.json's per_stage_ms (the
C++ reference's own stage timers) where the reference has one.  The last
line is one JSON object.  Needs a GPU.
"""

from __future__ import annotations

import argparse
import json
import statistics

import torch

from rebvio_tpu_torch import resolve_device
from rebvio_tpu_torch import types as T
from rebvio_tpu_torch.configs import PipelineConfig, fast_profile
from rebvio_tpu_torch import pipeline as P
from rebvio_tpu_torch.pipeline import STAGES

# REFERENCE_BASELINE.json's per_stage_ms key of each stage the reference times
REFERENCE_STAGE = {"detect": "edge_detector_detect", "att_field": "build_distance_field",
                   "minimize_vel": "minimize_vel", "ext_rot_vel": "ext_rot_vel",
                   "directed_match": "directed_match"}
ROUNDS = 7              # rounds over all the graphs


def staged_step(state, frame, imu_data, frame_dt, config, mats=None, upto: int = None,
                around=None):
    """Run ``pipeline.step_stages``: to its end (returns (state',
    odometry)), or through stage ``upto`` of STAGES only (returns None).
    ``around(name)``: a context manager entered around each stage's
    operations."""
    gen = P.step_stages(state, frame, imu_data, frame_dt, config, mats)
    for k, name in enumerate(STAGES):
        if around is None:
            got = next(gen)
        else:
            with around(name):
                got = next(gen)
        if got != name:
            raise RuntimeError(f"stage {k} is {got!r}, STAGES says {name!r}")
        if upto is not None and k == upto:
            gen.close()
            return None
    try:
        next(gen)
    except StopIteration as done:
        return done.value
    raise RuntimeError("stages yielded past STAGES")


def _warmed(config: PipelineConfig, dev, warm: int):
    """State after ``warm`` steps of synthetic seed 0 (undistorted, as the
    JAX tool's), and frame ``warm``'s inputs.  Returns (state, frame, imu,
    dt, mats)."""
    from rebvio_tpu_torch.bench import chunk_inputs, sequence

    mats = P.frontend_matrices(config, dev)
    frames, imu, dts = chunk_inputs(config, warm + 1, sequence(config.camera, warm + 1), dev)
    state = T.init_vio_state(config, dev)
    for i in range(warm):
        state, _odo = P.step(state, frames[i], T.tree_map(lambda x: x[i], imu), dts[i], config,
                             mats)
    return state, frames[warm], T.tree_map(lambda x: x[warm], imu), dts[warm], mats


def profile_ranges(fn_stage, n: int):
    """``fn_stage(around)`` (the staged step with ``around`` entered around
    each stage) ``n`` times under ``torch.profiler``; each range ends with a
    device synchronization.  Returns name -> (device ms, operations) per
    call, and the unattributed device operations' (ms, count) per call."""
    from contextlib import contextmanager

    @contextmanager
    def around(name):
        with torch.profiler.record_function("stage:" + name):
            yield
            torch.cuda.synchronize()

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(n):
            fn_stage(around)
        torch.cuda.synchronize()
    events = prof.events()
    ranges = [(e.time_range.start, e.time_range.end, e.name[len("stage:"):]) for e in events
              if e.device_type == torch.autograd.DeviceType.CPU and e.name.startswith("stage:")]
    ranges.sort()
    per = {name: [0.0, 0] for name in STAGES}
    loose = [0.0, 0]
    for e in events:
        if e.device_type != torch.autograd.DeviceType.CUDA or e.name.startswith("stage:"):
            continue
        t = e.time_range.start
        hit = next((name for a, b, name in ranges if a <= t <= b), None)
        acc = per[hit] if hit is not None else loose
        acc[0] += e.time_range.elapsed_us() / 1e3
        acc[1] += 1
    return ({k: (v[0] / n, v[1] / n) for k, v in per.items()}, (loose[0] / n, loose[1] / n))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--matcher", default=None, choices=["tube", "walk"])
    ap.add_argument("--df", default=None, choices=["jfa", "raster"])
    ap.add_argument("--iters", type=int, default=20, help="replays a graph a round")
    ap.add_argument("--profile", default="parity", choices=["parity", "fast"])
    ap.add_argument("--profiled", type=int, default=5,
                    help="staged steps under torch.profiler")
    ap.add_argument("--out", default=None, help="also write the JSON line here")
    args = ap.parse_args(argv)
    dev = resolve_device("cuda")
    from rebvio_tpu_torch.bench import REFERENCE_BASELINE
    from rebvio_tpu_torch.configs import default_df_mode
    from rebvio_tpu_torch.graph import CapturedGraph

    kw = {}
    if args.matcher:
        kw["matcher"] = args.matcher
        kw["df_mode"] = default_df_mode(args.matcher, args.df)
    elif args.df:
        kw["df_mode"] = args.df
    config = fast_profile(**kw) if args.profile == "fast" else PipelineConfig(**kw)
    warm = 4 + config.imu.init_bias_frame_num + 2        # the SAB filter engaged
    state, frame, imu, dt, mats = _warmed(config, dev, warm)
    torch.cuda.synchronize()

    def prefix(k):
        return lambda: staged_step(state, frame, imu, dt, config, mats, upto=k)

    graphs = [CapturedGraph(prefix(k)) for k in range(len(STAGES))]
    graphs.append(CapturedGraph(lambda: staged_step(state, frame, imu, dt, config, mats)))
    graphs.append(CapturedGraph(lambda: P.step(state, frame, imu, dt, config, mats)))
    # rounds over all the graphs; each graph as a share of the step in the
    # same round, the median share over the rounds
    rounds = [[g.seconds(n=args.iters, repeats=1) for g in graphs] for _ in range(ROUNDS)]
    t_step = statistics.median(r[-1] for r in rounds)
    share = [statistics.median(r[i] / r[-1] for r in rounds) for i in range(len(graphs))]
    cum, t_staged = [s * t_step for s in share[:len(STAGES)]], share[-2] * t_step
    dev_stage, loose = profile_ranges(
        lambda around: staged_step(state, frame, imu, dt, config, mats, around=around),
        args.profiled)

    with open(REFERENCE_BASELINE) as f:
        ref = json.load(f)["per_stage_ms"]
    ops_total = sum(v[1] for v in dev_stage.values()) + loose[1]
    rows, prev = [], 0.0
    for name, t in zip(STAGES, cum):
        ms, ops = dev_stage[name]
        rows.append({"stage": name, "cum_ms": t * 1e3, "delta_ms": (t - prev) * 1e3,
                     "device_ms": ms, "operations": ops,
                     "share_of_operations": ops / ops_total if ops_total else None,
                     "reference_ms": ref.get(REFERENCE_STAGE.get(name, ""))})
        prev = t
    for r in rows:
        print(f"{r['stage']:16s} cum {r['cum_ms']:8.3f} ms  delta {r['delta_ms']:8.3f} ms  "
              f"device {r['device_ms']:8.4f} ms  ops {r['operations']:7.1f} "
              f"({100 * (r['share_of_operations'] or 0):5.1f} %)  reference "
              f"{r['reference_ms'] if r['reference_ms'] is not None else '-'}")
    print(f"{'staged step':16s} cum {t_staged * 1e3:8.3f} ms")
    print(f"{'pipeline.step':16s} cum {t_step * 1e3:8.3f} ms  "
          f"(deltas sum to {100 * cum[-1] / t_step:.1f} % of it)")
    out = {"matcher": config.matcher, "df_mode": config.df_mode, "profile": args.profile,
           "device": torch.cuda.get_device_name(0), "warm_frames": warm, "stages": rows,
           "deltas_sum_ms": cum[-1] * 1e3, "staged_step_ms": t_staged * 1e3,
           "step_ms": t_step * 1e3, "deltas_over_step": cum[-1] / t_step,
           "step_ms_rounds": [r[-1] * 1e3 for r in rounds],
           "profiled_step_device_ms": sum(v[0] for v in dev_stage.values()) + loose[0],
           "profiled_step_operations": ops_total, "unattributed_operations": loose[1],
           "reference_state_estimation_loop_ms": ref.get("state_estimation_loop")}
    line = json.dumps(out)
    print(line, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return out


if __name__ == "__main__":
    main()
