"""Where the time of the step goes on the GPU.

    python -m rebvio_tpu_torch.profile_step [--vio] [--graph] [--frames 8] [--out FILE]
        [--matcher walk] [--batch B]

Runs the parity-profile VO slice (752x480, 16000 keylines, 8 tube probes)
over synthetic seed 0, or with ``--vio`` the VIO slice (``PipelineConfig()``:
IMU, SAB filter, undistortion) over the distorted seed-0 reference-anchor
stream, through ``VioRunner.process_frame``: eager, or with ``--graph`` one
CUDA graph replay a frame.  ``--matcher walk`` profiles the
reference-semantics step (the pixel walk on the rasterized field; the field
follows the matcher, as in run.py).  Warm-up frames (2; with ``--vio`` up to the first
frame with the SAB filter engaged), then ``--frames`` frames under
``torch.profiler``, then the
same number again under ``torch.cuda.set_sync_debug_mode`` to count the
host syncs.  Prints one JSON line: the wall time per frame, the device's
busy and idle share of that wall time (union of the kernel intervals), the
device time per frame of each kernel name (top 12), the ported kernels'
device time, launches and share, and the host syncs per frame with the source
line of each.  ``--batch B`` runs B sequences in lockstep
(``VioRunner(batch=B).process_batch``: synthetic seeds 0..B-1, made in worker
processes) and reports the same per batched step, with the frames per
second over all lanes.  Needs a GPU.
"""

from __future__ import annotations

import argparse
import json
import time
import warnings
from collections import defaultdict

import torch

from rebvio_tpu_torch.configs import CameraConfig, PipelineConfig, default_df_mode
from rebvio_tpu_torch.data import synthetic
from rebvio_tpu_torch.runner import VioRunner

# kernel names (substrings of the device symbols) of the ported kernels
PORTED = {"att_flood": ("att_flood_kernel",),
          "minimize_vel": ("minimize_vel_kernel",),
          "tube_match": ("tube_match_kernel",),
          "reg_ekf": ("match_reg_ekf",),
          "reg_ekf_alone": ("reg_ekf_alone",),
          "estimate_bias": ("estimate_bias_kernel",),
          "chol_inverse": ("chol_inverse_kernel",),
          "band_matmul": ("band_matmul_left_kernel", "band_matmul_right_kernel")}


def _union_us(intervals):
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b <= end:
            continue
        total += b - max(a, end)
        end = b
    return total


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--vio", action="store_true", help="profile the VIO slice")
    ap.add_argument("--graph", action="store_true",
                    help="replay the step as a CUDA graph (default: eager)")
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--matcher", choices=["tube", "walk"], default="tube")
    ap.add_argument("--out", default=None, help="also write the JSON here")
    ap.add_argument("--batch", type=int, default=0,
                    help="B sequences in lockstep, one batched step a frame (0: one sequence)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_step needs a GPU (torch.cuda.is_available() is False)")

    variant = dict(matcher=args.matcher, df_mode=default_df_mode(args.matcher))
    if args.vio:
        cfg = PipelineConfig(**variant)
        warm = 4 + cfg.imu.init_bias_frame_num + 2   # first frame with SAB engaged: 16
    else:
        cfg = PipelineConfig(use_imu=False, **variant)
        warm = 2
    n = warm + 2 * args.frames
    gen = dict(n_frames=n, distort=args.vio, imu_preroll_s=0.1 if args.vio else 0.0)
    runner = VioRunner(cfg, undistort=args.vio, device="cuda", graph=args.graph,
                       batch=args.batch)
    if args.batch:
        import concurrent.futures as cf
        import functools
        import multiprocessing as mp

        with cf.ProcessPoolExecutor(min(args.batch, 8), mp.get_context("spawn")) as ex:
            seqs = list(ex.map(functools.partial(_stream, **gen), range(args.batch)))

        def frame(i):
            runner.process_batch(seqs, i)
    else:
        seq = synthetic.generate(CameraConfig(), seed=0, **gen)

        def frame(i):
            runner.process_frame(seq.images[i], int(seq.ts_us[i]), seq.imu_ts_us, seq.imu_gyro,
                                 seq.imu_acc)

    for i in range(warm):
        frame(i)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for i in range(warm, warm + args.frames):
            frame(i)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    # host syncs: each synchronizing CUDA call warns once under the debug mode
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            for i in range(warm + args.frames, n):
                frame(i)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    # (the mode's own "prototype feature" notice is not a sync)
    syncs = [w for w in caught if "synchronizing CUDA operation" in str(w.message)]
    sync_sites = defaultdict(int)        # source line of each synchronizing call
    for w in syncs:
        sync_sites[f"{w.filename.split('rebvio_tpu_torch/')[-1]}:{w.lineno}"] += 1

    by_name = defaultdict(float)
    count_by_name = defaultdict(int)
    intervals = []
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name] += e.time_range.elapsed_us()
            count_by_name[e.name] += 1
            intervals.append((e.time_range.start, e.time_range.end))
    busy_us = _union_us(intervals)
    dev_total = sum(by_name.values())
    ported = {k: sum(v for name, v in by_name.items() if any(s in name for s in subs))
              / args.frames / 1e3 for k, subs in PORTED.items()}
    ported_launches = {k: sum(c for name, c in count_by_name.items()
                              if any(s in name for s in subs)) / args.frames
                       for k, subs in PORTED.items()}
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    out = {
        "slice": "vio" if args.vio else "vo",
        "variant": variant,
        "mode": "graph" if args.graph else "eager",
        "batch": args.batch,
        "device": torch.cuda.get_device_name(0),
        "frames": args.frames,
        "wall_ms_per_frame": wall_us / args.frames / 1e3,
        "device_busy_ms_per_frame": busy_us / args.frames / 1e3,
        "device_busy_share": busy_us / wall_us if wall_us else None,
        "device_idle_share": 1.0 - busy_us / wall_us if wall_us else None,
        "kernel_launches_per_frame": len(intervals) / args.frames,
        "ported_kernels_ms_per_frame": ported,
        "ported_kernels_launches_per_frame": ported_launches,
        "ported_share_of_device_time": sum(ported.values()) * args.frames * 1e3 / dev_total
        if dev_total else None,
        "top_kernels_ms_per_frame": [[name[:80], us / args.frames / 1e3] for name, us in top],
        "host_syncs_per_frame": len(syncs) / args.frames,
        "host_syncs_per_frame_by_site": {k: v / args.frames
                                         for k, v in sorted(sync_sites.items())},
    }
    if args.batch:
        # a "frame" above is one batched step of B lanes
        out["frames_per_s_all_lanes"] = args.batch * args.frames / (wall_us / 1e6)
    line = json.dumps(out)
    print(line, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return out


def _stream(seed: int, **gen):
    return synthetic.generate(CameraConfig(), seed=seed, **gen)


if __name__ == "__main__":
    main()
