"""Command-line dataset runner of the port (rebvio_tpu/run.py).

    python -m rebvio_tpu_torch.run --dataset synthetic --frames 120 --mode vio
    python -m rebvio_tpu_torch.run --dataset synthetic --mode vio --frames 120 --pose-graph
    python -m rebvio_tpu_torch.run --dataset synthetic --mode vio --frames 120 --chunk 8
    python -m rebvio_tpu_torch.run --dataset synthetic --mode vio --frames 120 --realtime 1.0
    python -m rebvio_tpu_torch.run --dataset synthetic --mode vio --frames 120 --matcher walk

Runs on the GPU unless ``--device cpu`` is given; there the step is one CUDA
graph a frame (``--chunk N``: a graph of N frames).  Writes a
reference-format odometry file on request and prints one JSON line with the
frame rate and the ATE against the synthetic ground truth; with
``--pose-graph`` also the keyframe pose graph's loop factors, cost and ATE
before and after the optimization; with ``--realtime`` the processed and
dropped frames and the worst latency.  ``--matcher walk`` runs the
reference's semantics (the pixel-walk matcher on the rasterized field, unless
``--df-mode jfa``); ``--chunk-mode pipelined`` holds the detection threshold
for each chunk.  Only what the port implements is offered: argparse rejects
every other flag of the JAX runner (``--ba`` among them).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

import numpy as np
import torch

from rebvio_tpu_torch import eval as ev
from rebvio_tpu_torch.configs import (CameraConfig, CoreConfig, EdgeDetectorConfig,
                                      PipelineConfig, default_df_mode)
from rebvio_tpu_torch.runner import RunResult, VioRunner

PRESETS = {
    "half": (dict(rows=240, cols=376, fx=229.3, fy=228.6, cx=183.6, cy=124.2,
                  k1=0, k2=0, k3=0, p1=0, p2=0),
             dict(keylines_max=4096, keylines_ref=3000),
             dict(search_range=20, global_min_matches_threshold=200)),
    "small": (dict(rows=120, cols=188, fx=114.6, fy=114.3, cx=91.8, cy=62.1,
                   k1=0, k2=0, k3=0, p1=0, p2=0),
              dict(keylines_max=2048, keylines_ref=1200),
              dict(search_range=10, global_min_matches_threshold=100)),
}


def preset_config(preset: str, use_imu: bool, **variants) -> PipelineConfig:
    """The preset's PipelineConfig; ``variants``: ``df_mode``, ``matcher``."""
    if preset == "euroc":
        return PipelineConfig(use_imu=use_imu, **variants)
    cam, det, core = PRESETS[preset]
    return PipelineConfig(camera=CameraConfig(**cam), detector=EdgeDetectorConfig(**det),
                          core=CoreConfig(**core), use_imu=use_imu, **variants)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dataset", choices=["synthetic"], default="synthetic")
    ap.add_argument("--mode", choices=["vio", "vo"], default="vio")
    ap.add_argument("--frames", type=int, default=120)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--odometry-out", default=None)
    ap.add_argument("--preset", choices=["euroc", "half", "small"], default="euroc",
                    help="camera/detector size preset (half/small for quick runs)")
    ap.add_argument("--pose-graph", action="store_true",
                    help="build a keyframe pose graph from the run (sequential odometry "
                         "factors + tracker-registered loop closures) and optimize it")
    ap.add_argument("--kf-every", type=int, default=5,
                    help="keyframe stride for --pose-graph; keyframes fire at frames "
                         "{kf-1, 2*kf-1, ...} (phase = kf_every-1)")
    ap.add_argument("--roll-sweep", type=float, default=0.0, metavar="DEG",
                    help="loop closure: extend the coarse yaw sweep to a 2-D yaw x roll "
                         "grid sweeping +-DEG about the optical axis (off by default: on "
                         "pure-yaw drift the extra candidates add selection noise)")
    ap.add_argument("--realtime", type=float, default=0.0, metavar="SPEED",
                    help="pace frames at sensor rate x SPEED with keep-up semantics: a "
                         "bounded queue drops frames when the estimator falls behind (the "
                         "reference's paced player and subscriber queues, "
                         "ros_rebvio.cpp:89-126); reports processed/dropped and the worst "
                         "latency")
    ap.add_argument("--rt-queue", type=int, default=2, help="realtime mode bounded queue depth")
    ap.add_argument("--chunk", type=int, default=0,
                    help="frames per replay (exact mode: the same results as streaming; "
                         "0/1 = streaming, one replay per frame)")
    ap.add_argument("--chunk-mode", choices=["pipelined", "exact"], default="exact",
                    help="pipelined = the chunk's detections at one threshold, taken ahead "
                         "of its estimates (the threshold controller updates once per "
                         "chunk); exact = per-frame streaming semantics")
    ap.add_argument("--matcher", choices=["tube", "walk"], default="tube",
                    help="epipolar matcher: the tube probe of the jump-flood field or the "
                         "reference's pixel walk")
    ap.add_argument("--df-mode", choices=["jfa", "raster"], default=None,
                    help="auxiliary field: the jump-flood attribute field (the default "
                         "with --matcher tube) or the reference's rasterized field (the "
                         "default with --matcher walk)")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="cuda (default) runs the hand-written kernels on the GPU and "
                         "fails without one; cpu runs their plain PyTorch versions")
    args = ap.parse_args(argv)

    from rebvio_tpu_torch.data import synthetic

    if args.realtime > 0 and (args.pose_graph or args.chunk):
        ap.error("--realtime is a streaming mode (no --pose-graph/--chunk)")
    if args.chunk and args.pose_graph:
        ap.error("--chunk with --pose-graph needs run_mapped, not ported yet")
    df_mode = default_df_mode(args.matcher, args.df_mode)
    if args.matcher == "tube" and df_mode != "jfa":
        ap.error("--matcher tube requires --df-mode jfa")
    pipelined = args.chunk_mode == "pipelined"
    config = preset_config(args.preset, use_imu=(args.mode == "vio"), matcher=args.matcher,
                           df_mode=df_mode)
    seq = synthetic.generate(config.camera, n_frames=args.frames, seed=args.seed)
    gt = seq.gt_pos
    runner = VioRunner(config, undistort=False, device=args.device)
    on_gpu = runner.device.type == "cuda"

    mapper = None
    if args.pose_graph:
        from rebvio_tpu_torch.ba.keyframe_map import KeyframeMapBuilder

        mapper = KeyframeMapBuilder(config, kf_every=args.kf_every, store_maps=True,
                                    kf_phase=args.kf_every - 1)

    # warm-up (kernel build, band matrices, the graphs' capture), so the fps
    # figure is steady state: one frame, and one chunk with --chunk
    runner.process_frame(np.asarray(seq.images[0]), int(seq.ts_us[0]) - 1,
                         np.asarray([], dtype=np.int64), np.zeros((0, 3)), np.zeros((0, 3)))
    if args.chunk > 1:
        runner.run(dataclasses.replace(seq, images=seq.images[:args.chunk],
                                       ts_us=seq.ts_us[:args.chunk]), chunk=args.chunk,
                   pipelined=pipelined)
    runner.reset()
    if on_gpu:
        torch.cuda.synchronize()

    t0 = time.time()
    rt = None
    if args.realtime > 0:
        rt = runner.run_realtime(seq, speed=args.realtime, queue_size=args.rt_queue)
        res = rt.result
    elif mapper is None:
        res = runner.run(seq, chunk=args.chunk, pipelined=pipelined)
    else:
        rows = []
        for i in range(len(seq.images)):
            odo = runner.process_frame(seq.images[i], int(seq.ts_us[i]), seq.imu_ts_us,
                                       seq.imu_gyro, seq.imu_acc)
            o, p = odo.orientation.cpu().numpy(), odo.position.cpu().numpy()
            mapper.add_frame(runner.state.edge_map, o, p, K_scale=float(runner.state.K))
            rows.append((int(seq.ts_us[i]), o, p, int(odo.num_matches), bool(odo.run_ok)))
        res = RunResult(*(np.asarray(c) for c in zip(*rows)))
    if on_gpu:
        torch.cuda.synchronize()
    elapsed = time.time() - t0
    n = len(res.ts_us)
    print(f"{n} frames in {elapsed:.2f}s ({n / elapsed:.1f} fps), "
          f"run_ok={bool(res.run_ok[-1])}", file=sys.stderr)

    if args.odometry_out:
        ev.write_odometry(args.odometry_out, res.ts_us, res.orientation, res.position)

    out = {"frames": n, "fps": n / elapsed, "run_ok": bool(res.run_ok[-1])}
    if rt is not None:
        out.update(realtime_speed=args.realtime, rt_processed=rt.processed,
                   rt_dropped=rt.dropped, rt_worst_latency_ms=rt.worst_latency_s * 1e3)
        gt = gt[rt.frame_idx]
    if mapper is not None and mapper.n_keyframes() >= 3:
        from rebvio_tpu_torch.ba import loop_closure as lc
        from rebvio_tpu_torch.ba import pose_graph as pgm

        kf_R = np.stack([k.R_wc for k in mapper.keyframes])
        kf_t = np.stack([k.t_wc for k in mapper.keyframes])
        g, n_loops = lc.build_graph_from_run(
            kf_R, kf_t, mapper.kf_maps, config, K_scale=float(runner.state.K),
            min_matches=int(config.core.global_min_matches_threshold),
            coarse_sweep2_deg=args.roll_sweep)
        g_opt, hist = pgm.optimize(g, iters=12)
        hist = hist.cpu().numpy()
        kf_idx = np.asarray([k.index for k in mapper.keyframes])
        out["pg_keyframes"] = mapper.n_keyframes()
        out["pg_loop_factors"] = n_loops
        out["pg_cost_before"] = float(hist[0])
        out["pg_cost_after"] = float(hist[-1])
        out["pg_ate_sim3_before"] = ev.ate_rmse(kf_t, gt[kf_idx], align=True, with_scale=True)
        out["pg_ate_sim3"] = ev.ate_rmse(g_opt.t.cpu().numpy(), gt[kf_idx], align=True,
                                         with_scale=True)
    out["ate_sim3"] = ev.ate_rmse(res.position, gt, align=True, with_scale=True)
    out["ate_se3"] = ev.ate_rmse(res.position, gt, align=True, with_scale=False)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
