"""Command-line dataset runner of the port (rebvio_tpu/run.py).

    python -m rebvio_tpu_torch.run --dataset synthetic --frames 120 --mode vio
    python -m rebvio_tpu_torch.run --dataset synthetic --mode vio --frames 120 --pose-graph

Runs on the GPU unless ``--device cpu`` is given.  Writes a reference-format
odometry file on request and prints one JSON line with the frame rate and
the ATE against the synthetic ground truth; with ``--pose-graph`` also the
keyframe pose graph's loop factors, cost and ATE before and after the
optimization.  Only what the port implements is offered: argparse rejects
every other flag of the JAX runner.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from rebvio_tpu_torch import eval as ev
from rebvio_tpu_torch.configs import (CameraConfig, CoreConfig, EdgeDetectorConfig,
                                      PipelineConfig)
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


def preset_config(preset: str, use_imu: bool) -> PipelineConfig:
    if preset == "euroc":
        return PipelineConfig(use_imu=use_imu)
    cam, det, core = PRESETS[preset]
    return PipelineConfig(camera=CameraConfig(**cam), detector=EdgeDetectorConfig(**det),
                          core=CoreConfig(**core), use_imu=use_imu)


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
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="cuda (default) runs the hand-written kernels on the GPU and "
                         "fails without one; cpu runs their plain PyTorch versions")
    args = ap.parse_args(argv)

    from rebvio_tpu_torch.data import synthetic

    config = preset_config(args.preset, use_imu=(args.mode == "vio"))
    seq = synthetic.generate(config.camera, n_frames=args.frames, seed=args.seed)
    gt = seq.gt_pos
    runner = VioRunner(config, undistort=False, device=args.device)
    on_gpu = runner.device.type == "cuda"

    mapper = None
    if args.pose_graph:
        from rebvio_tpu_torch.ba.keyframe_map import KeyframeMapBuilder

        mapper = KeyframeMapBuilder(config, kf_every=args.kf_every, store_maps=True,
                                    kf_phase=args.kf_every - 1)

    # one warm-up frame (kernel build, band matrices), so the fps figure is steady state
    runner.process_frame(np.asarray(seq.images[0]), int(seq.ts_us[0]) - 1,
                         np.asarray([], dtype=np.int64), np.zeros((0, 3)), np.zeros((0, 3)))
    runner.reset()
    if on_gpu:
        torch.cuda.synchronize()

    t0 = time.time()
    if mapper is None:
        res = runner.run(seq)
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
