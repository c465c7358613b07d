"""Command-line dataset runner of the port (rebvio_tpu/run.py).

    python -m rebvio_tpu_torch.run --dataset synthetic --frames 120 --mode vio
    python -m rebvio_tpu_torch.run --dataset synthetic --mode vio --frames 120 --pose-graph
    python -m rebvio_tpu_torch.run --dataset synthetic --mode vio --frames 120 --ba
    python -m rebvio_tpu_torch.run --dataset synthetic --mode vio --frames 120 --chunk 8
    python -m rebvio_tpu_torch.run --dataset synthetic --mode vio --frames 120 --realtime 1.0
    python -m rebvio_tpu_torch.run --dataset synthetic --mode vio --frames 120 --matcher walk
    python -m rebvio_tpu_torch.run --dataset synthetic --mode vio --frames 60 --checkpoint-out ck.npz
    python -m rebvio_tpu_torch.run --dataset synthetic --mode vio --frames 120 --resume ck.npz
    python -m rebvio_tpu_torch.run --dataset euroc --root <ASL tree> --loader native

Runs on the GPU unless ``--device cpu`` is given; there the step is one CUDA
graph a frame (``--chunk N``: a graph of N frames).  Writes a
reference-format odometry file on request and prints one JSON line with the
frame rate and the ATE against the synthetic ground truth.  With a keyframe
map (``--ba``, ``--pose-graph``) the run maps at chunk speed
(``VioRunner.run_mapped``: ``--kf-every`` frames a graph, the map's trace
read back once a chunk; ``--chunk`` is then unused, as in JAX): ``--ba``
adds the Schur-complement bundle adjustment's keyframes, landmarks, RMS
reprojection error before and after and keyframe ATE; ``--pose-graph`` the
keyframe pose graph's loop factors, cost and ATE before and after the
optimization.  ``--realtime`` reports the processed and dropped frames and
the worst latency.  ``--matcher walk`` runs the reference's semantics (the
pixel-walk matcher on the rasterized field, unless ``--df-mode jfa``);
``--chunk-mode pipelined`` holds the detection threshold for each chunk.
``--checkpoint-out`` saves the state after the run (an ``.npz`` in the JAX
package's key paths); ``--resume`` copies a saved state (the port's or
JAX's) into the runner and continues the stream after the frames that state
has seen.  ``--timing`` prints section times to stderr.  ``--dataset euroc``
reads an ASL-format sequence (``--root``; ``--start`` / ``--end`` in seconds)
with the native prefetch ring or the in-process decoder (``--loader``; the
JSON line says which ran), undistorts it on the device and reports the ATE
against its ground truth, taken at the first ground-truth sample at or after
each frame; the calibration is EuRoC cam0 unless ``--camera-json`` gives
another.  ``--preset euroc-fast`` is ``configs.fast_profile``.
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
                                      PipelineConfig, default_df_mode, fast_profile)
from rebvio_tpu_torch.graph import copy_tree_
from rebvio_tpu_torch.runner import VioRunner
from rebvio_tpu_torch.utils import logging as rlog
from rebvio_tpu_torch.utils import timing

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


def preset_config(preset: str, use_imu: bool, camera_json: str = None,
                  **variants) -> PipelineConfig:
    """The preset's PipelineConfig; ``variants``: ``df_mode``, ``matcher``.
    ``camera_json``: the calibration file's camera with the default detector
    and core (not with ``euroc-fast``, whose profile wins, as in JAX)."""
    if preset == "euroc-fast":
        return fast_profile(use_imu=use_imu, **variants)
    if camera_json:
        return PipelineConfig(camera=CameraConfig.from_json(camera_json), use_imu=use_imu,
                              **variants)
    if preset == "euroc":
        return PipelineConfig(use_imu=use_imu, **variants)
    cam, det, core = PRESETS[preset]
    return PipelineConfig(camera=CameraConfig(**cam), detector=EdgeDetectorConfig(**det),
                          core=CoreConfig(**core), use_imu=use_imu, **variants)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dataset", choices=["synthetic", "euroc"], default="synthetic")
    ap.add_argument("--root", help="EuRoC sequence root (contains mav0/)")
    ap.add_argument("--camera-json", help="camera calibration JSON (default EuRoC cam0)")
    ap.add_argument("--start", type=float, default=None, help="euroc start [s]")
    ap.add_argument("--end", type=float, default=None, help="euroc end [s]")
    ap.add_argument("--loader", choices=["auto", "native", "python"], default="auto",
                    help="euroc image decode: native = the threaded C++ prefetch ring "
                         "(native/loader.cpp, built at first use into build/rebvio_loader/), "
                         "python = in process, auto = native when it builds here")
    ap.add_argument("--mode", choices=["vio", "vo"], default="vio")
    ap.add_argument("--frames", type=int, default=120,
                    help="synthetic frames (euroc runs the --start/--end window)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--odometry-out", default=None)
    ap.add_argument("--checkpoint-out", default=None,
                    help="save the estimator state after the run (.npz)")
    ap.add_argument("--resume", default=None,
                    help="start from a saved state (the port's or the JAX package's "
                         "checkpoint) and run the frames after those it has seen")
    ap.add_argument("--timing", action="store_true", help="print section times to stderr")
    ap.add_argument("--preset", choices=["euroc", "euroc-fast", "half", "small"],
                    default="euroc",
                    help="camera/detector size preset (half/small for quick runs; "
                         "euroc-fast = full resolution, 8k keylines, 4-probe matcher: "
                         "configs.fast_profile)")
    ap.add_argument("--ba", action="store_true",
                    help="build a keyframe map during the run and refine it with "
                         "Schur-complement bundle adjustment")
    ap.add_argument("--pose-graph", action="store_true",
                    help="build a keyframe pose graph from the run (sequential odometry "
                         "factors + tracker-registered loop closures) and optimize it")
    ap.add_argument("--kf-every", type=int, default=5,
                    help="keyframe stride for --ba/--pose-graph, and the mapped run's "
                         "frames a graph; keyframes fire at frames {kf-1, 2*kf-1, ...} "
                         "(phase = kf_every-1, at the end of each chunk)")
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

    log = rlog.init()
    timing.enable(args.timing)
    mapping = args.ba or args.pose_graph
    if args.realtime > 0 and (mapping or args.chunk):
        ap.error("--realtime is a streaming mode (no --ba/--pose-graph/--chunk)")
    df_mode = default_df_mode(args.matcher, args.df_mode)
    if args.matcher == "tube" and df_mode != "jfa":
        ap.error("--matcher tube requires --df-mode jfa")
    pipelined = args.chunk_mode == "pipelined"
    config = preset_config(args.preset, use_imu=(args.mode == "vio"),
                           camera_json=args.camera_json, matcher=args.matcher, df_mode=df_mode)
    extra = {}
    if args.dataset == "synthetic":
        seq = synthetic.generate(config.camera, n_frames=args.frames, seed=args.seed)
        gt = seq.gt_pos
    else:
        from rebvio_tpu_torch.data import euroc

        if not args.root:
            ap.error("--root required for euroc")
        seq = euroc.load(args.root, args.start, args.end, loader=args.loader,
                         rows=config.camera.rows, cols=config.camera.cols)
        extra["loader"] = seq.resolved_loader()
        gt = None
        if seq.gt_pos is not None:
            sel = np.clip(np.searchsorted(seq.gt_ts_us, seq.ts_us), 0, len(seq.gt_ts_us) - 1)
            gt = seq.gt_pos[sel]
    runner = VioRunner(config, undistort=args.dataset == "euroc", device=args.device)
    on_gpu = runner.device.type == "cuda"

    builder = None
    if mapping:
        from rebvio_tpu_torch.ba.keyframe_map import KeyframeMapBuilder

        def new_builder():
            # keyframes at the end of each chunk: run_mapped snapshots the
            # device edge map there without a per-frame readback
            return KeyframeMapBuilder(config, kf_every=args.kf_every, store_maps=args.pose_graph,
                                      kf_phase=args.kf_every - 1)

        builder = new_builder()

    # warm-up (kernel build, band matrices, the graphs' capture), so the fps
    # figure is steady state: one frame, and one chunk of the mode that runs
    runner.process_frame(np.asarray(seq.images[0]), int(seq.ts_us[0]) - 1,
                         np.asarray([], dtype=np.int64), np.zeros((0, 3)), np.zeros((0, 3)))
    warm = min(args.kf_every if mapping else args.chunk, len(seq.images))
    if warm > 1:
        head = _frames_from(seq, 0, warm)
        if mapping:
            runner.run_mapped(head, new_builder(), chunk=args.kf_every)
        else:
            runner.run(head, chunk=args.chunk, pipelined=pipelined)
    runner.reset()

    if args.resume:
        from rebvio_tpu_torch.utils import checkpoint

        # into the static state: the captured graphs hold its addresses
        copy_tree_(runner.state, checkpoint.load(args.resume, runner.state))
        start = int(runner.state.frames_seen)
        if not 0 < start < len(seq.images):
            ap.error(f"--resume: the state has seen {start} frames; --frames {args.frames} "
                     f"leaves none to run")
        runner.continue_after(int(seq.ts_us[start - 1]), seq.imu_ts_us)
        seq = _frames_from(seq, start)
        gt = None if gt is None else gt[start:]
        log.info("resumed state from %s after frame %d", args.resume, start - 1)
    if on_gpu:
        torch.cuda.synchronize()

    t0 = time.time()
    rt = None
    with timing.section("run", sync=runner.device):
        if args.realtime > 0:
            rt = runner.run_realtime(seq, speed=args.realtime, queue_size=args.rt_queue)
            res = rt.result
        elif builder is None:
            res = runner.run(seq, chunk=args.chunk, pipelined=pipelined)
        else:
            res = runner.run_mapped(seq, builder, chunk=args.kf_every)
    if on_gpu:
        torch.cuda.synchronize()
    elapsed = time.time() - t0
    n = len(res.ts_us)
    log.info("%d frames in %.2fs (%.1f fps), run_ok=%s", n, elapsed, n / elapsed,
             bool(res.run_ok[-1]))

    if args.odometry_out:
        ev.write_odometry(args.odometry_out, res.ts_us, res.orientation, res.position)
        log.info("odometry written to %s", args.odometry_out)
    if args.checkpoint_out:
        from rebvio_tpu_torch.utils import checkpoint

        checkpoint.save(args.checkpoint_out, runner.state)
        log.info("state checkpoint written to %s", args.checkpoint_out)

    out = {"frames": n, "fps": n / elapsed, "run_ok": bool(res.run_ok[-1]), **extra}
    if rt is not None:
        out.update(realtime_speed=args.realtime, rt_processed=rt.processed,
                   rt_dropped=rt.dropped, rt_worst_latency_ms=rt.worst_latency_s * 1e3)
        gt = None if gt is None else gt[rt.frame_idx]
    if args.pose_graph and builder.n_keyframes() >= 3:
        from rebvio_tpu_torch.ba import loop_closure as lc
        from rebvio_tpu_torch.ba import pose_graph as pgm

        with timing.section("pose_graph", sync=runner.device):
            kf_R = np.stack([k.R_wc for k in builder.keyframes])
            kf_t = np.stack([k.t_wc for k in builder.keyframes])
            g, n_loops = lc.build_graph_from_run(
                kf_R, kf_t, builder.kf_maps, config, K_scale=float(runner.state.K),
                min_matches=int(config.core.global_min_matches_threshold),
                coarse_sweep2_deg=args.roll_sweep)
            g_opt, hist = pgm.optimize(g, iters=12)
            hist = hist.cpu().numpy()
        kf_idx = np.asarray([k.index for k in builder.keyframes])
        out["pg_keyframes"] = builder.n_keyframes()
        out["pg_loop_factors"] = n_loops
        out["pg_cost_before"] = float(hist[0])
        out["pg_cost_after"] = float(hist[-1])
        if gt is not None:
            out["pg_ate_sim3_before"] = ev.ate_rmse(kf_t, gt[kf_idx], align=True,
                                                    with_scale=True)
            out["pg_ate_sim3"] = ev.ate_rmse(g_opt.t.cpu().numpy(), gt[kf_idx], align=True,
                                             with_scale=True)
    p = builder.build_problem(min_obs=2, device=runner.device) if args.ba else None
    if p is not None:
        from rebvio_tpu_torch.ba import problem as bap

        with timing.section("ba", sync=runner.device):
            terms0 = bap.accumulate_terms(p)
            p_opt, _ = bap.optimize(p, iters=10, huber_delta=3.0)
            terms1 = bap.accumulate_terms(p_opt)
        n_obs = max(int(terms0.n_obs), 1)
        kf_idx = np.asarray([k.index for k in builder.keyframes])
        out["ba_keyframes"] = builder.n_keyframes()
        out["ba_landmarks"] = int(p.lm_valid.sum())
        out["ba_rms_before_px"] = float(np.sqrt(float(terms0.cost) / n_obs))
        out["ba_rms_after_px"] = float(np.sqrt(float(terms1.cost) / n_obs))
        if gt is not None:
            out["ba_ate_sim3"] = ev.ate_rmse(p_opt.t.cpu().numpy(), gt[kf_idx], align=True,
                                             with_scale=True)
    if gt is not None:
        out["ate_sim3"] = ev.ate_rmse(res.position, gt, align=True, with_scale=True)
        out["ate_se3"] = ev.ate_rmse(res.position, gt, align=True, with_scale=False)
    print(json.dumps(out))
    if args.timing:
        print(timing.report(), file=sys.stderr)
    return 0


def _frames_from(seq, start: int, stop: int = None):
    """The sequence's frames ``start:stop`` (the IMU stream kept whole: the
    runner's cursor takes the samples each frame needs)."""
    if hasattr(seq, "image_paths"):         # EuRoC: the paths, decoded on access
        return dataclasses.replace(seq, image_paths=seq.image_paths[start:stop],
                                   ts_us=seq.ts_us[start:stop])
    return dataclasses.replace(seq, images=seq.images[start:stop], ts_us=seq.ts_us[start:stop],
                               gt_pos=seq.gt_pos[start:stop], gt_R_wc=seq.gt_R_wc[start:stop])


if __name__ == "__main__":
    sys.exit(main())
