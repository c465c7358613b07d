"""Frames/s against the sequence batch on one GPU (the JAX package's
tools/scaling_bench.py ``--batch-sweep``).

    python -m rebvio_tpu_torch.tools.scaling_bench [--batch-sweep 1,2,4,8]
        [--frames 16] [--profile fast|parity] [--out FILE]

For each batch size B: B copies of synthetic seed 0's first ``--frames``
frames (undistorted, as the JAX sweep's) through the batched runner
(``VioRunner(config, batch=B).run_batched``: one CUDA graph a batched
step, ``parallel.batch.batched_step`` inside), warmed up over 3 frames (the
capture), then the best of 3 passes from the initial state, each ending in
the odometry's read-back.  One JSON line a batch size with the JAX sweep's
fields (aggregate_fps, fps_per_sequence, efficiency_vs_b1 = fps(B) / (B x
fps(1))), then a summary line.  The JAX tool's device-count sweep is not
here: the card machine has one GPU.  Needs a GPU.
"""

from __future__ import annotations

import argparse
import json
import time

from rebvio_tpu_torch import resolve_device
from rebvio_tpu_torch.configs import PipelineConfig, fast_profile


def emit(obj, out_file=None) -> None:
    """Print one JSON line; with ``out_file``, also append it there."""
    line = json.dumps(obj)
    print(line, flush=True)
    if out_file:
        with open(out_file, "a") as f:
            f.write(line + "\n")


def batch_fps(config: PipelineConfig, seq, B: int, n_frames: int) -> float:
    """Aggregate frames/s of B lanes over ``n_frames`` frames each."""
    from rebvio_tpu_torch.runner import VioRunner

    runner = VioRunner(config, undistort=False, device="cuda", batch=B)
    seqs = [seq] * B
    runner.run_batched(seqs, frames=range(min(3, n_frames)))     # capture + warm
    best = float("inf")
    for _ in range(3):
        runner.reset()
        t0 = time.perf_counter()
        runner.run_batched(seqs, frames=range(n_frames))
        best = min(best, time.perf_counter() - t0)
    return n_frames * B / best


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch-sweep", default="1,2,4,8",
                    help="comma-separated sequence-batch sizes")
    ap.add_argument("--frames", type=int, default=16, help="frames per sequence a pass")
    ap.add_argument("--profile", default="fast", choices=["fast", "parity"])
    ap.add_argument("--out", default=None, help="also append each JSON line here")
    args = ap.parse_args(argv)
    resolve_device("cuda")
    import torch

    from rebvio_tpu_torch.bench import sequence

    config = fast_profile() if args.profile == "fast" else PipelineConfig()
    seq = sequence(config.camera, args.frames)
    results = {}
    for B in [int(x) for x in args.batch_sweep.split(",")]:
        fps = batch_fps(config, seq, B, args.frames)
        results[B] = fps
        emit({"batch": B, "devices": 1, "aggregate_fps": fps, "fps_per_sequence": fps / B,
              "efficiency_vs_b1": fps / (B * results[1]) if 1 in results else None,
              "profile": args.profile, "platform": "gpu",
              "device": torch.cuda.get_device_name(0)}, args.out)
    summary = {"results": results}
    if len(results) > 1:
        bmax = max(results)
        summary = {
            "metric": "batch_scaling_efficiency_single_chip", "batch": bmax,
            "value": results[bmax] / (bmax * results[1]) if 1 in results else None,
            "unit": f"aggregate fps(B={bmax}) / ({bmax} x fps(B=1)), {args.profile} profile, "
                    f"one device, one CUDA graph a batched step (vmapped batched_step)",
            "results": results}
        emit(summary, args.out)
    return summary


if __name__ == "__main__":
    main()
