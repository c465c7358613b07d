"""Times the VIO step per frame on the GPU, eager and as one CUDA graph a
frame, at the EuRoC parity profile (``PipelineConfig()``: 752x480, 16000
keylines, undistortion on the device) over the distorted seed-0
reference-anchor stream.

    python -m rebvio_tpu_torch.tools.eager_ab [--frames 40] [--rounds 3] [--out FILE]

Each mode warms up to the first frame with the SAB filter engaged, then
times ``--rounds`` runs of ``--frames`` consecutive frames through
``VioRunner.process_frame`` (the stream continues from round to round), each
run ended by a device synchronize.  Prints one JSON line: the ms per frame of
each round and mode, each mode's peak device memory
(``torch.cuda.max_memory_allocated`` from the runner's creation on, the
graph's capture included), the card's name and power limit.  It uses only entry
points that older checkouts have, so two checkouts can be timed on the same
card one after the other: copy this file into the other checkout's
``tools/`` and run it there.  Needs a GPU.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import torch

from rebvio_tpu_torch.configs import CameraConfig, PipelineConfig
from rebvio_tpu_torch.data import synthetic
from rebvio_tpu_torch.runner import VioRunner


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=40, help="frames a timed round")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--out", default=None, help="also write the JSON here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("eager_ab needs a GPU (torch.cuda.is_available() is False)")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True)
    cfg = PipelineConfig()
    warm = 4 + cfg.imu.init_bias_frame_num + 2       # first frame with SAB engaged
    n = warm + args.rounds * args.frames
    seq = synthetic.generate(CameraConfig(), n_frames=n, seed=0, distort=True,
                             imu_preroll_s=0.1)
    out = {"tool": "eager_ab", "card": card.stdout.strip(), "frames": args.frames,
           "warm_frames": warm}
    for mode, graph in (("eager", False), ("graph", True)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        runner = VioRunner(cfg, undistort=True, device="cuda", graph=graph)

        def frame(i):
            runner.process_frame(seq.images[i], int(seq.ts_us[i]), seq.imu_ts_us,
                                 seq.imu_gyro, seq.imu_acc)

        for i in range(warm):
            frame(i)
        torch.cuda.synchronize()
        rounds = []
        for r in range(args.rounds):
            t0 = time.perf_counter()
            for i in range(warm + r * args.frames, warm + (r + 1) * args.frames):
                frame(i)
            torch.cuda.synchronize()
            rounds.append((time.perf_counter() - t0) / args.frames * 1e3)
        out[f"{mode}_ms_per_frame"] = rounds
        out[f"{mode}_max_memory_allocated_gb"] = torch.cuda.max_memory_allocated() / 2 ** 30
        del runner
    line = json.dumps(out)
    print(line, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return out


if __name__ == "__main__":
    main()
