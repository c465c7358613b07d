"""K7's (``kernels.nn_field``) cost per flood pass on the GPU.

    python -m rebvio_tpu_torch.tools.nn_passes

Runs K7 at search ranges 1, 5, 20 and 40 (16, 32, 48 and 56 dependent
passes), takes the device time of its flood kernels (names holding
``nn_``; the seeding's winner plane is left out) per call under
``torch.profiler``, and fits it by least squares over the pass count: the
slope is the cost of one pass, the intercept the fixed cost.  Two fields:
16x32 with 512 random keylines (one row per CTA of a 16-CTA cluster, so a
pass is little but its barrier or launch) and the fast profile's 240x376
with frame 1's keylines (8192, seed-0 synthetic sequence).  Prints one JSON
line per field; the card's name and power limit are printed first.  Uses
only names the port has had since K7 was first ported, so the same file
measures an older revision.
"""

from __future__ import annotations

import json
import subprocess

import torch

from rebvio_tpu_torch import resolve_device
from rebvio_tpu_torch.configs import fast_profile
from rebvio_tpu_torch.data import synthetic
from rebvio_tpu_torch.ops import distance_field as DF
from rebvio_tpu_torch.ops import edge_detect, kernels
from rebvio_tpu_torch.pipeline import frontend_matrices

RANGES = (1, 5, 20, 40)
WARM = 5
PROFILED = 20


def flood_us(fn, calls: int = PROFILED) -> float:
    """Device microseconds per call of the kernels whose names hold ``nn_``
    that ``fn`` launches, under torch.profiler."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return sum(e.time_range.elapsed_us() for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and "nn_" in e.name) / calls


def per_pass(pos, use, rows: int, cols: int) -> dict:
    """The flood's device time at RANGES and its least-squares line over the
    pass count."""
    passes, us = [], []
    for sr in RANGES:
        fn = lambda sr=sr: kernels.nn_field(pos, use, sr, rows, cols)   # noqa: E731
        for _ in range(WARM):
            fn()
        us.append(flood_us(fn))
        passes.append(8 * len(DF.flood_steps(sr)))
    n = len(passes)
    mp, mu = sum(passes) / n, sum(us) / n
    slope = (sum((p - mp) * (u - mu) for p, u in zip(passes, us))
             / sum((p - mp) ** 2 for p in passes))
    return {"field": [rows, cols], "keylines": int(pos.shape[0]), "passes": passes,
            "flood_us": us, "us_per_pass": slope, "us_at_0_passes": mu - slope * mp}


def main() -> list:
    dev = resolve_device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True)
    print("card:", card.stdout.strip().splitlines()[0] if card.returncode == 0 else "unknown")
    config = fast_profile()
    cam = config.camera
    scale = config.field_scale
    sr = int(config.core.search_range)
    seq = synthetic.generate(cam, n_frames=2, seed=0)
    frame = torch.as_tensor(seq.images[1]).to(dev).to(torch.float32) * config.image_gain
    thr = torch.full((), 0.01, dtype=torch.float32, device=dev)
    em = edge_detect.detect(frame, thr, frontend_matrices(config, dev), config.detector, cam,
                            field_scale=scale)
    frows, fcols, _ = DF.field_geometry(sr, cam.rows, cam.cols, scale)
    pos_f = (em.pos / torch.full_like(em.pos, float(scale))).contiguous()
    gen = torch.Generator().manual_seed(0)
    tiny = (torch.rand((512, 2), generator=gen) * torch.tensor([32.0, 16.0])).to(dev)
    lines = [per_pass(tiny, torch.ones(512, dtype=torch.bool, device=dev), 16, 32),
             per_pass(pos_f, DF.keyline_gate(em), frows, fcols)]
    for line in lines:
        print(json.dumps(line), flush=True)
    return lines


if __name__ == "__main__":
    main()
