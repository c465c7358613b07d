"""Times the three field functions on the GPU at the fast profile's field
geometry (8192 keylines, 752x480 image, field 240x376, field search range
20): the id-only nearest field (kernel K7, ``build_nn_field``), the
scatter-seeded attribute field (kernel K1b, ``build_att_field`` from the
keyline table) and the dense-seeded flood (kernel K1 fed by
``seed_stack_dense``), on frame 1 of the seed-0 synthetic sequence.

    python -m rebvio_tpu_torch.tools.jfa_ab

Prints one line per function in microseconds per call: the mean over a run
of calls between two CUDA events (device time plus launch gaps, the host's
enqueue hidden when the device is the slower side), the host's wall time
per call of the same run, and the device time per call (the sum of the
kernels' and copies' own durations under ``torch.profiler`` over a shorter
run).  Needs a GPU; the card's name and power limit are printed first.  The counterpart of the JAX package's ``tools/jfa_ab.py``.
"""

from __future__ import annotations

import subprocess
import time

import torch

from rebvio_tpu_torch import resolve_device
from rebvio_tpu_torch.configs import fast_profile
from rebvio_tpu_torch.data import synthetic
from rebvio_tpu_torch.ops import distance_field as DF
from rebvio_tpu_torch.ops import edge_detect
from rebvio_tpu_torch.pipeline import frontend_matrices

CALLS = 200
WARM = 5
PROFILED = 20


def time_us(fn, calls: int = CALLS, warm: int = WARM):
    """(event time, host wall time) per call in microseconds."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    a.record()
    for _ in range(calls):
        fn()
    b.record()
    b.synchronize()
    wall = time.perf_counter() - t0
    return a.elapsed_time(b) * 1e3 / calls, wall * 1e6 / calls


def device_us(fn, calls: int = PROFILED) -> float:
    """Device time per call in microseconds: the durations of all device
    activities of ``calls`` calls under torch.profiler, summed."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    total = sum(e.time_range.elapsed_us() for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CUDA)
    return total / calls


def main() -> dict:
    dev = resolve_device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True)
    print("card:", card.stdout.strip().splitlines()[0] if card.returncode == 0 else "unknown")

    config = fast_profile()
    cam = config.camera
    H, W = cam.rows, cam.cols
    scale = config.field_scale
    sr = int(config.core.search_range)
    mats = frontend_matrices(config, dev)
    seq = synthetic.generate(cam, n_frames=2, seed=0)
    frame = torch.as_tensor(seq.images[1]).to(dev).to(torch.float32) * config.image_gain
    thr = torch.full((), 0.01, dtype=torch.float32, device=dev)
    em = edge_detect.detect(frame, thr, mats, config.detector, cam, field_scale=scale)
    _, stack = edge_detect.detect_with_seeds(frame, thr, mats, config.detector, cam, scale, sr)
    frows, fcols, fsr = DF.field_geometry(sr, H, W, scale)
    print(f"keylines {int(em.count)} of {em.kmax}, field {frows}x{fcols}, "
          f"field search range {fsr}")

    fields = {
        "K7  build_nn_field (nn_field)": lambda: DF.build_nn_field(em, sr, H, W, scale),
        "K1b build_att_field (att_field)": lambda: DF.build_att_field(em, sr, H, W, scale),
        "K1  build_att_field(seed_stack) (att_flood)":
            lambda: DF.build_att_field(em, sr, H, W, scale, seed_stack=stack),
    }
    out = {}
    for name, fn in fields.items():
        ev_us, wall_us = time_us(fn)
        dev_us = device_us(fn)
        out[name] = (ev_us, wall_us, dev_us)
        print(f"{name:46s}: {ev_us:8.1f} us/call between events, {wall_us:8.1f} us/call host, "
              f"{dev_us:8.1f} us/call on the device")
    return out


if __name__ == "__main__":
    main()
