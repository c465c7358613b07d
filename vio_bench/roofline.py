"""The chip's peaks and the least bytes and operations of each of the
program's CUDA kernels, from the shapes of a configuration (copied from
``rebvio_tpu_torch/tools/roofline.py`` and ``chip_smoke.py`` phase 2).
Each input byte is counted read once and each output byte written once,
gathered values once a read; operations are float32.  A kernel's bound is
the larger of its bytes over the memory rate and its operations over the
float32 rate: a least time, so a share of it cannot pass 1."""

from __future__ import annotations

import re
from typing import Dict, Optional, Tuple

# NVIDIA H100 SXM data sheet, at the full 700 W
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12


def bound_ms(nbytes: float, flops: float) -> float:
    return max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOP_PER_S) * 1e3


def flood_steps(search_range: int):
    """The jump flood's step sizes (``distance_field.flood_steps``)."""
    s = 1
    while 2 * s < search_range:
        s *= 2
    steps = []
    while s >= 1:
        steps.append(s)
        s //= 2
    return steps + [1]


def flood_pad(search_range: int) -> int:
    """Pad rows of the flood's stack: the largest step rounded up to 8."""
    return -(-max(flood_steps(search_range)) // 8) * 8


def field_geometry(search_range: int, rows: int, cols: int, scale: int):
    """(field rows, field cols, search range in field cells)."""
    sr = search_range if scale == 1 else max(1, round(search_range / scale))
    return -(-rows // scale), -(-cols // scale), sr


def sab_flops(iters: int) -> int:
    """float32 operations of one K3 call (csrc/sab.cu's loops)."""
    def gj(n):
        return n * (2 * n + 2 * n * 2 * n)

    def mm(n, k, m):
        return 2 * n * k * m

    problem = (gj(3) + 4 * mm(3, 3, 3) + 2 * mm(3, 3, 1) + 2 * mm(11, 11, 1)
               + mm(11, 11, 6) + 3 * mm(6, 11, 1) + mm(6, 11, 6) + 120)
    step = problem + gj(7) + mm(7, 7, 1) + 7
    return iters * step + problem + gj(7) + gj(6) + 2 * mm(6, 6, 1) + mm(3, 3, 1)


def kernel_counts(p: dict) -> Dict[str, Tuple[float, float]]:
    """name -> (bytes, operations) of one lane of each kernel the step
    launches, at the shapes of the pipeline configuration ``p`` (a config
    file's ``pipeline``).  ``match_reg_ekf`` covers its two launches."""
    K = p["detector"]["keylines_max"]
    P = p["edge_map"]["tube_probes"]
    rows, cols = p["camera"]["rows"], p["camera"]["cols"]
    sr = int(p["core"]["search_range"])
    frows, fcols, fsr = field_geometry(sr, rows, cols, p["field_scale"])
    n = frows * fcols
    steps = len(flood_steps(fsr))
    stack = 5 * (frows + flood_pad(fsr)) * fcols
    passes = 1 + p["core"]["iterations"]
    return {
        "att_flood": (stack * 4 + 8 * n * 4, steps * 8 * 7 * n + 4 * n),
        "att_field": (K * 17 + 8 * n * 4, steps * 8 * 7 * n + 4 * n + 6 * K),
        "minimize_vel": (K * 7 * 4 + 12 + passes * K * 6 * 4 + K * 8 + 64,
                         passes * K * 75 + (passes - 1) * 150),
        "tube_match": (K * 13 * 4 + P * K * 10 * 4 + 16 + 12 * K * 4, P * K * 55),
        "match_reg_ekf": (K * 11 * 4 + K * (9 * 4 + 1 + 4 * 8) + 12 + 36 + 1
                          + K * (6 * 4 + 2 * 8) + 5, K * 100),
        "reg_ekf_alone": (K * (15 * 4 + 1) + 12 + 2 * K * 4, K * 80),
        "estimate_bias": ((162 + 63) * 4, sab_flops(p["imu"]["sab_iterations"])),
        # the smallest matrix the step inverts (6x6): read and written once
        "chol_inverse": (2 * 6 * 6 * 4, 6 ** 3),
    }


# the device kernels of each entry above, as the profiler names them
KERNEL_NAMES = {
    "att_flood": ("att_flood_kernel",),
    "att_field": ("att_field_kernel",),
    "minimize_vel": ("minimize_vel_kernel",),
    "tube_match": ("tube_match_kernel",),
    "match_reg_ekf": ("match_reg_ekf_count", "match_reg_ekf_gate"),
    "reg_ekf_alone": ("reg_ekf_alone",),
    "estimate_bias": ("estimate_bias_kernel",),
    "chol_inverse": ("chol_inverse_kernel",),
}
_FIRST_OF = {"match_reg_ekf": "match_reg_ekf_count"}     # one call, counted at its first launch


def kernel_of(device_op: str) -> Optional[Tuple[str, bool]]:
    """(entry of KERNEL_NAMES, whether this launch starts a call) of a device
    operation's name, None for an operation that is not a port kernel."""
    for entry, names in KERNEL_NAMES.items():
        for name in names:
            if re.search(rf"\b{name}\b", device_op):
                return entry, name == _FIRST_OF.get(entry, name)
    return None
