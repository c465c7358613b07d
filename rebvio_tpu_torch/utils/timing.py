"""Named accumulating section timers (rebvio_tpu/utils/timing.py; the
reference's Timer macros, util/timer.hpp:18-74), printed on demand.  Free
when disabled at run time.  The GPU runs asynchronously, so a section that
covers device work names the device in ``sync``: the clock stops after
``torch.cuda.synchronize`` on it, so the section measures the work's
completion, not its launch.  Also a ``torch.profiler`` trace written as a
Chrome trace (``device_trace``)."""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict

import torch

_ENABLED = False
_ACC: Dict[str, list] = defaultdict(lambda: [0, 0.0])  # name -> [count, total_s]


def enable(on: bool = True) -> None:
    global _ENABLED
    _ENABLED = on


@contextlib.contextmanager
def section(name: str, sync=None):
    """Accumulate the wall time of a section; ``sync``: a CUDA device (or a
    tensor on one) synchronized before the clock stops (None or a CPU
    device: no synchronization)."""
    if not _ENABLED:
        yield
        return
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dev = sync.device if torch.is_tensor(sync) else sync
        if dev is not None and torch.device(dev).type == "cuda":
            torch.cuda.synchronize(dev)
        acc = _ACC[name]
        acc[0] += 1
        acc[1] += time.perf_counter() - t0


def report() -> str:
    lines = ["section                     count     total_ms     avg_ms"]
    for name, (n, total) in sorted(_ACC.items()):
        avg = total / n * 1e3 if n else 0.0
        lines.append(f"{name:<26} {n:>6} {total * 1e3:>12.2f} {avg:>10.3f}")
    return "\n".join(lines)


def reset() -> None:
    _ACC.clear()


@contextlib.contextmanager
def device_trace(logdir: str):
    """A ``torch.profiler`` trace of the block (CPU activities, and CUDA
    activities where a GPU is present), written into ``logdir`` as a Chrome
    trace ``trace_<pid>_<ns>.json`` (chrome://tracing, Perfetto).  The JAX
    package's ``device_trace`` writes the JAX profiler's xplane instead."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    try:
        yield prof
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        prof.export_chrome_trace(
            os.path.join(logdir, f"trace_{os.getpid()}_{time.time_ns()}.json"))

