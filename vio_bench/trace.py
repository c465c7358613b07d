"""What a ``--trace 1`` run reads: the profiler's device operations over a
traced stretch of the window, the harness's own host spans around its calls
into the program, and the staged step's device time by stage.  The
per-layer metrics (``metrics/<name>.py``) read it through ``Trace``."""

from __future__ import annotations

import contextlib
import statistics
import time
from typing import Dict, List, Optional, Tuple

import torch

from vio_bench import roofline, stats

# ranges of the harness's own, named in the trace (record_function)
SPAN_PREFIX = "vio_bench:"
STAGE_PREFIX = "stage:"
ANNOTATIONS = (SPAN_PREFIX, STAGE_PREFIX)
NAME_CHARS = 200        # a device operation's name in the breakdown, cut to this


@contextlib.contextmanager
def span(name: str, on: bool):
    """A host range ``name`` in the profiler's trace while one runs."""
    if not on:
        yield
        return
    with torch.profiler.record_function(SPAN_PREFIX + name):
        yield


class Profile:
    """``torch.profiler`` over a stretch of the run (``start``/``stop``, each
    after a device synchronize): the device operations' intervals and the
    harness's host ranges, and the stretch's length on the host clock."""

    def __init__(self, device):
        self.device = torch.device(device)
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(activities=acts)
        self.window_s = None
        self.ops: List[Tuple[str, float, float]] = []       # (name, start_us, end_us)
        self.ranges: List[Tuple[str, float, float]] = []    # host spans

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def start(self):
        self.prof.start()
        self._sync()
        self._t0 = time.perf_counter()

    def stop(self):
        self._sync()
        self.window_s = time.perf_counter() - self._t0
        self.prof.stop()
        for e in self.prof.events():
            r = e.time_range
            if e.device_type == torch.autograd.DeviceType.CUDA:
                # a range's annotation is mirrored on the device timeline: no operation
                if not e.name.startswith(ANNOTATIONS):
                    self.ops.append((e.name, float(r.start), float(r.end)))
            elif e.name.startswith(SPAN_PREFIX):
                self.ranges.append((e.name[len(SPAN_PREFIX):], float(r.start), float(r.end)))


def stage_device_ms(run_staged, steps: int, device, stages) -> Dict[str, float]:
    """Device ms a step of each stage: ``run_staged(around)`` (one staged
    step, ``around(name)`` entered around each stage's operations) ``steps``
    times under the profiler, each range ending in a device synchronize, so
    each device operation falls in the range that launched it
    (rebvio_tpu_torch/tools/profile_stages.py's ``profile_ranges``)."""
    dev = torch.device(device)

    @contextlib.contextmanager
    def around(name):
        with torch.profiler.record_function(STAGE_PREFIX + name):
            yield
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)

    p = Profile(dev)
    p.start()
    for _ in range(steps):
        run_staged(around)
    p.stop()
    ranges = sorted((e.time_range.start, e.time_range.end, e.name[len(STAGE_PREFIX):])
                    for e in p.prof.events()
                    if e.device_type == torch.autograd.DeviceType.CPU
                    and e.name.startswith(STAGE_PREFIX))
    per = {name: 0.0 for name in stages}
    for name, a, b in p.ops:
        hit = next((s for lo, hi, s in ranges if lo <= a <= hi), None)
        if hit is not None:
            per[hit] += (b - a) / 1e3
    return {k: v / steps for k, v in per.items()}


class Trace:
    """The readings a per-layer metric takes from.  ``steps``: the program
    steps in the traced stretch (a batched step counts once); ``lanes``: the
    lanes a step carries; ``counts``: roofline.kernel_counts of the
    cell's configuration."""

    def __init__(self, profile: Optional[Profile], steps: int, lanes: int, counts: dict,
                 host_spans: Dict[str, List[float]], stages: Dict[str, float]):
        self.profile, self.steps, self.lanes, self.counts = profile, steps, lanes, counts
        self.host_spans, self.stages = host_spans, stages

    def _intervals(self):
        return [(a, b) for _, a, b in self.profile.ops]

    def has_device(self) -> bool:
        return self.profile is not None and bool(self.profile.ops)

    def busy_s(self) -> float:
        return stats.busy(self._intervals()) / 1e6

    def busy_ms_per_step(self) -> Optional[float]:
        return self.busy_s() * 1e3 / self.steps if self.has_device() else None

    def idle_share(self) -> Optional[float]:
        return 1.0 - self.busy_s() / self.profile.window_s if self.has_device() else None

    def kernels_per_step(self) -> Optional[float]:
        if not self.has_device():
            return None
        n = sum(1 for name, _, _ in self.profile.ops if not name.startswith(("Memcpy", "Memset")))
        return n / self.steps

    def stage_ms(self, *names: str) -> Optional[float]:
        if not self.stages or not any(v > 0 for v in self.stages.values()):
            return None
        return sum(self.stages[n] for n in names)

    def host_ms(self, name: str) -> Optional[float]:
        xs = self.host_spans.get(name)
        return statistics.fmean(xs) * 1e3 if xs else None

    def roofline_pct(self) -> Optional[float]:
        """100 x (the bounds of the port kernels' calls) / (their device
        time)."""
        if not self.has_device():
            return None
        bound = spent = 0.0
        for name, a, b in self.profile.ops:
            hit = roofline.kernel_of(name)
            if hit is None:
                continue
            spent += (b - a) / 1e3
            if hit[1]:
                bound += self.lanes * roofline.bound_ms(*self.counts[hit[0]])
        return 100.0 * bound / spent if spent > 0 else None

    def breakdown(self) -> dict:
        """The 10 device operations that took most time, and the 10 longest
        idle stretches of the device by the harness span the host was in."""
        tot: Dict[str, float] = {}
        for name, a, b in self.profile.ops:
            tot[name[:NAME_CHARS]] = tot.get(name[:NAME_CHARS], 0.0) + (b - a) / 1e6
        ops = sorted(tot.items(), key=lambda kv: -kv[1])[:10]
        idle = []
        for a, b in stats.gaps(self._intervals()):
            mid = (a + b) / 2
            inside = [(hi - lo, n) for n, lo, hi in self.profile.ranges if lo <= mid <= hi]
            idle.append((min(inside)[1] if inside else "outside harness spans", (b - a) / 1e6))
        idle.sort(key=lambda g: -g[1])
        return {"device_ops": [[n, s] for n, s in ops], "idle_gaps": [[n, s] for n, s in idle[:10]]}
